// Fused per-pixel field kernel for the marker detector.
//
// Replaces both Pallas entry points of vision_basedsensor_tpu/ops/pallas/fields.py:
// the whole-frame `fused_fields` (kernel `_kernel`) and the row-tiled
// `_fused_fields_tiled` (kernel `_kernel_tiled`). Their split is a TPU VMEM
// budget (whole frames up to 960x1280, row blocks above); Hopper has no such
// limit, so one tiled kernel serves every H and W.
//
// Per frame (B, H, W), from the NCC score field `ncc`, the 0/1 DoG area mask
// `area` and the gray frame:
//   m       = ncc > thr
//   band    = m * [erode(m, band_w) < 0.5]
//   opened  = dilate(erode(area, open_k), open_k)
//   packed  = gray + 256 * band + 512 * opened
//   sp      = ncc where ncc >= dilate(ncc, peak_w) and ncc > thr, else -inf
//   cval/cidx: per 8x8 cell max of sp and its row-major flat index y*W+x,
//              ties to the smallest index (ceil(H/8) x ceil(W/8) cells).
// Windows span [-(w/2), (w-1)/2]; every stage pads with its own identity, so
// the dilation of the opening sees -inf (not an erosion) outside the frame,
// exactly as lax.reduce_window and the Pallas kernels do. Pixels of a ragged
// cell that fall outside the frame count as -inf, like ops/peaks.py:85-88.
//
// Bound on the H100: memory. Each pixel needs 12 B read (ncc, area, gray)
// and 4 B written (packed) plus 8 B per 64 pixels for the cells; the window
// arithmetic is ~70 shared-memory min/max per pixel, far below the SM's
// issue rate. Design: one block owns a TH x TW output tile and loads it once
// with a halo of R pixels (R derived from the windows by the wrapper) into
// shared memory; every windowed min/max is a separable pair of passes in
// shared memory, so ncc and area cross device memory once per tile (plus the
// halo, which neighbouring tiles mostly find in L2) and the intermediates
// never leave the SM.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TH = 32;       // output rows per block (multiple of 8)
constexpr int TW = 32;       // output columns per block (multiple of 8)
constexpr int CELL = 8;
constexpr int NT = 256;      // threads per block

struct Geometry {
  int R;        // halo
  int bl, bh;   // band window offsets [-bl, bh]
  int pl, ph;   // peak window offsets
  int ol, oh;   // open window offsets
  int EH, EW;   // extended tile (tile + 2R)
  int OH, OW;   // erosion tile needed by the dilation
};

__host__ __device__ inline Geometry make_geometry(int band_w, int peak_w,
                                                  int open_k, int R) {
  Geometry g;
  g.R = R;
  g.bl = band_w / 2; g.bh = (band_w - 1) / 2;
  g.pl = peak_w / 2; g.ph = (peak_w - 1) / 2;
  g.ol = open_k / 2; g.oh = (open_k - 1) / 2;
  g.EH = TH + 2 * R; g.EW = TW + 2 * R;
  g.OH = TH + g.ol + g.oh; g.OW = TW + g.ol + g.oh;
  return g;
}

// Floats of dynamic shared memory; s_hd reuses s_hb after the second pass.
__host__ __device__ inline int smem_floats(const Geometry& g) {
  return 2 * g.EH * g.EW      // s_ncc, s_area
         + 2 * g.EH * TW      // s_hb, s_hp
         + g.EH * g.OW        // s_ha
         + g.OH * g.OW        // s_er
         + 2 * TH * TW;       // s_band, s_sp
}

__global__ void __launch_bounds__(NT)
fused_fields_kernel(const float* __restrict__ ncc,
                    const float* __restrict__ area,
                    const float* __restrict__ gray,
                    float* __restrict__ packed,
                    float* __restrict__ cval,
                    int* __restrict__ cidx,
                    int H, int W, float thr,
                    int band_w, int peak_w, int open_k, int R) {
  extern __shared__ float smem[];
  const Geometry g = make_geometry(band_w, peak_w, open_k, R);
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const size_t frame = (size_t)b * H * W;
  const float INF = __int_as_float(0x7f800000);

  float* s_ncc = smem;                     // EH x EW, extended coords
  float* s_area = s_ncc + g.EH * g.EW;     // EH x EW
  float* s_hb = s_area + g.EH * g.EW;      // EH x TW: row erosion of m
  float* s_hp = s_hb + g.EH * TW;          // EH x TW: row max of ncc
  float* s_ha = s_hp + g.EH * TW;          // EH x OW: row erosion of area
  float* s_er = s_ha + g.EH * g.OW;        // OH x OW: erosion of area
  float* s_band = s_er + g.OH * g.OW;      // TH x TW
  float* s_sp = s_band + TH * TW;          // TH x TW: masked peak field
  float* s_hd = s_hb;                      // OH x TW: row dilation (reuse)

  // Load the tile and its halo once; out-of-frame entries are never read
  // as data (every pass tests the coordinate and uses its identity).
  for (int i = tid; i < g.EH * g.EW; i += NT) {
    const int er = i / g.EW, ec = i - er * g.EW;
    const int gy = y0 + er - R, gx = x0 + ec - R;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const size_t o = frame + (size_t)gy * W + gx;
    s_ncc[i] = in ? ncc[o] : 0.f;
    s_area[i] = in ? area[o] : 0.f;
  }
  __syncthreads();

  // Pass 1: row (horizontal) reductions over every extended row.
  for (int i = tid; i < g.EH * TW; i += NT) {
    const int er = i / TW, c = i - er * TW;
    const int gy = y0 + er - R, gx = x0 + c;
    float hb = INF, hp = -INF;
    if (gy >= 0 && gy < H) {
      const float* row = s_ncc + er * g.EW + R + c;
      for (int d = -g.bl; d <= g.bh; ++d) {
        const int x = gx + d;
        if (x >= 0 && x < W) hb = fminf(hb, row[d] > thr ? 1.f : 0.f);
      }
      for (int d = -g.pl; d <= g.ph; ++d) {
        const int x = gx + d;
        if (x >= 0 && x < W) hp = fmaxf(hp, row[d]);
      }
    }
    s_hb[i] = hb;
    s_hp[i] = hp;
  }
  for (int i = tid; i < g.EH * g.OW; i += NT) {
    const int er = i / g.OW, oc = i - er * g.OW;
    const int c = oc - g.ol;
    const int gy = y0 + er - R, gx = x0 + c;
    float ha = INF;
    if (gy >= 0 && gy < H) {
      const float* row = s_area + er * g.EW + R + c;
      for (int d = -g.ol; d <= g.oh; ++d) {
        const int x = gx + d;
        if (x >= 0 && x < W) ha = fminf(ha, row[d]);
      }
    }
    s_ha[i] = ha;
  }
  __syncthreads();

  // Pass 2: column (vertical) reductions -> band, masked peak field, erosion.
  for (int i = tid; i < TH * TW; i += NT) {
    const int r = i / TW, c = i - r * TW;
    const int gy = y0 + r, gx = x0 + c;
    float eroded = INF, lmax = -INF;
    for (int d = -g.bl; d <= g.bh; ++d)
      eroded = fminf(eroded, s_hb[(r + d + R) * TW + c]);
    for (int d = -g.pl; d <= g.ph; ++d)
      lmax = fmaxf(lmax, s_hp[(r + d + R) * TW + c]);
    const float v = s_ncc[(r + R) * g.EW + c + R];
    const float m = v > thr ? 1.f : 0.f;
    s_band[i] = m * (eroded < 0.5f ? 1.f : 0.f);
    const bool in = gy < H && gx < W;
    s_sp[i] = (in && v >= lmax && v > thr) ? v : -INF;
  }
  for (int i = tid; i < g.OH * g.OW; i += NT) {
    const int orow = i / g.OW, oc = i - orow * g.OW;
    const int r = orow - g.ol, c = oc - g.ol;
    const int gy = y0 + r, gx = x0 + c;
    float e = -INF;  // the dilation's identity outside the frame
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      e = INF;
      for (int d = -g.ol; d <= g.oh; ++d)
        e = fminf(e, s_ha[(r + d + R) * g.OW + oc]);
    }
    s_er[i] = e;
  }
  __syncthreads();

  // Pass 3: row dilation of the erosion, and the per-cell reduction.
  for (int i = tid; i < g.OH * TW; i += NT) {
    const int orow = i / TW, c = i - orow * TW;
    float d_ = -INF;
    for (int d = -g.ol; d <= g.oh; ++d)
      d_ = fmaxf(d_, s_er[orow * g.OW + c + d + g.ol]);
    s_hd[i] = d_;
  }
  const int HC = (H + CELL - 1) / CELL, WC = (W + CELL - 1) / CELL;
  constexpr int CW = TW / CELL;
  for (int i = tid; i < (TH / CELL) * CW; i += NT) {
    const int cy = i / CW, cx = i - cy * CW;
    const int gcy = y0 / CELL + cy, gcx = x0 / CELL + cx;
    if (gcy >= HC || gcx >= WC) continue;
    // Row-major scan inside the cell is increasing flat index, so a strict
    // '>' keeps the smallest index among equal maxima.
    float best = -INF;
    int best_idx = (y0 + cy * CELL) * W + (x0 + cx * CELL);
    for (int rr = 0; rr < CELL; ++rr) {
      for (int cc = 0; cc < CELL; ++cc) {
        const float v = s_sp[(cy * CELL + rr) * TW + cx * CELL + cc];
        if (v > best) {
          best = v;
          best_idx = (y0 + cy * CELL + rr) * W + (x0 + cx * CELL + cc);
        }
      }
    }
    const size_t o = (size_t)b * HC * WC + (size_t)gcy * WC + gcx;
    cval[o] = best;
    cidx[o] = best_idx;
  }
  __syncthreads();

  // Pass 4: column dilation -> opened; pack the three fields.
  for (int i = tid; i < TH * TW; i += NT) {
    const int r = i / TW, c = i - r * TW;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= H || gx >= W) continue;
    float op = -INF;
    for (int d = -g.ol; d <= g.oh; ++d)
      op = fmaxf(op, s_hd[(r + d + g.ol) * TW + c]);
    const size_t o = frame + (size_t)gy * W + gx;
    packed[o] = gray[o] + 256.f * s_band[i] + 512.f * op;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int vbs_fused_fields(const float* ncc, const float* area,
                                const float* gray, float* packed, float* cval,
                                int* cidx, int B, int H, int W, float thr,
                                int band_w, int peak_w, int open_k, int R,
                                void* stream) {
  const int smem = (int)sizeof(float) *
                   smem_floats(make_geometry(band_w, peak_w, open_k, R));
  cudaError_t err = cudaFuncSetAttribute(
      fused_fields_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  fused_fields_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      ncc, area, gray, packed, cval, cidx, H, W, thr, band_w, peak_w, open_k,
      R);
  return (int)cudaGetLastError();
}
