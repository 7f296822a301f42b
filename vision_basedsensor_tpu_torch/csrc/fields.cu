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
// and 4 B written (packed) plus 8 B per 64 pixels for the cells. Design, so
// that the arithmetic stays below that:
//  - One block of 256 threads owns TW = 128 output columns by TH = 32 rows
//    and reads ncc and area once, with a halo of R rows and columns (R from
//    the windows, at most RMAX), into shared memory; a warp loads whole
//    rows, two at a time. Gray is read and packed written once, 16 bytes a
//    thread where W % 4 == 0. (On the H100, 64-row tiles, which halve the
//    halo rows, ran slower at both profiles, at 2 blocks an SM instead of
//    4; a block that walks down 4 tiles carrying the halo rows over gained
//    5% at R = 7, lost 3-11% at R = 4 and spilled.)
//  - The binary fields are bits. m and the area mask become 32-column words
//    with __ballot_sync as they are loaded (one word of halo each side); an
//    erosion or dilation is funnel shifts across neighbouring words combined
//    with & or | along a row, then & or | over rows. Out-of-frame bits are 1
//    in an erosion's input (+inf); the area's erosion is masked to 0 outside
//    the frame before its dilation (-inf).
//  - The peak field's max filter is separable float max with no bounds test
//    per tap: shared rows are padded with -inf once, a thread takes 4
//    columns of a row (16-byte shared loads) or 8 rows of a column into
//    registers with compile-time indices. The two profiles' peak windows
//    (9 and 15) are compiled in (RMAX = 8) and reduced van Herk /
//    Gil-Werman style (about 3 max a pixel); any other window is read at
//    run time and taken tap by tap (RMAX = 24, the widest halo taken).
//  - The cell argmax: each thread reduces its column's 8 rows of a cell,
//    then the cell's 8 lanes combine with __shfl_xor_sync by value
//    descending, then index ascending (ops/pallas/fields.py:106-130).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int TW = 128;             // output columns per block
constexpr int TH = 32;              // output rows per block (multiple of 8)
constexpr int NT = 256;             // threads per block
constexpr int NWARP = NT / 32;
constexpr int OWORDS = TW / 32;     // output words per row
constexpr int WORDS = OWORDS + 2;   // with one word of halo on each side
constexpr int CELL = 8;
constexpr int LOAD_ROWS = 2;        // rows a warp loads at once
constexpr unsigned FULL = 0xffffffffu;

struct Win { int lo, hi; };          // window offsets [-lo, hi]
__host__ __device__ inline Win win(int w) { return {w / 2, (w - 1) / 2}; }

// Shared memory of one block, in bytes; ER = TH + 2R rows of each field.
__host__ __device__ inline size_t smem_bytes(int rmax, int R) {
  const int er = TH + 2 * R;
  return sizeof(float) * er * ((TW + 2 * rmax) + TW)   // s_ncc, s_hp
         + sizeof(unsigned) * (6 * er * WORDS           // bit rows
                               + 2 * TH * OWORDS);      // s_band, s_open
}

// Bits of the word whose bit i is column x_base + i that lie in [0, W).
__device__ inline unsigned in_cols(int x_base, int W) {
  const int lo = min(max(-x_base, 0), 32), hi = min(max(W - x_base, 0), 32);
  if (hi <= lo) return 0u;
  const unsigned upto = hi == 32 ? FULL : (1u << hi) - 1u;
  return upto & ~((1u << lo) - 1u);   // lo < hi <= 32, so lo <= 31
}

// Bit i of the result is the row's column (bit i of `cur`) + d, |d| < 32;
// `prev` and `next` are the words to the left and right.
__device__ inline unsigned shifted(unsigned prev, unsigned cur, unsigned next,
                                   int d) {
  if (d > 0) return __funnelshift_r(cur, next, d);
  if (d < 0) return __funnelshift_l(prev, cur, -d);
  return cur;
}

// Erosion (AND) or dilation (OR) of one word along the row, window w.
template <bool kErode>
__device__ inline unsigned row_window(unsigned prev, unsigned cur,
                                      unsigned next, Win w) {
  unsigned acc = cur;
  for (int d = -w.lo; d <= w.hi; ++d) {
    const unsigned s = shifted(prev, cur, next, d);
    acc = kErode ? (acc & s) : (acc | s);
  }
  return acc;
}

// The plain version's float order: (gray + 256 * band) + 512 * opened.
__device__ inline float pack(float g, unsigned band, unsigned opened) {
  return __fadd_rn(__fadd_rn(g, 256.f * (float)(band & 1u)),
                   512.f * (float)(opened & 1u));
}

// out[u] = max of t[OFF + u - LO .. OFF + u + HI] for u in [0, C). A window
// of at least C taps takes van Herk / Gil-Werman around the start of the
// last window (2C + LO + HI - 3 max for the C outputs), a shorter one its
// taps one by one.
template <int LO, int HI, int C, int OFF, int N>
__device__ __forceinline__ void window_max(const float (&t)[N],
                                           float (&out)[C]) {
  if constexpr (LO + HI + 1 >= C) {
    constexpr int S = OFF + C - 1 - LO;   // start of the last window
    float suf[C];                         // suf[u] = max t[OFF + u - LO, S)
    if constexpr (C >= 2) {
      suf[C - 2] = t[S - 1];
#pragma unroll
      for (int u = C - 3; u >= 0; --u)
        suf[u] = fmaxf(t[OFF + u - LO], suf[u + 1]);
    }
    float pre = t[S];                     // max t[S, OFF + u + HI]
#pragma unroll
    for (int y = S + 1; y <= OFF + HI; ++y) pre = fmaxf(pre, t[y]);
#pragma unroll
    for (int u = 0; u < C; ++u) {
      if (u > 0) pre = fmaxf(pre, t[OFF + u + HI]);
      out[u] = u < C - 1 ? fmaxf(suf[u], pre) : pre;
    }
  } else {
#pragma unroll
    for (int u = 0; u < C; ++u) {
      float m = t[OFF + u];
#pragma unroll
      for (int d = 1; d <= LO; ++d) m = fmaxf(m, t[OFF + u - d]);
#pragma unroll
      for (int d = 1; d <= HI; ++d) m = fmaxf(m, t[OFF + u + d]);
      out[u] = m;
    }
  }
}

// RMAX: the largest halo (shared padding, register windows). PL, PH: the
// peak window's offsets compiled in, or -1 for a window read at run time.
template <int RMAX, int PL, int PH>
__global__ void __launch_bounds__(NT)
fused_fields_kernel(const float* __restrict__ ncc,
                    const float* __restrict__ area,
                    const float* __restrict__ gray,
                    float* __restrict__ packed,
                    float* __restrict__ cval,
                    int* __restrict__ cidx,
                    int H, int W, float thr,
                    int band_w, int peak_w, int open_k, int R, int vec) {
  constexpr int SW = TW + 2 * RMAX;   // s_ncc row: column c at RMAX + c
  extern __shared__ __align__(16) unsigned char smem[];
  const int ER = TH + 2 * R;          // extended row er is frame row y0-R+er
  float* s_ncc = reinterpret_cast<float*>(smem);    // ER x SW, -inf padded
  float* s_hp = s_ncc + ER * SW;                    // ER x TW: row max
  unsigned* s_mb = reinterpret_cast<unsigned*>(s_hp + ER * TW);  // m bits
  unsigned* s_ab = s_mb + ER * WORDS;   // area bits
  unsigned* s_hb = s_ab + ER * WORDS;   // row erosion of m (band window)
  unsigned* s_ha = s_hb + ER * WORDS;   // row erosion of area (open window)
  unsigned* s_ea = s_ha + ER * WORDS;   // erosion of area, 0 out of frame
  unsigned* s_hd = s_ea + ER * WORDS;   // row dilation of s_ea
  unsigned* s_band = s_hd + ER * WORDS; // TH x OWORDS
  unsigned* s_open = s_band + TH * OWORDS;

  const Win bw = win(band_w), pw = win(peak_w), ow = win(open_k);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const size_t frame = (size_t)blockIdx.z * H * W;
  const float NEG = __int_as_float(0xff800000);   // -inf

  // 1. Load. A warp takes whole rows (LOAD_ROWS at a time, every load in
  //    flight before the first ballot); lane l of word j is column
  //    c = 32 (j - 1) + l. Columns outside [-R, TW + R) or the frame load
  //    nothing: -inf for ncc, 1 (the erosion's identity) for the bits.
  for (int er0 = warp; er0 < ER; er0 += NWARP * LOAD_ROWS) {
    float v[LOAD_ROWS][WORDS], a[LOAD_ROWS][WORDS];
    bool in[LOAD_ROWS][WORDS];
#pragma unroll
    for (int s = 0; s < LOAD_ROWS; ++s) {
      const int er = er0 + s * NWARP, gy = y0 - R + er;
      const bool row_in = er < ER && gy >= 0 && gy < H;
      const size_t row = frame + (size_t)max(gy, 0) * W;
#pragma unroll
      for (int j = 0; j < WORDS; ++j) {
        const int c = 32 * (j - 1) + lane, gx = x0 + c;
        in[s][j] = row_in && c >= -R && c < TW + R && gx >= 0 && gx < W;
        v[s][j] = NEG;
        a[s][j] = 1.f;
        if (in[s][j]) {
          v[s][j] = __ldg(ncc + row + gx);
          a[s][j] = __ldg(area + row + gx);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < LOAD_ROWS; ++s) {
      const int er = er0 + s * NWARP;
      if (er < ER) {                  // warp-uniform
#pragma unroll
        for (int j = 0; j < WORDS; ++j) {
          const int c = 32 * (j - 1) + lane;
          const unsigned mb = __ballot_sync(FULL, !in[s][j] || v[s][j] > thr);
          const unsigned ab =
              __ballot_sync(FULL, !in[s][j] || a[s][j] != 0.f);
          if (c >= -RMAX && c < TW + RMAX) s_ncc[er * SW + RMAX + c] = v[s][j];
          if (lane == j) {
            s_mb[er * WORDS + j] = mb;
            s_ab[er * WORDS + j] = ab;
          }
        }
      }
    }
  }
  __syncthreads();

  // 2a. Row erosions: m over the band window (output words), the area over
  //     the open window (every word; past the halo words, the identity).
  for (int i = tid; i < ER * WORDS; i += NT) {
    const int j = i % WORDS;
    const unsigned* mrow = s_mb + (i - j);
    const unsigned* arow = s_ab + (i - j);
    if (j >= 1 && j <= OWORDS)
      s_hb[i] = row_window<true>(mrow[j - 1], mrow[j], mrow[j + 1], bw);
    s_ha[i] = row_window<true>(j > 0 ? arow[j - 1] : FULL, arow[j],
                               j < WORDS - 1 ? arow[j + 1] : FULL, ow);
  }
  // 2b. Row max of ncc over the peak window, 4 columns a thread, on the rows
  //     the column pass reads.
  {
    const int r_first = R - pw.lo, n_rows = TH + pw.lo + pw.hi;
    for (int i = tid; i < n_rows * (TW / 4); i += NT) {
      const int er = r_first + i / (TW / 4), q = i % (TW / 4);
      // t[k] is column 4q - RMAX + k.
      const float4* src = reinterpret_cast<const float4*>(s_ncc + er * SW) + q;
      float t[4 + 2 * RMAX], out[4];
      if constexpr (PL >= 0) {   // the window compiled in: only its taps
#pragma unroll
        for (int k = 0; k < 4 + 2 * RMAX; ++k) t[k] = NEG;
#pragma unroll
        for (int k = (RMAX - PL) / 4; k <= (RMAX + 3 + PH) / 4; ++k) {
          const float4 f = src[k];
          t[4 * k] = f.x; t[4 * k + 1] = f.y; t[4 * k + 2] = f.z;
          t[4 * k + 3] = f.w;
        }
        window_max<PL, PH, 4, RMAX>(t, out);
      } else {
#pragma unroll
        for (int k = 0; k < (4 + 2 * RMAX) / 4; ++k) {
          const float4 f = src[k];
          t[4 * k] = f.x; t[4 * k + 1] = f.y; t[4 * k + 2] = f.z;
          t[4 * k + 3] = f.w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float m = t[RMAX + u];
#pragma unroll
          for (int d = 1; d <= RMAX; ++d) {
            if (d <= pw.lo) m = fmaxf(m, t[RMAX + u - d]);
            if (d <= pw.hi) m = fmaxf(m, t[RMAX + u + d]);
          }
          out[u] = m;
        }
      }
      reinterpret_cast<float4*>(s_hp + er * TW)[q] =
          make_float4(out[0], out[1], out[2], out[3]);
    }
  }
  __syncthreads();

  // 3a. Column max -> masked peak field -> cell argmax. A thread takes one
  //     column of a cell row (8 rows); lanes are consecutive columns, so a
  //     cell is 8 lanes.
  const int HC = (H + CELL - 1) / CELL, WC = (W + CELL - 1) / CELL;
  for (int i = tid; i < (TH / CELL) * TW; i += NT) {   // NT | the count
    const int g = i / TW, c = i % TW;
    const int r0 = g * CELL, gx = x0 + c;
    float t[CELL + 2 * RMAX], lm[CELL];   // t[k]: row r0 - RMAX + k of s_hp
    if constexpr (PL >= 0) {
#pragma unroll
      for (int k = 0; k < CELL + 2 * RMAX; ++k)
        t[k] = (k >= RMAX - PL && k < RMAX + CELL + PH)
                   ? s_hp[(R + r0 - RMAX + k) * TW + c] : NEG;
      window_max<PL, PH, CELL, RMAX>(t, lm);
    } else {
#pragma unroll
      for (int k = 0; k < CELL + 2 * RMAX; ++k) {
        const int d = k - RMAX;
        t[k] = NEG;
        if (d >= -pw.lo && d <= CELL - 1 + pw.hi)
          t[k] = s_hp[(R + r0 + d) * TW + c];
      }
#pragma unroll
      for (int u = 0; u < CELL; ++u) {
        float m = t[RMAX + u];
#pragma unroll
        for (int d = 1; d <= RMAX; ++d) {
          if (d <= pw.lo) m = fmaxf(m, t[RMAX + u - d]);
          if (d <= pw.hi) m = fmaxf(m, t[RMAX + u + d]);
        }
        lm[u] = m;
      }
    }
    // Rows ascend with the index, so a strict '>' keeps the smallest index
    // of a column's equal maxima; a cell without a peak keeps the index of
    // its top-left pixel, as the plain version's argmax does.
    const int gy0 = y0 + r0;
    float best = NEG;
    int best_i = (gx < W && gy0 < H) ? gy0 * W + gx : INT_MAX;
#pragma unroll
    for (int u = 0; u < CELL; ++u) {
      const float v = s_ncc[(R + r0 + u) * SW + RMAX + c];
      if (gx < W && gy0 + u < H && v >= lm[u] && v > thr && v > best) {
        best = v;
        best_i = (gy0 + u) * W + gx;
      }
    }
#pragma unroll
    for (int off = 1; off < CELL; off <<= 1) {
      const float ov = __shfl_xor_sync(FULL, best, off);
      const int oi = __shfl_xor_sync(FULL, best_i, off);
      if (ov > best || (ov == best && oi < best_i)) {
        best = ov;
        best_i = oi;
      }
    }
    const int gcy = (y0 + r0) / CELL, gcx = gx / CELL;
    if ((c & (CELL - 1)) == 0 && gcy < HC && gcx < WC) {
      const size_t o = (size_t)blockIdx.z * HC * WC + (size_t)gcy * WC + gcx;
      cval[o] = best;
      cidx[o] = best_i;
    }
  }
  // 3b. Column erosions: band words of the output rows; the area's erosion
  //     on rows [-ol, TH + oh), the rows the dilation reads, masked to the
  //     frame.
  for (int i = tid; i < TH * OWORDS; i += NT) {
    const int r = i / OWORDS, j = i % OWORDS + 1;
    unsigned e = FULL;
    for (int d = -bw.lo; d <= bw.hi; ++d) e &= s_hb[(R + r + d) * WORDS + j];
    s_band[i] = s_mb[(R + r) * WORDS + j] & ~e;
  }
  const int n_open_rows = TH + ow.lo + ow.hi;
  for (int i = tid; i < n_open_rows * WORDS; i += NT) {
    const int er = R - ow.lo + i / WORDS, j = i % WORDS;
    unsigned e = FULL;
    for (int d = -ow.lo; d <= ow.hi; ++d) e &= s_ha[(er + d) * WORDS + j];
    const int gy = y0 - R + er;
    s_ea[er * WORDS + j] =
        (gy >= 0 && gy < H) ? e & in_cols(x0 + 32 * (j - 1), W) : 0u;
  }
  __syncthreads();

  // 4. Row dilation of the eroded area (output words).
  for (int i = tid; i < n_open_rows * OWORDS; i += NT) {
    const int er = R - ow.lo + i / OWORDS, j = i % OWORDS + 1;
    const unsigned* row = s_ea + er * WORDS;
    s_hd[er * WORDS + j] =
        row_window<false>(row[j - 1], row[j], row[j + 1], ow);
  }
  __syncthreads();

  // 5. Column dilation -> opened words of the output rows.
  for (int i = tid; i < TH * OWORDS; i += NT) {
    const int r = i / OWORDS, j = i % OWORDS + 1;
    unsigned o = 0u;
    for (int d = -ow.lo; d <= ow.hi; ++d) o |= s_hd[(R + r + d) * WORDS + j];
    s_open[i] = o;
  }
  __syncthreads();

  // 6. packed = gray + 256 band + 512 opened; a warp takes a row, a lane 4
  //    columns.
#pragma unroll 4
  for (int i = tid; i < TH * (TW / 4); i += NT) {
    const int r = i / (TW / 4), c = 4 * (i % (TW / 4));
    const int gy = y0 + r, gx = x0 + c;
    if (gy < H && gx < W) {
      const int sh = c & 31;
      const unsigned bb = s_band[r * OWORDS + (c >> 5)] >> sh;
      const unsigned ob = s_open[r * OWORDS + (c >> 5)] >> sh;
      const size_t o = frame + (size_t)gy * W + gx;
      if (vec) {   // W % 4 == 0 and 16-byte aligned rows: gx + 3 < W
        float4 g = __ldg(reinterpret_cast<const float4*>(gray + o));
        g.x = pack(g.x, bb, ob);
        g.y = pack(g.y, bb >> 1, ob >> 1);
        g.z = pack(g.z, bb >> 2, ob >> 2);
        g.w = pack(g.w, bb >> 3, ob >> 3);
        *reinterpret_cast<float4*>(packed + o) = g;
      } else {
        for (int u = 0; u < 4 && gx + u < W; ++u)
          packed[o + u] = pack(__ldg(gray + o + u), bb >> u, ob >> u);
      }
    }
  }
}

template <int RMAX, int PL, int PH>
int launch(const float* ncc, const float* area, const float* gray,
           float* packed, float* cval, int* cidx, int B, int H, int W,
           float thr, int band_w, int peak_w, int open_k, int R,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(RMAX, R);
  cudaError_t err = cudaFuncSetAttribute(
      fused_fields_kernel<RMAX, PL, PH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = W % 4 == 0 &&
                  ((uintptr_t)gray | (uintptr_t)packed) % 16 == 0;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  fused_fields_kernel<RMAX, PL, PH><<<grid, NT, smem, stream>>>(
      ncc, area, gray, packed, cval, cidx, H, W, thr, band_w, peak_w, open_k,
      R, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). R is the halo:
// at least every window's reach (ops/cuda/fields.py:halo), at most 24
// (ops/cuda/fields.py:MAX_HALO).
extern "C" int vbs_fused_fields(const float* ncc, const float* area,
                                const float* gray, float* packed, float* cval,
                                int* cidx, int B, int H, int W, float thr,
                                int band_w, int peak_w, int open_k, int R,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (R < 0 || R > 24) return (int)cudaErrorInvalidValue;
  // The peak windows of the two profiles (config.py) are compiled in; any
  // other window is read at run time.
  if (R <= 8 && peak_w == 9)
    return launch<8, 4, 4>(ncc, area, gray, packed, cval, cidx, B, H, W, thr,
                           band_w, peak_w, open_k, R, s);
  if (R <= 8 && peak_w == 15)
    return launch<8, 7, 7>(ncc, area, gray, packed, cval, cidx, B, H, W, thr,
                           band_w, peak_w, open_k, R, s);
  return launch<24, -1, -1>(ncc, area, gray, packed, cval, cidx, B, H, W, thr,
                            band_w, peak_w, open_k, R, s);
}
