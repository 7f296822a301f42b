// Per-peak window moment sums (the 28 sums of ops/moments.py's layout).
//
// One kernel with two input modes replaces three Pallas kernels:
//   three fields band, area, gray (PACKED = false):
//     vision_basedsensor_tpu/ops/pallas/moments.py:439 `window_sums_pallas`
//     (kernel `_kernel` :81, reduction `_accumulate` :32);
//   the packed field gray + 256*band + 512*area (PACKED = true), unpacked
//   exactly as `_packed_kernel` :157-163 does:
//     ops/pallas/moments.py:232 `window_sums_packed` and
//     benchmarks/gather_moments_kernel.py:152 `gather_moments` (the fused
//     gather + moments kernel; the sums are the same function).
//
// For peak k of frame b at (px, py) with clipped patch origin (cx, cy),
// computed by the wrapper as extract_patches does, the sums run over the
// P x P patch pixels (x, y) = (cx + c, cy + r) that pass
//   d2 = dx*dx + dy*dy <= cutoff^2,   dx = x - px, dy = y - py,
//   dx*ex_j + dy*ey_j <= rhs_j + 1e-3   for the three halfplanes j.
// Pass 1 reduces lo/hi = min/max of gray over those pixels (+inf/-inf when
// there are none); pass 2 accumulates the 26 other sums with the soft weight
// w = remap(clip((hi - gray) / max(hi - lo, 1e-3), 0, 1)) and wh = w >= 0.5.
// The TPU kernels' (P+8, 256) aligned window is a Mosaic tiling rule; with
// radial_cutoff <= P/2 - 1 it gates the same pixels as this patch, so the
// patch is all a warp reads. band and area are 0/1 masks (the detector's
// band_and_opening; the packed field's exact unpack).
//
// Bound on the H100: memory, 12 B per distinct gated pixel (4 B packed);
// chip_smoke.py's sums_bound counts it. The work around those bytes is what
// costs: a gate per patch pixel, a float64 sum per term, a reduction per
// peak. The design keeps each of them small:
//   - a warp per peak, WARPS peaks a block, no block barrier: the warp first
//     builds a table of each patch row's gated run of columns (a candidate
//     run from the disk and the halfplanes, widened by a pixel on each side,
//     trimmed by the exact gate at its ends: along a row the gate passes one
//     run), then writes each pixel of the runs, in order, as a 16-bit key
//     (row, column) into shared memory. Its lanes walk that list, UNROLL1
//     (pass 1) or UNROLL2 (pass 2) loads in flight a lane: no pass tests the
//     gate, every lane's pixel is gated, and the count (slot 23) is the
//     list's length, bit-equal to the plain version's;
//   - the 0/1 channels (band, area, wh, the cut) are summed as integers:
//     their counts, and the sums of their column and row indices, from
//     which sum(mask * dx) = sum(mask * c) + n * (cx - px) exactly in
//     float64 (dx = gx - px is exact in float32 unless the peak is within
//     ~32 px of the top-left corner, where the two differ by < 4e-3);
//   - only the 16 terms that are not exact integers (area and wh second
//     moments, every w term) take a float->double conversion and a float64
//     add, each term computed with the plain version's float32 operations
//     in its order (__fmul_rn/__fadd_rn), so the totals agree to float32
//     rounding whatever the summation order; in float32 the third moments
//     (~4e6 at 1080x1920) move by up to 0.25 with the order alone;
//   - the weight's division is a correctly rounded reciprocal per peak and
//     an exact-remainder step per pixel (Markstein), no divide per pixel;
//   - the warp reduces its 16 float64 partials by halving exchanges (16
//     shuffles of doubles instead of 80) and its integers with redux; lane
//     s writes slot s, so a peak's 112 B go out in one store.
// On the card (PERF.md) this runs at ~29% of the bound at 48x1080x1920: not
// the float64 work (a float32-accumulator twin is no faster) but the ~110
// instructions an entry of pass 2 and the latency of pass 1 at 20 warps an
// SM (96 registers).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 4;            // peaks per block, one a warp
constexpr int NT = 32 * WARPS;
constexpr int NOUT = 28;
constexpr int ND = 16;              // float64 sums
// List entries a lane loads at once: pass 1 holds no sums, so it keeps
// more loads in flight than pass 2.
constexpr int UNROLL1 = 16, UNROLL2 = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int CAP = 4096;           // list keys a warp holds (64 x 64)

// Shared memory of one warp in 4-byte words (P <= 256: a key packs the row
// and the column in 16 bits).
__host__ __device__ constexpr int warp_words(int P) {
  return 2 * P + 1 + CAP / 2;
}

// Output slot of each float64 sum: area dx^2, dy^2, dxdy; w, w dx, w dy,
// w dx^2, w dy^2, w dxdy; wh dx^2, dy^2, dxdy; w dx^3, dx^2dy, dxdy^2, dy^3.
__device__ __forceinline__ int dslot_index(int slot) {
  if (slot >= 6 && slot <= 14) return slot - 6;
  if (slot >= 18 && slot <= 20) return slot - 9;
  if (slot >= 24 && slot <= 27) return slot - 12;
  return -1;
}

// The float32 value of 0 <= i < 2^23, exactly, without a conversion
// instruction (they issue at 16 a clock an SM).
__device__ __forceinline__ float small_int_float(int i) {
  return __fsub_rn(__int_as_float(0x4B000000 | i), 8388608.0f);
}

struct Peak {
  float px, py, cut2;
  float ex[3], ey[3], rhs[3];   // rhs already + 1e-3
  int cx, cy;
};

__device__ __forceinline__ float col_dx(const Peak& p, int c) {
  return __fsub_rn(small_int_float(p.cx + c), p.px);
}
__device__ __forceinline__ float row_dy(const Peak& p, int r) {
  return __fsub_rn(small_int_float(p.cy + r), p.py);
}

__device__ __forceinline__ bool gated(const Peak& p, float dx, float dy) {
  const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  bool keep = d2 <= p.cut2;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float lhs = __fadd_rn(__fmul_rn(dx, p.ex[j]), __fmul_rn(dy, p.ey[j]));
    keep = keep && lhs <= p.rhs[j];
  }
  return keep;
}

// The run [c0, c0 + len) of patch columns of row r that may pass the gate:
// the disk's chord and each halfplane's side, each widened by one pixel.
// Rounding moves those ends by < 0.02 px (a halfplane bounds the run only
// when |ex| >= 1e-5 (|rhs| + 4 |dy ey|)), so no pixel that passes the exact
// gate falls outside. A halfplane with ex == 0 is exact for the whole row.
__device__ __forceinline__ void row_run(const Peak& p, int r, int P, int& c0,
                                        int& len) {
  c0 = 0;
  len = 0;
  const float dy = row_dy(p, r);
  const float dy2 = __fmul_rn(dy, dy);
  if (!(dy2 <= p.cut2)) return;                 // d2 >= dy2 on the whole row
  const float half = __fadd_rn(sqrtf(__fsub_rn(p.cut2, dy2)), 1.0f);
  float lo = -half, hi = half;                  // dx range
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float ex = p.ex[j], y = __fmul_rn(dy, p.ey[j]), rhs = p.rhs[j];
    if (ex == 0.f) {
      if (!(y <= rhs)) return;                  // the gate's lhs is y
    } else if (fabsf(ex) * 1e5f > __fadd_rn(fabsf(rhs), 4.f * fabsf(y))) {
      const float bnd = __fdiv_rn(__fsub_rn(rhs, y), ex);
      if (ex > 0.f)
        hi = fminf(hi, __fadd_rn(bnd, 1.0f));
      else
        lo = fmaxf(lo, __fsub_rn(bnd, 1.0f));
    }
  }
  const float base = __fsub_rn(p.px, small_int_float(p.cx));   // px - cx
  const float first = fmaxf(ceilf(__fadd_rn(base, lo)), 0.f);
  const float last = fminf(floorf(__fadd_rn(base, hi)), (float)(P - 1));
  if (!(first <= last)) return;
  // Along a row each test of the gate is monotone in the column (fl(dx)
  // rises with x, fl(dx*dx) with |dx|, fl(fl(dx*ex) + y) is monotone in
  // dx), so the gated pixels form one run: trim the candidate run to it.
  int a = (int)first, b = (int)last;
  while (a <= b && !gated(p, col_dx(p, a), dy)) ++a;
  while (b > a && !gated(p, col_dx(p, b), dy)) --b;
  if (a > b) return;
  c0 = a;
  len = b - a + 1;
}

// The packed field's exact unpack: 512*area and 256*band are exact
// products, gray < 256.
__device__ __forceinline__ void unpack(float v, float& band, float& area,
                                       float& gray) {
  area = floorf(__fmul_rn(v, 1.0f / 512.0f));
  const float r = __fsub_rn(v, __fmul_rn(512.0f, area));
  band = floorf(__fmul_rn(r, 1.0f / 256.0f));
  gray = __fsub_rn(r, __fmul_rn(256.0f, band));
}

// Writes the keys (row << 8 | column) of the warp's list entries [k0, k0 +
// CAP): lane l fills the runs of rows l, l + 32, ...
__device__ __forceinline__ void fill_keys(int k0, int P, int lane,
                                          const int* __restrict__ run_start,
                                          const int* __restrict__ run_col,
                                          unsigned short* __restrict__ keys) {
  __syncwarp();
  for (int r = lane; r < P; r += 32) {
    // Entry e of row r's run is column run_col[r] + e - run_start[r].
    const int key0 = (r << 8 | run_col[r]) - run_start[r];
    const int end = min(run_start[r + 1], k0 + CAP);
    for (int e = max(run_start[r], k0); e < end; ++e)
      keys[e - k0] = (unsigned short)(key0 + e);
  }
  __syncwarp();
}

// Walks the warp's list of gated pixels: lane l takes entries l, l + 32, ...,
// U at a time, and hands their keys (-1 past the end) to `batch`, which
// issues all their loads before it uses any. The keys are written again
// for each chunk of CAP entries when `refill` (or the list is longer).
template <int U, class Batch>
__device__ __forceinline__ void walk(int total, int P, int lane, bool refill,
                                     const int* __restrict__ run_start,
                                     const int* __restrict__ run_col,
                                     unsigned short* __restrict__ keys,
                                     Batch&& batch) {
  for (int k0 = 0; k0 < total; k0 += CAP) {
    const int n = min(total - k0, CAP);
    if (refill || total > CAP) fill_keys(k0, P, lane, run_start, run_col, keys);
    for (int e = lane; e < n; e += 32 * U) {
      int key[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        key[u] = e + 32 * u < n ? keys[e + 32 * u] : -1;
      batch(key);
    }
  }
}

// One halving step over 2M values: the lanes with bit o set keep the upper
// M, the others the lower M, each adding its partner's half.
template <int M>
__device__ __forceinline__ void halve(double* d, int lane, int o) {
  const bool up = lane & o;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const double send = up ? d[i] : d[i + M];
    const double keep = up ? d[i + M] : d[i];
    d[i] = keep + __shfl_xor_sync(FULL, send, o);
  }
}

template <bool PACKED>
__global__ void __launch_bounds__(NT)
window_sums_kernel(const float* __restrict__ f0, const float* __restrict__ f1,
                   const float* __restrict__ f2, const float* __restrict__ xy,
                   const float* __restrict__ geom, const int* __restrict__ start,
                   float* __restrict__ out, int BK, int H, int W, int K, int P,
                   float cut2, float soft_floor, float soft_scale) {
  // Per warp: run starts [P + 1], run columns [P], list keys [CAP].
  extern __shared__ int s_mem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pk = blockIdx.x * WARPS + warp;
  if (pk >= BK) return;
  int* run_start = s_mem + warp * warp_words(P);
  int* run_col = run_start + P + 1;
  unsigned short* keys = reinterpret_cast<unsigned short*>(run_col + P);

  Peak p;
  p.px = xy[pk * 2];
  p.py = xy[pk * 2 + 1];
  p.cut2 = cut2;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    p.ex[j] = geom[pk * 9 + 3 * j];
    p.ey[j] = geom[pk * 9 + 3 * j + 1];
    p.rhs[j] = __fadd_rn(geom[pk * 9 + 3 * j + 2], 1e-3f);
  }
  p.cx = start[pk * 2];
  p.cy = start[pk * 2 + 1];
  const float* g0 = f0 + (size_t)(pk / K) * H * W + (size_t)p.cy * W + p.cx;
  const float* g1 = f1 + (g0 - f0);
  const float* g2 = f2 + (g0 - f0);

  // The run table: an exclusive scan of the rows' run lengths.
  int total = 0;
  for (int r0 = 0; r0 < P; r0 += 32) {
    const int r = r0 + lane;
    int c0 = 0, len = 0;
    if (r < P) row_run(p, r, P, c0, len);
    int inc = len;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc += t;
    }
    if (r < P) {
      run_start[r] = total + inc - len;
      run_col[r] = c0;
    }
    total += __shfl_sync(FULL, inc, 31);
  }
  if (lane == 0) run_start[P] = total;
  __syncwarp();

  // Pass 1: lo/hi of gray over the gated pixels.
  const float* gsrc = PACKED ? g0 : g2;
  float lo = INFINITY, hi = -INFINITY;
  walk<UNROLL1>(total, P, lane, true, run_start, run_col, keys,
       [&](const int (&key)[UNROLL1]) {
         // fminf/fmaxf skip the NaN past the list's end.
         float v[UNROLL1];
#pragma unroll
         for (int u = 0; u < UNROLL1; ++u)
           v[u] = key[u] < 0 ? NAN : gsrc[(key[u] >> 8) * W + (key[u] & 0xff)];
#pragma unroll
         for (int u = 0; u < UNROLL1; ++u) {
           float gray = v[u];
           if (PACKED && key[u] >= 0) {
             float band, area;
             unpack(v[u], band, area, gray);
           }
           lo = fminf(lo, gray);
           hi = fmaxf(hi, gray);
         }
       });
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(FULL, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(FULL, hi, o));
  }
  const float contrast = fmaxf(__fsub_rn(hi, lo), 1e-3f);
  const float rc = __frcp_rn(contrast);

  // Pass 2: integer sums of the 0/1 channels, float64 sums of the rest.
  double d[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) d[i] = 0.0;
  int nb = 0, na = 0, nh = 0;
  int bc = 0, br = 0, ac = 0, ar = 0, hc = 0, hr = 0;
  walk<UNROLL2>(total, P, lane, false, run_start, run_col, keys,
       [&](const int (&key)[UNROLL2]) {
        float v0[UNROLL2], v1[UNROLL2], v2[UNROLL2];
#pragma unroll
        for (int u = 0; u < UNROLL2; ++u) {
          if (key[u] < 0) continue;
          const int i = (key[u] >> 8) * W + (key[u] & 0xff);
          v0[u] = g0[i];
          if (!PACKED) {
            v1[u] = g1[i];
            v2[u] = g2[i];
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL2; ++u) {
          if (key[u] < 0) continue;
          const int r = key[u] >> 8, c = key[u] & 0xff;
          const float dx = col_dx(p, c), dy = row_dy(p, r);
          float band, area, gray;
          if (PACKED) {
            unpack(v0[u], band, area, gray);
          } else {
            band = v0[u];
            area = v1[u];
            gray = v2[u];
          }
          // (hi - gray) / contrast, correctly rounded: q = num * (1/contrast)
          // is within an ulp, and one exact-remainder step rounds it right.
          const float num = __fsub_rn(hi, gray);
          const float q0 = __fmul_rn(num, rc);
          const float q = __fmaf_rn(__fmaf_rn(-q0, contrast, num), rc, q0);
          float w = fminf(fmaxf(q, 0.f), 1.f);
          if (soft_floor > 0.f)
            w = fminf(fmaxf(__fmul_rn(__fsub_rn(w, soft_floor), soft_scale), 0.f),
                      1.f);
          const bool ib = band != 0.f, ia = area != 0.f, ih = w >= 0.5f;
          if (ib) { ++nb; bc += c; br += r; }
          if (ia) { ++na; ac += c; ar += r; }
          if (ih) { ++nh; hc += c; hr += r; }
          // A 0/1 mask times dx*dx is dx*dx or 0, as the plain version's
          // (mask * dx) * dx.
          const float dxx = __fmul_rn(dx, dx), dyy = __fmul_rn(dy, dy);
          const float dxy = __fmul_rn(dx, dy);
          const float wx = __fmul_rn(w, dx), wy = __fmul_rn(w, dy);
          const float wxx = __fmul_rn(wx, dx), wyy = __fmul_rn(wy, dy);
          const float wxy = __fmul_rn(wx, dy);
          d[0] += ia ? dxx : 0.f;
          d[1] += ia ? dyy : 0.f;
          d[2] += ia ? dxy : 0.f;
          d[3] += w;
          d[4] += wx;
          d[5] += wy;
          d[6] += wxx;
          d[7] += wyy;
          d[8] += wxy;
          d[9] += ih ? dxx : 0.f;
          d[10] += ih ? dyy : 0.f;
          d[11] += ih ? dxy : 0.f;
          d[12] += __fmul_rn(wxx, dx);                  // w dx^3
          d[13] += __fmul_rn(wxx, dy);                  // w dx^2 dy
          d[14] += __fmul_rn(wxy, dy);                  // w dx dy^2
          d[15] += __fmul_rn(wyy, dy);                  // w dy^3
        }
       });

  // Halving exchanges: lane l ends with the warp's total of d[l >> 1].
  halve<8>(d, lane, 16);
  halve<4>(d, lane, 8);
  halve<2>(d, lane, 4);
  halve<1>(d, lane, 2);
  d[0] += __shfl_xor_sync(FULL, d[0], 1);
  nb = __reduce_add_sync(FULL, nb);
  na = __reduce_add_sync(FULL, na);
  nh = __reduce_add_sync(FULL, nh);
  bc = __reduce_add_sync(FULL, bc);
  br = __reduce_add_sync(FULL, br);
  ac = __reduce_add_sync(FULL, ac);
  ar = __reduce_add_sync(FULL, ar);
  hc = __reduce_add_sync(FULL, hc);
  hr = __reduce_add_sync(FULL, hr);

  // Lane s writes slot s. sum(mask * dx) = sum(mask * c) + n (cx - px),
  // exact in float64.
  const int j = dslot_index(lane);
  const double dv = __shfl_sync(FULL, d[0], 2 * (j < 0 ? 0 : j));
  const double ox = (double)p.cx - (double)p.px;
  const double oy = (double)p.cy - (double)p.py;
  double v = dv;
  switch (lane) {
    case 0: v = nb; break;
    case 1: v = bc + nb * ox; break;
    case 2: v = br + nb * oy; break;
    case 3: v = na; break;
    case 4: v = ac + na * ox; break;
    case 5: v = ar + na * oy; break;
    case 15: v = nh; break;
    case 16: v = hc + nh * ox; break;
    case 17: v = hr + nh * oy; break;
    case 21: v = lo; break;
    case 22: v = hi; break;
    case 23: v = total; break;
    default: break;
  }
  if (lane < NOUT) out[(size_t)pk * NOUT + lane] = (float)v;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). `packed`
// selects the input mode: f0 is the packed field and f1, f2 are unused.
extern "C" int vbs_window_sums(const float* f0, const float* f1,
                               const float* f2, const float* xy,
                               const float* geom, const int* start, float* out,
                               int B, int H, int W, int K, int P, float cut2,
                               float soft_floor, float soft_scale, int packed,
                               void* stream) {
  const int bk = B * K;
  const dim3 grid((bk + WARPS - 1) / WARPS);
  const size_t smem = (size_t)WARPS * warp_words(P) * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  if (packed)
    window_sums_kernel<true><<<grid, NT, smem, s>>>(
        f0, f1, f2, xy, geom, start, out, bk, H, W, K, P, cut2, soft_floor,
        soft_scale);
  else
    window_sums_kernel<false><<<grid, NT, smem, s>>>(
        f0, f1, f2, xy, geom, start, out, bk, H, W, K, P, cut2, soft_floor,
        soft_scale);
  return (int)cudaGetLastError();
}
