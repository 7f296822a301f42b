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
// patch is all a block reads.
//
// Numerics: every per-pixel value is computed with the plain version's
// float32 operations in its order (explicit __fmul_rn/__fadd_rn, so nvcc
// cannot contract them into FMAs), and the sums are accumulated in float64
// and rounded to float32 once, as ops/moments.py:window_sums_xla does. The
// two then agree to float32 rounding whatever their summation orders; in
// float32 the third moments (~4e6 at 1080x1920) move by up to 0.25 with the
// order alone.
//
// Bound on the H100: memory. A peak needs its gated pixels (the cutoff disk,
// ~1,000-2,800 of the P*P patch) read once, 12 B each (4 B packed), and 112 B
// written; the function needs 59 float32 ops per gated pixel (67 packed) and
// 51 per patch row (chip_smoke.py's sums_bound counts them term by term).
// This kernel does more: it tests the 18-op gate on every patch pixel, in
// both passes, and adds in float64. Design: one
// block per (frame, peak), 256 threads striding over the patch row-major, so
// a warp reads consecutive pixels of one image row; per-thread float64
// accumulators, then warp shuffles and shared memory. A simple kernel:
// blocks do not share the overlapping patches of neighbouring peaks.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int NOUT = 28;
constexpr int NACC = 26;   // every output but lo (21) and hi (22)

__device__ __forceinline__ int out_slot(int i) { return i < 21 ? i : i + 2; }

struct Peak {
  float px, py, cut2;
  float ex[3], ey[3], rhs[3];   // rhs already + 1e-3
  int cx, cy;
};

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

template <bool PACKED>
__device__ __forceinline__ void load(const float* __restrict__ f0,
                                     const float* __restrict__ f1,
                                     const float* __restrict__ f2, size_t i,
                                     float& band, float& area, float& gray) {
  if (PACKED) {
    // Exact: 512*area and 256*band are exact products, gray < 256.
    const float v = f0[i];
    area = floorf(__fmul_rn(v, 1.0f / 512.0f));
    const float r = __fsub_rn(v, __fmul_rn(512.0f, area));
    band = floorf(__fmul_rn(r, 1.0f / 256.0f));
    gray = __fsub_rn(r, __fmul_rn(256.0f, band));
  } else {
    band = f0[i];
    area = f1[i];
    gray = f2[i];
  }
}

template <typename T, typename Op>
__device__ __forceinline__ T warp_reduce(T v, Op op) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = op(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

template <bool PACKED>
__global__ void __launch_bounds__(NT)
window_sums_kernel(const float* __restrict__ f0, const float* __restrict__ f1,
                   const float* __restrict__ f2, const float* __restrict__ xy,
                   const float* __restrict__ geom, const int* __restrict__ start,
                   float* __restrict__ out, int H, int W, int K, int P,
                   float cut2, float soft_floor, float soft_scale) {
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const size_t pk = (size_t)b * K + k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

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

  const size_t frame = (size_t)b * H * W;
  const int n = P * P;

  // Pass 1: lo/hi of gray over the gated pixels.
  float lo = INFINITY, hi = -INFINITY;
  for (int e = threadIdx.x; e < n; e += NT) {
    const int r = e / P, c = e - r * P;
    const float dx = __fsub_rn((float)(p.cx + c), p.px);
    const float dy = __fsub_rn((float)(p.cy + r), p.py);
    if (!gated(p, dx, dy)) continue;
    float band, area, gray;
    load<PACKED>(f0, f1, f2, frame + (size_t)(p.cy + r) * W + (p.cx + c),
                 band, area, gray);
    lo = fminf(lo, gray);
    hi = fmaxf(hi, gray);
  }
  __shared__ float s_lo[NWARP], s_hi[NWARP];
  lo = warp_reduce(lo, [](float a, float c) { return fminf(a, c); });
  hi = warp_reduce(hi, [](float a, float c) { return fmaxf(a, c); });
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  lo = s_lo[0];
  hi = s_hi[0];
#pragma unroll
  for (int i = 1; i < NWARP; ++i) {
    lo = fminf(lo, s_lo[i]);
    hi = fmaxf(hi, s_hi[i]);
  }
  const float contrast = fmaxf(__fsub_rn(hi, lo), 1e-3f);

  // Pass 2: the 26 sums, float32 terms accumulated in float64.
  double acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0;
  for (int e = threadIdx.x; e < n; e += NT) {
    const int r = e / P, c = e - r * P;
    const float dx = __fsub_rn((float)(p.cx + c), p.px);
    const float dy = __fsub_rn((float)(p.cy + r), p.py);
    if (!gated(p, dx, dy)) continue;
    float band, area, gray;
    load<PACKED>(f0, f1, f2, frame + (size_t)(p.cy + r) * W + (p.cx + c),
                 band, area, gray);
    float w = fminf(fmaxf(__fdiv_rn(__fsub_rn(hi, gray), contrast), 0.f), 1.f);
    if (soft_floor > 0.f)
      w = fminf(fmaxf(__fmul_rn(__fsub_rn(w, soft_floor), soft_scale), 0.f),
                1.f);
    const float wh = w >= 0.5f ? 1.f : 0.f;
    const float bx = __fmul_rn(band, dx), by = __fmul_rn(band, dy);
    const float ax = __fmul_rn(area, dx), ay = __fmul_rn(area, dy);
    const float wx = __fmul_rn(w, dx), wy = __fmul_rn(w, dy);
    const float wxx = __fmul_rn(wx, dx);
    const float hx = __fmul_rn(wh, dx), hy = __fmul_rn(wh, dy);
    acc[0] += band;
    acc[1] += bx;
    acc[2] += by;
    acc[3] += area;
    acc[4] += ax;
    acc[5] += ay;
    acc[6] += __fmul_rn(ax, dx);
    acc[7] += __fmul_rn(ay, dy);
    acc[8] += __fmul_rn(ax, dy);
    acc[9] += w;
    acc[10] += wx;
    acc[11] += wy;
    acc[12] += wxx;
    acc[13] += __fmul_rn(wy, dy);
    acc[14] += __fmul_rn(wx, dy);
    acc[15] += wh;
    acc[16] += hx;
    acc[17] += hy;
    acc[18] += __fmul_rn(hx, dx);
    acc[19] += __fmul_rn(hy, dy);
    acc[20] += __fmul_rn(hx, dy);
    acc[21] += 1.0;                                       // count (slot 23)
    acc[22] += __fmul_rn(wxx, dx);                        // w dx^3
    acc[23] += __fmul_rn(wxx, dy);                        // w dx^2 dy
    acc[24] += __fmul_rn(__fmul_rn(wx, dy), dy);          // w dx dy^2
    acc[25] += __fmul_rn(__fmul_rn(wy, dy), dy);          // w dy^3
  }

  __shared__ double s_acc[NWARP][NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const double v = warp_reduce(acc[i], [](double a, double c) { return a + c; });
    if (lane == 0) s_acc[warp][i] = v;
  }
  __syncthreads();
  float* o = out + pk * NOUT;
  if (threadIdx.x < NACC) {
    double s = 0.0;
#pragma unroll
    for (int i = 0; i < NWARP; ++i) s += s_acc[i][threadIdx.x];
    o[out_slot(threadIdx.x)] = (float)s;
  } else if (threadIdx.x == NACC) {
    o[21] = lo;
    o[22] = hi;
  }
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
  dim3 grid(K, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (packed)
    window_sums_kernel<true><<<grid, NT, 0, s>>>(
        f0, f1, f2, xy, geom, start, out, H, W, K, P, cut2, soft_floor,
        soft_scale);
  else
    window_sums_kernel<false><<<grid, NT, 0, s>>>(
        f0, f1, f2, xy, geom, start, out, H, W, K, P, cut2, soft_floor,
        soft_scale);
  return (int)cudaGetLastError();
}
