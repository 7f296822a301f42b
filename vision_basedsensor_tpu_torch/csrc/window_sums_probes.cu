// Measurement probes for `chip_smoke.py --only window_sums`: three cuts of
// the first design of the window-sums kernel (window_sums.cu as of its first
// port: one 256-thread block per (frame, peak) striding over the patch
// row-major, the 18-op gate and `e / P` on every patch pixel in both passes,
// 26 float64 accumulators a thread, warp-shuffle trees and shared memory at
// the end), run on the same grid, so their times split that kernel's time
// between the bytes, the float64 conversions and the end reduction. Not part
// of the kernel library (build.py); the script builds this file on its own.
// Every entry takes vbs_window_sums's arguments.
//   vbs_ws_probe_loads: one pass over the patch, gate and loads of the gated
//     pixels only, summed into one float per thread and one per peak (slot
//     0); no lo/hi pass, no weights, no moment sums.
//   vbs_ws_probe_f32: the first design with float32 accumulators.
//   vbs_ws_probe_noreduce: the first design without the end reduction: lane
//     0 of each warp writes its own 26 partials (the warps of a block race
//     for the same slots; the values are not the sums).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int NOUT = 28;
constexpr int NACC = 26;

__device__ __forceinline__ int out_slot(int i) { return i < 21 ? i : i + 2; }

struct Peak {
  float px, py, cut2;
  float ex[3], ey[3], rhs[3];
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

__device__ __forceinline__ Peak load_peak(const float* __restrict__ xy,
                                          const float* __restrict__ geom,
                                          const int* __restrict__ start,
                                          size_t pk, float cut2) {
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
  return p;
}

template <bool PACKED>
__global__ void __launch_bounds__(NT)
probe_loads_kernel(const float* __restrict__ f0, const float* __restrict__ f1,
                   const float* __restrict__ f2, const float* __restrict__ xy,
                   const float* __restrict__ geom,
                   const int* __restrict__ start, float* __restrict__ out,
                   int H, int W, int K, int P, float cut2) {
  const size_t pk = (size_t)blockIdx.y * K + blockIdx.x;
  const Peak p = load_peak(xy, geom, start, pk, cut2);
  const size_t frame = (size_t)blockIdx.y * H * W;
  float s = 0.f;
  for (int e = threadIdx.x; e < P * P; e += NT) {
    const int r = e / P, c = e - r * P;
    const float dx = __fsub_rn((float)(p.cx + c), p.px);
    const float dy = __fsub_rn((float)(p.cy + r), p.py);
    if (!gated(p, dx, dy)) continue;
    float band, area, gray;
    load<PACKED>(f0, f1, f2, frame + (size_t)(p.cy + r) * W + (p.cx + c),
                 band, area, gray);
    s += band + area + gray;
  }
  __shared__ float s_w[NWARP];
  s = warp_reduce(s, [](float a, float c) { return a + c; });
  if ((threadIdx.x & 31) == 0) s_w[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < NWARP; ++i) t += s_w[i];
    out[pk * NOUT] = t;
  }
}

// The first design, with accumulator type ACC and the end reduction on or
// off.
template <bool PACKED, typename ACC, bool REDUCE>
__global__ void __launch_bounds__(NT)
probe_sums_kernel(const float* __restrict__ f0, const float* __restrict__ f1,
                  const float* __restrict__ f2, const float* __restrict__ xy,
                  const float* __restrict__ geom,
                  const int* __restrict__ start, float* __restrict__ out,
                  int H, int W, int K, int P, float cut2, float soft_floor,
                  float soft_scale) {
  const size_t pk = (size_t)blockIdx.y * K + blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Peak p = load_peak(xy, geom, start, pk, cut2);
  const size_t frame = (size_t)blockIdx.y * H * W;
  const int n = P * P;

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

  ACC acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0;
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
    acc[21] += 1;
    acc[22] += __fmul_rn(wxx, dx);
    acc[23] += __fmul_rn(wxx, dy);
    acc[24] += __fmul_rn(__fmul_rn(wx, dy), dy);
    acc[25] += __fmul_rn(__fmul_rn(wy, dy), dy);
  }

  float* o = out + pk * NOUT;
  if (!REDUCE) {
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) o[out_slot(i)] = (float)acc[i];
    }
    return;
  }
  __shared__ ACC s_acc[NWARP][NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const ACC v = warp_reduce(acc[i], [](ACC a, ACC c) { return a + c; });
    if (lane == 0) s_acc[warp][i] = v;
  }
  __syncthreads();
  if (threadIdx.x < NACC) {
    ACC s = 0;
#pragma unroll
    for (int i = 0; i < NWARP; ++i) s += s_acc[i][threadIdx.x];
    o[out_slot(threadIdx.x)] = (float)s;
  } else if (threadIdx.x == NACC) {
    o[21] = lo;
    o[22] = hi;
  }
}

}  // namespace

#define VBS_PROBE_ARGS                                                     \
  const float *f0, const float *f1, const float *f2, const float *xy,      \
      const float *geom, const int *start, float *out, int B, int H, int W, \
      int K, int P, float cut2, float soft_floor, float soft_scale,        \
      int packed, void *stream

extern "C" int vbs_ws_probe_loads(VBS_PROBE_ARGS) {
  dim3 grid(K, B);
  cudaStream_t s = (cudaStream_t)stream;
  (void)soft_floor;
  (void)soft_scale;
  if (packed)
    probe_loads_kernel<true><<<grid, NT, 0, s>>>(f0, f1, f2, xy, geom, start,
                                                 out, H, W, K, P, cut2);
  else
    probe_loads_kernel<false><<<grid, NT, 0, s>>>(f0, f1, f2, xy, geom, start,
                                                  out, H, W, K, P, cut2);
  return (int)cudaGetLastError();
}

template <typename ACC, bool REDUCE>
static int launch_sums(VBS_PROBE_ARGS) {
  dim3 grid(K, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (packed)
    probe_sums_kernel<true, ACC, REDUCE><<<grid, NT, 0, s>>>(
        f0, f1, f2, xy, geom, start, out, H, W, K, P, cut2, soft_floor,
        soft_scale);
  else
    probe_sums_kernel<false, ACC, REDUCE><<<grid, NT, 0, s>>>(
        f0, f1, f2, xy, geom, start, out, H, W, K, P, cut2, soft_floor,
        soft_scale);
  return (int)cudaGetLastError();
}

extern "C" int vbs_ws_probe_f32(VBS_PROBE_ARGS) {
  return launch_sums<float, true>(f0, f1, f2, xy, geom, start, out, B, H, W,
                                  K, P, cut2, soft_floor, soft_scale, packed,
                                  stream);
}

extern "C" int vbs_ws_probe_noreduce(VBS_PROBE_ARGS) {
  return launch_sums<double, false>(f0, f1, f2, xy, geom, start, out, B, H, W,
                                    K, P, cut2, soft_floor, soft_scale, packed,
                                    stream);
}
