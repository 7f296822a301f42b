// Measurement probes for `chip_smoke.py --only gather`: the two halves of the
// first design of the window-gather kernel (K3/K4, gather.cu as of its first
// port: one 256-thread block per (frame, output row), each thread stepping
// over the P x 128 slab with a scalar load and a dependent 4-byte store), run
// alone on the same grid, so their times split that kernel's time between
// the stores and the loads. Not part of the kernel library (build.py); the
// script builds this file on its own. Both entries take vbs_gather_windows's
// arguments.
//   vbs_gather_probe_stores: the slab's stores of a constant: no origins, no
//     loads.
//   vbs_gather_probe_loads: the origins and the in-image loads, summed a
//     thread; a sum is stored only if it is -1, which the nonnegative packed
//     field never gives, so the loads stay and almost nothing is written.
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 128;
constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
probe_stores_kernel(float* __restrict__ out, int P) {
  const int i = blockIdx.x;
  const int b = blockIdx.y;
  float* dst = out + ((size_t)b * gridDim.x + i) * (size_t)P * LANES;
  for (int e = threadIdx.x; e < P * LANES; e += NT) dst[e] = 0.f;
}

__global__ void __launch_bounds__(NT)
probe_loads_kernel(const float* __restrict__ packed,
                   const int* __restrict__ start, float* __restrict__ out,
                   int H, int W, int K, int P, int pack) {
  const int i = blockIdx.x;
  const int b = blockIdx.y;
  __shared__ int s_org[4];
  if (threadIdx.x < 2 * pack) {
    const int k = pack * i + threadIdx.x / 2;
    s_org[threadIdx.x] = start[((size_t)b * K + k) * 2 + (threadIdx.x & 1)];
  }
  __syncthreads();
  const float* src = packed + (size_t)b * H * W;
  float acc = 0.f;
  for (int e = threadIdx.x; e < P * LANES; e += NT) {
    const int r = e / LANES, c = e - r * LANES;
    const int j = pack == 2 ? c / 64 : 0;
    const int x = s_org[2 * j] + c - 64 * j;
    const int y = s_org[2 * j + 1] + r;
    acc += x < W ? src[(size_t)y * W + x] : 0.f;
  }
  if (acc == -1.f)
    out[((size_t)b * gridDim.x + i) * (size_t)P * LANES + threadIdx.x] = acc;
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int vbs_gather_probe_stores(const float* packed, const int* start,
                                       float* out, int B, int H, int W, int K,
                                       int P, int pack, void* stream) {
  (void)packed, (void)start, (void)H, (void)W;
  if (B == 0 || K / pack == 0) return 0;
  probe_stores_kernel<<<dim3(K / pack, B), NT, 0, (cudaStream_t)stream>>>(
      out, P);
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch.
extern "C" int vbs_gather_probe_loads(const float* packed, const int* start,
                                      float* out, int B, int H, int W, int K,
                                      int P, int pack, void* stream) {
  if (B == 0 || K / pack == 0) return 0;
  probe_loads_kernel<<<dim3(K / pack, B), NT, 0, (cudaStream_t)stream>>>(
      packed, start, out, H, W, K, P, pack);
  return (int)cudaGetLastError();
}
