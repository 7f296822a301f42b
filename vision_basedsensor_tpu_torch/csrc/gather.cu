// Per-peak window gather from the packed field.
//
// Replaces vision_basedsensor_tpu/ops/pallas/moments.py:gather_windows
// (kernel `_gather_kernel`) in both layouts: pack=2, the detector's default
// `gather_windows_paired`, which puts windows 2i and 2i+1 side by side in
// lanes [0, 64) and [64, 128) of output row i; and pack=1, one window per
// 128-lane row (odd K, or patches wider than 64).
//
// For window k with clipped patch origin (cx_k, cy_k), computed by the
// wrapper exactly as the reference's `_prep` does:
//   out[b, i, r, c] = packed[b, cy_k + r, cx_k + c - 64 j]   if that column < W
//                   = 0                                     otherwise
// with j = c / 64, k = 2i + j for pack=2 and j = 0, k = i for pack=1. Rows
// never leave the frame (cy_k <= H - P). The TPU kernel leaves other data in
// the out-of-image lanes; the moment stage gates them out by coordinate.
//
// Bound on the H100: memory, mostly the written bytes (the output outweighs
// the distinct in-image pixels the windows read). The (8, 128)-aligned DMA
// plus lane roll of the TPU kernel is a tiling workaround Hopper does not
// need. Design: one block per (frame, output row) copies its P x 128 slab
// directly, consecutive threads on consecutive columns, so each warp reads
// 32 contiguous floats of one image row (two runs of 32 per 64-lane slot)
// and writes 128 B contiguously; 8 blocks of 256 threads an SM keep enough
// loads in flight to overlap them with the stores. On an H100 (SXM, 700 W)
// it runs at 66-78% of the bound at the detector's shapes (`chip_smoke.py
// --only gather`). A version that brings the windows in with Hopper's copy
// engine (TMA) ran 1-15% slower: the engine takes only 16-byte aligned row
// starts, so its boxes were realigned through shared memory by the threads
// that store, which cost what the asynchronous loads saved.
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 128;
constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
gather_windows_kernel(const float* __restrict__ packed,
                      const int* __restrict__ start,
                      float* __restrict__ out, int H, int W, int K, int P,
                      int pack) {
  const int i = blockIdx.x;      // output row (window pair for pack=2)
  const int b = blockIdx.y;
  const int k_out = K / pack;
  __shared__ int s_org[4];       // (cx, cy) of the row's one or two windows
  if (threadIdx.x < 2 * pack) {
    const int k = pack * i + threadIdx.x / 2;
    s_org[threadIdx.x] = start[((size_t)b * K + k) * 2 + (threadIdx.x & 1)];
  }
  __syncthreads();
  const float* src = packed + (size_t)b * H * W;
  float* dst = out + ((size_t)b * k_out + i) * (size_t)P * LANES;
  for (int e = threadIdx.x; e < P * LANES; e += NT) {
    const int r = e / LANES, c = e - r * LANES;
    const int j = pack == 2 ? c / 64 : 0;
    const int x = s_org[2 * j] + c - 64 * j;
    const int y = s_org[2 * j + 1] + r;
    dst[e] = x < W ? src[(size_t)y * W + x] : 0.f;
  }
}

}  // namespace

extern "C" const char* vbs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int vbs_gather_windows(const float* packed, const int* start,
                                  float* out, int B, int H, int W, int K,
                                  int P, int pack, void* stream) {
  dim3 grid(K / pack, B);
  gather_windows_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      packed, start, out, H, W, K, P, pack);
  return (int)cudaGetLastError();
}
