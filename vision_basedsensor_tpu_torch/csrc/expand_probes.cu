// Measurement probes for `chip_smoke.py --only expand`: the two halves of the
// first design of the sorted-expand kernel (K8, expand_sorted.cu as of its
// first port: one 256-thread block per 4,096-slot tile, four threads
// binary-searching the tile's entry range in the two streams), run alone on
// the same grid, so their times split that kernel's time between the write
// and the search. Not part of the kernel library (build.py); the script
// builds this file on its own.
//   vbs_expand_probe_stores: zero the int32 tile in shared memory and write
//     it out as int16 with 16-byte stores: no search, no adds.
//   vbs_expand_probe_search: the four binary searches, the zero fill and the
//     shared-memory adds: no output stores (one int per block goes to `sink`
//     so nothing is dead code).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 4096;
constexpr int NT = 256;

__device__ __forceinline__ int lower_bound(const int* __restrict__ pos,
                                           int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (pos[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(NT)
probe_stores_kernel(int16_t* __restrict__ out, int total) {
  __shared__ int tile[TILE];
  const int base = blockIdx.x * TILE;
  const unsigned len = (unsigned)(min(base + TILE, total) - base);
  for (int i = threadIdx.x; i < TILE; i += NT) tile[i] = 0;
  __syncthreads();
  if (len == TILE) {
    uint4* dst = reinterpret_cast<uint4*>(out + base);
    for (int i = threadIdx.x; i < TILE / 8; i += NT) {
      const unsigned* t = reinterpret_cast<const unsigned*>(tile + 8 * i);
      uint4 v;
      v.x = (t[0] & 0xFFFFu) | (t[1] << 16);
      v.y = (t[2] & 0xFFFFu) | (t[3] << 16);
      v.z = (t[4] & 0xFFFFu) | (t[5] << 16);
      v.w = (t[6] & 0xFFFFu) | (t[7] << 16);
      dst[i] = v;
    }
  } else {
    for (int i = threadIdx.x; i < (int)len; i += NT)
      out[base + i] = (int16_t)tile[i];
  }
}

__global__ void __launch_bounds__(NT)
probe_search_kernel(const int* __restrict__ pos,
                    const int16_t* __restrict__ val, int n,
                    const int* __restrict__ spos,
                    const int16_t* __restrict__ sval, int m,
                    int* __restrict__ sink, int total) {
  __shared__ int tile[TILE];
  __shared__ int range[4];
  const int base = blockIdx.x * TILE;
  const int end = min(base + TILE, total);
  const unsigned len = (unsigned)(end - base);
  if (threadIdx.x < 4) {
    const int key = (threadIdx.x & 1) ? end : base;
    range[threadIdx.x] = threadIdx.x < 2 ? lower_bound(pos, n, key)
                                         : lower_bound(spos, m, key);
  }
  for (int i = threadIdx.x; i < TILE; i += NT) tile[i] = 0;
  __syncthreads();
  for (int e = range[0] + threadIdx.x; e < range[1]; e += NT) {
    const unsigned off = (unsigned)(pos[e] - base);
    if (off < len) atomicAdd(&tile[off], (int)val[e]);
  }
  for (int e = range[2] + threadIdx.x; e < range[3]; e += NT) {
    const unsigned off = (unsigned)(spos[e] - base);
    if (off < len) atomicAdd(&tile[off], (int)sval[e]);
  }
  __syncthreads();
  if (threadIdx.x == 0)
    sink[blockIdx.x] = range[0] + range[1] + range[2] + range[3] + tile[0];
}

int blocks_for(int total) {
  return (int)(((long long)total + TILE - 1) / TILE);
}

}  // namespace

// out: total int16 (16-byte aligned). Returns cudaGetLastError().
extern "C" int vbs_expand_probe_stores(int16_t* out, int total, void* stream) {
  if (total <= 0) return 0;
  probe_stores_kernel<<<blocks_for(total), NT, 0, (cudaStream_t)stream>>>(
      out, total);
  return (int)cudaGetLastError();
}

// sink: one int per 4,096-slot tile. Returns cudaGetLastError().
extern "C" int vbs_expand_probe_search(const int* pos, const int16_t* val,
                                       int n, const int* spos,
                                       const int16_t* sval, int m, int* sink,
                                       int total, void* stream) {
  if (total <= 0) return 0;
  probe_search_kernel<<<blocks_for(total), NT, 0, (cudaStream_t)stream>>>(
      pos, val, n, spos, sval, m, sink, total);
  return (int)cudaGetLastError();
}
