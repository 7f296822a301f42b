// Sorted sparse (position, value) streams -> dense int16 tensor.
//
// Replaces benchmarks/scatter_onehot_kernel.py:expand_sorted (kernel
// `_kernel`), and with it the `.at[pos].set/add(mode="drop")` scatters of
// every JPEG transport in vision_basedsensor_tpu/ops/jpeg.py
// (delta_idct_frames, split_idct_frames, tdelta_idct_frames). Contract:
//   out[p] = sum of val[e] over the entries with pos[e] == p, plus the same
//            over the optional second (spill) stream, for 0 <= p < total;
//   entries outside [0, total) are dropped.
// Each stream's positions are non-decreasing. Sums are taken in int32 and
// stored as int16, i.e. modulo 2^16, as the reference's int16 adds wrap.
//
// The TPU kernel built each (32, 512) output tile as a product of two bf16
// one-hots over a 2048-entry window, with scalar-prefetched tile starts and
// a scatter-add fix-up for overfull tiles: the MXU's way round the TPU's
// missing scatter. Hopper scatters into shared memory directly.
//
// Bound on the H100: memory. The dense output (B*blocks*64 int16, 157 MB at
// 256x480x640) is written once; the entries (6 B each, well under 1 M per
// batch) are read once. Design: one block per output tile of TILE slots.
// The block binary-searches its entry range [lo, hi) in each sorted stream
// (no prefetch pass, no entry budget: a block loops over however many
// entries its tile holds), zeroes an int32 tile in shared memory, adds its
// entries with shared-memory atomics (duplicates are adjacent and rare),
// and writes the tile out as int16 with 16-byte stores. So the zero-fill
// and the scatter are one pass over the output.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 4096;   // output slots per block (16 KB of int32)
constexpr int NT = 256;

// First index in [0, n) whose position is >= key (n if none).
__device__ __forceinline__ int lower_bound(const int* __restrict__ pos,
                                           int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (pos[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void add_range(int* tile, const int* __restrict__ pos,
                                          const int16_t* __restrict__ val,
                                          int lo, int hi, int base,
                                          unsigned len) {
  for (int e = lo + threadIdx.x; e < hi; e += NT) {
    // The unsigned test also keeps an unsorted stream (a broken contract)
    // inside shared memory: wrong sums, never a fault.
    const unsigned off = (unsigned)(pos[e] - base);
    if (off < len) atomicAdd(&tile[off], (int)val[e]);
  }
}

__global__ void __launch_bounds__(NT)
expand_sorted_kernel(const int* __restrict__ pos,
                     const int16_t* __restrict__ val, int n,
                     const int* __restrict__ spos,
                     const int16_t* __restrict__ sval, int m,
                     int16_t* __restrict__ out, int total) {
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
  add_range(tile, pos, val, range[0], range[1], base, len);
  add_range(tile, spos, sval, range[2], range[3], base, len);
  __syncthreads();
  if (len == TILE) {
    // 8 int16 per 16-byte store; base is a multiple of TILE, and the
    // wrapper passes a 16-byte-aligned output.
    uint4* dst = reinterpret_cast<uint4*>(out + base);
    for (int i = threadIdx.x; i < TILE / 8; i += NT) {
      const unsigned* t = reinterpret_cast<const unsigned*>(tile + 8 * i);
      uint4 v;   // little-endian: the even slot in the low half
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

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int vbs_expand_sorted(const int* pos, const int16_t* val, int n,
                                 const int* spos, const int16_t* sval, int m,
                                 int16_t* out, int total, void* stream) {
  if (total <= 0) return 0;
  const int blocks = (int)(((long long)total + TILE - 1) / TILE);
  expand_sorted_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(
      pos, val, n, spos, sval, m, out, total);
  return (int)cudaGetLastError();
}
