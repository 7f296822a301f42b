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
// Bound on the H100: memory. The dense output (157 MB at 256x480x640) is
// written once; the entries (6 B each, under 1 M a batch) are read once.
// Design: persistent blocks. The output is cut into tiles of TILE slots;
// each of G blocks (as many as fit on the card at once) owns a contiguous
// run of tiles, at most MAX_RUN. Runs are balanced by work, not by length:
// a tile weighs W entries, and block b takes the tiles whose weighted start
// falls in the b-th G-th of the total weight (a merge path over tile starts
// and entries, found by one warp: 32 probes a round, each one load, since
// "the first j entries lie before tile i" is a single comparison). TDELTA
// puts 13% of a batch's entries in the first frame's 75 tiles (0.4% of
// them): split by length, the heaviest of 792 blocks got 22,108 entries
// where the average got 537, and it set the kernel's time (0.096 ms against
// 0.062); split by weight, the heaviest gets 5,536.
// Four warps then find the run's entry range in both streams at once, each
// with a 32-ary search (4 dependent loads for 441 K entries, against ~19
// for a binary search), and one pass over the run's entries records where
// each tile's entries start (tile i's end is tile i+1's start), so no tile
// searches again. Tiles are built in two shared-memory int32 buffers in
// turn: zero, add the tile's entries with shared atomics (duplicates are
// adjacent and rare), then pack to int16 and write with 16-byte streaming
// stores, which drain while the next tile is zeroed and added.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 4096;    // output slots per tile (16 KB of int32)
constexpr int NT = 256;
constexpr int MAX_RUN = 64;   // tiles a block owns at most
constexpr int W = 256;        // a tile's weight in entries, for the split

// First index in [0, n) whose position is >= key (n if none), found by one
// warp: each round tests 32 evenly spaced pivots with one ballot; those
// below the key are a prefix, so the answer lies after the last of them.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ pos,
                                                int n, int key) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;   // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int q = lo + lane * step;
    const bool below = q < hi && pos[q] < key;
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    if (c == 0) {
      hi = lo;
    } else {
      const int base = lo;
      lo = base + (c - 1) * step + 1;
      hi = min(hi, base + c * step);
    }
  }
  return lo;
}

// The first tile i in [0, tiles] whose weighted start i * W + lb(i * TILE)
// is >= d (tiles if none), found by one warp. lb(x) >= j holds exactly
// when the j-th entry lies before x, so each probe is one load.
__device__ __forceinline__ int warp_split(const int* __restrict__ pos, int n,
                                          long long d, int tiles) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = tiles;
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int q = lo + lane * step;
    bool below = false;   // the weighted start of tile q is < d
    if (q < hi) {
      const long long j = d - (long long)q * W;
      below = j > 0 && (j > n || (long long)pos[j - 1] >= (long long)q * TILE);
    }
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    if (c == 0) {
      hi = lo;
    } else {
      const int base = lo;
      lo = base + (c - 1) * step + 1;
      hi = min(hi, base + c * step);
    }
  }
  return lo;
}

// start[r] = first entry of [lo, hi) in local tile r of the run at slot s0,
// for r in [0, run]; tiles past the last entry start at hi.
__device__ __forceinline__ void tile_starts(const int* __restrict__ pos,
                                            int lo, int hi, int s0, int run,
                                            int* start) {
#pragma unroll 4
  for (int e = lo + threadIdx.x; e < hi; e += NT) {
    const int t = (pos[e] - s0) / TILE;
    const int prev = e == lo ? -1 : (pos[e - 1] - s0) / TILE;
    for (int r = prev + 1; r <= t; ++r) start[r] = e;
  }
}

__device__ __forceinline__ void add_range(int* tile, const int* __restrict__ pos,
                                          const int16_t* __restrict__ val,
                                          int lo, int hi, int base,
                                          unsigned len) {
#pragma unroll 4
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
                     int16_t* __restrict__ out, int total, int tiles) {
  __shared__ int4 buf[2][TILE / 4];
  __shared__ int start[2][MAX_RUN + 1];
  __shared__ int range[4];
  __shared__ int split[2];
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {   // this block's first tile and the next block's
    const unsigned b = blockIdx.x + warp;
    const long long weight = (long long)tiles * W + n;
    const int t = b == gridDim.x
        ? tiles : warp_split(pos, n, weight * b / gridDim.x, tiles);
    if ((threadIdx.x & 31) == 0) split[warp] = t;
  }
  __syncthreads();
  const int t0 = split[0], run = split[1] - split[0];
  const int s0 = (int)min((long long)t0 * TILE, (long long)total);
  const int s1 = (int)min((long long)split[1] * TILE, (long long)total);

  if (warp < 4) {
    const int key = (warp & 1) ? s1 : s0;
    const int r = warp < 2 ? warp_lower_bound(pos, n, key)
                           : warp_lower_bound(spos, m, key);
    if ((threadIdx.x & 31) == 0) range[warp] = r;
  }
  __syncthreads();
  for (int r = threadIdx.x; r <= run; r += NT) {
    start[0][r] = range[1];
    start[1][r] = range[3];
  }
  __syncthreads();
  tile_starts(pos, range[0], range[1], s0, run, start[0]);
  tile_starts(spos, range[2], range[3], s0, run, start[1]);

  for (int r = 0; r < run; ++r) {
    int* tile = reinterpret_cast<int*>(buf[r & 1]);
    const int base = (t0 + r) * TILE;
    const unsigned len = (unsigned)min(TILE, total - base);
    for (int i = threadIdx.x; i < TILE / 4; i += NT)
      buf[r & 1][i] = make_int4(0, 0, 0, 0);
    __syncthreads();   // also publishes start[] before the first tile
    add_range(tile, pos, val, start[0][r], start[0][r + 1], base, len);
    add_range(tile, spos, sval, start[1][r], start[1][r + 1], base, len);
    __syncthreads();
    // The other buffer is zeroed next: this one is not written again before
    // two more barriers, so its reads here need no barrier after them.
    if (len == TILE) {
      // 8 int16 per 16-byte store; base is a multiple of TILE, and the
      // wrapper passes a 16-byte-aligned output.
      uint4* dst = reinterpret_cast<uint4*>(out + base);
      for (int i = threadIdx.x; i < TILE / 8; i += NT) {
        const int4 a = buf[r & 1][2 * i], b = buf[r & 1][2 * i + 1];
        uint4 v;   // little-endian: the even slot in the low half
        v.x = ((unsigned)a.x & 0xFFFFu) | ((unsigned)a.y << 16);
        v.y = ((unsigned)a.z & 0xFFFFu) | ((unsigned)a.w << 16);
        v.z = ((unsigned)b.x & 0xFFFFu) | ((unsigned)b.y << 16);
        v.w = ((unsigned)b.z & 0xFFFFu) | ((unsigned)b.w << 16);
        __stcs(dst + i, v);
      }
    } else {
      for (int i = threadIdx.x; i < (int)len; i += NT)
        out[base + i] = (int16_t)tile[i];
    }
  }
}

// Blocks resident on the current device at once (cached per device).
int resident_blocks() {
  static int cached_dev = -1, cached = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev != cached_dev) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, expand_sorted_kernel, NT, 0) != cudaSuccess)
      return 0;
    cached_dev = dev;
    cached = sms * per_sm;
  }
  return cached;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int vbs_expand_sorted(const int* pos, const int16_t* val, int n,
                                 const int* spos, const int16_t* sval, int m,
                                 int16_t* out, int total, void* stream) {
  if (total <= 0) return 0;
  const int tiles = (int)(((long long)total + TILE - 1) / TILE);
  const int resident = resident_blocks();
  if (resident <= 0) return (int)cudaGetLastError();
  // As many blocks as fit at once, but enough that a block's share of the
  // weight spans at most MAX_RUN - 1 tiles (so its run, MAX_RUN).
  const long long weight = (long long)tiles * W + n;
  const int blocks = (int)max((long long)min(tiles, resident),
                              (weight + (long long)W * (MAX_RUN - 1) - 1) /
                                  ((long long)W * (MAX_RUN - 1)));
  expand_sorted_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(
      pos, val, n, spos, sval, m, out, total, tiles);
  return (int)cudaGetLastError();
}
