// Sequential (last-sighting) marker association over frames, in one launch.
//
// Replaces the lax.scan of vision_basedsensor_tpu/track/associate.py
// (associate_sequential, step :83-108, the scan at :111); there is no Pallas
// kernel for it. The plain version is
// track/associate.py:associate_sequential_reference. Per frame t, with the
// carry last (N, 2):
//   d[s, k] = |last[s] - xy_t[k]| if valid_t[k] & ref_valid[s] else inf
//   j[s] = argmin_k d[s, k]; dmin[s] = min_k d[s, k]   (first index of ties)
//   owner[s] = argmin_r (j[r] == j[s] ? dmin[r] : inf)  (first index of ties)
//   ok[s] = ref_valid[s] & (dmin[s] <= gate) & (owner[s] == s)
//   outputs xy/axes/angle at j where ok, else 0; last[s] = ok ? xy_t[j] : last
// Distances are sqrtf(dx*dx + dy*dy) with each product and the sum rounded
// on its own (no FMA contraction), the plain version's order. A NaN counts
// as the least value and equal values go to the lower index, as
// torch.argmin and jnp.argmin do.
//
// Bound on the H100: a frame's picks need the carry the previous frame
// left, so the B frames run in order on one block, each N x K candidate
// tests (65 x 65 valid of 96 on the main path) behind a reduction and an
// owner test. A frame is a chain of dependent shared-memory loads,
// shuffles, an atomic and a barrier, so its time is that chain's length.
// The first design (8 lanes a slot; a byte load of `valid`, a correctly
// rounded sqrtf and a NaN-aware compare a candidate; an N x N owner loop
// behind its own barrier; runs staged and written between block barriers)
// took ~2.9 us a frame. This design shortens the chain:
//   - producer warps (PW) stage each run of F frames into one of two
//     shared-memory buffers while the walker warps walk the other: a
//     frame's valid detections compacted in index order (xy, axes, angle
//     and the original index), their count, and a flag if one has a NaN
//     coordinate; the row is padded with +inf positions to the next 32.
//     When the walkers leave a run, the producers write its outputs
//     (coalesced, from the walkers' picks and the staged values) and
//     refill the buffer. Handoff by named barriers (full/empty per
//     buffer); the walkers meet once a frame on their own barrier.
//   - a slot is LANES lanes of a walker warp that split the frame's valid
//     candidates (pick_fast): a candidate is its squared distance
//     (products and sum rounded as the plain version's) and one compare,
//     loads four at a time. sqrtf is monotone, so the least square gives
//     the least root; a larger square with the same rounded root at a
//     smaller position (the plain version's pick on a tie) is settled on
//     the roots in a rare second pass. Invalid detections are skipped:
//     their inf ties go to index 0, the scan's starting best. A frame with
//     a valid NaN coordinate, or a warp with a carry that is not finite,
//     takes the NaN-aware compare (scan, reduce). Exact: the plain
//     version's pick and tie order.
//   - owner test: each slot's (dmin order, slot) packs into 64 bits and
//     takes a shared-memory atomicMin at its pick (three arrays by frame,
//     so one barrier a frame suffices and each entry is reset two frames
//     later); a slot owns its pick if its key is the minimum.
//   - a slot keeps its carry in registers and stores its pick; nothing of
//     the output is on the walk.
// On the card (chip_smoke.py --only scans, 1024 x 65 x 96) the walk takes
// ~1.2 us a frame against the first design's 2.9: cutting the candidate
// scan or the owner test each saves ~0.28 us; the rest is the chain of
// shuffles, loads and selects around them. Eight or two lanes a slot and
// four producer warps measured no faster.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_N = 128;          // slots
constexpr int MAX_K = 1024;         // detections a frame (an index in int16)
constexpr int PW = 8;               // producer warps
constexpr int LANES = 4;            // lanes a slot: 16 walker warps at most
constexpr int RUN_BYTES = 48 * 1024;  // a staging buffer
constexpr float LO = 0.9999990463256836f;   // 1 - 2^-20
// Named barriers (0 is __syncthreads).
constexpr int BAR_FRAME = 1, BAR_FULL = 2, BAR_EMPTY = 4;
typedef unsigned long long u64;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// A staged run: per frame, the valid detections in index order, and the
// walkers' picks.
struct Run {
  float2* xy;     // [F][K]
  float2* axes;   // [F][K]
  float* angle;   // [F][K]
  short* idx;     // [F][K] original index
  int* cnt;       // [F] valid detections
  int* nan;       // [F] 1 if one of them has a NaN coordinate
  int* pick;      // [F][N] staged position of an owned pick, -1 none, -2
                  // detection 0 unstaged (an invalid pick: gate +inf)
};

// A frame's staged row holds ks = k rounded up to 32 detections (the fast
// path reads whole groups of 4 LANES).
__host__ __device__ inline int row(int k) { return (k + 31) / 32 * 32; }

__host__ __device__ inline size_t staged_bytes(int frames, int k) {
  return ((size_t)frames * row(k) * 22 + 15) / 16 * 16;
}

__host__ __device__ inline size_t run_bytes(int frames, int k, int n) {
  return (staged_bytes(frames, k) + (size_t)frames * (8 + 4 * n) + 15) / 16 *
         16;
}

__device__ __forceinline__ Run run_at(char* base, int frames, int k) {
  Run r;
  const size_t fk = (size_t)frames * row(k);
  r.xy = reinterpret_cast<float2*>(base);
  r.axes = r.xy + fk;
  r.angle = reinterpret_cast<float*>(r.axes + fk);
  r.idx = reinterpret_cast<short*>(r.angle + fk);
  r.cnt = reinterpret_cast<int*>(base + staged_bytes(frames, k));
  r.nan = r.cnt + frames;
  r.pick = r.nan + frames;
  return r;
}

// (sqrt(ka), ia) before (sqrt(kb), ib), square roots rounded, NaN first,
// ties by index: the plain version's order on the distances, read from the
// squared distances.
__device__ __forceinline__ bool before(float ka, int ia, float kb, int ib) {
  const bool na = isnan(ka), nb = isnan(kb);
  if (na || nb) return na && (!nb || ia < ib);
  if (ka == kb) return ia < ib;
  if (ka < kb)
    return ka < __fmul_rn(kb, LO) || sqrtf(ka) != sqrtf(kb) || ia < ib;
  return !(kb < __fmul_rn(ka, LO)) && sqrtf(ka) == sqrtf(kb) && ia < ib;
}

// The NaN-aware path: this lane's best of the frame's valid candidates
// p = l, l + LANES, ... (ascending, so a tie keeps the earlier one).
__device__ __forceinline__ void scan(const float2* __restrict__ q, int cnt,
                                     int l, float lx, float ly, float& bkey,
                                     int& bpos) {
  for (int p = l; p < cnt; p += LANES) {
    const float2 v = q[p];
    const float dx = __fsub_rn(lx, v.x), dy = __fsub_rn(ly, v.y);
    const float key = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    if (before(key, p, bkey, bpos)) { bkey = key; bpos = p; }
  }
}

// The fast path, for a frame whose valid candidates have no NaN
// coordinate and a warp whose carries are finite. The lane reads its
// candidates in
// groups of 4 (loads first); the producers padded the frame's row with
// +inf positions up to the next 32, whose squares are +inf and never win.
// A candidate is its square and one compare: the lane keeps the least
// square (the first of equal ones), its position, and the least square
// before it. The lanes then meet in a 64-bit integer minimum of (square
// bits + 1, position + 1) over log2(LANES) shuffle rounds (integer order =
// float order for nonnegative squares). That minimum differs from the
// plain version's pick only where a larger square with the same rounded
// root lies at a smaller position: every such square is within
// (1 + 2^-19) of the least, and a lane can hold one only if its best (when
// at a smaller position) or the best before it is that close; then (rare)
// the lane walks its candidates again and the slot settles it on the
// roots. Returns the pick's position (-1: index 0, the best while every
// distance is inf) and sets kmin to the least square.
__device__ __forceinline__ int pick_fast(const float2* __restrict__ q,
                                         int cnt, int l, float lx, float ly,
                                         float& kmin) {
  float bk = INFINITY, bprev = INFINITY;
  int bp = -1;
  const float2* ql = q + l;
#pragma unroll 4
  for (int p0 = 0; p0 < cnt; p0 += 4 * LANES) {
    float2 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = ql[p0 + LANES * u];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float dx = __fsub_rn(lx, v[u].x), dy = __fsub_rn(ly, v[u].y);
      const float key = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      const bool lt = key < bk;
      bprev = lt ? bk : bprev;
      bk = lt ? key : bk;
      bp = lt ? p0 + LANES * u + l : bp;
    }
  }
  u64 best = (u64)(__float_as_uint(bk) + 1u) << 32 | (unsigned)(bp + 1);
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) {
    const u64 other = __shfl_xor_sync(0xffffffffu, best, o);
    best = other < best ? other : best;
  }
  kmin = __uint_as_float((unsigned)(best >> 32) - 1u);
  int mpos = (int)(unsigned)best - 1;
  const float hi = __fmul_ru(kmin, 1.0000019073486328f);   // 1 + 2^-19
  const bool near = mpos >= 0 && (bp < mpos ? bk <= hi : bprev <= hi);
  if (__any_sync(0xffffffffu, near)) {   // a tie after rounding (rare)
    const float root = sqrtf(kmin);
    int cand = INT_MAX;
    for (int p = l; p < mpos && p < cnt; p += LANES) {
      const float2 v = q[p];
      const float dx = __fsub_rn(lx, v.x), dy = __fsub_rn(ly, v.y);
      const float key = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      if (key <= hi && sqrtf(key) == root) { cand = p; break; }
    }
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1)
      cand = min(cand, __shfl_xor_sync(0xffffffffu, cand, o));
    mpos = min(mpos, cand);
  }
  return mpos;
}

// The NaN-aware lanes' bests meet in a 64-bit integer minimum of (the key's
// order, position): NaN 0, a nonnegative square its bits + 1; the position
// + 1 below it. A lane whose square is larger but whose root may equal the
// least one's and whose position is smaller (rare) settles it on the roots.
__device__ __forceinline__ int reduce(float bkey, int bpos, float& kmin) {
  const unsigned ord = isnan(bkey) ? 0u : __float_as_uint(bkey) + 1u;
  u64 best = (u64)ord << 32 | (unsigned)(bpos + 1);
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) {
    const u64 other = __shfl_xor_sync(0xffffffffu, best, o);
    best = other < best ? other : best;
  }
  const unsigned mord = (unsigned)(best >> 32);
  const int mpos = (int)(unsigned)best - 1;
  kmin = mord == 0u ? __int_as_float(0x7fffffff) : __uint_as_float(mord - 1u);
  const bool near = mord != 0u && bpos >= 0 && bpos < mpos && bkey > kmin &&
                    !(kmin < __fmul_rn(bkey, LO));
  if (!__any_sync(0xffffffffu, near)) return mpos;
  int cand = bpos >= 0 && bkey == bkey && sqrtf(bkey) == sqrtf(kmin)
                 ? bpos : INT_MAX;
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
    cand = min(cand, __shfl_xor_sync(0xffffffffu, cand, o));
  return mord != 0u && cand != INT_MAX ? cand : mpos;
}

// Producers: stage run frames [t0, t0 + nf) into r, one frame a warp at a
// time, all of a chunk group's loads issued before the first is used.
__device__ void stage(const Run& r, const float* __restrict__ xy,
                      const float* __restrict__ axes,
                      const float* __restrict__ angle,
                      const bool* __restrict__ valid, long long t0, int nf,
                      int k, int pw, int lane) {
  constexpr int U = 4;   // 32-detection chunks a group
  const int ks = row(k);
  for (int f = pw; f < nf; f += PW) {
    const long long base = (t0 + f) * k;
    int cnt = 0;
    bool any_nan = false;
    for (int c0 = 0; c0 < k; c0 += 32 * U) {
      bool v[U];
      float x[U], y[U], a0[U], a1[U], an[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = c0 + 32 * u + lane;
        const bool in = c < k;
        const long long i = base + (in ? c : 0);
        v[u] = in && valid[i];
        x[u] = in ? xy[2 * i] : 0.f;
        y[u] = in ? xy[2 * i + 1] : 0.f;
        a0[u] = in ? axes[2 * i] : 0.f;
        a1[u] = in ? axes[2 * i + 1] : 0.f;
        an[u] = in ? angle[i] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const uint32_t bal = __ballot_sync(0xffffffffu, v[u]);
        if (v[u]) {
          const int p = f * ks + cnt + __popc(bal & ((1u << lane) - 1u));
          r.xy[p] = make_float2(x[u], y[u]);
          r.axes[p] = make_float2(a0[u], a1[u]);
          r.angle[p] = an[u];
          r.idx[p] = (short)(c0 + 32 * u + lane);
          any_nan |= isnan(x[u]) || isnan(y[u]);
        }
        cnt += __popc(bal);
      }
    }
    any_nan = __any_sync(0xffffffffu, any_nan);
    // +inf past the last valid detection up to the next 32 (fast path).
    if (cnt + lane < row(cnt))
      r.xy[f * ks + cnt + lane] = make_float2(INFINITY, INFINITY);
    if (lane == 0) { r.cnt[f] = cnt; r.nan[f] = any_nan; }
  }
}

// Producers: the outputs of run frames [t0, t0 + nf), from the picks,
// consecutive (frame, slot) pairs on consecutive threads.
__device__ void write_run(const Run& r, const float* __restrict__ xy,
                          const float* __restrict__ axes,
                          const float* __restrict__ angle, long long t0,
                          int nf, int n, int k, int me, int count,
                          float* __restrict__ out_xy,
                          float* __restrict__ out_axes,
                          float* __restrict__ out_angle,
                          bool* __restrict__ out_valid) {
  for (int i = me; i < nf * n; i += count) {
    const int p = r.pick[i];
    const long long o = t0 * n + i;
    float2 v = make_float2(0.f, 0.f), a = v;
    float an = 0.f;
    if (p >= 0) {
      const int at = i / n * row(k) + p;
      v = r.xy[at]; a = r.axes[at]; an = r.angle[at];
    } else if (p == -2) {
      const long long src = (t0 + i / n) * k;
      v = make_float2(xy[2 * src], xy[2 * src + 1]);
      a = make_float2(axes[2 * src], axes[2 * src + 1]);
      an = angle[src];
    }
    out_xy[2 * o] = v.x; out_xy[2 * o + 1] = v.y;
    out_axes[2 * o] = a.x; out_axes[2 * o + 1] = a.y;
    out_angle[o] = an;
    out_valid[o] = p != -1;
  }
}

__global__ void __launch_bounds__((MAX_N * LANES / 32 + PW) * 32)
associate_kernel(const float* __restrict__ ref_xy,
                 const bool* __restrict__ ref_valid,
                 const float* __restrict__ xy, const float* __restrict__ axes,
                 const float* __restrict__ angle,
                 const bool* __restrict__ valid, const float* __restrict__ carry,
                 int b, int n, int k, int frames, int run_stride, float gate,
                 float* __restrict__ out_xy, float* __restrict__ out_axes,
                 float* __restrict__ out_angle, bool* __restrict__ out_valid,
                 float* __restrict__ last_out) {
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  u64* own = reinterpret_cast<u64*>(sm + 2 * (size_t)run_stride);  // [3][K+1]
  const int wt = blockDim.x - 32 * PW;     // walker threads
  const int all = blockDim.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < 3 * (k + 1); i += all) own[i] = ~0ull;
  __syncthreads();
  const int runs = (int)((b + frames - 1) / frames);

  if (tid >= wt) {   // producer warps
    const int pw = (tid - wt) >> 5, lane = tid & 31;
    for (int r = 0; r < runs && r < 2; ++r) {
      const long long t0 = (long long)r * frames;
      stage(run_at(sm + r * (size_t)run_stride, frames, k), xy, axes, angle,
            valid, t0, (int)min((long long)frames, b - t0), k, pw, lane);
      bar_arrive(BAR_FULL + r, all);
    }
    for (int r = 0; r < runs; ++r) {
      const int bf = r & 1;
      const Run run = run_at(sm + bf * (size_t)run_stride, frames, k);
      bar_sync(BAR_EMPTY + bf, all);   // the walkers left run r
      const long long t0 = (long long)r * frames;
      write_run(run, xy, axes, angle, t0,
                (int)min((long long)frames, b - t0), n, k, tid - wt, all - wt,
                out_xy, out_axes, out_angle, out_valid);
      if (r + 2 < runs) {
        const long long t2 = t0 + 2LL * frames;
        // The outputs read the buffer: the warp's own reads are done, but
        // another warp's may not be.
        asm volatile("bar.sync 6, %0;" ::"r"(all - wt) : "memory");
        stage(run, xy, axes, angle, valid, t2,
              (int)min((long long)frames, b - t2), k, pw, lane);
        bar_arrive(BAR_FULL + bf, all);
      }
    }
    return;
  }

  const int s = tid / LANES, l = tid % LANES;
  const bool active = s < n;
  const bool rv = active && ref_valid[s];
  const float* init = carry != nullptr ? carry : ref_xy;
  float lx = active ? init[2 * s] : 0.f, ly = active ? init[2 * s + 1] : 0.f;
  int jprev = -1, cur = 0;   // own array of this frame; the last frame's pick
  for (int r = 0; r < runs; ++r) {
    const int bf = r & 1;
    bar_sync(BAR_FULL + bf, all);
    const Run run = run_at(sm + bf * (size_t)run_stride, frames, k);
    const long long t0 = (long long)r * frames;
    const int nf = (int)min((long long)frames, b - t0);
    int cnt = run.cnt[0], nanf = run.nan[0];
    for (int f = 0; f < nf; ++f) {
      const int cnt_next = f + 1 < nf ? run.cnt[f + 1] : 0;
      const int nan_next = f + 1 < nf ? run.nan[f + 1] : 0;
      const float2* q = run.xy + f * row(k);
      float kmin = INFINITY;
      int pos = -1;   // -1: index 0, the best while every distance is inf
      // The path is the warp's: both take shuffles over the whole warp.
      if (!nanf &&
          __all_sync(0xffffffffu, isfinite(lx) && isfinite(ly))) {
        const int pf = pick_fast(q, rv ? cnt : 0, l, lx, ly, kmin);
        if (rv) pos = pf;
      } else {
        float bkey = INFINITY;
        int bpos = -1;
        if (rv) scan(q, cnt, l, lx, ly, bkey, bpos);
        pos = reduce(bkey, bpos, kmin);
      }
      // The owner test runs on staged positions + 1; 0 is index 0 while
      // it is not staged (every distance inf), else its position 0 + 1.
      const int jo = pos >= 0 ? pos + 1
                              : (cnt > 0 && run.idx[f * row(k)] == 0 ? 1 : 0);
      const float2 cand = pos >= 0 ? q[pos] : make_float2(lx, ly);
      const float dmin = pos < 0 ? INFINITY : sqrtf(kmin);
      const u64 key =
          (u64)(isnan(dmin) ? 0u : __float_as_uint(dmin) + 1u) << 32 |
          (unsigned)s;
      u64* own_t = own + cur * (k + 1);
      if (active && l == 0) atomicMin(own_t + jo, key);
      bar_sync(BAR_FRAME, wt);
      // A slot at inf owns its pick only as slot 0: every other slot's
      // value is inf too, and ties go to the first slot.
      const bool ok = rv && dmin <= gate && own_t[jo] == key &&
                      (dmin != INFINITY || s == 0);
      const int prev = cur == 0 ? 2 : cur - 1;
      if (active && l == 0) {
        if (jprev >= 0) own[prev * (k + 1) + jprev] = ~0ull;
        run.pick[f * n + s] = ok ? (pos >= 0 ? pos : -2) : -1;
      }
      jprev = jo;
      cur = cur == 2 ? 0 : cur + 1;
      if (ok) { lx = cand.x; ly = cand.y; }
      // An invalid pick (only where gate is +inf) reads detection 0.
      if (__any_sync(0xffffffffu, ok && pos < 0) && ok && pos < 0) {
        const long long src = (t0 + f) * k;
        lx = xy[2 * src]; ly = xy[2 * src + 1];
      }
      cnt = cnt_next;
      nanf = nan_next;
    }
    bar_arrive(BAR_EMPTY + bf, all);
  }
  if (active && l == 0) { last_out[2 * s] = lx; last_out[2 * s + 1] = ly; }
}

int launch(const float* ref_xy, const bool* ref_valid, const float* xy,
           const float* axes, const float* angle, const bool* valid,
           const float* carry, int b, int n, int k, float gate, float* out_xy,
           float* out_axes, float* out_angle, bool* out_valid, float* last_out,
           cudaStream_t stream) {
  // A staged frame: xy, axes 8 B, angle 4 B and the index 2 B a detection,
  // two ints and a pick a slot; a run is as many frames as RUN_BYTES holds
  // (at least 1), at most 64.
  const int per_frame = row(k) * 22 + 8 + 4 * n;
  const int frames = max(1, min(min(64, RUN_BYTES / per_frame), b));
  const int stride = (int)run_bytes(frames, k, n);
  const size_t smem = 2 * (size_t)stride + 3 * (size_t)(k + 1) * 8;
  cudaError_t err = cudaFuncSetAttribute(
      associate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (n * LANES + 31) / 32 * 32 + 32 * PW;
  associate_kernel<<<1, threads, smem, stream>>>(
      ref_xy, ref_valid, xy, axes, angle, valid, carry, b, n, k, frames,
      stride, gate, out_xy, out_axes, out_angle, out_valid, last_out);
  return (int)cudaGetLastError();
}

}  // namespace

// ref_xy (n, 2) f32, ref_valid (n) bool; xy/axes (b, k, 2), angle (b, k)
// f32, valid (b, k) bool; carry (n, 2) or null (start from ref_xy).
// Outputs (b, n, 2), (b, n, 2), (b, n), (b, n) bool and last_out (n, 2).
// 1 <= n <= 128 and 1 <= k <= 1024 (the wrapper checks). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int vbs_associate_sequential(
    const float* ref_xy, const bool* ref_valid, const float* xy,
    const float* axes, const float* angle, const bool* valid,
    const float* carry, int b, int n, int k, float gate, float* out_xy,
    float* out_axes, float* out_angle, bool* out_valid, float* last_out,
    void* stream) {
  if (n < 1 || n > MAX_N || k < 1 || k > MAX_K)
    return (int)cudaErrorInvalidValue;
  return launch(ref_xy, ref_valid, xy, axes, angle, valid, carry, b, n, k,
                gate, out_xy, out_axes, out_angle, out_valid, last_out,
                (cudaStream_t)stream);
}
