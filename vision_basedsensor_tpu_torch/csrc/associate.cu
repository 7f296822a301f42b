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
// Bound on the H100: the dependency chain. A frame's picks need the carry
// the previous frame left, so the B frames run in order, each N*K distances
// and N*N owner tests (65*97 and 65*65 on the main path) behind two
// reductions. Design: one block; each slot is a group of L lanes of one
// warp, which split the K distances and the N owner tests and reduce with
// shuffles, so every lane of the group ends with the same pick and flag and
// keeps the slot's carry in registers. The block stages a run of F frames'
// xy and valid (independent of the carry) in shared memory with coalesced
// loads, walks the run with one barrier a frame (the per-frame picks are
// double-buffered), and then writes the run's outputs with all threads,
// gathering axes and angle from global memory in parallel.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int L = 8;            // lanes per slot
constexpr int MAX_N = 128;      // slots: 1024 threads
constexpr int MAX_K = 1024;     // detections per frame
constexpr int SMEM = 40 * 1024; // dynamic shared memory for the staged run

// (a, ia) before (b, ib): NaN first, then by value, then by index.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (!na && a != b) return a < b;
  return ia < ib;
}

__global__ void __launch_bounds__(MAX_N * L)
associate_kernel(const float* __restrict__ ref_xy,
                 const bool* __restrict__ ref_valid,
                 const float* __restrict__ xy, const float* __restrict__ axes,
                 const float* __restrict__ angle,
                 const bool* __restrict__ valid, const float* __restrict__ carry,
                 int b, int n, int k, int frames, float gate,
                 float* __restrict__ out_xy, float* __restrict__ out_axes,
                 float* __restrict__ out_angle, bool* __restrict__ out_valid,
                 float* __restrict__ last_out) {
  extern __shared__ float4 smem4[];
  float* sxy = reinterpret_cast<float*>(smem4);           // [frames][k][2]
  int* pick = reinterpret_cast<int*>(sxy + frames * k * 2); // [frames][n]
  bool* sval = reinterpret_cast<bool*>(pick + frames * n);  // [frames][k]
  __shared__ int cur_j[2][MAX_N];
  __shared__ float cur_d[2][MAX_N];

  const int s = threadIdx.x / L, l = threadIdx.x % L;
  const bool active = s < n;
  const bool rv = active && ref_valid[s];
  const float* init = carry != nullptr ? carry : ref_xy;
  float lx = active ? init[2 * s] : 0.f, ly = active ? init[2 * s + 1] : 0.f;

  for (long long t0 = 0; t0 < b; t0 += frames) {
    const int nf = (int)min((long long)frames, b - t0);
    for (int i = threadIdx.x; i < nf * k * 2; i += blockDim.x)
      sxy[i] = xy[t0 * k * 2 + i];
    for (int i = threadIdx.x; i < nf * k; i += blockDim.x)
      sval[i] = valid[t0 * k + i];
    __syncthreads();
    for (int f = 0; f < nf; ++f) {
      const int p = f & 1;
      // This lane's share of the argmin over K.
      float bd = INFINITY;
      int bk = INT_MAX;
      for (int c = l; c < k; c += L) {
        float d = INFINITY;
        if (rv && sval[f * k + c]) {
          const float dx = __fsub_rn(lx, sxy[(f * k + c) * 2]);
          const float dy = __fsub_rn(ly, sxy[(f * k + c) * 2 + 1]);
          d = sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
        }
        if (before(d, c, bd, bk)) { bd = d; bk = c; }
      }
      for (int o = L / 2; o > 0; o >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, bd, o);
        const int ok_ = __shfl_xor_sync(0xffffffffu, bk, o);
        if (before(od, ok_, bd, bk)) { bd = od; bk = ok_; }
      }
      if (active && l == 0) { cur_j[p][s] = bk; cur_d[p][s] = bd; }
      __syncthreads();
      // Owner: is there a slot r before me in (j[r] == j ? dmin[r] : inf, r)?
      bool beaten = false;
      if (active) {
        for (int r = l; r < n; r += L) {
          const float v = cur_j[p][r] == bk ? cur_d[p][r] : INFINITY;
          beaten |= before(v, r, bd, s);
        }
      }
      for (int o = L / 2; o > 0; o >>= 1)
        beaten |= __shfl_xor_sync(0xffffffffu, (int)beaten, o) != 0;
      const bool ok = rv && (bd <= gate) && !beaten;
      if (ok) { lx = sxy[(f * k + bk) * 2]; ly = sxy[(f * k + bk) * 2 + 1]; }
      if (active && l == 0) pick[f * n + s] = ok ? bk : -1;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nf * n; i += blockDim.x) {
      const int f = i / n;
      const int j = pick[i];
      const long long o = t0 * n + i;            // (t0 + f) * n + slot
      const long long src = (t0 + f) * k + j;
      const bool ok = j >= 0;
      out_xy[2 * o] = ok ? sxy[(f * k + j) * 2] : 0.f;
      out_xy[2 * o + 1] = ok ? sxy[(f * k + j) * 2 + 1] : 0.f;
      out_axes[2 * o] = ok ? axes[2 * src] : 0.f;
      out_axes[2 * o + 1] = ok ? axes[2 * src + 1] : 0.f;
      out_angle[o] = ok ? angle[src] : 0.f;
      out_valid[o] = ok;
    }
    __syncthreads();
  }
  if (active && l == 0) { last_out[2 * s] = lx; last_out[2 * s + 1] = ly; }
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
  // A staged frame: xy 8 B and valid 1 B a detection, the pick 4 B a slot
  // (at least 4 frames fit at the largest n and k).
  const int per_frame = k * 9 + n * 4;
  const int frames = min(64, SMEM / per_frame);
  const int threads = (n * L + 31) / 32 * 32;
  const size_t smem = (size_t)frames * per_frame;
  associate_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      ref_xy, ref_valid, xy, axes, angle, valid, carry, b, n, k, frames, gate,
      out_xy, out_axes, out_angle, out_valid, last_out);
  return (int)cudaGetLastError();
}
