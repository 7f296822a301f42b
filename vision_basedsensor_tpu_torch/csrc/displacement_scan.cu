// The last-sighting displacement scan over frames, in one launch.
//
// Replaces the lax.scan of vision_basedsensor_tpu/reconstruct/displacement.py
// (displacement_scan, step_fn :60-80, the scan at :82); there is no Pallas
// kernel for it. The plain version is
// reconstruct/displacement.py:displacement_scan_reference. Per marker n and
// frame t, with the carry (last, last_ok, first, first_ok, cum):
//   d = pos - last;  dn = |d|;  emit = last_ok & ok & (dn <= max_step)
//   step = emit ? d : 0;  step_norm = emit ? dn : 0;  cum += step_norm
//   first = (!first_ok & ok) ? pos : first;  first_ok |= ok
//   from_first = ok ? pos - first : 0;  from_first_norm = |from_first|
//   last = ok ? pos : last;  last_ok |= ok
// Norms are sqrtf((x*x + y*y) + z*z) with every product and sum rounded on
// its own (__fmul_rn/__fadd_rn: no FMA contraction), the plain version's
// order, so the two agree bit for bit; cum keeps the sequential add order.
//
// Bound on the H100: the `cum` chain, not bytes. The inputs (13 B per
// marker-frame) and outputs (37 B) of a 1024-frame, 65-marker batch are
// 3.3 MB, 1 us at 3.35 TB/s; the one float chain, B dependent adds a
// marker, is ~2 us at 4 cycles an add. The first design walked every
// frame's whole step on one warp a 32 markers (3 blocks, ~190 ns a frame,
// 0.195 ms at 1024 x 65): its walk held it (0.153 ms without its stores;
// its staging alone 0.105, hidden under the walk). Everything of the
// carry but `cum` is a function of the `seen` prefix: `last` is the
// position at the last sighting before t (or the carry's), `first` the
// one at the first sighting (or the carry's), exact integer max/min scans. So, above SMALL_B frames:
//   - a block owns G markers (grid ceil(N / G)) and takes the frames in
//     tiles of up to T; the carry crosses tiles in shared memory;
//   - the tile's positions are staged row by row, and the `seen` bits
//     become one 32-bit mask a marker and 32 frames (a warp ballot, its G
//     interleaved pieces OR-ed into the words);
//   - one warp a marker finds, for each mask word, the last earlier word
//     with a sighting (a ballot over the words); then the warps after the
//     first take the (frame, marker) pairs in chunks of CH frames, find
//     the last sighting before a frame with __clz and the first with
//     __ffs, compute step, emit, from_first and the norms in the plain
//     version's order, store them and stage dnz;
//   - only `cum` walks: warp 0, one thread a marker, adds a chunk's dnz in
//     frame order as soon as the chunk is staged (a named barrier a
//     chunk), the next 16 loaded while it adds the current 16; the block
//     stores cum_path.
// Up to SMALL_B frames one thread a marker walks them, with all their
// loads issued first (the first design without its staging). On the card
// (chip_smoke.py --only scans, 65 markers) the tiled kernel alone takes
// 0.0050-0.0051 ms at any batch from 1 to 32 frames, its fixed phases;
// the walking kernel 0.0025 ms at 1 frame and 0.0038 at 8, and the first
// design 0.0030 and 0.0050. A walking kernel up to 16 frames gained
// 0.0001 ms at 13 frames, lost 0.0002-0.0003 at 1-8 and 0.0007 at 16.
// 1024 x 65 takes ~0.02 ms, ~0.013 ms of it without the per-pair stores:
// a block's outputs are 2-24 B a frame row, scattered over the rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G = 2;         // markers a block; divides 32
constexpr int T = 1024;      // frames a tile at most: one mask word a lane
constexpr int NT = 512;
constexpr int SMALL_B = 8;   // at most this many frames: the walking kernel
constexpr int CH = 128;      // frames a chunk of phase B (T / CH barriers)
static_assert(T / CH < 16, "a named barrier a chunk: ids 1..15");
constexpr int FPW = 32 / G;  // frames a warp covers in (frame, marker) order
constexpr int PER_POS = T * G * 3 / NT;   // position loads a thread a tile
constexpr int PER_SEEN = T * G / NT;      // seen loads a thread a tile

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                         __fmul_rn(z, z)));
}

// The last set bit of `w` below bit `b` (0..31) as an index, or -1.
__device__ __forceinline__ int last_below(uint32_t w, int b) {
  const uint32_t m = w & ((1u << b) - 1u);
  return m ? 31 - __clz(m) : -1;
}

__global__ void __launch_bounds__(NT)
displacement_scan_kernel(const float* __restrict__ world,
                         const bool* __restrict__ seen, int b, int n, int tile,
                         float max_step, const float* __restrict__ last_in,
                         const bool* __restrict__ last_ok_in,
                         const float* __restrict__ first_in,
                         const bool* __restrict__ first_ok_in,
                         const float* __restrict__ cum_in,
                         float* __restrict__ step, float* __restrict__ step_norm,
                         bool* __restrict__ step_valid,
                         float* __restrict__ cum_path,
                         float* __restrict__ from_first,
                         float* __restrict__ from_first_norm,
                         float* __restrict__ last_out,
                         bool* __restrict__ last_ok_out,
                         float* __restrict__ first_out,
                         bool* __restrict__ first_ok_out,
                         float* __restrict__ cum_out) {
  extern __shared__ float dyn[];
  float* pos = dyn;                          // [tile][G * 3], as in world
  float* acc = dyn + tile * G * 3;           // [G][tile + 1]: dnz, then cum
  __shared__ uint32_t mask[G][T / 32 + 1];   // sightings, bit t % 32
  __shared__ int prevw[G][T / 32];           // last earlier word with one
  __shared__ int first_t[G], last_t[G];      // the tile's sightings, or -1
  __shared__ float c_last[G][3], c_first[G][3], c_cum[G];
  __shared__ bool c_lok[G], c_fok[G];

  const int m0 = blockIdx.x * G;
  const int nm = min(G, n - m0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int words = (tile + 31) / 32;
  const int acc_ld = tile + 1;

  // The carry; a null carry is the fresh state (zeros).
  if (tid < G) {
    const int m = m0 + tid;
    const bool on = tid < nm && last_in != nullptr;
    for (int c = 0; c < 3; ++c) {
      c_last[tid][c] = on ? last_in[3 * m + c] : 0.f;
      c_first[tid][c] = on ? first_in[3 * m + c] : 0.f;
    }
    c_lok[tid] = on && last_ok_in[m];
    c_fok[tid] = on && first_ok_in[m];
    c_cum[tid] = on ? cum_in[m] : 0.f;
  }

  for (long long t0 = 0; t0 < b; t0 += tile) {
    const int nf = (int)min((long long)tile, b - t0);
    const int nf16 = (nf + 15) / 16 * 16;   // <= tile, a multiple of 32
    for (int i = tid; i < G * (T / 32 + 1); i += NT) (&mask[0][0])[i] = 0u;
    __syncthreads();
    // Stage the tile's positions row by row and read its seen bits, every
    // load of the thread issued before the first is used.
    {
      float v[PER_POS];
      bool sv[PER_SEEN];
#pragma unroll
      for (int k = 0; k < PER_POS; ++k) {
        const int i = tid + k * NT;
        const int f = i / (G * 3), r = i - f * (G * 3);
        v[k] = i < nf * G * 3 && r < nm * 3
                   ? world[((t0 + f) * n + m0) * 3 + r] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < PER_SEEN; ++k) {
        const int i = tid + k * NT;
        const int f = i / G, g = i - f * G;
        sv[k] = i < nf * G && g < nm && seen[(t0 + f) * n + m0 + g];
      }
#pragma unroll
      for (int k = 0; k < PER_POS; ++k)
        if (tid + k * NT < nf * G * 3) pos[tid + k * NT] = v[k];
      // A warp covers FPW frames x G markers a step; lane g (< G) gathers
      // its marker's FPW bits and ORs them into the mask word.
#pragma unroll
      for (int k = 0; k < PER_SEEN; ++k) {
        const int base = warp * 32 + k * NT;
        const uint32_t bal = __ballot_sync(0xffffffffu, sv[k]);
        if (lane < G && bal != 0u) {
          uint32_t piece = G == 1 ? bal : 0u;
#pragma unroll
          for (int j = 0; G > 1 && j < FPW; ++j)
            piece |= ((bal >> (j * G + lane)) & 1u) << j;
          const int f0 = base / G;
          if (piece) atomicOr(&mask[lane][f0 >> 5], piece << (f0 & 31));
        }
      }
    }
    __syncthreads();
    // Per marker, over the tile's mask words: the last earlier word with a
    // sighting, and the tile's first and last sighting.
    if (warp < G) {
      const int g = warp;
      const uint32_t wd = lane < words ? mask[g][lane] : 0u;
      const uint32_t nz = __ballot_sync(0xffffffffu, wd != 0u);
      if (lane < words) {
        const int pw = last_below(nz, lane);
        prevw[g][lane] = pw;
      }
      if (lane == 0) {
        const int fw = __ffs(nz) - 1;
        first_t[g] = fw < 0 ? -1 : 32 * fw + __ffs(mask[g][fw]) - 1;
        const int lw = nz ? 31 - __clz(nz) : -1;
        last_t[g] = lw < 0 ? -1 : 32 * lw + 31 - __clz(mask[g][lw]);
      }
    }
    __syncthreads();
    // Every (frame, marker) pair of the tile, by the warps after the first
    // in chunks of CH frames; warp 0 walks each chunk's `cum` as soon as
    // the others have staged its dnz (a named barrier a chunk).
    const int nch = (nf + CH - 1) / CH;
    if (warp > 0) {
      for (int c = 0; c < nch; ++c) {
        const int f1 = min(nf, (c + 1) * CH);
        for (int i = c * CH * G + tid - 32; i < f1 * G; i += NT - 32) {
          const int f = i / G, g = i - f * G;
          if (g >= nm) continue;
          const int w = f >> 5, bit = f & 31;
          const uint32_t wd = mask[g][w];
          const bool ok = (wd >> bit) & 1u;
          int L = last_below(wd, bit);
          if (L >= 0) {
            L += 32 * w;
          } else {
            const int pw = prevw[g][w];
            L = pw < 0 ? -1 : 32 * pw + 31 - __clz(mask[g][pw]);
          }
          const float* p = pos + f * (G * 3) + 3 * g;
          const float px = p[0], py = p[1], pz = p[2];
          float lx, ly, lz;
          bool lok;
          if (L >= 0) {
            const float* q = pos + L * (G * 3) + 3 * g;
            lx = q[0]; ly = q[1]; lz = q[2]; lok = true;
          } else {
            lx = c_last[g][0]; ly = c_last[g][1]; lz = c_last[g][2];
            lok = c_lok[g];
          }
          const float dx = __fsub_rn(px, lx), dy = __fsub_rn(py, ly),
                      dz = __fsub_rn(pz, lz);
          const float dn = norm3(dx, dy, dz);
          const bool emit = lok && ok && (dn <= max_step);
          const float dnz = emit ? dn : 0.f;
          const int F = first_t[g];
          float fx = c_first[g][0], fy = c_first[g][1], fz = c_first[g][2];
          if (!c_fok[g] && F >= 0 && F <= f) {
            const float* q = pos + F * (G * 3) + 3 * g;
            fx = q[0]; fy = q[1]; fz = q[2];
          }
          const float gx = ok ? __fsub_rn(px, fx) : 0.f,
                      gy = ok ? __fsub_rn(py, fy) : 0.f,
                      gz = ok ? __fsub_rn(pz, fz) : 0.f;
          const long long o = (t0 + f) * n + m0 + g;
          step[3 * o] = emit ? dx : 0.f;
          step[3 * o + 1] = emit ? dy : 0.f;
          step[3 * o + 2] = emit ? dz : 0.f;
          step_norm[o] = dnz;
          step_valid[o] = emit;
          from_first[3 * o] = gx;
          from_first[3 * o + 1] = gy;
          from_first[3 * o + 2] = gz;
          from_first_norm[o] = norm3(gx, gy, gz);
          acc[g * acc_ld + f] = dnz;
        }
        if (c == nch - 1)
          for (int i = tid - 32; i < (nf16 - nf) * G; i += NT - 32)
            acc[(i % G) * acc_ld + nf + i / G] = 0.f;
        bar_arrive(1 + c, NT);
      }
    } else {
      // The chain: one thread a marker adds the dnz in frame order. dnz is
      // 0 past the tile's last frame up to the next 16, and adding +0 to a
      // sum that has had one add leaves it unchanged, so the adds need no
      // test; the next 16 are loaded while the current 16 are added.
      const int g = tid;
      float* a = acc + g * acc_ld;
      float cum = tid < nm ? c_cum[g] : 0.f;
      for (int c = 0; c < nch; ++c) {
        bar_sync(1 + c, NT);
        if (tid >= nm) continue;
        const int f0 = c * CH, f1 = min(nf16, (c + 1) * CH);
        float x[16], y[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) x[j] = a[f0 + j];
        for (int f = f0; f < f1; f += 32) {
          if (f + 16 < f1) {
#pragma unroll
            for (int j = 0; j < 16; ++j) y[j] = a[f + 16 + j];
          }
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            cum = __fadd_rn(cum, x[j]);
            a[f + j] = cum;
          }
          if (f + 16 >= f1) break;
          if (f + 32 < f1) {
#pragma unroll
            for (int j = 0; j < 16; ++j) x[j] = a[f + 32 + j];
          }
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            cum = __fadd_rn(cum, y[j]);
            a[f + 16 + j] = cum;
          }
        }
      }
    }
    // Then the carry moves to the tile's last and first sightings (every
    // pair has read it: the walker passed the last chunk's barrier).
    if (tid < nm) {
      const int g = tid;
      const float cum = acc[g * acc_ld + nf - 1];
      c_cum[g] = cum;
      const int L = last_t[g], F = first_t[g];
      if (L >= 0) {
        for (int c = 0; c < 3; ++c) c_last[g][c] = pos[L * (G * 3) + 3 * g + c];
        c_lok[g] = true;
      }
      if (!c_fok[g] && F >= 0) {
        for (int c = 0; c < 3; ++c) c_first[g][c] = pos[F * (G * 3) + 3 * g + c];
        c_fok[g] = true;
      }
    }
    __syncthreads();
    for (int i = tid; i < nf * G; i += NT) {
      const int f = i / G, g = i - f * G;
      if (g < nm) cum_path[(t0 + f) * n + m0 + g] = acc[g * acc_ld + f];
    }
  }
  __syncthreads();
  if (tid < nm) {
    const int m = m0 + tid;
    for (int c = 0; c < 3; ++c) {
      last_out[3 * m + c] = c_last[tid][c];
      first_out[3 * m + c] = c_first[tid][c];
    }
    last_ok_out[m] = c_lok[tid];
    first_ok_out[m] = c_fok[tid];
    cum_out[m] = c_cum[tid];
  }
}

// Up to SMALL_B frames: one thread a marker walks them, every load first.
__global__ void __launch_bounds__(64)
displacement_scan_small(const float* __restrict__ world,
                        const bool* __restrict__ seen, int b, int n,
                        float max_step, const float* __restrict__ last_in,
                        const bool* __restrict__ last_ok_in,
                        const float* __restrict__ first_in,
                        const bool* __restrict__ first_ok_in,
                        const float* __restrict__ cum_in,
                        float* __restrict__ step,
                        float* __restrict__ step_norm,
                        bool* __restrict__ step_valid,
                        float* __restrict__ cum_path,
                        float* __restrict__ from_first,
                        float* __restrict__ from_first_norm,
                        float* __restrict__ last_out,
                        bool* __restrict__ last_ok_out,
                        float* __restrict__ first_out,
                        bool* __restrict__ first_ok_out,
                        float* __restrict__ cum_out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n) return;
  float pos[SMALL_B][3];
  bool okf[SMALL_B];
#pragma unroll
  for (int t = 0; t < SMALL_B; ++t) {
    const long long o = (long long)t * n + m;
    for (int c = 0; c < 3; ++c) pos[t][c] = t < b ? world[3 * o + c] : 0.f;
    okf[t] = t < b && seen[o];
  }
  const bool on = last_in != nullptr;
  float lx = on ? last_in[3 * m] : 0.f, ly = on ? last_in[3 * m + 1] : 0.f,
        lz = on ? last_in[3 * m + 2] : 0.f;
  float fx = on ? first_in[3 * m] : 0.f, fy = on ? first_in[3 * m + 1] : 0.f,
        fz = on ? first_in[3 * m + 2] : 0.f;
  bool lok = on && last_ok_in[m], fok = on && first_ok_in[m];
  float cum = on ? cum_in[m] : 0.f;
#pragma unroll
  for (int t = 0; t < SMALL_B; ++t) {
    if (t >= b) break;
    const float px = pos[t][0], py = pos[t][1], pz = pos[t][2];
    const bool ok = okf[t];
    const float dx = __fsub_rn(px, lx), dy = __fsub_rn(py, ly),
                dz = __fsub_rn(pz, lz);
    const float dn = norm3(dx, dy, dz);
    const bool emit = lok && ok && (dn <= max_step);
    const float dnz = emit ? dn : 0.f;
    cum = __fadd_rn(cum, dnz);
    if (!fok && ok) { fx = px; fy = py; fz = pz; }
    fok = fok || ok;
    const float gx = ok ? __fsub_rn(px, fx) : 0.f,
                gy = ok ? __fsub_rn(py, fy) : 0.f,
                gz = ok ? __fsub_rn(pz, fz) : 0.f;
    if (ok) { lx = px; ly = py; lz = pz; }
    lok = lok || ok;
    const long long o = (long long)t * n + m;
    step[3 * o] = emit ? dx : 0.f;
    step[3 * o + 1] = emit ? dy : 0.f;
    step[3 * o + 2] = emit ? dz : 0.f;
    step_norm[o] = dnz;
    step_valid[o] = emit;
    cum_path[o] = cum;
    from_first[3 * o] = gx;
    from_first[3 * o + 1] = gy;
    from_first[3 * o + 2] = gz;
    from_first_norm[o] = norm3(gx, gy, gz);
  }
  last_out[3 * m] = lx; last_out[3 * m + 1] = ly; last_out[3 * m + 2] = lz;
  first_out[3 * m] = fx; first_out[3 * m + 1] = fy; first_out[3 * m + 2] = fz;
  last_ok_out[m] = lok; first_ok_out[m] = fok; cum_out[m] = cum;
}

}  // namespace

// world (b, n, 3) f32, seen (b, n) bool; the carry's five pointers are all
// null (fresh state) or all set; outputs as in reconstruct/displacement.py.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int vbs_displacement_scan(
    const float* world, const bool* seen, int b, int n, float max_step,
    const float* last_in, const bool* last_ok_in, const float* first_in,
    const bool* first_ok_in, const float* cum_in, float* step,
    float* step_norm, bool* step_valid, float* cum_path, float* from_first,
    float* from_first_norm, float* last_out, bool* last_ok_out,
    float* first_out, bool* first_ok_out, float* cum_out, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (b <= SMALL_B) {
    displacement_scan_small<<<(n + 63) / 64, 64, 0, st>>>(
        world, seen, b, n, max_step, last_in, last_ok_in, first_in,
        first_ok_in, cum_in, step, step_norm, step_valid, cum_path,
        from_first, from_first_norm, last_out, last_ok_out, first_out,
        first_ok_out, cum_out);
    return (int)cudaGetLastError();
  }
  // A tile holds the whole batch up to T frames (a multiple of 32 frames).
  const int tile = b < T ? (b + 31) / 32 * 32 : T;
  const size_t smem = sizeof(float) * ((size_t)tile * G * 3 +
                                       (size_t)G * (tile + 1) + 32);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        displacement_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n + G - 1) / G;
  displacement_scan_kernel<<<blocks, NT, smem, st>>>(
      world, seen, b, n, tile, max_step, last_in, last_ok_in, first_in,
      first_ok_in, cum_in, step, step_norm, step_valid, cum_path, from_first,
      from_first_norm, last_out, last_ok_out, first_out, first_ok_out,
      cum_out);
  return (int)cudaGetLastError();
}
