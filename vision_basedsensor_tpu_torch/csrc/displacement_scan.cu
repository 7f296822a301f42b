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
// Bound on the H100: the dependency chain, not bytes. The inputs (13 B per
// marker-frame) and outputs (37 B) of a 1024-frame, 65-marker batch are
// 3.3 MB, 1 us at 3.35 TB/s, but frame t+1 needs frame t's carry: B
// dependent steps of a few dozen instructions. Design: markers are
// independent, so each block owns 32 of them (one walking warp, one thread
// per marker, carry in registers) and the grid covers N. Frame t+1's input
// does not depend on the carry, so the block's other three warps stage the
// next run of CHUNK frames into the second of two shared-memory buffers
// (coalesced: a frame's 32 markers are 384 contiguous bytes) while the
// walking warp reads the current one; one barrier per run. Outputs are
// stored straight from the walking warp, coalesced across its 32 markers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MPB = 32;      // markers per block: the walking warp
constexpr int NT = 128;      // warp 0 walks, warps 1-3 stage
constexpr int CHUNK = 48;    // frames per staged run

struct Stage {
  float pos[CHUNK][MPB * 3];
  bool ok[CHUNK][MPB];
};

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                         __fmul_rn(z, z)));
}

// Copy frames [t0, t0 + nf) of this block's markers into s, with the
// threads [first, first + count) of the block.
__device__ __forceinline__ void stage(Stage& s, const float* __restrict__ world,
                                      const bool* __restrict__ seen, int n,
                                      int m0, int nm, long long t0, int nf,
                                      int first, int count) {
  const int me = threadIdx.x - first;
  for (int i = me; i < nf * nm * 3; i += count) {
    const int f = i / (nm * 3), r = i - f * (nm * 3);
    s.pos[f][r] = world[((t0 + f) * n + m0) * 3 + r];
  }
  for (int i = me; i < nf * nm; i += count) {
    const int f = i / nm, r = i - f * nm;
    s.ok[f][r] = seen[(t0 + f) * n + m0 + r];
  }
}

__global__ void __launch_bounds__(NT)
displacement_scan_kernel(const float* __restrict__ world,
                         const bool* __restrict__ seen, int b, int n,
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
  __shared__ Stage buf[2];
  const int m0 = blockIdx.x * MPB;
  const int nm = min(MPB, n - m0);
  const int lane = threadIdx.x;            // the walker's marker, warp 0
  const int m = m0 + lane;
  const bool walker = threadIdx.x < MPB && lane < nm;

  // Carry in registers; a null carry is the fresh state (zeros).
  float lx = 0.f, ly = 0.f, lz = 0.f, fx = 0.f, fy = 0.f, fz = 0.f, cum = 0.f;
  bool lok = false, fok = false;
  if (walker && last_in != nullptr) {
    lx = last_in[3 * m]; ly = last_in[3 * m + 1]; lz = last_in[3 * m + 2];
    fx = first_in[3 * m]; fy = first_in[3 * m + 1]; fz = first_in[3 * m + 2];
    lok = last_ok_in[m]; fok = first_ok_in[m]; cum = cum_in[m];
  }

  const int runs = (b + CHUNK - 1) / CHUNK;
  if (runs > 0)
    stage(buf[0], world, seen, n, m0, nm, 0, min(CHUNK, b), 0, NT);
  __syncthreads();
  for (int r = 0; r < runs; ++r) {
    const long long t0 = (long long)r * CHUNK;
    const int nf = (int)min((long long)CHUNK, b - t0);
    if (threadIdx.x >= 32) {
      if (r + 1 < runs)
        stage(buf[(r + 1) & 1], world, seen, n, m0, nm, t0 + CHUNK,
              (int)min((long long)CHUNK, b - t0 - CHUNK), 32, NT - 32);
    } else if (walker) {
      const Stage& s = buf[r & 1];
      for (int f = 0; f < nf; ++f) {
        const float px = s.pos[f][3 * lane], py = s.pos[f][3 * lane + 1],
                    pz = s.pos[f][3 * lane + 2];
        const bool ok = s.ok[f][lane];
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
        const long long o = (t0 + f) * n + m;
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
    }
    __syncthreads();
  }
  if (walker) {
    last_out[3 * m] = lx; last_out[3 * m + 1] = ly; last_out[3 * m + 2] = lz;
    first_out[3 * m] = fx; first_out[3 * m + 1] = fy;
    first_out[3 * m + 2] = fz;
    last_ok_out[m] = lok; first_ok_out[m] = fok; cum_out[m] = cum;
  }
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
  const int blocks = (n + MPB - 1) / MPB;
  displacement_scan_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(
      world, seen, b, n, max_step, last_in, last_ok_in, first_in, first_ok_in,
      cum_in, step, step_norm, step_valid, cum_path, from_first,
      from_first_norm, last_out, last_ok_out, first_out, first_ok_out,
      cum_out);
  return (int)cudaGetLastError();
}
