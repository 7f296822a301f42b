// Per-peak window gather from the packed field through Hopper's copy engine
// (TMA): a measured alternative to gather.cu, not part of the kernel library
// (build.py). `chip_smoke.py --only gather --baseline` builds this file on
// its own and checks and times it in turns with the library's kernel; on an
// H100 it ran 1-15% slower than gather.cu at the detector's shapes, so the
// library keeps gather.cu. It has the same C entry, vbs_gather_windows, and
// the same contract, for the reference's gather_windows / _paired
// (vision_basedsensor_tpu/ops/pallas/moments.py, `_gather_kernel`,
// pallas_call at :397): pack=2 puts windows 2i and 2i+1 side by side in
// lanes [0, 64) and [64, 128) of output row i; pack=1 one window per
// 128-lane row.
//
// For window k with clipped patch origin (cx_k, cy_k), computed by the
// wrapper exactly as the reference's `_prep` does:
//   out[b, i, r, c] = packed[b, cy_k + r, cx_k + c - 64 j]   if that column < W
//                   = 0                                     otherwise
// with j = c / 64, k = 2i + j for pack=2 and j = 0, k = i for pack=1. Rows
// never leave the frame (cy_k <= H - P). The TPU kernel leaves other data in
// the out-of-image lanes; the moment stage gates them out by coordinate.
//
// Bound on the H100: the written bytes. A copy does no arithmetic, and the
// output (B x K/pack x P x 128 floats) outweighs the in-image pixels the
// windows read. gather.cu (one 256-thread block per output row, a scalar
// load and a dependent store per step) overlaps its loads with its stores
// only in part. Design: Hopper's copy engine (TMA) brings the windows
// into shared memory ahead of the stores, so the threads only store. A 3D
// tensor map over `packed` (W, H, B) loads each slot as one box of P rows at
// (cx_k & ~3, cy_k, b): the copy engine takes only 16-byte aligned starts in
// the row (an unaligned one faults), so the box is BOX_SLACK columns wider
// than the slot and the copy-out shifts by cx_k & 3. The hardware fills the
// columns >= W with 0 (FLOAT_OOB_FILL_NONE), which is the `x < W ? v : 0`
// above. Persistent blocks walk the output rows through a ring of up to
// MAX_STAGES slabs, one mbarrier a stage: one thread keeps the next rows'
// loads in flight while COPY_WARPS warps write the current row with
// coalesced 128-byte stores.
//
// A tensor map needs 16-byte row strides and base addresses: frames with
// W % 4 != 0 (or narrower than a box, or a `packed` that starts off a
// 16-byte boundary) take a register copy instead, chosen by shape here,
// never after an error: a warp per output row, REG_ROWS patch rows' loads in
// flight before their 16-byte stores.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int MAX_STAGES = 4;              // slabs a block keeps in its ring
constexpr int STAGE_BUDGET = 72 * 1024;    // shared bytes a block's ring may take
constexpr int BOX_SLACK = 4;               // columns a box reaches past its slot
constexpr int COPY_WARPS = 4;              // warps a block that copy a stage out
constexpr int COPY_ROWS = 4;               // patch rows a lane loads before storing
constexpr int REG_WARPS = 8;               // register copy: warps a block
constexpr int REG_ROWS = 8;                // ... and patch rows in flight a warp
// Error codes of the C entry beyond CUDA's (see vbs_error_string).
constexpr int ERR_NO_ENCODER = 200000;     // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 200001;         // it refused a map (+ its CUresult)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(1u)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of parity `parity` to complete. A copy that never
// completes (a fault of the kernel) traps after ~2^26 tries, so the launch
// fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// Box of the 3D map at (x, y, z) into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x),
      "r"(y), "r"(z)
      : "memory");
}

// Shared bytes of one slot's box (P rows of LANES / pack + BOX_SLACK
// floats), rounded up to the 128 bytes a copy's destination is aligned to.
__host__ __device__ __forceinline__ int slot_bytes(int P, int pack) {
  return (P * (LANES / pack + BOX_SLACK) * 4 + 127) / 128 * 128;
}

// Rows g, g + G, g + 2G, ... of the B * K/pack output rows, G = gridDim.x.
// Row q of the block (0-based) goes through stage q % stages: lane 0 of
// warp 0 loads each slot's box at the 16-byte aligned column cx & ~3,
// BOX_SLACK columns wider than the slot, and the COPY_WARPS warps copy it
// out shifted by cx & 3, warp w taking the patch rows w, w + COPY_WARPS, ...
__global__ void __launch_bounds__(COPY_WARPS * 32)
gather_tma_kernel(const __grid_constant__ CUtensorMap src,
                  const int* __restrict__ start, float* __restrict__ out,
                  int k_out, int P, int pack, int rows, int stages) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  __shared__ int shift[MAX_STAGES][2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.x, G = gridDim.x;
  const int mine = (rows - g + G - 1) / G;
  const int box_w = LANES / pack + BOX_SLACK;
  const int slot_floats = slot_bytes(P, pack) / 4;
  const uint32_t stage_bytes = (uint32_t)slot_floats * pack * 4;
  const uint32_t box_bytes = (uint32_t)P * box_w * pack * 4;   // a stage's copy
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Warp 0 issues the loads. Its lane l holds the origins (cx, cy of each
  // slot) of row 32 c + l of the chunk c being loaded; lane 0 reads them with
  // shuffles.
  int o0 = 0, o1 = 0, o2 = 0, o3 = 0;
  auto issue = [&](int q) {    // warp 0: load row q into its stage
    if ((q & 31) == 0 && q + lane < mine) {
      const int* o = start + (size_t)(g + (q + lane) * G) * pack * 2;
      o0 = o[0];
      o1 = o[1];
      if (pack == 2) {
        o2 = o[2];
        o3 = o[3];
      }
    }
    const int cx0 = __shfl_sync(~0u, o0, q & 31);
    const int cy0 = __shfl_sync(~0u, o1, q & 31);
    const int cx1 = __shfl_sync(~0u, o2, q & 31);
    const int cy1 = __shfl_sync(~0u, o3, q & 31);
    if (lane == 0) {
      const int s = q % stages;
      unsigned char* st = ring + (size_t)s * stage_bytes;
      const int b = (g + q * G) / k_out;
      shift[s][0] = cx0 & 3;
      shift[s][1] = cx1 & 3;
      // The block's reads of the stage come before the copy engine's writes.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_expect_tx(&full[s], box_bytes);
      tma_load(st, &src, &full[s], cx0 & ~3, cy0, b);
      if (pack == 2)
        tma_load(st + (size_t)slot_floats * 4, &src, &full[s], cx1 & ~3, cy1,
                 b);
    }
  };

  if (warp == 0)
    for (int q = 0; q < stages && q < mine; ++q) issue(q);
  for (int t = 0; t < mine; ++t) {
    const int s = t % stages;
    mbar_wait(&full[s], (uint32_t)(t / stages) & 1u);
    // Lane l copies columns l + 32 m (m < 4): slot j = m / 2 with pack=2.
    const float* stg =
        reinterpret_cast<const float*>(ring + (size_t)s * stage_bytes);
    int base[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = pack == 2 ? m / 2 : 0;
      base[m] = j * slot_floats + shift[s][j] + lane + 32 * m -
                j * (LANES / 2);
    }
    float* dst = out + (size_t)(g + t * G) * P * LANES + lane;
    for (int y0 = warp; y0 < P; y0 += COPY_WARPS * COPY_ROWS) {
      float v[COPY_ROWS][4];
#pragma unroll
      for (int u = 0; u < COPY_ROWS; ++u)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int y = y0 + u * COPY_WARPS;
          if (y < P) v[u][m] = stg[base[m] + y * box_w];
        }
#pragma unroll
      for (int u = 0; u < COPY_ROWS; ++u)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int y = y0 + u * COPY_WARPS;
          if (y < P) dst[y * LANES + 32 * m] = v[u][m];
        }
    }
    __syncthreads();
    if (warp == 0 && t + stages < mine) issue(t + stages);
  }
}

// Register copy for frames a tensor map cannot describe: warps walk output
// rows; lane l copies columns [4l, 4l + 4) of each patch row.
__global__ void __launch_bounds__(REG_WARPS * 32)
gather_regs_kernel(const float* __restrict__ packed,
                   const int* __restrict__ start, float* __restrict__ out,
                   int H, int W, int k_out, int P, int pack, int rows) {
  const int lane = threadIdx.x & 31;
  const int c = 4 * lane;
  const int j = pack == 2 ? c / 64 : 0;
  for (int r = blockIdx.x * REG_WARPS + threadIdx.x / 32; r < rows;
       r += gridDim.x * REG_WARPS) {
    const int* o = start + ((size_t)r * pack + j) * 2;
    const int x = o[0] + c - 64 * j;
    const float* src =
        packed + ((size_t)(r / k_out) * H + o[1]) * (size_t)W + x;
    float4* dst = reinterpret_cast<float4*>(out + (size_t)r * P * LANES + c);
    for (int y = 0; y < P; y += REG_ROWS) {
      float4 v[REG_ROWS];
#pragma unroll
      for (int u = 0; u < REG_ROWS; ++u) {
        if (y + u < P) {
          const float* s = src + (size_t)(y + u) * W;
          v[u].x = x < W ? s[0] : 0.f;
          v[u].y = x + 1 < W ? s[1] : 0.f;
          v[u].z = x + 2 < W ? s[2] : 0.f;
          v[u].w = x + 3 < W ? s[3] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < REG_ROWS; ++u)
        if (y + u < P) dst[(size_t)(y + u) * (LANES / 4)] = v[u];
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime (the library
// is not linked against libcuda); null if libcuda has none.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A float32 tiled map with no swizzle; 0 or ERR_ENCODE + the CUresult.
int encode(EncodeTiled fn, CUtensorMap* map, int rank, const void* base,
           const cuuint64_t* dims, const cuuint64_t* strides,
           const cuuint32_t* box) {
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                          const_cast<void*>(base), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_L2_PROMOTION_NONE,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)res;
}

}  // namespace

extern "C" const char* vbs_error_string(int err) {
  if (err == ERR_NO_ENCODER)
    return "libcuda has no cuTensorMapEncodeTiled";
  if (err >= ERR_ENCODE && err < ERR_ENCODE + 100000)
    return "cuTensorMapEncodeTiled refused the gather's tensor map (CUresult "
           "= the code - 200001)";
  return cudaGetErrorString((cudaError_t)err);
}

// `out` is a fresh (16-byte aligned) B x K/pack x P x 128 float32 buffer.
// Returns 0 on success: cudaGetLastError() after the launch, or an error of
// the setup (a CUDA error code, or ERR_NO_ENCODER / ERR_ENCODE + CUresult).
extern "C" int vbs_gather_windows(const float* packed, const int* start,
                                  float* out, int B, int H, int W, int K,
                                  int P, int pack, void* stream) {
  const int k_out = K / pack;
  const long long rows = (long long)B * k_out;
  if (rows == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = (cudaStream_t)stream;
  const int box_w = LANES / pack + BOX_SLACK;
  const bool aligned = W % 4 == 0 && W >= box_w &&
                       (reinterpret_cast<uintptr_t>(packed) & 15) == 0;
  if (!aligned) {
    const long long want = (rows + REG_WARPS - 1) / REG_WARPS;
    const int grid = (int)(want < 8LL * sms ? want : 8LL * sms);
    gather_regs_kernel<<<grid, REG_WARPS * 32, 0, st>>>(
        packed, start, out, H, W, k_out, P, pack, (int)rows);
    return (int)cudaGetLastError();
  }

  const EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  CUtensorMap src;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)H * W * 4};
  const cuuint32_t box[3] = {(cuuint32_t)box_w, (cuuint32_t)P, 1};
  const int err = encode(fn, &src, 3, packed, dims, strides, box);
  if (err != 0) return err;

  const int stage_bytes = slot_bytes(P, pack) * pack;
  int stages = STAGE_BUDGET / stage_bytes;
  stages = stages < 2 ? 2 : (stages > MAX_STAGES ? MAX_STAGES : stages);
  const int smem = stages * stage_bytes;
  e = cudaFuncSetAttribute(gather_tma_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_tma_kernel, COPY_WARPS * 32, smem);
  if (e != cudaSuccess) return (int)e;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(rows < resident ? rows : resident);
  gather_tma_kernel<<<grid, COPY_WARPS * 32, smem, st>>>(
      src, start, out, k_out, P, pack, (int)rows, stages);
  return (int)cudaGetLastError();
}
