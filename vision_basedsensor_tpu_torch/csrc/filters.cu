// Separable-stencil filter front end of the marker detector, in float32.
//
// Replaces no TPU kernel: the JAX package runs these filters as XLA dot
// products with dense band matrices (core/imaging.py:_sep_filter), and the
// port's plain version runs the same band matrices as cuBLAS GEMMs. Two
// kernels a batch compute, for frames (B, H, W):
//   DoG (stage DOG), from the frame (uint8, or float32 gray, rows strided):
//     gray  = floor(x + 0.5)                          (to_grayscale)
//     bs/bl = floor(Gs * gray + 0.5), floor(Gl * gray + 0.5)
//     area  = inRange(remainder(bl - bs + offset, 256), lo, hi) as 0/1
//     count[b] += sum of area                          (exact integer)
//   NCC (stage NCC), from the 0/1 area mask and mu = count * (1 / (H W)),
//   or the mean the caller gives (a row shard's whole-frame mean):
//     corr = G * (area - mu), box1 = ones * (area - mu)   (zero padding)
//     the epilogue of ops/ncc.py:normxcorr_gaussian(binary_input=True).
// Each blur is an H (row) pass, then a W (column) pass, as in _sep_filter.
//
// Rounding: the same bits as the plain version's GEMMs where cuBLAS does
// not split the sum (every batch the benchmark runs). A SIMT float32 GEMM
// accumulates each output as acc = fma(T[i][j], x[j], acc) over ascending j
// from +0, and its zero band entries add +-0, which changes nothing (acc is
// never -0). So each output here is acc = 0; acc = __fmaf_rn(w_j, x_j, acc)
// in ascending source index j over a window that holds every nonzero entry
// of its band-matrix row, with the float32 entries of the band matrix
// itself (reflect101 folds included; ops/cuda/filters.py:pass_table). The
// epilogues use the _rn intrinsics, so nothing is contracted, and take the
// scalars as PyTorch's CUDA kernels do: a Python scalar rounded to float32,
// and a tensor divided by a Python scalar as a product with its float32
// reciprocal (the wrapper computes 1 / k^2 and 1 / (H W) in float32).
//
// Bound on the H100: FP32 FMA (no tensor cores: TF32 would round). Per pixel
// the DoG takes ks + kl multiply-adds a pass, the NCC 2 kt (244 at the
// low-res profile, 604 at the high-res one); a pixel moves 13 B (the frame's
// byte in, gray, area and ncc out as float32). Design:
//  - A block of 256 threads owns TH rows of one frame over the whole
//    width. Its H pass computes both filters' row sums for those rows into
//    shared memory (2 x TH full rows), its W pass reads them back, so no
//    intermediate goes through device memory. TH = 8 where the two rows fit
//    in 64 KB (W <= 1016), else 4 (fhd: 62 KB a block, 3 blocks an SM).
//    (On the H100, 128 threads ran 12-13% slower at both profiles, 512 at
//    fhd 11% faster but at vga 27% slower; TH = 16 at vga, 1.7x slower.)
//  - H pass: a thread owns a column, loads the TH + kb - 1 source rows of
//    the wider filter at once, and feeds each value to up to 2 TH
//    accumulators in registers; the narrower filter's window lies inside.
//    The DoG writes its rows' gray from the same loads.
//  - W pass: a thread owns 4 adjacent outputs of a row and reads its
//    sources as 16-byte shared loads (ceil((k + 3) / 4) of them a filter).
//  - The taps of the two profiles (21/35 and 39/101 for the DoG, 33 and 81
//    for the NCC) are compiled in and passed by value, so every tap is a
//    constant-bank operand of its FFMA. The frame's first and last rows and
//    columns (whose band-matrix rows are not the interior taps), and any
//    other tap count, read dense groups of 4 outputs' weights from device
//    memory: one 16-byte load a source and filter feeds 4 FMAs.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

// One 1-D pass of both filters over n samples, y[i] = sum_j T[i][j] x[j],
// as ops/cuda/filters.py:pass_table lays it out (outside the unnamed
// namespace: the C entries take it). Outputs go in groups of 4; group g
// reads L sources from j0[g], with filter a's weights of its 4 outputs,
// then filter b's, for each source (dense[(g * L + j) * 2 + {0, 1}]).
struct VbsPass {
  const int* j0;
  const float4* dense;
  int n, L;
  int in_lo, in_hi;  // outputs [in_lo, in_hi): both filters' interior span
};

namespace {

constexpr int NT = 256;           // threads per block
constexpr int PADL = 4;           // shared row padding before column 0
constexpr int SMEM_TH8 = 64 * 1024;
constexpr int SMEM_MAX = 227 * 1024;
constexpr unsigned FULL = 0xffffffffu;
enum Stage { DOG = 0, NCC = 1 };

template <int K>
struct Taps { float w[K > 0 ? K : 1]; };

struct Args {
  const void* src;
  long long sB, sH;           // source strides (elements) of a frame, a row
  float* gray;                // DoG: gray out
  float* out;                 // DoG: area; NCC: ncc
  int* count;                 // DoG: += mask count; NCC: read (mean null)
  const float* mean;          // NCC: the caller's mean, or null
  int H, W;
  VbsPass ph, pw;             // the H and the W pass of both filters
  int offset;                 // DoG
  float thr_lo, thr_hi;       // DoG
  float inv_hw, inv_n, t0, min_var, tiny;    // NCC
  int box_k;                                 // NCC
};

// Floats of one shared row: column c at PADL + c, room for the 16-byte
// loads' overreach on both sides.
__host__ __device__ inline int row_stride(int W) {
  return PADL + ((W + 3) & ~3) + 4;
}

template <int STAGE, typename In>
__device__ __forceinline__ float input(const In* p, float mu) {
  if constexpr (STAGE == NCC) {
    return __fsub_rn(__ldg(p), mu);
  } else if constexpr (std::is_same<In, uint8_t>::value) {
    return (float)__ldg(p);
  } else {
    return floorf(__fadd_rn(__ldg(p), 0.5f));
  }
}

__device__ __forceinline__ void fma4(float (&y)[4], const float4 w, float x) {
  y[0] = __fmaf_rn(w.x, x, y[0]);
  y[1] = __fmaf_rn(w.y, x, y[1]);
  y[2] = __fmaf_rn(w.z, x, y[2]);
  y[3] = __fmaf_rn(w.w, x, y[3]);
}

// H pass of TH interior rows r0.. of one column (p at row 0 of it): both
// filters' windows centred, a's inside b's. The column's TH + KB - 1 source
// values are loaded first, all in flight at once. The DoG writes the gray
// of its own rows (gray at row r0 of the column) from them.
template <int STAGE, int KA, int KB, int TH, typename In>
__device__ __forceinline__ void h_fast(const In* p, long long sH, int r0,
                                       float mu, const Taps<KA>& ta,
                                       const Taps<KB>& tb, float* gray, int W,
                                       float (&ya)[TH], float (&yb)[TH]) {
  constexpr int LOA = (KA - 1) / 2, LOB = (KB - 1) / 2, D = LOB - LOA;
  constexpr int NJ = TH + KB - 1;
  static_assert(D >= 0 && KA + D <= KB, "filter a's window inside b's");
  p += (r0 - LOB) * sH;
  float x[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) x[j] = input<STAGE>(p + j * sH, mu);
  if constexpr (STAGE == DOG) {
#pragma unroll
    for (int t = 0; t < TH; ++t) gray[(size_t)t * W] = x[LOB + t];
  }
#pragma unroll
  for (int t = 0; t < TH; ++t) ya[t] = yb[t] = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int t = 0; t < TH; ++t) {
      if (j - t >= 0 && j - t < KB) yb[t] = __fmaf_rn(tb.w[j - t], x[j], yb[t]);
      if (j - t - D >= 0 && j - t - D < KA)
        ya[t] = __fmaf_rn(ta.w[j - t - D], x[j], ya[t]);
    }
  }
}

// W pass of the 4 interior outputs c0..c0+3 (c0 % 4 == 0) from a shared
// row (row[c] is column c, row 16-byte aligned at column -PADL).
template <int K>
__device__ __forceinline__ void w_fast(const float* row, int c0,
                                       const Taps<K>& tp, float (&y)[4]) {
  constexpr int LO = (K - 1) / 2, S = (4 - LO % 4) % 4;
  constexpr int NL = (S + K + 6) / 4;
  const float4* p = reinterpret_cast<const float4*>(row + c0 - LO - S);
#pragma unroll
  for (int r = 0; r < 4; ++r) y[r] = 0.f;
#pragma unroll
  for (int m = 0; m < NL; ++m) {
    const float4 v = p[m];
    const float e4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int q = 4 * m + e - S - r;   // tap of output c0 + r
        if (q >= 0 && q < K) y[r] = __fmaf_rn(tp.w[q], e4[e], y[r]);
      }
    }
  }
}

// bl and bs are blurs of 0..255 values: floor(. + 0.5) is an integer in
// 0..255, so d = bl - bs + offset is exact and remainder(d, 256) is d & 255.
__device__ __forceinline__ float dog_area(float bs, float bl, const Args& a) {
  const int s = (int)floorf(__fadd_rn(bs, 0.5f));
  const int l = (int)floorf(__fadd_rn(bl, 0.5f));
  const float m = (float)((l - s + a.offset) & 255);
  return (m >= a.thr_lo && m <= a.thr_hi) ? 1.f : 0.f;
}

// ops/ncc.py:49-82 with binary_input=True, one torch op per rounding.
__device__ __forceinline__ float ncc_value(float corr, float box1, float cnt,
                                           float mu, const Args& a) {
  const float box_raw = __fadd_rn(box1, __fmul_rn(mu, cnt));
  const float box2 =
      __fadd_rn(__fmul_rn(__fsub_rn(1.f, __fmul_rn(2.f, mu)), box_raw),
                __fmul_rn(__fmul_rn(mu, mu), cnt));
  const float num = __fsub_rn(corr, __fmul_rn(box1, a.inv_n));
  float var = __fsub_rn(box2, __fmul_rn(__fmul_rn(box1, box1), a.inv_n));
  var = var < 0.f ? 0.f : var;
  if (!(var >= a.min_var)) return 0.f;
  float den = __fsqrt_rn(__fmul_rn(var, a.t0));
  den = den < a.tiny ? a.tiny : den;
  return __fdiv_rn(num, den);
}

// In-frame samples of a zero-padded box window of k at i (ops/ncc.py:
// _box_count along one axis).
__device__ __forceinline__ int box_span(int i, int n, int k) {
  return min(i + k / 2, n - 1) - max(i - (k - 1) / 2, 0) + 1;
}

template <int STAGE, int KA, int KB, int TH, typename In>
__global__ void __launch_bounds__(NT)
stencil_kernel(const __grid_constant__ Args a,
               const __grid_constant__ Taps<KA> ta,
               const __grid_constant__ Taps<KB> tb) {
  extern __shared__ float4 smem4[];
  __shared__ int s_count;
  const int H = a.H, W = a.W, RS = row_stride(W);
  float* s_a = reinterpret_cast<float*>(smem4) + PADL;
  float* s_b = s_a + TH * RS;
  const int tid = threadIdx.x, b = blockIdx.y, r0 = blockIdx.x * TH;
  const long long sH = a.sH;
  const In* src = static_cast<const In*>(a.src) + b * a.sB;
  const size_t fo = (size_t)b * H * W;

  float mu = 0.f;
  if constexpr (STAGE == NCC)
    mu = a.mean ? __ldg(a.mean + b)
                : __fmul_rn((float)__ldg(a.count + b), a.inv_hw);
  if (tid == 0) s_count = 0;
  float* gray = STAGE == DOG ? a.gray + fo + (size_t)r0 * W : nullptr;

  // 1. H pass: rows r0..r0+TH-1 of both filters into shared memory.
  bool fast = false;
  if constexpr (KA > 0) fast = r0 >= a.ph.in_lo && r0 + TH <= a.ph.in_hi;
  if constexpr (KA > 0) {
    if (fast) {
      for (int c = tid; c < W; c += NT) {
        float ya[TH], yb[TH];
        h_fast<STAGE, KA, KB, TH>(src + c, sH, r0, mu, ta, tb, gray + c, W,
                                  ya, yb);
#pragma unroll
        for (int t = 0; t < TH; ++t) {
          s_a[t * RS + c] = ya[t];
          s_b[t * RS + c] = yb[t];
        }
      }
    }
  }
  if (!fast) {   // the frame's first and last rows: dense groups of 4
    if constexpr (STAGE == DOG) {
      for (int t = 0; t < TH && r0 + t < H; ++t)
        for (int c = tid; c < W; c += NT)
          gray[(size_t)t * W + c] = input<DOG>(src + (r0 + t) * sH + c, 0.f);
    }
    const int L = a.ph.L;
    for (int q = 0; q < TH / 4 && r0 + 4 * q < H; ++q) {
      const int g = (r0 >> 2) + q;
      const In* p0 = src + __ldg(a.ph.j0 + g) * sH;
      const float4* D = a.ph.dense + (size_t)g * L * 2;
      for (int c = tid; c < W; c += NT) {
        float ya[4] = {}, yb[4] = {};
#pragma unroll 4
        for (int j = 0; j < L; ++j) {
          const float x = input<STAGE>(p0 + j * sH + c, mu);
          fma4(ya, __ldg(D + 2 * j), x);
          fma4(yb, __ldg(D + 2 * j + 1), x);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (r0 + 4 * q + r < H) {
            s_a[(4 * q + r) * RS + c] = ya[r];
            s_b[(4 * q + r) * RS + c] = yb[r];
          }
        }
      }
    }
  }
  __syncthreads();

  // 2. W pass and the epilogue, 4 adjacent outputs a thread.
  const int ng = (W + 3) >> 2;
  const bool vec = (W & 3) == 0;
  int cnt = 0;
  for (int it = tid; it < TH * ng; it += NT) {
    const int t = it / ng, c0 = (it - t * ng) << 2, i = r0 + t;
    if (i >= H) break;
    const float* ra = s_a + t * RS;
    const float* rb = s_b + t * RS;
    float ya[4] = {}, yb[4] = {};
    bool wfast = false;
    if constexpr (KA > 0) wfast = c0 >= a.pw.in_lo && c0 + 4 <= a.pw.in_hi;
    if constexpr (KA > 0) {
      if (wfast) {
        w_fast<KA>(ra, c0, ta, ya);
        w_fast<KB>(rb, c0, tb, yb);
      }
    }
    if (!wfast) {   // the first and last columns: a dense group
      const int L = a.pw.L, j0 = __ldg(a.pw.j0 + (c0 >> 2));
      const float4* D = a.pw.dense + (size_t)(c0 >> 2) * L * 2;
#pragma unroll 4
      for (int j = 0; j < L; ++j) {
        fma4(ya, __ldg(D + 2 * j), ra[j0 + j]);
        fma4(yb, __ldg(D + 2 * j + 1), rb[j0 + j]);
      }
    }
    float o[4];
    if constexpr (STAGE == DOG) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        o[r] = dog_area(ya[r], yb[r], a);
        cnt += (c0 + r < W) && o[r] != 0.f;
      }
    } else {
      const int ri = box_span(i, H, a.box_k);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        o[r] = ncc_value(ya[r], yb[r],
                         (float)(ri * box_span(c0 + r, W, a.box_k)), mu, a);
    }
    float* dst = a.out + fo + (size_t)i * W + c0;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (c0 + r < W) dst[r] = o[r];
    }
  }

  if constexpr (STAGE == DOG) {
    cnt = __reduce_add_sync(FULL, cnt);
    if ((tid & 31) == 0 && cnt) atomicAdd(&s_count, cnt);
    __syncthreads();
    if (tid == 0 && s_count) atomicAdd(a.count + b, s_count);
  }
}

template <int STAGE, int KA, int KB, int TH, typename In>
int launch_th(const Args& a, const Taps<KA>& ta, const Taps<KB>& tb, int B,
              cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * TH * row_stride(a.W);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stencil_kernel<STAGE, KA, KB, TH, In>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.H + TH - 1) / TH, B);
  stencil_kernel<STAGE, KA, KB, TH, In><<<grid, NT, smem, stream>>>(a, ta, tb);
  return (int)cudaGetLastError();
}

template <int STAGE, int KA, int KB, typename In>
int launch(Args a, const float* taps_a, const float* taps_b, int B,
           cudaStream_t stream) {
  Taps<KA> ta{};
  Taps<KB> tb{};
  if constexpr (KA > 0) {
    memcpy(ta.w, taps_a, sizeof(ta.w));
    memcpy(tb.w, taps_b, sizeof(tb.w));
  } else {   // every output from the dense groups
    a.ph.in_lo = a.ph.in_hi = a.pw.in_lo = a.pw.in_hi = 0;
  }
  if (sizeof(float) * 2 * 8 * row_stride(a.W) <= (size_t)SMEM_TH8)
    return launch_th<STAGE, KA, KB, 8, In>(a, ta, tb, B, stream);
  return launch_th<STAGE, KA, KB, 4, In>(a, ta, tb, B, stream);
}

template <typename In>
int launch_dog(const Args& a, int ka, const float* taps_a, int kb,
               const float* taps_b, int B, cudaStream_t s) {
  // The two profiles' blurs (config.py) are compiled in.
  if (ka == 21 && kb == 35)
    return launch<DOG, 21, 35, In>(a, taps_a, taps_b, B, s);
  if (ka == 39 && kb == 101)
    return launch<DOG, 39, 101, In>(a, taps_a, taps_b, B, s);
  return launch<DOG, 0, 0, In>(a, taps_a, taps_b, B, s);
}

bool bad_passes(const VbsPass* p, int H, int W) {
  return p[0].n != H || p[1].n != W || p[0].L < 1 || p[0].L > H ||
         p[1].L < 1 || p[1].L > W;
}

}  // namespace

// The DoG stage over frames (B, H, W): src uint8 (src_u8) or float32, row
// stride sH and frame stride sB in elements; gray and area (B, H, W)
// contiguous float32 out; count (B,) int32, zeroed by the caller, gets each
// frame's mask count. passes: the H and the W pass of the small (a) and
// large (b) blur; taps_a / taps_b: their interior spans (host memory).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int vbs_dog_fields(const void* src, int src_u8, long long sB,
                              long long sH, float* gray, float* area,
                              int* count, int B, int H, int W,
                              const VbsPass* passes, int ka,
                              const float* taps_a, int kb,
                              const float* taps_b, int offset, float thr_lo,
                              float thr_hi, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || bad_passes(passes, H, W) ||
      ka > kb)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.src = src; a.sB = sB; a.sH = sH;
  a.gray = gray; a.out = area; a.count = count;
  a.H = H; a.W = W;
  a.ph = passes[0]; a.pw = passes[1];
  a.offset = offset; a.thr_lo = thr_lo; a.thr_hi = thr_hi;
  const cudaStream_t s = (cudaStream_t)stream;
  return src_u8 ? launch_dog<uint8_t>(a, ka, taps_a, kb, taps_b, B, s)
                : launch_dog<float>(a, ka, taps_a, kb, taps_b, B, s);
}

// The binary NCC stage over the 0/1 mask area (B, H, W), contiguous
// float32, into ncc (B, H, W): mu = count[b] * inv_hw or mean[b], exactly
// one of count and mean given. passes: the H and the W pass of the Gaussian (a) and
// the box (b), zero padding; taps_g / taps_box: their interior spans, k
// taps each (host memory). inv_n = float32(1 / k^2), t0 the template
// energy, min_var and tiny as ops/ncc.py. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int vbs_binary_ncc(const float* area, float* ncc, const int* count,
                              const float* mean, int B, int H, int W,
                              const VbsPass* passes, int k,
                              const float* taps_g, const float* taps_box,
                              float inv_hw, float inv_n, float t0,
                              float min_var, float tiny, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || bad_passes(passes, H, W) ||
      !count == !mean)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.src = area; a.sB = (long long)H * W; a.sH = W;
  a.out = ncc; a.count = const_cast<int*>(count); a.mean = mean;
  a.H = H; a.W = W;
  a.ph = passes[0]; a.pw = passes[1];
  a.inv_hw = inv_hw; a.inv_n = inv_n; a.t0 = t0; a.min_var = min_var;
  a.tiny = tiny; a.box_k = k;
  const cudaStream_t s = (cudaStream_t)stream;
  if (k == 33) return launch<NCC, 33, 33, float>(a, taps_g, taps_box, B, s);
  if (k == 81) return launch<NCC, 81, 81, float>(a, taps_g, taps_box, B, s);
  return launch<NCC, 0, 0, float>(a, taps_g, taps_box, B, s);
}
