// Hand-written Hopper kernels of the int8 CU-Net forward: the quantized
// whole-model forward (affine_dot_i8, conv3x3_i8; driven by
// cunet_tpu_torch/kernels/model_buf.py) and the plain path's int8 1x1 conv
// (int8_matmul_dequant; cunet_tpu_torch/kernels/quant_matmul.py).
//
// Built by nvcc with the other sources of this directory into one shared
// library with a plain C interface, loaded with ctypes
// (cunet_tpu_torch/kernels/build.py).
//
// All three are the first, 128-row block tiling of affine_dot
// (buf_kernels.cu, since redesigned) with int8 operands: 16x16x16 int8 WMMA fragments, int32 accumulators, a float32
// epilogue in registers. Integer products accumulate exactly in any order,
// the quantizer scale s = 2^(bits_i-1) is a power of two, and every float
// rounding point matches the plain PyTorch version's (the BN affine rounds
// after the product and after the sum), so each kernel is bit-identical to
// its plain version.
//
// affine_dot_i8 and conv3x3_i8 also serve a model at
// compute_dtype="float32" (JAX's #1 runs its int8 branch at either dtype):
// affine_dot_i8 reads a float32 buffer view (its prologue float32 from the
// load on, as the TPU kernel's x.astype(f32)), and both write the
// dequantized float32 product unrounded. The element type is a template
// parameter; the bf16 instances are the code they were.
//
// Each entry point launches on the stream it is given and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include "common.cuh"

namespace {

typedef signed char i8;

// WMMA's 8-bit loads need a fragment pointer on a 32-byte boundary and a
// leading dimension that is a multiple of 16 bytes. The A tile is stored as
// BK/16 column panels of BM rows x 16 bytes, and the B tile, transposed, as
// BK/16 panels of BN columns x 16 bytes (read col_major): every fragment
// then starts 256 bytes apart with ldm 16.
template <int BN, int WARPS_N>
struct SmemI8 {
  __align__(128) i8 a[BK / 16][BM][16];
  __align__(128) i8 b[BK / 16][BN][16];
  __align__(128) int stage[kWarps][16 * 16];
};

template <int BN, int WARPS_N>
using AccI8 = wmma::fragment<wmma::accumulator, 16, 16, 16, int>
    [Tiles<BN, WARPS_N>::FM][Tiles<BN, WARPS_N>::FN];

template <int BN, int WARPS_N>
__device__ __forceinline__ void zero_acc(AccI8<BN, WARPS_N>& acc) {
  using T = Tiles<BN, WARPS_N>;
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0);
}

// One BK-deep step of the block's int8 tile product from shared memory.
template <int BN, int WARPS_N>
__device__ __forceinline__ void mma_stage_i8(SmemI8<BN, WARPS_N>& s, int wm,
                                             int wn,
                                             AccI8<BN, WARPS_N>& acc) {
  using T = Tiles<BN, WARPS_N>;
#pragma unroll
  for (int p = 0; p < BK / 16; ++p) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>
        fa[T::FM];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major>
        fb[T::FN];
#pragma unroll
    for (int i = 0; i < T::FM; ++i)
      wmma::load_matrix_sync(fa[i], &s.a[p][wm * T::WM + i * 16][0], 16);
#pragma unroll
    for (int j = 0; j < T::FN; ++j)
      wmma::load_matrix_sync(fb[j], &s.b[p][wn * T::WN + j * 16][0], 16);
#pragma unroll
    for (int i = 0; i < T::FM; ++i)
#pragma unroll
      for (int j = 0; j < T::FN; ++j)
        wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
  }
}

// Rows [k0, k0+BK) x cols [n0, n0+BN) of a row-major (K, N) int8 weight into
// the transposed B tile; zero outside the matrix. Byte loads: consecutive
// threads read consecutive columns (coalesced), and the weights are small
// and L2-resident.
template <int BN, int WARPS_N>
__device__ __forceinline__ void load_b_i8(SmemI8<BN, WARPS_N>& s,
                                          const i8* __restrict__ w, int ldw,
                                          int k0, int K, int n0, int N) {
  for (int c = threadIdx.x; c < BK * BN; c += kThreads) {
    const int r = c / BN, n = c % BN;
    const int k = k0 + r, col = n0 + n;
    s.b[r / 16][n][r % 16] =
        (k < K && col < N) ? w[(long long)k * ldw + col] : (i8)0;
  }
}

// Sixteen int8 values from p, zero past ``valid``: one 16-byte load where
// all sixteen are in range and p is 16-byte aligned, else byte by byte (a
// ragged K tail, an unaligned row).
__device__ __forceinline__ uint4 load16_i8(const i8* __restrict__ p,
                                           int valid) {
  if (valid >= 16 && (reinterpret_cast<uintptr_t>(p) & 15) == 0)
    return *reinterpret_cast<const uint4*>(p);
  union {
    uint4 v;
    i8 b[16];
  } u;
  u.v = make_uint4(0u, 0u, 0u, 0u);
  for (int t = 0; t < 16 && t < valid; ++t) u.b[t] = p[t];
  return u.v;
}

// The WAGE activation quantizer's int8 code: clip to +-(1 - 1/s), then
// sign * floor(|y| * s + 0.5). |y| * s is exact (s is a power of two); the
// add rounds once, as the plain version's does.
__device__ __forceinline__ i8 q8(float y, float s) {
  const float lim = 1.f - 1.f / s;
  const float c = fminf(fmaxf(y, -lim), lim);
  const float r = floorf(__fadd_rn(__fmul_rn(fabsf(c), s), 0.5f));
  return (i8)(c < 0.f ? -r : r);
}

// Epilogues: each stores columns [n, n+8) of output row m from eight int32
// sums ``a``. The dequant multiplies by 1/s, a power of two (exact).
struct EpiBf16 {  // float(acc) / s, into a bf16 OutView (N % 8 == 0)
  OutView out;
  float inv_s;
  __device__ void operator()(long long m, int n, int N, const int* a) const {
    Pack8 o;
#pragma unroll
    for (int t = 0; t < 8; ++t) o.u[t] = hi(__fmul_rn((float)a[t], inv_s));
    *reinterpret_cast<uint4*>(out_row(out, m) + n) = o.v;
  }
};

struct EpiOutF32 {  // float(acc) / s, into a float32 view (N % 8 == 0)
  OutViewOf<float> out;
  float inv_s;
  __device__ void operator()(long long m, int n, int N, const int* a) const {
    float v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = __fmul_rn((float)a[t], inv_s);
    float* dst = out_row(out, m) + n;
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
};

struct EpiF32 {  // (float(acc) * col_scale[n]) * x_scale, JAX's order
  float* out;
  long long ld;
  const float* col_scale;
  float x_scale;
  __device__ void operator()(long long m, int n, int N, const int* a) const {
    for (int t = 0; t < 8 && n + t < N; ++t)
      out[m * ld + n + t] =
          __fmul_rn(__fmul_rn((float)a[t], col_scale[n + t]), x_scale);
  }
};

struct EpiQ8 {  // float(acc) / s, BN2 affine + ReLU, quantized to int8
  i8* out;
  long long ld;
  float inv_s;
  const float* inv2;
  const float* shift2;
  float s;
  __device__ void operator()(long long m, int n, int N, const int* a) const {
    for (int t = 0; t < 8 && n + t < N; ++t) {
      const float y = __fmul_rn((float)a[t], inv_s);
      out[m * ld + n + t] =
          q8(fmaxf(affine(y, inv2[n + t], shift2[n + t]), 0.f), s);
    }
  }
};

// Accumulators -> output rows through a per-warp 16x16 int32 stage.
template <int BN, int WARPS_N, class Epi>
__device__ __forceinline__ void store_tile_i8(SmemI8<BN, WARPS_N>& s, int wm,
                                              int wn, long long m0, int n0,
                                              long long M, int N,
                                              const Epi& epi,
                                              AccI8<BN, WARPS_N>& acc) {
  using T = Tiles<BN, WARPS_N>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* st = s.stage[warp];
  const int r = lane / 2, cc = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < T::FM; ++i) {
#pragma unroll
    for (int j = 0; j < T::FN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long m = m0 + wm * T::WM + i * 16 + r;
      const int n = n0 + wn * T::WN + j * 16 + cc;
      if (m < M && n < N) epi(m, n, N, &st[r * 16 + cc]);
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// affine_dot_i8:
//   out[m, n] = epi( sum_{k<K} q8(relu(x[m,k]*inv[k] + shift[k])) W[k,n] )
// x is a bf16 or float32 (TX) buffer view (K % 8 == 0, 16-byte rows), W
// int8.
// ---------------------------------------------------------------------------
template <int BN, int WARPS_N, class Epi, typename TX = bf16>
__global__ void __launch_bounds__(kThreads)
    affine_dot_i8_kernel(const TX* __restrict__ x, long long ldx,
                         long long M, int K, const float* __restrict__ inv,
                         const float* __restrict__ shift,
                         const i8* __restrict__ w, int ldw, int N, float s,
                         Epi epi) {
  __shared__ SmemI8<BN, WARPS_N> sm;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  AccI8<BN, WARPS_N> acc;
  zero_acc<BN, WARPS_N>(acc);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: the BN affine + ReLU + quantizer of eight bf16 values per
    // thread, stored as eight int8 codes
    for (int c = threadIdx.x; c < BM * BK / 8; c += kThreads) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const long long m = m0 + r;
      const int k = k0 + kc;
      union {
        uint2 v;
        i8 b[8];
      } q;
      q.v = make_uint2(0u, 0u);
      if (m < M && k < K) {
        if constexpr (sizeof(TX) == 2) {
          Pack8 in;
          in.v = *reinterpret_cast<const uint4*>(x + m * ldx + k);
#pragma unroll
          for (int t = 0; t < 8; ++t)
            q.b[t] = q8(fmaxf(affine(lo(in, t), inv[k + t], shift[k + t]),
                              0.f),
                        s);
        } else {
          const float* src = x + m * ldx + k;
          const float4 a = *reinterpret_cast<const float4*>(src);
          const float4 b = *reinterpret_cast<const float4*>(src + 4);
          const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int t = 0; t < 8; ++t)
            q.b[t] = q8(fmaxf(affine(v[t], inv[k + t], shift[k + t]), 0.f),
                        s);
        }
      }
      *reinterpret_cast<uint2*>(&sm.a[kc / 16][r][kc % 16]) = q.v;
    }
    load_b_i8(sm, w, ldw, k0, K, n0, N);
    __syncthreads();
    mma_stage_i8(sm, wm, wn, acc);
    __syncthreads();
  }
  store_tile_i8(sm, wm, wn, m0, n0, M, N, epi, acc);
}

// ---------------------------------------------------------------------------
// conv3x3_i8: SAME 3x3 conv of (B*H*W, C) int8 rows as an implicit GEMM of
// depth 9*C against the int8 HWIO weight viewed as (9*C, G); zero padding
// per image; dequantized by 1/s into bf16 or float32 (Epi).
// ---------------------------------------------------------------------------
template <int BN, int WARPS_N, class Epi = EpiBf16>
__global__ void __launch_bounds__(kThreads)
    conv3x3_i8_kernel(const i8* __restrict__ y, long long ldy, long long M,
                      int H, int W, int C, const i8* __restrict__ w, int G,
                      Epi epi) {
  __shared__ SmemI8<BN, WARPS_N> sm;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long hw = (long long)H * W;
  AccI8<BN, WARPS_N> acc;
  zero_acc<BN, WARPS_N>(acc);

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    for (int c0 = 0; c0 < C; c0 += BK) {
      for (int c = threadIdx.x; c < BM * BK / 16; c += kThreads) {
        const int r = c / (BK / 16), p = c % (BK / 16);
        const long long m = m0 + r;
        const int ch = c0 + p * 16;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m < M && ch < C) {
          const long long img = m / hw;
          const int px = (int)(m - img * hw);
          const int yy = px / W + dy, xx = px % W + dx;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W)
            v = load16_i8(y + (img * hw + (long long)yy * W + xx) * ldy + ch,
                          C - ch);
        }
        *reinterpret_cast<uint4*>(&sm.a[p][r][0]) = v;
      }
      // weight rows tap*C + [c0, c0+BK), masked at C
      load_b_i8(sm, w + (long long)tap * C * G, G, c0, C, n0, G);
      __syncthreads();
      mma_stage_i8(sm, wm, wn, acc);
      __syncthreads();
    }
  }
  store_tile_i8(sm, wm, wn, m0, n0, M, G, epi, acc);
}

// ---------------------------------------------------------------------------
// int8_matmul_dequant: (M, K) int8 rows @ (K, N) int8 -> float32, scaled
// (acc * col_scale[n]) * x_scale.
// ---------------------------------------------------------------------------
template <int BN, int WARPS_N>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_kernel(const i8* __restrict__ x, long long ldx, long long M,
                       int K, const i8* __restrict__ w, int ldw, int N,
                       EpiF32 epi) {
  __shared__ SmemI8<BN, WARPS_N> sm;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  AccI8<BN, WARPS_N> acc;
  zero_acc<BN, WARPS_N>(acc);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int c = threadIdx.x; c < BM * BK / 16; c += kThreads) {
      const int r = c / (BK / 16), p = c % (BK / 16);
      const long long m = m0 + r;
      const int k = k0 + p * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M && k < K) v = load16_i8(x + m * ldx + k, K - k);
      *reinterpret_cast<uint4*>(&sm.a[p][r][0]) = v;
    }
    load_b_i8(sm, w, ldw, k0, K, n0, N);
    __syncthreads();
    mma_stage_i8(sm, wm, wn, acc);
    __syncthreads();
  }
  store_tile_i8(sm, wm, wn, m0, n0, M, N, epi, acc);
}

dim3 grid_of(long long M, int N, int BN) {
  return dim3((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
}

// Launch ``kern<BN, WARPS_N>`` with the block width chosen by N, as
// buf_kernels.cu does: 16 (one warp column), 32, 64 or 128 (two).
#define CUNET_I8_DISPATCH(N, LAUNCH) \
  do {                               \
    if ((N) <= 16) {                 \
      LAUNCH(16, 1);                 \
    } else if ((N) <= 32) {          \
      LAUNCH(32, 2);                 \
    } else if ((N) <= 64) {          \
      LAUNCH(64, 2);                 \
    } else {                         \
      LAUNCH(128, 2);                \
    }                                \
  } while (0)

}  // namespace

extern "C" {

// f32: x (and, without inv2, out) float32, else bf16.
int cunet_affine_dot_i8(const void* x, long long ldx, long long M, int K,
                        const void* inv, const void* shift, const void* w,
                        int ldw, int N, float s, const void* inv2,
                        const void* shift2, void* out, long long ldo,
                        long long rows_per_img, long long img_stride,
                        int f32, void* stream) {
  const auto* xp = static_cast<const bf16*>(x);
  const auto* xf = static_cast<const float*>(x);
  const auto* ip = static_cast<const float*>(inv);
  const auto* sp = static_cast<const float*>(shift);
  const auto* wp = static_cast<const i8*>(w);
  const auto st = static_cast<cudaStream_t>(stream);
  if (inv2 && f32) {
    const EpiQ8 epi{static_cast<i8*>(out), ldo, 1.f / s,
                    static_cast<const float*>(inv2),
                    static_cast<const float*>(shift2), s};
#define LAUNCH(BN_, WN_)                                                    \
  affine_dot_i8_kernel<BN_, WN_, EpiQ8, float>                              \
      <<<grid_of(M, N, BN_), kThreads, 0, st>>>(xf, ldx, M, K, ip, sp, wp, \
                                                ldw, N, s, epi)
    CUNET_I8_DISPATCH(N, LAUNCH);
#undef LAUNCH
  } else if (f32) {
    const EpiOutF32 epi{
        OutViewOf<float>{static_cast<float*>(out), ldo, rows_per_img,
                         img_stride},
        1.f / s};
#define LAUNCH(BN_, WN_)                                                    \
  affine_dot_i8_kernel<BN_, WN_, EpiOutF32, float>                          \
      <<<grid_of(M, N, BN_), kThreads, 0, st>>>(xf, ldx, M, K, ip, sp, wp, \
                                                ldw, N, s, epi)
    CUNET_I8_DISPATCH(N, LAUNCH);
#undef LAUNCH
  } else if (inv2) {
    const EpiQ8 epi{static_cast<i8*>(out), ldo, 1.f / s,
                    static_cast<const float*>(inv2),
                    static_cast<const float*>(shift2), s};
#define LAUNCH(BN_, WN_)                                                    \
  affine_dot_i8_kernel<BN_, WN_, EpiQ8>                                     \
      <<<grid_of(M, N, BN_), kThreads, 0, st>>>(xp, ldx, M, K, ip, sp, wp, \
                                                ldw, N, s, epi)
    CUNET_I8_DISPATCH(N, LAUNCH);
#undef LAUNCH
  } else {
    const EpiBf16 epi{
        OutView{static_cast<bf16*>(out), ldo, rows_per_img, img_stride},
        1.f / s};
#define LAUNCH(BN_, WN_)                                                    \
  affine_dot_i8_kernel<BN_, WN_, EpiBf16>                                   \
      <<<grid_of(M, N, BN_), kThreads, 0, st>>>(xp, ldx, M, K, ip, sp, wp, \
                                                ldw, N, s, epi)
    CUNET_I8_DISPATCH(N, LAUNCH);
#undef LAUNCH
  }
  return (int)cudaGetLastError();
}

// f32: out float32, else bf16.
int cunet_conv3x3_i8(const void* y, long long ldy, long long M, int H, int W,
                     int C, const void* w, int G, float s, void* out,
                     long long ldo, int f32, void* stream) {
  const auto* yp = static_cast<const i8*>(y);
  const auto* wp = static_cast<const i8*>(w);
  const auto st = static_cast<cudaStream_t>(stream);
  if (f32) {
    const EpiOutF32 epi{OutViewOf<float>{static_cast<float*>(out), ldo, M, 0},
                        1.f / s};
#define LAUNCH(BN_, WN_)                                           \
  conv3x3_i8_kernel<BN_, WN_, EpiOutF32>                           \
      <<<grid_of(M, G, BN_), kThreads, 0, st>>>(yp, ldy, M, H, W, C, wp, \
                                                 G, epi)
    CUNET_I8_DISPATCH(G, LAUNCH);
#undef LAUNCH
    return (int)cudaGetLastError();
  }
  const EpiBf16 epi{OutView{static_cast<bf16*>(out), ldo, M, 0}, 1.f / s};
#define LAUNCH(BN_, WN_)                                              \
  conv3x3_i8_kernel<BN_, WN_><<<grid_of(M, G, BN_), kThreads, 0, st>>>( \
      yp, ldy, M, H, W, C, wp, G, epi)
  CUNET_I8_DISPATCH(G, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}

int cunet_int8_matmul_dequant(const void* x, long long ldx, long long M,
                              int K, const void* w, int ldw, int N,
                              const void* col_scale, float x_scale, void* out,
                              long long ldo, void* stream) {
  const EpiF32 epi{static_cast<float*>(out), ldo,
                   static_cast<const float*>(col_scale), x_scale};
  const auto* xp = static_cast<const i8*>(x);
  const auto* wp = static_cast<const i8*>(w);
  const auto st = static_cast<cudaStream_t>(stream);
#define LAUNCH(BN_, WN_)                                               \
  int8_matmul_kernel<BN_, WN_><<<grid_of(M, N, BN_), kThreads, 0, st>>>( \
      xp, ldx, M, K, wp, ldw, N, epi)
  CUNET_I8_DISPATCH(N, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
