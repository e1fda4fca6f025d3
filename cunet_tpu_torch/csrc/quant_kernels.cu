// The hand-written Hopper kernel of the plain int8 inference path: the
// int8 1x1 conv int8_matmul_dequant (cunet_tpu_torch/kernels/
// quant_matmul.py), counterpart of cunet_tpu/kernels/quant_matmul.py (TPU
// kernel #10). The quantized whole-model forward's int8 kernels are in
// i8_kernels.cu.
//
// Built by nvcc with the other sources of this directory into one shared
// library with a plain C interface, loaded with ctypes
// (cunet_tpu_torch/kernels/build.py).
//
// The first, 128-row block tiling of affine_dot (buf_kernels.cu, since
// redesigned) with int8 operands: 16x16x16 int8 WMMA fragments, int32
// accumulators, a float32 epilogue in registers. Integer products
// accumulate exactly in any order and the epilogue multiplies in JAX's
// order, so the kernel is bit-identical to its plain version.
//
// The entry point launches on the stream it is given and returns
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

// The epilogue: stores columns [n, n+8) of output row m from eight int32
// sums ``a``.
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
