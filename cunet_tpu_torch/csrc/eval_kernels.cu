// Hand-written Hopper kernel of the eval-mode concat-free product over a
// feature table (cunet_tpu_torch/kernels/eval_ops.py wraps it):
//
//   out_a[m, n] = epi( sum_k bf16(relu(x[m,k]*inv_a[k] + shift_a[k])) W_a[k, n] )
//   out_s[m, n] =      sum_k bf16(relu(x[m,k]*inv_s[k] + shift_s[k])) W_s[k, n]
//
// where x is the virtual concat of G <= 16 separate bf16 (M, C_g) tensors,
// the affine is float32, the product bf16 with float32 accumulators, and each
// output is rounded to bf16 once. epi is the identity or relu(. + bias[n])
// (the bottleneck's folded BN2). The second output is optional (the dual
// form: a down block's ahead and skip adapters from one read of x).
//
// It is the Hopper counterpart of two TPU kernels:
//   cunet_tpu/kernels/fused_bottleneck.py::fused_bottleneck_infer (:76) and
//   fused_dual_bottleneck_infer (:178), TPU kernel #6;
//   every 1x1 stage of cunet_tpu/kernels/fused_hourglass.py::
//   fused_hourglass_infer (:447, _bottleneck_val :229), TPU kernel #4.
//
// The table (pointer, row stride, column offset of each group) travels by
// value in the launch parameters (__grid_constant__), so no fill launch and
// no device buffer exist: the FIFO entries, the skip and the out32 that a
// stage reads stay separate tensors and are read in place. Group widths,
// row strides and pointers are multiples of 8 elements / 16 bytes (the
// wrapper checks), so an 8-column vector never straddles two groups.
//
// Bound on the H100 by bytes, not by the tensor cores: K=192 -> 2 x 128 at
// M = 32,768 does ~109 flop per byte moved, against ~295 the card can do.
// Design: affine_dot's (buf_kernels.cu): 128-row block tiles over the full N,
// the prologue in float32 registers between the 16-byte global load and the
// bf16 shared-memory tile, WMMA with float32 accumulators. The dual form
// builds both prologues from one load. N tails (the face head's 68 classes)
// and row tails are handled in the kernel: weights and outputs whose rows are
// not 16-byte aligned move element by element.
//
// The entry point launches on the stream it is given and returns
// cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int kMaxGroups = 16;

// The virtual concat: group g holds columns [off[g], off[g+1]).
struct FeatTable {
  const bf16* ptr[kMaxGroups];
  long long ld[kMaxGroups];
  int off[kMaxGroups + 1];
  int G;
};

// One output: its BN vectors, its weight (row stride ldw; wvec: 16-byte
// rows) and where it goes (ovec: 16-byte output rows).
struct Operand {
  const float* inv;
  const float* shift;
  const bf16* w;
  int ldw;
  int wvec;
  OutView out;
  int ovec;
};

struct Operands {
  Operand o[2];
};

template <int BN, int NOUT>
struct TableSmem {
  __align__(128) bf16 a[NOUT][BM][BK + kPad];
  __align__(128) bf16 b[NOUT][BK][BN + kPad];
  __align__(128) float stage[kWarps][16 * 16];
};

// Rows [k0, k0+BK) x cols [n0, n0+BN) of the weight into shared memory; zero
// outside rows [0, K) and columns [0, N).
template <int BN>
__device__ __forceinline__ void load_w(bf16 (&b)[BK][BN + kPad],
                                       const Operand& op, int k0, int K,
                                       int n0, int N) {
  for (int c = threadIdx.x; c < BK * BN / 8; c += kThreads) {
    const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    const int k = k0 + r, n = n0 + nc;
    Pack8 v;
    v.v = make_uint4(0u, 0u, 0u, 0u);
    if (k < K && n < N) {
      const bf16* src = op.w + (long long)k * op.ldw + n;
      if (op.wvec && n + 8 <= N) {
        v.v = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t)
          if (n + t < N) v.u[t] = __bfloat16_as_ushort(src[t]);
      }
    }
    *reinterpret_cast<uint4*>(&b[r][nc]) = v.v;
  }
}

template <int BN, int WARPS_N>
__device__ __forceinline__ void mma_tiles(
    const bf16 (&a)[BM][BK + kPad], const bf16 (&b)[BK][BN + kPad], int wm,
    int wn,
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (
        &acc)[Tiles<BN, WARPS_N>::FM][Tiles<BN, WARPS_N>::FN]) {
  using T = Tiles<BN, WARPS_N>;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[T::FM];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[T::FN];
#pragma unroll
    for (int i = 0; i < T::FM; ++i)
      wmma::load_matrix_sync(fa[i], &a[wm * T::WM + i * 16][kk], BK + kPad);
#pragma unroll
    for (int j = 0; j < T::FN; ++j)
      wmma::load_matrix_sync(fb[j], &b[kk][wn * T::WN + j * 16], BN + kPad);
#pragma unroll
    for (int i = 0; i < T::FM; ++i)
#pragma unroll
      for (int j = 0; j < T::FN; ++j)
        wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
  }
}

// Accumulators -> bf16 output rows through a per-warp 16x16 float32 stage;
// with BIAS the epilogue is relu(acc + bias[n]).
template <int BN, int WARPS_N, bool BIAS>
__device__ __forceinline__ void store_out(
    float (&stage)[kWarps][16 * 16], int wm, int wn, long long m0, int n0,
    long long M, int N, const float* __restrict__ bias, const Operand& op,
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (
        &acc)[Tiles<BN, WARPS_N>::FM][Tiles<BN, WARPS_N>::FN]) {
  using T = Tiles<BN, WARPS_N>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* st = stage[warp];
  const int r = lane / 2, cc = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < T::FM; ++i) {
#pragma unroll
    for (int j = 0; j < T::FN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long m = m0 + wm * T::WM + i * 16 + r;
      const int n = n0 + wn * T::WN + j * 16 + cc;
      if (m < M && n < N) {
        Pack8 o;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          float v = st[r * 16 + cc + t];
          if (BIAS && n + t < N) v = fmaxf(v + bias[n + t], 0.f);
          o.u[t] = hi(v);
        }
        bf16* dst = out_row(op.out, m) + n;
        if (op.ovec && n + 8 <= N) {
          *reinterpret_cast<uint4*>(dst) = o.v;
        } else {
#pragma unroll
          for (int t = 0; t < 8; ++t)
            if (n + t < N) dst[t] = __ushort_as_bfloat16(o.u[t]);
        }
      }
      __syncwarp();
    }
  }
}

template <int BN, int WARPS_N, int NOUT, bool BIAS>
__global__ void __launch_bounds__(kThreads)
    table_dot_kernel(const __grid_constant__ FeatTable tbl, long long M,
                     int N, const __grid_constant__ Operands ops,
                     const float* __restrict__ bias) {
  using T = Tiles<BN, WARPS_N>;
  __shared__ TableSmem<BN, NOUT> s;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = tbl.off[tbl.G];

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NOUT][T::FM][T::FN];
#pragma unroll
  for (int o = 0; o < NOUT; ++o)
#pragma unroll
    for (int i = 0; i < T::FM; ++i)
#pragma unroll
      for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[o][i][j], 0.f);

  // each thread fills one 8-column vector of the A tiles in every
  // kRowStep-th row: one group lookup per stage
  constexpr int kVecs = BK / 8;
  constexpr int kRowStep = kThreads / kVecs;
  const int kc = (threadIdx.x % kVecs) * 8;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const int k = k0 + kc;
    const bf16* col = nullptr;
    long long ld = 0;
    if (k < K) {
      int g = 0;
      while (g + 1 < tbl.G && k >= tbl.off[g + 1]) ++g;
      col = tbl.ptr[g] + (k - tbl.off[g]);
      ld = tbl.ld[g];
    }
    for (int r = threadIdx.x / kVecs; r < BM; r += kRowStep) {
      const long long m = m0 + r;
      Pack8 o[NOUT];
#pragma unroll
      for (int q = 0; q < NOUT; ++q) o[q].v = make_uint4(0u, 0u, 0u, 0u);
      if (col != nullptr && m < M) {
        Pack8 in;
        in.v = *reinterpret_cast<const uint4*>(col + m * ld);
#pragma unroll
        for (int q = 0; q < NOUT; ++q)
#pragma unroll
          for (int t = 0; t < 8; ++t)
            o[q].u[t] = act(lo(in, t), ops.o[q].inv[k + t],
                            ops.o[q].shift[k + t], 0);
      }
#pragma unroll
      for (int q = 0; q < NOUT; ++q)
        *reinterpret_cast<uint4*>(&s.a[q][r][kc]) = o[q].v;
    }
#pragma unroll
    for (int q = 0; q < NOUT; ++q) load_w<BN>(s.b[q], ops.o[q], k0, K, n0, N);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < NOUT; ++q)
      mma_tiles<BN, WARPS_N>(s.a[q], s.b[q], wm, wn, acc[q]);
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < NOUT; ++q)
    store_out<BN, WARPS_N, BIAS>(s.stage, wm, wn, m0, n0, M, N, bias,
                                 ops.o[q], acc[q]);
}

template <int BN, int WARPS_N>
void launch_table_dot(const FeatTable& tbl, long long M, int N,
                      const Operands& ops, int nout, const float* bias,
                      cudaStream_t stream) {
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  if (nout == 2)
    table_dot_kernel<BN, WARPS_N, 2, false>
        <<<grid, kThreads, 0, stream>>>(tbl, M, N, ops, nullptr);
  else if (bias)
    table_dot_kernel<BN, WARPS_N, 1, true>
        <<<grid, kThreads, 0, stream>>>(tbl, M, N, ops, bias);
  else
    table_dot_kernel<BN, WARPS_N, 1, false>
        <<<grid, kThreads, 0, stream>>>(tbl, M, N, ops, nullptr);
}

Operand make_operand(const void* inv, const void* shift, const void* w,
                     int ldw, void* out, long long ldo, long long rows_per_img,
                     long long img_stride) {
  Operand op;
  op.inv = static_cast<const float*>(inv);
  op.shift = static_cast<const float*>(shift);
  op.w = static_cast<const bf16*>(w);
  op.ldw = ldw;
  op.wvec = ldw % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  op.out = OutView{static_cast<bf16*>(out), ldo, rows_per_img, img_stride};
  op.ovec = ldo % 8 == 0 && img_stride % 8 == 0 &&
            reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return op;
}

}  // namespace

extern "C" {

// feats / lds / widths: the G groups (G <= 16). Output a is required; a
// null out_s selects the single form, a non-null bias its relu(. + bias)
// epilogue (single form only). Both outputs share N and the weight stride.
int cunet_table_dot(const void* const* feats, const long long* lds,
                    const int* widths, int G, long long M, const void* inv_a,
                    const void* shift_a, const void* w_a, const void* inv_s,
                    const void* shift_s, const void* w_s, int ldw, int N,
                    const void* bias, void* out_a, long long ldo_a,
                    long long rows_per_img_a, long long img_stride_a,
                    void* out_s, long long ldo_s, void* stream) {
  if (G < 1 || G > kMaxGroups) return (int)cudaErrorInvalidValue;
  FeatTable tbl;
  tbl.G = G;
  tbl.off[0] = 0;
  for (int g = 0; g < kMaxGroups; ++g) {
    tbl.ptr[g] = g < G ? static_cast<const bf16*>(feats[g]) : nullptr;
    tbl.ld[g] = g < G ? lds[g] : 0;
    tbl.off[g + 1] = tbl.off[g] + (g < G ? widths[g] : 0);
  }
  Operands ops;
  ops.o[0] = make_operand(inv_a, shift_a, w_a, ldw, out_a, ldo_a,
                          rows_per_img_a, img_stride_a);
  const int nout = out_s ? 2 : 1;
  ops.o[1] = out_s ? make_operand(inv_s, shift_s, w_s, ldw, out_s, ldo_s, M, 0)
                   : ops.o[0];
  const auto* bp = static_cast<const float*>(bias);
  const auto st = static_cast<cudaStream_t>(stream);
  if (N <= 16)
    launch_table_dot<16, 1>(tbl, M, N, ops, nout, bp, st);
  else if (N <= 32)
    launch_table_dot<32, 2>(tbl, M, N, ops, nout, bp, st);
  else if (N <= 64)
    launch_table_dot<64, 2>(tbl, M, N, ops, nout, bp, st);
  else
    launch_table_dot<128, 2>(tbl, M, N, ops, nout, bp, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
