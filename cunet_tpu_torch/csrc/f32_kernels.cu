// Hand-written Hopper kernels of the float32 products: the float32 forms
// of table_dot (eval_kernels.cu), affine_dot and conv3x3 (buf_kernels.cu),
// for a model served at compute_dtype="float32" as the TPU kernels run it
// (cunet_tpu_torch/kernels/eval_ops.py and buf_ops.py wrap it), and the
// float32 products of its ghost-BN training (the slot kernels #8/#9,
// kernels/train_ops.py). One kernel template, dot3_kernel, computes
//
//   out_a[m, n] = epi( sum_k pro_a(x[m, k]) W_a[k, n] )
//   out_s[m, n] =      sum_k pro_s(x[m, k]) W_s[k, n]      (dual form)
//
// with x, W and out float32, pro(x) = relu(x * inv[k] + shift[k]) in
// float32 with no rounding (none for the conv), epi the identity, relu(. +
// b[n]) or relu(. * a[n] + b[n]) as in table_dot, the up / pool options of
// table_dot, and x read either
//   - through a feature table of G float32 groups (table_dot's float32
//     form, its table by value up to 16 groups, else in device memory as
//     table_dot's; affine_dot's is the table of one group, the strided
//     prefix buf[:, :K] of a channel-plane buffer), or
//   - as the implicit GEMM of a SAME 3x3 conv (conv3x3's float32 form): K =
//     9C tap-major, A[m, tap*C + c] = y[m + dy*W + dx, c], zero where the
//     source pixel lies outside m's image.
// The ghost-BN train step adds per-tile BN vectors (each row reads its
// own tile's [inv; shift]: a tile of 96 rows does not divide a 128-row
// block), the conv's BN2 prologue, and a gate epilogue (kEpiGate: the
// backward's ReLU mask of the stage input), so that affine_dx and
// conv3x3_dx run as dot3_kernel on the float32 cotangent through the
// transposed (flipped) weight, no prologue; dw3_kernel below takes the
// weight gradients, the product over the rows.
// The QuanInput options of the quantized model's training (W1/I8/G8 at
// float32): a prologue quantizer quan(relu(x * inv + shift), bits) on the
// unrounded float32 value (the bf16 forms' act() rounds to bf16 first;
// here nothing rounds but the affine's product and sum), in the 1x1
// forward (the head), the conv's BN2 prologue and dw3_kernel's z; and the
// straight-through gate 0 < z < 1 in the gate epilogue (ste). A code
// k / 2^(bits-1) with bits <= 9 has at most 8 significant bits, one bf16
// plane: its second and third planes are zero, so those forms skip the
// three products of the x planes 2 and 3 (exact: they add zeros).
// It replaces, at float32, the 1x1 stages and the conv of TPU kernels #1
// (cunet_tpu/kernels/fused_model_buf.py::_affine_dot :52, _conv3x3 via
// fused_hourglass.py:75), #4 (fused_hourglass.py::_bottleneck_val :229),
// #5 (fused_block.py::fused_dense_block_infer :207) and #6
// (fused_bottleneck.py :76, :178), and the products of #8/#9
// (train_slot.py::_dot :172, _conv3x3_t :647, _dot_dx :541, _dot_dw :549,
// _conv3x3_bwd :732), which run float32 x float32 products with float32
// accumulation at compute_dtype="float32".
//
// Arithmetic: float32-accurate on the tensor cores. Both operands are split
// exactly into three bf16 planes (split3, common.cuh: v = p1 + p2 + p3)
// as they are staged into shared memory, and each k16 step adds the six
// plane products x_i * w_j with i + j <= 4 (1-based) into the chunk's
// float32 accumulator, in one fixed order, the small terms first:
//   x1 w3, x2 w2, x1 w2, x3 w1, x2 w1, x1 w1
// (the dropped x2 w3, x3 w2, x3 w3 are below float32 rounding). One bf16 or
// TF32 pass would move the outputs by ~1e-3 relative. Each 32-deep chunk
// sums from zero in a fragment of its own, which joins the output's
// running sum by one float32 add on the CUDA cores (round to nearest,
// add_acc3): the tensor cores' float32 accumulation truncates, and a sum
// carried through every k16 step of a deep product (the 3x3 conv's
// 1,152) drifted toward zero (PERF.md section 6).
// Under a one-hot W (w2 = w3 = 0) a sum is 0 + x3 + x2 + x1, exactly the
// prologue value. Every output sums k ascending in those chunks whatever
// the form (single, dual, pooled, table or strided view), so the float32
// whole-model path (affine_dot) and the per-slot path (table_dot) agree bit
// for bit, as their bf16 forms do.
//
// Design: 128-row block tiles over BN columns (16, 32, 64 or 128; N in
// column tiles past 128), K streamed in chunks of BK = 32: each thread
// loads its chunk's x vectors into registers one chunk ahead (the global
// loads of chunk k+1 run under the products of chunk k; the single form
// fetches its W chunk and prologue vectors with them), then applies the
// prologue and writes the three planes of each output's A tile; the W
// chunk is split into its three planes beside it; 8 warps take the
// six-plane products by WMMA (bf16 16x16x16, float32 accumulators). The
// shared memory holds one chunk (NOUT x 3 planes of A and of W, 57 KB at
// BN = 128 single, 114 KB dual), so no weight is resident and every K
// fits. Outputs leave through a per-warp float32 stage as 16-byte stores;
// the pooled store keeps the float32 output tile in the operand tiles'
// bytes (128 x (BN + 4) floats, 66 KB at BN = 128) and writes each 2x2
// window's max. The conv splits K across blocks where its output tiles
// are few (the small resolutions), each split's partial summed in split
// order by the tile's last block. Bound at K = 192 -> 128, r = 64, batch
// 8: 42.0 MB of float32 bytes (12.5 us at 3.35 TB/s) against 9.7 GFLOP of
// six bf16 passes (9.8 us at 989 TFLOP/s); float32 FMA on the CUDA cores
// would take 24.0 us. Measured 57.1 us there on an H100 80GB HBM3 at 700 W
// (PERF.md section 6, PR 13).
//
// The entry points launch on the stream they are given and return
// cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int BK3 = 32;   // reduction depth of a chunk

// Where x comes from: a feature table (C == 0; past kMaxGroups groups its
// rows at ext, common.cuh) or a 3x3 conv's input (C > 0: group 0 is the
// (M, C) input; H, W its images).
struct Src {
  const float* ptr[kMaxGroups];
  long long ld[kMaxGroups];
  int off[kMaxGroups + 1];
  int G;
  int K;      // the concat's width (a 1x1 product)
  int up;     // bit g: group g is read through a 2x nearest upsample
  int H, W;   // the output images (up, pool, conv)
  int C;      // conv input channels, K = 9C; 0: a 1x1 product
  const long long* ext;
};

// One output: its prologue vectors (null: none), its weight, its epilogue
// vectors and where it goes (16-byte vectors where wvec / ovec). The BN
// vectors of the prologue (inv, shift) and of the gate epilogue (ea, eb)
// are one (2, K) eval pair (vstride 0) or per-tile ghost-BN pairs: row m
// reads tile m / tile_rows's, vstride floats after the previous tile's. The
// gate epilogue (kEpiGate, the backward's ReLU mask) reads the stage input
// gx (M, N) at row stride ldgx.
struct Op3 {
  const float* inv;
  const float* shift;
  const float* w;
  int ldw;
  int wvec;
  const float* ea;
  const float* eb;
  OutViewOf<float> out;
  int ovec;
  long long vstride;
  long long tile_rows;
  const float* gx;
  long long ldgx;
  int bits;   // QuanInput's quantizer on the prologue's output (QUANT)
};

// The backward's epilogue: the product where the recomputed pre-ReLU BN
// output z = gx * ea + eb of its element is positive, else zero; with
// kEpiGateSte (QuanInput's straight-through estimator) also zero where z
// >= 1.
constexpr int kEpiGate = 3;
constexpr int kEpiGateSte = 4;

struct Ops3 {
  Op3 o[2];
};

// Split-K (the conv at small M): block (tile, column tile, s) sums chunks
// [s * nchunk / n, (s + 1) * nchunk / n) into its (M, N) float32 partial
// at part + s * M * N; the last block of a tile to finish (counted in
// counters[tile], zeroed on the stream before the launch) adds the n
// partials in the order s = 0 .. n-1 and stores the sum, so the bits do
// not depend on which block finishes last. Both live in the caller's
// buffer of this one launch, so concurrent launches share nothing. n == 1:
// no split.
struct Split {
  float* part;
  int* counters;
  int n;
};

// The dynamic shared memory of a block: NOUT x 3 planes of the A chunk
// (BM x BK3, row stride BK3 + kPad) and of the W chunk (BK3 x BN, stride
// BN + kPad), bf16; with POOL the float32 output tile over the same bytes;
// then the warps' 16x16 float32 stages. kernels/buf_ops.py::dot3_plan
// computes the same sizes.
template <int BN, int NOUT, bool POOL>
struct Smem3 {
  static constexpr int AS = BK3 + kPad;
  static constexpr int BS = BN + kPad;
  static constexpr int A_PLANE = BM * AS;     // elements
  static constexpr int B_PLANE = BK3 * BS;
  static constexpr int A_BYTES = NOUT * 3 * A_PLANE * 2;
  static constexpr int IN_BYTES = A_BYTES + NOUT * 3 * B_PLANE * 2;
  static constexpr int OS = BN + 4;           // float32 output tile stride
  static constexpr int OUT_BYTES = POOL ? BM * OS * 4 : 0;
  static constexpr int RAW =
      ((IN_BYTES > OUT_BYTES ? IN_BYTES : OUT_BYTES) + 127) / 128 * 128;
  static constexpr int kBytes = RAW + kWarps * 256 * 4;
};

// Eight float32 values into their three bf16 planes at p[0], p[1], p[2]
// (16 bytes each).
__device__ __forceinline__ void store_planes(const float (&v)[8],
                                             bf16* p0, bf16* p1, bf16* p2) {
  Pack8 a, b, c;
#pragma unroll
  for (int t = 0; t < 8; ++t) split3(v[t], a.u[t], b.u[t], c.u[t]);
  *reinterpret_cast<uint4*>(p0) = a.v;
  *reinterpret_cast<uint4*>(p1) = b.v;
  *reinterpret_cast<uint4*>(p2) = c.v;
}

// The first plane alone: codes of a one-plane QuanInput operand, which
// bf16 holds exactly (no product reads the other two planes then).
__device__ __forceinline__ void store_plane1(const float (&v)[8], bf16* p0) {
  Pack8 a;
#pragma unroll
  for (int t = 0; t < 8; ++t) a.u[t] = hi(v[t]);
  *reinterpret_cast<uint4*>(p0) = a.v;
}

__device__ __forceinline__ void load8f(const float* p, bool vec,
                                       float (&v)[8]) {
  if (vec) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = p[t];
  }
}

template <int EPI>
__device__ __forceinline__ float epilogue3(float v, const Op3& op,
                                           long long m, int n) {
  if (EPI == kEpiShift) return fmaxf(v + op.eb[n], 0.f);
  if (EPI == kEpiScale) return fmaxf(affine(v, op.ea[n], op.eb[n]), 0.f);
  if (EPI == kEpiGate || EPI == kEpiGateSte) {
    const long long o = (op.vstride ? m / op.tile_rows : 0) * op.vstride + n;
    const float z = affine(op.gx[m * op.ldgx + n], op.ea[o], op.eb[o]);
    return z > 0.f && (EPI == kEpiGate || z < 1.f) ? v : 0.f;
  }
  return v;
}

// Eight float32 values to columns n .. n+8 of row dst (those below N).
__device__ __forceinline__ void put8(float* dst, const float (&v)[8], int n,
                                     int N, bool vec) {
  if (vec && n + 8 <= N) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (n + t < N) dst[t] = v[t];
  }
}

template <int BN, int WARPS_N>
using Acc3 = wmma::fragment<wmma::accumulator, 16, 16, 16, float>[
    Tiles<BN, WARPS_N>::FM][Tiles<BN, WARPS_N>::FN];

template <int BN, int WARPS_N>
__device__ __forceinline__ void zero_acc3(Acc3<BN, WARPS_N>& acc) {
#pragma unroll
  for (int i = 0; i < Tiles<BN, WARPS_N>::FM; ++i)
#pragma unroll
    for (int j = 0; j < Tiles<BN, WARPS_N>::FN; ++j)
      wmma::fill_fragment(acc[i][j], 0.f);
}

// acc += part, element by element on the CUDA cores (round to nearest).
// A chunk's products sum in a fragment of their own and join the running
// sums here: the tensor cores' float32 accumulation truncates, and every
// k16 step of a long reduction added into one accumulator biased its sums
// toward zero (PERF.md section 6).
template <int BN, int WARPS_N>
__device__ __forceinline__ void add_acc3(Acc3<BN, WARPS_N>& acc,
                                         const Acc3<BN, WARPS_N>& part) {
#pragma unroll
  for (int i = 0; i < Tiles<BN, WARPS_N>::FM; ++i)
#pragma unroll
    for (int j = 0; j < Tiles<BN, WARPS_N>::FN; ++j)
#pragma unroll
      for (int e = 0; e < acc[i][j].num_elements; ++e)
        acc[i][j].x[e] += part[i][j].x[e];
}

// One BK3-deep chunk of the six plane products into ``part``: W planes 3,
// 2, 1; with each, the x planes that keep i + j <= 4 (1-based), largest
// index first (the order in the header). XP = 1: the x operand is one
// bf16 plane (QuanInput codes of bits <= 9; planes 2, 3 zero), whose
// three products are the only nonzero ones: the same sums. Fragment i of
// x plane p at depth step kk is at a + p * a_plane + a0 + i * 16 * row_step
// + kk * k_step, leading dimension lda (dot3_kernel's row-major tile:
// row_step lda, k_step 1; dw3_kernel's depth-major z: row_step 1, k_step
// lda).
template <int BN, int WARPS_N, int XP, typename ALayout>
__device__ __forceinline__ void chunk_products(
    const bf16* a, int a_plane, int a0, int row_step, int k_step, int lda,
    const bf16* b, int b_plane, int ldb, int wn, Acc3<BN, WARPS_N>& part) {
  using T = Tiles<BN, WARPS_N>;
#pragma unroll
  for (int kk = 0; kk < BK3; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa[XP][T::FM];
#pragma unroll
    for (int p = 0; p < XP; ++p)
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
        wmma::load_matrix_sync(fa[p][i], a + p * a_plane + a0 +
                                             i * 16 * row_step + kk * k_step,
                               lda);
#pragma unroll
    for (int pw = 2; pw >= 0; --pw) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          fb[T::FN];
#pragma unroll
      for (int j = 0; j < T::FN; ++j)
        wmma::load_matrix_sync(
            fb[j], b + pw * b_plane + kk * ldb + wn * T::WN + j * 16, ldb);
#pragma unroll
      for (int px = (2 - pw < XP - 1 ? 2 - pw : XP - 1); px >= 0; --px)
#pragma unroll
        for (int i = 0; i < T::FM; ++i)
#pragma unroll
          for (int j = 0; j < T::FN; ++j)
            wmma::mma_sync(part[i][j], fa[px][i], fb[j], part[i][j]);
    }
  }
}

// Accumulators -> epilogue -> float32 output rows, through the warp's
// 16x16 stage.
template <int BN, int WARPS_N, int EPI>
__device__ __forceinline__ void store_out3(float* stage, int wm, int wn,
                                           long long m0, int n0, long long M,
                                           int N, const Op3& op,
                                           Acc3<BN, WARPS_N>& acc) {
  using T = Tiles<BN, WARPS_N>;
  const int lane = threadIdx.x % 32;
  float* st = stage + (threadIdx.x / 32) * 256;
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
        float v[8];
#pragma unroll
        for (int t = 0; t < 8; ++t)
          v[t] = n + t < N
                     ? epilogue3<EPI>(st[r * 16 + cc + t], op, m, n + t)
                     : 0.f;
        put8(out_row(op.out, m) + n, v, n, N, op.ovec);
      }
      __syncwarp();
    }
  }
}

// The pooled store: accumulators -> epilogue -> the block's float32 output
// tile in shared memory, then the max of each 2x2 window (maxpool2's order)
// to its row of the (M/4, N) output. The tile's 128 rows are whole pairs of
// image rows (the wrapper checks that 2W divides BM).
template <int BN, int WARPS_N, int EPI>
__device__ __forceinline__ void store_pooled3(float* tile, float* stage,
                                              int wm, int wn, long long m0,
                                              int n0, long long M, int N,
                                              int W, const Op3& op,
                                              Acc3<BN, WARPS_N>& acc) {
  using T = Tiles<BN, WARPS_N>;
  constexpr int OS = BN + 4;
  const int lane = threadIdx.x % 32;
  float* st = stage + (threadIdx.x / 32) * 256;
  const int r = lane / 2, cc = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < T::FM; ++i) {
#pragma unroll
    for (int j = 0; j < T::FN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = wm * T::WM + i * 16 + r;
      const int col = wn * T::WN + j * 16 + cc;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int n = n0 + col + t;
        tile[row * OS + col + t] =
            n < N ? epilogue3<EPI>(st[r * 16 + cc + t], op, m0 + row, n)
                  : 0.f;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  const int wo = W / 2;
  const long long mp_end = M / 4;
  for (int c = threadIdx.x; c < (BM / 4) * (BN / 8); c += kThreads) {
    const int p = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    const long long mp = m0 / 4 + p;
    const int n = n0 + nc;
    if (mp >= mp_end || n >= N) continue;
    const float* t00 = tile + ((p / wo) * 2 * W + (p % wo) * 2) * OS + nc;
    float v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t)
      v[t] = fmaxf(fmaxf(t00[t], t00[OS + t]),
                   fmaxf(t00[W * OS + t], t00[(W + 1) * OS + t]));
    put8(out_row(op.out, mp) + n, v, n, N, op.ovec);
  }
}

// The last block of a split tile: the partials of rows m0.. and columns
// n0.. summed in split order, then the epilogue, into the output.
template <int BN, int EPI>
__device__ __forceinline__ void reduce_split(const Split& sp, long long m0,
                                             int n0, long long M, int N,
                                             const Op3& op) {
  const bool vec = N % 4 == 0;
  for (int c = threadIdx.x; c < BM * (BN / 8); c += kThreads) {
    const long long m = m0 + c / (BN / 8);
    const int n = n0 + (c % (BN / 8)) * 8;
    if (m >= M || n >= N) continue;
    float v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = 0.f;
    for (int s = 0; s < sp.n; ++s) {
      const float* p = sp.part + ((long long)s * M + m) * N + n;
      if (vec && n + 8 <= N) {
        const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
        const float4 b = __ldcg(reinterpret_cast<const float4*>(p + 4));
        v[0] += a.x; v[1] += a.y; v[2] += a.z; v[3] += a.w;
        v[4] += b.x; v[5] += b.y; v[6] += b.z; v[7] += b.w;
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t)
          if (n + t < N) v[t] += __ldcg(p + t);
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (n + t < N) v[t] = epilogue3<EPI>(v[t], op, m, n + t);
    put8(out_row(op.out, m) + n, v, n, N, op.ovec);
  }
}

// EXT: the feature table in device memory (find_group); QUANT: the
// prologue's QuanInput quantizer (op.bits) and the one-plane products. Both
// template parameters, so an instance without them carries none of their
// code.
template <int BN, int WARPS_N, int NOUT, bool POOL, int EPI, bool CONV,
          bool EXT, bool QUANT>
__global__ void __launch_bounds__(kThreads)
    dot3_kernel(const __grid_constant__ Src src, long long M, int N,
                const __grid_constant__ Ops3 ops, const Split sp) {
  using T = Tiles<BN, WARPS_N>;
  using S = Smem3<BN, NOUT, POOL>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* const A = reinterpret_cast<bf16*>(smem);
  bf16* const B = reinterpret_cast<bf16*>(smem + S::A_BYTES);
  float* const stage = reinterpret_cast<float*>(smem + S::RAW);
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = CONV ? 9 * src.C : src.K;
  // a prologue's vectors per row (per-tile ghost-BN vectors, or the
  // conv's, whose column is the channel of a tap), fetched at commit; else
  // one eval pair, a chunk ahead (the single form)
  const bool row_vecs = CONV || ops.o[0].vstride != 0;
  // the QuanInput prologue's constants (QUANT: a single-output form); its
  // codes of bits <= 9 fill one bf16 plane (planes 2, 3 zero)
  const QuanConst qc = quan_const(QUANT ? ops.o[0].bits : 0);
  const bool one = QUANT && ops.o[0].bits >= 1 && ops.o[0].bits <= 9;

  Acc3<BN, WARPS_N> acc[NOUT];
#pragma unroll
  for (int o = 0; o < NOUT; ++o) zero_acc3<BN, WARPS_N>(acc[o]);

  // each thread stages one 8-column vector of the A chunk in every
  // kRowStep-th row; a row's upsample remap or image position once a block
  constexpr int kVecs = BK3 / 8;
  constexpr int kRowStep = kThreads / kVecs;
  constexpr int kRows = BM / kRowStep;
  const int kc = (threadIdx.x % kVecs) * 8;
  const int r0 = threadIdx.x / kVecs;
  long long src_up[kRows], vrow[kRows];
  int yy[kRows], xx[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long m = m0 + r0 + i * kRowStep;
    src_up[i] = src.up ? up_row(m, src.H, src.W) : m;
    // the offset of row m's BN tile in the prologue vectors (a conv tap's
    // source pixel lies in m's image, so in m's tile)
    vrow[i] = ops.o[0].vstride ? m / ops.o[0].tile_rows * ops.o[0].vstride
                               : 0;
    const int pix = CONV ? (int)(m % ((long long)src.H * src.W)) : 0;
    yy[i] = CONV ? pix / src.W : 0;
    xx[i] = CONV ? pix - yy[i] * src.W : 0;
  }

  // The single form also fetches the W chunk and the prologue vectors
  // with x, a chunk ahead (the dual form has no registers to spare).
  constexpr bool kAhead = NOUT == 1;
  constexpr int kWVecs = BK3 * BN / 8;
  constexpr int kWPer = (kWVecs + kThreads - 1) / kThreads;
  float xr[kRows][8];
  bool xok[kRows];
  float wr[kAhead ? kWPer : 1][8];
  float pa[8], pb[8];
  // W chunk vector c (row c / (BN/8), 8 columns) of output q: zero past K
  // and N
  const auto load_w = [&](const Op3& op, int k0, int c, float (&v)[8]) {
    const int kk = k0 + c / (BN / 8), n = n0 + (c % (BN / 8)) * 8;
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = 0.f;
    if (c < kWVecs && kk < K && n < N) {
      const float* wp = op.w + (long long)kk * op.ldw + n;
      if (op.wvec && n + 8 <= N) {
        load8f(wp, true, v);
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t)
          if (n + t < N) v[t] = wp[t];
      }
    }
  };
  // chunk k0's x vectors into registers (zero where the row or the column
  // is out of range, or the conv tap leaves the image); with kAhead its W
  // vectors and prologue vectors too
  const auto fetch = [&](int k0) {
    const int k = k0 + kc;
    const float* col = nullptr;
    long long ld = 0;
    bool upg = false;
    int dy = 0, dx = 0;
    if (k < K) {
      if (CONV) {
        const int tap = k / src.C;
        col = src.ptr[0] + (k - tap * src.C);
        ld = src.ld[0];
        dy = tap / 3 - 1;
        dx = tap % 3 - 1;
      } else {
        const GroupRef<float> grp = find_group<EXT, float>(src, k);
        col = grp.col;
        ld = grp.ld;
        upg = grp.up;
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long m = m0 + r0 + i * kRowStep;
      bool ok = col != nullptr && m < M;
      long long row = m;
      if (CONV) {
        const int sy = yy[i] + dy, sx = xx[i] + dx;
        ok = ok && sy >= 0 && sy < src.H && sx >= 0 && sx < src.W;
        row = m + dy * src.W + dx;
      } else if (upg) {
        row = src_up[i];
      }
      xok[i] = ok;
      if (ok) {
        load8f(col + row * ld, true, xr[i]);
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t) xr[i][t] = 0.f;
      }
    }
    if constexpr (kAhead) {
#pragma unroll
      for (int t = 0; t < kWPer; ++t)
        load_w(ops.o[0], k0, threadIdx.x + t * kThreads, wr[t]);
      if (!row_vecs && ops.o[0].inv && k < K) {
        load8f(ops.o[0].inv + k, false, pa);
        load8f(ops.o[0].shift + k, false, pb);
      }
    }
  };
  // the fetched chunk's prologue and A planes, and the W chunk's planes
  const auto commit = [&](int k0) {
    const int k = k0 + kc;
    // the prologue's column: k, or a conv tap's channel
    const int pc = CONV ? k - k / src.C * src.C : k;
#pragma unroll
    for (int q = 0; q < NOUT; ++q) {
      const Op3& op = ops.o[q];
      const bool pro = op.inv != nullptr && k < K;
      if (!kAhead && pro && !row_vecs) {
        load8f(op.inv + k, false, pa);
        load8f(op.shift + k, false, pb);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = r0 + i * kRowStep;
        if (pro && row_vecs && xok[i]) {
          load8f(op.inv + vrow[i] + pc, false, pa);
          load8f(op.shift + vrow[i] + pc, false, pb);
        }
        float v[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          v[t] = !xok[i] ? 0.f
                 : pro   ? fmaxf(affine(xr[i][t], pa[t], pb[t]), 0.f)
                         : xr[i][t];
          if constexpr (QUANT) v[t] = pro ? quan(v[t], qc) : v[t];
        }
        bf16* p = A + q * 3 * S::A_PLANE + r * S::AS + kc;
        if (QUANT && one)
          store_plane1(v, p);
        else
          store_planes(v, p, p + S::A_PLANE, p + 2 * S::A_PLANE);
      }
#pragma unroll
      for (int t = 0; t < kWPer; ++t) {
        const int c = threadIdx.x + t * kThreads;
        if (c >= kWVecs) break;
        float v[8];
        if constexpr (kAhead) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = wr[t][e];
        } else {
          load_w(op, k0, c, v);
        }
        bf16* p = B + q * 3 * S::B_PLANE + (c / (BN / 8)) * S::BS +
                  (c % (BN / 8)) * 8;
        store_planes(v, p, p + S::B_PLANE, p + 2 * S::B_PLANE);
      }
    }
  };

  // this block's chunks: all of K, or its split's share
  const int nchunk = (K + BK3 - 1) / BK3;
  const int k_beg = (int)blockIdx.z * nchunk / sp.n * BK3;
  const int k_end = ((int)blockIdx.z + 1) * nchunk / sp.n * BK3;
  fetch(k_beg);
  for (int k0 = k_beg; k0 < k_end; k0 += BK3) {
    commit(k0);
    __syncthreads();
    if (k0 + BK3 < k_end) fetch(k0 + BK3);
#pragma unroll
    for (int q = 0; q < NOUT; ++q) {
      const bf16* a = A + q * 3 * S::A_PLANE;
      const bf16* b = B + q * 3 * S::B_PLANE;
      Acc3<BN, WARPS_N> part;
      zero_acc3<BN, WARPS_N>(part);
      if constexpr (QUANT) {
        if (one)
          chunk_products<BN, WARPS_N, 1, wmma::row_major>(
              a, S::A_PLANE, wm * T::WM * S::AS, S::AS, 1, S::AS, b,
              S::B_PLANE, S::BS, wn, part);
        else
          chunk_products<BN, WARPS_N, 3, wmma::row_major>(
              a, S::A_PLANE, wm * T::WM * S::AS, S::AS, 1, S::AS, b,
              S::B_PLANE, S::BS, wn, part);
      } else {
        chunk_products<BN, WARPS_N, 3, wmma::row_major>(
            a, S::A_PLANE, wm * T::WM * S::AS, S::AS, 1, S::AS, b,
            S::B_PLANE, S::BS, wn, part);
      }
      add_acc3<BN, WARPS_N>(acc[q], part);
    }
    __syncthreads();
  }
  if constexpr (CONV) {
    if (sp.n == 1) {
      store_out3<BN, WARPS_N, EPI>(stage, wm, wn, m0, n0, M, N, ops.o[0],
                                   acc[0]);
      return;
    }
    Op3 partial = ops.o[0];
    partial.out = OutViewOf<float>{sp.part + (long long)blockIdx.z * M * N,
                                   N, M, 0};
    partial.ovec = N % 4 == 0;
    store_out3<BN, WARPS_N, kEpiNone>(stage, wm, wn, m0, n0, M, N, partial,
                                      acc[0]);
    __threadfence();
    __syncthreads();
    __shared__ int last;
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (threadIdx.x == 0)
      last = atomicAdd(sp.counters + tile, 1) == sp.n - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    reduce_split<BN, EPI>(sp, m0, n0, M, N, ops.o[0]);
    return;
  }
  if constexpr (POOL)
    store_pooled3<BN, WARPS_N, EPI>(reinterpret_cast<float*>(smem), stage,
                                    wm, wn, m0, n0, M, N, src.W, ops.o[0],
                                    acc[0]);
  else
    store_out3<BN, WARPS_N, EPI>(stage, wm, wn, m0, n0, M, N, ops.o[0],
                                 acc[0]);
  if (NOUT == 2)
    store_out3<BN, WARPS_N, kEpiNone>(stage, wm, wn, m0, n0, M, N, ops.o[1],
                                      acc[NOUT - 1]);
}

// ---------------------------------------------------------------------------
// dw3_kernel: the float32 weight gradients of the slot train step's 1x1
// stages and 3x3 conv (train_ops.affine_dw / conv3x3_dw at float32), a
// reduction over the M rows:
//   part[s, r, n] = sum over split s's rows m of z(m, r) * dy[m, n]
// with z(m, r) = relu(x[src, c] * inv_t[c] + shift_t[c]) of the stage input
// x, t = m / tile_rows m's ghost-BN tile; 1x1 (R = C rows): c = r, src = m;
// 3x3 (R = 9C, tap-major): tap = r / C, c = r % C, src = m + dy*W + dx, zero
// where the tap leaves m's image (the SAME padding of the activation).
// train_ops.sum_rows adds the splits' partials in order, so two calls give
// the same bits. It replaces, at float32, _dot_dw (cunet_tpu/kernels/
// train_slot.py:549) and the dW3 half of _conv3x3_bwd (:732), which JAX
// runs as float32 x float32 products at compute_dtype="float32".
//
// dot3_kernel's arithmetic over the other axis: the product's depth is M.
// A block owns 128 output rows by BN columns and one split of M, walked in
// chunks of BK3 rows: each thread loads two 8-row vectors of x (16-byte
// loads along the channels) and applies the prologue in registers, and up
// to two 8-column vectors of dy, a chunk ahead; commit splits both into
// three bf16 planes, z's stored depth-major (the A tile of the product
// transposed, read by WMMA as column-major: no transpose in memory), and 8
// warps take the six plane products a k16 step in dot3_kernel's order.
// ---------------------------------------------------------------------------
template <int BN>
struct SmemDw {
  static constexpr int AS = BM + kPad;        // z plane row (a depth row)
  static constexpr int BS = BN + kPad;
  static constexpr int A_PLANE = BK3 * AS;    // elements
  static constexpr int B_PLANE = BK3 * BS;
  static constexpr int A_BYTES = 3 * A_PLANE * 2;
  static constexpr int RAW = (A_BYTES + 3 * B_PLANE * 2 + 127) / 128 * 128;
  static constexpr int kBytes = RAW + kWarps * 256 * 4;
};

// The stage input of a weight gradient, its per-tile BN vectors (16-byte
// aligned rows: vstride and C multiples of 4), the conv's images, and
// QuanInput's bits on z (0: none; 1-9 one bf16 plane, as in dot3_kernel).
struct DwSrc {
  const float* x;
  long long ldx;
  const float* inv;
  const float* shift;
  long long vstride;
  long long tile_rows;
  int C;
  int H, W;
  int bits;
};

template <int BN, int WARPS_N, bool CONV, bool QUANT>
__global__ void __launch_bounds__(kThreads)
    dw3_kernel(const __grid_constant__ DwSrc s, long long M, int R,
               const float* __restrict__ dy, long long ldd, int N, int dvec,
               float* __restrict__ part, int nsplit) {
  using T = Tiles<BN, WARPS_N>;
  using S = SmemDw<BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* const A = reinterpret_cast<bf16*>(smem);
  bf16* const B = reinterpret_cast<bf16*>(smem + S::A_BYTES);
  float* const stage = reinterpret_cast<float*>(smem + S::RAW);
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int r0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  Acc3<BN, WARPS_N> acc;
  zero_acc3<BN, WARPS_N>(acc);

  // z: this thread's 8 output rows rr .. rr + 7 (one channel vector of one
  // tap) at depth rows kl + j * kAStep of each chunk
  constexpr int kRV = BM / 8;
  constexpr int kAStep = kThreads / kRV;
  constexpr int kAV = BK3 / kAStep;
  constexpr int kBVecs = BK3 * BN / 8;
  constexpr int kBV = (kBVecs + kThreads - 1) / kThreads;
  const int rr = (threadIdx.x % kRV) * 8, kl = threadIdx.x / kRV;
  const int r = r0 + rr;
  const bool rok = r < R;
  const int tap = CONV ? r / s.C : 0;
  const int c = CONV ? r - tap * s.C : r;
  const int ty = tap / 3 - 1, tx = tap % 3 - 1;
  const QuanConst qc = quan_const(QUANT ? s.bits : 0);   // z's quantizer
  const bool one = QUANT && s.bits >= 1 && s.bits <= 9;
  float ar[kAV][8], br[kBV][8];

  const auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kAV; ++j) {
      const long long m = k0 + kl + j * kAStep;
      bool ok = rok && m < M;
      long long src = m;
      if (CONV && ok) {
        const int pix = (int)(m % ((long long)s.H * s.W));
        const int sy = pix / s.W + ty, sx = pix % s.W + tx;
        ok = sy >= 0 && sy < s.H && sx >= 0 && sx < s.W;
        src = m + ty * s.W + tx;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) ar[j][e] = 0.f;
      if (ok) {
        float v[8], a[8], b[8];
        const long long o = m / s.tile_rows * s.vstride + c;
        load8f(s.x + src * s.ldx + c, true, v);
        load8f(s.inv + o, true, a);
        load8f(s.shift + o, true, b);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          ar[j][e] = fmaxf(affine(v[e], a[e], b[e]), 0.f);
          if constexpr (QUANT) ar[j][e] = quan(ar[j][e], qc);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kBV; ++t) {
      const int q = threadIdx.x + t * kThreads;
      const long long m = k0 + q / (BN / 8);
      const int n = n0 + (q % (BN / 8)) * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) br[t][e] = 0.f;
      if (q < kBVecs && m < M && n < N) {
        const float* p = dy + m * ldd + n;
        if (dvec && n + 8 <= N) {
          load8f(p, true, br[t]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (n + e < N) br[t][e] = p[e];
        }
      }
    }
  };
  const auto commit = [&]() {
#pragma unroll
    for (int j = 0; j < kAV; ++j) {
      bf16* p = A + (kl + j * kAStep) * S::AS + rr;
      if (QUANT && one)
        store_plane1(ar[j], p);
      else
        store_planes(ar[j], p, p + S::A_PLANE, p + 2 * S::A_PLANE);
    }
#pragma unroll
    for (int t = 0; t < kBV; ++t) {
      const int q = threadIdx.x + t * kThreads;
      if (q >= kBVecs) break;
      bf16* p = B + (q / (BN / 8)) * S::BS + (q % (BN / 8)) * 8;
      store_planes(br[t], p, p + S::B_PLANE, p + 2 * S::B_PLANE);
    }
  };

  const long long nchunk = (M + BK3 - 1) / BK3;
  const long long k_beg = blockIdx.z * nchunk / nsplit * BK3;
  const long long k_end = (blockIdx.z + 1) * nchunk / nsplit * BK3;
  if (k_beg < k_end) fetch((int)k_beg);
  for (long long k0 = k_beg; k0 < k_end; k0 += BK3) {
    commit();
    __syncthreads();
    if (k0 + BK3 < k_end) fetch((int)(k0 + BK3));
    Acc3<BN, WARPS_N> part;      // the chunk's sums (add_acc3)
    zero_acc3<BN, WARPS_N>(part);
    if constexpr (QUANT) {
      if (one)
        chunk_products<BN, WARPS_N, 1, wmma::col_major>(
            A, S::A_PLANE, wm * T::WM, 1, S::AS, S::AS, B, S::B_PLANE, S::BS,
            wn, part);
      else
        chunk_products<BN, WARPS_N, 3, wmma::col_major>(
            A, S::A_PLANE, wm * T::WM, 1, S::AS, S::AS, B, S::B_PLANE, S::BS,
            wn, part);
    } else {
      chunk_products<BN, WARPS_N, 3, wmma::col_major>(
          A, S::A_PLANE, wm * T::WM, 1, S::AS, S::AS, B, S::B_PLANE, S::BS, wn,
          part);
    }
    add_acc3<BN, WARPS_N>(acc, part);
    __syncthreads();
  }
  Op3 op = {};
  op.out = OutViewOf<float>{part + (long long)blockIdx.z * R * N, N, R, 0};
  op.ovec = N % 4 == 0;
  store_out3<BN, WARPS_N, kEpiNone>(stage, wm, wn, r0, n0, R, N, op, acc);
}

template <int BN, int WARPS_N, bool CONV, bool QUANT>
int launch_dw3(const DwSrc& s, long long M, int R, const float* dy,
               long long ldd, int N, float* part, int splits, int smem,
               cudaStream_t st) {
  constexpr int bytes = SmemDw<BN>::kBytes;
  if (smem != bytes) return (int)cudaErrorInvalidValue;
  auto kern = dw3_kernel<BN, WARPS_N, CONV, QUANT>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((R + BM - 1) / BM), (unsigned)((N + BN - 1) / BN),
                  (unsigned)splits);
  const int dvec = ldd % 4 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  kern<<<grid, kThreads, bytes, st>>>(s, M, R, dy, ldd, N, dvec, part,
                                      splits);
  return (int)cudaGetLastError();
}

template <bool CONV, bool QUANT>
int dw3_forms(const DwSrc& s, long long M, int R, const float* dy,
              long long ldd, int N, float* part, int bn, int splits, int smem,
              cudaStream_t st) {
  switch (bn) {
    case 16:
      return launch_dw3<16, 1, CONV, QUANT>(s, M, R, dy, ldd, N, part,
                                            splits, smem, st);
    case 32:
      return launch_dw3<32, 2, CONV, QUANT>(s, M, R, dy, ldd, N, part,
                                            splits, smem, st);
    case 64:
      return launch_dw3<64, 2, CONV, QUANT>(s, M, R, dy, ldd, N, part,
                                            splits, smem, st);
    case 128:
      return launch_dw3<128, 2, CONV, QUANT>(s, M, R, dy, ldd, N, part,
                                             splits, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}

// One instance: its dynamic shared memory raised past 48 KB once, then the
// launch. ``smem`` is the plan's (buf_ops.dot3_plan); a plan that disagrees
// with the kernel's layout is refused.
template <int BN, int WARPS_N, int NOUT, bool POOL, int EPI, bool CONV,
          bool EXT = false, bool QUANT = false>
int launch3(const Src& src, long long M, int N, const Ops3& ops, int smem,
            cudaStream_t st, Split sp = Split{nullptr, nullptr, 1}) {
  constexpr int bytes = Smem3<BN, NOUT, POOL>::kBytes;
  if (smem != bytes) return (int)cudaErrorInvalidValue;
  auto kern = dot3_kernel<BN, WARPS_N, NOUT, POOL, EPI, CONV, EXT, QUANT>;
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN),
                  (unsigned)sp.n);
  if (sp.n > 1) {
    const cudaError_t e = cudaMemsetAsync(
        sp.counters, 0, sizeof(int) * grid.x * grid.y, st);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, kThreads, bytes, st>>>(src, M, N, ops, sp);
  return (int)cudaGetLastError();
}

// table_dot's forms at one column tile width: the dual form has no
// epilogue (the wrapper checks); the single form takes each, pooled or not.
template <int BN, int WARPS_N, bool EXT>
int launch_epis(const Src& src, long long M, int N, const Ops3& ops,
                int nout, int pool, int epi, int smem, cudaStream_t st) {
  if (nout == 2)
    return pool ? launch3<BN, WARPS_N, 2, true, kEpiNone, false, EXT>(
                      src, M, N, ops, smem, st)
                : launch3<BN, WARPS_N, 2, false, kEpiNone, false, EXT>(
                      src, M, N, ops, smem, st);
  if (pool) {
    if (epi == kEpiShift)
      return launch3<BN, WARPS_N, 1, true, kEpiShift, false, EXT>(
          src, M, N, ops, smem, st);
    if (epi == kEpiScale)
      return launch3<BN, WARPS_N, 1, true, kEpiScale, false, EXT>(
          src, M, N, ops, smem, st);
    return launch3<BN, WARPS_N, 1, true, kEpiNone, false, EXT>(
        src, M, N, ops, smem, st);
  }
  if (epi == kEpiShift)
    return launch3<BN, WARPS_N, 1, false, kEpiShift, false, EXT>(
        src, M, N, ops, smem, st);
  if (epi == kEpiScale)
    return launch3<BN, WARPS_N, 1, false, kEpiScale, false, EXT>(
        src, M, N, ops, smem, st);
  return launch3<BN, WARPS_N, 1, false, kEpiNone, false, EXT>(
      src, M, N, ops, smem, st);
}

// table_dot's forms at one column tile width, the table by value or (past
// kMaxGroups groups) in device memory.
template <int BN, int WARPS_N>
int launch_forms(const Src& src, long long M, int N, const Ops3& ops,
                 int nout, int pool, int epi, int smem, cudaStream_t st) {
  return src.ext ? launch_epis<BN, WARPS_N, true>(src, M, N, ops, nout, pool,
                                                  epi, smem, st)
                 : launch_epis<BN, WARPS_N, false>(src, M, N, ops, nout,
                                                   pool, epi, smem, st);
}

Op3 make_op(const void* inv, const void* shift, const void* w, int ldw,
            void* out, long long ldo, long long rows_per_img,
            long long img_stride) {
  Op3 op;
  op.inv = static_cast<const float*>(inv);
  op.shift = static_cast<const float*>(shift);
  op.w = static_cast<const float*>(w);
  op.ldw = ldw;
  op.wvec = ldw % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  op.ea = op.eb = nullptr;
  op.out = OutViewOf<float>{static_cast<float*>(out), ldo, rows_per_img,
                            img_stride};
  op.ovec = ldo % 4 == 0 && img_stride % 4 == 0 &&
            reinterpret_cast<uintptr_t>(out) % 16 == 0;
  op.vstride = 0;
  op.tile_rows = 1;
  op.gx = nullptr;
  op.ldgx = 0;
  op.bits = 0;
  return op;
}

// The per-tile vectors of a train stage's prologue, or (gx given) its
// backward's gate epilogue: ea / eb its BN vectors and no prologue; the
// prologue's QuanInput bits.
void set_train(Op3& op, long long vstride, long long tile_rows,
               const void* gx, long long ldgx, const void* gate_inv,
               const void* gate_shift, int bits) {
  op.vstride = vstride;
  op.tile_rows = tile_rows;
  op.bits = bits;
  op.gx = static_cast<const float*>(gx);
  op.ldgx = ldgx;
  if (gx) {
    op.ea = static_cast<const float*>(gate_inv);
    op.eb = static_cast<const float*>(gate_shift);
  }
}

}  // namespace

extern "C" {

// The float32 form of cunet_table_dot (eval_kernels.cu), with the same
// arguments, plus the plan's column tile ``bn`` (16, 32, 64 or 128) and
// dynamic shared memory ``smem`` (kernels/buf_ops.py::dot3_plan). Every
// pointer is to float32. affine_dot's float32 form calls it with one group.
int cunet_table_dot_f32(const void* const* feats, const long long* lds,
                        const int* widths, int G, const int* ups, void* ext,
                        int H, int W,
                        long long M, const void* inv_a, const void* shift_a,
                        const void* w_a, const void* inv_s,
                        const void* shift_s, const void* w_s, int ldw, int N,
                        int epi, const void* epi_a, const void* epi_b,
                        int pool, void* out_a, long long ldo_a,
                        long long rows_per_img_a, long long img_stride_a,
                        void* out_s, long long ldo_s, int bn, int smem,
                        void* stream) {
  if (epi < kEpiNone || epi > kEpiScale || (out_s && epi != kEpiNone))
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  Src src;
  const cudaError_t e =
      set_groups<float>(src, feats, lds, widths, ups, G, ext, st);
  if (e != cudaSuccess) return (int)e;
  src.H = H;
  src.W = W;
  src.C = 0;
  Ops3 ops;
  ops.o[0] = make_op(inv_a, shift_a, w_a, ldw, out_a, ldo_a, rows_per_img_a,
                     img_stride_a);
  ops.o[0].ea = static_cast<const float*>(epi_a);
  ops.o[0].eb = static_cast<const float*>(epi_b);
  const int nout = out_s ? 2 : 1;
  ops.o[1] = out_s ? make_op(inv_s, shift_s, w_s, ldw, out_s, ldo_s, M, 0)
                   : ops.o[0];
  switch (bn) {
    case 16:
      return launch_forms<16, 1>(src, M, N, ops, nout, pool, epi, smem, st);
    case 32:
      return launch_forms<32, 2>(src, M, N, ops, nout, pool, epi, smem, st);
    case 64:
      return launch_forms<64, 2>(src, M, N, ops, nout, pool, epi, smem, st);
    case 128:
      return launch_forms<128, 2>(src, M, N, ops, nout, pool, epi, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The float32 form of cunet_conv3x3 (buf_kernels.cu): y (M, C) at row
// stride ldy, images H x W, the packed (9C, G) weight, out (M, G) at row
// stride ldo; ``bn``, ``smem`` and the K split ``splits`` from the plan;
// with splits > 1 ``part`` is this launch's own buffer: (splits, M, G)
// float32 partials, then one int per output tile, which this call zeroes on
// the stream. ``inv`` / ``shift`` (null: none, the eval conv) are the BN2
// prologue's per-tile vectors (vstride, tile_rows as in Op3): the ghost-BN
// train forward. With ``gx`` (conv3x3_dx's float32 form: y the cotangent,
// w its flipped, transposed weight) the output is gated by relu(gx *
// gate_inv + gate_shift) > 0 of the conv input gx (M, G) at row stride ldgx.
// bits: QuanInput's quantizer after the BN2 prologue; ste: the gate also
// closes where that affine is >= 1.
int cunet_conv3x3_f32(const void* y, long long ldy, long long M, int H, int W,
                      int C, const void* w, int G, const void* inv,
                      const void* shift, long long vstride,
                      long long tile_rows, const void* gx, long long ldgx,
                      const void* gate_inv, const void* gate_shift, void* out,
                      long long ldo, int bits, int ste, int bn, int smem,
                      int splits, void* part, void* stream) {
  if (C < 8 || C % 8 || splits < 1 || (splits > 1 && !part) ||
      (gx && inv) || tile_rows < 1 || (bits && !inv) || (ste && !gx))
    return (int)cudaErrorInvalidValue;
  float* const partials = static_cast<float*>(part);
  const Split sp{partials,
                 splits > 1 ? reinterpret_cast<int*>(partials + splits * M * G)
                            : nullptr,
                 splits};
  Src src;
  src.G = 1;
  src.K = 9 * C;
  src.up = 0;
  src.H = H;
  src.W = W;
  src.C = C;
  src.ext = nullptr;
  src.ptr[0] = static_cast<const float*>(y);
  src.ld[0] = ldy;
  src.off[0] = 0;
  src.off[1] = 9 * C;
  Ops3 ops;
  ops.o[0] = make_op(inv, shift, w, G, out, ldo, M, 0);
  set_train(ops.o[0], vstride, tile_rows, gx, ldgx, gate_inv, gate_shift,
            bits);
  ops.o[1] = ops.o[0];
  const auto st = static_cast<cudaStream_t>(stream);
  switch (bn) {
#define CUNET_CONV3(b, wn)                                                  \
  case b:                                                                   \
    if (gx)                                                                 \
      return ste ? launch3<b, wn, 1, false, kEpiGateSte, true>(             \
                       src, M, G, ops, smem, st, sp)                        \
                 : launch3<b, wn, 1, false, kEpiGate, true>(                \
                       src, M, G, ops, smem, st, sp);                       \
    return bits ? launch3<b, wn, 1, false, kEpiNone, true, false, true>(    \
                      src, M, G, ops, smem, st, sp)                         \
                : launch3<b, wn, 1, false, kEpiNone, true>(src, M, G, ops,  \
                                                           smem, st, sp);
    CUNET_CONV3(16, 1) CUNET_CONV3(32, 2) CUNET_CONV3(64, 2)
    CUNET_CONV3(128, 2)
#undef CUNET_CONV3
  }
  return (int)cudaErrorInvalidValue;
}

// The float32 1x1 stage of the ghost-BN train step, one feature group:
// out (M, N) = relu(x * inv_t + shift_t) @ w[:K] (affine_dot's float32
// form with per-tile vectors, vstride and tile_rows as in Op3), or, with
// ``gx`` and no ``inv`` (affine_dx's float32 form: x the cotangent, w the
// transposed weight), x @ w[:K] gated by relu(gx * gate_inv_t +
// gate_shift_t) > 0 of the stage input gx (M, N). ``bn`` and ``smem`` from
// buf_ops.dot3_plan; out an (M, N) view or an image-major one as in
// cunet_table_dot_f32. bits: QuanInput's quantizer after the prologue (the
// quantized model's head); ste: the gate also closes where its affine is
// >= 1.
int cunet_affine_f32(const void* x, long long ldx, long long M, int K,
                     const void* inv, const void* shift, long long vstride,
                     long long tile_rows, const void* w, int ldw, int N,
                     const void* gx, long long ldgx, const void* gate_inv,
                     const void* gate_shift, void* out, long long ldo,
                     long long rows_per_img, long long img_stride, int bits,
                     int ste, int bn, int smem, void* stream) {
  if ((gx && inv) || tile_rows < 1 || (bits && !inv) || (ste && !gx))
    return (int)cudaErrorInvalidValue;
  Src src;
  src.G = 1;
  src.K = K;
  src.up = 0;
  src.H = src.W = 0;
  src.C = 0;
  src.ext = nullptr;
  src.off[0] = 0;
  for (int g = 0; g < kMaxGroups; ++g) {
    src.ptr[g] = g ? nullptr : static_cast<const float*>(x);
    src.ld[g] = g ? 0 : ldx;
    src.off[g + 1] = K;
  }
  Ops3 ops;
  ops.o[0] = make_op(inv, shift, w, ldw, out, ldo, rows_per_img, img_stride);
  set_train(ops.o[0], vstride, tile_rows, gx, ldgx, gate_inv, gate_shift,
            bits);
  ops.o[1] = ops.o[0];
  const auto st = static_cast<cudaStream_t>(stream);
  switch (bn) {
#define CUNET_AFFINE3(b, wn)                                                \
  case b:                                                                   \
    if (gx)                                                                 \
      return ste ? launch3<b, wn, 1, false, kEpiGateSte, false>(            \
                       src, M, N, ops, smem, st)                            \
                 : launch3<b, wn, 1, false, kEpiGate, false>(               \
                       src, M, N, ops, smem, st);                           \
    return bits ? launch3<b, wn, 1, false, kEpiNone, false, false, true>(   \
                      src, M, N, ops, smem, st)                             \
                : launch3<b, wn, 1, false, kEpiNone, false>(src, M, N, ops, \
                                                            smem, st);
    CUNET_AFFINE3(16, 1) CUNET_AFFINE3(32, 2) CUNET_AFFINE3(64, 2)
    CUNET_AFFINE3(128, 2)
#undef CUNET_AFFINE3
  }
  return (int)cudaErrorInvalidValue;
}

// The float32 weight gradients (dw3_kernel): x (M, C) at row stride ldx,
// its per-tile vectors, dy (M, N) at row stride ldd; conv 0: the 1x1
// stage's (C, N) gradient, conv 1: the 3x3 conv's packed (9C, N) one over
// images H x W; bits: QuanInput's quantizer on z. Writes ``splits``
// float32 partials (splits, R, N) to ``part``; ``bn``, ``smem`` and
// ``splits`` from train_ops.dw3_plan.
int cunet_dw_f32(const void* x, long long ldx, long long M, int C, int H,
                 int W, int conv, const void* inv, const void* shift,
                 long long vstride, long long tile_rows, const void* dy,
                 long long ldd, int N, void* part, int bits, int bn, int smem,
                 int splits, void* stream) {
  if (C % 8 || vstride % 4 || tile_rows < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  DwSrc s;
  s.x = static_cast<const float*>(x);
  s.ldx = ldx;
  s.inv = static_cast<const float*>(inv);
  s.shift = static_cast<const float*>(shift);
  s.vstride = vstride;
  s.tile_rows = tile_rows;
  s.C = C;
  s.H = H;
  s.W = W;
  s.bits = bits;
  const auto* d = static_cast<const float*>(dy);
  auto* pp = static_cast<float*>(part);
  const auto st = static_cast<cudaStream_t>(stream);
  if (bits)
    return conv ? dw3_forms<true, true>(s, M, 9 * C, d, ldd, N, pp, bn,
                                        splits, smem, st)
                : dw3_forms<false, true>(s, M, C, d, ldd, N, pp, bn, splits,
                                         smem, st);
  return conv ? dw3_forms<true, false>(s, M, 9 * C, d, ldd, N, pp, bn, splits,
                                       smem, st)
              : dw3_forms<false, false>(s, M, C, d, ldd, N, pp, bn, splits,
                                        smem, st);
}

}  // extern "C"
