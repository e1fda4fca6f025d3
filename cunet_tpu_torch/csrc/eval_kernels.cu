// Hand-written Hopper kernel of the eval-mode concat-free product over a
// feature table (cunet_tpu_torch/kernels/eval_ops.py wraps it):
//
//   out_a[m, n] = epi( sum_k bf16(relu(x[m,k]*inv_a[k] + shift_a[k])) W_a[k, n] )
//   out_s[m, n] =      sum_k bf16(relu(x[m,k]*inv_s[k] + shift_s[k])) W_s[k, n]
//
// where x is the virtual concat of G <= 16 separate bf16 (M, C_g) tensors,
// the affine is float32, the product bf16 with float32 accumulators, and each
// output is rounded to bf16 once. epi is the identity, relu(. + b[n]) (the
// bottleneck's BN2 with its scale folded into W_a: "shift2") or
// relu(. * a[n] + b[n]) (BN2's full affine: "scale"). The second output is
// optional (the dual form: a down block's ahead and skip adapters from one
// read of x). Two options fold the hourglass's resampling into the product:
//   up:   a group flagged half-resolution is read through a 2x nearest
//         upsample: output row m = (b*H + y)*W + x reads its row
//         (b*(H/2) + y/2)*(W/2) + x/2 (an up block's first feature);
//   pool: out_a is stored 2x2-max-pooled, (M/4, N): the 128-row block tile
//         holds whole 2x2 windows when 2W divides it; the tile is rounded to
//         bf16 in shared memory and each window's max written once (a down
//         block's ahead output). out_s stays at full resolution.
//
// It is the Hopper counterpart of three TPU kernels:
//   cunet_tpu/kernels/fused_bottleneck.py::fused_bottleneck_infer (:76) and
//   fused_dual_bottleneck_infer (:178), TPU kernel #6;
//   every 1x1 stage of cunet_tpu/kernels/fused_hourglass.py::
//   fused_hourglass_infer (:447, _bottleneck_val :229), TPU kernel #4;
//   every 1x1 stage of cunet_tpu/kernels/fused_block.py::
//   fused_dense_block_infer (:207), TPU kernel #5, with its BN2 affine
//   (:148), its upsample_first (:128-132) and its pool_ahead (:178-183).
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
// Design: the first, WMMA design of affine_dot (which has since moved to
// persistent mma.sync blocks that sum in the same order, so the two
// kernels agree bit for bit): 128-row block tiles over the full N,
// the prologue in float32 registers between the 16-byte global load and the
// bf16 shared-memory tile, WMMA with float32 accumulators. The dual form
// builds both prologues from one load. The upsample remaps each thread's
// rows once per block, so the 16-byte loads stay as they are; the pooled
// store reuses the operand tiles' shared memory for the rounded output tile,
// so neither option moves a byte more than the product itself. N tails (the
// face head's 68 classes) and row tails are handled in the kernel: weights
// and outputs whose rows are not 16-byte aligned move element by element.
//
// The entry point launches on the stream it is given and returns
// cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int kMaxGroups = 16;

// The virtual concat: group g holds columns [off[g], off[g+1]); bit g of
// up marks a half-resolution group; H, W are the output images' rows and
// columns (read by the upsample remap and the pooled store).
struct FeatTable {
  const bf16* ptr[kMaxGroups];
  long long ld[kMaxGroups];
  int off[kMaxGroups + 1];
  int G;
  int up;
  int H, W;
};

// One output: its BN vectors, its weight (row stride ldw; wvec: 16-byte
// rows), its epilogue's vectors ea / eb and where it goes (ovec: 16-byte
// output rows).
struct Operand {
  const float* inv;
  const float* shift;
  const bf16* w;
  int ldw;
  int wvec;
  const float* ea;
  const float* eb;
  OutView out;
  int ovec;
};

struct Operands {
  Operand o[2];
};

template <int BN, int NOUT>
struct TableTiles {
  __align__(128) bf16 a[NOUT][BM][BK + kPad];
  __align__(128) bf16 b[NOUT][BK][BN + kPad];
};

// The operand tiles, and with POOL after the product in the same bytes the
// first output rounded to bf16 (the pooled store's source). Only the pooled
// form is sized for the output tile: the others keep the operand tiles'
// footprint, and so their occupancy.
template <int BN, int NOUT, bool POOL>
struct TableSmem {
  typedef unsigned short OutTile[BM][BN + kPad];
  static constexpr size_t kBytes =
      POOL && sizeof(OutTile) > sizeof(TableTiles<BN, NOUT>)
          ? sizeof(OutTile) : sizeof(TableTiles<BN, NOUT>);
  __align__(128) unsigned char raw[kBytes];
  __align__(128) float stage[kWarps][16 * 16];
  __device__ __forceinline__ TableTiles<BN, NOUT>& in() {
    return *reinterpret_cast<TableTiles<BN, NOUT>*>(raw);
  }
  __device__ __forceinline__ OutTile& out() {
    return *reinterpret_cast<OutTile*>(raw);
  }
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

// The epilogue of column n on a float32 accumulator, before the rounding:
// relu(v + b) as the plain version's add and ReLU; relu(v * a + b) with the
// product and the sum rounded apart, as its two elementwise ops round them.
template <int EPI>
__device__ __forceinline__ float epilogue(float v, const Operand& op, int n) {
  if (EPI == kEpiShift) return fmaxf(v + op.eb[n], 0.f);
  if (EPI == kEpiScale) return fmaxf(affine(v, op.ea[n], op.eb[n]), 0.f);
  return v;
}

// Accumulators -> bf16 output rows through a per-warp 16x16 float32 stage.
template <int BN, int WARPS_N, int EPI>
__device__ __forceinline__ void store_out(
    float (&stage)[kWarps][16 * 16], int wm, int wn, long long m0, int n0,
    long long M, int N, const Operand& op,
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
        for (int t = 0; t < 8; ++t)
          o.u[t] = hi(n + t < N
                          ? epilogue<EPI>(st[r * 16 + cc + t], op, n + t)
                          : 0.f);
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

// The pooled store: accumulators -> (epilogue, bf16) -> the block's output
// tile in shared memory, then the max of each 2x2 window to its row of the
// (M/4, N) output. The tile's 128 rows are BM / W whole image rows starting
// at an even one (the wrapper checks that 2W divides BM and H is even), so
// pooled row m0/4 + p reads tile rows 2(p / (W/2))W + 2(p % (W/2)) + {0, 1,
// W, W+1}. The max is taken of rounded values, in maxpool2's order, so the
// result is bit for bit maxpool2 of the unpooled output.
template <int BN, int WARPS_N, int NOUT, int EPI>
__device__ __forceinline__ void store_pooled(
    TableSmem<BN, NOUT, true>& s, int wm, int wn, long long m0, int n0,
    long long M, int N, int W, const Operand& op,
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (
        &acc)[Tiles<BN, WARPS_N>::FM][Tiles<BN, WARPS_N>::FN]) {
  using T = Tiles<BN, WARPS_N>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* st = s.stage[warp];
  const int r = lane / 2, cc = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < T::FM; ++i) {
#pragma unroll
    for (int j = 0; j < T::FN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = wm * T::WM + i * 16 + r;
      const int col = wn * T::WN + j * 16 + cc;
      Pack8 o;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int n = n0 + col + t;
        o.u[t] = hi(n < N ? epilogue<EPI>(st[r * 16 + cc + t], op, n) : 0.f);
      }
      *reinterpret_cast<uint4*>(&s.out()[row][col]) = o.v;
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
    const int t00 = (p / wo) * 2 * W + (p % wo) * 2;
    Pack8 o;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float v00 = __bfloat162float(
          __ushort_as_bfloat16(s.out()[t00][nc + t]));
      const float v01 = __bfloat162float(
          __ushort_as_bfloat16(s.out()[t00 + 1][nc + t]));
      const float v10 = __bfloat162float(
          __ushort_as_bfloat16(s.out()[t00 + W][nc + t]));
      const float v11 = __bfloat162float(
          __ushort_as_bfloat16(s.out()[t00 + W + 1][nc + t]));
      o.u[t] = hi(fmaxf(fmaxf(v00, v01), fmaxf(v10, v11)));
    }
    bf16* dst = out_row(op.out, mp) + n;
    if (op.ovec && n + 8 <= N) {
      *reinterpret_cast<uint4*>(dst) = o.v;
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t)
        if (n + t < N) dst[t] = __ushort_as_bfloat16(o.u[t]);
    }
  }
}

template <int BN, int WARPS_N, int NOUT, bool POOL, int EPI>
__global__ void __launch_bounds__(kThreads)
    table_dot_kernel(const __grid_constant__ FeatTable tbl, long long M,
                     int N, const __grid_constant__ Operands ops) {
  using T = Tiles<BN, WARPS_N>;
  __shared__ TableSmem<BN, NOUT, POOL> s;
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
  // kRowStep-th row: one group lookup per stage, one upsample remap of its
  // rows per block
  constexpr int kVecs = BK / 8;
  constexpr int kRowStep = kThreads / kVecs;
  constexpr int kRows = BM / kRowStep;
  const int kc = (threadIdx.x % kVecs) * 8;
  const int r0 = threadIdx.x / kVecs;
  long long src_up[kRows];
  if (tbl.up) {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      src_up[i] = up_row(m0 + r0 + i * kRowStep, tbl.H, tbl.W);
  }
  for (int k0 = 0; k0 < K; k0 += BK) {
    const int k = k0 + kc;
    const bf16* col = nullptr;
    long long ld = 0;
    bool upg = false;
    if (k < K) {
      int g = 0;
      while (g + 1 < tbl.G && k >= tbl.off[g + 1]) ++g;
      col = tbl.ptr[g] + (k - tbl.off[g]);
      ld = tbl.ld[g];
      upg = (tbl.up >> g) & 1;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + i * kRowStep;
      const long long m = m0 + r;
      Pack8 o[NOUT];
#pragma unroll
      for (int q = 0; q < NOUT; ++q) o[q].v = make_uint4(0u, 0u, 0u, 0u);
      if (col != nullptr && m < M) {
        Pack8 in;
        in.v = *reinterpret_cast<const uint4*>(col + (upg ? src_up[i] : m) *
                                                         ld);
#pragma unroll
        for (int q = 0; q < NOUT; ++q)
#pragma unroll
          for (int t = 0; t < 8; ++t)
            o[q].u[t] = act(lo(in, t), ops.o[q].inv[k + t],
                            ops.o[q].shift[k + t], 0);
      }
#pragma unroll
      for (int q = 0; q < NOUT; ++q)
        *reinterpret_cast<uint4*>(&s.in().a[q][r][kc]) = o[q].v;
    }
#pragma unroll
    for (int q = 0; q < NOUT; ++q)
      load_w<BN>(s.in().b[q], ops.o[q], k0, K, n0, N);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < NOUT; ++q)
      mma_tiles<BN, WARPS_N>(s.in().a[q], s.in().b[q], wm, wn, acc[q]);
    __syncthreads();
  }
  if constexpr (POOL)
    store_pooled<BN, WARPS_N, NOUT, EPI>(s, wm, wn, m0, n0, M, N, tbl.W,
                                         ops.o[0], acc[0]);
  else
    store_out<BN, WARPS_N, EPI>(s.stage, wm, wn, m0, n0, M, N, ops.o[0],
                                acc[0]);
  if (NOUT == 2)
    store_out<BN, WARPS_N, kEpiNone>(s.stage, wm, wn, m0, n0, M, N, ops.o[1],
                                     acc[NOUT - 1]);
}

template <int BN, int WARPS_N, int NOUT, bool POOL>
void launch_epi(const dim3& grid, const FeatTable& tbl, long long M, int N,
                const Operands& ops, int epi, cudaStream_t stream) {
  if (epi == kEpiShift)
    table_dot_kernel<BN, WARPS_N, NOUT, POOL, kEpiShift>
        <<<grid, kThreads, 0, stream>>>(tbl, M, N, ops);
  else if (epi == kEpiScale)
    table_dot_kernel<BN, WARPS_N, NOUT, POOL, kEpiScale>
        <<<grid, kThreads, 0, stream>>>(tbl, M, N, ops);
  else
    table_dot_kernel<BN, WARPS_N, NOUT, POOL, kEpiNone>
        <<<grid, kThreads, 0, stream>>>(tbl, M, N, ops);
}

// The dual form has no epilogue (the wrapper checks); the single form takes
// each, pooled or not.
template <int BN, int WARPS_N>
void launch_table_dot(const FeatTable& tbl, long long M, int N,
                      const Operands& ops, int nout, int pool, int epi,
                      cudaStream_t stream) {
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  if (nout == 2 && pool)
    table_dot_kernel<BN, WARPS_N, 2, true, kEpiNone>
        <<<grid, kThreads, 0, stream>>>(tbl, M, N, ops);
  else if (nout == 2)
    table_dot_kernel<BN, WARPS_N, 2, false, kEpiNone>
        <<<grid, kThreads, 0, stream>>>(tbl, M, N, ops);
  else if (pool)
    launch_epi<BN, WARPS_N, 1, true>(grid, tbl, M, N, ops, epi, stream);
  else
    launch_epi<BN, WARPS_N, 1, false>(grid, tbl, M, N, ops, epi, stream);
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
  op.ea = op.eb = nullptr;
  op.out = OutView{static_cast<bf16*>(out), ldo, rows_per_img, img_stride};
  op.ovec = ldo % 8 == 0 && img_stride % 8 == 0 &&
            reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return op;
}

}  // namespace

extern "C" {

// feats / lds / widths: the G groups (G <= 16); up: bit g flags group g
// half-resolution; H, W: the output images' size (M = B*H*W rows; read with
// up or pool). Output a is required; a null out_s selects the single form.
// epi (0 none, 1 shift, 2 scale; single form only) with the vectors epi_a
// (scale) and epi_b (shift) is output a's epilogue. pool stores output a
// 2x2-max-pooled, with M/4 rows. Both outputs share N and the weight stride.
// The wrapper (kernels/eval_ops.py) checks the shapes: even H and W with up
// or pool, and with pool whole 2x2 windows in the BM-row tile.
int cunet_table_dot(const void* const* feats, const long long* lds,
                    const int* widths, int G, int up, int H, int W,
                    long long M, const void* inv_a, const void* shift_a,
                    const void* w_a, const void* inv_s, const void* shift_s,
                    const void* w_s, int ldw, int N, int epi,
                    const void* epi_a, const void* epi_b, int pool,
                    void* out_a, long long ldo_a, long long rows_per_img_a,
                    long long img_stride_a, void* out_s, long long ldo_s,
                    void* stream) {
  if (G < 1 || G > kMaxGroups) return (int)cudaErrorInvalidValue;
  if (epi < kEpiNone || epi > kEpiScale || (out_s && epi != kEpiNone))
    return (int)cudaErrorInvalidValue;
  FeatTable tbl;
  tbl.G = G;
  tbl.up = up;
  tbl.H = H;
  tbl.W = W;
  tbl.off[0] = 0;
  for (int g = 0; g < kMaxGroups; ++g) {
    tbl.ptr[g] = g < G ? static_cast<const bf16*>(feats[g]) : nullptr;
    tbl.ld[g] = g < G ? lds[g] : 0;
    tbl.off[g + 1] = tbl.off[g] + (g < G ? widths[g] : 0);
  }
  Operands ops;
  ops.o[0] = make_operand(inv_a, shift_a, w_a, ldw, out_a, ldo_a,
                          rows_per_img_a, img_stride_a);
  ops.o[0].ea = static_cast<const float*>(epi_a);
  ops.o[0].eb = static_cast<const float*>(epi_b);
  const int nout = out_s ? 2 : 1;
  ops.o[1] = out_s ? make_operand(inv_s, shift_s, w_s, ldw, out_s, ldo_s, M, 0)
                   : ops.o[0];
  const auto st = static_cast<cudaStream_t>(stream);
  if (N <= 16)
    launch_table_dot<16, 1>(tbl, M, N, ops, nout, pool, epi, st);
  else if (N <= 32)
    launch_table_dot<32, 2>(tbl, M, N, ops, nout, pool, epi, st);
  else if (N <= 64)
    launch_table_dot<64, 2>(tbl, M, N, ops, nout, pool, epi, st);
  else
    launch_table_dot<128, 2>(tbl, M, N, ops, nout, pool, epi, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
