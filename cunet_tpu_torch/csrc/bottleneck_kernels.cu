// Hand-written Hopper kernels of the train-mode concat-free dense bottleneck
//   out = sum_k bf16(relu(bn_k(x_k))) @ bf16(W_k)    (BN with batch stats)
// and its recompute backward (cunet_tpu_torch/kernels/train_bottleneck.py
// wraps them and holds the autograd Function). With apply, the table form
// of buf_kernels.cu's affine_dot, they replace the four pallas_calls of
// cunet_tpu/kernels/train_bottleneck.py::fused_train_bottleneck:
//   tb_stats      <- _stats_kernel      (:49, called at :173)
//                    (float32: tb_stats_f32 + tb_stats_sum)
//   apply         <- _apply_kernel      (:66, called at :208)
//   tb_bwd_reduce <- _bwd_reduce_kernel (:92, called at :268)
//                    (float32: tb_split_g + tb_bwd_reduce_f32)
//   tb_bwd_dx     <- _bwd_dx_kernel     (:134, called at :296)
//                    (float32: tb_bwd_dx_f32 in tb_dx_f32_kernels.cu,
//                    on the planes tb_split_g wrote for the reduce)
//
// The features arrive as separate tensors (an up-block adapter reads
// [x, skip, fifo, out]): every kernel reads them through a feature table in
// device memory, one row of kTblCols int64 per group (halo.cuh),
//   [x pointer, x row stride, width, column offset in the concat,
//    dx pointer, dx row stride]
// and never builds the concat. cunet_tb_fill_table writes the table from
// the host's copy with launches whose parameters carry it by value (16
// groups each), so any group count works and a CUDA graph captures the table
// with the launch; the four kernels then read one filled table (the
// autograd Function fills one for the forward's two and one, with the dx
// columns, for the backward's two).
// Widths, offsets and row strides are multiples of 8 elements, pointers
// 16-byte aligned (the wrapper checks), so a column vector of 8 never
// straddles two groups.
//
// On a TPU the grid walks the rows in order and carries the reductions in
// VMEM. Here every reduction over rows (the statistics, dW, the two BN sums)
// writes per-block float32 partials that train_ops.sum_rows adds in a fixed
// order (the float32 statistics: float64 partials, a sum kernel of their
// own): no atomics, and two identical calls give identical bits.
//
// The backward's products keep the TPU kernel's float32 precision (dW =
// r^T g and g_r = g W^T with the unrounded f32 W): one TF32 or bf16
// tensor-core pass would move them by ~1e-3, outside the f32 bounds the
// port holds them to. Both backward kernels run them on the tensor cores
// through an exact three-way bf16 split of the f32 operand (three bf16
// passes: float32 sums of exact products), g W^T in the same order in both,
// so tb_bwd_dx gates the bits tb_bwd_reduce summed. The BN recompute rounds
// after every operation, in the plain version's order, so the ReLU gate is
// the same bit for bit.
//
// Each kernel takes bf16 features, or float32 ones (a model trained at
// compute_dtype="float32", as the JAX package runs #7 at the features'
// dtype). stats' float32 form (tb_stats_f32_kernel) reads 16-byte vectors
// of 4 columns and adds short float32 sums into float64, its chunk
// partials added by tb_stats_sum_kernel and rounded once. The reduce's
// float32 form is a design of its own (tb_bwd_reduce_f32_kernel): g split
// once into its planes by a pre-pass (tb_split_g_kernel), 64-row steps, one
// block an SM whose warps split the two products between them. bwd_dx's float32 form
// (tb_dx_f32_kernels.cu) reads the same planes. The bf16 kernels are the
// code they were before the float32 forms.
//
// Each entry point launches on the stream it is given and returns
// cudaGetLastError().

#include <string.h>

#include "halo.cuh"

namespace {

constexpr int kFillGroups = 16;
constexpr int kStatRows = 32;   // row stripes of a statistics block
constexpr int kStatCols = 64;   // channels of a statistics block

struct TblChunk {
  long long v[kFillGroups * kTblCols];
};

__global__ void fill_table_kernel(long long* __restrict__ dst, TblChunk c,
                                  int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = c.v[i];
}

// Where column k of the concat lives: (row 0 of it, row stride); T the
// groups' element type.
template <typename T>
struct ColRef {
  const T* x;
  long long ld;
};

template <typename T>
__device__ __forceinline__ ColRef<T> col_ref(
    const long long* __restrict__ tbl, int G, int k) {
  const long long* t = table_group(tbl, G, k);
  return {reinterpret_cast<const T*>(t[0]) + (k - t[3]), t[1]};
}

// The V = 16 / sizeof(T) values of one 16-byte load at p, as float32.
template <typename T>
__device__ __forceinline__ void load_vec(const T* p,
                                         float (&v)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    Pack8 q;
    q.v = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = lo(q, i);
  }
}

// ---------------------------------------------------------------------------
// tb_stats (bf16 features): part[s, 0, k] = sum, part[s, 1, k] = sum of
// squares of column k of the concat over rows [s*chunk, (s+1)*chunk)
// (float32). Grid (S, ceil(Ctot/64)); a block's 256 threads are 64 / V
// column vectors of V = 8 columns (one 16-byte load) x 32 row stripes,
// reduced in a fixed order in shared memory.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    tb_stats_kernel(const long long* __restrict__ tbl, int G, long long M,
                    int Ctot, long long chunk, float* __restrict__ part) {
  using T = bf16;
  constexpr int V = 16 / sizeof(T);
  constexpr int kVecs = kStatCols / V;
  constexpr int kStripes = kThreads / kVecs;
  static_assert(kStripes <= kStatRows, "row stripes past the reduction");
  __shared__ float red[2][kStatRows][kStatCols];
  const int cv = threadIdx.x % kVecs, rs = threadIdx.x / kVecs;
  const int k = blockIdx.y * kStatCols + cv * V;
  const long long rb = (long long)blockIdx.x * chunk;
  const long long re = rb + chunk < M ? rb + chunk : M;
  float s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = q[i] = 0.f;
  if (k < Ctot) {
    const ColRef<T> c = col_ref<T>(tbl, G, k);
    for (long long r = rb + rs; r < re; r += kStripes) {
      float v[V];
      load_vec(c.x + r * c.ld, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s[i] += v[i];
        q[i] += v[i] * v[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    red[0][rs][cv * V + i] = s[i];
    red[1][rs][cv * V + i] = q[i];
  }
  __syncthreads();
  if (threadIdx.x < 2 * kStatCols) {
    const int which = threadIdx.x / kStatCols, col = threadIdx.x % kStatCols;
    const int kk = blockIdx.y * kStatCols + col;
    float a = 0.f;
    for (int i = 0; i < kStripes; ++i) a += red[which][i][col];
    if (kk < Ctot) part[((long long)blockIdx.x * 2 + which) * Ctot + kk] = a;
  }
}

// ---------------------------------------------------------------------------
// tb_stats at float32: the same blocks, 16 row stripes of 16-byte loads of
// 4 columns. A thread loads kStatUnroll rows at once, sums them (and their
// squares) in float32, and adds that short partial into float64; the
// stripes in order and the chunk partials (part[s, 0 | 1, k], float64)
// are float64 too, and tb_stats_sum_kernel adds the chunks in order and
// rounds once. The sums then lie within about a rounding of float32 of
// the exact ones. Float32 running sums over a thread's 128 rows (the
// float32 form before) lost up to ~5 ulp, which the single-pass variance
// E[x^2] - mean^2 multiplies by mean^2 / var (up to ~17 on the CU-Net-8
// step: 5.2e-6 of the variance).
// ---------------------------------------------------------------------------
constexpr int kStatUnroll = 8;

__global__ void __launch_bounds__(kThreads)
    tb_stats_f32_kernel(const long long* __restrict__ tbl, int G,
                        long long M, int Ctot, long long chunk,
                        double* __restrict__ part) {
  constexpr int V = 4;
  constexpr int kVecs = kStatCols / V;
  constexpr int kStripes = kThreads / kVecs;
  __shared__ double red[2][kStripes][kStatCols];
  const int cv = threadIdx.x % kVecs, rs = threadIdx.x / kVecs;
  const int k = blockIdx.y * kStatCols + cv * V;
  const long long rb = (long long)blockIdx.x * chunk;
  const long long re = rb + chunk < M ? rb + chunk : M;
  double s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = q[i] = 0.0;
  if (k < Ctot) {
    const ColRef<float> c = col_ref<float>(tbl, G, k);
    for (long long r = rb + rs; r < re; r += kStatUnroll * kStripes) {
      float v[kStatUnroll][V];
#pragma unroll
      for (int j = 0; j < kStatUnroll; ++j) {
        const long long rr = r + j * kStripes;
        if (rr < re) {
          load_vec(c.x + rr * c.ld, v[j]);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) v[j][i] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float ps = 0.f, pq = 0.f;
#pragma unroll
        for (int j = 0; j < kStatUnroll; ++j) {
          ps += v[j][i];
          pq = fmaf(v[j][i], v[j][i], pq);
        }
        s[i] += (double)ps;
        q[i] += (double)pq;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    red[0][rs][cv * V + i] = s[i];
    red[1][rs][cv * V + i] = q[i];
  }
  __syncthreads();
  if (threadIdx.x < 2 * kStatCols) {
    const int which = threadIdx.x / kStatCols, col = threadIdx.x % kStatCols;
    const int kk = blockIdx.y * kStatCols + col;
    double a = 0.0;
    for (int i = 0; i < kStripes; ++i) a += red[which][i][col];
    if (kk < Ctot) part[((long long)blockIdx.x * 2 + which) * Ctot + kk] = a;
  }
}

// out[i] = float32(sum_s part[s, i]) over the S chunk partials in order,
// in float64; i over the n = 2 Ctot outputs.
__global__ void __launch_bounds__(kThreads)
    tb_stats_sum_kernel(const double* __restrict__ part, int S, int n,
                        float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  double a = 0.0;
  for (int s = 0; s < S; ++s) a += part[(long long)s * n + i];
  out[i] = (float)a;
}

// ---------------------------------------------------------------------------
// tb_bwd_reduce: one kind of block, over row chunk s (blockIdx.y) and the
// 64 concat columns [c0, c0 + 64) (blockIdx.x):
//   dw_part[s, c, n]   = sum_{m in chunk} r[m, c] g[m, n],  r = relu(y)
//   sums_part[s, 0, c] = sum g_y,  sums_part[s, 1, c] = sum g_y * x_hat,
//   g_y = [y > 0] (g W^T)[m, c]
// both products on the tensor cores (mma.sync m16n8k16, f32 sums) and
// float32-exact by an exact split of their float32 operands into three bf16
// pieces, v = p1 + p2 + p3 with p1 = bf16(v), p2 = bf16(v - p1),
// p3 = bf16(v - p1 - p2): 3 x 8 bits of significand hold a float32's 24
// (any normal v), and each bf16 x bf16 product is exact in the f32 sum. A
// bf16 g needs no split, so dW = sum_i p_i(r)^T g and g W^T = sum_i g
// p_i(W)^T agree with float32 FMA to float32 rounding, in another order.
// The block (bf16 features and g; the float32 form is
// tb_bwd_reduce_f32_kernel below):
// - splits its W rows once into three bf16 planes in shared memory;
// - stages each 32-row step's x vectors (through the feature table) and g
//   rows by cp.async, the next step loading while this one computes;
// - recomputes x_hat and y once per element in float32, one rounding per
//   operation in the plain version's order (so the gate is the same bit
//   for bit), and writes r's three planes and the gated x_hat (NaN where
//   y > 0 fails) to shared memory;
// - accumulates its dW partial in registers (A = r^T by ldmatrix.trans, B
//   = g by ldmatrix.trans), and computes g W^T for the step (A = g, B = the
//   W planes, both by ldmatrix), taking the gate and the two sums in its
//   registers;
// - writes one dW partial and one sums partial; train_ops.sum_rows adds
//   the chunks in order.
// Two blocks share an SM (32-row steps keep a block within half the SM's
// shared memory and its registers at 128 a thread), so one block's
// recompute and barriers overlap the other's products. Bounds at K=320 ->
// 128, batch 24, r=64: float32 FMA on the CUDA cores 240.4 us; this
// kernel's six bf16 passes 48.8 us (operations; 26 us of bytes). Measured
// there on an H100 80GB HBM3 at 700 W (PERF.md, PR 9): 209 us with its
// sum_rows (one block an SM with 64-row steps: 234 us, of which removing
// either product saved ~65).
// ---------------------------------------------------------------------------
constexpr int kRdThreads = 256;
constexpr int kRdCols = 64;   // concat columns of a block
constexpr int kRdRows = 32;   // rows of a pipelined step
constexpr int kRdMI = kRdRows / 32;   // m16 row tiles of a g W^T warp

struct RdPlan {
  long long chunk;  // rows of a block's chunk, a multiple of kRdRows
  int np;           // output channels zero-padded to 16
  int stages;       // x / g buffers: 2 (double-buffered) or 1
  int stat_off;     // shared-memory byte offsets: the columns' BN constants,
  int stage_off;    //   the first x / g stage,
  int stage_bytes;  //   bytes per stage,
  int g_off;        //   the g rows within a stage,
  int pl_off;       //   r's three planes,
  int xh_off;       //   the gated x_hat,
  int w_off;        //   W's slice planes within a stage (streamed W)
};

// W's rows c0 .. c0 + ROWS (float32 (Ctot, N)) split once into three bf16
// planes at ``smem``: plane k's row cl (concat column c0 + cl) at byte
// (k * ROWS + cl) * (np + 8) * 2, its N values contiguous; zero past Ctot
// and N.
template <int ROWS>
__device__ __forceinline__ void split_w_planes(unsigned char* smem,
                                               const float* __restrict__ w,
                                               int Ctot, int N, int c0, int np,
                                               int tid, int nthr) {
  const int gs = np + 8, wpl = ROWS * gs * 2;
  for (int i = tid; i < ROWS * np / 4; i += nthr) {
    const int cl = i / (np / 4), n = (i - cl * (np / 4)) * 4;
    const int c = c0 + cl;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < Ctot && n < N)
      v = *reinterpret_cast<const float4*>(w + (long long)c * N + n);
    const float vv[4] = {v.x, v.y, v.z, v.w};
    unsigned short q[3][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split3(vv[e], q[0][e], q[1][e], q[2][e]);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      *reinterpret_cast<uint2*>(smem + k * wpl + (cl * gs + n) * 2) =
          make_uint2(q[k][0] | ((unsigned)q[k][1] << 16),
                     q[k][2] | ((unsigned)q[k][3] << 16));
  }
}

// acc[i][j] += (g W^T) over a warp's MI m16 row tiles (g rows row0 + 16i
// .. of the staged g at ``gb``, row stride np + 8) and two n8 column tiles
// (W plane rows col0 + 8j ..): A = g and B = the planes by ldmatrix,
// kk over np / 16 outer and the three planes inner. bwd_reduce and bwd_dx
// both sum in this order, so their g_y are the same bits. (A float32 g
// is split into three planes too, and each k16 step adds the six plane
// products g_i W_j with i + j <= 4 (1-based) in f32_kernels.cu's order,
// small terms first: g1 W3, g2 W2, g1 W2, g3 W1, g2 W1, g1 W1 (the dropped
// three are below float32 rounding); the float32 reduce and dx sum in
// that order on wgmma.)
template <int MI>
__device__ __forceinline__ void gw_product_n(float (&acc)[MI][2][4],
                                             uint32_t gb, uint32_t wb, int nk,
                                             int gs, int wpl, int row0,
                                             int col0, int lane) {
  const int mat = lane >> 3;
  for (int kk = 0; kk < nk; ++kk) {
    uint32_t a[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      ldsm_x4(a[i], gb + ((row0 + 16 * i + (lane & 15)) * gs) * 2 +
                        kk * 32 + (lane >> 4) * 16);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      uint32_t b[4];
      ldsm_x4(b, wb + k * wpl +
                     ((col0 + (mat >> 1) * 8 + (lane & 7)) * gs) * 2 +
                     kk * 32 + (mat & 1) * 16);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        mma16816(acc[i][0], a[i], b[0], b[1]);
        mma16816(acc[i][1], a[i], b[2], b[3]);
      }
    }
  }
}

// The same over all np / 16 k16 steps, g and the planes at a row stride
// of np + 8.
template <int MI>
__device__ __forceinline__ void gw_product(float (&acc)[MI][2][4],
                                           uint32_t gb, uint32_t wb, int np,
                                           int wpl, int row0, int col0,
                                           int lane) {
  gw_product_n<MI>(acc, gb, wb, np / 16, np + 8, wpl, row0, col0, lane);
}

// STREAM: np > kWideN, the outputs in slices of kSliceN (NB8 = 4): the
// grid's z the dW slice; block z = 0 also takes g W^T and the sums, each
// step's slices an item of its pipeline (g's rows and W's planes of the
// slice, from the slice images ws of halo.cuh split_w_slices), one
// accumulator over N in bwd_dx's order; a block z > 0 its own slice's g.
// Two stages.
template <int NB8, bool STREAM = false>
__global__ void __launch_bounds__(kRdThreads, 2)
    tb_bwd_reduce_kernel(const long long* __restrict__ tbl, int G,
                         long long M, int Ctot, const bf16* __restrict__ g,
                         long long ldg, int N, const float* __restrict__ stat,
                         const float* __restrict__ bias,
                         const float* __restrict__ w,
                         const bf16* __restrict__ ws, RdPlan p,
                         float* __restrict__ dw_part,
                         float* __restrict__ sums_part) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int XS = kRdCols + 8;       // x row stride, elements
  constexpr int PS = kRdCols + 8;       // r-plane row stride, elements
  constexpr int HS = kRdCols + 8;       // x_hat row stride, floats
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.x * kRdCols;
  const long long rb = (long long)blockIdx.y * p.chunk;
  const long long re = rb + p.chunk < M ? rb + p.chunk : M;
  const int nsteps = (int)((re - rb + kRdRows - 1) / kRdRows);
  const int np = p.np;
  // g-plane / W-plane row stride (a slice's when streamed)
  const int gs = STREAM ? kSliceN + 8 : np + 8;
  const int wpl = kRdCols * gs * 2;     // bytes of one W plane
  float* sst = reinterpret_cast<float*>(smem + p.stat_off);
  const int nh = STREAM ? (np + kSliceN - 1) / kSliceN : 1;
  const int z = STREAM ? (int)blockIdx.z : 0;   // this block's dW slice
  const int per = z == 0 ? nh : 1;              // items of a step
  const int items = nsteps * per;

  // this thread's x vector: columns c0 + xv*8 .. +7, rows xr + 32h
  const int xv = tid & 7, xr = tid >> 3;
  const int xc = c0 + xv * 8;
  ColRef<bf16> xref{nullptr, 0};
  if (xc < Ctot) xref = col_ref<bf16>(tbl, G, xc);

  // item it (step it / per, its slice) into stage it % stages: the
  // step's x vectors with its first item, the slice's g rows (and W's
  // planes where streamed); an item past the chunk commits an empty group,
  // so group it is always item it's
  const auto issue = [&](int it) {
    if (it >= items) {
      cp_async_commit();
      return;
    }
    const int st = it / per, h = z + it - st * per;
    const long long m0 = rb + (long long)st * kRdRows;
    const uint32_t base = s0 + p.stage_off + (it % p.stages) * p.stage_bytes;
    if (it == st * per) {
#pragma unroll
      for (int hh = 0; hh < kRdRows / 32; ++hh) {
        const int r = xr + 32 * hh;
        const bool ok = xc < Ctot && m0 + r < re;
        cp_async16(base + (r * XS + xv * 8) * 2,
                   ok ? xref.x + (m0 + r) * xref.ld : g, ok ? 16 : 0);
      }
    }
    const int gv = (STREAM ? kSliceN : np) / 8, n0 = h * kSliceN;
    for (int i = tid; i < kRdRows * gv; i += kRdThreads) {
      const int r = i / gv, j = i - (i / gv) * gv;
      const bool ok = m0 + r < re && n0 + j * 8 < N;
      cp_async16(base + p.g_off + (r * gs + j * 8) * 2,
                 ok ? g + (m0 + r) * ldg + n0 + j * 8 : g, ok ? 16 : 0);
    }
    if (STREAM && z == 0) {
      const bf16* src = ws + ((long long)blockIdx.x * nh + h) * 3 *
                                 slice_plane(false);
      for (int i = tid; i < 3 * wpl / 16; i += kRdThreads)
        cp_async16(base + p.w_off + i * 16, src + i * 8, 16);
    }
    cp_async_commit();
  };
  for (int it = 0; it + 1 < p.stages; ++it) issue(it);

  // the columns' BN constants, and W's rows split into three planes once
  if (tid < kRdCols) {
    const int c = c0 + tid;
    const bool ok = c < Ctot;
    sst[tid] = ok ? stat[c] : 0.f;
    sst[kRdCols + tid] = ok ? stat[Ctot + c] : 0.f;
    sst[2 * kRdCols + tid] = ok ? stat[2 * Ctot + c] : 0.f;
    sst[3 * kRdCols + tid] = ok ? bias[c] : 0.f;
  }
  if (!STREAM)
    split_w_planes<kRdCols>(smem, w, Ctot, N, c0, np, tid, kRdThreads);
  __syncthreads();
  float mu[8], is[8], sc[8], bb[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    mu[t] = sst[xv * 8 + t];
    is[t] = sst[kRdCols + xv * 8 + t];
    sc[t] = sst[2 * kRdCols + xv * 8 + t];
    bb[t] = sst[3 * kRdCols + xv * 8 + t];
  }

  // dW: warp (dc, dq) owns columns dc*32 .. +32 (two m16 tiles of r^T)
  // and outputs dq*NB8*8 .. (NB8 n8 tiles of g)
  const int dc = warp & 1, dq = warp >> 1;
  const int nb0 = dq * NB8 * 8;
  // g W^T: warp (gr, gc) owns rows gr*16*kRdMI .. and columns gc*16 .. +16
  const int gr = warp & 1, gc = warp >> 1, gr0 = gr * 16 * kRdMI;
  const int mat = lane >> 3;
  const int t_pix = (lane & 7) + (mat >> 1) * 8;   // .trans A row (r^T)
  const int t_ofs = (mat & 1) * 16;
  const int b_pix = (mat & 1) * 8 + (lane & 7);    // .trans B row (g)
  float acc[2][NB8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NB8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float sg[4] = {0.f, 0.f, 0.f, 0.f}, sx[4] = {0.f, 0.f, 0.f, 0.f};
  const uint32_t pl = s0 + p.pl_off;
  const int plb = kRdRows * PS * 2;                // bytes of one r plane
  float* xh = reinterpret_cast<float*>(smem + p.xh_off);

  float gw[kRdMI][2][4];   // g W^T of a step, over its slices
  for (int it = 0; it < items; ++it) {
    issue(it + p.stages - 1);     // into the stage item it - 1 used
    if (p.stages == 2) cp_async_wait<1>();   // item it has landed
    else cp_async_wait<0>();
    __syncthreads();
    const int st = it / per, h = z + it - st * per;
    const bool first = it == st * per, last = it == st * per + per - 1;
    const int npl = STREAM ? min(kSliceN, np - h * kSliceN) : np;
    const long long m0 = rb + (long long)st * kRdRows;
    const uint32_t sb = s0 + p.stage_off + (it % p.stages) * p.stage_bytes;
    const unsigned char* sx_ = smem + p.stage_off +
                               (it % p.stages) * p.stage_bytes;

    // the recompute, once per element (with the step's first item): r's
    // planes and the gated x_hat
    if (first) {
#pragma unroll
      for (int h = 0; h < kRdRows / 32; ++h) {
        const int r = xr + 32 * h;
        const bool row_ok = m0 + r < re;
        const bf16* xin = reinterpret_cast<const bf16*>(sx_) + r * XS + xv * 8;
        float xf[8];
        Pack8 in;
        in.v = *reinterpret_cast<const uint4*>(xin);
#pragma unroll
        for (int t = 0; t < 8; ++t) xf[t] = lo(in, t);
        Pack8 o1, o2, o3;
        float hv[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const bool ok = row_ok && xc + t < Ctot;
          const float xhat = xhat_of(xf[t], mu[t], is[t]);
          const float y = ybn_of(xhat, sc[t], bb[t]);
          const bool pass = ok && y > 0.f;
          split3(pass ? y : 0.f, o1.u[t], o2.u[t], o3.u[t]);
          hv[t] = pass ? xhat : __int_as_float(0x7fc00000);
        }
        const int e = (r * PS + xv * 8) * 2;
        *reinterpret_cast<uint4*>(smem + p.pl_off + e) = o1.v;
        *reinterpret_cast<uint4*>(smem + p.pl_off + plb + e) = o2.v;
        *reinterpret_cast<uint4*>(smem + p.pl_off + 2 * plb + e) = o3.v;
        float* hp = xh + r * HS + xv * 8;
        *reinterpret_cast<float4*>(hp) =
            make_float4(hv[0], hv[1], hv[2], hv[3]);
        *reinterpret_cast<float4*>(hp + 4) =
            make_float4(hv[4], hv[5], hv[6], hv[7]);
      }
      __syncthreads();
    }

    // B of the dW product: the n8 tiles of the staged g rows for the
    // step's 16-row slice ks
    const auto load_b = [&](uint32_t gb, int ks, uint32_t (&b)[NB8][2]) {
#pragma unroll
      for (int jp = 0; jp < NB8 / 2; ++jp) {
        uint32_t t4[4] = {0u, 0u, 0u, 0u};
        if (nb0 + 16 * jp < npl)
          ldsm_x4_t(t4, gb + ((ks * 16 + b_pix) * gs + nb0 + 16 * jp +
                              8 * (mat >> 1)) * 2);
        b[2 * jp][0] = t4[0];
        b[2 * jp][1] = t4[1];
        b[2 * jp + 1][0] = t4[2];
        b[2 * jp + 1][1] = t4[3];
      }
      if ((NB8 & 1) && nb0 + 8 * (NB8 - 1) < npl)
        ldsm_x2_t(b[NB8 - 1][0], b[NB8 - 1][1],
                  gb + ((ks * 16 + b_pix) * gs + nb0 + 8 * (NB8 - 1)) * 2);
    };
    // dW += r plane k's slice ks, transposed, times b
    const auto dw_plane = [&](int k, int ks, const uint32_t (&b)[NB8][2]) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4_t(a[i], pl + k * plb + ((ks * 16 + t_pix) * PS +
                                        dc * 32 + 16 * i) * 2 + t_ofs);
#pragma unroll
      for (int j = 0; j < NB8; ++j) {
        if (nb0 + 8 * j >= npl) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma16816(acc[i][j], a[i], b[j][0], b[j][1]);
      }
    };

    // dW += sum p_i(r)^T g over the step's rows: the three r planes
    // times g (the block's slice's)
    const uint32_t gb_ = sb + p.g_off;
    if (h == z) {
#pragma unroll
      for (int ks = 0; ks < kRdRows / 16; ++ks) {
        uint32_t b[NB8][2] = {};
        load_b(gb_, ks, b);
#pragma unroll
        for (int k = 0; k < 3; ++k) dw_plane(k, ks, b);
      }
    }

    // g W^T for the step's rows (block z = 0), over its slices, gated
    // after the last; the two sums
    if (z == 0) {
      if (first) {
#pragma unroll
        for (int i = 0; i < kRdMI; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) gw[i][j][e] = 0.f;
      }
      if (STREAM)
        gw_product_n<kRdMI>(gw, gb_, sb + p.w_off, npl / 16, gs, wpl, gr0,
                            gc * 16, lane);
      else
        gw_product<kRdMI>(gw, gb_, s0, np, wpl, gr0, gc * 16, lane);
      if (last) {
#pragma unroll
        for (int i = 0; i < kRdMI; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* hr = xh + (gr0 + 16 * i + (lane >> 2) + 8 * h) * HS +
                              gc * 16 + 2 * (lane & 3);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float2 v = *reinterpret_cast<const float2*>(hr + 8 * j);
              const float gv0 = gw[i][j][2 * h], gv1 = gw[i][j][2 * h + 1];
              if (v.x == v.x) {
                sg[2 * j] += gv0;
                sx[2 * j] += __fmul_rn(gv0, v.x);
              }
              if (v.y == v.y) {
                sg[2 * j + 1] += gv1;
                sx[2 * j + 1] += __fmul_rn(gv1, v.y);
              }
            }
          }
      }
    }
    __syncthreads();
  }

  // the dW partial of this chunk (of the block's slice)
  float* dbase = dw_part + (long long)blockIdx.y * Ctot * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NB8; ++j) {
      const int n = z * kSliceN + nb0 + 8 * j + 2 * (lane & 3);
      const int c = c0 + dc * 32 + 16 * i + (lane >> 2);
      if (n >= N) continue;
      if (c < Ctot)
        *reinterpret_cast<float2*>(dbase + (long long)c * N + n) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (c + 8 < Ctot)
        *reinterpret_cast<float2*>(dbase + (long long)(c + 8) * N + n) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
  // the sums: over the lanes of a column (fixed tree), then the two row
  // halves in order
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      sg[e] += __shfl_xor_sync(0xffffffffu, sg[e], o);
      sx[e] += __shfl_xor_sync(0xffffffffu, sx[e], o);
    }
  float* red = xh;      // free after the loop's last barrier
  if (z == 0 && lane < 4)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = gc * 16 + 8 * (e >> 1) + 2 * lane + (e & 1);
      red[(0 * 2 + gr) * kRdCols + col] = sg[e];
      red[(1 * 2 + gr) * kRdCols + col] = sx[e];
    }
  __syncthreads();
  if (z == 0 && tid < 2 * kRdCols) {
    const int which = tid / kRdCols, col = tid % kRdCols, c = c0 + col;
    if (c < Ctot)
      sums_part[((long long)blockIdx.y * 2 + which) * Ctot + c] =
          red[(which * 2) * kRdCols + col] +
          red[(which * 2 + 1) * kRdCols + col];
  }
}

// ---------------------------------------------------------------------------
// tb_bwd_reduce at float32 (features and g float32): the same outputs, by
// two kernels.
// - tb_split_g_kernel splits g once into its three bf16 planes (common.cuh
//   split3) in device memory, each element once, where the column blocks
//   of the reduce would each split it again; the backward hands the same
//   planes to bwd_dx's float32 form (tb_dx_f32_kernels.cu), so no block
//   splits g. A plane is stored as the reduce
//   stages it: per 64-row tile t, 16 x 8 core matrices of 8 outputs n x 8
//   rows m (16 bytes a row: one output's 8 consecutive rows), core matrix
//   (n / 8, m / 8 within the tile) at ((k * T + t) * 128 + (n / 8) * 8 +
//   m / 8) * 128 bytes, zero past N and M (outputs padded to 128). A
//   cotangent wider than 128 is stored in nh = ceil(N / 128) such halves
//   (slices past two) a tile, half h of tile t where tile t * nh + h would
//   be.
// - tb_bwd_reduce_f32_kernel: block (row chunk blockIdx.y, 64 concat
//   columns blockIdx.x), two warpgroups, one block an SM, steps of kRfRows
//   rows. Each step's float32 x vectors (through the feature table) and
//   g's plane tiles (3 x 16 KB, contiguous) arrive by cp.async, the next
//   step's loading while this one computes; one barrier a step. W's rows
//   are split once into three bf16 planes of core matrices in shared
//   memory (split_w_cores). Both products run on wgmma (asynchronous: one
//   warpgroup's CUDA-core work runs under the other's products):
//   * warpgroup 0, g W^T (m64n64k16 over the step's 64 x 64 tile): A =
//     g's planes in registers by ldmatrix.trans from the core matrices,
//     B = W's planes by a shared-memory descriptor, the six plane
//     products per element in the float32 order above (k16 steps over N
//     ascending, W planes 3, 2, 1, each with the g planes that keep i + j
//     <= 4, one accumulator over N from zero). wgmma and mma.sync give
//     the same bits for this chain (2^25 outputs compared on an H100,
//     PERF.md section 6), so each g_y is the bits tb_bwd_dx gates. The
//     gate and the two sums on the accumulators: x_hat and y recomputed
//     from the staged x (one rounding per operation, the plain version's
//     order), each lane summing its columns over its rows;
//   * warpgroup 1, dW (m64n128k16): A = r^T, 64 columns x 16 rows, built
//     in registers from the staged x by each warp for its 16 columns (the
//     recompute, relu, the split of each pair of rows, halo.cuh
//     split_pair), the next k16 group's while this one's products run;
//     B = g's plane tile by a descriptor (K-major: the core matrices
//     above); each k16 row group's six products g_j r_i (i + j <= 4, small
//     terms first: g3 r1, g2 r2, g2 r1, g1 r3, g1 r2, g1 r1) sum from zero
//     in a fragment, which joins the running sum by one round-to-nearest
//     float32 add (the tensor cores' float32 accumulation truncates;
//     dw_f32_kernels.cu's order).
//   Past 128 outputs the grid's z halves the outputs: block z takes dW of
//   outputs 128z .. +128 (its g half of each step), and block 0 alone g
//   W^T and the sums, walking each step's g halves as items of its
//   pipeline (k16 steps over N ascending, one accumulator, as at N <=
//   128). Past kRfMaxN (STREAM) W's planes are no longer resident: block
//   0's items stage the half's slice of them too (halo.cuh
//   split_w_slices), exactly the card's 227 KB.
//   Row chunks, steps and every order of summation depend on the shapes
//   alone; each block writes one dW partial (of its outputs) and block
//   z = 0 one sums partial, which train_ops.sum_rows adds in order.
// Bound at K=320 -> 128, batch 24, r=64: the twelve bf16 passes of its two
// products (96.6 GFLOP, 97.7 us at 989 TFLOP/s); the float32 FMA of the
// same products on the CUDA cores would take 240.4 us.
// ---------------------------------------------------------------------------
constexpr int kRfRows = 64;            // rows of a step (a plane tile)
constexpr int kRfXS = kRdCols + 4;     // staged x row stride, floats
constexpr int kRfN = 128;              // outputs of a plane tile (padded)
constexpr int kRfMaxN = 2 * kRfN;      // the widest with W resident
constexpr int kRfPlane = kRfN * kRfRows * 2;   // bytes of a plane tile

inline int rf_up128(int b) {
  return (b + 127) / 128 * 128;
}

// The float32 reduce's shared memory (train_bottleneck.reduce_plan_f32
// computes the same): W's three planes (kRdCols x np bf16 in core
// matrices, split_w_cores), two buffers of kRfRows x rows (kRfXS floats)
// and g's three plane tiles (the sums' reduction, 2 x 4 x kRdCols floats,
// takes the first after the last step), then the columns' BN constants.
struct RfLayout {
  int wpl;          // bytes of one W plane (0: W streamed)
  int stage_off;    // the first buffer
  int g_off;        // g's plane tiles within a buffer
  int sw_off;       // W's slice planes within a buffer (streamed W)
  int stage_bytes;  // bytes of a buffer
  int stat_off;     // [mean; inv_sigma; scale; bias] of the columns
  int bytes;
};

// Past kRfMaxN outputs W's planes do not stay resident: each buffer also
// takes the item's slice of them (halo.cuh split_w_slices, core matrices,
// 3 x 16 KB), exactly the card's 227 KB with the rest.
inline RfLayout rf_layout(int np) {
  const bool stream = np > kRfMaxN;
  RfLayout l;
  l.wpl = stream ? 0 : kRdCols * np * 2;
  l.stage_off = rf_up128(3 * l.wpl);
  l.g_off = kRfRows * kRfXS * 4;
  l.sw_off = stream ? l.g_off + 3 * kRfPlane : 0;
  l.stage_bytes = rf_up128(l.g_off + (stream ? 6 : 3) * kRfPlane);
  l.stat_off = l.stage_off + 2 * l.stage_bytes;
  l.bytes = l.stat_off + 4 * kRdCols * 4;
  return l;
}

// g (M, N) float32 -> gp, its three planes in 64-row tiles of core
// matrices (the header above), T = ceil(M / 64) tiles a plane, NH halves
// (slices past two) of 128 outputs a tile. Thread (t, n, mg) splits rows
// t*64 + mg*8 .. +8 of output n; a warp's 32 outputs read each row
// coalesced.
template <int NH>
__global__ void __launch_bounds__(kThreads)
    tb_split_g_kernel(const float* __restrict__ g, long long ldg,
                      long long M, int N, long long T, int nhr,
                      bf16* __restrict__ gp) {
  // NH halves a tile (a constant, so the index arithmetic is shifts), or
  // with NH = 0 nhr of them
  const int nh = NH ? NH : nhr, nw = nh * kRfN;
  const long long total = T * nw * 8;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < total; i += (long long)gridDim.x * kThreads) {
    const int n = (int)(i % nw);
    const long long tm = i / nw;              // (t, mg)
    const long long t = tm / 8;
    const int mg = (int)(tm % 8);
    const long long m0 = t * kRfRows + mg * 8;
    Pack8 a, b, c;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float v = n < N && m0 + e < M ? g[(m0 + e) * ldg + n] : 0.f;
      split3(v, a.u[e], b.u[e], c.u[e]);
    }
    const int h = n / kRfN, nl = n % kRfN;
    const long long cm =
        ((t * nh + h) * 128 + (nl / 8) * 8 + mg) * 64 + (nl % 8) * 8;
    const long long pl = T * nh * 128 * 64;   // elements of a plane
    *reinterpret_cast<uint4*>(gp + cm) = a.v;
    *reinterpret_cast<uint4*>(gp + pl + cm) = b.v;
    *reinterpret_cast<uint4*>(gp + 2 * pl + cm) = c.v;
  }
}


// d (64 x 128, this warp's 16 rows) = a (registers, 64 x 16) * B (smem
// descriptor, 16 x 128) (+ d with ACC), bf16 in, float32 out.
template <int ACC>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(ACC));
}

// NT8: k16 steps of g W^T over a g half (np / 16 where np <= kRfN). WIDE:
// np > kRfN, halves of kRfN outputs (NT8 = 8), grid z the dW half: two
// with W resident, or (STREAM, np > kRfMaxN) any number, W's planes
// staged with each item's half from the slices of ws (halo.cuh
// split_w_slices; the block's column block's images).
template <int NT8, bool WIDE, bool STREAM = false>
__global__ void __launch_bounds__(kRdThreads, 1)
    tb_bwd_reduce_f32_kernel(const long long* __restrict__ tbl, int G,
                             long long M, int Ctot,
                             const bf16* __restrict__ gp, long long T, int N,
                             const float* __restrict__ stat,
                             const float* __restrict__ bias,
                             const float* __restrict__ w,
                             const bf16* __restrict__ ws, long long chunk,
                             RfLayout L, float* __restrict__ dw_part,
                             float* __restrict__ sums_part) {
  const int np = WIDE ? (N + 15) / 16 * 16 : 16 * NT8;
  // g halves of a tile
  const int nh = STREAM ? (np + kRfN - 1) / kRfN : WIDE ? 2 : 1;
  const int z = WIDE ? (int)blockIdx.z : 0;    // this block's dW half
  // block z = 0 walks both halves of a step (g W^T reads all of N), a
  // block z > 0 its own
  const int per = z == 0 ? nh : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.x * kRdCols;
  const long long rb = (long long)blockIdx.y * chunk;
  const long long re = rb + chunk < M ? rb + chunk : M;
  const int nsteps = (int)((re - rb + kRfRows - 1) / kRfRows);
  const int items = nsteps * per;
  const int g8 = lane >> 2, q4 = lane & 3, mat = lane >> 3;

  // this thread's x vector: columns c0 + xv*4 .. +3, rows xr + 16h
  const int xv = tid & 15, xr = tid >> 4;
  const int xc = c0 + xv * 4;
  ColRef<float> xref{nullptr, 0};
  if (xc < Ctot) xref = col_ref<float>(tbl, G, xc);
  // item it (step it / per, g half z + it % per): the step's x vectors
  // (zero past the chunk and Ctot) and the half's three plane tiles into
  // buffer it & 1
  const auto issue = [&](int it) {
    const int st = it / per, h = z + it - st * per;
    const long long m0 = rb + (long long)st * kRfRows;
    const uint32_t base = s0 + L.stage_off + (it & 1) * L.stage_bytes;
#pragma unroll
    for (int hh = 0; hh < kRfRows / 16; ++hh) {
      const int r = xr + 16 * hh;
      const bool ok = xc < Ctot && m0 + r < re;
      cp_async16(base + (r * kRfXS + xv * 4) * 4,
                 ok ? xref.x + (m0 + r) * xref.ld : w, ok ? 16 : 0);
    }
    const long long t = m0 / kRfRows;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const bf16* src = gp + ((k * T + t) * nh + h) * (kRfPlane / 2);
      for (int i = tid; i < kRfPlane / 16; i += kRdThreads)
        cp_async16(base + L.g_off + k * kRfPlane + i * 16, src + i * 8, 16);
    }
    if (STREAM && z == 0) {
      // W's planes of the half (g W^T reads them)
      const bf16* src =
          ws + ((long long)blockIdx.x * nh + h) * 3 * slice_plane(true);
      for (int i = tid; i < 3 * kRfPlane / 16; i += kRdThreads)
        cp_async16(base + L.sw_off + i * 16, src + i * 8, 16);
    }
    cp_async_commit();
  };
  issue(0);
  if (!STREAM && z == 0)
    split_w_cores<kRdCols>(smem, w, Ctot, N, c0, np, tid, kRdThreads);

  // the columns' BN constants [mean, inv_sigma, scale, bias] as one
  // 16-byte vector a column
  float4* sst = reinterpret_cast<float4*>(smem + L.stat_off);
  if (tid < kRdCols) {
    const int c = c0 + tid;
    sst[tid] = c < Ctot ? make_float4(stat[c], stat[Ctot + c],
                                      stat[2 * Ctot + c], bias[c])
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const bool gw_warp = warp < 4;
  // warp w of a warpgroup: g W^T rows w*16 + g8 (+8), this lane's columns
  // 8j + 2*q4 + e (wgmma's accumulator layout); dW columns w*16 + g8 + 8h
  // (the rows of its A = r^T)
  const int wq = warp & 3;
  float sg[16], sx[16];
#pragma unroll
  for (int u = 0; u < 16; ++u) sg[u] = sx[u] = 0.f;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  float gw[32];   // g W^T of a step, over its halves

  for (int it = 0; it < items; ++it) {
    cp_async_wait<0>();
    __syncthreads();   // item it (and W's planes) landed; item it-1 done
    if (it + 1 < items) issue(it + 1);
    const int st = it / per, h = z + it - st * per;
    const long long m0 = rb + (long long)st * kRfRows;
    const int rows = re - m0 < kRfRows ? (int)(re - m0) : kRfRows;
    const unsigned char* buf = smem + L.stage_off + (it & 1) * L.stage_bytes;
    const float* xs = reinterpret_cast<const float*>(buf);
    const uint32_t gb = s0 + L.stage_off + (it & 1) * L.stage_bytes +
                        L.g_off;

    if (gw_warp) {
      if (z != 0) continue;
      // g W^T over the step's 64 x 64 tile by wgmma m64n64k16, per element
      // the float32 order: k16 steps over N ascending (this half's
      // after the previous one's), W planes 3, 2, 1, each with the g
      // planes that keep i + j <= 4, one accumulator over N from zero. A
      // (rows m, depth n) from the core matrices (n group, m group) by
      // ldmatrix.trans, matrix q of the x4 at n group 2kk + (q >> 1), m
      // group 2w + (q & 1), double-buffered so the next step's loads run
      // under this one's products; B = W plane pw's core matrices (column
      // group, n group), 128 bytes apart along K, np * 16 along N.
      if (h == 0) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          gw[e] = 0.f;
          reg_fence(gw[e]);
        }
      }
      // k16 steps of this half: N's own count (bwd_dx's), not the padding
      const int nkk = WIDE ? min(NT8, np / 16 - NT8 * h) : NT8;
      uint32_t a[2][3][4];
#pragma unroll
      for (int kk = 0; kk < NT8; ++kk) {
        if (WIDE && kk >= nkk) break;
        if (kk >= 2) wgmma_wait<1>();   // the group of kk - 2 read a[kk & 1]
#pragma unroll
        for (int pg = 0; pg < 3; ++pg)
          ldsm_x4_t(a[kk & 1][pg],
                    gb + pg * kRfPlane +
                        ((2 * kk + (mat >> 1)) * 8 + 2 * wq + (mat & 1)) *
                            128 +
                        (lane & 7) * 16);
        const int kn = NT8 * h + kk;   // the k16 step within N
        const auto bd = [&](int pw) {
          return STREAM ? smem_desc(s0 + L.stage_off + (it & 1) *
                                        L.stage_bytes + L.sw_off +
                                        pw * kRfPlane + 2 * kk * 128,
                                    128, kRfN * 16)
                        : smem_desc(s0 + pw * L.wpl + 2 * kn * 128, 128,
                                    np * 16);
        };
        const uint32_t (&ak)[3][4] = a[kk & 1];
        wgmma_fence();
        wgmma_m64n64(gw, ak[0], bd(2));
        wgmma_m64n64(gw, ak[1], bd(1));
        wgmma_m64n64(gw, ak[0], bd(1));
        wgmma_m64n64(gw, ak[2], bd(0));
        wgmma_m64n64(gw, ak[1], bd(0));
        wgmma_m64n64(gw, ak[0], bd(0));
        wgmma_commit();
      }
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 32; ++e) reg_fence(gw[e]);
      if (h < nh - 1) continue;
      // the gate and the two sums, column by column: x_hat, y recomputed
      // from the staged x (a zero term where the gate is shut: rows past
      // the chunk, y <= 0)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * q4 + e;
          const float4 k4 = sst[col];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = wq * 16 + g8 + 8 * hh;
            const float xh = xhat_of(xs[r * kRfXS + col], k4.x, k4.y);
            const float y = ybn_of(xh, k4.z, k4.w);
            const bool pass = r < rows && y > 0.f;
            const float gv = gw[4 * j + 2 * hh + e];
            sg[2 * j + e] += pass ? gv : 0.f;
            sx[2 * j + e] += pass ? __fmul_rn(gv, xh) : 0.f;
          }
        }
    } else {
      if (h != z) continue;
      // dW over the step's rows, one fragment a k16 row group: the r^T
      // registers of group ks + 1 are built while the wgmmas of group ks
      // run; the BN constants of this lane's two columns
      const float4 k4[2] = {sst[wq * 16 + g8], sst[wq * 16 + g8 + 8]};
      // A = r^T: reg h + 2kh holds rows ks*16 + 2*q4 + 8kh (+1) of column
      // w*16 + g8 + 8h
      const auto build = [&](int ks, uint32_t (&A)[3][4]) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int kh = 0; kh < 2; ++kh) {
            const int r = ks * 16 + 2 * q4 + 8 * kh;
            const int col = wq * 16 + g8 + 8 * hh;
            float rv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float xh = xhat_of(xs[(r + e) * kRfXS + col], k4[hh].x,
                                       k4[hh].y);
              const float y = ybn_of(xh, k4[hh].z, k4[hh].w);
              rv[e] = r + e < rows && y > 0.f ? y : 0.f;
            }
            const int reg = hh + 2 * kh;
            split_pair(rv[0], rv[1], A[0][reg], A[1][reg], A[2][reg]);
          }
      };
      // B = g plane pg's rows ks*16 .. +16: core matrices (n group, m
      // groups 2ks, 2ks + 1), 128 bytes apart along K, 1,024 along N
      float f[64];
      const auto products = [&](int ks, const uint32_t (&A)[3][4]) {
        const auto desc = [&](int pg) {
          return smem_desc(gb + pg * kRfPlane + 2 * ks * 128, 128, 1024);
        };
#pragma unroll
        for (int e = 0; e < 64; ++e) reg_fence(f[e]);
        wgmma_fence();
        wgmma_m64n128<0>(f, A[0], desc(2));
        wgmma_m64n128<1>(f, A[1], desc(1));
        wgmma_m64n128<1>(f, A[0], desc(1));
        wgmma_m64n128<1>(f, A[2], desc(0));
        wgmma_m64n128<1>(f, A[1], desc(0));
        wgmma_m64n128<1>(f, A[0], desc(0));
        wgmma_commit();
      };
      const auto join = [&]() {
        wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          reg_fence(f[e]);
          acc[e] = __fadd_rn(acc[e], f[e]);
        }
      };
      uint32_t A[2][3][4];
      build(0, A[0]);
      products(0, A[0]);
#pragma unroll
      for (int ks = 1; ks < kRfRows / 16; ++ks) {
        build(ks, A[ks & 1]);
        join();
        products(ks, A[ks & 1]);
      }
      join();
    }
  }

  // the sums' reduction takes the first buffer once every item is done
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + L.stage_off);
  if (gw_warp) {
    // the sums: over the lanes of a column (fixed tree), then the four
    // warps' rows in order
#pragma unroll
    for (int u = 0; u < 16; ++u)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        sg[u] += __shfl_xor_sync(0xffffffffu, sg[u], o);
        sx[u] += __shfl_xor_sync(0xffffffffu, sx[u], o);
      }
    if (lane < 4)
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int col = 8 * (u >> 1) + 2 * lane + (u & 1);
        red[(0 * 4 + wq) * kRdCols + col] = sg[u];
        red[(1 * 4 + wq) * kRdCols + col] = sx[u];
      }
  } else {
    // the dW partial of this chunk: the warp's rows wq*16 + g8 (+8), the
    // n8 tile j's outputs 128z + 8j + 2*q4, +1 (wgmma's accumulator
    // layout)
    float* dbase = dw_part + (long long)blockIdx.y * Ctot * N;
    const int c = c0 + wq * 16 + g8;
#pragma unroll
    for (int j = 0; j < 2 * NT8; ++j) {
      const int n = kRfN * z + 8 * j + 2 * q4;
      if (n >= N) continue;
      if (c < Ctot)
        *reinterpret_cast<float2*>(dbase + (long long)c * N + n) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (c + 8 < Ctot)
        *reinterpret_cast<float2*>(dbase + (long long)(c + 8) * N + n) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();
  if (z == 0 && tid < 2 * kRdCols) {
    const int which = tid / kRdCols, col = tid % kRdCols, c = c0 + col;
    const float* rw = red + which * 4 * kRdCols + col;
    if (c < Ctot)
      sums_part[((long long)blockIdx.y * 2 + which) * Ctot + c] =
          ((rw[0] + rw[kRdCols]) + rw[2 * kRdCols]) + rw[3 * kRdCols];
  }
}

// ---------------------------------------------------------------------------
// tb_bwd_dx: the input cotangents, for each group's bf16 dx
//   dx = (scale * inv_sigma) * ((g_y - red0) - x_hat * red1),
//   g_y = [y > 0] (g W^T)[m, c],
// red = [mean g_y; mean g_y x_hat] (tb_bwd_reduce's sums over M), x_hat and
// y recomputed as in tb_bwd_reduce. The plan is the wrapper's
// (train_bottleneck.py::dx_plan):
// - persistent blocks of 8 warps, two an SM; block b keeps the column group
//   b % ngrp of kDxCols concat columns: its W rows split once into three
//   bf16 planes in shared memory (split_w_planes, 52 KB at N = 128), its
//   x and dx chunks resolved from the table once into shared memory, and
//   the BN constants of each thread's four columns in registers;
// - it walks kDxRows-row steps b / ngrp, + grid / ngrp, ...: the ngrp
//   blocks that share a step run side by side, so g's rows come from HBM
//   about once, not once per column group;
// - a step's x chunks and g rows arrive by cp.async, the next step's
//   loading while this one computes;
// - g W^T on the tensor cores (gw_product: warp (wr, wc) owns rows wr*32 ..
//   +32 and columns wc*16 .. +16), float32-exact through the split, in
//   tb_bwd_reduce's order;
// - the epilogue runs on the accumulators: x from the staged tile, the
//   recompute, the gate and the jacobian, each result rounded to bf16 in
//   place of its x; the tile then leaves as 16-byte rows into each
//   chunk's dx tensor.
// Two other designs measured slower at r=64 (PERF.md section 6): each
// warp's B fragments held in registers (183 of them; one block an SM, four
// stages), and x read and dx written by each thread straight from and to
// global memory (one barrier a step, three g stages).
// ---------------------------------------------------------------------------
constexpr int kDxRows = 64;            // rows of a step
constexpr int kDxCols = 64;            // concat columns of a block
constexpr int kDxChunks = kDxCols / 8;

struct DxPlan {
  int ngrp;         // column groups of kDxCols
  int np;           // outputs (the product's depth) zero-padded to 16
  int tbl_off;      // shared-memory byte offsets: the x then dx chunks,
  int stage_off;    //   the first x / g stage,
  int stage_bytes;  //   bytes per stage (two stages),
  int g_off;        //   the g rows within a stage,
  int w_off;        //   W's slice planes within a stage (streamed W)
};

// STREAM: np > kWideN, each step walked in slices of kSliceN outputs, an
// item of the pipeline each (g's rows and W's planes of the slice, from
// the slice images ws of halo.cuh split_w_slices; the step's x with its
// last slice), one accumulator over N.
template <bool STREAM>
__global__ void __launch_bounds__(kThreads, 2)
    tb_bwd_dx_kernel(const long long* __restrict__ tbl, int G, int M,
                     int Ctot, const bf16* __restrict__ g, long long ldg,
                     int N, const float* __restrict__ stat,
                     const float* __restrict__ bias,
                     const float* __restrict__ red,
                     const float* __restrict__ w,
                     const bf16* __restrict__ ws, DxPlan p) {
  constexpr int XS = kDxCols + 8;      // x tile row stride
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = (blockIdx.x % p.ngrp) * kDxCols;
  const int steps = (M + kDxRows - 1) / kDxRows;
  const int first = blockIdx.x / p.ngrp, stride = gridDim.x / p.ngrp;
  if (first >= steps) return;
  const int Q = (steps - 1 - first) / stride + 1;
  const int np = p.np;
  // g and W-plane row stride (a slice's when streamed), slices of a step
  const int gs = STREAM ? kSliceN + 8 : np + 8, wpl = kDxCols * gs * 2;
  const int nh = STREAM ? (np + kSliceN - 1) / kSliceN : 1;
  Chunk* ch = reinterpret_cast<Chunk*>(smem + p.tbl_off);   // x, then dx

  if (tid < 2 * kDxChunks)
    ch[tid] = table_chunk(tbl, G, Ctot, c0 + (tid % kDxChunks) * 8,
                          tid < kDxChunks ? 0 : 4);
  __syncthreads();
  // item it (step it / nh, slice it % nh) into stage it & 1
  const auto issue = [&](int it) {
    const int q = it / nh, h = it - q * nh;
    const int m0 = (first + q * stride) * kDxRows;
    const uint32_t base = s0 + p.stage_off + (it & 1) * p.stage_bytes;
    if (h == nh - 1)
      load_chunks(base, ch, M, m0, kDxRows, kDxCols, tid, kThreads);
    const int gv = (STREAM ? kSliceN : np) / 8, n0 = h * kSliceN;
    for (int i = tid; i < kDxRows * gv; i += kThreads) {
      const int r = i / gv, j = i - r * gv;
      const bool ok = m0 + r < M && n0 + j * 8 < N;
      cp_async16(base + p.g_off + (r * gs + j * 8) * 2,
                 ok ? g + (long long)(m0 + r) * ldg + n0 + j * 8 : g,
                 ok ? 16 : 0);
    }
    if (STREAM) {
      const bf16* src = ws + ((long long)(c0 / kDxCols) * nh + h) * 3 *
                                 slice_plane(false);
      for (int i = tid; i < 3 * wpl / 16; i += kThreads)
        cp_async16(base + p.w_off + i * 16, src + i * 8, 16);
    }
    cp_async_commit();
  };
  issue(0);
  if (!STREAM) split_w_planes<kDxCols>(smem, w, Ctot, N, c0, np, tid, kThreads);

  // warp (wr, wc): rows wr*32 .. +32, columns wc*16 .. +16; this lane's
  // four columns wc*16 + 8j + 2(lane & 3) + e and their BN constants
  const int wr = warp & 1, wc = warp >> 1;
  float mu[2][2], is[2][2], sc[2][2], bb[2][2], r0[2][2], r1[2][2],
      cf[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + wc * 16 + 8 * j + 2 * (lane & 3) + e;
      const bool ok = c < Ctot;
      mu[j][e] = ok ? stat[c] : 0.f;
      is[j][e] = ok ? stat[Ctot + c] : 0.f;
      sc[j][e] = ok ? stat[2 * Ctot + c] : 0.f;
      bb[j][e] = ok ? bias[c] : 0.f;
      r0[j][e] = ok ? red[c] : 0.f;
      r1[j][e] = ok ? red[Ctot + c] : 0.f;
      cf[j][e] = __fmul_rn(sc[j][e], is[j][e]);
    }
  // dx of column (j, e) at x: the recompute, the gate on g_y and the
  // jacobian, one rounding per operation
  const auto dx_of = [&](float x, float gv, int j, int e) {
    const float xh = xhat_of(x, mu[j][e], is[j][e]);
    const float gy = ybn_of(xh, sc[j][e], bb[j][e]) > 0.f ? gv : 0.f;
    const float v = __fsub_rn(__fsub_rn(gy, r0[j][e]),
                              __fmul_rn(xh, r1[j][e]));
    return __fmul_rn(cf[j][e], v);
  };

  float acc[2][2][4];
  for (int it = 0; it < Q * nh; ++it) {
    cp_async_wait<0>();
    __syncthreads();   // item it (and the planes) landed; item it-1 done
    if (it + 1 < Q * nh) issue(it + 1);
    const int q = it / nh, h = it - q * nh;
    const int m0 = (first + q * stride) * kDxRows;
    const int sb = p.stage_off + (it & 1) * p.stage_bytes;
    if (h == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
    if (STREAM)
      gw_product_n<2>(acc, s0 + sb + p.g_off, s0 + sb + p.w_off,
                      min(kSliceN, np - h * kSliceN) / 16, gs, wpl, wr * 32,
                      wc * 16, lane);
    else
      gw_product<2>(acc, s0 + sb + p.g_off, s0, np, wpl, wr * 32, wc * 16,
                    lane);
    if (h < nh - 1) continue;

    // the epilogue, each dx in place of its x
    bf16* xt = reinterpret_cast<bf16*>(smem + sb);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wr * 32 + 16 * i + (lane >> 2) + 8 * h;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t* pu = reinterpret_cast<uint32_t*>(
              xt + r * XS + wc * 16 + 8 * j + 2 * (lane & 3));
          const uint32_t xv = *pu;
          const float x2[2] = {__uint_as_float(xv << 16),
                               __uint_as_float(xv & 0xffff0000u)};
          unsigned short o[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            o[e] = hi(dx_of(x2[e], acc[i][j][2 * h + e], j, e));
          *pu = o[0] | ((uint32_t)o[1] << 16);
        }
      }
    __syncthreads();
    // the tile out as 16-byte vectors, each into its chunk's dx tensor
    for (int i = tid; i < kDxRows * kDxChunks; i += kThreads) {
      const int r = i / kDxChunks, v = i - r * kDxChunks;
      const Chunk d = ch[kDxChunks + v];
      if (m0 + r < M && d.ptr)
        *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(d.ptr) +
                                  (long long)(m0 + r) * d.ld) =
            *reinterpret_cast<const uint4*>(xt + r * XS + v * 8);
    }
  }
}

template <int NB8, bool STREAM = false>
int launch_bwd_reduce(const long long* tbl, int G, long long M, int Ctot,
                      const bf16* g, long long ldg, int N, const float* stat,
                      const float* bias, const float* w, const bf16* ws,
                      const RdPlan& p, float* dw_part, float* sums_part,
                      int smem, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      tb_bwd_reduce_kernel<NB8, STREAM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((Ctot + kRdCols - 1) / kRdCols),
                  (unsigned)((M + p.chunk - 1) / p.chunk),
                  STREAM ? (p.np + kSliceN - 1) / kSliceN : 1);
  tb_bwd_reduce_kernel<NB8, STREAM><<<grid, kRdThreads, smem, st>>>(
      tbl, G, M, Ctot, g, ldg, N, stat, bias, w, ws, p, dw_part, sums_part);
  return (int)cudaGetLastError();
}

template <int NT8, bool WIDE, bool STREAM = false>
int launch_bwd_reduce_f32(const long long* tbl, int G, long long M, int Ctot,
                          const bf16* gp, long long T, int N,
                          const float* stat, const float* bias,
                          const float* w, const bf16* ws, long long chunk,
                          const RfLayout& l, float* dw_part,
                          float* sums_part, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      tb_bwd_reduce_f32_kernel<NT8, WIDE, STREAM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, l.bytes);
  if (e != cudaSuccess) return (int)e;
  const int np = (N + 15) / 16 * 16;
  const dim3 grid((unsigned)((Ctot + kRdCols - 1) / kRdCols),
                  (unsigned)((M + chunk - 1) / chunk),
                  STREAM ? (np + kRfN - 1) / kRfN : WIDE ? 2 : 1);
  tb_bwd_reduce_f32_kernel<NT8, WIDE, STREAM>
      <<<grid, kRdThreads, l.bytes, st>>>(tbl, G, M, Ctot, gp, T, N, stat,
                                          bias, w, ws, chunk, l, dw_part,
                                          sums_part);
  return (int)cudaGetLastError();
}

int stats(const void* tbl, int G, long long M, int Ctot, long long chunk,
          void* part, void* stream) {
  const dim3 grid((unsigned)((M + chunk - 1) / chunk),
                  (unsigned)((Ctot + kStatCols - 1) / kStatCols));
  tb_stats_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(tbl), G, M, Ctot, chunk,
      static_cast<float*>(part));
  return (int)cudaGetLastError();
}

// the float32 form: float64 chunk partials in part64, then their sum,
// rounded once, into out (2, Ctot)
int stats_f32(const void* tbl, int G, long long M, int Ctot, long long chunk,
              void* part64, void* out, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int S = (int)((M + chunk - 1) / chunk);
  const dim3 grid((unsigned)S, (unsigned)((Ctot + kStatCols - 1) / kStatCols));
  auto* pp = static_cast<double*>(part64);
  tb_stats_f32_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const long long*>(tbl), G, M, Ctot, chunk, pp);
  const int n = 2 * Ctot;
  tb_stats_sum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      pp, S, n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

int bwd_reduce(const void* tbl, int G, long long M, int Ctot, const void* g,
               long long ldg, int N, const void* stat, const void* bias,
               const void* w, void* ws, const RdPlan& p, int smem,
               void* dw_part, void* sums_part, void* stream) {
  const auto* tp = static_cast<const long long*>(tbl);
  const auto* gp = static_cast<const bf16*>(g);
  const auto* sp = static_cast<const float*>(stat);
  const auto* bp = static_cast<const float*>(bias);
  const auto* wp = static_cast<const float*>(w);
  auto* wsp = static_cast<bf16*>(ws);
  auto* dp = static_cast<float*>(dw_part);
  auto* rp = static_cast<float*>(sums_part);
  const auto st = static_cast<cudaStream_t>(stream);
  if (p.np > kWideN) {
    if (!ws || p.stages != 2) return (int)cudaErrorInvalidValue;
    const int e = split_w_slices(wp, N, Ctot, N, false, wsp, st);
    if (e) return e;
    return launch_bwd_reduce<kSliceN / 32, true>(tp, G, M, Ctot, gp, ldg, N,
                                                 sp, bp, wp, wsp, p, dp, rp,
                                                 smem, st);
  }
  switch ((p.np + 31) / 32) {
#define CUNET_RD_NB8(n)                                                 \
  case n:                                                               \
    return launch_bwd_reduce<n>(tp, G, M, Ctot, gp, ldg, N, sp, bp, wp, \
                                wsp, p, dp, rp, smem, st);
    CUNET_RD_NB8(1) CUNET_RD_NB8(2) CUNET_RD_NB8(3) CUNET_RD_NB8(4)
    CUNET_RD_NB8(5) CUNET_RD_NB8(6) CUNET_RD_NB8(7) CUNET_RD_NB8(8)
#undef CUNET_RD_NB8
  }
  return (int)cudaErrorInvalidValue;
}

// tb_split_g_kernel over g (M, N) float32 at row stride ldg into its
// planes at gp (the layout above, nh halves past 128 outputs).
int split_g(const float* g, long long ldg, long long M, int N, bf16* gp,
            cudaStream_t st) {
  const long long T = (M + kRfRows - 1) / kRfRows;
  const int nh = (N + kRfN - 1) / kRfN;
  const long long want = (T * nh * kRfN * 8 + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < 132 * 16 ? want : 132 * 16);
  if (nh == 2)
    tb_split_g_kernel<2><<<blocks, kThreads, 0, st>>>(g, ldg, M, N, T, nh,
                                                      gp);
  else if (nh == 1)
    tb_split_g_kernel<1><<<blocks, kThreads, 0, st>>>(g, ldg, M, N, T, nh,
                                                      gp);
  else
    tb_split_g_kernel<0><<<blocks, kThreads, 0, st>>>(g, ldg, M, N, T, nh,
                                                      gp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cunet_tb_fill_table(const void* host_tbl, int G, void* tbl,
                        void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* host = static_cast<const long long*>(host_tbl);
  auto* dev = static_cast<long long*>(tbl);
  for (int g0 = 0; g0 < G; g0 += kFillGroups) {
    const int ng = G - g0 < kFillGroups ? G - g0 : kFillGroups;
    TblChunk c;
    memcpy(c.v, host + (long long)g0 * kTblCols,
           sizeof(long long) * ng * kTblCols);
    fill_table_kernel<<<1, 128, 0, st>>>(dev + (long long)g0 * kTblCols, c,
                                         ng * kTblCols);
  }
  return (int)cudaGetLastError();
}

// The statistics kernel over bf16 features: float32 chunk partials at part
// (train_ops.sum_rows adds them); the reduce and dx kernels over bf16
// features and cotangent (their float32 forms: cunet_tb_bwd_reduce_f32,
// cunet_tb_bwd_dx_f32); every other operand is float32.
int cunet_tb_stats(const void* tbl, int G, long long M, int Ctot,
                   long long chunk, void* part, void* stream) {
  return stats(tbl, G, M, Ctot, chunk, part, stream);
}

// Over float32 features: float64 chunk partials at part64 (S, 2, Ctot),
// their sum into out (2, Ctot); two launches.
int cunet_tb_stats_f32(const void* tbl, int G, long long M, int Ctot,
                       long long chunk, void* part64, void* out,
                       void* stream) {
  return stats_f32(tbl, G, M, Ctot, chunk, part64, out, stream);
}

// Past kWideN outputs W is split first into its slice images at ws
// (halo.cuh split_w_slices, rows of kSliceN + 8; the caller's,
// ceil(Ctot / 64) * ceil(N / 128) * 3 * 64 * 136 bf16).
int cunet_tb_bwd_reduce(const void* tbl, int G, long long M, int Ctot,
                        const void* g, long long ldg, int N, const void* stat,
                        const void* bias, const void* w, void* ws,
                        long long chunk, int np, int stages, int stat_off,
                        int stage_off, int stage_bytes, int g_off, int pl_off,
                        int xh_off, int w_off, int smem, void* dw_part,
                        void* sums_part, void* stream) {
  const RdPlan p{chunk, np, stages, stat_off, stage_off, stage_bytes, g_off,
                 pl_off, xh_off, w_off};
  return bwd_reduce(tbl, G, M, Ctot, g, ldg, N, stat, bias, w, ws, p, smem,
                    dw_part, sums_part, stream);
}

// The reduce over float32 features and g: g split into its planes at gp
// (3 x ceil(M / 64) x nh x 64 x 128 bf16, nh = ceil(N / 128) halves, the
// caller's), then the reduce in row chunks of ``chunk``
// (train_bottleneck.reduce_plan_f32; ``smem`` checked against the
// kernel's layout). Past kRfMaxN outputs W is split first into its slice
// images at ws (halo.cuh split_w_slices, core matrices; the caller's,
// ceil(Ctot / 64) * nh * 3 * 64 * 128 bf16), which the reduce stages.
int cunet_tb_bwd_reduce_f32(const void* tbl, int G, long long M, int Ctot,
                            const void* g, long long ldg, int N,
                            const void* stat, const void* bias,
                            const void* w, void* gp, void* ws,
                            long long chunk, int np, int smem, void* dw_part,
                            void* sums_part, void* stream) {
  const RfLayout l = rf_layout(np);
  const bool stream_w = np > kRfMaxN;
  if (N % 8 || np % 16 || np < N || np - N >= 16 || (stream_w && !ws) ||
      chunk % kRfRows || chunk < 1 || l.bytes != smem)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  auto* planes = static_cast<bf16*>(gp);
  const long long T = (M + kRfRows - 1) / kRfRows;
  const int nh = (np + kRfN - 1) / kRfN;
  const int e = split_g(static_cast<const float*>(g), ldg, M, N, planes, st);
  if (e) return e;
  const auto* tp = static_cast<const long long*>(tbl);
  const auto* sp = static_cast<const float*>(stat);
  const auto* bp = static_cast<const float*>(bias);
  const auto* wp = static_cast<const float*>(w);
  auto* dp = static_cast<float*>(dw_part);
  auto* rp = static_cast<float*>(sums_part);
  auto* wsp = static_cast<bf16*>(ws);
  if (stream_w) {
    const int e2 = split_w_slices(wp, N, Ctot, N, true, wsp, st);
    if (e2) return e2;
    return launch_bwd_reduce_f32<kRfN / 16, true, true>(
        tp, G, M, Ctot, planes, T, N, sp, bp, wp, wsp, chunk, l, dp, rp, st);
  }
  if (nh == 2)
    return launch_bwd_reduce_f32<kRfN / 16, true>(tp, G, M, Ctot, planes, T,
                                                  N, sp, bp, wp, wsp, chunk,
                                                  l, dp, rp, st);
  switch (np / 16) {
#define CUNET_RF(n)                                                        \
  case n:                                                                  \
    return launch_bwd_reduce_f32<n, false>(tp, G, M, Ctot, planes, T, N,  \
                                           sp, bp, wp, wsp, chunk, l, dp, \
                                           rp, st);
    CUNET_RF(1) CUNET_RF(2) CUNET_RF(3) CUNET_RF(4) CUNET_RF(5) CUNET_RF(6)
    CUNET_RF(7) CUNET_RF(8)
#undef CUNET_RF
  }
  return (int)cudaErrorInvalidValue;
}

// g (M, N) float32 split into its three planes at gp, the reduce's
// pre-pass alone (bwd_dx's float32 form called without the reduce's
// planes).
int cunet_tb_split_g(const void* g, long long ldg, long long M, int N,
                     void* gp, void* stream) {
  if (N % 8 || N < 8) return (int)cudaErrorInvalidValue;
  return split_g(static_cast<const float*>(g), ldg, M, N,
                 static_cast<bf16*>(gp), static_cast<cudaStream_t>(stream));
}

// Past kWideN outputs W is split first into its slice images at ws
// (halo.cuh split_w_slices, rows of kSliceN + 8; the caller's,
// ceil(Ctot / 64) * ceil(N / 128) * 3 * 64 * 136 bf16).
int cunet_tb_bwd_dx(const void* tbl, int G, long long M, int Ctot,
                    const void* g, long long ldg, int N, const void* stat,
                    const void* bias, const void* red, const void* w,
                    void* ws, int ngrp, int np, int tbl_off, int stage_off,
                    int stage_bytes, int g_off, int w_off, int smem,
                    void* stream) {
  const DxPlan p{ngrp, np, tbl_off, stage_off, stage_bytes, g_off, w_off};
  const bool stream_w = np > kWideN;
  if (stream_w && !ws) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (stream_w) {
    const int e = split_w_slices(static_cast<const float*>(w), N, Ctot, N,
                                 false, static_cast<bf16*>(ws), st);
    if (e) return e;
  }
  const int items = (int)((M + kDxRows - 1) / kDxRows) * p.ngrp;
  auto kern = stream_w ? tb_bwd_dx_kernel<true> : tb_bwd_dx_kernel<false>;
  int grid = 0;
  const int e = persistent_grid(kern, items, kThreads, smem, p.ngrp, &grid);
  if (e) return e;
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const long long*>(tbl), G, (int)M, Ctot,
      static_cast<const bf16*>(g), ldg, N, static_cast<const float*>(stat),
      static_cast<const float*>(bias), static_cast<const float*>(red),
      static_cast<const float*>(w), static_cast<const bf16*>(ws), p);
  return (int)cudaGetLastError();
}

}  // extern "C"
