// Hand-written Hopper kernels of the train-mode concat-free dense bottleneck
//   out = sum_k bf16(relu(bn_k(x_k))) @ bf16(W_k)    (BN with batch stats)
// and its recompute backward (cunet_tpu_torch/kernels/train_bottleneck.py
// wraps them and holds the autograd Function). They replace the four
// pallas_calls of cunet_tpu/kernels/train_bottleneck.py::
// fused_train_bottleneck:
//   tb_stats      <- _stats_kernel      (:49, called at :173)
//   tb_apply      <- _apply_kernel      (:66, called at :208)
//   tb_bwd_reduce <- _bwd_reduce_kernel (:92, called at :268)
//   tb_bwd_dx     <- _bwd_dx_kernel     (:134, called at :296)
//
// The features arrive as separate tensors (an up-block adapter reads
// [x, skip, fifo, out]): every kernel reads them through a feature table in
// device memory, one row of kTblCols int64 per group,
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
// order: no atomics, and two identical calls give identical bits.
//
// The backward's products keep the TPU kernel's float32 precision (dW =
// r^T g and g_r = g W^T with the unrounded f32 W): one TF32 or bf16
// tensor-core pass would move them by ~1e-3, outside the f32 bounds the
// port holds them to. tb_bwd_reduce runs both on the tensor cores through
// an exact three-way bf16 split of the f32 operand (three bf16 passes:
// float32 sums of exact products); tb_bwd_dx still runs g W^T as float32
// FMA on the CUDA cores (64 x 64 output tiles, 4 x 4 per thread). The BN
// recompute rounds after every operation, in the plain version's order,
// so the ReLU gate is the same bit for bit.
//
// Each entry point launches on the stream it is given and returns
// cudaGetLastError().

#include <string.h>

#include "halo.cuh"

namespace {

constexpr int kTblCols = 6;
constexpr int kFillGroups = 16;
constexpr int kStatRows = 32;   // row stripes of a statistics block
constexpr int kStatCols = 64;   // channels of a statistics block
constexpr int kT = 64;          // rows and columns of an f32 SIMT tile
constexpr int kD = 16;          // depth of one shared-memory stage

struct TblChunk {
  long long v[kFillGroups * kTblCols];
};

__global__ void fill_table_kernel(long long* __restrict__ dst, TblChunk c,
                                  int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = c.v[i];
}

// The group of concat column k (the last group whose offset is <= k).
__device__ __forceinline__ const long long* group_of(
    const long long* __restrict__ tbl, int G, int k) {
  int g = 0;
  while (g + 1 < G && k >= (int)tbl[(g + 1) * kTblCols + 3]) ++g;
  return tbl + g * kTblCols;
}

// Where column k of the concat lives: (row 0 of it, row stride).
struct ColRef {
  const bf16* x;
  long long ld;
};

__device__ __forceinline__ ColRef col_ref(const long long* __restrict__ tbl,
                                          int G, int k) {
  const long long* t = group_of(tbl, G, k);
  return {reinterpret_cast<const bf16*>(t[0]) + (k - t[3]), t[1]};
}

// The BN recompute of the backward, one rounding per operation (the plain
// version's elementwise ops): x_hat = (x - mean) * inv_sigma,
// y = x_hat * scale + bias.
__device__ __forceinline__ float xhat_of(float x, float mu, float is) {
  return __fmul_rn(__fsub_rn(x, mu), is);
}

__device__ __forceinline__ float ybn_of(float xh, float sc, float b) {
  return __fadd_rn(__fmul_rn(xh, sc), b);
}

// ---------------------------------------------------------------------------
// tb_stats: part[s, 0, k] = sum, part[s, 1, k] = sum of squares of column k
// of the concat over rows [s*chunk, (s+1)*chunk) (float32). Grid (S,
// ceil(Ctot/64)); a block's 256 threads are 8 column vectors x 32 row
// stripes, reduced in a fixed order in shared memory.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    tb_stats_kernel(const long long* __restrict__ tbl, int G, long long M,
                    int Ctot, long long chunk, float* __restrict__ part) {
  __shared__ float red[2][kStatRows][kStatCols];
  const int cv = threadIdx.x % 8, rs = threadIdx.x / 8;
  const int k = blockIdx.y * kStatCols + cv * 8;
  const long long rb = (long long)blockIdx.x * chunk;
  const long long re = rb + chunk < M ? rb + chunk : M;
  float s[8], q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = q[i] = 0.f;
  if (k < Ctot) {
    const ColRef c = col_ref(tbl, G, k);
    for (long long r = rb + rs; r < re; r += kStatRows) {
      Pack8 p;
      p.v = *reinterpret_cast<const uint4*>(c.x + r * c.ld);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float v = lo(p, i);
        s[i] += v;
        q[i] += v * v;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    red[0][rs][cv * 8 + i] = s[i];
    red[1][rs][cv * 8 + i] = q[i];
  }
  __syncthreads();
  if (threadIdx.x < 2 * kStatCols) {
    const int which = threadIdx.x / kStatCols, col = threadIdx.x % kStatCols;
    const int kk = blockIdx.y * kStatCols + col;
    float a = 0.f;
    for (int i = 0; i < kStatRows; ++i) a += red[which][i][col];
    if (kk < Ctot) part[((long long)blockIdx.x * 2 + which) * Ctot + kk] = a;
  }
}

// ---------------------------------------------------------------------------
// tb_apply: out[m, n] = sum_k bf16(relu(x[m,k]*inv[k] + shift[k])) w[k, n],
// the affine in float32 (whatever the model's bn_dtype: the TPU kernel's
// arithmetic), bf16 WMMA with float32 accumulators, one bf16 rounding of
// the result. The first, WMMA design of affine_dot (common.cuh's Smem,
// mma_stage, load_b, store_tile; affine_dot itself has since moved to
// persistent mma.sync blocks): 128-row tiles over the full N, the prologue
// between the 16-byte global load and the bf16 shared-memory tile, with
// each A vector read from its group's tensor.
// ---------------------------------------------------------------------------
template <int BN, int WARPS_N>
__global__ void __launch_bounds__(kThreads)
    tb_apply_kernel(const long long* __restrict__ tbl, int G, long long M,
                    int Ctot, const float* __restrict__ inv,
                    const float* __restrict__ shift,
                    const bf16* __restrict__ w, int N, OutView out) {
  using T = Tiles<BN, WARPS_N>;
  __shared__ Smem<BN, WARPS_N> s;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::FM][T::FN];
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < Ctot; k0 += BK) {
    for (int c = threadIdx.x; c < BM * BK / 8; c += kThreads) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const long long m = m0 + r;
      const int k = k0 + kc;
      Pack8 o;
      o.v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M && k < Ctot) {
        const ColRef cr = col_ref(tbl, G, k);
        Pack8 in;
        in.v = *reinterpret_cast<const uint4*>(cr.x + m * cr.ld);
#pragma unroll
        for (int t = 0; t < 8; ++t)
          o.u[t] = act(lo(in, t), inv[k + t], shift[k + t], 0);
      }
      *reinterpret_cast<uint4*>(&s.a[r][kc]) = o.v;
    }
    load_b(s, w, N, k0, Ctot, n0, N);
    __syncthreads();
    mma_stage(s, wm, wn, acc);
    __syncthreads();
  }
  store_tile<BN, WARPS_N, false>(s, wm, wn, m0, n0, M, N, nullptr, out, acc);
}

// ---------------------------------------------------------------------------
// The float32 SIMT tile of tb_bwd_dx: 64 x 64 outputs per
// block, thread (ty, tx) owning rows ty*4.. and columns tx*4.., the depth
// walked in kD-deep stages through shared memory (a[d][row], b[d][col]).
// ---------------------------------------------------------------------------
struct F32Smem {
  __align__(16) float a[kD][kT + 4];
  __align__(16) float b[kD][kT + 4];
};

__device__ __forceinline__ void zero_acc(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

__device__ __forceinline__ void f32_stage(const F32Smem& s, int ty, int tx,
                                          float (&acc)[4][4]) {
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(&s.a[d][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&s.b[d][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] = g_r[r0 + ty*4 + i, k0 + tx*4 + j] = sum_n g[r, n] w[k, n]:
// the cotangent through the 1x1 conv, against the unrounded f32 weight.
__device__ __forceinline__ void gw_tile(F32Smem& s,
                                        const bf16* __restrict__ g,
                                        long long ldg, long long M, int N,
                                        const float* __restrict__ w, int Ctot,
                                        long long r0, int k0,
                                        float (&acc)[4][4]) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  zero_acc(acc);
  for (int n0 = 0; n0 < N; n0 += kD) {
    if (tid < 128) {            // a[d][r] = g[r0 + r, n0 + d]
      const int r = tid / 2, dv = (tid % 2) * 8;
      const long long m = r0 + r;
      Pack8 p;
      p.v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M && n0 + dv < N)
        p.v = *reinterpret_cast<const uint4*>(g + m * ldg + n0 + dv);
#pragma unroll
      for (int t = 0; t < 8; ++t) s.a[dv + t][r] = lo(p, t);
    } else {                    // b[d][c] = w[k0 + c, n0 + d]
      for (int i = tid - 128; i < kT * kD / 4; i += 128) {
        const int c = i / (kD / 4), dv = (i % (kD / 4)) * 4;
        const int k = k0 + c, n = n0 + dv;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k < Ctot && n < N)
          v = *reinterpret_cast<const float4*>(w + (long long)k * N + n);
        s.b[dv][c] = v.x;
        s.b[dv + 1][c] = v.y;
        s.b[dv + 2][c] = v.z;
        s.b[dv + 3][c] = v.w;
      }
    }
    __syncthreads();
    f32_stage(s, ty, tx, acc);
    __syncthreads();
  }
}

// Four bf16 values of row m at a thread's four columns (8-byte load).
__device__ __forceinline__ void load4(const ColRef& c, long long m,
                                      float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(c.x + m * c.ld);
  v[0] = __bfloat162float(__ushort_as_bfloat16((unsigned short)(u.x & 0xFFFF)));
  v[1] = __bfloat162float(__ushort_as_bfloat16((unsigned short)(u.x >> 16)));
  v[2] = __bfloat162float(__ushort_as_bfloat16((unsigned short)(u.y & 0xFFFF)));
  v[3] = __bfloat162float(__ushort_as_bfloat16((unsigned short)(u.y >> 16)));
}

// Per-column BN constants of the backward at column k: mean, inv_sigma,
// scale (stat rows 0-2) and bias.
struct BnCol {
  float mu[4], is[4], sc[4], b[4];
};

__device__ __forceinline__ void bn_col(const float* __restrict__ stat,
                                       const float* __restrict__ bias,
                                       int Ctot, int k, BnCol& c) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    c.mu[j] = stat[k + j];
    c.is[j] = stat[Ctot + k + j];
    c.sc[j] = stat[2 * Ctot + k + j];
    c.b[j] = bias[k + j];
  }
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
// (any normal v), and each bf16 x bf16 product is exact in the f32 sum. g
// is bf16 already, so dW = sum_i p_i(r)^T g and g W^T = sum_i g p_i(W)^T
// agree with float32 FMA to float32 rounding, in another order. The block:
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
  int xh_off;       //   the gated x_hat
};

// v = p1 + p2 + p3, three bf16 pieces (exact for normal float32 v)
__device__ __forceinline__ void split3(float v, unsigned short& a,
                                       unsigned short& b, unsigned short& c) {
  const bf16 p1 = __float2bfloat16(v);
  const float r1 = __fsub_rn(v, __bfloat162float(p1));
  const bf16 p2 = __float2bfloat16(r1);
  const float r2 = __fsub_rn(r1, __bfloat162float(p2));
  a = __bfloat16_as_ushort(p1);
  b = __bfloat16_as_ushort(p2);
  c = __bfloat16_as_ushort(__float2bfloat16(r2));
}

template <int NB8>
__global__ void __launch_bounds__(kRdThreads, 2)
    tb_bwd_reduce_kernel(const long long* __restrict__ tbl, int G,
                         long long M, int Ctot, const bf16* __restrict__ g,
                         long long ldg, int N, const float* __restrict__ stat,
                         const float* __restrict__ bias,
                         const float* __restrict__ w, RdPlan p,
                         float* __restrict__ dw_part,
                         float* __restrict__ sums_part) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int XS = kRdCols + 8;       // x / plane row stride, elements
  constexpr int HS = kRdCols + 8;       // x_hat row stride, floats
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.x * kRdCols;
  const long long rb = (long long)blockIdx.y * p.chunk;
  const long long re = rb + p.chunk < M ? rb + p.chunk : M;
  const int nsteps = (int)((re - rb + kRdRows - 1) / kRdRows);
  const int np = p.np, gs = np + 8;     // g / W-plane row stride, elements
  const int wpl = kRdCols * gs * 2;     // bytes of one W plane
  float* sst = reinterpret_cast<float*>(smem + p.stat_off);

  // this thread's x vector: columns c0 + xv*8 .. +7, rows xr + 32h
  const int xv = tid & 7, xr = tid >> 3;
  const int xc = c0 + xv * 8;
  ColRef xref{nullptr, 0};
  if (xc < Ctot) xref = col_ref(tbl, G, xc);

  // step st's x vectors and g rows into stage st % stages; a step past
  // the chunk commits an empty group, so group st is always step st's
  const auto issue = [&](int st) {
    if (st >= nsteps) {
      cp_async_commit();
      return;
    }
    const long long m0 = rb + (long long)st * kRdRows;
    const uint32_t base = s0 + p.stage_off + (st % p.stages) * p.stage_bytes;
#pragma unroll
    for (int h = 0; h < kRdRows / 32; ++h) {
      const int r = xr + 32 * h;
      const bool ok = xc < Ctot && m0 + r < re;
      cp_async16(base + (r * XS + xv * 8) * 2,
                 ok ? xref.x + (m0 + r) * xref.ld : g, ok ? 16 : 0);
    }
    const int gv = np / 8;
    for (int i = tid; i < kRdRows * gv; i += kRdThreads) {
      const int r = i / gv, j = i - (i / gv) * gv;
      const bool ok = m0 + r < re && j * 8 < N;
      cp_async16(base + p.g_off + (r * gs + j * 8) * 2,
                 ok ? g + (m0 + r) * ldg + j * 8 : g, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  for (int st = 0; st + 1 < p.stages; ++st) issue(st);

  // the columns' BN constants, and W's rows split into three planes once
  if (tid < kRdCols) {
    const int c = c0 + tid;
    const bool ok = c < Ctot;
    sst[tid] = ok ? stat[c] : 0.f;
    sst[kRdCols + tid] = ok ? stat[Ctot + c] : 0.f;
    sst[2 * kRdCols + tid] = ok ? stat[2 * Ctot + c] : 0.f;
    sst[3 * kRdCols + tid] = ok ? bias[c] : 0.f;
  }
  for (int i = tid; i < kRdCols * np / 4; i += kRdThreads) {
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
  const int plb = kRdRows * XS * 2;                // bytes of one r plane
  float* xh = reinterpret_cast<float*>(smem + p.xh_off);

  for (int st = 0; st < nsteps; ++st) {
    issue(st + p.stages - 1);     // into the stage step st - 1 used
    if (p.stages == 2) cp_async_wait<1>();   // step st has landed
    else cp_async_wait<0>();
    __syncthreads();
    const long long m0 = rb + (long long)st * kRdRows;
    const uint32_t sb = s0 + p.stage_off + (st % p.stages) * p.stage_bytes;
    const unsigned char* sx_ = smem + p.stage_off +
                               (st % p.stages) * p.stage_bytes;

    // the recompute, once per element: r's planes and the gated x_hat
#pragma unroll
    for (int h = 0; h < kRdRows / 32; ++h) {
      const int r = xr + 32 * h;
      const bool row_ok = m0 + r < re;
      Pack8 in, o1, o2, o3;
      in.v = *reinterpret_cast<const uint4*>(sx_ + (r * XS + xv * 8) * 2);
      float hv[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const bool ok = row_ok && xc + t < Ctot;
        const float xhat = xhat_of(lo(in, t), mu[t], is[t]);
        const float y = ybn_of(xhat, sc[t], bb[t]);
        const bool pass = ok && y > 0.f;
        split3(pass ? y : 0.f, o1.u[t], o2.u[t], o3.u[t]);
        hv[t] = pass ? xhat : __int_as_float(0x7fc00000);
      }
      const int e = (r * XS + xv * 8) * 2;
      *reinterpret_cast<uint4*>(smem + p.pl_off + e) = o1.v;
      *reinterpret_cast<uint4*>(smem + p.pl_off + plb + e) = o2.v;
      *reinterpret_cast<uint4*>(smem + p.pl_off + 2 * plb + e) = o3.v;
      float* hp = xh + r * HS + xv * 8;
      *reinterpret_cast<float4*>(hp) = make_float4(hv[0], hv[1], hv[2], hv[3]);
      *reinterpret_cast<float4*>(hp + 4) =
          make_float4(hv[4], hv[5], hv[6], hv[7]);
    }
    __syncthreads();

    // dW += sum_i p_i(r)^T g over the step's 64 rows
    const uint32_t gb_ = sb + p.g_off;
#pragma unroll
    for (int ks = 0; ks < kRdRows / 16; ++ks) {
      uint32_t b[NB8][2] = {};
#pragma unroll
      for (int jp = 0; jp < NB8 / 2; ++jp) {
        uint32_t t4[4] = {0u, 0u, 0u, 0u};
        if (nb0 + 16 * jp < np)
          ldsm_x4_t(t4, gb_ + ((ks * 16 + b_pix) * gs + nb0 + 16 * jp +
                             8 * (mat >> 1)) * 2);
        b[2 * jp][0] = t4[0];
        b[2 * jp][1] = t4[1];
        b[2 * jp + 1][0] = t4[2];
        b[2 * jp + 1][1] = t4[3];
      }
      if ((NB8 & 1) && nb0 + 8 * (NB8 - 1) < np)
        ldsm_x2_t(b[NB8 - 1][0], b[NB8 - 1][1],
                  gb_ + ((ks * 16 + b_pix) * gs + nb0 + 8 * (NB8 - 1)) * 2);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4_t(a[i], pl + k * plb + ((ks * 16 + t_pix) * XS +
                                          dc * 32 + 16 * i) * 2 + t_ofs);
#pragma unroll
        for (int j = 0; j < NB8; ++j) {
          if (nb0 + 8 * j >= np) continue;
#pragma unroll
          for (int i = 0; i < 2; ++i)
            mma16816(acc[i][j], a[i], b[j][0], b[j][1]);
        }
      }
    }

    // g W^T for the step's rows, gated; the two sums
    float gw[kRdMI][2][4];
#pragma unroll
    for (int i = 0; i < kRdMI; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) gw[i][j][e] = 0.f;
    for (int kk = 0; kk < np / 16; ++kk) {
      uint32_t a[kRdMI][4];
#pragma unroll
      for (int i = 0; i < kRdMI; ++i)
        ldsm_x4(a[i], gb_ + ((gr0 + 16 * i + (lane & 15)) * gs) * 2 +
                          kk * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        uint32_t b[4];
        ldsm_x4(b, s0 + k * wpl +
                       ((gc * 16 + (mat >> 1) * 8 + (lane & 7)) * gs) * 2 +
                       kk * 32 + (mat & 1) * 16);
#pragma unroll
        for (int i = 0; i < kRdMI; ++i) {
          mma16816(gw[i][0], a[i], b[0], b[1]);
          mma16816(gw[i][1], a[i], b[2], b[3]);
        }
      }
    }
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
    __syncthreads();
  }

  // the dW partial of this chunk
  float* dbase = dw_part + (long long)blockIdx.y * Ctot * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NB8; ++j) {
      const int n = nb0 + 8 * j + 2 * (lane & 3);
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
  if (lane < 4)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = gc * 16 + 8 * (e >> 1) + 2 * lane + (e & 1);
      red[(0 * 2 + gr) * kRdCols + col] = sg[e];
      red[(1 * 2 + gr) * kRdCols + col] = sx[e];
    }
  __syncthreads();
  if (tid < 2 * kRdCols) {
    const int which = tid / kRdCols, col = tid % kRdCols, c = c0 + col;
    if (c < Ctot)
      sums_part[((long long)blockIdx.y * 2 + which) * Ctot + c] =
          red[(which * 2) * kRdCols + col] +
          red[(which * 2 + 1) * kRdCols + col];
  }
}

// ---------------------------------------------------------------------------
// tb_bwd_dx: per 64-row x 64-column tile, g_r = g W^T (float32 FMA), then
//   dx = (scale * inv_sigma) * ((g_y - mean(g_y)) - x_hat * mean(g_y x_hat))
// rounded once to bf16 into the group's dx tensor (red = [mean g_y;
// mean g_y x_hat], the reduce kernel's sums over M).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    tb_bwd_dx_kernel(const long long* __restrict__ tbl, int G, long long M,
                     int Ctot, const bf16* __restrict__ g, long long ldg,
                     int N, const float* __restrict__ stat,
                     const float* __restrict__ bias,
                     const float* __restrict__ red,
                     const float* __restrict__ w) {
  __shared__ F32Smem s;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long r0 = (long long)blockIdx.x * kT;
  const int k0 = blockIdx.y * kT;
  float acc[4][4];
  gw_tile(s, g, ldg, M, N, w, Ctot, r0, k0, acc);
  const int k = k0 + tx * 4;
  if (k >= Ctot) return;
  const long long* t = group_of(tbl, G, k);
  const ColRef c{reinterpret_cast<const bf16*>(t[0]) + (k - t[3]), t[1]};
  bf16* dx = reinterpret_cast<bf16*>(t[4]) + (k - t[3]);
  const long long lddx = t[5];
  BnCol bc;
  bn_col(stat, bias, Ctot, k, bc);
  float coef[4], r0m[4], r1m[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    coef[j] = __fmul_rn(bc.sc[j], bc.is[j]);
    r0m[j] = red[k + j];
    r1m[j] = red[Ctot + k + j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = r0 + ty * 4 + i;
    if (m >= M) continue;
    float x[4];
    load4(c, m, x);
    unsigned short o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float xh = xhat_of(x[j], bc.mu[j], bc.is[j]);
      const float gy = ybn_of(xh, bc.sc[j], bc.b[j]) > 0.f ? acc[i][j] : 0.f;
      const float v = __fsub_rn(__fsub_rn(gy, r0m[j]), __fmul_rn(xh, r1m[j]));
      o[j] = hi(__fmul_rn(coef[j], v));
    }
    *reinterpret_cast<uint2*>(dx + m * lddx) =
        make_uint2(o[0] | ((unsigned)o[1] << 16), o[2] | ((unsigned)o[3] << 16));
  }
}

template <int BN, int WARPS_N>
void launch_apply(const long long* tbl, int G, long long M, int Ctot,
                  const float* inv, const float* shift, const bf16* w, int N,
                  OutView out, cudaStream_t st) {
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  tb_apply_kernel<BN, WARPS_N><<<grid, kThreads, 0, st>>>(
      tbl, G, M, Ctot, inv, shift, w, N, out);
}

template <int NB8>
int launch_bwd_reduce(const long long* tbl, int G, long long M, int Ctot,
                      const bf16* g, long long ldg, int N, const float* stat,
                      const float* bias, const float* w, const RdPlan& p,
                      float* dw_part, float* sums_part, int smem,
                      cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      tb_bwd_reduce_kernel<NB8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((Ctot + kRdCols - 1) / kRdCols),
                  (unsigned)((M + p.chunk - 1) / p.chunk));
  tb_bwd_reduce_kernel<NB8><<<grid, kRdThreads, smem, st>>>(
      tbl, G, M, Ctot, g, ldg, N, stat, bias, w, p, dw_part, sums_part);
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

int cunet_tb_stats(const void* tbl, int G, long long M, int Ctot,
                   long long chunk, void* part, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((M + chunk - 1) / chunk),
                  (unsigned)((Ctot + kStatCols - 1) / kStatCols));
  tb_stats_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const long long*>(tbl), G, M, Ctot, chunk,
      static_cast<float*>(part));
  return (int)cudaGetLastError();
}

int cunet_tb_apply(const void* tbl, int G, long long M, int Ctot,
                   const void* inv, const void* shift, const void* w, int N,
                   void* out, long long ldo, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* tp = static_cast<const long long*>(tbl);
  const OutView ov{static_cast<bf16*>(out), ldo, M, 0};
  const auto* ip = static_cast<const float*>(inv);
  const auto* sp = static_cast<const float*>(shift);
  const auto* wp = static_cast<const bf16*>(w);
  if (N <= 16)
    launch_apply<16, 1>(tp, G, M, Ctot, ip, sp, wp, N, ov, st);
  else if (N <= 32)
    launch_apply<32, 2>(tp, G, M, Ctot, ip, sp, wp, N, ov, st);
  else if (N <= 64)
    launch_apply<64, 2>(tp, G, M, Ctot, ip, sp, wp, N, ov, st);
  else
    launch_apply<128, 2>(tp, G, M, Ctot, ip, sp, wp, N, ov, st);
  return (int)cudaGetLastError();
}

int cunet_tb_bwd_reduce(const void* tbl, int G, long long M, int Ctot,
                        const void* g, long long ldg, int N, const void* stat,
                        const void* bias, const void* w, long long chunk,
                        int np, int stages, int stat_off, int stage_off,
                        int stage_bytes, int g_off, int pl_off, int xh_off,
                        int smem, void* dw_part, void* sums_part,
                        void* stream) {
  const RdPlan p{chunk, np, stages, stat_off, stage_off, stage_bytes, g_off,
                 pl_off, xh_off};
  const auto* tp = static_cast<const long long*>(tbl);
  const auto* gp = static_cast<const bf16*>(g);
  const auto* sp = static_cast<const float*>(stat);
  const auto* bp = static_cast<const float*>(bias);
  const auto* wp = static_cast<const float*>(w);
  auto* dp = static_cast<float*>(dw_part);
  auto* rp = static_cast<float*>(sums_part);
  const auto st = static_cast<cudaStream_t>(stream);
  switch ((np + 31) / 32) {
#define CUNET_RD_NB8(n)                                                     \
  case n:                                                                   \
    return launch_bwd_reduce<n>(tp, G, M, Ctot, gp, ldg, N, sp, bp, wp, p, \
                                dp, rp, smem, st);
    CUNET_RD_NB8(1) CUNET_RD_NB8(2) CUNET_RD_NB8(3) CUNET_RD_NB8(4)
    CUNET_RD_NB8(5) CUNET_RD_NB8(6) CUNET_RD_NB8(7) CUNET_RD_NB8(8)
#undef CUNET_RD_NB8
  }
  return (int)cudaErrorInvalidValue;
}

int cunet_tb_bwd_dx(const void* tbl, int G, long long M, int Ctot,
                    const void* g, long long ldg, int N, const void* stat,
                    const void* bias, const void* red, const void* w,
                    void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((M + kT - 1) / kT),
                  (unsigned)((Ctot + kT - 1) / kT));
  tb_bwd_dx_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const long long*>(tbl), G, M, Ctot,
      static_cast<const bf16*>(g), ldg, N, static_cast<const float*>(stat),
      static_cast<const float*>(bias), static_cast<const float*>(red),
      static_cast<const float*>(w));
  return (int)cudaGetLastError();
}

}  // extern "C"
