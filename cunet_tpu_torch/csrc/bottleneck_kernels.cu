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
// The backward's two products run in float32 on the CUDA cores, as the TPU
// kernel computes them (dW = r^T g and g_r = g W^T with the unrounded f32
// W): tensor cores in TF32 or bf16 would move them by ~1e-3, outside the
// f32 bounds the port holds them to. Each is a 64 x 64 output tile per
// block, 4 x 4 per thread, 16-deep shared-memory stages. The BN recompute
// rounds after every operation, in the plain version's order, so the ReLU
// gate is the same bit for bit.
//
// Each entry point launches on the stream it is given and returns
// cudaGetLastError().

#include <string.h>

#include "common.cuh"

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
// the result. The affine_dot design of buf_kernels.cu (128-row tiles over
// the full N, the prologue between the 16-byte global load and the bf16
// shared-memory tile), with each A vector read from its group's tensor.
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
// The float32 SIMT tile of both backward kernels: 64 x 64 outputs per
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
// tb_bwd_reduce, one launch with two kinds of block over row chunk s of
// ``chunk`` rows and concat columns [k0, k0+64):
//  z <  nz-1: dW_part[s, k, n] = sum_m r[m,k] g[m,n] for n in [64z, 64z+64),
//             r = relu(y) recomputed from x in the stage prologue;
//  z == nz-1: sums_part[s] = [sum g_y; sum g_y * x_hat] per column, with
//             g_y = [y > 0] (g W^T), walking the chunk in 64-row tiles.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    tb_bwd_reduce_kernel(const long long* __restrict__ tbl, int G,
                         long long M, int Ctot, const bf16* __restrict__ g,
                         long long ldg, int N, const float* __restrict__ stat,
                         const float* __restrict__ bias,
                         const float* __restrict__ w, long long chunk,
                         float* __restrict__ dw_part,
                         float* __restrict__ sums_part) {
  __shared__ F32Smem s;
  __shared__ float red[2][16][kT];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long rb = (long long)blockIdx.x * chunk;
  const long long re = rb + chunk < M ? rb + chunk : M;
  const int k0 = blockIdx.y * kT;
  float acc[4][4];

  if (blockIdx.z + 1 < gridDim.z) {
    // ---- dW tile: rows k of the concat, columns n of the output ----
    const int n0 = blockIdx.z * kT;
    zero_acc(acc);
    // the prologue thread's column vector (threads < 128) and its constants
    const int pd = tid / 8, pk = k0 + (tid % 8) * 8;
    const bool pro = tid < 128 && pk < Ctot;
    ColRef pc{nullptr, 0};
    float mu[8], is[8], sc[8], b[8];
    if (pro) {
      pc = col_ref(tbl, G, pk);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        mu[t] = stat[pk + t];
        is[t] = stat[Ctot + pk + t];
        sc[t] = stat[2 * Ctot + pk + t];
        b[t] = bias[pk + t];
      }
    }
    for (long long rr = rb; rr < re; rr += kD) {
      if (tid < 128) {          // a[d][k] = r[rr + d, k0 + k]
        float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        const long long m = rr + pd;
        if (pro && m < re) {
          Pack8 p;
          p.v = *reinterpret_cast<const uint4*>(pc.x + m * pc.ld);
#pragma unroll
          for (int t = 0; t < 8; ++t)
            o[t] = fmaxf(ybn_of(xhat_of(lo(p, t), mu[t], is[t]), sc[t], b[t]),
                         0.f);
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) s.a[pd][(tid % 8) * 8 + t] = o[t];
      } else {                  // b[d][n] = g[rr + d, n0 + n]
        const int i = tid - 128, d = i / 8, nv = (i % 8) * 8;
        const long long m = rr + d;
        Pack8 p;
        p.v = make_uint4(0u, 0u, 0u, 0u);
        if (m < re && n0 + nv < N)
          p.v = *reinterpret_cast<const uint4*>(g + m * ldg + n0 + nv);
#pragma unroll
        for (int t = 0; t < 8; ++t) s.b[d][nv + t] = lo(p, t);
      }
      __syncthreads();
      f32_stage(s, ty, tx, acc);
      __syncthreads();
    }
    float* base = dw_part + (long long)blockIdx.x * Ctot * N;
    const int n = n0 + tx * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + ty * 4 + i;
      if (k < Ctot && n < N)
        *reinterpret_cast<float4*>(base + (long long)k * N + n) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    return;
  }

  // ---- the two BN sums of columns k0 + tx*4 .. +3 over the chunk ----
  const int k = k0 + tx * 4;
  const bool on = k < Ctot;
  ColRef c{nullptr, 0};
  BnCol bc;
  if (on) {
    c = col_ref(tbl, G, k);
    bn_col(stat, bias, Ctot, k, bc);
  }
  float sg[4] = {0.f, 0.f, 0.f, 0.f}, sx[4] = {0.f, 0.f, 0.f, 0.f};
  for (long long r0 = rb; r0 < re; r0 += kT) {
    gw_tile(s, g, ldg, re, N, w, Ctot, r0, k0, acc);
    if (!on) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long m = r0 + ty * 4 + i;
      if (m >= re) continue;
      float x[4];
      load4(c, m, x);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xh = xhat_of(x[j], bc.mu[j], bc.is[j]);
        const float gy = ybn_of(xh, bc.sc[j], bc.b[j]) > 0.f ? acc[i][j] : 0.f;
        sg[j] += gy;
        sx[j] += __fmul_rn(gy, xh);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[0][ty][tx * 4 + j] = sg[j];
    red[1][ty][tx * 4 + j] = sx[j];
  }
  __syncthreads();
  if (tid < 2 * kT) {
    const int which = tid / kT, col = tid % kT, kk = k0 + col;
    float a = 0.f;
    for (int i = 0; i < 16; ++i) a += red[which][i][col];
    if (kk < Ctot)
      sums_part[((long long)blockIdx.x * 2 + which) * Ctot + kk] = a;
  }
}

// ---------------------------------------------------------------------------
// tb_bwd_dx: per 64-row x 64-column tile, g_r = g W^T again, then
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
                        void* dw_part, void* sums_part, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((M + chunk - 1) / chunk),
                  (unsigned)((Ctot + kT - 1) / kT),
                  (unsigned)((N + kT - 1) / kT + 1));
  tb_bwd_reduce_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const long long*>(tbl), G, M, Ctot,
      static_cast<const bf16*>(g), ldg, N, static_cast<const float*>(stat),
      static_cast<const float*>(bias), static_cast<const float*>(w), chunk,
      static_cast<float*>(dw_part), static_cast<float*>(sums_part));
  return (int)cudaGetLastError();
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
