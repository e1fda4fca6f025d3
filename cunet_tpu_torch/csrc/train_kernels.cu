// Hand-written Hopper kernels of the CU-Net slot TRAIN step: the ghost-BN
// statistics of the forward and every kernel of the recompute backward
// (cunet_tpu_torch/kernels/train_ops.py wraps them, kernels/train_slot.py
// drives them). They replace the in-kernel jnp pieces of the TPU kernels
// cunet_tpu/kernels/train_slot.py::slot_train_fwd / slot_train_bwd:
//   bn_stats      <- _stats                   (per-tile mean, biased var)
//   dx (1x1)      <- _dot_dx + relu mask of _affine_bwd
//   conv3x3_dx    <- the d_z2 half of _conv3x3_bwd (halo tiles of dy,
//                    flipped taps of the resident weight, mma.sync)
//   dw (1x1)      <- _dot_dw
//   conv3x3_dw    <- the dW3 half of _conv3x3_bwd (halo tiles, mma.sync)
//   bn_bwd        <- the BN-jacobian of _affine_bwd (two sums per tile)
//   maxpool2_bwd  <- _pool_bwd (first-winner routing)
//   upsample2_bwd <- _upsample_bwd (2x2 sum)
//   sum_rows      <- the f32 accumulation across TPU grid steps (_mk_acc)
//   drop_mask     <- the dropout mask of _seed_mask applied to an out32
//                    (forward) or to its cotangent (backward)
//   threefry_mask <- the precomputed threefry masks (drop="masks") applied
//                    to an out32 (:296-299) or its cotangent (:949-951)
// and, as options of dx / dw, QuanInput's straight-through gate
// (_ste_mask) and quantizer (_quan).
//
// On a TPU the grid walks the batch tiles in order and carries weight-grad
// sums in VMEM from one step to the next. Here blocks run in no order, so
// every reduction over rows (BN sums, dW) is written as per-block f32
// partials and summed by a second pass in a fixed order: two identical
// steps give bit-identical gradients (no float atomics anywhere).
//
// Operands are strided 2-D views (row stride in elements, unit column
// stride, 16-byte aligned, widths multiples of 8), as in buf_kernels.cu.
// bn_stats, bn_bwd, maxpool2_bwd and upsample2_bwd also take float32
// stage inputs (a float32 model's ghost-BN training): bn_bwd and the two
// pool kernels are templates on the element type, whose bf16 instances are
// the kernels they were, and where a tile's rows do not fit a portable
// cluster (r=64) bn_bwd runs a persistent float32 kernel of its own
// (bn_bwd_f32_kernel); bn_stats a float32 kernel of its own (one pass)
// beside the bf16 one; the float32 products of that step are in
// f32_kernels.cu and the *_f32_kernels.cu sources.
// Each entry point launches on the stream it is given and returns
// cudaGetLastError().

#include <cooperative_groups.h>

#include "halo.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kStatRows = 32;   // row stripes of a per-tile reduction block
constexpr int kStatCols = 64;   // channels of a per-tile reduction block

__device__ __forceinline__ void load8f(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8f(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// Eight consecutive values of a row of T (bf16 or float32) as float32: one
// 16-byte load of bf16, two of float32. The kernels below that take either
// element type (bn_bwd, maxpool2_bwd, upsample2_bwd) read their
// rows through it; the bf16 form is one Pack8.
template <typename T>
struct Row8;

template <>
struct Row8<bf16> {
  Pack8 p;
  __device__ __forceinline__ void load(const bf16* a) {
    p.v = *reinterpret_cast<const uint4*>(a);
  }
  __device__ __forceinline__ float operator[](int i) const { return lo(p, i); }
};

template <>
struct Row8<float> {
  float f[8];
  __device__ __forceinline__ void load(const float* a) { load8f(a, f); }
  __device__ __forceinline__ float operator[](int i) const { return f[i]; }
};

// Eight float32 values to a row of T: rounded once to bf16, or as they are.
template <typename T>
__device__ __forceinline__ void store_row8(T* p, const float (&v)[8]) {
  if constexpr (sizeof(T) == 4) {
    store8f(p, v);
  } else {
    Pack8 o;
#pragma unroll
    for (int i = 0; i < 8; ++i) o.u[i] = hi(v[i]);
    *reinterpret_cast<uint4*>(p) = o.v;
  }
}

// ---------------------------------------------------------------------------
// F1 bn_stats: out[t, 0, k] = mean, out[t, 1, k] = biased variance of
// x[t*tile_rows : (t+1)*tile_rows, k], two passes (mean, then centred
// squares) as _stats computes them. Grid (T, ceil(K/64)); a block's 256
// threads are 8 channel vectors x 32 row stripes, reduced in a fixed order.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    bn_stats_kernel(const bf16* __restrict__ x, long long ldx,
                    long long tile_rows, int K, float* __restrict__ out) {
  __shared__ float red[kStatRows][kStatCols];
  __shared__ float mean_s[kStatCols];
  const int t = blockIdx.x;
  const int cv = threadIdx.x % 8, rs = threadIdx.x / 8;
  const int k = blockIdx.y * kStatCols + cv * 8;
  const bool on = k < K;
  const bf16* base = x + (long long)t * tile_rows * ldx + k;

  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  if (on)
    for (long long r = rs; r < tile_rows; r += kStatRows) {
      Pack8 p;
      p.v = *reinterpret_cast<const uint4*>(base + r * ldx);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += lo(p, i);
    }
#pragma unroll
  for (int i = 0; i < 8; ++i) red[rs][cv * 8 + i] = acc[i];
  __syncthreads();
  if (threadIdx.x < kStatCols) {
    float s = 0.f;
    for (int i = 0; i < kStatRows; ++i) s += red[i][threadIdx.x];
    mean_s[threadIdx.x] = s / (float)tile_rows;
  }
  __syncthreads();

  float mu[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mu[i] = mean_s[cv * 8 + i];
    acc[i] = 0.f;
  }
  if (on)
    for (long long r = rs; r < tile_rows; r += kStatRows) {
      Pack8 p;
      p.v = *reinterpret_cast<const uint4*>(base + r * ldx);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = lo(p, i) - mu[i];
        acc[i] += d * d;
      }
    }
#pragma unroll
  for (int i = 0; i < 8; ++i) red[rs][cv * 8 + i] = acc[i];
  __syncthreads();
  if (threadIdx.x < kStatCols) {
    const int kk = blockIdx.y * kStatCols + threadIdx.x;
    float s = 0.f;
    for (int i = 0; i < kStatRows; ++i) s += red[i][threadIdx.x];
    if (kk < K) {
      out[((long long)t * 2) * K + kk] = mean_s[threadIdx.x];
      out[((long long)t * 2 + 1) * K + kk] = s / (float)tile_rows;
    }
  }
}

// ---------------------------------------------------------------------------
// F1 bn_stats at float32 (a float32 model's stage inputs): one pass of
// shifted sums, x read once. A tile's rows are split across a cluster of
// cs blocks along y (rank q owns rows [q*rpb, (q+1)*rpb); the plan is the
// wrapper's, kernels/train_ops.py::stats_plan_f32); a thread of a block's
// 8 channel vectors x 32 row stripes sums d = x - x0 and d^2 over its
// rows, x0 the mean of the tile's first kStatUnroll rows cut to 8
// significant bits: near the data, so E[d^2] - E[d]^2 does not cancel
// and the partials stay short, and cut so that x - x0 loses no constant
// low bits of x0 (which would bias every row alike). kStatUnroll rows at
// a time in float32 (their loads in flight together; the first rows' with
// the shift's), each such partial added into float64; the stripes in
// order, then (after cluster.sync()) the cluster's blocks in rank order
// through distributed shared memory, in float64; rank 0 writes mean = x0
// + E[d] and var = E[d^2] - E[d]^2, each rounded once to float32. The two
// float32 passes of _stats (mean, then centred squares) read x twice,
// which at r=64 came from HBM again. The order of every sum depends on
// the shapes alone. Grid (ceil(K/64), T*cs).
// ---------------------------------------------------------------------------
constexpr int kStatUnroll = 8;   // rows a thread loads before it adds them
constexpr int kMaxCluster = 16;  // blocks of a cluster (non-portable past 8)
constexpr int kStatPitch = 72;   // doubles a stripe's row of partials takes

// Where channel col of a stripe's float64 partials lies in its row: the
// 8 channels of a channel vector rotated by the vector's index, and rows
// 72 doubles apart, so neither a warp's stores (8 vectors x 4 stripes,
// one channel each) nor its loads (32 channels of one stripe) meet twice
// in a bank. Only where the partials lie changes, not the order of a sum.
__device__ __forceinline__ int stat_slot(int col) {
  return 8 * (col >> 3) + ((col & 7) ^ (col >> 3));
}

__global__ void __launch_bounds__(kThreads)
    bn_stats_f32_kernel(const float* __restrict__ x, long long ldx,
                        long long tile_rows, int K, int cs, int rpb,
                        float* __restrict__ out) {
  __shared__ double red[2][kStatRows][kStatPitch];
  __shared__ double bsum[2][kStatCols];   // the block's [sum d; sum d^2]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cs > 1 ? (int)cluster.block_rank() : 0;
  const int t = blockIdx.y / cs;
  const int cv = threadIdx.x % 8, rs = threadIdx.x / 8;
  const int k = blockIdx.x * kStatCols + cv * 8;
  const bool on = k < K;
  const long long r0 = (long long)rank * rpb;
  const long long r1 = tile_rows < r0 + rpb ? tile_rows : r0 + rpb;
  const float* base = x + (long long)t * tile_rows * ldx + k;
  float x0[8];
  double s[8], q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    x0[i] = 0.f;
    s[i] = q[i] = 0.0;
  }
  // kStatUnroll rows from r, kStatRows apart, in flight together
  const auto load = [&](long long r, float (&v)[kStatUnroll][8]) {
#pragma unroll
    for (int j = 0; j < kStatUnroll; ++j)
      if (r + j * kStatRows < r1) load8f(base + (r + j * kStatRows) * ldx,
                                         v[j]);
  };
  const auto add = [&](long long r, float (&v)[kStatUnroll][8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float ps = 0.f, pq = 0.f;
#pragma unroll
      for (int j = 0; j < kStatUnroll; ++j) {
        const float d = r + j * kStatRows < r1 ? v[j][i] - x0[i] : 0.f;
        ps += d;
        pq = fmaf(d, d, pq);
      }
      s[i] += (double)ps;
      q[i] += (double)pq;
    }
  };
  if (on) {
    float v[kStatUnroll][8];
    long long r = r0 + rs;
    load(r, v);
    // the shift: the same in every block of the cluster
    const int n0 = tile_rows < kStatUnroll ? (int)tile_rows : kStatUnroll;
    for (int j = 0; j < n0; ++j) {
      float w[8];
      load8f(base + j * ldx, w);
#pragma unroll
      for (int i = 0; i < 8; ++i) x0[i] += w[i];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x0[i] = __uint_as_float(__float_as_uint(x0[i] / (float)n0) &
                              0xffff0000u);
    if (r < r1) add(r, v);
    for (r += kStatUnroll * kStatRows; r < r1;
         r += kStatUnroll * kStatRows) {
      load(r, v);
      add(r, v);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    red[0][rs][stat_slot(cv * 8 + i)] = s[i];
    red[1][rs][stat_slot(cv * 8 + i)] = q[i];
  }
  __syncthreads();
  if (threadIdx.x < 2 * kStatCols) {
    const int which = threadIdx.x / kStatCols, col = threadIdx.x % kStatCols;
    const int slot = stat_slot(col);
    double a = 0.0;
    for (int i = 0; i < kStatRows; ++i) a += red[which][i][slot];
    bsum[which][col] = a;
  }
  __syncthreads();
  if (rs == 0)                    // the shift, for the mean
#pragma unroll
    for (int i = 0; i < 8; ++i) red[0][0][stat_slot(cv * 8 + i)] = x0[i];
  // (a lone block, launched as no cluster, reads its own partials)
  if (cs > 1)
    cluster.sync();
  else
    __syncthreads();
  if (rank == 0 && threadIdx.x < kStatCols) {
    const int kk = blockIdx.x * kStatCols + threadIdx.x;
    double vs[kMaxCluster], vq[kMaxCluster];   // every rank's, loaded at once
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      const double* b =
          cs > 1 ? cluster.map_shared_rank(&bsum[0][0], r < cs ? r : 0)
                 : &bsum[0][0];
      vs[r] = r < cs ? b[threadIdx.x] : 0.0;
      vq[r] = r < cs ? b[kStatCols + threadIdx.x] : 0.0;
    }
    double ds = 0.0, dq = 0.0;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < cs) {
        ds += vs[r];
        dq += vq[r];
      }
    if (kk < K) {
      const double md = ds / (double)tile_rows;
      const double var = dq / (double)tile_rows - md * md;
      out[((long long)t * 2) * K + kk] =
          (float)((double)red[0][0][stat_slot(threadIdx.x)] + md);
      out[((long long)t * 2 + 1) * K + kk] = (float)(var > 0.0 ? var : 0.0);
    }
  }
  if (cs > 1) cluster.sync();   // no block leaves while rank 0 reads it
}

// ---------------------------------------------------------------------------
// B2 bn_bwd: backward of a = x*ig + shift through ghost-BN statistics, per
// tile t (m = tile_rows rows, xh = (x - mu) * rstd, ig = rstd * gamma):
//   sg = sum d_a*xh, sb = sum d_a            (written to part[t] = [sg; sb])
//   d_x (+)= ig * (d_a - sb/m - xh * sg/m)
//
// Design (the plan is the wrapper's, kernels/train_ops.py::bn_bwd_plan):
// - The grid is (K / cb, T * cs). A tile's cs blocks of one channel block
//   form a thread block cluster (along y); rank q owns the tile's
//   contiguous rows [q*rpb, (q+1)*rpb) of cb channels, so a tile of 8192
//   rows fills 8 SMs, not one. The channel blocks vary fastest, so the
//   blocks that run together read whole rows of x and d_a.
// - 256 threads are cb/8 channel vectors x 256/(cb/8) row stripes. Every
//   thread copies its own rows into shared memory with cp.async (16 bytes of
//   x, 32 of d_a a row), chunk by chunk with several chunks in flight, and
//   sums each chunk as it lands: pass 1 needs no barrier.
// - Where the block's rows fit in shared memory (the plan's resident form:
//   1024 rows x 32 channels, 192 KB, at r=64) they stay there for pass 2,
//   and HBM sees x and d_a once. Otherwise pass 2 streams them again
//   through the same ring of chunk buffers. A block of at most one row a
//   thread (r=4) keeps its rows in registers instead.
// - The block's [sg; sb] (thread sums, a warp butterfly, the warps in
//   order) go to its shared memory. After cluster.sync() every block adds
//   the cs partials in rank order through distributed shared memory, so
//   all ranks hold the same tile sums without a global round trip; rank 0
//   writes part[t], and sum_rows adds the tiles. No atomics: the order of
//   every sum depends on the shapes alone.
// Bound by bytes: reading x and d_a once, writing d_x (56.3 us at r=64,
// K=192, batch 24; PERF.md section 6).
// T is x's element type: bf16, or float32 (a float32 model's stage input:
// 32 bytes of x a row, staged as float32, so a resident block holds fewer
// rows; the same sums in the same order).
// ---------------------------------------------------------------------------
constexpr int kBnThreads = 256;
constexpr int kBnWarps = kBnThreads / 32;

struct BnPlan {
  int cb;     // channels per block: 16, 32 or 64
  int cs;     // blocks per tile: the cluster size, at most 8
  int rpb;    // rows per block
  int rc;     // rows per chunk: a multiple of the row stripes
  int slots;  // chunk buffers in shared memory (at least the chunks:
              // resident)
};

template <bool ACC, typename T>
__global__ void __launch_bounds__(kBnThreads, 1)
    bn_bwd_kernel(const T* __restrict__ x, long long ldx,
                  const float* __restrict__ da, long long ldd,
                  long long tile_rows, int K, const float* __restrict__ stats,
                  const float* __restrict__ gamma, float eps,
                  float* __restrict__ dx, long long lddx,
                  float* __restrict__ part, BnPlan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = blockIdx.y / p.cs;
  const int nv = p.cb / 8, stripes = kBnThreads / nv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cv = tid % nv, rs = tid / nv;
  const int k = blockIdx.x * p.cb + cv * 8;
  const bool on = k < K;
  const long long left = tile_rows - (long long)rank * p.rpb;
  const int n = left <= 0 ? 0 : (left < p.rpb ? (int)left : p.rpb);
  const long long r0 = (long long)t * tile_rows + (long long)rank * p.rpb;
  const int nch = (n + p.rc - 1) / p.rc;
  const int u = p.rc / stripes;          // a thread's rows per chunk
  T* xs = reinterpret_cast<T*>(smem);
  float* ds = reinterpret_cast<float*>(smem + (size_t)p.slots * p.rc * p.cb *
                                                  sizeof(T));
  float* wred = ds + (size_t)p.slots * p.rc * p.cb;   // [2][kBnWarps][cb]
  float* bpart = wred + 2 * kBnWarps * p.cb;            // [2][cb]
  float* tsum = bpart + 2 * p.cb;                     // [2][cb]

  // element offset of row jr of chunk c in its buffer (c % slots)
  const auto at = [&](int c, int jr) {
    return ((c % p.slots) * p.rc + jr) * p.cb + cv * 8;
  };
  const auto issue = [&](int c) {
    if (on && c < nch)
      for (int i = 0; i < u; ++i) {
        const int jr = i * stripes + rs;
        if (c * p.rc + jr >= n) break;
        const long long r = r0 + c * p.rc + jr;
        const int e = at(c, jr);
        cp_async16(smem_u32(xs + e), x + r * ldx + k, 16);
        if constexpr (sizeof(T) == 4)
          cp_async16(smem_u32(xs + e + 4), x + r * ldx + k + 4, 16);
        cp_async16(smem_u32(ds + e), da + r * ldd + k, 16);
        cp_async16(smem_u32(ds + e + 4), da + r * ldd + k + 4, 16);
      }
    cp_async_commit();
  };
  // every chunk through the buffers: up to ``slots`` chunks in flight; a
  // thread reads only what it copied, so no barrier
  const auto stream = [&](auto&& consume) {
    for (int c = 0; c < nch && c < p.slots; ++c) issue(c);
    for (int c = 0; c < nch; ++c) {
      const int issued = nch < c + p.slots ? nch : c + p.slots;
      cp_async_wait_upto(issued - c - 1);
      consume(c);
      if (c + p.slots < nch) issue(c + p.slots);
    }
  };

  float mu[8], rstd[8], ig[8], sg[8], sb[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    mu[q] = on ? stats[((long long)t * 2) * K + k + q] : 0.f;
    rstd[q] = on ? rsqrtf(stats[((long long)t * 2 + 1) * K + k + q] + eps)
                 : 0.f;
    ig[q] = on ? rstd[q] * gamma[k + q] : 0.f;
    sg[q] = 0.f;
    sb[q] = 0.f;
  }
  // one row's terms of the two sums, and its d_x (added to o with ACC)
  const auto add_row = [&](const Row8<T>& xv, const float (&d)[8]) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      sg[q] += d[q] * ((xv[q] - mu[q]) * rstd[q]);
      sb[q] += d[q];
    }
  };
  float mb[8], mg[8];               // the tile's sums over m, from pass 1
  const auto d_x_row = [&](const Row8<T>& xv, const float (&d)[8],
                           float (&o)[8]) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float xh = (xv[q] - mu[q]) * rstd[q];
      const float v = ig[q] * (d[q] - mb[q] - xh * mg[q]);
      o[q] = ACC ? o[q] + v : v;
    }
  };
  // a block of at most one row a thread (a small tile) keeps it in
  // registers: no copy through shared memory
  const bool in_regs = u == 1 && nch <= 1;
  const bool has = in_regs && on && rs < n;
  Row8<T> xr = {};
  float dr[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) dr[q] = 0.f;
  if (has) {
    xr.load(x + (r0 + rs) * ldx + k);
    load8f(da + (r0 + rs) * ldd + k, dr);
    add_row(xr, dr);
  }
  if (!in_regs) stream([&](int c) {
    if (!on) return;
    for (int i = 0; i < u; ++i) {
      const int jr = i * stripes + rs;
      if (c * p.rc + jr >= n) break;
      const int e = at(c, jr);
      Row8<T> xv;
      xv.load(xs + e);
      float d[8];
      load8f(ds + e, d);
      add_row(xv, d);
    }
  });

  // the block's sums: lanes of one channel vector (lane % nv) by a
  // butterfly, then the warps in order
  for (int off = 16; off >= nv; off >>= 1)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      sg[q] += __shfl_xor_sync(0xffffffffu, sg[q], off);
      sb[q] += __shfl_xor_sync(0xffffffffu, sb[q], off);
    }
  if (lane < nv)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      wred[warp * p.cb + cv * 8 + q] = sg[q];
      wred[(kBnWarps + warp) * p.cb + cv * 8 + q] = sb[q];
    }
  __syncthreads();
  if (tid < 2 * p.cb) {
    const int which = tid / p.cb, col = tid - which * p.cb;
    float a = 0.f;
    for (int w = 0; w < kBnWarps; ++w)
      a += wred[(which * kBnWarps + w) * p.cb + col];
    bpart[tid] = a;
  }
  // the tile's sums: the cluster's partials in rank order, in every block
  // (a lone block, launched as no cluster, reads its own)
  const auto sync = [&] {
    if (p.cs > 1)
      cluster.sync();
    else
      __syncthreads();
  };
  sync();
  if (tid < 2 * p.cb) {
    float a = 0.f;
    for (int q = 0; q < p.cs; ++q)
      a += (p.cs > 1 ? cluster.map_shared_rank(bpart, q) : bpart)[tid];
    tsum[tid] = a;
    const int which = tid / p.cb;
    const int kk = blockIdx.x * p.cb + (tid - which * p.cb);
    if (rank == 0 && kk < K) part[((long long)t * 2 + which) * K + kk] = a;
  }
  sync();   // no block leaves while another reads its partial
  if (!on) return;

  const float inv_m = 1.f / (float)tile_rows;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    mg[q] = tsum[cv * 8 + q] * inv_m;
    mb[q] = tsum[p.cb + cv * 8 + q] * inv_m;
  }
  // pass 2 over the thread's rows qi in [q_lo, q_hi) (row qi: chunk qi / u,
  // stripe row qi % u), four at a time so that d_x's reads overlap
  const auto finish = [&](int q_lo, int q_hi) {
    for (int q0 = q_lo; q0 < q_hi; q0 += 4) {
      float o[4][8];
      int e[4];
      long long r[4];
      bool ok[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int qi = q0 + a, c = qi / u, jr = (qi - c * u) * stripes + rs;
        ok[a] = qi < q_hi && c * p.rc + jr < n;
        e[a] = at(c, jr);
        r[a] = r0 + c * p.rc + jr;
        if (ACC && ok[a]) load8f(dx + r[a] * lddx + k, o[a]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (!ok[a]) continue;
        Row8<T> xv;
        xv.load(xs + e[a]);
        float d[8];
        load8f(ds + e[a], d);
        d_x_row(xv, d, o[a]);
        store8f(dx + r[a] * lddx + k, o[a]);
      }
    }
  };
  if (in_regs) {
    if (!has) return;
    float o[8];
    if (ACC) load8f(dx + (r0 + rs) * lddx + k, o);
    d_x_row(xr, dr, o);
    store8f(dx + (r0 + rs) * lddx + k, o);
  } else if (nch <= p.slots) {
    finish(0, nch * u);           // resident: the rows are still there
  } else {
    stream([&](int c) { finish(c * u, (c + 1) * u); });
  }
}

// ---------------------------------------------------------------------------
// B2 bn_bwd at float32 where no portable cluster keeps a tile's rows on
// chip (r=64 on the main path: a tile of 8,192 or 24,576 rows, 32 or 96
// KB a channel of x and d_a): persistent clusters of cs blocks (16, past
// the portable 8). An item is (tile t, channel block of cb); cluster c
// walks the items c, c + G, c + 2G, ... (G clusters, as many as the card
// holds at once); its rank q owns the tile's rows [q*rpb, (q+1)*rpb) of
// the item's channels. Each block keeps one item buffer of x and d_a in
// shared memory, the landing place of one item's copies (one cp.async
// group an item): a thread moves its rows of an item into registers as it
// sums them (at most ROWS: 16 or 24) and, once it has sent its sums to the
// cluster, refills the buffer with its next item, so while it waits for
// the cluster's sums and writes d_x from its registers, the next item's
// rows are on their way: HBM sees x and d_a once, and the loads' latency
// under load (several us) is covered by bytes in flight. A thread refills
// only what it read itself, so no barrier guards the buffer; the next
// item's statistics are loaded an item ahead and used only then. (Two or
// three buffers of narrower channel blocks, where they fit, were slower
// than one of the widest block: PERF.md section 7.4.) The accumulating
// form (ACC: d_x added into) stages its item's rows of d_x in a buffer of
// their own, copied while the block's previous item is written and waited
// for only before pass 2 (read from device memory in pass 2, d_x's loads
// stalled the thread); its buffers of 12 bytes an element fit 32 channels
// at tile 2 and 8 at tile 6, 16 and 12 rows a thread.
// The blocks trade their partial sums with st.async into every rank's
// shared memory, each completing bytes on the receiver's mbarrier (one a
// parity of the item, armed an item ahead): no cluster-wide barrier an
// item, whose release would wait for the previous item's d_x stores to
// reach memory (a cluster.sync() an item was slower: tools/bn_sweep.py).
// A thread owns 4 channels of its rows (16 bytes), so one warp's copies
// and stores cover whole 32-byte sectors (8 channels a thread, two 16-byte
// halves, took twice the requests); blocks of 32 channels (128-byte rows,
// tile 2) ran faster than 16 or 8. The two sums: each thread's rows in
// float32 (rpb / stripes of them: 16 at tile 2, 24 at tile 6), then in
// float64 the row stripes in groups of 8 in order, the groups in order and
// the cluster's blocks in rank order; the tile's sums are rounded once:
// rank 0 writes part[t], and sum_rows adds the tiles. The order of every
// sum depends on the shapes alone (not on G or on which cluster takes an
// item). p.rc = p.rpb (one buffer, an item's rows).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// one arrival on bar, and bytes more awaited in its current phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of bar with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// v into the shared memory of cluster rank r at the address local is at
// here, its 8 bytes completed on rank r's copy of bar
__device__ __forceinline__ void st_async_f64(const double* local, double v,
                                             const uint64_t* bar, int r) {
  uint32_t dst, mb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(dst)
               : "r"(smem_u32(local)), "r"(r));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(mb)
               : "r"(smem_u32(bar)), "r"(r));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];\n" ::"r"(dst),
      "l"(__double_as_longlong(v)), "r"(mb)
      : "memory");
}

template <bool ACC, int ROWS>
__global__ void __launch_bounds__(kBnThreads, 1)
    bn_bwd_f32_kernel(const float* __restrict__ x, long long ldx,
                      const float* __restrict__ da, long long ldd,
                      long long tile_rows, int T, int K,
                      const float* __restrict__ stats,
                      const float* __restrict__ gamma, float eps,
                      float* __restrict__ dx, long long lddx,
                      float* __restrict__ part, BnPlan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  // a thread owns a piece of 4 channels (16 bytes) of its rows, so the
  // lanes of one copy or store cover whole 32-byte sectors
  const int nv = p.cb / 4, stripes = kBnThreads / nv;
  const int tid = threadIdx.x;
  const int cv = tid % nv, rs = tid / nv;
  const int nkb = (K + p.cb - 1) / p.cb, items = T * nkb;
  const int clusters = gridDim.x / p.cs;
  const long long left = tile_rows - (long long)rank * p.rpb;
  const int n = left <= 0 ? 0 : (left < p.rpb ? (int)left : p.rpb);
  const size_t buf = (size_t)p.rpb * p.cb;   // floats of the buffer
  const int ns = 2 * p.cb;                   // sums of a block
  const int ng = kBnThreads / ns;            // stripe groups of a sum
  float* xs = reinterpret_cast<float*>(smem);                  // [buf]
  float* ds = xs + buf;                                        // [buf]
  float* dxs = ds + buf;                           // ACC: [buf] of d_x
  float* red = dxs + (ACC ? buf : 0);              // [stripes][ns]
  double* gred = reinterpret_cast<double*>(red + kBnThreads * 8);  // [ng][ns]
  double* recv = gred + ng * ns;                   // [2][cs][ns]
  double* tsum = recv + 2 * p.cs * ns;             // [ns]
  uint64_t* bar = reinterpret_cast<uint64_t*>(tsum + ns);     // [2]
  const uint32_t recv_bytes = (uint32_t)(p.cs * ns * sizeof(double));

  // the first column of this thread's piece in item i (K or more: none)
  const auto col = [&](int i) { return (i % nkb) * p.cb + cv * 4; };
  const auto row0 = [&](int i) {
    return (long long)(i / nkb) * tile_rows + (long long)rank * p.rpb;
  };
  const auto at = [&](int jr) { return (size_t)jr * p.cb + cv * 4; };
  const auto issue = [&](int i) {
    const int k = col(i);
    if (i < items && k < K) {
      const long long r0 = row0(i);
      for (int jr = rs; jr < n; jr += stripes) {
        cp_async16(smem_u32(xs + at(jr)), x + (r0 + jr) * ldx + k, 16);
        cp_async16(smem_u32(ds + at(jr)), da + (r0 + jr) * ldd + k, 16);
      }
    }
    cp_async_commit();
  };
  // ACC: item i's rows of d_x into their own buffer, a group of their own
  const auto issue_dx = [&](int i) {
    const int k = col(i);
    if (i < items && k < K) {
      const long long r0 = row0(i);
      for (int jr = rs; jr < n; jr += stripes)
        cp_async16(smem_u32(dxs + at(jr)), dx + (r0 + jr) * lddx + k, 16);
    }
    cp_async_commit();
  };
  // the next item's [mean; var; gamma] of this thread's channels, loaded
  // an item ahead (their latency would stall the thread where they are
  // used)
  float st[3][4];
  const auto load_stats = [&](int i) {
    const int t = i / nkb, k = col(i);
    const bool on = i < items && k < K;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      st[0][q] = on ? stats[((long long)t * 2) * K + k + q] : 0.f;
      st[1][q] = on ? stats[((long long)t * 2 + 1) * K + k + q] : 0.f;
      st[2][q] = on ? gamma[k + q] : 0.f;
    }
  };
  const auto load4 = [](const float* a, float (&v)[4]) {
    const float4 f = *reinterpret_cast<const float4*>(a);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  };

  if (tid == 0) {                 // the receive barriers of items 0 and 1
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&bar[0], recv_bytes);
    mbar_expect(&bar[1], recv_bytes);
  }
  cluster.sync();                 // armed in every block before any send
  const int i0 = blockIdx.x / p.cs;
  issue(i0);
  if (ACC) issue_dx(i0);
  load_stats(i0);
  for (int j = 0, i = i0; i < items; ++j, i += clusters) {
    const int h = j & 1, t = i / nkb, k = col(i);
    const bool on = k < K;
    float mu[4], rstd[4], ig[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      mu[q] = st[0][q];
      rstd[q] = rsqrtf(st[1][q] + eps);
      ig[q] = on ? rstd[q] * st[2][q] : 0.f;
    }
    // this item's x and d_a (ACC: its d_x, the newer group, may still
    // be on its way)
    if (ACC)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    // pass 1: the thread's rows into registers, summed in float32
    float xv[ROWS][4], d[ROWS][4], fg[4], fb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) fg[q] = fb[q] = 0.f;
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int jr = rs + u * stripes;
      if (!on || jr >= n) break;
      load4(xs + at(jr), xv[u]);
      load4(ds + at(jr), d[u]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        fg[q] += d[u][q] * ((xv[u][q] - mu[q]) * rstd[q]);
        fb[q] += d[u][q];
      }
    }
    // the block's sums in float64: the stripes in ng groups of
    // stripes / ng in order, then the groups in order
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      red[rs * ns + cv * 4 + q] = fg[q];
      red[rs * ns + p.cb + cv * 4 + q] = fb[q];
    }
    __syncthreads();
    {
      const int o = tid % ns, g = tid / ns, per = stripes / ng;
      double a = 0.0;
      for (int r = g * per; r < (g + 1) * per; ++r) a += red[r * ns + o];
      gred[g * ns + o] = a;
    }
    __syncthreads();
    if (tid < ns) {               // the block's sums to every rank
      double a = 0.0;
      for (int g = 0; g < ng; ++g) a += gred[g * ns + tid];
      double* slot = recv + (h * p.cs + rank) * ns + tid;
      for (int r = 0; r < p.cs; ++r) st_async_f64(slot, a, &bar[h], r);
    }
    // the buffer is free: the next item into it (a thread refills only
    // what it read itself; after the sends, so a copy that waits for room
    // holds up no other rank: refilling each row as pass 1 read it was
    // slower, tools/bn_sweep.py)
    issue(i + clusters);
    load_stats(i + clusters);
    if (tid < ns) {               // the tile's sums: the ranks' in order
      mbar_wait(&bar[h], (uint32_t)(j >> 1) & 1u);
      double s = 0.0;
      for (int r = 0; r < p.cs; ++r) s += recv[(h * p.cs + r) * ns + tid];
      tsum[tid] = s;
      const int kk = (i % nkb) * p.cb + (tid % p.cb);
      if (rank == 0 && kk < K)
        part[((long long)t * 2 + tid / p.cb) * K + kk] = (float)s;
    }
    __syncthreads();
    // every waiter is past this parity's phase: arm it for item j + 2
    if (tid == 0) mbar_expect(&bar[h], recv_bytes);
    // ACC: this item's d_x (only the next item's x and d_a may still land;
    // a thread reads only the rows it copied itself)
    if (ACC) cp_async_wait<1>();
    if (on) {
      float mg[4], mb[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        mg[q] = (float)(tsum[cv * 4 + q] / (double)tile_rows);
        mb[q] = (float)(tsum[p.cb + cv * 4 + q] / (double)tile_rows);
      }
      // pass 2: d_x from the registers (ACC: added to the staged d_x)
      const long long r0 = row0(i);
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        const int jr = rs + u * stripes;
        if (jr < n) {
          float o[4];
          if (ACC) load4(dxs + at(jr), o);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float xh = (xv[u][q] - mu[q]) * rstd[q];
            const float v = ig[q] * (d[u][q] - mb[q] - xh * mg[q]);
            o[q] = ACC ? o[q] + v : v;
          }
          *reinterpret_cast<float4*>(dx + (r0 + jr) * lddx + k) =
              make_float4(o[0], o[1], o[2], o[3]);
        }
      }
    }
    // ACC: the d_x buffer is free: the next item's rows into it, on their
    // way while that item's x and d_a are summed and its sums trade
    if (ACC) issue_dx(i + clusters);
  }
  cluster.sync();   // no block leaves while another may still send to it
}

// ---------------------------------------------------------------------------
// B1 affine_dx: the activation-gradient GEMM of a 1x1 stage, masked by its
// ReLU.
//   out[m, k] = [x[m,k]*inv[t,k] + shift[t,k] > 0] * sum_n dY[m, n] W[k, n]
// with W the (K, N) weight as it lies. The ReLU mask is recomputed from the
// stage input x with the forward's f32 prologue, so d_a never needs the
// forward's activations. With STE (QuanInput's straight-through
// estimator) the gate also needs the bf16 activation below 1: 0 < z < 1,
// z the value the quantizer read.
//
// Design (the plan is the wrapper's, kernels/train_ops.py::
// affine_dx_plan): affine_dot's (buf_kernels.cu) on dY.
// - Persistent blocks of 8 warps, each keeping one block of kc output
//   columns (K cut into equal blocks of at most 64: 192 is 3 x 64, no idle
//   part of a block); on the main path tiles of 64 rows and two buffers
//   let two blocks share an SM. For g = dY W^T the B operand needs each
//   output column's N values contiguous: the block's kc rows of W as they
//   lie, loaded once by cp.async at a row stride of an odd number of
//   16-byte chunks and read by ldmatrix without .trans (no transpose, no
//   per-step scatter).
// - A tile's dY rows and its x rows (kc channels, for the gate) arrive by
//   cp.async, two or three stages deep. The gate is taken once per element
//   in shared memory (halo.cuh's halo_map, the BN vectors in registers
//   across tiles), x replaced by its mask.
// - Warp (wm, wn) owns 32 rows and NTW n8 column tiles: mma.sync m16n8k16,
//   the float32 sums in registers; a lane pair swaps halves (one shuffle a
//   value) so each lane holds four consecutive columns of one row, masks
//   them with the staged gate and writes one 16-byte float32 vector.
// Bound by bytes: reading dY and x, writing the float32 result (41.3 us at
// r=64, K=192, N=128, batch 24); measured about 1.7x that on an H100 80GB
// HBM3 at 700 W (PERF.md section 6).
// ---------------------------------------------------------------------------
struct AffineDxPlan {
  int bm;           // rows per tile: 32 * row warps (128, 64 or 32)
  int kc;           // output columns per block: 8 * NTW * column warps
  int nkb;          // column blocks
  int np;           // N zero-padded to 16
  int stages;       // buffers: 2 or 3
  int w_bytes;      // the block's weight rows: kc at a stride of np + 8
  int dy_bytes;     // a buffer's dY rows (bm at np + 8); its x rows follow
  int stage_bytes;  // bytes per buffer
};

// The backward's gate of eight packed x values: 0xffff where it passes.
__device__ __forceinline__ uint4 gate8(uint4 in, const float (&a)[8],
                                       const float (&b)[8], bool ste) {
  Pack8 i, o;
  i.v = in;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float z = affine(lo(i, q), a[q], b[q]);
    o.u[q] = z > 0.f && (!ste || bf16r(z) < 1.f) ? 0xffffu : 0u;
  }
  return o.v;
}

template <int NTW, bool STE>
__global__ void __launch_bounds__(kThreads)
    dx_kernel(const bf16* __restrict__ dy, long long ldd, int M, int N,
              const bf16* __restrict__ w, int ldw, int K,
              const bf16* __restrict__ x, long long ldx,
              const float* __restrict__ inv, const float* __restrict__ shift,
              long long vstride, int tile_rows, float* __restrict__ out,
              long long ldo, AffineDxPlan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm_n = p.bm / 32;
  const int wm = warp % wm_n, wn = warp / wm_n;
  const int cb = blockIdx.x % p.nkb, k0 = cb * p.kc;
  const int tiles = (M + p.bm - 1) / p.bm;
  const int first = blockIdx.x / p.nkb, stride = gridDim.x / p.nkb;
  if (first >= tiles) return;
  const int Q = (tiles - 1 - first) / stride + 1;
  const int ws = (p.np + kHaloPad) * 2;   // weight and dY row stride, bytes
  const int xs = p.kc + kHaloPad;         // x (gate) row stride, elements

  // the weight's rows k0 .. k0 + kc, zero past K and N
  const int wv = p.np / 8;
  for (int i = tid; i < p.kc * wv; i += kThreads) {
    const int r = i / wv, v = i - r * wv;
    const int k = k0 + r, n = v * 8;
    const bool ok = k < K && n < N;
    cp_async16(s0 + r * ws + v * 16, ok ? w + (long long)k * ldw + n : w,
               ok ? 16 : 0);
  }
  cp_async_commit();
  const auto issue = [&](int q) {
    const int m0 = (first + q * stride) * p.bm;
    const uint32_t base = s0 + p.w_bytes + (q % p.stages) * p.stage_bytes;
    load_halo(base, dy, ldd, M, N, m0, p.bm, 0, p.np, tid, kThreads);
    load_halo(base + p.dy_bytes, x, ldx, M, K, m0, p.bm, k0, p.kc, tid,
              kThreads);
    cp_async_commit();
  };
  for (int q = 0; q < Q && q < p.stages - 1; ++q) issue(q);

  // ldmatrix lane coordinates: A (dY) rows wm*32 + (l & 15) (+16), byte
  // offset (l >> 4) * 16; B (W rows) row (mat >> 1) * 8 + (l & 7) of the
  // n8 tile pair, byte offset (mat & 1) * 16
  const int mat = lane >> 3;
  const int a_off = (wm * 32 + (lane & 15)) * ws + (lane >> 4) * 16;
  const uint32_t b_base =
      s0 + (wn * NTW * 8 + (mat >> 1) * 8 + (lane & 7)) * ws + (mat & 1) * 16;
  const int g = lane >> 2, q4 = lane & 3;
  const bool odd = q4 & 1;
  VecCache vc;
  vc.lo = vc.hi = 0;

  for (int q = 0; q < Q; ++q) {
    const int issued = Q < q + p.stages - 1 ? Q : q + p.stages - 1;
    cp_async_wait_upto(issued - q - 1);
    __syncthreads();   // tile q (and the weight) landed; tile q-1 is done
    if (q + p.stages - 1 < Q) issue(q + p.stages - 1);
    const int m0 = (first + q * stride) * p.bm;
    const int sb = p.w_bytes + (q % p.stages) * p.stage_bytes;
    bf16* gate = reinterpret_cast<bf16*>(smem + sb + p.dy_bytes);
    halo_map(gate, M, K, m0, p.bm, k0, p.kc, inv, shift, vstride, tile_rows,
             tid, kThreads, vc,
             [](uint4 v, const float(&a)[8], const float(&b)[8]) {
               return gate8(v, a, b, STE);
             });
    __syncthreads();

    float acc[2][NTW][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    const uint32_t abase = s0 + sb + a_off;
#pragma unroll 2
    for (int kk = 0; kk < p.np / 16; ++kk) {
      uint32_t a[2][4];
      ldsm_x4(a[0], abase + kk * 32);
      ldsm_x4(a[1], abase + 16 * ws + kk * 32);
#pragma unroll
      for (int jp = 0; jp < NTW / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, b_base + jp * 16 * ws + kk * 32);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma16816(acc[i][2 * jp], a[i], b[0], b[1]);
          mma16816(acc[i][2 * jp + 1], a[i], b[2], b[3]);
        }
      }
      if (NTW & 1) {
        uint32_t b0, b1;
        ldsm_x2(b0, b1, s0 + ((wn * NTW + NTW - 1) * 8 + (lane & 7)) * ws +
                            (mat & 1) * 16 + kk * 32);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma16816(acc[i][NTW - 1], a[i], b0, b1);
      }
    }

    // epilogue: lane pairs swap so an even lane holds row g, columns
    // 2q..2q+3 and an odd lane row g+8, columns 2(q-1)..; the staged gate
    // masks them and each lane writes one float4
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wm * 32 + i * 16 + g + (odd ? 8 : 0);
      const int m = m0 + r;
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const float* c = acc[i][j];
        const float t0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
        const float t1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
        const int kl = (wn * NTW + j) * 8 + 2 * (q4 & 2);
        const int k = k0 + kl;
        if (m < M && k < K) {
          float4 v = odd ? make_float4(t0, t1, c[2], c[3])
                         : make_float4(c[0], c[1], t0, t1);
          const uint2 gm = *reinterpret_cast<const uint2*>(gate + r * xs + kl);
          v.x = gm.x & 0xffffu ? v.x : 0.f;
          v.y = gm.x >> 16 ? v.y : 0.f;
          v.z = gm.y & 0xffffu ? v.z : 0.f;
          v.w = gm.y >> 16 ? v.w : 0.f;
          *reinterpret_cast<float4*>(out + (long long)m * ldo + k) = v;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B3 affine_dw: the weight gradient of a 1x1 stage,
//   part[p, k, n] = sum_{m in run p} z[m, k] * dY[m, n]
// with z = bf16(relu(x*inv[t] + shift[t])) recomputed (QuanInput-quantized
// with bits > 0: dW against what the forward's GEMM read); sum_rows adds
// the runs' partials in order.
//
// Design (the plan is the wrapper's, kernels/train_ops.py::affine_dw_plan):
// conv3x3_dw's design reduced to one tap.
// - Block (p, cy, gz) owns run p of whole br-row steps (the runs depend on
//   the shapes alone, so the sums and their order do too), the kc channels
//   cy (K cut into equal multiples of 16, no idle half block) and the ncol
//   columns gz; the plan sizes them to put two blocks on each of the
//   card's SMs (at most 128 registers a thread), so that one block's
//   loads and prologue run under the other's products.
// - Per step the step's x rows and dy rows arrive by cp.async, two or three
//   stages deep: the next steps load while this one computes.
// - The prologue (halo.cuh's, on a tile of no halo: the x rows are stored
//   as a halo tile is) runs once per element, in place in shared memory;
//   each thread keeps the inv/shift of its 8 channels in registers across
//   the run's steps and reloads them only where the ghost tile changes
//   (once or twice a run on the main path).
// - The 8 warps accumulate dW^T += dY^T z as mma.sync m16n8k16, z^T and dY
//   read by ldmatrix.trans (row strides of an odd number of 16-byte chunks:
//   no bank conflicts), the warps' channel tiles interleaved; the sums stay
//   in registers and the block writes one partial.
// Bound by bytes: reading x and dy once (18.8 us at r=64, K=192->128,
// batch 24; PERF.md section 6).
// ---------------------------------------------------------------------------
struct AffineDwPlan {
  int run_rows;     // rows of a block's run: a multiple of br
  int br;           // rows per step: 16, 32 or 64
  int kc;           // channels per block: a multiple of 16, at most 128
  int ncol;         // columns per block: 16, 32, 64 or 128
  int stages;       // buffers: 2 or 3
  int x_bytes;      // bytes of a stage's x rows (its dy rows follow)
  int stage_bytes;  // bytes per stage
};

// NTW n8 column tiles a warp, WN warps across the columns (ncol = 8 NTW WN)
template <int NTW, int WN>
__global__ void __launch_bounds__(kThreads, 2)
    affine_dw_kernel(const bf16* __restrict__ x, long long ldx, int M, int K,
                     const float* __restrict__ inv,
                     const float* __restrict__ shift, long long vstride,
                     long long tile_rows, int bits,
                     const bf16* __restrict__ dy, long long ldd, int N,
                     float* __restrict__ part, AffineDwPlan p) {
  constexpr int WC = kWarps / WN;   // warps across the channels
  constexpr int CT = 8 / WC;        // channel tiles a warp (kc <= 128)
  static_assert(NTW % 2 == 0 && WC * WN == kWarps, "warp layout");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wc = warp % WC, wn = warp / WC;
  const int c0 = blockIdx.y * p.kc, n0 = blockIdx.z * p.ncol;
  const int r_begin = blockIdx.x * p.run_rows;
  const int r_end = M - r_begin < p.run_rows ? M : r_begin + p.run_rows;
  const int nsteps = (r_end - r_begin + p.br - 1) / p.br;
  const int xs = (p.kc + 8) * 2, ds = (p.ncol + 8) * 2;   // row strides
  const int xv = p.kc / 8, dv = p.ncol / 8, ntiles = p.kc / 16;

  const auto issue = [&](int st) {
    const int m0 = r_begin + st * p.br;
    const uint32_t base = s0 + (st % p.stages) * p.stage_bytes;
    for (int i = tid; i < p.br * xv; i += kThreads) {
      const int r = i / xv, v = i - r * xv;
      const int m = m0 + r, c = c0 + v * 8;
      const bool ok = m < r_end && c < K;
      cp_async16(base + r * xs + v * 16,
                 ok ? x + (long long)m * ldx + c : x, ok ? 16 : 0);
    }
    for (int i = tid; i < p.br * dv; i += kThreads) {
      const int r = i / dv, v = i - r * dv;
      const int m = m0 + r, n = n0 + v * 8;
      const bool ok = m < r_end && n < N;
      cp_async16(base + p.x_bytes + r * ds + v * 16,
                 ok ? dy + (long long)m * ldd + n : dy, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  VecCache vc;   // the prologue thread's BN vectors, kept across steps
  vc.lo = vc.hi = 0;

  float acc[CT][NTW][4];
#pragma unroll
  for (int i = 0; i < CT; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // ldmatrix.trans lane coordinates (conv3x3_dw's). z^T (A): row
  // (l & 7) + (mat >> 1) * 8, channel offset (mat & 1) * 8. dY (B): row
  // (mat & 1) * 8 + (l & 7), 16-byte column chunk 2 * jp + (mat >> 1).
  const int mat = lane >> 3;
  const int a_row = (lane & 7) + (mat >> 1) * 8;
  const int a_ofs = (mat & 1) * 16;
  const int b_row = (mat & 1) * 8 + (lane & 7);
  const int b_chunk = wn * NTW + (mat >> 1);

  for (int st = 0; st < nsteps && st < p.stages - 1; ++st) issue(st);
  for (int st = 0; st < nsteps; ++st) {
    const int issued = nsteps < st + p.stages - 1 ? nsteps : st + p.stages - 1;
    cp_async_wait_upto(issued - st - 1);
    __syncthreads();   // step st landed; every warp is done with step st-1
    if (st + p.stages - 1 < nsteps) issue(st + p.stages - 1);
    halo_prologue(reinterpret_cast<bf16*>(smem + (st % p.stages) *
                                                     p.stage_bytes),
                  r_end, K, r_begin + st * p.br, p.br, c0, p.kc, inv, shift,
                  vstride, (int)tile_rows, bits, tid, kThreads, vc);
    __syncthreads();
    const uint32_t xb = s0 + (st % p.stages) * p.stage_bytes;
    const uint32_t db = xb + p.x_bytes;
#pragma unroll 1
    for (int kr = 0; kr < p.br; kr += 16) {
      uint32_t b[NTW][2];
#pragma unroll
      for (int jp = 0; jp < NTW / 2; ++jp) {
        uint32_t t4[4];
        ldsm_x4_t(t4, db + (kr + b_row) * ds + (b_chunk + 2 * jp) * 16);
        b[2 * jp][0] = t4[0];
        b[2 * jp][1] = t4[1];
        b[2 * jp + 1][0] = t4[2];
        b[2 * jp + 1][1] = t4[3];
      }
#pragma unroll
      for (int i = 0; i < CT; ++i) {
        const int ct = wc + WC * i;
        if (ct >= ntiles) continue;
        uint32_t a[4];
        ldsm_x4_t(a, xb + (kr + a_row) * xs + a_ofs + ct * 32);
#pragma unroll
        for (int j = 0; j < NTW; ++j)
          mma16816(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
  }

  float* base = part + (long long)blockIdx.x * K * N;
  const int g = lane >> 2, q2 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < CT; ++i) {
    const int ct = wc + WC * i;
    if (ct >= ntiles) continue;
    const int c = c0 + ct * 16 + g;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int n = n0 + (wn * NTW + j) * 8 + q2;
      if (n >= N) continue;
      if (c < K)
        *reinterpret_cast<float2*>(base + (long long)c * N + n) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (c + 8 < K)
        *reinterpret_cast<float2*>(base + (long long)(c + 8) * N + n) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// B5 conv3x3_dw: the 3x3 conv's weight gradient in the packed layout,
//   part[p, tap*C + c, n] = sum_{m in run p} z[src(m, tap), c] * dY[m, n]
// with z = bf16(relu(x*inv[t] + shift[t])) (QuanInput-quantized with
// bits > 0), zero where src(m, tap) lies outside m's image; sum_rows adds
// the runs' partials in order.
//
// Design (the plan is the wrapper's, kernels/train_ops.py::
// conv3x3_dw_plan): block (p, cy, gz) owns run p of whole 128-row steps
// (the runs depend on M alone, so the sums and their order do too), the
// 128 channels cy and the NT*8 columns gz. Per step it stages one halo
// tile of z (halo.cuh; the prologue and quantizer applied once per
// element) and the step's dy rows, both with cp.async, the next step's
// loading while this one computes. Twelve warps, one kernel row each
// (dy = warp/4 - 1) and two 16-channel tiles each (warp % 4), accumulate
// all three taps of their row from the one tile: dW_tap^T += dY^T z_tap
// as mma.sync m16n8k16, z_tap^T and dY read by ldmatrix.trans, the dY
// fragments shared by the warp's three taps and two channel tiles, the
// taps' rows shifted or pointed at the zero row per lane. Each block keeps
// its 9 x 128 x 32 sums in registers (96 a thread) and writes one partial.
// Bound by reading x and dy (9.4 us at r=64 batch 24); measured 70 us
// there without sum_rows on an H100 80GB HBM3 at 700 W (PERF.md, PR 8):
// ~31 of it the products, ~19 the prologue, ~10 the loads.
// ---------------------------------------------------------------------------
constexpr int kDwWarps = 12;
constexpr int kDwThreads = kDwWarps * 32;

struct DwPlan {
  int run_rows;     // rows of a block's run: a multiple of br
  int br;           // rows per step, a multiple of 16
  int kc;           // channels per block, a multiple of 16 (<= 128)
  int stages;       // 2 (double-buffered) or 1
  int zero_off;     // shared-memory byte offsets: the zero row,
  int stage_off;    //   the first stage,
  int stage_bytes;  //   bytes per stage,
  int dy_off;       //   the dy rows within a stage
};

template <int NT>
__global__ void __launch_bounds__(kDwThreads, 1)
    conv3x3_dw_kernel(const bf16* __restrict__ x, long long ldx, int M, int H,
                      int W, int C, const float* __restrict__ inv,
                      const float* __restrict__ shift, long long vstride,
                      int tile_rows, int bits, const bf16* __restrict__ dy,
                      long long ldd, int G, float* __restrict__ part,
                      DwPlan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int GB = NT * 8;
  constexpr int DS = (NT & 1 ? NT : NT + 1) * 16;  // dy row stride, bytes
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ky = warp >> 2, cq = warp & 3;
  const int c0 = blockIdx.y * p.kc, n0 = blockIdx.z * GB;
  const int r_begin = blockIdx.x * p.run_rows;
  const int r_end = M - r_begin < p.run_rows ? M : r_begin + p.run_rows;
  const int nsteps = (r_end - r_begin + p.br - 1) / p.br;
  const int hw = H * W;
  const int hstride = (p.kc + kHaloPad) * 2;
  const int halo_rows = p.br + 2 * W + 2;
  const bool busy = 2 * cq < p.kc / 16;  // this warp has a channel tile

  for (int i = tid; i < p.kc / 8; i += kDwThreads)
    *reinterpret_cast<uint4*>(smem + p.zero_off + i * 16) =
        make_uint4(0u, 0u, 0u, 0u);

  const auto issue = [&](int st) {
    const int m0 = r_begin + st * p.br;
    const uint32_t base = s0 + p.stage_off + (st % p.stages) * p.stage_bytes;
    load_halo(base, x, ldx, M, C, m0 - W - 1, halo_rows, c0, p.kc, tid,
              kDwThreads);
    // dy rows [m0, m0 + br) x columns [n0, n0 + GB), zero past the run or G
    for (int i = tid; i < p.br * NT; i += kDwThreads) {
      const int r = i / NT, j = i - (i / NT) * NT;
      const int m = m0 + r, n = n0 + j * 8;
      const bool ok = m < r_end && n < G;
      cp_async16(base + p.dy_off + r * DS + j * 16,
                 ok ? dy + (long long)m * ldd + n : dy, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  float acc[3][2][NT][4];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d][t][j][e] = 0.f;

  // ldmatrix.trans lane coordinates. z^T (A): pixel row (l & 7) +
  // (mat >> 1) * 8, channel offset (mat & 1) * 8. dY (B): pixel row
  // (mat & 1) * 8 + (l & 7), 16-byte column chunk 2 * jp + (mat >> 1).
  const int mat = lane >> 3;
  const int a_pix = (lane & 7) + (mat >> 1) * 8;
  const int a_ofs = (mat & 1) * 16;
  const int b_pix = (mat & 1) * 8 + (lane & 7);

  if (p.stages == 2) issue(0);
  for (int st = 0; st < nsteps; ++st) {
    if (p.stages == 1) issue(st);
    if (p.stages == 2 && st + 1 < nsteps) {
      issue(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    unsigned char* hs = smem + p.stage_off + (st % p.stages) * p.stage_bytes;
    const int m0 = r_begin + st * p.br;
    halo_prologue(reinterpret_cast<bf16*>(hs), M, C, m0 - W - 1, halo_rows,
                  c0, p.kc, inv, shift, vstride, tile_rows, bits, tid,
                  kDwThreads);
    __syncthreads();
    const uint32_t hbase = smem_u32(hs), zbase = s0 + p.zero_off;
    const uint32_t dbase = hbase + p.dy_off;
    if (busy) {
#pragma unroll 1
      for (int pr = 0; pr < p.br; pr += 16) {
        uint32_t b[NT][2];
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t t4[4];
          ldsm_x4_t(t4, dbase + (pr + b_pix) * DS + (2 * jp + (mat >> 1)) * 16);
          b[2 * jp][0] = t4[0];
          b[2 * jp][1] = t4[1];
          b[2 * jp + 1][0] = t4[2];
          b[2 * jp + 1][1] = t4[3];
        }
        if (NT & 1)
          ldsm_x2_t(b[NT - 1][0], b[NT - 1][1],
                    dbase + (pr + b_pix) * DS + (NT - 1) * 16);
        const int r = pr + a_pix, m = m0 + r;
        const bool in_range = m < r_end;
        const int pix = in_range ? m % hw : 0;
        const int yy = pix / W, xx = pix - (pix / W) * W;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const int hr = tap_row(r, yy, xx, in_range, ky - 1, d - 1, H, W);
          const uint32_t ab =
              (hr < 0 ? zbase : hbase + (uint32_t)(hr * hstride)) + a_ofs;
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int ct = 2 * cq + t;
            if (ct * 16 >= p.kc) continue;
            uint32_t a[4];
            ldsm_x4_t(a, ab + ct * 32);
#pragma unroll
            for (int j = 0; j < NT; ++j)
              mma16816(acc[d][t][j], a, b[j][0], b[j][1]);
          }
        }
      }
    }
    __syncthreads();
  }

  if (!busy) return;
  float* base = part + (long long)blockIdx.x * 9 * C * G;
  const int g = lane >> 2, q2 = 2 * (lane & 3);
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int tap = ky * 3 + d;
        const int c = c0 + (2 * cq + t) * 16 + g;
        const int n = n0 + 8 * j + q2;
        if (n >= G) continue;
        if (c < C)
          *reinterpret_cast<float2*>(base + ((long long)tap * C + c) * G + n) =
              make_float2(acc[d][t][j][0], acc[d][t][j][1]);
        if (c + 8 < C)
          *reinterpret_cast<float2*>(base + ((long long)tap * C + c + 8) * G +
                                     n) =
              make_float2(acc[d][t][j][2], acc[d][t][j][3]);
      }
}

// ---------------------------------------------------------------------------
// B4 conv3x3_dx: the transposed 3x3 conv of dY, masked by the ReLU of the
// conv's input (and QuanInput's straight-through gate with STE):
//   out[m, c] = gate(x[m, c]) *
//               sum_{t'} sum_n dY[m + off(t'), n] * Wp[(8 - t')*Cb + c, n]
// with off(t') = (t'/3 - 1)*W + t'%3 - 1, zero where m + off(t') lies
// outside m's image: tap t of the forward reads m - off(t) = m + off(8 - t),
// so the transposed conv is the forward's 3x3 conv of dY (G channels in,
// Cb out) through the flipped taps of the same packed (9*Cb, G) weight.
//
// Design (the plan is the wrapper's, kernels/train_ops.py::conv3x3_dx_plan):
// - conv3x3's form on dY: persistent blocks of 8 warps walk items (a tile
//   of bm output rows, a group of gb output channels). A tile's dY rows
//   are one halo tile (halo.cuh: bm + 2W + 2 rows of G channels, zero-padded
//   to 16), so a dY row comes from memory once per tile, not once per tap.
//   The halo, the tile's x rows and its BN vectors (the gate's operands)
//   arrive by cp.async while the previous tile computes (two stages where
//   they fit).
// - The weight slice of the column group stays in shared memory: 9 x gb x G
//   bf16 (72 KB on the main path), loaded once per block. Its rows (tap, c)
//   hold G contiguous values: the product's B operand already in the
//   layout ldmatrix reads without .trans, so the flip costs only the tap
//   index (8 - t') and no flipped or repacked copy exists. A 16-byte XOR
//   swizzle keeps the eight rows of an ldmatrix tile in eight bank groups.
// - mma.sync m16n8k16 (bf16 in, f32 sums), a warp owning 32 rows x WN
//   columns; at small M the warps split the 9*G reduction and their sums
//   are added in warp order in shared memory: no atomics, one launch.
// - The epilogue is built for its bytes: the f32 result is ~60 % of them,
//   and its writes must overlap the products, or the card's write rate
//   bounds a phase of its own (measured: 26 of 77 us at r=64 when the
//   tile's stores followed its products behind a barrier). So a warp gates
//   its finished tile in registers (the forward's rounding: it passes the
//   same elements as the plain version, bit for bit) and writes it during
//   the next tile's taps, a share after each tap; each quad of lanes
//   writes a whole 32-byte sector, and a warp's four neighbouring n8 tiles
//   fill each 128-byte line.
// Bound by bytes (24.4 us at r=64 batch 24, Cb=128 <- G=32: reading dY and
// x, writing the f32 result); measured 70 us there on an H100 80GB HBM3 at
// 700 W (PERF.md, PR 9), the products ~27 us of it.
// ---------------------------------------------------------------------------
constexpr int kDxWarps = 8;
constexpr int kDxThreads = kDxWarps * 32;

struct DxPlan {
  int bm;           // output rows per tile: 32, 64 or 128
  int gb;           // output channels per column group: 16 ... 128
  int ncol;         // column groups
  int stages;       // buffers of the halo, x and vectors: 2 or 1
  int zero_off;     // shared-memory byte offsets: the zero row,
  int stage_off;    //   the first halo stage,
  int stage_bytes;  //   bytes per halo stage,
  int x_off;        //   the first stage of the tile's x rows,
  int x_bytes;      //   bytes per x stage,
  int vec_off;      //   the first stage of its BN vectors [t][inv; shift],
  int vec_bytes;    //   bytes per vector stage,
  int red_off;      //   the split reduction's partial sums
};

// The 16-byte chunk swizzle of a weight row of n chunks: ldmatrix reads
// eight consecutive rows of one chunk, which then land in eight bank
// groups. Stays within the row (n is a multiple of 2, 4 or 8 as tested).
__device__ __forceinline__ int dx_swz(int n, int r) {
  if (n % 8 == 0) return r & 7;
  if (n % 4 == 0) return (r >> 1) & 3;
  if (n % 2 == 0) return (r >> 2) & 1;
  return 0;
}

template <int NTW, bool STE>
__global__ void __launch_bounds__(kDxThreads)
    conv3x3_dx_kernel(const bf16* __restrict__ dy, long long ldd, int M,
                      int H, int W, int G, const bf16* __restrict__ w, int Cb,
                      const bf16* __restrict__ x, long long ldx,
                      const float* __restrict__ inv,
                      const float* __restrict__ shift, long long vstride,
                      int tile_rows, float* __restrict__ out, long long ldo,
                      DxPlan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int WN = NTW * 8;       // output channels of a warp
  constexpr int E = 2 * NTW;        // a warp's (m16, n8) fragments
  const int tiles = (M + p.bm - 1) / p.bm;
  const int items = tiles * p.ncol;
  if ((int)blockIdx.x >= items) return;
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm_n = p.bm / 32, wn_n = p.gb / WN;
  const int wk_n = kDxWarps / (wm_n * wn_n);
  const int wm = warp % wm_n, wn = (warp / wm_n) % wn_n;
  const int wk = warp / (wm_n * wn_n);
  const int gp = (G + 15) / 16 * 16;      // dY channels, zero-padded
  const int kst = gp >> 4, steps = 9 * kst;
  const int s_lo = wk * steps / wk_n, s_hi = (wk + 1) * steps / wk_n;
  const int nchk = gp / 8;                // 16-byte chunks of a weight row
  const int hstride = (gp + kHaloPad) * 2;
  const int halo_rows = p.bm + 2 * W + 2;
  const int xs = p.gb + kHaloPad;         // x row stride, elements
  const int rs = p.gb + 4;                // partial-sum row stride, floats
  const int hw = H * W;
  const int Q = (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;

  for (int i = tid; i < gp / 8; i += kDxThreads)
    *reinterpret_cast<uint4*>(smem + p.zero_off + i * 16) =
        make_uint4(0u, 0u, 0u, 0u);

  const auto item_of = [&](int q) {
    return (int)blockIdx.x + q * (int)gridDim.x;
  };
  // item q's dY halo, x rows and the BN vectors of the tiles t0 .. of its
  // rows, into stage q % stages
  const auto issue = [&](int q) {
    const int it = item_of(q), tile = it % tiles, col = it / tiles;
    const int m0 = tile * p.bm, sq = q % p.stages;
    load_halo(s0 + p.stage_off + sq * p.stage_bytes, dy, ldd, M, G,
              m0 - W - 1, halo_rows, 0, gp, tid, kDxThreads);
    const int xv = p.gb / 8;
    const uint32_t xb = s0 + p.x_off + sq * p.x_bytes;
    for (int i = tid; i < p.bm * xv; i += kDxThreads) {
      const int r = i / xv, v = i - (i / xv) * xv;
      const int m = m0 + r, c = col * p.gb + v * 8;
      const bool ok = m < M && c < Cb;
      cp_async16(xb + (r * xs + v * 8) * 2,
                 ok ? x + (long long)m * ldx + c : x, ok ? 16 : 0);
    }
    const int t0 = m0 / tile_rows;
    const int t1 = ((m0 + p.bm < M ? m0 + p.bm : M) - 1) / tile_rows;
    const uint32_t vb = s0 + p.vec_off + sq * p.vec_bytes;
    for (int i = tid; i < (t1 - t0 + 1) * 2 * p.gb; i += kDxThreads) {
      const int t = i / (2 * p.gb), e = i - t * 2 * p.gb;
      const int which = e / p.gb, c = col * p.gb + (e - which * p.gb);
      const bool ok = c < Cb;
      const float* src = (which ? shift : inv) + (t0 + t) * vstride + c;
      cp_async4(vb + i * 4, ok ? src : inv, ok ? 4 : 0);
    }
    cp_async_commit();
  };
  const auto issue_weight = [&](int col) {
    for (int i = tid; i < 9 * p.gb * nchk; i += kDxThreads) {
      const int r = i / nchk, j = i - (i / nchk) * nchk;
      const int tap = r / p.gb, c = col * p.gb + (r - tap * p.gb);
      const bool ok = c < Cb && j * 8 < G;
      cp_async16(s0 + (r * nchk + (j ^ dx_swz(nchk, r))) * 16,
                 ok ? w + ((long long)tap * Cb + c) * G + j * 8 : w,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };

  // ldmatrix lane coordinates: A rows wm*32 + (l & 15) + 16i at byte offset
  // (l >> 4) * 16; B weight row (mat >> 1) * 8 + (l & 7) of an n16 pair,
  // 16-byte chunk 2 * kk + (mat & 1)
  const int a_row = wm * 32 + (lane & 15);
  const int a_ofs = (lane >> 4) * 16;
  const int b_mat = lane >> 3;
  const int b_row = wn * WN + (b_mat >> 1) * 8 + (lane & 7);
  // this lane's fragment coordinates: row wm*32 + 16i + 8h + f_row,
  // column wn*WN + 8j + f_col (+1)
  const int f_row = lane >> 2, f_col = 2 * (lane & 3);

  // the gated result of the warp's previous tile, written out during the
  // next one (pm0 < 0: none pending)
  float pend[2][NTW][4];
  int pm0 = -1, pc0 = 0, pdone = 0;
  const auto flush = [&](int upto) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e < pdone || e >= upto) continue;
      const int i = e / NTW, j = e % NTW;
      const int c = pc0 + wn * WN + 8 * j + f_col;
      if (c >= Cb) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = pm0 + wm * 32 + 16 * i + 8 * h + f_row;
        if (m < M)
          *reinterpret_cast<float2*>(out + (long long)m * ldo + c) =
              make_float2(pend[i][j][2 * h], pend[i][j][2 * h + 1]);
      }
    }
    pdone = upto > pdone ? upto : pdone;
  };

  float acc[2][NTW][4];
  int wcol = item_of(0) / tiles;
  issue_weight(wcol);
  issue(0);
  for (int q = 0; q < Q; ++q) {
    const int it = item_of(q);
    const int tile = it % tiles, col = it / tiles;
    const int m0 = tile * p.bm, sq = q % p.stages;
    if (p.stages == 1 && q > 0) {
      __syncthreads();                 // every warp is done with stage 0
      issue(q);
    }
    if (col != wcol) {
      __syncthreads();                 // every warp is done with the weight
      issue_weight(col);
      wcol = col;
    }
    cp_async_wait<0>();
    __syncthreads();
    if (p.stages == 2 && q + 1 < Q) issue(q + 1);

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    int yy[2], xx[2];
    bool in_range[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + a_row + 16 * i;
      in_range[i] = m < M;
      const int pix = in_range[i] ? m % hw : 0;
      yy[i] = pix / W;
      xx[i] = pix - yy[i] * W;
    }
    const uint32_t hbase = s0 + p.stage_off + sq * p.stage_bytes;
    const uint32_t zbase = s0 + p.zero_off;
    int share = 0;
    for (int tp = s_lo / kst; tp * kst < s_hi; ++tp) {
      const int k_lo = s_lo > tp * kst ? s_lo - tp * kst : 0;
      const int k_hi = s_hi < (tp + 1) * kst ? s_hi - tp * kst : kst;
      uint32_t abase[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int hr = tap_row(a_row + 16 * i, yy[i], xx[i], in_range[i],
                               tp / 3 - 1, tp % 3 - 1, H, W);
        abase[i] =
            (hr < 0 ? zbase : hbase + (uint32_t)(hr * hstride)) + a_ofs;
      }
      const int rb = (8 - tp) * p.gb + b_row;   // the flipped tap's slice
      for (int kk = k_lo; kk < k_hi; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) ldsm_x4(a[i], abase[i] + kk * 32);
        const int ch = 2 * kk + (b_mat & 1);
#pragma unroll
        for (int jp = 0; jp < NTW / 2; ++jp) {
          const int r = rb + jp * 16;
          uint32_t b[4];
          ldsm_x4(b, s0 + (r * nchk + (ch ^ dx_swz(nchk, r))) * 16);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma16816(acc[i][2 * jp], a[i], b[0], b[1]);
            mma16816(acc[i][2 * jp + 1], a[i], b[2], b[3]);
          }
        }
      }
      // a share of the previous tile's result, under this tap's products
      share += (E + 8) / 9;
      if (pm0 >= 0) flush(share);
    }
    if (pm0 >= 0) flush(E);

    if (wk_n > 1) {
      // the split reduction: warps wk > 0 hand their sums to warp wk = 0
      float* red = reinterpret_cast<float*>(smem + p.red_off);
      const auto at = [&](int k, int i, int j, int h) {
        return red + ((k * p.bm) + wm * 32 + 16 * i + 8 * h + f_row) * rs +
               wn * WN + 8 * j + f_col;
      };
      if (wk > 0)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < NTW; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float2*>(at(wk - 1, i, j, h)) =
                  make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      __syncthreads();
      if (wk == 0)
        for (int k = 0; k < wk_n - 1; ++k)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < NTW; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float2 u = *reinterpret_cast<const float2*>(
                    at(k, i, j, h));
                acc[i][j][2 * h] += u.x;
                acc[i][j][2 * h + 1] += u.y;
              }
    }
    if (wk != 0) continue;

    // the gate, from this tile's x rows and vectors (landed with its halo)
    const unsigned char* xt = smem + p.x_off + sq * p.x_bytes;
    const float* vt =
        reinterpret_cast<const float*>(smem + p.vec_off + sq * p.vec_bytes);
    const int t0 = m0 / tile_rows;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + 16 * i + 8 * h + f_row;
        const int m = m0 + r < M ? m0 + r : M - 1;
        const float* vr = vt + (m / tile_rows - t0) * 2 * p.gb;
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          const int cl = wn * WN + 8 * j + f_col;
          const __nv_bfloat162 xr = *reinterpret_cast<const __nv_bfloat162*>(
              xt + (r * xs + cl) * 2);
          const float2 iv = *reinterpret_cast<const float2*>(vr + cl);
          const float2 sv = *reinterpret_cast<const float2*>(vr + p.gb + cl);
          const float z0 = affine(__low2float(xr), iv.x, sv.x);
          const float z1 = affine(__high2float(xr), iv.y, sv.y);
          const bool p0 = z0 > 0.f && (!STE || bf16r(z0) < 1.f);
          const bool p1 = z1 > 0.f && (!STE || bf16r(z1) < 1.f);
          pend[i][j][2 * h] = p0 ? acc[i][j][2 * h] : 0.f;
          pend[i][j][2 * h + 1] = p1 ? acc[i][j][2 * h + 1] : 0.f;
        }
      }
    pm0 = m0;
    pc0 = col * p.gb;
    pdone = 0;
  }
  if (pm0 >= 0) flush(E);
}

// ---------------------------------------------------------------------------
// sum_rows: out[r] = sum_s in[s, r], s in order (the second pass of every
// row reduction above).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    sum_rows_kernel(const float* __restrict__ in, int S, long long R,
                    float* __restrict__ out) {
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < R;
       r += (long long)gridDim.x * blockDim.x) {
    // eight loads in flight, then added in order: the sum is the same
    float a = 0.f;
    int s = 0;
    for (; s + 8 <= S; s += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = in[(long long)(s + u) * R + r];
#pragma unroll
      for (int u = 0; u < 8; ++u) a += v[u];
    }
    for (; s < S; ++s) a += in[(long long)s * R + r];
    out[r] = a;
  }
}

// ---------------------------------------------------------------------------
// B6 maxpool2_bwd: each pooled cotangent goes to the first (row-major)
// element of its 2x2 window equal to the window max of the recomputed
// ahead; the other three get zero. B7 upsample2_bwd: each low-resolution
// cotangent is the f32 sum of its 2x2 replicas. One thread per 8 channels.
// T is the type of ahead and of the output: bf16, or float32 (a float32
// model: the window's values compared as they are, the cotangent not
// rounded).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    maxpool2_bwd_kernel(const T* __restrict__ a, long long lda,
                        const float* __restrict__ dp, long long ldp,
                        T* __restrict__ o, long long ldo, int B, int H,
                        int W, int C) {
  const int cg = C / 8, Ho = H / 2, Wo = W / 2;
  const long long total = (long long)B * Ho * Wo * cg;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(idx % cg) * 8;
    long long q = idx / cg;
    const int ox = (int)(q % Wo);
    q /= Wo;
    const int oy = (int)(q % Ho);
    const long long b = q / Ho;
    const long long r00 = (b * H + 2 * oy) * W + 2 * ox;
    const long long rows[4] = {r00, r00 + 1, r00 + W, r00 + W + 1};
    Row8<T> v[4];
    float out[4][8];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u].load(a + rows[u] * lda + c);
    float d[8];
    load8f(dp + ((b * Ho + oy) * Wo + ox) * ldp + c, d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float mx = fmaxf(fmaxf(v[0][i], v[1][i]), fmaxf(v[2][i], v[3][i]));
      bool taken = false;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool win = !taken && v[u][i] == mx;
        taken = taken || win;
        out[u][i] = win ? d[i] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) store_row8(o + rows[u] * ldo + c, out[u]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    upsample2_bwd_kernel(const float* __restrict__ d, long long ldd,
                         T* __restrict__ o, long long ldo, int B, int H,
                         int W, int C) {
  const int cg = C / 8, Wh = 2 * W;
  const long long total = (long long)B * H * W * cg;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(idx % cg) * 8;
    long long q = idx / cg;
    const int ix = (int)(q % W);
    q /= W;
    const int iy = (int)(q % H);
    const long long b = q / H;
    const long long r0 = (b * 2 * H + 2 * iy) * Wh + 2 * ix;
    float s[8], t[8];
    load8f(d + r0 * ldd + c, s);
    load8f(d + (r0 + 1) * ldd + c, t);
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] += t[i];
    load8f(d + (r0 + Wh) * ldd + c, t);
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] += t[i];
    load8f(d + (r0 + Wh + 1) * ldd + c, t);
    T* dst = o + ((b * H + iy) * W + ix) * ldo + c;
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] += t[i];
      store8f(dst, s);
    } else {
      Pack8 out;
#pragma unroll
      for (int i = 0; i < 8; ++i) out.u[i] = hi(s[i] + t[i]);
      *reinterpret_cast<uint4*>(dst) = out.v;
    }
  }
}

// ---------------------------------------------------------------------------
// drop_mask: the scaled dropout mask {0, scale} of one out32 view, applied
// (_seed_mask). Element (m, c) of the (M, G) view lies in ghost-BN tile
// t = m / tile_rows at index i = (m % tile_rows) * G + c and is kept iff
//   fmix32(i ^ fmix32(key ^ M1 * (t + 1))) & 0x7FFFFFFF < thr
// with key = fmix32(seed ^ GOLD * (pos + 1)) from the host: the bits of
// cunet_tpu_torch/ops/dropmask.py::tile_mask. Forward (F32_IN false): the
// bf16 view in place, bf16(x * m) (both factors bf16, so the f32 product
// is exact and rounds once, as a bf16 multiply does). Backward: f32 in,
// bf16(d * m) out. The float32 form (TO float, F32_IN): f32 in, f32(x * m)
// out, in place or not, m the float32 scale: the forward and the backward
// of a float32 model. One thread per 8 columns of a row.
// ---------------------------------------------------------------------------
template <bool F32_IN, typename TO>
__global__ void __launch_bounds__(kThreads)
    drop_mask_kernel(const void* in, long long ldi,  // in == out forward
                     TO* out, long long ldo, long long M,
                     int G, long long tile_rows, uint32_t key, uint32_t thr,
                     float scale) {
  const int cg = G / 8;
  const long long total = M * cg;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long m = idx / cg;
    const int c = (int)(idx % cg) * 8;
    const long long t = m / tile_rows;
    const uint32_t k = fmix32(key ^ (0x85EBCA6Bu * (uint32_t)(t + 1)));
    const uint32_t base = (uint32_t)((m - t * tile_rows) * G + c);
    float v[8];
    if (F32_IN) {
      load8f(static_cast<const float*>(in) + m * ldi + c, v);
    } else {
      Pack8 p;
      p.v = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(in) +
                                            m * ldi + c);
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = lo(p, q);
    }
    float r[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const bool keep = (fmix32((base + q) ^ k) & 0x7FFFFFFFu) < thr;
      r[q] = __fmul_rn(v[q], keep ? scale : 0.f);
    }
    if constexpr (sizeof(TO) == 4) {
      float4* po = reinterpret_cast<float4*>(out + m * ldo + c);
      po[0] = make_float4(r[0], r[1], r[2], r[3]);
      po[1] = make_float4(r[4], r[5], r[6], r[7]);
    } else {
      Pack8 o;
#pragma unroll
      for (int q = 0; q < 8; ++q) o.u[q] = hi(r[q]);
      *reinterpret_cast<uint4*>(out + m * ldo + c) = o.v;
    }
  }
}

// ---------------------------------------------------------------------------
// threefry_mask: JAX's drop_impl="masks" dropout, regenerated in the
// kernel instead of read from device memory. The TPU kernels take the
// mask as an input drawn outside (cunet_tpu/kernels/train_slot.py masks
// :425-426, :1389-1390; jax.random.bernoulli on the block key, as
// cunet_tpu/models/cu_net.py::_dropout_mask draws it). Element (m, c) of
// the (M, G) view, M = n * res * res in NHWC order, is the row-major index
// i = m * G + c of the whole batch's (n, res, res, g) mask, so the bits do
// not depend on the ghost-BN tile:
//   (y0, y1) = threefry2x32((k0, k1), (hi32(i), lo32(i)))
//   kept iff ((y0 ^ y1) >> 9) < thr,   thr = ceil(float32(keep) * 2^23)
// (JAX's uniform float (bits >> 9) * 2^-23 below float32(keep)), then
// multiplied by ``scale`` (float32(1/keep) in the compute dtype): the
// bits of cunet_tpu_torch/ops/threefry.py::bernoulli_mask. The forms are
// drop_mask_kernel's: forward (F32_IN false) the bf16 view in place,
// bf16(x * m); backward f32 in, bf16(d * m) out; the float32 form f32 in
// and out. One thread per 8 columns of a row.
// Bound by the integer pipe, not by bytes: threefry2x32 is 20 rounds of
// add / rotate / xor and 6 key injections, about 90 integer operations an
// element, against 4-8 bytes moved. The rotates are funnel shifts; nothing
// else is done about it (a plain kernel first).
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  unsigned long long i) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = (uint32_t)(i >> 32) + k0, x1 = (uint32_t)i + k1;
#define CUNET_TF_ROUND(r) \
  x0 += x1;               \
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
#define CUNET_TF_ROUNDS_A \
  CUNET_TF_ROUND(13) CUNET_TF_ROUND(15) CUNET_TF_ROUND(26) CUNET_TF_ROUND(6)
#define CUNET_TF_ROUNDS_B \
  CUNET_TF_ROUND(17) CUNET_TF_ROUND(29) CUNET_TF_ROUND(16) CUNET_TF_ROUND(24)
  CUNET_TF_ROUNDS_A
  x0 += k1; x1 += k2 + 1u;
  CUNET_TF_ROUNDS_B
  x0 += k2; x1 += k0 + 2u;
  CUNET_TF_ROUNDS_A
  x0 += k0; x1 += k1 + 3u;
  CUNET_TF_ROUNDS_B
  x0 += k1; x1 += k2 + 4u;
  CUNET_TF_ROUNDS_A
  x0 += k2; x1 += k0 + 5u;
#undef CUNET_TF_ROUNDS_B
#undef CUNET_TF_ROUNDS_A
#undef CUNET_TF_ROUND
  return x0 ^ x1;
}

template <bool F32_IN, typename TO>
__global__ void __launch_bounds__(kThreads)
    threefry_mask_kernel(const void* in, long long ldi,  // in == out fwd
                         TO* out, long long ldo, long long M, int G,
                         uint32_t k0, uint32_t k1, uint32_t thr,
                         float scale) {
  const int cg = G / 8;
  const long long total = M * cg;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long m = idx / cg;
    const int c = (int)(idx % cg) * 8;
    const unsigned long long base = (unsigned long long)(m * G + c);
    float v[8];
    if (F32_IN) {
      load8f(static_cast<const float*>(in) + m * ldi + c, v);
    } else {
      Pack8 p;
      p.v = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(in) +
                                            m * ldi + c);
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = lo(p, q);
    }
    float r[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const bool keep = (threefry_bits(k0, k1, base + q) >> 9) < thr;
      r[q] = __fmul_rn(v[q], keep ? scale : 0.f);
    }
    if constexpr (sizeof(TO) == 4) {
      float4* po = reinterpret_cast<float4*>(out + m * ldo + c);
      po[0] = make_float4(r[0], r[1], r[2], r[3]);
      po[1] = make_float4(r[4], r[5], r[6], r[7]);
    } else {
      Pack8 o;
#pragma unroll
      for (int q = 0; q < 8; ++q) o.u[q] = hi(r[q]);
      *reinterpret_cast<uint4*>(out + m * ldo + c) = o.v;
    }
  }
}

unsigned grid_blocks(long long total) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  return (unsigned)(blocks < (1LL << 20) ? (blocks > 0 ? blocks : 1)
                                         : (1LL << 20));
}

struct VecArgs {
  const float* inv;
  const float* shift;
  long long vstride;
  long long tile_rows;
  int bits;  // QuanInput bits of a dw prologue, or the ste flag of a dx
};

template <int NTW>
int launch_dx(const bf16* dy, long long ldd, int M, int N, const bf16* w,
              int ldw, int K, const bf16* x, long long ldx, VecArgs v,
              float* out, long long ldo, const AffineDxPlan& p, int smem,
              cudaStream_t st) {
  const int items = (M + p.bm - 1) / p.bm * p.nkb;
  auto kern = v.bits ? dx_kernel<NTW, true> : dx_kernel<NTW, false>;
  int grid = 0;
  const int e = persistent_grid(kern, items, kThreads, smem, p.nkb, &grid);
  if (e) return e;
  kern<<<grid, kThreads, smem, st>>>(dy, ldd, M, N, w, ldw, K, x, ldx, v.inv,
                                     v.shift, v.vstride, (int)v.tile_rows,
                                     out, ldo, p);
  return (int)cudaGetLastError();
}

template <int NTW, int WN>
int launch_affine_dw(const bf16* x, long long ldx, int M, int K, VecArgs v,
                     const bf16* dy, long long ldd, int N, float* part,
                     const AffineDwPlan& p, dim3 grid, int smem,
                     cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      affine_dw_kernel<NTW, WN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  affine_dw_kernel<NTW, WN><<<grid, kThreads, smem, st>>>(
      x, ldx, M, K, v.inv, v.shift, v.vstride, v.tile_rows, v.bits, dy, ldd,
      N, part, p);
  return (int)cudaGetLastError();
}

// bn_bwd's blocks, the cs blocks of a tile's channel block one cluster
template <bool ACC, typename XT>
int launch_bn_bwd(const XT* x, long long ldx, const float* da,
                  long long ldd, long long tile_rows, int T, int K,
                  const float* stats, const float* gamma, float eps,
                  float* dx, long long lddx, float* part, const BnPlan& p,
                  int smem, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      bn_bwd_kernel<ACC, XT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)p.cs;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((K + p.cb - 1) / p.cb), (unsigned)(T * p.cs));
  cfg.blockDim = dim3(kBnThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = p.cs > 1;          // a lone block is a cluster of one
  e = cudaLaunchKernelEx(&cfg, bn_bwd_kernel<ACC, XT>, x, ldx, da, ldd,
                         tile_rows, K, stats, gamma, eps, dx, lddx, part, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The float32 bn_bwd where its plan is persistent: as many clusters of
// p.cs blocks along x as the card holds at once
// (cudaOccupancyMaxActiveClusters), at most one an item.
template <bool ACC>
int launch_bn_bwd_f32(const float* x, long long ldx, const float* da,
                      long long ldd, long long tile_rows, int T, int K,
                      const float* stats, const float* gamma, float eps,
                      float* dx, long long lddx, float* part,
                      const BnPlan& p, int smem, cudaStream_t st) {
  const int stripes = kBnThreads / (p.cb / 4);
  const int rows = (p.rpb + stripes - 1) / stripes;
  // the accumulating form holds at most 16 rows a thread (its plan): one
  // instance
  if (p.cb % 4 || rows > (ACC ? 16 : 24)) return (int)cudaErrorInvalidValue;
  const auto kern = [rows] {
    if constexpr (ACC)
      return bn_bwd_f32_kernel<true, 16>;
    else
      return rows > 16 ? bn_bwd_f32_kernel<false, 24>
                       : bn_bwd_f32_kernel<false, 16>;
  }();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && p.cs > 8)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.cs);
  cfg.blockDim = dim3(kBnThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int held = 0;
  e = cudaOccupancyMaxActiveClusters(&held, kern, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (held < 1) return (int)cudaErrorInvalidConfiguration;
  const int items = T * ((K + p.cb - 1) / p.cb);
  cfg.gridDim = dim3((unsigned)((held < items ? held : items) * p.cs));
  e = cudaLaunchKernelEx(&cfg, kern, x, ldx, da, ldd, tile_rows, T, K, stats,
                         gamma, eps, dx, lddx, part, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int NT>
int launch_conv3x3_dw(const bf16* x, long long ldx, int M, int H, int W,
                      int C, VecArgs v, const bf16* dy, long long ldd, int G,
                      float* part, const DwPlan& p, dim3 grid, int smem,
                      cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      conv3x3_dw_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  conv3x3_dw_kernel<NT><<<grid, kDwThreads, smem, st>>>(
      x, ldx, M, H, W, C, v.inv, v.shift, v.vstride, (int)v.tile_rows,
      v.bits, dy, ldd, G, part, p);
  return (int)cudaGetLastError();
}

template <int NTW>
int launch_conv3x3_dx(const bf16* dy, long long ldd, int M, int H, int W,
                      int G, const bf16* w, int Cb, const bf16* x,
                      long long ldx, VecArgs v, float* out, long long ldo,
                      const DxPlan& p, int smem, cudaStream_t st) {
  const int items = (M + p.bm - 1) / p.bm * p.ncol;
  auto kern = v.bits ? conv3x3_dx_kernel<NTW, true>
                     : conv3x3_dx_kernel<NTW, false>;
  return launch_persistent(kern, items, kDxThreads, smem, st, dy, ldd, M, H,
                           W, G, w, Cb, x, ldx, v.inv, v.shift, v.vstride,
                           (int)v.tile_rows, out, ldo, p);
}

}  // namespace

extern "C" {

// x bf16 (f32 = 0) or float32 (f32 = 1: a tile's rows split across
// clusters of cs blocks of rpb rows, train_ops.stats_plan_f32).
int cunet_bn_stats(const void* x, long long ldx, long long M,
                   long long tile_rows, int K, void* out, int f32, int cs,
                   int rpb, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned T = (unsigned)(M / tile_rows);
  const unsigned kb = (unsigned)((K + kStatCols - 1) / kStatCols);
  if (!f32) {
    bn_stats_kernel<<<dim3(T, kb), kThreads, 0, st>>>(
        static_cast<const bf16*>(x), ldx, tile_rows, K,
        static_cast<float*>(out));
    return (int)cudaGetLastError();
  }
  if (cs > 8) {                     // past the portable cluster
    const cudaError_t e = cudaFuncSetAttribute(
        bn_stats_f32_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
        1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)cs;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kb, T * (unsigned)cs);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1;            // a lone block is a cluster of one
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, bn_stats_f32_kernel, static_cast<const float*>(x), ldx,
      tile_rows, K, cs, rpb, static_cast<float*>(out));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// x bf16 (f32 = 0) or float32 (f32 = 1).
// persistent = 1: the float32 x on bn_bwd_f32_kernel (its plan's rc = rpb,
// one item buffer).
int cunet_bn_bwd(const void* x, long long ldx, const void* da, long long ldd,
                 long long M, long long tile_rows, int K, const void* stats,
                 const void* gamma, float eps, void* dx, long long lddx,
                 int accumulate, void* part, int cb, int cs, int rpb, int rc,
                 int slots, int smem, int f32, int persistent,
                 void* stream) {
  const BnPlan p{cb, cs, rpb, rc, slots};
  const int T = (int)(M / tile_rows);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* dp = static_cast<const float*>(da);
  const auto* sp = static_cast<const float*>(stats);
  const auto* gp = static_cast<const float*>(gamma);
  auto* op = static_cast<float*>(dx);
  auto* pp = static_cast<float*>(part);
  if (f32 && persistent) {
    const auto* xp = static_cast<const float*>(x);
    if (accumulate)
      return launch_bn_bwd_f32<true>(xp, ldx, dp, ldd, tile_rows, T, K, sp,
                                     gp, eps, op, lddx, pp, p, smem, st);
    return launch_bn_bwd_f32<false>(xp, ldx, dp, ldd, tile_rows, T, K, sp, gp,
                                    eps, op, lddx, pp, p, smem, st);
  }
  if (f32) {
    const auto* xp = static_cast<const float*>(x);
    if (accumulate)
      return launch_bn_bwd<true>(xp, ldx, dp, ldd, tile_rows, T, K, sp, gp,
                                 eps, op, lddx, pp, p, smem, st);
    return launch_bn_bwd<false>(xp, ldx, dp, ldd, tile_rows, T, K, sp, gp,
                                eps, op, lddx, pp, p, smem, st);
  }
  const auto* xp = static_cast<const bf16*>(x);
  if (accumulate)
    return launch_bn_bwd<true>(xp, ldx, dp, ldd, tile_rows, T, K, sp, gp,
                               eps, op, lddx, pp, p, smem, st);
  return launch_bn_bwd<false>(xp, ldx, dp, ldd, tile_rows, T, K, sp, gp, eps,
                              op, lddx, pp, p, smem, st);
}

int cunet_dx(const void* dy, long long ldd, long long M, int N,
             const void* w, int ldw, int K, const void* x,
             long long ldx, const void* inv, const void* shift,
             long long vstride, long long tile_rows, int ste, void* out,
             long long ldo, int bm, int kc, int nkb, int ntw, int np,
             int stages, int w_bytes, int dy_bytes, int stage_bytes,
             int smem, void* stream) {
  const VecArgs v{static_cast<const float*>(inv),
                  static_cast<const float*>(shift), vstride, tile_rows, ste};
  const AffineDxPlan p{bm, kc, nkb, np, stages, w_bytes, dy_bytes,
                       stage_bytes};
  const auto* dp = static_cast<const bf16*>(dy);
  const auto* wp = static_cast<const bf16*>(w);
  const auto* xp = static_cast<const bf16*>(x);
  auto* op = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const int m = (int)M;
  switch (ntw) {
#define CUNET_DX1_NTW(n)                                                 \
  case n:                                                                \
    return launch_dx<n>(dp, ldd, m, N, wp, ldw, K, xp, ldx, v, op, ldo, p, \
                        smem, st);
    CUNET_DX1_NTW(1) CUNET_DX1_NTW(2) CUNET_DX1_NTW(3) CUNET_DX1_NTW(4)
#undef CUNET_DX1_NTW
  }
  return (int)cudaErrorInvalidValue;
}

int cunet_conv3x3_dx(const void* dy, long long ldd, long long M, int H,
                     int W, int G, const void* w, int Cb, const void* x,
                     long long ldx, const void* inv, const void* shift,
                     long long vstride, long long tile_rows, int ste,
                     void* out, long long ldo, int bm, int gb, int wn,
                     int ncol, int stages, int zero_off, int stage_off,
                     int stage_bytes, int x_off, int x_bytes, int vec_off,
                     int vec_bytes, int red_off, int smem, void* stream) {
  const VecArgs v{static_cast<const float*>(inv),
                  static_cast<const float*>(shift), vstride, tile_rows, ste};
  const DxPlan p{bm,    gb,      ncol,    stages,  zero_off,  stage_off,
                 stage_bytes, x_off, x_bytes, vec_off, vec_bytes, red_off};
  const auto* dp = static_cast<const bf16*>(dy);
  const auto* wp = static_cast<const bf16*>(w);
  const auto* xp = static_cast<const bf16*>(x);
  auto* op = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const int m = (int)M;
  switch (wn) {
#define CUNET_DX_WN(n)                                                   \
  case n:                                                                \
    return launch_conv3x3_dx<n / 8>(dp, ldd, m, H, W, G, wp, Cb, xp, ldx, \
                                    v, op, ldo, p, smem, st);
    CUNET_DX_WN(16) CUNET_DX_WN(32) CUNET_DX_WN(64)
#undef CUNET_DX_WN
  }
  return (int)cudaErrorInvalidValue;
}

int cunet_dw(const void* x, long long ldx, long long M, int K,
             const void* inv, const void* shift, long long vstride,
             long long tile_rows, int bits, const void* dy, long long ldd,
             int N, void* part, int runs, int run_rows, int br, int kc,
             int ncol, int stages, int x_bytes, int stage_bytes, int smem,
             void* stream) {
  const VecArgs v{static_cast<const float*>(inv),
                  static_cast<const float*>(shift), vstride, tile_rows, bits};
  const AffineDwPlan p{run_rows, br, kc, ncol, stages, x_bytes, stage_bytes};
  const dim3 grid((unsigned)runs, (unsigned)((K + kc - 1) / kc),
                  (unsigned)((N + ncol - 1) / ncol));
  const auto* xp = static_cast<const bf16*>(x);
  const auto* dp = static_cast<const bf16*>(dy);
  auto* pp = static_cast<float*>(part);
  const auto st = static_cast<cudaStream_t>(stream);
  const int m = (int)M;
  switch (ncol) {
    case 128:
      return launch_affine_dw<4, 4>(xp, ldx, m, K, v, dp, ldd, N, pp, p,
                                    grid, smem, st);
    case 64:
      return launch_affine_dw<4, 2>(xp, ldx, m, K, v, dp, ldd, N, pp, p,
                                    grid, smem, st);
    case 32:
      return launch_affine_dw<4, 1>(xp, ldx, m, K, v, dp, ldd, N, pp, p,
                                    grid, smem, st);
    case 16:
      return launch_affine_dw<2, 1>(xp, ldx, m, K, v, dp, ldd, N, pp, p,
                                    grid, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}

int cunet_conv3x3_dw(const void* x, long long ldx, long long M, int H, int W,
                     int C, const void* inv, const void* shift,
                     long long vstride, long long tile_rows, int bits,
                     const void* dy, long long ldd, int G, void* part,
                     int runs, int run_rows, int br, int kc, int nt,
                     int stages, int zero_off, int stage_off,
                     int stage_bytes, int dy_off, int smem, void* stream) {
  const VecArgs v{static_cast<const float*>(inv),
                  static_cast<const float*>(shift), vstride, tile_rows, bits};
  const DwPlan p{run_rows, br, kc, stages, zero_off, stage_off, stage_bytes,
                 dy_off};
  const dim3 grid((unsigned)runs, (unsigned)((C + kc - 1) / kc),
                  (unsigned)((G + nt * 8 - 1) / (nt * 8)));
  const auto* xp = static_cast<const bf16*>(x);
  const auto* dp = static_cast<const bf16*>(dy);
  auto* pp = static_cast<float*>(part);
  const auto st = static_cast<cudaStream_t>(stream);
  const int m = (int)M;
  switch (nt) {
#define CUNET_DW_NT(n)                                                     \
  case n:                                                                  \
    return launch_conv3x3_dw<n>(xp, ldx, m, H, W, C, v, dp, ldd, G, pp, p, \
                                grid, smem, st);
    CUNET_DW_NT(1) CUNET_DW_NT(2) CUNET_DW_NT(3) CUNET_DW_NT(4)
#undef CUNET_DW_NT
  }
  return (int)cudaErrorInvalidValue;
}

int cunet_sum_rows(const void* in, int S, long long R, void* out,
                   void* stream) {
  sum_rows_kernel<<<grid_blocks(R), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), S, R, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// ahead and out bf16 (f32 = 0) or float32 (f32 = 1).
int cunet_maxpool2_bwd(const void* a, long long lda, const void* dp,
                       long long ldp, void* out, long long ldo, int B, int H,
                       int W, int C, int f32, void* stream) {
  const long long total = (long long)B * (H / 2) * (W / 2) * (C / 8);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const float*>(dp);
  if (f32)
    maxpool2_bwd_kernel<float><<<grid_blocks(total), kThreads, 0, st>>>(
        static_cast<const float*>(a), lda, d, ldp, static_cast<float*>(out),
        ldo, B, H, W, C);
  else
    maxpool2_bwd_kernel<bf16><<<grid_blocks(total), kThreads, 0, st>>>(
        static_cast<const bf16*>(a), lda, d, ldp, static_cast<bf16*>(out),
        ldo, B, H, W, C);
  return (int)cudaGetLastError();
}

// out bf16 (f32 = 0) or float32 (f32 = 1).
int cunet_upsample2_bwd(const void* d, long long ldd, void* out,
                        long long ldo, int B, int H, int W, int C, int f32,
                        void* stream) {
  const long long total = (long long)B * H * W * (C / 8);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* dp = static_cast<const float*>(d);
  if (f32)
    upsample2_bwd_kernel<float><<<grid_blocks(total), kThreads, 0, st>>>(
        dp, ldd, static_cast<float*>(out), ldo, B, H, W, C);
  else
    upsample2_bwd_kernel<bf16><<<grid_blocks(total), kThreads, 0, st>>>(
        dp, ldd, static_cast<bf16*>(out), ldo, B, H, W, C);
  return (int)cudaGetLastError();
}

// f32_in 0: bf16 in place; 1: float32 in, bf16 out; 2: float32 in and out
// (the float32 form).
int cunet_drop_mask(const void* in, long long ldi, int f32_in, void* out,
                    long long ldo, long long M, int G, long long tile_rows,
                    unsigned int key, unsigned int thr, float scale,
                    void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<bf16*>(out);
  const unsigned blocks = grid_blocks(M * (G / 8));
  if (f32_in == 2)
    drop_mask_kernel<true, float><<<blocks, kThreads, 0, st>>>(
        in, ldi, static_cast<float*>(out), ldo, M, G, tile_rows, key, thr,
        scale);
  else if (f32_in)
    drop_mask_kernel<true, bf16><<<blocks, kThreads, 0, st>>>(
        in, ldi, op, ldo, M, G, tile_rows, key, thr, scale);
  else
    drop_mask_kernel<false, bf16><<<blocks, kThreads, 0, st>>>(
        in, ldi, op, ldo, M, G, tile_rows, key, thr, scale);
  return (int)cudaGetLastError();
}

// The forms of cunet_drop_mask: f32_in 0 bf16 in place, 1 float32 in and
// bf16 out, 2 float32 in and out; (k0, k1) the block's threefry key.
int cunet_threefry_mask(const void* in, long long ldi, int f32_in, void* out,
                        long long ldo, long long M, int G, unsigned int k0,
                        unsigned int k1, unsigned int thr, float scale,
                        void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<bf16*>(out);
  const unsigned blocks = grid_blocks(M * (G / 8));
  if (f32_in == 2)
    threefry_mask_kernel<true, float><<<blocks, kThreads, 0, st>>>(
        in, ldi, static_cast<float*>(out), ldo, M, G, k0, k1, thr, scale);
  else if (f32_in)
    threefry_mask_kernel<true, bf16><<<blocks, kThreads, 0, st>>>(
        in, ldi, op, ldo, M, G, k0, k1, thr, scale);
  else
    threefry_mask_kernel<false, bf16><<<blocks, kThreads, 0, st>>>(
        in, ldi, op, ldo, M, G, k0, k1, thr, scale);
  return (int)cudaGetLastError();
}

const char* cunet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
