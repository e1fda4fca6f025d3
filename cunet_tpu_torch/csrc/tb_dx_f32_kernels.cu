// Hand-written Hopper kernel of the float32 input cotangents of the train
// bottleneck (#7's bwd_dx at compute_dtype="float32"; cunet_tpu_torch/
// kernels/train_bottleneck.py wraps it, plan train_bottleneck.dx_f32_plan):
//   dx = (scale * inv_sigma) * ((g_y - red0) - x_hat * red1),
//   g_y = [y > 0] (g W^T)[m, c],
// for each feature group's float32 dx, with red = [mean g_y; mean g_y
// x_hat] (the reduce's sums over M), x_hat = (x - mean) * inv_sigma and
// y = x_hat * scale + bias recomputed from x. It replaces, at float32,
// _bwd_dx_kernel (cunet_tpu/kernels/train_bottleneck.py:134, called at
// :296); bottleneck_kernels.cu's tb_bwd_dx_kernel is the bf16 form.
//
// Arithmetic: g and W enter as the three bf16 planes of their exact split
// (common.cuh split3), and each k16 step of the depth N adds the six plane
// products g_i W_j with i + j <= 4 (1-based), small terms first: g1 W3,
// g2 W2, g1 W2, g3 W1, g2 W1, g1 W1, into one float32 accumulator over N,
// k16 steps over N ascending: the instruction sequence of
// tb_bwd_reduce_f32_kernel's g W^T (bottleneck_kernels.cu), so the gate
// takes the g_y the reduce summed. A step's first product takes wgmma's
// scale-d 0 in place of a zeroed accumulator: an instruction writing an
// accumulator register between two wgmmas makes ptxas serialize them
// (C7515), each wgmma then waiting for the one before. The epilogue rounds
// once per operation in the plain version's order (recompute, gate,
// jacobian).
//
// What bounds it on the card: bytes. At K=320 -> 128, r=64, batch 24 it
// reads x (126 MB) and g (50 MB as float32; the planes it reads are 75
// MB) and writes dx (126 MB): 90.2 us at 3.35 TB/s; its six bf16 passes
// take 48.8 us at 989 TFLOP/s. Design:
// - g's planes come from tb_split_g_kernel (bottleneck_kernels.cu), the
//   reduce's pre-pass: per 64-row tile, core matrices of 8 outputs x 8
//   rows (16 bytes a row: one output's 8 consecutive rows), in halves of
//   128 outputs. The backward hands the reduce's planes over, so no block
//   splits g, and a half's plane is 16 KB in one piece.
// - Persistent blocks, one an SM; block b keeps the column group b % ngrp
//   of kDfCols concat columns: its W rows split once into three bf16
//   planes of core matrices in shared memory (halo.cuh split_w_cores),
//   its x and dx chunks resolved from the feature table once, its
//   columns' BN constants in shared memory. It walks 64-row steps b /
//   ngrp, + grid / ngrp, ...: the blocks of a step run side by side, so
//   each plane tile comes from HBM about once.
// - The block's two warpgroups take every other one of its steps, each
//   with its own g stage (a half of a step's planes) and x stage and its
//   own barriers (named barriers of 128 threads), so one's epilogue runs
//   beside the other's products. A warpgroup takes its step's 64 rows x
//   kDfCols columns by wgmma m64n64k16: A = g's planes in registers by
//   ldmatrix.trans from the core matrices (double-buffered, so a k16
//   step's loads run under the previous one's products), B = W's planes
//   by a shared-memory descriptor. It issues its next half's copies as
//   soon as its products have read the stage, and its next step's x rows
//   once its epilogue is done with them.
// - The epilogue reads x from the stage and writes each dx in place of
//   its x; the tile then leaves in 16-byte vectors, a warp's store two
//   whole rows of the block's columns (4 full 128-byte lines where a
//   feature group holds them). Storing 8 bytes a lane straight from the
//   accumulators (8 rows of 32 bytes a warp) measured slower (PERF.md
//   section 6), as did a ring of g stages shared by both warpgroups and
//   smaller items.
//
// The entry point launches on the stream it is given and returns
// cudaGetLastError().

#include "halo.cuh"

namespace {

constexpr int kDfRows = 64;    // rows of a step: one tile of g's planes
constexpr int kDfN = 128;      // outputs of a plane tile's half
constexpr int kDfTile = kDfRows * kDfN;   // elements of a half's plane
constexpr int kDfPlane = kDfTile * 2;     // its bytes
constexpr int kDfCols = 64;    // concat columns of a block
constexpr int kDfXBytes = kDfRows * kDfCols * 4;   // bytes of an x stage
constexpr int kDfChunks = kDfCols / 8;
constexpr int kDfWg = 128;     // threads of a warpgroup

// The block's shared memory (train_bottleneck.dx_f32_plan computes the
// same): W's three planes (kDfCols columns x np bf16 in core matrices of 8
// columns x 8 outputs, split_w_cores), each warpgroup's g stage (a half's
// three planes) and x stage (a step's rows of kDfCols floats, 16-byte
// vectors swizzled by the row: x_swz), the columns' BN constants ([mean,
// inv_sigma, scale, bias] and [red0, red1, scale * inv_sigma, 0], two
// float4 a column), then the x and dx chunks.
struct DfLayout {
  int wpl;        // bytes of one W plane (0: W streamed)
  int g_off;      // warpgroup 0's g stage (warpgroup 1's follows)
  int x_off;      // warpgroup 0's x stage (warpgroup 1's follows)
  int sw_off;     // warpgroup 0's W slice stage (streamed W; 1's follows)
  int kon_off;    // the BN constants
  int ch_off;     // the x chunks, then the dx chunks
  int bytes;
};

// Past kWideN outputs W's planes do not stay resident: each warpgroup
// stages the slice of them its g half reads (halo.cuh split_w_slices,
// core matrices, 3 x 16 KB) beside the half's g planes.
inline DfLayout df_layout(int np) {
  const bool stream = np > kWideN;
  DfLayout l;
  l.wpl = stream ? 0 : kDfCols * np * 2;
  l.g_off = 3 * l.wpl;
  l.x_off = l.g_off + 2 * 3 * kDfPlane;
  l.sw_off = l.x_off + 2 * kDfXBytes;
  l.kon_off = l.sw_off + (stream ? 2 * 3 * kDfPlane : 0);
  l.ch_off = l.kon_off + kDfCols * 32;
  l.bytes = l.ch_off + 2 * kDfChunks * 16;
  return l;
}

// Byte offset of row r's 16-byte vector v (columns 4v .. 4v + 3) in an x
// stage: the vector index XORed with 2 (r % 8), which keeps a chunk's two
// vectors together and puts the epilogue's 8-byte accesses (eight rows,
// two vectors a row per warp) in distinct bank groups.
__device__ __forceinline__ int x_swz(int r, int v) {
  return r * kDfCols * 4 + ((v ^ (2 * (r & 7))) << 4);
}

// dx of one element: x, its g_y before the gate (gv), the column's
// constants k = [mean, inv_sigma, scale, bias], r = [red0, red1, scale *
// inv_sigma, 0]; one rounding per operation.
__device__ __forceinline__ float dx_of(float x, float gv, const float4& k,
                                       const float4& r) {
  const float xh = xhat_of(x, k.x, k.y);
  const float gy = ybn_of(xh, k.z, k.w) > 0.f ? gv : 0.f;
  return __fmul_rn(r.z, __fsub_rn(__fsub_rn(gy, r.x), __fmul_rn(xh, r.y)));
}

// A barrier of warpgroup wg's 128 threads alone (named barrier 1 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kDfWg) : "memory");
}

// STREAM: np > kWideN, W's planes staged a half at a time from the slice
// images ws (halo.cuh split_w_slices) of the block's column group.
template <bool STREAM>
__global__ void __launch_bounds__(kThreads, 1)
    tb_bwd_dx_f32_kernel(const long long* __restrict__ tbl, int G, int M,
                         int Ctot, const bf16* __restrict__ gp, int N,
                         const float* __restrict__ stat,
                         const float* __restrict__ bias,
                         const float* __restrict__ red,
                         const float* __restrict__ w,
                         const bf16* __restrict__ ws, DfLayout L) {
  constexpr int J = kDfCols / 8;    // n8 column tiles of a block
  constexpr int XV = kDfCols / 4;   // 16-byte vectors of an x row
  const int np = (N + 15) / 16 * 16;
  const int nh = (np + kDfN - 1) / kDfN;   // halves (slices) of a step
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ngrp = (Ctot + kDfCols - 1) / kDfCols;
  const int c0 = (blockIdx.x % ngrp) * kDfCols;
  const int steps = (M + kDfRows - 1) / kDfRows;
  const int first = blockIdx.x / ngrp, stride = gridDim.x / ngrp;
  if (first >= steps) return;
  const int Q = (steps - 1 - first) / stride + 1;   // the block's steps
  const long long plane = (long long)steps * nh * kDfTile;   // elements
  Chunk* ch = reinterpret_cast<Chunk*>(smem + L.ch_off);   // x, then dx
  float4* kon = reinterpret_cast<float4*>(smem + L.kon_off);

  if (tid < 2 * kDfChunks)
    ch[tid] = table_chunk<float>(tbl, G, Ctot, c0 + (tid % kDfChunks) * 8,
                                 tid < kDfChunks ? 0 : 4);
  if (tid < kDfCols) {
    const int c = c0 + tid;
    float4 k = make_float4(0.f, 0.f, 0.f, 0.f), r = k;
    if (c < Ctot) {
      const float is = stat[Ctot + c], sc = stat[2 * Ctot + c];
      k = make_float4(stat[c], is, sc, bias[c]);
      r = make_float4(red[c], red[Ctot + c], __fmul_rn(sc, is), 0.f);
    }
    kon[2 * tid] = k;
    kon[2 * tid + 1] = r;
  }
  // W's rows c0 .. c0 + kDfCols split once into three planes of core
  // matrices, made visible to wgmma
  if (!STREAM) split_w_cores<kDfCols>(smem, w, Ctot, N, c0, np, tid, kThreads);
  fence_proxy_async();
  __syncthreads();

  // From here each warpgroup works alone on the block's steps wg, wg + 2,
  // ... with its own stages, copies and barriers. Its warp wq: rows
  // wq*16 + g8 (+8) of a step, columns 8j + 2*q4 (+1) of each n8 tile j
  // (wgmma's accumulator layout).
  const int wg = warp >> 2, wq = warp & 3, wt = tid & (kDfWg - 1);
  const int g8 = lane >> 2, q4 = lane & 3, mat = lane >> 3;
  if (wg >= Q) return;
  const uint32_t gs = s0 + L.g_off + wg * 3 * kDfPlane;
  const uint32_t wst = s0 + L.sw_off + wg * 3 * kDfPlane;   // (STREAM)
  const uint32_t xst = s0 + L.x_off + wg * kDfXBytes;
  unsigned char* xs = smem + (xst - s0);
  // half h of the block's step i: the three planes' core matrices of its
  // outputs (contiguous in the tile) into the g stage; step i's x rows (a
  // row past M or a chunk past Ctot is not read: never stored) into the x
  // stage. Each commits one group (empty past the block's last step), so
  // the groups keep their order.
  const auto issue_g = [&](int i, int h) {
    if (i < Q) {
      const long long t = first + (long long)i * stride;
      const int per = min(np - h * kDfN, kDfN) * 8;   // vectors
      const bf16* src = gp + (t * nh + h) * kDfTile;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        for (int v = wt; v < per; v += kDfWg)
          cp_async16(gs + k * kDfPlane + v * 16, src + k * plane + v * 8,
                     16);
      if (STREAM) {
        // W's planes of the half, of the block's column group
        const bf16* wsrc =
            ws + ((long long)(c0 / kDfCols) * nh + h) * 3 * slice_plane(true);
        for (int v = wt; v < 3 * kDfPlane / 16; v += kDfWg)
          cp_async16(wst + v * 16, wsrc + v * 8, 16);
      }
    }
    cp_async_commit();
  };
  const auto issue_x = [&](int i) {
    if (i < Q) {
      const long long m0 = (first + (long long)i * stride) * kDfRows;
      for (int e = wt; e < kDfRows * XV; e += kDfWg) {
        const int r = e / XV, v = e % XV;
        const Chunk c = ch[v >> 1];
        if (c.ptr && m0 + r < M)
          cp_async16(xst + x_swz(r, v),
                     reinterpret_cast<const char*>(c.ptr) +
                         ((m0 + r) * c.ld + (v & 1) * 4) * 4,
                     16);
      }
    }
    cp_async_commit();
  };
  issue_g(wg, 0);
  issue_x(wg);

  float acc[J * 4];   // g W^T of the step
  for (int i = wg; i < Q; i += 2) {
    for (int h = 0; h < nh; ++h) {
      // the half landed (with h = 0 the step's x, committed after it, may
      // still be on its way)
      if (h == 0) cp_async_wait<1>();
      else cp_async_wait<0>();
      wg_sync(wg);
      // g W^T over the half's k16 steps (N's own count, the reduce's): A
      // = g's planes by ldmatrix.trans from the core matrices (n group
      // 2kk + (mat >> 1), m group 2wq + (mat & 1)), B = W's planes; six
      // plane products a k16 step into one accumulator over N, the step's
      // first product with d's scale 0
      const int nkk = min(np - h * kDfN, kDfN) / 16;
      uint32_t a[2][3][4];
#pragma unroll
      for (int kk = 0; kk < kDfN / 16; ++kk) {
        if (kk >= nkk) break;
        if (kk >= 2) wgmma_wait<1>();   // the group of kk - 2 read a[kk & 1]
#pragma unroll
        for (int pg = 0; pg < 3; ++pg)
          ldsm_x4_t(a[kk & 1][pg],
                    gs + pg * kDfPlane +
                        ((2 * kk + (mat >> 1)) * 8 + 2 * wq + (mat & 1)) *
                            128 +
                        (lane & 7) * 16);
        const int kn = (kDfN / 16) * h + kk;   // the k16 step within N
        const auto bd = [&](int pw) {
          return STREAM ? smem_desc(wst + pw * kDfPlane + 2 * kk * 128, 128,
                                    kDfN * 16)
                        : smem_desc(s0 + pw * L.wpl + 2 * kn * 128, 128,
                                    np * 16);
        };
        const uint32_t (&ak)[3][4] = a[kk & 1];
        wgmma_fence();
        wgmma_m64n64(acc, ak[0], bd(2), kn);
        wgmma_m64n64(acc, ak[1], bd(1));
        wgmma_m64n64(acc, ak[0], bd(1));
        wgmma_m64n64(acc, ak[2], bd(0));
        wgmma_m64n64(acc, ak[1], bd(0));
        wgmma_m64n64(acc, ak[0], bd(0));
        wgmma_commit();
      }
      // the g stage read (and, streamed, the W stage, which the products
      // read as they run): the next half's copies may start
      if (STREAM) wgmma_wait<0>();
      wg_sync(wg);
      if (h + 1 < nh) issue_g(i, h + 1);
      else issue_g(i + 2, 0);
      wgmma_wait<0>();
    }
#pragma unroll
    for (int e = 0; e < J * 4; ++e) reg_fence(acc[e]);

    // the epilogue: x from the staged rows, each dx in place of its x,
    // then the tile out to each chunk's dx tensor as 16-byte vectors
    cp_async_wait<1>();   // the step's x (the next half's g may pend)
    wg_sync(wg);
    const int m0 = (first + i * stride) * kDfRows;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int cl = 8 * j + 2 * q4;
      const float4 k0 = kon[2 * cl], r0 = kon[2 * cl + 1];
      const float4 k1 = kon[2 * cl + 2], r1 = kon[2 * cl + 3];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float2* px = reinterpret_cast<float2*>(
            xs + x_swz(wq * 16 + g8 + 8 * hh, cl >> 2) + (cl & 3) * 4);
        const float2 xv = *px;
        *px = make_float2(dx_of(xv.x, acc[4 * j + 2 * hh], k0, r0),
                          dx_of(xv.y, acc[4 * j + 2 * hh + 1], k1, r1));
      }
    }
    wg_sync(wg);
    for (int e = wt; e < kDfRows * XV; e += kDfWg) {
      const int r = e / XV, v = e % XV;
      const Chunk d = ch[kDfChunks + (v >> 1)];
      if (d.ptr && m0 + r < M)
        *reinterpret_cast<uint4*>(reinterpret_cast<char*>(d.ptr) +
                                  ((long long)(m0 + r) * d.ld + (v & 1) * 4) *
                                      4) =
            *reinterpret_cast<const uint4*>(xs + x_swz(r, v));
    }
    wg_sync(wg);   // the x stage read
    issue_x(i + 2);
  }
}

}  // namespace

extern "C" {

// bwd_dx's float32 form: the feature table tbl (G groups, the dx columns
// filled), M rows, Ctot concat columns, g's planes gp (tb_split_g_kernel's
// layout: 3 x ceil(M / 64) x nh x 64 x 128 bf16, nh = ceil(N / 128)
// halves) for N outputs, stat (3, Ctot) [mean; inv_sigma; scale], bias
// (Ctot,), red (2, Ctot), w (Ctot, N) float32; ``smem`` the plan's
// (train_bottleneck.dx_f32_plan), checked against the kernel's layout.
// Past kWideN outputs W is split first into its slice images at ws
// (halo.cuh split_w_slices, core matrices; the caller's, ceil(Ctot / 64)
// * nh * 3 * 64 * 128 bf16).
int cunet_tb_bwd_dx_f32(const void* tbl, int G, long long M, int Ctot,
                        const void* gp, int N, const void* stat,
                        const void* bias, const void* red, const void* w,
                        void* ws, int smem, void* stream) {
  const int np = (N + 15) / 16 * 16;
  const DfLayout l = df_layout(np);
  const bool stream_w = np > kWideN;
  if (N % 8 || N < 8 || l.bytes != smem || M < 1 || M > 0x7fffffff ||
      Ctot % 8 || Ctot < 8 || (stream_w && !ws))
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (stream_w) {
    const int e = split_w_slices(static_cast<const float*>(w), N, Ctot, N,
                                 true, static_cast<bf16*>(ws), st);
    if (e) return e;
  }
  const int ngrp = (Ctot + kDfCols - 1) / kDfCols;
  const int items = (int)((M + kDfRows - 1) / kDfRows) * ngrp;
  auto kern = stream_w ? tb_bwd_dx_f32_kernel<true>
                       : tb_bwd_dx_f32_kernel<false>;
  int grid = 0;
  const int e = persistent_grid(kern, items, kThreads, smem, ngrp, &grid);
  if (e) return e;
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const long long*>(tbl), G, (int)M, Ctot,
      static_cast<const bf16*>(gp), N, static_cast<const float*>(stat),
      static_cast<const float*>(bias), static_cast<const float*>(red),
      static_cast<const float*>(w), static_cast<const bf16*>(ws), l);
  return (int)cudaGetLastError();
}

}  // extern "C"
