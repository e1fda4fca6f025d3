// Hand-written Hopper kernels of the CU-Net forward over channel-plane
// buffers: the eval forward (cunet_tpu_torch/kernels/model_buf.py) and, with
// per-tile ghost-BN prologues, the slot train forward and its recompute
// (cunet_tpu_torch/kernels/train_slot.py).
//
// Built by nvcc into one shared library with a plain C interface and loaded
// with ctypes (cunet_tpu_torch/kernels/build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC buf_kernels.cu   (one object per source, linked
//   with -shared into one library)
//
// Every matrix operand is a strided 2-D view (row stride ``ld`` in elements,
// unit column stride) so a kernel reads ``buf[:, :k]`` and writes
// ``buf[:, kin:kin+g]`` of a channel-plane buffer in place. The wrapper checks
// that widths, row strides and pointers are multiples of 8 elements / 16
// bytes (the float32 pool and upsample: 4 elements / 16 bytes), which makes
// every global access a 16-byte vector. The float32 forms of affine_dot
// and conv3x3 are in f32_kernels.cu.
//
// Each entry point launches on the stream it is given and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include "halo.cuh"

namespace {

// ---------------------------------------------------------------------------
// K1 affine_dot:
//   out[m, n] = epi( sum_{k<K} bf16(relu(x[m,k]*inv[t,k] + shift[t,k])) W[k,n] )
// with t = m / tile_rows the ghost-BN tile of row m (train) or 0 (eval:
// tile_rows = M, one [inv; shift] pair). With bits > 0 the bf16 prologue
// value goes through the QuanInput quantizer (``quan``; the train head).
// epi is the identity or, with BIAS, relu(. + bias[n]) (the folded BN2),
// in f32 before the one bf16 rounding. x is the prefix of a strided
// channel-plane view or, in the table form (TABLE: #7's apply,
// cunet_tb_apply, one [inv; shift] pair, no epilogue), the virtual concat
// of feature groups read through #7's feature table (halo.cuh): the block
// resolves its K / 8 chunks once into shared memory past the output
// stages, and each 16-byte cp.async reads its chunk from its group's
// tensor at that group's row stride. Everything after the loads is the
// same code, so apply gives affine_dot's bits over the concat.
//
// Design (the plan is the wrapper's, kernels/buf_ops.py::affine_dot_plan):
// - Persistent blocks of 8 warps, each block keeping one group of ncol
//   output columns: its (K, ncol) weight prefix (at most 320 x 128 bf16,
//   80 KB) is loaded into shared memory once, by cp.async, under a
//   16-byte XOR swizzle, and read by ldmatrix.trans without bank
//   conflicts. The block walks row tiles of bm rows (128, 64 or 32); on
//   the main path (K <= 192) tiles of 64 and two x buffers let two blocks
//   share an SM, so one block's loads, prologue and stores run under the
//   other's products.
// - A tile's x rows arrive by cp.async, two or three stages deep: the next
//   tiles load while this one computes. The prologue (halo.cuh's
//   halo_prologue on a tile of no halo) runs once per element, in place in
//   shared memory, with the packed bf16x2 conversion; each thread keeps
//   the inv/shift of its 8 channels in registers (VecCache) and reloads
//   them only where the ghost-BN tile changes.
// - Warp (wm, wn) owns 32 rows and NTW n8 column tiles: mma.sync m16n8k16
//   with A by ldmatrix and B by ldmatrix.trans, one float32 accumulator
//   per output from zero, k ascending in 16-deep steps. A bf16 WMMA
//   16x16x16 compiles to the same HMMA.16816 pair, so every sum is the one
//   table_dot (eval_kernels.cu, WMMA) takes: the per-slot and whole-model
//   paths stay bit for bit equal. No split-K, no atomics: two calls give
//   the same bits.
// - The epilogue rounds each warp's 16-row halves into a per-warp
//   shared-memory stage; they leave as 16-byte stores into the strided or
//   image-major view (OutView).
// Bound by bytes: reading x and writing out (6.3 us at r=64, K=192->128,
// batch 8). Measured about 2.5x that on an H100 80GB HBM3 at 700 W, where
// skipping the loads, the prologue, the products or the stores each saves
// a fifth to a third of the time (tools/gemm_sweep.py --ablate; PERF.md
// section 6): no one part bounds it.
// A weight prefix that fits beside no x buffers (an intermedia adapter at
// order >= 6 with c = 128: K = 896 and up) streams instead:
// affine_dot_stream_kernel below.
// ---------------------------------------------------------------------------
struct DotPlan {
  int bm;           // rows per tile: 32 * row warps (128, 64 or 32)
  int ncol;         // columns per group: 8 * NTW * column warps
  int ngrp;         // column groups
  int kp;           // K zero-padded to 16 (streamed: to kc)
  int stages;       // x buffers: 2 or 3 (streamed: weight and x chunks)
  int w_bytes;      // the resident weight (kp rows of ncol / 8 chunks);
                    // streamed: one chunk's (kc rows), at a stage's start
  int stage_bytes;  // bytes per x buffer (bm rows at a stride of kp + 8);
                    // streamed: a chunk's weight, then its x (kc + 8)
  int out_off;      // the warps' output stages
  int kc;           // streamed: K per chunk (0: the weight resident)
};

// The XOR swizzle of a weight row of nt 16-byte chunks: chunk j of row k
// lands at j ^ ((k >> sh) & mk), so ldmatrix's eight consecutive rows of
// one chunk fall in eight bank groups (an odd nt needs none).
__device__ __forceinline__ void dot_swizzle(int nt, int& sh, int& mk) {
  sh = 0;
  mk = 0;
  if (nt % 8 == 0) {
    mk = 7;
  } else if (nt % 4 == 0) {
    sh = 1;
    mk = 3;
  } else if (nt % 2 == 0) {
    sh = 2;
    mk = 1;
  }
}

// Warp (wm, wn)'s products of one staged x tile: ``ksteps`` 16-deep k
// steps of its two m16 row tiles (A by ldmatrix from ``abase``, rows ``xs``
// bytes apart) against its NTW n8 column tiles of the swizzled weight rows
// at ``wbase`` (``nt`` 16-byte chunks a row), added in order into ``acc``.
// Lane l reads A rows wm*32 + (l & 15) (+16) at byte offset (l >> 4) * 16
// (``abase`` holds them) and B weight row (mat & 1) * 8 + (l & 7) of chunk
// wn*NTW + 2*jp + (mat >> 1), as conv3x3 does.
template <int NTW>
__device__ __forceinline__ void dot_products(float (&acc)[2][NTW][4],
                                             uint32_t abase, int xs,
                                             uint32_t wbase, int nt, int sh,
                                             int mk, int wn, int lane,
                                             int ksteps) {
  const int b_mat = lane >> 3;
  const int b_row = (b_mat & 1) * 8 + (lane & 7);
#pragma unroll 2
  for (int kk = 0; kk < ksteps; ++kk) {
    uint32_t a[2][4];
    ldsm_x4(a[0], abase + kk * 32);
    ldsm_x4(a[1], abase + 16 * xs + kk * 32);
    const int kr = kk * 16 + b_row;
    const uint32_t wrow = wbase + kr * nt * 16;
    const int sw = (kr >> sh) & mk;
#pragma unroll
    for (int jp = 0; jp < NTW / 2; ++jp) {
      const int j = wn * NTW + 2 * jp + (b_mat >> 1);
      uint32_t b[4];
      ldsm_x4_t(b, wrow + (j ^ sw) * 16);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma16816(acc[i][2 * jp], a[i], b[0], b[1]);
        mma16816(acc[i][2 * jp + 1], a[i], b[2], b[3]);
      }
    }
    if (NTW & 1) {
      uint32_t b0, b1;
      ldsm_x2_t(b0, b1, wrow + ((wn * NTW + NTW - 1) ^ sw) * 16);
#pragma unroll
      for (int i = 0; i < 2; ++i) mma16816(acc[i][NTW - 1], a[i], b0, b1);
    }
  }
}

// The epilogue of warp (wm, wn) on row tile m0 of column group n0: each
// 16-row half (with BIAS relu(acc + bias) in f32) rounded once into the
// warp's stage ``stg``, then out as 16-byte rows into the strided or
// image-major view.
template <int NTW, bool BIAS>
__device__ __forceinline__ void dot_epilogue(const float (&acc)[2][NTW][4],
                                             const float (&bv)[NTW][2],
                                             bf16* stg, OutView out, int M,
                                             int N, int m0, int n0, int wm,
                                             int wn, int lane) {
  constexpr int SS = NTW * 8 + 8;   // output stage row stride, elements
  const int g = lane >> 2, q2 = 2 * (lane & 3);
  const int rpi = (int)out.rows_per_img;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = BIAS ? fmaxf(acc[i][j][e] + bv[j][e & 1], 0.f) : acc[i][j][e];
      const __nv_bfloat162 lo2 = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi2 = __floats2bfloat162_rn(v[2], v[3]);
      *reinterpret_cast<__nv_bfloat162*>(stg + g * SS + j * 8 + q2) = lo2;
      *reinterpret_cast<__nv_bfloat162*>(stg + (g + 8) * SS + j * 8 + q2) =
          hi2;
    }
    __syncwarp();
    for (int c = lane; c < 16 * NTW; c += 32) {
      const int r = c / NTW, j = c - r * NTW;
      const int m = m0 + wm * 32 + i * 16 + r;
      const int n = n0 + (wn * NTW + j) * 8;
      if (m < M && n < N) {
        const int img = m / rpi;   // 32-bit: M < 2^31
        *reinterpret_cast<uint4*>(out.ptr + img * out.img_stride +
                                  (m - img * rpi) * out.ld + n) =
            *reinterpret_cast<const uint4*>(stg + r * SS + j * 8);
      }
    }
    __syncwarp();
  }
}

template <int NTW, bool BIAS, bool TABLE>
__global__ void __launch_bounds__(kThreads)
    affine_dot_kernel(const bf16* __restrict__ x, long long ldx, int M,
                      int K, const float* __restrict__ inv,
                      const float* __restrict__ shift, long long vstride,
                      int tile_rows, int bits, const bf16* __restrict__ w,
                      int ldw, int N, const float* __restrict__ bias,
                      OutView out, DotPlan p,
                      const long long* __restrict__ tbl, int G) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int SS = NTW * 8 + 8;   // output stage row stride, elements
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm_n = p.bm / 32;
  const int wm = warp % wm_n, wn = warp / wm_n;
  const int nt = p.ncol / 8;
  const int col = blockIdx.x % p.ngrp, n0 = col * p.ncol;
  const int tiles = (M + p.bm - 1) / p.bm;
  const int first = blockIdx.x / p.ngrp, stride = gridDim.x / p.ngrp;
  if (first >= tiles) return;
  const int Q = (tiles - 1 - first) / stride + 1;
  const int xs = (p.kp + kHaloPad) * 2;   // x row stride, bytes
  int sh, mk;
  dot_swizzle(nt, sh, mk);

  for (int i = tid; i < p.kp * nt; i += kThreads) {
    const int r = i / nt, j = i - r * nt;
    const int n = n0 + j * 8;
    const bool ok = r < K && n < N;
    cp_async16(s0 + (r * nt + (j ^ ((r >> sh) & mk))) * 16,
               ok ? w + (long long)r * ldw + n : w, ok ? 16 : 0);
  }
  cp_async_commit();
  // the table form: the K / 8 chunks resolved once, past the output stages
  Chunk* chunks = reinterpret_cast<Chunk*>(smem + p.out_off +
                                           kWarps * 16 * SS * 2);
  if constexpr (TABLE) {
    for (int v = tid; v < p.kp / 8; v += kThreads)
      chunks[v] = table_chunk(tbl, G, K, v * 8, 0);
    __syncthreads();
  }
  const auto issue = [&](int q) {
    if constexpr (TABLE)
      load_chunks(s0 + p.w_bytes + (q % p.stages) * p.stage_bytes, chunks, M,
                  (first + q * stride) * p.bm, p.bm, p.kp, tid, kThreads);
    else
      load_halo(s0 + p.w_bytes + (q % p.stages) * p.stage_bytes, x, ldx, M, K,
                (first + q * stride) * p.bm, p.bm, 0, p.kp, tid, kThreads);
    cp_async_commit();
  };
  for (int q = 0; q < Q && q < p.stages - 1; ++q) issue(q);

  // this lane's bias values and A row offset (dot_products)
  float bv[NTW][2];
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int n = n0 + (wn * NTW + j) * 8 + 2 * (lane & 3);
    bv[j][0] = BIAS && n < N ? bias[n] : 0.f;
    bv[j][1] = BIAS && n < N ? bias[n + 1] : 0.f;
  }
  const int a_off = (wm * 32 + (lane & 15)) * xs + (lane >> 4) * 16;
  bf16* stg = reinterpret_cast<bf16*>(smem + p.out_off) + warp * 16 * SS;
  VecCache vc;
  vc.lo = vc.hi = 0;

  for (int q = 0; q < Q; ++q) {
    const int issued = Q < q + p.stages - 1 ? Q : q + p.stages - 1;
    cp_async_wait_upto(issued - q - 1);
    __syncthreads();   // tile q (and the weight) landed; tile q-1 is done
    if (q + p.stages - 1 < Q) issue(q + p.stages - 1);
    const int m0 = (first + q * stride) * p.bm;
    const int sb = p.w_bytes + (q % p.stages) * p.stage_bytes;
    halo_prologue(reinterpret_cast<bf16*>(smem + sb), M, K, m0, p.bm, 0,
                  p.kp, inv, shift, vstride, tile_rows, bits, tid, kThreads,
                  vc);
    __syncthreads();

    float acc[2][NTW][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    dot_products(acc, s0 + sb + a_off, xs, s0, nt, sh, mk, wn, lane,
                 p.kp / 16);
    dot_epilogue<NTW, BIAS>(acc, bv, stg, out, M, N, m0, n0, wm, wn, lane);
  }
}

// ---------------------------------------------------------------------------
// affine_dot's streamed form: the same function, products and epilogue,
// with the weight read by K chunk instead of kept whole. Chosen by the plan
// only where no resident layout fits (K = 896 ... 1920 -> 128: the
// intermedia adapter at order 6 ... 14 with c = 128); every shape that
// plans resident keeps affine_dot_kernel, its instance and its bits.
// - A step of the pipeline is (row tile, K chunk of kc): one stage holds
//   the chunk's (kc, ncol) weight slice (the resident form's swizzle, kc a
//   multiple of 16) and the tile's x columns [c0, c0 + kc) at a row stride
//   of kc + 8; two or three stages in flight by cp.async, the weight
//   re-read from L2 for every row tile.
// - The prologue runs once per element of each chunk, as in the resident
//   form (its channel changes with the chunk, so no vectors are kept
//   across steps).
// - One float32 accumulator per output, from zero at the first chunk, in
//   ascending 16-deep k steps across the chunks, the last chunk stopping
//   at K padded to 16: the sums of the resident form and of
//   eval_ops.table_dot, bit for bit, so the whole-model and per-slot paths
//   stay equal at any K. The epilogue runs after the last chunk.
// Bound by bytes as the resident form (x read once, out written once; the
// weight's re-reads hit L2). A plain streamed pipeline: its time is in
// PERF.md section 6.
// ---------------------------------------------------------------------------
template <int NTW, bool BIAS, bool TABLE>
__global__ void __launch_bounds__(kThreads)
    affine_dot_stream_kernel(const bf16* __restrict__ x, long long ldx, int M,
                             int K, const float* __restrict__ inv,
                             const float* __restrict__ shift,
                             long long vstride, int tile_rows, int bits,
                             const bf16* __restrict__ w, int ldw, int N,
                             const float* __restrict__ bias, OutView out,
                             DotPlan p, const long long* __restrict__ tbl,
                             int G) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int SS = NTW * 8 + 8;   // output stage row stride, elements
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm_n = p.bm / 32;
  const int wm = warp % wm_n, wn = warp / wm_n;
  const int nt = p.ncol / 8;
  const int col = blockIdx.x % p.ngrp, n0 = col * p.ncol;
  const int tiles = (M + p.bm - 1) / p.bm;
  const int first = blockIdx.x / p.ngrp, stride = gridDim.x / p.ngrp;
  if (first >= tiles) return;
  const int Q = (tiles - 1 - first) / stride + 1;
  const int nch = p.kp / p.kc, steps = Q * nch;
  const int k16 = (K + 15) / 16 * 16;
  const int xs = (p.kc + kHaloPad) * 2;   // x row stride, bytes
  int sh, mk;
  dot_swizzle(nt, sh, mk);

  // the table form: the kp / 8 chunks resolved once, past the output stages
  Chunk* chunks = reinterpret_cast<Chunk*>(smem + p.out_off +
                                           kWarps * 16 * SS * 2);
  if constexpr (TABLE) {
    for (int v = tid; v < p.kp / 8; v += kThreads)
      chunks[v] = table_chunk(tbl, G, K, v * 8, 0);
    __syncthreads();
  }
  const auto issue = [&](int s) {
    const int q = s / nch, c0 = (s - q * nch) * p.kc;
    const int m0 = (first + q * stride) * p.bm;
    const uint32_t st = s0 + (s % p.stages) * p.stage_bytes;
    for (int i = tid; i < p.kc * nt; i += kThreads) {
      const int r = i / nt, j = i - r * nt;
      const int n = n0 + j * 8;
      const bool ok = c0 + r < K && n < N;
      cp_async16(st + (r * nt + (j ^ ((r >> sh) & mk))) * 16,
                 ok ? w + (long long)(c0 + r) * ldw + n : w, ok ? 16 : 0);
    }
    if constexpr (TABLE)
      load_chunks(st + p.w_bytes, chunks + c0 / 8, M, m0, p.bm, p.kc, tid,
                  kThreads);
    else
      load_halo(st + p.w_bytes, x, ldx, M, K, m0, p.bm, c0, p.kc, tid,
                kThreads);
    cp_async_commit();
  };
  for (int s = 0; s < steps && s < p.stages - 1; ++s) issue(s);

  // this lane's bias values and A row offset: affine_dot_kernel's
  float bv[NTW][2];
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int n = n0 + (wn * NTW + j) * 8 + 2 * (lane & 3);
    bv[j][0] = BIAS && n < N ? bias[n] : 0.f;
    bv[j][1] = BIAS && n < N ? bias[n + 1] : 0.f;
  }
  const int a_off = (wm * 32 + (lane & 15)) * xs + (lane >> 4) * 16;
  bf16* stg = reinterpret_cast<bf16*>(smem + p.out_off) + warp * 16 * SS;
  float acc[2][NTW][4];

  for (int s = 0; s < steps; ++s) {
    const int issued = steps < s + p.stages - 1 ? steps : s + p.stages - 1;
    cp_async_wait_upto(issued - s - 1);
    __syncthreads();   // step s landed; step s-1 is done
    if (s + p.stages - 1 < steps) issue(s + p.stages - 1);
    const int q = s / nch, c = s - q * nch, c0 = c * p.kc;
    const int m0 = (first + q * stride) * p.bm;
    const int sb = (s % p.stages) * p.stage_bytes;
    halo_prologue(reinterpret_cast<bf16*>(smem + sb + p.w_bytes), M, K, m0,
                  p.bm, c0, p.kc, inv, shift, vstride, tile_rows, bits, tid,
                  kThreads);
    __syncthreads();

    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
    // the last chunk stops at K rounded up to 16, as the resident form
    dot_products(acc, s0 + sb + p.w_bytes + a_off, xs, s0 + sb, nt, sh, mk,
                 wn, lane, (k16 - c0 < p.kc ? k16 - c0 : p.kc) / 16);
    if (c == nch - 1)
      dot_epilogue<NTW, BIAS>(acc, bv, stg, out, M, N, m0, n0, wm, wn, lane);
  }
}

// ---------------------------------------------------------------------------
// K2 conv3x3: SAME 3x3 conv of (B*H*W, C) rows,
//   out[m, n] = sum_{tap, c} pro(y[src(m, tap), c]) * W[tap*C + c, n]
// with the HWIO weight viewed as (9*C, G) and zero where src(m, tap) lies
// outside m's image. With PRO each input element first goes through the
// ghost-BN prologue relu(y*inv[t] + shift[t]) in f32, rounded to bf16 (t
// is the BN tile of the source row; a BN tile holds whole images), and with
// bits > 0 through QuanInput's quantizer; the padding stays zero.
//
// Design (the plan is the wrapper's, kernels/buf_ops.py::conv3x3_plan):
// - Persistent blocks of 12 warps walk tiles of bm output rows (and column
//   groups of NT*8 outputs where G > 64). The weight slice of a (column
//   group, channel chunk) sits in shared memory, loaded once per block when
//   one slice is the whole weight (9 x 128 x 32 bf16, 72 KB, on the main
//   path), under a 16-byte XOR swizzle so that ldmatrix reads it without
//   bank conflicts.
// - A tile's input is one halo tile (halo.cuh): loaded with cp.async while
//   the previous tile computes (two stages where they fit), the prologue
//   applied once per element when it has landed. The 9 taps read shifted
//   windows of it, so an input row comes from L2 once per tile, not 9
//   times, and the prologue runs once per element, not once per tap.
// - The product is mma.sync m16n8k16 fed by ldmatrix. The taps' A operands
//   are windows at row offsets of +-1 and +-W, with out-of-image rows
//   pointed at a zero row: wgmma's shared-memory operand (8-row core
//   matrices at fixed strides) cannot express either.
// - A warp owns 32 rows (two m16 tiles share each weight fragment it
//   reads): bm/32 warps split the rows and 12/(bm/32) the 9*C reduction
//   (small M: at bm = 32 each of the 12 warps takes 9*C/12 of the depth).
//   Their partial sums meet in shared memory and are added in warp order:
//   deterministic, no atomics, one launch. Results leave as 16-byte bf16
//   stores into the strided output view.
// Bound by bytes (3.2 us at r=64 batch 8, Cb=128 -> G=32); measured 17.1
// us there and 117 at batch 64 on an H100 80GB HBM3 at 700 W (PERF.md,
// PR 8), where removing the loads, the weight reads or the epilogue each
// saves 5-20 % and wgmma with A from registers was slower.
// ---------------------------------------------------------------------------
constexpr int kConvWarps = 12;    // warps of a conv3x3 block
constexpr int kConvMT = 2;        // m16 row tiles of a warp
constexpr int kConvThreads = kConvWarps * 32;
constexpr int kConvWarpRows = 16 * kConvMT;

struct ConvPlan {
  int bm;           // output rows per tile: 32, 64 or 128
  int kc;           // input channels per chunk, a multiple of 16
  int nchunk;       // chunks over the channels zero-padded to 16
  int ncol;         // column groups of NT*8 outputs
  int stages;       // halo buffers: 2 (double-buffered) or 1
  int zero_off;     // shared-memory byte offsets: the zero row,
  int stage_off;    //   the first stage,
  int stage_bytes;  //   bytes per stage (halo tile, later partial sums)
};

// The 16-byte column swizzle of a weight slice with NT 16-byte chunks per
// row: eight consecutive rows of one chunk land in eight bank groups.
template <int NT>
__device__ __forceinline__ int wswz(int k) {
  if (NT == 8) return k & 7;
  if (NT == 4) return (k >> 1) & 3;
  if (NT == 2 || NT == 6) return (k >> 2) & 1;
  return 0;  // odd NT: the row stride alone spreads the rows
}

template <int NT, bool PRO>
__global__ void __launch_bounds__(kConvThreads)
    conv3x3_kernel(const bf16* __restrict__ y, long long ldy, int M, int H,
                   int W, int C, const bf16* __restrict__ w, int G,
                   const float* __restrict__ inv,
                   const float* __restrict__ shift, long long vstride,
                   int tile_rows, int bits, OutView out, ConvPlan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int GB = NT * 8;
  constexpr int RS = GB + 4;  // f32 row stride of the partial sums
  const int tiles = (M + p.bm - 1) / p.bm;
  const int items = tiles * p.ncol;
  if ((int)blockIdx.x >= items) return;
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm_n = p.bm / kConvWarpRows, wk_n = kConvWarps / wm_n;
  const int wm = warp % wm_n, wk = warp / wm_n;
  const int kst = p.kc >> 4, steps = 9 * kst;
  const int s_lo = wk * steps / wk_n, s_hi = (wk + 1) * steps / wk_n;
  const int hstride = (p.kc + kHaloPad) * 2;
  const int halo_rows = p.bm + 2 * W + 2;
  const int hw = H * W;
  const int Q = ((items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) *
                p.nchunk;

  for (int i = tid; i < p.kc / 8; i += kConvThreads)
    *reinterpret_cast<uint4*>(smem + p.zero_off + i * 16) =
        make_uint4(0u, 0u, 0u, 0u);

  // stage q of this block: its (tile, column group) item and channel chunk
  struct Stage {
    int tile, col, chunk;
  };
  const auto item = [&](int q) {
    const int it = (int)blockIdx.x + (q / p.nchunk) * (int)gridDim.x;
    return Stage{it % tiles, it / tiles, q % p.nchunk};
  };
  const auto issue_halo = [&](int q) {
    const Stage sq = item(q);
    load_halo(s0 + p.stage_off + (q % p.stages) * p.stage_bytes, y, ldy, M,
              C, sq.tile * p.bm - W - 1, halo_rows, sq.chunk * p.kc, p.kc,
              tid, kConvThreads);
    cp_async_commit();
  };
  const auto issue_weight = [&](int col, int chunk) {
    for (int i = tid; i < 9 * p.kc * NT; i += kConvThreads) {
      const int r = i / NT, j = i - (i / NT) * NT;
      const int tap = r / p.kc, c = chunk * p.kc + (r - tap * p.kc);
      const int n = col * GB + j * 8;
      const bool ok = c < C && n < G;
      cp_async16(s0 + (r * NT + (j ^ wswz<NT>(r))) * 16,
                 ok ? w + ((long long)tap * C + c) * G + n : w, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  // this lane's ldmatrix coordinates: A rows wm*32 + (l & 15) + 16i, at
  // byte offset (l >> 4) * 16; B weight row (mat & 1) * 8 + (l & 7) of
  // chunk mat >> 1
  const int a_row = wm * kConvWarpRows + (lane & 15);
  const int a_ofs = (lane >> 4) * 16;
  const int b_mat = lane >> 3;
  const int b_row = (b_mat & 1) * 8 + (lane & 7);

  float acc[kConvMT][NT][4];
  int wkey = -1;
  if (p.stages == 2) issue_halo(0);
  for (int q = 0; q < Q; ++q) {
    const Stage sq = item(q);
    const int tile = sq.tile, col = sq.col, chunk = sq.chunk;
    if (p.stages == 1) issue_halo(q);
    const int key = col * p.nchunk + chunk;
    if (key != wkey) {
      issue_weight(col, chunk);
      wkey = key;
    }
    if (p.stages == 2 && q + 1 < Q) {
      issue_halo(q + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    unsigned char* hs = smem + p.stage_off + (q % p.stages) * p.stage_bytes;
    const int m0 = tile * p.bm;
    if (PRO) {
      halo_prologue(reinterpret_cast<bf16*>(hs), M, C, m0 - W - 1,
                    halo_rows, chunk * p.kc, p.kc, inv, shift, vstride,
                    tile_rows, bits, tid, kConvThreads);
      __syncthreads();
    }
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < kConvMT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }

    // the lane's two A rows (a_row and a_row + 16): image position
    int yy[kConvMT], xx[kConvMT];
    bool in_range[kConvMT];
#pragma unroll
    for (int i = 0; i < kConvMT; ++i) {
      const int m = m0 + a_row + 16 * i;
      in_range[i] = m < M;
      const int pix = in_range[i] ? m % hw : 0;
      yy[i] = pix / W;
      xx[i] = pix - yy[i] * W;
    }
    const uint32_t hbase = smem_u32(hs), zbase = s0 + p.zero_off;
    for (int tap = s_lo / kst; tap * kst < s_hi; ++tap) {
      const int k_lo = s_lo > tap * kst ? s_lo - tap * kst : 0;
      const int k_hi = s_hi < (tap + 1) * kst ? s_hi - tap * kst : kst;
      uint32_t abase[kConvMT];
#pragma unroll
      for (int i = 0; i < kConvMT; ++i) {
        const int hr = tap_row(a_row + 16 * i, yy[i], xx[i], in_range[i],
                               tap / 3 - 1, tap % 3 - 1, H, W);
        abase[i] =
            (hr < 0 ? zbase : hbase + (uint32_t)(hr * hstride)) + a_ofs;
      }
      const int rb = tap * p.kc + b_row;
#pragma unroll 2
      for (int kk = k_lo; kk < k_hi; ++kk) {
        uint32_t a[kConvMT][4];
#pragma unroll
        for (int i = 0; i < kConvMT; ++i) ldsm_x4(a[i], abase[i] + kk * 32);
        const int kr = rb + kk * 16;
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          const int j = 2 * jp + (b_mat >> 1);
          uint32_t b[4];
          ldsm_x4_t(b, s0 + (kr * NT + (j ^ wswz<NT>(kr))) * 16);
#pragma unroll
          for (int i = 0; i < kConvMT; ++i) {
            mma16816(acc[i][2 * jp], a[i], b[0], b[1]);
            mma16816(acc[i][2 * jp + 1], a[i], b[2], b[3]);
          }
        }
        if (NT & 1) {
          uint32_t b0, b1;
          ldsm_x2_t(b0, b1, s0 + (kr * NT + ((NT - 1) ^ wswz<NT>(kr))) * 16);
#pragma unroll
          for (int i = 0; i < kConvMT; ++i) mma16816(acc[i][NT - 1], a[i], b0, b1);
        }
      }
    }

    if (chunk == p.nchunk - 1) {
      // partial sums into this (now read) stage, added in warp order
      __syncthreads();
      float* red = reinterpret_cast<float*>(hs);
      float* rw = red + (wk * p.bm + wm * kConvWarpRows + (lane >> 2)) * RS +
                  2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < kConvMT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          *reinterpret_cast<float2*>(rw + 16 * i * RS + 8 * j) =
              make_float2(acc[i][j][0], acc[i][j][1]);
          *reinterpret_cast<float2*>(rw + (16 * i + 8) * RS + 8 * j) =
              make_float2(acc[i][j][2], acc[i][j][3]);
        }
      __syncthreads();
      for (int i = tid; i < p.bm * NT; i += kConvThreads) {
        const int r = i / NT, j = i - (i / NT) * NT;
        const int n = col * GB + j * 8;
        if (m0 + r >= M || n >= G) continue;
        float v[8];
        const float* src = red + r * RS + j * 8;
        load8(src, v);
        for (int k = 1; k < wk_n; ++k) {
          float u[8];
          load8(src + k * p.bm * RS, u);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += u[e];
        }
        Pack8 o;
#pragma unroll
        for (int e = 0; e < 8; ++e) o.u[e] = hi(v[e]);
        *reinterpret_cast<uint4*>(out_row(out, m0 + r) + n) = o.v;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K3 maxpool2 / K4 upsample2: one thread per 16-byte vector of one pixel's
// channels (8 bf16 or, in the float32 form, 4 floats). The same index maps
// on either element type; both are exact.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b, const bf16*) {
  Pack8 pa, pb, o;
  pa.v = a;
  pb.v = b;
#pragma unroll
  for (int t = 0; t < 8; ++t)
    o.u[t] = hi(fmaxf(lo(pa, t), lo(pb, t)));
  return o.v;
}

__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b, const float*) {
  return make_uint4(
      __float_as_uint(fmaxf(__uint_as_float(a.x), __uint_as_float(b.x))),
      __float_as_uint(fmaxf(__uint_as_float(a.y), __uint_as_float(b.y))),
      __float_as_uint(fmaxf(__uint_as_float(a.z), __uint_as_float(b.z))),
      __float_as_uint(fmaxf(__uint_as_float(a.w), __uint_as_float(b.w))));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    maxpool2_kernel(const T* __restrict__ x, long long ldx,
                    T* __restrict__ o, long long ldo, int B, int H, int W,
                    int C) {
  constexpr int E = 16 / sizeof(T);
  const int cg = C / E, Ho = H / 2, Wo = W / 2;
  const long long total = (long long)B * Ho * Wo * cg;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(idx % cg) * E;
    long long q = idx / cg;
    const int ox = (int)(q % Wo);
    q /= Wo;
    const int oy = (int)(q % Ho);
    const long long b = q / Ho;
    const long long r00 = (b * H + 2 * oy) * W + 2 * ox;
    const uint4 v00 = *reinterpret_cast<const uint4*>(x + r00 * ldx + c);
    const uint4 v01 = *reinterpret_cast<const uint4*>(x + (r00 + 1) * ldx + c);
    const uint4 v10 = *reinterpret_cast<const uint4*>(x + (r00 + W) * ldx + c);
    const uint4 v11 =
        *reinterpret_cast<const uint4*>(x + (r00 + W + 1) * ldx + c);
    *reinterpret_cast<uint4*>(o + ((b * Ho + oy) * Wo + ox) * ldo + c) =
        vmax(vmax(v00, v01, x), vmax(v10, v11, x), x);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    upsample2_kernel(const T* __restrict__ x, long long ldx,
                     T* __restrict__ o, long long ldo, int B, int H, int W,
                     int C) {
  constexpr int E = 16 / sizeof(T);
  const int cg = C / E, Wo = 2 * W;
  const long long total = (long long)B * H * W * cg;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(idx % cg) * E;
    long long q = idx / cg;
    const int ix = (int)(q % W);
    q /= W;
    const int iy = (int)(q % H);
    const long long b = q / H;
    const uint4 v = *reinterpret_cast<const uint4*>(
        x + ((b * H + iy) * W + ix) * ldx + c);
    const long long r0 = (b * 2 * H + 2 * iy) * Wo + 2 * ix;
    *reinterpret_cast<uint4*>(o + r0 * ldo + c) = v;
    *reinterpret_cast<uint4*>(o + (r0 + 1) * ldo + c) = v;
    *reinterpret_cast<uint4*>(o + (r0 + Wo) * ldo + c) = v;
    *reinterpret_cast<uint4*>(o + (r0 + Wo + 1) * ldo + c) = v;
  }
}

unsigned elementwise_blocks(long long total) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  return (unsigned)(blocks < (1LL << 20) ? (blocks > 0 ? blocks : 1)
                                         : (1LL << 20));
}

template <typename T>
int launch_maxpool2(const void* x, long long ldx, void* out, long long ldo,
                    int B, int H, int W, int C, void* stream) {
  const long long total =
      (long long)B * (H / 2) * (W / 2) * (C / (16 / (int)sizeof(T)));
  maxpool2_kernel<T><<<elementwise_blocks(total), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), ldx, static_cast<T*>(out), ldo, B, H, W, C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_upsample2(const void* x, long long ldx, void* out, long long ldo,
                     int B, int H, int W, int C, void* stream) {
  const long long total =
      (long long)B * H * W * (C / (16 / (int)sizeof(T)));
  upsample2_kernel<T><<<elementwise_blocks(total), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), ldx, static_cast<T*>(out), ldo, B, H, W, C);
  return (int)cudaGetLastError();
}

struct VecArgs {
  const float* inv;
  const float* shift;
  long long vstride;
  long long tile_rows;
  int bits;
};

template <int NTW>
int launch_affine_dot(const bf16* x, long long ldx, int M, int K, VecArgs v,
                      const bf16* w, int ldw, int N, const float* bias,
                      OutView out, const DotPlan& p, int smem,
                      cudaStream_t st) {
  const int items = (M + p.bm - 1) / p.bm * p.ngrp;
  auto kern = p.kc ? (bias ? affine_dot_stream_kernel<NTW, true, false>
                           : affine_dot_stream_kernel<NTW, false, false>)
                   : (bias ? affine_dot_kernel<NTW, true, false>
                           : affine_dot_kernel<NTW, false, false>);
  int grid = 0;
  const int e = persistent_grid(kern, items, kThreads, smem, p.ngrp, &grid);
  if (e) return e;
  kern<<<grid, kThreads, smem, st>>>(x, ldx, M, K, v.inv, v.shift,
                                     v.vstride, (int)v.tile_rows, v.bits, w,
                                     ldw, N, bias, out, p, nullptr, 0);
  return (int)cudaGetLastError();
}

// The table form (#7's apply): one [inv; shift] pair for all M rows, no
// epilogue, x read through the feature table; ``smem`` includes the
// resolved chunks.
template <int NTW>
int launch_affine_dot_table(const long long* tbl, int G, int M, int K,
                            const float* inv, const float* shift,
                            const bf16* w, int N, OutView out,
                            const DotPlan& p, int smem, cudaStream_t st) {
  const int items = (M + p.bm - 1) / p.bm * p.ngrp;
  auto kern = p.kc ? affine_dot_stream_kernel<NTW, false, true>
                   : affine_dot_kernel<NTW, false, true>;
  int grid = 0;
  const int e = persistent_grid(kern, items, kThreads, smem, p.ngrp, &grid);
  if (e) return e;
  kern<<<grid, kThreads, smem, st>>>(nullptr, 0, M, K, inv, shift, 0, M, 0,
                                     w, N, N, nullptr, out, p, tbl, G);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_conv3x3(const bf16* y, long long ldy, int M, int H, int W, int C,
                   const bf16* w, int G, VecArgs v, OutView out,
                   const ConvPlan& p, int smem, cudaStream_t st) {
  const int items = (M + p.bm - 1) / p.bm * p.ncol;
  auto kern = v.inv ? conv3x3_kernel<NT, true> : conv3x3_kernel<NT, false>;
  return launch_persistent(kern, items, kConvThreads, smem, st, y, ldy, M, H, W,
                           C, w, G, v.inv, v.shift, v.vstride,
                           (int)v.tile_rows, v.bits, out, p);
}

}  // namespace

extern "C" {

int cunet_affine_dot(const void* x, long long ldx, long long M, int K,
                     const void* inv, const void* shift, long long vstride,
                     long long tile_rows, int bits, const void* w, int ldw,
                     int N, const void* bias, void* out, long long ldo,
                     long long rows_per_img, long long img_stride, int bm,
                     int ncol, int ngrp, int ntw, int kp, int stages,
                     int w_bytes, int stage_bytes, int out_off, int kc,
                     int smem, void* stream) {
  const OutView ov{static_cast<bf16*>(out), ldo, rows_per_img, img_stride};
  const VecArgs v{static_cast<const float*>(inv),
                  static_cast<const float*>(shift), vstride, tile_rows, bits};
  const DotPlan p{bm,      ncol,        ngrp,    kp, stages,
                  w_bytes, stage_bytes, out_off, kc};
  const auto* xp = static_cast<const bf16*>(x);
  const auto* wp = static_cast<const bf16*>(w);
  const auto* bp = static_cast<const float*>(bias);
  const auto st = static_cast<cudaStream_t>(stream);
  const int m = (int)M;
  switch (ntw) {
#define CUNET_DOT_NTW(n)                                                    \
  case n:                                                                   \
    return launch_affine_dot<n>(xp, ldx, m, K, v, wp, ldw, N, bp, ov, p,    \
                                smem, st);
    CUNET_DOT_NTW(1) CUNET_DOT_NTW(2) CUNET_DOT_NTW(3) CUNET_DOT_NTW(4)
    CUNET_DOT_NTW(5) CUNET_DOT_NTW(6) CUNET_DOT_NTW(7) CUNET_DOT_NTW(8)
#undef CUNET_DOT_NTW
  }
  return (int)cudaErrorInvalidValue;
}

int cunet_tb_apply(const void* tbl, int G, long long M, int K,
                   const void* inv, const void* shift, const void* w, int N,
                   void* out, long long ldo, int bm, int ncol, int ngrp,
                   int ntw, int kp, int stages, int w_bytes, int stage_bytes,
                   int out_off, int kc, int smem, void* stream) {
  const OutView ov{static_cast<bf16*>(out), ldo, M, 0};
  const DotPlan p{bm,      ncol,        ngrp,    kp, stages,
                  w_bytes, stage_bytes, out_off, kc};
  const auto* tp = static_cast<const long long*>(tbl);
  const auto* ip = static_cast<const float*>(inv);
  const auto* sp = static_cast<const float*>(shift);
  const auto* wp = static_cast<const bf16*>(w);
  const auto st = static_cast<cudaStream_t>(stream);
  const int m = (int)M;
  switch (ntw) {
#define CUNET_TDOT_NTW(n)                                                   \
  case n:                                                                   \
    return launch_affine_dot_table<n>(tp, G, m, K, ip, sp, wp, N, ov, p,    \
                                      smem, st);
    CUNET_TDOT_NTW(1) CUNET_TDOT_NTW(2) CUNET_TDOT_NTW(3) CUNET_TDOT_NTW(4)
    CUNET_TDOT_NTW(5) CUNET_TDOT_NTW(6) CUNET_TDOT_NTW(7) CUNET_TDOT_NTW(8)
#undef CUNET_TDOT_NTW
  }
  return (int)cudaErrorInvalidValue;
}

int cunet_conv3x3(const void* y, long long ldy, long long M, int H, int W,
                  int C, const void* w, int G, const void* inv,
                  const void* shift, long long vstride, long long tile_rows,
                  int bits, void* out, long long ldo, int bm, int kc,
                  int nchunk, int nt, int ncol, int stages, int zero_off,
                  int stage_off, int stage_bytes, int smem, void* stream) {
  const OutView ov{static_cast<bf16*>(out), ldo, M, 0};
  const VecArgs v{static_cast<const float*>(inv),
                  static_cast<const float*>(shift), vstride, tile_rows, bits};
  const ConvPlan p{bm, kc, nchunk, ncol, stages, zero_off, stage_off,
                   stage_bytes};
  const auto* yp = static_cast<const bf16*>(y);
  const auto* wp = static_cast<const bf16*>(w);
  const auto st = static_cast<cudaStream_t>(stream);
  const int m = (int)M;
  switch (nt) {
#define CUNET_CONV_NT(n) \
  case n:                \
    return launch_conv3x3<n>(yp, ldy, m, H, W, C, wp, G, v, ov, p, smem, st);
    CUNET_CONV_NT(1) CUNET_CONV_NT(2) CUNET_CONV_NT(3) CUNET_CONV_NT(4)
    CUNET_CONV_NT(5) CUNET_CONV_NT(6) CUNET_CONV_NT(7) CUNET_CONV_NT(8)
#undef CUNET_CONV_NT
  }
  return (int)cudaErrorInvalidValue;
}

int cunet_maxpool2(const void* x, long long ldx, void* out, long long ldo,
                   int B, int H, int W, int C, void* stream) {
  return launch_maxpool2<bf16>(x, ldx, out, ldo, B, H, W, C, stream);
}

int cunet_upsample2(const void* x, long long ldx, void* out, long long ldo,
                    int B, int H, int W, int C, void* stream) {
  return launch_upsample2<bf16>(x, ldx, out, ldo, B, H, W, C, stream);
}

// The float32 forms: C a multiple of 4, rows on 16-byte bounds.
int cunet_maxpool2_f32(const void* x, long long ldx, void* out,
                       long long ldo, int B, int H, int W, int C,
                       void* stream) {
  return launch_maxpool2<float>(x, ldx, out, ldo, B, H, W, C, stream);
}

int cunet_upsample2_f32(const void* x, long long ldx, void* out,
                        long long ldo, int B, int H, int W, int C,
                        void* stream) {
  return launch_upsample2<float>(x, ldx, out, ldo, B, H, W, C, stream);
}

}  // extern "C"
