// Hand-written Hopper kernels of the quantized whole-model forward
// (cunet_tpu_torch/kernels/model_buf.py, the int8 branch): affine_dot_i8,
// the BN-fold + ReLU + int8 quantizer + int8 1x1 conv of every bottleneck,
// adapter and head, and conv3x3_i8, the int8 3x3 conv of the bottleneck's
// codes. Counterparts of cunet_tpu/kernels/fused_model_buf.py's
// _affine_dot_i8 (with _q8) and its int8 scatter conv (:316-329).
//
// Built by nvcc with the other sources of this directory into one shared
// library with a plain C interface, loaded with ctypes
// (cunet_tpu_torch/kernels/build.py). The plans (tiles, stages, shared
// memory offsets) are the wrapper's: kernels/quant_ops.py::i8_dot_plan and
// i8_conv_plan.
//
// Both kernels take their weight as the K-major image the int8 tensor-core
// operand needs (row n holds W[:, n], K zero-padded to 32 bytes:
// quant_ops.pack_w_i8 / pack_w3_i8, packed once when the slots are
// marshalled), multiply on mma.sync m16n8k32 s8 x s8 -> s32 fed by
// ldmatrix (both operands K-major 16-byte rows, as ldmatrix's 8x8 b16
// tiles give them; wgmma's shared-memory A operand cannot express the
// conv's shifted tap rows either), and dequantize in registers. Integer
// products accumulate exactly in any order, the quantizer scale s is a
// power of two, and every float rounding point is the plain PyTorch
// version's (the BN affine rounds after the product and after the sum;
// q8's |y| * s + 0.5 is one rounding of an exact product, so one FMA), so
// each kernel gives its plain version's bits.
//
// Each entry point launches on the stream it is given and returns
// cudaGetLastError() (or the error of its occupancy query) so the wrapper
// can raise on a refused launch.

#include "halo.cuh"

namespace {

typedef signed char i8;

// d += a (16x32, row-major) * b (32x8, column-major), s8 in, s32 sums.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The WAGE quantizer's int8 code of a ReLU'd value y >= 0: min(y, 1 - 1/s)
// * s + 0.5, floored. y * s is exact (s a power of two), so the FMA rounds
// once where the plain version's add does.
__device__ __forceinline__ uint32_t q8_relu(float y, float s, float lim) {
  return (uint32_t)__float2int_rd(__fmaf_rn(fminf(fmaxf(y, 0.f), lim), s,
                                            0.5f));
}

// Output rows of any element size, addressed in bytes: row m lands at
// ptr + (m / rows_per_img) * img_stride + (m % rows_per_img) * ld (the
// head's image-major slot of the stacked output; a plain view has
// rows_per_img = M).
struct ByteView {
  unsigned char* ptr;
  long long ld;
  int rows_per_img;
  long long img_stride;
};

__device__ __forceinline__ unsigned char* byte_row(const ByteView& o, int m) {
  const int img = m / o.rows_per_img;
  return o.ptr + img * o.img_stride + (long long)(m - img * o.rows_per_img) *
                                          o.ld;
}

// One 16-byte piece of a staged output row to global memory: one vector
// store where the piece is whole and the address 16-byte aligned (every
// call of the main path), else byte by byte (a ragged column tail, int8
// rows of a width that is not a multiple of 16).
__device__ __forceinline__ void store_piece(unsigned char* dst,
                                            const unsigned char* src,
                                            int bytes) {
  if (bytes == 16 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
    for (int b = 0; b < bytes; ++b) dst[b] = src[b];
  }
}

// A warp's 16 staged rows of ``row_bytes`` each (stage rows ``srow`` bytes
// apart) out to rows m .. m + 15 at byte column ``col`` of ``out``; rows at
// or past M and bytes at or past ``limit`` (N's byte width) stay unwritten.
__device__ __forceinline__ void store_rows(const unsigned char* stg, int srow,
                                           int row_bytes, const ByteView& out,
                                           int m, int M, int col, int limit,
                                           int lane) {
  const int cpr = (row_bytes + 15) / 16;
  for (int c = lane; c < 16 * cpr; c += 32) {
    const int r = c / cpr, ch = c - r * cpr;
    const int b0 = col + ch * 16;
    int bytes = row_bytes - ch * 16;
    bytes = bytes < 16 ? bytes : 16;
    bytes = limit - b0 < bytes ? limit - b0 : bytes;
    if (m + r >= M || bytes <= 0) continue;
    store_piece(byte_row(out, m + r) + b0, stg + r * srow + ch * 16, bytes);
  }
}

// ---------------------------------------------------------------------------
// affine_dot_i8:
//   out[m, n] = epi( sum_{k<K} q8(relu(x[m,k]*inv[k] + shift[k])) W[k,n] / s )
// x a bf16 or float32 (TX) buffer view (K % 8 == 0, 16-byte rows), W int8
// as its K-major image wt (N rows of ldw >= K bytes). epi (Q8): BN2 +
// ReLU + q8 into int8 rows (the 3x3 conv's codes); else the dequantized
// value into TX rows (rounded once to bf16, or float32 unrounded).
//
// Bound on the H100 by bytes: reading x and writing out (3.8 us at K=128
// -> 128 +BN2,q8, r=64, batch 8), not by the int8 tensor cores (0.5 us).
// Design:
// - Persistent blocks of 8 warps, each keeping one group of ncol output
//   columns (bm/32 row warps x ncol/(8*NTW) column warps, a warp 32 rows
//   and NTW n8 tiles). Its weight rows (ncol x K bytes of the K-major
//   image, a row padded by 16 bytes so ldmatrix's eight rows fall in
//   eight bank groups) are copied once by 16-byte cp.async, with the
//   [inv; shift] of K and BN2's [inv2; shift2] of the group's columns.
// - The block walks row tiles of bm rows in steps of kc columns (on the
//   main path K whole in one step). A step's x rows arrive by 16-byte
//   cp.async into
//   a ring of ``stages`` buffers, issued stages - 1 steps ahead: while a
//   step is quantized and multiplied, the next steps' bytes are in
//   flight. Each landed step is quantized once an element (the BN affine,
//   ReLU and q8 in float32 registers, 8 codes a thread a row, from the
//   vectors in shared memory) into the step's int8 A operand, at a row
//   stride of kc + 16 bytes; columns at or past K are zero codes.
// - mma.sync m16n8k32 s8: A by ldmatrix.x4 from the codes, B by
//   ldmatrix.x4 (two n8 tiles) from the weight rows, int32 accumulators
//   from zero at a tile's first step.
// - The epilogue runs from the accumulators: times 1/s, then BN2, ReLU and
//   q8 with the group's vectors from shared memory (Q8), or the one
//   rounding to bf16; the warp packs its 16-row halves into a per-warp
//   stage of output elements and writes them as whole 16-byte rows into
//   the strided or image-major view.
// - A weight that fits beside no ring (K past ~1,500 at N = 128) is
//   streamed instead (``resident`` 0): each step's stage holds its K
//   chunk's weight rows before its x rows, re-read from L2 for each tile.
// The plan runs two blocks an SM where their shared memory allows (every
// bf16 call of CU-Net-8's order-1 forward: 32-row tiles at K >= 288), so
// one block's quantizer and epilogue run under the other's copies and
// products. Measured: 13.9 us at K=128 +BN2,q8, r=64, batch 8 (its
// first WMMA kernel 52.5) on an H100 80GB HBM3 at 700 W (PERF.md
// section 6).
// ---------------------------------------------------------------------------
struct I8DotPlan {
  int bm;            // rows per tile: 32 * row warps
  int ncol;          // columns per group: 8 * NTW * column warps
  int ngrp;          // column groups
  int kp;            // K zero-padded to 32
  int kc;            // K columns per step (a multiple of 32, <= 2048)
  int nch;           // steps per tile: ceil(kp / kc)
  int stages;        // ring buffers (>= 2)
  int resident;      // 1: the group's weight rows resident; 0: streamed
  int w_off;         // resident weight: ncol rows of kp + 16 bytes
  int vec_off;       // inv[kp], shift[kp], then inv2[ncol], shift2[ncol]
  int ring_off;      // the ring: stages x stage_bytes
  int stage_bytes;   // [weight chunk (streamed)][x rows: bm x kc * sizeof]
  int wchunk_bytes;  // streamed: ncol rows of kc + 16 bytes; else 0
  int codes_off;     // a step's codes: bm rows of kc + 16 bytes
  int out_off;       // the warps' output stages
};

template <int NTW, bool Q8, typename TX>
__global__ void __launch_bounds__(kThreads, 2)
    i8_dot_kernel(const TX* __restrict__ x, long long ldx, int M, int K,
                  const float* __restrict__ inv,
                  const float* __restrict__ shift, const i8* __restrict__ wt,
                  long long ldw, int N, float s,
                  const float* __restrict__ inv2,
                  const float* __restrict__ shift2, ByteView out,
                  I8DotPlan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int OSZ = Q8 ? 1 : (int)sizeof(TX);   // output element bytes
  constexpr int SROW = NTW * 8 * OSZ + 16;         // output stage row
  constexpr int EPV = 16 / (int)sizeof(TX);        // x elements a copy
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm_n = p.bm / 32;
  const int wm = warp % wm_n, wn = warp / wm_n;
  const int col = blockIdx.x % p.ngrp, n0 = col * p.ncol;
  const int tiles = (M + p.bm - 1) / p.bm;
  const int first = blockIdx.x / p.ngrp, stride = gridDim.x / p.ngrp;
  if (first >= tiles) return;
  const int Q = (tiles - 1 - first) / stride + 1;
  const int steps = Q * p.nch;
  const float inv_s = __frcp_rn(s), lim = 1.f - inv_s;
  const int ws = (p.resident ? p.kp : p.kc) + 16;   // weight row, bytes
  const int cs = p.kc + 16;                         // codes row, bytes

  // weight rows [n0, n0 + ncol), bytes [k0, k0 + kw) of each, to dst
  const auto issue_w = [&](uint32_t dst, int k0, int kw) {
    const int vpr = kw / 16;
    for (int i = tid; i < p.ncol * vpr; i += kThreads) {
      const int r = i / vpr, v = i - r * vpr;
      const bool ok = n0 + r < N;
      cp_async16(dst + r * ws + v * 16,
                 ok ? wt + (long long)(n0 + r) * ldw + k0 + v * 16 : wt,
                 ok ? 16 : 0);
    }
  };
  // step st: tile st / nch, K chunk st % nch, into ring buffer st % stages
  const auto issue = [&](int st) {
    const int q = st / p.nch, c = st - q * p.nch;
    const int m0 = (first + q * stride) * p.bm, k0 = c * p.kc;
    const uint32_t base = s0 + p.ring_off + (st % p.stages) * p.stage_bytes;
    if (!p.resident)
      issue_w(base, k0, p.kp - k0 < p.kc ? p.kp - k0 : p.kc);
    const uint32_t xb = base + p.wchunk_bytes;
    const int vpr = p.kc / EPV;
    const int kv = K - k0;                 // x columns of this chunk
    const int rows = M - m0 < p.bm ? M - m0 : p.bm;
    for (int i = tid; i < rows * vpr; i += kThreads) {
      const int r = i / vpr, v = i - r * vpr;
      if (v * EPV < kv)
        cp_async16(xb + (r * p.kc + v * EPV) * (int)sizeof(TX),
                   x + (long long)(m0 + r) * ldx + k0 + v * EPV, 16);
    }
    cp_async_commit();
  };

  if (p.resident) issue_w(s0 + p.w_off, 0, p.kp);   // committed with step 0
  float* vs = reinterpret_cast<float*>(smem + p.vec_off);
  for (int i = tid; i < p.kp; i += kThreads) {
    vs[i] = i < K ? inv[i] : 0.f;
    vs[p.kp + i] = i < K ? shift[i] : 0.f;
  }
  if (Q8)
    for (int i = tid; i < p.ncol; i += kThreads) {
      const bool ok = n0 + i < N;
      vs[2 * p.kp + i] = ok ? inv2[n0 + i] : 0.f;
      vs[2 * p.kp + p.ncol + i] = ok ? shift2[n0 + i] : 0.f;
    }
  for (int st = 0; st < steps && st < p.stages - 1; ++st) issue(st);

  // the quantizer's map: vector pv (8 columns) of rows pr0, pr0 + prs, ...
  // (threads past prs whole rows of vectors idle)
  const int vpc = p.kc / 8, prs = kThreads / vpc;
  const int pv = tid % vpc, pr0 = tid / vpc < prs ? tid / vpc : p.bm;
  // ldmatrix lanes: A rows wm*32 + (l & 15) at byte (l >> 4) * 16; B rows
  // ((l >> 4) * 8 + (l & 7)) of an n8 tile pair at byte ((l >> 3) & 1) * 16
  const uint32_t a_off =
      p.codes_off + (wm * 32 + (lane & 15)) * cs + (lane >> 4) * 16;
  const int b_row = ((lane >> 4) << 3) + (lane & 7);
  const int b_col = ((lane >> 3) & 1) * 16;
  unsigned char* stg = smem + p.out_off + warp * 16 * SROW;
  float qa[8], qb[8];
  int acc[2][NTW][4];

  for (int st = 0; st < steps; ++st) {
    const int issued = steps < st + p.stages - 1 ? steps : st + p.stages - 1;
    cp_async_wait_upto(issued - st - 1);
    __syncthreads();   // step st landed; step st - 1's products are done
    if (st + p.stages - 1 < steps) issue(st + p.stages - 1);
    const int q = st / p.nch, c = st - q * p.nch;
    const int m0 = (first + q * stride) * p.bm, k0 = c * p.kc;
    const unsigned char* stage =
        smem + p.ring_off + (st % p.stages) * p.stage_bytes;

    // ---- quantize the landed x rows into the step's int8 codes ----
    const int kk = k0 + pv * 8;
    if (st < 1 || p.nch > 1) {
      const float4* va = reinterpret_cast<const float4*>(vs + kk);
      const float4* vb = reinterpret_cast<const float4*>(vs + p.kp + kk);
      const float4 a0 = va[0], a1 = va[1], b0 = vb[0], b1 = vb[1];
      qa[0] = a0.x; qa[1] = a0.y; qa[2] = a0.z; qa[3] = a0.w;
      qa[4] = a1.x; qa[5] = a1.y; qa[6] = a1.z; qa[7] = a1.w;
      qb[0] = b0.x; qb[1] = b0.y; qb[2] = b0.z; qb[3] = b0.w;
      qb[4] = b1.x; qb[5] = b1.y; qb[6] = b1.z; qb[7] = b1.w;
    }
    const int rows = M - m0 < p.bm ? M - m0 : p.bm;
    const TX* xs = reinterpret_cast<const TX*>(stage + p.wchunk_bytes);
    for (int r = pr0; r < rows; r += prs) {
      uint2 codes = make_uint2(0u, 0u);
      if (kk < K) {
        float v[8];
        if constexpr (sizeof(TX) == 2) {
          Pack8 in;
          in.v = *reinterpret_cast<const uint4*>(xs + r * p.kc + pv * 8);
#pragma unroll
          for (int t = 0; t < 8; ++t) v[t] = lo(in, t);
        } else {
          load8(xs + r * p.kc + pv * 8, v);
        }
        uint32_t w[2] = {0u, 0u};
#pragma unroll
        for (int t = 0; t < 8; ++t)
          w[t >> 2] |= q8_relu(affine(v[t], qa[t], qb[t]), s, lim)
                       << (8 * (t & 3));
        codes = make_uint2(w[0], w[1]);
      }
      *reinterpret_cast<uint2*>(smem + p.codes_off + r * cs + pv * 8) = codes;
    }
    __syncthreads();

    // ---- the step's products ----
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    }
    const uint32_t wb =
        p.resident ? s0 + p.w_off + k0
                   : s0 + p.ring_off + (st % p.stages) * p.stage_bytes;
    const uint32_t wrow = wb + (wn * NTW * 8 + b_row) * ws + b_col;
    const int ksteps = (p.kp - k0 < p.kc ? p.kp - k0 : p.kc) / 32;
#pragma unroll 2
    for (int kq = 0; kq < ksteps; ++kq) {
      uint32_t a[2][4];
      ldsm_x4(a[0], s0 + a_off + kq * 32);
      ldsm_x4(a[1], s0 + a_off + 16 * cs + kq * 32);
#pragma unroll
      for (int jp = 0; jp < NTW / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, wrow + jp * 16 * ws + kq * 32);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_s8(acc[i][2 * jp], a[i], b[0], b[1]);
          mma_s8(acc[i][2 * jp + 1], a[i], b[2], b[3]);
        }
      }
      if (NTW & 1) {
        uint32_t b0, b1;
        ldsm_x2(b0, b1, wb + ((wn * NTW + NTW - 1) * 8 + (lane & 7)) * ws +
                            b_col + kq * 32);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_s8(acc[i][NTW - 1], a[i], b0, b1);
      }
    }
    if (c != p.nch - 1) continue;

    // ---- epilogue from the accumulators ----
    const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int nl = (wn * NTW + j) * 8 + t2;   // column in the group
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float y0 = __fmul_rn((float)acc[i][j][2 * h], inv_s);
          const float y1 = __fmul_rn((float)acc[i][j][2 * h + 1], inv_s);
          unsigned char* dst = stg + (h * 8 + g) * SROW + (j * 8 + t2) * OSZ;
          if constexpr (Q8) {
            const float* v2 = vs + 2 * p.kp;
            const uint32_t c0 =
                q8_relu(affine(y0, v2[nl], v2[p.ncol + nl]), s, lim);
            const uint32_t c1 =
                q8_relu(affine(y1, v2[nl + 1], v2[p.ncol + nl + 1]), s, lim);
            *reinterpret_cast<unsigned short*>(dst) =
                (unsigned short)(c0 | (c1 << 8));
          } else if constexpr (sizeof(TX) == 2) {
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(y0, y1);
          } else {
            *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
          }
        }
      }
      __syncwarp();
      store_rows(stg, SROW, NTW * 8 * OSZ, out, m0 + wm * 32 + i * 16, M,
                 (n0 + wn * NTW * 8) * OSZ, N * OSZ, lane);
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// conv3x3_i8: SAME 3x3 conv of (B*H*W, C) int8 codes as an implicit GEMM of
// depth 9*C against the int8 weight's K-major image wt (G rows of 9 * cbp
// bytes, cbp = C padded to 32, tap-major), zero padding per image,
// dequantized by 1/s into TO rows (bf16, or float32 unrounded).
//
// Bound on the H100 by bytes (1.9 us at r=64, batch 8, Cb=128 -> G=32);
// the products take 1.2 us at the int8 peak. Design:
// - Persistent blocks of 8 warps keep the weight image of their column
//   group (8*NT outputs: 36 KB at Cb=128 -> G=32) in shared memory,
//   copied once by 16-byte cp.async, rows padded by 16 bytes.
// - A tile of bm output rows (whole image rows of one or more images)
//   stages one halo: input rows m0 - W - 1 ... m0 + bm + W, at a row
//   stride of cbp + 16 bytes, copied by 16-byte cp.async (byte loads where
//   the rows are not 16-byte aligned), channels past C zero-filled. Two
//   halo buffers where two blocks still fit an SM, so the next tile's
//   copy runs under this tile's products; at r=64 two blocks of one
//   buffer each (one block's copy under the other's products), 20-25 %
//   faster at batches 64 and 256. The nine taps read it at fixed row
//   offsets of +-1 and +-W; a row outside its image (the SAME padding,
//   and every border between two images in one tile) reads a zero row
//   instead (each lane of an ldmatrix gives its own row address): no
//   divides per piece, no ninefold gather.
// - mma.sync m16n8k32 s8 fed by ldmatrix; a warp owns 32 rows, bm/32 warps
//   split the rows and the rest the 9*cbp depth (small M), their int32
//   partials added through the halo buffer after the products.
// - The epilogue runs from the accumulators (times 1/s, one rounding to
//   bf16), packed per warp and stored as whole 16-byte rows into the
//   buffer's out32 slice.
// Measured: 10.7 us at r=64, batch 8 (its first WMMA kernel 52.6) on an
// H100 80GB HBM3 at 700 W (PERF.md section 6).
// ---------------------------------------------------------------------------
struct I8ConvPlan {
  int bm;           // output rows per tile: 32 * row warps
  int cbp;          // C zero-padded to 32
  int ngrp;         // column groups of 8 * NT outputs
  int stages;       // halo buffers: 2 or 1
  int w_off;        // weight image: 8 * NT rows of 9 * cbp + 16 bytes
  int zero_off;     // a zero row of cbp bytes
  int stage_off;    // the halo buffers (then a k split's partials)
  int stage_bytes;
  int out_off;      // the warps' output stages
  int vec16;        // 1: the input rows 16-byte aligned (cp.async)
};

template <int NT, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    i8_conv_kernel(const i8* __restrict__ y, long long ldy, int M, int H,
                   int W, int C, const i8* __restrict__ wt, int G, float s,
                   ByteView out, I8ConvPlan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int GB = NT * 8;
  constexpr int OSZ = (int)sizeof(TO);
  constexpr int SROW = GB * OSZ + 16;   // output stage row, bytes
  constexpr int RS = GB + 4;            // a partial sum's row, ints
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm_n = p.bm / 32, wk_n = kWarps / wm_n;
  const int wm = warp % wm_n, wk = warp / wm_n;
  const int kst = p.cbp / 32, steps = 9 * kst;
  const int s_lo = wk * steps / wk_n, s_hi = (wk + 1) * steps / wk_n;
  const int hs = p.cbp + 16, ws = 9 * p.cbp + 16;
  const int halo_rows = p.bm + 2 * W + 2;
  const int hw = H * W;
  const int col = blockIdx.x % p.ngrp, n0 = col * GB;
  const int tiles = (M + p.bm - 1) / p.bm;
  const int first = blockIdx.x / p.ngrp, stride = gridDim.x / p.ngrp;
  if (first >= tiles) return;
  const int Q = (tiles - 1 - first) / stride + 1;
  const float inv_s = __frcp_rn(s);

  for (int i = tid; i < p.cbp / 16; i += kThreads)
    *reinterpret_cast<uint4*>(smem + p.zero_off + i * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  // the group's weight rows, committed with the first halo
  {
    const int vpr = 9 * p.cbp / 16;
    for (int i = tid; i < GB * vpr; i += kThreads) {
      const int r = i / vpr, v = i - r * vpr;
      const bool ok = n0 + r < G;
      cp_async16(s0 + p.w_off + r * ws + v * 16,
                 ok ? wt + (long long)(n0 + r) * (9 * p.cbp) + v * 16 : wt,
                 ok ? 16 : 0);
    }
  }
  // tile q's halo: rows [g0, g0 + halo_rows) in [0, M), 16-byte pieces of
  // cbp bytes, zero past C
  const auto issue = [&](int q) {
    const int g0 = (first + q * stride) * p.bm - W - 1;
    const uint32_t dst = s0 + p.stage_off + (q % p.stages) * p.stage_bytes;
    const int r_lo = g0 < 0 ? -g0 : 0;
    const int r_hi = M - g0 < halo_rows ? M - g0 : halo_rows;
    const int vpr = p.cbp / 16;
    for (int i = tid; i < (r_hi - r_lo) * vpr; i += kThreads) {
      const int r = r_lo + i / vpr, c = (i % vpr) * 16;
      const i8* src = y + (long long)(g0 + r) * ldy + c;
      const int nb = C - c < 16 ? (C - c > 0 ? C - c : 0) : 16;
      if (p.vec16) {
        cp_async16(dst + r * hs + c, nb ? src : y, nb);
      } else {
        union {
          uint4 v;
          i8 b[16];
        } u;
        u.v = make_uint4(0u, 0u, 0u, 0u);
        for (int b = 0; b < nb; ++b) u.b[b] = src[b];
        *reinterpret_cast<uint4*>(smem + p.stage_off +
                                  (q % p.stages) * p.stage_bytes + r * hs +
                                  c) = u.v;
      }
    }
    cp_async_commit();
  };

  const int a_row = wm * 32 + (lane & 15);
  const int a_ofs = (lane >> 4) * 16;
  const int b_row = ((lane >> 4) << 3) + (lane & 7);
  const int b_col = ((lane >> 3) & 1) * 16;
  unsigned char* stg = smem + p.out_off + warp * 16 * SROW;

  if (p.stages == 2) issue(0);
  for (int q = 0; q < Q; ++q) {
    if (p.stages == 1) {
      issue(q);
      cp_async_wait<0>();
    } else if (q + 1 < Q) {
      issue(q + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile q's halo (and the weight) landed
    const int m0 = (first + q * stride) * p.bm;
    const uint32_t hbase =
        s0 + p.stage_off + (q % p.stages) * p.stage_bytes;
    const uint32_t zbase = s0 + p.zero_off;

    // the lane's two A rows: image position
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
    int acc[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

    for (int tap = s_lo / kst; tap * kst < s_hi; ++tap) {
      const int k_lo = s_lo > tap * kst ? s_lo - tap * kst : 0;
      const int k_hi = s_hi < (tap + 1) * kst ? s_hi - tap * kst : kst;
      uint32_t abase[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int hr = tap_row(a_row + 16 * i, yy[i], xx[i], in_range[i],
                               tap / 3 - 1, tap % 3 - 1, H, W);
        abase[i] = (hr < 0 ? zbase : hbase + (uint32_t)(hr * hs)) + a_ofs;
      }
      const uint32_t wrow =
          s0 + p.w_off + b_row * ws + tap * p.cbp + b_col;
#pragma unroll 2
      for (int kk = k_lo; kk < k_hi; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) ldsm_x4(a[i], abase[i] + kk * 32);
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t b[4];
          ldsm_x4(b, wrow + jp * 16 * ws + kk * 32);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_s8(acc[i][2 * jp], a[i], b[0], b[1]);
            mma_s8(acc[i][2 * jp + 1], a[i], b[2], b[3]);
          }
        }
        if (NT & 1) {
          uint32_t b0, b1;
          ldsm_x2(b0, b1, s0 + p.w_off + ((NT - 1) * 8 + (lane & 7)) * ws +
                              tap * p.cbp + b_col + kk * 32);
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_s8(acc[i][NT - 1], a[i], b0, b1);
        }
      }
    }

    const int g = lane >> 2, t2 = 2 * (lane & 3);
    if (wk_n > 1) {
      // the depth split's partials meet in this (now read) halo buffer
      __syncthreads();
      int* red = reinterpret_cast<int*>(smem + p.stage_off +
                                        (q % p.stages) * p.stage_bytes);
      if (wk > 0) {
        int* rw = red + ((wk - 1) * p.bm + wm * 32 + g) * RS + t2;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            *reinterpret_cast<int2*>(rw + 16 * i * RS + 8 * j) =
                make_int2(acc[i][j][0], acc[i][j][1]);
            *reinterpret_cast<int2*>(rw + (16 * i + 8) * RS + 8 * j) =
                make_int2(acc[i][j][2], acc[i][j][3]);
          }
      }
      __syncthreads();
      if (wk == 0) {
        for (int k = 1; k < wk_n; ++k) {
          const int* rw = red + ((k - 1) * p.bm + wm * 32 + g) * RS + t2;
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const int2 u = *reinterpret_cast<const int2*>(
                  rw + 16 * i * RS + 8 * j);
              const int2 v = *reinterpret_cast<const int2*>(
                  rw + (16 * i + 8) * RS + 8 * j);
              acc[i][j][0] += u.x;
              acc[i][j][1] += u.y;
              acc[i][j][2] += v.x;
              acc[i][j][3] += v.y;
            }
        }
      }
    }
    if (wk == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float y0 = __fmul_rn((float)acc[i][j][2 * h], inv_s);
            const float y1 = __fmul_rn((float)acc[i][j][2 * h + 1], inv_s);
            unsigned char* dst = stg + (h * 8 + g) * SROW + (j * 8 + t2) * OSZ;
            if constexpr (OSZ == 2)
              *reinterpret_cast<__nv_bfloat162*>(dst) =
                  __floats2bfloat162_rn(y0, y1);
            else
              *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
          }
        __syncwarp();
        store_rows(stg, SROW, GB * OSZ, out, m0 + wm * 32 + i * 16, M,
                   n0 * OSZ, G * OSZ, lane);
        __syncwarp();
      }
    }
    __syncthreads();   // this halo buffer is free for tile q + 2
  }
}

template <int NTW, bool Q8, typename TX>
int launch_i8_dot(const void* x, long long ldx, int M, int K, const void* inv,
                  const void* shift, const void* wt, long long ldw, int N,
                  float s, const void* inv2, const void* shift2,
                  const ByteView& out, const I8DotPlan& p, int smem,
                  cudaStream_t st) {
  auto kern = i8_dot_kernel<NTW, Q8, TX>;
  const int items = (M + p.bm - 1) / p.bm * p.ngrp;
  int grid = 0;
  const int e = persistent_grid(kern, items, kThreads, smem, p.ngrp, &grid);
  if (e) return e;
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const TX*>(x), ldx, M, K, static_cast<const float*>(inv),
      static_cast<const float*>(shift), static_cast<const i8*>(wt), ldw, N, s,
      static_cast<const float*>(inv2), static_cast<const float*>(shift2), out,
      p);
  return (int)cudaGetLastError();
}

template <bool Q8, typename TX>
int dispatch_i8_dot(int ntw, const void* x, long long ldx, int M, int K,
                    const void* inv, const void* shift, const void* wt,
                    long long ldw, int N, float s, const void* inv2,
                    const void* shift2, const ByteView& out,
                    const I8DotPlan& p, int smem, cudaStream_t st) {
  switch (ntw) {
#define CUNET_I8_NTW(n)                                                     \
  case n:                                                                   \
    return launch_i8_dot<n, Q8, TX>(x, ldx, M, K, inv, shift, wt, ldw, N, s, \
                                    inv2, shift2, out, p, smem, st);
    CUNET_I8_NTW(1) CUNET_I8_NTW(2) CUNET_I8_NTW(4)
#undef CUNET_I8_NTW
  }
  return (int)cudaErrorInvalidValue;
}

template <int NT, typename TO>
int launch_i8_conv(const void* y, long long ldy, int M, int H, int W, int C,
                   const void* wt, int G, float s, const ByteView& out,
                   const I8ConvPlan& p, int smem, cudaStream_t st) {
  auto kern = i8_conv_kernel<NT, TO>;
  const int items = (M + p.bm - 1) / p.bm * p.ngrp;
  int grid = 0;
  const int e = persistent_grid(kern, items, kThreads, smem, p.ngrp, &grid);
  if (e) return e;
  kern<<<grid, kThreads, smem, st>>>(static_cast<const i8*>(y), ldy, M, H, W,
                                     C, static_cast<const i8*>(wt), G, s, out,
                                     p);
  return (int)cudaGetLastError();
}

template <typename TO>
int dispatch_i8_conv(int nt, const void* y, long long ldy, int M, int H,
                     int W, int C, const void* wt, int G, float s,
                     const ByteView& out, const I8ConvPlan& p, int smem,
                     cudaStream_t st) {
  switch (nt) {
#define CUNET_I8_NT(n)                                                     \
  case n:                                                                  \
    return launch_i8_conv<n, TO>(y, ldy, M, H, W, C, wt, G, s, out, p, smem, \
                                 st);
    CUNET_I8_NT(1) CUNET_I8_NT(2) CUNET_I8_NT(4) CUNET_I8_NT(8)
#undef CUNET_I8_NT
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x bf16 (f32: float32); with inv2 the output is int8 codes, else x's
// type. ldo and img_stride in output elements.
int cunet_affine_dot_i8(const void* x, long long ldx, long long M, int K,
                        const void* inv, const void* shift, const void* wt,
                        long long ldw, int N, float s, const void* inv2,
                        const void* shift2, void* out, long long ldo,
                        long long rows_per_img, long long img_stride, int f32,
                        int bm, int ncol, int ngrp, int ntw, int kp, int kc,
                        int nch, int stages, int resident, int w_off,
                        int vec_off, int ring_off, int stage_bytes,
                        int wchunk_bytes, int codes_off, int out_off,
                        int smem, void* stream) {
  const int osz = inv2 ? 1 : (f32 ? 4 : 2);
  const ByteView ov{static_cast<unsigned char*>(out), ldo * osz,
                    (int)rows_per_img, img_stride * osz};
  const I8DotPlan p{bm,       ncol,    ngrp,     kp,          kc,
                    nch,      stages,  resident, w_off,       vec_off,
                    ring_off, stage_bytes, wchunk_bytes, codes_off, out_off};
  const auto st = static_cast<cudaStream_t>(stream);
  const int m = (int)M;
  if (inv2 && f32)
    return dispatch_i8_dot<true, float>(ntw, x, ldx, m, K, inv, shift, wt,
                                        ldw, N, s, inv2, shift2, ov, p, smem,
                                        st);
  if (inv2)
    return dispatch_i8_dot<true, bf16>(ntw, x, ldx, m, K, inv, shift, wt, ldw,
                                       N, s, inv2, shift2, ov, p, smem, st);
  if (f32)
    return dispatch_i8_dot<false, float>(ntw, x, ldx, m, K, inv, shift, wt,
                                         ldw, N, s, nullptr, nullptr, ov, p,
                                         smem, st);
  return dispatch_i8_dot<false, bf16>(ntw, x, ldx, m, K, inv, shift, wt, ldw,
                                      N, s, nullptr, nullptr, ov, p, smem, st);
}

// out bf16 (f32: float32), ldo in elements.
int cunet_conv3x3_i8(const void* y, long long ldy, long long M, int H, int W,
                     int C, const void* wt, int G, float s, void* out,
                     long long ldo, int f32, int bm, int cbp, int nt,
                     int ngrp, int stages, int w_off, int zero_off,
                     int stage_off, int stage_bytes, int out_off, int vec16,
                     int smem, void* stream) {
  const int osz = f32 ? 4 : 2;
  const ByteView ov{static_cast<unsigned char*>(out), ldo * osz, (int)M, 0};
  const I8ConvPlan p{bm,        cbp,         ngrp,    stages, w_off,
                     zero_off,  stage_off,   stage_bytes, out_off, vec16};
  const auto st = static_cast<cudaStream_t>(stream);
  const int m = (int)M;
  if (f32)
    return dispatch_i8_conv<float>(nt, y, ldy, m, H, W, C, wt, G, s, ov, p,
                                   smem, st);
  return dispatch_i8_conv<bf16>(nt, y, ldy, m, H, W, C, wt, G, s, ov, p, smem,
                                st);
}

}  // extern "C"
