// Hand-written Hopper kernel of the two float32 3x3 convs of the ghost-BN
// train step (cunet_tpu_torch/kernels/buf_ops.py wraps it, plan
// buf_ops.conv_f32_plan):
//   - conv3x3[f32,tile]: out = conv3x3(relu(y * inv_t + shift_t)), the BN2
//     prologue's per-tile vectors (t = m / tile_rows), zero padding staying
//     zero after it; it replaces, at float32, _norm_relu + _conv3x3_t
//     (cunet_tpu/kernels/train_slot.py:647);
//   - conv3x3_dx[f32]: out = [gx * inv_t + shift_t > 0] conv3x3(dy) through
//     the flipped, transposed weight (train_ops.flip_w3, applied here as
//     the weight is split), the d_z2 half of _conv3x3_bwd
//     (cunet_tpu/kernels/train_slot.py:732).
// The eval conv and the QuanInput forms stay on f32_kernels.cu's
// dot3_kernel, and so do the shapes where its plan splits K (small M).
//
// Arithmetic: dot3_kernel's, bit for bit. The implicit GEMM's depth K = 9C
// is tap-major (k = tap * C + c); each 32-deep chunk of it (C is a multiple
// of 32, so a chunk lies in one tap) sums from zero, its two k16 steps each
// adding the six plane products x_i W_j with i + j <= 4 (1-based) of the
// exact three-way bf16 split of both operands (common.cuh split3), small
// terms first: x1 W3, x2 W2, x1 W2, x3 W1, x2 W1, x1 W1; the chunk then
// joins the output's running sum by one round-to-nearest float32 add, in
// ascending k. The products run on wgmma, whose chains give mma.sync's
// (WMMA's) bits where a chain's first product takes scale-d 0 (PERF.md
// section 6); nothing writes an accumulator between two wgmmas (ptxas
// warning C7515 would serialize them). The prologue value is
// fmaxf(affine(x, inv, shift), 0) of the unrounded x, as dot3_kernel's.
//
// What bounds it on the card: the six bf16 passes of its product. At
// r=64, batch 24 (M = 98,304; Cb = 128 -> G = 32 forward, 32 -> 128 dx,
// K = 1,152 or 288) they take 44.0 us at 989 TFLOP/s; its float32 bytes
// (the input once, the output once, the dx's gate input once) 18.8 or
// 60.1 us. Measured on an H100 80GB HBM3 at 700 W (PERF.md section 6):
// about 4x and 3.4x that; the forward's halo fill and its chains' latency
// (twelve dependent wgmmas a chunk, 36 chunks) bound it, not its
// products. Design (one block an SM, 8 warps: what it cannot hide behind
// other warps it takes out of the loops):
// - Persistent blocks, each a run of consecutive 128-row tiles, a
//   warpgroup 64 rows of a tile (wgmma m64nNPk16, NP = N padded to 32, 64
//   or 128). A tile's halo (its rows, one image row and one pixel either
//   side: R = 128 + 2W + 2 rows of C channels) lies in a ring of R rows
//   (pixel p in row (p - p0) % R), so after a block's first tile only its
//   last 128 rows are new. The threads load them in batches of 16-byte
//   vectors, the next batch in flight while this one is processed, apply
//   the forward's prologue with each row's own ghost-BN tile vectors and
//   split each element once into three bf16 planes, their 16-byte chunks
//   swizzled by the row (conflict-free ldmatrix).
// - Each k16 step's A comes from the planes by ldmatrix, each lane giving
//   the address of its row of the tap's shifted window, or of a zero row
//   where the source pixel leaves the row's image (halo.cuh tap_row): the
//   padding costs no branch. A chunk's A is loaded while the previous
//   chunk's products run; at NP <= 64 the two chunks of a W slice run as
//   two chains issued together, on sums of their own, joined in order.
// - W is split once a call into its planes by a pre-pass
//   (conv_split_w_kernel: per 32-deep chunk, core matrices of 8 outputs x
//   8 depths, the K-major B operand of a descriptor; the conv launched
//   programmatically after it, its first halo fill beside the split), and
//   each chunk's three planes (3 x 32 x NP bf16) stream, two chunks a
//   slice, into two buffers by cp.async a slice ahead, copied by one warp,
//   which alone then fences them for the wgmmas' proxy (every thread's
//   fence cost the forward a tenth of its time); a block-wide barrier a
//   slice.
// - The epilogue swaps halves within a lane pair (dx_f32_kernels.cu's), so
//   that a lane holds four consecutive columns of one row. The dx's gate
//   input tile arrives by cp.async during the products and becomes its
//   gate (1 or 0) in place, each thread keeping one 4-column vector of the
//   BN2 affine; each dx is written in place of its gate, the tile then
//   leaving as whole rows of 16-byte vectors.
//
// The entry point launches on the stream it is given and returns
// cudaGetLastError().

#include "halo.cuh"

namespace {

constexpr int kCvRows = 128;   // output rows of a block
constexpr int kCvDepth = 32;   // depth of a chunk (dot3_kernel's BK3)
constexpr int kCvSlice = 2;    // chunks of K a W slice
constexpr int kCvRing = 2;     // W slices in shared memory
constexpr int kCvBatch = 2;    // halo rows a thread loads at once
constexpr int kCvSplitThreads = 64;   // threads of a block of W's split

// d (64 x NP, this warp's 16 rows) = a (registers, 64 x 16) * B (smem
// descriptor, 16 x NP) + (acc ? d : 0), bf16 in, float32 out: acc = 0 is
// a chain's first product (scale-d 0, no zeroing of d).
__device__ __forceinline__ void wg_mma(float (&d)[16], const uint32_t (&a)[4],
                                       uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

__device__ __forceinline__ void wg_mma(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t desc, int acc) {
  wgmma_m64n64(d, a, desc, acc);
}

__device__ __forceinline__ void wg_mma(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t desc, int acc) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// The packed (9C, N) float32 weight (flip: the forward's (9N, C) weight
// read as train_ops.flip_w3 of it, tap t's rows the transposed rows of tap
// 8 - t) split into its three bf16 planes (split3) at wp, chunk by chunk
// of K (j = t * C / 32 + c / 32): chunk j, plane p, core matrix (output
// group n / 8, depth group (c % 32) / 8) at element ((j * 3 + p) * (NP /
// 8) + n / 8) * 256 + ((c % 32) / 8) * 64, its row n % 8 the 8 depths of
// output n; zero past N. Thread (t, n, c / 8) splits one such row, the
// index of the 8 depths the one its warp's reads take whole lines at (n
// for the forward's (9C, N) rows, c with flip); small blocks, so that the
// few rows spread over many SMs.
__global__ void __launch_bounds__(kCvSplitThreads)
    conv_split_w_kernel(const float* __restrict__ w, int C, int N, int NP,
                        int flip, bf16* __restrict__ wp) {
  const int cg = C / 8;
  const int plane = NP * kCvDepth;   // elements of a chunk's plane
  // the conv launched after it may start its halo fill at once
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  for (long long i = (long long)blockIdx.x * kCvSplitThreads + threadIdx.x;
       i < 9LL * NP * cg; i += (long long)gridDim.x * kCvSplitThreads) {
    const int c0 = (int)(flip ? i % cg : i / NP % cg) * 8;
    const int n = (int)(flip ? i / cg % NP : i % NP);
    const int t = (int)(i / cg / NP);
    Pack8 a, b, c;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float v = 0.f;
      if (n < N)
        v = flip ? w[((long long)(8 - t) * N + n) * C + c0 + e]
                 : w[((long long)t * C + c0 + e) * N + n];
      split3(v, a.u[e], b.u[e], c.u[e]);
    }
    const long long j = (long long)t * (C / kCvDepth) + c0 / kCvDepth;
    const long long o = ((j * 3 * (NP / 8) + n / 8) * 4 +
                         (c0 % kCvDepth) / 8) * 64 + (n % 8) * 8;
    *reinterpret_cast<uint4*>(wp + o) = a.v;
    *reinterpret_cast<uint4*>(wp + plane + o) = b.v;
    *reinterpret_cast<uint4*>(wp + 2 * plane + o) = c.v;
  }
}

struct CvArgs {
  const float* y;        // the conv input (M, C)
  long long ldy;
  const bf16* wp;        // W's planes (conv_split_w_kernel)
  const float* inv;      // the forward's prologue vectors (PRO)
  const float* shift;
  long long vstride;     // floats between two ghost tiles' vectors
  long long tile_rows;   // rows of a ghost tile
  const float* gx;       // the dx's gate input (M, N) (GATE)
  long long ldgx;
  const float* ginv;
  const float* gshift;
  float* out;            // (M, N)
  long long ldo;
  int M, H, W, C, N;
  int halo_rows;         // 128 + 2W + 2
  int plane_bytes;       // bytes of one halo plane (halo_rows x C bf16)
  int zero_off;          // a 16-byte zero row
  int w_off;             // the W slice buffers
  int w_bytes;           // bytes of one chunk's three planes
  int g_off;             // the dx's gate input tile (kCvRows x (NP + 4))
};

// The 16-byte chunk ch of halo row r in a plane of C / 8 chunks a row:
// XOR-swizzled by the row, so the eight rows of an ldmatrix tile (eight
// consecutive halo rows, any start) fall in distinct bank groups.
__device__ __forceinline__ int halo_chunk(int r, int ch, int nc) {
  return ch ^ (nc >= 8 ? (r & 7) : nc == 4 ? ((r >> 1) & 3) : 0);
}

template <int NP, bool PRO, bool GATE>
__global__ void __launch_bounds__(kThreads, 1)
    conv_f32_kernel(const __grid_constant__ CvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wq = warp & 3, g8 = lane >> 2, q4 = lane & 3;
  const int C = a.C, nc = C / 8, rb = C * 2;   // chunks, bytes of a row
  const int R = a.halo_rows;           // rows of the halo ring
  const int ccs = C / kCvDepth;        // chunks of K a tap
  const int nck = 9 * ccs;             // chunks of K
  const int nsl = (nck + kCvSlice - 1) / kCvSlice;   // W slices
  const int sm = nsl > 2 ? nsl - 2 : nsl - 1;   // the gate pass's slice
  constexpr int GS = NP + 4;           // gate tile row stride, floats
  float* const gt = reinterpret_cast<float*>(smem + a.g_off);
  // the block's tiles: a run of consecutive ones, so that each tile's halo
  // shares all but kCvRows rows with the previous tile's (a ring of R
  // rows: pixel p in row (p - p0) % R)
  const int tiles = (a.M + kCvRows - 1) / kCvRows;
  const int t_beg = (int)((long long)blockIdx.x * tiles / gridDim.x);
  const int t_end = (int)((long long)(blockIdx.x + 1) * tiles / gridDim.x);
  const long long p0 = (long long)t_beg * kCvRows - a.W - 1;

  // W slice sl (chunks kCvSlice sl ..) into buffer sl % kCvRing, by warp
  // 0 alone (so that it alone fences its copies for the wgmmas' proxy)
  const auto issue_w = [&](int sl) {
    if (warp != 0 || sl >= nsl) return;
    const int j0 = sl * kCvSlice;
    const int bytes = (nck - j0 < kCvSlice ? nck - j0 : kCvSlice) * a.w_bytes;
    const char* src = reinterpret_cast<const char*>(a.wp) +
                      (long long)j0 * a.w_bytes;
    const uint32_t dst = s0 + a.w_off + (sl % kCvRing) * kCvSlice * a.w_bytes;
    for (int i = lane; i < bytes / 16; i += 32)
      cp_async16(dst + i * 16, src + i * 16, 16);
    cp_async_commit();
  };
  // the barrier before W slice sl's first chunk: warp 0's copies of it
  // landed and fenced for the wgmmas; every warp is done with slice sl -
  // 1, whose buffer then takes slice sl + 1
  const auto barrier = [&](int sl) {
    if (warp == 0) {
      cp_async_wait<0>();
      fence_proxy_async();
    }
    __syncthreads();
    issue_w(sl + 1);
  };
  // B of chunk j's k16 step s, W plane pw: core matrices (output group,
  // depth group 2s (+1)), 128 bytes apart along K, 512 along N
  const auto bdesc = [&](int j, int pw, int s) {
    return smem_desc(s0 + a.w_off +
                         ((j / kCvSlice) % kCvRing * kCvSlice + j % kCvSlice) *
                             a.w_bytes +
                         pw * (a.w_bytes / 3) + s * 256,
                     128, 512);
  };
  // chunk j's twelve products on A = aj into p, from zero (the caller
  // fences before and commits after)
  const auto chain = [&](int j, const uint32_t (&aj)[2][3][4],
                         float (&p)[NP / 2]) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      wg_mma(p, aj[s][0], bdesc(j, 2, s), s);
      wg_mma(p, aj[s][1], bdesc(j, 1, s), 1);
      wg_mma(p, aj[s][0], bdesc(j, 1, s), 1);
      wg_mma(p, aj[s][2], bdesc(j, 0, s), 1);
      wg_mma(p, aj[s][1], bdesc(j, 0, s), 1);
      wg_mma(p, aj[s][0], bdesc(j, 0, s), 1);
    }
  };

  if (tid == 0)
    *reinterpret_cast<uint4*>(smem + a.zero_off) = make_uint4(0, 0, 0, 0);
  long long lo = 0, hi = 0;   // the rows of the vectors iv, sh (PRO)
  float4 iv[2], sh[2];
  for (int t = t_beg; t < t_end; ++t) {
    const long long m0 = (long long)t * kCvRows;
    const long long hb = m0 - a.W - 1;   // the pixel of halo row 0
    const int ro = (int)((hb - p0) % R);   // the ring row of halo row 0
    const auto ring = [&](int r) { return r + ro < R ? r + ro : r + ro - R; };
    if (t != t_beg) issue_w(0);

    // the halo rows not in the ring yet (all of them for the block's first
    // tile, the last kCvRows after it), 8 channels (two 16-byte loads, one
    // 16-byte store a plane) at a time: thread (row stripe, 8-channel
    // chunk ch) in batches of kCvBatch rows, the next batch in flight
    // while it applies the prologue to this one's and splits them into
    // the three planes; rows outside [0, M) are never read (their taps
    // read the zero row)
    if (tid / nc < kThreads / nc) {
      const int stripes = kThreads / nc, ch = tid % nc;
      const int stride = kCvBatch * stripes;
      const int first = (t == t_beg ? 0 : R - kCvRows) + tid / nc;
      const auto live = [&](int r) {
        return r < R && hb + r >= 0 && hb + r < a.M;
      };
      const auto batch_in = [&](int r0, float4 (&x)[kCvBatch][2]) {
#pragma unroll
        for (int b = 0; b < kCvBatch; ++b) {
          const int r = r0 + b * stripes;
          if (live(r)) {
            const float4* src =
                reinterpret_cast<const float4*>(a.y + (hb + r) * a.ldy) +
                2 * ch;
            x[b][0] = __ldg(src);
            x[b][1] = __ldg(src + 1);
          }
        }
      };
      // one row's prologue, split and stores (its vectors iv, sh loaded)
      const auto row_out = [&](int r, const float4 (&x)[2]) {
        float u[8] = {x[0].x, x[0].y, x[0].z, x[0].w,
                      x[1].x, x[1].y, x[1].z, x[1].w};
        if constexpr (PRO) {
          const float ivs[8] = {iv[0].x, iv[0].y, iv[0].z, iv[0].w,
                                iv[1].x, iv[1].y, iv[1].z, iv[1].w};
          const float shs[8] = {sh[0].x, sh[0].y, sh[0].z, sh[0].w,
                                sh[1].x, sh[1].y, sh[1].z, sh[1].w};
#pragma unroll
          for (int e = 0; e < 8; ++e)
            u[e] = fmaxf(affine(u[e], ivs[e], shs[e]), 0.f);
        }
        uint4 p1, p2, p3;
        split_pair(u[0], u[1], p1.x, p2.x, p3.x);
        split_pair(u[2], u[3], p1.y, p2.y, p3.y);
        split_pair(u[4], u[5], p1.z, p2.z, p3.z);
        split_pair(u[6], u[7], p1.w, p2.w, p3.w);
        const int q = ring(r);
        unsigned char* d = smem + q * rb + halo_chunk(q, ch, nc) * 16;
        *reinterpret_cast<uint4*>(d) = p1;
        *reinterpret_cast<uint4*>(d + a.plane_bytes) = p2;
        *reinterpret_cast<uint4*>(d + 2 * a.plane_bytes) = p3;
      };
      // the vectors of row r's ghost tile (PRO), where they change
      const auto vectors = [&](int r) {
        const long long p = hb + r;
        if (p < lo || p >= hi) {
          const long long tt = p / a.tile_rows;
          const float4* vi =
              reinterpret_cast<const float4*>(a.inv + tt * a.vstride) + 2 * ch;
          const float4* vs =
              reinterpret_cast<const float4*>(a.shift + tt * a.vstride) +
              2 * ch;
          iv[0] = __ldg(vi);
          iv[1] = __ldg(vi + 1);
          sh[0] = __ldg(vs);
          sh[1] = __ldg(vs + 1);
          lo = tt * a.tile_rows;
          hi = lo + a.tile_rows;
        }
      };
      // a batch: where its rows all lie in the vectors' tile (the rule:
      // a ghost tile holds whole images), one pass with no branch but the
      // stores' own, so the rows' chains interleave
      const auto batch_out = [&](int r0, const float4 (&x)[kCvBatch][2]) {
        bool same = true;
        if constexpr (PRO) {
          vectors(r0);
#pragma unroll
          for (int b = 0; b < kCvBatch; ++b) {
            const int r = r0 + b * stripes;
            same = same && (!live(r) || (hb + r >= lo && hb + r < hi));
          }
        }
        if (same) {
#pragma unroll
          for (int b = 0; b < kCvBatch; ++b)
            if (live(r0 + b * stripes)) row_out(r0 + b * stripes, x[b]);
        } else {
#pragma unroll
          for (int b = 0; b < kCvBatch; ++b) {
            const int r = r0 + b * stripes;
            if (!live(r)) continue;
            if constexpr (PRO) vectors(r);
            row_out(r, x[b]);
          }
        }
      };
      float4 xa[kCvBatch][2], xb[kCvBatch][2];
      batch_in(first, xa);
      for (int r0 = first; r0 < R; r0 += 2 * stride) {
        batch_in(r0 + stride, xb);
        batch_out(r0, xa);
        batch_in(r0 + 2 * stride, xa);
        batch_out(r0 + stride, xb);
      }
    }
    if (t == t_beg) {
      // W's planes come from the split launched before this grid, which
      // may still run while the first halo fills
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      issue_w(0);
    }
    if constexpr (GATE) {
      // the gate input's rows of the tile (wanted by the gate pass), by
      // the warps other than warp 0, whose copies are W's alone
      const int nv = a.N / 4;
      for (int e = tid - 32; e >= 0 && e < kCvRows * nv;
           e += kThreads - 32) {
        const int r = e / nv, v = e - r * nv;
        if (m0 + r < a.M)
          cp_async16(s0 + a.g_off + (r * GS + v * 4) * 4,
                     a.gx + (m0 + r) * a.ldgx + v * 4, 16);
      }
      cp_async_commit();
    }

    // this lane's ldmatrix row: row l & 15 of its warp's 16 (matrices 0
    // and 2 rows 0-7, 1 and 3 rows 8-15), depth chunk l >> 4 of a k16
    // step; its image position
    const int rl = wg * 64 + wq * 16 + (lane & 15), kh = lane >> 4;
    const bool in = m0 + rl < a.M;
    const int pix = (int)((m0 + rl) % ((long long)a.H * a.W));
    const int yy = pix / a.W, xx = pix - yy * a.W;
    // A of chunk j (k16 steps s = 0, 1; planes 0-2): each lane's row of
    // the tap's window, or the zero row
    const auto load_a = [&](int j, uint32_t (&A)[2][3][4]) {
      const int tap = j / ccs, k0 = (j - tap * ccs) * kCvDepth;
      const int hr =
          tap_row(rl, yy, xx, in, tap / 3 - 1, tap % 3 - 1, a.H, a.W);
      const int q = hr < 0 ? 0 : ring(hr);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint32_t ad =
            hr < 0 ? s0 + a.zero_off
                   : s0 + q * rb +
                         halo_chunk(q, (k0 + 16 * s) / 8 + kh, nc) * 16;
#pragma unroll
        for (int p = 0; p < 3; ++p)
          ldsm_x4(A[s][p], ad + (hr < 0 ? 0 : p * a.plane_bytes));
      }
    };
    float acc[NP / 2], part[NP / 2];
#pragma unroll
    for (int e = 0; e < NP / 2; ++e) acc[e] = 0.f;
    // a chunk's sum joins the running sum once its chain has completed
    const auto join = [&](float (&p)[NP / 2]) {
#pragma unroll
      for (int e = 0; e < NP / 2; ++e) {
        reg_fence(p[e]);
        acc[e] = __fadd_rn(acc[e], p[e]);
      }
    };
    // the staged gx becomes its gate, 1 or 0 (GATE): thread (row stripe,
    // 4-column vector v), its vectors reloaded where the ghost tile
    // changes
    const auto gate_pass = [&]() {
      const int nv = a.N / 4, v = tid % nv;
      long long glo = 0, ghi = 0;
      float4 gi = make_float4(0.f, 0.f, 0.f, 0.f), gs = gi;
      if (tid / nv < kThreads / nv)
        for (int r = tid / nv; r < kCvRows; r += kThreads / nv) {
          const long long mr = m0 + r;
          if (mr >= a.M) break;
          if (mr < glo || mr >= ghi) {
            const long long tt = a.vstride ? mr / a.tile_rows : 0;
            gi = __ldg(reinterpret_cast<const float4*>(a.ginv +
                                                       tt * a.vstride) + v);
            gs = __ldg(reinterpret_cast<const float4*>(a.gshift +
                                                       tt * a.vstride) + v);
            glo = a.vstride ? tt * a.tile_rows : 0;
            ghi = a.vstride ? glo + a.tile_rows : a.M;
          }
          float4* px = reinterpret_cast<float4*>(gt + r * GS + v * 4);
          const float4 g = *px;
          *px = make_float4(affine(g.x, gi.x, gs.x) > 0.f ? 1.f : 0.f,
                            affine(g.y, gi.y, gs.y) > 0.f ? 1.f : 0.f,
                            affine(g.z, gi.z, gs.z) > 0.f ? 1.f : 0.f,
                            affine(g.w, gi.w, gs.w) > 0.f ? 1.f : 0.f);
        }
    };
    // the barrier of slice sl; before the gate pass's slice the gate
    // input's copies (GATE) landed
    const auto slice_start = [&](int sl) {
      if (GATE && sl == sm && warp != 0) cp_async_wait<0>();
      barrier(sl);
    };
    uint32_t A0[2][3][4], A1[2][3][4];
    __syncthreads();   // the halo planes (and the zero row) written
    load_a(0, A0);
    if constexpr (NP <= 64) {
      // the chunks in pairs (a W slice each): the two chains of a pair, on
      // sums of their own, issued together and waited for once, so that
      // the tensor cores interleave them; the joins in order once both
      // are done (a non-wgmma instruction that reads a sum while a chain
      // writes another serializes the wgmmas, C7514); the next pair's A
      // loaded while they run. Named A buffers, so the loop takes the
      // pairs two at a time (a register array takes no run-time index).
      float P1[NP / 2];
      uint32_t A2[2][3][4], A3[2][3][4];
      const auto pair = [&](int j, const uint32_t (&a0)[2][3][4],
                            const uint32_t (&a1)[2][3][4],
                            uint32_t (&n0)[2][3][4],
                            uint32_t (&n1)[2][3][4]) {
        slice_start(j / kCvSlice);
        wgmma_fence();
        chain(j, a0, part);
        if (j + 1 < nck) chain(j + 1, a1, P1);
        wgmma_commit();
        if (j + 2 < nck) load_a(j + 2, n0);
        if (j + 3 < nck) load_a(j + 3, n1);
        if (GATE && j == sm * kCvSlice) gate_pass();
        wgmma_wait<0>();
        join(part);
        if (j + 1 < nck) join(P1);
      };
      if (1 < nck) load_a(1, A1);
      for (int j = 0; j < nck; j += 4) {
        pair(j, A0, A1, A2, A3);
        if (j + 2 < nck) pair(j + 2, A2, A3, A0, A1);
      }
    } else {
      // chunk by chunk (two sums take too many registers at NP = 128): its
      // chain, the next chunk's A loaded while it runs, then the join
      const auto step = [&](int j, const uint32_t (&aj)[2][3][4],
                            uint32_t (&an)[2][3][4]) {
        if (j % kCvSlice == 0) slice_start(j / kCvSlice);
        wgmma_fence();
        chain(j, aj, part);
        wgmma_commit();
        if (j + 1 < nck) load_a(j + 1, an);
        if (GATE && j == sm * kCvSlice) gate_pass();
        wgmma_wait<0>();
        join(part);
      };
      for (int j = 0; j < nck; j += 2) {
        step(j, A0, A1);
        if (j + 1 < nck) step(j + 1, A1, A0);
      }
    }

    // the epilogue: an even lane takes row g8, columns 2q .. 2q + 3 of
    // each n8 tile, an odd lane row g8 + 8, columns 2(q - 1) ..
    const bool odd = q4 & 1;
    const int er = wg * 64 + wq * 16 + g8 + (odd ? 8 : 0);
    const long long m = m0 + er;
    const int nl0 = 2 * (q4 & 2);
    if constexpr (GATE) __syncthreads();   // every gate written
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      const float* c = acc + 4 * j;
      const float t0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
      const float t1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
      const int n = 8 * j + nl0;
      if (m >= a.M || n >= a.N) continue;
      const float4 o = make_float4(odd ? t0 : c[0], odd ? t1 : c[1],
                                   odd ? c[2] : t0, odd ? c[3] : t1);
      if constexpr (GATE) {
        // the gate; dx in its place
        float4* px = reinterpret_cast<float4*>(gt + er * GS + n);
        const float4 g = *px;
        *px = make_float4(g.x != 0.f ? o.x : 0.f, g.y != 0.f ? o.y : 0.f,
                          g.z != 0.f ? o.z : 0.f, g.w != 0.f ? o.w : 0.f);
      } else {
        *reinterpret_cast<float4*>(a.out + m * a.ldo + n) = o;
      }
    }
    if constexpr (GATE) {
      // the tile out as whole rows of 16-byte vectors
      __syncthreads();
      const int nv = a.N / 4;
      for (int e = tid; e < kCvRows * nv; e += kThreads) {
        const int r = e / nv, v = e - r * nv;
        if (m0 + r < a.M)
          *reinterpret_cast<float4*>(a.out + (m0 + r) * a.ldo + v * 4) =
              *reinterpret_cast<const float4*>(gt + r * GS + v * 4);
      }
    }
    // every warp is done with the ring rows the next tile's halo takes,
    // the gate tile and the W buffers
    __syncthreads();
  }
}

template <int NP>
int launch_conv(const CvArgs& a, int pro, int smem, cudaStream_t st) {
  void (*kern)(CvArgs) = pro ? conv_f32_kernel<NP, true, false>
                             : conv_f32_kernel<NP, false, true>;
  int grid = 0;
  const int e = persistent_grid(kern, (a.M + kCvRows - 1) / kCvRows,
                                kThreads, smem, 1, &grid);
  if (e) return e;
  // a programmatic launch: the grid may start before the split of W ends,
  // and waits for it where it first reads W
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, a);
}

}  // namespace

extern "C" {

// The float32 3x3 conv of y (M, C) at row stride ldy, images H x W, with
// the packed float32 weight w: (9C, N), or with flip the forward's (9N,
// C), read as train_ops.flip_w3 of it (the dx). Exactly one of: ``inv`` /
// ``shift`` the BN2 prologue's per-tile vectors (the forward), or ``gx``
// (M, N) at ldgx with ``gate_inv`` / ``gate_shift`` the ReLU gate of the
// output (the dx); vstride / tile_rows as buf_ops._vec_args gives them.
// out (M, N) at ldo. Rows of y, out and gx, and the vectors, start on 16
// bytes. ``wp`` is the caller's scratch for W's planes (27 C np bf16);
// np, ``plane_bytes``, ``zero_off``, ``w_off``, ``g_off`` and ``smem`` the
// plan's (buf_ops.conv_f32_plan), checked against the kernel's layout.
// Launches the split of W, then the conv.
int cunet_conv_f32(const void* y, long long ldy, long long M, int H, int W,
                   int C, const void* w, int N, int flip, const void* inv,
                   const void* shift, long long vstride, long long tile_rows,
                   const void* gx, long long ldgx, const void* gate_inv,
                   const void* gate_shift, void* out, long long ldo,
                   void* wp, int np, int plane_bytes, int zero_off,
                   int w_off, int g_off, int smem, void* stream) {
  const int halo_rows = kCvRows + 2 * W + 2;
  const int w_bytes = 3 * kCvDepth * np * 2;
  const bool pro = inv != nullptr;
  const auto al16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const void* vi = pro ? inv : gate_inv;
  const void* vs = pro ? shift : gate_shift;
  const int gate_end = g_off + (pro ? 0 : kCvRows * (np + 4) * 4);
  if (C < kCvDepth || (C != 32 && C % 64) || N < 8 || N % 8 || np < N ||
      (np != 32 && np != 64 && np != 128) || (np > 32 && np / 2 >= N) ||
      pro == (gx != nullptr) || !vi || !vs || !al16(vi) || !al16(vs) ||
      vstride % 4 || tile_rows < 1 || ldy % 4 || !al16(y) || ldo % 4 ||
      !al16(out) || (!pro && (ldgx % 4 || !al16(gx))) || !al16(wp) ||
      plane_bytes != halo_rows * C * 2 || zero_off != 3 * plane_bytes ||
      w_off % 128 || w_off < zero_off + 16 || g_off % 16 ||
      g_off < w_off + kCvRing * kCvSlice * w_bytes || smem < gate_end ||
      M < 1 || M > 0x7fffffff || H < 1 || W < 1 || M % ((long long)H * W))
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  {
    const long long rows = 9LL * np * (C / 8);
    const long long want = (rows + kCvSplitThreads - 1) / kCvSplitThreads;
    conv_split_w_kernel<<<(unsigned)(want < 1024 ? want : 1024),
                          kCvSplitThreads, 0, st>>>(
        static_cast<const float*>(w), C, N, np, flip,
        static_cast<bf16*>(wp));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  CvArgs a;
  a.y = static_cast<const float*>(y);
  a.ldy = ldy;
  a.wp = static_cast<const bf16*>(wp);
  a.inv = static_cast<const float*>(inv);
  a.shift = static_cast<const float*>(shift);
  a.vstride = vstride;
  a.tile_rows = tile_rows;
  a.gx = static_cast<const float*>(gx);
  a.ldgx = ldgx;
  a.ginv = static_cast<const float*>(gate_inv);
  a.gshift = static_cast<const float*>(gate_shift);
  a.out = static_cast<float*>(out);
  a.ldo = ldo;
  a.M = (int)M;
  a.H = H;
  a.W = W;
  a.C = C;
  a.N = N;
  a.halo_rows = halo_rows;
  a.plane_bytes = plane_bytes;
  a.zero_off = zero_off;
  a.w_off = w_off;
  a.w_bytes = w_bytes;
  a.g_off = g_off;
  switch (np) {
    case 32:
      return launch_conv<32>(a, pro, smem, st);
    case 64:
      return launch_conv<64>(a, pro, smem, st);
    case 128:
      return launch_conv<128>(a, pro, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
