// Hand-written Hopper kernel of the float32 forward 1x1 of training with a
// folded-BN + ReLU prologue (cunet_tpu_torch/kernels/buf_ops.py wraps it,
// plan buf_ops.fwd_f32_plan):
//   out[m, n] = sum_k quan(relu(x[m, k] * inv_t[k] + shift_t[k])) W[k, n],
// with x read from G float32 feature groups (each (M, c_g) at its own row
// stride, the virtual concat of their columns: Ctot = sum c_g), W the
// (K, N) float32 weight as it lies, quan QuanInput's quantizer (bits 0:
// the identity) and t the BN tile of row m: m / tile_rows, vstride floats
// a tile (vstride 0: one [inv; shift] pair). Two forms run on it:
// affine_dot at float32 with per-tile ghost-BN vectors or bits_i (one
// group; the slot train step's _norm_relu + _dot, cunet_tpu/kernels/
// train_slot.py:188, :172, and _quan at the head) and #7's apply at
// float32 (the feature groups and one pair: _apply_kernel, cunet_tpu/
// kernels/train_bottleneck.py:66), which JAX runs as float32 x float32
// products at compute_dtype="float32".
//
// Arithmetic (f32_kernels.cu's, bit for bit its dot3_kernel): x after the
// prologue and W are split exactly into three bf16 planes (split3), and
// each k16 step adds the six plane products x_i W_j with i + j <= 4
// (1-based) in the order
//   x1 W3, x2 W2, x1 W2, x3 W1, x2 W1, x1 W1
// into the fragment of its 32-deep chunk of the concat, which starts from
// zero and joins the output's running sum by one round-to-nearest float32
// add, k ascending. QuanInput codes of bits <= 9 fill one bf16 plane: the
// three products of x's planes 2 and 3 (zeros) are skipped, as
// dot3_kernel's QUANT form skips them. The products run on wgmma, which
// gives mma.sync's (and WMMA's) bits for such chains (PERF.md section 6).
//
// What bounds it on the card: its bytes at the main path's shapes (x read
// once, the float32 output written once: 37.6 us at K=192 -> 128, r=64,
// batch 24; 52.6 us at #7's K=320 -> 128); its six bf16 passes take 29.3
// and 48.8 us at 989 TFLOP/s. Design (dx_f32_kernels.cu's pattern; PERF.md
// section 6 has the designs measured against it):
// - Persistent blocks of two warpgroups (two blocks an SM where N <= 32),
//   each keeping one block of 8 * NT output columns (all of N = 128 at K
//   <= 192, else half of it): its W columns loaded once and split once
//   into three bf16 planes of
//   core matrices in shared memory (8 columns x 8 depths, each column's
//   depths along K: the K-major B operand of a wgmma descriptor). The nkb
//   blocks that keep the column blocks of one row tile run side by side
//   (block b keeps column block b % nkb and walks row tiles b / nkb, +
//   grid / nkb, ...). Where W's planes do not fit beside the x buffers
//   (K > 384 at N = 128: the intermedia adapter at order >= 3, #7 at
//   order 14) W streams instead: each item's rows of it arrive with its
//   x slice and are split by the block into one slice of planes.
// - The block resolves the concat once into shared memory, one (address,
//   row stride) a 16-byte chunk of 4 columns, from the table by value (up
//   to 16 groups) or in device memory (common.cuh set_groups); a tile's
//   128 raw float32 x rows then arrive by cp.async in slices of 64 depths
//   (two chunks), into two buffers, the next slice loading while this one
//   computes.
// - Warpgroup wg owns rows wg*64 .. +64 of the tile and every column of
//   the block (wgmma m64n(8 NT)k16), its warp wm 16 rows. Each warpgroup
//   copies and waits for its own rows behind a barrier of its own (one a
//   slice; the block's where W streams), and the second starts about half
//   a slice later, so that one's loads, prologue and splits run while the
//   other's products do. The warps read the fragments as float32 pairs
//   and split them into their three planes in registers, two values an
//   instruction (halo.cuh split_pair): no plane buffer, and every x
//   element is prologued and split once a block. The prologue runs on the
//   fragments too, from [inv; shift] pairs held in registers, where the
//   tile's 128 rows lie in one ghost tile (#7's apply, the ghost-BN step
//   at r >= 16); else each warp first applies it to its 16 staged rows in
//   place, each lane keeping one 4-column vector of its rows' ghost tile
//   (a 128-row tile spans up to three ghost tiles of 32 or 96 rows at
//   r=4, so every row looks up its own).
// - The epilogue swaps halves within a lane pair (one shuffle a value), so
//   each lane holds four consecutive columns of one row and writes one
//   16-byte float32 vector into out's (M, N) view or image-major view;
//   padded columns (the head's 68 classes run as 72 wide, a block of 128)
//   are never stored.
//
// The entry point launches on the stream it is given and returns
// cudaGetLastError().

#include <vector>

#include "halo.cuh"

namespace {

template <int NT>
struct Wgmma;

template <>
struct Wgmma<2> {
  // d (64 x 16) = a (registers, 64 x 16) * B (smem descriptor, 16 x 16),
  // plus d where acc is nonzero
  static __device__ __forceinline__ void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(acc));
  }
};

template <>
struct Wgmma<4> {
  // d (64 x 32) = a (registers, 64 x 16) * B (smem descriptor, 16 x 32),
  // plus d where acc is nonzero
  static __device__ __forceinline__ void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(acc));
  }
};

template <>
struct Wgmma<8> {
  // d (64 x 64) = a (registers, 64 x 16) * B (smem descriptor, 16 x 64),
  // plus d where acc is nonzero
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(acc));
  }
};

template <>
struct Wgmma<16> {
  // d (64 x 128) = a (registers, 64 x 16) * B (smem descriptor, 16 x 128),
  // plus d where acc is nonzero
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(acc));
  }
};

constexpr int kFwRows = 128;            // rows of a tile: two warpgroups
constexpr int kFwSlice = 64;            // depths of a staged slice
constexpr int kFwXS = kFwSlice + 8;     // staged x row stride, floats
constexpr int kFwChunk = 32;            // depths of a chunk's sum

inline int up128(int b) {
  return (b + 127) / 128 * 128;
}

// The block's shared memory (buf_ops.fwd_f32_plan computes the same): W's
// three planes (ncol columns x dp depths of bf16 in core matrices of 8
// columns x 8 depths, 128 bytes: column group cg, depth group dg at
// (cg * dp / 8 + dg) * 128; dp = kp, or kFwSlice where W streams), the
// chunk table (kp / 4 Chunks), then two buffers, each kFwRows x rows of a
// slice at kFwXS floats and, where W streams, the slice's kFwSlice W rows
// (ncol floats each) as they lie.
struct FwLayout {
  int dp;           // depths of W's planes
  int w_plane;      // bytes of one W plane
  int tbl_off;      // the chunk table
  int stage_off;    // the first buffer
  int w_raw_off;    // the streamed W rows within a buffer
  int stage_bytes;  // bytes of a buffer
  int bytes;
};

inline FwLayout fw_layout(int kp, int ncol, bool stream) {
  FwLayout l;
  l.dp = stream ? kFwSlice : kp;
  l.w_plane = ncol * l.dp * 2;
  l.tbl_off = up128(3 * l.w_plane);
  l.stage_off = up128(l.tbl_off + kp / 4 * (int)sizeof(Chunk));
  l.w_raw_off = kFwRows * kFwXS * 4;
  l.stage_bytes = up128(l.w_raw_off + (stream ? kFwSlice * ncol * 4 : 0));
  l.bytes = l.stage_off + 2 * l.stage_bytes;
  return l;
}

// The feature table of the concat (set_groups fills it): G groups by value
// or, past kMaxGroups, at ext.
struct FwTable {
  const float* ptr[kMaxGroups];
  long long ld[kMaxGroups];
  int off[kMaxGroups + 1];
  int G;
  int K;
  int up;
  const long long* ext;
};

struct FwArgs {
  FwTable t;
  const float* inv;
  const float* shift;
  long long vstride;
  long long tile_rows;
  int bits;
  const float* w;
  long long ldw;
  OutViewOf<float> out;
  int M, N, K;
  int kp;    // K padded to kFwChunk
  int nkb;   // column blocks of 8 NT
  FwLayout L;
};

// A register the compiler may not move across the wgmma fence, commit and
// wait (volatile asm keeps its order among them): the A planes are whole
// before the products read them, the fragment is read only after the wait.
__device__ __forceinline__ void keep(float& r) {
  asm volatile("" : "+f"(r));
}
__device__ __forceinline__ void keep(uint32_t& r) {
  asm volatile("" : "+r"(r));
}

// Step s of a k16's six plane products: x plane plane_x(s) times W plane
// plane_w(s) (0-based), in the order x1 W3, x2 W2, x1 W2, x3 W1, x2 W1,
// x1 W1.
__host__ __device__ constexpr int plane_x(int s) {
  return s == 1 || s == 4 ? 1 : s == 3 ? 2 : 0;
}
__host__ __device__ constexpr int plane_w(int s) {
  return s == 0 ? 2 : s < 3 ? 1 : 0;
}

// NT: n8 tiles of the block's columns; STREAM: W in slices of kFwSlice
// rows, split by each item; QUANT: QuanInput's quantizer after the
// prologue (a.bits), and for codes of bits <= 9 the products of x's first
// plane alone. Template parameters, so an instance without them carries
// none of their code.
template <int NT, bool STREAM, bool QUANT>
__global__ void __launch_bounds__(kThreads, NT <= 4 ? 2 : 1)
    fw3_kernel(const __grid_constant__ FwArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kCols = 8 * NT;
  const FwLayout& L = a.L;
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = (blockIdx.x % a.nkb) * kCols;
  const int tiles = (a.M + kFwRows - 1) / kFwRows;
  const int first = blockIdx.x / a.nkb, stride = gridDim.x / a.nkb;
  if (first >= tiles) return;
  const int ns = (a.kp + kFwSlice - 1) / kFwSlice;   // slices of a tile
  const int items = ((tiles - 1 - first) / stride + 1) * ns;
  const int ng = L.dp / 8;                           // depth groups
  const int nq = a.kp / 4;                           // chunks of the concat

  // the concat's 4-column chunks resolved once: the address of row 0 and
  // the row stride (none at or past K)
  Chunk* tbl = reinterpret_cast<Chunk*>(smem + L.tbl_off);
  for (int c = tid; c < nq; c += kThreads) {
    Chunk ch{0, 0};
    if (4 * c < a.K) {
      const GroupRef<float> g = a.t.ext ? find_group<true, float>(a.t, 4 * c)
                                        : find_group<false, float>(a.t,
                                                                   4 * c);
      ch = Chunk{reinterpret_cast<long long>(g.col), g.ld};
    }
    tbl[c] = ch;
  }
  __syncthreads();

  // warpgroup wg: rows wg*64 .. +64 of a tile, every column of the block
  // (wgmma's accumulator layout: mma.sync's m16n8 per n8 tile); its warp
  // wm: rows R0 .. R0 + 16
  const int wg = warp >> 2, wm = warp & 3;
  const int R0 = wg * 64 + wm * 16;
  const int g = lane >> 2, q4 = lane & 3;
  const bool odd = q4 & 1;

  // item it (tile it / ns, slice it % ns): the x rows of this warpgroup
  // (zero past K and M), each thread one 4-column chunk of eight rows 8
  // apart, and, where W streams, a share of the slice's W rows (zero past
  // K and N)
  const int iv = tid & 15, ir = (tid & 127) >> 4;
  const auto issue = [&](int it) {
    const int q = it / ns, sl = it - q * ns;
    const int m0 = (first + q * stride) * kFwRows + wg * 64 + ir;
    const int k0 = sl * kFwSlice;
    const uint32_t base = s0 + L.stage_off + (it & 1) * L.stage_bytes +
                          ((wg * 64 + ir) * kFwXS + iv * 4) * 4;
    const int c = k0 / 4 + iv;
    const Chunk ch = c < nq ? tbl[c] : Chunk{0, 0};
    const char* src = reinterpret_cast<const char*>(ch.ptr) +
                      (long long)m0 * ch.ld * 4;
    const long long step = 8 * ch.ld * 4;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool ok = ch.ptr != 0 && m0 + 8 * i < a.M;
      cp_async16(base + i * 8 * kFwXS * 4,
                 ok ? src + i * step : reinterpret_cast<const char*>(a.w),
                 ok ? 16 : 0);
    }
    if constexpr (STREAM) {
      constexpr int wv = kCols / 4;
      const uint32_t wbase = s0 + L.stage_off + (it & 1) * L.stage_bytes +
                             L.w_raw_off;
      for (int i = tid; i < kFwSlice * wv; i += kThreads) {
        const int kr = i / wv, v = i - kr * wv;
        const int k = k0 + kr, n = n0 + v * 4;
        const bool ok = k < a.K && n < a.N;
        cp_async16(wbase + (kr * kCols + v * 4) * 4,
                   ok ? a.w + (long long)k * a.ldw + n : a.w, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  issue(0);

  // W's depths kd, kd + 1 of column cl split into the three planes: plane
  // p's column cl, depth kd at p * w_plane + ((cl / 8) * ng + kd / 8) * 128
  // + (cl % 8) * 16 + (kd % 8) * 2
  const auto put_w = [&](int kd, int cl, float v0, float v1) {
    uint32_t p1, p2, p3;
    split_pair(v0, v1, p1, p2, p3);
    unsigned char* p =
        smem + ((cl / 8) * ng + kd / 8) * 128 + (cl % 8) * 16 + (kd % 8) * 2;
    *reinterpret_cast<uint32_t*>(p) = p1;
    *reinterpret_cast<uint32_t*>(p + L.w_plane) = p2;
    *reinterpret_cast<uint32_t*>(p + 2 * L.w_plane) = p3;
  };
  if constexpr (!STREAM) {
    // the block's columns of W, all kp depths, split once (zero past K and
    // N): a thread two rows of four columns at a time, 16-byte loads, six
    // pairs of them in flight
    constexpr int wq = kCols / 4;
    const int quads = a.kp / 2 * wq;
    const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i0 = tid; i0 < quads; i0 += 6 * kThreads) {
      float4 v[6][2];
#pragma unroll
      for (int u = 0; u < 6; ++u) {
        const int i = i0 + u * kThreads;
        const int k = 2 * (i / wq), n = n0 + 4 * (i % wq);
        const bool ok = i < quads && n < a.N;
        const float* w = a.w + (long long)k * a.ldw + n;
        v[u][0] = ok && k < a.K ? __ldg(reinterpret_cast<const float4*>(w))
                                : z4;
        v[u][1] = ok && k + 1 < a.K
                      ? __ldg(reinterpret_cast<const float4*>(w + a.ldw))
                      : z4;
      }
#pragma unroll
      for (int u = 0; u < 6; ++u) {
        const int i = i0 + u * kThreads;
        if (i >= quads) break;
        const int k = 2 * (i / wq), cl = 4 * (i % wq);
        put_w(k, cl, v[u][0].x, v[u][1].x);
        put_w(k, cl + 1, v[u][0].y, v[u][1].y);
        put_w(k, cl + 2, v[u][0].z, v[u][1].z);
        put_w(k, cl + 3, v[u][0].w, v[u][1].w);
      }
    }
    __syncthreads();   // W's planes are whole
    // the second warpgroup starts about half a slice later, so that one's
    // loads, prologue and splits run while the other's products do
    if (wg) __nanosleep(2500);
  }

  // an item's barrier: the warpgroup's (its rows are its own; W's planes
  // are read only), or the block's where a slice of W streams
  const auto item_sync = [&]() {
    if constexpr (STREAM)
      __syncthreads();
    else
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  };
  const QuanConst qc = quan_const(QUANT ? a.bits : 0);
  const bool one = QUANT && a.bits >= 1 && a.bits <= 9;   // one plane
  // the prologue of one value: relu(x * inv + shift), then the quantizer
  const auto pro1 = [&](float x, float i, float h) {
    const float z = fmaxf(affine(x, i, h), 0.f);
    return QUANT ? quan(z, qc) : z;
  };
  // B of the k16 step at depth kd of W's planes, plane pw: every column
  // group, depth groups kd / 8, kd / 8 + 1
  const auto bdesc = [&](int pw, int kd) {
    return smem_desc(s0 + pw * L.w_plane + (kd / 8) * 128, 128, ng * 128);
  };

  float acc[4 * NT], part[4 * NT];   // part: a chunk's fragment
  for (int it = 0; it < items; ++it) {
    const int q = it / ns, sl = it - q * ns;
    const int m0 = (first + q * stride) * kFwRows, k0 = sl * kFwSlice;
    const int width = min(kFwSlice, a.kp - k0);   // depths of the slice
    // where the tile's rows lie in one ghost tile (every slice of #7's
    // apply, the ghost-BN step at r >= 16), the prologue runs on the
    // fragments in registers instead: this lane's [inv; shift] of its 16
    // fragment columns k0 + 16 j + 2 q4 (+ 1, + 8, + 9), fetched under the
    // wait (zero past K: a padded column's prologue is zero)
    const int tl = a.vstride ? m0 / (int)a.tile_rows : 0;
    const bool one_tile =
        !a.vstride || tl == (min(m0 + kFwRows, a.M) - 1) / (int)a.tile_rows;
    float2 fi[kFwSlice / 16][2], fs[kFwSlice / 16][2];
    if (one_tile) {
      const long long o = (long long)tl * a.vstride + k0 + 2 * q4;
#pragma unroll
      for (int j = 0; j < kFwSlice / 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = k0 + 16 * j + 8 * h + 2 * q4;
          const bool in = 16 * j < width && k < a.K;
          fi[j][h] = in ? *reinterpret_cast<const float2*>(a.inv + o + 16 * j +
                                                           8 * h)
                        : make_float2(0.f, 0.f);
          fs[j][h] = in ? *reinterpret_cast<const float2*>(a.shift + o +
                                                           16 * j + 8 * h)
                        : make_float2(-1.f, -1.f);   // relu(0 * 0 - 1) = 0
        }
    }
    cp_async_wait<0>();
    item_sync();   // item it landed; item it-1 is done
    if (it + 1 < items) issue(it + 1);
    float* xs = reinterpret_cast<float*>(smem + L.stage_off +
                                         (it & 1) * L.stage_bytes);
    if constexpr (STREAM) {
      const float* wr = xs + L.w_raw_off / 4;
      for (int i = tid; i < kFwSlice / 2 * kCols; i += kThreads) {
        const int cl = i % kCols, kr = 2 * (i / kCols);
        put_w(kr, cl, wr[kr * kCols + cl], wr[(kr + 1) * kCols + cl]);
      }
    }

    // else the prologue on the warp's 16 rows, in place, once an element,
    // each row with its own ghost tile's [inv; shift]: lane l's columns
    // k0 + 4 (l % 16) .. +4 of rows R0 + l / 16, + 2, ..., its vectors held
    // for the rows below hi (rows ascend)
    const int pk = k0 + 4 * (lane & 15);
    if (!one_tile && pk - k0 < width && pk < a.K) {
      const int pr = m0 + R0 + (lane >> 4);
      long long hi = 0;
      float4 vi = make_float4(0.f, 0.f, 0.f, 0.f), vs = vi;
      float* const x0 = xs + (pr - m0) * kFwXS + pk - k0;   // row pr
      float4 xr[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (pr + 2 * i < a.M)
          xr[i] = *reinterpret_cast<const float4*>(x0 + 2 * i * kFwXS);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = pr + 2 * i;
        if (m < a.M) {
          if (m >= hi) {
            const int t = m / (int)a.tile_rows;
            hi = (long long)(t + 1) * a.tile_rows;
            const long long o = (long long)t * a.vstride + pk;
            vi = *reinterpret_cast<const float4*>(a.inv + o);
            vs = *reinterpret_cast<const float4*>(a.shift + o);
          }
          const float4 x = xr[i];
          *reinterpret_cast<float4*>(x0 + 2 * i * kFwXS) =
              make_float4(pro1(x.x, vi.x, vs.x), pro1(x.y, vi.y, vs.y),
                          pro1(x.z, vi.z, vs.z), pro1(x.w, vi.w, vs.w));
        }
      }
    }
    if constexpr (STREAM)
      __syncthreads();   // the slice of W's planes is whole
    else
      __syncwarp();

    // each 32-deep chunk: the A planes of its two k16 steps from the
    // staged float32 pairs, then per step W planes 3, 2, 1, each with the
    // x planes that keep i + j <= 4, by wgmma into a fragment from zero,
    // which joins acc by one float32 add
    if (sl == 0) {
#pragma unroll
      for (int e = 0; e < 4 * NT; ++e) acc[e] = 0.f;
    }
    const float* d0 = xs + (R0 + g) * kFwXS + 2 * q4;
    const float* d1 = d0 + 8 * kFwXS;
    const int kb = STREAM ? 0 : k0;   // the slice's first depth in W's planes
    const auto pro2 = [&](float2 x, float2 i, float2 h) {
      return make_float2(pro1(x.x, i.x, h.x), pro1(x.y, i.y, h.y));
    };
    const auto split_a = [&](int kk, uint32_t (&A)[3][4]) {
      float2 v0 = *reinterpret_cast<const float2*>(d0 + kk);
      float2 v1 = *reinterpret_cast<const float2*>(d1 + kk);
      float2 v2 = *reinterpret_cast<const float2*>(d0 + kk + 8);
      float2 v3 = *reinterpret_cast<const float2*>(d1 + kk + 8);
      if (one_tile) {
        const int j = kk / 16;
        v0 = pro2(v0, fi[j][0], fs[j][0]);
        v1 = pro2(v1, fi[j][0], fs[j][0]);
        v2 = pro2(v2, fi[j][1], fs[j][1]);
        v3 = pro2(v3, fi[j][1], fs[j][1]);
      }
      if (one) {
        A[0][0] = pack_rn(v0.x, v0.y);
        A[0][1] = pack_rn(v1.x, v1.y);
        A[0][2] = pack_rn(v2.x, v2.y);
        A[0][3] = pack_rn(v3.x, v3.y);
#pragma unroll
        for (int i = 0; i < 4; ++i) A[1][i] = A[2][i] = 0u;
      } else {
        split_pair(v0.x, v0.y, A[0][0], A[1][0], A[2][0]);
        split_pair(v1.x, v1.y, A[0][1], A[1][1], A[2][1]);
        split_pair(v2.x, v2.y, A[0][2], A[1][2], A[2][2]);
        split_pair(v3.x, v3.y, A[0][3], A[1][3], A[2][3]);
      }
      // the planes are whole before the products read them: none of
      // their arithmetic moves past the fence
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i) keep(A[p][i]);
    };
    // the six steps of a k16 (plane_x, plane_w); with one plane of codes
    // those of x1. The chunk's first product writes the fragment (wgmma's
    // scale-d 0: from zero), the others add to it.
    const auto k16 = [&](int kd, const uint32_t (&A)[3][4], bool first) {
#pragma unroll
      for (int s = 0; s < 6; ++s)
        if (!one || !plane_x(s))
          Wgmma<NT>::mma(part, A[plane_x(s)], bdesc(plane_w(s), kd),
                         !(first && s == 0));
    };
#pragma unroll
    for (int c0 = 0; c0 < kFwSlice; c0 += kFwChunk) {
      if (c0 >= width) break;
      uint32_t A0[3][4], A1[3][4];
      split_a(c0, A0);
      split_a(c0 + 16, A1);
      wgmma_fence();
      k16(kb + c0, A0, true);
      k16(kb + c0 + 16, A1, false);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 4 * NT; ++e) {
        keep(part[e]);
        acc[e] = __fadd_rn(acc[e], part[e]);
      }
    }
    if (sl < ns - 1) continue;

    // epilogue: an even lane takes row g, columns 2q .. 2q+3 of each n8
    // tile, an odd lane row g+8, columns 2(q-1) ..; one 16-byte store
    const long long m = m0 + R0 + g + (odd ? 8 : 0);
    float* orow = m >= a.M           ? nullptr
                  : a.out.img_stride ? out_row(a.out, m)
                                     : a.out.ptr + m * a.out.ld;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* c = acc + 4 * j;
      const float t0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
      const float t1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
      const int n = n0 + 8 * j + 2 * (q4 & 2);
      if (orow && n < a.N)
        *reinterpret_cast<float4*>(orow + n) =
            odd ? make_float4(t0, t1, c[2], c[3])
                : make_float4(c[0], c[1], t0, t1);
    }
  }
}

template <int NT>
void (*fw3_instance(bool stream, bool quant))(FwArgs) {
  if (quant)
    return stream ? fw3_kernel<NT, true, true> : fw3_kernel<NT, false, true>;
  return stream ? fw3_kernel<NT, true, false> : fw3_kernel<NT, false, false>;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// The float32 forward 1x1 over G feature groups (feats, their row strides
// lds and widths, as cunet_table_dot_f32 takes them; past 16 groups ext is
// the caller's device memory for the table, buf_ops.group_table): M rows,
// the prologue's vectors (inv, shift, vstride, tile_rows as
// buf_ops._vec_args gives them), QuanInput's bits (0: none), w (>= K, N)
// at row stride ldw as it lies, out an (M, N) view or an image-major one
// (ldo, rows_per_img, img_stride as in cunet_table_dot_f32). The plan's
// (buf_ops.fwd_f32_plan): nt n8 tiles a column block, nkb column blocks,
// stream, ``smem`` bytes (checked against the kernel's layout).
int cunet_fwd_f32(const void* const* feats, const long long* lds,
                  const int* widths, int G, void* ext, long long M,
                  const void* inv, const void* shift, long long vstride,
                  long long tile_rows, int bits, const void* w, long long ldw,
                  int N, void* out, long long ldo, long long rows_per_img,
                  long long img_stride, int nt, int nkb, int stream, int smem,
                  void* st) {
  bool ok = G >= 1 && M >= 1 && M <= 0x7fffffff && N >= 4 && N % 4 == 0 &&
            ldw % 4 == 0 && ldo % 4 == 0 && img_stride % 4 == 0 &&
            rows_per_img >= 1 && vstride >= 0 && vstride % 4 == 0 &&
            tile_rows >= 1 && bits >= 0 && bits <= 15 && nkb >= 1 &&
            (nt == 2 || nt == 4 || nt == 8 || nt == 16) &&
            nkb * 8 * nt >= N && (nkb - 1) * 8 * nt < N && aligned16(w) &&
            aligned16(out) && aligned16(inv) && aligned16(shift);
  for (int g = 0; ok && g < G; ++g)
    ok = widths[g] > 0 && widths[g] % 4 == 0 && lds[g] % 4 == 0 &&
         aligned16(feats[g]);
  if (!ok) return (int)cudaErrorInvalidValue;
  const auto cs = static_cast<cudaStream_t>(st);
  FwArgs a;
  const std::vector<int> ups(G, 0);   // no group is upsampled here
  const cudaError_t e =
      set_groups<float>(a.t, feats, lds, widths, ups.data(), G, ext, cs);
  if (e != cudaSuccess) return (int)e;
  a.inv = static_cast<const float*>(inv);
  a.shift = static_cast<const float*>(shift);
  a.vstride = vstride;
  a.tile_rows = tile_rows;
  a.bits = bits;
  a.w = static_cast<const float*>(w);
  a.ldw = ldw;
  a.out = OutViewOf<float>{static_cast<float*>(out), ldo, rows_per_img,
                           img_stride};
  a.M = (int)M;
  a.N = N;
  a.K = a.t.K;
  a.kp = (a.K + kFwChunk - 1) / kFwChunk * kFwChunk;
  a.nkb = nkb;
  a.L = fw_layout(a.kp, 8 * nt, stream != 0);
  if (a.L.bytes != smem) return (int)cudaErrorInvalidValue;
  void (*kern)(FwArgs) = nullptr;
  switch (nt) {
    case 2: kern = fw3_instance<2>(stream, bits != 0); break;
    case 4: kern = fw3_instance<4>(stream, bits != 0); break;
    case 8: kern = fw3_instance<8>(stream, bits != 0); break;
    case 16: kern = fw3_instance<16>(stream, bits != 0); break;
  }
  const int items = (int)((M + kFwRows - 1) / kFwRows) * nkb;
  int grid = 0;
  const int pe = persistent_grid(kern, items, kThreads, smem, nkb, &grid);
  if (pe) return pe;
  kern<<<grid, kThreads, smem, cs>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
