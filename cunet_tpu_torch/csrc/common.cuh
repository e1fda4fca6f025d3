// Pieces shared by the hand-written CUDA kernels of cunet_tpu_torch: 16-byte
// bf16 vectors, the output view, the epilogue codes and the upsample's row
// map, the BN prologue, QuanInput's quantizer, the exact three-way bf16
// split of a float32 value, and the 128-row WMMA tile layout of the
// feature-table, int8 and float32 product kernels.
// Included by every .cu file of this directory; each translation unit gets
// its own copy (anonymous namespace).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int BM = 128;        // output rows per block
constexpr int BK = 32;         // reduction depth per shared-memory stage
constexpr int kPad = 8;        // bf16 row padding of the smem tiles

// Output view: row m of an (M, N) result lands at
//   ptr + (m / rows_per_img) * img_stride + (m % rows_per_img) * ld.
// A plain 2-D view has rows_per_img == M; the head writes one slot of the
// (N, A, h, w, cls) output, whose images are img_stride apart. OutView is
// the bf16 one; the float32 forms (f32_kernels.cu) write an OutViewOf<float>.
template <typename T>
struct OutViewOf {
  T* ptr;
  long long ld;
  long long rows_per_img;
  long long img_stride;
};
typedef OutViewOf<bf16> OutView;

template <typename T>
__device__ __forceinline__ T* out_row(const OutViewOf<T>& o, long long m) {
  const long long img = m / o.rows_per_img;
  return o.ptr + img * o.img_stride + (m - img * o.rows_per_img) * o.ld;
}

// The epilogues of a product's output (table_dot and its float32 form):
// none, relu(. + b[n]) ("shift2"), relu(. * a[n] + b[n]) ("scale").
enum Epi { kEpiNone = 0, kEpiShift = 1, kEpiScale = 2 };

// Source row of output row m in a half-resolution group (2x nearest):
// output row m = (b*H + y)*W + x reads (b*(H/2) + y/2)*(W/2) + x/2.
__device__ __forceinline__ long long up_row(long long m, int H, int W) {
  const long long hw = (long long)H * W;
  const long long b = m / hw;
  const int rem = (int)(m - b * hw);
  const int y = rem / W, x = rem - (rem / W) * W;
  return (b * (H / 2) + y / 2) * (W / 2) + x / 2;
}

// The feature table of a concat-free product (table_dot and its float32
// form): groups 0 .. G-1, group g holding columns [off[g], off[g+1]) of
// the virtual concat. Up to kMaxGroups travel by value in the launch
// parameters (ptr, ld, off and the up bitmask of the table struct); a
// longer table (an up block's adapter reads order + 3 groups) lives in
// device memory at ``ext``: one row of kGroupCols int64 per group,
// [pointer, row stride, column offset, up flag], written by fill_groups on
// the launch's stream just before the product reads it. Both are searched
// for k the same way, so the groups' layout never changes what is summed,
// or in which order.
constexpr int kMaxGroups = 16;
constexpr int kGroupCols = 4;
constexpr int kFillRows = 64;   // groups a fill launch carries by value

struct GroupRows {
  long long v[kFillRows * kGroupCols];
};

__global__ void fill_groups_kernel(long long* __restrict__ dst,
                                   const __grid_constant__ GroupRows rows,
                                   int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = rows.v[i];
}

// Where column k of the virtual concat lives: the address of its row 0,
// the row stride, and whether its group is read through the 2x upsample.
template <typename T>
struct GroupRef {
  const T* col;
  long long ld;
  bool up;
};

// EXT (a template parameter, so a kernel over a table by value carries no
// code of the other kind): the table at t.ext, else the one by value.
template <bool EXT, typename T, typename Table>
__device__ __forceinline__ GroupRef<T> find_group(const Table& t, int k) {
  int g = 0;
  if constexpr (EXT) {
    while (g + 1 < t.G && k >= (int)t.ext[(g + 1) * kGroupCols + 2]) ++g;
    const long long* r = t.ext + g * kGroupCols;
    return {reinterpret_cast<const T*>(r[0]) + (k - (int)r[2]), r[1],
            r[3] != 0};
  } else {
    while (g + 1 < t.G && k >= t.off[g + 1]) ++g;
    return {t.ptr[g] + (k - t.off[g]), t.ld[g], ((t.up >> g) & 1) != 0};
  }
}

// The host side: the G groups (pointers, row strides, widths, up flags)
// into ``t``, by value when they fit, else into ``ext`` (G x kGroupCols
// int64 of device memory, the caller's) by fill launches on ``st``. Sets
// K, the concat's width; ``up`` is the bitmask of the flagged groups by
// value, or with ``ext`` nonzero when any group is flagged.
template <typename T, typename Table>
cudaError_t set_groups(Table& t, const void* const* feats,
                       const long long* lds, const int* widths,
                       const int* ups, int G, void* ext, cudaStream_t st) {
  if (G < 1 || (G > kMaxGroups && !ext)) return cudaErrorInvalidValue;
  t.G = G;
  t.up = 0;
  t.ext = nullptr;
  t.off[0] = 0;
  int off = 0;
  for (int g = 0; g < kMaxGroups; ++g) {
    const bool in = g < G && G <= kMaxGroups;
    t.ptr[g] = in ? static_cast<const T*>(feats[g]) : nullptr;
    t.ld[g] = in ? lds[g] : 0;
    t.off[g + 1] = t.off[g] + (in ? widths[g] : 0);
  }
  if (G <= kMaxGroups) {
    for (int g = 0; g < G; ++g) t.up |= ups[g] ? 1 << g : 0;
    t.K = t.off[G];
    return cudaSuccess;
  }
  auto* dev = static_cast<long long*>(ext);
  for (int g0 = 0; g0 < G; g0 += kFillRows) {
    const int ng = G - g0 < kFillRows ? G - g0 : kFillRows;
    GroupRows rows;
    for (int i = 0; i < ng; ++i) {
      const int g = g0 + i;
      long long* r = rows.v + i * kGroupCols;
      r[0] = reinterpret_cast<long long>(feats[g]);
      r[1] = lds[g];
      r[2] = off;
      r[3] = ups[g] != 0;
      off += widths[g];
      t.up |= ups[g] != 0;
    }
    fill_groups_kernel<<<1, 128, 0, st>>>(dev + (long long)g0 * kGroupCols,
                                          rows, ng * kGroupCols);
  }
  t.ext = dev;
  t.K = off;
  return cudaGetLastError();
}

// Eight bf16 values as one 16-byte vector (raw bits, so the union stays
// trivially constructible).
union Pack8 {
  uint4 v;
  unsigned short u[8];
};

__device__ __forceinline__ float lo(const Pack8& p, int t) {
  return __bfloat162float(__ushort_as_bfloat16(p.u[t]));
}

__device__ __forceinline__ unsigned short hi(float f) {
  return __bfloat16_as_ushort(__float2bfloat16(f));
}

// The BN affine x * a + b, rounded after the product and after the sum as
// the plain PyTorch versions' two elementwise ops round it: a contracted FMA
// would differ in the last bit, which flips a ReLU mask wherever the affine
// lands within an ulp of zero and moves a bf16 activation by one ulp.
__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

// f rounded to bf16 and back: the value a bf16 activation holds.
__device__ __forceinline__ float bf16r(float f) {
  return __bfloat162float(__float2bfloat16(f));
}

// The activation quantizer Q(C(x, bits), bits) of QuanInput (WAGE; the
// plain version is cunet_tpu_torch/quant/wage.py): clip to
// +-(1 - 2^-(bits-1)) for 3 <= bits <= 15 (+-1 for bits 1, 2), then sign
// (bits 1), round half away from zero (bits 2) or round(x * S) / S with
// S = 2^(bits-1). bits 0 or > 15: the identity. Every step is exact in f32
// for |x| <= 1 (S and 1/S are powers of two, so the plain version's
// division by S is this multiply by 1/S), so it agrees with the plain
// version bit for bit.
// QuanConst: the quantizer's constants for ``bits``, worked out once (a
// kernel's prologue applies it to every element, nine times an element in
// the implicit-GEMM conv).
struct QuanConst {
  int bits;
  float s, inv_s, lim;
};

__device__ __forceinline__ QuanConst quan_const(int bits) {
  QuanConst q;
  q.bits = bits <= 0 || bits > 15 ? 0 : bits;
  q.s = bits <= 2 ? 1.f : (float)(1 << (bits - 1));
  q.inv_s = __frcp_rn(q.s);
  q.lim = bits <= 2 ? 1.f : 1.f - q.inv_s;
  return q;
}

__device__ __forceinline__ float quan(float x, const QuanConst& q) {
  if (!q.bits) return x;
  x = fminf(fmaxf(x, -q.lim), q.lim);
  const float sgn = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  if (q.bits == 1) return sgn;
  const float y = __fmul_rn(fabsf(x), q.s);
  return __fmul_rn(__fmul_rn(sgn, floorf(__fadd_rn(y, 0.5f))), q.inv_s);
}

__device__ __forceinline__ float quan(float x, int bits) {
  return quan(x, quan_const(bits));
}

// The relu(BN) prologue of a GEMM operand: f32 affine, ReLU, one bf16
// rounding; with bits (QuanInput) the rounded value is quantized and
// rounded again (exact for bits <= 8).
__device__ __forceinline__ unsigned short act(float x, float a, float b,
                                              int bits) {
  const float z = fmaxf(affine(x, a, b), 0.f);
  return hi(bits ? quan(bf16r(z), bits) : z);
}

// act() on eight packed bf16 values; without a quantizer two at a time,
// one conversion instruction a pair, with the same bits.
__device__ __forceinline__ uint4 act8(uint4 in, const float (&a)[8],
                                      const float (&b)[8], int bits) {
  if (bits) {
    Pack8 i, o;
    i.v = in;
#pragma unroll
    for (int q = 0; q < 8; ++q) o.u[q] = act(lo(i, q), a[q], b[q], bits);
    return o.v;
  }
  const uint32_t w[4] = {in.x, in.y, in.z, in.w};
  uint32_t r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float x0 = __uint_as_float(w[j] << 16);
    const float x1 = __uint_as_float(w[j] & 0xffff0000u);
    const __nv_bfloat162 h = __floats2bfloat162_rn(
        fmaxf(affine(x0, a[2 * j], b[2 * j]), 0.f),
        fmaxf(affine(x1, a[2 * j + 1], b[2 * j + 1]), 0.f));
    r[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// v = p1 + p2 + p3, three bf16 pieces: p1 = bf16(v), p2 = bf16(v - p1),
// p3 = bf16(v - p1 - p2), each difference exact in float32 (exact for
// normal float32 v: v - p1 holds at most 16 significant bits, v - p1 - p2
// at most 8, which p3 holds exactly). The float32-accurate tensor-core
// products of bwd_reduce / bwd_dx and of the float32 forms sum plane
// products of these pieces.
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

// murmur3's fmix32 finalizer (the dropout masks' counter hash,
// cunet_tpu_torch/ops/dropmask.py).
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Tile shapes of the WMMA kernels (eval_kernels.cu's table_dot, the int8
// kernels of quant_kernels.cu): BM x BN per block, the 8 warps laid out
// WARPS_M x WARPS_N, each warp owning FM x FN 16x16 fragments.
template <int BN, int WARPS_N>
struct Tiles {
  static constexpr int WARPS_M = kWarps / WARPS_N;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int FM = WM / 16;
  static constexpr int FN = WN / 16;
  static_assert(FM >= 1 && FN >= 1, "tile too small for 16x16 fragments");
};

}  // namespace
