// Pieces shared by the tensor-core kernels: the three 3x3-conv kernels,
// conv3x3 (buf_kernels.cu), conv3x3_dx and conv3x3_dw (train_kernels.cu),
// #7's bwd_reduce and bwd_dx (bottleneck_kernels.cu; bwd_dx's float32
// form tb_dx_f32_kernels.cu), and the 1x1 kernels affine_dot
// (buf_kernels.cu; #7's apply is its table form), affine_dx and affine_dw
// and the BN backward bn_bwd (train_kernels.cu): asynchronous copies into
// shared memory (cp.async), ldmatrix loads of 8x8 bf16 tiles, the m16n8k16
// bf16 tensor-core product (mma.sync) and the warpgroup products (wgmma,
// m64n32 and m64n64 with A in registers), the exact three-plane bf16 split
// of float32 pairs that the float32 products (dw_f32_kernels.cu,
// dx_f32_kernels.cu, #7's float32 reduce and dx) feed them, a float32
// weight split into planes of core matrices, #7's BN recompute, the halo
// tile the conv kernels stage, #7's feature table and its chunks, and the
// launch of a persistent kernel.
//
// A halo tile holds rows [g0, g0 + rows) of an (M, C) bf16 channel-plane
// matrix, channels [c0, c0 + kc), at a row stride of kc + kHaloPad
// elements: 16 bytes more than the data, so the eight 16-byte rows that
// one ldmatrix tile reads fall in eight different bank groups whatever
// row they start at. For output rows [m0, m0 + bm) of an image-major
// (B, H, W) grid the tile starts at g0 = m0 - W - 1 and holds
// bm + 2W + 2 rows: every source row m + dy*W + dx of a 3x3 tap is then
// the tile row (m - m0) + W + 1 + dy*W + dx. A tap whose source lies
// outside the image (the SAME padding, and every border between two
// images flattened into one tile) reads a zero row instead: each lane of
// an ldmatrix gives its own row address, so the padding costs no
// branch in the product and no padded copy in memory. The 1x1 kernels
// stage their row tiles the same way, with no halo (g0 = m0).

#pragma once

#include "common.cuh"

namespace {

constexpr int kHaloPad = 8;   // bf16 elements of padding per halo row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros
// (src is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared, asynchronously (through L1); src_bytes 0
// writes zeros.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The same for a count known only at run time; above 7 it waits for 7 (more
// than asked, never less).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 sums.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b from a zero accumulator (m16n8k16, bf16 in, float32 out).
__device__ __forceinline__ void mma16816_z(float (&d)[4],
                                           const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// The fence, commit and wait of a warpgroup's wgmmas (Hopper's
// asynchronous warpgroup products, sm_90a); a register the compiler may
// not move across them, so an accumulator is read only after its wait.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Shared-memory writes of the threads (generic proxy: st.shared, a
// wgmma operand split in place) made visible to the wgmma that reads them
// through a descriptor (the async proxy); a barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The shared-memory descriptor of a K-major bf16 wgmma operand without
// swizzle: core matrices of 8 rows x 16 bytes (contiguous), ``lbo`` bytes
// apart along K and ``sbo`` bytes apart along M / N.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, int lbo,
                                              int sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d (64 x 32, this warp's 16 rows) += a (registers, 64 x 16) * B (smem
// descriptor, 16 x 32), bf16 in, float32 out.
__device__ __forceinline__ void wgmma_m64n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

// d (64 x 64) += a (registers, 64 x 16) * B (smem descriptor, 16 x 64),
// bf16 in, float32 out.
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

// The same with d's scale a run-time flag: acc = 0 takes d = a * B (the
// first product of a sum, with no zeroing of d: an instruction that writes
// an accumulator register between two wgmmas makes ptxas serialize them).
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32],
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// Two float32 values rounded to bf16 as one packed pair (cvt.rn.bf16x2),
// and the float32 values of its low and high halves.
__device__ __forceinline__ uint32_t pack_rn(float lo_v, float hi_v) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo_v, hi_v);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float low_half(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float high_half(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// The pair (a, b) split into its three packed bf16 planes: common.cuh's
// split3 on each value, two values an instruction (a in the low half: the
// lower column or depth index of an mma.sync fragment register).
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& p1,
                                           uint32_t& p2, uint32_t& p3) {
  p1 = pack_rn(a, b);
  const float ra = __fsub_rn(a, low_half(p1));
  const float rb = __fsub_rn(b, high_half(p1));
  p2 = pack_rn(ra, rb);
  p3 = pack_rn(__fsub_rn(ra, low_half(p2)), __fsub_rn(rb, high_half(p2)));
}

// Four float32 values into their three bf16 planes (8 bytes each, at p,
// p + plane, p + 2 plane). one: the first plane alone (a one-plane
// QuanInput operand).
__device__ __forceinline__ void store_planes4(unsigned char* p, int plane,
                                              const float4& v, bool one) {
  uint32_t w1[2], w2[2], w3[2];
  if (one) {
    w1[0] = pack_rn(v.x, v.y);
    w1[1] = pack_rn(v.z, v.w);
  } else {
    split_pair(v.x, v.y, w1[0], w2[0], w3[0]);
    split_pair(v.z, v.w, w1[1], w2[1], w3[1]);
  }
  *reinterpret_cast<uint2*>(p) = make_uint2(w1[0], w1[1]);
  if (one) return;
  *reinterpret_cast<uint2*>(p + plane) = make_uint2(w2[0], w2[1]);
  *reinterpret_cast<uint2*>(p + 2 * plane) = make_uint2(w3[0], w3[1]);
}

// W's rows c0 .. c0 + ROWS (float32 (Ctot, N)) split once into three
// bf16 planes of core matrices (8 columns x 8 outputs, 128 bytes): plane
// k's core matrix (cl / 8, n / 8) at k * wpl + ((cl / 8) * (np / 8) + n /
// 8) * 128, row cl % 8; zero past Ctot and N.
template <int ROWS>
__device__ __forceinline__ void split_w_cores(unsigned char* smem,
                                              const float* __restrict__ w,
                                              int Ctot, int N, int c0, int np,
                                              int tid, int nthr) {
  const int wpl = ROWS * np * 2, ng = np / 8;
  for (int i = tid; i < ROWS * np / 4; i += nthr) {
    const int cl = i / (np / 4), n = (i - cl * (np / 4)) * 4;
    const int c = c0 + cl;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < Ctot && n < N)
      v = *reinterpret_cast<const float4*>(w + (long long)c * N + n);
    store_planes4(smem + ((cl / 8) * ng + n / 8) * 128 + (cl % 8) * 16 +
                      (n % 8) * 2,
                  wpl, v, false);
  }
}

// A cotangent wider than kWideN (the widest whose W planes a block keeps
// resident) is walked in slices of kSliceN depths (outputs of the
// forward), and W's planes come a slice at a time from a pre-pass:
// split_w_slices_kernel splits the float32 W (K rows, N depths, row stride
// ldw) once into three bf16 planes, one image a (64-row block b, slice h)
// at element ((b * nsl + h) * 3 + plane) * slice_plane(CORE), laid out as
// the kernels stage it (the three planes of an image one contiguous
// copy): CORE, core matrices of 8 rows x 8 depths (row r, depth d at
// ((r / 8) * 16 + d / 8) * 64 + (r % 8) * 8 + d % 8, the K-major wgmma
// operand of split_w_cores), else rows of kSliceN + 8 (row r, depth d at
// r * (kSliceN + 8) + d, bwd_reduce's and bwd_dx's ldmatrix layout of
// split_w_planes); zero past K and N.
constexpr int kWideN = 256;
constexpr int kSliceN = 128;
constexpr int kSliceRows = 64;

__host__ __device__ constexpr int slice_plane(bool core) {   // elements
  return kSliceRows * (core ? kSliceN : kSliceN + 8);
}

template <bool CORE>
__global__ void __launch_bounds__(kThreads)
    split_w_slices_kernel(const float* __restrict__ w, long long ldw, int K,
                          int N, int nsl, bf16* __restrict__ wp) {
  constexpr int dg = CORE ? kSliceN / 8 : kSliceN / 8 + 1;   // depth groups
  const int nb = (K + kSliceRows - 1) / kSliceRows;
  const long long total = (long long)nb * nsl * kSliceRows * dg;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < total; i += (long long)gridDim.x * kThreads) {
    const int g = (int)(i % dg);
    const long long rest = i / dg;
    const int r = (int)(rest % kSliceRows);
    const long long bh = rest / kSliceRows;   // b * nsl + h
    const int h = (int)(bh % nsl), b = (int)(bh / nsl);
    const int k = b * kSliceRows + r, d0 = h * kSliceN + g * 8;
    Pack8 p1, p2, p3;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float v = k < K && g < kSliceN / 8 && d0 + e < N
                          ? w[(long long)k * ldw + d0 + e]
                          : 0.f;
      split3(v, p1.u[e], p2.u[e], p3.u[e]);
    }
    constexpr int pl = slice_plane(CORE);
    const long long img = bh * 3 * pl;
    const int o = CORE ? ((r / 8) * 16 + g) * 64 + (r % 8) * 8
                       : r * (kSliceN + 8) + g * 8;
    *reinterpret_cast<uint4*>(wp + img + o) = p1.v;
    *reinterpret_cast<uint4*>(wp + img + pl + o) = p2.v;
    *reinterpret_cast<uint4*>(wp + img + 2 * pl + o) = p3.v;
  }
}

// The pre-pass on the stream: W (K, N) at ldw into its slice images at wp
// (ceil(K / 64) * nsl * 3 * slice_plane(core) bf16, nsl = ceil(N /
// kSliceN)).
inline int split_w_slices(const float* w, long long ldw, int K, int N,
                          bool core, bf16* wp, cudaStream_t st) {
  const int nsl = (N + kSliceN - 1) / kSliceN;
  const long long nb = (K + kSliceRows - 1) / kSliceRows;
  const long long want =
      (nb * nsl * kSliceRows * (kSliceN / 8 + 1) + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < 1024 ? want : 1024);
  if (core)
    split_w_slices_kernel<true><<<blocks, kThreads, 0, st>>>(w, ldw, K, N,
                                                            nsl, wp);
  else
    split_w_slices_kernel<false><<<blocks, kThreads, 0, st>>>(w, ldw, K, N,
                                                             nsl, wp);
  return (int)cudaGetLastError();
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

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Issue the copies of a halo tile into shared memory at ``dst``: rows
// outside [0, M) are left unwritten (no valid tap reads them), channels at
// or past C are zero-filled (the k16 steps run over them).
__device__ __forceinline__ void load_halo(uint32_t dst,
                                          const bf16* __restrict__ x,
                                          long long ldx, int M, int C, int g0,
                                          int rows, int c0, int kc, int tid,
                                          int nthr) {
  const int vecs = kc / 8;
  const int stride = (kc + kHaloPad) * 2;
  const int r_lo = g0 < 0 ? -g0 : 0;
  const int r_hi = M - g0 < rows ? M - g0 : rows;
  const int n = (r_hi - r_lo) * vecs;
  for (int i = tid; i < n; i += nthr) {
    const int r = r_lo + i / vecs, v = i % vecs;
    const int c = c0 + v * 8;
    const bool ok = c < C;
    cp_async16(dst + r * stride + v * 16,
               ok ? x + (long long)(g0 + r) * ldx + c : x, ok ? 16 : 0);
  }
}

// The inv/shift values of one 8-channel vector for the rows [lo, hi) of
// one BN tile (lo = hi = 0: none yet), kept by a prologue thread from one
// call to the next.
struct VecCache {
  int lo, hi;
  float a[8], b[8];
};

// ``f`` on a landed halo tile, in place: every 8-channel vector of a row
// in [0, M) below channel C becomes f(v, inv[t, c..c+8], shift[t, c..c+8])
// with t the BN tile of its row, once per vector. Zero-filled channel
// padding stays zero. Each thread keeps one 8-channel vector and walks
// rows, so its inv/shift values are reloaded only where the BN tile
// changes; a caller that passes the same ``vc`` to every call of a thread
// keeps them across tiles too.
template <typename F>
__device__ __forceinline__ void halo_map(
    bf16* s, int M, int C, int g0, int rows, int c0, int kc,
    const float* __restrict__ inv, const float* __restrict__ shift,
    long long vstride, int tile_rows, int tid, int nthr, VecCache& vc,
    F f) {
  const int vecs = kc / 8;
  const int stripes = nthr / vecs;
  const int v = tid % vecs, r0 = tid / vecs;
  const int c = c0 + v * 8;
  if (r0 >= stripes || c >= C) return;
  const int r_lo = g0 < 0 ? -g0 : 0;
  const int r_hi = M - g0 < rows ? M - g0 : rows;
  for (int r = r_lo + r0; r < r_hi; r += stripes) {
    const int row = g0 + r;
    if (row < vc.lo || row >= vc.hi) {
      const int t = row / tile_rows;
      const long long vo = (long long)t * vstride + c;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        vc.a[q] = inv[vo + q];
        vc.b[q] = shift[vo + q];
      }
      vc.lo = t * tile_rows;
      vc.hi = vc.lo + tile_rows;
    }
    uint4* p = reinterpret_cast<uint4*>(s + r * (kc + kHaloPad) + v * 8);
    *p = f(*p, vc.a, vc.b);
  }
}

// The ghost-BN prologue on a landed halo tile, in place: every element of
// a row in [0, M) and a channel below C becomes
// act(x, inv[t, c], shift[t, c], bits) with t the BN tile of its row
// (halo_map).
__device__ __forceinline__ void halo_prologue(
    bf16* s, int M, int C, int g0, int rows, int c0, int kc,
    const float* __restrict__ inv, const float* __restrict__ shift,
    long long vstride, int tile_rows, int bits, int tid, int nthr,
    VecCache& vc) {
  halo_map(s, M, C, g0, rows, c0, kc, inv, shift, vstride, tile_rows, tid,
           nthr, vc,
           [bits](uint4 x, const float(&a)[8], const float(&b)[8]) {
             return act8(x, a, b, bits);
           });
}

__device__ __forceinline__ void halo_prologue(
    bf16* s, int M, int C, int g0, int rows, int c0, int kc,
    const float* __restrict__ inv, const float* __restrict__ shift,
    long long vstride, int tile_rows, int bits, int tid, int nthr) {
  VecCache vc;
  vc.lo = vc.hi = 0;
  halo_prologue(s, M, C, g0, rows, c0, kc, inv, shift, vstride, tile_rows,
                bits, tid, nthr, vc);
}

// The feature table of #7's kernels (bottleneck_kernels.cu, and apply's
// table form of affine_dot in buf_kernels.cu) in device memory: one row of
// kTblCols int64 per group, [x pointer, x row stride, width, column offset
// in the concat, dx pointer, dx row stride]. Widths and offsets are
// multiples of 8, so an 8-column chunk of the concat lies in one group.
constexpr int kTblCols = 6;

// The table row of the group holding concat column k: the last group whose
// offset is <= k.
__device__ __forceinline__ const long long* table_group(
    const long long* __restrict__ tbl, int G, int k) {
  int g = 0;
  while (g + 1 < G && k >= (int)tbl[(g + 1) * kTblCols + 3]) ++g;
  return tbl + g * kTblCols;
}

// An 8-column chunk of the concat resolved once: the byte address of its
// first element in row 0 (0 for a chunk at or past Ctot) and its row
// stride in elements. A block keeps its chunks in shared memory, so the
// row loop walks no table.
struct Chunk {
  long long ptr;
  long long ld;
};

// The chunk at concat column k, from the x columns (col 0) or the dx
// columns (col 4) of its group's table row; T the groups' element type.
template <typename T = bf16>
__device__ __forceinline__ Chunk table_chunk(const long long* __restrict__ tbl,
                                             int G, int Ctot, int k, int col) {
  if (k >= Ctot) return {0, 0};
  const long long* t = table_group(tbl, G, k);
  return {t[col] + (k - t[3]) * (long long)sizeof(T), t[col + 1]};
}

// load_halo over resolved chunks: rows [g0, g0 + rows) (g0 >= 0) of kc / 8
// chunks ``ch`` into shared memory at ``dst``, at a row stride of kc
// elements and 16 bytes (kHaloPad bf16, 4 float32); rows at or past M are
// left unwritten, chunks with no pointer are zero-filled. A float32 chunk
// is two 16-byte copies.
template <typename T = bf16>
__device__ __forceinline__ void load_chunks(uint32_t dst, const Chunk* ch,
                                            int M, int g0, int rows, int kc,
                                            int tid, int nthr) {
  if constexpr (sizeof(T) == 4) {
    const int vecs = kc / 4;
    const int stride = kc * 4 + 16;
    const int r_hi = M - g0 < rows ? M - g0 : rows;
    const char* any = reinterpret_cast<const char*>(ch[0].ptr);
    for (int i = tid; i < r_hi * vecs; i += nthr) {
      const int r = i / vecs, v = i - r * vecs;
      const Chunk c = ch[v >> 1];
      cp_async16(dst + r * stride + v * 16,
                 c.ptr ? reinterpret_cast<const char*>(c.ptr) +
                             ((long long)(g0 + r) * c.ld + (v & 1) * 4) * 4
                       : any,
                 c.ptr ? 16 : 0);
    }
    return;
  }
  const int vecs = kc / 8;
  const int stride = (kc + kHaloPad) * 2;
  const int r_hi = M - g0 < rows ? M - g0 : rows;
  const bf16* any = reinterpret_cast<const bf16*>(ch[0].ptr);
  for (int i = tid; i < r_hi * vecs; i += nthr) {
    const int r = i / vecs, v = i - r * vecs;
    const Chunk c = ch[v];
    cp_async16(dst + r * stride + v * 16,
               c.ptr ? reinterpret_cast<const bf16*>(c.ptr) +
                           (long long)(g0 + r) * c.ld
                     : any,
               c.ptr ? 16 : 0);
  }
}

// Row ``r`` (0 <= r < rows) of a tile starting at output row m0 seen
// through tap (dy, dx): the halo row it reads, or -1 where the source is
// outside its image or the row itself is not in [m0, row_end).
__device__ __forceinline__ int tap_row(int r, int yy, int xx, bool in_range,
                                       int dy, int dx, int H, int W) {
  const int sy = yy + dy, sx = xx + dx;
  if (!in_range || sy < 0 || sy >= H || sx < 0 || sx >= W) return -1;
  return r + W + 1 + dy * W + dx;
}

// The grid of a persistent kernel: as many blocks as fit on the card at
// once (never more than ``items``), cut down to a multiple of ``multiple``
// (a kernel whose blocks keep one of ``multiple`` column groups each).
// Returns a CUDA error code, 0 on success.
template <typename Kernel>
int persistent_grid(Kernel kern, int items, int threads, int smem,
                    int multiple, int* grid) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, nsm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  int g = items < per_sm * nsm ? items : per_sm * nsm;
  g -= g % multiple;
  *grid = g > 0 ? g : multiple;
  return 0;
}

// Launch a persistent kernel on at most as many blocks as fit on the card
// at once (never more than ``items``), with ``smem`` bytes of dynamic shared
// memory. The result does not depend on the grid: an item is computed the
// same way by whichever block takes it.
template <typename Kernel, typename... Args>
int launch_persistent(Kernel kern, int items, int threads, int smem,
                      cudaStream_t st, Args... args) {
  int grid = 0;
  const int e = persistent_grid(kern, items, threads, smem, 1, &grid);
  if (e) return e;
  kern<<<grid, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace
