// Hand-written Hopper kernel of the float32 activation gradient of a 1x1
// stage of the slot train step: affine_dx at float32 (cunet_tpu_torch/
// kernels/train_ops.py wraps it, plan train_ops.affine_dx_f32_plan),
//   out[m, k] = [z > 0 (and z < 1 with ste)] * sum_n dy[m, n] W[k, n],
//   z = x[m, k] * inv_t[k] + shift_t[k],
// with W the (K, N) float32 weight as it lies, x the stage input and t =
// m / tile_rows m's ghost-BN tile (an eval pair where vstride is 0). It
// replaces, at float32, _dot_dx (cunet_tpu/kernels/train_slot.py:541) with
// the ReLU mask of _affine_bwd and QuanInput's _ste_mask, which JAX runs as
// a float32 x float32 product at compute_dtype="float32".
//
// Arithmetic (f32_kernels.cu's, bit for bit its dot3_kernel on dy and
// W^T): dy and W are split exactly into three bf16 planes (split3), and
// each k16 step of the depth N adds the six plane products dy_i W_j with
// i + j <= 4 (1-based) in the order
//   dy1 W3, dy2 W2, dy1 W2, dy3 W1, dy2 W1, dy1 W1
// into the fragment of its 32-deep chunk, which starts from zero and joins
// the output's running sum by one round-to-nearest float32 add; the gate
// is common.cuh's affine() of the unrounded x, compared as the plain
// version compares it. The products run on wgmma, which gives mma.sync's
// (and WMMA's) bits for such chains (PERF.md section 6).
//
// What bounds it on the card: its bytes at the main path's shape (dy, x
// read once, the float32 output written once: 60.1 us at K=192 -> 128,
// r=64, batch 24); its six bf16 passes take 29.3 us at 989 TFLOP/s.
// Design:
// - Persistent blocks of two warpgroups, each block keeping one block of
//   kDx3Cols output columns: its W rows loaded once as they lie and split
//   once into three bf16 planes of core matrices in shared memory (8
//   columns x 8 depths, each column's N values along K: the K-major B
//   operand of a wgmma descriptor). The nkb blocks that keep the column
//   blocks of one row tile run side by side (block b keeps column block
//   b % nkb and walks row tiles b / nkb, + grid / nkb, ...), so dy comes
//   from HBM about once.
// - A tile's raw float32 dy rows and its x rows (the block's columns, for
//   the gate) arrive by cp.async into two buffers, the next tile's
//   loading while this one computes (a third buffer measured no faster,
//   PERF.md section 6); one barrier a tile. A cotangent wider than 128
//   arrives in slices of 128 depths, each an item of the pipeline with a
//   barrier of its own, the chunks of every slice joining one running sum
//   in ascending depth (the same order of sums); x comes with the tile's
//   last slice. Past kWideN (STREAM) W's planes come with each slice too
//   (halo.cuh split_w_slices), none resident.
// - Warpgroup wn owns the tile's 64 rows x 32 columns (wgmma m64n32k16),
//   its warp wm 16 rows: the dy fragments are read as float32 pairs from
//   the staged rows and split into their three planes in registers, two
//   values an instruction (halo.cuh split_pair): no plane buffer, no
//   second barrier; each dy element is split by the two warpgroups (a
//   departure from one split an element a block; PERF.md section 7.4
//   gives its cost).
// - The epilogue swaps halves within a lane pair (one shuffle a value), so
//   each lane holds four consecutive columns of one row, takes the gate of
//   those four from the staged x with its tile's inv / shift in registers
//   (reloaded where the ghost tile changes), and writes one 16-byte
//   float32 vector.
//
// The entry point launches on the stream it is given and returns
// cudaGetLastError().

#include "halo.cuh"

namespace {

constexpr int kDx3Rows = 64;   // rows of a tile
constexpr int kDx3Cols = 64;   // output columns of a block
constexpr int kDx3XS = kDx3Cols + 4;   // staged x row stride, floats

constexpr int kDx3Slice = 128;  // depths of a staged slice of dy

// The block's shared memory (train_ops.affine_dx_f32_plan computes the
// same): W's three planes (kDx3Cols x np bf16 in core matrices of 8
// columns x 8 depths, 128 bytes: column group cg, depth group ng at
// (cg * np / 8 + ng) * 128), then two buffers, each kDx3Rows dy rows of a
// slice of sw depths (sw + 8 floats; sw = np up to kDx3Slice) and
// kDx3Rows x rows (kDx3XS floats).
struct Dx3Layout {
  int w_plane;      // bytes of one W plane (0: W streamed)
  int stage_off;    // the first buffer
  int x_off;        // the x rows within a buffer
  int sw_off;       // the slice's W planes within a buffer (streamed W)
  int stage_bytes;  // bytes of a buffer
  int bytes;
};

inline int up128(int b) {
  return (b + 127) / 128 * 128;
}

// Past kWideN depths W's planes do not stay resident: each buffer also
// takes its slice of them (halo.cuh split_w_slices, core matrices, 3 x 16
// KB).
inline Dx3Layout dx3_layout(int np) {
  Dx3Layout l;
  const bool stream = np > kWideN;
  const int sw = np < kDx3Slice ? np : kDx3Slice;
  l.w_plane = stream ? 0 : kDx3Cols * np * 2;
  l.stage_off = up128(3 * l.w_plane);
  l.x_off = kDx3Rows * (sw + 8) * 4;
  l.sw_off = stream ? l.x_off + kDx3Rows * kDx3XS * 4 : 0;
  l.stage_bytes = up128(l.x_off + kDx3Rows * kDx3XS * 4 +
                        (stream ? 3 * kDx3Cols * kDx3Slice * 2 : 0));
  l.bytes = l.stage_off + 2 * l.stage_bytes;
  return l;
}

struct Dx3Args {
  const float* dy;
  long long ldd;
  const float* w;
  long long ldw;
  const float* x;
  long long ldx;
  const float* inv;
  const float* shift;
  long long vstride;
  long long tile_rows;
  float* out;
  long long ldo;
  int M, N, K;
  int np;        // N padded to 16
  int nkb;       // column blocks of kDx3Cols
  const bf16* ws;   // W's slice images (streamed W: halo.cuh split_w_slices)
  Dx3Layout L;
};

// NK: k16 steps of a slice (np / 16 where np <= kDx3Slice), so the
// product loop unrolls whole and the next step's loads and splits overlap
// this one's products. WIDE: np > kDx3Slice, walked in slices of
// kDx3Slice depths (NK = 8), the last one np - kDx3Slice * (ns - 1) deep;
// STREAM: np > kWideN, each slice's W planes staged with its dy.
template <int NK, bool STE, bool WIDE, bool STREAM = false>
__global__ void __launch_bounds__(kThreads, 1)
    dx3_kernel(const __grid_constant__ Dx3Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Dx3Layout& L = a.L;
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = (blockIdx.x % a.nkb) * kDx3Cols;
  const int tiles = (a.M + kDx3Rows - 1) / kDx3Rows;
  const int first = blockIdx.x / a.nkb, stride = gridDim.x / a.nkb;
  if (first >= tiles) return;
  constexpr int sw = 16 * NK;         // depths of a slice
  constexpr int ds = sw + 8;          // staged dy row stride, floats
  const int np = WIDE ? a.np : sw;
  const int ng = np / 8;              // depth groups of a W plane
  const int ns = WIDE ? (np + sw - 1) / sw : 1;   // slices of a tile
  const int items = ((tiles - 1 - first) / stride + 1) * ns;

  // item it (tile it / ns, slice it % ns): the slice's dy rows (zero past
  // N and M) and, with the tile's last slice, its x rows (zero past K and
  // M)
  const auto issue = [&](int it) {
    const int q = it / ns, sl = it - q * ns;
    const int m0 = (first + q * stride) * kDx3Rows, n0 = sl * sw;
    const uint32_t base = s0 + L.stage_off + (it & 1) * L.stage_bytes;
    constexpr int dv = sw / 4;
    for (int i = tid; i < kDx3Rows * dv; i += kThreads) {
      const int r = i / dv, v = i - r * dv;
      const bool ok = m0 + r < a.M && n0 + v * 4 < a.N;
      cp_async16(base + (r * ds + v * 4) * 4,
                 ok ? a.dy + (long long)(m0 + r) * a.ldd + n0 + v * 4 : a.dy,
                 ok ? 16 : 0);
    }
    if (sl == ns - 1) {
      constexpr int xv = kDx3Cols / 4;
      for (int i = tid; i < kDx3Rows * xv; i += kThreads) {
        const int r = i / xv, v = i - r * xv;
        const int k = k0 + v * 4;
        const bool ok = m0 + r < a.M && k < a.K;
        cp_async16(base + L.x_off + (r * kDx3XS + v * 4) * 4,
                   ok ? a.x + (long long)(m0 + r) * a.ldx + k : a.x,
                   ok ? 16 : 0);
      }
    }
    if (STREAM) {
      const bf16* src = a.ws + ((long long)(k0 / kDx3Cols) * ns + sl) * 3 *
                                   slice_plane(true);
      for (int i = tid; i < 3 * kDx3Cols * kDx3Slice / 8; i += kThreads)
        cp_async16(base + L.sw_off + i * 16, src + i * 8, 16);
    }
    cp_async_commit();
  };
  issue(0);

  // W's rows k0 .. k0 + kDx3Cols split once into three planes of core
  // matrices: plane p's row kl, depths n .. n + 4 at p * w_plane +
  // ((kl / 8) * ng + n / 8) * 128 + (kl % 8) * 16 + (n % 8) * 2, zero past
  // K and N (all np depths, every slice's)
  if (!STREAM) {
    const int wv = np / 4;
    for (int i = tid; i < kDx3Cols * wv; i += kThreads) {
      const int kl = i / wv, v = i - kl * wv;
      const int k = k0 + kl;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < a.K && v * 4 < a.N)
        val = *reinterpret_cast<const float4*>(a.w + (long long)k * a.ldw +
                                                v * 4);
      store_planes4(smem + ((kl / 8) * ng + v / 2) * 128 + (kl % 8) * 16 +
                        (v % 2) * 8,
                    L.w_plane, val, false);
    }
  }

  // warpgroup wn: columns wn*32 .. +32 (four n8 tiles); its warp wm: rows
  // wm*16 .. +16 (wgmma's accumulator layout: mma.sync's m16n8 per n8
  // tile)
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, q4 = lane & 3;
  const bool odd = q4 & 1;
  // B of the k16 step at depth kk, W plane pw: the core matrices of column
  // groups 4wn .. 4wn + 3, depth groups kk / 8, kk / 8 + 1 (streamed: of
  // the slice's planes in buffer b, kk within the slice)
  const auto bdesc = [&](int pw, int kk, int b) {
    return STREAM ? smem_desc(s0 + L.stage_off + b * L.stage_bytes +
                                  L.sw_off + pw * kDx3Cols * kDx3Slice * 2 +
                                  (4 * wn * (kDx3Slice / 8) + kk / 8) * 128,
                              128, kDx3Slice / 8 * 128)
                  : smem_desc(s0 + pw * L.w_plane +
                                  (4 * wn * ng + kk / 8) * 128,
                              128, ng * 128);
  };
  // the epilogue: this lane's row of the tile and its four columns of each
  // n8 tile j, kl0 + 8j .. +4
  const int er = wm * 16 + g + (odd ? 8 : 0);
  const int kl0 = wn * 32 + 2 * (q4 & 2);
  float4 gi[4], gsh[4];   // the gate's inv / shift of those columns
  long long vt = -1;      // their ghost tile

  float acc[16], part[16];
  for (int it = 0; it < items; ++it) {
    cp_async_wait<0>();
    __syncthreads();   // item it (and W's planes) landed; item it-1 is done
    if (it + 1 < items) issue(it + 1);
    const int q = it / ns, sl = it - q * ns;
    const int m0 = (first + q * stride) * kDx3Rows, n0 = sl * sw;
    const int width = WIDE ? min(sw, np - n0) : sw;   // depths of the slice
    const unsigned char* st = smem + L.stage_off + (it & 1) * L.stage_bytes;
    const float* d0 = reinterpret_cast<const float*>(st) +
                      (wm * 16 + g) * ds + 2 * q4;
    const float* d1 = d0 + 8 * ds;

    // each 32-deep chunk: the A planes of its two k16 steps from the
    // staged float32 dy pairs, then per step W planes 3, 2, 1, each with
    // the dy planes that keep i + j <= 4, by wgmma into a fragment from
    // zero, which joins acc by one float32 add
    if (sl == 0) {
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = 0.f;
    }
    const auto split_a = [&](int kk, uint32_t (&A)[3][4]) {
      const float2 v0 = *reinterpret_cast<const float2*>(d0 + kk);
      const float2 v1 = *reinterpret_cast<const float2*>(d1 + kk);
      const float2 v2 = *reinterpret_cast<const float2*>(d0 + kk + 8);
      const float2 v3 = *reinterpret_cast<const float2*>(d1 + kk + 8);
      split_pair(v0.x, v0.y, A[0][0], A[1][0], A[2][0]);
      split_pair(v1.x, v1.y, A[0][1], A[1][1], A[2][1]);
      split_pair(v2.x, v2.y, A[0][2], A[1][2], A[2][2]);
      split_pair(v3.x, v3.y, A[0][3], A[1][3], A[2][3]);
    };
    const auto k16 = [&](int kk, const uint32_t (&A)[3][4]) {
      const int kb = STREAM ? kk - n0 : kk, b = it & 1;
      wgmma_m64n32(part, A[0], bdesc(2, kb, b));
      wgmma_m64n32(part, A[1], bdesc(1, kb, b));
      wgmma_m64n32(part, A[0], bdesc(1, kb, b));
      wgmma_m64n32(part, A[2], bdesc(0, kb, b));
      wgmma_m64n32(part, A[1], bdesc(0, kb, b));
      wgmma_m64n32(part, A[0], bdesc(0, kb, b));
    };
#pragma unroll
    for (int c0 = 0; c0 < sw; c0 += 32) {
      if (WIDE && c0 >= width) break;
      uint32_t A0[3][4], A1[3][4];
      split_a(c0, A0);
      if (c0 + 16 < width) split_a(c0 + 16, A1);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        part[e] = 0.f;
        reg_fence(part[e]);
      }
      wgmma_fence();
      k16(n0 + c0, A0);
      if (c0 + 16 < width) k16(n0 + c0 + 16, A1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        reg_fence(part[e]);
        acc[e] = __fadd_rn(acc[e], part[e]);
      }
    }
    if (sl < ns - 1) continue;

    // epilogue: an even lane takes row g, columns 2q .. 2q+3 of each n8
    // tile, an odd lane row g+8, columns 2(q-1) ..; the gate from the
    // staged x, one 16-byte store
    const int m = m0 + er;
    const float* xr = reinterpret_cast<const float*>(st + L.x_off) +
                      er * kDx3XS + kl0;
    if (m < a.M) {
      const long long t = a.vstride ? m / a.tile_rows : 0;
      if (t != vt) {
        vt = t;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + kl0 + 8 * j;
          const long long o = t * a.vstride + (k < a.K ? k : 0);
          gi[j] = *reinterpret_cast<const float4*>(a.inv + o);
          gsh[j] = *reinterpret_cast<const float4*>(a.shift + o);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* c = acc + 4 * j;
      const float t0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
      const float t1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
      const int k = k0 + kl0 + 8 * j;
      if (m < a.M && k < a.K) {
        const float4 v = odd ? make_float4(t0, t1, c[2], c[3])
                             : make_float4(c[0], c[1], t0, t1);
        const float4 xv = *reinterpret_cast<const float4*>(xr + 8 * j);
        const float z[4] = {affine(xv.x, gi[j].x, gsh[j].x),
                            affine(xv.y, gi[j].y, gsh[j].y),
                            affine(xv.z, gi[j].z, gsh[j].z),
                            affine(xv.w, gi[j].w, gsh[j].w)};
        const float vv[4] = {v.x, v.y, v.z, v.w};
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[e] = z[e] > 0.f && (!STE || z[e] < 1.f) ? vv[e] : 0.f;
        *reinterpret_cast<float4*>(a.out + (long long)m * a.ldo + k) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
  }
}

}  // namespace

extern "C" {

// affine_dx's float32 form: dy (M, N) at row stride ldd, w (>= K, N) at
// row stride ldw as it lies, x (M, K) at ldx, the gate's per-tile vectors
// (inv, shift, vstride, tile_rows as buf_ops._vec_args gives them), out
// (M, K) at ldo; ste: QuanInput's straight-through gate too. The plan's
// (train_ops.affine_dx_f32_plan): nkb column blocks, np = N padded to 16,
// ``smem`` bytes (checked against the kernel's layout). Past kWideN W is
// split first into its slice images at ws (halo.cuh split_w_slices, core
// matrices; the caller's, nkb * ceil(N / 128) * 3 * 64 * 128 bf16).
int cunet_dx_f32(const void* dy, long long ldd, long long M, int N,
                 const void* w, long long ldw, int K, const void* x,
                 long long ldx, const void* inv, const void* shift,
                 long long vstride, long long tile_rows, int ste, void* out,
                 long long ldo, void* ws, int nkb, int np, int smem,
                 void* stream) {
  const Dx3Layout l = dx3_layout(np);
  const bool stream_w = np > kWideN;
  if (N % 4 || K % 4 || np % 16 || np < N || np - N >= 16 ||
      (stream_w && !ws) || vstride % 4 || tile_rows < 1 ||
      nkb * kDx3Cols < K || (nkb - 1) * kDx3Cols >= K || l.bytes != smem ||
      M > 0x7fffffff ||
      (reinterpret_cast<uintptr_t>(inv) | reinterpret_cast<uintptr_t>(shift)) &
          15)
    return (int)cudaErrorInvalidValue;
  Dx3Args a;
  a.dy = static_cast<const float*>(dy);
  a.ldd = ldd;
  a.w = static_cast<const float*>(w);
  a.ldw = ldw;
  a.x = static_cast<const float*>(x);
  a.ldx = ldx;
  a.inv = static_cast<const float*>(inv);
  a.shift = static_cast<const float*>(shift);
  a.vstride = vstride;
  a.tile_rows = tile_rows;
  a.out = static_cast<float*>(out);
  a.ldo = ldo;
  a.M = (int)M;
  a.N = N;
  a.K = K;
  a.np = np;
  a.nkb = nkb;
  a.ws = static_cast<const bf16*>(ws);
  a.L = l;
  const auto st = static_cast<cudaStream_t>(stream);
  if (stream_w) {
    const int e = split_w_slices(a.w, ldw, K, N, true,
                                 static_cast<bf16*>(ws), st);
    if (e) return e;
  }
  const int items = (int)((M + kDx3Rows - 1) / kDx3Rows) * nkb;
  void (*kern)(Dx3Args) = nullptr;
  if (stream_w) {
    kern = ste ? dx3_kernel<kDx3Slice / 16, true, true, true>
               : dx3_kernel<kDx3Slice / 16, false, true, true>;
  } else if (np > kDx3Slice) {
    kern = ste ? dx3_kernel<kDx3Slice / 16, true, true>
               : dx3_kernel<kDx3Slice / 16, false, true>;
  } else {
    switch (np / 16) {
#define CUNET_DX3(n)                                                      \
  case n:                                                                 \
    kern = ste ? dx3_kernel<n, true, false> : dx3_kernel<n, false, false>; \
    break;
      CUNET_DX3(1) CUNET_DX3(2) CUNET_DX3(3) CUNET_DX3(4) CUNET_DX3(5)
      CUNET_DX3(6) CUNET_DX3(7) CUNET_DX3(8)
#undef CUNET_DX3
    }
  }
  if (!kern) return (int)cudaErrorInvalidValue;
  int grid = 0;
  const int e = persistent_grid(kern, items, kThreads, smem, nkb, &grid);
  if (e) return e;
  kern<<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
