// Hand-written Hopper kernel of the float32 weight gradients of the slot
// train step: affine_dw and conv3x3_dw at float32 (cunet_tpu_torch/
// kernels/train_ops.py wraps it, plan train_ops.dw_f32_plan), a reduction
// over the M rows,
//   part[p, r, n] = sum over run p's rows m of z(m, r) * dy[m, n]
// with z(m, r) = relu(x[src, c] * inv_t[c] + shift_t[c]) of the stage input
// x, t = m / tile_rows m's ghost-BN tile; 1x1 (R = C rows): c = r,
// src = m; 3x3 (R = 9C, tap-major): tap = r / C, c = r % C,
// src = m + dy*W + dx, zero where the tap leaves m's image (the SAME
// padding of the activation). With QuanInput's bits, z is quan(z, bits)
// of the unrounded float32 value (common.cuh's affine() and quan(), as
// the forward's prologue computes it). train_ops.sum_rows adds the runs'
// partials in order. It replaces, at float32, _dot_dw (cunet_tpu/kernels/
// train_slot.py:549) and the dW3 half of _conv3x3_bwd (:732), which JAX
// runs as float32 x float32 products at compute_dtype="float32".
//
// Arithmetic (f32_kernels.cu's): z and dy are split exactly into three
// bf16 planes (split3, two values an instruction), and each k16 row group
// adds the six plane products z_i dy_j with i + j <= 4 (1-based) in the
// order
//   z1 dy3, z2 dy2, z1 dy2, z3 dy1, z2 dy1, z1 dy1
// (QuanInput codes of bits <= 9 fill one bf16 plane: z1 dy3, z1 dy2, z1
// dy1) into a fragment that starts from zero (the tensor cores' float32
// accumulation truncates) and joins the running sum by one
// round-to-nearest float32 add on the CUDA cores. Runs, steps and the
// order of every sum depend on the shapes alone.
//
// What bounds it on the card: the 3x3 form six bf16 passes over its
// products (44.0 us at r=64, batch 24, Cb=128 -> 32, at 989 TFLOP/s), the
// 1x1 form its bytes (x and dy once: 37.6 us at K=192 -> 128). Design:
// - Block (p, cb, gz) owns run p of whole steps of br rows, the kc
//   channels cb and the ncol columns gz: 12 warps, one block an SM; the
//   1x1 form at N <= 32 (the heads) 6 warps, two blocks an SM, so that one
//   block's copies and conversion run under the other's products.
// - Raw float32 x and dy rows arrive by cp.async, ``stages`` (2 or 3)
//   buffers deep: the next steps load while this one computes.
// - Each staged x element gets its BN prologue (and quantizer) and its
//   three-plane split once, into a ring of z planes in shared memory; each
//   thread keeps the inv/shift of its 4 channels in registers across the
//   run and reloads them where the ghost tile changes. The 3x3 form's
//   ring holds the chunks of br rows that a step's nine taps read (the
//   image row above and below: ``halo`` chunks either side, one where W
//   divides br) and one more being filled; consecutive steps share their
//   overlap, so every x element is staged and split once a channel block,
//   not once a tap. dy is split once a block, into two plane buffers.
// - One barrier a step: its products read the ring slots and dy buffer
//   of step s while the conversion fills those of step s + 1; half the
//   warps convert first and half take their products first, so that one
//   half's conversion runs under the other's products.
// - The products: mma.sync m16n8k16, z^T and dy read by ldmatrix.trans
//   (plane rows of an odd number of 16-byte chunks: no bank conflicts).
//   3x3: warp (ky, ct) takes the three taps of kernel row ky for 16
//   channels and all NT n8 tiles, each tap's rows pointed per lane at its
//   ring row or a zero row (the padding costs no branch in the product);
//   1x1: warp (wc, wn) the channel tiles wc, wc + 3, wc + 6 for the NT n8
//   tiles of column group wn. The dy fragments serve the warp's three A
//   sources, each A fragment its NT tiles; the running sums stay in
//   registers (no spills: ptxas -v, PERF.md section 6).
// Each block writes one partial. On an H100 80GB HBM3 at 700 W (PERF.md
// section 6), with sum_rows: conv3x3_dw[f32] 158.5-158.6 us at r=64,
// batch 24 (conv2d_weight 351.2-353.4, the kernel before it 714.9),
// affine_dw[f32] 149.5-151.5 us at K=192 -> 128 (torch.mm of the product
// 108.3-109.1, before 236.6). What remains between them and their
// bounds: the copies, the conversion and the products of a step run in
// series within each warp (PERF.md section 6).
//
// The entry point launches on the stream it is given and returns
// cudaGetLastError().

#include "halo.cuh"

namespace {

// Bytes of a bf16 plane row of ``cols`` columns: an odd number of 16-byte
// chunks, so the eight rows of an ldmatrix tile fall in distinct banks.
inline int plane_stride(int cols) {
  const int v = cols / 8;
  return (v & 1 ? v : v + 1) * 16;
}

inline int up128(int b) {
  return (b + 127) / 128 * 128;
}

// The block's shared memory (train_ops.dw_f32_plan computes the same): the
// three z planes of the ring (slots * br rows, then a zero row), two
// buffers of three dy planes (br rows), then ``stages`` raw buffers, each
// br rows of kc float32 x and br rows of ncol float32 dy.
struct DwLayout {
  int xs, ds;          // plane row strides, bytes
  int ring_plane;      // bytes of one z plane
  int dy_plane;        // bytes of one dy plane
  int dy_off, raw_off;
  int raw_x, raw_bytes;
  int bytes;
};

inline DwLayout dw_layout(int br, int slots, int kc, int ncol, int stages) {
  DwLayout l;
  l.xs = plane_stride(kc);
  l.ds = plane_stride(ncol);
  l.ring_plane = (slots * br + 1) * l.xs;
  l.dy_plane = br * l.ds;
  l.dy_off = up128(3 * l.ring_plane);
  l.raw_off = l.dy_off + up128(6 * l.dy_plane);
  l.raw_x = br * kc * 4;
  l.raw_bytes = l.raw_x + br * ncol * 4;
  l.bytes = l.raw_off + stages * l.raw_bytes;
  return l;
}

struct DwArgs {
  const float* x;
  long long ldx;
  const float* inv;
  const float* shift;
  long long vstride;
  int tile_rows;
  int bits;            // QuanInput's quantizer on z (0: none)
  const float* dy;
  long long ldd;
  float* part;         // (runs, R, N) float32 partials
  int M, C, N;
  int H, W;            // the 3x3 form's images
  int run_rows;        // rows of a run: a multiple of br
  int br;              // rows a step
  int halo;            // chunks a step reads either side (1x1: 0)
  int slots;           // chunks the ring holds: 2 halo + 2
  DwLayout L;          // the shared memory (the host's, in the parameter
                       // space: no registers)
  int kc;              // channels a block: a multiple of 16
  int ncol;            // columns a block: WARPS / 3 column groups of NT n8
                       // tiles (1x1), NT n8 tiles (3x3)
  int stages;          // raw buffers: 2 or 3
};

// CONV: the 3x3 form; NT: n8 column tiles a warp; QUANT: the quantizer on
// z and its one-plane products (a template parameter, so an instance
// without it carries none of its code); WARPS: 12 (one block an SM) or 6
// (two blocks an SM).
template <bool CONV, int NT, bool QUANT, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 12 / WARPS)
    dw_f32_kernel(const __grid_constant__ DwArgs a) {
  constexpr int kBlockThreads = WARPS * 32;
  constexpr int kRows = WARPS / 3;   // 3x3: channel tiles; 1x1: column groups
  extern __shared__ __align__(128) unsigned char smem[];
  const int slots = a.slots;
  const DwLayout& L = a.L;
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.y * a.kc, n0 = blockIdx.z * a.ncol;
  const int r_begin = blockIdx.x * a.run_rows;
  const int r_end = a.M - r_begin < a.run_rows ? a.M : r_begin + a.run_rows;
  const int nsteps = (r_end - r_begin + a.br - 1) / a.br;
  // the ring: chunk c of the run (rows r_begin + c*br ..) sits in slot
  // (c + halo) mod slots, so row g at ring row (g - r_begin + halo*br) mod
  // cap; the zero row at cap
  const int cap = slots * a.br;
  // the rows a valid tap of this run reads
  const int lo = CONV ? max(0, r_begin - a.W - 1) : r_begin;
  const int hi = CONV ? min(a.M, r_end + a.W + 1) : r_end;
  // iteration it converts chunk it - halo and the dy rows of step
  // it - 2 halo, and computes step it - 1 - 2 halo
  const int iters = nsteps + 2 * a.halo;
  // QuanInput codes of bits <= 9 fill one bf16 plane
  const bool one = QUANT && a.bits >= 1 && a.bits <= 9;

  // the zero row of each z plane (a tap outside the image reads it)
  for (int i = tid; i < 3 * (L.xs / 16); i += kBlockThreads)
    *reinterpret_cast<uint4*>(smem + (i / (L.xs / 16)) * L.ring_plane +
                              cap * L.xs + (i % (L.xs / 16)) * 16) =
        make_uint4(0u, 0u, 0u, 0u);

  // Each thread copies and converts one 4-channel vector of x in every
  // xstripes-th row of a chunk, and one 4-column vector of dy in every
  // dstripes-th row of a step.
  const int xv = a.kc / 4, dv = a.ncol / 4;   // 16-byte vectors a row
  const int xstripes = kBlockThreads / xv, dstripes = kBlockThreads / dv;
  const int xvec = tid % xv, xr0 = tid / xv;
  const int dvec = tid % dv, dr0 = tid / dv;
  const int xc = c0 + xvec * 4, dn = n0 + dvec * 4;
  // Raw buffer it: x rows of chunk it - halo (zero where no valid tap
  // reads them), dy rows of step it - 2 halo (zero past the run; columns
  // at or past N, which no stored output reads, not copied).
  const auto fetch = [&](int it) {
    const uint32_t base = s0 + L.raw_off + (it % a.stages) * L.raw_bytes;
    const int gx = r_begin + (it - a.halo) * a.br;
    for (int r = xr0; r < a.br && xr0 < xstripes; r += xstripes) {
      const int g = gx + r;
      const bool ok = g >= lo && g < hi && xc < a.C;
      cp_async16(base + (r * xv + xvec) * 16,
                 ok ? a.x + (long long)g * a.ldx + xc : a.x, ok ? 16 : 0);
    }
    const int s = it - 2 * a.halo;
    if (s >= 0 && dn < a.N) {
      const int gd = r_begin + s * a.br;
      for (int r = dr0; r < a.br; r += dstripes) {
        const int g = gd + r;
        const bool ok = g < r_end;
        cp_async16(base + L.raw_x + (r * dv + dvec) * 16,
                   ok ? a.dy + (long long)g * a.ldd + dn : a.dy, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  // the prologue thread's BN vectors for the rows [vlo, vlo + tile_rows)
  // of one ghost tile, kept across the run (vlo -tile_rows: none yet)
  int vlo = -a.tile_rows;
  float4 va, vb;
  // Iteration it's rows of this thread: their prologue and split into the
  // ring slot of chunk it - halo, and the split of the dy rows of step
  // it - 2 halo. A thread reads a batch of its raw vectors before it
  // converts any (independent chains in flight); dy columns at or past N
  // are never stored, so they are not converted.
  constexpr int kBatch = 2;
  const auto convert = [&](int it) {
    const QuanConst qc = quan_const(QUANT ? a.bits : 0);   // z's quantizer
    const unsigned char* raw = smem + L.raw_off + (it % a.stages) *
                                                      L.raw_bytes;
    const int gx = r_begin + (it - a.halo) * a.br;
    unsigned char* ring = smem + (it % slots) * a.br * L.xs + xvec * 8;
    for (int r0 = xr0; r0 < a.br && xr0 < xstripes;
         r0 += kBatch * xstripes) {
      float4 xin[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int r = r0 + i * xstripes;
        if (r < a.br)
          xin[i] = *reinterpret_cast<const float4*>(raw +
                                                    (r * xv + xvec) * 16);
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int r = r0 + i * xstripes;
        if (r >= a.br) break;
        const int g = gx + r;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (g >= lo && g < hi && xc < a.C) {
          if (g < vlo || g >= vlo + a.tile_rows) {
            const int t = g / a.tile_rows;
            const long long o = (long long)t * a.vstride + xc;
            va = *reinterpret_cast<const float4*>(a.inv + o);
            vb = *reinterpret_cast<const float4*>(a.shift + o);
            vlo = t * a.tile_rows;
          }
          v.x = fmaxf(affine(xin[i].x, va.x, vb.x), 0.f);
          v.y = fmaxf(affine(xin[i].y, va.y, vb.y), 0.f);
          v.z = fmaxf(affine(xin[i].z, va.z, vb.z), 0.f);
          v.w = fmaxf(affine(xin[i].w, va.w, vb.w), 0.f);
          if constexpr (QUANT) {
            v.x = quan(v.x, qc);
            v.y = quan(v.y, qc);
            v.z = quan(v.z, qc);
            v.w = quan(v.w, qc);
          }
        }
        store_planes4(ring + r * L.xs, L.ring_plane, v, QUANT && one);
      }
    }
    const int s = it - 2 * a.halo;
    if (s < 0 || dn >= a.N) return;
    unsigned char* d = smem + L.dy_off + (s & 1) * 3 * L.dy_plane + dvec * 8;
    for (int r0 = dr0; r0 < a.br; r0 += kBatch * dstripes) {
      float4 din[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int r = r0 + i * dstripes;
        if (r < a.br)
          din[i] = *reinterpret_cast<const float4*>(
              raw + L.raw_x + (r * dv + dvec) * 16);
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int r = r0 + i * dstripes;
        if (r >= a.br) break;
        store_planes4(d + r * L.ds, L.dy_plane, din[i], false);
      }
    }
  };

  // The warp's three A sources and its columns. 3x3: kernel row ky, the
  // taps (ky, 0 .. 2) of channel tile ct; 1x1: channel tiles wc + 3t for
  // the NT n8 tiles of column group wn.
  const int ky = warp / kRows, ct = warp % kRows;
  const int wc = warp % 3, wn = warp / 3;
  const int ntile0 = CONV ? 0 : wn * NT;
  const int ktiles = a.kc / 16;
  bool on[3];
#pragma unroll
  for (int t = 0; t < 3; ++t) on[t] = CONV ? ct < ktiles : wc + 3 * t < ktiles;
  const bool busy = on[0] && n0 + ntile0 * 8 < a.N;

  float acc[3][NT][4];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;

  // ldmatrix.trans lane coordinates (train_kernels.cu's conv3x3_dw). z^T
  // (A): depth row (l & 7) + (mat >> 1) * 8, channel offset (mat & 1) * 8.
  // dy (B): depth row (mat & 1) * 8 + (l & 7), 16-byte column chunk
  // 2 * jp + (mat >> 1).
  const int mat = lane >> 3;
  const int a_row = (lane & 7) + (mat >> 1) * 8;
  const int a_ofs = (mat & 1) * 16;
  const int b_row = (mat & 1) * 8 + (lane & 7);
  const int hw = a.H * a.W;

  // One k16 row group of step s, source by source: its six plane
  // products, in the header's order, sum from zero in a fragment a tile,
  // which joins the running sum by one float32 add (round to nearest).
  const auto products = [&](int s, int kr) {
    const int m0 = r_begin + s * a.br;
    const uint32_t db = s0 + L.dy_off + (s & 1) * 3 * L.dy_plane;
    // dy planes 1, 2, 3 of the warp's NT tiles
    uint32_t b[3][NT][2];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const uint32_t bp = db + p * L.dy_plane + (kr + b_row) * L.ds;
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t t4[4];
        ldsm_x4_t(t4, bp + (ntile0 + 2 * jp + (mat >> 1)) * 16);
        b[p][2 * jp][0] = t4[0];
        b[p][2 * jp][1] = t4[1];
        b[p][2 * jp + 1][0] = t4[2];
        b[p][2 * jp + 1][1] = t4[3];
      }
      if (NT & 1)
        ldsm_x2_t(b[p][NT - 1][0], b[p][NT - 1][1],
                  bp + (ntile0 + NT - 1) * 16);
    }
    // the lane's A row m = m0 + kr + a_row sits at ring row q (step s's
    // chunk is in slot (s + halo) mod slots); per source the ring row it
    // reads, or the zero row at cap where a tap leaves m's image or m
    // its run
    const int m = m0 + kr + a_row;
    const int q = ((s + a.halo) % slots) * a.br + kr + a_row;
    int yy = 0, xx = 0;
    if constexpr (CONV) {
      const int pix = m % hw;
      yy = pix / a.W;
      xx = pix - yy * a.W;
    }
    const bool row_ok = m < r_end && yy + ky - 1 >= 0 && yy + ky - 1 < a.H;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      if (!on[t]) continue;
      int row = q;
      if constexpr (CONV) {
        int rr = q + (ky - 1) * a.W + t - 1;
        rr += rr < 0 ? cap : (rr >= cap ? -cap : 0);
        const bool ok = row_ok && xx + t - 1 >= 0 && xx + t - 1 < a.W;
        row = ok ? rr : cap;
      }
      const uint32_t ab =
          s0 + row * L.xs + a_ofs + (CONV ? ct : wc + 3 * t) * 32;
      float f[NT][4];
      uint32_t z1[4];
      ldsm_x4_t(z1, ab);
      if (QUANT && one) {
        // one z plane: z1 dy3, z1 dy2, z1 dy1
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma16816_z(f[j], z1, b[2][j][0], b[2][j][1]);
#pragma unroll
        for (int p = 1; p >= 0; --p)
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma16816(f[j], z1, b[p][j][0], b[p][j][1]);
      } else {
        uint32_t z2[4], z3[4];
        ldsm_x4_t(z2, ab + L.ring_plane);
        ldsm_x4_t(z3, ab + 2 * L.ring_plane);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma16816_z(f[j], z1, b[2][j][0], b[2][j][1]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma16816(f[j], z2, b[1][j][0], b[1][j][1]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma16816(f[j], z1, b[1][j][0], b[1][j][1]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma16816(f[j], z3, b[0][j][0], b[0][j][1]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma16816(f[j], z2, b[0][j][0], b[0][j][1]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma16816(f[j], z1, b[0][j][0], b[0][j][1]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[t][j][e] = __fadd_rn(acc[t][j][e], f[j][e]);
    }
  };

  // Half the warps convert first and half take their products first
  // (swapping every iteration), so that while one half keeps the tensor
  // cores busy the other converts.
  const int nk = a.br / 16;
  for (int it = 0; it < a.stages - 1 && it < iters; ++it) fetch(it);
  for (int it = 0; it <= iters; ++it) {
    if (it < iters) {
      const int fetched =
          iters < it + a.stages - 1 ? iters : it + a.stages - 1;
      cp_async_wait_upto(fetched - it - 1);
    }
    // raw buffer it landed; every warp is done with step it - 2 - 2 halo
    // (the ring slot and dy buffer converted now) and with the raw buffer
    // the copies below refill
    __syncthreads();
    if (it + a.stages - 1 < iters) fetch(it + a.stages - 1);
    const int s = it - 1 - 2 * a.halo;
    const bool first = ((2 * warp / WARPS + it) & 1) == 0;
    if (s >= 0 && busy) {
      if (first && it < iters) convert(it);
      for (int kk = 0; kk < nk; ++kk) products(s, kk * 16);
      if (!first && it < iters) convert(it);
    } else if (it < iters) {
      convert(it);
    }
  }

  if (!busy) return;
  const int R = CONV ? 9 * a.C : a.C;
  float* base = a.part + (long long)blockIdx.x * R * a.N;
  const int g = lane >> 2, q2 = 2 * (lane & 3);
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    if (!on[t]) continue;
    const int c = c0 + (CONV ? ct : wc + 3 * t) * 16 + g;
    const long long row = CONV ? (long long)(ky * 3 + t) * a.C + c : c;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + (ntile0 + j) * 8 + q2;
      if (n >= a.N) continue;
      if (c < a.C)
        *reinterpret_cast<float2*>(base + row * a.N + n) =
            make_float2(acc[t][j][0], acc[t][j][1]);
      if (c + 8 < a.C)
        *reinterpret_cast<float2*>(base + (row + 8) * a.N + n) =
            make_float2(acc[t][j][2], acc[t][j][3]);
    }
  }
}

template <bool CONV, int NT, bool QUANT, int WARPS>
int launch_dw(const DwArgs& a, int runs, int nkb, int ngrp, int smem,
              cudaStream_t st) {
  auto kern = dw_f32_kernel<CONV, NT, QUANT, WARPS>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(runs, nkb, ngrp), WARPS * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The instances: the 3x3 form on 12 warps at NT 1, 2, 4; the 1x1 form on
// 12 warps at NT 2, 4 (N past 32) and on 6 warps at NT 1, 2 (N up to 32).
template <bool QUANT>
int dw_forms(const DwArgs& a, int conv, int warps, int nt, int runs,
             int nkb, int ngrp, int smem, cudaStream_t st) {
#define CUNET_DW(c, n, w) \
  return launch_dw<c, n, QUANT, w>(a, runs, nkb, ngrp, smem, st)
  if (conv && warps == 12) {
    if (nt == 1) CUNET_DW(true, 1, 12);
    if (nt == 2) CUNET_DW(true, 2, 12);
    if (nt == 4) CUNET_DW(true, 4, 12);
  } else if (!conv && warps == 12) {
    if (nt == 2) CUNET_DW(false, 2, 12);
    if (nt == 4) CUNET_DW(false, 4, 12);
  } else if (!conv && warps == 6) {
    if (nt == 1) CUNET_DW(false, 1, 6);
    if (nt == 2) CUNET_DW(false, 2, 6);
  }
#undef CUNET_DW
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The float32 weight gradients: x (M, C) at row stride ldx, its per-tile
// vectors (inv, shift, vstride, tile_rows as buf_ops._vec_args gives
// them), dy (M, N) at row stride ldd; conv 0: the 1x1 stage's (C, N)
// gradient, conv 1: the 3x3 conv's packed (9C, N) one over images H x W;
// bits: QuanInput's quantizer on z. Writes ``runs`` float32 partials
// (runs, R, N) to ``part``. The rest is the plan's (train_ops.dw_f32_plan):
// ``warps`` a block, runs of ``run_rows`` rows in steps of ``br``,
// ``halo`` chunks either side, ``nkb`` channel blocks of ``kc``, ``ngrp``
// column groups of ``ncol`` (``nt`` n8 tiles a warp), ``stages`` raw
// buffers, ``smem`` bytes of shared memory (checked against the kernel's
// layout).
int cunet_dw_f32(const void* x, long long ldx, int M, int C, int H, int W,
                 int conv, const void* inv, const void* shift,
                 long long vstride, int tile_rows, int bits, const void* dy,
                 long long ldd, int N, void* part, int warps, int runs,
                 int run_rows, int br, int halo, int kc, int nkb, int ncol,
                 int ngrp, int nt, int stages, int smem, void* stream) {
  const DwLayout l = dw_layout(br, 2 * halo + 2, kc, ncol, stages);
  const int rows = warps / 3;
  if (C % 8 || N % 8 || vstride % 4 || tile_rows < 1 || br % 16 ||
      kc % 16 || (warps != 12 && warps != 6) ||
      kc > (conv ? 16 * rows : 144) || ncol != (conv ? 8 : 8 * rows) * nt ||
      stages < 2 || run_rows % br || (conv && (H < 1 || W < 1)) ||
      l.bytes != smem)
    return (int)cudaErrorInvalidValue;
  DwArgs a;
  a.x = static_cast<const float*>(x);
  a.ldx = ldx;
  a.inv = static_cast<const float*>(inv);
  a.shift = static_cast<const float*>(shift);
  a.vstride = vstride;
  a.tile_rows = tile_rows;
  a.bits = bits;
  a.dy = static_cast<const float*>(dy);
  a.ldd = ldd;
  a.part = static_cast<float*>(part);
  a.M = M;
  a.C = C;
  a.N = N;
  a.H = H;
  a.W = W;
  a.run_rows = run_rows;
  a.br = br;
  a.halo = halo;
  a.slots = 2 * halo + 2;
  a.L = l;
  a.kc = kc;
  a.ncol = ncol;
  a.stages = stages;
  const auto st = static_cast<cudaStream_t>(stream);
  return bits ? dw_forms<true>(a, conv, warps, nt, runs, nkb, ngrp, smem, st)
              : dw_forms<false>(a, conv, warps, nt, runs, nkb, ngrp, smem,
                                st);
}

}  // extern "C"
