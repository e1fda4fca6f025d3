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
// bytes, which makes every global access a 16-byte vector.
//
// Each entry point launches on the stream it is given and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// K1 affine_dot:
//   out[m, n] = epi( sum_{k<K} bf16(relu(x[m,k]*inv[t,k] + shift[t,k])) W[k,n] )
// with t = m / tile_rows the ghost-BN tile of row m (train) or 0 (eval:
// tile_rows = M, one [inv; shift] pair). With bits > 0 the bf16 prologue
// value goes through the QuanInput quantizer (``quan``; the train head).
// ---------------------------------------------------------------------------
template <int BN, int WARPS_N, bool BIAS_RELU>
__global__ void __launch_bounds__(kThreads)
    affine_dot_kernel(const bf16* __restrict__ x, long long ldx, long long M,
                      int K, const float* __restrict__ inv,
                      const float* __restrict__ shift, long long vstride,
                      long long tile_rows, int bits,
                      const bf16* __restrict__ w, int ldw, int N,
                      const float* __restrict__ bias, OutView out) {
  using T = Tiles<BN, WARPS_N>;
  __shared__ Smem<BN, WARPS_N> s;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::FM][T::FN];
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile with the folded-BN + ReLU prologue in f32, rounded to bf16.
    for (int c = threadIdx.x; c < BM * BK / 8; c += kThreads) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const long long m = m0 + r;
      const int k = k0 + kc;
      Pack8 o;
      o.v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M && k < K) {
        Pack8 in;
        in.v = *reinterpret_cast<const uint4*>(x + m * ldx + k);
        const long long vo = (m / tile_rows) * vstride + k;
#pragma unroll
        for (int t = 0; t < 8; ++t)
          o.u[t] = act(lo(in, t), inv[vo + t], shift[vo + t], bits);
      }
      *reinterpret_cast<uint4*>(&s.a[r][kc]) = o.v;
    }
    load_b(s, w, ldw, k0, K, n0, N);
    __syncthreads();
    mma_stage(s, wm, wn, acc);
    __syncthreads();
  }
  store_tile<BN, WARPS_N, BIAS_RELU>(s, wm, wn, m0, n0, M, N, bias, out, acc);
}

// ---------------------------------------------------------------------------
// K2 conv3x3: SAME 3x3 conv of (B*H*W, C) rows as an implicit GEMM of depth
// 9*C against the HWIO weight viewed as (9*C, G). Zero padding is per image.
// With PRO, each in-image input vector first goes through the ghost-BN
// prologue relu(y*inv[t] + shift[t]) in f32 and is rounded to bf16 (t is the
// tile of the source row, which is the tile of the output row: a tile holds
// whole images); the padding stays zero. With bits > 0 the prologue value
// also goes through the QuanInput quantizer (the train forward's
// quan(relu(BN2)) before the 3x3 conv).
// ---------------------------------------------------------------------------
template <int BN, int WARPS_N, bool PRO>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const bf16* __restrict__ y, long long ldy, long long M,
                   int H, int W, int C, const bf16* __restrict__ w, int G,
                   const float* __restrict__ inv,
                   const float* __restrict__ shift, long long vstride,
                   long long tile_rows, int bits, OutView out) {
  using T = Tiles<BN, WARPS_N>;
  __shared__ Smem<BN, WARPS_N> s;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long hw = (long long)H * W;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::FM][T::FN];
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    for (int c0 = 0; c0 < C; c0 += BK) {
      for (int c = threadIdx.x; c < BM * BK / 8; c += kThreads) {
        const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
        const long long m = m0 + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m < M && c0 + kc < C) {
          const long long img = m / hw;
          const int p = (int)(m - img * hw);
          const int yy = p / W + dy, xx = p % W + dx;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
            const long long src = img * hw + (long long)yy * W + xx;
            v = *reinterpret_cast<const uint4*>(y + src * ldy + c0 + kc);
            if (PRO) {
              Pack8 in, o;
              in.v = v;
              const long long vo = (src / tile_rows) * vstride + c0 + kc;
#pragma unroll
              for (int t = 0; t < 8; ++t)
                o.u[t] = act(lo(in, t), inv[vo + t], shift[vo + t], bits);
              v = o.v;
            }
          }
        }
        *reinterpret_cast<uint4*>(&s.a[r][kc]) = v;
      }
      // weight rows tap*C + [c0, c0+BK), masked at C
      load_b(s, w + (long long)tap * C * G, G, c0, C, n0, G);
      __syncthreads();
      mma_stage(s, wm, wn, acc);
      __syncthreads();
    }
  }
  store_tile<BN, WARPS_N, false>(s, wm, wn, m0, n0, M, G, nullptr, out, acc);
}

// ---------------------------------------------------------------------------
// K3 maxpool2 / K4 upsample2: one thread per 8 channels of one pixel.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint4 max8(uint4 a, uint4 b) {
  Pack8 pa, pb, o;
  pa.v = a;
  pb.v = b;
#pragma unroll
  for (int t = 0; t < 8; ++t)
    o.u[t] = hi(fmaxf(lo(pa, t), lo(pb, t)));
  return o.v;
}

__global__ void __launch_bounds__(kThreads)
    maxpool2_kernel(const bf16* __restrict__ x, long long ldx,
                    bf16* __restrict__ o, long long ldo, int B, int H, int W,
                    int C) {
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
    const uint4 v00 = *reinterpret_cast<const uint4*>(x + r00 * ldx + c);
    const uint4 v01 = *reinterpret_cast<const uint4*>(x + (r00 + 1) * ldx + c);
    const uint4 v10 = *reinterpret_cast<const uint4*>(x + (r00 + W) * ldx + c);
    const uint4 v11 =
        *reinterpret_cast<const uint4*>(x + (r00 + W + 1) * ldx + c);
    *reinterpret_cast<uint4*>(o + ((b * Ho + oy) * Wo + ox) * ldo + c) =
        max8(max8(v00, v01), max8(v10, v11));
  }
}

__global__ void __launch_bounds__(kThreads)
    upsample2_kernel(const bf16* __restrict__ x, long long ldx,
                     bf16* __restrict__ o, long long ldo, int B, int H, int W,
                     int C) {
  const int cg = C / 8, Wo = 2 * W;
  const long long total = (long long)B * H * W * cg;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(idx % cg) * 8;
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

struct VecArgs {
  const float* inv;
  const float* shift;
  long long vstride;
  long long tile_rows;
  int bits;
};

template <int BN, int WARPS_N>
void launch_affine_dot(const bf16* x, long long ldx, long long M, int K,
                       VecArgs v, const bf16* w, int ldw, int N,
                       const float* bias, OutView out, cudaStream_t stream) {
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  if (bias)
    affine_dot_kernel<BN, WARPS_N, true><<<grid, kThreads, 0, stream>>>(
        x, ldx, M, K, v.inv, v.shift, v.vstride, v.tile_rows, v.bits, w, ldw,
        N, bias, out);
  else
    affine_dot_kernel<BN, WARPS_N, false><<<grid, kThreads, 0, stream>>>(
        x, ldx, M, K, v.inv, v.shift, v.vstride, v.tile_rows, v.bits, w, ldw,
        N, bias, out);
}

template <int BN, int WARPS_N>
void launch_conv3x3(const bf16* y, long long ldy, long long M, int H, int W,
                    int C, const bf16* w, int G, VecArgs v, OutView out,
                    cudaStream_t stream) {
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((G + BN - 1) / BN));
  if (v.inv)
    conv3x3_kernel<BN, WARPS_N, true><<<grid, kThreads, 0, stream>>>(
        y, ldy, M, H, W, C, w, G, v.inv, v.shift, v.vstride, v.tile_rows,
        v.bits, out);
  else
    conv3x3_kernel<BN, WARPS_N, false><<<grid, kThreads, 0, stream>>>(
        y, ldy, M, H, W, C, w, G, v.inv, v.shift, v.vstride, v.tile_rows,
        v.bits, out);
}

unsigned elementwise_blocks(long long total) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  return (unsigned)(blocks < (1LL << 20) ? (blocks > 0 ? blocks : 1)
                                         : (1LL << 20));
}

}  // namespace

extern "C" {

int cunet_affine_dot(const void* x, long long ldx, long long M, int K,
                     const void* inv, const void* shift, long long vstride,
                     long long tile_rows, int bits, const void* w, int ldw,
                     int N, const void* bias, void* out, long long ldo,
                     long long rows_per_img, long long img_stride,
                     void* stream) {
  const OutView ov{static_cast<bf16*>(out), ldo, rows_per_img, img_stride};
  const VecArgs v{static_cast<const float*>(inv),
                  static_cast<const float*>(shift), vstride, tile_rows, bits};
  const auto* xp = static_cast<const bf16*>(x);
  const auto* wp = static_cast<const bf16*>(w);
  const auto* bp = static_cast<const float*>(bias);
  const auto st = static_cast<cudaStream_t>(stream);
  if (N <= 16)
    launch_affine_dot<16, 1>(xp, ldx, M, K, v, wp, ldw, N, bp, ov, st);
  else if (N <= 32)
    launch_affine_dot<32, 2>(xp, ldx, M, K, v, wp, ldw, N, bp, ov, st);
  else if (N <= 64)
    launch_affine_dot<64, 2>(xp, ldx, M, K, v, wp, ldw, N, bp, ov, st);
  else
    launch_affine_dot<128, 2>(xp, ldx, M, K, v, wp, ldw, N, bp, ov, st);
  return (int)cudaGetLastError();
}

int cunet_conv3x3(const void* y, long long ldy, long long M, int H, int W,
                  int C, const void* w, int G, const void* inv,
                  const void* shift, long long vstride, long long tile_rows,
                  int bits, void* out, long long ldo, void* stream) {
  const OutView ov{static_cast<bf16*>(out), ldo, M, 0};
  const VecArgs v{static_cast<const float*>(inv),
                  static_cast<const float*>(shift), vstride, tile_rows, bits};
  const auto* yp = static_cast<const bf16*>(y);
  const auto* wp = static_cast<const bf16*>(w);
  const auto st = static_cast<cudaStream_t>(stream);
  if (G <= 16)
    launch_conv3x3<16, 1>(yp, ldy, M, H, W, C, wp, G, v, ov, st);
  else if (G <= 32)
    launch_conv3x3<32, 2>(yp, ldy, M, H, W, C, wp, G, v, ov, st);
  else if (G <= 64)
    launch_conv3x3<64, 2>(yp, ldy, M, H, W, C, wp, G, v, ov, st);
  else
    launch_conv3x3<128, 2>(yp, ldy, M, H, W, C, wp, G, v, ov, st);
  return (int)cudaGetLastError();
}

int cunet_maxpool2(const void* x, long long ldx, void* out, long long ldo,
                   int B, int H, int W, int C, void* stream) {
  const long long total = (long long)B * (H / 2) * (W / 2) * (C / 8);
  maxpool2_kernel<<<elementwise_blocks(total), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), ldx, static_cast<bf16*>(out), ldo, B, H, W,
      C);
  return (int)cudaGetLastError();
}

int cunet_upsample2(const void* x, long long ldx, void* out, long long ldo,
                    int B, int H, int W, int C, void* stream) {
  const long long total = (long long)B * H * W * (C / 8);
  upsample2_kernel<<<elementwise_blocks(total), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), ldx, static_cast<bf16*>(out), ldo, B, H, W,
      C);
  return (int)cudaGetLastError();
}

}  // extern "C"
