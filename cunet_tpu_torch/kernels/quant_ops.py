"""The int8 kernels of the quantized whole-model forward, each beside its
plain version, and the registry of all three int8 kernels.

Counterparts of the int8 branch of
``cunet_tpu/kernels/fused_model_buf.py::fused_model_buf_infer``: its
``_affine_dot_i8`` (with ``_q8``) and its int8 scatter 3x3 conv. The
wrappers read and write strided 2-D views of the channel-plane buffers of
:mod:`cunet_tpu_torch.kernels.model_buf`, as :mod:`buf_ops` does. On a CPU
tensor a wrapper computes the plain PyTorch version; on a CUDA tensor it
launches the kernel or raises. ``<wrapper>.launches`` counts the kernel
launches and nothing else.

Integer products with int32 accumulation are exact in any order, the
quantizer's scale S = 2^(bits_i-1) is a power of two (so scaling and
dequantizing are exact), and the BN affine rounds after the product and
after the sum in both versions: each kernel is bit-identical to its plain
version on the same operands.
"""

from __future__ import annotations

import torch

from cunet_tpu_torch.kernels import build
from cunet_tpu_torch.kernels.buf_ops import (
    _check_vec,
    _check_view,
    _rows,
    _stream,
    tile_affine,
)
from cunet_tpu_torch.kernels.quant_matmul import (
    _check_i8,
    int8_matmul_dequant,
    int8_matmul_dequant_plain,
    int_dot,
    q8,
)


# ---------------------------------------------------------------------------
# affine_dot_i8
# ---------------------------------------------------------------------------


def affine_dot_i8_plain(x, vec, w_i8, out, s, vec2=None):
    k = x.shape[1]
    codes = q8(torch.relu(tile_affine(x, vec)), s)
    y = int_dot(codes, w_i8[:k]).float() * (1.0 / s)
    if vec2 is not None:
        out.copy_(q8(torch.relu(y * vec2[0] + vec2[1]), s))
    else:
        out.copy_(y.view(out.shape).to(out.dtype))
    return out


def affine_dot_i8(x, vec, w_i8, out, *, s: float, vec2=None):
    """``out = epi(q8(relu(x * vec[0] + vec[1])) @ w_i8[:K] / s)`` for x
    (M, K).

    The int8 BN-fold + ReLU + quantize + 1x1 conv of every bottleneck,
    adapter and head of the quantized model. ``vec`` is the (2, >=K)
    float32 [inv; shift] of an eval BN, ``w_i8`` the (>=K, N) int8 weight
    ({-1, 0, +1} after ``quant_eval_params``), ``s`` the quantizer scale
    2^(bits_i-1). Without ``vec2`` the dequantized float32 product goes to
    ``out`` (an (M, N) or image-major (B, P, N) bf16 view on the card). With
    ``vec2`` ((2, N) float32 [inv2; shift2], BN2 of a dense layer) the
    epilogue is ``q8(relu(y * inv2 + shift2))`` and ``out`` is an (M, N)
    int8 tensor: the 3x3 conv's input codes, from a float32 ``y`` that is
    never rounded to bf16 (as in the TPU kernel).

    Replaces ``cunet_tpu/kernels/fused_model_buf.py::_affine_dot_i8`` and
    ``_q8``. Bound on the H100 by reading x and writing out (K <= 320, N <=
    128), not by the int8 tensor cores. Design: the first, WMMA design of
    ``buf_ops.affine_dot`` (which that kernel has since left for
    persistent mma.sync blocks) with int8 operands: 128-row block tiles
    over N, the prologue (BN affine,
    ReLU, quantizer) in f32 registers between the 16-byte bf16 load and the
    int8 shared-memory tile, 16x16x16 int8 WMMA with int32 accumulators,
    the epilogue in f32 registers.
    """
    m, k = x.shape
    n = w_i8.shape[1]
    rows = _rows(out)[0]
    if rows != m or out.shape[-1] != n or w_i8.shape[0] < k \
            or (vec2 is not None and (out.dim() != 2 or vec2.shape != (2, n))):
        raise ValueError(f"affine_dot_i8 shapes: x {tuple(x.shape)}, vec "
                         f"{tuple(vec.shape)}, w {tuple(w_i8.shape)}, out "
                         f"{tuple(out.shape)}, vec2 "
                         f"{None if vec2 is None else tuple(vec2.shape)}")
    if vec.dim() != 2 or vec.shape[0] != 2 or vec.shape[1] < k:
        raise ValueError(f"vec must be one eval (2, >={k}) [inv; shift], got "
                         f"{tuple(vec.shape)}")
    if x.device.type == "cpu":
        return affine_dot_i8_plain(x, vec, w_i8, out, s, vec2)
    _check_view(x, "x")
    _check_i8(w_i8, "w")
    if not w_i8.is_contiguous():
        raise ValueError("w must be contiguous")
    _check_vec(vec, "vec", k)
    inv2 = shift2 = 0
    if vec2 is None:
        _check_view(out, "out")
    else:
        _check_i8(out, "out")
        _check_vec(vec2, "vec2", n)
        inv2, shift2 = vec2[0].data_ptr(), vec2[1].data_ptr()
    _, rows_per_img, img_stride, ldo = _rows(out)
    code = build.lib().cunet_affine_dot_i8(
        x.data_ptr(), x.stride(0), m, k, vec[0].data_ptr(), vec[1].data_ptr(),
        w_i8.data_ptr(), n, n, s, inv2, shift2,
        out.data_ptr(), ldo, rows_per_img, img_stride, _stream(x))
    build.check(code, "affine_dot_i8")
    affine_dot_i8.launches += 1
    return out


# ---------------------------------------------------------------------------
# conv3x3_i8
# ---------------------------------------------------------------------------


def conv3x3_i8_plain(y_i8, w3_i8, b, h, w, out, s):
    c, g = y_i8.shape[1], w3_i8.shape[1]
    yp = torch.nn.functional.pad(y_i8.reshape(b, h, w, c),
                                 (0, 0, 1, 1, 1, 1))
    acc = None
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        rows = yp[:, dy:dy + h, dx:dx + w].reshape(b * h * w, c)
        part = int_dot(rows, w3_i8[tap * c:(tap + 1) * c])
        acc = part if acc is None else acc + part
    out.copy_((acc.float() * (1.0 / s)).to(out.dtype))
    return out


def conv3x3_i8(y_i8, w3_i8, b, h, w, out, *, s: float):
    """3x3 SAME conv of the int8 codes ``y_i8`` (b*h*w, Cb) with the int8
    weight ``w3_i8`` ((9*Cb, G), ``buf_ops.pack_w3`` layout), int32
    accumulation, zero padding per image, dequantized by 1/s into ``out``
    (b*h*w, G) (bf16 on the card).

    Replaces the int8 scatter conv of
    ``cunet_tpu/kernels/fused_model_buf.py`` (:316-329, weights packed by
    ``fused_hourglass.py::pack_w3_scatter``): there one (m, Cb) @ (Cb, 9G)
    int8 dot and nine shifted f32 adds of dequantized taps; here one
    implicit GEMM of depth 9*Cb with int32 accumulation (the same sum, exact
    in both). Design: ``conv3x3``'s with int8 operands: each 128-row block
    gathers its shifted input rows tap by tap (16-byte loads, byte loads
    where Cb does not tile), masks the per-image border to zero and writes
    the bf16 result into the buffer's ``out32`` slot. Like ``conv3x3`` it is
    latency-bound at low resolution (a block walks 9*Cb/32 reduction stages
    in series).
    """
    m, c = y_i8.shape
    g = w3_i8.shape[1]
    if m != b * h * w or w3_i8.shape[0] != 9 * c \
            or tuple(out.shape) != (m, g):
        raise ValueError(f"conv3x3_i8 shapes: y {tuple(y_i8.shape)}, w "
                         f"{tuple(w3_i8.shape)}, out {tuple(out.shape)}, "
                         f"image {b}x{h}x{w}")
    if y_i8.device.type == "cpu":
        return conv3x3_i8_plain(y_i8, w3_i8, b, h, w, out, s)
    _check_i8(y_i8, "y")
    _check_i8(w3_i8, "w3")
    if not w3_i8.is_contiguous():
        raise ValueError("w3 must be contiguous")
    _check_view(out, "out")
    code = build.lib().cunet_conv3x3_i8(
        y_i8.data_ptr(), y_i8.stride(0), m, h, w, c, w3_i8.data_ptr(), g,
        s, out.data_ptr(), out.stride(0), _stream(y_i8))
    build.check(code, "conv3x3_i8")
    conv3x3_i8.launches += 1
    return out


KERNELS = (affine_dot_i8, conv3x3_i8, int8_matmul_dequant)
PLAIN = {affine_dot_i8: affine_dot_i8_plain, conv3x3_i8: conv3x3_i8_plain,
         int8_matmul_dequant: int8_matmul_dequant_plain}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


reset_launch_counts()
