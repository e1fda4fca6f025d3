"""Low-bit matrix product of the plain int8 inference path, on a Hopper
kernel (counterpart of ``cunet_tpu/kernels/quant_matmul.py``).

Binarized weights are ``sign(w) * m`` with one scale per output filter, so
they are stored as int8 signs with ``m`` as a per-column epilogue scale;
WAGE activations ``round(x * 2^(b-1)) / 2^(b-1)`` are stored as their int8
integer part with one static scale. ``int8_matmul_dequant`` computes
``(x_i8 @ w_i8) * col_scale * x_scale`` with int32 accumulation.

On a CPU tensor the wrapper computes the plain PyTorch version; on a CUDA
tensor it launches the kernel or raises. ``int8_matmul_dequant.launches``
counts the kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from cunet_tpu_torch.kernels import build
from cunet_tpu_torch.quant.wage import quant_q, scale_s

# float32 holds every partial sum of up to this many products of int8
# values (|a * b| <= 2^14) exactly: 1024 * 2^14 = 2^24
_EXACT_F32_DEPTH = (1 << 24) // (128 * 128)


def int_dot(a_i8: torch.Tensor, b_i8: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of (M, K) and (K, N) int8 matrices, the plain
    reference of every int8 kernel. float32 ``torch.matmul`` over chunks of
    at most 1024 along K: every product and partial sum is an integer below
    2^24, so each chunk is exact whatever the summation order (TF32 and
    bf16 reduced precision hold int8 operands exactly too); the chunks add
    up in int32."""
    acc = None
    for k0 in range(0, a_i8.shape[1], _EXACT_F32_DEPTH):
        part = (a_i8[:, k0:k0 + _EXACT_F32_DEPTH].float()
                @ b_i8[k0:k0 + _EXACT_F32_DEPTH].float()).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def _check_i8(t: torch.Tensor, name: str) -> None:
    """An int8 kernel operand: on the current CUDA device, unit column
    stride (the kernels take any width, row stride and alignment)."""
    if t.device.type != "cuda" or t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name} is on {t.device}, expected the current "
                         f"CUDA device")
    if t.dtype != torch.int8:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes int8")
    if t.dim() != 2 or t.stride(-1) != 1:
        raise ValueError(f"{name} must be 2-D with unit column stride, got "
                         f"shape {tuple(t.shape)} stride {t.stride()}")


def int8_matmul_dequant_plain(x_i8, w_i8, col_scale, x_scale, out):
    acc = int_dot(x_i8, w_i8).float()
    out.copy_(((acc * col_scale) * x_scale).to(out.dtype))
    return out


def int8_matmul_dequant(x_i8: torch.Tensor, w_i8: torch.Tensor,
                        col_scale: torch.Tensor,
                        x_scale: float) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) float32, scaled per column:
    ``(float(acc) * col_scale) * x_scale``, the JAX epilogue's order, so the
    result is bit-identical to it.

    Replaces ``cunet_tpu/kernels/quant_matmul.py::int8_matmul_dequant`` (TPU
    kernel #10). Design: 128-row block tiles over N (x is read once), 16-byte
    row loads (byte loads at a ragged K tail or an unaligned row), the
    16x16x16 int8 WMMA with int32 accumulators, a float32 epilogue in
    registers. M and K need not tile: the last row tile and the last
    reduction stage are masked in the kernel, where the TPU version fell
    back to a lax product. At the plain path's shapes (K <= 320, N = 128)
    it is bound by reading x and writing the float32 out (~60 int ops per
    byte), far from the card's int8 tensor rate.
    """
    m, k = x_i8.shape
    n = w_i8.shape[1]
    if w_i8.shape[0] != k or col_scale.shape != (n,):
        raise ValueError(f"int8_matmul_dequant shapes: x {tuple(x_i8.shape)}, "
                         f"w {tuple(w_i8.shape)}, col_scale "
                         f"{tuple(col_scale.shape)}")
    if x_i8.device.type == "cpu":
        out = torch.empty(m, n, dtype=torch.float32)
        return int8_matmul_dequant_plain(x_i8, w_i8, col_scale, x_scale, out)
    _check_i8(x_i8, "x")
    _check_i8(w_i8, "w")
    if col_scale.device != x_i8.device or col_scale.dtype != torch.float32 \
            or not col_scale.is_contiguous():
        raise ValueError("col_scale must be a contiguous float32 tensor on "
                         "x's device")
    out = torch.empty(m, n, device=x_i8.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x_i8.device).cuda_stream
    code = build.lib().cunet_int8_matmul_dequant(
        x_i8.data_ptr(), x_i8.stride(0), m, k, w_i8.data_ptr(),
        w_i8.stride(0), n, col_scale.data_ptr(), x_scale,
        out.data_ptr(), out.stride(0), stream)
    build.check(code, "int8_matmul_dequant")
    int8_matmul_dequant.launches += 1
    return out


int8_matmul_dequant.launches = 0


def q8(y: torch.Tensor, s: float) -> torch.Tensor:
    """int8 codes of the WAGE activation quantizer with scale ``s``:
    ``sign(c) * floor(|c| * s + 0.5)`` of ``c = clip(y, ±(1 - 1/s))``
    (``_q8`` of the int8 TPU kernel)."""
    d = 1.0 / s
    c = torch.clamp(y, -1.0 + d, 1.0 - d)
    return (torch.sign(c) * torch.floor(torch.abs(c) * s + 0.5)).to(
        torch.int8)


def quantize_activations_i8(x: torch.Tensor, bits_i: int = 8):
    """WAGE fixed-point activations -> (int8 codes, dequant scale 1/S),
    S = 2^(bits_i-1), so ``codes / S == Q(C(x, b), b)``."""
    if not 2 < bits_i <= 8:
        raise ValueError("int8 packing supports 3..8 activation bits")
    s = scale_s(bits_i)
    return q8(x, s), 1.0 / s


def pack_binarized_weight(w: torch.Tensor, bits_g: int = 8):
    """HWIO 1x1 conv weight -> (int8 signs (K, N), float32 per-column scale
    (N,)): the scale is the per-filter mean |w| quantized to bits_g."""
    if w.shape[0] != 1 or w.shape[1] != 1:
        raise ValueError(f"pack expects a 1x1 conv, got {tuple(w.shape)}")
    m = quant_q(w.abs().mean(dim=(0, 1, 2)), bits_g)
    return torch.sign(w[0, 0]).to(torch.int8), m.float()


def binarized_matmul_infer(x: torch.Tensor, w: torch.Tensor, *,
                           bits_i: int = 8, bits_g: int = 8) -> torch.Tensor:
    """Activations quantized to int8, the binarized 1x1 weight packed to
    signs and scales, one ``int8_matmul_dequant``. x (..., K) float, w
    (1, 1, K, N); returns (..., N) float32."""
    lead, k = x.shape[:-1], x.shape[-1]
    x_i8, x_scale = quantize_activations_i8(x.reshape(-1, k), bits_i)
    w_i8, col_scale = pack_binarized_weight(w, bits_g)
    out = int8_matmul_dequant(x_i8, w_i8, col_scale, x_scale)
    return out.reshape(*lead, w.shape[3])
