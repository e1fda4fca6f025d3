"""WAGE-style quantization primitives and their straight-through gradients.

Counterpart of ``cunet_tpu/quant/wage.py``. Bit-widths are explicit
arguments. The three custom gradients of the JAX package
(``jax.custom_vjp``) are ``torch.autograd.Function``s here with the same
backward: ``quan_input`` (the activation quantizer, straight-through where
|x| < 1), ``fake_quant_weight`` (the XNOR jacobian for ``bits_w == 1``, else
straight-through, then the gradient quantized to ``bits_g``) and
``binarize_weight`` (the XNOR jacobian without the gradient quantization).
``sign`` and ``floor`` have zero gradients, so a value-only port would hand
every caller silent zero gradients.

Weight layout is HWIO, as in the JAX package: per-filter reductions are over
axes (0, 1, 2); the input-channel axis is 2.
"""

from __future__ import annotations

import torch

_FILTER_AXES = (0, 1, 2)  # HWIO: reduce over H, W, I -> per output filter


def scale_s(bits: int) -> float:
    """S(bits) = 2^(bits-1)."""
    return 2.0 ** (bits - 1)


def clip_c(x: torch.Tensor, bits: int = 32) -> torch.Tensor:
    """Clamp to [-1+delta, 1-delta]; delta = 0 for bits > 15 or bits in
    {1, 2}, else 1/S(bits)."""
    delta = 0.0 if (bits > 15 or bits in (1, 2)) else 1.0 / scale_s(bits)
    return torch.clamp(x, -1 + delta, 1 - delta)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * floor(|x| + 0.5): halves round away from zero (torch's
    ``round`` rounds them to even)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def quant_q(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Q(x, bits): identity (bits > 15), sign (1), round (2), else fixed
    point round(x * S) / S."""
    if bits > 15:
        return x
    if bits == 1:
        return torch.sign(x)
    if bits == 2:
        return _round_half_away(x)
    s = scale_s(bits)
    return _round_half_away(x * s) / s


def _per_filter_mean_abs(w: torch.Tensor) -> torch.Tensor:
    return torch.abs(w).mean(dim=_FILTER_AXES, keepdim=True)


# ---------------------------------------------------------------------------
# activation quantizer (QuanInput)
# ---------------------------------------------------------------------------


class _QuanInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bits_i):
        ctx.save_for_backward(x)
        return quant_q(clip_c(x, bits_i), bits_i)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where((x < 1) & (x > -1), g, torch.zeros_like(g)), None


def quan_input(x: torch.Tensor, bits_i: int) -> torch.Tensor:
    """Quantize activations: Q(C(x, bits_i), bits_i); the gradient passes
    through except where |x| >= 1."""
    return _QuanInput.apply(x, bits_i)


# ---------------------------------------------------------------------------
# weight quantizers
# ---------------------------------------------------------------------------


def binarize_weight_value(w: torch.Tensor, bits_g: int) -> torch.Tensor:
    """XNOR binarization sign(w) * mean|w| per output filter, the scale
    itself quantized to bits_g."""
    return torch.sign(w) * quant_q(_per_filter_mean_abs(w), bits_g)


def binarize_weight_value_ref(w: torch.Tensor, bits_g: int) -> torch.Tensor:
    """The reference's effective ``bits_w == 1`` forward: the unscaled
    sign(w), zero for whole filters whose bits_g-quantized scale rounds to
    0 (see the JAX package's docstring for the dangling ``else``)."""
    return torch.sign(w) * torch.sign(
        quant_q(_per_filter_mean_abs(w), bits_g))


def ternarize_weight_value(w: torch.Tensor) -> torch.Tensor:
    """bits_w == 2: {-1, 0, +1} with threshold 0.7 * mean|w| per output
    filter, not rescaled."""
    d = 0.7 * _per_filter_mean_abs(w)
    one, zero = torch.ones_like(w), torch.zeros_like(w)
    return torch.where(w > d, one, zero) + torch.where(w < -d, -one, zero)


def fixedpoint_weight_value(w: torch.Tensor, bits_w: int) -> torch.Tensor:
    """bits_w > 2: Q(C(w, bits_w), bits_w)."""
    return quant_q(clip_c(w, bits_w), bits_w)


def _xnor_jacobian(w: torch.Tensor, g: torch.Tensor,
                   bits_g: int = 32) -> torch.Tensor:
    """(mean|w| [0 where |w| > 1, quantized to bits_g] * g
    + per-filter mean(g * sign(w)) * sign(w)) * (1 - 1/c_in) * n; the
    default bits_g leaves mean|w| unrounded (``quant_q``'s identity)."""
    n = w.shape[0] * w.shape[1] * w.shape[2]
    c_in = w.shape[2]
    m = _per_filter_mean_abs(w) * torch.ones_like(w)
    m = torch.where((w < -1.0) | (w > 1.0), torch.zeros_like(m), m)
    m = quant_q(m, bits_g) * g
    m_add = (g * torch.sign(w)).mean(dim=_FILTER_AXES, keepdim=True) \
        * torch.sign(w)
    return (m + m_add) * (1.0 - 1.0 / c_in) * n


class _FakeQuantWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, bits_w, bits_g):
        ctx.save_for_backward(w)
        ctx.bits = (bits_w, bits_g)
        if bits_w > 15:
            return w.clone()
        if bits_w == 1:
            return binarize_weight_value_ref(w, bits_g)
        if bits_w == 2:
            return ternarize_weight_value(w)
        return fixedpoint_weight_value(w, bits_w)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        bits_w, bits_g = ctx.bits
        if bits_w > 15:
            return g, None, None
        if bits_w == 1:
            out = _xnor_jacobian(w, g, bits_g)
            return quant_q(clip_c(out, bits_g), bits_g), None, None
        return quant_q(clip_c(g, bits_g), bits_g), None, None


def fake_quant_weight(w: torch.Tensor, bits_w: int, bits_g: int
                      ) -> torch.Tensor:
    """Quantize a conv weight for the forward pass. ``bits_w == 1`` gives
    the reference's effective unscaled sign (``binarize_weight_value_ref``)
    while its backward applies the scaled-binarization XNOR jacobian, then
    quantizes the gradient to bits_g; ``bits_w in 2..15`` pass the gradient
    straight through, quantized to bits_g; ``bits_w > 15`` is the
    identity."""
    return _FakeQuantWeight.apply(w, bits_w, bits_g)


class _BinarizeWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, bits_g):
        ctx.save_for_backward(w)
        return torch.sign(w) * _per_filter_mean_abs(w)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return _xnor_jacobian(w, g), None


def binarize_weight(w: torch.Tensor, bits_g: int) -> torch.Tensor:
    """BinOp variant: sign(w) * mean|w|, the scale not quantized; the
    backward is the XNOR gradient without gradient quantization."""
    return _BinarizeWeight.apply(w, bits_g)


def meancenter_clamp_weight(w: torch.Tensor, bits_g: int) -> torch.Tensor:
    """Master-weight preprocessing: subtract the per-(filter, tap)
    input-channel mean, clamp to the bits_g range, round to bits_g."""
    centered = w - w.mean(dim=2, keepdim=True)
    return quant_q(clip_c(centered, bits_g), bits_g)


def meancenter_clamp_weight_bin(w: torch.Tensor) -> torch.Tensor:
    """BinOp master preprocessing: meancenter, then clamp to [-1, 1]; not
    rounded."""
    return torch.clamp(w - w.mean(dim=2, keepdim=True), -1.0, 1.0)
