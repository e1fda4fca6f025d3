"""NN ops on NHWC tensors: conv, batch-norm, pooling, upsampling.

Counterpart of ``cunet_tpu/ops/layers.py``. Layout stays NHWC with HWIO conv
weights at every public function, so the port and the JAX package compare
like with like. Numerics follow the JAX package: BN statistics in float32
with eps 1e-5 and momentum 0.1 (biased variance normalizes, the unbiased
one updates the running statistics), the affine in float32 or, with
``norm_dtype``, in that narrower dtype; the result is cast back to the
input dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def _no_tf32():
    """cuDNN's flags as they are, with TF32 off."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


class _Conv2dF32(torch.autograd.Function):
    """A float32 NCHW conv on the card whose forward and backward both run
    with cuDNN's TF32 off. Autograd runs a conv's backward after the
    forward's context has closed, under the global flag (True by default),
    so a context around ``F.conv2d`` alone leaves dX and dW in TF32."""

    @staticmethod
    def forward(ctx, xt, wt, stride, padding):
        ctx.save_for_backward(xt, wt)
        ctx.conf = (stride, padding)
        with _no_tf32():
            return F.conv2d(xt, wt, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, gy):
        xt, wt = ctx.saved_tensors
        stride, padding = ctx.conf
        with _no_tf32():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                gy, xt, wt, None, [stride] * 2, [padding] * 2, [1, 1],
                False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """2-D convolution, NHWC input, HWIO weight, NHWC output.

    The NHWC tensor is handed to ``F.conv2d`` as a channels-last NCHW view,
    so the library runs its NHWC kernels without a layout copy. Only the
    stem reaches this on the kernel path (the JAX package also runs the stem
    outside its Pallas program). A float32 conv runs in full float32 on
    the card, forward and backward, whatever
    ``torch.backends.cudnn.allow_tf32`` says (TF32, its default, would move
    it by ~1e-3 relative, where JAX's float32 conv moves by ~1e-7)."""
    xt, wt = x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1)
    if x.dtype == torch.float32 and x.is_cuda:
        y = _Conv2dF32.apply(xt, wt, stride, padding)
    else:
        y = F.conv2d(xt, wt, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def conv3x3_scatter(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv as one wide product and nine shifted adds
    (``cunet_tpu/ops/layers.py::conv3x3_scatter``, ``conv3x3_impl=
    "scatter"``). ``t = x @ W'`` with ``W'`` (Cin, 9*Cout) tap-major gives
    every tap's partial, rounded once to x's dtype (float32 accumulation);
    each output then sums its nine spatially shifted tap slices in x's
    dtype, one rounding per add, as the JAX form does (its product has no
    ``preferred_element_type``). At float32 this equals ``conv2d``; at bf16
    it rounds elsewhere. NHWC input, HWIO weight; differentiable."""
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    w_sc = w.permute(2, 0, 1, 3).reshape(cin, 9 * cout).to(x.dtype)
    t = (x.reshape(-1, cin).float() @ w_sc.float()).to(x.dtype)
    tp = F.pad(t.reshape(n, h, wd, 9 * cout), (0, 0, 1, 1, 1, 1))
    acc = None
    for dy in range(3):
        for dx in range(3):
            d = dy * 3 + dx
            sl = tp[:, dy:dy + h, dx:dx + wd, d * cout:(d + 1) * cout]
            acc = sl if acc is None else acc + sl
    return acc


def bn_inference_scale_shift(params: dict, state: dict, *,
                             eps: float = BN_EPS):
    """Fold an eval BN into per-channel float32 (inv, shift).

    ``params`` is ``{"scale", "bias"}``, ``state`` is ``{"mean", "var"}``."""
    inv = torch.rsqrt(state["var"].float() + eps) * params["scale"].float()
    return inv, params["bias"].float() - state["mean"].float() * inv


def narrow_dtype(norm_dtype) -> Optional[torch.dtype]:
    """The affine dtype of ``norm_dtype``: None for float32 (or None)."""
    if norm_dtype is None or norm_dtype == torch.float32:
        return None
    return norm_dtype


def batch_stats(x32: torch.Tensor, tile: int
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(mean, biased var, count) of a float32 (N, H, W, C) tensor over
    (N, H, W), or per contiguous group of ``tile`` images ((T, C) each)."""
    n, h, w, c = x32.shape
    if tile and tile < n:
        if n % tile:
            raise ValueError(f"batch {n} not divisible by bn_tile {tile}")
        xt = x32.reshape(n // tile, tile * h * w, c)
        return (xt.mean(dim=1), xt.var(dim=1, unbiased=False),
                tile * h * w)
    xt = x32.reshape(n * h * w, c)
    return xt.mean(dim=0), xt.var(dim=0, unbiased=False), n * h * w


def running_update(state: dict, mean: torch.Tensor, var: torch.Tensor,
                   cnt: int, momentum: float = BN_MOMENTUM) -> dict:
    """New running statistics from batch (or per-tile) mean and biased
    variance: the tile-averaged mean and tile-averaged unbiased variance
    enter with weight ``momentum`` (``cunet_tpu/ops/layers.py:88-108``)."""
    with torch.no_grad():
        unbiased = var * (cnt / max(cnt - 1, 1))
        if mean.dim() == 2:
            mean, unbiased = mean.mean(dim=0), unbiased.mean(dim=0)
        return {"mean": (1 - momentum) * state["mean"] + momentum * mean,
                "var": (1 - momentum) * state["var"] + momentum * unbiased}


def batch_norm(x: torch.Tensor, params: dict, state: dict, *,
               train: bool = False, eps: float = BN_EPS,
               momentum: float = BN_MOMENTUM, norm_dtype=None,
               tile: int = 0) -> Tuple[torch.Tensor, dict]:
    """BatchNorm over the channel (last) axis; returns ``(y, new_state)``.

    Eval uses the running statistics and returns ``state`` unchanged.
    Train normalizes with the batch statistics (per group of ``tile``
    images when ``0 < tile < N``, ghost BN) and returns the updated running
    statistics; gradients flow through the statistics by autograd.

    ``norm_dtype``: None (or float32) runs the affine in float32; a
    narrower dtype casts ``inv`` and ``shift`` to it and runs the affine
    there (``cfg.bn_dtype="compute"``), statistics staying float32.
    """
    scale, bias = params["scale"].float(), params["bias"].float()
    n, h, w, c = x.shape
    x32 = x.float()
    nd = narrow_dtype(norm_dtype)
    if train and tile and tile < n:
        mean, var, cnt = batch_stats(x32, tile)
        new_state = running_update(state, mean, var, cnt, momentum)
        inv = torch.rsqrt(var + eps) * scale              # (T, C)
        shift = bias - mean * inv
        xs = x.to(nd) if nd else x32
        if nd:
            inv, shift = inv.to(nd), shift.to(nd)
        t = n // tile
        y = xs.reshape(t, tile * h * w, c) * inv[:, None] + shift[:, None]
        return y.reshape(n, h, w, c).to(x.dtype), new_state
    if train:
        mean, var, cnt = batch_stats(x32, 0)
        new_state = running_update(state, mean, var, cnt, momentum)
    else:
        mean, var = state["mean"].float(), state["var"].float()
        new_state = state
    inv = torch.rsqrt(var + eps) * scale
    if nd:
        shift = (bias - mean * inv).to(nd)
        y = x.to(nd) * inv.to(nd) + shift
    else:
        y = (x32 - mean) * inv + bias
    return y.to(x.dtype), new_state


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool, NHWC. Its gradient goes to the first
    (row-major) maximum of each window, as XLA's select-and-scatter routes
    it (``amax`` would split it among ties)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 2)
    return y.permute(0, 2, 3, 1)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample, NHWC."""
    n, h, w, c = x.shape
    return x.reshape(n, h, 1, w, 1, c).expand(n, h, 2, w, 2, c) \
        .reshape(n, 2 * h, 2 * w, c)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)
