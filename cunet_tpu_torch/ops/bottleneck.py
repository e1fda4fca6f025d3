"""Concat-free dense bottleneck: BN(concat(features)) -> ReLU -> 1x1.

Counterpart of ``cunet_tpu/ops/bottleneck.py::dense_bottleneck``. A 1x1 conv
over a channel concat is a sum of per-group products,
``out = sum_k relu(bn_k(x_k)) @ W_k``, because BN is per channel and the
groups are disjoint, so the concat is never built; in train mode the batch
statistics are per group too (per ghost tile with ``tile``). This is the
plain layer-by-layer version; the kernel paths run the same arithmetic over
contiguous channel slices of their buffers
(:mod:`cunet_tpu_torch.kernels.buf_ops`, :mod:`cunet_tpu_torch.kernels.train_ops`).
Two train-mode forms sit beside it: ``dense_bottleneck_train_pallas`` (the
per-bottleneck train kernel, whole-batch statistics) and
``dense_bottleneck_remat`` (this one under activation checkpointing); and
one eval form, ``dense_bottleneck_infer_pallas`` (the per-bottleneck eval
kernel).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from cunet_tpu_torch.ops.layers import (
    BN_EPS,
    BN_MOMENTUM,
    batch_stats,
    narrow_dtype,
    running_update,
)


def dense_bottleneck(features: Sequence[torch.Tensor], params: dict,
                     state: dict, *, train: bool = False,
                     eps: float = BN_EPS, momentum: float = BN_MOMENTUM,
                     norm_dtype=None, tile: int = 0
                     ) -> Tuple[torch.Tensor, dict]:
    """BN -> ReLU -> 1x1 conv over the virtual concat of ``features``;
    returns ``(out, new_state)``.

    Args:
      features: NHWC tensors sharing N, H, W; channel counts may differ.
      params: ``{"norm": {"scale", "bias"}, "conv": (1, 1, Ctot, Cout)}``.
      state: ``{"mean", "var"}`` over the total channels.
      train: batch statistics (per group of ``tile`` images when
        ``0 < tile < N``) and a running-stat update, else running stats.
      norm_dtype: as in :func:`cunet_tpu_torch.ops.layers.batch_norm`.

    The activation is rounded to the feature dtype before the product, and
    products accumulate in float32; the result is cast back to the feature
    dtype.
    """
    w = params["conv"]
    ctot = sum(f.shape[-1] for f in features)
    if w.shape[2] != ctot:
        raise ValueError(f"conv in-channels {w.shape[2]} != concat {ctot}")
    scale = params["norm"]["scale"].float()
    bias = params["norm"]["bias"].float()
    n, h, wd, _ = features[0].shape
    dtype = features[0].dtype
    ghost = bool(train and tile and tile < n)

    if train:
        parts = [batch_stats(f.float(), tile if ghost else 0)
                 for f in features]
        mean = torch.cat([p[0] for p in parts], dim=-1)   # (C,) or (T, C)
        var = torch.cat([p[1] for p in parts], dim=-1)
        new_state = running_update(state, mean, var, parts[0][2], momentum)
    else:
        mean, var = state["mean"].float(), state["var"].float()
        new_state = state
    inv = torch.rsqrt(var + eps) * scale
    shift = bias - mean * inv
    nd = narrow_dtype(norm_dtype) or torch.float32
    inv, shift = inv.to(nd), shift.to(nd)

    acc = None
    off = 0
    for f in features:
        c = f.shape[-1]
        inv_k, shift_k = inv[..., off:off + c], shift[..., off:off + c]
        if ghost:
            t = n // tile
            y = f.to(nd).reshape(t, tile * h * wd, c) * inv_k[:, None] \
                + shift_k[:, None]
        else:
            y = f.to(nd) * inv_k + shift_k
        y = torch.relu(y).to(dtype).float().reshape(-1, c)
        part = y @ w[0, 0, off:off + c].to(dtype).float()
        acc = part if acc is None else acc + part
        off += c
    return acc.reshape(n, h, wd, -1).to(dtype), new_state


def dense_bottleneck_infer_pallas(features: Sequence[torch.Tensor],
                                  params: dict, state: dict
                                  ) -> Tuple[torch.Tensor, dict]:
    """Eval mode through the per-bottleneck eval kernel
    (:func:`cunet_tpu_torch.kernels.bottleneck_infer.fused_bottleneck_infer`):
    the running statistics folded into float32 (inv, shift), whatever the
    model's ``bn_dtype`` (``cunet_tpu/ops/bottleneck.py:130-140``); returns
    ``(out, state)``."""
    from cunet_tpu_torch.kernels.bottleneck_infer import fused_bottleneck_infer
    from cunet_tpu_torch.ops.layers import bn_inference_scale_shift

    inv, shift = bn_inference_scale_shift(params["norm"], state)
    return fused_bottleneck_infer(list(features), inv, shift,
                                  params["conv"]), state


def dense_bottleneck_train_pallas(features: Sequence[torch.Tensor],
                                  params: dict, state: dict, *,
                                  eps: float = BN_EPS,
                                  momentum: float = BN_MOMENTUM
                                  ) -> Tuple[torch.Tensor, dict]:
    """Train mode through the per-bottleneck train kernel
    (:func:`cunet_tpu_torch.kernels.train_bottleneck.fused_train_bottleneck`:
    whole-batch statistics, O(1) saved activations, recompute backward);
    returns ``(out, new_state)``. Where M = N*H*W has no row tile (not a
    multiple of 8) it takes ``dense_bottleneck`` with a float32 affine and
    whole-batch statistics, as ``cunet_tpu/ops/bottleneck.py`` does."""
    from cunet_tpu_torch.kernels.train_bottleneck import (
        fused_train_bottleneck,
        row_tile,
    )

    n, h, wd, _ = features[0].shape
    if row_tile(n * h * wd) == 0:
        return dense_bottleneck(features, params, state, train=True, eps=eps,
                                momentum=momentum)
    out, mean, var = fused_train_bottleneck(
        list(features), params["norm"]["scale"], params["norm"]["bias"],
        params["conv"], eps)
    return out, running_update(state, mean, var, n * h * wd, momentum)


def dense_bottleneck_remat(features: Sequence[torch.Tensor], params: dict,
                           state: dict, *, train: bool, **kw
                           ) -> Tuple[torch.Tensor, dict]:
    """``dense_bottleneck`` under ``torch.utils.checkpoint``: nothing
    between the inputs and the 1x1 output is saved for the backward, the
    BN / ReLU intermediates are recomputed (``jax.checkpoint`` in the JAX
    package). The new running statistics carry no autograd history. No
    RNG state is kept: nothing inside draws random numbers (the same rule
    as the model's checkpointed layers and slots)."""
    return checkpoint(
        lambda *feats: dense_bottleneck(feats, params, state, train=train,
                                        **kw),
        *features, use_reentrant=False, preserve_rng_state=False)
