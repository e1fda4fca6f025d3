"""Concat-free dense bottleneck: BN(concat(features)) -> ReLU -> 1x1.

Counterpart of ``cunet_tpu/ops/bottleneck.py::dense_bottleneck``. A 1x1 conv
over a channel concat is a sum of per-group products,
``out = sum_k relu(bn_k(x_k)) @ W_k``, because BN is per channel and the
groups are disjoint, so the concat is never built; in train mode the batch
statistics are per group too (per ghost tile with ``tile``). This is the
plain layer-by-layer version; the kernel paths run the same arithmetic over
contiguous channel slices of their buffers
(:mod:`cunet_tpu_torch.kernels.buf_ops`, :mod:`cunet_tpu_torch.kernels.train_ops`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

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
