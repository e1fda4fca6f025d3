"""The per-bottleneck eval kernels: BN (folded) -> ReLU -> 1x1 conv over a
list of NHWC features, one or two outputs.

Counterpart of ``cunet_tpu/kernels/fused_bottleneck.py`` (TPU kernel #6):
``fused_bottleneck_infer`` and ``fused_dual_bottleneck_infer``, with JAX's
signatures minus ``interpret``. Both run the feature-table product
(:func:`cunet_tpu_torch.kernels.eval_ops.table_dot`): the features are read
in place as separate tensors, the concat is never built, and the dual form
computes a down block's ahead and skip adapters from one read of them. The
affine is float32 whatever the model's ``bn_dtype``, as in the TPU kernel
(:63-65, :163-165). The kernel takes any row count, so the TPU kernel's
``_lax_fallback`` for row counts with no multiple-of-8 tile has no
counterpart here. On CPU tensors the plain version runs.
"""

from __future__ import annotations

from typing import Sequence

import torch

from cunet_tpu_torch.kernels.eval_ops import table_dot


def _operands(features, inv, shift, w):
    n, h, wd, _ = features[0].shape
    m = n * h * wd
    dtype = features[0].dtype
    xs = [f.reshape(m, f.shape[-1]) for f in features]
    vec = torch.stack([inv.float(), shift.float()])
    return xs, vec, w[0, 0].to(dtype).contiguous(), (n, h, wd)


def fused_bottleneck_infer(features: Sequence[torch.Tensor], inv, shift, w):
    """Eval bottleneck over the virtual concat of ``features`` (NHWC, same
    N, H, W): ``relu(x * inv + shift)`` (float32 (Ctot,) vectors, rounded
    to the features' dtype) ``@ w`` ((1, 1, Ctot, Cout)), float32
    accumulation. Returns (N, H, W, Cout) in the features' dtype."""
    xs, vec, w2, nhw = _operands(features, inv, shift, w)
    out = torch.empty(xs[0].shape[0], w2.shape[1], device=xs[0].device,
                      dtype=xs[0].dtype)
    table_dot(xs, vec, w2, out)
    return out.reshape(*nhw, -1)


def fused_dual_bottleneck_infer(features: Sequence[torch.Tensor], inv_a,
                                shift_a, w_a, inv_s, shift_s, w_s):
    """Two eval bottlenecks over the same features in one launch: the ahead
    and skip adapters of a down block. Returns (ahead, skip), each
    (N, H, W, Cout)."""
    xs, vec_a, wa, nhw = _operands(features, inv_a, shift_a, w_a)
    vec_s = torch.stack([inv_s.float(), shift_s.float()])
    ws = w_s[0, 0].to(wa.dtype).contiguous()
    m, cout = xs[0].shape[0], wa.shape[1]
    out_a, out_s = (torch.empty(m, cout, device=xs[0].device,
                                dtype=xs[0].dtype) for _ in range(2))
    table_dot(xs, vec_a, wa, out_a, vec_s=vec_s, w_s=ws, out_s=out_s)
    return out_a.reshape(*nhw, cout), out_s.reshape(*nhw, cout)
