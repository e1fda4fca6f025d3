"""The concat-free eval product over a feature table, beside its plain
version.

``table_dot`` is one Hopper kernel (``csrc/eval_kernels.cu``) that serves
two TPU kernels: the per-bottleneck eval kernels
(``cunet_tpu/kernels/fused_bottleneck.py``, #6, through
:mod:`cunet_tpu_torch.kernels.bottleneck_infer`) and every 1x1 stage of the
per-slot hourglass (``cunet_tpu/kernels/fused_hourglass.py``, #4, through
:mod:`cunet_tpu_torch.kernels.hourglass`). Its features are separate 2-D
tensors (a slot's FIFO entries come back from memory between slots as
tensors of their own), read in place: no concat, no copy. On a CPU tensor
the wrapper computes the plain version; on a CUDA tensor it launches the
kernel or raises. ``table_dot.launches`` counts its launches and nothing
else; ``option_counts`` those of the dual and the BN2-epilogue forms.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from cunet_tpu_torch.kernels import build
from cunet_tpu_torch.kernels.buf_ops import (
    _check_vec,
    _check_view,
    _rows,
    _stream,
    affine_dot_plain,
)

MAX_GROUPS = 16


def table_dot_plain(feats, vec, w, out, bias=None, vec_s=None, w_s=None,
                    out_s=None):
    """``torch.cat`` the features, then ``buf_ops.affine_dot_plain`` per
    output (the weight's first ``out.shape[-1]`` columns)."""
    x = torch.cat(list(feats), dim=1)
    n = out.shape[-1]
    affine_dot_plain(x, vec, w[:, :n], out, bias)
    if out_s is not None:
        affine_dot_plain(x, vec_s, w_s[:, :n], out_s)
    return out


def _check_dense(t: torch.Tensor, name: str, dev: torch.device) -> None:
    """A bf16 operand on ``dev`` with unit column stride; any width."""
    if t.device != dev or t.dtype != torch.bfloat16 or t.stride(-1) != 1:
        raise ValueError(f"{name} must be a bf16 tensor on {dev} with unit "
                         f"column stride, got {t.dtype} on {t.device}, "
                         f"strides {t.stride()}")


def table_dot(feats: Sequence[torch.Tensor], vec, w, out, *, bias=None,
              vec_s=None, w_s=None, out_s=None):
    """``out = epi(relu(x * vec[0] + vec[1]) @ w[:K, :N])`` for x the
    virtual concat of ``feats`` ((M, C_g) views, K = sum C_g, G <= 16
    groups), N = ``out.shape[-1]``.

    ``vec`` is the (2, >=K) float32 [inv; shift] of an eval BN (float32
    whatever the model's ``bn_dtype``, as the TPU kernels compute it), ``w``
    the (>=K, >=N) weight (any row stride), of which a row and column
    prefix is read (growth-phase slots read a row prefix of the padded
    weight, the head a column prefix of its padded one). ``epi`` is the
    identity or, with ``bias``, ``relu(. + bias)`` (the bottleneck's folded
    BN2). With ``vec_s, w_s, out_s`` a second output ``relu(x * vec_s[0] +
    vec_s[1]) @ w_s`` comes from the same read of x (the dual form: a down
    block's ahead and skip adapters). ``out`` is an (M, N) view or an
    image-major (B, P, N) view; ``out_s`` an (M, N) view. The activation is
    rounded to bf16 before the product, products accumulate in float32 and
    each output rounds to bf16 once.

    Replaces ``cunet_tpu/kernels/fused_bottleneck.py::
    fused_bottleneck_infer`` / ``fused_dual_bottleneck_infer`` and
    ``fused_hourglass.py::_bottleneck_val``. Bound on the H100 by reading x
    and writing the outputs. Design: ``csrc/eval_kernels.cu``: the table of
    (pointer, row stride, width) passed by value in the launch parameters;
    128-row block tiles over the full N; the prologue(s) in float32
    registers between one 16-byte load of x and the bf16 shared-memory
    tiles; bf16 WMMA with float32 accumulators; N and row tails in the
    kernel.
    """
    feats = list(feats)
    dual = out_s is not None
    if not feats or len(feats) > MAX_GROUPS:
        raise ValueError(f"table_dot takes 1..{MAX_GROUPS} feature groups, "
                         f"got {len(feats)}")
    if dual and (vec_s is None or w_s is None or bias is not None):
        raise ValueError("the dual form needs vec_s, w_s and out_s, and has "
                         "no bias epilogue")
    m = feats[0].shape[0]
    k = sum(f.shape[1] for f in feats)
    n = out.shape[-1]
    pairs = [(vec, w, out)] + ([(vec_s, w_s, out_s)] if dual else [])
    for f in feats:
        if f.dim() != 2 or f.shape[0] != m:
            raise ValueError(f"table_dot features must be (M={m}, C) views, "
                             f"got {[tuple(f.shape) for f in feats]}")
    for v, wt, o in pairs:
        if _rows(o)[0] != m or o.shape[-1] != n or wt.dim() != 2 \
                or wt.shape[0] < k or wt.shape[1] < n \
                or v.dim() != 2 or v.shape[0] != 2 or v.shape[1] < k:
            raise ValueError(
                f"table_dot shapes: features {[tuple(f.shape) for f in feats]}"
                f", vec {tuple(v.shape)}, w {tuple(wt.shape)}, out "
                f"{tuple(o.shape)}")
    if dual and (out_s.dim() != 2 or w_s.shape != w.shape):
        raise ValueError(f"out_s must be (M, N) and w_s shaped like w, got "
                         f"{tuple(out_s.shape)}, {tuple(w_s.shape)}")
    if feats[0].device.type == "cpu":
        return table_dot_plain(feats, vec, w, out, bias, vec_s, w_s, out_s)
    dev = feats[0].device
    for i, f in enumerate(feats):
        _check_view(f, f"feature {i}")
        if f.device != dev:
            raise ValueError(f"feature {i} is on {f.device}, not {dev}")
    for v, wt, o in pairs:
        _check_dense(o, "out", dev)
        _check_dense(wt, "w", dev)
        _check_vec(v, "vec", k)
    if dual and w_s.stride() != w.stride():
        raise ValueError(f"w_s strides {w_s.stride()} differ from w's "
                         f"{w.stride()}")
    if bias is not None:
        _check_vec(bias, "bias", n)
    _, rows_per_img, img_stride, ldo = _rows(out)
    g = len(feats)
    ptrs = (ctypes.c_void_p * g)(*[f.data_ptr() for f in feats])
    lds = (ctypes.c_longlong * g)(*[f.stride(0) for f in feats])
    widths = (ctypes.c_int * g)(*[f.shape[1] for f in feats])
    code = build.lib().cunet_table_dot(
        ptrs, lds, widths, g, m, vec[0].data_ptr(), vec[1].data_ptr(),
        w.data_ptr(),
        vec_s[0].data_ptr() if dual else 0,
        vec_s[1].data_ptr() if dual else 0,
        w_s.data_ptr() if dual else 0, w.stride(0), n,
        0 if bias is None else bias.data_ptr(), out.data_ptr(), ldo,
        rows_per_img, img_stride, out_s.data_ptr() if dual else 0,
        out_s.stride(0) if dual else 0, _stream(feats[0]))
    build.check(code, "table_dot")
    table_dot.launches += 1
    table_dot.dual_launches += dual
    table_dot.bias_launches += bias is not None
    return out


PLAIN = {table_dot: table_dot_plain}


def reset_launch_counts() -> None:
    table_dot.launches = 0
    table_dot.dual_launches = 0
    table_dot.bias_launches = 0


def launch_counts() -> dict:
    return {"table_dot": table_dot.launches}


def option_counts() -> dict:
    """Launches of the dual form and of the BN2 (``shift2``) epilogue."""
    return {"table_dot[dual]": table_dot.dual_launches,
            "table_dot[shift2]": table_dot.bias_launches}


reset_launch_counts()
