"""The concat-free eval product over a feature table, beside its plain
version.

``table_dot`` is one Hopper kernel (``csrc/eval_kernels.cu``) that serves
three TPU kernels: the per-bottleneck eval kernels
(``cunet_tpu/kernels/fused_bottleneck.py``, #6, through
:mod:`cunet_tpu_torch.kernels.bottleneck_infer`), every 1x1 stage of the
per-slot hourglass (``cunet_tpu/kernels/fused_hourglass.py``, #4, through
:mod:`cunet_tpu_torch.kernels.hourglass`) and every 1x1 stage of the
per-block eval (``cunet_tpu/kernels/fused_block.py``, #5, through
:mod:`cunet_tpu_torch.kernels.fused_block`), whose upsample and pool it
folds into its read and its store. Its features are separate 2-D tensors
(a slot's FIFO entries come back from memory between slots as tensors of
their own), read in place: no concat, no copy. On a CPU tensor the wrapper
computes the plain version; on a CUDA tensor it launches the kernel or
raises. ``table_dot.launches`` counts its launches and nothing else;
``option_counts`` those of each option.
"""

from __future__ import annotations

from typing import Sequence

import torch

from cunet_tpu_torch.kernels import build
from cunet_tpu_torch.kernels.buf_ops import (
    BF16,
    F32,
    _check_vec,
    _check_view,
    _rows,
    _stream,
    affine_dot_plain,
    INLINE_GROUPS,
    group_table,
    launch_dot3,
    maxpool2_plain,
    table_args,
    upsample2_plain,
)

# the kernel's row tile (csrc/common.cuh, BM): the one check of the pooled
# store's tile limit, which the kernel's entry point does not repeat
BLOCK_ROWS = 128


def table_dot_plain(feats, vec, w, out, bias=None, vec_s=None, w_s=None,
                    out_s=None, *, vec2=None, up=(), pool=False, hw=None):
    """The flagged groups 2x upsampled (``upsample2_plain``), ``torch.cat``
    of the features, then ``buf_ops.affine_dot_plain`` per output (the
    weight's first ``out.shape[-1]`` columns; ``vec2``'s epilogue
    ``relu(acc * vec2[0] + vec2[1])``), the first output max-pooled
    (``maxpool2_plain``) from its rounded values with ``pool``."""
    feats = list(feats)
    h, wd = hw if hw is not None else (0, 0)
    for i, half in enumerate(up):
        if half:
            f = feats[i]
            b = 4 * f.shape[0] // (h * wd)
            feats[i] = upsample2_plain(f, b, h // 2, wd // 2,
                                       f.new_empty(4 * f.shape[0], f.shape[1]))
    x = torch.cat(feats, dim=1)
    n = out.shape[-1]
    dst = x.new_empty(x.shape[0], n, dtype=out.dtype) if pool else out
    if vec2 is not None:
        affine_dot_plain(x, vec, w[:, :n], dst, vec2[1, :n], scale=vec2[0, :n])
    else:
        affine_dot_plain(x, vec, w[:, :n], dst, bias)
    if pool:
        maxpool2_plain(dst, x.shape[0] // (h * wd), h, wd, out)
    if out_s is not None:
        affine_dot_plain(x, vec_s, w_s[:, :n], out_s)
    return out


def _check_dense(t: torch.Tensor, name: str, dev: torch.device,
                 dtype=BF16) -> None:
    """An operand of ``dtype`` (the features': no operand is cast) on
    ``dev`` with unit column stride; any width."""
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the features {dtype}")
    if t.device != dev or t.stride(-1) != 1:
        raise ValueError(f"{name} must be a tensor on {dev} with unit "
                         f"column stride, got {t.device}, strides "
                         f"{t.stride()}")


def _check_resample(up, pool, hw, m, feats):
    """The shapes the upsample and pool options need; returns (H, W)."""
    if not (any(up) or pool):
        return 0, 0
    if hw is None:
        raise ValueError("table_dot with up or pool needs hw=(H, W), the "
                         "output images' size")
    h, wd = hw
    if h % 2 or wd % 2 or m % (h * wd):
        raise ValueError(f"table_dot: {m} rows are not whole {h}x{wd} "
                         f"images of even size")
    for i, half in enumerate(up):
        want = m // 4 if half else m
        if feats[i].shape[0] != want:
            raise ValueError(f"table_dot feature {i} has {feats[i].shape[0]} "
                             f"rows, expected {want}")
    if pool and BLOCK_ROWS % (2 * wd):
        raise ValueError(f"table_dot's pooled store needs whole 2x2 windows "
                         f"in its {BLOCK_ROWS}-row tile: 2 * W = {2 * wd} "
                         f"must divide {BLOCK_ROWS} (W <= {BLOCK_ROWS // 2})")
    return h, wd


def table_dot(feats: Sequence[torch.Tensor], vec, w, out, *, bias=None,
              vec2=None, vec_s=None, w_s=None, out_s=None, up=(),
              pool=False, hw=None):
    """``out = epi(relu(x * vec[0] + vec[1]) @ w[:K, :N])`` for x the
    virtual concat of ``feats`` ((M, C_g) views, K = sum C_g, any number G
    of groups), N = ``out.shape[-1]``.

    ``vec`` is the (2, >=K) float32 [inv; shift] of an eval BN (float32
    whatever the model's ``bn_dtype``, as the TPU kernels compute it), ``w``
    the (>=K, >=N) weight (any row stride), of which a row and column
    prefix is read (growth-phase slots read a row prefix of the padded
    weight, the head a column prefix of its padded one). ``epi`` is the
    identity; with ``bias``, ``relu(. + bias)`` (the bottleneck's BN2 with
    its scale folded into the weight: ``shift2``); with ``vec2`` ((2, >=N)
    float32 [inv2; shift2]), ``relu(. * inv2 + shift2)`` in float32 (BN2's
    full affine: ``scale``, TPU kernel #5's). With ``vec_s, w_s, out_s`` a
    second output ``relu(x * vec_s[0] + vec_s[1]) @ w_s`` comes from the
    same read of x (the dual form: a down block's ahead and skip adapters).
    ``out`` is an (M, N) view or an image-major (B, P, N) view; ``out_s``
    an (M, N) view. The activation is rounded to bf16 before the product,
    products accumulate in float32 and each output rounds to bf16 once.

    The hourglass's resampling, folded in (``hw=(H, W)``: the output
    images' size, M = B*H*W): ``up`` flags groups (one bool each) that
    enter at half resolution, (M/4, C_g), read through a 2x nearest
    upsample (``up``); with ``pool`` the first output is stored 2x2
    max-pooled into an (M/4, N) ``out`` (``pool``), from its bf16-rounded
    values, so it equals ``maxpool2`` of the unpooled output bit for bit.
    The pooled store needs whole windows in the kernel's 128-row tile:
    2W must divide 128, else the wrapper raises.

    Replaces ``cunet_tpu/kernels/fused_bottleneck.py::
    fused_bottleneck_infer`` / ``fused_dual_bottleneck_infer``,
    ``fused_hourglass.py::_bottleneck_val`` and the 1x1 stages of
    ``fused_block.py::fused_dense_block_infer``. Bound on the H100 by
    reading x and writing the outputs. Design: ``csrc/eval_kernels.cu``:
    the table of (pointer, row stride, width) passed by value in the
    launch parameters (past ``buf_ops.INLINE_GROUPS`` groups, in device
    memory, filled on the stream by the launch's entry point and searched
    the same way, so the sums do not change); 128-row block tiles over the
    full N; the prologue(s)
    in float32 registers between one 16-byte load of x and the bf16
    shared-memory tiles; bf16 WMMA with float32 accumulators; N and row
    tails in the kernel; the upsample a per-row remap of the load, the pool
    an epilogue over the output tile in shared memory.

    Float32 features (with float32 weights and outputs) run its float32
    form, every option included (``csrc/f32_kernels.cu``, plan
    ``buf_ops.dot3_plan``): no rounding anywhere, the product float32-accurate
    through the exact three-way bf16 split of both operands (six plane
    products a k16 step on the tensor cores), summed in the order of
    ``affine_dot``'s float32 form, so the per-slot and whole-model paths
    agree bit for bit at float32 too.
    """
    feats = list(feats)
    dual = out_s is not None
    up = tuple(bool(u) for u in up)
    if not feats:
        raise ValueError("table_dot takes one or more feature groups")
    if up and len(up) != len(feats):
        raise ValueError(f"up flags {len(up)} groups of {len(feats)}")
    if dual and (vec_s is None or w_s is None or bias is not None
                 or vec2 is not None):
        raise ValueError("the dual form needs vec_s, w_s and out_s, and has "
                         "no BN2 epilogue")
    if bias is not None and vec2 is not None:
        raise ValueError("bias (shift2) and vec2 (scale) are two epilogues; "
                         "pass one")
    full = [f for f, half in zip(feats, up + (False,) * len(feats))
            if not half]
    m = full[0].shape[0] if full else 4 * feats[0].shape[0]
    k = sum(f.shape[1] for f in feats)
    n = out.shape[-1]
    pairs = [(vec, w, out, m // 4 if pool else m)] + (
        [(vec_s, w_s, out_s, m)] if dual else [])
    for f in feats:
        if f.dim() != 2:
            raise ValueError(f"table_dot features must be 2-D views, got "
                             f"{[tuple(f.shape) for f in feats]}")
    for i, f in enumerate(feats):
        if not (up and up[i]) and f.shape[0] != m:
            raise ValueError(f"table_dot features must be (M={m}, C) views, "
                             f"got {[tuple(f.shape) for f in feats]}")
    for v, wt, o, rows in pairs:
        if _rows(o)[0] != rows or o.shape[-1] != n or wt.dim() != 2 \
                or wt.shape[0] < k or wt.shape[1] < n \
                or v.dim() != 2 or v.shape[0] != 2 or v.shape[1] < k:
            raise ValueError(
                f"table_dot shapes: features {[tuple(f.shape) for f in feats]}"
                f", vec {tuple(v.shape)}, w {tuple(wt.shape)}, out "
                f"{tuple(o.shape)}")
    if dual and (out_s.dim() != 2 or w_s.shape != w.shape):
        raise ValueError(f"out_s must be (M, N) and w_s shaped like w, got "
                         f"{tuple(out_s.shape)}, {tuple(w_s.shape)}")
    if vec2 is not None and (vec2.dim() != 2 or vec2.shape[0] != 2
                             or vec2.shape[1] < n):
        raise ValueError(f"vec2 must be (2, >={n}), got {tuple(vec2.shape)}")
    h, wd = _check_resample(up, pool, hw, m, feats)
    if feats[0].device.type == "cpu":
        return table_dot_plain(feats, vec, w, out, bias, vec_s, w_s, out_s,
                               vec2=vec2, up=up, pool=pool, hw=hw)
    dev, dt = feats[0].device, feats[0].dtype
    for i, f in enumerate(feats):
        _check_view(f, f"feature {i}", (BF16, F32))
        if f.device != dev:
            raise ValueError(f"feature {i} is on {f.device}, not {dev}")
        if f.dtype != dt:
            raise TypeError(f"feature {i} has dtype {f.dtype}, feature 0 "
                            f"{dt}")
    for v, wt, o, _ in pairs:
        _check_dense(o, "out", dev, dt)
        _check_dense(wt, "w", dev, dt)
        _check_vec(v, "vec", k)
    if dual and w_s.stride() != w.stride():
        raise ValueError(f"w_s strides {w_s.stride()} differ from w's "
                         f"{w.stride()}")
    for name, t in (("bias", bias), ("vec2", vec2)):
        if t is not None:
            _check_vec(t, name, n)
    kw = dict(bias=bias, vec2=vec2, vec_s=vec_s, w_s=w_s, out_s=out_s,
              up=up, hw=(h, wd), pool=pool)
    if dt == F32:
        build.check(launch_dot3(feats, m, vec, w, out, **kw),
                    "table_dot (float32)")
        table_dot.f32_launches += 1
    else:
        ext = group_table(feats)
        build.check(build.lib().cunet_table_dot(
            *table_args(feats, m, vec, w, out, ext=ext, **kw),
            _stream(feats[0])), "table_dot")
    table_dot.launches += 1
    table_dot.dual_launches += dual
    table_dot.bias_launches += bias is not None
    table_dot.scale_launches += vec2 is not None
    table_dot.up_launches += any(up)
    table_dot.pool_launches += bool(pool)
    table_dot.ext_launches += len(feats) > INLINE_GROUPS
    return out


PLAIN = {table_dot: table_dot_plain}


OPTIONS = {"dual": "dual_launches", "shift2": "bias_launches",
           "scale": "scale_launches", "up": "up_launches",
           "pool": "pool_launches"}


def reset_launch_counts() -> None:
    table_dot.launches = table_dot.f32_launches = table_dot.ext_launches = 0
    for attr in OPTIONS.values():
        setattr(table_dot, attr, 0)


def launch_counts() -> dict:
    return {"table_dot": table_dot.launches}


def f32_counts() -> dict:
    """Launches of the float32 form (also counted in ``launches`` and in
    each option's count)."""
    return {"table_dot[f32]": table_dot.f32_launches}


def ext_counts() -> dict:
    """Launches over more feature groups than the launch parameters carry
    (the table read from device memory; also counted in ``launches``)."""
    return {"table_dot[groups>16]": table_dot.ext_launches}


def option_counts() -> dict:
    """Launches of each option: the dual form, the BN2 epilogues (folded
    ``shift2``, full ``scale``), the upsampled read and the pooled store."""
    return {f"table_dot[{name}]": getattr(table_dot, attr)
            for name, attr in OPTIONS.items()}


reset_launch_counts()
