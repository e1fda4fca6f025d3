"""The dropout-mask kernel of the slot train step, beside its plain version.

Counterpart of the dense-layer dropout inside
``cunet_tpu/kernels/train_slot.py`` (``_seed_mask`` :226, applied to each
3x3 conv output at :296-300 and to its cotangent at :949-952): the mask is
regenerated from (seed, traversal position, ghost-BN tile, element index)
wherever it is needed, so neither the forward nor the recompute backward
stores it. The bits are those of :mod:`cunet_tpu_torch.ops.dropmask`, the
JAX package's for the same int32 seed.

As in :mod:`cunet_tpu_torch.kernels.buf_ops`: on a CPU tensor the wrapper
computes its plain PyTorch version; on a CUDA tensor it launches its kernel
or raises; ``drop_mask.launches`` counts its launches and nothing else.
"""

from __future__ import annotations

import torch

from cunet_tpu_torch.kernels import build
from cunet_tpu_torch.kernels.buf_ops import _check_view, _stream, reset_counts
from cunet_tpu_torch.kernels.train_ops import _check_f32
from cunet_tpu_torch.ops import dropmask


def drop_mask_plain(x, seed, pos, rate, tile_rows, out=None):
    m, g = x.shape
    dt = x.dtype if out is None else out.dtype
    mask = dropmask.rows_mask(seed, pos, m, g, tile_rows, rate, dt, x.device)
    if out is None:
        return x.mul_(mask)
    out.copy_(x.float() * mask.float())
    return out


def drop_mask(x, seed, pos, rate, tile_rows, out=None):
    """The scaled dropout mask {0, 1/keep} of traversal position ``pos``
    applied to an (M, G) out32 view, ghost-BN tile t holding rows
    [t * tile_rows, (t + 1) * tile_rows).

    Forward (``out`` None): ``x`` (the conv output, compute dtype) is
    multiplied in place, in the compute dtype, as JAX's ``out32 * mask``.
    Backward: ``out = x * mask`` for the float32 cotangent ``x``, the
    product taken in float32 and rounded once to ``out``'s dtype, as
    JAX's ``d_out32 * mask.astype(f32)`` before the conv backward.

    Replaces ``cunet_tpu/kernels/train_slot.py::_seed_mask`` and its two
    multiplies. Pure data movement (~10 integer ops per element), bound by
    reading and writing the view once. Design: one thread per 8 columns of
    a row, the tile key folded per row (two fmix32) and one fmix32 per
    element; 16-byte loads and stores into the strided buffer view.
    """
    m, g = x.shape
    if m % tile_rows or (out is not None and tuple(out.shape) != (m, g)):
        raise ValueError(f"drop_mask shapes: x {tuple(x.shape)}, out "
                         f"{None if out is None else tuple(out.shape)}, "
                         f"tile_rows {tile_rows}")
    thr = dropmask.keep_threshold(rate)
    if x.device.type == "cpu":
        return drop_mask_plain(x, seed, pos, rate, tile_rows, out)
    if out is None:
        _check_view(x, "x")
        dst = x
    else:
        _check_f32(x, "x", x.device)
        _check_view(out, "out")
        dst = out
    code = build.lib().cunet_drop_mask(
        x.data_ptr(), x.stride(0), int(out is not None), dst.data_ptr(),
        dst.stride(0), m, g, tile_rows, dropmask.seed_key(seed, pos), thr,
        dropmask.keep_scale(rate, torch.bfloat16), _stream(x))
    build.check(code, "drop_mask")
    drop_mask.launches += 1
    return dst


KERNELS = (drop_mask,)
PLAIN = {drop_mask: drop_mask_plain}


def reset_launch_counts() -> None:
    reset_counts(KERNELS)


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


reset_launch_counts()
