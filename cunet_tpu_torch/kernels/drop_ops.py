"""The dropout-mask kernels of the slot train step, beside their plain
versions: ``drop_mask`` (``drop_impl="prng"``) and ``threefry_mask``
(``drop_impl="masks"``).

Counterpart of the dense-layer dropout inside
``cunet_tpu/kernels/train_slot.py`` (``_seed_mask`` :226, applied to each
3x3 conv output at :296-300 and to its cotangent at :949-952): the mask is
regenerated from (seed, traversal position, ghost-BN tile, element index)
wherever it is needed, so neither the forward nor the recompute backward
stores it. The bits are those of :mod:`cunet_tpu_torch.ops.dropmask`, the
JAX package's for the same int32 seed. ``dropout`` applies the same kernel
on the layer-by-layer kernel path (``bn_tile=0``), where JAX multiplies by
the plain mask.

``threefry_mask`` is the ``drop_impl="masks"`` form: the TPU kernels
read each mask as an input (``train_slot.py`` :425-426, :1389-1390), a
threefry bernoulli draw of the block's key; here the kernel regenerates
those bits (:mod:`cunet_tpu_torch.ops.threefry`) in the forward and in the
recompute backward, so this form stores no mask either.
``dropout_masks`` is its layer-by-layer kernel path.

As in :mod:`cunet_tpu_torch.kernels.buf_ops`: on a CPU tensor a wrapper
computes its plain PyTorch version; on a CUDA tensor it launches its kernel
or raises; ``<wrapper>.launches`` counts its launches and nothing else.
"""

from __future__ import annotations

import torch

from cunet_tpu_torch.kernels import build
from cunet_tpu_torch.kernels.buf_ops import (
    BF16,
    F32,
    _check_view,
    _stream,
    count_f32,
    reset_counts,
)
from cunet_tpu_torch.kernels.train_ops import _check_f32
from cunet_tpu_torch.ops import dropmask, threefry


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

    Float32 ``x`` with ``out`` None or float32 (a float32 model's forward
    and backward): the float32 form, ``x * mask`` in float32 with the mask
    at float32, written to ``out`` or in place; counted in
    ``drop_mask.f32_launches`` too.

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
    f32 = x.dtype == F32 and (out is None or out.dtype == F32)
    if out is None:
        _check_view(x, "x", (BF16, F32))
        dst = x
    else:
        _check_f32(x, "x", x.device)
        _check_view(out, "out", (BF16, F32))
        dst = out
    code = build.lib().cunet_drop_mask(
        x.data_ptr(), x.stride(0), 2 if f32 else int(out is not None),
        dst.data_ptr(), dst.stride(0), m, g, tile_rows,
        dropmask.seed_key(seed, pos), thr,
        dropmask.keep_scale(rate, F32 if f32 else BF16), _stream(x))
    build.check(code, "drop_mask")
    drop_mask.launches += 1
    drop_mask.f32_launches += f32
    return dst


class _Dropout(torch.autograd.Function):
    """``y * mask`` with the mask regenerated by ``drop_mask`` in the
    forward and in the backward: nothing is saved, and both products are
    the compute-dtype products of the plain ``y * batch_mask(...)`` and of
    its autograd backward, bit for bit."""

    @staticmethod
    def forward(ctx, y, seed, pos, rate, tile_rows):
        ctx.mask = (seed, pos, rate, tile_rows)
        out = y.clone(memory_format=torch.contiguous_format)
        drop_mask(out.view(-1, out.shape[-1]), seed, pos, rate, tile_rows)
        return out

    @staticmethod
    def backward(ctx, d):
        d = d.clone(memory_format=torch.contiguous_format)
        drop_mask(d.view(-1, d.shape[-1]), *ctx.mask)
        return d, None, None, None, None


def dropout(y, seed, pos, rate, tile_images):
    """Dropout of an NHWC dense-layer output ``y`` at traversal position
    ``pos`` with ghost-BN tiles of ``tile_images`` images (0: the whole
    batch, one tile), through the mask kernel in the forward and the
    backward: the layer-by-layer kernel path's dropout, equal to
    ``y * ops.dropmask.batch_mask(seed, pos, y.shape, tile_images, rate,
    y.dtype)`` and its gradient."""
    n, h, w, _ = y.shape
    return _Dropout.apply(y, seed, pos, rate, (tile_images or n) * h * w)


def threefry_mask_plain(x, key, rate, out=None):
    m, g = x.shape
    dt = x.dtype if out is None else out.dtype
    mask = threefry.bernoulli_mask(key, (m, g), rate, dt, x.device)
    if out is None:
        return x.mul_(mask)
    out.copy_(x.float() * mask.float())
    return out


def threefry_mask(x, key, rate, out=None):
    """JAX's threefry dropout mask {0, 1/keep} of the block key ``key`` (a
    pair of uint32 ints) applied to an (M, G) out32 view whose rows are
    the batch's (n, res, res) positions in order: element (m, c) takes the
    bits at index m * G + c of ``jax.random.bernoulli(key, 1 - rate, (n,
    res, res, G))``, whatever the ghost-BN tiles.

    The forms, products and rounding are ``drop_mask``'s: forward (``out``
    None) in place in the compute dtype, as JAX's ``out32 * mask``;
    backward ``out = x * mask`` from the float32 cotangent ``x``, as
    JAX's ``d_out32 * mask.astype(f32)``; float32 ``x`` and ``out`` the
    float32 form, counted in ``threefry_mask.f32_launches`` too.

    Replaces the masks form of ``cunet_tpu/kernels/train_slot.py``
    (``slot_train_fwd`` / ``slot_train_bwd``'s mask inputs and their two
    multiplies, :296-299 and :949-951). Bound by the integer pipe:
    threefry2x32 is about 90 integer operations an element. Design: one
    thread per 8 columns of a row, threefry2x32 of each element's
    row-major index with funnel-shift rotates, 16-byte loads and stores
    into the strided buffer view.
    """
    m, g = x.shape
    if out is not None and tuple(out.shape) != (m, g):
        raise ValueError(f"threefry_mask shapes: x {tuple(x.shape)}, out "
                         f"{tuple(out.shape)}")
    thr = threefry.keep_threshold(rate)
    if x.device.type == "cpu":
        return threefry_mask_plain(x, key, rate, out)
    f32 = x.dtype == F32 and (out is None or out.dtype == F32)
    if out is None:
        _check_view(x, "x", (BF16, F32))
        dst = x
    else:
        _check_f32(x, "x", x.device)
        _check_view(out, "out", (BF16, F32))
        dst = out
    code = build.lib().cunet_threefry_mask(
        x.data_ptr(), x.stride(0), 2 if f32 else int(out is not None),
        dst.data_ptr(), dst.stride(0), m, g, key[0], key[1], thr,
        dropmask.keep_scale(rate, F32 if f32 else BF16), _stream(x))
    build.check(code, "threefry_mask")
    threefry_mask.launches += 1
    threefry_mask.f32_launches += f32
    return dst


class _MaskDropout(torch.autograd.Function):
    """``_Dropout`` for the threefry masks: ``y * mask`` with the mask of
    ``key`` regenerated by ``threefry_mask`` in the forward and in the
    backward, bit for bit the plain ``y * bernoulli_mask(...)`` and its
    autograd backward."""

    @staticmethod
    def forward(ctx, y, key, rate):
        ctx.mask = (key, rate)
        out = y.clone(memory_format=torch.contiguous_format)
        threefry_mask(out.view(-1, out.shape[-1]), key, rate)
        return out

    @staticmethod
    def backward(ctx, d):
        d = d.clone(memory_format=torch.contiguous_format)
        threefry_mask(d.view(-1, d.shape[-1]), *ctx.mask)
        return d, None, None


def dropout_masks(y, key, rate):
    """Dropout of an NHWC dense-layer output ``y`` with the threefry mask of
    its block key ``key`` through ``threefry_mask`` forward and backward:
    the layer-by-layer kernel path's ``drop_impl="masks"``, equal to ``y *
    ops.threefry.bernoulli_mask(key, y.shape, rate, y.dtype)`` and its
    gradient."""
    return _MaskDropout.apply(y, key, rate)


KERNELS = (drop_mask, threefry_mask)
PLAIN = {drop_mask: drop_mask_plain, threefry_mask: threefry_mask_plain}


def reset_launch_counts() -> None:
    reset_counts(KERNELS)


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def f32_counts() -> dict:
    return count_f32(KERNELS)


for _k in KERNELS:
    _k.f32_launches = 0
reset_launch_counts()
