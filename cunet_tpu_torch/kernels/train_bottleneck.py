"""Train-mode concat-free bottleneck with a recompute backward: TPU kernel
#7 on the H100.

Counterpart of ``cunet_tpu/kernels/train_bottleneck.py``. With
``use_pallas=True, bn_tile=0`` every bottleneck and adapter of the train
forward runs ``fused_train_bottleneck``: BN with whole-batch statistics ->
ReLU -> 1x1 conv over the virtual concat of its features, whose backward
recomputes the normalized activations instead of saving them (activation
memory O(1) in dense-layer count; the reference's
``_EfficientDensenetBottleneckFn``). Four hand-written kernels, each
beside its plain version (``apply`` the table form of
``csrc/buf_kernels.cu``'s ``affine_dot``, the rest in
``csrc/bottleneck_kernels.cu``):

- ``stats``: per-channel float32 sum and sum of squares over all rows;
- ``apply``: relu(x * inv + shift) in float32, rounded to the feature
  dtype, times the weight rounded to it, float32 accumulation (the table
  form of ``buf_ops.affine_dot``'s kernel);
- ``bwd_reduce``: dW = r^T g and the BN sums [sum g_y; sum g_y x_hat] with
  g_y = [y > 0] (g W^T), r and y recomputed from x;
- ``bwd_dx``: the input cotangents, recomputing again.

The features are separate tensors viewed as (M, c_k), M = N*H*W; every
kernel reads them through a feature table in device memory
(``feature_table``) and never builds the concat. The Function fills one
table for the forward's two kernels and one for the backward's two; a
wrapper called without one fills its own. As
in :mod:`cunet_tpu_torch.kernels.train_ops`: on a CPU tensor a wrapper
computes its plain version, on a CUDA tensor it launches its kernel or
raises; ``<wrapper>.launches`` counts its launches and nothing else; the row
reductions write per-block partials that ``train_ops.sum_rows`` adds in a
fixed order.

The arithmetic is the TPU kernel's, which differs from the plain
``ops.bottleneck.dense_bottleneck`` on purpose: a single-pass variance
(``sumsq / M - mean^2``), the forward affine always in float32, and a
backward against the unrounded float32 W^T whose ReLU gate reads
``x_hat * scale + bias``.

Every kernel takes bfloat16 or float32 features (one dtype a call; the
cotangent and the outputs in it too): the float32 forms are the JAX
package's #7 at ``compute_dtype="float32"``, float32 in, float32 products,
float32 out. ``stats``' float32 form sums eight rows at a time in float32
and those partials in float64 (16-byte loads of 4 columns, float64 chunk
partials added and rounded once by a second kernel); ``bwd_reduce``'s
float32 form is a kernel of its own (the cotangent split once into its
three bf16 planes by a pre-pass, ``reduce_plan_f32``), and so is ``bwd_dx``'s
(``csrc/tb_dx_f32_kernels.cu``, ``dx_f32_plan``), which reads the planes
the reduce's pre-pass wrote: the Function hands them over (``planes=``),
so the backward splits g once; ``apply`` is the float32 forward 1x1
of ``csrc/fwd_f32_kernels.cu`` over the features as its feature table
(``buf_ops.launch_fwd_f32``), bit for bit ``affine_dot``'s float32 form
over ``torch.cat(xs, 1)``. ``<wrapper>.f32_launches`` counts the float32
launches (also in ``launches``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence

import torch

from cunet_tpu_torch.kernels import build
from cunet_tpu_torch.kernels.buf_ops import (
    BF16,
    F32,
    SMEM_LIMIT,
    _check_dtypes,
    _check_rows as _check_row_count,
    _check_view,
    _stream,
    _up,
    affine_dot_plan,
    count_f32,
    launch_fwd_f32,
    reset_counts,
)
from cunet_tpu_torch.kernels.train_ops import _check_contig_f32, sum_rows
from cunet_tpu_torch.ops.layers import BN_EPS

ROW_CHUNK = 2048         # most rows per partial of a row reduction
CHUNKS = 32              # partials aimed at where M allows (fills the card)
TABLE_COLS = 6           # x ptr, x row stride, width, offset, dx ptr, dx ld
# bwd_reduce: concat columns of a block and rows of a pipelined step
# (csrc/bottleneck_kernels.cu kRdCols, kRdRows; the float32 form's steps
# kRfRows, also the rows of a tile of its cotangent planes), and the blocks
# it aims at, two on each of the card's 132 SMs (one at float32, whose
# staged float32 x, g's planes and W's take more than half an SM's shared
# memory): a constant, so the chunks (and the order of every sum) depend
# on the shapes alone; the float32 form's outputs a plane tile's half holds
# (csrc kRfN; a cotangent past two halves takes more of them)
REDUCE_COLS = 64
REDUCE_ROWS = 32
REDUCE_BLOCKS = 264
REDUCE_ROWS_F32 = 64
REDUCE_BLOCKS_F32 = 132
REDUCE_N_F32 = 128
# the widest cotangent whose W planes the backward's blocks keep resident
# (csrc/halo.cuh kWideN); past it every backward kernel stages W's planes
# a slice of SLICE_N outputs at a time (kSliceN) from the slice images of
# a pre-pass (split_w_slices), each plane a SLICE_ROWS-row block of the
# slice: (SLICE_N + 8) x SLICE_ROWS bf16 for the bf16 kernels' rows,
# SLICE_N x SLICE_ROWS for the float32 kernels' core matrices
WIDE_N = 256
SLICE_N = 128
SLICE_ROWS = 64
# bwd_dx: rows of a step and concat columns of a block (csrc kDxRows,
# kDxCols; the float32 form's too, kDfRows, kDfCols: its steps are the
# planes' tiles); a table chunk resolved into shared memory (csrc/halo.cuh
# Chunk: a pointer and a row stride)
DX_ROWS = 64
DX_COLS = 64
CHUNK_BYTES = 16


def row_tile(m: int, cap: int = 1024) -> int:
    """The TPU kernel's row tile: the largest multiple of 8 up to ``cap``
    dividing ``m``, 0 if none (the caller then takes the plain path)."""
    best = 0
    t = 8
    while t <= min(m, cap):
        if m % t == 0:
            best = t
        t += 8
    return best


def _widths(xs: Sequence[torch.Tensor]):
    """(offsets, total width) of the virtual concat of ``xs``."""
    offs, off = [], 0
    for x in xs:
        offs.append(off)
        off += x.shape[1]
    return offs, off


def _check_rows(xs, m):
    if not xs or any(x.dim() != 2 or x.shape[0] != m for x in xs):
        raise ValueError(f"features must be (M, c_k) views of {m} rows, got "
                         f"{[tuple(x.shape) for x in xs]}")


def _is_f32(xs) -> bool:
    """Whether the kernels run their float32 form for the features ``xs``
    (all bf16 or all float32; any other dtype raises)."""
    _check_view(xs[0], "features[0]", (BF16, F32))
    _check_dtypes(xs[0], **{f"features[{k}]": x for k, x in enumerate(xs)})
    return xs[0].dtype == F32


def feature_table(xs, dxs=None) -> torch.Tensor:
    """The feature table of the CUDA views ``xs`` (and of their cotangents
    ``dxs``) in device memory: one row of TABLE_COLS int64 per group
    [pointer, row stride, width, column offset, dx pointer, dx row stride],
    written by one fill launch on the current stream. It holds pointers:
    valid while the tensors it was built from live, for those tensors
    only. The features all bf16 or all float32, the cotangents in their
    dtype."""
    offs, _ = _widths(xs)
    _is_f32(xs)
    rows = []
    for k, (x, off) in enumerate(zip(xs, offs)):
        _check_view(x, f"features[{k}]", (x.dtype,))
        dx = (0, 0)
        if dxs is not None:
            _check_view(dxs[k], f"dx[{k}]", (x.dtype,))
            dx = (dxs[k].data_ptr(), dxs[k].stride(0))
        rows.append([x.data_ptr(), x.stride(0), x.shape[1], off, *dx])
    host = torch.tensor(rows, dtype=torch.int64)
    dev = torch.empty(len(xs) * TABLE_COLS, dtype=torch.int64,
                      device=xs[0].device)
    code = build.lib().cunet_tb_fill_table(host.data_ptr(), len(xs),
                                           dev.data_ptr(), _stream(dev))
    build.check(code, "train_bottleneck.feature_table")
    return dev


def _table_of(xs, table):
    """``table`` checked against ``xs``, or a new one for them."""
    if table is None:
        return feature_table(xs)
    if table.device != xs[0].device or table.dtype != torch.int64 \
            or table.numel() != len(xs) * TABLE_COLS:
        raise ValueError(f"feature table {table.dtype} {tuple(table.shape)} "
                         f"on {table.device} does not fit {len(xs)} groups "
                         f"on {xs[0].device}")
    return table


def row_chunk(m: int) -> int:
    """Rows per partial of a row reduction over M rows: M / CHUNKS rounded
    up to a multiple of 64, within [64, ROW_CHUNK], so a small M still
    spreads over enough blocks. A function of M alone: the same call sums
    in the same order every time."""
    return min(ROW_CHUNK, max(64, -(-m // (64 * CHUNKS)) * 64))


def _partials(m, *shape, device, dtype=torch.float32):
    return torch.empty(-(-m // row_chunk(m)), *shape, device=device,
                       dtype=dtype)


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------


def stats_plain(xs, out, table=None):
    offs, _ = _widths(xs)
    for x, off in zip(xs, offs):
        x32 = x.float()
        out[0, off:off + x.shape[1]] = x32.sum(dim=0)
        out[1, off:off + x.shape[1]] = (x32 * x32).sum(dim=0)
    return out


def stats(xs, out, table=None):
    """``out`` (2, Ctot) float32 = [sum; sum of squares] over the M rows of
    each column of the virtual concat of ``xs`` ((M, c_k) views), read
    through ``table`` (``feature_table(xs)``, filled here when None; the
    plain versions take and ignore it).

    Replaces ``cunet_tpu/kernels/train_bottleneck.py::_stats_kernel``.
    Bound by reading the features once (62.9 MB at K=320, M=98,304: 18.8 us
    on the H100; 125.8 MB at float32: 37.6 us). Design: one block per
    (chunk of ``row_chunk(M)`` rows, 64 columns), 32 row stripes of 16-byte
    loads per 8 columns, a fixed-order reduction in shared memory, the
    chunk partials added by ``sum_rows``. Float32 features: 16 stripes per
    4 columns, eight rows a thread summed in float32 and added into
    float64, the stripes and the chunks' float64 partials (the latter by a
    second kernel, in order) in float64 and rounded once, so the
    single-pass variance E[x^2] - mean^2 loses little more than that
    rounding (float32 running sums lost up to ~5 ulp, which the variance
    multiplies by mean^2 / var). A float32 call launches two kernels and
    counts both (``launches``, ``f32_launches``).
    """
    m = xs[0].shape[0]
    _check_rows(xs, m)
    ctot = _widths(xs)[1]
    if tuple(out.shape) != (2, ctot):
        raise ValueError(f"stats out {tuple(out.shape)}, expected (2, {ctot})")
    if xs[0].device.type == "cpu":
        return stats_plain(xs, out)
    _check_contig_f32(out, "out", xs[0].device)
    f32 = _is_f32(xs)
    table = _table_of(xs, table)
    if f32:
        part = _partials(m, 2, ctot, device=out.device, dtype=torch.float64)
        code = build.lib().cunet_tb_stats_f32(
            table.data_ptr(), len(xs), m, ctot, row_chunk(m),
            part.data_ptr(), out.data_ptr(), _stream(out))
    else:
        part = _partials(m, 2, ctot, device=out.device)
        code = build.lib().cunet_tb_stats(table.data_ptr(), len(xs), m, ctot,
                                          row_chunk(m), part.data_ptr(),
                                          _stream(out))
    build.check(code, "train_bottleneck.stats")
    # a float32 call launches two kernels, the chunks' sums and their total
    stats.launches += 1 + f32
    stats.f32_launches += 2 * f32
    return out if f32 else sum_rows(part, out)


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def apply_plain(xs, vec, w, out, table=None):
    offs, _ = _widths(xs)
    acc = None
    for x, off in zip(xs, offs):
        c = x.shape[1]
        y = torch.relu(x.float() * vec[0, off:off + c] + vec[1, off:off + c])
        part = y.to(x.dtype).float() @ w[off:off + c].float()
        acc = part if acc is None else acc + part
    out.copy_(acc.to(out.dtype))
    return out


def apply_smem(p) -> int:
    """Shared memory of ``apply``'s launch on ``affine_dot``'s plan ``p``:
    the plan's, then the K / 8 table chunks the block resolves."""
    return p.smem + p.kp // 8 * CHUNK_BYTES


def apply(xs, vec, w, out, table=None):
    """``out`` (M, Cout) = sum_k bf16(relu(x_k * inv_k + shift_k)) @ w_k,
    ``vec`` the (2, Ctot) float32 [inv; shift], the affine in float32, ``w``
    the (Ctot, Cout) weight already rounded to the feature dtype, float32
    accumulation, one rounding of the result to ``out``'s dtype; ``table``
    as in ``stats``.

    Replaces ``cunet_tpu/kernels/train_bottleneck.py::_apply_kernel``.
    Bound by reading the features and writing out (88 MB at K=320 -> 128,
    M=98,304: 26.3 us). Design: ``affine_dot``'s kernel in its table form
    (``csrc/buf_kernels.cu``, plan ``affine_dot_plan(M, Ctot, Cout)``): the
    block resolves the table once into shared memory, one (pointer, row
    stride) per 8-column chunk, and its 16-byte ``cp.async`` copies read
    each chunk from its group's tensor; the resident weight, the prologue,
    the ``mma.sync`` products and the epilogue are ``affine_dot``'s, so the
    result is ``affine_dot`` over ``torch.cat(xs, 1)`` bit for bit. Counted
    here, not in ``buf_ops.affine_dot.launches``.

    Float32 features, ``w`` and ``out``: the float32 forward 1x1 of
    ``csrc/fwd_f32_kernels.cu`` (plan ``buf_ops.fwd_f32_plan(Ctot,
    Cout)``) with the features as its feature table (any number of groups;
    ``table`` is not read), the prologue unrounded, six bf16 plane products
    a k16 step on ``wgmma``: ``affine_dot``'s float32 form over
    ``torch.cat(xs, 1)`` bit for bit. Bound at K=320 -> 128, M=98,304 by
    its float32 bytes (176 MB: 52.6 us); its six bf16 passes take 48.8 us,
    the same product as float32 FMA 120 us.
    """
    m = xs[0].shape[0]
    _check_rows(xs, m)
    ctot = _widths(xs)[1]
    n = w.shape[1]
    if tuple(w.shape) != (ctot, n) or tuple(out.shape) != (m, n) \
            or tuple(vec.shape) != (2, ctot):
        raise ValueError(f"apply shapes: Ctot {ctot}, vec "
                         f"{tuple(vec.shape)}, w {tuple(w.shape)}, out "
                         f"{tuple(out.shape)}")
    if xs[0].device.type == "cpu":
        return apply_plain(xs, vec, w, out)
    f32 = _is_f32(xs)
    dt = xs[0].dtype
    _check_view(w, "w", (dt,))
    _check_view(out, "out", (dt,))
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")
    _check_contig_f32(vec, "vec", out.device)
    _check_row_count(m)
    if f32:
        return _apply_f32(xs, vec, w, out)
    table = _table_of(xs, table)
    p = affine_dot_plan(m, ctot, n)
    smem = apply_smem(p)
    if smem > SMEM_LIMIT:
        raise ValueError(f"apply: K={ctot}, N={n} with its table chunks "
                         f"needs {smem} bytes of shared memory")
    code = build.lib().cunet_tb_apply(
        table.data_ptr(), len(xs), m, ctot, vec[0].data_ptr(),
        vec[1].data_ptr(), w.data_ptr(), n, out.data_ptr(), out.stride(0),
        p.bm, p.ncol, p.ngrp, p.ntw, p.kp, p.stages, p.w_bytes,
        p.stage_bytes, p.out_off, p.kc, smem, _stream(out))
    build.check(code, "train_bottleneck.apply")
    apply.launches += 1
    return out


def _apply_f32(xs, vec, w, out):
    """``apply``'s float32 form: the float32 forward 1x1 over the feature
    groups ``xs`` (checked by ``apply``)."""
    for k, x in enumerate(xs):
        _check_view(x, f"features[{k}]", (F32,))
    code = launch_fwd_f32(list(xs), xs[0].shape[0], vec, w, out)
    build.check(code, "train_bottleneck.apply (float32)")
    apply.launches += 1
    apply.f32_launches += 1
    return out


# ---------------------------------------------------------------------------
# backward: bwd_reduce and bwd_dx
# ---------------------------------------------------------------------------


def _recompute(x, stat, bias, off):
    """(x_hat, y) of one group from its forward statistics, one rounding
    per operation: x_hat = (x - mean) * inv_sigma, y = x_hat * scale +
    bias."""
    c = x.shape[1]
    xh = (x.float() - stat[0, off:off + c]) * stat[1, off:off + c]
    return xh, xh * stat[2, off:off + c] + bias[off:off + c]


def split_planes_plain(g, planes):
    """The float32 reduce's pre-pass in torch: g (M, N) float32 split
    exactly into three bf16 planes (p1 = bf16(g), p2 = bf16(g - p1), p3 =
    bf16(g - p1 - p2), each rounding to nearest even as the kernel's
    ``split3``) in ``split_planes_shape``'s layout, written into
    ``planes``: per 64-row tile and half of 128 outputs, core matrices of
    8 outputs x 8 rows (one output's 8 consecutive rows a 16-byte row),
    core matrix (n / 8, m / 8) at element ((n / 8) * 8 + m / 8) * 64, zero
    past M and N."""
    m, n = g.shape
    _, tiles, per = planes.shape
    halves = per // (REDUCE_N_F32 * REDUCE_ROWS_F32)
    gp = torch.zeros(tiles * REDUCE_ROWS_F32, halves * REDUCE_N_F32,
                     device=g.device)
    gp[:m, :n] = g
    p1 = gp.bfloat16()
    r1 = gp - p1.float()
    p2 = r1.bfloat16()
    for k, pk in enumerate((p1, p2, (r1 - p2.float()).bfloat16())):
        planes[k] = pk.view(tiles, 8, 8, halves, 16, 8).permute(
            0, 3, 4, 1, 5, 2).reshape(tiles, per)
    return planes


def bwd_reduce_plain(xs, g, stat, bias, w, dw, sums, table=None,
                     planes=None):
    if planes is not None:
        split_planes_plain(g, planes)
    offs, _ = _widths(xs)
    g32 = g.float()
    for x, off in zip(xs, offs):
        c = x.shape[1]
        xh, y = _recompute(x, stat, bias, off)
        dw[off:off + c] = torch.relu(y).t() @ g32
        gy = torch.where(y > 0, g32 @ w[off:off + c].t(), 0.0)
        sums[0, off:off + c] = gy.sum(dim=0)
        sums[1, off:off + c] = (gy * xh).sum(dim=0)
    return dw, sums


@dataclasses.dataclass(frozen=True)
class ReducePlan:
    """How ``bwd_reduce``'s kernel cuts M rows and Ctot concat columns into
    blocks (bf16 features): ``chunks`` row chunks of ``chunk`` rows (the
    last shorter) x ``col_blocks`` blocks of ``REDUCE_COLS`` columns, each
    chunk walked in steps of ``REDUCE_ROWS`` rows; the outputs zero-padded
    to ``np``; shared memory: the three W planes at 0, the columns' BN
    constants at ``stat_off``, ``stages`` x / g buffers of ``stage_bytes``
    from ``stage_off`` (g at ``g_off`` within one), r's three planes at
    ``pl_off``, the gated x_hat at ``xh_off``; ``smem`` bytes in all."""
    chunk: int
    chunks: int
    col_blocks: int
    np: int
    stages: int
    stat_off: int
    stage_off: int
    stage_bytes: int
    g_off: int
    pl_off: int
    xh_off: int
    smem: int
    w_off: int = 0

    def rows(self, s: int, m: int) -> range:
        return range(s * self.chunk, min(m, (s + 1) * self.chunk))


def slice_images(k: int, n: int, core: bool) -> int:
    """Elements (bf16) of the pre-pass's W slice images for a (K, N) W:
    ceil(K / SLICE_ROWS) row blocks x ceil(N / SLICE_N) slices x three
    planes."""
    plane = SLICE_ROWS * (SLICE_N if core else SLICE_N + 8)
    return -(-k // SLICE_ROWS) * -(-n // SLICE_N) * 3 * plane


@functools.lru_cache(maxsize=None)
def reduce_plan(m: int, ctot: int, n: int) -> ReducePlan:
    """The kernel plan of ``bwd_reduce`` over bf16 features at these shapes
    (a function of them alone; cached): chunks of whole steps, as many as
    give ``REDUCE_BLOCKS`` blocks with the column blocks; two x / g stages
    where they fit in ``SMEM_LIMIT``, else one (more stages measured no
    faster). Past ``WIDE_N`` outputs the grid's z takes the dW slices of
    ``SLICE_N`` outputs, each stage a slice of g's rows and (block z = 0)
    W's planes at ``w_off``, two stages."""
    np_ = _up(n, 16)
    col_blocks = -(-ctot // REDUCE_COLS)
    want = max(1, REDUCE_BLOCKS // col_blocks)
    chunk = _up(-(-m // want), REDUCE_ROWS)
    if np_ > WIDE_N:
        gs = (SLICE_N + 8) * 2
        stage_off = 4 * REDUCE_COLS * 4
        g_off = REDUCE_ROWS * (REDUCE_COLS * 2 + 16)
        w_off = _up(g_off + REDUCE_ROWS * gs, 128)
        stage_bytes = _up(w_off + 3 * REDUCE_COLS * gs, 128)
        pl_off = stage_off + 2 * stage_bytes
        xh_off = pl_off + 3 * REDUCE_ROWS * (REDUCE_COLS + 8) * 2
        return ReducePlan(chunk=chunk, chunks=-(-m // chunk),
                          col_blocks=col_blocks, np=np_, stages=2,
                          stat_off=0, stage_off=stage_off,
                          stage_bytes=stage_bytes, g_off=g_off,
                          pl_off=pl_off, xh_off=xh_off,
                          smem=xh_off + REDUCE_ROWS * (REDUCE_COLS + 8) * 4,
                          w_off=w_off)
    gs = (np_ + 8) * 2                        # bytes of a g / W-plane row
    xs = (REDUCE_COLS + 8) * 2                # bytes of an r-plane row
    stat_off = 3 * REDUCE_COLS * gs
    stage_off = stat_off + 4 * REDUCE_COLS * 4
    g_off = REDUCE_ROWS * (REDUCE_COLS * 2 + 16)
    stage_bytes = _up(g_off + REDUCE_ROWS * (np_ * 2 + 16), 128)
    for stages in (2, 1):
        pl_off = stage_off + stages * stage_bytes
        xh_off = pl_off + 3 * REDUCE_ROWS * xs
        smem = xh_off + REDUCE_ROWS * (REDUCE_COLS + 8) * 4
        if smem <= SMEM_LIMIT:
            return ReducePlan(chunk=chunk, chunks=-(-m // chunk),
                              col_blocks=col_blocks, np=np_, stages=stages,
                              stat_off=stat_off, stage_off=stage_off,
                              stage_bytes=stage_bytes, g_off=g_off,
                              pl_off=pl_off, xh_off=xh_off, smem=smem)
    raise ValueError(f"bwd_reduce: {n} outputs do not fit {SMEM_LIMIT} "
                     f"bytes of shared memory")


@dataclasses.dataclass(frozen=True)
class ReduceF32Plan:
    """How ``bwd_reduce``'s float32 kernel cuts M rows and Ctot concat
    columns: ``chunks`` row chunks of ``chunk`` rows (the last shorter) x
    ``col_blocks`` blocks of ``REDUCE_COLS`` columns, each chunk walked in
    steps of ``REDUCE_ROWS_F32`` rows, two buffers; g's planes from the
    pre-pass (``split_planes_shape``) in ``halves`` halves of
    ``REDUCE_N_F32`` outputs (two past 128: the grid's z, each block the
    dW of its half), the outputs zero-padded to ``np``; shared memory
    (``csrc/bottleneck_kernels.cu::rf_layout``): W's three planes in core
    matrices (``wpl`` bytes each) at 0, the buffers of ``stage_bytes``
    from ``stage_off`` (x rows of REDUCE_COLS + 4 floats, then g's three
    plane tiles at ``g_off``, past ``WIDE_N`` outputs W's slice planes at
    ``sw_off`` in place of resident ones (``wpl`` 0); the first also the
    sums' reduction after the last step), the columns' BN constants at
    ``stat_off``; ``smem`` bytes in all."""
    chunk: int
    chunks: int
    col_blocks: int
    np: int
    halves: int
    wpl: int
    stage_off: int
    g_off: int
    stage_bytes: int
    stat_off: int
    smem: int
    sw_off: int = 0

    def rows(self, s: int, m: int) -> range:
        return range(s * self.chunk, min(m, (s + 1) * self.chunk))

    def steps(self, s: int, m: int) -> list:
        r = self.rows(s, m)
        return [range(a, min(r.stop, a + REDUCE_ROWS_F32))
                for a in range(r.start, r.stop, REDUCE_ROWS_F32)]


@functools.lru_cache(maxsize=None)
def reduce_plan_f32(m: int, ctot: int, n: int) -> ReduceF32Plan:
    """The kernel plan of ``bwd_reduce`` over float32 features at these
    shapes (a function of them alone; cached): chunks of whole 64-row
    steps, as many as give ``REDUCE_BLOCKS_F32`` blocks (one an SM) with
    the column blocks (of each output half). Past ``WIDE_N`` outputs W's
    planes are staged a half at a time beside g's (exactly the card's
    shared memory)."""
    np_ = _up(n, 16)
    stream = np_ > WIDE_N
    col_blocks = -(-ctot // REDUCE_COLS)
    want = max(1, REDUCE_BLOCKS_F32 // col_blocks)
    chunk = _up(-(-m // want), REDUCE_ROWS_F32)
    wpl = 0 if stream else REDUCE_COLS * np_ * 2
    stage_off = _up(3 * wpl, 128)
    g_off = REDUCE_ROWS_F32 * (REDUCE_COLS + 4) * 4
    plane = REDUCE_ROWS_F32 * REDUCE_N_F32 * 2
    stage_bytes = _up(g_off + (6 if stream else 3) * plane, 128)
    stat_off = stage_off + 2 * stage_bytes
    smem = stat_off + 4 * REDUCE_COLS * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"bwd_reduce at float32: {n} outputs do not fit "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return ReduceF32Plan(chunk=chunk, chunks=-(-m // chunk),
                         col_blocks=col_blocks, np=np_,
                         halves=-(-np_ // REDUCE_N_F32), wpl=wpl,
                         stage_off=stage_off, g_off=g_off,
                         stage_bytes=stage_bytes, stat_off=stat_off,
                         smem=smem,
                         sw_off=g_off + 3 * plane if stream else 0)


def split_planes_shape(m: int, n: int):
    """The shape of the float32 reduce's cotangent planes (bf16) for N
    outputs: three planes of ceil(M / 64) tiles, each of ceil(N / 128)
    halves (slices past two) of 16 x 8 core matrices of 8 outputs x 8
    rows."""
    halves = -(-_up(n, 16) // REDUCE_N_F32)
    return (3, -(-m // REDUCE_ROWS_F32),
            halves * REDUCE_N_F32 * REDUCE_ROWS_F32)


def _check_bwd(xs, g, stat, bias, w, m, ctot):
    """The backward's shapes; on the card its operands, and whether the
    features (and ``g``, in their dtype) are float32."""
    n = g.shape[1]
    if tuple(g.shape) != (m, n) or tuple(w.shape) != (ctot, n) \
            or tuple(stat.shape) != (3, ctot) or tuple(bias.shape) != (ctot,):
        raise ValueError(f"backward shapes: Ctot {ctot}, g {tuple(g.shape)}, "
                         f"w {tuple(w.shape)}, stat {tuple(stat.shape)}, bias "
                         f"{tuple(bias.shape)}")
    if g.device.type == "cpu":
        return False
    dev = g.device
    f32 = _is_f32(xs)
    _check_view(g, "g", (xs[0].dtype,))
    for t, name in ((stat, "stat"), (bias, "bias"), (w, "w")):
        _check_contig_f32(t, name, dev)
    return f32


def bwd_reduce(xs, g, stat, bias, w, dw, sums, table=None, planes=None):
    """The reductions of the backward over all M rows, for features ``xs``,
    the output cotangent ``g`` (M, Cout), ``stat`` (3, Ctot) float32
    [mean; inv_sigma; scale], ``bias`` (Ctot,) and the float32 weight ``w``
    (Ctot, Cout), unrounded: ``dw`` (Ctot, Cout) = relu(y)^T g and ``sums``
    (2, Ctot) = [sum g_y; sum g_y * x_hat], with x_hat = (x - mean) *
    inv_sigma, y = x_hat * scale + bias, g_y = [y > 0] (g @ w^T), all in
    float32; ``table`` as in ``stats`` (its dx columns unused). At float32
    ``planes`` (bf16, ``split_planes_shape(M, Cout)``) receives g's three
    planes, which ``bwd_dx(..., planes=)`` then reads (the plain version
    writes them with ``split_planes_plain``); without it the call makes
    its own.

    Replaces ``cunet_tpu/kernels/train_bottleneck.py::_bwd_reduce_kernel``.
    Design (``csrc/bottleneck_kernels.cu``, plan ``reduce_plan``): one kind
    of block per (row chunk, 64 concat columns), two blocks an SM; both
    products on the tensor cores (mma.sync, f32 sums), float32-exact
    through the exact split of their float32 operand (relu(y) for dW, W
    for g W^T; a bf16 g needs none) into three bf16 pieces, so they agree
    with float32 FMA to float32 rounding. The block splits its W rows once
    into shared memory; stages each 32-row step's x vectors (through the
    feature table) and g rows by cp.async, the next step loading during
    this one; recomputes x_hat and y once per element (the plain version's
    rounding, so the gate is the same bit for bit); keeps its dW partial in
    registers and takes the gate and the two sums on the g W^T tile in
    registers. ``sum_rows`` adds the chunk partials in order. Bounds at
    K=320 -> 128, M=98,304: float32 FMA on the CUDA cores 240 us (4 M Ctot
    Cout flops at 67 TFLOP/s); the kernel's own six bf16 passes of
    2 M Ctot Cout 49 us (48.3 GFLOP at 989 TFLOP/s; 88 MB of x and g take
    26 us). Measured there on an H100 80GB HBM3 at 700 W (PERF.md section
    6, PR 9): 209 us with its ``sum_rows`` (the SIMT kernel before it:
    800), 12.6 us at r=4.

    Float32 features and g (``reduce_plan_f32``): a pre-pass splits g
    once into its three bf16 planes in device memory (where the column
    blocks would each split it again), in 64-row tiles of 8 x 8 core
    matrices; then blocks of two warpgroups, one an SM, walk 64-row steps:
    x vectors and g's plane tiles by cp.async a step ahead; both products
    on ``wgmma``. One warpgroup takes g W^T over the step's 64 x 64 tile
    (g's planes by ldmatrix, W's by a shared-memory descriptor; per
    element ``bwd_dx``'s order, which ``wgmma`` sums to ``mma.sync``'s
    bits, so it gates the same g_y) with the gate and the two sums on the
    accumulators, x_hat and y recomputed from the staged x; the other
    takes dW (m64n128k16: r^T built in registers from the staged x, g's
    plane tile by a descriptor), each k16 row group's six plane products
    in a fragment of its own joined by one float32 add. Twelve bf16
    passes in all (96.6 GFLOP: 97.7 us at 989 TFLOP/s at K=320 -> 128,
    M=98,304). Past 128 outputs g's planes come in halves (slices past
    two) and the grid's z takes dW a half each; one block of each column
    block takes g W^T and the sums over every half. The call launches two
    kernels and counts both (``launches``, ``f32_launches``).

    Past ``WIDE_N`` outputs (either dtype) no block keeps W's planes
    resident: a pre-pass (``csrc/halo.cuh`` ``split_w_slices``, a launch
    of its own, counted) splits W once into slice images of ``SLICE_N``
    outputs, and each item of a step stages its slice of W beside its
    slice of g; the grid's z takes dW a slice each (bf16: ``reduce_plan``,
    two stages), one accumulator of g W^T carried across the slices in
    ``bwd_dx``'s order. Measured there on an H100 80GB HBM3 at 700 W
    (PERF.md section 6): 1.6-1.7 ms at N = 512, r=64 (bound 195 / 391
    us), against 0.21 / 0.23 at 128.
    """
    m = xs[0].shape[0]
    _check_rows(xs, m)
    ctot = _widths(xs)[1]
    f32 = _check_bwd(xs, g, stat, bias, w, m, ctot)
    n = g.shape[1]
    if tuple(dw.shape) != (ctot, n) or tuple(sums.shape) != (2, ctot):
        raise ValueError(f"bwd_reduce outputs: dw {tuple(dw.shape)}, sums "
                         f"{tuple(sums.shape)}")
    if g.device.type == "cpu":
        return bwd_reduce_plain(xs, g, stat, bias, w, dw, sums,
                                planes=planes)
    _check_contig_f32(dw, "dw", g.device)
    _check_contig_f32(sums, "sums", g.device)
    table = _table_of(xs, table)
    planes = _planes_of(planes, f32, m, n, g.device)
    p = reduce_plan_f32(m, ctot, n) if f32 else reduce_plan(m, ctot, n)
    dw_part = torch.empty(p.chunks, ctot, n, device=g.device,
                          dtype=torch.float32)
    sums_part = torch.empty(p.chunks, 2, ctot, device=g.device,
                            dtype=torch.float32)
    wide = p.np > WIDE_N
    ws = _slices_of(wide, ctot, n, f32, g.device)
    if f32:
        code = build.lib().cunet_tb_bwd_reduce_f32(
            table.data_ptr(), len(xs), m, ctot, g.data_ptr(), g.stride(0), n,
            stat.data_ptr(), bias.data_ptr(), w.data_ptr(),
            planes.data_ptr(), _ptr(ws), p.chunk, p.np, p.smem,
            dw_part.data_ptr(), sums_part.data_ptr(), _stream(g))
    else:
        code = build.lib().cunet_tb_bwd_reduce(
            table.data_ptr(), len(xs), m, ctot, g.data_ptr(), g.stride(0), n,
            stat.data_ptr(), bias.data_ptr(), w.data_ptr(), _ptr(ws),
            p.chunk, p.np, p.stages, p.stat_off, p.stage_off, p.stage_bytes,
            p.g_off, p.pl_off, p.xh_off, p.w_off, p.smem, dw_part.data_ptr(),
            sums_part.data_ptr(), _stream(g))
    build.check(code, "train_bottleneck.bwd_reduce")
    # a float32 call launches two kernels, the split of g and the reduce;
    # past WIDE_N outputs one more, the split of W into its slices
    bwd_reduce.launches += (2 if f32 else 1) + wide
    bwd_reduce.f32_launches += (2 + wide) if f32 else 0
    sum_rows(dw_part, dw)
    sum_rows(sums_part, sums)
    return dw, sums


def bwd_dx_plain(xs, g, stat, bias, red, w, dxs, table=None, planes=None):
    offs, _ = _widths(xs)
    g32 = g.float()
    for x, dx, off in zip(xs, dxs, offs):
        c = x.shape[1]
        xh, y = _recompute(x, stat, bias, off)
        gy = torch.where(y > 0, g32 @ w[off:off + c].t(), 0.0)
        v = stat[2, off:off + c] * stat[1, off:off + c] * (
            gy - red[0, off:off + c] - xh * red[1, off:off + c])
        dx.copy_(v.to(dx.dtype))
    return dxs


@dataclasses.dataclass(frozen=True)
class DxPlan:
    """How ``bwd_dx``'s kernel cuts M rows and Ctot concat columns (bf16
    features): ``ngrp`` column groups of ``DX_COLS``, each kept by the
    persistent blocks b with b % ngrp == group, which walk steps of
    ``DX_ROWS`` rows b // ngrp, + grid // ngrp, ...; the outputs (the
    product's depth) zero-padded to ``np``; shared memory: the group's
    three W planes at 0, its x then dx table chunks at ``tbl_off``, two x
    / g stages of ``stage_bytes`` from ``stage_off`` (g at ``g_off``
    within one; past ``WIDE_N`` outputs a step's slices of ``SLICE_N``
    are items of their own, each stage a slice of g's rows and of W's
    planes, at ``w_off``, none resident); ``smem`` bytes in all."""
    ngrp: int
    np: int
    tbl_off: int
    stage_off: int
    stage_bytes: int
    g_off: int
    smem: int
    w_off: int = 0

    def steps(self, m: int) -> int:
        return -(-m // DX_ROWS)

    def items(self, m: int) -> int:
        return self.steps(m) * self.ngrp


@functools.lru_cache(maxsize=None)
def dx_plan(m: int, ctot: int, n: int) -> DxPlan:
    """The kernel plan of ``bwd_dx`` over bf16 features at these shapes (a
    function of them alone; cached): 64-column groups, 64-row steps, two
    stages. At N <= 128 a block fits in ``buf_ops.SMEM_PAIR`` and two share
    an SM; past ``WIDE_N`` W's planes are staged a slice at a time."""
    np_ = _up(n, 16)
    if np_ > WIDE_N:
        gs = (SLICE_N + 8) * 2
        stage_off = _up(2 * (DX_COLS // 8) * CHUNK_BYTES, 128)
        g_off = _up(DX_ROWS * (DX_COLS * 2 + 16), 128)
        w_off = _up(g_off + DX_ROWS * gs, 128)
        stage_bytes = _up(w_off + 3 * DX_COLS * gs, 128)
        return DxPlan(ngrp=-(-ctot // DX_COLS), np=np_, tbl_off=0,
                      stage_off=stage_off, stage_bytes=stage_bytes,
                      g_off=g_off, smem=stage_off + 2 * stage_bytes,
                      w_off=w_off)
    gs = (np_ + 8) * 2                        # bytes of a g / W-plane row
    tbl_off = 3 * DX_COLS * gs
    stage_off = _up(tbl_off + 2 * (DX_COLS // 8) * CHUNK_BYTES, 128)
    g_off = _up(DX_ROWS * (DX_COLS * 2 + 16), 128)
    stage_bytes = _up(g_off + DX_ROWS * (np_ * 2 + 16), 128)
    smem = stage_off + 2 * stage_bytes
    if smem > SMEM_LIMIT:
        raise ValueError(f"bwd_dx: {n} outputs do not fit {SMEM_LIMIT} "
                         f"bytes of shared memory")
    return DxPlan(ngrp=-(-ctot // DX_COLS), np=np_, tbl_off=tbl_off,
                  stage_off=stage_off, stage_bytes=stage_bytes, g_off=g_off,
                  smem=smem)


@dataclasses.dataclass(frozen=True)
class DxF32Plan:
    """How ``bwd_dx``'s float32 kernel cuts M rows and Ctot concat
    columns: ``ngrp`` column groups of ``DX_COLS``, each kept by the
    persistent blocks b with b % ngrp == group (one an SM), which walk
    steps of ``DX_ROWS`` rows b // ngrp, + grid // ngrp, ..., its two
    warpgroups taking every other one; a step is one tile of g's planes,
    taken in its ``halves`` halves of ``REDUCE_N_F32`` outputs; the
    outputs zero-padded to ``np``; shared memory
    (``csrc/tb_dx_f32_kernels.cu::df_layout``): the group's three W planes
    in core matrices (``wpl`` bytes each) at 0, each warpgroup's g stage
    (a half's three planes) from ``g_off`` and x stage (a step's rows)
    from ``x_off``, past ``WIDE_N`` outputs each warpgroup's W stage (its
    half's slice of W's planes, ``wpl`` 0) from ``sw_off``, the columns'
    BN constants at ``kon_off`` (32 bytes a column), the x then dx table
    chunks at ``ch_off``; ``smem`` bytes in all."""
    ngrp: int
    np: int
    halves: int
    wpl: int
    g_off: int
    x_off: int
    kon_off: int
    ch_off: int
    smem: int
    sw_off: int = 0

    def steps(self, m: int) -> int:
        return -(-m // DX_ROWS)

    def items(self, m: int) -> int:
        return self.steps(m) * self.ngrp


@functools.lru_cache(maxsize=None)
def dx_f32_plan(m: int, ctot: int, n: int) -> DxF32Plan:
    """The kernel plan of ``bwd_dx`` over float32 features at these shapes
    (a function of them alone; cached): 64-column groups, 64-row steps,
    each warpgroup's g stage a half of g's plane tile; past ``WIDE_N``
    outputs W's planes staged beside it, a half at a time."""
    np_ = _up(n, 16)
    stream = np_ > WIDE_N
    plane = REDUCE_N_F32 * DX_ROWS * 2
    wpl = 0 if stream else DX_COLS * np_ * 2
    g_off = 3 * wpl
    x_off = g_off + 2 * 3 * plane
    sw_off = x_off + 2 * DX_ROWS * DX_COLS * 4
    kon_off = sw_off + (2 * 3 * plane if stream else 0)
    ch_off = kon_off + DX_COLS * 32
    p = DxF32Plan(ngrp=-(-ctot // DX_COLS), np=np_,
                  halves=-(-np_ // REDUCE_N_F32), wpl=wpl, g_off=g_off,
                  x_off=x_off, kon_off=kon_off, ch_off=ch_off,
                  smem=ch_off + 2 * (DX_COLS // 8) * CHUNK_BYTES,
                  sw_off=sw_off if stream else 0)
    if p.smem > SMEM_LIMIT:
        raise ValueError(f"bwd_dx at float32: {n} outputs do not fit "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return p


def _slices_of(wide, k, n, f32, device):
    """The scratch for the pre-pass's W slice images of a (K, N) weight
    past ``WIDE_N`` outputs (core matrices at float32), or None."""
    if not wide:
        return None
    return torch.empty(slice_images(k, n, f32), device=device, dtype=BF16)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _planes_of(planes, f32, m, n, device):
    """``planes`` checked against the float32 backward's g planes of M
    rows and N outputs, or new ones (None at bf16, which takes none)."""
    if not f32:
        if planes is not None:
            raise ValueError("g's planes are the float32 backward's; bf16 "
                             "features take none")
        return None
    shape = split_planes_shape(m, n)
    if planes is None:
        return torch.empty(shape, device=device, dtype=BF16)
    if tuple(planes.shape) != shape or planes.dtype != BF16 \
            or planes.device != device or not planes.is_contiguous():
        raise ValueError(f"planes {planes.dtype} {tuple(planes.shape)} on "
                         f"{planes.device}: expected contiguous bf16 "
                         f"{shape} on {device}")
    return planes


def bwd_dx(xs, g, stat, bias, red, w, dxs, table=None, planes=None):
    """The input cotangents ``dxs`` ((M, c_k) views, each in its feature's
    dtype): scale * inv_sigma * (g_y - red[0] - x_hat * red[1]) with
    ``red`` (2, Ctot) = [mean g_y; mean g_y * x_hat] (``bwd_reduce``'s sums
    over M) and the rest as in ``bwd_reduce``; ``table`` is
    ``feature_table(xs, dxs)``, filled here when None. At float32
    ``planes`` are g's three planes from ``bwd_reduce(..., planes=)``;
    without them the call splits g first with the reduce's pre-pass (a
    launch of its own, counted here).

    Replaces ``cunet_tpu/kernels/train_bottleneck.py::_bwd_dx_kernel``.
    Bound at K=320 -> 128, M=98,304 by bytes: reading x and g and writing
    dx once, 151 MB in 45 us (the kernel's three bf16 passes of 2 M Ctot
    Cout take 24 us; the same product as float32 FMA on the CUDA cores
    120 us). Design (``csrc/bottleneck_kernels.cu``, plan ``dx_plan``):
    persistent blocks, two an SM, each keeping one group of 64 concat
    columns (its W rows split once into three bf16 planes in shared
    memory, its x and dx chunks resolved from the table once) and walking
    64-row steps beside the blocks of the other groups, so g comes from
    HBM about once; x and g by ``cp.async`` a step ahead; g W^T on the
    tensor cores, float32-exact through the split, in ``bwd_reduce``'s
    order (so the gate takes the bits ``bwd_reduce`` summed); the
    recompute, gate and BN jacobian on the accumulators, each dx rounded
    in shared memory and written as 16-byte rows into its group's tensor.

    Float32 features, g and dx (``csrc/tb_dx_f32_kernels.cu``, plan
    ``dx_f32_plan``): g W^T on ``wgmma`` from g's planes (never split in
    a block) and W's, six plane products a k16 step in the float32
    reduce's instruction order, so the gate takes its g_y bit for bit;
    persistent blocks of 64 concat columns, one an SM, whose two
    warpgroups take alternate 64-row steps (one's epilogue beside the
    other's products), each with its own g stage (a half of the step's
    planes, by ``cp.async`` as soon as its products have read the last)
    and x stage; dx in place of the staged x, out as 16-byte rows. Past
    128 outputs the planes come in halves (slices past two), past
    ``WIDE_N`` each warpgroup staging W's slice beside g's (slice images
    that this call's own launch of ``bwd_reduce``'s W pre-pass writes,
    counted: a wide backward splits W twice; bf16:
    ``dx_plan``, a step's slices items of their own, one accumulator
    across them). Bound by its float32 bytes
    (302 MB: 90.2 us; the planes it reads make it 327 MB); its six bf16
    passes take 48.8 us, float32 FMA 120 us. Measured there on an H100
    80GB HBM3 at 700 W (PERF.md section 6): 163 us on the handed
    planes (the kernel before it: 282), 214 us called alone.
    """
    m = xs[0].shape[0]
    _check_rows(xs, m)
    ctot = _widths(xs)[1]
    f32 = _check_bwd(xs, g, stat, bias, w, m, ctot)
    if tuple(red.shape) != (2, ctot) or len(dxs) != len(xs) \
            or any(tuple(d.shape) != tuple(x.shape) for d, x in zip(dxs, xs)):
        raise ValueError(f"bwd_dx shapes: red {tuple(red.shape)}, dx "
                         f"{[tuple(d.shape) for d in dxs]}")
    if g.device.type == "cpu":
        return bwd_dx_plain(xs, g, stat, bias, red, w, dxs)
    _check_contig_f32(red, "red", g.device)
    _check_row_count(m)
    table = feature_table(xs, dxs) if table is None \
        else _table_of(xs, table)
    n = g.shape[1]
    wide = _up(n, 16) > WIDE_N
    ws = _slices_of(wide, ctot, n, f32, g.device)
    if not f32:
        _planes_of(planes, f32, m, n, g.device)
        p = dx_plan(m, ctot, n)
        code = build.lib().cunet_tb_bwd_dx(
            table.data_ptr(), len(xs), m, ctot, g.data_ptr(), g.stride(0), n,
            stat.data_ptr(), bias.data_ptr(), red.data_ptr(), w.data_ptr(),
            _ptr(ws), p.ngrp, p.np, p.tbl_off, p.stage_off, p.stage_bytes,
            p.g_off, p.w_off, p.smem, _stream(g))
        build.check(code, "train_bottleneck.bwd_dx")
        # past WIDE_N outputs the split of W into its slices first
        bwd_dx.launches += 1 + wide
        return dxs
    p = dx_f32_plan(m, ctot, n)
    if planes is None:
        planes = _planes_of(None, f32, m, n, g.device)
        code = build.lib().cunet_tb_split_g(g.data_ptr(), g.stride(0), m, n,
                                            planes.data_ptr(), _stream(g))
        build.check(code, "train_bottleneck.bwd_dx (the split of g)")
        bwd_dx.launches += 1
        bwd_dx.f32_launches += 1
    else:
        _planes_of(planes, f32, m, n, g.device)
    code = build.lib().cunet_tb_bwd_dx_f32(
        table.data_ptr(), len(xs), m, ctot, planes.data_ptr(), n,
        stat.data_ptr(), bias.data_ptr(), red.data_ptr(), w.data_ptr(),
        _ptr(ws), p.smem, _stream(g))
    build.check(code, "train_bottleneck.bwd_dx")
    bwd_dx.launches += 1 + wide
    bwd_dx.f32_launches += 1 + wide
    return dxs


KERNELS = (stats, apply, bwd_reduce, bwd_dx)
PLAIN = {stats: stats_plain, apply: apply_plain, bwd_reduce: bwd_reduce_plain,
         bwd_dx: bwd_dx_plain}


def reset_launch_counts() -> None:
    reset_counts(KERNELS)


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def f32_counts() -> dict:
    return count_f32(KERNELS)


for _k in KERNELS:
    _k.f32_launches = 0
reset_launch_counts()


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------


def _rows2d(features):
    n, h, wd, _ = features[0].shape
    m = n * h * wd
    return m, [f.reshape(m, f.shape[-1]) for f in features]


class _FusedTrainBottleneck(torch.autograd.Function):
    """Saves the inputs, the parameters and the batch mean and variance,
    nothing else (the JAX custom VJP's residuals); the backward recomputes
    the rest. The cotangents of mean and var are dropped: they feed the
    running averages only."""

    @staticmethod
    def forward(ctx, eps, scale, bias, w, *features):
        m, xs = _rows2d(features)
        dtype, dev = features[0].dtype, features[0].device
        ctot = _widths(xs)[1]
        table = feature_table(xs) if dev.type == "cuda" else None
        sums = stats(xs, torch.empty(2, ctot, device=dev,
                                     dtype=torch.float32), table=table)
        mean = sums[0] / m
        var = sums[1] / m - mean * mean
        inv = torch.rsqrt(var + eps) * scale
        vec = torch.stack([inv, bias - mean * inv])
        w2 = w[0, 0].to(dtype).contiguous()
        out = torch.empty(m, w.shape[3], device=dev, dtype=dtype)
        apply(xs, vec, w2, out, table=table)
        ctx.eps = eps
        ctx.save_for_backward(*features, scale, bias, w, mean, var)
        ctx.mark_non_differentiable(mean, var)
        return out.reshape(*features[0].shape[:3], -1), mean, var

    @staticmethod
    def backward(ctx, g_out, g_mean, g_var):
        *features, scale, bias, w, mean, var = ctx.saved_tensors
        m, xs = _rows2d(features)
        dev = g_out.device
        ctot, cout = w.shape[2], w.shape[3]
        stat = torch.stack([mean, torch.rsqrt(var + ctx.eps),
                            scale.float()])
        bias32 = bias.float().contiguous()
        w2 = w[0, 0].float().contiguous()
        g2 = g_out.reshape(m, cout).contiguous()
        dw = torch.empty(ctot, cout, device=dev, dtype=torch.float32)
        sums = torch.empty(2, ctot, device=dev, dtype=torch.float32)
        dxs = [torch.empty_like(x, memory_format=torch.contiguous_format)
               for x in xs]
        table = planes = None
        if dev.type == "cuda":
            table = feature_table(xs, dxs)
            # at float32 the reduce's split of g, which bwd_dx reads
            planes = _planes_of(None, g2.dtype == torch.float32, m, cout,
                                dev)
        bwd_reduce(xs, g2, stat, bias32, w2, dw, sums, table=table,
                   planes=planes)
        bwd_dx(xs, g2, stat, bias32, sums / m, w2, dxs, table=table,
               planes=planes)
        return (None, sums[1].to(scale.dtype), sums[0].to(bias.dtype),
                dw.view(1, 1, ctot, cout).to(w.dtype),
                *(dx.view(f.shape) for dx, f in zip(dxs, features)))


def fused_train_bottleneck(features: Sequence[torch.Tensor], scale, bias, w,
                           eps: float = BN_EPS) -> List[torch.Tensor]:
    """Train-mode fused bottleneck over NHWC ``features`` sharing N, H, W;
    ``scale``, ``bias`` (Ctot,) and ``w`` (1, 1, Ctot, Cout) float32.

    Returns (out (N, H, W, Cout) in the features' dtype, batch mean, biased
    batch variance); the statistics feed the running averages outside.
    Differentiable in the features, scale, bias and w, with O(1) saved
    activations (recompute backward)."""
    return _FusedTrainBottleneck.apply(eps, scale, bias, w, *features)
