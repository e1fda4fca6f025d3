"""The Hopper kernels of the slot train step, each beside its plain version.

Counterparts of the in-kernel pieces of ``cunet_tpu/kernels/train_slot.py``
(see ``csrc/train_kernels.cu`` for the map). The forward's two GEMM stages
reuse ``buf_ops.affine_dot`` (F2) and ``buf_ops.conv3x3`` (F3) with per-tile
ghost-BN vectors; this module adds the statistics (F1) and the backward
(B1-B7). A stage is ``out = relu(bn(x)) @ W`` with BN statistics per tile of
``M / T`` rows, and ``vec`` is its (T, 2, K) float32 [inv; shift] with
``inv = rstd * gamma``, ``shift = beta - mean * inv``.

As in :mod:`cunet_tpu_torch.kernels.buf_ops`: on a CPU tensor a wrapper
computes its plain PyTorch version; on a CUDA tensor it launches its kernel
or raises; ``<wrapper>.launches`` counts its launches and nothing else,
``<wrapper>.option_launches`` those with QuanInput's option on.
Reductions over rows (BN sums, weight gradients) write per-block partials
that ``sum_rows`` adds in a fixed order, so the results are deterministic.

What bounds them on the H100: all are bandwidth passes except the weight-
and activation-gradient GEMMs, whose flop/byte is that of the forward 1x1
(about 77-91 at the flagship widths, below the card's ~295 bf16 flop/byte),
so the designs, like the forward's, read each operand once per pass and
recompute the BN+ReLU activation in the prologue instead of storing it.

Float32 forms (a float32 model's ghost-BN training, TPU kernels #8/#9 at
``compute_dtype="float32"``): every wrapper also takes float32 stage
inputs, cotangents and outputs. ``bn_bwd``, ``maxpool2_bwd`` and
``upsample2_bwd`` are their kernels instantiated for float32 (two
16-byte loads a vector of 8), ``bn_stats`` a float32 kernel that splits
each tile's rows across a cluster of blocks (``stats_plan_f32``);
``affine_dx`` and ``conv3x3_dx`` run the
float32 product kernel of ``csrc/f32_kernels.cu`` (``buf_ops``' float32
forms) on the cotangent through the transposed (flipped) weight, gated
in its epilogue; ``affine_dw`` and ``conv3x3_dw`` its weight-gradient
kernel ``dw3_kernel`` (plan ``dw3_plan``), per-split partials added by
``sum_rows``. Every product splits both float32 operands exactly into
three bf16 planes and sums six plane products: the float32 cotangent is
never rounded, as JAX's ``_dot_dx`` / ``_dot_dw`` do not round it at
float32. ``<wrapper>.f32_launches`` counts those launches (also in
``launches``). The QuanInput options run at float32 too (the quantized
model's training at ``compute_dtype="float32"``): the dx forms' ``ste``
gate (0 < z < 1 on the unrounded affine) in the epilogue, the dW forms'
``bits_i`` quantizer on the unrounded float32 z, counted in
``<wrapper>.f32_option_launches`` (also in ``option_launches``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from cunet_tpu_torch.kernels import build
from cunet_tpu_torch.kernels.buf_ops import (
    BF16,
    DOT3_DEPTH,
    DOT3_ROWS,
    DOT_WARPS,
    F32,
    SMEM_LIMIT,
    SMEM_PAIR,
    _check_bits,
    _check_dtypes,
    _check_rows,
    _check_tile_vec,
    _check_view,
    _stream,
    _vec_args,
    count_f32,
    count_f32_options,
    count_options,
    dot3_plan,
    launch_affine_f32,
    launch_conv3x3_f32,
    quantize_act,
    reset_counts,
    tile_affine,
    _up,
)

# affine_dx: warps of a block, rows a warp owns (csrc/train_kernels.cu,
# kThreads / 32 and two m16 tiles), the items (row tile, column block) its
# plan aims at before it takes a smaller row tile or cuts K finer (about
# one per SM of the card's 132, a constant, so the plan depends on the
# shapes alone), and the most n8 column tiles of a warp (the kernel's
# instantiations)
AFFINE_DX_WARPS = 8
AFFINE_DX_WARP_ROWS = 32
AFFINE_DX_ITEMS = 132
AFFINE_DX_MAX_NTW = 4
# affine_dw: the most blocks its plan aims at (two on each of the card's 132
# SMs, one wave: a few more would put a third block on a few SMs and stretch
# the launch by a block's time), and the fewest it takes before it cuts
# columns or channels finer; constants, so the runs (and the order of every
# sum) depend on the shapes alone
AFFINE_DW_BLOCKS = 264
AFFINE_DW_MIN_BLOCKS = 132
# bn_bwd: threads a block (csrc kBnThreads), the blocks its plan aims at
# (one on each SM), the fewest rows of a block split from its tile, the most
# blocks of a cluster (the portable limit), the chunk buffers of a block
# whose rows do not fit in shared memory
BN_BWD_THREADS = 256
BN_BWD_BLOCKS = 132
BN_BWD_MIN_ROWS = 128
BN_BWD_CLUSTER = 8
BN_BWD_RING = 4
# bn_stats at float32: the blocks its plan aims at (one on each of the
# card's 132 SMs), the fewest rows of a block split from its tile (8 a row
# stripe), the most blocks of a cluster (the portable limit)
STATS_F32_BLOCKS = 132
STATS_F32_MIN_ROWS = 256
STATS_F32_CLUSTER = 8
# conv3x3_dx: warps of a block, output rows a warp owns (csrc/
# train_kernels.cu kDxWarps), and the items (tile, channel group) aimed at
# before a smaller one is taken: about one per SM of the card's 132, a
# constant, so the plan (and the order of every sum) depends on the shapes
# alone
DX_WARPS = 8
DX_WARP_ROWS = 32
DX_TILES = 128
# conv3x3_dw: rows per pipelined step, and the most row runs (partials) it
# cuts M into, a constant near the card's 132 SMs so that the runs, and the
# order of every sum, depend on the shapes alone
DW_STEP_ROWS = 128
DW_RUNS = 128
# the float32 weight gradients (csrc/f32_kernels.cu dw3_kernel): the blocks
# their plan aims at, one on each of the card's 132 SMs (a constant, so the
# splits, and the order of every sum, depend on the shapes alone)
DW3_BLOCKS = 132


def _check_f32(t: torch.Tensor, name: str, dev: torch.device) -> None:
    """A float32 kernel operand on ``dev``: unit column stride, widths, row
    strides and the base pointer on 8-element / 16-byte bounds."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes f32")
    if t.stride(-1) != 1 or t.shape[-1] % 8 \
            or any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"{name}: needs unit column stride, width and row "
                         f"strides multiples of 8, 16-byte alignment; got "
                         f"shape {tuple(t.shape)} strides {t.stride()}")


def _check_contig_f32(t: torch.Tensor, name: str, dev: torch.device) -> None:
    if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor on "
                         f"{dev}")


def _tiles(m: int, stats: torch.Tensor) -> int:
    t = stats.shape[0]
    if m % t:
        raise ValueError(f"{m} rows do not split into {t} BN tiles")
    return m // t


# ---------------------------------------------------------------------------
# F1 bn_stats
# ---------------------------------------------------------------------------


def bn_stats_plain(x, out):
    t, k = out.shape[0], x.shape[1]
    xt = x.float().reshape(t, -1, k)
    mu = xt.mean(dim=1)
    out[:, 0] = mu
    out[:, 1] = ((xt - mu[:, None]) ** 2).mean(dim=1)
    return out


@functools.lru_cache(maxsize=None)
def stats_plan_f32(m: int, tile_rows: int, k: int) -> tuple[int, int]:
    """(cs, rpb) of ``bn_stats`` at float32: each tile's rows split across
    a cluster of cs blocks of rpb rows (a multiple of the 32 row stripes;
    the last block may hold fewer). The smallest cs whose grid reaches
    ``STATS_F32_BLOCKS``, at most ``STATS_F32_CLUSTER``, and 1 where a
    split block would hold fewer than ``STATS_F32_MIN_ROWS`` rows: r=64 at
    tile 6 splits a tile's 24,576 rows into 8 blocks of 3,072, 96 rows a
    thread. A function of the shapes alone, so is the order of every sum."""
    tiles, kb = m // tile_rows, -(-k // 64)
    best = (1, -(-tile_rows // 32) * 32)
    for cs in range(2, STATS_F32_CLUSTER + 1):
        if tiles * kb * best[0] >= STATS_F32_BLOCKS:
            break
        rpb = -(-(-(-tile_rows // cs)) // 32) * 32
        if rpb < STATS_F32_MIN_ROWS:
            break
        best = (cs, rpb)
    return best


def bn_stats(x, out):
    """Per-tile float32 mean and biased variance of ``x`` (M, K) into
    ``out`` (T, 2, K): tile t is rows [t*M/T, (t+1)*M/T). Two passes, the
    mean and then the centred squares, as ``_stats`` computes them; the
    input is the bf16 stage input itself, so the statistics are those of
    the rounded values.

    Replaces ``cunet_tpu/kernels/train_slot.py::_stats``. Bound by reading
    x twice (the second pass mostly from L2). Design: one block per (tile,
    64 channels), 32 row stripes of 16-byte loads, a fixed-order reduction
    in shared memory. A float32 x runs a float32 kernel of the same two
    passes whose tiles are split across clusters of blocks
    (``stats_plan_f32``: the grid fills the SMs, a thread's running sums
    stay short), the blocks' partials added in rank order through
    distributed shared memory.
    """
    m, k = x.shape
    if out.dim() != 3 or tuple(out.shape[1:]) != (2, k) or m % out.shape[0]:
        raise ValueError(f"bn_stats shapes: x {tuple(x.shape)}, out "
                         f"{tuple(out.shape)}")
    if x.device.type == "cpu":
        return bn_stats_plain(x, out)
    _check_view(x, "x", (BF16, F32))
    _check_contig_f32(out, "out", x.device)
    f32 = x.dtype == F32
    tr = m // out.shape[0]
    cs, rpb = stats_plan_f32(m, tr, k) if f32 else (1, tr)
    code = build.lib().cunet_bn_stats(x.data_ptr(), x.stride(0), m, tr, k,
                                      out.data_ptr(), int(f32), cs, rpb,
                                      _stream(x))
    build.check(code, "bn_stats")
    bn_stats.launches += 1
    bn_stats.f32_launches += f32
    return out


# ---------------------------------------------------------------------------
# sum_rows: the second pass of every row reduction
# ---------------------------------------------------------------------------


def sum_rows_plain(part, out):
    out.copy_(part.sum(dim=0).view(out.shape))
    return out


def sum_rows(part, out):
    """``out = part.sum(0)`` for contiguous float32 ``part`` (S, ...), the
    partials summed in order.

    Replaces the f32 accumulation of weight and BN-parameter gradients
    across the TPU's sequential grid steps (``train_slot.py::_mk_acc``).
    Bound by reading the partials once; one thread per output element.
    """
    if part[0].numel() != out.numel():
        raise ValueError(f"sum_rows shapes: part {tuple(part.shape)}, out "
                         f"{tuple(out.shape)}")
    if part.device.type == "cpu":
        return sum_rows_plain(part, out)
    _check_contig_f32(part, "part", part.device)
    _check_contig_f32(out, "out", part.device)
    code = build.lib().cunet_sum_rows(part.data_ptr(), part.shape[0],
                                      out.numel(), out.data_ptr(),
                                      _stream(part))
    build.check(code, "sum_rows")
    sum_rows.launches += 1
    return out


# ---------------------------------------------------------------------------
# B1 affine_dx / B4 conv3x3_dx
# ---------------------------------------------------------------------------


def _gate(x, vec, ste):
    """The backward's ReLU gate z > 0 of z = x*inv + shift; with ``ste``
    QuanInput's straight-through gate too: z, rounded to x's dtype (the
    value the quantizer read), below 1."""
    z = tile_affine(x, vec)
    if not ste:
        return z > 0
    return (z > 0) & (z.to(x.dtype).float() < 1)


def affine_dx_plain(dy, w, x, vec, out, ste=False):
    k = x.shape[1]
    d = dy.float() @ w[:k].float().t()
    out.copy_(torch.where(_gate(x, vec, ste), d, 0.0))
    return out


def _dx_operands(dy, w, x, vec, out):
    """The checks of a dx kernel's operands; the vector arguments."""
    _check_view(dy, "dy")
    _check_view(w, "w")
    _check_view(x, "x")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")
    _check_f32(out, "out", dy.device)
    _check_contig_f32(vec, "vec", dy.device)
    return _vec_args(vec, dy.shape[0], x.shape[1])


@dataclasses.dataclass(frozen=True)
class AffineDxPlan:
    """How ``affine_dx``'s kernel cuts dy (m, N) @ W^T -> (m, K): row tiles
    of ``bm`` rows (``row_warps`` warps of ``AFFINE_DX_WARP_ROWS`` rows),
    K in ``nkb`` blocks of ``kc`` columns (``col_warps`` warps of ``ntw``
    n8 tiles; columns past K are zero weights and are not stored), N
    zero-padded to ``np_``; the block's ``kc`` weight rows resident
    (``w_bytes``, at a stride of np_ + 8), then ``stages`` buffers of
    ``stage_bytes``, each a tile's dy rows (``dy_bytes``, at np_ + 8) and
    its x rows (at kc + 8); ``smem`` bytes in all."""
    bm: int
    kc: int
    nkb: int
    ntw: int
    np_: int
    stages: int
    w_bytes: int
    dy_bytes: int
    stage_bytes: int
    smem: int

    @property
    def row_warps(self) -> int:
        return self.bm // AFFINE_DX_WARP_ROWS

    @property
    def col_warps(self) -> int:
        return AFFINE_DX_WARPS // self.row_warps

    def tiles(self, m: int) -> int:
        return -(-m // self.bm)

    def items(self, m: int) -> int:
        return self.tiles(m) * self.nkb


def _affine_dx_layout(bm, k, n, split, stages=(3, 2), limit=SMEM_LIMIT):
    """The layout of row tiles of ``bm`` and K in ``split`` times the fewest
    blocks of at most 64, the first count of buffers of ``stages`` that
    fits in ``limit`` bytes; None where none does."""
    wn = AFFINE_DX_WARPS // (bm // AFFINE_DX_WARP_ROWS)
    kc = _up(-(-k // (-(-k // 64) * split)), 8 * wn)
    ntw = kc // (8 * wn)
    if ntw > AFFINE_DX_MAX_NTW:
        return None
    np_ = _up(n, 16)
    w_bytes = _up(kc * (np_ + 8) * 2, 128)
    dy_bytes = _up(bm * (np_ + 8) * 2, 128)
    stage_bytes = dy_bytes + _up(bm * (kc + 8) * 2, 128)
    for s in stages:
        smem = w_bytes + s * stage_bytes
        if smem <= limit:
            return AffineDxPlan(bm=bm, kc=kc, nkb=-(-k // kc), ntw=ntw,
                                np_=np_, stages=s, w_bytes=w_bytes,
                                dy_bytes=dy_bytes, stage_bytes=stage_bytes,
                                smem=smem)
    return None


@functools.lru_cache(maxsize=None)
def affine_dx_plan(m: int, k: int, n: int) -> AffineDxPlan:
    """The kernel plan of ``affine_dx`` at these shapes (a function of them
    alone). K in the fewest blocks of at most 64 columns, cut evenly in
    multiples of 16 where the warps allow (192: 3 x 64, 320: 5 x 64; 96- and
    128-column blocks were 4-5 % slower: ``tools/gemm_sweep.py``, PERF.md
    section 6); the largest row tile of 128, 64, 32 that gives
    ``AFFINE_DX_ITEMS`` items with a layout of two buffers that runs two
    blocks an SM (``buf_ops.SMEM_PAIR``: 64-row tiles on the main path; a
    third buffer was slower there); else one that fits alone, three
    buffers where they fit; else the same with K in twice as many blocks;
    else the plan of the most items. Cached, as ``buf_ops.affine_dot_plan``
    is."""
    best = None
    for split in (1, 2):
        for limit, stages in ((SMEM_PAIR, (2,)), (SMEM_LIMIT, (3, 2))):
            for bm in (128, 64, 32):
                p = _affine_dx_layout(bm, k, n, split, stages, limit)
                if p is None:
                    continue
                if p.items(m) >= AFFINE_DX_ITEMS:
                    return p
                if best is None or p.items(m) > best.items(m):
                    best = p
    if best is None:
        raise ValueError(f"affine_dx: no tiling of K={k}, N={n} fits "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return best


def affine_dx(dy, w, x, vec, out, *, ste=False):
    """``out = (dy @ w[:K]^T) * [x*inv + shift > 0]`` in float32 for
    dy (M, N) bf16, w (>=K, N), x (M, K) the stage input and ``vec`` its
    per-tile (T, 2, >=K) vectors: the cotangent of a stage's pre-ReLU
    activation. With ``ste`` the mask is QuanInput's too (the quantized
    head): it passes only where 0 < bf16(z) < 1.

    Replaces ``cunet_tpu/kernels/train_slot.py::_dot_dx`` with the ReLU
    mask of ``_affine_bwd`` (and ``_ste_mask``). Bound like the forward
    1x1 by reading dy and x and writing the f32 result. Design
    (``csrc/train_kernels.cu``, plan ``affine_dx_plan``): ``affine_dot``'s
    on dy. Persistent blocks keep one block of at most 64 of K's columns:
    its rows of W as they lie (the B operand of dy W^T wants each output
    column's N values contiguous), loaded once by cp.async and read by
    ldmatrix without a transpose; the tiles' dy rows and x rows (64-row
    tiles on the main path, two blocks an SM) arrive by cp.async one or
    two tiles ahead; the gate is recomputed once per element in
    shared memory with the forward's f32 prologue (the forward's
    activation is never stored); mma.sync m16n8k16 with f32 sums in
    registers, a lane pair's swap giving each lane four columns of one row
    for a 16-byte store. Its BN-jacobian sums are taken by ``bn_bwd``,
    which reads d_a anyway. PERF.md section 6 has its times on the H100.
    """
    m, n = dy.shape
    k = x.shape[1]
    if x.shape[0] != m or w.shape[0] < k or w.shape[1] != n \
            or tuple(out.shape) != (m, k):
        raise ValueError(f"affine_dx shapes: dy {tuple(dy.shape)}, w "
                         f"{tuple(w.shape)}, x {tuple(x.shape)}, out "
                         f"{tuple(out.shape)}")
    _check_tile_vec(vec, k, m)
    if dy.device.type == "cpu":
        return affine_dx_plain(dy, w, x, vec, out, ste)
    if dy.dtype == F32:
        return _affine_dx_f32(dy, w, x, vec, out, ste)
    inv, shift, vstride, tile_rows = _dx_operands(dy, w, x, vec, out)
    _check_rows(m)
    p = affine_dx_plan(m, k, n)
    code = build.lib().cunet_dx(
        dy.data_ptr(), dy.stride(0), m, n, w.data_ptr(), w.shape[1], k,
        x.data_ptr(), x.stride(0), inv, shift, vstride, tile_rows, int(ste),
        out.data_ptr(), out.stride(0), p.bm, p.kc, p.nkb, p.ntw, p.np_,
        p.stages, p.w_bytes, p.dy_bytes, p.stage_bytes, p.smem, _stream(dy))
    build.check(code, "affine_dx")
    affine_dx.launches += 1
    affine_dx.option_launches += bool(ste)
    return out


def _f32_gate_operands(dy, w, x, vec, out):
    """The checks of a float32 dx form's operands (all float32); the
    gate's vector arguments."""
    for name, t in (("dy", dy), ("w", w), ("x", x), ("out", out)):
        _check_view(t, name, (F32,))
    _check_contig_f32(vec, "vec", dy.device)
    _check_rows(dy.shape[0])
    return _vec_args(vec, dy.shape[0], x.shape[1])


def _affine_dx_f32(dy, w, x, vec, out, ste):
    """``affine_dx``'s float32 form: the float32 product kernel
    (``buf_ops.launch_affine_f32``) of dy through W^T (the K rows of w
    transposed into a contiguous (N, K) operand), no prologue, the ReLU
    gate of x's per-tile affine in its epilogue (with ``ste`` also 0 where
    that affine is >= 1): dy and W^T each split into three bf16 planes, six
    plane products a k16 step."""
    inv, shift, vstride, tile_rows = _f32_gate_operands(dy, w, x, vec, out)
    wt = w[:x.shape[1]].t().contiguous()
    code = launch_affine_f32(dy, 0, 0, vstride, tile_rows, wt, out,
                             gate=(x, inv, shift), ste=ste)
    build.check(code, "affine_dx (float32)")
    affine_dx.launches += 1
    affine_dx.f32_launches += 1
    affine_dx.option_launches += bool(ste)
    affine_dx.f32_option_launches += bool(ste)
    return out


def conv3x3_dx_plain(dy, w3p, b, h, w, x, vec, out, ste=False):
    cb, g = x.shape[1], dy.shape[1]
    d4 = dy.float().reshape(b, h, w, g).permute(0, 3, 1, 2)
    wt = w3p.float().view(3, 3, cb, g).permute(3, 2, 0, 1)
    dz = F.conv_transpose2d(d4, wt, padding=1)
    dz = dz.permute(0, 2, 3, 1).reshape(b * h * w, cb)
    out.copy_(torch.where(_gate(x, vec, ste), dz, 0.0))
    return out


@dataclasses.dataclass(frozen=True)
class DxPlan:
    """How ``conv3x3_dx``'s kernel cuts an (m, G) -> (m, Cb) transposed conv
    over images of width w: items of a tile of ``bm`` output rows and a
    group of ``gb`` output channels (``ncol`` groups), each computed by
    ``DX_WARPS`` warps of ``DX_WARP_ROWS`` rows x ``wn`` channels, of which
    ``row_warps`` x ``col_warps`` split the tile and ``k_warps`` the 9*G
    reduction (G zero-padded to 16: ``gp``). Shared memory: the weight
    slice (9 x gb x gp) at 0, the zero row at ``zero_off``; ``stages``
    buffers each of a halo tile (``halo_rows`` dy rows, ``stage_bytes``
    from ``stage_off``), the tile's x rows (``x_bytes`` from ``x_off``) and
    the BN vectors of the ``nv`` BN tiles its rows can touch (``vec_bytes``
    from ``vec_off``); the split reduction's partial sums at ``red_off``;
    ``smem`` bytes in all."""
    bm: int
    gb: int
    wn: int
    ncol: int
    gp: int
    nv: int
    stages: int
    halo_rows: int
    zero_off: int
    stage_off: int
    stage_bytes: int
    x_off: int
    x_bytes: int
    vec_off: int
    vec_bytes: int
    red_off: int
    smem: int

    @property
    def row_warps(self) -> int:
        return self.bm // DX_WARP_ROWS

    @property
    def col_warps(self) -> int:
        return self.gb // self.wn

    @property
    def k_warps(self) -> int:
        return DX_WARPS // (self.row_warps * self.col_warps)

    def items(self, m: int) -> int:
        return -(-m // self.bm) * self.ncol

    def k_range(self, wk: int) -> range:
        """The k16 steps (tap-major, ``gp // 16`` per tap) of warp row
        ``wk`` of the reduction, out of ``9 * gp // 16``."""
        steps = 9 * self.gp // 16
        return range(wk * steps // self.k_warps,
                     (wk + 1) * steps // self.k_warps)


def _dx_layout(bm, gb, stages, gp, nv, w) -> DxPlan:
    wn = min(gb, 64)
    halo_rows = bm + 2 * w + 2
    k_warps = DX_WARPS // ((bm // DX_WARP_ROWS) * (gb // wn))
    zero_off = 9 * gb * gp * 2
    stage_off = zero_off + _up(2 * gp, 128)
    stage_bytes = _up(halo_rows * (gp + 8) * 2, 128)
    x_off = stage_off + stages * stage_bytes
    x_bytes = _up(bm * (gb + 8) * 2, 128)
    vec_off = x_off + stages * x_bytes
    vec_bytes = _up(nv * 2 * gb * 4, 128)
    red_off = vec_off + stages * vec_bytes
    smem = red_off + (k_warps - 1) * bm * (gb + 4) * 4
    return DxPlan(bm=bm, gb=gb, wn=wn, ncol=0, gp=gp, nv=nv, stages=stages,
                  halo_rows=halo_rows, zero_off=zero_off,
                  stage_off=stage_off, stage_bytes=stage_bytes, x_off=x_off,
                  x_bytes=x_bytes, vec_off=vec_off, vec_bytes=vec_bytes,
                  red_off=red_off, smem=smem)


def conv3x3_dx_plan(m: int, h: int, w: int, cb: int, g: int,
                    tiles: int = 1) -> DxPlan:
    """The kernel plan of ``conv3x3_dx`` at these shapes (a function of them
    alone; ``tiles`` is the number of BN tiles of the rows, 1 for an eval
    vector). The (row tile, channel group) with the most work per item
    that still gives ``DX_TILES`` items, whole channel groups of up to 128
    preferred; else the one with the most items; two halo stages where they
    fit in ``SMEM_LIMIT``, else one."""
    gp = _up(g, 16)
    gb_max = next(gb for gb in (16, 32, 64, 128) if gb >= min(cb, 128))
    cands = sorted(((bm, gb) for bm in (128, 64, 32)
                    for gb in (128, 64, 32, 16) if gb <= gb_max),
                   key=lambda c: (-c[0] * c[1], -c[1]))
    tile_rows = m // tiles
    best = None
    for bm, gb in cands:
        nv = min(tiles, (bm - 1) // tile_rows + 2)
        plan = next((p for p in (_dx_layout(bm, gb, st, gp, nv, w)
                                 for st in (2, 1))
                     if p.smem <= SMEM_LIMIT), None)
        if plan is None:
            continue
        plan = dataclasses.replace(plan, ncol=-(-cb // gb))
        if plan.items(m) >= DX_TILES:
            return plan
        if best is None or plan.items(m) > best.items(m):
            best = plan
    if best is None:
        raise ValueError(f"conv3x3_dx: no tiling of G={g}, W={w} fits "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return best


def conv3x3_dx(dy, w3p, b, h, w, x, vec, out, *, ste=False):
    """The transposed 3x3 conv of ``dy`` (b*h*w, G) through the packed
    weight ``w3p`` (9*Cb, G), masked by relu(BN2(x)) > 0 of the conv's
    input x (b*h*w, Cb): the float32 cotangent of BN2's pre-ReLU output;
    with ``ste`` also QuanInput's gate (0 < bf16(z2) < 1).

    Replaces the d_z2 half of ``cunet_tpu/kernels/train_slot.py::
    _conv3x3_bwd`` (all its TPU forms). Bound on the H100 by bytes:
    reading dy and x, writing the float32 result (24.4 us at r=64 batch
    24). Design (``csrc/train_kernels.cu``, plan ``conv3x3_dx_plan``):
    ``conv3x3``'s form run on dy. Persistent blocks walk (row tile,
    channel group) items; a tile's dy rows are one halo tile (the rows
    plus one image row and pixel either side) loaded with cp.async while
    the previous tile computes; the nine taps read shifted windows of it
    through ldmatrix into mma.sync, rows outside the image pointed at a
    zero row, each against the flipped tap (8 - t) of the weight, resident
    in shared memory and read as it lies in memory (no flipped copy); the
    x rows and BN vectors of the gate arrive with the halo; a warp gates
    its finished tile in registers (the forward's rounding, so it passes
    the same elements as the plain version) and writes it during the next
    tile's taps, so the f32 writes overlap the products. At small M the
    warps split the 9*G reduction and add their sums in a fixed order. On
    an H100 80GB HBM3 at 700 W (PERF.md section 6, PR 9): 70 us at r=64
    (``conv2d_input`` 85, the WMMA kernel before it 110), 25.5 at r=32,
    5.9 at r=4.
    """
    m, g = dy.shape
    cb = x.shape[1]
    if m != b * h * w or x.shape[0] != m or tuple(w3p.shape) != (9 * cb, g) \
            or tuple(out.shape) != (m, cb):
        raise ValueError(f"conv3x3_dx shapes: dy {tuple(dy.shape)}, w "
                         f"{tuple(w3p.shape)}, x {tuple(x.shape)}, out "
                         f"{tuple(out.shape)}, image {b}x{h}x{w}")
    _check_tile_vec(vec, cb, m)
    if dy.device.type == "cpu":
        return conv3x3_dx_plain(dy, w3p, b, h, w, x, vec, out, ste)
    if dy.dtype == F32:
        return _conv3x3_dx_f32(dy, w3p, h, w, x, vec, out, ste)
    inv, shift, vstride, tile_rows = _dx_operands(dy, w3p, x, vec, out)
    _check_rows(m)
    p = conv3x3_dx_plan(m, h, w, cb, g, m // tile_rows)
    code = build.lib().cunet_conv3x3_dx(
        dy.data_ptr(), dy.stride(0), m, h, w, g, w3p.data_ptr(), cb,
        x.data_ptr(), x.stride(0), inv, shift, vstride, tile_rows, int(ste),
        out.data_ptr(), out.stride(0), p.bm, p.gb, p.wn, p.ncol, p.stages,
        p.zero_off, p.stage_off, p.stage_bytes, p.x_off, p.x_bytes,
        p.vec_off, p.vec_bytes, p.red_off, p.smem, _stream(dy))
    build.check(code, "conv3x3_dx")
    conv3x3_dx.launches += 1
    conv3x3_dx.option_launches += bool(ste)
    return out


def flip_w3(w3p: torch.Tensor) -> torch.Tensor:
    """The packed (9*Cb, G) 3x3 weight as the forward conv's of its
    transpose: (9*G, Cb), tap t's rows the transposed rows of tap 8 - t.
    The SAME conv of dy through it is the input gradient of the conv."""
    cb, g = w3p.shape[0] // 9, w3p.shape[1]
    return (w3p.view(3, 3, cb, g).flip(0, 1).permute(0, 1, 3, 2)
            .reshape(9 * g, cb).contiguous())


def _conv3x3_dx_f32(dy, w3p, h, w, x, vec, out, ste):
    """``conv3x3_dx``'s float32 form: the float32 product kernel's
    implicit GEMM (``buf_ops.launch_conv3x3_f32``) of dy through
    ``flip_w3(w3p)``, no prologue, the ReLU gate of x's per-tile BN2
    affine in its epilogue (after the split-K partials are added, where
    the plan splits K; with ``ste`` also 0 where that affine is >= 1)."""
    inv, shift, vstride, tile_rows = _f32_gate_operands(dy, w3p, x, vec,
                                                        out)
    code = launch_conv3x3_f32(dy, flip_w3(w3p), h, w, out,
                              pro=(0, 0, vstride, tile_rows),
                              gate=(x, inv, shift), ste=ste)
    build.check(code, "conv3x3_dx (float32)")
    conv3x3_dx.launches += 1
    conv3x3_dx.f32_launches += 1
    conv3x3_dx.option_launches += bool(ste)
    conv3x3_dx.f32_option_launches += bool(ste)
    return out


# ---------------------------------------------------------------------------
# B3 affine_dw / B5 conv3x3_dw
# ---------------------------------------------------------------------------


def affine_dw_plain(x, vec, dy, out, bits_i=0):
    z = quantize_act(torch.relu(tile_affine(x, vec)).to(x.dtype),
                     bits_i).float()
    out.copy_(z.t() @ dy.float())
    return out


def _dw_operands(x, vec, dy, out):
    _check_view(x, "x")
    _check_view(dy, "dy")
    _check_contig_f32(out, "out", x.device)
    _check_contig_f32(vec, "vec", x.device)
    return _vec_args(vec, x.shape[0], x.shape[1])


@dataclasses.dataclass(frozen=True)
class AffineDwPlan:
    """How ``affine_dw``'s kernel cuts z^T dy for z (m, K), dy (m, N): the
    rows in ``runs`` runs of ``run_rows`` (the last one shorter), each
    walked in steps of ``br`` rows and summed into one partial; K in
    ``nkb`` blocks of ``kc`` channels (a multiple of 16, at most 128), N in
    ``ngrp`` groups of ``ncol`` columns (16-128); ``stages`` buffers of
    ``stage_bytes``, each a step's x rows (``x_bytes``, at a row stride of
    kc + 8) and then its dy rows (ncol + 8); ``smem`` bytes in all."""
    runs: int
    run_rows: int
    br: int
    kc: int
    nkb: int
    ncol: int
    ngrp: int
    stages: int
    x_bytes: int
    stage_bytes: int
    smem: int

    @property
    def blocks(self) -> int:
        return self.runs * self.nkb * self.ngrp

    def run(self, p: int, m: int) -> range:
        return range(p * self.run_rows, min(m, (p + 1) * self.run_rows))


def _affine_dw_layout(m, k, n, br, ncol, split) -> AffineDwPlan:
    kc = _up(-(-k // (-(-k // 128) * split)), 16)
    nkb, ngrp = -(-k // kc), -(-n // ncol)
    steps = -(-m // br)
    per_run = max(1, AFFINE_DW_BLOCKS // (nkb * ngrp))
    # at least two steps a run where there are two: a block then has a
    # step loading under the one it computes
    run_steps = max(-(-steps // per_run), min(2, steps))
    x_bytes = _up(br * (kc + 8) * 2, 128)
    stage_bytes = x_bytes + _up(br * (ncol + 8) * 2, 128)
    stages = 3 if 3 * stage_bytes <= SMEM_LIMIT else 2
    return AffineDwPlan(runs=-(-steps // run_steps), run_rows=run_steps * br,
                        br=br, kc=kc, nkb=nkb, ncol=ncol, ngrp=ngrp,
                        stages=stages, x_bytes=x_bytes,
                        stage_bytes=stage_bytes, smem=stages * stage_bytes)


def affine_dw_plan(m: int, k: int, n: int) -> AffineDwPlan:
    """The kernel plan of ``affine_dw`` at these shapes (a function of them
    alone): K in the fewest blocks of at most 128 channels, cut evenly
    (192: 2 x 96, 320: 3 x 112), all N (up to 128) in one group, and the
    rows in runs of whole 64-row steps, at least two a run, as many runs
    as keep the blocks within ``AFFINE_DW_BLOCKS``. Where that gives fewer
    than ``AFFINE_DW_MIN_BLOCKS``, the first of half the columns, twice
    the channel blocks, both, then a quarter and an eighth of the columns,
    that reaches it, and only then steps of 32 and 16 rows (slower, where
    M allows 64: PERF.md section 6, PR 10); else the one with the most
    blocks."""
    full = next((c for c in (16, 32, 64) if c >= n), 128)
    best = None
    for br in (64, 32, 16):
        for div, split in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2),
                           (8, 1), (8, 2)):
            if full // div < 16:
                continue
            p = _affine_dw_layout(m, k, n, br, full // div, split)
            if p.blocks >= AFFINE_DW_MIN_BLOCKS:
                return p
            if best is None or p.blocks > best.blocks:
                best = p
    return best


def affine_dw(x, vec, dy, out, *, bits_i=0):
    """``out = bf16(relu(x*inv + shift))^T @ dy`` in float32, (K, N), for
    x (M, K), per-tile ``vec`` and dy (M, N): a 1x1 stage's weight
    gradient, summed over all rows. With ``bits_i`` (1-15) the activation
    is QuanInput-quantized (``quantize_act``): dW of the quantized head.

    Replaces ``cunet_tpu/kernels/train_slot.py::_dot_dw`` (and the
    cross-step dW accumulation). Bound on the H100 by reading x and dy once
    (18.8 us at r=64, K=192->128, batch 24). Design (``csrc/
    train_kernels.cu``, plan ``affine_dw_plan``): ``conv3x3_dw``'s design
    with one tap. A block owns a run of whole row steps, a block of
    channels and a group of columns, sized to put two blocks on each SM;
    per step the x and dy rows arrive by cp.async, up to three steps deep,
    the BN + ReLU prologue (and quantizer) is applied once per element in
    shared memory from BN vectors each thread keeps in registers across
    the run, and 8 warps accumulate dW^T += dY^T z with ldmatrix.trans and
    mma.sync, the sums in registers; each block writes one partial and
    ``sum_rows`` adds the runs' partials in order, so two calls give the
    same bits. On an H100 80GB HBM3 at 700 W (PERF.md section 6, PR 10):
    53.8 us at r=64 with its ``sum_rows`` (the WMMA kernel before it
    203.6; ``torch.mm`` of the product alone 33.3), 7.4 at r=4.
    """
    m, k = x.shape
    n = dy.shape[1]
    if dy.shape[0] != m or tuple(out.shape) != (k, n):
        raise ValueError(f"affine_dw shapes: x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}, out {tuple(out.shape)}")
    _check_tile_vec(vec, k, m)
    _check_bits(bits_i)
    if x.device.type == "cpu":
        return affine_dw_plain(x, vec, dy, out, bits_i)
    if x.dtype == F32:
        return _dw_f32(affine_dw, x, vec, dy, out, bits_i)
    inv, shift, vstride, tile_rows = _dw_operands(x, vec, dy, out)
    _check_rows(m)
    p = affine_dw_plan(m, k, n)
    part = torch.empty(p.runs, k, n, device=x.device, dtype=torch.float32)
    code = build.lib().cunet_dw(
        x.data_ptr(), x.stride(0), m, k, inv, shift, vstride, tile_rows,
        bits_i, dy.data_ptr(), dy.stride(0), n, part.data_ptr(), p.runs,
        p.run_rows, p.br, p.kc, p.ncol, p.stages, p.x_bytes, p.stage_bytes,
        p.smem, _stream(x))
    build.check(code, "affine_dw")
    sum_rows(part, out)
    affine_dw.launches += 1
    affine_dw.option_launches += bits_i > 0
    return out


@dataclasses.dataclass(frozen=True)
class Dw3Plan:
    """How the float32 weight-gradient kernel (``csrc/f32_kernels.cu``
    ``dw3_kernel``) cuts z^T dy for R output rows (K channels, or 9*Cb
    tap-major) and N columns over M rows: blocks of ``DOT3_ROWS`` output
    rows by ``bn`` columns, M in chunks of ``DOT3_DEPTH`` rows, the chunks
    in ``splits`` runs, each summed into one (R, N) partial; ``smem``
    bytes of shared memory (three bf16 planes of the z chunk, depth-major,
    and of the dy chunk, then the warps' stages)."""
    bn: int
    splits: int
    smem: int

    def grid(self, r: int, n: int):
        return -(-r // DOT3_ROWS), -(-n // self.bn), self.splits

    def chunks(self, m: int):
        """The chunks of M each split sums, in the order ``sum_rows`` adds
        the partials."""
        nch = -(-m // DOT3_DEPTH)
        return [range(s * nch // self.splits, (s + 1) * nch // self.splits)
                for s in range(self.splits)]


@functools.lru_cache(maxsize=None)
def dw3_plan(m: int, r: int, n: int) -> Dw3Plan:
    """The plan of the float32 weight gradients at these shapes (a
    function of them alone): ``dot3_plan``'s column tile for N, and as
    many splits of M as bring the blocks to ``DW3_BLOCKS`` with at least
    two chunks a split."""
    bn = dot3_plan(n).bn
    gr, gn, _ = Dw3Plan(bn, 1, 0).grid(r, n)
    nch = -(-m // DOT3_DEPTH)
    splits = max(1, min(DW3_BLOCKS // (gr * gn), nch // 2))
    planes = 3 * 2 * DOT3_DEPTH * ((DOT3_ROWS + 8) + (bn + 8))
    return Dw3Plan(bn=bn, splits=splits,
                   smem=_up(planes, 128) + DOT_WARPS * 16 * 16 * 4)


def _dw_f32(kern, x, vec, dy, out, bits_i, hw=None):
    """The float32 form of ``affine_dw`` (``hw`` None) or of
    ``conv3x3_dw`` (``hw`` = (h, w)): ``dw3_kernel``'s partials of
    ``dw3_plan``, added in order by ``sum_rows``; with ``bits_i`` on the
    quantized z (``quan`` of the unrounded float32 activation)."""
    _check_view(x, "x", (F32,))
    _check_view(dy, "dy", (F32,))
    _check_contig_f32(out, "out", x.device)
    _check_contig_f32(vec, "vec", x.device)
    if vec.shape[-1] % 4:
        raise ValueError(f"vec width {vec.shape[-1]}: the float32 weight "
                         f"gradients read it as 16-byte vectors")
    m, c = x.shape
    n = dy.shape[1]
    _check_rows(m)
    inv, shift, vstride, tile_rows = _vec_args(vec, m, c)
    r = c if hw is None else 9 * c
    p = dw3_plan(m, r, n)
    part = torch.empty(p.splits, r, n, device=x.device, dtype=torch.float32)
    h, w = hw if hw is not None else (0, 0)
    code = build.lib().cunet_dw_f32(
        x.data_ptr(), x.stride(0), m, c, h, w, int(hw is not None), inv,
        shift, vstride, tile_rows, dy.data_ptr(), dy.stride(0), n,
        part.data_ptr(), bits_i, p.bn, p.smem, p.splits, _stream(x))
    build.check(code, f"{kern.__name__} (float32)")
    sum_rows(part, out)
    kern.launches += 1
    kern.f32_launches += 1
    kern.option_launches += bits_i > 0
    kern.f32_option_launches += bits_i > 0
    return out


def conv3x3_dw_plain(x, vec, dy, b, h, w, out, bits_i=0):
    cb, g = x.shape[1], dy.shape[1]
    z = quantize_act(torch.relu(tile_affine(x, vec)).to(x.dtype),
                     bits_i).float()
    z4 = z.reshape(b, h, w, cb).permute(0, 3, 1, 2)
    d4 = dy.float().reshape(b, h, w, g).permute(0, 3, 1, 2)
    dw = torch.nn.grad.conv2d_weight(z4, (g, cb, 3, 3), d4, padding=1)
    out.copy_(dw.permute(2, 3, 1, 0).reshape(9 * cb, g))
    return out


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """How ``conv3x3_dw``'s kernel cuts the rows, channels and outputs: M in
    ``runs`` runs of ``run_rows`` rows (the last one shorter), each walked in
    steps of ``br`` rows and summed into one partial; the channels
    (zero-padded to 16) in blocks of ``kc``, the outputs in groups of
    ``nt * 8``; ``stages`` buffers of ``stage_bytes``, each a halo tile of
    ``halo_rows`` rows and, at ``dy_off``, a step's dy rows; the zero row
    at 0, the first stage at ``stage_off``; ``smem`` bytes in all."""
    runs: int
    run_rows: int
    br: int
    kc: int
    nt: int
    stages: int
    halo_rows: int
    zero_off: int
    stage_off: int
    stage_bytes: int
    dy_off: int
    smem: int

    def grid(self, cb: int, g: int):
        return self.runs, -(-cb // self.kc), -(-g // (8 * self.nt))

    def run(self, p: int, m: int) -> range:
        return range(p * self.run_rows, min(m, (p + 1) * self.run_rows))


def conv3x3_dw_plan(m: int, h: int, w: int, cb: int, g: int) -> DwPlan:
    """The kernel plan of ``conv3x3_dw`` at these shapes (a function of them
    alone): M in at most ``DW_RUNS`` runs of whole ``DW_STEP_ROWS``-row
    steps; 128 channels a block (fewer where a halo tile of a wide image
    would not fit), at most 32 outputs; two stages where they fit in
    ``SMEM_LIMIT``, else one."""
    br = DW_STEP_ROWS
    steps = -(-m // br)
    run_rows = -(-steps // DW_RUNS) * br
    nt = min(-(-g // 8), 4)
    ds = (nt if nt % 2 else nt + 1) * 16        # dy row stride, bytes
    halo_rows = br + 2 * w + 2
    for kc in range(min(_up(cb, 16), 128), 0, -16):
        dy_off = _up(halo_rows * (kc + 8) * 2, 128)
        stage_bytes = _up(dy_off + br * ds, 128)
        zero = _up(2 * kc, 128)
        for stages in (2, 1):
            if zero + stages * stage_bytes <= SMEM_LIMIT:
                return DwPlan(runs=-(-m // run_rows), run_rows=run_rows,
                              br=br, kc=kc, nt=nt, stages=stages,
                              halo_rows=halo_rows, zero_off=0,
                              stage_off=zero, stage_bytes=stage_bytes,
                              dy_off=dy_off,
                              smem=zero + stages * stage_bytes)
    raise ValueError(f"conv3x3_dw: no tiling of W={w} fits {SMEM_LIMIT} "
                     f"bytes of shared memory")


def conv3x3_dw(x, vec, dy, b, h, w, out, *, bits_i=0):
    """Weight gradient of the 3x3 conv in the packed (9*Cb, G) layout:
    ``out[tap*Cb + c] = sum_m z[m + offset(tap), c] * dy[m]`` with
    z = bf16(relu(x*inv + shift)) of the conv input x (b*h*w, Cb) (zero
    outside the image) and dy (b*h*w, G); with ``bits_i`` (1-15) z is
    QuanInput-quantized, the values the forward's conv read.

    Replaces the dW3 half of ``cunet_tpu/kernels/train_slot.py::
    _conv3x3_bwd``. Bound on the H100 by reading x and dy once (~9.4 us at
    batch 24, r=64). Design (``csrc/train_kernels.cu``, plan
    ``conv3x3_dw_plan``): a block owns a run of whole 128-row steps; per
    step it stages one halo tile of z (the rows plus one image row and
    pixel either side, the prologue and quantizer applied once per
    element) and the step's dy rows with cp.async, the next step loading
    while this one computes; twelve warps, one kernel row and two 16-channel
    tiles each, accumulate all nine taps from that one tile with
    ldmatrix.trans and mma.sync, and the block writes one (9*Cb, G)
    partial; ``sum_rows`` adds the runs' partials in order. The runs depend
    on M alone, so two calls give the same bits. On an H100 80GB HBM3 at
    700 W (PERF.md section 6, PR 8): 76 us at r=64 batch 24 with its
    ``sum_rows`` (bound 9.4, ``conv2d_weight`` on a stored z 39: the
    mma.sync products take ~31 us, the prologue ~19, the loads ~10), 15.5
    us at r <= 8.
    """
    m, cb = x.shape
    g = dy.shape[1]
    if m != b * h * w or dy.shape[0] != m or tuple(out.shape) != (9 * cb, g):
        raise ValueError(f"conv3x3_dw shapes: x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}, out {tuple(out.shape)}, "
                         f"image {b}x{h}x{w}")
    _check_tile_vec(vec, cb, m)
    _check_bits(bits_i)
    if x.device.type == "cpu":
        return conv3x3_dw_plain(x, vec, dy, b, h, w, out, bits_i)
    if x.dtype == F32:
        return _dw_f32(conv3x3_dw, x, vec, dy, out, bits_i, (h, w))
    inv, shift, vstride, tile_rows = _dw_operands(x, vec, dy, out)
    _check_rows(m)
    p = conv3x3_dw_plan(m, h, w, cb, g)
    part = torch.empty(p.runs, 9 * cb, g, device=x.device,
                       dtype=torch.float32)
    code = build.lib().cunet_conv3x3_dw(
        x.data_ptr(), x.stride(0), m, h, w, cb, inv, shift, vstride,
        tile_rows, bits_i, dy.data_ptr(), dy.stride(0), g, part.data_ptr(),
        p.runs, p.run_rows, p.br, p.kc, p.nt, p.stages, p.zero_off,
        p.stage_off, p.stage_bytes, p.dy_off, p.smem, _stream(x))
    build.check(code, "conv3x3_dw")
    sum_rows(part, out)
    conv3x3_dw.launches += 1
    conv3x3_dw.option_launches += bits_i > 0
    return out


# ---------------------------------------------------------------------------
# B2 bn_bwd
# ---------------------------------------------------------------------------


def bn_bwd_plain(x, d_a, stats, bn, eps, d_x, dbn, accumulate=False):
    t, k = stats.shape[0], x.shape[1]
    xt = x.float().reshape(t, -1, k)
    da = d_a.reshape(t, -1, k)
    rstd = torch.rsqrt(stats[:, 1, None] + eps)
    xh = (xt - stats[:, 0, None]) * rstd
    sb = da.sum(dim=1, keepdim=True)
    sg = (da * xh).sum(dim=1, keepdim=True)
    rows = xt.shape[1]
    dx = rstd * bn[0, :k] * (da - sb / rows - xh * (sg / rows))
    dx = dx.reshape(-1, k)
    if accumulate:
        d_x += dx
    else:
        d_x.copy_(dx)
    dbn.copy_(torch.cat([sg, sb], dim=1).sum(dim=0))
    return d_x


@dataclasses.dataclass(frozen=True)
class BnBwdPlan:
    """How ``bn_bwd``'s kernel cuts each BN tile: blocks of ``cb`` channels
    (``BN_BWD_THREADS`` threads: cb/8 channel vectors x ``stripes`` row
    stripes), ``cs`` blocks a tile (one thread block cluster), rank q owning
    the tile's rows [q*rpb, min((q+1)*rpb, tile_rows)); a block's rows in
    chunks of ``rc`` (rc / stripes rows a thread), ``slots`` chunk buffers
    of x and d_a in shared memory: every chunk where ``resident`` (kept for
    pass 2), else a ring both passes stream through; ``smem`` bytes in all
    (the buffers, then the warps', the block's and the tile's sums)."""
    cb: int
    cs: int
    rpb: int
    rc: int
    slots: int
    smem: int

    @property
    def stripes(self) -> int:
        return BN_BWD_THREADS // (self.cb // 8)

    @property
    def chunks(self) -> int:
        return -(-self.rpb // self.rc)

    @property
    def resident(self) -> bool:
        return self.slots >= self.chunks

    def grid(self, tiles: int, k: int):
        """(channel blocks, tiles x cluster ranks): the channel blocks of a
        tile vary fastest, a tile's ranks form one cluster along y."""
        return -(-k // self.cb), tiles * self.cs

    def blocks(self, tiles: int, k: int) -> int:
        gx, gy = self.grid(tiles, k)
        return gx * gy

    def rows(self, rank: int, tile_rows: int) -> range:
        return range(min(tile_rows, rank * self.rpb),
                     min(tile_rows, (rank + 1) * self.rpb))


def _bn_bwd_layout(cb: int, cs: int, tile_rows: int,
                   xb: int = 2) -> BnBwdPlan:
    def smem(slots, rc):       # the buffers, the warps', block's, tile's sums
        return (slots * rc * cb * (xb + 4)
                + (2 * BN_BWD_THREADS // 32 + 4) * cb * 4)

    stripes = BN_BWD_THREADS // (cb // 8)
    rpb = -(-tile_rows // cs)
    rc = stripes * -(-rpb // (stripes * 8))   # at most 8 chunks
    slots = -(-rpb // rc)
    if smem(slots, rc) > SMEM_LIMIT:
        rc, slots = 2 * stripes, BN_BWD_RING
    return BnBwdPlan(cb=cb, cs=cs, rpb=rpb, rc=rc, slots=slots,
                     smem=smem(slots, rc))


def bn_bwd_plan(m: int, tile_rows: int, k: int,
                f32: bool = False) -> BnBwdPlan:
    """The kernel plan of ``bn_bwd`` at these shapes (a function of them
    alone). Channel blocks of 64 or 32 where they divide K (else 16). The
    widest channel block, then the smallest cluster (1-8 blocks a tile,
    each of at least ``BN_BWD_MIN_ROWS`` rows), whose blocks keep their
    rows in shared memory and reach ``BN_BWD_BLOCKS``. Where the rows are
    too few for that (r <= 8 on the main path), one block a tile of the
    narrowest channel block: smaller clusters and blocks were slower
    there (PERF.md section 6, PR 10). Where they are too many for shared
    memory, the ring in clusters of ``BN_BWD_CLUSTER``. With ``f32`` the
    buffers hold float32 x (8 bytes an element with d_a, 6 at bf16)."""
    tiles = m // tile_rows
    xb = 4 if f32 else 2
    cbs = [c for c in (64, 32) if k % c == 0] or [16]
    for cb in cbs:
        for cs in (1, 2, 4, BN_BWD_CLUSTER):
            p = _bn_bwd_layout(cb, cs, tile_rows, xb)
            if cs > 1 and p.rpb < BN_BWD_MIN_ROWS:
                break
            if p.resident and p.blocks(tiles, k) >= BN_BWD_BLOCKS:
                return p
    p = _bn_bwd_layout(cbs[-1], 1, tile_rows, xb)
    return p if p.resident else _bn_bwd_layout(cbs[-1], BN_BWD_CLUSTER,
                                               tile_rows, xb)


def bn_bwd(x, d_a, stats, bn, eps, d_x, dbn, *, accumulate=False):
    """Ghost-BN backward of a stage: with per tile (rows m, xh = (x - mu)
    * rstd, ig = rstd * gamma), ``d_x (+)= ig * (d_a - sum(d_a)/m - xh *
    sum(d_a*xh)/m)`` and ``dbn = [sum_t sum(d_a*xh); sum_t sum(d_a)]``
    ([d_gamma; d_beta]). x (M, K) is the stage input, d_a (M, K) float32
    the pre-ReLU cotangent, stats (T, 2, K) the forward's [mean; biased
    var], bn (2, >=K) [gamma; beta]; d_x an (M, K) float32 view, written
    or, with ``accumulate``, added to (the stage's channel range of the
    block's input cotangent).

    Replaces the BN-jacobian of ``cunet_tpu/kernels/train_slot.py::
    _affine_bwd`` (the classic two-sum BN backward). Bound on the H100 by
    reading x and d_a once and writing d_x (56.3 us at r=64, K=192, batch
    24). Design (``csrc/train_kernels.cu``, plan ``bn_bwd_plan``): a tile's
    rows are split over the blocks of one thread block cluster; each block
    copies its rows into shared memory with cp.async, several chunks in
    flight, and sums them as they land; the blocks add the cluster's
    partial sums in rank order through distributed shared memory, so every
    block holds the tile's sums without a trip through device memory, and
    pass 2 reads the rows from shared memory where they fit (HBM sees x
    and d_a once), else streams them again. Per-tile partials, added over
    tiles by ``sum_rows``; no atomics, so two calls give the same bits. On
    an H100 80GB HBM3 at 700 W (PERF.md section 6, PR 10): 103.3 us at
    r=64, K=192 with its ``sum_rows`` (the kernel before it 321.7,
    ``native_batch_norm_backward`` 142.2), 4.9 at r=4. A float32 x runs
    the kernel at float32 (x staged as float32, ``bn_bwd_plan(...,
    f32=True)``).
    """
    m, k = x.shape
    if tuple(d_a.shape) != (m, k) or tuple(d_x.shape) != (m, k) \
            or tuple(stats.shape[1:]) != (2, k) or bn.shape[-1] < k \
            or tuple(dbn.shape) != (2, k):
        raise ValueError(f"bn_bwd shapes: x {tuple(x.shape)}, d_a "
                         f"{tuple(d_a.shape)}, stats {tuple(stats.shape)}, "
                         f"bn {tuple(bn.shape)}, d_x {tuple(d_x.shape)}, "
                         f"dbn {tuple(dbn.shape)}")
    tile_rows = _tiles(m, stats)
    if x.device.type == "cpu":
        return bn_bwd_plain(x, d_a, stats, bn, eps, d_x, dbn, accumulate)
    dev = x.device
    _check_view(x, "x", (BF16, F32))
    _check_f32(d_a, "d_a", dev)
    _check_f32(d_x, "d_x", dev)
    _check_contig_f32(stats, "stats", dev)
    _check_contig_f32(bn, "bn", dev)
    _check_contig_f32(dbn, "dbn", dev)
    f32 = x.dtype == F32
    p = bn_bwd_plan(m, tile_rows, k, f32)
    part = torch.empty(stats.shape[0], 2, k, device=dev, dtype=torch.float32)
    code = build.lib().cunet_bn_bwd(
        x.data_ptr(), x.stride(0), d_a.data_ptr(), d_a.stride(0), m,
        tile_rows, k, stats.data_ptr(), bn[0].data_ptr(), float(eps),
        d_x.data_ptr(), d_x.stride(0), int(accumulate), part.data_ptr(),
        p.cb, p.cs, p.rpb, p.rc, p.slots, p.smem, int(f32), _stream(x))
    build.check(code, "bn_bwd")
    bn_bwd.launches += 1
    bn_bwd.f32_launches += f32
    sum_rows(part, dbn)
    return d_x


# ---------------------------------------------------------------------------
# B6 maxpool2_bwd / B7 upsample2_bwd
# ---------------------------------------------------------------------------


def maxpool2_bwd_plain(ahead, d_pool, b, h, w, out):
    c = ahead.shape[1]
    a6 = ahead.float().reshape(b, h // 2, 2, w // 2, 2, c)
    quads = [a6[:, :, i, :, j] for i in range(2) for j in range(2)]
    mx = torch.maximum(torch.maximum(quads[0], quads[1]),
                       torch.maximum(quads[2], quads[3]))
    dp = d_pool.float().reshape(b, h // 2, w // 2, c)
    taken = torch.zeros_like(mx, dtype=torch.bool)
    parts = []
    for q in quads:
        win = (q == mx) & ~taken
        taken |= win
        parts.append(torch.where(win, dp, 0.0))
    d6 = torch.stack([torch.stack(parts[0:2], dim=3),
                      torch.stack(parts[2:4], dim=3)], dim=2)
    out.copy_(d6.reshape(b * h * w, c))
    return out


def maxpool2_bwd(ahead, d_pool, b, h, w, out):
    """Backward of the 2x2/2 max pool: ``d_pool`` ((b*h/2*w/2, C) float32)
    goes to the first (row-major) element of each window equal to the
    window max of ``ahead`` (b*h*w, C), the pool's recomputed input; the
    rest of ``out`` (b*h*w, C) is zero.

    Replaces ``cunet_tpu/kernels/train_slot.py::_pool_bwd``. Like it, the
    winner comes from the backward's own recompute of ahead and never from
    comparing with the forward's saved pooled values, so a rounding-
    divergent recompute cannot zero a window and an exact tie cannot count
    twice. Pure data movement; one thread per 8 channels of a window.
    Float32 ahead and out: the same kernel at float32 (the window compared
    unrounded, the cotangent written unrounded).
    """
    m, c = ahead.shape
    if m != b * h * w or h % 2 or w % 2 or tuple(out.shape) != (m, c) \
            or tuple(d_pool.shape) != (m // 4, c):
        raise ValueError(f"maxpool2_bwd shapes: ahead {tuple(ahead.shape)}, "
                         f"d_pool {tuple(d_pool.shape)}, out "
                         f"{tuple(out.shape)}, image {b}x{h}x{w}")
    if ahead.device.type == "cpu":
        return maxpool2_bwd_plain(ahead, d_pool, b, h, w, out)
    _check_view(ahead, "ahead", (BF16, F32))
    _check_view(out, "out", (BF16, F32))
    _check_dtypes(ahead, out=out)
    _check_f32(d_pool, "d_pool", ahead.device)
    f32 = ahead.dtype == F32
    code = build.lib().cunet_maxpool2_bwd(
        ahead.data_ptr(), ahead.stride(0), d_pool.data_ptr(),
        d_pool.stride(0), out.data_ptr(), out.stride(0), b, h, w, c,
        int(f32), _stream(ahead))
    build.check(code, "maxpool2_bwd")
    maxpool2_bwd.launches += 1
    maxpool2_bwd.f32_launches += f32
    return out


def upsample2_bwd_plain(d_up, b, h, w, out):
    c = d_up.shape[1]
    d = d_up.float().reshape(b, h, 2, w, 2, c).sum(dim=(2, 4))
    out.copy_(d.reshape(b * h * w, c))
    return out


def upsample2_bwd(d_up, b, h, w, out):
    """Backward of the 2x nearest upsample: ``out`` (b*h*w, C) is the f32
    sum of the 2x2 replicas in ``d_up`` ((b*2h*2w, C) float32), rounded to
    ``out``'s dtype.

    Replaces ``cunet_tpu/kernels/train_slot.py::_upsample_bwd``. Pure data
    movement; one thread per 8 channels of a low-resolution pixel. A
    float32 ``out`` takes the sum unrounded.
    """
    c = d_up.shape[1]
    if d_up.shape[0] != 4 * b * h * w or tuple(out.shape) != (b * h * w, c):
        raise ValueError(f"upsample2_bwd shapes: d_up {tuple(d_up.shape)}, "
                         f"out {tuple(out.shape)}, image {b}x{h}x{w}")
    if d_up.device.type == "cpu":
        return upsample2_bwd_plain(d_up, b, h, w, out)
    _check_f32(d_up, "d_up", d_up.device)
    _check_view(out, "out", (BF16, F32))
    f32 = out.dtype == F32
    code = build.lib().cunet_upsample2_bwd(
        d_up.data_ptr(), d_up.stride(0), out.data_ptr(), out.stride(0), b, h,
        w, c, int(f32), _stream(d_up))
    build.check(code, "upsample2_bwd")
    upsample2_bwd.launches += 1
    upsample2_bwd.f32_launches += f32
    return out


KERNELS = (bn_stats, affine_dx, conv3x3_dx, affine_dw, conv3x3_dw, bn_bwd,
           maxpool2_bwd, upsample2_bwd, sum_rows)
PLAIN = {bn_stats: bn_stats_plain, affine_dx: affine_dx_plain,
         conv3x3_dx: conv3x3_dx_plain, affine_dw: affine_dw_plain,
         conv3x3_dw: conv3x3_dw_plain, bn_bwd: bn_bwd_plain,
         maxpool2_bwd: maxpool2_bwd_plain, upsample2_bwd: upsample2_bwd_plain,
         sum_rows: sum_rows_plain}
OPTIONS = {affine_dx: "ste", conv3x3_dx: "ste", affine_dw: "bits_i",
           conv3x3_dw: "bits_i"}
# the wrappers with a float32 form (sum_rows is float32 at every dtype)
F32_FORMS = KERNELS[:-1]


def reset_launch_counts() -> None:
    reset_counts(KERNELS, OPTIONS)


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def option_counts() -> dict:
    return count_options(OPTIONS)


def f32_counts() -> dict:
    return count_f32(F32_FORMS)


def f32_option_counts() -> dict:
    return count_f32_options(OPTIONS)


for _k in F32_FORMS:
    _k.f32_launches = 0
reset_launch_counts()
