"""The host-side plans of the port's two 1x1 GEMM kernels, on the CPU:
``buf_ops.affine_dot_plan`` (the BN-fold + ReLU + 1x1 of the whole-model
forward and of the ghost-BN train forward) and ``train_ops.affine_dx_plan``
(its input gradient, gated by the forward's ReLU).

At CU-Net-8 @256's shapes (eval at batch 8, 64 and 256; train at batch 24,
ghost-BN tile 2; r = 64 ... 4; K = 128 ... 320; N = 16, the face head's 72
and 128) and at tails (K = 8, 40, 136; rows that no row tile divides; row
tiles across ghost tiles; one tile), these tests hold the plans'
invariants: every row and column computed by exactly one warp of one
block whatever the persistent grid, shared memory within the H100's
227 KB, row strides that keep ldmatrix free of bank conflicts, the
weight's swizzle, the blocks the plans promise, and plans that are
functions of the shapes alone. A torch mirror of each kernel's partition
then runs the plain version tile by tile in the plan's order and is held
against ``affine_dot_plain`` / ``affine_dx_plain`` bit for bit, and
against the JAX package's ``_bottleneck_val`` / ``_norm_relu`` + ``_dot``
(the bf16 limit) and ``_dot_dx`` with its ReLU and STE gates (the float32
sum limit; PERF.md section 2).

Where no layout keeps ``affine_dot``'s weight resident (K >= 888: the
intermedia adapter of CU-Net-8's widths at order >= 6), the plan streams
the weight by K chunk: every ``affine_dot`` and ``apply`` call of a
CU-Net-8 forward and train forward at orders 6 and 14 has a plan that fits,
every shape that planned before keeps the plan it had (a copy of the
earlier search, ``resident_plan``), and the streamed partition's mirror
joins the mirror cases.
"""

import contextlib
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cunet_tpu.kernels.fused_hourglass import _bottleneck_val
from cunet_tpu.kernels.train_slot import _dot, _dot_dx, _norm_relu, _ste_mask
from cunet_tpu_torch.kernels import buf_ops, train_ops
from cunet_tpu_torch.kernels import train_bottleneck as tbk
from cunet_tpu_torch.kernels.buf_ops import SMEM_LIMIT, quantize_act
from cunet_tpu_torch.kernels.train_slot import _affine_vec

RES = (64, 32, 16, 8, 4)
KS = (128, 160, 192, 256, 288, 320)          # the stages' widths
EPS = 1e-5
# (batch, r, K, N, ghost-BN tiles or 0 for eval) on the main path: the
# stages (N = 128) at every width and resolution, the heads (128 -> 16,
# and the face model's 68 classes padded to 72) at r=64
MAIN = ([(b, r, k, 128, 0) for b in (8, 64, 256) for r in RES for k in KS]
        + [(24, r, k, 128, 12) for r in RES for k in KS]
        + [(b, 64, 128, n, t) for b, t in ((8, 0), (64, 0), (24, 12))
           for n in (16, 72)])
# (rows, K, N, tiles): K tails (8, 40, 136), rows no row tile divides, row
# tiles across ghost tiles (250-row tiles), one tile, N tails (8, 24, 136)
TAILS = [(216, 8, 8, 3), (520, 40, 16, 0), (1000, 136, 24, 4),
         (300, 128, 72, 1), (520, 200, 136, 0), (3000, 136, 48, 3),
         (16, 40, 24, 1), (8 * 64 * 64 + 8, 128, 16, 0)]


def _shape(s):
    """(rows, K, N, tiles) of a MAIN or TAILS entry."""
    if len(s) == 5:
        b, r, k, n, t = s
        return b * r * r, k, n, t
    return s


def _id(s):
    return "m{}-k{}-n{}-t{}".format(*_shape(s))


def _grids(groups, items):
    """Persistent grids the kernels may launch with: a block an SM or two
    (cut to a multiple of the column groups), every item its own block,
    one block a group."""
    out = {groups, max(groups, items - items % groups)}
    for g in (132, 264):
        g = min(g, items)
        out.add(max(groups, g - g % groups))
    return sorted(out)


def _items_once(tiles, groups, grid):
    """The (tile, group) items the kernels' blocks walk for ``grid``: block
    b keeps group b % groups and takes tiles b // groups, + grid // groups,
    ... (csrc: affine_dot_kernel, dx_kernel). Returns the hit counts."""
    hits = np.zeros((tiles, groups), int)
    stride = grid // groups
    for b in range(grid):
        hits[b // groups::stride, b % groups] += 1
    return hits


def _warp_cover(bm, row_warps, ntw):
    """Hits of a (bm, 8 * ntw * col_warps) block tile by its 8 warps: warp
    w owns rows (w % row_warps) * 32 .. + 32 and n8 tiles
    (w // row_warps) * ntw .. + ntw."""
    col_warps = 8 // row_warps
    hits = np.zeros((bm, 8 * ntw * col_warps), int)
    for w in range(8):
        wm, wn = w % row_warps, w // row_warps
        hits[wm * 32:wm * 32 + 32, wn * ntw * 8:(wn + 1) * ntw * 8] += 1
    return hits


def _swizzle(nt):
    """(shift, mask) of the weight's 16-byte XOR swizzle (csrc
    dot_swizzle)."""
    if nt % 8 == 0:
        return 0, 7
    if nt % 4 == 0:
        return 1, 3
    if nt % 2 == 0:
        return 2, 1
    return 0, 0


@pytest.mark.parametrize("shape", MAIN + TAILS, ids=_id)
def test_affine_dot_plan_covers_every_output_once(shape):
    m, k, n, _ = _shape(shape)
    p = buf_ops.affine_dot_plan(m, k, n)
    assert p.bm in (32, 64, 128) and p.row_warps * p.col_warps == 8
    assert 1 <= p.ntw <= buf_ops.DOT_MAX_NTW
    assert p.ncol == 8 * p.ntw * p.col_warps
    assert (p.ngrp - 1) * p.ncol < n <= p.ngrp * p.ncol
    assert p.kp == -(-k // 16) * 16
    # every (row tile, column group) once, for any grid the launch picks;
    # every row and column of a block's tile by one warp
    for grid in _grids(p.ngrp, p.items(m)):
        assert (_items_once(p.tiles(m), p.ngrp, grid) == 1).all()
    assert (_warp_cover(p.bm, p.row_warps, p.ntw) == 1).all()
    assert (p.tiles(m) - 1) * p.bm < m <= p.tiles(m) * p.bm
    # shared memory: the weight group, the x buffers, the output stages
    assert p.stages in (2, 3)
    assert p.w_bytes >= p.kp * p.ncol * 2
    assert p.stage_bytes >= p.bm * (p.kp + 8) * 2
    assert p.out_off == p.w_bytes + p.stages * p.stage_bytes
    assert p.smem == p.out_off + 8 * 16 * (8 * p.ntw + 8) * 2 <= SMEM_LIMIT
    assert all(v % 128 == 0 for v in (p.w_bytes, p.stage_bytes, p.out_off))
    # x rows at an odd number of 16-byte chunks: ldmatrix's eight rows in
    # eight bank groups; the weight's swizzle keeps every chunk in its row
    # and puts any eight consecutive rows of one chunk in eight groups
    assert (p.kp + 8) * 2 // 16 % 2 == 1
    nt = p.ncol // 8
    sh, mk = _swizzle(nt)
    rows = np.arange(p.kp)
    for j in range(nt):
        phys = j ^ ((rows >> sh) & mk)
        assert (phys < nt).all()
        slots = (rows * nt + phys) % 8
        for r0 in range(0, p.kp, 8):
            assert len(set(slots[r0:r0 + 8])) == 8


@pytest.mark.parametrize("shape", MAIN + TAILS, ids=_id)
def test_affine_dx_plan_covers_every_output_once(shape):
    m, k, n, _ = _shape(shape)
    p = train_ops.affine_dx_plan(m, k, n)
    assert p.bm in (32, 64, 128) and p.row_warps * p.col_warps == 8
    assert 1 <= p.ntw <= train_ops.AFFINE_DX_MAX_NTW
    # column blocks of a multiple of 16 that the warps fill exactly
    assert p.kc % 16 == 0 and p.kc == 8 * p.ntw * p.col_warps
    assert (p.nkb - 1) * p.kc < k <= p.nkb * p.kc
    assert p.np_ == -(-n // 16) * 16
    for grid in _grids(p.nkb, p.items(m)):
        assert (_items_once(p.tiles(m), p.nkb, grid) == 1).all()
    assert (_warp_cover(p.bm, p.row_warps, p.ntw) == 1).all()
    assert p.stages in (2, 3)
    assert p.w_bytes >= p.kc * (p.np_ + 8) * 2
    assert p.dy_bytes >= p.bm * (p.np_ + 8) * 2
    assert p.stage_bytes >= p.dy_bytes + p.bm * (p.kc + 8) * 2
    assert p.smem == p.w_bytes + p.stages * p.stage_bytes <= SMEM_LIMIT
    assert all(v % 128 == 0 for v in (p.w_bytes, p.dy_bytes, p.stage_bytes))
    # weight and dy rows (read by ldmatrix) at an odd number of 16-byte
    # chunks; the gate rows hold whole 16-byte vectors
    assert (p.np_ + 8) * 2 // 16 % 2 == 1
    assert (p.kc + 8) * 2 % 16 == 0


def test_plans_fill_the_card_on_the_main_path():
    """At r >= 32 every stage's plan (N = 128) has at least 132 items, one
    for each of the card's SMs; at r = 16 at least 100 (batch 8: 64 row
    tiles of 32, N in two groups). At r=64 N is not cut (affine_dot reads x
    once), the tiles are 64 rows, two blocks an SM, up to K=192 (128 rows
    alone at K=256, 64 rows alone above), and affine_dx's K=192 is three
    blocks of 64 (no idle part of a block)."""
    for b, r, k, n, t in MAIN:
        if n != 128 or b not in (8, 24):
            continue
        m = b * r * r
        dot = buf_ops.affine_dot_plan(m, k, n)
        assert dot.items(m) >= (132 if r >= 32 else 100 if r == 16 else 1)
        if t:
            dx = train_ops.affine_dx_plan(m, k, n)
            assert dx.items(m) >= (132 if r >= 16 else 1)
            assert dx.nkb * dx.kc - k < 16 * dx.col_warps // 2 + dx.kc // 2
        if r == 64:
            assert dot.ngrp == 1 and dot.bm == (128 if k == 256 else 64)
            assert (dot.smem <= buf_ops.SMEM_PAIR) == (k <= 192)
    dx = train_ops.affine_dx_plan(24 * 64 * 64, 192, 128)
    assert (dx.bm, dx.kc, dx.nkb, dx.ntw, dx.stages) == (64, 64, 3, 2, 2)
    assert dx.smem <= buf_ops.SMEM_PAIR
    dot = buf_ops.affine_dot_plan(8 * 64 * 64, 192, 128)
    assert (dot.bm, dot.ncol, dot.ntw, dot.stages) == (64, 128, 4, 2)


def test_plans_are_functions_of_the_shapes_alone(monkeypatch):
    """No device query: the same shapes give the same plans, and with every
    CUDA query broken the plans still come out."""
    def plans():
        return ([buf_ops.affine_dot_plan(*_shape(s)[:3]) for s in MAIN + TAILS]
                + [train_ops.affine_dx_plan(*_shape(s)[:3])
                   for s in MAIN + TAILS])

    want = plans()

    def broken(*a, **k):
        raise AssertionError("a plan asked the device")

    for name in ("get_device_properties", "device_count", "current_device",
                 "is_available"):
        monkeypatch.setattr(torch.cuda, name, broken)
    buf_ops.affine_dot_plan.cache_clear()
    train_ops.affine_dx_plan.cache_clear()
    assert plans() == want


def test_plans_raise_where_nothing_fits():
    """``affine_dx`` raises where no layout fits; ``affine_dot`` streams
    its weight where no resident layout fits, which fits at any K."""
    p = buf_ops.affine_dot_plan(1024, 4096, 128)
    assert p.kc == buf_ops.DOT_STREAM_K and p.smem <= SMEM_LIMIT
    with pytest.raises(ValueError, match="affine_dx"):
        train_ops.affine_dx_plan(1024, 128, 8192)


# ---------------------------------------------------------------------------
# the streamed weight: plans at large K
# ---------------------------------------------------------------------------


def _parent_layout(bm, k, n, split, stages, limit):
    """``_dot_layout`` as it was before the streamed form (resident
    weight only)."""
    wn = buf_ops.DOT_WARPS // (bm // buf_ops.DOT_WARP_ROWS)
    ncol = -(-(-(-n // split)) // (8 * wn)) * 8 * wn
    ntw = ncol // (8 * wn)
    if ntw > buf_ops.DOT_MAX_NTW:
        return None
    kp = -(-k // 16) * 16
    w_bytes = -(-kp * ncol * 2 // 128) * 128
    stage_bytes = -(-bm * (kp + 8) * 2 // 128) * 128
    out_bytes = 8 * 16 * (ntw * 8 + 8) * 2
    for st in stages:
        out_off = w_bytes + st * stage_bytes
        if out_off + out_bytes <= limit:
            return buf_ops.DotPlan(bm=bm, ncol=ncol, ngrp=-(-n // ncol),
                                   ntw=ntw, kp=kp, stages=st,
                                   w_bytes=w_bytes, stage_bytes=stage_bytes,
                                   out_off=out_off, smem=out_off + out_bytes)
    return None


def resident_plan(m, k, n):
    """``affine_dot_plan`` as it was before the streamed form; None where
    it raised."""
    best = None
    groups = -(-n // 128)
    for split in (groups, 2 * groups):
        for limit, stages, tiles in ((buf_ops.SMEM_PAIR, (2,), (128, 64)),
                                     (SMEM_LIMIT, (3, 2), (128, 64, 32))):
            for bm in tiles:
                p = _parent_layout(bm, k, n, split, stages, limit)
                if p is None or (limit == buf_ops.SMEM_PAIR and not (
                        p.smem <= buf_ops.SMEM_PAIR
                        and p.ntw <= buf_ops.PAIR_NTW)):
                    continue
                if p.items(m) >= buf_ops.DOT_ITEMS:
                    return p
                if best is None or p.items(m) > best.items(m):
                    best = p
    return best


@contextlib.contextmanager
def one_thread():
    """One intra-op thread for the model init and forward that record call
    shapes (a context manager, or a decorator): their thousands of small
    ops each pay for a hand-off to the thread pool, and beside the other
    tier-1 workers every pool is oversubscribed (one bn0 recording forward
    with its plan checks: about 1 s alone, 256 s with five copies beside it
    on eight cores; 1.3 s with one thread each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
@one_thread()
def _model_calls(order, train, bn_tile=2):
    """{(M, K, N)} of every ``affine_dot`` call (and with ``bn_tile=0``
    every #7 ``apply`` call) of a forward of CU-Net-8's widths (c=128,
    g=32, 16 classes) at ``order`` (layer_num max(8, order + 1)): eval on
    the whole-model path at batch 8, or the train forward at batch 24
    (ghost-BN tile 2, or ``bn_tile``), read from the port's forward on the
    CPU at 64 x 64 images (M scales by 16) and batch 1 or 2 (M scales to
    the batch). Recorded once a configuration, on one intra-op thread
    (``one_thread``)."""
    from cunet_tpu_torch.config import ModelConfig
    from cunet_tpu_torch.models import apply_cu_net, init_cu_net

    layers = max(8, order + 1)
    cfg = ModelConfig(layer_num=layers, order=order, class_num=16,
                      loss_num=2, use_pallas=True, pallas_whole_model=True,
                      bn_tile=bn_tile)
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    n_img = 2 if train else 1
    scale = 16 * (24 if train else 8) // n_img
    calls = set()

    def dot(x, vec, w, out, **kw):
        calls.add((scale * x.shape[0], x.shape[1], w.shape[1]))
        return buf_ops.affine_dot_plain(x, vec, w, out, kw.get("bias"),
                                        kw.get("bits_i", 0))

    def apply(xs, vec, w, out, table=None):
        calls.add((scale * xs[0].shape[0], sum(x.shape[1] for x in xs),
                   w.shape[1]))
        return tbk.apply_plain(xs, vec, w, out)

    x = torch.rand(n_img, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        for mod in ("buf_ops", "model_buf", "train_slot"):
            target = getattr(__import__("cunet_tpu_torch.kernels." + mod,
                                        fromlist=["x"]), "affine_dot", None)
            if target is not None:
                mp.setattr(f"cunet_tpu_torch.kernels.{mod}.affine_dot", dot)
        mp.setattr(tbk, "apply", apply)
        apply_cu_net(params, state, x, cfg=cfg, train=train)
    return frozenset(calls)


# (order, train, bn_tile): the eval whole-model forward and the ghost-BN
# train forward at orders 6 and 14; #7's apply at order 14
MODEL_RUNS = [(6, False, 2), (14, False, 2), (6, True, 2), (14, True, 2),
              (14, True, 0)]


@pytest.mark.parametrize("order,train,bn_tile", MODEL_RUNS,
                         ids=lambda v: str(v))
def test_every_affine_dot_call_at_large_order_has_a_plan(order, train,
                                                        bn_tile):
    """Each call plans within the H100's shared memory (``apply`` with its
    table chunks); the intermedia adapter streams (K = 128 (1 + order) >=
    888, from slot 7 at order 6), no other call does, and every call that
    planned before keeps that plan."""
    calls = _model_calls(order, train, bn_tile)
    ks = {k for _, k, _ in calls}
    assert 128 * (1 + order) in ks
    streamed = set()
    for m, k, n in sorted(calls):
        p = buf_ops.affine_dot_plan(m, k, n)
        assert p.smem <= SMEM_LIMIT and tbk.apply_smem(p) <= SMEM_LIMIT
        before = resident_plan(m, k, n)
        if before is not None:
            assert p == before, (m, k, n)
        else:
            assert p.kc == buf_ops.DOT_STREAM_K and k >= 888, (m, k, n)
            streamed.add(k)
    assert streamed == {k for k in ks if k >= 888} != set()
    assert streamed <= {128 * (1 + i) for i in range(order + 1)}


def test_resident_plans_are_unchanged():
    """Every shape of MAIN and TAILS, and every K up to 880 at the main
    path's row counts, plans as before: no stream."""
    for s in MAIN + TAILS:
        m, k, n, _ = _shape(s)
        assert buf_ops.affine_dot_plan(m, k, n) == resident_plan(m, k, n)
    for k in range(8, 888, 8):
        for m in (8 * 64 * 64, 24 * 64 * 64, 24 * 4 * 4):
            want = resident_plan(m, k, 128)
            assert want is not None and want.kc == 0
            assert buf_ops.affine_dot_plan(m, k, 128) == want
    assert resident_plan(8 * 64 * 64, 888, 128) is None


@pytest.mark.parametrize("k", [888, 896, 1000, 1920, 4096])
@pytest.mark.parametrize("m,n", [(8 * 64 * 64, 128), (24 * 64 * 64, 128),
                                 (24 * 4 * 4, 128), (8 * 4 * 4, 16),
                                 (1000, 72)])
def test_stream_plan_covers_every_output_once(m, k, n):
    p = buf_ops.affine_dot_plan(m, k, n)
    assert p.kc == buf_ops.DOT_STREAM_K
    assert p.kp % p.kc == 0 and p.kp - p.kc < k <= p.kp
    assert p.bm in (32, 64, 128) and p.row_warps * p.col_warps == 8
    assert p.ncol == 8 * p.ntw * p.col_warps
    assert (p.ngrp - 1) * p.ncol < n <= p.ngrp * p.ncol
    for grid in _grids(p.ngrp, p.items(m)):
        assert (_items_once(p.tiles(m), p.ngrp, grid) == 1).all()
    assert (_warp_cover(p.bm, p.row_warps, p.ntw) == 1).all()
    # a stage: the chunk's weight, then its x columns at kc + 8
    assert p.w_bytes >= p.kc * p.ncol * 2
    assert p.stage_bytes >= p.w_bytes + p.bm * (p.kc + 8) * 2
    assert p.out_off == p.stages * p.stage_bytes
    assert p.smem == p.out_off + 8 * 16 * (8 * p.ntw + 8) * 2 <= SMEM_LIMIT
    assert tbk.apply_smem(p) <= SMEM_LIMIT
    assert all(v % 128 == 0 for v in (p.w_bytes, p.stage_bytes, p.out_off))
    assert (p.kc + 8) * 2 // 16 % 2 == 1
    # the swizzle repeats within 8 rows, so a chunk's rows keep the
    # resident form's banks
    nt = p.ncol // 8
    sh, mk = _swizzle(nt)
    rows = np.arange(p.kp)
    assert (((rows >> sh) & mk) == (((rows % p.kc) >> sh) & mk)).all()
    for j in range(nt):
        slots = (rows * nt + (j ^ ((rows >> sh) & mk))) % 8
        for r0 in range(0, p.kc, 8):
            assert len(set(slots[r0:r0 + 8])) == 8


# ---------------------------------------------------------------------------
# mirrors of the kernels' partitions
# ---------------------------------------------------------------------------


def _operands(rng, m, k, n, tiles):
    """bf16 x (a strided view, as the buffers hand it in), eval (2, K) or
    per-tile (T, 2, K) [inv; shift], the BN params and stats behind them,
    a bf16 (K, N) weight, a float32 bias."""
    xb = torch.from_numpy(2 * rng.standard_normal((m, k + 8), np.float32)
                          ).to(torch.bfloat16)
    x = xb[:, 8:]
    bn = torch.from_numpy(np.stack([rng.random(k, np.float32) + 0.5,
                                    0.3 * rng.standard_normal(k,
                                                              np.float32)]))
    if tiles:
        st = torch.empty(tiles, 2, k)
        train_ops.bn_stats_plain(x, st)
        vec = _affine_vec(st, bn, EPS)
    else:
        st = None
        vec = torch.from_numpy(np.stack([
            rng.random(k, np.float32) + 0.5,
            0.5 * rng.standard_normal(k, np.float32)]))
    w = torch.from_numpy(rng.standard_normal((k, n), np.float32)
                         * k ** -0.5).to(torch.bfloat16)
    bias = torch.from_numpy(0.5 * rng.standard_normal(n, np.float32))
    return x, vec, bn, st, w, bias


def _row_vec(vec, rows, m):
    """The [inv; shift] of each row of ``rows``: (len, 2, K)."""
    if vec.dim() == 2:
        return vec[None].expand(len(rows), -1, -1)
    tile_rows = m // vec.shape[0]
    return vec[torch.as_tensor(rows) // tile_rows]


def _plan_items(groups, tiles):
    """The items in the order a grid of one block a group walks them."""
    return [(t, g) for g in range(groups) for t in range(tiles)]


def _stream_item(x, rv, w, plan, rows, cols, bits_i):
    """One item of the streamed kernel: each K chunk [c0, c0 + kc) of the
    tile's x and of the group's weight slice loaded alone (zero past K),
    the prologue on the chunk's columns below K only, the chunks laid side
    by side into one accumulator's operands, cut back to K (the kernel's
    last chunk stops at K rounded up to 16; the columns between are
    zeros)."""
    k = x.shape[1]
    zs, ws = [], []
    for c0 in range(0, plan.kp, plan.kc):
        c1 = min(k, c0 + plan.kc)
        xc = torch.zeros(len(rows), plan.kc, dtype=x.dtype)
        wc = torch.zeros(plan.kc, cols.stop - cols.start, dtype=w.dtype)
        xr = x[rows.start:rows.stop, c0:c1].float()
        xc[:, :c1 - c0] = torch.relu(xr * rv[:, 0, c0:c1]
                                     + rv[:, 1, c0:c1]).to(x.dtype)
        wc[:c1 - c0] = w[c0:c1, cols]
        zs.append(xc)
        ws.append(wc)
    z = torch.cat(zs, 1)[:, :k]
    return quantize_act(z, bits_i).float() @ torch.cat(ws)[:k].float()


def affine_dot_mirror(x, vec, w, plan, bias=None, bits_i=0):
    """affine_dot as its kernel cuts it: each (row tile, column group) item
    computed alone by the plain arithmetic (f32 affine per row's ghost
    tile, ReLU, bf16, quantizer, the product, the epilogue, one bf16
    rounding), written into a NaN output; a streamed plan's items chunk by
    chunk (``_stream_item``)."""
    m, k = x.shape
    n = w.shape[1]
    out = torch.full((m, n), float("nan"), dtype=torch.bfloat16)
    for t, g in _plan_items(plan.ngrp, plan.tiles(m)):
        rows = range(t * plan.bm, min(m, (t + 1) * plan.bm))
        cols = slice(g * plan.ncol, min(n, (g + 1) * plan.ncol))
        rv = _row_vec(vec, rows, m)
        if plan.kc:
            acc = _stream_item(x, rv, w, plan, rows, cols, bits_i)
        else:
            xr = x[rows.start:rows.stop].float()
            z = torch.relu(xr * rv[:, 0, :k] + rv[:, 1, :k]).to(x.dtype)
            acc = quantize_act(z, bits_i).float() @ w[:k, cols].float()
        if bias is not None:
            acc = torch.relu(acc + bias[cols])
        out[rows.start:rows.stop, cols] = acc.to(out.dtype)
    return out


def affine_dx_mirror(dy, w, x, vec, plan, ste=False):
    """affine_dx as its kernel cuts it: each (row tile, column block) item
    alone, dy's rows times the block's rows of W, gated by the forward's
    f32 prologue of its x rows (and the STE gate), into a NaN output."""
    m, k = x.shape
    out = torch.full((m, k), float("nan"))
    for t, c in _plan_items(plan.nkb, plan.tiles(m)):
        rows = range(t * plan.bm, min(m, (t + 1) * plan.bm))
        cols = slice(c * plan.kc, min(k, (c + 1) * plan.kc))
        rv = _row_vec(vec, rows, m)
        z = x[rows.start:rows.stop, cols].float() * rv[:, 0, cols] \
            + rv[:, 1, cols]
        gate = z > 0
        if ste:
            gate = gate & (z.to(x.dtype).float() < 1)
        d = dy[rows.start:rows.stop].float() @ w[cols].float().t()
        out[rows.start:rows.stop, cols] = torch.where(gate, d, 0.0)
    return out


def _bf16_limit(scale):
    return 2e-2 * scale + 1e-2


def _sum_limit(n, scale):
    return 1e-5 * n ** 0.5 * scale + 1e-6


# (rows, K, N, tiles, bias / ste, bits_i): per-tile 32-row tiles with N in
# two groups (r=8, batch 24), eval 32-row tiles in two groups (r=16,
# batch 8), 250-row ghost tiles across row tiles with the quantizer, one
# tile, the face head's 72 columns, K = 40 with the BN2 epilogue, 64-row
# tiles (r=16, batch 24); streamed: the intermedia adapter at order 6
# (eval, r=16, batch 2) and 14 (per tile, r=4, batch 24), K = 1000 (a
# partial last chunk, 250-row ghost tiles, the quantizer) with the
# epilogue, N = 72
MIRROR = [(24 * 8 * 8, 192, 128, 12, False, 0),
          (8 * 16 * 16, 160, 128, 0, True, 0), (1000, 136, 24, 4, True, 8),
          (300, 128, 72, 1, False, 0), (520, 40, 16, 0, True, 0),
          (24 * 16 * 16, 128, 16, 12, False, 8),
          (2 * 16 * 16, 896, 128, 0, False, 0),
          (24 * 4 * 4, 1920, 128, 12, False, 0),
          (1000, 1000, 72, 4, True, 8)]


def _exact_operands(rng, m, k, n, tiles):
    """Operands whose float32 products and sums are exact in any order: x
    on a grid of 1/16 below 8, [inv; shift] of 1/2, 1 or 2 and a multiple
    of 1/16 (the prologue on a grid of 1/32 below 24, exact in bf16), a
    weight of {-1, 0, 1} / 4 (every partial sum a multiple of 1/128 below
    2^13 in magnitude: 20 bits)."""
    x = torch.from_numpy(rng.integers(-127, 128, (m, k)) / 16.0).to(
        torch.bfloat16)
    inv = torch.from_numpy(rng.choice([0.5, 1.0, 2.0], (max(tiles, 1), k)))
    shift = torch.from_numpy(rng.integers(-16, 17, (max(tiles, 1), k))
                             / 16.0)
    vec = torch.stack([inv, shift], 1).float()
    w = torch.from_numpy(rng.integers(-1, 2, (k, n)) / 4.0).to(
        torch.bfloat16)
    return x, (vec if tiles else vec[0]), w


@pytest.mark.parametrize("m,k,n,tiles,flag,bits", MIRROR)
def test_affine_dot_partition_matches_plain_and_jax(m, k, n, tiles, flag,
                                                    bits):
    """The mirror bit for bit the plain version; at a streamed plan on
    ``_exact_operands`` (the CPU's float32 product sums a long K in an
    order that depends on the rows of the call), then on the random
    operands within the bf16 limit of JAX."""
    rng = np.random.default_rng(m + k + n)
    x, vec, bn, st, w, bias = _operands(rng, m, k, n, tiles)
    b = bias if flag else None
    plan = buf_ops.affine_dot_plan(m, k, n)
    xe, ve, we = (x, vec, w) if not plan.kc else _exact_operands(
        rng, m, k, n, tiles)
    got = affine_dot_mirror(xe, ve, we, plan, b, bits)
    plain = torch.empty(m, n, dtype=torch.bfloat16)
    buf_ops.affine_dot_plain(xe, ve, we, plain, b, bits)
    assert torch.equal(got, plain)
    if plan.kc:
        assert (plain != 0).float().mean() > 0.25
        got = affine_dot_mirror(x, vec, w, plan, b, bits)
    if bits:
        return        # JAX's _norm_relu / _bottleneck_val have no quantizer
    if tiles:
        tr = m // tiles
        want = np.concatenate([np.asarray(_dot(
            _norm_relu(jnp.asarray(x[t * tr:(t + 1) * tr].float().numpy()),
                       jnp.asarray(bn.numpy()), jnp.asarray(st[t, 0].numpy()),
                       jnp.asarray(st[t, 1].numpy()), jnp.float32, EPS),
            jnp.asarray(w.float().numpy()), jnp.bfloat16))
            for t in range(tiles)])
    else:
        want = np.asarray(_bottleneck_val(
            jnp.asarray(x.float().numpy()), jnp.asarray(vec.numpy()),
            jnp.asarray(w.float().numpy()), jnp.bfloat16))
    if b is not None:
        want = np.maximum(want + b.numpy(), 0.0)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= _bf16_limit(np.abs(want).max())


# (rows, K, N, tiles, ste): K = 192 in two blocks of 96 (64-row tiles,
# r=16) and in three of 64 (32-row tiles, r=8), 250-row ghost tiles across
# row tiles with the STE gate, one tile with N = 72, K = 40, the head's
# STE gate (128 -> 16)
DX_MIRROR = [(24 * 16 * 16, 192, 128, 12, False),
             (24 * 8 * 8, 192, 128, 12, False), (1000, 136, 24, 4, True),
             (300, 40, 72, 1, False), (216, 40, 16, 3, False),
             (24 * 16 * 16, 128, 16, 12, True)]


@pytest.mark.parametrize("m,k,n,tiles,ste", DX_MIRROR)
def test_affine_dx_partition_matches_plain_and_jax(m, k, n, tiles, ste):
    rng = np.random.default_rng(m + k + n + 1)
    x, vec, _, _, w, _ = _operands(rng, m, k, n, tiles)
    if ste:           # activations around 1.0, where the STE gate decides
        x = (x.float() * 0.25 + 1.0).to(torch.bfloat16)
        vec = torch.stack([torch.ones(tiles, k),
                           torch.full((tiles, k), -2.0 ** -10)], 1)
    dy = torch.from_numpy(rng.standard_normal((m, n), np.float32)
                          ).to(torch.bfloat16)
    plan = train_ops.affine_dx_plan(m, k, n)
    got = affine_dx_mirror(dy, w, x, vec, plan, ste)
    plain = torch.empty(m, k)
    train_ops.affine_dx_plain(dy, w, x, vec, plain, ste)
    assert torch.equal(got, plain)
    if ste:
        passed = (got != 0).float().mean().item()
        assert 0.05 < passed < 0.95
    tr = m // tiles
    want = []
    for t in range(tiles):
        sl = slice(t * tr, (t + 1) * tr)
        z = jnp.asarray(x[sl].float().numpy()) * jnp.asarray(
            vec[t, 0].numpy()) + jnp.asarray(vec[t, 1].numpy())
        d = _dot_dx(jnp.asarray(dy[sl].float().numpy()),
                    jnp.asarray(w.float().numpy()), jnp.bfloat16)
        d = jnp.where(z > 0, d, 0.0)
        if ste:
            d = _ste_mask(d, z.astype(jnp.bfloat16))
        want.append(np.asarray(d))
    want = np.concatenate(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= _sum_limit(n, np.abs(want).max())
    assert np.array_equal(got.numpy() == 0, want == 0)
