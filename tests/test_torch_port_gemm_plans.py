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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cunet_tpu.kernels.fused_hourglass import _bottleneck_val
from cunet_tpu.kernels.train_slot import _dot, _dot_dx, _norm_relu, _ste_mask
from cunet_tpu_torch.kernels import buf_ops, train_ops
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
    with pytest.raises(ValueError, match="affine_dot"):
        buf_ops.affine_dot_plan(1024, 4096, 128)
    with pytest.raises(ValueError, match="affine_dx"):
        train_ops.affine_dx_plan(1024, 128, 8192)


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


def affine_dot_mirror(x, vec, w, plan, bias=None, bits_i=0):
    """affine_dot as its kernel cuts it: each (row tile, column group) item
    computed alone by the plain arithmetic (f32 affine per row's ghost
    tile, ReLU, bf16, quantizer, the product, the epilogue, one bf16
    rounding), written into a NaN output."""
    m, k = x.shape
    n = w.shape[1]
    out = torch.full((m, n), float("nan"), dtype=torch.bfloat16)
    for t, g in _plan_items(plan.ngrp, plan.tiles(m)):
        rows = range(t * plan.bm, min(m, (t + 1) * plan.bm))
        cols = slice(g * plan.ncol, min(n, (g + 1) * plan.ncol))
        rv = _row_vec(vec, rows, m)
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
# tiles (r=16, batch 24)
MIRROR = [(24 * 8 * 8, 192, 128, 12, False, 0),
          (8 * 16 * 16, 160, 128, 0, True, 0), (1000, 136, 24, 4, True, 8),
          (300, 128, 72, 1, False, 0), (520, 40, 16, 0, True, 0),
          (24 * 16 * 16, 128, 16, 12, False, 8)]


@pytest.mark.parametrize("m,k,n,tiles,flag,bits", MIRROR)
def test_affine_dot_partition_matches_plain_and_jax(m, k, n, tiles, flag,
                                                    bits):
    rng = np.random.default_rng(m + k + n)
    x, vec, bn, st, w, bias = _operands(rng, m, k, n, tiles)
    b = bias if flag else None
    plan = buf_ops.affine_dot_plan(m, k, n)
    got = affine_dot_mirror(x, vec, w, plan, b, bits)
    plain = torch.empty(m, n, dtype=torch.bfloat16)
    buf_ops.affine_dot_plain(x, vec, w, plain, b, bits)
    assert torch.equal(got, plain)
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
