"""The host-side plans of the ghost-BN backward's two row reductions, on the
CPU: ``train_ops.bn_bwd_plan`` (the BN jacobian, a tile's rows split over a
thread block cluster) and ``train_ops.affine_dw_plan`` (the 1x1 weight
gradient, the rows cut into runs of whole steps).

At CU-Net-8 @256's stage shapes (batch 8 and 24, ghost-BN tile 2, r = 64
... 4, K = 128 ... 320, N = 128 and the head's 16) and at the card tests'
tails, these tests hold the plans' invariants: every row and channel (and
column) counted once, a block's rows within one BN tile, clusters within
the portable 8, shared memory within the H100's 227 KB, the blocks the
plans promise, and plans that are functions of the shapes alone. A torch
mirror of each kernel's split then sums each block's rows and adds the
partials in the plan's rank or run order, and is held against the plain
versions and against the JAX package's ``_affine_bwd`` / ``_dot_dw``
within the float32 sum limit (PERF.md section 2).

The float32 plans: ``bn_bwd_plan(..., f32=True)`` is the portable
search's plan (a copy of it here, ``_portable_plan``) wherever that keeps
a tile's rows in shared memory, and the bf16 plans are that search's
everywhere; at r=64 (tiles of 2 and 6 images) the persistent kernel's
clusters of 16 with a thread's rows in registers; ``stats_plan_f32`` one
wave of whole row stripes. Every float32 step shape (tiles 1, 2, 6, order
14's widths) is checked, and every plan is a function of the shapes alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cunet_tpu.kernels.train_slot import _affine_bwd, _dot_dw
from cunet_tpu_torch.kernels import train_ops
from cunet_tpu_torch.kernels.buf_ops import SMEM_LIMIT, quantize_act
from cunet_tpu_torch.kernels.buf_ops import tile_affine
from cunet_tpu_torch.kernels.train_slot import _affine_vec

RES = (64, 32, 16, 8, 4)
KS = (128, 160, 192, 256, 288, 320)          # the stages' widths
# (batch, r, K) of bn_bwd on the main path (12 or 4 BN tiles), and tails:
# (rows, tiles, K) with K = 8, 40, 136, one tile, tile rows not dividing
# by the cluster, rows too many for shared memory (the ring)
BN_MAIN = [(n, r, k) for n in (8, 24) for r in RES for k in KS]
BN_TAILS = [(216, 3, 8), (216, 3, 40), (300, 1, 136), (3003, 3, 64),
            (40, 1, 16), (24 * 4100, 24, 32), (2 * 65536, 2, 64),
            (12 * 1000, 12, 192)]
# (batch, r, K, N) of affine_dw: the adapters and bottlenecks (N = 128),
# the head (128 -> 16), and tails (rows, K, N): K = 8, 40, 136, rows not
# dividing a step, N = 8, 24, 136 and the face model's head (68 classes,
# padded to 72)
DW_MAIN = ([(n, r, k, 128) for n in (8, 24) for r in RES for k in KS]
           + [(n, 64, 128, 16) for n in (8, 24)])
DW_TAILS = [(216, 8, 8), (216, 40, 16), (216, 200, 136), (1000, 136, 24),
            (100, 16, 128), (24 * 64 * 64 + 8, 320, 128),
            (8 * 64 * 64, 128, 72)]


def _bn_shape(s):
    """(rows, tile rows, K) of a BN_MAIN or BN_TAILS entry."""
    if s in BN_MAIN:
        n, r, k = s
        return n * r * r, 2 * r * r, k
    m, tiles, k = s
    return m, m // tiles, k


def _dw_shape(s):
    if s in DW_MAIN:
        n, r, k, c = s
        return n * r * r, k, c
    return s


def _bn_id(s):
    return "m{}-tile{}-k{}".format(*_bn_shape(s))


def _dw_id(s):
    return "m{}-k{}-n{}".format(*_dw_shape(s))


def _sum_limit(n, scale):
    """PERF.md section 2: a float32 n-term sum in another order."""
    return 1e-5 * n ** 0.5 * scale + 1e-6


@pytest.mark.parametrize("shape", BN_MAIN + BN_TAILS, ids=_bn_id)
def test_bn_bwd_plan_counts_every_row_and_channel_once(shape):
    m, tile_rows, k = _bn_shape(shape)
    tiles = m // tile_rows
    p = train_ops.bn_bwd_plan(m, tile_rows, k)
    assert p.cb in (16, 32, 64) and (k % p.cb == 0 or p.cb == 16)
    assert p.cs in (1, 2, 4, 8) and p.cs <= train_ops.BN_BWD_CLUSTER
    # the ranks of a cluster partition the tile's rows, each rank's rows
    # contiguous and inside the tile; a split tile gives each block at
    # least BN_BWD_MIN_ROWS rows (a ring's blocks more than they can hold)
    rows = [i for q in range(p.cs) for i in p.rows(q, tile_rows)]
    assert rows == list(range(tile_rows))
    assert p.cs == 1 or p.rpb >= train_ops.BN_BWD_MIN_ROWS
    # a chunk gives each of the block's stripes the same number of rows;
    # the buffers hold every chunk (resident) or a ring of them
    assert p.rc % p.stripes == 0
    assert p.stripes * (p.cb // 8) == train_ops.BN_BWD_THREADS
    if p.resident:
        assert p.slots * p.rc >= p.rpb and p.chunks <= 8
    else:
        assert p.slots == train_ops.BN_BWD_RING < p.chunks
    # the channel blocks cover K, the grid holds every tile's cluster
    gx, gy = p.grid(tiles, k)
    assert gy == tiles * p.cs and (gx - 1) * p.cb < k <= gx * p.cb
    sums = (2 * train_ops.BN_BWD_THREADS // 32 + 4) * p.cb * 4
    assert p.smem == p.slots * p.rc * p.cb * 6 + sums <= SMEM_LIMIT


def test_bn_bwd_plan_fills_the_card_on_the_main_path():
    """At r >= 16 every stage width puts at least one block on each of the
    132 SMs, with every row in shared memory (x and d_a read once); at
    r=64 a tile's 8192 rows are split over a cluster of 8; at r <= 8 a
    block holds a tile's 32 channels."""
    for n, r, k in BN_MAIN:
        m, tile_rows, _ = _bn_shape((n, r, k))
        p = train_ops.bn_bwd_plan(m, tile_rows, k)
        assert p.resident
        if r >= 16 and n == 24:
            assert p.blocks(m // tile_rows, k) >= 132
        if r == 64 and n == 24:
            assert (p.cs, p.cb, p.rpb) == (8, 32, 1024)
        if r <= 8:
            assert (p.cs, p.cb) == (1, 32)


@pytest.mark.parametrize("shape", DW_MAIN + DW_TAILS, ids=_dw_id)
def test_affine_dw_plan_counts_every_row_channel_and_column_once(shape):
    m, k, n = _dw_shape(shape)
    p = train_ops.affine_dw_plan(m, k, n)
    # the runs partition the rows in whole steps
    assert p.br in (16, 32, 64) and p.run_rows % p.br == 0
    rows = [i for q in range(p.runs) for i in p.run(q, m)]
    assert rows == list(range(m))
    # channel blocks of multiples of 16 up to 128, column groups of 16-128
    assert p.kc % 16 == 0 and p.kc <= 128
    assert (p.nkb - 1) * p.kc < k <= p.nkb * p.kc
    assert p.ncol in (16, 32, 64, 128)
    assert (p.ngrp - 1) * p.ncol < n <= p.ngrp * p.ncol
    # the kernel's warps (NTW n8 tiles each, WN across the columns, the
    # channel tiles interleaved over the other 8 / WN) write every (k, n)
    # of the partial once
    ntw = 4 if p.ncol >= 32 else 2
    wn_n = p.ncol // (8 * ntw)
    wc_n = 8 // wn_n
    hits = np.zeros((p.nkb * p.kc, p.ngrp * p.ncol), int)
    for y in range(p.nkb):
        for z in range(p.ngrp):
            for warp in range(8):
                wc, wn = warp % wc_n, warp // wc_n
                for i in range(8 // wc_n):
                    ct = wc + wc_n * i
                    if ct >= p.kc // 16:
                        continue
                    c = y * p.kc + ct * 16
                    o = z * p.ncol + wn * ntw * 8
                    hits[c:c + 16, o:o + 8 * ntw] += 1
    assert (hits == 1).all()
    assert p.stages in (2, 3)
    assert p.x_bytes >= p.br * (p.kc + 8) * 2
    assert p.stage_bytes >= p.x_bytes + p.br * (p.ncol + 8) * 2
    assert p.smem == p.stages * p.stage_bytes <= SMEM_LIMIT
    assert all(v % 128 == 0 for v in (p.x_bytes, p.stage_bytes))
    # odd 16-byte chunks a row: ldmatrix's eight rows in eight bank groups
    assert (p.kc + 8) * 2 // 16 % 2 == 1 and (p.ncol + 8) * 2 // 16 % 2 == 1


def test_affine_dw_plan_fills_the_card_on_the_main_path():
    """At batch 24 every stage's plan puts a block on each of the 132 SMs,
    and at most two, at every resolution; at r >= 16 K is cut into equal
    blocks (no idle half block at 160-320), at r >= 32 N=128 stays one
    group and a run has at least two 64-row steps."""
    for n, r, k, c in DW_MAIN:
        if n != 24:
            continue
        p = train_ops.affine_dw_plan(n * r * r, k, c)
        assert 132 <= p.blocks <= train_ops.AFFINE_DW_BLOCKS == 264
        if r >= 16:
            assert p.nkb * p.kc - k < p.kc // 2
        if r >= 32:
            assert p.ngrp == 1 and p.br == 64 and p.run_rows >= 128
    p = train_ops.affine_dw_plan(24 * 64 * 64, 192, 128)
    assert (p.kc, p.nkb, p.br, p.blocks) == (96, 2, 64, 256)


def _portable_plan(m, tile_rows, k, xb):
    """The plan search of the portable clusters as it stood before the
    float32 kernel's persistent plan (1-8 blocks a tile, the ring past
    them): what ``bn_bwd_plan`` must still give at bf16 everywhere, and at
    float32 wherever it keeps a tile's rows in shared memory."""
    def layout(cb, cs):
        stripes = train_ops.BN_BWD_THREADS // (cb // 8)
        rpb = -(-tile_rows // cs)
        rc = stripes * -(-rpb // (stripes * 8))
        slots = -(-rpb // rc)
        sums = (2 * train_ops.BN_BWD_THREADS // 32 + 4) * cb * 4
        if slots * rc * cb * (xb + 4) + sums > SMEM_LIMIT:
            rc, slots = 2 * stripes, train_ops.BN_BWD_RING
        return (cb, cs, rpb, rc, slots,
                slots * rc * cb * (xb + 4) + sums)

    tiles = m // tile_rows
    cbs = [c for c in (64, 32) if k % c == 0] or [16]
    for cb in cbs:
        for cs in (1, 2, 4, 8):
            p = layout(cb, cs)
            if cs > 1 and p[2] < train_ops.BN_BWD_MIN_ROWS:
                break
            if p[4] >= -(-p[2] // p[3]) and \
                    -(-k // cb) * tiles * cs >= train_ops.BN_BWD_BLOCKS:
                return p
    p = layout(cbs[-1], 1)
    return p if p[4] >= -(-p[2] // p[3]) else layout(cbs[-1], 8)


def _key(p):
    return (p.cb, p.cs, p.rpb, p.rc, p.slots, p.smem)


# (rows, tile rows, K) of the float32 ghost-BN step at tiles 1, 2 and 6
# (batch 24): every stage width and order 14's intermedia adapter
F32_MAIN = sorted({(24 * r * r, t * r * r, k) for t in (1, 2, 6)
                   for r in RES for k in KS + (160 + 32 * 14, 128 * 15)})


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
def test_bn_bwd_plans_unchanged_where_a_portable_cluster_fits(f32):
    """bf16: every plan the portable search's, bit for bit the kernels
    they were; float32: the same wherever that search keeps a tile's rows
    in shared memory (r <= 32 on the main path), so only r=64 changes (to
    the persistent kernel; a tail tile of 65,536 rows keeps the ring)."""
    shapes = [_bn_shape(s) for s in BN_MAIN + BN_TAILS] + F32_MAIN
    for m, tr, k in shapes:
        old = _portable_plan(m, tr, k, 4 if f32 else 2)
        p = train_ops.bn_bwd_plan(m, tr, k, f32)
        if not f32:
            assert _key(p) == old and not p.persistent
        elif old[4] >= -(-old[2] // old[3]):
            assert _key(p) == old and not p.persistent, (m, tr, k)
        else:                   # persistent, or the ring where none fits
            assert p.persistent or _key(p) == old, (m, tr, k)
            assert p.persistent or tr > 6 * 4096


@pytest.mark.parametrize("m,tr,k", F32_MAIN,
                         ids=lambda v: str(v))
def test_bn_bwd_f32_plan_keeps_every_tile_on_chip(m, tr, k):
    """At every shape of the float32 step each tile's rows stay on chip:
    resident in a portable cluster, or (r=64) on the persistent kernel's
    clusters of ``BN_F32_CLUSTER``, its rows of a thread within
    ``BN_F32_ROWS`` registers, every row of the tile in one rank, the
    channel blocks covering K, shared memory within the H100's."""
    p = train_ops.bn_bwd_plan(m, tr, k, True)
    assert p.smem <= SMEM_LIMIT
    assert [i for q in range(p.cs) for i in p.rows(q, tr)] == list(range(tr))
    assert (-(-k // p.cb) - 1) * p.cb < k <= -(-k // p.cb) * p.cb
    if not p.persistent:
        assert p.resident and p.cs <= train_ops.BN_BWD_CLUSTER
        return
    assert tr in (2 * 4096, 6 * 4096)          # r=64, tiles 2 and 6
    assert p.cs == train_ops.BN_F32_CLUSTER <= 16
    assert p.cb in train_ops.BN_F32_CBS and p.cb % 4 == 0
    assert p.rc == p.rpb and p.slots == 1       # one item buffer
    assert p.thread_rows <= train_ops.BN_F32_ROWS
    assert (p.cb, p.slots) == {2 * 4096: (32, 1), 6 * 4096: (16, 1)}[tr]


@pytest.mark.parametrize("m,tr,k", F32_MAIN, ids=lambda v: str(v))
def test_bn_bwd_f32_accumulating_plan_stages_d_x(m, tr, k):
    """With ``accumulate`` (d_x added into) the float32 plan is the one
    without it wherever a portable cluster keeps a tile's rows; at r=64
    the persistent kernel with d_x's item buffer beside x's and d_a's (12
    bytes an element) in shared memory, at most ``BN_F32_ACC_ROWS`` rows
    a thread (the kernel's one accumulating instance), every row of the
    tile in one rank, the channel blocks covering K (tile 2: 32 channels;
    tile 6: 8, where no block of 16 or more fits)."""
    p = train_ops.bn_bwd_plan(m, tr, k, True, accumulate=True)
    q = train_ops.bn_bwd_plan(m, tr, k, True)
    assert p.smem <= SMEM_LIMIT
    assert [i for r in range(p.cs) for i in p.rows(r, tr)] == list(range(tr))
    assert (-(-k // p.cb) - 1) * p.cb < k <= -(-k // p.cb) * p.cb
    if not q.persistent:
        assert p == q
        return
    assert p.persistent and p.cb == {2 * 4096: 32, 6 * 4096: 8}[tr]
    assert p.cb in train_ops.BN_F32_CBS
    assert p.cs == train_ops.BN_F32_CLUSTER <= 16
    assert p.rc == p.rpb and p.slots == 1
    assert p.thread_rows <= train_ops.BN_F32_ACC_ROWS
    assert p.smem > 12 * p.rpb * p.cb


@pytest.mark.parametrize("m,tr,k", F32_MAIN, ids=lambda v: str(v))
def test_stats_plan_f32_is_one_wave_of_whole_row_stripes(m, tr, k):
    """``bn_stats``' float32 plan: clusters of ``STATS_F32_CLUSTERS`` (1
    where a split block would hold fewer than ``STATS_F32_MIN_ROWS``
    rows), the grid within one wave of ``STATS_F32_BLOCKS``, every row of
    a tile in one block, a block's rows whole stripes of 32."""
    cs, rpb = train_ops.stats_plan_f32(m, tr, k)
    assert cs == 1 or cs in train_ops.STATS_F32_CLUSTERS
    assert rpb % 32 == 0 and (cs - 1) * rpb < tr <= cs * rpb
    if cs > 1:
        assert rpb >= train_ops.STATS_F32_MIN_ROWS
        assert m // tr * -(-k // 64) * cs <= train_ops.STATS_F32_BLOCKS


def test_plans_are_functions_of_the_shapes_alone(monkeypatch):
    """No device query: the same shapes give the same plans, and with every
    CUDA query broken the plans still come out (so the split of the sums,
    and their bits, cannot depend on the card)."""
    def plans():
        return ([train_ops.bn_bwd_plan(*_bn_shape(s))
                 for s in BN_MAIN + BN_TAILS]
                + [train_ops.bn_bwd_plan(*s, True) for s in F32_MAIN]
                + [train_ops.bn_bwd_plan(*s, True, True) for s in F32_MAIN]
                + [train_ops.stats_plan_f32(*s) for s in F32_MAIN]
                + [train_ops.affine_dw_plan(*_dw_shape(s))
                   for s in DW_MAIN + DW_TAILS])

    want = plans()

    def broken(*a, **k):
        raise AssertionError("a plan asked the device")

    for name in ("get_device_properties", "device_count", "current_device",
                 "is_available"):
        monkeypatch.setattr(torch.cuda, name, broken)
    assert plans() == want


# ---------------------------------------------------------------------------
# mirrors of the kernels' splits
# ---------------------------------------------------------------------------


def _bn_operands(rng, m, tiles, k):
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32)
                         ).to(torch.bfloat16)
    d_a = torch.from_numpy(rng.standard_normal((m, k), np.float32))
    st = torch.empty(tiles, 2, k)
    train_ops.bn_stats_plain(x, st)
    bn = torch.from_numpy(np.stack([rng.random(k, np.float32) + 0.5,
                                    0.3 * rng.standard_normal(k,
                                                              np.float32)]))
    return x, d_a, st, bn


def bn_bwd_mirror(x, d_a, st, bn, eps, plan):
    """bn_bwd as its kernel splits it: each cluster rank's [sum d_a*xh;
    sum d_a] over its own rows, the tile's sums the ranks' partials added
    in rank order, d_x from them; dbn the tiles' sums in tile order."""
    tiles, k = st.shape[0], x.shape[1]
    tile_rows = x.shape[0] // tiles
    rstd = torch.rsqrt(st[:, 1] + eps)
    d_x = torch.empty(x.shape)
    dbn = torch.zeros(2, k)
    for t in range(tiles):
        lo = t * tile_rows
        xh = (x[lo:lo + tile_rows].float() - st[t, 0]) * rstd[t]
        da = d_a[lo:lo + tile_rows]
        sums = torch.zeros(2, k)
        for q in range(plan.cs):
            rows = plan.rows(q, tile_rows)
            part = torch.stack([(da[rows.start:rows.stop]
                                 * xh[rows.start:rows.stop]).sum(0),
                                da[rows.start:rows.stop].sum(0)])
            sums = sums + part
        d_x[lo:lo + tile_rows] = rstd[t] * bn[0, :k] * (
            da - sums[1] / tile_rows - xh * (sums[0] / tile_rows))
        dbn = dbn + sums
    return d_x, dbn


BN_MIRROR = [(24 * 16 * 16, 12, 192), (24 * 8 * 8, 12, 320),
             (24 * 4 * 4, 12, 128), (216, 3, 40), (300, 1, 136),
             (3003, 3, 64), (24 * 4100, 24, 32)]


@pytest.mark.parametrize("m,tiles,k", BN_MIRROR)
def test_bn_bwd_split_matches_plain_and_jax(m, tiles, k):
    rng = np.random.default_rng(m + k)
    x, d_a, st, bn = _bn_operands(rng, m, tiles, k)
    tile_rows = m // tiles
    plan = train_ops.bn_bwd_plan(m, tile_rows, k)
    got_dx, got_dbn = bn_bwd_mirror(x, d_a, st, bn, 1e-5, plan)
    plain_dx, plain_dbn = torch.empty(m, k), torch.empty(2, k)
    train_ops.bn_bwd_plain(x, d_a, st, bn, 1e-5, plain_dx, plain_dbn)
    # JAX's _affine_bwd per tile, its ReLU gate open (z > 0 everywhere)
    jax_dx, jax_dbn = [], np.zeros((2, k), np.float32)
    for t in range(tiles):
        sl = slice(t * tile_rows, (t + 1) * tile_rows)
        dx_t, dbn_t = _affine_bwd(
            jnp.asarray(x[sl].float().numpy()), jnp.asarray(bn.numpy()),
            jnp.asarray(st[t, 0].numpy()), jnp.asarray(st[t, 1].numpy()),
            jnp.asarray(d_a[sl].numpy()), jnp.float32, 1e-5,
            z=jnp.ones((tile_rows, k), jnp.float32))
        jax_dx.append(np.asarray(dx_t))
        jax_dbn = jax_dbn + np.asarray(dbn_t)
    jax_dx = np.concatenate(jax_dx)
    for ref_dx, ref_dbn in ((plain_dx.numpy(), plain_dbn.numpy()),
                            (jax_dx, jax_dbn)):
        err_dx = np.abs(got_dx.numpy() - ref_dx).max()
        err_dbn = np.abs(got_dbn.numpy() - ref_dbn).max()
        assert err_dx <= _sum_limit(tile_rows, np.abs(ref_dx).max())
        assert err_dbn <= _sum_limit(m, np.abs(ref_dbn).max())


def affine_dw_mirror(x, vec, dy, plan, bits_i=0):
    """affine_dw as its kernel splits it: each run's z^T dy over its own
    rows (one partial a run), the partials added in run order."""
    z = quantize_act(torch.relu(tile_affine(x, vec)).to(x.dtype),
                     bits_i).float()
    out = torch.zeros(x.shape[1], dy.shape[1])
    for q in range(plan.runs):
        rows = plan.run(q, x.shape[0])
        out = out + z[rows.start:rows.stop].t() @ dy[rows.start:
                                                     rows.stop].float()
    return out, z


DW_MIRROR = [(24 * 32 * 32, 12, 320, 128, 0), (24 * 8 * 8, 12, 320, 128, 0),
             (24 * 4 * 4, 12, 128, 128, 0), (24 * 16 * 16, 12, 128, 16, 8),
             (216, 3, 40, 16, 0), (1000, 4, 136, 24, 8),
             (2 * 3000, 2, 160, 128, 0)]


@pytest.mark.parametrize("m,tiles,k,n,bits", DW_MIRROR)
def test_affine_dw_split_matches_plain_and_jax(m, tiles, k, n, bits):
    rng = np.random.default_rng(m + k + n)
    x, _, st, bn = _bn_operands(rng, m, tiles, k)
    vec = _affine_vec(st, bn, 1e-5)
    dy = torch.from_numpy(rng.standard_normal((m, n), np.float32)
                          ).to(torch.bfloat16)
    plan = train_ops.affine_dw_plan(m, k, n)
    tile_rows = m // tiles
    if (m, k) == (24 * 32 * 32, 320):       # runs across ghost tiles
        assert any(r.start // tile_rows != (r.stop - 1) // tile_rows
                   for r in (plan.run(q, m) for q in range(plan.runs)))
    got, z = affine_dw_mirror(x, vec, dy, plan, bits)
    plain = torch.empty(k, n)
    train_ops.affine_dw_plain(x, vec, dy, plain, bits)
    ref_jax = np.asarray(_dot_dw(jnp.asarray(z.numpy()),
                                 jnp.asarray(dy.float().numpy()),
                                 jnp.float32))
    for ref in (plain.numpy(), ref_jax):
        err = np.abs(got.numpy() - ref).max()
        assert err <= _sum_limit(m, np.abs(ref).max())
