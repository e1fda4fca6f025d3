"""The host-side plans of the port's tensor-core kernels, on the CPU.

``buf_ops.conv3x3_plan`` (the forward), ``train_ops.conv3x3_dx_plan`` (the
input gradient), ``train_ops.conv3x3_dw_plan`` (the weight gradient) and
``train_bottleneck.reduce_plan`` (#7's backward reductions) decide how the
kernels cut rows, the reduction, channels and outputs, and lay out shared
memory. These tests hold their invariants at the main path's shapes and
at the tails the card tests use: every output row in one tile, every
reduction step in one warp, every (tap, channel, output) and every row
counted once in dW, shared memory within the H100's 227 KB, and a plan
that is a function of the shapes alone. A numpy mirror of the kernels'
index map (halo tile, tap rows, the zero row, dx's flipped taps) then
computes the conv, its input gradient and its weight gradient from
exactly the rows the kernels read, with the halo rows no tap may read set
to NaN, and is held against PyTorch.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cunet_tpu_torch.kernels import buf_ops, train_bottleneck, train_ops

# (images, r, Cb, G): CU-Net-8 @256 at batch 8, 24 and 64 at every conv
# resolution, and the card tests' tails (channels 16-512, outputs 8-72,
# widths not dividing a tile)
MAIN = [(n, r, 128, 32) for n in (8, 24, 64) for r in (64, 32, 16, 8, 4)]
TAILS = [(3, 8, 16, 8), (3, 2, 16, 8), (3, 4, 48, 24), (5, 6, 128, 32),
         (4, 12, 128, 40), (16, 32, 48, 8), (2, 20, 24, 16), (2, 8, 512, 64),
         (2, 16, 128, 72), (4, 8, 256, 32), (1, 128, 128, 64),
         (1, 300, 16, 8)]
SHAPES = MAIN + TAILS


def _id(s):
    return "n{}-r{}-cb{}-g{}".format(*s)


@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_conv3x3_plan_covers_rows_steps_channels_and_outputs_once(shape):
    n, r, cb, g = shape
    m = n * r * r
    p = buf_ops.conv3x3_plan(m, r, r, cb, g)
    assert p.bm in (32, 64, 128)
    assert p.row_warps * p.k_warps == buf_ops.CONV_WARPS
    # tiles [t*bm, (t+1)*bm) cover [0, m) and no tile is past it
    assert (p.tiles(m) - 1) * p.bm < m <= p.tiles(m) * p.bm
    # the k_warps ranges partition the 9*kc/16 steps of a chunk (a warp
    # with none adds zeros)
    steps = [s for wk in range(p.k_warps) for s in p.k_range(wk)]
    assert steps == list(range(9 * p.kc // 16))
    # chunks cover the channels (zero-padded to 16), groups the outputs
    cbp = -(-cb // 16) * 16
    assert p.kc % 16 == 0 and (p.nchunk - 1) * p.kc < cbp <= p.nchunk * p.kc
    assert 1 <= p.nt <= 8
    assert (p.ncol - 1) * 8 * p.nt < g <= p.ncol * 8 * p.nt


@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_conv3x3_plan_fits_shared_memory(shape):
    n, r, cb, g = shape
    p = buf_ops.conv3x3_plan(n * r * r, r, r, cb, g)
    gb = 8 * p.nt
    assert p.smem <= buf_ops.SMEM_LIMIT == 232_448
    assert p.halo_rows == p.bm + 2 * r + 2
    assert p.zero_off == 9 * p.kc * gb * 2              # the weight slice
    assert p.stage_off >= p.zero_off + 2 * p.kc          # the zero row
    assert p.stage_bytes >= p.halo_rows * (p.kc + 8) * 2
    assert p.stage_bytes >= (buf_ops.CONV_WARPS * buf_ops.CONV_WARP_ROWS
                             * (gb + 4) * 4)             # partial sums
    assert p.smem == p.stage_off + p.stages * p.stage_bytes
    assert all(v % 128 == 0 for v in (p.zero_off, p.stage_off,
                                      p.stage_bytes))


@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_conv3x3_dw_plan_counts_every_row_and_tap_once(shape):
    n, r, cb, g = shape
    m = n * r * r
    p = train_ops.conv3x3_dw_plan(m, r, r, cb, g)
    # the runs partition the rows in whole steps, at most DW_RUNS of them
    assert p.run_rows % p.br == 0 and p.runs <= train_ops.DW_RUNS
    rows = [i for q in range(p.runs) for i in p.run(q, m)]
    assert rows == list(range(m))
    # block (y, z), warp (ky, cq), its tiles t and lanes cover every
    # (tap, channel, output) of the (9*Cb, G) result once
    gy, gz = p.grid(cb, g)[1:]
    hits = np.zeros((9, cb, g), int)
    for y in range(gy):
        for z in range(gz):
            for ky in range(3):
                for cq in range(4):
                    for t in range(2):
                        if (2 * cq + t) * 16 >= p.kc:
                            continue
                        c = y * p.kc + (2 * cq + t) * 16 + np.arange(16)
                        c = c[c < cb]
                        o = z * 8 * p.nt + np.arange(8 * p.nt)
                        o = o[o < g]
                        for d in range(3):
                            hits[np.ix_([3 * ky + d], c, o)] += 1
    assert (hits == 1).all()
    assert p.smem <= buf_ops.SMEM_LIMIT
    assert p.dy_off >= p.halo_rows * (p.kc + 8) * 2
    assert p.stage_bytes >= p.dy_off + p.br * 16 * p.nt


def test_plans_are_functions_of_the_shapes_alone(monkeypatch):
    """No device query: the same shapes give the same plans, and with every
    CUDA query broken the plans still come out (so the split of the sums,
    and their bits, cannot depend on the card)."""
    want = [(buf_ops.conv3x3_plan(n * r * r, r, r, cb, g),
             train_ops.conv3x3_dw_plan(n * r * r, r, r, cb, g))
            for n, r, cb, g in SHAPES]

    def broken(*a, **k):
        raise AssertionError("a plan asked the device")

    for name in ("get_device_properties", "device_count", "current_device",
                 "is_available"):
        monkeypatch.setattr(torch.cuda, name, broken)
    got = [(buf_ops.conv3x3_plan(n * r * r, r, r, cb, g),
            train_ops.conv3x3_dw_plan(n * r * r, r, r, cb, g))
           for n, r, cb, g in SHAPES]
    assert got == want


def test_conv3x3_plan_at_the_main_path():
    """The main path's tiles: 128 rows and two stages where M is large, the
    reduction split over the warps where M is small (batch 8, r <= 16),
    the whole 9 x 128 x 32 weight resident."""
    def plan(n, r):
        return buf_ops.conv3x3_plan(n * r * r, r, r, 128, 32)

    assert (plan(8, 64).bm, plan(64, 64).bm, plan(24, 64).bm) == (128,) * 3
    assert all(plan(8, r).k_warps == buf_ops.CONV_WARPS for r in (16, 8, 4))
    assert all(plan(n, r).nchunk == 1 and plan(n, r).stages == 2
               for n, r, _, _ in MAIN)


# ---------------------------------------------------------------------------
# the kernels' index map, mirrored in numpy
# ---------------------------------------------------------------------------


def _halo(x, g0, rows, kc, c0):
    """The halo tile the kernels stage: rows [g0, g0 + rows) of x, channels
    [c0, c0 + kc) zero-padded past x's width; rows outside x are never
    written, so NaN here."""
    m, c = x.shape
    t = np.full((rows, kc), np.nan)
    lo, hi = max(0, -g0), min(rows, m - g0)
    t[lo:hi] = 0.0
    w = max(0, min(kc, c - c0))
    t[lo:hi, :w] = x[g0 + lo:g0 + hi, c0:c0 + w]
    return t


def _tap_row(r, m, in_range, h, w, dy, dx):
    """halo.cuh's tap_row: the halo row that row r (output row m) reads
    through tap (dy, dx), or -1 for the zero row."""
    pix = m % (h * w)
    yy, xx = pix // w, pix % w
    sy, sx = yy + dy, xx + dx
    if not in_range or sy < 0 or sy >= h or sx < 0 or sx >= w:
        return -1
    return r + w + 1 + dy * w + dx


def _gather(halo, r, m, in_range, h, w, dy, dx):
    hr = _tap_row(r, m, in_range, h, w, dy, dx)
    return np.zeros(halo.shape[1]) if hr < 0 else halo[hr]


def _mirror_conv(y, w3p, b, h, w):
    m, cb = y.shape
    g = w3p.shape[1]
    p = buf_ops.conv3x3_plan(m, h, w, cb, g)
    wpad = np.zeros((9, p.nchunk * p.kc, g))
    wpad[:, :cb] = w3p.reshape(9, cb, g)
    out = np.zeros((m, g))
    for tile in range(p.tiles(m)):
        m0 = tile * p.bm
        for chunk in range(p.nchunk):
            c0 = chunk * p.kc
            halo = _halo(y, m0 - w - 1, p.halo_rows, p.kc, c0)
            assert halo.shape[0] == p.bm + 2 * w + 2
            for r in range(p.bm):
                if m0 + r >= m:
                    continue
                for tap in range(9):
                    a = _gather(halo, r, m0 + r, True, h, w, tap // 3 - 1,
                                tap % 3 - 1)
                    out[m0 + r] += a @ wpad[tap, c0:c0 + p.kc]
    return out


def _mirror_dw(x, dy, b, h, w):
    m, cb = x.shape
    g = dy.shape[1]
    p = train_ops.conv3x3_dw_plan(m, h, w, cb, g)
    parts = []
    for q in range(p.runs):
        run = p.run(q, m)
        acc = np.zeros((9, cb, g))
        for m0 in range(run.start, run.stop, p.br):
            for y in range(p.grid(cb, g)[1]):
                c0 = y * p.kc
                halo = _halo(x, m0 - w - 1, p.halo_rows, p.kc, c0)
                for r in range(p.br):
                    mm = m0 + r
                    in_range = mm < run.stop
                    d = dy[mm] if in_range else np.zeros(g)
                    for tap in range(9):
                        a = _gather(halo, r, mm, in_range, h, w,
                                    tap // 3 - 1, tap % 3 - 1)
                        kc = min(p.kc, cb - c0)
                        acc[tap, c0:c0 + kc] += np.outer(a[:kc], d)
        parts.append(acc.reshape(9 * cb, g))
    return np.sum(parts, axis=0), len(parts)


# (images, r, Cb, G): tiles spanning images and W not dividing a tile, a
# channel tail (24), two chunks (256 at kc 128 in dW), small and larger M
MIRROR = [(3, 2, 16, 8), (2, 6, 24, 8), (3, 5, 16, 16), (2, 12, 16, 8),
          (2, 4, 256, 8)]


@pytest.mark.parametrize("shape", MIRROR, ids=_id)
def test_index_map_mirror_computes_the_conv(shape):
    n, r, cb, g = shape
    rng = np.random.RandomState(sum(shape))
    y = rng.randn(n * r * r, cb)
    w3p = rng.randn(9 * cb, g)
    got = _mirror_conv(y, w3p, n, r, r)
    assert np.isfinite(got).all()        # no NaN halo row was read
    want = F.conv2d(torch.from_numpy(y).reshape(n, r, r, cb)
                    .permute(0, 3, 1, 2),
                    torch.from_numpy(w3p).reshape(3, 3, cb, g)
                    .permute(3, 2, 0, 1), padding=1)
    np.testing.assert_allclose(
        got, want.permute(0, 2, 3, 1).reshape(-1, g).numpy(), atol=1e-9)


@pytest.mark.parametrize("shape", MIRROR + [(3, 10, 16, 8)], ids=_id)
def test_index_map_mirror_computes_the_weight_gradient(shape):
    n, r, cb, g = shape
    rng = np.random.RandomState(sum(shape) + 1)
    x = rng.randn(n * r * r, cb)
    dy = rng.randn(n * r * r, g)
    got, runs = _mirror_dw(x, dy, n, r, r)
    assert np.isfinite(got).all()
    want = torch.nn.grad.conv2d_weight(
        torch.from_numpy(x).reshape(n, r, r, cb).permute(0, 3, 1, 2),
        (g, cb, 3, 3),
        torch.from_numpy(dy).reshape(n, r, r, g).permute(0, 3, 1, 2),
        padding=1)
    np.testing.assert_allclose(
        got, want.permute(2, 3, 1, 0).reshape(9 * cb, g).numpy(), atol=1e-9)
    assert runs == -(-n * r * r // 128)


def test_index_map_mirror_fails_on_a_halo_row_off_by_one(monkeypatch):
    """The mirror can fail: a tap row one row off (the fault a halo origin
    one row late would make) reads a NaN halo row or the wrong pixel."""
    shape = (3, 5, 16, 16)
    n, r, cb, g = shape
    rng = np.random.RandomState(5)
    y, w3p = rng.randn(n * r * r, cb), rng.randn(9 * cb, g)
    good = _mirror_conv(y, w3p, n, r, r)
    real = _tap_row

    def off_by_one(rr, *a):
        hr = real(rr, *a)
        return hr - 1 if hr > 0 else hr

    monkeypatch.setitem(globals(), "_tap_row", off_by_one)
    bad = _mirror_conv(y, w3p, n, r, r)
    assert not np.allclose(np.nan_to_num(bad, nan=1e9), good, atol=1e-3)


# ---------------------------------------------------------------------------
# conv3x3_dx's plan and its flipped-tap index map
# ---------------------------------------------------------------------------


def _dx_plan(n, r, cb, g):
    return train_ops.conv3x3_dx_plan(n * r * r, r, r, cb, g, max(1, n // 2))


@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_conv3x3_dx_plan_covers_rows_channels_and_steps_once(shape):
    n, r, cb, g = shape
    m = n * r * r
    p = _dx_plan(n, r, cb, g)
    assert p.bm in (32, 64, 128) and p.gb in (16, 32, 64, 128)
    assert p.wn == min(p.gb, 64) and p.gp == -(-g // 16) * 16
    assert p.row_warps * p.col_warps * p.k_warps == train_ops.DX_WARPS
    # items (tile, channel group) cover every (row, channel) once
    hits = np.zeros((m, cb), int)
    for it in range(p.items(m)):
        tiles = -(-m // p.bm)
        tile, col = it % tiles, it // tiles
        rows = np.arange(tile * p.bm, min(m, (tile + 1) * p.bm))
        cols = np.arange(col * p.gb, min(cb, (col + 1) * p.gb))
        hits[np.ix_(rows, cols)] += 1
    assert (hits == 1).all()
    # the warps' reduction ranges partition the 9 * gp / 16 steps
    steps = [s for wk in range(p.k_warps) for s in p.k_range(wk)]
    assert steps == list(range(9 * p.gp // 16))


@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_conv3x3_dx_plan_fits_shared_memory(shape):
    n, r, cb, g = shape
    m = n * r * r
    p = _dx_plan(n, r, cb, g)
    assert p.smem <= buf_ops.SMEM_LIMIT == 232_448
    assert p.halo_rows == p.bm + 2 * r + 2
    assert p.zero_off == 9 * p.gb * p.gp * 2             # the weight slice
    assert p.stage_off >= p.zero_off + 2 * p.gp           # the zero row
    assert p.stage_bytes >= p.halo_rows * (p.gp + 8) * 2
    assert p.x_off == p.stage_off + p.stages * p.stage_bytes
    assert p.x_bytes >= p.bm * (p.gb + 8) * 2
    assert p.vec_off == p.x_off + p.stages * p.x_bytes
    # the BN tiles one row tile can touch
    tile_rows = m // max(1, n // 2)
    touched = max(len({q // tile_rows for q in range(t, min(m, t + p.bm))})
                  for t in range(0, m, p.bm))
    assert touched <= p.nv and p.vec_bytes >= p.nv * 2 * p.gb * 4
    assert p.red_off == p.vec_off + p.stages * p.vec_bytes
    # partial sums of the split reduction's other warps
    assert p.smem == p.red_off + (p.k_warps - 1) * p.bm * (p.gb + 4) * 4
    assert all(v % 128 == 0 for v in (p.zero_off, p.stage_off, p.x_off,
                                      p.x_bytes, p.vec_off, p.vec_bytes,
                                      p.red_off))


def test_dx_and_reduce_plans_are_functions_of_the_shapes_alone(monkeypatch):
    """As for the conv plans: no device query, the same plans with every
    CUDA query broken."""
    def plans():
        return ([_dx_plan(n, r, cb, g) for n, r, cb, g in SHAPES]
                + [train_bottleneck.reduce_plan(m, c, o)
                   for m, c, o in REDUCE_SHAPES])

    want = plans()

    def broken(*a, **k):
        raise AssertionError("a plan asked the device")

    for name in ("get_device_properties", "device_count", "current_device",
                 "is_available"):
        monkeypatch.setattr(torch.cuda, name, broken)
    assert plans() == want


def test_conv3x3_dx_plan_at_the_main_path():
    """Batch 24, Cb=128 <- G=32: 128-row tiles over all 128 channels where
    M is large (r = 64, 32), the reduction split over the warps below;
    the whole 9 x 128 x 32 weight resident and two halo stages at r=64."""
    def plan(r):
        return _dx_plan(24, r, 128, 32)

    assert (plan(64).bm, plan(64).gb, plan(64).k_warps) == (128, 128, 1)
    assert (plan(32).bm, plan(32).gb) == (128, 128)
    assert all(plan(r).k_warps > 1 for r in (16, 8, 4))
    assert plan(64).stages == 2 and plan(64).zero_off == 9 * 128 * 32 * 2


def _mirror_dx(dy, w3p, b, h, w, flip=True):
    """conv3x3_dx's products as the kernel runs them: per item, the dy halo
    tile (G zero-padded to gp), tap t read at tap_row(t) against the weight
    rows of tap 8 - t (t itself when not ``flip``), every channel group."""
    m, g = dy.shape
    cb = w3p.shape[0] // 9
    p = _dx_plan(b, h, cb, g)
    wpad = np.zeros((9, p.ncol * p.gb, p.gp))
    wpad[:, :cb, :g] = w3p.reshape(9, cb, g)
    out = np.zeros((m, p.ncol * p.gb))
    tiles = -(-m // p.bm)
    for it in range(p.items(m)):
        tile, col = it % tiles, it // tiles
        m0, c0 = tile * p.bm, col * p.gb
        halo = _halo(dy, m0 - w - 1, p.halo_rows, p.gp, 0)
        for r in range(p.bm):
            if m0 + r >= m:
                continue
            for tap in range(9):
                a = _gather(halo, r, m0 + r, True, h, w, tap // 3 - 1,
                            tap % 3 - 1)
                wt = wpad[8 - tap if flip else tap, c0:c0 + p.gb]
                out[m0 + r, c0:c0 + p.gb] += wt @ a
    return out[:, :cb]


# (images, r, Cb, G): tiles spanning images, W not dividing a tile, channel
# tails (24, 48) and groups (Cb = 48 in groups of 16), G not a multiple of
# 16 (8, 24)
DX_MIRROR = [(3, 2, 16, 8), (2, 6, 24, 8), (3, 5, 48, 24), (2, 12, 16, 16),
             (1, 7, 32, 8)]


@pytest.mark.parametrize("shape", DX_MIRROR, ids=_id)
def test_index_map_mirror_computes_the_input_gradient(shape):
    """The mirror of the kernel's flipped taps against the plain version
    (its gate opened everywhere: x = 1, inv = 1, shift = 0), with NaN in
    every halo row no tap may read."""
    n, r, cb, g = shape
    m = n * r * r
    rng = np.random.RandomState(sum(shape) + 2)
    dy, w3p = rng.randn(m, g), rng.randn(9 * cb, g)
    got = _mirror_dx(dy, w3p, n, r, r)
    assert np.isfinite(got).all()        # no NaN halo row was read
    want = train_ops.conv3x3_dx_plain(
        torch.from_numpy(dy).float(), torch.from_numpy(w3p).float(), n, r,
        r, torch.ones(m, cb), torch.stack([torch.ones(cb), torch.zeros(cb)]),
        torch.empty(m, cb))
    np.testing.assert_allclose(got, want.double().numpy(), rtol=1e-5,
                               atol=1e-4)


def test_index_map_mirror_fails_with_taps_not_flipped():
    """The mirror can fail: the taps read against their own weight slice
    (not 8 - t) compute the forward conv of dy, not its transpose."""
    n, r, cb, g = 2, 6, 16, 8
    m = n * r * r
    rng = np.random.RandomState(9)
    dy, w3p = rng.randn(m, g), rng.randn(9 * cb, g)
    good = _mirror_dx(dy, w3p, n, r, r)
    bad = _mirror_dx(dy, w3p, n, r, r, flip=False)
    assert np.abs(bad - good).max() > 0.1 * np.abs(good).max()


# ---------------------------------------------------------------------------
# bwd_reduce's plan (#7)
# ---------------------------------------------------------------------------

# (M, Ctot, Cout): the up-block adapter of CU-Net-8 @256 at batch 24 at
# every resolution, the bottleneck widths, and the card tests' tails
REDUCE_SHAPES = ([(24 * r * r, 320, 128) for r in (64, 32, 16, 8, 4)]
                 + [(24 * 64 * 64, c, 128) for c in (128, 160, 192, 256)]
                 + [(216, 8, 8), (1000, 56, 16), (2056, 56, 136),
                    (216, 160, 16), (6144, 128, 8), (1536, 264, 16),
                    (300, 40, 256)])


@pytest.mark.parametrize("shape", REDUCE_SHAPES,
                         ids=lambda s: "m{}-c{}-o{}".format(*s))
def test_reduce_plan_counts_every_row_and_column_once(shape):
    m, ctot, cout = shape
    p = train_bottleneck.reduce_plan(m, ctot, cout)
    R, C = train_bottleneck.REDUCE_ROWS, train_bottleneck.REDUCE_COLS
    # chunks of whole steps partition the rows; column blocks cover Ctot
    assert p.chunk % R == 0
    assert [i for s in range(p.chunks) for i in p.rows(s, m)] == \
        list(range(m))
    assert (p.col_blocks - 1) * C < ctot <= p.col_blocks * C
    assert p.chunks * p.col_blocks <= max(train_bottleneck.REDUCE_BLOCKS,
                                          p.col_blocks)
    # outputs padded to whole k16 steps and to the dW warps' n8 tiles
    assert p.np == -(-cout // 16) * 16 and p.np <= 256
    # shared memory: W's three planes, the BN constants, the stages, r's
    # three planes, the gated x_hat
    gs, xs = (p.np + 8) * 2, (C + 8) * 2
    assert p.stat_off == 3 * C * gs
    assert p.stage_off >= p.stat_off + 4 * C * 4
    assert p.g_off >= R * xs and p.stage_bytes >= p.g_off + R * gs
    assert p.pl_off >= p.stage_off + p.stages * p.stage_bytes
    assert p.xh_off >= p.pl_off + 3 * R * xs
    assert p.smem == p.xh_off + R * (C + 8) * 4 <= buf_ops.SMEM_LIMIT
    assert all(v % 16 == 0 for v in (p.stat_off, p.stage_off, p.g_off,
                                     p.stage_bytes, p.pl_off, p.xh_off))


def test_reduce_plan_at_the_main_path():
    """K = 320 -> 128 at batch 24, r = 64: 52 chunks of 1920 rows x 5
    column blocks, 260 blocks, one wave of two blocks on each of the
    H100's 132 SMs (each block within half the SM's shared memory), two
    stages; past 256 outputs no W plane is resident: each of the two
    stages takes a slice of W's planes beside g's, the grid's z the dW
    slices."""
    p = train_bottleneck.reduce_plan(24 * 64 * 64, 320, 128)
    assert (p.chunk, p.chunks, p.col_blocks, p.stages) == (1920, 52, 5, 2)
    assert 2 * (p.smem + 1024) <= 233_472
    assert p.w_off == 0 and p.stat_off == 3 * 64 * (128 + 8) * 2
    wide = train_bottleneck.reduce_plan(1000, 64, 264)
    assert wide.stages == 2 and wide.stat_off == 0 and wide.w_off > 0
    assert wide.stage_bytes >= wide.w_off + 3 * 64 * (128 + 8) * 2
    assert wide.smem <= buf_ops.SMEM_LIMIT
