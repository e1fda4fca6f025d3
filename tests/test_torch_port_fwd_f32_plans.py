"""The float32 forward 1x1's host plan and numpy mirrors of its kernel
(``buf_ops.fwd_f32_plan``, ``csrc/fwd_f32_kernels.cu::fw3_kernel``: the
per-tile and QuanInput forms of ``affine_dot`` at float32 and #7's
``apply[f32]``), on the CPU.

- The plan at every (M, K, N) of the CU-Net-8 @256 float32 steps (batch
  24; ghost-BN tiles 2 and 6 and whole-batch BN share the products'
  shapes) at order 1 and order 14, the 16- and 68-class heads included
  and K up to 1,920: it fits the H100's shared memory, its column blocks
  hold N, and it is a function of the shapes alone.
- Every output is stored once: the persistent blocks (column block b %
  nkb, row tiles b // nkb, + grid // nkb, ...) and the lanes of their
  warps (warpgroup wg the tile's rows wg*64 .., warp wm 16 of them, each
  lane four consecutive columns of one row of each n8 tile); the padded
  columns of a head (68 classes in a block of 128) never.
- The prologue's per-row vector lookup: each lane's walk over its warp's
  rows in the in-place pass gives every row its own ghost tile's [inv;
  shift] at tiles of 32 and 96 rows (r=4, tiles 2 and 6; a 128-row tile
  spans two or three), and the lanes touch every staged element of a
  slice once; the prologue on the fragments runs only where the tile's
  rows lie in one ghost tile, its lanes' column pairs covering a slice.
- The chunk table resolves every 4-column chunk of the concat to its
  group (17 groups, the table past 16 read from device memory alike).
- A numpy mirror of the kernel's order of sums (slices of 64 depths,
  32-deep chunks from zero joined by one float32 add, the six plane
  products a k16 step) equals ``test_torch_port_f32_forms.dot3_mirror``
  bit for bit where every k16 product is one term (one-hot W gives the
  prologue value exactly; ones in three chunks a column fix the chunks'
  order), and lies within float32 rounding of the float64 product.
"""

import numpy as np
import pytest
import torch

from cunet_tpu_torch.kernels import buf_ops
from cunet_tpu_torch.kernels.buf_ops import SMEM_LIMIT, SMEM_PAIR

from test_torch_port_bf16_split import SUM_REL_PER_SQRT_N
from test_torch_port_dx_f32_plans import _grids, _step_shapes
from test_torch_port_f32_forms import ORDER, dot3_mirror

ROWS, SLICE, CHUNK = (buf_ops.FWD_F32_ROWS, buf_ops.FWD_F32_SLICE,
                      buf_ops.FWD_F32_CHUNK)
FWD_SHAPES = sorted(set(_step_shapes(1)) | set(_step_shapes(14))
                    | {(24 * 4096, 1920, 136), (1000, 200, 136)})


def _ncols(p, n):
    """The stored columns of each column block of plan ``p``."""
    return [range(b * p.ncol, min(n, (b + 1) * p.ncol))
            for b in range(p.nkb)]


@pytest.mark.parametrize("m,k,n", FWD_SHAPES)
def test_plan_fits_and_holds_n(m, k, n):
    p = buf_ops.fwd_f32_plan(k, n)
    assert p.nt in buf_ops.FWD_F32_NTS
    assert (p.nkb - 1) * p.ncol < n <= p.nkb * p.ncol
    assert p.kp == -(-k // CHUNK) * CHUNK
    # the slices cover kp once, each a whole number of chunks
    depths = [range(s * SLICE, min(p.kp, (s + 1) * SLICE))
              for s in range(p.slices)]
    assert [d for r in depths for d in r] == list(range(p.kp))
    assert all(len(r) % CHUNK == 0 for r in depths)
    # W's planes (all kp depths, or one slice streamed), the table, two
    # buffers: x rows at 72 floats (and streamed W rows) a slice
    assert p.dp == (SLICE if p.stream else p.kp)
    assert p.w_plane == p.ncol * p.dp * 2
    assert p.tbl_off >= 3 * p.w_plane
    assert p.stage_off >= p.tbl_off + p.kp // 4 * buf_ops.CHUNK_BYTES
    assert p.w_raw_off == ROWS * (SLICE + 8) * 4
    assert p.stage_bytes >= p.w_raw_off + (SLICE * p.ncol * 4 if p.stream
                                           else 0)
    assert all(v % 128 == 0 for v in (p.tbl_off, p.stage_off,
                                      p.stage_bytes))
    assert p.smem == p.stage_off + 2 * p.stage_bytes <= SMEM_LIMIT
    # W resident wherever its planes fit beside the buffers
    if p.stream:
        assert buf_ops._fwd_f32_layout(p.kp, p.nt, p.nkb,
                                       False).smem > SMEM_LIMIT
    # the staged rows give conflict-free float2 fragment reads: a row
    # stride of 8 or 24 words modulo the 32 banks
    assert (SLICE + 8) % 32 in (8, 24)
    assert p.items(m) == -(-m // ROWS) * p.nkb


def test_main_path_plans():
    """K=192 -> 128 (the adapters): one block keeps every column, W
    resident (x read and split once); #7's K=320: two blocks of 64; the
    intermedia adapter at order 14 and #7's 17 groups stream W; the heads
    (16 and 68 classes, 68 run as 72) one block, the 16-class head two
    blocks an SM."""
    p = buf_ops.fwd_f32_plan(192, 128)
    assert (p.nkb, p.nt, p.stream) == (1, 16, False)
    assert (buf_ops.fwd_f32_plan(320, 128).nkb,
            buf_ops.fwd_f32_plan(320, 128).stream) == (2, False)
    assert buf_ops.fwd_f32_plan(1920, 128).stream
    assert buf_ops.fwd_f32_plan(384, 128).stream is False
    assert buf_ops.fwd_f32_plan(416, 128).stream
    assert buf_ops.fwd_f32_plan(128, 16).nt == 2
    assert buf_ops.fwd_f32_plan(128, 16).smem <= SMEM_PAIR
    for n in (68, 72):
        assert (buf_ops.fwd_f32_plan(128, n).nkb,
                buf_ops.fwd_f32_plan(128, n).nt) == (1, 16)
    assert buf_ops.fwd_f32_plan(1920, 136).nkb == 2
    for k, n in ((190, 128), (192, 66), (0, 16)):
        with pytest.raises(ValueError, match="multiples of 4"):
            buf_ops.fwd_f32_plan(k, n)


def test_plans_are_functions_of_the_shapes_alone(monkeypatch):
    def plans():
        buf_ops.fwd_f32_plan.cache_clear()
        return [buf_ops.fwd_f32_plan(k, n) for _, k, n in FWD_SHAPES]

    want = plans()

    def broken(*a, **k):
        raise AssertionError("a plan asked the device")

    for name in ("get_device_properties", "device_count", "current_device",
                 "is_available"):
        monkeypatch.setattr(torch.cuda, name, broken)
    assert plans() == want


def _tile_cover(nt):
    """Hits of a (128 rows, 8 nt columns) tile by the 8 warps' epilogue
    stores: warp w in warpgroup wg = w >> 2, wm = w & 3, lane (g, q): row
    wg*64 + wm*16 + g (+8 on an odd q), columns 8j + 2*(q & 2) .. +4 for
    the n8 tiles j < nt."""
    hits = np.zeros((ROWS, 8 * nt), int)
    for w in range(8):
        r0 = (w >> 2) * 64 + (w & 3) * 16
        for lane in range(32):
            g, q = lane >> 2, lane & 3
            row = r0 + g + (8 if q & 1 else 0)
            for j in range(nt):
                c = 8 * j + 2 * (q & 2)
                hits[row, c:c + 4] += 1
    return hits


@pytest.mark.parametrize("m,k,n", FWD_SHAPES)
def test_stores_cover_every_output_once(m, k, n):
    p = buf_ops.fwd_f32_plan(k, n)
    assert (_tile_cover(p.nt) == 1).all()
    # a block's columns: those below N stored (the kernel's n < N), the
    # padded ones never; the blocks' column ranges cover N once
    cols = _ncols(p, n)
    assert [c for r in cols for c in r] == list(range(n))
    tiles = p.tiles(m)
    for grid in _grids(p.nkb, p.items(m)):
        hits = np.zeros((tiles, p.nkb), int)
        stride = grid // p.nkb
        for b in range(grid):
            hits[b // p.nkb::stride, b % p.nkb] += 1
        assert (hits == 1).all()


def _prologue_walk(m, k, tile_rows, m0, k0, width):
    """A mirror of each lane's prologue pass over one item (the tile at row
    m0, the slice at depth k0): warp w's rows R0 = (w >> 2)*64 + (w & 3)*16,
    lane l's columns k0 + 4 (l % 16) .. +4 (those below the slice's width
    and K), its rows R0 + l // 16 + 2i while below M, its [inv; shift]
    reloaded where the row leaves the tile rows [lo, hi) it holds.
    Returns (hits of the staged slice, the tile each row's vectors came
    from)."""
    hits = np.zeros((ROWS, SLICE), int)
    tile_of = np.full(ROWS, -1)
    for w in range(8):
        r0 = (w >> 2) * 64 + (w & 3) * 16
        for lane in range(32):
            v = lane & 15
            if not (4 * v < width and k0 + 4 * v < k):
                continue
            lo = hi = 0
            t_held = None
            for i in range(8):
                r = r0 + (lane >> 4) + 2 * i
                row = m0 + r
                if row >= m:
                    break
                if row < lo or row >= hi:
                    t_held = row // tile_rows
                    lo, hi = t_held * tile_rows, t_held * tile_rows + \
                        tile_rows
                hits[r, 4 * v:4 * v + 4] += 1
                assert tile_of[r] in (-1, t_held)
                tile_of[r] = t_held
    return hits, tile_of


@pytest.mark.parametrize("m,tile_rows", [
    (24 * 16, 32), (24 * 16, 96),              # r=4, tiles 2 and 6
    (24 * 64, 128), (24 * 64, 384),            # r=8
    (24 * 4096, 8192), (24 * 16, 16),          # r=64 tile 2; r=4 tile 1
    (1000, 40), (1200, 400), (300, 300)])      # ragged tiles and rows
@pytest.mark.parametrize("k", [192, 72])
def test_prologue_gives_each_row_its_own_tile(m, tile_rows, k):
    p = buf_ops.fwd_f32_plan(k, 128)
    starts = range(0, m, ROWS) if m <= 2000 else \
        [0, ROWS * 31, m - m % ROWS or m - ROWS]
    for m0 in starts:
        for s in range(p.slices):
            k0 = s * SLICE
            width = min(SLICE, p.kp - k0)
            hits, tile_of = _prologue_walk(m, k, tile_rows, m0, k0, width)
            rows = min(ROWS, m - m0)
            cols = min(width, k - k0)
            assert (hits[:rows, :cols] == 1).all()
            assert (hits[rows:] == 0).all() and (hits[:, cols:] == 0).all()
            want = (m0 + np.arange(rows)) // tile_rows
            assert (tile_of[:rows] == want).all()


def _one_tile(m0, m, tile_rows, vstride=1):
    """The kernel's test for the prologue on the fragments: the tile's rows
    m0 .. min(m0 + 128, M) - 1 lie in one ghost tile (always, with one
    [inv; shift] pair)."""
    return not vstride or m0 // tile_rows == (min(m0 + ROWS, m) - 1) \
        // tile_rows


@pytest.mark.parametrize("m,tile_rows", [
    (24 * 16, 32), (24 * 16, 96), (24 * 64, 128), (24 * 64, 384),
    (24 * 4096, 8192), (24 * 1024, 2048), (1000, 40), (300, 300)])
def test_fragment_prologue_where_one_ghost_tile(m, tile_rows):
    """Where the kernel applies the prologue on the fragments, every row of
    the tile reads the same ghost tile's [inv; shift] (each row its own,
    as the in-place pass gives it), and the lanes' pairs of fragment
    columns 16 j + 8 h + 2 q (+ 1) cover a slice's 64 columns once; a
    padded column's zero inv and shift of -1 give a zero prologue."""
    for m0 in range(0, m, ROWS):
        tiles = {r // tile_rows for r in range(m0, min(m0 + ROWS, m))}
        assert _one_tile(m0, m, tile_rows) == (len(tiles) == 1)
        assert _one_tile(m0, m, tile_rows, vstride=0)
    # the main path: r >= 16 at ghost tiles of 2 and 6 images (and #7's one
    # pair) take the fragment form; r = 4 and 8 at tile 6 do not
    if tile_rows % ROWS == 0:
        assert all(_one_tile(m0, m, tile_rows) for m0 in range(0, m, ROWS))
    cols = np.zeros(SLICE, int)
    for q in range(4):
        for j in range(SLICE // 16):
            for h in range(2):
                c = 16 * j + 8 * h + 2 * q
                cols[c:c + 2] += 1
    assert (cols == 1).all()
    z = prologue_np(np.zeros((1, 4), np.float32),
                    np.stack([np.zeros((1, 4)), -np.ones((1, 4))], 1)
                    .astype(np.float32), 1)
    assert not z.any()


def _chunk_table(widths):
    """A mirror of the block's chunk table: concat column 4c resolved as
    common.cuh find_group resolves it (the last group whose offset is <=
    the column): (group, column within it); none at or past Ctot."""
    offs = np.cumsum((0,) + tuple(widths))
    ctot = offs[-1]
    kp = -(-ctot // CHUNK) * CHUNK
    out = []
    for c in range(kp // 4):
        col = 4 * c
        if col >= ctot:
            out.append(None)
            continue
        g = 0
        while g + 1 < len(widths) and col >= offs[g + 1]:
            g += 1
        out.append((g, col - offs[g]))
    return out


@pytest.mark.parametrize("widths", [(192,), (128, 128, 32, 32), (40, 16),
                                    (128,) * 13 + (64,) * 4, (8,) * 20,
                                    (16, 24, 8, 8)])
def test_chunk_table_resolves_the_concat(widths):
    rng = np.random.RandomState(len(widths))
    feats = [rng.randn(5, c).astype(np.float32) for c in widths]
    table = _chunk_table(widths)
    staged = np.zeros((5, 4 * len(table)), np.float32)
    for c, ref in enumerate(table):
        if ref is not None:
            g, col = ref
            staged[:, 4 * c:4 * c + 4] = feats[g][:, col:col + 4]
    ctot = sum(widths)
    assert np.array_equal(staged[:, :ctot], np.concatenate(feats, 1))
    assert not staged[:, ctot:].any()


# ---------------------------------------------------------------------------
# numpy mirror of the kernel's order of sums
# ---------------------------------------------------------------------------


def bf16_rn(a):
    """float32 values rounded to bf16 (round to nearest even), as float32."""
    b = np.ascontiguousarray(a, np.float32).view(np.uint32)
    r = (b + np.uint32(0x7FFF) + ((b >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return r.view(np.float32)


def split3_np(a):
    """common.cuh split3: a = p1 + p2 + p3, each exactly a bf16."""
    p1 = bf16_rn(a)
    r1 = (a - p1).astype(np.float32)
    p2 = bf16_rn(r1)
    return p1, p2, bf16_rn((r1 - p2).astype(np.float32))


def prologue_np(x, vec, tile_rows, bits=0):
    """relu(x * inv_t + shift_t) in float32 (each op rounded, no FMA) with
    row m's tile t = m // tile_rows (``vec`` (T, 2, K)), then QuanInput's
    quantizer (the plain version's)."""
    t = np.arange(x.shape[0]) // tile_rows
    z = np.maximum((x * vec[t, 0]).astype(np.float32) + vec[t, 1], 0)
    z = z.astype(np.float32)
    if bits:
        z = buf_ops.quantize_act(torch.from_numpy(z), bits).numpy()
    return z


def fwd_mirror(z, w, plan, one=False):
    """z (M, K) @ w (K, N) as ``fw3_kernel`` sums it under ``plan``: K
    zero-padded to kp, walked in slices of 64 depths, each slice's 32-deep
    chunks summed from zero in a float32 fragment (per k16 step the six
    plane products of ``ORDER``, or with ``one`` x's first plane times W's
    three) that joins the output's float32 sum by one add."""
    m, k = z.shape
    zp = np.zeros((m, plan.kp), np.float32)
    zp[:, :k] = z
    wp = np.zeros((plan.kp, w.shape[1]), np.float32)
    wp[:k] = w
    xs, ws = split3_np(zp), split3_np(wp)
    order = [(0, 2), (0, 1), (0, 0)] if one else ORDER
    acc = np.zeros((m, w.shape[1]), np.float32)
    for s in range(plan.slices):
        k0 = s * SLICE
        for c0 in range(0, min(SLICE, plan.kp - k0), CHUNK):
            part = np.zeros_like(acc)
            for kk in (k0 + c0, k0 + c0 + 16):
                for i, j in order:
                    part = (part + xs[i][:, kk:kk + 16] @
                            ws[j][kk:kk + 16]).astype(np.float32)
            acc = (acc + part).astype(np.float32)
    return acc


def _operands(m, k, n, tiles, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    vec = np.stack([rng.uniform(0.5, 1.5, (tiles, k)),
                    rng.randn(tiles, k) * 0.5], 1).astype(np.float32)
    return x, vec, m // tiles


def _hot(k, n, rows_per_col, seed):
    """W with ``rows_per_col`` ones a column, each in its own 32-deep chunk
    (distinct chunks ascending: every k16 product one term)."""
    rng = np.random.RandomState(seed)
    w = np.zeros((k, n), np.float32)
    chunks = -(-k // CHUNK)
    for j in range(n):
        for c in sorted(rng.choice(chunks, rows_per_col, replace=False)):
            w[min(k - 1, c * CHUNK + rng.randint(CHUNK)), j] = 1.0
    return w


@pytest.mark.parametrize("m,k,n,tiles", [(300, 192, 128, 3), (256, 136, 72, 1),
                                         (384, 200, 16, 4), (96, 40, 136, 3)])
def test_mirror_is_dot3_bit_for_bit_where_each_product_is_one_term(
        m, k, n, tiles):
    x, vec, tile_rows = _operands(m, k, n, tiles, k + n)
    z = prologue_np(x, vec, tile_rows)
    plan = buf_ops.fwd_f32_plan(k, -(-n // 4) * 4)
    # one-hot W: the prologue value itself, exactly
    hot = _hot(k, n, 1, 1)
    got = fwd_mirror(z, hot, plan)
    assert np.array_equal(got, z @ hot)
    assert np.array_equal(got, dot3_mirror(torch.from_numpy(z),
                                           torch.from_numpy(hot)).numpy())
    # ones in three chunks a column: ((0 + a) + b) + c, the chunks in
    # ascending order, as dot3_kernel adds them
    if k > 2 * CHUNK:
        three = _hot(k, n, 3, 2)
        got = fwd_mirror(z, three, plan)
        want = dot3_mirror(torch.from_numpy(z), torch.from_numpy(three))
        assert np.array_equal(got, want.numpy())
        rows = [np.nonzero(three[:, j])[0] for j in range(n)]
        backwards = np.stack([(z[:, r[2]] + z[:, r[1]]) + z[:, r[0]]
                              for r in rows], 1)
        assert not np.array_equal(got, backwards)


@pytest.mark.parametrize("k", [192, 320])
def test_mirror_is_the_float64_product_to_float32_rounding(k):
    x, vec, tile_rows = _operands(256, k, 128, 2, k)
    z = prologue_np(x, vec, tile_rows)
    w = (np.random.RandomState(k + 1).randn(k, 128) * k ** -0.5).astype(
        np.float32)
    got = fwd_mirror(z, w, buf_ops.fwd_f32_plan(k, 128))
    want = z.astype(np.float64) @ w.astype(np.float64)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= SUM_REL_PER_SQRT_N * k ** 0.5
    # the three-plane split is what keeps it there: one bf16 pass misses
    one = bf16_rn(z).astype(np.float64) @ bf16_rn(w).astype(np.float64)
    assert np.abs(one - want).max() / np.abs(want).max() > 10 * rel


@pytest.mark.parametrize("bits", [8, 12])
def test_quantized_prologue_and_one_plane(bits):
    """QuanInput codes: the plain quantizer's after the float32 prologue;
    at bits <= 9 they fill x's first plane, so the three products of its
    planes 2 and 3 are zeros and skipping them keeps the sums; at 12 they
    do not."""
    x, vec, tile_rows = _operands(192, 128, 16, 2, bits)
    z = prologue_np(x, vec, tile_rows, bits)
    t = torch.from_numpy(x)
    v = torch.from_numpy(vec)
    want = buf_ops.quantize_act(torch.relu(buf_ops.tile_affine(t, v)), bits)
    assert np.array_equal(z, want.numpy())
    p2, p3 = split3_np(z)[1:]
    w = (np.random.RandomState(bits).randn(128, 16) * 0.1).astype(np.float32)
    plan = buf_ops.fwd_f32_plan(128, 16)
    if bits <= 9:
        assert not p2.any() and not p3.any()
        assert np.array_equal(fwd_mirror(z, w, plan, one=True),
                              fwd_mirror(z, w, plan))
    else:
        assert p2.any()
