"""The float32 cotangent products' host plans and a mirror of the reduce's
dW order (``train_ops.affine_dx_f32_plan``, ``csrc/dx_f32_kernels.cu``;
``train_bottleneck.reduce_plan_f32``, ``csrc/bottleneck_kernels.cu``), on
the CPU.

- Every output is stored once: ``affine_dx``'s persistent blocks (column
  block b % nkb, row tiles b // nkb, + grid // nkb, ...) and the lanes of
  their warps (a mirror of the kernel's epilogue: warp (wm, wn), each lane
  four consecutive columns of one row of each n8 tile); the reduce's row
  chunks and their 64-row steps cover M's rows once in ascending order,
  its dW warps store every (column, output) of a block once and its g W^T
  warps every column's two sums. At every (M, K, N) of the CU-Net-8 @256
  float32 steps (batch 24, ghost-BN tiles 2 and 6, whole-batch BN) at
  order 1 and order 14, the heads included, and at cotangents wider than
  128 (up to 256: ``affine_dx`` in two slices of depth, the reduce in two
  output halves), each plan fits the H100's shared memory and is a
  function of the shapes alone.
- The reduce's dW order: each k16 row group's six plane products (both
  operands split into three bf16 planes) summed from zero in a fragment,
  the fragments joined in ascending row order in each chunk, the chunks'
  partials added in order (``sum_rows``), gives the float64 product within
  2^-24 sqrt(M) relative L2 (the smoke's ``F32_DW_REL``) and the plain
  version within the float32 M-term limit.
"""

import functools

import numpy as np
import pytest
import torch

from cunet_tpu_torch.kernels import train_bottleneck as tbk
from cunet_tpu_torch.kernels import train_ops
from cunet_tpu_torch.kernels.buf_ops import SMEM_LIMIT, SMEM_PAIR
from cunet_tpu_torch.kernels.train_slot import slot_plan

from test_torch_port_bf16_split import SUM_REL_PER_SQRT_N, split_bf16x3
from test_torch_port_f32_forms import ORDER

BATCH = 24
F32_DW_REL = 2.0 ** -24


@functools.lru_cache(maxsize=None)
def _step_shapes(order):
    """(M, K, N) of every 1x1 product of the CU-Net-8 @256 float32 step at
    ``order`` (c=128, g=32: the bottleneck inputs k1, the adapters' k2, the
    intermedia adapter c * (1 + order)), the 16-class head and the 68-class
    face head, at r = 64 ... 4."""
    out = set()
    for L in range(order + 1):
        for p in slot_plan(4, 64, 128, 32, L):
            m = BATCH * p["res"] ** 2
            out |= {(m, p["k1"], 128), (m, p["k2"], 128),
                    (m, 128 * (1 + order), 128), (m, 128, 16), (m, 128, 68)}
    return tuple(sorted(out))


# cotangents past 128 (a model whose neck_size * growth_rate or
# init_chan_num is above 128): two slices of depth / two output halves,
# the second 8, 64 and 128 wide; past 256 (W's planes staged a slice at a
# time) three, four and nine, the last 8, 64, 128 and 16 wide
WIDE_SHAPES = [(m, k, n) for m in (BATCH * 64 * 64, BATCH * 16, 1000)
               for k, n in ((192, 136), (320, 192), (1920, 256), (192, 264),
                            (320, 320), (320, 512), (320, 1040))]
DX_SHAPES = sorted(set(_step_shapes(1)) | set(_step_shapes(14))
                   | set(WIDE_SHAPES))
# #7's calls: every product but the heads (the whole-batch BN step's
# bottlenecks and adapters, N = 128), and the wide cotangents
REDUCE_SHAPES = [s for s in DX_SHAPES if s[2] >= 128]


def _grids(groups, items):
    """Persistent grids the kernel may launch with: one or two blocks an
    SM of the card's 132 (cut to a multiple of the column blocks), every
    item its own block, one block a column block."""
    out = {groups, max(groups, items - items % groups)}
    for g in (132, 264):
        g = min(g, items)
        out.add(max(groups, g - g % groups))
    return sorted(out)


def _dx_tile_cover():
    """Hits of a (64 rows, 64 columns) tile by the 8 warps' epilogue
    stores: warp (wm, wn) = (w & 3, w >> 2), lane (g, q): row wm*16 + g
    (+8 on an odd q), columns wn*32 + 2*(q & 2) + 8j .. +4 for the four n8
    tiles j."""
    hits = np.zeros((64, 64), int)
    for w in range(8):
        wm, wn = w & 3, w >> 2
        for lane in range(32):
            g, q = lane >> 2, lane & 3
            row = wm * 16 + g + (8 if q & 1 else 0)
            for j in range(4):
                c = wn * 32 + 2 * (q & 2) + 8 * j
                hits[row, c:c + 4] += 1
    return hits


@pytest.mark.parametrize("m,k,n", DX_SHAPES)
def test_affine_dx_plan_covers_every_output_once(m, k, n):
    p = train_ops.affine_dx_f32_plan(k, n)
    R, C = train_ops.AFFINE_DX_F32_ROWS, train_ops.AFFINE_DX_F32_COLS
    assert (p.nkb - 1) * C < k <= p.nkb * C
    assert p.np_ == -(-n // 16) * 16
    # the slices of depth cover np_ once, each but the last sw deep
    assert p.sw == min(p.np_, train_ops.AFFINE_DX_F32_SLICE)
    depths = [range(s * p.sw, min(p.np_, (s + 1) * p.sw))
              for s in range(p.slices)]
    assert [d for r in depths for d in r] == list(range(p.np_))
    assert all(len(r) % 16 == 0 and len(r) > 0 for r in depths)
    assert (_dx_tile_cover() == 1).all()
    tiles = p.tiles(m)
    for grid in _grids(p.nkb, p.items(m)):
        hits = np.zeros((tiles, p.nkb), int)
        stride = grid // p.nkb
        for b in range(grid):
            hits[b // p.nkb::stride, b % p.nkb] += 1
        assert (hits == 1).all()
    # the layout: W's planes (all np_ depths; none past WIDE_N, each
    # buffer then the slice's at sw_off), then two buffers (a slice's dy
    # rows at sw + 8 floats, x rows at C + 4), within the H100's shared
    # memory; two blocks an SM where N < 128 (the heads)
    wide = p.np_ > train_ops.AFFINE_DX_F32_WIDE_N
    assert p.w_plane == (0 if wide else C * p.np_ * 2)
    assert p.stage_off >= 3 * p.w_plane and p.stage_off % 128 == 0
    assert p.x_off == R * (p.sw + 8) * 4
    assert p.sw_off == (p.x_off + R * (C + 4) * 4 if wide else 0)
    assert p.stage_bytes >= p.x_off + R * (C + 4) * 4 + (
        3 * C * p.sw * 2 if wide else 0)
    assert p.stage_bytes % 128 == 0
    assert p.smem == p.stage_off + 2 * p.stage_bytes <= SMEM_LIMIT
    assert (p.smem <= SMEM_PAIR) == (n < 128)
    # the staged dy rows give conflict-free float2 fragment reads: a row
    # stride of 8 or 24 words modulo the 32 banks
    assert (p.sw + 8) % 32 in (8, 24)


def _reduce_block_cover(p):
    """Hits of a column block's (64 columns, np outputs) dW tile by the
    dW warpgroups' stores of its blocks z < halves and of its 64 columns
    by the g W^T warpgroup's sums (per warp; block z = 0 alone): warp w of
    a warpgroup, lane (g, q), wgmma's accumulator layout; dW (warps 4-7):
    columns (w - 4)*16 + g (+8), outputs 128z + 8j + 2q (+1) for the n8
    tiles j < min(np, 128) / 8 with outputs below np; g W^T (warps 0-3),
    lanes 0-3: columns 8(u >> 1) + 2 lane + (u & 1), u < 16."""
    half = tbk.REDUCE_N_F32
    dw = np.zeros((64, p.np), int)
    sums = np.zeros((4, 64), int)
    for z in range(p.halves):
        for w in range(8):
            if w >= 4:
                for lane in range(32):
                    g, q = lane >> 2, lane & 3
                    for j in range(min(p.np, half) // 8):
                        n0 = half * z + 8 * j + 2 * q
                        if n0 >= p.np:
                            continue
                        for c in ((w - 4) * 16 + g, (w - 4) * 16 + g + 8):
                            dw[c, n0:n0 + 2] += 1
            elif z == 0:
                for lane in range(4):
                    for u in range(16):
                        sums[w, 8 * (u >> 1) + 2 * lane + (u & 1)] += 1
    return dw, sums


@pytest.mark.parametrize("m,ctot,n", REDUCE_SHAPES)
def test_reduce_plan_counts_every_row_and_output_once(m, ctot, n):
    p = tbk.reduce_plan_f32(m, ctot, n)
    R, C = tbk.REDUCE_ROWS_F32, tbk.REDUCE_COLS
    steps = [st for s in range(p.chunks) for st in p.steps(s, m)]
    assert [i for st in steps for i in st] == list(range(m))
    assert all(st.start % R == 0 and 0 < len(st) <= R for st in steps)
    assert p.chunk % R == 0 and (p.chunks - 1) * p.chunk < m
    assert (p.col_blocks - 1) * C < ctot <= p.col_blocks * C
    assert p.chunks * p.col_blocks <= max(tbk.REDUCE_BLOCKS_F32,
                                          p.col_blocks)
    assert p.halves == -(-p.np // tbk.REDUCE_N_F32)
    dw, sums = _reduce_block_cover(p)
    assert (dw == 1).all() and (sums == 1).all()
    # the pre-pass's planes: a tile of every half of 128 outputs
    assert tbk.split_planes_shape(m, n) == (
        3, -(-m // R), p.halves * tbk.REDUCE_N_F32 * R)
    # W's planes (past WIDE_N none: each buffer a half's at sw_off), two
    # buffers of x rows and g's planes (the first also the sums'
    # reduction, 2 x 4 x C floats, after the last step) and the BN
    # constants: one block an SM
    wide = p.np > tbk.WIDE_N
    assert p.wpl == (0 if wide else C * p.np * 2)
    assert p.stage_off == -(-3 * p.wpl // 128) * 128
    assert p.g_off == R * (C + 4) * 4
    tile = R * tbk.REDUCE_N_F32 * 2   # a plane tile
    assert p.sw_off == (p.g_off + 3 * tile if wide else 0)
    assert p.stage_bytes == -(-(p.g_off + (6 if wide else 3) * tile)
                              // 128) * 128
    assert p.stage_bytes >= 8 * C * 4
    assert p.stat_off == p.stage_off + 2 * p.stage_bytes
    assert p.smem == p.stat_off + 4 * C * 4 <= SMEM_LIMIT
    assert p.smem > SMEM_PAIR


def test_plans_are_functions_of_the_shapes_alone(monkeypatch):
    def plans():
        train_ops.affine_dx_f32_plan.cache_clear()
        tbk.reduce_plan_f32.cache_clear()
        return ([train_ops.affine_dx_f32_plan(k, n) for _, k, n in DX_SHAPES]
                + [tbk.reduce_plan_f32(*s) for s in REDUCE_SHAPES])

    want = plans()

    def broken(*a, **k):
        raise AssertionError("a plan asked the device")

    for name in ("get_device_properties", "device_count", "current_device",
                 "is_available"):
        monkeypatch.setattr(torch.cuda, name, broken)
    assert plans() == want
    # the main path's shapes: one block an SM (N = 128); two blocks an SM
    # at the head
    p = train_ops.affine_dx_f32_plan(192, 128)
    assert p.nkb == 3 and p.smem > SMEM_PAIR
    assert train_ops.affine_dx_f32_plan(128, 16).smem <= SMEM_PAIR
    p = tbk.reduce_plan_f32(BATCH * 64 * 64, 320, 128)
    assert (p.col_blocks, p.chunks) == (5, 26)


def test_plans_raise_past_the_widest_cotangent():
    """Up to 256 outputs W's planes stay resident; past the widest such
    cotangent the plans no longer raise but stage them a slice at a time
    (none resident), at any width."""
    assert train_ops.affine_dx_f32_plan(192, 256).slices == 2
    assert train_ops.affine_dx_f32_plan(192, 256).w_plane > 0
    assert tbk.reduce_plan_f32(4096, 320, 256).halves == 2
    assert tbk.reduce_plan_f32(4096, 320, 256).wpl > 0
    for n in (272, 1040):
        p = train_ops.affine_dx_f32_plan(192, n)
        assert p.slices == -(-n // 128) and p.w_plane == 0 < p.sw_off
        p = tbk.reduce_plan_f32(4096, 320, n)
        assert p.halves == -(-n // 128) and p.wpl == 0 < p.sw_off


def reduce_dw_mirror(r, g, plan):
    """r^T g as the float32 reduce sums it under ``plan``: per row chunk,
    its k16 row groups in ascending order, each the six plane products of
    ``ORDER`` (g's plane j with r's plane i: the kernel's g3 r1, g2 r2, g2
    r1, g1 r3, g1 r2, g1 r1) summed from zero in a float32 fragment that
    joins the chunk's sum by one float32 add; the chunks' partials added in
    order (``sum_rows``)."""
    m = r.shape[0]
    mp = -(-m // 16) * 16
    rp = split_bf16x3(torch.nn.functional.pad(r, (0, 0, 0, mp - m)))
    gp = split_bf16x3(torch.nn.functional.pad(g, (0, 0, 0, mp - m)))
    out = torch.zeros(r.shape[1], g.shape[1])
    for s in range(plan.chunks):
        rows = plan.rows(s, m)
        k0s = list(range(rows.start, rows.stop, 16))
        # the chunk's fragments at once: (groups, C, N)
        part = torch.zeros(len(k0s), r.shape[1], g.shape[1])
        for i, j in ORDER:
            a = torch.stack([rp[i][k0:k0 + 16] for k0 in k0s]).float()
            b = torch.stack([gp[j][k0:k0 + 16] for k0 in k0s]).float()
            part = part + a.transpose(1, 2) @ b
        acc = torch.zeros_like(out)
        for f in part:
            acc = acc + f
        out = out + acc
    return out


@pytest.mark.parametrize("r", [64, 4])
def test_reduce_dw_order_gives_the_float64_product(r):
    """At phase 9's adapter (Ctot = 128 + 128 + 32 + 32 -> 128, batch 24)
    the mirror of the reduce's dW is within 2^-24 sqrt(M) relative L2 of
    the float64 product of the same r and g, and within the float32 M-term
    limit of the plain version."""
    rng = np.random.default_rng(r)
    m, ctot, n = BATCH * r * r, 320, 128
    y = torch.from_numpy(rng.standard_normal((m, ctot)).astype(np.float32))
    relu = torch.relu(y)
    g = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    plan = tbk.reduce_plan_f32(m, ctot, n)
    got = reduce_dw_mirror(relu, g, plan)
    ref = relu.double().t() @ g.double()
    rel = ((got.double() - ref).norm() / ref.norm()).item()
    assert rel <= F32_DW_REL * m ** 0.5, rel
    plain = relu.t() @ g
    lim = SUM_REL_PER_SQRT_N * m ** 0.5 * plain.abs().max()
    assert (got - plain).abs().max() <= lim
