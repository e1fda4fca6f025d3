"""The float32 weight gradients' host plan and a mirror of their 3x3
staging (``train_ops.dw_f32_plan``, ``csrc/dw_f32_kernels.cu``), on the CPU.

- Every (output row, depth row) product is summed exactly once: the runs
  and their steps cover M's rows once, in ascending order, in steps of
  ``br`` rows; the warps of each block (a mirror of the kernel's layout:
  3x3, warp (ky, ct) the three taps of kernel row ky for channel tile ct;
  1x1, warp (wc, wn) the channel tiles wc, wc + 3, wc + 6 and the n8 tiles
  of column group wn) store every output element once. A block of 12
  warps fits an SM's shared memory, one of 6 (the 1x1 form at N <= 32)
  half of it. The plan is a function of the shapes alone.
- The 3x3 form's staging: a mirror of the ring of z rows (which rows a
  run's chunks stage and zero, which ring slot a chunk lands in, which
  ring row or zero row each tap of each step reads) gives ``im2col`` of
  the plain z, padding included, at r = 4, 8 and 64 with ghost-BN tiles
  2 and 6 (CU-Net-8 @256's batch 24). A never-written ring row reads NaN,
  so a tap that read a stale or unstaged row would show.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cunet_tpu_torch.kernels import train_ops
from cunet_tpu_torch.kernels.buf_ops import SMEM_LIMIT, SMEM_PAIR

BATCH = 24

# (m, c, n, w): CU-Net-8 @256's 3x3 convs (Cb=128 -> 32) at r = 64 ... 4,
# its 1x1 stages at order 1 (K = 128 ... 320 -> 128, the head 128 -> 16)
# and order 14's intermedia adapter (K = 1,920), and odd shapes: a small
# config's widths, N past one column group, K not a multiple of 16
PLAN_SHAPES = (
    [(BATCH * r * r, 128, 32, r) for r in (64, 32, 16, 8, 4)]
    + [(BATCH * 64 * 64, k, 128, 0) for k in (128, 160, 192, 256, 288, 320,
                                             1920)]
    + [(BATCH * 64 * 64, 128, 16, 0), (BATCH * 4 * 4, 192, 128, 0),
       (2 * 8 * 8, 8, 8, 8), (4 * 6 * 6, 24, 40, 6), (3 * 16 * 16, 40, 72, 16),
       (1000, 200, 136, 0), (4 * 2 * 2, 16, 16, 2)])


def _warp_outputs(plan, c, n, cb, gz):
    """The (output row, column) elements each warp of block (., cb, gz)
    stores, as the kernel's store loop computes them."""
    c0, n0 = cb * plan.kc, gz * plan.ncol
    ktiles = plan.kc // 16
    rows = plan.warps // 3
    for warp in range(plan.warps):
        if plan.conv:
            ky, ct = warp // rows, warp % rows
            ntile0 = 0
            srcs = [(ky * 3 + t, ct) for t in range(3)] if ct < ktiles else []
        else:
            wc, wn = warp % 3, warp // 3
            ntile0 = wn * plan.nt
            srcs = [(None, wc + 3 * t) for t in range(3)
                    if wc + 3 * t < ktiles]
        if not srcs or n0 + ntile0 * 8 >= n:
            continue
        for tap, tile in srcs:
            for ch in range(c0 + tile * 16, c0 + tile * 16 + 16):
                if ch >= c:
                    continue
                row = ch if tap is None else tap * c + ch
                for j in range(plan.nt):
                    for col in range(n0 + (ntile0 + j) * 8,
                                     n0 + (ntile0 + j) * 8 + 8):
                        if col < n:
                            yield row, col


@pytest.mark.parametrize("m,c,n,w", PLAN_SHAPES)
def test_every_product_summed_once_in_ascending_depth(m, c, n, w):
    plan = train_ops.dw_f32_plan(m, c, n, w)
    assert plan.conv == (w > 0)
    # depth: the runs' steps cover the rows once, ascending, br at a time
    steps = [s for p in range(plan.runs) for s in plan.steps(p, m)]
    assert [i for s in steps for i in s] == list(range(m))
    assert all(s.start % plan.br == 0 and 0 < len(s) <= plan.br
               for s in steps)
    assert plan.run_rows % plan.br == 0
    # outputs: every element once over the blocks' warps
    r = 9 * c if plan.conv else c
    count = np.zeros((r, n), np.int64)
    for cb in range(plan.nkb):
        for gz in range(plan.ngrp):
            for row, col in _warp_outputs(plan, c, n, cb, gz):
                count[row, col] += 1
    assert (count == 1).all()
    # the kernel's limits on its layout
    rows = plan.warps // 3
    assert plan.kc % 16 == 0 and plan.kc <= (16 * rows if plan.conv else 144)
    assert plan.ncol == (8 if plan.conv else 8 * rows) * plan.nt
    assert plan.nt in (1, 2, 4) and plan.stages in (2, 3)
    assert plan.smem == train_ops.dw_f32_smem(plan.br, plan.halo, plan.kc,
                                              plan.ncol, plan.stages)
    # a block of 12 warps takes an SM, one of 6 (the heads, N <= 32) half
    assert plan.warps == (6 if not plan.conv and n <= 32 else 12)
    assert plan.smem <= (SMEM_LIMIT if plan.warps == 12 else SMEM_PAIR)


def test_plan_depends_on_the_shapes_alone():
    first = [train_ops.dw_f32_plan(*s) for s in PLAN_SHAPES]
    train_ops.dw_f32_plan.cache_clear()
    torch.manual_seed(1)
    again = [train_ops.dw_f32_plan(*s) for s in PLAN_SHAPES]
    assert first == again
    # the main path's shapes: one wave (12 warps a block: one an SM; 6:
    # two)
    for s in PLAN_SHAPES[:13]:
        p = train_ops.dw_f32_plan(*s)
        assert p.blocks <= train_ops.DW_F32_BLOCKS * 12 // p.warps


def staging_mirror(z, plan, h, w):
    """The (M, 9C) operand the 3x3 kernel's taps read under ``plan``: per
    run, iteration it stages chunk it - halo (rows in [lo, hi), the rows a
    valid tap of the run reads; zero elsewhere) into ring slot
    it % slots, and step s = it - 1 - 2 halo reads, for each tap, ring row
    (m - g0 + offset) mod cap (g0 = r_begin - halo * br), or the zero row
    where the tap leaves m's image or m its run."""
    m, c = z.shape
    br, halo = plan.br, plan.halo
    slots = 2 * halo + 2
    cap = slots * br
    out = torch.full((m, 9 * c), float("nan"))
    ar = torch.arange(br)
    for p in range(plan.runs):
        rows = plan.run(p, m)
        r_begin, r_end = rows.start, rows.stop
        nsteps = -(-(r_end - r_begin) // br)
        g0 = r_begin - halo * br
        lo, hi = max(0, r_begin - w - 1), min(m, r_end + w + 1)
        ring = torch.full((cap + 1, c), float("nan"))
        ring[cap] = 0.0
        iters = nsteps + 2 * halo
        for it in range(iters + 1):
            if it < iters:
                g = r_begin + (it - halo) * br + ar
                ok = (g >= lo) & (g < hi)
                chunk = torch.zeros(br, c)
                chunk[ok] = z[g[ok]]
                ring[(it % slots) * br:(it % slots + 1) * br] = chunk
            s = it - 1 - 2 * halo
            if s < 0:
                continue
            mm = r_begin + s * br + ar
            q = ((s + halo) % slots) * br + ar     # = (mm - g0) mod cap
            assert torch.equal(q, (mm - g0) % cap)
            pix = mm % (h * w)
            yy, xx = pix // w, pix % w
            keep = mm < r_end
            for ky in range(3):
                for dx in range(3):
                    rr = q + (ky - 1) * w + dx - 1
                    rr = torch.where(rr < 0, rr + cap,
                                     torch.where(rr >= cap, rr - cap, rr))
                    ok = keep & (yy + ky - 1 >= 0) & (yy + ky - 1 < h) \
                        & (xx + dx - 1 >= 0) & (xx + dx - 1 < w)
                    src = torch.where(ok, rr, torch.full_like(rr, cap))
                    tap = ky * 3 + dx
                    out[mm[keep], tap * c:(tap + 1) * c] = ring[src[keep]]
    return out


def im2col(y, b, h, w):
    c = y.shape[1]
    p = F.pad(y.reshape(b, h, w, c), (0, 0, 1, 1, 1, 1))
    cols = [p[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]
    return torch.cat(cols, dim=-1).reshape(b * h * w, 9 * c)


@pytest.mark.parametrize("r", [4, 8, 64])
@pytest.mark.parametrize("tile", [2, 6])
def test_conv_staging_is_im2col_of_the_plain_z(r, tile):
    """At CU-Net-8 @256's shapes (Cb=128 -> 32, batch 24): z is the plain
    prologue relu(x * inv_t + shift_t) with each ghost tile's own vectors
    (all 128 channels at r = 4 and 8; the staging does not depend on the
    channel, so 8 of them at r=64)."""
    gen = torch.Generator().manual_seed(r * 10 + tile)
    m = BATCH * r * r
    plan = train_ops.dw_f32_plan(m, 128, 32, r)
    c = 128 if r < 64 else 8
    tiles = BATCH // tile
    x = torch.randn(m, c, generator=gen)
    inv = torch.rand(tiles, c, generator=gen) + 0.5
    shift = torch.randn(tiles, c, generator=gen) * 0.5
    t = torch.arange(m) // (m // tiles)
    z = torch.relu(x * inv[t] + shift[t])
    got = staging_mirror(z, plan, r, r)
    assert not torch.isnan(got).any()
    assert torch.equal(got, im2col(z, BATCH, r, r))
