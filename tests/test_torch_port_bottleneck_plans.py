"""The host-side plans of TPU kernel #7's two GEMM kernels on the H100, on
the CPU: ``train_bottleneck.dx_plan`` (``bwd_dx``, the input cotangents:
g W^T on the tensor cores through the exact three-way bf16 split of the
float32 W, the BN recompute, gate and jacobian in its epilogue) and
``buf_ops.affine_dot_plan`` as ``apply`` (``affine_dot``'s kernel in its
feature-table form) launches it.

Over ``test_torch_port_conv_plans.REDUCE_SHAPES`` (the up-block adapter
K = 320 -> 128 at batch 24, r = 64 ... 4, the other stage widths at r=64,
and the card tests' tails) these tests hold ``dx_plan``'s invariants: every
(row, column) computed once whatever the persistent grid, shared memory
within the H100's 227 KB and within half an SM at the main path's N = 128
(two blocks an SM), ldmatrix rows free of bank conflicts, and a plan that
is a function of the shapes alone. A torch mirror of the kernel's walk
(the column groups, the chunks resolved from the feature table once per
block, 64-row steps, g W^T from the three W planes with kk outer and the
planes inner, the epilogue) then gives ``bwd_dx_plain``'s bits under
one-hot cotangents, and differs from them with a plane dropped or a chunk
resolved one group off. Last, ``apply``'s launch (the plan's shared memory
plus the table chunks) fits at every (M, Ctot, Cout) the CU-Net-8 @256
``bn_tile=0`` step gives it, read from the port's own forward at full
width.
"""

import functools
import itertools

import numpy as np
import pytest
import torch

from cunet_tpu_torch.kernels import buf_ops
from cunet_tpu_torch.kernels import train_bottleneck as tbk
from cunet_tpu_torch.kernels.buf_ops import SMEM_LIMIT, SMEM_PAIR

from test_torch_port_bf16_split import split_bf16x3
from test_torch_port_conv_plans import REDUCE_SHAPES
from test_torch_port_gemm_plans import _grids, _items_once, one_thread

R, C = tbk.DX_ROWS, tbk.DX_COLS
# the shapes the mirror walks in full (M Ctot Cout up to ~63 M)
MIRROR = [s for s in REDUCE_SHAPES if s[0] * s[1] * s[2] <= 63_000_000]


def _id(s):
    return "m{}-c{}-o{}".format(*s)


def _widths(ctot):
    """Feature groups of ragged widths (multiples of 8) summing to
    ``ctot``, some across a 64-column group's edge."""
    out = []
    for w in itertools.cycle((40, 16, 24, 8, 64, 32)):
        if sum(out) >= ctot:
            return out
        out.append(min(w, ctot - sum(out)))


@pytest.mark.parametrize("shape", REDUCE_SHAPES, ids=_id)
def test_dx_plan_covers_every_row_and_column_once(shape):
    m, ctot, n = shape
    p = tbk.dx_plan(m, ctot, n)
    assert (p.ngrp - 1) * C < ctot <= p.ngrp * C
    assert (p.steps(m) - 1) * R < m <= p.steps(m) * R
    assert p.np == -(-n // 16) * 16 <= 256
    # every (step, column group) once for any grid the launch picks (a
    # multiple of the groups: block b keeps group b % ngrp)
    for grid in _grids(p.ngrp, p.items(m)):
        assert (_items_once(p.steps(m), p.ngrp, grid) == 1).all()
    # a step's 64 x 64 tile: warp w owns rows (w & 1) * 32 .. + 32 and
    # columns (w >> 1) * 16 .. + 16; its lanes' m16n8 accumulators (two row
    # tiles, two column tiles) each output once
    hits = np.zeros((R, C), int)
    for w in range(8):
        r0, c0 = (w & 1) * 32, (w >> 1) * 16
        for lane, i, h, j, e in itertools.product(range(32), range(2),
                                                  range(2), range(2),
                                                  range(2)):
            hits[r0 + 16 * i + (lane >> 2) + 8 * h,
                 c0 + 8 * j + 2 * (lane & 3) + e] += 1
    assert (hits == 1).all()
    # the x loads and dx stores: every 16-byte (row, chunk) of the tile by
    # one thread
    vecs = np.zeros((R, C // 8), int)
    for t in range(256):
        for i in range(t, R * C // 8, 256):
            vecs[i // (C // 8), i % (C // 8)] += 1
    assert (vecs == 1).all()


@pytest.mark.parametrize("shape", REDUCE_SHAPES, ids=_id)
def test_dx_plan_shared_memory(shape):
    m, ctot, n = shape
    p = tbk.dx_plan(m, ctot, n)
    gs = (p.np + 8) * 2                       # bytes of a g / W-plane row
    assert p.tbl_off == 3 * C * gs            # the three W planes
    assert p.stage_off >= p.tbl_off + 2 * (C // 8) * tbk.CHUNK_BYTES
    assert p.g_off >= R * (C + 8) * 2         # the x tile, then g
    assert p.stage_bytes >= p.g_off + R * gs
    assert p.smem == p.stage_off + 2 * p.stage_bytes <= SMEM_LIMIT
    assert all(v % 128 == 0 for v in (p.tbl_off, p.stage_off, p.g_off,
                                      p.stage_bytes))
    # ldmatrix reads eight rows of g or of a plane at once: an odd number
    # of 16-byte chunks a row puts them in eight bank groups
    assert gs // 16 % 2 == 1
    if n <= 128:                              # the main path: two an SM
        assert p.smem <= SMEM_PAIR


def test_dx_plan_is_a_function_of_the_shapes(monkeypatch):
    def plans():
        tbk.dx_plan.cache_clear()
        return [tbk.dx_plan(*s) for s in REDUCE_SHAPES]

    want = plans()

    def broken(*a, **k):
        raise AssertionError("a plan asked the device")

    for name in ("get_device_properties", "device_count", "current_device",
                 "is_available"):
        monkeypatch.setattr(torch.cuda, name, broken)
    assert plans() == want


def _one_hot_case(m, widths, n, seed, red_zero):
    """Features > 0 (every row gated: mean and bias 0, scale > 0), the
    first group's view strided in a wider buffer, row m's cotangent one-hot
    at n_m = m % n; red zero or not."""
    gen = torch.Generator().manual_seed(seed)
    ctot = sum(widths)
    xs = [(torch.rand(m, c, generator=gen) * 3 + 0.1).bfloat16()
          for c in widths]
    xs[0] = torch.cat([xs[0], xs[0][:, :8]], 1)[:, :widths[0]]
    stat = torch.stack([torch.zeros(ctot),
                        torch.rand(ctot, generator=gen) + 0.5,
                        torch.rand(ctot, generator=gen) + 0.5])
    bias = torch.zeros(ctot)
    red = torch.zeros(2, ctot) if red_zero else \
        torch.randn(2, ctot, generator=gen) * 0.1
    w = torch.randn(ctot, n, generator=gen)
    g = torch.zeros(m, n, dtype=torch.bfloat16)
    g[torch.arange(m), torch.arange(m) % n] = 1
    return xs, g, stat, bias, red, w


def mirror_bwd_dx(xs, g, stat, bias, red, w, planes=(0, 1, 2), off=0):
    """``bwd_dx`` as the kernel walks it, in torch: block b of the two-an-SM
    grid keeps column group b % ngrp and resolves its 8 chunks from the
    table once (group ``off`` groups past the right one: a fault), then
    walks steps b // ngrp, + grid // ngrp, ...; each step's g W^T from
    ``planes`` of W's split (kk over np / 16 outer, planes inner), the
    epilogue in the kernel's order, dx written through the chunks.
    Returns (dxs, the gated float32 g_y as (M, Ctot))."""
    m, n = g.shape
    widths = [x.shape[1] for x in xs]
    ctot = sum(widths)
    p = tbk.dx_plan(m, ctot, n)
    offs = list(itertools.accumulate([0] + widths))
    pieces = [torch.zeros(p.ngrp * C, p.np, dtype=torch.bfloat16)
              for _ in range(3)]
    for piece, part in zip(pieces, split_bf16x3(w)):
        piece[:ctot, :n] = part
    gp = torch.zeros(p.steps(m) * R, p.np, dtype=torch.bfloat16)
    gp[:m, :n] = g
    cols = torch.zeros(6, p.ngrp * C)     # mu, is, sc, b, red0, red1
    cols[:, :ctot] = torch.cat([stat, bias[None], red])
    dxs = [torch.full((m, c), float("nan"), dtype=torch.bfloat16)
           for c in widths]
    gys = torch.full((m, p.ngrp * C), float("nan"))

    def chunk(k):
        """(group, local column) of the chunk at concat column k."""
        gi = max(i for i in range(len(widths)) if offs[i] <= k)
        gj = (gi + off) % len(widths)
        return gj, min(k - offs[gi], widths[gj] - 8)

    grid = max(p.ngrp, min(264, p.items(m)) - min(264, p.items(m)) % p.ngrp)
    for b in range(grid):
        c0 = (b % p.ngrp) * C
        chunks = [chunk(c0 + 8 * v) if c0 + 8 * v < ctot else None
                  for v in range(C // 8)]
        mu, is_, sc, bb, r0, r1 = cols[:, c0:c0 + C]
        for s in range(b // p.ngrp, p.steps(m), grid // p.ngrp):
            rows = slice(s * R, min(m, s * R + R))
            acc = torch.zeros(R, C)
            for kk in range(p.np // 16):
                a = gp[s * R:s * R + R, 16 * kk:16 * kk + 16].float()
                for k in planes:
                    acc = acc + a @ pieces[k][c0:c0 + C,
                                              16 * kk:16 * kk + 16].float().t()
            xt = torch.zeros(R, C)
            for v, ch in enumerate(chunks):
                if ch is not None:
                    gj, lc = ch
                    xt[:rows.stop - rows.start, 8 * v:8 * v + 8] = \
                        xs[gj][rows, lc:lc + 8].float()
            xh = (xt - mu) * is_
            gy = torch.where(xh * sc + bb > 0, acc, 0.0)
            gys[rows, c0:c0 + C] = gy[:rows.stop - rows.start]
            out = (sc * is_ * ((gy - r0) - xh * r1)).bfloat16()
            for v, ch in enumerate(chunks):
                if ch is not None:
                    gj, lc = ch
                    dxs[gj][rows, lc:lc + 8] = \
                        out[:rows.stop - rows.start, 8 * v:8 * v + 8]
    return torch.cat(dxs, 1), gys[:, :ctot]


@pytest.mark.parametrize("red_zero", [True, False], ids=["red0", "red"])
@pytest.mark.parametrize("shape", MIRROR, ids=_id)
def test_dx_mirror_is_exact_under_one_hot_cotangents(shape, red_zero):
    """g_y = W[c, n_m] exactly (one exact product a pass, the three pieces
    adding back to W), and the epilogue rounds as the plain version does:
    the mirror gives ``bwd_dx_plain``'s bits. Dropping any plane moves g_y
    off W (dropping the first or second moves the dx bits too: the third
    carries W's last eight bits, below most outputs' bf16 rounding);
    resolving the chunks one group off moves the dx bits."""
    m, ctot, n = shape
    widths = _widths(ctot)
    case = _one_hot_case(m, widths, n, seed=m + ctot + n, red_zero=red_zero)
    xs, g, stat, bias, red, w = case
    want = [torch.empty(m, c, dtype=torch.bfloat16) for c in widths]
    tbk.bwd_dx_plain(xs, g, stat, bias, red, w, want)
    want = torch.cat(want, 1)
    exact = w.t()[torch.arange(m) % n]        # W[c, n_m]
    dx, gy = mirror_bwd_dx(*case)
    assert torch.equal(gy, exact) and torch.equal(dx, want)
    for planes in ((1, 2), (0, 2), (0, 1)):
        dx, gy = mirror_bwd_dx(*case, planes=planes)
        assert (gy != exact).float().mean() > 0.25, planes
        assert planes == (0, 1) or not torch.equal(dx, want), planes
    if len(widths) > 1:
        assert not torch.equal(mirror_bwd_dx(*case, off=1)[0], want)


@functools.lru_cache(maxsize=None)
@one_thread()
def _bn0_apply_shapes():
    """(M, Ctot, Cout) of every ``apply`` call of one CU-Net-8 @256
    ``bn_tile=0`` train forward at batch 24, read from the port's forward
    at full width on 64 x 64 images (16 x 16 at the top of each hourglass,
    a quarter of 64 x 64): M scales by 16, Ctot and Cout do not. Recorded
    once a module, on one intra-op thread (``one_thread``)."""
    from cunet_tpu_torch.config import ModelConfig
    from cunet_tpu_torch.models import apply_cu_net, init_cu_net

    cfg = ModelConfig(layer_num=8, order=1, class_num=16, loss_num=8,
                      use_pallas=True, bn_tile=0)
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    calls = []

    def recorder(xs, vec, w, out, table=None):
        calls.append((16 * xs[0].shape[0], sum(x.shape[1] for x in xs),
                      w.shape[1]))
        return tbk.apply_plain(xs, vec, w, out)

    x = torch.rand(24, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(tbk, "apply", recorder)
        apply_cu_net(params, state, x, cfg=cfg, train=True)
    return tuple(calls)


def test_apply_plans_fit_the_bn0_step():
    """183 ``apply`` calls a step (PERF.md's launch count), at r = 64 ... 4
    and Ctot up to 320: ``affine_dot_plan`` and the table chunks fit in
    shared memory at each, and the plan is ``affine_dot``'s own."""
    calls = _bn0_apply_shapes()
    assert len(calls) == 183
    assert {m for m, _, _ in calls} == {24 * r * r
                                         for r in (64, 32, 16, 8, 4)}
    assert max(k for _, k, _ in calls) == 320
    for m, k, n in sorted(set(calls)):
        p = buf_ops.affine_dot_plan(m, k, n)
        assert tbk.apply_smem(p) == p.smem + p.kp // 8 * tbk.CHUNK_BYTES
        assert tbk.apply_smem(p) <= SMEM_LIMIT, (m, k, n)
        # the chunks sit past the output stages, 16-byte aligned
        assert p.smem == p.out_off + 8 * 16 * (8 * p.ntw + 8) * 2
        assert p.smem % 16 == 0
