"""The float32 forms of the slot train kernels #8/#9 on the CPU: their
arithmetic, their plans, the step check's permutation, and the float32
ghost-BN slot step against JAX's.

(a) Torch mirrors of the ten forms (F1-F10 of the float32 ghost-BN step)
held to their plain versions within the float32 n-term limit
``SUM_REL_PER_SQRT_N * sqrt(n)`` of the largest value:

- F2 / F3, the forward products: each row reads its own ghost-BN tile's
  [inv; shift] through the pointers, stride and rows-per-tile that the
  wrappers hand the kernel (``buf_ops._vec_args``), at tiles of 32 and 96
  rows (r=4, tiles 2 and 6: 96 does not divide a 128-row block) and 8,192
  (r=64, tile 2); the product is ``dot3_mirror``'s six bf16 plane products;
- F4 / F7, the input gradients: the float32 cotangent split into three
  planes like the weight (W^T, or ``train_ops.flip_w3`` of the conv's),
  gated by the forward's rounding of x*inv + shift (bit for bit the plain
  version's gate); one bf16 pass of dy breaks the limit;
- F5 / F8, the weight gradients: ``dw_f32_plan``'s runs of M, each a
  partial of steps of 16 to 64 rows, each k16 row group's six products
  summed from zero in a fragment of its own, the partials added in run
  order (``sum_rows``); the runs cover every row once, in order; the
  mirror within the float32 limit of the plain version and within 2^-24
  sqrt(M) relative L2 of a float64 product (``tests/
  test_torch_port_dw_f32_plans.py`` holds the plans' coverage and the 3x3
  form's staging);
- F1 / F6: the statistics as ``stats_plan_f32`` splits a tile's rows
  across a cluster of blocks, one pass of shifted sums, float32 8-row
  partials in float64 (``stats_f32_mirror``; against float64, the plain
  version and JAX's ``_stats``, no farther from float64 than the plain
  version on a cancelling input), and the BN backward at float32
  (``bn_bwd_plan(..., f32=True)``; at r=64 the persistent kernel's order,
  ``bn_bwd_f32_mirror``, writing d_x and adding into it, against the
  plain version, JAX's ``_affine_bwd`` and float64);
- F9 / F10: the pool's first-winner routing on float32 ties, and the
  unrounded 2x2 sum.

(b) Every new host plan fits the H100's shared memory at every shape of
the CU-Net-8 @256 float32 step (batch 24, tiles 1, 2 and 6, r = 64 ... 4;
the weight gradients at order 1 and order 14, K up to 1,920).

(c) ``chip_smoke.tile_perm``: the permutation of the float32 step check's
controls keeps every image in its ghost-BN tile (the tile's statistics are
then the same sums in another order).

(d) The float32 ghost-BN slot path (plain versions, two slots,
``num_blocks=2``, 32 px, batch 4, tiles 2 and 1) against JAX's
``fused_slot_train`` in interpret mode on the same weights
(``tools/from_jax.py``): the loss, the outputs and every gradient leaf,
each within max(1e-5, 2c) of its largest value, c that leaf's largest
distance between JAX's own float32 paths (the fused slot kernels against
the lax path on the batch and on it permuted three ways with its tiles
kept whole: the same function, summed in other orders); each slot's
per-tile statistics within max(1e-5, 2c) of c on that slot's output (the
lax path emits no per-tile statistics). JAX's gradients rounded once to
bf16 break their leaf's limit at every leaf. A flat 1e-5 fails on JAX's
own paths (their distance reaches 4.6e-4 at tile 1, where a BN tile of
one image's 64 rows at the neck cancels most of the BN jacobian's terms).
"""

import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cunet_tpu.models import apply_cu_net as jax_apply_cu_net
from cunet_tpu.train.loss import intermediate_mse as jax_mse
from cunet_tpu_torch.kernels import buf_ops, train_ops
from cunet_tpu_torch.kernels.buf_ops import SMEM_LIMIT
from cunet_tpu_torch.kernels.train_slot import slot_plan
from cunet_tpu_torch.models import apply_cu_net
from cunet_tpu_torch.tools.from_jax import flatten_tree
from cunet_tpu_torch.train import intermediate_mse

from test_torch_port_bf16_split import SUM_REL_PER_SQRT_N, split_bf16x3
from test_torch_port_f32_forms import ORDER, dot3_mirror
from test_torch_port_stage_bwd_plans import bn_bwd_mirror
from torch_port_util import from_jax, images, np_weights, small_cfg

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

EPS = 1e-5
# (M, tile rows): r=4 at batch 24, tiles 2 and 6; r=64 tile 2 (two of its
# tiles, to keep the CPU mirror short)
TILE_CASES = [(24 * 4 * 4, 32), (24 * 4 * 4, 96), (2 * 8192, 8192)]


def _limit(n, ref):
    return SUM_REL_PER_SQRT_N * n ** 0.5 * ref.abs().max().item()


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32))


def _vec(rng, tiles, k):
    """Per-tile (T, 2, k) [inv; shift], a few columns wider than read."""
    inv = rng.uniform(0.5, 1.5, (tiles, k + 8)).astype(np.float32)
    shift = (rng.standard_normal((tiles, k + 8)) * 0.5).astype(np.float32)
    return torch.from_numpy(np.stack([inv, shift], axis=1))


def row_vectors(vec, m, k):
    """(inv, shift) (m, k) of each row, read as the float32 kernels read
    them: from the two pointers, the per-tile stride and the rows per tile
    that ``buf_ops._vec_args`` hands them, row r at tile r // tile_rows
    (``dot3_kernel``'s ``vrow``, the weight gradients' prologue and
    the gate's ``o``)."""
    p_inv, p_shift, vstride, tile_rows = buf_ops._vec_args(vec, m, k)
    flat = vec.reshape(-1)
    base = vec.data_ptr()
    off = (torch.arange(m) // tile_rows * vstride)[:, None] + torch.arange(k)
    return (flat[(p_inv - base) // 4 + off],
            flat[(p_shift - base) // 4 + off])


def prologue(x, vec):
    """relu(x * inv + shift) per row, two float32 roundings (the kernels'
    ``affine``)."""
    inv, shift = row_vectors(vec, x.shape[0], x.shape[1])
    return torch.relu(x * inv + shift)


def gate(x, vec):
    inv, shift = row_vectors(vec, x.shape[0], x.shape[1])
    return x * inv + shift > 0


def im2col(y, b, h, w):
    return chip_smoke.im2col(torch, y, b, h, w)


def dw_f32_mirror(z, dy, plan):
    """z^T dy as the float32 weight-gradient kernel sums it under ``plan``
    (``train_ops.dw_f32_plan``): per run, its steps' k16 row groups in
    ascending order, each the six plane products of ``ORDER`` summed from
    zero in a fragment that joins the run's sum by one float32 add; the
    runs' partials added in order (``sum_rows``)."""
    m = z.shape[0]
    mp = -(-m // 16) * 16
    zp = split_bf16x3(F.pad(z, (0, 0, 0, mp - m)))
    dp = split_bf16x3(F.pad(dy, (0, 0, 0, mp - m)))
    out = torch.zeros(z.shape[1], dy.shape[1])
    for p in range(plan.runs):
        acc = torch.zeros_like(out)
        for step in plan.steps(p, m):
            for k0 in range(step.start, step.stop, 16):
                part = torch.zeros_like(out)
                for i, j in ORDER:
                    part = part + zp[i][k0:k0 + 16].float().t() @ \
                        dp[j][k0:k0 + 16].float()
                acc = acc + part
        out = out + acc
    return out


# ---------------------------------------------------------------------------
# (a) the forms' arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,tile_rows", TILE_CASES)
def test_per_row_tile_vectors_are_the_plain_versions_tiles(m, tile_rows):
    """Each row's vectors through the kernels' pointer arithmetic are its
    tile's; with them, F2's product (``dot3_mirror`` of the prologue)
    is ``affine_dot_plain`` within the float32 limit, F4's gate is the
    plain gate bit for bit."""
    rng = np.random.default_rng(m + tile_rows)
    k = 192
    vec = _vec(rng, m // tile_rows, k)
    inv, shift = row_vectors(vec, m, k)
    t = torch.arange(m) // tile_rows
    assert torch.equal(inv, vec[t, 0, :k]) and torch.equal(
        shift, vec[t, 1, :k])
    x = _rand(rng, m, k)
    assert torch.equal(gate(x, vec), train_ops._gate(x, vec, False))
    assert torch.equal(prologue(x, vec),
                       torch.relu(buf_ops.tile_affine(x, vec)))
    w = _rand(rng, k, 128, scale=k ** -0.5)
    want = buf_ops.affine_dot_plain(x, vec, w, torch.empty(m, 128))
    got = dot3_mirror(prologue(x, vec), w)
    assert (got - want).abs().max() <= _limit(k, want)


@pytest.mark.parametrize("tile_rows", [32, 96])
def test_conv_prologue_per_tile(tile_rows):
    """F3: the implicit GEMM of relu(BN2(yb)) per row's tile (a tap's
    source pixel lies in the row's image, so in its tile), zero padding
    after the prologue, against ``conv3x3_plain`` at r=4, batch 24."""
    rng = np.random.default_rng(tile_rows)
    b, r, cb, g = 24, 4, 128, 32
    m = b * r * r
    y = _rand(rng, m, cb)
    vec = _vec(rng, m // tile_rows, cb)
    w3 = _rand(rng, 9 * cb, g, scale=(9 * cb) ** -0.5)
    want = buf_ops.conv3x3_plain(y, w3, b, r, r, torch.empty(m, g), vec)
    got = dot3_mirror(im2col(prologue(y, vec), b, r, r), w3)
    assert (got - want).abs().max() <= _limit(9 * cb, want)


@pytest.mark.parametrize("form", ["affine_dx", "conv3x3_dx"])
def test_input_gradients_split_dy_and_gate(form):
    """F4 / F7: dy and the transposed weight each in three planes, six
    products, the gate after: within the limit of the plain version; one
    bf16 pass of dy (dy rounded, then the same products) breaks it."""
    rng = np.random.default_rng(4)
    b, r, tiles = 24, 4, 4
    m = b * r * r
    if form == "affine_dx":
        k, n = 192, 128
        x, dy = _rand(rng, m, k), _rand(rng, m, n)
        w = _rand(rng, k + 32, n, scale=k ** -0.5)
        vec = _vec(rng, tiles, k)
        want = train_ops.affine_dx_plain(dy, w, x, vec, torch.empty(m, k))

        def product(d):
            return dot3_mirror(d, w[:k].t().contiguous())
        depth = n
    else:
        k, g = 128, 32
        x, dy = _rand(rng, m, k), _rand(rng, m, g)
        w = _rand(rng, 9 * k, g, scale=(9 * k) ** -0.5)
        vec = _vec(rng, tiles, k)
        want = train_ops.conv3x3_dx_plain(dy, w, b, r, r, x, vec,
                                          torch.empty(m, k))

        def product(d):
            return dot3_mirror(im2col(d, b, r, r), train_ops.flip_w3(w))
        depth = 9 * g
    lim = _limit(depth, want)
    got = torch.where(gate(x, vec), product(dy), 0.0)
    assert (got - want).abs().max() <= lim
    one_pass = torch.where(gate(x, vec), product(dy.bfloat16().float()), 0.0)
    assert (one_pass - want).abs().max() > 3 * lim


def test_flip_w3_is_the_conv_transpose():
    """``flip_w3``: the SAME conv of dy through it is ``conv_transpose2d``
    of dy through the forward weight, in float64."""
    rng = np.random.default_rng(5)
    b, r, cb, g = 2, 6, 16, 8
    w3 = _rand(rng, 9 * cb, g).double()
    dy = _rand(rng, b * r * r, g).double()
    wt = w3.view(3, 3, cb, g).permute(3, 2, 0, 1)
    want = F.conv_transpose2d(dy.reshape(b, r, r, g).permute(0, 3, 1, 2),
                              wt, padding=1).permute(0, 2, 3, 1)
    got = im2col(dy, b, r, r) @ train_ops.flip_w3(w3)
    torch.testing.assert_close(got, want.reshape(-1, cb), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("form,r,tile", [("affine_dw", 4, 6),
                                         ("affine_dw", 16, 2),
                                         ("conv3x3_dw", 4, 6),
                                         ("conv3x3_dw", 8, 2)])
def test_weight_gradients_in_the_plans_split_order(form, r, tile):
    """F5 / F8: ``dw_f32_plan``'s runs cover M's rows once, in order, in
    steps of ``br`` rows, and the mirror of their partials (both operands
    split, a fragment a k16 row group, the runs added in order) is the
    plain version within the limit of M terms and a float64 product within
    the relative L2 error of one recursive float32 sum over M rows."""
    rng = np.random.default_rng(r * 10 + tile)
    b = 24
    m, tiles = b * r * r, b // tile
    k, n = (192, 128) if form == "affine_dw" else (128, 32)
    x, dy = _rand(rng, m, k), _rand(rng, m, n)
    vec = _vec(rng, tiles, k)
    z = prologue(x, vec)
    if form == "affine_dw":
        want = train_ops.affine_dw_plain(x, vec, dy, torch.empty(k, n))
        plan = train_ops.dw_f32_plan(m, k, n)
    else:
        want = train_ops.conv3x3_dw_plain(x, vec, dy, b, r, r,
                                          torch.empty(9 * k, n))
        z = im2col(z, b, r, r)
        plan = train_ops.dw_f32_plan(m, k, n, r)
    steps = [s for p in range(plan.runs) for s in plan.steps(p, m)]
    assert [i for s in steps for i in s] == list(range(m))
    assert all(s.start % plan.br == 0 and len(s) <= plan.br for s in steps)
    assert plan.blocks <= train_ops.DW_F32_BLOCKS * 12 // plan.warps
    got = dw_f32_mirror(z, dy, plan)
    assert (got - want).abs().max() <= _limit(m, want)
    ref = z.double().t() @ dy.double()
    rel = ((got.double() - ref).norm() / ref.norm()).item()
    assert rel <= 2.0 ** -24 * m ** 0.5, rel


def fma32(a, b, c):
    """float32 fma(a, b, c): the exact product and sum, rounded once (in
    float64 first: a float32 product is exact there)."""
    return (a.double() * b.double() + c.double()).float()


def bf16_cut(v):
    """v with its low 16 bits cleared: 8 significant bits."""
    return (v.view(torch.int32) & -65536).view(torch.float32)


def stats_f32_mirror(x, tiles):
    """``bn_stats``' float32 kernel in torch: each tile's rows split as
    ``stats_plan_f32`` splits them; a shift x0 a channel, the tile's first
    8 rows' float32 mean cut to 8 significant bits; each of a block's 32
    row stripes sums d = x - x0 and d^2 over 8 of its rows at a time in
    float32 (the square by fma), those partials in float64; the stripes in
    order, the blocks in rank order, in float64; mean = x0 + E[d], var =
    E[d^2] - E[d]^2, each rounded once to float32."""
    m, k = x.shape
    tr = m // tiles
    cs, rpb = train_ops.stats_plan_f32(m, tr, k)
    assert rpb % 32 == 0 and (cs - 1) * rpb < tr <= cs * rpb
    xt = x.view(tiles, tr, k)
    n0 = min(tr, 8)
    acc = torch.zeros(tiles, k)
    for j in range(n0):
        acc = acc + xt[:, j]
    x0 = bf16_cut(acc / n0)
    span = -(-rpb // 256) * 256                 # 8 rows x 32 stripes a step
    xs = F.pad(xt, (0, 0, 0, cs * rpb - tr))    # the ranks' rows, 0 past tr
    xs = xs.view(tiles, cs, rpb, k)
    on = F.pad(torch.ones(tiles, tr, 1), (0, 0, 0, cs * rpb - tr))
    on = on.view(tiles, cs, rpb, 1)
    xs = F.pad(xs, (0, 0, 0, span - rpb))
    on = F.pad(on, (0, 0, 0, span - rpb))
    # rows: step, j (8), stripe (32)
    d = ((xs - x0[:, None, None]) * on).view(tiles, cs, span // 256, 8, 32,
                                            k)
    s = torch.zeros(tiles, cs, 32, k, dtype=torch.float64)
    q = torch.zeros_like(s)
    for step in range(span // 256):
        ps = torch.zeros(tiles, cs, 32, k)
        pq = torch.zeros_like(ps)
        for j in range(8):
            v = d[:, :, step, j]
            ps = ps + v
            pq = fma32(v, v, pq)
        s, q = s + ps.double(), q + pq.double()
    ds = torch.zeros(tiles, k, dtype=torch.float64)
    dq = torch.zeros_like(ds)
    for rank in range(cs):
        bs = torch.zeros(tiles, k, dtype=torch.float64)
        bq = torch.zeros_like(bs)
        for i in range(32):                     # the stripes in order
            bs, bq = bs + s[:, rank, i], bq + q[:, rank, i]
        ds, dq = ds + bs, dq + bq
    md = ds / tr
    var = (dq / tr - md * md).clamp_min(0)
    return torch.stack([(x0.double() + md).float(), var.float()], 1)


def bn_bwd_f32_mirror(x, d_a, st, bn, eps, plan, d_x0=None):
    """``bn_bwd``'s persistent float32 kernel in torch (``plan.persistent``):
    a tile's rows split across the cluster's ranks (``plan.rows``); a
    thread owns 4 channels of the rows ``rs + u * stripes`` of its rank
    (stripes = 256 / (cb / 4)) and sums d_a * xh (by fma) and d_a over them
    in float32; in float64 the stripes in groups of 8 in order, the groups
    in order, the ranks in order; the tile's sums rounded once to float32
    (``part``), dbn their sum over the tiles in tile order (``sum_rows``);
    d_x = ig * (d_a - sb/m - xh * sg/m) with sb/m, sg/m rounded from
    float64, or with ``d_x0`` (the accumulating instances) d_x0 plus that
    in float32."""
    tiles, k = st.shape[0], x.shape[1]
    tr = x.shape[0] // tiles
    stripes = 256 // (plan.cb // 4)
    rstd = torch.rsqrt(st[:, 1] + eps)
    d_x = torch.empty(x.shape)
    part = torch.empty(tiles, 2, k)
    for t in range(tiles):
        sl = slice(t * tr, (t + 1) * tr)
        xh = (x[sl] - st[t, 0]) * rstd[t]
        da = d_a[sl]
        tsum = torch.zeros(2, k, dtype=torch.float64)
        for q in range(plan.cs):
            rows = plan.rows(q, tr)
            n = len(rows)
            steps = -(-n // stripes)
            pad = steps * stripes - n
            dq = F.pad(da[rows.start:rows.stop], (0, 0, 0, pad))
            xq = F.pad(xh[rows.start:rows.stop], (0, 0, 0, pad))
            dq = dq.view(steps, stripes, k)
            xq = xq.view(steps, stripes, k)
            fg = torch.zeros(stripes, k)
            fb = torch.zeros(stripes, k)
            for u in range(steps):              # a thread's rows in order
                fg = fma32(dq[u], xq[u], fg)
                fb = fb + dq[u]
            g = torch.stack([fg, fb]).double().view(2, stripes // 8, 8, k)
            grp = torch.zeros(2, stripes // 8, k, dtype=torch.float64)
            for i in range(8):                  # a group's stripes in order
                grp = grp + g[:, :, i]
            blk = torch.zeros(2, k, dtype=torch.float64)
            for i in range(stripes // 8):       # the groups in order
                blk = blk + grp[:, i]
            tsum = tsum + blk                   # the ranks in order
        part[t] = tsum.float()
        mg, mb = (tsum / tr).float()
        d_x[sl] = rstd[t] * bn[0, :k] * (da - mb - xh * mg)
        if d_x0 is not None:
            d_x[sl] += d_x0[sl]
    dbn = torch.zeros(2, k)
    for t in range(tiles):
        dbn = dbn + part[t]
    return d_x, dbn


@pytest.mark.parametrize("m,tiles,k", [(24 * 4 * 4, 4, 160),
                                       (24 * 8 * 8, 12, 320),
                                       (24 * 16 * 16, 4, 192),
                                       (2 * 6 * 64 * 64, 2, 192)])
def test_stats_and_bn_bwd_at_float32(m, tiles, k):
    """F1 / F6 on float32 x: ``bn_stats`` (two passes) and its kernel's
    one pass of shifted sums (``stats_f32_mirror``, clusters of 1, 4 and
    16 blocks here: the last two tiles of 6 images at r=64) against
    float64, and ``bn_bwd`` as its float32 plan splits it
    (``bn_bwd_mirror``; at r=64 also in the persistent kernel's order,
    ``bn_bwd_f32_mirror``) against its plain version, each within its
    sum's limit."""
    rng = np.random.default_rng(m + k)
    x = _rand(rng, m, k) * 1.7 + 0.3
    st = train_ops.bn_stats_plain(x, torch.empty(tiles, 2, k))
    x64 = x.double().reshape(tiles, -1, k)
    want = torch.stack([x64.mean(1), x64.var(1, unbiased=False)], 1)
    assert (st.double() - want).abs().max() <= _limit(m // tiles, want)
    got = stats_f32_mirror(x, tiles)
    assert (got.double() - want).abs().max() <= _limit(m // tiles, want)
    d_a = _rand(rng, m, k)
    bn = torch.from_numpy(np.stack([rng.uniform(0.5, 1.5, k),
                                    rng.standard_normal(k) * 0.3])
                          .astype(np.float32))
    plan = train_ops.bn_bwd_plan(m, m // tiles, k, f32=True)
    got_dx, got_dbn = bn_bwd_mirror(x, d_a, st, bn, EPS, plan)
    dx, dbn = torch.empty(m, k), torch.empty(2, k)
    train_ops.bn_bwd_plain(x, d_a, st, bn, EPS, dx, dbn)
    assert (got_dx - dx).abs().max() <= _limit(m // tiles, dx)
    assert (got_dbn - dbn).abs().max() <= _limit(m, dbn)
    assert plan.persistent == (m // tiles == 6 * 64 * 64)
    if plan.persistent:
        got_dx, got_dbn = bn_bwd_f32_mirror(x, d_a, st, bn, EPS, plan)
        assert (got_dx - dx).abs().max() <= _limit(m // tiles, dx)
        assert (got_dbn - dbn).abs().max() <= _limit(m, dbn)


@pytest.mark.parametrize("shift", [0.0, 4.0])
def test_bn_stats_f32_one_pass_against_float64_plain_and_jax(shift):
    """``bn_stats``' float32 kernel (``stats_f32_mirror``) at a tile of 6
    images at r=64 (24,576 rows, clusters of 16 blocks): within the float32
    limit of its plain version and of JAX's ``_stats``, and no farther
    from float64 than the plain version (the variance on x ~ N(0, 1) and
    on a cancelling x ~ 4 + N(0, 1), mean^2 / var ~ 16; the mean on the
    latter), its sums in float64 rounded once."""
    from cunet_tpu.kernels.train_slot import _stats as jax_stats

    tiles, tr, k = 2, 6 * 64 * 64, 64
    assert train_ops.stats_plan_f32(tiles * tr, tr, k) == (16, 1536)
    rng = np.random.default_rng(23)
    x = _rand(rng, tiles * tr, k) + shift
    got = stats_f32_mirror(x, tiles).double()
    plain = train_ops.bn_stats_plain(x, torch.empty(tiles, 2, k)).double()
    x64 = x.double().view(tiles, tr, k)
    mean64, var64 = x64.mean(1), x64.var(1, unbiased=False)
    jax = torch.stack([torch.from_numpy(np.stack(
        [np.asarray(a) for a in jax_stats(x[t * tr:(t + 1) * tr].numpy())]))
        for t in range(tiles)]).double()
    for ref in (plain, jax):
        assert (got - ref).abs().max() <= _limit(tr, ref)

    def err(st):
        return (((st[:, 0] - mean64) / var64.sqrt()).abs().max().item(),
                ((st[:, 1] - var64) / var64).abs().max().item())

    (gm, gv), (pm, pv) = err(got), err(plain)
    assert gv <= pv and gv <= 2.0 ** -22
    if shift:
        assert gm <= pm


@pytest.mark.parametrize("tr,k,cb,rows", [(64 * 64 * 2, 64, 32, 16),
                                          (64 * 64 * 6, 32, 16, 24)])
def test_bn_bwd_f32_persistent_order(tr, k, cb, rows):
    """``bn_bwd``'s persistent float32 plan at a tile of 2 (6) images at
    r=64: clusters of 16 blocks of 32 (16) channels, 16 (24) rows a thread
    in registers, every row of the tile in one rank; the kernel's order of
    sums (``bn_bwd_f32_mirror``) within the float32 limit of the plain
    version and of JAX's ``_affine_bwd``, and dbn within 2^-24 sqrt(M)
    relative L2 of float64."""
    import jax.numpy as jnp

    from cunet_tpu.kernels.train_slot import _affine_bwd

    plan = train_ops.bn_bwd_plan(tr, tr, k, f32=True)
    assert plan.persistent and (plan.cb, plan.cs) == (cb, 16)
    assert plan.thread_rows == rows <= train_ops.BN_F32_ROWS
    assert [i for q in range(plan.cs) for i in plan.rows(q, tr)] \
        == list(range(tr))
    rng = np.random.default_rng(tr + k)
    x = _rand(rng, tr, k) * 1.7 + 0.3
    d_a = _rand(rng, tr, k)
    st = train_ops.bn_stats_plain(x, torch.empty(1, 2, k))
    bn = torch.from_numpy(np.stack([rng.uniform(0.5, 1.5, k),
                                    rng.standard_normal(k) * 0.3])
                          .astype(np.float32))
    got_dx, got_dbn = bn_bwd_f32_mirror(x, d_a, st, bn, EPS, plan)
    dx, dbn = torch.empty(tr, k), torch.empty(2, k)
    train_ops.bn_bwd_plain(x, d_a, st, bn, EPS, dx, dbn)
    jdx, jdbn = _affine_bwd(
        jnp.asarray(x.numpy()), jnp.asarray(bn.numpy()),
        jnp.asarray(st[0, 0].numpy()), jnp.asarray(st[0, 1].numpy()),
        jnp.asarray(d_a.numpy()), jnp.float32, EPS,
        z=jnp.ones((tr, k), jnp.float32))
    for ref_dx, ref_dbn in ((dx, dbn), (torch.from_numpy(np.array(jdx)),
                                        torch.from_numpy(np.array(jdbn)))):
        assert (got_dx - ref_dx).abs().max() <= _limit(tr, ref_dx)
        assert (got_dbn - ref_dbn).abs().max() <= _limit(tr, ref_dbn)
    rstd = torch.rsqrt(st[0, 1].double() + EPS)
    xh = (x.double() - st[0, 0].double()) * rstd
    dbn64 = torch.stack([(d_a.double() * xh).sum(0), d_a.double().sum(0)])
    rel = ((got_dbn.double() - dbn64).norm() / dbn64.norm()).item()
    assert rel <= 2.0 ** -24 * tr ** 0.5, rel


@pytest.mark.parametrize("tr,k,cb,rows", [(64 * 64 * 2, 64, 32, 16),
                                          (64 * 64 * 6, 32, 8, 12)])
def test_bn_bwd_f32_persistent_accumulates(tr, k, cb, rows):
    """The persistent float32 kernel's accumulating instance (a block's
    skip adapter and bottleneck, the head: d_x added into) at a tile of 2
    (6) images at r=64, its plan's 32 (8) channels a block, 16 (12) rows
    a thread: the kernel's order of sums (``bn_bwd_f32_mirror``) adding
    into a random d_x, within the float32 limit of the plain version with
    ``accumulate`` and of JAX's ``_affine_bwd`` plus that d_x."""
    import jax.numpy as jnp

    from cunet_tpu.kernels.train_slot import _affine_bwd

    plan = train_ops.bn_bwd_plan(tr, tr, k, f32=True, accumulate=True)
    assert plan.persistent and (plan.cb, plan.cs) == (cb, 16)
    assert plan.thread_rows == rows <= train_ops.BN_F32_ACC_ROWS
    rng = np.random.default_rng(tr + k + 1)
    x = _rand(rng, tr, k) * 1.7 + 0.3
    d_a = _rand(rng, tr, k)
    base = _rand(rng, tr, k)
    st = train_ops.bn_stats_plain(x, torch.empty(1, 2, k))
    bn = torch.from_numpy(np.stack([rng.uniform(0.5, 1.5, k),
                                    rng.standard_normal(k) * 0.3])
                          .astype(np.float32))
    got_dx, got_dbn = bn_bwd_f32_mirror(x, d_a, st, bn, EPS, plan, base)
    dx, dbn = base.clone(), torch.empty(2, k)
    train_ops.bn_bwd_plain(x, d_a, st, bn, EPS, dx, dbn, accumulate=True)
    jdx, jdbn = _affine_bwd(
        jnp.asarray(x.numpy()), jnp.asarray(bn.numpy()),
        jnp.asarray(st[0, 0].numpy()), jnp.asarray(st[0, 1].numpy()),
        jnp.asarray(d_a.numpy()), jnp.float32, EPS,
        z=jnp.ones((tr, k), jnp.float32))
    for ref_dx, ref_dbn in ((dx, dbn),
                            (base + torch.from_numpy(np.array(jdx)),
                             torch.from_numpy(np.array(jdbn)))):
        assert (got_dx - ref_dx).abs().max() <= _limit(tr, ref_dx)
        assert (got_dbn - ref_dbn).abs().max() <= _limit(tr, ref_dbn)


def test_pool_and_upsample_backward_at_float32():
    """F9: a float32 window's cotangent goes to its first maximal element,
    ties included, unrounded; F10: the unrounded 2x2 sum."""
    rng = np.random.default_rng(9)
    b, h, c = 2, 8, 16
    a = _rand(rng, b * h * h, c)
    a6 = a.view(b, h // 2, 2, h // 2, 2, c)
    a6[:, ::2, :, :, :, ::3] = 1.25 + 2 ** -20      # whole windows tied
    d_pool = _rand(rng, b * h * h // 4, c)
    got = train_ops.maxpool2_bwd(a, d_pool, b, h, h,
                                 torch.empty(b * h * h, c))
    assert got.dtype == torch.float32
    g6 = got.view(b, h // 2, 2, h // 2, 2, c)
    assert torch.equal(g6[:, ::2, 0, :, 0, ::3],
                       d_pool.view(b, h // 2, h // 2, c)[:, ::2, :, ::3])
    assert torch.equal(g6.sum(dim=(2, 4)).reshape(-1, c), d_pool)
    assert ((g6 != 0).sum(dim=(2, 4)) <= 1).all()
    d_up = _rand(rng, 4 * b * h * h, c)
    up = train_ops.upsample2_bwd(d_up, b, h, h, torch.empty(b * h * h, c))
    want = d_up.double().view(b, h, 2, h, 2, c).sum(dim=(2, 4))
    assert (up.double() - want.reshape(-1, c)).abs().max() <= \
        _limit(4, want)


# ---------------------------------------------------------------------------
# (b) the plans at every shape of the float32 step
# ---------------------------------------------------------------------------


def _step_shapes(tile, order=1):
    """(m, tile_rows, k, n) of every stage of the CU-Net-8 @256 float32
    ghost-BN step at ``tile`` (batch 24, c=128, g=32, Cb=128: L up to
    ``order``), the intermedia adapter (c * (1 + order) channels) and the
    16-class head."""
    out = set()
    for L in range(order + 1):
        for p in slot_plan(4, 64, 128, 32, L):
            m = 24 * p["res"] ** 2
            tr = tile * p["res"] ** 2
            out.update({(m, tr, p["k1"], 128), (m, tr, p["k2"], 128),
                        (m, tr, 128, 16), (m, tr, 128 * (1 + order), 128)})
    return sorted(out)


@pytest.mark.parametrize("tile", [1, 2, 6])
def test_f32_plans_fit_at_every_step_shape(tile):
    for m, tr, k, n in _step_shapes(tile):
        assert buf_ops.fwd_f32_plan(k, n).smem <= SMEM_LIMIT  # F2
        assert train_ops.affine_dx_f32_plan(k, n).smem <= SMEM_LIMIT  # F4
        assert train_ops.bn_bwd_plan(m, tr, k, True).smem <= SMEM_LIMIT
        if k == 128 and n == 128:                              # the conv
            for cin, cout in ((128, 32), (32, 128)):          # F3, F7
                c = buf_ops.conv3x3_plan_f32(m, cin, cout)
                assert c.smem <= SMEM_LIMIT
                assert sorted(ch for s in c.k_chunks(9 * cin) for ch in s) \
                    == list(range(-(-9 * cin // 32)))
    for order in (1, 14):                                      # F5, F8
        for m, tr, k, n in _step_shapes(tile, order):
            res = int(round((m // 24) ** 0.5))
            for p, c in ((train_ops.dw_f32_plan(m, k, n), k),
                         (train_ops.dw_f32_plan(m, 128, 32, res), 128)):
                assert p.smem <= (SMEM_LIMIT if p.warps == 12
                                  else buf_ops.SMEM_PAIR)
                assert p.runs * p.run_rows >= m > (p.runs - 1) * p.run_rows
                assert (p.nkb - 1) * p.kc < c <= p.nkb * p.kc


# ---------------------------------------------------------------------------
# (c) the step check's permutation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bt", [1, 2, 6])
def test_tile_perm_keeps_every_image_in_its_tile(bt):
    n = 24
    for seed in range(3):
        perm = chip_smoke.tile_perm(torch, n, bt, torch.Generator()
                                    .manual_seed(seed))
        assert sorted(perm.tolist()) == list(range(n))
        tiles = perm.view(n // bt, bt) // bt
        # each new tile holds the images of one old tile
        assert (tiles == tiles[:, :1]).all()
        assert sorted(tiles[:, 0].tolist()) == list(range(n // bt))
    if bt > 1:
        assert any(not torch.equal(chip_smoke.tile_perm(
            torch, n, bt, torch.Generator().manual_seed(s)), torch.arange(n))
            for s in range(3))
    perms = chip_smoke.tile_perms(torch, n, bt, 7)
    assert len({tuple(q.tolist()) for q in perms + [torch.arange(n)]}) == 8


# ---------------------------------------------------------------------------
# (d) the float32 ghost-BN slot path against JAX's fused slot kernels
# ---------------------------------------------------------------------------

STEP_FLOOR = 1e-5
STEP_CONTROL = 2.0
# tile-preserving permutations of the lax path's controls
LAX_PERMS = 3


def _capture(module, store):
    """Wrap ``module.fused_slot_train`` to record each call's per-tile
    statistics (the fifth output) into ``store``."""
    orig = module.fused_slot_train

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        store.append([np.asarray(s.detach().numpy() if torch.is_tensor(s)
                                 else s) for s in out[4]])
        return out
    return orig, wrapped


def run_f32_slot_step(tile):
    """The float32 slot step on JAX's fused slot kernels (interpret mode),
    on JAX's lax path and on the port's plain versions, from the same
    weights: their outputs, per-tile statistics, losses and gradients."""
    import cunet_tpu.kernels.train_slot as jts
    import cunet_tpu_torch.kernels.train_slot as pts

    cfg = small_cfg(2, 1, bn_tile=tile, bn_dtype="float32",
                    remat="none", use_scan=False, use_pallas=True,
                    compute_dtype="float32")
    pn, sn = np_weights(cfg)
    x = images(4, 32)
    t = np.random.RandomState(3).rand(4, 8, 8, cfg.class_num).astype(
        np.float32)
    jstats, pstats = [], []

    def loss(p):
        outs, ns = jax_apply_cu_net(p, sn, x, cfg=cfg, train=True)
        return jax_mse(outs, t), (outs, ns)

    (jl, (jouts, _)), jg = jax.value_and_grad(loss, has_aux=True)(pn)
    lax_cfg = dataclasses.replace(cfg, use_pallas=False)

    def flat(tree):
        return flatten_tree(jax.tree_util.tree_map(np.asarray, tree))

    def lax_run(q):
        """JAX's lax path on the batch permuted by ``q``: (loss, outputs
        in the batch's own order, flat grads)."""
        def lax_loss(p):
            outs, _ = jax_apply_cu_net(p, sn, x[q], cfg=lax_cfg, train=True)
            return jax_mse(outs, t[q]), outs

        (ll, louts), lg = jax.value_and_grad(lax_loss, has_aux=True)(pn)
        inv = np.argsort(q)
        return float(ll), [np.asarray(o)[inv] for o in louts], flat(lg)

    perms = chip_smoke.tile_perms(torch, 4, tile, LAX_PERMS)
    lax = [lax_run(q) for q in [np.arange(4)] + [q.numpy() for q in perms]]
    orig, wrapped = _capture(jts, jstats)
    jts.fused_slot_train = wrapped
    try:
        jax_apply_cu_net(pn, sn, x, cfg=cfg, train=True)   # eager: stats
    finally:
        jts.fused_slot_train = orig
    params, state = from_jax(pn, sn, cfg=cfg)
    for v in params.values():
        v.requires_grad_(True)
    orig, wrapped = _capture(pts, pstats)
    pts.fused_slot_train = wrapped
    try:
        outs, _ = apply_cu_net(params, state, torch.from_numpy(x), cfg=cfg,
                               train=True)
    finally:
        pts.fused_slot_train = orig
    tl = intermediate_mse(outs, torch.from_numpy(t))
    tl.backward()

    return dict(jl=float(jl), tl=tl.item(), jouts=jouts, outs=outs,
                jstats=jstats, pstats=pstats, jgrads=flat(jg), lax=lax,
                grads={k: v.grad for k, v in params.items()})


@pytest.fixture(scope="module", params=[2, 1], ids=["tile2", "tile1"])
def f32_slot_step(request):
    return run_f32_slot_step(request.param)


def _limit_of(c, leaf, fused):
    """A leaf's limit: max(1e-5, 2x its largest distance between JAX's own
    float32 paths: the fused slot kernels, and the lax path on the batch
    and on it permuted with its tiles kept whole (``leaf(run)`` picks the
    leaf from a lax run (loss, outputs, grads))."""
    return max(STEP_FLOOR, STEP_CONTROL * max(_rel(leaf(r), fused)
                                              for r in c["lax"]))


def _rel(got, want):
    """The largest difference relative to ``want``'s largest value."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _close(got, want, what, limit):
    rel = _rel(got, want)
    assert rel <= limit, (f"{what}: {rel:.3g} of its largest value > "
                          f"{limit:.3g}")


def test_f32_slot_step_outputs_and_loss_match_jax(f32_slot_step):
    c = f32_slot_step
    _close(c["tl"], c["jl"], "loss", _limit_of(c, lambda r: r[0], c["jl"]))
    assert len(c["outs"]) == len(c["jouts"])
    for i, (a, b) in enumerate(zip(c["outs"], c["jouts"])):
        _close(a.detach().numpy(), b, f"output {i}",
               _limit_of(c, lambda r: r[1][i], b))


def test_f32_slot_step_per_tile_stats_match_jax(f32_slot_step):
    """Each slot's per-tile statistics in emission order, within max(1e-5,
    2x the largest distance of JAX's own paths on that slot's output):
    the lax path emits no per-tile statistics to hold them to, and they
    are values of the slot's forward. JAX emits the skip adapters' (bn_s)
    statistics again after bn_a's, the port once
    (``train_slot.stat_widths``)."""
    c = f32_slot_step
    assert len(c["pstats"]) == len(c["jstats"]) == 2
    for i, (ps, js) in enumerate(zip(c["pstats"], c["jstats"])):
        lim = _limit_of(c, lambda r: r[1][i], c["jouts"][i])
        # drop bn_s's copies: an entry equal to the one before it
        kept = [s for q, s in enumerate(js) if q == 0 or not (
            s.shape == js[q - 1].shape and np.array_equal(s, js[q - 1]))]
        assert len(kept) == len(ps)
        for k, (a, b) in enumerate(zip(ps, kept)):
            _close(a, b, f"slot {i} stats {k}", lim)


def test_f32_slot_step_grads_match_jax(f32_slot_step):
    """Each gradient leaf within its own limit (``_limit_of``); JAX's
    gradients rounded once to bf16 break that limit at every leaf."""
    c = f32_slot_step
    assert set(c["grads"]) == set(c["jgrads"])
    for k, want in c["jgrads"].items():
        lim = _limit_of(c, lambda r: r[2][k], want)
        _close(c["grads"][k].numpy(), want, k, lim)
        lo = torch.from_numpy(np.array(want)).bfloat16().float().numpy()
        assert _rel(lo, want) > lim, (k, _rel(lo, want), lim)
