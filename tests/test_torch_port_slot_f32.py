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
  across a cluster of blocks (``stats_f32_mirror``), and the BN backward
  at float32 (``bn_bwd_plan(..., f32=True)``);
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


def stats_f32_mirror(x, tiles):
    """``bn_stats``' float32 kernel in torch: each tile's rows split as
    ``stats_plan_f32`` splits them, each of the 32 row stripes of a block
    a running float32 sum, the stripes added in order, then the blocks in
    rank order; the mean, then the centred squares so summed."""
    m, k = x.shape
    tr = m // tiles
    cs, rpb = train_ops.stats_plan_f32(m, tr, k)
    assert rpb % 32 == 0 and (cs - 1) * rpb < tr <= cs * rpb
    on = F.pad(torch.ones(tiles, tr, 1), (0, 0, 0, cs * rpb - tr))
    xs = F.pad(x.view(tiles, tr, k), (0, 0, 0, cs * rpb - tr))

    def tile_sum(v):                    # (tiles, cs * rpb, k), 0 past tr
        v = v.view(tiles, cs, rpb // 32, 32, k)
        acc = torch.zeros(tiles, cs, 32, k)
        for j in range(rpb // 32):      # a stripe's running sum
            acc = acc + v[:, :, j]
        blk = torch.zeros(tiles, cs, k)
        for i in range(32):             # the stripes in order
            blk = blk + acc[:, :, i]
        out = torch.zeros(tiles, k)
        for q in range(cs):             # the cluster's blocks in rank order
            out = out + blk[:, q]
        return out

    mean = tile_sum(xs) / tr
    d = (xs - mean[:, None]) * on
    return torch.stack([mean, tile_sum(d * d) / tr], 1)


@pytest.mark.parametrize("m,tiles,k", [(24 * 4 * 4, 4, 160),
                                       (24 * 8 * 8, 12, 320),
                                       (24 * 16 * 16, 4, 192),
                                       (2 * 6 * 64 * 64, 2, 192)])
def test_stats_and_bn_bwd_at_float32(m, tiles, k):
    """F1 / F6 on float32 x: ``bn_stats`` (two passes) and its kernel's
    split sums (``stats_f32_mirror``, clusters of 1, 6 and 8 blocks here:
    the last two tiles of 6 images at r=64) against float64, and
    ``bn_bwd`` as its float32 plan splits it (``bn_bwd_mirror``) against
    its plain version, each within its sum's limit."""
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
