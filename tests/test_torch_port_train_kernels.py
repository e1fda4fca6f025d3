"""Torch port: train-mode BN and bottleneck, and the plain versions of the
slot train kernels, against their JAX counterparts on the CPU.

- the ``bn_dtype="compute"`` repair: ``batch_norm`` and ``dense_bottleneck``
  with bf16 inputs and ``norm_dtype=bfloat16`` equal JAX's within one bf16
  ulp (the two frameworks may round the affine once or twice);
- train ``batch_norm`` (tile 0 and 2, both affine dtypes) and train
  ``dense_bottleneck``: values, new running stats and gradients;
- each train kernel's plain version (what its wrapper computes on a CPU
  tensor) against the in-kernel jnp function of
  ``cunet_tpu/kernels/train_slot.py`` it replaces, per ghost-BN tile;
- the port's kernel train path against the JAX fused slot kernels
  (``use_pallas=True, bn_tile=2``) in interpret mode, as
  tests/test_train_slot.py runs them.

Tolerances: float32 values 2e-4 (sums in another order), gradients 1e-3
(through the BN jacobian's two reductions), model-level as in
tests/test_train_slot.py (forward 5e-4, loss rtol 1e-4, grads 3e-3).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cunet_tpu.kernels import train_slot as jts
from cunet_tpu.kernels.fused_hourglass import (
    _conv3x3,
    pack_w3_dycol,
    pack_w3_scatter,
)
from cunet_tpu.models import apply_cu_net as jax_apply_cu_net
from cunet_tpu.ops import bottleneck as jax_bottleneck
from cunet_tpu.ops import layers as jax_layers
from cunet_tpu.train.loss import intermediate_mse as jax_mse
from cunet_tpu_torch.kernels import buf_ops, train_ops, train_slot
from cunet_tpu_torch.models import apply_cu_net
from cunet_tpu_torch.ops import bottleneck, layers
from cunet_tpu_torch.tools.from_jax import flatten_tree
from cunet_tpu_torch.train import intermediate_mse

from torch_port_util import from_jax, images, np_weights, small_cfg

VAL = dict(rtol=2e-4, atol=2e-4)
GRAD = dict(rtol=1e-3, atol=1e-3)
EPS = 1e-5
RNG = np.random.RandomState


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bn_params(rng, c):
    return ({"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
             "bias": (rng.randn(c) * 0.2).astype(np.float32)},
            {"mean": (rng.randn(c) * 0.2).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)})


def _torch_tree(tree):
    return {k: (_torch_tree(v) if isinstance(v, dict) else _t(v))
            for k, v in tree.items()}


def _assert_within_bf16_ulp(got, want):
    """|got - want| <= one bf16 ulp of want, elementwise."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    bad = np.abs(got - want) > ulp
    assert not bad.any(), (f"{bad.sum()} of {bad.size} elements more than "
                           f"one bf16 ulp apart; worst "
                           f"{np.abs(got - want).max()}")


# ---------------------------------------------------------------------------
# the bn_dtype repair
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_bf16_affine_matches_jax(train):
    rng = RNG(0)
    x = rng.randn(4, 4, 4, 16).astype(np.float32)
    xb = x.astype(ml_dtypes.bfloat16)
    p, s = _bn_params(rng, 16)
    want, _ = jax_layers.batch_norm(jnp.asarray(xb), p, s, train=train,
                                    norm_dtype=jnp.bfloat16,
                                    tile=2 if train else 0)
    got, _ = layers.batch_norm(_t(x).bfloat16(), _torch_tree(p),
                               _torch_tree(s), train=train,
                               norm_dtype=torch.bfloat16,
                               tile=2 if train else 0)
    assert got.dtype == torch.bfloat16
    _assert_within_bf16_ulp(got.float().numpy(),
                            np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("train", [False, True])
def test_dense_bottleneck_bf16_affine_matches_jax(train):
    rng = RNG(1)
    feats = [rng.randn(4, 4, 4, c).astype(np.float32).astype(
        ml_dtypes.bfloat16) for c in (16, 8)]
    p = {"norm": _bn_params(rng, 24)[0],
         "conv": (rng.randn(1, 1, 24, 16) * 0.2).astype(np.float32)}
    s = _bn_params(rng, 24)[1]
    want, _ = jax_bottleneck.dense_bottleneck(
        [jnp.asarray(f) for f in feats], p, s, train=train,
        norm_dtype=jnp.bfloat16, tile=2 if train else 0)
    got, _ = bottleneck.dense_bottleneck(
        [_t(f.astype(np.float32)).bfloat16() for f in feats],
        _torch_tree(p), _torch_tree(s), train=train,
        norm_dtype=torch.bfloat16, tile=2 if train else 0)
    _assert_within_bf16_ulp(got.float().numpy(),
                            np.asarray(want).astype(np.float32))


# ---------------------------------------------------------------------------
# train batch_norm and dense_bottleneck
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tile", [0, 2])
@pytest.mark.parametrize("narrow", [False, True])
def test_train_batch_norm_matches_jax(tile, narrow):
    """Values, new running stats and input / scale / bias grads. With the
    bf16 affine the values are bf16 (held within one ulp); the two
    autodiffs round the backward's bf16 products and sums at different
    points, so there the grads are held by relative L2 <= 2e-2 (a few bf16
    ulps over the 64-element reductions) instead of elementwise."""
    rng = RNG(2)
    x = rng.randn(4, 4, 4, 8).astype(np.float32)
    p, s = _bn_params(rng, 8)
    probe = rng.randn(4, 4, 4, 8).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if narrow
                else (jnp.float32, torch.float32))
    nd = (jnp.bfloat16, torch.bfloat16) if narrow else (None, None)

    def jf(xx, pp):
        y, ns = jax_layers.batch_norm(xx, pp, s, train=True,
                                      norm_dtype=nd[0], tile=tile)
        return jnp.sum(y.astype(jnp.float32) * probe), (y, ns)

    (_, (want, want_s)), (jgx, jgp) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(x).astype(jdt), p)
    tx = _t(x).to(tdt).requires_grad_(True)
    tp = {k: v.requires_grad_(True) for k, v in _torch_tree(p).items()}
    got, got_s = layers.batch_norm(tx, tp, _torch_tree(s), train=True,
                                   norm_dtype=nd[1], tile=tile)
    (got.float() * _t(probe)).sum().backward()

    def close(a, b):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        if not narrow:
            np.testing.assert_allclose(a, b, **GRAD)
        else:
            assert np.linalg.norm(a - b) <= 2e-2 * np.linalg.norm(b)

    if narrow:
        _assert_within_bf16_ulp(got.float().detach().numpy(),
                                np.asarray(want).astype(np.float32))
    else:
        np.testing.assert_allclose(got.detach().numpy(), want, **VAL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_s[k].numpy(), want_s[k], rtol=1e-5,
                                   atol=1e-6)
    close(tx.grad.float().numpy(), jgx)
    for k in ("scale", "bias"):
        close(tp[k].grad.numpy(), jgp[k])


@pytest.mark.parametrize("tile", [0, 2])
def test_train_dense_bottleneck_matches_jax(tile):
    rng = RNG(3)
    feats = [rng.randn(4, 4, 4, c).astype(np.float32) for c in (16, 8, 8)]
    p = {"norm": _bn_params(rng, 32)[0],
         "conv": (rng.randn(1, 1, 32, 12) * 0.2).astype(np.float32)}
    s = _bn_params(rng, 32)[1]
    probe = rng.randn(4, 4, 4, 12).astype(np.float32)

    def jf(fs, pp):
        y, ns = jax_bottleneck.dense_bottleneck(fs, pp, s, train=True,
                                                tile=tile)
        return jnp.sum(y * probe), (y, ns)

    (_, (want, want_s)), (jgf, jgp) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)([jnp.asarray(f) for f in feats], p)
    tf = [_t(f).requires_grad_(True) for f in feats]
    tp = {"norm": {k: _t(v).requires_grad_(True)
                   for k, v in p["norm"].items()},
          "conv": _t(p["conv"]).requires_grad_(True)}
    got, got_s = bottleneck.dense_bottleneck(tf, tp, _torch_tree(s),
                                             train=True, tile=tile)
    (got * _t(probe)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **VAL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_s[k].numpy(), want_s[k], rtol=1e-5,
                                   atol=1e-6)
    for f, g in zip(tf, jgf):
        np.testing.assert_allclose(f.grad.numpy(), g, **GRAD)
    np.testing.assert_allclose(tp["conv"].grad.numpy(), jgp["conv"], **GRAD)
    for k in ("scale", "bias"):
        np.testing.assert_allclose(tp["norm"][k].grad.numpy(),
                                   jgp["norm"][k], **GRAD)


# ---------------------------------------------------------------------------
# plain versions of the train kernels against the TPU kernels' jnp pieces
# ---------------------------------------------------------------------------

T, BT, H = 2, 2, 8            # tiles, images per tile, resolution
M = T * BT * H * H


def _stage(rng, k, n):
    """x (M, K), bn (2, K), w (K, N), dy (M, N) of one stage."""
    x = (rng.randn(M, k) * 1.5 + 0.3).astype(np.float32)
    bn = np.stack([rng.uniform(0.5, 1.5, k),
                   rng.randn(k) * 0.3]).astype(np.float32)
    w = (rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
    dy = rng.randn(M, n).astype(np.float32)
    return x, bn, w, dy


def _port_stats(x):
    return train_ops.bn_stats(_t(x), torch.empty(T, 2, x.shape[1]))


def _tiles(a):
    return np.split(np.asarray(a), T)


def test_bn_stats_matches_stats():
    x = _stage(RNG(10), 24, 8)[0]
    got = _port_stats(x).numpy()
    for t, xt in enumerate(_tiles(x)):
        mu, var = jts._stats(jnp.asarray(xt))
        np.testing.assert_allclose(got[t, 0], mu, **VAL)
        np.testing.assert_allclose(got[t, 1], var, **VAL)


def test_affine_dot_per_tile_matches_norm_relu_dot():
    x, bn, w, _ = _stage(RNG(11), 24, 16)
    st = _port_stats(x)
    got = buf_ops.affine_dot(_t(x), train_slot._affine_vec(st, _t(bn), EPS),
                             _t(w), torch.empty(M, 16)).numpy()
    for t, xt in enumerate(_tiles(x)):
        mu, var = jts._stats(jnp.asarray(xt))
        z = jts._norm_relu(jnp.asarray(xt), bn, mu, var, jnp.float32, EPS)
        np.testing.assert_allclose(_tiles(got)[t],
                                   jts._dot(z, w, jnp.float32), **VAL)


def _check_conv_prologue(rng, cb, g, h):
    m = T * BT * h * h
    yb = (rng.randn(m, cb) + 0.2).astype(np.float32)
    bn2 = np.stack([rng.uniform(0.5, 1.5, cb),
                    rng.randn(cb) * 0.3]).astype(np.float32)
    w3 = (rng.randn(3, 3, cb, g) * 0.2).astype(np.float32)
    st = _port_stats(yb)
    got = buf_ops.conv3x3(_t(yb), buf_ops.pack_w3(_t(w3)), T * BT, h, h,
                          torch.empty(m, g),
                          vec=train_slot._affine_vec(st, _t(bn2), EPS))
    for t, yt in enumerate(_tiles(yb)):
        mu, var = jts._stats(jnp.asarray(yt))
        z2 = jts._norm_relu(jnp.asarray(yt), bn2, mu, var, jnp.float32, EPS)
        want = _conv3x3(z2, pack_w3_dycol(jnp.asarray(w3)), BT, h, h,
                        mode="dycol")
        np.testing.assert_allclose(_tiles(got.numpy())[t], want, **VAL)


def test_conv3x3_bn_prologue_matches_norm_relu_conv():
    _check_conv_prologue(RNG(12), 16, 8, H)


# (Cb, G, r): the card tests' channel and output tails (24, 48; 16, 24,
# 40), widths that do not divide a kernel tile (6, 12), 2x2 images
CONV_TAILS = [(24, 16, 6), (48, 24, 4), (16, 40, 12), (16, 8, 2)]


@pytest.mark.parametrize("cb,g,h", CONV_TAILS)
def test_conv3x3_bn_prologue_tails_match_norm_relu_conv(cb, g, h):
    _check_conv_prologue(RNG(40 + cb + g + h), cb, g, h)


def _port_stage_bwd(x, bn, w, dy):
    """affine_dx -> bn_bwd, affine_dw: (d_x, dW, d_bn) of one stage."""
    k, n = w.shape
    st = _port_stats(x)
    vec = train_slot._affine_vec(st, _t(bn), EPS)
    d_a = train_ops.affine_dx(_t(dy), _t(w), _t(x), vec, torch.empty(M, k))
    dw = train_ops.affine_dw(_t(x), vec, _t(dy), torch.empty(k, n))
    d_x, dbn = torch.empty(M, k), torch.empty(2, k)
    train_ops.bn_bwd(_t(x), d_a, st, _t(bn), EPS, d_x, dbn)
    return d_x.numpy(), dw.numpy(), dbn.numpy()


@pytest.mark.parametrize("k,n", [(40, 16), (16, 4)])
def test_stage_bwd_kernels_match_stage_bwd(k, n):
    """B1 affine_dx + B2 bn_bwd + B3 affine_dw == ``_stage_bwd`` (the
    adapter / bottleneck / head backward), tile by tile, dW and d_bn
    summed over tiles as the TPU grid accumulates them."""
    x, bn, w, dy = _stage(RNG(13 + k), k, n)
    d_x, dw, dbn = _port_stage_bwd(x, bn, w, dy)
    want_dw, want_dbn = 0.0, 0.0
    for t, (xt, dyt) in enumerate(zip(_tiles(x), _tiles(dy))):
        mu, var = jts._stats(jnp.asarray(xt))
        jdx, jdw, jdbn = jts._stage_bwd(jnp.asarray(xt), jnp.asarray(bn),
                                        jnp.asarray(w), mu, var,
                                        jnp.asarray(dyt), jnp.float32, EPS)
        np.testing.assert_allclose(_tiles(d_x)[t], jdx, **GRAD)
        want_dw, want_dbn = want_dw + np.asarray(jdw), want_dbn + np.asarray(
            jdbn)
    np.testing.assert_allclose(dw, want_dw, **GRAD)
    np.testing.assert_allclose(dbn, want_dbn, **GRAD)


def _check_conv_bwd(rng, cb, g, res):
    bt, tiles = BT, T
    m = tiles * bt * res * res
    yb = (rng.randn(m, cb) + 0.2).astype(np.float32)
    bn2 = np.stack([rng.uniform(0.5, 1.5, cb),
                    rng.randn(cb) * 0.3]).astype(np.float32)
    w3 = (rng.randn(3, 3, cb, g) * 0.2).astype(np.float32)
    d_o = rng.randn(m, g).astype(np.float32)
    st = train_ops.bn_stats(_t(yb), torch.empty(tiles, 2, cb))
    vec = train_slot._affine_vec(st, _t(bn2), EPS)
    w3p = buf_ops.pack_w3(_t(w3))
    n_img = tiles * bt
    d_a = train_ops.conv3x3_dx(_t(d_o), w3p, n_img, res, res, _t(yb), vec,
                               torch.empty(m, cb))
    dw3 = train_ops.conv3x3_dw(_t(yb), vec, _t(d_o), n_img, res, res,
                               torch.empty(9 * cb, g))
    d_yb, dbn = torch.empty(m, cb), torch.empty(2, cb)
    train_ops.bn_bwd(_t(yb), d_a, st, _t(bn2), EPS, d_yb, dbn)
    w_sc = pack_w3_scatter(jnp.asarray(w3))
    want_dw, want_dbn = 0.0, 0.0
    for t, (yt, dt) in enumerate(zip(np.split(yb, tiles),
                                     np.split(d_o, tiles))):
        mu, var = jts._stats(jnp.asarray(yt))
        z2 = jts._norm_relu(jnp.asarray(yt), bn2, mu, var, jnp.float32, EPS)
        d_z2, jdw = jts._conv3x3_bwd(z2, w_sc, jnp.asarray(dt), bt, res,
                                     res, jnp.float32)
        jdyb, jdbn = jts._affine_bwd(jnp.asarray(yt), bn2, mu, var, d_z2,
                                     jnp.float32, EPS)
        np.testing.assert_allclose(np.split(d_yb.numpy(), tiles)[t], jdyb,
                                   **GRAD)
        # scatter columns are [c, tap*G + g]; the port's rows [tap*Cb + c]
        jdw = np.asarray(jdw).reshape(cb, 9, g).transpose(1, 0, 2)
        want_dw = want_dw + jdw.reshape(9 * cb, g)
        want_dbn = want_dbn + np.asarray(jdbn)
    np.testing.assert_allclose(dw3.numpy(), want_dw, **GRAD)
    np.testing.assert_allclose(dbn.numpy(), want_dbn, **GRAD)


@pytest.mark.parametrize("res", [8, 2])
def test_conv_bwd_kernels_match_conv3x3_bwd_and_affine_bwd(res):
    """B4 conv3x3_dx + B5 conv3x3_dw + B2 bn_bwd == ``_conv3x3_bwd``
    (scatter packing) followed by ``_affine_bwd`` of BN2, per tile."""
    _check_conv_bwd(RNG(20 + res), 16, 8, res)


@pytest.mark.parametrize("cb,g,res", CONV_TAILS)
def test_conv_bwd_kernel_tails_match_conv3x3_bwd(cb, g, res):
    _check_conv_bwd(RNG(60 + cb + g + res), cb, g, res)


@pytest.mark.parametrize("tie", [False, True])
def test_maxpool2_bwd_matches_pool_bwd(tie):
    """First-winner routing, including exact ties (all four quadrants of
    some windows equal): the cotangent goes to exactly one element."""
    rng = RNG(30)
    b, h, c = 2, 8, 16
    ahead = rng.randn(b * h * h, c).astype(np.float32)
    if tie:
        a6 = ahead.reshape(b, h // 2, 2, h // 2, 2, c)
        a6[:, ::2, :, :, :, ::3] = 1.25         # whole windows tied
        a6[:, 1::2, 1, :, 0, 1::2] = a6[:, 1::2, 0, :, 1, 1::2]
        ahead = a6.reshape(b * h * h, c)
    d_pool = rng.randn(b * h * h // 4, c).astype(np.float32)
    got = train_ops.maxpool2_bwd(_t(ahead), _t(d_pool), b, h, h,
                                 torch.empty(b * h * h, c)).numpy()
    want = jts._pool_bwd(jnp.asarray(d_pool), jnp.asarray(ahead), None, h, h,
                         b)
    np.testing.assert_array_equal(got, np.asarray(want))
    # every window routes its whole cotangent exactly once
    sums = got.reshape(b, h // 2, 2, h // 2, 2, c).sum(axis=(2, 4))
    np.testing.assert_allclose(sums.reshape(-1, c), d_pool, rtol=1e-6)


def test_upsample2_bwd_matches_upsample_bwd():
    rng = RNG(31)
    b, h, c = 2, 4, 16
    d_up = rng.randn(b * 4 * h * h, c).astype(np.float32)
    got = train_ops.upsample2_bwd(_t(d_up), b, h, h,
                                  torch.empty(b * h * h, c)).numpy()
    want = jts._upsample_bwd(jnp.asarray(d_up), h, h, b, c)
    np.testing.assert_allclose(got, want, **VAL)


def test_geometry_matches_jax():
    for nb, h0, c, g, L in [(2, 8, 16, 8, 0), (4, 64, 128, 32, 1),
                            (2, 8, 16, 8, 2)]:
        assert train_slot.slot_plan(nb, h0, c, g, L) == jts.slot_plan(
            nb, h0, c, g, L)
    cfg = small_cfg(3, 1, bn_tile=2)
    for i in range(3):
        meta = train_slot.SlotMeta(num_blocks=2, L=min(i, 1),
                                   has_inter=i > 0, bt=2, chan=16, growth=8,
                                   cb=16, h=8, dtype=torch.float32)
        jmeta = jts.finalize_meta(jts.make_meta(cfg, i, 2), 8)
        W = {"head": (np.zeros((2, 16)), None)}
        if i > 0:
            W["inter"] = (np.zeros((2, 16 * (1 + min(i, 1)))), None)
        # JAX emits the skip adapter's statistics (bn_a's) again after
        # bn_a; the port emits them once
        want = iter(jts._stat_widths(jmeta, W))
        shared = [next(want)] if i > 0 else []
        for p in jmeta["plan"]:
            shared += [next(want), next(want), next(want)]
            if p["skip"]:
                assert next(want) == p["k2"] == shared[-1]
        shared += list(want)
        assert train_slot.stat_widths(meta) == shared


def test_train_wrappers_check_shapes_and_count_nothing_on_cpu():
    train_ops.reset_launch_counts()
    x = torch.randn(M, 16)
    with pytest.raises(ValueError):
        train_ops.bn_stats(x, torch.empty(3, 2, 16))      # 3 tiles of 256?
    with pytest.raises(ValueError):
        train_ops.affine_dx(torch.randn(M, 8), torch.randn(16, 4), x,
                            torch.ones(T, 2, 16), torch.empty(M, 16))
    with pytest.raises(ValueError):
        train_ops.maxpool2_bwd(x, torch.randn(M, 16), 2, 8, 8,
                               torch.empty(M, 16))
    train_ops.bn_stats(x, torch.empty(T, 2, 16))
    assert not any(train_ops.launch_counts().values())


# ---------------------------------------------------------------------------
# the kernel train path against the JAX fused slot kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fused_case():
    cfg = small_cfg(2, 1, bn_tile=2, bn_dtype="compute", remat="none",
                    use_scan=False, use_pallas=True)
    pn, sn = np_weights(cfg)
    x = images(4, 32)
    t = RNG(3).rand(4, 8, 8, cfg.class_num).astype(np.float32)

    def loss(p):
        outs, ns = jax_apply_cu_net(p, sn, x, cfg=cfg, train=True)
        return jax_mse(outs, t), (outs, ns)

    (jl, (jouts, jns)), jg = jax.value_and_grad(loss, has_aux=True)(pn)
    params, state = from_jax(pn, sn, cfg=cfg)
    for v in params.values():
        v.requires_grad_(True)
    outs, new_state = apply_cu_net(params, state, torch.from_numpy(x),
                                   cfg=cfg, train=True)
    tl = intermediate_mse(outs, torch.from_numpy(t))
    tl.backward()
    flat = lambda tree: flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                            tree))
    return dict(jl=float(jl), jouts=jouts, jstate=flat(jns),
                jgrads=flat(jg), tl=tl.item(), outs=outs,
                state=new_state, params=params)


def test_kernel_train_path_matches_jax_fused_forward(fused_case):
    c = fused_case
    np.testing.assert_allclose(c["tl"], c["jl"], rtol=1e-4)
    for a, b in zip(c["outs"], c["jouts"]):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=5e-4,
                                   atol=5e-4)


def test_kernel_train_path_matches_jax_fused_bn_state(fused_case):
    c = fused_case
    for k, want in c["jstate"].items():
        np.testing.assert_allclose(c["state"][k].numpy(), want, rtol=5e-4,
                                   atol=5e-4, err_msg=k)


def test_kernel_train_path_matches_jax_fused_grads(fused_case):
    c = fused_case
    for k, want in c["jgrads"].items():
        np.testing.assert_allclose(c["params"][k].grad.numpy(), want,
                                   rtol=3e-3, atol=3e-3, err_msg=k)
