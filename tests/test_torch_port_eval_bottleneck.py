"""Torch port: the per-bottleneck eval kernels (TPU kernel #6) and the
feature-table product under them, against the JAX package on the CPU.

- ``fused_bottleneck_infer`` / ``fused_dual_bottleneck_infer`` (their plain
  versions on CPU tensors) against JAX's kernels in interpret mode at 1-4
  feature groups, with the row count a multiple of 8 and not (JAX's
  ``_lax_fallback``): float32 within ``TOL``; bf16 bit for bit (measured:
  both round the activation once before the product and the float32 sum
  once after it, and at these depths the sums' order moves no rounding);
- ``table_dot``'s BN2 epilogue, its column-prefix weights and its image-
  major output against JAX's ``_bottleneck_val`` (the 1x1 stage of #4);
- the whole model with ``use_pallas, pallas_hourglass=False,
  use_scan=False`` (every bottleneck and intermedia adapter on #6, each
  down block's adapter pair on its dual form) against JAX's same path;
- the quantized eval with ``use_pallas``: weights-only W1/I8/G8, and
  ``int8_infer`` on #10, whose down-block adapter pairs run the float dual
  kernel while the neck and up adapters run int8 (JAX's quirk).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cunet_tpu.kernels.quant_matmul as jax_qm
from cunet_tpu.config import QuantConfig
from cunet_tpu.kernels import fused_bottleneck as jax_fb
from cunet_tpu.kernels.fused_hourglass import _bottleneck_val
from cunet_tpu.models import apply_cu_net as jax_apply_cu_net
from cunet_tpu.train.quant_step import quant_eval_params as jax_qep
from cunet_tpu_torch.kernels import bottleneck_infer, eval_ops
from cunet_tpu_torch.models import apply_cu_net

from torch_port_util import TOL, from_jax, images, np_weights, small_cfg

W1I8G8 = QuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True)
INT8 = dataclasses.replace(W1I8G8, int8_infer=True, int8_impl="pallas")
# the quantized models: int8 products exact, float32 affines and float
# adapters summed in another order
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
# (group widths, image batch, resolution): M = 32, 2 (no multiple-of-8
# tile: JAX's _lax_fallback), 54 (the same) and 128
GROUPS = [((16,), 2, 4), ((16, 8), 2, 1), ((16, 16, 8), 6, 3),
          ((16, 16, 8, 8), 2, 8)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _operands(widths, n, r, cout=16, seed=0):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(n, r, r, c).astype(np.float32) for c in widths]
    ctot = sum(widths)

    def bn():
        return (rng.uniform(0.5, 1.5, ctot).astype(np.float32),
                (rng.randn(ctot) * 0.5).astype(np.float32))

    def conv():
        return (rng.randn(1, 1, ctot, cout) * ctot ** -0.5).astype(
            np.float32)

    return feats, bn(), conv(), bn(), conv()


def _to(arrs, dtype):
    return ([jnp.asarray(a).astype(dtype) for a in arrs],
            [_t(a).to(getattr(torch, jnp.dtype(dtype).name)) for a in arrs])


@pytest.mark.parametrize("widths,n,r", GROUPS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_single_matches_jax(widths, n, r, dtype):
    feats, (inv, shift), w, _, _ = _operands(widths, n, r)
    jf, tf = _to(feats, dtype)
    want = np.asarray(jax_fb.fused_bottleneck_infer(
        jf, jnp.asarray(inv), jnp.asarray(shift), jnp.asarray(w)).astype(
            jnp.float32))
    got = bottleneck_infer.fused_bottleneck_infer(tf, _t(inv), _t(shift),
                                                  _t(w))
    assert got.dtype == tf[0].dtype and got.shape == want.shape
    if dtype == jnp.float32:
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("widths,n,r", GROUPS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_dual_matches_jax(widths, n, r, dtype):
    feats, (inv_a, sh_a), w_a, (inv_s, sh_s), w_s = _operands(widths, n, r,
                                                              seed=1)
    jf, tf = _to(feats, dtype)
    want = jax_fb.fused_dual_bottleneck_infer(
        jf, *map(jnp.asarray, (inv_a, sh_a, w_a, inv_s, sh_s, w_s)))
    got = bottleneck_infer.fused_dual_bottleneck_infer(
        tf, *map(_t, (inv_a, sh_a, w_a, inv_s, sh_s, w_s)))
    single = bottleneck_infer.fused_bottleneck_infer(
        tf, _t(inv_s), _t(sh_s), _t(w_s))
    assert torch.equal(got[1], single)      # one read, the same numbers
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        if dtype == jnp.float32:
            np.testing.assert_allclose(g.numpy(), w, **TOL)
        else:
            np.testing.assert_array_equal(g.float().numpy(), w)


def test_table_dot_stages_match_jax_bottleneck_val():
    """The 1x1 stages of the per-slot kernel (#4) at bf16: a bottleneck
    with BN2's ``relu(. + shift2)`` epilogue on its float32 sum, an
    adapter over [x, fifo, out32] reading a row prefix of a padded weight,
    and a 68-class head (the face model) reading a column prefix of its
    padded weight into an image-major view. Against JAX's
    ``_bottleneck_val`` on the concat: bit for bit (measured)."""
    rng = np.random.RandomState(3)
    m, c, g = 2 * 8 * 8, 16, 8
    x, fifo, out32 = (rng.randn(m, k).astype(np.float32) for k in (c, g, g))
    k = c + 2 * g
    vec = np.stack([rng.uniform(0.5, 1.5, k + g),
                    rng.randn(k + g) * 0.5]).astype(np.float32)
    w = (rng.randn(k + g, 72) * k ** -0.5).astype(np.float32)
    w[k:] = 0.0                                     # the padding rows
    shift2 = (rng.randn(72) * 0.5).astype(np.float32)
    xs = [_t(a).to(torch.bfloat16) for a in (x, fifo, out32)]
    cat = jnp.concatenate([jnp.asarray(a).astype(jnp.bfloat16)
                           for a in (x, fifo, out32)], axis=-1)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    tw = _t(w).to(torch.bfloat16)

    def close(got, want):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))

    # bottleneck: yb stays float32 through + shift2 and the ReLU
    yb = _bottleneck_val(cat, jnp.asarray(vec[:, :k]), wb[:k, :32],
                         jnp.bfloat16)
    want = jnp.maximum(yb + shift2[:32], 0.0).astype(jnp.bfloat16)
    got = torch.empty(m, 32, dtype=torch.bfloat16)
    eval_ops.table_dot(xs, _t(vec), tw[:, :32], got,
                       bias=_t(shift2[:32]).contiguous())
    close(got, want)
    # adapter: a row prefix of the padded weight and vector
    want = _bottleneck_val(cat[:, :c + g], jnp.asarray(vec[:, :c + g]),
                           wb[:c + g, :16], jnp.bfloat16).astype(jnp.bfloat16)
    got = torch.empty(m, 16, dtype=torch.bfloat16)
    eval_ops.table_dot(xs[:2], _t(vec), tw[:, :16], got)
    close(got, want)
    # head: 68 classes from the 72-column weight, image-major (2, 64, 68)
    want = _bottleneck_val(cat[:, :c], jnp.asarray(vec[:, :c]), wb[:c, :68],
                           jnp.bfloat16).astype(jnp.bfloat16)
    out = torch.zeros(2, 3, 64, 72, dtype=torch.bfloat16)
    eval_ops.table_dot(xs[:1], _t(vec), tw, out[:, 1, :, :68])
    close(out[:, 1, :, :68].reshape(m, 68), want)
    assert not out[:, 1, :, 68:].any() and not out[:, 0].any()


def test_table_dot_checks_its_operands():
    x = torch.zeros(8, 16)
    vec, w = torch.zeros(2, 16), torch.zeros(16, 8)
    # any number of feature groups (17 here: past the 16 a launch carries
    # in its parameters), but one at least
    out = eval_ops.table_dot([x] * 17, torch.zeros(2, 272),
                             torch.zeros(272, 8), torch.full((8, 8), 7.0))
    assert not out.any()
    with pytest.raises(ValueError, match="one or more"):
        eval_ops.table_dot([], vec, w, torch.empty(8, 8))
    with pytest.raises(ValueError, match="dual"):
        eval_ops.table_dot([x], vec, w, torch.empty(8, 8), bias=torch.zeros(8),
                           vec_s=vec, w_s=w, out_s=torch.empty(8, 8))
    with pytest.raises(ValueError, match="shapes"):
        eval_ops.table_dot([x], vec, w[:8], torch.empty(8, 8))


# ---------------------------------------------------------------------------
# the whole model on #6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layer_num,order", [(4, 1), (4, 2), (3, 0)])
def test_layer_path_matches_jax(layer_num, order):
    cfg = small_cfg(layer_num, order, use_pallas=True,
                    pallas_hourglass=False, use_scan=False)
    pn, sn = np_weights(cfg)
    x = images()
    want, _ = jax_apply_cu_net(pn, sn, x, cfg=cfg, train=False)
    params, state = from_jax(pn, sn, cfg=cfg)
    got, _ = apply_cu_net(params, state, _t(x), cfg=cfg)
    assert len(got) == len(want) == len(cfg.anchors)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_layer_path_runs_the_float32_affine():
    """``bn_dtype="compute"`` narrows the plain path's BN affine; #6 keeps
    it float32 (``fused_bottleneck.py:63-65``), in JAX and in the port: at
    bf16 the port's #6 path equals JAX's bit for bit (measured), and the
    plain path differs from both."""
    cfg = small_cfg(3, 1, compute_dtype="bfloat16", bn_dtype="compute",
                    use_pallas=True, pallas_hourglass=False, use_scan=False)
    pn, sn = np_weights(cfg)
    x = images()
    want, _ = jax_apply_cu_net(pn, sn, x, cfg=cfg, train=False)
    params, state = from_jax(pn, sn, cfg=cfg)
    got, _ = apply_cu_net(params, state, _t(x), cfg=cfg)
    plain, _ = apply_cu_net(params, state, _t(x),
                            cfg=dataclasses.replace(cfg, use_pallas=False))
    for g, w, p in zip(got, want, plain):
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_array_equal(g.float().numpy(), w)
        assert not np.array_equal(p.float().numpy(), w)


# ---------------------------------------------------------------------------
# the quantized eval with use_pallas
# ---------------------------------------------------------------------------


def _quant_model(cfg, q):
    pn, sn = np_weights(cfg)
    qp = jax.tree_util.tree_map(np.asarray, jax_qep(pn, q))
    return qp, sn


@pytest.mark.parametrize("q", [W1I8G8, INT8], ids=["w1i8g8", "int8"])
def test_quant_eval_with_use_pallas_matches_jax(monkeypatch, q):
    # JAX's int8 product (#10) in interpret mode, as its own tests run it
    orig = jax_qm.int8_matmul_dequant
    monkeypatch.setattr(jax_qm, "int8_matmul_dequant",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    cfg = small_cfg(4, 1, use_pallas=True, use_scan=False)
    qp, sn = _quant_model(cfg, q)
    x = images()
    want, _ = jax_apply_cu_net(qp, sn, x, cfg=cfg, train=False, quant=q)
    params, state = from_jax(qp, sn, cfg=cfg)
    got, _ = apply_cu_net(params, state, _t(x), cfg=cfg, quant=q)
    assert len(got) == len(want) == len(cfg.anchors)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODEL_TOL)


def test_int8_eval_runs_float_dual_adapters(monkeypatch):
    """With ``int8_infer`` and ``use_pallas`` the down blocks' adapter
    pairs run the float dual kernel, once per down block and slot, while
    every other bottleneck and adapter runs int8; without ``use_pallas``
    they run int8 too, to other numbers."""
    cfg = small_cfg(3, 1, use_pallas=True)
    qp, sn = _quant_model(cfg, INT8)
    params, state = from_jax(qp, sn, cfg=cfg)
    x = _t(images())
    calls = []
    dual = bottleneck_infer.fused_dual_bottleneck_infer
    monkeypatch.setattr(bottleneck_infer, "fused_dual_bottleneck_infer",
                        lambda *a: calls.append(1) or dual(*a))
    got, _ = apply_cu_net(params, state, x, cfg=cfg, quant=INT8)
    assert len(calls) == cfg.num_blocks * cfg.layer_num
    plain, _ = apply_cu_net(params, state, x, quant=INT8,
                            cfg=dataclasses.replace(cfg, use_pallas=False))
    assert len(calls) == cfg.num_blocks * cfg.layer_num
    assert not np.allclose(got[-1].numpy(), plain[-1].numpy(), rtol=1e-3,
                           atol=1e-3)
