"""Torch port: the int8 forward against the JAX package on the CPU.

- the plain versions of the three int8 kernels (the wrappers on CPU
  tensors) against their JAX counterparts: ``int8_matmul_dequant`` in
  interpret mode, ``_affine_dot_i8`` / ``_q8`` of the int8 TPU kernel, and
  its int8 scatter 3x3 conv (restated from ``fused_model_buf.py``); all
  exact, since integer products are exact in both;
- ``quantize_activations_i8``, ``pack_binarized_weight``,
  ``binarized_matmul_infer`` and ``_int8_bottleneck_infer``: exact;
- the whole quantized model at f32 and small widths, on JAX's
  ``quant_eval_params`` weights: the port's whole-model int8 path against
  JAX's ``fused_model_buf_infer(quant_bits_i=8)`` in interpret mode and
  against JAX's lax int8 path (1e-5); the port's plain path with
  ``int8_impl="pallas"`` against ``"lax"`` (bit-identical); order 1 and 2;
- the whole-model int8 path at bf16 against JAX's int8 kernel in
  interpret mode: bit-identical, order 1 and 2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cunet_tpu.kernels.quant_matmul as jax_qm
from cunet_tpu.config import QuantConfig
from cunet_tpu.kernels.fused_hourglass import pack_w3_scatter
from cunet_tpu.kernels.fused_model_buf import _affine_dot_i8, _q8
from cunet_tpu.models import apply_cu_net as jax_apply_cu_net
from cunet_tpu.models.cu_net import (
    _int8_bottleneck_infer as jax_int8_bottleneck,
)
from cunet_tpu.train.quant_step import quant_eval_params as jax_qep
from cunet_tpu_torch.kernels import quant_matmul, quant_ops
from cunet_tpu_torch.kernels.buf_ops import pack_w3
from cunet_tpu_torch.kernels.model_buf import marshal_slots
from cunet_tpu_torch.models import apply_cu_net
from cunet_tpu_torch.models.cu_net import (
    _int8_bottleneck_infer,
    eval_path,
    eval_slots,
    slot_args,
)
from cunet_tpu_torch.serving import Predictor

from torch_port_util import from_jax, images, np_weights, small_cfg

INT8 = QuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True,
                   int8_infer=True, int8_impl="pallas")
LAX = dataclasses.replace(INT8, int8_impl="lax")
S = 128.0
# whole-model tolerance: int8 products exact, float32 BN affines and the
# float intermedia adapters summed in another order
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.RandomState


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _vec(rng, k, lo=0.5, hi=1.5, shift=0.5):
    return np.stack([rng.uniform(lo, hi, k),
                     rng.randn(k) * shift]).astype(np.float32)


def _signs(rng, *shape):
    return rng.randint(-1, 2, shape).astype(np.int8)


def _interpret(monkeypatch):
    """JAX's int8 matmul in interpret mode, as tests/test_quant_matmul.py
    runs it on the CPU."""
    orig = jax_qm.int8_matmul_dequant
    monkeypatch.setattr(jax_qm, "int8_matmul_dequant",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


# ---------------------------------------------------------------------------
# the plain versions of the kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(64, 32, 16), (17, 24, 8), (96, 40, 24)])
def test_int8_matmul_dequant_matches_jax(m, k, n):
    rng = RNG(0)
    x = rng.randint(-127, 128, (m, k)).astype(np.int8)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    cs = rng.rand(n).astype(np.float32)
    want = jax_qm.int8_matmul_dequant(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(cs), 1 / S, interpret=True)
    quant_ops.reset_launch_counts()
    got = quant_matmul.int8_matmul_dequant(_t(x), _t(w), _t(cs), 1 / S)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not any(quant_ops.launch_counts().values())


def test_int_dot_is_exact_past_float32_depth():
    """K = 2100 full-range int8 products exceed float32's 2^24: the plain
    product splits K and adds in int32."""
    rng = RNG(1)
    a = rng.randint(-128, 128, (5, 2100)).astype(np.int8)
    b = rng.randint(-128, 128, (2100, 3)).astype(np.int8)
    want = a.astype(np.int64) @ b.astype(np.int64)
    got = quant_matmul.int_dot(_t(a), _t(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", (3, 6, 8))
def test_activation_and_weight_packing_match_jax(bits):
    rng = RNG(2)
    x = (rng.randn(300) * 0.7).astype(np.float32)
    x[:4] = [0.5 / 2 ** (bits - 1), -1.5, 2.0, 0.0]
    v, sc = quant_matmul.quantize_activations_i8(_t(x), bits)
    jv, jsc = jax_qm.quantize_activations_i8(jnp.asarray(x), bits)
    assert sc == jsc
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(
        quant_matmul.q8(_t(x), 2.0 ** (bits - 1)).numpy(),
        np.asarray(_q8(jnp.asarray(x), 2.0 ** (bits - 1))))
    w = (rng.randn(1, 1, 24, 8) * 0.2).astype(np.float32)
    signs, scale = quant_matmul.pack_binarized_weight(_t(w), bits)
    js, jscale = jax_qm.pack_binarized_weight(jnp.asarray(w), bits)
    np.testing.assert_array_equal(signs.numpy(), np.asarray(js))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


def test_binarized_matmul_infer_matches_jax():
    rng = RNG(3)
    x = (rng.randn(2, 4, 4, 32) * 0.5).astype(np.float32)
    w = (rng.randn(1, 1, 32, 16) * 0.2).astype(np.float32)
    want = jax_qm.binarized_matmul_infer(jnp.asarray(x), jnp.asarray(w),
                                         interpret=True)
    got = quant_matmul.binarized_matmul_infer(_t(x), _t(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_vec2", [False, True])
def test_affine_dot_i8_matches_jax_affine_dot_i8(with_vec2):
    """relu-affine -> q8 -> int8 product -> dequant, reading ``x[:, :K]``
    of a wider buffer and a padded weight; with ``vec2`` BN2 + ReLU + q8 of
    the float32 result (the int8 conv's input codes)."""
    rng = RNG(4)
    m, k, n = 2 * 6 * 6, 40, 24
    src = (rng.randn(m, 56) * 0.7).astype(np.float32)
    vec, w = _vec(rng, 48), _signs(rng, 48, n)
    vec2 = _vec(rng, n, 0.02, 0.1, 0.3)
    y = _affine_dot_i8(jnp.asarray(src[:, :k]), jnp.asarray(vec),
                       jnp.asarray(w), S)
    if with_vec2:
        want = _q8(jnp.maximum(y * vec2[0] + vec2[1], 0.0), S)
        out = torch.zeros(m, n, dtype=torch.int8)
        quant_ops.affine_dot_i8(_t(src)[:, :k], _t(vec), _t(w), out, s=S,
                                vec2=_t(vec2))
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        assert (out != 0).float().mean() > 0.2      # the codes are not all 0
    else:
        dst = rng.randn(m, n + 16).astype(np.float32)
        out = _t(dst.copy())
        quant_ops.affine_dot_i8(_t(src)[:, :k], _t(vec), _t(w),
                                out[:, 8:8 + n], s=S)
        np.testing.assert_array_equal(out[:, 8:8 + n].numpy(),
                                      np.asarray(y))
        keep = np.ones(n + 16, bool)
        keep[8:8 + n] = False
        np.testing.assert_array_equal(out.numpy()[:, keep], dst[:, keep])


def test_affine_dot_i8_writes_image_strided_head_slot():
    rng = RNG(5)
    b, hw, k, cls = 2, 16, 16, 4
    x = rng.randn(b * hw, k).astype(np.float32)
    vec, w = _vec(rng, k), _signs(rng, k, cls)
    out = torch.zeros(b, 3, 4, 4, cls)
    quant_ops.affine_dot_i8(_t(x), _t(vec), _t(w),
                            out[:, 1].view(b, hw, cls), s=S)
    want = _affine_dot_i8(jnp.asarray(x), jnp.asarray(vec), jnp.asarray(w), S)
    np.testing.assert_array_equal(out[:, 1].reshape(b * hw, cls).numpy(),
                                  np.asarray(want))
    assert not out[:, [0, 2]].any()


def _jax_scatter_conv(codes, w3, b, h, w):
    """The int8 3x3 conv of ``fused_model_buf.py`` (:316-329): one int8
    dot against the (Cb, 9G) scatter-packed weight, dequantized, then nine
    shifted f32 adds of G-wide tap slices."""
    g = w3.shape[3]
    t = jax.lax.dot_general(
        jnp.asarray(codes), jnp.round(pack_w3_scatter(jnp.asarray(w3))
                                      ).astype(jnp.int8),
        (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32,
    ).astype(jnp.float32) * (1.0 / S)
    tp = jnp.pad(t.reshape(b, h, w, 9 * g), ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = jnp.zeros((b, h, w, g), jnp.float32)
    for dy in range(3):
        for dx in range(3):
            d = dy * 3 + dx
            acc = acc + tp[:, dy:dy + h, dx:dx + w, d * g:(d + 1) * g]
    return np.asarray(acc.reshape(b * h * w, g))


@pytest.mark.parametrize("cb,g,r", [(16, 8, 8), (24, 8, 2), (16, 16, 4)])
def test_conv3x3_i8_matches_jax_scatter_conv(cb, g, r):
    rng = RNG(6)
    n = 3
    codes = rng.randint(0, 128, (n * r * r, cb)).astype(np.int8)
    w3 = rng.randint(-1, 2, (3, 3, cb, g)).astype(np.float32)
    want = _jax_scatter_conv(codes, w3, n, r, r)
    dst = rng.randn(n * r * r, g + 16).astype(np.float32)
    out = _t(dst.copy())
    quant_ops.conv3x3_i8(_t(codes), torch.round(pack_w3(_t(w3))).to(
        torch.int8), n, r, r, out[:, 8:8 + g], s=S)
    np.testing.assert_array_equal(out[:, 8:8 + g].numpy(), want)
    np.testing.assert_array_equal(out[:, :8].numpy(), dst[:, :8])


@pytest.mark.parametrize("impl", ["lax", "pallas"])
def test_int8_bottleneck_matches_jax(monkeypatch, impl):
    _interpret(monkeypatch)
    rng = RNG(7)
    cin, cout = 24, 16
    feats = [(rng.randn(2, 4, 4, 16) * 2).astype(np.float32),
             (rng.randn(2, 4, 4, 8) * 2).astype(np.float32)]
    conv = rng.choice([-1.0, 0.0, 1.0], (1, 1, cin, cout)).astype(np.float32)
    scale, bias = rng.rand(cin).astype(np.float32), (
        rng.randn(cin) * 0.1).astype(np.float32)
    mean, var = (rng.randn(cin) * 0.1).astype(np.float32), (
        rng.rand(cin) + 0.5).astype(np.float32)
    q = dataclasses.replace(INT8, int8_impl=impl)
    want = jax_int8_bottleneck(
        {"norm": {"scale": scale, "bias": bias}, "conv": conv},
        {"mean": mean, "var": var}, [jnp.asarray(f) for f in feats], q)
    params = {"u.norm.scale": _t(scale), "u.norm.bias": _t(bias),
              "u.conv": _t(conv)}
    state = {"u.norm.mean": _t(mean), "u.norm.var": _t(var)}
    got = _int8_bottleneck_infer(params, state, "u", [_t(f) for f in feats],
                                 q)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the whole quantized model
# ---------------------------------------------------------------------------


def _quantized(cfg):
    pn, sn = np_weights(cfg)
    qp = jax.tree_util.tree_map(np.asarray, jax_qep(pn, INT8))
    return qp, sn


@pytest.mark.parametrize("order", [1, 2])
def test_int8_model_paths_match_jax(order):
    """The port's whole-model int8 path and plain int8 path against JAX's
    lax int8 path (and, at order 1, JAX's whole-model int8 kernel in
    interpret mode); the plain path on ``int8_matmul_dequant``
    bit-identical to its lax form."""
    cfg = small_cfg(4, order, use_scan=False)
    whole = dataclasses.replace(cfg, use_pallas=True, pallas_whole_model=True)
    qp, sn = _quantized(cfg)
    x = images()
    want, _ = jax_apply_cu_net(qp, sn, x, cfg=cfg, train=False, quant=LAX)
    params, state = from_jax(qp, sn, cfg=cfg)
    xt = torch.from_numpy(x)
    quant_ops.reset_launch_counts()
    got_w, _ = apply_cu_net(params, state, xt, cfg=whole, quant=INT8)
    got_k, _ = apply_cu_net(params, state, xt, cfg=cfg, quant=INT8)
    got_l, _ = apply_cu_net(params, state, xt, cfg=cfg, quant=LAX)
    assert not any(quant_ops.launch_counts().values())
    assert len(got_w) == len(want) == len(cfg.anchors)
    for w_, k_, l_, j_ in zip(got_w, got_k, got_l, want):
        assert torch.equal(k_, l_)
        np.testing.assert_allclose(l_.numpy(), np.asarray(j_), **MODEL_TOL)
        np.testing.assert_allclose(w_.numpy(), np.asarray(j_), **MODEL_TOL)
    if order == 1:
        jw, _ = jax_apply_cu_net(qp, sn, x, cfg=whole, train=False,
                                 quant=INT8)
        for w_, j_ in zip(got_w, jw):
            np.testing.assert_allclose(w_.numpy(), np.asarray(j_),
                                       **MODEL_TOL)


@pytest.mark.parametrize("order", [1, 2])
def test_int8_whole_model_matches_jax_kernel_bf16(monkeypatch, order):
    """The served dtype: at bf16 the port's whole-model int8 path keeps
    ``yb`` and the BN2 / head inputs in float32 and rounds to bf16 where
    JAX's ``fused_model_buf_infer(quant_bits_i=8)`` does (interpret mode):
    bit-identical heatmaps."""
    import cunet_tpu.kernels.fused_model_buf as fmb

    orig = fmb.fused_model_buf_infer
    monkeypatch.setattr(fmb, "fused_model_buf_infer",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    cfg = small_cfg(4, order, use_scan=False, compute_dtype="bfloat16",
                    use_pallas=True, pallas_whole_model=True)
    qp, sn = _quantized(cfg)
    x = images()
    want, _ = jax_apply_cu_net(qp, sn, x, cfg=cfg, train=False, quant=INT8)
    params, state = from_jax(qp, sn, cfg=cfg)
    got, _ = apply_cu_net(params, state, torch.from_numpy(x), cfg=cfg,
                          quant=INT8)
    assert len(got) == len(want) == len(cfg.anchors)
    for g_, j_ in zip(got, want):
        assert g_.dtype == torch.bfloat16
        assert g_.float().abs().max() > 0
        np.testing.assert_array_equal(g_.float().numpy(),
                                      np.asarray(j_).astype(np.float32))


def test_int8_marshalling_and_dispatch():
    cfg = small_cfg(3, 1, use_pallas=True, pallas_whole_model=True)
    qp, sn = _quantized(cfg)
    params, state = from_jax(qp, sn, cfg=cfg)
    slots = eval_slots(params, state, cfg, INT8)
    blk = slots[1]["blocks"][0]
    for key in ("w_b", "w3", "w_a", "w_s"):
        assert blk[key].dtype == torch.int8
        assert set(blk[key].unique().tolist()) <= {-1, 0, 1}
    assert blk["vec2"].shape == (2, cfg.bottleneck_chan)
    assert "shift2" not in blk
    assert slots[1]["inter"][1].dtype == torch.float32
    assert slots[1]["head"][1].dtype == torch.int8
    # BN2's scale stays out of the int8 bottleneck weight
    sa = slot_args(params, state, cfg, fold=False)
    assert torch.equal(sa[0]["blocks"][0]["w_b"],
                       params["hg.down.0.layers.0.bottleneck.conv"])
    # the slots carry the quantizer scale that selects the int8 kernels
    assert all(sl["s"] == S for sl in slots)
    float_slots = marshal_slots(slot_args(params, state, cfg), cfg,
                                dtype=torch.float32)
    assert all(sl["s"] is None for sl in float_slots)
    assert float_slots[1]["blocks"][0]["w_b"].dtype == torch.float32
    assert eval_path(cfg, INT8) == eval_path(cfg) == "whole_model"
    assert eval_path(cfg, LAX) == "layers"
    assert eval_path(cfg, QuantConfig(enabled=True)) == "layers"
    # every other quant config with use_pallas runs layer by layer, its
    # float bottlenecks and adapter pairs on the per-bottleneck eval kernels
    # (#6), as JAX runs them (held against JAX in
    # tests/test_torch_port_eval_bottleneck.py)
    x = torch.zeros(1, 32, 32, 3)
    for q in (LAX, QuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True),
              INT8):
        c = cfg if q is not INT8 else dataclasses.replace(
            cfg, pallas_whole_model=False)
        assert eval_path(c, q) == "layers"
        outs, _ = apply_cu_net(params, state, x, cfg=c, quant=q)
        assert [tuple(o.shape) for o in outs] == [(1, 8, 8, 4)] * 3
        assert all(torch.isfinite(o).all() for o in outs)


def test_int8_predictor_serves_the_quantized_model():
    cfg = small_cfg(3, 1, use_pallas=True, pallas_whole_model=True)
    qp, sn = _quantized(cfg)
    params, state = from_jax(qp, sn, cfg=cfg)
    imgs = images(3)
    pred = Predictor(cfg, params, state, device="cpu", batch_size=2,
                     quant=INT8)
    assert pred._slots[0]["blocks"][0]["w_b"].dtype == torch.int8
    hm = pred.heatmaps(imgs)
    want, _ = apply_cu_net(params, state, torch.from_numpy(imgs), cfg=cfg,
                           quant=INT8)
    assert hm.shape == (3, 8, 8, cfg.class_num)
    np.testing.assert_allclose(hm, want[-1].numpy(), rtol=1e-6, atol=1e-6)
    assert pred.predict(imgs).shape == (3, cfg.class_num, 2)
