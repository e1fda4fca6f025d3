"""Torch port: WAGE quantization against the JAX package on the CPU.

- ``cunet_tpu_torch.quant.wage`` values against ``cunet_tpu.quant.wage`` at
  bits 1, 2, 4 and 8 (exact), and its three custom gradients against
  ``jax.grad`` / ``jax.vjp`` (exact, or 1e-6 where a per-filter mean is
  summed in another order);
- the selection predicate picks the same convs for every policy;
- ``preprocess_masters`` / ``quantize_params`` / ``quant_eval_params``
  against JAX's (exact up to rounding flips from the mean's summation
  order, counted and bounded by 1e-4 of the elements);
- quantized eval of the whole model (float simulation, ``int8_infer``
  off) against JAX's ``apply_cu_net(train=False, quant=q)``: the port used
  to ignore ``quant`` in eval and run the float model;
- ``quant_eval_step`` against JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cunet_tpu.config import QuantConfig
from cunet_tpu.models import apply_cu_net as jax_apply_cu_net
from cunet_tpu.quant import transforms as jax_transforms
from cunet_tpu.quant import wage as jax_wage
from cunet_tpu.train.quant_step import quant_eval_params as jax_qep
from cunet_tpu.train.quant_step import quant_eval_step as jax_quant_eval_step
from cunet_tpu_torch.models import apply_cu_net, init_cu_net
from cunet_tpu_torch.quant import transforms, wage
from cunet_tpu_torch.train.quant_step import (
    quant_eval_params,
    quant_eval_step,
)

from torch_port_util import from_jax, images, np_weights, small_cfg

BITS = (1, 2, 4, 8)
SIM = QuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True)
# float-simulation model tolerance: the same float ops in both packages
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _x(seed=0, shape=(3, 3, 6, 4), scale=0.8):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def assert_flips_bounded(got, want, frac=1e-4):
    """Exact, but for rounding flips a differently ordered float sum can
    cause: at most ``frac`` of the elements differ."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert (got != want).sum() <= frac * got.size, (got != want).sum()


# ---------------------------------------------------------------------------
# wage values
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", BITS + (16,))
def test_elementwise_quantizers_match_jax_exactly(bits):
    x = _x(0, (1000,), 1.2)
    x[:6] = [-1.5, -0.5, 0.5, 1.5, 0.0, 2.5 / 8]     # halves and zero
    for name in ("clip_c", "quant_q"):
        got = getattr(wage, name)(_t(x), bits).numpy()
        want = np.asarray(getattr(jax_wage, name)(jnp.asarray(x), bits))
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(
        wage.quan_input(_t(x), bits).numpy(),
        np.asarray(jax_wage.quan_input(jnp.asarray(x), bits)))


@pytest.mark.parametrize("bits", BITS)
def test_weight_quantizers_match_jax_exactly(bits):
    w = _x(1, (3, 3, 6, 4), 0.3)
    w[..., 3] *= 1e-3                  # a filter whose scale rounds to 0
    jw, tw = jnp.asarray(w), _t(w)
    cases = [("binarize_weight_value", (bits,)),
             ("binarize_weight_value_ref", (bits,)),
             ("ternarize_weight_value", ())]
    if bits > 2:
        cases.append(("fixedpoint_weight_value", (bits,)))
    for name, args in cases:
        assert_flips_bounded(getattr(wage, name)(tw, *args).numpy(),
                             getattr(jax_wage, name)(jw, *args))
    assert_flips_bounded(wage.meancenter_clamp_weight(tw, bits).numpy(),
                         jax_wage.meancenter_clamp_weight(jw, bits))
    assert_flips_bounded(wage.fake_quant_weight(tw, bits, 8).detach().numpy(),
                         jax_wage.fake_quant_weight(jw, bits, 8))


def test_unrounded_weight_values_match_jax():
    """binarize_weight and the BinOp master preprocessing keep a per-filter
    mean unrounded: float32 means summed in another order (1e-6)."""
    w = _x(2, (3, 3, 6, 4), 0.7)
    np.testing.assert_allclose(
        wage.binarize_weight(_t(w), 8).detach().numpy(),
        np.asarray(jax_wage.binarize_weight(jnp.asarray(w), 8)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        wage.meancenter_clamp_weight_bin(_t(w)).numpy(),
        np.asarray(jax_wage.meancenter_clamp_weight_bin(jnp.asarray(w))),
        rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the three custom gradients
# ---------------------------------------------------------------------------


def _torch_vjp(fn, x, g):
    t = _t(x).requires_grad_(True)
    fn(t).backward(_t(g))
    return t.grad.numpy()


@pytest.mark.parametrize("bits", (4, 8, 16))
def test_quan_input_gradient_matches_jax(bits):
    x = _x(3, (500,), 1.0)
    x[:4] = [-1.0, 1.0, -0.999, 0.999]
    g = _x(4, (500,), 1.0)
    want = jax.vjp(lambda v: jax_wage.quan_input(v, bits), jnp.asarray(x))[1](
        jnp.asarray(g))[0]
    np.testing.assert_array_equal(
        _torch_vjp(lambda v: wage.quan_input(v, bits), x, g),
        np.asarray(want))


@pytest.mark.parametrize("bits_w", (1, 2, 4, 16))
def test_fake_quant_weight_gradient_matches_jax(bits_w):
    w, g = _x(5, (3, 3, 6, 4), 0.7), _x(6, (3, 3, 6, 4), 1.0)
    w[0, 0, 0, 0] = 1.3                 # outside [-1, 1]: masked m
    want = jax.vjp(lambda v: jax_wage.fake_quant_weight(v, bits_w, 8),
                   jnp.asarray(w))[1](jnp.asarray(g))[0]
    got = _torch_vjp(lambda v: wage.fake_quant_weight(v, bits_w, 8), w, g)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)


def test_binarize_weight_gradient_matches_jax():
    """Unquantized XNOR gradient: two float32 per-filter means summed in
    another order, then scaled by n * (1 - 1/c_in) = 45 where the two
    terms cancel, so the bound is 1e-6 of the largest gradient."""
    w, g = _x(7, (3, 3, 6, 4), 0.7), _x(8, (3, 3, 6, 4), 1.0)
    want = np.asarray(jax.vjp(lambda v: jax_wage.binarize_weight(v, 8),
                              jnp.asarray(w))[1](jnp.asarray(g))[0])
    got = _torch_vjp(lambda v: wage.binarize_weight(v, 8), w, g)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


# ---------------------------------------------------------------------------
# model-level transforms
# ---------------------------------------------------------------------------


def _jax_key(path) -> str:
    return jax_transforms._path_str(path).replace("/", ".")


@pytest.mark.parametrize("policy", transforms.POLICIES)
@pytest.mark.parametrize("order", (1, 2))
def test_predicate_selects_the_jax_leaves(policy, order):
    cfg = small_cfg(4, order)
    pn, sn = np_weights(cfg)
    jpred = jax_transforms.selected_conv_predicate(pn, policy)
    want = {_jax_key(p) for p, leaf in
            jax.tree_util.tree_flatten_with_path(pn)[0]
            if np.ndim(leaf) == 4 and jpred(p)}
    params, _ = from_jax(pn, sn, cfg=cfg)
    pred = transforms.selected_conv_predicate(params, policy)
    assert {k for k in params if params[k].dim() == 4 and pred(k)} == want
    assert "stem.conv" not in want
    if policy == "reference":
        assert "intermedia.adapters.2.conv" not in want
        assert "heads.3.conv" in want


def test_predicate_rejects_unknown_policy():
    with pytest.raises(ValueError):
        transforms.selected_conv_predicate({}, "none")


@pytest.mark.parametrize("qcfg", [
    SIM,
    QuantConfig(bits_w=4, bits_i=8, bits_g=8, enabled=True),
    QuantConfig(bits_w=1, bits_i=8, bits_g=32, enabled=True),   # BinOp
], ids=["w1", "w4", "binop"])
def test_transforms_match_jax(qcfg):
    cfg = small_cfg(3, 1)
    pn, sn = np_weights(cfg)
    params, _ = from_jax(pn, sn, cfg=cfg)
    pred = transforms.selected_conv_predicate(params)
    jpred = jax_transforms.selected_conv_predicate(pn)
    masters = transforms.preprocess_masters(params, qcfg, pred)
    jmasters = jax_transforms.preprocess_masters(pn, qcfg, jpred)
    got = quant_eval_params(params, qcfg)
    want = from_jax(jax.tree_util.tree_map(np.asarray, jax_qep(pn, qcfg)),
                    sn, cfg=cfg)[0]
    jm = from_jax(jax.tree_util.tree_map(np.asarray, jmasters), sn,
                  cfg=cfg)[0]
    tol = dict(rtol=1e-6, atol=1e-6)
    for k in params:
        if qcfg.bits_g > 15:        # BinOp: unrounded means
            np.testing.assert_allclose(masters[k].numpy(), jm[k].numpy(),
                                       **tol)
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       want[k].numpy(), **tol)
        else:
            assert_flips_bounded(masters[k].numpy(), jm[k].numpy())
            assert_flips_bounded(got[k].detach().numpy(), want[k].numpy())
    assert torch.equal(got["stem.conv"], params["stem.conv"])


def test_quantize_params_gradient_matches_jax():
    """The fake-quantized weights are differentiable in the masters through
    the XNOR jacobian, as in JAX (a value-only port would hand back zero
    gradients through ``sign``)."""
    cfg = small_cfg(2, 1)
    pn, sn = np_weights(cfg)
    params, _ = from_jax(pn, sn, cfg=cfg)
    pred = transforms.selected_conv_predicate(params)
    masters = {k: v.requires_grad_(True) for k, v in
               transforms.preprocess_masters(params, SIM, pred).items()}
    key = "hg.neck.layers.1.conv2"
    q = transforms.quantize_params(masters, SIM, pred)[key]
    assert set(q.unique().tolist()) <= {-1.0, 0.0, 1.0}
    g = _x(9, tuple(q.shape), 1.0)
    q.backward(_t(g))
    want = jax.vjp(lambda v: jax_wage.fake_quant_weight(v, 1, 8),
                   jnp.asarray(masters[key].detach().numpy()))[1](
        jnp.asarray(g))[0]
    assert masters[key].grad.abs().sum() > 0
    np.testing.assert_allclose(masters[key].grad.numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# quantized eval of the whole model (the repaired fault)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sim_model():
    """JAX quant_eval_params weights (numpy trees), the config and input."""
    cfg = small_cfg(4, 1, use_scan=False)
    pn, sn = np_weights(cfg)
    qp = jax.tree_util.tree_map(np.asarray, jax_qep(pn, SIM))
    return cfg, qp, sn, images()


def test_quant_eval_matches_jax_float_simulation(sim_model):
    """Eval with an enabled QuantConfig runs the quantized model (the
    activation quantizer before every 3x3 conv and head), as JAX does; the
    port once ignored ``quant`` in eval and ran the float model."""
    cfg, qp, sn, x = sim_model
    want, _ = jax_apply_cu_net(qp, sn, x, cfg=cfg, train=False, quant=SIM)
    params, state = from_jax(qp, sn, cfg=cfg)
    got, _ = apply_cu_net(params, state, torch.from_numpy(x), cfg=cfg,
                          quant=SIM)
    assert len(got) == len(want) == len(cfg.anchors)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODEL_TOL)
    # the float model on the same weights is another model entirely
    flt, _ = apply_cu_net(params, state, torch.from_numpy(x), cfg=cfg)
    assert not np.allclose(flt[-1].numpy(), np.asarray(want[-1]), rtol=0.1)
    # with use_pallas JAX runs the float simulation's bottlenecks on its
    # per-bottleneck eval kernel (#6); so does the port (its plain version
    # on the CPU), to the same numbers
    pcfg = dataclasses.replace(cfg, use_pallas=True, pallas_whole_model=True)
    want_k, _ = jax_apply_cu_net(qp, sn, x, cfg=pcfg, train=False,
                                 quant=SIM)
    got_k, _ = apply_cu_net(params, state, torch.from_numpy(x), cfg=pcfg,
                            quant=SIM)
    for g, w in zip(got_k, want_k):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODEL_TOL)


def test_quant_eval_step_matches_jax(sim_model):
    cfg, qp, sn, x = sim_model
    t = np.random.RandomState(3).rand(2, 8, 8, cfg.class_num).astype(
        np.float32)
    want = jax_quant_eval_step(qp, sn, {"image": x, "heatmap": t}, cfg=cfg,
                               qcfg=SIM)
    params, state = from_jax(qp, sn, cfg=cfg)
    got = quant_eval_step(params, state, {"image": torch.from_numpy(x),
                                          "heatmap": torch.from_numpy(t)},
                          cfg=cfg, qcfg=SIM)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got["last_out"].numpy(),
                               np.asarray(want["last_out"]), **MODEL_TOL)


def test_disabled_quant_config_is_the_float_model():
    cfg = small_cfg(2, 1)
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    x = torch.from_numpy(images())
    a, _ = apply_cu_net(params, state, x, cfg=cfg)
    b, _ = apply_cu_net(params, state, x, cfg=cfg,
                        quant=QuantConfig(enabled=False))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
