"""Torch port, quantized (WAGE W1/I8/G8) training on the CPU against the JAX
package.

- ``quant_train_step`` (plain path and kernel path) against JAX's
  ``quant_train_step`` on the lax path: loss rtol 1e-4, last output and BN
  state 5e-4; the master grads (taken by JAX through ``quantize_params`` of
  the preprocessed masters) within tests/test_train_slot.py's one-step /
  0.5 % budget: the grads are quantized to bits_g, so a float32 sum in
  another order may move an element on a rounding boundary by one step;
  the new params where the grads agree;
- the kernel path (``use_pallas=True, bn_tile=2``, QuanInput in the slot
  train orchestration) against JAX's fused slot kernels with bits_i=8 in
  interpret mode, under the same budget;
- quantization with dropout on the kernel path learns: finite, falling
  loss over a few steps (tests/test_train_slot.py::test_quant_plus_dropout;
  grads of that combination are not reproducible even inside JAX).

Weights, images and targets are those of tests/test_train_slot.py's quant
parity (the JAX package's init from key 0, normal images, uniform
targets), not ``torch_port_util.np_weights``: with order-one activations
through every slot the quantized model is chaotic even in float32 (one
quantizer midpoint flip moves a value by 1/128 and spreads; JAX's own
fused and lax paths then differ on ~78 % of the grad elements), while at
this init JAX's two paths differ on one element and the budget means
something. A kernel path without QuanInput, or without its gate, misses
it on ~80 % of the elements.

Small widths (c=16, g=8, Cb=16, 4 classes, 2 blocks), 32x32 images, batch
4, ghost-BN tile 2, float32.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from cunet_tpu.config import QuantConfig as JaxQuantConfig
from cunet_tpu.config import TrainConfig as JaxTrainConfig
from cunet_tpu.models import apply_cu_net as jax_apply_cu_net
from cunet_tpu.models import init_cu_net as jax_init_cu_net
from cunet_tpu.quant import preprocess_masters as jax_preprocess
from cunet_tpu.quant import quantize_params as jax_quantize
from cunet_tpu.quant import selected_conv_predicate as jax_pred
from cunet_tpu.train import create_train_state as jax_create_state
from cunet_tpu.train import make_optimizer as jax_make_optimizer
from cunet_tpu.train.loss import intermediate_mse as jax_mse
from cunet_tpu.train.quant_step import quant_train_step as jax_qstep
from cunet_tpu_torch.config import QuantConfig, TrainConfig
from cunet_tpu_torch.kernels import buf_ops, drop_ops, train_ops
from cunet_tpu_torch.quant import (
    preprocess_masters,
    quantize_params,
    selected_conv_predicate,
)
from cunet_tpu_torch.tools.from_jax import flatten_tree
from cunet_tpu_torch.train import create_train_state, quant_train_step

from torch_port_util import from_jax, port_cfg, small_cfg

FWD = dict(rtol=5e-4, atol=5e-4)
LOSS_RTOL = 1e-4
N, SIZE, LR = 4, 32, 1e-3
QCFG = JaxQuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True)
PORT_QCFG = QuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True)
STEP = 1.0 / 2.0 ** (QCFG.bits_g - 1)     # one bits_g quantization step


def _cfg(layer_num, **kw):
    return small_cfg(layer_num, 1, bn_tile=2, bn_dtype="compute",
                     remat="none", use_scan=False, **kw)


def _flat_np(tree):
    return flatten_tree(jax.tree_util.tree_map(np.asarray, tree))


def assert_grads_within_budget(got, want):
    """Elementwise 3e-3 except on at most 0.5 % of each leaf's elements,
    which may differ by one bits_g step."""
    assert set(got) == set(want)
    for k, b in want.items():
        diff = np.abs(np.asarray(got[k], np.float64) - b)
        bad = diff > 3e-3 + 3e-3 * np.abs(b)
        assert bad.mean() <= 0.005, (k, bad.mean())
        assert (diff[bad] < STEP * 1.001).all(), (k, diff.max())


@functools.lru_cache(maxsize=None)
def jax_quant_reference(use_pallas):
    """JAX master grads, loss and outputs through ``quantize_params`` of
    the preprocessed masters (lax path, or the fused kernels in interpret
    mode), and, on the lax path, one ``quant_train_step``."""
    cfg = _cfg(3, use_pallas=use_pallas)
    pn, sn = jax.tree_util.tree_map(
        np.asarray, jax_init_cu_net(jax.random.PRNGKey(0), cfg))
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (N, SIZE, SIZE, 3)))
    t = np.array(jax.random.uniform(jax.random.PRNGKey(2),
                                    (N, SIZE // 4, SIZE // 4, cfg.class_num)))
    pred = jax_pred(pn, "reference")
    masters = jax_preprocess(pn, QCFG, pred)

    def loss(m):
        outs, ns = jax_apply_cu_net(jax_quantize(m, QCFG, pred), sn, x,
                                    cfg=cfg, train=True, quant=QCFG)
        return jax_mse(outs, t), (outs, ns)

    (l, (outs, ns)), g = jax.value_and_grad(loss, has_aux=True)(masters)
    ref = dict(cfg=cfg, pn=pn, sn=sn, x=x, t=t, loss=float(l),
               outs=[np.asarray(o) for o in outs], state=_flat_np(ns),
               grads=_flat_np(g))
    if not use_pallas:
        tx = jax_make_optimizer(JaxTrainConfig(lr=LR))
        st, m = jax_qstep(jax_create_state(pn, sn, tx),
                          {"image": x, "heatmap": t}, cfg=cfg, qcfg=QCFG,
                          tx=tx)
        ref.update(step_loss=float(m["loss"]),
                   last_out=np.asarray(m["last_out"]),
                   step_state=_flat_np(st.bn_state),
                   new_params=_flat_np(st.params))
    return ref


@functools.lru_cache(maxsize=None)
def port_quant_step(path):
    ref = jax_quant_reference(False)
    cfg = port_cfg(dataclasses.replace(ref["cfg"],
                                       use_pallas=path == "kernel"))
    st = create_train_state(*from_jax(ref["pn"], ref["sn"], ref["cfg"]),
                            TrainConfig(lr=LR))
    st, m = quant_train_step(st, {"image": torch.from_numpy(ref["x"]),
                                  "heatmap": torch.from_numpy(ref["t"])},
                             cfg=cfg, qcfg=PORT_QCFG)
    return ref, st, m


PATHS = ["plain", "kernel"]


@pytest.mark.parametrize("path", PATHS)
def test_quant_train_step_loss_output_state_match_jax(path):
    ref, st, m = port_quant_step(path)
    assert st.step == 1
    np.testing.assert_allclose(float(m["loss"]), ref["step_loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["last_out"].numpy(), ref["last_out"], **FWD)
    for k, want in ref["step_state"].items():
        np.testing.assert_allclose(st.bn_state[k].numpy(), want, err_msg=k,
                                   **FWD)


@pytest.mark.parametrize("path", PATHS)
def test_quant_train_step_master_grads_match_jax(path):
    ref, st, _ = port_quant_step(path)
    assert_grads_within_budget(
        {k: v.grad.numpy() for k, v in st.params.items()}, ref["grads"])


@pytest.mark.parametrize("path", PATHS)
def test_quant_train_step_new_params_match_jax(path):
    """The preprocessed masters after one RMSprop step. The first step
    moves an element by about 10 * lr * sign(g); where the port's and JAX's
    grads differ (a one-step flip) or sit within float32 noise of zero the
    sign may differ, so those elements are held only to 10 * lr + 1e-6."""
    ref, st, _ = port_quant_step(path)
    for k, want in ref["new_params"].items():
        got = st.params[k].detach().numpy()
        g, gj = st.params[k].grad.numpy(), ref["grads"][k]
        sure = (np.abs(g - gj) <= 3e-3 + 3e-3 * np.abs(gj)) & (
            np.abs(gj) > 1e-2 * np.abs(gj).max() + 1e-6)
        np.testing.assert_allclose(got[sure], want[sure], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_array_less(np.abs(got - want), 10 * LR * 1.01 +
                                     1e-6)


def test_quant_train_step_writes_masters_in_place():
    """The selected weights become their preprocessed values in the tensors
    the optimizer holds (RMSprop keys its state by tensor)."""
    ref, st, _ = port_quant_step("plain")
    params, _ = from_jax(ref["pn"], ref["sn"], ref["cfg"])
    pred = selected_conv_predicate(params, "reference")
    masters = preprocess_masters(params, PORT_QCFG, pred)
    held = {id(p) for g in st.opt.param_groups for p in g["params"]}
    assert all(id(v) in held for v in st.params.values())
    moved = [k for k in params if masters[k] is not params[k]]
    assert moved and "stem.conv" not in moved
    for k in moved:      # one step from the preprocessed master
        assert np.abs(st.params[k].detach().numpy()
                      - masters[k].numpy()).max() <= 10 * LR * 1.01 + 1e-6


def test_quant_kernel_path_matches_jax_fused_forward():
    """The port's kernel path against JAX's fused slot kernels (interpret
    mode), each with QuanInput at bits_i=8, on ``quantize_params`` of the
    same preprocessed masters: loss, last output and BN state."""
    ref = jax_quant_reference(True)
    _, st, m = port_quant_step("kernel")
    np.testing.assert_allclose(float(m["loss"]), ref["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["last_out"].numpy(), ref["outs"][-1], **FWD)
    for k, want in ref["state"].items():
        np.testing.assert_allclose(st.bn_state[k].numpy(), want, err_msg=k,
                                   **FWD)


def test_quant_kernel_path_matches_jax_fused_grads():
    _, st, _ = port_quant_step("kernel")
    assert_grads_within_budget(
        {k: v.grad.numpy() for k, v in st.params.items()},
        jax_quant_reference(True)["grads"])


def test_quant_with_dropout_learns_on_the_kernel_path():
    """W1/I8/G8 with dropout 0.25 through the slot train orchestration:
    four quant_train_steps from one generator, finite and falling loss;
    no kernel launches on the CPU."""
    ref = jax_quant_reference(False)
    cfg = port_cfg(dataclasses.replace(ref["cfg"], use_pallas=True,
                                       drop_rate=0.25))
    st = create_train_state(*from_jax(ref["pn"], ref["sn"], ref["cfg"]),
                            TrainConfig(lr=5e-3))
    batch = {"image": torch.from_numpy(ref["x"]),
             "heatmap": torch.from_numpy(ref["t"])}
    gen = torch.Generator().manual_seed(9)
    for ops in (buf_ops, train_ops, drop_ops):
        ops.reset_launch_counts()
    losses = [float(quant_train_step(st, batch, cfg=cfg, qcfg=PORT_QCFG,
                                     generator=gen)[1]["loss"])
              for _ in range(4)]
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], losses
    for ops in (buf_ops, train_ops, drop_ops):
        assert not any(ops.launch_counts().values())


def test_quant_kernel_bits():
    from cunet_tpu.models.cu_net import quant_kernel_bits as jax_bits
    from cunet_tpu_torch.models.cu_net import quant_kernel_bits

    for q, jq in ((None, None), (PORT_QCFG, QCFG),
                  (dataclasses.replace(PORT_QCFG, enabled=False),
                   dataclasses.replace(QCFG, enabled=False)),
                  (dataclasses.replace(PORT_QCFG, bits_i=16),
                   dataclasses.replace(QCFG, bits_i=16))):
        assert quant_kernel_bits(q) == jax_bits(jq)
