"""Torch port, dropout training with JAX's threefry masks
(``drop_impl="masks"``) on the CPU against the JAX package.

Both packages are handed the same threefry key: JAX as its ``rng``, the
port as ``apply_cu_net(..., drop_key=)`` or ``train_step(..., rng=)``, so
both draw the same masks (``tests/test_torch_port_threefry.py`` holds the
masks themselves bit for bit). Held against JAX's lax path: the port's
plain path and its kernel path (the slot train orchestration at ghost-BN
tile 2, and the per-bottleneck path at ``bn_tile=0``, on the mask
kernel's plain version). Tolerances of ``test_torch_port_dropout_train``:
loss rtol 1e-4, outputs and BN state 5e-4, grads 3e-3.

Small widths (c=16, g=8, Cb=16, 4 classes, 2 blocks), 32x32 images, batch
4, float32, drop rate 0.25. JAX's references run under ``jax.jit``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
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
from cunet_tpu.train.step import train_step as jax_train_step
from cunet_tpu_torch.config import QuantConfig, TrainConfig
from cunet_tpu_torch.kernels import drop_ops
from cunet_tpu_torch.models import apply_cu_net
from cunet_tpu_torch.quant import (
    preprocess_masters,
    quantize_params,
    selected_conv_predicate,
)
from cunet_tpu_torch.tools.from_jax import flatten_tree
from cunet_tpu_torch.train import create_train_state, intermediate_mse
from cunet_tpu_torch.train import train_step

from torch_port_util import from_jax, images, np_weights, port_cfg, small_cfg

FWD = dict(rtol=5e-4, atol=5e-4)
GRAD = dict(rtol=3e-3, atol=3e-3)
LOSS_RTOL = 1e-4
N, SIZE, RATE = 4, 32, 0.25
KEY = jax.random.PRNGKey(7)
# a learning rate at which the second step's loss stays within LOSS_RTOL of
# JAX's: RMSprop's first step moves every weight by ~10 lr, so a gradient
# within the float32 noise of zero that takes the other sign here moves its
# weight 20 lr away from JAX's
STEP_LR = 1e-6


def _cfg(layer_num, bn_tile, **kw):
    return small_cfg(layer_num, 1, bn_tile=bn_tile, bn_dtype="compute",
                     remat="none", use_scan=False, drop_rate=RATE,
                     drop_impl="masks", **kw)


def _targets(cfg, seed=3):
    return np.random.RandomState(seed).rand(
        N, SIZE // 4, SIZE // 4, cfg.class_num).astype(np.float32)


def _flat_np(tree):
    return flatten_tree(jax.tree_util.tree_map(np.asarray, tree))


@functools.lru_cache(maxsize=None)
def jax_reference(bn_tile):
    """JAX's lax path under the threefry masks of KEY: loss, outputs, new
    bn_state and grads, with their inputs (3 slots, a steady state from
    slot 1)."""
    cfg = _cfg(3, bn_tile)
    x, t = images(N, SIZE), _targets(cfg)
    pn, sn = np_weights(cfg)

    @jax.jit
    def grads(p):
        def loss(p):
            outs, ns = jax_apply_cu_net(p, sn, x, cfg=cfg, train=True,
                                        rng=KEY)
            return jax_mse(outs, t), (outs, ns)
        return jax.value_and_grad(loss, has_aux=True)(p)

    (l, (outs, ns)), g = grads(pn)
    return dict(cfg=cfg, pn=pn, sn=sn, x=x, t=t, loss=float(l),
                outs=[np.asarray(o) for o in outs], state=_flat_np(ns),
                grads=_flat_np(g))


@functools.lru_cache(maxsize=None)
def port_run(bn_tile, path):
    ref = jax_reference(bn_tile)
    cfg = port_cfg(dataclasses.replace(ref["cfg"],
                                       use_pallas=path == "kernel"))
    params, state = from_jax(ref["pn"], ref["sn"], ref["cfg"])
    for v in params.values():
        v.requires_grad_(True)
    outs, new_state = apply_cu_net(
        params, state, torch.from_numpy(ref["x"]), cfg=cfg, train=True,
        drop_key=np.asarray(KEY))
    loss = intermediate_mse(outs, torch.from_numpy(ref["t"]))
    loss.backward()
    return dict(loss=loss.item(), outs=[o.detach().numpy() for o in outs],
                state={k: v.numpy() for k, v in new_state.items()},
                grads={k: v.grad.numpy() for k, v in params.items()})


# (bn_tile, port path): ghost-BN tile 2 (the kernel path is the slot train
# orchestration) and whole-batch BN (the per-bottleneck path)
CASES = [(2, "plain"), (2, "kernel"), (0, "plain"), (0, "kernel")]


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"tile{c[0]}-{c[1]}")
def case(request):
    return jax_reference(request.param[0]), port_run(*request.param)


def test_masks_outputs_and_loss_match_jax(case):
    ref, got = case
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
    assert len(got["outs"]) == len(ref["outs"])
    for a, b in zip(got["outs"], ref["outs"]):
        np.testing.assert_allclose(a, b, **FWD)


def test_masks_bn_state_matches_jax(case):
    ref, got = case
    assert set(got["state"]) == set(ref["state"])
    for k, want in ref["state"].items():
        np.testing.assert_allclose(got["state"][k], want, err_msg=k, **FWD)


def test_masks_grads_match_jax(case):
    ref, got = case
    assert set(got["grads"]) == set(ref["grads"])
    for k, want in ref["grads"].items():
        np.testing.assert_allclose(got["grads"][k], want, err_msg=k, **GRAD)


def test_masks_differ_from_the_seed_form_and_from_no_dropout():
    """The threefry masks are not all ones, and not the seed form's."""
    ref = jax_reference(2)
    got = port_run(2, "kernel")
    cfg = port_cfg(dataclasses.replace(ref["cfg"], use_pallas=True))
    params, state = from_jax(ref["pn"], ref["sn"], ref["cfg"])
    with torch.no_grad():
        x = torch.from_numpy(ref["x"])
        seed_form, _ = apply_cu_net(
            params, state, x, train=True, drop_seeds=[1, 2, 3],
            cfg=dataclasses.replace(cfg, drop_impl="prng"))
        undropped, _ = apply_cu_net(
            params, state, x, train=True,
            cfg=dataclasses.replace(cfg, drop_rate=0.0))
    for other in (seed_form, undropped):
        assert not np.allclose(got["outs"][-1], other[-1].numpy(), atol=1e-3)


@functools.lru_cache(maxsize=None)
def jax_two_steps():
    """Two jitted JAX train_steps on the lax path, each folding its step
    into KEY: (losses, last outputs, final bn_state), with the inputs."""
    cfg = _cfg(2, 2)
    x, t = images(N, SIZE), _targets(cfg)
    pn, sn = np_weights(cfg)
    tx = jax_make_optimizer(JaxTrainConfig(lr=STEP_LR))
    st = jax_create_state(pn, sn, tx)
    step = jax.jit(functools.partial(jax_train_step, cfg=cfg, tx=tx))
    losses, lasts = [], []
    for _ in range(2):
        st, m = step(st, {"image": x, "heatmap": t}, rng=KEY)
        losses.append(float(m["loss"]))
        lasts.append(np.asarray(m["last_out"]))
    return dict(cfg=cfg, pn=pn, sn=sn, x=x, t=t, losses=losses, lasts=lasts,
                state=_flat_np(st.bn_state))


@pytest.mark.parametrize("path", ["plain", "kernel"])
def test_two_train_steps_fold_the_step_into_rng(path):
    """Two port train_steps from ``rng=KEY`` against JAX's: the second step
    draws the masks of fold_in(KEY, 1) on both sides (its loss differs from
    the same step's under step 0's masks). No kernel launches on the
    CPU."""
    ref = jax_two_steps()
    cfg = port_cfg(dataclasses.replace(ref["cfg"],
                                       use_pallas=path == "kernel"))
    st = create_train_state(*from_jax(ref["pn"], ref["sn"], ref["cfg"]),
                            TrainConfig(lr=STEP_LR))
    batch = {"image": torch.from_numpy(ref["x"]),
             "heatmap": torch.from_numpy(ref["t"])}
    drop_ops.reset_launch_counts()
    for want_loss, want_last in zip(ref["losses"], ref["lasts"]):
        _, m = train_step(st, batch, cfg=cfg, rng=np.asarray(KEY))
        np.testing.assert_allclose(float(m["loss"]), want_loss,
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(m["last_out"].numpy(), want_last, **FWD)
    assert st.step == 2
    for k, want in ref["state"].items():
        np.testing.assert_allclose(st.bn_state[k].numpy(), want, err_msg=k,
                                   **FWD)
    assert not any(drop_ops.launch_counts().values())
    st.step = 0                        # step 1's weights under step 0's key
    _, m = train_step(st, batch, cfg=cfg, rng=np.asarray(KEY))
    assert abs(float(m["loss"]) - ref["losses"][1]) > 1e-3 * ref["losses"][1]


@functools.lru_cache(maxsize=None)
def jax_quant_forward():
    """JAX's W1/I8/G8 forward with masks on the lax path, at
    ``tests/test_train_slot.py``'s pinned config (its init, inputs and
    key 9): loss and outputs through ``quantize_params`` of the
    preprocessed masters."""
    cfg = _cfg(3, 2)
    qcfg = JaxQuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True)
    pn, sn = jax.tree_util.tree_map(
        np.asarray, jax_init_cu_net(jax.random.PRNGKey(0), cfg))
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (N, SIZE, SIZE,
                                                           3)))
    t = np.array(jax.random.uniform(jax.random.PRNGKey(2),
                                    (N, SIZE // 4, SIZE // 4, 4)))
    pred = jax_pred(pn, "reference")
    masters = jax_preprocess(pn, qcfg, pred)

    @jax.jit
    def fwd(m):
        outs, _ = jax_apply_cu_net(jax_quantize(m, qcfg, pred), sn, x,
                                   cfg=cfg, train=True, quant=qcfg,
                                   rng=jax.random.PRNGKey(9))
        return sum(jnp.mean((o - t) ** 2) for o in outs), outs

    loss, outs = fwd(masters)
    return dict(cfg=cfg, pn=pn, sn=sn, x=x, t=t, loss=float(loss),
                outs=[np.asarray(o) for o in outs])


@pytest.mark.parametrize("path", ["plain", "kernel"])
def test_quant_forward_with_masks_matches_jax(path):
    """W1/I8/G8 with the threefry masks, forward: the JAX package pins its
    fused kernels to its lax path at this config (no quantizer midpoint
    flips under these masks); the port's paths are held to the lax path at
    the same tolerances."""
    ref = jax_quant_forward()
    cfg = port_cfg(dataclasses.replace(ref["cfg"],
                                       use_pallas=path == "kernel"))
    qcfg = QuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True)
    params, state = from_jax(ref["pn"], ref["sn"], ref["cfg"])
    pred = selected_conv_predicate(params, "reference")
    qp = quantize_params(preprocess_masters(params, qcfg, pred), qcfg, pred)
    with torch.no_grad():
        outs, _ = apply_cu_net(qp, state, torch.from_numpy(ref["x"]),
                               cfg=cfg, train=True, quant=qcfg,
                               drop_key=np.asarray(jax.random.PRNGKey(9)))
    t = torch.from_numpy(ref["t"])
    loss = sum(torch.mean((o - t) ** 2) for o in outs)
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=LOSS_RTOL)
    for a, b in zip(outs, ref["outs"]):
        np.testing.assert_allclose(a.numpy(), b, **FWD)
