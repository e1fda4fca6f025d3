"""Torch port, dropout training (``drop_rate > 0``, ``drop_impl="prng"``) on
the CPU against the JAX package.

The JAX package derives each slot's int32 seed from its key
(``dropmask.derive_seed(jax.random.fold_in(rng, i))``); the port is handed
those seeds (``apply_cu_net(..., drop_seeds=)``), so both draw the same
masks. Held against JAX's lax path: the port's plain path and its kernel
path (``use_pallas=True, bn_tile=2``: the slot train orchestration with the
mask op's plain version); against JAX's fused slot kernels (interpret
mode, their in-kernel seed masks): the port's kernel path. Tolerances of
tests/test_train_slot.py's dropout parity: loss rtol 1e-4, outputs and BN
state 5e-4, grads 3e-3.

Small widths (c=16, g=8, Cb=16, 4 classes, 2 blocks), 32x32 images, batch
4, ghost-BN tile 2, float32, drop rate 0.25.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from cunet_tpu.models import apply_cu_net as jax_apply_cu_net
from cunet_tpu.ops import dropmask as jdm
from cunet_tpu.train.loss import intermediate_mse as jax_mse
from cunet_tpu_torch.config import TrainConfig
from cunet_tpu_torch.kernels import drop_ops
from cunet_tpu_torch.models import apply_cu_net
from cunet_tpu_torch.tools.from_jax import flatten_tree
from cunet_tpu_torch.train import create_train_state, intermediate_mse
from cunet_tpu_torch.train import train_step

from torch_port_util import from_jax, images, np_weights, port_cfg, small_cfg

FWD = dict(rtol=5e-4, atol=5e-4)
GRAD = dict(rtol=3e-3, atol=3e-3)
LOSS_RTOL = 1e-4
N, SIZE, RATE = 4, 32, 0.25


def _cfg(layer_num, **kw):
    return small_cfg(layer_num, 1, bn_tile=2, bn_dtype="compute",
                     remat="none", use_scan=False, drop_rate=RATE, **kw)


def _targets(cfg, seed=3):
    return np.random.RandomState(seed).rand(
        N, SIZE // 4, SIZE // 4, cfg.class_num).astype(np.float32)


def _flat_np(tree):
    return flatten_tree(jax.tree_util.tree_map(np.asarray, tree))


def jax_seeds(rng, layer_num):
    """The per-slot int32 seeds JAX's dropout draws from ``rng``."""
    return [int(np.asarray(jdm.derive_seed(jax.random.fold_in(rng, i)))[0])
            for i in range(layer_num)]


@functools.lru_cache(maxsize=None)
def jax_reference(layer_num, use_pallas):
    """JAX loss, outputs, new bn_state and grads under dropout (the lax path,
    or the fused slot kernels in interpret mode), with their inputs."""
    cfg = _cfg(layer_num, use_pallas=use_pallas)
    x, t = images(N, SIZE), _targets(cfg)
    pn, sn = np_weights(cfg)
    rng = jax.random.PRNGKey(7)

    def loss(p):
        outs, ns = jax_apply_cu_net(p, sn, x, cfg=cfg, train=True, rng=rng)
        return jax_mse(outs, t), (outs, ns)

    (l, (outs, ns)), g = jax.value_and_grad(loss, has_aux=True)(pn)
    return dict(cfg=cfg, pn=pn, sn=sn, x=x, t=t, seeds=jax_seeds(rng,
                                                                layer_num),
                loss=float(l), outs=[np.asarray(o) for o in outs],
                state=_flat_np(ns), grads=_flat_np(g))


def port_run(ref, use_pallas, seeds=None):
    cfg = port_cfg(dataclasses.replace(ref["cfg"], use_pallas=use_pallas))
    params, state = from_jax(ref["pn"], ref["sn"], ref["cfg"])
    for v in params.values():
        v.requires_grad_(True)
    outs, new_state = apply_cu_net(
        params, state, torch.from_numpy(ref["x"]), cfg=cfg, train=True,
        drop_seeds=ref["seeds"] if seeds is None else seeds)
    loss = intermediate_mse(outs, torch.from_numpy(ref["t"]))
    loss.backward()
    return dict(loss=loss.item(), outs=[o.detach().numpy() for o in outs],
                state={k: v.numpy() for k, v in new_state.items()},
                grads={k: v.grad.numpy() for k, v in params.items()})


# (port path, JAX path): the plain and kernel paths against lax (3 slots,
# a steady state from slot 1), the kernel path against the fused kernels
CASES = [("plain", "lax"), ("kernel", "lax"), ("kernel", "fused")]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def case(request):
    path, jpath = request.param
    ref = jax_reference(3 if jpath == "lax" else 2, jpath == "fused")
    return ref, port_run(ref, path == "kernel")


def test_dropout_outputs_and_loss_match_jax(case):
    ref, got = case
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
    assert len(got["outs"]) == len(ref["outs"])
    for a, b in zip(got["outs"], ref["outs"]):
        np.testing.assert_allclose(a, b, **FWD)


def test_dropout_bn_state_matches_jax(case):
    ref, got = case
    assert set(got["state"]) == set(ref["state"])
    for k, want in ref["state"].items():
        np.testing.assert_allclose(got["state"][k], want, err_msg=k, **FWD)


def test_dropout_grads_match_jax(case):
    ref, got = case
    assert set(got["grads"]) == set(ref["grads"])
    for k, want in ref["grads"].items():
        np.testing.assert_allclose(got["grads"][k], want, err_msg=k, **GRAD)


@pytest.mark.parametrize("path", ["plain", "kernel"])
def test_dropped_output_differs_from_undropped(path):
    """The masks are not all ones: the dropped forward differs from the
    same forward with another seed, and from the undropped one."""
    ref = jax_reference(3, False)
    a = port_run(ref, path == "kernel")
    b = port_run(ref, path == "kernel", seeds=[s + 1 for s in ref["seeds"]])
    cfg0 = port_cfg(dataclasses.replace(ref["cfg"], drop_rate=0.0,
                                        use_pallas=path == "kernel"))
    params, state = from_jax(ref["pn"], ref["sn"], ref["cfg"])
    with torch.no_grad():
        outs0, _ = apply_cu_net(params, state, torch.from_numpy(ref["x"]),
                                cfg=cfg0, train=True)
    assert not np.allclose(a["outs"][-1], b["outs"][-1], atol=1e-3)
    assert not np.allclose(a["outs"][-1], outs0[-1].numpy(), atol=1e-3)


def test_train_step_draws_seeds_from_its_generator():
    """Two kernel-path steps from one generator: each step draws new seeds
    (the second step's masks differ), the loss stays finite, and the same
    generator seed repeats the step exactly; no kernel launches on the
    CPU."""
    ref = jax_reference(3, False)
    cfg = port_cfg(dataclasses.replace(ref["cfg"], use_pallas=True))
    batch = {"image": torch.from_numpy(ref["x"]),
             "heatmap": torch.from_numpy(ref["t"])}

    def run(seed):
        st = create_train_state(*from_jax(ref["pn"], ref["sn"], ref["cfg"]),
                                TrainConfig(lr=1e-3))
        gen = torch.Generator().manual_seed(seed)
        return [float(train_step(st, batch, cfg=cfg, generator=gen)[1][
            "loss"]) for _ in range(2)], st

    drop_ops.reset_launch_counts()
    losses, st = run(0)
    again, st2 = run(0)
    other, _ = run(1)
    assert np.isfinite(losses).all() and st.step == 2
    assert losses == again
    assert all(torch.equal(st.params[k], st2.params[k]) for k in st.params)
    assert losses[0] != other[0]
    assert drop_ops.drop_mask.launches == 0
    with pytest.raises(ValueError):
        train_step(st, batch, cfg=cfg)           # dropout needs a generator


@pytest.mark.parametrize("use_pallas", [False, True])
def test_dropout_without_seeds_raises(use_pallas):
    ref = jax_reference(3, False)
    cfg = port_cfg(dataclasses.replace(ref["cfg"], use_pallas=use_pallas))
    params, state = from_jax(ref["pn"], ref["sn"], ref["cfg"])
    with pytest.raises(ValueError):
        apply_cu_net(params, state, torch.from_numpy(ref["x"]), cfg=cfg,
                     train=True)
    with pytest.raises(ValueError):               # one seed per slot
        apply_cu_net(params, state, torch.from_numpy(ref["x"]), cfg=cfg,
                     train=True, drop_seeds=ref["seeds"][:2])
    # eval ignores dropout
    apply_cu_net(params, state, torch.from_numpy(ref["x"]),
                 cfg=dataclasses.replace(cfg, use_pallas=False))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_drop_impl_masks_raises(use_pallas):
    """The threefry-mask form draws from a (2,) uint32 threefry key: with
    seeds and no key, or with a (4,) key of JAX's rbg generators, it
    refuses to train."""
    ref = jax_reference(3, False)
    cfg = port_cfg(dataclasses.replace(ref["cfg"], drop_impl="masks",
                                       use_pallas=use_pallas))
    params, state = from_jax(ref["pn"], ref["sn"], ref["cfg"])
    x = torch.from_numpy(ref["x"])
    with pytest.raises(ValueError, match="drop_key"):
        apply_cu_net(params, state, x, cfg=cfg, train=True,
                     drop_seeds=ref["seeds"])
    with pytest.raises(ValueError, match="uint32"):
        apply_cu_net(params, state, x, cfg=cfg, train=True,
                     drop_key=np.zeros(4, np.uint32))
