"""Torch port: the activation-checkpointing policies (``remat``) of the
layer-by-layer train paths on the CPU.

``remat`` in {"bottleneck", "layer", "block"} maps ``jax.checkpoint`` to
``torch.utils.checkpoint`` (non-reentrant), on the plain train path
(``use_pallas=False``) and on the per-bottleneck train kernel's path
(``use_pallas=True, bn_tile=0``, where the kernel subsumes "bottleneck"):

- each policy gives the loss, heatmaps, gradients and BN running statistics
  of ``remat="none"`` bit for bit (the recompute repeats the forward's
  arithmetic and the backward graph keeps its order), dropout included;
- each against the JAX package's train step with the same policy (its
  kernel in interpret mode), at tests/test_torch_port_train.py's
  tolerances.

A two-slot model with one down/up block (the JAX references with the
kernel in interpret mode cost ~15 s each), 32x32 images, batch 4, float32.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import cunet_tpu.kernels.train_bottleneck as jtb
from cunet_tpu.models import apply_cu_net as jax_apply_cu_net
from cunet_tpu.train.loss import intermediate_mse as jax_mse
from cunet_tpu_torch.models import apply_cu_net
from cunet_tpu_torch.ops.dropmask import draw_slot_seeds
from cunet_tpu_torch.tools.from_jax import flatten_tree
from cunet_tpu_torch.train import intermediate_mse

from torch_port_util import from_jax, images, np_weights, port_cfg, small_cfg

FWD = dict(rtol=5e-4, atol=5e-4)
GRAD = dict(rtol=3e-3, atol=3e-3)
STATE = dict(rtol=5e-4, atol=5e-4)
LOSS_RTOL = 1e-4
N, SIZE = 4, 32
PATHS = {"plain": False, "kernel": True}
REMATS = ["bottleneck", "layer", "block"]


@pytest.fixture(scope="module", autouse=True)
def _interpret():
    """JAX's train-bottleneck kernel in interpret mode (as
    tests/test_train_kernel.py::TestModelTrainPallas runs it)."""
    orig = jtb.fused_train_bottleneck
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtb, "fused_train_bottleneck",
                   lambda f, s, b, w, eps=1e-5, interp=False:
                   orig(f, s, b, w, eps, True))
        yield


def _cfg(path, remat, **kw):
    return small_cfg(2, 1, num_blocks=1, bn_tile=0, bn_dtype="compute",
                     use_scan=False, use_pallas=PATHS[path], remat=remat,
                     **kw)


def _inputs(cfg):
    t = np.random.RandomState(3).rand(N, SIZE // 4, SIZE // 4,
                                      cfg.class_num).astype(np.float32)
    return images(N, SIZE), t


@functools.lru_cache(maxsize=None)
def jax_step(path, remat):
    cfg = _cfg(path, remat)
    x, t = _inputs(cfg)
    pn, sn = np_weights(cfg)

    def loss(p):
        outs, ns = jax_apply_cu_net(p, sn, x, cfg=cfg, train=True)
        return jax_mse(outs, t), (outs, ns)

    (l, (outs, ns)), g = jax.value_and_grad(loss, has_aux=True)(pn)
    flat = lambda tree: flatten_tree(jax.tree_util.tree_map(  # noqa: E731
        np.asarray, tree))
    return dict(loss=float(l), outs=[np.asarray(o) for o in outs],
                state=flat(ns), grads=flat(g))


@functools.lru_cache(maxsize=None)
def port_step(path, remat, drop_rate=0.0):
    cfg = _cfg(path, remat, drop_rate=drop_rate)
    x, t = _inputs(cfg)
    params, state = from_jax(*np_weights(cfg), cfg=cfg)
    for v in params.values():
        v.requires_grad_(True)
    seeds = (draw_slot_seeds(torch.Generator().manual_seed(5), 2)
             if drop_rate else None)
    outs, new_state = apply_cu_net(params, state, torch.from_numpy(x),
                                   cfg=port_cfg(cfg), train=True,
                                   drop_seeds=seeds)
    loss = intermediate_mse(outs, torch.from_numpy(t))
    loss.backward()
    assert not any(v.requires_grad for v in new_state.values())
    return dict(loss=loss.item(), outs=[o.detach() for o in outs],
                state=dict(new_state),
                grads={k: v.grad for k, v in params.items()})


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("path", list(PATHS))
def test_remat_equals_no_remat_bit_for_bit(path, remat):
    want, got = port_step(path, "none"), port_step(path, remat)
    assert got["loss"] == want["loss"]
    assert all(torch.equal(a, b) for a, b in zip(got["outs"], want["outs"]))
    assert set(got["state"]) == set(want["state"])
    for k, v in want["state"].items():
        assert torch.equal(got["state"][k], v), k
    for k, v in want["grads"].items():
        assert torch.equal(got["grads"][k], v), k


@pytest.mark.parametrize("remat", ["layer", "block"])
def test_remat_with_dropout_bit_for_bit(remat):
    """The checkpointed regions regenerate the same dropout masks from the
    slot seeds ("block" recomputes them, "layer" applies them outside)."""
    want = port_step("kernel", "none", 0.2)
    got = port_step("kernel", remat, 0.2)
    assert got["loss"] == want["loss"]
    for k, v in want["grads"].items():
        assert torch.equal(got["grads"][k], v), k


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("path", list(PATHS))
def test_remat_step_matches_jax(path, remat):
    ref, got = jax_step(path, remat), port_step(path, remat)
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
    for a, b in zip(got["outs"], ref["outs"]):
        np.testing.assert_allclose(a.numpy(), b, **FWD)
    for k, want in ref["state"].items():
        np.testing.assert_allclose(got["state"][k].numpy(), want, err_msg=k,
                                   **STATE)
    for k, want in ref["grads"].items():
        np.testing.assert_allclose(got["grads"][k].numpy(), want, err_msg=k,
                                   **GRAD)


def test_remat_region_writes_each_running_stat_once():
    """Under "block" every BN's new running statistics come from the first
    forward (a dict of the same keys and values as without remat) and the
    recompute in the backward adds nothing to the returned state."""
    cfg = port_cfg(_cfg("kernel", "block"))
    x, _ = _inputs(cfg)
    params, state = from_jax(*np_weights(_cfg("kernel", "block")), cfg=cfg)
    for v in params.values():
        v.requires_grad_(True)
    outs, new_state = apply_cu_net(params, state, torch.from_numpy(x),
                                   cfg=cfg, train=True)
    before = {k: v.clone() for k, v in new_state.items()}
    sum(o.float().sum() for o in outs).backward()
    assert set(new_state) == set(state)
    assert all(torch.equal(before[k], v) for k, v in new_state.items())
    plain = dataclasses.replace(cfg, remat="none")
    _, want = apply_cu_net(params, state, torch.from_numpy(x), cfg=plain,
                           train=True)
    assert all(torch.equal(want[k], v) for k, v in new_state.items())
