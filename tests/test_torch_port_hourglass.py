"""Torch port: the per-slot eval kernel (TPU kernel #4) against the JAX
package on the CPU.

- one slot: the port's ``fused_hourglass_infer`` (its kernels' plain
  versions on CPU tensors) against JAX's in interpret mode, each called by
  its package's ``_fused_slot_eval_hg`` on slot 0, a growth slot and a
  steady slot at orders 0, 1 and 2; every output (y_out, head, pre_out,
  the out32s) and the FIFOs the bookkeeping hands on;
- the whole model with ``use_pallas`` and the default flags (#4 for every
  slot; JAX's scan runs its steady slots, K >= order + 3) against JAX;
- at bf16 the port's per-slot path against its whole-model path (#1): the
  same plain kernels with the same rounding points, bit for bit;
- the ``Predictor`` with the default flags marshals the slots once and
  serves what JAX's ``Predictor`` serves.

Tolerances: ``TOL`` at float32; at bf16 the bound each test states, as
measured against JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cunet_tpu.kernels.fused_hourglass as jax_fhg
from cunet_tpu.models import apply_cu_net as jax_apply_cu_net
from cunet_tpu.models.cu_net import _fused_slot_eval_hg as jax_slot_eval
from cunet_tpu.models.cu_net import _slot_subtree as jax_slot_subtree
from cunet_tpu.serving import Predictor as JaxPredictor
from cunet_tpu_torch.kernels import hourglass
from cunet_tpu_torch.models import apply_cu_net
from cunet_tpu_torch.models.cu_net import (
    _fused_slot_eval_hg,
    eval_path,
    eval_slots,
)
from cunet_tpu_torch.serving import Predictor

from torch_port_util import TOL, from_jax, images, np_weights, small_cfg

# (order, slot): slot 0 (no intermedia adapter, FIFOs seeded), a growth
# slot (i < order: FIFOs append) where the order has one, a steady slot
SLOTS = [(0, 0), (0, 2), (1, 0), (1, 2), (2, 0), (2, 1), (2, 3)]


def _capture(monkeypatch, module, name):
    """Record every raw return of ``module.name``."""
    seen, orig = [], getattr(module, name)

    def spy(*a, **k):
        seen.append(orig(*a, **k))
        return seen[-1]

    monkeypatch.setattr(module, name, spy)
    return seen


def _slot_inputs(cfg, i, seed=5):
    """A slot input and the FIFOs slot ``i`` reads, numpy, in the
    ``empty_fifos`` structure."""
    rng = np.random.RandomState(seed)
    n, h0, c, g, nb = 2, 8, cfg.init_chan_num, cfg.growth_rate, \
        cfg.num_blocks
    nf = min(i, cfg.order)

    def entries(r, ch, k=nf):
        return [rng.randn(n, r, r, ch).astype(np.float32) for _ in range(k)]

    return rng.randn(n, h0, h0, c).astype(np.float32), {
        "intermedia": entries(h0, c) if i > 0 else [],
        "down": [entries(h0 >> j, g) for j in range(nb)],
        "neck": entries(h0 >> nb, g),
        "up": [entries(h0 >> j, g) for j in range(nb)],
    }


def _flat_fifos(f):
    return (list(f["intermedia"]) + [t for e in f["down"] for t in e]
            + list(f["neck"]) + [t for e in f["up"] for t in e])


@pytest.mark.parametrize("order,i", SLOTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slot_matches_jax(monkeypatch, order, i, dtype):
    cfg = small_cfg(4, order, use_pallas=True, compute_dtype=dtype)
    pn, sn = np_weights(cfg)
    y, fifos = _slot_inputs(cfg, i)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    want_raw = _capture(monkeypatch, jax_fhg, "fused_hourglass_infer")
    got_raw = _capture(monkeypatch, hourglass, "fused_hourglass_infer")
    jf = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdt), fifos)
    jy, jf_out, jhm = jax_slot_eval(
        jax_slot_subtree(pn, i, cfg), jax_slot_subtree(sn, i, cfg),
        jnp.asarray(y).astype(jdt), jf, cfg=cfg, slot_i=i)
    params, state = from_jax(pn, sn, cfg=cfg)
    tf = {k: [[torch.from_numpy(t).to(tdt) for t in e] for e in v]
          if k in ("down", "up") else [torch.from_numpy(t).to(tdt) for t in v]
          for k, v in fifos.items()}
    ty, tf_out, thm = _fused_slot_eval_hg(
        torch.from_numpy(y).to(tdt), tf, eval_slots(params, state, cfg)[i],
        cfg=cfg, i=i)
    (want,), (got,) = want_raw, got_raw
    n_out = 2 + (i > 0 and order > 0) + (2 * cfg.num_blocks + 1) * (order > 0)
    assert len(got) == len(want) == n_out
    pairs = list(zip(got, want)) + [(ty, jy), (thm, jhm)]
    if order > 0:
        pairs += list(zip(_flat_fifos(tf_out), _flat_fifos(jf_out)))
    else:
        assert tf_out is tf
    for g, w in pairs:
        w = np.asarray(w.astype(jnp.float32))
        assert g.dtype == tdt and tuple(g.shape) == w.shape
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), w, **TOL)
        else:
            # bf16: the 1x1 stages round as JAX's do; the 3x3 conv sums its
            # taps in float32 in another order (JAX's dycol form: three
            # products and three shifted adds), so an out32 may land one
            # rounding apart and carry that on. Measured: 13 of the 14
            # cases bit for bit, order 0 slot 2 one ulp (2^-8 at
            # max|w| ~ 1.4) on 6-8 % of y_out and the head
            bound = 2 ** -6 * np.abs(w).max() + 2 ** -7
            gap = np.abs(g.float().numpy() - w).max()
            assert gap <= bound


@pytest.mark.parametrize("layer_num,order", [(3, 0), (4, 1), (5, 2)])
def test_model_matches_jax(layer_num, order):
    cfg = small_cfg(layer_num, order, use_pallas=True)
    assert cfg.pallas_hourglass and cfg.use_scan
    pn, sn = np_weights(cfg)
    x = images()
    want, _ = jax_apply_cu_net(pn, sn, x, cfg=cfg, train=False)
    params, state = from_jax(pn, sn, cfg=cfg)
    assert eval_path(cfg) == "hourglass"
    got, _ = apply_cu_net(params, state, torch.from_numpy(x), cfg=cfg)
    assert len(got) == len(want) == len(cfg.anchors)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("order", [0, 1, 2])
def test_slot_path_equals_whole_model_path_bf16(monkeypatch, order):
    """Both paths run the same plain kernels on the CPU with the same
    rounding points, so they agree bit for bit; the per-slot path runs
    ``fused_hourglass_infer`` once per slot. (JAX's own two kernels, #4
    and #1 in interpret mode, differ at order 1: one ulp on ~1 % of the
    last anchor's heatmaps, measured on these inputs.)"""
    cfg = small_cfg(4, order, use_pallas=True, compute_dtype="bfloat16")
    params, state = from_jax(*np_weights(cfg), cfg=cfg)
    x = torch.from_numpy(images())
    slots = eval_slots(params, state, cfg)
    calls = _capture(monkeypatch, hourglass, "fused_hourglass_infer")
    per_slot, _ = apply_cu_net(params, state, x, cfg=cfg, slots=slots)
    assert len(calls) == cfg.layer_num
    whole, _ = apply_cu_net(params, state, x, slots=slots,
                            cfg=dataclasses.replace(cfg,
                                                    pallas_whole_model=True))
    for a, b in zip(per_slot, whole):
        assert a.dtype == torch.bfloat16 and a.float().abs().max() > 0
        assert torch.equal(a, b)


def test_predictor_serves_the_slot_path(monkeypatch):
    cfg = small_cfg(4, 1, use_pallas=True)
    pn, sn = np_weights(cfg)
    imgs = images(n=6, seed=2)
    pairs = np.array([[0, 1]])
    want = JaxPredictor(cfg, pn, sn, batch_size=4, flip_test=True,
                        flip_pairs=pairs).heatmaps(imgs)
    calls = _capture(monkeypatch, hourglass, "fused_hourglass_infer")
    pred = Predictor.from_jax_params(cfg, pn, sn, device="cpu", batch_size=4,
                                     flip_test=True, flip_pairs=pairs)
    assert pred._slots is not None and len(pred._slots) == cfg.layer_num
    got = pred.heatmaps(imgs)
    # two chunks of 4, each with its mirror: four forwards of K slots
    assert len(calls) == 4 * cfg.layer_num
    np.testing.assert_allclose(got, want, **TOL)
