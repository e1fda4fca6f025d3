"""Torch port: the value-carried whole-model evals (TPU kernels #3
``fused_model_loop_infer`` and #2 ``fused_model_infer``) against the JAX
package on the CPU.

- #3: JAX's ``apply_cu_net`` with ``pallas_whole_model`` and
  ``CUNET_TERA_IMPL=loop`` runs it in interpret mode; its stem output and
  every slot's head are captured, and the port's function on that stem
  output (``eval_slots`` of the same weights) gives every head;
- #2: JAX's function called with the slot arguments #3 was given (the
  unanchored heads dropped), in interpret mode, against the port's;
- both at the (order, loss) pairs of ``tests/test_fused_block.py``'s
  whole-model test, at float32 within ``TOL``;
- at bf16 the port's #3 and #2 anchored heads are its whole-model path's
  bit for bit: the same kernels in the same order.
"""

import dataclasses

import numpy as np
import pytest
import torch

import cunet_tpu.kernels.fused_model as jax_fm
from cunet_tpu.models import apply_cu_net as jax_apply_cu_net
from cunet_tpu_torch.kernels import fused_model
from cunet_tpu_torch.models import apply_cu_net
from cunet_tpu_torch.models.cu_net import _apply_stem, eval_slots

from torch_port_util import (TOL, from_jax, images, np_weights, port_cfg,
                             small_cfg)

# (order, loss) as tests/test_fused_block.py:158, K from the loss there
PAIRS = [(1, 2), (2, 5), (0, 2), (3, 6)]
K_OF_LOSS = {2: 4, 5: 5, 6: 6}


def _jax_loop(monkeypatch, cfg, x):
    """JAX's #3 through ``apply_cu_net``: (y_stem, slot_args, every head)."""
    seen = []
    orig = jax_fm.fused_model_loop_infer

    def spy(y_stem, slot_args, **kw):
        seen.append((y_stem, slot_args, kw))
        return orig(y_stem, slot_args, **kw)

    monkeypatch.setenv("CUNET_TERA_IMPL", "loop")
    monkeypatch.setattr(jax_fm, "fused_model_loop_infer", spy)
    outs, _ = jax_apply_cu_net(*np_weights(cfg), x, cfg=cfg, train=False)
    (y_stem, slot_args, kw), = seen
    stacked = orig(y_stem, slot_args, **kw)
    for a, o in zip(cfg.anchors, outs):
        np.testing.assert_array_equal(np.asarray(stacked[:, a - 1]),
                                      np.asarray(o))
    return y_stem, slot_args, stacked


@pytest.mark.parametrize("order,loss", PAIRS)
def test_loop_and_unrolled_match_jax(monkeypatch, order, loss):
    cfg = dataclasses.replace(
        small_cfg(K_OF_LOSS[loss], order, use_pallas=True,
                  pallas_whole_model=True), loss_num=loss)
    y_stem, slot_args, want = _jax_loop(monkeypatch, cfg, images())
    params, state = from_jax(*np_weights(cfg), cfg=cfg)
    pcfg = port_cfg(cfg)
    slots = eval_slots(params, state, pcfg)
    y = torch.from_numpy(np.array(y_stem))
    got = fused_model.fused_model_loop_infer(y, slots, pcfg)
    assert tuple(got.shape) == want.shape == (2, cfg.layer_num, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    anchored = [dict(sa, head=sa["head"] if i + 1 in cfg.anchors else None)
                for i, sa in enumerate(slot_args)]
    want2 = jax_fm.fused_model_infer(
        y_stem, anchored, num_blocks=cfg.num_blocks,
        layer_num=cfg.layer_num, order=order, anchors=cfg.anchors,
        class_num=cfg.class_num, interpret=True)
    got2 = fused_model.fused_model_infer(y, slots, pcfg)
    assert isinstance(got2, tuple) and len(got2) == len(want2) == loss
    for g, w in zip(got2, want2):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("order", [0, 1, 2])
def test_anchored_heads_are_the_whole_model_path_bf16(order):
    jcfg = dataclasses.replace(
        small_cfg(5, order, use_pallas=True, pallas_whole_model=True,
                  compute_dtype="bfloat16"), loss_num=3)
    params, state = from_jax(*np_weights(jcfg), cfg=jcfg)
    cfg = port_cfg(jcfg)
    x = torch.from_numpy(images())
    slots = eval_slots(params, state, cfg)
    whole, _ = apply_cu_net(params, state, x, cfg=cfg, slots=slots)
    y = _apply_stem(params, state, x.to(torch.bfloat16), cfg=cfg)
    every = fused_model.fused_model_loop_infer(y, slots, cfg)
    unrolled = fused_model.fused_model_infer(y, slots, cfg)
    assert every.shape[1] == cfg.layer_num and len(unrolled) == 3
    for a, w, u in zip(cfg.anchors, whole, unrolled):
        assert w.dtype == torch.bfloat16 and w.float().abs().max() > 0
        assert torch.equal(every[:, a - 1], w) and torch.equal(u, w)
    # the unanchored slots' heads run too, and are finite
    assert torch.isfinite(every.float()).all()
    plain, _ = apply_cu_net(params, state, x, cfg=dataclasses.replace(
        cfg, use_pallas=False))
    for w, p in zip(whole, plain):
        assert (w.float() - p.float()).norm() <= 3e-2 * p.float().norm()
