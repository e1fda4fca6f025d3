"""Torch port: feature tables of more than 16 groups, on the CPU.

An up block's adapter reads ``order + 3`` feature groups (its input, its
skip, ``order`` FIFO entries and the layer's output), so ``order`` >= 14
gives 17 or more; ``ModelConfig`` takes any ``order < layer_num``. The
card's ``table_dot`` carries 16 groups in its launch parameters and reads a
longer table from device memory; here, where the wrapper takes its plain
version, these tests hold:

- ``table_dot`` (the wrapper on CPU tensors) and ``table_dot_plain`` over
  17 and 18 groups, with and without the first group upsampled, single and
  dual, against the product over the concatenated features;
- the port's per-slot path (TPU kernel #4) on a steady slot at order 14
  against JAX's ``fused_hourglass_infer`` (interpret mode on the CPU);
- the per-slot, per-block and per-bottleneck paths of a model at order 14
  against the plain path, and the per-slot path bit for bit the
  whole-model path at bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cunet_tpu.kernels.fused_hourglass as jax_fhg
from cunet_tpu.models.cu_net import _fused_slot_eval_hg as jax_slot_eval
from cunet_tpu.models.cu_net import _slot_subtree as jax_slot_subtree
from cunet_tpu_torch.kernels import eval_ops, hourglass
from cunet_tpu_torch.kernels.buf_ops import INLINE_GROUPS, affine_dot_plain
from cunet_tpu_torch.models import apply_cu_net
from cunet_tpu_torch.models.cu_net import _fused_slot_eval_hg, eval_slots

from test_torch_port_hourglass import _capture, _flat_fifos, _slot_inputs
from torch_port_util import TOL, from_jax, images, np_weights, small_cfg

ORDER = 14


@pytest.mark.parametrize("groups", [17, 18])
@pytest.mark.parametrize("up", [False, True])
def test_table_dot_past_16_groups_is_the_concat_product(groups, up):
    """The wrapper (on CPU tensors its plain version) over ``groups``
    separate features, the first at half resolution when ``up``, with the
    dual form's second output: each output the plain affine product over
    the concatenated (upsampled) features."""
    assert groups > INLINE_GROUPS
    gen = torch.Generator().manual_seed(groups + up)
    n, r, c, g, nout = 2, 8, 16, 8, 24
    m = n * r * r
    first = torch.randn(m // 4 if up else m, c, generator=gen)
    feats = [first, torch.randn(m, c, generator=gen)] + [
        torch.randn(m, g, generator=gen) for _ in range(groups - 2)]
    k = sum(f.shape[1] for f in feats)
    vec = torch.stack([torch.rand(k, generator=gen) + 0.5,
                       torch.randn(k, generator=gen) * 0.5])
    vec_s = torch.stack([torch.rand(k, generator=gen) + 0.5,
                         torch.randn(k, generator=gen) * 0.5])
    w = torch.randn(k, nout, generator=gen) * k ** -0.5
    w_s = torch.randn(k, nout, generator=gen) * k ** -0.5
    kw = dict(up=(True,) + (False,) * (groups - 1), hw=(r, r)) if up else {}
    out, out_s = torch.empty(m, nout), torch.empty(m, nout)
    eval_ops.reset_launch_counts()
    eval_ops.table_dot(feats, vec, w, out, vec_s=vec_s, w_s=w_s,
                       out_s=out_s, **kw)
    assert eval_ops.table_dot.launches == 0     # the CPU takes the plain one
    full = first.reshape(n, r // 2, r // 2, c).repeat_interleave(
        2, 1).repeat_interleave(2, 2).reshape(m, c) if up else first
    x = torch.cat([full] + feats[1:], dim=1)
    for v, wt, got in ((vec, w, out), (vec_s, w_s, out_s)):
        want = affine_dot_plain(x, v, wt, torch.empty(m, nout))
        assert torch.equal(got, want)
        again = torch.empty(m, nout)
        eval_ops.table_dot_plain(feats, v, wt, again, **kw)
        assert torch.equal(again, want)


def test_steady_slot_at_order_14_matches_jax(monkeypatch):
    """A steady slot at order 14 (layer_num 15): every up block's adapter
    reads 17 groups. The port's ``fused_hourglass_infer`` against JAX's in
    interpret mode, each called by its package's ``_fused_slot_eval_hg``:
    every output and the FIFOs handed on, at float32 within TOL."""
    cfg = small_cfg(ORDER + 1, ORDER, use_pallas=True)
    i = ORDER
    pn, sn = np_weights(cfg)
    y, fifos = _slot_inputs(cfg, i)
    widths = []
    table_dot = eval_ops.table_dot

    def counting(feats, *a, **k):
        widths.append(len(feats))
        return table_dot(feats, *a, **k)

    monkeypatch.setattr(hourglass, "table_dot", counting)
    want_raw = _capture(monkeypatch, jax_fhg, "fused_hourglass_infer")
    got_raw = _capture(monkeypatch, hourglass, "fused_hourglass_infer")
    jf = jax.tree_util.tree_map(jnp.asarray, fifos)
    jy, jf_out, jhm = jax_slot_eval(
        jax_slot_subtree(pn, i, cfg), jax_slot_subtree(sn, i, cfg),
        jnp.asarray(y), jf, cfg=cfg, slot_i=i)
    params, state = from_jax(pn, sn, cfg=cfg)
    tf = {k: [[torch.from_numpy(t) for t in e] for e in v]
          if k in ("down", "up") else [torch.from_numpy(t) for t in v]
          for k, v in fifos.items()}
    ty, tf_out, thm = _fused_slot_eval_hg(
        torch.from_numpy(y), tf, eval_slots(params, state, cfg)[i], cfg=cfg,
        i=i)
    assert max(widths) == ORDER + 3 > INLINE_GROUPS
    (want,), (got,) = want_raw, got_raw
    assert len(got) == len(want)
    pairs = list(zip(got, want)) + [(ty, jy), (thm, jhm)] + list(
        zip(_flat_fifos(tf_out), _flat_fifos(jf_out)))
    for g, w in pairs:
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_paths_at_order_14(dtype):
    """At order 14 the per-slot, per-block and per-bottleneck paths (their
    kernels' plain versions on the CPU) run and agree with the plain path;
    the per-slot path bit for bit the whole-model path."""
    cfg = dataclasses.replace(small_cfg(ORDER + 1, ORDER, use_pallas=True,
                                        compute_dtype=dtype), loss_num=2)
    params, state = from_jax(*np_weights(cfg), cfg=cfg)
    x = torch.from_numpy(images())
    slots = eval_slots(params, state, cfg)
    per_slot, _ = apply_cu_net(params, state, x, cfg=cfg, slots=slots)
    whole, _ = apply_cu_net(params, state, x, slots=slots,
                            cfg=dataclasses.replace(cfg,
                                                    pallas_whole_model=True))
    plain, _ = apply_cu_net(params, state, x, cfg=dataclasses.replace(
        cfg, use_pallas=False))
    others = [apply_cu_net(params, state, x, cfg=dataclasses.replace(
        cfg, pallas_hourglass=False, **f))[0]
        for f in ({}, {"use_scan": False})]
    for i, (a, b, p) in enumerate(zip(per_slot, whole, plain)):
        assert torch.equal(a, b)
        for t in [a] + [o[i] for o in others]:
            if dtype == "float32":
                np.testing.assert_allclose(t.numpy(), p.numpy(), **TOL)
            else:
                rel = ((t.float() - p.float()).norm() / p.float().norm())
                assert rel.item() <= 3e-2
