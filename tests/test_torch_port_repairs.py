"""Torch port: three faults against the reference, each held by a test that
the port failed before its repair (CPU; the card tests are in
tests/test_torch_port_cuda.py).

1. The face model's 68-class head on the kernel paths: every kernel
   operand of ``buf_ops`` / ``quant_ops`` / ``train_ops`` moves 8-wide
   vectors, so the heads run at a width padded to a multiple of 8
   (``pad_cols``) and the heatmaps are its first ``class_num`` columns.
2. The dtype guard of the CUDA kernel paths: ``check_kernel_dtype`` lets
   every float32 path through (the float and quantized evals, ghost-BN,
   quantized ghost-BN and whole-batch BN training have kernels) and
   raises ``NotImplementedError`` naming the dtypes the kernels take for
   any other (float16).
3. ``conv3x3_impl="scatter"``: the dense layers run JAX's scatter form,
   which rounds its tap partials and their sums in bf16.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cunet_tpu.config import QuantConfig
from cunet_tpu.models import apply_cu_net as jax_apply_cu_net
from cunet_tpu.ops.layers import conv3x3_scatter as jax_conv3x3_scatter
from cunet_tpu_torch.kernels import model_buf, train_slot
from cunet_tpu_torch.models import apply_cu_net
from cunet_tpu_torch.models.cu_net import check_kernel_dtype, eval_slots
from cunet_tpu_torch.ops.layers import conv2d, conv3x3_scatter
from cunet_tpu_torch.serving import Predictor
from cunet_tpu_torch.train import quant_eval_params

from torch_port_util import (TOL, from_jax, images, np_weights, port_cfg,
                             small_cfg)

FACE = 68            # the 300-W model's landmarks
INT8 = QuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True,
                   int8_infer=True, int8_impl="pallas")


# ---------------------------------------------------------------------------
# 1. the 68-class head
# ---------------------------------------------------------------------------


def _vector_widths(monkeypatch, module, names):
    """Wrap ``module``'s kernel wrappers: every 2-D bf16 / int8 / f32
    operand they get must have a width that is a multiple of 8, as the CUDA
    kernels require (checked here on the CPU, where the plain versions
    run). Returns the list of the widths seen."""
    seen = []

    def wrap(fn):
        def checked(*args, **kw):
            for a in list(args) + list(kw.values()):
                if isinstance(a, torch.Tensor) and a.dim() in (2, 3):
                    seen.append(a.shape[-1])
                    assert a.shape[-1] % 8 == 0, (fn.__name__, a.shape)
            return fn(*args, **kw)
        return checked

    for name in names:
        monkeypatch.setattr(module, name, wrap(getattr(module, name)))
    return seen


def test_eval_heads_are_marshalled_to_vector_widths(monkeypatch):
    cfg = small_cfg(3, 1, class_num=FACE, use_pallas=True,
                    pallas_whole_model=True)
    pn, sn = np_weights(cfg)
    params, state = from_jax(pn, sn, cfg=cfg)
    slots = eval_slots(params, state, cfg)
    assert [tuple(sl["head"][1].shape) for sl in slots] == [(16, 72)] * 3
    assert not slots[0]["head"][1][:, FACE:].any()
    seen = _vector_widths(monkeypatch, model_buf, ["affine_dot"])
    x = images()
    want, _ = jax_apply_cu_net(pn, sn, x, cfg=cfg, train=False)
    got, _ = apply_cu_net(params, state, torch.from_numpy(x), cfg=cfg,
                          slots=slots)
    assert 72 in seen
    for g, w in zip(got, want):
        assert g.shape == (2, 8, 8, FACE)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # the per-slot path (the head is its feature-table product, whose
    # kernel takes the 68-column tail itself) on the same slots
    got, _ = apply_cu_net(params, state, torch.from_numpy(x), slots=slots,
                          cfg=dataclasses.replace(cfg,
                                                  pallas_whole_model=False))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_int8_head_is_marshalled_to_vector_widths(monkeypatch):
    cfg = small_cfg(3, 1, class_num=FACE, use_pallas=True,
                    pallas_whole_model=True)
    params, state = from_jax(*np_weights(cfg), cfg=cfg)
    qp = quant_eval_params(params, INT8)
    slots = eval_slots(qp, state, cfg, INT8)
    assert slots[0]["head"][1].shape == (16, 72)
    assert slots[0]["head"][1].dtype == torch.int8
    _vector_widths(monkeypatch, model_buf, ["affine_dot_i8"])
    x = torch.from_numpy(images())
    got, _ = apply_cu_net(qp, state, x, cfg=cfg, quant=INT8, slots=slots)
    want, _ = apply_cu_net(qp, state, x, quant=dataclasses.replace(
        INT8, int8_impl="lax"), cfg=dataclasses.replace(cfg,
                                                        use_pallas=False))
    for g, w in zip(got, want):
        assert g.shape == (2, 8, 8, FACE)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_slot_train_head_runs_at_vector_width(monkeypatch):
    """The slot train kernels' head (forward, and the backward's dx / dW on
    its cotangent) at 68 classes: every operand 8-wide, and the kernel
    step's outputs and gradients those of the plain step."""
    cfg = small_cfg(2, 1, class_num=FACE, use_pallas=True, bn_tile=1,
                    remat="none")
    params, state = from_jax(*np_weights(cfg), cfg=cfg)
    seen = _vector_widths(monkeypatch, train_slot,
                          ["affine_dot", "affine_dx", "affine_dw"])
    x = torch.from_numpy(images())
    t = torch.from_numpy(np.random.RandomState(4).rand(2, 8, 8, FACE)
                         .astype(np.float32))
    grads = []
    for c in (cfg, dataclasses.replace(cfg, use_pallas=False)):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        outs, _ = apply_cu_net(p, state, x, cfg=c, train=True)
        loss = sum(((o.float() - t) ** 2).mean() for o in outs)
        loss.backward()
        grads.append((outs, {k: v.grad for k, v in p.items()}))
    assert 72 in seen
    (ko, kg), (po, pg) = grads
    for a, b in zip(ko, po):
        assert a.shape == (2, 8, 8, FACE)
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   **TOL)
    for key in ("heads.1.conv", "heads.0.conv", "heads.1.norm.scale"):
        np.testing.assert_allclose(kg[key].numpy(), pg[key].numpy(),
                                   rtol=1e-3, atol=1e-5)


# ---------------------------------------------------------------------------
# 2. the bf16 limit of the kernels
# ---------------------------------------------------------------------------


def test_f32_kernel_path_on_the_card_raises():
    """float32 passes the guard on every CUDA kernel path: the f32 eval,
    f32 ghost-BN training, f32 whole-batch BN training (``bn_tile=0``),
    quantized f32 ghost-BN training and the quantized f32 eval
    (tests/test_torch_port_f32_forms.py (c)); float16 raises, also from
    ``Predictor``."""
    f32 = small_cfg(2, 1, use_pallas=True)
    q = port_cfg(INT8)
    assert f32.bn_tile == 0
    check_kernel_dtype(f32, "cuda", train=True)
    check_kernel_dtype(dataclasses.replace(f32, bn_tile=2), "cuda:0",
                       train=True)
    check_kernel_dtype(dataclasses.replace(f32, bn_tile=2), "cuda:0",
                       train=True, quant=q)
    check_kernel_dtype(f32, "cuda", quant=q)
    f16 = dataclasses.replace(f32, compute_dtype="float16")
    with pytest.raises(NotImplementedError, match="bfloat16"):
        check_kernel_dtype(f16, "cuda", quant=q)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        Predictor(f16, device="cuda", quant=q)
    # bf16 kernels, the plain path on the card, and any dtype on the CPU
    check_kernel_dtype(dataclasses.replace(f32, compute_dtype="bfloat16"),
                       "cuda")
    check_kernel_dtype(dataclasses.replace(f32, use_pallas=False), "cuda")
    check_kernel_dtype(f32, "cpu")
    params, state = from_jax(*np_weights(f32), cfg=f32)
    outs, _ = apply_cu_net(params, state, torch.from_numpy(images()),
                           cfg=f32)
    assert outs[-1].dtype == torch.float32


# ---------------------------------------------------------------------------
# 3. conv3x3_impl="scatter"
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (3, 16, 16, 32),
                                   (1, 4, 4, 128)])
def test_scatter_conv_matches_jax_bf16(shape):
    """Both round the wide product's tap partials once to bf16 and sum
    them in bf16, one rounding per add: bit for bit (measured). The lax
    conv (one float32 sum, one rounding) differs on ~60 % of the
    outputs."""
    rng = np.random.RandomState(8)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(3, 3, shape[-1], 8) * 0.2).astype(np.float32)
    want = np.asarray(jax_conv3x3_scatter(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w)).astype(
            jnp.float32))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = conv3x3_scatter(xb, torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    lax = conv2d(xb, torch.from_numpy(w), padding=1).float().numpy()
    assert (lax != want).mean() > 0.3
    # float32: the two forms are the same conv
    f32 = conv3x3_scatter(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(
        f32.numpy(), conv2d(torch.from_numpy(x), torch.from_numpy(w),
                            padding=1).numpy(), rtol=1e-5, atol=1e-5)


def test_scatter_conv_runs_in_the_model():
    """The plain path with ``conv3x3_impl="scatter"`` at bf16 against
    JAX's, eval and train (autograd through the scatter form)."""
    cfg = small_cfg(3, 1, compute_dtype="bfloat16", conv3x3_impl="scatter",
                    use_scan=False)
    pn, sn = np_weights(cfg)
    params, state = from_jax(pn, sn, cfg=cfg)
    x = images()
    want, _ = jax_apply_cu_net(pn, sn, x, cfg=cfg, train=False)
    got, _ = apply_cu_net(params, state, torch.from_numpy(x), cfg=cfg)
    lax, _ = apply_cu_net(params, state, torch.from_numpy(x),
                          cfg=dataclasses.replace(cfg, conv3x3_impl="lax"))
    for g, w, l in zip(got, want, lax):
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_array_equal(g.float().numpy(), w)
        assert not np.array_equal(l.float().numpy(), w)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    outs, _ = apply_cu_net(p, state, torch.from_numpy(x), cfg=cfg,
                           train=True)
    outs[-1].float().sum().backward()
    g = p["hg.down.0.layers.1.conv2"].grad
    assert g is not None and torch.isfinite(g).all() and g.abs().max() > 0
