"""Torch port: the per-block eval (TPU kernel #5) against the JAX package on
the CPU.

- one block: the port's ``fused_dense_block_infer`` (its kernels' plain
  versions on CPU tensors) against JAX's in interpret mode, for a down
  block with the intermedia pre-stage, its skip adapter and the pooled
  ahead output, the neck, and an up block with its upsampled first
  feature and the head; every output;
- the whole model with ``use_pallas, pallas_hourglass=False`` and
  ``use_scan`` (the slots before ``max(order, 1)`` layer by layer on #6,
  every steady slot on #5: JAX's scan runs #5 there) against JAX at
  orders 0, 1 and 2 with K >= order + 3; the launch of #5 per steady
  block, and none of the per-slot kernel;
- the ``Predictor`` with those flags marshals the slots once and serves
  what JAX's ``Predictor`` serves;
- ``table_dot``'s argument checks for the upsample, the pool and the BN2
  epilogue, which run before the CPU takes the plain version.

Tolerances: ``TOL`` at float32; at bf16 the bound each test states, as
measured against JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cunet_tpu.kernels.fused_block as jax_fblk
from cunet_tpu.models import apply_cu_net as jax_apply_cu_net
from cunet_tpu.serving import Predictor as JaxPredictor
from cunet_tpu_torch.kernels import eval_ops, fused_block, hourglass
from cunet_tpu_torch.models import apply_cu_net
from cunet_tpu_torch.models.cu_net import eval_path
from cunet_tpu_torch.serving import Predictor

from torch_port_util import TOL, from_jax, images, np_weights, small_cfg

N, H, C, G, CB, CLS = 2, 8, 16, 8, 16, 4


def _vec(rng, k):
    return np.stack([rng.uniform(0.5, 1.5, k),
                     rng.randn(k) * 0.3]).astype(np.float32)


def _w(rng, *shape):
    a = np.sqrt(3.0 / np.prod(shape[:-1]))
    return rng.uniform(-a, a, shape).astype(np.float32)


def _block_case(kind, seed=3):
    """(features, positional weights, keyword options) of one block, numpy,
    at the small widths: c=16, g=8, Cb=16, 8x8 images, batch 2, one FIFO
    entry; kwargs hold the pre-stage's and head's features and weights."""
    rng = np.random.RandomState(seed)

    def feat(r, ch):
        return rng.randn(N, r, r, ch).astype(np.float32)

    if kind == "up":
        feats = [feat(H // 2, C), feat(H, C), feat(H, G)]
    else:
        feats = [feat(H, C), feat(H, G)]
    cin = sum(f.shape[-1] for f in feats)
    args = [_vec(rng, cin), _w(rng, 1, 1, cin, CB), _vec(rng, CB),
            _w(rng, 3, 3, CB, G), _vec(rng, cin + G),
            _w(rng, 1, 1, cin + G, C)]
    kw = {}
    if kind == "down":
        args += [_vec(rng, cin + G), _w(rng, 1, 1, cin + G, C)]
        kw = dict(pre_features=[feat(H, C), feat(H, C)],
                  pre_vec=_vec(rng, 2 * C), pre_w=_w(rng, 1, 1, 2 * C, C),
                  pool_ahead=True)
    if kind == "up":
        kw = dict(head_vec=_vec(rng, C), head_w=_w(rng, 1, 1, C, CLS),
                  upsample_first=True)
    return feats, args, kw


@pytest.mark.parametrize("kind", ["down", "neck", "up"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_matches_jax(kind, dtype):
    feats, args, kw = _block_case(kind)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jkw = {k: ([jnp.asarray(f).astype(jdt) for f in v] if k == "pre_features"
               else jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    want = jax_fblk.fused_dense_block_infer(
        [jnp.asarray(f).astype(jdt) for f in feats],
        *[jnp.asarray(a) for a in args], **jkw, interpret=True)
    tkw = {k: ([torch.from_numpy(f).to(tdt) for f in v]
               if k == "pre_features"
               else torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    got = fused_block.fused_dense_block_infer(
        [torch.from_numpy(f).to(tdt) for f in feats],
        *[torch.from_numpy(a) for a in args], **tkw)
    # (ahead[, skip], layer_out[, head][, pre_out])
    assert len(got) == len(want) == {"down": 4, "neck": 2, "up": 3}[kind]
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert g.dtype == tdt and tuple(g.shape) == w.shape
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), w, **TOL)
        else:
            # bf16: the 1x1 stages and the pool round as JAX's do; the 3x3
            # conv sums its nine taps in float32 in another order (JAX's
            # dy-major shifted products, fused_block.py:36-54), so an out32
            # may land one rounding apart and the adapters and head carry
            # it. Measured: every output bit for bit here
            bound = 2 ** -6 * np.abs(w).max() + 2 ** -7
            assert np.abs(g.float().numpy() - w).max() <= bound


def _count(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def spy(*a, **k):
        calls.append(k)
        return orig(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("layer_num,order", [(3, 0), (4, 1), (5, 2)])
def test_model_matches_jax(monkeypatch, layer_num, order):
    """JAX's scan runs #5 on its steady slots (in interpret mode on the CPU,
    ``kernels/common.py::auto_interpret``), its unrolled slots layer by
    layer on #6; the port runs the same split."""
    cfg = small_cfg(layer_num, order, use_pallas=True,
                    pallas_hourglass=False)
    assert cfg.use_scan
    pn, sn = np_weights(cfg)
    x = images()
    jax_calls = _count(monkeypatch, jax_fblk, "fused_dense_block_infer")
    want, _ = jax_apply_cu_net(pn, sn, x, cfg=cfg, train=False)
    params, state = from_jax(pn, sn, cfg=cfg)
    assert eval_path(cfg) == "blocks"
    calls = _count(monkeypatch, fused_block, "fused_dense_block_infer")
    slot_calls = _count(monkeypatch, hourglass, "fused_hourglass_infer")
    got, _ = apply_cu_net(params, state, torch.from_numpy(x), cfg=cfg)
    steady = layer_num - max(order, 1)
    npos = 2 * cfg.num_blocks + 1
    assert len(jax_calls) == npos   # traced once: the scan body
    assert len(calls) == steady * npos and not slot_calls
    assert sum("pre_w" in k for k in calls) == steady
    assert sum("head_w" in k for k in calls) == steady   # every slot anchored
    assert len(got) == len(want) == len(cfg.anchors)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_model_matches_jax_bf16():
    """At bf16 the whole new path against JAX's: the same rounding points;
    only the 3x3 sum order differs (above), and a one-ulp flip in a slot
    spreads through the slots after it. Measured: anchors 1-2 bit for bit,
    anchors 3-4 1.2e-3 and 1.8e-3 relative L2; the bound leaves a margin
    of five."""
    cfg = small_cfg(4, 1, use_pallas=True, pallas_hourglass=False,
                    compute_dtype="bfloat16")
    pn, sn = np_weights(cfg)
    x = images()
    want, _ = jax_apply_cu_net(pn, sn, x, cfg=cfg, train=False)
    params, state = from_jax(pn, sn, cfg=cfg)
    got, _ = apply_cu_net(params, state, torch.from_numpy(x), cfg=cfg)
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        g = g.float().numpy()
        assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w)


def test_predictor_serves_the_block_path(monkeypatch):
    cfg = small_cfg(4, 1, use_pallas=True, pallas_hourglass=False)
    pn, sn = np_weights(cfg)
    imgs = images(n=6, seed=2)
    pairs = np.array([[0, 1]])
    want = JaxPredictor(cfg, pn, sn, batch_size=4, flip_test=True,
                        flip_pairs=pairs).heatmaps(imgs)
    calls = _count(monkeypatch, fused_block, "fused_dense_block_infer")
    pred = Predictor.from_jax_params(cfg, pn, sn, device="cpu", batch_size=4,
                                     flip_test=True, flip_pairs=pairs)
    slots = pred._slots
    assert slots is not None and "vec2" in slots[1]["blocks"][0]
    got = pred.heatmaps(imgs)
    assert pred._slots is slots
    # two chunks of 4, each with its mirror: four forwards of 3 steady slots
    assert len(calls) == 4 * 3 * (2 * cfg.num_blocks + 1)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("case", ["pool_past_tile", "up_rows", "odd_image",
                                  "no_hw", "two_epilogues", "dual_scale"])
def test_table_dot_rejects_what_the_kernel_does_not_take(case):
    """Raised on the CPU as on the card: the checks precede the dispatch.
    The pooled store needs whole 2x2 windows in the 128-row tile."""
    x, v = torch.zeros(2 * 128 * 128, 16), torch.ones(2, 16)
    w, out = torch.zeros(16, 8), torch.zeros(128 * 128 // 2, 8)
    small = torch.zeros(2 * 8 * 8, 16)
    kw = {"pool_past_tile": dict(pool=True, hw=(128, 128)),
          "up_rows": dict(up=(True,), hw=(128, 128)),
          "odd_image": dict(pool=True, hw=(6, 7)),
          "no_hw": dict(pool=True),
          "two_epilogues": dict(bias=torch.zeros(8), vec2=torch.ones(2, 8)),
          "dual_scale": dict(vec2=torch.ones(2, 8), vec_s=v, w_s=w,
                             out_s=torch.zeros(128, 8))}[case]
    feats = [x] if case == "pool_past_tile" else [small]
    if case == "up_rows":        # a half-resolution group of 50 rows, not 32
        feats = [small[:, :8], torch.zeros(50, 8)]
        kw.update(up=(False, True), hw=(8, 8))
    o = out if case == "pool_past_tile" else torch.zeros(
        feats[0].shape[0] // (4 if kw.get("pool") else 1), 8)
    match = {"pool_past_tile": "2 \\* W = 256", "up_rows": "rows",
             "odd_image": "even", "no_hw": "hw=", "two_epilogues": "one",
             "dual_scale": "dual"}[case]
    with pytest.raises(ValueError, match=match):
        eval_ops.table_dot(feats, v, w, o, **kw)
