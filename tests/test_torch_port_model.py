"""Torch port: the whole model and the weight bridge against JAX on the CPU.

- the port's plain forward against JAX ``apply_cu_net(use_pallas=False,
  use_scan=False)``;
- the port's buffer-resident kernel forward (plain kernel versions on the
  CPU) against JAX ``apply_cu_net(use_pallas=True,
  pallas_whole_model=True)``, which runs ``fused_model_buf_infer`` in
  interpret mode here;
- the scanned eval with ``pallas_hourglass=False`` on the port's per-block
  kernels against JAX's, which runs ``fused_block.py`` (#5) there;
- the bridge maps every leaf of the JAX trees, and nothing else.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cunet_tpu.models import apply_cu_net as jax_apply_cu_net
from cunet_tpu.models import init_cu_net as jax_init_cu_net
from cunet_tpu.models.cu_net import stack_steady
from cunet_tpu_torch.kernels import buf_ops
from cunet_tpu_torch.models import apply_cu_net, init_cu_net, param_shapes
from cunet_tpu_torch.tools.from_jax import flatten_tree

from torch_port_util import TOL, from_jax, images, np_weights, small_cfg

# (layer_num, order): steady state from slot 1; growth phase with FIFO
# rotation; no coupling at all
CONFIGS = [(4, 1), (4, 2), (3, 0)]


def _both(cfg, x):
    pn, sn = np_weights(cfg)
    want, _ = jax_apply_cu_net(pn, sn, x, cfg=cfg, train=False)
    params, state = from_jax(pn, sn, cfg=cfg)
    got, _ = apply_cu_net(params, state, torch.from_numpy(x), cfg=cfg)
    assert len(got) == len(want) == len(cfg.anchors)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("layer_num,order", CONFIGS)
def test_plain_forward_matches_jax_lax(layer_num, order):
    cfg = small_cfg(layer_num, order, use_scan=False)
    for g, w in zip(*_both(cfg, images())):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("layer_num,order", CONFIGS)
def test_kernel_forward_matches_jax_whole_model(layer_num, order):
    cfg = small_cfg(layer_num, order, use_pallas=True,
                    pallas_whole_model=True)
    buf_ops.reset_launch_counts()
    for g, w in zip(*_both(cfg, images())):
        np.testing.assert_allclose(g, w, **TOL)
    # CPU tensors take the plain versions: no kernel launched
    assert not any(buf_ops.launch_counts().values())


def test_kernel_forward_matches_plain_forward_bf16():
    """The two forwards of the port agree in bf16 (the kernel path folds
    BN2's scale into the bottleneck weight, so roundings differ)."""
    cfg = small_cfg(4, 2, compute_dtype="bfloat16")
    pn, sn = np_weights(cfg)
    params, state = from_jax(pn, sn, cfg=cfg)
    x = torch.from_numpy(images())
    plain, _ = apply_cu_net(params, state, x, cfg=cfg)
    fused, _ = apply_cu_net(params, state, x, cfg=dataclasses.replace(
        cfg, use_pallas=True, pallas_whole_model=True))
    for a, b in zip(fused, plain):
        assert a.dtype == torch.bfloat16
        rel = (a.float() - b.float()).norm() / b.float().norm()
        assert rel < 3e-2, rel


def test_per_slot_kernels_are_not_ported(monkeypatch):
    """JAX's scanned eval with ``pallas_hourglass=False`` runs its per-block
    kernel (``fused_block.py``, #5) on two or more steady slots; the port
    runs its own (``kernels/fused_block.py``) there, one call per block
    position of each steady slot, and matches JAX. Without the scan, or
    with one steady slot, the same flags run layer by layer on the
    per-bottleneck kernel (#6), as in JAX."""
    from cunet_tpu_torch.kernels import fused_block
    from cunet_tpu_torch.models.cu_net import eval_path

    cfg = small_cfg(4, 1, use_pallas=True, pallas_hourglass=False)
    calls = []
    orig = fused_block.fused_dense_block_infer
    monkeypatch.setattr(fused_block, "fused_dense_block_infer",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    assert eval_path(cfg) == "blocks"
    for g, w in zip(*_both(cfg, images())):
        np.testing.assert_allclose(g, w, **TOL)
    assert len(calls) == 3 * (2 * cfg.num_blocks + 1)
    x = torch.zeros(1, 32, 32, 3)
    short = small_cfg(2, 1, use_pallas=True, pallas_hourglass=False)
    for c in (dataclasses.replace(cfg, use_scan=False), short):
        assert eval_path(c) == "layers"
        p, s = init_cu_net(c, device="cpu")
        outs, _ = apply_cu_net(p, s, x, cfg=c)
        assert len(outs) == len(c.anchors)
    assert len(calls) == 3 * (2 * cfg.num_blocks + 1)


@pytest.mark.parametrize("layer_num,order", CONFIGS)
def test_bridge_maps_every_leaf(layer_num, order):
    cfg = small_cfg(layer_num, order)
    pn, sn = np_weights(cfg)
    params, state = from_jax(pn, sn, cfg=cfg)
    for tree, got in ((pn, params), (sn, state)):
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        want = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path): np.asarray(leaf)
                for path, leaf in leaves}
        assert set(got) == set(want)
        for key, leaf in want.items():
            np.testing.assert_array_equal(got[key].numpy(), leaf)


def test_bridge_key_examples():
    cfg = small_cfg(4, 1)
    params, state = from_jax(*np_weights(cfg), cfg=cfg)
    assert params["hg.down.0.layers.3.bottleneck.conv"].shape == (
        1, 1, 16 + 8, 16)
    assert state["heads.3.norm.mean"].shape == (16,)
    assert params["intermedia.adapters.2.conv"].shape == (1, 1, 32, 16)


def test_bridge_rejects_stacked_and_mismatched_trees():
    cfg = small_cfg(4, 1)
    pn, sn = np_weights(cfg)
    with pytest.raises(ValueError, match="stacked"):
        from_jax(stack_steady(pn, cfg), sn, cfg=cfg)
    pn_missing = dict(pn, heads=pn["heads"][:-1])
    with pytest.raises(ValueError, match="missing"):
        from_jax(pn_missing, sn, cfg=cfg)
    with pytest.raises(ValueError, match="unexpected"):
        from_jax(pn, sn, cfg=small_cfg(3, 1))


def test_init_matches_jax_layout_and_distributions():
    cfg = small_cfg(4, 2)
    jp, js = jax_init_cu_net(jax.random.PRNGKey(0), cfg)
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    p_shapes, s_shapes = param_shapes(cfg)
    for tree, got, shapes in ((jp, params, p_shapes), (js, state, s_shapes)):
        flat = flatten_tree(jax.tree_util.tree_map(np.asarray, tree))
        assert list(got) == list(shapes)
        assert {k: tuple(v.shape) for k, v in flat.items()} == {
            k: tuple(v.shape) for k, v in got.items()}
    conv = params["hg.up.1.layers.2.conv2"]
    bound = 1.0 / (9 * cfg.bottleneck_chan) ** 0.5
    assert conv.abs().max() <= bound and conv.std() > bound / 3
    assert (params["stem.norm.scale"] >= 0).all()
    assert not params["stem.norm.bias"].any()
    assert (state["heads.0.norm.var"] == 1).all()
