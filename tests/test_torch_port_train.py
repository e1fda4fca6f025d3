"""Torch port, training on the CPU against the JAX package.

One JAX reference per configuration (``apply_cu_net(train=True,
use_pallas=False, use_scan=False)``: outputs, new ``bn_state`` and the
grads of ``intermediate_mse``) serves every comparison of that
configuration:

- the port's plain train path (autograd through the layer-by-layer ops);
- the port's kernel train path (``use_pallas=True, bn_tile=2``: the slot
  train orchestration and its recompute backward, each kernel wrapper
  computing its plain version on these CPU tensors);
- the port's ``train_step`` (loss, grads, bn_state, and the RMSprop update
  against optax's ``rmsprop(eps_in_sqrt=False)``).

Besides, ``chip_smoke.slot_rel_errors`` (the card smoke's check of one slot,
kernel path against plain path) runs here at small widths, and is shown to
catch a dropped cotangent.

Small widths (c=16, g=8, Cb=16, 4 classes, 2 blocks), 32x32 images, batch
4, ghost-BN tile 2, float32. Tolerances follow tests/test_train_slot.py:
forward 5e-4, loss rtol 1e-4, grads 3e-3 (f32 sums in another order
through ~40 BN layers); the ghost-BN running stats 5e-4.
"""

import dataclasses
import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cunet_tpu.config import TrainConfig
from cunet_tpu.models import apply_cu_net as jax_apply_cu_net
from cunet_tpu.train import eval_step as jax_eval_step
from cunet_tpu.train import make_optimizer as jax_make_optimizer
from cunet_tpu.train.loss import intermediate_mse as jax_mse
from cunet_tpu_torch.kernels import buf_ops, train_ops
from cunet_tpu_torch.models import apply_cu_net
from cunet_tpu_torch.tools.from_jax import flatten_tree
from cunet_tpu_torch.train import (
    create_train_state,
    eval_step,
    get_lr,
    intermediate_mse,
    make_optimizer,
    set_lr,
    train_step,
)

from torch_port_util import from_jax, images, np_weights, small_cfg

FWD = dict(rtol=5e-4, atol=5e-4)
GRAD = dict(rtol=3e-3, atol=3e-3)
STATE = dict(rtol=5e-4, atol=5e-4)
LOSS_RTOL = 1e-4
N, SIZE = 4, 32


def _cfg(layer_num, order, **kw):
    return small_cfg(layer_num, order, bn_tile=2, bn_dtype="compute",
                     remat="none", use_scan=False, **kw)


def _targets(cfg, seed=3):
    return np.random.RandomState(seed).rand(
        N, SIZE // 4, SIZE // 4, cfg.class_num).astype(np.float32)


def _flat_np(tree):
    return flatten_tree(jax.tree_util.tree_map(np.asarray, tree))


@functools.lru_cache(maxsize=None)
def jax_train_reference(layer_num, order):
    """JAX lax-path loss, outputs, new bn_state and grads (flat numpy
    dicts), with the inputs they came from; computed once per config."""
    cfg = _cfg(layer_num, order)
    x, t = images(N, SIZE), _targets(cfg)
    pn, sn = np_weights(cfg)

    def loss(p):
        outs, ns = jax_apply_cu_net(p, sn, x, cfg=cfg, train=True)
        return jax_mse(outs, t), (outs, ns)

    (l, (outs, ns)), g = jax.value_and_grad(loss, has_aux=True)(pn)
    return dict(pn=pn, sn=sn, x=x, t=t, loss=float(l),
                outs=[np.asarray(o) for o in outs], state=_flat_np(ns),
                grads=_flat_np(g))


def port_train(cfg, ref):
    x, t = ref["x"], ref["t"]
    params, state = from_jax(ref["pn"], ref["sn"], cfg=cfg)
    for v in params.values():
        v.requires_grad_(True)
    outs, new_state = apply_cu_net(params, state, torch.from_numpy(x),
                                   cfg=cfg, train=True)
    loss = intermediate_mse(outs, torch.from_numpy(t))
    loss.backward()
    return dict(loss=loss.item(), outs=[o.detach().numpy() for o in outs],
                state={k: v.numpy() for k, v in new_state.items()},
                grads={k: v.grad.numpy() for k, v in params.items()})


# (layer_num, order): steady state from slot 1; a growth phase of two slots
CONFIGS = [(3, 1), (3, 2)]
PATHS = ["plain", "kernel"]


@pytest.fixture(scope="module", params=CONFIGS, ids=lambda c: f"K{c[0]}o{c[1]}")
def case(request):
    cfg = _cfg(*request.param)
    ref = jax_train_reference(*request.param)
    ports = {"plain": port_train(cfg, ref),
             "kernel": port_train(dataclasses.replace(cfg, use_pallas=True),
                                  ref)}
    return ref, ports


@pytest.mark.parametrize("path", PATHS)
def test_train_outputs_and_loss_match_jax(case, path):
    ref, ports = case
    got = ports[path]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
    assert len(got["outs"]) == len(ref["outs"])
    for a, b in zip(got["outs"], ref["outs"]):
        np.testing.assert_allclose(a, b, **FWD)


@pytest.mark.parametrize("path", PATHS)
def test_train_bn_state_matches_jax(case, path):
    ref, ports = case
    got = ports[path]["state"]
    assert set(got) == set(ref["state"])
    moved = 0
    for k, want in ref["state"].items():
        np.testing.assert_allclose(got[k], want, err_msg=k, **STATE)
        moved += not np.array_equal(want, _flat_np(ref["sn"])[k])
    assert moved > 0


@pytest.mark.parametrize("path", PATHS)
def test_train_grads_match_jax(case, path):
    ref, ports = case
    got = ports[path]["grads"]
    assert set(got) == set(ref["grads"])
    for k, want in ref["grads"].items():
        np.testing.assert_allclose(got[k], want, err_msg=k, **GRAD)


def test_kernel_and_plain_paths_agree(case):
    """The two port paths against each other, tighter than against JAX."""
    _, ports = case
    for k, a in ports["plain"]["grads"].items():
        np.testing.assert_allclose(ports["kernel"]["grads"][k], a,
                                   err_msg=k, **GRAD)


# ---------------------------------------------------------------------------
# one slot alone: the card smoke's slot check, at small widths in float32
# ---------------------------------------------------------------------------


def _slot_check(order, i):
    import chip_smoke

    cfg = _cfg(3, order, use_pallas=True)
    params, state = from_jax(*np_weights(cfg), cfg=cfg)
    return chip_smoke.slot_rel_errors(torch, cfg, params, state, N,
                                      SIZE // 4, i, "cpu",
                                      torch.Generator().manual_seed(2))


@pytest.mark.parametrize("order,i", [(1, 1), (2, 2)])
def test_slot_check_kernel_slot_matches_plain_slot(order, i):
    """Every output, running-stat update, input cotangent and weight
    gradient of the kernel slot (plain versions on the CPU) against the
    plain slot, under a cotangent on each output in turn: within the
    gradient tolerance (3e-3) in float32."""
    kern, _ = _slot_check(order, i)
    assert len(kern) == 2 + 3 + (2 * 2 + 1)   # + one per slot output
    for grp, rels in kern.items():
        worst = max(rels, key=rels.get)
        assert rels[worst] <= GRAD["rtol"], (grp, worst, rels[worst])


def test_slot_check_catches_a_dropped_cotangent(monkeypatch):
    """A slot backward that drops the cotangent of down block 0's out32
    is off by relative error 1 on what that cotangent feeds."""
    from cunet_tpu_torch.kernels import train_slot

    orig = train_slot.slot_train_bwd

    def drop(meta, saved, W, cts):
        d_y_out, d_head, d_inter_out, d_out32s = cts
        return orig(meta, saved, W, (d_y_out, d_head, d_inter_out,
                                     [None] + list(d_out32s[1:])))

    monkeypatch.setattr(train_slot, "slot_train_bwd", drop)
    kern, _ = _slot_check(1, 1)
    assert max(kern["grads from out32.down.0"].values()) == pytest.approx(1)
    assert max(kern["grads from inter_out"].values()) <= GRAD["rtol"]


def test_step_limits_scale_with_the_control():
    """The card smoke's limits for a step held to a control: each at most
    CONTROL_FACTOR times the control's difference (or the band above it,
    where tighter); ``step_failures`` names every limit broken."""
    import chip_smoke as cs

    f = cs.CONTROL_FACTOR
    c = dict(loss=1.2e-3, ratio=1.14, cos=0.075, heads=2.3e-3, bn=0.028)
    lim = cs.step_limits(c, controlled=True)
    assert lim["loss"] == pytest.approx(f * c["loss"])
    assert lim["heads"] == pytest.approx(f * c["heads"])
    assert lim["bn"] == pytest.approx(c["bn"] + cs.BN_STATE_REL_L2)
    assert lim["cos"] == pytest.approx(c["cos"] / f)
    assert lim["ratio"] == pytest.approx(
        tuple(c["ratio"] * b for b in cs.GRAD_NORM_RATIO))
    k = dict(c, loss=1.4e-3, cos=0.064, heads=2.6e-3)
    assert cs.step_failures(k, lim) == []
    bad = cs.step_failures(dict(k, ratio=8.5, heads=1.1e-2,
                                loss=float("nan")), lim)
    assert [b.split(" ")[0] for b in bad] == ["loss", "grad-norm", "heads.*"]
    assert cs.step_limits(c, controlled=False)["loss"] == cs.LOSS_REL


# ---------------------------------------------------------------------------
# train_step and the optimizer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def step_case():
    cfg = _cfg(3, 1, use_pallas=True)
    ref = jax_train_reference(3, 1)
    x, t = ref["x"], ref["t"]
    params, state = from_jax(ref["pn"], ref["sn"], cfg=cfg)
    tcfg = TrainConfig(lr=1e-3)
    st = create_train_state(params, state, tcfg)
    st, metrics = train_step(st, {"image": torch.from_numpy(x),
                                  "heatmap": torch.from_numpy(t)}, cfg=cfg)
    return cfg, tcfg, ref, st, metrics


def test_train_step_loss_grads_state(step_case):
    _, _, ref, st, metrics = step_case
    assert st.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["last_out"].numpy(), ref["outs"][-1],
                               **FWD)
    for k, want in ref["grads"].items():
        np.testing.assert_allclose(st.params[k].grad.numpy(), want,
                                   err_msg=k, **GRAD)
    for k, want in ref["state"].items():
        np.testing.assert_allclose(st.bn_state[k].numpy(), want, err_msg=k,
                                   **STATE)


def test_train_step_params_follow_optax(step_case):
    """The updated params against one optax RMSprop step on JAX's grads.
    The first step moves a param by about lr * g / (sqrt(0.01 g^2) + eps),
    i.e. 10 * lr * sign(g); a grad within the f32 noise of zero may take
    either sign, so only params whose |grad| clears that noise are held."""
    _, tcfg, ref, st, _ = step_case
    tx = jax_make_optimizer(tcfg)
    p0 = ref["pn"]
    g = jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(ref["grads"][".".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in path)]),
        p0)
    updates, _ = tx.update(g, tx.init(p0), p0)
    want = _flat_np(optax.apply_updates(p0, updates))
    for k, w in want.items():
        grad = ref["grads"][k]
        sure = np.abs(grad) > 1e-2 * np.abs(grad).max() + 1e-6
        np.testing.assert_allclose(st.params[k].detach().numpy()[sure],
                                   w[sure], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_rmsprop_matches_optax_on_identical_grads():
    """torch.optim.RMSprop(alpha=0.99, eps=1e-8) == optax.rmsprop(decay
    0.99, eps 1e-8, eps_in_sqrt=False), three steps on the same grads."""
    tcfg = TrainConfig(lr=1e-2)
    rng = np.random.RandomState(0)
    p = {"a": rng.randn(5, 3).astype(np.float32),
         "b": rng.randn(7).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) * 0.1
              for k, v in p.items()} for _ in range(3)]
    tx = jax_make_optimizer(tcfg)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    opt = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    topt = make_optimizer(tcfg, tp.values())
    for g in grads:
        upd, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt,
                             jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in tp.items():
            v.grad = torch.from_numpy(g[k])
        topt.step()
    for k in p:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)


def test_lr_get_and_set():
    cfg = _cfg(2, 1)
    params, state = from_jax(*np_weights(cfg), cfg=cfg)
    st = create_train_state(params, state, TrainConfig(lr=2.5e-4))
    assert get_lr(st) == pytest.approx(2.5e-4)
    set_lr(st, 1e-5)
    assert get_lr(st) == pytest.approx(1e-5)
    assert all(g["lr"] == 1e-5 for g in st.opt.param_groups)
    assert all(v.requires_grad and v.dtype == torch.float32
               for v in st.params.values())


def test_eval_step_matches_jax():
    cfg = _cfg(2, 1)
    pn, sn = np_weights(cfg)
    x, t = images(N, SIZE), _targets(cfg)
    want = jax_eval_step(pn, sn, {"image": x, "heatmap": t}, cfg=cfg)
    params, state = from_jax(pn, sn, cfg=cfg)
    got = eval_step(params, state, {"image": torch.from_numpy(x),
                                    "heatmap": torch.from_numpy(t)}, cfg=cfg)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["last_out"].numpy(),
                               np.asarray(want["last_out"]), **FWD)


# ---------------------------------------------------------------------------
# what the train path refuses, counts and imports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("change", [
    # threefry masks draw from a key; a Generator serves the seed form only
    dict(drop_rate=0.2, drop_impl="masks"),
])
def test_unported_train_options_raise(change):
    cfg = dataclasses.replace(_cfg(2, 1), **change)
    params, state = from_jax(*np_weights(_cfg(2, 1)), cfg=cfg)
    st = create_train_state(params, state, TrainConfig())
    batch = {"image": torch.zeros(2, SIZE, SIZE, 3),
             "heatmap": torch.zeros(2, SIZE // 4, SIZE // 4, cfg.class_num)}
    with pytest.raises(ValueError, match="rng="):
        train_step(st, batch, cfg=cfg, generator=torch.Generator())
    assert st.step == 0


def test_cpu_train_step_launches_no_kernel():
    cfg = _cfg(2, 1, use_pallas=True)
    params, state = from_jax(*np_weights(cfg), cfg=cfg)
    st = create_train_state(params, state, TrainConfig())
    buf_ops.reset_launch_counts()
    train_ops.reset_launch_counts()
    st, m = train_step(st, {"image": torch.from_numpy(images(N, SIZE)),
                            "heatmap": torch.from_numpy(_targets(cfg))},
                       cfg=cfg)
    assert np.isfinite(float(m["loss"]))
    assert not any(buf_ops.launch_counts().values())
    assert not any(train_ops.launch_counts().values())


def test_train_package_imports_no_jax():
    code = ("import sys; import cunet_tpu_torch.train, "
            "cunet_tpu_torch.kernels.train_slot; "
            "sys.exit(1 if 'jax' in sys.modules else 0)")
    assert subprocess.run([sys.executable, "-c", code]).returncode == 0
