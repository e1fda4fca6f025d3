"""Torch port: the per-bottleneck train kernel (TPU kernel #7) on the CPU
against the JAX package's ``fused_train_bottleneck`` in interpret mode.

- the port's ``fused_train_bottleneck`` (its four wrappers computing their
  plain versions on CPU tensors) against JAX's, on 1, 2 and 4 feature
  groups of mixed widths, float32 and bfloat16, and on two groups with 160
  outputs (past the 144 the first float32 ``bwd_dx`` kernel took) and, for
  the gradients at float32, 320 (past the 256 whose W planes the
  backward's kernels keep resident): the forward's output, batch mean and
  variance, and the gradients of the features, scale, bias and weight
  under a fixed cotangent;
- what the autograd Function saves: the inputs, the parameters and the two
  statistics only (the counterpart of tests/test_train_kernel.py::
  test_memory_o1_residuals);
- the row-tile rule and its fallback (M not a multiple of 8 takes the plain
  bottleneck with a float32 affine, as JAX does), running statistics
  included;
- one ``train_step`` of a two-slot model at ``use_pallas=True, bn_tile=0``
  against JAX's step with the kernel in interpret mode (monkeypatched as
  tests/test_train_kernel.py::TestModelTrainPallas does; nothing in the
  JAX package changes): loss, outputs, grads, BN state and the RMSprop
  update.

Tolerances: float32 values 1e-5; a bf16 output within one bf16 ulp; the
gradients rtol 2e-4 / atol 2e-5 (JAX's own kernel-against-lax bands,
tests/test_train_kernel.py), bf16 input gradients within one bf16 ulp; the
model step at tests/test_torch_port_train.py's tolerances.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

import cunet_tpu.kernels.train_bottleneck as jtb
from cunet_tpu.config import TrainConfig
from cunet_tpu.models import apply_cu_net as jax_apply_cu_net
from cunet_tpu.ops.bottleneck import (
    dense_bottleneck_train_pallas as jax_train_pallas,
)
from cunet_tpu.train import make_optimizer as jax_make_optimizer
from cunet_tpu.train.loss import intermediate_mse as jax_mse
from cunet_tpu_torch.kernels import train_bottleneck as tb
from cunet_tpu_torch.ops import dense_bottleneck_train_pallas
from cunet_tpu_torch.tools.from_jax import flatten_tree
from cunet_tpu_torch.train import create_train_state, train_step

from torch_port_util import from_jax, images, np_weights, port_cfg, small_cfg

EPS = 1e-5
VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
STEP_FWD = dict(rtol=5e-4, atol=5e-4)
STEP_GRAD = dict(rtol=3e-3, atol=3e-3)
STEP_STATE = dict(rtol=5e-4, atol=5e-4)
LOSS_RTOL = 1e-4
N, H, COUT = 2, 8, 16
GROUPS = {1: [24], 2: [16, 12], 4: [32, 16, 8, 4], "wide": [32, 24],
          "wider": [32, 24]}
# outputs of a case, COUT where not listed: past the 144 the first float32
# bwd_dx kernel took, and past the 256 whose W planes the backward's
# kernels keep resident (three slices of 128)
COUTS = {"wide": 160, "wider": 320}


@pytest.fixture(scope="module", autouse=True)
def _interpret():
    """JAX's kernel in interpret mode wherever the JAX package calls it."""
    orig = jtb.fused_train_bottleneck
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtb, "fused_train_bottleneck",
                   lambda f, s, b, w, eps=EPS, interp=False:
                   orig(f, s, b, w, eps, True))
        yield


def _inputs(widths, n=N, h=H, seed=0, cout=COUT):
    rng = np.random.RandomState(seed)
    feats = [(rng.randn(n, h, h, c) * (0.5 + k) + 0.3 * k).astype(np.float32)
             for k, c in enumerate(widths)]
    ctot = sum(widths)
    scale = rng.uniform(0.5, 1.5, ctot).astype(np.float32)
    bias = (rng.randn(ctot) * 0.2).astype(np.float32)
    w = (rng.randn(1, 1, ctot, cout) * ctot ** -0.5).astype(np.float32)
    ct = rng.randn(n, h, h, cout).astype(np.float32)
    return feats, scale, bias, w, ct


def _cast(a, dtype):
    return a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a


def _np(t):
    return t.detach().float().numpy()


def _one_ulp(got, want):
    """|got - want| within one bf16 ulp of the larger (plus float32 noise
    where the result cancels to near zero)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
    assert np.all(np.abs(got - want) <= ulp + 1e-5 * np.abs(want).max())


def _jax(feats, scale, bias, w, ct, dtype):
    """JAX's forward and the gradients of sum(out * ct) (numpy)."""
    fs = tuple(jnp.asarray(_cast(f, dtype)) for f in feats)

    def loss(fs, scale, bias, w):
        out, _, _ = jtb.fused_train_bottleneck(fs, scale, bias, w, EPS)
        return jnp.sum(out.astype(jnp.float32) * ct)

    out, mean, var = jtb.fused_train_bottleneck(fs, scale, bias, w, EPS)
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(fs, scale, bias, w)
    return ([np.asarray(out.astype(jnp.float32)), np.asarray(mean),
             np.asarray(var)],
            [np.asarray(g.astype(jnp.float32)) for g in grads[0]]
            + [np.asarray(g) for g in grads[1:]])


def _port(feats, scale, bias, w, ct, dtype):
    fs = [torch.from_numpy(f).to(getattr(torch, dtype)).requires_grad_(True)
          for f in feats]
    ps = [torch.from_numpy(a).requires_grad_(True) for a in (scale, bias, w)]
    out, mean, var = tb.fused_train_bottleneck(fs, *ps, EPS)
    (out.float() * torch.from_numpy(ct)).sum().backward()
    return [_np(out), _np(mean), _np(var)], \
        [_np(f.grad) for f in fs] + [_np(p.grad) for p in ps]


@functools.lru_cache(maxsize=None)
def _case(groups, dtype):
    args = _inputs(GROUPS[groups], cout=COUTS.get(groups, COUT))
    return _jax(*args, dtype), _port(*args, dtype), len(GROUPS[groups])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [1, 2, 4, "wide"])
def test_forward_matches_jax(groups, dtype):
    (want, _), (got, _), _ = _case(groups, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got[0], want[0], **VAL)
    else:
        _one_ulp(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):        # mean, var: float32
        np.testing.assert_allclose(a, b, **VAL)


@pytest.mark.parametrize("groups,dtype", [
    (gr, dt) for gr in (1, 2, 4, "wide") for dt in ("float32", "bfloat16")]
    + [("wider", "float32")])
def test_grads_match_jax(groups, dtype):
    (_, want), (_, got), g = _case(groups, dtype)
    for k, (a, b) in enumerate(zip(got, want)):
        if k < g and dtype == "bfloat16":      # input grads in bf16
            _one_ulp(a, b)
        else:
            np.testing.assert_allclose(a, b, err_msg=f"grad {k}", **GRAD)


def test_saves_only_inputs_and_statistics():
    """The Function keeps the features, scale, bias, w, mean and var for
    its backward and nothing of the size of the concat or the ReLU output
    (the recompute's point)."""
    feats, scale, bias, w, _ = _inputs(GROUPS[4])
    fs = [torch.from_numpy(f).requires_grad_(True) for f in feats]
    ps = [torch.from_numpy(a).requires_grad_(True) for a in (scale, bias, w)]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        out, mean, var = tb.fused_train_bottleneck(fs, *ps, EPS)
    keep = fs + ps + [mean, var]
    assert len(saved) == len(keep)
    assert all(any(s is k for k in keep) for s in saved)
    m, ctot = N * H * H, scale.shape[0]
    assert sum(s.numel() for s in saved) < (m * ctot + 2 * ctot
                                            + ctot * COUT) * 2.1
    assert not mean.requires_grad and not var.requires_grad
    assert out.grad_fn is not None


def test_row_tile_matches_jax():
    for m in (1, 7, 8, 9, 24, 96, 100, 384, 1000, 1024, 1032, 98304):
        assert tb.row_tile(m) == jtb._row_tile(m), m


@pytest.mark.parametrize("n,h", [(1, 3), (2, 8)])
def test_train_pallas_dispatch_and_running_stats_match_jax(n, h):
    """``dense_bottleneck_train_pallas``: the kernel at M = 128, the plain
    fallback (float32 affine, whole-batch statistics) at M = 9; output,
    new running statistics (momentum 0.1, unbiased variance) and grads."""
    feats, scale, bias, w, _ = _inputs(GROUPS[2], n=n, h=h, seed=3)
    ctot = scale.shape[0]
    rng = np.random.RandomState(4)
    state = {"mean": (rng.randn(ctot) * 0.1).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, ctot).astype(np.float32)}
    ct = rng.randn(n, h, h, COUT).astype(np.float32)

    def jloss(fs, sc, b, wt):
        p = {"norm": {"scale": sc, "bias": b}, "conv": wt}
        out, ns = jax_train_pallas(list(fs), p, state)
        return jnp.sum(out * ct), (out, ns)

    (_, (jout, jns)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        tuple(map(jnp.asarray, feats)), scale, bias, w)
    fs = [torch.from_numpy(f).requires_grad_(True) for f in feats]
    ps = [torch.from_numpy(a).requires_grad_(True) for a in (scale, bias, w)]
    out, ns = dense_bottleneck_train_pallas(
        fs, {"norm": {"scale": ps[0], "bias": ps[1]}, "conv": ps[2]},
        {k: torch.from_numpy(v) for k, v in state.items()})
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(_np(out), np.asarray(jout), **VAL)
    for k in ("mean", "var"):
        assert not ns[k].requires_grad
        np.testing.assert_allclose(ns[k].numpy(), np.asarray(jns[k]), **VAL)
    got = [f.grad for f in fs] + [p.grad for p in ps]
    for a, b in zip(got, list(jg[0]) + list(jg[1:])):
        np.testing.assert_allclose(_np(a), np.asarray(b), **GRAD)


# ---------------------------------------------------------------------------
# one train step at use_pallas=True, bn_tile=0
# ---------------------------------------------------------------------------


STEP_N, SIZE = 4, 32


def step_cfg(**kw):
    return small_cfg(2, 1, bn_tile=0, bn_dtype="compute", remat="none",
                     use_scan=False, use_pallas=True, **kw)


def step_targets(cfg, seed=3):
    return np.random.RandomState(seed).rand(
        STEP_N, SIZE // 4, SIZE // 4, cfg.class_num).astype(np.float32)


def flat_np(tree):
    return flatten_tree(jax.tree_util.tree_map(np.asarray, tree))


@functools.lru_cache(maxsize=None)
def jax_step_reference(**kw):
    """JAX's loss, outputs, new bn_state and grads (flat numpy dicts) of
    ``step_cfg(**kw)`` (its kernel in interpret mode: the module's
    ``_interpret``), and the inputs."""
    cfg = step_cfg(**kw)
    x, t = images(STEP_N, SIZE), step_targets(cfg)
    pn, sn = np_weights(cfg)

    def loss(p):
        outs, ns = jax_apply_cu_net(p, sn, x, cfg=cfg, train=True)
        return jax_mse(outs, t), (outs, ns)

    (l, (outs, ns)), g = jax.value_and_grad(loss, has_aux=True)(pn)
    return dict(cfg=cfg, pn=pn, sn=sn, x=x, t=t, loss=float(l),
                outs=[np.asarray(o) for o in outs], state=flat_np(ns),
                grads=flat_np(g))


@pytest.fixture(scope="module")
def step_case():
    ref = jax_step_reference()
    params, state = from_jax(ref["pn"], ref["sn"], cfg=ref["cfg"])
    tcfg = TrainConfig(lr=1e-3)
    st = create_train_state(params, state, tcfg)
    st, metrics = train_step(st, {"image": torch.from_numpy(ref["x"]),
                                  "heatmap": torch.from_numpy(ref["t"])},
                             cfg=port_cfg(ref["cfg"]))
    return ref, tcfg, st, metrics


def test_train_step_loss_outputs_and_state_match_jax(step_case):
    ref, _, st, metrics = step_case
    assert st.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["last_out"].numpy(), ref["outs"][-1],
                               **STEP_FWD)
    assert set(st.bn_state) == set(ref["state"])
    moved = 0
    for k, want in ref["state"].items():
        np.testing.assert_allclose(st.bn_state[k].numpy(), want, err_msg=k,
                                   **STEP_STATE)
        assert not st.bn_state[k].requires_grad
        moved += not np.array_equal(want, flat_np(ref["sn"])[k])
    assert moved > 0


def test_train_step_grads_match_jax(step_case):
    ref, _, st, _ = step_case
    assert set(st.params) == set(ref["grads"])
    for k, want in ref["grads"].items():
        np.testing.assert_allclose(st.params[k].grad.numpy(), want,
                                   err_msg=k, **STEP_GRAD)


def test_train_step_params_follow_optax(step_case):
    """The updated params against one optax RMSprop step on JAX's grads,
    where the grad clears the float32 noise around zero (see
    tests/test_torch_port_train.py::test_train_step_params_follow_optax)."""
    ref, tcfg, st, _ = step_case
    tx = jax_make_optimizer(tcfg)
    p0 = ref["pn"]
    g = jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(ref["grads"][".".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in path)]),
        p0)
    updates, _ = tx.update(g, tx.init(p0), p0)
    want = flat_np(optax.apply_updates(p0, updates))
    for k, w in want.items():
        grad = ref["grads"][k]
        sure = np.abs(grad) > 1e-2 * np.abs(grad).max() + 1e-6
        np.testing.assert_allclose(st.params[k].detach().numpy()[sure],
                                   w[sure], rtol=1e-5, atol=1e-6, err_msg=k)


def test_smoke_stats_limits_catch_planted_faults():
    """The card smoke's statistics check at its r=64 adapter shape holds
    each feature group's sums and sums of squares to their own scale: a
    sum in another order (float64, rounded once) passes, and each planted
    fault of ``chip_smoke.stats_faults`` (group 0 read at half its row
    stride, one row chunk of group 0 lost, group 0's sum row zeroed; the
    plain version standing in for the kernel on the CPU) breaks a limit."""
    import chip_smoke as cs

    o = cs.tb_operands(torch, torch.Generator().manual_seed(9), 64,
                       dev="cpu")
    want = tb.stats_plain(o["feats"], torch.empty(2, o["k"]))
    other = torch.cat([torch.stack([f.double().sum(0),
                                    (f.double() ** 2).sum(0)])
                       for f in o["feats"]], 1).float()
    bnd = [("sum", o["m"], "cols")]
    assert cs.output_errors(torch, [other], [want], bnd)[2]
    faults = cs.stats_faults(torch, tb, o)
    assert len(faults) == 3
    for name, err, _, share in faults:
        assert share > 1, (name, err)
