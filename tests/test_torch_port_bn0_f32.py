"""Float32 whole-batch BN training (TPU kernel #7 and the mask kernel at
``compute_dtype="float32"``) on the CPU.

(a) Torch mirrors of the float32 backward's arithmetic
(``csrc/bottleneck_kernels.cu``): both operands of each product split
exactly into three bf16 planes (``split_bf16x3``), six plane products a
k16 step in the kernels' order (``gw_product3``; the dW product takes the
same pairs). g W^T over Cout = 128 and dW = r^T g over the rows give the
float64 product to float32 rounding; three passes with g rounded to bf16
fail the float32 n-term limit. The dx mirror at float32 (the recompute,
gate and jacobian unrounded) gives ``bwd_dx_plain``'s bits under one-hot
cotangents, and not with a W plane dropped.

(b) The float32 plans (``reduce_plan`` / ``dx_plan`` with ``f32``, and
``apply``'s float32 product ``buf_ops.dot3_plan``) at every #7 call of the
CU-Net-8 @256 float32 ``bn_tile=0`` step, read from the port's own forward
(183 calls): each fits the H100's shared memory, covers every row and
column once, and is a function of the shapes alone. ``apply``'s float32
product takes any number of feature groups (a table past 16 goes to
device memory), so the guard lets every ``order`` through, and one step
at ``order`` 14 (17 groups at an up block's adapter) runs.

(c) The float32 conv's autograd Function (``ops.layers._Conv2dF32``, the
repair of the float32 conv's TF32 backward): its gradients are autograd's.

(d) One float32 ``bn_tile=0`` dropout step of a two-slot model on the
port's kernel path (the plain versions on the CPU) against JAX's with its
#7 kernel in interpret mode, at tests/test_torch_port_train_bottleneck.py's
tolerances and at float32's own (``F32_STEP_*``, relative L2 per leaf).
"""

import dataclasses
import functools
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import cunet_tpu.kernels.train_bottleneck as jtb
from cunet_tpu.models import apply_cu_net as jax_apply_cu_net
from cunet_tpu.train.loss import intermediate_mse as jax_mse
from cunet_tpu_torch.kernels import buf_ops
from cunet_tpu_torch.kernels import train_bottleneck as tbk
from cunet_tpu_torch.kernels.buf_ops import SMEM_LIMIT
from cunet_tpu_torch.models import apply_cu_net
from cunet_tpu_torch.ops.layers import _Conv2dF32
from cunet_tpu_torch.train import intermediate_mse

from test_torch_port_bf16_split import SUM_REL_PER_SQRT_N, split_bf16x3
from test_torch_port_dropout_train import jax_seeds
from test_torch_port_f32_forms import ORDER
from test_torch_port_gemm_plans import _grids, _items_once
from test_torch_port_train_bottleneck import (
    EPS,
    LOSS_RTOL,
    STEP_FWD,
    STEP_GRAD,
    STEP_STATE,
    flat_np,
)
from torch_port_util import from_jax, images, np_weights, port_cfg, small_cfg

KERNEL = Path(__file__).resolve().parent.parent / \
    "cunet_tpu_torch/csrc/bottleneck_kernels.cu"
# (g plane, W plane) of three passes against g rounded to bf16 once
G_ONE_PASS = ((0, 2), (0, 1), (0, 0))


# ---------------------------------------------------------------------------
# (a) the arithmetic
# ---------------------------------------------------------------------------


def planes_mirror(a, b, order=ORDER):
    """a (M, K) @ b (K, N) as the float32 kernels sum it: K zero-padded to
    16, both split into three bf16 planes, and for each k16 step the plane
    products (a plane, b plane) of ``order`` into one float32
    accumulator."""
    k = a.shape[1]
    kp = -(-k // 16) * 16
    ap = split_bf16x3(torch.nn.functional.pad(a, (0, kp - k)))
    bp = split_bf16x3(torch.nn.functional.pad(b, (0, 0, 0, kp - k)))
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, kp, 16):
        for i, j in order:
            acc = acc + ap[i][:, k0:k0 + 16].float() @ \
                bp[j][k0:k0 + 16].float()
    return acc


def _rel_err(got, a, b):
    want = a.double() @ b.double()
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def _operands(m, c, n, seed):
    """relu(y) of BN-like float32 features, a float32 cotangent g and a
    float32 weight W (c, n), full 24-bit significands."""
    rng = np.random.RandomState(seed)
    r = torch.relu(torch.from_numpy(
        (rng.randn(m, c) * 1.3 + 0.1).astype(np.float32)))
    g = torch.from_numpy(rng.randn(m, n).astype(np.float32))
    w = torch.from_numpy((rng.randn(c, n) * c ** -0.5).astype(np.float32))
    return r, g, w


def test_the_mirror_sums_in_the_kernels_order():
    """The order ``gw_product3``'s comment states is the mirror's."""
    src = KERNEL.read_text()
    stated = re.search(r"terms first: (g1 W3, g2 W2, g1 W2, g3 W1, g2 W1, "
                       r"g1 W1)", src)
    assert stated, "the kernel no longer states its order"
    pairs = [(int(t[1]) - 1, int(t[4]) - 1)
             for t in stated.group(1).split(", ")]
    assert tuple(pairs) == ORDER


def test_g_w_six_products_give_the_float64_product():
    """g W^T over Cout = 128 (the depth of ``bwd_dx``'s and ``bwd_reduce``'s
    g W^T), Ctot = 320: within float32 rounding of the float64 product;
    three passes against bf16(g) miss the float32 128-term limit."""
    _, g, w = _operands(512, 320, 128, 1)
    limit = SUM_REL_PER_SQRT_N * 128 ** 0.5
    six = _rel_err(planes_mirror(g, w.t()), g, w.t())
    one = _rel_err(planes_mirror(g, w.t(), G_ONE_PASS), g, w.t())
    assert six < 2e-6 < 0.02 * limit
    assert one > limit and one > 100 * six


@pytest.mark.parametrize("m", [256, 4096])
def test_dw_six_products_give_the_float64_product(m):
    """dW = r^T g over m rows: the six plane products within float32
    rounding of the float64 product; three passes against bf16(g) (the
    bf16 kernel's arithmetic) miss the float32 m-term limit at m = 256,
    where that limit is below one pass's error."""
    r, g, _ = _operands(m, 64, 128, m)
    limit = SUM_REL_PER_SQRT_N * m ** 0.5
    six = _rel_err(planes_mirror(r.t(), g), r.t(), g)
    one = _rel_err(planes_mirror(r.t(), g, ((2, 0), (1, 0), (0, 0))),
                   r.t(), g)
    assert six < 2e-6
    assert one > 100 * six
    if m == 256:
        assert one > limit


def mirror_bwd_dx_f32(xs, g, stat, bias, red, w, order=ORDER):
    """``bwd_dx`` at float32 in torch: g W^T from the planes of both (k16
    steps over Cout, ``order``), then the recompute, gate and jacobian in
    float32, one rounding per operation, in the kernel's order."""
    x = torch.cat(xs, 1)
    gy = planes_mirror(g, w.t(), order)
    xh = (x - stat[0]) * stat[1]
    gy = torch.where(xh * stat[2] + bias > 0, gy, 0.0)
    return (stat[2] * stat[1]) * ((gy - red[0]) - xh * red[1])


@pytest.mark.parametrize("widths,n", [([128, 128, 32, 32], 128),
                                      ([40, 16, 24], 16)])
def test_dx_mirror_is_exact_under_one_hot_cotangents(widths, n):
    """Row m's cotangent one-hot (1) at n_m = m % n: g_y = W[c, n_m] exactly
    (the pieces of W add back to it), so the mirror gives
    ``bwd_dx_plain``'s float32 bits; a W plane dropped moves them."""
    m, ctot = 512, sum(widths)
    gen = torch.Generator().manual_seed(ctot)
    xs = [torch.randn(m, c, generator=gen) * 2 for c in widths]
    stat = torch.stack([torch.randn(ctot, generator=gen) * 0.1,
                        torch.rand(ctot, generator=gen) + 0.5,
                        torch.rand(ctot, generator=gen) + 0.5])
    bias = torch.randn(ctot, generator=gen) * 0.2
    red = torch.randn(2, ctot, generator=gen) * 0.1
    w = torch.randn(ctot, n, generator=gen)
    g = torch.zeros(m, n)
    g[torch.arange(m), torch.arange(m) % n] = 1
    want = [torch.empty(m, c) for c in widths]
    tbk.bwd_dx_plain(xs, g, stat, bias, red, w, want)
    want = torch.cat(want, 1)
    assert want.dtype == torch.float32 and want.abs().max() > 0
    assert torch.equal(mirror_bwd_dx_f32(xs, g, stat, bias, red, w), want)
    dropped = tuple(p for p in ORDER if p[1] != 2)      # W's third plane
    assert not torch.equal(
        mirror_bwd_dx_f32(xs, g, stat, bias, red, w, dropped), want)


# ---------------------------------------------------------------------------
# (b) the float32 plans at the CU-Net-8 @256 bn_tile=0 step's calls
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _bn0_f32_calls():
    """(M, Ctot, Cout, groups) of every #7 call of one CU-Net-8 @256
    float32 ``bn_tile=0`` train forward at batch 24, read from the port's
    forward at full width on eight 64 x 64 images (16 x 16 at the top of
    each hourglass; at 1 x 1 the 8 rows still make a row tile): M scales
    by 3 x 16 (the backward's two kernels take the forward's shapes)."""
    from cunet_tpu_torch.config import ModelConfig
    from cunet_tpu_torch.models import init_cu_net

    cfg = ModelConfig(layer_num=8, order=1, class_num=16, loss_num=8,
                      compute_dtype="float32", use_pallas=True, bn_tile=0)
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    calls = []

    def recorder(xs, vec, w, out, table=None):
        assert xs[0].dtype == torch.float32
        calls.append((48 * xs[0].shape[0], sum(x.shape[1] for x in xs),
                      w.shape[1], len(xs)))
        return tbk.apply_plain(xs, vec, w, out)

    x = torch.rand(8, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(tbk, "apply", recorder)
        apply_cu_net(params, state, x, cfg=cfg, train=True)
    return calls


def test_the_bn0_f32_step_makes_183_calls():
    calls = _bn0_f32_calls()
    assert len(calls) == 183
    assert {m for m, *_ in calls} == {24 * r * r for r in (64, 32, 16, 8, 4)}
    assert max(k for _, k, _, _ in calls) == 320
    assert {n for _, _, n, _ in calls} == {128}


def test_f32_reduce_plans_fit_every_bn0_call():
    """Chunks of whole 32-row steps partition the rows, 64-column blocks
    cover Ctot, at most one block an SM's worth of blocks; shared memory:
    W's three planes, the BN constants, float32 x / g stages, r's planes,
    the gated x_hat, g's three planes, within the H100's."""
    R, C = tbk.REDUCE_ROWS, tbk.REDUCE_COLS
    for m, ctot, n, _ in sorted(set(_bn0_f32_calls())):
        p = tbk.reduce_plan(m, ctot, n, True)
        assert [i for s in range(p.chunks) for i in p.rows(s, m)] == \
            list(range(m))
        assert p.chunk % R == 0
        assert (p.col_blocks - 1) * C < ctot <= p.col_blocks * C
        assert p.chunks * p.col_blocks <= max(tbk.REDUCE_BLOCKS_F32,
                                              p.col_blocks)
        gs = (p.np + 8) * 2
        assert p.stat_off == 3 * C * gs
        assert p.stage_off == p.stat_off + 4 * C * 4
        assert p.g_off == R * (C * 4 + 16)
        assert p.stage_bytes >= p.g_off + R * (p.np * 4 + 16)
        assert p.pl_off == p.stage_off + p.stages * p.stage_bytes
        assert p.xh_off == p.pl_off + 3 * R * (C + 8) * 2
        assert p.gp_off == p.xh_off + R * (C + 8) * 4
        assert p.smem == p.gp_off + 3 * R * gs <= SMEM_LIMIT
        assert all(v % 16 == 0 for v in (p.stage_off, p.g_off, p.stage_bytes,
                                         p.pl_off, p.xh_off, p.gp_off))
        assert p.stages == 2 and p.smem > SMEM_LIMIT // 2   # one an SM


def test_f32_dx_plans_fit_every_bn0_call():
    """Every (64-row step, 64-column group) once for any persistent grid;
    shared memory: W's planes, the chunks, two float32 x / g stages, g's
    three planes, within the H100's."""
    R, C = tbk.DX_ROWS, tbk.DX_COLS
    for m, ctot, n, _ in sorted(set(_bn0_f32_calls())):
        p = tbk.dx_plan(m, ctot, n, True)
        assert (p.ngrp - 1) * C < ctot <= p.ngrp * C
        for grid in _grids(p.ngrp, p.items(m)):
            assert (_items_once(p.steps(m), p.ngrp, grid) == 1).all()
        gs = (p.np + 8) * 2
        assert p.tbl_off == 3 * C * gs
        assert p.g_off >= R * (C * 4 + 16)
        assert p.stage_bytes >= p.g_off + R * (p.np * 4 + 16)
        assert p.gp_off == p.stage_off + 2 * p.stage_bytes
        assert p.smem == p.gp_off + 3 * R * gs <= SMEM_LIMIT
        assert all(v % 128 == 0 for v in (p.stage_off, p.g_off,
                                          p.stage_bytes, p.gp_off))


def test_f32_apply_plans_fit_every_bn0_call():
    """``apply``'s float32 product: the plan of N = 128 within shared
    memory whatever K (it streams K) and whatever the number of feature
    groups (past 16 its table is read from device memory)."""
    for m, ctot, n, groups in sorted(set(_bn0_f32_calls())):
        assert groups >= 1
        p = buf_ops.dot3_plan(n)
        assert p.smem <= SMEM_LIMIT and p.bn == 128
        assert sum(len(c) for c in p.k_chunks(ctot)) == -(-ctot // p.bk)


@pytest.mark.parametrize("order", [1, 3])
def test_bn0_feature_groups_is_the_most_a_call_reads(order):
    """``bn0_feature_groups`` is the most feature groups a #7 call of the
    train forward reads (an up block's adapter)."""
    from cunet_tpu_torch.config import ModelConfig
    from cunet_tpu_torch.models import init_cu_net
    from cunet_tpu_torch.models.cu_net import bn0_feature_groups

    cfg = ModelConfig(layer_num=order + 2, order=order, loss_num=1,
                      neck_size=2, growth_rate=8, init_chan_num=16,
                      class_num=4, num_blocks=2, compute_dtype="float32",
                      use_pallas=True, bn_tile=0)
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    groups = []

    def recorder(xs, vec, w, out, table=None):
        groups.append(len(xs))
        return tbk.apply_plain(xs, vec, w, out)

    x = torch.rand(8, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(tbk, "apply", recorder)
        apply_cu_net(params, state, x, cfg=cfg, train=True)
    assert max(groups) == bn0_feature_groups(cfg) == order + 3
    assert max(g for *_, g in _bn0_f32_calls()) == 4


@pytest.mark.parametrize("order", [13, 14])
def test_f32_bn0_guard_holds_the_apply_groups(order):
    """float32 whole-batch BN training on the card passes the guard at
    order 13 (16 feature groups at an up block's adapter) and at order 14
    (17, past the 16 a launch carries in its parameters: the table goes to
    device memory), as bf16 does; and the step runs at that order (on the
    CPU on the kernels' plain versions), its up blocks' adapters reading
    order + 3 groups through ``apply``."""
    from cunet_tpu_torch.config import ModelConfig
    from cunet_tpu_torch.models import init_cu_net
    from cunet_tpu_torch.models.cu_net import (
        bn0_feature_groups,
        check_kernel_dtype,
    )

    cfg = ModelConfig(layer_num=order + 1, order=order, loss_num=1,
                      neck_size=2, growth_rate=8, init_chan_num=16,
                      class_num=4, num_blocks=2, compute_dtype="float32",
                      use_pallas=True, bn_tile=0)
    check_kernel_dtype(cfg, "cuda", train=True)
    check_kernel_dtype(dataclasses.replace(cfg, compute_dtype="bfloat16"),
                       "cuda", train=True)
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    groups = []

    def recorder(xs, vec, w, out, table=None):
        groups.append(len(xs))
        return tbk.apply_plain(xs, vec, w, out)

    ps = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbk, "apply", recorder)
        outs, _ = apply_cu_net(ps, state, x, cfg=cfg, train=True)
    sum(o.float().square().mean() for o in outs).backward()
    assert max(groups) == bn0_feature_groups(cfg) == order + 3
    assert all(torch.isfinite(p.grad).all() for p in ps.values()
               if p.grad is not None)


def test_f32_plans_are_functions_of_the_shapes(monkeypatch):
    shapes = sorted({(m, k, n) for m, k, n, _ in _bn0_f32_calls()})

    def plans():
        tbk.reduce_plan.cache_clear()
        tbk.dx_plan.cache_clear()
        return [(tbk.reduce_plan(*s, True), tbk.dx_plan(*s, True))
                for s in shapes]

    want = plans()

    def broken(*a, **k):
        raise AssertionError("a plan asked the device")

    for name in ("get_device_properties", "device_count", "current_device",
                 "is_available"):
        monkeypatch.setattr(torch.cuda, name, broken)
    assert plans() == want
    # the bf16 plans at the same shapes differ: two blocks an SM
    assert all(tbk.reduce_plan(*s).chunks > tbk.reduce_plan(*s, True).chunks
               for s in shapes if s[0] >= 24 * 16 * 16)


# ---------------------------------------------------------------------------
# (c) the float32 conv's Function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 3)])
def test_conv2d_f32_function_gives_autograds_gradients(stride, padding):
    """The Function the port's float32 conv takes on the card (its
    backward under cuDNN's TF32 off) computes autograd's dX and dW; on the
    CPU, bit for bit."""
    gen = torch.Generator().manual_seed(stride)
    x = torch.randn(2, 5, 12, 12, generator=gen)
    w = torch.randn(4, 5, 3 + 4 * (stride - 1), 3 + 4 * (stride - 1),
                    generator=gen)
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    ws = [w.clone().requires_grad_(True) for _ in range(2)]
    y0 = _Conv2dF32.apply(xs[0], ws[0], stride, padding)
    y1 = torch.nn.functional.conv2d(xs[1], ws[1], stride=stride,
                                    padding=padding)
    ct = torch.randn(y1.shape, generator=gen)
    y0.backward(ct)
    y1.backward(ct)
    assert torch.equal(y0, y1)
    assert torch.equal(xs[0].grad, xs[1].grad)
    assert torch.equal(ws[0].grad, ws[1].grad)


# ---------------------------------------------------------------------------
# (d) one float32 bn_tile=0 dropout step against JAX's
# ---------------------------------------------------------------------------

N, SIZE, RATE = 4, 32, 0.25


def _cfg():
    return small_cfg(2, 1, bn_tile=0, bn_dtype="compute", remat="none",
                     use_scan=False, use_pallas=True, drop_rate=RATE)


@functools.lru_cache(maxsize=None)
def _jax_reference():
    """JAX's loss, outputs, new bn_state and grads of one float32 bn_tile=0
    dropout step, its #7 kernel in interpret mode, and the inputs and the
    per-slot seeds its dropout draws."""
    cfg = _cfg()
    assert cfg.compute_dtype == "float32"
    x = images(N, SIZE)
    t = np.random.RandomState(3).rand(N, SIZE // 4, SIZE // 4,
                                      cfg.class_num).astype(np.float32)
    pn, sn = np_weights(cfg)
    rng = jax.random.PRNGKey(7)
    orig = jtb.fused_train_bottleneck

    def loss(p):
        outs, ns = jax_apply_cu_net(p, sn, x, cfg=cfg, train=True, rng=rng)
        return jax_mse(outs, t), (outs, ns)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtb, "fused_train_bottleneck",
                   lambda f, s, b, w, eps=EPS, interp=False:
                   orig(f, s, b, w, eps, True))
        (l, (outs, ns)), g = jax.value_and_grad(loss, has_aux=True)(pn)
    return dict(cfg=cfg, pn=pn, sn=sn, x=x, t=t, seeds=jax_seeds(rng, 2),
                loss=float(l), outs=[np.asarray(o) for o in outs],
                state=flat_np(ns), grads=flat_np(g))


@pytest.fixture(scope="module")
def drop_step():
    ref = _jax_reference()
    params, state = from_jax(ref["pn"], ref["sn"], ref["cfg"])
    for v in params.values():
        v.requires_grad_(True)
    outs, new_state = apply_cu_net(
        params, state, torch.from_numpy(ref["x"]), cfg=port_cfg(ref["cfg"]),
        train=True, drop_seeds=ref["seeds"])
    loss = intermediate_mse(outs, torch.from_numpy(ref["t"]))
    loss.backward()
    return ref, dict(loss=loss.item(), outs=[o.detach().numpy()
                                             for o in outs],
                     state={k: v.numpy() for k, v in new_state.items()},
                     grads={k: v.grad.numpy() for k, v in params.items()})


def test_f32_bn0_dropout_step_loss_outputs_and_state_match_jax(drop_step):
    ref, got = drop_step
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
    assert len(got["outs"]) == len(ref["outs"])
    for a, b in zip(got["outs"], ref["outs"]):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, **STEP_FWD)
    assert set(got["state"]) == set(ref["state"])
    for k, want in ref["state"].items():
        np.testing.assert_allclose(got["state"][k], want, err_msg=k,
                                   **STEP_STATE)


def test_f32_bn0_dropout_step_grads_match_jax(drop_step):
    ref, got = drop_step
    assert set(got["grads"]) == set(ref["grads"])
    for k, want in ref["grads"].items():
        np.testing.assert_allclose(got["grads"][k], want, err_msg=k,
                                   **STEP_GRAD)


# float32 limits of the same step, relative L2 (loss: relative): the
# readings on the CPU are 1.1e-7 (loss), 2.9e-6 (worst output), 2.3e-7
# (worst BN stat), 1.5e-5 (worst grad leaf, stem.norm.scale; median
# 5.2e-6), the plain path (two-
# pass variance, autograd's backward) against JAX's 2.2e-7 / 2.3e-7 /
# 1.0e-5; one bf16 rounding of JAX's grads moves each leaf by 8.1e-4 or
# more, so a bf16-precision fault breaks F32_STEP_LEAF.
F32_STEP_LOSS, F32_STEP_OUT, F32_STEP_STAT, F32_STEP_LEAF = 1e-6, 1e-5, 1e-5, 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_f32_bn0_dropout_step_matches_jax_to_float32(drop_step):
    """The same step at float32's own precision, beside the tolerances
    above: loss, each output, each BN running stat and each grad leaf
    within the F32_STEP limits; JAX's grads rounded once to bf16 break
    the grad limit at every leaf."""
    ref, got = drop_step
    assert abs(got["loss"] - ref["loss"]) <= F32_STEP_LOSS * abs(ref["loss"])
    for a, b in zip(got["outs"], ref["outs"]):
        assert _rel(a, b) <= F32_STEP_OUT
    for k, want in ref["state"].items():
        assert _rel(got["state"][k], want) <= F32_STEP_STAT, k
    leaves = [k for k, v in ref["grads"].items() if np.any(v)]
    assert len(leaves) > 100
    for k in leaves:
        assert _rel(got["grads"][k], ref["grads"][k]) <= F32_STEP_LEAF, k
        bf16 = torch.from_numpy(ref["grads"][k]).bfloat16().float().numpy()
        assert _rel(bf16, ref["grads"][k]) > F32_STEP_LEAF, k


def test_f32_step_gap_tool_on_the_cpu(capsys):
    """``tools/f32_step_gap.py`` at a tiny size on the CPU, where the kernel
    path is the swap step: they agree bit for bit, and the plain path with
    single-pass variance has the swap step's BN stats bit for bit."""
    from cunet_tpu_torch.tools import f32_step_gap

    assert f32_step_gap.main(["--device", "cpu", "--size", "16",
                              "--batch", "8", "--perms", "2"]) == 0
    out = capsys.readouterr().out
    assert "kernel vs swap: loss 0; grads over all 0," in out
    line = next(x for x in out.splitlines()
                if x.startswith("plain1 vs swap:"))
    assert "BN stats over all 0," in line


def test_f32_bn0_dropout_drops(drop_step):
    """The masks are not all ones: the same step without dropout gives
    other outputs."""
    ref, got = drop_step
    cfg0 = port_cfg(dataclasses.replace(ref["cfg"], drop_rate=0.0))
    params, state = from_jax(ref["pn"], ref["sn"], ref["cfg"])
    with torch.no_grad():
        outs0, _ = apply_cu_net(params, state, torch.from_numpy(ref["x"]),
                                cfg=cfg0, train=True)
    assert not np.allclose(got["outs"][-1], outs0[-1].numpy(), atol=1e-3)
