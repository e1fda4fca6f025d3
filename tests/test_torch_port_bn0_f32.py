"""Float32 whole-batch BN training (TPU kernel #7 and the mask kernel at
``compute_dtype="float32"``) on the CPU.

(a) Torch mirrors of the float32 backward's arithmetic
(``csrc/bottleneck_kernels.cu``): both operands of each product split
exactly into three bf16 planes (``split_bf16x3``), six plane products a
k16 step in the kernels' order (``gw_product3``; the dW product takes the
same pairs). g W^T over Cout = 128 and dW = r^T g over the rows give the
float64 product to float32 rounding; three passes with g rounded to bf16
fail the float32 n-term limit. The dx mirror at float32 (g's planes as
the reduce's pre-pass writes them, ``split_planes_plain``, read back core
matrix by core matrix as the kernel reads them; the recompute, gate and
jacobian unrounded) gives ``bwd_dx_plain``'s bits under one-hot
cotangents, at 128 outputs and at 192 and 256 (two halves of the
planes), and not with a W plane dropped. ``stats``' float32 sums
(``tb_stats_f32_mirror``: 8-row float32 partials in float64, rounded
once) against its plain version, JAX's ``_stats_kernel`` in interpret
mode and float64, the variance they imply no farther from float64 than
the plain version's.

(b) The float32 plans (``reduce_plan_f32``, ``dx_f32_plan``, and
``apply``'s float32 product ``buf_ops.dot3_plan``) at every #7 call of the
CU-Net-8 @256 float32 ``bn_tile=0`` step, read from the port's own forward
(183 calls): each fits the H100's shared memory, covers every row and
column once, and is a function of the shapes alone; the plans of both
backward kernels at float32 and bf16 at every call of the step at
``neck_size * growth_rate`` and ``init_chan_num`` of 128 ... 256, and
``check_kernel_dtype`` refusing up front what no plan takes.
``apply``'s float32 product takes any number of feature groups (a table
past 16 goes to device memory), so the guard lets every ``order``
through, and one step at ``order`` 14 (17 groups at an up block's
adapter) runs.

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
from test_torch_port_gemm_plans import _grids, _items_once, one_thread
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


def planes_mirror(a, b, order=ORDER, ap=None):
    """a (M, K) @ b (K, N) as the float32 kernels sum it: K zero-padded to
    16, both split into three bf16 planes (``ap``: a's, given), and for
    each k16 step the plane products (a plane, b plane) of ``order`` into
    one float32 accumulator."""
    k = a.shape[1]
    kp = -(-k // 16) * 16
    if ap is None:
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


def kernel_g_planes(g):
    """g's three bf16 planes as ``bwd_dx``'s float32 kernel reads them:
    written by the reduce's pre-pass (``split_planes_plain``, its layout:
    per 64-row tile t and half h of 128 outputs, core matrix (n group,
    m group) at ((n / 8) * 8 + m / 8) * 64 elements, one output's 8 rows a
    core matrix row) and read back core matrix by core matrix, the outputs
    padded to 16 (the halves' k16 steps in ascending order)."""
    m, n = g.shape
    planes = torch.full(tbk.split_planes_shape(m, n), float("nan"),
                        dtype=torch.bfloat16)
    tbk.split_planes_plain(g, planes)
    tiles, halves = planes.shape[1], planes.shape[2] // (128 * 64)
    cores = planes.view(3, tiles, halves, 16, 8, 8, 8)   # t h ng mg nr mr
    full = cores.permute(0, 1, 4, 6, 2, 3, 5).reshape(3, tiles * 64,
                                                      halves * 128)
    return full[:, :m, :-(-n // 16) * 16]


def mirror_bwd_dx_f32(xs, g, stat, bias, red, w, order=ORDER):
    """``bwd_dx`` at float32 in torch: g W^T from the planes of both (g's as
    the kernel reads them, ``kernel_g_planes``; k16 steps over Cout
    ascending, through every half or slice of 128 outputs, ``order``),
    then the recompute, gate and jacobian in float32, one rounding per
    operation, in the kernel's order."""
    x = torch.cat(xs, 1)
    gy = planes_mirror(g, w.t(), order, ap=kernel_g_planes(g))
    xh = (x - stat[0]) * stat[1]
    gy = torch.where(xh * stat[2] + bias > 0, gy, 0.0)
    return (stat[2] * stat[1]) * ((gy - red[0]) - xh * red[1])


@pytest.mark.parametrize("widths,n", [([128, 128, 32, 32], 128),
                                      ([40, 16, 24], 16),
                                      ([64, 40, 88], 192),
                                      ([128, 32], 256),
                                      ([64, 40, 88], 320)])
def test_dx_mirror_is_exact_under_one_hot_cotangents(widths, n):
    """Row m's cotangent one-hot (1) at n_m = m % n: g_y = W[c, n_m] exactly
    (the pieces of W add back to it), so the mirror gives
    ``bwd_dx_plain``'s float32 bits, past 128 outputs across both halves of
    g's planes, past 256 across its three slices (W's planes staged with
    each); a W plane dropped moves them."""
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


def tb_stats_f32_mirror(x):
    """#7's ``stats`` at float32 (``tb_stats_f32_kernel`` then
    ``tb_stats_sum_kernel``) in torch over the concat x (M, Ctot): chunks
    of ``row_chunk(M)`` rows; in a chunk each of 16 row stripes sums 8 of
    its rows at a time (16 apart) in float32, the squares by fma, those
    partials in float64; the stripes in order, then the chunks in order,
    in float64, rounded once."""
    m, c = x.shape
    chunk = tbk.row_chunk(m)
    S = -(-m // chunk)
    span = -(-chunk // 128) * 128               # 8 rows x 16 stripes a step
    xs = torch.nn.functional.pad(x, (0, 0, 0, S * chunk - m))
    xs = torch.nn.functional.pad(xs.view(S, chunk, c),
                                 (0, 0, 0, span - chunk))
    v = xs.view(S, span // 128, 8, 16, c)
    s = torch.zeros(S, 16, c, dtype=torch.float64)
    q = torch.zeros_like(s)
    for step in range(span // 128):
        ps = torch.zeros(S, 16, c)
        pq = torch.zeros_like(ps)
        for j in range(8):
            r = v[:, step, j]
            ps = ps + r
            pq = (r.double() * r.double() + pq.double()).float()   # fma
        s, q = s + ps.double(), q + pq.double()
    out = torch.zeros(2, c, dtype=torch.float64)
    for i in range(S):                          # the chunks in order
        part = torch.zeros(2, c, dtype=torch.float64)
        for rs in range(16):                    # the stripes in order
            part = part + torch.stack([s[i, rs], q[i, rs]])
        out = out + part
    return out.float()


@pytest.mark.parametrize("shift", [0.0, 4.0])
def test_stats_f32_sums_in_float64(shift):
    """#7's ``stats`` at float32 in its kernel's order
    (``tb_stats_f32_mirror``; M = 4,096: 64 chunks of 64 rows): within the
    float32 limit of its plain version and of JAX's ``_stats_kernel`` in
    interpret mode, each sum of squares within two float32 roundings of
    float64 (the sums within that and the float32 roundings of their
    8-row partials, 2^-24 sqrt(M) max|x|), and
    the single-pass variance E[x^2] - mean^2 it implies no farther from
    float64 than the plain version's, on x ~ N(0, 1) and on a cancelling
    x ~ 4 + N(0, 1) (mean^2 / var ~ 16; the plain float32 sums lose
    several ulp there, which the variance multiplies by 17)."""
    rng = np.random.default_rng(7)
    widths, m = (32, 32, 16, 16), 4096
    xs = [torch.from_numpy((rng.standard_normal((m, w)) + shift)
                           .astype(np.float32)) for w in widths]
    x = torch.cat(xs, 1)
    got = tb_stats_f32_mirror(x)
    plain = tbk.stats_plain(xs, torch.empty(2, x.shape[1]))
    jax_out = torch.from_numpy(np.array(jtb._stats(
        [f.numpy() for f in xs], x.shape[1], jtb._row_tile(m), m,
        interpret=True)))
    for ref in (plain, jax_out):
        lim = SUM_REL_PER_SQRT_N * m ** 0.5 * ref.abs().max(1).values
        assert ((got - ref).abs().max(1).values <= lim).all()
    x64 = x.double()
    want = torch.stack([x64.sum(0), (x64 * x64).sum(0)])
    err = (got.double() - want).abs()
    assert (err[1] <= 2.0 ** -23 * want[1]).all()
    # the sums cancel: their float32 partials' roundings scale with |x|
    assert (err[0] <= 2.0 ** -23 * want[0].abs()
            + 2.0 ** -24 * m ** 0.5 * x64.abs().max()).all()

    def var_err(sums):
        mean = sums[0].double() / m
        var = sums[1].double() / m - mean * mean
        var64 = x64.var(0, unbiased=False)
        return ((var - var64).abs() / var64).max().item()

    assert var_err(got) <= var_err(plain)


# ---------------------------------------------------------------------------
# (b) the float32 plans at the CU-Net-8 @256 bn_tile=0 step's calls
# ---------------------------------------------------------------------------


# (neck_size, growth_rate, init_chan_num) of a CU-Net-8 whose #7 calls
# all have one cotangent width: 128 (the default's), 144, 160, 192, 256,
# and past the 256 whose W planes the backward keeps resident 264, 320,
# 512, 1040 (the last not a multiple of 128)
BN0_WIDTHS = {128: (4, 32, 128), 144: (3, 48, 144), 160: (5, 32, 160),
              192: (4, 48, 192), 256: (4, 64, 256), 264: (3, 88, 264),
              320: (5, 64, 320), 512: (4, 128, 512), 1040: (5, 208, 1040)}


def _bn0_cfg(width=128, dtype="float32"):
    """CU-Net-8 at ``BN0_WIDTHS[width]``; past 256 outputs CU-Net-2 (the
    same calls but fewer: a wide model's weights take seconds to draw on
    the CPU)."""
    from cunet_tpu_torch.config import ModelConfig

    neck, growth, init = BN0_WIDTHS[width]
    layers = 8 if width <= tbk.WIDE_N else 2
    return ModelConfig(layer_num=layers, order=1, class_num=16,
                       loss_num=layers,
                       neck_size=neck, growth_rate=growth,
                       init_chan_num=init, compute_dtype=dtype,
                       use_pallas=True, bn_tile=0)


def _bn0_f32_calls(width=128, dtype="float32"):
    """``_bn0_calls_of(width, dtype)``: one forward per (width, dtype) in
    a module, whichever way the caller spells the defaults."""
    return _bn0_calls_of(width, dtype)


@functools.lru_cache(maxsize=None)
@one_thread()
def _bn0_calls_of(width, dtype):
    """(M, Ctot, Cout, groups) of every #7 call of one CU-Net-8 @256
    ``bn_tile=0`` train forward at batch 24 (float32 by default; the
    widths of ``BN0_WIDTHS[width]``), read from the port's forward on
    eight 64 x 64 images (16 x 16 at the top of each hourglass; at 1 x 1
    the 8 rows still make a row tile): M scales by 3 x 16 (the backward's
    two kernels take the forward's shapes). Past 256 outputs (a wide, slow
    forward on the CPU) two images, M scaled by 12 x 16. On one intra-op
    thread (``one_thread``)."""
    from cunet_tpu_torch.models import init_cu_net

    cfg = _bn0_cfg(width, dtype)
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    calls = []

    def recorder(xs, vec, w, out, table=None):
        assert xs[0].dtype == getattr(torch, dtype)
        calls.append((24 // images * 16 * xs[0].shape[0],
                       sum(x.shape[1] for x in xs), w.shape[1], len(xs)))
        return tbk.apply_plain(xs, vec, w, out)

    images = 8 if width <= tbk.WIDE_N else 2
    x = torch.rand(images, 64, 64, 3,
                   generator=torch.Generator().manual_seed(1))
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
    """Chunks of whole 64-row steps partition the rows, 64-column blocks
    cover Ctot, at most one block an SM's worth of blocks; shared memory:
    W's three planes, two buffers of float32 x rows and g's three planes
    (the first also the sums' reduction after the last step), the BN
    constants, within the H100's."""
    R, C = tbk.REDUCE_ROWS_F32, tbk.REDUCE_COLS
    for m, ctot, n, _ in sorted(set(_bn0_f32_calls())):
        p = tbk.reduce_plan_f32(m, ctot, n)
        assert [i for s in range(p.chunks) for i in p.rows(s, m)] == \
            list(range(m))
        assert [i for s in range(p.chunks) for st in p.steps(s, m)
                for i in st] == list(range(m))
        assert p.chunk % R == 0
        assert (p.col_blocks - 1) * C < ctot <= p.col_blocks * C
        assert p.chunks * p.col_blocks <= max(tbk.REDUCE_BLOCKS_F32,
                                              p.col_blocks)
        assert p.wpl == C * p.np * 2 and p.stage_off >= 3 * p.wpl
        assert p.g_off == R * (C + 4) * 4
        assert p.stage_bytes >= p.g_off + 3 * R * tbk.REDUCE_N_F32 * 2
        assert p.stage_bytes >= 8 * C * 4
        assert p.stat_off == p.stage_off + 2 * p.stage_bytes
        assert p.smem == p.stat_off + 4 * C * 4 <= SMEM_LIMIT
        assert all(v % 128 == 0 for v in (p.stage_off, p.g_off,
                                          p.stage_bytes, p.stat_off))
        assert p.smem > SMEM_LIMIT // 2   # one an SM


def _check_dx_f32_plan(m, ctot, n):
    """``dx_f32_plan`` at one call: every (64-row step, 64-column group)
    once for any persistent grid, a step one tile of g's planes (the
    reduce's pre-pass's) in its halves; shared memory: W's three planes of
    the group's columns, each warpgroup's g stage (a half's three planes)
    and x stage (a step's rows), the BN constants and the x / dx chunks,
    within the H100's."""
    R, C = tbk.DX_ROWS, tbk.DX_COLS
    p = tbk.dx_f32_plan(m, ctot, n)
    assert R == tbk.REDUCE_ROWS_F32
    assert (p.ngrp - 1) * C < ctot <= p.ngrp * C
    for grid in _grids(p.ngrp, p.items(m)):
        assert (_items_once(p.steps(m), p.ngrp, grid) == 1).all()
    assert p.np == -(-n // 16) * 16 and p.halves == -(-p.np // 128)
    assert tbk.split_planes_shape(m, n) == (3, p.steps(m),
                                            p.halves * 128 * R)
    # past WIDE_N no W plane is resident: each warpgroup stages its half's
    wide = p.np > tbk.WIDE_N
    assert p.wpl == (0 if wide else C * p.np * 2) and p.g_off == 3 * p.wpl
    assert p.x_off == p.g_off + 2 * 3 * 128 * R * 2
    assert p.sw_off == (p.x_off + 2 * R * C * 4 if wide else 0)
    assert p.kon_off == p.x_off + 2 * R * C * 4 + (2 * 3 * 128 * R * 2
                                                   if wide else 0)
    assert p.ch_off == p.kon_off + 32 * C
    assert p.smem == p.ch_off + 2 * (C // 8) * 16 <= SMEM_LIMIT
    assert all(v % 128 == 0 for v in (p.wpl, p.g_off, p.x_off, p.kon_off,
                                      p.sw_off))
    return p


def test_f32_dx_plans_fit_every_bn0_call():
    """``dx_f32_plan`` (``_check_dx_f32_plan``) at every call of the
    float32 step; r=64's calls in 128-column blocks."""
    for m, ctot, n, _ in sorted(set(_bn0_f32_calls())):
        _check_dx_f32_plan(m, ctot, n)


@pytest.mark.parametrize("width", sorted(BN0_WIDTHS))
def test_backward_plans_fit_every_bn0_call_at_width(width):
    """At ``neck_size * growth_rate`` = ``init_chan_num`` = 128 ... 1040 the
    backward's plans at every #7 call of a float32 and of a bf16
    ``bn_tile=0`` step (each step's calls read from its own forward):
    ``dx_f32_plan`` and ``reduce_plan_f32``, ``dx_plan`` and
    ``reduce_plan``, each within the H100's shared memory (past 256
    outputs with W's planes staged, none resident); and
    ``check_kernel_dtype`` lets both configurations through."""
    from cunet_tpu_torch.models.cu_net import check_kernel_dtype

    f32, bf16 = (sorted(set(_bn0_f32_calls(width, dt)))
                 for dt in ("float32", "bfloat16"))
    assert f32 == bf16 and len(f32) > 10
    assert {n for _, _, n, _ in f32} == {width}
    for m, ctot, n, _ in f32:
        _check_dx_f32_plan(m, ctot, n)
        wide = -(-n // 16) * 16 > tbk.WIDE_N
        for p in (tbk.reduce_plan_f32(m, ctot, n), tbk.dx_plan(m, ctot, n),
                  tbk.reduce_plan(m, ctot, n)):
            assert p.smem <= SMEM_LIMIT
            assert bool(getattr(p, "w_off", 0) or getattr(p, "sw_off", 0)
                        or getattr(p, "wpl", 1) == 0) == wide
    for dt in ("float32", "bfloat16"):
        check_kernel_dtype(_bn0_cfg(width, dt), "cuda", train=True)


@pytest.mark.parametrize("neck,growth,init,bn_tile,dtype", [
    (5, 64, 128, 0, "float32"),      # neck_size * growth_rate = 320
    (5, 64, 128, 0, "bfloat16"),
    (4, 32, 320, 0, "bfloat16"),     # init_chan_num = 320
    (4, 32, 264, 2, "float32"),      # a ghost-BN cotangent of 264
])
def test_check_kernel_dtype_refuses_what_no_plan_takes(neck, growth, init,
                                                       bn_tile, dtype):
    """The configurations whose cotangents once passed every plan of #7's
    backward (at either dtype) and of the ghost-BN ``affine_dx[f32]``, past
    256 outputs: no plan refuses them now (W's planes staged a slice at a
    time), so ``check_kernel_dtype`` lets their training on the card
    through, as it does on the CPU, in eval and off the kernels; and each
    plan that takes their widest cotangent fits the H100's shared memory.
    A float32 ``bn_tile=0`` model at ``growth_rate=48`` (192 outputs)
    passes."""
    from cunet_tpu_torch.kernels import train_ops
    from cunet_tpu_torch.models.cu_net import check_kernel_dtype

    cfg = dataclasses.replace(_bn0_cfg(), neck_size=neck, growth_rate=growth,
                              init_chan_num=init, bn_tile=bn_tile,
                              compute_dtype=dtype)
    wide = max(neck * growth, init)
    check_kernel_dtype(cfg, "cuda", train=True)
    if bn_tile:
        plans = [train_ops.affine_dx_f32_plan(wide, wide)]
    else:
        shape = (tbk.DX_ROWS, wide, wide)
        plans = ([tbk.reduce_plan_f32(*shape), tbk.dx_f32_plan(*shape)]
                 if dtype == "float32"
                 else [tbk.reduce_plan(*shape), tbk.dx_plan(*shape)])
    assert all(p.smem <= SMEM_LIMIT for p in plans)
    check_kernel_dtype(cfg, "cpu", train=True)
    check_kernel_dtype(cfg, "cuda")
    check_kernel_dtype(dataclasses.replace(cfg, use_pallas=False), "cuda",
                       train=True)
    check_kernel_dtype(dataclasses.replace(_bn0_cfg(), growth_rate=48),
                       "cuda", train=True)


def test_f32_apply_plans_fit_every_bn0_call():
    """``apply``'s float32 product (the float32 forward 1x1,
    ``buf_ops.fwd_f32_plan``): its plan of N = 128 within shared memory
    whatever K (past K = 384 it streams W) and whatever the number of
    feature groups (past 16 its table is read from device memory), its
    column blocks holding N, its slices every 32-deep chunk of K."""
    for m, ctot, n, groups in sorted(set(_bn0_f32_calls())):
        assert groups >= 1
        p = buf_ops.fwd_f32_plan(ctot, n)
        assert p.smem <= SMEM_LIMIT and p.nkb * p.ncol >= n == 128
        assert p.kp == -(-ctot // 32) * 32
        assert p.slices == -(-p.kp // buf_ops.FWD_F32_SLICE)


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
        tbk.reduce_plan_f32.cache_clear()
        tbk.dx_f32_plan.cache_clear()
        return [(tbk.reduce_plan_f32(*s), tbk.dx_f32_plan(*s))
                for s in shapes]

    want = plans()

    def broken(*a, **k):
        raise AssertionError("a plan asked the device")

    for name in ("get_device_properties", "device_count", "current_device",
                 "is_available"):
        monkeypatch.setattr(torch.cuda, name, broken)
    assert plans() == want
    # the bf16 plans at the same shapes differ: two blocks an SM
    assert all(tbk.reduce_plan(*s).chunks > tbk.reduce_plan_f32(*s).chunks
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
