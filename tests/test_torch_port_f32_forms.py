"""The float32 forms of the eval kernels on the CPU: their arithmetic, their
plans and the dtype guard of the kernel paths.

(a) ``dot3_mirror`` states in torch the product of ``csrc/f32_kernels.cu``
(the float32 forms of ``affine_dot``, ``table_dot`` and ``conv3x3``): both
operands split exactly into three bf16 planes (``split_bf16x3``, the split
``bwd_reduce`` already uses), and in each k16 step the six plane products
with i + j <= 4 (1-based) added to one float32 accumulator in the kernel's
order. It gives the float64 product to float32 rounding at the main path's
depths, and the float32 prologue value bit for bit under a one-hot weight;
one bf16 plane of each operand fails both, and x split alone (three
products against a bf16 W) fails the first.

(b) The plans of the float32 forms (``buf_ops.dot3_plan``, which
``affine_dot`` and ``table_dot`` launch with, and ``conv3x3_plan_f32``) at
every call the CU-Net-8 @256 float32 forward makes on the whole-model,
per-slot and per-block paths, the 68-class face head included, read from
the port's own forward at full width: each fits the H100's shared memory,
covers every output once (a split conv's chunks once each), and is a
function of the shapes alone.

(c) ``check_kernel_dtype``: a float32 eval, quantized or not, float32
ghost-BN training (``bn_tile > 0``, plain, with dropout and quantized)
and float32 whole-batch BN training (``bn_tile=0``, every remat policy,
dropout, quantized training) run on the card's kernel paths; float16
raises.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cunet_tpu_torch.config import ModelConfig, QuantConfig
from cunet_tpu_torch.kernels import (
    bottleneck_infer,
    buf_ops,
    eval_ops,
    fused_block,
    hourglass,
    model_buf,
)
from cunet_tpu_torch.kernels.buf_ops import SMEM_LIMIT
from cunet_tpu_torch.models import apply_cu_net, init_cu_net
from cunet_tpu_torch.models.cu_net import check_kernel_dtype

from test_torch_port_bf16_split import SUM_REL_PER_SQRT_N, split_bf16x3
from test_torch_port_gemm_plans import one_thread

KERNEL = Path(__file__).resolve().parent.parent / \
    "cunet_tpu_torch/csrc/f32_kernels.cu"
# (x plane, w plane), 0-based, in the kernel's order: the small terms first
ORDER = ((0, 2), (1, 1), (0, 1), (2, 0), (1, 0), (0, 0))
ONE_PASS = ((0, 0),)
X_SPLIT_ONLY = ((2, 0), (1, 0), (0, 0))


# ---------------------------------------------------------------------------
# (a) the arithmetic
# ---------------------------------------------------------------------------


def dot3_mirror(x, w, order=ORDER, w_planes=3):
    """x (M, K) @ w (K, N) as the kernel sums it: K zero-padded to 16, the
    planes of x and of w (``w_planes`` 1: w rounded to bf16 once), for
    each k16 step the plane products of ``order`` into the 32-deep chunk's
    float32 sum, each chunk's sum added to the output's (``add_acc3``)."""
    k = x.shape[1]
    kp = -(-k // 16) * 16
    xp = split_bf16x3(torch.nn.functional.pad(x, (0, kp - k)))
    wp = split_bf16x3(torch.nn.functional.pad(w, (0, 0, 0, kp - k)))
    if w_planes == 1:
        wp = (wp[0],)
    acc = torch.zeros(x.shape[0], w.shape[1])
    for c0 in range(0, kp, 32):
        part = torch.zeros_like(acc)
        for k0 in range(c0, min(c0 + 32, kp), 16):
            for i, j in order:
                part = part + xp[i][:, k0:k0 + 16].float() @ \
                    wp[j][k0:k0 + 16].float()
        acc = acc + part
    return acc


def _prologue(m, k, seed):
    """relu(x * inv + shift) in float32: BN-like activations with full
    24-bit significands, as the float32 forms' prologue gives them."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32))
    inv = torch.from_numpy(rng.uniform(0.5, 1.5, k).astype(np.float32))
    shift = torch.from_numpy((rng.randn(k) * 0.5).astype(np.float32))
    return torch.relu(x * inv + shift)


def _rel_err(got, x, w):
    want = x.double() @ w.double()
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def test_the_mirror_sums_in_the_kernels_order():
    """The order the kernel's header states is the mirror's."""
    src = KERNEL.read_text()
    stated = re.search(r"//\s+(x1 w3, x2 w2, x1 w2, x3 w1, x2 w1, x1 w1)\n",
                       src)
    assert stated, "the kernel's header no longer states its order"
    names = [(int(t[1]) - 1, int(t[4]) - 1)
             for t in stated.group(1).split(", ")]
    assert tuple(names) == ORDER
    # every product with i + j <= 4 (1-based) once, none other
    assert sorted(ORDER) == sorted((i, j) for i in range(3) for j in range(3)
                                   if i + j <= 2)


@pytest.mark.parametrize("k", [192, 320])
def test_six_products_give_the_float64_product_to_float32_rounding(k):
    """At the main path's depths (K = 192 adapters, K = 320 the up blocks'
    widest), N = 128: within float32 rounding of the float64 product,
    where one bf16 pass and x split alone miss by ~1e-3."""
    x = _prologue(512, k, k)
    w = torch.from_numpy(np.random.RandomState(k + 1).randn(k, 128)
                         .astype(np.float32)) * k ** -0.5
    limit = SUM_REL_PER_SQRT_N * k ** 0.5
    six = _rel_err(dot3_mirror(x, w), x, w)
    one = _rel_err(dot3_mirror(x, w, ONE_PASS, 1), x, w)
    x_only = _rel_err(dot3_mirror(x, w, X_SPLIT_ONLY, 1), x, w)
    assert six < 2e-6 < 0.02 * limit
    assert one > limit and x_only > limit
    assert one > 100 * six and x_only > 100 * six


@pytest.mark.parametrize("k", [24, 192, 320])
def test_one_hot_weight_gives_the_prologue_value_bit_for_bit(k):
    """Column j's one 1 at row r_j: the six products sum 0 + x3 + x2 + x1 =
    x exactly (the card tests hold the kernels to the same); one bf16 pass
    gives bf16(x)."""
    x = _prologue(256, k, 7 * k)
    rows = torch.from_numpy(np.random.RandomState(k).randint(0, k, 64))
    w = torch.zeros(k, 64)
    w[rows, torch.arange(64)] = 1.0
    assert torch.equal(dot3_mirror(x, w), x[:, rows])
    one = dot3_mirror(x, w, ONE_PASS, 1)
    assert not torch.equal(one, x[:, rows])
    assert torch.equal(one, x[:, rows].bfloat16().float())


# ---------------------------------------------------------------------------
# (b) the plans at the CU-Net-8 @256 float32 forward's calls
# ---------------------------------------------------------------------------

SCALE = 16     # the forward runs on 64 x 64 images, a quarter of 256 x 256


def _record(monkeypatch, calls, module, name, shape_of):
    real = getattr(module, name)

    def rec(*a, **k):
        calls.append(shape_of(*a, **k))
        return real(*a, **k)

    monkeypatch.setattr(module, name, rec)


@one_thread()
def _forward_calls(monkeypatch, class_num):
    """(kernel, M, K, N, nout, pool, W) of every 1x1 and 3x3 call the
    CU-Net-8 float32 forward makes on the whole-model, per-slot and
    per-block paths, at full width on one 64 x 64 image, with M and W
    scaled to 256 x 256 (the rows by 16, the image width by 4). On one
    intra-op thread (``one_thread``)."""
    calls = []

    def dot(x, vec, w, out, **kw):
        return ("affine_dot", SCALE * x.shape[0], x.shape[1], w.shape[1], 1,
                False, 0)

    def conv(y, w3p, b, h, w, out, **kw):
        return ("conv3x3", SCALE * y.shape[0], w3p.shape[0], w3p.shape[1],
                1, False, 4 * w)

    def table(feats, vec, w, out, *, out_s=None, pool=False, hw=None,
              **kw):
        m = max(f.shape[0] for f in feats)
        return ("table_dot", SCALE * m, sum(f.shape[1] for f in feats),
                out.shape[-1], 2 if out_s is not None else 1, bool(pool),
                4 * hw[1] if hw else 0)

    for mod in (model_buf,):
        _record(monkeypatch, calls, mod, "affine_dot", dot)
    for mod in (model_buf, hourglass, fused_block):
        _record(monkeypatch, calls, mod, "conv3x3", conv)
    for mod in (hourglass, fused_block, bottleneck_infer):
        _record(monkeypatch, calls, mod, "table_dot", table)
    cfg = ModelConfig(layer_num=8, order=1, class_num=class_num, loss_num=8,
                      compute_dtype="float32", use_pallas=True)
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    x = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    paths = {"whole_model": dict(pallas_whole_model=True),
             "slot": {}, "blocks": dict(pallas_hourglass=False)}
    seen = {}
    with torch.no_grad():
        for name, flags in paths.items():
            before = len(calls)
            apply_cu_net(params, state, x,
                         cfg=dataclasses.replace(cfg, **flags))
            seen[name] = calls[before:]
    return seen


@pytest.fixture(scope="module")
def forward_calls():
    mp = pytest.MonkeyPatch()
    try:
        return {cls: _forward_calls(mp, cls) for cls in (16, 68)}
    finally:
        mp.undo()


def _partition(ranges, total):
    """The ranges cover [0, total) once."""
    hits = np.zeros(total, int)
    for r in ranges:
        hits[r.start:r.stop] += 1
    return (hits == 1).all()


def _plan(kernel, m, k, n, nout, pool, w):
    """The plan each float32 wrapper launches with."""
    if kernel == "conv3x3":
        return buf_ops.conv3x3_plan_f32(m, k // 9, n)
    return buf_ops.dot3_plan(n, nout, pool)


def _blocks(p, m, n):
    """(row, column) ranges of each block's outputs: the kernel's grid."""
    gm, gn = p.grid(m, n)
    return [(range(i * p.bm, min((i + 1) * p.bm, m)),
             range(j * p.bn, min((j + 1) * p.bn, n)))
            for i in range(gm) for j in range(gn)]


def test_forward_calls_reach_every_form(forward_calls):
    """The recorded calls: each path's kernels, at r = 64 ... 4, with
    every option of the per-block path and the 68-class head."""
    for cls, seen in forward_calls.items():
        whole = {c[0] for c in seen["whole_model"]}
        assert whole == {"affine_dot", "conv3x3"}
        assert {c[0] for c in seen["slot"]} == {"table_dot", "conv3x3"}
        blocks = [c for c in seen["blocks"] if c[0] == "table_dot"]
        assert any(c[4] == 2 and c[5] for c in blocks)      # pooled pair
        convs = {c[1] for c in seen["whole_model"] if c[0] == "conv3x3"}
        assert convs == {r * r for r in (64, 32, 16, 8, 4)}
        # the head: the class count, or (whole model) its padded width
        for path in seen.values():
            assert {cls, -(-cls // 8) * 8} & {c[3] for c in path}


def test_f32_plans_fit_cover_and_depend_on_shapes_alone(forward_calls):
    shapes = sorted({c for seen in forward_calls.values()
                     for path in seen.values() for c in path})
    assert len(shapes) > 20
    for kernel, m1, k, n, nout, pool, w in shapes:
        p = _plan(kernel, m1, k, n, nout, pool, w)
        assert p.smem <= SMEM_LIMIT, (kernel, k, n)
        assert p.nout == nout and p.pool == pool
        if pool:
            assert eval_ops.BLOCK_ROWS % (2 * w) == 0
            assert p.bm == eval_ops.BLOCK_ROWS
        for batch in (8, 64, 256):
            m = batch * m1
            q = _plan(kernel, m, k, n, nout, pool, w)
            blocks = _blocks(q, m, n)
            rows = {b[0] for b in blocks}
            cols = {b[1] for b in blocks}
            assert len(blocks) == len(rows) * len(cols)
            assert _partition(rows, m) and _partition(cols, n)
            # a split conv: its splits' chunks cover K's once, in order
            chunks = q.k_chunks(k)
            assert [c for r in chunks for c in r] == \
                list(range(-(-k // q.bk)))
            assert all(len(r) >= 2 for r in chunks)
            if q.splits > 1:
                assert kernel == "conv3x3"
                assert len(blocks) * q.splits <= buf_ops.DOT3_ITEMS
            # the 1x1 plans do not depend on the batch (M) or the depth
            # (the whole-model and per-slot paths sum alike)
            if kernel != "conv3x3":
                assert _plan(kernel, m, k + 8, n, nout, pool, w) == p
        # a function of the shapes: asked again after the caches are
        # cleared, the same plan
        buf_ops.dot3_plan.cache_clear()
        buf_ops.conv3x3_plan_f32.cache_clear()
        assert _plan(kernel, m1, k, n, nout, pool, w) == p


# ---------------------------------------------------------------------------
# (c) the dtype guard
# ---------------------------------------------------------------------------

INT8 = QuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True,
                   int8_infer=True, int8_impl="pallas")


@pytest.mark.parametrize("flags", [{}, dict(pallas_whole_model=True),
                                   dict(pallas_hourglass=False),
                                   dict(pallas_hourglass=False,
                                        use_scan=False)])
def test_f32_eval_on_the_card_passes_the_guard(flags):
    cfg = ModelConfig(layer_num=2, order=1, loss_num=2, class_num=8,
                      compute_dtype="float32", use_pallas=True, **flags)
    check_kernel_dtype(cfg, "cuda")
    check_kernel_dtype(cfg, "cuda:0", quant=dataclasses.replace(
        INT8, enabled=False))


@pytest.mark.parametrize("remat,drop,quant", [
    ("none", 0.0, None), ("layer", 0.0, None), ("block", 0.0, None),
    ("bottleneck", 0.2, None), ("none", 0.0, dataclasses.replace(
        INT8, int8_infer=False))])
def test_f32_bn0_training_passes_the_guard(remat, drop, quant):
    """float32 whole-batch BN training runs on #7's and the mask kernel's
    float32 forms: every remat policy, dropout, W1/I8/G8 training."""
    cfg = ModelConfig(layer_num=2, order=1, loss_num=2, class_num=8,
                      compute_dtype="float32", use_pallas=True, bn_tile=0,
                      remat=remat, drop_rate=drop)
    check_kernel_dtype(cfg, "cuda", train=True, quant=quant)
    check_kernel_dtype(cfg, "cuda:0", train=True)


@pytest.mark.parametrize("bn_tile", [0, 2])
def test_f32_train_and_quantized_eval_on_the_card_raise(bn_tile):
    """float32 passes the guard on every kernel path at every bn_tile:
    training plain, with dropout and W1/I8/G8 (ghost-BN tiles on the
    float32 forms of the slot kernels #8/#9 with their QuanInput options),
    and the quantized eval on the per-slot flags' layer-by-layer path and
    the whole-model int8 path (the int8 kernels' float32 forms); only a
    dtype the kernels do not take (float16) raises."""
    cfg = ModelConfig(layer_num=2, order=1, loss_num=2, class_num=8,
                      compute_dtype="float32", use_pallas=True,
                      bn_tile=bn_tile)
    check_kernel_dtype(cfg, "cuda", train=True)
    check_kernel_dtype(dataclasses.replace(cfg, drop_rate=0.2), "cuda:0",
                       train=True)
    check_kernel_dtype(cfg, "cuda", train=True, quant=INT8)
    check_kernel_dtype(cfg, "cuda", train=True, quant=dataclasses.replace(
        INT8, int8_infer=False))
    for c in (cfg, dataclasses.replace(cfg, pallas_whole_model=True)):
        check_kernel_dtype(c, "cuda", quant=INT8)
    # bf16 on the card, the plain path and the CPU take every case
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    check_kernel_dtype(bf16, "cuda", train=True, quant=INT8)
    check_kernel_dtype(dataclasses.replace(cfg, use_pallas=False), "cuda",
                       train=True, quant=INT8)
    check_kernel_dtype(cfg, "cpu", train=True, quant=INT8)
    for kw in (dict(train=True, quant=INT8), {}):
        with pytest.raises(NotImplementedError, match="bfloat16"):
            check_kernel_dtype(dataclasses.replace(
                cfg, compute_dtype="float16"), "cuda", **kw)
