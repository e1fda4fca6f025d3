"""Torch port on the card: each CUDA kernel against its plain version at the
small test widths (c=16, g=8, Cb=16; widths down to 8, ragged row tiles),
the kernel forward against the plain forward, a two-slot kernel train
step against the plain train step, the int8 kernels bit-identical to
their plain versions (K tails, ragged rows, unaligned int8 rows, the
head's image-major view), alone and in the quantized forward, the
train kernels' options: the dropout-mask kernel bit for bit, QuanInput's
prologues and straight-through gate, a two-slot step with each; the
feature-table kernel's forms and the eval paths over it: per slot (#4),
per bottleneck (#6), per block (#5, with the upsample and the pool
folded into the product), and the value-carried whole-model evals (#3,
#2); the float32 forms of the eval kernels (every form against its plain
version at float32 within the float32 n-term bound and bit for bit under
one-hot weights, the conv's split K, the eval paths at float32); the
float32 forms of #7 and of the mask kernel (against their plain versions
at r=64 and r=4, bit for bit under one-hot operands, the Function's
gradients), the float32 conv's backward with TF32 on globally, and the
float32 bn_tile=0 step. Skips
without a CUDA device. Imports no JAX, so it runs on a machine without
it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import dataclasses
import itertools

import pytest
import torch

from cunet_tpu_torch.config import ModelConfig
from cunet_tpu_torch.kernels import buf_ops, drop_ops, quant_ops
from cunet_tpu_torch.models import apply_cu_net, init_cu_net

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator().manual_seed(0)


def _bf16(gen, *shape):
    return torch.randn(*shape, generator=gen).to("cuda", torch.bfloat16)


def _vec(gen, k):
    return torch.stack([torch.rand(k, generator=gen) + 0.5,
                        torch.randn(k, generator=gen) * 0.5]).cuda()


def _close(got, want):
    got, want = got.float(), want.float()
    bound = 2e-2 * want.abs().max().item() + 1e-2
    assert (got - want).abs().max().item() <= bound


def _check(kernel, call, dst, sel):
    """Kernel and plain version into clones of ``dst``; compare the view
    ``sel`` (an int8 kernel and the mask kernel bit for bit) and check
    nothing outside it moved."""
    k_buf, p_buf = dst.clone(), dst.clone()
    before = kernel.launches
    call(kernel, k_buf)
    call({**buf_ops.PLAIN, **quant_ops.PLAIN, **drop_ops.PLAIN}[kernel],
         p_buf)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    if kernel in quant_ops.PLAIN or kernel in drop_ops.PLAIN:
        assert torch.equal(sel(k_buf), sel(p_buf))
    else:
        _close(sel(k_buf), sel(p_buf))
    sel(k_buf).copy_(sel(dst))
    assert torch.equal(k_buf, dst)


# (rows, K, N, bias, bits_i) of the eval affine_dot: every path of its
# plan. Row tiles of 64 two blocks an SM (K = 192), of 128 alone (K = 256,
# two x buffers) and of 64 alone (K = 320, three), of 32 (8192 rows) with
# N in two groups (2048 rows) or three (N = 136); even and odd n8 tiles a
# warp (N = 72 pads to 96 and N = 48: three; N = 16: one; eight at
# K = 256); K tails (8, 24, 40, 136: a zero-padded half k16 step); ragged
# last row tiles; more tiles than blocks; QuanInput's quantizer on the
# prologue; the BN2 epilogue; the streamed weight (K = 896 and 1920, the
# intermedia adapter at order 6 and 14; K = 1000, a partial last chunk,
# with the quantizer)
DOT_CASES = [(520, 24, 16, False, 0), (520, 40, 16, True, 0),
             (520, 16, 8, False, 0), (520, 200, 136, True, 0),
             (8 * 64 * 64, 192, 128, False, 0),
             (8 * 64 * 64, 256, 128, True, 0),
             (8 * 64 * 64, 320, 128, True, 0),
             (8 * 32 * 32, 192, 128, True, 0),
             (8 * 16 * 16, 160, 128, True, 0),
             (8 * 64 * 64, 128, 72, False, 0),
             (8 * 64 * 64 + 8, 136, 48, False, 8),
             (8 * 64 * 64 + 40, 128, 16, True, 8), (1000, 8, 8, True, 0),
             (8 * 64 * 64, 896, 128, False, 0),
             (8 * 16 * 16, 1920, 128, True, 0), (1000, 1000, 72, False, 8)]


def test_dot_cases_cover_every_plan_path():
    plans = [(buf_ops.affine_dot_plan(m, k, n), m, n)
             for m, k, n, _, _ in DOT_CASES]
    assert {p.bm for p, _, _ in plans} >= {32, 64, 128}
    assert {p.ngrp for p, _, _ in plans} >= {1, 2, 3}
    assert {p.stages for p, _, _ in plans} >= {2, 3}
    assert {p.ntw for p, _, _ in plans} >= {1, 2, 3, 4, 8}
    assert {p.smem <= buf_ops.SMEM_PAIR for p, _, _ in plans} == {True,
                                                                  False}
    assert any(p.ncol * p.ngrp > n for p, _, n in plans)
    assert any(m % p.bm for p, m, _ in plans)
    assert any(p.items(m) > 132 for p, m, _ in plans)
    assert {k % 16 for _, k, _, _, _ in DOT_CASES} >= {0, 8}
    assert {p.kc for p, _, _ in plans} == {0, buf_ops.DOT_STREAM_K}


@pytest.mark.parametrize("m,k,n,bias,bits", DOT_CASES)
def test_affine_dot(gen, m, k, n, bias, bits):
    x = _bf16(gen, m, k + 8)
    v, w = _vec(gen, k + 8), _bf16(gen, k + 8, n) * k ** -0.5
    b = (torch.randn(n, generator=gen) * 0.5).cuda() if bias else None
    _check(buf_ops.affine_dot,
           lambda f, o: f(x[:, :k], v, w, o[:, 8:8 + n], bias=b,
                          bits_i=bits),
           _bf16(gen, m, n + 16), lambda o: o[:, 8:8 + n])


# (images, r, K, classes) of the head written into its image-major slot:
# small images, the flagship's 16-class head at r=64, the face head's 68
# classes padded to 72, images of a size no row tile divides
@pytest.mark.parametrize("b,r,k,cls", [(2, 8, 16, 8), (8, 64, 128, 16),
                                       (8, 64, 128, 72), (3, 6, 40, 24)])
def test_affine_dot_head_slot(gen, b, r, k, cls):
    hw = r * r
    x, v, w = _bf16(gen, b * hw, k), _vec(gen, k), _bf16(gen, k, cls)
    _check(buf_ops.affine_dot,
           lambda f, o: f(x, v, w, o[:, 2].view(b, hw, cls)),
           _bf16(gen, b, 3, r, r, cls), lambda o: o[:, 2])


def test_affine_dot_is_table_dot_bit_for_bit(gen):
    """The whole-model path's 1x1 kernel and the per-slot path's feature-
    table kernel sum every output in the same order (ascending 16-deep k
    steps from zero into one float32 accumulator) and round it the same
    way: bit for bit on one feature, with and without the BN2 epilogue,
    at every row tile and column split of affine_dot's plan."""
    from cunet_tpu_torch.kernels import eval_ops

    for m, k, n, bias in ((8 * 64 * 64, 192, 128, False),
                          (8 * 64 * 64, 160, 128, True),
                          (8 * 32 * 32, 320, 128, True),
                          (8 * 16 * 16, 256, 128, False),
                          (8 * 64 * 64, 128, 16, False),
                          (8 * 8 * 8, 128, 72, False), (520, 40, 24, True)):
        x = _bf16(gen, m, k + 8)[:, :k]
        v, w = _vec(gen, k), _bf16(gen, k, n) * k ** -0.5
        b = (torch.randn(n, generator=gen) * 0.5).cuda() if bias else None
        got = torch.empty(m, n, device="cuda", dtype=torch.bfloat16)
        want = torch.empty_like(got)
        buf_ops.affine_dot(x, v, w, got, bias=b)
        eval_ops.table_dot([x], v, w, want, bias=b)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (m, k, n, bias)


# (Cb, G, r, images): every code path of the conv kernels' plans. Small M
# with the reduction split over 8, 4 or 2 warps (bm 32-128), tiles spanning
# images (r = 2, 4, 6: 4-36 rows an image) and W not dividing the tile
# (6, 12, 20); the persistent 128-row tiles (M >= 16384); channel tails
# (24: a zero-padded half k16 step, 48) and output tails (G = 8, 24, 40:
# an odd count of 8-wide n tiles, 72: two column groups); the weight in
# four chunks with one halo stage (Cb = 512, G = 64).
CONV_CASES = [(16, 8, 8, 3), (16, 8, 2, 3), (48, 24, 4, 3),
              (128, 32, 6, 5), (128, 40, 12, 4), (128, 32, 64, 4),
              (48, 8, 32, 16), (24, 16, 20, 2), (512, 64, 8, 2),
              (128, 72, 16, 2), (128, 32, 32, 8), (128, 32, 16, 24)]


def test_conv_cases_cover_every_plan_path():
    plans = [buf_ops.conv3x3_plan(n * r * r, r, r, cb, g)
             for cb, g, r, n in CONV_CASES]
    assert {p.bm for p in plans} == {32, 64, 128}
    assert any(p.nchunk > 1 and p.stages == 1 for p in plans)
    assert any(p.ncol > 1 for p in plans)
    assert {p.nt % 2 for p in plans} == {0, 1}


@pytest.mark.parametrize("cb,g,r,n", CONV_CASES)
def test_conv3x3(gen, cb, g, r, n):
    y2 = torch.relu(_bf16(gen, n * r * r, cb))
    w3 = _bf16(gen, 9 * cb, g) * (9 * cb) ** -0.5
    _check(buf_ops.conv3x3, lambda f, o: f(y2, w3, n, r, r, o[:, 16:16 + g]),
           _bf16(gen, n * r * r, 16 + g + 8), lambda o: o[:, 16:16 + g])


@pytest.mark.parametrize("r", [16, 2])
def test_maxpool2_upsample2(gen, r):
    n, c = 2, 16
    x = _bf16(gen, n * r * r, c)
    _check(buf_ops.maxpool2, lambda f, o: f(x, n, r, r, o[:, :c]),
           _bf16(gen, n * r * r // 4, c + 16), lambda o: o[:, :c])
    _check(buf_ops.upsample2, lambda f, o: f(x, n, r, r, o[:, :c]),
           _bf16(gen, n * 4 * r * r, 2 * c + 16), lambda o: o[:, :c])


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    x = _bf16(gen, 64, 16)
    v, w, out = _vec(gen, 16), _bf16(gen, 16, 8), _bf16(gen, 64, 8)
    with pytest.raises(TypeError):           # float32 x, bf16 weight
        buf_ops.affine_dot(x.float(), v, w, out.float())
    with pytest.raises(ValueError):          # K not a multiple of 8
        buf_ops.affine_dot(x[:, :12], v, w, out)
    with pytest.raises(ValueError):          # vec not float32
        buf_ops.affine_dot(x, v.bfloat16(), w, out)
    with pytest.raises(ValueError):          # mixed devices
        buf_ops.maxpool2(x, 1, 8, 8, torch.empty(16, 16))


@pytest.mark.parametrize("order", [1, 2])
def test_kernel_forward_matches_plain_forward(gen, order):
    cfg = ModelConfig(layer_num=4, order=order, loss_num=2, neck_size=2,
                      growth_rate=8, init_chan_num=16, class_num=8,
                      num_blocks=2, compute_dtype="bfloat16", use_pallas=True,
                      pallas_whole_model=True)
    params, state = init_cu_net(cfg, gen, device="cuda")
    x = torch.rand(3, 64, 64, 3, generator=gen).cuda()
    buf_ops.reset_launch_counts()
    fused, _ = apply_cu_net(params, state, x, cfg=cfg)
    assert all(buf_ops.launch_counts().values())
    plain, _ = apply_cu_net(params, state, x, cfg=dataclasses.replace(
        cfg, use_pallas=False))
    for a, b in zip(fused, plain):
        rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
        assert rel <= 3e-2, rel


# ---------------------------------------------------------------------------
# the slot train kernels
# ---------------------------------------------------------------------------

from cunet_tpu_torch.kernels import train_ops  # noqa: E402
from cunet_tpu_torch.kernels.train_slot import _affine_vec  # noqa: E402


def _close_sum(got, want, n):
    """float32 outputs of an n-term reduction: sums taken in another order
    differ by O(sqrt(n) * 2^-24) of the result's scale; 1e-5 * sqrt(n)
    leaves a margin of ~170."""
    got, want = got.float(), want.float()
    bound = 1e-5 * max(n, 1) ** 0.5 * want.abs().max().item() + 1e-6
    assert (got - want).abs().max().item() <= bound


def _train_vec(gen, x, tiles):
    """Per-tile statistics, BN params and [inv; shift] vectors of x."""
    k = x.shape[1]
    bn = torch.stack([torch.rand(k, generator=gen) + 0.5,
                      torch.randn(k, generator=gen) * 0.3]).cuda()
    st = torch.empty(tiles, 2, k, device="cuda")
    train_ops.bn_stats_plain(x, st)
    return st, bn, _affine_vec(st, bn, 1e-5)


def _both(kernel, make_out, call):
    """(kernel result, plain result) on fresh outputs; one launch counted."""
    before = kernel.launches
    k_out, p_out = make_out(), make_out()
    call(kernel, k_out)
    call(train_ops.PLAIN.get(kernel, buf_ops.PLAIN.get(kernel)), p_out)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    return k_out, p_out


# rows: 3 tiles of 2 images of 6x6 = 216 rows (a ragged last 128-row tile);
# widths down to 8
@pytest.mark.parametrize("k", [8, 24, 136])
def test_bn_stats(gen, k):
    x = _bf16(gen, 216, k + 16)[:, 8:8 + k]
    got, want = _both(train_ops.bn_stats,
                      lambda: torch.empty(3, 2, k, device="cuda"),
                      lambda f, o: f(x, o))
    _close_sum(got, want, 72)


# (rows, BN tiles, K, N, bits_i) of the per-tile affine_dot: the r=64
# adapter at batch 24 (768 row tiles), r=16 (64-row tiles) and r=4 (32-row
# tiles, N in two groups), row tiles across ghost-tile boundaries (250-row
# tiles), one tile, the quantized head, K and N tails
DOT_TILE_CASES = [(216, 3, 8, 8, 0), (216, 3, 40, 16, 0),
                  (216, 3, 200, 136, 0), (24 * 64 * 64, 12, 192, 128, 0),
                  (24 * 16 * 16, 12, 192, 128, 0),
                  (24 * 4 * 4, 12, 192, 128, 0), (1000, 4, 136, 24, 8),
                  (300, 1, 128, 16, 8), (24 * 64 * 64, 12, 128, 16, 8)]


@pytest.mark.parametrize("m,tiles,k,n,bits", DOT_TILE_CASES)
def test_affine_dot_per_tile(gen, m, tiles, k, n, bits):
    x = _bf16(gen, m, k)
    _, _, vec = _train_vec(gen, x, tiles)
    w = _bf16(gen, k, n) * k ** -0.5
    _check(buf_ops.affine_dot,
           lambda f, o: f(x, vec, w, o[:, 8:8 + n], bits_i=bits),
           _bf16(gen, m, n + 16), lambda o: o[:, 8:8 + n])


# (Cb, G, r, images, bits_i) of the per-tile prologue: BN tiles of two
# images, the paths of CONV_CASES, QuanInput's quantizer
PROLOGUE_CASES = [(16, 8, 6, 6, 0), (16, 8, 2, 6, 0), (48, 24, 4, 6, 0),
                  (128, 32, 64, 4, 0), (128, 40, 6, 6, 8), (24, 16, 20, 2, 0),
                  (128, 32, 16, 24, 8), (512, 64, 8, 2, 8)]


@pytest.mark.parametrize("cb,g,r,n,bits", PROLOGUE_CASES)
def test_conv3x3_bn_prologue(gen, cb, g, r, n, bits):
    y = _bf16(gen, n * r * r, cb)
    _, _, vec = _train_vec(gen, y, n // 2)
    w3 = _bf16(gen, 9 * cb, g) * (9 * cb) ** -0.5
    _check(buf_ops.conv3x3,
           lambda f, o: f(y, w3, n, r, r, o[:, 16:16 + g], vec=vec,
                          bits_i=bits),
           _bf16(gen, n * r * r, 16 + g + 8), lambda o: o[:, 16:16 + g])


# (rows, BN tiles, K, N, ste) of affine_dx (and affine_dw on the same
# operands, quantized where ste is on): every path of affine_dx's plan.
# Row tiles of 64 two blocks an SM over K = 192 in three blocks of 64 (two
# n8 tiles a warp; r=64, r=16) and K = 320 in five; of 128 (the head,
# 128 -> 16: one k16 step, four tiles a warp); of 32 (r=8, r=4; one tile a
# warp); a block partly past K (K = 40, 136, 200); layouts alone with two
# buffers and with three (N = 512); K and N tails (8, 40, 136; N = 24, 72,
# 136); row tiles across ghost tiles; one tile; the STE gate
DX_CASES = [(216, 3, 8, 8, False), (216, 3, 40, 16, False),
            (216, 3, 200, 136, False), (24 * 64 * 64, 12, 192, 128, False),
            (24 * 64 * 64, 12, 128, 16, True),
            (24 * 16 * 16, 12, 192, 128, False),
            (24 * 8 * 8, 12, 192, 128, True),
            (24 * 32 * 32, 12, 320, 128, False),
            (24 * 4 * 4, 12, 320, 128, True), (1000, 4, 136, 24, True),
            (300, 1, 40, 72, False), (24 * 32 * 32, 12, 128, 136, False),
            (2000, 2, 64, 512, False), (2000, 4, 192, 512, True)]


def test_affine_dx_cases_cover_every_plan_path():
    plans = [(train_ops.affine_dx_plan(m, k, n), m, k)
             for m, _, k, n, _ in DX_CASES]
    assert {p.bm for p, _, _ in plans} >= {32, 64, 128}
    assert {p.nkb for p, _, _ in plans} >= {1, 2, 3}
    assert {p.stages for p, _, _ in plans} >= {2, 3}
    assert {p.ntw for p, _, _ in plans} >= {1, 2, 4}
    assert {p.smem <= buf_ops.SMEM_PAIR for p, _, _ in plans} == {True,
                                                                  False}
    assert any(p.kc * p.nkb > k for p, _, k in plans)
    assert any(m % p.bm for p, m, _ in plans)
    assert any(p.items(m) > 132 for p, m, _ in plans)
    assert {n % 16 for _, _, _, n, _ in DX_CASES} >= {0, 8}


@pytest.mark.parametrize("m,tiles,k,n,ste", DX_CASES)
def test_affine_dx_dw(gen, m, tiles, k, n, ste):
    x = _bf16(gen, m, k + 8)[:, :k]
    _, _, vec = _train_vec(gen, x, tiles)
    w = (_bf16(gen, k, n) * k ** -0.5).contiguous()
    dy = _bf16(gen, m, n)
    got, want = _both(train_ops.affine_dx,
                      lambda: torch.empty(m, k + 8, device="cuda")[:, :k],
                      lambda f, o: f(dy, w, x, vec, o, ste=ste))
    _close_sum(got, want, n)
    assert torch.equal(got == 0, want == 0)
    got, want = _both(train_ops.affine_dw,
                      lambda: torch.empty(k, n, device="cuda"),
                      lambda f, o: f(x, vec, dy, o, bits_i=8 if ste else 0))
    _close_sum(got, want, m)


def test_gemm_kernels_repeat_bit_for_bit(gen):
    """affine_dot (eval and per tile, 128- and 32-row tiles, N in one and
    two groups) and affine_dx (two and three column blocks, the STE gate)
    give the same bits on a second run: no atomics, no split reduction,
    plans of the shapes alone."""
    for m, tiles, k in ((24 * 64 * 64, 12, 192), (24 * 4 * 4, 12, 192)):
        x = _bf16(gen, m, k)
        _, _, vec = _train_vec(gen, x, tiles)
        w = (_bf16(gen, k, 128) * k ** -0.5).contiguous()
        dy = _bf16(gen, m, 128)
        for v in (vec, _vec(gen, k)):
            runs = [buf_ops.affine_dot(x, v, w, torch.empty(
                m, 128, device="cuda", dtype=torch.bfloat16))
                for _ in range(2)]
            torch.cuda.synchronize()
            assert torch.equal(*runs)
        for ste in (False, True):
            runs = [train_ops.affine_dx(dy, w, x, vec, torch.empty(
                m, k, device="cuda"), ste=ste) for _ in range(2)]
            torch.cuda.synchronize()
            assert torch.equal(*runs)


# (Cb, G, r, images, bits_i) of the conv backward: one run and several
# (M > 128), runs of two steps (M = 24576), W not dividing a step (6, 12,
# 20), two column groups (G = 40), two channel blocks (Cb = 256), channel
# tails (24, 48), QuanInput's quantizer. For conv3x3_dx: the reduction
# split over 8, 4 or 2 warps, tiles spanning images (r = 2, 4, 6), the
# persistent 128-row tiles over all 128 channels (M = 24576, more items
# than blocks), channel groups of 16-128 (r = 8: 32), dy widths G = 8,
# 24, 32, 40 (a zero-padded half k16 step), one halo stage (W = 128,
# G = 64)
DW_CASES = [(16, 8, 6, 6, 0), (16, 8, 2, 6, 0), (48, 24, 4, 6, 0),
            (128, 32, 32, 24, 0), (128, 40, 6, 6, 0), (256, 32, 8, 4, 0),
            (24, 16, 20, 2, 0), (128, 32, 12, 24, 8), (128, 8, 64, 4, 8),
            (128, 24, 16, 24, 0), (48, 40, 32, 8, 0), (128, 64, 128, 2, 0),
            (128, 32, 8, 24, 0)]


def test_dx_cases_cover_every_plan_path():
    plans = [(train_ops.conv3x3_dx_plan(n * r * r, r, r, cb, g, n // 2),
              n * r * r, r) for cb, g, r, n, _ in DW_CASES]
    assert any(p.k_warps == 1 and p.items(m) > 132 for p, m, _ in plans)
    assert {p.k_warps for p, _, _ in plans} >= {2, 4, 8}
    assert any(p.k_warps > 1 and p.gb == 128 for p, _, _ in plans)
    assert {p.gb for p, _, _ in plans} >= {16, 32, 64, 128}
    assert any(p.ncol > 1 for p, _, _ in plans)
    assert any(p.stages == 1 for p, _, _ in plans)
    assert any(p.bm > r * r for p, _, r in plans)        # across images
    assert any(p.bm % r for p, _, r in plans)            # W not dividing
    assert {-(-g // 16) * 16 - g for _, g, _, _, _ in DW_CASES} >= {0, 8}


def test_dw_cases_cover_every_plan_path():
    plans = [(train_ops.conv3x3_dw_plan(n * r * r, r, r, cb, g), cb, g)
             for cb, g, r, n, _ in DW_CASES]
    assert any(p.runs == 1 for p, _, _ in plans)
    assert any(p.runs > 1 and p.run_rows > p.br for p, _, _ in plans)
    assert any(p.grid(cb, g)[1] > 1 for p, cb, g in plans)
    assert any(p.grid(cb, g)[2] > 1 for p, cb, g in plans)


@pytest.mark.parametrize("cb,g,r,n,bits", DW_CASES)
def test_conv3x3_dx_dw(gen, cb, g, r, n, bits):
    m = n * r * r
    yb = _bf16(gen, m, cb)
    _, _, vec = _train_vec(gen, yb, n // 2)
    w3 = (_bf16(gen, 9 * cb, g) * (9 * cb) ** -0.5).contiguous()
    d_o = _bf16(gen, m, g)
    got, want = _both(train_ops.conv3x3_dx,
                      lambda: torch.empty(m, cb, device="cuda"),
                      lambda f, o: f(d_o, w3, n, r, r, yb, vec, o))
    _close_sum(got, want, 9 * g)
    got, want = _both(train_ops.conv3x3_dw,
                      lambda: torch.empty(9 * cb, g, device="cuda"),
                      lambda f, o: f(yb, vec, d_o, n, r, r, o, bits_i=bits))
    _close_sum(got, want, m)


def test_backward_kernels_repeat_bit_for_bit(gen):
    """conv3x3_dx (128-row tiles, and the split reduction of small M) and
    bwd_reduce give the same bits on a second run: no atomics, and their
    plans depend on the shapes only."""
    n, r, cb, g = 24, 32, 128, 32
    m = n * r * r
    yb = _bf16(gen, m, cb)
    _, _, vec = _train_vec(gen, yb, n // 2)
    w3 = (_bf16(gen, 9 * cb, g) * (9 * cb) ** -0.5).contiguous()
    d_o = _bf16(gen, m, g)
    for k, rr in ((n, r), (2, 4)):
        mm = k * rr * rr
        runs = [train_ops.conv3x3_dx(
            d_o[:mm], w3, k, rr, rr, yb[:mm], vec[:1] if k == 2 else vec,
            torch.empty(mm, cb, device="cuda"), ste=True) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(*runs)
    feats, _, stat, bias, w, g_o = _tb_operands(gen, m, [128, 128, 32, 32],
                                                128)
    outs = [tbk.bwd_reduce(feats, g_o, stat, bias, w,
                           torch.empty(320, 128, device="cuda"),
                           torch.empty(2, 320, device="cuda"))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_conv_kernels_repeat_bit_for_bit(gen):
    """The same inputs give the same bits on a second run: no atomics, and
    the plans (the reduction splits, the dW runs) depend on shapes only."""
    n, r, cb, g = 24, 32, 128, 32
    m = n * r * r
    yb = _bf16(gen, m, cb)
    _, _, vec = _train_vec(gen, yb, n // 2)
    w3 = (_bf16(gen, 9 * cb, g) * (9 * cb) ** -0.5).contiguous()
    d_o = _bf16(gen, m, g)
    for small in (False, True):       # 128-row tiles; the split reduction
        y = yb[:2 * r * r] if small else yb
        v = vec[:1] if small else vec
        k = 2 if small else n
        runs = [buf_ops.conv3x3(y, w3, k, r, r, torch.empty(
            y.shape[0], g, device="cuda", dtype=torch.bfloat16), vec=v,
            bits_i=8) for _ in range(2)]
        assert torch.equal(*runs)
    dws = [train_ops.conv3x3_dw(yb, vec, d_o, n, r, r,
                                torch.empty(9 * cb, g, device="cuda"))
           for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*dws)


@pytest.mark.parametrize("k,accumulate", [(8, False), (40, True),
                                          (136, False)])
def test_bn_bwd(gen, k, accumulate):
    m = 216
    x = _bf16(gen, m, k)
    st, bn, _ = _train_vec(gen, x, 3)
    d_a = torch.randn(m, k + 8, generator=gen).cuda()[:, :k]
    base = torch.randn(m, k, generator=gen).cuda()
    outs = {}
    for name, fn in (("kernel", train_ops.bn_bwd),
                     ("plain", train_ops.bn_bwd_plain)):
        d_x, dbn = base.clone(), torch.empty(2, k, device="cuda")
        if name == "kernel":
            fn(x, d_a, st, bn, 1e-5, d_x, dbn, accumulate=accumulate)
        else:
            fn(x, d_a, st, bn, 1e-5, d_x, dbn, accumulate)
        outs[name] = (d_x, dbn)
    torch.cuda.synchronize()
    _close_sum(outs["kernel"][0], outs["plain"][0], 72)
    _close_sum(outs["kernel"][1], outs["plain"][1], m)


# (rows, BN tiles, K, accumulate) of bn_bwd: every plan branch -- one block
# a tile (r <= 8), clusters of 2 (K=640), 4 and 8, the r=64 main shapes (a
# tile over 8 blocks of 1024 rows kept in shared memory), rows too many for
# shared memory (the ring), tile rows not dividing by the cluster (1001
# over 4), channel blocks of 16-64, channel tails (8, 40, 136), one tile
BN_BWD_CASES = [(24 * 64 * 64, 12, 192, False),
                (24 * 64 * 64, 12, 288, True), (24 * 32 * 32, 12, 192, True),
                (24 * 16 * 16, 12, 128, False), (24 * 16 * 16, 12, 640, True),
                (24 * 8 * 8, 12, 320, True), (24 * 4 * 4, 12, 128, False),
                (2 * 65536, 2, 64, True), (12 * 1001, 12, 192, False),
                (216, 3, 8, False), (216, 3, 40, True), (300, 1, 136, False)]


def test_bn_bwd_cases_cover_every_plan_path():
    plans = [(train_ops.bn_bwd_plan(m, m // t, k), m // t)
             for m, t, k, _ in BN_BWD_CASES]
    assert {p.cs for p, _ in plans} >= {1, 2, 4, 8}
    assert {p.cb for p, _ in plans} >= {16, 32, 64}
    assert any(p.resident and p.chunks > 1 for p, _ in plans)
    assert any(not p.resident for p, _ in plans)
    assert any(tr % p.cs for p, tr in plans)


@pytest.mark.parametrize("m,tiles,k,accumulate", BN_BWD_CASES)
def test_bn_bwd_plans(gen, m, tiles, k, accumulate):
    x = _bf16(gen, m, k + 8)[:, :k]
    st, bn, _ = _train_vec(gen, x, tiles)
    d_a = torch.randn(m, k + 8, generator=gen).cuda()[:, 8:]
    base = torch.randn(m, k, generator=gen).cuda()
    got, want = _both(train_ops.bn_bwd,
                      lambda: (base.clone(),
                               torch.empty(2, k, device="cuda")),
                      lambda f, o: f(x, d_a, st, bn, 1e-5, o[0], o[1],
                                     accumulate=accumulate))
    _close_sum(got[0], want[0], m // tiles)
    _close_sum(got[1], want[1], m)


# (rows, BN tiles, K, N, bits_i) of affine_dw: the r=64 main shapes (two and
# three channel blocks, the quantized head's N=16), runs straddling ghost
# tiles (r=32, K=320: runs of 320 rows, tiles of 2048), steps of 64, 32 and
# 16 rows, the column groups of r <= 16, channel and column tails, rows not
# dividing a step, one run
DW_PLAN_CASES = [(24 * 64 * 64, 12, 192, 128, 0),
                 (24 * 64 * 64, 12, 128, 16, 8),
                 (24 * 64 * 64, 12, 320, 128, 0),
                 (24 * 32 * 32, 12, 320, 128, 0),
                 (24 * 16 * 16, 12, 128, 128, 0),
                 (24 * 4 * 4, 12, 192, 128, 8), (24 * 8 * 8, 12, 192, 128, 0),
                 (216, 3, 8, 8, 0), (216, 3, 200, 136, 0),
                 (1000, 4, 136, 24, 8), (16, 1, 40, 24, 0)]


def test_affine_dw_cases_cover_every_plan_path():
    plans = [(train_ops.affine_dw_plan(m, k, n), m, m // t)
             for m, t, k, n, _ in DW_PLAN_CASES]
    assert any(p.runs == 1 for p, _, _ in plans)
    assert any(p.runs > 1 and p.nkb > 1 for p, _, _ in plans)
    assert {p.ncol for p, _, _ in plans} >= {16, 32, 64, 128}
    assert {p.br for p, _, _ in plans} >= {16, 32, 64}
    assert any(p.ngrp > 1 for p, _, _ in plans)
    assert any(r.start // tr != (r.stop - 1) // tr
               for p, m, tr in plans
               for r in (p.run(q, m) for q in range(p.runs)))


@pytest.mark.parametrize("m,tiles,k,n,bits", DW_PLAN_CASES)
def test_affine_dw_plans(gen, m, tiles, k, n, bits):
    x = (_bf16(gen, m, k + 8) * 2)[:, 8:]
    _, _, vec = _train_vec(gen, x, tiles)
    dy = _bf16(gen, m, n + 8)[:, :n]
    got, want = _both(train_ops.affine_dw,
                      lambda: torch.empty(k, n, device="cuda"),
                      lambda f, o: f(x, vec, dy, o, bits_i=bits))
    _close_sum(got, want, m)


def test_stage_bwd_kernels_repeat_bit_for_bit(gen):
    """bn_bwd (a cluster of 8 blocks a tile, and the ring) and affine_dw
    (two channel blocks of 64 runs; r=4's column groups) give the same bits
    on a second run: no atomics, plans of the shapes alone."""
    for m, tiles, k in ((24 * 64 * 64, 12, 192), (2 * 65536, 2, 64)):
        x = _bf16(gen, m, k)
        st, bn, vec = _train_vec(gen, x, tiles)
        d_a = torch.randn(m, k, generator=gen).cuda()
        outs = []
        for _ in range(2):
            o = (torch.empty(m, k, device="cuda"),
                 torch.empty(2, k, device="cuda"))
            train_ops.bn_bwd(x, d_a, st, bn, 1e-5, *o)
            outs.append(o)
        for n, mm in ((128, m), (128, 384)):
            dy = _bf16(gen, mm, n)
            v = vec if mm == m else vec[:1]
            outs.append([train_ops.affine_dw(x[:mm], v, dy,
                                             torch.empty(k, n, device="cuda"),
                                             bits_i=8 if mm < m else 0)
                         for _ in range(2)])
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*outs[:2]))
        assert all(torch.equal(*pair) for pair in outs[2:])


@pytest.mark.parametrize("r", [8, 2])
def test_maxpool2_bwd_and_upsample2_bwd(gen, r):
    n, c = 3, 16
    ahead = _bf16(gen, n * r * r, c)
    ahead[::5] = ahead[1::5][:ahead[::5].shape[0]]     # some exact ties
    d_pool = torch.randn(n * r * r // 4, c + 8, generator=gen).cuda()[:, :c]
    got, want = _both(train_ops.maxpool2_bwd,
                      lambda: torch.empty(n * r * r, c, device="cuda",
                                          dtype=torch.bfloat16),
                      lambda f, o: f(ahead, d_pool, n, r, r, o))
    assert torch.equal(got, want)
    d_up = torch.randn(n * 4 * r * r, c, generator=gen).cuda()
    got, want = _both(train_ops.upsample2_bwd,
                      lambda: torch.empty(n * r * r, c, device="cuda",
                                          dtype=torch.bfloat16),
                      lambda f, o: f(d_up, n, r, r, o))
    _close(got, want)


def _train_grads(cfg, params, state, x, t):
    from cunet_tpu_torch.train import intermediate_mse

    ps = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    outs, new_state = apply_cu_net(ps, state, x, cfg=cfg, train=True)
    loss = intermediate_mse(outs, t)
    loss.backward()
    return loss.item(), {k: v.grad for k, v in ps.items()}, new_state


def test_kernel_train_step_matches_plain_and_repeats(gen):
    """Two slots, bf16, ghost tile 2: the kernel path's loss, grads and BN
    state against the plain path on the card (bf16 rounding points differ:
    the kernels' BN affine runs in f32), and bit-identical on a repeat."""
    cfg = ModelConfig(layer_num=2, order=1, loss_num=2, neck_size=2,
                      growth_rate=8, init_chan_num=16, class_num=8,
                      num_blocks=2, compute_dtype="bfloat16", use_pallas=True,
                      bn_tile=2, bn_dtype="compute", remat="none")
    params, state = init_cu_net(cfg, gen, device="cuda")
    x = torch.rand(4, 64, 64, 3, generator=gen).cuda()
    t = torch.rand(4, 16, 16, 8, generator=gen).cuda()
    buf_ops.reset_launch_counts()
    train_ops.reset_launch_counts()
    lk, gk, sk = _train_grads(cfg, params, state, x, t)
    assert all(buf_ops.launch_counts().values())
    assert all(train_ops.launch_counts().values())
    lk2, gk2, _ = _train_grads(cfg, params, state, x, t)
    assert lk2 == lk and all(torch.equal(gk[k], gk2[k]) for k in gk)
    lp, gp, sp = _train_grads(dataclasses.replace(cfg, use_pallas=False),
                              params, state, x, t)
    assert abs(lk - lp) <= 1e-2 * abs(lp)
    norm = lambda g: torch.sqrt(sum((v.float() ** 2).sum() for v in g.values()))
    assert 0.85 <= (norm(gk) / norm(gp)).item() <= 1.18
    cos = [torch.nn.functional.cosine_similarity(
        gk[k].flatten(), gp[k].flatten(), dim=0).item()
        for k in gk if gp[k].abs().max() > 0]
    assert sum(cos) / len(cos) > 0.5
    for k in sp:
        rel = ((sk[k] - sp[k]).norm() / sp[k].norm()).item()
        assert rel <= 1e-2, (k, rel)


# ---------------------------------------------------------------------------
# the int8 kernels (bit-identical to their plain versions)
# ---------------------------------------------------------------------------

from cunet_tpu_torch.config import QuantConfig  # noqa: E402
from cunet_tpu_torch.kernels import model_buf  # noqa: E402
from cunet_tpu_torch.train.quant_step import quant_eval_params  # noqa: E402

INT8 = QuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True,
                   int8_infer=True, int8_impl="pallas")


def _signs(gen, k, n):
    return torch.randint(-1, 2, (k, n), generator=gen,
                         dtype=torch.int8).cuda()


def _codes(gen, *shape):
    return torch.randint(-127, 128, shape, generator=gen,
                         dtype=torch.int8).cuda()


# K tails (24, 40: not multiples of 32), 200 rows (a ragged row tile), N
# from 8 to 136 (two column blocks)
@pytest.mark.parametrize("k,n,q8", [(24, 16, False), (40, 24, True),
                                    (16, 8, True), (200, 136, False)])
def test_affine_dot_i8(gen, k, n, q8):
    m = 200
    x = _bf16(gen, m, k + 8) * 0.5
    v, w = _vec(gen, k + 8), _signs(gen, k + 8, n)
    if q8:
        v2 = _vec(gen, n) * torch.tensor([[0.05], [1.0]], device="cuda")
        _check(quant_ops.affine_dot_i8,
                     lambda f, o: f(x[:, :k], v, w, o, s=128.0, vec2=v2),
                     _codes(gen, m, n), lambda o: o)
    else:
        _check(quant_ops.affine_dot_i8,
                     lambda f, o: f(x[:, :k], v, w, o[:, 8:8 + n], s=128.0),
                     _bf16(gen, m, n + 16), lambda o: o[:, 8:8 + n])


def test_affine_dot_i8_head_slot(gen):
    b, hw, k, cls = 2, 64, 16, 8
    x, v, w = _bf16(gen, b * hw, k), _vec(gen, k), _signs(gen, k, cls)
    _check(quant_ops.affine_dot_i8,
                 lambda f, o: f(x, v, w, o[:, 2].view(b, hw, cls), s=128.0),
                 _bf16(gen, b, 3, 8, 8, cls), lambda o: o[:, 2])


# Cb=24 (not a multiple of 16: byte loads), 3 images of r x r (ragged
# row tiles), G up to 40 (two column blocks of 32)
@pytest.mark.parametrize("cb,g,r", [(16, 8, 8), (24, 8, 2), (48, 40, 5)])
def test_conv3x3_i8(gen, cb, g, r):
    n = 3
    y = _codes(gen, n * r * r, cb).clamp_(min=0)
    w3 = _signs(gen, 9 * cb, g)
    _check(quant_ops.conv3x3_i8,
                 lambda f, o: f(y, w3, n, r, r, o[:, 16:16 + g], s=128.0),
                 _bf16(gen, n * r * r, 16 + g + 8), lambda o: o[:, 16:16 + g])


# K=20: 20-byte rows, unaligned for 16-byte loads
@pytest.mark.parametrize("m,k,n", [(200, 20, 24), (64, 32, 16),
                                   (300, 136, 130)])
def test_int8_matmul_dequant(gen, m, k, n):
    x, w = _codes(gen, m, k), _codes(gen, k, n)
    cs = torch.rand(n, generator=gen).cuda()
    before = quant_ops.int8_matmul_dequant.launches
    got = quant_ops.int8_matmul_dequant(x, w, cs, 1 / 128)
    want = torch.empty_like(got)
    quant_ops.PLAIN[quant_ops.int8_matmul_dequant](x, w, cs, 1 / 128, want)
    torch.cuda.synchronize()
    assert quant_ops.int8_matmul_dequant.launches == before + 1
    assert torch.equal(got, want)


def test_int8_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    x = _bf16(gen, 64, 16)
    v, w = _vec(gen, 16), _signs(gen, 16, 8)
    out, codes = _bf16(gen, 64, 8), _codes(gen, 64, 8)
    with pytest.raises(TypeError):            # float32 x: no silent cast
        quant_ops.affine_dot_i8(x.float(), v, w, out, s=128.0)
    with pytest.raises(TypeError):            # bf16 weights
        quant_ops.affine_dot_i8(x, v, w.bfloat16(), out, s=128.0)
    with pytest.raises(ValueError):           # BN2 epilogue into bf16
        quant_ops.affine_dot_i8(x, v, w, out.view(64, 1, 8), s=128.0,
                                vec2=_vec(gen, 8))
    with pytest.raises(ValueError):           # weights on the CPU
        quant_ops.affine_dot_i8(x, v, w.cpu(), out, s=128.0)
    with pytest.raises(TypeError):            # bf16 conv input
        quant_ops.conv3x3_i8(x, _signs(gen, 144, 8), 1, 8, 8, out, s=128.0)
    with pytest.raises(ValueError):           # float32 column scales
        quant_ops.int8_matmul_dequant(codes, w[:8], torch.ones(
            8, device="cuda").double(), 1 / 128)
    with pytest.raises(ValueError):           # CUDA int8 rows, CPU weights
        quant_ops.int8_matmul_dequant(codes, w[:8].cpu(), torch.ones(
            8, device="cuda"), 1 / 128)


def test_int8_forward_kernels_match_plain_versions_exactly(gen):
    """The whole-model int8 forward on the card is bit-identical with the
    int8 kernels swapped for their plain versions, launches them, and the
    plain path on int8_matmul_dequant is bit-identical to its lax form."""
    cfg = ModelConfig(layer_num=3, order=1, loss_num=3, neck_size=2,
                      growth_rate=8, init_chan_num=16, class_num=8,
                      num_blocks=2, compute_dtype="bfloat16", use_pallas=True,
                      pallas_whole_model=True)
    params, state = init_cu_net(cfg, gen, device="cuda")
    params = quant_eval_params(params, INT8)
    x = torch.rand(3, 64, 64, 3, generator=gen).cuda()
    quant_ops.reset_launch_counts()
    fused, _ = apply_cu_net(params, state, x, cfg=cfg, quant=INT8)
    counts = quant_ops.launch_counts()
    assert counts["affine_dot_i8"] and counts["conv3x3_i8"]
    saved = (model_buf.affine_dot_i8, model_buf.conv3x3_i8)
    model_buf.affine_dot_i8 = quant_ops.affine_dot_i8_plain
    model_buf.conv3x3_i8 = quant_ops.conv3x3_i8_plain
    try:
        plain, _ = apply_cu_net(params, state, x, cfg=cfg, quant=INT8)
    finally:
        model_buf.affine_dot_i8, model_buf.conv3x3_i8 = saved
    assert all(torch.equal(a, b) for a, b in zip(fused, plain))
    assert all(a.abs().max() > 0 for a in fused)
    flat = dataclasses.replace(cfg, use_pallas=False)
    k8, _ = apply_cu_net(params, state, x, cfg=flat, quant=INT8)
    assert quant_ops.int8_matmul_dequant.launches > 0
    lax, _ = apply_cu_net(params, state, x, cfg=flat,
                          quant=dataclasses.replace(INT8, int8_impl="lax"))
    assert all(torch.equal(a, b) for a, b in zip(k8, lax))


# ---------------------------------------------------------------------------
# the slot train kernels' options: QuanInput and dropout
# ---------------------------------------------------------------------------

from cunet_tpu_torch.ops import dropmask  # noqa: E402


@pytest.mark.parametrize("cb,g,r", [(16, 8, 6), (48, 24, 4)])
def test_quantized_prologues(gen, cb, g, r):
    """conv3x3 / affine_dot with bits_i=8, and the dW kernels with bits_i:
    kernel against plain version (the quantized bf16 activations are the
    same values; sums in another order)."""
    n = 6
    m = n * r * r
    y = _bf16(gen, m, cb) * 2
    _, _, vec = _train_vec(gen, y, 3)
    w3 = (_bf16(gen, 9 * cb, g) * (9 * cb) ** -0.5).contiguous()
    _check(buf_ops.conv3x3,
           lambda f, o: f(y, w3, n, r, r, o[:, 16:16 + g], vec=vec,
                          bits_i=8),
           _bf16(gen, m, 16 + g + 8), lambda o: o[:, 16:16 + g])
    w = (_bf16(gen, cb, g) * cb ** -0.5).contiguous()
    _check(buf_ops.affine_dot, lambda f, o: f(y, vec, w, o, bits_i=8),
           _bf16(gen, m, g), lambda o: o)
    d_o = _bf16(gen, m, g)
    got, want = _both(train_ops.conv3x3_dw,
                      lambda: torch.empty(9 * cb, g, device="cuda"),
                      lambda f, o: f(y, vec, d_o, n, r, r, o, bits_i=8))
    _close_sum(got, want, m)
    got, want = _both(train_ops.affine_dw,
                      lambda: torch.empty(cb, g, device="cuda"),
                      lambda f, o: f(y, vec, d_o, o, bits_i=4))
    _close_sum(got, want, m)


# (images, r, Cb, G) of the STE gate: the split reduction over channel
# groups of 16, tiles across images; the persistent 128-row tiles over all
# 128 channels; a channel tail (48) with G = 24
STE_CASES = [(6, 4, 16, 8), (24, 32, 128, 32), (3, 6, 48, 24)]


@pytest.mark.parametrize("n,r,cb,g", STE_CASES)
def test_ste_gate_exact(gen, n, r, cb, g):
    """affine_dx / conv3x3_dx with ste: the same elements pass as in the
    plain version, on activations placed at and around 1.0 after bf16
    rounding (0.99999 rounds to 1.0 and is gated)."""
    m = n * r * r
    x = torch.full((m, cb), 0.5, device="cuda", dtype=torch.bfloat16)
    z = torch.tensor([0.99999, 0.999, 0.99609375, 0.998, 1.0, 1.2, -0.5,
                      0.3] * (cb // 8), device="cuda")
    vec = torch.stack([torch.ones(cb, device="cuda"), z - 0.5])
    w3 = (_bf16(gen, 9 * cb, g) * 0.2).contiguous()
    d_o = _bf16(gen, m, g)
    got, want = _both(train_ops.conv3x3_dx,
                      lambda: torch.empty(m, cb, device="cuda"),
                      lambda f, o: f(d_o, w3, n, r, r, x, vec, o, ste=True))
    assert torch.equal(got == 0, want == 0)
    assert torch.equal((got[0] != 0).cpu(), torch.tensor(
        [0, 0, 1, 1, 0, 0, 0, 1] * (cb // 8), dtype=torch.bool))
    _close_sum(got, want, 9 * g)
    w = (_bf16(gen, cb, g) * 0.2).contiguous()
    got, want = _both(train_ops.affine_dx,
                      lambda: torch.empty(m, cb, device="cuda"),
                      lambda f, o: f(d_o, w, x, vec, o, ste=True))
    assert torch.equal(got == 0, want == 0)


@pytest.mark.parametrize("g,r,rate", [(8, 6, 0.25), (32, 4, 0.2),
                                      (24, 2, 0.5)])
def test_drop_mask_bit_identical(gen, g, r, rate):
    """Forward in place on a strided bf16 view and backward from a strided
    float32 cotangent, bit-identical to the plain version; on a ones view
    the forward leaves the plain tile masks."""
    n, bt = 6, 2
    m, tile_rows = n * r * r, bt * r * r
    for seed, pos in ((7, 0), (-123456, 8), (2 ** 31 - 1, 4)):
        _check(drop_ops.drop_mask,
               lambda f, o: f(o[:, 16:16 + g], seed, pos, rate, tile_rows),
               _bf16(gen, m, 16 + g + 8), lambda o: o[:, 16:16 + g])
        ones = torch.ones(m, g, device="cuda", dtype=torch.bfloat16)
        drop_ops.drop_mask(ones, seed, pos, rate, tile_rows)
        assert torch.equal(ones, dropmask.rows_mask(
            seed, pos, m, g, tile_rows, rate, torch.bfloat16, "cuda"))
        d = torch.randn(m, g + 8, generator=gen).cuda()[:, 4:4 + g]
        outs = [torch.empty(m, g, device="cuda", dtype=torch.bfloat16)
                for _ in range(2)]
        drop_ops.drop_mask(d, seed, pos, rate, tile_rows, outs[0])
        drop_ops.PLAIN[drop_ops.drop_mask](d, seed, pos, rate, tile_rows,
                                           outs[1])
        assert torch.equal(outs[0], outs[1])


def _option_grads(cfg, params, state, x, t, **kw):
    from cunet_tpu_torch.train import intermediate_mse

    ps = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    outs, new_state = apply_cu_net(ps, state, x, cfg=cfg, train=True, **kw)
    loss = intermediate_mse(outs, t)
    loss.backward()
    return loss.item(), {k: v.grad for k, v in ps.items()}


@pytest.mark.parametrize("option", ["dropout", "quant"])
def test_kernel_train_step_with_option(gen, option):
    """Two slots, bf16, ghost tile 2, with dropout 0.2 (seeds per slot) or
    QuanInput (bits_i=8): the kernel path launches the option's kernels,
    repeats bit for bit, and its loss is within 1e-2 of the plain path's."""
    cfg = ModelConfig(layer_num=2, order=1, loss_num=2, neck_size=2,
                      growth_rate=8, init_chan_num=16, class_num=8,
                      num_blocks=2, compute_dtype="bfloat16", use_pallas=True,
                      bn_tile=2, bn_dtype="compute", remat="none",
                      drop_rate=0.2 if option == "dropout" else 0.0)
    params, state = init_cu_net(cfg, gen, device="cuda")
    x = torch.rand(4, 64, 64, 3, generator=gen).cuda()
    t = torch.rand(4, 16, 16, 8, generator=gen).cuda()
    kw = (dict(drop_seeds=[11, -12]) if option == "dropout" else
          dict(quant=QuantConfig(bits_w=1, bits_i=8, bits_g=8,
                                 enabled=True)))
    drop_ops.reset_launch_counts()
    buf_ops.reset_launch_counts()
    lk, gk = _option_grads(cfg, params, state, x, t, **kw)
    if option == "dropout":
        assert drop_ops.drop_mask.launches == 2 * 2 * 5   # fwd+bwd, 5 blocks
    else:
        assert buf_ops.conv3x3.option_launches > 0
    lk2, gk2 = _option_grads(cfg, params, state, x, t, **kw)
    assert lk2 == lk and all(torch.equal(gk[k], gk2[k]) for k in gk)
    lp, _ = _option_grads(dataclasses.replace(cfg, use_pallas=False), params,
                          state, x, t, **kw)
    assert abs(lk - lp) <= 1e-2 * abs(lp)


# ---------------------------------------------------------------------------
# the per-bottleneck train kernel (TPU kernel #7) and its bn_tile=0 step
# ---------------------------------------------------------------------------

from cunet_tpu_torch.kernels import train_bottleneck as tbk  # noqa: E402


def _tb_operands(gen, m, widths, cout):
    """Features (the second one a strided view of a wider buffer, when
    there are two or more), BN parameters, weights, the forward's vectors
    and statistics, and a bf16 output cotangent."""
    feats = [_bf16(gen, m, c) * (1 + k) + 0.2 * k
             for k, c in enumerate(widths)]
    if len(feats) > 1:
        feats[1] = torch.cat([feats[1], _bf16(gen, m, 8)], 1)[:, :widths[1]]
    ctot = sum(widths)
    scale = (torch.rand(ctot, generator=gen) + 0.5).cuda()
    bias = (torch.randn(ctot, generator=gen) * 0.3).cuda()
    w = (torch.randn(ctot, cout, generator=gen) * ctot ** -0.5).cuda()
    sums = tbk.stats_plain(feats, torch.empty(2, ctot, device="cuda"))
    mean = sums[0] / m
    var = sums[1] / m - mean * mean
    inv_sigma = torch.rsqrt(var + 1e-5)
    vec = torch.stack([inv_sigma * scale, bias - mean * inv_sigma * scale])
    stat = torch.stack([mean, inv_sigma, scale])
    return feats, vec, stat, bias, w, _bf16(gen, m, cout)


def _close_group_sums(got, want, n, widths, rows=False):
    """A float32 n-term reduction over the columns of several feature
    groups, each group's part (its rows of dW with ``rows``, else each row
    of its [sum; sum of squares] columns) held to its own scale, so a
    group of small values answers to them and not to a larger group's."""
    offs = [0] + list(itertools.accumulate(widths))
    for a, b in zip(offs[:-1], offs[1:]):
        if rows:
            _close_sum(got[a:b], want[a:b], n)
        else:
            for i in range(got.shape[0]):
                _close_sum(got[i, a:b], want[i, a:b], n)


# rows: a ragged 64-row tile and a ragged ROW_CHUNK (and bwd_reduce's
# ragged last chunk); 20 groups: more than one launch of the table fill;
# Ctot not a multiple of bwd_reduce's 64-column block (8, 56, 160, 128 +
# 136) and a group across two of its blocks ([40, 64, 24]); Cout 8, 16,
# 136; the up-block adapter at r = 64, 32 and 16 (M <= 24576: there the
# float32 sum limit is below one bf16 pass's error, so only an exact split
# of relu(y) and W passes)
TB_CASES = [(216, [8], 8), (1000, [16, 24, 8, 8], 16), (2056, [40, 16], 136),
            (216, [8] * 20, 16), (98304, [128, 128, 32, 32], 128),
            (24576, [128, 128, 32, 32], 128), (6144, [128, 128, 32, 32], 128),
            (6144, [40, 64, 24], 8), (1536, [128, 136], 16)]


@pytest.mark.parametrize("m,widths,cout", TB_CASES)
def test_train_bottleneck_kernels(gen, m, widths, cout):
    feats, vec, stat, bias, w, g = _tb_operands(gen, m, widths, cout)
    ctot = sum(widths)
    before = tbk.launch_counts()
    got, want = (fn(feats, torch.empty(2, ctot, device="cuda"))
                 for fn in (tbk.stats, tbk.stats_plain))
    _close_group_sums(got, want, m, widths)
    outs = [torch.empty(m, cout, device="cuda", dtype=torch.bfloat16)
            for _ in range(2)]
    tbk.apply(feats, vec, w.bfloat16(), outs[0])
    tbk.apply_plain(feats, vec, w.bfloat16(), outs[1])
    _close(outs[0], outs[1])
    red = []
    for fn in (tbk.bwd_reduce, tbk.bwd_reduce_plain):
        dw, sums = torch.empty(ctot, cout, device="cuda"), \
            torch.empty(2, ctot, device="cuda")
        red.append(fn(feats, g, stat, bias, w, dw, sums))
    torch.cuda.synchronize()
    _close_group_sums(red[0][0], red[1][0], m, widths, rows=True)
    _close_group_sums(red[0][1], red[1][1], m, widths)
    dxs = []
    for fn in (tbk.bwd_dx, tbk.bwd_dx_plain):
        buf = torch.zeros(m, ctot + 8, device="cuda", dtype=torch.bfloat16)
        offs = [0] + list(torch.tensor(widths).cumsum(0))
        views = [buf[:, int(a):int(b)] for a, b in zip(offs[:-1], offs[1:])]
        fn(feats, g, stat, bias, red[1][1] / m, w, views)
        dxs.append(buf)
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(offs[:-1], offs[1:])):
        _close(dxs[0][:, int(a):int(b)], dxs[1][:, int(a):int(b)])
    assert torch.equal(dxs[0][:, ctot:], dxs[1][:, ctot:])
    after = tbk.launch_counts()
    assert all(after[k] == before[k] + 1 for k in after)


def test_bwd_reduce_split_is_exact_on_one_row(gen):
    """One row passes the gate (y > 0; every other row has x = -1, so
    y = -inv_sigma * scale < 0) and the cotangent is one-hot on it: every
    dW entry and every BN sum is then one exact product, so the kernel
    must give the plain version's bits. A dropped piece of either split
    (relu(y) for dW, W for g W^T) moves them by ~2^-17 of their size,
    which the float32 sum limits cannot see."""
    m, widths, cout, row, hot = 1000, [40, 64, 24], 16, 977, 3
    ctot = sum(widths)
    feats = []
    for c in widths:
        x = -torch.ones(m, c)
        x[row] = torch.rand(c, generator=gen) * 3 + 0.1
        feats.append(x.to("cuda", torch.bfloat16))
    stat = torch.stack([torch.zeros(ctot),
                        torch.rand(ctot, generator=gen) + 0.5,
                        torch.rand(ctot, generator=gen) + 0.5]).cuda()
    bias = torch.zeros(ctot, device="cuda")
    w = torch.randn(ctot, cout, generator=gen).cuda()
    g = torch.zeros(m, cout, device="cuda", dtype=torch.bfloat16)
    g[row, hot] = 1
    got, want = ([torch.empty(ctot, cout, device="cuda"),
                  torch.empty(2, ctot, device="cuda")] for _ in range(2))
    tbk.bwd_reduce(feats, g, stat, bias, w, *got)
    tbk.bwd_reduce_plain(feats, g, stat, bias, w, *want)
    torch.cuda.synchronize()
    assert want[0][:, hot].abs().min() > 0 and want[1][0].abs().min() > 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("m,widths,cout", TB_CASES)
def test_apply_is_affine_dot_over_the_concat(gen, m, widths, cout):
    """apply is affine_dot's kernel in its table form: over the features'
    concat, with the same plan, it gives affine_dot's bits."""
    feats, vec, _, _, w, _ = _tb_operands(gen, m, widths, cout)
    w16 = w.bfloat16()
    got, want = (torch.empty(m, cout, device="cuda", dtype=torch.bfloat16)
                 for _ in range(2))
    before = (tbk.apply.launches, buf_ops.affine_dot.launches)
    tbk.apply(feats, vec, w16, got)
    torch.cuda.synchronize()
    assert (tbk.apply.launches, buf_ops.affine_dot.launches) == \
        (before[0] + 1, before[1])
    buf_ops.affine_dot(torch.cat(feats, 1), vec, w16, want)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,widths,cout", TB_CASES)
def test_bwd_dx_is_exact_under_one_hot_cotangents(gen, m, widths, cout):
    """Every row passes the gate (x > 0, mean and bias 0, scale > 0) and
    row m's cotangent is one-hot at n_m = m % Cout, with red = 0: then
    g_y = W[c, n_m] exactly and dx = bf16(scale * inv_sigma * W[c, n_m]),
    one rounding of exact values, so the kernel must give the plain
    version's bits. W rounded to bf16 (one pass instead of the three-way
    split) changes a share of them."""
    ctot = sum(widths)
    feats = [(torch.rand(m, c, generator=gen) * 3 + 0.1).to(
        "cuda", torch.bfloat16) for c in widths]
    if len(feats) > 1:
        feats[1] = torch.cat([feats[1], feats[1][:, :8]], 1)[:, :widths[1]]
    stat = torch.stack([torch.zeros(ctot),
                        torch.rand(ctot, generator=gen) + 0.5,
                        torch.rand(ctot, generator=gen) + 0.5]).cuda()
    bias = torch.zeros(ctot, device="cuda")
    red = torch.zeros(2, ctot, device="cuda")
    w = torch.randn(ctot, cout, generator=gen).cuda()
    g = torch.zeros(m, cout, device="cuda", dtype=torch.bfloat16)
    g[torch.arange(m), torch.arange(m) % cout] = 1
    outs = []
    for fn, wk in ((tbk.bwd_dx, w), (tbk.bwd_dx_plain, w),
                   (tbk.bwd_dx_plain, w.bfloat16().float())):
        dxs = [torch.empty(m, c, device="cuda", dtype=torch.bfloat16)
               for c in widths]
        fn(feats, g, stat, bias, red, wk, dxs)
        outs.append(torch.cat(dxs, 1))
    torch.cuda.synchronize()
    got, want, one_pass = outs
    assert want.abs().min() > 0
    assert torch.equal(got, want)
    assert (one_pass != want).sum() > 0.05 * want.numel()


def test_train_bottleneck_wrappers_raise(gen):
    feats, vec, _, _, w, _ = _tb_operands(gen, 64, [16, 8], 8)
    out = torch.empty(64, 8, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError):           # float32 features, bf16 w
        tbk.apply([f.float() for f in feats], vec, w.bfloat16(), out)
    with pytest.raises(TypeError):           # bf16 and float32 features
        tbk.stats([feats[0], feats[1].float()],
                  torch.empty(2, 24, device="cuda"))
    with pytest.raises(TypeError):           # float16 features
        tbk.stats([f.half() for f in feats],
                  torch.empty(2, 24, device="cuda"))
    with pytest.raises(ValueError):          # a width not a multiple of 8
        tbk.stats([feats[0][:, :12]], torch.empty(2, 12, device="cuda"))
    with pytest.raises(ValueError):          # rows differ
        tbk.stats([feats[0], feats[1][:32]],
                  torch.empty(2, 24, device="cuda"))


def _bn0_cfg(**kw):
    return ModelConfig(layer_num=2, order=1, loss_num=2, neck_size=2,
                       growth_rate=8, init_chan_num=16, class_num=8,
                       num_blocks=2, compute_dtype="bfloat16", use_pallas=True,
                       bn_tile=0, bn_dtype="compute", remat="none", **kw)


def test_bn_tile0_kernel_step_matches_plain_and_remat(gen):
    """Two slots, bf16, whole-batch BN: every bottleneck and adapter on the
    four kernels; the step repeats bit for bit, is within the train bands
    of the plain path's (the kernels' bottleneck affine runs in float32),
    and remat "layer" / "block" give the same loss and grads bit for bit
    (cuDNN deterministic)."""
    cfg = _bn0_cfg()
    params, state = init_cu_net(cfg, gen, device="cuda")
    x = torch.rand(4, 64, 64, 3, generator=gen).cuda()
    t = torch.rand(4, 16, 16, 8, generator=gen).cuda()
    torch.backends.cudnn.deterministic = True
    try:
        _bn0_checks(cfg, params, state, x, t)
    finally:
        torch.backends.cudnn.deterministic = False


def _bn0_checks(cfg, params, state, x, t):
    buf_ops.reset_launch_counts()
    train_ops.reset_launch_counts()
    tbk.reset_launch_counts()
    lk, gk, sk = _train_grads(cfg, params, state, x, t)
    counts = tbk.launch_counts()
    assert counts["stats"] == counts["apply"] == 25       # per bottleneck
    assert counts["bwd_reduce"] == counts["bwd_dx"] == 25
    assert not any(buf_ops.launch_counts().values())
    lp, gp, sp = _train_grads(dataclasses.replace(cfg, use_pallas=False),
                              params, state, x, t)
    assert abs(lk - lp) <= 1e-2 * abs(lp)
    norm = lambda g: torch.sqrt(sum((v.float() ** 2).sum() for v in g.values()))
    assert 0.85 <= (norm(gk) / norm(gp)).item() <= 1.18
    for k in sp:
        rel = ((sk[k] - sp[k]).norm() / sp[k].norm()).item()
        assert rel <= 1e-2, (k, rel)
    for remat in ("none", "layer", "block"):
        lr, gr, _ = _train_grads(dataclasses.replace(cfg, remat=remat),
                                 params, state, x, t)
        assert lr == lk
        assert all(torch.equal(gr[k], gk[k]) for k in gr), remat


def test_train_bottleneck_shared_table(gen):
    """The four kernels reading one filled feature table (the Function's
    use) give the bits they give when each fills its own."""
    widths, m, cout = [16, 24, 8], 1000, 16
    feats, vec, stat, bias, w, g = _tb_operands(gen, m, widths, cout)
    ctot = sum(widths)
    dxs = {name: [torch.empty(m, c, device="cuda", dtype=torch.bfloat16)
                  for c in widths] for name in ("own", "shared")}
    outs = {}
    for name, table in (("own", None),
                        ("shared", tbk.feature_table(feats,
                                                     dxs["shared"]))):
        st = tbk.stats(feats, torch.empty(2, ctot, device="cuda"),
                       table=table)
        out = torch.empty(m, cout, device="cuda", dtype=torch.bfloat16)
        tbk.apply(feats, vec, w.bfloat16(), out, table=table)
        dw, sums = torch.empty(ctot, cout, device="cuda"), \
            torch.empty(2, ctot, device="cuda")
        tbk.bwd_reduce(feats, g, stat, bias, w, dw, sums, table=table)
        tbk.bwd_dx(feats, g, stat, bias, sums / m, w, dxs[name], table=table)
        outs[name] = [st, out, dw, sums] + dxs[name]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(outs["own"], outs["shared"]))
    with pytest.raises(ValueError):          # a table of two groups for three
        tbk.stats(feats, torch.empty(2, ctot, device="cuda"),
                  table=tbk.feature_table(feats[:2]))


def test_bn_tile0_dropout_runs_the_mask_kernel(gen):
    """Dropout on the bn_tile=0 kernel path: the mask kernel launches in
    the forward and the backward, and the step is bit for bit the step
    with the plain mask swapped in (cuDNN deterministic)."""
    cfg = _bn0_cfg(drop_rate=0.2)
    params, state = init_cu_net(cfg, gen, device="cuda")
    x = torch.rand(4, 64, 64, 3, generator=gen).cuda()
    t = torch.rand(4, 16, 16, 8, generator=gen).cuda()
    seeds = dropmask.draw_slot_seeds(torch.Generator().manual_seed(1), 2)

    def step():
        from cunet_tpu_torch.train import intermediate_mse

        ps = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
        outs, _ = apply_cu_net(ps, state, x, cfg=cfg, train=True,
                               drop_seeds=seeds)
        loss = intermediate_mse(outs, t)
        loss.backward()
        return loss.item(), {k: v.grad for k, v in ps.items()}

    kernel = drop_ops.drop_mask
    torch.backends.cudnn.deterministic = True
    try:
        drop_ops.reset_launch_counts()
        lk, gk = step()
        n = drop_ops.launch_counts()["drop_mask"]
        assert n > 0 and n % 2 == 0          # each layer's forward + backward
        drop_ops.drop_mask = drop_ops.PLAIN[kernel]
        lp, gp = step()
    finally:
        drop_ops.drop_mask = kernel
        torch.backends.cudnn.deterministic = False
    assert lk == lp
    assert all(torch.equal(gk[k], gp[k]) for k in gk)


# ---------------------------------------------------------------------------
# the eval feature-table kernel: per-bottleneck (#6) and per-slot (#4)
# eval, and the face head and bf16 limit on every kernel path
# ---------------------------------------------------------------------------

from cunet_tpu_torch.kernels import bottleneck_infer, eval_ops  # noqa: E402
from cunet_tpu_torch.models.cu_net import (  # noqa: E402
    _fused_slot_eval_hg,
    empty_fifos,
    eval_slots,
)

SMALL = dict(neck_size=2, growth_rate=8, init_chan_num=16, num_blocks=2,
             compute_dtype="bfloat16", use_pallas=True)


@pytest.mark.parametrize("widths,m,n", [((16, 8, 8), 300, 16),
                                        ((32,), 128, 68),
                                        ((16, 16, 8, 8), 2 * 8 * 8, 136)])
@pytest.mark.parametrize("mode", ["single", "shift2", "dual"])
def test_table_dot(gen, widths, m, n, mode):
    """Separate features (the first a strided view of a wider buffer, as
    a FIFO slice is), any row count, N tails (68), a column prefix of a
    wider weight; each output view written and nothing around it."""
    wide = _bf16(gen, m, widths[0] + 24)
    feats = [wide[:, 8:8 + widths[0]]] + [_bf16(gen, m, c)
                                          for c in widths[1:]]
    k = sum(widths)
    v, vs = _vec(gen, k + 8), _vec(gen, k + 8)
    w = _bf16(gen, k + 8, n + 8) * k ** -0.5
    ws = _bf16(gen, k + 8, n + 8) * k ** -0.5
    kw = {}
    if mode == "shift2":
        kw["bias"] = (torch.randn(n, generator=gen) * 0.5).cuda()
    dst = _bf16(gen, m, n + 16)
    dst_s = _bf16(gen, m, n + 8)
    got, want = dst.clone(), dst.clone()
    got_s, want_s = dst_s.clone(), dst_s.clone()
    if mode == "dual":
        kw_k = dict(vec_s=vs, w_s=ws, out_s=got_s[:, :n])
        kw_p = dict(vec_s=vs, w_s=ws, out_s=want_s[:, :n])
    else:
        kw_k = kw_p = kw
    eval_ops.reset_launch_counts()
    eval_ops.table_dot(feats, v, w, got[:, 8:8 + n], **kw_k)
    eval_ops.table_dot_plain(feats, v, w, want[:, 8:8 + n], **kw_p)
    torch.cuda.synchronize()
    assert eval_ops.table_dot.launches == 1
    assert eval_ops.option_counts() == {
        f"table_dot[{o}]": int(mode == o) for o in eval_ops.OPTIONS}
    _close(got[:, 8:8 + n], want[:, 8:8 + n])
    got[:, 8:8 + n].copy_(dst[:, 8:8 + n])
    assert torch.equal(got, dst)
    if mode == "dual":
        _close(got_s[:, :n], want_s[:, :n])
        assert torch.equal(got_s[:, n:], dst_s[:, n:])


def test_table_dot_raises_on_what_the_kernel_does_not_take(gen):
    x, v = _bf16(gen, 64, 16), _vec(gen, 16)
    w, out = _bf16(gen, 16, 8), _bf16(gen, 64, 8)
    with pytest.raises(TypeError):
        eval_ops.table_dot([x.float()], v, w, out)
    with pytest.raises(ValueError):          # a group width off 8
        eval_ops.table_dot([x[:, :12]], v, w, out)
    with pytest.raises(ValueError):          # vec not float32
        eval_ops.table_dot([x], v.bfloat16(), w, out)
    with pytest.raises(ValueError):          # a CPU output
        eval_ops.table_dot([x], v, w, out.cpu())


def test_bottleneck_infer_kernels_match_plain(gen):
    feats = [_bf16(gen, 3, 5, 5, c) for c in (16, 8, 8)]   # M = 75
    inv, shift = _vec(gen, 32)
    w_a, w_s = (torch.randn(1, 1, 32, 16, generator=gen).cuda() * 0.2
                for _ in range(2))
    inv_s, sh_s = _vec(gen, 32)
    eval_ops.reset_launch_counts()
    one = bottleneck_infer.fused_bottleneck_infer(feats, inv, shift, w_a)
    two = bottleneck_infer.fused_dual_bottleneck_infer(
        feats, inv, shift, w_a, inv_s, sh_s, w_s)
    assert eval_ops.table_dot.launches == 2
    assert eval_ops.table_dot.dual_launches == 1
    cpu = [f.cpu() for f in feats]
    _close(one, bottleneck_infer.fused_bottleneck_infer(
        cpu, inv.cpu(), shift.cpu(), w_a.cpu()).cuda())
    assert torch.equal(two[0], one)
    _close(two[1], bottleneck_infer.fused_bottleneck_infer(
        cpu, inv_s.cpu(), sh_s.cpu(), w_s.cpu()).cuda())


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.parametrize("order", [1, 2])
def test_slot_kernels_match_plain_and_count_launches(gen, order):
    """One steady slot on the card against the same slot on the CPU (the
    plain versions): its ~37 launches by kind, and every output."""
    cfg = ModelConfig(layer_num=4, order=order, loss_num=2, class_num=8,
                      **SMALL)
    params, state = init_cu_net(cfg, gen, device="cuda")
    slot = eval_slots(params, state, cfg)[3]
    n, h0, nb = 2, 16, cfg.num_blocks
    y = _bf16(gen, n, h0, h0, 16)
    fifos = empty_fifos(cfg)
    fifos["intermedia"] = [_bf16(gen, n, h0, h0, 16) for _ in range(order)]
    for key, res in (("down", [h0 >> j for j in range(nb)]),
                     ("up", [h0 >> j for j in range(nb)])):
        fifos[key] = [[_bf16(gen, n, r, r, 8) for _ in range(order)]
                      for r in res]
    fifos["neck"] = [_bf16(gen, n, h0 >> nb, h0 >> nb, 8)
                     for _ in range(order)]
    eval_ops.reset_launch_counts()
    buf_ops.reset_launch_counts()
    got = _fused_slot_eval_hg(y, fifos, slot, cfg=cfg, i=3)
    torch.cuda.synchronize()
    npos = 2 * nb + 1
    assert eval_ops.table_dot.launches == 1 + 2 * npos + 1
    assert eval_ops.option_counts() == {
        "table_dot[dual]": nb, "table_dot[shift2]": npos,
        "table_dot[scale]": 0, "table_dot[up]": 0, "table_dot[pool]": 0}
    assert buf_ops.launch_counts() == {"affine_dot": 0, "conv3x3": npos,
                                       "maxpool2": nb, "upsample2": nb}
    to_cpu = lambda t: t.cpu()  # noqa: E731
    cpu_slot = {"inter": tuple(map(to_cpu, slot["inter"])),
                "head": tuple(map(to_cpu, slot["head"])),
                "blocks": [{k: to_cpu(v) for k, v in b.items()}
                           for b in slot["blocks"]]}
    cpu_fifos = {k: [[to_cpu(t) for t in e] for e in v] if k in ("down", "up")
                 else [to_cpu(t) for t in v] for k, v in fifos.items()}
    want = _fused_slot_eval_hg(y.cpu(), cpu_fifos, cpu_slot, cfg=cfg, i=3)
    assert _rel(got[0], want[0].cuda()) <= 3e-2
    assert _rel(got[2], want[2].cuda()) <= 3e-2
    for a, b in zip(got[1]["down"] + got[1]["up"],
                    want[1]["down"] + want[1]["up"]):
        assert _rel(a[-1], b[-1].cuda()) <= 3e-2


@pytest.mark.parametrize("order", [0, 1, 2])
def test_slot_path_forward_matches_plain_and_whole_model(gen, order):
    """The default flags run every slot on #4's kernels: against the plain
    path, and against the whole-model path (#1) on the same slots, whose
    1x1 products walk the same reduction in the same order."""
    cfg = ModelConfig(layer_num=4, order=order, loss_num=2, class_num=8,
                      **SMALL)
    params, state = init_cu_net(cfg, gen, device="cuda")
    x = torch.rand(3, 64, 64, 3, generator=gen).cuda()
    slots = eval_slots(params, state, cfg)
    eval_ops.reset_launch_counts()
    buf_ops.reset_launch_counts()
    per_slot, _ = apply_cu_net(params, state, x, cfg=cfg, slots=slots)
    assert eval_ops.table_dot.launches > 0
    counts = buf_ops.launch_counts()
    assert counts.pop("affine_dot") == 0 and all(counts.values())
    whole, _ = apply_cu_net(params, state, x, slots=slots,
                            cfg=dataclasses.replace(cfg,
                                                    pallas_whole_model=True))
    plain, _ = apply_cu_net(params, state, x, cfg=dataclasses.replace(
        cfg, use_pallas=False))
    for a, b, p in zip(per_slot, whole, plain):
        assert torch.equal(a, b)
        assert _rel(a, p) <= 3e-2


def test_layer_eval_runs_the_bottleneck_kernels(gen):
    cfg = ModelConfig(layer_num=3, order=1, loss_num=3, class_num=8,
                      pallas_hourglass=False, use_scan=False, **SMALL)
    params, state = init_cu_net(cfg, gen, device="cuda")
    x = torch.rand(2, 64, 64, 3, generator=gen).cuda()
    eval_ops.reset_launch_counts()
    buf_ops.reset_launch_counts()
    got, _ = apply_cu_net(params, state, x, cfg=cfg)
    nb, k = cfg.num_blocks, cfg.layer_num
    # per slot: 2nb+1 bottlenecks, nb dual adapter pairs, nb+1 single
    # adapters; the intermedia adapters of slots 1..K-1
    assert eval_ops.table_dot.launches == k * (2 * (2 * nb + 1)) + k - 1
    assert eval_ops.table_dot.dual_launches == nb * k
    assert not any(buf_ops.launch_counts().values())
    plain, _ = apply_cu_net(params, state, x, cfg=dataclasses.replace(
        cfg, use_pallas=False))
    for a, b in zip(got, plain):
        assert _rel(a, b) <= 3e-2


def test_int8_eval_runs_dual_and_int8_kernels(gen):
    """``int8_infer`` with ``use_pallas`` but not the whole-model path:
    the block 1x1 convs on #10, the down blocks' adapter pairs on the float
    dual kernel, the intermedia adapters on the single form."""
    cfg = ModelConfig(layer_num=3, order=1, loss_num=3, class_num=8,
                      **SMALL)
    params, state = init_cu_net(cfg, gen, device="cuda")
    params = quant_eval_params(params, INT8)
    x = torch.rand(2, 64, 64, 3, generator=gen).cuda()
    eval_ops.reset_launch_counts()
    quant_ops.reset_launch_counts()
    got, _ = apply_cu_net(params, state, x, cfg=cfg, quant=INT8)
    nb, k = cfg.num_blocks, cfg.layer_num
    assert eval_ops.table_dot.dual_launches == nb * k
    assert eval_ops.table_dot.launches == nb * k + k - 1
    # bottlenecks (2nb+1) and neck / up adapters (nb+1) per slot on #10
    assert quant_ops.int8_matmul_dequant.launches == k * (3 * nb + 2)
    again, _ = apply_cu_net(params, state, x, cfg=cfg, quant=INT8)
    for a, b in zip(got, again):
        assert torch.isfinite(a.float()).all() and torch.equal(a, b)


def test_face_head_on_every_kernel_path(gen):
    """68 classes (the 300-W model): the whole-model float and int8 paths,
    the per-slot path and a slot-kernel train step run, each head 68 wide
    and the float paths near the plain path."""
    cfg = ModelConfig(layer_num=3, order=1, loss_num=3, class_num=68,
                      **SMALL)
    params, state = init_cu_net(cfg, gen, device="cuda")
    x = torch.rand(2, 64, 64, 3, generator=gen).cuda()
    plain, _ = apply_cu_net(params, state, x, cfg=dataclasses.replace(
        cfg, use_pallas=False))
    for c in (cfg, dataclasses.replace(cfg, pallas_whole_model=True)):
        got, _ = apply_cu_net(params, state, x, cfg=c)
        for a, b in zip(got, plain):
            assert a.shape == (2, 16, 16, 68) and _rel(a, b) <= 3e-2
    qp = quant_eval_params(params, INT8)
    quant_ops.reset_launch_counts()
    q8, _ = apply_cu_net(qp, state, x, quant=INT8,
                         cfg=dataclasses.replace(cfg, pallas_whole_model=True))
    assert quant_ops.affine_dot_i8.launches > 0
    assert all(a.shape == (2, 16, 16, 68) and torch.isfinite(a).all()
               for a in q8)
    tcfg = dataclasses.replace(cfg, bn_tile=1, remat="none")
    t = torch.rand(2, 16, 16, 68, generator=gen).cuda()
    lk, gk, _ = _train_grads(tcfg, params, state, x, t)
    lp, gp, _ = _train_grads(dataclasses.replace(tcfg, use_pallas=False),
                             params, state, x, t)
    assert abs(lk - lp) <= 1e-2 * abs(lp)
    for key in ("heads.2.conv", "heads.0.conv"):
        assert gk[key].shape == (1, 1, 16, 68)
        assert _rel(gk[key], gp[key]) <= 5e-2


def test_f32_kernel_path_raises(gen):
    """float32 runs every kernel path: the float eval paths, ghost-BN and
    bn_tile=0 training, quantized float32 ghost-BN training and the
    quantized float32 eval (the QuanInput and int8 forms at float32), each
    returning float32; only a dtype the kernels do not take (float16)
    raises."""
    cfg = ModelConfig(layer_num=2, order=1, loss_num=2, class_num=8,
                      **{**SMALL, "compute_dtype": "float32"})
    params, state = init_cu_net(cfg, gen, device="cuda")
    x = torch.rand(2, 64, 64, 3, generator=gen).cuda()
    outs, _ = apply_cu_net(params, state, x, cfg=dataclasses.replace(
        cfg, bn_tile=1), train=True, quant=dataclasses.replace(
            INT8, int8_infer=False))
    assert outs[-1].dtype == torch.float32
    for tile in (1, 0):
        outs, _ = apply_cu_net(params, state, x, train=True,
                               cfg=dataclasses.replace(cfg, bn_tile=tile))
        assert outs[-1].dtype == torch.float32
    qp = quant_eval_params(params, INT8)
    for c in (cfg, dataclasses.replace(cfg, pallas_whole_model=True)):
        outs, _ = apply_cu_net(qp, state, x, cfg=c, quant=INT8)
        assert outs[-1].dtype == torch.float32
        assert all(torch.isfinite(o).all() for o in outs)
        outs, _ = apply_cu_net(params, state, x, cfg=c)
        assert outs[-1].dtype == torch.float32
    outs, _ = apply_cu_net(params, state, x, cfg=dataclasses.replace(
        cfg, use_pallas=False))
    assert outs[-1].dtype == torch.float32
    with pytest.raises(NotImplementedError, match="float16"):
        apply_cu_net(params, state, x, cfg=dataclasses.replace(
            cfg, compute_dtype="float16"))


# ---------------------------------------------------------------------------
# the per-block eval (#5): table_dot's upsampled read, pooled store and
# BN2-affine epilogue; the path over them; the whole-model evals #3 and #2
# ---------------------------------------------------------------------------

from cunet_tpu_torch.kernels import fused_model  # noqa: E402
from cunet_tpu_torch.models.cu_net import (  # noqa: E402
    _apply_stem,
    _fused_slot_eval,
    block_slots,
)


@pytest.mark.parametrize("n,r", [(3, 8), (2, 16), (1, 64)])
def test_table_dot_up_and_pool_are_their_compositions(gen, n, r):
    """``[up]`` bit for bit ``upsample2`` then ``table_dot``; ``[pool]``
    (single and dual) bit for bit ``maxpool2`` of the unpooled kernel
    output; ragged last row tiles (3 x 8 x 8 = 192 rows) included."""
    c, g, m = 16, 8, n * r * r
    half, skip, fifo = (_bf16(gen, m // 4, c), _bf16(gen, m, c),
                        _bf16(gen, m, g))
    k = 2 * c + g
    v, vs = _vec(gen, k), _vec(gen, k)
    w, ws = _bf16(gen, k, c) * k ** -0.5, _bf16(gen, k, c) * k ** -0.5
    full = torch.empty(m, c, device="cuda", dtype=torch.bfloat16)
    buf_ops.upsample2(half, n, r // 2, r // 2, full)
    want = torch.empty(m, c, device="cuda", dtype=torch.bfloat16)
    eval_ops.table_dot([full, skip, fifo], v, w, want)
    got = torch.empty_like(want)
    eval_ops.reset_launch_counts()
    eval_ops.table_dot([half, skip, fifo], v, w, got, up=(True, False, False),
                       hw=(r, r))
    assert eval_ops.option_counts()["table_dot[up]"] == 1
    assert torch.equal(got, want)

    feats = [skip, fifo]
    v, vs = v[:, c:].contiguous(), vs[:, c:].contiguous()
    unpooled, s_want = (torch.empty(m, c, device="cuda",
                                    dtype=torch.bfloat16) for _ in range(2))
    eval_ops.table_dot(feats, v, w[c:], unpooled, vec_s=vs, w_s=ws[c:],
                       out_s=s_want)
    pooled = torch.empty(m // 4, c, device="cuda", dtype=torch.bfloat16)
    buf_ops.maxpool2(unpooled, n, r, r, pooled)
    dst = _bf16(gen, m // 4, c + 16)
    s_got = torch.empty_like(s_want)
    got = dst.clone()
    eval_ops.table_dot(feats, v, w[c:], got[:, 8:8 + c], vec_s=vs,
                       w_s=ws[c:], out_s=s_got, pool=True, hw=(r, r))
    assert torch.equal(got[:, 8:8 + c], pooled) and torch.equal(s_got, s_want)
    got[:, 8:8 + c].copy_(dst[:, 8:8 + c])
    assert torch.equal(got, dst)
    one = torch.empty(m // 4, c, device="cuda", dtype=torch.bfloat16)
    eval_ops.table_dot(feats, v, w[c:], one, pool=True, hw=(r, r))
    assert torch.equal(one, pooled)
    assert eval_ops.option_counts()["table_dot[pool]"] == 2


@pytest.mark.parametrize("n_out", [16, 68])
def test_table_dot_scale_epilogue(gen, n_out):
    """BN2's full affine on the float32 sum (#5's bottleneck) against the
    plain version, with an N tail."""
    m = 2 * 8 * 8 + 8
    feats = [_bf16(gen, m, 16), _bf16(gen, m, 8)]
    v, w = _vec(gen, 24), _bf16(gen, 24, n_out) * 24 ** -0.5
    v2 = _vec(gen, n_out)
    got, want = (torch.empty(m, n_out, device="cuda", dtype=torch.bfloat16)
                 for _ in range(2))
    eval_ops.reset_launch_counts()
    eval_ops.table_dot(feats, v, w, got, vec2=v2)
    eval_ops.table_dot_plain(feats, v, w, want, vec2=v2)
    assert eval_ops.option_counts()["table_dot[scale]"] == 1
    _close(got, want)
    assert (got.float() >= 0).all()


def test_table_dot_pool_raises_past_the_tile(gen):
    x, v, w = _bf16(gen, 2 * 128 * 128, 16), _vec(gen, 16), _bf16(gen, 16, 8)
    out = torch.empty(128 * 128 // 2, 8, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="2 \\* W"):
        eval_ops.table_dot([x], v, w, out, pool=True, hw=(128, 128))


@pytest.mark.parametrize("order", [0, 1, 2])
def test_block_path_matches_plain_and_counts_launches(gen, order):
    """``pallas_hourglass=False`` under ``use_scan``: the steady slots on
    #5's kernels, each block's pool and upsample folded in (no
    ``maxpool2`` or ``upsample2`` launch on them); against the plain
    path, and one steady slot against the same slot on the CPU."""
    cfg = ModelConfig(layer_num=order + 3, order=order, loss_num=order + 3,
                      class_num=8, pallas_hourglass=False, **SMALL)
    params, state = init_cu_net(cfg, gen, device="cuda")
    x = torch.rand(3, 64, 64, 3, generator=gen).cuda()
    slots = block_slots(params, state, cfg)
    nb, start = cfg.num_blocks, max(order, 1)
    steady = cfg.layer_num - start
    y = _apply_stem(params, state, x.to(torch.bfloat16), cfg=cfg)
    fifos = empty_fifos(cfg)
    fifos["intermedia"] = [_bf16(gen, *y.shape) for _ in range(order)]
    for key in ("down", "up"):
        fifos[key] = [[_bf16(gen, 3, 16 >> j, 16 >> j, 8)
                       for _ in range(order)] for j in range(nb)]
    fifos["neck"] = [_bf16(gen, 3, 16 >> nb, 16 >> nb, 8)
                     for _ in range(order)]
    eval_ops.reset_launch_counts()
    buf_ops.reset_launch_counts()
    one = _fused_slot_eval(y, fifos, slots[start], cfg=cfg, head=True)
    torch.cuda.synchronize()
    npos = 2 * nb + 1
    # pre + per position (bottleneck, adapters) + head; conv3x3 per position
    assert eval_ops.table_dot.launches == 1 + 2 * npos + 1
    assert eval_ops.option_counts() == {
        "table_dot[dual]": nb, "table_dot[shift2]": 0,
        "table_dot[scale]": npos, "table_dot[up]": 2 * nb,
        "table_dot[pool]": nb}
    assert buf_ops.launch_counts() == {"affine_dot": 0, "conv3x3": npos,
                                       "maxpool2": 0, "upsample2": 0}
    cpu = [{k: (tuple(t.cpu() for t in v) if isinstance(v, tuple) else
                [{kk: t.cpu() for kk, t in b.items()} for b in v]
                if k == "blocks" else v) for k, v in slots[start].items()}]
    cpu_f = {k: [[t.cpu() for t in e] for e in v] if k in ("down", "up")
             else [t.cpu() for t in v] for k, v in fifos.items()}
    want = _fused_slot_eval(y.cpu(), cpu_f, cpu[0], cfg=cfg, head=True)
    assert _rel(one[0], want[0].cuda()) <= 3e-2
    assert _rel(one[2], want[2].cuda()) <= 3e-2

    eval_ops.reset_launch_counts()
    buf_ops.reset_launch_counts()
    got, _ = apply_cu_net(params, state, x, cfg=cfg, slots=slots)
    counts = buf_ops.launch_counts()
    # the prefix slots run layer by layer (#6, cuDNN convs, torch pools)
    assert counts == {"affine_dot": 0, "conv3x3": steady * npos,
                      "maxpool2": 0, "upsample2": 0}
    assert eval_ops.option_counts()["table_dot[pool]"] == steady * nb
    plain, _ = apply_cu_net(params, state, x, cfg=dataclasses.replace(
        cfg, use_pallas=False))
    for a, p in zip(got, plain):
        assert a.shape == (3, 16, 16, 8) and _rel(a, p) <= 3e-2


@pytest.mark.parametrize("order", [0, 1, 2])
def test_fused_model_evals_are_the_whole_model_path(gen, order):
    """#3's every-slot heads and #2's anchored heads: their anchored heads
    bit for bit the whole-model path's (the same kernels in the same
    order), every head near the plain path's slot heads."""
    cfg = ModelConfig(layer_num=4, order=order, loss_num=2, class_num=8,
                      pallas_whole_model=True, **SMALL)
    params, state = init_cu_net(cfg, gen, device="cuda")
    x = torch.rand(2, 64, 64, 3, generator=gen).cuda()
    slots = eval_slots(params, state, cfg)
    whole, _ = apply_cu_net(params, state, x, cfg=cfg, slots=slots)
    y = _apply_stem(params, state, x.to(torch.bfloat16), cfg=cfg)
    buf_ops.reset_launch_counts()
    every = fused_model.fused_model_loop_infer(y, slots, cfg)
    assert buf_ops.affine_dot.launches > 0
    unrolled = fused_model.fused_model_infer(y, slots, cfg)
    assert every.shape == (2, 4, 16, 16, 8) and len(unrolled) == 2
    for a, w, u in zip(cfg.anchors, whole, unrolled):
        assert torch.equal(every[:, a - 1], w) and torch.equal(u, w)
    plain_cfg = dataclasses.replace(cfg, use_pallas=False,
                                    loss_num=cfg.layer_num)
    plain, _ = apply_cu_net(params, state, x, cfg=plain_cfg)
    for i, p in enumerate(plain):
        assert _rel(every[:, i], p) <= 3e-2


# ---------------------------------------------------------------------------
# the float32 forms of the eval kernels (csrc/f32_kernels.cu, and the
# float32 maxpool2 / upsample2): against their plain versions at float32
# (TF32 off) within the float32 n-term bound, bit for bit under one-hot
# weights; the float32 eval paths
# ---------------------------------------------------------------------------

F32_SUM = 1e-5      # PERF.md section 2: |k - p| <= 1e-5 sqrt(n) max|p|


def _f32(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen) * scale).cuda()


def _close_f32(got, want, n):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    bound = F32_SUM * n ** 0.5 * want.abs().max().item() + 1e-6
    assert (got - want).abs().max().item() <= bound


def _one_hot(gen, k, n, rows=None):
    """A (k, n) float32 weight with one 1 in each column (at ``rows``, or
    at random rows below k)."""
    if rows is None:
        rows = torch.randint(0, k, (n,), generator=gen)
    w = torch.zeros(k, n)
    w[rows, torch.arange(n)] = 1.0
    return w.cuda()


@pytest.mark.parametrize("m,k,n,bias", [(520, 24, 16, False),
                                        (520, 40, 16, True),
                                        (2048, 192, 128, True),
                                        (300, 136, 72, False),
                                        (4096, 320, 128, True)])
def test_affine_dot_f32(gen, m, k, n, bias):
    """Against the plain version within the float32 bound (a strided x
    prefix, a strided output view), and bit for bit under a one-hot W,
    with and without the shift + ReLU epilogue."""
    wide = _f32(gen, m, k + 24)
    v = _vec(gen, k + 8)
    b = (torch.randn(n, generator=gen) * 0.5).cuda() if bias else None
    for hot in (False, True):
        w = (torch.cat([_one_hot(gen, k, n), torch.zeros(8, n).cuda()])
             if hot else _f32(gen, k + 8, n, scale=k ** -0.5))
        dst = _f32(gen, m, n + 16)
        got, want = dst.clone(), dst.clone()
        before = buf_ops.affine_dot.f32_launches
        buf_ops.affine_dot(wide[:, :k], v, w, got[:, 8:8 + n], bias=b)
        buf_ops.affine_dot_plain(wide[:, :k], v, w, want[:, 8:8 + n], b)
        torch.cuda.synchronize()
        assert buf_ops.affine_dot.f32_launches == before + 1
        if hot:
            assert torch.equal(got, want)
        else:
            _close_f32(got[:, 8:8 + n], want[:, 8:8 + n], k)
            got[:, 8:8 + n].copy_(dst[:, 8:8 + n])
            assert torch.equal(got, dst)


def test_affine_dot_f32_head_slot(gen):
    b, r, k, cls = 8, 16, 32, 72
    x, v = _f32(gen, b * r * r, k), _vec(gen, k)
    w = _f32(gen, k, cls, scale=k ** -0.5)
    heads = _f32(gen, b, 3, r, r, cls)
    got, want = heads.clone(), heads.clone()
    buf_ops.affine_dot(x, v, w, got[:, 1].view(b, r * r, cls))
    buf_ops.affine_dot_plain(x, v, w, want[:, 1].view(b, r * r, cls))
    torch.cuda.synchronize()
    _close_f32(got, want, k)
    got[:, 1] = heads[:, 1]
    assert torch.equal(got, heads)


def _shifted(y, n, r, c, rows, g):
    """The SAME 3x3 conv of y (n*r*r, c) under the one-hot weight with
    column j's 1 at packed row rows[j] (tap-major): each output column a
    shifted input channel, zero outside the image; exact."""
    img = torch.nn.functional.pad(y.view(n, r, r, c), (0, 0, 1, 1, 1, 1))
    out = torch.empty(n, r, r, g, device=y.device)
    for j, row in enumerate(rows.tolist()):
        tap, ch = divmod(row, c)
        dy, dx = divmod(tap, 3)
        out[..., j] = img[:, dy:dy + r, dx:dx + r, ch]
    return out.view(n * r * r, g)


@pytest.mark.parametrize("cb,g,r,n", [(16, 8, 8, 3), (48, 24, 4, 3),
                                      (128, 32, 16, 2), (64, 40, 5, 2),
                                      (32, 16, 64, 4)])
def test_conv3x3_f32(gen, cb, g, r, n):
    """K split across blocks at small M (two to nine partials, added in
    split order: a repeat gives the same bits), whole at large M."""
    m = n * r * r
    splits = buf_ops.conv3x3_plan_f32(m, cb, g).splits
    assert (splits > 1) == (m < 16384)
    y = _f32(gen, m, cb)
    w3 = _f32(gen, 9 * cb, g, scale=(9 * cb) ** -0.5)
    dst = _f32(gen, m, g + 16)
    got, want = dst.clone(), dst.clone()
    before = buf_ops.conv3x3.f32_launches
    buf_ops.conv3x3(y, w3, n, r, r, got[:, 8:8 + g])
    buf_ops.conv3x3_plain(y, w3, n, r, r, want[:, 8:8 + g])
    torch.cuda.synchronize()
    assert buf_ops.conv3x3.f32_launches == before + 1
    _close_f32(got[:, 8:8 + g], want[:, 8:8 + g], 9 * cb)
    again = dst.clone()
    buf_ops.conv3x3(y, w3, n, r, r, again[:, 8:8 + g])
    torch.cuda.synchronize()
    assert torch.equal(again, got)
    got[:, 8:8 + g].copy_(dst[:, 8:8 + g])
    assert torch.equal(got, dst)
    rows = torch.randint(0, 9 * cb, (g,), generator=gen)
    out = torch.empty(m, g, device="cuda")
    buf_ops.conv3x3(y, _one_hot(gen, 9 * cb, g, rows), n, r, r, out)
    torch.cuda.synchronize()
    assert torch.equal(out, _shifted(y, n, r, cb, rows, g))


def test_conv3x3_f32_split_on_two_streams(gen):
    """Split convs launched at once on two streams, each with its own
    partials and arrival counters: each gives its plain version's sum
    and its own first answer's bits."""
    n, r, cb, g = 2, 8, 128, 32
    m = n * r * r
    assert buf_ops.conv3x3_plan_f32(m, cb, g).splits > 1
    ys = [_f32(gen, m, cb) for _ in range(2)]
    ws = [_f32(gen, 9 * cb, g, scale=(9 * cb) ** -0.5) for _ in range(2)]
    wants = [buf_ops.conv3x3_plain(y, w, n, r, r, torch.empty(m, g).cuda())
             for y, w in zip(ys, ws)]
    firsts = [buf_ops.conv3x3(y, w, n, r, r, torch.empty(m, g).cuda())
              for y, w in zip(ys, ws)]
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = [[torch.empty(m, g).cuda() for _ in range(50)] for _ in range(2)]
    torch.cuda.synchronize()
    for i in range(50):
        for s, y, w, o in zip(streams, ys, ws, outs):
            with torch.cuda.stream(s):
                buf_ops.conv3x3(y, w, n, r, r, o[i])
    torch.cuda.synchronize()
    for want, first, o in zip(wants, firsts, outs):
        _close_f32(first, want, 9 * cb)
        assert all(torch.equal(got, first) for got in o)


@pytest.mark.parametrize("r", [16, 2])
def test_maxpool2_upsample2_f32(gen, r):
    n, c = 2, 20                       # 20 channels: 16-byte vectors of 4
    x = _f32(gen, n * r * r, c)
    for kern, rows, plain in ((buf_ops.maxpool2, n * r * r // 4,
                               buf_ops.maxpool2_plain),
                              (buf_ops.upsample2, n * 4 * r * r,
                               buf_ops.upsample2_plain)):
        dst = _f32(gen, rows, c + 12)
        got, want = dst.clone(), dst.clone()
        before = kern.f32_launches
        kern(x, n, r, r, got[:, 4:4 + c])
        plain(x, n, r, r, want[:, 4:4 + c])
        torch.cuda.synchronize()
        assert kern.f32_launches == before + 1
        assert torch.equal(got, want)
    with pytest.raises(TypeError):            # float32 into bf16
        buf_ops.maxpool2(x[:, :16], n, r, r, torch.empty(
            n * r * r // 4, 16, device="cuda", dtype=torch.bfloat16))


@pytest.mark.parametrize("widths,m,n", [((16, 8, 8), 300, 16),
                                        ((32,), 128, 68),
                                        ((16, 16, 8, 8), 2 * 8 * 8, 136)])
@pytest.mark.parametrize("mode", ["single", "shift2", "scale", "dual"])
def test_table_dot_f32(gen, widths, m, n, mode):
    """Every epilogue and the dual form, N tails, a strided feature and a
    column prefix of a wider weight; within the float32 bound of the plain
    version, and bit for bit under one-hot weights."""
    wide = _f32(gen, m, widths[0] + 24)
    feats = [wide[:, 8:8 + widths[0]]] + [_f32(gen, m, c)
                                          for c in widths[1:]]
    k = sum(widths)
    v, vs = _vec(gen, k + 8), _vec(gen, k + 8)
    kw = {}
    if mode == "shift2":
        kw["bias"] = (torch.randn(n, generator=gen) * 0.5).cuda()
    if mode == "scale":
        kw["vec2"] = _vec(gen, n)
    for hot in (False, True):
        if hot:
            w = torch.cat([_one_hot(gen, k, n + 8),
                           torch.zeros(8, n + 8).cuda()])
            ws = torch.cat([_one_hot(gen, k, n + 8),
                            torch.zeros(8, n + 8).cuda()])
        else:
            w = _f32(gen, k + 8, n + 8, scale=k ** -0.5)
            ws = _f32(gen, k + 8, n + 8, scale=k ** -0.5)
        dst, dst_s = _f32(gen, m, n + 16), _f32(gen, m, n + 8)
        got, want = dst.clone(), dst.clone()
        got_s, want_s = dst_s.clone(), dst_s.clone()
        kw_k, kw_p = dict(kw), dict(kw)
        if mode == "dual":
            kw_k.update(vec_s=vs, w_s=ws, out_s=got_s[:, :n])
            kw_p.update(vec_s=vs, w_s=ws, out_s=want_s[:, :n])
        eval_ops.reset_launch_counts()
        eval_ops.table_dot(feats, v, w, got[:, 8:8 + n], **kw_k)
        eval_ops.table_dot_plain(feats, v, w, want[:, 8:8 + n], **kw_p)
        torch.cuda.synchronize()
        assert eval_ops.table_dot.launches == 1
        assert eval_ops.f32_counts() == {"table_dot[f32]": 1}
        if hot:
            assert torch.equal(got, want) and torch.equal(got_s, want_s)
            continue
        _close_f32(got[:, 8:8 + n], want[:, 8:8 + n], k)
        got[:, 8:8 + n].copy_(dst[:, 8:8 + n])
        assert torch.equal(got, dst)
        if mode == "dual":
            _close_f32(got_s[:, :n], want_s[:, :n], k)
            assert torch.equal(got_s[:, n:], dst_s[:, n:])


@pytest.mark.parametrize("n,r", [(3, 8), (2, 16), (1, 64)])
def test_table_dot_f32_up_and_pool_are_their_compositions(gen, n, r):
    """At float32: ``[up]`` bit for bit ``upsample2`` then ``table_dot``;
    ``[pool]`` (single and dual) bit for bit ``maxpool2`` of the unpooled
    output; each within the float32 bound of its plain version."""
    c, g, m = 16, 8, n * r * r
    half = _f32(gen, m // 4, c)
    skip, fifo = _f32(gen, m, c), _f32(gen, m, g)
    k = 2 * c + g
    v, vs = _vec(gen, k), _vec(gen, k)
    w, ws = _f32(gen, k, c, scale=k ** -0.5), _f32(gen, k, c, scale=k ** -0.5)
    up_got = torch.empty(m, c, device="cuda")
    eval_ops.table_dot([half, skip, fifo], v, w, up_got,
                       up=(True, False, False), hw=(r, r))
    full = torch.empty(m, c, device="cuda")
    buf_ops.upsample2(half, n, r // 2, r // 2, full)
    comp = torch.empty(m, c, device="cuda")
    eval_ops.table_dot([full, skip, fifo], v, w, comp)
    plain = torch.empty(m, c, device="cuda")
    eval_ops.table_dot_plain([half, skip, fifo], v, w, plain,
                             up=(True, False, False), hw=(r, r))
    torch.cuda.synchronize()
    assert torch.equal(up_got, comp)
    _close_f32(up_got, plain, k)
    for dual in (False, True):
        kw = dict(vec_s=vs, w_s=ws) if dual else {}
        pooled = torch.empty(m // 4, c, device="cuda")
        s_got = torch.empty(m, c, device="cuda")
        eval_ops.table_dot([full, skip, fifo], v, w, pooled, pool=True,
                           hw=(r, r), **kw, **({"out_s": s_got} if dual
                                                else {}))
        unpooled = torch.empty(m, c, device="cuda")
        s_ref = torch.empty(m, c, device="cuda")
        eval_ops.table_dot([full, skip, fifo], v, w, unpooled, **kw,
                           **({"out_s": s_ref} if dual else {}))
        ref = torch.empty(m // 4, c, device="cuda")
        buf_ops.maxpool2(unpooled, n, r, r, ref)
        torch.cuda.synchronize()
        assert torch.equal(pooled, ref)
        if dual:
            assert torch.equal(s_got, s_ref)


def test_affine_dot_f32_is_table_dot_bit_for_bit(gen):
    """The whole-model path's 1x1 (a prefix of the channel-plane buffer)
    and the per-slot path's (separate groups) at float32: the same bits."""
    m, widths = 1000, (64, 32, 16, 8)
    buf = _f32(gen, m, sum(widths) + 8)
    offs = [sum(widths[:i]) for i in range(len(widths))]
    feats = [buf[:, o:o + c].clone() for o, c in zip(offs, widths)]
    k = sum(widths)
    v, w = _vec(gen, k), _f32(gen, k, 128, scale=k ** -0.5)
    b = (torch.randn(128, generator=gen) * 0.5).cuda()
    got, want = (torch.empty(m, 128, device="cuda") for _ in range(2))
    buf_ops.affine_dot(buf[:, :k], v, w, got, bias=b)
    eval_ops.table_dot(feats, v, w, want, bias=b)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_f32_conv2d_ignores_the_global_tf32_flag(gen):
    """The port's float32 conv (the stem) runs in full float32 with
    cuDNN's TF32 switched on globally."""
    from cunet_tpu_torch.ops.layers import conv2d

    x, w = _f32(gen, 2, 32, 32, 64), _f32(gen, 3, 3, 64, 32, scale=0.05)
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = conv2d(x, w, padding=1)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    want = conv2d(x.double().cpu(), w.double().cpu(), padding=1)
    err = (got.double().cpu() - want).abs().max().item()
    assert err <= F32_SUM * (9 * 64) ** 0.5 * want.abs().max().item()


F32_SMALL = {**SMALL, "compute_dtype": "float32"}


@pytest.mark.parametrize("order", [0, 1, 2])
def test_f32_eval_paths_match_plain_and_each_other(gen, order):
    """compute_dtype float32 on the card: the per-slot path bit for bit the
    whole-model path; each of them, the per-block and the per-bottleneck
    path within relative L2 1e-4 of the plain path at float32; every eval
    kernel's float32 form launched."""
    cfg = ModelConfig(layer_num=order + 3, order=order, loss_num=2,
                      class_num=8, **F32_SMALL)
    params, state = init_cu_net(cfg, gen, device="cuda")
    x = torch.rand(3, 64, 64, 3, generator=gen).cuda()
    plain, _ = apply_cu_net(params, state, x, cfg=dataclasses.replace(
        cfg, use_pallas=False))
    slots = eval_slots(params, state, cfg)
    buf_ops.reset_launch_counts()
    eval_ops.reset_launch_counts()
    per_slot, _ = apply_cu_net(params, state, x, cfg=cfg, slots=slots)
    whole, _ = apply_cu_net(params, state, x, slots=slots,
                            cfg=dataclasses.replace(cfg,
                                                    pallas_whole_model=True))
    assert all(buf_ops.f32_counts().values())
    assert eval_ops.f32_counts()["table_dot[f32]"] > 0
    blocks, _ = apply_cu_net(params, state, x, cfg=dataclasses.replace(
        cfg, pallas_hourglass=False))
    layers, _ = apply_cu_net(params, state, x, cfg=dataclasses.replace(
        cfg, pallas_hourglass=False, use_scan=False))
    for a, b, c, d, p in zip(per_slot, whole, blocks, layers, plain):
        assert a.dtype == torch.float32 and torch.equal(a, b)
        for t in (a, c, d):
            assert _rel(t, p) <= 1e-4


# ---------------------------------------------------------------------------
# float32 whole-batch BN training: #7's and the mask kernel's float32 forms,
# the float32 conv's backward, the bn_tile=0 step at float32
# ---------------------------------------------------------------------------


def _tb_f32(gen, m, widths, cout):
    """``_tb_operands`` at float32 (the features off the bf16 grid):
    features, vectors, statistics, a float32 cotangent."""
    feats, _, stat, bias, w, g = _tb_operands(gen, m, widths, cout)
    feats = [f.float() + 0.01 * _f32(gen, *f.shape) for f in feats]
    if len(feats) > 1:                       # a strided view again
        feats[1] = torch.cat([feats[1], feats[1][:, :8]], 1)[:, :widths[1]]
    sums = tbk.stats_plain(feats, torch.empty(2, sum(widths), device="cuda"))
    mean = sums[0] / m
    inv_sigma = torch.rsqrt(sums[1] / m - mean * mean + 1e-5)
    scale = stat[2]
    vec = torch.stack([inv_sigma * scale, bias - mean * inv_sigma * scale])
    stat = torch.stack([mean, inv_sigma, scale])
    return feats, vec, stat, bias, w, g.float() + 0.01 * _f32(gen, m, cout)


def _tb_f32_outputs(fns, feats, vec, stat, bias, w, g):
    """stats, apply, bwd_reduce's (dw, sums) and bwd_dx's dx of the
    functions ``fns`` (the kernels or the plain versions) at float32."""
    m, ctot, cout = feats[0].shape[0], w.shape[0], w.shape[1]
    st = fns[0](feats, torch.empty(2, ctot, device="cuda"))
    out = fns[1](feats, vec, w, torch.empty(m, cout, device="cuda"))
    dw, sums = fns[2](feats, g, stat, bias, w,
                      torch.empty(ctot, cout, device="cuda"),
                      torch.empty(2, ctot, device="cuda"))
    dxs = [torch.empty(m, f.shape[1], device="cuda") for f in feats]
    fns[3](feats, g, stat, bias, sums / m, w, dxs)
    torch.cuda.synchronize()
    return st, out, dw, sums, dxs


# (past 128 outputs the float32 reduce and dx take two halves of g's
# planes: 136 and 144 leave the second 8 and 16 wide)
TB_F32_CASES = [(98304, [128, 128, 32, 32], 128),
                (384, [128, 128, 32, 32], 128), (1000, [16, 24, 8, 8], 16),
                (2056, [40, 16], 136), (216, [8] * 20, 16),
                (640, [64, 40], 144)]


@pytest.mark.parametrize("m,widths,cout", TB_F32_CASES)
def test_train_bottleneck_kernels_f32(gen, m, widths, cout):
    """Each float32 form against its plain version within the float32
    n-term bound (the sums per feature group), counted as float32
    launches (stats two: the chunks' sums and their total; bwd_reduce two:
    the split of g and the reduce; bwd_dx called without the reduce's
    planes two: the split and its kernel); apply over
    any number of groups (20 in the fifth case: the float32 product's
    table read from device memory)."""
    ops = _tb_f32(gen, m, widths, cout)
    tbk.reset_launch_counts()
    got = _tb_f32_outputs(tbk.KERNELS, *ops)
    assert tbk.f32_counts() == {"stats[f32]": 2, "apply[f32]": 1,
                                "bwd_reduce[f32]": 2, "bwd_dx[f32]": 2}
    want = _tb_f32_outputs([tbk.PLAIN[k] for k in tbk.KERNELS], *ops)
    _close_group_sums(got[0], want[0], m, widths)
    _close_f32(got[1], want[1], sum(widths))
    _close_group_sums(got[2], want[2], m, widths, rows=True)
    _close_group_sums(got[3], want[3], m, widths)
    for a, b in zip(got[4], want[4]):
        assert a.dtype == torch.float32
        _close_f32(a, b, cout)


@pytest.mark.parametrize("cout", [192, 256])
def test_bwd_reduce_f32_two_halves(gen, cout):
    """bwd_reduce at float32 with 192 and 256 outputs (two halves of g's
    planes, the second 64 and 128 wide; past bwd_dx's float32 width):
    dW and the sums within the float32 n-term bound of the plain
    version, per feature group, two float32 launches."""
    m, widths = 1000, [64, 40]
    feats, _, stat, bias, w, g = _tb_f32(gen, m, widths, cout)
    ctot = sum(widths)

    def run(fn):
        out = fn(feats, g, stat, bias, w,
                 torch.empty(ctot, cout, device="cuda"),
                 torch.empty(2, ctot, device="cuda"))
        torch.cuda.synchronize()
        return out

    before = tbk.bwd_reduce.f32_launches
    got = run(tbk.bwd_reduce)
    assert tbk.bwd_reduce.f32_launches == before + 2
    want = run(tbk.bwd_reduce_plain)
    _close_group_sums(got[0], want[0], m, widths, rows=True)
    _close_group_sums(got[1], want[1], m, widths)


@pytest.mark.parametrize("cout", [160, 192, 256])
def test_bwd_dx_f32_two_halves(gen, cout):
    """bwd_dx at float32 past 144 outputs (two halves of g's planes, the
    second 32, 64 and 128 wide): dx within the float32 Cout-term bound of
    the plain version; on the planes bwd_reduce hands over (one float32
    launch) bit for bit a call that splits g itself (two)."""
    m, widths = 1000, [64, 40]
    feats, _, stat, bias, w, g = _tb_f32(gen, m, widths, cout)
    ctot = sum(widths)
    planes = torch.empty(tbk.split_planes_shape(m, cout), device="cuda",
                         dtype=torch.bfloat16)
    _, sums = tbk.bwd_reduce(feats, g, stat, bias, w,
                             torch.empty(ctot, cout, device="cuda"),
                             torch.empty(2, ctot, device="cuda"),
                             planes=planes)

    def run(fn, **kw):
        d = [torch.empty(m, c, device="cuda") for c in widths]
        fn(feats, g, stat, bias, sums / m, w, d, **kw)
        torch.cuda.synchronize()
        return d

    before = tbk.bwd_dx.f32_launches
    handed = run(tbk.bwd_dx, planes=planes)
    assert tbk.bwd_dx.f32_launches == before + 1
    alone = run(tbk.bwd_dx)
    assert tbk.bwd_dx.f32_launches == before + 3
    for a, b, c in zip(handed, alone, run(tbk.bwd_dx_plain)):
        assert torch.equal(a, b)
        _close_f32(a, c, cout)


@pytest.mark.parametrize("m,widths,cout", TB_F32_CASES[:3])
def test_train_bottleneck_f32_exact_under_one_hot(gen, m, widths, cout):
    """Under a one-hot W (distinct rows) every float32 form gives its plain
    version's bits where the plain sums are exact: apply (the prologue
    value), bwd_dx with red = 0 (g_y = g[m, n_c], one term), and, under a
    cotangent with one 1 a column too, bwd_reduce (each dW entry and BN
    sum one exact term). g rounded to bf16 (one pass of its split) moves
    dx."""
    feats, vec, stat, bias, _, g = _tb_f32(gen, m, widths, cout)
    ctot = sum(widths)
    w = _one_hot(gen, ctot, cout, torch.randperm(ctot, generator=gen)[:cout])
    outs = [fn(feats, vec, w, torch.empty(m, cout, device="cuda"))
            for fn in (tbk.apply, tbk.apply_plain)]
    red = torch.zeros(2, ctot, device="cuda")
    dxs = []
    for fn, gk in ((tbk.bwd_dx, g), (tbk.bwd_dx_plain, g),
                   (tbk.bwd_dx_plain, g.bfloat16().float())):
        d = [torch.empty(m, c, device="cuda") for c in widths]
        fn(feats, gk, stat, bias, red, w, d)
        dxs.append(torch.cat(d, 1))
    hot = torch.zeros(m, cout, device="cuda")
    hot[torch.randint(0, m, (cout,), generator=gen), torch.arange(cout)] = 1
    reds = [fn(feats, hot, stat, bias, w,
               torch.empty(ctot, cout, device="cuda"),
               torch.empty(2, ctot, device="cuda"))
            for fn in (tbk.bwd_reduce, tbk.bwd_reduce_plain)]
    torch.cuda.synchronize()
    assert torch.equal(*outs)
    assert torch.equal(dxs[0], dxs[1]) and dxs[1].abs().max() > 0
    assert (dxs[2] != dxs[1]).sum() > 0.05 * dxs[1].numel()
    assert reds[1][0].abs().max() > 0
    assert torch.equal(reds[0][0], reds[1][0])
    assert torch.equal(reds[0][1], reds[1][1])


@pytest.mark.parametrize("m,widths,cout", TB_F32_CASES[:4])
def test_apply_f32_is_affine_dot_over_the_concat(gen, m, widths, cout):
    feats, vec, _, _, w, _ = _tb_f32(gen, m, widths, cout)
    got, want = (torch.empty(m, cout, device="cuda") for _ in range(2))
    tbk.apply(feats, vec, w, got)
    buf_ops.affine_dot(torch.cat(feats, 1), vec, w, want)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("r", [64, 4])
def test_fused_train_bottleneck_f32_grads(gen, r):
    """The autograd Function at float32 on the kernels against itself on
    the plain versions: output and every gradient within its bound."""
    n, widths, cout = 24, [128, 128, 32, 32], 128
    feats, _, stat, bias, w, g = _tb_f32(gen, n * r * r, widths, cout)
    res = []
    for plain in (False, True):
        saved = {k.__name__: k for k in tbk.KERNELS}
        if plain:
            for k in tbk.KERNELS:
                setattr(tbk, k.__name__, tbk.PLAIN[k])
        try:
            fs = [f.contiguous().view(n, r, r, -1).requires_grad_(True)
                  for f in feats]
            sc = stat[2].clone().requires_grad_(True)
            b = bias.clone().requires_grad_(True)
            wv = w.view(1, 1, *w.shape).clone().requires_grad_(True)
            out, _, _ = tbk.fused_train_bottleneck(fs, sc, b, wv)
            out.backward(g.view(n, r, r, cout))
            res.append([out] + [f.grad for f in fs]
                       + [sc.grad, b.grad, wv.grad[0, 0]])
        finally:
            for name, fn in saved.items():
                setattr(tbk, name, fn)
    got, want = res
    m, ctot = n * r * r, sum(widths)
    assert got[0].dtype == torch.float32
    _close_f32(got[0], want[0], ctot)
    for a, b in zip(got[1:5], want[1:5]):
        assert a.dtype == torch.float32
        _close_f32(a, b, cout)
    _close_group_sums(got[5][None], want[5][None], m, widths)
    _close_group_sums(got[6][None], want[6][None], m, widths)
    _close_group_sums(got[7], want[7], m, widths, rows=True)


@pytest.mark.parametrize("g,r,rate", [(32, 64, 0.2), (8, 4, 0.5)])
def test_drop_mask_f32_bit_identical(gen, g, r, rate):
    """The float32 form, in place on a strided view and into another
    float32 view, bit for bit its plain version (the mask's scale at
    float32); on ones the plain float32 tile masks."""
    n, bt = 24, 0
    m, tile_rows = n * r * r, (bt or n) * r * r
    for seed, pos in ((7, 0), (-123456, 8)):
        before = drop_ops.drop_mask.f32_launches
        _check(drop_ops.drop_mask,
               lambda f, o: f(o[:, 16:16 + g], seed, pos, rate, tile_rows),
               _f32(gen, m, 16 + g + 8), lambda o: o[:, 16:16 + g])
        assert drop_ops.drop_mask.f32_launches == before + 1
        ones = torch.ones(m, g, device="cuda")
        drop_ops.drop_mask(ones, seed, pos, rate, tile_rows)
        assert torch.equal(ones, dropmask.rows_mask(
            seed, pos, m, g, tile_rows, rate, torch.float32, "cuda"))
        d = _f32(gen, m, g + 8)[:, 4:4 + g]
        outs = [torch.empty(m, g, device="cuda") for _ in range(2)]
        drop_ops.drop_mask(d, seed, pos, rate, tile_rows, outs[0])
        drop_ops.PLAIN[drop_ops.drop_mask](d, seed, pos, rate, tile_rows,
                                           outs[1])
        assert torch.equal(outs[0], outs[1])


def test_f32_conv2d_backward_ignores_the_global_tf32_flag(gen):
    """dX and dW of the port's float32 conv with cuDNN's TF32 on globally
    (torch's default): within the float32 bound of a float64 reference
    (one CU-Net 3x3 conv, 128 -> 32)."""
    from cunet_tpu_torch.ops.layers import conv2d

    x = _f32(gen, 4, 32, 32, 128).requires_grad_(True)
    w = _f32(gen, 3, 3, 128, 32, scale=(9 * 128) ** -0.5).requires_grad_(True)
    ct = _f32(gen, 4, 32, 32, 32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        conv2d(x, w, padding=1).backward(ct)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    x64 = x.detach().double().cpu().requires_grad_(True)
    w64 = w.detach().double().cpu().requires_grad_(True)
    conv2d(x64, w64, padding=1).backward(ct.double().cpu())
    for got, want, n in ((x.grad, x64.grad, 9 * 32),
                         (w.grad, w64.grad, 4 * 32 * 32)):
        err = (got.double().cpu() - want).abs().max().item()
        assert err <= F32_SUM * n ** 0.5 * want.abs().max().item()


def test_bn_tile0_f32_kernel_step_matches_plain_and_remat(gen):
    """Two slots at float32, whole-batch BN: every bottleneck and adapter
    on #7's float32 forms; the loss and every BN running stat within 1e-5
    relative of the plain path's; each gradient leaf within relative L2
    max(2c, 1e-5) of the swap step (the same path with #7's plain versions
    swapped in: the same arithmetic, so only the kernels differ), c the
    largest of three controls, the swap step against itself on the batch
    permuted three ways (only the order of the whole-batch sums changes);
    remat "layer" / "block" bit for bit; with dropout 0.2 the masks on the mask
    kernel's float32 form, bit for bit the step with the plain mask (cuDNN
    deterministic)."""
    cfg = dataclasses.replace(_bn0_cfg(), compute_dtype="float32")
    params, state = init_cu_net(cfg, gen, device="cuda")
    x = torch.rand(4, 64, 64, 3, generator=gen).cuda()
    t = torch.rand(4, 16, 16, 8, generator=gen).cuda()
    seeds = dropmask.draw_slot_seeds(torch.Generator().manual_seed(1), 2)

    def grads(c, x, t, **kw):
        from cunet_tpu_torch.train import intermediate_mse

        ps = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
        outs, st = apply_cu_net(ps, state, x, cfg=c, train=True, **kw)
        loss = intermediate_mse(outs, t)
        loss.backward()
        return loss.item(), {k: v.grad for k, v in ps.items()}, st

    plain = dataclasses.replace(cfg, use_pallas=False)
    perms = torch.tensor([[2, 0, 3, 1], [1, 3, 0, 2], [3, 2, 1, 0]],
                         device="cuda")
    drop = dataclasses.replace(cfg, drop_rate=0.2)
    kernel = drop_ops.drop_mask
    torch.backends.cudnn.deterministic = True
    try:
        tbk.reset_launch_counts()
        lk, gk, sk = grads(cfg, x, t)
        counts = tbk.f32_counts()
        # 25 calls each; bwd_reduce launches two kernels a call
        assert counts == {"stats[f32]": 25, "apply[f32]": 25,
                          "bwd_reduce[f32]": 50, "bwd_dx[f32]": 25}, counts
        lp, gp, sp = grads(plain, x, t)
        saved = {k.__name__: k for k in tbk.KERNELS}
        for k in tbk.KERNELS:
            setattr(tbk, k.__name__, tbk.PLAIN[k])
        try:
            _, gs, _ = grads(cfg, x, t)
            gcs = [grads(cfg, x[q], t[q])[1] for q in perms]
        finally:
            for name, k in saved.items():
                setattr(tbk, name, k)
        for remat in ("layer", "block"):
            lr, gr, _ = grads(dataclasses.replace(cfg, remat=remat), x, t)
            assert lr == lk and all(torch.equal(gr[k], gk[k]) for k in gr)
        drop_ops.reset_launch_counts()
        ld, gd, _ = grads(drop, x, t, drop_seeds=seeds)
        assert drop_ops.f32_counts()["drop_mask[f32]"] > 0
        drop_ops.drop_mask = drop_ops.PLAIN[kernel]
        lm, gm, _ = grads(drop, x, t, drop_seeds=seeds)
    finally:
        drop_ops.drop_mask = kernel
        torch.backends.cudnn.deterministic = False
    assert ld == lm and all(torch.equal(gd[k], gm[k]) for k in gd)
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for k in sp:
        assert _rel(sk[k], sp[k]) <= 1e-5, k
    for k in gs:
        if gs[k].norm() > 0:
            c = max(_rel(gc[k], gs[k]) for gc in gcs)
            assert _rel(gk[k], gs[k]) <= max(2 * c, 1e-5), k


# ---------------------------------------------------------------------------
# the float32 forms of the slot train kernels #8/#9: ghost-BN training at
# float32 (the ten forms F1-F10, their cases and checks from chip_smoke.py)
# ---------------------------------------------------------------------------

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
from cunet_tpu_torch.kernels import train_slot  # noqa: E402
from cunet_tpu_torch.tools import f32_step_gap  # noqa: E402


@pytest.mark.parametrize("r", [64, 32, 16, 8, 4])
@pytest.mark.parametrize("tile", [2, 6])
def test_slot_f32_forms(gen, r, tile):
    """Each of the ten forms at float32 against its plain version at the
    CU-Net-8 @256 step's shapes (batch 24, ghost-BN tiles of 2 and 6
    images: 32 and 96 rows at r=4), every output within the float32
    n-term limit 1e-5 sqrt(n) max|p|, each launch a float32 launch."""
    o = chip_smoke.slot_f32_operands(torch, train_ops, gen, r, tile)
    plain = {**buf_ops.PLAIN, **train_ops.PLAIN}
    for row, kern, label, call, bounds, *_ in chip_smoke.slot_f32_cases(
            torch, train_ops, buf_ops, o):
        before = kern.f32_launches
        got, want = call(kern), call(plain[kern])
        torch.cuda.synchronize()
        assert kern.f32_launches == before + 1, row
        err, share, ok = chip_smoke.output_errors(torch, got, want, bounds)
        assert ok, (row, label, err, share)


def test_slot_f32_one_hot_and_bf16_dy(gen):
    """At r=64, tile 2: every product form bit for bit an exact reference
    under one-hot operands, and one bf16 pass of the cotangent breaking
    each input gradient's float32 limit."""
    o = chip_smoke.slot_f32_operands(torch, train_ops, gen, 64, 2)
    same = chip_smoke.slot_f32_exact_checks(torch, train_ops, buf_ops, o,
                                            gen)
    assert all(same.values()), same


@pytest.mark.parametrize("n,ste", [(136, False), (192, True), (256, False)])
def test_affine_dx_f32_past_128(gen, n, ste):
    """affine_dx at float32 with a cotangent wider than the kernel's
    128-deep slice (two slices, the second 8, 64 and 128 deep), three
    ghost tiles of 400 rows (a ragged last 64-row tile) and K = 72 (a
    partial second column block): within the float32 n-term limit of its
    plain version, one float32 launch, and bit for bit the plain version
    under a one-hot weight (one term a product)."""
    m, tiles, k = 1200, 3, 72
    x = _f32(gen, m, k)
    st = train_ops.bn_stats_plain(x, torch.empty(tiles, 2, k, device="cuda"))
    bn = torch.stack([torch.rand(k, generator=gen) + 0.5,
                      torch.randn(k, generator=gen) * 0.3]).cuda()
    vec = train_slot._affine_vec(st, bn, 1e-5)
    dy = _f32(gen, m, n)
    hot = _one_hot(gen, n, k).t().contiguous()
    for w in (_f32(gen, k, n, scale=n ** -0.5), hot):
        before = train_ops.affine_dx.f32_launches
        got, want = _both(train_ops.affine_dx,
                          lambda: torch.empty(m, k, device="cuda"),
                          lambda f, o: f(dy, w, x, vec, o, ste=ste))
        assert train_ops.affine_dx.f32_launches == before + 1
        _close_f32(got, want, n)
    assert torch.equal(got, want)


# tile-preserving permutations of the 2-slot step check's controls
SLOT_STEP_PERMS = 7


@pytest.mark.parametrize("tile", [2, 4])
def test_slot_f32_step_matches_swap_step(gen, tile):
    """Two slots at float32, ghost-BN tiles: every stage on the ten forms
    (each launched); against the swap step (the same path with the forms'
    plain versions swapped in) the loss, each gradient leaf and each BN
    running stat within max(2c, 1e-5) relative (L2), c that number's
    largest distance over ten controls of the swap step: the batch
    permuted seven ways with every image kept in its tile (the same
    function, its row sums in another order; batch 4 has seven at tile 2)
    and, three seeds, every product's output moved by one ulp in half its
    elements (``f32_step_gap.ulp_noise``: the products' own rounding,
    which the kernels change and no permutation reaches). Against the
    permutations alone the kernel step lies 2.4-2.5x past the stem's BN
    gradients' largest at tile 2, where no permutation lies past 2x the
    others' and the one-ulp controls lie past 2x them at up to 47 of 114
    leaves (``tools/f32_step_gap.py``, PERF.md section 6).
    A planted fault, ``affine_dw``'s kernel on the cotangent rounded once
    to bf16, must break that limit. A repeated step bit for bit; with
    dropout 0.2 the masks on the mask kernel's float32 form, bit for bit
    the step with the plain mask (cuDNN deterministic)."""
    cfg = ModelConfig(layer_num=2, order=1, loss_num=2, class_num=8,
                      **{**SMALL, "compute_dtype": "float32"}, bn_tile=tile,
                      bn_dtype="float32")
    params, state = init_cu_net(cfg, gen, device="cuda")
    x = torch.rand(4, 64, 64, 3, generator=gen).cuda()
    t = torch.rand(4, 16, 16, 8, generator=gen).cuda()
    seeds = dropmask.draw_slot_seeds(torch.Generator().manual_seed(1), 2)

    def grads(c, x, t, **kw):
        return chip_smoke._grads(torch, c, params, state, x, t, **kw)

    def faulty_dw(x, vec, dy, out, **kw):
        return kernel_dw(x, vec, dy.bfloat16().float(), out, **kw)

    perms = [q.cuda() for q in chip_smoke.tile_perms(torch, 4, tile,
                                                      SLOT_STEP_PERMS)]
    drop = dataclasses.replace(cfg, drop_rate=0.2)
    kernel = train_slot.drop_mask        # the slot path calls it by name
    kernel_dw = train_slot.affine_dw
    torch.backends.cudnn.deterministic = True
    try:
        train_ops.reset_launch_counts()
        buf_ops.reset_launch_counts()
        k = grads(cfg, x, t)
        counts = chip_smoke.slot_f32_counts(train_ops, buf_ops)
        assert all(counts.values()), counts
        k2 = grads(cfg, x, t)
        with chip_smoke.slot_plain_swapped():
            train_ops.reset_launch_counts()
            buf_ops.reset_launch_counts()
            s = grads(cfg, x, t)
            ctl = [grads(cfg, x[q], t[q]) for q in perms]
            assert not any(chip_smoke.slot_f32_counts(
                train_ops, buf_ops).values())
        for i in range(3):
            noisy = f32_step_gap.slot_swap(gen=torch.Generator(
                device="cuda").manual_seed(23 + i))
            with f32_step_gap.patched(train_slot, **noisy):
                ctl.append(grads(cfg, x, t))
        with f32_step_gap.patched(train_slot, affine_dw=faulty_dw):
            fault = grads(cfg, x, t)
        drop_ops.reset_launch_counts()
        ld, gd, _ = grads(drop, x, t, drop_seeds=seeds)
        assert drop_ops.f32_counts()["drop_mask[f32]"] > 0
        train_slot.drop_mask = drop_ops.PLAIN[kernel]
        lm, gm, _ = grads(drop, x, t, drop_seeds=seeds)
    finally:
        train_slot.drop_mask = kernel
        torch.backends.cudnn.deterministic = False
    assert k2[0] == k[0] and all(torch.equal(k2[1][n], k[1][n])
                                 for n in k[1])
    assert ld == lm and all(torch.equal(gd[n], gm[n]) for n in gd)
    got = chip_smoke.step_leaves(torch, k, s)
    ctrl = [chip_smoke.step_leaves(torch, cc, s) for cc in ctl]
    lim = {n: max(2 * max(d[n] for d in ctrl), 1e-5) for n in got}
    over = {n: (got[n], lim[n]) for n in got if not got[n] <= lim[n]}
    assert not over, over
    planted = chip_smoke.step_leaves(torch, fault, s)
    caught = [n for n in lim if planted[n] > lim[n]]
    assert caught, {n: (planted[n], lim[n]) for n in lim}


# ---------------------------------------------------------------------------
# feature tables past 16 groups (order >= 14); the quantized model at
# float32: the QuanInput forms of the slot kernels and the int8 forms
# ---------------------------------------------------------------------------


def _merged(fs, groups):
    """The same columns as ``fs`` in 16 groups: FIFO entries 0 .. groups-15
    joined into one tensor, so the table travels in the launch
    parameters."""
    j = groups - 15
    return fs[:2] + [torch.cat(fs[2:2 + j], 1)] + fs[2 + j:]


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("groups", [17, 18])
@pytest.mark.parametrize("mode", ["single", "dual", "up", "shift2"])
def test_table_dot_past_16_groups(gen, dt, groups, mode):
    """An up block's adapter at order 14 and 15 (2 + order + 1 groups; its
    first feature at half resolution in ``up``): against the plain version
    over the concat, and bit for bit the same columns in 16 groups (the
    table by value); the launch counted over more than 16 groups."""
    n, r, c, g = 2, 8, 16, 8
    m = n * r * r

    def act(rows, cols):
        return (torch.randn(rows, cols, generator=gen) * 0.5).to("cuda", dt)

    fs = [act(m // 4 if mode == "up" else m, c), act(m, c)] + [
        act(m, g) for _ in range(groups - 2)]
    k = sum(f.shape[1] for f in fs)
    v = _vec(gen, k)
    w = (torch.randn(k, 24, generator=gen) * k ** -0.5).to("cuda", dt)
    kw = {}
    if mode == "dual":
        kw = dict(vec_s=_vec(gen, k), w_s=(torch.randn(
            k, 24, generator=gen) * k ** -0.5).to("cuda", dt))
    if mode == "shift2":
        kw = dict(bias=(torch.randn(24, generator=gen) * 0.5).cuda())
    if mode == "up":
        kw = dict(hw=(r, r))

    def run(fn, feats):
        out = torch.empty(m, 24, device="cuda", dtype=dt)
        extra = dict(kw)
        if mode == "dual":
            extra["out_s"] = torch.empty(m, 24, device="cuda", dtype=dt)
        if mode == "up":
            extra["up"] = (True,) + (False,) * (len(feats) - 1)
        fn(feats, v, w, out, **extra)
        return [out] + ([extra["out_s"]] if mode == "dual" else [])

    eval_ops.reset_launch_counts()
    got = run(eval_ops.table_dot, fs)
    assert eval_ops.ext_counts() == {"table_dot[groups>16]": 1}
    inline = run(eval_ops.table_dot, _merged(fs, groups))
    assert eval_ops.ext_counts() == {"table_dot[groups>16]": 1}
    want = run(eval_ops.table_dot_plain, fs)
    torch.cuda.synchronize()
    for a, b, p in zip(got, inline, want):
        assert torch.equal(a, b)
        if dt == torch.float32:
            _close_f32(a, p, k)
        else:
            _close(a, p)


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_slot_path_at_order_14_is_the_whole_model_path(gen, dt):
    """order 14 (layer_num 15): every up block's adapter reads 17 feature
    groups; the per-slot path runs them from a table in device memory, bit
    for bit the whole-model path, near the plain path; the per-block and
    per-bottleneck paths too."""
    cfg = ModelConfig(layer_num=15, order=14, loss_num=2, class_num=8,
                      **{**SMALL, "compute_dtype": dt})
    params, state = init_cu_net(cfg, gen, device="cuda")
    x = torch.rand(2, 64, 64, 3, generator=gen).cuda()
    slots = eval_slots(params, state, cfg)
    eval_ops.reset_launch_counts()
    per_slot, _ = apply_cu_net(params, state, x, cfg=cfg, slots=slots)
    assert eval_ops.ext_counts()["table_dot[groups>16]"] > 0
    whole, _ = apply_cu_net(params, state, x, slots=slots,
                            cfg=dataclasses.replace(cfg,
                                                    pallas_whole_model=True))
    plain, _ = apply_cu_net(params, state, x, cfg=dataclasses.replace(
        cfg, use_pallas=False))
    bound = 1e-4 if dt == "float32" else 3e-2
    others = [apply_cu_net(params, state, x, cfg=dataclasses.replace(
        cfg, pallas_hourglass=False, **f))[0]
        for f in ({}, {"use_scan": False})]
    for i, (a, b, p) in enumerate(zip(per_slot, whole, plain)):
        assert torch.equal(a, b)
        for t in [a] + [o[i] for o in others]:
            assert _rel(t, p) <= bound


@pytest.mark.parametrize("r", [64, 4])
def test_quant_f32_forms(gen, r):
    """The six QuanInput forms at float32 (bits_i 8) against their plain
    versions at the CU-Net-8 @256 step's shapes (batch 24, tile 2): every
    output within the float32 n-term limit, each launch counted as a
    float32 option launch."""
    o = chip_smoke.slot_f32_operands(torch, train_ops, gen, r, 2)
    plain = {**buf_ops.PLAIN, **train_ops.PLAIN}
    for row, kern, label, call, bounds, *_ in chip_smoke.quant_f32_cases(
            torch, train_ops, buf_ops, o):
        before = kern.f32_option_launches
        got, want = call(kern), call(plain[kern])
        torch.cuda.synchronize()
        assert kern.f32_option_launches == before + 1, row
        err, share, ok = chip_smoke.output_errors(torch, got, want, bounds)
        assert ok, (row, label, err, share)


def test_quant_f32_one_hot_and_bf16_dy(gen):
    """At r=64, tile 2: the six QuanInput forms at float32 bit for bit an
    exact reference under one-hot operands (the plain quantizer's codes,
    the plain STE gate), a bf16 pass of dy breaking the dx limits, dW
    within F32_DW_REL of float64."""
    o = chip_smoke.slot_f32_operands(torch, train_ops, gen, 64, 2)
    same = chip_smoke.quant_f32_exact_checks(torch, train_ops, buf_ops, o,
                                             gen)
    assert all(same.values()), same


def test_int8_kernels_f32(gen):
    """The int8 kernels' float32 forms bit for bit their plain versions at
    the CU-Net-8 @256 shapes and the ragged ones, nothing outside the
    output view written, each launch counted as a float32 one."""
    for name, label, dst, sel, call, _ in chip_smoke.int8_kernel_cases(
            torch, gen, f32=True):
        kern = getattr(quant_ops, name)
        before = kern.f32_launches
        k_buf, p_buf = dst.clone(), dst.clone()
        call(kern, k_buf)
        call(quant_ops.PLAIN[kern], p_buf)
        torch.cuda.synchronize()
        assert kern.f32_launches == before + 1, label
        assert torch.equal(sel(k_buf), sel(p_buf)), label
        sel(k_buf).copy_(sel(dst))
        assert torch.equal(k_buf, dst), label


def test_int8_f32_eval_paths(gen):
    """The quantized model at float32: the whole-model int8 path (the int8
    kernels' float32 forms) against the plain path (``int8_impl="lax"``,
    the same function), and the layer-by-layer path (#6's dual form at
    float32, #10) against itself on those kernels' plain versions (JAX
    runs its down blocks' adapter pairs float there, so it is another
    function than the plain path's); each anchor within relative L2 1e-4
    or, where flipped int8 codes set the gap, 2x its reference's own
    distance under a one-ulp move of the input; the whole-model path bit
    for bit itself on the int8 kernels' plain versions."""
    cfg = ModelConfig(layer_num=3, order=1, loss_num=3, class_num=8,
                      **F32_SMALL, pallas_whole_model=True)
    params, state = init_cu_net(cfg, gen, device="cuda")
    qp = quant_eval_params(params, INT8)
    x = torch.rand(2, 64, 64, 3, generator=gen).cuda()
    nudged = torch.nextafter(x, x + 1)
    lax = dataclasses.replace(INT8, int8_impl="lax")
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    layer_cfg = dataclasses.replace(cfg, pallas_whole_model=False)
    want, _ = apply_cu_net(qp, state, x, cfg=plain_cfg, quant=lax)
    ctl, _ = apply_cu_net(qp, state, nudged, cfg=plain_cfg, quant=lax)
    quant_ops.reset_launch_counts()
    whole, _ = apply_cu_net(qp, state, x, cfg=cfg, quant=INT8)
    assert all(quant_ops.f32_counts().values())
    layers, _ = apply_cu_net(qp, state, x, quant=INT8, cfg=layer_cfg)
    with chip_smoke.layer_plain_swapped(torch):
        l_want, _ = apply_cu_net(qp, state, x, quant=INT8, cfg=layer_cfg)
        l_ctl, _ = apply_cu_net(qp, state, nudged, quant=INT8, cfg=layer_cfg)
    saved = (model_buf.affine_dot_i8, model_buf.conv3x3_i8)
    model_buf.affine_dot_i8 = quant_ops.PLAIN[quant_ops.affine_dot_i8]
    model_buf.conv3x3_i8 = quant_ops.PLAIN[quant_ops.conv3x3_i8]
    try:
        swap, _ = apply_cu_net(qp, state, x, cfg=cfg, quant=INT8)
    finally:
        model_buf.affine_dot_i8, model_buf.conv3x3_i8 = saved
    for a, s_, p, c, la, lp, lc in zip(whole, swap, want, ctl, layers,
                                       l_want, l_ctl):
        assert a.dtype == la.dtype == torch.float32
        assert torch.equal(a, s_)
        assert _rel(a, p) <= max(1e-4, 2 * _rel(c, p))
        assert _rel(la, lp) <= max(1e-4, 2 * _rel(lc, lp))


@pytest.mark.parametrize("tile", [2])
def test_quant_f32_slot_step_matches_swap_step(gen, tile):
    """Two slots W1/I8/G8 at float32, ghost-BN tile 2: every stage on the
    float32 forms, the six QuanInput ones among them (each launched);
    against the swap step (their plain versions swapped in) the loss, each
    gradient leaf and each BN running stat within max(2c, 1e-5), c over
    the controls of ``test_slot_f32_step_matches_swap_step`` (seven
    tile-preserving permutations, three one-ulp product controls). The
    swap step and every control run on the kernel step's int8 codes
    (``f32_step_gap.pinned_codes``): at these sizes one code rounded across
    a boundary (2^-7) moves the step by ~1e-2 and any one run flips none
    or a few, so unpinned the check would hold the chance of a flip, not
    the kernels. A planted fault, ``affine_dw``'s kernel on dy rounded
    once to bf16, must break the limit; a repeated step bit for bit."""
    from cunet_tpu_torch.quant import preprocess_masters
    from cunet_tpu_torch.quant import selected_conv_predicate

    quant = dataclasses.replace(INT8, int8_infer=False)
    cfg = ModelConfig(layer_num=2, order=1, loss_num=2, class_num=8,
                      **{**SMALL, "compute_dtype": "float32"}, bn_tile=tile,
                      bn_dtype="float32")
    params, state = init_cu_net(cfg, gen, device="cuda")
    masters = preprocess_masters(params, quant,
                                 selected_conv_predicate(params, "reference"))
    x = torch.rand(4, 64, 64, 3, generator=gen).cuda()
    t = torch.rand(4, 16, 16, 8, generator=gen).cuda()
    codes = []

    def grads(x, t):
        return chip_smoke._grads(torch, cfg, masters, state, x, t,
                                 quant=quant)

    def faulty_dw(x, vec, dy, out, **kw):
        return kernel_dw(x, vec, dy.bfloat16().float(), out, **kw)

    perms = [q.cuda() for q in chip_smoke.tile_perms(torch, 4, tile,
                                                      SLOT_STEP_PERMS)]
    kernel_dw = train_slot.affine_dw
    torch.backends.cudnn.deterministic = True
    try:
        train_ops.reset_launch_counts()
        buf_ops.reset_launch_counts()
        with f32_step_gap.recorded_codes(train_slot, codes):
            k = grads(x, t)
        counts = chip_smoke.quant_f32_counts(train_ops, buf_ops)
        assert all(counts.values()), counts
        k2 = grads(x, t)
        with chip_smoke.slot_plain_swapped():
            with f32_step_gap.pinned_codes(codes):
                s = grads(x, t)
            ctl = []
            for q in perms:
                with f32_step_gap.pinned_codes(codes, q):
                    ctl.append(grads(x[q], t[q]))
        for i in range(3):
            noisy = f32_step_gap.slot_swap(gen=torch.Generator(
                device="cuda").manual_seed(23 + i))
            with f32_step_gap.patched(train_slot, **noisy), \
                    f32_step_gap.pinned_codes(codes):
                ctl.append(grads(x, t))
        with f32_step_gap.patched(train_slot, affine_dw=faulty_dw):
            fault = grads(x, t)
    finally:
        torch.backends.cudnn.deterministic = False
    assert k2[0] == k[0] and all(torch.equal(k2[1][n], k[1][n])
                                 for n in k[1])
    got = chip_smoke.step_leaves(torch, k, s)
    ctrl = [chip_smoke.step_leaves(torch, cc, s) for cc in ctl]
    lim = {n: max(2 * max(d[n] for d in ctrl), 1e-5) for n in got}
    over = {n: (got[n], lim[n]) for n in got if not got[n] <= lim[n]}
    assert not over, over
    planted = chip_smoke.step_leaves(torch, fault, s)
    caught = [n for n in lim if planted[n] > lim[n]]
    assert caught, {n: (planted[n], lim[n]) for n in lim}


# ---------------------------------------------------------------------------
# the float32 forward 1x1 (csrc/fwd_f32_kernels.cu, fw3_kernel): the
# per-tile and QuanInput forms of affine_dot at float32 and #7's apply
# ---------------------------------------------------------------------------


def _fwd_feats(gen, m, widths):
    """Float32 feature groups, the second a strided view of a wider
    buffer."""
    feats = [_f32(gen, m, c) for c in widths]
    if len(feats) > 1:
        feats[1] = _f32(gen, m, widths[1] + 8)[:, :widths[1]]
    return feats


def _tile_vec(gen, x, tiles):
    """Per-tile (tiles, 2, K) [inv; shift] of x's ghost-BN statistics."""
    k = x.shape[1]
    st = train_ops.bn_stats_plain(x, torch.empty(tiles, 2, k, device="cuda"))
    bn = torch.stack([torch.rand(k, generator=gen) + 0.5,
                      torch.randn(k, generator=gen) * 0.3]).cuda()
    return _affine_vec(st, bn, 1e-5)


@pytest.mark.parametrize("m,widths,cout", [
    (2056, (40,), 128), (1000, (128, 24, 8), 16), (216, (8,) * 17, 136),
    (3000, (128,) * 13 + (64,) * 4, 128), (500, (1920,), 72)])
def test_apply_f32_is_the_dot3_product_bit_for_bit(gen, m, widths, cout):
    """#7's apply at float32 (the forward 1x1) bit for bit the float32
    product kernel it replaced (``launch_dot3``, ``dot3_kernel``, which
    the eval forms still run) on the same features and pair: 1, 3 and 17
    groups (the table in device memory), Ctot = 1,920 (W streamed)."""
    feats = _fwd_feats(gen, m, widths)
    ctot = sum(widths)
    vec = _vec(gen, ctot)
    w = _f32(gen, ctot, cout, scale=ctot ** -0.5)
    got, want = (torch.empty(m, cout, device="cuda") for _ in range(2))
    before = tbk.apply.f32_launches
    tbk.apply(feats, vec, w, got)
    assert tbk.apply.f32_launches == before + 1
    buf_ops.build.check(buf_ops.launch_dot3(feats, m, vec, w, want),
                        "launch_dot3")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n", [(24 * 1024, 192, 128), (520, 40, 16),
                                   (1000, 320, 128), (300, 1920, 136)])
def test_affine_dot_f32_one_tile_is_the_eval_pair_bit_for_bit(gen, m, k, n):
    """affine_dot at float32 with one ghost tile of all M rows (the
    forward 1x1) bit for bit the eval pair's form (``dot3_kernel``):
    the same sums, K = 40 ... 1,920 (W resident and streamed), N = 16 ...
    136 (two column blocks)."""
    x = _f32(gen, m, k + 16)[:, :k]
    v = _vec(gen, k)
    w = _f32(gen, k, n, scale=k ** -0.5)
    before = buf_ops.affine_dot.f32_launches
    got = buf_ops.affine_dot(x, v[None], w, torch.empty(m, n, device="cuda"))
    want = buf_ops.affine_dot(x, v, w, torch.empty(m, n, device="cuda"))
    torch.cuda.synchronize()
    assert buf_ops.affine_dot.f32_launches == before + 2
    assert torch.equal(got, want)


@pytest.mark.parametrize("tiles", [12, 4])      # 32 and 96 rows at r=4
@pytest.mark.parametrize("k,n", [(192, 128), (128, 16), (136, 68),
                                 (160, 136)])
def test_affine_dot_f32_ghost_tiles_at_r4(gen, tiles, k, n):
    """The per-tile form at r=4, batch 24 (384 rows: ghost tiles of 32 and
    96 rows, so a 128-row tile spans two or three), into a strided output
    view: within the float32 K-term limit of the plain version, bit for
    bit under a one-hot W, nothing outside the view written; N = 16, 68
    (the face head, no padded column stored) and 136."""
    m = 24 * 16
    x = _f32(gen, m, k + 8)[:, :k]
    v = _tile_vec(gen, x, tiles)
    for hot in (False, True):
        w = _one_hot(gen, k, n) if hot else _f32(gen, k, n, scale=k ** -0.5)
        dst = _f32(gen, m, n + 12)
        got, want = dst.clone(), dst.clone()
        buf_ops.affine_dot(x, v, w, got[:, 4:4 + n])
        buf_ops.affine_dot_plain(x, v, w, want[:, 4:4 + n])
        torch.cuda.synchronize()
        if hot:
            assert torch.equal(got, want)
        else:
            _close_f32(got, want, k)
        got[:, 4:4 + n].copy_(dst[:, 4:4 + n])
        assert torch.equal(got, dst)


@pytest.mark.parametrize("bits", [8, 12])
@pytest.mark.parametrize("tiles", [1, 3])
def test_affine_dot_f32_bits_i(gen, bits, tiles):
    """QuanInput's quantizer on the float32 prologue (the quantized head,
    128 -> 16; an eval pair with ``bits_i`` runs the forward 1x1 too):
    within the float32 limit of the plain version (codes of 8 bits fill one
    bf16 plane, 12 bits three), bit for bit under a one-hot W, counted as
    a float32 option launch."""
    m, k, n = 1200, 128, 16
    x = _f32(gen, m, k) * 2
    v = _tile_vec(gen, x, tiles) if tiles > 1 else _vec(gen, k)
    for w in (_f32(gen, k, n, scale=k ** -0.5), _one_hot(gen, k, n)):
        before = buf_ops.affine_dot.f32_option_launches
        got = buf_ops.affine_dot(x, v, w, torch.empty(m, n, device="cuda"),
                                 bits_i=bits)
        want = buf_ops.affine_dot_plain(x, v, w, torch.empty(
            m, n, device="cuda"), bits_i=bits)
        torch.cuda.synchronize()
        assert buf_ops.affine_dot.f32_option_launches == before + 1
        _close_f32(got, want, k)
    assert torch.equal(got, want)


def test_affine_dot_f32_tile_head_slot(gen):
    """The per-tile form into an image-major view (one slot of a stacked
    head output): every row lands in its image, the other slots
    untouched."""
    b, r, k, cls = 6, 8, 128, 16
    x = _f32(gen, b * r * r, k)
    v = _tile_vec(gen, x, 3)
    w = _f32(gen, k, cls, scale=k ** -0.5)
    heads = _f32(gen, b, 3, r, r, cls)
    got, want = heads.clone(), heads.clone()
    buf_ops.affine_dot(x, v, w, got[:, 1].view(b, r * r, cls))
    buf_ops.affine_dot_plain(x, v, w, want[:, 1].view(b, r * r, cls))
    torch.cuda.synchronize()
    _close_f32(got, want, k)
    got[:, 1] = heads[:, 1]
    assert torch.equal(got, heads)
