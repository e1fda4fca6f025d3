"""Torch port on the CPU: the host plans of the quantized whole-model
forward's int8 kernels (``quant_ops.i8_dot_plan`` for ``affine_dot_i8``,
``quant_ops.i8_conv_plan`` for ``conv3x3_i8``; ``csrc/i8_kernels.cu``)
and their weights' K-major images.

- Every call of the port's int8 whole-model forward of CU-Net-8 (order 1,
  heads of 16 and 68 classes), recorded once per module from a forward on
  one 64 x 64 image with the kernels' arithmetic skipped (the calls'
  shapes do not depend on it), with M scaled to batches 8, 64 and 256 at
  256 x 256; order 14's K values (up to 2c + 15g = 736) from the config:
  each plan fits the H100's shared memory (``buf_ops.SMEM_LIMIT``), its
  regions lie in order and aligned, every output (row tile, column
  group) is taken once by any persistent grid, the K steps and the conv's
  depth split partition their ranges.
- Phase 6's ragged and unaligned cases and a K past the resident weight
  (the streamed plan).
- A numpy mirror of the conv's halo and tap index map over the plan's
  tiles and depth split: bit for bit the plain conv.
- The packers round-trip exactly, a K prefix of an image gives the prefix
  product, and the marshalled slots hold each int8 matrix's image.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from cunet_tpu_torch.config import ModelConfig, QuantConfig
from cunet_tpu_torch.kernels import model_buf
from cunet_tpu_torch.kernels import quant_ops as qo
from cunet_tpu_torch.kernels.buf_ops import SMEM_LIMIT, SMEM_PAIR, pack_w3
from cunet_tpu_torch.kernels.quant_matmul import int_dot
from cunet_tpu_torch.models import apply_cu_net, init_cu_net
from cunet_tpu_torch.models.cu_net import eval_slots
from cunet_tpu_torch.train import quant_eval_params

from test_torch_port_gemm_plans import one_thread

INT8 = QuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True,
                   int8_infer=True, int8_impl="pallas")
BATCHES = (8, 64, 256)
SCALE = 16          # the forward runs on 64 x 64 images: rows x 16 at 256
C, G, CB = 128, 32, 128


def _up(x, m):
    return -(-x // m) * m


def unpack_w_i8(wt, k):
    """The (K, N) weight of ``pack_w_i8``'s image: its inverse."""
    return wt[:, :k].t().contiguous()


def unpack_w3_i8(wt, cb):
    """The (9*Cb, G) weight of ``pack_w3_i8``'s image: its inverse."""
    g = wt.shape[0]
    return wt.reshape(g, 9, -1)[:, :, :cb].reshape(g, 9 * cb).t(
    ).contiguous()


@functools.lru_cache(maxsize=None)
@one_thread()
def _int8_calls(class_num):
    """(dot calls, conv calls) of one int8 whole-model forward of CU-Net-8
    at ``class_num`` classes: (rows of one 256 x 256 image, K, N, BN2 +
    q8 epilogue) of each ``affine_dot_i8`` call and (rows of one image, H,
    W, Cb, G) of each ``conv3x3_i8`` call, read from the port's forward
    on one 64 x 64 image on one intra-op thread (``one_thread``), each
    K-major image checked against its weight."""
    cfg = ModelConfig(layer_num=8, order=1, class_num=class_num, loss_num=8,
                      compute_dtype="bfloat16", use_pallas=True,
                      pallas_whole_model=True)
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    params = quant_eval_params(params, INT8)
    dots, convs = [], []

    def dot(x, vec, w, out, *, s, vec2=None, wt=None):
        assert torch.equal(unpack_w_i8(wt, w.shape[0]), w)
        dots.append((SCALE * x.shape[0], x.shape[1], w.shape[1],
                     vec2 is not None))
        return out

    def conv(y, w3, b, h, w, out, *, s, wt=None):
        assert torch.equal(unpack_w3_i8(wt, y.shape[1]), w3)
        convs.append((SCALE * y.shape[0], 4 * h, 4 * w, y.shape[1],
                      w3.shape[1]))
        return out

    x = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(model_buf, "affine_dot_i8", dot)
        mp.setattr(model_buf, "conv3x3_i8", conv)
        apply_cu_net(params, state, x, cfg=cfg, quant=INT8)
    return dots, convs


def _order14_dots():
    """(rows of one image, K, N, q8) of CU-Net-8's int8 1x1 calls at order
    14 from its widths: a bottleneck reads c (down, neck) or 2c (up) plus
    up to 14 FIFO entries of g, its adapters g more, at r = 64 ... 4; the
    head reads c."""
    calls = set()
    for r in (64, 32, 16, 8, 4):
        for base in (C, 2 * C):
            for link in range(15):
                k = base + link * G
                calls.add((r * r, k, CB, True))
                calls.add((r * r, k + G, C, False))
    return sorted(calls)


def _partition(ranges, total):
    """The ranges cover [0, total) once."""
    hits = np.zeros(total, int)
    for r in ranges:
        hits[r.start:r.stop] += 1
    return bool((hits == 1).all())


def _grids(groups, items):
    """Persistent grids a kernel may launch with: one or two blocks an SM
    of the card's 132 (cut to a multiple of the column groups), every item
    its own block, one block a group."""
    out = {groups, max(groups, items - items % groups)}
    for g in (132, 264):
        g = min(g, items)
        out.add(max(groups, g - g % groups))
    return sorted(out)


@functools.lru_cache(maxsize=None)
def _items_once(tiles, groups):
    """Whether every (tile, group) item is taken by exactly one block for
    each grid of ``_grids``: block b keeps group b % groups and takes
    tiles b // groups, + grid // groups, ... (csrc/i8_kernels.cu, both
    kernels)."""
    for grid in _grids(groups, tiles * groups):
        hits = np.zeros((tiles, groups), int)
        stride = grid // groups
        for b in range(grid):
            hits[b // groups::stride, b % groups] += 1
        if not (hits == 1).all():
            return False
    return True


@functools.lru_cache(maxsize=None)
def _cover(m, bm, groups):
    """Row tiles of bm partition [0, m), and each (tile, group) item is
    taken once (``_items_once``)."""
    tiles = -(-m // bm)
    return _partition([range(t * bm, min(m, (t + 1) * bm))
                       for t in range(tiles)], m) and \
        _items_once(tiles, groups)


def _check_dot_plan(m, k, n, f32, q8):
    p = qo.i8_dot_plan(m, k, n, f32, q8)
    esz = 4 if f32 else 2
    osz = 1 if q8 else esz
    assert p.smem <= SMEM_LIMIT, (m, k, n, f32, q8)
    assert p.row_warps * p.col_warps == qo.I8_WARPS and p.ntw in qo.I8_NTW
    assert p.ncol == 8 * p.ntw * p.col_warps
    assert (p.ngrp - 1) * p.ncol < n <= p.ngrp * p.ncol
    # the warps take a block's (bm, ncol) tile once
    hits = np.zeros((p.bm, p.ncol), int)
    for wp in range(qo.I8_WARPS):
        wm, wn = wp % p.row_warps, wp // p.row_warps
        hits[wm * 32:(wm + 1) * 32, wn * p.ntw * 8:(wn + 1) * p.ntw * 8] += 1
    assert (hits == 1).all()
    # K in whole k32 steps; the steps of a tile partition it
    assert p.kp == _up(k, 32) and p.kc % 32 == 0
    assert p.kc <= min(p.kp, qo.I8_MAX_KC)
    chunks = [range(c * p.kc, min(p.kp, (c + 1) * p.kc))
              for c in range(p.nch)]
    assert _partition(chunks, p.kp)
    assert all(len(r) % 32 == 0 for r in chunks)
    # the steps are as even as whole k32 steps allow
    assert p.kc - len(chunks[-1]) < p.nch * 32
    # the quantizer's map: kc / 8 vectors a row, at least one whole row a
    # pass of the block's threads
    assert p.kc // 8 <= qo.I8_WARPS * 32
    assert p.stages >= 2
    # shared memory: each region past the one before, 128-byte aligned
    wbytes = p.ncol * (p.kp + 16) if p.resident else 0
    assert p.wchunk_bytes == (0 if p.resident else
                              _up(p.ncol * (p.kc + 16), 128))
    assert p.w_off == 0 and p.vec_off >= wbytes
    assert p.ring_off >= p.vec_off + 4 * (2 * p.kp + 2 * p.ncol)
    assert p.stage_bytes >= p.wchunk_bytes + p.bm * p.kc * esz
    assert p.codes_off >= p.ring_off + p.stages * p.stage_bytes
    assert p.out_off >= p.codes_off + p.bm * (p.kc + 16)
    assert p.smem == p.out_off + qo.I8_WARPS * 16 * (8 * p.ntw * osz + 16)
    assert all(v % 128 == 0 for v in (p.vec_off, p.ring_off, p.stage_bytes,
                                      p.wchunk_bytes, p.codes_off,
                                      p.out_off))
    # the codes' and weight rows' strides keep ldmatrix free of conflicts
    assert ((p.kc + 16) // 16) % 2 == 1
    assert (((p.kp if p.resident else p.kc) + 16) // 16) % 2 == 1
    # a step's vector reads stay inside the block's shared memory
    assert p.vec_off + 4 * (p.kp + p.nch * p.kc) <= p.smem
    # row tiles and (tile, group) items, each once for any grid
    assert _cover(m, p.bm, p.ngrp)
    return p


def _check_conv_plan(m, h, w, cb, g, f32):
    p = qo.i8_conv_plan(m, h, w, cb, g, f32)
    osz = 4 if f32 else 2
    assert p.smem <= SMEM_LIMIT, (m, h, w, cb, g, f32)
    assert p.cbp == _up(cb, 32) and p.nt in qo.I8_CONV_NT
    assert (p.ngrp - 1) * 8 * p.nt < g <= p.ngrp * 8 * p.nt
    assert p.row_warps * p.k_warps == qo.I8_WARPS
    assert p.bm in qo.I8_CONV_ROWS and p.stages in (1, 2)
    assert _partition([p.k_range(wk) for wk in range(p.k_warps)],
                      9 * p.cbp // 32)
    # every tap's source row of a tile lies in its halo
    assert p.halo_rows == p.bm + 2 * w + 2
    assert min(r + w + 1 + dy * w + dx for r in (0, p.bm - 1)
               for dy in (-1, 1) for dx in (-1, 1)) >= 0
    assert p.bm - 1 + 2 * w + 2 < p.halo_rows
    # shared memory: weight image, zero row, halo buffers (or the depth
    # split's int32 partials), output stages
    assert p.w_off == 0 and p.zero_off >= 8 * p.nt * (9 * p.cbp + 16)
    assert p.stage_off >= p.zero_off + p.cbp
    assert p.stage_bytes >= p.halo_rows * (p.cbp + 16)
    assert p.stage_bytes >= (p.k_warps - 1) * p.bm * (8 * p.nt + 4) * 4
    assert p.out_off == p.stage_off + p.stages * p.stage_bytes
    assert p.smem == p.out_off + qo.I8_WARPS * 16 * (8 * p.nt * osz + 16)
    assert all(v % 128 == 0 for v in (p.zero_off, p.stage_off,
                                      p.stage_bytes, p.out_off))
    assert ((p.cbp + 16) // 16) % 2 == 1 and ((9 * p.cbp + 16) // 16) % 2
    assert _cover(m, p.bm, p.ngrp)
    return p


# ---------------------------------------------------------------------------
# the plans at every call of the int8 forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("class_num", [16, 68])
def test_the_int8_forward_makes_its_calls(class_num):
    """184 ``affine_dot_i8`` calls a forward (72 with the BN2 + q8
    epilogue into the conv's codes) and 72 ``conv3x3_i8`` calls, at r = 64
    ... 4; the head's weight padded to a multiple of 8 columns."""
    dots, convs = _int8_calls(class_num)
    assert len(dots) == 184 and sum(q for *_, q in dots) == 72
    assert len(convs) == 72
    assert {m for m, *_ in dots} == {r * r for r in (64, 32, 16, 8, 4)}
    assert {k for _, k, _, q in dots if q} == {128, 160, 256, 288}
    assert {k for _, k, _, q in dots if not q} == {128, 160, 192, 288, 320}
    assert {n for _, _, n, _ in dots} == {CB, C, _up(class_num, 8)}
    assert {c for c in convs} == {(r * r, r, r, CB, G)
                                  for r in (64, 32, 16, 8, 4)}


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("class_num", [16, 68])
def test_dot_plans_fit_every_int8_call(class_num, batch, f32):
    dots, _ = _int8_calls(class_num)
    plans = {}
    for rows, k, n, q8 in sorted(set(dots)):
        plans[(rows, k, n, q8)] = _check_dot_plan(batch * rows, k, n, f32, q8)
    # the main path's product keeps its weight resident, one column group
    assert all(p.resident for p in plans.values())
    assert {p.ngrp for p in plans.values()} == {1}
    if not f32:
        # two blocks an SM at every bf16 call of the bottlenecks and adapters
        assert all(p.smem <= SMEM_PAIR for (_, _, n, _), p in plans.items()
                   if n == 128)


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("batch", BATCHES)
def test_conv_plans_fit_every_int8_call(batch, f32):
    _, convs = _int8_calls(16)
    for rows, h, w, cb, g in sorted(set(convs)):
        p = _check_conv_plan(batch * rows, h, w, cb, g, f32)
        assert p.ngrp == 1 and p.smem <= SMEM_PAIR
        # r=64: 256-row tiles, the depth whole in each warp, two blocks an
        # SM of one halo buffer each
        if h == 64:
            assert p.bm == 256 and p.k_warps == 1 and p.stages == 1


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("batch", BATCHES)
def test_dot_plans_fit_order_14(batch, f32):
    """At order 14 every K up to 2c + 15g = 736 keeps the weight
    resident."""
    calls = _order14_dots()
    assert max(k for _, k, _, _ in calls) == 2 * C + 15 * G
    for rows, k, n, q8 in calls:
        assert _check_dot_plan(batch * rows, k, n, f32, q8).resident


# ---------------------------------------------------------------------------
# phase 6's ragged cases, a K past the resident weight
# ---------------------------------------------------------------------------


# (M, K, N, q8): K not a multiple of 32, M not a multiple of a tile, int8
# rows of 24 bytes, N past 128 (a 256-column group), K past what a resident weight holds
# (streamed), at bf16 and float32
RAGGED_DOTS = [(1000, 40, 24, True), (1000, 40, 24, False),
               (200, 200, 136, False), (520, 16, 8, True),
               (8 * 64 * 64, 2048, 128, True),
               (64 * 64 * 64, 2048, 128, False), (1000, 1000, 72, False),
               (8 * 64 * 64, 128, 72, False), (8 * 64 * 64, 128, 16, False)]


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("m,k,n,q8", RAGGED_DOTS)
def test_ragged_dot_plans(m, k, n, q8, f32):
    p = _check_dot_plan(m, k, n, f32, q8)
    assert p.resident == (k <= 1000)
    assert p.ngrp == 1


# (M, H, W, Cb, G): Cb not a multiple of 32 (and of 16), ragged row
# tiles, G of one n8 tile and of five (an 8-tile warp), r = 64 ... 4
RAGGED_CONVS = [(108, 6, 6, 24, 8), (3 * 25, 5, 5, 48, 40),
                (3 * 64, 8, 8, 16, 8), (8 * 16, 4, 4, 128, 32),
                (8 * 64, 8, 8, 128, 32), (256 * 64 * 64, 64, 64, 128, 32)]


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("m,h,w,cb,g", RAGGED_CONVS)
def test_ragged_conv_plans(m, h, w, cb, g, f32):
    _check_conv_plan(m, h, w, cb, g, f32)


def test_plans_raise_where_nothing_fits():
    """No silent detour: a shape no plan takes is an error."""
    with pytest.raises(ValueError):
        qo.i8_conv_plan(4 * 2000 * 2000, 2000, 2000, 128, 32)
    with pytest.raises(ValueError):
        qo.i8_dot_plan(1000, 1 << 20, 128)


def test_plans_are_functions_of_the_shapes():
    args = [(8 * 64 * 64, 160, 128, False, True), (1000, 40, 24, True, False)]
    first = [qo.i8_dot_plan(*a) for a in args]
    qo.i8_dot_plan.cache_clear()
    assert [qo.i8_dot_plan(*a) for a in args] == first
    conv = qo.i8_conv_plan(8 * 64 * 64, 64, 64, 128, 32)
    qo.i8_conv_plan.cache_clear()
    assert qo.i8_conv_plan(8 * 64 * 64, 64, 64, 128, 32) == conv


# ---------------------------------------------------------------------------
# the conv's index map, mirrored
# ---------------------------------------------------------------------------


def _mirror_conv(y, wt, b, h, w, p):
    """conv3x3_i8's integer sums as its blocks form them: per row tile of
    the plan, the halo of rows m0 - W - 1 ... (channels zero-padded to
    cbp), each warp's two m16 rows through ``tap_row`` (a zero row outside
    the image) over its depth warp's k32 steps, the partials added."""
    m, cb = y.shape
    g = wt.shape[0]
    hw = h * w
    yp = np.zeros((m, p.cbp), np.int64)
    yp[:, :cb] = y
    wk = wt.astype(np.int64).reshape(g, 9, p.cbp)
    out = np.zeros((m, g), np.int64)
    kst = p.cbp // 32
    for t in range(p.tiles(m)):
        m0 = t * p.bm
        g0 = m0 - w - 1
        halo = np.zeros((p.halo_rows, p.cbp), np.int64)
        lo, hi = max(0, -g0), min(p.halo_rows, m - g0)
        halo[lo:hi] = yp[g0 + lo:g0 + hi]
        for r in range(p.bm):
            mm = m0 + r
            if mm >= m:
                continue
            yy, xx = divmod(mm % hw, w)
            for wkp in range(p.k_warps):
                for step in p.k_range(wkp):
                    tap, kk = divmod(step, kst)
                    dy, dx = tap // 3 - 1, tap % 3 - 1
                    sy, sx = yy + dy, xx + dx
                    if not (0 <= sy < h and 0 <= sx < w):
                        continue                      # the zero row
                    row = halo[r + w + 1 + dy * w + dx,
                               kk * 32:(kk + 1) * 32]
                    out[mm] += row @ wk[:, tap, kk * 32:(kk + 1) * 32].T
    return out


@pytest.mark.parametrize("m,h,w,cb,g", RAGGED_CONVS[:3])
def test_conv_index_map_mirror_is_the_plain_conv(m, h, w, cb, g):
    rng = np.random.RandomState(3)
    y = rng.randint(0, 128, (m, cb)).astype(np.int8)
    w3 = rng.randint(-1, 2, (3, 3, cb, g)).astype(np.float32)
    w3p = torch.round(pack_w3(torch.from_numpy(w3))).to(torch.int8)
    wt = qo.pack_w3_i8(w3p)
    p = qo.i8_conv_plan(m, h, w, cb, g)
    got = _mirror_conv(y, wt.numpy(), m // (h * w), h, w, p)
    want = torch.empty(m, g)
    qo.conv3x3_i8_plain(torch.from_numpy(y), w3p, m // (h * w), h, w, want,
                        1.0)
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64))


# ---------------------------------------------------------------------------
# the K-major images
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,n", [(40, 24), (128, 128), (320, 72), (7, 3)])
def test_pack_w_i8_round_trips(k, n):
    rng = np.random.RandomState(k)
    w = torch.from_numpy(rng.randint(-128, 128, (k, n)).astype(np.int8))
    wt = qo.pack_w_i8(w)
    assert wt.shape == (n, _up(k, 32)) and wt.is_contiguous()
    assert not wt[:, k:].any()
    assert torch.equal(unpack_w_i8(wt, k), w)


@pytest.mark.parametrize("cb,g", [(24, 8), (128, 32), (48, 40)])
def test_pack_w3_i8_round_trips(cb, g):
    rng = np.random.RandomState(cb)
    w3p = torch.from_numpy(rng.randint(-128, 128, (9 * cb, g)).astype(np.int8))
    wt = qo.pack_w3_i8(w3p)
    cbp = _up(cb, 32)
    assert wt.shape == (g, 9 * cbp) and wt.is_contiguous()
    assert not wt.reshape(g, 9, cbp)[:, :, cb:].any()
    assert torch.equal(unpack_w3_i8(wt, cb), w3p)


def test_a_k_prefix_of_the_image_gives_the_prefix_product():
    """A growth-phase slot reads K < K_max of the padded weight: its image
    columns past K hold the later rows' weights, and the kernel's zero
    codes there leave exactly the product of the prefix."""
    rng = np.random.RandomState(5)
    kmax, k, n = 160, 136, 128
    w = torch.from_numpy(rng.randint(-1, 2, (kmax, n)).astype(np.int8))
    codes = torch.from_numpy(rng.randint(0, 128, (50, k)).astype(np.int8))
    wt = qo.pack_w_i8(w)
    kp = _up(k, 32)
    assert wt[:, k:kp].any()
    a = torch.zeros(50, kp, dtype=torch.int8)
    a[:, :k] = codes
    got = int_dot(a, wt[:, :kp].t().contiguous())
    assert torch.equal(got, int_dot(codes, w[:k]))


def test_marshalled_int8_slots_hold_the_packed_images():
    cfg = ModelConfig(layer_num=3, order=2, loss_num=3, neck_size=2,
                      growth_rate=8, init_chan_num=16, class_num=68,
                      num_blocks=2, use_pallas=True, pallas_whole_model=True)
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    qp = quant_eval_params(params, INT8)
    slots = eval_slots(qp, state, cfg, INT8)
    float_slots = eval_slots(params, state, dataclasses.replace(cfg))
    for sl in slots:
        assert torch.equal(unpack_w_i8(sl["wt_head"], cfg.init_chan_num),
                           sl["head"][1])
        for blk in sl["blocks"]:
            for key in ("w_b", "w_a", "w_s"):
                if key in blk:
                    wt = blk["wt" + key[1:]]
                    assert wt.dtype == torch.int8
                    assert torch.equal(unpack_w_i8(wt, blk[key].shape[0]),
                                       blk[key])
            cb = blk["w3"].shape[0] // 9
            assert torch.equal(unpack_w3_i8(blk["wt3"], cb), blk["w3"])
    assert not any(k.startswith("wt") for sl in float_slots for k in sl)
    assert not any(k.startswith("wt") for sl in float_slots
                   for blk in sl["blocks"] for k in blk)
