"""Torch port: the plain versions of the slot train kernels' two options,
dropout and QuanInput, against their JAX counterparts on the CPU.

- ``buf_ops.quantize_act`` (the kernels' ``quan``) against
  ``cunet_tpu/kernels/train_slot.py::_quan`` for every bit width, bf16 and
  float32, bit for bit;
- the QuanInput forms of the stage kernels (``affine_dot`` / ``conv3x3``
  with ``bits_i``; ``affine_dx`` / ``conv3x3_dx`` with ``ste``,
  ``affine_dw`` / ``conv3x3_dw`` with ``bits_i``) against ``_quan``,
  ``_ste_mask`` and ``_stage_bwd(bits_i=)`` / ``_conv3x3_bwd`` of the TPU
  kernels, tile by tile;
- the straight-through gate on values that straddle 1.0 after bf16
  rounding: it reads the rounded activation, as JAX's bf16 z does;
- ``drop_ops.drop_mask`` (forward in place in the compute dtype, backward
  from float32) against ``out32 * tile_mask`` and ``d * mask.astype(f32)``
  of ``_seed_mask``'s bits (``dropmask.tile_mask``).

Tolerances: float32 values 2e-4, gradients 1e-3, as
tests/test_torch_port_train_kernels.py; the quantizer, the gates and the
masks exactly.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cunet_tpu.kernels import train_slot as jts
from cunet_tpu.kernels.fused_hourglass import _conv3x3, pack_w3_dycol
from cunet_tpu.kernels.fused_hourglass import pack_w3_scatter
from cunet_tpu.ops import dropmask as jdm
from cunet_tpu_torch.kernels import buf_ops, drop_ops, train_ops, train_slot

VAL = dict(rtol=2e-4, atol=2e-4)
GRAD = dict(rtol=1e-3, atol=1e-3)
EPS = 1e-5
T, BT, H = 2, 2, 8            # tiles, images per tile, resolution
M = T * BT * H * H
RNG = np.random.RandomState


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tiles(a):
    return np.split(np.asarray(a), T)


@pytest.mark.parametrize("bits", [0, 1, 2, 3, 4, 8, 15, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_act_matches_quan(bits, dtype):
    x = (RNG(bits).randn(4096) * 0.8).astype(np.float32)
    x[:6] = [0.0, 1.0, -1.0, 0.5 / 128, 1.5 / 128, 0.99999]
    xt = _t(x).to(getattr(torch, dtype))
    want = jts._quan(jnp.asarray(x).astype(dtype), bits)
    got = buf_ops.quantize_act(xt, bits if bits <= 15 else 0)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))


def _stage(rng, k, n, scale=1.5):
    x = (rng.randn(M, k) * scale + 0.3).astype(np.float32)
    bn = np.stack([rng.uniform(0.3, 0.8, k),
                   rng.randn(k) * 0.3]).astype(np.float32)
    w = (rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
    dy = rng.randn(M, n).astype(np.float32)
    return x, bn, w, dy


def _stats(x):
    return train_ops.bn_stats(_t(x), torch.empty(T, 2, x.shape[1]))


def test_quantized_head_forward_matches_quan_dot():
    """The head's ``affine_dot(bits_i=8)`` == ``_dot(_quan(z))``."""
    x, bn, w, _ = _stage(RNG(40), 16, 4)
    st = _stats(x)
    got = buf_ops.affine_dot(_t(x), train_slot._affine_vec(st, _t(bn), EPS),
                             _t(w), torch.empty(M, 4), bits_i=8).numpy()
    for t, xt in enumerate(_tiles(x)):
        mu, var = jts._stats(jnp.asarray(xt))
        z = jts._quan(jts._norm_relu(jnp.asarray(xt), bn, mu, var,
                                     jnp.float32, EPS), 8)
        np.testing.assert_allclose(_tiles(got)[t],
                                   jts._dot(z, w, jnp.float32), **VAL)


def test_quantized_head_backward_matches_stage_bwd():
    """affine_dx(ste) + bn_bwd + affine_dw(bits_i) == ``_stage_bwd(...,
    bits_i=8)``: dW against the quantized activation, the STE gate on its
    cotangent; per tile, dW and d_bn summed over tiles."""
    x, bn, w, dy = _stage(RNG(41), 16, 4)
    k, n = w.shape
    st = _stats(x)
    vec = train_slot._affine_vec(st, _t(bn), EPS)
    d_a = train_ops.affine_dx(_t(dy), _t(w), _t(x), vec, torch.empty(M, k),
                              ste=True)
    dw = train_ops.affine_dw(_t(x), vec, _t(dy), torch.empty(k, n), bits_i=8)
    d_x, dbn = torch.empty(M, k), torch.empty(2, k)
    train_ops.bn_bwd(_t(x), d_a, st, _t(bn), EPS, d_x, dbn)
    want_dw, want_dbn, gated = 0.0, 0.0, 0
    for t, (xt, dyt) in enumerate(zip(_tiles(x), _tiles(dy))):
        mu, var = jts._stats(jnp.asarray(xt))
        jdx, jdw, jdbn = jts._stage_bwd(jnp.asarray(xt), jnp.asarray(bn),
                                        jnp.asarray(w), mu, var,
                                        jnp.asarray(dyt), jnp.float32, EPS,
                                        bits_i=8)
        np.testing.assert_allclose(_tiles(d_x.numpy())[t], jdx, **GRAD)
        want_dw, want_dbn = want_dw + np.asarray(jdw), want_dbn + np.asarray(
            jdbn)
        z = jts._norm_relu(jnp.asarray(xt), bn, mu, var, jnp.float32, EPS)
        gated += int((np.asarray(z) >= 1).sum())
    assert gated > 100           # the STE gate closes on many elements
    np.testing.assert_allclose(dw.numpy(), want_dw, **GRAD)
    np.testing.assert_allclose(dbn.numpy(), want_dbn, **GRAD)


@pytest.mark.parametrize("res", [8, 2])
def test_quantized_conv_matches_quan_conv_and_bwd(res):
    """conv3x3(bits_i=8) == ``_conv3x3(_quan(z2))``; conv3x3_dx(ste) +
    conv3x3_dw(bits_i) + bn_bwd == ``_conv3x3_bwd(z2q)``, ``_ste_mask`` and
    ``_affine_bwd`` of BN2 (``_block_bwd_generic`` :953-963), per tile."""
    rng = RNG(50 + res)
    cb, g, n_img = 16, 8, T * BT
    m = n_img * res * res
    yb = (rng.randn(m, cb) * 1.5 + 0.2).astype(np.float32)
    bn2 = np.stack([rng.uniform(0.3, 0.8, cb),
                    rng.randn(cb) * 0.3]).astype(np.float32)
    w3 = (rng.randn(3, 3, cb, g) * 0.2).astype(np.float32)
    d_o = rng.randn(m, g).astype(np.float32)
    st = train_ops.bn_stats(_t(yb), torch.empty(T, 2, cb))
    vec = train_slot._affine_vec(st, _t(bn2), EPS)
    w3p = buf_ops.pack_w3(_t(w3))
    out = buf_ops.conv3x3(_t(yb), w3p, n_img, res, res, torch.empty(m, g),
                          vec=vec, bits_i=8)
    d_a = train_ops.conv3x3_dx(_t(d_o), w3p, n_img, res, res, _t(yb), vec,
                               torch.empty(m, cb), ste=True)
    dw3 = train_ops.conv3x3_dw(_t(yb), vec, _t(d_o), n_img, res, res,
                               torch.empty(9 * cb, g), bits_i=8)
    d_yb, dbn = torch.empty(m, cb), torch.empty(2, cb)
    train_ops.bn_bwd(_t(yb), d_a, st, _t(bn2), EPS, d_yb, dbn)
    w_sc = pack_w3_scatter(jnp.asarray(w3))
    want_dw, want_dbn = 0.0, 0.0
    for t, (yt, dt) in enumerate(zip(np.split(yb, T), np.split(d_o, T))):
        mu, var = jts._stats(jnp.asarray(yt))
        z2 = jts._norm_relu(jnp.asarray(yt), bn2, mu, var, jnp.float32, EPS)
        z2q = jts._quan(z2, 8)
        np.testing.assert_allclose(
            np.split(out.numpy(), T)[t],
            _conv3x3(z2q, pack_w3_dycol(jnp.asarray(w3)), BT, res, res,
                     mode="dycol"), **VAL)
        d_z2, jdw = jts._conv3x3_bwd(z2q, w_sc, jnp.asarray(dt), BT, res,
                                     res, jnp.float32)
        d_z2 = jts._ste_mask(d_z2, z2)
        jdyb, jdbn = jts._affine_bwd(jnp.asarray(yt), bn2, mu, var, d_z2,
                                     jnp.float32, EPS, z=z2)
        np.testing.assert_allclose(np.split(d_yb.numpy(), T)[t], jdyb,
                                   **GRAD)
        jdw = np.asarray(jdw).reshape(cb, 9, g).transpose(1, 0, 2)
        want_dw = want_dw + jdw.reshape(9 * cb, g)
        want_dbn = want_dbn + np.asarray(jdbn)
    np.testing.assert_allclose(dw3.numpy(), want_dw, **GRAD)
    np.testing.assert_allclose(dbn.numpy(), want_dbn, **GRAD)


def test_ste_gate_reads_the_bf16_activation():
    """Inputs whose affine lands just below 1.0 in float32 but rounds to
    1.0 in bf16 are gated (JAX quantizes and gates the bf16 z); those that
    stay below 1.0 after rounding pass, and z <= 0 never passes."""
    k = 8
    z = np.array([0.99999, 0.9990, 0.99609375, 0.998, 1.0, 1.2, -0.5, 0.0],
                 np.float32)
    # x * inv + shift == z with inv 1, shift 0; x itself is bf16, so build
    # z from a bf16 x and a float32 shift that lands it where wanted
    x = np.full((16, k), 0.5, np.float32)
    vec = np.stack([np.ones(k, np.float32), z - 0.5]).astype(np.float32)
    xb = _t(x).bfloat16()
    dy, w = torch.ones(16, 4), torch.ones(k, 4)
    got = train_ops.affine_dx(dy.bfloat16(), w.bfloat16(), xb, _t(vec),
                              torch.empty(16, k), ste=True)[0].numpy()
    zb = np.asarray(jnp.asarray(z).astype(jnp.bfloat16))
    want = np.asarray(jts._ste_mask(jnp.where(zb > 0, 4.0, 0.0), zb))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got != 0, [0, 0, 1, 1, 0, 0, 0, 0])
    plain = train_ops.affine_dx(dy.bfloat16(), w.bfloat16(), xb, _t(vec),
                                torch.empty(16, k))[0].numpy()
    np.testing.assert_array_equal(plain != 0, [1, 1, 1, 1, 1, 1, 0, 0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed,pos,rate", [(123, 0, 0.2), (-77, 8, 0.25),
                                           (2 ** 31 - 1, 4, 0.5)])
def test_drop_mask_matches_seed_mask(dtype, seed, pos, rate):
    """Forward: the out32 view of a wider buffer times the tile masks of
    ``_seed_mask`` (tile t = ghost-BN tile, index row-in-tile * g + col,
    col the logical column of the view), in the compute dtype, in place;
    backward: ``bf16(d * mask.astype(f32))`` from a float32 cotangent."""
    g, res = 8, 4
    tile_rows = BT * res * res
    m = T * tile_rows
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = RNG(60)
    buf = rng.randn(m, 32).astype(np.float32)
    o32 = np.asarray(jnp.asarray(buf[:, 16:24]).astype(jdt))
    masks = [jdm.tile_mask(seed, pos, t, tile_rows, g, rate, jdt)
             for t in range(T)]
    want = np.concatenate([np.asarray((jnp.asarray(o) * mk).astype(
        jnp.float32)) for o, mk in zip(np.split(o32, T), masks)])
    tb = _t(buf).to(tdt)
    before = tb.clone()
    drop_ops.drop_mask(tb[:, 16:24], seed, pos, rate, tile_rows)
    np.testing.assert_array_equal(tb[:, 16:24].float().numpy(), want)
    assert torch.equal(tb[:, :16], before[:, :16])
    assert torch.equal(tb[:, 24:], before[:, 24:])
    d = rng.randn(m, g).astype(np.float32)
    want_b = np.concatenate([np.asarray((jnp.asarray(dt) * mk.astype(
        jnp.float32)).astype(jdt).astype(jnp.float32))
        for dt, mk in zip(np.split(d, T), masks)])
    out = torch.empty(m, g, dtype=tdt)
    drop_ops.drop_mask(_t(d), seed, pos, rate, tile_rows, out)
    np.testing.assert_array_equal(out.float().numpy(), want_b)


def test_option_wrappers_check_their_arguments():
    x, v = torch.randn(M, 16), torch.ones(T, 2, 16)
    with pytest.raises(ValueError):
        buf_ops.affine_dot(x, v, torch.randn(16, 4), torch.empty(M, 4),
                           bits_i=16)
    with pytest.raises(ValueError):          # no prologue to quantize
        buf_ops.conv3x3(x, torch.randn(9 * 16, 8), T * BT, H, H,
                        torch.empty(M, 8), bits_i=8)
    with pytest.raises(ValueError):
        train_ops.affine_dw(x, v, torch.randn(M, 4), torch.empty(16, 4),
                            bits_i=-1)
    assert ml_dtypes.bfloat16(0.99999) == 1.0   # the straddle the gate reads
