"""Torch port: the quantized model's float32 forms against the JAX package
on the CPU.

The card runs QuanInput's quantizer inside the float32 product kernels
(``csrc/f32_kernels.cu``: ``quan(relu(x * inv + shift), bits)`` on the
unrounded float32 value, and the straight-through gate 0 < z < 1 in the
backward's epilogue), and the int8 kernels on float32 buffers
(``csrc/quant_kernels.cu``). Here, where no kernel runs:

- a numpy float32 mirror of that prologue, one rounding an operation as
  the kernel's ``affine`` and ``quan`` take them, gives the codes of the
  port's plain version (``buf_ops.quantize_act`` of ``tile_affine``) and
  of ``quant_q(clip_c(.))`` of the port's and JAX's ``quant/wage.py`` bit
  for bit, on random activations and on values placed exactly at the code
  boundaries (k + 1/2) / 2^(bits-1), one ulp either side, and at the clip;
  a mirror that contracts the affine into one FMA (float64, then rounded)
  flips codes there: the reason the kernel rounds the product and the sum
  apart;
- a code of bits <= 9 fills one bf16 plane (the kernels skip the other two
  planes' products then); at 12 bits it does not;
- the straight-through gate of ``train_ops._gate(..., ste=True)`` at
  float32 equals JAX's ReLU mask times ``_ste_mask`` of the unrounded z;
- ``affine_dot_i8`` / ``conv3x3_i8``'s plain versions on float32 inputs
  and outputs against JAX's ``_affine_dot_i8`` / the int8 scatter conv of
  ``fused_model_buf.py``, exact;
- the whole-model int8 path at float32 against JAX's #1 int8 branch in
  interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cunet_tpu.config import QuantConfig
from cunet_tpu.kernels.fused_model_buf import _affine_dot_i8, _q8
from cunet_tpu.kernels.train_slot import _ste_mask
from cunet_tpu.models import apply_cu_net as jax_apply_cu_net
from cunet_tpu.quant import wage as jax_wage
from cunet_tpu_torch.kernels import buf_ops, quant_ops, train_ops
from cunet_tpu_torch.kernels.buf_ops import pack_w3, quantize_act
from cunet_tpu_torch.models import apply_cu_net
from cunet_tpu_torch.quant.wage import clip_c, quant_q

from test_torch_port_bf16_split import split_bf16x3
from test_torch_port_int8 import _jax_scatter_conv, _quantized
from torch_port_util import from_jax, images, small_cfg

F32 = np.float32
BITS = (1, 2, 3, 8, 9, 12, 15)
INT8 = QuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True,
                   int8_infer=True, int8_impl="pallas")
S = 128.0
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)


def kernel_affine(x, a, b):
    """``common.cuh::affine`` + ReLU: the product and the sum rounded apart
    (``__fadd_rn(__fmul_rn(x, a), b)``)."""
    return np.maximum(F32(x) * F32(a) + F32(b), F32(0))


def fma_affine(x, a, b):
    """The affine as one contracted FMA: exact in float64, rounded once."""
    return np.maximum((np.float64(x) * a + b).astype(F32), F32(0))


def kernel_quan(z, bits):
    """``common.cuh::quan`` on float32 z, step for step in float32."""
    z = np.asarray(z, F32)
    if bits <= 0 or bits > 15:
        return z
    s = F32(1.0 if bits <= 2 else 2.0 ** (bits - 1))
    inv_s = F32(1) / s
    lim = F32(1) if bits <= 2 else F32(1) - inv_s
    x = np.minimum(np.maximum(z, -lim), lim)
    sgn = np.where(x > 0, F32(1), np.where(x < 0, F32(-1), F32(0)))
    if bits == 1:
        return sgn
    y = np.abs(x) * s
    return (sgn * np.floor(y + F32(0.5))) * inv_s


def _boundary_values(bits):
    """z at every code boundary (k + 1/2) / S of ``bits`` (a sample of them
    at wide codes), one float32 ulp either side, the clip limit and 1, and
    their negatives: where a wrong rounding shows."""
    s = 1.0 if bits <= 2 else 2.0 ** (bits - 1)
    ks = np.arange(0, int(s) + 1)
    if len(ks) > 600:
        ks = np.unique(np.r_[ks[:200], ks[-200:],
                             np.random.RandomState(bits).choice(ks, 200)])
    t = ((ks + 0.5) / s).astype(F32)
    vals = np.r_[t, np.nextafter(t, F32(np.inf)), np.nextafter(t, F32(0)),
                 F32(1) - F32(1) / F32(s), F32(1), F32(0)]
    return np.r_[vals, -vals].astype(F32)


@pytest.mark.parametrize("bits", BITS)
def test_prologue_codes_match_the_plain_quantizers(bits):
    """The kernel's quantizer on float32 z equals the port's ``quant_q(
    clip_c(z))``, JAX's and the plain version's ``quantize_act`` bit for
    bit, at the code boundaries and on random activations; the prologue
    ``quan(relu(x * inv + shift))`` equals ``quantize_act(relu(
    tile_affine(x, vec)))``, which the float32 forms' plain versions
    take."""
    rng = np.random.RandomState(bits)
    z = np.r_[_boundary_values(bits),
              (rng.randn(20000) * 0.7).astype(F32)].astype(F32)
    want = kernel_quan(z, bits)
    port = quant_q(clip_c(torch.from_numpy(z), bits), bits).numpy()
    jaxq = np.asarray(jax_wage.quant_q(jax_wage.clip_c(jnp.asarray(z), bits),
                                       bits))
    plain = quantize_act(torch.from_numpy(z), bits).numpy()
    for got in (port, jaxq, plain):
        # equal values (a zero's sign aside: sign(-0) is -0 in torch, 0 in
        # the kernel, and multiplies as 0 either way)
        assert got.dtype == F32
        np.testing.assert_array_equal(got, want)
    x = (rng.randn(4096, 8) * 1.5).astype(F32)
    vec = np.stack([rng.uniform(0.5, 1.5, 8), rng.randn(8) * 0.5]).astype(F32)
    got = quantize_act(torch.relu(buf_ops.tile_affine(
        torch.from_numpy(x), torch.from_numpy(vec))), bits).numpy()
    np.testing.assert_array_equal(
        got, kernel_quan(kernel_affine(x, vec[0], vec[1]), bits))


def _near_boundaries(bits, n, seed):
    """(x, a, b) whose exact affine x*a + b lies within an ulp of a code
    boundary (k + 1/2) / S: b = t - x*a rounded, for random x and a."""
    rng = np.random.RandomState(seed)
    s = 2.0 ** (bits - 1)
    t = (rng.randint(0, int(s) - 1, n) + 0.5) / s
    x = (rng.randn(n) * 2).astype(F32)
    a = rng.uniform(0.5, 1.5, n).astype(F32)
    b = (t - np.float64(x) * a).astype(F32)
    return x, a, b


@pytest.mark.parametrize("bits", [8, 12])
def test_a_contracted_affine_flips_codes(bits):
    """With the affine at a code boundary, the two roundings of the
    kernel's ``affine`` give the plain version's codes bit for bit; one
    FMA (float64, then rounded) lands on the other side of the boundary
    for some of them."""
    x, a, b = _near_boundaries(bits, 200000, bits)
    two = kernel_quan(kernel_affine(x, a, b), bits)
    fma = kernel_quan(fma_affine(x, a, b), bits)
    plain = quantize_act(torch.relu(torch.from_numpy(x) * torch.from_numpy(a)
                                    + torch.from_numpy(b)), bits).numpy()
    np.testing.assert_array_equal(plain, two)
    assert (fma != two).sum() >= 1


@pytest.mark.parametrize("bits,one_plane", [(1, True), (2, True), (8, True),
                                            (9, True), (10, False),
                                            (12, False)])
def test_codes_fill_one_bf16_plane_up_to_9_bits(bits, one_plane):
    """Every code k / 2^(bits-1), |k| < 2^(bits-1), at bits <= 9 is its own
    bf16 value: the split's planes 2 and 3 are zero, so the kernels skip
    their products (exact); from 10 bits on some codes need a second
    plane, and the general path runs."""
    s = 1.0 if bits <= 2 else 2.0 ** (bits - 1)
    codes = torch.from_numpy(kernel_quan(np.linspace(-1, 1, 40001,
                                                     dtype=F32), bits))
    assert len(codes.unique()) >= min(2 * s - 1, 3)
    p1, p2, p3 = split_bf16x3(codes)
    assert torch.equal(p1.float() + p2.float() + p3.float(), codes)
    assert bool((p2 == 0).all() and (p3 == 0).all()) == one_plane


def test_ste_gate_matches_jax():
    """``_gate(x, vec, ste=True)`` at float32: the ReLU mask of z = x * inv
    + shift and JAX's ``_ste_mask`` of relu(z), unrounded: 0 < z < 1,
    including z at 1, one ulp below it, and 0."""
    rng = np.random.RandomState(3)
    x = (rng.randn(2048, 8) * 1.5).astype(F32)
    x[:4, 0] = [1.0, np.nextafter(F32(1), F32(0)), 0.0, -0.0]
    vec = np.stack([rng.uniform(0.5, 1.5, 8), rng.randn(8) * 0.5]).astype(F32)
    vec[:, 0] = [1.0, 0.0]
    z = F32(x) * vec[0] + vec[1]
    got = train_ops._gate(torch.from_numpy(x), torch.from_numpy(vec),
                          True).numpy()
    jax_gate = (np.asarray(_ste_mask(jnp.ones(z.shape), jnp.maximum(z, 0)))
                != 0) & (z > 0)
    np.testing.assert_array_equal(got, jax_gate)
    np.testing.assert_array_equal(got, (z > 0) & (z < 1))
    assert got[:4, 0].tolist() == [False, True, False, False]
    assert 0.1 < got.mean() < 0.9


@pytest.mark.parametrize("with_vec2", [False, True])
def test_affine_dot_i8_plain_at_float32_matches_jax(with_vec2):
    """float32 x and out: relu-affine -> q8 -> int8 product -> dequant, the
    float32 product unrounded into an image-major head slot; with ``vec2``
    the BN2 + ReLU + q8 codes of it. Exact against ``_affine_dot_i8`` /
    ``_q8``."""
    rng = np.random.RandomState(8)
    b, hw, k, n = 2, 36, 40, 24
    src = (rng.randn(b * hw, 56) * 0.7).astype(F32)
    vec = np.stack([rng.uniform(0.5, 1.5, 48),
                    rng.randn(48) * 0.5]).astype(F32)
    w = rng.randint(-1, 2, (48, n)).astype(np.int8)
    vec2 = np.stack([rng.uniform(0.02, 0.1, n),
                     rng.randn(n) * 0.3]).astype(F32)
    y = np.asarray(_affine_dot_i8(jnp.asarray(src[:, :k]), jnp.asarray(vec),
                                  jnp.asarray(w), S))
    x = torch.from_numpy(src)[:, :k]
    if with_vec2:
        out = torch.zeros(b * hw, n, dtype=torch.int8)
        quant_ops.affine_dot_i8(x, torch.from_numpy(vec), torch.from_numpy(w),
                                out, s=S, vec2=torch.from_numpy(vec2))
        want = _q8(jnp.maximum(jnp.asarray(y) * vec2[0] + vec2[1], 0.0), S)
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        assert (out != 0).float().mean() > 0.2
    else:
        heads = torch.zeros(b, 3, 6, 6, n)
        got = quant_ops.affine_dot_i8(x, torch.from_numpy(vec),
                                      torch.from_numpy(w),
                                      heads[:, 1].view(b, hw, n), s=S)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(heads[:, 1].reshape(b * hw, n).numpy(),
                                      y)
        assert not heads[:, [0, 2]].any()


@pytest.mark.parametrize("cb,g,r", [(16, 8, 8), (24, 8, 2)])
def test_conv3x3_i8_plain_at_float32_matches_jax(cb, g, r):
    """The int8 conv into a float32 out32 slot: exact against the scatter
    conv of ``fused_model_buf.py``, which sums its float32 taps unrounded
    at float32."""
    rng = np.random.RandomState(9)
    n = 3
    codes = rng.randint(0, 128, (n * r * r, cb)).astype(np.int8)
    w3 = rng.randint(-1, 2, (3, 3, cb, g)).astype(F32)
    want = _jax_scatter_conv(codes, w3, n, r, r)
    buf = torch.zeros(n * r * r, g + 16)
    quant_ops.conv3x3_i8(torch.from_numpy(codes),
                         torch.round(pack_w3(torch.from_numpy(w3))).to(
                             torch.int8), n, r, r, buf[:, 8:8 + g], s=S)
    assert want.dtype == F32
    np.testing.assert_array_equal(buf[:, 8:8 + g].numpy(), want)
    assert not buf[:, :8].any() and not buf[:, 8 + g:].any()


def test_int8_whole_model_matches_jax_kernel_f32(monkeypatch):
    """JAX's default dtype: the port's whole-model int8 path at float32
    (float32 buffers, the int8 kernels' float32 plain versions) against
    JAX's ``fused_model_buf_infer(quant_bits_i=8)`` in interpret mode; the
    int8 products are exact, the float intermedia adapters sum in another
    order."""
    import cunet_tpu.kernels.fused_model_buf as fmb

    orig = fmb.fused_model_buf_infer
    monkeypatch.setattr(fmb, "fused_model_buf_infer",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    cfg = small_cfg(4, 1, use_scan=False, use_pallas=True,
                    pallas_whole_model=True)
    assert cfg.compute_dtype == "float32"
    qp, sn = _quantized(cfg)
    x = images()
    want, _ = jax_apply_cu_net(qp, sn, x, cfg=cfg, train=False, quant=INT8)
    params, state = from_jax(qp, sn, cfg=cfg)
    got, _ = apply_cu_net(params, state, torch.from_numpy(x), cfg=cfg,
                          quant=INT8)
    assert len(got) == len(want) == len(cfg.anchors)
    for g_, j_ in zip(got, want):
        assert g_.dtype == torch.float32 and g_.abs().max() > 0
        np.testing.assert_allclose(g_.numpy(), np.asarray(j_), **MODEL_TOL)
