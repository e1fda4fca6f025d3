"""Torch port: the counter-hash dropout masks (``cunet_tpu_torch/ops/
dropmask.py``) against ``cunet_tpu/ops/dropmask.py``, bit for bit, and the
masks' statistics (as tests/test_dropmask.py holds the JAX helper).

The JAX functions take int32 seeds (``derive_seed``'s output type); the
port hashes the same 32 bits as unsigned values, so every comparison is of
the uint32 bit patterns, over seeds including negatives, every traversal
position of a two- and a four-block slot (0..2nb), several tiles, and the
rates 0.2, 0.25 and 0.5 in float32 and bfloat16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cunet_tpu.ops import dropmask as jdm
from cunet_tpu_torch.kernels import drop_ops
from cunet_tpu_torch.ops import dropmask

SEEDS = [0, 1, -1, 77, -123456789, 2 ** 31 - 1, -2 ** 31]
RATES = [0.2, 0.25, 0.5]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _u32(a):
    return np.asarray(a).astype(np.int32).view(np.uint32).astype(np.int64)


def test_fmix32_matches_jax():
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randint(-2 ** 31, 2 ** 31, 20000, np.int64),
                        [0, 1, -1, 2 ** 31 - 1, -2 ** 31]])
    want = _u32(jdm._fmix32(jnp.asarray(x.astype(np.int32))))
    got = dropmask._fmix32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert all(dropmask._fmix32(int(v)) == w for v, w in zip(x[:50], want))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_seed_matches_jax(seed):
    for pos in range(9):
        for t in (0, 1, 2, 11, 1000):
            want = int(_u32(jdm.fold_seed(seed, pos, t)))
            assert dropmask.fold_seed(seed, pos, t) == want, (pos, t)


@pytest.mark.parametrize("rate", RATES + [1e-9, 0.999])
def test_keep_threshold_matches_jax(rate):
    assert dropmask.keep_threshold(rate) == jdm.keep_threshold(rate)


@pytest.mark.parametrize("rate", [0.0, 1.0, -0.1, 1.5])
def test_rate_outside_open_interval_raises(rate):
    with pytest.raises(ValueError):
        dropmask.keep_threshold(rate)
    with pytest.raises(ValueError):
        dropmask.tile_mask(1, 0, 0, 4, 8, rate, torch.float32)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_tile_mask_matches_jax(rate, dt):
    for seed in SEEDS[:5]:
        for pos in range(9):
            for t in (0, 3):
                want = np.asarray(jdm.tile_mask(seed, pos, t, 32, 8, rate,
                                                dt[0]).astype(jnp.float32))
                got = dropmask.tile_mask(seed, pos, t, 32, 8, rate, dt[1])
                assert got.dtype == dt[1]
                np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("bt", [0, 1, 2])
def test_batch_mask_matches_jax(rate, bt):
    for seed in (5, -9):
        for pos, res in ((0, 8), (2, 2), (4, 8)):
            shape = (4, res, res, 8)
            want = np.asarray(jdm.batch_mask(seed, pos, shape, bt, rate,
                                             jnp.bfloat16).astype(
                jnp.float32))
            got = dropmask.batch_mask(seed, pos, shape, bt, rate,
                                      torch.bfloat16)
            np.testing.assert_array_equal(got.float().numpy(), want)


def test_mask_distribution_and_values():
    m = dropmask.tile_mask(77, 2, 0, 8192, 32, 0.25, torch.float32).numpy()
    assert set(np.unique(m).tolist()) <= {0.0, np.float32(1.0 / 0.75)}
    assert abs(m.mean() - 1.0) < 0.01          # 262k samples
    assert abs((m != 0).mean() - 0.75) < 0.01


def test_mask_deterministic_and_key_sensitive():
    a = dropmask.tile_mask(5, 1, 3, 1024, 16, 0.5, torch.float32)
    assert torch.equal(a, dropmask.tile_mask(5, 1, 3, 1024, 16, 0.5,
                                             torch.float32))
    for seed, pos, t in ((6, 1, 3), (5, 2, 3), (5, 1, 4)):
        c = dropmask.tile_mask(seed, pos, t, 1024, 16, 0.5, torch.float32)
        assert not torch.equal(a, c), (seed, pos, t)


def test_mask_lag_decorrelated():
    m = dropmask.tile_mask(123, 0, 0, 8192, 32, 0.5, torch.float32)
    b = (m != 0).double().flatten().numpy()
    for lag in (1, 32, 33):
        r = np.corrcoef(b[:-lag], b[lag:])[0, 1]
        assert abs(r) < 0.02, (lag, r)


def test_draw_slot_seeds():
    a = dropmask.draw_slot_seeds(torch.Generator().manual_seed(0), 8)
    b = dropmask.draw_slot_seeds(torch.Generator().manual_seed(0), 8)
    gen = torch.Generator().manual_seed(0)
    c, d = (dropmask.draw_slot_seeds(gen, 8) for _ in range(2))
    assert a == b == c != d
    assert len(a) == 8 and all(-2 ** 31 <= s < 2 ** 31 for s in a + d)
    assert len(set(a + d)) == 16


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_drop_mask_plain_forward_and_backward(dt):
    """The mask op's plain version: the forward multiplies an out32 view of
    a wider buffer in place in its dtype (nothing else moves), the backward
    takes the float32 cotangent to ``out``'s dtype."""
    m, g, tile_rows = 64, 8, 16
    buf = torch.randn(m, 24, generator=torch.Generator().manual_seed(1)).to(
        dt)
    mask = dropmask.rows_mask(-3, 4, m, g, tile_rows, 0.25, dt)
    want = buf.clone()
    want[:, 8:16] = buf[:, 8:16] * mask
    drop_ops.drop_mask.launches = 0
    drop_ops.drop_mask(buf[:, 8:16], -3, 4, 0.25, tile_rows)
    assert torch.equal(buf, want)
    d = torch.randn(m, g, generator=torch.Generator().manual_seed(2))
    out = torch.empty(m, g, dtype=dt)
    drop_ops.drop_mask(d, -3, 4, 0.25, tile_rows, out)
    assert torch.equal(out, (d * mask.float()).to(dt))
    assert drop_ops.drop_mask.launches == 0
    with pytest.raises(ValueError):
        drop_ops.drop_mask(d, -3, 4, 0.25, 48)


@pytest.mark.parametrize("tile_images", [0, 2])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_dropout_function_equals_plain_product(dt, tile_images):
    """``drop_ops.dropout`` (the layer-by-layer kernel path's dropout, an
    autograd Function over the mask op) gives ``y * batch_mask`` and its
    gradient bit for bit, from an NHWC view as the 3x3 conv returns it,
    and leaves its input as it was."""
    gen = torch.Generator().manual_seed(3)
    y = torch.randn(4, 3, 8, 6, generator=gen).to(dt).permute(0, 2, 3, 1)
    y0 = y.clone()
    yk, yp = y.clone().requires_grad_(True), y.clone().requires_grad_(True)
    got = drop_ops.dropout(yk, -7, 3, 0.2, tile_images)
    want = yp * dropmask.batch_mask(-7, 3, y.shape, tile_images, 0.2, dt)
    assert torch.equal(got, want)
    ct = torch.randn(y.shape, generator=gen).to(dt)
    got.backward(ct)
    want.backward(ct)
    assert torch.equal(yk.grad, yp.grad)
    assert torch.equal(y, y0)
