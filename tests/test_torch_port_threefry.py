"""Torch port, the threefry dropout masks (``cunet_tpu_torch.ops.threefry``,
the ``drop_impl="masks"`` form) on the CPU against the installed JAX.

threefry2x32 against Random123's known-answer vectors; ``fold_in``,
``random_bits`` and ``bernoulli_mask`` bit for bit against
``jax.random.fold_in``, ``jax.random.bits`` and the JAX package's
``_dropout_mask``; ``block_keys`` against the fold_in chain of the JAX
package's ``_fused_slot_train`` (compared as masks); the digests that
``chip_smoke.py`` holds the port's masks to on the card (``MASK_DIGESTS``)
against JAX's masks; the keys the port refuses.
"""

import functools
import hashlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cunet_tpu.models.cu_net import _dropout_mask
from cunet_tpu_torch.ops import threefry

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

U32 = 2 ** 32 - 1
# Random123's threefry2x32 (20 rounds) known answers: (key, count, result)
KAT = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
       ((U32, U32), (U32, U32), (0x1CB996FC, 0xBB002BE7)),
       ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
        (0xC4923A9C, 0x483DF7A0))]
DTYPES = [(jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)]
NB = 4


def _key(k):
    return threefry.as_key(np.asarray(k))


def _jax_mask(key, shape, rate, dt):
    """The JAX package's ``_dropout_mask`` as float32 numpy (exact: the
    mask holds 0 and one scale)."""
    fn = jax.jit(lambda k: _dropout_mask(k, shape, rate, dt).astype(
        jnp.float32))
    return np.asarray(fn(key))


def test_jax_threefry_layout_is_the_mirrored_one():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert _key(jax.random.PRNGKey(12345)) == (0, 12345)


@pytest.mark.parametrize("key,count,want", KAT)
def test_threefry2x32_known_answers(key, count, want):
    assert threefry.threefry2x32(key, *count) == want
    got = threefry.threefry2x32(key, torch.tensor([count[0]]),
                                torch.tensor([count[1]]))
    assert (got[0].item(), got[1].item()) == want


@pytest.mark.parametrize("tag", [0, 1, 100, 200, 201, 202, 203, 2 ** 31 - 1,
                                 U32])
def test_fold_in_matches_jax(tag):
    base = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    want = _key(jax.random.fold_in(base, np.uint32(tag)))
    assert threefry.fold_in(_key(base), tag) == want


@pytest.mark.parametrize("shape", [(7,), (3, 5, 11), (2, 1, 13, 3)])
def test_random_bits_match_jax(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(5), 17)
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    got = threefry.random_bits(_key(key), shape)
    assert got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("rate", [0.2, 0.25])
@pytest.mark.parametrize("dts", DTYPES, ids=["bf16", "f32"])
def test_bernoulli_mask_matches_jax_dropout_mask(dts, rate):
    jdt, tdt = dts
    key = jax.random.fold_in(jax.random.PRNGKey(9), 200 + 3)
    shape = (3, 16, 16, 8)
    want = _jax_mask(key, shape, rate, jdt)
    got = threefry.bernoulli_mask(_key(key), shape, rate, tdt)
    assert got.dtype == tdt and got.shape == shape
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert 0 < (want == 0).mean() < 2 * rate


def test_keep_threshold_is_jax_comparison():
    """``m < keep_threshold`` iff JAX's uniform float ``m * 2^-23`` lies
    below float32(keep), at the threshold and one mantissa either side."""
    for rate in (0.2, 0.25, 0.5, 1 / 3):
        thr = threefry.keep_threshold(rate)
        keep = np.float32(1.0 - rate)
        for m in (thr - 1, thr, thr + 1):
            u = np.float32(m) * np.float32(2.0 ** -23)
            assert (m < thr) == (u < keep), (rate, m)


def test_block_keys_match_the_fused_slot_chain():
    """The masks of ``block_keys`` in traversal order equal those of the
    JAX package's ``_fused_slot_train`` list (down j -> fold(r, j), neck ->
    fold(r, 100), up j -> fold(r, 200 + j) for j = nb-1 ... 0)."""
    rng = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(7), 2),
                             1)
    keys = [jax.random.fold_in(rng, j) for j in range(NB)]
    keys.append(jax.random.fold_in(rng, 100))
    for j in reversed(range(NB)):
        keys.append(jax.random.fold_in(rng, 200 + j))
    got = threefry.block_keys(_key(rng), NB)
    assert len(got) == len(keys) == 2 * NB + 1
    for pos, (k, r) in enumerate(chip_smoke.mask_positions(NB, 16)):
        shape = (2, r, r, 8)
        np.testing.assert_array_equal(
            threefry.bernoulli_mask(got[pos], shape, 0.2,
                                    torch.float32).numpy(),
            _jax_mask(keys[pos], shape, 0.2, jnp.float32), err_msg=str(pos))


@pytest.mark.parametrize("dts", DTYPES, ids=["bf16", "f32"])
def test_chip_smoke_mask_digests_are_jax_masks(dts):
    """``chip_smoke.MASK_DIGESTS`` is the digest of JAX's masks (PRNGKey(0),
    step 3, slot 1, every position of CU-Net-8 @256's step at batch 24),
    and the port's plain masks on the CPU give it too."""
    jdt, tdt = dts
    slot = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(0), chip_smoke.MASK_STEP), chip_smoke.MASK_SLOT)
    keys = {threefry.fold_in(_key(slot), threefry.block_tag(pos, NB)):
            jax.random.fold_in(slot, threefry.block_tag(pos, NB))
            for pos in range(2 * NB + 1)}

    @functools.lru_cache(maxsize=None)
    def draw(shape):
        return jax.jit(lambda k: _dropout_mask(k, shape, chip_smoke.DROP_RATE,
                                               jdt))

    def jax_masks(key, shape):
        return torch.from_numpy(
            np.asarray(draw(shape)(keys[key]).astype(jnp.float32))).to(tdt)

    name = str(tdt).split(".")[-1]
    assert chip_smoke.mask_digest(torch, tdt, "cpu", jax_masks) == \
        chip_smoke.MASK_DIGESTS[name]
    assert chip_smoke.mask_digest(torch, tdt, "cpu") == \
        chip_smoke.MASK_DIGESTS[name]
    assert hashlib.sha256(b"").hexdigest() not in chip_smoke.MASK_DIGESTS


@pytest.mark.parametrize("bad", [
    np.zeros(4, np.uint32),              # a (4,) key of JAX's rbg generators
    np.zeros(2, np.int32),               # not uint32
    (1, 2, 3), (-1, 0), (0, 2 ** 32),    # not two uint32 words
    torch.zeros(2, dtype=torch.float32),
])
def test_as_key_refuses_what_is_not_a_threefry_key(bad):
    with pytest.raises(ValueError):
        threefry.as_key(bad)
