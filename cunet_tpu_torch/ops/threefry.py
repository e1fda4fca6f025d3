"""JAX's threefry dropout masks (``drop_impl="masks"``), in plain PyTorch.

The JAX package draws each dense layer's dropout mask as
``jax.random.bernoulli(block_key, 1 - rate, (n, res, res, g))`` on a
``fold_in`` chain of threefry2x32 keys (``cunet_tpu/models/cu_net.py``
``_dropout_mask`` and ``_fused_slot_train``): the step key
``fold_in(rng, step)``, the slot key ``fold_in(step_key, i)``, the block key
``fold_in(slot_key, tag)`` with tag j for down block j, 100 for the neck and
200 + j for up block j. This module computes the same bits:

- a key is a pair of uint32 words, ``PRNGKey(s) = (0, s)``;
- ``fold_in(key, d) = threefry2x32(key, (0, d))``;
- the bits of a shape are ``y0 ^ y1`` of ``threefry2x32(key, (hi32(i),
  lo32(i)))`` at each row-major linear index i (JAX's partitionable
  layout, ``jax_threefry_partitionable``);
- a position is kept where ``bits >> 9`` (the mantissa of JAX's uniform
  float in [0, 1)) lies below ``keep_threshold(rate)``, and then holds
  float32(1 / keep) rounded to the compute dtype.

The mask covers the whole batch: unlike :mod:`cunet_tpu_torch.ops.dropmask`
(the ``"prng"`` form) no ghost-BN tile enters its bits. The key chain runs
on the host in Python ints (a handful of scalar hashes per slot, no device
sync); the mask's bits run on int64 tensors holding uint32 values, masked
to 32 bits after every step. ``kernels/drop_ops.py::threefry_mask`` is the
kernel of the same bits.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from cunet_tpu_torch.ops.dropmask import keep_scale

Key = Tuple[int, int]

_U32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# the block tags of the JAX package's fold_in chain
NECK_TAG, UP_TAG = 100, 200


def _rotl(x, r: int):
    return ((x << r) & _U32) | (x >> (32 - r))


def threefry2x32(key: Key, x0, x1):
    """Random123's threefry2x32 (20 rounds) of the count (x0, x1) under
    ``key``: uint32 values as Python ints or int64 tensors. Returns (y0,
    y1)."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ _PARITY)
    x0 = (x0 + ks[0]) & _U32
    x1 = (x1 + ks[1]) & _U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _U32
    return x0, x1


def as_key(key) -> Key:
    """A threefry key as two Python ints: from a (2,) uint32 numpy array
    (JAX's ``PRNGKey`` as ``np.asarray`` gives it), a (2,) uint32 or int64
    tensor, or a pair of ints in [0, 2^32). Raises ``ValueError`` on
    anything else, such as the (4,) keys of JAX's ``rbg`` generators."""
    if isinstance(key, np.ndarray):
        if key.dtype != np.uint32:
            raise ValueError(f"a threefry key is uint32, got {key.dtype}")
        key = key.tolist()
    elif isinstance(key, torch.Tensor):
        if key.dtype not in (torch.int64, getattr(torch, "uint32", None)):
            raise ValueError(f"a threefry key is uint32, got {key.dtype}")
        key = key.tolist()
    key = tuple(key)
    if len(key) != 2 or not all(isinstance(k, int) and 0 <= k <= _U32
                                for k in key):
        raise ValueError(f"a threefry key is two uint32 words (JAX's "
                         f"PRNGKey), got {key}")
    return key


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    return threefry2x32(key, 0, data & _U32)


def block_tag(pos: int, num_blocks: int) -> int:
    """The fold_in tag of traversal position ``pos`` (down 0..nb-1, neck,
    up nb-1..0): j for down block j, 100 for the neck, 200 + j for up
    block j."""
    nb = num_blocks
    if pos < nb:
        return pos
    if pos == nb:
        return NECK_TAG
    return UP_TAG + 2 * nb - pos


def block_keys(slot_key: Key, num_blocks: int) -> List[Key]:
    """The 2 * num_blocks + 1 block keys of one slot, in traversal order."""
    return [fold_in(slot_key, block_tag(pos, num_blocks))
            for pos in range(2 * num_blocks + 1)]


def random_bits(key: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an int64 tensor."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, idx >> 32, idx & _U32)
    return (y0 ^ y1).view(tuple(shape))


def keep_threshold(rate: float) -> int:
    """The least 23-bit mantissa that is dropped: JAX keeps a position
    where its uniform float ``m * 2^-23`` is below float32(1 - rate), that
    is where ``m < ceil(float32(1 - rate) * 2^23)``."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"drop rate must be in (0, 1), got {rate}")
    return math.ceil(float(np.float32(1.0 - rate)) * 2 ** 23)


def bernoulli_mask(key: Key, shape, rate: float, dtype,
                   device=None) -> torch.Tensor:
    """The scaled mask {0, 1/keep} in ``dtype`` of the JAX package's
    ``_dropout_mask(key, shape, rate, dtype)``, bit for bit."""
    keep = (random_bits(key, shape, device) >> 9) < keep_threshold(rate)
    scale = torch.full((), keep_scale(rate, torch.float32),
                       dtype=torch.float32, device=device)
    return torch.where(keep, scale, 0.0).to(dtype)
