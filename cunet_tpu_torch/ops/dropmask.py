"""Counter-hash dropout masks (counterpart of ``cunet_tpu/ops/dropmask.py``).

A mask element depends only on (seed, traversal position, ghost-BN tile,
index within the tile): murmur3's fmix32 finalizer over that counter, kept
iff its low 31 bits fall below ``keep_threshold(rate)``, scaled by 1/keep.
So the slot train forward and its recompute backward regenerate the same
bits with no saved state, the plain path reproduces them tile by tile, and
the masks equal the JAX package's for the same int32 seed, bit for bit.

The hash runs on 32-bit unsigned values held in int64 tensors (or Python
ints), masked to 32 bits after every step: torch's ``>>`` on int32 is
arithmetic, and a 32 x 32-bit product overflows int64's sign, so each
multiply is split into 16-bit halves.

The seeds are int32 values, one per slot per step. The JAX package draws
each from a threefry key (``derive_seed``); the port draws them from an
explicit ``torch.Generator`` (``draw_slot_seeds``), the same contract of 32
bits per slot per step, and a test hands both packages the same seeds.
"""

from __future__ import annotations

from typing import List

import torch

_U32 = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLD = 0x9E3779B9


def _mul32(h, c: int):
    """``(h * c) mod 2^32`` for 32-bit unsigned ``h`` (int or int64 tensor)
    and constant ``c``, without a product past 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _U32


def _fmix32(h):
    """murmur3's fmix32 on 32-bit unsigned values (int or int64 tensor);
    any int32 input is first taken modulo 2^32."""
    h = h & _U32
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def seed_key(seed: int, pos: int) -> int:
    """The (seed, traversal position) half of ``fold_seed``: the key the
    mask kernel folds each tile into."""
    return _fmix32((seed & _U32) ^ _mul32(pos + 1, _GOLD))


def fold_seed(seed: int, pos: int, t: int) -> int:
    """Mix (seed, traversal position, tile) into one 32-bit key (unsigned)."""
    return _fmix32(seed_key(seed, pos) ^ _mul32(t + 1, _M1))


def keep_threshold(rate: float) -> int:
    """31-bit keep threshold: an element is kept iff (bits & 0x7FFFFFFF) is
    below it."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"drop rate must be in (0, 1), got {rate}")
    return min(int((1.0 - rate) * (1 << 31)), (1 << 31) - 1)


def keep_scale(rate: float, dtype) -> float:
    """1/keep as the mask holds it: rounded to float32, then to ``dtype``."""
    return torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32).to(
        dtype).item()


def tile_mask(seed: int, pos: int, t: int, rows: int, lanes: int,
              rate: float, dtype, device=None) -> torch.Tensor:
    """Scaled mask {0, 1/keep} of tile ``t``, shape (rows, lanes), element
    (r, c) hashed at index r * lanes + c."""
    thr = keep_threshold(rate)
    idx = torch.arange(rows * lanes, dtype=torch.int64, device=device)
    u = _fmix32(idx ^ fold_seed(seed, pos, t)) & 0x7FFFFFFF
    scale = torch.full((), 1.0 / (1.0 - rate), dtype=torch.float32,
                       device=device)
    m = torch.where(u < thr, scale, 0.0)
    return m.to(dtype).view(rows, lanes)


def rows_mask(seed: int, pos: int, m: int, lanes: int, tile_rows: int,
              rate: float, dtype, device=None) -> torch.Tensor:
    """(m, lanes) mask over rows grouped in tiles of ``tile_rows``: the
    mask of a channel-plane view whose tile t holds rows
    [t * tile_rows, (t + 1) * tile_rows)."""
    if m % tile_rows:
        raise ValueError(f"{m} rows do not split into tiles of {tile_rows}")
    return torch.cat([tile_mask(seed, pos, t, tile_rows, lanes, rate, dtype,
                                device) for t in range(m // tile_rows)])


def batch_mask(seed: int, pos: int, shape, bt: int, rate: float, dtype,
               device=None) -> torch.Tensor:
    """Full-batch mask (n, h, w, c) assembled tile by tile, ``bt`` images
    per tile (cfg.bn_tile; 0 = the whole batch, one tile)."""
    n, h, w, c = shape
    bt = bt or n
    return rows_mask(seed, pos, n * h * w, c, bt * h * w, rate, dtype,
                     device).view(n, h, w, c)


def draw_slot_seeds(generator: torch.Generator, k: int) -> List[int]:
    """``k`` int32 seeds (one per slot) drawn from ``generator``: 32 bits
    per slot per step, the JAX package's contract. By the birthday bound
    two of the seeds drawn in a run coincide with even odds after about
    77k draws, and a repeated seed repeats its masks."""
    return torch.randint(-2 ** 31, 2 ** 31, (k,), generator=generator,
                         dtype=torch.int64).tolist()
