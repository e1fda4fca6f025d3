"""The exact three-way bf16 split behind ``bwd_reduce``'s tensor-core
products (#7), on the CPU.

``split_bf16x3`` states in torch the split the kernel
(``csrc/bottleneck_kernels.cu::split3``) applies to its float32 operands
(relu(y) for dW, W for g W^T): p1 = bf16(v), p2 = bf16(v - p1),
p3 = bf16(v - p1 - p2). These tests hold that the
pieces add back to v exactly over the normal float32 range, that a product
summed from the three pieces' exact products agrees with the float64
product to float32 rounding, and that one bf16 piece alone breaks the
float32 sum limit the port holds ``bwd_reduce`` to (``1e-5 * sqrt(n)`` of
the largest sum) wherever that limit is below one pass's error: so the
limit of the card tests at M <= 24,576 rows tells the split from a single
bf16 pass.
"""

import numpy as np
import pytest
import torch

SUM_REL_PER_SQRT_N = 1e-5     # chip_smoke.py and the card tests


def split_bf16x3(v: torch.Tensor):
    """p1 = bf16(v), p2 = bf16(v - p1), p3 = bf16(v - p1 - p2), each
    difference exact in float32."""
    v = v.float()
    p1 = v.bfloat16()
    r1 = v - p1.float()
    p2 = r1.bfloat16()
    return p1, p2, (r1 - p2.float()).bfloat16()


def test_pieces_add_back_exactly_over_the_normal_range():
    """10^6 float32 values with exponents from -90 to 90, both signs."""
    gen = torch.Generator().manual_seed(0)
    mant = torch.rand(10 ** 6, generator=gen) + 1.0
    exp = torch.randint(-90, 91, (10 ** 6,), generator=gen).float()
    sign = torch.where(torch.rand(10 ** 6, generator=gen) < 0.5, -1.0, 1.0)
    v = sign * mant * torch.exp2(exp)
    p1, p2, p3 = split_bf16x3(v)
    assert all(p.dtype == torch.bfloat16 for p in (p1, p2, p3))
    total = p1.double() + p2.double() + p3.double()
    assert torch.equal(total, v.double())
    # the pieces carry the low bits: p2 and p3 are not zero in general
    assert (p2 != 0).float().mean() > 0.9 and (p3 != 0).float().mean() > 0.5


def test_split_of_zero_and_of_bf16_values():
    v = torch.tensor([0.0, 1.0, -0.5, 3.0, 2.0 ** -100])
    p1, p2, p3 = split_bf16x3(v)
    assert torch.equal(p1.float(), v)
    assert not p2.float().any() and not p3.float().any()


def _operands(m, seed):
    """relu(y) of BN-like float32 features (full 24-bit significands) and
    a bf16 cotangent, as ``bwd_reduce`` sees them."""
    rng = np.random.RandomState(seed)
    y = rng.randn(m, 8).astype(np.float32) * np.float32(1.3) + np.float32(0.1)
    r = torch.relu(torch.from_numpy(y))
    g = torch.from_numpy(rng.randn(m, 16).astype(np.float32)).bfloat16()
    return r, g


def _rel_err(pieces, r, g):
    want = r.double().t() @ g.double()
    got = sum(p.float().t() @ g.float() for p in pieces)
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def test_three_pieces_give_the_float64_product_to_float32_rounding():
    """dW = sum_i p_i^T g over 98,304 rows (batch 24 at r=64): within
    float32 rounding of the float64 product, where one bf16 piece misses
    by ~1e-3 of the largest sum."""
    r, g = _operands(98_304, 1)
    pieces = split_bf16x3(r)
    three = _rel_err(pieces, r, g)
    one = _rel_err(pieces[:1], r, g)
    assert three < 2e-6
    assert one > 2e-4
    assert one > 100 * three


@pytest.mark.parametrize("m", [24 * 16 * 16, 24 * 8 * 8, 24 * 4 * 4])
def test_one_piece_breaks_the_float32_sum_limit_where_three_hold_it(m):
    """At r <= 16 (batch 24) the float32 sum limit 1e-5 * sqrt(M) of the
    largest sum is below one bf16 pass's error: one piece breaks it, the
    three pieces stay far inside it."""
    r, g = _operands(m, m)
    pieces = split_bf16x3(r)
    limit = SUM_REL_PER_SQRT_N * m ** 0.5
    assert _rel_err(pieces, r, g) < 0.1 * limit
    assert _rel_err(pieces[:1], r, g) > limit
