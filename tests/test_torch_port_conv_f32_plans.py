"""Torch port, on the CPU: the float32 train convs' ``wgmma`` kernel
(``csrc/conv_f32_kernels.cu``, ``conv3x3[f32,tile]`` and
``conv3x3_dx[f32]``) as far as a CPU can hold it.

- ``buf_ops.conv_f32_plan``: which shapes the kernel takes (those whose
  ``dot3_kernel`` plan does not split K, C of 32 or a multiple of 64, N up
  to 128; the eval and QuanInput forms never reach it), its halo ring and
  buffers within the H100's shared memory, a function of the shapes
  alone;
- a torch mirror of the kernel's walk: persistent blocks over runs of
  consecutive 128-row tiles, the halo ring (each pixel's prologue and
  three-way bf16 split made once, in ring row (p - p0) % R), every tap's
  window read from the ring (its row asserted to hold the source pixel)
  or from the zero row, each 32-deep chunk of K's twelve plane products
  from zero joined in ascending k, the dx's gate and W read flipped:
  bit for bit ``test_torch_port_f32_forms.dot3_mirror`` on the im2col
  operand, the sums ``dot3_kernel`` gives (within float32 rounding of the
  plain version, which ``torch.nn.functional.conv2d`` sums otherwise).
"""

import pytest
import torch

from cunet_tpu_torch.kernels import buf_ops, train_ops
from cunet_tpu_torch.kernels.buf_ops import SMEM_LIMIT, tile_affine

from test_torch_port_bf16_split import split_bf16x3
from test_torch_port_f32_forms import ORDER, dot3_mirror

ROWS = buf_ops.CONV_F32_ROWS
DEPTH = buf_ops.CONV_F32_DEPTH
# (batch, image side) of the CU-Net-8 @256 ghost-BN step's convs, batch 24
STEP = [(24, r) for r in (64, 32, 16, 8, 4)]


@pytest.mark.parametrize("b,r", STEP)
@pytest.mark.parametrize("c,n,gate", [(128, 32, False), (32, 128, True)])
def test_plan_takes_the_unsplit_shapes_and_fits(b, r, c, n, gate):
    """The forward (Cb = 128 -> 32) and the dx (32 -> 128) take the kernel
    where ``dot3_kernel``'s plan does not split K (r = 64 and 32 of the
    step), else stay on it; the plan's halo planes, zero row, W slices and
    the dx's gate tile fit the H100's shared memory, at the offsets the
    kernel checks."""
    m = b * r * r
    p = buf_ops.conv_f32_plan(m, r, r, c, n, gate)
    splits = buf_ops.conv3x3_plan_f32(m, c, n).splits
    assert (p is None) == (splits > 1)
    assert (p is not None) == (r >= 32)
    if p is None:
        return
    assert p.np_ == next(w for w in buf_ops.CONV_F32_NP if n <= w)
    assert p.halo_rows == ROWS + 2 * r + 2
    assert p.plane_bytes == p.halo_rows * c * 2
    assert p.zero_off == 3 * p.plane_bytes
    assert p.w_off % 128 == 0 and p.w_off >= p.zero_off + 16
    assert p.w_bytes == 3 * DEPTH * p.np_ * 2
    assert p.g_off == p.w_off + buf_ops.CONV_F32_RING \
        * buf_ops.CONV_F32_SLICE * p.w_bytes
    assert p.smem == p.g_off + (ROWS * (p.np_ + 4) * 4 if gate else 0)
    assert p.smem <= SMEM_LIMIT


@pytest.mark.parametrize("m,h,w,c,n", [
    (96, 4, 4, 64, 32),      # a chunk of K would not lie in one tap
    (24 * 64 * 64, 64, 64, 48, 32),
    (24 * 64 * 64, 64, 64, 128, 136),   # N past 128
    (24 * 64 * 64, 64, 64, 96, 32),     # C neither 32 nor a multiple of 64
    (8 * 256 * 256, 256, 256, 128, 32),  # a halo too tall
])
def test_plan_leaves_the_other_shapes_to_dot3(m, h, w, c, n):
    assert buf_ops.conv_f32_plan(m, h, w, c, n, False) is None


def test_plan_is_a_function_of_the_shapes_alone(monkeypatch):
    shapes = [(b * r * r, r, r, c, n, gate) for b, r in STEP
              for c, n, gate in ((128, 32, False), (32, 128, True),
                                 (64, 48, False), (256, 64, True))]

    def plans():
        buf_ops.conv_f32_plan.cache_clear()
        return [buf_ops.conv_f32_plan(*s) for s in shapes]

    want = plans()
    for name in ("is_available", "device_count", "current_device"):
        def broken(*a, **k):
            raise AssertionError("a plan asked the card")
        monkeypatch.setattr(torch.cuda, name, broken)
    assert plans() == want


def _tap_rows(m0, rows, h, w, dy, dx):
    """The tile's rows, their source pixels through tap (dy, dx) and
    whether each lies in its row's image (the kernel's tap_row)."""
    m = torch.arange(m0, m0 + rows)
    pix = m % (h * w)
    yy, xx = pix // w, pix % w
    ok = (yy + dy >= 0) & (yy + dy < h) & (xx + dx >= 0) & (xx + dx < w)
    return m + dy * w + dx, ok


def wg_conv_mirror(y, w3, b, h, w, vec=None, gate=None, flip=False,
                   grid=1):
    """The kernel's walk in torch (the module docstring): y (M, C); w3 the
    packed (9C, N) weight, with ``flip`` the forward's (9N, C) read as
    ``train_ops.flip_w3`` of it; ``vec`` (T, 2, C) the forward's
    prologue; ``gate`` = (gx (M, N), (T, 2, N) vectors) the dx's;
    ``grid`` persistent blocks."""
    m, c = y.shape
    wk = train_ops.flip_w3(w3) if flip else w3
    n = wk.shape[1]
    assert c % DEPTH == 0
    ring_rows = ROWS + 2 * w + 2
    x = torch.relu(tile_affine(y, vec)) if vec is not None else y
    xp = split_bf16x3(x)                 # each pixel split once
    wp = split_bf16x3(wk)
    zero = torch.zeros(c, dtype=torch.bfloat16)
    out = torch.zeros(m, n)
    tiles = -(-m // ROWS)
    for blk in range(grid):
        t_beg, t_end = blk * tiles // grid, (blk + 1) * tiles // grid
        p0 = t_beg * ROWS - w - 1
        ring = torch.full((ring_rows,), -1, dtype=torch.long)
        planes = [torch.zeros(ring_rows, c, dtype=torch.bfloat16)
                  for _ in range(3)]
        for t in range(t_beg, t_end):
            m0 = t * ROWS
            hb = m0 - w - 1
            rows = min(ROWS, m - m0)
            for r in range(0 if t == t_beg else ring_rows - ROWS, ring_rows):
                p = hb + r
                if 0 <= p < m:
                    q = (p - p0) % ring_rows
                    ring[q] = p
                    for k in range(3):
                        planes[k][q] = xp[k][p]
            # A of the tile: each tap's window from the ring (its row holds
            # the source pixel) or the zero row
            a = [torch.empty(rows, 9 * c, dtype=torch.bfloat16)
                 for _ in range(3)]
            for tap in range(9):
                dy, dx = tap // 3 - 1, tap % 3 - 1
                src, ok = _tap_rows(m0, rows, h, w, dy, dx)
                slot = (src - p0) % ring_rows
                assert torch.equal(ring[slot][ok], src[ok])
                for k in range(3):
                    a[k][:, tap * c:(tap + 1) * c] = torch.where(
                        ok[:, None], planes[k][slot], zero)
            acc = torch.zeros(rows, n)
            for c0 in range(0, 9 * c, DEPTH):
                part = torch.zeros(rows, n)
                for k0 in (c0, c0 + 16):
                    for i, j in ORDER:
                        part = part + a[i][:, k0:k0 + 16].float() @ \
                            wp[j][k0:k0 + 16].float()
                acc = acc + part
            out[m0:m0 + rows] = acc
    if gate is not None:
        gx, gvec = gate
        out = torch.where(tile_affine(gx, gvec) > 0, out, 0.0)
    return out


def _im2col(y, b, h, w):
    c = y.shape[1]
    p = torch.nn.functional.pad(y.reshape(b, h, w, c), (0, 0, 1, 1, 1, 1))
    cols = [p[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]
    return torch.cat(cols, dim=-1).reshape(b * h * w, 9 * c)


def _operands(b, h, c, n, tiles, seed):
    gen = torch.Generator().manual_seed(seed)
    m = b * h * h
    y = torch.randn(m, c, generator=gen) * 1.5 + 0.2
    vec = torch.stack([torch.rand(tiles, c, generator=gen) + 0.5,
                       torch.randn(tiles, c, generator=gen) * 0.3], 1)
    w3 = torch.randn(9 * c, n, generator=gen) * (9 * c) ** -0.5
    return y, vec, w3


@pytest.mark.parametrize("b,h,c,n,tiles,grid", [
    (3, 8, 32, 32, 3, 1),    # two tiles (the second ragged), one block
    (3, 8, 64, 16, 1, 2),    # a block a tile
    (5, 12, 32, 64, 5, 2),   # ring rows past a tile of two images
])
def test_forward_mirror_is_dot3_bit_for_bit(b, h, c, n, tiles, grid):
    """The forward (per-tile prologue): the kernel's walk gives
    ``dot3_mirror`` of the im2col operand bit for bit, within float32
    rounding of the plain version."""
    y, vec, w3 = _operands(b, h, c, n, tiles, seed=c + n)
    got = wg_conv_mirror(y, w3, b, h, h, vec=vec, grid=grid)
    z = torch.relu(tile_affine(y, vec))
    assert torch.equal(got, dot3_mirror(_im2col(z, b, h, h), w3))
    plain = buf_ops.conv3x3_plain(y, w3, b, h, h, torch.empty(b * h * h, n),
                                  vec=vec)
    torch.testing.assert_close(got, plain, rtol=0, atol=2e-5)


@pytest.mark.parametrize("b,h,g,cb,tiles", [(3, 8, 32, 64, 3),
                                            (2, 16, 32, 128, 1)])
def test_dx_mirror_is_dot3_bit_for_bit(b, h, g, cb, tiles):
    """The dx: dy through the forward's weight read flipped, gated by the
    BN2 affine of the conv input: bit for bit ``dot3_mirror`` through
    ``flip_w3`` with the gate, within float32 rounding of the plain
    version."""
    dy = _operands(b, h, g, cb, tiles, seed=g + cb)[0]
    gx, gvec, w3 = _operands(b, h, cb, g, tiles, seed=cb)
    got = wg_conv_mirror(dy, w3, b, h, h, gate=(gx, gvec), flip=True,
                         grid=2)
    want = torch.where(tile_affine(gx, gvec) > 0,
                       dot3_mirror(_im2col(dy, b, h, h),
                                   train_ops.flip_w3(w3)), 0.0)
    assert torch.equal(got, want)
    plain = train_ops.conv3x3_dx_plain(dy, w3, b, h, h, gx, gvec,
                                       torch.empty(b * h * h, cb))
    torch.testing.assert_close(got, plain, rtol=0, atol=2e-5)
