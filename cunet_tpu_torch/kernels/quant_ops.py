"""The int8 kernels of the quantized whole-model forward, each beside its
plain version, and the registry of all three int8 kernels.

Counterparts of the int8 branch of
``cunet_tpu/kernels/fused_model_buf.py::fused_model_buf_infer``: its
``_affine_dot_i8`` (with ``_q8``) and its int8 scatter 3x3 conv. The
wrappers read and write strided 2-D views of the channel-plane buffers of
:mod:`cunet_tpu_torch.kernels.model_buf`, as :mod:`buf_ops` does. On a CPU
tensor a wrapper computes the plain PyTorch version; on a CUDA tensor it
launches the kernel or raises. ``<wrapper>.launches`` counts the kernel
launches and nothing else. Both kernels (``csrc/i8_kernels.cu``) read
their weights as the K-major images of ``pack_w_i8`` / ``pack_w3_i8``
(packed once as the slots are marshalled) and take their tiling from
the host plans ``i8_dot_plan`` / ``i8_conv_plan``.

Integer products with int32 accumulation are exact in any order, the
quantizer's scale S = 2^(bits_i-1) is a power of two (so scaling and
dequantizing are exact), and the BN affine rounds after the product and
after the sum in both versions: each kernel is bit-identical to its plain
version on the same operands.

A float32 model (``compute_dtype="float32"``, JAX's default, whose #1 runs
the same int8 branch on float32 buffers) runs their float32 forms:
``affine_dot_i8`` reads float32 x and ``affine_dot_i8`` / ``conv3x3_i8``
write the dequantized float32 product unrounded.
``<wrapper>.f32_launches`` counts those launches (also in ``launches``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from cunet_tpu_torch.kernels import build
from cunet_tpu_torch.kernels.buf_ops import (
    BF16,
    F32,
    SMEM_LIMIT,
    SMEM_PAIR,
    _check_rows,
    _check_vec,
    _check_view,
    _rows,
    _stream,
    _up,
    tile_affine,
)
from cunet_tpu_torch.kernels.quant_matmul import (
    _check_i8,
    int8_matmul_dequant,
    int8_matmul_dequant_plain,
    int_dot,
    q8,
)


# ---------------------------------------------------------------------------
# the weights' K-major images and the kernels' plans (csrc/i8_kernels.cu)
# ---------------------------------------------------------------------------

# A block of either kernel: 8 warps, a warp 32 output rows (two m16 tiles)
I8_WARPS = 8
I8_WARP_ROWS = 32
# the K-major image's rows: K zero-padded to a whole m16n8k32 step
I8_DEPTH = 32
# affine_dot_i8: n8 tiles a warp (the kernel's instances), the most K
# columns of a pipeline step (K is split into equal steps of whole k32
# steps; the kernel's quantizer map takes up to 256 vectors of 8 a row)
# and ring depths, by preference
I8_NTW = (4, 2, 1)
I8_MAX_KC = 2048
I8_STAGES = (3, 2)
# the narrowest step for which two blocks an SM are preferred to one
I8_PAIR_KC = 128
# conv3x3_i8: n8 tiles a warp (its instances), the row tiles, and the tile
# count it aims for before it takes a smaller row tile (about one per SM
# of the card's 132, a constant: the plan depends on the shapes alone)
I8_CONV_NT = (1, 2, 4, 8)
I8_CONV_ROWS = (256, 128, 64, 32)
I8_CONV_TILES = 128


def pack_w_i8(w: torch.Tensor) -> torch.Tensor:
    """The K-major image of a (K, N) int8 weight that the int8 tensor-core
    operand reads: (N, K zero-padded to ``I8_DEPTH``), row n holding
    ``w[:, n]``. A K prefix of ``w`` (a growth-phase slot) is the same
    prefix of every row."""
    k = w.shape[0]
    return torch.nn.functional.pad(w.t(), (0, _up(k, I8_DEPTH) - k)
                                   ).contiguous()


def pack_w3_i8(w3p: torch.Tensor) -> torch.Tensor:
    """The K-major image of a packed (9*Cb, G) int8 3x3 weight
    (``buf_ops.pack_w3`` layout): (G, 9 * Cbp), Cbp = Cb zero-padded to
    ``I8_DEPTH``, tap-major (row n holds tap t's Cb channels at
    [t * Cbp, t * Cbp + Cb))."""
    cb, g = w3p.shape[0] // 9, w3p.shape[1]
    cbp = _up(cb, I8_DEPTH)
    return torch.nn.functional.pad(w3p.reshape(9, cb, g),
                                   (0, 0, 0, cbp - cb)
                                   ).reshape(9 * cbp, g).t().contiguous()


@dataclasses.dataclass(frozen=True)
class I8DotPlan:
    """How ``affine_dot_i8``'s kernel cuts an (m, K) -> (m, N) product:
    row tiles of ``bm`` rows (``row_warps`` warps of 32 rows), N in
    ``ngrp`` groups of ``ncol`` columns (``col_warps`` warps of ``ntw`` n8
    tiles; columns past N are zero weights and are not stored), K padded
    to ``kp`` and walked in ``nch`` steps of ``kc`` columns. Shared memory
    (byte offsets): the group's weight rows (``resident``: ncol rows of kp
    + 16 at ``w_off``; else each ring stage opens with its chunk's,
    ``wchunk_bytes``), [inv; shift] of kp and [inv2; shift2] of ncol
    floats at ``vec_off``, ``stages`` ring buffers of ``stage_bytes`` from
    ``ring_off`` (a step's x rows, kc elements of ``esz`` bytes), a step's
    codes (bm rows of kc + 16) at ``codes_off``, the warps' output stages
    at ``out_off``; ``smem`` bytes in all."""
    bm: int
    ncol: int
    ngrp: int
    ntw: int
    kp: int
    kc: int
    nch: int
    stages: int
    resident: bool
    w_off: int
    vec_off: int
    ring_off: int
    stage_bytes: int
    wchunk_bytes: int
    codes_off: int
    out_off: int
    smem: int

    @property
    def row_warps(self) -> int:
        return self.bm // I8_WARP_ROWS

    @property
    def col_warps(self) -> int:
        return I8_WARPS // self.row_warps

    def tiles(self, m: int) -> int:
        return -(-m // self.bm)

    def items(self, m: int) -> int:
        return self.tiles(m) * self.ngrp

    def args(self):
        """The plan's fields in the C entry's order."""
        return (self.bm, self.ncol, self.ngrp, self.ntw, self.kp, self.kc,
                self.nch, self.stages, int(self.resident), self.w_off,
                self.vec_off, self.ring_off, self.stage_bytes,
                self.wchunk_bytes, self.codes_off, self.out_off, self.smem)


def _i8_dot_layout(bm, ntw, k, n, esz, osz, kc, stages, resident):
    ncol = 8 * ntw * (I8_WARPS // (bm // I8_WARP_ROWS))
    kp = _up(k, I8_DEPTH)
    w_bytes = _up(ncol * (kp + 16), 128) if resident else 0
    wchunk = 0 if resident else _up(ncol * (kc + 16), 128)
    vec_off = w_bytes
    ring_off = vec_off + _up(4 * (2 * kp + 2 * ncol), 128)
    stage_bytes = wchunk + _up(bm * kc * esz, 128)
    codes_off = ring_off + stages * stage_bytes
    out_off = codes_off + _up(bm * (kc + 16), 128)
    smem = out_off + I8_WARPS * 16 * (8 * ntw * osz + 16)
    return I8DotPlan(bm=bm, ncol=ncol, ngrp=-(-n // ncol), ntw=ntw, kp=kp,
                     kc=kc, nch=-(-kp // kc), stages=stages,
                     resident=resident, w_off=0, vec_off=vec_off,
                     ring_off=ring_off, stage_bytes=stage_bytes,
                     wchunk_bytes=wchunk, codes_off=codes_off,
                     out_off=out_off, smem=smem)


def _i8_dot_tilings(n: int):
    """The (bm, ntw) of ``affine_dot_i8``'s warps for N outputs that give
    the fewest column groups, then the fewest columns past N; in the
    order of row tiles of 64, 128, 256, 32, the widest warps first."""
    cands = []
    for bm in (64, 128, 256, 32):
        for ntw in I8_NTW:
            ncol = 8 * ntw * (I8_WARPS // (bm // I8_WARP_ROWS))
            ngrp = -(-n // ncol)
            cands.append(((ngrp, ngrp * ncol - n), bm, ntw))
    best = min(c[0] for c in cands)
    return [(bm, ntw) for key, bm, ntw in cands if key == best]


def _i8_steps(k: int):
    """The step widths of K, widest first: K padded to 32 cut into 1, 2, 3,
    ... equal steps of whole k32 steps, at most ``I8_MAX_KC`` columns."""
    kp = _up(k, I8_DEPTH)
    out = []
    for nch in range(1, kp // I8_DEPTH + 1):
        kc = _up(-(-kp // nch), I8_DEPTH)
        if kc <= I8_MAX_KC and -(-kp // kc) == nch and kc not in out:
            out.append(kc)
    return out


@functools.lru_cache(maxsize=None)
def i8_dot_plan(m: int, k: int, n: int, f32: bool = False,
                q8_out: bool = False) -> I8DotPlan:
    """The kernel plan of ``affine_dot_i8`` at these shapes (a function of
    them alone; ``m`` is taken for the signature's sake: the tiling does
    not depend on it): x of float32 (``f32``) or bf16, out int8 codes
    (``q8_out``) or x's type. The weight rows resident before streamed;
    within two blocks an SM (``buf_ops.SMEM_PAIR``, with steps of at least
    ``I8_PAIR_KC`` columns or K whole) before one (``SMEM_LIMIT``); the
    widest step of ``_i8_steps`` (K whole where it
    fits); the warps of ``_i8_dot_tilings`` in their order (at N = 128,
    64-row tiles, else 32 where their smaller x buffers fit two blocks an
    SM); the deepest ring of ``I8_STAGES``. (Steps of at most 128 columns
    were 10-20 % slower at K = 160 ... 320, one block an SM at K = 320
    slower than 32-row tiles two an SM: PERF.md section 6.) Cached:
    a forward asks for the same few shapes hundreds of times."""
    esz = 4 if f32 else 2
    osz = 1 if q8_out else esz
    for resident in (True, False):
        for limit in (SMEM_PAIR, SMEM_LIMIT):
            for kc in _i8_steps(k):
                if limit == SMEM_PAIR and kc < min(_up(k, I8_DEPTH),
                                                   I8_PAIR_KC):
                    continue
                for bm, ntw in _i8_dot_tilings(n):
                    for stages in I8_STAGES:
                        p = _i8_dot_layout(bm, ntw, k, n, esz, osz, kc,
                                           stages, resident)
                        if p.smem <= limit:
                            return p
    raise ValueError(f"affine_dot_i8: no plan of K={k}, N={n} fits "
                     f"{SMEM_LIMIT} bytes of shared memory")


@dataclasses.dataclass(frozen=True)
class I8ConvPlan:
    """How ``conv3x3_i8``'s kernel cuts an (m, Cb) -> (m, G) conv over
    images of width w: tiles of ``bm`` output rows, each computed by 8
    warps of 32 rows, of which ``row_warps`` split the rows and
    ``k_warps`` the depth 9 * ``cbp`` (Cb padded to 32); G in ``ngrp``
    groups of ``nt`` n8 tiles. Shared memory (byte offsets): the group's
    weight image (8 nt rows of 9 cbp + 16) at ``w_off``, a zero row at
    ``zero_off``, ``stages`` halo buffers of ``stage_bytes`` from
    ``stage_off`` (``halo_rows`` rows of cbp + 16; after the products a
    depth split's int32 partials), the warps' output stages at
    ``out_off``; ``smem`` bytes in all."""
    bm: int
    cbp: int
    nt: int
    ngrp: int
    stages: int
    halo_rows: int
    w_off: int
    zero_off: int
    stage_off: int
    stage_bytes: int
    out_off: int
    smem: int

    @property
    def row_warps(self) -> int:
        return self.bm // I8_WARP_ROWS

    @property
    def k_warps(self) -> int:
        return I8_WARPS // self.row_warps

    def tiles(self, m: int) -> int:
        return -(-m // self.bm)

    def items(self, m: int) -> int:
        return self.tiles(m) * self.ngrp

    def k_range(self, wk: int) -> range:
        """The k32 steps (tap-major, ``cbp // 32`` a tap) of depth warp
        ``wk``, out of ``9 * cbp // 32``."""
        steps = 9 * self.cbp // I8_DEPTH
        return range(wk * steps // self.k_warps,
                     (wk + 1) * steps // self.k_warps)

    def args(self):
        """The plan's fields in the C entry's order."""
        return (self.bm, self.cbp, self.nt, self.ngrp, self.stages,
                self.w_off, self.zero_off, self.stage_off, self.stage_bytes,
                self.out_off)


def _i8_conv_layout(bm, cbp, nt, g, w, stages, osz):
    halo_rows = bm + 2 * w + 2
    zero_off = _up(8 * nt * (9 * cbp + 16), 128)
    stage_off = zero_off + _up(cbp, 128)
    partials = (I8_WARPS // (bm // I8_WARP_ROWS) - 1) * bm * (8 * nt + 4) * 4
    stage_bytes = _up(max(halo_rows * (cbp + 16), partials), 128)
    out_off = stage_off + stages * stage_bytes
    return I8ConvPlan(bm=bm, cbp=cbp, nt=nt, ngrp=-(-g // (8 * nt)),
                      stages=stages, halo_rows=halo_rows, w_off=0,
                      zero_off=zero_off, stage_off=stage_off,
                      stage_bytes=stage_bytes, out_off=out_off,
                      smem=out_off + I8_WARPS * 16 * (8 * nt * osz + 16))


@functools.lru_cache(maxsize=None)
def i8_conv_plan(m: int, h: int, w: int, cb: int, g: int,
                 f32: bool = False) -> I8ConvPlan:
    """The kernel plan of ``conv3x3_i8`` at these shapes (a function of
    them alone), out bf16 or float32 (``f32``): n8 tiles a warp the
    fewest of ``I8_CONV_NT`` that hold G (else 8, in column groups); the
    largest row tile of ``I8_CONV_ROWS`` that still gives
    ``I8_CONV_TILES`` tiles (else 32), else the next smaller; for each,
    two blocks an SM (``buf_ops.SMEM_PAIR``) before one (``SMEM_LIMIT``),
    two halo buffers before one. (At r=64 two blocks of one buffer beat
    one block of two by 20-25 % at batch 64 and 256: PERF.md section
    6.)"""
    cbp = _up(cb, I8_DEPTH)
    nt = next((t for t in I8_CONV_NT if 8 * t >= g), I8_CONV_NT[-1])
    bm0 = next((bm for bm in I8_CONV_ROWS if -(-m // bm) >= I8_CONV_TILES),
               I8_CONV_ROWS[-1])
    for bm in (b for b in I8_CONV_ROWS if b <= bm0):
        for limit in (SMEM_PAIR, SMEM_LIMIT):
            for stages in (2, 1):
                p = _i8_conv_layout(bm, cbp, nt, g, w, stages,
                                    4 if f32 else 2)
                if p.smem <= limit:
                    return p
    raise ValueError(f"conv3x3_i8: no tiling of Cb={cb}, G={g}, W={w} fits "
                     f"{SMEM_LIMIT} bytes of shared memory")


def _check_wt(wt, rows, k, name, exact=False):
    """A K-major int8 image on the card: ``rows`` rows of at least (with
    ``exact``: of) K bytes padded to 32, contiguous, 16-byte aligned."""
    _check_i8(wt, name)
    kp = _up(k, I8_DEPTH)
    if not wt.is_contiguous() or wt.shape[0] != rows \
            or wt.shape[1] < kp or (exact and wt.shape[1] != kp) \
            or wt.shape[1] % 16 or wt.data_ptr() % 16:
        raise ValueError(f"{name} must be the contiguous K-major image of "
                         f"{rows} rows of >= {_up(k, I8_DEPTH)} bytes "
                         f"(pack_w_i8 / pack_w3_i8), got "
                         f"{tuple(wt.shape)}")


# ---------------------------------------------------------------------------
# affine_dot_i8
# ---------------------------------------------------------------------------


def affine_dot_i8_plain(x, vec, w_i8, out, s, vec2=None, wt=None):
    k = x.shape[1]
    codes = q8(torch.relu(tile_affine(x, vec)), s)
    y = int_dot(codes, w_i8[:k]).float() * (1.0 / s)
    if vec2 is not None:
        out.copy_(q8(torch.relu(y * vec2[0] + vec2[1]), s))
    else:
        out.copy_(y.view(out.shape).to(out.dtype))
    return out


def affine_dot_i8(x, vec, w_i8, out, *, s: float, vec2=None, wt=None):
    """``out = epi(q8(relu(x * vec[0] + vec[1])) @ w_i8[:K] / s)`` for x
    (M, K).

    The int8 BN-fold + ReLU + quantize + 1x1 conv of every bottleneck,
    adapter and head of the quantized model. ``vec`` is the (2, >=K)
    float32 [inv; shift] of an eval BN, ``w_i8`` the (>=K, N) int8 weight
    ({-1, 0, +1} after ``quant_eval_params``), ``s`` the quantizer scale
    2^(bits_i-1), ``wt`` its K-major image (``pack_w_i8``, made once when
    the slots are marshalled; packed here when not given). Without
    ``vec2`` the dequantized float32 product goes to ``out`` (an (M, N) or
    image-major (B, P, N) view in x's dtype: rounded once to bf16, or kept
    at float32). With ``vec2`` ((2, N) float32 [inv2; shift2], BN2 of a
    dense layer) the epilogue is ``q8(relu(y * inv2 + shift2))`` and
    ``out`` is an (M, N) int8 tensor: the 3x3 conv's input codes, from a
    float32 ``y`` that is never rounded to bf16 (as in the TPU kernel).

    Replaces ``cunet_tpu/kernels/fused_model_buf.py::_affine_dot_i8`` and
    ``_q8``. Bound on the H100 by reading x and writing out (K <= 320, N
    <= 128), not by the int8 tensor cores. Design (``csrc/i8_kernels.cu``,
    plan ``i8_dot_plan``): persistent blocks keep one column group's
    weight rows (the K-major image, by 16-byte cp.async) and the four BN
    vectors in shared memory; x's rows stream by 16-byte cp.async through
    a ring two or three steps deep, each landed step quantized once an
    element into the int8 A operand while the next steps' bytes are in
    flight; mma.sync m16n8k32 s8 through ldmatrix with int32
    accumulators; the epilogue (1/s, BN2, ReLU, q8, or the bf16 rounding)
    in registers, packed per warp and stored as 16-byte rows. Where the
    weight fits beside no ring (K past ~1,500 at N = 128) it streams by K
    chunk through the ring instead. Float32 x (the float32 model): two
    16-byte copies a vector of 8, the same code from the load on.
    """
    m, k = x.shape
    n = w_i8.shape[1]
    rows = _rows(out)[0]
    if rows != m or out.shape[-1] != n or w_i8.shape[0] < k \
            or (vec2 is not None and (out.dim() != 2 or vec2.shape != (2, n))):
        raise ValueError(f"affine_dot_i8 shapes: x {tuple(x.shape)}, vec "
                         f"{tuple(vec.shape)}, w {tuple(w_i8.shape)}, out "
                         f"{tuple(out.shape)}, vec2 "
                         f"{None if vec2 is None else tuple(vec2.shape)}")
    if vec.dim() != 2 or vec.shape[0] != 2 or vec.shape[1] < k:
        raise ValueError(f"vec must be one eval (2, >={k}) [inv; shift], got "
                         f"{tuple(vec.shape)}")
    if x.device.type == "cpu":
        return affine_dot_i8_plain(x, vec, w_i8, out, s, vec2)
    _check_view(x, "x", (BF16, F32))
    f32 = x.dtype == F32
    _check_i8(w_i8, "w")
    _check_vec(vec, "vec", k)
    _check_rows(m)
    inv2 = shift2 = 0
    if vec2 is None:
        _check_view(out, "out", (x.dtype,))
    else:
        _check_i8(out, "out")
        _check_vec(vec2, "vec2", n)
        inv2, shift2 = vec2[0].data_ptr(), vec2[1].data_ptr()
    if wt is None:
        wt = pack_w_i8(w_i8)
    _check_wt(wt, n, k, "wt")
    _, rows_per_img, img_stride, ldo = _rows(out)
    p = i8_dot_plan(m, k, n, f32, vec2 is not None)
    code = build.lib().cunet_affine_dot_i8(
        x.data_ptr(), x.stride(0), m, k, vec[0].data_ptr(), vec[1].data_ptr(),
        wt.data_ptr(), wt.stride(0), n, s, inv2, shift2,
        out.data_ptr(), ldo, rows_per_img, img_stride, int(f32), *p.args(),
        _stream(x))
    build.check(code, "affine_dot_i8")
    affine_dot_i8.launches += 1
    affine_dot_i8.f32_launches += f32
    return out


# ---------------------------------------------------------------------------
# conv3x3_i8
# ---------------------------------------------------------------------------


def conv3x3_i8_plain(y_i8, w3_i8, b, h, w, out, s, wt=None):
    c, g = y_i8.shape[1], w3_i8.shape[1]
    yp = torch.nn.functional.pad(y_i8.reshape(b, h, w, c),
                                 (0, 0, 1, 1, 1, 1))
    acc = None
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        rows = yp[:, dy:dy + h, dx:dx + w].reshape(b * h * w, c)
        part = int_dot(rows, w3_i8[tap * c:(tap + 1) * c])
        acc = part if acc is None else acc + part
    out.copy_((acc.float() * (1.0 / s)).to(out.dtype))
    return out


def conv3x3_i8(y_i8, w3_i8, b, h, w, out, *, s: float, wt=None):
    """3x3 SAME conv of the int8 codes ``y_i8`` (b*h*w, Cb) with the int8
    weight ``w3_i8`` ((9*Cb, G), ``buf_ops.pack_w3`` layout; ``wt`` its
    K-major image ``pack_w3_i8``, made once when the slots are marshalled,
    packed here when not given), int32 accumulation, zero padding per
    image, dequantized by 1/s into ``out`` (b*h*w, G) (bf16 or float32 on
    the card, the model's dtype).

    Replaces the int8 scatter conv of
    ``cunet_tpu/kernels/fused_model_buf.py`` (:316-329, weights packed by
    ``fused_hourglass.py::pack_w3_scatter``): there one (m, Cb) @ (Cb, 9G)
    int8 dot and nine shifted f32 adds of dequantized taps; here one
    implicit GEMM of depth 9*Cb with int32 accumulation (the same sum,
    exact in both). Bound on the H100 by bytes (1.9 us at r=64, batch 8).
    Design (``csrc/i8_kernels.cu``, plan ``i8_conv_plan``): persistent
    blocks keep the weight image (36 KB at Cb=128 -> G=32) in shared
    memory; a tile of up to 256 output rows stages one halo of its rows
    plus an image row and a pixel either side by 16-byte cp.async (byte
    loads where the rows are not 16-byte aligned), two buffers deep, and
    the nine taps read it at fixed row offsets, out-of-image rows pointed
    at a zero row; mma.sync m16n8k32 s8 through ldmatrix; at small M the
    warps split the depth and add their int32 partials; the epilogue in
    registers, stored as 16-byte rows into the out32 slice.
    """
    m, c = y_i8.shape
    g = w3_i8.shape[1]
    if m != b * h * w or w3_i8.shape[0] != 9 * c \
            or tuple(out.shape) != (m, g):
        raise ValueError(f"conv3x3_i8 shapes: y {tuple(y_i8.shape)}, w "
                         f"{tuple(w3_i8.shape)}, out {tuple(out.shape)}, "
                         f"image {b}x{h}x{w}")
    if y_i8.device.type == "cpu":
        return conv3x3_i8_plain(y_i8, w3_i8, b, h, w, out, s)
    _check_i8(y_i8, "y")
    _check_i8(w3_i8, "w3")
    _check_view(out, "out", (BF16, F32))
    _check_rows(m)
    f32 = out.dtype == F32
    if wt is None:
        wt = pack_w3_i8(w3_i8)
    _check_wt(wt, g, 9 * _up(c, I8_DEPTH), "wt", exact=True)
    p = i8_conv_plan(m, h, w, c, g, f32)
    vec16 = y_i8.data_ptr() % 16 == 0 and y_i8.stride(0) % 16 == 0
    code = build.lib().cunet_conv3x3_i8(
        y_i8.data_ptr(), y_i8.stride(0), m, h, w, c, wt.data_ptr(), g, s,
        out.data_ptr(), out.stride(0), int(f32), *p.args(), int(vec16),
        p.smem, _stream(y_i8))
    build.check(code, "conv3x3_i8")
    conv3x3_i8.launches += 1
    conv3x3_i8.f32_launches += f32
    return out


KERNELS = (affine_dot_i8, conv3x3_i8, int8_matmul_dequant)
PLAIN = {affine_dot_i8: affine_dot_i8_plain, conv3x3_i8: conv3x3_i8_plain,
         int8_matmul_dequant: int8_matmul_dequant_plain}


# the wrappers with a float32 form
F32_FORMS = (affine_dot_i8, conv3x3_i8)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    for k in F32_FORMS:
        k.f32_launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def f32_counts() -> dict:
    """Launches of the float32 forms, keyed ``name[f32]``."""
    return {f"{k.__name__}[f32]": k.f32_launches for k in F32_FORMS}


reset_launch_counts()
