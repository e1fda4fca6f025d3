"""The four Hopper kernels of the forward, each beside its plain version.

Every wrapper takes strided 2-D views into the channel-plane buffers of
:mod:`cunet_tpu_torch.kernels.model_buf` (eval) and
:mod:`cunet_tpu_torch.kernels.train_slot` (train; ``affine_dot`` and
``conv3x3`` then take per-tile ghost-BN vectors) (row stride free, unit
column stride) and writes its result into the ``out`` view it is given, in
place.
On a CPU tensor a wrapper computes the plain PyTorch version; on a CUDA
tensor it launches the kernel or raises. ``<wrapper>.launches`` counts the
kernel launches and nothing else; ``<wrapper>.option_launches`` those of
them with the QuanInput option on (``option_counts``).

All four are bound on the H100 by memory traffic, not by the tensor cores:
a 1x1 of K=192 -> 128 does about 77 flop per byte of x read and out
written (K=320 -> 128 about 91), against the card's ~295 bf16 flop per
byte, and the 3x3 conv emits only G=32 channels. So the designs below
spend their effort on touching each byte once: 16-byte vector accesses,
the BN prologue and epilogue applied in registers on the way through, and
outputs written straight into the buffer slot the next stage reads (no
concat, no staging copy).

Each wrapper also takes float32 operands (an f32 model's eval and its
ghost-BN training): the pool and the upsample move 4-float vectors;
``affine_dot`` and ``conv3x3`` run the float32 product kernel of
``csrc/f32_kernels.cu`` (``launch_dot3``, plans ``dot3_plan`` /
``conv3x3_plan_f32``), float32-accurate on the tensor cores through the
exact three-way bf16 split of both operands, with eval vectors or per-tile
ghost-BN ones, and with QuanInput's ``bits_i`` (the quantized model's
float32 training) on the unrounded float32 prologue value.
``<wrapper>.f32_launches`` counts those launches (also in ``launches``),
``<wrapper>.f32_option_launches`` those with the option on (also in
``option_launches``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from cunet_tpu_torch.kernels import build
from cunet_tpu_torch.quant.wage import clip_c, quant_q


# ---------------------------------------------------------------------------
# argument checks for the CUDA path
# ---------------------------------------------------------------------------


BF16, F32 = torch.bfloat16, torch.float32


def _check_view(t: torch.Tensor, name: str, dtypes=(BF16,),
                width_mult=8) -> None:
    """A kernel operand: on the current CUDA device, of one of ``dtypes``
    (bf16, or float32 where the wrapper has a float32 form), unit column
    stride, a width that is a multiple of ``width_mult`` elements (None:
    of 16 bytes), row strides and the base pointer on 16-byte bounds (every
    access is one 16-byte vector: 8 bf16 or 4 floats)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}, expected a CUDA tensor")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name} is on {t.device}, not the current device "
                         f"cuda:{torch.cuda.current_device()}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes "
                        f"{' or '.join(str(d) for d in dtypes)}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} needs unit column stride, got {t.stride()}")
    e = t.element_size()
    mult = 16 // e if width_mult is None else width_mult
    if t.shape[-1] % mult or any(s * e % 16 for s in t.stride()[:-1]):
        raise ValueError(f"{name}: width {t.shape[-1]} must be a multiple "
                         f"of {mult} and row strides {t.stride()[:-1]} of "
                         f"16 bytes")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def _check_dtypes(ref: torch.Tensor, **tensors) -> None:
    """Every one of ``tensors`` (name=tensor) in ``ref``'s dtype: a kernel
    takes one element type, and no operand is cast on the way in."""
    for name, t in tensors.items():
        if t is not None and t.dtype != ref.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, the others "
                            f"{ref.dtype}")


def _check_rows(m: int) -> None:
    """The tensor-core kernels index rows with 32-bit integers."""
    if m >= 2 ** 31:
        raise ValueError(f"{m} rows: the kernels take fewer than 2^31")


def _check_vec(t: torch.Tensor, name: str, width: int) -> None:
    if t.device.type != "cuda" or t.dtype != torch.float32 \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 CUDA tensor")
    if t.shape[-1] < width:
        raise ValueError(f"{name} has {t.shape[-1]} columns, needs {width}")


def pad_cols(w: torch.Tensor, mult: int = 8) -> torch.Tensor:
    """``w`` with zero columns appended up to a multiple of ``mult``: every
    kernel operand of this module moves 8-wide vectors, so a head of 68
    classes (the 300-W face model) runs on a (C, 72) weight into a 72-wide
    output whose first 68 columns are the heatmaps. ``w`` itself when its
    width is a multiple already."""
    extra = -w.shape[-1] % mult
    return F.pad(w, (0, extra)) if extra else w


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _rows(out: torch.Tensor):
    """(rows, rows_per_img, img_stride, ld) of a 2-D (M, N) or an image-major
    3-D (B, P, N) output view."""
    if out.dim() == 2:
        return out.shape[0], out.shape[0], 0, out.stride(0)
    if out.dim() == 3:
        return out.shape[0] * out.shape[1], out.shape[1], out.stride(0), \
            out.stride(1)
    raise ValueError(f"out must be 2-D or 3-D, got shape {tuple(out.shape)}")


# ---------------------------------------------------------------------------
# K1 affine_dot
# ---------------------------------------------------------------------------


def tile_affine(x, vec):
    """``x * inv + shift`` in float32 for x (M, K): ``vec`` is one (2, >=K)
    [inv; shift] pair, or (T, 2, >=K) pairs, one per group of M/T rows."""
    k = x.shape[1]
    if vec.dim() == 2:
        return x.float() * vec[0, :k] + vec[1, :k]
    t = vec.shape[0]
    xt = x.float().reshape(t, -1, k)
    return (xt * vec[:, 0, None, :k] + vec[:, 1, None, :k]).reshape(-1, k)


def _vec_args(vec, m, k):
    """(inv, shift pointers, per-tile element stride, rows per tile) of an
    eval (2, >=K) vector or per-tile (T, 2, >=K) vectors."""
    if vec.dim() == 2:
        return vec[0].data_ptr(), vec[1].data_ptr(), 0, m
    t = vec.shape[0]
    if m % t:
        raise ValueError(f"{m} rows do not split into {t} BN tiles")
    return vec[0, 0].data_ptr(), vec[0, 1].data_ptr(), vec.stride(0), m // t


def _check_bits(bits_i: int) -> None:
    if not 0 <= bits_i <= 15:
        raise ValueError(f"bits_i must be 0 (off) or 1..15, got {bits_i}")


def quantize_act(z, bits_i: int):
    """QuanInput's quantizer ``Q(C(z, bits_i), bits_i)`` on an activation
    ``z`` (computed in float32, rounded back to z's dtype: exact for
    bits_i <= 8); ``bits_i == 0`` is the identity. The plain version of the
    kernels' ``quan``."""
    if not bits_i:
        return z
    return quant_q(clip_c(z.float(), bits_i), bits_i).to(z.dtype)


def _check_tile_vec(vec, k, m, what="vec"):
    if vec.dim() not in (2, 3) or vec.shape[-2] != 2 or vec.shape[-1] < k:
        raise ValueError(f"{what} must be (2, >={k}) or (T, 2, >={k}), got "
                         f"{tuple(vec.shape)}")
    if vec.dim() == 3 and m % vec.shape[0]:
        raise ValueError(f"{m} rows do not split into {vec.shape[0]} tiles")


def affine_dot_plain(x, vec, w, out, bias=None, bits_i=0, scale=None):
    """With ``bias`` the epilogue ``relu(acc + bias)``, and with ``scale``
    too ``relu(acc * scale + bias)`` (BN2's full affine, float32)."""
    k = x.shape[1]
    y = quantize_act(torch.relu(tile_affine(x, vec)).to(x.dtype), bits_i)
    acc = y.float() @ w[:k].float()
    if bias is not None:
        acc = torch.relu((acc if scale is None else acc * scale) + bias)
    out.copy_(acc.view(out.shape).to(out.dtype))
    return out


# Shared memory one block may hold on the H100 (227 KB).
SMEM_LIMIT = 232_448
# affine_dot: warps of a block and rows a warp owns (csrc/buf_kernels.cu,
# kThreads / 32 and two m16 tiles), and the items (row tile, column group)
# its plan aims at before it takes a smaller row tile or splits N: about
# one per SM of the card's 132, a constant, so the plan depends on the
# shapes alone
DOT_WARPS = 8
DOT_WARP_ROWS = 32
DOT_ITEMS = 132
DOT_MAX_NTW = 8     # n8 column tiles a warp (the kernel's instantiations)
# Two blocks on one SM: each within half the H100's 228 KB of shared
# memory (less the 1 KB the card keeps for each block) and at most four
# n8 tiles a warp (<= 128 registers a thread), so that one block's loads,
# prologue and epilogue run under the other's products
SMEM_PAIR = 115_712
PAIR_NTW = 4


@dataclasses.dataclass(frozen=True)
class DotPlan:
    """How ``affine_dot``'s kernel cuts an (m, K) -> (m, N) product: row
    tiles of ``bm`` rows (``row_warps`` warps of ``DOT_WARP_ROWS`` rows),
    N in ``ngrp`` groups of ``ncol`` columns (``col_warps`` warps of
    ``ntw`` n8 tiles; columns past N are zero weights and are not stored),
    K zero-padded to ``kp``; the weight group resident (``w_bytes``), x
    tiles in ``stages`` buffers of ``stage_bytes`` (rows at a stride of
    kp + 8), then the warps' 16-row output stages at ``out_off``; ``smem``
    bytes in all."""
    bm: int
    ncol: int
    ngrp: int
    ntw: int
    kp: int
    stages: int
    w_bytes: int
    stage_bytes: int
    out_off: int
    smem: int

    @property
    def row_warps(self) -> int:
        return self.bm // DOT_WARP_ROWS

    @property
    def col_warps(self) -> int:
        return DOT_WARPS // self.row_warps

    def tiles(self, m: int) -> int:
        return -(-m // self.bm)

    def items(self, m: int) -> int:
        return self.tiles(m) * self.ngrp


def _dot_layout(bm, k, n, split, stages=(3, 2), limit=SMEM_LIMIT):
    """The layout of row tiles of ``bm`` and N cut into ``split`` groups,
    the first count of x buffers of ``stages`` that fits in ``limit``
    bytes; None where none does."""
    wn = DOT_WARPS // (bm // DOT_WARP_ROWS)
    ncol = _up(-(-n // split), 8 * wn)
    ntw = ncol // (8 * wn)
    if ntw > DOT_MAX_NTW:
        return None
    kp = _up(k, 16)
    w_bytes = _up(kp * ncol * 2, 128)
    stage_bytes = _up(bm * (kp + 8) * 2, 128)
    out_bytes = DOT_WARPS * 16 * (ntw * 8 + 8) * 2
    for s in stages:
        out_off = w_bytes + s * stage_bytes
        if out_off + out_bytes <= limit:
            return DotPlan(bm=bm, ncol=ncol, ngrp=-(-n // ncol), ntw=ntw,
                           kp=kp, stages=s, w_bytes=w_bytes,
                           stage_bytes=stage_bytes, out_off=out_off,
                           smem=out_off + out_bytes)
    return None


def _pair(p) -> bool:
    return p.smem <= SMEM_PAIR and p.ntw <= PAIR_NTW


# The float32 products (csrc/f32_kernels.cu, dot3_kernel): 128-row tiles
# (BM) over column tiles of 16, 32, 64 or 128, K streamed in chunks of 32,
# each chunk's operands held as three bf16 planes per output at a row
# padding of 8 elements, 8 warps with a 16x16 float32 stage each. The conv
# splits K across blocks where its tiles are fewer than about one per SM
# (a constant: the plan depends on the shapes alone), at most one split a
# tap and at least two chunks a split.
DOT3_ROWS = 128
DOT3_DEPTH = 32
DOT3_COLS = (16, 32, 64, 128)
DOT3_ITEMS = 132
DOT3_MAX_SPLITS = 9


@dataclasses.dataclass(frozen=True)
class Dot3Plan:
    """How the float32 product kernel cuts an (m, K) -> (m, N) product
    (``nout`` outputs, the first stored 2x2-pooled with ``pool``; or a 3x3
    conv, ``nout`` 1): one block a tile of ``bm`` rows by ``bn`` columns,
    K in chunks of ``bk`` (no weight resident: any K fits), ``smem`` bytes
    of shared memory (the chunk's A and W planes, or the pooled float32
    output tile, whichever is larger, then the warps' stages)."""
    bn: int
    nout: int
    pool: bool
    smem: int
    bm: int = DOT3_ROWS
    bk: int = DOT3_DEPTH
    splits: int = 1

    def grid(self, m: int, n: int):
        return -(-m // self.bm), -(-n // self.bn)

    def k_chunks(self, k: int):
        """The chunks of K each split sums (the kernel's ``k_beg`` ..
        ``k_end``), in the order the last block adds the partials."""
        nch = -(-k // self.bk)
        return [range(s * nch // self.splits, (s + 1) * nch // self.splits)
                for s in range(self.splits)]


@functools.lru_cache(maxsize=None)
def dot3_plan(n: int, nout: int = 1, pool: bool = False) -> Dot3Plan:
    """The float32 product kernel's plan for N output columns (a function
    of the shapes alone: M and K change only the grid and the chunk count).
    The narrowest column tile of 16, 32, 64, 128 that holds N, else 128;
    its shared memory is ``csrc/f32_kernels.cu::Smem3``'s, which the kernel
    checks."""
    bn = next((b for b in DOT3_COLS if n <= b), DOT3_COLS[-1])
    planes = nout * 3 * 2 * (DOT3_ROWS * (DOT3_DEPTH + 8)
                             + DOT3_DEPTH * (bn + 8))
    out_tile = DOT3_ROWS * (bn + 4) * 4 if pool else 0
    smem = _up(max(planes, out_tile), 128) + DOT_WARPS * 16 * 16 * 4
    return Dot3Plan(bn=bn, nout=nout, pool=pool, smem=smem)


# Feature groups a launch carries in its parameters (csrc/common.cuh
# kMaxGroups); a longer table goes through device memory (``group_table``),
# one int64 row of GROUP_COLS a group.
INLINE_GROUPS = 16
GROUP_COLS = 4


def group_table(feats):
    """Device memory for the table of ``feats`` where it has more groups
    than a launch carries (an up block's adapter at ``order`` >= 14 reads
    ``order + 3``), filled on the stream by the entry point; None where
    the table travels in the launch parameters. Held by the caller until
    the launch is queued."""
    if len(feats) <= INLINE_GROUPS:
        return None
    return torch.empty(len(feats) * GROUP_COLS, dtype=torch.int64,
                       device=feats[0].device)


def table_args(feats, m, vec, w, out, *, bias=None, vec2=None, vec_s=None,
               w_s=None, out_s=None, up=(), ext=None, hw=(0, 0), pool=False):
    """The arguments of ``cunet_table_dot`` and of its float32 form
    ``cunet_table_dot_f32`` (which takes its plan's column tile and shared
    memory after them), up to the stream: the feature table as ctypes
    arrays (``up`` a flag a group; ``ext`` the ``group_table`` of a table
    longer than ``INLINE_GROUPS``), the BN vectors, weights, epilogue
    (none, ``relu(. + bias)`` or ``relu(. * vec2[0] + vec2[1])``) and
    outputs, the dual form's second output with ``out_s``."""
    g, n, dual = len(feats), out.shape[-1], out_s is not None
    ups = tuple(up) or (False,) * g
    epi, ea, eb = 0, 0, 0
    if bias is not None:
        epi, eb = 1, bias.data_ptr()
    if vec2 is not None:
        epi, ea, eb = 2, vec2[0].data_ptr(), vec2[1].data_ptr()
    _, rows_per_img, img_stride, ldo = _rows(out)
    return ((ctypes.c_void_p * g)(*[f.data_ptr() for f in feats]),
            (ctypes.c_longlong * g)(*[f.stride(0) for f in feats]),
            (ctypes.c_int * g)(*[f.shape[1] for f in feats]), g,
            (ctypes.c_int * g)(*[int(u) for u in ups]),
            0 if ext is None else ext.data_ptr(), hw[0], hw[1], m, vec[0].data_ptr(), vec[1].data_ptr(),
            w.data_ptr(), vec_s[0].data_ptr() if dual else 0,
            vec_s[1].data_ptr() if dual else 0,
            w_s.data_ptr() if dual else 0, w.stride(0), n, epi, ea, eb,
            int(pool), out.data_ptr(), ldo, rows_per_img, img_stride,
            out_s.data_ptr() if dual else 0,
            out_s.stride(0) if dual else 0)


def launch_dot3(feats, m, vec, w, out, **kw):
    """Launch the float32 product (``cunet_table_dot_f32``) over the
    float32 views ``feats`` (checked by the caller; ``kw`` as
    ``table_args``, less ``ext``): the float32 form of
    ``eval_ops.table_dot`` and, with one group, of ``affine_dot``, and of
    #7's ``apply``, over any number of groups. Returns the launch's CUDA
    error code."""
    p = dot3_plan(out.shape[-1], 2 if kw.get("out_s") is not None else 1,
                  bool(kw.get("pool")))
    ext = group_table(feats)
    return build.lib().cunet_table_dot_f32(
        *table_args(feats, m, vec, w, out, ext=ext, **kw), p.bn, p.smem,
        _stream(feats[0]))


@functools.lru_cache(maxsize=None)
def affine_dot_plan(m: int, k: int, n: int) -> DotPlan:
    """The kernel plan of ``affine_dot`` at these shapes (a function of them
    alone). N in the fewest groups of at most 128 columns; the larger row
    tile of 128, 64 that gives ``DOT_ITEMS`` items with a layout of two x
    buffers that runs two blocks an SM (``SMEM_PAIR``: 64-row tiles at K
    <= 192, N = 128); else the largest of 128, 64, 32 whose layout fits
    alone, three buffers where they fit; else the same with N split in
    twice as many groups; else the plan of the most items. (A third buffer
    at one block an SM, 32-row tiles and N split were slower at r=64:
    ``tools/gemm_sweep.py``, PERF.md section 6.) Cached: a forward asks
    for the same few shapes hundreds of times, and the host's time per
    launch bounds the small-batch forward. (The float32 form's plan is
    ``dot3_plan``.)"""
    best = None
    groups = -(-n // 128)
    for split in (groups, 2 * groups):
        for limit, stages, tiles in ((SMEM_PAIR, (2,), (128, 64)),
                                     (SMEM_LIMIT, (3, 2), (128, 64, 32))):
            for bm in tiles:
                p = _dot_layout(bm, k, n, split, stages, limit)
                if p is None or (limit == SMEM_PAIR and not _pair(p)):
                    continue
                if p.items(m) >= DOT_ITEMS:
                    return p
                if best is None or p.items(m) > best.items(m):
                    best = p
    if best is None:
        raise ValueError(f"affine_dot: no tiling of K={k}, N={n} fits "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return best


def affine_dot(x, vec, w, out, *, bias=None, bits_i=0):
    """``out = epi(relu(x * vec[0] + vec[1]) @ w[:K])`` for x (M, K).

    The concat-free BN-fold + ReLU + 1x1 conv of every bottleneck, adapter,
    intermedia adapter and head. ``vec`` is the (2, >=K) f32 [inv; shift]
    of an eval BN; ``w`` the (>=K, N) weight, of which the first K rows are
    read (growth-phase slots read a prefix of the padded weight). ``epi`` is
    the identity, or ``relu(. + bias)`` for the bottleneck's folded BN2.
    ``out`` is an (M, N) view or an image-major (B, P, N) view with
    B*P == M (one slot of the stacked head output). With ``bits_i`` (1-15)
    the bf16 activation goes through QuanInput's quantizer
    (``quantize_act``) before the product: the quantized train head.

    Replaces ``cunet_tpu/kernels/fused_model_buf.py::_affine_dot`` and
    ``fused_hourglass.py::_bottleneck_val``, and with per-tile vectors
    ``train_slot.py::_norm_relu`` + ``_dot``. Bound on the H100 by reading
    x and writing out (K <= 320, N <= 128 is at most ~91 flop/byte).
    Design (``csrc/buf_kernels.cu``, plan ``affine_dot_plan``): persistent
    blocks keep one column group's weight prefix in shared memory (loaded
    once, by cp.async, under a 16-byte swizzle) and walk row tiles of up
    to 128 rows (64 on the main path, two blocks an SM) whose x rows
    arrive by cp.async one or two tiles ahead; the BN + ReLU prologue (and
    quantizer) runs once per element in shared memory from BN vectors
    kept in registers; mma.sync m16n8k16 through
    ldmatrix sums each output from zero in ascending 16-deep k steps, the
    order ``eval_ops.table_dot``'s WMMA takes, so the whole-model and
    per-slot paths agree bit for bit; the epilogue in f32 before one bf16
    rounding, staged per warp and written as 16-byte rows straight into
    the buffer slot. PERF.md section 6 has its times on the H100.

    Float32 x, w and out (an f32 model's eval and ghost-BN train forward)
    run the float32 product kernel with one feature group
    (``csrc/f32_kernels.cu``): the prologue unrounded, six bf16 plane
    products a k16 step, summed as ``eval_ops.table_dot``'s float32 form
    sums them. With per-tile vectors each row reads its own tile's [inv;
    shift] (a tile of 96 rows at r=4, tile 6, does not divide a 128-row
    block). With ``bits_i`` the quantizer takes the unrounded float32
    prologue value (no ``bias`` then), and for ``bits_i`` <= 9 its codes
    fill one bf16 plane, so three of the six plane products are skipped.
    """
    m, k = x.shape
    n = w.shape[1]
    rows = _rows(out)[0]
    if rows != m or out.shape[-1] != n or w.shape[0] < k:
        raise ValueError(f"affine_dot shapes: x {tuple(x.shape)}, vec "
                         f"{tuple(vec.shape)}, w {tuple(w.shape)}, out "
                         f"{tuple(out.shape)}")
    _check_tile_vec(vec, k, m)
    _check_bits(bits_i)
    if x.device.type == "cpu":
        return affine_dot_plain(x, vec, w, out, bias, bits_i)
    if x.dtype == F32:
        return _affine_dot_f32(x, vec, w, out, bias, bits_i)
    _check_view(x, "x")
    _check_view(out, "out")
    _check_view(w, "w")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")
    _check_vec(vec, "vec", k)
    if bias is not None:
        _check_vec(bias, "bias", n)
    _check_rows(m)
    _, rows_per_img, img_stride, ldo = _rows(out)
    inv, shift, vstride, tile_rows = _vec_args(vec, m, k)
    p = affine_dot_plan(m, k, n)
    code = build.lib().cunet_affine_dot(
        x.data_ptr(), x.stride(0), m, k, inv, shift, vstride, tile_rows,
        bits_i, w.data_ptr(), n, n, 0 if bias is None else bias.data_ptr(),
        out.data_ptr(), ldo, rows_per_img, img_stride, p.bm, p.ncol, p.ngrp,
        p.ntw, p.kp, p.stages, p.w_bytes, p.stage_bytes, p.out_off, p.smem,
        _stream(x))
    build.check(code, "affine_dot")
    affine_dot.launches += 1
    affine_dot.option_launches += bits_i > 0
    return out


def _affine_dot_f32(x, vec, w, out, bias, bits_i):
    """``affine_dot``'s float32 form: the float32 product kernel over the
    one group ``x`` (``csrc/f32_kernels.cu``): with an eval ``vec`` through
    ``launch_dot3``; with per-tile ghost-BN vectors (the f32 train forward,
    TPU kernel #8's ``_norm_relu`` + ``_dot``) or QuanInput's ``bits_i``
    (its ``_quan`` at the head) through ``cunet_affine_f32``, which reads
    each row's tile's vectors in its prologue."""
    for name, t in (("x", x), ("out", out), ("w", w)):
        _check_view(t, name, (F32,))
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")
    _check_vec(vec, "vec", x.shape[1])
    if bias is not None:
        _check_vec(bias, "bias", w.shape[1])
    m = x.shape[0]
    _check_rows(m)
    if vec.dim() == 2 and not bits_i:
        code = launch_dot3([x], m, vec, w, out, bias=bias)
    else:
        if bias is not None:
            raise ValueError("affine_dot at float32: no bias with per-tile "
                             "vectors or bits_i")
        inv, shift, vstride, tile_rows = _vec_args(vec, m, x.shape[1])
        code = launch_affine_f32(x, inv, shift, vstride, tile_rows, w, out,
                                 bits_i=bits_i)
    build.check(code, "affine_dot (float32)")
    affine_dot.launches += 1
    affine_dot.f32_launches += 1
    affine_dot.option_launches += bits_i > 0
    affine_dot.f32_option_launches += bits_i > 0
    return out


def launch_affine_f32(x, inv, shift, vstride, tile_rows, w, out, gate=None,
                      bits_i=0, ste=False):
    """Launch ``cunet_affine_f32`` (checked by the caller): the float32
    product ``x @ w[:K]`` of one group with a per-tile prologue (``inv``,
    ``shift`` pointers as ``_vec_args`` gives them; with ``bits_i``
    QuanInput's quantizer after it), or, with ``gate`` = (gx, gate_inv,
    gate_shift) and no prologue (``inv`` 0), gated by the backward's ReLU
    mask of the stage input gx (with ``ste`` QuanInput's straight-through
    gate too). Returns the CUDA error code."""
    m, k = x.shape
    n = w.shape[1]
    p = dot3_plan(n)
    gx, ginv, gshift = gate if gate is not None else (None, 0, 0)
    _, rows_per_img, img_stride, ldo = _rows(out)
    return build.lib().cunet_affine_f32(
        x.data_ptr(), x.stride(0), m, k, inv, shift, vstride, tile_rows,
        w.data_ptr(), w.stride(0), n, 0 if gx is None else gx.data_ptr(),
        0 if gx is None else gx.stride(0), ginv, gshift, out.data_ptr(), ldo,
        rows_per_img, img_stride, bits_i, int(ste), p.bn, p.smem, _stream(x))


# ---------------------------------------------------------------------------
# K2 conv3x3
# ---------------------------------------------------------------------------


def pack_w3(w3: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, Cb, G) -> (9*Cb, G): the implicit GEMM's tap-major rows."""
    return w3.reshape(9 * w3.shape[2], w3.shape[3]).contiguous()


def conv3x3_plain(y, w3p, b, h, w, out, vec=None, bits_i=0):
    c, g = y.shape[1], w3p.shape[1]
    if vec is not None:
        y = quantize_act(torch.relu(tile_affine(y, vec)).to(y.dtype), bits_i)
    x4 = y.reshape(b, h, w, c).permute(0, 3, 1, 2).float()
    wt = w3p.view(3, 3, c, g).permute(3, 2, 0, 1).float()
    o = F.conv2d(x4, wt, padding=1)
    out.copy_(o.permute(0, 2, 3, 1).reshape(b * h * w, g).to(out.dtype))
    return out


# The tile count conv3x3 aims for before it takes a smaller row tile: about
# one tile per SM of the card's 132, a constant, so the plan (and the order
# of every sum) depends on the shapes alone.
CONV_TILES = 128
# conv3x3's block: warps, and output rows a warp owns (csrc/buf_kernels.cu
# kConvWarps, kConvMT * 16)
CONV_WARPS = 12
CONV_WARP_ROWS = 32


def _up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How ``conv3x3``'s kernel cuts an (m, Cb) -> (m, G) conv over images
    of width w: tiles of ``bm`` output rows, each computed by
    ``CONV_WARPS`` warps of ``CONV_WARP_ROWS`` rows, of which
    ``row_warps`` split the rows and ``k_warps`` the 9*Cb reduction; the
    channels (zero-padded to 16) in ``nchunk`` chunks of ``kc``; the
    outputs in ``ncol`` groups of ``nt * 8``; ``stages`` halo buffers of
    ``stage_bytes`` (a halo tile of ``halo_rows`` rows, later the warps'
    partial sums); the byte offsets of the zero row and the first stage
    after the weight slice; ``smem`` bytes in all."""
    bm: int
    kc: int
    nchunk: int
    nt: int
    ncol: int
    stages: int
    halo_rows: int
    zero_off: int
    stage_off: int
    stage_bytes: int
    smem: int

    @property
    def row_warps(self) -> int:
        return self.bm // CONV_WARP_ROWS

    @property
    def k_warps(self) -> int:
        return CONV_WARPS // self.row_warps

    def tiles(self, m: int) -> int:
        return -(-m // self.bm)

    def k_range(self, wk: int) -> range:
        """The k16 steps (tap-major, ``kc // 16`` per tap) of warp row
        ``wk`` of the reduction, out of ``9 * kc // 16``."""
        steps = 9 * self.kc // 16
        return range(wk * steps // self.k_warps,
                     (wk + 1) * steps // self.k_warps)


def _conv_layout(bm, kc, stages, nt, cbp, w) -> ConvPlan:
    gb = 8 * nt
    halo_rows = bm + 2 * w + 2
    w_bytes = 9 * kc * gb * 2
    zero_bytes = _up(2 * kc, 128)
    # the halo tile (rows padded by 16 bytes) or, after the product, the
    # f32 partial sums of every warp's rows (stride gb + 4)
    red_bytes = CONV_WARPS * CONV_WARP_ROWS * (gb + 4) * 4
    stage_bytes = _up(max(halo_rows * (kc + 8) * 2, red_bytes), 128)
    stage_off = w_bytes + zero_bytes
    return ConvPlan(bm=bm, kc=kc, nchunk=-(-cbp // kc), nt=nt, ncol=0,
                    stages=stages, halo_rows=halo_rows, zero_off=w_bytes,
                    stage_off=stage_off, stage_bytes=stage_bytes,
                    smem=stage_off + stages * stage_bytes)


@functools.lru_cache(maxsize=None)
def conv3x3_plan_f32(m: int, cb: int, g: int) -> Dot3Plan:
    """The float32 conv's plan at these shapes (a function of them alone):
    ``dot3_plan`` of G columns, its implicit GEMM's depth 9*Cb split across
    blocks where the tiles are fewer than ``DOT3_ITEMS`` (at most
    ``DOT3_MAX_SPLITS`` splits, at least two chunks a split)."""
    p = dot3_plan(g)
    gm, gn = p.grid(m, g)
    splits = min(DOT3_MAX_SPLITS, DOT3_ITEMS // (gm * gn),
                 -(-9 * cb // DOT3_DEPTH) // 2)
    return dataclasses.replace(p, splits=max(splits, 1))


def conv3x3_plan(m: int, h: int, w: int, cb: int, g: int) -> ConvPlan:
    """The kernel plan of ``conv3x3`` at these shapes (a function of them
    alone; the float32 form's is ``conv3x3_plan_f32``). The largest row
    tile of 128, 64, 32 that still gives ``CONV_TILES`` tiles (else 32),
    the whole weight resident (one chunk) and two halo stages where they
    fit in ``SMEM_LIMIT``; else one stage, a smaller tile, then smaller
    channel chunks."""
    cbp = _up(cb, 16)
    nt = min(-(-g // 8), 8)
    ncol = -(-g // (8 * nt))
    tiles = [bm for bm in (128, 64, 32)
             if CONV_WARP_ROWS <= bm <= CONV_WARPS * CONV_WARP_ROWS]
    bm0 = next((bm for bm in tiles if -(-m // bm) >= CONV_TILES), tiles[-1])
    for kc in range(min(cbp, 256), 0, -16):
        for stages in (2, 1):
            for bm in (b for b in tiles if b <= bm0):
                plan = _conv_layout(bm, kc, stages, nt, cbp, w)
                if plan.smem <= SMEM_LIMIT:
                    return dataclasses.replace(plan, ncol=ncol)
    raise ValueError(f"conv3x3: no tiling of Cb={cb}, G={g}, W={w} fits "
                     f"{SMEM_LIMIT} bytes of shared memory")


def conv3x3(y, w3p, b, h, w, out, *, vec=None, bits_i=0):
    """3x3 SAME conv of ``y`` (b*h*w, Cb) into ``out`` (b*h*w, G), f32
    accumulation, zero padding per image (flattened images never bleed into
    each other). ``w3p`` is ``pack_w3`` of the HWIO weight. With ``vec``
    ((T, 2, Cb) per-tile [inv; shift] of a ghost-BN train stage) the input
    rows first go through ``relu(y * inv + shift)`` in f32, rounded to
    bf16, so that relu(BN2(yb)) never lands in memory; the zero padding
    stays zero after that prologue; with ``bits_i`` (1-15, train only)
    the rounded value goes through QuanInput's quantizer too.

    Replaces ``cunet_tpu/kernels/fused_hourglass.py::_conv3x3`` (all four of
    its TPU forms: taps, onedot, scatter, dycol) and, with ``vec``,
    ``cunet_tpu/kernels/train_slot.py::_conv3x3_t``. Bound on the H100 by
    bytes: reading y and writing out (at Cb=128 -> G=32 the conv does ~230
    flop per byte, under the card's ~295 bf16 flop/byte). Design
    (``csrc/buf_kernels.cu``, plan ``conv3x3_plan``): persistent blocks
    hold the packed weight in shared memory (72 KB on the main path,
    loaded once per block) and walk tiles of up to 128 output rows; each
    tile's input is one halo tile (the rows plus one image row and pixel
    either side) loaded with cp.async while the previous tile computes,
    the prologue applied once per element as it lands; the nine taps read
    shifted windows of it through ldmatrix into mma.sync, with rows outside
    the image pointed at a zero row; at small M the warps split the 9*Cb
    reduction and add their sums in a fixed order. On an H100 80GB HBM3 at
    700 W (PERF.md section 6, PR 8): 17.1 us at r=64 batch 8 (bound 3.2,
    ``F.conv2d`` 25.0), 117 us at batch 64 (bound 25.1, ``F.conv2d`` 104;
    no single part of the tile's work dominates), 6.7-7.9 us at r <= 32
    batch 8, 65 us per tile at batch 24.

    Float32 y, w3p and out (an f32 model's eval, and with ``vec`` its
    ghost-BN train forward) run the float32 product kernel as an implicit
    GEMM of depth 9*Cb (``csrc/f32_kernels.cu``, plan
    ``conv3x3_plan_f32``), the BN2 prologue per row of the tap's source
    pixel (its image's tile), unrounded, then QuanInput's quantizer with
    ``bits_i`` (no bf16 rounding before it); K split across blocks where
    the output tiles are few, the partials added in a fixed order.
    """
    m, c = y.shape
    g = w3p.shape[1]
    if m != b * h * w or w3p.shape[0] != 9 * c or tuple(out.shape) != (m, g):
        raise ValueError(f"conv3x3 shapes: y {tuple(y.shape)}, w "
                         f"{tuple(w3p.shape)}, out {tuple(out.shape)}, "
                         f"image {b}x{h}x{w}")
    if vec is not None:
        _check_tile_vec(vec, c, m)
    _check_bits(bits_i)
    if bits_i and vec is None:
        raise ValueError("conv3x3 quantizes only with a BN prologue (vec)")
    if y.device.type == "cpu":
        return conv3x3_plain(y, w3p, b, h, w, out, vec, bits_i)
    if y.dtype == F32:
        return _conv3x3_f32(y, w3p, b, h, w, out, vec, bits_i)
    _check_view(y, "y")
    _check_view(out, "out")
    _check_view(w3p, "w3")
    if not w3p.is_contiguous():
        raise ValueError("w3 must be contiguous")
    _check_rows(m)
    inv = shift = vstride = 0
    tile_rows = m
    if vec is not None:
        _check_vec(vec, "vec", c)
        inv, shift, vstride, tile_rows = _vec_args(vec, m, c)
    p = conv3x3_plan(m, h, w, c, g)
    code = build.lib().cunet_conv3x3(
        y.data_ptr(), y.stride(0), m, h, w, c, w3p.data_ptr(), g, inv, shift,
        vstride, tile_rows, bits_i, out.data_ptr(), out.stride(0), p.bm,
        p.kc, p.nchunk, p.nt, p.ncol, p.stages, p.zero_off, p.stage_off,
        p.stage_bytes, p.smem, _stream(y))
    build.check(code, "conv3x3")
    conv3x3.launches += 1
    conv3x3.option_launches += bits_i > 0
    return out


def _conv3x3_f32(y, w3p, b, h, w, out, vec, bits_i):
    """``conv3x3``'s float32 form: the float32 product kernel's implicit
    GEMM (``csrc/f32_kernels.cu``), with the per-tile BN2 prologue of the
    ghost-BN train forward where ``vec`` is given (TPU kernel #8's
    ``_norm_relu`` + ``_conv3x3_t``; with ``bits_i`` its ``_quan``)."""
    for name, t in (("y", y), ("out", out), ("w3", w3p)):
        _check_view(t, name, (F32,))
    if not w3p.is_contiguous():
        raise ValueError("w3 must be contiguous")
    m, c = y.shape
    pro = (0, 0, 0, m)
    if vec is not None:
        _check_vec(vec, "vec", c)
        pro = _vec_args(vec, m, c)
    code = launch_conv3x3_f32(y, w3p, h, w, out, pro, bits_i=bits_i)
    build.check(code, "conv3x3 (float32)")
    conv3x3.launches += 1
    conv3x3.f32_launches += 1
    conv3x3.option_launches += bits_i > 0
    conv3x3.f32_option_launches += bits_i > 0
    return out


def launch_conv3x3_f32(y, w3p, h, w, out, pro=None, gate=None, bits_i=0,
                       ste=False):
    """Launch ``cunet_conv3x3_f32`` (checked by the caller) of y (M, C)
    through the packed (9C, N) ``w3p``: with ``pro`` = (inv, shift,
    vstride, tile_rows) as ``_vec_args`` gives them a BN prologue (inv 0:
    none), QuanInput's quantizer after it with ``bits_i``; with ``gate`` =
    (gx, gate_inv, gate_shift) the backward's ReLU mask of gx on the output
    (with ``ste`` the straight-through gate too). Returns the CUDA error
    code."""
    m, c = y.shape
    n = w3p.shape[1]
    _check_rows(m)
    inv, shift, vstride, tile_rows = pro if pro is not None else (0, 0, 0, m)
    gx, ginv, gshift = gate if gate is not None else (None, 0, 0)
    p = conv3x3_plan_f32(m, c, n)
    part = None
    if p.splits > 1:
        # this launch's own partials and per-tile arrival counters (the
        # entry zeroes them on the stream): nothing shared with another
        # stream's launch or left behind by an aborted one
        gm, gn = p.grid(m, n)
        part = torch.empty(p.splits * m * n + gm * gn, device=y.device)
    return build.lib().cunet_conv3x3_f32(
        y.data_ptr(), y.stride(0), m, h, w, c, w3p.data_ptr(), n, inv, shift,
        vstride, tile_rows, 0 if gx is None else gx.data_ptr(),
        0 if gx is None else gx.stride(0), ginv, gshift, out.data_ptr(),
        out.stride(0), bits_i, int(ste), p.bn, p.smem, p.splits,
        0 if part is None else part.data_ptr(), _stream(y))


# ---------------------------------------------------------------------------
# K3 maxpool2 / K4 upsample2
# ---------------------------------------------------------------------------


def maxpool2_plain(x, b, h, w, out):
    c = x.shape[1]
    p = x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))
    out.copy_(p.reshape(-1, c))
    return out


def maxpool2(x, b, h, w, out):
    """2x2/2 max pool of ``x`` (b*h*w, C) into ``out`` (b*h/2*w/2, C).

    Replaces ``cunet_tpu/kernels/fused_hourglass.py::_maxpool2``: the down
    block's ahead output pooled into the next buffer's ``[:, :c]``. Pure
    data movement (reads 4 rows, writes 1). Design: one thread per 8
    channels (4 at float32) of an output pixel, four 16-byte loads, one
    16-byte store into the strided buffer view.
    """
    m, c = x.shape
    if m != b * h * w or h % 2 or w % 2 \
            or tuple(out.shape) != (b * (h // 2) * (w // 2), c):
        raise ValueError(f"maxpool2 shapes: x {tuple(x.shape)}, out "
                         f"{tuple(out.shape)}, image {b}x{h}x{w}")
    if x.device.type == "cpu":
        return maxpool2_plain(x, b, h, w, out)
    _check_view(x, "x", (BF16, F32), None)
    _check_view(out, "out", (BF16, F32), None)
    _check_dtypes(x, out=out)
    f32 = x.dtype == F32
    fn = build.lib().cunet_maxpool2_f32 if f32 else build.lib().cunet_maxpool2
    code = fn(x.data_ptr(), x.stride(0), out.data_ptr(), out.stride(0), b, h,
              w, c, _stream(x))
    build.check(code, "maxpool2")
    maxpool2.launches += 1
    maxpool2.f32_launches += f32
    return out


def upsample2_plain(x, b, h, w, out):
    c = x.shape[1]
    u = x.reshape(b, h, 1, w, 1, c).expand(b, h, 2, w, 2, c)
    out.copy_(u.reshape(-1, c))
    return out


def upsample2(x, b, h, w, out):
    """2x nearest upsample of ``x`` (b*h*w, C) into ``out`` (b*2h*2w, C).

    Replaces ``cunet_tpu/kernels/fused_hourglass.py::_upsample2``: the
    neck/up ahead output written into the next up buffer's ``[:, :c]``.
    Pure data movement (reads 1 row, writes 4). Design: one thread per 8
    channels (4 at float32) of an input pixel, one 16-byte load, four
    16-byte stores.
    """
    m, c = x.shape
    if m != b * h * w or tuple(out.shape) != (b * 4 * h * w, c):
        raise ValueError(f"upsample2 shapes: x {tuple(x.shape)}, out "
                         f"{tuple(out.shape)}, image {b}x{h}x{w}")
    if x.device.type == "cpu":
        return upsample2_plain(x, b, h, w, out)
    _check_view(x, "x", (BF16, F32), None)
    _check_view(out, "out", (BF16, F32), None)
    _check_dtypes(x, out=out)
    f32 = x.dtype == F32
    fn = (build.lib().cunet_upsample2_f32 if f32
          else build.lib().cunet_upsample2)
    code = fn(x.data_ptr(), x.stride(0), out.data_ptr(), out.stride(0), b, h,
              w, c, _stream(x))
    build.check(code, "upsample2")
    upsample2.launches += 1
    upsample2.f32_launches += f32
    return out


KERNELS = (affine_dot, conv3x3, maxpool2, upsample2)
PLAIN = {affine_dot: affine_dot_plain, conv3x3: conv3x3_plain,
         maxpool2: maxpool2_plain, upsample2: upsample2_plain}
OPTIONS = {affine_dot: "bits_i", conv3x3: "bits_i"}


def reset_counts(kernels, options=()) -> None:
    """Zero ``launches`` of each wrapper of ``kernels`` (and its
    ``f32_launches``, where it has a float32 form) and ``option_launches``
    and ``f32_option_launches`` of each of ``options``."""
    for k in kernels:
        k.launches = 0
        if hasattr(k, "f32_launches"):
            k.f32_launches = 0
    for k in options:
        k.option_launches = k.f32_option_launches = 0


def count_options(options: dict) -> dict:
    """Launches with an option on, keyed ``name[option]``, of the wrappers
    of ``options`` ({wrapper: option name})."""
    return {f"{k.__name__}[{o}]": k.option_launches
            for k, o in options.items()}


def count_f32_options(options: dict) -> dict:
    """Launches of the float32 forms with an option on, keyed
    ``name[f32,option]`` (also counted in ``option_launches``)."""
    return {f"{k.__name__}[f32,{o}]": k.f32_option_launches
            for k, o in options.items()}


def count_f32(kernels) -> dict:
    """Launches of the float32 form of each wrapper of ``kernels``, keyed
    ``name[f32]`` (also counted in its ``launches``)."""
    return {f"{k.__name__}[f32]": k.f32_launches for k in kernels}


def reset_launch_counts() -> None:
    reset_counts(KERNELS, OPTIONS)


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def option_counts() -> dict:
    return count_options(OPTIONS)


def f32_counts() -> dict:
    return count_f32(KERNELS)


def f32_option_counts() -> dict:
    return count_f32_options(OPTIONS)


for _k in KERNELS:
    _k.f32_launches = 0
reset_launch_counts()
