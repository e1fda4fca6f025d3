"""One U-Net slot of the train step on the Hopper kernels: forward and
recompute backward, wired as a ``torch.autograd.Function``.

Counterpart of ``cunet_tpu/kernels/train_slot.py``: ``slot_train_fwd``
(:450), ``slot_train_bwd`` (:1320) and the custom VJP of ``_make_slot_fn``
(:1561) behind ``fused_slot_train`` (:1626). The TPU runs a slot as one
Pallas program forward and two backward (a v5e VMEM limit); here a short
PyTorch orchestration drives the kernels of
:mod:`cunet_tpu_torch.kernels.buf_ops` (the forward GEMMs, with per-tile
ghost-BN prologues) and :mod:`cunet_tpu_torch.kernels.train_ops` (the
statistics and the backward) over per-slot channel-plane buffers, as
:mod:`cunet_tpu_torch.kernels.model_buf` does for eval:

  down/neck buffer: [ y(c)            | fifo(g*L) | out32(g) ]
  up buffer:        [ up_y(c) | skip(c) | fifo(g*L) | out32(g) ]
  intermedia:       [ y(c) | fifo(c*L) ]

A stage ``out = relu(bn(x)) @ W`` reads a channel prefix of a buffer, with
BN statistics per tile of ``bn_tile`` images taken in-kernel from the bf16
stage input. The buffers belong to one call and are dropped after it:
FIFO entries are copied in (g-wide columns), and every output or saved
tensor is one the slot allocated and nothing writes into afterwards, so
autograd's saved-tensor version checks hold (PR 1's eval buffers, shared
across slots and written in place, would defeat them).

What is saved for the backward is what the JAX kernel saves: the slot's
inputs, the block inputs of ``saved_layout`` (pooled, up inputs before the
upsample, skips), the out32s, the slot output and the per-tile
statistics. The backward rebuilds each block's buffer from them in one
scratch (recomputing the upsample, and the intermedia output for down
block 0), then recomputes what lies inside the block: the bottleneck
output and, for pooling, the ahead output.

Numerics: the kernels' BN affine runs in float32 from float32 [inv; shift]
and rounds once to bf16 (the per-tile form of the eval prologue), where the
JAX kernel's ``_norm_relu`` runs it in the compute dtype; with a float32
compute dtype the two are the same computation (on the card the kernels'
float32 forms, float32-accurate products, take float32 buffers). Statistics
are taken from the bf16 stage inputs and the out32s are rounded before
their statistics, as ``_slot_fwd_kernel`` rounds them.

The backward walks the slot in reverse -- head, up path, neck, down path,
intermedia -- recomputing each block from its buffer, as ``_run_up`` :1033,
``_run_down`` :1175 and ``_block_bwd_generic`` :917 do. Weight gradients
come back in float32 for the float32 master parameters.

The two options of the TPU kernels:

- dropout (``drop="seed"``): the slot's int32 seed and the rate ride in
  ``SlotMeta``; ``drop_ops.drop_mask`` multiplies each out32 by its mask
  right after the conv (before its statistics and before it is saved, so
  the saved out32s are post-dropout), and the backward regenerates the
  same mask for the conv's cotangent (``_seed_mask`` :226, :296-300,
  :949-952); with ``drop="masks"`` the slot's per-position threefry keys
  ride there instead, and ``drop_ops.threefry_mask`` regenerates JAX's
  precomputed masks (kernel inputs :425-426, :1389-1390) at the same two
  points;
- QuanInput (``bits_i``): the conv3x3 prologue and the head's quantize
  their bf16 activation (``_quan`` :198, :294, :356); the backward takes
  dW against the quantized values and adds the straight-through gate
  0 < z < 1 to the ReLU mask (:953-959, ``_stage_bwd`` :585). Intermedia,
  bottleneck and adapter stages are never quantized.

Not carried over: the TPU-only knobs (``CUNET_TRAIN_CONV3X3``,
``CUNET_CONV_BWD``, ``CUNET_TRAIN_CONV_CHUNK``, ``CUNET_TSBWD_*``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from cunet_tpu_torch.config import ModelConfig
from cunet_tpu_torch.kernels.drop_ops import drop_mask, threefry_mask
from cunet_tpu_torch.kernels.buf_ops import (
    affine_dot,
    conv3x3,
    maxpool2,
    pack_w3,
    pad_cols,
    upsample2,
)
from cunet_tpu_torch.kernels.train_ops import (
    affine_dw,
    affine_dx,
    bn_bwd,
    bn_stats,
    conv3x3_dw,
    conv3x3_dx,
    maxpool2_bwd,
    upsample2_bwd,
)
from cunet_tpu_torch.ops.layers import BN_EPS

# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def slot_plan(num_blocks: int, h0: int, c: int, g: int, L: int) -> List[Dict]:
    """Per-position dicts in traversal order (down 0..nb-1, neck, up
    nb-1..0): resolution, base width, skip adapter, stage widths k1 (the
    bottleneck input) and k2 (the adapters' input). L = FIFO entry count of
    this slot (min(slot_i, order))."""
    plan = []
    res = h0
    for _ in range(num_blocks):
        plan.append(dict(res=res, base=c, skip=True, k1=c + L * g))
        res //= 2
    plan.append(dict(res=res, base=c, skip=False, k1=c + L * g))
    for _ in range(num_blocks):
        res *= 2
        plan.append(dict(res=res, base=2 * c, skip=False, k1=2 * c + L * g))
    for p in plan:
        p["k2"] = p["k1"] + g
    return plan


def _wset_keys(skip: bool):
    return ("bn1", "w_b", "bn2", "w3", "bn_a", "w_a") + (
        ("bn_s", "w_s") if skip else ())


@dataclasses.dataclass(frozen=True)
class SlotMeta:
    """Static description of one slot call (``make_meta`` + ``finalize_meta``
    of the JAX kernel). ``bits_i``: QuanInput bits (0 = off); ``seed``: the
    slot's int32 dropout seed (``drop_impl="prng"``), or ``keys``: its
    threefry block keys in traversal order (``"masks"``), at most one of
    the two set (neither: no dropout), with ``drop_rate``."""

    num_blocks: int
    L: int
    has_inter: bool
    bt: int
    chan: int
    growth: int
    cb: int
    h: int
    dtype: torch.dtype
    eps: float = BN_EPS
    bits_i: int = 0
    drop_rate: float = 0.0
    seed: Optional[int] = None
    keys: Optional[tuple] = None

    @property
    def dropout(self) -> bool:
        return self.seed is not None or self.keys is not None

    def drop(self, x, pos: int, res: int, out=None):
        """The dropout mask of position ``pos`` on an out32 view ``x`` at
        resolution ``res`` (in place), or onto ``out`` from the float32
        cotangent ``x``; the identity without dropout."""
        if self.keys is not None:
            return threefry_mask(x, self.keys[pos], self.drop_rate, out)
        if self.seed is None:
            return x
        return drop_mask(x, self.seed, pos, self.drop_rate,
                         self.bt * res * res, out)

    @property
    def plan(self) -> List[Dict]:
        return slot_plan(self.num_blocks, self.h, self.chan, self.growth,
                         self.L)

    def weight_keys(self) -> List[tuple]:
        """(group, key) of every weight in the flat argument order."""
        keys = [("inter", 0), ("inter", 1)] if self.has_inter else []
        for pos, p in enumerate(self.plan):
            keys += [(pos, k) for k in _wset_keys(p["skip"])]
        return keys + [("head", 0), ("head", 1)]


def stat_widths(meta: SlotMeta) -> List[int]:
    """Per-tile stat channel widths in emission order: [inter] + per
    position (bn1, bn2, bn_a) + head. ``_stat_widths`` :433 also emits
    bn_s after bn_a; its statistics are bn_a's, the same numbers, so here
    they are emitted once and serve both adapters."""
    widths = [meta.chan * (1 + meta.L)] if meta.has_inter else []
    for p in meta.plan:
        widths += [p["k1"], meta.cb, p["k2"]]
    return widths + [meta.chan]


def marshal_slot(p_slot: Dict[str, torch.Tensor], num_blocks: int) -> Dict:
    """Kernel weight dict from a ``cu_net._slot_subtree`` params view:
    BN params stacked as (2, C) [scale; bias], 1x1 weights as (Cin, Cout),
    the 3x3 weight packed tap-major (9*Cb, G) (``buf_ops.pack_w3``). All
    differentiable glue (stack, index, reshape), so gradients reach the
    float32 master parameters through it; the TPU layouts (dycol/scatter
    packings) are not carried over."""

    def bn(prefix):
        return torch.stack([p_slot[f"{prefix}.scale"],
                            p_slot[f"{prefix}.bias"]])

    def wset(pre, skip):
        d = {"bn1": bn(f"{pre}.layers.bottleneck.norm"),
             "w_b": p_slot[f"{pre}.layers.bottleneck.conv"][0, 0],
             "bn2": bn(f"{pre}.layers.norm2"),
             "w3": pack_w3(p_slot[f"{pre}.layers.conv2"]),
             "bn_a": bn(f"{pre}.adapters_ahead.norm"),
             "w_a": p_slot[f"{pre}.adapters_ahead.conv"][0, 0]}
        if skip:
            d["bn_s"] = bn(f"{pre}.adapters_skip.norm")
            d["w_s"] = p_slot[f"{pre}.adapters_skip.conv"][0, 0]
        return d

    blocks = ([wset(f"hg.down.{j}", True) for j in range(num_blocks)]
              + [wset("hg.neck", False)]
              + [wset(f"hg.up.{j}", False)
                 for j in reversed(range(num_blocks))])
    W = {"blocks": blocks,
         "head": (bn("head.norm"), p_slot["head.conv"][0, 0])}
    if "inter.conv" in p_slot:
        W["inter"] = (bn("inter.norm"), p_slot["inter.conv"][0, 0])
    return W


def _flat_weights(meta: SlotMeta, W: Dict) -> List[torch.Tensor]:
    return [W[g][k] if g in ("inter", "head") else W["blocks"][g][k]
            for g, k in meta.weight_keys()]


def _unflat_weights(meta: SlotMeta, flat: Sequence[torch.Tensor]) -> Dict:
    W: Dict = {"blocks": [{} for _ in meta.plan]}
    pairs: Dict = {}
    for (g, k), t in zip(meta.weight_keys(), flat):
        if g in ("inter", "head"):
            pairs.setdefault(g, [None, None])[k] = t
        else:
            W["blocks"][g][k] = t
    for g, pair in pairs.items():
        W[g] = tuple(pair)
    return W


def _affine_vec(stats: torch.Tensor, bn: torch.Tensor, eps: float):
    """Per-tile (T, 2, C) [inv; shift] of a train BN from its (T, 2, C)
    [mean; var] statistics and (2, C) [gamma; beta]."""
    inv = torch.rsqrt(stats[:, 1] + eps) * bn[0]
    return torch.stack([inv, bn[1] - stats[:, 0] * inv], dim=1)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def saved_layout(plan: List[Dict], nb: int, c: int):
    """(res, chan) of the block inputs the forward saves, in emission order:
    pooled inputs (down 1..nb-1 and the neck), up-block inputs before the
    upsample, skips (``saved_layout`` :75)."""
    pooled = [(plan[j + 1]["res"], c) for j in range(nb)]
    up_pre = [(plan[nb + 1 + i]["res"] // 2, c) for i in range(nb)]
    skips = [(plan[j]["res"], c) for j in range(nb)]
    return pooled, up_pre, skips


class _Saved:
    """The backward's residuals: the slot's inputs, the saved block inputs
    (``saved_layout``), the out32s, the slot output and the per-tile
    statistics, with their flat form for
    ``ctx.save_for_backward``."""

    FIELDS = ("inputs", "pooled", "up_pre", "skips", "out32s")

    def __init__(self, inputs, pooled, up_pre, skips, out32s, y_out, stats):
        self.inputs, self.pooled, self.up_pre = inputs, pooled, up_pre
        self.skips, self.out32s = skips, out32s
        self.y_out, self.stats = y_out, stats

    def tensors(self) -> List[torch.Tensor]:
        flat = [t for f in self.FIELDS for t in getattr(self, f)]
        return flat + [self.y_out] + list(self.stats)

    @classmethod
    def from_tensors(cls, meta: SlotMeta, ts: Sequence[torch.Tensor]):
        npos, nb = len(meta.plan), meta.num_blocks
        n_in = 1 + (meta.L if meta.has_inter else 0) + npos * meta.L
        sizes = (n_in, nb, nb, nb, npos)
        parts, i = [], 0
        for size in sizes:
            parts.append(list(ts[i:i + size]))
            i += size
        return cls(*parts, ts[i], list(ts[i + 1:]))

    def slot_inputs(self, meta: SlotMeta):
        """(y, inter_fifo, per-position fifo entries)."""
        y, rest = self.inputs[0], self.inputs[1:]
        ni = meta.L if meta.has_inter else 0
        L = meta.L
        fifos = [rest[ni + pos * L:ni + (pos + 1) * L]
                 for pos in range(len(meta.plan))]
        return y, rest[:ni], fifos


def _stats_of(x: torch.Tensor, tiles: int) -> torch.Tensor:
    out = torch.empty(tiles, 2, x.shape[1], device=x.device,
                      dtype=torch.float32)
    return bn_stats(x, out)


def _fill_fifo(buf, p, L, g, fifo):
    """Copy the FIFO entries into a block buffer's fifo columns."""
    o = p["k1"] - L * g
    for li, f in enumerate(fifo):
        buf[:, o + li * g:o + (li + 1) * g].copy_(f.reshape(-1, g))


def slot_train_fwd(meta: SlotMeta, y, inter_fifo, fifos, W):
    """One slot's train forward. ``W`` holds kernel operands (matrices in
    the compute dtype, BN vectors in float32). Returns
    ``(y_out, head, inter_out|None, out32s, stats, saved)``: stats are the
    per-tile (T, 2, C) float32 [mean; biased var] in emission order
    (``stat_widths``: bn_a's statistics serve bn_s too) and ``saved`` the
    backward's residuals. The block buffers live only for the call."""
    n, h0 = y.shape[0], y.shape[1]
    nb, L, c, g, cb = (meta.num_blocks, meta.L, meta.chan, meta.growth,
                       meta.cb)
    if n % meta.bt:
        raise ValueError(f"batch {n} not divisible by bn_tile {meta.bt}")
    tiles = n // meta.bt
    dev, dt = y.device, meta.dtype
    plan = meta.plan
    eps = meta.eps

    def empty(rows, cols):
        return torch.empty(rows, cols, device=dev, dtype=dt)

    def rows(res):
        return n * res * res

    bufs = [empty(rows(p["res"]), p["k2"]) for p in plan]
    for pos, p in enumerate(plan):
        _fill_fifo(bufs[pos], p, L, g, fifos[pos])
    pooled, up_pre, skips = ([empty(rows(r), ch) for r, ch in part]
                             for part in saved_layout(plan, nb, c))
    out32s = [empty(rows(p["res"]), g) for p in plan]
    m0 = rows(h0)
    stats: List[torch.Tensor] = []

    inter_out = None
    if meta.has_inter:
        ibuf = empty(m0, c * (1 + L))
        for li, f in enumerate([y] + list(inter_fifo)):
            ibuf[:, li * c:(li + 1) * c].copy_(f.reshape(-1, c))
        s = _stats_of(ibuf, tiles)
        stats.append(s)
        bn_i, w_i = W["inter"]
        inter_out = empty(m0, c)
        affine_dot(ibuf, _affine_vec(s, bn_i, eps), w_i, inter_out)
        bufs[0][:, :c].copy_(inter_out)
    else:
        bufs[0][:, :c].copy_(y.reshape(-1, c))

    yb = empty(m0, cb)           # bottleneck output, reused by every block
    ahead = empty(m0, c)         # a down block's ahead output before pooling
    y_out = empty(m0, c)

    def block(pos, ahead_out, skip_out=None):
        p, buf, w = plan[pos], bufs[pos], W["blocks"][pos]
        k1, k2, res = p["k1"], p["k2"], p["res"]
        ybm = yb[:rows(res)]
        s1 = _stats_of(buf[:, :k1], tiles)
        affine_dot(buf[:, :k1], _affine_vec(s1, w["bn1"], eps), w["w_b"], ybm)
        s2 = _stats_of(ybm, tiles)
        conv3x3(ybm, w["w3"], n, res, res, buf[:, k1:k2],
                vec=_affine_vec(s2, w["bn2"], eps), bits_i=meta.bits_i)
        meta.drop(buf[:, k1:k2], pos, res)
        out32s[pos].copy_(buf[:, k1:k2])
        # x2 = [x_cat | out32]: x_cat's statistics are s1, per channel
        sa = torch.cat([s1, _stats_of(buf[:, k1:k2], tiles)], dim=2)
        affine_dot(buf[:, :k2], _affine_vec(sa, w["bn_a"], eps), w["w_a"],
                   ahead_out)
        stats.extend([s1, s2, sa])
        if skip_out is not None:
            affine_dot(buf[:, :k2], _affine_vec(sa, w["bn_s"], eps),
                       w["w_s"], skip_out)

    for j in range(nb):
        res = plan[j]["res"]
        a = ahead[:rows(res)]
        block(j, a, skips[j])
        bufs[2 * nb - j][:, c:2 * c].copy_(skips[j])
        maxpool2(a, n, res, res, pooled[j])
        bufs[j + 1][:, :c].copy_(pooled[j])
    for pos in range(nb, 2 * nb):
        i = pos - nb                  # up block i reads up_pre[i]
        block(pos, up_pre[i])
        r = plan[pos]["res"]
        upsample2(up_pre[i], n, r, r, bufs[pos + 1][:, :c])
    block(2 * nb, y_out)
    del bufs

    sh = _stats_of(y_out, tiles)
    stats.append(sh)
    bn_h, w_h = W["head"]
    # the head runs at its padded width (68 classes as 72, ``pad_cols``)
    w_hp = pad_cols(w_h)
    head = torch.empty(m0, w_hp.shape[1], device=dev, dtype=dt)
    affine_dot(y_out, _affine_vec(sh, bn_h, eps), w_hp, head,
               bits_i=meta.bits_i)
    head = head[:, :w_h.shape[1]]

    if [s.shape[2] for s in stats] != stat_widths(meta):
        raise RuntimeError("slot statistics out of emission order")

    def img(t, res):
        return t.unflatten(0, (n, res, res))

    inputs = [y] + list(inter_fifo) + [t for f in fifos for t in f]
    saved = _Saved(inputs, pooled, up_pre, skips, out32s, y_out, stats)
    return (img(y_out, h0), img(head, h0),
            None if inter_out is None else img(inter_out, h0),
            [img(o, p["res"]) for o, p in zip(out32s, plan)], stats, saved)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def slot_train_bwd(meta: SlotMeta, saved: _Saved, W, cts):
    """Recompute backward of one slot. ``cts`` = (d_y_out, d_head,
    d_inter_out, d_out32s), each None where no cotangent arrived. Returns
    (d_y, d_inter_fifo, d_fifos, dW) with dW in ``W``'s structure, float32.

    Each block's buffer is rebuilt, in one scratch, from its saved input
    (the upsample recomputed for the up blocks, the intermedia adapter for
    down block 0), its FIFO entries and its out32."""
    d_y_out, d_head, d_inter_out, d_out32s = cts
    nb, L, c, g, cb = (meta.num_blocks, meta.L, meta.chan, meta.growth,
                       meta.cb)
    plan, eps, dt = meta.plan, meta.eps, meta.dtype
    y, inter_fifo, fifos = saved.slot_inputs(meta)
    y_out = saved.y_out
    m0, h0 = y_out.shape[0], meta.h
    n = m0 // (h0 * h0)
    dev = y_out.device
    f32 = torch.float32

    stat_it = iter(saved.stats)
    s_inter = next(stat_it) if meta.has_inter else None
    block_stats = [(next(stat_it), next(stat_it), next(stat_it))
                   for _ in plan]
    s_head = next(stat_it)

    def empty(rows, cols, dtype=f32):
        return torch.empty(rows, cols, device=dev, dtype=dtype)

    def rows(res):
        return n * res * res

    def compute(t):
        return t.to(dt).contiguous()

    dW: Dict = {"blocks": [{} for _ in plan]}
    d_fifos: List[List] = [[] for _ in plan]
    yb = empty(m0, cb, dt)
    scratch = empty(m0, max(p["k2"] for p in plan), dt)
    ibuf = None

    def rebuild(pos):
        """Block ``pos``'s buffer [base | fifo | out32] in the scratch."""
        nonlocal ibuf
        p = plan[pos]
        res = p["res"]
        buf = scratch[:rows(res), :p["k2"]]
        if pos == 0 and meta.has_inter:
            ibuf = empty(m0, c * (1 + L), dt)
            for li, f in enumerate([y] + list(inter_fifo)):
                ibuf[:, li * c:(li + 1) * c].copy_(f.reshape(-1, c))
            bn_i, w_i = W["inter"]
            affine_dot(ibuf, _affine_vec(s_inter, bn_i, eps), w_i,
                       buf[:, :c])
        elif pos == 0:
            buf[:, :c].copy_(y.reshape(-1, c))
        elif pos <= nb:
            buf[:, :c].copy_(saved.pooled[pos - 1])
        else:
            r = res // 2
            upsample2(saved.up_pre[pos - nb - 1], n, r, r, buf[:, :c])
            buf[:, c:2 * c].copy_(saved.skips[2 * nb - pos])
        _fill_fifo(buf, p, L, g, fifos[pos])
        buf[:, p["k1"]:p["k2"]].copy_(saved.out32s[pos])
        return buf

    def stage_bwd(x, s, bn, w, dy, d_x, gw, gbn, accumulate, d_a, bits_i=0):
        """out = [quan](relu(bn(x))) @ w: weight and BN-param grads, and the
        input cotangent into (or onto) d_x."""
        v = _affine_vec(s, bn, eps)
        affine_dx(dy, w, x, v, d_a, ste=bits_i > 0)
        affine_dw(x, v, dy, gw, bits_i=bits_i)
        bn_bwd(x, d_a, s, bn, eps, d_x, gbn, accumulate=accumulate)

    def block_bwd(pos, buf, d_ahead, d_skip):
        p, w = plan[pos], W["blocks"][pos]
        k1, k2, res = p["k1"], p["k2"], p["res"]
        m = rows(res)
        s1, s2, sa = block_stats[pos]
        gw = {k: torch.empty(w[k].shape, device=dev, dtype=f32)
              for k in _wset_keys(p["skip"])}
        dW["blocks"][pos] = gw
        x2 = buf[:, :k2]
        d_x2, d_a = empty(m, k2), empty(m, k2)
        stage_bwd(x2, sa, w["bn_a"], w["w_a"], d_ahead, d_x2, gw["w_a"],
                  gw["bn_a"], False, d_a)
        if d_skip is not None:
            stage_bwd(x2, sa, w["bn_s"], w["w_s"], d_skip, d_x2, gw["w_s"],
                      gw["bn_s"], True, d_a)
        d_o = d_x2[:, k1:k2]
        if d_out32s[pos] is not None:
            d_o = d_o + d_out32s[pos].reshape(m, g).float()
        # the saved out32 is post-dropout: the conv's cotangent is d_o * mask
        d_o = (meta.drop(d_o, pos, res, empty(m, g, dt)) if meta.dropout
               else compute(d_o))
        # recompute the bottleneck output, then 3x3 conv + BN2 backward
        v1 = _affine_vec(s1, w["bn1"], eps)
        ybm = yb[:m]
        affine_dot(buf[:, :k1], v1, w["w_b"], ybm)
        v2 = _affine_vec(s2, w["bn2"], eps)
        d_a2, d_yb = empty(m, cb), empty(m, cb)
        conv3x3_dx(d_o, w["w3"], n, res, res, ybm, v2, d_a2,
                   ste=meta.bits_i > 0)
        conv3x3_dw(ybm, v2, d_o, n, res, res, gw["w3"], bits_i=meta.bits_i)
        bn_bwd(ybm, d_a2, s2, w["bn2"], eps, d_yb, gw["bn2"])
        stage_bwd(buf[:, :k1], s1, w["bn1"], w["w_b"], compute(d_yb),
                  d_x2[:, :k1], gw["w_b"], gw["bn1"], True, d_a[:, :k1])
        o = k1 - L * g
        d_fifos[pos] = [compute(d_x2[:, o + li * g:o + (li + 1) * g])
                        .unflatten(0, (n, res, res)) for li in range(L)]
        return d_x2

    # ---- head: its input is the slot output ----
    d_y = (torch.zeros(m0, c, device=dev, dtype=f32) if d_y_out is None
           else d_y_out.reshape(m0, c).to(f32, copy=True))
    bn_h, w_h = W["head"]
    ncls, w_hp = w_h.shape[1], pad_cols(w_h)   # the forward's padded head
    g_bnh = torch.zeros(bn_h.shape, device=dev, dtype=f32)
    g_wh = torch.zeros(w_hp.shape, device=dev, dtype=f32)
    if d_head is not None:
        d_hp = pad_cols(compute(d_head.reshape(m0, ncls))).contiguous()
        stage_bwd(y_out, s_head, bn_h, w_hp, d_hp, d_y, g_wh, g_bnh, True,
                  empty(m0, c), meta.bits_i)
    dW["head"] = (g_bnh, g_wh[:, :ncls])

    # ---- up path, neck ----
    d_ahead = compute(d_y)
    d_skips: List = [None] * nb
    for pos in range(2 * nb, nb, -1):
        d_x2 = block_bwd(pos, rebuild(pos), d_ahead, None)
        r = plan[pos]["res"] // 2
        d_skips[2 * nb - pos] = d_x2[:, c:2 * c]
        d_ahead = empty(rows(r), c, dt)
        upsample2_bwd(d_x2[:, :c], n, r, r, d_ahead)
    d_x2 = block_bwd(nb, rebuild(nb), d_ahead, None)

    # ---- down path: recompute ahead for the pool's winner routing ----
    for pos in range(nb - 1, -1, -1):
        p, w = plan[pos], W["blocks"][pos]
        res, k2 = p["res"], p["k2"]
        m = rows(res)
        buf = rebuild(pos)
        a = empty(m, c, dt)
        affine_dot(buf[:, :k2],
                   _affine_vec(block_stats[pos][2], w["bn_a"], eps),
                   w["w_a"], a)
        d_ah = empty(m, c, dt)
        maxpool2_bwd(a, d_x2[:, :c], n, res, res, d_ah)
        d_x2 = block_bwd(pos, buf, d_ah, compute(d_skips[pos]))

    # ---- intermedia ----
    d_base = d_x2[:, :c]
    d_inter_fifo: List = []
    if meta.has_inter:
        if d_inter_out is not None:
            d_base = d_base + d_inter_out.reshape(m0, c).float()
        bn_i, w_i = W["inter"]
        kin = ibuf.shape[1]
        g_bni = torch.empty(bn_i.shape, device=dev, dtype=f32)
        g_wi = torch.empty(w_i.shape, device=dev, dtype=f32)
        d_xi = empty(m0, kin)
        stage_bwd(ibuf, s_inter, bn_i, w_i, compute(d_base), d_xi, g_wi,
                  g_bni, False, empty(m0, kin))
        dW["inter"] = (g_bni, g_wi)
        d_base = d_xi[:, :c]
        d_inter_fifo = [compute(d_xi[:, (li + 1) * c:(li + 2) * c])
                        .unflatten(0, (n, h0, h0)) for li in range(L)]
    d_y = compute(d_base).unflatten(0, (n, h0, h0))
    return d_y, d_inter_fifo, d_fifos, dW


# ---------------------------------------------------------------------------
# the autograd Function (the custom VJP of _make_slot_fn)
# ---------------------------------------------------------------------------


def _kernel_operands(meta: SlotMeta, flat_w: Sequence[torch.Tensor]):
    """Float32 master weights -> kernel operands: matrices in the compute
    dtype, contiguous; BN vectors float32."""
    out = []
    for (_, k), t in zip(meta.weight_keys(), flat_w):
        is_bn = k == 0 or (isinstance(k, str) and k.startswith("bn"))
        out.append(t.detach().float().contiguous() if is_bn
                   else t.detach().to(meta.dtype).contiguous())
    return out


class _SlotTrain(torch.autograd.Function):
    """Inputs: (meta, y, *inter_fifo, *fifo entries, *weights); outputs:
    (y_out, head, [inter_out], *out32s, *stats) with the stats marked
    non-differentiable. The backward returns a cotangent for every input:
    y, each FIFO entry (they flow into the earlier slots' out32 and
    inter_out, JAX's ``d_out32_ext`` / ``d_inter_out``) and every weight
    (float32)."""

    @staticmethod
    def forward(ctx, meta: SlotMeta, *args):
        npos, L = len(meta.plan), meta.L
        y = args[0]
        ni = L if meta.has_inter else 0
        inter_fifo = list(args[1:1 + ni])
        rest = args[1 + ni:]
        fifos = [list(rest[pos * L:(pos + 1) * L]) for pos in range(npos)]
        wk = _kernel_operands(meta, rest[npos * L:])
        W = _unflat_weights(meta, wk)
        y_out, head, inter_out, out32s, stats, saved = slot_train_fwd(
            meta, y.detach().to(meta.dtype), inter_fifo, fifos, W)
        ctx.meta, ctx.y_dtype = meta, y.dtype
        ctx.n_saved = len(saved.tensors())
        ctx.save_for_backward(*saved.tensors(), *wk)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(*stats)
        outs = [y_out, head] + ([inter_out] if meta.has_inter else [])
        return tuple(outs + out32s + stats)

    @staticmethod
    def backward(ctx, *cts):
        meta = ctx.meta
        ts = ctx.saved_tensors
        saved = _Saved.from_tensors(meta, ts[:ctx.n_saved])
        W = _unflat_weights(meta, ts[ctx.n_saved:])
        npos = len(meta.plan)
        d_y_out, d_head = cts[0], cts[1]
        i = 2
        d_inter_out = None
        if meta.has_inter:
            d_inter_out, i = cts[2], 3
        d_out32s = list(cts[i:i + npos])
        d_y, d_if, d_f, dW = slot_train_bwd(
            meta, saved, W, (d_y_out, d_head, d_inter_out, d_out32s))
        flat_f = [t for per in d_f for t in per]
        return (None, d_y.to(ctx.y_dtype), *d_if, *flat_f,
                *_flat_weights(meta, dW))


def fused_slot_train(y, inter_fifo, fifos, W, *, cfg: ModelConfig, L: int,
                     has_inter: bool, bits_i: int = 0,
                     drop_seed: Optional[int] = None,
                     drop_keys: Optional[Sequence[tuple]] = None):
    """Whole-slot train forward with the recompute backward as its
    gradient. ``y`` (N, h0, h0, c) is the slot input, ``inter_fifo`` the L
    intermedia FIFO entries (empty without the intermedia adapter),
    ``fifos`` the per-position FIFO entries in traversal order, ``W`` the
    ``marshal_slot`` weights (float32 masters). Requires cfg.bn_tile > 0
    (the BN statistics group). ``bits_i`` > 0 runs QuanInput (bits > 15
    are none); ``drop_seed`` (an int32) runs dropout at ``cfg.drop_rate``
    with masks regenerated from it, ``drop_keys`` (the slot's threefry
    block keys in traversal order, ``ops.threefry.block_keys``) with JAX's
    threefry masks regenerated from them. Returns (y_out, head, inter_out|None,
    out32s tuple, stats tuple), stats per-tile (T, 2, C) float32 in
    emission order."""
    if cfg.bn_tile <= 0:
        raise ValueError("the slot train kernels need cfg.bn_tile > 0")
    dropout = drop_seed is not None or drop_keys is not None
    if drop_seed is not None and drop_keys is not None:
        raise ValueError("dropout from drop_seed or from drop_keys, not both")
    if dropout and not 0.0 < cfg.drop_rate < 1.0:
        raise ValueError(f"dropout masks given with drop_rate "
                         f"{cfg.drop_rate}")
    if drop_keys is not None and len(drop_keys) != 2 * cfg.num_blocks + 1:
        raise ValueError(f"{len(drop_keys)} drop_keys, one a position "
                         f"({2 * cfg.num_blocks + 1})")
    meta = SlotMeta(num_blocks=cfg.num_blocks, L=L, has_inter=has_inter,
                    bt=cfg.bn_tile, chan=cfg.init_chan_num,
                    growth=cfg.growth_rate, cb=cfg.bottleneck_chan,
                    h=y.shape[1], dtype=getattr(torch, cfg.compute_dtype),
                    bits_i=bits_i if 0 < bits_i <= 15 else 0,
                    drop_rate=cfg.drop_rate if dropout else 0.0,
                    seed=None if drop_seed is None else int(drop_seed),
                    keys=None if drop_keys is None else tuple(
                        tuple(k) for k in drop_keys))
    npos = len(meta.plan)
    if len(fifos) != npos or any(len(f) != L for f in fifos) \
            or len(inter_fifo) != (L if has_inter else 0):
        raise ValueError(f"FIFO entries do not match L={L}, "
                         f"has_inter={has_inter}")
    flat = ([y] + list(inter_fifo) + [t for f in fifos for t in f]
            + _flat_weights(meta, W))
    outs = list(_SlotTrain.apply(meta, *flat))
    y_out, head = outs[0], outs[1]
    i = 2
    inter_out = None
    if has_inter:
        inter_out, i = outs[2], 3
    out32s = tuple(outs[i:i + npos])
    stats = tuple(outs[i + npos:])
    return y_out, head, inter_out, out32s, stats
