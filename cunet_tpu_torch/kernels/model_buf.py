"""Whole post-stem eval forward over channel-plane buffers, on four kernels.

Counterpart of ``cunet_tpu/kernels/fused_model_buf.py::fused_model_buf_infer``
(float branch). The TPU version is one Pallas program; here a small PyTorch
orchestration drives the hand-written kernels of
:mod:`cunet_tpu_torch.kernels.buf_ops` over the same buffer layout, one
persistent buffer per block position, so that every stage input is a
contiguous channel prefix of a buffer and no concat exists:

  down/neck buffer: [ y(c) | fifo(g*order) | out32(g) ]
  up buffer:        [ up_y(c) | skip(c) | fifo(g*order) | out32(g) ]
  intermedia:       [ y(c) | fifo(c*order) ]

A dense stage reads ``buf[:, :K]``, writes its 3x3 output into the
``out32`` slot right after the current FIFO tail, and the FIFO update
between slots is one g-wide in-buffer column copy. The buffers hold the
whole batch and persist across the K slots, because the FIFO entries live
in them from one slot to the next.

With slots marshalled for int8 (the int8 branch of ``fused_model_buf_infer``) the
quantized model runs on the int8 kernels of
:mod:`cunet_tpu_torch.kernels.quant_ops`: each bottleneck quantizes its
input to int8, multiplies by the {-1, 0, +1} weight with int32
accumulation, applies BN2's full affine and ReLU to the float32 result and
quantizes it again for the int8 3x3 conv; adapters and heads are int8
products too. The intermedia adapters stay float (``affine_dot``), and
pool, upsample and the FIFO copies are unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from cunet_tpu_torch.config import ModelConfig
from cunet_tpu_torch.kernels.buf_ops import (
    affine_dot,
    conv3x3,
    maxpool2,
    pack_w3,
    pad_cols,
    upsample2,
)
from cunet_tpu_torch.kernels.quant_ops import (
    affine_dot_i8,
    conv3x3_i8,
    pack_w3_i8,
    pack_w_i8,
)
from cunet_tpu_torch.quant.wage import scale_s


def marshal_slots(slot_args: Sequence[Dict], cfg: ModelConfig,
                  dtype=torch.bfloat16, quant_bits_i: int = 0,
                  bn2_affine: bool = False) -> List[Dict]:
    """Kernel operands from ``cu_net.slot_args``: matrices in ``dtype``, BN
    vectors in float32, vectors and matrices zero-padded to the steady-state
    input width of their position so that growth-phase slots read a prefix
    of the same padded weight (as ``fused_model_buf_infer`` marshals them).

    With ``quant_bits_i`` (``slot_args(..., fold=False)`` of
    ``quant_eval_params`` weights) the bottleneck, adapter, head and 3x3
    matrices are rounded to int8 (each beside its K-major image for the
    int8 kernels, ``quant_ops.pack_w_i8`` / ``pack_w3_i8``: ``wt_b``,
    ``wt_a``, ``wt_s``, ``wt3``, the slot's ``wt_head``), the intermedia
    matrices stay in ``dtype`` and each block keeps BN2's full (2, Cb)
    [inv2; shift2] as ``vec2``;
    ``bn2_affine`` keeps it so for the float model too (``slot_args(...,
    fold=False)`` for the per-block eval, #5). Each slot's ``s`` is the
    activation quantizer's scale 2^(bits_i-1), or None for the float
    model: it selects ``model_buf_infer``'s mode. The head weight gets zero
    columns up to a multiple of 8 (``pad_cols``: 68 classes run as 72)."""
    nb, order = cfg.num_blocks, cfg.order
    c, g = cfg.init_chan_num, cfg.growth_rate

    def float_mat(w):
        return (w[0, 0] if w.dim() == 4 else w).to(dtype)

    def mat(w):
        if quant_bits_i:
            return torch.round(w[0, 0] if w.dim() == 4 else w).to(torch.int8)
        return float_mat(w)

    def w3_mat(w3):
        p = pack_w3(w3)
        return torch.round(p).to(torch.int8) if quant_bits_i else p.to(dtype)

    def pad_vec(vec, k):
        return torch.nn.functional.pad(vec.float(), (0, k - vec.shape[1]))

    def pad_mat(w, k):
        return torch.nn.functional.pad(w, (0, 0, 0, k - w.shape[0]))

    def kmax(pos):
        return (2 * c if pos > nb else c) + order * g

    ki = c + order * c
    s_q = scale_s(quant_bits_i) if quant_bits_i else None
    out = []
    for sa in slot_args:
        blocks = []
        for pos, ws in enumerate(sa["blocks"]):
            kb = kmax(pos)
            b = {
                "vec_b": pad_vec(ws["vec_b"], kb),
                "w_b": pad_mat(mat(ws["w_b"]), kb).contiguous(),
                "w3": w3_mat(ws["w3"]),
                "vec_a": pad_vec(ws["vec_a"], kb + g),
                "w_a": pad_mat(mat(ws["w_a"]), kb + g).contiguous(),
            }
            if quant_bits_i or bn2_affine:
                b["vec2"] = ws["vec2"].float().contiguous()
            else:
                b["shift2"] = ws["vec2"][1].float().contiguous()
            if "w_s" in ws:
                b["vec_s"] = pad_vec(ws["vec_s"], kb + g)
                b["w_s"] = pad_mat(mat(ws["w_s"]), kb + g).contiguous()
            if quant_bits_i:
                # the int8 kernels' K-major weight images, packed once
                for key in ("w_b", "w_a", "w_s"):
                    if key in b:
                        b["wt" + key[1:]] = pack_w_i8(b[key])
                b["wt3"] = pack_w3_i8(b["w3"])
            blocks.append(b)
        inter = None
        if sa["inter"] is not None:
            vec, w = sa["inter"]
            inter = (pad_vec(vec, ki), pad_mat(float_mat(w), ki).contiguous())
        vec, w = sa["head"]
        head = (vec.float().contiguous(), pad_cols(mat(w)).contiguous())
        out.append({"inter": inter, "blocks": blocks, "head": head,
                    "s": s_q})
        if quant_bits_i:
            out[-1]["wt_head"] = pack_w_i8(head[1])
    return out


def model_buf_infer(y_stem: torch.Tensor, slots: Sequence[Dict],
                    cfg: ModelConfig,
                    heads: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Post-stem forward of all K slots. ``y_stem`` is the (N, h0, h0, c)
    stem output; returns the heads of the 1-indexed slots ``heads``
    (default ``cfg.anchors``) stacked as (N, len(heads), h0, h0, class_num)
    in ``y_stem.dtype`` (a view of the padded head width). Slots
    marshalled with ``quant_bits_i`` run the quantized model on the int8
    kernels."""
    n, h0, _, c = y_stem.shape
    nb, order, K = cfg.num_blocks, cfg.order, cfg.layer_num
    g, cb = cfg.growth_rate, cfg.bottleneck_chan
    anchors = tuple(cfg.anchors if heads is None else heads)
    dev, dtype = y_stem.device, y_stem.dtype
    s_q = slots[0]["s"]

    def empty(rows, cols, dt=dtype):
        return torch.empty(rows, cols, device=dev, dtype=dt)

    res = [h0 >> j for j in range(nb + 1)]
    # traversal order: down j = buffer j, neck = nb, up j = nb+1+(nb-1-j)
    bufs = ([empty(n * res[j] ** 2, c + order * g + g) for j in range(nb)]
            + [empty(n * res[nb] ** 2, c + order * g + g)]
            + [empty(n * res[j] ** 2, 2 * c + order * g + g)
               for j in reversed(range(nb))])
    inter = empty(n * h0 * h0, c + order * c)
    # relu(BN2(bottleneck)) rows: the 3x3 conv's input (int8 codes in the
    # quantized model)
    y2_scratch = empty(n * h0 * h0, cb,
                       dtype if s_q is None else torch.int8)
    ahead_scratch = empty(n * h0 * h0, c)    # ahead before pool / upsample
    # the heads write the padded width of their weights (``pad_cols``)
    cls_pad = slots[0]["head"][1].shape[1]
    out = torch.empty(n, len(anchors), h0, h0, cls_pad, device=dev,
                      dtype=dtype)
    y0 = y_stem.reshape(n * h0 * h0, c)

    def rotate(buf, base, width, src):
        """Steady-state FIFO update: shift the ``order`` entries of
        ``width`` columns from ``base`` left by one, append ``src``."""
        for s in range(order - 1):
            buf[:, base + width * s:base + width * (s + 1)].copy_(
                buf[:, base + width * (s + 1):base + width * (s + 2)])
        buf[:, base + width * (order - 1):base + width * order].copy_(src)

    if s_q is not None:
        def adapter(x, vec, w, out, wt):
            affine_dot_i8(x, vec, w, out, s=s_q, wt=wt)

        def layer(x, ws, res_, out):
            y2 = y2_scratch[:x.shape[0]]
            affine_dot_i8(x, ws["vec_b"], ws["w_b"], y2, s=s_q,
                          vec2=ws["vec2"], wt=ws["wt_b"])
            conv3x3_i8(y2, ws["w3"], n, res_, res_, out, s=s_q,
                       wt=ws["wt3"])
    else:
        def adapter(x, vec, w, out, wt):
            affine_dot(x, vec, w, out)

        def layer(x, ws, res_, out):
            y2 = y2_scratch[:x.shape[0]]
            affine_dot(x, ws["vec_b"], ws["w_b"], y2, bias=ws["shift2"])
            conv3x3(y2, ws["w3"], n, res_, res_, out)

    def dense(i, pos, ws, res_, is_up, ahead_out):
        """One block at buffer ``pos``; ahead -> ``ahead_out``."""
        link = min(i, order)
        buf = bufs[pos]
        base = 2 * c if is_up else c
        kin = base + link * g
        layer(buf[:, :kin], ws, res_, buf[:, kin:kin + g])
        adapter(buf[:, :kin + g], ws["vec_a"], ws["w_a"], ahead_out,
                ws.get("wt_a"))
        if "w_s" in ws:
            up_buf = bufs[nb + 1 + (nb - 1 - pos)]
            adapter(buf[:, :kin + g], ws["vec_s"], ws["w_s"],
                    up_buf[:, c:2 * c], ws.get("wt_s"))
        # growth phase (i < order) leaves out32 where it landed, at FIFO
        # position ``link``; steady state rotates it in
        if order > 0 and i >= order:
            rotate(buf, base, g, buf[:, kin:kin + g])

    for i in range(K):
        sl = slots[i]
        d0 = bufs[0]
        # ---- intermedia: its output goes straight into down0[:, :c] ----
        if i == 0:
            d0[:, :c].copy_(y0)
            if order > 0:
                inter[:, c:2 * c].copy_(y0)
        else:
            link = min(i, order)
            vec, w = sl["inter"]
            affine_dot(inter[:, :c + link * c], vec, w, d0[:, :c])
            if order > 0 and i >= order:
                rotate(inter, c, c, d0[:, :c])
            elif order > 0:
                inter[:, c * (1 + i):c * (2 + i)].copy_(d0[:, :c])
        # ---- down path ----
        for j in range(nb):
            ahead = ahead_scratch[:n * res[j] ** 2]
            dense(i, j, sl["blocks"][j], res[j], False, ahead)
            maxpool2(ahead, n, res[j], res[j], bufs[j + 1][:, :c])
        # ---- neck ----
        ahead = ahead_scratch[:n * res[nb] ** 2]
        dense(i, nb, sl["blocks"][nb], res[nb], False, ahead)
        upsample2(ahead, n, res[nb], res[nb], bufs[nb + 1][:, :c])
        # ---- up path; the last up block's ahead is the slot output ----
        for idx, j in enumerate(reversed(range(nb))):
            pos = nb + 1 + idx
            if idx < nb - 1:
                ahead = ahead_scratch[:n * res[j] ** 2]
                dense(i, pos, sl["blocks"][pos], res[j], True, ahead)
                upsample2(ahead, n, res[j], res[j], bufs[pos + 1][:, :c])
            else:
                dense(i, pos, sl["blocks"][pos], res[j], True, inter[:, :c])
        if (i + 1) in anchors:
            vec, w = sl["head"]
            a = anchors.index(i + 1)
            adapter(inter[:, :c], vec, w, out[:, a].view(n, h0 * h0, cls_pad),
                    sl.get("wt_head"))
    return out[..., :cfg.class_num]
