"""One slot's eval forward on the hand-written kernels: the intermedia
adapter, the down blocks with their pools, the neck, the up blocks with
their upsamples, and the head.

Counterpart of ``cunet_tpu/kernels/fused_hourglass.py::
fused_hourglass_infer`` (TPU kernel #4). The TPU version is one Pallas
program per image whose feature maps stay in VMEM; here a short PyTorch
orchestration drives hand-written kernels, about 37 launches per slot:

- every 1x1 stage (the intermedia adapter, each bottleneck with BN2's
  ``relu(. + shift2)`` epilogue, each adapter, the head) is the
  feature-table product :func:`cunet_tpu_torch.kernels.eval_ops.table_dot`,
  which reads y, the skip, the FIFO entries and the out32 in place as
  separate tensors (no concat, no copy into a buffer); a down block's ahead
  and skip adapters are its dual form, one read of their input;
- the 3x3 conv, the pool and the upsample are ``conv3x3``, ``maxpool2``
  and ``upsample2`` of :mod:`cunet_tpu_torch.kernels.buf_ops`, the
  functions the whole-model eval (#1) also runs, as the TPU kernels share
  ``_conv3x3``, ``_maxpool2`` and ``_upsample2``.

Rounding points are the TPU kernel's (``fused_hourglass.py:229-295``): the
bottleneck output stays float32 through ``+ shift2`` and the ReLU and is
rounded once; out32, the adapters' outputs, pre_out and the head are
rounded to the compute dtype. The weights are the slots of
:func:`cunet_tpu_torch.models.cu_net.eval_slots` (BN folded, BN2's scale in
the bottleneck weight, matrices padded to their steady-state width), so a
growth slot reads a row prefix of the same weights, and the whole-model
path and this one share one marshalling. On CPU tensors every kernel's
plain version runs.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from cunet_tpu_torch.kernels.buf_ops import conv3x3, maxpool2, upsample2
from cunet_tpu_torch.kernels.eval_ops import table_dot


def traversal_res(h0: int, num_blocks: int) -> List[int]:
    """Resolution of each block position in traversal order: down 0..nb-1,
    neck, up nb-1..0."""
    return ([h0 >> j for j in range(num_blocks)] + [h0 >> num_blocks]
            + [h0 >> j for j in reversed(range(num_blocks))])


def fused_hourglass_infer(y: torch.Tensor, inter_fifo: Sequence[torch.Tensor],
                          inter_vec, inter_w,
                          block_fifos: Sequence[Sequence[torch.Tensor]],
                          block_wsets: Sequence[Dict], head_vec, head_w, *,
                          num_blocks: int = 4, n_fifo: int = 1,
                          emit_layer_out: bool = True):
    """One slot's eval forward. ``y`` is the (N, h0, h0, c) slot input,
    ``inter_fifo`` the intermedia FIFO entries (N, h0, h0, c) and
    ``inter_vec`` / ``inter_w`` the intermedia adapter's folded (2, >=K)
    float32 vector and (>=K, c) weight, or None for slot 0.
    ``block_fifos`` / ``block_wsets``: per block position in traversal
    order (down 0..nb-1, neck, up nb-1..0), its ``n_fifo`` FIFO entries
    (N, r, r, g) and its weights as :func:`eval_slots` marshals them
    (``vec_b``, ``w_b``, ``shift2``, ``w3`` packed, ``vec_a``, ``w_a``
    [, ``vec_s``, ``w_s``]). ``head_vec`` / ``head_w``: the head's (2, c)
    vector and (c, >=class) weight; ``head_w`` may carry zero columns past
    the classes, and ``head_out``'s width is ``head_w``'s.

    Returns ``(y_out, head_out[, pre_out][, layer_outs...])`` as
    ``cunet_tpu/kernels/fused_hourglass.py::fused_hourglass_infer`` does:
    pre_out (the intermedia adapter's output) when the slot has one and
    ``emit_layer_out``, and with ``emit_layer_out`` each position's out32
    (N, r, r, g) in traversal order; all in y's dtype."""
    n, h0, _, c = y.shape
    nb = num_blocks
    dev, dt = y.device, y.dtype
    res = traversal_res(h0, nb)
    if len(block_fifos) != len(res) or len(block_wsets) != len(res):
        raise ValueError(f"{len(block_fifos)} FIFOs and {len(block_wsets)} "
                         f"weight sets for {len(res)} block positions")
    if any(len(f) != n_fifo for f in block_fifos) or (
            inter_w is not None and len(inter_fifo) != n_fifo):
        raise ValueError(f"every FIFO must hold n_fifo={n_fifo} entries")

    def empty(rows, cols):
        return torch.empty(rows, cols, device=dev, dtype=dt)

    def flat(t):
        return t.reshape(-1, t.shape[-1])

    m0 = n * h0 * h0
    pre = None
    x = flat(y)
    if inter_w is not None:
        pre = empty(m0, c)
        table_dot([x] + [flat(f) for f in inter_fifo], inter_vec, inter_w,
                  pre)
        x = pre
    cb, g = block_wsets[0]["w_b"].shape[1], block_wsets[0]["w3"].shape[1]
    yb = empty(m0, cb)            # relu(BN2(bottleneck)), reused per block
    skips: List[torch.Tensor] = []
    layer_outs: List[torch.Tensor] = []
    for pos, (fifo, ws) in enumerate(zip(block_fifos, block_wsets)):
        r = res[pos]
        m = n * r * r
        feats = ([x] + ([skips[2 * nb - pos]] if pos > nb else [])
                 + [flat(f) for f in fifo])
        y2 = yb[:m]
        table_dot(feats, ws["vec_b"], ws["w_b"], y2, bias=ws["shift2"])
        out32 = empty(m, g)
        conv3x3(y2, ws["w3"], n, r, r, out32)
        layer_outs.append(out32)
        feats.append(out32)
        ahead = empty(m, c)
        if pos < nb:                              # down: ahead + skip, pool
            skip = empty(m, c)
            table_dot(feats, ws["vec_a"], ws["w_a"], ahead,
                      vec_s=ws["vec_s"], w_s=ws["w_s"], out_s=skip)
            skips.append(skip)
            x = empty(m // 4, c)
            maxpool2(ahead, n, r, r, x)
        else:
            table_dot(feats, ws["vec_a"], ws["w_a"], ahead)
            if pos < 2 * nb:                      # neck and up: upsample
                x = empty(4 * m, c)
                upsample2(ahead, n, r, r, x)
            else:                                 # the slot output
                x = ahead
    head = empty(m0, head_w.shape[1])
    table_dot([x], head_vec, head_w, head)

    def img(t, r):
        return t.reshape(n, r, r, t.shape[-1])

    outs = [img(x, h0), img(head, h0)]
    if pre is not None and emit_layer_out:
        outs.append(img(pre, h0))
    if emit_layer_out:
        outs += [img(o, r) for o, r in zip(layer_outs, res)]
    return tuple(outs)
