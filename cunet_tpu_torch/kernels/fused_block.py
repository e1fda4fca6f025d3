"""One dense block's eval forward on the hand-written kernels, with the
hourglass's upsample folded into its reads and its pool into its store.

Counterpart of ``cunet_tpu/kernels/fused_block.py::fused_dense_block_infer``
(TPU kernel #5), with JAX's signature minus ``interpret``. The TPU version
is one Pallas program per image whose stages stay in VMEM; here each stage
is one launch of a hand-written kernel, three to five per block:

1. the optional pre-stage (the intermedia adapter riding the first down
   block): ``table_dot`` over ``pre_features``; its output, rounded to the
   compute dtype, becomes feature 0;
2. the bottleneck over the features (feature 0 read through a 2x nearest
   upsample with ``upsample_first``: ``table_dot[up]``) with BN2's full
   affine on the float32 sum, rounded once (``table_dot[scale]``): #5 takes
   BN2 unfolded, unlike #1 and #4, whose bottleneck weights carry its scale;
3. the 3x3 conv, ``conv3x3`` (the whole-model path's kernel), giving out32;
4. the ahead adapter over the features and out32, with a down block's
   skip adapter from the same read (``table_dot[dual]``) and the ahead
   output stored 2x2-max-pooled with ``pool_ahead`` (``table_dot[pool]``):
   no full-resolution ahead tensor and no ``maxpool2`` launch exist;
5. the optional head over the (full-resolution) ahead output.

Rounding points are the TPU kernel's (``fused_block.py:104-204``): pre_out,
relu(BN2(bottleneck)), out32, the adapters' outputs and the head round to
the compute dtype; the pool takes the max of the rounded ahead. The
features are NHWC tensors, read in place; the 1x1 weights are (K, Cout)
matrices or (1, 1, K, Cout) convs (a row and column prefix is read), the
3x3 weight HWIO or ``pack_w3``-packed, the BN vectors float32 (2, C)
[inv; shift]. On CPU tensors every kernel's plain version runs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from cunet_tpu_torch.kernels.buf_ops import conv3x3
from cunet_tpu_torch.kernels.eval_ops import table_dot


def _mat(w: torch.Tensor, dt) -> torch.Tensor:
    """A 1x1 conv's (K, Cout) matrix in the compute dtype (no copy when it
    is one already)."""
    return (w[0, 0] if w.dim() == 4 else w).to(dt)


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def fused_dense_block_infer(
    features: Sequence[torch.Tensor],
    bneck_vec: torch.Tensor,
    bneck_w: torch.Tensor,
    vec2: torch.Tensor,
    w3: torch.Tensor,
    ahead_vec: torch.Tensor,
    ahead_w: torch.Tensor,
    skip_vec: Optional[torch.Tensor] = None,
    skip_w: Optional[torch.Tensor] = None,
    *,
    pre_features: Optional[Sequence[torch.Tensor]] = None,
    pre_vec: Optional[torch.Tensor] = None,
    pre_w: Optional[torch.Tensor] = None,
    emit_pre_out: bool = True,
    head_vec: Optional[torch.Tensor] = None,
    head_w: Optional[torch.Tensor] = None,
    upsample_first: bool = False,
    pool_ahead: bool = False,
    emit_layer_out: bool = True,
):
    """One dense block's eval (see the module docstring).

    ``features`` are NHWC; with ``upsample_first`` the first enters at half
    resolution. With ``pre_w`` a 1x1 bottleneck over ``pre_features``
    (``pre_vec``) becomes feature 0, and ``features[0]`` only donates its
    shape; with ``head_w`` a BN -> ReLU -> 1x1 head (``head_vec``) runs on
    the ahead output. Returns ``(ahead[, skip][, layer_out][, head_out]
    [, pre_out])`` as ``cunet_tpu/kernels/fused_block.py::
    fused_dense_block_infer`` does, each NHWC in the features' dtype;
    ahead is 2x2-max-pooled with ``pool_ahead``, pre_out returned with
    ``emit_pre_out``, layer_out (out32) with ``emit_layer_out``."""
    pre = pre_w is not None
    skip = skip_w is not None
    head = head_w is not None
    if pre and upsample_first:
        raise ValueError("the pre-stage excludes upsample_first")
    if head and pool_ahead:
        raise ValueError("the head reads the full-resolution ahead output, "
                         "which pool_ahead does not store")
    f0 = features[0]
    n = f0.shape[0]
    h = f0.shape[1] * (2 if upsample_first else 1)
    w = f0.shape[2] * (2 if upsample_first else 1)
    m = n * h * w
    dev, dt = f0.device, f0.dtype
    wb, wa = _mat(bneck_w, dt), _mat(ahead_w, dt)
    cb, cout = wb.shape[1], wa.shape[1]
    w3p = (w3.reshape(-1, w3.shape[-1]) if w3.dim() == 4 else w3).to(dt)
    g = w3p.shape[1]

    def empty(rows, cols):
        return torch.empty(rows, cols, device=dev, dtype=dt)

    feats: List[torch.Tensor] = [_flat(f) for f in features]
    pre_out = None
    if pre:
        wp = _mat(pre_w, dt)
        pre_out = empty(m, wp.shape[1])
        table_dot([_flat(f) for f in pre_features], pre_vec, wp, pre_out)
        feats[0] = pre_out
    up = [upsample_first] + [False] * (len(feats) - 1)
    hw = (h, w)
    yb = empty(m, cb)
    table_dot(feats, bneck_vec, wb, yb, vec2=vec2, up=up, hw=hw)
    out32 = empty(m, g)
    conv3x3(yb, w3p, n, h, w, out32)
    feats.append(out32)
    ahead = empty(m // 4 if pool_ahead else m, cout)
    kw = dict(up=up + [False], pool=pool_ahead, hw=hw)
    outs = [ahead]
    if skip:
        sk = empty(m, cout)
        table_dot(feats, ahead_vec, wa, ahead, vec_s=skip_vec,
                  w_s=_mat(skip_w, dt), out_s=sk, **kw)
        outs.append(sk)
    else:
        table_dot(feats, ahead_vec, wa, ahead, **kw)
    if emit_layer_out:
        outs.append(out32)
    if head:
        wh = _mat(head_w, dt)
        hm = empty(m, wh.shape[1])
        table_dot([ahead], head_vec, wh, hm)
        outs.append(hm)
    if pre and emit_pre_out:
        outs.append(pre_out)
    ho, wo = (h // 2, w // 2) if pool_ahead else (h, w)
    res = [outs[0].view(n, ho, wo, cout)]
    return tuple(res + [t.view(n, h, w, t.shape[-1]) for t in outs[1:]])
