"""Model-level quantization transforms over the port's flat parameter dict.

Counterpart of ``cunet_tpu/quant/transforms.py``: the reference's stateful
QuanOp / BinOp controller as two pure transforms,

1. ``preprocess_masters(params)``: meancenter + clamp + round-to-bits_g of
   the selected conv weights (what the optimizer steps on);
2. ``quantize_params(params)``: fake-quant of each selected weight through
   :func:`cunet_tpu_torch.quant.wage.fake_quant_weight`, whose backward is
   the reference's gradient correction.

Keys are the port's dotted paths (``hg.down.0.layers.3.conv2``); the JAX
package's ``/conv`` and ``/conv2`` suffixes are ``.conv`` and ``.conv2``
here. Selection policy ``"reference"`` quantizes every conv except the
first and last in the reference's module-traversal order: the stem and,
through its registration order, the *last intermedia adapter*, not the last
head. ``"heads_out"`` excludes the stem and all heads; ``"all"`` excludes
the stem only. The port stores no stacked slots, so JAX's ``all_but_last``
sentinel has no counterpart.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from cunet_tpu_torch.config import QuantConfig
from cunet_tpu_torch.quant.wage import (
    binarize_weight,
    fake_quant_weight,
    meancenter_clamp_weight,
    meancenter_clamp_weight_bin,
)

KeyPredicate = Callable[[str], bool]
POLICIES = ("reference", "heads_out", "all")


def selected_conv_predicate(params: Dict[str, torch.Tensor],
                            policy: str = "reference") -> KeyPredicate:
    """Predicate over parameter keys choosing the quantized conv weights."""
    if policy not in POLICIES:
        raise ValueError(f"unknown selection policy: {policy}")
    n_inter = sum(1 for k in params
                  if k.startswith("intermedia.adapters.")
                  and k.endswith(".conv"))
    last_inter = f"intermedia.adapters.{n_inter - 1}.conv"

    def pred(key: str) -> bool:
        if not (key.endswith(".conv") or key.endswith(".conv2")):
            return False
        if key.startswith("stem."):
            return False
        if policy == "reference":
            return key != last_inter
        if policy == "heads_out":
            return not key.startswith("heads.")
        return True

    return pred


def _map_selected(fn, params, pred: KeyPredicate):
    return {k: fn(v) if v.dim() == 4 and pred(k) else v
            for k, v in params.items()}


def preprocess_masters(params, qcfg: QuantConfig, pred: KeyPredicate):
    """Per-step master-weight preprocessing (meancenter, clamp, round to
    bits_g; the BinOp protocol, ``bits_w == 1`` with ``bits_g > 15``, does
    not round)."""
    if qcfg.bits_w == 1 and qcfg.bits_g > 15:
        return _map_selected(meancenter_clamp_weight_bin, params, pred)
    return _map_selected(lambda w: meancenter_clamp_weight(w, qcfg.bits_g),
                         params, pred)


def quantize_params(params, qcfg: QuantConfig, pred: KeyPredicate):
    """Fake-quant the selected conv weights for the forward pass; gradients
    through it carry the XNOR / straight-through corrections."""
    if qcfg.bits_w == 1 and qcfg.bits_g > 15:
        return _map_selected(lambda w: binarize_weight(w, qcfg.bits_g),
                             params, pred)
    return _map_selected(
        lambda w: fake_quant_weight(w, qcfg.bits_w, qcfg.bits_g), params,
        pred)
