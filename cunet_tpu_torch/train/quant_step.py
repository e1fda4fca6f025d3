"""Quantized (WAGE / BIN) evaluation (counterpart of the eval half of
``cunet_tpu/train/quant_step.py``).

``quant_eval_params`` quantizes the weights once for a whole evaluation;
``quant_eval_step`` runs the eval forward on them with the activation
quantizers on. With ``QuantConfig(int8_infer=True)`` the 1x1 convs and the
3x3 convs run as integer products (the whole-model int8 kernels with
``use_pallas=True, pallas_whole_model=True, int8_impl="pallas"``, else the
plain path). Quantized training is not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch

from cunet_tpu.config import ModelConfig, QuantConfig
from cunet_tpu_torch.models import apply_cu_net
from cunet_tpu_torch.quant import (
    preprocess_masters,
    quantize_params,
    selected_conv_predicate,
)
from cunet_tpu_torch.train.loss import intermediate_mse


def quant_eval_params(params: Dict[str, torch.Tensor], qcfg: QuantConfig,
                      policy: str = "reference") -> Dict[str, torch.Tensor]:
    """Validation-time weights: the selected convs preprocessed and
    fake-quantized once (``bits_w == 1``: values in {-1, 0, +1})."""
    pred = selected_conv_predicate(params, policy)
    return quantize_params(preprocess_masters(params, qcfg, pred), qcfg, pred)


@torch.no_grad()
def quant_eval_step(params, bn_state, batch: Dict[str, torch.Tensor], *,
                    cfg: ModelConfig, qcfg: QuantConfig):
    """Eval forward with pre-quantized params (``quant_eval_params``
    output) and the activation quantizers on: the summed per-anchor loss
    and the final heatmaps."""
    outs, _ = apply_cu_net(params, bn_state, batch["image"], cfg=cfg,
                           quant=qcfg)
    return {"loss": intermediate_mse(outs, batch["heatmap"]),
            "last_out": outs[-1]}
