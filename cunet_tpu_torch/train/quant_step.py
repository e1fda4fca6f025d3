"""Quantized (WAGE / BIN) training and evaluation (counterpart of
``cunet_tpu/train/quant_step.py``).

``quant_train_step`` is the reference's per-batch protocol (quantize,
forward, backward, restore, correct the gradients, step) as one step: the
masters are preprocessed (meancenter, clamp, round to bits_g) and written
back into the optimizer's parameter tensors, the forward runs on
``quantize_params`` of them, whose autograd carries the XNOR and
gradient-quantization corrections, and RMSprop steps on the masters. The
activation quantizers run on either train path, inside the slot train
kernels with ``use_pallas=True, bn_tile > 0``.

``quant_eval_params`` quantizes the weights once for a whole evaluation;
``quant_eval_step`` runs the eval forward on them with the activation
quantizers on. With ``QuantConfig(int8_infer=True)`` the 1x1 convs and the
3x3 convs run as integer products (the whole-model int8 kernels with
``use_pallas=True, pallas_whole_model=True, int8_impl="pallas"``, else the
plain path).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from cunet_tpu_torch.config import ModelConfig, QuantConfig
from cunet_tpu_torch.models import apply_cu_net
from cunet_tpu_torch.quant import (
    preprocess_masters,
    quantize_params,
    selected_conv_predicate,
)
from cunet_tpu_torch.train.loss import intermediate_mse
from cunet_tpu_torch.train.state import TrainState
from cunet_tpu_torch.train.step import step_drop_args


def quant_train_step(state: TrainState, batch: Dict[str, torch.Tensor], *,
                     cfg: ModelConfig, qcfg: QuantConfig,
                     policy: str = "reference",
                     generator: Optional[torch.Generator] = None,
                     rng=None):
    """One quantized optimization step (``qcfg`` enabled; the JAX
    package's ``quant_train_step``). Updates ``state`` in place: the
    selected master weights become their preprocessed values (written into
    the same tensors, so RMSprop's per-tensor state follows them), then
    take one RMSprop step on the gradients through ``quantize_params``.
    Returns ``(state, {"loss", "last_out"})``; with dropout, ``generator``
    gives the step's mask seeds, or ``rng`` its threefry key
    (``drop_impl="masks"``), as in ``train_step``."""
    pred = selected_conv_predicate(state.params, policy)
    with torch.no_grad():
        for key, m in preprocess_masters(state.params, qcfg, pred).items():
            if m is not state.params[key]:
                state.params[key].copy_(m)
    state.opt.zero_grad(set_to_none=True)
    outs, new_bn = apply_cu_net(
        quantize_params(state.params, qcfg, pred), state.bn_state,
        batch["image"], cfg=cfg, train=True, quant=qcfg,
        **step_drop_args(cfg, state.step, generator, rng))
    loss = intermediate_mse(outs, batch["heatmap"])
    loss.backward()
    state.opt.step()
    state.bn_state = {k: v.detach() for k, v in new_bn.items()}
    state.step += 1
    return state, {"loss": loss.detach(), "last_out": outs[-1].detach()}


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
