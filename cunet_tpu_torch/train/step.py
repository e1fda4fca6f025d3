"""Train and eval steps on one device (counterpart of
``cunet_tpu/train/step.py::train_step`` / ``eval_step``).

A train step is the hot loop of the reference (forward, intermediate-
supervision MSE, backward, one RMSprop step) plus the new BN running
statistics and ``step + 1``. The model path follows the config: with
``use_pallas=True, bn_tile > 0`` every slot runs the hand-written train
kernels on a CUDA device (their plain versions on the CPU). A dropout
config (``drop_rate > 0``) draws one int32 seed per slot per step from the
caller's ``torch.Generator`` (``ops.dropmask.draw_slot_seeds``), where the
JAX package folds the step into a threefry key. The sharded and shard_map
steps of the JAX package are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from cunet_tpu_torch.config import ModelConfig
from cunet_tpu_torch.models import apply_cu_net
from cunet_tpu_torch.ops.dropmask import draw_slot_seeds
from cunet_tpu_torch.train.loss import intermediate_mse
from cunet_tpu_torch.train.state import TrainState


def step_drop_seeds(cfg: ModelConfig,
                    generator: Optional[torch.Generator]):
    """This step's per-slot dropout seeds, or None without dropout."""
    if cfg.drop_rate <= 0:
        return None
    if generator is None:
        raise ValueError("a dropout config (drop_rate > 0) needs a "
                         "torch.Generator for its per-step mask seeds")
    return draw_slot_seeds(generator, cfg.layer_num)


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], *,
               cfg: ModelConfig, generator: Optional[torch.Generator] = None):
    """One optimization step on ``batch = {"image": NHWC, "heatmap":
    NHWC}``. Updates ``state`` in place (parameters, optimizer moments, BN
    statistics, step) and returns ``(state, {"loss", "last_out"})``; the
    parameters' ``.grad`` hold this step's gradients afterwards. With
    dropout, ``generator`` gives the step's mask seeds."""
    state.opt.zero_grad(set_to_none=True)
    outs, new_bn = apply_cu_net(state.params, state.bn_state, batch["image"],
                                cfg=cfg, train=True,
                                drop_seeds=step_drop_seeds(cfg, generator))
    loss = intermediate_mse(outs, batch["heatmap"])
    loss.backward()
    state.opt.step()
    state.bn_state = {k: v.detach() for k, v in new_bn.items()}
    state.step += 1
    return state, {"loss": loss.detach(), "last_out": outs[-1].detach()}


@torch.no_grad()
def eval_step(params, bn_state, batch: Dict[str, torch.Tensor], *,
              cfg: ModelConfig):
    """Validation forward: the summed per-anchor loss and the final
    heatmaps."""
    outs, _ = apply_cu_net(params, bn_state, batch["image"], cfg=cfg)
    return {"loss": intermediate_mse(outs, batch["heatmap"]),
            "last_out": outs[-1]}
