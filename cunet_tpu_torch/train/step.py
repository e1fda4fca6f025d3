"""Train and eval steps on one device (counterpart of
``cunet_tpu/train/step.py::train_step`` / ``eval_step``).

A train step is the hot loop of the reference (forward, intermediate-
supervision MSE, backward, one RMSprop step) plus the new BN running
statistics and ``step + 1``. The model path follows the config: with
``use_pallas=True, bn_tile > 0`` every slot runs the hand-written train
kernels on a CUDA device (their plain versions on the CPU). A dropout
config (``drop_rate > 0``) with ``drop_impl="prng"`` draws one int32 seed
per slot per step from the caller's ``torch.Generator``
(``ops.dropmask.draw_slot_seeds``); with ``drop_impl="masks"`` it folds the
step into the caller's threefry key ``rng``, as the JAX package's
``train_step`` does, and draws JAX's masks. The sharded and shard_map steps
of the JAX package are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from cunet_tpu_torch.config import ModelConfig
from cunet_tpu_torch.models import apply_cu_net
from cunet_tpu_torch.ops import threefry
from cunet_tpu_torch.ops.dropmask import draw_slot_seeds
from cunet_tpu_torch.train.loss import intermediate_mse
from cunet_tpu_torch.train.state import TrainState


def step_drop_args(cfg: ModelConfig, step: int,
                   generator: Optional[torch.Generator], rng) -> Dict:
    """This step's dropout arguments of ``apply_cu_net``: ``drop_seeds``
    drawn from ``generator`` (``drop_impl="prng"``), or ``drop_key`` =
    ``fold_in(rng, step)`` (``"masks"``; ``rng`` a (2,) uint32 threefry
    key as a numpy array, a tensor or a pair of ints); none without
    dropout."""
    if cfg.drop_rate <= 0:
        return {}
    if cfg.drop_impl == "masks":
        if rng is None:
            raise ValueError("drop_impl='masks' needs rng=, a (2,) uint32 "
                             "threefry key (a torch.Generator serves "
                             "drop_impl='prng' only)")
        return {"drop_key": threefry.fold_in(threefry.as_key(rng), step)}
    if generator is None:
        raise ValueError("a dropout config (drop_rate > 0) needs a "
                         "torch.Generator for its per-step mask seeds")
    return {"drop_seeds": draw_slot_seeds(generator, cfg.layer_num)}


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], *,
               cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               rng=None):
    """One optimization step on ``batch = {"image": NHWC, "heatmap":
    NHWC}``. Updates ``state`` in place (parameters, optimizer moments, BN
    statistics, step) and returns ``(state, {"loss", "last_out"})``; the
    parameters' ``.grad`` hold this step's gradients afterwards. With
    dropout, ``generator`` gives the step's mask seeds
    (``drop_impl="prng"``), or ``rng`` the threefry key that the step is
    folded into (``"masks"``)."""
    state.opt.zero_grad(set_to_none=True)
    outs, new_bn = apply_cu_net(state.params, state.bn_state, batch["image"],
                                cfg=cfg, train=True,
                                **step_drop_args(cfg, state.step, generator,
                                                 rng))
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
