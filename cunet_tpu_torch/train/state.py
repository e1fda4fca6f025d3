"""Train state and optimizer (counterpart of ``cunet_tpu/train/state.py``).

The optimizer is the reference recipe, ``torch.optim.RMSprop(lr=2.5e-4,
alpha=0.99, eps=1e-8)``: torch adds eps outside the square root, which is
what the JAX package's ``optax.rmsprop(eps_in_sqrt=False)`` reproduces. The
learning rate lives in the optimizer's ``param_groups``, read and set with
``get_lr`` / ``set_lr`` (the JAX package injects it as a hyperparameter).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from cunet_tpu_torch.config import TrainConfig


@dataclasses.dataclass
class TrainState:
    step: int                              # global step counter
    params: Dict[str, torch.Tensor]        # float32 leaves, requires_grad
    bn_state: Dict[str, torch.Tensor]      # BN running statistics
    opt: torch.optim.Optimizer


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.RMSprop:
    """RMSprop with the reference's torch semantics over ``params`` (an
    iterable of tensors)."""
    return torch.optim.RMSprop(list(params), lr=cfg.lr,
                               alpha=cfg.rmsprop_alpha, eps=cfg.rmsprop_eps)


def create_train_state(params, bn_state, cfg: TrainConfig) -> TrainState:
    """Float32 master copies of ``params`` that require grad, copies of
    ``bn_state``, and an RMSprop over the parameters."""
    master = {k: v.detach().float().clone().requires_grad_(True)
              for k, v in params.items()}
    stats = {k: v.detach().float().clone() for k, v in bn_state.items()}
    return TrainState(step=0, params=master, bn_state=stats,
                      opt=make_optimizer(cfg, master.values()))


def get_lr(state: TrainState) -> float:
    return float(state.opt.param_groups[0]["lr"])


def set_lr(state: TrainState, lr: float) -> TrainState:
    """Set the learning rate of every parameter group, in place (the
    reference mutates ``optimizer.param_groups`` the same way)."""
    for group in state.opt.param_groups:
        group["lr"] = float(lr)
    return state
