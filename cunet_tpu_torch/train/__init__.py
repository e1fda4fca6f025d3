"""Training: loss, state and optimizer, train and eval steps (counterpart of
``cunet_tpu.train``)."""

from cunet_tpu_torch.train.loss import intermediate_mse
from cunet_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    get_lr,
    make_optimizer,
    set_lr,
)
from cunet_tpu_torch.train.quant_step import (
    quant_eval_params,
    quant_eval_step,
    quant_train_step,
)
from cunet_tpu_torch.train.step import eval_step, train_step

__all__ = [
    "TrainState",
    "create_train_state",
    "eval_step",
    "get_lr",
    "intermediate_mse",
    "make_optimizer",
    "quant_eval_params",
    "quant_eval_step",
    "quant_train_step",
    "set_lr",
    "train_step",
]
