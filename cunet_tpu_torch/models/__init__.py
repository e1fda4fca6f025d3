from cunet_tpu_torch.models.cu_net import (
    apply_cu_net,
    apply_slot_train,
    dense_block_channels,
    empty_fifos,
    init_cu_net,
    param_shapes,
    slot_args,
)

__all__ = [
    "apply_cu_net",
    "apply_slot_train",
    "dense_block_channels",
    "empty_fifos",
    "init_cu_net",
    "param_shapes",
    "slot_args",
]
