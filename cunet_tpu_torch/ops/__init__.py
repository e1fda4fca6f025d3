"""NN ops on NHWC tensors, eval and train mode (counterpart of
``cunet_tpu.ops``)."""

from cunet_tpu_torch.ops.bottleneck import (
    dense_bottleneck,
    dense_bottleneck_infer_pallas,
    dense_bottleneck_remat,
    dense_bottleneck_train_pallas,
)
from cunet_tpu_torch.ops.layers import (
    BN_EPS,
    batch_norm,
    bn_inference_scale_shift,
    conv2d,
    conv3x3_scatter,
    max_pool_2x2,
    relu,
    upsample_nearest_2x,
)

__all__ = [
    "BN_EPS",
    "batch_norm",
    "bn_inference_scale_shift",
    "conv2d",
    "conv3x3_scatter",
    "dense_bottleneck",
    "dense_bottleneck_infer_pallas",
    "dense_bottleneck_remat",
    "dense_bottleneck_train_pallas",
    "max_pool_2x2",
    "relu",
    "upsample_nearest_2x",
]
