"""WAGE quantization: primitives, straight-through gradients and the
model-level transforms (counterpart of ``cunet_tpu.quant``)."""

from cunet_tpu_torch.quant.transforms import (
    preprocess_masters,
    quantize_params,
    selected_conv_predicate,
)
from cunet_tpu_torch.quant.wage import (
    binarize_weight,
    binarize_weight_value,
    binarize_weight_value_ref,
    clip_c,
    fake_quant_weight,
    fixedpoint_weight_value,
    meancenter_clamp_weight,
    meancenter_clamp_weight_bin,
    quan_input,
    quant_q,
    scale_s,
    ternarize_weight_value,
)

__all__ = [
    "binarize_weight",
    "binarize_weight_value",
    "binarize_weight_value_ref",
    "clip_c",
    "fake_quant_weight",
    "fixedpoint_weight_value",
    "meancenter_clamp_weight",
    "meancenter_clamp_weight_bin",
    "preprocess_masters",
    "quan_input",
    "quant_q",
    "quantize_params",
    "scale_s",
    "selected_conv_predicate",
    "ternarize_weight_value",
]
