"""cunet_tpu_torch — CU-Net serving and training in PyTorch, with
hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

A port of ``cunet_tpu`` (JAX/Pallas on a TPU), which stays in the repository
as the reference. Module names mirror the JAX package: ``ops.layers``,
``ops.bottleneck``, ``models.cu_net``, ``kernels.model_buf`` (the counterpart
of ``kernels/fused_model_buf.py``), ``kernels.train_slot``, ``train``,
``evaluation.decode``, ``serving``, ``quant`` (WAGE quantization),
``kernels.quant_matmul`` and ``kernels.quant_ops`` (the int8 forward),
``ops.dropmask`` (the counter-hash dropout masks). The configuration
dataclasses (``config``) and the crop geometry (``geometry``) are the
port's own copies: nothing in this package imports JAX or ``cunet_tpu``.
"""

from cunet_tpu_torch.config import ModelConfig, QuantConfig, TrainConfig

__all__ = ["ModelConfig", "QuantConfig", "TrainConfig"]
