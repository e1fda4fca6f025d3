"""The two value-carried whole-model evals, on the whole-model kernels.

Counterparts of ``cunet_tpu/kernels/fused_model.py``: ``fused_model_infer``
(TPU kernel #2, the unrolled one-launch forward that returns the anchored
heads) and ``fused_model_loop_infer`` (TPU kernel #3, the same forward
with its steady slots looped over stacked weights, returning every slot's
head). On the TPU they carry the slots' FIFOs as VMEM values fed to each
stage through ``jnp.concatenate``; their math and rounding points are
those of ``fused_model_buf_infer`` (#1), whose channel-plane buffers only
drop the concats (``fused_model_buf.py:20``). So both run here as
:func:`cunet_tpu_torch.kernels.model_buf.model_buf_infer` over its four
kernels (``affine_dot``, ``conv3x3``, ``maxpool2``, ``upsample2``), asking
it for the heads each returns: their anchored heads are the whole-model
path's bit for bit. The loop variant's stacked weights and its loop exist
to bound Mosaic compile time and have no counterpart here. Both take the
slots of :func:`cunet_tpu_torch.models.cu_net.eval_slots` (float; BN
folded, padded) and the port's config instead of JAX's keyword list. The
port has no ``CUNET_TERA_IMPL`` knob, so no path dispatches to them: they
are functions with parity tests.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from cunet_tpu_torch.config import ModelConfig
from cunet_tpu_torch.kernels.model_buf import model_buf_infer


def fused_model_loop_infer(y_stem: torch.Tensor, slots: Sequence[Dict],
                           cfg: ModelConfig) -> torch.Tensor:
    """Post-stem forward of all K slots from the (N, h0, h0, c) stem output;
    returns every slot's head stacked as (N, K, h0, h0, class_num), the
    anchors picked outside (``cunet_tpu/models/cu_net.py:1441``)."""
    return model_buf_infer(y_stem, slots, cfg,
                           heads=range(1, cfg.layer_num + 1))


def fused_model_infer(y_stem: torch.Tensor, slots: Sequence[Dict],
                      cfg: ModelConfig) -> Tuple[torch.Tensor, ...]:
    """Post-stem forward of all K slots from the (N, h0, h0, c) stem output;
    returns the anchored heads, each (N, h0, h0, class_num), as a tuple in
    slot order. Unanchored slots run no head."""
    out = model_buf_infer(y_stem, slots, cfg)
    return tuple(out[:, a] for a in range(out.shape[1]))
