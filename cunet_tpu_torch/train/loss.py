"""Intermediate-supervision heatmap loss (counterpart of
``cunet_tpu/train/loss.py::intermediate_mse``)."""

from __future__ import annotations

from typing import Sequence

import torch


def intermediate_mse(outputs: Sequence[torch.Tensor],
                     target: torch.Tensor) -> torch.Tensor:
    """Sum over anchored outputs of the MSE against the same target
    heatmaps, in float32."""
    t = target.float()
    return sum(((o.float() - t) ** 2).mean() for o in outputs)
