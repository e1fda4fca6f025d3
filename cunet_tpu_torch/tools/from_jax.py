"""JAX parameter trees -> the port's flat tensor dicts.

``cunet_tpu`` keeps parameters and BN running statistics as nested pytrees
(dicts of lists of dicts of arrays); ``cunet_tpu/tools/convert_torch.py``
maps the reference's torch names onto those trees. This bridge goes the
other way, from the JAX trees to the port: every leaf becomes a torch
tensor keyed by its dotted tree path (``hg.down.0.layers.3.bottleneck.conv``,
``heads.7.norm.mean``), the layout of :mod:`cunet_tpu_torch.models.cu_net`.

The trees arrive with numpy leaves (``jax.tree_util.tree_map(np.asarray,
...)`` on the JAX side); this module never imports JAX. Only the canonical
per-slot-list storage is accepted: the stacked ``{"prefix", "steady"}``
containers of ``cunet_tpu.models.cu_net.stack_steady`` must be
``unstack_steady``-ed first.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from cunet_tpu_torch.config import ModelConfig


def flatten_tree(tree) -> Dict[str, np.ndarray]:
    """Nested dicts / lists of arrays -> {dotted path: array}."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, dict):
            if set(node) == {"prefix", "steady"}:
                raise ValueError(
                    f"stacked slot container at '{path or '<root>'}': "
                    "convert it with cunet_tpu.models.cu_net.unstack_steady "
                    "before bridging")
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}" if path else str(i))
        else:
            out[path] = np.asarray(node)

    walk(tree, "")
    return out


def _to_torch(flat: Dict[str, np.ndarray], device):
    return {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in flat.items()}


def _check(flat, shapes, what):
    missing = sorted(set(shapes) - set(flat))
    extra = sorted(set(flat) - set(shapes))
    wrong = sorted(k for k in set(flat) & set(shapes)
                   if tuple(flat[k].shape) != tuple(shapes[k]))
    if missing or extra or wrong:
        raise ValueError(
            f"{what} tree does not match the config: missing {missing[:5]} "
            f"({len(missing)}), unexpected {extra[:5]} ({len(extra)}), "
            f"wrong shape {[(k, flat[k].shape, shapes[k]) for k in wrong[:5]]} "
            f"({len(wrong)})")


def from_jax(params_np, state_np, cfg: ModelConfig, *, device="cuda"
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(params, bn_state) JAX trees with numpy leaves -> (params, state)
    flat dicts of float32 tensors on ``device`` (the card unless the caller
    asks for the CPU).

    Every leaf is checked against the shapes the port expects for ``cfg``
    (no leaf missing, none left over, none of another shape); a mismatch
    raises ``ValueError``."""
    from cunet_tpu_torch.models.cu_net import param_shapes

    p_flat = flatten_tree(params_np)
    s_flat = flatten_tree(state_np)
    p_shapes, s_shapes = param_shapes(cfg)
    _check(p_flat, p_shapes, "params")
    _check(s_flat, s_shapes, "bn_state")
    return _to_torch(p_flat, device), _to_torch(s_flat, device)
