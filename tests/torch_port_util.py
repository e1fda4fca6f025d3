"""Shared helpers of the torch-port parity tests (tests/test_torch_port_*.py).

Weights are drawn with numpy into the JAX package's own tree structure, then
handed to both packages: to JAX as they are, to the port through
``cunet_tpu_torch.tools.from_jax`` (on the CPU: the port's entry points
default to the card). The draws keep activations of order one through every
slot (the JAX init shrinks them by orders of magnitude per slot, which would
let a fixed absolute tolerance pass anything). The tests build the JAX
package's configs; ``port_cfg`` turns one into the port's own.
"""

import dataclasses

import jax
import numpy as np

from cunet_tpu.config import ModelConfig
from cunet_tpu.models import init_cu_net as jax_init_cu_net
from cunet_tpu_torch import config as port_config
from cunet_tpu_torch.tools import from_jax as _bridge

SMALL = dict(neck_size=2, growth_rate=8, init_chan_num=16, class_num=4,
             num_blocks=2)
TOL = dict(rtol=2e-4, atol=2e-4)


def port_cfg(cfg):
    """The port's config (``cunet_tpu_torch.config``) of the same class
    name and fields as the JAX package's ``cfg``."""
    return getattr(port_config, type(cfg).__name__)(**dataclasses.asdict(cfg))


def from_jax(params_np, state_np, cfg, *, device="cpu"):
    """``cunet_tpu_torch.tools.from_jax.from_jax`` onto the CPU."""
    return _bridge.from_jax(params_np, state_np, port_cfg(cfg), device=device)


def small_cfg(layer_num=4, order=1, **kw) -> ModelConfig:
    return ModelConfig(layer_num=layer_num, order=order, loss_num=layer_num,
                       **{**SMALL, **kw})


def _leaf_name(path) -> str:
    return str(getattr(path[-1], "key", getattr(path[-1], "idx", "")))


def np_weights(cfg: ModelConfig, seed: int = 0):
    """(params, bn_state) trees of the JAX structure with numpy leaves."""
    params, state = jax_init_cu_net(jax.random.PRNGKey(0), cfg)
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = _leaf_name(path), np.shape(leaf)
        if name in ("conv", "conv2"):
            a = np.sqrt(3.0 / np.prod(shape[:3]))
            return rng.uniform(-a, a, shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (rng.randn(*shape) * 0.2).astype(np.float32)  # bias, mean

    return (jax.tree_util.tree_map_with_path(draw, params),
            jax.tree_util.tree_map_with_path(draw, state))


def images(n=2, size=32, seed=1):
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(
        np.float32)
