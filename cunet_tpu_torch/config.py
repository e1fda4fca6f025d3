"""Configuration dataclasses of the port.

The port's own copy of ``cunet_tpu/config.py``: the same classes, fields,
defaults and checks, so a configuration means the same model in both
packages (``dataclasses.asdict`` of one builds the other). Knobs that only
steer the JAX package's TPU programs (``use_scan``, ``pallas_hourglass``,
``conv3x3_impl``) are kept for that reason and are read by the port where
it has a counterpart.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


def _round_half_up(x: float) -> int:
    """Python 2's ``round`` (halves away from zero): the reference computes
    its loss anchors with it, and Python 3's rounding to even would move
    the anchors on exact ties."""
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


def loss_anchors(layer_num: int, loss_num: int) -> Tuple[int, ...]:
    """``loss_num`` supervision anchors spread over ``layer_num`` U-Nets:
    ``anchor_j = round(K / loss_num * (j + 1))``, at most ``layer_num``;
    the last U-Net always carries a loss. Anchors are 1-indexed U-Net
    counts (anchor ``a``: the output of U-Net ``a - 1`` gets a head)."""
    if not (1 <= loss_num <= layer_num):
        raise ValueError(
            f"loss_num must satisfy 1 <= loss_num <= layer_num, got "
            f"loss_num={loss_num}, layer_num={layer_num}"
        )
    loss_every = float(layer_num) / float(loss_num)
    anchors = []
    for j in range(loss_num):
        a = _round_half_up(loss_every * (j + 1))
        if a <= layer_num:
            anchors.append(a)
    if layer_num not in anchors:
        raise ValueError(f"final U-Net has no loss anchor: {anchors}")
    if len(anchors) != loss_num:
        raise ValueError(f"anchor collision: {anchors}")
    return tuple(anchors)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of the order-K coupled U-Net and how it runs."""

    layer_num: int = 2          # K, number of coupled U-Nets
    order: int = 1              # coupling order (FIFO depth of cross-U-Net links)
    class_num: int = 16         # output heatmap channels
    loss_num: int = 2           # number of supervised anchors
    neck_size: int = 4          # bottleneck width multiplier (1x1 conv out = neck*growth)
    growth_rate: int = 32
    init_chan_num: int = 128
    num_blocks: int = 4         # down/up steps per hourglass
    drop_rate: float = 0.0
    drop_impl: str = "prng"     # dropout mask source when drop_rate > 0:
                                # "prng"  -- counter-hash masks from one
                                #            int32 seed per slot
                                #            (ops/dropmask.py)
                                # "masks" -- JAX's threefry bernoulli
                                #            masks from a (2,) uint32
                                #            key (ops/threefry.py)
    compute_dtype: str = "float32"   # "bfloat16" for the tensor cores
    param_dtype: str = "float32"
    remat: str = "bottleneck"        # none | bottleneck | layer | block
    use_pallas: bool = False         # run the hand-written kernels
    pallas_hourglass: bool = True    # JAX: whole-slot eval program
    pallas_whole_model: bool = False # whole post-stem eval forward on kernels
    use_scan: bool = True            # JAX: lax.scan over steady slots
    conv3x3_impl: str = "lax"        # JAX: "lax" | "scatter" 3x3 conv form
    bn_dtype: str = "float32"        # BN affine dtype: "float32" (torch
                                     # parity) | "compute" (f32 statistics,
                                     # affine in compute_dtype)
    bn_tile: int = 0                 # ghost BN: train batch-statistics group
                                     # in images (0 = whole batch); the
                                     # running statistics take the tile
                                     # average. The slot train kernels need
                                     # bn_tile > 0.

    def __post_init__(self):
        if self.order >= self.layer_num:
            raise ValueError(
                f"order ({self.order}) must be < layer_num ({self.layer_num})"
            )
        if self.remat not in ("none", "bottleneck", "layer", "block"):
            raise ValueError(f"unknown remat policy: {self.remat}")
        if self.conv3x3_impl not in ("lax", "scatter"):
            raise ValueError(f"unknown conv3x3_impl: {self.conv3x3_impl}")
        if self.bn_dtype not in ("float32", "compute"):
            raise ValueError(f"unknown bn_dtype: {self.bn_dtype}")
        if self.drop_impl not in ("prng", "masks"):
            raise ValueError(f"unknown drop_impl: {self.drop_impl}")
        loss_anchors(self.layer_num, self.loss_num)  # validate

    @property
    def anchors(self) -> Tuple[int, ...]:
        return loss_anchors(self.layer_num, self.loss_num)

    @property
    def bottleneck_chan(self) -> int:
        return self.neck_size * self.growth_rate


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """WAGE quantization bit-widths; ``bits > 15`` disables quantization of
    that tensor class."""

    bits_w: int = 1
    bits_i: int = 8
    bits_g: int = 8
    enabled: bool = False
    # int8 execution of the binarized 1x1 and 3x3 convs at inference, with
    # the activations quantized to bits_i at every 1x1 conv input too
    int8_infer: bool = False
    int8_impl: str = "pallas"   # "pallas" (the int8 kernels) | "lax" (plain)

    def __post_init__(self):
        if self.int8_infer:
            if self.bits_w != 1:
                raise ValueError("int8_infer requires binarized weights (bits_w=1)")
            if not (2 < self.bits_i <= 8):
                raise ValueError("int8_infer requires 3..8 activation bits")
            if self.int8_impl not in ("pallas", "lax"):
                raise ValueError(f"unknown int8_impl: {self.int8_impl}")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization recipe."""

    lr: float = 2.5e-4
    rmsprop_alpha: float = 0.99
    rmsprop_eps: float = 1e-8
    batch_size: int = 24
    n_epochs: int = 200
    schedule: str = "mpii"      # "mpii" (x0.2@101,x0.5@141,x0.5@161) | "face" (@30/60/90) | "none"
    print_freq: int = 10
    seed: int = 0
    dp: int = 1                 # data-parallel size
    sp: int = 1                 # spatial-partition size (shards H)
