#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (cunet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line (or a few) before the last:

1. build: the card's name and power limit, torch/CUDA versions, and the
   nvcc build of the kernels from cunet_tpu_torch/csrc;
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes the CU-Net-8 @256 forward gives it (batch 8;
   affine_dot and conv3x3 at every resolution, and at r=64 at batch 64 too,
   affine_dot at every stage width), reading and writing strided views of
   channel-plane buffers;
3. serving: a Predictor for CU-Net-8 @256 (order 1, 16 classes, 8 loss
   anchors, bf16, kernel path) with random weights from seed 0 answers
   three requests of 8, 5 and 11 images with the flip test; checks shapes,
   finiteness, that every kernel launched, and the kernel path against the
   plain path on the card; times the forward at batch 8 and 64;
4. train kernels: each kernel of the slot train step (and the per-tile
   forms of affine_dot / conv3x3) against its plain version on the card at
   the shapes the CU-Net-8 @256 train step gives it (batch 24, ghost-BN
   tile 2; the GEMMs and convs at every resolution);
5. training: CU-Net-8 @256 (bf16, bn_tile 2, bn_dtype "compute", RMSprop)
   at batch 24 from the port's init (seed 0), numpy images and Gaussian
   target heatmaps: slot 1 alone, kernel path against plain path under a
   cotangent on each output in turn (every input cotangent, weight
   gradient, output and running-stat update, held to a plain-vs-plain
   control); one kernel-path step against one plain-path step from
   the same state (loss, grad-norm ratio, per-leaf cosine against a
   plain-vs-plain control, head grads, BN running stats), a bit-identical
   repeat, three kernel-path train_steps
   that launch every kernel, and the step time, img/s and peak memory of
   both paths;
6. int8 serving: the three int8 kernels against their plain versions at
   the CU-Net-8 @256 int8 shapes and ragged ones (bit-identical), the
   whole-model pair (``csrc/i8_kernels.cu``) also at batches 64 and 256,
   order 14's widest K, a streamed K and the 68-class head; a
   Predictor for the quantized CU-Net-8 (``bench.py``'s int8
   configuration: W1/I8/G8, ``int8_infer``, ``int8_impl="pallas"``;
   ``quant_eval_params`` of the port's init, seed 0) answers the three
   requests on the int8 kernel path (the main path), which must launch the
   int8 kernels; the same forward on the int8 kernels' plain versions is
   bit-identical; the plain path on ``int8_matmul_dequant`` (the second
   path) is bit-identical to ``int8_impl="lax"``; the kernel path against
   the plain path beside a same-run control; forward times at batch 8 and
   64 beside the float kernel path's;
7. dropout training, CU-Net-8 @256 with drop_rate 0.2 (``bench.py``'s
   ``cu_net8_256_train_drop0.2``): the dropout-mask kernel against the
   plain masks at the train shapes (batch 24, tile 2): on ones
   bit-identical to the plain tile masks at every traversal position
   (r = 64..4, 12 tiles, a negative seed), conv3x3 plus mask bit-identical
   to the undropped kernel output times the plain mask, the backward form
   bit-identical, the drop fraction of a full out32; then the kernel step
   against the plain step from the same state and seeds in phase 5's
   bands, a bit-identical repeat, three ``train_step``s from a generator
   on the kernel path (the main path: every kernel and the mask kernel
   launch), step times of both paths;
8. quantized training, the same model with ``QuantConfig(bits_w=1,
   bits_i=8, bits_g=8, enabled=True)`` (``cu_net8_256_quant_w1i8g8_train``):
   the QuanInput options of the train kernels against their plain
   versions (the quantized prologues within phase 4's bounds, the
   straight-through gate exact on values that straddle 1.0 after bf16
   rounding), and the quantizer of each quantized prologue bit for bit
   through products made exact (identity and one-hot weights, {0, 1}
   cotangents); then ``quant_train_step``'s kernel step against its plain
   step, each comparison held to at most CONTROL_FACTOR times a
   plain-vs-plain control of the same run (the quantized model is chaotic
   in bf16; ``cunet_tpu_torch/tools/plant_faults.py`` shows which limit
   each dropped option breaks), a bit-identical repeat, three
   ``quant_train_step``s on the kernel path (every kernel and every
   QuanInput option launches), step times;
9. whole-batch BN training, the same model at ``bn_tile=0`` (the JAX CLI's
   default) with ``use_pallas``: every bottleneck and adapter on the four
   kernels of TPU kernel #7 (``csrc/bottleneck_kernels.cu``; ``apply`` the
   table form of ``affine_dot``). Each kernel against its plain version
   over the up-block adapter's four feature groups (K = 128+128+32+32 ->
   128) at M = 24*r*r, r = 64 ... 4 (``stats`` at r = 64 and 4), beside
   ``torch.mm`` of its product alone (the three GEMMs), every float32
   reduction held per feature group, and three planted faults of the
   statistics kernel that those limits must catch; the autograd
   Function against itself on the plain versions; the kernel step against
   the plain step in phase 5's bands; ``remat`` "layer" and "block" equal
   to "none" bit for bit (cuDNN deterministic); three kernel-path
   ``train_step``s (the main path: the four kernels launch, no slot
   kernel does); dropout 0.2 through the mask kernel bit for bit the step
   with the plain mask, one dropout step (the mask kernel launches), one
   W1/I8/G8 ``quant_train_step``; step times, img/s and peak memory of
   both paths and of each remat policy, the dropout step's time.

10. per-slot and per-bottleneck eval (TPU kernels #4 and #6, both on the
   feature-table product ``table_dot`` of ``csrc/eval_kernels.cu``): the
   product against its plain version at the CU-Net-8 @256 shapes of
   batch 8 and 64 (a bottleneck with BN2's ``shift2`` epilogue, the
   down-block adapter pair in its dual form, an up-block adapter, the
   intermedia adapter, heads of 16 and 68 classes; features as separate
   tensors); a Predictor with JAX's default flags (``pallas_hourglass``:
   every slot on #4's kernels, the main path) answers the three requests,
   launching ``table_dot`` 159 times per forward and ``affine_dot`` never,
   held to the plain path (relative L2) and to the whole-model path on
   the same weights (bit for bit), timed at batch 8 and 64 beside the
   whole-model path; the int8 model with ``use_pallas`` layer by layer
   (its 1x1 convs on #10, its down blocks' adapter pairs on the float
   dual kernel); the 68-class head (the 300-W face model) on the
   whole-model float and int8 paths, the per-slot path and the slot train
   step; f32 W1/I8/G8 ghost-BN training and the f32 quantized eval run on
   the kernel paths (68-class heads), an f16 model raises.
11. per-block eval (TPU kernel #5) and the value-carried whole-model
   evals (#3, #2): ``table_dot``'s three forms of #5 at the CU-Net-8 @256
   shapes of batch 8 and 64 against their plain versions (``[up]``, an up
   block's adapter reading feature 0 through a folded 2x upsample, and
   ``[pool]``, a down block's adapter pair storing the ahead output 2x2
   pooled, each also bit for bit its two-launch composition with
   ``upsample2`` / ``maxpool2``; ``[scale]``, a bottleneck with BN2's full
   affine); ``fused_dense_block_infer`` for a down, the neck and an up
   block against its plain versions; a Predictor with ``pallas_hourglass
   =False`` under ``use_scan`` (slot 0 layer by layer, slots 1-7 on #5:
   the main path) answers the three requests with 29 hand-written
   launches on each steady slot and no ``maxpool2`` or ``upsample2``
   there, held to the plain path at batch 8 and 64 and timed beside the
   per-slot and whole-model paths; #3 and #2 on the whole-model kernels,
   their anchored heads bit for bit the whole-model path's, every head of
   #3 near its plain versions.
12. float32 serving (``compute_dtype="float32"``, JAX's default and the
   dtype of the converted reference weights): the float32 forms of the
   eval kernels (``affine_dot``, ``conv3x3`` and ``table_dot`` in every
   form on ``csrc/f32_kernels.cu``, float32-accurate through the exact
   three-way bf16 split of both operands; ``maxpool2`` / ``upsample2``)
   against their plain versions at float32 within the float32 n-term
   limit at r = 64 ... 4 (batch 8) and r=64 (batch 64), bit for bit under
   one-hot weights, timed beside their bound and ``torch.mm`` of the
   float32 product alone (or the library call); then CU-Net-8 @256 at
   float32 served through ``Predictor`` with ``use_pallas`` on the
   whole-model, per-slot and per-block paths (requests of 8 and 5, every
   float32 form launched), each anchor within relative L2 1e-4 of the
   plain path at float32 at batch 8 and 64, the per-slot path bit for bit
   the whole-model path, forward ms and img/s of each.
13. float32 whole-batch BN training, CU-Net-8 @256 at ``compute_dtype=
   "float32"``, ``bn_tile=0``, ``use_pallas``: (a) the float32 forms of
   #7's four kernels (``stats``, ``bwd_reduce`` in
   ``csrc/bottleneck_kernels.cu``; ``bwd_dx`` in
   ``csrc/tb_dx_f32_kernels.cu``, on the g planes ``bwd_reduce``'s pre-pass
   wrote, as the backward hands them over; ``apply`` on
   ``csrc/fwd_f32_kernels.cu``) against their plain versions at phase 9's
   cases at float32 (every sum and float32 output within the float32
   n-term limit, three planted ``stats`` faults caught), bit for bit
   under one-hot operands, ``bwd_dx`` on the handed planes bit for bit a
   call that splits g itself, one bf16 pass of g breaking the dx limit;
   ``bwd_reduce``'s dW within F32_DW_REL sqrt(M) of float64 at r = 64, 4
   and at Ctot = 1,920 (order 14's intermedia adapter), where it is also
   held to its plain version and timed; ``bwd_dx`` at 160, 192 and 256
   outputs and at Ctot = 1,920 against its plain version, timed; the mask
   kernel's float32 form bit for bit; (b) the autograd Function at
   float32; (c) the float32 conv's backward with cuDNN's TF32 on (torch's
   default) within the float32 limit of float64, where the conv as it was
   before its repair breaks it; (d) the kernel step against the plain step
   beside two
   permuted-batch controls (F32_STEP_CONTROL), a bit-identical repeat,
   ``remat`` "layer" / "block" bit for bit, dropout through the float32
   mask bit for bit the plain mask's step; the same check of a model 48
   wide in growth (192 outputs at every bottleneck, past the 144 the
   first float32 ``bwd_dx`` took) at cut depth; three
   ``train_step``s (the main
   path: every float32 form of #7 launched, no slot kernel), one dropout
   step (``drop_mask[f32]`` launched) and one W1/I8/G8 step; (e) step
   times and peak memory of both paths beside phase 9's bf16 step.
14. float32 ghost-BN training, CU-Net-8 @256 at ``compute_dtype=
   "float32"``, ``bn_dtype="float32"``, ghost-BN tiles of 6 images (the
   reference's BN groups: bs 24 on 4 GPUs) and 2, ``use_pallas``: (a) the
   ten float32 forms of the slot kernels #8/#9 (``bn_stats``, per-tile
   ``affine_dot`` / ``conv3x3``, ``affine_dx``, ``affine_dw``, ``bn_bwd``
   writing d_x and adding into it, ``conv3x3_dx``, ``conv3x3_dw``, the
   pool / upsample backward) against
   their plain versions at r = 64 ... 4 and tiles 2 and 6 within the
   float32 n-term limit, at r=64 a second call bit for bit the first,
   each timed at r=64, tile 2 beside its bound and library call; bit for
   bit under one-hot operands; one bf16 pass of the cotangent breaking the
   input gradients' limits; ``affine_dw[f32]`` and ``affine_dx[f32]``
   (``csrc/dx_f32_kernels.cu``) at order 14's intermedia adapter, K =
   1,920 <-> 128, against their plain versions, timed beside ``torch.mm``
   of their products and their bounds; (b) the tile-6 step
   against the swap step (the same path on the forms' plain versions)
   within max(2c, 1e-5), c the largest of three tile-preserving permuted
   controls, the plain path beside both, a bit-identical repeat, dropout
   through the float32 mask bit for bit the plain mask's step; (c) three
   main-path ``train_step``s at tile 6 (every form launched), one dropout
   step, three steps at tile 2; (d) step times and peak memory of both
   paths at both tiles beside phase 5's bf16 step, whose kernel step's
   digest phase 5 prints.
15. the quantized model at float32 and feature tables past 16 groups: (a)
   the six QuanInput forms of the slot kernels at float32 (the head's
   ``affine_dot[f32,bits_i]``, ``affine_dx[f32,ste]``,
   ``affine_dw[f32,bits_i]``, the conv's ``conv3x3[f32,bits_i]``,
   ``conv3x3_dx[f32,ste]``, ``conv3x3_dw[f32,bits_i]``; bits_i 8) against
   their plain versions at r = 64 and 4, tile 2, within the float32
   n-term limit, timed at r=64 beside their bound and the float32 product
   alone; bit for bit under one-hot operands, a bf16 pass of dy breaking
   the dx limits, dW within F32_DW_REL of float64; the int8 kernels'
   float32 forms bit for bit their plain versions at phase 6's shapes;
   ``table_dot`` over 17 groups (its table in device memory) at bf16 and
   float32, single, dual and ``[up]``, against its plain version and bit
   for bit the same columns in 16 groups, timed beside them; (b) CU-Net-8
   @256 W1/I8/G8 at float32, ghost-BN tile 2, through
   ``quant_train_step``: the kernel step against the swap step within
   max(2c, 1e-5), three main-path steps (every form launched), times; (c)
   the quantized CU-Net-8 at float32 served on the whole-model int8 path
   and the layer-by-layer path, each anchor against the plain path at
   batch 8 and 64 (within 1e-4, or 2x a one-ulp input nudge where flipped
   int8 codes set the gap), the share of flipped codes, times; (d) order
   14 (layer_num 15): the per-slot forward, its up blocks' adapters over
   17 groups, bit for bit the whole-model path (float32 and bf16 at
   CU-Net-8's widths), the float32 per-slot, per-block and
   per-bottleneck paths near the plain path.
16. JAX's threefry dropout masks (``drop_impl="masks"``, the masks form
   of #8/#9) and ``affine_dot`` at any K: (a) the plain threefry on the
   card against Random123's three vectors and against MASK_DIGESTS (JAX's
   masks); (b) ``threefry_mask`` on ones at all 9 positions, in place and
   from a float32 cotangent, bf16 and float32, bit for bit its plain
   version, its drop fraction at r=64, timed; (c) the CU-Net-8 @256
   ghost-BN tile-2 step with the masks (the step key folded from
   ``PRNGKey(5)``): bf16 against the plain step within the step limits
   and bit for bit on a repeat, float32 against the swap step within
   max(2c, 1e-5) (c over one-ulp product controls), three main-path
   ``train_step(..., rng=)``s (``threefry_mask`` 72 + 72 launches a step,
   ``drop_mask`` none), step times beside the seed form's; (d) the bf16
   ``bn_tile=0`` step with the masks bit for bit its plain mask's, one
   ``train_step``; (e) is 15 (d) at bf16 and CU-Net-8's widths, whose
   whole-model intermedia adapters stream ``affine_dot``'s weight
   (counted); (f) ``affine_dot`` streamed at K = 896 and 1920 (r=64,
   batch 8) against its plain version, timed beside ``torch.mm`` of the
   product; (g) slot 6 of a bf16 ghost-BN step at order 6 (its intermedia
   adapter at K = 896, streamed per tile) against the plain path as slot 1
   is in phase 5. Each phase prints its wall time (``phase time``).

The line before the last is a JSON object with each kernel's launches,
error, times, the least time the card could take for the same work and
the time of one PyTorch call computing the same function where there is
one; the last line is ``{"ok": true, "device": {...}}``. Any failed check
ends the run with a non-zero exit and no result line. There is no CPU
fallback: without a CUDA device the script exits non-zero.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SOURCE = "cunet_tpu_torch/csrc/buf_kernels.cu"
TRAIN_SOURCE = "cunet_tpu_torch/csrc/train_kernels.cu"
INT8_SOURCE = "cunet_tpu_torch/csrc/quant_kernels.cu"
I8_SOURCE = "cunet_tpu_torch/csrc/i8_kernels.cu"   # the whole-model pair
TB_SOURCE = "cunet_tpu_torch/csrc/bottleneck_kernels.cu"
EVAL_SOURCE = "cunet_tpu_torch/csrc/eval_kernels.cu"
BLOCK_SOURCE = "cunet_tpu_torch/kernels/fused_block.py"
MODEL_SOURCE = "cunet_tpu_torch/kernels/fused_model.py"
REPLACES = {
    "affine_dot_i8": "cunet_tpu/kernels/fused_model_buf.py:83",
    "conv3x3_i8": "cunet_tpu/kernels/fused_model_buf.py:316",
    "int8_matmul_dequant": "cunet_tpu/kernels/quant_matmul.py:50",
    "affine_dot": "cunet_tpu/kernels/fused_model_buf.py:52",
    "affine_dot[stream]": "cunet_tpu/kernels/fused_model_buf.py:52",
    "conv3x3": "cunet_tpu/kernels/fused_hourglass.py:75",
    "maxpool2": "cunet_tpu/kernels/fused_hourglass.py:312",
    "upsample2": "cunet_tpu/kernels/fused_hourglass.py:329",
    "bn_stats": "cunet_tpu/kernels/train_slot.py:179",
    "affine_dx": "cunet_tpu/kernels/train_slot.py:541",
    "affine_dw": "cunet_tpu/kernels/train_slot.py:549",
    "bn_bwd": "cunet_tpu/kernels/train_slot.py:557",
    "conv3x3_dx": "cunet_tpu/kernels/train_slot.py:732",
    "conv3x3_dw": "cunet_tpu/kernels/train_slot.py:732",
    "maxpool2_bwd": "cunet_tpu/kernels/train_slot.py:814",
    "upsample2_bwd": "cunet_tpu/kernels/train_slot.py:847",
    "sum_rows": "cunet_tpu/kernels/train_slot.py:854",
    "drop_mask": "cunet_tpu/kernels/train_slot.py:226",
    "threefry_mask": "cunet_tpu/kernels/train_slot.py:425",
    "threefry_mask[f32]": "cunet_tpu/kernels/train_slot.py:425",
    "affine_dot[bits_i]": "cunet_tpu/kernels/train_slot.py:198",
    "conv3x3[bits_i]": "cunet_tpu/kernels/train_slot.py:198",
    "affine_dx[ste]": "cunet_tpu/kernels/train_slot.py:218",
    "conv3x3_dx[ste]": "cunet_tpu/kernels/train_slot.py:218",
    "affine_dw[bits_i]": "cunet_tpu/kernels/train_slot.py:585",
    "conv3x3_dw[bits_i]": "cunet_tpu/kernels/train_slot.py:198",
    "train_bottleneck.stats": "cunet_tpu/kernels/train_bottleneck.py:49",
    "train_bottleneck.apply": "cunet_tpu/kernels/train_bottleneck.py:66",
    "train_bottleneck.bwd_reduce":
        "cunet_tpu/kernels/train_bottleneck.py:92",
    "train_bottleneck.bwd_dx": "cunet_tpu/kernels/train_bottleneck.py:134",
    "table_dot": "cunet_tpu/kernels/fused_hourglass.py:229",
    "table_dot[dual]": "cunet_tpu/kernels/fused_bottleneck.py:178",
    "table_dot[shift2]": "cunet_tpu/kernels/fused_hourglass.py:254",
    "table_dot[up]": "cunet_tpu/kernels/fused_block.py:128",
    "table_dot[scale]": "cunet_tpu/kernels/fused_block.py:148",
    "table_dot[pool]": "cunet_tpu/kernels/fused_block.py:178",
    "fused_dense_block_infer": "cunet_tpu/kernels/fused_block.py:207",
    "fused_model_loop_infer": "cunet_tpu/kernels/fused_model.py:418",
    "fused_model_infer": "cunet_tpu/kernels/fused_model.py:138",
}
# the feature-table product serves two TPU kernels: #4's 1x1 stages (above)
# and #6 (these)
ALSO_REPLACES = {
    "table_dot": "cunet_tpu/kernels/fused_bottleneck.py:76",
    "table_dot[dual]": "cunet_tpu/kernels/fused_hourglass.py:279",
}
# published peaks of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet): HBM bytes/s, and dense operations/s by type ("f32" = float32
# outside the tensor cores)
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12,
            # 32-bit integer operations (add, shift, logic): at most one
            # warp instruction a clock in each of an SM's 4 partitions,
            # 128 lanes a clock, x 132 SMs x 1.98 GHz (the clock behind
            # the float32 67 TFLOP/s, which counts an FMA as two)
            "int32": 132 * 128 * 1.98e9}
# the bf16 output rounds at 2^-8 of its magnitude
REL_BOUND, ABS_BOUND = 2e-2, 1e-2
# a float32 result of an n-term reduction, summed in another order, moves
# by O(sqrt(n) * 2^-24) of its scale; 1e-5 * sqrt(n) leaves a margin ~170
SUM_REL_PER_SQRT_N = 1e-5
PATH_REL_L2 = 3e-2   # kernel path vs plain path: 8 bf16 slots of rounding
BATCH = 8
TRAIN_BATCH, BN_TILE = 24, 2
CONV_RES = (64, 32, 16, 8, 4)   # the 3x3 convs' resolutions, CU-Net-8 @256
# kernel train step vs plain train step on the card (PARITY.md:274-288):
# elementwise grads are chaotic at depth, so aggregate bands. The per-leaf
# cosine is chaotic too at this init: the plain path against itself, with
# the stem BN bias moved by CONTROL_NUDGE (below one bf16 ulp of the O(1)
# activations), measures 0.13 on an H100. So the kernel path's mean cosine
# is held against that control, measured in the same run, minus a margin.
LOSS_REL = 1e-2
GRAD_NORM_RATIO = (0.85, 1.18)
CONTROL_NUDGE = 1e-4
COSINE_MARGIN = 0.05
HEADS_REL_L2 = 5e-2
BN_STATE_REL_L2 = 1e-2
# a kernel step held to a same-run control (quantized training) may differ
# from the plain step by at most this many times the control's difference
CONTROL_FACTOR = 2.0
# int8 kernel path vs plain path: the mean over anchors of their relative
# L2 may exceed the same-run control's by this much (PERF.md, section 6)
INT8_PATH_MARGIN = 0.05
DROP_RATE = 0.2
DROP_FRACTION_TOL = 0.005
# JAX's drop_impl="masks" dropout masks of jax.random.PRNGKey(0) (the key
# (0, 0)), step MASK_STEP, slot MASK_SLOT, at every traversal position of
# CU-Net-8 @256's train step (batch 24, res 64 ... 4, g=32, rate DROP_RATE):
# SHA-256 of the raw masks in traversal order (``mask_digest``), computed
# by JAX; tests/test_torch_port_threefry.py holds them to JAX's masks
MASK_STEP, MASK_SLOT = 3, 1
MASK_DIGESTS = {
    "bfloat16":
        "1777feaee169ad70511c3f0b03f1377c864e6ead414809de4c3f95939ae4ae65",
    "float32":
        "6ae0ac19ba727310a1455967533c21d355f332770483d23d4a3a96660f4ba405",
}


class SmokeFailure(RuntimeError):
    pass


def mask_positions(nb=4, h0=64):
    """(traversal position, resolution) of a slot of ``nb`` blocks."""
    return [(pos, h0 >> min(pos, 2 * nb - pos)) for pos in range(2 * nb + 1)]


def mask_digest(torch, dtype, device, masks=None):
    """SHA-256 of the threefry masks behind ``MASK_DIGESTS`` at ``dtype``:
    ``masks(block_key, shape)`` for each traversal position in order (by
    default the plain ``ops.threefry.bernoulli_mask`` on ``device``), their
    raw bytes."""
    import hashlib

    from cunet_tpu_torch.ops import threefry

    if masks is None:
        def masks(key, shape):
            return threefry.bernoulli_mask(key, shape, DROP_RATE, dtype,
                                           device)
    slot_key = threefry.fold_in(threefry.fold_in((0, 0), MASK_STEP),
                                MASK_SLOT)
    keys = threefry.block_keys(slot_key, 4)
    h = hashlib.sha256()
    for pos, r in mask_positions():
        m = masks(keys[pos], (TRAIN_BATCH, r, r, 32))
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        h.update(m.contiguous().view(bits).cpu().numpy().tobytes())
    return h.hexdigest()


def sz(*dims, e=2):
    """Bytes of a tensor of shape ``dims`` and element size ``e``."""
    n = e
    for d in dims:
        n *= d
    return n


def work(nbytes, ops=0, kind="bf16"):
    """What a kernel call must do: bytes it moves (each input read once,
    each output written once), operations and their type."""
    return nbytes, ops, kind


def bound(w):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    nbytes, ops, kind = w
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS[kind] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def record(results, name, err, ms, plain_ms, label, w, lib_ms,
           product_ms=None):
    """Fold one case into ``results[name]``: the worst error; the first
    case's (the main-path headline's) times, bound and library time, and
    where no library call computes the kernel's function, the time of its
    product alone."""
    r = results.setdefault(name, {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    if "ms" not in r:
        bms, by = bound(w)
        r.update(ms=ms, plain_ms=plain_ms, shape=label, bound_ms=bms,
                 bound_by=by, library_ms=lib_ms)
        if product_ms is not None:
            r["product_ms"] = product_ms


def product_text(prod_ms):
    return ("" if prod_ms is None
            else f", product alone (torch.mm) {prod_ms:.4f} ms")


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_time_ms(fn, iters=20):
    """Device time of one ``fn()``: ``iters`` calls captured in a CUDA graph
    and replayed between two events, so the host's per-call cost (Python,
    argument checks) does not count. Inputs stay warm in the L2 cache, as
    they are when the forward's previous stage has just written them."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_cases(torch, gen):
    """(kernel name, label, destination buffer, view selector,
    callable(fn, out), work, library call or None, product alone or None)
    at the flagship's main-path shapes: c=128, g=32, Cb=128, cls=16,
    h0=64, batch 8. No single PyTorch call computes ``affine_dot`` (BN +
    ReLU, the 1x1, an epilogue, into a strided view): its cases time
    ``torch.mm`` of the raw x at r=64 beside it, the product alone."""
    import torch.nn.functional as F

    dev = "cuda"
    c, g, cb, cls, h0, n = 128, 32, 128, 16, 64, 8

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(
            dev, torch.bfloat16)

    def vec(k):
        inv = torch.rand(k, generator=gen) + 0.5
        shift = torch.randn(k, generator=gen) * 0.5
        return torch.stack([inv, shift]).to(dev)

    m64 = n * h0 * h0
    down64 = randn(m64, c + g + g)            # [y | fifo | out32]
    up64 = randn(m64, 2 * c + g + g)          # [up_y | skip | fifo | out32]
    inter = randn(m64, 2 * c)                 # [y | fifo]
    heads = randn(n, 8, h0, h0, cls)          # (N, A, h, w, cls)
    cases = []

    def dot_work(k, nout, bias=False, m=m64):
        return work(sz(m, k) + sz(k, nout) + sz(2, k, e=4)
                    + (sz(nout, e=4) if bias else 0) + sz(m, nout),
                    2 * m * k * nout)

    def product(x, w):
        return lambda: torch.mm(x, w)

    # K1: adapter K=192 -> 128 written into the up buffer's skip slot
    v, w = vec(192), randn(192, c, scale=192 ** -0.5)
    cases.append(("affine_dot", "K=192->128 r=64", up64,
                  lambda b: b[:, c:2 * c],
                  lambda f, b: f(down64, v, w, b[:, c:2 * c]),
                  dot_work(192, c), None, product(down64, w)))
    # K1: bottlenecks K -> 128 with the shift+ReLU epilogue, at every stage
    # width of r=64 (K=160 first, as before)
    wide = randn(m64, 320 + g)                # [features ... | out32]
    for k in (160, 128, 192, 256, 288, 320):
        vk, wk = vec(k), randn(k, cb, scale=k ** -0.5)
        bias = (torch.randn(cb, generator=gen) * 0.5).to(dev)
        cases.append(("affine_dot", f"K={k}->128 +shift,relu r=64",
                      randn(m64, c + g + g), lambda b: b[:, :cb],
                      lambda f, b, k=k, vk=vk, wk=wk, bias=bias:
                      f(wide[:, :k], vk, wk, b[:, :cb], bias=bias),
                      dot_work(k, cb, True), None,
                      product(wide[:, :k], wk)))
    # K1: head K=128 -> 16 into anchor slot 3 of the stacked head output
    v3, w3 = vec(c), randn(c, cls, scale=c ** -0.5)
    cases.append(("affine_dot", "head K=128->16 r=64", heads,
                  lambda b: b[:, 3],
                  lambda f, b: f(inter[:, :c], v3, w3,
                                 b[:, 3].view(n, h0 * h0, cls)),
                  dot_work(c, cls), None, product(inter[:, :c], w3)))
    # K1: the adapter at r = 32 ... 4, batch 8, then at r=64, batch 64
    for nb, r in [(n, r) for r in CONV_RES[1:]] + [(64, 64)]:
        m = nb * r * r
        xr, vr = randn(m, c + g + g), vec(192)
        cases.append(("affine_dot", f"K=192->128 r={r} batch {nb}",
                      randn(m, 2 * c + g + g), lambda b: b[:, c:2 * c],
                      lambda f, b, xr=xr, vr=vr: f(xr, vr, w, b[:, c:2 * c]),
                      dot_work(192, c, m=m), None,
                      product(xr, w) if r == 64 else None))
    # K2: 3x3 conv into the out32 slot at every resolution of the forward,
    # batch 8 then 64, r=64 first (the kernels line records it); the
    # library call: cuDNN on the same rows viewed as channels-last NCHW
    for nb in (n, 64):
        for r in CONV_RES:
            m = nb * r * r
            y2 = torch.relu(randn(m, cb))
            wk = randn(9 * cb, g, scale=(9 * cb) ** -0.5)
            w_oihw = wk.view(3, 3, cb, g).permute(3, 2, 0, 1).contiguous()
            dst = randn(m, c + g + g)
            cases.append(("conv3x3", f"Cb=128->32 r={r} batch {nb}", dst,
                          lambda b: b[:, c + g:c + 2 * g],
                          lambda f, b, y2=y2, wk=wk, r=r, nb=nb:
                          f(y2, wk, nb, r, r, b[:, c + g:c + 2 * g]),
                          work(sz(m, cb) + sz(9 * cb, g) + sz(m, g),
                               2 * m * 9 * cb * g),
                          lambda y2=y2, w_oihw=w_oihw, r=r:
                          F.conv2d(nchw(y2, r), w_oihw, padding=1), None))
    # K3: pool 64 -> 32 into the next down buffer
    ahead = randn(m64, c)
    down32 = randn(n * 32 * 32, c + g + g)
    cases.append(("maxpool2", "64->32", down32, lambda b: b[:, :c],
                  lambda f, b: f(ahead, n, 64, 64, b[:, :c]),
                  work(sz(m64, c) + sz(m64 // 4, c), 3 * m64 // 4 * c,
                       "f32"),
                  lambda: F.max_pool2d(nchw(ahead, 64), 2), None))
    # K4: upsample 4 -> 8 and 32 -> 64 into the next up buffer
    for r in (32, 4):
        x = randn(n * r * r, c)
        dst = randn(n * 4 * r * r, 2 * c + g + g)
        cases.append(("upsample2", f"{r}->{2 * r}", dst, lambda b: b[:, :c],
                      lambda f, b, x=x, r=r: f(x, n, r, r, b[:, :c]),
                      work(sz(n * r * r, c) + sz(4 * n * r * r, c)),
                      lambda x=x, r=r: F.interpolate(
                          nchw(x, r), scale_factor=2, mode="nearest"), None))
    return cases


def phase_kernels(torch, ops):
    gen = torch.Generator().manual_seed(0)
    results = {}
    for name, label, dst, sel, call, w, lib, prod in kernel_cases(torch, gen):
        kern = getattr(ops, name)
        plain = ops.PLAIN[kern]
        k_buf, p_buf = dst.clone(), dst.clone()
        call(kern, k_buf)
        call(plain, p_buf)
        torch.cuda.synchronize()
        got, want = sel(k_buf).float(), sel(p_buf).float()
        err = (got - want).abs().max().item()
        bound_ = REL_BOUND * want.abs().max().item() + ABS_BOUND
        # everything outside the destination view must be untouched
        outside = k_buf.clone()
        sel(outside).copy_(sel(dst))
        untouched = torch.equal(outside, dst)
        ms = cuda_time_ms(lambda: call(kern, k_buf))
        plain_ms = cuda_time_ms(lambda: call(plain, p_buf))
        lib_ms = None if lib is None else cuda_time_ms(lib)
        prod_ms = None if prod is None else cuda_time_ms(prod)
        print(f"kernel {name} [{label}]: max_abs_err {err:.4g} (bound "
              f"{bound_:.4g}), outside view untouched {untouched}, "
              f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, library "
              f"{lib_ms if lib_ms is None else f'{lib_ms:.4f} ms'}"
              f"{product_text(prod_ms)}, bound {bound(w)[0]:.4f} ms "
              f"({bound(w)[1]})", flush=True)
        require(np.isfinite(err) and err <= bound_,
                f"{name} [{label}] disagrees with its plain version: "
                f"{err} > {bound_}")
        require(untouched, f"{name} [{label}] wrote outside its view")
        record(results, name, err, ms, plain_ms, label, w, lib_ms, prod_ms)
    return results


# ---------------------------------------------------------------------------
# phase 3: serving
# ---------------------------------------------------------------------------


def wall_ms(torch, fn, iters=6, warmup=2):
    """Wall time of one ``fn()`` over ``iters`` calls after ``warmup``,
    the card synchronized at both ends: a whole forward of a few hundred
    launches, which the host's launch rate may bound (a CUDA graph, as in
    ``cuda_time_ms``, would hide that)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def time_forward(torch, pred, batch, iters=6):
    x = torch.rand(batch, 256, 256, 3, generator=torch.Generator()
                   .manual_seed(1)).to("cuda", pred.dtype)
    return wall_ms(torch, lambda: pred.forward(x), iters)


def phase_serving(torch, ops, gpu):
    from cunet_tpu_torch import ModelConfig
    from cunet_tpu_torch.models import init_cu_net
    from cunet_tpu_torch.serving import Predictor

    cfg = ModelConfig(layer_num=8, order=1, class_num=16, loss_num=8,
                      compute_dtype="bfloat16", use_pallas=True,
                      pallas_whole_model=True)
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0))
    pred = Predictor(cfg, params, state, device="cuda", batch_size=BATCH,
                     flip_test=True)
    rng = np.random.RandomState(0)
    requests = [rng.rand(k, 256, 256, 3).astype(np.float32)
                for k in (8, 5, 11)]

    ops.reset_launch_counts()
    answers = []
    for imgs in requests:
        hm = pred.heatmaps(imgs)
        pts = pred.predict(imgs)
        answers.append((hm, pts))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    print(f"serving: launches on the main path {launches}", flush=True)
    for imgs, (hm, pts) in zip(requests, answers):
        k = imgs.shape[0]
        print(f"serving: request of {k}: heatmaps {hm.shape} "
              f"max|hm| {np.abs(hm).max():.4g}, landmarks {pts.shape}",
              flush=True)
        require(hm.shape == (k, 64, 64, 16), f"heatmaps shape {hm.shape}")
        require(pts.shape == (k, 16, 2), f"landmarks shape {pts.shape}")
        require(np.isfinite(hm).all() and np.isfinite(pts).all(),
                "non-finite output")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} never launched on the main path")

    plain = Predictor(dataclasses.replace(cfg, use_pallas=False), params,
                      state, device="cuda", batch_size=BATCH, flip_test=True)
    want = plain.heatmaps(requests[0])
    got = answers[0][0]
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    print(f"serving: kernel path vs plain path on the card, request of 8: "
          f"relative L2 {rel:.4g} (bound {PATH_REL_L2}), "
          f"|plain| {np.linalg.norm(want):.4g}", flush=True)
    require(np.isfinite(rel) and rel <= PATH_REL_L2,
            f"kernel path disagrees with the plain path: {rel}")

    times = {}
    for batch in (BATCH, 64):
        p = pred if batch == BATCH else Predictor(
            cfg, params, state, device="cuda", batch_size=batch)
        times[batch] = ms = time_forward(torch, p, batch)
        print(f"serving: forward batch {batch}: {ms:.3f} ms, "
              f"{batch / ms * 1e3:.1f} img/s (kernel path; {gpu})",
              flush=True)
    ms = time_forward(torch, plain, BATCH)
    print(f"serving: forward batch {BATCH}: {ms:.3f} ms, "
          f"{BATCH / ms * 1e3:.1f} img/s (plain path; {gpu})", flush=True)
    return launches, times


# ---------------------------------------------------------------------------
# phase 4: train kernels against their plain versions
# ---------------------------------------------------------------------------


def nchw(t, r):
    """(B*r*r, C) channel-plane rows as a (B, C, r, r) NCHW view."""
    return t.view(-1, r, r, t.shape[1]).permute(0, 3, 1, 2)


def empty_of(torch, dtype, *shape):
    """A maker of fresh outputs of ``shape`` on the card."""
    return lambda: torch.empty(*shape, device="cuda", dtype=dtype)


def tile_vec(torch, tops, x, gen):
    """Ghost-BN statistics of x (M, K) per tile at the train shapes, a random
    BN (weight in [0.5, 1.5), bias 0.3 N(0, 1)) and their (T, 2, K) float32
    [inv; shift] vectors: (stats, bn, vec)."""
    from cunet_tpu_torch.kernels.train_slot import _affine_vec

    k = x.shape[1]
    st = torch.empty(TRAIN_BATCH // BN_TILE, 2, k, device="cuda")
    tops.bn_stats_plain(x, st)
    bn = torch.stack([torch.rand(k, generator=gen) + 0.5,
                      torch.randn(k, generator=gen) * 0.3]).to("cuda")
    return st, bn, _affine_vec(st, bn, 1e-5)


def vec_bytes(k):
    """Bytes of the per-tile (T, 2, K) float32 vectors at the train shapes."""
    return sz(TRAIN_BATCH // BN_TILE, 2, k, e=4)


def train_kernel_cases(torch, tops, bops, gen):
    """(kernel, label, make_out, call(fn, out), bound, work, library call or
    None, product alone or None) at the CU-Net-8 @256 train shapes
    (c=128, g=32, Cb=128, cls=16, h0=64, batch 24, tile 2). bound is
    ("bf16",), ("exact",) or ("sum", n) for an n-term reduction."""
    dev = "cuda"
    c, g, cb, cls, h0, n = 128, 32, 128, 16, 64, TRAIN_BATCH
    tiles = n // BN_TILE

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    def vec(x):
        return tile_vec(torch, tops, x, gen)

    def f32(*shape):
        return empty_of(torch, torch.float32, *shape)

    def bf16(*shape):
        return empty_of(torch, torch.bfloat16, *shape)

    m64 = n * h0 * h0
    down64 = randn(m64, c + g + g)            # [y | fifo | out32]
    x2 = down64[:, :c + 2 * g]                # K=192 adapter input
    _, _, v2 = vec(x2)
    w_a = randn(192, c, scale=192 ** -0.5)
    d_ahead = randn(m64, c)
    y_out = randn(m64, c)
    _, _, vh = vec(y_out)
    w_h = randn(c, cls, scale=c ** -0.5)
    d_head = randn(m64, cls)

    def dx_work(k, nout, m=m64):   # dy, w, x, vec -> f32 (m, k)
        return work(sz(m, nout) + sz(k, nout) + sz(m, k) + vec_bytes(k)
                    + sz(m, k, e=4), 2 * m * k * nout)

    x160 = down64[:, :160]
    # the 1x1 GEMMs: no PyTorch call computes either function; the last
    # element times torch.mm of the product alone at r=64 (affine_dx's in
    # bf16, the kernel writes float32)
    cases = [
        (tops.bn_stats, "r=64 K=160", f32(tiles, 2, 160),
         lambda f, o: f(x160, o), ("sum", 2 * h0 * h0),
         work(sz(m64, 160) + sz(tiles, 2, 160, e=4), 3 * m64 * 160, "f32"),
         lambda: torch.var_mean(x160.view(tiles, -1, 160), dim=1,
                                correction=0), None),
        (bops.affine_dot, "K=192->128 r=64 per-tile", bf16(m64, c),
         lambda f, o: f(x2, v2, w_a, o), ("bf16",),
         work(sz(m64, 192) + sz(192, c) + vec_bytes(192) + sz(m64, c),
              2 * m64 * 192 * c), None, lambda: torch.mm(x2, w_a)),
        (tops.affine_dx, "K=192->128 r=64", f32(m64, 192),
         lambda f, o: f(d_ahead, w_a, x2, v2, o), ("sum", c),
         dx_work(192, c), None, lambda: torch.mm(d_ahead, w_a.t())),
        (tops.affine_dx, "head 128->16 r=64", f32(m64, c),
         lambda f, o: f(d_head, w_h, y_out, vh, o), ("sum", cls),
         dx_work(c, cls), None, lambda: torch.mm(d_head, w_h.t())),
    ]
    # the two 1x1 GEMMs at r = 32 ... 4 (the adapter, K=192 -> 128)
    for r in CONV_RES[1:]:
        m = n * r * r
        xr = randn(m, c + g + g)
        _, _, vr = vec(xr)
        dr = randn(m, c)
        cases += [
            (bops.affine_dot, f"K=192->128 r={r} per-tile", bf16(m, c),
             lambda f, o, xr=xr, vr=vr: f(xr, vr, w_a, o), ("bf16",),
             work(sz(m, 192) + sz(192, c) + vec_bytes(192) + sz(m, c),
                  2 * m * 192 * c), None, None),
            (tops.affine_dx, f"K=192->128 r={r}", f32(m, 192),
             lambda f, o, xr=xr, vr=vr, dr=dr: f(dr, w_a, xr, vr, o),
             ("sum", c), dx_work(192, c, m), None, None),
        ]
    for r in CONV_RES:
        m = n * r * r
        yb = randn(m, cb)
        _, _, vb = vec(yb)
        w3 = randn(9 * cb, g, scale=(9 * cb) ** -0.5)
        w_oihw = w3.view(3, 3, cb, g).permute(3, 2, 0, 1).contiguous()
        d_o = randn(m, g)
        conv_ops = 2 * m * 9 * cb * g
        cases += [
            (bops.conv3x3, f"Cb=128->32 r={r} per-tile prologue",
             bf16(m, g), lambda f, o, yb=yb, w3=w3, vb=vb, r=r:
             f(yb, w3, n, r, r, o, vec=vb), ("bf16",),
             work(sz(m, cb) + vec_bytes(cb) + sz(9 * cb, g) + sz(m, g),
                  conv_ops),
             None, (lambda yb=yb, w_oihw=w_oihw, r=r: torch.nn.functional
                    .conv2d(nchw(yb, r), w_oihw, padding=1))
             if r == 64 else None),
            (tops.conv3x3_dx, f"32->128 r={r}", f32(m, cb),
             lambda f, o, yb=yb, w3=w3, vb=vb, d_o=d_o, r=r:
             f(d_o, w3, n, r, r, yb, vb, o), ("sum", 9 * g),
             work(sz(m, g) + sz(9 * cb, g) + sz(m, cb) + vec_bytes(cb)
                  + sz(m, cb, e=4), conv_ops),
             lambda d_o=d_o, w_oihw=w_oihw, r=r:
             torch.nn.grad.conv2d_input((n, cb, r, r), w_oihw,
                                        nchw(d_o, r), padding=1), None),
            (tops.conv3x3_dw, f"(9*128, 32) r={r}", f32(9 * cb, g),
             lambda f, o, yb=yb, vb=vb, d_o=d_o, r=r:
             f(yb, vb, d_o, n, r, r, o), ("sum", m),
             work(sz(m, cb) + vec_bytes(cb) + sz(m, g) + sz(9 * cb, g, e=4),
                  conv_ops),
             lambda yb=yb, d_o=d_o, r=r:
             torch.nn.grad.conv2d_weight(nchw(yb, r), (g, cb, 3, 3),
                                         nchw(d_o, r), padding=1), None),
        ]
    ahead = randn(m64, c)
    d_pool = randn(m64 // 4, c, dtype=torch.float32)
    cases.append((tops.maxpool2_bwd, "64->32", bf16(m64, c),
                  lambda f, o: f(ahead, d_pool, n, 64, 64, o), ("exact",),
                  work(sz(m64, c) + sz(m64 // 4, c, e=4) + sz(m64, c),
                       4 * m64 * c, "f32"), None, None))
    d_up = randn(n * 64, c, dtype=torch.float32)
    cases.append((tops.upsample2_bwd, "8->4", bf16(n * 16, c),
                  lambda f, o: f(d_up, n, 4, 4, o), ("bf16",),
                  work(sz(n * 64, c, e=4) + sz(n * 16, c), 3 * n * 16 * c,
                       "f32"),
                  lambda: torch.nn.functional.avg_pool2d(
                      nchw(d_up, 8), 2, divisor_override=1), None))
    part = randn(48, 192, c, dtype=torch.float32)
    cases.append((tops.sum_rows, "48 x (192*128) dW chunks", f32(192, c),
                  lambda f, o: f(part, o), ("sum", 48),
                  work(sz(48, 192, c, e=4) + sz(192, c, e=4), 48 * 192 * c,
                       "f32"), lambda: torch.sum(part, 0), None))
    return cases


def limit(bnd, scale):
    """The largest |kernel - plain| a result of largest magnitude ``scale``
    may show: ("bf16",) a bf16 output, ("exact",) nothing rounds, ("sum",
    n) a float32 n-term reduction."""
    if bnd[0] == "bf16":
        return REL_BOUND * scale + ABS_BOUND
    if bnd[0] == "exact":
        return 0.0
    return SUM_REL_PER_SQRT_N * bnd[1] ** 0.5 * scale + 1e-6


def check_case(torch, plain_of, results, prefix, kern, label, make_out,
               call, bnd, w, lib, name=None, product=None, note=""):
    """Kernel against plain version on fresh outputs, within ``bnd``;
    records error, times, bound and library time (and that of the product
    alone, ``product``) under ``name``; ``note`` ends the case's line."""
    name = name or kern.__name__
    k_out, p_out = make_out(), make_out()
    call(kern, k_out)
    call(plain_of[kern], p_out)
    torch.cuda.synchronize()
    got, want = k_out.float(), p_out.float()
    err = (got - want).abs().max().item()
    lim = limit(bnd, want.abs().max().item())
    ms = cuda_time_ms(lambda: call(kern, k_out))
    plain_ms = cuda_time_ms(lambda: call(plain_of[kern], p_out))
    lib_ms = None if lib is None else cuda_time_ms(lib)
    prod_ms = None if product is None else cuda_time_ms(product)
    print(f"{prefix} {name} [{label}]: max_abs_err {err:.4g} "
          f"(bound {lim:.4g}, {bnd[0]}"
          f"{'' if len(bnd) == 1 else f' n={bnd[1]}'}), "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, library "
          f"{lib_ms if lib_ms is None else f'{lib_ms:.4f} ms'}"
          f"{product_text(prod_ms)}, bound "
          f"{bound(w)[0]:.4f} ms ({bound(w)[1]}){note}", flush=True)
    require(np.isfinite(err) and err <= lim,
            f"{name} [{label}] disagrees with its plain version: "
            f"{err} > {lim}")
    record(results, name, err, ms, plain_ms, label, w, lib_ms, prod_ms)
    return k_out, p_out


STAGE_WIDTHS = (192, 128, 160, 256, 288, 320)   # r=64's, the headline first


def stage_bwd_cases(torch, tops, gen):
    """``bn_bwd`` and ``affine_dw``, the ghost-BN backward's two row
    reductions, at the CU-Net-8 @256 train shapes (batch 24, tile 2): at
    r=64 every stage width of the path (K=192 first, the headline), then
    K=192 at r = 32 ... 4. ``bn_bwd`` writes d_x or, on every second case,
    adds to it (``accumulate``); ``affine_dw`` runs plain and with
    ``bits_i=8``, and at r=64 also as the head (128 -> 16). Operands are
    views of wider buffers, as the slot backward hands them in. Yields
    (kernel, label, make_outs, call(fn, outs), bounds, work, library call,
    operands)."""
    dev = "cuda"
    n, tiles, c, cls = TRAIN_BATCH, TRAIN_BATCH // BN_TILE, 128, 16
    acc = False
    for r in CONV_RES:
        m = n * r * r
        tile_rows = m // tiles
        xbuf = (torch.randn(m, 320 + 32, generator=gen) * 2).to(
            dev, torch.bfloat16)
        dabuf = torch.randn(m, 320 + 32, generator=gen).to(dev)
        dy = torch.randn(m, c, generator=gen).to(dev, torch.bfloat16)
        for k in STAGE_WIDTHS if r == 64 else STAGE_WIDTHS[:1]:
            x, d_a = xbuf[:, :k], dabuf[:, :k]
            st, bn, v = tile_vec(torch, tops, x, gen)
            base = torch.randn(m, k, generator=gen).to(dev)
            # the library's layout: tile t's channels at columns t*K + k
            xf = x.float().view(tiles, tile_rows, k).permute(1, 0, 2) \
                .reshape(tile_rows, tiles * k).contiguous()
            daf = d_a.reshape(tiles, tile_rows, k).permute(1, 0, 2) \
                .reshape(tile_rows, tiles * k).contiguous()
            mean = st[:, 0].reshape(-1).contiguous()
            rstd = torch.rsqrt(st[:, 1] + 1e-5).reshape(-1).contiguous()
            gamma = bn[0, :k].repeat(tiles).contiguous()

            def bn_lib(xf=xf, daf=daf, mean=mean, rstd=rstd, gamma=gamma):
                return torch.ops.aten.native_batch_norm_backward(
                    daf, xf, gamma, None, None, mean, rstd, True, 1e-5,
                    [True, True, True])

            def bn_outs(k=k, base=base, acc=acc):
                return (base.clone() if acc else
                        torch.empty(m, k, device=dev),
                        torch.empty(2, k, device=dev))

            yield (tops.bn_bwd, f"K={k} r={r}"
                   + (" accumulate" if acc else ""), bn_outs,
                   lambda f, o, x=x, d_a=d_a, st=st, bn=bn, acc=acc:
                   f(x, d_a, st, bn, 1e-5, o[0], o[1], accumulate=acc),
                   (("sum", tile_rows), ("sum", m)),
                   work(sz(m, k) + sz(m, k, e=4) * (3 if acc else 2)
                        + vec_bytes(k), 8 * m * k, "f32"), bn_lib,
                   dict(x=x, d_a=d_a, st=st, bn=bn, acc=acc))
            acc = not acc
            shapes = [(k, c, x, v, dy, 0)]
            if r == 64 and k == 128:
                shapes.append((k, cls, x, v, dy[:, :cls].contiguous(), 0))
            if k == 192:
                shapes.append((k, c, x, v, dy, 8))
            for kk, nn, xx, vv, dd, bits in shapes:
                label = ("head " if nn == cls else "K=") + \
                    f"{kk}->{nn} r={r}" + (" quantized z" if bits else "")
                yield (tops.affine_dw, label,
                       lambda kk=kk, nn=nn: (torch.empty(kk, nn,
                                                         device=dev),),
                       lambda f, o, xx=xx, vv=vv, dd=dd, bits=bits:
                       f(xx, vv, dd, o[0], bits_i=bits), (("sum", m),),
                       work(sz(m, kk) + vec_bytes(kk) + sz(m, nn)
                            + sz(kk, nn, e=4), 2 * m * kk * nn),
                       lambda xx=xx, dd=dd: torch.mm(xx.t(), dd),
                       dict(x=xx, vec=vv, dy=dd, bits=bits))


def stage_bwd_faults(torch, tops, kern, o, got, want, bounds):
    """A planted fault of each kernel's split at the operands ``o`` of its
    r=64 headline case, built from the kernel's own outputs ``got`` and
    its plan: ``bn_bwd`` with the partial of tile 0's last cluster rank
    dropped from that tile's sums; ``affine_dw`` with the middle run's
    partial added twice. Returns (fault, error, share of its limit)."""
    from cunet_tpu_torch.kernels.buf_ops import tile_affine

    x = o["x"]
    m, k = x.shape
    if kern is tops.bn_bwd:
        st, bn, d_a = o["st"], o["bn"], o["d_a"]
        tile_rows = m // st.shape[0]
        p = tops.bn_bwd_plan(m, tile_rows, k)
        rows = p.rows(p.cs - 1, tile_rows)
        rstd = torch.rsqrt(st[0, 1] + 1e-5)
        xh = (x[:tile_rows].float() - st[0, 0]) * rstd
        da = d_a[:tile_rows]
        sl = slice(rows.start, rows.stop)
        drop = torch.stack([(da[sl] * xh[sl]).sum(0), da[sl].sum(0)])
        sums = torch.stack([(da * xh).sum(0), da.sum(0)]) - drop
        d_x = got[0].clone()
        d_x[:tile_rows] = rstd * bn[0, :k] * (
            da - sums[1] / tile_rows - xh * (sums[0] / tile_rows))
        faulty = [d_x, got[1] - drop]
        fault = (f"the partial of tile 0's rank {p.cs - 1} of {p.cs} "
                 f"(rows {rows.start}-{rows.stop - 1}) dropped")
    else:
        p = tops.affine_dw_plan(m, k, o["dy"].shape[1])
        rows = p.run(p.runs // 2, m)
        z = torch.relu(tile_affine(x[:], o["vec"])).to(x.dtype).float()
        extra = z[rows.start:rows.stop].t() @ \
            o["dy"][rows.start:rows.stop].float()
        faulty = [got[0] + extra]
        fault = (f"run {p.runs // 2} of {p.runs} (rows {rows.start}-"
                 f"{rows.stop - 1}) counted twice")
    err, share, _ = output_errors(torch, faulty, want, bounds)
    return fault, err, share


def phase_train_kernels(torch, tops, bops):
    gen = torch.Generator().manual_seed(0)
    results = {}
    plain_of = {**bops.PLAIN, **tops.PLAIN}
    for *case, prod in train_kernel_cases(torch, tops, bops, gen):
        check_case(torch, plain_of, results, "train kernel", *case,
                   product=prod)
    for kern, label, make_outs, call, bounds, w, lib, o in \
            stage_bwd_cases(torch, tops, gen):
        name = kern.__name__
        got, want = make_outs(), make_outs()
        call(kern, got)
        call(plain_of[kern], want)
        torch.cuda.synchronize()
        err, share, ok = output_errors(torch, got, want, bounds)
        ms = cuda_time_ms(lambda: call(kern, got))
        plain_ms = cuda_time_ms(lambda: call(plain_of[kern], want))
        lib_ms = cuda_time_ms(lib)
        print(f"train kernel {name} [{label}]: max_abs_err {err:.4g} (at "
              f"most {share:.3g} of its sum limits: {ok}), {ms:.4f} ms vs "
              f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
              f"{bound(w)[0]:.4f} ms ({bound(w)[1]})", flush=True)
        require(ok, f"{name} [{label}] disagrees with its plain version")
        record(results, name, err, ms, plain_ms, label, w, lib_ms)
        # the faults need the plans (absent from checkouts before them,
        # which tools/kernel_times.py times on these cases)
        if label in ("K=192 r=64", "K=192->128 r=64") \
                and hasattr(tops, "bn_bwd_plan"):
            fault, ferr, fshare = stage_bwd_faults(
                torch, tops, kern, o, got, want, bounds)
            print(f"train kernel planted fault of {name} [{label}]: "
                  f"{fault}: max_abs_err {ferr:.4g}, {fshare:.3g} of its "
                  f"limit", flush=True)
            require(fshare > 1, f"the {name} check misses a planted fault: "
                    f"{fault}")
    return results


# ---------------------------------------------------------------------------
# phase 5: training
# ---------------------------------------------------------------------------


def gaussian_heatmaps(rng, n, joints, size, sigma=1.0):
    """(n, size, size, joints) float32 Gaussian target heatmaps at random
    joint positions, rendered with numpy."""
    centres = rng.uniform(4, size - 4, (n, joints, 2))
    grid = np.arange(size, dtype=np.float32)
    gx = np.exp(-(grid[None, None, :] - centres[..., 0:1]) ** 2
                / (2 * sigma ** 2))
    gy = np.exp(-(grid[None, None, :] - centres[..., 1:2]) ** 2
                / (2 * sigma ** 2))
    hm = gy[:, :, :, None] * gx[:, :, None, :]          # (n, J, y, x)
    return hm.transpose(0, 2, 3, 1).astype(np.float32)


def _grads(torch, cfg, params, state, x, t, quant=None, **kw):
    """One forward + backward from float32 copies of ``params`` (with
    ``quant``, the masters, through ``quantize_params`` of them): (loss,
    grads, new bn_state). ``kw`` goes to ``apply_cu_net`` (drop_seeds)."""
    from cunet_tpu_torch.models import apply_cu_net
    from cunet_tpu_torch.quant import quantize_params, selected_conv_predicate
    from cunet_tpu_torch.train import intermediate_mse

    ps = {k: v.detach().clone().requires_grad_(True)
          for k, v in params.items()}
    run = ps if quant is None else quantize_params(
        ps, quant, selected_conv_predicate(ps, "reference"))
    outs, new_state = apply_cu_net(run, state, x, cfg=cfg, train=True,
                                   quant=quant, **kw)
    loss = intermediate_mse(outs, t)
    loss.backward()
    return loss.item(), {k: v.grad for k, v in ps.items()}, new_state


def _rel_l2(torch, a, b, keys):
    num = sum(((a[k].float() - b[k].float()) ** 2).sum() for k in keys)
    den = sum((b[k].float() ** 2).sum() for k in keys)
    return (num / den).sqrt().item()


def slot_rel_errors(torch, cfg, params, state, n, h0, i, device, gen):
    """Slot ``i`` (>= 1) of the train step alone, from one slot input and
    one set of FIFO entries, on three paths: the kernel path, the plain
    path with its BN affine in float32 (the reference: it rounds where the
    kernels round) and the plain path as configured (the control).

    Groups: the forward outputs; the running-statistics updates; and, for
    each output alone under a random cotangent, every input cotangent (the
    slot input and each FIFO entry: what reaches the earlier slots' out32
    and inter_out) and every weight gradient, a missing gradient counting
    as zero. Returns ``(kernel, control)``, each {group: {name: relative
    L2 against the reference}}."""
    from cunet_tpu_torch.models import apply_slot_train, empty_fifos

    dt = getattr(torch, cfg.compute_dtype)
    nb, c, g, L = cfg.num_blocks, cfg.init_chan_num, cfg.growth_rate, \
        min(i, cfg.order)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(device, dt)

    # FIFO entries in empty_fifos order: down 0..nb-1, neck, up 0..nb-1
    pos_res = ([(f"down.{j}", h0 >> j) for j in range(nb)]
               + [("neck", h0 >> nb)]
               + [(f"up.{j}", h0 >> j) for j in range(nb)])
    names = (["d_y"] + [f"d_inter_fifo.{k}" for k in range(L)]
             + [f"d_fifo.{p}.{k}" for p, _ in pos_res for k in range(L)])
    inputs = ([rand(n, h0, h0, c).relu() for _ in range(1 + L)]
              + [rand(n, r, r, g) for _, r in pos_res for _ in range(L)])
    out_names = (["y_out", "head", "inter_out"]
                 + [f"out32.{p}" for p, _ in pos_res])
    cts = []

    def run(run_cfg):
        ps = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
        xs = [t.clone().requires_grad_(True) for t in inputs]
        it = iter(xs[1:])
        fifos = empty_fifos(cfg)
        fifos["intermedia"] = [next(it) for _ in range(L)]
        fifos["down"] = [[next(it) for _ in range(L)] for _ in range(nb)]
        fifos["neck"] = [next(it) for _ in range(L)]
        fifos["up"] = [[next(it) for _ in range(L)] for _ in range(nb)]
        y_out, nf, hm, upd = apply_slot_train(ps, state, xs[0], fifos,
                                              cfg=run_cfg, i=i)
        outs = ([y_out, hm, nf["intermedia"][-1]]
                + [f[-1] for f in nf["down"]] + [nf["neck"][-1]]
                + [f[-1] for f in nf["up"]])
        if not cts:
            cts.extend(rand(*o.shape) for o in outs)
        leaves = dict(zip(names, xs))
        leaves.update((f"dW.{k}", v) for k, v in ps.items())
        got = {"forward outputs": {k: o.detach()
                                   for k, o in zip(out_names, outs)},
               "running-stat updates": {k: v - state[k]
                                        for k, v in upd.items()}}
        for on, o, ct in zip(out_names, outs, cts):
            gr = torch.autograd.grad(o, list(leaves.values()), ct,
                                     allow_unused=True, retain_graph=True)
            got[f"grads from {on}"] = {k: d for k, d in zip(leaves, gr)
                                       if d is not None}
        return got

    def rel(a, b):              # a missing gradient is a zero one
        if b is None or not b.any():
            return 0.0 if a is None or not a.any() else float("inf")
        a = torch.zeros_like(b) if a is None else a
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    def against(got, ref):
        return {grp: {k: rel(got[grp].get(k), ref[grp].get(k))
                      for k in set(got[grp]) | set(ref[grp])}
                for grp in ref}

    kern = run(cfg)
    ref = run(dataclasses.replace(cfg, use_pallas=False, bn_dtype="float32"))
    ctl = run(dataclasses.replace(cfg, use_pallas=False))
    return against(kern, ref), against(ctl, ref)


def check_slot(torch, cfg, params, state, i=1):
    """Slot ``i`` (1: the flagship's) of the train step alone at full width
    (the intermedia adapter, every block position, min(i, order) FIFO
    entries each): per
    group of ``slot_rel_errors``, the kernel path's largest error against
    the float32-affine plain path must not exceed the control's (the plain
    path with the configured bf16 affine, a correct implementation). In
    bf16 the two plain paths flip ReLU masks and pool winners apart, and
    the flips grow with depth, so a fixed bound would be loose for deep
    outputs or fail at shallow ones; a dropped or doubled cotangent path
    gives 1 on the leaves it feeds."""
    kern, ctl = slot_rel_errors(torch, cfg, params, state, TRAIN_BATCH, 64,
                                i, "cuda", torch.Generator().manual_seed(2))
    label = "training" + ("" if cfg.order == 1 else f" (order {cfg.order})")
    for grp, rels in kern.items():
        worst = max(rels, key=rels.get)
        bound = max(ctl[grp].values())
        print(f"{label}: slot {i} alone, kernel vs plain (f32 BN affine): "
              f"{grp}: {len(rels)} tensors, max rel L2 {rels[worst]:.4g} "
              f"({worst}); control (plain, bf16 affine) {bound:.4g}",
              flush=True)
        require(rels[worst] <= bound,
                f"slot {i} {grp}: kernel path {worst} off the plain path by "
                f"{rels[worst]} > control {bound}")


def time_train(torch, step, steps=3):
    """Median host time of ``steps`` synchronised calls of ``step()`` after
    one warm-up, and the peak device memory over them."""
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), torch.cuda.max_memory_allocated()


def step_metrics(torch, g, s, l, gp, sp, lp):
    """A step's (loss, grads, BN state) against the plain step's: relative
    loss difference, grad-norm ratio, mean per-leaf cosine, ``heads.*``
    grads and BN running stats relative L2, and the worst BN leaf."""
    norm = lambda gr: sum((v.float() ** 2).sum()  # noqa: E731
                          for v in gr.values()).sqrt()
    cos = [torch.nn.functional.cosine_similarity(
        g[k].flatten().float(), gp[k].flatten().float(), dim=0).item()
        for k in g if gp[k].abs().max() > 0]
    heads = [k for k in g if k.startswith("heads.")]
    conv3 = [k for k in g if k.endswith("conv2")]
    worst = max(sp, key=lambda k: _rel_l2(torch, s, sp, [k]))
    return dict(loss=abs(l - lp) / abs(lp),
                ratio=(norm(g) / norm(gp)).item(), cos=float(np.mean(cos)),
                cos_min=float(np.min(cos)),
                heads=_rel_l2(torch, g, gp, heads),
                conv3=_rel_l2(torch, g, gp, conv3),
                bn=_rel_l2(torch, s, sp, list(sp)), worst_bn=worst,
                worst_bn_rel=_rel_l2(torch, s, sp, [worst]))


def step_limits(c, controlled):
    """The limits of a kernel step's ``step_metrics`` given the control's
    ``c``. Without ``controlled``: phase 5's bands, the cosine at least the
    control's minus COSINE_MARGIN. With it (a model chaotic in bf16, whose
    control is the plain path with its BN affine in float32) each limit is
    scaled to the control's own value: the loss difference, ``heads.*`` and
    BN errors at most the control's plus the band and at most
    CONTROL_FACTOR times the control's; the cosine at least the control's
    minus the margin and at least its 1 / CONTROL_FACTOR; the grad-norm
    ratio within the band around the control's."""
    if not controlled:
        return dict(loss=LOSS_REL, heads=HEADS_REL_L2, bn=BN_STATE_REL_L2,
                    ratio=GRAD_NORM_RATIO, cos=c["cos"] - COSINE_MARGIN)
    f = CONTROL_FACTOR
    return dict(loss=min(c["loss"] + LOSS_REL, f * c["loss"]),
                heads=min(c["heads"] + HEADS_REL_L2, f * c["heads"]),
                bn=min(c["bn"] + BN_STATE_REL_L2, f * c["bn"]),
                ratio=(c["ratio"] * GRAD_NORM_RATIO[0],
                       c["ratio"] * GRAD_NORM_RATIO[1]),
                cos=max(c["cos"] - COSINE_MARGIN, c["cos"] / f))


def step_failures(k, lim):
    """The limits of ``step_limits`` that the kernel step's metrics ``k``
    break, each as 'metric value vs limit'."""
    bad = []
    if not (np.isfinite(k["loss"]) and k["loss"] <= lim["loss"]):
        bad.append(f"loss rel {k['loss']:.4g} > {lim['loss']:.4g}")
    if not lim["ratio"][0] <= k["ratio"] <= lim["ratio"][1]:
        bad.append(f"grad-norm ratio {k['ratio']:.4f} outside "
                   f"({lim['ratio'][0]:.4f}, {lim['ratio'][1]:.4f})")
    if not k["cos"] >= lim["cos"]:
        bad.append(f"mean cosine {k['cos']:.4f} < {lim['cos']:.4f}")
    for key, what in (("heads", "heads.* grads rel L2"),
                      ("bn", "BN running stats rel L2")):
        if not k[key] <= lim[key]:
            bad.append(f"{what} {k[key]:.4g} > {lim[key]:.4g}")
    return bad


def reference_steps(torch, cfg, params, state, x, t, controlled=False, **kw):
    """The plain step's (loss, grads, BN state) and the control's
    ``step_metrics`` against it (see ``step_limits``)."""
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    lp, gp, sp = _grads(torch, plain_cfg, params, state, x, t, **kw)
    if controlled:
        lq, gq, sq = _grads(torch, dataclasses.replace(
            plain_cfg, bn_dtype="float32"), params, state, x, t, **kw)
    else:
        nudged = dict(params)
        nudged["stem.norm.bias"] = params["stem.norm.bias"] + CONTROL_NUDGE
        lq, gq, sq = _grads(torch, plain_cfg, nudged, state, x, t, **kw)
    return (lp, gp, sp), step_metrics(torch, gq, sq, lq, gp, sp, lp)


def compare_steps(torch, label, cfg, params, state, x, t, controlled=False,
                  **kw):
    """One kernel-path step against one plain-path step from the same state
    (and the same dropout seeds or quantizer, ``kw``), beside a control of
    the same run, within ``step_limits``; then the same kernel step again,
    bit for bit."""
    lk, gk, sk = _grads(torch, cfg, params, state, x, t, **kw)
    (lp, gp, sp), c = reference_steps(torch, cfg, params, state, x, t,
                                      controlled, **kw)
    k = step_metrics(torch, gk, sk, lk, gp, sp, lp)
    lim = step_limits(c, controlled)
    print(f"{label}: kernel vs plain step on the card: loss {lk:.6g} vs "
          f"{lp:.6g} (rel {k['loss']:.3g}, bound {lim['loss']:.3g}); "
          f"grad-norm ratio {k['ratio']:.4f} (band "
          f"({lim['ratio'][0]:.4f}, {lim['ratio'][1]:.4f})); mean per-leaf "
          f"cosine {k['cos']:.4f} (min {k['cos_min']:.4f}; bound >= "
          f"{lim['cos']:.4f}); heads.* grads rel L2 "
          f"{k['heads']:.4g} (bound {lim['heads']:.4g}); BN running stats "
          f"rel L2 {k['bn']:.4g} (bound {lim['bn']:.4g}; worst leaf "
          f"{k['worst_bn']} {k['worst_bn_rel']:.4g}); control ("
          f"{'plain, f32 BN affine' if controlled else 'plain, stem BN'}"
          f"{'' if controlled else f' bias +{CONTROL_NUDGE}'}): loss rel "
          f"{c['loss']:.3g}, ratio {c['ratio']:.4f}, cosine {c['cos']:.4f}, "
          f"heads {c['heads']:.4g}, BN {c['bn']:.4g}", flush=True)
    bad = step_failures(k, lim)
    require(not bad, f"{label}: kernel step off the plain step: "
            f"{'; '.join(bad)}")
    lk2, gk2, _ = _grads(torch, cfg, params, state, x, t, **kw)
    same = lk2 == lk and all(torch.equal(gk[n], gk2[n]) for n in gk)
    print(f"{label}: repeated kernel step bit-identical: {same}", flush=True)
    require(same, f"{label}: the kernel train step is not deterministic")
    return lk, gk


def step_digest(torch, loss, grads):
    """sha256 (16 hex digits) of a step's float loss and its grads in
    name order: two checkouts whose digests agree computed the same step
    bit for bit."""
    import hashlib

    h = hashlib.sha256(np.float64(loss).tobytes())
    for k in sorted(grads):
        h.update(k.encode())
        h.update(grads[k].detach().float().contiguous().cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def flagship_train(torch):
    """CU-Net-8 @256 training (bf16, ghost-BN tile 2, bn_dtype "compute",
    kernel path) from the port's init, seed 0, and its batch of 24 numpy
    images and Gaussian target heatmaps."""
    from cunet_tpu_torch import ModelConfig
    from cunet_tpu_torch.models import init_cu_net

    cfg = ModelConfig(layer_num=8, order=1, class_num=16, loss_num=8,
                      compute_dtype="bfloat16", remat="none",
                      use_pallas=True, bn_tile=BN_TILE, bn_dtype="compute")
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(TRAIN_BATCH, 256, 256, 3).astype(
        np.float32)).cuda()
    t = torch.from_numpy(gaussian_heatmaps(rng, TRAIN_BATCH, 16, 64)).cuda()
    return cfg, params, state, {"image": x, "heatmap": t}


def main_path_steps(torch, label, step, params_of, counters):
    """Three steps of the main path (``step()``), the launch counters of
    ``counters`` (modules with reset_launch_counts / launch_counts, or
    callables returning counts) set to 0 just before and read just after:
    every count must be positive, the losses finite and some parameter
    must move. Returns the counts."""
    before = {k: v.detach().clone() for k, v in params_of().items()}
    for m in counters:
        if hasattr(m, "reset_launch_counts"):
            m.reset_launch_counts()
    losses = [float(step()["loss"]) for _ in range(3)]
    torch.cuda.synchronize()
    launches = {}
    for m in counters:
        launches.update(m.launch_counts() if hasattr(m, "launch_counts")
                        else m())
    moved = sum(not torch.equal(before[k], v.detach())
                for k, v in params_of().items())
    print(f"{label}: 3 kernel-path steps, losses {losses}; {moved}/"
          f"{len(before)} params changed; launches {launches}", flush=True)
    require(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
    require(moved > 0, f"{label}: no parameter changed")
    for name, count in launches.items():
        require(count > 0, f"{label}: kernel {name} never launched")
    return launches


def report_times(torch, label, kernel_step, plain_step, gpu):
    """{path: (step ms, peak memory)} of the kernel and plain paths' steps,
    printed: the kernel path's median of three, the plain path's one step
    after its warm-up (a reference beside the metric, and the slowest
    steps of the run)."""
    times = {}
    for path, fn, steps in (("kernel", kernel_step, 3),
                            ("plain", plain_step, 1)):
        times[path] = ms, mem = time_train(torch, fn, steps)
        print(f"{label}: {path} path, batch {TRAIN_BATCH}: "
              f"{'median step' if steps > 1 else 'one step'} {ms:.3f} ms, "
              f"{TRAIN_BATCH / ms * 1e3:.1f} img/s, peak memory "
              f"{mem / 2 ** 30:.2f} GiB ({gpu})", flush=True)
    return times


def phase_training(torch, tops, bops, gpu):
    from cunet_tpu_torch import TrainConfig
    from cunet_tpu_torch.train import create_train_state, train_step

    cfg, params, state, batch = flagship_train(torch)
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    x, t = batch["image"], batch["heatmap"]

    # ---- one slot alone: every cotangent path, kernel against plain ----
    check_slot(torch, cfg, params, state)
    # ---- kernel step against plain step, from identical state ----
    lk, gk = compare_steps(torch, "training", cfg, params, state, x, t)
    digest = step_digest(torch, lk, gk)
    print(f"training: bf16 ghost-BN kernel step digest {digest} (loss and "
          f"grads; tools/kernel_times.py prints it for another checkout)",
          flush=True)
    del gk

    # ---- three train steps through the kernels: the main path ----
    tcfg = TrainConfig(lr=2.5e-4, batch_size=TRAIN_BATCH)
    st = create_train_state(params, state, tcfg)
    launches = main_path_steps(
        torch, "training", lambda: train_step(st, batch, cfg=cfg)[1],
        lambda: st.params, (bops, tops))

    # ---- timing: kernel path, then plain path ----
    st_p = create_train_state(params, state, tcfg)
    times = report_times(torch, "training",
                         lambda: train_step(st, batch, cfg=cfg),
                         lambda: train_step(st_p, batch, cfg=plain_cfg), gpu)
    return launches, times


# ---------------------------------------------------------------------------
# phases 7 and 8: dropout and quantized training
# ---------------------------------------------------------------------------


def drop_mask_checks(torch, dops, results):
    """The mask kernel at the train shapes (batch 24, tile 2, g=32): on
    ones it leaves the plain tile masks bit for bit at every traversal
    position with its resolution, a negative seed among them; conv3x3's
    out32 with the mask applied equals the undropped kernel output times
    the plain mask; the backward form equals its plain version; a full
    r=64 out32 drops DROP_RATE of its elements."""
    from cunet_tpu_torch.kernels import buf_ops, train_ops
    from cunet_tpu_torch.ops import dropmask

    n, g, cb, nb = TRAIN_BATCH, 32, 128, 4
    gen = torch.Generator().manual_seed(4)
    plain = dops.PLAIN[dops.drop_mask]
    for pos in range(2 * nb + 1):
        r = 64 >> (pos if pos <= nb else 2 * nb - pos)
        m, tile_rows = n * r * r, BN_TILE * r * r
        for seed in (-1234567, 2 ** 31 - 1) if pos in (0, nb) else (-99,):
            ones = torch.ones(m, g, device="cuda", dtype=torch.bfloat16)
            dops.drop_mask(ones, seed, pos, DROP_RATE, tile_rows)
            want = dropmask.rows_mask(seed, pos, m, g, tile_rows, DROP_RATE,
                                      torch.bfloat16, "cuda")
            require(torch.equal(ones, want),
                    f"mask kernel on ones differs from the plain masks at "
                    f"position {pos}, r={r}, seed {seed}")
            if pos == 0 and seed < 0:
                frac = (ones == 0).float().mean().item()
                print(f"drop_mask: drop fraction of one r=64 out32 "
                      f"({m} x {g}): {frac:.5f} (rate {DROP_RATE} +- "
                      f"{DROP_FRACTION_TOL})", flush=True)
                require(abs(frac - DROP_RATE) <= DROP_FRACTION_TOL,
                        f"drop fraction {frac}")
    print("drop_mask: on ones bit-identical to the plain tile masks at "
          "positions 0..8 (r = 64..4, 12 tiles, negative seeds)", flush=True)

    # the forward's use: conv3x3 into the out32 view, then the mask
    r, pos, seed = 64, 1, -31
    m, tile_rows = n * r * r, BN_TILE * r * r
    yb = torch.randn(m, cb, generator=gen).to("cuda", torch.bfloat16)
    vb = tile_vec(torch, train_ops, yb, gen)[2]
    w3 = (torch.randn(9 * cb, g, generator=gen) * (9 * cb) ** -0.5).to(
        "cuda", torch.bfloat16)
    buf = torch.zeros(m, 3 * g + 128, device="cuda", dtype=torch.bfloat16)
    out32 = buf[:, 128 + g:128 + 2 * g]
    buf_ops.conv3x3(yb, w3, n, r, r, out32, vec=vb)
    undropped = out32.clone()
    dops.drop_mask(out32, seed, pos, DROP_RATE, tile_rows)
    torch.cuda.synchronize()
    want = undropped * dropmask.rows_mask(seed, pos, m, g, tile_rows,
                                          DROP_RATE, torch.bfloat16, "cuda")
    same = torch.equal(out32, want)
    print(f"drop_mask: conv3x3 + mask at r=64 bit-identical to the undropped "
          f"conv times the plain mask: {same}", flush=True)
    require(same, "conv3x3 + mask differs from conv3x3 times the plain mask")

    # timed cases: forward in place on the out32 view, backward from f32
    d = torch.randn(m, g + 96, generator=gen).cuda()[:, 64:64 + g]
    fwd_w = work(2 * sz(m, g))
    bwd_w = work(sz(m, g, e=4) + sz(m, g))
    cases = [("forward r=64 in place", lambda f, o: f(o, seed, pos,
              DROP_RATE, tile_rows), lambda: undropped.clone(), fwd_w),
             ("backward r=64 f32->bf16", lambda f, o: f(
                 d, seed, pos, DROP_RATE, tile_rows, o),
              lambda: torch.empty(m, g, device="cuda",
                                  dtype=torch.bfloat16), bwd_w)]
    for label, call, make_out, w in cases:
        k_out, p_out = make_out(), make_out()
        call(dops.drop_mask, k_out)
        call(plain, p_out)
        torch.cuda.synchronize()
        same = torch.equal(k_out, p_out)
        ms = cuda_time_ms(lambda: call(dops.drop_mask, k_out))
        plain_ms = cuda_time_ms(lambda: call(plain, p_out))
        print(f"drop kernel drop_mask [{label}]: bit-identical {same}, "
              f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, bound "
              f"{bound(w)[0]:.4f} ms ({bound(w)[1]})", flush=True)
        require(same, f"drop_mask [{label}] differs from its plain version")
        record(results, "drop_mask", 0.0, ms, plain_ms, label, w, None)


def phase_dropout_training(torch, tops, bops, dops, gpu):
    """Phase 7: the mask kernel's checks, then CU-Net-8 @256 training with
    drop_rate DROP_RATE: kernel step against plain step from the same
    seeds, three train_steps from a generator (the main path), times."""
    from cunet_tpu_torch import TrainConfig
    from cunet_tpu_torch.ops.dropmask import draw_slot_seeds
    from cunet_tpu_torch.train import create_train_state, train_step

    results = {}
    drop_mask_checks(torch, dops, results)
    cfg, params, state, batch = flagship_train(torch)
    cfg = dataclasses.replace(cfg, drop_rate=DROP_RATE)
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    seeds = draw_slot_seeds(torch.Generator().manual_seed(5), cfg.layer_num)
    compare_steps(torch, "dropout training", cfg, params, state,
                  batch["image"], batch["heatmap"], drop_seeds=seeds)

    tcfg = TrainConfig(lr=2.5e-4, batch_size=TRAIN_BATCH)
    st = create_train_state(params, state, tcfg)
    gen = torch.Generator().manual_seed(6)
    launches = main_path_steps(
        torch, "dropout training",
        lambda: train_step(st, batch, cfg=cfg, generator=gen)[1],
        lambda: st.params, (bops, tops, mask_counter(dops.drop_mask)))
    st_p = create_train_state(params, state, tcfg)
    gen_p = torch.Generator().manual_seed(6)
    report_times(torch, "dropout training",
                 lambda: train_step(st, batch, cfg=cfg, generator=gen),
                 lambda: train_step(st_p, batch, cfg=plain_cfg,
                                    generator=gen_p), gpu)
    return results, launches


def option_kernel_cases(torch, tops, bops, gen):
    """The QuanInput options at the train shapes (bits_i=8, batch 24, tile
    2): (kernel, label, make_out, call, bound, work, library, row name,
    product alone). No PyTorch call computes a quantized or STE-gated
    function; beside the r=64 case of each the product alone in bf16
    (``torch.mm``, ``F.conv2d``, ``conv2d_input`` / ``conv2d_weight``).
    The gate cases' stage inputs straddle 1.0 after bf16 rounding: x on the
    bf16 grid around 1 and an affine of 1 - 2^-10 shift, so x = 1.0 gives
    z = 0.99902 in float32, 1.0 in bf16 (gated) and x = 0.99609375 gives
    z = 0.99511 (passes)."""
    dev = "cuda"
    c, g, cb, cls, h0, n = 128, 32, 128, 16, 64, TRAIN_BATCH
    m64 = n * h0 * h0

    def vec(x):
        return tile_vec(torch, tops, x, gen)[2]

    def f32(*shape):
        return empty_of(torch, torch.float32, *shape)

    def bf16(*shape):
        return empty_of(torch, torch.bfloat16, *shape)

    def straddle(m, k):
        grid = torch.tensor([0.98828125, 0.9921875, 0.99609375, 1.0,
                             1.0078125, 0.5, -0.25, 1.5])
        idx = torch.randint(0, len(grid), (m, k), generator=gen)
        x = grid[idx].to(dev, torch.bfloat16)
        v = torch.stack([torch.ones(k), torch.full((k,), -2.0 ** -10)])
        return x, v.to(dev)

    yb = (torch.randn(m64, cb, generator=gen) * 2).to(dev, torch.bfloat16)
    vb = vec(yb)
    w3 = (torch.randn(9 * cb, g, generator=gen) * (9 * cb) ** -0.5).to(
        dev, torch.bfloat16)
    d_o = torch.randn(m64, g, generator=gen).to(dev, torch.bfloat16)
    y_out = (torch.randn(m64, c, generator=gen) * 2).to(dev, torch.bfloat16)
    vh = vec(y_out)
    w_h = (torch.randn(c, cls, generator=gen) * c ** -0.5).to(
        dev, torch.bfloat16)
    d_head = torch.randn(m64, cls, generator=gen).to(dev, torch.bfloat16)
    xs3, vs3 = straddle(m64, cb)
    xsh, vsh = straddle(m64, c)
    conv_ops = 2 * m64 * 9 * cb * g
    w_oihw = w3.view(3, 3, cb, g).permute(3, 2, 0, 1).contiguous()
    nn_grad = torch.nn.grad
    q = 8
    # the quantized conv, its dW and the gated dx at the lower resolutions,
    # after r=64
    lower = []
    for r in CONV_RES[1:]:
        m = n * r * r
        y_r = (torch.randn(m, cb, generator=gen) * 2).to(dev, torch.bfloat16)
        v_r = vec(y_r)
        d_r = torch.randn(m, g, generator=gen).to(dev, torch.bfloat16)
        ops_r = 2 * m * 9 * cb * g
        xs_r, vs_r = straddle(m, cb)
        lower += [
            (bops.conv3x3, f"Cb=128->32 r={r} quan(relu(BN2)) prologue",
             bf16(m, g), lambda f, o, y_r=y_r, v_r=v_r, r=r:
             f(y_r, w3, n, r, r, o, vec=v_r, bits_i=q), ("bf16",),
             work(sz(m, cb) + vec_bytes(cb) + sz(9 * cb, g) + sz(m, g),
                  ops_r), None, "conv3x3[bits_i]", None),
            (tops.conv3x3_dw, f"(9*128, 32) r={r} quantized z",
             f32(9 * cb, g), lambda f, o, y_r=y_r, v_r=v_r, d_r=d_r, r=r:
             f(y_r, v_r, d_r, n, r, r, o, bits_i=q), ("sum", m),
             work(sz(m, cb) + vec_bytes(cb) + sz(m, g)
                  + sz(9 * cb, g, e=4), ops_r), None, "conv3x3_dw[bits_i]",
             None),
            (tops.conv3x3_dx, f"32->128 r={r} STE gate, straddling 1.0",
             f32(m, cb), lambda f, o, d_r=d_r, xs_r=xs_r, vs_r=vs_r, r=r:
             f(d_r, w3, n, r, r, xs_r, vs_r, o, ste=True), ("sum", 9 * g),
             work(sz(m, g) + sz(9 * cb, g) + sz(m, cb) + sz(2, cb, e=4)
                  + sz(m, cb, e=4), ops_r), None, "conv3x3_dx[ste]", None),
        ]
    return [
        (bops.conv3x3, "Cb=128->32 r=64 quan(relu(BN2)) prologue",
         bf16(m64, g), lambda f, o: f(yb, w3, n, h0, h0, o, vec=vb,
                                      bits_i=q), ("bf16",),
         work(sz(m64, cb) + vec_bytes(cb) + sz(9 * cb, g) + sz(m64, g),
              conv_ops),
         None, "conv3x3[bits_i]",
         lambda: torch.nn.functional.conv2d(nchw(yb, h0), w_oihw,
                                            padding=1)),
        (bops.affine_dot, "head 128->16 r=64 quantized", bf16(m64, cls),
         lambda f, o: f(y_out, vh, w_h, o, bits_i=q), ("bf16",),
         work(sz(m64, c) + vec_bytes(c) + sz(c, cls) + sz(m64, cls),
              2 * m64 * c * cls), None, "affine_dot[bits_i]",
         lambda: torch.mm(y_out, w_h)),
        (tops.conv3x3_dw, "(9*128, 32) r=64 quantized z", f32(9 * cb, g),
         lambda f, o: f(yb, vb, d_o, n, h0, h0, o, bits_i=q), ("sum", m64),
         work(sz(m64, cb) + vec_bytes(cb) + sz(m64, g) + sz(9 * cb, g, e=4),
              conv_ops), None, "conv3x3_dw[bits_i]",
         lambda: nn_grad.conv2d_weight(nchw(yb, h0), (g, cb, 3, 3),
                                       nchw(d_o, h0), padding=1)),
        (tops.affine_dw, "head 128->16 r=64 quantized z", f32(c, cls),
         lambda f, o: f(y_out, vh, d_head, o, bits_i=q), ("sum", m64),
         work(sz(m64, c) + vec_bytes(c) + sz(m64, cls) + sz(c, cls, e=4),
              2 * m64 * c * cls), None, "affine_dw[bits_i]",
         lambda: torch.mm(y_out.t(), d_head)),
        (tops.conv3x3_dx, "32->128 r=64 STE gate, straddling 1.0",
         f32(m64, cb), lambda f, o: f(d_o, w3, n, h0, h0, xs3, vs3, o,
                                      ste=True), ("sum", 9 * g),
         work(sz(m64, g) + sz(9 * cb, g) + sz(m64, cb) + sz(2, cb, e=4)
              + sz(m64, cb, e=4), conv_ops), None, "conv3x3_dx[ste]",
         lambda: nn_grad.conv2d_input((n, cb, h0, h0), w_oihw,
                                      nchw(d_o, h0), padding=1)),
        (tops.affine_dx, "head 128->16 r=64 STE gate, straddling 1.0",
         f32(m64, c), lambda f, o: f(d_head, w_h, xsh, vsh, o, ste=True),
         ("sum", cls),
         work(sz(m64, cls) + sz(c, cls) + sz(m64, c) + sz(2, c, e=4)
              + sz(m64, c, e=4), 2 * m64 * c * cls), None, "affine_dx[ste]",
         lambda: torch.mm(d_head, w_h.t())),
    ] + lower


def quan_exact_checks(torch, tops, bops, gen):
    """QuanInput's quantizer in the four quantized prologues, bit for bit,
    at the r=64 train shapes (bits_i=8). Each product is made exact: an
    identity 1x1 and one-hot 3x3 taps give outputs that are one quantized
    activation each; a {0, 1} cotangent gives dW sums of multiples of 2^-7
    below 2^17, which float32 holds exactly in any order. So each kernel
    output must equal a float64 reference built from the plain quantizer
    (``quantize_act``). Prints how many activations sit on a rounding tie
    or above the clip and how many outputs a round-half-even or a floor
    quantizer would change: what the check tells apart."""
    from cunet_tpu_torch.kernels.buf_ops import quantize_act, tile_affine

    q, n, cb, g, cls, r = 8, TRAIN_BATCH, 128, 32, 16, 64
    m = n * r * r
    x = (torch.randn(m, cb, generator=gen) * 2).to("cuda", torch.bfloat16)
    v = tile_vec(torch, tops, x, gen)[2]
    z = torch.relu(tile_affine(x, v)).to(torch.bfloat16)
    zq = quantize_act(z, q)
    s, lim = 2.0 ** (q - 1), 1 - 2.0 ** (1 - q)
    y = z.float().clamp(max=lim) * s
    print(f"quantizer exact: {m} x {cb} activations, "
          f"{int((y.frac() == 0.5).sum())} on a rounding tie, "
          f"{int((z.float() > lim).sum())} above the clip; a round-half-even "
          f"quantizer would change {int((y.round() / s != zq.float()).sum())} "
          f"of them, a floor quantizer "
          f"{int((y.floor() / s != zq.float()).sum())}", flush=True)

    padded = torch.nn.functional.pad(zq.view(n, r, r, cb).double(),
                                     (0, 0, 1, 1, 1, 1))

    def tap(t):                 # z at (row + ky - 1, col + kx - 1), 0 outside
        ky, kx = divmod(t, 3)
        return padded[:, ky:ky + r, kx:kx + r].reshape(m, cb)

    def bits(p):
        return (torch.rand(m, p, generator=gen) < 0.5).to(
            "cuda", torch.bfloat16)

    cases = []
    out = torch.empty(m, cb, device="cuda", dtype=torch.bfloat16)
    eye = torch.eye(cb, device="cuda", dtype=torch.bfloat16)
    bops.affine_dot(x, v, eye, out, bits_i=q)
    cases.append(("affine_dot identity 128->128", out, zq))
    for grp in range(cb // g):               # output o reads channel grp*g+o
        w3 = torch.zeros(9, cb, g, device="cuda", dtype=torch.bfloat16)
        taps = [(o + grp) % 9 for o in range(g)]
        w3[taps, [grp * g + o for o in range(g)], list(range(g))] = 1
        out = torch.empty(m, g, device="cuda", dtype=torch.bfloat16)
        bops.conv3x3(x, w3.view(9 * cb, g), n, r, r, out, vec=v, bits_i=q)
        want = torch.stack([tap(t)[:, grp * g + o]
                            for o, t in enumerate(taps)], 1)
        cases.append((f"conv3x3 one-hot taps, channels {grp * g}.."
                      f"{grp * g + g - 1}", out, want))
    dy = bits(cls)
    out = torch.empty(cb, cls, device="cuda")
    tops.affine_dw(x, v, dy, out, bits_i=q)
    cases.append(("affine_dw {0,1} cotangent 128->16", out,
                  zq.double().t() @ dy.double()))
    dy = bits(g)
    out = torch.empty(9 * cb, g, device="cuda")
    tops.conv3x3_dw(x, v, dy, n, r, r, out, bits_i=q)
    cases.append(("conv3x3_dw {0,1} cotangent (9*128, 32)", out, torch.cat(
        [tap(t).t() @ dy.double() for t in range(9)])))
    torch.cuda.synchronize()
    for label, got, want in cases:
        diff = int((got.double() != want.double()).sum())
        print(f"quantizer exact: {label}: {diff} of {got.numel()} outputs "
              f"differ from the plain quantizer's", flush=True)
        require(diff == 0, f"quantizer exact [{label}]: {diff} outputs "
                f"differ")


def phase_option_kernels(torch, tops, bops):
    """Phase 8's kernel half: each QuanInput option against its plain
    version (the gates bit for bit), then the quantizer's exact checks."""
    gen = torch.Generator().manual_seed(7)
    plain_of = {**bops.PLAIN, **tops.PLAIN}
    results = {}
    for case in option_kernel_cases(torch, tops, bops, gen):
        kern, label, make_out, call, bnd, w, lib, name, prod = case
        got, want = check_case(torch, plain_of, results, "option kernel",
                               kern, label, make_out, call, bnd, w, lib,
                               name=name, product=prod)
        if name.endswith("[ste]"):
            passed = (got != 0).float().mean().item()
            same = torch.equal(got == 0, want == 0)
            print(f"option kernel {name}: gate bit-identical to the plain "
                  f"version {same} (passes {passed:.4f} of the elements)",
                  flush=True)
            require(same, f"{name}: the STE gate differs from its plain "
                    f"version")
            require(0.05 < passed < 0.95, f"{name}: degenerate gate")
    quan_exact_checks(torch, tops, bops, gen)
    return results


def phase_quant_training(torch, tops, bops, dops, gpu):
    """Phase 8: the QuanInput options against their plain versions, then
    CU-Net-8 @256 through quant_train_step (W1/I8/G8): kernel step against
    plain step held to a same-run control, three quant_train_steps (the
    main path), times."""
    from cunet_tpu_torch import QuantConfig, TrainConfig
    from cunet_tpu_torch.quant import preprocess_masters
    from cunet_tpu_torch.quant import selected_conv_predicate
    from cunet_tpu_torch.train import create_train_state, quant_train_step

    results = phase_option_kernels(torch, tops, bops)

    quant = QuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True)
    cfg, params, state, batch = flagship_train(torch)
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    masters = preprocess_masters(params, quant,
                                 selected_conv_predicate(params, "reference"))
    compare_steps(torch, "quantized training", cfg, masters, state,
                  batch["image"], batch["heatmap"], controlled=True,
                  quant=quant)

    tcfg = TrainConfig(lr=2.5e-4, batch_size=TRAIN_BATCH)
    st = create_train_state(params, state, tcfg)
    launches = main_path_steps(
        torch, "quantized training",
        lambda: quant_train_step(st, batch, cfg=cfg, qcfg=quant)[1],
        lambda: st.params, (bops, tops, bops.option_counts,
                            tops.option_counts))
    st_p = create_train_state(params, state, tcfg)
    report_times(torch, "quantized training",
                 lambda: quant_train_step(st, batch, cfg=cfg, qcfg=quant),
                 lambda: quant_train_step(st_p, batch, cfg=plain_cfg,
                                          qcfg=quant), gpu)
    return results, launches


# ---------------------------------------------------------------------------
# phase 6: int8 serving
# ---------------------------------------------------------------------------


def int8_kernel_cases(torch, gen, f32=False):
    """(kernel name, label, destination, view selector, call(fn, out),
    work) of the three int8 kernels at the CU-Net-8 @256 int8 main-path shapes
    (c=128, g=32, Cb=128, cls=16, h0=64, batch 8; every bottleneck and
    adapter K), plus ragged cases: K not a multiple of 32, M not a multiple
    of the 128-row tile, Cb not a multiple of 16, unaligned int8 rows; then
    the whole-model kernels at ``bench.py``'s batches 64 and 256, order
    14's widest K (704 +BN2,q8 and 736), a K past the resident weight
    (2048, streamed) and the 68-class head (72 columns). With ``f32`` the
    float32 model's (activations and outputs float32; no
    ``int8_matmul_dequant``, whose output is float32 at every dtype). The
    whole-model kernels get their weights' K-major images where the
    checkout packs them (``quant_ops.pack_w_i8`` / ``pack_w3_i8``, packed
    once as the slots are marshalled), so a call is the kernel alone."""
    from cunet_tpu_torch.kernels import quant_ops as qops

    dev = "cuda"
    c, g, cb, cls, h0, n = 128, 32, 128, 16, 64, BATCH
    s = 128.0                                   # 2^(bits_i - 1), bits_i 8
    act_dt, e = (torch.float32, 4) if f32 else (torch.bfloat16, 2)
    pack = getattr(qops, "pack_w_i8", None)
    pack3 = getattr(qops, "pack_w3_i8", None)

    def wt(w):                                  # the image, where packed
        return {"wt": pack(w)} if pack else {}

    def wt3(w3):
        return {"wt": pack3(w3)} if pack3 else {}

    def bf16(*shape, scale=1.0):                # an activation or output
        return (torch.randn(*shape, generator=gen) * scale).to(dev, act_dt)

    def signs(k, m):                            # binarized weights
        return torch.randint(-1, 2, (k, m), generator=gen,
                             dtype=torch.int8).to(dev)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen,
                             dtype=torch.int8).to(dev)

    def vec(k, lo=0.5, hi=1.5, shift=0.5):
        inv = torch.rand(k, generator=gen) * (hi - lo) + lo
        return torch.stack([inv, torch.randn(k, generator=gen) * shift]).to(
            dev)

    m64 = n * h0 * h0
    down = bf16(m64, c + g + g, scale=0.5)     # [y | fifo | out32]
    up = bf16(m64, 2 * c + g + g, scale=0.5)   # [up_y | skip | fifo | out32]
    cases = []
    # affine_dot_i8: bottlenecks (BN2 + q8 epilogue into int8 rows) at every
    # bottleneck K, adapters (bf16 into buffer views) at every adapter K
    def dot_i8(m, k, nout, out_e, v2=False):   # x, vec, int8 w
        out_e = 1 if out_e == 1 else e
        return work(sz(m, k, e=e) + sz(2, k, e=4) + sz(k, nout, e=1)
                    + (sz(2, nout, e=4) if v2 else 0) + sz(m, nout, e=out_e),
                    2 * m * k * nout, "int8")

    def bn2_case(label, m, k, src, nout=cb):   # BN2 + q8 into int8 rows
        v, w, v2 = vec(k), signs(k, nout), vec(nout, 0.01, 0.05, 0.3)
        cases.append(("affine_dot_i8", label, codes(m, nout), lambda b: b,
                      lambda f, b, src=src, k=k, v=v, w=w, v2=v2, kw=wt(w):
                      f(src[:, :k], v, w, b, s=s, vec2=v2, **kw),
                      dot_i8(m, k, nout, 1, True)))

    def adapter_case(label, m, k, src):         # into a buffer view
        v, w = vec(k), signs(k, c)
        cases.append(("affine_dot_i8", label, bf16(m, 2 * c + g + g),
                      lambda b: b[:, c:2 * c],
                      lambda f, b, src=src, k=k, v=v, w=w, kw=wt(w):
                      f(src[:, :k], v, w, b[:, c:2 * c], s=s, **kw),
                      dot_i8(m, k, c, 2)))

    def head_case(label, ncls):                 # into anchor slot 3
        vh, wh = vec(c), signs(c, ncls)
        cases.append(("affine_dot_i8", label, bf16(n, 8, h0, h0, ncls),
                      lambda b: b[:, 3],
                      lambda f, b, vh=vh, wh=wh, kw=wt(wh):
                      f(down[:, :c], vh, wh,
                        b[:, 3].view(n, h0 * h0, ncls), s=s, **kw),
                      dot_i8(m64, c, ncls, 2)))

    def conv_case(label, m, r, b_):             # into the out32 slot
        y = codes(m, cb).clamp_(min=0)          # relu'd codes
        w3 = signs(9 * cb, g)
        cases.append(("conv3x3_i8", label, bf16(m, c + 2 * g),
                      lambda b: b[:, c + g:],
                      lambda f, b, y=y, w3=w3, r=r, kw=wt3(w3):
                      f(y, w3, b_, r, r, b[:, c + g:], s=s, **kw),
                      work(sz(m, cb, e=1) + sz(9 * cb, g, e=1)
                           + sz(m, g, e=e), 2 * m * 9 * cb * g, "int8")))

    for k, src in ((128, down), (160, down), (256, up), (288, up)):
        bn2_case(f"K={k}->128 +BN2,q8 r=64", m64, k, src)
    for k, src in ((192, down), (160, down), (320, up), (288, up)):
        adapter_case(f"K={k}->128 r=64", m64, k, src)
    head_case(f"head K=128->{cls} r=64", cls)
    # ragged: K=40, M=1000 (7.8 row tiles), N=24, both epilogues
    xr = bf16(1000, 48, scale=0.5)
    vr, wr, v2r = vec(48), signs(48, 24), vec(24, 0.01, 0.05, 0.3)
    cases.append(("affine_dot_i8", "ragged K=40->24 M=1000 +BN2,q8",
                  codes(1000, 24), lambda b: b,
                  lambda f, b, kw=wt(wr):
                  f(xr[:, :40], vr, wr, b, s=s, vec2=v2r, **kw),
                  dot_i8(1000, 40, 24, 1, True)))
    cases.append(("affine_dot_i8", "ragged K=40->24 M=1000",
                  bf16(1000, 40), lambda b: b[:, 8:32],
                  lambda f, b, kw=wt(wr):
                  f(xr[:, :40], vr, wr, b[:, 8:32], s=s, **kw),
                  dot_i8(1000, 40, 24, 2)))
    # conv3x3_i8: Cb=128 -> 32 into the out32 slot at r=64 and r=4
    for r in (64, 4):
        conv_case(f"Cb=128->32 r={r}", n * r * r, r, n)
    # ragged conv: Cb=24 (byte loads), 3 images of 6x6 (M=108), G=8
    yr, w3r = codes(108, 24), signs(9 * 24, 8)
    cases.append(("conv3x3_i8", "ragged Cb=24->8 r=6 M=108", bf16(108, 16),
                  lambda b: b[:, 8:],
                  lambda f, b, kw=wt3(w3r):
                  f(yr, w3r, 3, 6, 6, b[:, 8:], s=s, **kw),
                  work(sz(108, 24, e=1) + sz(216, 8, e=1) + sz(108, 8, e=e),
                       2 * 108 * 216 * 8, "int8")))
    # the whole-model kernels at bench.py's batches 64 and 256 (r=64), order
    # 14's widest K, a K past the resident weight, the 68-class head
    for nb_ in (64, 256):
        m = nb_ * h0 * h0
        big = bf16(m, 2 * c + g + g, scale=0.5)
        bn2_case(f"K=128->128 +BN2,q8 r=64 batch {nb_}", m, 128, big)
        adapter_case(f"K=320->128 r=64 batch {nb_}", m, 320, big)
        conv_case(f"Cb=128->32 r=64 batch {nb_}", m, 64, nb_)
        del big
    wide = bf16(m64, 2 * c + 15 * g + g, scale=0.5)   # the up buffer at 14
    bn2_case("order 14 K=704->128 +BN2,q8 r=64", m64, 2 * c + 14 * g, wide)
    adapter_case("order 14 K=736->128 r=64", m64, 2 * c + 15 * g, wide)
    m32 = n * 32 * 32
    deep = bf16(m32, 2048, scale=0.5)
    bn2_case("streamed K=2048->128 +BN2,q8 r=32", m32, 2048, deep)
    adapter_case("streamed K=2048->128 r=32", m32, 2048, deep)
    head_case("head K=128->72 r=64 (68 classes)", 72)
    if f32:
        return cases
    # int8_matmul_dequant: the plain path's 1x1 convs at every K
    ones = torch.ones(c, device=dev)

    def mm_i8(m, k, nout):                     # int8 x, w, f32 scales, out
        return work(sz(m, k, e=1) + sz(k, nout, e=1) + sz(nout, e=4)
                    + sz(m, nout, e=4), 2 * m * k * nout, "int8")

    for k in (128, 160, 192, 256, 288, 320):
        x, w = codes(m64, k).clamp_(min=0), signs(k, c)
        cases.append(("int8_matmul_dequant", f"K={k}->128 r=64", None, None,
                      lambda f, x=x, w=w: f(x, w, ones, 1 / s),
                      mm_i8(m64, k, c)))
    # ragged: K=20 (unaligned 20-byte rows), M=1000, N=24, column scales
    xq, wq = codes(1000, 20), codes(20, 24)
    cs = torch.rand(24, generator=gen).to(dev)
    cases.append(("int8_matmul_dequant", "ragged K=20->24 M=1000", None,
                  None, lambda f: f(xq, wq, cs, 1 / s), mm_i8(1000, 20, 24)))
    return cases


def int8_products(torch, gen):
    """``torch._int_mm`` of each int8 kernel's product alone at its
    headline shape (batch 8, r=64): the 1x1 K=128 -> 128 on int8 codes and
    {-1, 0, +1} weights, and the 3x3 conv Cb=128 -> 32 as one product of
    its im2col rows (9 x 128 deep), made beforehand. No PyTorch call
    computes the kernels' functions (quantizer, BN, dequantization)."""
    dev, m = "cuda", BATCH * 64 * 64

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen,
                             dtype=torch.int8).to(dev)

    def signs(k, n):   # column-major, as cuBLASLt's int8 product takes it
        return torch.randint(-1, 2, (n, k), generator=gen,
                             dtype=torch.int8).to(dev).t()

    x, w = codes(m, 128), signs(128, 128)
    col, w3 = codes(m, 9 * 128), signs(9 * 128, 32)
    dot = lambda: torch._int_mm(x, w)          # noqa: E731
    return {"affine_dot_i8": dot, "int8_matmul_dequant": dot,
            "conv3x3_i8": lambda: torch._int_mm(col, w3)}


def phase_int8_kernels(torch, qops, f32=False):
    """Each int8 kernel against its plain version on the same operands:
    the outputs must be bit-identical (integer products accumulate exactly
    in any order; every float rounding point is shared); beside each,
    ``torch._int_mm`` of its product alone (``int8_products``). With
    ``f32`` the float32 forms of the two kernels of the whole-model path,
    their rows ``name[f32]``, each launch counted as a float32 one."""
    gen = torch.Generator().manual_seed(33 if f32 else 3)
    products = int8_products(torch, torch.Generator().manual_seed(30))
    results = {}
    for name, label, dst, sel, call, w in int8_kernel_cases(torch, gen,
                                                            f32):
        kern = getattr(qops, name)
        f32_before = getattr(kern, "f32_launches", 0)
        plain = qops.PLAIN[kern]
        if dst is None:                          # returns a new tensor
            got = call(kern)
            want = torch.empty_like(got)
            call(lambda *a: plain(*a, want))
            run_k, run_p = (lambda: call(kern)), (lambda: call(
                lambda *a: plain(*a, want)))
            untouched = True
        else:
            k_buf, p_buf = dst.clone(), dst.clone()
            call(kern, k_buf)
            call(plain, p_buf)
            got, want = sel(k_buf), sel(p_buf)
            outside = k_buf.clone()
            sel(outside).copy_(sel(dst))
            untouched = torch.equal(outside, dst)
            run_k, run_p = (lambda: call(kern, k_buf)), (
                lambda: call(plain, p_buf))
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        err = (got.float() - want.float()).abs().max().item()
        ms = cuda_time_ms(run_k)
        plain_ms = cuda_time_ms(run_p)
        if f32:
            require(kern.f32_launches > f32_before and got.dtype in (
                torch.float32, torch.int8), f"{name} [{label}]: no float32 "
                f"launch")
            name = f"{name}[f32]"
        print(f"int8 kernel {name} [{label}]: bit-identical {same} "
              f"(max_abs_err {err:.4g}), outside view untouched "
              f"{untouched}, {ms:.4f} ms vs plain {plain_ms:.4f} ms",
              flush=True)
        require(same, f"{name} [{label}] differs from its plain version: "
                f"max_abs_err {err}")
        require(untouched, f"{name} [{label}] wrote outside its view")
        prod_ms = (cuda_time_ms(products.pop(name.split("[")[0]))
                   if name.split("[")[0] in products else None)
        record(results, name, err, ms, plain_ms, label, w, None, prod_ms)
    return results


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def phase_int8_serving(torch, ops, qops, gpu, float_ms):
    """CU-Net-8 @256 bf16, quantized W1/I8/G8 (``bench.py``'s int8
    configuration), params ``quant_eval_params`` of the port's init (seed
    0): serving on the int8 kernel path (the main path), the bit-identical
    check of its int8 kernels at every launch of a request, the plain
    path with ``int8_impl="pallas"`` (kernel #10) against ``"lax"``, the
    kernel path against the plain path beside a same-run control, and
    timing."""
    from cunet_tpu_torch import ModelConfig, QuantConfig
    from cunet_tpu_torch.kernels import model_buf
    from cunet_tpu_torch.models import init_cu_net
    from cunet_tpu_torch.serving import Predictor
    from cunet_tpu_torch.train import quant_eval_params

    cfg = ModelConfig(layer_num=8, order=1, class_num=16, loss_num=8,
                      compute_dtype="bfloat16", use_pallas=True,
                      pallas_whole_model=True)
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    quant = QuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True,
                        int8_infer=True, int8_impl="pallas")
    lax = dataclasses.replace(quant, int8_impl="lax")
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0))
    qparams = quant_eval_params(params, quant)
    values = {float(u) for k, v in qparams.items() if k.endswith("conv2")
              for u in v.unique()}
    require(values <= {-1.0, 0.0, 1.0}, f"quantized 3x3 weights {values}")

    def predictor(c, q, batch=BATCH, flip=True):
        return Predictor(c, qparams, state, device="cuda", batch_size=batch,
                         flip_test=flip, quant=q)

    pred = predictor(cfg, quant)
    rng = np.random.RandomState(0)
    requests = [rng.rand(k, 256, 256, 3).astype(np.float32)
                for k in (8, 5, 11)]

    # ---- the main path: int8 serving on the kernels ----
    ops.reset_launch_counts()
    qops.reset_launch_counts()
    answers = [(pred.heatmaps(imgs), pred.predict(imgs))
               for imgs in requests]
    torch.cuda.synchronize()
    launches = {**ops.launch_counts(), **qops.launch_counts()}
    print(f"int8 serving: launches on the main path {launches}", flush=True)
    for imgs, (hm, pts) in zip(requests, answers):
        k = imgs.shape[0]
        print(f"int8 serving: request of {k}: heatmaps {hm.shape} "
              f"max|hm| {np.abs(hm).max():.4g}, landmarks {pts.shape}",
              flush=True)
        require(hm.shape == (k, 64, 64, 16), f"heatmaps shape {hm.shape}")
        require(pts.shape == (k, 16, 2), f"landmarks shape {pts.shape}")
        require(np.isfinite(hm).all() and np.isfinite(pts).all(),
                "non-finite output")
        require(np.abs(hm).max() > 0, "all-zero heatmaps")
    for name in ("affine_dot_i8", "conv3x3_i8", "affine_dot", "maxpool2",
                 "upsample2"):
        require(launches[name] > 0,
                f"kernel {name} never launched on the int8 main path")
    require(launches["int8_matmul_dequant"] == 0,
            "int8_matmul_dequant launched on the whole-model path")

    # ---- the same forward with the int8 kernels' plain versions ----
    got = answers[0][0]
    saved = (model_buf.affine_dot_i8, model_buf.conv3x3_i8)
    model_buf.affine_dot_i8 = qops.PLAIN[qops.affine_dot_i8]
    model_buf.conv3x3_i8 = qops.PLAIN[qops.conv3x3_i8]
    try:
        want = pred.heatmaps(requests[0])
    finally:
        model_buf.affine_dot_i8, model_buf.conv3x3_i8 = saved
    print(f"int8 serving: kernel path vs the same path on the int8 "
          f"kernels' plain versions, request of 8: bit-identical "
          f"{np.array_equal(got, want)}", flush=True)
    require(np.array_equal(got, want),
            "the int8 kernels' forward differs from their plain versions'")

    # ---- the plain path on kernel #10: the second path ----
    plain_k = predictor(plain_cfg, quant)
    qops.reset_launch_counts()
    hm_k = plain_k.heatmaps(requests[0])
    torch.cuda.synchronize()
    plain_launches = qops.launch_counts()
    hm_l = predictor(plain_cfg, lax).heatmaps(requests[0])
    print(f"int8 plain path: launches {plain_launches}; int8_impl "
          f"'pallas' vs 'lax' bit-identical {np.array_equal(hm_k, hm_l)}",
          flush=True)
    require(plain_launches["int8_matmul_dequant"] > 0,
            "int8_matmul_dequant never launched on the plain int8 path")
    require(np.array_equal(hm_k, hm_l),
            "the plain int8 path on int8_matmul_dequant differs from lax")

    # ---- kernel path against the plain path, beside a control ----
    # Each anchor of one request of 8, no flip test. The binarized model is
    # chaotic at this init (a rounding difference anywhere decorrelates
    # the later heatmaps, PERF.md section 6), so the kernel path is held,
    # as the training phase's slot check is, against a control measured
    # here: the plain path with its BN affine in bf16 (bn_dtype "compute")
    # against the plain path with its float32 affine (the reference).
    from cunet_tpu_torch.models import apply_cu_net

    qp, st = pred.params, pred.bn_state
    x = torch.from_numpy(requests[0]).to("cuda", torch.bfloat16)
    ctl_cfg = dataclasses.replace(plain_cfg, bn_dtype="compute")
    with torch.inference_mode():
        outs = [apply_cu_net(qp, st, x, cfg=c, quant=q, slots=sl)[0]
                for c, q, sl in ((cfg, quant, pred._slots),
                                 (plain_cfg, lax, None),
                                 (ctl_cfg, lax, None))]
    k_rel, c_rel = [], []
    for a in range(len(cfg.anchors)):
        kk, pp, cc = (o[a].float().cpu().numpy() for o in outs)
        k_rel.append(_rel(kk, pp))
        c_rel.append(_rel(cc, pp))
    print(f"int8 serving: kernel path vs plain path (lax, f32 BN affine), "
          f"request of 8, relative L2 per anchor "
          f"{[round(v, 4) for v in k_rel]} (mean {np.mean(k_rel):.4f}); "
          f"control (plain, bf16 BN affine) {[round(v, 4) for v in c_rel]} "
          f"(mean {np.mean(c_rel):.4f}); bound: mean <= control mean + "
          f"{INT8_PATH_MARGIN}", flush=True)
    require(np.isfinite(k_rel).all()
            and np.mean(k_rel) <= np.mean(c_rel) + INT8_PATH_MARGIN,
            f"int8 kernel path off the plain path: mean relative L2 "
            f"{np.mean(k_rel)} > control {np.mean(c_rel)} + "
            f"{INT8_PATH_MARGIN}")

    # ---- timing ----
    for label, c, q, batch in (("kernel", cfg, quant, BATCH),
                               ("kernel", cfg, quant, 64),
                               ("plain lax", plain_cfg, lax, BATCH),
                               ("plain lax", plain_cfg, lax, 64),
                               ("plain pallas", plain_cfg, quant, BATCH)):
        p = predictor(c, q, batch, flip=False)
        ms = time_forward(torch, p, batch)
        print(f"int8 serving: forward batch {batch}: {ms:.3f} ms, "
              f"{batch / ms * 1e3:.1f} img/s (int8 {label} path; float "
              f"kernel path {float_ms[batch]:.3f} ms; {gpu})", flush=True)
    return launches, plain_launches


# ---------------------------------------------------------------------------
# phase 9: whole-batch BN training on the per-bottleneck train kernel
# ---------------------------------------------------------------------------

TB_WIDTHS = (128, 128, 32, 32)   # the up-block adapter: [x, skip, fifo, out]


def tb_operands(torch, gen, r, dev="cuda", dtype=None, widths=TB_WIDTHS,
                cout=128):
    """The adapter's operands at resolution r, batch 24: four feature
    tensors (the fifo entry a strided view of a wider buffer, as a FIFO
    slice is), the forward's [inv; shift], the backward's [mean;
    inv_sigma; scale] and bias, float32 weights (``wa``: apply's, in the
    features' dtype), an output cotangent of ``cout`` outputs and red =
    [mean g_y; mean g_y x_hat] from the plain reduce and, at float32 where
    the checkout has them, g's planes (``planes``: the pre-pass's, written
    by the plain reduce); features and cotangent in ``dtype`` (bf16 by
    default). Other ``widths``: those feature tensors, none a view."""
    from cunet_tpu_torch.kernels import train_bottleneck as tbk

    m, k = TRAIN_BATCH * r * r, sum(widths)
    dtype = dtype or torch.bfloat16

    def bf16(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(
            dev, dtype)

    feats = [bf16(m, c, scale=1 + i % 4, shift=0.2 * (i % 4))
             for i, c in enumerate(widths)]
    if widths == TB_WIDTHS:
        feats[2] = torch.cat([feats[2], bf16(m, 64)], 1)[:, :TB_WIDTHS[2]]
    scale = (torch.rand(k, generator=gen) + 0.5).to(dev)
    bias = (torch.randn(k, generator=gen) * 0.3).to(dev)
    w = (torch.randn(k, cout, generator=gen) * k ** -0.5).to(dev)
    sums = tbk.stats_plain(feats, torch.empty(2, k, device=dev))
    mean = sums[0] / m
    var = sums[1] / m - mean * mean
    inv_sigma = torch.rsqrt(var + 1e-5)
    vec = torch.stack([inv_sigma * scale, bias - mean * inv_sigma * scale])
    stat = torch.stack([mean, inv_sigma, scale])
    g = bf16(m, cout)
    dw, red = torch.empty(k, cout, device=dev), torch.empty(2, k, device=dev)
    planes = None
    if dtype == torch.float32 and hasattr(tbk, "split_planes_plain"):
        planes = torch.empty(tbk.split_planes_shape(m, cout), device=dev,
                             dtype=torch.bfloat16)
    tbk.bwd_reduce_plain(feats, g, stat, bias, w, dw, red,
                         **({} if planes is None else {"planes": planes}))
    return dict(m=m, k=k, cout=cout, feats=feats, vec=vec, stat=stat,
                bias=bias, w=w, wa=w.to(dtype), g=g, red=red / m,
                dtype=dtype, planes=planes)


def tb_cases(torch, o):
    """(name, call(fn) -> outputs, bounds, work, library call or None,
    product alone or None) of the four kernels on the operands ``o``.
    bounds: per output ("bf16",) or ("sum", n[, split]), a split one held
    per feature group (``tb_pieces``); at float32 apply's output and each
    dx are float32 sums over Ctot and Cout. The work of the GEMMs is their
    kernels' arithmetic: each float32 product (2 M Ctot Cout; two in
    ``bwd_reduce``) as three bf16 tensor-core passes, the exact split of
    the float32 operand, and at float32 as six (both operands split;
    ``apply`` a bf16 product at bf16); ``f32_fma_ms`` gives the bound of
    the same products as float32 FMA. No PyTorch call computes a #7 GEMM
    (BN recompute, gate, jacobian or sums around it): the product alone is
    ``torch.mm`` of ``apply``'s operands and, for the two backward
    kernels, of g (as float32, converted beforehand) and W^T (TF32 off).
    At float32 ``bwd_dx`` reads ``o["planes"]`` where there are any (the
    main path's launch: the backward hands it the planes ``bwd_reduce``
    wrote; its bytes bound counts g as float32, the function's input)."""
    m, k, cout = o["m"], o["k"], o["cout"]
    f, dev, dt = o["feats"], o["feats"][0].device, o["dtype"]
    f32 = dt == torch.float32
    e = 4 if f32 else 2
    passes = 6 if f32 else 3
    feat_bytes = sz(m, k, e=e)
    small = sz(3, k, e=4) + sz(k, e=4) + sz(k, cout, e=4)   # stat, bias, w
    cat = torch.cat(f, 1)
    g32 = o["g"].float()
    out_bound = [("sum", k)] if f32 else [("bf16",)]
    widths = tuple(x.shape[1] for x in f)
    dx_bound = [("sum", cout) if f32 else ("bf16",)] * len(widths)
    handed = {} if o.get("planes") is None else {"planes": o["planes"]}

    def dxs():
        buf = torch.empty(m, k + 8, device=dev, dtype=dt)
        offs = np.cumsum((0,) + widths)
        return [buf[:, a:b] for a, b in zip(offs[:-1], offs[1:])]

    def gw():
        return torch.mm(g32, o["w"].t())

    return [
        ("stats", lambda fn: [fn(f, torch.empty(2, k, device=dev))],
         [("sum", m, "cols")],
         work(feat_bytes + sz(2, k, e=4), 3 * m * k, "f32"),
         lambda: torch.var_mean(cat, dim=0, correction=0), None),
        ("apply", lambda fn: [fn(f, o["vec"], o["wa"], torch.empty(
            m, cout, device=dev, dtype=dt))], out_bound,
         work(feat_bytes + sz(2, k, e=4) + sz(k, cout, e=e)
              + sz(m, cout, e=e), (6 if f32 else 1) * 2 * m * k * cout),
         None, lambda: torch.mm(cat, o["wa"])),
        ("bwd_reduce", lambda fn: list(fn(
            f, o["g"], o["stat"], o["bias"], o["w"],
            torch.empty(k, cout, device=dev), torch.empty(2, k, device=dev))),
         [("sum", m, "rows"), ("sum", m, "cols")],
         work(feat_bytes + sz(m, cout, e=e) + small + sz(k, cout, e=4)
              + sz(2, k, e=4), passes * 4 * m * k * cout), None, gw),
        ("bwd_dx", lambda fn: list(fn(f, o["g"], o["stat"], o["bias"],
                                      o["red"], o["w"], dxs(), **handed)),
         dx_bound,
         work(feat_bytes + sz(m, cout, e=e) + small + sz(2, k, e=4)
              + feat_bytes, passes * 2 * m * k * cout), None, gw),
    ]


def tb_pieces(t, bnd):
    """The parts of a #7 output that each meet their own limit: a float32
    reduction ("sum", n, split) one per feature group, over its columns
    ("cols", each row of a [sum; sum of squares] pair apart) or its rows
    ("rows", dW); any other output whole. So the sums of a group of small
    values answer to their own scale, not to that of a larger group's sums
    of squares."""
    if len(bnd) < 3:
        return [t]
    offs = np.cumsum((0,) + TB_WIDTHS)
    spans = list(zip(offs[:-1], offs[1:]))
    t = t.reshape(-1, t.shape[-1])
    if bnd[2] == "rows":
        return [t[a:b] for a, b in spans]
    return [t[i, a:b] for i in range(t.shape[0]) for a, b in spans]


def output_errors(torch, got, want, bounds):
    """(max |k - p| over the outputs, the largest share of its limit that
    a piece's error takes, True if every piece is within its limit)."""
    worst, share, ok = 0.0, 0.0, True
    for a, b, bnd in zip(got, want, bounds):
        for pa, pb in zip(tb_pieces(a.float(), bnd),
                          tb_pieces(b.float(), bnd)):
            err = (pa - pb).abs().max().item()
            lim = limit(bnd, pb.abs().max().item())
            part = err / lim if lim else (0.0 if err == 0 else float("inf"))
            worst, share = max(worst, err), max(share, part)
            ok = ok and bool(np.isfinite(err)) and err <= lim
    return worst, share, ok


def stats_faults(torch, tbk, o):
    """Three planted faults of the statistics kernel at the operands ``o``
    (group 0 zero-mean, of unit scale, beside groups of up to 4x its scale
    and shift): group 0 read at half its row stride, one row chunk of
    group 0 lost, group 0's sum row zeroed. Each must break the per-group
    limits. Returns (name, error, share of the whole-output limit, share
    of the per-group limit) per fault."""
    f, m, k = o["feats"], o["m"], o["k"]
    want = tbk.stats_plain(f, torch.empty(2, k, device=f[0].device))
    bnd = ("sum", m, "cols")
    f0 = f[0]
    lost = f0.clone()
    lost[:tbk.row_chunk(m)] = 0
    faults = [("group 0 at half its row stride",
               [f0.as_strided(f0.shape, (f0.stride(0) // 2, 1))] + f[1:]),
              ("one row chunk of group 0 lost", [lost] + f[1:]),
              ("group 0's sum row zeroed", f)]
    out = []
    for name, feats in faults:
        got = tbk.stats(feats, torch.empty(2, k, device=f0.device))
        if name.endswith("zeroed"):
            got[0, :TB_WIDTHS[0]] = 0
        err = (got - want).abs().max().item()
        whole = err / limit(bnd, want.abs().max().item())
        out.append((name, err, whole, output_errors(torch, [got], [want],
                                                    [bnd])[1]))
    return out


# float32 products (2 M Ctot Cout each) of the #7 backward kernels (and
# of apply at float32)
F32_PRODUCTS = {"bwd_reduce": 2, "bwd_dx": 1}
F32_PRODUCTS_F32 = {**F32_PRODUCTS, "apply": 1}


def f32_fma_ms(o, products):
    """``products`` float32 products of 2 M Ctot Cout flops as float32 FMA
    on the CUDA cores (at 67 TFLOP/s): the bound no CUDA-core design
    beats."""
    return 2 * products * o["m"] * o["k"] * o["cout"] / PEAK_OPS["f32"] * 1e3


def dx_alone_text(torch, tbk, o):
    """At float32, where ``bwd_dx`` reads the handed planes: the time of a
    call without them (the reduce's split of g launched first, as a
    caller outside the backward makes it), else ''."""
    if o.get("planes") is None:
        return ""
    f = o["feats"]
    dxs = [torch.empty_like(x) for x in f]
    ms = cuda_time_ms(lambda: tbk.bwd_dx(f, o["g"], o["stat"], o["bias"],
                                         o["red"], o["w"], dxs))
    return f", called alone (g split first) {ms * 1e3:.1f} us"


def phase_bn0_kernels(torch, tbk, dtype=None):
    """Each kernel of #7 against its plain version at every resolution r =
    64 ... 4 (r=64 first: the main path's largest call; ``stats`` at r=64
    and 4), timed with its plain version, with ``torch.var_mean`` over the
    same values for the statistics and with ``torch.mm`` of the product
    alone for the three GEMMs; at ``dtype`` float32 the kernels' float32
    forms, recorded as ``train_bottleneck.<name>[f32]``."""
    dtype = dtype or torch.bfloat16
    tag = "[f32]" if dtype == torch.float32 else ""
    products = F32_PRODUCTS_F32 if tag else F32_PRODUCTS
    gen = torch.Generator().manual_seed(13 if tag else 9)
    results = {}
    for r in CONV_RES:
        o = tb_operands(torch, gen, r, dtype=dtype)
        label = f"K=128+128+32+32->128 r={r}"
        for name, call, bounds, w, lib, prod in tb_cases(torch, o):
            if r not in (64, 4) and name == "stats":
                continue
            kern = getattr(tbk, name)
            got, want = call(kern), call(tbk.PLAIN[kern])
            torch.cuda.synchronize()
            err, share, ok = output_errors(torch, got, want, bounds)
            ms = cuda_time_ms(lambda: call(kern))
            plain_ms = cuda_time_ms(lambda: call(tbk.PLAIN[kern]))
            lib_ms = None if lib is None else cuda_time_ms(lib)
            prod_ms = None if prod is None else cuda_time_ms(prod)
            f32 = products.get(name)
            name = name + tag
            print(f"bn0 kernel train_bottleneck.{name}"
                  f"{fwd_note(f'train_bottleneck.{name}', tbk)} [{label}]: "
                  f"max_abs_err {err:.4g} (at most {share:.3g} of a "
                  f"{'/'.join(b[0] for b in bounds)} limit: {ok}), "
                  f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, library "
                  f"{lib_ms if lib_ms is None else f'{lib_ms:.4f} ms'}"
                  f"{product_text(prod_ms)}, bound {bound(w)[0]:.4f} ms "
                  f"({bound(w)[1]})"
                  + (f", float32-FMA bound {f32_fma_ms(o, f32):.4f} ms"
                     if f32 else "")
                  + (dx_alone_text(torch, tbk, o) if name == "bwd_dx" + tag
                     else ""),
                  flush=True)
            require(ok, f"train_bottleneck.{name} [{label}] disagrees with "
                    f"its plain version")
            record(results, f"train_bottleneck.{name}", err, ms, plain_ms,
                   label, w, lib_ms, prod_ms)
        if r == 64:
            for fault, err, whole, share in stats_faults(torch, tbk, o):
                print(f"bn0 planted fault of stats{tag} [{label}]: {fault}: "
                      f"max_abs_err {err:.4g}, {whole:.3g} of the "
                      f"whole-output limit, {share:.3g} of the per-group "
                      f"limit", flush=True)
                require(share > 1, f"the stats check misses a planted "
                        f"fault: {fault}")
    return results


@contextlib.contextmanager
def tb_plain_swapped(tbk, plain=True, kernels=None):
    """#7's four kernels (or ``kernels`` of them) swapped for their plain
    versions (``plain``) in ``tbk``, which the autograd Function calls by
    name."""
    kernels = tbk.KERNELS if kernels is None else kernels
    saved = {k.__name__: getattr(tbk, k.__name__) for k in kernels}
    if plain:
        for k in kernels:
            setattr(tbk, k.__name__, tbk.PLAIN[k])
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(tbk, name, fn)


def tb_function_grads(torch, tbk, o, ct, plain):
    """The autograd Function's output and gradients on operands ``o``
    under cotangent ``ct``, with the module's kernels or (``plain``) their
    plain versions swapped in."""
    with tb_plain_swapped(tbk, plain):
        n = TRAIN_BATCH
        r = int(round((o["m"] // n) ** 0.5))
        fs = [x.contiguous().view(n, r, r, -1).requires_grad_(True)
              for x in o["feats"]]
        sc = o["stat"][2].clone().requires_grad_(True)
        b = o["bias"].clone().requires_grad_(True)
        w = o["w"].view(1, 1, o["k"], o["cout"]).clone().requires_grad_(True)
        out, _, _ = tbk.fused_train_bottleneck(fs, sc, b, w)
        out.backward(ct)
        torch.cuda.synchronize()
        return [out] + [x.grad for x in fs] + [sc.grad, b.grad, w.grad]


def check_tb_function(torch, tbk, dtype=None):
    """(b): the Function's forward and backward on the kernels against the
    same Function on the plain versions, one r=64 adapter call; at float32
    the output within its Ctot-term and each d_feature within its
    Cout-term float32 limit."""
    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32
    o = tb_operands(torch, torch.Generator().manual_seed(10), 64,
                    dtype=dtype)
    ct = o["g"].view(TRAIN_BATCH, 64, 64, -1)
    got = tb_function_grads(torch, tbk, o, ct, plain=False)
    want = tb_function_grads(torch, tbk, o, ct, plain=True)
    names = (["out"] + [f"d_feature.{i}" for i in range(len(TB_WIDTHS))]
             + ["d_scale", "d_bias", "d_w"])
    bounds = ([("sum", o["k"])] + [("sum", o["cout"])] * len(TB_WIDTHS)
              if f32 else [("bf16",)] * (1 + len(TB_WIDTHS))) + [
        ("sum", o["m"], "cols")] * 2 + [("sum", o["m"], "rows")]
    for name, a, b, bnd in zip(names, got, want, bounds):
        err, share, ok = output_errors(torch, [a], [b], [bnd])
        print(f"bn0 Function{' at float32' if f32 else ''}, kernels vs "
              f"plain versions, r=64: {name} "
              f"max_abs_err {err:.4g} (at most {share:.3g} of a {bnd[0]} "
              f"limit: {ok})", flush=True)
        require(ok, f"the #7 autograd Function's {name} disagrees with the "
                f"plain versions'")


def mask_counter(kernel, f32=False):
    """Launch counters of one mask kernel of ``kernels/drop_ops.py``
    (``drop_mask`` or ``threefry_mask``; with ``f32`` its float32 form's,
    keyed ``name[f32]``): a recipe checks the kernel it runs, and the
    module counts both."""
    import types

    from cunet_tpu_torch.kernels import drop_ops

    name = kernel.__name__ + ("[f32]" if f32 else "")
    return types.SimpleNamespace(
        reset_launch_counts=drop_ops.reset_launch_counts,
        launch_counts=lambda: {name: kernel.f32_launches if f32
                               else kernel.launches})


def one_step(torch, label, step, counters):
    """One step of a recipe on the #7 path: finite loss, every kernel of
    ``counters`` (modules with launch counters) launched."""
    counts = {}
    for m in counters:
        m.reset_launch_counts()
    loss = float(step()["loss"])
    torch.cuda.synchronize()
    for m in counters:
        counts.update(m.launch_counts())
    print(f"{label}: one kernel-path step, loss {loss:.6g}; launches "
          f"{counts}", flush=True)
    require(np.isfinite(loss), f"{label}: non-finite loss {loss}")
    require(all(counts.values()), f"{label}: a kernel never launched")
    return counts


def paired_step_times(torch, steps, rounds=4):
    """Host ms of single synchronised calls of each of ``steps`` (label ->
    step), one warm-up each, then ``rounds`` rounds in ABBA order so that
    a drift of the host's speed falls on both alike: {label: [ms, ...]}."""
    for fn in steps.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in steps}
    for r in range(rounds):
        for k in (list(steps) if r % 2 == 0 else list(steps)[::-1]):
            t0 = time.perf_counter()
            steps[k]()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return times


def bn0_dropout(torch, cfg, params, state, x, t, dops,
                label="bn0 dropout training", where=None, name="drop_mask",
                **kw):
    """The kernel path of ``cfg`` (bn_tile=0, or ghost-BN tiles) at drop
    rate DROP_RATE: its dropout runs the mask kernel forward and backward,
    bit for bit the step with the plain mask swapped in (as ``name`` of
    ``where``, the module that calls it by name: ``dops`` at bn_tile=0,
    ``kernels/train_slot.py`` with ghost-BN tiles; cuDNN deterministic).
    ``name`` is ``drop_mask`` (seeds drawn here) or ``threefry_mask``
    (``drop_impl="masks"``, its key ``drop_key`` in ``kw``)."""
    from cunet_tpu_torch.ops.dropmask import draw_slot_seeds

    where = where or dops
    if not kw:
        kw = {"drop_seeds": draw_slot_seeds(torch.Generator().manual_seed(7),
                                            cfg.layer_num)}
    kernel = getattr(where, name)
    torch.backends.cudnn.deterministic = True
    try:
        lk, gk, _ = _grads(torch, cfg, params, state, x, t, **kw)
        setattr(where, name, dops.PLAIN[kernel])
        lp, gp, _ = _grads(torch, cfg, params, state, x, t, **kw)
    finally:
        setattr(where, name, kernel)
        torch.backends.cudnn.deterministic = False
    same = lk == lp and all(torch.equal(gk[k], gp[k]) for k in gk)
    print(f"{label}: mask kernel vs plain mask, loss and grads "
          f"bit-identical {same}", flush=True)
    require(same, f"{label}: the mask kernel changes the step")


def step_memory(torch, cfg, params, state, batch):
    """(loss, grads, peak device memory) of one train_step from a fresh
    train state."""
    from cunet_tpu_torch import TrainConfig
    from cunet_tpu_torch.train import create_train_state, train_step

    st = create_train_state(params, state,
                            TrainConfig(lr=2.5e-4, batch_size=TRAIN_BATCH))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, mets = train_step(st, batch, cfg=cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return float(mets["loss"]), {k: v.grad for k, v in st.params.items()}, \
        peak


def phase_bn0_training(torch, tbk, tops, bops, dops, gpu):
    """Phase 9 (b)-(f): CU-Net-8 @256 at bn_tile=0 on the #7 kernels."""
    from cunet_tpu_torch import QuantConfig, TrainConfig
    from cunet_tpu_torch.train import (
        create_train_state,
        quant_train_step,
        train_step,
    )

    check_tb_function(torch, tbk)
    cfg, params, state, batch = flagship_train(torch)
    cfg = dataclasses.replace(cfg, bn_tile=0)
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    x, t = batch["image"], batch["heatmap"]

    # (c) and (d) with cuDNN's deterministic algorithms: the 3x3 convs'
    # backward is cuDNN's on this path, and the checks are bit for bit
    torch.backends.cudnn.deterministic = True
    try:
        compare_steps(torch, "bn0 training", cfg, params, state, x, t)
        perms = [torch.randperm(x.shape[0], generator=torch.Generator()
                                .manual_seed(17 + i)).cuda()
                 for i in range(F32_STEP_PERMS)]
        wide_bn0_step_check(torch, tbk, cfg, x, t, perms, *WIDER_BN0)
        l0, g0, peak0 = step_memory(torch, cfg, params, state, batch)
        for remat in ("layer", "block"):
            lr, gr, peak = step_memory(torch, dataclasses.replace(
                cfg, remat=remat), params, state, batch)
            same = lr == l0 and all(torch.equal(gr[k], g0[k]) for k in g0)
            print(f"bn0 training: remat={remat!r} vs 'none' on the kernel "
                  f"path: loss and grads bit-identical {same}; peak memory "
                  f"of one step {peak / 2 ** 30:.2f} GiB ('none' "
                  f"{peak0 / 2 ** 30:.2f} GiB; {gpu})", flush=True)
            require(same, f"bn0 training: remat={remat!r} changes the step")
            del gr
        del g0
    finally:
        torch.backends.cudnn.deterministic = False
    lb, gb, peak = step_memory(torch, dataclasses.replace(
        plain_cfg, remat="bottleneck"), params, state, batch)
    print(f"bn0 training: plain path remat='bottleneck': loss {lb:.6g}, "
          f"peak memory of one step {peak / 2 ** 30:.2f} GiB ({gpu})",
          flush=True)
    require(np.isfinite(lb), "plain remat='bottleneck' step: non-finite")
    del gb

    # (e) the main path: three steps, then one each of dropout and W1/I8/G8
    tcfg = TrainConfig(lr=2.5e-4, batch_size=TRAIN_BATCH)
    st = create_train_state(params, state, tcfg)
    bops.reset_launch_counts()
    tops.reset_launch_counts()
    launches = main_path_steps(
        torch, "bn0 training", lambda: train_step(st, batch, cfg=cfg)[1],
        lambda: st.params, (tbk,))
    others = {k: v for k, v in {**bops.launch_counts(),
                                **tops.launch_counts()}.items()
              if v and k != "sum_rows"}
    require(not others, f"bn0 training launched slot kernels: {others}")
    st_d = create_train_state(params, state, tcfg)
    gen = torch.Generator().manual_seed(6)
    drop_cfg = dataclasses.replace(cfg, drop_rate=DROP_RATE)
    bn0_dropout(torch, drop_cfg, params, state, x, t, dops)
    one_step(torch, "bn0 dropout training",
             lambda: train_step(st_d, batch, cfg=drop_cfg, generator=gen)[1],
             (tbk, mask_counter(dops.drop_mask)))
    st_q = create_train_state(params, state, tcfg)
    quant = QuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True)
    one_step(torch, "bn0 quantized training",
             lambda: quant_train_step(st_q, batch, cfg=cfg, qcfg=quant)[1],
             (tbk,))
    del st_q

    # (f) step times and peak memory, kernel path then plain path
    kernel = dops.drop_mask

    def drop_step(mask_fn):
        def run():
            dops.drop_mask = mask_fn
            try:
                return train_step(st_d, batch, cfg=drop_cfg, generator=gen)
            finally:
                dops.drop_mask = kernel
        return run

    times = paired_step_times(torch, {
        "the mask kernel": drop_step(kernel),
        "the plain mask": drop_step(dops.PLAIN[kernel])})
    wins = sum(a < b for a, b in zip(*times.values()))
    parts = [f"with {k} median {np.median(v):.3f} ms ("
             + ", ".join(f"{ms:.1f}" for ms in v) + ")"
             for k, v in times.items()]
    print(f"bn0 dropout training, batch {TRAIN_BATCH}, steps in ABBA "
          f"order: {'; '.join(parts)}; the mask kernel faster in {wins} of "
          f"{len(times['the mask kernel'])} pairs ({gpu})", flush=True)
    del st_d
    st_p = create_train_state(params, state, tcfg)
    times = report_times(torch, "bn0 training",
                         lambda: train_step(st, batch, cfg=cfg),
                         lambda: train_step(st_p, batch, cfg=plain_cfg), gpu)
    return {f"train_bottleneck.{k}": v for k, v in launches.items()}, times



# ---------------------------------------------------------------------------
# phase 10: the per-slot eval (#4) and the per-bottleneck eval (#6)
# ---------------------------------------------------------------------------

FACE_CLASSES = 68     # the 300-W face model's landmarks


def table_dot_cases(torch, gen, n):
    """(row name, label, make_out, call, work, torch.mm of the product
    alone or None) of the feature-table product
    at the CU-Net-8 @256 shapes of batch ``n`` (c=128, g=32, Cb=128,
    r=64), each feature a tensor of its own (a FIFO entry a slice of a
    wider one): a down block's bottleneck with BN2's ``shift2`` epilogue,
    its adapter pair (dual), an up block's adapter, the intermedia adapter
    and the heads of 16 and 68 classes (a column prefix of the padded
    weight)."""
    dev = "cuda"
    c, g, cb, h0 = 128, 32, 128, 64
    m = n * h0 * h0

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(
            dev, torch.bfloat16)

    def vec(k):
        return torch.stack([torch.rand(k, generator=gen) + 0.5,
                            torch.randn(k, generator=gen) * 0.5]).to(dev)

    def empty(cols):
        return lambda: torch.empty(m, cols, device=dev, dtype=torch.bfloat16)

    def dot_work(ks, nout, outs=1, bias=False):
        k = sum(ks)
        return work(sum(sz(m, kk) for kk in ks)
                    + outs * (sz(k, nout) + sz(2, k, e=4) + sz(m, nout))
                    + (sz(nout, e=4) if bias else 0),
                    2 * outs * m * k * nout)

    def mm(feats, w):
        """torch.mm of the product alone, its operands made beforehand."""
        x = torch.cat(feats, 1)
        return lambda: torch.mm(x, w)

    wide = randn(m, c + g + g)
    y, fifo, out32 = randn(m, c), wide[:, c:c + g], randn(m, g)
    up, skip, inter_f = randn(m, c), randn(m, c), randn(m, c)
    cases = []
    v, w = vec(2 * c + g + g), randn(2 * c + g + g, c, scale=320 ** -0.5)
    cases.append(("table_dot", f"up adapter K=320->128 r=64 batch {n}",
                  empty(c), lambda f, o: f([up, skip, fifo, out32], v, w, o),
                  dot_work((c, c, g, g), c), mm([up, skip, fifo, out32], w)))
    vi, wi = vec(2 * c), randn(2 * c, c, scale=256 ** -0.5)
    cases.append(("table_dot", f"intermedia K=256->128 r=64 batch {n}",
                  empty(c), lambda f, o: f([y, inter_f], vi, wi, o),
                  dot_work((c, c), c), None))
    vh, wh = vec(c), randn(c, 72, scale=c ** -0.5)
    for cls in (16, FACE_CLASSES):
        cases.append(("table_dot", f"head K=128->{cls} r=64 batch {n}",
                      empty(cls), lambda f, o: f([y], vh, wh, o),
                      dot_work((c,), cls), None))
    vb, wb = vec(c + g), randn(c + g, cb, scale=160 ** -0.5)
    b2 = (torch.randn(cb, generator=gen) * 0.5).to(dev)
    cases.append(("table_dot[shift2]",
                  f"bottleneck K=160->128 +shift2 r=64 batch {n}", empty(cb),
                  lambda f, o: f([y, fifo], vb, wb, o, bias=b2),
                  dot_work((c, g), cb, bias=True), mm([y, fifo], wb)))
    va, wa = vec(c + g + g), randn(c + g + g, c, scale=192 ** -0.5)
    vs, ws = vec(c + g + g), randn(c + g + g, c, scale=192 ** -0.5)
    cases.append(("table_dot[dual]",
                  f"adapter pair K=192->2x128 r=64 batch {n}", empty(2 * c),
                  lambda f, o: f([y, fifo, out32], va, wa, o[:, :c],
                                 vec_s=vs, w_s=ws, out_s=o[:, c:]),
                  dot_work((c, g, g), c, outs=2),
                  mm([y, fifo, out32], torch.cat([wa, ws], 1))))
    return cases


def phase_eval_kernels(torch, eops):
    """Phase 10 (a): the feature-table product against its plain version
    (within the bf16 bound) at batch 8, the main-path headline, and 64."""
    gen = torch.Generator().manual_seed(10)
    results = {}
    for n in (BATCH, 64):
        for name, label, make_out, call, w, prod in table_dot_cases(
                torch, gen, n):
            check_case(torch, eops.PLAIN, results, "eval kernel",
                       eops.table_dot, label, make_out, call, ("bf16",), w,
                       None, name=name, product=prod)
    return results


def phase_slot_serving(torch, ops, eops, gpu, float_ms):
    """Phase 10 (b): CU-Net-8 @256 served with JAX's default flags
    (``use_pallas``, ``pallas_hourglass``): every slot on #4's kernels.
    The main path answers the three requests; it is held to the plain path
    and to the whole-model path (#1) on the same weights, then timed at
    batch 8 and 64 beside the whole-model path's times of this run."""
    from cunet_tpu_torch import ModelConfig
    from cunet_tpu_torch.models import init_cu_net
    from cunet_tpu_torch.models.cu_net import eval_path
    from cunet_tpu_torch.serving import Predictor

    cfg = ModelConfig(layer_num=8, order=1, class_num=16, loss_num=8,
                      compute_dtype="bfloat16", use_pallas=True)
    require(eval_path(cfg) == "hourglass", "default flags: not the slot path")
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0))
    pred = Predictor(cfg, params, state, device="cuda", batch_size=BATCH,
                     flip_test=True)
    rng = np.random.RandomState(0)
    requests = [rng.rand(k, 256, 256, 3).astype(np.float32)
                for k in (8, 5, 11)]

    ops.reset_launch_counts()
    eops.reset_launch_counts()
    answers = [(pred.heatmaps(imgs), pred.predict(imgs))
               for imgs in requests]
    torch.cuda.synchronize()
    launches = {**ops.launch_counts(), **eops.launch_counts(),
                **{k: v for k, v in eops.option_counts().items()
                   if k in ("table_dot[dual]", "table_dot[shift2]")}}
    forwards = 2 * 2 * sum(-(-imgs.shape[0] // BATCH) for imgs in requests)
    print(f"slot serving: launches on the main path {launches} in "
          f"{forwards} forwards", flush=True)
    for imgs, (hm, pts) in zip(requests, answers):
        k = imgs.shape[0]
        require(hm.shape == (k, 64, 64, 16), f"heatmaps shape {hm.shape}")
        require(pts.shape == (k, 16, 2), f"landmarks shape {pts.shape}")
        require(np.isfinite(hm).all() and np.isfinite(pts).all(),
                "non-finite output")
    require(launches.pop("affine_dot") == 0,
            "the slot path launched the whole-model path's affine_dot")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} never launched on the slot path")
    require(launches["table_dot"] == 159 * forwards,
            f"table_dot launches {launches['table_dot']}, expected 159 per "
            f"forward")

    want = Predictor(dataclasses.replace(cfg, use_pallas=False), params,
                     state, device="cuda", batch_size=BATCH,
                     flip_test=True).heatmaps(requests[0])
    got = answers[0][0]
    rel = _rel(got, want)
    whole = Predictor(dataclasses.replace(cfg, pallas_whole_model=True),
                      params, state, device="cuda", batch_size=BATCH,
                      flip_test=True).heatmaps(requests[0])
    same = np.array_equal(got, whole)
    print(f"slot serving: slot path vs plain path, request of 8: relative "
          f"L2 {rel:.4g} (bound {PATH_REL_L2}); vs the whole-model path: "
          f"bit-identical {same} (relative L2 {_rel(got, whole):.4g})",
          flush=True)
    require(np.isfinite(rel) and rel <= PATH_REL_L2,
            f"slot path disagrees with the plain path: {rel}")
    require(same, "the slot path differs from the whole-model path")

    times = {}
    for batch in (BATCH, 64):
        p = pred if batch == BATCH else Predictor(
            cfg, params, state, device="cuda", batch_size=batch)
        times[batch] = ms = time_forward(torch, p, batch)
        w = Predictor(dataclasses.replace(cfg, pallas_whole_model=True),
                      params, state, device="cuda", batch_size=batch)
        whole_ms = time_forward(torch, w, batch)
        print(f"slot serving: forward batch {batch}: {ms:.3f} ms, "
              f"{batch / ms * 1e3:.1f} img/s (slot path); whole-model path "
              f"{whole_ms:.3f} ms now, {float_ms[batch]:.3f} ms in phase 3 "
              f"({gpu})", flush=True)
    return {k: launches[k] for k in ("table_dot", "table_dot[dual]",
                                     "table_dot[shift2]")}, forwards, times


def phase_quant_layer_eval(torch, eops, qops, gpu):
    """Phase 10 (c): the int8 model (W1/I8/G8, ``int8_infer``,
    ``int8_impl="pallas"``) with ``use_pallas`` and the default flags runs
    layer by layer: its block 1x1 convs on #10, its down blocks' adapter
    pairs on the float dual kernel (JAX's quirk), its intermedia adapters
    on the single form; deterministic, finite. The binarized model at
    random init is chaotic (PERF.md), so no elementwise bound."""
    from cunet_tpu_torch import ModelConfig, QuantConfig
    from cunet_tpu_torch.models import apply_cu_net, init_cu_net
    from cunet_tpu_torch.train import quant_eval_params

    cfg = ModelConfig(layer_num=8, order=1, class_num=16, loss_num=8,
                      compute_dtype="bfloat16", use_pallas=True)
    quant = QuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True,
                        int8_infer=True, int8_impl="pallas")
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0))
    qp = quant_eval_params(params, quant)
    x = torch.rand(BATCH, 256, 256, 3, generator=torch.Generator()
                   .manual_seed(1)).to("cuda", torch.bfloat16)
    eops.reset_launch_counts()
    qops.reset_launch_counts()
    with torch.inference_mode():
        outs, _ = apply_cu_net(qp, state, x, cfg=cfg, quant=quant)
        again, _ = apply_cu_net(qp, state, x, cfg=cfg, quant=quant)
    torch.cuda.synchronize()
    counts = {**eops.launch_counts(), **eops.option_counts(),
              **qops.launch_counts()}
    nb, k = cfg.num_blocks, cfg.layer_num
    print(f"int8 eval with use_pallas (two forwards): launches {counts}",
          flush=True)
    require(counts["table_dot[dual]"] == 2 * nb * k,
            "the int8 model's down-block adapter pairs did not run the dual "
            "kernel")
    require(counts["table_dot"] == 2 * (nb * k + k - 1),
            f"table_dot launches {counts['table_dot']}")
    require(counts["int8_matmul_dequant"] == 2 * k * (3 * nb + 2),
            f"int8_matmul_dequant launches {counts['int8_matmul_dequant']}")
    require(all(o.shape == (BATCH, 64, 64, 16) and torch.isfinite(o).all()
                for o in outs), "int8 eval: bad output")
    require(all(torch.equal(a, b) for a, b in zip(outs, again)),
            "int8 eval with use_pallas is not deterministic")
    return counts["table_dot[dual]"] // 2


def phase_face_heads(torch, ops, eops, qops, tops, gpu):
    """Phase 10 (d): the 68-class head (the 300-W face model) on every
    kernel path with a head: the whole-model float and int8 paths, the
    per-slot path and the slot train step; and (e) the dtype guard: the
    quantized f32 model runs on the kernel paths, an f16 one raises."""
    from cunet_tpu_torch import ModelConfig, QuantConfig
    from cunet_tpu_torch.kernels import model_buf
    from cunet_tpu_torch.models import apply_cu_net, init_cu_net
    from cunet_tpu_torch.train import quant_eval_params

    cfg = ModelConfig(layer_num=8, order=1, class_num=FACE_CLASSES,
                      loss_num=8, compute_dtype="bfloat16", use_pallas=True)
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0))
    x = torch.rand(BATCH, 256, 256, 3, generator=torch.Generator()
                   .manual_seed(1)).to("cuda", torch.bfloat16)
    shape = (BATCH, 64, 64, FACE_CLASSES)
    with torch.inference_mode():
        plain, _ = apply_cu_net(params, state, x, cfg=dataclasses.replace(
            cfg, use_pallas=False))
        for label, c in (("per-slot", cfg), ("whole-model", dataclasses
                                              .replace(cfg,
                                                       pallas_whole_model=True))):
            outs, _ = apply_cu_net(params, state, x, cfg=c)
            rel = max(_rel(a.float().cpu().numpy(), b.float().cpu().numpy())
                      for a, b in zip(outs, plain))
            print(f"face heads: {label} path, {FACE_CLASSES} classes: "
                  f"shapes {tuple(outs[-1].shape)}, worst anchor relative "
                  f"L2 to the plain path {rel:.4g} (bound {PATH_REL_L2})",
                  flush=True)
            require(all(tuple(o.shape) == shape for o in outs) and np.isfinite(rel)
                    and rel <= PATH_REL_L2, f"face heads: {label} path off")
        quant = QuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True,
                            int8_infer=True, int8_impl="pallas")
        qp = quant_eval_params(params, quant)
        whole = dataclasses.replace(cfg, pallas_whole_model=True)
        q8, _ = apply_cu_net(qp, state, x, cfg=whole, quant=quant)
        saved = (model_buf.affine_dot_i8, model_buf.conv3x3_i8)
        model_buf.affine_dot_i8 = qops.PLAIN[qops.affine_dot_i8]
        model_buf.conv3x3_i8 = qops.PLAIN[qops.conv3x3_i8]
        try:
            q8p, _ = apply_cu_net(qp, state, x, cfg=whole, quant=quant)
        finally:
            model_buf.affine_dot_i8, model_buf.conv3x3_i8 = saved
    same = all(torch.equal(a, b) for a, b in zip(q8, q8p))
    print(f"face heads: int8 whole-model path, {FACE_CLASSES} classes: "
          f"shapes {tuple(q8[-1].shape)}, bit-identical to its plain "
          f"versions {same}", flush=True)
    require(same and all(tuple(o.shape) == shape for o in q8),
            "face heads: int8 whole-model path off")

    tcfg = dataclasses.replace(cfg, remat="none", bn_tile=BN_TILE,
                               bn_dtype="compute")
    rng = np.random.RandomState(0)
    xt = torch.from_numpy(rng.rand(TRAIN_BATCH, 256, 256, 3).astype(
        np.float32)).cuda()
    t = torch.from_numpy(gaussian_heatmaps(rng, TRAIN_BATCH, FACE_CLASSES,
                                           64)).cuda()
    ops.reset_launch_counts()
    tops.reset_launch_counts()
    lk, gk, _ = _grads(torch, tcfg, params, state, xt, t)
    heads_launched = tops.affine_dx.launches > 0 and ops.affine_dot.launches
    lp, gp, _ = _grads(torch, dataclasses.replace(tcfg, use_pallas=False),
                       params, state, xt, t)
    heads = [k for k in gk if k.startswith("heads.")]
    hrel = _rel_l2(torch, gk, gp, heads)
    lrel = abs(lk - lp) / abs(lp)
    print(f"face heads: slot-kernel train step, {FACE_CLASSES} classes, "
          f"batch {TRAIN_BATCH}: loss {lk:.6g} vs plain {lp:.6g} (rel "
          f"{lrel:.3g}, bound {LOSS_REL}), heads.* grads rel L2 {hrel:.4g} "
          f"(bound {HEADS_REL_L2})", flush=True)
    require(heads_launched and lrel <= LOSS_REL and hrel <= HEADS_REL_L2
            and gk["heads.7.conv"].shape == (1, 1, 128, FACE_CLASSES),
            "face heads: slot-kernel train step off the plain step")
    del gk, gp

    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    x2 = x[:2].float()
    w1i8g8 = QuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True)
    ran = []
    for label, c, args, kw in (
            ("W1/I8/G8 ghost-BN training (tile 2)",
             dataclasses.replace(f32, bn_tile=BN_TILE), (params,),
             dict(train=True, quant=w1i8g8)),
            ("quantized eval, per-slot flags", f32, (qp,),
             dict(quant=quant)),
            ("quantized eval, whole-model flags", whole, (qp,),
             dict(quant=quant))):
        c = dataclasses.replace(c, compute_dtype="float32")
        with torch.no_grad():
            outs, _ = apply_cu_net(*args, state, x2, cfg=c, **kw)
        require(all(o.dtype == torch.float32 and torch.isfinite(o).all()
                    and tuple(o.shape) == (2,) + shape[1:] for o in outs),
                f"f32 {label}: bad output")
        ran.append(label)
    try:
        apply_cu_net(params, state, x2, cfg=dataclasses.replace(
            cfg, compute_dtype="float16"))
    except NotImplementedError as e:
        require("float16" in str(e), f"f16 guard message: {e}")
    else:
        require(False, "a float16 model ran on a CUDA kernel path")
    print(f"f32 guard: on the card with use_pallas, float32 runs {ran} "
          f"(68-class heads, float32 outputs; phase 15 checks them); "
          f"float16 raises NotImplementedError", flush=True)


# ---------------------------------------------------------------------------
# phase 11: the per-block eval (#5) and the whole-model evals #3 and #2
# ---------------------------------------------------------------------------


def block_option_cases(torch, ops, eops, gen, n):
    """(row name, label, make_out, call, work, composition, product) of
    ``table_dot``'s three forms of #5 at the CU-Net-8 @256 shapes of batch
    ``n`` (c=128, g=32, Cb=128, r=64, order 1): an up block's adapter,
    K=320 -> 128, reading feature 0 at r=32 through the folded upsample;
    a down block's adapter pair, K=192 -> 2 x 128, storing the ahead
    output pooled (its rows first, then the skip's) and the bottleneck,
    K=160 -> 128, with BN2's full affine. ``composition(out)`` computes
    the same through the launches the form folds (``upsample2`` then
    ``table_dot``; ``table_dot`` then ``maxpool2``), or is None."""
    dev = "cuda"
    c, g, cb, r = 128, 32, 128, 64
    m = n * r * r
    hw = (r, r)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(
            dev, torch.bfloat16)

    def vec(k):
        return torch.stack([torch.rand(k, generator=gen) + 0.5,
                            torch.randn(k, generator=gen) * 0.5]).to(dev)

    def empty(rows, cols):
        return lambda: torch.empty(rows, cols, device=dev,
                                   dtype=torch.bfloat16)

    y, half, skip = randn(m, c), randn(m // 4, c), randn(m, c)
    fifo, out32 = randn(m, g), randn(m, g)
    cases = []

    k = 2 * c + 2 * g
    vu, wu = vec(k), randn(k, c, scale=k ** -0.5)
    ups = (True, False, False, False)

    def up_comp(o):
        full = torch.empty(m, c, device=dev, dtype=torch.bfloat16)
        ops.upsample2(half, n, r // 2, r // 2, full)
        eops.table_dot([full, skip, fifo, out32], vu, wu, o)

    cat_u = torch.cat([y, skip, fifo, out32], 1)
    cases.append(("table_dot[up]",
                  f"up adapter K=320->128 r=64, feature 0 from r=32, "
                  f"batch {n}", empty(m, c),
                  lambda f, o: f([half, skip, fifo, out32], vu, wu, o,
                                 up=ups, hw=hw),
                  work(sz(m // 4, c) + sz(m, c) + 2 * sz(m, g) + sz(k, c)
                       + sz(2, k, e=4) + sz(m, c), 2 * m * k * c), up_comp,
                  lambda: torch.mm(cat_u, wu)))

    k = c + 2 * g
    va, wa = vec(k), randn(k, c, scale=k ** -0.5)
    vs, ws = vec(k), randn(k, c, scale=k ** -0.5)
    cat_a, wa2 = torch.cat([y, fifo, out32], 1), torch.cat([wa, ws], 1)
    q = m // 4

    def pool_comp(o):
        unpooled = torch.empty(m, c, device=dev, dtype=torch.bfloat16)
        eops.table_dot([y, fifo, out32], va, wa, unpooled, vec_s=vs, w_s=ws,
                       out_s=o[q:])
        ops.maxpool2(unpooled, n, r, r, o[:q])

    cases.append(("table_dot[pool]",
                  f"adapter pair K=192->2x128 r=64, ahead pooled, batch {n}",
                  empty(q + m, c),
                  lambda f, o: f([y, fifo, out32], va, wa, o[:q], vec_s=vs,
                                 w_s=ws, out_s=o[q:], pool=True, hw=hw),
                  work(sz(m, k) + 2 * (sz(k, c) + sz(2, k, e=4))
                       + sz(q, c) + sz(m, c), 2 * 2 * m * k * c), pool_comp,
                  lambda: torch.mm(cat_a, wa2)))

    k = c + g
    vb, wb, v2 = vec(k), randn(k, cb, scale=k ** -0.5), vec(cb)
    cat_b = torch.cat([y, fifo], 1)
    cases.append(("table_dot[scale]",
                  f"bottleneck K=160->128 +BN2 affine r=64 batch {n}",
                  empty(m, cb),
                  lambda f, o: f([y, fifo], vb, wb, o, vec2=v2),
                  work(sz(m, k) + sz(k, cb) + sz(2, k, e=4) + sz(2, cb, e=4)
                       + sz(m, cb), 2 * m * k * cb), None,
                  lambda: torch.mm(cat_b, wb)))
    return cases


def phase_block_kernels(torch, ops, eops):
    """Phase 11 (a): table_dot's #5 forms against their plain versions
    (within the bf16 bound), ``[up]`` and ``[pool]`` also bit for bit
    their two-launch compositions, at batch 8 (the headline) and 64."""
    gen = torch.Generator().manual_seed(11)
    results = {}
    for n in (BATCH, 64):
        for name, label, make_out, call, w, comp, prod in \
                block_option_cases(torch, ops, eops, gen, n):
            k_out, _ = check_case(torch, eops.PLAIN, results, "block kernel",
                                  eops.table_dot, label, make_out, call,
                                  ("bf16",), w, None, name=name,
                                  product=prod)
            if comp is None:
                continue
            c_out = make_out()
            comp(c_out)
            torch.cuda.synchronize()
            same = torch.equal(k_out, c_out)
            comp_ms = cuda_time_ms(lambda: comp(c_out))
            print(f"block kernel {name} [{label}]: bit for bit its "
                  f"two-launch composition {same} ({comp_ms:.4f} ms)",
                  flush=True)
            require(same, f"{name} [{label}] differs from its two-launch "
                          f"composition")
    return results


def phase_block_functions(torch, ops, eops):
    """Phase 11 (b): ``fused_dense_block_infer`` for down block 0 (pooled,
    with its skip and the intermedia pre-stage), the neck and up block 0
    (upsampled, with the head) of a steady slot of CU-Net-8 @256 at batch
    8, on the operands ``block_slots`` marshals, against the same function
    on the kernels' plain versions, each output within the bf16 bound of
    its own magnitude; the down block is the row's headline."""
    from cunet_tpu_torch import ModelConfig
    from cunet_tpu_torch.kernels import fused_block
    from cunet_tpu_torch.models import init_cu_net
    from cunet_tpu_torch.models.cu_net import block_slots
    from cunet_tpu_torch.tools.eval_bounds import block_work

    cfg = ModelConfig(layer_num=8, order=1, class_num=16, loss_num=8,
                      compute_dtype="bfloat16", use_pallas=True,
                      pallas_hourglass=False)
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0))
    slot = block_slots(params, state, cfg)[1]
    blocks = slot["blocks"]
    gen = torch.Generator().manual_seed(12)
    n, c, g, nb = BATCH, 128, 32, cfg.num_blocks

    def feat(r, ch):
        return torch.randn(n, r, r, ch, generator=gen).to(
            "cuda", torch.bfloat16)

    def args(pos):
        ws = blocks[pos]
        skip = (ws["vec_s"], ws["w_s"]) if "w_s" in ws else ()
        return (ws["vec_b"], ws["w_b"], ws["vec2"], ws["w3"], ws["vec_a"],
                ws["w_a"]) + skip

    rn = 64 >> nb
    vec_p, w_p = slot["inter"]
    vec_h, w_h = slot["head"]
    pre = dict(pre_features=[feat(64, c), feat(64, c)], pre_vec=vec_p,
               pre_w=w_p)
    head = dict(head_vec=vec_h, head_w=w_h[:, :cfg.class_num])
    # (kind, label, features, operands, options, output names, work)
    cases = [("down", "down block 0 r=64, pooled, pre-stage",
              [feat(64, c), feat(64, g)], args(0),
              dict(pool_ahead=True, **pre),
              ("ahead", "skip", "layer_out", "pre_out"),
              block_work(cfg, n, pre=True)),
             ("neck", f"neck r={rn}", [feat(rn, c), feat(rn, g)], args(nb),
              {}, ("ahead", "layer_out"), block_work(cfg, n, "neck")),
             ("up", "up block 0 r=64, upsampled, head",
              [feat(32, c), feat(64, c), feat(64, g)], args(2 * nb),
              dict(upsample_first=True, **head),
              ("ahead", "layer_out", "head_out"),
              block_work(cfg, n, "up", head=True))]
    saved = (fused_block.table_dot, fused_block.conv3x3)
    plain = (eops.table_dot_plain, ops.conv3x3_plain)
    results = {}
    for kind, label, feats, a, kw, names, bw in cases:
        def run(f=feats, a=a, kw=kw):
            return fused_block.fused_dense_block_infer(f, *a, **kw)

        got = run()
        fused_block.table_dot, fused_block.conv3x3 = plain
        try:
            want = run()
            torch.cuda.synchronize()
            plain_ms = cuda_time_ms(run, iters=5)
        finally:
            fused_block.table_dot, fused_block.conv3x3 = saved
        require(len(got) == len(names) and len(want) == len(names),
                f"fused_dense_block_infer [{label}] returned {len(got)} "
                f"outputs, expected {names}")
        errs = {k: (o.float() - p.float()).abs().max().item()
                for k, o, p in zip(names, got, want)}
        lims = {k: limit(("bf16",), p.float().abs().max().item())
                for k, p in zip(names, want)}
        ms = cuda_time_ms(run)
        w = work(bw.nbytes, bw.ops)
        per = ", ".join(f"{k} {errs[k]:.4g} (bound {lims[k]:.4g})"
                        for k in names)
        print(f"block function fused_dense_block_infer [{label}, batch {n}]"
              f": max_abs_err {per}, bf16; {ms:.4f} ms vs plain "
              f"{plain_ms:.4f} ms, library None, bound {bound(w)[0]:.4f} ms "
              f"({bound(w)[1]})", flush=True)
        bad = [k for k in names
               if not (np.isfinite(errs[k]) and errs[k] <= lims[k])]
        require(not bad, f"fused_dense_block_infer [{label}] disagrees with "
                         f"its plain versions in {bad}: {errs} > {lims}")
        record(results, "fused_dense_block_infer", max(errs.values()), ms,
               plain_ms, f"{label}, batch {n}", w, None)
    return results


def phase_block_serving(torch, ops, eops, gpu):
    """Phase 11 (c): CU-Net-8 @256 with ``use_pallas,
    pallas_hourglass=False`` and ``use_scan`` (JAX's ``--use_pallas`` with
    the per-block kernels): slot 0 layer by layer (#6), slots 1-7 on #5.
    The main path answers the three requests; each steady slot is counted
    alone; held to the plain path at batch 8 and 64, then timed at both
    beside the per-slot and whole-model paths in this run."""
    from cunet_tpu_torch import ModelConfig
    from cunet_tpu_torch.kernels import fused_block
    from cunet_tpu_torch.models import apply_cu_net, cu_net, init_cu_net
    from cunet_tpu_torch.serving import Predictor

    cfg = ModelConfig(layer_num=8, order=1, class_num=16, loss_num=8,
                      compute_dtype="bfloat16", use_pallas=True,
                      pallas_hourglass=False)
    require(cu_net.eval_path(cfg) == "blocks",
            "pallas_hourglass=False under use_scan: not the block path")
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0))
    pred = Predictor(cfg, params, state, device="cuda", batch_size=BATCH,
                     flip_test=True)
    rng = np.random.RandomState(0)
    requests = [rng.rand(k, 256, 256, 3).astype(np.float32)
                for k in (8, 5, 11)]

    def counts():
        return {**ops.launch_counts(), **eops.launch_counts(),
                **eops.option_counts()}

    per_slot, blocks = [], []
    slot_eval, block_fn = cu_net._fused_slot_eval, \
        fused_block.fused_dense_block_infer

    def counted_slot(*a, **k):
        before = counts()
        out = slot_eval(*a, **k)
        after = counts()
        per_slot.append({key: after[key] - before[key] for key in after})
        return out

    def counted_block(*a, **k):
        blocks.append(1)
        return block_fn(*a, **k)

    ops.reset_launch_counts()
    eops.reset_launch_counts()
    cu_net._fused_slot_eval = counted_slot
    fused_block.fused_dense_block_infer = counted_block
    try:
        answers = [(pred.heatmaps(imgs), pred.predict(imgs))
                   for imgs in requests]
        torch.cuda.synchronize()
    finally:
        cu_net._fused_slot_eval = slot_eval
        fused_block.fused_dense_block_infer = block_fn
    launches = counts()
    launches["fused_dense_block_infer"] = len(blocks)
    forwards = 2 * 2 * sum(-(-imgs.shape[0] // BATCH) for imgs in requests)
    steady = cfg.layer_num - max(cfg.order, 1)
    print(f"block serving: launches on the main path {launches} in "
          f"{forwards} forwards; one steady slot: {per_slot[0]}", flush=True)
    for imgs, (hm, pts) in zip(requests, answers):
        k = imgs.shape[0]
        require(hm.shape == (k, 64, 64, 16), f"heatmaps shape {hm.shape}")
        require(pts.shape == (k, 16, 2), f"landmarks shape {pts.shape}")
        require(np.isfinite(hm).all() and np.isfinite(pts).all(),
                "non-finite output")
    nb, npos = cfg.num_blocks, 2 * cfg.num_blocks + 1
    want_slot = {"affine_dot": 0, "conv3x3": npos, "maxpool2": 0,
                 "upsample2": 0, "table_dot": 2 + 2 * npos,
                 "table_dot[dual]": nb, "table_dot[shift2]": 0,
                 "table_dot[scale]": npos, "table_dot[up]": 2 * nb,
                 "table_dot[pool]": nb}
    require(len(per_slot) == steady * forwards,
            f"{len(per_slot)} steady slots in {forwards} forwards")
    require(all(d == want_slot for d in per_slot),
            f"a steady slot's launches differ from {want_slot}")
    hand = sum(want_slot[k] for k in ("affine_dot", "conv3x3", "maxpool2",
                                      "upsample2", "table_dot"))
    require(hand == 29, f"{hand} hand-written launches per steady slot")
    require(len(blocks) == npos * steady * forwards,
            f"{len(blocks)} fused_dense_block_infer calls")
    for name in ("table_dot", "conv3x3", "table_dot[dual]",
                 "table_dot[scale]", "table_dot[up]", "table_dot[pool]"):
        require(launches[name] > 0,
                f"kernel {name} never launched on the block path")

    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    want = Predictor(plain_cfg, params, state, device="cuda",
                     batch_size=BATCH, flip_test=True).heatmaps(requests[0])
    rel8 = _rel(answers[0][0], want)
    x = torch.rand(64, 256, 256, 3, generator=torch.Generator()
                   .manual_seed(2)).to("cuda", torch.bfloat16)
    with torch.inference_mode():
        got64, _ = apply_cu_net(params, state, x, cfg=cfg)
        want64, _ = apply_cu_net(params, state, x, cfg=plain_cfg)
    rel64 = max(_rel(a.float().cpu().numpy(), b.float().cpu().numpy())
                for a, b in zip(got64, want64))
    del got64, want64, x
    print(f"block serving: block path vs plain path: request of 8 relative "
          f"L2 {rel8:.4g}, batch 64 worst anchor {rel64:.4g} (bound "
          f"{PATH_REL_L2})", flush=True)
    require(np.isfinite(rel8) and rel8 <= PATH_REL_L2
            and np.isfinite(rel64) and rel64 <= PATH_REL_L2,
            f"the block path disagrees with the plain path: {rel8}, {rel64}")

    times = {}
    others = {"per-slot": dataclasses.replace(cfg, pallas_hourglass=True),
              "whole-model": dataclasses.replace(cfg,
                                                 pallas_whole_model=True)}
    for batch in (BATCH, 64):
        p = Predictor(cfg, params, state, device="cuda", batch_size=batch)
        times[batch] = ms = time_forward(torch, p, batch)
        parts = []
        for label, c in others.items():
            o = Predictor(c, params, state, device="cuda", batch_size=batch)
            parts.append(f"{label} path {time_forward(torch, o, batch):.3f}"
                         f" ms")
        print(f"block serving: forward batch {batch}: {ms:.3f} ms, "
              f"{batch / ms * 1e3:.1f} img/s (block path); "
              f"{', '.join(parts)} ({gpu})", flush=True)
    return launches, forwards, times


def phase_fused_models(torch, ops, gpu):
    """Phase 11 (d): #3 (every slot's head) and #2 (the anchored heads) at
    CU-Net-8 @256 batch 8 on the whole-model kernels: their anchored heads
    bit for bit the whole-model path's on the same slots and stem output;
    every head of #3 against #3 on the kernels' plain versions (relative
    L2 within the path bound; the worst element against the bf16 bound);
    times of both and of their plain versions."""
    from cunet_tpu_torch import ModelConfig
    from cunet_tpu_torch.kernels import fused_model, model_buf
    from cunet_tpu_torch.models import apply_cu_net, init_cu_net
    from cunet_tpu_torch.models.cu_net import _apply_stem, eval_slots
    from cunet_tpu_torch.tools.eval_bounds import model_work

    cfg = ModelConfig(layer_num=8, order=1, class_num=16, loss_num=8,
                      compute_dtype="bfloat16", use_pallas=True,
                      pallas_whole_model=True)
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0))
    x = torch.rand(BATCH, 256, 256, 3, generator=torch.Generator()
                   .manual_seed(1)).to("cuda", torch.bfloat16)
    names = ("affine_dot", "conv3x3", "maxpool2", "upsample2")
    saved = {k: getattr(model_buf, k) for k in names}
    results = {}
    with torch.inference_mode():
        slots = eval_slots(params, state, cfg)
        whole, _ = apply_cu_net(params, state, x, cfg=cfg, slots=slots)
        y = _apply_stem(params, state, x, cfg=cfg)
        fns = {"fused_model_loop_infer": fused_model.fused_model_loop_infer,
               "fused_model_infer": fused_model.fused_model_infer}
        calls = dict.fromkeys(fns, 0)

        def drive(name):
            calls[name] += 1
            return fns[name](y, slots, cfg)

        launches, outs, plain_outs, times = {}, {}, {}, {}
        for name, fn in fns.items():
            # the drive of each function, counted; the timing and the plain
            # comparison below call it directly
            calls[name] = 0
            ops.reset_launch_counts()
            outs[name] = drive(name)
            torch.cuda.synchronize()
            launches[name] = dict(ops.launch_counts())
            times[name] = wall_ms(torch, lambda fn=fn: fn(y, slots, cfg),
                                  iters=5, warmup=1)
            for k in names:
                setattr(model_buf, k, ops.PLAIN[getattr(ops, k)])
            try:
                plain_outs[name] = fn(y, slots, cfg)
                plain_ms = wall_ms(torch, lambda fn=fn: fn(y, slots, cfg),
                                   iters=2, warmup=0)
            finally:
                for k, v in saved.items():
                    setattr(model_buf, k, v)
            times[name] = (times[name], plain_ms)
    every, unrolled = outs["fused_model_loop_infer"], outs["fused_model_infer"]
    require(tuple(every.shape) == (BATCH, 8, 64, 64, 16)
            and len(unrolled) == len(cfg.anchors), "fused model shapes")
    same = all(torch.equal(every[:, a - 1], w) and torch.equal(u, w)
               for a, w, u in zip(cfg.anchors, whole, unrolled))
    rels = [_rel(every[:, i].float().cpu().numpy(),
                 plain_outs["fused_model_loop_infer"][:, i].float().cpu()
                 .numpy()) for i in range(cfg.layer_num)]
    errs = {}
    for name in fns:
        k_o, p_o = outs[name], plain_outs[name]
        if isinstance(k_o, tuple):
            k_o, p_o = torch.stack(k_o, 1), torch.stack(p_o, 1)
        errs[name] = (k_o.float() - p_o.float()).abs().max().item()
        lim = limit(("bf16",), p_o.float().abs().max().item())
        w = model_work(cfg, BATCH, every_head=name == "fused_model_loop_infer")
        wk = work(w.nbytes, w.ops)
        ms, plain_ms = times[name]
        print(f"fused model {name} [CU-Net-8 @256 post-stem, batch {BATCH}]"
              f": {calls[name]} call(s) driven, kernel launches per call "
              f"{launches[name]}, max_abs_err {errs[name]:.4g} "
              f"against its plain versions (bf16 bound {lim:.4g}), "
              f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, library None, bound "
              f"{bound(wk)[0]:.4f} ms ({bound(wk)[1]}) ({gpu})", flush=True)
        require(np.isfinite(errs[name]) and errs[name] <= lim,
                f"{name}'s heads disagree with its plain versions: "
                f"{errs[name]} > {lim}")
        record(results, name, errs[name], ms, plain_ms,
               f"CU-Net-8 @256 post-stem, batch {BATCH}", wk, None)
        results[name].update(calls=calls[name], kernel_launches_per_call=sum(
            launches[name].values()))
    print(f"fused model: anchored heads of #3 and #2 bit for bit the "
          f"whole-model path's {same}; #3's heads against its plain "
          f"versions: relative L2 {max(rels):.4g} at worst (bound "
          f"{PATH_REL_L2})", flush=True)
    require(same, "#3 / #2 anchored heads differ from the whole-model path")
    require(all(np.isfinite(r) and r <= PATH_REL_L2 for r in rels),
            f"#3's heads disagree with its plain versions: {rels}")
    return results


# ---------------------------------------------------------------------------
# phase 12: float32 serving, on the float32 forms of the eval kernels
# ---------------------------------------------------------------------------

F32_SOURCE = "cunet_tpu_torch/csrc/f32_kernels.cu"
DW_F32_SOURCE = "cunet_tpu_torch/csrc/dw_f32_kernels.cu"
DX_F32_SOURCE = "cunet_tpu_torch/csrc/dx_f32_kernels.cu"
FWD_F32_SOURCE = "cunet_tpu_torch/csrc/fwd_f32_kernels.cu"
# #7's float32 input cotangents: a kernel of their own, on the g planes
# bwd_reduce's pre-pass writes
TB_DX_F32_SOURCE = "cunet_tpu_torch/csrc/tb_dx_f32_kernels.cu"
CONV_F32_SOURCE = "cunet_tpu_torch/csrc/conv_f32_kernels.cu"
TB_DX_F32_KERNEL = "tb_bwd_dx_f32_kernel"
# the rows that run the float32 forward 1x1 (fw3_kernel): the per-tile and
# QuanInput forms of affine_dot, #7's apply
FWD_F32_KERNEL = "fw3_kernel"
FWD_F32_ROWS = ("affine_dot[f32,tile]", "affine_dot[f32,bits_i]",
                "train_bottleneck.apply[f32]")


def f32_source(name):
    """The source of a float32 train form's kernel: the weight gradients',
    affine_dx's, the forward 1x1's and the two train convs' own files (the
    convs at r <= 16 on f32_kernels.cu's product kernel, whose plan splits
    K there), the rest f32_kernels.cu's product kernel."""
    base = name.split("[")[0]
    if name in ("conv3x3[f32,tile]", "conv3x3_dx[f32]", CONV_WG):
        return CONV_F32_SOURCE
    if base in ("affine_dw", "conv3x3_dw"):
        return DW_F32_SOURCE
    return {"affine_dx": DX_F32_SOURCE,
            "affine_dot": FWD_F32_SOURCE}.get(base, F32_SOURCE)


def fwd_note(row, ops):
    """`` on fw3_kernel`` for a row of the float32 forward 1x1 where the
    kernels' module ``ops`` (``buf_ops`` or ``train_bottleneck``) has it,
    else ''."""
    return f" on {FWD_F32_KERNEL}" if row in FWD_F32_ROWS and hasattr(
        ops, "launch_fwd_f32") else ""


def fwd_kernel(row):
    """The kernels line's ``kernel`` key of a row of the float32 forward
    1x1 (its source holds other kernels too), else none."""
    return {"kernel": FWD_F32_KERNEL} if row in FWD_F32_ROWS else {}


# the kernels line's ``kernel`` key of the float32 statistics and
# BN-jacobian rows: their kernels, whose sums end in float64
# (``f32_sums_f64_checks`` holds them to float64)
SUMS_KERNELS = {
    "bn_stats[f32]": "bn_stats_f32_kernel (one pass of shifted sums, "
                     "float64 partials, clusters of up to 16)",
    "bn_bwd[f32]": "bn_bwd_f32_kernel (r=64: persistent clusters of 16, a "
                   "block's rows in registers, sums traded by st.async, "
                   "d_x staged where added into); bn_bwd_kernel<float> "
                   "where a portable cluster keeps a tile's rows (r <= 32)",
    "train_bottleneck.stats[f32]": "tb_stats_f32_kernel + "
                                   "tb_stats_sum_kernel (float64 sums)",
}


def sums_kernel(row):
    """The kernels line's ``kernel`` key of a row of ``SUMS_KERNELS``, else
    none."""
    return {"kernel": SUMS_KERNELS[row]} if row in SUMS_KERNELS else {}


def conv_kernel(row):
    """The kernels line's ``kernel`` key of the two train convs' rows: the
    wgmma kernel where its plan takes the shape (r >= 32), dot3_kernel
    below."""
    if row not in ("conv3x3[f32,tile]", "conv3x3_dx[f32]"):
        return {}
    return {"kernel": "conv_f32_kernel (r >= 32; dot3_kernel of "
                      f"{F32_SOURCE} at r <= 16)"}
F32_PATH_REL_L2 = 1e-4   # a float32 kernel path vs the plain path
# the f32 rows of the kernels line: the bf16 row whose TPU kernel each
# replaces at float32
F32_OF = {"affine_dot[f32]": "affine_dot", "conv3x3[f32]": "conv3x3",
          "maxpool2[f32]": "maxpool2", "upsample2[f32]": "upsample2",
          "table_dot[f32]": "table_dot",
          "table_dot[f32,shift2]": "table_dot[shift2]",
          "table_dot[f32,dual]": "table_dot[dual]",
          "table_dot[f32,up]": "table_dot[up]",
          "table_dot[f32,scale]": "table_dot[scale]",
          "table_dot[f32,pool]": "table_dot[pool]"}
REPLACES.update({k: REPLACES[v] for k, v in F32_OF.items()})


def f32_work(m, ks, nout, outs=1, rows_out=None, extra=0):
    """Bytes and operations of a float32 product: x read once (``ks`` the
    features' (rows, width)), per output its weight, BN vectors and rows
    written, at 4 bytes an element; six bf16 passes of 2 m K N on the
    tensor cores. Also the float32 FMA time of the product alone."""
    k = sum(w for _, w in ks)
    nbytes = (sum(sz(r, w, e=4) for r, w in ks) + extra
              + outs * (sz(k, nout, e=4) + sz(2, k, e=4)
                        + sz(rows_out or m, nout, e=4)))
    flops = 2 * outs * m * k * nout
    return work(nbytes, 6 * flops, "bf16"), flops / PEAK_OPS["f32"] * 1e3


def f32_kernel_cases(torch, ops, eops, gen, n, rs):
    """(row, label, kernel, plain table, make_out, call, limit, work, fma
    ms, library, product) of the float32 forms at the CU-Net-8 @256 shapes
    of batch ``n`` (c=128, g=32, Cb=128): ``affine_dot`` (the adapter
    K=192->128 into a strided buffer slot and the bottleneck with BN2's
    shift), ``conv3x3`` and ``table_dot`` in each form at each resolution
    of ``rs``, the pool and the upsample at the first. Limits: the float32
    n-term sum, exact for the pool and the upsample. Product alone: the
    float32 ``torch.mm`` of the 1x1 forms' concat (both outputs of a pair
    as one, N = 256; ``[up]``'s at full resolution), none for
    ``[scale]``, whose product is ``[shift2]``'s."""
    import torch.nn.functional as F

    dev = "cuda"
    c, g, cb = 128, 32, 128

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    def vec(k):
        return torch.stack([torch.rand(k, generator=gen) + 0.5,
                            torch.randn(k, generator=gen) * 0.5]).to(dev)

    def empty(rows, cols):
        """Fresh zeroed outputs: a case writes a view of them, and the
        rest must compare equal."""
        return lambda: torch.zeros(rows, cols, device=dev)

    def mm(x, w):
        return lambda: torch.mm(x, w)

    def table_forms(r):
        """table_dot's forms at resolution r, each feature a tensor of its
        own."""
        m = n * r * r
        y, half, up, skip = randn(m, c), randn(m // 4, c), randn(m, c), \
            randn(m, c)
        fifo, out32 = randn(m, g), randn(m, g)
        cat4 = torch.cat([up, skip, fifo, out32], 1)
        k = 2 * c + 2 * g
        vu, wu = vec(k), randn(k, c, scale=k ** -0.5)
        wk, fma = f32_work(m, [(m, c), (m, c), (m, g), (m, g)], c)
        cases.append(("table_dot[f32]",
                      f"up adapter K=320->128 r={r} batch {n}",
                      eops.table_dot, eops.PLAIN, empty(m, c),
                      lambda f, o: f([up, skip, fifo, out32], vu, wu, o),
                      ("sum", k), wk, fma, None, mm(cat4, wu)))
        wk, fma = f32_work(m, [(m // 4, c), (m, c), (m, g), (m, g)], c)
        cases.append(("table_dot[f32,up]",
                      f"up adapter K=320->128 r={r}, feature 0 from "
                      f"r={r // 2}, batch {n}", eops.table_dot, eops.PLAIN,
                      empty(m, c),
                      lambda f, o: f([half, skip, fifo, out32], vu, wu, o,
                                     up=(True, False, False, False),
                                     hw=(r, r)),
                      ("sum", k), wk, fma, None, mm(cat4, wu)))
        kb = c + g
        vb, wb = vec(kb), randn(kb, cb, scale=kb ** -0.5)
        b2, v2 = (torch.randn(cb, generator=gen) * 0.5).to(dev), vec(cb)
        cat2 = torch.cat([y, fifo], 1)
        wk, fma = f32_work(m, [(m, c), (m, g)], cb, extra=sz(cb, e=4))
        cases.append(("table_dot[f32,shift2]",
                      f"bottleneck K=160->128 +shift2 r={r} batch {n}",
                      eops.table_dot, eops.PLAIN, empty(m, cb),
                      lambda f, o: f([y, fifo], vb, wb, o, bias=b2),
                      ("sum", kb), wk, fma, None, mm(cat2, wb)))
        wk, fma = f32_work(m, [(m, c), (m, g)], cb, extra=sz(2, cb, e=4))
        cases.append(("table_dot[f32,scale]",
                      f"bottleneck K=160->128 +BN2 affine r={r} batch {n}",
                      eops.table_dot, eops.PLAIN, empty(m, cb),
                      lambda f, o: f([y, fifo], vb, wb, o, vec2=v2),
                      ("sum", kb), wk, fma, None, None))
        ka = c + 2 * g
        va, wa = vec(ka), randn(ka, c, scale=ka ** -0.5)
        vs, ws = vec(ka), randn(ka, c, scale=ka ** -0.5)
        cat3, w2 = torch.cat([y, fifo, out32], 1), torch.cat([wa, ws], 1)
        wk, fma = f32_work(m, [(m, c), (m, g), (m, g)], c, outs=2)
        cases.append(("table_dot[f32,dual]",
                      f"adapter pair K=192->2x128 r={r} batch {n}",
                      eops.table_dot, eops.PLAIN, empty(m, 2 * c),
                      lambda f, o: f([y, fifo, out32], va, wa, o[:, :c],
                                     vec_s=vs, w_s=ws, out_s=o[:, c:]),
                      ("sum", ka), wk, fma, None, mm(cat3, w2)))
        q = m // 4
        wk, fma = f32_work(m, [(m, c), (m, g), (m, g)], c, outs=2,
                           extra=sz(q, c, e=4) - sz(m, c, e=4))
        cases.append(("table_dot[f32,pool]",
                      f"adapter pair K=192->2x128 r={r}, ahead pooled, "
                      f"batch {n}", eops.table_dot, eops.PLAIN,
                      empty(q + m, c),
                      lambda f, o: f([y, fifo, out32], va, wa, o[:q],
                                     vec_s=vs, w_s=ws, out_s=o[q:],
                                     pool=True, hw=(r, r)),
                      ("sum", ka), wk, fma, None, mm(cat3, w2)))

    cases = []
    for r in rs:
        m = n * r * r
        buf = randn(m, c + g + g)                  # [y | fifo | out32]
        v, w = vec(c + 2 * g), randn(c + 2 * g, c, scale=192 ** -0.5)
        wk, fma = f32_work(m, [(m, c + 2 * g)], c)
        cases.append(("affine_dot[f32]", f"K=192->128 r={r} batch {n}",
                      ops.affine_dot, ops.PLAIN, empty(m, 2 * c),
                      lambda f, o, buf=buf, v=v, w=w: f(buf, v, w,
                                                        o[:, c:]),
                      ("sum", c + 2 * g), wk, fma, None, mm(buf, w)))
        vb, wb = vec(c + g), randn(c + g, cb, scale=160 ** -0.5)
        bias = (torch.randn(cb, generator=gen) * 0.5).to(dev)
        wk, fma = f32_work(m, [(m, c + g)], cb, extra=sz(cb, e=4))
        cases.append(("affine_dot[f32]",
                      f"K=160->128 +shift,relu r={r} batch {n}",
                      ops.affine_dot, ops.PLAIN, empty(m, cb),
                      lambda f, o, buf=buf, vb=vb, wb=wb, bias=bias:
                      f(buf[:, :c + g], vb, wb, o, bias=bias),
                      ("sum", c + g), wk, fma, None, None))
        y2 = torch.relu(randn(m, cb))
        w3 = randn(9 * cb, g, scale=(9 * cb) ** -0.5)
        w_oihw = w3.view(3, 3, cb, g).permute(3, 2, 0, 1).contiguous()
        flops = 2 * m * 9 * cb * g
        cases.append(("conv3x3[f32]", f"Cb=128->32 r={r} batch {n}",
                      ops.conv3x3, ops.PLAIN, empty(m, c + 2 * g),
                      lambda f, o, y2=y2, w3=w3, r=r:
                      f(y2, w3, n, r, r, o[:, c + g:]),
                      ("sum", 9 * cb),
                      work(sz(m, cb, e=4) + sz(9 * cb, g, e=4)
                           + sz(m, g, e=4), 6 * flops),
                      flops / PEAK_OPS["f32"] * 1e3,
                      lambda y2=y2, w_oihw=w_oihw, r=r:
                      F.conv2d(nchw(y2, r), w_oihw, padding=1), None))
        table_forms(r)
    r = rs[0]
    m = n * r * r
    ahead = randn(m, c)
    cases.append(("maxpool2[f32]", f"{r}->{r // 2} batch {n}", ops.maxpool2,
                  ops.PLAIN, empty(m // 4, c + 2 * g),
                  lambda f, o: f(ahead, n, r, r, o[:, :c]), ("exact",),
                  work(sz(m, c, e=4) + sz(m // 4, c, e=4), 3 * m // 4 * c,
                       "f32"), None,
                  lambda: F.max_pool2d(nchw(ahead, r), 2), None))
    small = randn(m // 4, c)
    cases.append(("upsample2[f32]", f"{r // 2}->{r} batch {n}",
                  ops.upsample2, ops.PLAIN, empty(m, 2 * c + 2 * g),
                  lambda f, o: f(small, n, r // 2, r // 2, o[:, :c]),
                  ("exact",), work(sz(m // 4, c, e=4) + sz(m, c, e=4)), None,
                  lambda: F.interpolate(nchw(small, r // 2), scale_factor=2,
                                        mode="nearest"), None))
    return cases


def f32_one_hot_checks(torch, ops, eops, gen):
    """Under one-hot weights (one 1 a column) every float32 form gives its
    plain version's bits at r=64, batch 8: the six plane products sum to
    the prologue value exactly (a single bf16 pass would round it); the
    conv gives each output column one shifted input channel."""
    dev, n, r, c, g = "cuda", BATCH, 64, 128, 32
    m = n * r * r

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def vec(k):
        return torch.stack([torch.rand(k, generator=gen) + 0.5,
                            torch.randn(k, generator=gen) * 0.5]).to(dev)

    def hot(k, cols, rows=None):
        rows = torch.randint(0, k, (cols,), generator=gen) \
            if rows is None else rows
        w = torch.zeros(k, cols)
        w[rows, torch.arange(cols)] = 1.0
        return w.to(dev), rows

    y, fifo, out32, half = randn(m, c), randn(m, g), randn(m, g), \
        randn(m // 4, c)
    feats = [y, fifo, out32]
    k, ku = c + 2 * g, 2 * c + 2 * g
    v, vs, vu, v2 = vec(k), vec(k), vec(ku), vec(c)
    bias = torch.randn(c, generator=gen).to(dev)
    w, _ = hot(k, c)
    ws, _ = hot(k, c)
    wu, _ = hot(ku, c)
    cat = torch.cat(feats, 1)
    checks = {
        "affine_dot[f32]": (ops.affine_dot, ops.PLAIN, lambda f, o: f(
            cat, v, w, o, bias=bias), (m, c)),
        "table_dot[f32]": (eops.table_dot, eops.PLAIN, lambda f, o: f(
            feats, v, w, o), (m, c)),
        "table_dot[f32,shift2]": (eops.table_dot, eops.PLAIN, lambda f, o: f(
            feats, v, w, o, bias=bias), (m, c)),
        "table_dot[f32,scale]": (eops.table_dot, eops.PLAIN, lambda f, o: f(
            feats, v, w, o, vec2=v2), (m, c)),
        "table_dot[f32,dual]": (eops.table_dot, eops.PLAIN, lambda f, o: f(
            feats, v, w, o[:, :c], vec_s=vs, w_s=ws, out_s=o[:, c:]),
            (m, 2 * c)),
        "table_dot[f32,pool]": (eops.table_dot, eops.PLAIN, lambda f, o: f(
            feats, v, w, o[:m // 4], vec_s=vs, w_s=ws, out_s=o[m // 4:],
            pool=True, hw=(r, r)), (m // 4 + m, c)),
        "table_dot[f32,up]": (eops.table_dot, eops.PLAIN, lambda f, o: f(
            [half, y, fifo, out32], vu, wu, o,
            up=(True, False, False, False), hw=(r, r)), (m, c)),
    }
    same = {}
    for name, (kern, plain, call, shape) in checks.items():
        got = torch.empty(*shape, device=dev)
        want = torch.empty(*shape, device=dev)
        call(kern, got)
        call(plain[kern], want)
        torch.cuda.synchronize()
        same[name] = torch.equal(got, want)
    rows = torch.randint(0, 9 * c, (g,), generator=gen)
    w3, _ = hot(9 * c, g, rows)
    got = torch.empty(m, g, device=dev)
    ops.conv3x3(y, w3, n, r, r, got)
    img = torch.nn.functional.pad(y.view(n, r, r, c), (0, 0, 1, 1, 1, 1))
    want = torch.empty(n, r, r, g, device=dev)
    for j, row in enumerate(rows.tolist()):
        tap, ch = divmod(row, c)
        want[..., j] = img[:, tap // 3:tap // 3 + r, tap % 3:tap % 3 + r, ch]
    torch.cuda.synchronize()
    same["conv3x3[f32]"] = torch.equal(got, want.view(m, g))
    print(f"f32 kernels under one-hot weights, bit for bit their plain "
          f"versions (the conv: the shifted inputs): {same}", flush=True)
    require(all(same.values()), f"an f32 form is not exact under one-hot "
                                f"weights: {same}")
    return same


def phase_f32_kernels(torch, ops, eops):
    """Phase 12 (a): each float32 form against its plain version at
    float32 (TF32 off) within the float32 n-term limit (the pool and the
    upsample exact) at batch 8, r = 64 ... 4, and at r=64, batch 64; timed
    by CUDA-graph replay beside its bound (six bf16 passes or its bytes;
    the float32 FMA time beside it) and ``torch.mm`` of its float32
    product alone or the library call; then the one-hot checks."""
    gen = torch.Generator().manual_seed(12)
    results = {}
    for n, rs in ((BATCH, CONV_RES), (64, CONV_RES[:1])):
        for (name, label, kern, plain, make_out, call, bnd, w, fma, lib,
             prod) in f32_kernel_cases(torch, ops, eops, gen, n, rs):
            check_case(torch, plain, results, "f32 kernel", kern, label,
                       make_out, call, bnd, w, lib, name=name, product=prod,
                       note="" if fma is None else
                       f", float32-FMA bound {fma:.4f} ms")
    hot = f32_one_hot_checks(torch, ops, eops, gen)
    for name, same in hot.items():
        results[name]["one_hot_exact"] = same
    return results


def phase_f32_serving(torch, ops, eops, gpu):
    """Phase 12 (b): CU-Net-8 @256 at ``compute_dtype="float32"`` (JAX's
    default, the converted reference weights' dtype) served through
    ``Predictor(cfg, device="cuda")`` with ``use_pallas`` on the
    whole-model, per-slot and per-block paths: each answers the requests
    of 8 and 5 images with its float32 kernels counted (the main path's
    launches), its answers within relative L2 1e-4 of a plain-path
    ``Predictor``'s on the same requests; each anchor's heatmaps within
    relative L2 1e-4 of the plain path at float32 at batch 8 and 64; the
    per-slot path bit for bit the whole-model path, its answers too;
    forward ms and img/s at batch 8 and 64."""
    from cunet_tpu_torch import ModelConfig
    from cunet_tpu_torch.models import apply_cu_net, init_cu_net
    from cunet_tpu_torch.models.cu_net import eval_path
    from cunet_tpu_torch.serving import Predictor

    base = ModelConfig(layer_num=8, order=1, class_num=16, loss_num=8,
                       compute_dtype="float32", use_pallas=True)
    paths = {"whole-model": dataclasses.replace(base,
                                                pallas_whole_model=True),
             "per-slot": base,
             "per-block": dataclasses.replace(base, pallas_hourglass=False)}
    require([eval_path(c) for c in paths.values()]
            == ["whole_model", "hourglass", "blocks"], "f32 path flags")
    params, state = init_cu_net(base, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    requests = [rng.rand(k, 256, 256, 3).astype(np.float32) for k in (8, 5)]

    def counts():
        return {**ops.f32_counts(), **eops.f32_counts(),
                **{f"table_dot[f32,{k[10:-1]}]": v
                   for k, v in eops.option_counts().items()}}

    launches, per_path, preds, served = {}, {}, {}, {}
    for label, cfg in paths.items():
        pred = Predictor(cfg, params, state, device="cuda",
                         batch_size=BATCH)
        preds[label] = pred
        ops.reset_launch_counts()
        eops.reset_launch_counts()
        answers = [(pred.heatmaps(imgs), pred.predict(imgs))
                   for imgs in requests]
        torch.cuda.synchronize()
        per_path[label] = c = {k: v for k, v in counts().items() if v}
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
        served[label] = answers
        for imgs, (hm, pts) in zip(requests, answers):
            k = imgs.shape[0]
            require(hm.shape == (k, 64, 64, 16) and hm.dtype == np.float32,
                    f"f32 {label}: heatmaps {hm.shape} {hm.dtype}")
            require(pts.shape == (k, 16, 2), f"landmarks shape {pts.shape}")
            require(np.isfinite(hm).all() and np.isfinite(pts).all(),
                    f"f32 {label}: non-finite output")
    print(f"f32 serving: float32 kernel launches on the main paths "
          f"(requests of 8 and 5): {per_path}", flush=True)
    for name in F32_OF:
        require(launches.get(name, 0) > 0,
                f"f32 form {name} never launched on the f32 serving paths")
    require(per_path["per-slot"].get("affine_dot[f32]", 0) == 0,
            "the f32 per-slot path launched the whole-model affine_dot")

    plain_cfg = dataclasses.replace(base, use_pallas=False)
    plain_pred = Predictor(plain_cfg, params, state, device="cuda",
                           batch_size=BATCH)
    plain_answers = [plain_pred.heatmaps(imgs) for imgs in requests]
    preds["plain"] = plain_pred
    served_rel = {label: max(_rel(hm, want) for (hm, _), want
                             in zip(answers, plain_answers))
                  for label, answers in served.items()}
    served_same = all(
        np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        for a, b in zip(served["per-slot"], served["whole-model"]))
    print(f"f32 serving: Predictor heatmaps (requests of 8 and 5), worst "
          f"relative L2 to a plain-path Predictor's {served_rel} (bound "
          f"{F32_PATH_REL_L2}); per-slot answers bit for bit the "
          f"whole-model path's {served_same}", flush=True)
    require(all(np.isfinite(v) and v <= F32_PATH_REL_L2
                for v in served_rel.values()),
            f"f32 Predictor answers off the plain path's: {served_rel}")
    require(served_same, "f32 per-slot Predictor answers differ from the "
                         "whole-model path's")
    rels = {}
    for batch in (BATCH, 64):
        x = torch.rand(batch, 256, 256, 3, generator=torch.Generator()
                       .manual_seed(batch)).to("cuda")
        with torch.inference_mode():
            want, _ = apply_cu_net(params, state, x, cfg=plain_cfg)
            outs = {label: apply_cu_net(params, state, x, cfg=cfg,
                                        slots=preds[label]._slots)[0]
                    for label, cfg in paths.items()}
        same = all(torch.equal(a, b) for a, b in
                   zip(outs["per-slot"], outs["whole-model"]))
        worst = {}
        for label, got in outs.items():
            rels[(label, batch)] = worst[label] = max(
                _rel(a.cpu().numpy(), b.cpu().numpy())
                for a, b in zip(got, want))
        print(f"f32 serving, batch {batch}: worst anchor relative L2 to "
              f"the plain path at float32 {worst} (bound "
              f"{F32_PATH_REL_L2}); per-slot bit for bit the whole-model "
              f"path {same}", flush=True)
        require(same, f"f32 per-slot path differs from the whole-model path "
                      f"at batch {batch}")
        del want, outs, x
    bad = {k: v for k, v in rels.items()
           if not (np.isfinite(v) and v <= F32_PATH_REL_L2)}
    require(not bad, f"f32 kernel paths off the plain path: {bad}")

    times = {}
    for batch in (BATCH, 64):
        parts = []
        for label, cfg in list(paths.items()) + [("plain", plain_cfg)]:
            if label == "plain" and batch != BATCH:
                continue
            p = preds[label] if batch == BATCH and label in preds else \
                Predictor(cfg, params, state, device="cuda", batch_size=batch)
            ms = time_forward(torch, p, batch)
            times[(label, batch)] = ms
            parts.append(f"{label} {ms:.3f} ms, {batch / ms * 1e3:.1f} img/s")
        print(f"f32 serving: forward batch {batch}: {'; '.join(parts)} "
              f"({gpu})", flush=True)
    return launches, per_path, times


# ---------------------------------------------------------------------------
# phase 13: float32 whole-batch BN training, on #7's float32 forms
# ---------------------------------------------------------------------------

# kernel step vs the swap step at float32: the same path with #7's four
# plain versions swapped in, the same arithmetic (JAX's: single-pass
# variance, the recompute backward), so only the kernels differ. c is the
# plain control: the swap step against itself on the batch permuted (only
# the order of every whole-batch sum changes), the largest of
# F32_STEP_PERMS permutations (at depth one permutation's deviation at a
# leaf scatters 2x and more: PERF.md section 6). Limits, each of the form
# max(2 x the control, 1e-5): the loss rel,
# each grad leaf's rel L2, each BN running stat's rel L2 (a flat 1e-5
# fails on the control itself at depth: loss 1.9e-5, stats 1.4e-3).
F32_STEP_CONTROL = 2.0
F32_STEP_FLOOR = 1e-5
F32_STEP_PERMS = 3
TB_F32 = tuple(f"train_bottleneck.{k}[f32]"
               for k in ("stats", "apply", "bwd_reduce", "bwd_dx"))
REPLACES.update({k: REPLACES[k[:-5]] for k in TB_F32})
REPLACES["drop_mask[f32]"] = REPLACES["drop_mask"]


def tile_perm(torch, n, bt, gen):
    """A permutation of a batch of ``n`` images that keeps ghost-BN tiles
    of ``bt`` images whole (``tools/f32_step_gap.py::tile_perm``): every
    tile holds the same images, its statistics the same sums in another
    order, so the step computes the same function; a permutation of the
    whole batch would regroup the tiles and compute another one."""
    from cunet_tpu_torch.tools.f32_step_gap import tile_perm as perm

    return perm(n, bt, gen)


def tile_perms(torch, n, bt, count):
    """``count`` distinct tile-preserving permutations of ``n`` images,
    none the identity (``tile_perm`` over the seeds 0, 1, ...)."""
    out, seed = [], 0
    while len(out) < count:
        q = tile_perm(torch, n, bt, torch.Generator().manual_seed(seed))
        seed += 1
        if not torch.equal(q, torch.arange(n)) and \
                not any(torch.equal(q, p) for p in out):
            out.append(q)
    return out


def tb_f32_exact_checks(torch, tbk, gen):
    """At r=64, float32, under a one-hot W (distinct rows): ``apply`` bit
    for bit its plain version (the prologue value), ``bwd_dx`` with red =
    0 (g_y one term of g), and under a cotangent with one 1 a column
    ``bwd_reduce`` (each dW entry and BN sum one exact term); ``bwd_dx`` on
    the g planes ``bwd_reduce`` handed over bit for bit a call that splits
    g itself; then one bf16 pass of g (the plain versions on g rounded to
    bf16) against the float32 g, which must break the dx limit. Returns
    {name: exact}."""
    o = tb_operands(torch, gen, 64, dtype=torch.float32)
    f, m, k, cout = o["feats"], o["m"], o["k"], o["cout"]
    rows = torch.randperm(k, generator=gen)[:cout]
    w = torch.zeros(k, cout)
    w[rows, torch.arange(cout)] = 1.0
    w = w.cuda()
    same = {}
    outs = [fn(f, o["vec"], w, torch.empty(m, cout, device="cuda"))
            for fn in (tbk.apply, tbk.apply_plain)]
    red = torch.zeros(2, k, device="cuda")

    def dx(fn, g):
        d = [torch.empty(m, c, device="cuda") for c in TB_WIDTHS]
        fn(f, g, o["stat"], o["bias"], red, w, d)
        return d

    dxs = [dx(tbk.bwd_dx, o["g"]), dx(tbk.bwd_dx_plain, o["g"])]
    # dx from the planes bwd_reduce hands over (the backward's path)
    # against a call that splits g itself, on the random W
    planes = torch.empty(tbk.split_planes_shape(m, cout), device="cuda",
                         dtype=torch.bfloat16)
    tbk.bwd_reduce(f, o["g"], o["stat"], o["bias"], o["w"],
                   torch.empty(k, cout, device="cuda"),
                   torch.empty(2, k, device="cuda"), planes=planes)
    handed = [[torch.empty(m, c, device="cuda") for c in TB_WIDTHS]
              for _ in range(2)]
    tbk.bwd_dx(f, o["g"], o["stat"], o["bias"], o["red"], o["w"], handed[0],
               planes=planes)
    tbk.bwd_dx(f, o["g"], o["stat"], o["bias"], o["red"], o["w"], handed[1])
    hot = torch.zeros(m, cout, device="cuda")
    hot[torch.randint(0, m, (cout,), generator=gen), torch.arange(cout)] = 1
    reds = [fn(f, hot, o["stat"], o["bias"], w,
               torch.empty(k, cout, device="cuda"),
               torch.empty(2, k, device="cuda"))
            for fn in (tbk.bwd_reduce, tbk.bwd_reduce_plain)]
    # apply on the random W bit for bit affine_dot's eval-pair form
    # (dot3_kernel) over the concat: the same sums in the same order
    from cunet_tpu_torch.kernels import buf_ops

    concat = (tbk.apply(f, o["vec"], o["wa"],
                        torch.empty(m, cout, device="cuda")),
              buf_ops.affine_dot(torch.cat(f, 1), o["vec"], o["wa"],
                                 torch.empty(m, cout, device="cuda")))
    torch.cuda.synchronize()
    same["train_bottleneck.apply[f32]"] = torch.equal(*outs)
    same["train_bottleneck.bwd_dx[f32]"] = all(
        torch.equal(a, b) for a, b in zip(*dxs))
    same["train_bottleneck.bwd_reduce[f32]"] = all(
        torch.equal(a, b) for a, b in zip(*reds))
    print(f"bn0 f32 kernels under one-hot operands (r=64), bit for bit "
          f"their plain versions: {same}", flush=True)
    require(all(same.values()), f"a #7 float32 form is not exact under "
                                f"one-hot operands: {same}")
    handed_same = all(torch.equal(a, b) for a, b in zip(*handed))
    print(f"bn0 f32: bwd_dx[f32] on the planes bwd_reduce handed over bit "
          f"for bit a call that splits g itself (r=64, random W): "
          f"{handed_same}", flush=True)
    require(handed_same, "bwd_dx[f32] on bwd_reduce's planes differs from "
                         "a call that splits g itself")
    print(f"bn0 f32: apply[f32] bit for bit affine_dot[f32] over the "
          f"concat (r=64, random W): {torch.equal(*concat)}", flush=True)
    require(torch.equal(*concat), "apply[f32] differs from affine_dot[f32] "
                                  "over the concat")
    # one bf16 pass of g, on the random W: the dx and dW limits
    g16 = o["g"].bfloat16().float()
    want = tbk.bwd_dx_plain(f, o["g"], o["stat"], o["bias"], o["red"],
                            o["w"], [torch.empty(m, c, device="cuda")
                                     for c in TB_WIDTHS])
    one = tbk.bwd_dx_plain(f, g16, o["stat"], o["bias"], o["red"], o["w"],
                           [torch.empty(m, c, device="cuda")
                            for c in TB_WIDTHS])
    shares = {"dx": output_errors(torch, one, want,
                                  [("sum", cout)] * len(TB_WIDTHS))[1]}
    dws = [tbk.bwd_reduce_plain(f, g, o["stat"], o["bias"], o["w"],
                                torch.empty(k, cout, device="cuda"),
                                torch.empty(2, k, device="cuda"))[0]
           for g in (g16, o["g"])]
    shares["dW"] = output_errors(torch, [dws[0]], [dws[1]],
                                 [("sum", m, "rows")])[1]
    print(f"bn0 f32: one bf16 pass of g (the plain versions on bf16(g)) "
          f"against float32 g, r=64: the largest share of each limit "
          f"{shares} (dx must exceed 1)", flush=True)
    require(shares["dx"] > 1, f"one bf16 pass of g stays within the f32 "
                              f"dx limit: {shares}")
    return same


# order 14's intermedia adapter at the bn_tile=0 step: c * (1 + order)
# channels of CU-Net-8, fifteen 128-wide groups
WIDE_TB_WIDTHS = (128,) * 15


def tb_dw_f64_rel(torch, tbk, o, kern):
    """``kern``'s (a ``bwd_reduce``) dW at the operands ``o``, and the plain
    version's, as relative L2 errors against float64 products of the same
    r = relu(y) (recomputed in float32, as both compute it) and g."""
    f, m, k, cout = o["feats"], o["m"], o["k"], o["cout"]
    offs = np.cumsum((0,) + tuple(x.shape[1] for x in f))
    g64 = o["g"].double()
    ref = torch.cat([
        torch.relu(tbk._recompute(x, o["stat"], o["bias"], int(a))[1])
        .double().t() @ g64 for x, a in zip(f, offs[:-1])])
    out = {}
    for name, fn in (("kernel", kern), ("plain", tbk.bwd_reduce_plain)):
        dw = fn(f, o["g"], o["stat"], o["bias"], o["w"],
                torch.empty(k, cout, device="cuda"),
                torch.empty(2, k, device="cuda"))[0]
        out[name] = ((dw.double() - ref).norm() / ref.norm()).item()
    return out


def tb_f32_dw_f64_checks(torch, tbk, gen, strict=True):
    """``bwd_reduce[f32]``'s dW partials, summed, against float64 products
    of the same r and g at r=64 and r=4 (phase 9's adapter, batch 24) and
    at Ctot = 1,920 (r=64): each within ``F32_DW_REL`` sqrt(M) relative L2,
    the error of one recursive float32 sum over the M rows (``strict``:
    required). Returns {label: {kernel, plain, limit}}."""
    kern = tbk.bwd_reduce
    out = {}
    for r, widths in ((64, TB_WIDTHS), (4, TB_WIDTHS),
                      (64, WIDE_TB_WIDTHS)):
        o = tb_operands(torch, gen, r, dtype=torch.float32, widths=widths)
        label = f"Ctot={o['k']} r={r}"
        rel = tb_dw_f64_rel(torch, tbk, o, kern)
        rel["limit"] = F32_DW_REL * o["m"] ** 0.5
        out[label] = rel
        del o
    ok = all(v["kernel"] <= v["limit"] for v in out.values())
    print(f"bn0 f32: bwd_reduce[f32]'s dW against float64 products of the "
          f"same r and g (relative L2; the limit F32_DW_REL sqrt(M)): {out}, "
          f"within: {ok}", flush=True)
    require(ok or not strict,
            f"bwd_reduce[f32]'s dW is past its float64 limit: {out}")
    return out


def wide_reduce_check(torch, tbk, gen, results=None):
    """``bwd_reduce[f32]`` at Ctot = 1,920 -> 128 (fifteen 128-wide groups,
    r=64, batch 24) against its plain version, dW and the sums within their
    float32 sum limits, timed beside the plain version, the product g W^T
    alone (``torch.mm``) and its bound; the float32-FMA time of its two
    products."""
    o = tb_operands(torch, gen, 64, dtype=torch.float32,
                    widths=WIDE_TB_WIDTHS)
    m, k, cout = o["m"], o["k"], o["cout"]
    _, call, bounds, w, _, prod = [c for c in tb_cases(torch, o)
                                   if c[0] == "bwd_reduce"][0]
    bounds = [b[:2] for b in bounds]
    got, want = call(tbk.bwd_reduce), call(tbk.bwd_reduce_plain)
    torch.cuda.synchronize()
    err, share, ok = output_errors(torch, got, want, bounds)
    label = f"Ctot={k}->{cout} r=64"
    require(ok, f"bwd_reduce[f32] [{label}] disagrees with its plain "
                f"version: {err} ({share:.3g} of its limit)")
    ms = cuda_time_ms(lambda: call(tbk.bwd_reduce))
    plain_ms = cuda_time_ms(lambda: call(tbk.bwd_reduce_plain), iters=3)
    prod_ms = cuda_time_ms(prod)
    bms, by = bound(w)
    print(f"bn0 kernel train_bottleneck.bwd_reduce[f32] [{label}]: "
          f"max_abs_err {err:.4g} ({share:.3g} of its float32 limit), "
          f"{ms * 1e3:.1f} us vs plain {plain_ms * 1e3:.1f} us, bound "
          f"{bms * 1e3:.1f} us ({by}){product_text(prod_ms)}, float32-FMA "
          f"bound {f32_fma_ms(o, 2) * 1e3:.1f} us", flush=True)


# bwd_dx[f32]'s wide cases: (feature widths, outputs): past the 144
# outputs its first float32 kernel took (two plane halves at 160 to 256)
# and order 14's intermedia adapter
WIDE_DX_CASES = ((TB_WIDTHS, 160), (TB_WIDTHS, 192), (TB_WIDTHS, 256),
                 (WIDE_TB_WIDTHS, 128))


def wide_bwd_dx_check(torch, tbk, gen, strict=True):
    """``bwd_dx[f32]`` at ``WIDE_DX_CASES`` (r=64, batch 24) against its
    plain version within the float32 Cout-term limit, on the planes the
    backward hands it and called alone (which splits g itself: bit for bit
    the same), timed beside the plain version and its bound. ``strict``:
    required (else a checkout that takes no such width prints its
    failure). Returns {label: within its limit}."""
    out = {}
    for widths, cout in WIDE_DX_CASES:
        label = f"Ctot={sum(widths)}->{cout} r=64"
        try:
            o = tb_operands(torch, gen, 64, dtype=torch.float32,
                            widths=widths, cout=cout)
            _, call, bounds, w, _, _ = [c for c in tb_cases(torch, o)
                                        if c[0] == "bwd_dx"][0]
            got, want = call(tbk.bwd_dx), call(tbk.bwd_dx_plain)
            f = o["feats"]
            alone = tbk.bwd_dx(f, o["g"], o["stat"], o["bias"], o["red"],
                               o["w"], [torch.empty_like(x) for x in f])
            torch.cuda.synchronize()
            err, share, ok = output_errors(torch, got, want, bounds)
            same = all(torch.equal(a, b) for a, b in zip(got, alone))
            ms = cuda_time_ms(lambda: call(tbk.bwd_dx))
            plain_ms = cuda_time_ms(lambda: call(tbk.bwd_dx_plain), iters=3)
            bms, by = bound(w)
            print(f"bn0 kernel train_bottleneck.bwd_dx[f32] [{label}]: "
                  f"max_abs_err {err:.4g} ({share:.3g} of its float32 "
                  f"limit: {ok}), called alone bit for bit the same: "
                  f"{same}, {ms * 1e3:.1f} us vs plain {plain_ms * 1e3:.1f} "
                  f"us, bound {bms * 1e3:.1f} us ({by})", flush=True)
            out[label] = ok and same
            del o, got, want, alone
        except (RuntimeError, ValueError) as e:
            print(f"bn0 kernel train_bottleneck.bwd_dx[f32] [{label}]: "
                  f"failed: {e}", flush=True)
            out[label] = False
    require(all(out.values()) or not strict,
            f"bwd_dx[f32] fails a wide case: {out}")
    return out


# #7's backward past the 256 outputs whose W planes a block keeps resident:
# (r, outputs) of the up-block adapter (Ctot = 320); 512 at r=64 is timed
WIDE_OUT_CASES = ((32, 320), (64, 512), (32, 1040))


def wide_out_check(torch, tbk, gen, dtype, strict=True):
    """#7's four kernels at ``dtype`` with ``WIDE_OUT_CASES`` outputs
    (``apply``'s N and the backward's cotangent; the backward stages W's
    planes a slice at a time) against their plain versions within their
    limits (bf16's bound, or the float32 sum limits: ``apply``'s over
    Ctot, ``stats``' over M); at float32 ``apply`` (the forward 1x1 in
    several column blocks) bit for bit ``affine_dot``'s eval form over the
    concat (``csrc/f32_kernels.cu::dot3_kernel``, the order of sums it
    keeps), ``bwd_dx`` on the handed planes bit for bit called alone, and
    the reduce's dW within ``F32_DW_REL`` sqrt(M) of float64. The r=64
    case timed beside its plain version and bound. ``strict``: required
    (else a checkout that takes no such width prints its failure).
    Returns {label: within its limits}."""
    from cunet_tpu_torch.kernels import buf_ops

    tag = "[f32]" if dtype == torch.float32 else ""
    out = {}
    for r, cout in WIDE_OUT_CASES:
        label = f"Ctot={sum(TB_WIDTHS)}->{cout} r={r}"
        try:
            o = tb_operands(torch, gen, r, dtype=dtype, cout=cout)
            cases = {c[0]: c for c in tb_cases(torch, o)}
            oks = []
            for name in ("stats", "apply", "bwd_reduce", "bwd_dx"):
                _, call, bounds, w, _, _ = cases[name]
                kern = getattr(tbk, name)
                got, want = call(kern), call(tbk.PLAIN[kern])
                torch.cuda.synchronize()
                err, share, ok = output_errors(torch, got, want, bounds)
                text = ""
                if name == "apply" and tag:
                    d3 = torch.empty_like(got[0])
                    buf_ops.affine_dot(torch.cat(o["feats"], 1), o["vec"],
                                       o["wa"], d3)
                    same = torch.equal(got[0], d3)
                    ok = ok and same
                    text += (f", bit for bit dot3_kernel over the concat: "
                             f"{same}")
                if name == "bwd_dx" and tag:
                    f = o["feats"]
                    alone = kern(f, o["g"], o["stat"], o["bias"], o["red"],
                                 o["w"], [torch.empty_like(x) for x in f])
                    same = all(torch.equal(a, b) for a, b in zip(got, alone))
                    ok = ok and same
                    text += f", called alone bit for bit the same: {same}"
                if name == "bwd_reduce" and tag:
                    rel = tb_dw_f64_rel(torch, tbk, o, kern)
                    lim = F32_DW_REL * o["m"] ** 0.5
                    ok = ok and rel["kernel"] <= lim
                    text += (f", dW against float64 {rel['kernel']:.3g} "
                             f"(plain {rel['plain']:.3g}, limit {lim:.3g})")
                if r == 64:
                    ms = cuda_time_ms(lambda: call(kern))
                    plain_ms = cuda_time_ms(
                        lambda: call(tbk.PLAIN[kern]), iters=3)
                    bms, by = bound(w)
                    text += (f", {ms * 1e3:.1f} us vs plain "
                             f"{plain_ms * 1e3:.1f} us, bound "
                             f"{bms * 1e3:.1f} us ({by})")
                print(f"bn0 kernel train_bottleneck.{name}{tag} [{label}]: "
                      f"max_abs_err {err:.4g} ({share:.3g} of its limit: "
                      f"{ok}){text}", flush=True)
                oks.append(ok)
                del got, want
            out[label] = all(oks)
            del o
        except (RuntimeError, ValueError) as e:
            print(f"bn0 kernels train_bottleneck{tag} [{label}]: failed: "
                  f"{e}", flush=True)
            out[label] = False
    require(all(out.values()) or not strict,
            f"#7{tag} fails a wide output: {out}")
    return out


def drop_mask_f32_checks(torch, dops, results):
    """The mask kernel's float32 form at the bn_tile=0 shapes (batch 24,
    one tile of the whole batch, g=32): on ones the plain float32 masks
    bit for bit at every traversal position (r = 64 ... 4); in place on a
    conv output and into another float32 view bit for bit its plain
    version, timed at r=64."""
    from cunet_tpu_torch.ops import dropmask

    n, g, nb = TRAIN_BATCH, 32, 4
    gen = torch.Generator().manual_seed(14)
    plain = dops.PLAIN[dops.drop_mask]
    for pos in range(2 * nb + 1):
        r = 64 >> (pos if pos <= nb else 2 * nb - pos)
        m = n * r * r
        ones = torch.ones(m, g, device="cuda")
        dops.drop_mask(ones, -1234567, pos, DROP_RATE, m)
        require(torch.equal(ones, dropmask.rows_mask(
            -1234567, pos, m, g, m, DROP_RATE, torch.float32, "cuda")),
            f"f32 mask kernel on ones differs from the plain float32 mask "
            f"at position {pos}, r={r}")
    r, pos, seed = 64, 1, -31
    m = n * r * r
    y = torch.randn(m, g, generator=gen).cuda()
    d = torch.randn(m, g + 96, generator=gen).cuda()[:, 64:64 + g]
    w = work(2 * sz(m, g, e=4))
    cases = [("forward r=64 in place, one tile", lambda f, o: f(
                 o, seed, pos, DROP_RATE, m), lambda: y.clone()),
             ("backward r=64 f32->f32", lambda f, o: f(
                 d, seed, pos, DROP_RATE, m, o),
              lambda: torch.empty(m, g, device="cuda"))]
    for label, call, make_out in cases:
        k_out, p_out = make_out(), make_out()
        call(dops.drop_mask, k_out)
        call(plain, p_out)
        torch.cuda.synchronize()
        same = torch.equal(k_out, p_out)
        ms = cuda_time_ms(lambda: call(dops.drop_mask, k_out))
        plain_ms = cuda_time_ms(lambda: call(plain, p_out))
        print(f"bn0 f32 kernel drop_mask[f32] [{label}]: bit-identical "
              f"{same}, {ms:.4f} ms vs plain {plain_ms:.4f} ms, bound "
              f"{bound(w)[0]:.4f} ms ({bound(w)[1]})", flush=True)
        require(same, f"drop_mask[f32] [{label}] differs from its plain "
                      f"version")
        record(results, "drop_mask[f32]", 0.0, ms, plain_ms, label, w, None)


def phase_bn0_f32_kernels(torch, tbk, dops):
    """Phase 13 (a): #7's float32 forms against their plain versions at
    every resolution (phase 9's cases at float32, TF32 off: every sum and
    float32 output within the float32 n-term limit, three planted
    ``stats`` faults), bit for bit under one-hot operands, one bf16 pass
    of g breaking the dx limit; ``bwd_reduce[f32]``'s dW within
    ``F32_DW_REL`` sqrt(M) of float64 (r = 64, 4 and Ctot = 1,920) and
    the reduce at Ctot = 1,920 against its plain version; ``bwd_dx[f32]``
    at ``WIDE_DX_CASES``; the mask kernel's float32 form."""
    results = phase_bn0_kernels(torch, tbk, torch.float32)
    gen = torch.Generator().manual_seed(15)
    exact = tb_f32_exact_checks(torch, tbk, gen)
    for name, same in exact.items():
        results[name]["one_hot_exact"] = same
    results["train_bottleneck.bwd_reduce[f32]"]["dw_f64_rel"] = \
        tb_f32_dw_f64_checks(torch, tbk, gen)
    wide_reduce_check(torch, tbk, gen)
    results["train_bottleneck.bwd_dx[f32]"]["wide"] = wide_bwd_dx_check(
        torch, tbk, gen)
    results["train_bottleneck.bwd_dx[f32]"]["wide_out"] = wide_out_check(
        torch, tbk, gen, torch.float32)
    drop_mask_f32_checks(torch, dops, results)
    return results


def check_conv_repair(torch):
    """Phase 13 (c): one CU-Net-8 3x3 conv at r=64, batch 24, 128 -> 32, at
    float32 with cuDNN's TF32 at torch's default (on): the port's conv
    (``ops.layers.conv2d``) gives dX and dW within the float32 n-term
    limit of a float64 reference; the conv as it was before the repair
    (``F.conv2d`` with TF32 off for the forward only, the backward under
    the global flag) must break it."""
    import torch.nn.functional as F

    from cunet_tpu_torch.ops.layers import conv2d

    gen = torch.Generator().manual_seed(16)
    n, r, c, g = TRAIN_BATCH, 64, 128, 32
    x = torch.randn(n, r, r, c, generator=gen).relu().cuda()
    w = (torch.randn(3, 3, c, g, generator=gen) * (9 * c) ** -0.5).cuda()
    ct = torch.randn(n, r, r, g, generator=gen).cuda()
    cudnn = torch.backends.cudnn

    def grads(conv, dtype):
        xx = x.to(dtype).clone().requires_grad_(True)
        ww = w.to(dtype).clone().requires_grad_(True)
        conv(xx, ww).backward(ct.to(dtype))
        return xx.grad, ww.grad

    def unrepaired(xx, ww):
        with cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            y = F.conv2d(xx.permute(0, 3, 1, 2), ww.permute(3, 2, 0, 1),
                         padding=1)
        return y.permute(0, 2, 3, 1)

    want = grads(lambda a, b: conv2d(a, b, padding=1), torch.float64)
    bounds = [("sum", 9 * g), ("sum", n * r * r)]
    shares = {}
    default = cudnn.allow_tf32
    cudnn.allow_tf32 = True
    try:
        for label, conv in (("repaired", lambda a, b: conv2d(a, b,
                                                             padding=1)),
                            ("unrepaired", unrepaired)):
            got = grads(conv, torch.float32)
            torch.cuda.synchronize()
            shares[label] = [
                output_errors(torch, [a], [b.float()], [bnd])[:2]
                for a, b, bnd in zip(got, want, bounds)]
    finally:
        cudnn.allow_tf32 = default
    print(f"bn0 f32 conv repair, 3x3 conv r=64 batch 24 128->32, TF32 on "
          f"globally: (max_abs_err, share of the float32 limit) of dX, dW "
          f"against float64: {shares}", flush=True)
    require(all(sh <= 1 for _, sh in shares["repaired"]),
            f"the float32 conv's backward is off float64: {shares}")
    require(max(sh for _, sh in shares["unrepaired"]) > 1,
            f"the check cannot see a TF32 backward: {shares}")
    return shares


def step_leaves(torch, a, b):
    """{"loss": relative distance, grad leaf: relative L2, BN running
    stat: relative L2} of the step (loss, grads, bn_state) ``a`` against
    ``b``, over b's nonzero leaves."""
    (la, ga, sa), (lb, gb, sb) = a, b
    out = {"loss": abs(la - lb) / abs(lb)}
    out.update({n: _rel_l2(torch, ga, gb, [n]) for n in gb
                if gb[n].norm() > 0})
    out.update({n: _rel_l2(torch, sa, sb, [n]) for n in sb
                if sb[n].norm() > 0})
    return out


def f32_step_check(torch, label, cfg, params, state, x, t, swapped,
                   counters, perms, quant=None, noise=0, **kw):
    """Phase 13 (d) and 14 (b): the float32 kernel step against the swap
    step from the same state (``swapped()``: the path with its kernels'
    plain versions swapped in, none of ``counters``' kernels launching),
    its loss, each grad leaf and each BN running stat within
    max(F32_STEP_CONTROL x the swap step's control, F32_STEP_FLOOR), the
    control the largest distance of the swap step on the batch permuted by
    each of ``perms`` (the same function, its sums in another order); the
    plain path (use_pallas off) beside both, printed; then the kernel step
    again, bit for bit. With ``quant`` (phase 15 (b)) every step runs the
    quantized model from the masters ``params``, and the swap step and its
    controls run on the kernel step's int8 codes (``f32_step_gap.
    pinned_codes``): a code one of them rounds across a boundary moves its
    activation by 2^-7, which would swamp the float rounding the check
    holds; the codes the swap step would have taken otherwise are
    counted. ``noise`` adds that many one-ulp product controls to c (the
    swap step with every rounded form's output moved by one ulp in half
    its elements, ``f32_step_gap.slot_swap(gen=...)``, the card test's
    controls): the kernels reround every product, which no permutation
    reaches. ``kw`` (dropout arguments) reach every step; threefry masks
    follow a sample's place in the batch, so their check takes no
    permutations (``perms`` empty) and the noise controls alone. Returns
    (the kernel step, the swap step, {leaf: (distance, limit)} past their
    limits)."""
    from cunet_tpu_torch.kernels import train_slot
    from cunet_tpu_torch.tools.f32_step_gap import (
        patched,
        pinned_codes,
        recorded_codes,
        slot_swap,
    )

    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    codes, flips = [], []

    def grads(c, x, t):
        return _grads(torch, c, params, state, x, t, quant=quant, **kw)

    def pin(perm=None, flips=None):
        return (pinned_codes(codes, perm, flips) if quant is not None
                else contextlib.nullcontext())

    with (recorded_codes(train_slot, codes) if quant is not None
          else contextlib.nullcontext()):
        k = grads(cfg, x, t)
    with swapped():
        counters.reset_launch_counts()
        with pin(flips=flips):
            s = grads(cfg, x, t)
        sc = []
        for q in perms:
            with pin(q):
                sc.append(grads(cfg, x[q], t[q]))
        swapped_launches = sum(counters.launch_counts().values())
    for i in range(noise):
        noisy = slot_swap(gen=torch.Generator(device="cuda").manual_seed(
            23 + i))
        with patched(train_slot, **noisy), pin():
            sc.append(grads(cfg, x, t))
    if quant is not None:
        print(f"{label}: the swap step and its controls on the kernel "
              f"step's {sum(c.numel() for c in codes)} QuanInput codes; the "
              f"swap step's own would differ at {sum(flips)} of them",
              flush=True)
    require(swapped_launches == 0, f"{label}: the swap step launched "
                                   f"kernels")
    p = grads(plain_cfg, x, t)

    def summary(name, a, b):
        (_, ga, sa), (_, gb, sb) = a, b
        g = [n for n in gb if gb[n].norm() > 0]
        st = [n for n in sb if sb[n].norm() > 0]
        d = step_leaves(torch, a, b)
        cos = np.mean([torch.nn.functional.cosine_similarity(
            ga[n].flatten(), gb[n].flatten(), dim=0).item() for n in g])
        worst = max(g, key=d.get)
        print(f"{label}: {name}: loss {d['loss']:.4g}; grads over "
              f"all {_rel_l2(torch, ga, gb, g):.4g}, median leaf "
              f"{np.median([d[n] for n in g]):.4g}, worst {worst} "
              f"{d[worst]:.4g}, mean cosine {cos:.4f}; BN stats over all "
              f"{_rel_l2(torch, sa, sb, st):.4g}, worst "
              f"{max(d[n] for n in st):.4g}", flush=True)
        return d

    print(f"{label}: losses: kernel {k[0]:.8g}, swap {s[0]:.8g}, "
          f"plain path {p[0]:.8g}", flush=True)
    got = summary("kernel vs swap step", k, s)
    ctrl = [summary(f"control: swap step "
                    f"{'permuted' if i < len(perms) else 'one-ulp noise'} "
                    f"({i}) vs swap step", c, s)
            for i, c in enumerate(sc)]
    summary("kernel step vs plain path", k, p)
    summary("swap step vs plain path", s, p)
    if perms:
        summary("control: plain path permuted (0) vs plain path",
                grads(plain_cfg, x[perms[0]], t[perms[0]]), p)
    c = {n: max(d[n] for d in ctrl) for n in got}
    lim = {n: max(F32_STEP_CONTROL * c[n], F32_STEP_FLOOR) for n in got}
    bad = {n: (got[n], lim[n]) for n in got if not got[n] <= lim[n]}
    print(f"{label}: kernel vs swap step: loss {got['loss']:.4g} "
          f"(limit {lim['loss']:.4g}); {len(got) - len(bad)}/{len(got)} of "
          f"the loss, grad leaves and BN stats within max("
          f"{F32_STEP_CONTROL:g} x the control, {F32_STEP_FLOOR:g}); "
          f"largest share of its limit: "
          f"{max(got[n] / lim[n] for n in got):.3f}; over: {bad}",
          flush=True)
    require(not bad, f"{label}: step off the swap step: "
                                   f"{bad}")
    lk2, gk2, _ = grads(cfg, x, t)
    same = lk2 == k[0] and all(torch.equal(k[1][n], gk2[n]) for n in gk2)
    print(f"{label}: repeated kernel step bit-identical: {same}",
          flush=True)
    require(same, f"{label}: the kernel step is not deterministic")
    return k, s, bad


def f64_step_hold(torch, label, cfg, params, state, x, t, k, s):
    """The kernel step ``k`` and the swap step ``s`` (``f32_step_check``'s)
    each against the plain path's step in float64 (``f32_step_gap.
    step_f64``: no operation rounds to float32): the loss, each grad leaf
    and each BN running stat of the kernel step no farther from float64
    than max(F32_STEP_CONTROL x the swap step's distance,
    F32_STEP_FLOOR), so the kernels lose no accuracy that the plain
    versions keep, however far a chaotic model carries either. Returns
    {number: (distance, limit)} past their limits."""
    from cunet_tpu_torch.tools.f32_step_gap import rel, step_f64

    ref = step_f64(cfg, params, state, x, t)

    def dist(a):
        (la, ga, sa), (lr, gr, sr) = a, ref
        d = {"loss": abs(la - lr) / abs(lr)}
        d.update({n: rel(ga[n], gr[n]) for n in gr if gr[n].norm() > 0})
        d.update({n: rel(sa[n], sr[n]) for n in sr if sr[n].norm() > 0})
        return d

    dk, ds = dist(k), dist(s)
    lim = {n: max(F32_STEP_CONTROL * ds[n], F32_STEP_FLOOR) for n in dk}
    bad = {n: (dk[n], lim[n]) for n in dk if not dk[n] <= lim[n]}
    ratio = {n: dk[n] / max(ds[n], 1e-30) for n in dk}
    worst = sorted(ratio, key=ratio.get, reverse=True)[:3]
    print(f"{label}: kernel and swap steps against float64: loss "
          f"{dk['loss']:.4g} / {ds['loss']:.4g}; {len(dk) - len(bad)}/"
          f"{len(dk)} of the loss, grad leaves and BN stats of the kernel "
          f"step within max({F32_STEP_CONTROL:g} x the swap step's "
          f"distance, {F32_STEP_FLOOR:g}); largest share of its limit "
          f"{max(dk[n] / lim[n] for n in dk):.3f}; largest ratios "
          + ", ".join(f"{n} {dk[n]:.4g} / {ds[n]:.4g}" for n in worst)
          + f"; over: {bad}", flush=True)
    require(not bad, f"{label}: kernel step farther from "
                                   f"float64 than the swap step: {bad}")
    return bad


# the float32 bn_tile=0 model past bwd_dx's first float32 width:
# growth_rate 48 (192 outputs at every bottleneck), cut to two slots
WIDE_BN0_GROWTH, WIDE_BN0_LAYERS = 48, 2
# neck_size, growth_rate of a model whose bottlenecks' #7 calls are 320
# outputs wide, past the 256 whose W planes the backward keeps resident
WIDER_BN0 = (5, 64)


def wide_bn0_step_check(torch, tbk, cfg, x, t, perms, neck=None,
                        growth=WIDE_BN0_GROWTH, f64=False):
    """Phases 9 and 13 (d), wide: the ``bn_tile=0`` step of a model with
    ``growth_rate`` ``growth`` (and ``neck_size`` ``neck``) at ``cfg``'s
    dtype: at WIDE_BN0_GROWTH every bottleneck's #7 call 192 outputs wide
    (two plane halves of g), at WIDER_BN0 320 (W's planes staged a slice
    at a time), at WIDE_BN0_LAYERS slots, against its swap step within
    max(2c, 1e-5), c over the batch permuted by ``perms``
    (``f32_step_check``); #7's launches of the kernel steps counted. At
    bf16 too the swap step (#7's plain versions swapped in) is the
    reference: a two-slot model is too chaotic in bf16 for the plain
    step's bands (the plain path rounds otherwise than #7 on purpose), at
    128 outputs on the resident-W kernels as at 320. With ``f64`` the
    kernel step is also held to float64 (``f64_step_hold``): at float32
    and 320 outputs on the smoke's batch, where ``stats[f32]``'s float32
    sums once moved ``hg.neck.layers.1`` 4.7x farther from float64 than
    the swap step (``tools/f32_step_gap.py --smoke_batch``, PERF.md
    section 7); its float64 sums hold both limits."""
    from cunet_tpu_torch.models import init_cu_net

    wide = dataclasses.replace(cfg, growth_rate=growth,
                               neck_size=neck or cfg.neck_size,
                               layer_num=WIDE_BN0_LAYERS,
                               loss_num=WIDE_BN0_LAYERS)
    params, state = init_cu_net(wide, torch.Generator().manual_seed(0))
    f32 = cfg.compute_dtype == "float32"
    label = (f"bn0 {'f32' if f32 else 'bf16'} training, neck_size "
             f"{wide.neck_size} x growth_rate {growth} "
             f"({wide.neck_size * wide.growth_rate} outputs), "
             f"{WIDE_BN0_LAYERS} slots")
    tbk.reset_launch_counts()
    k, s, _ = f32_step_check(torch, label, wide, params, state, x, t,
                             lambda: tb_plain_swapped(tbk), tbk, perms)
    if f64:
        f64_step_hold(torch, label, wide, params, state, x, t, k, s)
    print(f"{label}: #7 launches of the checks' kernel steps "
          f"{tbk.f32_counts() if f32 else tbk.launch_counts()}", flush=True)


def phase_bn0_f32_training(torch, tbk, tops, bops, dops, gpu, bf16_times):
    """Phase 13 (b)-(e): the Function at float32; the conv repair;
    CU-Net-8 @256 at float32, bn_tile=0, on #7's float32 forms: the step
    against the swap step (and, at growth 48 and at 320 outputs,
    ``wide_bn0_step_check``; at 320 on all four kernels against its swap
    step and against float64, both required),
    remat "layer" / "block" bit for bit, dropout through the mask kernel's
    float32 form bit for bit the plain mask's step, one W1/I8/G8 step,
    three main-path steps; step times and peak memory beside phase 9's
    bf16 step. Returns ({row: launches of the
    main path's drive}, launches per step)."""
    import types

    from cunet_tpu_torch import QuantConfig, TrainConfig
    from cunet_tpu_torch.train import (
        create_train_state,
        quant_train_step,
        train_step,
    )

    check_tb_function(torch, tbk, torch.float32)
    check_conv_repair(torch)
    cfg, params, state, batch = flagship_train(torch)
    cfg = dataclasses.replace(cfg, compute_dtype="float32", bn_tile=0,
                              bn_dtype="float32")
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    x, t = batch["image"], batch["heatmap"]
    f32_tb = types.SimpleNamespace(reset_launch_counts=tbk.reset_launch_counts,
                                   launch_counts=tbk.f32_counts)
    f32_drop = mask_counter(dops.drop_mask, f32=True)

    torch.backends.cudnn.deterministic = True
    try:
        perms = [torch.randperm(x.shape[0], generator=torch.Generator()
                                .manual_seed(17 + i)).cuda()
                 for i in range(F32_STEP_PERMS)]
        f32_step_check(torch, "bn0 f32 training", cfg, params, state, x, t,
                       lambda: tb_plain_swapped(tbk), tbk, perms)
        wide_bn0_step_check(torch, tbk, cfg, x, t, perms)
        wide_bn0_step_check(torch, tbk, cfg, x, t, perms, *WIDER_BN0,
                            f64=True)
        l0, g0, peak0 = step_memory(torch, cfg, params, state, batch)
        for remat in ("layer", "block"):
            lr, gr, peak = step_memory(torch, dataclasses.replace(
                cfg, remat=remat), params, state, batch)
            same = lr == l0 and all(torch.equal(gr[k], g0[k]) for k in g0)
            print(f"bn0 f32 training: remat={remat!r} vs 'none' on the "
                  f"kernel path: loss and grads bit-identical {same}; peak "
                  f"memory of one step {peak / 2 ** 30:.2f} GiB ('none' "
                  f"{peak0 / 2 ** 30:.2f} GiB; {gpu})", flush=True)
            require(same, f"bn0 f32 training: remat={remat!r} changes the "
                          f"step")
            del gr
        del g0
    finally:
        torch.backends.cudnn.deterministic = False

    # the main path: three steps, then one each of dropout and W1/I8/G8
    tcfg = TrainConfig(lr=2.5e-4, batch_size=TRAIN_BATCH)
    st = create_train_state(params, state, tcfg)
    bops.reset_launch_counts()
    tops.reset_launch_counts()
    launches = main_path_steps(
        torch, "bn0 f32 training", lambda: train_step(st, batch, cfg=cfg)[1],
        lambda: st.params, (f32_tb,))
    others = {k: v for k, v in {**bops.launch_counts(),
                                **tops.launch_counts()}.items()
              if v and k != "sum_rows"}
    require(not others, f"bn0 f32 training launched slot kernels: {others}")
    drop_cfg = dataclasses.replace(cfg, drop_rate=DROP_RATE)
    bn0_dropout(torch, drop_cfg, params, state, x, t, dops)
    st_d = create_train_state(params, state, tcfg)
    gen = torch.Generator().manual_seed(6)
    drop_launches = one_step(
        torch, "bn0 f32 dropout training",
        lambda: train_step(st_d, batch, cfg=drop_cfg, generator=gen)[1],
        (f32_tb, f32_drop))
    del st_d
    st_q = create_train_state(params, state, tcfg)
    quant = QuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True)
    one_step(torch, "bn0 f32 quantized training",
             lambda: quant_train_step(st_q, batch, cfg=cfg, qcfg=quant)[1],
             (f32_tb,))
    del st_q

    # (e) step times and peak memory, kernel path then plain path
    st_p = create_train_state(params, state, tcfg)
    times = report_times(torch, "bn0 f32 training",
                         lambda: train_step(st, batch, cfg=cfg),
                         lambda: train_step(st_p, batch, cfg=plain_cfg), gpu)
    print(f"bn0 training, float32 against bf16 (phase 9, this run), batch "
          f"{TRAIN_BATCH}: " + "; ".join(
              f"{path} path {times[path][0]:.3f} ms, "
              f"{times[path][1] / 2 ** 30:.2f} GiB (bf16 "
              f"{bf16_times[path][0]:.3f} ms, "
              f"{bf16_times[path][1] / 2 ** 30:.2f} GiB)"
              for path in ("kernel", "plain")) + f" ({gpu})", flush=True)
    rows = {f"train_bottleneck.{k}": v for k, v in launches.items()}
    rows["drop_mask[f32]"] = drop_launches["drop_mask[f32]"]
    per_step = {k: v / 3 for k, v in rows.items()}
    per_step["drop_mask[f32]"] = rows["drop_mask[f32]"]
    return rows, per_step


# ---------------------------------------------------------------------------
# phase 14: float32 ghost-BN training, on the float32 forms of #8/#9
# ---------------------------------------------------------------------------

# the reference's own BN groups (bs 24 on 4 GPUs): the step that is checked;
# the smoke's bf16 tile runs and is timed too
SLOT_F32_TILE = 6
SLOT_F32_TILES = (BN_TILE, SLOT_F32_TILE)
# the float32 weight gradients' relative L2 error against float64, per
# sqrt(M): 2^-24 sqrt(M), the expected error of one recursive float32 sum
# over M rows (1.9e-5 at r=64); one bf16 rounding of dy gives ~1e-3
F32_DW_REL = 2.0 ** -24
# the kernels line's rows of the ten forms F1-F10 of the float32 ghost-BN
# step: (wrapper, TPU function it replaces); the per-tile forward products
# have rows of their own beside phase 12's eval forms
SLOT_F32 = {
    "bn_stats[f32]": ("bn_stats", REPLACES["bn_stats"]),
    "affine_dot[f32,tile]": ("affine_dot",
                             "cunet_tpu/kernels/train_slot.py:172"),
    "conv3x3[f32,tile]": ("conv3x3", "cunet_tpu/kernels/train_slot.py:647"),
    "affine_dx[f32]": ("affine_dx", REPLACES["affine_dx"]),
    "affine_dw[f32]": ("affine_dw", REPLACES["affine_dw"]),
    "bn_bwd[f32]": ("bn_bwd", REPLACES["bn_bwd"]),
    "conv3x3_dx[f32]": ("conv3x3_dx", REPLACES["conv3x3_dx"]),
    "conv3x3_dw[f32]": ("conv3x3_dw", REPLACES["conv3x3_dw"]),
    "maxpool2_bwd[f32]": ("maxpool2_bwd", REPLACES["maxpool2_bwd"]),
    "upsample2_bwd[f32]": ("upsample2_bwd", REPLACES["upsample2_bwd"]),
}
REPLACES.update({k: v[1] for k, v in SLOT_F32.items()})


def slot_f32_operands(torch, tops, gen, r, tile):
    """Float32 operands of the ten forms at resolution ``r`` of the
    CU-Net-8 @256 step (batch 24, ghost-BN ``tile``; c=128, g=32, Cb=128,
    16 classes): the K=192 adapter input as a view of a wider buffer, its
    per-tile statistics, BN and vectors, the conv input and its BN2
    vectors, cotangents, the weights."""
    from cunet_tpu_torch.kernels.train_slot import _affine_vec

    n, c, g, cb = TRAIN_BATCH, 128, 32, 128
    m, tiles = n * r * r, n // tile

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    def stats(x):
        k = x.shape[1]
        st = tops.bn_stats_plain(x, torch.empty(tiles, 2, k, device="cuda"))
        bn = torch.stack([torch.rand(k, generator=gen) + 0.5,
                          torch.randn(k, generator=gen) * 0.3]).cuda()
        return st, bn, _affine_vec(st, bn, 1e-5)

    o = dict(m=m, r=r, tiles=tiles, tile_rows=m // tiles)
    buf = randn(m, 224)
    o["x2"] = buf[:, :192]         # [y | fifo | out32] of a down block
    o["st2"], o["bn2"], o["v2"] = stats(o["x2"])
    o["w_a"] = randn(192, c, scale=192 ** -0.5)
    o["dy"] = randn(m, c)
    o["d_a"] = randn(m, 192)
    o["yb"] = randn(m, cb) * 1.5 + 0.2
    _, _, o["vb"] = stats(o["yb"])
    o["w3"] = randn(9 * cb, g, scale=(9 * cb) ** -0.5)
    o["d_o"] = randn(m, g)
    o["w_h"] = randn(c, 16, scale=c ** -0.5)
    o["d_head"] = randn(m, 16)
    o["ahead"] = randn(m, c)
    o["d_pool"] = randn(m // 4, c)
    if r < 64:
        o["d_up"] = randn(4 * m, c)
    o["dx0"] = randn(m, 192)       # the d_x that bn_bwd adds into
    return o


def slot_f32_cases(torch, tops, bops, o):
    """(row, kernel, label, call(fn) -> outputs, bounds, work, float32 FMA
    ms of the products, library call, product alone) of the ten forms at
    the operands ``o``, ``bn_bwd`` twice: writing d_x, and adding into a
    random d_x (``accumulate``, as the slot backward does for a block's
    skip adapter and bottleneck and for the head; the kernel's own
    instances). Bounds: the float32 n-term sum, exact for the pool's
    routing. Library calls at float32 with TF32 off: ``torch.
    var_mean``, ``native_batch_norm_backward`` on the ghost-tile layout,
    ``conv2d_input`` / ``conv2d_weight``, the 2x2 sum as ``avg_pool2d``;
    the 1x1 products and the forward conv have none (a BN prologue or a
    gate on the product), so ``torch.mm`` / ``F.conv2d`` of the product
    alone stands beside them."""
    import torch.nn.functional as F

    n, c, g, cb = TRAIN_BATCH, 128, 32, 128
    m, r, tiles, tr = o["m"], o["r"], o["tiles"], o["tile_rows"]
    x2, v2, dy = o["x2"], o["v2"], o["dy"]
    vecb = sz(tiles, 2, 192, e=4)
    w_oihw = o["w3"].view(3, 3, cb, g).permute(3, 2, 0, 1).contiguous()
    ybf = o["yb"].view(tiles, tr, cb)

    def empty(*shape):
        return torch.empty(*shape, device="cuda")

    def mm_work(rows, k, nout, extra=0):
        return f32_work(rows, [(rows, k)], nout, extra=extra)

    w2, fma2 = mm_work(m, 192, c, vecb)
    wh, fmah = mm_work(m, c, 16, sz(tiles, 2, c, e=4))
    wc, fmac = f32_work(m, [(m, 9 * cb)], g)
    wc = work(sz(m, cb, e=4) + sz(9 * cb, g, e=4) + sz(m, g, e=4) + vecb,
              wc[1], "bf16")
    wdx = work(sz(m, c, e=4) + sz(192, c, e=4) + 2 * sz(m, 192, e=4) + vecb,
               6 * 2 * m * 192 * c, "bf16")
    wdw = work(sz(m, 192, e=4) + sz(m, c, e=4) + sz(192, c, e=4) + vecb,
               6 * 2 * m * 192 * c, "bf16")
    wcdx = work(sz(m, g, e=4) + sz(9 * cb, g, e=4) + 2 * sz(m, cb, e=4)
                + vecb, 6 * 2 * m * 9 * cb * g, "bf16")
    wcdw = work(sz(m, cb, e=4) + sz(m, g, e=4) + sz(9 * cb, g, e=4) + vecb,
                6 * 2 * m * 9 * cb * g, "bf16")
    fma = lambda flops: flops / PEAK_OPS["f32"] * 1e3  # noqa: E731
    xf = x2.reshape(tiles, tr, 192).permute(1, 0, 2).reshape(
        tr, tiles * 192).contiguous()
    daf = o["d_a"].reshape(tiles, tr, 192).permute(1, 0, 2).reshape(
        tr, tiles * 192).contiguous()
    mean = o["st2"][:, 0].reshape(-1).contiguous()
    rstd = torch.rsqrt(o["st2"][:, 1] + 1e-5).reshape(-1).contiguous()
    gamma = o["bn2"][0].repeat(tiles).contiguous()
    cases = [
        ("bn_stats[f32]", tops.bn_stats, f"K=192 r={r}",
         lambda f: [f(x2, empty(tiles, 2, 192))], [("sum", tr)],
         work(sz(m, 192, e=4) + sz(tiles, 2, 192, e=4), 3 * m * 192, "f32"),
         None, lambda: torch.var_mean(x2.reshape(tiles, tr, 192), dim=1,
                                      correction=0), None),
        ("affine_dot[f32,tile]", bops.affine_dot, f"K=192->128 r={r}",
         lambda f: [f(x2, v2, o["w_a"], empty(m, c))], [("sum", 192)], w2,
         fma2, None, lambda: torch.mm(x2, o["w_a"])),
        ("affine_dot[f32,tile]", bops.affine_dot, f"head 128->16 r={r}",
         lambda f: [f(o["yb"], o["vb"], o["w_h"], empty(m, 16))],
         [("sum", c)], wh, fmah, None, lambda: torch.mm(o["yb"], o["w_h"])),
        ("conv3x3[f32,tile]", bops.conv3x3, f"Cb=128->32 r={r}",
         lambda f: [f(o["yb"], o["w3"], n, r, r,
                      empty(m, 224)[:, 192:224], vec=o["vb"])],
         [("sum", 9 * cb)], wc, fma(2 * m * 9 * cb * g), None,
         lambda: F.conv2d(nchw(o["yb"], r), w_oihw, padding=1)),
        ("affine_dx[f32]", tops.affine_dx, f"K=192->128 r={r}",
         lambda f: [f(dy, o["w_a"], x2, v2, empty(m, 192))], [("sum", c)],
         wdx, fma(2 * m * 192 * c), None,
         lambda: torch.mm(dy, o["w_a"].t())),
        ("affine_dx[f32]", tops.affine_dx, f"head 128->16 r={r}",
         lambda f: [f(o["d_head"], o["w_h"], o["yb"], o["vb"],
                      empty(m, c))], [("sum", 16)],
         work(sz(m, 16, e=4) + 2 * sz(m, c, e=4), 6 * 2 * m * c * 16,
              "bf16"), fma(2 * m * c * 16), None,
         lambda: torch.mm(o["d_head"], o["w_h"].t())),
        ("affine_dw[f32]", tops.affine_dw, f"K=192->128 r={r}",
         lambda f: [f(x2, v2, dy, empty(192, c))], [("sum", m)], wdw,
         fma(2 * m * 192 * c), None, lambda: torch.mm(x2.t(), dy)),
        ("bn_bwd[f32]", tops.bn_bwd, f"K=192 r={r}",
         lambda f: _bn_bwd_outs(f, o, empty), [("sum", tr), ("sum", m)],
         work(3 * sz(m, 192, e=4) + vecb, 8 * m * 192, "f32"), None,
         lambda: torch.ops.aten.native_batch_norm_backward(
             daf, xf, gamma, None, None, mean, rstd, True, 1e-5,
             [True, True, True]), None),
        ("bn_bwd[f32]", tops.bn_bwd, f"K=192 r={r} accumulate",
         lambda f: _bn_bwd_outs(f, o, empty, accumulate=True),
         [("sum", tr), ("sum", m)],
         work(4 * sz(m, 192, e=4) + vecb, 9 * m * 192, "f32"), None, None,
         None),
        ("conv3x3_dx[f32]", tops.conv3x3_dx, f"32->128 r={r}",
         lambda f: [f(o["d_o"], o["w3"], n, r, r, o["yb"], o["vb"],
                      empty(m, cb))], [("sum", 9 * g)], wcdx,
         fma(2 * m * 9 * cb * g),
         lambda: torch.nn.grad.conv2d_input((n, cb, r, r), w_oihw,
                                            nchw(o["d_o"], r), padding=1),
         None),
        ("conv3x3_dw[f32]", tops.conv3x3_dw, f"(9*128, 32) r={r}",
         lambda f: [f(o["yb"], o["vb"], o["d_o"], n, r, r,
                      empty(9 * cb, g))], [("sum", m)], wcdw,
         fma(2 * m * 9 * cb * g),
         lambda: torch.nn.grad.conv2d_weight(nchw(o["yb"], r), (g, cb, 3, 3),
                                             nchw(o["d_o"], r), padding=1),
         None),
    ]
    if r < 64:
        cases.append(
            ("upsample2_bwd[f32]", tops.upsample2_bwd, f"{2 * r}->{r}",
             lambda f: [f(o["d_up"], n, r, r, empty(m, c))], [("sum", 4)],
             work(sz(4 * m, c, e=4) + sz(m, c, e=4), 3 * m * c, "f32"),
             None, lambda: F.avg_pool2d(nchw(o["d_up"], 2 * r), 2,
                                        divisor_override=1), None))
    if r > 4:
        cases.append(
            ("maxpool2_bwd[f32]", tops.maxpool2_bwd, f"{r}->{r // 2}",
             lambda f: [f(o["ahead"], o["d_pool"], n, r, r, empty(m, c))],
             [("exact",)], work(2 * sz(m, c, e=4) + sz(m // 4, c, e=4),
                                4 * m * c, "f32"), None, None, None))
    return cases


def _bn_bwd_outs(f, o, empty, accumulate=False):
    d_x = o["dx0"].clone() if accumulate else empty(o["m"], 192)
    dbn = empty(2, 192)
    f(o["x2"], o["d_a"], o["st2"], o["bn2"], 1e-5, d_x, dbn,
      accumulate=accumulate)
    return [d_x, dbn]


def im2col(torch, y, b, h, w):
    """(M, 9C) tap-major: column tap*C + c of row m is y at m's pixel moved
    by (tap // 3 - 1, tap % 3 - 1), zero outside m's image: the implicit
    GEMM's operand, for exact references under one-hot weights."""
    import torch.nn.functional as F

    c = y.shape[1]
    p = F.pad(y.reshape(b, h, w, c), (0, 0, 1, 1, 1, 1))
    cols = [p[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]
    return torch.cat(cols, dim=-1).reshape(b * h * w, 9 * c)


def f32_sums_f64_checks(torch, tops, tbk, strict=True):
    """The sums of the float32 statistics and BN-jacobian kernels against
    float64, beside their plain versions', at r=64, K=192, batch 24 on the
    smoke's operands (x ~ N(0, 1)) and on a cancelling input (x ~ 4 +
    N(0, 1): mean^2 / var ~ 16): ``bn_stats[f32]``'s mean (largest error
    over a channel's float64 standard deviation) and variance (largest
    relative error), at tiles 2 and 6; ``bn_bwd[f32]``'s dbn (largest
    error over its largest value) and d_x, at tiles 2 and 6; #7's
    ``stats[f32]``'s variance E[x^2] - mean^2 from its sums (largest
    relative error; the concat of x's 128 and 64 columns). With
    ``strict`` the two statistics kernels, and ``bn_bwd[f32]``'s dbn,
    must lie no farther from float64 than their plain versions (their
    sums are float64, rounded once; d_x, rounded from float32 products
    of those sums, is printed). Returns {row: [(case, kernel error,
    plain error, held)]}."""
    m, k = TRAIN_BATCH * 64 * 64, 192
    gen = torch.Generator().manual_seed(23)
    out = {}

    def note(row, case, kern_err, plain_err, what, held=True):
        out.setdefault(row, []).append((case, kern_err, plain_err, held))
        print(f"f64 sums {row} [{case}]: {what} from float64 "
              f"{kern_err:.4g} (plain version {plain_err:.4g})", flush=True)

    for name, shift in (("N(0,1)", 0.0), ("4+N(0,1)", 4.0)):
        buf = torch.randn(m, 224, generator=gen).cuda() + shift
        x = buf[:, :k]
        x64 = x.double()
        for tile in SLOT_F32_TILES:
            tiles = TRAIN_BATCH // tile
            case = f"K=192 r=64 tile {tile}, x ~ {name}"
            xt = x64.view(tiles, -1, k)
            mean64, var64 = xt.mean(1), xt.var(1, unbiased=False)
            errs = []
            for fn in (tops.bn_stats, tops.bn_stats_plain):
                st = fn(x, torch.empty(tiles, 2, k, device="cuda")).double()
                errs.append((((st[:, 0] - mean64) / var64.sqrt()).abs().max()
                             .item(),
                             ((st[:, 1] - var64) / var64).abs().max().item()))
            note("bn_stats[f32]", case, errs[0][0], errs[1][0],
                 "mean's largest error in standard deviations")
            note("bn_stats[f32]", case, errs[0][1], errs[1][1],
                 "variance's largest relative error")
            st = tops.bn_stats_plain(x, torch.empty(tiles, 2, k,
                                                    device="cuda"))
            bn = torch.stack([torch.rand(k, generator=gen) + 0.5,
                              torch.randn(k, generator=gen) * 0.3]).cuda()
            d_a = torch.randn(m, k, generator=gen).cuda()
            rstd = torch.rsqrt(st[:, 1].double() + 1e-5)
            xh = (xt - st[:, 0, None].double()) * rstd[:, None]
            da = d_a.double().view(tiles, -1, k)
            sg, sb = (da * xh).sum(1, keepdim=True), da.sum(1, keepdim=True)
            dx64 = (rstd[:, None] * bn[0].double() * (
                da - sb / xt.shape[1] - xh * (sg / xt.shape[1]))).view(m, k)
            dbn64 = torch.cat([sg, sb], 1).sum(0)
            errs = []
            for fn in (tops.bn_bwd, tops.bn_bwd_plain):
                d_x, dbn = (torch.empty(m, k, device="cuda"),
                            torch.empty(2, k, device="cuda"))
                fn(x, d_a, st, bn, 1e-5, d_x, dbn)
                errs.append((((dbn.double() - dbn64).abs().max(1).values
                              / dbn64.abs().max(1).values).max().item(),
                             ((d_x.double() - dx64).abs().max()
                              / dx64.abs().max()).item()))
            note("bn_bwd[f32]", case, errs[0][0], errs[1][0],
                 "dbn's largest error over its largest value")
            note("bn_bwd[f32]", case, errs[0][1], errs[1][1],
                 "d_x's largest error over its largest value", held=False)
        feats = [buf[:, :128], buf[:, 128:k]]
        var64 = x64.var(0, unbiased=False)
        errs = []
        for fn in (tbk.stats, tbk.stats_plain):
            sums = fn(feats, torch.empty(2, k, device="cuda")).double()
            var = sums[1] / m - (sums[0] / m) ** 2
            errs.append(((var - var64) / var64).abs().max().item())
        note("train_bottleneck.stats[f32]", f"K=128+64 r=64, x ~ {name}",
             errs[0], errs[1], "variance's largest relative error")
        del buf, x, x64, d_a
    for row in out:
        bad = [c[:3] for c in out[row] if c[3] and not c[1] <= c[2]]
        require(not bad or not strict, f"{row}: farther from float64 than "
                                       f"its plain version: {bad}")
    return out


def slot_f32_exact_checks(torch, tops, bops, o, gen):
    """At the operands ``o`` of r=64, tile 2, under one-hot operands (a
    weight or cotangent with one 1 a column in distinct rows) each product
    form bit for bit an exact reference: the 1x1 forms their plain
    versions (one product a sum), the conv forms the im2col gather of the
    same prologue, gate and flipped weight. Then one bf16 pass of the
    cotangent (the plain versions on dy rounded to bf16) against the
    float32 dy, which must break each input gradient's limit; and the two
    weight gradients against float64 products, within the relative L2
    error of one recursive float32 sum over M rows, which that bf16 pass
    must break. Returns {row: exact}."""
    from cunet_tpu_torch.kernels.buf_ops import tile_affine

    n, c, g, cb, r, m = TRAIN_BATCH, 128, 32, 128, o["r"], o["m"]
    plain = {**bops.PLAIN, **tops.PLAIN}

    def empty(*shape):
        return torch.empty(*shape, device="cuda")

    def onehot(k, nout):
        w = torch.zeros(k, nout)
        w[torch.randperm(k, generator=gen)[:nout], torch.arange(nout)] = 1
        return w.cuda()

    w1, w3 = onehot(192, c), onehot(9 * cb, g)
    hot_dy, hot_do = onehot(m, c), onehot(m, g)
    # conv3x3_dx's one-hot weight: each channel in at most one column, so
    # that its transpose is one-hot too (one term an input-gradient sum)
    w3t = torch.zeros(9 * cb, g)
    w3t[torch.randint(0, 9, (g,), generator=gen) * cb
        + torch.randperm(cb, generator=gen)[:g], torch.arange(g)] = 1
    w3t = w3t.cuda()
    z = torch.relu(tile_affine(o["yb"], o["vb"]))
    gate = tile_affine(o["yb"], o["vb"]) > 0
    x2, v2 = o["x2"], o["v2"]
    pairs = {
        "affine_dot[f32,tile]": (
            bops.affine_dot(x2, v2, w1, empty(m, c)),
            plain[bops.affine_dot](x2, v2, w1, empty(m, c))),
        "conv3x3[f32,tile]": (
            bops.conv3x3(o["yb"], w3, n, r, r, empty(m, g), vec=o["vb"]),
            im2col(torch, z, n, r, r) @ w3),
        "affine_dx[f32]": (
            tops.affine_dx(o["dy"], w1, x2, v2, empty(m, 192)),
            plain[tops.affine_dx](o["dy"], w1, x2, v2, empty(m, 192))),
        "affine_dw[f32]": (
            tops.affine_dw(x2, v2, hot_dy, empty(192, c)),
            plain[tops.affine_dw](x2, v2, hot_dy, empty(192, c))),
        "conv3x3_dx[f32]": (
            tops.conv3x3_dx(o["d_o"], w3t, n, r, r, o["yb"], o["vb"],
                            empty(m, cb)),
            torch.where(gate, im2col(torch, o["d_o"], n, r, r)
                        @ tops.flip_w3(w3t), 0.0)),
        "conv3x3_dw[f32]": (
            tops.conv3x3_dw(o["yb"], o["vb"], hot_do, n, r, r,
                            empty(9 * cb, g)),
            im2col(torch, z, n, r, r).t() @ hot_do),
        "maxpool2_bwd[f32]": (
            tops.maxpool2_bwd(o["ahead"], o["d_pool"], n, r, r,
                              empty(m, c)),
            plain[tops.maxpool2_bwd](o["ahead"], o["d_pool"], n, r, r,
                                     empty(m, c))),
    }
    # one ghost tile of all M rows, on the random W: the per-tile form bit
    # for bit the eval pair's form (dot3_kernel), the same sums
    one_tile = (bops.affine_dot(x2, v2[:1], o["w_a"], empty(m, c)),
                bops.affine_dot(x2, v2[0], o["w_a"], empty(m, c)))
    torch.cuda.synchronize()
    same = {k: torch.equal(a, b) for k, (a, b) in pairs.items()}
    print(f"slot f32 kernels under one-hot operands (r=64, tile 2), bit for "
          f"bit an exact reference: {same}", flush=True)
    require(all(same.values()), f"a float32 slot form is not exact under "
                                f"one-hot operands: {same}")
    print(f"slot f32: affine_dot[f32,tile] with one tile bit for bit the "
          f"eval pair's affine_dot[f32] (random W): "
          f"{torch.equal(*one_tile)}", flush=True)
    require(torch.equal(*one_tile), "affine_dot[f32,tile] with one tile "
                                    "differs from the eval pair's form")
    # one bf16 pass of the cotangent: the plain versions on bf16(dy)
    d16, do16 = o["dy"].bfloat16().float(), o["d_o"].bfloat16().float()
    cases = {
        "affine_dx[f32]": (lambda d: plain[tops.affine_dx](
            d, o["w_a"], x2, v2, empty(m, 192)), d16, o["dy"], ("sum", c)),
        "affine_dw[f32]": (lambda d: plain[tops.affine_dw](
            x2, v2, d, empty(192, c)), d16, o["dy"], ("sum", m)),
        "conv3x3_dx[f32]": (lambda d: plain[tops.conv3x3_dx](
            d, o["w3"], n, r, r, o["yb"], o["vb"], empty(m, cb)), do16,
            o["d_o"], ("sum", 9 * g)),
        "conv3x3_dw[f32]": (lambda d: plain[tops.conv3x3_dw](
            o["yb"], o["vb"], d, n, r, r, empty(9 * cb, g)), do16, o["d_o"],
            ("sum", m)),
    }
    shares = {k: output_errors(torch, [fn(d_lo)], [fn(d)], [bnd])[1]
              for k, (fn, d_lo, d, bnd) in cases.items()}
    print(f"slot f32: one bf16 pass of the cotangent (the plain versions on "
          f"bf16(dy)) against float32 dy, r=64: the share of each limit "
          f"{shares} (the input gradients' must exceed 1; a weight "
          f"gradient's M-term limit averages the rounding out)", flush=True)
    require(shares["affine_dx[f32]"] > 1 and shares["conv3x3_dx[f32]"] > 1,
            f"one bf16 pass of dy stays within a dx limit: {shares}")
    # the weight gradients against float64 products of the same z: the
    # M-term limit above lets one bf16 pass of dy through, so each is held
    # to the relative L2 error of one recursive float32 sum over its M rows
    lim = F32_DW_REL * m ** 0.5
    zx, cols = torch.relu(tile_affine(x2, v2)), im2col(torch, z, n, r, r)
    dw = {
        "affine_dw[f32]": (zx, o["dy"], d16, tops.affine_dw, lambda f, d: f(
            x2, v2, d, empty(192, c))),
        "conv3x3_dw[f32]": (cols, o["d_o"], do16, tops.conv3x3_dw,
                            lambda f, d: f(o["yb"], o["vb"], d, n, r, r,
                                           empty(9 * cb, g))),
    }
    rel = {}
    for k, (a, d, d_lo, kern, call) in dw.items():
        ref = a.double().t() @ d.double()
        rel[k] = {name: ((got.double() - ref).norm() / ref.norm()).item()
                  for name, got in (("kernel", call(kern, d)),
                                    ("plain", call(plain[kern], d)),
                                    ("bf16 dy", call(plain[kern], d_lo)))}
    print(f"slot f32: the weight gradients' relative L2 error against "
          f"float64, r=64 (limit {lim:.3g}, one recursive float32 sum over "
          f"M={m} rows): {rel}", flush=True)
    require(all(v["kernel"] <= lim < v["bf16 dy"] for v in rel.values()),
            f"a weight gradient is past its float64 limit, or one bf16 "
            f"pass of dy is within it: {rel}")
    return same


def phase_slot_f32_kernels(torch, tops, bops, tbk):
    """Phase 14 (a): the ten forms against their plain versions at float32
    (TF32 off) at every resolution r = 64 ... 4 and tiles 2 and 6 (a tile
    of 96 rows at r=4 does not divide a 128-row block), each output within
    the float32 n-term limit, and at r=64 a second call bit for bit the
    first; the r=64 tile-2 case of each (upsample2_bwd: r=32) timed beside
    its plain version, its bound, its library call or the product alone,
    and the float32 FMA time of its products; bit for bit under one-hot
    operands, one bf16 pass of dy caught; ``affine_dw[f32]`` and
    ``affine_dx[f32]`` at order 14's intermedia adapter width
    (``wide_dw_check``, ``wide_dx_check``); the sums of ``bn_stats[f32]``,
    ``bn_bwd[f32]`` and #7's ``stats[f32]`` against float64
    (``f32_sums_f64_checks``)."""
    gen = torch.Generator().manual_seed(18)
    plain = {**bops.PLAIN, **tops.PLAIN}
    results = {}
    for tile in SLOT_F32_TILES:
        for r in CONV_RES:
            o = slot_f32_operands(torch, tops, gen, r, tile)
            if r == 64 and tile == BN_TILE:
                exact = slot_f32_exact_checks(torch, tops, bops, o, gen)
            for row, kern, label, call, bounds, w, fma_ms, lib, prod in \
                    slot_f32_cases(torch, tops, bops, o):
                got, want = call(kern), call(plain[kern])
                torch.cuda.synchronize()
                err, share, ok = output_errors(torch, got, want, bounds)
                label = f"{label} tile {tile}"
                require(ok, f"{row} [{label}] disagrees with its plain "
                            f"version: {err} ({share:.3g} of its limit)")
                if r == 64:
                    again = call(kern)
                    torch.cuda.synchronize()
                    require(all(torch.equal(a, b) for a, b in
                                zip(got, again)),
                            f"{row} [{label}]: a second call differs from "
                            f"the first")
                if row in results:
                    results[row]["max_abs_err"] = max(
                        results[row]["max_abs_err"], err)
                    print(f"slot f32 kernel {row}{fwd_note(row, bops)} "
                          f"[{label}]: max_abs_err {err:.4g} ({share:.3g} "
                          f"of its limit)", flush=True)
                    continue
                ms = cuda_time_ms(lambda: call(kern))
                plain_ms = cuda_time_ms(lambda: call(plain[kern]))
                lib_ms = None if lib is None else cuda_time_ms(lib)
                prod_ms = None if prod is None else cuda_time_ms(prod)
                bms, by = bound(w)
                lib = "none" if lib_ms is None else f"{lib_ms * 1e3:.1f} us"
                fma = "" if fma_ms is None else \
                    f", float32 FMA of the products {fma_ms * 1e3:.1f} us"
                print(f"slot f32 kernel {row}{fwd_note(row, bops)} "
                      f"[{label}]: max_abs_err {err:.4g} ({share:.3g} of its "
                      f"float32 limit), "
                      f"{ms * 1e3:.1f} us vs plain {plain_ms * 1e3:.1f} us, "
                      f"bound {bms * 1e3:.1f} us ({by}), library {lib}"
                      f"{product_text(prod_ms)}{fma}", flush=True)
                record(results, row, err, ms, plain_ms, label, w, lib_ms,
                       prod_ms)
    print("slot f32: every r=64 case bit for bit on a second call",
          flush=True)
    wide_dw_check(torch, tops, gen)
    wide_dx_check(torch, tops, gen)
    f32_sums_f64_checks(torch, tops, tbk)
    from cunet_tpu_torch.kernels import train_bottleneck

    wide_fwd_check(torch, train_bottleneck, bops, gen)
    for row in results:
        results[row]["one_hot_exact"] = exact.get(row)
    return results


# order 14's intermedia adapter: c * (1 + order) channels of CU-Net-8
WIDE_DW_K = 128 * 15


def wide_dw_check(torch, tops, gen):
    """``affine_dw[f32]`` at K = ``WIDE_DW_K`` -> 128 (r=64, batch 24, tile
    2) against its plain version within the float32 M-term limit, timed
    beside the plain version, ``torch.mm`` of the product alone and its
    bound."""
    from cunet_tpu_torch.kernels.train_slot import _affine_vec

    m, k, c = TRAIN_BATCH * 64 * 64, WIDE_DW_K, 128
    tiles = TRAIN_BATCH // BN_TILE
    x = torch.randn(m, k, generator=gen).cuda()
    st = tops.bn_stats_plain(x, torch.empty(tiles, 2, k, device="cuda"))
    bn = torch.stack([torch.rand(k, generator=gen) + 0.5,
                      torch.randn(k, generator=gen) * 0.3]).cuda()
    v = _affine_vec(st, bn, 1e-5)
    dy = torch.randn(m, c, generator=gen).cuda()
    out = torch.empty(k, c, device="cuda")

    def call(f):
        return [f(x, v, dy, out.clone())]

    got, want = call(tops.affine_dw), call(tops.affine_dw_plain)
    torch.cuda.synchronize()
    err, share, ok = output_errors(torch, got, want, [("sum", m)])
    label = f"K={k}->{c} r=64 tile {BN_TILE}"
    require(ok, f"affine_dw[f32] [{label}] disagrees with its plain "
                f"version: {err} ({share:.3g} of its limit)")
    ms = cuda_time_ms(lambda: tops.affine_dw(x, v, dy, out))
    plain_ms = cuda_time_ms(lambda: tops.affine_dw_plain(x, v, dy, out),
                            iters=3)
    prod_ms = cuda_time_ms(lambda: torch.mm(x.t(), dy))
    bms, by = bound(work(sz(m, k, e=4) + sz(m, c, e=4) + sz(k, c, e=4)
                         + sz(tiles, 2, k, e=4), 6 * 2 * m * k * c, "bf16"))
    print(f"slot f32 kernel affine_dw[f32] [{label}]: max_abs_err {err:.4g} "
          f"({share:.3g} of its float32 limit), {ms * 1e3:.1f} us vs plain "
          f"{plain_ms * 1e3:.1f} us, bound {bms * 1e3:.1f} us ({by})"
          f"{product_text(prod_ms)}", flush=True)


def wide_dx_check(torch, tops, gen):
    """``affine_dx[f32]`` at K = ``WIDE_DW_K`` <- 128 (order 14's intermedia
    adapter, r=64, batch 24, tile 2) and at K = 192 <- 320 and 512 (a
    cotangent past the 256 whose W planes a block keeps resident: W staged
    a slice at a time) against its plain version within the float32
    n-term limit, timed beside the plain version, ``torch.mm`` of the
    product alone and its bound."""
    for k, c in ((WIDE_DW_K, 128), (192, 320), (192, 512)):
        _wide_dx_case(torch, tops, gen, k, c)


def _wide_dx_case(torch, tops, gen, k, c):
    from cunet_tpu_torch.kernels.train_slot import _affine_vec

    m = TRAIN_BATCH * 64 * 64
    tiles = TRAIN_BATCH // BN_TILE
    x = torch.randn(m, k, generator=gen).cuda()
    st = tops.bn_stats_plain(x, torch.empty(tiles, 2, k, device="cuda"))
    bn = torch.stack([torch.rand(k, generator=gen) + 0.5,
                      torch.randn(k, generator=gen) * 0.3]).cuda()
    v = _affine_vec(st, bn, 1e-5)
    dy = torch.randn(m, c, generator=gen).cuda()
    w = (torch.randn(k, c, generator=gen) * k ** -0.5).cuda()
    out = torch.empty(m, k, device="cuda")

    def call(f):
        return [f(dy, w, x, v, out.clone())]

    got, want = call(tops.affine_dx), call(tops.affine_dx_plain)
    torch.cuda.synchronize()
    err, share, ok = output_errors(torch, got, want, [("sum", c)])
    label = f"K={k}->{c} r=64 tile {BN_TILE}"
    require(ok, f"affine_dx[f32] [{label}] disagrees with its plain "
                f"version: {err} ({share:.3g} of its limit)")
    ms = cuda_time_ms(lambda: tops.affine_dx(dy, w, x, v, out))
    plain_ms = cuda_time_ms(lambda: tops.affine_dx_plain(dy, w, x, v, out),
                            iters=3)
    prod_ms = cuda_time_ms(lambda: torch.mm(dy, w.t()))
    bms, by = bound(work(sz(m, c, e=4) + 2 * sz(m, k, e=4) + sz(k, c, e=4)
                         + sz(tiles, 2, k, e=4), 6 * 2 * m * k * c, "bf16"))
    print(f"slot f32 kernel affine_dx[f32] [{label}]: max_abs_err {err:.4g} "
          f"({share:.3g} of its float32 limit), {ms * 1e3:.1f} us vs plain "
          f"{plain_ms * 1e3:.1f} us, bound {bms * 1e3:.1f} us ({by})"
          f"{product_text(prod_ms)}", flush=True)


# order 14's widest #7 call: 17 feature groups, Ctot = 1,920; and a head
# past 128 columns (two column blocks, the second 8 wide)
WIDE_FWD_WIDTHS = (128,) * 13 + (64,) * 4
WIDE_FWD_N = 136


def wide_fwd_check(torch, tbk, bops, gen):
    """The float32 forward 1x1 at K = 1,920 -> ``WIDE_FWD_N`` (r=64, batch
    24): ``apply[f32]`` over ``WIDE_FWD_WIDTHS`` (17 groups: the table in
    device memory) and ``affine_dot[f32,tile]`` on their concat at tile 2,
    each against its plain version within the float32 K-term limit, timed
    beside the plain version, ``torch.mm`` of the product alone and its
    bound (W streamed by slices: its planes do not fit beside the x
    buffers)."""
    from cunet_tpu_torch.kernels.train_slot import _affine_vec

    m, n = TRAIN_BATCH * 64 * 64, WIDE_FWD_N
    k = sum(WIDE_FWD_WIDTHS)
    tiles = TRAIN_BATCH // BN_TILE
    buf = torch.randn(m, k + 32, generator=gen).cuda()
    feats = [buf[:, a:a + c] for a, c in zip(
        np.cumsum((0,) + WIDE_FWD_WIDTHS[:-1]), WIDE_FWD_WIDTHS)]
    x = buf[:, :k]
    vec = torch.stack([torch.rand(k, generator=gen) + 0.5,
                       torch.randn(k, generator=gen) * 0.3]).cuda()
    st = torch.stack([x.reshape(tiles, -1, k).mean(1),
                      x.reshape(tiles, -1, k).var(1, unbiased=False)], 1)
    v = _affine_vec(st.contiguous(), vec, 1e-5)
    w = (torch.randn(k, n, generator=gen) * k ** -0.5).cuda()
    cases = (("train_bottleneck.apply[f32]", tbk.apply, tbk.apply_plain,
              lambda f, o: f(feats, vec, w, o), "17 groups"),
             ("affine_dot[f32,tile]", bops.affine_dot,
              bops.affine_dot_plain, lambda f, o: f(x, v, w, o),
              f"tile {BN_TILE}"))
    nbytes = sz(m, k, e=4) + sz(k, n, e=4) + sz(m, n, e=4)
    for row, kern, plain, call, what in cases:
        out = torch.empty(m, n, device="cuda")
        got, want = [call(kern, out.clone())], [call(plain, out.clone())]
        torch.cuda.synchronize()
        err, share, ok = output_errors(torch, got, want, [("sum", k)])
        label = f"K={k}->{n} r=64 {what}"
        require(ok, f"{row} [{label}] disagrees with its plain version: "
                    f"{err} ({share:.3g} of its limit)")
        ms = cuda_time_ms(lambda: call(kern, out))
        plain_ms = cuda_time_ms(lambda: call(plain, out), iters=3)
        prod_ms = cuda_time_ms(lambda: torch.mm(x, w))
        bms, by = bound(work(nbytes + sz(2, k, e=4) * (tiles if "tile" in
                                                       what else 1),
                             6 * 2 * m * k * n, "bf16"))
        print(f"wide f32 kernel {row}{fwd_note(row, bops)} [{label}]: "
              f"max_abs_err {err:.4g} ({share:.3g} of its float32 limit), "
              f"{ms * 1e3:.1f} us vs plain {plain_ms * 1e3:.1f} us, bound "
              f"{bms * 1e3:.1f} us ({by}){product_text(prod_ms)}",
              flush=True)
        del got, want, out


def bytes_digest(torch, ts):
    """sha256 (16 hex digits) of the bytes of the tensors ``ts``: two
    checkouts whose digests of the same operands agree give them bit for
    bit."""
    import hashlib

    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


# the float32 GEMMs of #7 and their products (f32_fma_ms)
TB_F32_PRODUCTS = {"apply": 1, "bwd_reduce": 2, "bwd_dx": 1}


def row_times(torch, pattern, tops, bops, tbk, eops=None):
    """``tools/kernel_times.py --rows PATTERN``: the kernel rows of phases
    9 (a), 13 (a), 14 (a) and 15 (a) (and with ``eops`` 12 (a)'s float32
    eval forms at batch 8, r = 64 ... 4) whose names match the regular
    expression ``pattern`` (``re.search``), from the phases' own case
    lists: #7's kernels at bf16 and their float32 forms at r = 64 ... 4
    (``tb_cases``, rows ``train_bottleneck.<name>`` and
    ``train_bottleneck.<name>[f32]``; ``bwd_dx[f32]`` on the planes the
    backward hands it, its time called alone beside), the ten slot forms
    and the QuanInput forms at float32 at r = 64 ... 4 and tiles 2 and 6
    (``slot_f32_cases``, ``quant_f32_cases``). Each against its plain
    version, timed (CUDA-graph replay) beside its library call or product
    alone, its bound and, for the products, their float32 FMA time; then
    the wide checks of the rows that match (``wide_reduce_check`` and
    ``tb_f32_dw_f64_checks`` for ``bwd_reduce[f32]``,
    ``wide_bwd_dx_check``, ``wide_dw_check``, ``wide_dx_check``; printed,
    not required, so a checkout that fails one still gives its times), and
    a digest of each matching #7 row's outputs at each r and of the other
    rows' at r=64 (two checkouts whose digests agree give them bit for
    bit)."""
    import re

    rx = re.compile(pattern)
    outs = {}

    def run(row, label, kern, plain, call, bounds, w, lib, prod, fma_ms,
            extra=lambda: ""):
        got, want = call(kern), call(plain)
        torch.cuda.synchronize()
        err, share, ok = output_errors(torch, got, want, bounds)
        require(ok, f"{row} [{label}] disagrees with its plain version: "
                    f"{err} ({share:.3g} of its limit)")
        ms = cuda_time_ms(lambda: call(kern))
        bms, by = bound(w)
        text = "".join(f", {name} {cuda_time_ms(fn) * 1e3:.1f} us"
                       for name, fn in (("library", lib), ("product", prod))
                       if fn is not None)
        if fma_ms is not None:
            text += f", float32 FMA {fma_ms * 1e3:.1f} us"
        print(f"row time {row}{fwd_note(row, bops)} [{label}]: max_abs_err "
              f"{err:.4g} ({share:.3g} of its limit), {ms * 1e3:.1f} us, "
              f"bound {bms * 1e3:.1f} us ({by}){text}{extra()}", flush=True)
        return got

    # #7 at bf16 (phase 9's operands) and at float32 (phase 13's)
    for tag, dt, seed in (("", torch.bfloat16, 9), ("[f32]", torch.float32,
                                                    13)):
        if not any(rx.search(f"train_bottleneck.{k.__name__}{tag}")
                   for k in tbk.KERNELS):
            continue
        gen = torch.Generator().manual_seed(seed)
        for r in CONV_RES:
            o = tb_operands(torch, gen, r, dtype=dt)
            for name, call, bounds, w, lib, prod in tb_cases(torch, o):
                row = f"train_bottleneck.{name}{tag}"
                if not rx.search(row):
                    continue
                kern = getattr(tbk, name)
                fma = TB_F32_PRODUCTS.get(name) if tag else None
                got = run(row, f"r={r}", kern, tbk.PLAIN[kern], call, bounds,
                          w, lib, prod,
                          None if fma is None else f32_fma_ms(o, fma),
                          lambda: dx_alone_text(torch, tbk, o)
                          if name == "bwd_dx" else "")
                outs[f"{row} r={r}"] = got
            del o
    gen = torch.Generator().manual_seed(18)
    plain = {**bops.PLAIN, **tops.PLAIN}
    slot_rows = any(rx.search(row) for row in (*SLOT_F32, *QUANT_F32))
    for tile in SLOT_F32_TILES if slot_rows else ():
        for r in CONV_RES:
            o = slot_f32_operands(torch, tops, gen, r, tile)
            cases = [c[:6] + (c[7], c[8], c[6])
                     for c in slot_f32_cases(torch, tops, bops, o)]
            cases += [c + (None,) for c in quant_f32_cases(torch, tops, bops,
                                                           o)]
            for row, kern, label, call, bounds, w, lib, prod, fma in cases:
                if not rx.search(row):
                    continue
                got = run(row, f"{label} tile {tile}", kern, plain[kern],
                          call, bounds, w, lib, prod, fma)
                if r == 64:
                    outs.setdefault(row, []).extend(got)
    # the int8 whole-model kernels and their float32 forms (phase 6's and
    # phase 15 (a)'s cases), bit for bit their plain versions
    from cunet_tpu_torch.kernels import quant_ops as qops

    for tag, seed in (("", 3), ("[f32]", 33)):
        gen6 = torch.Generator().manual_seed(seed)
        if not any(rx.search(f"{k.__name__}{tag}") for k in qops.F32_FORMS):
            continue
        for name, label, dst, sel, call, w in int8_kernel_cases(
                torch, gen6, bool(tag)):
            row, kern = f"{name}{tag}", getattr(qops, name)
            if kern not in qops.F32_FORMS or not rx.search(row):
                continue
            k_buf, p_buf = dst.clone(), dst.clone()
            call(kern, k_buf)
            call(qops.PLAIN[kern], p_buf)
            torch.cuda.synchronize()
            got, want = sel(k_buf), sel(p_buf)
            require(torch.equal(got, want), f"{row} [{label}] differs from "
                                            f"its plain version")
            ms = cuda_time_ms(lambda: call(kern, k_buf))
            bms, by = bound(w)
            print(f"row time {row} [{label}]: bit for bit its plain version, "
                  f"{ms * 1e3:.1f} us, bound {bms * 1e3:.1f} us ({by})",
                  flush=True)
            if " r=64" in label and "batch" not in label:
                outs.setdefault(row, []).append(got.clone())
            del k_buf, p_buf, got, want
    # phase 12 (a)'s float32 eval forms (batch 8)
    if eops is not None and hasattr(bops, "dot3_plan"):
        gen12 = torch.Generator().manual_seed(12)
        for (row, label, kern, plain_of, make_out, call, bnd, w, fma, lib,
             prod) in f32_kernel_cases(torch, bops, eops, gen12, BATCH,
                                       CONV_RES):
            if not rx.search(row):
                continue

            def call1(f, make_out=make_out, call=call):
                o = make_out()
                call(f, o)
                return [o]

            got = run(row, label, kern, plain_of[kern], call1, [bnd], w,
                      lib, prod, fma)
            if " r=64 " in f" {label} ":
                outs.setdefault(row, []).extend(got)
    wide = (("train_bottleneck.bwd_reduce[f32]", lambda: (
                 wide_reduce_check(torch, tbk, torch.Generator()
                                   .manual_seed(15)),
                 tb_f32_dw_f64_checks(torch, tbk, torch.Generator()
                                      .manual_seed(15), strict=False))),
            ("train_bottleneck.bwd_dx[f32]", lambda: wide_bwd_dx_check(
                torch, tbk, torch.Generator().manual_seed(16),
                strict=False)),
            ("train_bottleneck.bwd_reduce[f32]|train_bottleneck.bwd_dx[f32]",
             lambda: wide_out_check(torch, tbk, torch.Generator()
                                    .manual_seed(17), torch.float32,
                                    strict=False)),
            ("train_bottleneck.bwd_reduce|train_bottleneck.bwd_dx",
             lambda: wide_out_check(torch, tbk, torch.Generator()
                                    .manual_seed(17), torch.bfloat16,
                                    strict=False)),
            ("affine_dw[f32]", lambda: wide_dw_check(torch, tops, gen)),
            ("affine_dx[f32]", lambda: wide_dx_check(torch, tops, gen)),
            ("affine_dot[f32,tile]|train_bottleneck.apply[f32]",
             lambda: wide_fwd_check(torch, tbk, bops, gen)))
    for rows, check in wide:
        if any(rx.search(row) for row in rows.split("|")):
            check()
    if any(rx.search(row) for row in SUMS_KERNELS):
        f32_sums_f64_checks(torch, tops, tbk, strict=False)
    print(f"row times: output digests of the rows matching {pattern!r} (#7 "
          f"at each r, the others at r=64): " + str(
              {row: bytes_digest(torch, ts) for row, ts in outs.items()}),
          flush=True)


def slot_f32_counts(tops, bops) -> dict:
    """Launches of the ten forms' float32 kernels, keyed by their rows."""
    counts = {**tops.f32_counts(), **bops.f32_counts()}
    return {row: counts[f"{name}[f32]"] for row, (name, _) in SLOT_F32.items()}


# the float32 train convs' wgmma kernel (csrc/conv_f32_kernels.cu): its
# row, the TPU functions its two forms replace
CONV_WG = "conv3x3[f32,wgmma]"
REPLACES[CONV_WG] = REPLACES["conv3x3[f32,tile]"]
CONV_WG_ALSO = REPLACES["conv3x3_dx[f32]"]


def conv_wg_counts(tops, bops) -> dict:
    """Launches of the wgmma conv kernel by both its forms (the forward's
    and the dx's), keyed by its row; none where the checkout has no such
    kernel."""
    if not hasattr(bops, "wg_counts"):
        return {}
    return {CONV_WG: bops.wg_counts()["conv3x3"]
            + tops.wg_counts()["conv3x3_dx"]}


def slot_plain_swapped():
    """The ten forms' plain versions swapped into the slot train path
    (``kernels/train_slot.py`` calls them by name): the swap step."""
    from cunet_tpu_torch.kernels import train_slot
    from cunet_tpu_torch.tools.f32_step_gap import patched, slot_swap

    return patched(train_slot, **slot_swap())


def phase_slot_f32_training(torch, tops, bops, dops, gpu, bf16_times):
    """Phase 14 (b)-(d): CU-Net-8 @256 at float32 (bn_dtype "float32", the
    reference's torch semantics), ghost-BN tile 6, use_pallas, on the ten
    forms: the kernel step against the swap step within max(2c, 1e-5), c
    the largest of F32_STEP_PERMS tile-preserving permuted controls, the
    plain path beside both; a bit-identical repeat; dropout 0.2 through
    the float32 mask kernel bit for bit the plain mask's step; three
    main-path ``train_step``s (every form launched), one dropout step and
    three steps at tile 2; step times and peak memory of both paths at
    both tiles beside phase 5's bf16 step. Returns ({row: launches of the
    main path's drive}, launches per step)."""
    import types

    from cunet_tpu_torch import TrainConfig
    from cunet_tpu_torch.kernels import train_slot
    from cunet_tpu_torch.train import create_train_state, train_step

    cfg, params, state, batch = flagship_train(torch)
    cfg = dataclasses.replace(cfg, compute_dtype="float32",
                              bn_dtype="float32", bn_tile=SLOT_F32_TILE)
    x, t = batch["image"], batch["heatmap"]
    forms = types.SimpleNamespace(
        reset_launch_counts=lambda: (tops.reset_launch_counts(),
                                     bops.reset_launch_counts()),
        launch_counts=lambda: {**slot_f32_counts(tops, bops),
                               **conv_wg_counts(tops, bops)})
    f32_drop = mask_counter(dops.drop_mask, f32=True)
    label = f"slot f32 training (tile {SLOT_F32_TILE})"
    perms = [tile_perm(torch, TRAIN_BATCH, SLOT_F32_TILE, torch.Generator()
                       .manual_seed(17 + i)).cuda()
             for i in range(F32_STEP_PERMS)]
    drop_cfg = dataclasses.replace(cfg, drop_rate=DROP_RATE)
    torch.backends.cudnn.deterministic = True
    try:
        f32_step_check(torch, label, cfg, params, state, x, t,
                       slot_plain_swapped, forms, perms)
        bn0_dropout(torch, drop_cfg, params, state, x, t, dops,
                    label=f"slot f32 dropout training (tile "
                          f"{SLOT_F32_TILE})", where=train_slot)
    finally:
        torch.backends.cudnn.deterministic = False

    # the main path: three steps at tile 6; a dropout step; tile 2
    tcfg = TrainConfig(lr=2.5e-4, batch_size=TRAIN_BATCH)
    st = create_train_state(params, state, tcfg)
    launches = main_path_steps(
        torch, label, lambda: train_step(st, batch, cfg=cfg)[1],
        lambda: st.params, (forms,))
    st_d = create_train_state(params, state, tcfg)
    gen = torch.Generator().manual_seed(6)
    drop_launches = one_step(
        torch, f"slot f32 dropout training (tile {SLOT_F32_TILE})",
        lambda: train_step(st_d, batch, cfg=drop_cfg, generator=gen)[1],
        (forms, f32_drop))
    del st_d
    cfg2 = dataclasses.replace(cfg, bn_tile=BN_TILE)
    st2 = create_train_state(params, state, tcfg)
    main_path_steps(torch, f"slot f32 training (tile {BN_TILE})",
                    lambda: train_step(st2, batch, cfg=cfg2)[1],
                    lambda: st2.params, (forms,))

    # (d) step times and peak memory, kernel path then plain path
    times = {}
    for tile, c, s in ((SLOT_F32_TILE, cfg, st), (BN_TILE, cfg2, st2)):
        st_p = create_train_state(params, state, tcfg)
        plain_cfg = dataclasses.replace(c, use_pallas=False)
        times[tile] = report_times(
            torch, f"slot f32 training (tile {tile})",
            lambda c=c, s=s: train_step(s, batch, cfg=c),
            lambda st_p=st_p, plain_cfg=plain_cfg: train_step(
                st_p, batch, cfg=plain_cfg), gpu)
        del st_p
    print(f"slot training, float32 against bf16 (phase 5, tile {BN_TILE}, "
          f"this run), batch {TRAIN_BATCH}: " + "; ".join(
              f"{path} path: float32 tile {SLOT_F32_TILE} "
              f"{times[SLOT_F32_TILE][path][0]:.3f} ms, "
              f"{times[SLOT_F32_TILE][path][1] / 2 ** 30:.2f} GiB; float32 "
              f"tile {BN_TILE} {times[BN_TILE][path][0]:.3f} ms, "
              f"{times[BN_TILE][path][1] / 2 ** 30:.2f} GiB; bf16 "
              f"{bf16_times[path][0]:.3f} ms, "
              f"{bf16_times[path][1] / 2 ** 30:.2f} GiB"
              for path in ("kernel", "plain")) + f" ({gpu})", flush=True)
    print(f"slot f32 training: the dropout step launched drop_mask[f32] "
          f"{drop_launches['drop_mask[f32]']} times", flush=True)
    return launches, {k: v / 3 for k, v in launches.items()}


# ---------------------------------------------------------------------------
# phase 15: the quantized model at float32 (the QuanInput forms of #8/#9,
# the int8 forms of #1), and feature tables of more than 16 groups
# ---------------------------------------------------------------------------

QUANT_BITS = 8       # W1/I8/G8's bits_i
# the kernels line's rows of the six QuanInput forms at float32: (wrapper,
# TPU function it replaces), at the quantized step's shapes: the head's
# 1x1 forms (128 -> 16) and the 3x3 conv's (Cb=128 -> 32)
QUANT_F32 = {
    "affine_dot[f32,bits_i]": ("affine_dot",
                               "cunet_tpu/kernels/train_slot.py:356"),
    "conv3x3[f32,bits_i]": ("conv3x3", "cunet_tpu/kernels/train_slot.py:294"),
    "affine_dx[f32,ste]": ("affine_dx", "cunet_tpu/kernels/train_slot.py:600"),
    "affine_dw[f32,bits_i]": ("affine_dw",
                              "cunet_tpu/kernels/train_slot.py:597"),
    "conv3x3_dx[f32,ste]": ("conv3x3_dx",
                            "cunet_tpu/kernels/train_slot.py:959"),
    "conv3x3_dw[f32,bits_i]": ("conv3x3_dw",
                               "cunet_tpu/kernels/train_slot.py:901"),
}
REPLACES.update({k: v[1] for k, v in QUANT_F32.items()})
REPLACES.update({"affine_dot_i8[f32]": REPLACES["affine_dot_i8"],
                 "conv3x3_i8[f32]": REPLACES["conv3x3_i8"],
                 "table_dot[groups>16]": REPLACES["table_dot"],
                 "table_dot[f32,groups>16]": REPLACES["table_dot"]})
# the most feature groups a launch carries in its parameters; an up block's
# adapter reads order + 3, so order 14 gives 17
MANY_ORDER = 14


def quant_f32_cases(torch, tops, bops, o):
    """(row, kernel, label, call(fn) -> outputs, bounds, work, library
    call, product alone) of the six QuanInput forms at float32 at the
    operands ``o`` (``slot_f32_operands``): the quantized head's forward,
    its STE-gated dx and its dW on the quantized z (128 -> 16), and the
    same three of the 3x3 conv (Cb=128 -> 32), bits_i 8. Bounds: the
    float32 n-term sum (the codes themselves are the plain version's bit
    for bit, ``quant_f32_exact_checks``). No PyTorch call computes a
    quantized or STE-gated function: ``torch.mm`` / ``F.conv2d`` /
    ``conv2d_input`` / ``conv2d_weight`` of the float32 product alone
    (TF32 off) stands beside each."""
    import torch.nn.functional as F

    n, c, g, cb, cls = TRAIN_BATCH, 128, 32, 128, 16
    m, r, tiles = o["m"], o["r"], o["tiles"]
    yb, vb, q = o["yb"], o["vb"], QUANT_BITS
    w_oihw = o["w3"].view(3, 3, cb, g).permute(3, 2, 0, 1).contiguous()
    vecb = sz(tiles, 2, cb, e=4)
    head = 6 * 2 * m * c * cls
    conv = 6 * 2 * m * 9 * cb * g

    def empty(*shape):
        return torch.empty(*shape, device="cuda")

    return [
        ("affine_dot[f32,bits_i]", bops.affine_dot, f"head 128->16 r={r}",
         lambda f: [f(yb, vb, o["w_h"], empty(m, cls), bits_i=q)],
         [("sum", c)],
         work(sz(m, c, e=4) + vecb + sz(c, cls, e=4) + sz(m, cls, e=4),
              head // 2, "bf16"), None,
         lambda: torch.mm(yb, o["w_h"])),
        ("conv3x3[f32,bits_i]", bops.conv3x3, f"Cb=128->32 r={r}",
         lambda f: [f(yb, o["w3"], n, r, r, empty(m, 224)[:, 192:224],
                      vec=vb, bits_i=q)], [("sum", 9 * cb)],
         work(sz(m, cb, e=4) + sz(9 * cb, g, e=4) + sz(m, g, e=4) + vecb,
              conv // 2, "bf16"), None,
         lambda: F.conv2d(nchw(yb, r), w_oihw, padding=1)),
        ("affine_dx[f32,ste]", tops.affine_dx, f"head 128->16 r={r}",
         lambda f: [f(o["d_head"], o["w_h"], yb, vb, empty(m, c),
                      ste=True)], [("sum", cls)],
         work(sz(m, cls, e=4) + sz(c, cls, e=4) + 2 * sz(m, c, e=4) + vecb,
              head, "bf16"), None,
         lambda: torch.mm(o["d_head"], o["w_h"].t())),
        ("affine_dw[f32,bits_i]", tops.affine_dw, f"head 128->16 r={r}",
         lambda f: [f(yb, vb, o["d_head"], empty(c, cls), bits_i=q)],
         [("sum", m)],
         work(sz(m, c, e=4) + sz(m, cls, e=4) + sz(c, cls, e=4) + vecb,
              head // 2, "bf16"), None,
         lambda: torch.mm(yb.t(), o["d_head"])),
        ("conv3x3_dx[f32,ste]", tops.conv3x3_dx, f"32->128 r={r}",
         lambda f: [f(o["d_o"], o["w3"], n, r, r, yb, vb, empty(m, cb),
                      ste=True)], [("sum", 9 * g)],
         work(sz(m, g, e=4) + sz(9 * cb, g, e=4) + 2 * sz(m, cb, e=4)
              + vecb, conv, "bf16"), None,
         lambda: torch.nn.grad.conv2d_input((n, cb, r, r), w_oihw,
                                            nchw(o["d_o"], r), padding=1)),
        ("conv3x3_dw[f32,bits_i]", tops.conv3x3_dw, f"(9*128, 32) r={r}",
         lambda f: [f(yb, vb, o["d_o"], n, r, r, empty(9 * cb, g),
                      bits_i=q)], [("sum", m)],
         work(sz(m, cb, e=4) + sz(m, g, e=4) + sz(9 * cb, g, e=4) + vecb,
              conv // 2, "bf16"), None,
         lambda: torch.nn.grad.conv2d_weight(nchw(yb, r), (g, cb, 3, 3),
                                             nchw(o["d_o"], r), padding=1)),
    ]


def quant_f32_exact_checks(torch, tops, bops, o, gen):
    """At the operands ``o`` of r=64, tile 2, the six QuanInput forms at
    float32 under one-hot operands, each bit for bit an exact reference
    built from the plain quantizer (``quantize_act`` of the unrounded
    float32 activation) and the plain STE gate (0 < z < 1): the 1x1 forms
    their plain versions, the conv forms an im2col gather. A bf16
    rounding of the activation before the quantizer (what the bf16 forms
    do) must change some codes. Then one bf16 pass of the cotangent must
    break each dx form's float32 limit, and the dW forms must lie within
    F32_DW_REL sqrt(M) relative L2 of float64 products of the quantized z,
    where that bf16 pass must not. Returns {row: exact}."""
    from cunet_tpu_torch.kernels.buf_ops import quantize_act, tile_affine

    n, c, g, cb, cls, r, m = TRAIN_BATCH, 128, 32, 128, 16, o["r"], o["m"]
    q = QUANT_BITS
    plain = {**bops.PLAIN, **tops.PLAIN}
    yb, vb = o["yb"], o["vb"]

    def empty(*shape):
        return torch.empty(*shape, device="cuda")

    def onehot(k, nout):
        w = torch.zeros(k, nout)
        w[torch.randperm(k, generator=gen)[:nout], torch.arange(nout)] = 1
        return w.cuda()

    wh, w3 = onehot(c, cls), onehot(9 * cb, g)
    hot_h, hot_o = onehot(m, cls), onehot(m, g)
    w3t = torch.zeros(9 * cb, g)
    w3t[torch.randint(0, 9, (g,), generator=gen) * cb
        + torch.randperm(cb, generator=gen)[:g], torch.arange(g)] = 1
    w3t = w3t.cuda()
    a = tile_affine(yb, vb)
    zq = quantize_act(torch.relu(a), q)
    ste = (a > 0) & (a < 1)
    rounded = quantize_act(torch.relu(a).bfloat16().float(), q)
    flips = int((rounded != zq).sum())
    pairs = {
        "affine_dot[f32,bits_i]": (
            bops.affine_dot(yb, vb, wh, empty(m, cls), bits_i=q),
            plain[bops.affine_dot](yb, vb, wh, empty(m, cls), bits_i=q)),
        "conv3x3[f32,bits_i]": (
            bops.conv3x3(yb, w3, n, r, r, empty(m, g), vec=vb, bits_i=q),
            im2col(torch, zq, n, r, r) @ w3),
        "affine_dx[f32,ste]": (
            tops.affine_dx(o["d_head"], wh, yb, vb, empty(m, c), ste=True),
            plain[tops.affine_dx](o["d_head"], wh, yb, vb, empty(m, c),
                                  ste=True)),
        "affine_dw[f32,bits_i]": (
            tops.affine_dw(yb, vb, hot_h, empty(c, cls), bits_i=q),
            plain[tops.affine_dw](yb, vb, hot_h, empty(c, cls), bits_i=q)),
        "conv3x3_dx[f32,ste]": (
            tops.conv3x3_dx(o["d_o"], w3t, n, r, r, yb, vb, empty(m, cb),
                            ste=True),
            torch.where(ste, im2col(torch, o["d_o"], n, r, r)
                        @ tops.flip_w3(w3t), 0.0)),
        "conv3x3_dw[f32,bits_i]": (
            tops.conv3x3_dw(yb, vb, hot_o, n, r, r, empty(9 * cb, g),
                            bits_i=q),
            im2col(torch, zq, n, r, r).t() @ hot_o),
    }
    torch.cuda.synchronize()
    same = {k: torch.equal(x, y) for k, (x, y) in pairs.items()}
    print(f"quant f32 kernels under one-hot operands (r=64, tile 2, bits_i "
          f"{q}), bit for bit an exact reference: {same}; the STE gate "
          f"passes {ste.float().mean().item():.4f} of z; a bf16 rounding "
          f"before the quantizer would change {flips} of {zq.numel()} "
          f"codes", flush=True)
    require(all(same.values()), f"a QuanInput form at float32 is not exact "
                                f"under one-hot operands: {same}")
    require(flips > 0 and 0.05 < ste.float().mean().item() < 0.95,
            "the quantized operands do not tell the forms apart")
    d16, do16 = o["d_head"].bfloat16().float(), o["d_o"].bfloat16().float()
    dx = {
        "affine_dx[f32,ste]": (lambda d: plain[tops.affine_dx](
            d, o["w_h"], yb, vb, empty(m, c), ste=True), d16, o["d_head"],
            ("sum", cls)),
        "conv3x3_dx[f32,ste]": (lambda d: plain[tops.conv3x3_dx](
            d, o["w3"], n, r, r, yb, vb, empty(m, cb), ste=True), do16,
            o["d_o"], ("sum", 9 * g)),
    }
    shares = {k: output_errors(torch, [fn(d_lo)], [fn(d)], [bnd])[1]
              for k, (fn, d_lo, d, bnd) in dx.items()}
    print(f"quant f32: one bf16 pass of the cotangent against float32 dy, "
          f"r=64: the share of each dx limit {shares} (must exceed 1)",
          flush=True)
    require(all(v > 1 for v in shares.values()),
            f"one bf16 pass of dy stays within a dx limit: {shares}")
    lim = F32_DW_REL * m ** 0.5
    dw = {
        "affine_dw[f32,bits_i]": (zq, o["d_head"], d16, tops.affine_dw,
                                  lambda f, d: f(yb, vb, d, empty(c, cls),
                                                 bits_i=q)),
        "conv3x3_dw[f32,bits_i]": (im2col(torch, zq, n, r, r), o["d_o"],
                                   do16, tops.conv3x3_dw,
                                   lambda f, d: f(yb, vb, d, n, r, r,
                                                  empty(9 * cb, g),
                                                  bits_i=q)),
    }
    rel = {}
    for k, (z, d, d_lo, kern, call) in dw.items():
        ref = z.double().t() @ d.double()
        rel[k] = {name: ((got.double() - ref).norm() / ref.norm()).item()
                  for name, got in (("kernel", call(kern, d)),
                                    ("plain", call(plain[kern], d)),
                                    ("bf16 dy", call(plain[kern], d_lo)))}
    print(f"quant f32: the weight gradients on the quantized z, relative "
          f"L2 error against float64, r=64 (limit {lim:.3g}): {rel}",
          flush=True)
    require(all(v["kernel"] <= lim < v["bf16 dy"] for v in rel.values()),
            f"a quantized weight gradient is past its float64 limit, or one "
            f"bf16 pass of dy is within it: {rel}")
    return same


def many_group_cases(torch, gen, n, dt):
    """(label, feats, merged, kw, k) of ``table_dot`` over an up block's
    adapter at order MANY_ORDER (CU-Net-8 @256 widths, r=64, batch ``n``):
    17 groups [up_y | skip | 14 FIFO entries | out32], K = 736 -> 128,
    single, dual and with feature 0 read at half resolution (``[up]``);
    ``merged`` the same columns in 16 groups (FIFO entries 0 and 1 as one
    tensor), whose table travels in the launch parameters."""
    c, g, r = 128, 32, 64
    m = n * r * r

    def act(rows, cols):
        return (torch.randn(rows, cols, generator=gen) * 0.5).to("cuda", dt)

    full = [act(m, c), act(m, c)] + [act(m, g) for _ in range(MANY_ORDER)] \
        + [act(m, g)]
    half = [act(m // 4, c)] + full[1:]
    k = sum(f.shape[1] for f in full)

    def merge(fs):
        return fs[:2] + [torch.cat(fs[2:4], 1)] + fs[4:]

    return [("single", full, merge(full), {}, k),
            ("dual", full, merge(full), {"dual": True}, k),
            ("up", half, merge(half), {"up": True, "hw": (r, r)}, k)]


def phase_many_group_kernels(torch, eops, dt):
    """``table_dot`` over 17 feature groups (its table in device memory) at
    ``dt``: against its plain version (bf16 bound, float32 n-term limit)
    and bit for bit the same product over the same columns in 16 groups
    (the table in the launch parameters); timed beside the 16-group launch
    and the plain version at batch 8. Returns {row: result}."""
    import torch.nn.functional as F

    f32 = dt == torch.float32
    row = "table_dot[f32,groups>16]" if f32 else "table_dot[groups>16]"
    gen = torch.Generator().manual_seed(40)
    e = 4 if f32 else 2
    results = {}
    for label, feats, merged, opt, k in many_group_cases(torch, gen, BATCH,
                                                         dt):
        m, n = feats[1].shape[0], 128
        vec = torch.stack([torch.rand(k, generator=gen) + 0.5,
                           torch.randn(k, generator=gen) * 0.5]).cuda()
        w = (torch.randn(k, n, generator=gen) * k ** -0.5).to("cuda", dt)
        kw = {}
        if opt.get("dual"):
            kw = dict(vec_s=vec.flip(1).contiguous(), w_s=w.flip(0)
                      .contiguous())
        if opt.get("up"):
            kw.update(up=(True,) + (False,) * (len(feats) - 1),
                      hw=opt["hw"])

        def call(fn, fs, outs, kw=kw):
            extra = dict(kw)
            if "up" in extra:
                extra["up"] = extra["up"][:len(fs)]
            if len(outs) == 2:
                extra["out_s"] = outs[1]
            fn(fs, vec, w, outs[0], **extra)
            return outs

        def outs():
            return [torch.empty(m, n, device="cuda", dtype=dt)
                    for _ in range(2 if "w_s" in kw else 1)]

        before = eops.table_dot.ext_launches
        got = call(eops.table_dot, feats, outs())
        require(eops.table_dot.ext_launches == before + 1,
                f"{row} [{label}]: the 17-group launch was not counted")
        inline = call(eops.table_dot, merged, outs())
        want = call(eops.table_dot_plain, feats, outs())
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, inline))
        bnd = [("sum", k)] * len(got) if f32 else [("bf16",)] * len(got)
        err, share, ok = output_errors(torch, got, want, bnd)
        ms = cuda_time_ms(lambda: call(eops.table_dot, feats, got))
        ms16 = cuda_time_ms(lambda: call(eops.table_dot, merged, inline))
        plain_ms = cuda_time_ms(lambda: call(eops.table_dot_plain, feats,
                                             want))
        rows_in = m // 4 if opt.get("up") else m
        w_ = work(sz(rows_in, feats[0].shape[1], e=e)
                  + sum(sz(m, f.shape[1], e=e) for f in feats[1:])
                  + len(got) * (sz(k, n, e=e) + sz(2, k, e=4)
                                + sz(m, n, e=e)),
                  len(got) * 2 * m * k * n * (6 if f32 else 1), "bf16")
        x = torch.cat([F.interpolate(nchw(feats[0], 32), scale_factor=2)
                       .permute(0, 2, 3, 1).reshape(m, -1)
                       if opt.get("up") else feats[0]] + feats[1:], 1)
        prod_ms = cuda_time_ms(lambda: torch.mm(x, w))
        print(f"{row} [{label}, 17 groups, K={k}->{n}, r=64, batch "
              f"{BATCH}]: max_abs_err {err:.4g} ({share:.3g} of its limit); "
              f"bit for bit the 16-group table {same}; {ms * 1e3:.1f} us "
              f"(16 groups {ms16 * 1e3:.1f} us) vs plain "
              f"{plain_ms * 1e3:.1f} us, bound {bound(w_)[0] * 1e3:.1f} us "
              f"({bound(w_)[1]}), product alone (torch.mm) "
              f"{prod_ms * 1e3:.1f} us", flush=True)
        require(ok, f"{row} [{label}] disagrees with its plain version: "
                    f"{err} ({share:.3g} of its limit)")
        require(same, f"{row} [{label}] differs from the same product over "
                      f"16 groups")
        if row not in results:
            record(results, row, err, ms, plain_ms, f"{label}, 17 groups",
                   w_, None, prod_ms)
            results[row]["ms_16_groups"] = ms16
        results[row]["max_abs_err"] = max(results[row]["max_abs_err"], err)
    return results


def phase_quant_f32_kernels(torch, tops, bops, qops, eops):
    """Phase 15 (a): the six QuanInput forms at float32 against their plain
    versions at r = 64 and 4, tile 2 (the float32 n-term limit), each timed
    at r=64 beside its bound and the product alone; bit for bit under
    one-hot operands, a bf16 pass of dy caught, dW held to float64; the
    int8 kernels' float32 forms bit for bit their plain versions at
    phase 6's shapes; ``table_dot`` over 17 groups at bf16 and float32.
    Returns {row: result}."""
    gen = torch.Generator().manual_seed(41)
    plain = {**bops.PLAIN, **tops.PLAIN}
    results = {}
    for r in (64, 4):
        o = slot_f32_operands(torch, tops, gen, r, BN_TILE)
        if r == 64:
            exact = quant_f32_exact_checks(torch, tops, bops, o, gen)
        for row, kern, label, call, bounds, w, lib, prod in \
                quant_f32_cases(torch, tops, bops, o):
            before = kern.f32_option_launches
            got, want = call(kern), call(plain[kern])
            torch.cuda.synchronize()
            require(kern.f32_option_launches == before + 1,
                    f"{row} [{label}] did not count its launch")
            err, share, ok = output_errors(torch, got, want, bounds)
            require(ok, f"{row} [{label}] disagrees with its plain version: "
                        f"{err} ({share:.3g} of its limit)")
            if row in results:
                results[row]["max_abs_err"] = max(
                    results[row]["max_abs_err"], err)
                print(f"quant f32 kernel {row} [{label}]: max_abs_err "
                      f"{err:.4g} ({share:.3g} of its limit)", flush=True)
                continue
            ms = cuda_time_ms(lambda: call(kern))
            plain_ms = cuda_time_ms(lambda: call(plain[kern]))
            prod_ms = cuda_time_ms(prod)
            bms, by = bound(w)
            print(f"quant f32 kernel {row} [{label}]: max_abs_err {err:.4g} "
                  f"({share:.3g} of its float32 limit), {ms * 1e3:.1f} us vs "
                  f"plain {plain_ms * 1e3:.1f} us, bound {bms * 1e3:.1f} us "
                  f"({by}), library none, product alone "
                  f"{prod_ms * 1e3:.1f} us", flush=True)
            record(results, row, err, ms, plain_ms, label, w, None, prod_ms)
    for row in QUANT_F32:
        results[row]["one_hot_exact"] = exact[row]
    results.update(phase_int8_kernels(torch, qops, f32=True))
    for dt in (torch.bfloat16, torch.float32):
        results.update(phase_many_group_kernels(torch, eops, dt))
    return results


def quant_f32_counts(tops, bops) -> dict:
    """Launches of the six QuanInput forms at float32, keyed by their
    rows."""
    counts = {**bops.f32_option_counts(), **tops.f32_option_counts()}
    return {row: counts[row] for row in QUANT_F32}


def phase_quant_f32_training(torch, tops, bops, gpu):
    """Phase 15 (b): CU-Net-8 @256 W1/I8/G8 at float32 (bn_dtype
    "float32"), ghost-BN tile 2, use_pallas, through ``quant_train_step``:
    the kernel step (every slot on the float32 forms, the QuanInput ones
    among them) against the swap step (their plain versions swapped in,
    on the kernel step's int8 codes) within max(2c, 1e-5), c the largest of
    F32_STEP_PERMS tile-preserving permuted controls and as many one-ulp
    product controls (against the permutations alone the kernel step lies
    up to 1.40x past 2c: PERF.md section 6); the plain path beside both; a
    bit-identical repeat;
    three main-path ``quant_train_step``s (every form and QuanInput form
    launched); step times and peak memory of both paths. Returns ({row:
    launches of the drive}, launches per step)."""
    import types

    from cunet_tpu_torch import QuantConfig, TrainConfig
    from cunet_tpu_torch.quant import preprocess_masters
    from cunet_tpu_torch.quant import selected_conv_predicate
    from cunet_tpu_torch.train import create_train_state, quant_train_step

    quant = QuantConfig(bits_w=1, bits_i=QUANT_BITS, bits_g=8, enabled=True)
    cfg, params, state, batch = flagship_train(torch)
    cfg = dataclasses.replace(cfg, compute_dtype="float32",
                              bn_dtype="float32", bn_tile=BN_TILE)
    masters = preprocess_masters(params, quant,
                                 selected_conv_predicate(params, "reference"))
    x, t = batch["image"], batch["heatmap"]
    forms = types.SimpleNamespace(
        reset_launch_counts=lambda: (tops.reset_launch_counts(),
                                     bops.reset_launch_counts()),
        launch_counts=lambda: {**slot_f32_counts(tops, bops),
                               **quant_f32_counts(tops, bops)})
    label = f"quant f32 training (W1/I8/G8, tile {BN_TILE})"
    perms = [tile_perm(torch, TRAIN_BATCH, BN_TILE, torch.Generator()
                       .manual_seed(17 + i)).cuda()
             for i in range(F32_STEP_PERMS)]
    torch.backends.cudnn.deterministic = True
    try:
        f32_step_check(torch, label, cfg, masters, state, x, t,
                       slot_plain_swapped, forms, perms, quant=quant,
                       noise=F32_STEP_PERMS)
    finally:
        torch.backends.cudnn.deterministic = False

    tcfg = TrainConfig(lr=2.5e-4, batch_size=TRAIN_BATCH)
    st = create_train_state(params, state, tcfg)
    launches = main_path_steps(
        torch, label,
        lambda: quant_train_step(st, batch, cfg=cfg, qcfg=quant)[1],
        lambda: st.params, (forms,))
    st_p = create_train_state(params, state, tcfg)
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    report_times(torch, label,
                 lambda: quant_train_step(st, batch, cfg=cfg, qcfg=quant),
                 lambda: quant_train_step(st_p, batch, cfg=plain_cfg,
                                          qcfg=quant), gpu)
    return launches, {k: v / 3 for k, v in launches.items()}


@contextlib.contextmanager
def conv_codes(torch, s, record):
    """Append to ``record`` the int8 codes of every 3x3 conv's input of the
    forwards run inside: from ``quan_input`` on the plain and layer-by-layer
    paths (the heads' quantizer left out), from ``conv3x3_i8``'s input on
    the whole-model path; (M, Cb) rows of (image, y, x) either way."""
    from cunet_tpu_torch.kernels import model_buf
    from cunet_tpu_torch.models import cu_net

    quan, head, conv = cu_net.quan_input, cu_net._apply_head, \
        model_buf.conv3x3_i8
    in_head = [False]

    def quan_rec(y, bits):
        out = quan(y, bits)
        if not in_head[0]:
            record.append(torch.round(out.float() * s).to(torch.int8)
                          .reshape(-1, out.shape[-1]))
        return out

    def head_rec(*a, **kw):
        in_head[0] = True
        try:
            return head(*a, **kw)
        finally:
            in_head[0] = False

    def conv_rec(y_i8, *a, **kw):
        record.append(y_i8.clone())
        return conv(y_i8, *a, **kw)

    cu_net.quan_input, cu_net._apply_head = quan_rec, head_rec
    model_buf.conv3x3_i8 = conv_rec
    try:
        yield record
    finally:
        cu_net.quan_input, cu_net._apply_head = quan, head
        model_buf.conv3x3_i8 = conv


@contextlib.contextmanager
def _swapped(module, name, fn):
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


@contextlib.contextmanager
def layer_plain_swapped(torch):
    """The layer-by-layer quantized eval on its kernels' plain versions:
    ``table_dot`` (#6, the down blocks' float adapter pairs and the
    intermedia adapters) and ``int8_matmul_dequant`` (#10, every int8
    bottleneck). That path's reference: JAX runs the adapter pairs float
    there (``cu_net.py::_apply_dual_adapters`` ignores ``quant``), so it
    computes another function than the plain path (``use_pallas`` off),
    whose adapter pairs are int8 products."""
    from cunet_tpu_torch.kernels import bottleneck_infer, eval_ops
    from cunet_tpu_torch.kernels import quant_matmul

    def mm_plain(x, w, cs, xs):
        out = torch.empty(x.shape[0], w.shape[1], device=x.device)
        return quant_matmul.int8_matmul_dequant_plain(x, w, cs, xs, out)

    saved = (bottleneck_infer.table_dot, quant_matmul.int8_matmul_dequant)
    bottleneck_infer.table_dot = eval_ops.table_dot_plain
    quant_matmul.int8_matmul_dequant = mm_plain
    try:
        yield
    finally:
        bottleneck_infer.table_dot, quant_matmul.int8_matmul_dequant = saved


def phase_quant_f32_serving(torch, ops, qops, eops, gpu):
    """Phase 15 (c): the quantized CU-Net-8 @256 (W1/I8/G8, ``int8_infer``,
    ``quant_eval_params`` of the port's init, seed 0) at float32 served
    through ``Predictor`` on the whole-model int8 path (the int8 kernels'
    float32 forms) and on the layer-by-layer path JAX takes for a
    quantized eval (the down blocks' adapter pairs on ``table_dot``'s
    float32 dual form, every bottleneck on ``int8_matmul_dequant``):
    requests of 8 and 5, the kernels counted; each anchor against its
    reference at batch 8 and 64 within relative L2 F32_PATH_REL_L2, or
    where flipped int8 codes set the gap within 2x a same-run control, the
    reference on its input moved by one ulp: for the whole-model path the
    plain path (``use_pallas`` off, ``int8_impl="lax"``), the same
    function; for the layer-by-layer path that path on its kernels' plain
    versions (``layer_plain_swapped``: JAX's dispatch makes it another
    function than the plain path's, whose distance is printed beside); the
    share of the 3x3 convs' int8 codes that differ from the reference's
    (the random-init quantized model is chaotic: a one-ulp move of the
    input moves the later anchors by O(1)); so, as phase 6 does at bf16,
    each path bit for bit itself with its integer kernels' plain versions
    swapped in (the whole-model path's ``affine_dot_i8`` / ``conv3x3_i8``,
    the layer path's ``int8_matmul_dequant``), and the plain path on #10
    (``int8_impl="pallas"``) bit for bit its ``"lax"`` form; forward
    times. Returns
    ({row: launches}, {label: counts})."""
    from cunet_tpu_torch import ModelConfig, QuantConfig
    from cunet_tpu_torch.models import apply_cu_net, init_cu_net
    from cunet_tpu_torch.models.cu_net import eval_path
    from cunet_tpu_torch.serving import Predictor
    from cunet_tpu_torch.train import quant_eval_params

    whole = ModelConfig(layer_num=8, order=1, class_num=16, loss_num=8,
                        compute_dtype="float32", use_pallas=True,
                        pallas_whole_model=True)
    paths = {"whole-model": whole,
             "layers": dataclasses.replace(whole, pallas_whole_model=False)}
    plain_cfg = dataclasses.replace(whole, use_pallas=False)
    quant = QuantConfig(bits_w=1, bits_i=QUANT_BITS, bits_g=8, enabled=True,
                        int8_infer=True, int8_impl="pallas")
    lax = dataclasses.replace(quant, int8_impl="lax")
    require([eval_path(c, quant) for c in paths.values()]
            == ["whole_model", "layers"], "quant f32 path flags")
    params, state = init_cu_net(whole, torch.Generator().manual_seed(0))
    qparams = quant_eval_params(params, quant)
    rng = np.random.RandomState(0)
    requests = [rng.rand(k, 256, 256, 3).astype(np.float32) for k in (8, 5)]

    def counts():
        return {**qops.launch_counts(), **qops.f32_counts(),
                **ops.f32_counts(), **eops.f32_counts(),
                "table_dot[f32,dual]": eops.option_counts()[
                    "table_dot[dual]"]}

    per_path, preds = {}, {}
    for label, cfg in paths.items():
        pred = preds[label] = Predictor(cfg, qparams, state, device="cuda",
                                        batch_size=BATCH, flip_test=True,
                                        quant=quant)
        ops.reset_launch_counts()
        qops.reset_launch_counts()
        eops.reset_launch_counts()
        answers = [(pred.heatmaps(imgs), pred.predict(imgs))
                   for imgs in requests]
        torch.cuda.synchronize()
        per_path[label] = {k: v for k, v in counts().items() if v}
        for imgs, (hm, pts) in zip(requests, answers):
            k = imgs.shape[0]
            require(hm.shape == (k, 64, 64, 16) and hm.dtype == np.float32,
                    f"quant f32 {label}: heatmaps {hm.shape} {hm.dtype}")
            require(pts.shape == (k, 16, 2), f"landmarks shape {pts.shape}")
            require(np.isfinite(hm).all() and np.isfinite(pts).all()
                    and np.abs(hm).max() > 0,
                    f"quant f32 {label}: non-finite or zero output")
    print(f"quant f32 serving: launches on the main paths (requests of 8 "
          f"and 5, flip test): {per_path}", flush=True)
    need = {"whole-model": ("affine_dot_i8[f32]", "conv3x3_i8[f32]",
                            "affine_dot[f32]", "maxpool2[f32]",
                            "upsample2[f32]"),
            "layers": ("int8_matmul_dequant", "table_dot[f32]",
                       "table_dot[f32,dual]")}
    for label, names in need.items():
        for name in names:
            require(per_path[label].get(name, 0) > 0,
                    f"quant f32 {label}: {name} never launched")
    require("int8_matmul_dequant" not in per_path["whole-model"],
            "int8_matmul_dequant launched on the whole-model path")

    from cunet_tpu_torch.kernels import model_buf, quant_matmul

    def i8_plain():
        """The integer kernels' plain versions swapped in."""
        stack = contextlib.ExitStack()
        for mod, name in ((model_buf, "affine_dot_i8"),
                          (model_buf, "conv3x3_i8")):
            stack.enter_context(_swapped(mod, name, qops.PLAIN[getattr(
                qops, name)]))
        stack.enter_context(_swapped(
            quant_matmul, "int8_matmul_dequant",
            lambda x, w, cs, xs: quant_matmul.int8_matmul_dequant_plain(
                x, w, cs, xs, torch.empty(x.shape[0], w.shape[1],
                                          device=x.device))))
        return stack

    x8 = torch.from_numpy(requests[0]).to("cuda")
    with torch.inference_mode():
        for label, cfg in paths.items():
            got = apply_cu_net(qparams, state, x8, cfg=cfg, quant=quant,
                               slots=preds[label]._slots)[0]
            with i8_plain():
                want = apply_cu_net(qparams, state, x8, cfg=cfg, quant=quant,
                                    slots=preds[label]._slots)[0]
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            print(f"quant f32 serving, {label} path, request of 8: bit for "
                  f"bit the same path on its integer kernels' plain "
                  f"versions {same}", flush=True)
            require(same, f"quant f32 {label}: the int8 kernels' forward "
                          f"differs from their plain versions'")
        qops.reset_launch_counts()
        on_k = apply_cu_net(qparams, state, x8, cfg=plain_cfg, quant=quant)[0]
        k10 = qops.launch_counts()["int8_matmul_dequant"]
        on_lax = apply_cu_net(qparams, state, x8, cfg=plain_cfg, quant=lax)[0]
        same = all(torch.equal(a, b) for a, b in zip(on_k, on_lax))
        print(f"quant f32 serving, plain path (use_pallas off), request of "
              f"8: int8_impl 'pallas' ({k10} int8_matmul_dequant launches) "
              f"bit for bit 'lax' {same}", flush=True)
        require(k10 > 0 and same, "quant f32: the plain path on #10 "
                                  "differs from its lax form")

    s = 2.0 ** (QUANT_BITS - 1)
    plain = dict(cfg=plain_cfg, quant=lax)
    refs = {"whole-model": (plain, contextlib.nullcontext),
            "layers": (dict(cfg=paths["layers"], quant=quant),
                       lambda: layer_plain_swapped(torch))}
    for batch in (BATCH, 64):
        x = torch.rand(batch, 256, 256, 3, generator=torch.Generator()
                       .manual_seed(batch)).to("cuda")
        nudged = torch.nextafter(x, torch.full_like(x, 2.0))
        with torch.inference_mode():
            base, _ = apply_cu_net(qparams, state, x, **plain)
            for label, cfg in paths.items():
                kw, swap = refs[label]
                codes = {"kernel": [], "ref": []}
                with conv_codes(torch, s, codes["kernel"]):
                    got = apply_cu_net(qparams, state, x, cfg=cfg,
                                       quant=quant,
                                       slots=preds[label]._slots)[0]
                with swap():
                    with conv_codes(torch, s, codes["ref"]):
                        want = apply_cu_net(qparams, state, x, **kw)[0]
                    ctl = apply_cu_net(qparams, state, nudged, **kw)[0]
                require(all(a.dtype == torch.float32 for a in got),
                        f"quant f32 {label}: output dtype")
                k_rel = [_rel(a.cpu().numpy(), b.cpu().numpy())
                         for a, b in zip(got, want)]
                c_rel = [_rel(a.cpu().numpy(), b.cpu().numpy())
                         for a, b in zip(ctl, want)]
                p_rel = [_rel(a.cpu().numpy(), b.cpu().numpy())
                         for a, b in zip(got, base)]
                lim = [max(F32_PATH_REL_L2, 2 * c) for c in c_rel]
                rec, ref = codes["kernel"], codes["ref"]
                require(len(rec) == len(ref) and all(
                    a.shape == b.shape for a, b in zip(rec, ref)),
                    f"quant f32 {label}: conv inputs do not pair up")
                flipped = sum(int((a != b).sum()) for a, b in zip(rec, ref))
                total = sum(a.numel() for a in ref)
                print(f"quant f32 serving, {label} path, batch {batch}: "
                      f"relative L2 per anchor to its reference "
                      f"{[float(f'{v:.4g}') for v in k_rel]}; control "
                      f"(reference, input moved one ulp) "
                      f"{[float(f'{v:.4g}') for v in c_rel]}; limits max("
                      f"{F32_PATH_REL_L2:g}, 2 x control); largest share "
                      f"{max(k / m for k, m in zip(k_rel, lim)):.3g}; 3x3 "
                      f"conv int8 codes differing from the reference's: "
                      f"{flipped} of {total} ({flipped / total:.3g}); to the "
                      f"plain path (use_pallas off) "
                      f"{[float(f'{v:.4g}') for v in p_rel]}", flush=True)
                require(all(np.isfinite(k) and k <= m
                            for k, m in zip(k_rel, lim)),
                        f"quant f32 {label} path off its reference at batch "
                        f"{batch}: {k_rel} against {lim}")
                del got, want, ctl, codes
        del base, x, nudged

    for batch in (BATCH, 64):
        parts = []
        for label, cfg, q in [(k, v, quant) for k, v in paths.items()] + [
                ("plain lax", plain_cfg, lax)]:
            p = Predictor(cfg, qparams, state, device="cuda",
                          batch_size=batch, quant=q)
            ms = time_forward(torch, p, batch)
            parts.append(f"{label} {ms:.3f} ms, {batch / ms * 1e3:.1f} img/s")
        print(f"quant f32 serving: forward batch {batch}: "
              f"{'; '.join(parts)} ({gpu})", flush=True)
    launches = {}
    for c in per_path.values():
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
    return launches, per_path


def phase_many_group_serving(torch, ops, eops):
    """Phase 15 (d) and 16 (e): CU-Net at order MANY_ORDER (layer_num 15,
    16 classes, batch 8 at 256 px, seed 0) at CU-Net-8's widths, whose up
    blocks' adapters read 17 feature groups from a table in device memory
    (counted): at float32 and bf16 the per-slot path (JAX's default flags)
    bit for bit the whole-model path; at float32 it, the per-block and the
    per-bottleneck paths within F32_PATH_REL_L2 of the plain path per
    anchor. At bf16 the whole-model path's intermedia adapters from slot 6
    on (K = 896 ... 1920) run ``affine_dot`` with its weight streamed
    (counted). Returns {row: launches over more than 16 groups, or of the
    streamed ``affine_dot``}."""
    from cunet_tpu_torch import ModelConfig
    from cunet_tpu_torch.models import apply_cu_net, init_cu_net
    from cunet_tpu_torch.models.cu_net import eval_slots

    launches = {}
    for dt in ("float32", "bfloat16"):
        cfg = ModelConfig(layer_num=MANY_ORDER + 1, order=MANY_ORDER,
                          class_num=16, loss_num=2, compute_dtype=dt,
                          use_pallas=True)
        params, state = init_cu_net(cfg, torch.Generator().manual_seed(0))
        x = torch.rand(BATCH, 256, 256, 3, generator=torch.Generator()
                       .manual_seed(14)).to("cuda")
        slots = eval_slots(params, state, cfg)
        with torch.inference_mode():
            eops.reset_launch_counts()
            per_slot, _ = apply_cu_net(params, state, x, cfg=cfg,
                                       slots=slots)
            torch.cuda.synchronize()
            ext = eops.ext_counts()["table_dot[groups>16]"]
            ops.reset_launch_counts()
            whole, _ = apply_cu_net(params, state, x, slots=slots,
                                    cfg=dataclasses.replace(
                                        cfg, pallas_whole_model=True))
            torch.cuda.synchronize()
            stream = ops.stream_counts()["affine_dot[stream]"]
            same = all(torch.equal(a, b) for a, b in zip(per_slot, whole))
            rels = {}
            if dt == "float32":
                plain, _ = apply_cu_net(params, state, x,
                                        cfg=dataclasses.replace(
                                            cfg, use_pallas=False))
                others = {"per-slot": per_slot}
                for label, flags in (("per-block", dict(
                        pallas_hourglass=False)), ("per-bottleneck", dict(
                            pallas_hourglass=False, use_scan=False))):
                    others[label] = apply_cu_net(
                        params, state, x,
                        cfg=dataclasses.replace(cfg, **flags))[0]
                rels = {label: max(_rel(a.cpu().numpy(), b.cpu().numpy())
                                   for a, b in zip(outs, plain))
                        for label, outs in others.items()}
        row = "table_dot[f32,groups>16]" if dt == "float32" \
            else "table_dot[groups>16]"
        launches[row] = ext
        if dt == "bfloat16":
            launches["affine_dot[stream]"] = stream
        print(f"order {MANY_ORDER} ({dt}, layer_num {cfg.layer_num}, c="
              f"{cfg.init_chan_num}, g={cfg.growth_rate}, batch {BATCH}): "
              f"per-slot forward launched table_dot over more than 16 groups "
              f"{ext} times; the whole-model forward launched affine_dot "
              f"with its weight streamed {stream} times; bit for bit the "
              f"whole-model path {same}; worst anchor relative L2 to the "
              f"plain path {rels} (bound {F32_PATH_REL_L2})", flush=True)
        require(ext > 0, f"order {MANY_ORDER}: no table of more than 16 "
                         f"groups was read")
        require((stream > 0) == (dt == "bfloat16"),
                f"order {MANY_ORDER} ({dt}): streamed affine_dot launched "
                f"{stream} times")
        require(same, f"order {MANY_ORDER} ({dt}): per-slot path differs "
                      f"from the whole-model path")
        require(all(np.isfinite(v) and v <= F32_PATH_REL_L2
                    for v in rels.values()),
                f"order {MANY_ORDER}: a kernel path off the plain path: "
                f"{rels}")
        del per_slot, whole, params, slots
    return launches


# ---------------------------------------------------------------------------
# phase 16: JAX's threefry dropout masks (drop_impl="masks", the masks form
# of #8/#9) and affine_dot with its weight streamed (any K)
# ---------------------------------------------------------------------------

# Random123's threefry2x32 (20 rounds) known answers: (key, count, result)
RANDOM123 = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
             ((2 ** 32 - 1,) * 2, (2 ** 32 - 1,) * 2,
              (0x1CB996FC, 0xBB002BE7)),
             ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
              (0xC4923A9C, 0x483DF7A0))]
# integer operations of one mask element (csrc/train_kernels.cu,
# threefry_bits): 2 adds of the first key injection, 20 rounds of add,
# funnel shift and xor, 5 injections of two adds, the output xor, then the
# shift and the comparison
THREEFRY_OPS = 2 + 20 * 3 + 5 * 2 + 1 + 2
# the masks steps' threefry key: jax.random.PRNGKey(5)
MASK_RNG = (0, 5)
# the streamed affine_dot: the intermedia adapter at order 6 and 14
STREAM_KS = (896, 1920)


def threefry_checks(torch, dops, results):
    """Phase 16 (a) and (b): the plain threefry on the card against
    Random123's vectors and against MASK_DIGESTS (JAX's masks), at bf16
    and float32; ``threefry_mask`` on ones at every traversal position
    (batch 24, g=32, r = 64 ... 4) and from a strided float32 cotangent,
    both forms bit for bit the plain masks; its drop fraction at r=64;
    the r=64 cases timed (rows ``threefry_mask`` and ``[f32]``)."""
    from cunet_tpu_torch.ops import threefry

    for key, (c0, c1), want in RANDOM123:
        y0, y1 = threefry.threefry2x32(
            key, torch.tensor([c0], device="cuda"),
            torch.tensor([c1], device="cuda"))
        require((y0.item(), y1.item()) == want,
                f"threefry2x32 on the card: key {key}, count {(c0, c1)} "
                f"gives {(y0.item(), y1.item())}, Random123 {want}")
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        got = mask_digest(torch, dt, "cuda")
        require(got == MASK_DIGESTS[name],
                f"threefry masks ({name}) on the card: digest {got}, JAX's "
                f"{MASK_DIGESTS[name]}")
    print("threefry: the plain version on the card gives Random123's three "
          "vectors and JAX's masks (MASK_DIGESTS, bf16 and float32, 9 "
          "positions at batch 24)", flush=True)

    n, g = TRAIN_BATCH, 32
    keys = threefry.block_keys(threefry.fold_in(threefry.fold_in(
        MASK_RNG, 0), 1), 4)
    plain = dops.PLAIN[dops.threefry_mask]
    gen = torch.Generator().manual_seed(16)
    for dt in (torch.bfloat16, torch.float32):
        for pos, r in mask_positions():
            m = n * r * r
            ones = torch.ones(m, g, device="cuda", dtype=dt)
            dops.threefry_mask(ones, keys[pos], DROP_RATE)
            want = threefry.bernoulli_mask(keys[pos], (m, g), DROP_RATE, dt,
                                           "cuda")
            d = torch.randn(m, g + 8, generator=gen).cuda()[:, 8:]
            k_out = torch.empty(m, g, device="cuda", dtype=dt)
            p_out = torch.empty_like(k_out)
            dops.threefry_mask(d, keys[pos], DROP_RATE, k_out)
            plain(d, keys[pos], DROP_RATE, p_out)
            torch.cuda.synchronize()
            require(torch.equal(ones, want) and torch.equal(k_out, p_out),
                    f"threefry_mask ({dt}) differs from the plain masks at "
                    f"position {pos}, r={r}")
            if pos == 0:
                frac = (ones == 0).float().mean().item()
                print(f"threefry_mask: drop fraction of one r=64 out32 "
                      f"({m} x {g}, {dt}): {frac:.5f} (rate {DROP_RATE} +- "
                      f"{DROP_FRACTION_TOL})", flush=True)
                require(abs(frac - DROP_RATE) <= DROP_FRACTION_TOL,
                        f"threefry drop fraction {frac}")
    print("threefry_mask: bf16 and float32, in place and from a float32 "
          "cotangent, bit for bit the plain masks at positions 0..8 (r = "
          "64..4, batch 24)", flush=True)

    m, key = n * 64 * 64, keys[0]
    ops = THREEFRY_OPS * m * g
    for dt, name in ((torch.bfloat16, "threefry_mask"),
                     (torch.float32, "threefry_mask[f32]")):
        e = 4 if dt == torch.float32 else 2
        buf = torch.randn(m, 3 * g, generator=gen).to("cuda", dt)
        d = torch.randn(m, g + 96, generator=gen).cuda()[:, 64:64 + g]
        cases = [("forward r=64 in place", lambda f, o: f(o, key, DROP_RATE),
                  lambda: buf.clone()[:, g:2 * g],
                  work(2 * sz(m, g, e=e), ops, "int32")),
                 (f"backward r=64 f32->{'f32' if e == 4 else 'bf16'}",
                  lambda f, o: f(d, key, DROP_RATE, o),
                  lambda: torch.empty(m, g, device="cuda", dtype=dt),
                  work(sz(m, g, e=4) + sz(m, g, e=e), ops, "int32"))]
        for label, call, make_out, w in cases:
            k_out, p_out = make_out(), make_out()
            call(dops.threefry_mask, k_out)
            call(plain, p_out)
            torch.cuda.synchronize()
            same = torch.equal(k_out, p_out)
            ms = cuda_time_ms(lambda: call(dops.threefry_mask, k_out))
            plain_ms = cuda_time_ms(lambda: call(plain, p_out))
            print(f"mask kernel {name} [{label}]: bit-identical {same}, "
                  f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, library none, "
                  f"bound {bound(w)[0]:.4f} ms ({bound(w)[1]})", flush=True)
            require(same, f"{name} [{label}] differs from its plain version")
            record(results, name, 0.0, ms, plain_ms, label, w, None)


def stream_dot_checks(torch, ops, results):
    """Phase 16 (f): ``affine_dot`` with its weight streamed, at K =
    STREAM_KS -> 128 (r=64, batch 8, from a strided buffer, the eval
    vectors), against its plain version within the bf16 bound, timed
    beside ``torch.mm`` of its bf16 product alone (row
    ``affine_dot[stream]``)."""
    gen = torch.Generator().manual_seed(17)
    m, n = BATCH * 64 * 64, 128
    for k in STREAM_KS:
        x = torch.randn(m, k + 32, generator=gen).to("cuda", torch.bfloat16)
        v = torch.stack([torch.rand(k, generator=gen) + 0.5,
                         torch.randn(k, generator=gen) * 0.5]).cuda()
        w = (torch.randn(k, n, generator=gen) * k ** -0.5).to(
            "cuda", torch.bfloat16)
        require(ops.affine_dot_plan(m, k, n).kc > 0,
                f"affine_dot at K={k} does not stream")
        k_out = torch.empty(m, n + 32, device="cuda",
                            dtype=torch.bfloat16)[:, 16:16 + n]
        p_out = torch.empty_like(k_out)

        def call(f, o, x=x, v=v, w=w, k=k):
            f(x[:, :k], v, w, o)

        call(ops.affine_dot, k_out)
        call(ops.affine_dot_plain, p_out)
        torch.cuda.synchronize()
        want = p_out.float()
        err = (k_out.float() - want).abs().max().item()
        lim = REL_BOUND * want.abs().max().item() + ABS_BOUND
        ms = cuda_time_ms(lambda: call(ops.affine_dot, k_out))
        plain_ms = cuda_time_ms(lambda: call(ops.affine_dot_plain, p_out))
        prod_ms = cuda_time_ms(lambda x=x, w=w, k=k: torch.mm(x[:, :k], w))
        wk = work(sz(m, k) + sz(k, n) + sz(2, k, e=4) + sz(m, n),
                  2 * m * k * n)
        label = f"K={k}->128 r=64 batch {BATCH}, streamed"
        print(f"kernel affine_dot[stream] [{label}]: max_abs_err {err:.4g} "
              f"(bound {lim:.4g}), {ms:.4f} ms vs plain {plain_ms:.4f} ms"
              f"{product_text(prod_ms)}, bound {bound(wk)[0]:.4f} ms "
              f"({bound(wk)[1]})", flush=True)
        require(err <= lim, f"affine_dot[stream] [{label}]: {err} > {lim}")
        record(results, "affine_dot[stream]", err, ms, plain_ms, label, wk,
               None, prod_ms)


def phase_masks_training(torch, tops, bops, dops, gpu):
    """Phase 16 (c), (d), (g): CU-Net-8 @256 at drop rate DROP_RATE with
    ``drop_impl="masks"`` (the step key ``fold_in(MASK_RNG, step)``): the
    bf16 ghost-BN tile-2 kernel step against the plain step within the
    step limits and bit for bit on a repeat (``compare_steps``); the
    float32 step against the swap step within max(2c, 1e-5), c over three
    one-ulp product controls (a permuted batch would move the masks); three
    main-path ``train_step(..., rng=)``, ``threefry_mask`` launched 72 times
    forward and 72 backward a step and ``drop_mask`` never; step times in
    ABBA order beside the seed form; the bf16 ``bn_tile=0`` step with the
    plain mask swapped in, bit for bit, and one ``train_step`` there; one
    bf16 ghost-BN slot at order 6 (the intermedia adapter's K = 896, the
    streamed ``affine_dot`` per tile) against the plain path. Returns
    {row: launches of the main path's drive}."""
    from cunet_tpu_torch import TrainConfig
    from cunet_tpu_torch.kernels import train_slot
    from cunet_tpu_torch.models import init_cu_net
    from cunet_tpu_torch.ops import threefry
    from cunet_tpu_torch.tools.f32_step_gap import patched, slot_swap
    from cunet_tpu_torch.train import create_train_state, train_step

    cfg, params, state, batch = flagship_train(torch)
    x, t = batch["image"], batch["heatmap"]
    mcfg = dataclasses.replace(cfg, drop_rate=DROP_RATE, drop_impl="masks")
    key = threefry.fold_in(MASK_RNG, 0)
    compare_steps(torch, "masks training", mcfg, params, state, x, t,
                  drop_key=key)

    # float32 against the swap step (the ten forms and the mask plain)
    import types

    fcfg = dataclasses.replace(mcfg, compute_dtype="float32",
                               bn_dtype="float32")
    forms = types.SimpleNamespace(
        reset_launch_counts=lambda: (tops.reset_launch_counts(),
                                     bops.reset_launch_counts(),
                                     dops.reset_launch_counts()),
        launch_counts=lambda: {**slot_f32_counts(tops, bops),
                               **mask_counter(dops.threefry_mask, True)
                               .launch_counts()})
    torch.backends.cudnn.deterministic = True
    try:
        f32_step_check(
            torch, f"masks f32 training (tile {BN_TILE})", fcfg, params,
            state, x, t, lambda: patched(
                train_slot, **slot_swap(),
                threefry_mask=dops.PLAIN[dops.threefry_mask]),
            forms, [], noise=3, drop_key=key)
    finally:
        torch.backends.cudnn.deterministic = False
    tcfg = TrainConfig(lr=2.5e-4, batch_size=TRAIN_BATCH)
    rng = np.array(MASK_RNG, np.uint32)
    st_f = create_train_state(params, state, tcfg)
    launches = one_step(
        torch, f"masks f32 training (tile {BN_TILE})",
        lambda: train_step(st_f, batch, cfg=fcfg, rng=rng)[1], (forms,))
    launches = {"threefry_mask[f32]": launches["threefry_mask[f32]"]}
    del st_f

    # the main path: three steps from rng=MASK_RNG
    st = create_train_state(params, state, tcfg)
    launches.update(main_path_steps(
        torch, "masks training",
        lambda: train_step(st, batch, cfg=mcfg, rng=rng)[1],
        lambda: st.params, (bops, tops, mask_counter(dops.threefry_mask))))
    per_step = launches["threefry_mask"] / 3
    want = 2 * mcfg.layer_num * (2 * mcfg.num_blocks + 1)
    print(f"masks training: threefry_mask launched {per_step:g} times a step "
          f"(72 forward + 72 backward expected), drop_mask "
          f"{dops.drop_mask.launches}", flush=True)
    require(per_step == want, f"masks training: threefry_mask {per_step} "
                              f"launches a step, not {want}")
    require(dops.drop_mask.launches == 0,
            "masks training launched the seed-form mask kernel")
    st_s = create_train_state(params, state, tcfg)
    gen = torch.Generator().manual_seed(6)
    scfg = dataclasses.replace(mcfg, drop_impl="prng")
    times = paired_step_times(torch, {
        "threefry masks": lambda: train_step(st, batch, cfg=mcfg, rng=rng),
        "seed masks": lambda: train_step(st_s, batch, cfg=scfg,
                                         generator=gen)})
    print(f"masks training, batch {TRAIN_BATCH}, steps in ABBA order: " +
          "; ".join(f"{k} median {np.median(v):.3f} ms ("
                    + ", ".join(f"{ms:.1f}" for ms in v) + ")"
                    for k, v in times.items()) + f" ({gpu})", flush=True)
    del st, st_s

    # bn_tile=0: the masks through the Function, bit for bit the plain mask
    bcfg = dataclasses.replace(mcfg, bn_tile=0)
    bn0_dropout(torch, bcfg, params, state, x, t, dops,
                label="bn0 masks training", name="threefry_mask",
                drop_key=key)
    from cunet_tpu_torch.kernels import train_bottleneck as tbk

    st_b = create_train_state(params, state, tcfg)
    one_step(torch, "bn0 masks training",
             lambda: train_step(st_b, batch, cfg=bcfg, rng=rng)[1],
             (tbk, mask_counter(dops.threefry_mask)))
    del st_b

    # one slot at order 6: the intermedia adapter at K = 896, streamed
    ocfg = dataclasses.replace(cfg, order=6)
    oparams, ostate = init_cu_net(ocfg, torch.Generator().manual_seed(0))
    bops.reset_launch_counts()
    check_slot(torch, ocfg, oparams, ostate, i=6)
    stream = bops.stream_counts()["affine_dot[stream]"]
    print(f"training (order 6): slot 6's kernel path launched affine_dot "
          f"with its weight streamed {stream} times", flush=True)
    require(stream > 0, "order 6 slot: the streamed affine_dot never ran")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU smoke",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from cunet_tpu_torch.kernels import buf_ops as ops
    from cunet_tpu_torch.kernels import build
    from cunet_tpu_torch.kernels import drop_ops as dops
    from cunet_tpu_torch.kernels import eval_ops as eops
    from cunet_tpu_torch.kernels import quant_ops as qops
    from cunet_tpu_torch.kernels import train_bottleneck as tbk
    from cunet_tpu_torch.kernels import train_ops as tops

    # ---- phase 1: build ----
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(gpu, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.lib()
    print(f"build: {build.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc "
          f"{'ran' if build.build_seconds is not None else 'skipped'}; "
          f"each source done after, s: "
          f"{ {k: round(v, 1) for k, v in build.source_seconds.items()} })",
          flush=True)

    clock = [time.perf_counter()]

    def lap(label):
        """Print the wall time since the last lap (the run's time budget)."""
        now = time.perf_counter()
        print(f"phase time: {label} {now - clock[0]:.1f} s", flush=True)
        clock[0] = now

    try:
        kernels = phase_kernels(torch, ops)
        launches, float_ms = phase_serving(torch, ops, gpu)
        lap("2-3")
        train_kernels = phase_train_kernels(torch, tops, ops)
        train_launches, bf16_times = phase_training(torch, tops, ops, gpu)
        lap("4-5")
        int8_kernels = phase_int8_kernels(torch, qops)
        int8_launches, plain_launches = phase_int8_serving(
            torch, ops, qops, gpu, float_ms)
        lap("6")
        drop_kernels, drop_launches = phase_dropout_training(
            torch, tops, ops, dops, gpu)
        option_kernels, quant_launches = phase_quant_training(
            torch, tops, ops, dops, gpu)
        lap("7-8")
        tb_kernels = phase_bn0_kernels(torch, tbk)
        tb_kernels["train_bottleneck.bwd_dx"]["wide_out"] = wide_out_check(
            torch, tbk, torch.Generator().manual_seed(17), torch.bfloat16)
        tb_launches, bn0_times = phase_bn0_training(torch, tbk, tops, ops,
                                                    dops, gpu)
        lap("9")
        eval_kernels = phase_eval_kernels(torch, eops)
        slot_launches, slot_forwards, slot_ms = phase_slot_serving(
            torch, ops, eops, gpu, float_ms)
        int8_duals = phase_quant_layer_eval(torch, eops, qops, gpu)
        phase_face_heads(torch, ops, eops, qops, tops, gpu)
        lap("10")
        block_kernels = phase_block_kernels(torch, ops, eops)
        block_fns = phase_block_functions(torch, ops, eops)
        block_launches, block_forwards, block_ms = phase_block_serving(
            torch, ops, eops, gpu)
        model_fns = phase_fused_models(torch, ops, gpu)
        lap("11")
        f32_kernels = phase_f32_kernels(torch, ops, eops)
        f32_launches, f32_per_path, f32_ms = phase_f32_serving(
            torch, ops, eops, gpu)
        lap("12")
        tb_f32_kernels = phase_bn0_f32_kernels(torch, tbk, dops)
        lap("13 (a)")
        tb_f32_launches, tb_f32_per_step = phase_bn0_f32_training(
            torch, tbk, tops, ops, dops, gpu, bn0_times)
        lap("13 (b)-(e)")
        slot_f32_kernels = phase_slot_f32_kernels(torch, tops, ops, tbk)
        lap("14 (a)")
        slot_f32_launches, slot_f32_per_step = phase_slot_f32_training(
            torch, tops, ops, dops, gpu, bf16_times)
        lap("14 (b)-(d)")
        quant_f32_kernels = phase_quant_f32_kernels(torch, tops, ops, qops,
                                                    eops)
        lap("15 (a)")
        quant_f32_launches, quant_f32_per_step = phase_quant_f32_training(
            torch, tops, ops, gpu)
        lap("15 (b)")
        int8_f32_launches, int8_f32_per_path = phase_quant_f32_serving(
            torch, ops, qops, eops, gpu)
        lap("15 (c)")
        many_launches = phase_many_group_serving(torch, ops, eops)
        lap("15 (d), 16 (e)")
        mask_kernels = {}
        threefry_checks(torch, dops, mask_kernels)
        stream_dot_checks(torch, ops, mask_kernels)
        lap("16 (a), (b), (f)")
        mask_launches = phase_masks_training(torch, tops, ops, dops, gpu)
        lap("16 (c), (d), (g)")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    if "jax" in sys.modules or "cunet_tpu" in sys.modules:
        print("chip_smoke: FAILED: the JAX package was imported",
              file=sys.stderr)
        return 1

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")

    def row(name, source, r, n_launches, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": REPLACES[name], "launches": n_launches,
                **{k: r[k] for k in keys},
                **{k: r[k] for k in ("product_ms",) if k in r}, **extra}

    rows = []
    for name in list(kernels) + [k for k in train_kernels
                                 if k not in kernels]:
        r = kernels.get(name) or train_kernels[name]
        extra = {"train_launches": train_launches[name],
                 "dropout_train_launches": drop_launches[name],
                 "quant_train_launches": quant_launches[name]}
        if name in kernels and name in train_kernels:
            t = train_kernels[name]
            extra.update(train_ms=t["ms"], train_plain_ms=t["plain_ms"],
                         train_bound_ms=t["bound_ms"],
                         train_library_ms=t["library_ms"],
                         train_product_ms=t.get("product_ms"),
                         train_shape=t["shape"])
            r = dict(r, max_abs_err=max(r["max_abs_err"], t["max_abs_err"]))
        rows.append(row(name, SOURCE if name in launches else TRAIN_SOURCE,
                        r, launches.get(name, train_launches[name]),
                        **extra))
    for name, r in int8_kernels.items():
        rows.append(row(name, INT8_SOURCE, r, plain_launches[name])
                    if name == "int8_matmul_dequant" else
                    row(name, I8_SOURCE, r, int8_launches[name]))
    rows.append(row("drop_mask", TRAIN_SOURCE, drop_kernels["drop_mask"],
                    drop_launches["drop_mask"]))
    for name, r in option_kernels.items():
        rows.append(row(name, SOURCE if name.split("[")[0] in launches
                        else TRAIN_SOURCE, r, quant_launches[name]))
    for name, r in tb_kernels.items():
        rows.append(row(name, SOURCE if name == "train_bottleneck.apply"
                        else TB_SOURCE, r, tb_launches[name]))
    for name, r in eval_kernels.items():
        extra = {"launches_per_forward":
                 slot_launches[name] / slot_forwards,
                 "slot_forward_ms": slot_ms}
        if name in ALSO_REPLACES:
            extra["also_replaces"] = ALSO_REPLACES[name]
        if name == "table_dot[dual]":
            extra["int8_eval_launches"] = int8_duals
        rows.append(row(name, EVAL_SOURCE, r, slot_launches[name], **extra))
    block_extra = {"block_forward_ms": block_ms}
    for name, r in {**block_kernels, **block_fns}.items():
        rows.append(row(name, BLOCK_SOURCE if name in block_fns
                        else EVAL_SOURCE, r, block_launches[name],
                        launches_per_forward=block_launches[name]
                        / block_forwards, **block_extra))
    for name, r in model_fns.items():
        rows.append(row(name, MODEL_SOURCE, r, r["calls"],
                        kernel_launches_per_call=r["kernel_launches_per_call"]
                        ))
    f32_extra = {"f32_forward_ms": {f"{label}, batch {b}": ms
                                    for (label, b), ms in f32_ms.items()}}
    for name, r in f32_kernels.items():
        src = SOURCE if name.split("[")[0] in ("maxpool2", "upsample2") \
            else F32_SOURCE
        rows.append(row(name, src, r, f32_launches[name],
                        launches_per_path={k: v.get(name, 0) for k, v in
                                           f32_per_path.items()},
                        **{k: r[k] for k in ("one_hot_exact",) if k in r},
                        **f32_extra))
    for name, r in tb_f32_kernels.items():
        src = TRAIN_SOURCE if name == "drop_mask[f32]" else \
            FWD_F32_SOURCE if name in FWD_F32_ROWS else \
            TB_DX_F32_SOURCE if name == "train_bottleneck.bwd_dx[f32]" \
            else TB_SOURCE
        rows.append(row(name, src, r, tb_f32_launches[name],
                        launches_per_step=tb_f32_per_step[name],
                        **fwd_kernel(name), **sums_kernel(name),
                        **({"kernel": TB_DX_F32_KERNEL}
                           if src == TB_DX_F32_SOURCE else {}),
                        **{k: r[k] for k in ("one_hot_exact", "dw_f64_rel",
                                             "wide") if k in r}))
    for name, r in slot_f32_kernels.items():
        src = TRAIN_SOURCE if SLOT_F32[name][0] in (
            "bn_stats", "bn_bwd", "maxpool2_bwd", "upsample2_bwd") \
            else f32_source(name)
        rows.append(row(name, src, r, slot_f32_launches[name],
                        launches_per_step=slot_f32_per_step[name],
                        **fwd_kernel(name), **conv_kernel(name),
                        **sums_kernel(name),
                        one_hot_exact=r["one_hot_exact"]))
    # the wgmma conv kernel: the forward form's r=64 numbers, the dx's
    # beside them
    dx = slot_f32_kernels["conv3x3_dx[f32]"]
    rows.append(row(CONV_WG, CONV_F32_SOURCE,
                    slot_f32_kernels["conv3x3[f32,tile]"],
                    slot_f32_launches[CONV_WG],
                    launches_per_step=slot_f32_per_step[CONV_WG],
                    also_replaces=CONV_WG_ALSO,
                    dx_form={k: dx[k] for k in keys}))
    for name, r in quant_f32_kernels.items():
        if name in QUANT_F32:
            src = f32_source(name)
            n = quant_f32_launches[name]
            extra = dict(launches_per_step=quant_f32_per_step[name],
                         one_hot_exact=r["one_hot_exact"], **fwd_kernel(name))
        elif name.endswith("groups>16]"):
            src = F32_SOURCE if "f32" in name else EVAL_SOURCE
            n = many_launches[name]
            extra = dict(ms_16_groups=r["ms_16_groups"])
        else:
            src, n = I8_SOURCE, int8_f32_launches[name]
            extra = dict(launches_per_path={
                k: v.get(name, 0) for k, v in int8_f32_per_path.items()})
        rows.append(row(name, src, r, n, **extra))
    for name, r in mask_kernels.items():
        if name == "affine_dot[stream]":
            rows.append(row(name, SOURCE, r, many_launches[name]))
        else:
            rows.append(row(name, TRAIN_SOURCE, r, mask_launches[name]))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
