"""Order-K coupled U-Net (CU-Net) in PyTorch: eval and train forwards.

Counterpart of ``cunet_tpu/models/cu_net.py``. ``layer_num`` (K) U-Nets
share one set of per-position dense blocks; U-Net ``i`` uses layer slot
``i`` of every block, and dense connections across U-Nets are trimmed to
the last ``order`` neighbours through per-block FIFOs.

Parameters and BN running statistics are two flat dicts of tensors keyed by
the JAX tree paths (``hg.down.0.layers.3.bottleneck.conv``,
``heads.7.norm.scale``; state ``...norm.mean`` / ``...norm.var``), so a
checkpoint of either package maps one to one
(:mod:`cunet_tpu_torch.tools.from_jax`). Activations are NHWC and conv
weights HWIO, as in the JAX package.

Paths, chosen by the config as in JAX (:func:`eval_path` names the eval
ones):

- the plain layer-by-layer forward (``use_pallas=False``), eval or train,
  a direct translation of the JAX lax path (gradients by autograd);
- the whole-model eval forward (``use_pallas=True,
  pallas_whole_model=True``): the stem in plain PyTorch, then the whole
  post-stem stack over channel-plane buffers through the hand-written
  kernels (:mod:`cunet_tpu_torch.kernels.model_buf`); with an int8
  ``QuantConfig`` (``int8_infer=True, int8_impl="pallas"``) the same
  buffers through the int8 kernels;
- the per-slot eval forward (``use_pallas=True`` and the default
  ``pallas_hourglass=True``, unquantized): the stem in plain PyTorch, then
  every slot through the hourglass kernels
  (:mod:`cunet_tpu_torch.kernels.hourglass`), whose FIFO entries go back to
  memory between slots (:func:`_fused_slot_eval_hg`);
- the per-block eval forward (``use_pallas=True,
  pallas_hourglass=False`` with ``use_scan`` over two or more steady
  slots, unquantized): the slots before ``max(order, 1)`` layer by layer
  as below, then every steady slot on the per-block kernels
  (:mod:`cunet_tpu_torch.kernels.fused_block`, #5), the intermedia adapter
  riding the first down block and the head the last up block
  (:func:`_fused_slot_eval`), as JAX's scan body runs them;
- the layer-by-layer eval with ``use_pallas`` otherwise
  (``pallas_hourglass=False`` without that scan, or any quantized eval
  outside the whole-model int8 path): every bottleneck and intermedia
  adapter on the per-bottleneck eval kernel and each down block's adapter
  pair on its dual form (:mod:`cunet_tpu_torch.kernels.bottleneck_infer`),
  the 3x3 convs, pools, upsamples and heads plain, as in JAX;
- the train kernel path (``use_pallas=True, bn_tile > 0``): the stem in
  plain PyTorch, then each slot through the slot train kernels and their
  recompute backward (:mod:`cunet_tpu_torch.kernels.train_slot`);
- whole-batch BN training on the kernels (``use_pallas=True, bn_tile=0``):
  the plain layer-by-layer train forward with every bottleneck and adapter
  on the per-bottleneck train kernel and its recompute backward
  (:mod:`cunet_tpu_torch.kernels.train_bottleneck`); BN2, the 3x3 convs,
  the stem, the pools and the heads stay plain PyTorch, as they stay
  ``lax`` in the JAX package.

Activation checkpointing (``remat``, train mode, the layer-by-layer paths)
maps JAX's ``jax.checkpoint`` policies to ``torch.utils.checkpoint``:
``"bottleneck"`` each plain bottleneck (the per-bottleneck kernel subsumes
it), ``"layer"`` each dense layer's bottleneck + BN2 + 3x3 conv, ``"block"``
each slot's intermedia adapter and hourglass. A checkpointed region writes
its running statistics once, from the first forward, and the recompute
draws no seed: the dropout masks are hashes of the slot's seed.

The JAX ``lax.scan`` over steady-state slots and its stacked-slot storage
exist to cut XLA compile time; here every slot runs in a plain loop, and
``use_scan`` only chooses the kernels, as it does in JAX.

The hand-written kernels take bfloat16 and float32
(``compute_dtype="float32"``, JAX's default) on every path: the
whole-model, per-slot, per-block and per-bottleneck eval kernels, the
int8 kernels, the slot train kernels #8/#9 (ghost-BN training, ``bn_tile
> 0``, plain, with dropout and with QuanInput), the per-bottleneck train
kernel #7 (``bn_tile=0``) and the dropout-mask kernel have float32 forms
whose products are float32-accurate. ``use_pallas`` on a CUDA device with
any other dtype raises (:func:`check_kernel_dtype`); on the CPU the
kernels' plain versions run in any dtype.
``conv3x3_impl="scatter"`` runs every dense layer's 3x3 conv as JAX's
scatter form (:func:`cunet_tpu_torch.ops.layers.conv3x3_scatter`).

Quantized eval (``quant``, weights from
:func:`cunet_tpu_torch.train.quant_step.quant_eval_params`) follows the JAX
package: the activation quantizer before every 3x3 conv and every head, and
with ``int8_infer`` also before every block 1x1 conv, which then runs as an
integer product (:func:`_int8_bottleneck_infer`); intermedia adapters are
never quantized, and with ``use_pallas`` neither are the down blocks'
adapter pairs, which JAX sends to its float dual kernel whatever the
quantization (:func:`_apply_dual_adapters`). Quantized training (weights ``quantize_params`` of the
masters, :func:`cunet_tpu_torch.train.quant_step.quant_train_step`) puts
the quantizer at the same two points, on either train path.

Dropout (``drop_rate > 0``, ``drop_impl="prng"``) multiplies each dense
layer's 3x3 conv output by a counter-hash mask
(:mod:`cunet_tpu_torch.ops.dropmask`) from one int32 seed per slot
(``apply_cu_net(..., drop_seeds=)``), at traversal position down j -> j,
neck -> nb, up j -> 2nb - j and per ghost-BN tile, so both train paths and
the JAX package draw the same masks from the same seeds. On the
layer-by-layer kernel path (``bn_tile=0``) the mask kernel applies it,
forward and backward (:func:`cunet_tpu_torch.kernels.drop_ops.dropout`).
With ``drop_impl="masks"`` the masks are the JAX package's threefry
bernoulli draws (:mod:`cunet_tpu_torch.ops.threefry`) from one step key
(``apply_cu_net(..., drop_key=)``): slot i folds i into it, and block
position down j / neck / up j folds tag j / 100 / 200 + j into the slot
key; the kernel paths regenerate them with
:func:`cunet_tpu_torch.kernels.drop_ops.threefry_mask`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from cunet_tpu_torch.config import ModelConfig, QuantConfig
from cunet_tpu_torch.ops import (
    batch_norm,
    bn_inference_scale_shift,
    conv2d,
    conv3x3_scatter,
    dense_bottleneck,
    dense_bottleneck_infer_pallas,
    dense_bottleneck_remat,
    dense_bottleneck_train_pallas,
    max_pool_2x2,
    relu,
    upsample_nearest_2x,
)
from cunet_tpu_torch.ops import dropmask, threefry
from cunet_tpu_torch.ops.layers import running_update
from cunet_tpu_torch.quant.wage import quan_input

# ---------------------------------------------------------------------------
# parameter layout and init
# ---------------------------------------------------------------------------


def dense_block_channels(cfg: ModelConfig, in_num: int) -> List[Tuple[int, int]]:
    """(layer_in, adapter_in) channel counts per U-Net slot i."""
    out = []
    for i in range(cfg.layer_num):
        link = min(i, cfg.order)
        out.append((in_num + link * cfg.growth_rate,
                    in_num + (link + 1) * cfg.growth_rate))
    return out


def param_shapes(cfg: ModelConfig) -> Tuple[Dict[str, tuple], Dict[str, tuple]]:
    """Shapes of every parameter and BN-state leaf, keyed by JAX tree path,
    in the order of ``cunet_tpu.models.cu_net.init_cu_net``."""
    params: Dict[str, tuple] = {}
    state: Dict[str, tuple] = {}

    def bn(prefix, c):
        params[f"{prefix}.scale"] = (c,)
        params[f"{prefix}.bias"] = (c,)
        state[f"{prefix}.mean"] = (c,)
        state[f"{prefix}.var"] = (c,)

    def unit(prefix, cin, cout):
        bn(f"{prefix}.norm", cin)
        params[f"{prefix}.conv"] = (1, 1, cin, cout)

    def block(prefix, in_num, skip, is_up):
        aout = in_num // 2 if is_up else in_num
        for i, (lin, ain) in enumerate(dense_block_channels(cfg, in_num)):
            unit(f"{prefix}.layers.{i}.bottleneck", lin, cfg.bottleneck_chan)
            bn(f"{prefix}.layers.{i}.norm2", cfg.bottleneck_chan)
            params[f"{prefix}.layers.{i}.conv2"] = (
                3, 3, cfg.bottleneck_chan, cfg.growth_rate)
            unit(f"{prefix}.adapters_ahead.{i}", ain, aout)
            if skip:
                unit(f"{prefix}.adapters_skip.{i}", ain, aout)

    c = cfg.init_chan_num
    params["stem.conv"] = (7, 7, 3, c)
    bn("stem.norm", c)
    for b in range(cfg.num_blocks):
        block(f"hg.down.{b}", c, True, False)
        block(f"hg.up.{b}", 2 * c, False, True)
    block("hg.neck", c, False, False)
    for j in range(cfg.layer_num - 1):
        cin = c + (min(j, cfg.order - 1) + 1) * c if cfg.order > 0 else c
        unit(f"intermedia.adapters.{j}", cin, c)
    for i in range(cfg.layer_num):
        unit(f"heads.{i}", c, cfg.class_num)
    return params, state


def init_cu_net(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda"):
    """Random (params, state) with the JAX init's shapes and distributions:
    conv weights U(-1/sqrt(fan_in), +1/sqrt(fan_in)), BN scale U(0, 1), BN
    bias 0, running mean 0, running var 1. Drawn in float32 on the CPU from
    ``generator`` (the numbers differ from JAX's for the same seed), then
    moved to ``device`` (the card unless the caller asks for the CPU)."""
    p_shapes, s_shapes = param_shapes(cfg)
    params = {}
    for key, shape in p_shapes.items():
        if key.endswith(".bias"):
            t = torch.zeros(shape)
        elif key.endswith(".scale"):
            t = torch.rand(shape, generator=generator)
        else:
            kh, kw, cin, _ = shape
            stdv = 1.0 / (kh * kw * cin) ** 0.5
            t = (torch.rand(shape, generator=generator) * 2 - 1) * stdv
        params[key] = t.to(device)
    state = {key: (torch.zeros(shape) if key.endswith(".mean")
                   else torch.ones(shape)).to(device)
             for key, shape in s_shapes.items()}
    return params, state


# ---------------------------------------------------------------------------
# plain layer-by-layer forward
# ---------------------------------------------------------------------------
#
# Every function takes ``train`` and ``upd``: in train mode each BN writes
# its new running statistics into ``upd`` under its state keys, the flat
# counterpart of the JAX state patches (``_apply_dense_block`` :423,
# ``_merge_block_patches`` :465); ``apply_cu_net`` merges them over the old
# state.


def _bn_nd(cfg: ModelConfig):
    """BN affine dtype per config (None = float32, torch parity)."""
    return getattr(torch, cfg.compute_dtype) if cfg.bn_dtype == "compute" \
        else None


def _bn(params, state, prefix):
    """The ({scale, bias}, {mean, var}) pair of the BN at ``prefix``."""
    return ({"scale": params[f"{prefix}.scale"],
             "bias": params[f"{prefix}.bias"]},
            {"mean": state[f"{prefix}.mean"], "var": state[f"{prefix}.var"]})


def _patch(upd, prefix, new_state):
    upd[f"{prefix}.mean"] = new_state["mean"]
    upd[f"{prefix}.var"] = new_state["var"]


def _norm(params, state, prefix, x, *, cfg, train, upd):
    """Train- or eval-mode BN at ``prefix``, with the config's affine dtype
    and ghost tile; records the new running stats in train mode."""
    y, ns = batch_norm(x, *_bn(params, state, prefix), train=train,
                       norm_dtype=_bn_nd(cfg), tile=cfg.bn_tile)
    if train:
        _patch(upd, prefix, ns)
    return y


def _int8_bottleneck_infer(params, state, prefix, feats, quant: QuantConfig):
    """Eval BN -> ReLU -> quantize to int8 (bits_i) -> integer 1x1 conv with
    the {-1, 0, +1} weights of ``quant_eval_params``, dequantized.

    ``int8_impl="pallas"`` runs the product on the
    ``int8_matmul_dequant`` kernel on a CUDA tensor; ``"lax"`` runs its
    float32 product, exact for these integers. Both compute the same
    numbers bit for bit (``cunet_tpu/models/cu_net.py::
    _int8_bottleneck_infer``)."""
    from cunet_tpu_torch.kernels.quant_matmul import (
        int8_matmul_dequant,
        quantize_activations_i8,
    )

    inv, shift = bn_inference_scale_shift(
        *_bn(params, state, f"{prefix}.norm"))
    x = torch.cat(list(feats), dim=-1)
    y = torch.relu(x.float() * inv + shift)
    y_i8, x_scale = quantize_activations_i8(y, quant.bits_i)
    w2 = params[f"{prefix}.conv"][0, 0]          # (K, Cout)
    k, cout = w2.shape
    if quant.int8_impl == "lax":
        out = (y_i8.reshape(-1, k).float() @ w2.float()) * x_scale
    else:
        out = int8_matmul_dequant(
            y_i8.reshape(-1, k), torch.round(w2).to(torch.int8),
            torch.ones(cout, device=x.device), x_scale)
    return out.reshape(*x.shape[:-1], cout).to(x.dtype)


def _apply_bottleneck(params, state, prefix, feats: Sequence[torch.Tensor],
                      *, cfg, train=False, upd=None, quant=None):
    """BN -> ReLU -> 1x1 over a virtual concat (``prefix`` is the unit), in
    the JAX package's dispatch order (``cu_net.py:290-312``): with an
    ``int8_infer`` quant config the int8 bottleneck (eval only); in train
    mode with ``use_pallas`` and ``bn_tile=0`` the per-bottleneck train
    kernel (it subsumes ``remat="bottleneck"``); else with
    ``remat="bottleneck"`` the plain one under checkpointing; in eval with
    ``use_pallas`` the per-bottleneck eval kernel (float32 affine whatever
    ``bn_dtype``); else the plain one."""
    if quant is not None and quant.int8_infer and not train:
        return _int8_bottleneck_infer(params, state, prefix, feats, quant)
    norm_p, norm_s = _bn(params, state, f"{prefix}.norm")
    p = {"norm": norm_p, "conv": params[f"{prefix}.conv"]}
    if train and cfg.use_pallas and not cfg.bn_tile:
        out, ns = dense_bottleneck_train_pallas(feats, p, norm_s)
    elif not train and cfg.use_pallas:
        out, ns = dense_bottleneck_infer_pallas(feats, p, norm_s)
    elif train and cfg.remat == "bottleneck":
        out, ns = dense_bottleneck_remat(feats, p, norm_s, train=True,
                                         norm_dtype=_bn_nd(cfg),
                                         tile=cfg.bn_tile)
    else:
        out, ns = dense_bottleneck(feats, p, norm_s, train=train,
                                   norm_dtype=_bn_nd(cfg), tile=cfg.bn_tile)
    if train:
        _patch(upd, f"{prefix}.norm", ns)
    return out


def _apply_dual_adapters(params, state, prefix, i: int, feats, *, cfg,
                         train=False, upd=None, quant=None):
    """The ahead and skip adapters of down block ``prefix`` at slot ``i``
    over the same features. In eval with ``use_pallas`` both come from one
    launch of the dual eval kernel, float even for an ``int8_infer`` model
    (JAX's ``_apply_dual_adapters``, ``cu_net.py:396-411``, ignores
    ``quant`` there, while its neck and up adapters run int8); else two
    ``_apply_bottleneck`` calls."""
    ahead, skip = (f"{prefix}.adapters_ahead.{i}",
                   f"{prefix}.adapters_skip.{i}")
    if not train and cfg.use_pallas:
        from cunet_tpu_torch.kernels.bottleneck_infer import (
            fused_dual_bottleneck_infer,
        )

        inv_a, sh_a = bn_inference_scale_shift(
            *_bn(params, state, f"{ahead}.norm"))
        inv_s, sh_s = bn_inference_scale_shift(
            *_bn(params, state, f"{skip}.norm"))
        return fused_dual_bottleneck_infer(
            list(feats), inv_a, sh_a, params[f"{ahead}.conv"], inv_s, sh_s,
            params[f"{skip}.conv"])
    kw = dict(cfg=cfg, train=train, upd=upd, quant=quant)
    return (_apply_bottleneck(params, state, ahead, feats, **kw),
            _apply_bottleneck(params, state, skip, feats, **kw))


def _quantize_input(y, quant):
    """The activation quantizer before a 3x3 conv or a head (bits_i <= 15)."""
    if quant is not None and quant.bits_i <= 15:
        return quan_input(y, quant.bits_i)
    return y


def _checkpointed(fn, upd, *args):
    """``fn(*args, stats)`` under ``torch.utils.checkpoint``: its outputs'
    history is recomputed in the backward, not saved. ``stats`` is a fresh
    dict on every run; the first run's running statistics go into ``upd``,
    the recompute's are dropped. No RNG state is kept: nothing inside
    draws random numbers."""
    def run(*a):
        stats: Dict[str, torch.Tensor] = {}
        return fn(*a, stats), stats

    out, stats = checkpoint(run, *args, use_reentrant=False,
                            preserve_rng_state=False)
    upd.update(stats)
    return out


def _apply_dense_layer(params, state, prefix, feats, *, cfg, train=False,
                       upd=None, quant=None, drop=None):
    """Bottleneck 1x1, then BN -> ReLU [-> quantize] -> 3x3 conv to
    ``growth_rate`` [-> dropout: ``drop`` = (seed, traversal position), or
    the block's threefry key with ``drop_impl="masks"``]; with
    ``remat="layer"`` in train mode all but the dropout checkpointed."""
    def body(feats, upd):
        kw = dict(cfg=cfg, train=train, upd=upd)
        b = _apply_bottleneck(params, state, f"{prefix}.bottleneck", feats,
                              quant=quant, **kw)
        y = _quantize_input(
            relu(_norm(params, state, f"{prefix}.norm2", b, **kw)), quant)
        if cfg.conv3x3_impl == "scatter":
            return conv3x3_scatter(y, params[f"{prefix}.conv2"])
        return conv2d(y, params[f"{prefix}.conv2"], stride=1, padding=1)

    if train and cfg.remat == "layer":
        y = _checkpointed(body, upd, list(feats))
    else:
        y = body(feats, upd)
    if drop is None:
        return y
    masks = cfg.drop_impl == "masks"
    if cfg.use_pallas:                          # the bn_tile=0 kernel path
        from cunet_tpu_torch.kernels.drop_ops import dropout, dropout_masks

        if masks:
            return dropout_masks(y, drop, cfg.drop_rate)
        return dropout(y, *drop, cfg.drop_rate, cfg.bn_tile)
    if masks:
        return y * threefry.bernoulli_mask(drop, y.shape, cfg.drop_rate,
                                           y.dtype, y.device)
    return y * dropmask.batch_mask(*drop, y.shape, cfg.bn_tile,
                                   cfg.drop_rate, y.dtype, y.device)


def _fifo_push(fifo: List, out, i: int, order: int) -> List:
    """FIFO update: append while ``i < order``, then pop the oldest."""
    if i < order:
        return fifo + [out]
    if fifo:
        return fifo[1:] + [out]
    return fifo


def empty_fifos(cfg: ModelConfig) -> Dict:
    return {
        "down": [[] for _ in range(cfg.num_blocks)],
        "neck": [],
        "up": [[] for _ in range(cfg.num_blocks)],
        "intermedia": [],
    }


def _apply_dense_block(params, state, prefix, feats, i: int, fifo: List, *,
                       cfg, requires_skip: bool, train=False, upd=None,
                       quant=None, drop=None):
    """Block position ``prefix`` at slot ``i``: returns ((ahead, skip|None),
    new_fifo)."""
    kw = dict(cfg=cfg, train=train, upd=upd, quant=quant)
    x = list(feats) + list(fifo)
    out = _apply_dense_layer(params, state, f"{prefix}.layers.{i}", x,
                             drop=drop, **kw)
    new_fifo = _fifo_push(fifo, out, i, cfg.order)
    x = x + [out]
    if requires_skip:
        return _apply_dual_adapters(params, state, prefix, i, x,
                                    **kw), new_fifo
    ahead = _apply_bottleneck(params, state, f"{prefix}.adapters_ahead.{i}",
                              x, **kw)
    return (ahead, None), new_fifo


def _block_drops(cfg: ModelConfig, slot_drop) -> List:
    """The dropout handle of each traversal position of a slot whose
    handle is ``slot_drop`` (``_slot_drops``), as ``_drop_handles`` of the
    JAX package keys them: (seed, position) with position down j -> j,
    neck -> nb, up j -> 2nb - j (``drop_impl="prng"``), or the block key
    ``threefry.block_keys`` folds (``"masks"``); None without dropout."""
    npos = 2 * cfg.num_blocks + 1
    if slot_drop is None:
        return [None] * npos
    if cfg.drop_impl == "masks":
        return threefry.block_keys(slot_drop, cfg.num_blocks)
    return [(slot_drop, pos) for pos in range(npos)]


def _apply_hourglass(params, state, x, i: int, fifos: Dict, *, cfg,
                     train=False, upd=None, quant=None, slot_drop=None):
    """num_blocks x (down block -> max pool), neck, num_blocks x (upsample ->
    up block). ``slot_drop``: slot ``i``'s dropout handle (``_slot_drops``).
    Returns (x, fifos)."""
    kw = dict(cfg=cfg, train=train, upd=upd, quant=quant)
    nb = cfg.num_blocks
    drops = _block_drops(cfg, slot_drop)

    skips = []
    for j in range(nb):
        (x, skip), fifos["down"][j] = _apply_dense_block(
            params, state, f"hg.down.{j}", [x], i, fifos["down"][j],
            requires_skip=True, drop=drops[j], **kw)
        skips.append(skip)
        x = max_pool_2x2(x)
    (x, _), fifos["neck"] = _apply_dense_block(
        params, state, "hg.neck", [x], i, fifos["neck"], requires_skip=False,
        drop=drops[nb], **kw)
    for j in reversed(range(nb)):
        x = upsample_nearest_2x(x)
        (x, _), fifos["up"][j] = _apply_dense_block(
            params, state, f"hg.up.{j}", [x, skips[j]], i, fifos["up"][j],
            requires_skip=False, drop=drops[2 * nb - j], **kw)
    return x, fifos


def _apply_intermedia(params, state, x, i: int, fifo: List, *, cfg,
                      train=False, upd=None):
    """Cross-U-Net input adapter: identity at i == 0 (seeding the FIFO),
    else an adapter over [x] + FIFO."""
    if i == 0:
        if cfg.order != 0:
            fifo = fifo + [x]
        return x, fifo
    out = _apply_bottleneck(params, state, f"intermedia.adapters.{i - 1}",
                            [x] + list(fifo), cfg=cfg, train=train, upd=upd)
    return out, _fifo_push(fifo, out, i, cfg.order)


def _apply_head(params, state, prefix, y, *, cfg, train=False, upd=None,
                quant=None):
    """Head: BN -> ReLU [-> quantize] -> 1x1 conv to ``class_num``
    heatmaps."""
    z = relu(_norm(params, state, f"{prefix}.norm", y, cfg=cfg, train=train,
                   upd=upd))
    return conv2d(_quantize_input(z, quant), params[f"{prefix}.conv"],
                  stride=1, padding=0)


def _apply_stem(params, state, x, *, cfg, train=False, upd=None):
    """conv 7x7/2 -> BN -> ReLU -> max pool 2x2."""
    y = conv2d(x, params["stem.conv"], stride=2, padding=3)
    y = relu(_norm(params, state, "stem.norm", y, cfg=cfg, train=train,
                   upd=upd))
    return max_pool_2x2(y)


# ---------------------------------------------------------------------------
# kernel-path weight folding
# ---------------------------------------------------------------------------


def _slot_subtree(tree: Dict[str, torch.Tensor], i: int):
    """Slot ``i`` of a flat params or state dict: slot i of every block
    position (``hg.down.0.layers.bottleneck.conv``), the intermedia adapter
    serving slot i (``inter.*``, absent at i == 0) and head i (``head.*``)."""
    out = {}
    for key, val in tree.items():
        parts = key.split(".")
        if parts[0] == "hg":
            # hg.{down,up}.b.<group>.i.* or hg.neck.<group>.i.*
            at = 4 if parts[1] in ("down", "up") else 3
            if int(parts[at]) == i:
                out[".".join(parts[:at] + parts[at + 1:])] = val
        elif parts[0] == "intermedia":
            if int(parts[2]) == i - 1:
                out[".".join(["inter"] + parts[3:])] = val
        elif parts[0] == "heads":
            if int(parts[1]) == i:
                out[".".join(["head"] + parts[2:])] = val
    return out


def _fold_bn_vec(params, state, prefix) -> torch.Tensor:
    """Eval BN at ``prefix`` -> stacked float32 (2, C) [inv; shift]."""
    return torch.stack(bn_inference_scale_shift(*_bn(params, state, prefix)))


def _hg_wset(bp, bs, prefix, skip: bool, fold_vec2: bool = True):
    """Folded weights of one block position for one slot (``bp``/``bs`` are
    ``_slot_subtree`` dicts, ``prefix`` the position). BN2's scale folds
    into w_b's output columns (the 1x1 conv is linear and has a single
    consumer), leaving an add + ReLU for the kernel epilogue. The int8
    model keeps BN2's full affine instead (``fold_vec2=False``): its
    weights must stay in {-1, 0, +1}."""
    vec2 = _fold_bn_vec(bp, bs, f"{prefix}.layers.norm2")
    w_b = bp[f"{prefix}.layers.bottleneck.conv"]
    if fold_vec2:
        w_b = w_b * vec2[0][None, None, None, :]
        vec2 = torch.stack([torch.ones_like(vec2[0]), vec2[1]])
    d = {
        "vec_b": _fold_bn_vec(bp, bs, f"{prefix}.layers.bottleneck.norm"),
        "w_b": w_b,
        "vec2": vec2,
        "w3": bp[f"{prefix}.layers.conv2"],
        "vec_a": _fold_bn_vec(bp, bs, f"{prefix}.adapters_ahead.norm"),
        "w_a": bp[f"{prefix}.adapters_ahead.conv"],
    }
    if skip:
        d["vec_s"] = _fold_bn_vec(bp, bs, f"{prefix}.adapters_skip.norm")
        d["w_s"] = bp[f"{prefix}.adapters_skip.conv"]
    return d


def slot_args(params, state, cfg: ModelConfig, fold: bool = True
              ) -> List[Dict]:
    """Per-slot folded weights in buffer traversal order (down 0..nb-1,
    neck, up nb-1..0), the intermedia adapter and the head: the argument
    list of the JAX ``fused_model_buf_infer``. ``fold=False`` keeps BN2's
    scale out of the bottleneck weights (the int8 model)."""
    nb = cfg.num_blocks
    out = []
    for i in range(cfg.layer_num):
        p = _slot_subtree(params, i)
        s = _slot_subtree(state, i)
        blocks = ([_hg_wset(p, s, f"hg.down.{j}", True, fold)
                   for j in range(nb)]
                  + [_hg_wset(p, s, "hg.neck", False, fold)]
                  + [_hg_wset(p, s, f"hg.up.{j}", False, fold)
                     for j in reversed(range(nb))])
        inter = None
        if i > 0:
            inter = (_fold_bn_vec(p, s, "inter.norm"), p["inter.conv"])
        head = (_fold_bn_vec(p, s, "head.norm"), p["head.conv"])
        out.append({"inter": inter, "blocks": blocks, "head": head})
    return out


# ---------------------------------------------------------------------------
# kernel train path
# ---------------------------------------------------------------------------


def fused_train_ok(cfg: ModelConfig) -> bool:
    """Whether training runs the whole-slot train kernels (ghost-BN tiles;
    with ``bn_tile == 0`` the layer-by-layer forward runs the per-bottleneck
    train kernel instead, ``_apply_bottleneck``)."""
    return cfg.use_pallas and cfg.bn_tile > 0


def _slot_bn_prefixes(cfg: ModelConfig, i: int, h0: int):
    """(state prefixes, resolution) of each statistic of slot ``i`` in the
    train kernels' emission order: [intermedia] + per position (bottleneck,
    norm2, ahead) + head. A down block's skip adapter normalizes the same
    input as its ahead adapter, so the ahead statistic updates both."""
    nb = cfg.num_blocks
    out = [((f"intermedia.adapters.{i - 1}.norm",), h0)] if i > 0 else []
    pos = ([(f"hg.down.{j}", h0 >> j, True) for j in range(nb)]
           + [("hg.neck", h0 >> nb, False)]
           + [(f"hg.up.{j}", h0 >> j, False) for j in reversed(range(nb))])
    for pre, res, skip in pos:
        adapters = (f"{pre}.adapters_ahead.{i}.norm",) + (
            (f"{pre}.adapters_skip.{i}.norm",) if skip else ())
        out += [((f"{pre}.layers.{i}.bottleneck.norm",), res),
                ((f"{pre}.layers.{i}.norm2",), res), (adapters, res)]
    return out + [((f"heads.{i}.norm",), h0)]


def _slot_state_from_stats(state, stats, cfg: ModelConfig, i: int, h0: int):
    """New running statistics of slot ``i`` from the kernels' per-tile
    (T, 2, C) [mean; biased var]: the tile-averaged mean and tile-averaged
    unbiased variance enter with momentum 0.1 (the ghost-BN rule of
    ``ops.layers.batch_norm``). Returns {state key: tensor}."""
    prefixes = _slot_bn_prefixes(cfg, i, h0)
    if len(prefixes) != len(stats):
        raise ValueError(f"{len(stats)} statistics for {len(prefixes)} BNs")
    upd = {}
    with torch.no_grad():
        for (pres, res), st in zip(prefixes, stats):
            cnt = cfg.bn_tile * res * res
            for pre in pres:
                _patch(upd, pre, running_update(
                    {"mean": state[f"{pre}.mean"],
                     "var": state[f"{pre}.var"]},
                    st[:, 0], st[:, 1], cnt))
    return upd


def _write_slot_state(upd, slot_upd, cfg: ModelConfig, i: int) -> None:
    """Merge one slot's new statistics; head state changes only at anchored
    slots (the reference never runs the other heads)."""
    anchored = (i + 1) in cfg.anchors
    for key, val in slot_upd.items():
        if anchored or not key.startswith("heads."):
            upd[key] = val


def quant_kernel_bits(quant) -> int:
    """bits_i of the slot train kernels; 0 = no activation quantization.
    Weight quantization happens outside the model (``quantize_params``),
    so the kernels add only the two QuanInput points."""
    quant = _active(quant)
    return 0 if quant is None else int(quant.bits_i)


def _fused_slot_train(params, state, y, fifos, *, cfg: ModelConfig,
                      i: int, bits_i: int = 0, slot_drop=None):
    """Slot ``i`` through the train kernels (QuanInput at ``bits_i``,
    dropout from the slot's handle ``slot_drop``, ``_slot_drops``).
    Returns (y_out, new_fifos, head_out, slot_state_updates)."""
    from cunet_tpu_torch.kernels.train_slot import (
        fused_slot_train,
        marshal_slot,
    )

    nb = cfg.num_blocks
    has_inter = i > 0
    L = min(i, cfg.order)
    W = marshal_slot(_slot_subtree(params, i), nb)
    fifos_t = ([fifos["down"][j] for j in range(nb)] + [fifos["neck"]]
               + [fifos["up"][j] for j in reversed(range(nb))])
    drop = {}
    if slot_drop is not None:
        drop = ({"drop_keys": _block_drops(cfg, slot_drop)}
                if cfg.drop_impl == "masks" else {"drop_seed": slot_drop})
    y_out, hm, inter_out, out32s, stats = fused_slot_train(
        y, fifos["intermedia"] if has_inter else [], fifos_t, W, cfg=cfg,
        L=L, has_inter=has_inter, bits_i=bits_i, **drop)
    slot_upd = _slot_state_from_stats(state, stats, cfg, i, y.shape[1])
    if cfg.order == 0:
        return y_out, fifos, hm, slot_upd

    def push(fifo, out):
        return list(fifo) + [out] if i < cfg.order else list(fifo[1:]) + [out]

    new_f = {
        "intermedia": (push(fifos["intermedia"], inter_out) if has_inter
                       else list(fifos["intermedia"]) + [y]),
        "down": [push(fifos["down"][j], out32s[j]) for j in range(nb)],
        "neck": push(fifos["neck"], out32s[nb]),
        "up": [push(fifos["up"][j], out32s[2 * nb - j]) for j in range(nb)],
    }
    return y_out, new_f, hm, slot_upd


def apply_slot_train(params, state, y, fifos, *, cfg: ModelConfig, i: int):
    """Slot ``i`` of the train forward alone, on the config's path (the
    slot train kernels with ``use_pallas``, else layer by layer), its head
    run whatever the anchors. ``y`` is the slot input and ``fifos`` the
    FIFO entries it reads (``empty_fifos`` structure). Returns (y_out,
    new_fifos, head, {state key: new running statistics of the slot}); the
    caller's ``fifos`` are not changed. Holds one slot of the kernel path
    against the plain path on inputs and cotangents of the caller's
    choosing."""
    _check_train_cfg(cfg, None, None)
    check_kernel_dtype(cfg, y.device, train=True)
    if fused_train_ok(cfg):
        return _fused_slot_train(params, state, y, fifos, cfg=cfg, i=i)
    upd: Dict[str, torch.Tensor] = {}
    kw = dict(cfg=cfg, train=True, upd=upd)
    fifos = {k: list(v) for k, v in fifos.items()}
    y, fifos["intermedia"] = _apply_intermedia(
        params, state, y, i, fifos["intermedia"], **kw)
    y, fifos = _apply_hourglass(params, state, y, i, fifos, **kw)
    return y, fifos, _apply_head(params, state, f"heads.{i}", y, **kw), upd


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _active(quant: Optional[QuantConfig]) -> Optional[QuantConfig]:
    """``quant`` if it is an enabled config, else None."""
    return quant if quant is not None and quant.enabled else None


def eval_path(cfg: ModelConfig, quant=None) -> str:
    """The eval forward's path, chosen as ``cunet_tpu/models/cu_net.py::
    apply_cu_net`` chooses it (:1478-1528, :1227-1234): ``"whole_model"``
    (#1, float with no quant config, int8 with ``int8_infer`` and
    ``int8_impl="pallas"``), ``"hourglass"`` (#4 for every slot,
    unquantized, the default flags), ``"blocks"`` (unquantized,
    ``pallas_hourglass=False`` and ``use_scan`` over two or more steady
    slots: #5 for each steady slot, the slots before it layer by layer),
    else ``"layers"`` (layer by layer; with ``use_pallas`` every
    bottleneck on #6). A quantized scan runs layer by layer, JAX's quirk:
    its quantized scan body is ``_scan_block``, not #5."""
    quant = _active(quant)
    if not cfg.use_pallas:
        return "layers"
    if cfg.pallas_whole_model and (quant is None or (
            quant.int8_infer and quant.int8_impl == "pallas")):
        return "whole_model"
    if quant is not None:
        return "layers"
    if cfg.pallas_hourglass:
        return "hourglass"
    if cfg.use_scan and cfg.layer_num - max(cfg.order, 1) >= 2:
        return "blocks"
    return "layers"


def bn0_feature_groups(cfg: ModelConfig) -> int:
    """The most feature groups a bottleneck or adapter reads in training:
    an up block's adapter, over its input, its skip, ``order`` FIFO
    entries and the layer's output."""
    return cfg.order + 3


def check_kernel_dtype(cfg: ModelConfig, device, *, train: bool = False,
                       quant=None) -> None:
    """Raise ``NotImplementedError`` where ``cfg`` would run a CUDA kernel
    path (``use_pallas`` on a CUDA ``device``) in a dtype its kernels do not
    take. bfloat16 and float32 run every path: the float and quantized
    eval paths (whole-model, per-slot, per-block and per-bottleneck
    kernels, the int8 kernels), ghost-BN training (``bn_tile > 0``: the
    slot kernels #8/#9 with their dropout and QuanInput options) and
    whole-batch BN training (``bn_tile=0``: #7 and the mask kernel, at any
    ``order``). Any other dtype raises; ``quant`` does not change the
    answer. In training (``train``) a cotangent wider than the backward
    kernels' plans take raises too, before any step (``_check_train_widths``).
    On the CPU the kernels' plain versions run in any dtype and width."""
    if not cfg.use_pallas or torch.device(device).type != "cuda":
        return
    if cfg.compute_dtype not in ("bfloat16", "float32"):
        raise NotImplementedError(
            f"the CUDA kernels take {cfg.compute_dtype!r} nowhere: use_pallas "
            f"on {device} needs compute_dtype='bfloat16' or 'float32' "
            f"(use_pallas=False runs it on the plain path)")
    if train:
        _check_train_widths(cfg)


def _check_train_widths(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` where a 1x1's output cotangent in
    ``cfg``'s training step (``neck_size * growth_rate`` at a bottleneck,
    ``init_chan_num`` at an adapter, ``class_num`` at a ghost-BN head) is
    wider than a plan of the kernel that takes it: at ``bn_tile=0`` #7's
    ``bwd_reduce`` and ``bwd_dx`` (either dtype), at ``bn_tile > 0`` and
    float32 the slot step's ``affine_dx`` (its bf16 form takes any width).
    The plans themselves are asked, so a wider plan moves the answer."""
    from cunet_tpu_torch.kernels import train_bottleneck as tbk
    from cunet_tpu_torch.kernels import train_ops

    f32 = cfg.compute_dtype == "float32"
    widths = {"neck_size * growth_rate": cfg.neck_size * cfg.growth_rate,
              "init_chan_num": cfg.init_chan_num}
    if cfg.bn_tile:
        if not f32:
            return
        widths["class_num"] = cfg.class_num
        plans = {"affine_dx": train_ops.affine_dx_f32_plan}

        def shape(n):          # (K, N): the width only matters
            return n, n
    else:
        plans = {"bwd_reduce": tbk.reduce_plan_f32 if f32 else tbk.reduce_plan,
                 "bwd_dx": tbk.dx_f32_plan if f32 else tbk.dx_plan}

        def shape(n):          # (M, Ctot, N): one step
            return tbk.DX_ROWS, n, n
    for name, n in widths.items():
        for kernel, plan in plans.items():
            try:
                plan(*shape(n))
            except ValueError as e:
                raise NotImplementedError(
                    f"{cfg.compute_dtype} training with bn_tile="
                    f"{cfg.bn_tile} on the CUDA kernels: {name} of {n} "
                    f"outputs is past {kernel}'s kernel: {e} "
                    f"(use_pallas=False runs it on the plain path)") from None


def eval_slots(params, state, cfg: ModelConfig, quant=None):
    """Kernel operands of the whole-model and per-slot eval forwards (BN
    folded, padded, int8 matrices for an int8 ``quant``), built once and
    reused across calls through ``apply_cu_net(..., slots=)``."""
    from cunet_tpu_torch.kernels.model_buf import marshal_slots

    quant = _active(quant)
    return marshal_slots(
        slot_args(params, state, cfg, fold=quant is None), cfg,
        dtype=getattr(torch, cfg.compute_dtype),
        quant_bits_i=quant.bits_i if quant is not None else 0)


def block_slots(params, state, cfg: ModelConfig):
    """Kernel operands of the per-block eval (#5): :func:`eval_slots`'
    marshalling of the float model with BN2 unfolded (``slot_args(...,
    fold=False)``): each block keeps its raw bottleneck weight and BN2's
    (2, Cb) [inv2; shift2] as ``vec2``, as JAX's ``_fused_block_slot``
    passes them (``cu_net.py:875-883``). Built once and reused through
    ``apply_cu_net(..., slots=)``."""
    from cunet_tpu_torch.kernels.model_buf import marshal_slots

    return marshal_slots(slot_args(params, state, cfg, fold=False), cfg,
                         dtype=getattr(torch, cfg.compute_dtype),
                         bn2_affine=True)


def path_slots(params, state, cfg: ModelConfig, quant=None):
    """The kernel operands the eval path of ``cfg`` and ``quant`` reads
    (:func:`eval_slots` or :func:`block_slots`), or None for the
    layer-by-layer path, which reads ``params`` directly."""
    path = eval_path(cfg, quant)
    if path in ("whole_model", "hourglass"):
        return eval_slots(params, state, cfg, quant)
    if path == "blocks":
        return block_slots(params, state, cfg)
    return None


def _fused_slot_eval(y, fifos, slot, *, cfg: ModelConfig, head: bool):
    """A steady slot on the per-block eval kernels (``slot`` is its entry
    of :func:`block_slots`), as JAX's ``_fused_slot_eval``
    (``cu_net.py:1146-1181``) runs it: one :func:`fused_dense_block_infer`
    per block position, the intermedia adapter riding down block 0 as its
    pre-stage (its output pushed to the intermedia FIFO when ``order >
    0``), the pools folded into the down blocks' stores, the upsamples into
    the up blocks' reads, and with ``head`` the head riding up block 0
    (JAX computes every steady slot's head and keeps the anchored ones; the
    port runs only those). Every FIFO pops its oldest entry and pushes the
    block's out32; ``order=0`` keeps none. Returns (y_out, new_fifos,
    head or None)."""
    from cunet_tpu_torch.kernels.fused_block import fused_dense_block_infer

    nb, emit = cfg.num_blocks, cfg.order > 0
    blocks = slot["blocks"]

    def push(fifo, outs):
        return list(fifo[1:]) + [outs[0]] if emit else list(fifo)

    def block(pos, feats, fifo, **kw):
        ws = blocks[pos]
        skip = (ws["vec_s"], ws["w_s"]) if "w_s" in ws else ()
        return list(fused_dense_block_infer(
            list(feats) + list(fifo), ws["vec_b"], ws["w_b"], ws["vec2"],
            ws["w3"], ws["vec_a"], ws["w_a"], *skip, emit_layer_out=emit,
            **kw))

    inter = list(fifos["intermedia"])
    vec_p, w_p = slot["inter"]
    down, skips = [], []
    for j in range(nb):
        pre = {} if j else dict(pre_features=[y] + inter, pre_vec=vec_p,
                                pre_w=w_p, emit_pre_out=emit)
        outs = block(j, [y], fifos["down"][j], pool_ahead=True, **pre)
        y, skip = outs[0], outs[1]
        skips.append(skip)
        down.append(push(fifos["down"][j], outs[2:]))
        if j == 0 and emit:
            inter = inter[1:] + [outs[-1]]
    outs = block(nb, [y], fifos["neck"])
    y, neck = outs[0], push(fifos["neck"], outs[1:])
    up, hm = [None] * nb, None
    for j in reversed(range(nb)):
        kw = {}
        if j == 0 and head:
            vec_h, w_h = slot["head"]
            kw = dict(head_vec=vec_h, head_w=w_h[:, :cfg.class_num])
        outs = block(2 * nb - j, [y, skips[j]], fifos["up"][j],
                     upsample_first=True, **kw)
        y = outs[0]
        up[j] = push(fifos["up"][j], outs[1:])
        if kw:
            hm = outs[-1]
    return y, {"intermedia": inter, "down": down, "neck": neck,
               "up": up}, hm


def _fused_slot_eval_hg(y, fifos, slot, *, cfg: ModelConfig, i: int):
    """Slot ``i`` on the per-slot eval kernels (``slot`` is its entry of
    :func:`eval_slots`), with the FIFO bookkeeping of JAX's
    ``_fused_slot_eval_hg`` (``cu_net.py:936-1000``): slot 0 has no
    intermedia adapter and seeds the intermedia FIFO with its input; growth
    slots (i < order) append their outputs, steady slots pop the oldest and
    push; ``order=0`` keeps no FIFO and emits no layer outputs. Returns
    (y_out, new_fifos, head)."""
    from cunet_tpu_torch.kernels.hourglass import fused_hourglass_infer

    nb, order = cfg.num_blocks, cfg.order
    has_inter = i > 0
    emit = order > 0
    block_fifos = ([fifos["down"][j] for j in range(nb)] + [fifos["neck"]]
                   + [fifos["up"][j] for j in reversed(range(nb))])
    inter_vec, inter_w = slot["inter"] if has_inter else (None, None)
    vec_h, w_h = slot["head"]
    outs = fused_hourglass_infer(
        y, fifos["intermedia"] if has_inter else [], inter_vec, inter_w,
        block_fifos, slot["blocks"], vec_h, w_h[:, :cfg.class_num],
        num_blocks=nb, n_fifo=min(i, order), emit_layer_out=emit)
    y_out, hm = outs[0], outs[1]
    if not emit:
        return y_out, fifos, hm

    def push(fifo, out):
        return list(fifo) + [out] if i < order else list(fifo[1:]) + [out]

    if has_inter:
        new_inter, louts = push(fifos["intermedia"], outs[2]), outs[3:]
    else:
        new_inter, louts = list(fifos["intermedia"]) + [y], outs[2:]
    return y_out, {
        "intermedia": new_inter,
        "down": [push(fifos["down"][j], louts[j]) for j in range(nb)],
        "neck": push(fifos["neck"], louts[nb]),
        "up": [push(fifos["up"][j], louts[2 * nb - j]) for j in range(nb)],
    }, hm


def _check_train_cfg(cfg: ModelConfig, drop_seeds, drop_key) -> None:
    if cfg.drop_rate <= 0:
        return
    if cfg.drop_impl == "masks":
        if drop_key is None:
            raise ValueError(
                "drop_impl='masks' in train mode needs drop_key, the step's "
                "threefry key; train_step folds its rng= with the step")
        threefry.as_key(drop_key)
    elif drop_seeds is None or len(drop_seeds) != cfg.layer_num:
        raise ValueError(
            f"drop_rate > 0 in train mode needs drop_seeds, one int32 "
            f"per slot ({cfg.layer_num}); train_step draws them from "
            f"its generator")


def _slot_drops(cfg: ModelConfig, train: bool, drop_seeds,
                drop_key) -> List:
    """Each slot's dropout handle: its int32 seed (``drop_impl="prng"``),
    or its threefry key ``fold_in(drop_key, i)`` (``"masks"``, as the JAX
    package folds the slot into the step key); None without dropout."""
    if not train or cfg.drop_rate <= 0:
        return [None] * cfg.layer_num
    if cfg.drop_impl == "masks":
        key = threefry.as_key(drop_key)
        return [threefry.fold_in(key, i) for i in range(cfg.layer_num)]
    return list(drop_seeds)


def apply_cu_net(params, state, x: torch.Tensor, *, cfg: ModelConfig,
                 train: bool = False, slots=None, quant=None,
                 drop_seeds=None, drop_key=None):
    """Forward: stem -> K x (intermedia -> hourglass [-> head if anchored]).

    Args:
      x: (N, H, W, 3) NHWC input, cast to ``cfg.compute_dtype``.
      train: batch statistics (per ``cfg.bn_tile`` images) and new running
        statistics; gradients reach float32 ``params`` by autograd. With
        ``cfg.use_pallas`` every slot runs the slot train kernels
        (:mod:`cunet_tpu_torch.kernels.train_slot`), or with ``bn_tile=0``
        every bottleneck and adapter the per-bottleneck train kernel
        (:mod:`cunet_tpu_torch.kernels.train_bottleneck`); ``cfg.remat``
        checkpoints the layer-by-layer paths.
      slots: eval kernel-path weights from :func:`path_slots` (for the
        same ``quant``: :func:`eval_slots` for the whole-model and
        per-slot paths, :func:`block_slots` for the per-block path), reused
        across calls; built from ``params`` / ``state`` when None.
      quant: an enabled ``QuantConfig`` runs the quantized model
        (``params`` from ``quant_eval_params`` in eval, ``quantize_params``
        of the masters in train): activation quantizers before every 3x3
        conv and head (in train on either path, in the slot kernels with
        ``use_pallas``), and in eval with ``int8_infer`` int8 block 1x1
        convs, on the whole-model int8 kernels with ``pallas_whole_model``
        and ``int8_impl="pallas"``, else layer by layer (with
        ``use_pallas`` the float bottlenecks and adapter pairs on the
        per-bottleneck eval kernels).
      drop_seeds: with ``cfg.drop_rate > 0`` in train mode, one int32
        dropout seed per slot (``ops.dropmask.draw_slot_seeds``); ignored
        in eval.
      drop_key: with ``cfg.drop_impl="masks"`` instead, the step's
        threefry key (a (2,) uint32 array or tensor, or a pair of ints:
        JAX's ``fold_in(rng, step)``); ``ValueError`` for any other key,
        such as a (4,) rbg key.
    Returns:
      (list of (N, H/4, W/4, class_num) heatmaps, one per loss anchor in
      U-Net order, state) -- the state is unchanged in eval, and in train
      a new dict with every BN's updated running statistics.

    Raises ``NotImplementedError`` for ``use_pallas`` on a CUDA tensor in
    a dtype its kernels do not take: bfloat16 runs every path, float32 the
    float eval and unquantized training (:func:`check_kernel_dtype`).
    """
    quant = _active(quant)
    check_kernel_dtype(cfg, x.device, train=train, quant=quant)
    path = None if train else eval_path(cfg, quant)
    if train:
        _check_train_cfg(cfg, drop_seeds, drop_key)
    x = x.to(getattr(torch, cfg.compute_dtype))
    upd: Dict[str, torch.Tensor] = {}
    kw = dict(cfg=cfg, train=train, upd=upd)
    y = _apply_stem(params, state, x, **kw)
    outs: List[torch.Tensor] = []
    fifos = empty_fifos(cfg)

    drops = _slot_drops(cfg, train, drop_seeds, drop_key)
    if train and fused_train_ok(cfg):
        for i in range(cfg.layer_num):
            y, fifos, hm, slot_upd = _fused_slot_train(
                params, state, y, fifos, cfg=cfg, i=i,
                bits_i=quant_kernel_bits(quant), slot_drop=drops[i])
            _write_slot_state(upd, slot_upd, cfg, i)
            if (i + 1) in cfg.anchors:
                outs.append(hm)
        return outs, {**state, **upd}

    if not train and slots is None:
        slots = path_slots(params, state, cfg, quant)
    if path == "whole_model":
        from cunet_tpu_torch.kernels.model_buf import model_buf_infer

        out = model_buf_infer(y, slots, cfg)
        return [out[:, k] for k in range(out.shape[1])], state
    if path == "hourglass":
        for i in range(cfg.layer_num):
            y, fifos, hm = _fused_slot_eval_hg(y, fifos, slots[i], cfg=cfg,
                                               i=i)
            if (i + 1) in cfg.anchors:
                outs.append(hm)
        return outs, state

    start = max(cfg.order, 1)
    for i in range(cfg.layer_num):
        if path == "blocks" and i >= start:
            anchored = (i + 1) in cfg.anchors
            y, fifos, hm = _fused_slot_eval(y, fifos, slots[i], cfg=cfg,
                                            head=anchored)
            if anchored:
                outs.append(hm)
            continue

        def slot(y, fifos, upd, i=i):
            """Slot i's intermedia adapter and hourglass on a copy of the
            FIFOs (a checkpoint's recompute must find its inputs as they
            were)."""
            fifos = {k: [list(f) for f in v] if k in ("down", "up")
                     else list(v) for k, v in fifos.items()}
            kw = dict(cfg=cfg, train=train, upd=upd)
            y, fifos["intermedia"] = _apply_intermedia(
                params, state, y, i, fifos["intermedia"], **kw)
            return _apply_hourglass(params, state, y, i, fifos, quant=quant,
                                    slot_drop=drops[i], **kw)

        if train and cfg.remat == "block":
            y, fifos = _checkpointed(slot, upd, y, fifos)
        else:
            y, fifos = slot(y, fifos, upd)
        if (i + 1) in cfg.anchors:
            outs.append(_apply_head(params, state, f"heads.{i}", y,
                                    quant=quant, **kw))
    return outs, ({**state, **upd} if train else state)
