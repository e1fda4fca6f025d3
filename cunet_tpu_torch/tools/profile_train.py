"""Device-time breakdown of the CU-Net-8 @256 train step on one GPU.

    python -m cunet_tpu_torch.tools.profile_train [--plain] [--drop RATE]
        [--drop_impl masks] [--quant] [--bn_tile T] [--dtype float32]
        [--out profile_train.json]

The train step (kernel path, or the plain path with ``--plain``; bf16,
ghost-BN tile 2, ``bn_dtype="compute"``, RMSprop) from the port's init
(seed 0) on numpy images and targets, at batch 24, is warmed up, then
three steps run under ``torch.profiler``. ``--drop RATE`` trains with
dense-layer dropout (seeds from a generator, one set per step; with
``--drop_impl masks`` JAX's threefry masks, the step folded into the key
``PRNGKey(1)``);
``--quant`` runs ``quant_train_step`` with ``QuantConfig(bits_w=1,
bits_i=8, bits_g=8, enabled=True)``; ``--bn_tile 0`` trains with
whole-batch BN statistics (the kernel path then runs every bottleneck and
adapter on the per-bottleneck train kernel); ``--dtype float32`` trains at
``compute_dtype="float32"`` (``bn_dtype`` float32: on the kernel path the
float32 forms of the slot kernels #8/#9 at ``--bn_tile`` 2 or 6, with
``--quant`` their QuanInput forms too, of #7 at ``--bn_tile 0``). Prints
the host
wall time per
step, the device time by category (the hand-written kernels, cuDNN and
cuBLAS, the optimizer's fused update, the rest of torch), by kernel name
and by function (a template's instances summed), launches per step and
the device's busy share. Needs a CUDA device;
there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from cunet_tpu_torch import ModelConfig, QuantConfig, TrainConfig
from cunet_tpu_torch.models import init_cu_net
from cunet_tpu_torch.tools.profile_forward import (
    gpu_name,
    print_report,
    profile_window,
)
from cunet_tpu_torch.train import (
    create_train_state,
    quant_train_step,
    train_step,
)

FLAGSHIP = ModelConfig(layer_num=8, order=1, class_num=16, loss_num=8,
                       compute_dtype="bfloat16", remat="none",
                       use_pallas=True, bn_tile=2, bn_dtype="compute")
W1I8G8 = QuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True)
BATCH, ITERS = 24, 3
LIBRARY = ("cudnn", "cublas", "xmma", "cutlass", "gemm", "conv", "sm90_")


def category(name: str) -> str:
    """The layer a device kernel belongs to, from its (demangled) name:
    the port's own kernels live in an anonymous namespace at top level."""
    low = name.lower()
    if name.startswith("Optimizer.step"):
        return "optimizer step span (overlaps its kernels)"
    if name.startswith("void (anonymous namespace)::") \
            or name.startswith("(anonymous namespace)::"):
        return "hand-written kernels"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "optimizer (RMSprop)"
    if not low.startswith("void at::") and any(k in low for k in LIBRARY):
        return "cuDNN / cuBLAS"
    return "torch glue"


def print_categories(r: dict) -> None:
    cats = {}
    for k in r["kernels"]:
        c = cats.setdefault(category(k["name"]), [0.0, 0.0])
        c[0] += k["ms_per_call"]
        c[1] += k["launches_per_call"]
    r["categories"] = {c: {"ms_per_call": v[0], "launches_per_call": v[1]}
                       for c, v in cats.items()}
    for c, (ms, n) in sorted(cats.items(), key=lambda kv: -kv[1][0]):
        print(f"  {c}: {ms:.3f} ms device, {n:.0f} launches per step")
    # the optimizer's span overlaps its own kernels: the step's kernel time
    # leaves it out
    r["kernel_ms_per_call"] = sum(v[0] for c, v in cats.items()
                                  if not c.startswith("optimizer step span"))
    print(f"  kernels (the span left out): {r['kernel_ms_per_call']:.3f} "
          f"ms device per step")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plain", action="store_true",
                    help="profile the plain PyTorch path instead")
    ap.add_argument("--drop", type=float, default=0.0,
                    help="dense-layer dropout rate")
    ap.add_argument("--drop_impl", default="prng", choices=("prng", "masks"),
                    help="dropout masks: counter-hash seeds or threefry")
    ap.add_argument("--quant", action="store_true",
                    help="W1/I8/G8 quantized training")
    ap.add_argument("--bn_tile", type=int, default=FLAGSHIP.bn_tile,
                    help="ghost-BN tile in images; 0 = whole-batch BN")
    ap.add_argument("--dtype", default=FLAGSHIP.compute_dtype,
                    choices=("bfloat16", "float32"),
                    help="compute dtype (float32: bn_dtype float32 too)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    cfg = dataclasses.replace(FLAGSHIP, use_pallas=not args.plain,
                              drop_rate=args.drop, drop_impl=args.drop_impl,
                              bn_tile=args.bn_tile, compute_dtype=args.dtype)
    if args.dtype == "float32":
        cfg = dataclasses.replace(cfg, bn_dtype="float32")
    gpu = gpu_name()
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(rng.rand(
                 BATCH, 256, 256, 3).astype(np.float32)).cuda(),
             "heatmap": torch.from_numpy(rng.rand(
                 BATCH, 64, 64, cfg.class_num).astype(
                 np.float32)).cuda()}
    st = create_train_state(params, state, TrainConfig(batch_size=BATCH))
    drop = {"generator": torch.Generator().manual_seed(1),
            "rng": np.array([0, 1], np.uint32)}
    if args.quant:
        def step():
            return quant_train_step(st, batch, cfg=cfg, qcfg=W1I8G8, **drop)
    else:
        def step():
            return train_step(st, batch, cfg=cfg, **drop)
    path = "plain" if args.plain else "kernel"
    variant = ([f"drop ({args.drop_impl})"] if args.drop else []) + (
        ["quant"] if args.quant else []) + [f"bn_tile {args.bn_tile}",
                                             args.dtype]
    r = dict(batch=BATCH, path=path, drop=args.drop,
             drop_impl=args.drop_impl, quant=args.quant,
             bn_tile=args.bn_tile, dtype=args.dtype,
             **profile_window(step, ITERS))
    print_report(f"train step {path} path{''.join(' +' + v for v in variant)}"
                 f", batch {BATCH} ({gpu})", r, top=20)
    print_categories(r)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"gpu": gpu, "torch": torch.__version__, **r}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
