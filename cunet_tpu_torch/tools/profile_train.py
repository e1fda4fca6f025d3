"""Device-time breakdown of the CU-Net-8 @256 train step on one GPU.

    python -m cunet_tpu_torch.tools.profile_train [--plain]
        [--out chiprun_out/profile_train.json]

The train step (kernel path, or the plain path with ``--plain``; bf16,
ghost-BN tile 2, ``bn_dtype="compute"``, RMSprop) from the port's init
(seed 0) on numpy images and targets, at batch 24, is warmed up, then
three steps run under ``torch.profiler``. Prints the host wall time per
step, the device time summed by kernel name, launches per step and the
device's busy share. Needs a CUDA device; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from cunet_tpu_torch import ModelConfig, TrainConfig
from cunet_tpu_torch.models import init_cu_net
from cunet_tpu_torch.tools.profile_forward import (
    gpu_name,
    print_report,
    profile_window,
)
from cunet_tpu_torch.train import create_train_state, train_step

FLAGSHIP = ModelConfig(layer_num=8, order=1, class_num=16, loss_num=8,
                       compute_dtype="bfloat16", remat="none",
                       use_pallas=True, bn_tile=2, bn_dtype="compute")
BATCH, ITERS = 24, 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plain", action="store_true",
                    help="profile the plain PyTorch path instead")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    cfg = dataclasses.replace(FLAGSHIP, use_pallas=not args.plain)
    gpu = gpu_name()
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0),
                                device="cuda")
    rng = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(rng.rand(
                 BATCH, 256, 256, 3).astype(np.float32)).cuda(),
             "heatmap": torch.from_numpy(rng.rand(
                 BATCH, 64, 64, cfg.class_num).astype(
                 np.float32)).cuda()}
    st = create_train_state(params, state, TrainConfig(batch_size=BATCH))
    r = dict(batch=BATCH, path="plain" if args.plain else "kernel",
             **profile_window(lambda: train_step(st, batch, cfg=cfg),
                              ITERS))
    print_report(f"train step {r['path']} path, batch {BATCH} ({gpu})",
                 r, top=20)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"gpu": gpu, "torch": torch.__version__, **r}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
