"""Device times of ``table_dot``'s forms and the per-slot forward of a
checkout, for comparing two checkouts on one card.

    python -m cunet_tpu_torch.tools.table_dot_times [--root DIR]

Imports ``chip_smoke`` and ``cunet_tpu_torch`` from ``--root`` (default:
the checkout holding this file), builds that checkout's kernels, runs the
smoke's phase 10 ``table_dot`` cases (single, ``[shift2]``, ``[dual]``,
heads; batch 8 and 64) and, where that checkout has it, phase 11 (a)
(``[up]``, ``[pool]``, ``[scale]``), each against its plain version and
timed by CUDA-graph replay, then the per-slot forward of CU-Net-8 @256
(JAX's default flags) at batch 8 and 64, three wall-clock times each. To
compare a change with its parent, unpack the parent with ``git archive``
into a gitignored directory and run this once per checkout in one call, in
the order parent, change, change, parent. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2])
    args = ap.parse_args(argv)
    root = str(args.root.resolve())
    sys.path.insert(0, root)
    for name in [m for m in sys.modules
                 if m == "cunet_tpu_torch" or m.startswith("cunet_tpu_torch.")]:
        del sys.modules[name]
    import torch

    import chip_smoke as cs
    from cunet_tpu_torch import ModelConfig
    from cunet_tpu_torch.kernels import buf_ops, build, eval_ops
    from cunet_tpu_torch.models import init_cu_net
    from cunet_tpu_torch.serving import Predictor

    if not torch.cuda.is_available():
        print("table_dot_times: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    print(f"checkout {root}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.lib()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    cs.phase_eval_kernels(torch, eval_ops)
    if hasattr(cs, "phase_block_kernels"):
        cs.phase_block_kernels(torch, buf_ops, eval_ops)
    cfg = ModelConfig(layer_num=8, order=1, class_num=16, loss_num=8,
                      compute_dtype="bfloat16", use_pallas=True)
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0))
    for batch in (cs.BATCH, 64):
        pred = Predictor(cfg, params, state, device="cuda", batch_size=batch)
        ms = [cs.time_forward(torch, pred, batch) for _ in range(3)]
        print(f"per-slot forward batch {batch}: "
              f"{' '.join(f'{m:.3f}' for m in ms)} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
