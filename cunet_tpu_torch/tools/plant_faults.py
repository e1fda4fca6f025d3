"""Planted faults against the quantized-training step check of chip_smoke.

    python -m cunet_tpu_torch.tools.plant_faults

Run from the repo root on one CUDA card. Builds the kernels and, as phase 8
of ``chip_smoke.py`` does, takes the W1/I8/G8 CU-Net-8 @256 plain step
(batch 24, ghost-BN tile 2, bf16) and its same-run control (the plain path
with its BN affine in float32) once. Then it takes the kernel step once as
it is and once under each planted fault: a QuanInput option dropped where
the slot train step hands it to a kernel wrapper, so the kernel runs
without it. Prints each step's metrics beside the control's, the limits
of ``chip_smoke.step_limits`` it breaks, the QuanInput options that never
launched (``chip_smoke`` fails on those too), and how many elements of the
3x3 convs' master gradients differ from the unfaulted step's and how many
sit at the G8 gradient quantizer's clip. Exits non-zero if the unfaulted
step breaks a limit or a fault expected to break one breaks none.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]

# (fault, {wrapper name in kernels/train_slot.py: options forced off},
# whether the step check is expected to see it). dW3 against unquantized z
# is not: it changes about half of the 3x3 master-gradient elements, but
# those are as far from the plain step's in the unfaulted step (relative
# L2 ~1.4: chaotic in bf16) and move no aggregate metric. The launch
# counters and the option's kernel checks catch it instead.
FAULTS = [
    ("conv3x3 forward unquantized", {"conv3x3": {"bits_i": 0}}, True),
    ("conv3x3_dw against unquantized z", {"conv3x3_dw": {"bits_i": 0}},
     False),
    ("conv3x3_dx without the STE gate", {"conv3x3_dx": {"ste": False}},
     True),
    ("head affine_dw against unquantized z", {"affine_dw": {"bits_i": 0}},
     True),
    ("head affine_dx without the STE gate", {"affine_dx": {"ste": False}},
     True),
    ("head unquantized", {"affine_dot": {"bits_i": 0},
                          "affine_dw": {"bits_i": 0},
                          "affine_dx": {"ste": False}}, True),
]


def _forcing(fn, off):
    def call(*args, **kwargs):
        return fn(*args, **{**kwargs, **off})
    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("plant_faults: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    from cunet_tpu_torch import QuantConfig
    from cunet_tpu_torch.kernels import buf_ops, build, train_ops, train_slot
    from cunet_tpu_torch.quant import (preprocess_masters,
                                       selected_conv_predicate)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.lib()
    quant = QuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True)
    cfg, params, state, batch = cs.flagship_train(torch)
    masters = preprocess_masters(params, quant,
                                 selected_conv_predicate(params, "reference"))
    x, t = batch["image"], batch["heatmap"]
    (lp, gp, sp), c = cs.reference_steps(torch, cfg, masters, state, x, t,
                                         True, quant=quant)
    lim = cs.step_limits(c, True)
    print(f"control (plain, f32 BN affine) vs plain: loss rel "
          f"{c['loss']:.4g}, ratio {c['ratio']:.4f}, cosine {c['cos']:.4f}, "
          f"heads {c['heads']:.4g}, BN {c['bn']:.4g}; limits {lim}",
          flush=True)
    conv3 = [key for key in gp if key.endswith("conv2")]
    clip = 1 - 2.0 ** (1 - quant.bits_g)
    ok, g0 = True, None
    for fault, patch, visible in [("none", {}, False)] + FAULTS:
        saved = {name: getattr(train_slot, name) for name in patch}
        for name, off in patch.items():
            setattr(train_slot, name, _forcing(saved[name], off))
        buf_ops.reset_launch_counts()
        train_ops.reset_launch_counts()
        try:
            lk, gk, sk = cs._grads(torch, cfg, masters, state, x, t,
                                   quant=quant)
        finally:
            for name, fn in saved.items():
                setattr(train_slot, name, fn)
        idle = [o for o, n in {**buf_ops.option_counts(),
                               **train_ops.option_counts()}.items() if not n]
        g0 = g0 or gk
        moved = sum(int((gk[key] != g0[key]).sum()) for key in conv3)
        clipped = sum(int((gk[key].abs() == clip).sum()) for key in conv3)
        total = sum(gk[key].numel() for key in conv3)
        k = cs.step_metrics(torch, gk, sk, lk, gp, sp, lp)
        bad = cs.step_failures(k, lim)
        print(f"fault [{fault}]: loss rel {k['loss']:.4g} "
              f"({k['loss'] / c['loss']:.3g}x control), ratio "
              f"{k['ratio']:.4f} ({k['ratio'] / c['ratio']:.4f}x), cosine "
              f"{k['cos']:.4f} ({k['cos'] / c['cos']:.3g}x), heads "
              f"{k['heads']:.4g} ({k['heads'] / c['heads']:.3g}x), BN "
              f"{k['bn']:.4g} ({k['bn'] / c['bn']:.3g}x), 3x3 grads "
              f"{k['conv3']:.4g} ({k['conv3'] / c['conv3']:.3g}x); breaks: "
              f"{'; '.join(bad) or 'nothing'}; options never launched: "
              f"{idle or 'none'}; 3x3 master-grad elements changed from the "
              f"unfaulted step {moved} of {total}, G8-clipped {clipped}",
              flush=True)
        if fault == "none" or visible:
            ok = ok and bool(bad) == visible
    print(f"plant_faults: {'ok' if ok else 'FAILED'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
