"""Device times of the float32 ghost-BN pair, ``bn_bwd`` and ``bn_stats``,
under each candidate cut of a BN tile, at the main path's largest shape.

    python -m cunet_tpu_torch.tools.bn_sweep

At r=64, K=192, batch 24 and BN tiles of 2 and 6 images (the operands of
``chip_smoke.slot_f32_operands``), each kernel runs with its plan replaced
by every cut of ``BWD_CUTS`` / ``STATS_CUTS``: for ``bn_bwd``, writing
d_x and adding into it (``slot_f32_cases``' two cases), the ring of the
portable clusters (``train_ops._bn_bwd_layout``: x and d_a streamed
twice; the parent's kernel and plan at r=64) and the persistent kernel
(``train_ops._bn_bwd_items``; adding into d_x, its staged d_x buffer too)
at 8 to 32 channels and clusters of 8 and 16 blocks; for ``bn_stats``'
one pass, clusters of 2 to 16 blocks. Each line gives the plan, its
shared memory, the time (CUDA-graph replay; ``bn_bwd`` called on fixed
outputs, so the accumulating case's copy of d_x, timed alone beside, is
not in it) and the largest error against the plain version as a share of
the float32 n-term limit; the plans the wrappers choose
(``train_ops.bn_bwd_plan(..., f32=True, accumulate=...)``,
``train_ops.stats_plan_f32``) are marked. Needs a CUDA device; ~2 min
with the build.
"""

from __future__ import annotations

import importlib.util
import itertools
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
# bn_bwd: (persistent, channels a block, blocks a cluster)
BWD_CUTS = ((False, 32, 8), (True, 32, 16), (True, 16, 16), (True, 8, 16),
            (True, 16, 8), (True, 8, 8))
# bn_stats: blocks a cluster
STATS_CUTS = (2, 4, 8, 16)


def _smoke():
    spec = importlib.util.spec_from_file_location("bn_sweep_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    import torch

    from cunet_tpu_torch.kernels import buf_ops, build, train_ops

    if not torch.cuda.is_available():
        print("bn_sweep: no CUDA device", file=sys.stderr)
        return 1
    cs = _smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    build.lib()
    gen = torch.Generator().manual_seed(18)
    for tile in cs.SLOT_F32_TILES:
        o = cs.slot_f32_operands(torch, train_ops, gen, 64, tile)
        m, tr = o["m"], o["tile_rows"]
        k = o["x2"].shape[1]
        cases = [c for c in cs.slot_f32_cases(torch, train_ops, buf_ops, o)
                 if c[0] in ("bn_bwd[f32]", "bn_stats[f32]")]
        bwd = [c for c in cases if c[0] == "bn_bwd[f32]"]
        plans = []
        for (persistent, cb, n), c in itertools.product(BWD_CUTS, bwd):
            acc = "accumulate" in c[2]
            p = (train_ops._bn_bwd_items(cb, n, tr, acc) if persistent
                 else train_ops._bn_bwd_layout(cb, n, tr, 4))
            rows = train_ops.BN_F32_ACC_ROWS if acc else train_ops.BN_F32_ROWS
            if p.smem <= train_ops.SMEM_LIMIT and not (
                    persistent and p.thread_rows > rows):
                plans.append((c, "bn_bwd_plan", p,
                              train_ops.bn_bwd_plan(m, tr, k, True,
                                                    accumulate=acc),
                              f"{'persistent' if persistent else 'ring'} "
                              f"cb={cb} cs={n} rpb={p.rpb} smem {p.smem} B"))
        stats = next(c for c in cases if c[0] == "bn_stats[f32]")
        for n in STATS_CUTS:
            p = (n, -(-(-(-tr // n)) // 32) * 32)
            plans.append((stats, "stats_plan_f32", p,
                          train_ops.stats_plan_f32(m, tr, k),
                          f"one pass cs={n} rpb={p[1]}"))
        # the accumulating case's call copies d_x first; timed without it
        copy_us = cs.cuda_time_ms(lambda: o["dx0"].clone()) * 1e3
        print(f"bn_sweep [tile {tile}] the copy of d_x alone: {copy_us:.1f} "
              f"us (not in the times below)", flush=True)
        d_x, dbn = o["dx0"].clone(), torch.empty(2, k, device="cuda")
        for case, name, p, chosen, text in plans:
            row, kern, label, call, bounds, *_ = case
            want = call(train_ops.PLAIN[kern])
            orig = getattr(train_ops, name)
            setattr(train_ops, name, lambda *a, p=p, **kw: p)

            def timed(kern=kern, call=call, acc="accumulate" in label):
                if row != "bn_bwd[f32]":
                    return call(kern)
                return kern(o["x2"], o["d_a"], o["st2"], o["bn2"], 1e-5, d_x,
                            dbn, accumulate=acc)
            try:
                got = call(kern)
                torch.cuda.synchronize()
                err, share, ok = cs.output_errors(torch, got, want, bounds)
                us = cs.cuda_time_ms(timed) * 1e3
            finally:
                setattr(train_ops, name, orig)
            mark = " (the plan)" if p == chosen else ""
            print(f"bn_sweep {row} [{label} tile {tile}] {text}: {us:.1f} us, "
                  f"{share:.3g} of its limit ({ok}){mark}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
