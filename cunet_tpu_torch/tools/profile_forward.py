"""Device-time breakdown of the CU-Net-8 @256 eval forward on one GPU.

    python -m cunet_tpu_torch.tools.profile_forward [--batch 8 64] [--int8]
        [--path whole_model|hourglass|blocks|layers] [--dtype float32]
        [--out chiprun_out/profile_forward.json]

For each batch size: the forward (kernel path, bf16 or with ``--dtype
float32`` the float32 model on the float32 forms, random weights from
seed 0; with ``--int8`` the quantized W1/I8/G8 model of ``bench.py``'s int8
configuration, weights ``quant_eval_params`` of the same init) is warmed
up, then ``--iters`` forwards run under
``torch.profiler``. Prints the host wall time per forward, the device time
summed by kernel name (the card runs one stream, so kernels do not
overlap) and by function (a template's instances summed), and the
device's busy and idle shares of the window. ``--path``
picks the eval path by its flags: ``whole_model`` (``pallas_whole_model``,
the whole-model kernels, float or int8), ``hourglass`` (JAX's default
flags: every slot on the per-slot kernels; an int8 model runs layer by
layer there), ``blocks`` (``pallas_hourglass=False`` under ``use_scan``:
slot 0 layer by layer, the steady slots on the per-block kernels) or
``layers`` (``pallas_hourglass=False, use_scan=False``: the
per-bottleneck kernels). Needs a CUDA device; there is no CPU
fallback.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import re
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from cunet_tpu_torch.config import ModelConfig, QuantConfig
from cunet_tpu_torch.models import init_cu_net
from cunet_tpu_torch.models.cu_net import eval_path
from cunet_tpu_torch.serving import Predictor
from cunet_tpu_torch.train.quant_step import quant_eval_params

FLAGSHIP = ModelConfig(layer_num=8, order=1, class_num=16, loss_num=8,
                       compute_dtype="bfloat16", use_pallas=True,
                       pallas_whole_model=True)
PATHS = {
    "whole_model": FLAGSHIP,
    "hourglass": dataclasses.replace(FLAGSHIP, pallas_whole_model=False),
    "blocks": dataclasses.replace(FLAGSHIP, pallas_whole_model=False,
                                  pallas_hourglass=False),
    "layers": dataclasses.replace(FLAGSHIP, pallas_whole_model=False,
                                  pallas_hourglass=False, use_scan=False),
}
INT8 = QuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True,
                   int8_infer=True, int8_impl="pallas")


def profile_window(fn, iters: int) -> dict:
    """Run ``fn`` three times to warm up, then ``iters`` times under
    ``torch.profiler``: host wall time per call, device time summed by
    kernel name, launches per call and the device's busy share."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = collections.Counter()
    launches = collections.Counter()
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.name] += evt.time_range.elapsed_us() / 1e3
            launches[evt.name] += 1
    device_ms = sum(by_name.values())
    return {
        "iters": iters,
        "wall_ms_per_call": wall_ms / iters,
        "device_ms_per_call": device_ms / iters,
        "device_busy_share": device_ms / wall_ms,
        "kernels": [
            {"name": name, "ms_per_call": ms / iters,
             "launches_per_call": launches[name] / iters,
             "share_of_device": ms / device_ms}
            for name, ms in by_name.most_common()],
    }


def function_name(name: str) -> str:
    """A kernel's function name without its namespaces, template arguments
    and parameters: one entry for all instances of a template."""
    base = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", base, maxsplit=1)[0].split("::")[-1].strip()


def by_function(r: dict) -> list:
    """(function, ms per call, launches per call, share of device) of the
    kernels in ``r``, template instances summed, the largest first."""
    acc = {}
    for k in r["kernels"]:
        a = acc.setdefault(function_name(k["name"]), [0.0, 0.0, 0.0])
        a[0] += k["ms_per_call"]
        a[1] += k["launches_per_call"]
        a[2] += k["share_of_device"]
    return sorted(([f, *v] for f, v in acc.items()), key=lambda e: -e[1])


def print_report(label: str, r: dict, top: int = 12) -> None:
    print(f"{label}: wall {r['wall_ms_per_call']:.3f} ms/call, device "
          f"{r['device_ms_per_call']:.3f} ms, busy "
          f"{r['device_busy_share']:.3f}")
    for k in r["kernels"][:top]:
        print(f"  {k['ms_per_call']:8.3f} ms {k['share_of_device']:6.3f}"
              f" x{k['launches_per_call']:6.1f}  {k['name'][:90]}")
    r["functions"] = by_function(r)
    print("  by function, template instances summed:")
    for f, ms, n, share in r["functions"][:top]:
        print(f"  {ms:8.3f} ms {share:6.3f} x{n:6.1f}  {f}")


def gpu_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 64])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--int8", action="store_true",
                    help="the quantized model on the int8 kernels")
    ap.add_argument("--path", choices=sorted(PATHS), default="whole_model",
                    help="the eval path, chosen by its config flags")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16", help="the model's compute dtype")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: no CUDA device")
    gpu = gpu_name()
    cfg = dataclasses.replace(PATHS[args.path], compute_dtype=args.dtype)
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0))
    quant = INT8 if args.int8 else None
    if quant is not None:
        params = quant_eval_params(params, quant)
    report = {"gpu": gpu, "torch": torch.__version__, "int8": args.int8,
              "dtype": args.dtype, "path": eval_path(cfg, quant), "runs": []}
    for batch in args.batch:
        pred = Predictor(cfg, params, state, device="cuda",
                         batch_size=batch, quant=quant)
        x = torch.rand(batch, 256, 256, 3, generator=torch.Generator()
                       .manual_seed(1)).to("cuda", pred.dtype)
        r = dict(batch=batch, **profile_window(lambda: pred.forward(x),
                                               args.iters))
        report["runs"].append(r)
        print_report(f"{'int8 ' if args.int8 else ''}{args.dtype} "
                     f"forward, {report['path']} path, batch {batch} "
                     f"({gpu})", r)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
