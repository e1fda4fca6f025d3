"""Device times of a checkout's hand-written kernels at the smoke's cases
and of its per-slot and whole-model forwards, for comparing two checkouts
on one card.

    python -m cunet_tpu_torch.tools.kernel_times [--root DIR]

Runs the kernel phases of the ``chip_smoke.py`` beside this file on the
kernels of ``--root`` (default: the checkout holding this file; its
``cunet_tpu_torch`` is imported and its kernels built): phase 2 (the
forward kernels, ``affine_dot`` at every resolution at batch 8, at r=64
at batch 64 and at every stage width, ``conv3x3`` at every resolution at
batch 8 and 64), phase 4 (the train kernels at batch 24, ``affine_dot``
per tile, ``affine_dx``, ``conv3x3`` per tile and ``conv3x3_dx`` /
``conv3x3_dw`` at every resolution, ``bn_bwd`` and
``affine_dw`` at every resolution and at r=64 at every stage width, with
``accumulate`` and ``bits_i``, beside ``native_batch_norm_backward`` and
``torch.mm``, and their planted faults), phase 8's option
kernels (``conv3x3[bits_i]``, ``conv3x3_dw[bits_i]`` and
``conv3x3_dx[ste]`` at every resolution), phase 9's kernels of #7
(``bwd_reduce`` at every resolution) and phase 7's mask kernel
(``drop_mask``), phase 10 (``table_dot``'s forms) and phase 11 (a)
(``[up]``, ``[pool]``, ``[scale]``; a checkout needs them) and, where the
checkout has them, phase 12 (a) (the float32 eval forms), phase 13 (a)
(the float32 forms of #7 and of the mask kernel), phase 14 (a) (the
float32 forms F1-F10 of the slot kernels #8/#9, at r = 64 ... 4 and
tiles 2 and 6), phase 15 (a) (the QuanInput forms at float32, the int8
kernels' float32 forms, ``table_dot`` over 17 groups) and phase 16 (a),
(b) and (f) (``threefry_mask`` and its float32 form; ``affine_dot`` with
its weight streamed at K = 896 and 1920): each case against its
plain version, timed by CUDA-graph replay beside its library call (or
``torch.mm`` of its product alone) and bound. It also prints a digest of
the bf16 outputs of #7's four kernels, of ``drop_mask`` and, where the
checkout has it, of ``threefry_mask`` on fixed operands (phase 9's at r=64
and r=4, seeded): two checkouts whose digests
agree give those outputs bit for bit; and the digest of phase 5's bf16
ghost-BN kernel step (``chip_smoke.step_digest`` of its loss and grads,
CU-Net-8 @256, batch 24, tile 2), which the smoke prints for its own
checkout. Then the
forward of CU-Net-8 @256 at batch 8 and 64, three wall-clock times each:
the per-slot path (JAX's default flags) and the whole-model path
(``pallas_whole_model``, the main path's serving forward), at bf16 and,
where the checkout has the float32 forms, at float32. The cases come
from this checkout, so two checkouts are timed on the same cases. To
compare a change with its parent, unpack the parent with ``git archive`` into a gitignored
directory and run this once per checkout in one call, in the order parent,
change, change, parent. Needs a CUDA device.

With ``--rows PATTERN`` it runs only the kernel rows of #7 (phases 9 (a)
and 13 (a)) and the float32 rows of phases 14 (a) and 15 (a) whose names
match the regular expression PATTERN, from those phases' own case lists
(``chip_smoke.row_times``: each at r = 64 ... 4, the slot forms at tiles
2 and 6, against its plain version and timed beside its library call or
product alone, its bound and the float32 FMA time of its products; the
wide checks of the rows that match, a digest of #7's outputs at each r
and of the others' at r=64), then the digests (the bf16 outputs, the
bf16 ghost-BN step and the float32 ``bn_tile=0`` step). For example
``--rows 'bwd_dx'`` runs #7's ``bwd_dx`` at bf16 and its float32 form
(``csrc/tb_dx_f32_kernels.cu``, on the g planes the backward hands it,
its time called alone beside; at 160, 192 and 256 outputs and Ctot =
1,920: ``wide_bwd_dx_check``);
``--rows 'affine_dot\\[f32,tile|apply\\[f32'`` runs the float32 forward
1x1 (``csrc/fwd_f32_kernels.cu``): ``affine_dot[f32,tile]`` at tiles 2
and 6 and #7's ``apply[f32]`` (with both at K = 1,920 -> 136, ``apply``
over 17 groups); ``--rows 'bwd_reduce\\[f32|affine_dx\\[f32'``
``bwd_reduce[f32]`` (with its dW against float64 and at Ctot = 1,920) and
``affine_dx[f32]`` / ``[f32,ste]`` (with K = 1,920); ``--rows '_dw\\['``
the float32 weight gradients (with ``affine_dw[f32]`` at K = 1,920);
``--rows 'affine_dot_i8|conv3x3_i8'`` the int8 whole-model kernels and
their float32 forms at phase 6's cases (``int8_kernel_cases``: r=64 and
the ragged cases at batch 8, r=64 at batches 64 and 256, order 14's
widest K, a streamed K, both head widths), each bit for bit its plain
version.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def _smoke():
    """This checkout's ``chip_smoke.py``, loaded by path: its cases time
    whichever ``cunet_tpu_torch`` is imported."""
    spec = importlib.util.spec_from_file_location("kernel_times_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bf16_digests(torch, cs, tbk, dops) -> dict:
    """sha256 (16 hex digits) of the bf16 outputs of #7's four kernels at
    phase 9's operands of r=64 and r=4 (seed 9) and of ``drop_mask``
    (forward in place, backward into bf16) at r=64, batch 24, tile 2."""
    def digest(ts):
        return cs.bytes_digest(torch, ts)

    gen = torch.Generator().manual_seed(9)
    out = {}
    for r in (64, 4):
        o = cs.tb_operands(torch, gen, r)
        for name, call, *_ in cs.tb_cases(torch, o):
            out[f"{name} r={r}"] = digest(call(getattr(tbk, name)))
    m, g, tile = cs.TRAIN_BATCH * 64 * 64, 32, cs.BN_TILE * 64 * 64
    y = torch.randn(m, g, generator=gen).to("cuda", torch.bfloat16)
    d = torch.randn(m, g, generator=gen).cuda()
    fwd = dops.drop_mask(y.clone(), -31, 1, cs.DROP_RATE, tile)
    bwd = dops.drop_mask(d, -31, 1, cs.DROP_RATE, tile,
                         torch.empty(m, g, device="cuda",
                                     dtype=torch.bfloat16))
    out["drop_mask"] = digest([fwd, bwd])
    if hasattr(dops, "threefry_mask"):
        key = (0x13198A2E, 0x03707344)
        fwd = dops.threefry_mask(y.clone(), key, cs.DROP_RATE)
        bwd = dops.threefry_mask(d, key, cs.DROP_RATE, torch.empty(
            m, g, device="cuda", dtype=torch.bfloat16))
        out["threefry_mask"] = digest([fwd, bwd])
    torch.cuda.synchronize()
    return out


def _digests(torch, cs, tbk, dops) -> None:
    """Print ``bf16_digests``, the digest of phase 5's bf16 ghost-BN kernel
    step and, where the checkout has #7's float32 forms, of phase 13's
    float32 ``bn_tile=0`` kernel step and of phase 14's float32 ghost-BN
    kernel steps at tiles 2 and 6 (cuDNN deterministic)."""
    print(f"bf16 output digests: {bf16_digests(torch, cs, tbk, dops)}",
          flush=True)
    cfg, params, state, batch = cs.flagship_train(torch)
    x, t = batch["image"], batch["heatmap"]
    loss, grads, _ = cs._grads(torch, cfg, params, state, x, t)
    print(f"bf16 ghost-BN kernel step digest "
          f"{cs.step_digest(torch, loss, grads)}", flush=True)
    if not hasattr(tbk, "f32_counts"):
        return
    for tile in (0, *cs.SLOT_F32_TILES):
        f32 = dataclasses.replace(cfg, compute_dtype="float32", bn_tile=tile,
                                  bn_dtype="float32")
        torch.backends.cudnn.deterministic = True
        try:
            loss, grads, _ = cs._grads(torch, f32, params, state, x, t)
        finally:
            torch.backends.cudnn.deterministic = False
        what = "bn_tile=0" if tile == 0 else f"ghost-BN tile {tile}"
        print(f"float32 {what} kernel step digest "
              f"{cs.step_digest(torch, loss, grads)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--rows", metavar="PATTERN",
                    help="only the kernel rows matching this regular "
                         "expression, and the digests")
    args = ap.parse_args(argv)
    root = str(args.root.resolve())
    cs = _smoke()
    sys.path.insert(0, root)
    for name in [m for m in sys.modules
                 if m == "cunet_tpu_torch" or m.startswith("cunet_tpu_torch.")]:
        del sys.modules[name]
    import torch

    from cunet_tpu_torch import ModelConfig
    from cunet_tpu_torch.kernels import buf_ops, build, drop_ops, eval_ops
    from cunet_tpu_torch.kernels import quant_ops, train_bottleneck, train_ops
    from cunet_tpu_torch.models import init_cu_net
    from cunet_tpu_torch.serving import Predictor

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
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
    if args.rows is not None:
        cs.row_times(torch, args.rows, train_ops, buf_ops, train_bottleneck,
                     eval_ops)
        _digests(torch, cs, train_bottleneck, drop_ops)
        return 0
    cs.phase_kernels(torch, buf_ops)
    cs.phase_train_kernels(torch, train_ops, buf_ops)
    cs.phase_option_kernels(torch, train_ops, buf_ops)
    cs.phase_bn0_kernels(torch, train_bottleneck)
    cs.drop_mask_checks(torch, drop_ops, {})
    _digests(torch, cs, train_bottleneck, drop_ops)
    cs.phase_eval_kernels(torch, eval_ops)
    cs.phase_block_kernels(torch, buf_ops, eval_ops)
    # the float32 forms, where the checkout has them
    dtypes = ["bfloat16"]
    if hasattr(buf_ops, "dot3_plan"):
        cs.phase_f32_kernels(torch, buf_ops, eval_ops)
        dtypes.append("float32")
    if hasattr(train_bottleneck, "f32_counts"):
        cs.phase_bn0_f32_kernels(torch, train_bottleneck, drop_ops)
    if hasattr(train_ops, "f32_counts"):
        cs.phase_slot_f32_kernels(torch, train_ops, buf_ops,
                                  train_bottleneck)
    if hasattr(train_ops, "f32_option_counts"):
        cs.phase_quant_f32_kernels(torch, train_ops, buf_ops, quant_ops,
                                   eval_ops)
    if hasattr(drop_ops, "threefry_mask"):
        cs.threefry_checks(torch, drop_ops, {})
    if hasattr(buf_ops, "DOT_STREAM_K"):
        cs.stream_dot_checks(torch, buf_ops, {})
    for dtype in dtypes:
        cfg = ModelConfig(layer_num=8, order=1, class_num=16, loss_num=8,
                          compute_dtype=dtype, use_pallas=True)
        params, state = init_cu_net(cfg, torch.Generator().manual_seed(0))
        for path, c in (("per-slot", cfg), ("whole-model",
                                            dataclasses.replace(
                                                cfg, pallas_whole_model=True))):
            for batch in (cs.BATCH, 64):
                pred = Predictor(c, params, state, device="cuda",
                                 batch_size=batch)
                ms = [cs.time_forward(torch, pred, batch) for _ in range(3)]
                print(f"{path} forward {dtype} batch {batch}: "
                      f"{' '.join(f'{m:.3f}' for m in ms)} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
