"""Device times of ``affine_dot`` and ``affine_dx`` under every layout their
plans can take, and with parts of their kernels taken out: what the plans'
order of preference rests on, and what holds the kernels back.

    python -m cunet_tpu_torch.tools.gemm_sweep [--ablate [VARIANT ...]]

At CU-Net-8 @256's r=64 shapes (``affine_dot``: K=192, 256, 320 -> 128
eval at batch 8, K=192 at batch 64 and per ghost-BN tile at batch 24, the
quantized 128 -> 16 head per tile; ``affine_dx``: K=192 and 320 -> 128 and
the head's STE form at batch 24, tile 2): every row tile (128, 64, 32),
cut of N or K (the fewest groups or blocks, or twice as many) and count
of buffers (3, 2) whose layout fits, with the wrapper's plan replaced by
it, each checked against the plain version (the smoke's bf16 and float32
sum limits) and timed by CUDA-graph replay (``chip_smoke.cuda_time_ms``);
the layout the wrapper's own plan picks is marked.

With ``--ablate`` the plans' own layouts are timed instead on kernels
built from copies of ``csrc`` with one part of the kernels skipped at
run time (the x / dy loads, the prologue or gate, the products, the
output stores; the results are then wrong and not checked): the time
each part adds. The ablation also times TPU kernel #7's two GEMMs at the
smoke's r=64 adapter (K=128+128+32+32 -> 128, batch 24): ``apply``
(``affine_dot``'s table form, so its parts go with ``affine_dot``'s) and
``bwd_dx`` (its x / g loads, the recompute and gate of its epilogue,
its three-plane product, its dx stores), and ``affine_dx[f32]`` at the
smoke's r=64 ghost-BN case (K=192 -> 128, batch 24, tile 2), whose
variant "one dy plane" packs each dy pair once into bf16 in place of its
exact three-plane split (the six products still run): the time of the
split, which each of its two warpgroups makes for every dy element it
reads. It also times the float32 forward 1x1 (``csrc/fwd_f32_kernels.cu``)
at ``affine_dot[f32,tile]``'s smoke case (K=192 -> 128, r=64, batch 24,
tile 2) and #7's ``apply[f32]`` at r=64 (K=128+128+32+32 -> 128), whose
variants "fwd no prologue" (the BN + ReLU prologue skipped, on the
fragments in registers or in place on the staged rows) and "fwd one x
plane" (each x pair packed once into bf16 in place of its exact
three-plane split; the six products still run) give the time of the
prologue and of the split, each made once an element in registers on
the fragments. ``--ablate full "one dy
plane"`` builds only those variants. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# (file, text, replacement): each part of the two kernels skipped by a
# condition the compiler cannot fold (a plan field is never negative)
ABLATIONS = {
    "no loads": [
        ("buf_kernels.cu",
         "    load_halo(s0 + p.w_bytes + (q % p.stages) * p.stage_bytes,",
         "    if (p.kp < 0) load_halo(s0 + p.w_bytes + (q % p.stages) * "
         "p.stage_bytes,"),
        ("buf_kernels.cu",
         "      load_chunks(s0 + p.w_bytes + (q % p.stages) * p.stage_bytes,",
         "      if (p.kp < 0) load_chunks(s0 + p.w_bytes + (q % p.stages) * "
         "p.stage_bytes,"),
        ("bottleneck_kernels.cu",
         "    load_chunks(base, ch, M, m0, kDxRows, kDxCols, tid, kThreads);",
         "    if (p.np < 0) load_chunks(base, ch, M, m0, kDxRows, kDxCols, "
         "tid, kThreads);"),
        ("bottleneck_kernels.cu",
         "for (int i = tid; i < kDxRows * gv; i += kThreads) {",
         "for (int i = tid; i < kDxRows * gv - (1 << 30); i += kThreads) {"),
        ("train_kernels.cu",
         "    load_halo(base, dy, ldd, M, N, m0, p.bm, 0, p.np, tid, "
         "kThreads);\n    load_halo(base + p.dy_bytes,",
         "    if (p.np < 0) load_halo(base, dy, ldd, M, N, m0, p.bm, 0, p.np, "
         "tid, kThreads);\n    if (p.np < 0) load_halo(base + p.dy_bytes,")],
    "no prologue": [
        ("buf_kernels.cu",
         "    halo_prologue(reinterpret_cast<bf16*>(smem + sb), M, K, m0,",
         "    if (p.kp < 0) halo_prologue(reinterpret_cast<bf16*>(smem + sb), "
         "M, K, m0,"),
        ("train_kernels.cu", "    halo_map(gate, M, K, m0,",
         "    if (p.np < 0) halo_map(gate, M, K, m0,"),
        ("bottleneck_kernels.cu",
         "const float xh = xhat_of(x2[e], mu[j][e], is[j][e]);",
         "const float xh = p.np < 0 ? xhat_of(x2[e], mu[j][e], is[j][e]) "
         ": x2[e];"),
        ("bottleneck_kernels.cu",
         "const float gy = ybn_of(xh, sc[j][e], bb[j][e]) > 0.f",
         "const float gy = p.np >= 0 || ybn_of(xh, sc[j][e], bb[j][e]) > 0.f")],
    "no products": [
        ("buf_kernels.cu", "for (int kk = 0; kk < p.kp / 16; ++kk) {",
         "for (int kk = 0; kk < p.kp / 16 - 4096; ++kk) {"),
        ("train_kernels.cu", "for (int kk = 0; kk < p.np / 16; ++kk) {",
         "for (int kk = 0; kk < p.np / 16 - 4096; ++kk) {"),
        ("bottleneck_kernels.cu", "    gw_product<2>(acc, s0 + sb + p.g_off,",
         "    if (p.np < 0) gw_product<2>(acc, s0 + sb + p.g_off,")],
    "no stores": [
        ("buf_kernels.cu",
         "        if (m < M && n < N) {\n          const int img",
         "        if (m < M && n < N && p.kp < 0) {\n          const int img"),
        ("train_kernels.cu",
         "        if (m < M && k < K) {\n          float4 v",
         "        if (m < M && k < K && p.np < 0) {\n          float4 v"),
        ("bottleneck_kernels.cu", "      if (m0 + r < M && d.ptr)",
         "      if (m0 + r < M && d.ptr && p.np < 0)")],
    "one dy plane": [
        ("dx_f32_kernels.cu",
         "      split_pair(v0.x, v0.y, A[0][0], A[1][0], A[2][0]);\n"
         "      split_pair(v1.x, v1.y, A[0][1], A[1][1], A[2][1]);\n"
         "      split_pair(v2.x, v2.y, A[0][2], A[1][2], A[2][2]);\n"
         "      split_pair(v3.x, v3.y, A[0][3], A[1][3], A[2][3]);\n",
         "      A[0][0] = A[1][0] = A[2][0] = pack_rn(v0.x, v0.y);\n"
         "      A[0][1] = A[1][1] = A[2][1] = pack_rn(v1.x, v1.y);\n"
         "      A[0][2] = A[1][2] = A[2][2] = pack_rn(v2.x, v2.y);\n"
         "      A[0][3] = A[1][3] = A[2][3] = pack_rn(v3.x, v3.y);\n")],
    "fwd no prologue": [
        ("fwd_f32_kernels.cu",
         "    if (!one_tile && pk - k0 < width && pk < a.K) {",
         "    if (!one_tile && pk - k0 < width && pk < a.K && a.kp < 0) {"),
        ("fwd_f32_kernels.cu",
         "      if (one_tile) {\n        const int j = kk / 16;",
         "      if (one_tile && a.kp < 0) {\n        const int j = kk / 16;")],
    "fwd one x plane": [
        ("fwd_f32_kernels.cu",
         "      if (one) {\n        A[0][0] = pack_rn(v0.x, v0.y);",
         "      if (a.kp >= 0) {\n        A[0][0] = A[1][0] = A[2][0] = "
         "pack_rn(v0.x, v0.y);\n        A[1][1] = A[2][1] = pack_rn(v1.x, "
         "v1.y);\n        A[1][2] = A[2][2] = pack_rn(v2.x, v2.y);\n"
         "        A[1][3] = A[2][3] = pack_rn(v3.x, v3.y);")],
}


def _smoke():
    spec = importlib.util.spec_from_file_location("gemm_sweep_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _layouts(layout, k, n):
    seen = []
    for split in (1, 2):
        for bm in (128, 64, 32):
            for stages in ((3,), (2,)):
                p = layout(bm, k, n, split, stages)
                if p is not None and p not in seen:
                    seen.append(p)
    return seen


def _cases(torch):
    """(kernel name, label, K, N, call(out), make_out, plain result, limit
    kind)."""
    from cunet_tpu_torch.kernels import buf_ops, train_ops
    from cunet_tpu_torch.kernels.train_slot import _affine_vec

    gen = torch.Generator().manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(
            "cuda", torch.bfloat16)

    def tile_vec(x, tiles):
        k = x.shape[1]
        if not tiles:
            return torch.stack([torch.rand(k, generator=gen) + 0.5,
                                torch.randn(k, generator=gen) * 0.5]).cuda()
        st = torch.empty(tiles, 2, k, device="cuda")
        train_ops.bn_stats_plain(x, st)
        bn = torch.stack([torch.rand(k, generator=gen) + 0.5,
                          torch.randn(k, generator=gen) * 0.3]).cuda()
        return _affine_vec(st, bn, 1e-5)

    cases = []
    for label, m, tiles, k, n, bits in (
            ("eval batch 8", 8 * 4096, 0, 192, 128, 0),
            ("eval batch 8", 8 * 4096, 0, 256, 128, 0),
            ("eval batch 8", 8 * 4096, 0, 320, 128, 0),
            ("eval batch 64", 64 * 4096, 0, 192, 128, 0),
            ("per tile batch 24", 24 * 4096, 12, 192, 128, 0),
            ("quantized head per tile batch 24", 24 * 4096, 12, 128, 16, 8)):
        x, w = rand(m, k, scale=2.0), rand(k, n, scale=k ** -0.5)
        vec = tile_vec(x, tiles)
        want = torch.empty(m, n, device="cuda", dtype=torch.bfloat16)
        buf_ops.affine_dot_plain(x, vec, w, want, bits_i=bits)
        cases.append(("affine_dot", label, k, n,
                      lambda o, x=x, vec=vec, w=w, bits=bits:
                      buf_ops.affine_dot(x, vec, w, o, bits_i=bits),
                      lambda want=want: torch.empty_like(want), want,
                      ("bf16",)))
    for label, k, n, ste in (("batch 24", 192, 128, False),
                             ("batch 24", 320, 128, False),
                             ("head STE batch 24", 128, 16, True)):
        m = 24 * 4096
        x, w = rand(m, k, scale=2.0), rand(k, n, scale=k ** -0.5)
        vec, dy = tile_vec(x, 12), rand(m, n)
        want = torch.empty(m, k, device="cuda")
        train_ops.affine_dx_plain(dy, w, x, vec, want, ste)
        cases.append(("affine_dx", label, k, n,
                      lambda o, x=x, vec=vec, w=w, dy=dy, ste=ste:
                      train_ops.affine_dx(dy, w, x, vec, o, ste=ste),
                      lambda want=want: torch.empty_like(want), want,
                      ("sum", n)))
    return cases


def _plan_slot(name):
    """(module, plan attribute, layout function) of a kernel's plan."""
    from cunet_tpu_torch.kernels import buf_ops, train_ops

    if name == "affine_dot":
        return buf_ops, "affine_dot_plan", buf_ops._dot_layout
    return train_ops, "affine_dx_plan", train_ops._affine_dx_layout


def _time(torch, cs, case, plan, check):
    """Device us of one case under ``plan``, and its max error (None
    unchecked)."""
    name, _, _, _, call, make_out, want, kind = case
    mod, attr, _ = _plan_slot(name)
    own = getattr(mod, attr)
    setattr(mod, attr, lambda *a: plan)
    try:
        out = make_out()
        call(out)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        if check:
            lim = cs.limit(kind, want.float().abs().max().item())
            cs.require(err <= lim, f"{name} {plan}: {err} > {lim}")
        return cs.cuda_time_ms(lambda: call(out)) * 1e3, err
    finally:
        setattr(mod, attr, own)


def sweep(torch, cs) -> None:
    for case in _cases(torch):
        name, label, k, n = case[:4]
        mod, attr, layout = _plan_slot(name)
        m = case[6].shape[0]
        chosen = getattr(mod, attr)(m, k, n)
        for p in _layouts(layout, k, n):
            us, err = _time(torch, cs, case, p, True)
            print(f"{name} {label} K={k}->{n}: {p}: {us:.1f} us, "
                  f"max_abs_err {err:.3g}{' <- plan' if p == chosen else ''}",
                  flush=True)


def _tb_cases(torch, cs):
    """(name, call(fn) -> outputs, bounds) of #7's ``apply`` and ``bwd_dx``
    at the smoke's r=64 adapter."""
    o = cs.tb_operands(torch, torch.Generator().manual_seed(9), 64)
    return [(name, call, bounds)
            for name, call, bounds, *_ in cs.tb_cases(torch, o)
            if name in ("apply", "bwd_dx")]


def _dx_f32_cases(torch, cs):
    """(row, label, kernel, call(fn) -> outputs, bounds) of
    ``affine_dx[f32]`` at the smoke's r=64 ghost-BN operands, tile 2."""
    from cunet_tpu_torch.kernels import buf_ops, train_ops

    o = cs.slot_f32_operands(torch, train_ops, torch.Generator()
                             .manual_seed(18), 64, cs.BN_TILE)
    return [c[:5] for c in cs.slot_f32_cases(torch, train_ops, buf_ops, o)
            if c[0] == "affine_dx[f32]"]


def _fwd_f32_cases(torch, cs):
    """(row, label, kernel, plain, call(fn) -> outputs, bounds) of the
    float32 forward 1x1: ``affine_dot[f32,tile]`` at the smoke's r=64
    ghost-BN operands, tile 2, and #7's ``apply[f32]`` at r=64."""
    from cunet_tpu_torch.kernels import buf_ops, train_ops
    from cunet_tpu_torch.kernels import train_bottleneck as tbk

    o = cs.slot_f32_operands(torch, train_ops, torch.Generator()
                             .manual_seed(18), 64, cs.BN_TILE)
    cases = [(c[0], f"{c[2]} tile {cs.BN_TILE}", c[1], buf_ops.PLAIN[c[1]],
              c[3], c[4])
             for c in cs.slot_f32_cases(torch, train_ops, buf_ops, o)
             if c[0] == "affine_dot[f32,tile]" and "K=192" in c[2]]
    o = cs.tb_operands(torch, torch.Generator().manual_seed(13), 64,
                       dtype=torch.float32)
    return cases + [("train_bottleneck.apply[f32]",
                     "K=128+128+32+32->128 r=64", tbk.apply,
                     tbk.apply_plain, call, bounds)
                    for name, call, bounds, *_ in cs.tb_cases(torch, o)
                    if name == "apply"]


def ablate(torch, cs, variants) -> None:
    from cunet_tpu_torch.kernels import build, train_ops
    from cunet_tpu_torch.kernels import train_bottleneck as tbk

    tb_cases = _tb_cases(torch, cs)
    dx_cases = _dx_f32_cases(torch, cs)
    fwd_cases = _fwd_f32_cases(torch, cs)
    csrc, build_dir = build.CSRC, build.BUILD_DIR
    work = Path(tempfile.mkdtemp(prefix="gemm_ablate_"))
    try:
        for variant in variants or ["full", *ABLATIONS]:
            src = work / variant.replace(" ", "_")
            shutil.copytree(csrc, src)
            for fname, old, new in ABLATIONS.get(variant, []):
                text = (src / fname).read_text()
                if text.count(old) != 1:
                    raise RuntimeError(f"{variant}: {fname} lost its anchor")
                (src / fname).write_text(text.replace(old, new))
            build.CSRC, build.BUILD_DIR = src, src / "_build"
            build._lib = None
            build.lib()
            for case in _cases(torch):
                name, label, k, n = case[:4]
                if name == "affine_dot" and k != 192:
                    continue
                mod, attr, _ = _plan_slot(name)
                p = getattr(mod, attr)(case[6].shape[0], k, n)
                us, _ = _time(torch, cs, case, p, variant == "full")
                print(f"ablation [{variant}] {name} {label} K={k}->{n} "
                      f"(bm {p.bm}, stages {p.stages}): {us:.1f} us",
                      flush=True)
            for name, call, bounds in tb_cases:
                kern = getattr(tbk, name)
                if variant == "full":
                    ok = cs.output_errors(torch, call(kern),
                                          call(tbk.PLAIN[kern]), bounds)[2]
                    cs.require(ok, f"train_bottleneck.{name} disagrees")
                us = cs.cuda_time_ms(lambda: call(kern)) * 1e3
                print(f"ablation [{variant}] train_bottleneck.{name} "
                      f"K=128+128+32+32->128 r=64 batch 24: {us:.1f} us",
                      flush=True)
            for row, kern, label, call, bounds in dx_cases:
                if variant == "full":
                    ok = cs.output_errors(torch, call(kern),
                                          call(train_ops.PLAIN[kern]),
                                          bounds)[2]
                    cs.require(ok, f"{row} disagrees")
                us = cs.cuda_time_ms(lambda: call(kern)) * 1e3
                print(f"ablation [{variant}] {row} [{label} tile "
                      f"{cs.BN_TILE}]: {us:.1f} us", flush=True)
            for row, label, kern, plain, call, bounds in fwd_cases:
                if variant == "full":
                    ok = cs.output_errors(torch, call(kern), call(plain),
                                          bounds)[2]
                    cs.require(ok, f"{row} disagrees")
                us = cs.cuda_time_ms(lambda: call(kern)) * 1e3
                print(f"ablation [{variant}] {row} [{label}]: {us:.1f} us",
                      flush=True)
    finally:
        build.CSRC, build.BUILD_DIR = csrc, build_dir
        build._lib = None
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ablate", nargs="*", metavar="VARIANT",
                    help="time the kernels with parts taken out: these "
                         "variants (default: full and every ablation)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("gemm_sweep: no CUDA device", file=sys.stderr)
        return 1
    cs = _smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    if args.ablate is None:
        sweep(torch, cs)
    else:
        unknown = set(args.ablate) - {"full", *ABLATIONS}
        if unknown:
            ap.error(f"unknown variants {sorted(unknown)}")
        ablate(torch, cs, args.ablate)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
