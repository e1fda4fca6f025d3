"""Where the float32 whole-batch BN step's paths part from each other.

    python -m cunet_tpu_torch.tools.f32_step_gap [--layers 2] [--size 64]
        [--batch 4] [--full] [--device cuda]

One CU-Net train step at ``compute_dtype="float32"``, ``bn_tile=0``,
``bn_dtype`` float32, from the port's init (seed 0) on one batch of random
images and targets (cuDNN deterministic, TF32 off), on five paths:

- ``kernel``: ``use_pallas``, every bottleneck and adapter on #7's kernels;
- ``swap``: the same path with #7's plain versions swapped in (JAX's
  arithmetic: single-pass variance, the recompute backward);
- ``plain``: ``use_pallas`` off (two-pass variance, autograd's backward);
- ``plain1``: the plain path with its bottlenecks' whole-batch variance
  taken single-pass, E[x^2] - mean^2, as #7 takes it;
- ``control0`` ... : the swap step on the batch permuted, ``--perms``
  ways (only the order of every whole-batch sum changes).

Prints, for each pair, the loss's relative difference, the gradients'
relative L2 over all and per leaf (median, the stem's leaves, the worst
leaves against the control's), and the BN running stats'; "over 2x c0"
counts the leaves over twice ``control0``'s deviation, "over 2x c" over
twice the largest of the other controls' (for a control, of the others). The default
sizes are the two-slot card test's; ``--full`` takes CU-Net-8's widths
(``--layers 8 --size 256 --batch 24`` for the smoke's step). On the CPU
``kernel`` is ``swap`` (the wrappers take their plain versions there).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses

import torch

from cunet_tpu_torch import ModelConfig
from cunet_tpu_torch.kernels import train_bottleneck as tbk
from cunet_tpu_torch.models import apply_cu_net, init_cu_net
from cunet_tpu_torch.ops import bottleneck
from cunet_tpu_torch.train import intermediate_mse


@contextlib.contextmanager
def patched(module, **fns):
    saved = {k: getattr(module, k) for k in fns}
    for k, v in fns.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def batch_stats_single_pass(x32, tile):
    """``ops.layers.batch_stats`` at ``tile`` 0 with #7's variance."""
    assert not tile or tile >= x32.shape[0]
    xt = x32.reshape(-1, x32.shape[-1])
    m = xt.shape[0]
    mean = xt.sum(dim=0) / m
    return mean, (xt * xt).sum(dim=0) / m - mean * mean, m


def step(cfg, params, state, x, t):
    ps = {k: v.detach().clone().requires_grad_(True)
          for k, v in params.items()}
    outs, new_state = apply_cu_net(ps, state, x, cfg=cfg, train=True)
    loss = intermediate_mse(outs, t)
    loss.backward()
    return loss.item(), {k: v.grad for k, v in ps.items()}, new_state


def rel(a, b):
    return ((a.double() - b.double()).norm()
            / b.double().norm().clamp_min(1e-300)).item()


def rel_all(a, b, keys):
    num = sum(((a[k].double() - b[k].double()) ** 2).sum() for k in keys)
    den = sum((b[k].double() ** 2).sum() for k in keys)
    return (num / den).sqrt().item()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--full", action="store_true",
                    help="CU-Net-8's widths (else the card test's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--perms", type=int, default=3)
    args = ap.parse_args(argv)
    if args.perms < 2:
        ap.error("--perms takes 2 or more (each control is held against "
                 "the others)")

    common = dict(layer_num=args.layers, order=1, compute_dtype="float32",
                  use_pallas=True, bn_tile=0, bn_dtype="float32",
                  remat="none")
    if args.full:
        cfg = ModelConfig(class_num=16, loss_num=args.layers, **common)
    else:
        cfg = ModelConfig(loss_num=2, neck_size=2, growth_rate=8,
                          init_chan_num=16, class_num=8, num_blocks=2,
                          **common)
    dev = args.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    gen = torch.Generator().manual_seed(0)
    params, state = init_cu_net(cfg, gen, device=dev)
    x = torch.rand(args.batch, args.size, args.size, 3, generator=gen).to(dev)
    t = torch.rand(args.batch, args.size // 4, args.size // 4, cfg.class_num,
                   generator=gen).to(dev)
    perms = [torch.randperm(args.batch, generator=torch.Generator()
                            .manual_seed(17 + i)).to(dev)
             for i in range(args.perms)]
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    swap = {k.__name__: tbk.PLAIN[k] for k in tbk.KERNELS}

    runs = {"kernel": step(cfg, params, state, x, t)}
    with patched(tbk, **swap):
        runs["swap"] = step(cfg, params, state, x, t)
        for i, q in enumerate(perms):
            runs[f"control{i}"] = step(cfg, params, state, x[q], t[q])
    runs["plain"] = step(plain_cfg, params, state, x, t)
    with patched(bottleneck, batch_stats=batch_stats_single_pass):
        runs["plain1"] = step(plain_cfg, params, state, x, t)
    widths = "CU-Net-8" if args.full else "card test"
    print(f"f32 step gap: layer_num {args.layers}, {args.size} x "
          f"{args.size}, batch {args.batch}, {widths} widths, on {dev}; "
          f"losses "
          + ", ".join(f"{k} {v[0]:.9g}" for k, v in runs.items()), flush=True)

    _, gs, ss = runs["swap"]
    keys = [k for k in gs if gs[k].norm() > 0]
    stat_keys = [k for k in ss if ss[k].norm() > 0]
    controls = [f"control{i}" for i in range(args.perms)]
    dev_of = {c: {k: rel(runs[c][1][k], gs[k]) for k in keys}
              for c in controls}
    pairs = [("kernel", "swap")] + [(c, "swap") for c in controls] + [
        ("kernel", "plain"), ("swap", "plain"), ("plain1", "plain"),
        ("plain1", "swap")]
    for a, b in pairs:
        (la, ga, sa), (lb, gb, sb) = runs[a], runs[b]
        leaf = {k: rel(ga[k], gb[k]) for k in keys}
        others = [c for c in controls if c != a]
        ctrl = {k: max(dev_of[c][k] for c in others) for k in keys}
        ratio = {k: leaf[k] / max(ctrl[k], 1e-30) for k in keys}
        over0 = sum(leaf[k] > 2 * dev_of[others[0]][k] for k in keys)
        worst = sorted(keys, key=ratio.get, reverse=True)[:6]
        med = sorted(leaf.values())[len(leaf) // 2]
        stem = {k: round(leaf[k], 9) for k in keys if k.startswith("stem.")}
        print(f"{a} vs {b}: loss {abs(la - lb) / abs(lb):.4g}; grads over "
              f"all {rel_all(ga, gb, keys):.4g}, median leaf {med:.4g}; "
              f"leaves over 2x c0 ({others[0]}) {over0}, over 2x c "
              f"{sum(r > 2 for r in ratio.values())} of {len(keys)}; BN "
              f"stats over all {rel_all(sa, sb, stat_keys):.4g}, worst "
              f"{max(rel(sa[k], sb[k]) for k in stat_keys):.4g}; stem "
              f"{stem}; worst against c: "
              + ", ".join(f"{k} {leaf[k]:.4g} ({ratio[k]:.3g}x)"
                          for k in worst), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
