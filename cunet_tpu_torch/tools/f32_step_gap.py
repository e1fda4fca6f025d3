"""Where the float32 train step's paths part from each other.

    python -m cunet_tpu_torch.tools.f32_step_gap [--layers 2] [--size 64]
        [--batch 4] [--full] [--bn_tile 0] [--device cuda]

One CU-Net train step at ``compute_dtype="float32"``, ``bn_dtype``
float32, whole-batch BN (``--bn_tile 0``) or ghost-BN tiles of
``--bn_tile`` images, from the port's init (seed 0) on one batch of random
images and targets (cuDNN deterministic, TF32 off), on these paths:

- ``kernel``: ``use_pallas``: every bottleneck and adapter on #7's kernels
  (``bn_tile=0``), or every slot on the float32 forms of the slot kernels
  #8/#9 (ghost-BN tiles);
- ``swap``: the same path with those kernels' plain versions swapped in
  (JAX's arithmetic: at bn_tile=0 single-pass variance, and the recompute
  backward);
- ``plain``: ``use_pallas`` off (two-pass variance, autograd's backward);
- ``plain1`` (bn_tile=0): the plain path with its bottlenecks'
  whole-batch variance taken single-pass, E[x^2] - mean^2, as #7 takes it;
- ``control0`` ... : the swap step on the batch permuted, ``--perms``
  ways (only the order of every whole-batch sum changes; with ghost-BN
  tiles the permutation keeps each tile's images together, so only the
  order of each tile's sums changes);
- with ghost-BN tiles, ``noise0`` ... : the swap step with the output of
  every form whose kernel rounds otherwise than its plain version (all
  ten but the pool's exact routing) moved by one ulp up or down at random
  in half its elements, ``--perms`` seeds: the distance of a float32
  implementation that rounds where the kernels do; and ``only:<form>``:
  the swap step with one form of the ten on its kernel, how far each
  kernel alone moves it.

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
from cunet_tpu_torch.kernels import buf_ops, train_ops, train_slot
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


# the ten float32 forms of the slot kernels, by the names kernels/
# train_slot.py calls them; all but the pool's routing (exact) round
# otherwise than their plain versions
SLOT_FORMS = ("bn_stats", "affine_dot", "conv3x3", "affine_dx", "affine_dw",
              "bn_bwd", "conv3x3_dx", "conv3x3_dw", "maxpool2_bwd",
              "upsample2_bwd")
ROUNDED = tuple(f for f in SLOT_FORMS if f != "maxpool2_bwd")


def ulp_noise(fn, gen):
    """``fn`` (a plain version, which returns its output) with the output
    moved by one ulp, up or down at random, in half its elements."""
    def noisy(*args, **kwargs):
        out = fn(*args, **kwargs)
        u = torch.rand(out.shape, generator=gen, device=out.device)
        inf = torch.full_like(out, float("inf"))
        step = torch.nextafter(out, torch.where(u < 0.25, -inf, inf))
        out.copy_(torch.where(u < 0.5, step, out))
        return out
    return noisy


def slot_swap(only=None, gen=None):
    """{name: fn} of the slot path's ten forms: each its plain version,
    ``only`` kept on its kernel; with ``gen`` the plain versions of
    ``ROUNDED`` under ``ulp_noise``."""
    plain = {**buf_ops.PLAIN, **train_ops.PLAIN}
    out = {}
    for name in SLOT_FORMS:
        kern = getattr(train_slot, name)
        if name == only:
            continue
        fn = plain[kern]
        out[name] = ulp_noise(fn, gen) if gen is not None and \
            name in ROUNDED else fn
    return out


def tile_perm(n, bt, gen):
    """A batch permutation that keeps ghost-BN tiles of ``bt`` images
    whole (``chip_smoke.tile_perm``)."""
    order = torch.randperm(n // bt, generator=gen).tolist()
    return torch.cat([t * bt + torch.randperm(bt, generator=gen)
                      for t in order])


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
    ap.add_argument("--bn_tile", type=int, default=0,
                    help="ghost-BN tile in images (0: whole-batch BN)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--perms", type=int, default=3)
    args = ap.parse_args(argv)
    if args.perms < 2:
        ap.error("--perms takes 2 or more (each control is held against "
                 "the others)")

    common = dict(layer_num=args.layers, order=1, compute_dtype="float32",
                  use_pallas=True, bn_tile=args.bn_tile, bn_dtype="float32",
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
    slot = args.bn_tile > 0
    perms = [(tile_perm(args.batch, args.bn_tile, torch.Generator()
                        .manual_seed(17 + i)) if slot else
              torch.randperm(args.batch, generator=torch.Generator()
                             .manual_seed(17 + i))).to(dev)
             for i in range(args.perms)]
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    module = train_slot if slot else tbk
    swap = slot_swap() if slot else {k.__name__: tbk.PLAIN[k]
                                     for k in tbk.KERNELS}

    runs = {"kernel": step(cfg, params, state, x, t)}
    with patched(module, **swap):
        runs["swap"] = step(cfg, params, state, x, t)
        for i, q in enumerate(perms):
            runs[f"control{i}"] = step(cfg, params, state, x[q], t[q])
    if slot:
        for i in range(args.perms):
            gen = torch.Generator(device=dev).manual_seed(23 + i)
            with patched(module, **slot_swap(gen=gen)):
                runs[f"noise{i}"] = step(cfg, params, state, x, t)
        for name in SLOT_FORMS:
            with patched(module, **slot_swap(only=name)):
                runs[f"only:{name}"] = step(cfg, params, state, x, t)
    runs["plain"] = step(plain_cfg, params, state, x, t)
    if not slot:
        with patched(bottleneck, batch_stats=batch_stats_single_pass):
            runs["plain1"] = step(plain_cfg, params, state, x, t)
    widths = "CU-Net-8" if args.full else "card test"
    print(f"f32 step gap: layer_num {args.layers}, {args.size} x "
          f"{args.size}, batch {args.batch}, bn_tile {args.bn_tile}, "
          f"{widths} widths, on {dev}; "
          f"losses "
          + ", ".join(f"{k} {v[0]:.9g}" for k, v in runs.items()), flush=True)

    _, gs, ss = runs["swap"]
    keys = [k for k in gs if gs[k].norm() > 0]
    stat_keys = [k for k in ss if ss[k].norm() > 0]
    controls = [f"control{i}" for i in range(args.perms)]
    dev_of = {c: {k: rel(runs[c][1][k], gs[k]) for k in keys}
              for c in controls}
    pairs = [("kernel", "swap")] + [(c, "swap") for c in controls] + (
        [(k, "swap") for k in runs if k.startswith(("noise", "only:"))]
        + [("kernel", "plain"), ("swap", "plain")] if slot else [
            ("kernel", "plain"), ("swap", "plain"), ("plain1", "plain"),
            ("plain1", "swap")])
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
