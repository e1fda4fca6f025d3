"""Where the float32 train step's paths part from each other.

    python -m cunet_tpu_torch.tools.f32_step_gap [--layers 2] [--size 64]
        [--batch 4] [--full] [--neck_size N] [--growth_rate G] [--seed 0]
        [--smoke_batch] [--bn_tile 0] [--device cuda] [--quant] [--f64]
        [--cancel]

One CU-Net train step at ``compute_dtype="float32"``, ``bn_dtype``
float32, whole-batch BN (``--bn_tile 0``) or ghost-BN tiles of
``--bn_tile`` images, from the port's init (``--seed``) on one batch of
random images and targets (the same seed; with ``--smoke_batch``
``chip_smoke.flagship_train``'s numpy images and Gaussian heatmaps
instead; cuDNN deterministic, TF32 off), on these paths:

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
- with ``--f64``, ``f64``: the plain path in float64 (``compute_dtype=
  "float64"``, ``bn_dtype="compute"``, float64 parameters, and every
  ``.float()`` of the plain ops taken as ``.double()``, so no operation
  rounds to float32), the reference each float32 path is then held to
  leaf by leaf: a leaf where the kernel step lies more than 2x farther
  from it than the swap step does is counted, and the three largest
  ratios' numbers printed for every run (the controls' spread);
- with ``--quant``, every step is W1/I8/G8's (``QuantConfig(bits_w=1,
  bits_i=8, bits_g=8)``): the masters preprocessed once, the selected
  weights fake-quantized in each step, QuanInput in the forward; each
  run's QuanInput codes (the plain quantizer of the inputs its forward's
  quantized ``conv3x3`` / ``affine_dot`` calls get, which the kernels
  quantize bit for bit alike) are compared with the swap step's, and the
  codes that differ printed: a code moves its activation by 2^-7, so one
  flip moves the step far more than the products' own rounding does, and
  every other step of the slot path runs on the kernel step's codes
  (``pinned_codes``), so those pairs compare float rounding alone (the
  plain path, ``use_pallas`` off, keeps its own codes);
- with ghost-BN tiles, ``noise0`` ... : the swap step with the output of
  every form whose kernel rounds otherwise than its plain version (all
  ten but the pool's exact routing) moved by one ulp up or down at random
  in half its elements, ``--perms`` seeds: the distance of a float32
  implementation that rounds where the kernels do; and ``only:<form>``:
  the swap step with one form of the ten on its kernel, how far each
  kernel alone moves it;
- with whole-batch BN, ``noise0`` ... : the swap step with the outputs of
  ``stats`` and ``apply`` (#7's forward, whose kernels sum otherwise than
  their plain versions) moved by one ulp in half their elements; and for
  each of #7's four kernels ``only:<kernel>`` (the swap step with that
  kernel alone on its kernel) and ``swap:<kernel>`` (the kernel step with
  that kernel alone on its plain version): which kernel moves the step.

With ``--cancel`` (whole-batch BN) it first prints the #7 calls of the
kernel step whose single-pass variance E[x^2] - mean^2 cancels most (the
largest mean^2 / var of a column, which multiplies the sums' relative
rounding into the variance's) and those whose variance from ``stats``'
sums lies farthest from float64, beside the plain version's.

Prints, for each pair, the loss's relative difference, the gradients'
relative L2 over all and per leaf (median, the stem's leaves, the worst
leaves against the control's), and the BN running stats'; "over 2x c0"
counts the leaves over twice ``control0``'s deviation, "over 2x c" over
twice the largest of the other controls' (for a control, of the others). The default
sizes are the two-slot card test's; ``--full`` takes CU-Net-8's widths
(``--layers 8 --size 256 --batch 24`` for the smoke's step), and
``--neck_size`` / ``--growth_rate`` override the bottlenecks' (``--full
--layers 2 --size 256 --batch 24 --neck_size 5 --growth_rate 64``: the
smoke's 320-output step). On the CPU
``kernel`` is ``swap`` (the wrappers take their plain versions there).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses

import numpy as np
import torch

from cunet_tpu_torch import ModelConfig, QuantConfig
from cunet_tpu_torch.kernels import buf_ops, train_ops, train_slot
from cunet_tpu_torch.kernels import train_bottleneck as tbk
from cunet_tpu_torch.models import apply_cu_net, init_cu_net
from cunet_tpu_torch.ops import bottleneck
from cunet_tpu_torch.quant import (
    preprocess_masters,
    quantize_params,
    selected_conv_predicate,
)
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
# the plain quantizer, whatever ``pinned_codes`` puts in its place
QUANTIZE = buf_ops.quantize_act
# #7's statistics kernel, whatever ``report_cancel`` puts in its place
STATS = tbk.stats


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


def step(cfg, params, state, x, t, quant=None):
    """(loss, grads, new BN state) of one train step from ``params``; with
    ``quant`` the masters' selected weights fake-quantized first."""
    ps = {k: v.detach().clone().requires_grad_(True)
          for k, v in params.items()}
    run = ps if quant is None else quantize_params(
        ps, quant, selected_conv_predicate(ps, "reference"))
    outs, new_state = apply_cu_net(run, state, x, cfg=cfg, train=True,
                                   quant=quant)
    loss = intermediate_mse(outs, t)
    loss.backward()
    return loss.item(), {k: v.grad for k, v in ps.items()}, new_state


@contextlib.contextmanager
def float64_everywhere():
    """Every ``Tensor.float()`` taken as ``.double()``: the plain ops cast
    their operands to float32 for the statistics and the products (the
    reference's precision); inside, a float64 model computes all of it in
    float64."""
    orig = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.double()
    try:
        yield
    finally:
        torch.Tensor.float = orig


def step_f64(cfg, params, state, x, t):
    """The plain path's step in float64 (``float64_everywhere``): float64
    parameters, state, images and targets; BN affine in the compute dtype.
    Returns it as ``step`` does, every tensor float64."""
    cfg64 = dataclasses.replace(cfg, use_pallas=False,
                                compute_dtype="float64", bn_dtype="compute")
    with float64_everywhere():
        out = step(cfg64, {k: v.double() for k, v in params.items()},
                   {k: v.double() for k, v in state.items()}, x.double(),
                   t.double())
    if not all(g.dtype == torch.float64 for g in out[1].values()
               if g is not None):
        raise RuntimeError("the float64 step computed a float32 gradient")
    return out


@contextlib.contextmanager
def recorded_codes(module, record):
    """Append to ``record``, in call order, the QuanInput codes of every
    quantized call of ``module``'s ``conv3x3`` / ``affine_dot`` (the
    forward's 3x3 convs and heads) and ``conv3x3_dw`` / ``affine_dw``
    (their weight gradients, on the recomputed z), each computed by the
    plain quantizer from the call's own inputs: on the kernel path the
    codes the kernels quantize to, which equal the plain quantizer's on
    the same inputs bit for bit (the card's exact checks)."""
    names = ("conv3x3", "affine_dot", "conv3x3_dw", "affine_dw")
    saved = {n: getattr(module, n) for n in names}

    def codes(x, vec, bits):
        z = torch.relu(buf_ops.tile_affine(x, vec)).to(x.dtype)
        record.append(QUANTIZE(z, bits).detach().clone())

    def conv_rec(y, w3p, b, h, w, out, *, vec=None, bits_i=0):
        if bits_i:
            codes(y, vec, bits_i)
        return saved["conv3x3"](y, w3p, b, h, w, out, vec=vec, bits_i=bits_i)

    def dot_rec(x, vec, w, out, *, bias=None, bits_i=0):
        if bits_i:
            codes(x, vec, bits_i)
        return saved["affine_dot"](x, vec, w, out, bias=bias, bits_i=bits_i)

    def conv_dw_rec(x, vec, dy, b, h, w, out, *, bits_i=0):
        if bits_i:
            codes(x, vec, bits_i)
        return saved["conv3x3_dw"](x, vec, dy, b, h, w, out, bits_i=bits_i)

    def dw_rec(x, vec, dy, out, *, bits_i=0):
        if bits_i:
            codes(x, vec, bits_i)
        return saved["affine_dw"](x, vec, dy, out, bits_i=bits_i)

    for n, f in zip(names, (conv_rec, dot_rec, conv_dw_rec, dw_rec)):
        setattr(module, n, f)
    try:
        yield record
    finally:
        for n, f in saved.items():
            setattr(module, n, f)


@contextlib.contextmanager
def pinned_codes(codes, perm=None, flips=None):
    """The plain quantizer (``quantize_act`` of ``buf_ops`` and
    ``train_ops``, which the slot path's plain versions call once per
    quantized call) returning, call after call, the recorded ``codes``
    (``recorded_codes`` of another run of the same path; with ``perm`` the
    batch permutation that run's images are taken in) instead of its own.
    A step run inside computes with the recorded run's int8 codes, so two
    such steps differ only by their float rounding, not by a code that one
    of them rounds across a boundary (each flip moves an activation by
    2^-7). ``flips`` (a list) gets how many of its own codes differ from the
    pinned ones, call by call."""
    queue = list(codes)

    def pinned(z, bits_i):
        if not bits_i:
            return z
        want = queue.pop(0)
        if perm is not None:
            n = len(perm)
            want = want.reshape(n, -1)[perm].reshape(want.shape)
        if want.shape != z.shape:
            raise RuntimeError(f"pinned codes {tuple(want.shape)} for a "
                               f"call of {tuple(z.shape)}")
        if flips is not None:
            flips.append(int((QUANTIZE(z, bits_i) != want).sum()))
        return want.to(z.dtype)

    with patched(buf_ops, quantize_act=pinned), \
            patched(train_ops, quantize_act=pinned):
        yield
    if queue:
        raise RuntimeError(f"{len(queue)} pinned codes left unused")


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
    ap.add_argument("--neck_size", type=int, default=None)
    ap.add_argument("--growth_rate", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0,
                    help="the init's and the batch's seed")
    ap.add_argument("--cancel", action="store_true",
                    help="the #7 calls whose variance cancels most")
    ap.add_argument("--smoke_batch", action="store_true",
                    help="chip_smoke.py's training batch (its numpy seed 0)")
    ap.add_argument("--bn_tile", type=int, default=0,
                    help="ghost-BN tile in images (0: whole-batch BN)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--perms", type=int, default=3)
    ap.add_argument("--quant", action="store_true",
                    help="W1/I8/G8 quantized training")
    ap.add_argument("--f64", action="store_true",
                    help="also the plain path in float64, the reference")
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
    cfg = dataclasses.replace(
        cfg, neck_size=args.neck_size or cfg.neck_size,
        growth_rate=args.growth_rate or cfg.growth_rate)
    dev = args.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    gen = torch.Generator().manual_seed(args.seed)
    params, state = init_cu_net(cfg, gen, device=dev)
    quant = None
    if args.quant:
        quant = QuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True)
        params = preprocess_masters(
            params, quant, selected_conv_predicate(params, "reference"))
    x = torch.rand(args.batch, args.size, args.size, 3, generator=gen).to(dev)
    t = torch.rand(args.batch, args.size // 4, args.size // 4, cfg.class_num,
                   generator=gen).to(dev)
    if args.smoke_batch:
        from cunet_tpu_torch.tools.kernel_times import _smoke

        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.rand(args.batch, args.size, args.size, 3)
                             .astype(np.float32)).to(dev)
        t = torch.from_numpy(_smoke().gaussian_heatmaps(
            rng, args.batch, cfg.class_num, args.size // 4)).to(dev)
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

    codes = {}
    pin = quant is not None and slot

    def run(name, x, t, fns=None, perm=None):
        """One step; with --quant its codes recorded and, past the kernel
        step, the kernel step's codes pinned."""
        ctx = patched(module, **fns) if fns else contextlib.nullcontext()
        rec = codes.setdefault(name, [])
        with contextlib.ExitStack() as stack:
            stack.enter_context(ctx)
            if quant is not None and slot:
                stack.enter_context(recorded_codes(module, rec))
            if pin and name != "kernel":
                stack.enter_context(pinned_codes(codes["kernel"], perm))
            runs[name] = step(cfg, params, state, x, t, quant)

    runs = {}
    if args.cancel and not slot:
        report_cancel(lambda: step(cfg, params, state, x, t, quant))
    run("kernel", x, t)
    run("swap", x, t, swap)
    for i, q in enumerate(perms):
        run(f"control{i}", x[q], t[q], swap, q)
    if slot:
        for i in range(args.perms):
            gen = torch.Generator(device=dev).manual_seed(23 + i)
            run(f"noise{i}", x, t, slot_swap(gen=gen))
        for name in SLOT_FORMS:
            run(f"only:{name}", x, t, slot_swap(only=name))
    else:
        for i in range(args.perms):
            gen = torch.Generator(device=dev).manual_seed(23 + i)
            run(f"noise{i}", x, t, {**swap, **{
                k.__name__: ulp_noise(tbk.PLAIN[k], gen)
                for k in (tbk.stats, tbk.apply)}})
        for k in tbk.KERNELS:
            name = k.__name__
            run(f"only:{name}", x, t,
                {n: f for n, f in swap.items() if n != name})
            run(f"swap:{name}", x, t, {name: swap[name]})
    runs["plain"] = step(plain_cfg, params, state, x, t, quant)
    if not slot:
        with patched(bottleneck, batch_stats=batch_stats_single_pass):
            runs["plain1"] = step(plain_cfg, params, state, x, t, quant)
    if args.f64:
        if quant is not None:
            ap.error("--f64 takes the float model (no --quant)")
        runs["f64"] = step_f64(cfg, params, state, x, t)
    widths = (f"{'CU-Net-8' if args.full else 'card test'} widths, "
              f"neck_size {cfg.neck_size} x growth_rate {cfg.growth_rate}, "
              f"seed {args.seed}")
    print(f"f32 step gap: layer_num {args.layers}, {args.size} x "
          f"{args.size}, batch {args.batch}, bn_tile {args.bn_tile}, "
          f"{widths}, {'W1/I8/G8, ' if quant else ''}on {dev}; "
          f"losses "
          + ", ".join(f"{k} {v[0]:.9g}" for k, v in runs.items()), flush=True)

    _, gs, ss = runs["swap"]
    keys = [k for k in gs if gs[k].norm() > 0]
    stat_keys = [k for k in ss if ss[k].norm() > 0]
    controls = [f"control{i}" for i in range(args.perms)]
    dev_of = {c: {k: rel(runs[c][1][k], gs[k]) for k in keys}
              for c in controls}
    pairs = [("kernel", "swap")] + [(c, "swap") for c in controls] + [
        (k, "swap") for k in runs
        if k.startswith(("noise", "only:", "swap:"))] + (
        [("kernel", "plain"), ("swap", "plain")] if slot else [
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
    if quant is not None and slot:
        report_codes(codes, perms)
    if args.f64:
        report_f64(runs, keys, stat_keys)
    return 0


def report_cancel(step_fn):
    """Run ``step_fn`` with #7's ``stats`` recorded; print its five calls
    whose single-pass variance E[x^2] - mean^2 cancels most (the largest
    mean^2 / var of a column: the factor by which the sums' relative
    rounding reaches the variance), then the five whose variance from the
    kernel's sums lies farthest from the float64 two-pass variance of the
    same features, each beside the plain version's (``stats_plain``)."""
    calls = []

    def var_of(sums, m):
        mean = sums[0].double() / m
        return sums[1].double() / m - mean * mean, mean

    def rec(xs, out, table=None):
        r = STATS(xs, out, table=table)
        m = xs[0].shape[0]
        var, mean = var_of(r, m)
        cat = torch.cat([x.double() for x in xs], 1)
        var64 = cat.var(0, unbiased=False)
        plain, _ = var_of(tbk.stats_plain(xs, torch.empty_like(r)), m)
        amp = mean * mean / var64.clamp_min(1e-30)
        err = ((var - var64).abs() / var64.clamp_min(1e-30)).max().item()
        perr = ((plain - var64).abs() / var64.clamp_min(1e-30)).max().item()
        calls.append((amp.max().item(), m, r.shape[1], err, perr))
        return r

    # the kernel counts its launches on the module's ``stats``: this one
    rec.launches = rec.f32_launches = 0
    with patched(tbk, stats=rec):
        step_fn()
    for what, key in (("cancellation", 0), ("variance error", 3)):
        top = sorted(range(len(calls)), key=lambda i: calls[i][key],
                     reverse=True)[:5]
        print(f"#7 stats calls by {what} (call: largest mean^2/var, M, Ctot, "
              f"largest relative variance error from the kernel's sums / "
              f"the plain version's): " + ", ".join(
                  f"{i}: {calls[i][0]:.3g}, {calls[i][1]}, {calls[i][2]}, "
                  f"{calls[i][3]:.3g} / {calls[i][4]:.3g}" for i in top)
              + f" of {len(calls)} calls", flush=True)


def report_codes(codes, perms):
    """The QuanInput codes of each run that differ from the swap step's (a
    permuted control's forward holds its images in another order: its codes
    are compared after the permutation is undone)."""
    ref = codes["swap"]
    total = sum(c.numel() for c in ref)
    parts = []
    for name, rec in codes.items():
        if name == "swap" or len(rec) != len(ref):
            continue
        if name.startswith("control"):
            inv = torch.argsort(perms[int(name[7:])])
            rec = [c.reshape(len(inv), -1)[inv].reshape(c.shape)
                   for c in rec]
        parts.append(f"{name} {sum(int((a != b).sum()) for a, b in zip(rec, ref))}")
    print(f"QuanInput codes differing from the swap step's (of {total}): "
          + ", ".join(parts), flush=True)


def report_f64(runs, keys, stat_keys):
    """Each float32 path against the float64 run, leaf by leaf, and the
    leaves (grads, then BN stats, then the loss) where the kernel step
    lies more than 2x farther from float64 than the swap step does."""
    (l64, g64, s64) = runs["f64"]
    dist = {}
    for name in [k for k in runs if k != "f64"]:
        la, ga, sa = runs[name]
        d = {k: rel(ga[k], g64[k]) for k in keys}
        d.update({f"state:{k}": rel(sa[k], s64[k]) for k in stat_keys})
        d["loss"] = abs(la - l64) / abs(l64)
        dist[name] = d
        med = sorted(d.values())[len(d) // 2]
        print(f"{name} vs f64: loss {d['loss']:.4g}; grads over all "
              f"{rel_all(ga, g64, keys):.4g}, median number {med:.4g}, "
              f"largest {max(d.values()):.4g} ({max(d, key=d.get)})",
              flush=True)
    k, s = dist["kernel"], dist["swap"]
    over = {n: (k[n], s[n]) for n in k if k[n] > 2 * s[n]}
    ratio = {n: k[n] / max(s[n], 1e-30) for n in k}
    worst = sorted(ratio, key=ratio.get, reverse=True)[:6]
    print(f"kernel vs swap, each against f64: {len(over)} of {len(k)} "
          f"numbers where the kernel step lies more than 2x farther; "
          f"largest ratios " + ", ".join(
              f"{n} {k[n]:.4g} / {s[n]:.4g} ({ratio[n]:.3g}x)"
              for n in worst), flush=True)
    for n in worst[:3]:
        print(f"{n} against f64, every run: " + ", ".join(
            f"{name} {d[n]:.4g}" for name, d in dist.items()), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
