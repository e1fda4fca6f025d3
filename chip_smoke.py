#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (cunet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line (or a few) before the last:

1. build: the card's name and power limit, torch/CUDA versions, and the
   nvcc build of the kernels from cunet_tpu_torch/csrc;
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes the CU-Net-8 @256 forward gives it (batch 8),
   reading and writing strided views of channel-plane buffers;
3. serving: a Predictor for CU-Net-8 @256 (order 1, 16 classes, 8 loss
   anchors, bf16, kernel path) with random weights from seed 0 answers
   three requests of 8, 5 and 11 images with the flip test; checks shapes,
   finiteness, that every kernel launched, and the kernel path against the
   plain path on the card; times the forward at batch 8 and 64;
4. train kernels: each kernel of the slot train step (and the per-tile
   forms of affine_dot / conv3x3) against its plain version on the card at
   the shapes the CU-Net-8 @256 train step gives it (batch 24, ghost-BN
   tile 2);
5. training: CU-Net-8 @256 (bf16, bn_tile 2, bn_dtype "compute", RMSprop)
   at batch 24 from the port's init (seed 0), numpy images and Gaussian
   target heatmaps: slot 1 alone, kernel path against plain path under a
   cotangent on each output in turn (every input cotangent, weight
   gradient, output and running-stat update, held to a plain-vs-plain
   control); one kernel-path step against one plain-path step from
   the same state (loss, grad-norm ratio, per-leaf cosine against a
   plain-vs-plain control, head grads, BN running stats), a bit-identical
   repeat, three kernel-path train_steps
   that launch every kernel, and the step time, img/s and peak memory of
   both paths;
6. int8 serving: the three int8 kernels against their plain versions at
   the CU-Net-8 @256 int8 shapes and ragged ones (bit-identical); a
   Predictor for the quantized CU-Net-8 (``bench.py``'s int8
   configuration: W1/I8/G8, ``int8_infer``, ``int8_impl="pallas"``;
   ``quant_eval_params`` of the port's init, seed 0) answers the three
   requests on the int8 kernel path (the main path), which must launch the
   int8 kernels; the same forward on the int8 kernels' plain versions is
   bit-identical; the plain path on ``int8_matmul_dequant`` (the second
   path) is bit-identical to ``int8_impl="lax"``; the kernel path against
   the plain path beside a same-run control; forward times at batch 8 and
   64 beside the float kernel path's.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is ``{"ok": true, "device": {...}}``. Any
failed check ends the run with a non-zero exit and no result line. There is
no CPU fallback: without a CUDA device the script exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SOURCE = "cunet_tpu_torch/csrc/buf_kernels.cu"
TRAIN_SOURCE = "cunet_tpu_torch/csrc/train_kernels.cu"
INT8_SOURCE = "cunet_tpu_torch/csrc/quant_kernels.cu"
REPLACES = {
    "affine_dot_i8": "cunet_tpu/kernels/fused_model_buf.py:83",
    "conv3x3_i8": "cunet_tpu/kernels/fused_model_buf.py:316",
    "int8_matmul_dequant": "cunet_tpu/kernels/quant_matmul.py:50",
    "affine_dot": "cunet_tpu/kernels/fused_model_buf.py:52",
    "conv3x3": "cunet_tpu/kernels/fused_hourglass.py:75",
    "maxpool2": "cunet_tpu/kernels/fused_hourglass.py:312",
    "upsample2": "cunet_tpu/kernels/fused_hourglass.py:329",
    "bn_stats": "cunet_tpu/kernels/train_slot.py:179",
    "affine_dx": "cunet_tpu/kernels/train_slot.py:541",
    "affine_dw": "cunet_tpu/kernels/train_slot.py:549",
    "bn_bwd": "cunet_tpu/kernels/train_slot.py:557",
    "conv3x3_dx": "cunet_tpu/kernels/train_slot.py:732",
    "conv3x3_dw": "cunet_tpu/kernels/train_slot.py:732",
    "maxpool2_bwd": "cunet_tpu/kernels/train_slot.py:814",
    "upsample2_bwd": "cunet_tpu/kernels/train_slot.py:847",
    "sum_rows": "cunet_tpu/kernels/train_slot.py:854",
}
# the bf16 output rounds at 2^-8 of its magnitude
REL_BOUND, ABS_BOUND = 2e-2, 1e-2
# a float32 result of an n-term reduction, summed in another order, moves
# by O(sqrt(n) * 2^-24) of its scale; 1e-5 * sqrt(n) leaves a margin ~170
SUM_REL_PER_SQRT_N = 1e-5
PATH_REL_L2 = 3e-2   # kernel path vs plain path: 8 bf16 slots of rounding
BATCH = 8
TRAIN_BATCH, BN_TILE = 24, 2
# kernel train step vs plain train step on the card (PARITY.md:274-288):
# elementwise grads are chaotic at depth, so aggregate bands. The per-leaf
# cosine is chaotic too at this init: the plain path against itself, with
# the stem BN bias moved by CONTROL_NUDGE (below one bf16 ulp of the O(1)
# activations), measures 0.13 on an H100. So the kernel path's mean cosine
# is held against that control, measured in the same run, minus a margin.
LOSS_REL = 1e-2
GRAD_NORM_RATIO = (0.85, 1.18)
CONTROL_NUDGE = 1e-4
COSINE_MARGIN = 0.05
HEADS_REL_L2 = 5e-2
BN_STATE_REL_L2 = 1e-2
# int8 kernel path vs plain path: the mean over anchors of their relative
# L2 may exceed the same-run control's by this much (PERF.md, section 6)
INT8_PATH_MARGIN = 0.05


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_time_ms(fn, iters=20):
    """Device time of one ``fn()``: ``iters`` calls captured in a CUDA graph
    and replayed between two events, so the host's per-call cost (Python,
    argument checks) does not count. Inputs stay warm in the L2 cache, as
    they are when the forward's previous stage has just written them."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_cases(torch, gen):
    """(kernel name, label, callable(fn, out), destination buffer, view
    selector) at the flagship's main-path shapes: c=128, g=32, Cb=128,
    cls=16, h0=64, batch 8."""
    dev = "cuda"
    c, g, cb, cls, h0, n = 128, 32, 128, 16, 64, 8

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(
            dev, torch.bfloat16)

    def vec(k):
        inv = torch.rand(k, generator=gen) + 0.5
        shift = torch.randn(k, generator=gen) * 0.5
        return torch.stack([inv, shift]).to(dev)

    m64 = n * h0 * h0
    down64 = randn(m64, c + g + g)            # [y | fifo | out32]
    up64 = randn(m64, 2 * c + g + g)          # [up_y | skip | fifo | out32]
    inter = randn(m64, 2 * c)                 # [y | fifo]
    heads = randn(n, 8, h0, h0, cls)          # (N, A, h, w, cls)
    cases = []

    # K1: adapter K=192 -> 128 written into the up buffer's skip slot
    v, w = vec(192), randn(192, c, scale=192 ** -0.5)
    cases.append(("affine_dot", "K=192->128 r=64", up64,
                  lambda b: b[:, c:2 * c],
                  lambda f, b: f(down64, v, w, b[:, c:2 * c])))
    # K1: bottleneck K=160 -> 128 with the shift+ReLU epilogue
    v2, w2 = vec(160), randn(160, cb, scale=160 ** -0.5)
    bias = (torch.randn(cb, generator=gen) * 0.5).to(dev)
    y2dst = randn(m64, c + g + g)
    cases.append(("affine_dot", "K=160->128 +shift,relu r=64", y2dst,
                  lambda b: b[:, :cb],
                  lambda f, b: f(down64[:, :160], v2, w2, b[:, :cb],
                                 bias=bias)))
    # K1: head K=128 -> 16 into anchor slot 3 of the stacked head output
    v3, w3 = vec(c), randn(c, cls, scale=c ** -0.5)
    cases.append(("affine_dot", "head K=128->16 r=64", heads,
                  lambda b: b[:, 3],
                  lambda f, b: f(inter[:, :c], v3, w3,
                                 b[:, 3].view(n, h0 * h0, cls))))
    # K2: 3x3 conv into the out32 slot, at r=64 and r=4
    for r in (64, 4):
        m = n * r * r
        y2 = torch.relu(randn(m, cb))
        wk = randn(9 * cb, g, scale=(9 * cb) ** -0.5)
        dst = randn(m, c + g + g)
        cases.append(("conv3x3", f"Cb=128->32 r={r}", dst,
                      lambda b: b[:, c + g:c + 2 * g],
                      lambda f, b, y2=y2, wk=wk, r=r:
                      f(y2, wk, n, r, r, b[:, c + g:c + 2 * g])))
    # K3: pool 64 -> 32 into the next down buffer
    ahead = randn(m64, c)
    down32 = randn(n * 32 * 32, c + g + g)
    cases.append(("maxpool2", "64->32", down32, lambda b: b[:, :c],
                  lambda f, b: f(ahead, n, 64, 64, b[:, :c])))
    # K4: upsample 4 -> 8 and 32 -> 64 into the next up buffer
    for r in (32, 4):
        x = randn(n * r * r, c)
        dst = randn(n * 4 * r * r, 2 * c + g + g)
        cases.append(("upsample2", f"{r}->{2 * r}", dst, lambda b: b[:, :c],
                      lambda f, b, x=x, r=r: f(x, n, r, r, b[:, :c])))
    return cases


def phase_kernels(torch, ops):
    gen = torch.Generator().manual_seed(0)
    results = {}
    for name, label, dst, sel, call in kernel_cases(torch, gen):
        kern = getattr(ops, name)
        plain = ops.PLAIN[kern]
        k_buf, p_buf = dst.clone(), dst.clone()
        call(kern, k_buf)
        call(plain, p_buf)
        torch.cuda.synchronize()
        got, want = sel(k_buf).float(), sel(p_buf).float()
        err = (got - want).abs().max().item()
        bound = REL_BOUND * want.abs().max().item() + ABS_BOUND
        # everything outside the destination view must be untouched
        outside = k_buf.clone()
        sel(outside).copy_(sel(dst))
        untouched = torch.equal(outside, dst)
        ms = cuda_time_ms(lambda: call(kern, k_buf))
        plain_ms = cuda_time_ms(lambda: call(plain, p_buf))
        print(f"kernel {name} [{label}]: max_abs_err {err:.4g} (bound "
              f"{bound:.4g}), outside view untouched {untouched}, "
              f"{ms:.4f} ms vs plain {plain_ms:.4f} ms", flush=True)
        require(np.isfinite(err) and err <= bound,
                f"{name} [{label}] disagrees with its plain version: "
                f"{err} > {bound}")
        require(untouched, f"{name} [{label}] wrote outside its view")
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r.setdefault("ms", ms)          # first case = main-path headline
        r.setdefault("plain_ms", plain_ms)
        r.setdefault("shape", label)
    return results


# ---------------------------------------------------------------------------
# phase 3: serving
# ---------------------------------------------------------------------------


def time_forward(torch, pred, batch, iters=10):
    x = torch.rand(batch, 256, 256, 3, generator=torch.Generator()
                   .manual_seed(1)).to("cuda", pred.dtype)
    for _ in range(3):
        pred.forward(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        pred.forward(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def phase_serving(torch, ops, gpu):
    from cunet_tpu_torch import ModelConfig
    from cunet_tpu_torch.models import init_cu_net
    from cunet_tpu_torch.serving import Predictor

    cfg = ModelConfig(layer_num=8, order=1, class_num=16, loss_num=8,
                      compute_dtype="bfloat16", use_pallas=True,
                      pallas_whole_model=True)
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0))
    pred = Predictor(cfg, params, state, device="cuda", batch_size=BATCH,
                     flip_test=True)
    rng = np.random.RandomState(0)
    requests = [rng.rand(k, 256, 256, 3).astype(np.float32)
                for k in (8, 5, 11)]

    ops.reset_launch_counts()
    answers = []
    for imgs in requests:
        hm = pred.heatmaps(imgs)
        pts = pred.predict(imgs)
        answers.append((hm, pts))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    print(f"serving: launches on the main path {launches}", flush=True)
    for imgs, (hm, pts) in zip(requests, answers):
        k = imgs.shape[0]
        print(f"serving: request of {k}: heatmaps {hm.shape} "
              f"max|hm| {np.abs(hm).max():.4g}, landmarks {pts.shape}",
              flush=True)
        require(hm.shape == (k, 64, 64, 16), f"heatmaps shape {hm.shape}")
        require(pts.shape == (k, 16, 2), f"landmarks shape {pts.shape}")
        require(np.isfinite(hm).all() and np.isfinite(pts).all(),
                "non-finite output")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} never launched on the main path")

    plain = Predictor(dataclasses.replace(cfg, use_pallas=False), params,
                      state, device="cuda", batch_size=BATCH, flip_test=True)
    want = plain.heatmaps(requests[0])
    got = answers[0][0]
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    print(f"serving: kernel path vs plain path on the card, request of 8: "
          f"relative L2 {rel:.4g} (bound {PATH_REL_L2}), "
          f"|plain| {np.linalg.norm(want):.4g}", flush=True)
    require(np.isfinite(rel) and rel <= PATH_REL_L2,
            f"kernel path disagrees with the plain path: {rel}")

    times = {}
    for batch in (BATCH, 64):
        p = pred if batch == BATCH else Predictor(
            cfg, params, state, device="cuda", batch_size=batch)
        times[batch] = ms = time_forward(torch, p, batch)
        print(f"serving: forward batch {batch}: {ms:.3f} ms, "
              f"{batch / ms * 1e3:.1f} img/s (kernel path; {gpu})",
              flush=True)
    ms = time_forward(torch, plain, BATCH)
    print(f"serving: forward batch {BATCH}: {ms:.3f} ms, "
          f"{BATCH / ms * 1e3:.1f} img/s (plain path; {gpu})", flush=True)
    return launches, times


# ---------------------------------------------------------------------------
# phase 4: train kernels against their plain versions
# ---------------------------------------------------------------------------


def train_kernel_cases(torch, tops, bops, gen):
    """(kernel, label, make_out, call(fn, out), bound) at the CU-Net-8 @256
    train shapes (c=128, g=32, Cb=128, cls=16, h0=64, batch 24, tile 2).
    bound is ("bf16",), ("exact",) or ("sum", n) for an n-term reduction."""
    from cunet_tpu_torch.kernels.train_slot import _affine_vec

    dev = "cuda"
    c, g, cb, cls, h0, n = 128, 32, 128, 16, 64, TRAIN_BATCH
    tiles = n // BN_TILE

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    def vec(x):
        k = x.shape[1]
        st = torch.empty(tiles, 2, k, device=dev)
        tops.bn_stats_plain(x, st)
        bn = torch.stack([torch.rand(k, generator=gen) + 0.5,
                          torch.randn(k, generator=gen) * 0.3]).to(dev)
        return st, bn, _affine_vec(st, bn, 1e-5)

    def f32(*shape):
        return lambda: torch.empty(*shape, device=dev)

    def bf16(*shape):
        return lambda: torch.empty(*shape, device=dev, dtype=torch.bfloat16)

    m64 = n * h0 * h0
    down64 = randn(m64, c + g + g)            # [y | fifo | out32]
    x2 = down64[:, :c + 2 * g]                # K=192 adapter input
    st2, bn2, v2 = vec(x2)
    w_a = randn(192, c, scale=192 ** -0.5)
    d_ahead = randn(m64, c)
    y_out = randn(m64, c)
    sth, bnh, vh = vec(y_out)
    w_h = randn(c, cls, scale=c ** -0.5)
    d_head = randn(m64, cls)
    cases = [
        (tops.bn_stats, "r=64 K=160", f32(tiles, 2, 160),
         lambda f, o: f(down64[:, :160], o), ("sum", 2 * h0 * h0)),
        (bops.affine_dot, "K=192->128 r=64 per-tile", bf16(m64, c),
         lambda f, o: f(x2, v2, w_a, o), ("bf16",)),
        (tops.affine_dx, "K=192->128 r=64", f32(m64, 192),
         lambda f, o: f(d_ahead, w_a, x2, v2, o), ("sum", c)),
        (tops.affine_dx, "head 128->16 r=64", f32(m64, c),
         lambda f, o: f(d_head, w_h, y_out, vh, o), ("sum", cls)),
        (tops.affine_dw, "K=192->128 r=64", f32(192, c),
         lambda f, o: f(x2, v2, d_ahead, o), ("sum", m64)),
        (tops.affine_dw, "head 128->16 r=64", f32(c, cls),
         lambda f, o: f(y_out, vh, d_head, o), ("sum", m64)),
    ]
    d_a = randn(m64, 192, dtype=torch.float32)
    cases.append((tops.bn_bwd, "K=192 r=64", f32(m64, 192),
                  lambda f, o: f(x2, d_a, st2, bn2, 1e-5, o,
                                 torch.empty(2, 192, device=dev)),
                  ("sum", 2 * h0 * h0)))
    for r in (64, 4):
        m = n * r * r
        yb = randn(m, cb)
        _, _, vb = vec(yb)
        w3 = randn(9 * cb, g, scale=(9 * cb) ** -0.5)
        d_o = randn(m, g)
        cases += [
            (bops.conv3x3, f"Cb=128->32 r={r} per-tile prologue",
             bf16(m, g), lambda f, o, yb=yb, w3=w3, vb=vb, r=r:
             f(yb, w3, n, r, r, o, vec=vb) if f is bops.conv3x3
             else f(yb, w3, n, r, r, o, vb), ("bf16",)),
            (tops.conv3x3_dx, f"32->128 r={r}", f32(m, cb),
             lambda f, o, yb=yb, w3=w3, vb=vb, d_o=d_o, r=r:
             f(d_o, w3, n, r, r, yb, vb, o), ("sum", 9 * g)),
            (tops.conv3x3_dw, f"(9*128, 32) r={r}", f32(9 * cb, g),
             lambda f, o, yb=yb, vb=vb, d_o=d_o, r=r:
             f(yb, vb, d_o, n, r, r, o), ("sum", m)),
        ]
    ahead = randn(m64, c)
    d_pool = randn(m64 // 4, c, dtype=torch.float32)
    cases.append((tops.maxpool2_bwd, "64->32", bf16(m64, c),
                  lambda f, o: f(ahead, d_pool, n, 64, 64, o), ("exact",)))
    d_up = randn(n * 64, c, dtype=torch.float32)
    cases.append((tops.upsample2_bwd, "8->4", bf16(n * 16, c),
                  lambda f, o: f(d_up, n, 4, 4, o), ("bf16",)))
    part = randn(48, 192, c, dtype=torch.float32)
    cases.append((tops.sum_rows, "48 x (192*128) dW chunks", f32(192, c),
                  lambda f, o: f(part, o), ("sum", 48)))
    return cases


def phase_train_kernels(torch, tops, bops):
    gen = torch.Generator().manual_seed(0)
    results = {}
    plain_of = {**bops.PLAIN, **tops.PLAIN}
    for kern, label, make_out, call, bound in train_kernel_cases(
            torch, tops, bops, gen):
        name = kern.__name__
        k_out, p_out = make_out(), make_out()
        call(kern, k_out)
        call(plain_of[kern], p_out)
        torch.cuda.synchronize()
        got, want = k_out.float(), p_out.float()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        if bound[0] == "bf16":
            lim = REL_BOUND * scale + ABS_BOUND
        elif bound[0] == "exact":
            lim = 0.0
        else:
            lim = SUM_REL_PER_SQRT_N * bound[1] ** 0.5 * scale + 1e-6
        ms = cuda_time_ms(lambda: call(kern, k_out))
        plain_ms = cuda_time_ms(lambda: call(plain_of[kern], p_out))
        print(f"train kernel {name} [{label}]: max_abs_err {err:.4g} "
              f"(bound {lim:.4g}, {bound[0]}"
              f"{'' if len(bound) == 1 else f' n={bound[1]}'}), "
              f"{ms:.4f} ms vs plain {plain_ms:.4f} ms", flush=True)
        require(np.isfinite(err) and err <= lim,
                f"{name} [{label}] disagrees with its plain version: "
                f"{err} > {lim}")
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r.setdefault("ms", ms)          # first case = main-path headline
        r.setdefault("plain_ms", plain_ms)
        r.setdefault("shape", label)
    return results


# ---------------------------------------------------------------------------
# phase 5: training
# ---------------------------------------------------------------------------


def gaussian_heatmaps(rng, n, joints, size, sigma=1.0):
    """(n, size, size, joints) float32 Gaussian target heatmaps at random
    joint positions, rendered with numpy."""
    centres = rng.uniform(4, size - 4, (n, joints, 2))
    grid = np.arange(size, dtype=np.float32)
    gx = np.exp(-(grid[None, None, :] - centres[..., 0:1]) ** 2
                / (2 * sigma ** 2))
    gy = np.exp(-(grid[None, None, :] - centres[..., 1:2]) ** 2
                / (2 * sigma ** 2))
    hm = gy[:, :, :, None] * gx[:, :, None, :]          # (n, J, y, x)
    return hm.transpose(0, 2, 3, 1).astype(np.float32)


def _grads(torch, cfg, params, state, x, t):
    """One forward + backward from float32 copies of ``params``: (loss,
    grads, new bn_state)."""
    from cunet_tpu_torch.models import apply_cu_net
    from cunet_tpu_torch.train import intermediate_mse

    ps = {k: v.detach().clone().requires_grad_(True)
          for k, v in params.items()}
    outs, new_state = apply_cu_net(ps, state, x, cfg=cfg, train=True)
    loss = intermediate_mse(outs, t)
    loss.backward()
    return loss.item(), {k: v.grad for k, v in ps.items()}, new_state


def _rel_l2(torch, a, b, keys):
    num = sum(((a[k].float() - b[k].float()) ** 2).sum() for k in keys)
    den = sum((b[k].float() ** 2).sum() for k in keys)
    return (num / den).sqrt().item()


def slot_rel_errors(torch, cfg, params, state, n, h0, i, device, gen):
    """Slot ``i`` (>= 1) of the train step alone, from one slot input and
    one set of FIFO entries, on three paths: the kernel path, the plain
    path with its BN affine in float32 (the reference: it rounds where the
    kernels round) and the plain path as configured (the control).

    Groups: the forward outputs; the running-statistics updates; and, for
    each output alone under a random cotangent, every input cotangent (the
    slot input and each FIFO entry: what reaches the earlier slots' out32
    and inter_out) and every weight gradient, a missing gradient counting
    as zero. Returns ``(kernel, control)``, each {group: {name: relative
    L2 against the reference}}."""
    from cunet_tpu_torch.models import apply_slot_train, empty_fifos

    dt = getattr(torch, cfg.compute_dtype)
    nb, c, g, L = cfg.num_blocks, cfg.init_chan_num, cfg.growth_rate, \
        min(i, cfg.order)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(device, dt)

    # FIFO entries in empty_fifos order: down 0..nb-1, neck, up 0..nb-1
    pos_res = ([(f"down.{j}", h0 >> j) for j in range(nb)]
               + [("neck", h0 >> nb)]
               + [(f"up.{j}", h0 >> j) for j in range(nb)])
    names = (["d_y"] + [f"d_inter_fifo.{k}" for k in range(L)]
             + [f"d_fifo.{p}.{k}" for p, _ in pos_res for k in range(L)])
    inputs = ([rand(n, h0, h0, c).relu() for _ in range(1 + L)]
              + [rand(n, r, r, g) for _, r in pos_res for _ in range(L)])
    out_names = (["y_out", "head", "inter_out"]
                 + [f"out32.{p}" for p, _ in pos_res])
    cts = []

    def run(run_cfg):
        ps = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
        xs = [t.clone().requires_grad_(True) for t in inputs]
        it = iter(xs[1:])
        fifos = empty_fifos(cfg)
        fifos["intermedia"] = [next(it) for _ in range(L)]
        fifos["down"] = [[next(it) for _ in range(L)] for _ in range(nb)]
        fifos["neck"] = [next(it) for _ in range(L)]
        fifos["up"] = [[next(it) for _ in range(L)] for _ in range(nb)]
        y_out, nf, hm, upd = apply_slot_train(ps, state, xs[0], fifos,
                                              cfg=run_cfg, i=i)
        outs = ([y_out, hm, nf["intermedia"][-1]]
                + [f[-1] for f in nf["down"]] + [nf["neck"][-1]]
                + [f[-1] for f in nf["up"]])
        if not cts:
            cts.extend(rand(*o.shape) for o in outs)
        leaves = dict(zip(names, xs))
        leaves.update((f"dW.{k}", v) for k, v in ps.items())
        got = {"forward outputs": {k: o.detach()
                                   for k, o in zip(out_names, outs)},
               "running-stat updates": {k: v - state[k]
                                        for k, v in upd.items()}}
        for on, o, ct in zip(out_names, outs, cts):
            gr = torch.autograd.grad(o, list(leaves.values()), ct,
                                     allow_unused=True, retain_graph=True)
            got[f"grads from {on}"] = {k: d for k, d in zip(leaves, gr)
                                       if d is not None}
        return got

    def rel(a, b):              # a missing gradient is a zero one
        if b is None or not b.any():
            return 0.0 if a is None or not a.any() else float("inf")
        a = torch.zeros_like(b) if a is None else a
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    def against(got, ref):
        return {grp: {k: rel(got[grp].get(k), ref[grp].get(k))
                      for k in set(got[grp]) | set(ref[grp])}
                for grp in ref}

    kern = run(cfg)
    ref = run(dataclasses.replace(cfg, use_pallas=False, bn_dtype="float32"))
    ctl = run(dataclasses.replace(cfg, use_pallas=False))
    return against(kern, ref), against(ctl, ref)


def check_slot(torch, cfg, params, state):
    """Slot 1 of the flagship train step alone at full width (the
    intermedia adapter, every block position, one FIFO entry each): per
    group of ``slot_rel_errors``, the kernel path's largest error against
    the float32-affine plain path must not exceed the control's (the plain
    path with the configured bf16 affine, a correct implementation). In
    bf16 the two plain paths flip ReLU masks and pool winners apart, and
    the flips grow with depth, so a fixed bound would be loose for deep
    outputs or fail at shallow ones; a dropped or doubled cotangent path
    gives 1 on the leaves it feeds."""
    kern, ctl = slot_rel_errors(torch, cfg, params, state, TRAIN_BATCH, 64,
                                1, "cuda", torch.Generator().manual_seed(2))
    for grp, rels in kern.items():
        worst = max(rels, key=rels.get)
        bound = max(ctl[grp].values())
        print(f"training: slot 1 alone, kernel vs plain (f32 BN affine): "
              f"{grp}: {len(rels)} tensors, max rel L2 {rels[worst]:.4g} "
              f"({worst}); control (plain, bf16 affine) {bound:.4g}",
              flush=True)
        require(rels[worst] <= bound,
                f"slot 1 {grp}: kernel path {worst} off the plain path by "
                f"{rels[worst]} > control {bound}")


def time_train(torch, st, batch, cfg, steps=5):
    from cunet_tpu_torch.train import train_step

    train_step(st, batch, cfg=cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        train_step(st, batch, cfg=cfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), torch.cuda.max_memory_allocated()


def phase_training(torch, tops, bops, gpu):
    from cunet_tpu_torch import ModelConfig, TrainConfig
    from cunet_tpu_torch.models import init_cu_net
    from cunet_tpu_torch.train import create_train_state, train_step

    cfg = ModelConfig(layer_num=8, order=1, class_num=16, loss_num=8,
                      compute_dtype="bfloat16", remat="none",
                      use_pallas=True, bn_tile=BN_TILE, bn_dtype="compute")
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0),
                                device="cuda")
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(TRAIN_BATCH, 256, 256, 3).astype(
        np.float32)).cuda()
    t = torch.from_numpy(gaussian_heatmaps(rng, TRAIN_BATCH, 16, 64)).cuda()

    # ---- one slot alone: every cotangent path, kernel against plain ----
    check_slot(torch, cfg, params, state)

    # ---- kernel step against plain step, from identical state ----
    lk, gk, sk = _grads(torch, cfg, params, state, x, t)
    lp, gp, sp = _grads(torch, plain_cfg, params, state, x, t)
    nudged = dict(params)
    nudged["stem.norm.bias"] = params["stem.norm.bias"] + CONTROL_NUDGE
    _, gq, _ = _grads(torch, plain_cfg, nudged, state, x, t)
    loss_rel = abs(lk - lp) / abs(lp)
    norm = lambda g: sum((v.float() ** 2).sum() for v in g.values()).sqrt()
    ratio = (norm(gk) / norm(gp)).item()

    def cosines(ga):
        return [torch.nn.functional.cosine_similarity(
            ga[k].flatten().float(), gp[k].flatten().float(), dim=0).item()
            for k in ga if gp[k].abs().max() > 0]

    cos, cos_ctl = cosines(gk), np.mean(cosines(gq))
    del gq
    heads = [k for k in gk if k.startswith("heads.")]
    heads_rel = _rel_l2(torch, gk, gp, heads)
    bn_rel = _rel_l2(torch, sk, sp, list(sp))
    worst_bn = max(sp, key=lambda k: _rel_l2(torch, sk, sp, [k]))
    print(f"training: kernel vs plain step on the card: loss {lk:.6g} vs "
          f"{lp:.6g} (rel {loss_rel:.3g}, bound {LOSS_REL}); grad-norm "
          f"ratio {ratio:.4f} (band {GRAD_NORM_RATIO}); mean per-leaf cosine "
          f"{np.mean(cos):.4f} (min {np.min(cos):.4f}; control, plain vs "
          f"plain with the stem BN bias +{CONTROL_NUDGE}: {cos_ctl:.4f}; "
          f"bound >= control - {COSINE_MARGIN}); heads.* grads rel L2 "
          f"{heads_rel:.4g} (bound "
          f"{HEADS_REL_L2}); BN running stats rel L2 {bn_rel:.4g} (bound "
          f"{BN_STATE_REL_L2}; worst leaf {worst_bn} "
          f"{_rel_l2(torch, sk, sp, [worst_bn]):.4g})", flush=True)
    require(np.isfinite(lk) and loss_rel <= LOSS_REL,
            f"kernel-path loss {lk} vs plain {lp}")
    require(GRAD_NORM_RATIO[0] <= ratio <= GRAD_NORM_RATIO[1],
            f"grad-norm ratio {ratio}")
    require(np.mean(cos) >= cos_ctl - COSINE_MARGIN,
            f"mean cosine {np.mean(cos)} below the control {cos_ctl}")
    require(heads_rel <= HEADS_REL_L2, f"heads.* grads rel L2 {heads_rel}")
    require(bn_rel <= BN_STATE_REL_L2, f"BN running stats rel L2 {bn_rel}")

    # ---- determinism: the same kernel step again ----
    lk2, gk2, _ = _grads(torch, cfg, params, state, x, t)
    same = lk2 == lk and all(torch.equal(gk[k], gk2[k]) for k in gk)
    print(f"training: repeated kernel step bit-identical: {same}",
          flush=True)
    require(same, "the kernel train step is not deterministic")
    del gk, gp, gk2, sk, sp

    # ---- three train steps through the kernels: the main path ----
    tcfg = TrainConfig(lr=2.5e-4, batch_size=TRAIN_BATCH)
    st = create_train_state(params, state, tcfg)
    before = {k: v.detach().clone() for k, v in st.params.items()}
    batch = {"image": x, "heatmap": t}
    bops.reset_launch_counts()
    tops.reset_launch_counts()
    losses = []
    for _ in range(3):
        st, m = train_step(st, batch, cfg=cfg)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    launches = {**bops.launch_counts(), **tops.launch_counts()}
    moved = sum(not torch.equal(before[k], v.detach())
                for k, v in st.params.items())
    print(f"training: 3 kernel-path steps, losses {losses}; "
          f"{moved}/{len(before)} params changed; launches {launches}",
          flush=True)
    require(all(np.isfinite(losses)), f"non-finite loss {losses}")
    require(moved > 0, "no parameter changed")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} never launched in training")

    # ---- timing: kernel path, then plain path ----
    ms_k, mem_k = time_train(torch, st, batch, cfg)
    st_p = create_train_state(params, state, tcfg)
    ms_p, mem_p = time_train(torch, st_p, batch, plain_cfg)
    for path, ms, mem in (("kernel", ms_k, mem_k), ("plain", ms_p, mem_p)):
        print(f"training: {path} path, batch {TRAIN_BATCH}: median step "
              f"{ms:.3f} ms, {TRAIN_BATCH / ms * 1e3:.1f} img/s, peak "
              f"memory {mem / 2 ** 30:.2f} GiB ({gpu})", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 6: int8 serving
# ---------------------------------------------------------------------------


def int8_kernel_cases(torch, gen):
    """(kernel name, label, destination, view selector, call(fn, out)) of
    the three int8 kernels at the CU-Net-8 @256 int8 main-path shapes
    (c=128, g=32, Cb=128, cls=16, h0=64, batch 8; every bottleneck and
    adapter K), plus ragged cases: K not a multiple of 32, M not a multiple
    of the 128-row tile, Cb not a multiple of 16, unaligned int8 rows."""
    dev = "cuda"
    c, g, cb, cls, h0, n = 128, 32, 128, 16, 64, BATCH
    s = 128.0                                   # 2^(bits_i - 1), bits_i 8

    def bf16(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(
            dev, torch.bfloat16)

    def signs(k, m):                            # binarized weights
        return torch.randint(-1, 2, (k, m), generator=gen,
                             dtype=torch.int8).to(dev)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen,
                             dtype=torch.int8).to(dev)

    def vec(k, lo=0.5, hi=1.5, shift=0.5):
        inv = torch.rand(k, generator=gen) * (hi - lo) + lo
        return torch.stack([inv, torch.randn(k, generator=gen) * shift]).to(
            dev)

    m64 = n * h0 * h0
    down = bf16(m64, c + g + g, scale=0.5)     # [y | fifo | out32]
    up = bf16(m64, 2 * c + g + g, scale=0.5)   # [up_y | skip | fifo | out32]
    cases = []
    # affine_dot_i8: bottlenecks (BN2 + q8 epilogue into int8 rows) at every
    # bottleneck K, adapters (bf16 into buffer views) at every adapter K
    for k, src in ((128, down), (160, down), (256, up), (288, up)):
        v, w, v2 = vec(k), signs(k, cb), vec(cb, 0.01, 0.05, 0.3)
        cases.append(("affine_dot_i8", f"K={k}->128 +BN2,q8 r=64",
                      codes(m64, cb), lambda b: b,
                      lambda f, b, src=src, k=k, v=v, w=w, v2=v2:
                      f(src[:, :k], v, w, b, s=s, vec2=v2)))
    for k, src in ((192, down), (160, down), (320, up), (288, up)):
        v, w = vec(k), signs(k, c)
        dst = bf16(m64, 2 * c + g + g)
        cases.append(("affine_dot_i8", f"K={k}->128 r=64", dst,
                      lambda b: b[:, c:2 * c],
                      lambda f, b, src=src, k=k, v=v, w=w:
                      f(src[:, :k], v, w, b[:, c:2 * c], s=s)))
    # head K=128 -> 16 into anchor slot 3 of the stacked head output
    vh, wh = vec(c), signs(c, cls)
    heads = bf16(n, 8, h0, h0, cls)
    cases.append(("affine_dot_i8", "head K=128->16 r=64", heads,
                  lambda b: b[:, 3],
                  lambda f, b: f(down[:, :c], vh, wh,
                                 b[:, 3].view(n, h0 * h0, cls), s=s)))
    # ragged: K=40, M=1000 (7.8 row tiles), N=24, both epilogues
    xr = bf16(1000, 48, scale=0.5)
    vr, wr, v2r = vec(48), signs(48, 24), vec(24, 0.01, 0.05, 0.3)
    cases.append(("affine_dot_i8", "ragged K=40->24 M=1000 +BN2,q8",
                  codes(1000, 24), lambda b: b,
                  lambda f, b: f(xr[:, :40], vr, wr, b, s=s, vec2=v2r)))
    cases.append(("affine_dot_i8", "ragged K=40->24 M=1000",
                  bf16(1000, 40), lambda b: b[:, 8:32],
                  lambda f, b: f(xr[:, :40], vr, wr, b[:, 8:32], s=s)))
    # conv3x3_i8: Cb=128 -> 32 into the out32 slot at r=64 and r=4
    for r in (64, 4):
        m = n * r * r
        y = codes(m, cb).clamp_(min=0)          # relu'd codes
        w3 = signs(9 * cb, g)
        cases.append(("conv3x3_i8", f"Cb=128->32 r={r}", bf16(m, c + 2 * g),
                      lambda b: b[:, c + g:],
                      lambda f, b, y=y, w3=w3, r=r:
                      f(y, w3, n, r, r, b[:, c + g:], s=s)))
    # ragged conv: Cb=24 (byte loads), 3 images of 6x6 (M=108), G=8
    yr, w3r = codes(108, 24), signs(9 * 24, 8)
    cases.append(("conv3x3_i8", "ragged Cb=24->8 r=6 M=108", bf16(108, 16),
                  lambda b: b[:, 8:],
                  lambda f, b: f(yr, w3r, 3, 6, 6, b[:, 8:], s=s)))
    # int8_matmul_dequant: the plain path's 1x1 convs at every K
    ones = torch.ones(c, device=dev)
    for k in (128, 160, 192, 256, 288, 320):
        x, w = codes(m64, k).clamp_(min=0), signs(k, c)
        cases.append(("int8_matmul_dequant", f"K={k}->128 r=64", None, None,
                      lambda f, x=x, w=w: f(x, w, ones, 1 / s)))
    # ragged: K=20 (unaligned 20-byte rows), M=1000, N=24, column scales
    xq, wq = codes(1000, 20), codes(20, 24)
    cs = torch.rand(24, generator=gen).to(dev)
    cases.append(("int8_matmul_dequant", "ragged K=20->24 M=1000", None,
                  None, lambda f: f(xq, wq, cs, 1 / s)))
    return cases


def phase_int8_kernels(torch, qops):
    """Each int8 kernel against its plain version on the same operands:
    the outputs must be bit-identical (integer products accumulate exactly
    in any order; every float rounding point is shared)."""
    gen = torch.Generator().manual_seed(3)
    results = {}
    for name, label, dst, sel, call in int8_kernel_cases(torch, gen):
        kern = getattr(qops, name)
        plain = qops.PLAIN[kern]
        if dst is None:                          # returns a new tensor
            got = call(kern)
            want = torch.empty_like(got)
            call(lambda *a: plain(*a, want))
            run_k, run_p = (lambda: call(kern)), (lambda: call(
                lambda *a: plain(*a, want)))
            untouched = True
        else:
            k_buf, p_buf = dst.clone(), dst.clone()
            call(kern, k_buf)
            call(plain, p_buf)
            got, want = sel(k_buf), sel(p_buf)
            outside = k_buf.clone()
            sel(outside).copy_(sel(dst))
            untouched = torch.equal(outside, dst)
            run_k, run_p = (lambda: call(kern, k_buf)), (
                lambda: call(plain, p_buf))
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        err = (got.float() - want.float()).abs().max().item()
        ms = cuda_time_ms(run_k)
        plain_ms = cuda_time_ms(run_p)
        print(f"int8 kernel {name} [{label}]: bit-identical {same} "
              f"(max_abs_err {err:.4g}), outside view untouched "
              f"{untouched}, {ms:.4f} ms vs plain {plain_ms:.4f} ms",
              flush=True)
        require(same, f"{name} [{label}] differs from its plain version: "
                f"max_abs_err {err}")
        require(untouched, f"{name} [{label}] wrote outside its view")
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r.setdefault("ms", ms)          # first case = main-path headline
        r.setdefault("plain_ms", plain_ms)
        r.setdefault("shape", label)
    return results


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def phase_int8_serving(torch, ops, qops, gpu, float_ms):
    """CU-Net-8 @256 bf16, quantized W1/I8/G8 (``bench.py``'s int8
    configuration), params ``quant_eval_params`` of the port's init (seed
    0): serving on the int8 kernel path (the main path), the bit-identical
    check of its int8 kernels at every launch of a request, the plain
    path with ``int8_impl="pallas"`` (kernel #10) against ``"lax"``, the
    kernel path against the plain path beside a same-run control, and
    timing."""
    from cunet_tpu_torch import ModelConfig, QuantConfig
    from cunet_tpu_torch.kernels import model_buf
    from cunet_tpu_torch.models import init_cu_net
    from cunet_tpu_torch.serving import Predictor
    from cunet_tpu_torch.train import quant_eval_params

    cfg = ModelConfig(layer_num=8, order=1, class_num=16, loss_num=8,
                      compute_dtype="bfloat16", use_pallas=True,
                      pallas_whole_model=True)
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    quant = QuantConfig(bits_w=1, bits_i=8, bits_g=8, enabled=True,
                        int8_infer=True, int8_impl="pallas")
    lax = dataclasses.replace(quant, int8_impl="lax")
    params, state = init_cu_net(cfg, torch.Generator().manual_seed(0))
    qparams = quant_eval_params(params, quant)
    values = {float(u) for k, v in qparams.items() if k.endswith("conv2")
              for u in v.unique()}
    require(values <= {-1.0, 0.0, 1.0}, f"quantized 3x3 weights {values}")

    def predictor(c, q, batch=BATCH, flip=True):
        return Predictor(c, qparams, state, device="cuda", batch_size=batch,
                         flip_test=flip, quant=q)

    pred = predictor(cfg, quant)
    rng = np.random.RandomState(0)
    requests = [rng.rand(k, 256, 256, 3).astype(np.float32)
                for k in (8, 5, 11)]

    # ---- the main path: int8 serving on the kernels ----
    ops.reset_launch_counts()
    qops.reset_launch_counts()
    answers = [(pred.heatmaps(imgs), pred.predict(imgs))
               for imgs in requests]
    torch.cuda.synchronize()
    launches = {**ops.launch_counts(), **qops.launch_counts()}
    print(f"int8 serving: launches on the main path {launches}", flush=True)
    for imgs, (hm, pts) in zip(requests, answers):
        k = imgs.shape[0]
        print(f"int8 serving: request of {k}: heatmaps {hm.shape} "
              f"max|hm| {np.abs(hm).max():.4g}, landmarks {pts.shape}",
              flush=True)
        require(hm.shape == (k, 64, 64, 16), f"heatmaps shape {hm.shape}")
        require(pts.shape == (k, 16, 2), f"landmarks shape {pts.shape}")
        require(np.isfinite(hm).all() and np.isfinite(pts).all(),
                "non-finite output")
        require(np.abs(hm).max() > 0, "all-zero heatmaps")
    for name in ("affine_dot_i8", "conv3x3_i8", "affine_dot", "maxpool2",
                 "upsample2"):
        require(launches[name] > 0,
                f"kernel {name} never launched on the int8 main path")
    require(launches["int8_matmul_dequant"] == 0,
            "int8_matmul_dequant launched on the whole-model path")

    # ---- the same forward with the int8 kernels' plain versions ----
    got = answers[0][0]
    saved = (model_buf.affine_dot_i8, model_buf.conv3x3_i8)
    model_buf.affine_dot_i8 = qops.PLAIN[qops.affine_dot_i8]
    model_buf.conv3x3_i8 = qops.PLAIN[qops.conv3x3_i8]
    try:
        want = pred.heatmaps(requests[0])
    finally:
        model_buf.affine_dot_i8, model_buf.conv3x3_i8 = saved
    print(f"int8 serving: kernel path vs the same path on the int8 "
          f"kernels' plain versions, request of 8: bit-identical "
          f"{np.array_equal(got, want)}", flush=True)
    require(np.array_equal(got, want),
            "the int8 kernels' forward differs from their plain versions'")

    # ---- the plain path on kernel #10: the second path ----
    plain_k = predictor(plain_cfg, quant)
    qops.reset_launch_counts()
    hm_k = plain_k.heatmaps(requests[0])
    torch.cuda.synchronize()
    plain_launches = qops.launch_counts()
    hm_l = predictor(plain_cfg, lax).heatmaps(requests[0])
    print(f"int8 plain path: launches {plain_launches}; int8_impl "
          f"'pallas' vs 'lax' bit-identical {np.array_equal(hm_k, hm_l)}",
          flush=True)
    require(plain_launches["int8_matmul_dequant"] > 0,
            "int8_matmul_dequant never launched on the plain int8 path")
    require(np.array_equal(hm_k, hm_l),
            "the plain int8 path on int8_matmul_dequant differs from lax")

    # ---- kernel path against the plain path, beside a control ----
    # Each anchor of one request of 8, no flip test. The binarized model is
    # chaotic at this init (a rounding difference anywhere decorrelates
    # the later heatmaps, PERF.md section 6), so the kernel path is held,
    # as the training phase's slot check is, against a control measured
    # here: the plain path with its BN affine in bf16 (bn_dtype "compute")
    # against the plain path with its float32 affine (the reference).
    from cunet_tpu_torch.models import apply_cu_net

    qp, st = pred.params, pred.bn_state
    x = torch.from_numpy(requests[0]).to("cuda", torch.bfloat16)
    ctl_cfg = dataclasses.replace(plain_cfg, bn_dtype="compute")
    with torch.inference_mode():
        outs = [apply_cu_net(qp, st, x, cfg=c, quant=q, slots=sl)[0]
                for c, q, sl in ((cfg, quant, pred._slots),
                                 (plain_cfg, lax, None),
                                 (ctl_cfg, lax, None))]
    k_rel, c_rel = [], []
    for a in range(len(cfg.anchors)):
        kk, pp, cc = (o[a].float().cpu().numpy() for o in outs)
        k_rel.append(_rel(kk, pp))
        c_rel.append(_rel(cc, pp))
    print(f"int8 serving: kernel path vs plain path (lax, f32 BN affine), "
          f"request of 8, relative L2 per anchor "
          f"{[round(v, 4) for v in k_rel]} (mean {np.mean(k_rel):.4f}); "
          f"control (plain, bf16 BN affine) {[round(v, 4) for v in c_rel]} "
          f"(mean {np.mean(c_rel):.4f}); bound: mean <= control mean + "
          f"{INT8_PATH_MARGIN}", flush=True)
    require(np.isfinite(k_rel).all()
            and np.mean(k_rel) <= np.mean(c_rel) + INT8_PATH_MARGIN,
            f"int8 kernel path off the plain path: mean relative L2 "
            f"{np.mean(k_rel)} > control {np.mean(c_rel)} + "
            f"{INT8_PATH_MARGIN}")

    # ---- timing ----
    for label, c, q, batch in (("kernel", cfg, quant, BATCH),
                               ("kernel", cfg, quant, 64),
                               ("plain lax", plain_cfg, lax, BATCH),
                               ("plain lax", plain_cfg, lax, 64),
                               ("plain pallas", plain_cfg, quant, BATCH)):
        p = predictor(c, q, batch, flip=False)
        ms = time_forward(torch, p, batch)
        print(f"int8 serving: forward batch {batch}: {ms:.3f} ms, "
              f"{batch / ms * 1e3:.1f} img/s (int8 {label} path; float "
              f"kernel path {float_ms[batch]:.3f} ms; {gpu})", flush=True)
    return launches, plain_launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU smoke",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from cunet_tpu_torch.kernels import buf_ops as ops
    from cunet_tpu_torch.kernels import build
    from cunet_tpu_torch.kernels import quant_ops as qops
    from cunet_tpu_torch.kernels import train_ops as tops

    # ---- phase 1: build ----
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(gpu, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.lib()
    print(f"build: {build.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc "
          f"{'ran' if build.build_seconds is not None else 'skipped'})",
          flush=True)

    try:
        kernels = phase_kernels(torch, ops)
        launches, float_ms = phase_serving(torch, ops, gpu)
        train_kernels = phase_train_kernels(torch, tops, ops)
        train_launches = phase_training(torch, tops, ops, gpu)
        int8_kernels = phase_int8_kernels(torch, qops)
        int8_launches, plain_launches = phase_int8_serving(
            torch, ops, qops, gpu, float_ms)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    if "jax" in sys.modules:
        print("chip_smoke: FAILED: jax was imported", file=sys.stderr)
        return 1

    rows = []
    for name in list(kernels) + [k for k in train_kernels
                                 if k not in kernels]:
        r = kernels.get(name) or train_kernels[name]
        row = {"name": name, "route": "cuda",
               "source": SOURCE if name in launches else TRAIN_SOURCE,
               "replaces": REPLACES[name],
               "launches": launches.get(name, train_launches[name]),
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "shape": r["shape"],
               "train_launches": train_launches[name]}
        if name in kernels and name in train_kernels:
            t = train_kernels[name]
            row.update(train_ms=t["ms"], train_plain_ms=t["plain_ms"],
                       train_shape=t["shape"],
                       max_abs_err=max(r["max_abs_err"], t["max_abs_err"]))
        rows.append(row)
    for name, r in int8_kernels.items():
        rows.append({"name": name, "route": "cuda", "source": INT8_SOURCE,
                     "replaces": REPLACES[name],
                     "launches": (int8_launches[name] if
                                  name != "int8_matmul_dequant" else
                                  plain_launches[name]),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "shape": r["shape"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
