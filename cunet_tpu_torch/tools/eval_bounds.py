"""Least device times of the eval kernels' work, counted from the shapes.

    python -m cunet_tpu_torch.tools.eval_bounds [--batch 8 64]

For CU-Net-8 @256 (order 1, 16 classes, c=128, g=32, Cb=128, 4 blocks)
prints, per batch size, the bytes each eval function must move (each input
read once, each output written once: activations and heatmaps in bf16,
matrices in bf16, folded BN vectors in float32) and the bf16 operations of
its products, and the bound: the larger of bytes over 3.35 TB/s and
operations over 989 TFLOP/s (one H100 SXM at 700 W, NVIDIA's data sheet).
The functions are those of the TPU kernels (``cunet_tpu/kernels``): the
post-stem forward of all slots (#1 ``fused_model_buf_infer``, #2
``fused_model_infer``, #3 ``fused_model_loop_infer``; #3 writes every
slot's heads), one steady slot (#4 ``fused_hourglass_infer``), one dense
block of each kind (#5 ``fused_dense_block_infer``: the down block at r=64
with its pool, the neck, the up block at r=64 with its upsample) and one
bottleneck or adapter pair (#6). Counting only: it runs on
the CPU and measures nothing.
"""

from __future__ import annotations

import argparse

from cunet_tpu_torch.config import ModelConfig

PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
FLAGSHIP = ModelConfig(layer_num=8, order=1, class_num=16, loss_num=8,
                       compute_dtype="bfloat16")


class Work:
    """Activation bytes, weight bytes and bf16 operations of a function."""

    def __init__(self):
        self.acts = 0
        self.weights = 0
        self.ops = 0

    @property
    def nbytes(self):
        return self.acts + self.weights

    def dot(self, m, ks, n, outs=1, bias=False):
        """A 1x1 product over feature groups of widths ``ks`` into ``outs``
        outputs of width ``n`` (their weights and BN vectors read)."""
        k = sum(ks)
        self.acts += 2 * m * k + outs * 2 * m * n
        self.weights += outs * (2 * k * n + 8 * k) + (4 * n if bias else 0)
        self.ops += 2 * outs * m * k * n

    def conv3x3(self, m, cb, g):
        self.acts += 2 * m * g
        self.weights += 2 * 9 * cb * g
        self.ops += 2 * m * 9 * cb * g

    def bound_ms(self):
        return max(self.nbytes / PEAK_BYTES, self.ops / PEAK_BF16) * 1e3

    def bound_by(self):
        return ("bytes" if self.nbytes / PEAK_BYTES >= self.ops / PEAK_BF16
                else "operations")


def slot_work(cfg: ModelConfig, n: int, i: int, head: bool = True) -> Work:
    """Slot ``i``'s eval as one function (#4): y and the FIFO entries in;
    y_out, the head, pre_out and the out32s (the next slot's FIFO entries)
    out. Every stage's input counts once: inside the function the stages'
    outputs feed the next stages without a trip to memory."""
    c, g, cb, nb = (cfg.init_chan_num, cfg.growth_rate, cfg.bottleneck_chan,
                    cfg.num_blocks)
    h0 = 64
    link = min(i, cfg.order)
    w = Work()
    m0 = n * h0 * h0
    w.acts += 2 * m0 * c * (1 + (link if i > 0 else 0))  # y, its FIFO
    if i > 0:
        w.weights += 2 * (1 + link) * c * c + 8 * (1 + link) * c
        w.ops += 2 * m0 * (1 + link) * c * c
        w.acts += 2 * m0 * c                             # pre_out
    res = ([h0 >> j for j in range(nb)] + [h0 >> nb]
           + [h0 >> j for j in reversed(range(nb))])
    for pos, r in enumerate(res):
        m = n * r * r
        kb = (2 * c if pos > nb else c) + link * g
        w.acts += 2 * m * link * g                       # FIFO entries in
        w.weights += 2 * kb * cb + 8 * kb + 4 * cb       # bottleneck
        w.ops += 2 * m * kb * cb
        w.conv3x3(m, cb, g)                              # out32 out
        outs = 2 if pos < nb else 1
        w.weights += outs * (2 * (kb + g) * c + 8 * (kb + g))
        w.ops += 2 * outs * m * (kb + g) * c
    w.acts += 2 * m0 * c                                 # y_out
    if head:
        w.weights += 2 * c * cfg.class_num + 8 * c
        w.ops += 2 * m0 * c * cfg.class_num
        w.acts += 2 * m0 * cfg.class_num
    return w


def model_work(cfg: ModelConfig, n: int, every_head: bool = False) -> Work:
    """The post-stem forward of all slots (#1, #2, #3): the stem output in,
    the anchored heads (every slot's with ``every_head``) out; the slots'
    FIFO entries and outputs stay inside."""
    total = Work()
    for i in range(cfg.layer_num):
        s = slot_work(cfg, n, i, head=every_head or (i + 1) in cfg.anchors)
        total.weights += s.weights
        total.ops += s.ops
    m0 = n * 64 * 64
    nheads = cfg.layer_num if every_head else len(cfg.anchors)
    total.acts = 2 * m0 * cfg.init_chan_num + nheads * 2 * m0 * cfg.class_num
    return total


def block_work(cfg: ModelConfig, n: int, kind: str = "down",
               pre: bool = False, head: bool = False) -> Work:
    """One steady block in one call (#5, BN2 unfolded: its two float32
    vectors read): ``down`` at r=64 ([y, fifo] in; the pooled ahead, the
    skip and the out32 out), ``neck`` at r = 64 >> num_blocks ([y, fifo]
    in; ahead and out32 out), ``up`` at r=64 ([y at r/2, skip, fifo] in:
    the upsample folded into the read; ahead and out32 out). ``pre`` (a
    down block): the intermedia pre-stage over [y, its FIFO] makes feature
    0 and writes pre_out; ``head`` (an up block): the head over the ahead
    output writes the heatmaps (down block 0 and up block 0 of a steady
    slot carry them)."""
    c, g, cb = cfg.init_chan_num, cfg.growth_rate, cfg.bottleneck_chan
    r = 64 >> cfg.num_blocks if kind == "neck" else 64
    m = n * r * r
    fifo = cfg.order * g
    kb = (2 * c if kind == "up" else c) + fifo
    outs = 2 if kind == "down" else 1
    w = Work()
    if kind == "up":
        w.acts += 2 * (m // 4) * c + 2 * m * (c + fifo)
    else:
        w.acts += 2 * m * kb
    w.acts += 2 * (m // 4 if kind == "down" else m) * c      # ahead
    w.acts += 2 * m * c if kind == "down" else 0              # skip
    w.weights += 2 * kb * cb + 8 * kb + 8 * cb
    w.ops += 2 * m * kb * cb
    w.conv3x3(m, cb, g)
    w.weights += outs * (2 * (kb + g) * c + 8 * (kb + g))
    w.ops += 2 * outs * m * (kb + g) * c
    if pre:
        # [y, its FIFO] in where y was; pre_out (feature 0) out
        kp = (1 + cfg.order) * c
        w.acts += 2 * m * kp
        w.weights += 2 * kp * c + 8 * kp
        w.ops += 2 * m * kp * c
    if head:
        w.acts += 2 * m * cfg.class_num                       # heatmaps
        w.weights += 2 * c * cfg.class_num + 8 * c
        w.ops += 2 * m * c * cfg.class_num
    return w


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 64])
    args = ap.parse_args(argv)
    cfg = FLAGSHIP
    c, g = cfg.init_chan_num, cfg.growth_rate
    for n in args.batch:
        rows = {
            "#1/#2 whole post-stem eval (anchored heads)": model_work(cfg, n),
            "#3 whole post-stem eval (every slot's heads)":
                model_work(cfg, n, every_head=True),
            "#4 one steady slot": slot_work(cfg, n, 1),
            "#5 one down block r=64, pooled": block_work(cfg, n),
            "#5 down block 0 r=64, pooled, with the pre-stage":
                block_work(cfg, n, pre=True),
            "#5 the neck r=4": block_work(cfg, n, "neck"),
            "#5 one up block r=64, upsampled": block_work(cfg, n, "up"),
            "#5 up block 0 r=64, upsampled, with the head":
                block_work(cfg, n, "up", head=True),
        }
        six = Work()
        six.dot(n * 64 * 64, [c, g, g], c, outs=2)
        rows["#6 dual adapter pair K=192->2x128 r=64"] = six
        for name, w in rows.items():
            print(f"batch {n}: {name}: {w.nbytes / 1e6:.2f} MB, "
                  f"{w.ops / 1e9:.2f} GFLOP, bound {w.bound_ms():.4f} ms "
                  f"({w.bound_by()})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
