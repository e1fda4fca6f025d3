"""Torch port: the plain versions of the four kernels, the NN ops and the
dense bottleneck against their JAX counterparts on the CPU.

The kernel wrappers of ``cunet_tpu_torch.kernels.buf_ops`` compute their
plain PyTorch versions on CPU tensors; here they are held against the
primitives of the Pallas kernels (``_bottleneck_val``, ``_conv3x3``,
``_maxpool2``, ``_upsample2``) called as plain jnp functions, reading and
writing strided views of wider buffers as the buffer-resident forward does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cunet_tpu.kernels.fused_hourglass import (
    _bottleneck_val,
    _conv3x3,
    _maxpool2,
    _upsample2,
    pack_w3_dycol,
)
from cunet_tpu.ops import bottleneck as jax_bottleneck
from cunet_tpu.ops import layers as jax_layers
from cunet_tpu_torch.kernels import buf_ops
from cunet_tpu_torch.ops import bottleneck, layers

from torch_port_util import TOL

RNG = np.random.RandomState


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _vec(rng, k):
    return np.stack([rng.uniform(0.5, 1.5, k),
                     rng.randn(k) * 0.5]).astype(np.float32)


def _assert_view_write(buf_before, buf_after, cols, want):
    """``buf_after[:, cols]`` equals ``want`` and nothing else changed."""
    np.testing.assert_allclose(buf_after[:, cols], want, **TOL)
    rest = np.ones(buf_before.shape[1], bool)
    rest[cols] = False
    np.testing.assert_array_equal(buf_after[:, rest], buf_before[:, rest])


class TestKernelPlainVersions:
    @pytest.mark.parametrize("with_bias", [False, True])
    def test_affine_dot_matches_bottleneck_val(self, with_bias):
        rng = RNG(0)
        m, k, n = 2 * 8 * 8, 40, 16
        src = rng.randn(m, 48).astype(np.float32)    # read buf[:, :40]
        vec = _vec(rng, 48)                          # padded past K
        w = (rng.randn(48, n) * 0.2).astype(np.float32)
        bias = (rng.randn(n) * 0.5).astype(np.float32)
        want = np.asarray(_bottleneck_val(
            jnp.asarray(src[:, :k]), jnp.asarray(vec[:, :k]),
            jnp.asarray(w[:k]), jnp.float32))
        if with_bias:
            want = np.maximum(want + bias, 0.0)
        dst = rng.randn(m, 32).astype(np.float32)    # write dst[:, 8:24]
        got = _t(dst.copy())
        buf_ops.affine_dot(_t(src)[:, :k], _t(vec), _t(w), got[:, 8:24],
                           bias=_t(bias) if with_bias else None)
        _assert_view_write(dst, got.numpy(), slice(8, 24), want)

    def test_affine_dot_writes_image_strided_head_slot(self):
        rng = RNG(1)
        b, hw, k, cls, slots = 2, 16, 16, 4, 3
        x = rng.randn(b * hw, k).astype(np.float32)
        vec, w = _vec(rng, k), (rng.randn(k, cls) * 0.3).astype(np.float32)
        out = torch.zeros(b, slots, 4, 4, cls)
        buf_ops.affine_dot(_t(x), _t(vec), _t(w),
                           out[:, 1].view(b, hw, cls))
        want = np.asarray(_bottleneck_val(jnp.asarray(x), jnp.asarray(vec),
                                          jnp.asarray(w), jnp.float32))
        np.testing.assert_allclose(out[:, 1].reshape(b * hw, cls).numpy(),
                                   want, **TOL)
        assert not out[:, 0].any() and not out[:, 2].any()

    # (images, r, Cb, G) beyond the first: the card tests' channel and
    # output tails and widths that do not divide a kernel tile
    @pytest.mark.parametrize("packing,shape", [
        pytest.param("dycol", (2, 8, 8, 16, 8), id="dycol"),
        pytest.param("taps", (2, 8, 8, 16, 8), id="taps"),
        *[pytest.param(p, (n, r, r, cb, g), id=f"{p}-n{n}-r{r}-cb{cb}-g{g}")
          for p in ("dycol", "taps")
          for n, r, cb, g in [(3, 6, 24, 16), (3, 4, 48, 24),
                              (1, 12, 16, 40), (3, 2, 16, 8)]]])
    def test_conv3x3_matches_pallas_conv(self, packing, shape):
        rng = RNG(2)
        b, h, w, cb, g = shape
        y2 = rng.randn(b * h * w, cb).astype(np.float32)
        w3 = (rng.randn(3, 3, cb, g) * 0.2).astype(np.float32)
        jw = pack_w3_dycol(jnp.asarray(w3)) if packing == "dycol" \
            else jnp.asarray(w3)
        want = np.asarray(_conv3x3(jnp.asarray(y2), jw, b, h, w,
                                   mode=packing))
        dst = rng.randn(b * h * w, 24 + g).astype(np.float32)
        got = _t(dst.copy())
        buf_ops.conv3x3(_t(y2), buf_ops.pack_w3(_t(w3)), b, h, w,
                        got[:, 16:16 + g])
        _assert_view_write(dst, got.numpy(), slice(16, 16 + g), want)

    def test_conv3x3_pads_each_image(self):
        """Images flattened into rows must not bleed into each other: the
        batched conv equals each image convolved alone."""
        rng = RNG(3)
        b, h, w, cb, g = 3, 4, 4, 8, 8
        y2 = _t(rng.randn(b * h * w, cb).astype(np.float32))
        w3p = buf_ops.pack_w3(_t((rng.randn(3, 3, cb, g) * 0.2)
                                 .astype(np.float32)))
        batched = buf_ops.conv3x3(y2, w3p, b, h, w, torch.empty(b * h * w, g))
        for i in range(b):
            rows = slice(i * h * w, (i + 1) * h * w)
            alone = buf_ops.conv3x3(y2[rows], w3p, 1, h, w,
                                    torch.empty(h * w, g))
            torch.testing.assert_close(batched[rows], alone)

    def test_maxpool2_matches(self):
        rng = RNG(4)
        b, h, w, c = 2, 8, 8, 16
        x = rng.randn(b * h * w, c).astype(np.float32)
        want = np.asarray(_maxpool2(jnp.asarray(x), h, w, b))
        dst = rng.randn(b * h * w // 4, 40).astype(np.float32)
        got = _t(dst.copy())
        buf_ops.maxpool2(_t(x), b, h, w, got[:, :c])
        _assert_view_write(dst, got.numpy(), slice(0, c), want)

    def test_upsample2_matches(self):
        rng = RNG(5)
        b, h, w, c = 2, 4, 4, 16
        x = rng.randn(b * h * w, c).astype(np.float32)
        want = np.asarray(_upsample2(jnp.asarray(x), h, w, b))
        dst = rng.randn(b * h * w * 4, 56).astype(np.float32)
        got = _t(dst.copy())
        buf_ops.upsample2(_t(x), b, h, w, got[:, :c])
        _assert_view_write(dst, got.numpy(), slice(0, c), want)

    def test_cpu_tensors_never_count_a_launch(self):
        buf_ops.reset_launch_counts()
        x = torch.randn(2 * 4 * 4, 16)
        buf_ops.affine_dot(x, torch.ones(2, 16), torch.randn(16, 8),
                           torch.empty(32, 8), bias=torch.zeros(8))
        buf_ops.conv3x3(x, torch.randn(9 * 16, 8), 2, 4, 4,
                        torch.empty(32, 8))
        buf_ops.maxpool2(x, 2, 4, 4, torch.empty(8, 16))
        buf_ops.upsample2(x, 2, 4, 4, torch.empty(128, 16))
        assert buf_ops.launch_counts() == {
            "affine_dot": 0, "conv3x3": 0, "maxpool2": 0, "upsample2": 0}

    def test_shape_mismatch_raises(self):
        x = torch.randn(32, 16)
        with pytest.raises(ValueError):
            buf_ops.affine_dot(x, torch.ones(2, 8), torch.randn(16, 8),
                               torch.empty(32, 8))
        with pytest.raises(ValueError):
            buf_ops.conv3x3(x, torch.randn(9 * 16, 8), 2, 4, 3,
                            torch.empty(32, 8))
        with pytest.raises(ValueError):
            buf_ops.maxpool2(x, 2, 4, 4, torch.empty(16, 16))


class TestOps:
    @pytest.mark.parametrize("k,stride,pad", [(7, 2, 3), (3, 1, 1), (1, 1, 0)])
    def test_conv2d(self, k, stride, pad):
        rng = RNG(6)
        x = rng.randn(2, 16, 16, 4).astype(np.float32)
        w = (rng.randn(k, k, 4, 8) * 0.2).astype(np.float32)
        want = np.asarray(jax_layers.conv2d(jnp.asarray(x), jnp.asarray(w),
                                            stride=stride, padding=pad))
        got = layers.conv2d(_t(x), _t(w), stride=stride, padding=pad)
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    def test_batch_norm_and_fold(self):
        rng = RNG(7)
        x = rng.randn(2, 4, 4, 8).astype(np.float32)
        p = {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
             "bias": rng.randn(8).astype(np.float32)}
        s = {"mean": rng.randn(8).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 8).astype(np.float32)}
        tp = {k: _t(v) for k, v in p.items()}
        ts = {k: _t(v) for k, v in s.items()}
        want, _ = jax_layers.batch_norm(jnp.asarray(x), p, s, train=False)
        got, new_state = layers.batch_norm(_t(x), tp, ts)
        assert new_state is ts
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for a, b in zip(layers.bn_inference_scale_shift(tp, ts),
                        jax_layers.bn_inference_scale_shift(p, s)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)

    def test_batch_norm_keeps_bf16(self):
        x = torch.randn(1, 2, 2, 4, dtype=torch.bfloat16)
        p = {"scale": torch.ones(4), "bias": torch.zeros(4)}
        s = {"mean": torch.zeros(4), "var": torch.ones(4)}
        assert layers.batch_norm(x, p, s)[0].dtype == torch.bfloat16

    def test_pool_upsample_relu(self):
        x = RNG(8).randn(2, 8, 8, 4).astype(np.float32)
        for jf, tf in [(jax_layers.max_pool_2x2, layers.max_pool_2x2),
                       (jax_layers.upsample_nearest_2x,
                        layers.upsample_nearest_2x),
                       (jax_layers.relu, layers.relu)]:
            np.testing.assert_array_equal(tf(_t(x)).numpy(),
                                          np.asarray(jf(jnp.asarray(x))))

    def test_dense_bottleneck(self):
        rng = RNG(9)
        feats = [rng.randn(2, 4, 4, c).astype(np.float32) for c in (16, 8, 8)]
        p = {"norm": {"scale": rng.uniform(0.5, 1.5, 32).astype(np.float32),
                      "bias": rng.randn(32).astype(np.float32) * 0.2},
             "conv": (rng.randn(1, 1, 32, 12) * 0.2).astype(np.float32)}
        s = {"mean": rng.randn(32).astype(np.float32) * 0.2,
             "var": rng.uniform(0.5, 1.5, 32).astype(np.float32)}
        want, _ = jax_bottleneck.dense_bottleneck(
            [jnp.asarray(f) for f in feats], p, s, train=False)
        got, _ = bottleneck.dense_bottleneck(
            [_t(f) for f in feats],
            {"norm": {k: _t(v) for k, v in p["norm"].items()},
             "conv": _t(p["conv"])},
            {k: _t(v) for k, v in s.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
