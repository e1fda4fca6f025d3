"""Torch port: serving and decode against JAX on the CPU, and the port's
import boundary (no JAX)."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cunet_tpu.evaluation import decode as jax_decode
from cunet_tpu.serving import Predictor as JaxPredictor
from cunet_tpu_torch.evaluation import decode
from cunet_tpu_torch.kernels import buf_ops
from cunet_tpu_torch.serving import Predictor

from torch_port_util import TOL, images, np_weights, small_cfg

PAIRS = np.array([[0, 1]])   # toy flip table for 4 classes


@pytest.fixture(scope="module")
def weights():
    cfg = small_cfg(4, 2)
    return cfg, np_weights(cfg)


@pytest.mark.parametrize("kernel_path", [False, True, "slot"])
@pytest.mark.parametrize("flip_test", [False, True])
def test_heatmaps_match_jax_predictor(weights, kernel_path, flip_test):
    """6 images through a fixed batch of 4: one full and one padded chunk;
    f32 (``small_cfg``'s dtype). ``kernel_path``: False the plain path,
    True the whole-model path, "slot" the per-slot path (JAX's #4 in
    interpret mode against the port's per-slot kernels' plain versions)."""
    cfg, (pn, sn) = weights
    imgs = images(n=6, seed=2)
    slot = kernel_path == "slot"
    jcfg = dataclasses.replace(cfg, use_pallas=slot)
    want = JaxPredictor(jcfg, pn, sn, batch_size=4, flip_test=flip_test,
                        flip_pairs=PAIRS).heatmaps(imgs)
    tcfg = dataclasses.replace(cfg, use_pallas=bool(kernel_path),
                               pallas_whole_model=kernel_path is True)
    buf_ops.reset_launch_counts()
    pred = Predictor.from_jax_params(tcfg, pn, sn, device="cpu",
                                     batch_size=4, flip_test=flip_test,
                                     flip_pairs=PAIRS)
    got = pred.heatmaps(imgs)
    assert got.shape == want.shape == (6, 8, 8, 4)
    np.testing.assert_allclose(got, want, **TOL)
    assert not any(buf_ops.launch_counts().values())


def test_padding_does_not_change_real_samples(weights):
    cfg, (pn, sn) = weights
    pred = Predictor.from_jax_params(cfg, pn, sn, device="cpu", batch_size=4)
    imgs = images(n=6, seed=3)
    np.testing.assert_allclose(pred.heatmaps(imgs)[:4],
                               pred.heatmaps(imgs[:4]), rtol=1e-5, atol=1e-6)


def test_predict_matches_jax_predictor(weights):
    cfg, (pn, sn) = weights
    imgs = images(n=3, seed=4)
    centers = np.array([[14.0, 17.0], [16.0, 16.0], [10.5, 20.0]])
    scales = np.array([0.16, 0.2, 0.12])
    rots = np.array([0.0, 10.0, -25.0])
    want = JaxPredictor(cfg, pn, sn, batch_size=2, flip_test=True,
                        flip_pairs=PAIRS).predict(imgs, centers, scales, rots)
    pred = Predictor.from_jax_params(cfg, pn, sn, device="cpu", batch_size=2,
                                     flip_test=True, flip_pairs=PAIRS)
    got = pred.predict(imgs, centers, scales, rots)
    assert got.shape == want.shape == (3, 4, 2)
    # integer coordinates; a heatmap difference within TOL may move a
    # quarter-pixel refinement across a truncation boundary by one pixel
    np.testing.assert_allclose(got, want, atol=1)
    # without crop metadata: the heatmap-space defaults
    np.testing.assert_array_equal(pred.predict(imgs), decode.final_preds(
        pred.heatmaps(imgs), np.tile([4.0, 4.0], (3, 1)), np.full(3, 0.04),
        [8, 8], np.zeros(3)))


def _decode_cases():
    rng = np.random.RandomState(5)
    hm = rng.randn(4, 16, 16, 6).astype(np.float32)
    hm[0, :, :, 0] = -1.0                   # max <= 0 -> zeroed coords
    hm[1, :, :, 1] = 0.0
    hm[1, 3, 5, 1] = hm[1, 9, 2, 1] = 2.0   # tie -> first flat index
    hm[2, 0, 7, 2] = 9.0                    # peak on the top border
    hm[2, 15, 15, 3] = 9.0                  # peak in the corner
    hm[3, 6, 6, 4] = 9.0                    # flat neighbours: zero shift
    hm[3, 6, 5, 4] = hm[3, 6, 7, 4] = hm[3, 5, 6, 4] = hm[3, 7, 6, 4] = 1.0
    centers = rng.uniform(50, 150, (4, 2))
    scales = rng.uniform(0.5, 2.0, 4)
    rots = np.array([0.0, 30.0, -15.0, 90.0])
    return hm, centers, scales, rots


def test_decode_matches_jax_exactly():
    hm, centers, scales, rots = _decode_cases()
    preds = decode.get_preds(hm)
    np.testing.assert_array_equal(preds, jax_decode.get_preds(hm))
    np.testing.assert_array_equal(
        decode.quarter_pixel_refine(hm, preds),
        jax_decode.quarter_pixel_refine(hm, preds))
    np.testing.assert_array_equal(
        decode.final_preds(hm, centers, scales, [16, 16], rots),
        jax_decode.final_preds(hm, centers, scales, [16, 16], rots))
    assert (preds[0, 0] == 0).all()
    np.testing.assert_array_equal(preds[1, 1], [6, 4])


def test_port_imports_no_jax():
    """Every module of the port, and ``chip_smoke``, imports with JAX and
    the JAX package (``cunet_tpu``, jax-free modules included) blocked by a
    ``sys.meta_path`` finder, and none of them is loaded afterwards."""
    code = (
        "import importlib, importlib.abc, pkgutil, sys\n"
        "BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'cunet_tpu')\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'blocked import of {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import cunet_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    cunet_tpu_torch.__path__, 'cunet_tpu_torch.')]\n"
        "for name in mods + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)\n"
        "assert not bad, bad\n"
        "assert len(mods) > 30, mods\n"
        "assert {'cunet_tpu_torch.kernels.fused_block',\n"
        "        'cunet_tpu_torch.kernels.fused_model'} <= set(mods), mods\n"
    )
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
