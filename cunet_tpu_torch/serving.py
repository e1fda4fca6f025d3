"""Inference serving: weights -> fixed-batch forward -> landmarks.

Counterpart of ``cunet_tpu/serving.py``. The predictor runs the eval forward
at a fixed batch size (ragged requests are padded to it, so every call has
the same shapes), optionally mirror-ensembles with the flip test, and
decodes heatmaps to landmark coordinates with the reference-exact
quarter-pixel decode. With ``cfg.use_pallas`` (bf16 or float32, the
float model or the quantized one) the forward runs the hand-written kernels: with the default flags every slot on the per-slot
hourglass kernels, as JAX's ``Predictor`` runs them, with
``cfg.pallas_whole_model`` the whole-model eval kernels, and with
``pallas_hourglass=False`` under ``use_scan`` the steady slots on the
per-block kernels; the folded kernel weights of each are marshalled once,
here, not per request. With an int8
``quant`` config (``int8_infer=True``) and weights from
``quant_eval_params`` it serves the quantized model, on the whole-model
int8 kernels with ``pallas_whole_model`` and ``int8_impl="pallas"``, else
layer by layer (with ``use_pallas`` on the per-bottleneck eval kernels).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cunet_tpu_torch.config import ModelConfig
from cunet_tpu_torch.geometry import MPII_FLIP_PAIRS, flip_test_merge
from cunet_tpu_torch.evaluation import final_preds
from cunet_tpu_torch.models import apply_cu_net, init_cu_net
from cunet_tpu_torch.models.cu_net import check_kernel_dtype, path_slots


class Predictor:
    """Landmark predictor.

    Args:
      cfg: model architecture (use_pallas for the kernel paths on the
        card, at bf16 or float32: per slot with the
        default flags, the whole model with ``pallas_whole_model``, per
        block with ``pallas_hourglass=False``).
      params/bn_state: flat tensor dicts (``cunet_tpu_torch.models``
        layout); default = random init from ``seed``.
      device: where the forward runs, e.g. ``"cuda"`` or ``"cpu"``.
      batch_size: fixed forward batch; requests are padded/chunked to it.
      flip_test: mirror ensemble (MPII protocol).
      flip_pairs: left/right channel table for the flip test.
      quant: a ``QuantConfig`` for the quantized model (``params`` must
        then be ``quant_eval_params`` output).
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params=None,
        bn_state=None,
        *,
        device,
        batch_size: int = 16,
        flip_test: bool = False,
        flip_pairs=MPII_FLIP_PAIRS,
        seed: int = 0,
        quant=None,
    ):
        self.cfg = cfg
        self.quant = quant
        self.device = torch.device(device)
        check_kernel_dtype(cfg, self.device, quant=quant)
        self.batch_size = batch_size
        self.flip_test = flip_test
        self.flip_pairs = flip_pairs
        if params is None or bn_state is None:
            params, bn_state = init_cu_net(
                cfg, torch.Generator().manual_seed(seed), device=self.device)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.bn_state = {k: v.to(self.device) for k, v in bn_state.items()}
        self.dtype = getattr(torch, cfg.compute_dtype)
        self._slots = path_slots(self.params, self.bn_state, cfg, quant)

    @classmethod
    def from_jax_params(cls, cfg: ModelConfig, params_np, state_np, *,
                        device, **kw):
        """From JAX ``(params, bn_state)`` trees with numpy leaves."""
        from cunet_tpu_torch.tools.from_jax import from_jax

        params, state = from_jax(params_np, state_np, cfg, device=device)
        return cls(cfg, params, state, device=device, **kw)

    # -- inference ---------------------------------------------------------
    @torch.inference_mode()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """One fixed-batch forward: (B, H, W, 3) -> last head's heatmaps."""
        outs, _ = apply_cu_net(self.params, self.bn_state, x, cfg=self.cfg,
                               slots=self._slots, quant=self.quant)
        return outs[-1]

    def _run(self, chunk: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(
            self.device, self.dtype)
        return self.forward(x).float().cpu().numpy()

    def heatmaps(self, images: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) float [0, 1] -> (N, h, w, class_num) heatmaps.

        Chunks/pads to the fixed batch size; applies flip-test merging."""
        n = images.shape[0]
        outs = []
        for lo in range(0, n, self.batch_size):
            chunk = images[lo:lo + self.batch_size]
            pad = self.batch_size - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
            out = self._run(chunk)
            if self.flip_test:
                out = flip_test_merge(out, self._run(chunk[:, :, ::-1, :]),
                                      self.flip_pairs)
            outs.append(out[:self.batch_size - pad])
        return np.concatenate(outs, axis=0)

    def predict(
        self,
        images: np.ndarray,
        centers: Optional[np.ndarray] = None,
        scales: Optional[np.ndarray] = None,
        rots: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Images -> (N, L, 2) landmark coordinates.

        With crop metadata, coordinates map back to original-image space
        through the quarter-pixel-refined inverse affine; otherwise they are
        1-indexed heatmap-space coordinates."""
        hm = self.heatmaps(images)
        n, h, w = hm.shape[0], hm.shape[1], hm.shape[2]
        if centers is None:
            centers = np.tile([w / 2, h / 2], (n, 1))
            scales = np.full(n, w / 200.0)
            rots = np.zeros(n)
        if rots is None:
            rots = np.zeros(n)
        return final_preds(hm, centers, scales, [w, h], rots)
