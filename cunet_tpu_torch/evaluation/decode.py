"""Heatmap decoding on the host (counterpart of
``cunet_tpu/evaluation/decode.py``: ``get_preds``, ``quarter_pixel_refine``,
``final_preds``).

The decode math keeps every 1-indexing and int-truncation quirk of the
reference evaluation, because they move the metric:

- ``get_preds``: 1-indexed argmax over the flattened H*W, zeroed where the
  maximum is <= 0;
- ``final_preds``: a quarter-pixel shift by the sign of the neighbour
  gradient (only where 1 < px < W and 1 < py < H), then +0.5, then the
  inverse crop affine with its -1 / truncate / +1 steps.

Arrays are NHWC numpy arrays; the JAX package's module cannot be imported
here because its package imports JAX.
"""

from __future__ import annotations

import numpy as np

from cunet_tpu_torch.geometry import transform_preds_1indexed


def get_preds(scores: np.ndarray) -> np.ndarray:
    """(N, H, W, C) heatmaps -> (N, C, 2) 1-indexed (x, y); 0 where max <= 0.

    Ties resolve to the first flattened index."""
    n, h, w, c = scores.shape
    flat = scores.transpose(0, 3, 1, 2).reshape(n, c, h * w)
    idx = np.argmax(flat, axis=2)
    maxval = np.take_along_axis(flat, idx[:, :, None], axis=2)[:, :, 0]
    x = idx % w + 1
    y = idx // w + 1
    preds = np.stack([x, y], axis=2).astype(np.float64)
    preds *= (maxval > 0)[:, :, None]
    return preds


def quarter_pixel_refine(scores: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Shift 1-indexed argmax coords by 0.25 * sign(neighbour gradient),
    then add 0.5."""
    n, h, w, c = scores.shape
    hm = scores.transpose(0, 3, 1, 2)  # (N, C, H, W)
    out = coords.copy()
    px = np.floor(coords[..., 0]).astype(int)
    py = np.floor(coords[..., 1]).astype(int)
    ok = (px > 1) & (px < w) & (py > 1) & (py < h)
    ni, ci = np.nonzero(ok)
    pxo, pyo = px[ni, ci], py[ni, ci]
    # 1-indexed coords into 0-indexed arrays: hm[py-1, px] is the right
    # neighbour of the peak
    dx = hm[ni, ci, pyo - 1, pxo] - hm[ni, ci, pyo - 1, pxo - 2]
    dy = hm[ni, ci, pyo, pxo - 1] - hm[ni, ci, pyo - 2, pxo - 1]
    out[ni, ci, 0] += np.sign(dx) * 0.25
    out[ni, ci, 1] += np.sign(dy) * 0.25
    return out + 0.5


def final_preds(scores, centers, scales, res, rots) -> np.ndarray:
    """Decode to original-image coordinates.

    Args: scores (N, H, W, C); centers (N, 2); scales (N,); res (w, h);
    rots (N,). Returns (N, C, 2) integer original-resolution predictions.
    """
    coords = quarter_pixel_refine(scores, get_preds(scores))
    preds = np.zeros_like(coords)
    for i in range(coords.shape[0]):
        preds[i] = transform_preds_1indexed(
            coords[i], np.asarray(centers[i]), float(scales[i]),
            float(rots[i]), res[0])
    return preds
