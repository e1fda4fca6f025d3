"""Crop geometry and the flip table the port uses (its own copy of what it
needs from ``cunet_tpu/geometry.py``): the inverse crop affine of the
decode, the MPII left/right joint pairs and the flip-test merge.

The crop transform maps a square window of side ``size * scale`` centred at
``center`` in the original image onto a ``res x res`` output, rotated about
the output centre; the decode's inverse keeps the reference's int
truncation, which moves the metric.
"""

from __future__ import annotations

import numpy as np

REF_SIZE = 200  # canonical person-box side; scale is in units of 200 px

# MPII 16-joint left/right pairs
MPII_FLIP_PAIRS = np.array([[1, 4], [0, 5], [12, 13], [11, 14], [10, 15],
                            [2, 3]])


def get_transform(center, scale, rot, res, size=REF_SIZE) -> np.ndarray:
    """3x3 affine: original-image coords -> res x res crop coords."""
    h = size * scale
    t = np.zeros((3, 3))
    t[0, 0] = res / h
    t[1, 1] = res / h
    t[0, 2] = res * (-float(center[0]) / h + 0.5)
    t[1, 2] = res * (-float(center[1]) / h + 0.5)
    t[2, 2] = 1
    if rot != 0:
        rot = -rot  # cropping rotates the window, points rotate oppositely
        rot_rad = rot * np.pi / 180
        sn, cs = np.sin(rot_rad), np.cos(rot_rad)
        rot_mat = np.array([[cs, -sn, 0], [sn, cs, 0], [0, 0, 1]])
        t_to = np.eye(3)
        t_to[:2, 2] = -res / 2
        t_from = np.eye(3)
        t_from[:2, 2] = res / 2
        t = t_from @ rot_mat @ t_to @ t
    return t


def transform_pts(pts, center, scale, rot, res, size=REF_SIZE, invert=False):
    """Float affine of an (L, 2) point array."""
    t = get_transform(center, scale, rot, res, size)
    if invert:
        t = np.linalg.inv(t)
    homo = np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1).T
    return (t @ homo)[:2].T


def transform_preds_1indexed(coords, center, scale, rot, res, size=REF_SIZE):
    """Invert the crop affine on 1-indexed heatmap coords: subtract 1, the
    inverse affine, truncate to int, add 1."""
    out = transform_pts(coords - 1, center, scale, rot, res, size, invert=True)
    return out.astype(int) + 1


def flip_channels(maps):
    """Mirror NHWC or HWC heatmaps along W."""
    return maps[..., :, ::-1, :]


def shuffle_flip_pairs(maps, pairs):
    """Swap the left/right channels of NHWC or HWC heatmaps."""
    perm = np.arange(maps.shape[-1])
    for a, b in pairs:
        perm[a], perm[b] = perm[b], perm[a]
    return maps[..., perm]


def flip_test_merge(output, flipped_output, pairs):
    """Average the straight view with the de-flipped mirrored view."""
    unflipped = shuffle_flip_pairs(flip_channels(flipped_output), pairs)
    return (output + unflipped) / 2
