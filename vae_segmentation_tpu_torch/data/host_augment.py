"""The training warp on the host, for ``--aug_host`` (the port's copy of
vae_segmentation_tpu/data/host_augment.py; numpy + scipy, the same law and
the same draws).

The reference warps on 16 CPU worker processes beside the GPU
(utils/utils.py:927-969 via the DataLoader at main_source.py:191-206). The
default ingest warps on the device instead (``data/augment.py``); with
``--aug_host`` the loader's worker threads apply this module's warp
(``data/pipeline.py::AugmentedDataset``) and the device ingest only
normalises. The law, the scipy formulation batchgenerators wraps:
  * a rotation uniform in (-0.2, 0.2) rad about each axis, composed
    Rx @ Ry @ Rz and applied transposed (rotate_coords_3d);
  * the split zoom draw: half the time uniform(0.85, 1), half uniform(1,
    1.15);
  * a crop centre uniform in [patch//2 - 5, shape - (patch//2 - 5)];
  * the image by scipy map_coordinates at order 1 or 3, constant border
    -1024; the label at order 0, constant border 0.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
from scipy.ndimage import map_coordinates

ROT_RANGE = 0.2
SCALE_RANGE = (0.85, 1.15)
CVAL_IMAGE = -1024.0
CVAL_LABEL = 0.0


def _rot_matrix(ax: float, ay: float, az: float) -> np.ndarray:
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rx @ ry @ rz


def warp_coords(angles: np.ndarray, scale: float, center: np.ndarray,
                patch_size: Sequence[int]) -> np.ndarray:
    """[3, *patch] sample coordinates of the affine warp, f64."""
    axes = [np.arange(s, dtype=np.float64) - (s - 1) / 2.0
            for s in patch_size]
    coords = np.stack(np.meshgrid(*axes, indexing="ij"), axis=0)
    m = _rot_matrix(*angles)
    coords = (m.T @ coords.reshape(3, -1)).reshape(coords.shape)
    coords = coords * scale
    return coords + np.asarray(center, np.float64)[:, None, None, None]


def draw_params(rng: np.random.Generator, in_shape: Sequence[int],
                patch_size: Sequence[int]):
    """(angles, scale, center) drawn from `rng` by the reference's law."""
    angles = rng.uniform(-ROT_RANGE, ROT_RANGE, 3)
    if rng.random() < 0.5:
        scale = rng.uniform(SCALE_RANGE[0], 1.0)
    else:
        scale = rng.uniform(1.0, SCALE_RANGE[1])
    dist = np.array([p // 2 - 5 for p in patch_size], np.float64)
    center = dist + rng.random(3) * (np.asarray(in_shape, np.float64)
                                     - 2 * dist)
    return angles, float(scale), center


def apply_warp(image: np.ndarray, label: np.ndarray, angles, scale,
               center, patch_size: Sequence[int], order: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(image, label) warped into [*patch], f32: the image at `order`, the
    label nearest; both with scipy's hard constant border."""
    coords = warp_coords(np.asarray(angles, np.float64), float(scale),
                         center, patch_size)
    img = map_coordinates(image.astype(np.float64), coords, order=order,
                          mode="constant", cval=CVAL_IMAGE)
    lab = map_coordinates(label.astype(np.float64), coords, order=0,
                          mode="constant", cval=CVAL_LABEL)
    return img.astype(np.float32), lab.astype(np.float32)


def augment_spatial_host(image: np.ndarray, label: np.ndarray,
                         rng: np.random.Generator,
                         patch_size: Sequence[int], order: int = 3
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """One sample's random affine warp, drawn from `rng`."""
    angles, scale, center = draw_params(rng, image.shape, patch_size)
    return apply_warp(image, label, angles, scale, center, patch_size,
                      order)
