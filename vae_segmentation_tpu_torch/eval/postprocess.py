"""Host-side connected-component post-processing (a copy of
vae_segmentation_tpu/eval/postprocess.py, scipy only).

Replaces the reference's SimpleITK ConnectedComponent/RelabelComponent
filters (utils/utils.py:776-802) and its flood fill (utils/utils.py:20-57)
with scipy.ndimage. It runs on the argmax map on the host, outside the
device loop, as the reference's SimpleITK filters did.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def largest_components(mask: np.ndarray, *, min_voxels: int = 10000,
                       keep: int = 2, connectivity: int = 3) -> np.ndarray:
    """Keep the up-to-`keep` largest components with >= min_voxels voxels:
    the predict_vol rule (utils/utils.py:791-796: drop components smaller
    than 10000 voxels or ranked worse than 2nd). int8 mask."""
    structure = ndimage.generate_binary_structure(3, connectivity)
    labeled, n = ndimage.label(mask > 0, structure=structure)
    if n == 0:
        return np.zeros_like(mask, dtype=np.int8)
    sizes = ndimage.sum_labels(np.ones_like(labeled), labeled,
                               index=np.arange(1, n + 1))
    order = np.argsort(sizes)[::-1]
    out = np.zeros_like(mask, dtype=np.int8)
    for rank, comp_idx in enumerate(order):
        if rank >= keep or sizes[comp_idx] < min_voxels:
            break
        out[labeled == comp_idx + 1] = 1
    return out


def connected_components(mask: np.ndarray, connectivity: int = 3):
    """(label map, component count) of a mask (the check_connection
    capability, utils/utils.py:38-57)."""
    structure = ndimage.generate_binary_structure(3, connectivity)
    return ndimage.label(mask > 0, structure=structure)
