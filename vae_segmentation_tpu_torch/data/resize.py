"""Host-side volume resize matching skimage.transform.resize semantics
(skimage is not a dependency). Counterpart of the JAX package's
data/resize.py: by default a 3D volume at order 0 or 1 goes through the
native loader's pool-parallel separable resize (``data/native_loader.py``,
``data/csrc/fastloader.cpp``); ``VAESEG_NATIVE_RESIZE=0``, the JAX
package's switch, selects the scipy version, which stays as the plain
version the native route is held against (tests/test_torch_native_loader.py).

The reference preprocesses with skimage.resize (utils/utils.py:288-291:
order-1 + anti-aliasing for images, order-0 without for labels).
scipy.ndimage.zoom(grid_mode=True, mode='grid-constant') uses the same
output->input coordinate convention as skimage.resize, and we reproduce
skimage's automatic anti-aliasing sigma max(0, (1/scale - 1) / 2) for
downscaling axes.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
from scipy import ndimage

from vae_segmentation_tpu_torch.data import native_loader


def resize_volume(vol: np.ndarray, output_size: Sequence[int], *,
                  order: int = 1, anti_aliasing: bool | None = None) -> np.ndarray:
    """Resize a 3D volume to output_size.

    order=1 + AA (default for images), order=0 (labels; AA off).
    """
    vol = np.asarray(vol)
    output_size = tuple(int(s) for s in output_size)
    if vol.shape == output_size:
        return vol.astype(np.float32, copy=False)
    factors = np.array(output_size, dtype=np.float64) / np.array(vol.shape)
    if anti_aliasing is None:
        anti_aliasing = order != 0
    if (os.environ.get("VAESEG_NATIVE_RESIZE", "1") == "1"
            and vol.ndim == 3 and order in (0, 1)):
        return native_loader.resize_volume(vol, output_size, order=order,
                                           anti_aliasing=anti_aliasing)
    work = vol.astype(np.float32, copy=False)
    if anti_aliasing:
        sigmas = np.maximum(0.0, (1.0 / factors - 1.0) / 2.0)
        if np.any(sigmas > 0):
            work = ndimage.gaussian_filter(work, sigma=sigmas, mode="mirror")
    out = ndimage.zoom(work, factors, order=order, grid_mode=True,
                       mode="grid-constant", prefilter=False)
    # zoom can be off by one voxel on awkward ratios; hard-assert the contract
    assert out.shape == output_size, (out.shape, output_size)
    return out.astype(np.float32, copy=False)
