"""TensorBoard observability (counterpart of vae_segmentation_tpu/obs/
saver.py; reference utils/saver.py:7-27).

``Saver(display_dir, display_freq).write_display(it, loss, image,
force_write)`` writes scalars and image-grid panels every display_freq
iterations and prints a ``name value it`` line a scalar, with or without a
writer. The values may be tensors on the card: they are copied to the host
on a display step only, so the iterations between cost no host sync.
tensorboardX is optional, as in the JAX package: without it the panels
and event files are off (said once on stdout) and the lines still print.
Image panels are [N, H, W] (or [N, 1, H, W]) mid-slice stacks; the grid is
torchvision's ``make_grid(nrow=5, padding=2)`` with the reference's
/2 + 0.5 display normalization.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_NOTICE = []   # the missing-writer notice, printed once a process


def summary_writer_class():
    """tensorboardX's SummaryWriter, or None (then said once on stdout)."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        if not _NOTICE:
            _NOTICE.append(True)
            print("tensorboardX is not installed: no TensorBoard event "
                  "files or panels (the scalar lines still print)")
        return None
    return SummaryWriter


def to_numpy(x) -> np.ndarray:
    """A tensor (any device or dtype) or array as a host numpy array, f32
    for a floating tensor."""
    if hasattr(x, "detach"):
        x = x.detach()
        if x.is_floating_point():
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def make_grid(images, nrow: int = 5, padding: int = 2,
              pad_value: float = 0.0) -> np.ndarray:
    """[N, H, W] -> [H', W'] tiled grid (torchvision make_grid semantics)."""
    images = to_numpy(images)
    if images.ndim == 4:  # [N, 1, H, W]
        images = images[:, 0]
    n, h, w = images.shape
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    grid = np.full((nrows * (h + padding) + padding,
                    ncol * (w + padding) + padding), pad_value,
                   dtype=np.float32)
    for i in range(n):
        r, c = divmod(i, ncol)
        y = r * (h + padding) + padding
        x = c * (w + padding) + padding
        grid[y:y + h, x:x + w] = images[i]
    return grid


class Saver:
    """Scalar + image TensorBoard writer; prints its scalars either way."""

    def __init__(self, display_dir: str, display_freq: int = 10):
        self.display_dir = display_dir
        self.display_freq = display_freq
        os.makedirs(display_dir, exist_ok=True)
        writer = summary_writer_class()
        self.writer = writer(logdir=display_dir) if writer is not None \
            else None

    def write_display(self, total_it: int, loss: Sequence[Tuple[str, object]],
                      image: Optional[Dict[str, object]] = None,
                      force_write: bool = False,
                      verbose: bool = True) -> None:
        if not (force_write or (total_it + 1) % self.display_freq == 0):
            return
        if self.writer is not None and image is not None:
            for name, im in image.items():
                grid = make_grid(im) / 2.0 + 0.5
                self.writer.add_image(name, grid[None], total_it)
        if self.writer is None and not verbose:
            return
        for name, value in loss:
            value = float(value)
            if self.writer is not None:
                self.writer.add_scalar(name, value, total_it)
            if verbose:
                print(name, value, total_it)

    def close(self):
        if self.writer is not None:
            self.writer.close()


class NullSaver:
    """The saver of a rank that does not write: does nothing."""

    def write_display(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


def mid_slice_panel(*volumes) -> np.ndarray:
    """Stack the mid-W slice of sample 0 of several [B, D, H, W(, C)]
    volumes (tensors or arrays; C is cut to its first channel) into an
    [N, D, H] panel: the reference's ``_display`` tensors
    (main_source.py:394-396)."""
    panels: List[np.ndarray] = []
    for v in volumes:
        v = to_numpy(v[:1])
        if v.ndim == 5:
            v = v[..., 0]
        w = v.shape[3]
        panels.append(v[0, :, :, w // 2])
    return np.stack(panels)
