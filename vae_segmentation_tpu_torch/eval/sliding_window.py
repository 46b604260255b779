"""Sliding-window inference over a full volume, stitched on the device
(counterpart of vae_segmentation_tpu/eval/sliding_window.py).

The volume is tiled with overlapping patches (``window_starts``); the
patches run through ``seg_fn`` a chunk of ``batch`` windows at a time, and
each window's probabilities, weighted by a centred Gaussian
(``gaussian_weight``), are added into f32 accumulators of the volume's
size on the volume's device, window by window in ``window_starts`` order.
The result is the weighted mean. No step of the loop waits for the device:
the window origins are host integers and nothing is read back.

The JAX package pads the last chunk with copies of the last window at
weight 0 so that every chunk has one shape; this port runs a shorter last
chunk instead. Both add the same terms in the same order (a zero-weight
term adds 0), so the stitched probabilities are the same.

Connected-component post-processing is host-side scipy
(``eval/postprocess.py``).
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from vae_segmentation_tpu_torch.models.blocks import refusing_batch_norm


def window_starts(vol_size: Sequence[int], patch: Sequence[int],
                  overlap: float = 0.5) -> np.ndarray:
    """[N, 3] int32 window origins covering the volume: stride
    max(1, int(p * (1 - overlap))) an axis, the last window clamped to the
    boundary, [0] on an axis no larger than the patch."""
    starts_per_axis = []
    for size, p in zip(vol_size, patch):
        if size <= p:
            starts_per_axis.append([0])
            continue
        stride = max(1, int(p * (1.0 - overlap)))
        n = math.ceil((size - p) / stride) + 1
        axis = [min(i * stride, size - p) for i in range(n)]
        starts_per_axis.append(sorted(set(axis)))
    return np.array(list(itertools.product(*starts_per_axis)), np.int32)


def gaussian_weight(patch: Sequence[int], sigma_scale: float = 0.125
                    ) -> torch.Tensor:
    """The separable window weight [*patch], f32: exp(-x^2 / (2 sigma^2))
    an axis with sigma = p * sigma_scale around the patch centre, floored
    at 1e-4 (nnU-Net's importance map), computed in numpy as the JAX
    package does."""
    axes = []
    for p in patch:
        x = np.arange(p, dtype=np.float32) - (p - 1) / 2.0
        sigma = p * sigma_scale
        axes.append(np.exp(-0.5 * (x / sigma) ** 2))
    w = axes[0][:, None, None] * axes[1][None, :, None] \
        * axes[2][None, None, :]
    return torch.from_numpy(np.maximum(w, 1e-4).astype(np.float32))


@torch.no_grad()
def stitch(seg_fn: Callable[[torch.Tensor], torch.Tensor],
           volume: torch.Tensor, starts: np.ndarray,
           patch: Tuple[int, int, int], batch: int, n_class: int
           ) -> torch.Tensor:
    """Weighted mean [D, H, W, n_class] f32 of seg_fn's probabilities over
    the windows at `starts` of a [D, H, W] f32 volume. Each chunk of
    `batch` windows is gathered into a contiguous [b, *patch, 1] tensor;
    seg_fn's output (bf16 or f32) is cast to f32 before weighting."""
    d, h, w = volume.shape
    pd, ph, pw = patch
    dev = volume.device
    weight = gaussian_weight(patch).to(dev)
    wc = weight[..., None]
    acc = torch.zeros((d, h, w, n_class), dtype=torch.float32, device=dev)
    acc_w = torch.zeros((d, h, w), dtype=torch.float32, device=dev)
    origins = [tuple(int(v) for v in s) for s in starts]
    for c0 in range(0, len(origins), batch):
        chunk = origins[c0:c0 + batch]
        patches = torch.stack([volume[z:z + pd, y:y + ph, x:x + pw]
                               for z, y, x in chunk])[..., None].contiguous()
        probs = seg_fn(patches).float() * wc
        for j, (z, y, x) in enumerate(chunk):
            acc[z:z + pd, y:y + ph, x:x + pw] += probs[j]
            acc_w[z:z + pd, y:y + ph, x:x + pw] += weight
    return acc / torch.clamp(acc_w, min=1e-8)[..., None]


@refusing_batch_norm()
def sliding_window_predict(seg_fn: Callable[[torch.Tensor], torch.Tensor],
                           volume: torch.Tensor,
                           patch: Tuple[int, int, int] = (128, 128, 128),
                           overlap: float = 0.5, batch: int = 4,
                           n_class: int = 2) -> torch.Tensor:
    """Full-volume class probabilities [D, H, W, n_class] f32 of a
    [D, H, W] volume (normalised already), on the volume's device.

    seg_fn(images [B, *patch, 1]) -> probs [B, *patch, n_class], e.g. a
    SegUNet or ``Joint.segment``. A volume smaller than `patch` on an axis
    is padded there with its minimum and cropped back."""
    vol = volume.float()
    orig = tuple(vol.shape)
    padded = tuple(max(s, p) for s, p in zip(orig, patch))
    if padded != orig:
        # filled on the device from the 0-dim minimum: no host read-back
        big = vol.new_empty(padded)
        big.fill_(vol.min())
        big[:orig[0], :orig[1], :orig[2]] = vol
        vol = big
    starts = window_starts(vol.shape, patch, overlap)
    probs = stitch(seg_fn, vol, starts, tuple(patch), batch, n_class)
    return probs[:orig[0], :orig[1], :orig[2]]
