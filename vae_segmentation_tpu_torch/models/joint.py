"""Seg -> VAE(pred) composite (reference ``Joint``, joint_model.py:438-452;
counterpart of vae_segmentation_tpu/models/joint.py). Submodule names
``Seg`` and ``Vae`` give the reference's ``Seg.*`` / ``Vae.*`` state_dict
keys. Eval path only: no dropout, no sampled latent."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from vae_segmentation_tpu_torch.models.blocks import DEFAULT_FMAPS
from vae_segmentation_tpu_torch.models.unet import SegUNet
from vae_segmentation_tpu_torch.models.vae import ShapeVAE


class Joint(nn.Module):

    def __init__(self, n_class: int = 2, dim: int = 128,
                 fmaps: Sequence[int] = DEFAULT_FMAPS,
                 bottleneck: int = 16384,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_class = n_class
        self.Seg = SegUNet(n_class=n_class, fmaps=fmaps, dtype=dtype,
                           generator=generator)
        self.Vae = ShapeVAE(n_class=n_class, fmaps=fmaps, dim=dim,
                            bottleneck=bottleneck, dtype=dtype,
                            generator=generator)

    def forward(self, image: torch.Tensor):
        """image [B, D, H, W, 1] -> (pred, recon, mean, std)."""
        pred = self.Seg(image)
        recon, mean, std = self.Vae(pred)
        return pred, recon, mean, std

    def segment(self, image: torch.Tensor) -> torch.Tensor:
        return self.Seg(image)

    def vae_forward(self, x: torch.Tensor, mid_input: bool = False):
        """Raw-in/raw-out VAE access: (recon, mean, std) of a mask, or the
        decode of a latent with mid_input."""
        return self.Vae(x, mid_input=mid_input)
