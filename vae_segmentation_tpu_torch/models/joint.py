"""Seg -> VAE(pred) composite (reference ``Joint``, joint_model.py:438-452;
counterpart of vae_segmentation_tpu/models/joint.py). Submodule names
``Seg`` and ``Vae`` give the reference's ``Seg.*`` / ``Vae.*`` state_dict
keys. ``dropout=True`` turns on the MC branch (joint_model.py:447-451):
``seg_dropout`` in the Seg decoder and ``vae_decoder_dropout`` in the VAE
decoder. The latent is never sampled (the trainers keep
``vae_forward_scale`` at 0)."""

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
                 generator: Optional[torch.Generator] = None,
                 vae_decoder_dropout: float = 0.0, seg_dropout: float = 0.0):
        super().__init__()
        self.n_class = n_class
        self.vae_decoder_dropout = vae_decoder_dropout
        self.seg_dropout = seg_dropout
        self.Seg = SegUNet(n_class=n_class, fmaps=fmaps, dtype=dtype,
                           generator=generator)
        self.Vae = ShapeVAE(n_class=n_class, fmaps=fmaps, dim=dim,
                            bottleneck=bottleneck, dtype=dtype,
                            generator=generator)

    def forward(self, image: torch.Tensor, dropout: bool = False,
                generator: Optional[torch.Generator] = None):
        """image [B, D, H, W, 1] -> (pred, recon, mean, std). dropout=True
        draws the MC dropout masks from ``generator`` (on the image's
        device)."""
        pred = self.Seg(image, self.seg_dropout if dropout else 0.0,
                        generator)
        recon, mean, std = self.Vae(
            pred, dropout=self.vae_decoder_dropout if dropout else 0.0,
            generator=generator)
        return pred, recon, mean, std

    def segment(self, image: torch.Tensor) -> torch.Tensor:
        return self.Seg(image)

    def encode_pred(self, pred: torch.Tensor):
        """VAE encode (mean, std) of a prediction: the teacher's KL path
        (train/steps.py)."""
        return self.Vae.encode(pred)

    def vae_forward(self, x: torch.Tensor, mid_input: bool = False):
        """Raw-in/raw-out VAE access: (recon, mean, std) of a mask, or the
        decode of a latent with mid_input."""
        return self.Vae(x, mid_input=mid_input)
