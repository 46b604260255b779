"""Segmentation U-Net (reference ``Segmentation``, joint_model.py:349-390;
counterpart of vae_segmentation_tpu/models/unet.py).

5-stage encoder (8 -> 128 channels, 128^3 -> 8^3), 4-stage decoder with
skip-adds after up3 and up4 (joint_model.py:380-382), 3^3 conv head with
the class softmax in K1's epilogue. The in_block's norm+ReLU is the down1
entry's prologue and up5's final norm+ReLU the head's prologue
(unet.py:92-120 of the JAX package); with MC dropout active the norm is
applied inline and the softmax follows the head's own dropout. On the norm
route (``blocks.use_pallas_norm``) the blocks return normalized tensors and
no affine (unet.py:86-137 with ``fold`` false), as they do for
``norm_type`` 2 (BatchNorm) and 3 (GSNorm): each conv, its ``Norm``, the
activation (unet.py:37,64: the JAX model folds and fuses only at
norm_type 1). Under a mesh the blocks' shard wraps take the rank's slice;
a skip-add keeps its operands' layout.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from vae_segmentation_tpu_torch.models.blocks import (
    DEFAULT_FMAPS, Conv3, ConvNormAct, Down, Up, apply_affine_relu,
    mc_dropout)
from vae_segmentation_tpu_torch.parallel import sharding


class SegUNet(nn.Module):
    """[B, D, H, W, n_channels] image -> [B, D, H, W, n_class] probabilities
    in the compute dtype."""

    def __init__(self, n_class: int = 2, fmaps: Sequence[int] = DEFAULT_FMAPS,
                 dtype: torch.dtype = torch.bfloat16, n_channels: int = 1,
                 generator: Optional[torch.Generator] = None,
                 norm_type: int = 1):
        super().__init__()
        f = tuple(fmaps)
        self.n_class = n_class
        self.dtype = dtype
        g, nt = generator, norm_type
        self.in_block = ConvNormAct(n_channels, f[0], g, norm_type=nt)
        self.down1 = Down(f[0], f[1], g, norm_type=nt)
        self.down2 = Down(f[1], f[2], g, norm_type=nt)
        self.down3 = Down(f[2], f[3], g, norm_type=nt)
        self.down4 = Down(f[3], f[4], g, norm_type=nt)
        self.up2 = Up(f[4], f[3], g, norm_type=nt)
        self.up3 = Up(f[3], f[2], g, norm_type=nt)
        self.up4 = Up(f[2], f[1], g, norm_type=nt)
        self.up5 = Up(f[1], f[0], g, norm_type=nt)
        self.out_block = Conv3(f[0], n_class, g)

    def forward(self, x: torch.Tensor, dropout: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """dropout > 0: MC dropout after each decoder stage and around the
        head conv, before the softmax (joint_model.py:379-387)."""
        def drop(h):
            return mc_dropout(h, dropout, generator)

        x1, aff1 = self.in_block(x.to(self.dtype))
        x2 = self.down1(x1, pre=aff1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        h = drop(self.up2(x5))
        h = drop(sharding.like(self.up3(h) + x3, x3))
        h = drop(sharding.like(self.up4(h) + x2, x2))
        h, aff5 = self.up5(h, defer=True)
        if not dropout:
            return self.out_block(h, pre=aff5, softmax=True)
        if aff5 is not None:
            h = apply_affine_relu(h, aff5)
        h = drop(self.out_block(drop(h)))
        return sharding.like(torch.softmax(h.float(), dim=-1).to(self.dtype),
                             h)
