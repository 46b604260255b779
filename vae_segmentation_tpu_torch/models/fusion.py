"""Two-branch fusion U-Net (reference ``Fusion``, joint_model.py:392-436;
counterpart of vae_segmentation_tpu/models/fusion.py).

An image branch (in_block, down1) and a mask branch (in_block_mask,
down1_mask), each entry norm+ReLU the K2 prologue of its Down, are added
at the stride-2 scale and merged by a conv (``merge``); then SegUNet's body
(down2-4, up2-5, skip-adds after up3 and up4) and the 3^3 head with the
class softmax in K1's epilogue, up5's norm+ReLU its prologue. A deferred
norm cannot cross an add, so both Down outputs, merge's output (the
up4 skip) and the skip operands are normalized where they are made.
``norm_type`` 2 or 3 builds every block, ``merge`` included, with that norm
(fusion.py:31,42 of the JAX package). Used only by ``Embed``
(models/joint.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from vae_segmentation_tpu_torch.models.blocks import (
    DEFAULT_FMAPS, Conv3, ConvNormAct, Down, Up, apply_affine_relu)
from vae_segmentation_tpu_torch.parallel import sharding


class FusionNet(nn.Module):
    """(image [B, D, H, W, n_channels], mask [B, D, H, W, n_class]) ->
    probabilities [B, D, H, W, n_class] in the compute dtype."""

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
        self.in_block_mask = ConvNormAct(n_class, f[0], g, norm_type=nt)
        self.down1_mask = Down(f[0], f[1], g, norm_type=nt)
        self.merge = ConvNormAct(f[1], f[1], g, norm_type=nt)
        self.down2 = Down(f[1], f[2], g, norm_type=nt)
        self.down3 = Down(f[2], f[3], g, norm_type=nt)
        self.down4 = Down(f[3], f[4], g, norm_type=nt)
        self.up2 = Up(f[4], f[3], g, norm_type=nt)
        self.up3 = Up(f[3], f[2], g, norm_type=nt)
        self.up4 = Up(f[2], f[1], g, norm_type=nt)
        self.up5 = Up(f[1], f[0], g, norm_type=nt)
        self.out_block = Conv3(f[0], n_class, g)

    def forward(self, image: torch.Tensor, mask: torch.Tensor
                ) -> torch.Tensor:
        xi, aff_i = self.in_block(image.to(self.dtype))
        xm, aff_m = self.in_block_mask(mask.to(self.dtype))
        x2 = self.down1(xi, pre=aff_i)
        x2 = sharding.like(x2 + self.down1_mask(xm, pre=aff_m), x2)
        x2, aff2 = self.merge(x2)
        if aff2 is not None:
            x2 = apply_affine_relu(x2, aff2)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        h = self.up2(x5)
        h = sharding.like(self.up3(h) + x3, x3)
        h = sharding.like(self.up4(h) + x2, x2)
        h, aff5 = self.up5(h, defer=True)
        return self.out_block(h, pre=aff5, softmax=True)
