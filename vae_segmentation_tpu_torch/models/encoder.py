"""Shape / image encoder (reference ``Encoder``, joint_model.py:274-305;
counterpart of vae_segmentation_tpu/models/encoder.py).

The VAE encoder's trunk (``encode_trunk``: in_block, its norm+ReLU as
down1's K2 prologue, down1-5, 128^3 -> 4^3 at 8 -> 256 channels), the
channel-major flatten to the bottleneck (16384 at 128^3), then fc1
16384 -> 1024, ReLU, fc2 1024 -> 128, ReLU, fc_mean 128 -> dim and a
sigmoid in f32. The dense layers are ``F.linear`` in the compute dtype, as
the VAE's. ``dim=1`` is the shape discriminator of Joint2
(``discriminator_train``, ``domain_adaptation_dis``), ``dim=128`` the image
encoder of Embed (``embed_train``, ``refine_vae``). ``norm_type`` 2 or 3
builds its blocks with that norm (encoder.py:41,52 of the JAX package).
Under a 'spatial' axis the trunk's output is gathered over the data row
before the flatten, as the VAE's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from vae_segmentation_tpu_torch.models.blocks import (
    DEFAULT_FMAPS, ConvNormAct, Down, torch_uniform_init)
from vae_segmentation_tpu_torch.parallel import collectives, sharding


def linear(cin: int, cout: int, generator) -> nn.Linear:
    """nn.Linear with torch's default init drawn from `generator`."""
    lin = nn.Linear(cin, cout)
    with torch.no_grad():
        lin.weight.copy_(torch_uniform_init((cout, cin), cin, generator))
        lin.bias.copy_(torch_uniform_init((cout,), cin, generator))
    return lin


def dense(x: torch.Tensor, layer: nn.Linear,
          dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


def bottleneck_side(bottleneck: int, channels: int) -> int:
    """The side s of the bottleneck volume: bottleneck = channels * s^3."""
    side = round((bottleneck // channels) ** (1.0 / 3.0))
    if channels * side ** 3 != bottleneck:
        raise ValueError(f"bottleneck {bottleneck} is not fmaps[5]="
                         f"{channels} times a cube")
    return side


def flatten(h: torch.Tensor) -> torch.Tensor:
    """[B, s, s, s, C] -> [B, C * s^3], channel-major like the reference's
    view of NCDHW (the order the bottleneck's dense layer expects)."""
    return h.permute(0, 4, 1, 2, 3).reshape(h.shape[0], -1)


def encode_trunk(net: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The encoder trunk of a ShapeVAE or ShapeEncoder `net` (in_block,
    down1-5) on x, flattened to [B, bottleneck]: the whole volume's under a
    'spatial' axis."""
    x1, aff = net.in_block(x.to(net.dtype))
    h = net.down1(x1, pre=aff)
    for down in (net.down2, net.down3, net.down4, net.down5):
        h = down(h)
    mesh = sharding.spatial_mesh(h)
    if mesh is not None:
        h = collectives.gather_spatial(h, mesh)
    return flatten(h)


class ShapeEncoder(nn.Module):
    """[B, D, H, W, n_channels] -> sigmoid embedding [B, dim], f32."""

    def __init__(self, dim: int = 1, fmaps: Sequence[int] = DEFAULT_FMAPS,
                 bottleneck: int = 16384,
                 dtype: torch.dtype = torch.bfloat16, n_channels: int = 1,
                 generator: Optional[torch.Generator] = None,
                 norm_type: int = 1):
        super().__init__()
        f = tuple(fmaps)
        bottleneck_side(bottleneck, f[5])
        self.dtype = dtype
        g, nt = generator, norm_type
        self.in_block = ConvNormAct(n_channels, f[0], g, norm_type=nt)
        self.down1 = Down(f[0], f[1], g, norm_type=nt)
        self.down2 = Down(f[1], f[2], g, norm_type=nt)
        self.down3 = Down(f[2], f[3], g, norm_type=nt)
        self.down4 = Down(f[3], f[4], g, norm_type=nt)
        self.down5 = Down(f[4], f[5], g, norm_type=nt)
        self.fc1 = linear(bottleneck, 1024, g)
        self.fc2 = linear(1024, 128, g)
        self.fc_mean = linear(128, dim, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(dense(encode_trunk(self, x), self.fc1, self.dtype))
        h = torch.relu(dense(h, self.fc2, self.dtype))
        return torch.sigmoid(dense(h, self.fc_mean, self.dtype).float())
