"""Shape-prior VAE (reference ``VAE``, joint_model.py:204-272; counterpart
of vae_segmentation_tpu/models/vae.py).

6-stage 3^3-conv encoder (8 -> 256 channels, 128^3 -> 4^3), channel-major
flatten to the bottleneck (16384 at 128^3, as the reference's
``x.view(B, -1)`` of NCDHW), fc_mean / fc_std (ReLU std) -> latent 128,
fc2 decode, 5 Up stages, softmax head. The dense layers are plain
``F.linear`` products in the compute dtype. ``if_random=True`` samples the
latent, mean + eps * std * scale, through ``ops.reparam`` (the hand-written
kernel on the card, eps drawn inside it from a seed out of the caller's
generator; vae.py:171-187 of the JAX package); ``reparameterize`` also
returns the KL term that the same call computes (the ``vae_train`` step).
The decoder's MC dropout is ported (joint_model.py:255-264). ``soft=True``
is the soft-ReLU VAE of --softrelu 1 (vae.py:58 of the JAX package): every
norm of its blocks takes softplus in place of ReLU, so none rides into a
kernel prologue (``models/blocks.py``). On the norm
route (``blocks.use_pallas_norm``) the blocks return normalized tensors and
no affine (vae.py:113-166 with ``fold`` false), as they do for
``norm_type`` 2 and 3 (vae.py:55,84 of the JAX package; with ``soft``:
the ``Norm``, then softplus).

Under a 'spatial' axis (``parallel.sharding``) the flatten needs the whole
4^3 volume: the encoder's output is gathered over the data row before
fc_mean / fc_std, and fc2's output, whole on every rank, is cut back to
the rank's planes (``blocks.spread``) before the decoder. Under a 'data'
axis each data rank draws its latent's eps from the step's seed plus its
data index and the KL is averaged over 'data' (the JAX package's
reparam.py:111-135).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from vae_segmentation_tpu_torch.models.blocks import (
    DEFAULT_FMAPS, Conv3, ConvNormAct, Down, Up, apply_affine_relu,
    mc_dropout, spread)
from vae_segmentation_tpu_torch.models.encoder import (
    bottleneck_side, dense, encode_trunk, flatten, linear)
from vae_segmentation_tpu_torch.ops import reparam
from vae_segmentation_tpu_torch.parallel import collectives, sharding


class ShapeVAE(nn.Module):
    """VAE over one-hot or probability masks [B, D, H, W, n_class]."""

    def __init__(self, n_class: int = 2, fmaps: Sequence[int] = DEFAULT_FMAPS,
                 dim: int = 128, bottleneck: int = 16384,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None,
                 soft: bool = False, norm_type: int = 1):
        super().__init__()
        f = tuple(fmaps)
        self.fmaps = f
        self.n_class = n_class
        self.dtype = dtype
        self.soft = soft
        self.side = bottleneck_side(bottleneck, f[5])
        g, kw = generator, dict(soft=soft, norm_type=norm_type)
        self.in_block = ConvNormAct(n_class, f[0], g, **kw)
        self.down1 = Down(f[0], f[1], g, **kw)
        self.down2 = Down(f[1], f[2], g, **kw)
        self.down3 = Down(f[2], f[3], g, **kw)
        self.down4 = Down(f[3], f[4], g, **kw)
        self.down5 = Down(f[4], f[5], g, **kw)
        self.fc_mean = linear(bottleneck, dim, g)
        self.fc_std = linear(bottleneck, dim, g)
        self.fc2 = linear(dim, bottleneck, g)
        self.up1 = Up(f[5], f[4], g, **kw)
        self.up2 = Up(f[4], f[3], g, **kw)
        self.up3 = Up(f[3], f[2], g, **kw)
        self.up4 = Up(f[2], f[1], g, **kw)
        self.up5 = Up(f[1], f[0], g, **kw)
        self.out_block = Conv3(f[0], n_class, g)

    def _dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return dense(x, layer, self.dtype)

    flatten = staticmethod(flatten)

    def unflatten(self, h: torch.Tensor) -> torch.Tensor:
        """Inverse of ``flatten``: fc2's output -> [B, s, s, s, C]."""
        s = self.side
        return h.reshape(h.shape[0], self.fmaps[5], s, s, s) \
            .permute(0, 2, 3, 4, 1).contiguous()

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mask -> (mean, std), f32, std >= 0 (joint_model.py:235-243)."""
        flat = encode_trunk(self, x)
        mean = self._dense(self.fc_mean, flat).float()
        std = torch.relu(self._dense(self.fc_std, flat).float())
        return mean, std

    def decode(self, z: torch.Tensor, dropout: float = 0.0,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Latent [B, dim] -> probabilities [B, D, H, W, n_class]
        (joint_model.py:252-266). dropout > 0 is the MC decoder dropout
        after every Up stage, drawn from ``generator``; up5's deferred norm
        is then applied inline before the last dropout instead of riding
        into the head's prologue (vae.py:141-165 of the JAX package)."""
        h = spread(self.unflatten(self._dense(self.fc2, z)))
        for up in (self.up1, self.up2, self.up3, self.up4):
            h = mc_dropout(up(h), dropout, generator)
        h, aff = self.up5(h, defer=True)
        if dropout:
            if aff is not None:
                h = apply_affine_relu(h, aff)
            h = mc_dropout(h, dropout, generator)
            aff = None
        return self.out_block(h, pre=aff, softmax=True)

    def reparameterize(self, mean: torch.Tensor, std: torch.Tensor,
                       scale: float, generator: Optional[torch.Generator]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(latent, kl): latent = mean + eps * std * scale and the batch-mean
        KL term, from one ``ops.reparam.reparam_kl`` call whose eps is drawn
        from a seed out of `generator` (on mean's device). At scale 0 the
        latent equals mean. Under a mesh: the seed plus the data index, and
        the KL averaged over 'data'."""
        seed = reparam.draw_seed(generator, mean.device)
        mesh = sharding.current()
        if mesh is not None:
            seed = (seed + mesh.data_index) % reparam.SEED_MAX
        latent, kl, _ = reparam.reparam_kl(mean, std, scale, seed)
        if mesh is not None:
            kl = collectives.data_mean(kl, mesh)
        return latent, kl

    def forward(self, x: torch.Tensor, if_random: bool = False,
                scale: float = 1.0, mid_input: bool = False,
                dropout: float = 0.0,
                generator: Optional[torch.Generator] = None):
        """(recon, mean, std), or recon alone with mid_input (x a latent).
        if_random samples the latent (``reparameterize``); ``generator``
        feeds that draw and the decoder's MC dropout."""
        if mid_input:
            return self.decode(x, dropout, generator)
        mean, std = self.encode(x)
        latent = self.reparameterize(mean, std, scale, generator)[0] \
            if if_random else mean
        return self.decode(latent, dropout, generator), mean, std
