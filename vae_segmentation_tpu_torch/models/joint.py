"""The composites (reference ``Joint``, ``Joint2``, ``Embed``,
joint_model.py:438-501; counterpart of vae_segmentation_tpu/models/
joint.py). Submodule names give the reference's state_dict keys:
``Seg.*`` / ``Vae.*`` (Joint), ``Seg.*`` / ``Dis.*`` (Joint2),
``Encoder.*`` / ``Vae.*`` / ``Fusion.*`` (Embed).

Joint: Seg -> VAE(pred). ``dropout=True`` turns on the MC branch
(joint_model.py:447-451): ``seg_dropout`` in the Seg decoder and
``vae_decoder_dropout`` in the VAE decoder. The latent is never sampled
(the trainers keep ``vae_forward_scale`` at 0).

Joint2: Seg -> the discriminator's score of the class-1 channel
(joint_model.py:455-466), with the Seg's MC dropout when asked.

Embed: the latent-space segmentation of ``embed_train`` / ``refine_vae``
(joint_model.py:469-501): the image Encoder's latent decoded by the VAE
(``init_seg``), the VAE of the ground truth with a sampled latent (scale
0.5, one ``reparam_kl`` call, which also gives the KL of its (mean, std)),
the FusionNet of the image and a mask (``init_seg`` in test mode, else
the ground truth's reconstruction) and the VAE of the detached
``init_seg``.

Each takes ``norm_type`` (default 1) and passes it to its networks
(joint.py:39,78-81,146-155,170-183 of the JAX package).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from vae_segmentation_tpu_torch.models.blocks import DEFAULT_FMAPS
from vae_segmentation_tpu_torch.models.encoder import ShapeEncoder
from vae_segmentation_tpu_torch.models.fusion import FusionNet
from vae_segmentation_tpu_torch.models.unet import SegUNet
from vae_segmentation_tpu_torch.models.vae import ShapeVAE


class Joint(nn.Module):

    def __init__(self, n_class: int = 2, dim: int = 128,
                 fmaps: Sequence[int] = DEFAULT_FMAPS,
                 bottleneck: int = 16384,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None,
                 vae_decoder_dropout: float = 0.0, seg_dropout: float = 0.0,
                 norm_type: int = 1):
        super().__init__()
        self.n_class = n_class
        self.vae_decoder_dropout = vae_decoder_dropout
        self.seg_dropout = seg_dropout
        self.Seg = SegUNet(n_class=n_class, fmaps=fmaps, dtype=dtype,
                           generator=generator, norm_type=norm_type)
        self.Vae = ShapeVAE(n_class=n_class, fmaps=fmaps, dim=dim,
                            bottleneck=bottleneck, dtype=dtype,
                            generator=generator, norm_type=norm_type)

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


class Joint2(nn.Module):

    def __init__(self, n_class: int = 2, fmaps: Sequence[int] = DEFAULT_FMAPS,
                 bottleneck: int = 16384,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None,
                 seg_dropout: float = 0.0, norm_type: int = 1):
        super().__init__()
        self.n_class = n_class
        self.seg_dropout = seg_dropout
        self.Seg = SegUNet(n_class=n_class, fmaps=fmaps, dtype=dtype,
                           generator=generator, norm_type=norm_type)
        self.Dis = ShapeEncoder(dim=1, fmaps=fmaps, bottleneck=bottleneck,
                                dtype=dtype, generator=generator,
                                norm_type=norm_type)

    def forward(self, image: torch.Tensor, dropout: bool = False,
                generator: Optional[torch.Generator] = None):
        """image [B, D, H, W, 1] -> (pred, score [B, 1] f32)."""
        pred = self.Seg(image, self.seg_dropout if dropout else 0.0,
                        generator)
        return pred, self.Dis(pred[..., 1:2].contiguous())


class Embed(nn.Module):

    def __init__(self, n_class: int = 2, dim: int = 128,
                 fmaps: Sequence[int] = DEFAULT_FMAPS,
                 bottleneck: int = 16384,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None,
                 norm_type: int = 1):
        super().__init__()
        self.n_class = n_class
        kw = dict(fmaps=fmaps, dtype=dtype, generator=generator,
                  norm_type=norm_type)
        self.Encoder = ShapeEncoder(dim=dim, bottleneck=bottleneck, **kw)
        self.Vae = ShapeVAE(n_class=n_class, dim=dim, bottleneck=bottleneck,
                            **kw)
        self.Fusion = FusionNet(n_class=n_class, **kw)

    def forward(self, image: torch.Tensor, gt_onehot: torch.Tensor,
                test_mode: bool = False,
                latent_input: Optional[torch.Tensor] = None,
                seg_input: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        """The reference's data_dict keys (joint_model.py:475-501):
        latent_code, gt_recon, latent_code_gt, latent_code_std, init_seg,
        pred, seg_recon; and 'kl', the KL of (latent_code_gt,
        latent_code_std) from the draw of the gt branch's latent, whose
        seed comes from `generator` (on the image's device)."""
        latent = self.Encoder(image) if latent_input is None \
            else latent_input
        mean, std = self.Vae.encode(gt_onehot)
        sample, kl = self.Vae.reparameterize(mean, std, 0.5, generator)
        gt_recon = self.Vae.decode(sample)
        init_seg = self.Vae.decode(latent) if seg_input is None \
            else seg_input
        pred = self.Fusion(image, init_seg if test_mode else gt_recon)
        seg_recon = self.Vae(init_seg.detach())[0]
        return {"latent_code": latent, "gt_recon": gt_recon,
                "latent_code_gt": mean, "latent_code_std": std,
                "init_seg": init_seg, "pred": pred, "seg_recon": seg_recon,
                "kl": kl}

    def segment(self, image: torch.Tensor) -> torch.Tensor:
        """The GT-free path of the sliding window: the Fusion of the image
        and the decode of its latent."""
        return self.Fusion(image, self.Vae.decode(self.Encoder(image)))
