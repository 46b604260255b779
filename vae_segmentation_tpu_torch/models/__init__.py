"""SegUNet, ShapeVAE, ShapeEncoder, FusionNet and the composites Joint,
Joint2 and Embed in the logical channels-last representation."""

from vae_segmentation_tpu_torch.models.encoder import ShapeEncoder
from vae_segmentation_tpu_torch.models.fusion import FusionNet
from vae_segmentation_tpu_torch.models.joint import Embed, Joint, Joint2
from vae_segmentation_tpu_torch.models.unet import SegUNet
from vae_segmentation_tpu_torch.models.vae import ShapeVAE
from vae_segmentation_tpu_torch.models.weights import (
    from_jax_params, load_component, load_network, load_state)

__all__ = ["Embed", "FusionNet", "Joint", "Joint2", "SegUNet",
           "ShapeEncoder", "ShapeVAE", "from_jax_params",
           "load_component", "load_network", "load_state"]
