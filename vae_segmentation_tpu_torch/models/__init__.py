"""SegUNet, ShapeVAE and Joint in the logical channels-last representation."""

from vae_segmentation_tpu_torch.models.joint import Joint
from vae_segmentation_tpu_torch.models.unet import SegUNet
from vae_segmentation_tpu_torch.models.vae import ShapeVAE
from vae_segmentation_tpu_torch.models.weights import (
    from_jax_params, load_component, load_network, load_state)

__all__ = ["Joint", "SegUNet", "ShapeVAE", "from_jax_params",
           "load_component", "load_network", "load_state"]
