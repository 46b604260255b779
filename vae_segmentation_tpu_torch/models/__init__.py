"""SegUNet, ShapeVAE, ShapeEncoder, FusionNet and the composites Joint,
Joint2 and Embed in the logical channels-last representation, each at
norm_type 1 (InstanceNorm), 2 (BatchNorm) or 3 (GSNorm); the GS family of
``models/gs.py``."""

from vae_segmentation_tpu_torch.models.blocks import (
    Norm, gs_norm, instance_norm)
from vae_segmentation_tpu_torch.models.encoder import ShapeEncoder
from vae_segmentation_tpu_torch.models.fusion import FusionNet
from vae_segmentation_tpu_torch.models.gs import (
    ConvGS, DoubleConvGS, DownGS, GSConv3d, GSConvTranspose3d,
    SConv3d, SegmentationGS, UpGS, gs_normalize_weight)
from vae_segmentation_tpu_torch.models.joint import Embed, Joint, Joint2
from vae_segmentation_tpu_torch.models.unet import SegUNet
from vae_segmentation_tpu_torch.models.vae import ShapeVAE
from vae_segmentation_tpu_torch.models.weights import (
    from_jax_params, load_component, load_network, load_state)

__all__ = ["ConvGS", "DoubleConvGS", "DownGS", "Embed", "FusionNet",
           "GSConv3d", "GSConvTranspose3d", "Joint", "Joint2", "Norm",
           "SConv3d", "SegUNet", "SegmentationGS", "ShapeEncoder", "ShapeVAE",
           "UpGS", "from_jax_params", "gs_norm", "gs_normalize_weight",
           "instance_norm", "load_component", "load_network", "load_state"]
