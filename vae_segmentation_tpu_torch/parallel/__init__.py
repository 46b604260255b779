"""Multi-rank training (counterpart of vae_segmentation_tpu/parallel/): the
('data', 'spatial') mesh of ranks (``sharding``), its differentiable
collectives and the gradient mean (``collectives``), and starting a world
of ranks (``launch``)."""

from vae_segmentation_tpu_torch.parallel import collectives, launch, sharding
from vae_segmentation_tpu_torch.parallel.sharding import (
    Mesh, active, batch_shard, current, make_mesh, make_mesh_if_multichip,
    replicate)

__all__ = ["Mesh", "active", "batch_shard", "collectives", "current",
           "launch", "make_mesh", "make_mesh_if_multichip", "replicate",
           "sharding"]
