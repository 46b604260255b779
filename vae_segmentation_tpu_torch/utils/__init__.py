"""Host analysis helpers (copies of the JAX package's utils/legacy.py)."""

from vae_segmentation_tpu_torch.utils.legacy import (  # noqa: F401
    create_grid_images,
    get_parameter_number,
    get_synthesis_mask,
    masked_mse_loss,
    mutual_information_3d,
    plot_slides,
    smoothness_loss,
)
