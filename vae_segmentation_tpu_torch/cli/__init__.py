"""Command-line entry points (``python -m vae_segmentation_tpu_torch.cli.target_main``)."""
