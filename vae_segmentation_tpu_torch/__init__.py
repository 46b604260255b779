"""PyTorch/CUDA port of vae_segmentation_tpu for NVIDIA Hopper (H100).

The JAX package beside it is the reference. This package imports neither
JAX nor that package. Entry points run on ``cuda`` unless the caller asks
for the CPU (``device="cpu"``, ``--device cpu``), where every kernel's
plain PyTorch version runs instead.
"""
