"""Losses and the hand-written kernels (K1 ``conv3.conv3``, K2
``bridges.down_k2s2``, K3 ``bridges.up_k2s2``) with their plain PyTorch
versions and launch counters."""

from typing import Dict

from vae_segmentation_tpu_torch.ops import bridges, conv3

KERNELS = (conv3.conv3, bridges.down_k2s2, bridges.up_k2s2)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}
