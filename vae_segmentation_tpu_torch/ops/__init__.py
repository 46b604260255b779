"""Losses and the hand-written kernels with their plain PyTorch versions
and launch counters: K1 ``conv3.conv3`` with ``conv3.conv3_dk`` and the
merged backward ``conv3.conv3_bwd``, K2 ``bridges.down_k2s2`` and K3
``bridges.up_k2s2`` with their backwards, ``losses.softmax_vjp`` /
``losses.dice_sums``, ``reparam.reparam_kl`` and the InstanceNorm kernels
of ``instance_norm``."""

from typing import Dict

from vae_segmentation_tpu_torch.ops import (
    bridges, conv3, instance_norm, losses, reparam)

KERNELS = (conv3.conv3, bridges.down_k2s2, bridges.up_k2s2, conv3.conv3_dk,
           bridges.down_k2s2_bwd, bridges.up_k2s2_bwd, losses.softmax_vjp,
           losses.dice_sums, reparam.reparam_kl, conv3.conv3_bwd,
           instance_norm.norm_stats, instance_norm.norm_apply,
           instance_norm.norm_bwd_sums, instance_norm.norm_bwd_dx)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}
