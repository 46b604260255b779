"""The train steps and what they need (counterpart of
vae_segmentation_tpu/train/): optimizers with frozen subtrees, the EMA
teacher update, the source-domain ``make_vae_train_step`` and
``make_seg_train_step`` and the adaptation ``make_adapt_step``."""

from vae_segmentation_tpu_torch.train import optim
from vae_segmentation_tpu_torch.train.ema import copy_params, ema_update_seg
from vae_segmentation_tpu_torch.train.steps import (
    AdaptConfig, adapt_loss, default_sched, make_adapt_step,
    make_seg_train_step, make_vae_train_step)

__all__ = ["AdaptConfig", "adapt_loss", "copy_params", "default_sched",
           "ema_update_seg", "make_adapt_step", "make_seg_train_step",
           "make_vae_train_step", "optim"]
