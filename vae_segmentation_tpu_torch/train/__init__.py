"""The train steps and what they need (counterpart of
vae_segmentation_tpu/train/): optimizers with frozen subtrees, the EMA
teacher update, the source-domain ``make_vae_train_step`` and
``make_seg_train_step``, the Joint's source steps ``make_joint_train_step``,
``make_cached_pseudo_adapt_step`` and ``make_sep_joint_train_step``, the
adaptation ``make_adapt_step``, the source replay
``make_seg_replay_step``, the discriminator methods'
``make_discriminator_step`` and ``make_adapt_dis_step``, Embed's
``make_embed_train_step`` and ``make_refine_vae_step``;
``checking_terms``, the --debug_nans hook."""

from vae_segmentation_tpu_torch.train import optim
from vae_segmentation_tpu_torch.train.ema import copy_params, ema_update_seg
from vae_segmentation_tpu_torch.train.steps import (
    AdaptConfig, adapt_loss, checking_terms, default_sched,
    make_adapt_dis_step, make_adapt_step, make_cached_pseudo_adapt_step,
    make_discriminator_step, make_embed_train_step, make_joint_train_step,
    make_refine_vae_step, make_seg_replay_step, make_seg_train_step,
    make_sep_joint_train_step, make_vae_train_step)

__all__ = ["AdaptConfig", "adapt_loss", "checking_terms", "copy_params",
           "default_sched", "ema_update_seg", "make_adapt_dis_step",
           "make_adapt_step", "make_cached_pseudo_adapt_step",
           "make_discriminator_step", "make_embed_train_step",
           "make_joint_train_step", "make_refine_vae_step",
           "make_seg_replay_step", "make_seg_train_step",
           "make_sep_joint_train_step", "make_vae_train_step", "optim"]
