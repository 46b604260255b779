"""Target-domain CLI of the port (counterpart of vae_segmentation_tpu/cli/
target_main.py), ``--method domain_adaptation``:

    python -m vae_segmentation_tpu_torch.cli.target_main <prefix> \\
        --method domain_adaptation \\
        --load_prefix <seg> --load_prefix_vae <vae> \\
        --domain_loss_type 8 --vae_decoder_dropout 0.5 ... [--device cpu]

trains the student Joint with the live-teacher adaptation step
(``train/steps.py``) on the warped train batches (``data/augment.py``, off
with ``--no_aug``): teacher <- student copy at the start, no step in outer
epoch 0, the EMA teacher update on the reference's cadence, a loss line per
step, the crop evaluation after every outer epoch with
``tensorboard/<prefix>/score_<epoch>.json`` and the best and periodic
checkpoints under ``<save_root>/<prefix>/``. With ``--test_only
--load_prefix_joint <p>`` it only evaluates ``<save_root>/<p>/
best_model.ckpt`` (a port or reference torch checkpoint) and writes
``score_0.json``. It runs on ``--device cuda`` unless told otherwise.

``--vae_forward_scale`` is accepted and changes nothing, as in the JAX
package (its Joint always encodes with the mean latent). ``--pseudo_list``,
``--resume``, ``--val_finetune``, ``--aug_order 3``, ``--aug_host`` and every
other method raise NotImplementedError naming the ROADMAP item that will
port them.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from vae_segmentation_tpu_torch.cli import common
from vae_segmentation_tpu_torch.cli.common import todo
from vae_segmentation_tpu_torch.core.config import (
    TargetConfig, parse_target_args)
from vae_segmentation_tpu_torch.core.device import resolve_device
from vae_segmentation_tpu_torch.data.pipeline import TrainLoader
from vae_segmentation_tpu_torch.eval.evaluate import (
    make_joint_eval_step, run_eval)
from vae_segmentation_tpu_torch.models import (
    Joint, load_component, load_state)
from vae_segmentation_tpu_torch.train import (
    AdaptConfig, copy_params, default_sched, ema_update_seg, make_adapt_step,
    optim)


def _check_supported(cfg: TargetConfig) -> None:
    if cfg.method != "domain_adaptation":
        todo(f"--method {cfg.method}", "item 11 (the other methods)")
    if cfg.val_finetune != 0:
        todo("--val_finetune (ft1 test-time training)", "item 4")
    if cfg.eval_mode != "crop":
        todo(f"--eval_mode {cfg.eval_mode}", "item 6")
    if cfg.spatial_shards != 1:
        todo("--spatial_shards", "item 9")
    if cfg.analysis_figure_name is not None or cfg.save_eval_result \
            or cfg.save_more_reference or cfg.profile_dir is not None:
        todo("eval figures, npy dumps, TensorBoard panels and profiling",
             "item 11")
    if cfg.load_prefix_encoder:
        todo("--load_prefix_encoder", "item 11")
    if cfg.test_only:
        if not cfg.load_prefix_joint or cfg.load_prefix \
                or cfg.load_prefix_vae or cfg.pseudo_list is not None \
                or cfg.resume:
            todo("--test_only with anything but --load_prefix_joint",
                 "item 3")
        return
    if cfg.pseudo_list is not None:
        todo("--pseudo_list (source replay)", "item 3")
    if cfg.resume:
        todo("--resume", "item 3")


def _adapt_cfg(cfg: TargetConfig, n_class: int) -> AdaptConfig:
    return AdaptConfig(
        n_class=n_class, domain_loss_type=cfg.domain_loss_type,
        only_pseudo=cfg.only_pseudo,
        use_confident_binarize=cfg.use_confident_binarize, kl=cfg.kl,
        vae_mont_number=cfg.vae_mont_number,
        turn_enabled=cfg.turn_epoch != -1)


def _epoch_sched(cfg: TargetConfig, epoch: int, lambda_vae: float) -> Dict:
    sched = default_sched(lambda_vae)
    if cfg.lambda_vae_warmup > 0:
        sched["warmup_scale"] = 1.0 if epoch >= cfg.lambda_vae_warmup \
            else epoch / cfg.lambda_vae_warmup
    if cfg.turn_epoch != -1:
        sched["turn_phase"] = (epoch // cfg.turn_epoch) % 2
    return sched


def _build_models(cfg: TargetConfig, n_class: int, device: torch.device):
    """(student, teacher) after the load matrix of main_target.py:355-394
    and the teacher <- student copy (:383-384, 427-433)."""
    kw = dict(n_class=n_class, dim=128,
              bottleneck=common.bottleneck_for(cfg.patch_size))
    model = Joint(vae_decoder_dropout=cfg.vae_decoder_dropout,
                  seg_dropout=cfg.seg_dropout,
                  generator=torch.Generator().manual_seed(cfg.seed), **kw)
    teacher = Joint(**kw)
    copy_params(teacher, model)
    print("Loading prefix.")
    if cfg.load_prefix:
        load_component(teacher if cfg.from_scratch else model,
                       common.load(cfg, cfg.load_prefix, cfg.checkpoint_name),
                       "Seg")
    if cfg.load_prefix_vae:
        ck = common.load(cfg, cfg.load_prefix_vae)
        if cfg.from_scratch:
            load_component(teacher, ck, "Vae")
        load_component(model, ck, "Vae")
    if cfg.load_prefix_joint:
        load_state(model, common.load(cfg, cfg.load_prefix_joint))
    if cfg.test_only or not cfg.from_scratch:
        copy_params(teacher, model)
    for p in teacher.parameters():
        p.requires_grad_(False)
    return model.to(device), teacher.to(device)


def _print_line(epoch: int, eval_epoch: int, idx: int, metrics: Dict) -> None:
    vals = ", ".join("%.4f" % float(metrics[k]) for k in
                     ("recon_loss", "dice_loss_fake", "dice_loss"))
    print("[%3d, %3d] loss: %s" % ((epoch + 1) * eval_epoch, idx + 1, vals))


def _train_epoch(cfg: TargetConfig, epoch: int, loader: TrainLoader, step,
                 ingest, model, teacher, optimizer, generator,
                 lambda_vae: float) -> float:
    """One outer epoch of adaptation steps; returns lambda_vae after the
    --tag decay. `generator` draws the warp and the MC dropout masks."""
    if epoch == 0:
        common.skip_epoch(loader)  # epoch-0 skip (main_target.py:506)
        return lambda_vae
    sched = _epoch_sched(cfg, epoch, lambda_vae)
    # EMA cadence (main_target.py:508-509): once per inner dataset pass (the
    # list is replicated eval_epoch x), or every iteration
    ema_interval = max(len(loader) // cfg.eval_epoch, 1) \
        if cfg.pseudo_save_epoch != 0 else None
    for idx, batch in enumerate(loader):
        if ema_interval is not None and \
                epoch % max(cfg.pseudo_save_epoch // cfg.eval_epoch, 1) == 0 \
                and (cfg.update_every_iteration or idx % ema_interval == 0):
            if not cfg.update_every_iteration:
                print("Updating Network")
            ema_update_seg(teacher, model, cfg.alpha)
            if cfg.tag:
                lambda_vae = cfg.alpha * lambda_vae
                sched = _epoch_sched(cfg, epoch, lambda_vae)
        image, label = ingest(batch, generator)
        metrics = step(model, teacher, optimizer, image, label, generator,
                       sched)
        _print_line(epoch, cfg.eval_epoch, idx, metrics)
    return lambda_vae


def run(cfg: TargetConfig) -> float:
    """Train (or with --test_only just evaluate) the Joint; returns the
    best mean validation Dice (the mean Dice with --test_only)."""
    _check_supported(cfg)
    device = resolve_device(cfg.device)
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    n_class = common.n_classes(cfg)

    print("Building model.")
    model, teacher = _build_models(cfg, n_class, device)
    val_ds = common.build_val_dataset(cfg, data_root=cfg.val_data_root,
                                      list_key=cfg.val_list)
    eval_step = make_joint_eval_step(model, n_class)
    runner = common.EpochRunner(cfg)

    loader = step = ingest = optimizer = generator = None
    if not cfg.test_only:
        print("Loading data.")
        loader = common.build_train_loader(cfg, data_root=cfg.data_root,
                                           list_key=cfg.train_list)
        ingest = common.make_train_ingest(cfg, device)
        trainable = optim.freeze_all_but_seg_head(model) if cfg.fix_layer \
            else optim.freeze_vae(model)
        optimizer = optim.build(trainable, cfg.adam, cfg.lr_seg,
                                weight_decay=cfg.weight_decay)
        step = make_adapt_step(_adapt_cfg(cfg, n_class))
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
        print("Start training")

    lambda_vae = cfg.lambda_vae  # host-mutable (--tag decay)
    for epoch in range(cfg.outer_epochs):
        if not cfg.test_only:
            lambda_vae = _train_epoch(cfg, epoch, loader, step, ingest,
                                      model, teacher, optimizer, generator,
                                      lambda_vae)
        print("Start evaluation")
        t0 = time.time()
        dsc, scores = run_eval(
            common.val_batches(val_ds, cfg.val_batch, device), eval_step)
        runner.dump_scores(epoch, scores)
        print("Time: {}".format(time.time() - t0))
        if cfg.test_only:
            print("epoch 1 validation result: %f over %d cases."
                  % (dsc, len(scores)))
            return dsc
        runner.end_of_epoch(epoch, dsc, model)
    return runner.best_result


def main(argv: Optional[List[str]] = None) -> float:
    return run(parse_target_args(argv))


if __name__ == "__main__":
    main()
