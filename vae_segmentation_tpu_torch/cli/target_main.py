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

``--val_finetune N`` (ft1) finetunes a copy of the student on each
validation batch (N steps of the adaptation step's finetune variant, SGD at
momentum 0 and ``--lr_finetune``, the VAE frozen) before scoring it, and
writes the student's own scores beside as ``score_noft_<epoch>.json``;
training runs do so from outer epoch 1. ``--eval_mode sliding_window``
scores the full volumes instead of the ROI crops (``--sw_overlap``,
``--postprocess``, ``--postprocess_min_voxels``; ``-b`` windows a chunk, at
most 4); with ft1 each case's finetune takes its ROI crop and the sweep
uses the finetuned copy.

``--pseudo_list <list>`` replays labelled source cases (``--pseudo_data_root``,
``--pseudo_pan_index``) during adaptation: the adaptation loss takes its
``pseudo`` variant, every adaptation step is followed by one replay step
on a source batch (``train/steps.py::make_seg_replay_step``, its loss
printed as ``dice_loss_pseudo``), and the teacher becomes a full copy of
the student on every iteration of an outer epoch divisible by
``--pseudo_save_epoch`` (with ``--tag``, lambda_vae / 10 each time) in
place of the EMA update. ``--resume`` restarts from the latest
``model_epoch<N>.ckpt`` of the prefix, the port's or the JAX package's
(``cli/common.py::resume``: params, outer epoch and best result, a fresh
optimizer). ``--test_only`` evaluates whatever the load flags assemble
(``--load_prefix_joint``, or ``--load_prefix`` with ``--load_prefix_vae``;
the teacher is the student's copy). ``--aug_order 3`` and ``--aug_host``
pick the cubic and the host warp (``cli/common.py::make_train_ingest``).

``--vae_forward_scale`` is accepted and changes nothing, as in the JAX
package (its Joint always encodes with the mean latent). Every other
method, and the flags of later slices, raise NotImplementedError naming
the ROADMAP item that will port them.

Under ``torchrun --nproc_per_node N`` the ranks train as the JAX package's
mesh (``cli/common.py::start``; ``--spatial_shards S`` splits the volume's
D axis over S ranks): every adaptation and replay step on a rank's slice,
the gradients averaged over the mesh, the EMA teacher updated alike on
every rank; the eval (with ft1 and the sliding window) runs on rank 0 as
in one process, which alone prints and writes.
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
from vae_segmentation_tpu_torch.data.pipeline import (
    TrainLoader, intensity_normalize)
from vae_segmentation_tpu_torch.eval.evaluate import (
    make_joint_eval_step, mean_score, record_scores)
from vae_segmentation_tpu_torch.models import (
    Joint, load_component, load_state)
from vae_segmentation_tpu_torch.parallel import sharding
from vae_segmentation_tpu_torch.train import (
    AdaptConfig, copy_params, default_sched, ema_update_seg, make_adapt_step,
    make_seg_replay_step, optim)


def _check_supported(cfg: TargetConfig) -> None:
    if cfg.method != "domain_adaptation":
        todo(f"--method {cfg.method}", "item 11 (the other methods)")
    if cfg.analysis_figure_name is not None or cfg.save_eval_result \
            or cfg.save_more_reference or cfg.profile_dir is not None:
        todo("eval figures, npy dumps, TensorBoard panels and profiling",
             "item 11")
    if cfg.load_prefix_encoder:
        todo("--load_prefix_encoder", "item 11")


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


def _make_finetune(cfg: TargetConfig, n_class: int, device: torch.device):
    """ft1 test-time training (main_target.py:807-900; cli/target_main.py:
    271-275, 464-480 of the JAX package). Returns (finetune, ft_model):

        finetune(student, teacher, image, label, sched) -> metrics

    copies the student into ft_model, one finetune Joint (built once, on
    `device`, with the student's widths and dropouts), freezes its VAE
    whatever --fix_layer says, and takes --val_finetune steps of the
    adaptation step's finetune variant with SGD at momentum 0 and
    --lr_finetune (stateless: the reference re-creates its optimizer every
    step), its MC dropout masks drawn from its own generator seeded from
    --seed; metrics are the last step's (``make_adapt_step``'s aux). The
    student, its optimizer and the teacher are not touched."""
    ft_model = Joint(n_class=n_class, dim=128,
                     bottleneck=common.bottleneck_for(cfg.patch_size),
                     vae_decoder_dropout=cfg.vae_decoder_dropout,
                     seg_dropout=cfg.seg_dropout,
                     generator=torch.Generator().manual_seed(cfg.seed)
                     ).to(device)
    step = make_adapt_step(_adapt_cfg(cfg, n_class), variant="finetune")
    generator = torch.Generator(device=device).manual_seed(cfg.seed)

    def finetune(student, teacher, image, label, sched) -> Dict:
        copy_params(ft_model, student)
        opt = optim.sgd(optim.freeze_vae(ft_model), cfg.lr_finetune,
                        momentum=0.0, weight_decay=cfg.weight_decay)
        aux = {}
        for _ in range(cfg.val_finetune):
            aux = step(ft_model, teacher, opt, image, label, generator, sched)
        return aux

    return finetune, ft_model


def _crop_eval(cfg: TargetConfig, val_ds, device, eval_step, finetune,
               ft_eval_step, model, teacher, sched):
    """The crop eval (cli/target_main.py:456-488 of the JAX package):
    {case: Dice} and, with ft1, the finetuned model's scores beside the
    student's ({} without ft1)."""
    scores: Dict[int, float] = {}
    scores_noft: Dict[int, float] = {}
    for batch in common.val_batches(val_ds, cfg.val_batch, device):
        image, label = batch["image_norm"], batch["label"]
        step = eval_step
        if finetune is not None:
            finetune(model, teacher, image, label, sched)
            record_scores(scores_noft, eval_step(image, label)["score"],
                          batch["index"])
            step = ft_eval_step
        record_scores(scores, step(image, label)["score"], batch["index"])
    return scores, scores_noft


def _sliding_window_eval(cfg: TargetConfig, n_class: int, val_ds, device,
                         finetune, ft_model, model, teacher, sched):
    """The full-volume eval (cli/target_main.py:406-455 of the JAX
    package) with ``Joint.segment``. With ft1 each case first finetunes
    the ft copy on its ROI crop (the crop path's case, `val_ds`) and the
    sweep uses it; a second sweep with the student fills score_noft."""
    def sweep(model_for_case=None):
        return common.run_sliding_window_eval(
            cfg, lambda net, x: net.segment(x), model, n_class=n_class,
            data_root=cfg.val_data_root, list_key=cfg.val_list,
            pan_index=cfg.pan_index, model_for_case=model_for_case)[1]

    if finetune is None:
        return sweep(), {}

    def model_for_case(case):
        item = val_ds[case["index"]]
        image = intensity_normalize(torch.from_numpy(
            item["image"].astype(np.float32)).to(device))[None]
        label = torch.from_numpy(
            item["label"].astype(np.float32)).to(device)[None]
        finetune(model, teacher, image, label, sched)
        return ft_model

    scores_noft = sweep()
    return sweep(model_for_case), scores_noft


PRINT_KEYS = ("recon_loss", "dice_loss_fake", "dice_loss",
              "dice_loss_pseudo")


def _print_line(epoch: int, eval_epoch: int, idx: int, metrics: Dict) -> None:
    vals = ", ".join("%.4f" % float(metrics[k]) for k in PRINT_KEYS
                     if k in metrics)
    print("[%3d, %3d] loss: %s" % ((epoch + 1) * eval_epoch, idx + 1, vals))


class SourceReplay:
    """The --pseudo_list replay (cli/target_main.py:115-120, 279-284,
    352-363 of the JAX package): a second train loader over the source
    list (--pseudo_data_root, --pseudo_pan_index; shuffle and host warp
    seeded --seed + 101), and ``replay(student)``: the next source batch,
    cycling the loader when a pass ends, through the train ingest (its own
    draw from `generator`) and one ``make_seg_replay_step`` with the
    adaptation step's optimizer; returns the detached Dice loss.
    ``new_pass()`` starts each outer epoch on a fresh pass, as the JAX
    package does."""

    def __init__(self, cfg: TargetConfig, n_class: int, ingest, optimizer,
                 generator, mesh=None):
        self.loader = common.build_train_loader(
            cfg, data_root=cfg.pseudo_data_root, list_key=cfg.pseudo_list,
            pan_index=cfg.pseudo_pan_index, seed_salt=101)
        if len(self.loader) == 0:
            raise ValueError(f"--pseudo_list {cfg.pseudo_list}: fewer cases "
                             f"than a batch of {cfg.batch_size}")
        self.step = make_seg_replay_step(n_class)
        self.ingest, self.optimizer = ingest, optimizer
        self.generator = generator
        self.mesh = mesh
        self.batches = None

    def new_pass(self) -> None:
        self.batches = iter(self.loader)

    def __call__(self, student) -> torch.Tensor:
        try:
            batch = next(self.batches)
        except StopIteration:
            self.new_pass()
            batch = next(self.batches)
        image, label = self.ingest(batch, self.generator)
        with sharding.active(self.mesh):
            return self.step(student, self.optimizer, image,
                             label)["dice_loss"]


def _train_epoch(cfg: TargetConfig, epoch: int, loader: TrainLoader, step,
                 ingest, model, teacher, optimizer, generator,
                 lambda_vae: float,
                 replay: Optional[SourceReplay] = None, mesh=None) -> float:
    """One outer epoch of adaptation steps (each followed by a replay step
    with --pseudo_list); returns lambda_vae after the --tag decay.
    `generator` draws the warps and the MC dropout masks; the steps run on
    this rank's slice of `mesh`."""
    if epoch == 0:
        common.skip_epoch(loader)  # epoch-0 skip (main_target.py:506)
        return lambda_vae
    sched = _epoch_sched(cfg, epoch, lambda_vae)
    # EMA cadence (main_target.py:508-509): once per inner dataset pass (the
    # list is replicated eval_epoch x), or every iteration
    ema_interval = max(len(loader) // cfg.eval_epoch, 1) \
        if cfg.pseudo_save_epoch != 0 else None
    if replay is not None:
        replay.new_pass()
    for idx, batch in enumerate(loader):
        if replay is not None:
            # the replay runs' teacher: a full copy of the student on every
            # iteration of a qualifying epoch, --tag dividing lambda by 10
            # (main_target.py:633-635)
            if cfg.pseudo_save_epoch != 0 and \
                    epoch % cfg.pseudo_save_epoch == 0:
                copy_params(teacher, model)
                if cfg.tag:
                    lambda_vae = lambda_vae / 10.0
                    sched = _epoch_sched(cfg, epoch, lambda_vae)
        elif ema_interval is not None and \
                epoch % max(cfg.pseudo_save_epoch // cfg.eval_epoch, 1) == 0 \
                and (cfg.update_every_iteration or idx % ema_interval == 0):
            if not cfg.update_every_iteration:
                print("Updating Network")
            ema_update_seg(teacher, model, cfg.alpha)
            if cfg.tag:
                lambda_vae = cfg.alpha * lambda_vae
                sched = _epoch_sched(cfg, epoch, lambda_vae)
        image, label = ingest(batch, generator)
        with sharding.active(mesh):
            metrics = step(model, teacher, optimizer, image, label,
                           generator, sched)
        if replay is not None:
            metrics = dict(metrics, dice_loss_pseudo=replay(model))
        _print_line(epoch, cfg.eval_epoch, idx, metrics)
    return lambda_vae


def run(cfg: TargetConfig) -> float:
    """Train (or with --test_only just evaluate) the Joint; returns the
    best mean validation Dice (the mean Dice with --test_only). Under
    torchrun: rank 0's, on every rank of the mesh (0.0 on a rank outside
    it)."""
    _check_supported(cfg)
    world, mesh, device = common.start(cfg)
    try:
        return 0.0 if device is None else _run(cfg, device, mesh)
    finally:
        common.stop(world)


def _run(cfg: TargetConfig, device: torch.device, mesh) -> float:
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    n_class = common.n_classes(cfg)

    print("Building model.")
    model, teacher = _build_models(cfg, n_class, device)
    if mesh is not None:
        sharding.replicate(mesh, model)
        sharding.replicate(mesh, teacher)
    val_ds = common.build_val_dataset(cfg, data_root=cfg.val_data_root,
                                      list_key=cfg.val_list)
    eval_step = make_joint_eval_step(model, n_class)
    finetune = ft_model = ft_eval_step = None
    if cfg.val_finetune != 0:
        finetune, ft_model = _make_finetune(cfg, n_class, device)
        ft_eval_step = make_joint_eval_step(ft_model, n_class)
    runner = common.EpochRunner(cfg, writes=common.writes(mesh))
    # params, epoch and best of the latest periodic checkpoint; the teacher
    # stays the copy made from the load flags, as in the JAX package
    start_epoch = common.resume(cfg, runner, lambda ck: load_state(model, ck))

    loader = step = ingest = optimizer = generator = replay = None
    if not cfg.test_only:
        print("Loading data.")
        loader = common.build_train_loader(cfg, data_root=cfg.data_root,
                                           list_key=cfg.train_list)
        ingest = common.make_train_ingest(cfg, device, mesh)
        trainable = optim.freeze_all_but_seg_head(model) if cfg.fix_layer \
            else optim.freeze_vae(model)
        optimizer = optim.build(trainable, cfg.adam, cfg.lr_seg,
                                weight_decay=cfg.weight_decay)
        # --pseudo_list runs take the restricted loss of
        # main_target.py:642-653
        step = make_adapt_step(
            _adapt_cfg(cfg, n_class),
            variant="pseudo" if cfg.pseudo_list is not None else "train")
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
        if cfg.pseudo_list is not None:
            replay = SourceReplay(cfg, n_class, ingest, optimizer, generator,
                                  mesh)
        print("Start training")

    lambda_vae = cfg.lambda_vae  # host-mutable (--tag decay)
    for epoch in range(start_epoch, cfg.outer_epochs):
        if not cfg.test_only:
            lambda_vae = _train_epoch(cfg, epoch, loader, step, ingest,
                                      model, teacher, optimizer, generator,
                                      lambda_vae, replay, mesh)
        print("Start evaluation")
        t0 = time.time()
        # ft1 from the first outer epoch that trained (main_target.py:807)
        ft = finetune if epoch != 0 or cfg.test_only else None
        sched = _epoch_sched(cfg, epoch, lambda_vae)
        scores, scores_noft = {}, {}
        if common.writes(mesh):  # the other ranks wait in share()
            if cfg.eval_mode == "sliding_window":
                scores, scores_noft = _sliding_window_eval(
                    cfg, n_class, val_ds, device, ft, ft_model, model,
                    teacher, sched)
            else:
                scores, scores_noft = _crop_eval(
                    cfg, val_ds, device, eval_step, ft, ft_eval_step, model,
                    teacher, sched)
        dsc = common.share(mesh, mean_score(scores))
        runner.dump_scores(epoch, scores)
        if scores_noft:
            runner.dump_scores(epoch, scores_noft, name="score_noft")
            print("val_result_no_finetune: %f" % mean_score(scores_noft))
        print("Time: {}".format(time.time() - t0))
        if cfg.test_only:
            print("epoch 1 validation result: %f over %d cases."
                  % (dsc, len(scores)))
            return dsc
        runner.end_of_epoch(epoch, dsc, model, optimizer)
    return runner.best_result


def main(argv: Optional[List[str]] = None) -> float:
    with common.rank_stdout():
        return run(parse_target_args(argv))


if __name__ == "__main__":
    main()
