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

The serving outputs (cli/target_main.py:255-300, 440-564 of the JAX
package): ``--save_eval_result`` writes each case's binarized prediction,
image and one-hot label as ``result/<prefix>/<epoch>_<idx>_{pred.join,pic,
gt}.npy`` every 10th outer epoch and under ``--test_only``;
``--save_more_reference`` adds the display panels (the train step's, the
val case's, a train case's after the eval) to the TensorBoard files under
``tensorboard/<prefix>/`` (``obs/saver.py``: the scalars every 10 steps,
``steps_per_sec``, ft1's ``finetune_*``, ``val_result`` and
``val_result_no_finetune``, also printed as ``name value it`` lines);
``--analysis_figure_name <t>`` computes the pseudo-loss / recon-loss pairs
of each case (``eval/evaluate.py::make_analysis_metrics_step``) and draws
``figure/analysis_figure/<t>{,_gt,_pseudo}.jpg`` and ``analysis.jpg``
(matplotlib, checked at start-up); ``--profile_dir <d>`` writes a
torch.profiler Chrome trace of the run into ``<d>``; ``--debug_nans``
stops the run with FloatingPointError at the first loss term or score
that is not finite (``cli/common.py::nan_guard``).

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

import dataclasses
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
    make_analysis_metrics_step, make_joint_eval_step, mean_score,
    record_scores)
from vae_segmentation_tpu_torch.models import (
    Joint, load_component, load_state)
from vae_segmentation_tpu_torch.obs import draw
from vae_segmentation_tpu_torch.obs.saver import mid_slice_panel, to_numpy
from vae_segmentation_tpu_torch.obs.timing import StepTimer
from vae_segmentation_tpu_torch.ops import losses as L
from vae_segmentation_tpu_torch.parallel import sharding
from vae_segmentation_tpu_torch.train import (
    AdaptConfig, copy_params, default_sched, ema_update_seg, make_adapt_step,
    make_seg_replay_step, optim)


# the reference's fixed dict key of every display panel
LABEL_KEY = "venous_pancreas"


def _check_supported(cfg: TargetConfig) -> None:
    if cfg.method in ("discriminator_train", "domain_adaptation_dis"):
        todo(f"--method {cfg.method} (ShapeEncoder, Joint2)", "item 11e")
    if cfg.method == "vae_train":
        todo("--method vae_train of the target CLI", "item 11h")
    if cfg.method != "domain_adaptation":
        raise ValueError(f"--method {cfg.method}: try a valid method")
    if cfg.load_prefix_encoder:
        todo("--load_prefix_encoder (ShapeEncoder)", "item 11e")
    if cfg.analysis_figure_name is not None:
        draw.require_matplotlib()


def _adapt_cfg(cfg: TargetConfig, n_class: int) -> AdaptConfig:
    return AdaptConfig(
        n_class=n_class, domain_loss_type=cfg.domain_loss_type,
        only_pseudo=cfg.only_pseudo,
        use_confident_binarize=cfg.use_confident_binarize, kl=cfg.kl,
        vae_mont_number=cfg.vae_mont_number,
        turn_enabled=cfg.turn_epoch != -1,
        return_display=cfg.save_more_reference)


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

        finetune(student, teacher, image, label, sched[, report]) -> metrics

    copies the student into ft_model, one finetune Joint (built once, on
    `device`, with the student's widths and dropouts), freezes its VAE
    whatever --fix_layer says, and takes --val_finetune steps of the
    adaptation step's finetune variant with SGD at momentum 0 and
    --lr_finetune (stateless: the reference re-creates its optimizer every
    step), its MC dropout masks drawn from its own generator seeded from
    --seed; metrics are the last step's (``make_adapt_step``'s aux). The
    student, its optimizer and the teacher are not touched. ``report(i,
    aux)`` sees each step's aux (the ``finetune_*`` scalars)."""
    ft_model = Joint(n_class=n_class, dim=128,
                     bottleneck=common.bottleneck_for(cfg.patch_size),
                     vae_decoder_dropout=cfg.vae_decoder_dropout,
                     seg_dropout=cfg.seg_dropout,
                     generator=torch.Generator().manual_seed(cfg.seed)
                     ).to(device)
    step = make_adapt_step(dataclasses.replace(
        _adapt_cfg(cfg, n_class), return_display=False), variant="finetune")
    generator = torch.Generator(device=device).manual_seed(cfg.seed)

    def finetune(student, teacher, image, label, sched,
                 report=None) -> Dict:
        copy_params(ft_model, student)
        opt = optim.sgd(optim.freeze_vae(ft_model), cfg.lr_finetune,
                        momentum=0.0, weight_decay=cfg.weight_decay)
        aux = {}
        for i in range(cfg.val_finetune):
            with common.nan_guard(cfg, f"ft1 step {i + 1}"):
                aux = step(ft_model, teacher, opt, image, label, generator,
                           sched)
            if report is not None:
                report(i, aux)
        return aux

    return finetune, ft_model


class EvalSteps:
    """The crop eval's steps: the student's eval and analysis steps and,
    with ft1, the finetune and the ft copy's (None where not asked)."""

    def __init__(self, cfg: TargetConfig, n_class: int, device, model,
                 teacher):
        self.eval = make_joint_eval_step(model, n_class)
        self.analysis = self.ft_eval = self.ft_analysis = None
        self.finetune = self.ft_model = None
        if cfg.val_finetune != 0:
            self.finetune, self.ft_model = _make_finetune(cfg, n_class,
                                                          device)
            self.ft_eval = make_joint_eval_step(self.ft_model, n_class)
        if cfg.analysis_figure_name is not None:
            self.analysis = make_analysis_metrics_step(model, teacher,
                                                       n_class)
            if self.ft_model is not None:
                self.ft_analysis = make_analysis_metrics_step(
                    self.ft_model, teacher, n_class)


# the analysis figures' (x, y) pairs: (name suffix, x key, y key)
FIGURES = (("", "dsc_loss_fake", "recon_loss"),
           ("_gt", "gt_dsc_loss_fake", "gt_recon_loss"),
           ("_pseudo", "pseudo_dsc_loss_fake", "pseudo_recon_loss"))


def _crop_eval(cfg: TargetConfig, n_class: int, val_ds, device,
               steps: EvalSteps, finetune, epoch, runner, model, teacher,
               sched):
    """The crop eval (cli/target_main.py:456-533 of the JAX package):
    ({case: Dice}, with ft1 the student's own scores beside ({} without),
    the val display panel, the analysis figures' {case: (x, y)} pairs).
    With ft1 every finetune step's scalars go to the saver as
    ``finetune_*``; --save_more_reference takes the val panel of case
    epoch % cases; --save_eval_result dumps every case every 10th
    epoch."""
    scores: Dict[int, float] = {}
    scores_noft: Dict[int, float] = {}
    display: Dict[str, np.ndarray] = {}
    figs = tuple({} for _ in FIGURES)
    for batch in common.val_batches(val_ds, cfg.val_batch, device):
        image, label, index = batch["image_norm"], batch["label"], \
            batch["index"]
        step, analysis = steps.eval, steps.analysis
        if finetune is not None:
            vidx = int(np.asarray(index)[0])

            def report(i, aux):
                runner.saver.write_display(
                    i + vidx * cfg.val_finetune,
                    [("finetune_" + k, v) for k, v in aux.items()
                     if k != "kl_loss"], force_write=True, verbose=False)

            finetune(model, teacher, image, label, sched, report)
            record_scores(scores_noft, steps.eval(image, label)["score"],
                          index)
            step, analysis = steps.ft_eval, steps.ft_analysis
        out = step(image, label)
        record_scores(scores, out["score"], index)
        j = common.panel_sample(index, epoch, len(val_ds))
        if cfg.save_more_reference and j is not None:
            onehot = L.one_hot_label(label, n_class)
            display[LABEL_KEY + "_display_val"] = mid_slice_panel(
                out["recon"][j:j + 1][..., 1], onehot[j:j + 1][..., 1],
                out["pred"][j:j + 1][..., 1])
        if analysis is not None:
            am = {k: to_numpy(v).reshape(-1)
                  for k, v in analysis(image, label).items()}
            for j, vi in enumerate(np.asarray(index)):
                for fig, (_, x, y) in zip(figs, FIGURES):
                    fig[int(vi)] = [float(am[x][j]), float(am[y][j])]
        if cfg.save_eval_result and epoch % 10 == 0:
            common.dump_eval_batch(cfg, epoch, index, out["pred"], image,
                                   label, n_class)
    return scores, scores_noft, display, figs


def _draw_figures(name: str, figs) -> None:
    """The four analysis figures (main_target.py:978-995)."""
    for fig, (suffix, _, _) in zip(figs, FIGURES):
        draw.scatter_plot(fig, name + suffix, "Pseudo_loss", "Recon_loss")
    draw.scatter_plot_multi(figs[0], figs[1], "analysis")


def _train_display_panel(cfg: TargetConfig, n_class: int, eval_step,
                         teacher, epoch: int) -> np.ndarray:
    """The post-eval panel of train case epoch % cases (main_target.py:
    999-1010; cli/target_main.py:570-593 of the JAX package): [recon,
    gt, pred, the teacher's binarized pseudo label] (class 1), the case
    normalized as the eval's (no warp)."""
    ds = common.build_val_dataset(cfg, data_root=cfg.data_root,
                                  list_key=cfg.train_list)
    device = next(teacher.parameters()).device
    case = ds[epoch % len(ds)]
    image = intensity_normalize(torch.from_numpy(
        case["image"].astype(np.float32)).to(device))[None]
    label = torch.from_numpy(case["label"].astype(np.float32))[None]
    label = label.to(device)
    out = eval_step(image, label)
    with torch.no_grad():
        pseudo = L.binarize(teacher.segment(image[..., None]))
    onehot = L.one_hot_label(label, n_class)
    return mid_slice_panel(out["recon"][..., 1], onehot[..., 1],
                           out["pred"][..., 1], pseudo[..., 1])


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
                 lambda_vae: float, runner, timer: StepTimer,
                 replay: Optional[SourceReplay] = None, mesh=None) -> float:
    """One outer epoch of adaptation steps (each followed by a replay step
    with --pseudo_list); returns lambda_vae after the --tag decay.
    `generator` draws the warps and the MC dropout masks; the steps run on
    this rank's slice of `mesh`. Each step's scalars, ``steps_per_sec``
    and its display panel go to the runner's saver (cli/target_main.py:
    252-260 of the JAX package)."""
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
        where = f"epoch {(epoch + 1) * cfg.eval_epoch}, iteration {idx + 1}"
        with common.nan_guard(cfg, where):
            with sharding.active(mesh):
                metrics = step(model, teacher, optimizer, image, label,
                               generator, sched)
            if replay is not None:
                metrics = dict(metrics, dice_loss_pseudo=replay(model))
        timer.tick()
        _print_line(epoch, cfg.eval_epoch, idx, metrics)
        display = metrics.pop("display", None)
        runner.saver.write_display(
            idx + epoch * len(loader),
            list(metrics.items()) + [("steps_per_sec", timer.rate)],
            image=None if display is None
            else {LABEL_KEY + "_display": display})
    return lambda_vae


def run(cfg: TargetConfig) -> float:
    """Train (or with --test_only just evaluate) the Joint; returns the
    best mean validation Dice (the mean Dice with --test_only). Under
    torchrun: rank 0's, on every rank of the mesh (0.0 on a rank outside
    it)."""
    _check_supported(cfg)
    world, mesh, device = common.start(cfg)
    try:
        if device is None:
            return 0.0
        runner = common.EpochRunner(cfg, writes=common.writes(mesh))
        try:
            with common.profile(cfg):
                return _run(cfg, device, mesh, runner)
        finally:
            runner.saver.close()
    finally:
        common.stop(world)


def _run(cfg: TargetConfig, device: torch.device, mesh, runner) -> float:
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
    steps = EvalSteps(cfg, n_class, device, model, teacher)
    finetune, ft_model = steps.finetune, steps.ft_model
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
    timer = StepTimer()
    iters = common.iterations_per_epoch(cfg)
    for epoch in range(start_epoch, cfg.outer_epochs):
        if not cfg.test_only:
            lambda_vae = _train_epoch(cfg, epoch, loader, step, ingest,
                                      model, teacher, optimizer, generator,
                                      lambda_vae, runner, timer, replay,
                                      mesh)
        print("Start evaluation")
        t0 = time.time()
        # ft1 from the first outer epoch that trained (main_target.py:807)
        ft = finetune if epoch != 0 or cfg.test_only else None
        sched = _epoch_sched(cfg, epoch, lambda_vae)
        scores, scores_noft, display, figs = {}, {}, {}, ()
        if common.writes(mesh):  # the other ranks wait in share()
            if cfg.eval_mode == "sliding_window":
                scores, scores_noft = _sliding_window_eval(
                    cfg, n_class, val_ds, device, ft, ft_model, model,
                    teacher, sched)
            else:
                scores, scores_noft, display, figs = _crop_eval(
                    cfg, n_class, val_ds, device, steps, ft, epoch, runner,
                    model, teacher, sched)
            where = f"epoch {(epoch + 1) * cfg.eval_epoch} (eval)"
            common.check_scores(cfg, scores, where)
            common.check_scores(cfg, scores_noft, where, "score_noft")
            if cfg.analysis_figure_name is not None and figs and figs[0]:
                _draw_figures(cfg.analysis_figure_name, figs)
            if cfg.save_more_reference and not cfg.test_only:
                display[LABEL_KEY + "_display_train"] = \
                    _train_display_panel(cfg, n_class, steps.eval, teacher,
                                         epoch)
        dsc = common.share(mesh, mean_score(scores))
        runner.dump_scores(epoch, scores)
        results = [("val_result", dsc)]
        if scores_noft:
            runner.dump_scores(epoch, scores_noft, name="score_noft")
            print("val_result_no_finetune: %f" % mean_score(scores_noft))
            results.append(("val_result_no_finetune",
                            mean_score(scores_noft)))
        runner.saver.write_display((epoch + 1) * iters, results,
                                   display or None, force_write=True)
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
