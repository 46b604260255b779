"""Target-domain CLI of the port (counterpart of vae_segmentation_tpu/cli/
target_main.py), its flagship ``--method domain_adaptation``:

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
package (its Joint always encodes with the mean latent).

The other methods (main_target.py:316-344): ``vae_train`` trains a
ShapeVAE on the target's ground-truth masks (``make_vae_train_step``,
the soft-ReLU VAE with ``--softrelu 1``; ``--load_prefix_joint`` starts
it from a VAE checkpoint), scored by its
reconstruction's Dice; ``discriminator_train`` trains a ShapeEncoder
(``--load_prefix_encoder`` or ``--load_prefix_joint`` start it) to
score the warped masks against each case's realism score, read from
``<data_root>/score.json`` (case id -> score, 1.0 where absent), and
scores each val case 1 - its squared error; ``domain_adaptation_dis``
adapts a Joint2 (Seg + the frozen discriminator, ``--load_prefix_encoder``
its Dis, ``--load_prefix`` its Seg) with the discriminator's score in place
of the VAE's reconstruction loss, against a teacher SegUNet (the EMA, the
epoch-0 skip and ``--pseudo_list``'s teacher copies as
domain_adaptation's, with no replay step). ft1, the analysis figures,
the source replay and ``--load_prefix_vae`` are domain_adaptation's; the
other methods ignore them, as the JAX package's do. ``--load_prefix`` or
``--load_prefix_encoder`` for a network the method has not raises
ValueError (the JAX package's load fails on the missing subtree).

Under ``torchrun --nproc_per_node N`` the ranks train as the JAX package's
mesh (``cli/common.py::start``; ``--spatial_shards S`` splits the volume's
D axis over S ranks): every adaptation and replay step on a rank's slice,
the gradients averaged over the mesh, the EMA teacher updated alike on
every rank; the eval (with ft1 and the sliding window) runs on rank 0 as
in one process, which alone prints and writes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from vae_segmentation_tpu_torch.cli import common
from vae_segmentation_tpu_torch.core.config import (
    TargetConfig, parse_target_args)
from vae_segmentation_tpu_torch.data.manifest import (
    case_id, filedict_from_json)
from vae_segmentation_tpu_torch.data.pipeline import (
    TrainLoader, intensity_normalize)
from vae_segmentation_tpu_torch.eval.evaluate import (
    make_analysis_metrics_step, make_discriminator_eval_step,
    make_joint_eval_step, make_seg_eval_step, make_vae_eval_step,
    mean_score, record_scores)
from vae_segmentation_tpu_torch.models import (
    Joint, Joint2, SegUNet, ShapeEncoder, ShapeVAE, load_component,
    load_network, load_state)
from vae_segmentation_tpu_torch.obs import draw
from vae_segmentation_tpu_torch.obs.saver import mid_slice_panel, to_numpy
from vae_segmentation_tpu_torch.obs.timing import StepTimer
from vae_segmentation_tpu_torch.ops import losses as L
from vae_segmentation_tpu_torch.parallel import sharding
from vae_segmentation_tpu_torch.train import (
    AdaptConfig, copy_params, default_sched, ema_update_seg,
    make_adapt_dis_step, make_adapt_step, make_discriminator_step,
    make_seg_replay_step, make_vae_train_step, optim)


# the reference's fixed dict key of every display panel
LABEL_KEY = "venous_pancreas"
ADAPT_METHODS = ("domain_adaptation", "domain_adaptation_dis")
METHODS = ("vae_train", "discriminator_train") + ADAPT_METHODS
# the network each of these load flags loads, and the methods that have
# one (--load_prefix_vae is read by domain_adaptation, ignored otherwise)
LOADS = {"load_prefix": ("a SegUNet", ADAPT_METHODS),
         "load_prefix_encoder": ("a ShapeEncoder", (
             "discriminator_train", "domain_adaptation_dis"))}
# the bare network of a method and its name in a composite
BARE = {"vae_train": "Vae", "discriminator_train": "Dis"}


def _check_supported(cfg: TargetConfig) -> None:
    m = cfg.method
    if m not in METHODS:
        raise ValueError(f"--method {m}: try a valid method")
    for flag, (net, methods) in LOADS.items():
        if getattr(cfg, flag) and m not in methods:
            raise ValueError(f"--{flag} loads {net}; --method {m} has none")
    if cfg.analysis_figure_name is not None and m == "domain_adaptation":
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


def _score_lookup(cfg: TargetConfig, list_key: str) -> np.ndarray:
    """discriminator_train's realism targets, one a case of the list
    (cli/target_main.py:71-86 of the JAX package): <data_root>/score.json
    maps case id -> score; 1.0 where a case or the file is absent."""
    entries = filedict_from_json(cfg.data_path, list_key, 1)
    path = os.path.join(cfg.data_root, "score.json")
    raw = {}
    if os.path.exists(path):
        with open(path) as f:
            raw = json.load(f)
    return np.array([float(raw.get(case_id(e), 1.0)) for e in entries],
                    np.float32)


def _build_models(cfg: TargetConfig, n_class: int, device: torch.device):
    """(student, teacher) after the load matrix of main_target.py:355-394
    (cli/target_main.py:133-200 of the JAX package); the teacher is None
    where the method has none."""
    m = cfg.method
    gen = torch.Generator().manual_seed(cfg.seed)
    bott = common.bottleneck_for(cfg.patch_size)
    teacher = None
    print("Loading prefix.")
    if m == "vae_train":
        model = ShapeVAE(n_class=n_class, dim=128, bottleneck=bott,
                         generator=gen, soft=cfg.softrelu == 1)
    elif m == "discriminator_train":
        model = ShapeEncoder(dim=1, bottleneck=bott, generator=gen)
        if cfg.load_prefix_encoder:
            load_network(model, common.load(cfg, cfg.load_prefix_encoder),
                         "Dis")
    elif m == "domain_adaptation_dis":
        model = Joint2(n_class=n_class, bottleneck=bott, generator=gen,
                       seg_dropout=cfg.seg_dropout)
        teacher = SegUNet(n_class=n_class)
        copy_params(teacher, model.Seg)
        if cfg.load_prefix:
            ck = common.load(cfg, cfg.load_prefix, cfg.checkpoint_name)
            load_network(teacher if cfg.from_scratch else model.Seg, ck,
                         "Seg")
            if not cfg.from_scratch:
                copy_params(teacher, model.Seg)
        if cfg.load_prefix_encoder:
            load_component(model, common.load(cfg, cfg.load_prefix_encoder),
                           "Dis")
    else:
        model, teacher = _build_joints(cfg, n_class, gen, bott)
    if cfg.load_prefix_joint:
        # the whole model; a bare network's from a composite's part too
        ck = common.load(cfg, cfg.load_prefix_joint)
        if m in BARE:
            load_network(model, ck, BARE[m])
        else:
            load_state(model, ck)
    if m == "domain_adaptation" and (cfg.test_only or not cfg.from_scratch):
        copy_params(teacher, model)
    if teacher is not None:
        for p in teacher.parameters():
            p.requires_grad_(False)
        teacher = teacher.to(device)
    return model.to(device), teacher


def _build_joints(cfg: TargetConfig, n_class: int, gen, bott: int):
    """domain_adaptation's student and teacher Joints: the seed weights,
    then --load_prefix's Seg (into the teacher with --from_scratch) and
    --load_prefix_vae's Vae."""
    kw = dict(n_class=n_class, dim=128, bottleneck=bott)
    model = Joint(vae_decoder_dropout=cfg.vae_decoder_dropout,
                  seg_dropout=cfg.seg_dropout, generator=gen, **kw)
    teacher = Joint(**kw)
    copy_params(teacher, model)
    if cfg.load_prefix:
        load_component(teacher if cfg.from_scratch else model,
                       common.load(cfg, cfg.load_prefix, cfg.checkpoint_name),
                       "Seg")
    if cfg.load_prefix_vae:
        ck = common.load(cfg, cfg.load_prefix_vae)
        if cfg.from_scratch:
            load_component(teacher, ck, "Vae")
        load_component(model, ck, "Vae")
    return model, teacher


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
    """The crop eval's steps: the student's eval and, for
    domain_adaptation, its analysis steps and, with ft1, the finetune and
    the ft copy's (None where not asked, and for domain_adaptation_dis,
    which ignores those flags as the JAX package's does)."""

    def __init__(self, cfg: TargetConfig, n_class: int, device, model,
                 teacher):
        self.analysis = self.ft_eval = self.ft_analysis = None
        self.finetune = self.ft_model = None
        if cfg.method == "domain_adaptation_dis":
            self.eval = make_seg_eval_step(model.Seg, n_class)
            return
        self.eval = make_joint_eval_step(model, n_class)
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
        if cfg.save_more_reference and j is not None and "recon" in out:
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
    package) with the student's Seg. With ft1 each case first finetunes
    the ft copy on its ROI crop (the crop path's case, `val_ds`) and the
    sweep uses it; a second sweep with the student fills score_noft."""
    def sweep(model_for_case=None):
        return common.run_sliding_window_eval(
            cfg, lambda net, x: net.Seg(x), model, n_class=n_class,
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


# the loss terms of a method's train line (cli/target_main.py:609-615 of
# the JAX package), and the replay's
PRINT_KEYS = {"vae_train": ("dice_loss", "kl_loss"),
              "discriminator_train": ("final_loss",),
              "domain_adaptation": ("recon_loss", "dice_loss_fake",
                                    "dice_loss", "dice_loss_pseudo"),
              "domain_adaptation_dis": ("discriminator_loss",
                                        "dice_loss_fake", "dice_loss")}


def _print_line(method: str, epoch: int, eval_epoch: int, idx: int,
                metrics: Dict) -> None:
    vals = ", ".join("%.4f" % float(metrics[k]) for k in PRINT_KEYS[method]
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
                 replay: Optional[SourceReplay] = None, mesh=None,
                 train_scores: Optional[np.ndarray] = None) -> float:
    """One outer epoch of the method's steps (an adaptation step followed by
    a replay step with --pseudo_list); returns lambda_vae after the --tag
    decay. `generator` draws the warps, the MC dropout masks and
    vae_train's reparam seeds; the steps run on this rank's slice of
    `mesh`; discriminator_train's targets are `train_scores` of the batch's
    cases. Each step's scalars, ``steps_per_sec`` and its display panel go
    to the runner's saver (cli/target_main.py:252-260 of the JAX
    package)."""
    m = cfg.method
    adapt = m in ADAPT_METHODS
    if epoch == 0 and adapt:
        common.skip_epoch(loader)  # epoch-0 skip (main_target.py:506, 694)
        return lambda_vae
    sched = _epoch_sched(cfg, epoch, lambda_vae)
    # EMA cadence (main_target.py:508-509): once per inner dataset pass (the
    # list is replicated eval_epoch x), or every iteration
    ema_interval = max(len(loader) // cfg.eval_epoch, 1) \
        if cfg.pseudo_save_epoch != 0 and adapt else None
    if replay is not None:
        replay.new_pass()
    for idx, batch in enumerate(loader):
        if adapt and cfg.pseudo_list is not None:
            # the replay runs' teacher: a full copy of the student (of its
            # Seg for a SegUNet teacher) on every iteration of a qualifying
            # epoch, --tag dividing lambda by 10 (main_target.py:633-635)
            if cfg.pseudo_save_epoch != 0 and \
                    epoch % cfg.pseudo_save_epoch == 0:
                copy_params(teacher, model.Seg
                            if isinstance(teacher, SegUNet) else model)
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
                if m == "vae_train":
                    metrics = step(model, optimizer, label, generator)
                elif m == "discriminator_train":
                    score = torch.from_numpy(train_scores[
                        np.asarray(batch["index"]) % len(train_scores)])
                    score = score.to(label.device)
                    if mesh is not None:
                        score = sharding.batch_shard(mesh, score,
                                                     spatial=False)
                    metrics = step(model, optimizer, label, score)
                else:
                    metrics = step(model, teacher, optimizer, image, label,
                                   generator, sched)
            if replay is not None:
                metrics = dict(metrics, dice_loss_pseudo=replay(model))
        timer.tick()
        metrics.pop("score_out", None)
        _print_line(m, epoch, cfg.eval_epoch, idx, metrics)
        display = metrics.pop("display", None)
        runner.saver.write_display(
            idx + epoch * len(loader),
            list(metrics.items()) + [("steps_per_sec", timer.rate)],
            image=None if display is None
            else {LABEL_KEY + "_display": display})
    return lambda_vae


def _label_eval(cfg: TargetConfig, n_class: int, val_ds, device,
                model) -> Dict[int, float]:
    """vae_train's and discriminator_train's eval (cli/target_main.py:
    389-405 of the JAX package): {case: the reconstruction's binary Dice},
    or {case: 1 - (target - the discriminator's score of its label)^2}."""
    scores: Dict[int, float] = {}
    if cfg.method == "vae_train":
        step = make_vae_eval_step(model, n_class)
        for batch in common.val_batches(val_ds, cfg.val_batch, device):
            record_scores(scores, step(batch["label"])["score"],
                          batch["index"])
        return scores
    step = make_discriminator_eval_step(model)
    targets = _score_lookup(cfg, cfg.val_list)
    for batch in common.val_batches(val_ds, cfg.val_batch, device):
        t = targets[np.asarray(batch["index"]) % len(targets)]
        record_scores(scores, step(batch["label"], t)["score"],
                      batch["index"])
    return scores


def _train_step(cfg: TargetConfig, n_class: int):
    """The method's train step (cli/target_main.py:256-275 of the JAX
    package); --pseudo_list runs of domain_adaptation take the restricted
    loss of main_target.py:642-653."""
    m = cfg.method
    if m == "vae_train":
        return make_vae_train_step(n_class)
    if m == "discriminator_train":
        return make_discriminator_step()
    if m == "domain_adaptation_dis":
        return make_adapt_dis_step(_adapt_cfg(cfg, n_class))
    return make_adapt_step(
        _adapt_cfg(cfg, n_class),
        variant="pseudo" if cfg.pseudo_list is not None else "train")


def _trainable(cfg: TargetConfig, model: torch.nn.Module):
    """The optimizer's parameters (cli/target_main.py:209-218 of the JAX
    package): the Seg (its head with --fix_layer) of the adaptation
    methods, everything of the others."""
    if cfg.method == "domain_adaptation":
        return optim.freeze_all_but_seg_head(model) if cfg.fix_layer \
            else optim.freeze_vae(model)
    if cfg.method == "domain_adaptation_dis":
        return optim.freeze_dis(model)
    return list(model.parameters())


def run(cfg: TargetConfig) -> float:
    """Train (or with --test_only just evaluate) the method's model;
    returns the best mean validation score (the mean with --test_only).
    Under
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
    m = cfg.method

    print("Building model.")
    model, teacher = _build_models(cfg, n_class, device)
    if mesh is not None:
        sharding.replicate(mesh, model)
        if teacher is not None:
            sharding.replicate(mesh, teacher)
    val_ds = common.build_val_dataset(cfg, data_root=cfg.val_data_root,
                                      list_key=cfg.val_list)
    steps = EvalSteps(cfg, n_class, device, model, teacher) \
        if m in ADAPT_METHODS else None
    finetune, ft_model = (steps.finetune, steps.ft_model) if steps \
        else (None, None)
    # params, epoch and best of the latest periodic checkpoint; the teacher
    # stays the copy made from the load flags, as in the JAX package
    start_epoch = common.resume(cfg, runner, lambda ck: load_state(model, ck))

    loader = step = ingest = optimizer = generator = replay = None
    train_scores = None
    if not cfg.test_only:
        print("Loading data.")
        loader = common.build_train_loader(cfg, data_root=cfg.data_root,
                                           list_key=cfg.train_list)
        ingest = common.make_train_ingest(cfg, device, mesh)
        optimizer = optim.build(_trainable(cfg, model), cfg.adam, cfg.lr_seg,
                                weight_decay=cfg.weight_decay)
        step = _train_step(cfg, n_class)
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
        if cfg.pseudo_list is not None and m == "domain_adaptation":
            replay = SourceReplay(cfg, n_class, ingest, optimizer, generator,
                                  mesh)
        if m == "discriminator_train":
            train_scores = _score_lookup(cfg, cfg.train_list)
        print("Start training")

    lambda_vae = cfg.lambda_vae  # host-mutable (--tag decay)
    timer = StepTimer()
    iters = common.iterations_per_epoch(cfg)
    for epoch in range(start_epoch, cfg.outer_epochs):
        if not cfg.test_only:
            lambda_vae = _train_epoch(cfg, epoch, loader, step, ingest,
                                      model, teacher, optimizer, generator,
                                      lambda_vae, runner, timer, replay,
                                      mesh, train_scores)
        print("Start evaluation")
        t0 = time.time()
        # ft1 from the first outer epoch that trained (main_target.py:807)
        ft = finetune if epoch != 0 or cfg.test_only else None
        sched = _epoch_sched(cfg, epoch, lambda_vae)
        scores, scores_noft, display, figs = {}, {}, {}, ()
        if common.writes(mesh):  # the other ranks wait in share()
            if steps is None:
                scores = _label_eval(cfg, n_class, val_ds, device, model)
            elif cfg.eval_mode == "sliding_window":
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
            if cfg.save_more_reference and not cfg.test_only and \
                    m == "domain_adaptation":
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
