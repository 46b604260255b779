"""Source-domain CLI of the port (counterpart of vae_segmentation_tpu/cli/
source_main.py; reference main_source.py), the first two stages of the
paper's pipeline:

    python -m vae_segmentation_tpu_torch.cli.source_main <prefix> \\
        --method vae_train ... [--device cpu]   # shape-prior VAE on GT masks
    python -m vae_segmentation_tpu_torch.cli.source_main <prefix> \\
        --method seg_train ... [--device cpu]   # supervised SegUNet

``vae_train`` trains a ShapeVAE on the one-hot of the (warped) ground truth
with the sampled latent (``train/steps.py::make_vae_train_step``: the
hand-written reparam+KL kernel on the card), ``seg_train`` a SegUNet on the
warped, normalized image (no step in outer epoch 0, as the reference). Both
print a loss line per step, evaluate after every outer epoch (the VAE's
reconstruction of the ground truth, the Seg's prediction; binary Dice per
case), write ``tensorboard/<prefix>/score_<epoch>.json`` and the best and
periodic checkpoints under ``<save_root>/<prefix>/``. The target CLI takes
them as ``--load_prefix_vae`` and ``--load_prefix``. ``--load_prefix_vae``
(vae_train) and ``--load_prefix`` (seg_train) start from a checkpoint.
With ``--eval_mode sliding_window`` seg_train scores the full volumes
(``cli/common.py::run_sliding_window_eval``: ``--sw_overlap``,
``--postprocess``, ``--postprocess_min_voxels``); vae_train keeps the crop
eval, as in the JAX package.

The Joint's methods (main_source.py:448-544, 631-658): ``joint_train``
(the Seg through the frozen VAE, lambda_vae recon + Dice),
``sep_joint_train`` (a student Joint distilled from a frozen teacher Joint,
assembled from ``--load_prefix_joint`` or from ``--load_prefix`` and
``--load_prefix_vae``) and ``domain_adaptation`` (the cached pseudo label:
at outer epoch 0 the starting Joint's prediction of every train case is
written to ``domain_cache/<prefix>/<case>_pred.npy``, refreshed from the
step's prediction every ``--mode`` epochs; the loss takes the turn /
warmup schedule). Each trains the Seg with the VAE frozen; ``--load_prefix``
/ ``--load_prefix_vae`` load its parts and ``--load_prefix_joint`` the
whole Joint.

The serving outputs and observability, as the target CLI: the saver's
``name value it`` lines and TensorBoard files (the train step's scalars
every 10 steps, vae_train's train panel, ``val_result``),
``--save_eval_result`` (``result/<prefix>/<epoch>_<idx>_{pred.join,pic,
gt}.npy`` every 10th outer epoch for the Seg and Joint methods, and
``_gt_recon.npy`` from the reference VAE of seg_train's
``--load_prefix_vae``), ``--save_more_reference`` (the val and train
panels), ``--profile_dir`` and ``--debug_nans``.

``--resume`` restarts from the latest ``model_epoch<N>.ckpt`` of the
prefix (the port's or the JAX package's): params, outer epoch and best
result, with a fresh optimizer (``cli/common.py::resume``).
``--aug_order 3`` warps the image with the cubic spline, ``--aug_host``
warps in the loader's workers (``data/host_augment.py``).

Under ``torchrun --nproc_per_node N`` the ranks train as the JAX
package's mesh (``cli/common.py::start``; ``--spatial_shards`` splits the
volume's D axis): each step on a rank's slice, the gradients averaged over
the mesh, the eval on rank 0, which alone prints and writes.

Embed's methods (main_source.py:546-635): ``embed_train`` (the image
Encoder, the Fusion and the frozen VAE of the latent-space segmentation;
the Encoder's gradient counts on odd outer epochs only) and
``refine_vae`` (the VAE's decoder refined on the ground truth's and the
decoded latent's reconstructions, its encoder frozen); ``--load_prefix_vae``
loads the Embed's VAE, ``--load_prefix_joint`` the whole Embed; the eval
scores the Fusion's test-mode prediction (``Embed.segment`` through
``eval/evaluate.py::make_seg_eval_step``), as the sliding window does.
``--softrelu 1`` makes vae_train's VAE the soft-ReLU one (softplus after
each norm) and changes no other method's model, as in the JAX package.
It runs on ``--device cuda`` unless told otherwise.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from vae_segmentation_tpu_torch.cli import common
from vae_segmentation_tpu_torch.core.config import (
    SourceConfig, parse_source_args)
from vae_segmentation_tpu_torch.data.pipeline import intensity_normalize
from vae_segmentation_tpu_torch.eval.evaluate import (
    make_joint_eval_step, make_seg_eval_step, make_vae_eval_step,
    mean_score, record_scores)
from vae_segmentation_tpu_torch.models import (
    Embed, Joint, SegUNet, ShapeVAE, load_component, load_network,
    load_state)
from vae_segmentation_tpu_torch.obs.saver import mid_slice_panel, to_numpy
from vae_segmentation_tpu_torch.ops import losses as L
from vae_segmentation_tpu_torch.parallel import collectives, sharding
from vae_segmentation_tpu_torch.train import (
    AdaptConfig, copy_params, default_sched, make_cached_pseudo_adapt_step,
    make_embed_train_step, make_joint_train_step, make_refine_vae_step,
    make_seg_train_step, make_sep_joint_train_step, make_vae_train_step,
    optim)

JOINT_METHODS = ("joint_train", "domain_adaptation", "sep_joint_train")
EMBED_METHODS = ("embed_train", "refine_vae")
METHODS = ("vae_train", "seg_train") + JOINT_METHODS + EMBED_METHODS
# the loss terms of a method's train line (source_main.py:469-478 of the JAX
# package)
PRINT_KEYS = {"vae_train": ("dice_loss", "kl_loss"),
              "seg_train": ("dice_loss",),
              "joint_train": ("recon_loss", "dice_loss"),
              "domain_adaptation": ("recon_loss", "dice_loss_fake",
                                    "dice_loss"),
              "sep_joint_train": ("recon_loss", "dice_loss"),
              "embed_train": ("dice_loss1", "dice_loss2", "mse_loss",
                              "inpaint_loss", "recon_loss"),
              "refine_vae": ("recon_loss", "inpaint_loss", "init_loss")}
# the reference's fixed dict key of every display panel (main_source.py:115)
LABEL_KEY = "venous_pancreas"


def _check_supported(cfg: SourceConfig) -> None:
    if cfg.method not in METHODS:
        raise ValueError(f"--method {cfg.method}: try a valid method")
    if cfg.method == "vae_train" and cfg.load_prefix:
        raise ValueError("--load_prefix loads a SegUNet; vae_train trains a "
                         "ShapeVAE (start it with --load_prefix_vae)")
    if cfg.method in EMBED_METHODS and cfg.load_prefix:
        raise ValueError(f"--load_prefix loads a SegUNet; {cfg.method} "
                         "trains an Embed, which has none (give "
                         "--load_prefix_vae or --load_prefix_joint)")
    if cfg.load_prefix_joint and cfg.method not in JOINT_METHODS \
            + EMBED_METHODS:
        raise ValueError(f"--load_prefix_joint loads a Joint; {cfg.method} "
                         "trains a " + ("ShapeVAE" if cfg.method ==
                                        "vae_train" else "SegUNet"))
    if cfg.method == "sep_joint_train" and not cfg.load_prefix_joint and \
            not (cfg.load_prefix and cfg.load_prefix_vae):
        raise ValueError("sep_joint_train distils a teacher Joint: give "
                         "--load_prefix_joint, or --load_prefix with "
                         "--load_prefix_vae")


def _build_model(cfg: SourceConfig, n_class: int) -> torch.nn.Module:
    """The model zoo dispatch (main_source.py:249-275), weights drawn from
    --seed."""
    gen = torch.Generator().manual_seed(cfg.seed)
    bott = common.bottleneck_for(cfg.patch_size)
    if cfg.method == "vae_train":
        return ShapeVAE(n_class=n_class, dim=128, bottleneck=bott,
                        generator=gen, soft=cfg.softrelu == 1)
    if cfg.method == "seg_train":
        return SegUNet(n_class=n_class, generator=gen)
    if cfg.method in EMBED_METHODS:
        return Embed(n_class=n_class, dim=128, bottleneck=bott,
                     generator=gen)
    return Joint(n_class=n_class, dim=128, bottleneck=bott, generator=gen)


def _load_prefix(cfg: SourceConfig, model: torch.nn.Module
                 ) -> Optional[ShapeVAE]:
    """The selective-load matrix (main_source.py:301-344; cli/source_main.py:
    107-121 of the JAX package). vae_train: --load_prefix_vae; seg_train:
    --load_prefix, and --load_prefix_vae as the reference VAE of its eval
    panels and dumps (returned, mean latent, no gradient); a Joint method:
    --load_prefix into its Seg, --load_prefix_vae into its Vae, then
    --load_prefix_joint into the whole; an Embed method: --load_prefix_vae
    into its Vae, then --load_prefix_joint into the whole. Each
    checkpoint is of that network alone or of a composite (its Seg.* /
    Vae.*)."""
    ref_vae = None
    if cfg.method == "vae_train":
        if cfg.load_prefix_vae:
            load_network(model, common.load(cfg, cfg.load_prefix_vae), "Vae")
        return None
    if cfg.method == "seg_train":
        if cfg.load_prefix:
            load_network(model, common.load(cfg, cfg.load_prefix,
                                            cfg.checkpoint_name), "Seg")
        if cfg.load_prefix_vae:
            ref_vae = ShapeVAE(n_class=model.n_class, dim=128,
                               bottleneck=common.bottleneck_for(
                                   cfg.patch_size))
            load_network(ref_vae, common.load(cfg, cfg.load_prefix_vae),
                         "Vae")
            for p in ref_vae.parameters():
                p.requires_grad_(False)
        return ref_vae
    _load_joint_parts(cfg, model)
    if cfg.load_prefix_joint:
        common.load_joint(cfg, model)
    return None


def _load_joint_parts(cfg: SourceConfig, joint: torch.nn.Module) -> None:
    """--load_prefix into the Joint's Seg, --load_prefix_vae into its Vae
    (an Embed's: its Vae)."""
    if cfg.load_prefix:
        load_component(joint, common.load(cfg, cfg.load_prefix,
                                          cfg.checkpoint_name), "Seg")
    if cfg.load_prefix_vae:
        load_component(joint, common.load(cfg, cfg.load_prefix_vae), "Vae")


def _sep_teacher(cfg: SourceConfig, model: Joint) -> Joint:
    """sep_joint_train's frozen teacher (main_source.py:333-341; cli/
    source_main.py:150-162 of the JAX package): the seed weights, then the
    whole --load_prefix_joint, or the Seg of --load_prefix with the Vae of
    --load_prefix_vae."""
    teacher = Joint(n_class=model.n_class, dim=128,
                    bottleneck=common.bottleneck_for(cfg.patch_size))
    copy_params(teacher, model)
    if cfg.load_prefix_joint:
        common.load_joint(cfg, teacher)
    else:
        _load_joint_parts(cfg, teacher)
    for p in teacher.parameters():
        p.requires_grad_(False)
    return teacher


def _print_line(method: str, epoch: int, eval_epoch: int, idx: int,
                metrics: Dict) -> None:
    vals = ", ".join("%.4f" % float(metrics[k]) for k in PRINT_KEYS[method])
    print("[%3d, %3d] loss: %s" % ((epoch + 1) * eval_epoch, idx + 1, vals))


def _adapt_cfg(cfg: SourceConfig, n_class: int) -> AdaptConfig:
    return AdaptConfig(n_class=n_class, turn_enabled=cfg.turn_epoch != -1)


def _epoch_sched(cfg: SourceConfig, epoch: int) -> Dict:
    """The turn / warmup schedule of the Joint methods (cli/source_main.py:
    426-436 of the JAX package)."""
    sched = default_sched(cfg.lambda_vae)
    if cfg.lambda_vae_warmup > 0:
        sched["warmup_scale"] = 1.0 if epoch >= cfg.lambda_vae_warmup \
            else epoch / cfg.lambda_vae_warmup
    if cfg.turn_epoch != -1:
        sched["turn_phase"] = (epoch // cfg.turn_epoch) % 2
    return sched


class PseudoCache:
    """The source domain_adaptation's pseudo labels (main_source.py:
    367-379; cli/source_main.py:439-467 of the JAX package), keyed by case
    index: ``<middle_path>/<case>_pred.npy``, the [D, H, W, n_class] f32
    prediction. ``fill`` writes, at outer epoch 0, the Joint's prediction of
    every train case (one pass of the train loader, each case's image
    normalized, unwarped, as the JAX package does); ``slice`` reads a
    batch's and takes this rank's part; ``refresh`` writes the step's
    predictions back (--mode). Under torchrun rank 0 alone writes, from the
    global batch (the refresh gathers the ranks' slices to it first), and
    every rank waits at a barrier before it reads."""

    def __init__(self, cfg: SourceConfig, mesh):
        self.cfg, self.mesh = cfg, mesh
        self.writes = common.writes(mesh)

    def path(self, case: int) -> str:
        return os.path.join(self.cfg.middle_path, f"{case}_pred.npy")

    def _barrier(self) -> None:
        if self.mesh is not None and self.mesh.size > 1:
            import torch.distributed as dist

            dist.barrier(group=self.mesh.group)

    @torch.no_grad()
    def fill(self, loader, model: Joint, device) -> None:
        """One pass of `loader` (its shuffle advances as a pass does; a
        rank that does not write draws the pass's order alone): each
        case's first prediction."""
        if not self.writes:
            loader.batch_indices()
            self._barrier()
            return
        os.makedirs(self.cfg.middle_path, exist_ok=True)
        seen = set()
        for batch in loader:
            image = intensity_normalize(
                torch.from_numpy(batch["image"]).to(device))
            preds = to_numpy(model.segment(image[..., None]))
            for i, case in enumerate(np.asarray(batch["index"])):
                if int(case) not in seen:
                    seen.add(int(case))
                    np.save(self.path(int(case)), preds[i])
        self._barrier()

    def slice(self, index, device) -> torch.Tensor:
        pseudo = torch.from_numpy(np.stack(
            [np.load(self.path(int(c))) for c in np.asarray(index)]))
        pseudo = pseudo.to(device)
        return pseudo if self.mesh is None else \
            sharding.batch_shard(self.mesh, pseudo)

    @torch.no_grad()
    def refresh(self, index, pred: torch.Tensor) -> None:
        mesh = self.mesh
        if mesh is not None:
            if mesh.n_spatial > 1:
                pred = collectives.gather_spatial(pred, mesh)
            pred = collectives.gather_data(pred, mesh)
        if self.writes:
            pred = to_numpy(pred)
            for i, case in enumerate(np.asarray(index)):
                np.save(self.path(int(case)), pred[i])
        self._barrier()


def _seg_fn(method: str):
    """(model, images [B, *patch, 1]) -> probabilities: the sliding
    window's patch inference (cli/source_main.py:377-389 of the JAX
    package)."""
    if method == "seg_train":
        return lambda net, x: net(x)
    return lambda net, x: net.segment(x)   # Joint's and Embed's


def run(cfg: SourceConfig) -> float:
    """Train (or with --test_only just evaluate) the method's network;
    returns the best mean validation Dice. Under torchrun: rank 0's,
    on every rank of the mesh (0.0 on a rank outside it)."""
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


def _train_step(cfg: SourceConfig, n_class: int):
    """The method's train step (cli/source_main.py:186-206 of the JAX
    package); ``_train_epoch`` calls it with the method's arguments."""
    m = cfg.method
    if m == "vae_train":
        return make_vae_train_step(n_class, return_display=True)
    if m == "seg_train":
        return make_seg_train_step(n_class)
    if m == "joint_train":
        return make_joint_train_step(n_class)
    if m == "embed_train":
        return make_embed_train_step(n_class)
    if m == "refine_vae":
        return make_refine_vae_step(n_class)
    if m == "domain_adaptation":
        return make_cached_pseudo_adapt_step(_adapt_cfg(cfg, n_class))
    return make_sep_joint_train_step(n_class)


def _run(cfg: SourceConfig, device: torch.device, mesh, runner) -> float:
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    n_class = common.n_classes(cfg)
    m = cfg.method

    loader = ingest = None
    if not cfg.test_only:
        print("Loading data.")
        loader = common.build_train_loader(cfg, data_root=cfg.data_root,
                                           list_key=cfg.train_list)
        ingest = common.make_train_ingest(cfg, device, mesh)
    val_ds = common.build_val_dataset(cfg, data_root=cfg.val_data_root,
                                      list_key=cfg.val_list)

    print("Building model.")
    model = _build_model(cfg, n_class)
    teacher = None
    print("Loading prefix.")
    ref_vae = _load_prefix(cfg, model)
    if m == "sep_joint_train":
        teacher = _sep_teacher(cfg, model).to(device)
    if ref_vae is not None:
        ref_vae = ref_vae.to(device)
    model = model.to(device)
    if mesh is not None:
        sharding.replicate(mesh, model)
        if teacher is not None:
            sharding.replicate(mesh, teacher)
    # embed_train: the VAE frozen, the Encoder's gradient switched by the
    # step; refine_vae: the VAE's encoder half (cli/source_main.py:91-103
    # of the JAX package)
    trainable = optim.freeze_vae(model) \
        if m in JOINT_METHODS + ("embed_train",) \
        else optim.freeze_vae_encoder(model) if m == "refine_vae" \
        else model.parameters()
    optimizer = optim.build(trainable, cfg.adam, cfg.lr_seg,
                            weight_decay=cfg.weight_decay)
    step = _train_step(cfg, n_class)
    if m == "vae_train":
        eval_step = make_vae_eval_step(model, n_class)
    elif m == "seg_train":
        eval_step = make_seg_eval_step(model, n_class)
    elif m in EMBED_METHODS:
        eval_step = make_seg_eval_step(model.segment, n_class)
    else:
        eval_step = make_joint_eval_step(model, n_class)
    def restore(ck):
        if m in JOINT_METHODS + EMBED_METHODS:
            load_state(model, ck)
        else:
            load_network(model, ck, "Vae" if m == "vae_train" else "Seg")

    start_epoch = common.resume(cfg, runner, restore)
    # draws the warp and, for vae_train and the Embed methods, the reparam
    # seeds
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    cache = PseudoCache(cfg, mesh) if m == "domain_adaptation" else None
    iters = common.iterations_per_epoch(cfg)

    print("Start training")
    for epoch in range(start_epoch, cfg.outer_epochs):
        if not cfg.test_only:
            if epoch == 0 and cache is not None:
                cache.fill(loader, model, device)
            if epoch == 0 and m in ("seg_train", "domain_adaptation"):
                common.skip_epoch(loader)  # epoch-0 skip (:416, :481)
            else:
                _train_epoch(cfg, epoch, loader, step, ingest, model,
                             teacher, optimizer, generator, cache, runner,
                             mesh)
        print("Start evaluation")
        dsc, scores, display = 0.0, {}, {}
        if common.writes(mesh):
            if cfg.eval_mode == "sliding_window" and m != "vae_train":
                dsc, scores = common.run_sliding_window_eval(
                    cfg, _seg_fn(m), model, n_class=n_class,
                    data_root=cfg.val_data_root, list_key=cfg.val_list,
                    pan_index=cfg.pan_index)
            else:
                scores, display = _crop_eval(cfg, m, n_class, val_ds,
                                             device, eval_step, ref_vae,
                                             epoch)
                dsc = mean_score(scores)
            common.check_scores(cfg, scores,
                                f"epoch {(epoch + 1) * cfg.eval_epoch} "
                                "(eval)")
            if cfg.save_more_reference and not cfg.test_only and \
                    m not in ("vae_train",) + EMBED_METHODS:
                display[LABEL_KEY + "_display_train"] = \
                    _train_display_panel(cfg, n_class, eval_step, ref_vae,
                                         epoch)
        dsc = common.share(mesh, dsc)
        runner.dump_scores(epoch, scores)
        runner.saver.write_display((epoch + 1) * iters, [("val_result", dsc)],
                                   display or None, force_write=True)
        runner.end_of_epoch(epoch, dsc, model, optimizer)
        if cfg.test_only:
            break
    return runner.best_result


def _train_epoch(cfg: SourceConfig, epoch: int, loader, step, ingest, model,
                 teacher, optimizer, generator, cache: Optional[PseudoCache],
                 runner, mesh) -> None:
    """One outer epoch of the method's steps (cli/source_main.py:218-262 of
    the JAX package): a loss line a step and the step's scalars (and
    vae_train's train panel) to the saver; the source domain_adaptation
    reads each batch's cached pseudo labels and, every --mode epochs,
    writes the step's predictions back."""
    m = cfg.method
    sched = _epoch_sched(cfg, epoch)
    refresh = cache is not None and cfg.mode != 0 and epoch % cfg.mode == 0
    for idx, batch in enumerate(loader):
        image, label = ingest(batch, generator)
        pseudo = None if cache is None else cache.slice(batch["index"],
                                                        image.device)
        where = f"epoch {(epoch + 1) * cfg.eval_epoch}, iteration {idx + 1}"
        with common.nan_guard(cfg, where), sharding.active(mesh):
            if m == "vae_train":
                metrics = step(model, optimizer, label, generator)
            elif m == "seg_train":
                metrics = step(model, optimizer, image, label)
            elif m == "joint_train":
                metrics = step(model, optimizer, image, label, sched)
            elif m == "embed_train":
                # the Encoder learns on odd outer epochs (main_source.py:
                # 551-555)
                metrics = step(model, optimizer, image, label, generator,
                               float(epoch % 2))
            elif m == "refine_vae":
                metrics = step(model, optimizer, image, label, generator)
            elif m == "domain_adaptation":
                metrics = step(model, optimizer, image, label, pseudo, sched)
            else:
                metrics = step(model, teacher, optimizer, image)
        pred = metrics.pop("pred", None)
        if refresh:
            with sharding.active(mesh):
                cache.refresh(batch["index"], pred)
        panel = metrics.pop("display", None)
        _print_line(m, epoch, cfg.eval_epoch, idx, metrics)
        runner.saver.write_display(
            idx + epoch * len(loader), list(metrics.items()),
            None if panel is None else {LABEL_KEY + "_display": panel})


def _crop_eval(cfg: SourceConfig, m: str, n_class: int, val_ds, device,
               eval_step, ref_vae: Optional[ShapeVAE], epoch: int):
    """The crop eval (cli/source_main.py:276-330 of the JAX package):
    ({case: Dice}, the val display panel). --save_more_reference takes
    the panel of case epoch % cases: vae_train [gt c0, gt c1, recon c1],
    the Joint methods [recon, gt, pred], seg_train with its reference VAE
    [image, gt, pred, the VAE's reconstruction of pred] (class 1);
    --save_eval_result dumps every case of the Seg and Joint methods every
    10th epoch, with seg_train's reference VAE also its reconstruction of
    the one-hot label (``_gt_recon.npy``)."""
    scores: Dict[int, float] = {}
    display: Dict[str, np.ndarray] = {}
    dump = cfg.save_eval_result and epoch % 10 == 0 and \
        m not in ("vae_train",) + EMBED_METHODS
    for batch in common.val_batches(val_ds, cfg.val_batch, device):
        image, label, index = batch["image_norm"], batch["label"], \
            batch["index"]
        j = common.panel_sample(index, epoch, len(val_ds))
        panel = cfg.save_more_reference and j is not None
        onehot = L.one_hot_label(label, n_class)
        if m == "vae_train":
            out = eval_step(label)
            if panel:
                display[LABEL_KEY + "_display"] = mid_slice_panel(
                    onehot[j:j + 1][..., 0], onehot[j:j + 1][..., 1],
                    out["recon"][j:j + 1][..., 1])
            record_scores(scores, out["score"], index)
            continue
        out = eval_step(image, label)
        record_scores(scores, out["score"], index)
        pred = out["pred"]
        if dump:
            common.dump_eval_batch(cfg, epoch, index, pred, image, label,
                                   n_class)
            if ref_vae is not None:
                with torch.no_grad():
                    gt_recon = np.moveaxis(to_numpy(L.binarize(
                        ref_vae(onehot)[0])), -1, 1)
                for i, vi in enumerate(np.asarray(index)):
                    np.save(os.path.join(cfg.result_path,
                                         f"{epoch}_{int(vi)}_gt_recon"),
                            gt_recon[i:i + 1])
        if panel and "recon" in out:
            display[LABEL_KEY + "_display_val"] = mid_slice_panel(
                out["recon"][j:j + 1][..., 1], onehot[j:j + 1][..., 1],
                pred[j:j + 1][..., 1])
        elif panel and ref_vae is not None:
            with torch.no_grad():
                recon_pred = ref_vae(pred)[0]
            display[LABEL_KEY + "_display_val"] = mid_slice_panel(
                image[j:j + 1], onehot[j:j + 1][..., 1],
                pred[j:j + 1][..., 1], recon_pred[j:j + 1][..., 1])
    return scores, display


def _train_display_panel(cfg: SourceConfig, n_class: int, eval_step,
                         ref_vae: Optional[ShapeVAE], epoch: int
                         ) -> np.ndarray:
    """The post-eval panel of train case epoch % cases (main_source.py:
    776-811; cli/source_main.py:391-419 of the JAX package), the case
    normalized as the eval's (no warp): the Joint methods [recon, gt,
    pred], seg_train [image, gt, pred] and with its reference VAE the
    VAE's reconstruction of pred (class 1)."""
    ds = common.build_val_dataset(cfg, data_root=cfg.data_root,
                                  list_key=cfg.train_list)
    case = ds[epoch % len(ds)]
    image = intensity_normalize(torch.from_numpy(
        case["image"].astype(np.float32)))[None]
    label = torch.from_numpy(case["label"].astype(np.float32))[None]
    out = eval_step(image, label)
    onehot = L.one_hot_label(label, n_class)
    if "recon" in out:
        return mid_slice_panel(out["recon"][..., 1], onehot[..., 1],
                               out["pred"][..., 1])
    vols = [image, onehot[..., 1], out["pred"][..., 1]]
    if ref_vae is not None:
        with torch.no_grad():
            vols.append(ref_vae(out["pred"])[0][..., 1])
    return mid_slice_panel(*vols)


def main(argv: Optional[List[str]] = None) -> float:
    with common.rank_stdout():
        return run(parse_source_args(argv))


if __name__ == "__main__":
    main()
