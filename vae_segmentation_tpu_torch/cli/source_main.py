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

``--resume`` restarts from the latest ``model_epoch<N>.ckpt`` of the
prefix (the port's or the JAX package's): params, outer epoch and best
result, with a fresh optimizer (``cli/common.py::resume``).
``--aug_order 3`` warps the image with the cubic spline, ``--aug_host``
warps in the loader's workers (``data/host_augment.py``).

Under ``torchrun --nproc_per_node N`` the ranks train as the JAX
package's mesh (``cli/common.py::start``; ``--spatial_shards`` splits the
volume's D axis): each step on a rank's slice, the gradients averaged over
the mesh, the eval on rank 0, which alone prints and writes.

The other methods and the flags this slice does not port raise
NotImplementedError naming their ROADMAP item. It runs on ``--device cuda``
unless told otherwise.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from vae_segmentation_tpu_torch.cli import common
from vae_segmentation_tpu_torch.cli.common import todo
from vae_segmentation_tpu_torch.core.config import (
    SourceConfig, parse_source_args)
from vae_segmentation_tpu_torch.eval.evaluate import (
    make_seg_eval_step, make_vae_eval_step, run_eval)
from vae_segmentation_tpu_torch.models import SegUNet, ShapeVAE, load_network
from vae_segmentation_tpu_torch.parallel import sharding
from vae_segmentation_tpu_torch.train import (
    make_seg_train_step, make_vae_train_step, optim)

METHODS = ("vae_train", "seg_train")
# the loss terms of a method's train line (source_main.py:469-484 of the JAX
# package)
PRINT_KEYS = {"vae_train": ("dice_loss", "kl_loss"),
              "seg_train": ("dice_loss",)}


def _check_supported(cfg: SourceConfig) -> None:
    if cfg.method not in METHODS:
        todo(f"--method {cfg.method}", "item 11 (the other source methods)")
    if cfg.softrelu == 1:
        todo("--softrelu 1 (the soft-ReLU VAE)", "item 11")
    if cfg.save_eval_result or cfg.save_more_reference \
            or cfg.profile_dir is not None:
        todo("eval npy dumps, TensorBoard panels and profiling", "item 11")
    if cfg.load_prefix_joint:
        todo("--load_prefix_joint for the source methods", "item 11")
    if cfg.method == "seg_train" and cfg.load_prefix_vae:
        todo("--load_prefix_vae with seg_train (the reference VAE of the "
             "eval panels and dumps)", "item 11")
    if cfg.method == "vae_train" and cfg.load_prefix:
        raise ValueError("--load_prefix loads a SegUNet; vae_train trains a "
                         "ShapeVAE (start it with --load_prefix_vae)")


def _build_model(cfg: SourceConfig, n_class: int) -> torch.nn.Module:
    """The model zoo dispatch (main_source.py:249-275), weights drawn from
    --seed."""
    gen = torch.Generator().manual_seed(cfg.seed)
    if cfg.method == "vae_train":
        return ShapeVAE(n_class=n_class, dim=128,
                        bottleneck=common.bottleneck_for(cfg.patch_size),
                        generator=gen)
    return SegUNet(n_class=n_class, generator=gen)


def _load_prefix(cfg: SourceConfig, model: torch.nn.Module) -> None:
    """--load_prefix_vae (vae_train) / --load_prefix (seg_train): a
    checkpoint of that network alone or of a Joint (its Vae.* / Seg.*)."""
    if cfg.method == "vae_train" and cfg.load_prefix_vae:
        load_network(model, common.load(cfg, cfg.load_prefix_vae), "Vae")
    if cfg.method == "seg_train" and cfg.load_prefix:
        load_network(model, common.load(cfg, cfg.load_prefix,
                                        cfg.checkpoint_name), "Seg")


def _print_line(method: str, epoch: int, eval_epoch: int, idx: int,
                metrics: Dict) -> None:
    vals = ", ".join("%.4f" % float(metrics[k]) for k in PRINT_KEYS[method])
    print("[%3d, %3d] loss: %s" % ((epoch + 1) * eval_epoch, idx + 1, vals))


def run(cfg: SourceConfig) -> float:
    """Train (or with --test_only just evaluate) the method's network;
    returns the best mean validation Dice. Under torchrun: rank 0's,
    on every rank of the mesh (0.0 on a rank outside it)."""
    _check_supported(cfg)
    world, mesh, device = common.start(cfg)
    try:
        return 0.0 if device is None else _run(cfg, device, mesh)
    finally:
        common.stop(world)


def _run(cfg: SourceConfig, device: torch.device, mesh) -> float:
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    n_class = common.n_classes(cfg)
    vae = cfg.method == "vae_train"
    runner = common.EpochRunner(cfg, writes=common.writes(mesh))

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
    print("Loading prefix.")
    _load_prefix(cfg, model)
    model = model.to(device)
    if mesh is not None:
        sharding.replicate(mesh, model)
    optimizer = optim.build(model.parameters(), cfg.adam, cfg.lr_seg,
                            weight_decay=cfg.weight_decay)
    if vae:
        step = make_vae_train_step(n_class)
        eval_step = make_vae_eval_step(model, n_class)
    else:
        step = make_seg_train_step(n_class)
        eval_step = make_seg_eval_step(model, n_class)
    start_epoch = common.resume(
        cfg, runner, lambda ck: load_network(model, ck, "Vae" if vae
                                             else "Seg"))
    # draws the warp and, for vae_train, the reparam seeds
    generator = torch.Generator(device=device).manual_seed(cfg.seed)

    print("Start training")
    for epoch in range(start_epoch, cfg.outer_epochs):
        if not cfg.test_only:
            if epoch == 0 and not vae:
                common.skip_epoch(loader)  # epoch-0 skip (:416)
            else:
                for idx, batch in enumerate(loader):
                    image, label = ingest(batch, generator)
                    with sharding.active(mesh):
                        metrics = step(model, optimizer, label, generator) \
                            if vae else step(model, optimizer, image, label)
                    _print_line(cfg.method, epoch, cfg.eval_epoch, idx,
                                metrics)
        print("Start evaluation")
        dsc, scores = 0.0, {}
        if common.writes(mesh):
            if cfg.eval_mode == "sliding_window" and not vae:
                dsc, scores = common.run_sliding_window_eval(
                    cfg, lambda net, x: net(x), model, n_class=n_class,
                    data_root=cfg.val_data_root, list_key=cfg.val_list,
                    pan_index=cfg.pan_index)
            else:
                dsc, scores = run_eval(
                    common.val_batches(val_ds, cfg.val_batch, device),
                    eval_step, uses_image=not vae)
        dsc = common.share(mesh, dsc)
        runner.dump_scores(epoch, scores)
        runner.end_of_epoch(epoch, dsc, model, optimizer)
        if cfg.test_only:
            break
    return runner.best_result


def main(argv: Optional[List[str]] = None) -> float:
    with common.rank_stdout():
        return run(parse_source_args(argv))


if __name__ == "__main__":
    main()
