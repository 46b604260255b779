"""Target-domain CLI of the port (counterpart of vae_segmentation_tpu/cli/
target_main.py). Ported so far: the evaluation of a trained Joint model,

    python -m vae_segmentation_tpu_torch.cli.target_main <prefix> \\
        --method domain_adaptation --test_only --load_prefix_joint <p> \\
        [--val_batch N] [--device cuda|cpu] ...

which loads ``<save_root>/<p>/best_model.ckpt`` (a port or reference torch
checkpoint), runs one ROI crop per validation case through Joint on the
device, and writes the per-case binary Dice to
``tensorboard/<prefix>/score_0.json`` in the JAX CLI's format. Every other
method or flag combination raises NotImplementedError naming the ROADMAP
item that will port it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from vae_segmentation_tpu_torch.core.checkpoint import (
    checkpoint_path, load_checkpoint)
from vae_segmentation_tpu_torch.core.config import (
    TargetConfig, parse_target_args)
from vae_segmentation_tpu_torch.core.device import resolve_device
from vae_segmentation_tpu_torch.data.manifest import filedict_from_json
from vae_segmentation_tpu_torch.data.pipeline import (
    CaseDataset, intensity_normalize, iterate_batches)
from vae_segmentation_tpu_torch.data.transforms import parse_pan_index
from vae_segmentation_tpu_torch.eval.evaluate import (
    make_joint_eval_step, run_eval)
from vae_segmentation_tpu_torch.models import Joint, load_state


def bottleneck_for(patch_size, top_fmaps: int = 256) -> int:
    """Flattened VAE bottleneck width: fmaps[-1] * prod(patch / 32)
    (16384 at the reference's 128^3, joint_model.py:222)."""
    n = top_fmaps
    for p in patch_size:
        n *= p // 32
    return n


def _check_supported(cfg: TargetConfig) -> None:
    def todo(what: str, item: str):
        raise NotImplementedError(
            f"{what} is not ported yet: ROADMAP.md queue 1, {item}")

    if cfg.method != "domain_adaptation":
        todo(f"--method {cfg.method}",
             "item 4 (vae_train) / item 10 (the other methods)")
    if not cfg.test_only or cfg.pseudo_list is not None:
        todo("training (the adaptation step)", "item 2")
    if not cfg.load_prefix_joint or cfg.load_prefix or cfg.load_prefix_vae \
            or cfg.load_prefix_encoder or cfg.resume:
        todo("loading anything but --load_prefix_joint", "item 2")
    if cfg.val_finetune != 0:
        todo("--val_finetune (ft1 test-time training)", "item 3")
    if cfg.eval_mode != "crop":
        todo(f"--eval_mode {cfg.eval_mode}", "item 5")
    if cfg.spatial_shards != 1:
        todo("--spatial_shards", "item 8")
    if cfg.analysis_figure_name is not None or cfg.save_eval_result \
            or cfg.save_more_reference or cfg.profile_dir is not None:
        todo("eval figures, npy dumps, TensorBoard panels and profiling",
             "item 10")


def _batches(ds: CaseDataset, batch_size: int, device: torch.device
             ) -> Iterator[Dict]:
    for batch in iterate_batches(ds, batch_size):
        batch["image_norm"] = intensity_normalize(
            torch.from_numpy(batch["image"]).to(device))
        batch["label"] = torch.from_numpy(batch["label"]).to(device)
        yield batch


def run(cfg: TargetConfig) -> float:
    """Evaluate the Joint checkpoint; returns the mean Dice over cases."""
    _check_supported(cfg)
    device = resolve_device(cfg.device)
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    mask_index = parse_pan_index(cfg.pan_index)
    n_class = len(mask_index)
    patch = tuple(cfg.patch_size)

    print("Building model.")
    model = Joint(n_class=n_class, dim=128, bottleneck=bottleneck_for(patch))
    path = checkpoint_path(cfg.save_root, cfg.load_prefix_joint)
    print(f"Loading checkpoint {path}")
    load_state(model, load_checkpoint(path))
    model.to(device).eval()

    ds = CaseDataset(filedict_from_json(cfg.data_path, cfg.val_list, 1),
                     cfg.val_data_root, mask_index=mask_index,
                     output_size=patch)
    step = make_joint_eval_step(model, n_class)
    print("Start evaluation")
    t0 = time.time()
    dsc, scores = run_eval(_batches(ds, cfg.val_batch, device), step)
    os.makedirs(cfg.display_path, exist_ok=True)
    with open(os.path.join(cfg.display_path, "score_0.json"), "w") as f:
        json.dump({str(k): v for k, v in scores.items()}, f)
    print("Time: {}".format(time.time() - t0))
    print("epoch 1 validation result: %f over %d cases." % (dsc, len(scores)))
    return dsc


def main(argv: Optional[List[str]] = None) -> float:
    return run(parse_target_args(argv))


if __name__ == "__main__":
    main()
