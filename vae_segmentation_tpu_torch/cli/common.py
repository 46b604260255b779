"""What the port's two trainers share (counterpart of vae_segmentation_tpu/
cli/common.py): the loaders with the reference's list replication, the
train ingest (the device warp unless --no_aug, then the intensity
normalization; common.py:89-144 of the JAX package), the validation
batches, and the epoch bookkeeping: the score JSON and the best and
periodic checkpoints (main_source.py:806-850, main_target.py:1022-1062).
A checkpoint is a torch ``{'epoch', 'model_state_dict'}`` file
(``core/checkpoint.py``)."""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch

from vae_segmentation_tpu_torch.core.checkpoint import (
    checkpoint_path, load_checkpoint, save_checkpoint)
from vae_segmentation_tpu_torch.core.config import CommonConfig
from vae_segmentation_tpu_torch.data import augment
from vae_segmentation_tpu_torch.data.manifest import filedict_from_json
from vae_segmentation_tpu_torch.data.pipeline import (
    CaseDataset, TrainLoader, intensity_normalize, iterate_batches)
from vae_segmentation_tpu_torch.data.transforms import parse_pan_index


def todo(what: str, item: str) -> None:
    """Refuse a flag or method a later slice of the port brings."""
    raise NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md queue 1, {item}")


def n_classes(cfg: CommonConfig) -> int:
    return len(parse_pan_index(cfg.pan_index))


def bottleneck_for(patch_size, top_fmaps: int = 256) -> int:
    """Flattened VAE bottleneck width: fmaps[-1] * prod(patch / 32)
    (16384 at the reference's 128^3, joint_model.py:222)."""
    n = top_fmaps
    for p in patch_size:
        n *= p // 32
    return n


def build_train_loader(cfg: CommonConfig, *, data_root: str,
                       list_key: str) -> TrainLoader:
    """The train loader with the reference's list replication: the file
    list repeated eval_epoch times, so one pass is eval_epoch dataset epochs
    (main_source.py:123-131, 186)."""
    ds = CaseDataset(
        filedict_from_json(cfg.data_path, list_key, cfg.eval_epoch),
        data_root, mask_index=parse_pan_index(cfg.pan_index),
        output_size=cfg.patch_size, shift=getattr(cfg, "shift", 0))
    return TrainLoader(ds, cfg.batch_size, seed=cfg.seed,
                       num_workers=cfg.num_workers)


def build_val_dataset(cfg: CommonConfig, *, data_root: str,
                      list_key: str) -> CaseDataset:
    return CaseDataset(filedict_from_json(cfg.data_path, list_key, 1),
                       data_root, mask_index=parse_pan_index(cfg.pan_index),
                       output_size=cfg.patch_size)


def val_batches(ds: CaseDataset, batch_size: int, device: torch.device
                ) -> Iterator[Dict]:
    """In-order validation batches with 'image_norm' and 'label' on
    `device`."""
    for batch in iterate_batches(ds, batch_size):
        batch["image_norm"] = intensity_normalize(
            torch.from_numpy(batch["image"]).to(device))
        batch["label"] = torch.from_numpy(batch["label"]).to(device)
        yield batch


def make_train_ingest(cfg: CommonConfig, device: torch.device) -> Callable:
    """(host batch, generator) -> (image_norm [B, *patch], label [B, *patch])
    on `device`: the random affine warp drawn from `generator` (on
    `device`) unless --no_aug, then Clip(-200, 400) and (x - 100) / 300
    (main_source.py:197-213). The other warps' flags are refused, even
    where --no_aug makes them moot."""
    if cfg.aug_order != 1:
        todo("--aug_order 3 (the cubic spline warp)", "item 3")
    if cfg.aug_host:
        todo("--aug_host (the warp in the loader's workers)", "item 3")
    patch = tuple(cfg.patch_size)

    def ingest(batch: Dict[str, np.ndarray], generator: torch.Generator
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        image = torch.from_numpy(batch["image"]).to(device)
        label = torch.from_numpy(batch["label"]).to(device)
        if not cfg.no_aug:
            image, label = augment.spatial_augment(image, label, generator,
                                                   patch_size=patch)
        return intensity_normalize(image), label

    return ingest


def skip_epoch(loader: TrainLoader) -> None:
    """The reference's epoch-0 skip (main_source.py:416, main_target.py:506):
    no step, but the shuffle advances as a full pass would."""
    loader.batch_indices()


def load(cfg: CommonConfig, prefix: str, name: str = "best_model.ckpt"
         ) -> Dict:
    path = checkpoint_path(cfg.save_root, prefix, name)
    print(f"Loading checkpoint {path}")
    return load_checkpoint(path)


class EpochRunner:
    """Score, best and periodic checkpoint bookkeeping after every outer
    epoch (common.py:195-237 of the JAX package)."""

    def __init__(self, cfg: CommonConfig):
        self.cfg = cfg
        self.best_result = 0.0
        os.makedirs(cfg.save_path, exist_ok=True)
        os.makedirs(cfg.display_path, exist_ok=True)

    def dump_scores(self, epoch: int, scores: Dict[int, float]) -> None:
        with open(os.path.join(self.cfg.display_path,
                               f"score_{epoch}.json"), "w") as f:
            json.dump({str(k): v for k, v in scores.items()}, f)

    def end_of_epoch(self, epoch: int, dsc: float,
                     model: torch.nn.Module) -> bool:
        """Best checkpoint when the mean Dice improved, the periodic one
        every save_epoch; returns whether it improved."""
        cfg = self.cfg
        print("epoch %d validation result: %f, best result %f."
              % (epoch + 1, dsc, self.best_result))
        improved = dsc > self.best_result and not cfg.test_only
        stamp = (epoch + 1) * cfg.eval_epoch
        if improved:
            self.best_result = dsc
            save_checkpoint(os.path.join(cfg.save_path, "best_model.ckpt"),
                            epoch=stamp, model=model)
        if not cfg.test_only and \
                (epoch + 1) % (cfg.save_epoch // cfg.eval_epoch) == 0:
            print("saving model")
            save_checkpoint(os.path.join(cfg.save_path,
                                         f"model_epoch{stamp}.ckpt"),
                            epoch=stamp, model=model)
        return improved
