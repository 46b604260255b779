"""What the port's two trainers share (counterpart of vae_segmentation_tpu/
cli/common.py): the loaders with the reference's list replication (the
host warp of --aug_host in their workers), the train ingest (the device
warp at --aug_order unless --no_aug or --aug_host, then the intensity
normalization; common.py:89-144 of the JAX package), the validation
batches, the epoch bookkeeping (the score JSON and the best and periodic
checkpoints, main_source.py:806-850, main_target.py:1022-1062) and
--resume (``resume``). A checkpoint holds the JAX package's payload
(``core/checkpoint.py``), and either package's file loads.
``run_sliding_window_eval`` is the full-volume eval of both trainers
(common.py:321-385 of the JAX package).

Under ``torchrun`` (``start``) both trainers run as a world of ranks laid
out as the JAX package's mesh (``parallel/sharding.py::
make_mesh_if_multichip``): every rank loads the same global batch and
takes its slice (``make_train_ingest``, ``shard_train_batch``), the steps
run under the mesh, and the eval, ft1 and the sliding window run on rank 0
as in one process while the other ranks wait for its result
(``share``); rank 0 alone prints and writes scores and checkpoints
(``EpochRunner``'s ``writes``). Without ``torchrun`` nothing changes.

Observability (common.py:204, 383-395 of the JAX package): the runner's
TensorBoard ``saver`` (``obs/saver.py``; a saver that does nothing on a
rank that does not write), ``save_eval_npys`` (--save_eval_result),
``profile`` (--profile_dir) and, under --debug_nans, ``nan_guard`` and
``check_scores``: the port's counterpart of ``jax_debug_nans``, a run that
stops with FloatingPointError at the first loss term or score that is not
finite."""

from __future__ import annotations

import contextlib
import json
import math
import os
import sys
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from vae_segmentation_tpu_torch.core.checkpoint import (
    checkpoint_path, latest_checkpoint, load_checkpoint, save_checkpoint)
from vae_segmentation_tpu_torch.core.config import CommonConfig
from vae_segmentation_tpu_torch.core.device import resolve_device
from vae_segmentation_tpu_torch.data import augment
from vae_segmentation_tpu_torch.data.manifest import filedict_from_json
from vae_segmentation_tpu_torch.data.pipeline import (
    AugmentedDataset, CaseDataset, FullVolumeDataset, TrainLoader,
    intensity_normalize, iterate_batches)
from vae_segmentation_tpu_torch.data.transforms import parse_pan_index
from vae_segmentation_tpu_torch.eval.evaluate import mean_score
from vae_segmentation_tpu_torch.eval.postprocess import largest_components
from vae_segmentation_tpu_torch.eval.sliding_window import (
    sliding_window_predict)
from vae_segmentation_tpu_torch.models import load_state
from vae_segmentation_tpu_torch.obs.saver import NullSaver, Saver, to_numpy
from vae_segmentation_tpu_torch.obs.timing import profile_trace
from vae_segmentation_tpu_torch.ops import losses as L
from vae_segmentation_tpu_torch.train.steps import checking_terms
from vae_segmentation_tpu_torch.parallel import launch, sharding
from vae_segmentation_tpu_torch.parallel.sharding import Mesh


def start(cfg: CommonConfig):
    """(world, mesh, device) of the run: torchrun's world
    (``launch.init_distributed``) and its mesh, or (None, None, the
    device) in one process. A rank outside the mesh says so and gets
    device None: it does no work."""
    world = launch.init_distributed(cfg.device)
    if world is None:
        if cfg.spatial_shards > 1:
            raise ValueError(
                f"--spatial_shards {cfg.spatial_shards} splits the volume "
                f"over {cfg.spatial_shards} ranks: run the CLI under "
                "torchrun --nproc_per_node N (N >= --spatial_shards)")
        return None, None, resolve_device(cfg.device)
    mesh = sharding.make_mesh_if_multichip(cfg, world.size)
    if not (mesh.member if mesh is not None else world.rank == 0):
        grid = "1 x 1" if mesh is None else \
            f"{mesh.n_data} x {mesh.n_spatial}"
        print(f"rank {world.rank} of {world.size}: outside the mesh "
              f"({grid}); no work", file=sys.stderr)
        return world, mesh, None
    return world, mesh, world.device


def writes(mesh: Optional[Mesh]) -> bool:
    """Whether this rank prints and writes: one process, or rank 0."""
    return mesh is None or mesh.first_rank


@contextlib.contextmanager
def rank_stdout():
    """Within: stdout of a rank other than 0 of torchrun's world goes
    nowhere (rank 0 prints the run's lines once)."""
    if int(os.environ.get("RANK", "0")) == 0:
        yield
        return
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        yield


def share(mesh: Optional[Mesh], value):
    """Rank 0's `value` on every rank of the mesh (the others wait here
    while rank 0 evaluates)."""
    if mesh is None or mesh.size == 1:
        return value
    import torch.distributed as dist

    box = [value]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]


def stop(world) -> None:
    """Tear down a world this process started."""
    if world is not None and world.owned:
        import torch.distributed as dist

        dist.destroy_process_group()


@contextlib.contextmanager
def profile(cfg: CommonConfig):
    """--profile_dir: the whole run under ``torch.profiler``, its Chrome
    trace written there (``obs/timing.py::profile_trace``)."""
    with profile_trace(cfg.profile_dir):
        yield


@contextlib.contextmanager
def nan_guard(cfg: CommonConfig, where: str):
    """--debug_nans around a step: autograd's anomaly mode, and each of the
    step's scalar loss terms checked before its backward; the first that is
    not finite raises FloatingPointError naming it and `where` (the epoch
    and iteration). Without the flag: nothing, and no host sync."""
    if not cfg.debug_nans:
        yield
        return

    def check(terms: Dict[str, torch.Tensor]) -> None:
        for name, value in terms.items():
            if not bool(torch.isfinite(value).all()):
                raise FloatingPointError(
                    f"--debug_nans: loss term {name} = "
                    f"{float(value.detach())} at "
                    f"{where}")

    with torch.autograd.set_detect_anomaly(True), checking_terms(check):
        yield


def check_scores(cfg: CommonConfig, scores: Dict[int, float], where: str,
                 name: str = "score") -> None:
    """--debug_nans: FloatingPointError at the first eval score that is not
    finite."""
    if not cfg.debug_nans:
        return
    for idx, v in scores.items():
        if not math.isfinite(v):
            raise FloatingPointError(
                f"--debug_nans: {name} of case {idx} = {v} at {where}")


def iterations_per_epoch(cfg: CommonConfig) -> int:
    """Batches of one outer epoch's train pass (the train loader's length,
    the list replicated eval_epoch times; 0 without the list): the
    iteration count of the saver's steps, known without a loader under
    --test_only as in the JAX package."""
    return len(filedict_from_json(cfg.data_path, cfg.train_list,
                                  cfg.eval_epoch)) // cfg.batch_size


def save_eval_npys(result_path: str, epoch: int, val_idx: int,
                   pred_bin: np.ndarray, image: np.ndarray,
                   gt_bin: np.ndarray) -> None:
    """--save_eval_result npy dumps (main_target.py:922-936; common.py:
    383-395 of the JAX package): <epoch>_<idx>_pred.join.npy, _pic.npy and
    _gt.npy in the reference's channel-first layout, from a [1, D, H, W, C]
    binarized prediction, the [1, D, H, W] normalized image and the
    [1, D, H, W, C] one-hot label."""
    os.makedirs(result_path, exist_ok=True)
    np.save(os.path.join(result_path, f"{epoch}_{val_idx}_pred.join"),
            np.moveaxis(pred_bin, -1, 1))
    np.save(os.path.join(result_path, f"{epoch}_{val_idx}_pic"),
            image[:, None])
    np.save(os.path.join(result_path, f"{epoch}_{val_idx}_gt"),
            np.moveaxis(gt_bin, -1, 1))


def dump_eval_batch(cfg: CommonConfig, epoch: int, index, pred: torch.Tensor,
                    image: torch.Tensor, label: torch.Tensor,
                    n_class: int) -> None:
    """``save_eval_npys`` for each case of an eval batch: the binarized
    prediction, the normalized image and the one-hot label, f32."""
    pred_b = to_numpy(L.binarize(pred))
    img_b = to_numpy(image)
    gt_b = to_numpy(L.one_hot_label(label, n_class))
    for j, vi in enumerate(np.asarray(index)):
        save_eval_npys(cfg.result_path, epoch, int(vi), pred_b[j:j + 1],
                       img_b[j:j + 1], gt_b[j:j + 1])


def panel_sample(index, epoch: int, n_cases: int) -> Optional[int]:
    """The batch position of the case the val panel shows this epoch
    (case epoch % n_cases, the reference's batch-1 cycle), or None when
    the batch does not hold it."""
    pj = np.flatnonzero(np.asarray(index) == epoch % max(n_cases, 1))
    return int(pj[0]) if pj.size else None


def load_joint(cfg: CommonConfig, model: torch.nn.Module) -> torch.nn.Module:
    """--load_prefix_joint: a whole Joint checkpoint into `model`
    (common.py:186 of the JAX package)."""
    return load_state(model, load(cfg, cfg.load_prefix_joint))


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
                       list_key: str, pan_index: Optional[str] = None,
                       seed_salt: int = 0) -> TrainLoader:
    """The train loader with the reference's list replication: the file
    list repeated eval_epoch times, so one pass is eval_epoch dataset epochs
    (main_source.py:123-131, 186). With --aug_host (and not --no_aug) its
    workers warp each item (``AugmentedDataset`` at --aug_order). The
    shuffle and the host warp draw from seed + seed_salt (the replay
    loader's salt is 101, as in the JAX package)."""
    ds = CaseDataset(
        filedict_from_json(cfg.data_path, list_key, cfg.eval_epoch),
        data_root, mask_index=parse_pan_index(pan_index or cfg.pan_index),
        output_size=cfg.patch_size, shift=getattr(cfg, "shift", 0))
    if cfg.aug_host and not cfg.no_aug:
        ds = AugmentedDataset(ds, cfg.patch_size, order=cfg.aug_order,
                              seed=cfg.seed + seed_salt)
    return TrainLoader(ds, cfg.batch_size, seed=cfg.seed + seed_salt,
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


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def sweep_volume(image: np.ndarray, patch, device: torch.device
                 ) -> torch.Tensor:
    """A case's image as the sliding-window eval sweeps it: padded with
    -1024 up to a multiple of 64 an axis, at least the patch (the JAX
    package pads so for its compile cache; the padding moves the window
    grid, so the port keeps it), then normalised on `device`."""
    img = image.astype(np.float32)
    padded = [_round_up(max(s, p), 64) for s, p in zip(img.shape, patch)]
    img = np.pad(img, [(0, t - s) for s, t in zip(img.shape, padded)],
                 constant_values=-1024.0)
    return intensity_normalize(torch.from_numpy(img).to(device))


def volume_dice(pred: torch.Tensor, label: np.ndarray, n_class: int
                ) -> float:
    """avg_dsc over classes [1, n_class) of the one-hot class map `pred`
    [D, H, W] against the one-hot label."""
    classes = torch.arange(n_class, device=pred.device)
    onehot_pred = (pred[..., None] == classes).float()[None]
    onehot_gt = L.one_hot_label(torch.from_numpy(label).to(pred.device),
                                n_class, dtype=torch.float32)[None]
    return float(L.avg_dsc(onehot_pred, onehot_gt, botindex=1,
                           topindex=n_class))


def run_sliding_window_eval(
        cfg: CommonConfig,
        seg_fn: Callable[[torch.nn.Module, torch.Tensor], torch.Tensor],
        model: torch.nn.Module, *, n_class: int, data_root: str,
        list_key: str, pan_index: str,
        model_for_case: Optional[Callable[[Dict], torch.nn.Module]] = None
        ) -> Tuple[float, Dict[int, float]]:
    """Full-volume sliding-window eval (common.py:321-385 of the JAX
    package): (mean Dice, {case index: Dice}), keyed as the crop path keys
    its scores.

    Each uncropped case (``sweep_volume``) is swept by
    ``sliding_window_predict`` on the model's device with
    ``seg_fn(model, images)`` at batch min(-b, 4) and --sw_overlap, cropped
    back and argmaxed; with --postprocess the host keeps the largest
    components (``largest_components``, --postprocess_min_voxels); the
    class map is scored by ``volume_dice``. ``model_for_case(case)`` gives
    a case its own model: the ft1 hook (the JAX package's
    ``params_for_case``)."""
    ds = FullVolumeDataset(filedict_from_json(cfg.data_path, list_key, 1),
                           data_root, parse_pan_index(pan_index))
    device = next(model.parameters()).device
    patch = tuple(cfg.patch_size)
    scores: Dict[int, float] = {}
    for idx in range(len(ds)):
        case = ds[idx]
        net = model if model_for_case is None else model_for_case(case)
        d, h, w = case["image"].shape
        probs = sliding_window_predict(
            lambda x: seg_fn(net, x),
            sweep_volume(case["image"], patch, device), patch=patch,
            overlap=cfg.sw_overlap, batch=min(cfg.batch_size, 4),
            n_class=n_class)
        pred = torch.argmax(probs[:d, :h, :w], dim=-1)
        if getattr(cfg, "postprocess", False):
            # the reference's predict_vol rule (utils/utils.py:777-796):
            # keep the <= 2 largest foreground components above the voxel
            # floor, on the host
            pred_np = pred.cpu().numpy()
            keep = largest_components(pred_np > 0,
                                      min_voxels=cfg.postprocess_min_voxels)
            pred = torch.from_numpy(pred_np * keep).to(device)
        scores[int(case["index"])] = volume_dice(pred, case["label"],
                                                 n_class)
    return mean_score(scores), scores


def shard_train_batch(mesh: Optional[Mesh], image: torch.Tensor,
                      label: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's slice of a global train batch (common.py:284-290 of the
    JAX package): its items and, over 'spatial', its D planes."""
    if mesh is None:
        return image, label
    return sharding.batch_shard(mesh, image), sharding.batch_shard(mesh,
                                                                   label)


def make_train_ingest(cfg: CommonConfig, device: torch.device,
                      mesh: Optional[Mesh] = None) -> Callable:
    """(host batch, generator) -> (image_norm [B, *patch], label [B, *patch])
    on `device`: the random affine warp drawn from `generator` (on
    `device`; the image at --aug_order, 1 trilinear or 3 the cubic spline)
    unless --no_aug, then Clip(-200, 400) and (x - 100) / 300
    (main_source.py:197-213). With --aug_host the loader's workers have
    warped the batch already, so it only normalises (common.py:128-142 of
    the JAX package). Under a mesh every rank holds the same global batch
    (one loader, one seed) and the same generator: the warp is drawn for
    the whole batch, each rank warps its items whole and keeps its slice,
    so the items and the draws are one process's."""
    patch = tuple(cfg.patch_size)
    no_aug = cfg.no_aug or cfg.aug_host

    def ingest(batch: Dict[str, np.ndarray], generator: torch.Generator
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        image = torch.from_numpy(batch["image"]).to(device)
        label = torch.from_numpy(batch["label"]).to(device)
        if no_aug:
            image, label = shard_train_batch(mesh, image, label)
        elif mesh is None:
            image, label = augment.spatial_augment(
                image, label, generator, patch_size=patch,
                order=cfg.aug_order)
        else:
            n = image.shape[0] // mesh.n_data
            image, label = augment.spatial_augment(
                image, label, generator, patch_size=patch,
                order=cfg.aug_order,
                items=slice(mesh.data_index * n, (mesh.data_index + 1) * n))
            if mesh.n_spatial > 1:
                image = sharding.take_planes(mesh, image)
                label = sharding.take_planes(mesh, label)
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


def resume(cfg: CommonConfig, runner: "EpochRunner",
           load_params: Callable[[Dict], None]) -> int:
    """--resume (cli/source_main.py:169-182, cli/target_main.py:226-239 of
    the JAX package; the reference parses the flag and ignores it): from
    the latest ``model_epoch<N>.ckpt`` under --save_root/<prefix>, of
    either package, ``load_params(ck)`` restores the params and
    ``runner.best_result`` the best mean Dice ('extra', default 0.0).
    Returns the outer epoch to start from, ``ck['epoch'] // eval_epoch``;
    0 without --resume or without a checkpoint (a fresh start). As in the
    JAX package the optimizer starts afresh (its saved state is not
    restored) and the random streams restart from --seed."""
    if not cfg.resume:
        return 0
    latest = latest_checkpoint(cfg.save_root, cfg.prefix)
    if latest is None:
        return 0
    ck = load_checkpoint(latest)
    load_params(ck)
    runner.best_result = float(ck.get("extra", {}).get("best_result", 0.0))
    print(f"Resumed from {latest} at epoch {ck['epoch']} "
          f"(best {runner.best_result:.4f})")
    return ck["epoch"] // cfg.eval_epoch


class EpochRunner:
    """Score, best and periodic checkpoint bookkeeping after every outer
    epoch, and the TensorBoard ``saver`` of the run (common.py:195-237 of
    the JAX package). With writes=False (a rank of a world other than 0)
    it keeps the best result and writes nothing: its saver does nothing."""

    def __init__(self, cfg: CommonConfig, writes: bool = True):
        self.cfg = cfg
        self.best_result = 0.0
        self.writes = writes
        self.saver = NullSaver()
        if writes:
            os.makedirs(cfg.save_path, exist_ok=True)
            os.makedirs(cfg.display_path, exist_ok=True)
            self.saver = Saver(cfg.display_path, display_freq=10)

    def dump_scores(self, epoch: int, scores: Dict[int, float],
                    name: str = "score") -> None:
        """tensorboard/<prefix>/<name>_<epoch>.json: {case index: Dice}
        (``score_noft`` holds ft1's scores without the finetune)."""
        if not self.writes:
            return
        with open(os.path.join(self.cfg.display_path,
                               f"{name}_{epoch}.json"), "w") as f:
            json.dump({str(k): v for k, v in scores.items()}, f)

    def end_of_epoch(self, epoch: int, dsc: float, model: torch.nn.Module,
                     optimizer: Optional[torch.optim.Optimizer] = None
                     ) -> bool:
        """Best checkpoint when the mean Dice improved, the periodic one
        every save_epoch, each with the optimizer's state and
        extra={'best_result'} (common.py:212-236 of the JAX package);
        returns whether it improved."""
        cfg = self.cfg
        print("epoch %d validation result: %f, best result %f."
              % (epoch + 1, dsc, self.best_result))
        improved = dsc > self.best_result and not cfg.test_only
        stamp = (epoch + 1) * cfg.eval_epoch
        if improved:
            self.best_result = dsc
        kw = dict(epoch=stamp, model=model, optimizer=optimizer,
                  extra={"best_result": self.best_result})
        if not self.writes:
            return improved
        if improved:
            save_checkpoint(os.path.join(cfg.save_path, "best_model.ckpt"),
                            **kw)
        if not cfg.test_only and \
                (epoch + 1) % (cfg.save_epoch // cfg.eval_epoch) == 0:
            print("saving model")
            save_checkpoint(os.path.join(cfg.save_path,
                                         f"model_epoch{stamp}.ckpt"), **kw)
        return improved
