"""The trainers' config dataclasses and argparse adapters (a copy of the
JAX package's core/config.py, reproducing main_source.py:22-95 and
main_target.py:28-82), including the quirks the recipe scripts depend on:

  * data_path is prefixed with 'lists/' (main_source.py:78) so the recipes'
    `--data_path data/Multi_all.json` resolves to lists/data/Multi_all.json;
  * the pan_index mini-DSL (main_source.py:92-95, data/transforms.py);
  * assert save_epoch % eval_epoch == 0 and the turn_epoch divisibility
    guard (main_source.py:89-90);
  * flag-combination asserts of the target trainer (main_target.py:145-170).

The -G/--GPU flag is accepted for recipe compatibility and ignored;
``--device`` picks the device (``cuda`` unless ``cpu`` is asked for).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class CommonConfig:
    prefix: str = ""
    target_phase: str = "arterial"
    gpu: str = "0,1,2,3"
    batch_size: int = 4
    max_epoch: int = 1600
    save_epoch: int = 50
    eval_epoch: int = 50
    turn_epoch: int = -1
    softrelu: int = 0
    method: str = "vae_train"
    data_root: str = "../nih_data/numpy_data/"
    val_data_root: str = "../nih_data/numpy_data/"
    data_path: str = "Multi_all.json"
    train_list: str = "NIH_train"
    val_list: str = "NIH_val"
    load_prefix: Optional[str] = None
    checkpoint_name: str = "best_model.ckpt"
    load_prefix_vae: Optional[str] = None
    load_prefix_joint: Optional[str] = None
    pan_index: str = "1"
    lambda_vae: float = 0.1
    lambda_vae_warmup: int = 0
    lr_seg: float = 1e-2
    lr_vae: float = 0.0
    test_only: bool = False
    resume: bool = False
    save_more_reference: bool = False
    save_eval_result: bool = False
    no_aug: bool = False
    adam: bool = False
    mode: int = 0
    # framework extensions (not in the reference CLI)
    seed: int = 0
    num_workers: int = 8
    spatial_shards: int = 1     # shard the D axis over the mesh 'spatial' axis
    profile_dir: Optional[str] = None
    save_root: str = "3dmodel"
    eval_mode: str = "crop"
    sw_overlap: float = 0.5
    postprocess: bool = False
    postprocess_min_voxels: int = 10000
    debug_nans: bool = False
    device: str = "cuda"

    # reference constant, overridable for small-scale tests (must be a
    # multiple of 32: the VAE trunk has 5 stride-2 stages)
    patch_size: tuple = (128, 128, 128)
    weight_decay: float = 0.0
    val_batch: int = 1
    aug_order: int = 1
    aug_host: bool = False

    def finalize(self) -> "CommonConfig":
        assert self.save_epoch % self.eval_epoch == 0
        assert self.turn_epoch % self.eval_epoch == 0 or self.turn_epoch == -1
        self.patch_size = tuple(self.patch_size)
        assert all(p % 32 == 0 for p in self.patch_size), self.patch_size
        # the 'lists/' join quirk (main_source.py:78)
        if not os.path.isabs(self.data_path) and \
                not self.data_path.startswith("lists" + os.sep):
            self.data_path = os.path.join("lists", self.data_path)
        return self

    @property
    def save_path(self) -> str:
        return os.path.join(self.save_root, self.prefix)

    @property
    def display_path(self) -> str:
        return os.path.join("tensorboard", self.prefix)

    @property
    def middle_path(self) -> str:
        return os.path.join("domain_cache", self.prefix)

    @property
    def result_path(self) -> str:
        return os.path.join("result", self.prefix)

    @property
    def outer_epochs(self) -> int:
        return self.max_epoch // self.eval_epoch


@dataclass
class SourceConfig(CommonConfig):
    """main_source.py surface."""


@dataclass
class TargetConfig(CommonConfig):
    """main_target.py surface (superset)."""

    pseudo_data_root: str = "../nih_data/numpy_data/"
    pseudo_list: Optional[str] = None
    load_prefix_encoder: Optional[str] = None
    pseudo_pan_index: str = "1"
    only_pseudo: bool = False
    fix_layer: bool = False
    use_confident_binarize: bool = False
    analysis_figure_name: Optional[str] = None
    pseudo_save_epoch: int = 0
    domain_loss_type: int = 0
    vae_mont_number: int = 1
    vae_forward_scale: float = 0.0
    vae_decoder_dropout: float = 0.0
    seg_dropout: float = 0.0
    val_finetune: int = 0
    lr_finetune: float = 1e-2
    tag: bool = False
    from_scratch: bool = False
    kl: bool = False
    alpha: float = 0.995
    update_every_iteration: bool = False
    generate_bounding_boxes: bool = False
    shift: int = 0

    def finalize(self) -> "TargetConfig":
        super().finalize()
        # flag-combination guards (main_target.py:145-170)
        if self.vae_mont_number != 1:
            assert self.vae_forward_scale != 0.0
        if self.analysis_figure_name is not None:
            assert self.test_only
        if self.from_scratch:
            assert self.method == "domain_adaptation"
            assert not self.test_only
        if self.kl:
            assert self.method == "domain_adaptation"
            assert self.domain_loss_type in (0, 8)
        if self.update_every_iteration:
            assert self.pseudo_save_epoch == 1
        if self.generate_bounding_boxes:
            assert self.method == "domain_adaptation"
        return self


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("prefix", help="prefix")
    p.add_argument("-P", "--target_phase", default="arterial")
    p.add_argument("-G", "--GPU", dest="gpu", default="0,1,2,3",
                   help="accepted for recipe compat; ignored (see --device)")
    p.add_argument("-b", "--batch_size", type=int, default=4)
    p.add_argument("-E", "--max_epoch", type=int, default=1600)
    p.add_argument("--save_epoch", type=int, default=50)
    p.add_argument("--eval_epoch", type=int, default=50)
    p.add_argument("--turn_epoch", type=int, default=-1)
    p.add_argument("-S", "--softrelu", type=int, default=0)
    p.add_argument("-M", "--method", default="vae_train")
    p.add_argument("-l", "--data_path", default="Multi_all.json")
    p.add_argument("--load_prefix", default=None)
    p.add_argument("--checkpoint_name", default="best_model.ckpt")
    p.add_argument("--load_prefix_vae", default=None)
    p.add_argument("--load_prefix_joint", default=None)
    p.add_argument("--pan_index", default="1")
    p.add_argument("--lambda_vae", type=float, default=0.1)
    p.add_argument("--lambda_vae_warmup", type=int, default=0)
    p.add_argument("--lr_seg", type=float, default=1e-2)
    p.add_argument("--lr_vae", type=float, default=0.0)
    p.add_argument("--test_only", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--save_more_reference", action="store_true")
    p.add_argument("--save_eval_result", action="store_true")
    p.add_argument("--no_aug", action="store_true")
    p.add_argument("--adam", action="store_true")
    p.add_argument("--mode", type=int, default=0)
    # framework extensions
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--spatial_shards", type=int, default=1)
    p.add_argument("--profile_dir", default=None)
    p.add_argument("--patch_size", type=int, nargs=3,
                   default=(128, 128, 128),
                   help="volume crop size (framework extension; "
                        "multiples of 32)")
    p.add_argument("--save_root", default="3dmodel")
    p.add_argument("--eval_mode", choices=("crop", "sliding_window"),
                   default="crop",
                   help="crop: the reference's one-ROI-crop eval; "
                        "sliding_window: full-volume patch inference with "
                        "on-device stitching (framework extension)")
    p.add_argument("--sw_overlap", type=float, default=0.5)
    p.add_argument("--postprocess", action="store_true",
                   help="connected-component filter on sliding-window "
                        "predictions: keep the <=2 largest foreground "
                        "components above --postprocess_min_voxels voxels "
                        "(the reference's full-volume predict_vol rule, "
                        "utils/utils.py:777-796)")
    p.add_argument("--postprocess_min_voxels", type=int, default=10000,
                   help="minimum component size for --postprocess "
                        "(reference constant 10000, utils/utils.py:791; "
                        "overridable for small-volume runs)")
    p.add_argument("--aug_order", type=int, choices=(1, 3), default=1,
                   help="augmentation image interpolation order: 1 = fast "
                        "trilinear (default), 3 = the reference's cubic "
                        "spline, exact on device (framework extension)")
    p.add_argument("--aug_host", action="store_true",
                   help="run the spatial augmentation on the host in the "
                        "loader worker pool (the reference's 16-worker "
                        "architecture, data/host_augment.py) instead of "
                        "inside the device ingest jit; --aug_order picks "
                        "the interpolation in both modes. Recommended with "
                        "--aug_order 3: on-host the cubic warp overlaps "
                        "device compute, on-device it is gather-bound "
                        "(BENCH.md ingest table)")
    p.add_argument("--val_batch", type=int, default=1,
                   help="validation batch size (framework extension; eval "
                        "scores are per-sample so any value is exact)")
    p.add_argument("--debug_nans", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")


def _ns_to_cfg(ns: argparse.Namespace, cls):
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: v for k, v in vars(ns).items() if k in fields}
    return cls(**kwargs).finalize()


def parse_source_args(argv: Optional[List[str]] = None) -> SourceConfig:
    p = argparse.ArgumentParser(prog="main_source")
    _add_common(p)
    p.add_argument("-R", "--data_root", default="../nih_data/numpy_data/")
    p.add_argument("-V", "--val_data_root", default="../nih_data/numpy_data/")
    p.add_argument("-t", "--train_list", default="NIH_train")
    p.add_argument("-v", "--val_list", default="NIH_val")
    return _ns_to_cfg(p.parse_args(argv), SourceConfig)


def parse_target_args(argv: Optional[List[str]] = None) -> TargetConfig:
    p = argparse.ArgumentParser(prog="main_target")
    _add_common(p)
    p.add_argument("--data_root", default="../nih_data/numpy_data/")
    p.add_argument("--val_data_root", default="../nih_data/numpy_data/")
    p.add_argument("--pseudo_data_root", default="../nih_data/numpy_data/")
    p.add_argument("--train_list", default="NIH_train")
    p.add_argument("--val_list", default="NIH_val")
    p.add_argument("--pseudo_list", default=None)
    p.add_argument("--load_prefix_encoder", default=None)
    p.add_argument("--pseudo_pan_index", default="1")
    p.add_argument("--only_pseudo", action="store_true")
    p.add_argument("--fix_layer", action="store_true")
    p.add_argument("--use_confident_binarize", action="store_true")
    p.add_argument("--analysis_figure_name", default=None)
    p.add_argument("--pseudo_save_epoch", type=int, default=0)
    p.add_argument("--domain_loss_type", type=int, default=0)
    p.add_argument("--vae_mont_number", type=int, default=1)
    p.add_argument("--vae_forward_scale", type=float, default=0.0)
    p.add_argument("--vae_decoder_dropout", type=float, default=0.0)
    p.add_argument("--seg_dropout", type=float, default=0.0)
    p.add_argument("--val_finetune", type=int, default=0)
    p.add_argument("--lr_finetune", type=float, default=1e-2)
    p.add_argument("--tag", action="store_true")
    p.add_argument("--from_scratch", action="store_true")
    p.add_argument("--kl", action="store_true")
    p.add_argument("--alpha", type=float, default=0.995)
    p.add_argument("--update_every_iteration", action="store_true")
    p.add_argument("--generate_bounding_boxes", action="store_true")
    p.add_argument("--shift", type=int, default=0)
    return _ns_to_cfg(p.parse_args(argv), TargetConfig)
