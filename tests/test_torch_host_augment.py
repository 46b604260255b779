"""``--aug_host`` in the port: its copy of the host warp
(vae_segmentation_tpu_torch/data/host_augment.py) against the JAX
package's (numpy + scipy in both: equal bit for bit), ``AugmentedDataset``
against the JAX package's and across loader worker counts, and the CLI
wiring (the loader warps, the ingest only normalises, a seg_train run)."""

import json
import os

import numpy as np
import pytest
import torch

from vae_segmentation_tpu.data import host_augment as jhost
from vae_segmentation_tpu.data.pipeline import AugmentedDataset as JAug
from vae_segmentation_tpu_torch.cli import common, source_main
from vae_segmentation_tpu_torch.core.config import SourceConfig
from vae_segmentation_tpu_torch.data import host_augment as phost
from vae_segmentation_tpu_torch.data.pipeline import (
    AugmentedDataset, TrainLoader, intensity_normalize)
from vae_segmentation_tpu_torch.data.synthetic import write_synthetic_dataset

torch.set_num_threads(2)

PATCH = (24, 20, 28)


class _Base:
    """Cases of a non-cubic shape, an ellipsoid label each."""

    def __init__(self, n=5, shape=(30, 26, 34)):
        self.n, self.shape = n, shape

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        r = np.random.default_rng(idx)
        img = (r.normal(size=self.shape) * 300 + 40).astype(np.float32)
        z, y, x = np.indices(self.shape)
        lab = (((z - 15) / 9.0) ** 2 + ((y - 13) / 7.0) ** 2
               + ((x - 17) / 10.0) ** 2 <= 1).astype(np.float32)
        return {"image": img, "label": lab, "ori_shape": self.shape,
                "id": f"c{idx}", "index": idx}


@pytest.mark.parametrize("order", [1, 3])
def test_host_warp_equals_jax_bit_for_bit(order):
    base = _Base()
    for idx in range(3):
        item = base[idx]
        for seed in (0, 11):
            p = phost.augment_spatial_host(
                item["image"], item["label"],
                np.random.default_rng((seed, idx)), PATCH, order=order)
            j = jhost.augment_spatial_host(
                item["image"], item["label"],
                np.random.default_rng((seed, idx)), PATCH, order=order)
            for a, b in zip(p, j):
                assert a.dtype == np.float32 and a.shape == PATCH
                np.testing.assert_array_equal(a, b)
        draw = phost.draw_params(np.random.default_rng(idx), base.shape,
                                 PATCH)
        img, lab = phost.apply_warp(item["image"], item["label"], *draw,
                                    PATCH, order)
        jimg, jlab = jhost.apply_warp(item["image"], item["label"], *draw,
                                      PATCH, order)
        np.testing.assert_array_equal(img, jimg)
        np.testing.assert_array_equal(lab, jlab)


@pytest.mark.parametrize("workers", [0, 3])
def test_augmented_dataset_draws_alike_for_any_worker_count(workers):
    """The same batches under 0 and 3 loader threads, each item as the JAX
    package's AugmentedDataset warps it."""
    ds = AugmentedDataset(_Base(6), PATCH, order=3, seed=9)
    want = JAug(_Base(6), PATCH, order=3, seed=9)
    got = list(TrainLoader(ds, 2, seed=1, num_workers=workers))
    ref = list(TrainLoader(ds, 2, seed=1, num_workers=0))
    assert len(got) == 3
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["image"], r["image"])
        np.testing.assert_array_equal(g["label"], r["label"])
        for j, idx in enumerate(g["index"]):
            item = want[int(idx)]
            np.testing.assert_array_equal(g["image"][j], item["image"])
            np.testing.assert_array_equal(g["label"][j], item["label"])


def _cfg(root, **kw):
    cfg = SourceConfig(prefix="h", method="seg_train", patch_size=(32,) * 3,
                       data_root=str(root / "data"), batch_size=2,
                       data_path=str(root / "data" / "Multi_all.json"),
                       device="cpu", num_workers=0, **kw)
    return cfg.finalize()


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("host_aug")
    write_synthetic_dataset(str(root / "data"), n_train=4, n_val=1, size=36,
                            seed=1)
    old = os.getcwd()
    os.chdir(root)
    yield root
    os.chdir(old)


def test_loader_warps_and_the_ingest_only_normalises(workdir):
    cfg = _cfg(workdir, aug_host=True, aug_order=3)
    loader = common.build_train_loader(cfg, data_root=cfg.data_root,
                                       list_key="NIH_train")
    assert isinstance(loader.dataset, AugmentedDataset)
    assert (loader.dataset.order, loader.dataset.seed) == (3, cfg.seed)
    salted = common.build_train_loader(cfg, data_root=cfg.data_root,
                                       list_key="NIH_train", seed_salt=101)
    assert salted.dataset.seed == cfg.seed + 101
    batch = next(iter(loader))
    ingest = common.make_train_ingest(cfg, torch.device("cpu"))
    img, lab = ingest(batch, torch.Generator().manual_seed(0))
    assert torch.equal(img, intensity_normalize(
        torch.from_numpy(batch["image"])))
    assert torch.equal(lab, torch.from_numpy(batch["label"]))
    plain = common.build_train_loader(_cfg(workdir, aug_host=True,
                                           no_aug=True),
                                      data_root=cfg.data_root,
                                      list_key="NIH_train")
    assert not isinstance(plain.dataset, AugmentedDataset)


def test_seg_train_cli_with_aug_host(workdir):
    argv = ["sh", "--method", "seg_train", "--train_list", "NIH_train",
            "--val_list", "NIH_val", "--data_root", str(workdir / "data"),
            "--val_data_root", str(workdir / "data"),
            "--data_path", str(workdir / "data" / "Multi_all.json"),
            "--patch_size", "32", "32", "32", "-b", "2", "--eval_epoch", "1",
            "--save_epoch", "1", "--max_epoch", "2", "--num_workers", "2",
            "--aug_host", "--device", "cpu"]
    best = source_main.main(argv)
    with open("tensorboard/sh/score_1.json") as f:
        scores = json.load(f)
    assert len(scores) == 1 and 0.0 <= best <= 1.0
    assert os.path.exists("3dmodel/sh/model_epoch2.ckpt")
