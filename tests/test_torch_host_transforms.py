"""The port's host transform library
(vae_segmentation_tpu_torch/data/host_transforms.py) against the JAX
package's (data/host_transforms.py) on the same seeded dicts and files:
each transform and loader alone, the reference chain of
tests/test_inventory.py:65-147, and ``image_resize`` (the port's native
resize against the JAX package's scipy path, within the rules of
tests/test_native_loader.py)."""

import random
import sys
import types

import numpy as np
import pytest
import torch

from vae_segmentation_tpu.data import host_transforms as J
from vae_segmentation_tpu_torch.data import host_transforms as P

torch.set_num_threads(2)


def _same(a, b):
    """Equal dicts: the same keys, arrays equal in dtype, shape and bits."""
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


def _dict(rng):
    return {"venous": rng.normal(size=(12, 9, 14)).astype(np.float32) * 300,
            "venous_pancreas": (rng.random((12, 9, 14)) > 0.7)
            .astype(np.float32),
            "venous_lung": (rng.random((12, 9, 14)) > 0.5)
            .astype(np.float32),
            "id": "0007"}


TRANSFORMS = {
    "copy_field": lambda M: M.CopyField(fields=["venous"],
                                        to_field="venous_origin"),
    "pad": lambda M: M.PadToSize(fields=["venous"], size=(16, 16, 16),
                                 pad_val=-1024, seg_pad_val=2,
                                 load_mask=True),
    "crop_random": lambda M: M.PadToSize(fields=["venous"], size=(8, 6, 10),
                                         load_mask=True),
    "crop_max_corner": lambda M: M.PadToSize(fields=["venous"],
                                             size=(8, 6, 10),
                                             random_subpadding=False),
    "pad_and_crop": lambda M: M.PadToSize(fields=["venous"],
                                          size=(16, 6, 14), load_mask=True),
    "reshape_default": lambda M: M.Reshape(fields=["venous",
                                                   "venous_pancreas"]),
    "reshape_view": lambda M: M.Reshape(fields=["venous"],
                                        reshape_view=[3, 4, 9, 14]),
    "extend": lambda M: M.ExtendSqueeze(fields=["venous"], dimension=0,
                                        mode=1),
    "squeeze": lambda M: M.Compose([
        M.ExtendSqueeze(fields=["venous"], dimension=-1, mode=1),
        M.ExtendSqueeze(fields=["venous"], dimension=-1, mode=0)]),
    "clip": lambda M: M.Clip(fields=["venous", "missing"], new_min=-200,
                             new_max=400),
    "center": lambda M: M.CenterIntensities(fields=["venous"],
                                            subtrahend=100, divisor=300),
    "binarize": lambda M: M.Binarize(fields=["venous_pancreas", "venous"],
                                     threshold=0.25),
    "base": lambda M: M.BaseTransform(fields=["venous"]),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(rng, name):
    src = _dict(rng)
    outs = []
    for M in (P, J):
        random.seed(3)
        d = {k: (v.copy() if isinstance(v, np.ndarray) else v)
             for k, v in src.items()}
        outs.append(TRANSFORMS[name](M)(d))
    _same(*outs)


def _merge_case(tmp_path, rng, channels=2):
    img = rng.normal(size=(20, 18, 22)) * 300
    lab = rng.choice([0, 1, 2, 5], (20, 18, 22))
    chans = [img, lab] + [rng.random((20, 18, 22)) > 0.5] * (channels - 2)
    case = tmp_path / "case0001"
    case.mkdir()
    np.save(case / "merge.npy", np.stack(chans, -1).astype(np.int16))
    pred = rng.random((20, 18, 22)).astype(np.float32)
    np.save(tmp_path / "0001_pred.npy", pred)
    return "case0001/merge.npy"


@pytest.mark.parametrize("kw", [
    dict(load_mask=True, mask_index=[[0, 0], [1, 1], [[2, 5], 2]]),
    dict(load_mask=True),
    dict(load_mask=True, load_pred=True, load_pseudo=True,
         mask_index=[[0, 0], [1, 1]], dtype=np.float64),
], ids=["remap", "raw", "pred_pseudo"])
def test_numpy_loader_multi_merge_matches_jax(tmp_path, rng, kw):
    entry = _merge_case(tmp_path, rng, channels=3)
    outs = [M.NumpyLoaderMultiMerge(fields=["venous", "arterial"],
                                    root_dir=str(tmp_path),
                                    middle_path=str(tmp_path), **kw)(entry)
            for M in (P, J)]
    _same(*outs)
    assert outs[0]["id"] == "0001"


def test_npy_loaders_match_jax(tmp_path, rng):
    img = rng.normal(size=(8, 7, 6)).astype(np.float32)
    lab = (rng.random((8, 7, 6)) > 0.5).astype(np.float32)
    (tmp_path / "case0003").mkdir()
    np.save(tmp_path / "case0003" / "img.npy", img)
    np.save(tmp_path / "case0003" / "label.npy", lab)
    np.save(tmp_path / "lab.npy", lab)
    for make in (
            lambda M: M.NumpyLoader(fields=["venous"], root_dir=str(tmp_path),
                                    load_mask=True)("case0003/merge.npy"),
            lambda M: M.NumpyLoaderMulti(
                fields=["venous"], root_dir=str(tmp_path), load_mask=True,
                load_pred=True)({"venous": "case0003/img.npy",
                                 "venous_pancreas": "lab.npy",
                                 "venous_pancreas_pred": ""}),
            lambda M: M.NumpyLoaderMulti(fields=["venous"],
                                         root_dir=str(tmp_path))({"o": 1}),
            lambda M: M.ReadNPY(fields=["venous", "other"], dtype=np.float64)(
                {"venous": str(tmp_path / "lab.npy"), "other": 3})):
        _same(make(P), make(J))


def test_nii_loader_matches_jax(tmp_path, rng, monkeypatch):
    """NiiLoader with a stand-in for nibabel (not installed): nib.load of an
    npz holding 'data' and 'affine'."""
    fake = types.ModuleType("nibabel")

    def load(path):
        z = np.load(path)
        return types.SimpleNamespace(dataobj=z["data"], affine=z["affine"])

    fake.load = load
    monkeypatch.setitem(sys.modules, "nibabel", fake)
    for name in ("a.nii.gz", "b.nii.gz"):
        with open(tmp_path / name, "wb") as f:
            np.savez(f, data=rng.normal(size=(6, 5, 4)).astype(np.float32),
                     affine=np.diag([-0.7, 0.7, 2.5, 1.0]))
    for entry in ("a.nii.gz", {"venous": "a.nii.gz",
                               "venous_label": "b.nii.gz"}):
        outs = [M.NiiLoader(fields=["venous"], root_dir=str(tmp_path),
                            load_mask=True)(entry) for M in (P, J)]
        _same(*outs)


def test_reference_chain_matches_jax(tmp_path, rng):
    img = rng.normal(size=(20, 20, 20)).astype(np.float32) * 300
    lab = (rng.random((20, 20, 20)) > 0.8).astype(np.int16)
    (tmp_path / "case0001").mkdir()
    np.save(tmp_path / "case0001" / "merge.npy",
            np.stack([img, lab], -1).astype(np.int16))

    def chain(M):
        return M.Compose([
            M.NumpyLoaderMultiMerge(fields=["venous"], root_dir=str(tmp_path),
                                    load_mask=True,
                                    mask_index=[[0, 0], [1, 1]]),
            M.CopyField(fields=["venous"], to_field=["venous_origin"]),
            M.Clip(fields=["venous"], new_min=-200, new_max=400),
            M.CenterIntensities(fields=["venous"], subtrahend=100,
                                divisor=300),
            M.PadToSize(fields=["venous"], size=(24, 24, 24), pad_val=-1024,
                        load_mask=True),
            M.Reshape(fields=["venous", "venous_pancreas"]),
            M.ExtendSqueeze(fields=["venous"], dimension=0, mode=1),
            M.Binarize(fields=["venous_pancreas"]),
        ])

    outs = [M.BaseDataset(["case0001/merge.npy"], transforms=chain(M))[0]
            for M in (P, J)]
    _same(*outs)
    assert outs[0]["venous"].shape == (1, 1, 1, 24, 24, 24)
    assert len(P.BaseDataset(["x", "y"])) == 2
    assert P.BaseDataset(["x"])[0] == "x"


@pytest.mark.parametrize("shape,out", [((30, 26, 34), (16, 20, 12)),
                                       ((10, 12, 8), (20, 18, 24))])
def test_image_resize_matches_jax(rng, monkeypatch, shape, out):
    vol = rng.normal(size=shape).astype(np.float32) * 300
    lab = (rng.random(shape) > 0.6).astype(np.float32)
    got_img = P.image_resize(vol, out)
    got_lab = P.image_resize(lab, out, is_label=True)
    monkeypatch.setenv("VAESEG_NATIVE_RESIZE", "0")
    want_img = J.image_resize(vol, out)
    want_lab = J.image_resize(lab, out, is_label=True)
    np.testing.assert_allclose(got_img, want_img, rtol=2e-4, atol=2e-3)
    assert np.mean(got_lab != want_lab) < 1e-3
    # the plain version: the same bits as the JAX package's
    np.testing.assert_array_equal(P.image_resize(vol, out), want_img)
    np.testing.assert_array_equal(P.image_resize(lab, out, is_label=True),
                                  want_lab)
