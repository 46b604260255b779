"""The port's offline preprocessing (vae_segmentation_tpu_torch/data/
preprocess.py) against the JAX package's (data/preprocess.py), following
tests/test_preprocess.py: ``reorient``, ``cube_crop`` and
``update_manifest`` equal, ``resample_iso`` (the port's native resize)
within the rules of tests/test_native_loader.py of the JAX package's scipy
path, and the CLI, ``python -m vae_segmentation_tpu_torch.data.preprocess``,
on NIfTI stand-ins: nibabel is not installed, so a module of that name
loads npz files holding 'data' and 'affine'."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from vae_segmentation_tpu.data import preprocess as J
from vae_segmentation_tpu_torch.data import preprocess as P

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAKE_NIBABEL = '''import types
import numpy as np


def load(path):
    z = np.load(path)
    return types.SimpleNamespace(dataobj=z["data"], affine=z["affine"])
'''


def test_reorient_matches_jax(rng):
    vol = rng.normal(size=(5, 7, 9)).astype(np.float32)
    for spacing in ([-1.0, -1.0, 1.0], [1.0, 1.0, 1.0], [-0.7, 0.8, -2.0]):
        spacing = np.asarray(spacing)
        got = P.reorient(vol, spacing)
        want = J.reorient(vol, spacing)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spacing", [[-2.0, -1.5, 3.0], [0.7, -0.8, 2.5]])
def test_resample_iso_matches_jax(rng, monkeypatch, spacing):
    img = rng.normal(size=(10, 12, 8)).astype(np.float32) * 100
    lab = (rng.random((10, 12, 8)) > 0.7).astype(np.float32)
    spacing = np.asarray(spacing)
    got_img, got_lab = P.resample_iso(img, lab, spacing)
    monkeypatch.setenv("VAESEG_NATIVE_RESIZE", "0")
    want_img, want_lab = J.resample_iso(img, lab, spacing)
    assert got_img.shape == want_img.shape == \
        tuple((np.array(img.shape) * np.abs(spacing)).astype(int))
    np.testing.assert_allclose(got_img, want_img, rtol=2e-4, atol=2e-3)
    assert np.mean(got_lab != want_lab) < 1e-3
    assert set(np.unique(got_lab)) <= {0.0, 1.0}


@pytest.mark.parametrize("box,pad", [
    ((slice(40, 50), slice(30, 45), slice(20, 28)), (2, 2, 2)),
    ((slice(0, 10), slice(0, 30), slice(0, 5)), (32, 32, 32)),
    ((slice(90, 100), slice(5, 9), slice(60, 80)), (4, 0, 9)),
])
def test_cube_crop_matches_jax(rng, box, pad):
    img = rng.normal(size=(100, 90, 80)).astype(np.float32)
    lab = np.zeros((100, 90, 80), np.float32)
    lab[box] = 1
    got = P.cube_crop(img, lab, pad=pad)
    want = J.cube_crop(img, lab, pad=pad)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].sum() == lab.sum()


def test_cube_crop_raises_on_empty():
    z = np.zeros((8, 8, 8), np.float32)
    with pytest.raises(ValueError):
        P.cube_crop(z, z)


def test_update_manifest_matches_jax(tmp_path):
    for mod, name in ((P, "p.json"), (J, "j.json")):
        path = os.path.join(tmp_path, "lists", name)
        mod.update_manifest(path, "NIH_train", ["a/merge.npy", "b/merge.npy"])
        mod.update_manifest(path, "NIH_train", ["b/merge.npy", "c/merge.npy"])
        mod.update_manifest(path, "NIH_val", ["d/merge.npy"])
    with open(tmp_path / "lists" / "p.json") as f:
        got = f.read()
    with open(tmp_path / "lists" / "j.json") as f:
        assert got == f.read()
    assert json.loads(got)["NIH_train"] == ["a/merge.npy", "b/merge.npy",
                                            "c/merge.npy"]


def test_label_names_match_jax():
    for name, ds in (("PANCREAS_0001.nii.gz", "nih"),
                     ("pancreas_042.nii.gz", "msd"),
                     ("img0005-avg.nii.gz", "synapse")):
        assert P._label_name(name, ds) == J._label_name(name, ds)


def _nifti_cases(root, rng, n=2):
    """NIfTI stand-ins: n images with a label each, one more without."""
    img_dir, lab_dir = root / "img", root / "lab"
    img_dir.mkdir()
    lab_dir.mkdir()
    affine = np.diag([-0.8, -0.8, 2.5, 1.0])
    for i in range(n + 1):
        img = (rng.normal(40, 200, (40, 36, 12))).astype(np.int16)
        zz, yy, xx = np.mgrid[0:40, 0:36, 0:12]
        lab = ((((zz - 20 - i) / 8.0) ** 2 + ((yy - 17) / 6.0) ** 2
                + ((xx - 6) / 3.0) ** 2) <= 1).astype(np.int16)
        with open(img_dir / f"PANCREAS_{i + 1:04d}.nii.gz", "wb") as f:
            np.savez(f, data=img, affine=affine)
        if i < n:
            with open(lab_dir / f"label{i + 1:04d}.nii.gz", "wb") as f:
                np.savez(f, data=lab, affine=affine)
    return img_dir, lab_dir


def test_cli_writes_the_cases_of_the_jax_package(tmp_path, rng, monkeypatch):
    img_dir, lab_dir = _nifti_cases(tmp_path, rng)
    (tmp_path / "fake").mkdir()
    (tmp_path / "fake" / "nibabel.py").write_text(FAKE_NIBABEL)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path / "fake"), REPO])
    manifest = tmp_path / "lists" / "Multi_all.json"
    res = subprocess.run(
        [sys.executable, "-m", "vae_segmentation_tpu_torch.data.preprocess",
         "--image_dir", str(img_dir), "--label_dir", str(lab_dir),
         "--out", str(tmp_path / "out"), "--dataset", "nih",
         "--manifest", str(manifest), "--split", "NIH_train",
         "--workers", "2"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "PANCREAS_0001: ok" in res.stdout
    assert "PANCREAS_0003.nii.gz: FAILED" in res.stdout
    with open(manifest) as f:
        assert json.load(f) == {"NIH_train": ["PANCREAS_0001/merge.npy",
                                              "PANCREAS_0002/merge.npy"]}

    fake = types.ModuleType("nibabel")
    exec(FAKE_NIBABEL, fake.__dict__)
    monkeypatch.setitem(sys.modules, "nibabel", fake)
    for i in (1, 2):
        case = f"PANCREAS_{i:04d}"
        args = (str(img_dir / f"{case}.nii.gz"),
                str(lab_dir / f"label{i:04d}.nii.gz"))
        P.process_nifti_case(*args, str(tmp_path / "p" / case))
        monkeypatch.setenv("VAESEG_NATIVE_RESIZE", "0")
        J.process_nifti_case(*args, str(tmp_path / "j" / case))
        monkeypatch.setenv("VAESEG_NATIVE_RESIZE", "1")
        for name in ("img.npy", "label.npy", "merge.npy"):
            cli = np.load(tmp_path / "out" / case / name)
            mine = np.load(tmp_path / "p" / case / name)
            jax_ = np.load(tmp_path / "j" / case / name)
            np.testing.assert_array_equal(cli, mine)
            assert cli.dtype == jax_.dtype and cli.shape == jax_.shape
            # labels equal; the image's int16 truncation of two resizes
            # that agree within 2e-3 may differ by one
            if name == "label.npy":
                np.testing.assert_array_equal(cli, jax_)
                continue
            if name == "merge.npy":
                np.testing.assert_array_equal(cli[..., 1], jax_[..., 1])
            diff = np.abs(cli.astype(np.int32) - jax_.astype(np.int32))
            assert diff.max() <= 1 and np.mean(diff > 0) < 1e-2
