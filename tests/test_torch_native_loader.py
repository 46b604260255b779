"""The port's native case loader and resize
(vae_segmentation_tpu_torch/data/native_loader.py, data/csrc/fastloader.cpp)
against the JAX package's numpy path (``remap_labels``, ``label_bbox`` and
``resize_volume`` under ``VAESEG_NATIVE_RESIZE=0``): image, label and bbox
bit for bit, the resize within the JAX package's own rules
(tests/test_native_loader.py), ``CaseDataset`` against the JAX package's,
loads from several threads, the build (a bad compiler raises, a second
process reuses the library, concurrent builds compile once) and the
numpy path where the loader's subset ends."""

import ctypes
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from vae_segmentation_tpu.data import native_loader as jnative
from vae_segmentation_tpu.data import resize as jresize
from vae_segmentation_tpu.data import transforms as jtransforms
from vae_segmentation_tpu.data.pipeline import CaseDataset as JCaseDataset
from vae_segmentation_tpu_torch.data import native_loader, resize, transforms
from vae_segmentation_tpu_torch.data.pipeline import (
    CaseDataset, FullVolumeDataset)
from vae_segmentation_tpu_torch.data.synthetic import write_synthetic_dataset

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAN_INDICES = ["1", "10", "11", "1,2"]
DTYPES = ["<i2", "<f4", "|i1"]
# tests/test_native_loader.py:99-104
RESIZE_SHAPES = [
    ((180, 211, 150), (128, 128, 128)),   # typical crop -> patch downscale
    ((100, 100, 100), (128, 128, 128)),   # upscale
    ((97, 64, 131), (32, 64, 48)),        # mixed odd ratios
    ((1, 40, 40), (1, 16, 16)),           # degenerate axis
]


def _write_case(root, rng, dtype="<i2", shape=(12, 10, 14),
                labels=(0, 1, 2, 11), name="case0042"):
    scale = 40 if dtype == "|i1" else 300
    img = rng.normal(0, scale, shape).astype(dtype)
    lab = rng.choice(labels, shape).astype(dtype)
    case = os.path.join(str(root), name)
    os.makedirs(case, exist_ok=True)
    np.save(os.path.join(case, "merge.npy"), np.stack([img, lab], -1))
    return img, lab, f"{name}/merge.npy"


def _jax_numpy_case(path, mask_index):
    """The JAX package's numpy path of load_merge_case and its bbox."""
    merge = np.load(path)
    label = jtransforms.remap_labels(merge[..., 1], mask_index)
    return merge[..., 0].astype(np.float32), label, \
        jtransforms.label_bbox(label)


def _jax_scipy_resize(monkeypatch, vol, out, order):
    monkeypatch.setenv("VAESEG_NATIVE_RESIZE", "0")
    try:
        return jresize.resize_volume(vol, out, order=order)
    finally:
        monkeypatch.setenv("VAESEG_NATIVE_RESIZE", "1")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pan_index", PAN_INDICES)
def test_native_case_equals_numpy_bit_for_bit(tmp_path, rng, pan_index,
                                              dtype):
    img, lab, entry = _write_case(tmp_path, rng, dtype)
    mask_index = transforms.parse_pan_index(pan_index)
    got = transforms.load_merge_case(str(tmp_path), entry, mask_index)
    assert "bbox" in got, "the case did not take the native loader"
    want_img, want_lab, want_box = _jax_numpy_case(
        os.path.join(tmp_path, entry), mask_index)
    assert got["id"] == "0042"
    assert got["image"].dtype == got["label"].dtype == np.float32
    np.testing.assert_array_equal(got["image"], want_img)
    np.testing.assert_array_equal(got["label"], want_lab)
    np.testing.assert_array_equal(got["bbox"], np.concatenate(want_box))


def test_native_bbox_of_an_empty_label_is_all_minus_one(tmp_path, rng):
    _, _, entry = _write_case(tmp_path, rng, labels=(0, 5))
    got = native_loader.load_case(os.path.join(tmp_path, entry), [[[1], 1]])
    assert _jax_numpy_case(os.path.join(tmp_path, entry),
                           [[[1], 1]])[2] is None
    np.testing.assert_array_equal(got["bbox"], [-1] * 6)
    np.testing.assert_array_equal(got["label"], 0.0)
    # crop_resize reads the all -1 bbox as the empty-mask fallback
    a = transforms.crop_resize(got["image"], got["label"], (8, 8, 8),
                               bbox=got["bbox"])
    b = transforms.crop_resize(got["image"], got["label"], (8, 8, 8))
    for k in ("image", "label", "ori_shape"):
        np.testing.assert_array_equal(a[k], b[k])


def test_remap_takes_the_last_entry_and_exact_values(tmp_path):
    """remap_labels' semantics where the JAX package's C++ copy differs: a
    raw label named by two entries takes the later one, and a float label
    matches only the value it equals."""
    lab = np.array([0.0, 1.0, 1.5, 2.0, 3.0, 1.0], np.float32)
    merge = np.stack([np.arange(6, dtype=np.float32), lab], -1)
    os.makedirs(tmp_path / "case7")
    np.save(tmp_path / "case7" / "merge.npy", merge.reshape(1, 2, 3, 2))
    mask_index = [[0, 0], [1, 1], [[1, 3], 2]]
    got = native_loader.load_case(str(tmp_path / "case7" / "merge.npy"),
                                  mask_index)
    want = jtransforms.remap_labels(lab, mask_index).reshape(1, 2, 3)
    np.testing.assert_array_equal(got["label"], want)
    assert want.ravel().tolist() == [0, 2, 0, 0, 2, 2]


@pytest.mark.parametrize("shape,out", RESIZE_SHAPES)
@pytest.mark.parametrize("order", [0, 1])
def test_native_resize_within_the_rules_of_scipy(shape, out, order,
                                                 monkeypatch):
    rng = np.random.default_rng(hash((shape, order)) % 2**31)
    vol = rng.normal(size=shape).astype(np.float32) * 300.0
    if order == 0:
        vol = np.round(vol / 100.0)  # label-ish integer field
    want = _jax_scipy_resize(monkeypatch, vol, out, order)
    got = native_loader.resize_volume(vol, out, order=order,
                                      anti_aliasing=order != 0)
    assert got.shape == want.shape and got.dtype == np.float32
    if order == 0:
        assert np.mean(got != want) < 1e-3
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)
    # the port's resize_volume takes the native route by default, scipy's
    # under VAESEG_NATIVE_RESIZE=0
    np.testing.assert_array_equal(resize.resize_volume(vol, out,
                                                       order=order), got)
    monkeypatch.setenv("VAESEG_NATIVE_RESIZE", "0")
    np.testing.assert_array_equal(resize.resize_volume(vol, out,
                                                       order=order), want)


@pytest.mark.parametrize("shape,out", [((2, 4, 4), (49, 4, 4)),
                                       ((64, 6, 5), (32, 3, 10)),
                                       ((3, 7, 210), (1, 5, 128))])
def test_native_nearest_equals_scipy_at_ties(monkeypatch, shape, out):
    """scipy's grid-mode coordinate (o + 0.5) * (n_in / n_out) - 0.5: at
    2 -> 49 the JAX package's C++ copy, which divides by n_out / n_in,
    picks another neighbour on 1.9% of the voxels."""
    vol = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    want = _jax_scipy_resize(monkeypatch, vol, out, 0)
    np.testing.assert_array_equal(
        native_loader.resize_volume(vol, out, order=0, anti_aliasing=False),
        want)


@pytest.mark.parametrize("shift", [0, 3])
def test_case_dataset_matches_jax(tmp_path, monkeypatch, shift):
    manifest = write_synthetic_dataset(str(tmp_path), n_train=0, n_val=3,
                                       size=40, seed=5, labels=(1, 2))
    with open(manifest) as f:
        entries = json.load(f)["NIH_val"]
    mask_index = transforms.parse_pan_index("10")
    size = (24, 20, 28)
    got = [CaseDataset(entries, str(tmp_path), mask_index, size,
                       shift=shift)[i] for i in range(3)]
    # the JAX package's numpy path: no native loader, scipy's resize
    monkeypatch.setattr(jnative, "_get_lib", lambda: None)
    monkeypatch.setenv("VAESEG_NATIVE_RESIZE", "0")
    jds = JCaseDataset(entries, str(tmp_path), mask_index, size, shift=shift)
    for i, g in enumerate(got):
        w = jds[i]
        assert g["id"] == w["id"] and g["index"] == w["index"] == i
        np.testing.assert_array_equal(g["ori_shape"], w["ori_shape"])
        np.testing.assert_array_equal(g["label"], w["label"])
        np.testing.assert_allclose(g["image"], w["image"], rtol=2e-4,
                                   atol=2e-3)
        full = FullVolumeDataset(entries, str(tmp_path), mask_index)[i]
        want_img, want_lab, _ = _jax_numpy_case(
            os.path.join(tmp_path, entries[i]), mask_index)
        np.testing.assert_array_equal(full["image"], want_img)
        np.testing.assert_array_equal(full["label"], want_lab)


def test_loads_from_four_threads_give_the_same_bits(tmp_path, rng):
    entries = [_write_case(tmp_path, rng, shape=(30, 26, 34),
                           name=f"case{i:04d}")[2] for i in range(6)]
    ds = CaseDataset(entries, str(tmp_path), [[0, 0], [1, 1], [2, 2]],
                     (16, 20, 12))
    serial = [ds[i] for i in range(len(entries))]
    results, errors = {}, []

    def work(t):
        try:
            for rep in range(3):
                for i in range(len(entries)):
                    results[(t, rep, i)] = ds[i]
        except Exception as e:  # recorded and re-raised by the assertion
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors, errors
    assert len(results) == 4 * 3 * len(entries)
    for (_, _, i), got in results.items():
        for k in ("image", "label", "ori_shape"):
            np.testing.assert_array_equal(got[k], serial[i][k])


def test_numpy_path_where_the_subset_ends(tmp_path, rng):
    """mask_index None, another dtype, Fortran order or a third channel take
    the numpy path, as in the JAX package; a missing file and a truncated
    one raise."""
    img, lab, entry = _write_case(tmp_path, rng)
    path = os.path.join(tmp_path, entry)
    out = transforms.load_merge_case(str(tmp_path), entry, None)
    assert "bbox" not in out
    np.testing.assert_array_equal(out["label"], lab.astype(np.float32))
    mask_index = transforms.parse_pan_index("1,2")
    merge = np.stack([img, lab], -1)
    for name, arr in (("be", merge.astype(">i2")),
                      ("u2", merge.astype("<u2")),
                      ("fortran", np.asfortranarray(merge)),
                      ("three", np.concatenate([merge, merge[..., :1]], -1))):
        os.makedirs(tmp_path / name)
        np.save(tmp_path / name / "merge.npy", arr)
        assert not native_loader.in_subset(str(tmp_path / name / "merge.npy"))
        got = transforms.load_merge_case(str(tmp_path), f"{name}/merge.npy",
                                         mask_index)
        assert "bbox" not in got
        np.testing.assert_array_equal(got["image"],
                                      arr[..., 0].astype(np.float32))
        np.testing.assert_array_equal(
            got["label"], jtransforms.remap_labels(arr[..., 1], mask_index))
    assert native_loader.in_subset(path)
    with pytest.raises(FileNotFoundError):
        transforms.load_merge_case(str(tmp_path), "nope/merge.npy",
                                   mask_index)
    with open(path, "rb") as f:
        data = f.read()
    os.makedirs(tmp_path / "cut")
    with open(tmp_path / "cut" / "merge.npy", "wb") as f:
        f.write(data[:-10])
    with pytest.raises(ValueError, match="truncated"):
        transforms.load_merge_case(str(tmp_path), "cut/merge.npy",
                                   mask_index)


def test_c_abi_shape_and_load_without_bbox(tmp_path, rng):
    img, lab, entry = _write_case(tmp_path, rng, "<f4")
    path = os.fsencode(os.path.join(tmp_path, entry))
    lib = native_loader.library()
    shape = np.zeros(3, np.int64)
    P = ctypes.POINTER
    assert lib.vaeseg_case_shape(
        path, shape.ctypes.data_as(P(ctypes.c_int64))) == 0
    assert shape.tolist() == list(img.shape)
    raws = np.array([0, 11], np.int32)
    clss = np.array([0, 1], np.int32)
    got_img = np.empty(img.shape, np.float32)
    got_lab = np.empty(img.shape, np.float32)
    assert lib.vaeseg_load_case(
        path, raws.ctypes.data_as(P(ctypes.c_int32)),
        clss.ctypes.data_as(P(ctypes.c_int32)), 2,
        got_img.ctypes.data_as(P(ctypes.c_float)),
        got_lab.ctypes.data_as(P(ctypes.c_float)),
        shape.ctypes.data_as(P(ctypes.c_int64))) == 0
    np.testing.assert_array_equal(got_img, img)
    np.testing.assert_array_equal(
        got_lab, jtransforms.remap_labels(lab, [[0, 0], [11, 1]]))
    assert lib.vaeseg_case_shape(
        os.fsencode(str(tmp_path / "none.npy")),
        shape.ctypes.data_as(P(ctypes.c_int64))) != 0


@pytest.mark.parametrize("cxx", ["/nonexistent/c++", "false"])
def test_a_failed_build_raises_and_does_not_fall_back(tmp_path, rng,
                                                      monkeypatch, cxx):
    _, _, entry = _write_case(tmp_path, rng)
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_loader, "_lib", None)
    with pytest.raises(RuntimeError, match="failed|could not run"):
        transforms.load_merge_case(str(tmp_path), entry,
                                   transforms.parse_pan_index("1"))
    with pytest.raises(RuntimeError):
        resize.resize_volume(np.zeros((4, 4, 4), np.float32), (2, 2, 2))
    assert native_loader._lib is None
    assert not list((tmp_path / "build").glob("*.so"))


def _run(code, **env):
    full = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    full.update(env)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=full,
                          capture_output=True, text=True, timeout=120)


def test_a_second_process_loads_the_library_without_building():
    native_loader.library()
    res = _run(
        "import json\n"
        "from vae_segmentation_tpu_torch.data import native_loader as n\n"
        "n.library()\n"
        "r = n.build_record(); r.pop('log')\n"
        "print(json.dumps(r))\n", VAESEG_LOADER_THREADS="3")
    assert res.returncode == 0, res.stderr
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["built"] is False
    assert rec["path"] == native_loader.build_record()["path"]
    assert rec["threads"] == 3


def test_concurrent_builds_compile_once(tmp_path):
    code = ("import json, sys\n"
            "from pathlib import Path\n"
            "from vae_segmentation_tpu_torch.data import native_loader as n\n"
            "lib, rec = n.build(Path(sys.argv[1]))\n"
            "rec.pop('log')\n"
            "print(json.dumps(rec))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               str(tmp_path / "b")], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    recs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        recs.append(json.loads(out.strip().splitlines()[-1]))
    assert sorted(r["built"] for r in recs) == [False, False, True]
    assert len({r["path"] for r in recs}) == 1
    assert [p.name for p in (tmp_path / "b").glob("*.so")] == \
        [os.path.basename(recs[0]["path"])]


def test_native_directory_is_never_opened(tmp_path, rng):
    """The port builds its own library under data/build and never maps the
    JAX package's native/*.so, whatever is there."""
    _, _, entry = _write_case(tmp_path, rng)
    res = _run(
        "import sys\n"
        "import numpy as np\n"
        "from vae_segmentation_tpu_torch.data import transforms, resize\n"
        "from vae_segmentation_tpu_torch.data import native_loader as n\n"
        f"c = transforms.load_merge_case({str(tmp_path)!r}, {entry!r},\n"
        "                                 transforms.parse_pan_index('1'))\n"
        "assert 'bbox' in c\n"
        "resize.resize_volume(np.ones((9, 9, 9), np.float32), (4, 4, 4))\n"
        "maps = open('/proc/self/maps').read()\n"
        "import json\n"
        "print(json.dumps(sorted({l.split()[-1] for l in maps.splitlines()\n"
        "                         if 'fastloader' in l or '/native/' in l})))\n"
        "print(n.build_record()['path'])\n")
    assert res.returncode == 0, res.stderr
    mapped, lib_path = res.stdout.strip().splitlines()[-2:]
    build_dir = os.path.join(REPO, "vae_segmentation_tpu_torch", "data",
                             "build")
    assert os.path.dirname(lib_path) == build_dir
    mapped = json.loads(mapped)
    assert mapped and all(os.path.dirname(p) == build_dir for p in mapped)
    for root, _, files in os.walk(os.path.join(REPO,
                                               "vae_segmentation_tpu_torch")):
        for name in files:
            if name.endswith((".py", ".cpp")):
                with open(os.path.join(root, name)) as f:
                    src = f.read()
                assert "libvaeseg_fastloader" not in src, name
                assert "make -C native" not in src, name


def test_new_port_modules_import_no_jax():
    res = _run(
        "import sys\n"
        "import vae_segmentation_tpu_torch.data.native_loader\n"
        "import vae_segmentation_tpu_torch.data.host_transforms\n"
        "import vae_segmentation_tpu_torch.data.preprocess\n"
        "import vae_segmentation_tpu_torch.utils\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                    'vae_segmentation_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    assert res.returncode == 0, res.stdout + res.stderr
