"""The port's checkpoints (vae_segmentation_tpu_torch/core/checkpoint.py,
core/msgpack.py) and ``--resume`` on the CPU:

  * files the JAX package's own ``save_checkpoint`` writes (msgpack via
    flax) for a Joint, a SegUNet and a ShapeVAE load into the port's
    models, whose f32 forward then matches the JAX forward within
    tests/test_torch_models.py's 32^3 bounds (probabilities 1e-4 abs,
    mean / std 1e-4 of their largest |value|);
  * the pure-Python msgpack reader against the ``msgpack`` package on
    every type flax writes, and its refusals: a truncated file, an unknown
    ext code, ext 2 (complex), a chunked array, trailing bytes; a failed
    load leaves the model untouched;
  * the port's torch payload round trip (optimizer state and 'extra'), the
    format sniffing, ``latest_checkpoint``;
  * the vae_train CLI resuming from a JAX-written run directory and from a
    port-written one: the start epoch, the best result, the restored
    weights bit for bit, a fresh start without a checkpoint.
"""

import os
import re
from unittest import mock

import msgpack as msgpack_ref
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from test_torch_models import NAMES, _case, _draw_params, _jax_out, \
    _port_model
from vae_segmentation_tpu.core import checkpoint as jckpt
from vae_segmentation_tpu.models import ShapeVAE as JVae
from vae_segmentation_tpu.train import optim as joptim
from vae_segmentation_tpu.train import steps as jsteps
from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch.cli import source_main
from vae_segmentation_tpu_torch.core import checkpoint as ckpt
from vae_segmentation_tpu_torch.core import msgpack
from vae_segmentation_tpu_torch.data.synthetic import write_synthetic_dataset

torch.set_num_threads(2)


def _jax_file(path, kind, epoch=4, extra=None):
    """The JAX package's checkpoint of `kind`'s seeded params (and an SGD
    state masked as the trainers mask it), written by its own
    save_checkpoint."""
    params = jax.tree.map(jnp.asarray, _case(kind)[0])
    base = joptim.sgd(1e-2)
    tx = joptim.freeze_vae(base, params) if kind == "joint" else base
    opt_state = jsteps.init_state(params, tx).opt_state
    jckpt.save_checkpoint(str(path), epoch=epoch, params=params,
                          opt_state=opt_state,
                          extra=extra or {"best_result": 0.25})
    return str(path)


@pytest.mark.parametrize("kind", ["seg", "vae", "joint"])
def test_port_reads_a_jax_checkpoint_and_matches_its_forward(tmp_path, kind):
    path = _jax_file(tmp_path / "best_model.ckpt", kind)
    ck = ckpt.load_checkpoint(path)
    assert ck["epoch"] == 4 and ck["version"] == 1
    assert ck["extra"] == {"best_result": 0.25}
    model = _port_model(kind, "f32")
    if kind == "joint":
        pm.load_state(model, path)           # by path, as the CLIs do
    else:
        pm.load_network(model, ck, "Seg" if kind == "seg" else "Vae")
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(_case(kind)[1]))
    out = list(out) if isinstance(out, tuple) else [out]
    for name, g, w in zip(NAMES[kind], out, _jax_out(kind, "f32")):
        g = g.float().numpy()
        assert g.shape == w.shape, name
        tol = 1e-4 if name in ("pred", "recon") else 1e-4 * np.abs(w).max()
        assert np.abs(g - w).max() <= tol, (name, np.abs(g - w).max())


def test_jax_components_load_selectively(tmp_path):
    """--load_prefix / --load_prefix_vae: a JAX SegUNet file into Joint.Seg,
    a JAX ShapeVAE file into Joint.Vae, the other half untouched."""
    seg = _jax_file(tmp_path / "seg.ckpt", "seg")
    vae = _jax_file(tmp_path / "vae.ckpt", "vae")
    joint = _port_model("joint", "f32")
    before = {k: v.clone() for k, v in joint.state_dict().items()}
    pm.load_component(joint, seg, "Seg")
    sd = joint.state_dict()
    want = pm.from_jax_params(_case("seg")[0])
    assert all(torch.equal(sd["Seg." + k], v) for k, v in want.items())
    assert all(torch.equal(sd[k], v) for k, v in before.items()
               if k.startswith("Vae."))
    pm.load_component(joint, vae, "Vae")
    want = pm.from_jax_params(_case("vae")[0])
    sd = joint.state_dict()
    assert all(torch.equal(sd["Vae." + k], v) for k, v in want.items())


# ---- the msgpack reader


def _tree():
    """Every msgpack type flax writes, at each length class."""
    rng = np.random.default_rng(0)
    return {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                 2 ** 32, 2 ** 63, -1, -32, -33, -128, -129, -32768, -32769,
                 -2 ** 31, -2 ** 31 - 1, -2 ** 63],
        "floats": [0.0, -2.5, 1e300, float("inf")],
        "none": None, "bools": [True, False],
        "strs": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000, "hé"],
        "bins": [b"", b"x" * 300, b"y" * 70000],
        "arrays": [list(range(15)), list(range(16)), list(range(70000))],
        "maps": [{str(i): i for i in range(15)},
                 {str(i): i for i in range(16)},
                 {str(i): i for i in range(70000)}],
        "nd": {str(i): a for i, a in enumerate([
            rng.normal(size=(3, 4)).astype(np.float32),
            rng.normal(size=(2, 1, 5)),
            rng.integers(-9, 9, (7,)).astype(np.int32),
            np.zeros((0, 3), np.float32), np.arange(6, dtype=np.uint8),
            np.array([True, False]), np.asarray(3.5, np.float32)])},
        "scalars": [np.float32(1.5), np.int32(-7), np.float64(2.25)],
    }


def test_reader_matches_the_msgpack_package_on_every_type():
    data = serialization.msgpack_serialize(_tree())
    got = msgpack.unpackb(data)
    want = serialization.msgpack_restore(data)

    def same(g, w):
        if isinstance(w, np.ndarray):
            return isinstance(g, np.ndarray) and g.dtype == w.dtype \
                and g.shape == w.shape and np.array_equal(g, w)
        if isinstance(w, np.generic):
            return type(g) is type(w) and g == w
        if isinstance(w, dict):
            return isinstance(g, dict) and list(g) == list(w) and all(
                same(g[k], w[k]) for k in w)
        if isinstance(w, (list, tuple)):
            return len(g) == len(w) and all(map(same, g, w))
        return type(g) is type(w) and g == w

    assert same(got, want)
    plain = {"a": [1, -2, 3.5, None, True, "s", b"b"], "m": {"k": {}}}
    assert msgpack.unpackb(msgpack_ref.packb(plain, use_bin_type=True)) \
        == plain


def test_reader_widens_bfloat16_exactly():
    x = jnp.asarray([1.0, -2.5, 3.140625, 1e-3], jnp.bfloat16)
    got = msgpack.unpackb(serialization.msgpack_serialize({"x": x}))["x"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(x, np.float32))


def _ext(code, payload=b"\x00"):
    return msgpack_ref.packb({"model_state_dict": msgpack_ref.ExtType(
        code, payload), "epoch": 1})


@pytest.mark.parametrize("fault", ["truncated", "ext_unknown", "ext_complex",
                                   "chunked", "trailing", "not_a_checkpoint",
                                   "bad_ndarray"])
def test_malformed_files_raise_and_load_nothing(tmp_path, fault):
    path = tmp_path / "model_epoch1.ckpt"
    good = open(_jax_file(tmp_path / "good.ckpt", "seg"), "rb").read()
    if fault == "truncated":
        data = good[:len(good) // 2]
        match = "truncated"
    elif fault == "ext_unknown":
        data, match = _ext(7), "unknown msgpack ext type 7"
    elif fault == "ext_complex":
        data = serialization.msgpack_serialize(
            {"model_state_dict": {"w": 1 + 2j}, "epoch": 1})
        match = "ext type 2"
    elif fault == "chunked":
        with mock.patch.object(serialization, "MAX_CHUNK_SIZE", 64):
            data = serialization.msgpack_serialize(
                {"model_state_dict": {"w": np.zeros(100, np.float32)},
                 "epoch": 1})
        match = "chunked"
    elif fault == "trailing":
        data, match = good + b"\x00", "after the msgpack object"
    elif fault == "not_a_checkpoint":
        data = serialization.msgpack_serialize({"params": {}})
        match = "not a checkpoint"
    else:
        data = _ext(1, msgpack_ref.packb(((2, 3), "float32", b"\x00" * 21),
                                         use_bin_type=True))
        match = "whole elements"
    path.write_bytes(data)
    with pytest.raises(msgpack.MsgpackError, match=match):
        ckpt.load_checkpoint(str(path))
    model = _port_model("seg", "f32")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(msgpack.MsgpackError):
        pm.load_network(model, str(path), "Seg")
    assert all(torch.equal(v, before[k])
               for k, v in model.state_dict().items())


def test_a_composite_tree_with_unknown_parts_raises():
    params = _case("joint")[0]
    with pytest.raises(KeyError, match="other than Seg and Vae"):
        pm.from_jax_params({**params, "Dis": params["Seg"]})


# ---- the port's own files


def test_torch_round_trip_with_optimizer_and_extra(tmp_path):
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model(torch.ones(4, 3)).sum().backward()
    opt.step()
    path = str(tmp_path / "p" / "best_model.ckpt")
    ckpt.save_checkpoint(path, epoch=6, model=model, optimizer=opt,
                         extra={"best_result": 0.5})
    assert open(path, "rb").read(4) == ckpt.ZIP_MAGIC
    assert not os.path.exists(path + ".tmp")
    ck = ckpt.load_checkpoint(path)
    assert set(ck) == {"version", "epoch", "model_state_dict",
                       "optimizer_state_dict", "extra"}
    assert (ck["version"], ck["epoch"], ck["extra"]) == \
        (1, 6, {"best_result": 0.5})
    assert all(torch.equal(ck["model_state_dict"][k], v)
               for k, v in model.state_dict().items())
    want = opt.state_dict()
    got = ck["optimizer_state_dict"]
    assert got["param_groups"] == want["param_groups"]
    assert all(torch.equal(got["state"][i]["momentum_buffer"],
                           s["momentum_buffer"])
               for i, s in want["state"].items())
    ckpt.save_checkpoint(path, epoch=1, model=model)
    assert ckpt.load_checkpoint(path)["optimizer_state_dict"] == {}


def test_sniffing_takes_either_torch_format_and_msgpack(tmp_path):
    model = pm.SegUNet(n_class=2, fmaps=(4, 8, 8, 16, 16, 32),
                       dtype=torch.float32,
                       generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    legacy = str(tmp_path / "legacy.ckpt")
    torch.save({"epoch": 3, "model_state_dict": sd}, legacy,
               _use_new_zipfile_serialization=False)
    assert open(legacy, "rb").read(1) == ckpt.PICKLE_PROTO
    for path in (legacy, _jax_file(tmp_path / "j.ckpt", "seg")):
        other = pm.SegUNet(n_class=2, fmaps=(4, 8, 8, 16, 16, 32),
                           dtype=torch.float32)
        pm.load_network(other, path, "Seg")
        want = sd if path == legacy else pm.from_jax_params(_case("seg")[0])
        assert all(torch.equal(other.state_dict()[k], v)
                   for k, v in want.items())


def test_latest_checkpoint_picks_the_largest_epoch(tmp_path):
    assert ckpt.latest_checkpoint(str(tmp_path), "p") is None
    d = tmp_path / "p"
    d.mkdir()
    for name in ("model_epoch9.ckpt", "model_epoch10.ckpt",
                 "model_epoch2.ckpt", "best_model.ckpt",
                 "model_epochx.ckpt", "model_epoch11.ckpt.tmp"):
        (d / name).write_bytes(b"")
    assert ckpt.latest_checkpoint(str(tmp_path), "p") == \
        str(d / "model_epoch10.ckpt")


# ---- --resume on the vae_train CLI


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("resume")
    write_synthetic_dataset(str(root / "data"), n_train=2, n_val=1, size=36,
                            seed=0)
    old = os.getcwd()
    os.chdir(root)
    yield root
    os.chdir(old)


def _argv(root, prefix, *extra):
    return [prefix, "--method", "vae_train", "--train_list", "NIH_train",
            "--val_list", "NIH_val", "--data_root", str(root / "data"),
            "--val_data_root", str(root / "data"),
            "--data_path", str(root / "data" / "Multi_all.json"),
            "--patch_size", "32", "32", "32", "-b", "2", "--eval_epoch", "1",
            "--save_epoch", "1", "--num_workers", "0", "--no_aug",
            "--device", "cpu", *extra]


def _resume_run(argv, capsys):
    """Run the CLI, capturing the ShapeVAE's weights right after --resume
    restored them; returns (best, restored state_dict, stdout)."""
    restored = {}
    real = source_main.load_network

    def spy(model, ck, name):
        real(model, ck, name)
        restored.update({k: v.clone() for k, v in model.state_dict().items()})

    capsys.readouterr()
    with mock.patch.object(source_main, "load_network", spy):
        best = source_main.main(argv)
    return best, restored, capsys.readouterr().out


def test_vae_train_resumes_from_a_jax_run(workdir, capsys):
    """The JAX package's layout: model_epoch2 and model_epoch4 (with
    extra.best_result) of a full-width 32^3 ShapeVAE; the port resumes
    from epoch 4 with its best result and the epoch-4 params."""
    template = jax.eval_shape(
        lambda v: JVae(n_class=2, dim=128, bottleneck=256, s2d=False).init(
            jax.random.PRNGKey(0), v),
        jax.ShapeDtypeStruct((1, 32, 32, 32, 2), jnp.float32))["params"]
    runs = {}
    for epoch, seed in ((2, 5), (4, 6)):
        params = _draw_params(template, np.random.default_rng(seed))
        runs[epoch] = params
        jckpt.save_checkpoint(
            str(workdir / "3dmodel" / "jr" / f"model_epoch{epoch}.ckpt"),
            epoch=epoch, params=params, extra={"best_result": 0.97 + epoch
                                               / 1000})
    best, restored, out = _resume_run(
        _argv(workdir, "jr", "--max_epoch", "5", "--resume"), capsys)
    assert "Resumed from 3dmodel/jr/model_epoch4.ckpt at epoch 4 " \
           "(best 0.9740)" in out
    steps = re.findall(r"^\[\s*(\d+),\s*\d+\] loss", out, re.M)
    assert steps == ["5"]                 # outer epoch 4 only, one batch
    assert best == pytest.approx(0.974)   # random weights score below it
    want = pm.from_jax_params(runs[4])
    assert sorted(restored) == sorted(want)
    assert all(torch.equal(restored[k], v) for k, v in want.items())
    ck = ckpt.load_checkpoint("3dmodel/jr/model_epoch5.ckpt")
    assert ck["epoch"] == 5 and ck["extra"] == {"best_result": best}
    assert ck["optimizer_state_dict"]["state"]   # the momentum of one step


def test_vae_train_resumes_from_a_port_run_and_starts_fresh_without(
        workdir, capsys):
    best, restored, out = _resume_run(
        _argv(workdir, "pr", "--max_epoch", "2", "--resume"), capsys)
    assert "Resumed" not in out and not restored   # no checkpoint: fresh
    assert re.findall(r"^\[\s*(\d+),", out, re.M) == ["1", "2"]
    saved = ckpt.load_checkpoint("3dmodel/pr/model_epoch2.ckpt")
    best2, restored, out = _resume_run(
        _argv(workdir, "pr", "--max_epoch", "3", "--resume"), capsys)
    assert f"Resumed from 3dmodel/pr/model_epoch2.ckpt at epoch 2 " \
           f"(best {best:.4f})" in out
    assert re.findall(r"^\[\s*(\d+),", out, re.M) == ["3"]
    assert all(torch.equal(restored[k], v)
               for k, v in saved["model_state_dict"].items())
    assert best2 >= best
