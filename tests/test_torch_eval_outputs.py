"""The port's serving outputs against the JAX package on the CPU:
``save_eval_npys`` (the same names and arrays as the JAX function's),
``make_joint_eval_step(with_gt_recon=True)`` and
``make_analysis_metrics_step`` held to JAX's at 32^3 with
tests/test_torch_train.py's widths in f32, weights carried by
``from_jax_params`` (a teacher Joint of its own seed), with
tests/test_torch_models.py's f32 tolerances: probabilities 1e-4 abs,
each per-sample Dice (binary or soft) 1e-4; and both CLIs with the 11b
flags on synthetic cases at 32^3 full width (``--device cpu``): the files
the JAX CLIs' writers give for those cases (``save_eval_npys``, the
``_gt_recon`` dump, the four analysis figures, a score JSON and an event
file; the JAX CLIs themselves take ~1.5 min to build the full-width models
on this CPU, so their writers are called here instead), and the dumped
arrays equal to the eval step's binarized prediction, the normalized image
and the one-hot label."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import NC, _case, _draw_params, _jax_joint, _port_joint
from vae_segmentation_tpu.cli import common as jcommon
from vae_segmentation_tpu.eval import evaluate as jeval
from vae_segmentation_tpu.obs import draw as jdraw
from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch.cli import common, source_main, target_main
from vae_segmentation_tpu_torch.core.checkpoint import save_checkpoint
from vae_segmentation_tpu_torch.data import pipeline as pp
from vae_segmentation_tpu_torch.data.synthetic import write_synthetic_dataset
from vae_segmentation_tpu_torch.data.transforms import parse_pan_index
from vae_segmentation_tpu_torch.eval.evaluate import (
    make_analysis_metrics_step, make_joint_eval_step)
from vae_segmentation_tpu_torch.ops import losses as L

torch.set_num_threads(2)

SIZE = 32
PROB_TOL = 1e-4
DICE_TOL = 1e-4


def test_save_eval_npys_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    pred = (rng.random((1, 6, 5, 4, 2)) > 0.5).astype(np.float32)
    img = rng.normal(size=(1, 6, 5, 4)).astype(np.float32)
    gt = (rng.random((1, 6, 5, 4, 2)) > 0.5).astype(np.float32)
    jcommon.save_eval_npys(str(tmp_path / "jax"), 3, 7, pred, img, gt)
    common.save_eval_npys(str(tmp_path / "port"), 3, 7, pred, img, gt)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == \
        ["3_7_gt.npy", "3_7_pic.npy", "3_7_pred.join.npy"]
    for n in names:
        a, b = np.load(tmp_path / "jax" / n), np.load(tmp_path / "port" / n)
        assert a.dtype == b.dtype and np.array_equal(a, b), n
    assert np.load(tmp_path / "port" / "3_7_pred.join.npy").shape == \
        (1, 2, 6, 5, 4)


_RUN = {}


def _models():
    if not _RUN:
        params, batches = _case(SIZE)
        teacher = _draw_params(jax.tree.map(np.asarray, params),
                               np.random.default_rng(9))
        img, lab = batches[0]
        jm = _jax_joint(SIZE)
        jp, jt = (jax.tree.map(jnp.asarray, p) for p in (params, teacher))
        ja, jl = jnp.asarray(img), jnp.asarray(lab)
        _RUN["jax_eval"] = {k: np.asarray(v) for k, v in
                            jeval.make_joint_eval_step(
                                jm, NC, with_gt_recon=True)(jp, ja, jl)
                            .items()}
        _RUN["jax_analysis"] = {k: np.asarray(v) for k, v in
                                jeval.make_analysis_metrics_step(
                                    jm, jm, NC)(jp, jt, ja, jl).items()}
        model, tea = _port_joint(SIZE), _port_joint(SIZE)
        pm.load_state(model, pm.from_jax_params(params))
        pm.load_state(tea, pm.from_jax_params(teacher))
        pi, pl = torch.from_numpy(img), torch.from_numpy(lab)
        _RUN["port_eval"] = {k: v.numpy() for k, v in make_joint_eval_step(
            model, NC, with_gt_recon=True)(pi, pl).items()}
        _RUN["port_analysis"] = {
            k: v.numpy() for k, v in
            make_analysis_metrics_step(model, tea, NC)(pi, pl).items()}
    return _RUN


def test_eval_step_with_gt_recon_matches_jax():
    run = _models()
    got, want = run["port_eval"], run["jax_eval"]
    assert sorted(got) == sorted(want) == ["gt_recon", "pred", "recon",
                                           "score"]
    for k in ("gt_recon", "pred", "recon"):
        assert got[k].shape == want[k].shape, k
        assert np.abs(got[k] - want[k]).max() <= PROB_TOL, k
    assert np.abs(got["score"] - want["score"]).max() <= DICE_TOL


def test_analysis_metrics_match_jax():
    run = _models()
    got, want = run["port_analysis"], run["jax_analysis"]
    assert sorted(got) == sorted(want) and len(got) == 7
    for k, w in want.items():
        assert got[k].shape == w.shape == (2,), k
        assert np.abs(got[k] - w).max() <= DICE_TOL, (k, got[k], w)
        assert np.all((got[k] >= 0) & (got[k] <= 1)), k


# ---- the CLIs with the 11b flags


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_eval_outputs")
    write_synthetic_dataset(str(root / "data"), n_train=2, n_val=2, size=40,
                            seed=0)
    model = pm.Joint(n_class=2, bottleneck=256,
                     generator=torch.Generator().manual_seed(0))
    save_checkpoint(str(root / "3dmodel" / "jp" / "best_model.ckpt"),
                    epoch=0, model=model)
    save_checkpoint(str(root / "3dmodel" / "vp" / "best_model.ckpt"),
                    epoch=0, model=model.Vae)
    old = os.getcwd()
    os.chdir(root)
    yield root
    os.chdir(old)


def _common(root, *extra):
    return ["--train_list", "NIH_train", "--val_list", "NIH_val",
            "--data_root", str(root / "data"),
            "--val_data_root", str(root / "data"),
            "--data_path", str(root / "data" / "Multi_all.json"),
            "--patch_size", "32", "32", "32", "--num_workers", "0",
            "--device", "cpu", *extra]


def _val_cases(root):
    with open(root / "data" / "Multi_all.json") as f:
        entries = json.load(f)["NIH_val"]
    ds = pp.CaseDataset(entries, str(root / "data"), parse_pan_index("1"),
                        (32, 32, 32))
    return [ds[i] for i in range(len(ds))]


def _jax_file_set(tmp, epoch, cases, figure=None, gt_recon=False):
    """The files the JAX CLI's writers give: its save_eval_npys (and the
    seg_train _gt_recon dump) a case, its four analysis figures."""
    os.makedirs(tmp, exist_ok=True)
    old = os.getcwd()
    os.chdir(tmp)
    try:
        z = np.zeros((1, 2, 2, 2, 2), np.float32)
        for c in cases:
            jcommon.save_eval_npys("result", epoch, c, z, z[..., 0], z)
            if gt_recon:
                np.save(os.path.join("result", f"{epoch}_{c}_gt_recon"), z)
        figs = []
        if figure is not None:
            pts = {0: [0.1, 0.2], 1: [0.3, 0.4]}
            for suffix in ("", "_gt", "_pseudo"):
                jdraw.scatter_plot(pts, figure + suffix, "Pseudo_loss",
                                   "Recon_loss")
            jdraw.scatter_plot_multi(pts, pts, "analysis")
            figs = sorted(os.listdir(jdraw.FIGURE_DIR))
        return sorted(os.listdir("result")), figs
    finally:
        os.chdir(old)


def test_target_cli_outputs_match_the_jax_writers(workdir, capsys):
    dsc = target_main.main([
        "ev", "--method", "domain_adaptation", "--test_only",
        "--load_prefix_joint", "jp", "--save_eval_result",
        "--save_more_reference", "--analysis_figure_name", "fig",
        "--profile_dir", "prof", *_common(workdir)])
    out = capsys.readouterr().out
    results, figs = _jax_file_set(workdir / "jax_t", 0, (0, 1), "fig")
    assert sorted(os.listdir("result/ev")) == results
    assert sorted(os.listdir("figure/analysis_figure")) == figs == \
        ["analysis.jpg", "fig.jpg", "fig_gt.jpg", "fig_pseudo.jpg"]
    tb = sorted(os.listdir("tensorboard/ev"))
    assert tb[-1] == "score_0.json" and tb[0].startswith("events.out")
    assert os.listdir("prof") == ["trace.json"]
    # the saver's step: an outer epoch's batches, 2 cases x 50 (--eval_epoch)
    # // 4 (-b)
    assert f"val_result {dsc} 25" in out
    # the dumps: the eval step's binarized prediction, the image, the label
    model = pm.Joint(n_class=2, bottleneck=256)
    pm.load_state(model, "3dmodel/jp/best_model.ckpt")
    step = make_joint_eval_step(model, 2)
    for i, case in enumerate(_val_cases(workdir)):
        img = pp.intensity_normalize(torch.from_numpy(case["image"]))[None]
        lab = torch.from_numpy(case["label"])[None]
        pred = step(img, lab)["pred"]
        want = {"pred.join": L.binarize(pred).float().permute(0, 4, 1, 2, 3),
                "pic": img[:, None],
                "gt": L.one_hot_label(lab, 2, torch.float32)
                .permute(0, 4, 1, 2, 3)}
        for stem, w in want.items():
            got = np.load(f"result/ev/0_{case['index']}_{stem}.npy")
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, w.numpy())


def test_source_cli_outputs_match_the_jax_writers(workdir, capsys):
    """seg_train with --load_prefix_vae (the reference VAE of its panels
    and its _gt_recon dump), --save_eval_result and
    --save_more_reference; one outer epoch (no step: the epoch-0 skip)."""
    source_main.main(["seg", "--method", "seg_train", "--load_prefix_vae",
                      "vp", "--save_eval_result", "--save_more_reference",
                      "--eval_epoch", "1", "--save_epoch", "1",
                      "--max_epoch", "1", "-b", "2", *_common(workdir)])
    assert "val_result " in capsys.readouterr().out
    results, _ = _jax_file_set(workdir / "jax_s", 0, (0, 1),
                               gt_recon=True)
    assert sorted(os.listdir("result/seg")) == results
    vae = pm.ShapeVAE(n_class=2, bottleneck=256)
    pm.load_network(vae, "3dmodel/vp/best_model.ckpt", "Vae")
    for case in _val_cases(workdir):
        onehot = L.one_hot_label(torch.from_numpy(case["label"])[None], 2)
        with torch.no_grad():
            want = L.binarize(vae(onehot)[0]).float().permute(0, 4, 1, 2, 3)
        np.testing.assert_array_equal(
            np.load(f"result/seg/0_{case['index']}_gt_recon.npy"),
            want.numpy())
