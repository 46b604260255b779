"""The port's observability (``vae_segmentation_tpu_torch/obs/``) against
the JAX package's (``vae_segmentation_tpu/obs/``) on the CPU: ``make_grid``
and ``mid_slice_panel`` bit for bit on seeded inputs (fewer images than a
row, a last row part-filled, [N, 1, H, W], tensors as well as arrays); the
``Saver``'s ``name value it`` lines equal to the JAX Saver's on the same
calls, its event files, its lines without tensorboardX (said once), and
its values read on display steps only; ``profile_trace``'s Chrome trace;
the analysis figures' files and matplotlib checked at start-up; and
--debug_nans: a planted NaN stops each CLI with FloatingPointError naming
the loss term, where the same run without the flag completes."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from vae_segmentation_tpu.obs import draw as jdraw
from vae_segmentation_tpu.obs import saver as jsaver
from vae_segmentation_tpu_torch.cli import common, source_main, target_main
from vae_segmentation_tpu_torch.core.checkpoint import save_checkpoint
from vae_segmentation_tpu_torch.core.config import parse_source_args
from vae_segmentation_tpu_torch.data.synthetic import write_synthetic_dataset
from vae_segmentation_tpu_torch.models import Joint
from vae_segmentation_tpu_torch.obs import draw, saver, timing
from vae_segmentation_tpu_torch.train import steps

torch.set_num_threads(2)


@pytest.mark.parametrize("shape,nrow", [
    ((3, 6, 5), 5),       # fewer images than a row
    ((7, 6, 5), 5),       # the last row part-filled
    ((6, 1, 6, 5), 5),    # [N, 1, H, W]
    ((10, 4, 4), 5),
    ((7, 3, 8), 3),
])
def test_make_grid_matches_jax(shape, nrow):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = jsaver.make_grid(x, nrow=nrow)
    np.testing.assert_array_equal(saver.make_grid(x, nrow=nrow), want)
    np.testing.assert_array_equal(
        saver.make_grid(torch.from_numpy(x), nrow=nrow), want)


def test_mid_slice_panel_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(2, 6, 5, 8)).astype(np.float32)
    b = rng.normal(size=(2, 6, 5, 7, 2)).astype(np.float32)
    c = rng.random((1, 6, 5, 8, 1)).astype(np.float32)
    want = jsaver.mid_slice_panel(a, b[..., 1], c, b)
    got = saver.mid_slice_panel(torch.from_numpy(a),
                                torch.from_numpy(b)[..., 1], c,
                                torch.from_numpy(b))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (4, 6, 5)


def _drive(s):
    panel = np.random.default_rng(2).random((3, 6, 5)).astype(np.float32)
    for it in range(25):
        s.write_display(it, [("dice_loss", 0.5 + it / 100), ("kl_loss", it)],
                        {"venous_pancreas_display": panel})
    s.write_display(30, [("val_result", 0.7)], {"p": panel},
                    force_write=True)
    s.write_display(3, [("finetune_dice_loss", 1.0)], force_write=True,
                    verbose=False)
    s.close()


def test_saver_prints_the_jax_lines_and_writes_events(tmp_path, capsys):
    _drive(jsaver.Saver(str(tmp_path / "jax"), display_freq=10))
    want = capsys.readouterr().out
    _drive(saver.Saver(str(tmp_path / "port"), display_freq=10))
    got = capsys.readouterr().out
    assert got == want
    assert got.splitlines()[:2] == ["dice_loss 0.59 9", "kl_loss 9.0 9"]
    assert len(got.splitlines()) == 5
    assert any(f.startswith("events.out.tfevents")
               for f in os.listdir(tmp_path / "port"))


def test_saver_without_tensorboardx_still_prints(tmp_path, capsys,
                                                 monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    monkeypatch.setattr(saver, "_NOTICE", [])
    _drive(jsaver.Saver(str(tmp_path / "jax"), display_freq=10))
    want = capsys.readouterr().out
    for name in ("a", "b"):
        s = saver.Saver(str(tmp_path / name), display_freq=10)
        assert s.writer is None
        _drive(s)
    out = capsys.readouterr().out.splitlines()
    notice = [ln for ln in out if "tensorboardX is not installed" in ln]
    assert len(notice) == 1 and out[0] == notice[0]
    assert "\n".join(out[1:]) + "\n" == want * 2
    assert os.listdir(tmp_path / "a") == []


class _Lazy:
    """A value that counts its reads (a tensor on the card: a host sync)."""

    reads = 0

    def __float__(self):
        _Lazy.reads += 1
        return 0.25


def test_saver_reads_values_on_display_steps_only(tmp_path, capsys):
    s = saver.Saver(str(tmp_path), display_freq=10)
    for it in range(20):
        s.write_display(it, [("x", _Lazy())])
    s.write_display(0, [("y", _Lazy())], force_write=True, verbose=False)
    s.close()
    assert _Lazy.reads == 3
    assert capsys.readouterr().out.splitlines() == ["x 0.25 9", "x 0.25 19"]
    null = saver.NullSaver()
    null.write_display(9, [("x", _Lazy())], force_write=True)
    assert _Lazy.reads == 3


def test_profile_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    with timing.profile_trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    with timing.profile_trace(None):
        pass
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert timing.trace_path("d") == os.path.join("d", "trace_rank1.json")
    t = timing.StepTimer()
    t.tick()
    t.tick(2)
    assert t.count == 3 and t.rate > 0


def test_figures_are_the_jax_files(tmp_path, monkeypatch):
    data = {0: [0.2, 0.3], 1: [0.4, 0.5], 2: [0.1, 0.9]}
    names = {}
    for who, mod in (("jax", jdraw), ("port", draw)):
        monkeypatch.chdir(tmp_path)
        os.makedirs(who)
        monkeypatch.chdir(tmp_path / who)
        mod.scatter_plot(data, "t", "Pseudo_loss", "Recon_loss")
        mod.scatter_plot_multi(data, data, "analysis")
        names[who] = sorted(os.listdir(mod.FIGURE_DIR))
    assert names["port"] == names["jax"] == ["analysis.jpg", "t.jpg"]


def test_analysis_figures_need_matplotlib_at_start_up(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        draw.require_matplotlib()
    # raised before any data is read
    with pytest.raises(ImportError, match="analysis_figure_name"):
        target_main.main(["x", "--method", "domain_adaptation",
                          "--test_only", "--analysis_figure_name", "t",
                          "--val_data_root", "/nonexistent", "--device",
                          "cpu"])


# ---- --debug_nans


def test_nan_guard_names_the_term_and_is_off_without_the_flag():
    argv = ["x", "--device", "cpu"]
    off, on = parse_source_args(argv), parse_source_args(
        argv + ["--debug_nans"])
    nan = torch.tensor(float("nan"))
    with common.nan_guard(off, "here"):
        assert not torch.is_anomaly_enabled()
        steps._check_terms(dice_loss=nan)
    with common.nan_guard(on, "epoch 3, iteration 2"):
        assert torch.is_anomaly_enabled()
        steps._check_terms(dice_loss=torch.tensor(0.5))
        with pytest.raises(FloatingPointError,
                           match="kl_loss = nan at epoch 3, iteration 2"):
            steps._check_terms(dice_loss=torch.tensor(0.5), kl_loss=nan)
    common.check_scores(off, {0: float("nan")}, "e")
    common.check_scores(on, {0: 0.5, 1: 0.25}, "e")
    with pytest.raises(FloatingPointError, match="score of case 1 = inf"):
        common.check_scores(on, {0: 0.5, 1: float("inf")}, "e")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_obs")
    write_synthetic_dataset(str(root / "data"), n_train=2, n_val=1, size=40,
                            seed=0)
    joint = Joint(n_class=2, bottleneck=256,
                  generator=torch.Generator().manual_seed(0))
    save_checkpoint(str(root / "3dmodel" / "s" / "best_model.ckpt"),
                    epoch=0, model=joint.Seg)
    save_checkpoint(str(root / "3dmodel" / "v" / "best_model.ckpt"),
                    epoch=0, model=joint.Vae)
    old = os.getcwd()
    os.chdir(root)
    yield root
    os.chdir(old)


def _argv(root, prefix, *extra):
    return [prefix, "--train_list", "NIH_train", "--val_list", "NIH_val",
            "--data_root", str(root / "data"),
            "--val_data_root", str(root / "data"),
            "--data_path", str(root / "data" / "Multi_all.json"),
            "--patch_size", "32", "32", "32", "-b", "2", "--eval_epoch", "1",
            "--save_epoch", "1", "--max_epoch", "2", "--num_workers", "0",
            "--no_aug", "--load_prefix", "s", "--load_prefix_vae", "v",
            "--device", "cpu", *extra]


@pytest.mark.parametrize("cli,argv,term", [
    (source_main, ["--method", "joint_train"], "recon_loss"),
    (target_main, ["--method", "domain_adaptation", "--domain_loss_type",
                   "8"], "recon_loss"),
])
def test_debug_nans_stops_at_a_planted_nan(workdir, monkeypatch, capsys,
                                           cli, argv, term):
    """A NaN planted in the train ingest's normalization: with --debug_nans
    the first step raises FloatingPointError naming its first loss term
    and where; the same run without the flag trains through to its
    scores (NaN losses printed)."""
    real = common.intensity_normalize
    monkeypatch.setattr(common, "intensity_normalize",
                        lambda x: real(x) * float("nan"))
    prefix = "nan_" + cli.__name__.rsplit(".", 1)[1]
    cli.main(_argv(workdir, prefix, *argv))
    assert "nan" in capsys.readouterr().out
    assert os.path.exists(f"tensorboard/{prefix}/score_1.json")
    where = "epoch 1" if cli is source_main else "epoch 2"
    with pytest.raises(FloatingPointError,
                       match=f"loss term {term} = nan at {where}, "
                             "iteration 1"):
        cli.main(_argv(workdir, prefix + "_dbg", *argv, "--debug_nans"))
