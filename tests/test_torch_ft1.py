"""ft1 test-time training and the sliding-window eval in the port's CLIs
(vae_segmentation_tpu_torch/cli/target_main.py, cli/source_main.py) on the
CPU at 32^3, full width: the per-case finetune loop leaves the student as
it was and starts every case from it; the finetune copy trains its whole
Seg whatever --fix_layer says; ``score_noft_<epoch>.json`` holds the plain
scores, on the crop path and composed with the full-volume sweep; training
runs finetune from outer epoch 1; the source CLI sweeps seg_train and keeps
vae_train on the crop eval; the flags of scripts/target/
domain_msd_dh_ft1.bash parse as the JAX package parses them and run.
The finetune step itself is held against the JAX package's in
tests/test_torch_ft1_step.py."""

import json
import os
import shlex

import numpy as np
import pytest
import torch

from vae_segmentation_tpu.core.config import parse_target_args as jparse
from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch.cli import common, source_main, target_main
from vae_segmentation_tpu_torch.core.checkpoint import save_checkpoint
from vae_segmentation_tpu_torch.core.config import parse_target_args
from vae_segmentation_tpu_torch.data.synthetic import write_synthetic_dataset

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_ft1")
    write_synthetic_dataset(str(root / "data"), n_train=3, n_val=2, size=40,
                            seed=0)
    # the MSD recipe's lists, labels {1, 2} -> 1 (--pan_index 10), through
    # the lists/ join of --data_path data/Multi_all.json
    os.makedirs(root / "lists" / "data")
    write_synthetic_dataset(str(root / "msd"), n_train=3, n_val=2, size=40,
                            seed=1, labels=(1, 2), train_key="MSD_train",
                            val_key="MSD_val",
                            manifest_name="../lists/data/Multi_all.json")
    joint = pm.Joint(n_class=2, bottleneck=256,
                     generator=torch.Generator().manual_seed(0))
    for prefix, net in (("joint", joint), ("seg", joint.Seg),
                        ("vae", joint), ("seg_nih", joint.Seg),
                        ("vae_nih", joint)):
        save_checkpoint(str(root / "3dmodel" / prefix / "best_model.ckpt"),
                        epoch=0, model=net)
    old = os.getcwd()
    os.chdir(root)
    yield root
    os.chdir(old)


def _data(root):
    return ["--val_list", "NIH_val", "--val_data_root", str(root / "data"),
            "--data_path", str(root / "data" / "Multi_all.json"),
            "--patch_size", "32", "32", "32", "--device", "cpu"]


def _eval(root, prefix, *extra):
    return target_main.main([prefix, "--method", "domain_adaptation",
                             "--test_only", "--load_prefix_joint", "joint",
                             *_data(root), *extra])


def _train(root, prefix, *extra):
    return target_main.main([
        prefix, "--method", "domain_adaptation", "--no_aug",
        "--load_prefix", "seg", "--load_prefix_vae", "vae",
        "--train_list", "NIH_train", "--data_root", str(root / "data"),
        "-b", "2", "--eval_epoch", "1", "--save_epoch", "1",
        "--max_epoch", "2", "--num_workers", "2", "--domain_loss_type", "8",
        "--lambda_vae", "1.0", "--vae_decoder_dropout", "0.5",
        *_data(root), *extra])


def _scores(prefix, name="score", epoch=0):
    path = os.path.join("tensorboard", prefix, f"{name}_{epoch}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _state(net):
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def _flags(net):
    return {k: p.requires_grad for k, p in net.named_parameters()}


@pytest.fixture()
def spy(monkeypatch):
    """Records, at every finetune step, the ft copy's weights, flags and
    optimizer; and the student before and after each eval."""
    rec = {"steps": [], "evals": []}
    real_step = target_main.make_adapt_step

    def make_adapt_step(cfg, variant="train"):
        step = real_step(cfg, variant=variant)
        if variant != "finetune":
            return step

        def spied(model, teacher, opt, image, label, gen, sched):
            rec["steps"].append({
                "state": _state(model), "flags": _flags(model),
                "momentum": [g["momentum"] for g in opt.param_groups],
                "n_trainable": sum(len(g["params"])
                                   for g in opt.param_groups),
                "batch": image.shape[0]})
            return step(model, teacher, opt, image, label, gen, sched)
        return spied

    for name in ("_crop_eval", "_sliding_window_eval"):
        real = getattr(target_main, name)

        def wrapped(*args, _real=real, **kw):
            model = args[-3]
            before = (_state(model), _flags(model))
            out = _real(*args, **kw)
            rec["evals"].append((before, (_state(model), _flags(model)),
                                 model))
            return out
        monkeypatch.setattr(target_main, name, wrapped)
    monkeypatch.setattr(target_main, "make_adapt_step", make_adapt_step)
    return rec


def _same(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_the_loop_leaves_the_student_and_starts_each_case_from_it(
        workdir, spy):
    """--test_only --val_finetune 1 over 2 cases: one finetune step a case
    on batch 1, each starting from the student's weights (case 2 not from
    case 1's finetuned copy); the student's weights and requires_grad flags
    after the loop are those before it; score_noft_0 equals a plain
    --test_only run's score_0, and score_0 differs from it."""
    _eval(workdir, "ft", "--val_finetune", "1")
    assert len(spy["steps"]) == 2 and len(spy["evals"]) == 1
    (state0, flags0), (state1, flags1), student = spy["evals"][0]
    assert _same(state0, state1) and flags0 == flags1
    for s in spy["steps"]:
        assert _same(s["state"], state0)
        assert s["batch"] == 1 and s["momentum"] == [0.0]
    _eval(workdir, "plain")
    plain = _scores("plain")
    assert sorted(plain) == ["0", "1"]
    assert _scores("ft", "score_noft") == plain
    assert _scores("ft").keys() == plain.keys() and _scores("ft") != plain
    assert _scores("plain", "score_noft") is None


def test_fix_layer_does_not_reach_the_finetune_copy(workdir, spy):
    """Training with --fix_layer freezes all of the student but its head;
    the ft copy trains its whole Seg (the JAX package builds its finetune
    optimizer from freeze_vae alone) and the student keeps its flags."""
    _train(workdir, "fx", "--fix_layer", "--val_finetune", "1")
    assert len(spy["steps"]) == 2          # epoch 1 only, 2 cases
    for s in spy["steps"]:
        assert all(v == k.startswith("Seg.") for k, v in s["flags"].items())
        assert s["n_trainable"] == sum(k.startswith("Seg.")
                                       for k in s["flags"])
    for (state0, flags0), (state1, flags1), _ in spy["evals"]:
        assert _same(state0, state1) and flags0 == flags1
        assert {k for k, v in flags0.items() if v} == {
            k for k in flags0 if k.startswith(("Seg.up5.", "Seg.out_block."))}


def test_training_finetunes_from_outer_epoch_one(workdir, spy):
    """Two outer epochs with --val_finetune 1: epoch 0 (no step taken)
    evaluates without ft1, epoch 1 with it."""
    _train(workdir, "tr", "--val_finetune", "1")
    assert _scores("tr", "score_noft", 0) is None
    noft = _scores("tr", "score_noft", 1)
    assert sorted(noft) == sorted(_scores("tr", epoch=1)) == ["0", "1"]
    assert all(0.0 <= v <= 1.0 for v in noft.values())
    assert len(spy["steps"]) == 2


def test_sliding_window_composes_with_ft1(workdir, spy):
    """--eval_mode sliding_window --val_finetune 1 --test_only: each case
    finetunes on its ROI crop (batch 1, 32^3) before its sweep; score_0 and
    score_noft_0 have the crop path's keys; score_noft_0 equals the plain
    sweep's score_0; the student is left as it was."""
    _eval(workdir, "swft", "--eval_mode", "sliding_window",
          "--val_finetune", "1", "--postprocess",
          "--postprocess_min_voxels", "10")
    _eval(workdir, "sw", "--eval_mode", "sliding_window", "--postprocess",
          "--postprocess_min_voxels", "10")
    assert sorted(_scores("swft")) == sorted(_scores("swft", "score_noft")) \
        == ["0", "1"]
    assert _scores("swft", "score_noft") == _scores("sw")
    assert all(0.0 <= v <= 1.0 for v in _scores("swft").values())
    assert [tuple(s["state"]["Seg.out_block.weight"].shape)
            for s in spy["steps"]] == [(2, 8, 3, 3, 3)] * 2
    (state0, flags0), (state1, flags1), _ = spy["evals"][0]
    assert _same(state0, state1) and flags0 == flags1
    for s in spy["steps"]:
        assert _same(s["state"], state0) and s["batch"] == 1


def test_source_cli_sweeps_seg_train_and_keeps_vae_train_on_crops(
        workdir, monkeypatch):
    calls = []
    real = common.run_sliding_window_eval
    monkeypatch.setattr(common, "run_sliding_window_eval",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    argv = ["--train_list", "NIH_train", "--data_root",
            str(workdir / "data"), "-b", "2", "--eval_epoch", "1",
            "--save_epoch", "1", "--max_epoch", "1", "--num_workers", "2",
            "--eval_mode", "sliding_window", *_data(workdir)]
    source_main.main(["ssw", "--method", "seg_train", *argv])
    assert len(calls) == 1
    assert sorted(_scores("ssw")) == ["0", "1"]
    source_main.main(["vsw", "--method", "vae_train", *argv])
    assert len(calls) == 1
    assert sorted(_scores("vsw")) == ["0", "1"]


def _recipe_argv(root):
    """The argument list of scripts/target/domain_msd_dh_ft1.bash."""
    with open(os.path.join(REPO, "scripts", "target",
                           "domain_msd_dh_ft1.bash")) as f:
        text = f.read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if "main_target.py" in ln)
    line = line.replace("$1", "0").replace(
        "${MSD_DATA_ROOT:-../nih_data/numpy_data/}", str(root / "msd"))
    return shlex.split(line.split("main_target.py", 1)[1])


def test_ft1_recipe_flags_parse_and_run(workdir):
    """The recipe's flags parse as in the JAX package; with the sizes cut
    (32^3, batch 2, two outer epochs of --eval_epoch 2) it trains, finetunes
    in outer epoch 1 and writes both score files."""
    argv = _recipe_argv(workdir)
    assert "--val_finetune" in argv
    got, want = vars(parse_target_args(argv)), vars(jparse(argv))
    assert got.pop("device") == "cuda"
    assert got == want
    target_main.main(argv + ["--patch_size", "32", "32", "32", "-b", "2",
                             "--max_epoch", "4", "--save_epoch", "4",
                             "--num_workers", "2", "--device", "cpu"])
    prefix = argv[0]
    assert _scores(prefix, "score_noft", 0) is None
    for name in ("score", "score_noft"):
        sc = _scores(prefix, name, 1)
        assert sorted(sc) == ["0", "1"]
        assert all(0.0 <= v <= 1.0 for v in sc.values())
