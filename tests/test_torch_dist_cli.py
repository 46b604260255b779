"""Both CLIs of the port as a 2-rank (and a 4-rank) gloo world on the CPU at
32^3, full width, one training epoch each, as ``torchrun`` would run them
(``parallel.launch.spawn`` starts the world; the CLIs find it initialized):

  * ``source_main --method vae_train`` on the data axis (DP2, no flag): the
    loss lines and the checkpoints come from rank 0 alone (rank 1 runs in a
    directory of its own and writes nothing there);
  * ``target_main --spatial_shards 2`` (a 1 x 2 mesh): scores within
    chip_smoke.py phase 3's Dice gate (0.01) of the same run in one
    process; then ``--resume`` on both ranks from rank 0's checkpoint, and
    ``--test_only`` on the result;
  * at batch 2 in a 4-rank world the idle pairs are promoted to 'spatial'
    (the JAX package's message), and a rank outside a mesh says so."""

import json
import os

import pytest
import torch

import torch_dist_workers as W
from vae_segmentation_tpu_torch.core.checkpoint import save_checkpoint
from vae_segmentation_tpu_torch.data.synthetic import write_synthetic_dataset
from vae_segmentation_tpu_torch.models import Joint
from vae_segmentation_tpu_torch.parallel import launch

DICE_GATE = 0.01


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_cli")
    write_synthetic_dataset(str(root / "data"), n_train=2, n_val=2, size=40,
                            seed=0)
    model = Joint(n_class=2, bottleneck=256,
                  generator=torch.Generator().manual_seed(5))
    for d in ("r0", "r1", "one"):
        save_checkpoint(str(root / d / "3dmodel" / "seg" / "best_model.ckpt"),
                        epoch=0, model=model.Seg)
        save_checkpoint(str(root / d / "3dmodel" / "vae" / "best_model.ckpt"),
                        epoch=0, model=model)
    return root


def _common(root, *extra):
    return ["--train_list", "NIH_train", "--val_list", "NIH_val",
            "--data_root", str(root / "data"),
            "--val_data_root", str(root / "data"),
            "--data_path", str(root / "data" / "Multi_all.json"),
            "--patch_size", "32", "32", "32", "-b", "2", "--eval_epoch", "1",
            "--save_epoch", "1", "--num_workers", "0", "--device", "cpu",
            *extra]


def _target(root, prefix, *extra):
    return [prefix, "--method", "domain_adaptation", "--load_prefix", "seg",
            "--load_prefix_vae", "vae", "--domain_loss_type", "8",
            "--lambda_vae", "1.0", *_common(root, *extra)]


def _scores(d, prefix, epoch):
    with open(d / "tensorboard" / prefix / f"score_{epoch}.json") as f:
        return json.load(f)


def test_vae_train_on_the_data_axis(root):
    (best0, out0), (best1, out1) = launch.spawn(
        W.cli, 2, timeout=120.0,
        args=("source", ["dp", "--method", "vae_train",
                         *_common(root, "--max_epoch", "1")],
              [str(root / "r0"), str(root / "r1")]))
    assert "[  1,   1] loss: " in out0 and out1 == ""
    assert best1 == best0 and 0.0 <= best0 <= 1.0
    assert sorted(os.listdir(root / "r0" / "3dmodel" / "dp")) == \
        ["best_model.ckpt", "model_epoch1.ckpt"]
    assert not (root / "r1" / "3dmodel" / "dp").exists()
    assert not (root / "r1" / "tensorboard").exists()


def test_target_cli_on_a_spatial_axis_resumes_and_evaluates(root):
    """Two outer epochs (the first takes no step) with --spatial_shards 2,
    against one process; then a third resumed on both ranks from rank 0's
    model_epoch2.ckpt; then --test_only on it."""
    same = [str(root / "r0")] * 2
    (best0, out0), (best1, _) = launch.spawn(
        W.cli, 2, timeout=120.0,
        args=("target", _target(root, "sp", "--spatial_shards", "2",
                                "--max_epoch", "2"), same))
    assert "[  2,   1] loss: " in out0 and best1 == best0
    old = os.getcwd()
    os.chdir(root / "one")
    try:
        from vae_segmentation_tpu_torch.cli import target_main
        target_main.main(_target(root, "sp", "--max_epoch", "2"))
    finally:
        os.chdir(old)
    for epoch in (0, 1):
        got = _scores(root / "r0", "sp", epoch)
        want = _scores(root / "one", "sp", epoch)
        assert got.keys() == want.keys()
        assert all(abs(got[k] - want[k]) <= DICE_GATE for k in got), \
            (got, want)
    (_, out0), _ = launch.spawn(
        W.cli, 2, timeout=120.0,
        args=("target", _target(root, "sp", "--spatial_shards", "2",
                                "--max_epoch", "3", "--resume"), same))
    assert "Resumed from 3dmodel/sp/model_epoch2.ckpt at epoch 2" in out0
    assert "[  3,   1] loss: " in out0 and "[  2," not in out0
    (dsc, out0), (dsc1, _) = launch.spawn(
        W.cli, 2, timeout=120.0,
        args=("target", ["ev", "--method", "domain_adaptation",
                         "--test_only", "--load_prefix_joint", "sp",
                         "--spatial_shards", "2", *_common(root)], same))
    assert "validation result" in out0 and dsc1 == dsc and 0.0 <= dsc <= 1.0


def test_idle_pairs_are_promoted_and_outsiders_say_so(root, capsys):
    """Batch 2 on 4 ranks: mesh data=2 x spatial=2 (the JAX package's
    auto-promotion); batch 2 with --spatial_shards 1 on 3 ranks: rank 2 is
    outside the 2 x 1 mesh, does no work and says so."""
    d4 = [str(root / "r0")] * 4
    got = launch.spawn(W.cli, 4, timeout=120.0, args=(
        "target", ["ev4", "--method", "domain_adaptation", "--test_only",
                   "--load_prefix", "seg", "--load_prefix_vae", "vae",
                   *_common(root)], d4))
    assert "Auto-promoting 2 idle chips to spatial sharding: mesh data=2 x " \
           "spatial=2" in got[0][1]
    assert len({r[0] for r in got}) == 1
    got = launch.spawn(W.cli, 3, timeout=120.0, args=(
        "target", ["ev3", "--method", "domain_adaptation", "--test_only",
                   "--load_prefix", "seg", "--load_prefix_vae", "vae",
                   *_common(root)], d4[:3]))
    assert "WARNING: using 2 of 3 devices" in got[0][1]
    assert got[2][0] == 0.0 and got[0][0] == got[1][0]
