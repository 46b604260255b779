"""The port's source CLI (vae_segmentation_tpu_torch/cli/source_main.py)
and the chain it starts, on the CPU (``--device cpu``) at 32^3, full width,
with the augmentation warp on: ``vae_train`` then ``seg_train`` train two
outer epochs each (seg_train takes no step in the first, as the reference),
then the target CLI adapts from their two checkpoints. Also: the flags and
methods ported by ROADMAP items 11d and 11f (``--softrelu 1``,
``embed_train``, ``refine_vae``) run beside the flags ported before, and
the target CLI's ``--vae_forward_scale`` is accepted and changes nothing
(the JAX package's Joint always encodes with the mean latent)."""

import contextlib
import io
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

from vae_segmentation_tpu.core.config import parse_source_args as jparse
from vae_segmentation_tpu_torch.cli import source_main, target_main
from vae_segmentation_tpu_torch.core.checkpoint import save_checkpoint
from vae_segmentation_tpu_torch.core.config import parse_source_args
from vae_segmentation_tpu_torch.data.synthetic import write_synthetic_dataset
from vae_segmentation_tpu_torch.models import Embed, ShapeVAE
from vae_segmentation_tpu_torch.ops import reparam

torch.set_num_threads(2)

RECIPE = ["--train_list", "NIH_train", "--val_list", "NIH_val",
          "--data_path", "data/Multi_all.json", "--eval_epoch", "20",
          "--save_epoch", "800", "--max_epoch", "4800"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_source_cli")
    write_synthetic_dataset(str(root / "data"), n_train=3, n_val=2, size=40,
                            seed=0)
    old = os.getcwd()
    os.chdir(root)
    yield root
    os.chdir(old)


def _common(root, *extra):
    return ["--train_list", "NIH_train", "--val_list", "NIH_val",
            "--data_root", str(root / "data"),
            "--val_data_root", str(root / "data"),
            "--data_path", str(root / "data" / "Multi_all.json"),
            "--patch_size", "32", "32", "32", "-b", "2", "--eval_epoch", "1",
            "--save_epoch", "1", "--max_epoch", "2", "--num_workers", "2",
            "--device", "cpu", *extra]


def _scores(prefix, epoch):
    with open(os.path.join("tensorboard", prefix, f"score_{epoch}.json")) as f:
        return json.load(f)


def _checkpoints(prefix):
    return sorted(os.listdir(os.path.join("3dmodel", prefix)))


def _train_target(root, prefix, *extra):
    return target_main.main([
        prefix, "--method", "domain_adaptation", "--load_prefix", "seg",
        "--load_prefix_vae", "vae", "--domain_loss_type", "8",
        "--lambda_vae", "1.0", "--vae_decoder_dropout", "0.5",
        *_common(root, *extra)])


@pytest.fixture(scope="module")
def chain(workdir):
    """vae_train -> seg_train -> domain_adaptation; the stdout of each."""
    out = {}
    for name, run in (
            ("vae", lambda: source_main.main(
                ["vae", "--method", "vae_train", *_common(workdir)])),
            ("seg", lambda: source_main.main(
                ["seg", "--method", "seg_train", *_common(workdir)])),
            ("ad", lambda: _train_target(workdir, "ad"))):
        before = reparam.reparam_kl.launches
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            best = run()
        out[name] = (buf.getvalue(), best,
                     reparam.reparam_kl.launches - before)
    return out


def test_vae_train_trains_two_outer_epochs(chain):
    text, best, launches = chain["vae"]
    lines = [ln for ln in text.splitlines() if "] loss: " in ln]
    # 3 cases, batch 2, drop_last: one step per outer epoch, two loss terms
    assert [ln.split("]")[0] for ln in lines] == ["[  1,   1", "[  2,   1"]
    assert all(len(ln.split("loss: ")[1].split(", ")) == 2 for ln in lines)
    assert launches == 0        # the CPU runs the plain version
    for epoch in (0, 1):
        sc = _scores("vae", epoch)
        assert sorted(sc) == ["0", "1"]
        assert all(0.0 <= v <= 1.0 for v in sc.values())
    assert best == pytest.approx(max(np.mean(list(_scores("vae", e).values()))
                                     for e in (0, 1)))
    assert _checkpoints("vae") == ["best_model.ckpt", "model_epoch1.ckpt",
                                   "model_epoch2.ckpt"]
    sd = torch.load("3dmodel/vae/model_epoch2.ckpt")["model_state_dict"]
    assert "fc_std.weight" in sd and not any(k.startswith("Vae.")
                                             for k in sd)


def test_seg_train_skips_epoch_zero(chain):
    text, _, _ = chain["seg"]
    lines = [ln for ln in text.splitlines() if "] loss: " in ln]
    assert len(lines) == 1 and lines[0].startswith("[  2,   1] loss: ")
    assert len(lines[0].split("loss: ")[1].split(", ")) == 1
    assert _checkpoints("seg") == ["best_model.ckpt", "model_epoch1.ckpt",
                                   "model_epoch2.ckpt"]
    e1 = torch.load("3dmodel/seg/model_epoch1.ckpt")["model_state_dict"]
    e2 = torch.load("3dmodel/seg/model_epoch2.ckpt")["model_state_dict"]
    # epoch 1 took no step: its weights are the seed's; epoch 2 moved them
    assert not torch.equal(e1["out_block.weight"], e2["out_block.weight"])
    for epoch in (0, 1):
        assert all(0.0 <= v <= 1.0 for v in _scores("seg", epoch).values())


def test_target_adapts_from_both_checkpoints_with_the_warp(chain):
    text, best, _ = chain["ad"]
    assert "Loading checkpoint 3dmodel/seg/best_model.ckpt" in text
    assert "Loading checkpoint 3dmodel/vae/best_model.ckpt" in text
    assert text.count("] loss: ") == 1 and "[  2,   1] loss: " in text
    assert _checkpoints("ad") == ["best_model.ckpt", "model_epoch1.ckpt",
                                  "model_epoch2.ckpt"]
    sd = torch.load("3dmodel/ad/model_epoch2.ckpt")["model_state_dict"]
    vae = torch.load("3dmodel/vae/best_model.ckpt")["model_state_dict"]
    assert all(torch.equal(sd["Vae." + k], v) for k, v in vae.items())
    assert 0.0 <= best <= 1.0


def test_vae_forward_scale_is_accepted_and_changes_nothing(chain, workdir):
    _train_target(workdir, "fs", "--vae_forward_scale", "0.5")
    a = torch.load("3dmodel/ad/model_epoch2.ckpt")["model_state_dict"]
    b = torch.load("3dmodel/fs/model_epoch2.ckpt")["model_state_dict"]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert _scores("ad", 1) == _scores("fs", 1)


def test_load_prefix_starts_from_a_checkpoint(chain, workdir):
    """--load_prefix_vae (vae_train) and --load_prefix (seg_train) take the
    Vae.* / Seg.* of the adapted Joint's best checkpoint: --test_only then
    scores what the runs that wrote those weights scored."""
    def best_scores(prefix):
        return max((_scores(prefix, e) for e in (0, 1)),
                   key=lambda sc: np.mean(list(sc.values())))

    argv = _common(workdir, "--test_only")
    source_main.main(["vr", "--method", "vae_train", "--load_prefix_vae",
                      "ad", *argv])
    source_main.main(["sr", "--method", "seg_train", "--load_prefix", "ad",
                      *argv])
    assert _scores("vr", 0) == best_scores("vae")
    assert _scores("sr", 0) == best_scores("ad")
    assert not os.listdir(os.path.join("3dmodel", "vr"))


def test_the_warp_changes_the_step(workdir):
    """--no_aug leaves the batch unwarped: another loss than with the
    warp, from the same weights and batch."""
    argv = _common(workdir, "--max_epoch", "1")
    losses = []
    for extra in ([], ["--no_aug"]):
        source_main.main(["w" + str(len(extra)), "--method", "vae_train",
                          *argv, *extra])
        losses.append(_scores("w" + str(len(extra)), 0))
    assert losses[0] != losses[1]


def _checkpoints_for(extra):
    """The checkpoints a case loads: an Embed's ('j'), a VAE's ('vae')."""
    if "--load_prefix_joint" in extra and \
            not os.path.exists("3dmodel/j/best_model.ckpt"):
        save_checkpoint("3dmodel/j/best_model.ckpt", epoch=0,
                        model=Embed(bottleneck=256))
    if "--load_prefix_vae" in extra and \
            not os.path.exists("3dmodel/vae/best_model.ckpt"):
        save_checkpoint("3dmodel/vae/best_model.ckpt", epoch=0,
                        model=ShapeVAE(bottleneck=256))


# what was refused until ROADMAP items 11d and 11f landed, alone and beside
# the flags ported before (the Joint methods' --load_prefix_joint, the eval
# outputs, the profiler): each now trains one outer epoch and evaluates
@pytest.mark.parametrize("extra,item", [
    (["--method", "embed_train"], "item 11"),
    (["--method", "vae_train", "--softrelu", "1"], "item 11"),
    (["--method", "refine_vae", "--load_prefix_joint", "j"], "item 11"),
    (["--method", "embed_train", "--save_eval_result"], "item 11"),
    (["--method", "refine_vae", "--save_more_reference"], "item 11"),
    (["--method", "embed_train", "--load_prefix_vae", "vae"], "item 11"),
    (["--method", "vae_train", "--softrelu", "1", "--profile_dir", "prof"],
     "item 11"),
])
def test_unported_flags_and_methods_raise(workdir, extra, item):
    _checkpoints_for(extra)
    prefix = "u" + "_".join(a.strip("-") for a in extra)
    best = source_main.main([prefix, *_common(workdir), *extra,
                             "--max_epoch", "1"])
    scores = _scores(prefix, 0)
    assert sorted(scores) == ["0", "1"]
    assert all(0.0 <= v <= 1.0 for v in scores.values())
    assert best == pytest.approx(np.mean(list(scores.values())))
    assert "model_epoch1.ckpt" in _checkpoints(prefix)
    if "--profile_dir" in extra:
        assert os.path.exists(os.path.join("prof", "trace.json"))


@pytest.mark.parametrize("extra,item", [
    (["--method", "embed_train"], "item 11f"),
    (["--method", "refine_vae"], "item 11f"),
    (["--method", "vae_train", "--softrelu", "1"], "item 11d"),
    (["--method", "joint_train", "--softrelu", "1"], "item 11d"),
])
def test_refusals_name_their_item_letter(workdir, extra, item):
    """Each method and flag refused until its ROADMAP item (`item`) landed
    now runs (its eval, --test_only); --softrelu 1 changes only
    vae_train's model (its VAE's blocks soft), as in the JAX package."""
    built = []
    real = source_main._build_model

    def spy(cfg, n_class):
        built.append(real(cfg, n_class))
        return built[-1]

    prefix = "l" + "_".join(a.strip("-") for a in extra)
    with mock.patch.object(source_main, "_build_model", spy):
        source_main.main([prefix, *_common(workdir), *extra, "--test_only"])
    scores = _scores(prefix, 0)
    assert sorted(scores) == ["0", "1"]
    assert all(0.0 <= v <= 1.0 for v in scores.values())
    softs = {m.soft for m in built[0].modules() if hasattr(m, "soft")}
    assert softs == {extra[1] == "vae_train"}


@pytest.mark.parametrize("extra,match", [
    (["--method", "vae_train", "--load_prefix_joint", "j"], "Joint"),
    (["--method", "seg_train", "--load_prefix_joint", "j"], "Joint"),
    (["--method", "no_such_method"], "valid method"),
])
def test_flags_that_do_not_fit_the_method_raise(workdir, extra, match):
    with pytest.raises(ValueError, match=match):
        source_main.main(["x", *_common(workdir), *extra])


@pytest.mark.parametrize("method", ["seg_train", "vae_train"])
def test_spatial_shards_needs_a_world_of_ranks(workdir, method):
    """--spatial_shards is ported (ROADMAP item 9): in one process, with
    no world to split the volume over, it says to run under torchrun
    (tests/test_torch_dist_cli.py runs it there)."""
    with pytest.raises(ValueError, match="torchrun"):
        source_main.main(["x", *_common(workdir), "--method", method,
                          "--spatial_shards", "2"])


def test_source_config_matches_the_jax_package():
    """The recipe flags of scripts/source/*.bash parse alike."""
    for method in ("vae_train", "seg_train"):
        argv = ["p", "--method", method, "-G", "0", *RECIPE]
        got, want = vars(parse_source_args(argv)), vars(jparse(argv))
        assert got.pop("device") == "cuda"
        assert got == want
