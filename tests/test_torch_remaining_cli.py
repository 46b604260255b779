"""The methods ROADMAP items 11d-11h brought to the port's CLIs, end to end
on the CPU (``--device cpu``, synthetic cases at 32^3, full width, the
warp on): the target CLI's ``vae_train --softrelu 1``,
``discriminator_train`` (its realism targets from ``score.json``) and
``domain_adaptation_dis``, the source CLI's ``embed_train`` (crop and
sliding-window eval) and ``refine_vae``; each trains and evaluates one or
two outer epochs and writes what the JAX CLIs write (``score_<epoch>.json``
with a score per case in [0, 1], the best and periodic checkpoints, a loss
line per step with the method's terms). What each method freezes does not
move. A load flag for a network the method has not raises ValueError;
the flags the JAX target CLI reads for domain_adaptation only are
ignored by its other methods."""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from vae_segmentation_tpu_torch.cli import source_main, target_main
from vae_segmentation_tpu_torch.core.checkpoint import (
    load_checkpoint, save_checkpoint)
from vae_segmentation_tpu_torch.data.pipeline import CaseDataset
from vae_segmentation_tpu_torch.data.synthetic import write_synthetic_dataset
from vae_segmentation_tpu_torch.data.transforms import parse_pan_index
from vae_segmentation_tpu_torch.eval.evaluate import (
    make_discriminator_eval_step)
from vae_segmentation_tpu_torch.models import (
    Embed, Joint2, SegUNet, ShapeEncoder, load_state)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_remaining_cli")
    write_synthetic_dataset(str(root / "data"), n_train=3, n_val=2, size=40,
                            seed=0)
    gen = torch.Generator().manual_seed(0)
    save_checkpoint(str(root / "3dmodel" / "seg" / "best_model.ckpt"),
                    epoch=0, model=SegUNet(generator=gen))
    save_checkpoint(str(root / "3dmodel" / "enc" / "best_model.ckpt"),
                    epoch=0, model=ShapeEncoder(bottleneck=256,
                                                generator=gen))
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
            "--save_epoch", "1", "--max_epoch", "1", "--num_workers", "0",
            "--device", "cpu", *extra]


def _run(main, argv):
    """(result, the loss lines' values) of a CLI run."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        best = main(argv)
    lines = re.findall(r"^\[\s*\d+,\s*\d+\] loss: (.*)$", out.getvalue(),
                       re.M)
    return best, [[float(v) for v in ln.split(", ")] for ln in lines], \
        out.getvalue()


def _scores(prefix, epoch):
    with open(os.path.join("tensorboard", prefix,
                           f"score_{epoch}.json")) as f:
        return {int(k): v for k, v in json.load(f).items()}


def _check_run(prefix, best, epochs):
    for e in range(epochs):
        scores = _scores(prefix, e)
        assert sorted(scores) == [0, 1]
        assert all(0.0 <= v <= 1.0 for v in scores.values())
    assert 0.0 <= best <= 1.0
    files = os.listdir(os.path.join("3dmodel", prefix))
    assert f"model_epoch{epochs}.ckpt" in files


def test_target_vae_train_softrelu(workdir):
    best, lines, _ = _run(target_main.main, [
        "tv", "--method", "vae_train", "--softrelu", "1",
        *_common(workdir)])
    _check_run("tv", best, 1)
    assert len(lines) == 1 and len(lines[0]) == 2     # dice, KL


def test_discriminator_train_reads_score_json(workdir):
    """A case absent from score.json scores 1.0; the eval's score is 1 -
    (target - the discriminator's score of the label)^2 per case."""
    with open(workdir / "data" / "Multi_all.json") as f:
        val = json.load(f)["NIH_val"]
    ids = ["".join(re.findall(r"\d+", e)) for e in val]
    with open(workdir / "data" / "score.json", "w") as f:
        json.dump({ids[0]: 0.25}, f)
    try:
        best, lines, _ = _run(target_main.main, [
            "dt", "--method", "discriminator_train", *_common(workdir)])
    finally:
        os.remove(workdir / "data" / "score.json")
    _check_run("dt", best, 1)
    assert len(lines) == 1 and len(lines[0]) == 1     # final_loss
    enc = load_state(ShapeEncoder(bottleneck=256),
                     load_checkpoint("3dmodel/dt/model_epoch1.ckpt"))
    ds = CaseDataset(val, str(workdir / "data"), parse_pan_index("1"),
                     (32, 32, 32))
    labels = torch.from_numpy(np.stack([ds[i]["label"] for i in (0, 1)]))
    want = make_discriminator_eval_step(enc.eval())(
        labels, torch.tensor([0.25, 1.0]))["score"]
    got = _scores("dt", 0)
    assert [got[0], got[1]] == pytest.approx(want.tolist(), abs=1e-6)


def test_domain_adaptation_dis_trains_the_seg_only(workdir):
    best, lines, out = _run(target_main.main, [
        "dd", "--method", "domain_adaptation_dis", "--load_prefix", "seg",
        "--load_prefix_encoder", "enc", "--lambda_vae", "1.0",
        "--pseudo_save_epoch", "1", *_common(workdir, "--max_epoch", "2")])
    _check_run("dd", best, 2)
    assert len(lines) == 1 and len(lines[0]) == 3     # epoch 0 skipped
    assert "Updating Network" in out
    sd = load_checkpoint("3dmodel/dd/model_epoch2.ckpt")["model_state_dict"]
    enc = load_checkpoint("3dmodel/enc/best_model.ckpt")["model_state_dict"]
    seg = load_checkpoint("3dmodel/seg/best_model.ckpt")["model_state_dict"]
    assert all(torch.equal(sd["Dis." + k], v) for k, v in enc.items())
    assert not torch.equal(sd["Seg.out_block.weight"],
                           seg["out_block.weight"])
    # its eval from the checkpoint: the crop eval of the Joint2's Seg
    dsc = target_main.main([
        "dd_ev", "--method", "domain_adaptation_dis", "--test_only",
        "--load_prefix_joint", "dd", *_common(workdir)])
    assert 0.0 <= dsc <= 1.0
    model = Joint2(bottleneck=256)
    load_state(model, "3dmodel/dd/best_model.ckpt")


def test_embed_train_then_refine_vae(workdir):
    """embed_train (sliding-window eval) then refine_vae from its
    checkpoint: the Embed's VAE stays frozen in embed_train and the
    Encoder (enc_on 0 at outer epoch 0) unmoved; refine_vae moves the
    VAE's decoder only."""
    best, lines, _ = _run(source_main.main, [
        "em", "--method", "embed_train", "--eval_mode", "sliding_window",
        *_common(workdir)])
    _check_run("em", best, 1)
    assert len(lines) == 1 and len(lines[0]) == 5
    start = Embed(bottleneck=256,
                  generator=torch.Generator().manual_seed(0)).state_dict()
    em = load_checkpoint("3dmodel/em/model_epoch1.ckpt")["model_state_dict"]
    for k, v in em.items():
        if k.startswith(("Encoder.", "Vae.")):
            assert torch.equal(v, start[k]), k
    assert not torch.equal(em["Fusion.out_block.weight"],
                           start["Fusion.out_block.weight"])
    best, lines, _ = _run(source_main.main, [
        "rv", "--method", "refine_vae", "--load_prefix_joint", "em",
        *_common(workdir)])
    _check_run("rv", best, 1)
    assert len(lines) == 1 and len(lines[0]) == 3
    rv = load_checkpoint("3dmodel/rv/model_epoch1.ckpt")["model_state_dict"]
    frozen = ("Vae.in_block.", "Vae.down", "Vae.fc_mean.", "Vae.fc_std.",
              "Encoder.", "Fusion.")
    for k, v in rv.items():
        if k.startswith(frozen):
            assert torch.equal(v, em[k]), k
    assert not torch.equal(rv["Vae.out_block.weight"],
                           em["Vae.out_block.weight"])


@pytest.mark.parametrize("main,extra,match", [
    ("target", ["--method", "domain_adaptation", "--load_prefix_encoder",
                "enc"], "ShapeEncoder"),
    ("target", ["--method", "vae_train", "--load_prefix_encoder", "enc"],
     "ShapeEncoder"),
    ("target", ["--method", "discriminator_train", "--load_prefix", "seg"],
     "SegUNet"),
    ("source", ["--method", "embed_train", "--load_prefix", "seg"],
     "SegUNet"),
])
def test_flags_for_what_the_method_has_not_raise(workdir, main, extra,
                                                 match):
    with pytest.raises(ValueError, match=match):
        (target_main if main == "target" else source_main).main(
            ["x", *_common(workdir), *extra])


# flags the JAX target CLI reads for domain_adaptation only and ignores
# with the other methods (cli/target_main.py:188, 271-284 of the JAX
# package): accepted, and the model, its eval and the finetune are those
# of the run without them (no checkpoint "vae" exists, so a load would
# raise)
@pytest.mark.parametrize("method,extra", [
    ("vae_train", ["--load_prefix_vae", "vae"]),
    ("domain_adaptation_dis", ["--load_prefix_vae", "vae"]),
    ("vae_train", ["--val_finetune", "1"]),
    ("domain_adaptation_dis", ["--val_finetune", "1", "--test_only",
                               "--analysis_figure_name", "fig"]),
    ("discriminator_train", ["--pseudo_list", "NIH_train"]),
])
def test_flags_of_domain_adaptation_change_no_other_method(workdir, method,
                                                           extra):
    built = []
    for argv in ([], extra):
        cfg = target_main.parse_target_args(
            ["x", *_common(workdir), "--method", method, *argv])
        target_main._check_supported(cfg)
        model, teacher = target_main._build_models(
            cfg, 2, torch.device("cpu"))
        built.append(model.state_dict())
        if method in target_main.ADAPT_METHODS:
            steps = target_main.EvalSteps(cfg, 2, torch.device("cpu"),
                                          model, teacher)
            assert steps.finetune is None and steps.analysis is None
    assert built[0].keys() == built[1].keys()
    assert all(torch.equal(v, built[1][k]) for k, v in built[0].items())
