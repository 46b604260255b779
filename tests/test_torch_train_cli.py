"""The port's adaptation loss dispatch, the dropout graph of its models, its
train loader and the training loop of its CLI (``--method domain_adaptation
--no_aug --device cpu``) against the JAX package on the CPU. The whole train
step is held in tests/test_torch_train.py, whose seeded cases this file
shares. Tolerances stand at each test."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_train import NC, _case, _jax_joint, _port_pair
from vae_segmentation_tpu.data.pipeline import Loader as JLoader
from vae_segmentation_tpu.models import unet as junet
from vae_segmentation_tpu.models import vae as jvae
from vae_segmentation_tpu.ops import losses as JL
from vae_segmentation_tpu.train import steps as jsteps
from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch.cli import target_main
from vae_segmentation_tpu_torch.core.checkpoint import save_checkpoint
from vae_segmentation_tpu_torch.data import pipeline as pp
from vae_segmentation_tpu_torch.data.synthetic import write_synthetic_dataset
from vae_segmentation_tpu_torch.models import unet as punet
from vae_segmentation_tpu_torch.models import vae as pvae
from vae_segmentation_tpu_torch.ops import losses as PL
from vae_segmentation_tpu_torch.train import steps as psteps

torch.set_num_threads(2)


# ---- (b) adapt_loss


def _jax_adapt(cfg_kw, sched, variant, r, f, klv, sq):
    cfg = jsteps.AdaptConfig(**cfg_kw)
    jsched = {"lambda_vae": jnp.float32(sched["lambda_vae"]),
              "warmup_scale": jnp.float32(sched["warmup_scale"]),
              "turn_phase": jnp.int32(sched["turn_phase"])}
    return float(jsteps.adapt_loss(jnp.float32(r), jnp.float32(f),
                                   jnp.float32(klv), jnp.float32(sq), cfg,
                                   jsched, variant=variant))


def _port_adapt(cfg_kw, sched, variant, r, f, klv, sq):
    cfg = psteps.AdaptConfig(**cfg_kw)
    return float(psteps.adapt_loss(torch.tensor(r), torch.tensor(f),
                                   torch.tensor(klv), torch.tensor(sq), cfg,
                                   sched, variant=variant))


@pytest.mark.parametrize("loss_type", [0, 8, 9, 10, 11, 12, 13, 14, 15, 16])
def test_adapt_loss_matches_jax(loss_type):
    """Every domain_loss_type in the three variants, with and without kl,
    at recon losses in all four dh buckets and lambdas on both sides of
    1 (and the lambda >= 1000 recon-only mode of the pseudo variant)."""
    n = 0
    for variant in ("train", "finetune", "pseudo"):
        for kl in (False, True):
            for r in (0.05, 0.2, 0.27, 0.6):
                for lam in (0.4, 1.0, 2000.0):
                    cfg_kw = dict(domain_loss_type=loss_type, kl=kl)
                    sched = dict(psteps.default_sched(lam), warmup_scale=0.5)
                    args = (cfg_kw, sched, variant, r, 0.35, 3.7, 0.21)
                    want = _jax_adapt(*args)
                    assert _port_adapt(*args) == pytest.approx(
                        want, rel=1e-6, abs=1e-7), args
                    n += 1
    assert n == 72


@pytest.mark.parametrize("switch", ["only_pseudo", "turn_phase_0",
                                    "turn_phase_1", "warmup_done_kl"])
def test_adapt_loss_switches_match_jax(switch):
    cfg_kw, sched = dict(domain_loss_type=0), psteps.default_sched(0.7)
    if switch == "only_pseudo":
        cfg_kw["only_pseudo"] = True
    elif switch.startswith("turn"):
        cfg_kw["turn_enabled"] = True
        sched["turn_phase"] = int(switch[-1])
    else:
        cfg_kw["kl"] = True     # past warmup: + 2e-5 * lambda * KL
    for variant in ("train", "finetune"):
        args = (cfg_kw, sched, variant, 0.3, 0.4, 5.0, 0.0)
        assert _port_adapt(*args) == pytest.approx(_jax_adapt(*args),
                                                   rel=1e-6), args


def test_default_sched_and_bucket_lambda_match_jax():
    assert {k: float(v) for k, v in jsteps.default_sched(0.3).items()} == \
        pytest.approx(psteps.default_sched(0.3))
    for r in (0.0, 0.1499, 0.15, 0.2249, 0.225, 0.2999, 0.3, 0.9):
        want = float(jsteps._bucket_lambda(jnp.float32(r), 0.5))
        got = float(psteps._bucket_lambda(torch.tensor(r), 0.5))
        assert got == pytest.approx(want, rel=1e-6), r


def test_confident_binarize_and_kl_match_jax(rng):
    a = rng.random((2, 5, 4, 3, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        PL.confident_binarize(torch.from_numpy(a)).numpy(),
        np.asarray(JL.confident_binarize(jnp.asarray(a))))
    mean = rng.normal(size=(3, 8)).astype(np.float32)
    std = np.abs(rng.normal(size=(3, 8))).astype(np.float32)
    std[0, 0] = 0.0                                    # the ReLU'd std
    np.testing.assert_allclose(
        PL.kl_loss(torch.from_numpy(mean), torch.from_numpy(std)).numpy(),
        np.asarray(JL.kl_loss(jnp.asarray(mean), jnp.asarray(std))),
        rtol=1e-6)


# ---- (e) the dropout graph, masks from numpy


def _numpy_masks(seed):
    """mc_dropout replacements for both packages that draw the keep mask
    of the i-th call from numpy, so the two models drop the same
    elements."""
    counters = {"jax": 0, "port": 0}

    def mask(which, shape, rate):
        rng = np.random.default_rng((seed, counters[which]))
        counters[which] += 1
        return rng.random(shape) >= rate

    def jax_drop(module, x, rate):
        if not rate:
            return x
        keep = jnp.asarray(mask("jax", x.shape, rate))
        return jnp.where(keep, x / (1.0 - rate), jnp.zeros_like(x))

    def port_drop(x, rate, generator):
        if not rate:
            return x
        keep = torch.from_numpy(mask("port", tuple(x.shape), rate))
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))

    return jax_drop, port_drop, counters


@pytest.mark.parametrize("seg_dropout", [0.0, 0.3])
def test_dropout_graph_matches_jax(monkeypatch, seg_dropout):
    """Joint(dropout=True) with the same numpy keep masks in both
    packages: decoder dropout after up1..up4, up5's norm applied inline
    before the last dropout and the head without prologue; with
    seg_dropout also the Seg decoder's and head's dropouts before the
    softmax. pred and recon within 1e-4, the three Dice losses within
    1e-5."""
    jax_drop, port_drop, counters = _numpy_masks(11)
    monkeypatch.setattr(jvae, "mc_dropout", jax_drop)
    monkeypatch.setattr(junet, "mc_dropout", jax_drop)
    monkeypatch.setattr(pvae, "mc_dropout", port_drop)
    monkeypatch.setattr(punet, "mc_dropout", port_drop)
    params, batches = _case(32, seed=6, n_batches=1)
    img, lab = batches[0]
    kw = dict(vae_decoder_dropout=0.5, seg_dropout=seg_dropout)
    want = _jax_joint(32, **kw).apply(
        {"params": params}, jnp.asarray(img)[..., None], dropout=True,
        rngs={"dropout": jax.random.PRNGKey(0)})
    student, _ = _port_pair(params, 32, **kw)
    with torch.no_grad():
        got = student(torch.from_numpy(img)[..., None], dropout=True)
    assert counters["jax"] == counters["port"] == (10 if seg_dropout else 5)
    for name, g, w in zip(("pred", "recon"), got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-4, name
    onehot_j = JL.one_hot_label(jnp.asarray(lab), NC)
    onehot_p = PL.one_hot_label(torch.from_numpy(lab), NC)
    for tj, tp in ((want[1], got[1]), (onehot_j, onehot_p)):
        dj = float(JL.avg_dsc(want[0], tj, botindex=1, topindex=NC))
        dp = float(PL.multi_soft_dice(got[0], (tp,))[0][:, 1:NC].mean())
        assert dp == pytest.approx(dj, abs=1e-5)
    # without the dropout flag the masks are not drawn
    with torch.no_grad():
        student(torch.from_numpy(img)[..., None])
    assert counters["port"] == (10 if seg_dropout else 5)


def test_mc_dropout_draws_from_the_generator():
    from vae_segmentation_tpu_torch.models.blocks import mc_dropout

    x = torch.ones(4, 8, 8, 8, 3)
    a = mc_dropout(x, 0.5, torch.Generator().manual_seed(1))
    b = mc_dropout(x, 0.5, torch.Generator().manual_seed(1))
    c = mc_dropout(x, 0.5, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert abs(float((a == 0).float().mean()) - 0.5) < 0.03
    assert mc_dropout(x, 0.0, None) is x


# ---- the train loader and (f) the CLI


def test_train_loader_shuffles_like_the_jax_loader():
    class Cases:
        def __len__(self):
            return 11

        def __getitem__(self, i):
            return {"image": np.full((2, 2, 2), i, np.float32),
                    "label": np.zeros((2, 2, 2), np.float32),
                    "ori_shape": np.array([2, 2, 2]), "index": i}

    ref = JLoader(Cases(), 4, shuffle=True, drop_last=True, seed=7)
    for workers in (0, 3):
        ref.rng = np.random.default_rng(7)
        loader = pp.TrainLoader(Cases(), 4, seed=7, num_workers=workers)
        assert len(loader) == len(ref) == 2
        for _ in range(2):                       # two passes, two shuffles
            want = [list(b) for b in ref._batch_indices()]
            got = list(loader)
            assert [list(b["index"]) for b in got] == want
            assert all(b["image"].shape == (4, 2, 2, 2) for b in got)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_train_cli")
    write_synthetic_dataset(str(root / "data"), n_train=3, n_val=2, size=40,
                            seed=0)
    gen = torch.Generator().manual_seed(0)
    joint = pm.Joint(n_class=2, bottleneck=256, generator=gen)
    save_checkpoint(str(root / "3dmodel" / "seg" / "best_model.ckpt"),
                    epoch=0, model=joint.Seg)
    save_checkpoint(str(root / "3dmodel" / "vae" / "best_model.ckpt"),
                    epoch=0, model=joint)      # a composite: Vae.* is taken
    old = os.getcwd()
    os.chdir(root)
    yield root
    os.chdir(old)


def _train_argv(root, *extra):
    return ["ad", "--method", "domain_adaptation", "--no_aug",
            "--load_prefix", "seg", "--load_prefix_vae", "vae",
            "--train_list", "NIH_train", "--val_list", "NIH_val",
            "--data_root", str(root / "data"),
            "--val_data_root", str(root / "data"),
            "--data_path", str(root / "data" / "Multi_all.json"),
            "--patch_size", "32", "32", "32", "-b", "2", "--eval_epoch", "1",
            "--save_epoch", "1", "--max_epoch", "2", "--num_workers", "2",
            "--domain_loss_type", "8", "--lambda_vae", "1.0",
            "--vae_decoder_dropout", "0.5", "--device", "cpu", *extra]


def test_cli_trains_two_outer_epochs(workdir, capsys, monkeypatch):
    """Epoch 0 takes no step; epoch 1 takes one (3 cases, batch 2,
    drop_last) after one EMA update; both epochs evaluate, write their
    score JSON and checkpoints, and the eval path reloads the result."""
    emas = []
    real_ema = target_main.ema_update_seg
    monkeypatch.setattr(target_main, "ema_update_seg",
                        lambda t, s, a: (emas.append(a), real_ema(t, s, a)))
    best = target_main.main(_train_argv(workdir, "--pseudo_save_epoch", "1",
                                        "--tag", "--alpha", "0.9"))
    out = capsys.readouterr().out
    assert out.count("] loss: ") == 1 and "[  2,   1] loss: " in out
    assert emas == [0.9] and out.count("Updating Network") == 1
    for epoch in (0, 1):
        with open(f"tensorboard/ad/score_{epoch}.json") as f:
            scores = json.load(f)
        assert sorted(scores) == ["0", "1"]
        assert all(0.0 <= v <= 1.0 for v in scores.values())
    assert best == pytest.approx(max(
        np.mean(list(json.load(open(f"tensorboard/ad/score_{e}.json"))
                     .values())) for e in (0, 1)))
    for name in ("best_model.ckpt", "model_epoch1.ckpt", "model_epoch2.ckpt"):
        assert os.path.exists(os.path.join("3dmodel", "ad", name)), name
    # the student moved in its Seg only, and the eval path reloads it
    seg0 = torch.load("3dmodel/seg/best_model.ckpt")["model_state_dict"]
    vae0 = torch.load("3dmodel/vae/best_model.ckpt")["model_state_dict"]
    last = torch.load("3dmodel/ad/model_epoch2.ckpt")
    assert last["epoch"] == 2
    sd = last["model_state_dict"]
    assert not torch.equal(sd["Seg.out_block.weight"],
                           seg0["out_block.weight"])
    assert all(torch.equal(v, vae0[k]) for k, v in sd.items()
               if k.startswith("Vae."))
    os.replace("3dmodel/ad/model_epoch2.ckpt", "3dmodel/ad/best_model.ckpt")
    dsc = target_main.main([
        "ev", "--method", "domain_adaptation", "--test_only",
        "--load_prefix_joint", "ad", "--val_list", "NIH_val",
        "--val_data_root", str(workdir / "data"),
        "--data_path", str(workdir / "data" / "Multi_all.json"),
        "--patch_size", "32", "32", "32", "--device", "cpu"])
    with open("tensorboard/ad/score_1.json") as f:
        assert dsc == pytest.approx(np.mean(list(json.load(f).values())))


@pytest.mark.parametrize("extra,item", [
    (["--pseudo_list", "NIH_train"], "item 3"),
    (["--resume"], "item 3"),
    (["--val_finetune", "1"], "item 4"),
    (["--eval_mode", "sliding_window"], "item 6"),
    (["--aug_host"], "item 3"),
])
def test_cli_training_flags_of_later_slices_raise(workdir, extra, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
        target_main.main(_train_argv(workdir, *extra))


def test_cli_training_without_no_aug_raises(workdir):
    """Training without --no_aug runs the order-1 device warp
    (tests/test_torch_source_cli.py); its cubic and host variants are not
    ported yet."""
    argv = [a for a in _train_argv(workdir) if a != "--no_aug"]
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 3"):
        target_main.main(argv + ["--aug_order", "3"])


def test_epoch_sched_matches_jax():
    from vae_segmentation_tpu.cli import target_main as jmain
    from vae_segmentation_tpu_torch.core.config import TargetConfig

    cfg = TargetConfig(lambda_vae_warmup=4, turn_epoch=2, eval_epoch=1)
    for epoch in range(7):
        want = jmain._epoch_sched(cfg, epoch, 0.3)
        got = target_main._epoch_sched(cfg, epoch, 0.3)
        assert {k: float(v) for k, v in want.items()} == pytest.approx(got)
