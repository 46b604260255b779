"""The --pseudo_list source replay of the port's target CLI on the CPU:

  * ``make_seg_replay_step`` against the JAX package's
    ``make_seg_replay_step`` (logical model, ``folded_io=False``) from the
    same weights and batch, 32^3, fmaps (4, 8, 8, 16, 16, 32), f32: the
    Dice loss within 2e-5 and the Seg gradients (JAX's from its SGD update)
    within tests/test_torch_train.py's tolerance (``GRAD_REL``,
    ``GRAD_COS``, ``HEAD_REL``, ``NOISE_ABS``); the port's update p0 - lr *
    g exactly (1e-7); the frozen VAE unmoved;
  * the loop's order (cli/target_main.py:321-363 of the JAX package), with
    the steps replaced by recorders: one replay step after every
    adaptation step, none in outer epoch 0, the adaptation step built with
    the 'pseudo' variant, the full teacher <- student copy on every
    iteration of an epoch divisible by --pseudo_save_epoch and no EMA,
    lambda_vae / 10 at each copy under --tag, the replay batches from a
    loader over the source list seeded --seed + 101 that restarts each
    outer epoch and cycles when it runs out;
  * a real run of the CLI with --pseudo_list printing dice_loss_pseudo.
"""

import json
import os
import re
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_train import LR, NC, _case, _check_grads, _grad_errors, \
    _jax_joint, _port_pair
from vae_segmentation_tpu.train import optim as joptim
from vae_segmentation_tpu.train import steps as jsteps
from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch import train as pt
from vae_segmentation_tpu_torch.cli import common, target_main
from vae_segmentation_tpu_torch.core.config import parse_target_args
from vae_segmentation_tpu_torch.data.synthetic import write_synthetic_dataset

torch.set_num_threads(2)

SIZE = 32


def test_replay_step_matches_jax():
    params, batches = _case(SIZE, seed=3, n_batches=1)
    img, lab = batches[0]
    model = _jax_joint(SIZE)
    jparams = jax.tree.map(jnp.asarray, params)
    tx = joptim.freeze_vae(joptim.sgd(LR), jparams)
    assert not model.folded_io
    jstep = jsteps.make_seg_replay_step(model, tx, NC)
    state = jsteps.init_state(jax.tree.map(jnp.copy, jparams), tx)
    state, jaux = jstep(state, jnp.asarray(img), jnp.asarray(lab))
    p0 = pm.from_jax_params(params)
    j1 = pm.from_jax_params(jax.tree.map(np.asarray, state.params))
    jgrads = {k: (p0[k] - j1[k]) / LR for k in p0}

    student, _ = _port_pair(params, SIZE)
    opt = pt.optim.sgd(pt.optim.freeze_vae(student), LR)
    aux = pt.make_seg_replay_step(NC)(student, opt, torch.from_numpy(img),
                                      torch.from_numpy(lab))
    assert set(aux) == {"dice_loss"}
    assert float(aux["dice_loss"]) == pytest.approx(float(jaux["dice_loss"]),
                                                    abs=2e-5)
    grads = {k: p.grad for k, p in student.named_parameters()
             if p.grad is not None}
    assert sorted(grads) == sorted(k for k in p0 if k.startswith("Seg."))
    rows, noise = _grad_errors(grads, jgrads)
    assert len(rows) == 35
    _check_grads(rows, noise)
    for k, v in student.state_dict().items():
        want = p0[k] - LR * grads[k] if k in grads else p0[k]
        torch.testing.assert_close(v, want, rtol=0, atol=1e-7)
        if k.startswith("Vae."):
            assert torch.equal(v, p0[k]), k
            assert torch.equal(j1[k], p0[k]), k


# ---- the CLI loop


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("replay")
    manifest = write_synthetic_dataset(str(root / "data"), n_train=4,
                                       n_val=1, size=36, seed=2)
    write_synthetic_dataset(str(root / "src"), n_train=3, n_val=0, size=36,
                            seed=3, train_key="SRC")
    with open(manifest) as f:
        lists = json.load(f)
    with open(root / "src" / "Multi_all.json") as f:
        lists["SRC"] = json.load(f)["SRC"]
    with open(manifest, "w") as f:
        json.dump(lists, f)
    old = os.getcwd()
    os.chdir(root)
    yield root
    os.chdir(old)


def _argv(root, prefix, *extra):
    return [prefix, "--method", "domain_adaptation", "--no_aug",
            "--train_list", "NIH_train", "--val_list", "NIH_val",
            "--data_root", str(root / "data"),
            "--val_data_root", str(root / "data"),
            "--data_path", str(root / "data" / "Multi_all.json"),
            "--pseudo_list", "SRC", "--pseudo_data_root", str(root / "src"),
            "--patch_size", "32", "32", "32", "-b", "2", "--eval_epoch", "1",
            "--save_epoch", "1", "--num_workers", "0",
            "--domain_loss_type", "8", "--lambda_vae", "1.0",
            "--device", "cpu", *extra]


def _recorded_run(argv):
    """Run the CLI with the adaptation and replay steps replaced by
    recorders; returns the events: ('copy',), ('ema',), ('adapt',
    lambda_vae), ('replay', label)."""
    events, variants = [], []
    real_copy = target_main.copy_params

    def adapt_factory(cfg, variant="train"):
        variants.append(variant)

        def step(student, teacher, opt, image, label, gen, sched):
            events.append(("adapt", sched["lambda_vae"]))
            z = torch.zeros(())
            return {"recon_loss": z, "dice_loss_fake": z, "dice_loss": z}
        return step

    def replay_factory(n_class):
        def step(student, opt, image, label):
            events.append(("replay", label.clone()))
            return {"dice_loss": torch.zeros(())}
        return step

    def copy(dst, src):
        events.append(("copy",))
        real_copy(dst, src)

    with mock.patch.object(target_main, "make_adapt_step", adapt_factory), \
            mock.patch.object(target_main, "make_seg_replay_step",
                              replay_factory), \
            mock.patch.object(target_main, "copy_params", copy), \
            mock.patch.object(target_main, "ema_update_seg",
                              lambda *a: events.append(("ema",))):
        target_main.main(argv)
    return events, variants


def _want_labels(root, argv, n):
    """The source batches the replay should take: passes of a loader over
    SRC seeded --seed + 101, a new pass at each outer epoch (2 adaptation
    steps an epoch) and whenever one runs out (a pass is 1 batch of 2)."""
    cfg = parse_target_args(argv)
    loader = common.build_train_loader(cfg, data_root=cfg.pseudo_data_root,
                                       list_key="SRC", seed_salt=101)
    assert len(loader) == 1
    return [torch.from_numpy(next(iter(loader))["label"]) for _ in range(n)]


@pytest.mark.parametrize("save_epoch,tag", [(1, True), (2, False)])
def test_cli_loop_order_and_teacher_cadence(workdir, save_epoch, tag):
    argv = _argv(workdir, f"o{save_epoch}", "--max_epoch", "3",
                 "--pseudo_save_epoch", str(save_epoch),
                 *(["--tag"] if tag else []))
    events, variants = _recorded_run(argv)
    assert variants == ["pseudo"]
    # the two copies of the load matrix, then the training loop
    assert [e[0] for e in events[:2]] == ["copy", "copy"]
    train = events[2:]
    want, lam = [], 1.0
    for epoch in (1, 2):                      # outer epoch 0 takes no step
        for _ in range(2):                    # 4 cases at batch 2
            if epoch % save_epoch == 0:
                want.append(("copy",))
                lam = lam / 10.0 if tag else lam
            want += [("adapt", lam), ("replay",)]
    assert [e[:1] if e[0] == "replay" else e for e in train] == \
        [w for w in want]
    labels = [e[1] for e in train if e[0] == "replay"]
    for got, exp in zip(labels, _want_labels(workdir, argv, len(labels))):
        assert torch.equal(got, exp)


def test_cli_with_pseudo_list_trains_and_prints_the_replay_loss(
        workdir, capsys):
    argv = _argv(workdir, "real", "--max_epoch", "2",
                 "--pseudo_save_epoch", "1", "--vae_decoder_dropout", "0.5")
    capsys.readouterr()
    best = target_main.main(argv)
    out = capsys.readouterr().out
    lines = re.findall(r"^\[\s*2,\s*\d\] loss: (.*)$", out, re.M)
    assert len(lines) == 2
    for line in lines:
        vals = [float(v) for v in line.split(", ")]
        assert len(vals) == 4 and all(0.0 <= v <= 2.0 for v in vals)
    assert 0.0 <= best <= 1.0
    ck = torch.load("3dmodel/real/model_epoch2.ckpt", weights_only=True)
    assert ck["extra"]["best_result"] == best
