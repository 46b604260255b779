"""vae_train and seg_train under a mesh (``parallel/``), in gloo worlds on
the CPU: vae_train at 64^3 under DP2 (its reparam streams, seed + data
index, and the KL averaged over 'data') and seg_train at 32^3 under SP2,
and the adaptation step on the norm route (VAESEG_PALLAS=1) under SP2,
against the one-process port step, with tests/test_torch_dist_step.py's
rules (the Joint's source steps: tests/test_torch_dist_joint_source.py)."""

import numpy as np
import pytest
import torch

import torch_dist_workers as W
from test_torch_dist_step import (LOSS_ABS, DRIFT_MULTIPLE, SIZE, _reordered,
                                  drift_ratios)
from test_torch_train import BATCH, DIM, FMAPS, LR, _bottleneck
from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch.parallel import launch

_SRC = {}


def _source(kind, layout):
    key = (kind, layout)
    if key not in _SRC:
        torch.manual_seed(0)
        rng = np.random.default_rng(11)
        if kind == "vae":
            net = pm.ShapeVAE(n_class=2, fmaps=FMAPS, dim=DIM,
                              bottleneck=_bottleneck(64),
                              dtype=torch.float32,
                              generator=torch.Generator().manual_seed(3))
            size = 64
        else:
            net = pm.SegUNet(n_class=2, fmaps=FMAPS, dtype=torch.float32,
                             generator=torch.Generator().manual_seed(3))
            size = SIZE
        spec = {"kind": kind, "fmaps": FMAPS, "dim": DIM,
                "bottleneck": _bottleneck(64), "scale": 0.35, "lr": LR,
                "state": {k: v.detach().numpy()
                          for k, v in net.state_dict().items()},
                "image": (rng.normal(size=(BATCH, size, size, size)) * 0.5)
                .astype(np.float32),
                "label": (rng.random((BATCH, size, size, size)) > 0.7)
                .astype(np.float32)}
        _SRC["spec", kind] = spec
        _SRC[key] = (W.source_step(0, 1, 1, 1, spec),
                     launch.spawn(W.source_step, layout[0] * layout[1],
                                  timeout=120.0, args=(*layout, spec)))
    return _SRC[key]


def test_vae_train_under_dp2_draws_a_stream_a_data_rank():
    """vae_train at 64^3 (a 2^3 bottleneck), reparam scale 0.35, DP2: rank
    r hands the kernel the step's seed + r (the JAX package's seed +
    axis_index('data')), so the two items' eps come from two streams, and
    the KL is averaged over 'data'. At scale 0 the latent is the mean and
    the step equals one process's; the streams are the JAX mesh's, not one
    process's, so at 0.35 the loss differs from it by the eps draw alone:
    the Dice term within 0.05, the KL (no eps in it) within LOSS_ABS."""
    one, ranks = _source("vae", (2, 1))
    assert len(one["seeds"]) == 1
    s0 = one["seeds"][0]
    assert [r["seeds"] for r in ranks] == [[s0], [s0 + 1]]
    for r in ranks:
        assert r["aux"]["kl_loss"] == pytest.approx(one["aux"]["kl_loss"],
                                                    rel=LOSS_ABS)
        assert abs(r["aux"]["dice_loss"] - one["aux"]["dice_loss"]) < 0.05
    assert ranks[1]["grad_digest"] == ranks[0]["grad_digest"]


def test_seg_train_under_sp2():
    """seg_train at 32^3 under SP2: the loss and every gradient the
    one-process step's (the drift rule above), the same bits on both
    ranks."""
    one, ranks = _source("seg", (1, 2))
    for r in ranks:
        assert r["aux"]["dice_loss"] == pytest.approx(
            one["aux"]["dice_loss"], abs=LOSS_ABS)
    reordered = _reordered(W.source_step, _SRC["spec", "seg"])
    for k, ratio in drift_ratios(ranks[0]["grads"], one["grads"],
                                 reordered["grads"])[2].items():
        assert ratio <= DRIFT_MULTIPLE, (k, ratio)
    assert ranks[1]["grad_digest"] == ranks[0]["grad_digest"]


def test_adapt_step_on_the_norm_route_under_sp2(monkeypatch):
    """The norm route (VAESEG_PALLAS=1: every InstanceNorm+ReLU through
    ``instance_norm_act``, its f64 sums added over the data row before the
    fold) under SP2 at 32^3: the loss terms and every gradient the
    one-process norm-route step's, under tests/test_torch_dist_step.py's
    rules; the ranks' gradients the same bits."""
    from test_torch_dist_step import LOSS_KEYS, _case, _spec

    monkeypatch.setenv("VAESEG_PALLAS", "1")
    params, batches = _case(SIZE)
    spec = _spec(params, batches[0])
    one = W.adapt_step(0, 1, 1, 1, spec)
    reordered = _reordered(W.adapt_step, spec)
    ranks = launch.spawn(W.adapt_step, 2, timeout=120.0, args=(1, 2, spec),
                         env={"VAESEG_PALLAS": "1"})
    for r in ranks:
        for k in LOSS_KEYS:
            assert r["aux"][k] == pytest.approx(one["aux"][k],
                                                abs=LOSS_ABS), k
    for k, ratio in drift_ratios(ranks[0]["grads"], one["grads"],
                                 reordered["grads"])[2].items():
        assert ratio <= DRIFT_MULTIPLE, (k, ratio)
    assert ranks[1]["grad_digest"] == ranks[0]["grad_digest"]

