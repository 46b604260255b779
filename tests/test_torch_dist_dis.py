"""domain_adaptation_dis under a mesh (``parallel/``), in gloo worlds of
two ranks on the CPU: the Joint2 step (``train/steps.py::
make_adapt_dis_step``) against the one-process port step
(tests/test_torch_dis_steps.py holds that one to JAX's), with
tests/test_torch_dist_step.py's rules: the loss terms within 1e-5, every
Seg gradient within 4x the one-process step's drift under reordered f32
conv sums, the same bits on both ranks, the Dis unmoved. At 64^3 with
narrow widths: at 32^3 the Dis's 1^3 bottleneck norm makes its score
constant, and its part of the gradient zero.

SP2 runs the whole step. Under DP2 the gradient rule holds the Dice terms'
part (lambda_vae 0; the discriminator loss still reported and held), and
the score's part is held where it is well conditioned: the gradient of
1 - the batch mean of a ShapeEncoder's scores in its input, a uniform
random volume, within 1e-4 of one process's. At the seed weights the Seg
predicts ~0.5 everywhere, so the Dis's first InstanceNorm divides by a
tiny std, and a data rank's batch-1 conv against one process's batch-2 one
moves that part of the Seg gradient by up to 6.8% with no mesh at all (one
process, the batch run whole against each sample alone)."""

import numpy as np
import pytest
import torch

import torch_dist_workers as W
from test_torch_dis_steps import BOTT, FMAPS, LR, _cases
from test_torch_dist_step import (LOSS_ABS, DRIFT_MULTIPLE, _reordered,
                                  drift_ratios)
from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch.parallel import launch

torch.set_num_threads(2)

_SPEC = {}


def _spec():
    if not _SPEC:
        c = _cases()
        _SPEC.update(
            state={k: v.numpy() for k, v in
                   pm.from_jax_params(c["joint2"]).items()},
            teacher={k: v.numpy() for k, v in
                     pm.from_jax_params(c["teacher"]).items()},
            image=c["image"], label=c["mask"], fmaps=FMAPS,
            bottleneck=BOTT, lr=LR)
    return _SPEC


@pytest.mark.parametrize("layout,lam", [((2, 1), 0.0), ((1, 2), 1.0)])
def test_adapt_dis_step_under_a_mesh(layout, lam):
    spec = dict(_spec(), lambda_vae=lam)
    one = W.adapt_dis_step(0, 1, 1, 1, spec)
    reordered = _reordered(W.adapt_dis_step, spec)
    ranks = launch.spawn(W.adapt_dis_step, 2, timeout=180.0,
                         args=(*layout, spec))
    for r in ranks:
        assert r["aux"].keys() == one["aux"].keys()
        for k, v in one["aux"].items():
            assert r["aux"][k] == pytest.approx(v, abs=LOSS_ABS), k
        assert r["dis_unmoved"]
    assert sorted(ranks[0]["grads"]) == sorted(
        k for k in spec["state"] if k.startswith("Seg."))
    for k, ratio in drift_ratios(ranks[0]["grads"], one["grads"],
                                 reordered["grads"])[2].items():
        assert ratio <= DRIFT_MULTIPLE, (k, ratio)
    assert ranks[1]["grad_digest"] == ranks[0]["grad_digest"]
    assert np.isfinite(list(one["aux"].values())).all()


def test_score_mean_gradient_under_dp2():
    rng = np.random.default_rng(4)
    spec = {"fmaps": FMAPS, "bottleneck": BOTT,
            "x": rng.random((2, 64, 64, 64, 1)).astype(np.float32)}
    one = W.dis_input_grad(0, 1, 1, 1, spec)
    ranks = launch.spawn(W.dis_input_grad, 2, timeout=180.0,
                         args=(2, 1, spec))
    for i, r in enumerate(ranks):
        assert r["loss"] == pytest.approx(one["loss"], abs=LOSS_ABS)
        # a data rank's cotangent is the global loss's on its items, before
        # the mesh's mean over ranks halves it
        got, want = np.asarray(r["grad"]) / 2, one["grad"][i:i + 1].numpy()
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)
