"""The train steps under a mesh (``parallel/``), in gloo worlds on the CPU:
the adaptation step at 32^3 under DP2, SP2 and DP2 x SP2 (4 ranks), f32,
dropout 0, against the one-process port step and JAX's single-device
``make_adapt_step``; a batch whose per-rank reconstruction losses fall in
other dh buckets than the global one (vae_train under DP2 and seg_train
under SP2: tests/test_torch_dist_source.py).

At 32^3 with tests/test_torch_train.py's widths (fmaps 4-32) every path
of the shard wraps runs: the halo conv with its range at every Seg and VAE
stage, the stats correction, the bridges on the slab, the Seg's bottom up
bridge (D 2 does not split in pairs: gathered, whole, then cut back to the
rank's planes) and the VAE's 1^3 bottom (D 1 does not split: whole on every
rank of a row). The mesh changes only the order of f32 sums (stats and
Dice sums per slab then across ranks, the gradient mean), so:
  * loss terms: within ``LOSS_ABS`` = 1e-5 of the one-process step and
    tests/test_torch_train.py's 2e-5 of JAX's;
  * every gradient tensor: its relative L2 error against the one-process
    port's within ``DRIFT_MULTIPLE`` = 4 times the one-process port's own
    drift when only the f32 summation order of its convs changes
    (tests/test_torch_train.py's ``_split_sums``), each tensor held to its
    own drift or the median tensor's, whichever is larger (chip_smoke.py's
    ``drift_ratios``; the random-weight network's gradients pass ~10
    InstanceNorms whose backward cancels, so round-off reaches 1e-3 of a
    tensor here: ``python tests/test_torch_dist_step.py`` prints errors and
    drifts), and the same bits on every rank of the world; a conv bias
    under an InstanceNorm (zero gradient in exact arithmetic) within
    tests/test_torch_train.py's NOISE_ABS of the largest weight-gradient
    element;
  * every parameter after the update: the same bits on every rank; the
    VAE unmoved.
A collective with an identity backward would leave a factor n_spatial or
n_data in the gradients (a relative error of 0.5 or more), far past these
bounds; test_an_identity_backward_fails_the_gate plants one."""

import types

import numpy as np
import pytest
import torch.nn.functional as F

import torch_dist_workers as W
from test_torch_train import (DIM, FMAPS, LOSS_KEYS, LR, NOISE_ABS,
                              _bottleneck, _case, _jax_trajectory,
                              _split_sums)
from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch.ops import bridges as pbridges
from vae_segmentation_tpu_torch.ops import conv3 as pconv3
from vae_segmentation_tpu_torch.parallel import launch

SIZE = 32
LOSS_ABS = 1e-5
DRIFT_MULTIPLE = 4.0
LAYOUTS = [(2, 1), (1, 2), (2, 2)]    # DP2, SP2, DP2 x SP2

_RUN = {}


def _spec(params, batch):
    state = {k: v.numpy() for k, v in pm.from_jax_params(params).items()}
    return {"state": state, "image": batch[0], "label": batch[1],
            "dim": DIM, "fmaps": FMAPS, "bottleneck": _bottleneck(SIZE),
            "lr": LR}


def _adapt():
    """The one-process port step, JAX's, and each layout's world."""
    if not _RUN:
        params, batches = _case(SIZE)
        spec = _spec(params, batches[0])
        _RUN["jax"] = _jax_trajectory(params, batches, 1, SIZE)[0][0]
        _RUN["one"] = W.adapt_step(0, 1, 1, 1, spec)
        _RUN["reordered"] = _reordered(W.adapt_step, spec)
        for n_data, n_sp in LAYOUTS:
            _RUN[n_data, n_sp] = launch.spawn(
                W.adapt_step, n_data * n_sp, timeout=120.0,
                args=(n_data, n_sp, spec))
    return _RUN


def _reordered(worker, spec):
    """The one-process step with each conv's f32 sums split over two
    halves of its input channels: another summation order."""
    ns = types.SimpleNamespace(
        conv3d=_split_sums(F.conv3d),
        conv_transpose3d=_split_sums(F.conv_transpose3d))
    with pytest.MonkeyPatch.context() as m:
        m.setattr(pconv3, "F", ns)
        m.setattr(pbridges, "F", ns)
        return worker(0, 1, 1, 1, spec)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _norm_cancelled(key):
    """A conv bias under an InstanceNorm: zero gradient in exact
    arithmetic, round-off on every path (chip_smoke.py's rule)."""
    return key.endswith(".bias") and "out_block" not in key \
        and not key.split(".")[-2].startswith("fc")


def drift_ratios(got, one, reordered):
    """(error, drift, ratio) per gradient tensor but the norm-cancelled
    biases: `got` against the one-process gradients, the reordered
    one-process step against them, and the error over the larger of the
    tensor's drift and the median drift."""
    keys = [k for k in one if not _norm_cancelled(k)]
    err = {k: _rel(got[k], one[k]) for k in keys}
    drift = {k: _rel(reordered[k], one[k]) for k in keys}
    median = sorted(drift.values())[len(drift) // 2]
    return err, drift, {k: err[k] / max(drift[k], median) for k in err}


def _check_noise(grads):
    """The norm-cancelled biases' round-off within tests/test_torch_train.
    py's NOISE_ABS of the largest weight-gradient element."""
    scale = max(np.abs(g).max() for k, g in grads.items()
                if k.endswith(".weight"))
    noise = max(np.abs(g).max() for k, g in grads.items()
                if _norm_cancelled(k))
    assert noise <= NOISE_ABS * scale, (noise, scale)


def grad_ratios(layout):
    run = _adapt()
    return drift_ratios(run[layout][0]["grads"], run["one"]["grads"],
                        run["reordered"]["grads"])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_adapt_step_loss_terms(layout):
    run = _adapt()
    for rank in run[layout]:
        for k in LOSS_KEYS:
            assert rank["aux"][k] == pytest.approx(run["one"]["aux"][k],
                                                   abs=LOSS_ABS), k
            assert rank["aux"][k] == pytest.approx(run["jax"][k],
                                                   abs=2e-5), k


@pytest.mark.parametrize("layout", LAYOUTS)
def test_adapt_step_gradients_and_update(layout):
    run = _adapt()
    one, ranks = run["one"], run[layout]
    assert sorted(ranks[0]["grads"]) == sorted(one["grads"])
    assert all(k.startswith("Seg.") for k in one["grads"])
    for k, ratio in grad_ratios(layout)[2].items():
        assert ratio <= DRIFT_MULTIPLE, (k, ratio)
    _check_noise(ranks[0]["grads"])
    for rank in ranks[1:]:
        assert rank["grad_digest"] == ranks[0]["grad_digest"]
        assert rank["param_digest"] == ranks[0]["param_digest"]
    assert all(rank["vae_unmoved"] for rank in ranks) and one["vae_unmoved"]


def test_dh_bucket_of_the_global_batch():
    """Two items, one reconstructed exactly, one at ~0.4: under DP each
    rank's own recon loss falls in another dh bucket (0.6 below 0.15, 3.0
    from 0.3) than the global one (~0.2: 1.2); under the mesh every rank's
    loss is the one-process loss, and the gradient of its slice of pred is
    the mesh size times the one-process gradient's slice (the gradient
    convention: each rank's loss is the global one, and the mean over the
    mesh that parameters take divides the factor out)."""
    rng = np.random.default_rng(5)
    shape = (2, 8, 4, 4, 2)
    fg = rng.random(shape[:-1]) > 0.5
    recon = np.stack([~fg, fg], -1).astype(np.float32)
    pred = recon.copy()                       # item 0: recon loss 0
    pred[1] = 0.4 * (1.0 - recon[1]) + 0.6 * recon[1]   # item 1: ~0.4
    pseudo = (rng.random(shape) > 0.5).astype(np.float32)
    one = W.dh_loss(0, 1, 1, 1, pred, recon, pseudo)
    assert 0.15 <= one["recon"] < 0.3
    for n_data, n_sp in LAYOUTS:
        got = launch.spawn(W.dh_loss, n_data * n_sp, timeout=60.0,
                           args=(n_data, n_sp, pred, recon, pseudo))
        own = sorted({round(r["own_recon"], 6) for r in got})
        if n_data > 1:
            assert own[0] < 0.15 and own[-1] >= 0.3, own
        for r, rank in enumerate(got):
            assert rank["final"] == pytest.approx(one["final"], abs=1e-6)
            di, si = divmod(r, n_sp)
            want = one["grad"][di:di + 1] if n_data > 1 else one["grad"]
            want = want[:, si * 8 // n_sp:(si + 1) * 8 // n_sp]
            np.testing.assert_allclose(rank["grad"], n_data * n_sp * want,
                                       rtol=1e-5, atol=1e-7)


def test_an_identity_backward_fails_the_gate():
    """The DP2 x SP2 gradients with the factor an identity backward of one
    collective would leave (each rank's share of a spatial_sum taken as
    the whole: n_spatial times the one-process gradient) fail the rule."""
    run = _adapt()
    planted = {k: 2.0 * g for k, g in run[2, 2][0]["grads"].items()}
    ratios = drift_ratios(planted, run["one"]["grads"],
                          run["reordered"]["grads"])[2]
    assert min(ratios.values()) > 10 * DRIFT_MULTIPLE, min(ratios.values())


if __name__ == "__main__":
    for layout in LAYOUTS:
        err, drift, ratio = grad_ratios(layout)
        worst = max(ratio, key=ratio.get)
        print(f"{layout}: worst ratio {ratio[worst]:.3f} ({worst}: error "
              f"{err[worst]:.3e}, drift {drift[worst]:.3e}); largest error "
              f"{max(err.values()):.3e}, median drift "
              f"{sorted(drift.values())[len(drift) // 2]:.3e}",
              {k: _RUN[layout][0]["aux"][k] - _RUN["one"]["aux"][k]
               for k in LOSS_KEYS})
