"""The norm route (VAESEG_PALLAS=1) through a train step and the CLIs, on
the CPU. One adaptation step of the port against the JAX package's
``make_adapt_step`` under the same switch (its norms run the Pallas
function in interpret mode), from the seeded weights and batch of
tests/test_torch_train.py at 32^3, f32, and the target CLI's training loop
and eval path at 32^3 on ``--device cpu``.

The step is the pseudo-label loss alone (``AdaptConfig.only_pseudo``): its
gradient stays in the Seg, so it crosses the Seg's 25 norms forward and
backward, and it is the better-conditioned of the adaptation gradients
with random weights (the card's gate uses it for that reason). The JAX step
under the switch compiles ~130 interpret-mode kernels (35 s on one core);
the whole loss at 64^3, test_torch_train.py's, takes 43-57 s on its own.

Tolerance (``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/
test_torch_norm_step.py`` prints the measured errors): the loss within
2e-5; every Seg weight gradient within ``GRAD_REL`` = 2e-2 relative L2 of
JAX's (its step-1 update over -lr), measured 1.1e-4 to 4.6e-3 (the head
4e-6); the port drifts from itself by at most 5.9e-4 when only the f32
order of its conv sums changes, and a planted fault (the xhat * m2 term of
the norm's backward dropped) moves every Seg weight gradient by 0.85 to
6.1. Norm-cancelled biases (zero in exact arithmetic) are held to
``NOISE_ABS`` of the largest weight-gradient element, as in
test_torch_train.py (measured 0.040 against JAX and 0.040 reordered)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_train as tt
from test_torch_train_cli import _train_argv, workdir  # noqa: F401
from vae_segmentation_tpu.train import optim as joptim
from vae_segmentation_tpu.train import steps as jsteps
from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch import train as pt
from vae_segmentation_tpu_torch.cli import target_main
from vae_segmentation_tpu_torch.models import blocks as pblocks
from vae_segmentation_tpu_torch.ops import bridges as pbridges
from vae_segmentation_tpu_torch.ops import conv3 as pconv3
from vae_segmentation_tpu_torch.ops import instance_norm as pin

torch.set_num_threads(2)

SIZE = 32
GRAD_REL = 2e-2    # relative L2 error of a Seg weight gradient
NOISE_ABS = 0.2    # a norm-cancelled bias gradient over the largest
                   # weight-gradient element (test_torch_train.py's)


def _jax_grads(params, batch):
    """JAX's step-1 gradient of every Seg tensor under the switch (the
    caller sets it), from its SGD update at zero momentum."""
    model = tt._jax_joint(SIZE)
    p0 = jax.tree.map(jnp.asarray, params)
    tx = joptim.freeze_vae(joptim.sgd(tt.LR), p0)
    step = jsteps.make_adapt_step(
        model, model, tx, jsteps.AdaptConfig(n_class=tt.NC, only_pseudo=True))
    state = jsteps.init_state(jax.tree.map(jnp.copy, p0), tx)
    state, aux = step(state, p0, jnp.asarray(batch[0]), jnp.asarray(batch[1]),
                      jax.random.PRNGKey(0), jsteps.default_sched(tt.LAMBDA))
    p1 = pm.from_jax_params(jax.tree.map(np.asarray, state.params))
    start = pm.from_jax_params(params)
    return float(aux["dice_loss_fake"]), {
        k: (start[k] - p1[k]) / tt.LR for k in start if k.startswith("Seg.")}


def _port_grads(params, batch):
    student, teacher = tt._port_pair(params, SIZE)
    opt = pt.optim.sgd(pt.optim.freeze_vae(student), tt.LR)
    step = pt.make_adapt_step(pt.AdaptConfig(n_class=tt.NC, only_pseudo=True))
    aux = step(student, teacher, opt, torch.from_numpy(batch[0]),
               torch.from_numpy(batch[1]), torch.Generator().manual_seed(0),
               pt.default_sched(tt.LAMBDA))
    return float(aux["dice_loss_fake"]), {
        k: p.grad.clone() for k, p in student.named_parameters()
        if p.grad is not None}


_RUN = {}


def _run(monkeypatch):
    """(JAX's and the port's step-1 loss and Seg gradients, the port's
    under reordered f32 conv sums and under the planted fault), computed
    once per file."""
    if not _RUN:
        params, batches = tt._case(SIZE, n_batches=1)
        batch = batches[0]
        with monkeypatch.context() as m:
            m.setenv("VAESEG_PALLAS", "1")
            _RUN["jax"] = _jax_grads(params, batch)
            calls = []
            real = pblocks.instance_norm_act
            m.setattr(pblocks, "instance_norm_act",
                      lambda x: (calls.append(1), real(x))[1])
            _RUN["port"] = _port_grads(params, batch)
            _RUN["norms"] = len(calls)
            ns = tt.types.SimpleNamespace(
                conv3d=tt._split_sums(tt.F.conv3d),
                conv_transpose3d=tt._split_sums(tt.F.conv_transpose3d))
            with monkeypatch.context() as r:
                r.setattr(pconv3, "F", ns)
                r.setattr(pbridges, "F", ns)
                _RUN["reordered"] = _port_grads(params, batch)
            real_dx = pin.norm_bwd_dx_plain
            with monkeypatch.context() as f:
                f.setattr(pin, "norm_bwd_dx_plain",
                          lambda x, g, s, t, mm, relu=True: real_dx(
                              x, g, s, t, mm * torch.tensor(
                                  [1.0, 0.0])[None, :, None], relu))
                _RUN["fault"] = _port_grads(params, batch)
    return _RUN


def _errors(got, want):
    """{key: relative L2 error} over the Seg weights and the head's bias,
    and the largest norm-cancelled bias gradient over the largest
    weight-gradient element."""
    rows, noise, scale = {}, 0.0, 0.0
    for key, w in want.items():
        g, w = got[key].numpy().ravel(), w.numpy().ravel()
        if tt._norm_cancelled(key):
            noise = max(noise, np.abs(g).max(), np.abs(w).max())
            continue
        scale = max(scale, np.abs(w).max())
        rows[key] = float(np.linalg.norm(g - w) / np.linalg.norm(w))
    return rows, noise / scale


def test_step_gradient_matches_jax_on_the_norm_route(monkeypatch):
    run = _run(monkeypatch)
    # the student's Joint forward (56) and the teacher's Seg (25)
    assert run["norms"] == 56 + 25
    (jl, want), (pl, got) = run["jax"], run["port"]
    assert pl == pytest.approx(jl, abs=2e-5)
    assert sorted(got) == sorted(want)
    rows, noise = _errors(got, want)
    assert len(rows) == 35          # 34 Seg weights and the head's bias
    assert max(rows.values()) <= GRAD_REL and noise <= NOISE_ABS, \
        (rows, noise)


def test_step_tolerance_sits_between_drift_and_a_fault(monkeypatch):
    """The port with reordered f32 conv sums stays inside the bound; the
    planted norm-backward fault moves every Seg weight gradient at least
    10x beyond it."""
    run = _run(monkeypatch)
    drift, dnoise = _errors(run["reordered"][1], run["port"][1])
    assert max(drift.values()) <= GRAD_REL and dnoise <= NOISE_ABS
    fault, _ = _errors(run["fault"][1], run["jax"][1])
    assert all(v > 10 * GRAD_REL for k, v in fault.items()
               if k.endswith(".weight") and "out_block" not in k), fault


def test_cli_trains_and_evaluates_on_the_norm_route(workdir, monkeypatch):
    """The target CLI under VAESEG_PALLAS=1: two outer epochs of training
    (one step) and the eval path on the result, every norm through
    ``instance_norm_act``; scores in [0, 1] and the three checkpoints."""
    monkeypatch.setenv("VAESEG_PALLAS", "1")
    calls = []
    real = pblocks.instance_norm_act
    monkeypatch.setattr(pblocks, "instance_norm_act",
                        lambda x: (calls.append(1), real(x))[1])
    best = target_main.main(_train_argv(workdir, "--pseudo_save_epoch", "1"))
    assert 0.0 <= best <= 1.0 and calls
    for name in ("best_model.ckpt", "model_epoch1.ckpt", "model_epoch2.ckpt"):
        assert (workdir / "3dmodel" / "ad" / name).exists(), name
    before = len(calls)
    dsc = target_main.main([
        "ev", "--method", "domain_adaptation", "--test_only",
        "--load_prefix_joint", "ad", "--val_list", "NIH_val",
        "--val_data_root", str(workdir / "data"),
        "--data_path", str(workdir / "data" / "Multi_all.json"),
        "--patch_size", "32", "32", "32", "--device", "cpu"])
    assert 0.0 <= dsc <= 1.0
    assert len(calls) - before == 2 * 56     # two cases, one Joint each


def _report():
    run = _run(pytest.MonkeyPatch())
    err, noise = _errors(run["port"][1], run["jax"][1])
    drift, dnoise = _errors(run["reordered"][1], run["port"][1])
    fault, _ = _errors(run["fault"][1], run["jax"][1])
    print("losses", run["jax"][0], run["port"][0], "norms", run["norms"])
    print("bias noise vs JAX", noise, "reordered", dnoise)
    for k in sorted(err):
        print(f"  {k:34s} vs JAX {err[k]:.2e} | reordered {drift[k]:.2e} "
              f"| fault {fault[k]:.2e}")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_norm_step.py
    jax.config.update("jax_platforms", "cpu")
    _report()
