"""The Joint's three source methods of the port (``train/steps.py``:
``make_joint_train_step``, ``make_cached_pseudo_adapt_step``,
``make_sep_joint_train_step``) against the JAX package's steps on the CPU,
with the wiring of the JAX package's source CLI (cli/source_main.py:
69-99): the Joint without dropout, SGD at momentum 0.9 with the VAE
frozen (``optim.freeze_vae``), the source Dice eps (1e-4) for joint_train
and the cached pseudo label, the eval eps (1e-6) for sep_joint_train.

At 64^3 (a 2^3 VAE bottleneck: at 32^3 the encoder's norm zeroes its
output and the reconstruction no longer depends on the prediction) with
tests/test_torch_train.py's widths, seeded weights carried across by
``from_jax_params``, batch 2, two SGD steps each, and its tolerances: the
loss terms of both steps within 2e-5 abs (step 2 free-running, 1e-4 as
that file's trajectory); the Seg gradients of step 1 against JAX's step-1
update over -lr, and of step 2 taken from JAX's step-1 weights against
JAX's step-2 gradient (its update over -lr less the momentum term), per
tensor: relative L2 <= 0.3 and cosine >= 0.97 (the head 2e-2 / 2e-3, the
norm-cancelled biases 0.2 of the largest weight gradient); the VAE bit for
bit. The cached pseudo label is a seeded two-class probability volume;
sep_joint_train's teacher Joint has weights of its own seed. The cached
pseudo label's step (the same machinery, kind 'cached') and the three
methods through the CLI are in tests/test_torch_cached_pseudo.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import (
    BATCH, LAMBDA, LR, NC, _case, _check_grads, _draw_params, _grad_errors,
    _jax_joint, _port_joint)
from vae_segmentation_tpu.train import optim as joptim
from vae_segmentation_tpu.train import steps as jsteps
from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch import train as pt

torch.set_num_threads(2)

SIZE = 64
MOMENTUM = 0.9
KEYS = {"joint": ("recon_loss", "dice_loss"),
        "cached": ("recon_loss", "dice_loss_fake", "dice_loss",
                   "final_loss"),
        "sep": ("recon_loss", "dice_loss", "final_loss")}


def _pseudo(rng):
    """A [B, D, H, W, 2] two-class probability volume, bf16-exact."""
    p1 = torch.from_numpy(rng.random((BATCH, SIZE, SIZE, SIZE))
                          .astype(np.float32)).bfloat16().float()
    return torch.stack([1.0 - p1, p1], dim=-1).numpy()


def _inputs():
    params, batches = _case(SIZE)
    rng = np.random.default_rng(7)
    teacher = _draw_params(jax.tree.map(np.asarray, params), rng)
    pseudos = [_pseudo(rng) for _ in batches]
    return params, teacher, batches, pseudos


def _jax_run(kind, params, teacher, batches, pseudos):
    model = _jax_joint(SIZE)
    params = jax.tree.map(jnp.asarray, params)
    tx = joptim.freeze_vae(joptim.sgd(LR), params)
    sched = jsteps.default_sched(LAMBDA)
    if kind == "joint":
        step = jsteps.make_joint_train_step(model, tx, NC)
    elif kind == "cached":
        step = jsteps.make_cached_pseudo_adapt_step(
            model, tx, jsteps.AdaptConfig(n_class=NC))
    else:
        step = jsteps.make_sep_joint_train_step(model, model, tx, NC)
        teacher = jax.tree.map(jnp.asarray, teacher)
    state = jsteps.init_state(jax.tree.map(jnp.copy, params), tx)
    losses, snaps = [], []
    for i, (img, lab) in enumerate(batches):
        img, lab = jnp.asarray(img), jnp.asarray(lab)
        if kind == "joint":
            state, aux = step(state, img, lab, sched)
        elif kind == "cached":
            state, aux = step(state, img, lab, jnp.asarray(pseudos[i]),
                              jax.random.PRNGKey(i), sched)
        else:
            state, aux = step(state, teacher, img, lab)
        losses.append({k: float(aux[k]) for k in KEYS[kind]})
        snaps.append(jax.tree.map(np.asarray, state.params))
    return losses, snaps


def _port_run(kind, params, teacher, batches, pseudos, start=None, lr=LR,
              first=0, n=2):
    """(losses, per-step state_dicts, per-step gradients, model)."""
    model = _port_joint(SIZE)
    pm.load_state(model, pm.from_jax_params(params))
    if start is not None:
        pm.load_state(model, start)
    tea = None
    if kind == "sep":
        tea = _port_joint(SIZE)
        pm.load_state(tea, pm.from_jax_params(teacher))
        for p in tea.parameters():
            p.requires_grad_(False)
    opt = pt.optim.sgd(pt.optim.freeze_vae(model), lr)
    sched = pt.default_sched(LAMBDA)
    losses, snaps, grads = [], [], []
    for i in range(first, first + n):
        img, lab = (torch.from_numpy(a) for a in batches[i])
        if kind == "joint":
            aux = pt.make_joint_train_step(NC)(model, opt, img, lab, sched)
        elif kind == "cached":
            aux = pt.make_cached_pseudo_adapt_step(pt.AdaptConfig(
                n_class=NC))(model, opt, img, lab,
                             torch.from_numpy(pseudos[i]), sched)
        else:
            aux = pt.make_sep_joint_train_step(NC)(model, tea, opt, img)
        losses.append({k: float(aux[k]) for k in KEYS[kind]})
        snaps.append({k: v.detach().clone()
                      for k, v in model.state_dict().items()})
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None})
    return losses, snaps, grads, model


_RUN = {}


def _run(kind):
    if kind not in _RUN:
        if "inputs" not in _RUN:
            _RUN["inputs"] = _inputs()
        inputs = _RUN["inputs"]
        jl, js = _jax_run(kind, *inputs)
        p0 = pm.from_jax_params(inputs[0])
        j1, j2 = (pm.from_jax_params(t) for t in js)
        g1 = {k: (p0[k] - j1[k]) / LR for k in p0}
        # p2 = p1 - lr (m g1 + g2)
        g2 = {k: (j1[k] - j2[k]) / LR - MOMENTUM * g1[k] for k in p0}
        # the port's step 2 from JAX's step-1 weights, at lr 0
        step2 = _port_run(kind, *inputs, start=j1, lr=0.0, first=1, n=1)
        _RUN[kind] = {"jax": jl, "jax_grads": (g1, g2), "p0": p0,
                      "port": _port_run(kind, *inputs), "step2": step2}
    return _RUN[kind]


@pytest.mark.parametrize("kind", ["joint", "sep"])
def test_loss_terms_match_jax(kind):
    run = _run(kind)
    for i, (lp, lj) in enumerate(zip(run["port"][0], run["jax"])):
        for k in KEYS[kind]:
            assert lp[k] == pytest.approx(lj[k], abs=2e-5 if i == 0
                                          else 1e-4), (i, k)
    for k in KEYS[kind]:
        assert run["step2"][0][0][k] == pytest.approx(run["jax"][1][k],
                                                      abs=2e-5), k


@pytest.mark.parametrize("kind", ["joint", "sep"])
def test_seg_gradients_match_jax(kind):
    run = _run(kind)
    got1, got2 = run["port"][2][0], run["step2"][2][0]
    want1, want2 = run["jax_grads"]
    assert sorted(got1) == sorted(k for k in want1 if k.startswith("Seg."))
    for got, want in ((got1, want1), (got2, want2)):
        rows, noise = _grad_errors(got, want)
        assert len(rows) == 35
        _check_grads(rows, noise)


@pytest.mark.parametrize("kind", ["joint", "sep"])
def test_vae_stays_frozen(kind):
    run = _run(kind)
    for snap in run["port"][1]:
        for k, v in snap.items():
            if k.startswith("Vae."):
                assert torch.equal(v, run["p0"][k]), k
    assert not any(k.startswith("Vae.") for g in run["port"][2] for k in g)
