"""The port's ft1 finetune step against the JAX package's
``make_finetune_step`` on the CPU, with the wiring of the JAX package's
target CLI (cli/target_main.py:271-275): SGD at momentum 0 with the VAE
frozen (``optim.freeze_vae(optim.sgd(lr, momentum=0.0))``), the live
teacher, the finetune variant of the adaptation loss. The port's step is
``make_adapt_step(cfg, variant='finetune')`` with ``optim.sgd(optim.
freeze_vae(model), lr, momentum=0.0)``, as ``cli/target_main.py::
_make_finetune`` builds it.

Domain loss type 12, whose finetune fork (lambda * recon + fake + (1 -
recon) * (1 - fake)) differs from the train path's; dropout 0; one
validation case (batch 1), two steps on it, as ft1 takes them. At 64^3
(a 2^3 VAE bottleneck: at 32^3 the encoder's norm zeroes its output, so
the gradient through the frozen VAE would say nothing). Weights from a
numpy seed through ``from_jax_params``; the seeded case, the model widths
and the tolerances are tests/test_torch_train.py's: loss terms 2e-5 abs,
the Seg gradients per tensor (relative L2 0.3, cosine 0.97, the head's
2e-2 / 2e-3, the norm-cancelled biases 0.2 of the largest weight
gradient), step 2 held at JAX's step-1 weights. The VAE stays bit for
bit."""

import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_train import (
    LAMBDA, LOSS_KEYS, LR, NC, _case, _check_grads, _grad_errors, _jax_joint,
    _port_pair)
from vae_segmentation_tpu.train import optim as joptim
from vae_segmentation_tpu.train import steps as jsteps
from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch import train as pt

torch.set_num_threads(2)

LOSS_TYPE = 12
SIZE = 64


def _batch(batches):
    img, lab = batches[0]
    return img[:1], lab[:1]


def _jax_finetune(params, img, lab, n_steps):
    model = _jax_joint(SIZE)
    params = jax.tree.map(jnp.asarray, params)
    tx_ft = joptim.freeze_vae(
        joptim.sgd(LR, momentum=0.0, weight_decay=0.0), params)
    step = jsteps.make_finetune_step(
        model, model, tx_ft,
        jsteps.AdaptConfig(n_class=NC, domain_loss_type=LOSS_TYPE))
    teacher = jax.tree.map(jnp.copy, params)
    state = jsteps.init_state(jax.tree.map(jnp.copy, params), tx_ft)
    losses, snaps = [], []
    for i in range(n_steps):
        state, aux = step(state, teacher, jnp.asarray(img), jnp.asarray(lab),
                          jax.random.PRNGKey(i),
                          jsteps.default_sched(LAMBDA))
        losses.append({k: float(aux[k]) for k in LOSS_KEYS})
        snaps.append(jax.tree.map(lambda a: a.__array__(), state.params))
    return losses, snaps


def _port_finetune(params, img, lab, n_steps, start=None, lr=LR):
    """(losses, per-step state_dicts, per-step gradients, ft model): the
    teacher holds `params`, the ft model starts from `start` (a
    state_dict) when given."""
    model, teacher = _port_pair(params, SIZE)
    if start is not None:
        pm.load_state(model, start)
    opt = pt.optim.sgd(pt.optim.freeze_vae(model), lr, momentum=0.0,
                       weight_decay=0.0)
    step = pt.make_adapt_step(
        pt.AdaptConfig(n_class=NC, domain_loss_type=LOSS_TYPE),
        variant="finetune")
    gen = torch.Generator().manual_seed(0)
    losses, snaps, grads = [], [], []
    for _ in range(n_steps):
        aux = step(model, teacher, opt, torch.from_numpy(img),
                   torch.from_numpy(lab), gen, pt.default_sched(LAMBDA))
        losses.append({k: float(aux[k]) for k in LOSS_KEYS})
        snaps.append({k: v.detach().clone()
                      for k, v in model.state_dict().items()})
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None})
    return losses, snaps, grads, model


_RUN = {}


def _run():
    if not _RUN:
        params, batches = _case(SIZE)
        img, lab = _batch(batches)
        _RUN.update(params=params, img=img, lab=lab,
                    jax=_jax_finetune(params, img, lab, 2),
                    port=_port_finetune(params, img, lab, 2))
        p0 = pm.from_jax_params(params)
        j1, j2 = (pm.from_jax_params(t) for t in _RUN["jax"][1])
        # momentum 0: each update is -lr times that step's gradient
        _RUN["jax_grads"] = [{k: (p0[k] - j1[k]) / LR for k in p0},
                             {k: (j1[k] - j2[k]) / LR for k in p0}]
        _RUN["j1"] = j1
    return _RUN


def test_finetune_loss_terms_match_jax():
    """Step 1's loss terms (the type-12 finetune fork in final_loss)."""
    run = _run()
    lp, lj = run["port"][0][0], run["jax"][0][0]
    for k in LOSS_KEYS:
        assert lp[k] == pytest.approx(lj[k], abs=2e-5), k
    r, f = lp["recon_loss"], lp["dice_loss_fake"]
    assert lp["final_loss"] == pytest.approx(
        LAMBDA * r + f + (1.0 - r) * (1.0 - f), rel=1e-6)


def test_finetune_seg_gradients_match_jax():
    run = _run()
    got, want = run["port"][2][0], run["jax_grads"][0]
    assert sorted(got) == sorted(k for k in want if k.startswith("Seg."))
    rows, noise = _grad_errors(got, want)
    assert len(rows) == 35
    _check_grads(rows, noise)


def test_finetune_update_is_stateless_sgd():
    """p1 == p0 - lr * g1 and p2 == p1 - lr * g2 (no momentum) for every
    Seg tensor."""
    run = _run()
    p0 = pm.from_jax_params(run["params"])
    (p1, p2), (g1, g2) = run["port"][1], run["port"][2]
    for before, after, g in ((p0, p1, g1), (p1, p2, g2)):
        for k, v in g.items():
            torch.testing.assert_close(after[k], before[k] - LR * v,
                                       rtol=0, atol=1e-7)


def test_finetune_step2_matches_jax_from_jax_weights():
    """JAX's second update over -lr is its g2 (momentum 0): held to the
    port's gradient at JAX's step-1 weights on the same case."""
    run = _run()
    losses, _, grads, _ = _port_finetune(run["params"], run["img"],
                                         run["lab"], 1, start=run["j1"],
                                         lr=0.0)
    _check_grads(*_grad_errors(grads[0], run["jax_grads"][1]))
    lp, lj = losses[0], run["jax"][0][1]
    for k in LOSS_KEYS:
        assert lp[k] == pytest.approx(lj[k], abs=2e-5), k


def test_finetune_keeps_the_vae_bit_for_bit():
    run = _run()
    p0 = pm.from_jax_params(run["params"])
    model = run["port"][3]
    assert not any(k.startswith("Vae.") for g in run["port"][2] for k in g)
    for snap in run["port"][1]:
        for k, v in snap.items():
            if k.startswith("Vae."):
                assert torch.equal(v, p0[k]), k
    assert all(not p.requires_grad for p in model.Vae.parameters())
    assert all(p.requires_grad for p in model.Seg.parameters())
