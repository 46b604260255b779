"""The port's Embed methods (``train/steps.py::make_embed_train_step``,
``::make_refine_vae_step``) against the JAX package's (train/steps.py:
584-660) on the CPU (``eval/evaluate.py::make_embed_eval_step`` is held in
tests/test_torch_encoder_models.py), with the JAX source CLI's wiring
(cli/source_main.py:91-103): embed_train with the VAE frozen
(``optim.freeze_vae``) and the Encoder's gradient times ``enc_on`` (0 and
1), refine_vae with the VAE's encoder half frozen
(``optim.freeze_vae_encoder``); SGD at momentum 0.9 (zero buffer at step
1).

At 64^3 (a 2^3 bottleneck) with tests/test_torch_train.py's widths, latent
16, seeded weights carried across by ``from_jax_params``, batch 2, f32.
The gt branch's latent is sampled (scale 0.5) in both packages; the JAX
draw cannot be reproduced in torch, so one seeded eps goes into both:
``jax.random.normal`` returns it for the latent's shape while the JAX step
is traced, and the port's ``ops.reparam.philox_normal_plain`` returns it.
Tolerances (``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_embed_steps.py`` prints the measured errors), those of
tests/test_torch_dis_steps.py: loss terms 2e-5 abs (the KL 1e-3 relative:
its log(std + 1e-5) amplifies the f32 round-off of the std entries near 0,
measured 1.9e-4; the latent MSE 5e-4 relative, the 64^3 VAE encoder's
mean limit of tests/test_torch_models.py, measured 1.2e-4);
gradients per tensor relative L2 <= 0.3 and cosine >= 0.97 (the heads
2e-2), norm-cancelled conv biases within 0.2 of the largest
weight gradient; the planted backward fault (K1's stats cotangent without
its sum-of-squares term) takes every 3^3 conv weight but the last stage's
out of the band; what is frozen, and the Encoder at enc_on 0 and
under refine_vae, does not move in either package.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dis_steps import (
    _faulty_stats_cotangent, check_grads, grad_errors)
from test_torch_train import _draw_params
from vae_segmentation_tpu.models import Embed as JEmbed
from vae_segmentation_tpu.train import optim as joptim
from vae_segmentation_tpu.train import steps as jsteps
from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch import train as pt
from vae_segmentation_tpu_torch.ops import conv3 as pconv3
from vae_segmentation_tpu_torch.ops import reparam as preparam

torch.set_num_threads(2)

FMAPS = (4, 8, 8, 16, 16, 32)
SIZE, BATCH, NC, DIM, LR = 64, 2, 2, 16, 1e-2
BOTT = FMAPS[5] * (SIZE // 32) ** 3
LOSS_ABS = 2e-5
KL_REL = 1e-3       # the KL's log(std + 1e-5) amplifies the round-off of
                    # the std entries near 0 (20 of the 32 are 0 after the
                    # ReLU here): measured 1.9e-4
MSE_REL = 5e-4      # the mean latent of the 64^3 VAE encoder is held to
                    # 5e-4 of its largest value (tests/test_torch_models.py
                    # LIMITS_64): measured 1.2e-4
KEYS = {"embed": ("dice_loss1", "dice_loss2", "mse_loss", "inpaint_loss",
                  "recon_loss", "final_loss"),
        "refine": ("recon_loss", "inpaint_loss", "init_loss",
                   "final_loss")}
# the heads: no norm between them and the loss
HEADS = ("out_block",)
# the trained subtrees of each method (what has a gradient)
TRAINED = {"embed": ("Encoder.", "Fusion."),
           "refine": ("Vae.fc2.", "Vae.up", "Vae.out_block.")}


def _jax_embed():
    return JEmbed(n_class=NC, dim=DIM, fmaps=FMAPS, bottleneck=BOTT,
                  dtype=jnp.float32)


def _port_embed(params):
    return pm.load_state(pm.Embed(n_class=NC, dim=DIM, fmaps=FMAPS,
                                  bottleneck=BOTT, dtype=torch.float32),
                         pm.from_jax_params(params))


def _case():
    rng = np.random.default_rng(1)
    template = jax.eval_shape(
        lambda a, b: _jax_embed().init(
            {"params": jax.random.PRNGKey(0),
             "reparam": jax.random.PRNGKey(1)}, a, b),
        jax.ShapeDtypeStruct((BATCH, SIZE, SIZE, SIZE, 1), jnp.float32),
        jax.ShapeDtypeStruct((BATCH, SIZE, SIZE, SIZE, NC),
                             jnp.float32))["params"]
    params = _draw_params(template, rng)
    z, y, x = np.mgrid[:SIZE, :SIZE, :SIZE] - SIZE / 2
    label = np.stack([(((z / rng.uniform(8, 16)) ** 2 + (y / 12) ** 2
                        + (x / rng.uniform(8, 16)) ** 2) <= 1)
                      .astype(np.float32) for _ in range(BATCH)])
    image = (rng.normal(size=label.shape) * 0.3 + label).astype(np.float32)
    eps = rng.normal(size=(BATCH, DIM)).astype(np.float32)
    return params, image, label, eps


@contextlib.contextmanager
def jax_eps(eps):
    """jax.random.normal returns `eps` for the latent's shape."""
    real = jax.random.normal

    def normal(key, shape=(), dtype=jnp.float32):
        if tuple(shape) == eps.shape:
            return jnp.asarray(eps, dtype)
        return real(key, shape, dtype)

    jax.random.normal = normal
    try:
        yield
    finally:
        jax.random.normal = real


@contextlib.contextmanager
def port_eps(eps):
    """The port's reparam draw returns `eps`."""
    real = preparam.philox_normal_plain
    preparam.philox_normal_plain = lambda *a, **k: torch.from_numpy(eps)
    try:
        yield
    finally:
        preparam.philox_normal_plain = real


_JAX_STEPS = {}


def _jax_step(kind, params, image, label, eps, enc_on=1.0):
    """JAX's step 1 (one jitted step per kind: enc_on is traced)."""
    params = jax.tree.map(jnp.asarray, params)
    if kind not in _JAX_STEPS:
        if kind == "embed":
            tx = joptim.freeze_vae(joptim.sgd(LR), params)
            step = jsteps.make_embed_train_step(_jax_embed(), tx, NC)
        else:
            tx = joptim.freeze_vae_encoder(joptim.sgd(LR), params)
            step = jsteps.make_refine_vae_step(_jax_embed(), tx, NC)
        _JAX_STEPS[kind] = (tx, step)
    tx, step = _JAX_STEPS[kind]
    args = (jnp.float32(enc_on),) if kind == "embed" else ()
    state = jsteps.init_state(params, tx)
    with jax_eps(eps):
        state, aux = step(state, jnp.asarray(image), jnp.asarray(label),
                          jax.random.PRNGKey(3), *args)
    return {k: float(v) for k, v in aux.items()}, \
        pm.from_jax_params(jax.tree.map(np.asarray, state.params))


def _port_step(kind, params, image, label, eps, enc_on=1.0):
    """(aux, gradients, state_dict after the step)."""
    model = _port_embed(params)
    if kind == "embed":
        opt = pt.optim.sgd(pt.optim.freeze_vae(model), LR)
        step = pt.make_embed_train_step(NC)
        args = (enc_on,)
    else:
        opt = pt.optim.sgd(pt.optim.freeze_vae_encoder(model), LR)
        step = pt.make_refine_vae_step(NC)
        args = ()
    with port_eps(eps):
        aux = step(model, opt, torch.from_numpy(image),
                   torch.from_numpy(label), torch.Generator().manual_seed(0),
                   *args)
    grads = {k: p.grad.clone() for k, p in model.named_parameters()
             if p.grad is not None}
    return {k: float(v) for k, v in aux.items()}, grads, \
        {k: v.detach().clone() for k, v in model.state_dict().items()}


_RUN = {}


def _run(kind, enc_on=1.0):
    if "case" not in _RUN:
        _RUN["case"] = _case()
    key = (kind, enc_on)
    if key not in _RUN:
        params, image, label, eps = _RUN["case"]
        jaux, jnew = _jax_step(kind, params, image, label, eps, enc_on)
        p0 = pm.from_jax_params(params)
        _RUN[key] = {"p0": p0, "jax_aux": jaux, "jax_new": jnew,
                     "jax_grads": {k: (p0[k] - jnew[k]) / LR for k in p0},
                     "port": _port_step(kind, params, image, label, eps,
                                        enc_on)}
    return _RUN[key]


def _trained(kind, key):
    return key.startswith(TRAINED[kind])


def _check_terms(kind, run):
    paux, jaux = run["port"][0], run["jax_aux"]
    for k in KEYS[kind]:
        tol = MSE_REL * abs(jaux[k]) if k == "mse_loss" else LOSS_ABS
        assert paux[k] == pytest.approx(jaux[k], abs=tol), k
    assert paux["kl_loss"] == pytest.approx(jaux["kl_loss"], rel=KL_REL)


def _check_unmoved(kind, run, enc_on):
    """What takes no update stays bit for bit in both packages."""
    p0, jnew, pnew = run["p0"], run["jax_new"], run["port"][2]
    still = [k for k in p0 if not _trained(kind, k)
             or (k.startswith("Encoder.") and not enc_on)]
    assert still
    for k in still:
        assert torch.equal(pnew[k], p0[k]), k
        assert torch.equal(jnew[k], p0[k]), k


@pytest.mark.parametrize("enc_on", [0.0, 1.0])
def test_embed_train_step_matches_jax(enc_on):
    run = _run("embed", enc_on)
    _check_terms("embed", run)
    grads = run["port"][1]
    assert sorted(grads) == sorted(k for k in run["p0"]
                                   if _trained("embed", k))
    live = {k: v for k, v in run["jax_grads"].items()
            if k.startswith("Fusion.") or (enc_on and
                                          k.startswith("Encoder."))}
    rows, noise = grad_errors(grads, live)
    check_grads(rows, noise, HEADS)
    if not enc_on:
        assert all(not grads[k].any() for k in grads
                   if k.startswith("Encoder."))
    _check_unmoved("embed", run, enc_on)


def test_refine_vae_step_matches_jax():
    run = _run("refine")
    _check_terms("refine", run)
    grads = run["port"][1]
    assert sorted(grads) == sorted(k for k in run["p0"]
                                   if _trained("refine", k))
    rows, noise = grad_errors(grads, {k: v for k, v in
                                      run["jax_grads"].items()
                                      if k in grads})
    check_grads(rows, noise, HEADS)
    _check_unmoved("refine", run, 0.0)


@pytest.mark.parametrize("kind", ["embed", "refine"])
def test_gradient_band_excludes_a_planted_fault(monkeypatch, kind):
    run = _run(kind)
    params, image, label, eps = _RUN["case"]
    with monkeypatch.context() as m:
        m.setattr(pconv3, "stats_cotangent", _faulty_stats_cotangent)
        got = _port_step(kind, params, image, label, eps)[1]
    rows, _ = grad_errors(got, {k: v for k, v in run["jax_grads"].items()
                                if k in got})
    # every 3^3 conv weight but the last stage's (up5's DoubleConv, whose
    # norms the fault reaches least: measured 0.2-0.24 there, 0.5-4 above)
    convs = {k: v for k, v in rows.items() if ".conv." in k
             and k.endswith(".weight") and "up5.conv.1." not in k}
    assert convs and all(rel > 0.3 for rel, _ in convs.values()), \
        sorted((v, k) for k, v in convs.items())[:5]


def _report():
    for kind, enc_on in (("embed", 1.0), ("embed", 0.0), ("refine", 1.0)):
        run = _run(kind, enc_on)
        grads = run["port"][1]
        rows, noise = grad_errors(grads, {k: v for k, v in
                                          run["jax_grads"].items()
                                          if k in grads})
        print(kind, enc_on, "noise", noise, run["port"][0],
              run["jax_aux"])
        for k, v in sorted(rows.items(), key=lambda kv: -kv[1][0])[:12]:
            print(f"  {k}: rel {v[0]:.3g} cos {v[1]:.5f}")


if __name__ == "__main__":
    _report()
