"""The soft-ReLU ShapeVAE of ``--softrelu 1`` (``models/vae.py``,
``ShapeVAE(soft=True)``: softplus in place of ReLU after every norm)
against the JAX package's ``ShapeVAE(soft=True)`` on the CPU, on both of
the port's routes: the default one (K1's stats epilogue, the norm applied
with softplus where it is made, no prologue) and the norm route
(``VAESEG_PALLAS=1``: ``instance_norm_act`` without its ReLU, then
softplus). The JAX package's soft stages never take its Pallas norm
(blocks.py:529), so one JAX model is the reference of both routes.

Widths (4, 8, 8, 16, 16, 32), latent 16, batch 2, seeded weights carried
across by ``from_jax_params``. Tolerances, those of
tests/test_torch_models.py and tests/test_torch_source_train.py:
  * forward at 32^3, f32: probabilities 1e-4 abs, mean / std 1e-4 of their
    largest value (measured 1.5e-6 and 1.2e-7); the same weights through
    the ReLU model (soft=False) exceed it;
  * forward at 32^3, bf16: the port no further from the f32 result than
    the JAX package's own bf16 model (max and mean abs, 25% slack);
  * the ``vae_train`` step at 64^3 (a 2^3 bottleneck; at 32^3 the
    encoder's norm makes its output constant), f32, with one seeded eps in
    both packages: Dice 1e-4 abs and KL 1e-3 relative (its log(std +
    1e-5) amplifies the round-off of std entries near 0); gradients per
    tensor relative L2 <= 0.3 and cosine >= 0.97 (the head 2e-2),
    norm-cancelled biases within 0.2 of the largest weight gradient; the
    planted backward fault (K1's stats cotangent without its
    sum-of-squares term) takes the encoder's conv weights out of the band.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dis_steps import (
    _faulty_stats_cotangent, check_grads, grad_errors)
from test_torch_embed_steps import jax_eps, port_eps
from test_torch_train import _draw_params
from vae_segmentation_tpu.models import ShapeVAE as JVae
from vae_segmentation_tpu.train import optim as joptim
from vae_segmentation_tpu.train import steps as jsteps
from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch import train as pt
from vae_segmentation_tpu_torch.ops import conv3 as pconv3

torch.set_num_threads(2)

FMAPS = (4, 8, 8, 16, 16, 32)
BATCH, NC, DIM, LR = 2, 2, 16, 1e-2
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
PDT = {"f32": torch.float32, "bf16": torch.bfloat16}
ROUTES = {"default": None, "norm": "1"}


def _bott(size):
    return FMAPS[5] * (size // 32) ** 3


def _jax_vae(size, dt="f32"):
    return JVae(n_class=NC, fmaps=FMAPS, dim=DIM, bottleneck=_bott(size),
                dtype=JDT[dt], s2d=False, soft=True)


def _port_vae(params, size, dt="f32", soft=True):
    return pm.load_state(pm.ShapeVAE(n_class=NC, fmaps=FMAPS, dim=DIM,
                                     bottleneck=_bott(size), dtype=PDT[dt],
                                     soft=soft),
                         pm.from_jax_params(params))


_CASES = {}


def _case(size):
    if size not in _CASES:
        rng = np.random.default_rng(size)
        template = jax.eval_shape(
            lambda v: _jax_vae(size).init(jax.random.PRNGKey(0), v),
            jax.ShapeDtypeStruct((BATCH, size, size, size, NC),
                                 jnp.float32))["params"]
        logits = rng.normal(size=(BATCH, size, size, size, NC)) * 2
        probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)) \
            .astype(np.float32)
        z, y, x = np.mgrid[:size, :size, :size] - size / 2
        label = np.stack([(((z / rng.uniform(4, size / 4)) ** 2
                            + (y / (size / 5)) ** 2
                            + (x / rng.uniform(4, size / 4)) ** 2) <= 1)
                          .astype(np.float32) for _ in range(BATCH)])
        eps = rng.normal(size=(BATCH, DIM)).astype(np.float32)
        _CASES[size] = (_draw_params(template, rng), probs, label, eps)
    return _CASES[size]


def _jax_forward(dt):
    params, x, _, _ = _case(32)
    out = _jax_vae(32, dt).apply({"params": params}, jnp.asarray(x))
    return [np.asarray(o, np.float32) for o in out]


def _port_forward(dt, route, monkeypatch, soft=True):
    params, x, _, _ = _case(32)
    with monkeypatch.context() as m:
        if ROUTES[route]:
            m.setenv("VAESEG_PALLAS", ROUTES[route])
        else:
            m.delenv("VAESEG_PALLAS", raising=False)
        with torch.no_grad():
            out = _port_vae(params, 32, dt, soft)(
                torch.from_numpy(x).to(PDT[dt]))
    return [o.float().numpy() for o in out]


@pytest.mark.parametrize("route", ["default", "norm"])
def test_soft_vae_forward_f32(route, monkeypatch):
    got = _port_forward("f32", route, monkeypatch)
    want = _jax_forward("f32")
    for name, g, w in zip(("recon", "mean", "std"), got, want):
        tol = 1e-4 if name == "recon" else 1e-4 * np.abs(w).max()
        assert np.abs(g - w).max() <= tol, (name, np.abs(g - w).max())
    # the same weights through the ReLU blocks are another function
    relu = _port_forward("f32", route, monkeypatch, soft=False)
    assert max(np.abs(g - w).max() for g, w in zip(relu, want)) > 1e-2


@pytest.mark.parametrize("route", ["default", "norm"])
def test_soft_vae_forward_bf16(route, monkeypatch):
    got = _port_forward("bf16", route, monkeypatch)
    want, truth = _jax_forward("bf16"), _jax_forward("f32")
    for name, g, w, t in zip(("recon", "mean", "std"), got, want, truth):
        port_err, ref_err = np.abs(g - t), np.abs(w - t)
        assert port_err.max() <= 1.25 * ref_err.max() + 1e-3, \
            (name, port_err.max(), ref_err.max())
        assert port_err.mean() <= 1.25 * ref_err.mean() + 1e-4, \
            (name, port_err.mean(), ref_err.mean())


_STEP = {}


def _jax_step():
    if not _STEP:
        params, _, label, eps = _case(64)
        tx = joptim.sgd(LR)
        step = jsteps.make_vae_train_step(_jax_vae(64), tx, NC)
        state = jsteps.init_state(jax.tree.map(jnp.asarray, params), tx)
        with jax_eps(eps):
            state, aux = step(state, jnp.asarray(label),
                              jax.random.PRNGKey(2))
        p0 = pm.from_jax_params(params)
        p1 = pm.from_jax_params(jax.tree.map(np.asarray, state.params))
        _STEP.update(aux={k: float(v) for k, v in aux.items()},
                     grads={k: (p0[k] - p1[k]) / LR for k in p0})
    return _STEP


def _port_step(route, monkeypatch):
    params, _, label, eps = _case(64)
    with monkeypatch.context() as m:
        if ROUTES[route]:
            m.setenv("VAESEG_PALLAS", ROUTES[route])
        else:
            m.delenv("VAESEG_PALLAS", raising=False)
        vae = _port_vae(params, 64)
        opt = pt.optim.sgd(vae.parameters(), LR)
        with port_eps(eps):
            aux = pt.make_vae_train_step(NC)(
                vae, opt, torch.from_numpy(label),
                torch.Generator().manual_seed(0))
    return {k: float(v) for k, v in aux.items()}, \
        {k: p.grad.clone() for k, p in vae.named_parameters()}


@pytest.mark.parametrize("route", ["default", "norm"])
def test_soft_vae_train_step_matches_jax(route, monkeypatch):
    want = _jax_step()
    aux, grads = _port_step(route, monkeypatch)
    assert aux["dice_loss"] == pytest.approx(want["aux"]["dice_loss"],
                                             abs=1e-4)
    assert aux["kl_loss"] == pytest.approx(want["aux"]["kl_loss"], rel=1e-3)
    rows, noise = grad_errors(grads, want["grads"])
    # 42 conv weights, the head bias, 10 bridge biases, 3 dense pairs
    assert len(rows) == 59
    check_grads(rows, noise, ("out_block",))


def test_soft_vae_gradient_band_excludes_a_planted_fault(monkeypatch):
    monkeypatch.setattr(pconv3, "stats_cotangent", _faulty_stats_cotangent)
    _, grads = _port_step("default", monkeypatch)
    rows, _ = grad_errors(grads, _jax_step()["grads"])
    enc = {k: v for k, v in rows.items() if k.endswith(".weight")
           and k.split(".")[0] in ("in_block", "down1", "down2", "down3",
                                   "down4", "down5")}
    assert enc and all(rel > 0.3 for rel, _ in enc.values()), \
        sorted((v, k) for k, v in enc.items())[:5]
