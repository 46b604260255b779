"""The port's models on the norm route (VAESEG_PALLAS=1: every norm+ReLU
through ``ops.instance_norm.instance_norm_act``, no stats epilogue, no
deferred affine) against the JAX package's models under the same switch on
the CPU, where its norms run the Pallas function in interpret mode (each
forward jitted). Weights and inputs are tests/test_torch_models.py's seeded
cases (fmaps (4, 8, 8, 16, 16, 32), batch 2, f32), carried across with
``from_jax_params``.

Tolerances are test_torch_models.py's: at 32^3 probabilities within 1e-4
abs, mean and std within 1e-4 of their largest magnitude, per-case Dice
within 1e-4; the ShapeVAE at 64^3 (a 2^3 bottleneck: the encoder counts)
within ``LIMITS_64``, which sit between the port's f32 summation-order
drift and a planted norm fault."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_models as tm
from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch.models import blocks as pblocks

torch.set_num_threads(2)


def _jax_norm_route(kind, size):
    """The JAX model's outputs under VAESEG_PALLAS=1 (the caller sets it:
    the switch is read while tracing), the VAE's pre-flatten activation
    last."""
    params, x, _ = tm._case(kind, size)
    model = tm._jax_model(kind, "f32", size)
    out = jax.jit(lambda p, v: model.apply({"params": p}, v))(
        params, jnp.asarray(x))
    out = list(out) if isinstance(out, tuple) else [out]
    if kind == "vae":
        out.append(jax.jit(lambda p, v: model.apply(
            {"params": p}, v, method=tm._jax_encode_act))(
                params, jnp.asarray(x)))
    return [np.asarray(o, np.float32) for o in out]


@pytest.mark.parametrize("kind,size", [("seg", 32), ("vae", 32),
                                       ("vae", 64)])
def test_models_match_jax_on_the_norm_route(monkeypatch, kind, size):
    monkeypatch.setenv("VAESEG_PALLAS", "1")
    calls = []
    real = pblocks.instance_norm_act
    monkeypatch.setattr(pblocks, "instance_norm_act",
                        lambda x: (calls.append(1), real(x))[1])
    got, model = tm._port_out(kind, "f32", size)
    want = _jax_norm_route(kind, size)
    # one norm per conv but the head (SegUNet 25, ShapeVAE 31)
    assert len(calls) == sum(isinstance(m, pblocks.Conv3)
                             for m in model.modules()) - 1
    err = tm._errors(kind, got, want)
    if size == 64:
        assert all(err[n] <= lim for n, lim in tm.LIMITS_64[kind].items()), \
            err
    else:
        assert all(e <= 1e-4 for n, e in err.items() if n != "act"), err
    if kind == "seg":
        tm._check_dice(kind, got, want, tm._case(kind, size)[2], 1e-4)


@pytest.mark.parametrize("switch", ["VAESEG_PALLAS", "VAESEG_MERGED_BWD"])
def test_jax_params_run_under_each_switch(monkeypatch, switch):
    """JAX params through ``from_jax_params`` into one port Joint, which
    runs forward and backward with no switch and under `switch`: the same
    state_dict keys serve both routes, and the port computes one function
    on both (f32; the default route's stats epilogue and prologues do what
    the norm route's kernels do, and the merged backward is the pair;
    measured equal on the CPU, held within 1e-6)."""
    params, _, _ = tm._case("joint")
    model = tm._port_model("joint", "f32")
    pm.load_state(model, pm.from_jax_params(params))
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(1, 32, 32, 32, 1)).astype(np.float32))

    def run():
        model.zero_grad()
        out = model(x)
        (out[0][..., 1].mean() + out[1][..., 1].mean()).backward()
        return [o.detach() for o in out] + [
            p.grad.clone() for p in model.parameters()
            if p.grad is not None]

    base = run()
    assert len(base) > 60
    monkeypatch.setenv(switch, "1")
    got = run()
    assert len(got) == len(base)
    for a, b in zip(base, got):
        assert (a - b).abs().max() <= 1e-6 * max(a.abs().max().item(), 1.0)
