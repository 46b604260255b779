"""Carrying weights between the JAX package and the port:
``from_jax_params`` inverts ``torch_compat.convert_state_dict`` exactly
(conv transposes, the ConvTranspose tap flip, dense transposes and the
bottleneck flatten permutations), its keys and shapes are the port model's
state_dict, and the port's bottleneck flatten agrees with the JAX package's
dense layers."""

import math

import numpy as np
import torch

import jax
import jax.numpy as jnp

from vae_segmentation_tpu.models import Joint as JJoint
from vae_segmentation_tpu.models import ShapeVAE as JVae
from vae_segmentation_tpu.models.torch_compat import convert_state_dict
from vae_segmentation_tpu_torch import models as pm

torch.set_num_threads(2)


def _random_params(template, rng):
    return jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), template)


def _flagship_template():
    """Param shapes of the flagship Joint (fmaps 8..256, 128^3, bottleneck
    16384), traced without computing anything."""
    model = JJoint(n_class=2, dim=128, bottleneck=16384)
    return jax.eval_shape(
        lambda x: model.init(jax.random.PRNGKey(0), x),
        jax.ShapeDtypeStruct((1, 128, 128, 128, 1), jnp.float32))["params"]


def _assert_trees_equal(a, b):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(b)[0])
    assert len(fa) == len(fb)
    for path, leaf in fa:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(fb[path]),
                                      err_msg=str(path))


def test_from_jax_params_round_trips_with_convert_state_dict():
    rng = np.random.default_rng(0)
    params = _random_params(_flagship_template(), rng)
    sd = pm.from_jax_params(params)

    port = pm.Joint(n_class=2, dim=128, bottleneck=16384)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    pm.load_state(port, sd)  # strict: every key present and used

    back = convert_state_dict({k: v.numpy() for k, v in sd.items()}, params,
                              "joint")
    _assert_trees_equal(back, params)

    # and the other way round: torch state_dict -> JAX -> torch
    sd2 = {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
           for k, v in sd.items()}
    again = pm.from_jax_params(convert_state_dict(
        {k: v.numpy() for k, v in sd2.items()}, params, "joint"))
    assert again.keys() == sd2.keys()
    for k in sd2:
        assert torch.equal(again[k], sd2[k]), k


def test_load_state_accepts_checkpoint_dicts_and_module_prefix(tmp_path):
    model = pm.SegUNet(fmaps=(2, 2, 2, 2, 2, 2),
                       generator=torch.Generator().manual_seed(0))
    sd = {"module." + k: v.clone() for k, v in model.state_dict().items()}
    path = tmp_path / "best_model.ckpt"
    torch.save({"epoch": 3, "model_state_dict": sd}, path)
    other = pm.SegUNet(fmaps=(2, 2, 2, 2, 2, 2),
                       generator=torch.Generator().manual_seed(1))
    pm.load_state(other, str(path))
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k


def test_bottleneck_flatten_matches_jax_dense_layers():
    """fc_mean(flatten(h)) and unflatten(fc2(z)) of the port equal the JAX
    package's spatial-major dense layers on weights carried across, at a
    2^3 x 32-channel bottleneck (where the two flatten orders differ)."""
    fmaps, side, dim, b = (4, 8, 8, 16, 16, 32), 2, 16, 2
    bott = fmaps[5] * side ** 3
    jm = JVae(n_class=2, fmaps=fmaps, dim=dim, bottleneck=bott,
              dtype=jnp.float32, s2d=False)
    template = jax.eval_shape(
        lambda x: jm.init(jax.random.PRNGKey(0), x),
        jax.ShapeDtypeStruct((1, 64, 64, 64, 2), jnp.float32))["params"]
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape)
                   / math.sqrt(max(s.shape[0], 1))).astype(np.float32),
        template)
    port = pm.ShapeVAE(n_class=2, fmaps=fmaps, dim=dim, bottleneck=bott,
                       dtype=torch.float32)
    pm.load_state(port, pm.from_jax_params(params))

    h = rng.normal(size=(b, side, side, side, fmaps[5])).astype(np.float32)
    z = rng.normal(size=(b, dim)).astype(np.float32)
    want_mean = jm.apply({"params": params}, jnp.asarray(h),
                         method=lambda m, v: m.fc_mean(v.reshape(b, -1)))
    want_dec = jm.apply(
        {"params": params}, jnp.asarray(z),
        method=lambda m, v: m.fc2(v).reshape(b, side, side, side, fmaps[5]))
    with torch.no_grad():
        got_mean = port._dense(port.fc_mean, port.flatten(torch.from_numpy(h)))
        got_dec = port.unflatten(port._dense(port.fc2, torch.from_numpy(z)))
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(want_mean),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_dec.numpy(), np.asarray(want_dec),
                               rtol=1e-5, atol=1e-5)
