"""The port's fused InstanceNorm(+ReLU) (vae_segmentation_tpu_torch/ops/
instance_norm.py) against the JAX package's Pallas function
(vae_segmentation_tpu/ops/pallas/instance_norm.py) in interpret mode on
the CPU, on the cases tests/test_pallas.py uses (C 8, 16, 128; spatial
(8, 8, 8) and (6, 10, 4), whose flat [S * C] tail is no multiple of the
TPU's 128 lanes) and on C 4 and 256. Inputs are drawn with numpy from a
seed. The models, a train step and the CLIs on the norm route are held in
tests/test_torch_norm_models.py and tests/test_torch_norm_step.py.

Tolerances (f32 unless stated): the forward within 2e-5 abs (test_pallas's
bound for the same function), the gradient within 1e-4 abs; the pieces
within 1e-5 of their largest element (the same sums in another order);
bf16 I/O within 1e-2 of the largest |y| (both sides compute f32 statistics
of the same bf16 values and round once to bf16, so they differ by the
roundings that the sums' order flips, one bf16 ulp, 2^-8 relative).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_segmentation_tpu.ops.pallas import instance_norm as jin
from vae_segmentation_tpu_torch import ops as port_ops
from vae_segmentation_tpu_torch.ops import instance_norm as pin
from vae_segmentation_tpu_torch.ops.kernels import build

torch.set_num_threads(2)

CASES = [(c, spatial) for c in (4, 8, 16, 128, 256)
         for spatial in ((8, 8, 8), (6, 10, 4))]


def _draw(seed, c, spatial, batch=2):
    """x (scaled and shifted like test_pallas.py's) and a cotangent."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(batch, *spatial, c)) * 3 + 1).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    return x, g


def _max_err(got, want):
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("c,spatial", CASES)
def test_instance_norm_act_and_gradient_match_jax(c, spatial, relu):
    """Forward within 2e-5 and the gradient of <y, g> within 1e-4 of
    ``jax.vjp`` of the Pallas function (interpret mode)."""
    x, g = _draw(c, c, spatial)
    want, vjp = jax.vjp(lambda v: jin.instance_norm_act(v, relu),
                        jnp.asarray(x))
    want_dx = vjp(jnp.asarray(g))[0]
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pin.instance_norm_act(xt, relu)
    got.backward(torch.from_numpy(g))
    assert got.dtype == torch.float32
    assert _max_err(got.detach(), want) <= 2e-5
    assert _max_err(xt.grad, want_dx) <= 1e-4


@pytest.mark.parametrize("c,spatial", [(16, (8, 8, 8)), (8, (6, 10, 4))])
def test_bf16_io_matches_jax(c, spatial):
    x, _ = _draw(1, c, spatial, batch=1)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jin.instance_norm_act(xb, True), np.float32)
    got = pin.instance_norm_act(
        torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    assert _max_err(got.float(), want) <= 1e-2 * np.abs(want).max()


def _lane_fold(lane, b, c, cycles):
    """JAX's per-lane [B, 2, L] sums -> [B, 2, C] (instance_norm.py:173)."""
    return np.asarray(jnp.asarray(lane).reshape(b, 2, cycles, c).sum(axis=2))


@pytest.mark.parametrize("c,spatial", [(8, (6, 10, 4)), (128, (8, 8, 8)),
                                       (4, (8, 8, 8))])
def test_pieces_match_their_jax_pieces(c, spatial):
    """norm_stats against ``_per_lane_stats`` (folded to channels),
    norm_apply against ``_apply_per_lane``, norm_bwd against ``_bwd``, each
    within 1e-5 of its largest element; norm_bwd_sums against its f64
    value (1e-5), and norm_bwd = norm_bwd_dx after norm_bwd_sums over the
    voxel count, for relu on and off."""
    x, g = _draw(7 + c, c, spatial)
    b, n = x.shape[0], math.prod(spatial)
    plan = jin._flatten_plan(x.shape)
    xf = jin._flat_view(jnp.asarray(x), *plan[:3])
    st_want = _lane_fold(jin._per_lane_stats(xf), b, c, plan[3])
    st = pin.norm_stats_plain(torch.from_numpy(x)).numpy()
    assert _max_err(st, st_want) <= 1e-5 * np.abs(st_want).max()
    s, t = pin.affine_from_stats(torch.from_numpy(st), n)
    for relu in (True, False):
        tile = (lambda v: jnp.tile(jnp.asarray(v.numpy()), (1, plan[3])))
        y_want = jin._unflatten(jin._apply_per_lane(
            xf, tile(s), tile(t), relu), x.shape)
        y = pin.norm_apply_plain(torch.from_numpy(x), s, t, relu)
        assert _max_err(y, y_want) <= 1e-5 * np.abs(np.asarray(y_want)).max()
        # the mean the fold took: JAX's shift -mean * rstd is then t
        mean = jnp.asarray((torch.from_numpy(st)[:, 0] / n).numpy())
        dx_want = jin._bwd(relu, (jnp.asarray(x), mean,
                                  jnp.asarray(s.numpy())), jnp.asarray(g))[0]
        xt, gt = torch.from_numpy(x), torch.from_numpy(g)
        dx = pin.norm_bwd(xt, gt, s, t, relu)
        assert _max_err(dx, dx_want) <= \
            1e-5 * np.abs(np.asarray(dx_want)).max()
        sums = pin.norm_bwd_sums_plain(xt, gt, s, t, relu)
        xhat = x.astype(np.float64) * s.double().numpy()[:, None, None, None] \
            + t.double().numpy()[:, None, None, None]
        gm = np.where(xhat > 0, g, 0.0) if relu else g.astype(np.float64)
        exact = np.stack([gm.sum(axis=(1, 2, 3)),
                          (gm * xhat).sum(axis=(1, 2, 3))], axis=1)
        assert _max_err(sums, exact) <= 1e-5 * np.abs(exact).max()
        torch.testing.assert_close(
            pin.norm_bwd_dx_plain(xt, gt, s, t, sums / n, relu), dx,
            rtol=0, atol=0)


def test_cpu_tensors_run_the_plain_versions_and_build_nothing():
    """On CPU tensors every wrapper is its plain version: no launch is
    counted and no kernel library is loaded."""
    x, g = _draw(3, 8, (4, 4, 4))
    xt, gt = torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16()
    port_ops.reset_launch_counts()
    st = pin.norm_stats(xt)
    s, t = pin.affine_from_stats(st, 64)
    torch.testing.assert_close(pin.norm_apply(xt, s, t),
                               pin.norm_apply_plain(xt, s, t), rtol=0, atol=0)
    sums = pin.norm_bwd_sums(xt, gt, s, t)
    pin.norm_bwd_dx(xt, gt, s, t, sums / 64)
    assert set(port_ops.launch_counts().values()) == {0}
    assert build.loaded() == []
