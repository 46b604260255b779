"""The mesh's collectives (``parallel/collectives.py``) in 2- and 4-rank gloo
worlds on the CPU, forward and backward, against one process that computes
every rank's output from the whole tensor.

Each rank applies a collective to its slice of one global x and takes the
backward of sum(y * c_r) with its own weights c_r. Under the port's
gradient convention (each collective's standard adjoint) the gradient a
rank gets for its slice is that of sum over ranks of sum(y_r * c_r) with
respect to the whole x, sliced: the one-process reference below. The halo
exchange's edges (zero planes past the volume) are included; a backward
that were the identity would miss the other ranks' terms. ``mean_grads``
must give every rank the same bits, those of the rank-order sum over the
mesh size. Inputs from a numpy seed; f64, so forward values are exact
(sums of at most 4 terms of [-1, 1) draws compared at 1e-12)."""

import numpy as np
import pytest
import torch

import torch_dist_workers as W
from vae_segmentation_tpu_torch.parallel import launch

NAMES = ("halo", "spatial_sum", "gather_spatial", "gather_data", "data_mean")


def _slices(rank, n_data, n_sp, b, d):
    di, si = divmod(rank, n_sp)
    bl, dl = b // n_data, d // n_sp
    return slice(di * bl, (di + 1) * bl), slice(si * dl, (si + 1) * dl)


def _reference(x, name, rank, n_data, n_sp):
    """Rank `rank`'s output of collective `name`, from the whole x."""
    b, d = x.shape[:2]
    items, planes = _slices(rank, n_data, n_sp, b, d)
    di, si = divmod(rank, n_sp)
    if name == "halo":
        z = torch.zeros_like(x[:, :1])
        xp = torch.cat([z, x, z], dim=1)[items]
        dl = d // n_sp
        return xp[:, si * dl:si * dl + dl + 2]
    if name == "spatial_sum":
        return sum(x[items, _slices(di * n_sp + s, n_data, n_sp, b, d)[1]]
                   for s in range(n_sp))
    if name == "gather_spatial":
        return x[items]
    if name == "gather_data":
        return x[:, planes]
    return sum(x[_slices(k * n_sp + si, n_data, n_sp, b, d)[0], planes]
               for k in range(n_data)) / n_data


@pytest.mark.parametrize("n_data,n_sp", [(1, 2), (2, 1), (2, 2), (1, 4)])
def test_collectives_forward_and_backward(n_data, n_sp):
    world = n_data * n_sp
    rng = np.random.default_rng(10 * n_data + n_sp)
    x = rng.uniform(-1, 1, size=(2, 4, 3, 2, 2))
    xt = torch.from_numpy(x)
    c = []
    for r in range(world):
        c.append({n: rng.uniform(-1, 1, size=tuple(
            _reference(xt, n, r, n_data, n_sp).shape)) for n in NAMES})
        c[-1]["grad"] = rng.uniform(-1, 1, size=(3, 5)).astype(np.float32)
    got = launch.spawn(W.collectives, world, timeout=90.0,
                       args=(n_data, n_sp, x, c))
    for name in NAMES:
        xg = xt.clone().requires_grad_(True)
        total = sum((_reference(xg, name, r, n_data, n_sp)
                     * torch.from_numpy(c[r][name])).sum()
                    for r in range(world))
        total.backward()
        for r in range(world):
            items, planes = _slices(r, n_data, n_sp, *x.shape[:2])
            y, g = got[r][name]
            want_y = _reference(xt, name, r, n_data, n_sp).numpy()
            np.testing.assert_allclose(y, want_y, rtol=0, atol=1e-12,
                                       err_msg=f"{name} rank {r}")
            np.testing.assert_allclose(
                g, xg.grad[items, planes].numpy(), rtol=0, atol=1e-12,
                err_msg=f"{name} backward rank {r}")
    want = torch.from_numpy(c[0]["grad"]).clone()
    for r in range(1, world):
        want += torch.from_numpy(c[r]["grad"])
    want /= world
    for r in range(world):
        assert np.array_equal(got[r]["mean_grads"], want.numpy()), r


def test_halo_backward_is_not_the_identity():
    """The halo exchange's gradient at a slab's boundary planes holds the
    neighbours' terms: dropping them (an identity backward) changes it."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, size=(1, 4, 2, 2, 1))
    c = [{n: rng.uniform(-1, 1, size=tuple(_reference(
        torch.from_numpy(x), n, r, 1, 2).shape)) for n in NAMES}
        for r in range(2)]
    for r in range(2):
        c[r]["grad"] = np.zeros((3, 5), np.float32)
    got = launch.spawn(W.collectives, 2, timeout=90.0, args=(1, 2, x, c))
    g0 = got[0]["halo"][1]
    own = c[0]["halo"][:, 1:-1]
    assert not np.allclose(g0, own)
    np.testing.assert_allclose(g0[:, :-1], own[:, :-1], atol=1e-12)
    np.testing.assert_allclose(g0[:, -1], own[:, -1] + c[1]["halo"][:, 0],
                               atol=1e-12)


def test_a_failing_rank_fails_the_world():
    """A rank that raises fails spawn with its traceback, and the others,
    waiting on it in a collective, are killed: no hang."""
    with pytest.raises(RuntimeError, match=r"rank \d of 2 failed"):
        launch.spawn(W.collectives, 2, timeout=60.0,
                     args=(1, 2, np.zeros((1, 3, 1, 1, 1)), [{}, {}]))
