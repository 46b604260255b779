"""The port's connected-component post-processing (vae_segmentation_tpu_
torch/eval/postprocess.py) against the JAX package's on seeded masks:
equal exactly, dtype included."""

import numpy as np
import pytest

from vae_segmentation_tpu.eval import postprocess as jpp
from vae_segmentation_tpu_torch.eval import postprocess as ppp


def _mask(seed, shape=(40, 36, 44), n_balls=6):
    """Several balls of seeded centres and radii (some touching, so some
    components merge), plus scattered single voxels."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"))
    mask = np.zeros(shape, bool)
    for _ in range(n_balls):
        c = rng.uniform(0, np.array(shape))
        r = rng.uniform(1.5, 7.0)
        mask |= np.sum((g - c[:, None, None, None]) ** 2, axis=0) <= r * r
    mask |= rng.random(shape) > 0.999
    return mask


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("keep", [1, 2])
def test_largest_components_match_jax(seed, keep):
    """min_voxels below the smallest component, between two component
    sizes, and above the largest; float and int8 inputs."""
    mask = _mask(seed)
    _, n = jpp.connected_components(mask)
    assert n > 3
    sizes = np.sort(np.bincount(jpp.connected_components(mask)[0].ravel())
                    [1:])
    for min_voxels in (1, int(sizes[-2]) + 1, int(sizes[-1]) + 1, 10000):
        for m in (mask, mask.astype(np.float32), mask.astype(np.int8)):
            got = ppp.largest_components(m, min_voxels=min_voxels, keep=keep)
            want = jpp.largest_components(m, min_voxels=min_voxels,
                                          keep=keep)
            assert got.dtype == want.dtype == np.int8
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("connectivity", [1, 2, 3])
def test_connected_components_match_jax(connectivity):
    mask = _mask(7)
    got, n_got = ppp.connected_components(mask, connectivity)
    want, n_want = jpp.connected_components(mask, connectivity)
    assert n_got == n_want
    np.testing.assert_array_equal(got, want)


def test_empty_mask_matches_jax():
    for m in (np.zeros((8, 9, 10), np.float32), np.zeros((4, 4, 4), bool)):
        got = ppp.largest_components(m)
        np.testing.assert_array_equal(got, jpp.largest_components(m))
        assert got.dtype == np.int8 and got.sum() == 0
        assert ppp.connected_components(m)[1] == 0
