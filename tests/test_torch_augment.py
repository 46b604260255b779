"""The port's device warp (vae_segmentation_tpu_torch/data/augment.py)
against the JAX package's (vae_segmentation_tpu/data/augment.py, order 1)
on the CPU: the same affine draws (angles, scale, centre) replayed through
both on non-cubic volumes and patches, so that a swapped axis cannot pass.
  * the sampling grid within 1e-4 voxel;
  * the image within 1e-4 of its largest |value| and the label equal,
    except at voxels whose JAX coordinate lies within 1e-4 of the volume's
    border on some axis (the ``inside`` mask may flip there) or, for the
    label, within 1e-4 of a rounding tie; those voxels are counted and the
    count bounded;
  * the law of ``sample_affine_params`` over many draws: ranges, the 50/50
    split of the scale draw, the centre interval.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vae_segmentation_tpu.data import augment as jaug
from vae_segmentation_tpu_torch.data import augment as paug

torch.set_num_threads(2)

IN_SHAPE = (40, 48, 56)
PATCH = (32, 24, 40)
NEAR = 1e-4
# (angles, scale, centre): inside the volume, zoomed out against a corner
# (border exposed on several axes), and at the law's extremes
DRAWS = [
    ((0.1, -0.15, 0.05), 0.93, (20.0, 24.0, 28.0)),
    ((-0.2, 0.2, -0.2), 1.15, (11.0, 37.0, 15.0)),
    ((0.17, 0.03, -0.11), 0.85, (29.0, 7.0, 45.0)),
    ((0.0, 0.0, 0.0), 1.0, (19.5, 23.5, 27.5)),
]


def _volumes(rng):
    image = rng.normal(100.0, 300.0, IN_SHAPE).astype(np.float32)
    label = rng.integers(0, 3, IN_SHAPE).astype(np.float32)
    return image, label


def _jax_warp(image, label, angles, scale, centre):
    img, lab = jaug.warp_with_params(
        jnp.asarray(image), jnp.asarray(label),
        jnp.asarray(angles, jnp.float32), jnp.float32(scale),
        jnp.asarray(centre, jnp.float32), PATCH)
    coords = jaug.affine_coords(jnp.asarray(angles, jnp.float32),
                                jnp.float32(scale),
                                jnp.asarray(centre, jnp.float32), PATCH)
    return np.asarray(img), np.asarray(lab), np.asarray(coords)


def _port_warp(images, labels, draws):
    angles = torch.tensor([d[0] for d in draws], dtype=torch.float32)
    scale = torch.tensor([d[1] for d in draws], dtype=torch.float32)
    centre = torch.tensor([d[2] for d in draws], dtype=torch.float32)
    coords = paug.affine_coords(angles, scale, centre, PATCH)
    img, lab = paug.warp_with_params(torch.from_numpy(images),
                                     torch.from_numpy(labels), angles, scale,
                                     centre, PATCH)
    return img.numpy(), lab.numpy(), coords.numpy()


def test_warp_matches_jax_on_replayed_draws(rng):
    cases = [_volumes(rng) for _ in DRAWS]
    images = np.stack([c[0] for c in cases])
    labels = np.stack([c[1] for c in cases])
    p_img, p_lab, p_coords = _port_warp(images, labels, DRAWS)
    assert p_img.shape == (len(DRAWS), *PATCH) == p_lab.shape
    exposed = skipped_img = skipped_lab = 0
    for i, (angles, scale, centre) in enumerate(DRAWS):
        j_img, j_lab, j_coords = _jax_warp(images[i], labels[i], angles,
                                           scale, centre)
        assert np.abs(p_coords[i] - j_coords).max() <= NEAR
        border = np.zeros(PATCH, bool)
        tie = np.zeros(PATCH, bool)
        for ax, n in enumerate(IN_SHAPE):
            c = j_coords[ax]
            border |= (np.abs(c) <= NEAR) | (np.abs(c - (n - 1)) <= NEAR)
            tie |= np.abs(c - np.floor(c) - 0.5) <= NEAR
        keep = ~border
        err = np.abs(p_img - j_img)[i][keep].max()
        assert err <= 1e-4 * np.abs(j_img).max(), (i, err)
        same = p_lab[i] == j_lab
        assert same[keep & ~tie].all(), i
        exposed += int((j_img == jaug.BORDER_CVAL_DATA).sum())
        skipped_img += int(border.sum())
        skipped_lab += int((border | tie).sum())
    n = len(DRAWS) * int(np.prod(PATCH))
    # the border was reached, and near-border / tie voxels are rare
    assert exposed > 0.05 * n
    assert skipped_img <= 1e-3 * n and skipped_lab <= 2e-3 * n, \
        (skipped_img, skipped_lab, n)


def test_affine_law_over_many_draws():
    n = 20000
    gen = torch.Generator().manual_seed(0)
    angles, scale, centre = paug.sample_affine_params(gen, n, PATCH,
                                                      IN_SHAPE)
    assert angles.shape == (n, 3) and scale.shape == (n,)
    assert centre.shape == (n, 3) and centre.dtype == torch.float32
    assert float(angles.abs().max()) <= paug.ROT_RANGE
    assert float(angles.abs().max()) > 0.99 * paug.ROT_RANGE
    assert abs(float(angles.mean())) < 0.005
    assert paug.SCALE_RANGE[0] <= float(scale.min()) < 0.86
    assert 1.14 < float(scale.max()) <= paug.SCALE_RANGE[1]
    zoom_in = float((scale < 1.0).double().mean())
    assert abs(zoom_in - 0.5) < 5 * (0.25 / n) ** 0.5
    # each branch uniform on its interval
    assert float(scale[scale < 1].mean()) == pytest.approx(0.925, abs=2e-3)
    assert float(scale[scale > 1].mean()) == pytest.approx(1.075, abs=2e-3)
    for ax, (p, s) in enumerate(zip(PATCH, IN_SHAPE)):
        lo, hi = p // 2 - 5, s - (p // 2 - 5)
        c = centre[:, ax]
        assert lo <= float(c.min()) < lo + 0.01 * (hi - lo)
        assert hi - 0.01 * (hi - lo) < float(c.max()) <= hi
        assert float(c.mean()) == pytest.approx((lo + hi) / 2,
                                                abs=0.01 * (hi - lo))


def test_spatial_augment_is_reproducible_from_the_generator(rng):
    image, label = _volumes(rng)
    images = torch.from_numpy(np.stack([image, image]))
    labels = torch.from_numpy(np.stack([label, label]))

    def run(seed):
        return paug.spatial_augment(images, labels,
                                    torch.Generator().manual_seed(seed),
                                    patch_size=PATCH)

    (a_img, a_lab), (b_img, b_lab), (c_img, _) = run(1), run(1), run(2)
    assert torch.equal(a_img, b_img) and torch.equal(a_lab, b_lab)
    assert not torch.equal(a_img, c_img)
    # one draw per sample
    assert not torch.equal(a_img[0], a_img[1])
    assert set(a_lab.unique().tolist()) <= {0.0, 1.0, 2.0}
