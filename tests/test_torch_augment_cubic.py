"""The port's cubic warp (``--aug_order 3``; vae_segmentation_tpu_torch/
data/augment.py) against the JAX package's (vae_segmentation_tpu/data/
augment.py) and against scipy on the CPU. Tolerances:

  * ``prefilter_matrix`` against scipy's ``spline_filter1d`` (mirror mode)
    and the JAX package's recursion, in f64: 1e-12 of the input's largest
    |value|;
  * ``map_coordinates_cubic`` in f64 against scipy's ``map_coordinates``
    (order 3) and the JAX function under x64: ``F64_TOL`` = 1e-10 of the
    volume's largest |value| (measured 0.8e-15 to 1.7e-15);
  * in f32 against scipy in f64: ``F32_TOL`` = 4e-6 of the volume's
    largest |value| (the prefilter in f64 rounded once, then 64 f32 taps;
    measured 1.6e-7 to 6.9e-7). The card test and chip_smoke phase 15
    hold the card's f32 warp to its CPU run in f64 by the same rule;
  * ``warp_with_params(order=3)`` against the golden scipy oracle
    (tests/fixtures/augment_golden.npz, read only): max abs <= 1e-3, mean
    <= 1e-4 (the oracle's image stored in f32, values ~1e3; measured
    4.3e-4 / 4.4e-5 in f32), the label equal to the oracle's; in f64
    against the JAX function under x64 on the same draws: within F64_TOL,
    the mask and the label equal;
  * ``spatial_augment`` and the train ingest take the order through.
"""

import os

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax
import jax.numpy as jnp

from vae_segmentation_tpu.data import augment as jaug
from vae_segmentation_tpu_torch.cli import common
from vae_segmentation_tpu_torch.core.config import SourceConfig
from vae_segmentation_tpu_torch.data import augment as paug
from vae_segmentation_tpu_torch.data.pipeline import intensity_normalize

torch.set_num_threads(2)

F64_TOL = 1e-10
F32_TOL = 4e-6
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "augment_golden.npz")


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


@pytest.mark.parametrize("n", [1, 2, 3, 17, 128])
def test_prefilter_matrix_is_the_mirror_spline_filter(n):
    x = np.random.default_rng(n).normal(size=(n, 5)) * 100
    got = paug.prefilter_matrix(n) @ x
    want = ndimage.spline_filter1d(x, order=3, axis=0, mode="mirror")
    assert np.abs(got - want).max() <= 1e-12 * np.abs(x).max()
    with jax.enable_x64(True):
        j = np.asarray(jaug._spline_filter1d_mirror(jnp.asarray(x), 0))
    assert np.abs(got - j).max() <= 1e-12 * np.abs(x).max()


def _coords(rng, shape, out=(7, 9, 8), margin=2.5):
    """Coordinates reaching `margin` past each border (mirrored taps)."""
    return np.stack([rng.uniform(-margin, n - 1 + margin, out)
                     for n in shape])


@pytest.mark.parametrize("shape", [(18, 20, 16), (5, 33, 9), (2, 6, 1)])
def test_map_coordinates_cubic_matches_scipy_and_jax(shape):
    rng = np.random.default_rng(sum(shape))
    vol = rng.normal(size=shape) * 300
    coords = _coords(rng, shape)
    want = ndimage.map_coordinates(vol, coords, order=3, mode="mirror")
    got = paug.map_coordinates_cubic(torch.from_numpy(vol),
                                     torch.from_numpy(coords)).numpy()
    scale = np.abs(vol).max()
    assert got.dtype == np.float64 and got.shape == coords.shape[1:]
    assert np.abs(got - want).max() <= F64_TOL * scale
    with jax.enable_x64(True):
        j = np.asarray(jaug.map_coordinates_cubic(jnp.asarray(vol),
                                                  jnp.asarray(coords)))
    assert np.abs(got - j).max() <= F64_TOL * scale
    got32 = paug.map_coordinates_cubic(
        torch.from_numpy(vol).float(), torch.from_numpy(coords).float())
    assert got32.dtype == torch.float32
    # the f32 coordinates are the ones both runs take
    c32 = torch.from_numpy(coords).float().double().numpy()
    want32 = ndimage.map_coordinates(vol, c32, order=3, mode="mirror")
    assert np.abs(got32.numpy() - want32).max() <= F32_TOL * scale


def test_batched_map_coordinates_is_per_sample():
    rng = np.random.default_rng(3)
    vols = rng.normal(size=(3, 10, 12, 9))
    coords = np.stack([_coords(rng, vols.shape[1:]) for _ in range(3)])
    got = paug.map_coordinates_cubic(torch.from_numpy(vols),
                                     torch.from_numpy(coords))
    for i in range(3):
        one = paug.map_coordinates_cubic(torch.from_numpy(vols[i]),
                                         torch.from_numpy(coords[i]))
        assert torch.equal(got[i], one)


def _replay(golden, i, dtype):
    image = torch.from_numpy(golden["image"]).to(dtype)[None]
    label = torch.from_numpy(golden["label"]).to(dtype)[None]
    draw = [torch.tensor(golden[f"{k}_{i}"]).to(dtype)[None]
            for k in ("angles", "scale", "center")]
    return image, label, draw


def test_order3_warp_matches_the_scipy_oracle(golden):
    patch = tuple(int(p) for p in golden["patch"])
    for i in range(int(golden["n_cases"])):
        for dtype in (torch.float32, torch.float64):
            image, label, draw = _replay(golden, i, dtype)
            img, lab = paug.warp_with_params(image, label, *draw, patch,
                                             order=3)
            assert img.dtype == dtype and img.shape == (1, *patch)
            delta = np.abs(img[0].double().numpy()
                           - golden[f"img_order3_{i}"])
            assert delta.max() <= 1e-3 and delta.mean() <= 1e-4, \
                (i, dtype, delta.max(), delta.mean())
            np.testing.assert_array_equal(lab[0].numpy(),
                                          golden[f"lab_order0_{i}"])


def test_order3_warp_matches_jax_in_f64(golden):
    """The golden draws and two more that expose the border, through both
    packages in f64: image within F64_TOL of the volume's largest |value|,
    label and the border fill equal."""
    patch = tuple(int(p) for p in golden["patch"])
    draws = [tuple(golden[f"{k}_{i}"].astype(np.float64)
                   for k in ("angles", "scale", "center"))
             for i in range(int(golden["n_cases"]))]
    draws += [(np.array([0.2, -0.2, 0.1]), np.float64(1.15),
               np.array([4.0, 30.0, 6.0])),
              (np.array([-0.1, 0.05, 0.2]), np.float64(0.85),
               np.array([27.0, 5.0, 25.0]))]
    image = golden["image"].astype(np.float64)
    label = golden["label"].astype(np.float64)
    scale = np.abs(image).max()
    filled = 0
    for angles, sc, centre in draws:
        with jax.enable_x64(True):
            j_img, j_lab = jaug.warp_with_params(
                jnp.asarray(image), jnp.asarray(label), jnp.asarray(angles),
                jnp.asarray(sc), jnp.asarray(centre), patch, order=3)
            j_img, j_lab = np.asarray(j_img), np.asarray(j_lab)
        img, lab = paug.warp_with_params(
            torch.from_numpy(image)[None], torch.from_numpy(label)[None],
            torch.from_numpy(angles)[None], torch.tensor([float(sc)],
                                                         dtype=torch.float64),
            torch.from_numpy(centre)[None], patch, order=3)
        img, lab = img[0].numpy(), lab[0].numpy()
        assert np.abs(img - j_img).max() <= F64_TOL * scale
        np.testing.assert_array_equal(img == paug.BORDER_CVAL_DATA,
                                      j_img == jaug.BORDER_CVAL_DATA)
        np.testing.assert_array_equal(lab, j_lab)
        filled += int((img == paug.BORDER_CVAL_DATA).sum())
    assert filled > 0


def test_spatial_augment_and_the_ingest_take_the_order():
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.normal(100, 300, (2, 36, 40, 34))
                              .astype(np.float32))
    labels = torch.from_numpy((rng.random((2, 36, 40, 34)) > 0.6)
                              .astype(np.float32))
    patch = (32, 32, 32)
    out = {o: paug.spatial_augment(images, labels,
                                   torch.Generator().manual_seed(4), patch,
                                   order=o) for o in (1, 3)}
    # the same draws: the label is the same, the image another interpolation
    assert torch.equal(out[1][1], out[3][1])
    assert torch.equal(out[1][0] == paug.BORDER_CVAL_DATA,
                       out[3][0] == paug.BORDER_CVAL_DATA)
    assert not torch.equal(out[1][0], out[3][0])
    angles, sc, centre = paug.sample_affine_params(
        torch.Generator().manual_seed(4), 2, patch, images.shape[1:])
    want = paug.warp_with_params(images, labels, angles, sc, centre, patch,
                                 order=3)
    assert torch.equal(out[3][0], want[0])
    cfg = SourceConfig(aug_order=3, patch_size=patch, device="cpu")
    ingest = common.make_train_ingest(cfg, torch.device("cpu"))
    img, lab = ingest({"image": images.numpy(), "label": labels.numpy()},
                      torch.Generator().manual_seed(4))
    assert torch.equal(img, intensity_normalize(out[3][0]))
    assert torch.equal(lab, out[3][1])
    with pytest.raises(ValueError, match="takes 1 or 3"):
        paug.warp_with_params(images, labels, angles, sc, centre, patch,
                              order=2)
