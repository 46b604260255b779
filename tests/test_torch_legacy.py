"""The port's host analysis helpers (vae_segmentation_tpu_torch/utils/
legacy.py) against the JAX package's (utils/legacy.py) on seeded inputs;
``get_parameter_number`` counts a torch module's parameters where the JAX
package counts the same model's param tree."""

import numpy as np
import pytest
import torch

from vae_segmentation_tpu import utils as J
from vae_segmentation_tpu_torch import utils as P

torch.set_num_threads(2)


def test_synthesis_mask_matches_jax(rng):
    vol = rng.normal(50, 200, (10, 9, 8)).astype(np.float32)
    got = P.get_synthesis_mask({"venous": vol.copy()})
    want = J.get_synthesis_mask({"venous": vol.copy()})
    np.testing.assert_array_equal(got["venous_syn_mask"],
                                  want["venous_syn_mask"])
    assert got["venous_syn_mask"].dtype == np.float32
    other = P.get_synthesis_mask({"art": vol}, field="art")
    np.testing.assert_array_equal(other["art_syn_mask"],
                                  want["venous_syn_mask"])


@pytest.mark.parametrize("normalized", [True, False])
def test_mutual_information_matches_jax(rng, normalized):
    x = rng.normal(size=4096)
    y = 0.5 * x + rng.normal(size=4096)
    for a, b in ((x, x), (x, y)):
        assert P.mutual_information_3d(a, b, sigma=1.5,
                                       normalized=normalized) == \
            J.mutual_information_3d(a, b, sigma=1.5, normalized=normalized)


@pytest.mark.parametrize("display", ["TB", "CV2"])
def test_plot_slides_matches_jax(rng, display):
    v = rng.normal(size=(7, 10, 12))
    got = P.plot_slides(v, display)
    want = J.plot_slides(v, display)
    assert got.dtype == want.dtype and got.shape == (11 * 3, 13 * 3, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("side", [512, 64])
def test_create_grid_images_matches_jax(tmp_path, rng, monkeypatch, side):
    imageio = pytest.importorskip("imageio.v2")
    vols = [rng.normal(40, 300, (2, side, side)).astype(np.float32)
            for _ in range(3)]
    P.create_grid_images(*vols, str(tmp_path / "p"), slice_num=1)
    monkeypatch.setenv("VAESEG_NATIVE_RESIZE", "0")
    J.create_grid_images(*vols, str(tmp_path / "j"), slice_num=1)
    for name in ("source.png", "target.png", "source_align.png",
                 "orig_check.png", "align_check.png"):
        got = imageio.imread(tmp_path / "p" / name).astype(np.int32)
        want = imageio.imread(tmp_path / "j" / name).astype(np.int32)
        assert got.shape == want.shape == (512, 512)
        if side == 512:
            np.testing.assert_array_equal(got, want)
        else:
            # the native and the scipy resize agree within 2e-3 before the
            # 8-bit quantization
            assert np.abs(got - want).max() <= 1
            assert np.mean(got != want) < 1e-2


def test_losses_match_jax(rng):
    target = rng.normal(size=(6, 5, 4)).astype(np.float32)
    mask = (rng.random((6, 5, 4)) > 0.5).astype(np.float32)
    srcs = [rng.normal(size=(6, 5, 4)).astype(np.float32) for _ in range(2)]
    for source in (srcs[0], srcs):
        for do_mask in (True, False):
            d = {"align_arterial": source, "venous": target,
                 "venous_reg_mask": mask}
            dj = dict(d)
            assert P.masked_mse_loss(d, do_mask) == \
                J.masked_mse_loss(dj, do_mask)
            np.testing.assert_array_equal(d["dummy_align_venous"],
                                          dj["dummy_align_venous"])
    smooth = {"smooth_dform": rng.random((3, 4, 5))}
    assert P.smoothness_loss(smooth) == J.smoothness_loss(smooth)


def test_parameter_number_counts_the_module(capsys):
    net = torch.nn.Sequential(torch.nn.Conv3d(2, 3, 3),
                              torch.nn.InstanceNorm3d(3, affine=True),
                              torch.nn.Linear(5, 7))
    tree = {name.replace(".", "/"): p.detach().numpy()
            for name, p in net.named_parameters()}
    want = J.get_parameter_number(tree)
    got = P.get_parameter_number(net)
    assert got == want == {"Total": 162 + 3 + 6 + 42, "Trainable": 213}
    net[0].weight.requires_grad_(False)
    assert P.get_parameter_number(net) == {"Total": 213, "Trainable": 51}
    assert capsys.readouterr().out.splitlines()[-2:] == ["Total: 213",
                                                         "Trainable: 51"]
