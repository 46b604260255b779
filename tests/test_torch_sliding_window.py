"""The port's sliding-window eval (vae_segmentation_tpu_torch/eval/
sliding_window.py and cli/common.py::run_sliding_window_eval) against the
JAX package's on the CPU, on seeded numpy inputs. Tolerances:
  * ``window_starts`` exactly; ``gaussian_weight`` within 1e-7;
  * ``sliding_window_predict`` with the same analytic per-voxel model in
    both packages within 1e-6 (the port runs a short last chunk where JAX
    pads with zero-weight windows: the same terms in the same order);
  * a SegUNet sweep (32^3 patches, f32, the same weights through
    ``from_jax_params``) within 1e-4, the f32 probability tolerance of
    tests/test_torch_models.py;
  * ``run_sliding_window_eval``'s Dice within 1e-6, with and without
    --postprocess, on the blob-plus-speck case of
    tests/test_postprocess.py (copied here)."""

import json
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_segmentation_tpu.cli.common import (
    run_sliding_window_eval as jax_run_sw)
from vae_segmentation_tpu.eval import sliding_window as jsw
from vae_segmentation_tpu.models import SegUNet as JSeg
from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch.cli.common import run_sliding_window_eval
from vae_segmentation_tpu_torch.eval import sliding_window as psw

torch.set_num_threads(2)

FMAPS = (4, 8, 8, 16, 16, 32)
PATCH = (32, 32, 32)


@pytest.mark.parametrize("overlap", [0.0, 0.25, 0.5, 0.75])
def test_window_starts_match_jax(overlap):
    """Axes smaller than, equal to, a multiple of and not a multiple of the
    patch; anisotropic patches."""
    for vol, patch in (((20, 32, 56), PATCH), ((40, 56, 48), PATCH),
                       ((64, 96, 33), PATCH), ((192, 192, 192), (128,) * 3),
                       ((160, 70, 31), (64, 32, 16))):
        got = psw.window_starts(vol, patch, overlap)
        want = jsw.window_starts(vol, patch, overlap)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("patch", [PATCH, (128, 128, 128), (16, 24, 40)])
def test_gaussian_weight_matches_jax(patch):
    got = psw.gaussian_weight(patch)
    want = np.asarray(jsw._gaussian_weight(patch))
    assert got.dtype == torch.float32 and tuple(got.shape) == patch
    assert np.abs(got.numpy() - want).max() <= 1e-7
    assert float(got.min()) >= np.float32(1e-4)


def _analytic_jax(params, x):
    v = x[..., 0]
    return jax.nn.softmax(jnp.stack([v, 0.5 * v * v], axis=-1), axis=-1)


def _analytic_port(x):
    v = x[..., 0]
    return torch.softmax(torch.stack([v, 0.5 * v * v], dim=-1), dim=-1)


@pytest.mark.parametrize("shape", [(40, 56, 48), (20, 56, 48)])
def test_sliding_window_predict_matches_jax(shape):
    """Batch 3 over 8 (or 4) windows: the last chunk is short. (20, 56, 48)
    is smaller than the patch on its first axis: padded with the volume's
    minimum, cropped back."""
    vol = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    want = np.asarray(jsw.sliding_window_predict(
        _analytic_jax, None, jnp.asarray(vol), patch=PATCH, overlap=0.5,
        batch=3, n_class=2))
    calls = []

    def seg_fn(x):
        calls.append(tuple(x.shape))
        assert x.is_contiguous()
        return _analytic_port(x)

    got = psw.sliding_window_predict(seg_fn, torch.from_numpy(vol),
                                     patch=PATCH, overlap=0.5, batch=3,
                                     n_class=2)
    n = len(jsw.window_starts(tuple(max(s, p) for s, p in zip(shape, PATCH)),
                              PATCH, 0.5))
    assert calls == [(3, *PATCH, 1)] * (n // 3) + \
        ([(n % 3, *PATCH, 1)] if n % 3 else [])
    assert got.dtype == torch.float32 and tuple(got.shape) == (*shape, 2)
    assert np.abs(got.numpy() - want).max() <= 1e-6


def test_segunet_sweep_matches_jax():
    """A SegUNet (32^3 patches, f32) swept over a [48, 40, 36] volume (4
    windows at batch 3) with the same weights in both packages."""
    rng = np.random.default_rng(5)
    model = JSeg(n_class=2, fmaps=FMAPS, dtype=jnp.float32, s2d=False)
    template = jax.eval_shape(
        lambda v: model.init(jax.random.PRNGKey(0), v),
        jax.ShapeDtypeStruct((1, *PATCH, 1), jnp.float32))["params"]

    def draw(node):
        if "kernel" in node:
            bound = 1.0 / math.sqrt(math.prod(node["kernel"].shape[:-1]))
            return {k: rng.uniform(-bound, bound, v.shape).astype(np.float32)
                    for k, v in node.items()}
        return {k: draw(v) for k, v in node.items()}

    params = draw(template)
    vol = (rng.normal(size=(48, 40, 36)) * 0.5).astype(np.float32)
    want = np.asarray(jsw.sliding_window_predict(
        lambda p, x: model.apply({"params": p}, x),
        jax.tree.map(jnp.asarray, params), jnp.asarray(vol), patch=PATCH,
        overlap=0.5, batch=3, n_class=2))
    net = pm.SegUNet(n_class=2, fmaps=FMAPS, dtype=torch.float32)
    pm.load_state(net, pm.from_jax_params(params))
    got = psw.sliding_window_predict(net, torch.from_numpy(vol), patch=PATCH,
                                     overlap=0.5, batch=3, n_class=2)
    assert np.abs(got.numpy() - want).max() <= 1e-4


# ---- run_sliding_window_eval on the blob-plus-speck case
# (tests/test_postprocess.py:64-96)


def _ball(shape, center, r):
    g = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"))
    return (np.sum((g - np.asarray(center)[:, None, None, None]) ** 2,
                   axis=0) <= r * r)


@pytest.fixture()
def sw_case(tmp_path):
    """One on-disk case: the label is one blob; the image is bright on the
    blob and on a small speck, so a threshold 'model' predicts both and the
    component filter removes exactly the speck."""
    blob = _ball((48, 48, 48), (20, 24, 24), 7)
    speck = _ball((48, 48, 48), (40, 40, 40), 2)
    img = np.full((48, 48, 48), -1024.0, np.float32)
    img[blob | speck] = 400.0
    case_dir = tmp_path / "case1"
    case_dir.mkdir()
    np.save(case_dir / "merge.npy",
            np.stack([img, blob.astype(np.float32)], axis=-1))
    manifest = tmp_path / "manifest.json"
    manifest.write_text(json.dumps({"VAL": ["case1/merge.npy"]}))
    return {"root": str(tmp_path), "manifest": str(manifest)}


def _threshold_jax(params, x):
    fg = (x[..., 0] > 0.0).astype(jnp.float32)
    return jnp.stack([1.0 - fg, fg], axis=-1)


def _threshold_port(net, x):
    fg = (x[..., 0] > 0.0).float()
    return torch.stack([1.0 - fg, fg], dim=-1)


def _sw_cfg(case, postprocess):
    return SimpleNamespace(
        data_path=case["manifest"], patch_size=PATCH, sw_overlap=0.5,
        batch_size=2, postprocess=postprocess, postprocess_min_voxels=100)


def test_run_sliding_window_eval_matches_jax(sw_case):
    """The Dice with and without --postprocess within 1e-6 of JAX's, keyed
    by the case's index; the filter removes the speck."""
    got = {}
    for pp in (False, True):
        cfg = _sw_cfg(sw_case, pp)
        want = jax_run_sw(cfg, _threshold_jax, None, n_class=2,
                          data_root=sw_case["root"], list_key="VAL",
                          pan_index="1")
        got[pp] = run_sliding_window_eval(
            cfg, _threshold_port, torch.nn.Linear(1, 1), n_class=2,
            data_root=sw_case["root"], list_key="VAL", pan_index="1")
        assert sorted(got[pp][1]) == sorted(want[1]) == [0]
        assert got[pp][0] == pytest.approx(want[0], abs=1e-6)
        assert got[pp][1][0] == pytest.approx(want[1][0], abs=1e-6)
    assert got[False][0] < 1.0 - 1e-4
    assert got[True][0] > 1.0 - 1e-4


def test_run_sliding_window_eval_gives_each_case_its_model(sw_case):
    """model_for_case hands every case its own model (the ft1 hook): seg_fn
    sees that model on every window chunk of that case."""
    seen = []
    default, own = torch.nn.Linear(1, 1), torch.nn.Linear(1, 1)

    def seg_fn(net, x):
        seen.append(net)
        return _threshold_port(net, x)

    run_sliding_window_eval(_sw_cfg(sw_case, False), seg_fn, default,
                            n_class=2, data_root=sw_case["root"],
                            list_key="VAL", pan_index="1",
                            model_for_case=lambda case: own)
    # 64^3 padded volume, 32^3 patches at overlap 0.5, batch 2: 27 windows
    assert len(seen) == 14 and all(net is own for net in seen)
