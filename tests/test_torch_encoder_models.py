"""The port's ShapeEncoder, Joint2 and FusionNet (``models/encoder.py``,
``models/joint.py``, ``models/fusion.py``) against the JAX package's on
the CPU, Embed's eval step (``eval/evaluate.py::make_seg_eval_step`` of
``Embed.segment``: the Fusion's test-mode prediction, binary Dice per case)
against its
``make_embed_eval_step``, and ``ops/losses.py::bce`` against its
``bce``.

At 64^3, widths (4, 8, 8, 16, 16, 32), batch 2, seeded weights carried
across by ``from_jax_params`` (at 32^3 the encoder's 1^3 bottleneck norm
makes its score the same for every input). Tolerances, those of
tests/test_torch_models.py at 64^3:
  * f32: probabilities 3e-4 abs (``LIMITS_64``'s Joint prediction; measured
    2.6e-5 for Joint2's, 1.1e-5 for FusionNet's), the sigmoid scores 1e-4
    abs (measured 1.5e-6);
  * bf16: the port no further from the f32 result than the JAX package's
    own bf16 model (max and mean abs, 25% slack, plus 1e-3 / 1e-4), Joint2's
    score on one input (its Dis on the port's bf16 prediction);
  * Embed's eval: the binary Dice per case 1e-3 abs, as
    tests/test_torch_source_train.py's eval steps (a probability near 0.5
    may flip its argmax: measured 1.7e-5), the prediction 1e-3
    (tests/test_torch_models.py's LIMITS_64 for probabilities through the
    64^3 VAE encoder: 2e-3);
  * bce: 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _draw_params
from vae_segmentation_tpu.eval import evaluate as jeval
from vae_segmentation_tpu.models import Embed as JEmbed
from vae_segmentation_tpu.models import FusionNet as JFusion
from vae_segmentation_tpu.models import Joint2 as JJoint2
from vae_segmentation_tpu.models import ShapeEncoder as JEnc
from vae_segmentation_tpu.ops import losses as JL
from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch.eval import evaluate as peval
from vae_segmentation_tpu_torch.ops import losses as PL

torch.set_num_threads(2)

FMAPS = (4, 8, 8, 16, 16, 32)
SIZE, BATCH, NC = 64, 2, 2
BOTT = FMAPS[5] * (SIZE // 32) ** 3
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
PDT = {"f32": torch.float32, "bf16": torch.bfloat16}
PROB_ABS, SCORE_ABS = 3e-4, 1e-4


def _jax(kind, dt):
    if kind == "encoder":
        return JEnc(dim=1, fmaps=FMAPS, bottleneck=BOTT, dtype=JDT[dt])
    if kind == "joint2":
        return JJoint2(n_class=NC, fmaps=FMAPS, bottleneck=BOTT,
                       dtype=JDT[dt])
    return JFusion(n_class=NC, fmaps=FMAPS, dtype=JDT[dt])


def _port(kind, dt):
    if kind == "encoder":
        return pm.ShapeEncoder(dim=1, fmaps=FMAPS, bottleneck=BOTT,
                               dtype=PDT[dt])
    if kind == "joint2":
        return pm.Joint2(n_class=NC, fmaps=FMAPS, bottleneck=BOTT,
                         dtype=PDT[dt])
    return pm.FusionNet(n_class=NC, fmaps=FMAPS, dtype=PDT[dt])


_CASES = {}


def _case(kind):
    if kind not in _CASES:
        rng = np.random.default_rng(len(kind))
        image = (rng.normal(size=(BATCH, SIZE, SIZE, SIZE, 1)) * 0.5) \
            .astype(np.float32)
        logits = rng.normal(size=(BATCH, SIZE, SIZE, SIZE, NC)) * 2
        mask = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)) \
            .astype(np.float32)
        inputs = (image,) if kind != "fusion" else (image, mask)
        template = jax.eval_shape(
            lambda *v: _jax(kind, "f32").init(jax.random.PRNGKey(0), *v),
            *[jax.ShapeDtypeStruct(x.shape, jnp.float32)
              for x in inputs])["params"]
        _CASES[kind] = (_draw_params(template, rng), inputs)
    return _CASES[kind]


def _outputs(out):
    return [np.asarray(o, np.float32) if not isinstance(o, torch.Tensor)
            else o.float().numpy()
            for o in (out if isinstance(out, tuple) else (out,))]


def _jax_out(kind, dt):
    params, inputs = _case(kind)
    return _outputs(_jax(kind, dt).apply(
        {"params": params}, *[jnp.asarray(x) for x in inputs]))


def _port_out(kind, dt):
    params, inputs = _case(kind)
    model = pm.load_state(_port(kind, dt), pm.from_jax_params(params))
    with torch.no_grad():
        return _outputs(model(*[torch.from_numpy(x).to(PDT[dt])
                                for x in inputs]))


# (kind, the tolerance of each output in f32)
KINDS = {"encoder": (SCORE_ABS,), "joint2": (PROB_ABS, SCORE_ABS),
         "fusion": (PROB_ABS,)}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_forward_f32(kind):
    got, want = _port_out(kind, "f32"), _jax_out(kind, "f32")
    for g, w, tol in zip(got, want, KINDS[kind]):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol, np.abs(g - w).max()


def _check_bf16(got, want, truth):
    for g, w, t in zip(got, want, truth):
        port_err, ref_err = np.abs(g - t), np.abs(w - t)
        assert port_err.max() <= 1.25 * ref_err.max() + 1e-3, \
            (port_err.max(), ref_err.max())
        assert port_err.mean() <= 1.25 * ref_err.mean() + 1e-4, \
            (port_err.mean(), ref_err.mean())


@pytest.mark.parametrize("kind", ["encoder", "joint2"])
def test_forward_bf16(kind):
    """Joint2's score is held on one input: its Dis on the port's bf16
    prediction in both packages (two scores of two bf16 predictions differ
    by the predictions' own rounding, a lottery of two samples)."""
    got, want = _port_out(kind, "bf16"), _jax_out(kind, "bf16")
    truth = _jax_out(kind, "f32")
    if kind == "encoder":
        _check_bf16(got, want, truth)
        return
    _check_bf16(got[:1], want[:1], truth[:1])
    params, _ = _case(kind)
    pred1 = jnp.asarray(got[0][..., 1:2])
    dis = [_outputs(_jax(kind, dt).apply(
        {"params": params}, pred1.astype(JDT[dt]),
        method=lambda m, x: m.Dis(x))) for dt in ("bf16", "f32")]
    _check_bf16(got[1:], *dis)


def test_bce_matches_jax():
    rng = np.random.default_rng(3)
    src = rng.random((2, 8, 8, 8, 1)).astype(np.float32)
    src[0, 0, 0, 0, 0] = 0.0   # the clamp (1 - 1e-12 is 1.0 in f32)
    tgt = (rng.random(src.shape) > 0.5).astype(np.float32)
    want = float(JL.bce(jnp.asarray(src), jnp.asarray(tgt)))
    got = float(PL.bce(torch.from_numpy(src), torch.from_numpy(tgt)))
    assert got == pytest.approx(want, rel=1e-6)
    ref = torch.nn.functional.binary_cross_entropy(
        torch.from_numpy(src).double().clamp(1e-12, 1 - 1e-12),
        torch.from_numpy(tgt).double())
    assert got == pytest.approx(float(ref), rel=1e-5)


def test_embed_eval_step_matches_jax():
    rng = np.random.default_rng(9)
    jm = JEmbed(n_class=NC, dim=16, fmaps=FMAPS, bottleneck=BOTT,
                dtype=jnp.float32)
    template = jax.eval_shape(
        lambda a, b: jm.init({"params": jax.random.PRNGKey(0),
                              "reparam": jax.random.PRNGKey(1)}, a, b),
        jax.ShapeDtypeStruct((1, SIZE, SIZE, SIZE, 1), jnp.float32),
        jax.ShapeDtypeStruct((1, SIZE, SIZE, SIZE, NC),
                             jnp.float32))["params"]
    params = _draw_params(template, rng)
    image = (rng.normal(size=(BATCH, SIZE, SIZE, SIZE)) * 0.5) \
        .astype(np.float32)
    label = (rng.random((BATCH, SIZE, SIZE, SIZE)) > 0.6) \
        .astype(np.float32)
    model = pm.load_state(pm.Embed(n_class=NC, dim=16, fmaps=FMAPS,
                                   bottleneck=BOTT, dtype=torch.float32),
                          pm.from_jax_params(params)).eval()
    got = peval.make_seg_eval_step(model.segment, NC)(
        torch.from_numpy(image), torch.from_numpy(label))
    want = jeval.make_embed_eval_step(jm, NC)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(image),
        jnp.asarray(label))
    np.testing.assert_allclose(got["score"].numpy(),
                               np.asarray(want["score"]), atol=1e-3)
    np.testing.assert_allclose(got["pred"].numpy(),
                               np.asarray(want["pred"]), atol=1e-3)
