"""The port's source-domain train and eval steps (vae_segmentation_tpu_torch/
train/steps.py::make_vae_train_step, ::make_seg_train_step, eval/
evaluate.py::make_vae_eval_step, ::make_seg_eval_step) against the JAX
package's on the CPU. Weights are drawn from a numpy seed into the JAX
param tree and carried across with ``from_jax_params`` (which also carries
a gradient tree: the map is linear). Fmaps (4, 8, 8, 16, 16, 32), latent
16, batch 2, f32, at 64^3 (a 2^3 VAE bottleneck: at 32^3 the encoder's
norm zeroes its output).

The VAE step runs the JAX package's fused reparam path
(``VAESEG_FUSED_REPARAM=1``, set here through monkeypatch): off the TPU it
draws eps = normal(PRNGKey(seed)) with seed = randint(step key), and the
test hands that eps to the port in place of its own draw. Tolerances
(``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_source_train.py``
prints the measured errors, the port's drift from itself under reordered
f32 conv sums and a planted fault's):
  * step-1 loss terms: Dice 1e-4 abs, KL 1e-4 relative;
  * gradients, per tensor, against JAX's step-1 update over -lr: relative
    L2 error <= ``GRAD_REL`` = 0.3 and cosine >= ``GRAD_COS`` = 0.97, as
    tests/test_torch_train.py holds the Seg's; a bias followed by an
    InstanceNorm (zero gradient in exact arithmetic) is held to
    ``NOISE_ABS`` of the largest weight-gradient element. Measured for the
    VAE: 2e-4 at the head, growing through the decoder's norms to 0.09-0.12
    at up1 and 0.12-0.16 in the encoder (cosine >= 0.987), the round-off
    amplification tests/test_torch_train.py measures for the Seg; the port
    drifts from itself under reordered f32 conv sums by 2e-4 to 8e-3.
    ``test_vae_gradient_tolerance_sits_between_noise_and_a_fault`` shows
    that drift inside the tolerance, a planted backward fault (the stats
    cotangent's sum-of-squares term dropped in K1's backward) 3.6x to 900x
    beyond it for every weight but the head's (no norm follows it) and the
    two convs before it (0.22, 0.36), and a planted fault in the reparam VJP
    (d std without its eps * scale term) 3x beyond it at fc_std (0.94);
  * the SGD update: p1 == p0 - lr * grad (1e-7);
  * the eval steps: the VAE's reconstruction within 1e-2 max abs (measured
    5.5e-3, mean 4.6e-4: the 64^3 encoder's f32 round-off, see
    tests/test_torch_models.py), the Seg's prediction within 1e-4
    (measured 3.9e-5), the binary Dice per case within 1e-3 (measured
    8.6e-5: a probability near 0.5 may flip its argmax).
"""

import math
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from vae_segmentation_tpu.eval import evaluate as jeval
from vae_segmentation_tpu.models import SegUNet as JSegUNet
from vae_segmentation_tpu.models import ShapeVAE as JShapeVAE
from vae_segmentation_tpu.train import optim as joptim
from vae_segmentation_tpu.train import steps as jsteps
from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch import train as pt
from vae_segmentation_tpu_torch.eval import evaluate as peval
from vae_segmentation_tpu_torch.ops import bridges as pbridges
from vae_segmentation_tpu_torch.ops import conv3 as pconv3
from vae_segmentation_tpu_torch.ops import reparam as preparam

torch.set_num_threads(2)

FMAPS = (4, 8, 8, 16, 16, 32)
SIZE, BATCH, NC, DIM, LR = 64, 2, 2, 16, 1e-2
BOTTLENECK = FMAPS[5] * (SIZE // 32) ** 3
GRAD_REL = 0.3      # relative L2 error of a weight gradient
GRAD_COS = 0.97
NOISE_ABS = 0.2     # a norm-cancelled bias gradient over the largest
                    # weight-gradient element
RECON_ABS = 1e-2    # max abs error of the VAE eval step's reconstruction
PRED_ABS = 1e-4     # and of the Seg eval step's prediction
SCORE_ABS = 1e-3    # binary Dice per case


def _draw_params(template, rng):
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every kernel and its bias."""
    out = {}
    for name, node in template.items():
        if "kernel" in node:
            bound = 1.0 / math.sqrt(math.prod(node["kernel"].shape[:-1]))
            out[name] = {k: rng.uniform(-bound, bound, v.shape)
                         .astype(np.float32) for k, v in node.items()}
        else:
            out[name] = _draw_params(node, rng)
    return out


def _jax_vae():
    return JShapeVAE(n_class=NC, dim=DIM, fmaps=FMAPS, bottleneck=BOTTLENECK,
                     dtype=jnp.float32)


def _jax_seg():
    return JSegUNet(n_class=NC, fmaps=FMAPS, dtype=jnp.float32)


def _params(model, cin, rng):
    template = jax.eval_shape(
        lambda v: model.init(jax.random.PRNGKey(0), v),
        jax.ShapeDtypeStruct((BATCH, SIZE, SIZE, SIZE, cin), jnp.float32)
    )["params"]
    return _draw_params(template, rng)


def _labels(rng):
    """A blob per sample (a shape prior needs a shape), plus noise."""
    ax = np.arange(SIZE) - SIZE / 2
    r = np.sqrt(ax[:, None, None] ** 2 + (ax[None, :, None] / 1.3) ** 2
                + (ax[None, None, :] / 0.8) ** 2)
    out = []
    for _ in range(BATCH):
        blob = r < rng.uniform(10, 20)
        out.append((blob ^ (rng.random(r.shape) > 0.97)).astype(np.float32))
    return np.stack(out)


def _port_vae(params):
    vae = pm.ShapeVAE(n_class=NC, fmaps=FMAPS, dim=DIM, bottleneck=BOTTLENECK,
                      dtype=torch.float32)
    return pm.load_state(vae, pm.from_jax_params(params))


def _port_seg(params):
    seg = pm.SegUNet(n_class=NC, fmaps=FMAPS, dtype=torch.float32)
    return pm.load_state(seg, pm.from_jax_params(params))


def _jax_eps(key):
    """The sample JAX's fused path draws off the TPU from the step key
    (steps.py:163-165, reparam.py:97-100)."""
    seed = jax.random.randint(key, (), 0, jnp.iinfo(jnp.int32).max)
    return np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                      (BATCH, DIM), jnp.float32))


def _jax_step(model, params, tx, step, *args):
    state = jsteps.init_state(jax.tree.map(jnp.asarray, params), tx)
    state, aux = step(state, *args)
    p1 = jax.tree.map(np.asarray, state.params)
    # JAX's step-1 gradient from its update: p1 = p0 - lr * g
    p0, j1 = pm.from_jax_params(params), pm.from_jax_params(p1)
    return {k: float(v) for k, v in aux.items()}, \
        {k: (p0[k] - j1[k]) / LR for k in p0}


def _port_vae_step(params, label, eps, lr=LR):
    """(aux, gradients, state_dict after the step) of one port step with
    JAX's eps in place of the port's own draw."""
    vae = _port_vae(params)
    opt = pt.optim.sgd(vae.parameters(), lr)
    real = preparam.philox_normal_plain
    preparam.philox_normal_plain = lambda *a, **k: torch.from_numpy(eps)
    try:
        aux = pt.make_vae_train_step(NC)(vae, opt, torch.from_numpy(label),
                                         torch.Generator().manual_seed(0))
    finally:
        preparam.philox_normal_plain = real
    grads = {k: p.grad.clone() for k, p in vae.named_parameters()}
    return {k: float(v) for k, v in aux.items()}, grads, \
        {k: v.detach().clone() for k, v in vae.state_dict().items()}


_RUN = {}


def _run(monkeypatch=None):
    if not _RUN:
        rng = np.random.default_rng(0)
        vparams = _params(_jax_vae(), NC, rng)
        sparams = _params(_jax_seg(), 1, rng)
        label = _labels(rng)
        image = (rng.normal(size=label.shape) * 0.3 + label).astype(
            np.float32)
        key = jax.random.PRNGKey(5)
        env = pytest.MonkeyPatch() if monkeypatch is None else monkeypatch
        with env.context() as m:
            m.setenv("VAESEG_FUSED_REPARAM", "1")
            tx = joptim.sgd(LR)
            vstep = jsteps.make_vae_train_step(_jax_vae(), tx, NC)
        eps = _jax_eps(key)
        tx = joptim.sgd(LR)
        sstep = jsteps.make_seg_train_step(_jax_seg(), tx, NC)
        _RUN.update(
            vparams=vparams, sparams=sparams, label=label, image=image,
            eps=eps,
            jax_vae=_jax_step(_jax_vae(), vparams, tx, vstep,
                              jnp.asarray(label), key),
            jax_seg=_jax_step(_jax_seg(), sparams, tx, sstep,
                              jnp.asarray(image), jnp.asarray(label)),
            port_vae=_port_vae_step(vparams, label, eps))
    return _RUN


def _port_seg_step(params, image, label):
    seg = _port_seg(params)
    opt = pt.optim.sgd(seg.parameters(), LR)
    aux = pt.make_seg_train_step(NC)(seg, opt, torch.from_numpy(image),
                                     torch.from_numpy(label))
    return {k: float(v) for k, v in aux.items()}, \
        {k: p.grad.clone() for k, p in seg.named_parameters()}, \
        {k: v.detach().clone() for k, v in seg.state_dict().items()}


def _norm_cancelled(key):
    """A conv bias followed by an InstanceNorm: zero gradient in exact
    arithmetic (the head conv and the dense layers have none after)."""
    return key.endswith(".bias") and "out_block" not in key \
        and not key.startswith("fc")


def _grad_errors(got, want):
    """{key: (relative L2 error, cosine)} and the largest norm-cancelled
    bias gradient over the largest weight-gradient element."""
    rows, noise, scale = {}, 0.0, 0.0
    for key, w in want.items():
        g, w = got[key].numpy().ravel(), w.numpy().ravel()
        if _norm_cancelled(key):
            noise = max(noise, np.abs(g).max(), np.abs(w).max())
            continue
        scale = max(scale, np.abs(w).max())
        rows[key] = (np.linalg.norm(g - w) / np.linalg.norm(w),
                     float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w))))
    return rows, noise / scale


def _check_grads(rows, noise):
    for key, (rel, cos) in rows.items():
        assert rel <= GRAD_REL and cos >= GRAD_COS, (key, rel, cos)
    assert noise <= NOISE_ABS, noise


def test_vae_step_loss_terms_match_jax(monkeypatch):
    run = _run(monkeypatch)
    got, want = run["port_vae"][0], run["jax_vae"][0]
    assert got["dice_loss"] == pytest.approx(want["dice_loss"], abs=1e-4)
    assert got["kl_loss"] == pytest.approx(want["kl_loss"], rel=1e-4)


def test_vae_step_gradients_match_jax(monkeypatch):
    run = _run(monkeypatch)
    got, want = run["port_vae"][1], run["jax_vae"][1]
    assert sorted(got) == sorted(want)
    rows, noise = _grad_errors(got, want)
    assert len(rows) == 49      # 45 weights, the fc and the head biases
    _check_grads(rows, noise)


def test_vae_step_sgd_update_is_minus_lr_times_gradient(monkeypatch):
    run = _run(monkeypatch)
    p0 = pm.from_jax_params(run["vparams"])
    _, grads, p1 = run["port_vae"]
    for k in p0:
        torch.testing.assert_close(p1[k], p0[k] - LR * grads[k], rtol=0,
                                   atol=1e-7)
        if not _norm_cancelled(k):
            assert not torch.equal(p1[k], p0[k]), k


def _split_sums(fn):
    """`fn` (conv3d or conv_transpose3d, NCDHW) as the sum of two convs over
    the halves of the input channels: another f32 summation order."""
    def run(x, w, b=None, **kw):
        h = x.shape[1] // 2
        if h == 0:
            return fn(x, w, b, **kw)
        wa, wb = (w[:, :h], w[:, h:]) if fn is F.conv3d else (w[:h], w[h:])
        return fn(x[:, :h], wa, b, **kw) + fn(x[:, h:], wb, None, **kw)
    return run


_ReparamKLFn = preparam._ReparamKLFn


class _FaultyReparam(_ReparamKLFn):
    """The planted fault: d std loses its g_latent * eps * scale term."""

    @staticmethod
    def backward(ctx, g_latent, g_kl, g_eps):
        d_mean, d_std, _, _ = _ReparamKLFn.backward(
            ctx, g_latent, g_kl, g_eps)
        _, std, eps = ctx.saved_tensors
        return d_mean, d_std - g_latent * eps * ctx.scale, None, None


def _conv_faulty(run):
    real, pconv3.stats_cotangent = pconv3.stats_cotangent, \
        _faulty_stats_cotangent
    try:
        return _port_vae_step(run["vparams"], run["label"], run["eps"])[1]
    finally:
        pconv3.stats_cotangent = real


def _reordered(run):
    ns = types.SimpleNamespace(
        conv3d=_split_sums(F.conv3d),
        conv_transpose3d=_split_sums(F.conv_transpose3d))
    real = pconv3.F
    pconv3.F = pbridges.F = ns
    try:
        return _port_vae_step(run["vparams"], run["label"], run["eps"])[1]
    finally:
        pconv3.F = pbridges.F = real


def _faulty(run):
    preparam._ReparamKLFn = _FaultyReparam
    try:
        return _port_vae_step(run["vparams"], run["label"], run["eps"])[1]
    finally:
        preparam._ReparamKLFn = _ReparamKLFn


def _faulty_stats_cotangent(y, gy, gst):
    """The planted conv-backward fault: the sum-of-squares term dropped."""
    return (gy.float() + gst[:, 0, None, None, None, :]).to(y.dtype)


def test_vae_gradient_tolerance_sits_between_noise_and_a_fault(monkeypatch):
    """The port with reordered f32 conv sums stays inside the tolerance
    around itself; a planted fault in the convs' backward moves the
    weights 3x beyond it, one in the reparam VJP moves fc_std 2x beyond."""
    run = _run(monkeypatch)
    _check_grads(*_grad_errors(_reordered(run), run["port_vae"][1]))
    with monkeypatch.context() as m:
        m.setattr(pconv3, "stats_cotangent", _faulty_stats_cotangent)
        fault, _ = _grad_errors(_port_vae_step(
            run["vparams"], run["label"], run["eps"])[1], run["jax_vae"][1])
    # every weight but the head's and the two convs closest to it
    near_head = ("out_block.weight", "up5.conv.1.conv.3.weight",
                 "up5.conv.1.conv.6.weight")
    weights = [k for k in fault if k.endswith(".weight")]
    assert len(weights) == 45
    assert all(fault[k][0] > 3 * GRAD_REL for k in weights
               if k not in near_head), {k: fault[k][0] for k in weights}
    fault, _ = _grad_errors(_faulty(run), run["jax_vae"][1])
    for k in ("fc_std.weight", "fc_std.bias"):
        assert fault[k][0] > 2 * GRAD_REL, (k, fault[k])


def test_seg_step_matches_jax(monkeypatch):
    run = _run(monkeypatch)
    aux, grads, p1 = _port_seg_step(run["sparams"], run["image"],
                                    run["label"])
    want_aux, want_grads = run["jax_seg"]
    assert aux["dice_loss"] == pytest.approx(want_aux["dice_loss"], abs=1e-4)
    rows, noise = _grad_errors(grads, want_grads)
    _check_grads(rows, noise)
    p0 = pm.from_jax_params(run["sparams"])
    for k in p0:
        torch.testing.assert_close(p1[k], p0[k] - LR * grads[k], rtol=0,
                                   atol=1e-7)


def test_eval_steps_match_jax(monkeypatch):
    run = _run(monkeypatch)
    label, image = run["label"], run["image"]
    vp = jax.tree.map(jnp.asarray, run["vparams"])
    recon, score = jeval.make_vae_eval_step(_jax_vae(), NC)(
        vp, jnp.asarray(label))
    out = peval.make_vae_eval_step(_port_vae(run["vparams"]), NC)(
        torch.from_numpy(label))
    assert np.abs(out["recon"].numpy() - np.asarray(recon)).max() \
        <= RECON_ABS
    np.testing.assert_allclose(out["score"].numpy(), np.asarray(score),
                               atol=SCORE_ABS)
    sp = jax.tree.map(jnp.asarray, run["sparams"])
    pred, score = jeval.make_seg_eval_step(_jax_seg(), NC)(
        sp, jnp.asarray(image), jnp.asarray(label))
    out = peval.make_seg_eval_step(_port_seg(run["sparams"]), NC)(
        torch.from_numpy(image), torch.from_numpy(label))
    assert np.abs(out["pred"].numpy() - np.asarray(pred)).max() <= PRED_ABS
    np.testing.assert_allclose(out["score"].numpy(), np.asarray(score),
                               atol=SCORE_ABS)
    # the label-only loop of the VAE's validation
    batches = [{"label": torch.from_numpy(label), "index": np.array([4, 7])}]
    mean, scores = peval.run_eval(
        batches, peval.make_vae_eval_step(_port_vae(run["vparams"]), NC),
        uses_image=False)
    assert sorted(scores) == [4, 7] and 0.0 <= mean <= 1.0


def _report():
    """Print the measured errors against JAX, the port's drift under
    reordered f32 sums and what the planted fault does."""
    run = _run()
    print("vae losses port", run["port_vae"][0], "jax", run["jax_vae"][0])
    rows, noise = _grad_errors(run["port_vae"][1], run["jax_vae"][1])
    drift, dnoise = _grad_errors(_reordered(run), run["port_vae"][1])
    fault, _ = _grad_errors(_faulty(run), run["jax_vae"][1])
    conv_fault, _ = _grad_errors(_conv_faulty(run), run["jax_vae"][1])
    print("bias noise vs JAX", noise, "reordered", dnoise)
    for k, (rel, cos) in sorted(rows.items()):
        print(f"  {k:24s} vs JAX rel {rel:.2e} cos {cos:.6f} | reordered "
              f"rel {drift[k][0]:.2e} | reparam fault rel {fault[k][0]:.2e}"
              f" | conv fault rel {conv_fault[k][0]:.2e}")
    # chip_smoke's step-1 gate on the same footing: each tensor's error
    # against the port over the port's reordered drift (or the median
    # tensor's, where larger); the gate fails above 4
    med = sorted(d for d, _ in drift.values())[len(drift) // 2]
    ref = run["port_vae"][1]
    for name, grads in (("reparam fault", _faulty(run)),
                        ("conv fault", _conv_faulty(run))):
        err, _ = _grad_errors(grads, ref)
        ratio = {k: err[k][0] / max(drift[k][0], med) for k in err}
        print(f"gate ratio, {name}: min {min(ratio.values()):.3g} "
              f"median {sorted(ratio.values())[len(ratio) // 2]:.3g} max "
              f"{max(ratio.values()):.3g}; above 4: "
              f"{sum(r > 4 for r in ratio.values())} of {len(ratio)}")
    aux, grads, _ = _port_seg_step(run["sparams"], run["image"], run["label"])
    print("seg loss port", aux, "jax", run["jax_seg"][0])
    rows, noise = _grad_errors(grads, run["jax_seg"][1])
    print("seg bias noise", noise, "worst rel",
          max(r for r, _ in rows.values()), "min cos",
          min(c for _, c in rows.values()))


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_source_train.py
    jax.config.update("jax_platforms", "cpu")
    _report()
