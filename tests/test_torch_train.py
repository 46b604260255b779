"""The port's adaptation train step (vae_segmentation_tpu_torch/train/)
against the JAX package on the CPU, where the JAX package runs the logical
model with XLA convs (the loss dispatch, the dropout graph, the train loader
and the training CLI are in tests/test_torch_train_cli.py). Weights are
drawn from a numpy seed into the JAX param tree and carried across with
``from_jax_params`` (which also carries a JAX gradient tree into the port's
names and layouts: the map is linear). Fmaps (4, 8, 8, 16, 16, 32), batch 2,
f32.

The whole step runs at 64^3 (a 2^3 VAE bottleneck: at 32^3 the encoder's
norm zeroes its output and the reconstruction no longer depends on the
prediction). Tolerances there (``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_train.py`` prints the measured errors and the planted
fault's):
  * step-1 loss terms: 2e-5 abs (measured <= 1e-6);
  * Seg gradients, per tensor, against JAX's step-1 update over -lr (zero
    momentum buffer): relative L2 error <= ``GRAD_REL`` = 0.3 and cosine >=
    0.97 for every weight; ``out_block`` (no norm between it and the loss)
    weight 2e-2, bias 2e-3. The random-weight network's gradients are badly
    conditioned in f32: they pass ~10 InstanceNorms whose backward cancels
    large terms. Measured 0.08-0.16 (cosine 0.987-0.997) against JAX, and
    the port drifts from ITSELF by 0.05-0.10 when only the f32 summation
    order of its convs changes (``test_gradient_tolerance_sits_between_
    noise_and_a_fault``), so this is round-off, not a fault; the JAX package
    meets the torch reference at the same 0.15 (tests/test_train_parity.py).
    A bias followed by an InstanceNorm has an exactly zero gradient in exact
    arithmetic, so both frameworks return round-off there: held to
    ``NOISE_ABS`` = 0.2 of the largest weight-gradient element (measured
    0.06). The planted fault (the stats cotangent's sum-of-squares term
    dropped in K1's backward) gives relative L2 errors of 12 to 2500: 40x
    the tolerance and more;
  * the SGD update: p1 == p0 - lr * grad exactly (1e-7) in the port;
  * a 4-step trajectory: loss terms within 1e-4 of JAX's through step 3 and
    5e-3 at step 4 (measured 8e-5 and 1.7e-3: the round-off above, fed back
    through the weights; tests/test_train_parity.py allows 3e-3). The
    weights themselves are compared step by step from JAX's weights (see
    test_step2_update_matches_jax_from_jax_weights), not free-running.
"""

import math
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from vae_segmentation_tpu.models import Joint as JJoint
from vae_segmentation_tpu.ops import losses as JL
from vae_segmentation_tpu.train import ema as jema
from vae_segmentation_tpu.train import optim as joptim
from vae_segmentation_tpu.train import steps as jsteps
from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch import train as pt
from vae_segmentation_tpu_torch.ops import bridges as pbridges
from vae_segmentation_tpu_torch.ops import conv3 as pconv3

torch.set_num_threads(2)

FMAPS = (4, 8, 8, 16, 16, 32)
BATCH, NC, DIM, LR, LAMBDA = 2, 2, 16, 1e-2, 1.0
LOSS_KEYS = ("recon_loss", "dice_loss_fake", "dice_loss", "final_loss")
GRAD_REL = 0.3     # relative L2 error of a Seg weight gradient
GRAD_COS = 0.97
HEAD_REL = {"Seg.out_block.weight": 2e-2, "Seg.out_block.bias": 2e-3}
NOISE_ABS = 0.2    # a norm-cancelled bias gradient over the largest
                   # weight-gradient element


def _bottleneck(size):
    return FMAPS[5] * (size // 32) ** 3


def _jax_joint(size, **kw):
    return JJoint(n_class=NC, dim=DIM, fmaps=FMAPS,
                  bottleneck=_bottleneck(size), dtype=jnp.float32,
                  trunk_remat=False, **kw)


def _port_joint(size, **kw):
    return pm.Joint(n_class=NC, dim=DIM, fmaps=FMAPS,
                    bottleneck=_bottleneck(size), dtype=torch.float32, **kw)


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


def _case(size, seed=0, n_batches=2):
    """(params, [(image, label), ...]) from a numpy seed."""
    rng = np.random.default_rng(seed)
    template = jax.eval_shape(
        lambda v: _jax_joint(size).init(jax.random.PRNGKey(0), v),
        jax.ShapeDtypeStruct((BATCH, size, size, size, 1),
                             jnp.float32))["params"]
    params = _draw_params(template, rng)
    batches = [((rng.normal(size=(BATCH, size, size, size)) * 0.5)
                .astype(np.float32),
                (rng.random((BATCH, size, size, size)) > 0.7)
                .astype(np.float32)) for _ in range(n_batches)]
    return params, batches


def _port_pair(params, size, **kw):
    student, teacher = _port_joint(size, **kw), _port_joint(size)
    pm.load_state(student, pm.from_jax_params(params))
    pt.copy_params(teacher, student)
    return student, teacher


# ---- (c), (d) the whole step at dropout 0


def _jax_trajectory(params, batches, n_steps, size):
    model = _jax_joint(size)
    params = jax.tree.map(jnp.asarray, params)
    tx = joptim.freeze_vae(joptim.sgd(LR), params)
    cfg = jsteps.AdaptConfig(n_class=NC, domain_loss_type=8)
    step = jsteps.make_adapt_step(model, model, tx, cfg)
    teacher = jax.tree.map(jnp.copy, params)
    state = jsteps.init_state(jax.tree.map(jnp.copy, params), tx)
    sched = jsteps.default_sched(LAMBDA)
    losses, snaps = [], []
    for i in range(n_steps):
        img, lab = batches[i % len(batches)]
        state, aux = step(state, teacher, jnp.asarray(img), jnp.asarray(lab),
                          jax.random.PRNGKey(i), sched)
        losses.append({k: float(aux[k]) for k in LOSS_KEYS})
        snaps.append(jax.tree.map(np.asarray, state.params))
    return losses, snaps


def _port_trajectory(params, batches, n_steps, size, grads_out=None,
                     start=None, lr=LR, first_batch=0):
    """(losses, per-step state_dicts, per-step gradients, student,
    teacher). The teacher holds `params`; the student starts from `start`
    (a state_dict) when given."""
    student, teacher = _port_pair(params, size)
    if start is not None:
        pm.load_state(student, start)
    opt = pt.optim.sgd(pt.optim.freeze_vae(student), lr)
    step = pt.make_adapt_step(pt.AdaptConfig(n_class=NC, domain_loss_type=8))
    gen = torch.Generator().manual_seed(0)
    losses, snaps, grads = [], [], []
    for i in range(n_steps):
        img, lab = batches[(first_batch + i) % len(batches)]
        aux = step(student, teacher, opt, torch.from_numpy(img),
                   torch.from_numpy(lab), gen, pt.default_sched(LAMBDA))
        losses.append({k: float(aux[k]) for k in LOSS_KEYS})
        snaps.append({k: v.detach().clone()
                      for k, v in student.state_dict().items()})
        grads.append({k: p.grad.clone() for k, p in
                      student.named_parameters() if p.grad is not None})
    if grads_out is not None:
        grads_out.update(grads[0])
    return losses, snaps, grads, student, teacher


def _norm_cancelled(key):
    return key.endswith(".bias") and not key.startswith("Seg.out_block")


def _check_grads(rows, noise):
    for key, (rel, cos) in rows.items():
        assert rel <= HEAD_REL.get(key, GRAD_REL) and cos >= GRAD_COS, \
            (key, rel, cos)
    assert noise <= NOISE_ABS, noise


def _grad_errors(got, want):
    """{key: (relative L2 error, cosine)} over the Seg weights and the
    out_block bias, and the largest norm-cancelled bias gradient over the
    largest weight-gradient element."""
    rows, noise, scale = {}, 0.0, 0.0
    for key, w in want.items():
        if not key.startswith("Seg."):
            continue
        g, w = got[key].numpy().ravel(), w.numpy().ravel()
        if _norm_cancelled(key):
            noise = max(noise, np.abs(g).max(), np.abs(w).max())
            continue
        scale = max(scale, np.abs(w).max())
        rows[key] = (np.linalg.norm(g - w) / np.linalg.norm(w),
                     float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w))))
    return rows, noise / scale


_RUN = {}


def _run64():
    if not _RUN:
        params, batches = _case(64)
        grads = {}
        _RUN.update(
            params=params, batches=batches,
            jax=_jax_trajectory(params, batches, 4, 64),
            port=_port_trajectory(params, batches, 4, 64, grads),
            port_grads=grads)
        # JAX's step-1 gradient from its update: p1 = p0 - lr * g
        p0 = pm.from_jax_params(params)
        j1 = pm.from_jax_params(_RUN["jax"][1][0])
        _RUN["jax_grads"] = {k: (p0[k] - j1[k]) / LR for k in p0}
    return _RUN


def test_step1_loss_terms_match_jax():
    run = _run64()
    for k in LOSS_KEYS:
        assert run["port"][0][0][k] == pytest.approx(run["jax"][0][0][k],
                                                     abs=2e-5), k


def test_step1_seg_gradients_match_jax():
    run = _run64()
    got, want = run["port_grads"], run["jax_grads"]
    assert sorted(got) == sorted(k for k in want if k.startswith("Seg."))
    rows, noise = _grad_errors(got, want)
    assert len(rows) == 35          # 34 Seg weights and the out_block bias
    _check_grads(rows, noise)


def test_step1_sgd_update_is_minus_lr_times_gradient():
    """p1 == p0 - lr * grad for every Seg tensor (zero momentum buffer at
    step 1); what has no gradient did not move."""
    run = _run64()
    p0 = pm.from_jax_params(run["params"])
    p1 = run["port"][1][0]
    for k in p0:
        g = run["port_grads"].get(k)
        want = p0[k] if g is None else p0[k] - LR * g
        torch.testing.assert_close(p1[k], want, rtol=0, atol=1e-7)


def test_four_step_trajectory_matches_jax():
    run = _run64()
    for i, (lp, lj) in enumerate(zip(run["port"][0], run["jax"][0])):
        for k in LOSS_KEYS:
            tol = 1e-4 if i < 3 else 5e-3
            assert lp[k] == pytest.approx(lj[k], abs=tol), (i, k)
    # the port's step 2 is torch SGD with momentum on its own gradients
    (p1, p2), (g1, g2) = run["port"][1][:2], run["port"][2][:2]
    for k, g in g2.items():
        torch.testing.assert_close(p2[k], p1[k] - LR * (0.9 * g1[k] + g),
                                   rtol=0, atol=1e-7)


def test_step2_update_matches_jax_from_jax_weights():
    """JAX's second update, (j1 - j2) / lr, is 0.9 * g1 + g2: its g2 is held
    to the port's gradient AT JAX's step-1 weights on the second batch, at
    the step-1 tolerance. (Free-running weights cannot be compared after
    step 1: with random weights one step of lr 1e-2 turns the gradient
    around, cosine -0.26 between the gradients at p0 and at p1, so the 16%
    round-off of step 1 decorrelates the later updates, while the losses
    stay within 5e-3.)"""
    run = _run64()
    p0 = pm.from_jax_params(run["params"])
    j1, j2 = (pm.from_jax_params(t) for t in run["jax"][1][:2])
    want = {k: (j1[k] - j2[k]) / LR - 0.9 * run["jax_grads"][k] for k in p0}
    got = _port_trajectory(run["params"], run["batches"], 1, 64, start=j1,
                           lr=0.0, first_batch=1)[2][0]
    _check_grads(*_grad_errors(got, want))


def test_vae_gets_no_gradient_and_does_not_move():
    run = _run64()
    p0 = pm.from_jax_params(run["params"])
    student, teacher = run["port"][3], run["port"][4]
    assert not any(k.startswith("Vae.") for k in run["port_grads"])
    for k, v in student.state_dict().items():
        if k.startswith("Vae."):
            assert torch.equal(v, p0[k]), k
        elif not _norm_cancelled(k):
            # (a bias under an InstanceNorm may see an exactly zero gradient)
            assert not torch.equal(v, p0[k]), k
    # no EMA was asked for: the teacher still holds the initial weights
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, p0[k]), k
    assert all(not p.requires_grad for p in student.Vae.parameters())


def _faulty_stats_cotangent(y, gy, gst):
    """The planted fault: the sum-of-squares term dropped."""
    return (gy.float() + gst[:, 0, None, None, None, :]).to(y.dtype)


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


def _port_step1_grads(run):
    grads = {}
    _port_trajectory(run["params"], run["batches"], 1, 64, grads)
    return grads


def test_gradient_tolerance_sits_between_noise_and_a_fault(monkeypatch):
    """The port with reordered f32 conv sums drifts from itself by at least
    a third of its gradient error against JAX (that error is round-off) and
    stays inside the tolerance; the planted backward fault moves every Seg
    gradient at least 10x beyond it."""
    run = _run64()
    err, _ = _grad_errors(run["port_grads"], run["jax_grads"])
    ns = types.SimpleNamespace(
        conv3d=_split_sums(F.conv3d),
        conv_transpose3d=_split_sums(F.conv_transpose3d))
    with monkeypatch.context() as m:
        m.setattr(pconv3, "F", ns)
        m.setattr(pbridges, "F", ns)
        drift, noise = _grad_errors(_port_step1_grads(run),
                                    run["port_grads"])
    _check_grads(drift, noise)
    worst = max(err, key=lambda k: err[k][0])
    assert drift[worst][0] >= err[worst][0] / 3, (drift[worst], err[worst])
    with monkeypatch.context() as m:
        m.setattr(pconv3, "stats_cotangent", _faulty_stats_cotangent)
        fault, _ = _grad_errors(_port_step1_grads(run), run["jax_grads"])
    assert all(rel > 10 * GRAD_REL for rel, _ in fault.values()), fault


def test_fix_layer_and_adam_train_only_the_seg_head():
    params, batches = _case(32, seed=3, n_batches=1)
    student, teacher = _port_pair(params, 32)
    trainable = pt.optim.freeze_all_but_seg_head(student)
    names = {k for k, p in student.named_parameters() if p.requires_grad}
    assert names and all(k.startswith(("Seg.up5.", "Seg.out_block."))
                         for k in names)
    assert len(trainable) == len(names) == 10
    opt = pt.optim.build(trainable, True, 1e-3)
    assert isinstance(opt, torch.optim.Adam)
    before = {k: v.clone() for k, v in student.state_dict().items()}
    step = pt.make_adapt_step(pt.AdaptConfig(n_class=NC, domain_loss_type=0))
    img, lab = batches[0]
    step(student, teacher, opt, torch.from_numpy(img), torch.from_numpy(lab),
         torch.Generator().manual_seed(0), pt.default_sched(0.1))
    for k, v in student.state_dict().items():
        assert torch.equal(v, before[k]) == (k not in names), k


def test_ema_and_teacher_copy_match_jax(rng):
    params, _ = _case(32, seed=4, n_batches=0)
    other = jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * 0.1)
                         .astype(np.float32), params)
    student, teacher = _port_joint(32), _port_joint(32)
    pm.load_state(student, pm.from_jax_params(other))
    pm.load_state(teacher, pm.from_jax_params(params))
    want = jema.ema_update_seg(jax.tree.map(jnp.asarray, params),
                               jax.tree.map(jnp.asarray, other), 0.9)
    pt.ema_update_seg(teacher, student, 0.9)
    want = pm.from_jax_params(jax.tree.map(np.asarray, want))
    for k, v in teacher.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=1e-6, atol=1e-7)
        if k.startswith("Vae."):
            assert torch.equal(v, pm.from_jax_params(params)[k])
    pt.copy_params(teacher, student)
    for k, v in student.state_dict().items():
        assert torch.equal(teacher.state_dict()[k], v)
        assert teacher.state_dict()[k].data_ptr() != v.data_ptr()


def test_kl_step_uses_the_teacher_encoding():
    """--kl: kl_loss of the teacher's VAE encode of its own prediction,
    equal to JAX's, enters the type-8 loss."""
    params, batches = _case(64, seed=5, n_batches=1)
    img, lab = batches[0]
    model = _jax_joint(64)
    jp = jax.tree.map(jnp.asarray, params)
    t_pred, t_mean, t_std = jsteps._teacher_forward(
        model, jp, jnp.asarray(img)[..., None], True)
    want = float(JL.kl_loss(t_mean, t_std))
    student, teacher = _port_pair(params, 64)
    opt = pt.optim.sgd(pt.optim.freeze_vae(student), LR)
    step = pt.make_adapt_step(pt.AdaptConfig(n_class=NC, domain_loss_type=8,
                                             kl=True))
    aux = step(student, teacher, opt, torch.from_numpy(img),
               torch.from_numpy(lab), torch.Generator().manual_seed(0),
               pt.default_sched(LAMBDA))
    # measured 2e-4: the ReLU'd std has zeros, whose log(std + 1e-5) terms
    # magnify the f32 differences of the encoder
    assert float(aux["kl_loss"]) == pytest.approx(want, rel=1e-3)
    cur = 3.0 if float(aux["recon_loss"]) >= 0.3 else None
    assert cur is not None      # random weights: the top bucket
    assert float(aux["final_loss"]) == pytest.approx(
        float(aux["recon_loss"]) + float(aux["kl_loss"])
        + float(aux["dice_loss_fake"]) / cur, rel=1e-5)


def _report():
    """Print the measured errors against JAX at 64^3, the port's drift from
    itself under reordered f32 sums, and what the planted fault does."""
    run = _run64()
    for i, (lp, lj) in enumerate(zip(run["port"][0], run["jax"][0])):
        print("step", i, {k: abs(lp[k] - lj[k]) for k in LOSS_KEYS})
    rows, noise = _grad_errors(run["port_grads"], run["jax_grads"])
    print("vs JAX: norm-cancelled bias noise", noise)
    ns = types.SimpleNamespace(
        conv3d=_split_sums(F.conv3d),
        conv_transpose3d=_split_sums(F.conv_transpose3d))
    real_f = pconv3.F
    pconv3.F = pbridges.F = ns
    drift, dnoise = _grad_errors(_port_step1_grads(run), run["port_grads"])
    pconv3.F = pbridges.F = real_f
    real, pconv3.stats_cotangent = pconv3.stats_cotangent, \
        _faulty_stats_cotangent
    fault, _ = _grad_errors(_port_step1_grads(run), run["jax_grads"])
    pconv3.stats_cotangent = real
    print("reordered port vs port: bias noise", dnoise)
    for k, (rel, cos) in sorted(rows.items()):
        print(f"  {k:34s} vs JAX rel {rel:.2e} cos {cos:.4f} | reordered "
              f"rel {drift[k][0]:.2e} | fault rel {fault[k][0]:.2e}")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_train.py
    jax.config.update("jax_platforms", "cpu")
    _report()
