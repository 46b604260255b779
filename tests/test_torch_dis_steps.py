"""The port's discriminator methods (``train/steps.py::
make_discriminator_step``, ``::make_adapt_dis_step``; ``eval/evaluate.py::
make_seg_eval_step`` of the Joint2's Seg, ``::make_discriminator_eval_step``)
against the JAX package's (train/steps.py:693-743, cli/target_main.py:
395-405, 597-607) on the CPU, with the JAX target CLI's wiring: the ShapeEncoder
(dim 1) trained whole, the Joint2's Dis frozen by the optimizer
(``optim.freeze_dis``) with its gradient flowing through it into the Seg,
a teacher SegUNet, SGD (momentum 0.9, zero buffer at step 1). Seg dropout
0 (the JAX dropout stream cannot be reproduced in torch).

At 64^3 (a 2^3 bottleneck: at 32^3 the encoder's norm zeroes its output
and the score is the same for every input) with tests/test_torch_train.py's
widths, seeded weights carried across by ``from_jax_params``, batch 2,
f32. Tolerances (``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_dis_steps.py`` prints the measured errors):
  * loss terms and scores: 2e-5 abs, as tests/test_torch_train.py;
  * gradients, per tensor, against JAX's step-1 update over -lr: relative
    L2 <= ``GRAD_REL`` = 0.3 and cosine >= 0.97, the band of
    tests/test_torch_train.py (the discriminator's dense layers and the
    head, which no norm follows, 2e-2); the norm-cancelled biases (a 3^3
    conv's that an InstanceNorm follows) within ``NOISE_ABS`` = 0.2 of the
    largest weight gradient. The planted backward fault (the stats
    cotangent's sum-of-squares term dropped in K1's backward) moves every
    3^3 conv weight out of the band;
  * the frozen Dis bit for bit, in both packages;
  * the eval steps' scores: 1e-5 abs (binary Dice: a probability at 0.5
    could flip; none here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _draw_params
from vae_segmentation_tpu.cli import target_main as jtarget
from vae_segmentation_tpu.models import Joint2 as JJoint2
from vae_segmentation_tpu.models import SegUNet as JSeg
from vae_segmentation_tpu.models import ShapeEncoder as JEnc
from vae_segmentation_tpu.train import optim as joptim
from vae_segmentation_tpu.train import steps as jsteps
from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch import train as pt
from vae_segmentation_tpu_torch.eval import evaluate as peval
from vae_segmentation_tpu_torch.ops import conv3 as pconv3

torch.set_num_threads(2)

FMAPS = (4, 8, 8, 16, 16, 32)
SIZE, BATCH, NC, LR, LAMBDA = 64, 2, 2, 1e-2, 1.0
BOTT = FMAPS[5] * (SIZE // 32) ** 3
LOSS_ABS = 2e-5
GRAD_REL, GRAD_COS, NOISE_ABS = 0.3, 0.97, 0.2
TIGHT_REL = 2e-2    # a layer with no norm between it and the loss: the
                    # discriminator's dense layers, a head
TIGHT = ("fc1", "fc2", "fc_mean", "out_block")
DIS_KEYS = ("discriminator_loss", "dice_loss_fake", "dice_loss",
            "final_loss")


def _template(model, cin):
    return jax.eval_shape(
        lambda v: model.init(jax.random.PRNGKey(0), v),
        jax.ShapeDtypeStruct((BATCH, SIZE, SIZE, SIZE, cin),
                             jnp.float32))["params"]


def _blobs(rng):
    """[B, D, H, W] class-valued masks: an ellipsoid each, plus noise."""
    ax = np.arange(SIZE) - SIZE / 2
    out = []
    for _ in range(BATCH):
        r = np.sqrt((ax[:, None, None] / rng.uniform(0.8, 1.3)) ** 2
                    + ax[None, :, None] ** 2 + ax[None, None, :] ** 2)
        blob = r < rng.uniform(10, 20)
        out.append((blob ^ (rng.random(r.shape) > 0.97)).astype(np.float32))
    return np.stack(out)


def _jax_enc():
    return JEnc(dim=1, fmaps=FMAPS, bottleneck=BOTT, dtype=jnp.float32)


def _jax_joint2():
    return JJoint2(n_class=NC, fmaps=FMAPS, bottleneck=BOTT,
                   dtype=jnp.float32)


def _port_enc(params):
    return pm.load_state(pm.ShapeEncoder(dim=1, fmaps=FMAPS, bottleneck=BOTT,
                                         dtype=torch.float32),
                         pm.from_jax_params(params))


def _port_joint2(params):
    return pm.load_state(pm.Joint2(n_class=NC, fmaps=FMAPS, bottleneck=BOTT,
                                   dtype=torch.float32),
                         pm.from_jax_params(params))


def _port_seg(params):
    return pm.load_state(pm.SegUNet(n_class=NC, fmaps=FMAPS,
                                    dtype=torch.float32),
                         pm.from_jax_params(params))


def _jax_grads(params, new, lr=LR):
    """JAX's step-1 gradient from its update: p1 = p0 - lr * g."""
    p0, p1 = pm.from_jax_params(params), pm.from_jax_params(new)
    return {k: (p0[k] - p1[k]) / lr for k in p0}


def _cases():
    rng = np.random.default_rng(0)
    enc = _draw_params(_template(_jax_enc(), 1), rng)
    joint2 = _draw_params(_template(_jax_joint2(), 1), rng)
    teacher = _draw_params(_template(JSeg(n_class=NC, fmaps=FMAPS,
                                          dtype=jnp.float32), 1), rng)
    mask = _blobs(rng)
    image = (rng.normal(size=mask.shape) * 0.3 + mask).astype(np.float32)
    score = rng.uniform(0.2, 1.0, BATCH).astype(np.float32)
    return {"enc": enc, "joint2": joint2, "teacher": teacher, "mask": mask,
            "image": image, "score": score}


def _jax_disc(c):
    tx = joptim.sgd(LR)
    step = jsteps.make_discriminator_step(_jax_enc(), tx)
    state = jsteps.init_state(jax.tree.map(jnp.asarray, c["enc"]), tx)
    state, aux = step(state, jnp.asarray(c["mask"]), jnp.asarray(c["score"]))
    return {k: np.asarray(v) for k, v in aux.items()}, \
        _jax_grads(c["enc"], jax.tree.map(np.asarray, state.params))


def _jax_adapt_dis(c):
    params = jax.tree.map(jnp.asarray, c["joint2"])
    tx = joptim.freeze_by_path(joptim.sgd(LR), params,
                               lambda path: path and path[0] == "Dis")
    step = jsteps.make_adapt_dis_step(
        _jax_joint2(), JSeg(n_class=NC, fmaps=FMAPS, dtype=jnp.float32), tx,
        jsteps.AdaptConfig(n_class=NC))
    state = jsteps.init_state(params, tx)
    state, aux = step(state, jax.tree.map(jnp.asarray, c["teacher"]),
                      jnp.asarray(c["image"]), jnp.asarray(c["mask"]),
                      jax.random.PRNGKey(0), jsteps.default_sched(LAMBDA))
    new = jax.tree.map(np.asarray, state.params)
    return {k: float(v) for k, v in aux.items()}, \
        _jax_grads(c["joint2"], new), new


def _port_disc(c, lr=LR):
    enc = _port_enc(c["enc"])
    opt = pt.optim.sgd(enc.parameters(), lr)
    aux = pt.make_discriminator_step()(enc, opt, torch.from_numpy(c["mask"]),
                                       torch.from_numpy(c["score"]))
    return {k: v.numpy() for k, v in aux.items()}, \
        {k: p.grad.clone() for k, p in enc.named_parameters()}


def _port_adapt_dis(c, lr=LR):
    student = _port_joint2(c["joint2"])
    teacher = _port_seg(c["teacher"])
    opt = pt.optim.sgd(pt.optim.freeze_dis(student), lr)
    dis0 = {k: v.clone() for k, v in student.Dis.state_dict().items()}
    aux = pt.make_adapt_dis_step(pt.AdaptConfig(n_class=NC))(
        student, teacher, opt, torch.from_numpy(c["image"]),
        torch.from_numpy(c["mask"]), torch.Generator().manual_seed(0),
        pt.default_sched(LAMBDA))
    grads = {k: p.grad.clone() for k, p in student.named_parameters()
             if p.grad is not None}
    dis_still = all(torch.equal(v, dis0[k])
                    for k, v in student.Dis.state_dict().items())
    return {k: float(v) for k, v in aux.items()}, grads, dis_still, student


_RUN = {}


def _run():
    if not _RUN:
        c = _cases()
        _RUN.update(case=c, jax_disc=_jax_disc(c),
                    jax_dis=_jax_adapt_dis(c), port_disc=_port_disc(c),
                    port_dis=_port_adapt_dis(c))
    return _RUN


def _norm_cancelled(key):
    """A 3^3 conv's bias that an InstanceNorm follows (in exact arithmetic
    its gradient is 0): those of a DoubleConv and of a ConvNormAct. The
    biases of the K2 and K3 bridges feed a conv first, and count."""
    parts = key.split(".")
    return parts[-1] == "bias" and (".conv.1.conv." in key or (
        parts[-3:-1] == ["conv", "0"]
        and parts[-4] in ("in_block", "in_block_mask", "merge")))


def _module(key):
    return key.split(".")[-2]


def grad_errors(got, want, prefix=""):
    """{key: (relative L2 error, cosine)} of every tensor under `prefix`
    but the norm-cancelled biases, and their largest gradient over the
    largest weight-gradient element."""
    rows, noise, scale = {}, 0.0, 0.0
    for key, w in want.items():
        if not key.startswith(prefix):
            continue
        g, w = got[key].numpy().ravel(), w.numpy().ravel()
        if _norm_cancelled(key):
            noise = max(noise, np.abs(g).max(), np.abs(w).max())
            continue
        scale = max(scale, np.abs(w).max())
        rows[key] = (float(np.linalg.norm(g - w) / np.linalg.norm(w)),
                     float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w))))
    return rows, noise / scale


def check_grads(rows, noise, tight=TIGHT):
    """Every row in the band (TIGHT_REL for the modules `tight`), the
    norm-cancelled biases' noise within NOISE_ABS."""
    for key, (rel, cos) in rows.items():
        assert rel <= (TIGHT_REL if _module(key) in tight else GRAD_REL) \
            and cos >= GRAD_COS, (key, rel, cos)
    assert noise <= NOISE_ABS, noise


def test_discriminator_step_matches_jax():
    run = _run()
    (jaux, jgrads), (paux, pgrads) = run["jax_disc"], run["port_disc"]
    assert abs(float(paux["final_loss"]) - float(jaux["final_loss"])) \
        <= LOSS_ABS
    np.testing.assert_allclose(paux["score_out"], jaux["score_out"],
                               atol=LOSS_ABS)
    assert sorted(pgrads) == sorted(jgrads)
    rows, noise = grad_errors(pgrads, jgrads)
    # 21 conv weights, 5 K2 biases, 3 dense weights and biases
    assert len(rows) == 32
    check_grads(rows, noise)


def test_adapt_dis_step_matches_jax_and_leaves_the_dis():
    run = _run()
    (jaux, jgrads, jnew), (paux, pgrads, dis_still, _) = run["jax_dis"], \
        run["port_dis"]
    for k in DIS_KEYS:
        assert paux[k] == pytest.approx(jaux[k], abs=LOSS_ABS), k
    assert sorted(pgrads) == sorted(k for k in jgrads
                                    if k.startswith("Seg."))
    rows, noise = grad_errors(pgrads, jgrads, "Seg.")
    check_grads(rows, noise)
    # the Dis takes no update in either package
    assert dis_still
    j0 = pm.from_jax_params(run["case"]["joint2"])
    j1 = pm.from_jax_params(jnew)
    assert all(torch.equal(j0[k], j1[k]) for k in j0 if k.startswith("Dis."))


def _faulty_stats_cotangent(y, gy, gst):
    """The planted fault: the sum-of-squares term dropped."""
    return (gy.float() + gst[:, 0, None, None, None, :]).to(y.dtype)


@pytest.mark.parametrize("step", ["discriminator", "adapt_dis"])
def test_gradient_band_excludes_a_planted_fault(monkeypatch, step):
    """With the planted backward fault every 3^3 conv weight that an
    InstanceNorm follows leaves the band (rel > GRAD_REL)."""
    run = _run()
    with monkeypatch.context() as m:
        m.setattr(pconv3, "stats_cotangent", _faulty_stats_cotangent)
        if step == "discriminator":
            got, want = _port_disc(run["case"])[1], run["jax_disc"][1]
        else:
            got, want = _port_adapt_dis(run["case"])[1], run["jax_dis"][1]
    rows, _ = grad_errors(got, want, "" if step == "discriminator"
                          else "Seg.")
    convs = {k: v for k, v in rows.items() if _module(k) not in TIGHT
             and k.endswith(".weight")}
    assert convs and all(rel > GRAD_REL for rel, _ in convs.values()), \
        convs


def test_eval_steps_match_jax():
    """make_seg_eval_step of the Joint2's Seg against the JAX package's
    make_joint2_eval at its --val_batch 1, and the discriminator's per-case eval score."""
    c = _run()["case"]
    student = _port_joint2(c["joint2"]).eval()
    step = peval.make_seg_eval_step(student.Seg, NC)
    jstep = jtarget.make_joint2_eval(_jax_joint2(), NC)
    for i in range(BATCH):
        img, lab = c["image"][i:i + 1], c["mask"][i:i + 1]
        want = jstep(jax.tree.map(jnp.asarray, c["joint2"]),
                     jnp.asarray(img), jnp.asarray(lab))
        got = step(torch.from_numpy(img), torch.from_numpy(lab))
        assert abs(float(got["score"][0]) - float(want["score"])) <= 1e-5
    enc = _port_enc(c["enc"]).eval()
    got = peval.make_discriminator_eval_step(enc)(
        torch.from_numpy(c["mask"]), torch.from_numpy(c["score"]))["score"]
    out = _jax_enc().apply({"params": jax.tree.map(jnp.asarray, c["enc"])},
                           jnp.asarray(c["mask"])[..., None])[:, 0]
    want = 1.0 - np.square(c["score"] - np.asarray(out))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _report():
    run = _run()
    for name, (pg, jg, prefix) in {
            "discriminator": (run["port_disc"][1], run["jax_disc"][1], ""),
            "adapt_dis": (run["port_dis"][1], run["jax_dis"][1], "Seg.")
    }.items():
        rows, noise = grad_errors(pg, jg, prefix)
        print(name, "noise", noise)
        for k, v in sorted(rows.items(), key=lambda kv: -kv[1][0]):
            print(f"  {k}: rel {v[0]:.3g} cos {v[1]:.5f}")
    print("losses", run["port_disc"][0]["final_loss"],
          run["jax_disc"][0]["final_loss"], run["port_dis"][0],
          run["jax_dis"][0])


if __name__ == "__main__":
    _report()
