"""norm_type 2 (BatchNorm) and 3 (GSNorm) in the port (``models/blocks.py``:
``Norm``, ``gs_norm``, ``instance_norm`` and the blocks' norm_type
branches) against the JAX package's on the CPU, through every model kind,
with weights carried by ``from_jax_params`` (BatchNorms with their
``batch_stats``).

The norms alone (``Norm`` 1 / 2 / 3 and ``gs_norm`` at 1, 2 and 4 groups),
on [2, 4, 5, 6, 8] inputs, each in f32 and bf16: both packages compute in
f32 and cast once, so the outputs are held within ``NORM_F32`` (1e-5 of
their largest magnitude), in bf16 plus one bf16 ulp of the value. The
BatchNorm's updated running statistics within 1e-6 relative of flax's
(``mutable=["batch_stats"]``); torch's own running update (the unbiased
variance, n / (n - 1)) is planted and must fail that rule.

The models at narrow widths (fmaps (4, 8, 8, 16, 16, 32), latent 16,
batch 2, f32):
  * norm_type 2 at 64^3 wherever a VAE or an encoder bottoms out (a
    BatchNorm of a 1^3 volume at batch 2 outputs +-1), SegUNet and
    FusionNet at 32^3 (2^3 at the bottom); BatchNorm scales and biases and
    the running statistics drawn from the seed. Tolerances, those of
    tests/test_torch_models.py at 64^3 (``LIMITS_64``): probabilities
    ``PROB_ABS`` 3e-4, reconstructions ``RECON_ABS`` 1e-2, latents 4e-3,
    sigmoid scores 1e-4 abs; the running statistics after the forward
    ``STATS_REL`` 1e-3 of their largest magnitude. A network fed by
    another's output is held on one input, the JAX network of the port's
    input: the Joint's VAE of the port's prediction (the 64^3 VAE
    amplifies the two predictions' 8.0e-5 difference to 1.9e-2 in recon,
    where the port's reordered f32 sums move it 8.8e-4) and Embed's
    Fusion of the port's gt_recon. Measured: probabilities <= 8.0e-5,
    reconstructions <= 1.7e-3, latents <= 1.6e-4, scores <= 1.4e-5.
  * norm_type 3 at 32^3 (a GSNorm is voxel-local: a 1^3 volume is no
    special case). GSNorm divides a raw conv output by its channel sum +
    1e-4, and with the seed's U(-b, b) weights those sums come near 0: the
    first block's outputs reach 1.7e4, and the port drifts from itself by
    1.0 max / 0.33 mean abs in the Joint's probabilities when only the
    f32 summation order of its convs changes (the JAX model likewise).
    There the first block matches the JAX package's bit for bit
    (``test_gsnorm_first_block_is_exact``); the whole models are held on a
    conditioned draw instead: non-negative kernels, biases and images, so
    every channel sum is at least its largest term and every GSNorm output
    lies in [0, 1] (Embed's injected eps non-negative too). Tolerance
    ``GS_ABS`` 1e-4 on every output (measured <= 3.6e-7).

Also: the ``from_jax_params`` round trip of a norm_type 2 tree with its
``batch_stats`` and of a norm_type 3 tree, a strict ``load_state`` of a
norm_type 2 model's port checkpoint, and a norm_type 2 model refused by a
train step, an eval and an active mesh while a norm_type 3 one runs in the
step.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_embed_steps import jax_eps, port_eps
from vae_segmentation_tpu.models import Embed as JEmbed
from vae_segmentation_tpu.models import FusionNet as JFusion
from vae_segmentation_tpu.models import Joint as JJoint
from vae_segmentation_tpu.models import Joint2 as JJoint2
from vae_segmentation_tpu.models import SegUNet as JSeg
from vae_segmentation_tpu.models import ShapeEncoder as JEnc
from vae_segmentation_tpu.models import ShapeVAE as JVae
from vae_segmentation_tpu.models.blocks import ConvNormAct as JConvNormAct
from vae_segmentation_tpu.models.blocks import Norm as JNorm
from vae_segmentation_tpu.models.blocks import gs_norm as jgs_norm
from vae_segmentation_tpu.models.torch_compat import convert_state_dict
from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch import train as pt
from vae_segmentation_tpu_torch.core.checkpoint import save_checkpoint
from vae_segmentation_tpu_torch.eval import evaluate as peval
from vae_segmentation_tpu_torch.models import blocks as pblocks
from vae_segmentation_tpu_torch.parallel import sharding

torch.set_num_threads(2)

FMAPS = (4, 8, 8, 16, 16, 32)
BATCH, NC, DIM = 2, 2, 16
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
PDT = {"f32": torch.float32, "bf16": torch.bfloat16}
NORM_F32 = 1e-5
PROB_ABS, RECON_ABS, LATENT_ABS, SCORE_ABS = 3e-4, 1e-2, 4e-3, 1e-4
STATS_REL = 1e-3
GS_ABS = 1e-4
UPDATE_REL = 1e-6


# ---------------------------------------------------------------- the norms

def _norm_input(dt, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(2, 4, 5, 6, 8)) * 3 + 1).astype(np.float32)
    return jnp.asarray(x).astype(JDT[dt]), torch.from_numpy(x).to(PDT[dt])


def _bn_state(rng, c):
    return ({"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
             "bias": rng.uniform(-0.5, 0.5, c).astype(np.float32)},
            {"mean": rng.uniform(-0.5, 0.5, c).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)})


def _port_bn(params, stats, **kw):
    m = pm.Norm(2, params["scale"].shape[0], **kw)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(params["scale"]))
        m.bias.copy_(torch.from_numpy(params["bias"]))
        m.running_mean.copy_(torch.from_numpy(stats["mean"]))
        m.running_var.copy_(torch.from_numpy(stats["var"]))
    return m


def _assert_norm_close(got, want, dt):
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = NORM_F32 * max(1.0, np.abs(want).max())
    if dt == "bf16":    # and one bf16 ulp of the value (2^-7 of its octave)
        tol = tol + 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                        1e-30))) - 7)
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("norm_type", [1, 2, 3])
def test_norm_matches_jax(norm_type, dt):
    jx, px = _norm_input(dt)
    if norm_type != 2:
        want = JNorm(norm_type).apply({}, jx)
        got = pm.Norm(norm_type)(px)
        _assert_norm_close(got, want, dt)
        return
    params, stats = _bn_state(np.random.default_rng(1), 8)
    want, upd = JNorm(2).apply(
        {"params": {"BatchNorm_0": params},
         "batch_stats": {"BatchNorm_0": stats}}, jx, mutable=["batch_stats"])
    m = _port_bn(params, stats)
    got = m(px)
    _assert_norm_close(got, want, dt)
    new = upd["batch_stats"]["BatchNorm_0"]
    _assert_update(m.running_mean, new["mean"])
    _assert_update(m.running_var, new["var"])
    assert int(m.num_batches_tracked) == 1


def _assert_update(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=UPDATE_REL,
                               atol=UPDATE_REL)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_batch_norm_running_average_matches_jax(dt):
    """use_running_average: the stored statistics normalise, nothing
    moves."""
    jx, px = _norm_input(dt, seed=2)
    params, stats = _bn_state(np.random.default_rng(3), 8)
    want = JNorm(2, use_running_average=True).apply(
        {"params": {"BatchNorm_0": params},
         "batch_stats": {"BatchNorm_0": stats}}, jx)
    m = _port_bn(params, stats, use_running_average=True)
    _assert_norm_close(m(px), want, dt)
    np.testing.assert_array_equal(m.running_mean.numpy(), stats["mean"])
    np.testing.assert_array_equal(m.running_var.numpy(), stats["var"])
    assert int(m.num_batches_tracked) == 0


def test_batch_norm_updates_in_eval_mode_too():
    """The JAX models build every Norm with use_running_average=False: a
    port model normalises with batch statistics and moves its buffers
    whatever ``training`` says."""
    _, px = _norm_input("f32", seed=4)
    params, stats = _bn_state(np.random.default_rng(5), 8)
    a, b = _port_bn(params, stats), _port_bn(params, stats).eval()
    torch.testing.assert_close(a(px), b(px), rtol=0, atol=0)
    torch.testing.assert_close(a.running_var, b.running_var, rtol=0, atol=0)
    assert not torch.equal(b.running_var, torch.from_numpy(stats["var"]))


def test_unbiased_running_update_fails_the_rule():
    """The planted fault: torch's F.batch_norm update (momentum 0.1, the
    unbiased variance) in place of flax's. Its running variance sits
    1 / (n - 1) of 0.1 var from flax's, beyond UPDATE_REL; the port's is
    within it."""
    jx, px = _norm_input("f32", seed=6)
    params, stats = _bn_state(np.random.default_rng(7), 8)
    _, upd = JNorm(2).apply(
        {"params": {"BatchNorm_0": params},
         "batch_stats": {"BatchNorm_0": stats}}, jx, mutable=["batch_stats"])
    want = upd["batch_stats"]["BatchNorm_0"]["var"]
    rm = torch.from_numpy(stats["mean"].copy())
    rv = torch.from_numpy(stats["var"].copy())
    F.batch_norm(px.permute(0, 4, 1, 2, 3), rm, rv, None, None,
                 training=True, momentum=0.1, eps=1e-5)
    with pytest.raises(AssertionError):
        _assert_update(rv, want)
    m = _port_bn(params, stats)
    m(px)
    _assert_update(m.running_var, want)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_gs_norm_matches_jax(groups, dt):
    jx, px = _norm_input(dt, seed=8)
    _assert_norm_close(pm.gs_norm(px, groups), jgs_norm(jx, groups), dt)


def test_gsnorm_first_block_is_exact():
    """A norm_type 3 ConvNormAct on the seed's U(-b, b) weights: the port
    computes the JAX block's values bit for bit, 1.7e4 at most (channel
    sums near 0)."""
    rng = np.random.default_rng(9)
    x = (rng.normal(size=(2, 16, 16, 16, 1)) * 0.5).astype(np.float32)
    jm = JConvNormAct(4, norm_type=3, dtype=jnp.float32)
    params = _draw(jax.eval_shape(lambda v: jm.init(jax.random.PRNGKey(0), v),
                                  jax.ShapeDtypeStruct(x.shape, jnp.float32)
                                  )["params"], rng)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    m = pblocks.ConvNormAct(1, 4, norm_type=3)
    m.load_state_dict({"conv.0.weight": torch.from_numpy(np.ascontiguousarray(
        np.transpose(params["Conv3_0"]["kernel"], (4, 3, 0, 1, 2)))),
        "conv.0.bias": torch.from_numpy(params["Conv3_0"]["bias"])})
    with torch.no_grad():
        got, aff = m(torch.from_numpy(x))
    assert aff is None
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).max() > 1e3


# ---------------------------------------------------------------- the models

def _draw(template, rng, positive=False):
    """U(-b, b), b = 1/sqrt(fan_in), for every kernel and its bias;
    BatchNorm scales U(0.5, 1.5) and biases U(-0.2, 0.2). `positive` is
    the conditioned draw of norm_type 3 (``_conditioned``)."""
    out = {}
    for name, node in template.items():
        if "kernel" in node:
            b = 1.0 / math.sqrt(math.prod(node["kernel"].shape[:-1]))
            out[name] = _conditioned(node, b, rng) if positive else {
                k: rng.uniform(-b, b, v.shape).astype(np.float32)
                for k, v in node.items()}
        elif "scale" in node:
            out[name] = {"scale": rng.uniform(0.5, 1.5, node["scale"].shape)
                         .astype(np.float32),
                         "bias": rng.uniform(-0.2, 0.2, node["bias"].shape)
                         .astype(np.float32)}
        else:
            out[name] = _draw(node, rng, positive)
    return out


def _conditioned(node, b, rng):
    """A layer of the norm_type 3 draw. Every activation stays >= 0 (a
    non-negative image, the ReLU after every GSNorm), and a 3^3 kernel is
    V - mean_O(V) + P with V ~ U(-b, b) and P ~ U(0, b) shared by the
    output channels: the channels differ by signed weights, but their sum,
    the GSNorm's denominator, is C_out * P . x >= 0 with no cancellation
    beyond round-off. The other kernels (the bridges, the dense layers) are
    U(0, b), the biases U(0, b / 100): a bias that dominated a GSNorm's
    small inputs would flatten its output and every gradient below it."""
    k = node["kernel"].shape
    if len(k) == 5 and k[:3] == (3, 3, 3):
        v = rng.uniform(-b, b, k)
        kernel = v - v.mean(axis=-1, keepdims=True) \
            + rng.uniform(0.0, b, k[:-1] + (1,))
    else:
        kernel = rng.uniform(0.0, b, k)
    return {"kernel": kernel.astype(np.float32),
            "bias": rng.uniform(0.0, b / 100, node["bias"].shape)
            .astype(np.float32)}


def _draw_stats(template, rng):
    return jax.tree.map(
        lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32),
        template)


# kind: (size at norm_type 2, JAX model, port model, input kinds)
def _jax_model(kind, nt, size):
    bott = FMAPS[5] * (size // 32) ** 3
    kw = dict(norm_type=nt, fmaps=FMAPS, dtype=jnp.float32)
    return {"seg": lambda: JSeg(n_class=NC, **kw),
            "vae": lambda: JVae(n_class=NC, dim=DIM, bottleneck=bott, **kw),
            "vae_soft": lambda: JVae(n_class=NC, dim=DIM, bottleneck=bott,
                                     soft=True, **kw),
            "encoder": lambda: JEnc(dim=1, bottleneck=bott, **kw),
            "fusion": lambda: JFusion(n_class=NC, **kw),
            "joint": lambda: JJoint(n_class=NC, dim=DIM, bottleneck=bott,
                                    **kw),
            "joint2": lambda: JJoint2(n_class=NC, bottleneck=bott, **kw),
            "embed": lambda: JEmbed(n_class=NC, dim=DIM, bottleneck=bott,
                                    **kw)}[kind]()


def _port_model(kind, nt, size):
    bott = FMAPS[5] * (size // 32) ** 3
    kw = dict(norm_type=nt, fmaps=FMAPS, dtype=torch.float32)
    return {"seg": lambda: pm.SegUNet(n_class=NC, **kw),
            "vae": lambda: pm.ShapeVAE(n_class=NC, dim=DIM, bottleneck=bott,
                                       **kw),
            "vae_soft": lambda: pm.ShapeVAE(n_class=NC, dim=DIM,
                                            bottleneck=bott, soft=True, **kw),
            "encoder": lambda: pm.ShapeEncoder(dim=1, bottleneck=bott, **kw),
            "fusion": lambda: pm.FusionNet(n_class=NC, **kw),
            "joint": lambda: pm.Joint(n_class=NC, dim=DIM, bottleneck=bott,
                                      **kw),
            "joint2": lambda: pm.Joint2(n_class=NC, bottleneck=bott, **kw),
            "embed": lambda: pm.Embed(n_class=NC, dim=DIM, bottleneck=bott,
                                      **kw)}[kind]()


# each kind's inputs ("image" one channel, "mask" class probabilities,
# "onehot" a one-hot label) and its outputs' names and tolerances at
# norm_type 2 (norm_type 3: GS_ABS for all)
KINDS = {
    "seg": (32, ("image",), {"pred": PROB_ABS}),
    "vae": (64, ("mask",), {"recon": RECON_ABS, "mean": LATENT_ABS,
                            "std": LATENT_ABS}),
    "vae_soft": (64, ("mask",), {"recon": RECON_ABS, "mean": LATENT_ABS,
                                 "std": LATENT_ABS}),
    "encoder": (64, ("mask1",), {"score": SCORE_ABS}),
    "fusion": (32, ("image", "mask"), {"pred": PROB_ABS}),
    "joint": (64, ("image",), {"pred": PROB_ABS, "recon": RECON_ABS,
                               "mean": LATENT_ABS, "std": LATENT_ABS}),
    "joint2": (64, ("image",), {"pred": PROB_ABS, "score": SCORE_ABS}),
    "embed": (64, ("image", "onehot"), {
        "latent_code": LATENT_ABS, "gt_recon": RECON_ABS,
        "latent_code_gt": LATENT_ABS, "latent_code_std": LATENT_ABS,
        "init_seg": RECON_ABS, "pred": RECON_ABS, "seg_recon": RECON_ABS}),
}


def _inputs(kinds, size, rng, positive):
    shape = (BATCH, size, size, size)
    out = []
    for k in kinds:
        if k == "image":
            x = rng.normal(size=shape + (1,)) * 0.5
            out.append(np.abs(x) if positive else x)
        elif k in ("mask", "mask1"):
            logits = rng.normal(size=shape + (NC,)) * 2
            p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
            out.append(p[..., 1:] if k == "mask1" else p)
        else:
            out.append(np.eye(NC)[rng.integers(0, NC, shape)])
    return [x.astype(np.float32) for x in out]


def _named(kind, out):
    names = list(KINDS[kind][2])
    if isinstance(out, dict):
        return {n: out[n] for n in names}
    out = out if isinstance(out, tuple) else (out,)
    return dict(zip(names, out))


def _run_case(kind, nt):
    size = KINDS[kind][0] if nt == 2 else 32
    rng = np.random.default_rng(10 * nt + len(kind))
    inputs = _inputs(KINDS[kind][1], size, rng, positive=nt == 3)
    jm = _jax_model(kind, nt, size)
    shapes = jax.eval_shape(
        lambda *v: jm.init({"params": jax.random.PRNGKey(0),
                            "reparam": jax.random.PRNGKey(1)}, *v),
        *[jax.ShapeDtypeStruct(x.shape, jnp.float32) for x in inputs])
    params = _draw(shapes["params"], rng, positive=nt == 3)
    stats = _draw_stats(shapes["batch_stats"], rng) if nt == 2 else None
    eps = rng.normal(size=(BATCH, DIM)).astype(np.float32)
    if nt == 3:     # the conditioned draw: a non-negative latent too
        eps = np.abs(eps)
    variables = {"params": params}
    if stats is not None:
        variables["batch_stats"] = stats
    with jax_eps(eps):
        out = jax.jit(lambda v, *x: jm.apply(
            v, *x, rngs={"reparam": jax.random.PRNGKey(2)},
            mutable=["batch_stats"] if nt == 2 else False))(
                variables, *[jnp.asarray(x) for x in inputs])
    want, upd = out if nt == 2 else (out, None)
    model = pm.load_state(_port_model(kind, nt, size),
                          pm.from_jax_params(params, stats))
    with port_eps(eps), torch.no_grad():
        got = model(*[torch.from_numpy(x) for x in inputs])
    want = _named(kind, jax.tree.map(np.asarray, want))
    got = _named(kind, jax.tree.map(lambda t: t.numpy(), got))
    if kind == "joint":
        # the VAE half held on one input: the JAX VAE of the port's
        # prediction (the 64^3 VAE amplifies the two predictions' 8e-5
        # difference to 1.9e-2 in recon at norm_type 2)
        vae_out = jax.jit(lambda v, x: jm.apply(
            v, x, method=lambda m, p: m.Vae(p),
            mutable=["batch_stats"] if nt == 2 else False))(
                variables, jnp.asarray(got["pred"]))
        vae_out = vae_out[0] if nt == 2 else vae_out
        want.update(zip(("recon", "mean", "std"),
                        (np.asarray(v) for v in vae_out)))
    if kind == "embed":
        # likewise the Fusion's prediction: the JAX Fusion of the image and
        # the port's gt_recon
        fused = jax.jit(lambda v, x, m: jm.apply(
            v, x, m, method=lambda mod, a, b: mod.Fusion(a, b),
            mutable=["batch_stats"] if nt == 2 else False))(
                variables, jnp.asarray(inputs[0]),
                jnp.asarray(got["gt_recon"]))
        want["pred"] = np.asarray(fused[0] if nt == 2 else fused)
    return want, got, model, params, \
        None if upd is None else upd["batch_stats"]


NETWORKS = ("encoder", "fusion", "seg", "vae", "vae_soft")
# the composites' cases: tests/test_torch_norm_composites.py
COMPOSITES = ("embed", "joint", "joint2")


@pytest.mark.parametrize("norm_type", [2, 3])
@pytest.mark.parametrize("kind", NETWORKS)
def test_model_matches_jax(kind, norm_type):
    check_model(kind, norm_type)


def check_model(kind, norm_type):
    """The port's `kind` at `norm_type` against the JAX model: every output
    within its tolerance, at norm_type 2 the running statistics after the
    forward against flax's updated batch_stats."""
    want, got, model, params, new_stats = _run_case(kind, norm_type)
    for name, tol in KINDS[kind][2].items():
        tol = GS_ABS if norm_type == 3 else tol
        w, g = np.asarray(want[name], np.float32), got[name]
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        assert np.abs(g - w).max() <= tol, (name, np.abs(g - w).max())
    if norm_type == 3:
        assert not any(isinstance(m, pm.Norm) and m.norm_type != 3
                       for m in model.modules())
        return
    # the running statistics after the forward: flax's updated batch_stats
    want_sd = pm.from_jax_params(params, new_stats)
    got_sd = model.state_dict()
    keys = [k for k in want_sd if k.endswith(("running_mean",
                                              "running_var"))]
    assert keys
    for k in keys:
        w, g = want_sd[k].numpy(), got_sd[k].numpy()
        tol = STATS_REL * max(1.0, np.abs(w).max())
        assert np.abs(g - w).max() <= tol, (k, np.abs(g - w).max())


# ------------------------------------------------------- weights and refusal

def _template(kind, nt, size=64):
    jm = _jax_model(kind, nt, size)
    inputs = _inputs(KINDS[kind][1], 1, np.random.default_rng(0), False)
    return jax.eval_shape(
        lambda *v: jm.init({"params": jax.random.PRNGKey(0),
                            "reparam": jax.random.PRNGKey(1)}, *v),
        *[jax.ShapeDtypeStruct((1, size, size, size, x.shape[-1]),
                               jnp.float32) for x in inputs])


@pytest.mark.parametrize("kind", ["joint", "joint2", "embed"])
def test_from_jax_params_carries_a_norm2_tree(kind):
    """Every key of the port model, loaded strictly; each BatchNorm's
    scale, bias, mean and var at its reference key (``conv.1`` of a
    ConvNormAct, ``conv.1.conv.{1,4,7}`` of a DoubleConv); without
    batch_stats the buffers are flax's initial 0 and 1."""
    shapes = _template(kind, 2)
    rng = np.random.default_rng(11)
    params = jax.tree.map(lambda s: rng.normal(size=s.shape)
                          .astype(np.float32), shapes["params"])
    stats = _draw_stats(shapes["batch_stats"], rng)
    sd = pm.from_jax_params(params, stats)
    model = pm.load_state(_port_model(kind, 2, 64), sd)
    assert sd.keys() == model.state_dict().keys()
    seen = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        names = [p.key for p in path]
        if "BatchNorm_0" not in names:
            continue
        i = names.index("BatchNorm_0")
        sub = names[0] + "." if kind in ("joint", "joint2", "embed") else ""
        net = names[1:i - 1] if sub else names[:i - 1]
        norm = int(names[i - 1].split("_")[1])
        key = sub + (f"{net[0]}.conv.1" if len(net) == 1
                     else f"{net[0]}.conv.1.conv.{(1, 4, 7)[norm]}")
        leaf_key = {"scale": "weight", "bias": "bias"}[names[-1]]
        np.testing.assert_array_equal(sd[f"{key}.{leaf_key}"].numpy(), leaf)
        node = stats
        for n in names[:i + 1]:
            node = node[n]
        np.testing.assert_array_equal(sd[f"{key}.running_mean"].numpy(),
                                      node["mean"])
        np.testing.assert_array_equal(sd[f"{key}.running_var"].numpy(),
                                      node["var"])
        assert int(sd[f"{key}.num_batches_tracked"]) == 0
        seen += 1
    assert seen == sum(isinstance(m, pm.Norm) for m in model.modules()) * 2
    bare = pm.from_jax_params(params)
    for k, v in bare.items():
        if k.endswith("running_mean"):
            assert not v.any()
        elif k.endswith("running_var"):
            assert (v == 1).all()


def test_from_jax_params_round_trips_a_norm3_tree():
    """A norm_type 3 tree is the norm_type 1 tree (GSNorm has no
    parameters): at the flagship widths (convert_state_dict's bottleneck
    geometry) from_jax_params inverts convert_state_dict on a Joint's
    (test_model_matches_jax loads every kind's narrow tree strictly)."""
    jm = JJoint(n_class=NC, norm_type=3, dim=128, bottleneck=16384)
    params = jax.eval_shape(
        lambda x: jm.init(jax.random.PRNGKey(0), x),
        jax.ShapeDtypeStruct((1, 128, 128, 128, 1), jnp.float32))["params"]
    rng = np.random.default_rng(12)
    params = jax.tree.map(lambda s: rng.normal(size=s.shape)
                          .astype(np.float32), params)
    sd = pm.from_jax_params(params)
    pm.load_state(pm.Joint(n_class=NC, dim=128, bottleneck=16384,
                           norm_type=3), sd)
    back = convert_state_dict({k: v.numpy() for k, v in sd.items()}, params,
                              "joint")
    flat = jax.tree_util.tree_flatten_with_path
    assert [p for p, _ in flat(back)[0]] == [p for p, _ in flat(params)[0]]
    for (_, a), (_, b) in zip(flat(back)[0], flat(params)[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_norm2_checkpoint_loads_strictly(tmp_path):
    """A norm_type 2 model's port checkpoint (``save_checkpoint``) holds
    every BatchNorm buffer and loads into a fresh model strictly."""
    a = pm.Joint(fmaps=FMAPS, dim=DIM, bottleneck=FMAPS[5] * 8,
                 norm_type=2, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a(torch.randn(2, 64, 64, 64, 1, generator=torch.Generator()
                      .manual_seed(1)).to(torch.bfloat16))
    path = tmp_path / "best_model.ckpt"
    save_checkpoint(str(path), epoch=1, model=a)
    b = pm.load_state(pm.Joint(fmaps=FMAPS, dim=DIM,
                               bottleneck=FMAPS[5] * 8, norm_type=2),
                      str(path))
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert any(k.endswith("num_batches_tracked") for k in sa)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert int(sb["Seg.in_block.conv.1.num_batches_tracked"]) == 1


def test_norm2_is_refused_by_steps_evals_and_a_mesh():
    """No JAX step or eval runs a BatchNorm (they apply {"params": p}
    alone), and no mesh does: each raises ValueError; the same model runs
    at the model level, and a norm_type 3 model runs in the step."""
    kw = dict(fmaps=(2, 2, 2, 2, 2, 2), dtype=torch.float32)
    image = torch.randn(2, 16, 16, 16)
    label = (torch.rand(2, 16, 16, 16) > 0.5).float()
    seg2 = pm.SegUNet(norm_type=2, **kw)
    seg2(image[..., None])
    step = pt.make_seg_train_step(NC)
    with pytest.raises(ValueError, match="BatchNorm"):
        step(seg2, pt.optim.sgd(seg2.parameters(), 1e-3), image, label)
    with pytest.raises(ValueError, match="BatchNorm"):
        peval.make_seg_eval_step(seg2, NC)(image, label)
    mesh = sharding.Mesh(n_data=1, n_spatial=1, rank=0, member=True)
    with sharding.active(mesh), pytest.raises(ValueError, match="mesh"):
        seg2(image[..., None])
    seg3 = pm.SegUNet(norm_type=3, **kw)
    aux = step(seg3, pt.optim.sgd(seg3.parameters(), 1e-3), image, label)
    assert torch.isfinite(aux["dice_loss"])
    with sharding.active(mesh):
        assert torch.isfinite(seg3(image[..., None])).all()
