"""The port's SegUNet, ShapeVAE and Joint against the JAX package's models
on the CPU (where the JAX package runs the logical model: no s2d fold, XLA
convs). Weights are drawn once from a numpy seed into the JAX param tree
and carried across with ``from_jax_params``; inputs come from a numpy
seed. Fmaps (4, 8, 8, 16, 16, 32), batch 2.

At 32^3, f32: probabilities <= 1e-4 abs, mean/std <= 1e-4 of their largest
magnitude, per-case Dice <= 1e-4. At this size the VAE bottleneck is 1^3,
so its InstanceNorm sets the encoder output to zero and mean/std equal the
fc biases: the 32^3 tests hold the decoder and the Seg network, not the
VAE encoder.

At 64^3 (a 2^3 bottleneck) the encoder counts: the ShapeVAE test also holds
the activation before the flatten. The limits there (``LIMITS_64``) sit
between two measured errors (``python tests/test_torch_models.py`` prints
both): f32 summation-order noise, which the port shows against itself when
only the order of its conv sums changes (``test_64_limits_sit_between_
noise_and_a_fault``), and a planted norm fault (eps 1e-4 for 1e-5), which
every output must exceed. Summation order is the cause of the 64^3 error,
not the one-pass variance: the port with f64 (sum, sumsq) statistics
lands as far from the JAX package as with f32 ones.

bf16 (32^3): per-case Dice <= 0.02 against the JAX package's bf16 model,
and the port's bf16 output may sit no further from the f32 result than the
JAX package's own bf16 output does (max and mean abs, 25% slack). The two
bf16 models round at different points (the port's fused prologue
normalizes in f32 where XLA normalizes in bf16, and the port adds the bias
before its one cast), so they are compared through the f32 truth: at this
size the JAX package's own bf16 probabilities differ from its f32 ones by
0.085-0.11 max and 0.008-0.011 mean abs (five seeds and widths), more than
the 5e-2 / 5e-3 any two bf16 implementations could be held to.
"""

import math
import types
from contextlib import ExitStack
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from vae_segmentation_tpu.models import Joint as JJoint
from vae_segmentation_tpu.models import SegUNet as JSeg
from vae_segmentation_tpu.models import ShapeVAE as JVae
from vae_segmentation_tpu.ops import losses as JL
from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch.models import blocks as pblocks
from vae_segmentation_tpu_torch.ops import bridges as pbridges
from vae_segmentation_tpu_torch.ops import conv3 as pconv3
from vae_segmentation_tpu_torch.ops import losses as PL

torch.set_num_threads(2)

FMAPS = (4, 8, 8, 16, 16, 32)
SIZE, BATCH, NC, DIM = 32, 2, 2, 16
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
PDT = {"f32": torch.float32, "bf16": torch.bfloat16}
SEEDS = {"seg": 0, "vae": 1, "joint": 2}
NAMES = {"seg": ["pred"], "vae": ["recon", "mean", "std"],
         "joint": ["pred", "recon", "mean", "std"]}
# f32 at 64^3: probabilities abs, the rest relative to their largest |value|
LIMITS_64 = {"vae": {"act": 5e-4, "recon": 2e-3, "mean": 5e-4, "std": 5e-4},
             "joint": {"pred": 3e-4, "recon": 1e-2, "mean": 4e-3,
                       "std": 4e-3}}


def _bottleneck(size):
    return FMAPS[5] * (size // 32) ** 3


def _jax_model(kind, dt, size=SIZE):
    if kind == "seg":
        return JSeg(n_class=NC, fmaps=FMAPS, dtype=JDT[dt], s2d=False)
    if kind == "vae":
        return JVae(n_class=NC, fmaps=FMAPS, dim=DIM,
                    bottleneck=_bottleneck(size), dtype=JDT[dt], s2d=False)
    return JJoint(n_class=NC, dim=DIM, fmaps=FMAPS,
                  bottleneck=_bottleneck(size), dtype=JDT[dt])


def _port_model(kind, dt, size=SIZE):
    if kind == "seg":
        return pm.SegUNet(n_class=NC, fmaps=FMAPS, dtype=PDT[dt])
    if kind == "vae":
        return pm.ShapeVAE(n_class=NC, fmaps=FMAPS, dim=DIM,
                           bottleneck=_bottleneck(size), dtype=PDT[dt])
    return pm.Joint(n_class=NC, dim=DIM, fmaps=FMAPS,
                    bottleneck=_bottleneck(size), dtype=PDT[dt])


def _draw_params(template, rng):
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every kernel and its bias
    (fan_in = prod of all but the last kernel axis: the torch init for
    convs, the channel-preserving transposed convs and dense layers)."""
    out = {}
    for name, node in template.items():
        if "kernel" in node:
            bound = 1.0 / math.sqrt(math.prod(node["kernel"].shape[:-1]))
            out[name] = {k: rng.uniform(-bound, bound, v.shape)
                         .astype(np.float32) for k, v in node.items()}
        else:
            out[name] = _draw_params(node, rng)
    return out


def _inputs(kind, rng, size):
    if kind == "vae":
        logits = rng.normal(size=(BATCH, size, size, size, NC)) * 2
        return (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)) \
            .astype(np.float32)
    return (rng.normal(size=(BATCH, size, size, size, 1)) * 0.5) \
        .astype(np.float32)


def _label(rng, size):
    """An ellipsoid foreground per case, [B, D, H, W] class values."""
    z, y, x = np.mgrid[:size, :size, :size]
    out = np.zeros((BATCH, size, size, size), np.float32)
    for i in range(BATCH):
        c = rng.uniform(10, size - 10, 3)
        r = rng.uniform(4, 9, 3)
        out[i][((z - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2
               + ((x - c[2]) / r[2]) ** 2 <= 1] = 1
    return out


_CACHE = {}


def _case(kind, size=SIZE, seed=None):
    """(params, input, label) for `kind`, drawn once per file."""
    seed = SEEDS[kind] if seed is None else seed
    key = (kind, size, seed)
    if key not in _CACHE:
        rng = np.random.default_rng(seed)
        x = _inputs(kind, rng, size)
        template = jax.eval_shape(
            lambda v: _jax_model(kind, "f32", size).init(
                jax.random.PRNGKey(0), v),
            jax.ShapeDtypeStruct(x.shape, jnp.float32))["params"]
        _CACHE[key] = (_draw_params(template, rng), x, _label(rng, size))
    return _CACHE[key]


def _jax_encode_act(vae, x):
    """The ShapeVAE encoder's activation before the flatten (s2d off)."""
    x = vae.down1(vae.in_block(x))
    for down in (vae.down2, vae.down3, vae.down4, vae.down5):
        x = down(x)
    return x


def _jax_out(kind, dt, size=SIZE, seed=None):
    key = (kind, dt, size, seed, "jax")
    if key not in _CACHE:
        params, x, _ = _case(kind, size, seed)
        model = _jax_model(kind, dt, size)
        out = model.apply({"params": params}, jnp.asarray(x))
        out = list(out) if isinstance(out, tuple) else [out]
        if kind == "vae":
            out.append(model.apply({"params": params}, jnp.asarray(x),
                                   method=_jax_encode_act))
        _CACHE[key] = [np.asarray(o, np.float32) for o in out]
    return _CACHE[key]


def _port_out(kind, dt, size=SIZE, seed=None, patches=()):
    """The port's outputs (for the VAE also the activation before the
    flatten, taken by a hook on down5) under the given mock patches."""
    params, x, _ = _case(kind, size, seed)
    model = _port_model(kind, dt, size)
    pm.load_state(model, pm.from_jax_params(params))
    act = []
    if kind == "vae":
        model.down5.register_forward_hook(lambda m, a, o: act.append(o))
    with ExitStack() as stack, torch.no_grad():
        for p in patches:
            stack.enter_context(p)
        out = model.eval()(torch.from_numpy(x).to(PDT[dt]))
    out = list(out) if isinstance(out, tuple) else [out]
    return [o.float().numpy() for o in out + act], model


def _errors(kind, got, want):
    """{output: error}: max abs for probabilities, max abs over the largest
    |want| for the rest; 'act' is the VAE's pre-flatten activation."""
    names = NAMES[kind] + (["act"] if kind == "vae" else [])
    out = {}
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        err = float(np.abs(g - w).max())
        out[name] = err if name in ("pred", "recon") \
            else err / float(np.abs(w).max())
    return out


def _dice(pred, label):
    """Per-case binary Dice [B] with the JAX package's metric."""
    onehot = JL.one_hot_label(jnp.asarray(label), NC, jnp.float32)
    return np.asarray(JL.avg_dsc(jnp.asarray(pred), onehot, binary=True,
                                 botindex=1, topindex=NC, return_mean=False))


def _check_dice(kind, got, want, label, tol):
    names = NAMES[kind]
    pred = got[names.index("pred")]
    port_dice = PL.avg_dsc(torch.from_numpy(pred),
                           PL.one_hot_label(torch.from_numpy(label), NC),
                           binary=True, botindex=1, topindex=NC,
                           return_mean=False).numpy()
    jd = _dice(want[names.index("pred")], label)
    assert np.abs(port_dice - jd).max() <= tol, (port_dice, jd)


def _check(kind, dt, names):
    """Compare every output at 32^3; probabilities are 'pred'/'recon'."""
    got, _ = _port_out(kind, dt)
    want = _jax_out(kind, dt)
    truth = _jax_out(kind, "f32")
    for name, g, w, t in zip(names, got, want, truth):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if dt == "f32":
            tol = 1e-4 if name in ("pred", "recon") \
                else 1e-4 * np.abs(w).max()
            assert np.abs(g - w).max() <= tol, (name, np.abs(g - w).max())
        else:
            port_err, ref_err = np.abs(g - t), np.abs(w - t)
            assert port_err.max() <= 1.25 * ref_err.max() + 1e-3, \
                (name, port_err.max(), ref_err.max())
            assert port_err.mean() <= 1.25 * ref_err.mean() + 1e-4, \
                (name, port_err.mean(), ref_err.mean())
    if "pred" in names:
        _check_dice(kind, got, want, _case(kind)[2],
                    1e-4 if dt == "f32" else 0.02)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_segunet_parity(dt):
    _check("seg", dt, ["pred"])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_shapevae_parity(dt):
    _check("vae", dt, ["recon", "mean", "std"])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_joint_parity(dt):
    _check("joint", dt, ["pred", "recon", "mean", "std"])


def test_shapevae_decode_parity():
    """mid_input decode of a latent (f32), the eval-path vae_forward."""
    params, _, _ = _case("vae")
    z = np.random.default_rng(5).normal(size=(BATCH, DIM)).astype(np.float32)
    want = _jax_model("vae", "f32").apply({"params": params}, jnp.asarray(z),
                                          mid_input=True)
    model = _port_model("vae", "f32")
    pm.load_state(model, pm.from_jax_params(params))
    with torch.no_grad():
        got = model(torch.from_numpy(z), mid_input=True)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4


# ---- 64^3: the VAE encoder counts


def _split_sums(fn):
    """`fn` (conv3d or conv_transpose3d, NCDHW) computed as the sum of two
    convs over the halves of the input channels: the same function with
    another f32 summation order."""
    def run(x, w, b=None, **kw):
        h = x.shape[1] // 2
        if h == 0:
            return fn(x, w, b, **kw)
        wa, wb = (w[:, :h], w[:, h:]) if fn is F.conv3d else (w[:h], w[h:])
        return fn(x[:, :h], wa, b, **kw) + fn(x[:, h:], wb, None, **kw)
    return run


def _reordered_sums():
    """Patches that give every plain conv of the port another f32
    summation order."""
    ns = types.SimpleNamespace(conv3d=_split_sums(F.conv3d),
                               conv_transpose3d=_split_sums(
                                   F.conv_transpose3d))
    return [mock.patch.object(pconv3, "F", ns),
            mock.patch.object(pbridges, "F", ns)]


def _norm_eps_fault():
    """A planted fault: InstanceNorm eps 1e-4 for 1e-5."""
    aff = pblocks.affine_from_stats
    return [mock.patch.object(pblocks, "affine_from_stats",
                              lambda st, n, eps=1e-5: aff(st, n, 1e-4))]


def _f64_stats():
    """The port with its (sum, sumsq) statistics in f64."""
    def stats(y):
        y = y.double()
        return torch.stack([y.sum(dim=(1, 2, 3)),
                            (y * y).sum(dim=(1, 2, 3))], dim=1)
    return [mock.patch.object(pconv3, "_stats", stats)]


@pytest.mark.parametrize("kind", ["vae", "joint"])
def test_parity_64(kind):
    """f32 at 64^3: ShapeVAE (recon, mean, std and the encoder's activation
    before the flatten) and Joint, within LIMITS_64; Joint Dice <= 1e-4."""
    got, _ = _port_out(kind, "f32", 64)
    want = _jax_out(kind, "f32", 64)
    err = _errors(kind, got, want)
    assert all(err[n] <= lim for n, lim in LIMITS_64[kind].items()), err
    if kind == "joint":
        _check_dice(kind, got, want, _case(kind, 64)[2], 1e-4)


@pytest.mark.parametrize("kind", ["vae", "joint"])
def test_64_limits_sit_between_noise_and_a_fault(kind):
    """The port with reordered f32 conv sums drifts from itself by at least
    a tenth of its recon error against the JAX package (the error is
    summation-order noise) and stays within LIMITS_64; the planted norm
    fault exceeds every limit."""
    base, _ = _port_out(kind, "f32", 64)
    want = _jax_out(kind, "f32", 64)
    reordered, _ = _port_out(kind, "f32", 64, patches=_reordered_sums())
    drift = _errors(kind, reordered, base)
    err = _errors(kind, base, want)
    assert drift["recon"] >= 0.1 * err["recon"], (drift, err)
    limits = LIMITS_64[kind]
    assert all(drift[n] <= lim for n, lim in limits.items()), drift
    faulty, _ = _port_out(kind, "f32", 64, patches=_norm_eps_fault())
    fault = _errors(kind, faulty, want)
    assert all(fault[n] > lim for n, lim in limits.items()), fault


def _report(seeds=(0, 1, 2, 3)):
    """Print, per kind and seed at 64^3 (f32), the port's error against the
    JAX package, with reordered sums, with f64 statistics and with the
    planted fault, and the reordered port's drift from the port."""
    for kind in ("vae", "joint"):
        for seed in seeds:
            want = _jax_out(kind, "f32", 64, seed)
            base, _ = _port_out(kind, "f32", 64, seed)
            rows = {"port": base}
            for tag, patches in (("reordered", _reordered_sums()),
                                 ("f64 stats", _f64_stats()),
                                 ("eps fault", _norm_eps_fault())):
                rows[tag] = _port_out(kind, "f32", 64, seed, patches)[0]
            for tag, got in rows.items():
                print(kind, seed, f"{tag} vs jax", _errors(kind, got, want))
            print(kind, seed, "reordered vs port",
                  _errors(kind, rows["reordered"], base), flush=True)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python tests/test_torch_models.py
    jax.config.update("jax_platforms", "cpu")
    _report()
