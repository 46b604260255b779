"""The port's GS family (``models/gs.py``) against the JAX package's
``models/gs.py`` on the CPU, and the norm_type 3 (GSNorm) train steps
against the JAX package's.

Weights come from the JAX modules' own init (torch's default ranges) and
cross as torch layouts: a conv's kernel [k, k, k, I, O] -> [O, I, k, k, k],
a transposed conv's with its taps flipped -> [I, O, k, k, k]
(models/torch_compat.py of the JAX package); SegmentationGS by
``from_jax_params``. f32 unless named. Tolerances:
  * the four checks of tests/test_inventory.py:14-62, each also as parity
    with the JAX module's output: ``ABS`` 1e-5 of the output's largest
    magnitude (measured <= 1e-6; every GS output here is a sum of at most
    27 x 120 products);
  * each reparametrised conv at K1's shape (3^3 SAME), at K2's (2^3 stride
    2 VALID), at K3's (the transposed 2^3 stride 2) and at shapes the
    kernels do not take (stride-2 SAME 3^3, the transposed 3^3 stride 2, a
    transposed kernel smaller than its stride); bf16 at K1's shape: the
    JAX module's own bf16 error from its f32 output, 25% and 1e-3 slack,
    as tests/test_torch_encoder_models.py;
  * a GSConv3d weight gradient against ``jax.grad`` through
    ``_gs_normalize_kernel``: 1e-5 relative L2 (measured ~1e-7);
  * ``upsample`` against ``jax.image.resize(..., "trilinear")`` at factors
    2, 4 and 8 on odd-sized volumes, the edge planes alone and the whole:
    1e-6 abs (JAX drops the taps outside the volume and renormalizes,
    torch clamps the coordinate: the same weights);
  * SegmentationGS at the reference widths (8, 16, 32, 64: GSNorm groups
    2, 4, 8, 8) and the inventory's (2, 3, 4, 5: gcd groups 2, 1, 4, 5):
    probabilities 1e-5 abs, summing to 1. Its GSNorms follow a ReLU, so
    each channel sum is at least its largest term: well conditioned on the
    default init (unlike a norm_type 3 block, tests/test_torch_norm_types
    .py);
  * the norm_type 3 steps (``make_vae_train_step``, ``make_seg_train_step``
    at 32^3, batch 2, fmaps (4, 8, 8, 16, 16, 32), lr 1e-2) on the
    conditioned draw of tests/test_torch_norm_types.py (non-negative
    kernels, biases, images and injected eps): loss terms 1e-4 abs, the
    Dice tolerance of tests/test_torch_source_train.py (measured 3.9e-5
    and 4.3e-5: the JAX step's f32 reduction of the Dice sums over the
    volume; the port's sums lie within 1e-7 of their f64 value). The
    gradients: the JAX step's from its SGD momentum trace (its update
    cannot resolve them: they fall ~10x a layer from the head, to 1e-22),
    the port's ``.grad``; every tensor (GSNorm cancels no bias) within
    tests/test_torch_train.py's band, relative L2 <= 0.3 and cosine >= 0.97
    (measured <= 1.1e-4), or 0 in both where it underflows; the seg_train
    step under SP2 (two gloo ranks, chip_smoke.py's conditioned draw)
    against one process's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_embed_steps import jax_eps, port_eps
from test_torch_norm_types import _draw
from vae_segmentation_tpu.models import SegUNet as JSeg
from vae_segmentation_tpu.models import ShapeVAE as JVae
from vae_segmentation_tpu.models import gs as jgs
from vae_segmentation_tpu.train import optim as joptim
from vae_segmentation_tpu.train import steps as jsteps
from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch import train as pt
from vae_segmentation_tpu_torch.models import gs as pgs
from vae_segmentation_tpu_torch.models.weights import kind_of

torch.set_num_threads(2)

ABS = 1e-5
GRAD_REL, GRAD_COS = 0.3, 0.97
LOSS_ABS = 1e-4


def _conv(k):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(k), (4, 3, 0, 1, 2))))


def _convt(k):
    k = np.asarray(k)[::-1, ::-1, ::-1]
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(k, (3, 4, 0, 1, 2))))


def _load(module, params, convt=False):
    """A bare JAX conv's {kernel, bias} into a port module."""
    with torch.no_grad():
        module.weight.copy_(_convt(params["kernel"]) if convt
                            else _conv(params["kernel"]))
        if "bias" in params:
            module.bias.copy_(torch.from_numpy(np.array(params["bias"])))
    return module


def _jax_run(module, x, seed=0):
    xs = jnp.asarray(x)
    params = module.init({"params": jax.random.PRNGKey(seed)},
                         xs.astype(jnp.float32))["params"]
    return params, np.asarray(module.apply({"params": params}, xs),
                              np.float32)


def _close(got, want, tol=ABS):
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _rand(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


# ------------------------------------------- tests/test_inventory.py:14-62

def test_gsconv_weights_sum_to_one_per_group():
    rng = np.random.default_rng(0)
    x = _rand(rng, (1, 8, 8, 8, 4))
    params, want = _jax_run(jgs.GSConv3d(features=4, num_group=2,
                                         dtype=jnp.float32), x)
    m = _load(pgs.GSConv3d(4, 4, num_group=2), params)
    _close(m(torch.from_numpy(x)), want)
    k = m.derived_weight()
    sums = k.reshape(4, 2, 2, 27).sum(dim=2)
    torch.testing.assert_close(sums, torch.ones_like(sums), rtol=1e-5,
                               atol=0)
    torch.testing.assert_close(k, _conv(jgs._gs_normalize_kernel(
        params["kernel"], 2)), rtol=1e-6, atol=0)


def test_sconv_zero_mean_kernel_kills_dc():
    const = np.full((1, 8, 8, 8, 2), 5.0, np.float32)
    params, want = _jax_run(jgs.SConv3d(features=3, dtype=jnp.float32),
                            const)
    m = _load(pgs.SConv3d(2, 3), params)
    got = m(torch.from_numpy(const))
    _close(got, want)
    interior = got.detach().numpy()[0, 2:-2, 2:-2, 2:-2]
    np.testing.assert_allclose(
        interior, np.broadcast_to(np.asarray(params["bias"]),
                                  interior.shape), atol=1e-4)


def _gs_model(fmaps, size, seed):
    rng = np.random.default_rng(seed)
    x = _rand(rng, (1, size, size, size, 1))
    jm = jgs.SegmentationGS(n_class=2, fmaps=fmaps, dtype=jnp.float32)
    params = jm.init({"params": jax.random.PRNGKey(seed)},
                     jnp.asarray(x))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    params = jax.tree.map(np.asarray, params)
    model = pm.load_state(pm.SegmentationGS(n_class=2, fmaps=fmaps,
                                            dtype=torch.float32),
                          pm.from_jax_params(params))
    return params, x, want, model


@pytest.mark.parametrize("fmaps,size", [((2, 3, 4, 5, 6, 8), 16),
                                        ((8, 16, 32, 64), 16)])
def test_segmentation_gs_forward(fmaps, size):
    _, x, want, model = _gs_model(fmaps, size, len(fmaps))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (1, size, size, size, 2)
    _close(got, want)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_gsconvtranspose_upsamples():
    rng = np.random.default_rng(1)
    x = _rand(rng, (1, 4, 4, 4, 2))
    params, want = _jax_run(jgs.GSConvTranspose3d(features=3, num_group=1,
                                                  dtype=jnp.float32), x)
    m = _load(pgs.GSConvTranspose3d(2, 3), params, convt=True)
    got = m(torch.from_numpy(x))
    assert got.shape == (1, 8, 8, 8, 3)
    _close(got, want)


# ---------------------------------------------- the convs at every shape

CONVS = {
    # name: (JAX module, port module, input shape, transposed)
    "gsconv_k1": (lambda: jgs.GSConv3d(6, num_group=2, dtype=jnp.float32),
                  lambda: pgs.GSConv3d(4, 6, num_group=2), (2, 6, 5, 4, 4),
                  False),
    "gsconv_k2": (lambda: jgs.GSConv3d(5, kernel=(2, 2, 2),
                                       strides=(2, 2, 2), padding="VALID",
                                       use_bias=False, dtype=jnp.float32),
                  lambda: pgs.GSConv3d(4, 5, kernel=2, stride=2,
                                       padding="VALID", bias=False),
                  (2, 6, 4, 8, 4), False),
    "gsconv_s2_same": (lambda: jgs.GSConv3d(3, strides=(2, 2, 2),
                                            dtype=jnp.float32),
                       lambda: pgs.GSConv3d(2, 3, stride=2),
                       (1, 7, 6, 5, 2), False),
    "sconv_k1": (lambda: jgs.SConv3d(3, dtype=jnp.float32),
                 lambda: pgs.SConv3d(2, 3), (2, 5, 6, 4, 2), False),
    "sconv_pairs": (lambda: jgs.SConv3d(3, kernel=(1, 3, 3),
                                        padding=((0, 0), (2, 0), (1, 1)),
                                        dtype=jnp.float32),
                    lambda: pgs.SConv3d(2, 3, kernel=(1, 3, 3),
                                        padding=((0, 0), (2, 0), (1, 1))),
                    (1, 4, 5, 6, 2), False),
    "gsconvt_k3": (lambda: jgs.GSConvTranspose3d(4, num_group=2,
                                                 use_bias=True,
                                                 dtype=jnp.float32),
                   lambda: pgs.GSConvTranspose3d(4, 4, num_group=2,
                                                 bias=True),
                   (2, 3, 4, 5, 4), True),
    "gsconvt_3s2": (lambda: jgs.GSConvTranspose3d(3, kernel=(3, 3, 3),
                                                  dtype=jnp.float32),
                    lambda: pgs.GSConvTranspose3d(2, 3, kernel=3),
                    (1, 3, 4, 2, 2), True),
    "gsconvt_2s3": (lambda: jgs.GSConvTranspose3d(3, strides=(3, 3, 3),
                                                  dtype=jnp.float32),
                    lambda: pgs.GSConvTranspose3d(2, 3, stride=3),
                    (1, 3, 2, 4, 2), True),
}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_conv_matches_jax(name):
    jmod, pmod, shape, convt = CONVS[name]
    x = _rand(np.random.default_rng(len(name)), shape)
    params, want = _jax_run(jmod(), x)
    _close(_load(pmod(), params, convt)(torch.from_numpy(x)), want)


@pytest.mark.parametrize("name", ["gsconv_k1", "gsconvt_k3"])
def test_conv_bf16_as_close_as_jax_bf16(name):
    """The port's bf16 output no further from the f32 result than the JAX
    module's own bf16 output (max and mean abs, 25% slack, + 1e-3 /
    1e-4)."""
    jmod, pmod, shape, convt = CONVS[name]
    x = _rand(np.random.default_rng(7), shape)
    params, truth = _jax_run(jmod(), x)
    jb = jmod().clone(dtype=jnp.bfloat16)
    want = np.asarray(jb.apply({"params": params}, jnp.asarray(x)),
                      np.float32)
    got = _load(pmod(), params, convt)(
        torch.from_numpy(x).to(torch.bfloat16)).detach().float().numpy()
    port, ref = np.abs(got - truth), np.abs(want - truth)
    assert port.max() <= 1.25 * ref.max() + 1e-3, (port.max(), ref.max())
    assert port.mean() <= 1.25 * ref.mean() + 1e-4, (port.mean(),
                                                      ref.mean())


@pytest.mark.parametrize("kernel", [(3, 3, 3), (2, 2, 2)])
def test_gsconv_weight_gradient_matches_jax_grad(kernel):
    """d sum(y * r) / d weight through the reparametrisation, K1's route
    (3^3 SAME) and the general one (2^3 SAME), against jax.grad of the JAX
    module's kernel."""
    rng = np.random.default_rng(11)
    x = _rand(rng, (2, 6, 6, 6, 4))
    jm = jgs.GSConv3d(4, num_group=2, kernel=kernel, dtype=jnp.float32)
    params = jm.init({"params": jax.random.PRNGKey(3)},
                     jnp.asarray(x))["params"]
    r = _rand(rng, (2, 6, 6, 6, 4))
    g = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x))
                                   * r))(params)
    m = _load(pgs.GSConv3d(4, 4, num_group=2, kernel=kernel), params)
    (m(torch.from_numpy(x)) * torch.from_numpy(r)).sum().backward()
    for got, want in ((m.weight.grad, _conv(g["kernel"])),
                      (m.bias.grad, torch.from_numpy(np.array(
                          g["bias"])))):
        assert (got - want).norm() <= 1e-5 * want.norm(), \
            ((got - want).norm() / want.norm()).item()


# ------------------------------------------------------------ the blocks

@pytest.mark.parametrize("factor", [2, 4, 8])
def test_upsample_matches_jax_resize_at_the_edges(factor):
    rng = np.random.default_rng(factor)
    x = _rand(rng, (1, 3, 4, 5, 2))
    want = np.asarray(jax.image.resize(
        jnp.asarray(x), (1, 3 * factor, 4 * factor, 5 * factor, 2),
        "trilinear"))
    got = pgs.upsample(torch.from_numpy(x), factor).numpy()
    for axis in (1, 2, 3):
        for idx in (0, -1):
            np.testing.assert_allclose(np.take(got, idx, axis),
                                       np.take(want, idx, axis), atol=1e-6)
    np.testing.assert_allclose(got, want, atol=1e-6)


BLOCKS = {
    # name: (JAX block, port block, input channels, torch key of each JAX
    # conv path)
    "conv_gs": (lambda: jgs.ConvGS(4, dtype=jnp.float32),
                lambda: pgs.ConvGS(3, 4), 3, {("Conv3_0",): "conv.0"}),
    "double_conv_gs_soft": (
        lambda: jgs.DoubleConvGS(4, soft=True, dtype=jnp.float32),
        lambda: pgs.DoubleConvGS(3, 4, soft=True), 3,
        {("Conv3_0",): "conv.0", ("Conv3_1",): "conv.2"}),
    "down_gs": (lambda: jgs.DownGS(5, dtype=jnp.float32),
                lambda: pgs.DownGS(3, 5), 3,
                {("Conv3_0",): "conv.0",
                 ("DoubleConvGS_0", "Conv3_0"): "conv.1.conv.0",
                 ("DoubleConvGS_0", "Conv3_1"): "conv.1.conv.2"}),
    "up_gs": (lambda: jgs.UpGS(2, dtype=jnp.float32),
              lambda: pgs.UpGS(3, 2), 3,
              {("DoubleConvGS_0", "Conv3_0"): "conv.1.conv.0",
               ("DoubleConvGS_0", "Conv3_1"): "conv.1.conv.2"}),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name):
    jmod, pmod, cin, keys = BLOCKS[name]
    x = _rand(np.random.default_rng(len(name)), (2, 6, 8, 4, cin))
    params, want = _jax_run(jmod(), x)
    sd = {}
    for path, key in keys.items():
        node = params
        for p in path:
            node = node[p]
        sd[f"{key}.weight"] = _conv(node["kernel"])
        sd[f"{key}.bias"] = torch.from_numpy(np.array(node["bias"]))
    m = pmod()
    m.load_state_dict(sd, strict=True)
    _close(m(torch.from_numpy(x)), want)


def test_from_jax_params_carries_a_segmentation_gs_tree():
    """Every leaf of the JAX tree at its documented key (models/gs.py), in
    torch layout, and nothing else: the port model loads it strictly."""
    params, _, _, model = _gs_model((8, 16, 32, 64), 16, 5)
    sd = pm.from_jax_params(params)
    assert sd.keys() == model.state_dict().keys()
    names = {"ConvGS_0": "in_block", "DownGS_0": "down1",
             "DownGS_1": "down2", "DownGS_2": "down3", "ConvGS_1": "fuse",
             "Conv3_0": "out_block"}
    inner = {("Conv3_0",): "conv.0", ("DoubleConvGS_0", "Conv3_0"):
             "conv.1.conv.0", ("DoubleConvGS_0", "Conv3_1"): "conv.1.conv.2"}
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        names_ = [p.key for p in path]
        key = names[names_[0]]
        if len(names_) > 2:
            key += "." + inner[tuple(names_[1:-1])]
        if names_[-1] == "kernel":
            torch.testing.assert_close(sd[f"{key}.weight"], _conv(leaf),
                                       rtol=0, atol=0)
        else:
            torch.testing.assert_close(sd[f"{key}.bias"],
                                       torch.from_numpy(np.array(leaf)),
                                       rtol=0, atol=0)
        n += 1
    assert n == len(sd)
    assert kind_of(params) == "segmentation_gs"


# ------------------------------------------- the norm_type 3 train steps

FMAPS = (4, 8, 8, 16, 16, 32)
SIZE, BATCH, NC, DIM, LR = 32, 2, 2, 16, 1e-2
BOTT = FMAPS[5] * (SIZE // 32) ** 3


def _jax_gradient(state):
    """The JAX step's gradient: SGD's momentum trace after step 1
    (optax.sgd's ``TraceState``, zero before the step). The update
    p0 - lr * g cannot resolve the GSNorm network's gradients, which fall
    ~10x a layer from the head to 1e-10 and below."""
    trace = next(t for t in jax.tree.leaves(
        state.opt_state, is_leaf=lambda n: hasattr(n, "trace"))
        if hasattr(t, "trace"))
    return pm.from_jax_params(jax.tree.map(np.asarray, trace.trace))


def _step_case(kind):
    rng = np.random.default_rng(21 if kind == "vae" else 22)
    jm = JVae(n_class=NC, norm_type=3, dim=DIM, fmaps=FMAPS,
              bottleneck=BOTT, dtype=jnp.float32) if kind == "vae" \
        else JSeg(n_class=NC, norm_type=3, fmaps=FMAPS, dtype=jnp.float32)
    cin = NC if kind == "vae" else 1
    template = jax.eval_shape(
        lambda v: jm.init(jax.random.PRNGKey(0), v),
        jax.ShapeDtypeStruct((BATCH, SIZE, SIZE, SIZE, cin), jnp.float32)
    )["params"]
    params = _draw(template, rng, positive=True)
    label = (rng.random((BATCH, SIZE, SIZE, SIZE)) > 0.6).astype(np.float32)
    image = np.abs(rng.normal(size=label.shape) * 0.5 + label) \
        .astype(np.float32)
    eps = np.abs(rng.normal(size=(BATCH, DIM))).astype(np.float32)
    tx = joptim.sgd(LR)
    state = jsteps.init_state(jax.tree.map(jnp.asarray, params), tx)
    if kind == "vae":
        step = jsteps.make_vae_train_step(jm, tx, NC)
        with jax_eps(eps):
            state, aux = step(state, jnp.asarray(label),
                              jax.random.PRNGKey(5))
    else:
        step = jsteps.make_seg_train_step(jm, tx, NC)
        state, aux = step(state, jnp.asarray(image), jnp.asarray(label))
    p0 = pm.from_jax_params(params)
    want = _jax_gradient(state)
    net = pm.ShapeVAE(n_class=NC, dim=DIM, fmaps=FMAPS, bottleneck=BOTT,
                      dtype=torch.float32, norm_type=3) if kind == "vae" \
        else pm.SegUNet(n_class=NC, fmaps=FMAPS, dtype=torch.float32,
                        norm_type=3)
    net = pm.load_state(net, p0)
    opt = pt.optim.sgd(net.parameters(), LR)
    if kind == "vae":
        with port_eps(eps):
            got_aux = pt.make_vae_train_step(NC)(
                net, opt, torch.from_numpy(label),
                torch.Generator().manual_seed(0))
    else:
        got_aux = pt.make_seg_train_step(NC)(
            net, opt, torch.from_numpy(image), torch.from_numpy(label))
    got = {k: p.grad for k, p in net.named_parameters()}
    return ({k: float(v) for k, v in aux.items()},
            {k: float(v) for k, v in got_aux.items()}, want, got)


@pytest.mark.parametrize("kind", ["vae", "seg"])
def test_norm3_train_step_matches_jax(kind):
    want_aux, got_aux, want, got = _step_case(kind)
    assert want_aux.keys() <= got_aux.keys()
    for k, v in want_aux.items():
        assert got_aux[k] == pytest.approx(v, abs=LOSS_ABS), k
    assert want.keys() == got.keys()
    resolved = 0
    for k in want:
        w, g = want[k].double().ravel(), got[k].double().ravel()
        if not w.any():     # below f32's range in both (the deepest layers)
            assert not g.any(), k
            continue
        resolved += 1
        rel = ((g - w).norm() / w.norm()).item()
        cos = (g @ w / (g.norm() * w.norm())).item()
        assert rel <= GRAD_REL and cos >= GRAD_COS, (k, rel, cos)
    assert resolved >= 0.75 * len(want), resolved



def test_norm3_seg_train_step_under_sp2():
    """GSNorm is voxel-local, so a norm_type 3 SegUNet runs on the D slabs
    of a 'spatial' axis: seg_train at 32^3 under SP2 (two gloo ranks on
    the CPU) on chip_smoke.py's conditioned draw gives one process's loss
    (1e-6; measured equal) and gradients (relative L2 1e-4, or 0 in both
    where they underflow; measured <= 2.4e-6) and the same gradient bits on
    both ranks."""
    import chip_smoke
    import torch_dist_workers as W
    from vae_segmentation_tpu_torch.parallel import launch

    net = pm.SegUNet(n_class=NC, fmaps=FMAPS, dtype=torch.float32,
                     norm_type=3, generator=torch.Generator().manual_seed(3))
    chip_smoke.condition_gsnorm(torch, net, torch.Generator().manual_seed(4))
    rng = np.random.default_rng(23)
    label = (rng.random((BATCH, SIZE, SIZE, SIZE)) > 0.6).astype(np.float32)
    spec = {"kind": "seg", "norm_type": 3, "fmaps": FMAPS, "lr": LR,
            "state": {k: v.detach().numpy()
                      for k, v in net.state_dict().items()},
            "image": np.abs(rng.normal(size=label.shape) * 0.5 + label)
            .astype(np.float32), "label": label}
    one = W.source_step(0, 1, 1, 1, spec)
    ranks = launch.spawn(W.source_step, 2, timeout=120.0,
                         args=(1, 2, spec))
    for r in ranks:
        assert r["aux"]["dice_loss"] == pytest.approx(
            one["aux"]["dice_loss"], abs=1e-6)
    assert ranks[1]["grad_digest"] == ranks[0]["grad_digest"]
    for k, w in one["grads"].items():
        g, w = torch.as_tensor(ranks[0]["grads"][k]).double(), w.double()
        if not w.any():
            assert not g.any(), k
            continue
        assert (g - w).norm() <= 1e-4 * w.norm(), k

if __name__ == "__main__":
    for kind in ("vae", "seg"):
        want_aux, got_aux, want, got = _step_case(kind)
        print(kind, {k: abs(got_aux[k] - v) for k, v in want_aux.items()})
        for k in want:
            print(f"  {k:32s} |g| {want[k].norm().item():.3g} relative L2 "
                  f"{((got[k] - want[k]).norm() / want[k].norm()).item():.3g}")
