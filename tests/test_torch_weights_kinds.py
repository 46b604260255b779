"""``models/weights.py::from_jax_params`` for every kind of
vae_segmentation_tpu/models/torch_compat.py::convert_state_dict ('vae',
'seg', 'encoder', 'fusion', 'joint', 'joint2', 'embed'): at the flagship
widths (fmaps 8-256, 128^3, bottleneck 16384, where convert_state_dict's
fixed 256 x 4^3 bottleneck geometry holds) its keys and shapes are the port
model's state_dict and it inverts convert_state_dict exactly, both ways;
the kind is read from the tree. Then the JAX package's own msgpack files
of a Joint2 and an Embed, written by its ``save_checkpoint`` at 64^3 with
narrow widths (the bottleneck geometry from down5's channels, 32 x 2^3),
load into the port (``core/checkpoint.py``) weight for weight, and the
Embed's forward agrees with the JAX package's (Joint2's is held by
tests/test_torch_encoder_models.py): probabilities 2e-3 abs and latents
5e-4 of their largest value (tests/test_torch_models.py's LIMITS_64), the
gt branch's eps injected into both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_embed_steps import jax_eps, port_eps
from test_torch_train import _draw_params
from vae_segmentation_tpu.core import checkpoint as jckpt
from vae_segmentation_tpu.models import Embed as JEmbed
from vae_segmentation_tpu.models import FusionNet as JFusion
from vae_segmentation_tpu.models import Joint as JJoint
from vae_segmentation_tpu.models import Joint2 as JJoint2
from vae_segmentation_tpu.models import SegUNet as JSeg
from vae_segmentation_tpu.models import ShapeEncoder as JEnc
from vae_segmentation_tpu.models import ShapeVAE as JVae
from vae_segmentation_tpu.models.torch_compat import convert_state_dict
from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch.core import checkpoint as ckpt
from vae_segmentation_tpu_torch.models.weights import kind_of

torch.set_num_threads(2)

# kind -> (JAX model, port model, the inputs' channels) at the flagship
# widths
FLAGSHIP = {
    "vae": (lambda: JVae(n_class=2, dim=128), lambda: pm.ShapeVAE(), (2,)),
    "seg": (lambda: JSeg(n_class=2), lambda: pm.SegUNet(), (1,)),
    "encoder": (lambda: JEnc(dim=1), lambda: pm.ShapeEncoder(dim=1), (1,)),
    "fusion": (lambda: JFusion(n_class=2), lambda: pm.FusionNet(), (1, 2)),
    "joint": (lambda: JJoint(n_class=2, dim=128), lambda: pm.Joint(), (1,)),
    "joint2": (lambda: JJoint2(n_class=2), lambda: pm.Joint2(), (1,)),
    "embed": (lambda: JEmbed(n_class=2, dim=128), lambda: pm.Embed(),
              (1, 2)),
}


def _template(model, channels, size):
    return jax.eval_shape(
        lambda *v: model.init({"params": jax.random.PRNGKey(0),
                               "reparam": jax.random.PRNGKey(1)}, *v),
        *[jax.ShapeDtypeStruct((1, size, size, size, c), jnp.float32)
          for c in channels])["params"]


def _flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.mark.parametrize("kind", sorted(FLAGSHIP))
def test_from_jax_params_inverts_convert_state_dict(kind):
    jmodel, pmodel, channels = FLAGSHIP[kind]
    template = _template(jmodel(), channels, 128)
    rng = np.random.default_rng(len(kind))
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape, dtype=np.float32), template)
    assert kind_of(params) == kind
    sd = pm.from_jax_params(params)
    port = pmodel()
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in port.state_dict().items()}
    pm.load_state(port, sd)     # strict: every key present and used
    back = _flat(convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                    params, kind))
    for path, leaf in _flat(params).items():
        np.testing.assert_array_equal(np.asarray(back[path]), leaf,
                                      err_msg=str(path))
    # and the other way: torch state_dict -> JAX -> torch
    sd2 = {k: torch.from_numpy(rng.standard_normal(v.shape, dtype=np.float32))
           for k, v in sd.items()}
    again = pm.from_jax_params(convert_state_dict(
        {k: v.numpy() for k, v in sd2.items()}, params, kind))
    assert again.keys() == sd2.keys()
    assert all(torch.equal(again[k], sd2[k]) for k in sd2)


FMAPS = (4, 8, 8, 16, 16, 32)
SIZE, DIM = 64, 16
BOTT = FMAPS[5] * (SIZE // 32) ** 3


def _narrow(kind):
    if kind == "joint2":
        return (JJoint2(n_class=2, fmaps=FMAPS, bottleneck=BOTT,
                        dtype=jnp.float32),
                pm.Joint2(fmaps=FMAPS, bottleneck=BOTT, dtype=torch.float32))
    return (JEmbed(n_class=2, dim=DIM, fmaps=FMAPS, bottleneck=BOTT,
                   dtype=jnp.float32),
            pm.Embed(dim=DIM, fmaps=FMAPS, bottleneck=BOTT,
                     dtype=torch.float32))


@pytest.mark.parametrize("kind", ["joint2", "embed"])
def test_jax_msgpack_file_loads_into_the_port(tmp_path, kind):
    jm, port = _narrow(kind)
    rng = np.random.default_rng(7)
    channels = (1,) if kind == "joint2" else (1, 2)
    params = _draw_params(_template(jm, channels, SIZE), rng)
    path = str(tmp_path / "3dmodel" / kind / "best_model.ckpt")
    jckpt.save_checkpoint(path, epoch=3, params=params,
                          extra={"best_result": 0.5})
    ck = ckpt.load_checkpoint(path)
    assert ck["epoch"] == 3
    pm.load_state(port, ck)
    sd = pm.from_jax_params(params)
    assert all(torch.equal(port.state_dict()[k], v) for k, v in sd.items())

    if kind == "joint2":
        return      # its forward: tests/test_torch_encoder_models.py
    image = (rng.normal(size=(2, SIZE, SIZE, SIZE, 1)) * 0.5) \
        .astype(np.float32)
    label = (rng.random((2, SIZE, SIZE, SIZE)) > 0.6).astype(np.int64)
    onehot = np.eye(2, dtype=np.float32)[label]
    eps = rng.normal(size=(2, DIM)).astype(np.float32)
    with jax_eps(eps):
        want = jm.apply({"params": params}, jnp.asarray(image),
                        jnp.asarray(onehot), test_mode=True,
                        rngs={"reparam": jax.random.PRNGKey(0)})
    with port_eps(eps), torch.no_grad():
        got = port(torch.from_numpy(image), torch.from_numpy(onehot),
                   test_mode=True, generator=torch.Generator().manual_seed(0))
    assert set(want) == set(got) - {"kl"}
    for k, w in want.items():
        w, g = np.asarray(w), got[k].numpy()
        err = np.abs(g - w).max()
        if k.startswith("latent"):
            assert err <= 5e-4 * np.abs(w).max(), (k, err)
        else:
            assert err <= 2e-3, (k, err)
