"""Carrying weights into the port.

The port's modules use the reference's torch ``state_dict`` keys and
shapes, so a reference ``.ckpt`` loads directly (``load_state``).
``from_jax_params`` turns a JAX param tree of any of the JAX package's
models (nested dicts of numpy arrays: SegUNet, ShapeVAE, ShapeEncoder,
FusionNet, Joint, Joint2, Embed) into such a state_dict: it is the inverse
of vae_segmentation_tpu/models/torch_compat.py::convert_state_dict for
each of its kinds. It also carries what that function does not map: the
BatchNorms of a norm_type 2 tree (``Norm_i/BatchNorm_0``, with the
``batch_stats`` collection when given) and a SegmentationGS tree
(``models/gs.py`` lists its keys).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_DOUBLECONV_IDX = {0: "0", 1: "3", 2: "6"}
_TCONV = ("ConvTranspose_0", "TConv2_0")
# each kind's dense layers whose 16384-wide side is the bottleneck's
# flatten (torch_compat.py:171-172: VAE_FCS, ENCODER_FCS): fc2's output
# side, the others' input side
BOTTLENECK_FCS = {"vae": ("fc_mean", "fc_std", "fc2"), "encoder": ("fc1",),
                  "seg": (), "fusion": (), "segmentation_gs": ()}
# the composites' submodules and their kinds (torch_compat.py:189-210)
COMPOSITES = {"joint": {"Seg": "seg", "Vae": "vae"},
              "joint2": {"Seg": "seg", "Dis": "encoder"},
              "embed": {"Encoder": "encoder", "Vae": "vae",
                        "Fusion": "fusion"}}


# a norm_type 2 block's BatchNorm: the reference's Sequential index of the
# norm after each conv (a ConvNormAct's at 1, a DoubleConv's at 1, 4, 7)
_NORM_IDX = {0: "1", 1: "4", 2: "7"}
# SegmentationGS: its modules' names in the JAX tree (models/gs.py's keys)
_GS_NAMES = {"ConvGS_0": "in_block", "DownGS_0": "down1",
             "DownGS_1": "down2", "DownGS_2": "down3", "ConvGS_1": "fuse",
             "Conv3_0": "out_block"}


def _index(pattern: str, part: str) -> int:
    return int(re.fullmatch(pattern, part).group(1))


def _torch_key(path: Tuple[str, ...]) -> str:
    """JAX module path -> torch key prefix (torch_compat.py:88-106, and a
    norm_type 2 block's ``Norm_i/BatchNorm_0``)."""
    name = path[0]
    if name in ("fc_mean", "fc_std", "fc1", "fc2") or name == "out_block":
        return name
    if path[1] in _TCONV or (path[1] == "Conv3_0" and len(path) == 2):
        return f"{name}.conv.0"
    if path[1:] == ("Norm_0", "BatchNorm_0"):
        return f"{name}.conv.1"
    if path[1] == "DoubleConv_0" and path[2].startswith("Conv3_"):
        i = _index(r"Conv3_(\d)", path[2])
        return f"{name}.conv.1.conv.{_DOUBLECONV_IDX[i]}"
    if path[1] == "DoubleConv_0" and path[3:] == ("BatchNorm_0",):
        i = _index(r"Norm_(\d)", path[2])
        return f"{name}.conv.1.conv.{_NORM_IDX[i]}"
    raise KeyError(f"no torch mapping for JAX path {path}")


def _gs_key(path: Tuple[str, ...]) -> str:
    """SegmentationGS module path -> torch key prefix (``models/gs.py``)."""
    name = _GS_NAMES[path[0]]
    if path[1:] == ():
        return name                                    # the 1^3 head
    if path[1:] == ("Conv3_0",):
        return f"{name}.conv.0"         # ConvGS's conv, DownGS's 2^3 conv
    if path[1] == "DoubleConvGS_0" and len(path) == 3:
        i = _index(r"Conv3_(\d)", path[2])
        return f"{name}.conv.1.conv.{2 * i}"
    raise KeyError(f"no torch mapping for JAX path {path}")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _bottleneck_geometry(params: Mapping, width: int) -> Tuple[int, int]:
    """(channels, side) of the bottleneck: channels = fmaps[5], down5's
    output channels (the last conv of its DoubleConv)."""
    ch = np.asarray(
        params["down5"]["DoubleConv_0"]["Conv3_2"]["kernel"]).shape[-1]
    side = round((width // ch) ** (1.0 / 3.0))
    if ch * side ** 3 != width:
        raise ValueError(f"bottleneck {width} is not {ch} x a cube")
    return ch, side


def kind_of(params: Mapping) -> str:
    """The torch_compat kind of a JAX param tree: a composite by its
    submodules, a single network by the layers only it has."""
    for kind, parts in COMPOSITES.items():
        if set(params) == set(parts):
            return kind
    if any(k in params for k in ("Seg", "Vae", "Dis", "Encoder", "Fusion")):
        raise KeyError("a composite JAX tree holds submodules other than "
                       "Seg and Vae (a Joint), Seg and Dis (a Joint2) or "
                       f"Encoder, Vae and Fusion (an Embed): {sorted(params)}")
    if "ConvGS_0" in params:
        return "segmentation_gs"
    if "fc1" in params:
        return "encoder"
    if "fc_std" in params:
        return "vae"
    return "fusion" if "merge" in params else "seg"


def _running(stats: Optional[Mapping], path: Tuple[str, ...], key: str,
             channels: int) -> Dict[str, np.ndarray]:
    """A BatchNorm's buffers: `stats`' mean and var at its module `path`,
    or flax's initial values (0 and 1) without `stats`; no batch
    counted."""
    node = stats
    if stats is not None:
        for p in path:
            node = node[p]
    out = {}
    for leaf, buf, init in (("mean", "running_mean", np.zeros),
                            ("var", "running_var", np.ones)):
        out[f"{key}.{buf}"] = init(channels, np.float32) if node is None \
            else np.array(node[leaf], np.float32)
    out[f"{key}.num_batches_tracked"] = np.array(0, np.int64)
    return out


def _component(params: Mapping, kind: str,
               stats: Optional[Mapping] = None) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    fcs = BOTTLENECK_FCS[kind]
    for path, w in _leaves(params):
        key = _gs_key(path[:-1]) if kind == "segmentation_gs" \
            else _torch_key(path[:-1])
        leaf, base = path[-1], path[0]
        if leaf == "scale":             # a BatchNorm: weight and buffers
            out[f"{key}.weight"] = np.array(w, np.float32)
            out.update(_running(stats, path[:-1], key, w.shape[0]))
            continue
        bottleneck = base in fcs
        if leaf == "kernel":
            if w.ndim == 5 and path[-2] in _TCONV:
                # flax ConvTranspose taps are torch's flipped
                w = np.transpose(w[::-1, ::-1, ::-1], (3, 4, 0, 1, 2))
            elif w.ndim == 5:
                w = np.transpose(w, (4, 3, 0, 1, 2))
            else:
                w = w.T  # dense [in, out] -> Linear [out, in]
                if bottleneck and base != "fc2":
                    ch, s = _bottleneck_geometry(params, w.shape[1])
                    # JAX flattens (d, h, w, c); torch (c, d, h, w)
                    w = w.reshape(-1, s, s, s, ch).transpose(0, 4, 1, 2, 3) \
                        .reshape(w.shape[0], -1)
                elif bottleneck:
                    ch, s = _bottleneck_geometry(params, w.shape[0])
                    w = w.reshape(s, s, s, ch, -1).transpose(3, 0, 1, 2, 4) \
                        .reshape(w.shape[0], -1)
            out[f"{key}.weight"] = np.array(w, np.float32)
        else:
            if bottleneck and base == "fc2":
                ch, s = _bottleneck_geometry(params, w.shape[0])
                w = w.reshape(s, s, s, ch).transpose(3, 0, 1, 2).reshape(-1)
            out[f"{key}.bias"] = np.array(w, np.float32)
    return out


def from_jax_params(params_np: Mapping[str, Any],
                    batch_stats: Optional[Mapping[str, Any]] = None
                    ) -> Dict[str, torch.Tensor]:
    """JAX param tree -> port/reference torch state_dict: the inverse of
    ``torch_compat.convert_state_dict`` for the tree's kind ('vae', 'seg',
    'encoder', 'fusion', 'joint', 'joint2', 'embed'; read from the tree,
    ``kind_of``), and of the SegmentationGS tree ('segmentation_gs'). A
    composite's keys carry its submodules' prefixes (``Seg.*``, ``Vae.*``,
    ``Dis.*``, ``Encoder.*``, ``Fusion.*``).

    A norm_type 2 tree's BatchNorms (``.../Norm_i/BatchNorm_0/{scale,
    bias}``) become ``weight`` and ``bias``, and `batch_stats` (the flax
    collection of the same structure: ``{mean, var}``) ``running_mean``
    and ``running_var``; ``num_batches_tracked`` is 0. Without
    `batch_stats` the buffers take flax's initial values (0 and 1), which
    is what a JAX checkpoint implies: the JAX package saves params only
    (``core/checkpoint.py:42``)."""
    kind = kind_of(params_np)
    if kind in COMPOSITES:
        parts = COMPOSITES[kind]
        flat = {f"{name}.{k}": v for name, sub_kind in parts.items()
                for k, v in _component(
                    params_np[name], sub_kind,
                    None if batch_stats is None else batch_stats[name]
                ).items()}
    else:
        flat = _component(params_np, kind, batch_stats)
    return {k: torch.from_numpy(v) for k, v in flat.items()}


def _state_dict(state: Any) -> Dict[str, torch.Tensor]:
    """A state_dict, a ``{'model_state_dict': ...}`` checkpoint dict or a
    path to one (either package's file) -> plain {key: tensor} without
    DataParallel's ``module.`` prefix."""
    if isinstance(state, (str, bytes)) or hasattr(state, "__fspath__"):
        # imported here: core.checkpoint imports this module
        from vae_segmentation_tpu_torch.core.checkpoint import load_checkpoint
        state = load_checkpoint(state)
    sd = state.get("model_state_dict", state)
    return {k[len("module."):] if k.startswith("module.") else k:
            torch.as_tensor(v) for k, v in sd.items()}


def load_state(model: torch.nn.Module, state: Any) -> torch.nn.Module:
    """Load a state_dict, a checkpoint dict or a path to one (reference,
    port and JAX package checkpoints alike) into `model`, strictly."""
    model.load_state_dict(_state_dict(state), strict=True)
    return model


def load_network(net: torch.nn.Module, state: Any,
                 name: str) -> torch.nn.Module:
    """Load a bare network `net` (SegUNet, ShapeVAE, ShapeEncoder),
    strictly: from a composite checkpoint its ``<name>.*`` keys ('Seg',
    'Vae', 'Dis', ...), from a checkpoint of that network alone every
    key."""
    sd = _state_dict(state)
    prefix = name + "."
    if any(k.startswith(prefix) for k in sd):
        sd = {k[len(prefix):]: v for k, v in sd.items()
              if k.startswith(prefix)}
    net.load_state_dict(sd, strict=True)
    return net


def load_component(model: torch.nn.Module, state: Any,
                   name: str) -> torch.nn.Module:
    """Load only the submodule `name` ('Seg', 'Vae' or 'Dis') of a
    composite `model` (--load_prefix / --load_prefix_vae /
    --load_prefix_encoder, main_target.py:355-394), as ``load_network``
    does."""
    load_network(getattr(model, name), state, name)
    return model
