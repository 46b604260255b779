"""Carrying weights into the port.

The port's modules use the reference's torch ``state_dict`` keys and
shapes, so a reference ``.ckpt`` loads directly (``load_state``).
``from_jax_params`` turns the JAX package's Joint / SegUNet / ShapeVAE
param tree (nested dicts of numpy arrays) into such a state_dict: it is the
inverse of vae_segmentation_tpu/models/torch_compat.py::convert_state_dict.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_DOUBLECONV_IDX = {0: "0", 1: "3", 2: "6"}
_TCONV = ("ConvTranspose_0", "TConv2_0")


def _torch_key(path: Tuple[str, ...]) -> str:
    """JAX module path -> torch key prefix (torch_compat.py:88-106)."""
    name = path[0]
    if name in ("fc_mean", "fc_std", "fc2") or name == "out_block":
        return name
    if path[1] in _TCONV or (path[1] == "Conv3_0" and len(path) == 2):
        return f"{name}.conv.0"
    if path[1] == "DoubleConv_0":
        i = int(re.match(r"Conv3_(\d)", path[2]).group(1))
        return f"{name}.conv.1.conv.{_DOUBLECONV_IDX[i]}"
    raise KeyError(f"no torch mapping for JAX path {path}")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _bottleneck_geometry(params: Mapping, width: int) -> Tuple[int, int]:
    """(channels, side) of the VAE bottleneck: channels = fmaps[5], read
    from up1's channel-preserving ConvTranspose."""
    ch = np.asarray(params["up1"]["TConv2_0"]["kernel"]).shape[-1]
    side = round((width // ch) ** (1.0 / 3.0))
    if ch * side ** 3 != width:
        raise ValueError(f"bottleneck {width} is not {ch} x a cube")
    return ch, side


def _component(params: Mapping) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for path, w in _leaves(params):
        key = _torch_key(path[:-1])
        kind, base = path[-1], path[0]
        if kind == "kernel":
            if w.ndim == 5 and path[-2] in _TCONV:
                # flax ConvTranspose taps are torch's flipped
                w = np.transpose(w[::-1, ::-1, ::-1], (3, 4, 0, 1, 2))
            elif w.ndim == 5:
                w = np.transpose(w, (4, 3, 0, 1, 2))
            else:
                w = w.T  # dense [in, out] -> Linear [out, in]
                if base in ("fc_mean", "fc_std"):
                    ch, s = _bottleneck_geometry(params, w.shape[1])
                    # JAX flattens (d, h, w, c); torch (c, d, h, w)
                    w = w.reshape(-1, s, s, s, ch).transpose(0, 4, 1, 2, 3) \
                        .reshape(w.shape[0], -1)
                elif base == "fc2":
                    ch, s = _bottleneck_geometry(params, w.shape[0])
                    w = w.reshape(s, s, s, ch, -1).transpose(3, 0, 1, 2, 4) \
                        .reshape(w.shape[0], -1)
            out[f"{key}.weight"] = np.array(w, np.float32)
        else:
            if base == "fc2":
                ch, s = _bottleneck_geometry(params, w.shape[0])
                w = w.reshape(s, s, s, ch).transpose(3, 0, 1, 2).reshape(-1)
            out[f"{key}.bias"] = np.array(w, np.float32)
    return out


def from_jax_params(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX param tree -> port/reference torch state_dict. A tree with
    top-level ``Seg``/``Vae`` is a Joint (keys ``Seg.*``, ``Vae.*``);
    otherwise a single SegUNet or ShapeVAE."""
    parts = {k: params_np[k] for k in ("Seg", "Vae") if k in params_np}
    if parts:
        flat = {f"{name}.{k}": v for name, sub in parts.items()
                for k, v in _component(sub).items()}
    else:
        flat = _component(params_np)
    return {k: torch.from_numpy(v) for k, v in flat.items()}


def _state_dict(state: Any) -> Dict[str, torch.Tensor]:
    """A state_dict, a ``{'model_state_dict': ...}`` checkpoint dict or a
    path to one -> plain {key: tensor} without DataParallel's ``module.``
    prefix."""
    if isinstance(state, (str, bytes)) or hasattr(state, "__fspath__"):
        state = torch.load(state, map_location="cpu", weights_only=True)
    sd = state.get("model_state_dict", state)
    return {k[len("module."):] if k.startswith("module.") else k:
            torch.as_tensor(v) for k, v in sd.items()}


def load_state(model: torch.nn.Module, state: Any) -> torch.nn.Module:
    """Load a state_dict, a checkpoint dict or a path to one (reference and
    port checkpoints alike) into `model`, strictly."""
    model.load_state_dict(_state_dict(state), strict=True)
    return model


def load_network(net: torch.nn.Module, state: Any,
                 name: str) -> torch.nn.Module:
    """Load a bare network `net` (SegUNet or ShapeVAE), strictly: from a
    composite checkpoint its ``<name>.*`` keys ('Seg' or 'Vae'), from a
    checkpoint of that network alone every key."""
    sd = _state_dict(state)
    prefix = name + "."
    if any(k.startswith(prefix) for k in sd):
        sd = {k[len(prefix):]: v for k, v in sd.items()
              if k.startswith(prefix)}
    net.load_state_dict(sd, strict=True)
    return net


def load_component(model: torch.nn.Module, state: Any,
                   name: str) -> torch.nn.Module:
    """Load only the submodule `name` ('Seg' or 'Vae') of a composite
    `model` (--load_prefix / --load_prefix_vae, main_target.py:355-394),
    as ``load_network`` does."""
    load_network(getattr(model, name), state, name)
    return model
