"""Checkpoints in the reference's layout, with the JAX package's payload
(core/checkpoint.py:41-105 of the JAX package; main_source.py:826-843):

    <save_root>/<prefix>/model_epoch<N>.ckpt   every save_epoch
    <save_root>/<prefix>/best_model.ckpt       on a better mean Dice

``save_checkpoint`` writes ``{'version', 'epoch', 'model_state_dict',
'optimizer_state_dict', 'extra'}`` with ``torch.save`` (tmp + rename).
``load_checkpoint`` takes either package's file: a torch file (a zip, or
the legacy pickle, as the reference's ``.ckpt``) loads with
``torch.load(weights_only=True)``; anything else is read as the JAX
package's msgpack (``core/msgpack.py``), whose param tree
``models/weights.py::from_jax_params`` turns into the torch keys, so
``load_state`` / ``load_component`` / ``load_network`` take it as they
take a torch file. A JAX file's optimizer state stays its raw tree: no
caller restores an optimizer (``--resume`` restores params, epoch and the
best result, as the JAX package does)."""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Optional

import torch

from vae_segmentation_tpu_torch.core import msgpack
from vae_segmentation_tpu_torch.models.weights import from_jax_params

CKPT_VERSION = 1
ZIP_MAGIC = b"PK\x03\x04"
PICKLE_PROTO = b"\x80"   # torch's legacy (non-zip) format starts a pickle


def checkpoint_path(save_root: str, prefix: str,
                    name: str = "best_model.ckpt") -> str:
    """os.path.join('3dmodel', prefix, name) (main_source.py:301)."""
    return os.path.join(save_root, prefix, name)


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str, *, epoch: int, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    extra: Optional[Dict] = None) -> None:
    """Write the JAX package's payload atomically (tmp + rename): the
    model's and the optimizer's state_dicts ({} without an optimizer) on
    the CPU, and `extra` (the trainers store 'best_result')."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "version": CKPT_VERSION,
        "epoch": int(epoch),
        "model_state_dict": _to_cpu(model.state_dict()),
        "optimizer_state_dict": _to_cpu(optimizer.state_dict())
        if optimizer is not None else {},
        "extra": dict(extra or {}),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict:
    """The checkpoint dict of either package's file, tensors on the CPU.
    A JAX file's 'model_state_dict' comes back in the torch keys; a file
    that does not parse whole raises (``msgpack.MsgpackError``)."""
    with open(path, "rb") as f:
        head = f.read(len(ZIP_MAGIC))
    if head == ZIP_MAGIC or head.startswith(PICKLE_PROTO):
        return torch.load(path, map_location="cpu", weights_only=True)
    with open(path, "rb") as f:
        ck = msgpack.unpackb(f.read())
    if not isinstance(ck, dict) or not isinstance(
            ck.get("model_state_dict"), dict) or "epoch" not in ck:
        raise msgpack.MsgpackError(
            f"{path} is not a checkpoint of the JAX package: no "
            "'model_state_dict' and 'epoch'")
    ck["model_state_dict"] = from_jax_params(ck["model_state_dict"])
    ck["epoch"] = int(ck["epoch"])
    return ck


def latest_checkpoint(save_root: str, prefix: str) -> Optional[str]:
    """The model_epoch<N>.ckpt with the largest N under <save_root>/
    <prefix>, or None (core/checkpoint.py:95-105 of the JAX package)."""
    candidates = []
    for p in glob.glob(os.path.join(save_root, prefix, "model_epoch*.ckpt")):
        m = re.search(r"model_epoch(\d+)\.ckpt$", p)
        if m:
            candidates.append((int(m.group(1)), p))
    return max(candidates)[1] if candidates else None
