"""Checkpoints in the reference's layout: ``torch.save`` of
``{'epoch', 'model_state_dict'}`` at ``<save_root>/<prefix>/<name>``
(main_source.py:826-843; core/checkpoint.py:89-92 of the JAX package).
A reference ``.ckpt`` is such a file, so it loads directly. The JAX
package's msgpack checkpoints are not read yet (ROADMAP queue 1)."""

from __future__ import annotations

import os
from typing import Dict

import torch


def checkpoint_path(save_root: str, prefix: str,
                    name: str = "best_model.ckpt") -> str:
    """os.path.join('3dmodel', prefix, name) (main_source.py:301)."""
    return os.path.join(save_root, prefix, name)


def save_checkpoint(path: str, *, epoch: int, model: torch.nn.Module) -> None:
    """Write {'epoch', 'model_state_dict'} atomically (tmp + rename)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    tmp = path + ".tmp"
    torch.save({"epoch": epoch, "model_state_dict": sd}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict:
    """The checkpoint dict, tensors on the CPU (weights_only load)."""
    return torch.load(path, map_location="cpu", weights_only=True)
