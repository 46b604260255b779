"""Dice metrics on channels-last masks [B, D, H, W, C], reductions in f32.

Counterpart of vae_segmentation_tpu/ops/losses.py (dice, binarize,
onehot_argmax, soft_dice_per_class, avg_dsc, one_hot_label), which mirrors
the reference's utils/evaluation.py:6-80 and main_source.py:150-182,390-392.
The class axis is last; reductions run over every axis but batch and
class.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# eps used by utils/evaluation.py:72-79 (the target-domain trainer)
EVAL_EPS = 1e-6
# eps used by the duplicated copy in main_source.py:174-181 (source trainer)
SOURCE_EPS = 1e-4


def _reduce_dims(x: torch.Tensor):
    return tuple(range(1, x.dim() - 1))


def dice(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Global soft Dice over all elements (utils/evaluation.py:6-7)."""
    a32, b32 = a.float(), b.float()
    return 2.0 * (a32 * b32).sum() / (a32.sum() + b32.sum() + eps)


def binarize(a: torch.Tensor) -> torch.Tensor:
    """Hard threshold at 0.5, keeping the dtype (utils/evaluation.py:9-10)."""
    return (a >= 0.5).to(a.dtype)


def onehot_argmax(probs: torch.Tensor) -> torch.Tensor:
    """Argmax over the class axis (first max on ties, like jnp.argmax),
    re-expanded to one-hot in the input dtype."""
    n_class = probs.shape[-1]
    return F.one_hot(torch.argmax(probs, dim=-1), n_class).to(probs.dtype)


def soft_dice_per_class(source: torch.Tensor, target: torch.Tensor,
                        eps: float = EVAL_EPS) -> torch.Tensor:
    """Per-sample, per-class soft Dice: [B, ..., C] x2 -> [B, C], f32."""
    dims = _reduce_dims(source)
    s32, t32 = source.float(), target.float()
    inter = (s32 * t32).sum(dim=dims)
    denom = s32.sum(dim=dims) + t32.sum(dim=dims)
    return 2.0 * inter / (denom + eps)


def avg_dsc(source: torch.Tensor, target: torch.Tensor, *,
            binary: bool = False, botindex: int = 0, topindex: int = 2,
            return_mean: bool = True, eps: float = EVAL_EPS) -> torch.Tensor:
    """Mean soft Dice over classes [botindex:topindex]
    (utils/evaluation.py:48-80). binary: argmax-one-hot both masks first.
    Scalar if return_mean, else per sample [B]. With C == 1 the class slice
    is skipped, as in the reference."""
    if binary:
        source = onehot_argmax(source)
        target = onehot_argmax(target)
    per_class = soft_dice_per_class(source, target, eps)
    if source.shape[-1] > 1:
        per_class = per_class[:, botindex:topindex]
    if return_mean:
        return per_class.mean()
    return per_class.mean(dim=1)


def one_hot_label(label: torch.Tensor, n_class: int,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Class-valued label volume [B, D, H, W] -> one-hot [B, D, H, W, C]
    (main_source.py:390-392), by float equality as the JAX package does."""
    classes = torch.arange(n_class, dtype=label.dtype, device=label.device)
    return (label[..., None] == classes).to(dtype)
