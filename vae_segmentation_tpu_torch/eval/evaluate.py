"""Whole-crop evaluation (counterpart of vae_segmentation_tpu/eval/
evaluate.py::make_vae_eval_step, ::make_seg_eval_step,
::make_joint_eval_step and ::run_eval; reference main_source.py:685-774 and
main_target.py:796-995): one ROI crop per case, binary Dice over classes
[1, n_class), per sample, so any --val_batch keeps the per-case score
contract. The VAE's step scores the reconstruction of the ground-truth
one-hot; the Seg's and the Joint's the Seg prediction."""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch

from vae_segmentation_tpu_torch.ops import losses as L


def _binary_dice(probs, onehot, n_class: int) -> torch.Tensor:
    return L.avg_dsc(probs, onehot, binary=True, botindex=1,
                     topindex=n_class, return_mean=False)


def make_vae_eval_step(model: torch.nn.Module, n_class: int) -> Callable:
    """(label [B, D, H, W]) -> {'recon', 'score' [B]}: the ShapeVAE's
    reconstruction of the GT one-hot with the mean latent
    (evaluate.py:25-34 of the JAX package)."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def step(label) -> Dict[str, torch.Tensor]:
        onehot = L.one_hot_label(torch.as_tensor(label, device=device),
                                 n_class)
        recon = model(onehot)[0]
        return {"recon": recon,
                "score": _binary_dice(recon, onehot, n_class)}

    return step


def make_seg_eval_step(model: torch.nn.Module, n_class: int) -> Callable:
    """(image_norm [B, D, H, W], label [B, D, H, W]) -> {'pred', 'score'
    [B]} of a SegUNet (evaluate.py:37-46 of the JAX package)."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def step(image, label) -> Dict[str, torch.Tensor]:
        image = torch.as_tensor(image, device=device)
        onehot = L.one_hot_label(torch.as_tensor(label, device=device),
                                 n_class)
        pred = model(image[..., None])
        return {"pred": pred, "score": _binary_dice(pred, onehot, n_class)}

    return step


def make_joint_eval_step(model: torch.nn.Module, n_class: int) -> Callable:
    """(image_norm [B, D, H, W], label [B, D, H, W]) -> {'pred', 'recon',
    'score' [B]}, on the model's device."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def step(image, label) -> Dict[str, torch.Tensor]:
        image = torch.as_tensor(image, device=device)
        onehot = L.one_hot_label(torch.as_tensor(label, device=device),
                                 n_class)
        pred, recon, _, _ = model(image[..., None])
        return {"pred": pred, "recon": recon,
                "score": _binary_dice(pred, onehot, n_class)}

    return step


def run_eval(batches: Iterable[Dict], eval_step: Callable, *,
             uses_image: bool = True) -> Tuple[float, Dict[int, float]]:
    """Per-case eval loop over batches carrying 'label', 'index' and, when
    `uses_image`, 'image_norm': (mean Dice, {case index: Dice}). The VAE's
    step reads the label alone (uses_image=False)."""
    scores: Dict[int, float] = {}
    for batch in batches:
        out = eval_step(batch["image_norm"], batch["label"]) if uses_image \
            else eval_step(batch["label"])
        score = out["score"].float().cpu().numpy().reshape(-1)
        for j, vi in enumerate(np.asarray(batch["index"])):
            scores[int(vi)] = float(score[j])
    mean = sum(scores.values()) / max(len(scores), 1)
    return mean, scores
