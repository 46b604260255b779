"""Joint whole-crop evaluation (counterpart of vae_segmentation_tpu/eval/
evaluate.py::make_joint_eval_step and ::run_eval; reference
main_target.py:796-995): one ROI crop per case, binary Dice of the Seg
prediction against the GT one-hot over classes [1, n_class), per sample, so
any --val_batch keeps the per-case score contract."""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch

from vae_segmentation_tpu_torch.ops import losses as L


def make_joint_eval_step(model: torch.nn.Module, n_class: int) -> Callable:
    """(image_norm [B, D, H, W], label [B, D, H, W]) -> {'pred', 'recon',
    'score' [B]}, on the model's device."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def step(image, label) -> Dict[str, torch.Tensor]:
        image = torch.as_tensor(image, device=device)
        label = torch.as_tensor(label, device=device)
        onehot = L.one_hot_label(label, n_class)
        pred, recon, _, _ = model(image[..., None])
        score = L.avg_dsc(pred, onehot, binary=True, botindex=1,
                          topindex=n_class, return_mean=False)
        return {"pred": pred, "recon": recon, "score": score}

    return step


def run_eval(batches: Iterable[Dict], eval_step: Callable
             ) -> Tuple[float, Dict[int, float]]:
    """Per-case eval loop over batches carrying 'image_norm', 'label' and
    'index': (mean Dice, {case index: Dice})."""
    scores: Dict[int, float] = {}
    for batch in batches:
        out = eval_step(batch["image_norm"], batch["label"])
        score = out["score"].float().cpu().numpy().reshape(-1)
        for j, vi in enumerate(np.asarray(batch["index"])):
            scores[int(vi)] = float(score[j])
    mean = sum(scores.values()) / max(len(scores), 1)
    return mean, scores
