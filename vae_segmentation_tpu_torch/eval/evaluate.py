"""Whole-crop evaluation (counterpart of vae_segmentation_tpu/eval/
evaluate.py::make_vae_eval_step, ::make_seg_eval_step,
::make_joint_eval_step, ::make_embed_eval_step (as make_seg_eval_step),
::make_analysis_metrics_step and ::run_eval, and of cli/target_main.py::
make_joint2_eval and the discriminator's val; reference
main_source.py:685-774 and main_target.py:796-995): one ROI crop per
case, binary Dice over classes [1, n_class), per sample, so any
--val_batch keeps the per-case score contract. The VAE's step scores the
reconstruction of the ground-truth one-hot; the Seg's, the Joint's and
the Joint2's the Seg prediction, Embed's the Fusion's test-mode
prediction; the discriminator's step scores 1 - the squared error of its
score of the label against the case's target score."""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch

from vae_segmentation_tpu_torch.models.blocks import refusing_batch_norm
from vae_segmentation_tpu_torch.ops import losses as L


def _binary_dice(probs, onehot, n_class: int) -> torch.Tensor:
    return L.avg_dsc(probs, onehot, binary=True, botindex=1,
                     topindex=n_class, return_mean=False)


def make_vae_eval_step(model: torch.nn.Module, n_class: int) -> Callable:
    """(label [B, D, H, W]) -> {'recon', 'score' [B]}: the ShapeVAE's
    reconstruction of the GT one-hot with the mean latent
    (evaluate.py:25-34 of the JAX package)."""
    device = next(model.parameters()).device

    @refusing_batch_norm()
    @torch.no_grad()
    def step(label) -> Dict[str, torch.Tensor]:
        onehot = L.one_hot_label(torch.as_tensor(label, device=device),
                                 n_class)
        recon = model(onehot)[0]
        return {"recon": recon,
                "score": _binary_dice(recon, onehot, n_class)}

    return step


def make_seg_eval_step(segment: Callable, n_class: int) -> Callable:
    """(image_norm [B, D, H, W], label [B, D, H, W]) -> {'pred', 'score'
    [B]} of `segment`, a network or a bound method mapping an image
    [B, D, H, W, 1] to class probabilities: a SegUNet (evaluate.py:37-46
    of the JAX package), a Joint2's Seg (cli/target_main.py:597-607, whose
    mean score is the per-case one at its --val_batch 1) or
    ``Embed.segment``, the Fusion's test-mode prediction that
    evaluate.py:70-85 scores (the gt branch it also runs does not reach
    that score)."""
    owner = getattr(segment, "__self__", segment)
    device = next(owner.parameters()).device

    @refusing_batch_norm()
    @torch.no_grad()
    def step(image, label) -> Dict[str, torch.Tensor]:
        image = torch.as_tensor(image, device=device)
        onehot = L.one_hot_label(torch.as_tensor(label, device=device),
                                 n_class)
        pred = segment(image[..., None])
        return {"pred": pred, "score": _binary_dice(pred, onehot, n_class)}

    return step


def make_joint_eval_step(model: torch.nn.Module, n_class: int, *,
                         with_gt_recon: bool = False) -> Callable:
    """(image_norm [B, D, H, W], label [B, D, H, W]) -> {'pred', 'recon',
    'score' [B]}, on the model's device (evaluate.py:49-67 of the JAX
    package). with_gt_recon adds 'gt_recon': the VAE's reconstruction of
    the GT one-hot with the mean latent."""
    device = next(model.parameters()).device

    @refusing_batch_norm()
    @torch.no_grad()
    def step(image, label) -> Dict[str, torch.Tensor]:
        image = torch.as_tensor(image, device=device)
        onehot = L.one_hot_label(torch.as_tensor(label, device=device),
                                 n_class)
        pred, recon, _, _ = model(image[..., None])
        out = {"pred": pred, "recon": recon,
               "score": _binary_dice(pred, onehot, n_class)}
        if with_gt_recon:
            out["gt_recon"] = model.vae_forward(onehot)[0]
        return out

    return step


def make_discriminator_eval_step(model: torch.nn.Module) -> Callable:
    """(label, target score [B]) -> {'score' [B]}: 1 - (target - the
    ShapeEncoder's score of the label)^2 per case (cli/target_main.py:
    395-405 of the JAX package)."""
    device = next(model.parameters()).device

    @refusing_batch_norm()
    @torch.no_grad()
    def step(label, target) -> Dict[str, torch.Tensor]:
        label = torch.as_tensor(label, device=device)
        out = model(label[..., None].float())[:, 0]
        target = torch.as_tensor(target, device=device)
        return {"score": 1.0 - (target.float() - out).square()}

    return step


def make_analysis_metrics_step(model: torch.nn.Module,
                               teacher: torch.nn.Module,
                               n_class: int) -> Callable:
    """The --analysis_figure_name metric set (main_target.py:956-976;
    evaluate.py:88-114 of the JAX package): (image_norm, label) -> seven
    per-sample [B] values, the pseudo-loss / recon-loss pairs of the
    student's prediction, of the GT and of the teacher's pseudo label
    (``fake``, the teacher Joint's prediction; its reconstruction
    ``fake_recon``). 'score', 'gt_recon_loss' and 'recon_loss' are binary
    Dices, the rest soft."""
    device = next(model.parameters()).device

    def dsc(a, b, binary=False):
        return L.avg_dsc(a, b, binary=binary, botindex=1, topindex=n_class,
                         return_mean=False)

    @refusing_batch_norm()
    @torch.no_grad()
    def step(image, label) -> Dict[str, torch.Tensor]:
        img = torch.as_tensor(image, device=device)[..., None]
        onehot = L.one_hot_label(torch.as_tensor(label, device=device),
                                 n_class)
        pred, recon, _, _ = model(img)
        gt_recon = model.vae_forward(onehot)[0]
        fake, fake_recon, _, _ = teacher(img)
        return {
            "score": dsc(pred, onehot, True),
            "gt_recon_loss": 1 - dsc(gt_recon, onehot, True),
            "gt_dsc_loss_fake": 1 - dsc(fake, onehot),
            "recon_loss": 1 - dsc(pred, recon, True),
            "dsc_loss_fake": 1 - dsc(pred, fake),
            "pseudo_recon_loss": 1 - dsc(fake, fake_recon),
            "pseudo_dsc_loss_fake": 1 - dsc(fake, fake),
        }

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
        record_scores(scores, out["score"], batch["index"])
    return mean_score(scores), scores


def record_scores(scores: Dict[int, float], score: torch.Tensor,
                  index) -> None:
    """scores[case index] = the sample's Dice, for each sample of a batch
    (score [B], index [B])."""
    score = score.float().cpu().numpy().reshape(-1)
    for j, vi in enumerate(np.asarray(index)):
        scores[int(vi)] = float(score[j])


def mean_score(scores: Dict[int, float]) -> float:
    return sum(scores.values()) / max(len(scores), 1)
