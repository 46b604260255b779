"""The train steps (counterparts of vae_segmentation_tpu/train/steps.py):
the two source-domain steps, ``make_vae_train_step`` (the shape-prior VAE
on ground-truth masks, main_source.py:389-413) and ``make_seg_train_step``
(the supervised SegUNet, main_source.py:415-446), and the adaptation step
``make_adapt_step`` with what it calls (main_target.py:505-613).

One adaptation step: the teacher's Seg forward without gradients (plus its
VAE encode for the KL term), a binarized pseudo-label, the student Joint
forward with MC dropout, three soft Dices of the student's prediction (against the VAE
reconstruction, the pseudo-label and the one-hot label) from one fused
``dice_sums`` pass, the ``adapt_loss`` dispatch over ``domain_loss_type``,
backward through the hand-written kernels, and the optimizer's update of
whatever ``train.optim`` left trainable.

Every step is a plain eager callable. Scalars that change between epochs
(lambda_vae with its --tag decay, the warmup ramp, the turn phase) travel
in the ``sched`` dict; the loss arithmetic stays on the device
(``torch.where``, no ``.item()``), so a step never waits for the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from vae_segmentation_tpu_torch.ops import losses as L


@dataclass(frozen=True)
class AdaptConfig:
    """Static switches of the adaptation loss (argparse flags)."""

    n_class: int = 2
    domain_loss_type: int = 0          # --domain_loss_type
    only_pseudo: bool = False          # --only_pseudo
    use_confident_binarize: bool = False  # --use_confident_binarize
    kl: bool = False                   # --kl
    vae_mont_number: int = 1           # --vae_mont_number
    turn_enabled: bool = False         # --turn_epoch != -1
    kl_weight: float = 2e-5


def make_vae_train_step(n_class: int, *, scale: float = 0.35,
                        kl_weight: float = 2e-5,
                        eps: float = L.SOURCE_EPS) -> Callable:
    """The VAE shape-prior step (main_source.py:389-413; steps.py:142-188 of
    the JAX package with its fused reparam path):

        step(model, optimizer, label, generator) -> aux

    loss = (1 - avg_dsc(recon, onehot) over classes [1, n_class)) + kl_weight
    * KL, the latent sampled at reparam `scale` by ``ShapeVAE.
    reparameterize`` (one ``reparam_kl`` call: the kernel on the card, its
    seed drawn from ``generator``, which lives on the label's device).
    label [B, D, H, W] holds class values; the optimizer updates the
    ShapeVAE `model` in place; aux holds the detached 'dice_loss' and
    'kl_loss'."""

    def step(model, optimizer, label, generator):
        onehot = L.one_hot_label(label, n_class)
        optimizer.zero_grad(set_to_none=True)
        mean, std = model.encode(onehot)
        latent, klv = model.reparameterize(mean, std, scale, generator)
        recon = model.decode(latent)
        dsc_loss = 1.0 - L.avg_dsc(recon, onehot, botindex=1,
                                   topindex=n_class, eps=eps)
        (dsc_loss + kl_weight * klv).backward()
        optimizer.step()
        return {"dice_loss": dsc_loss.detach(), "kl_loss": klv.detach()}

    return step


def make_seg_train_step(n_class: int, *, eps: float = L.SOURCE_EPS
                        ) -> Callable:
    """The supervised segmentation step (main_source.py:415-446;
    steps.py:191-210 of the JAX package):

        step(model, optimizer, image, label) -> aux

    loss = 1 - avg_dsc(pred, onehot) over classes [1, n_class); image
    [B, D, H, W] (normalized) or [B, D, H, W, 1], label class values; the
    optimizer updates the SegUNet `model` in place; aux holds the detached
    'dice_loss'."""

    def step(model, optimizer, image, label):
        img = image if image.dim() == 5 else image[..., None]
        onehot = L.one_hot_label(label, n_class)
        optimizer.zero_grad(set_to_none=True)
        pred = model(img)
        dsc_loss = 1.0 - L.avg_dsc(pred, onehot, botindex=1,
                                   topindex=n_class, eps=eps)
        dsc_loss.backward()
        optimizer.step()
        return {"dice_loss": dsc_loss.detach()}

    return step


def default_sched(lambda_vae: float) -> Dict[str, float]:
    return {
        "lambda_vae": float(lambda_vae),
        "warmup_scale": 1.0,   # epoch / warmup clamp, 1 == past warmup
        "turn_phase": 1,       # 1 -> recon + pseudo, 0 -> recon only
    }


def _bucket_lambda(recon_loss: torch.Tensor, lambda_vae) -> torch.Tensor:
    """dh bucketing (main_target.py:551-554): factor 0.6 / 1.2 / 2.0 / 3.0
    at recon-loss thresholds .15 / .225 / .3."""
    def const(v):
        return torch.full_like(recon_loss, v)

    factor = torch.where(recon_loss < 0.15, const(0.6),
                         torch.where(recon_loss < 0.225, const(1.2),
                                     torch.where(recon_loss < 0.3,
                                                 const(2.0), const(3.0))))
    return lambda_vae * factor


def adapt_loss(recon_loss, fake_loss, klv, pred_sq_mean, cfg: AdaptConfig,
               sched: Dict, *, variant: str = "train"):
    """The full domain_loss_type dispatch.

    variant='train'    -> main_target.py:548-592
    variant='finetune' -> main_target.py:835-884 (ft1 path; differs at loss
                          types 12, 13, 15)
    variant='pseudo'   -> main_target.py:642-653 (--pseudo_list branch:
                          only type 8 [un-normalized], the lambda>=1000
                          recon-only mode, and the plain default)
    """
    lam = sched["lambda_vae"]
    t = cfg.domain_loss_type
    if cfg.only_pseudo:
        return fake_loss
    if variant == "pseudo":
        if t == 8:
            cur = _bucket_lambda(recon_loss, lam)
            return torch.where(cur > 1.0,
                               recon_loss + fake_loss / cur,
                               cur * recon_loss + fake_loss)
        if lam >= 1000.0:
            return recon_loss * lam / 10000.0
        return lam * recon_loss + fake_loss
    if (variant == "train" and t in (8, 15, 16)) or \
       (variant == "finetune" and t == 8):
        cur = _bucket_lambda(recon_loss, lam)
        if cfg.kl:
            hi = recon_loss + klv + fake_loss / cur
            lo = cur * (recon_loss + klv) + fake_loss
        else:
            hi = recon_loss + fake_loss / cur
            lo = cur * recon_loss + fake_loss
        return torch.where(cur > 1.0, hi, lo)
    if t == 9:
        cur = _bucket_lambda(recon_loss, lam)
        return (cur * recon_loss + fake_loss) / (1.0 + cur)
    if t == 10:
        # the ft1-path semantics (main_target.py:854-856), as the JAX
        # package: the train-path copy at :567-569 is a NameError
        return pred_sq_mean + recon_loss + fake_loss
    if t == 11:
        return lam * recon_loss + fake_loss + recon_loss * fake_loss
    if t == 12:
        if variant == "finetune":  # main_target.py:860-861
            return lam * recon_loss + fake_loss \
                + (1.0 - recon_loss) * (1.0 - fake_loss)
        return lam * recon_loss + fake_loss - recon_loss * fake_loss
    if t == 13:
        return lam * torch.clamp(recon_loss - 0.15, min=0.0)
    if t == 14:
        return lam * torch.clamp(recon_loss - 0.1, min=0.0) + fake_loss
    if variant == "finetune" and t == 15:  # main_target.py:870-875
        return lam * torch.clamp(recon_loss - 0.1, min=0.0) \
            + torch.clamp(fake_loss - 0.1, min=0.0)
    if cfg.turn_enabled:
        # (epoch // turn_epoch) % 2: phase 0 -> recon only
        # (main_target.py:583-587)
        if sched["turn_phase"] == 0:
            return lam * recon_loss
        return lam * recon_loss + fake_loss
    # default: warmup ramp then lambda * recon + pseudo
    # (main_target.py:588-592); with --kl (type 0), + 2e-5 * lambda * KL
    # once past warmup
    base = sched["warmup_scale"] * lam * recon_loss + fake_loss
    if cfg.kl and variant == "train" and sched["warmup_scale"] >= 1.0:
        base = base + cfg.kl_weight * lam * klv
    return base


def _teacher_forward(teacher, img: torch.Tensor, need_kl: bool
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                Optional[torch.Tensor]]:
    """Teacher inference without gradients: Seg only, plus the VAE encode
    of the teacher's own prediction when the KL term is on (the reference's
    full teacher VAE decode is never used, main_target.py:532)."""
    with torch.no_grad():
        t_pred = teacher.segment(img)
        t_mean = t_std = None
        if need_kl:
            t_mean, t_std = teacher.encode_pred(t_pred)
    return t_pred, t_mean, t_std


def _student_mc_losses(model, img, onehot, pseudo, klv, cfg: AdaptConfig,
                       sched, generator, *, variant: str):
    """MC loop over vae_mont_number student forwards
    (main_target.py:530-603); each draws its dropout masks from
    ``generator``."""
    n = cfg.n_class
    tot_recon = tot_fake = tot_dsc = tot_final = 0.0
    for _ in range(cfg.vae_mont_number):
        pred, recon, _, _ = model(img, dropout=True, generator=generator)
        d_pr, d_ps, d_po = L.multi_soft_dice(
            pred, (recon, pseudo, onehot), eps=L.EVAL_EPS)
        recon_loss = 1.0 - d_pr[:, 1:n].mean()
        fake_loss = 1.0 - d_ps[:, 1:n].mean()
        dsc_loss = 1.0 - d_po[:, 1:n].mean()
        pred_sq = pred.float().square().mean() \
            if cfg.domain_loss_type == 10 else 0.0
        final = adapt_loss(recon_loss, fake_loss, klv, pred_sq, cfg, sched,
                           variant=variant)
        tot_recon = tot_recon + recon_loss
        tot_fake = tot_fake + fake_loss
        tot_dsc = tot_dsc + dsc_loss
        tot_final = tot_final + final
    m = cfg.vae_mont_number
    aux = {"recon_loss": tot_recon / m, "dice_loss_fake": tot_fake / m,
           "dice_loss": tot_dsc / m}
    return tot_final / m, aux


def make_adapt_step(cfg: AdaptConfig, *, variant: str = "train") -> Callable:
    """The teacher-student adaptation step (main_target.py:505-613):

        step(student, teacher, optimizer, image, label, generator, sched)
            -> aux

    image [B, D, H, W] (normalized) or [B, D, H, W, 1]; label [B, D, H, W]
    class values; ``generator`` feeds the MC dropout and lives on the
    image's device; ``sched`` as ``default_sched``. The student's trainable
    parameters are updated in place by ``optimizer``; ``aux`` holds the
    detached scalars 'recon_loss', 'dice_loss_fake', 'dice_loss',
    'final_loss' and 'kl_loss'. Gradients flow through the frozen student
    VAE into the student Seg; the teacher runs without gradients."""

    def step(student, teacher, optimizer, image, label, generator, sched):
        img = image if image.dim() == 5 else image[..., None]
        onehot = L.one_hot_label(label, cfg.n_class)
        t_pred, t_mean, t_std = _teacher_forward(teacher, img, cfg.kl)
        pseudo = L.confident_binarize(t_pred) if cfg.use_confident_binarize \
            else L.binarize(t_pred)
        klv = L.kl_loss(t_mean, t_std) if cfg.kl \
            else torch.zeros((), device=img.device)
        optimizer.zero_grad(set_to_none=True)
        final, aux = _student_mc_losses(student, img, onehot, pseudo, klv,
                                        cfg, sched, generator,
                                        variant=variant)
        final.backward()
        optimizer.step()
        aux = {k: v.detach() for k, v in aux.items()}
        aux["final_loss"] = final.detach()
        aux["kl_loss"] = klv
        return aux

    return step
