"""The train steps (counterparts of vae_segmentation_tpu/train/steps.py):
the source-domain steps, ``make_vae_train_step`` (the shape-prior VAE on
ground-truth masks, main_source.py:389-413), ``make_seg_train_step`` (the
supervised SegUNet, main_source.py:415-446) and the Joint's
``make_joint_train_step`` (joint_train), ``make_cached_pseudo_adapt_step``
(the source domain_adaptation) and ``make_sep_joint_train_step``
(sep_joint_train), the adaptation step ``make_adapt_step`` with what it
calls (main_target.py:505-613), the source replay of --pseudo_list
runs, ``make_seg_replay_step``, the discriminator methods'
``make_discriminator_step`` and ``make_adapt_dis_step`` (main_target.py:
494-503, 693-732) and Embed's ``make_embed_train_step`` and
``make_refine_vae_step`` (main_source.py:546-635).

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

Under an active mesh (``parallel.sharding.active``; the JAX package's
sharded steps) every step takes this rank's slice of the batch
(``sharding.batch_shard``), the losses are those of the global batch on
every rank (``ops/losses.py``; the teacher's KL averaged over 'data'), and
before the optimizer's update the trainable gradients are averaged over
the mesh by one fixed-order flat all-reduce (``collectives.mean_grads``;
the gradient convention of ``parallel/collectives.py``), so every rank
applies the same update and the parameters stay equal bit for bit. What
is frozen has no gradient and is never reduced. The detached loss terms
a step returns are already the global batch's.

Within ``checking_terms(check)`` (the CLIs' --debug_nans) every step hands
its scalar loss terms to ``check`` before its backward; outside it nothing
is checked and nothing waits for the card. A step asked for a display
panel (``return_display``) returns it detached, on the device: the
``Saver`` copies it to the host on a display step only.

Every step runs under ``models.blocks.refusing_batch_norm``: a model with
a norm_type 2 (BatchNorm) module raises ValueError, as no step of the JAX
package runs one (it applies ``{"params": p}`` alone); a norm_type 3
(GSNorm) model runs as in the JAX package. So do the evals
(``eval/evaluate.py``, ``eval/sliding_window.py``).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from vae_segmentation_tpu_torch.models.blocks import refusing_batch_norm
from vae_segmentation_tpu_torch.ops import losses as L
from vae_segmentation_tpu_torch.parallel import collectives, sharding


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
    # a [4, D, H] mid-W panel (recon, gt, pred, pseudo; class 1 of sample
    # 0) in the aux dict for the TensorBoard grid (main_target.py:538-541)
    return_display: bool = False


_CHECK_TERMS: Optional[Callable[[Dict[str, torch.Tensor]], None]] = None


@contextlib.contextmanager
def checking_terms(check: Callable[[Dict[str, torch.Tensor]], None]):
    """Within: every step calls ``check({name: scalar loss term})`` before
    its backward (the --debug_nans check of ``cli/common.py::nan_guard``)."""
    global _CHECK_TERMS
    prev, _CHECK_TERMS = _CHECK_TERMS, check
    try:
        yield
    finally:
        _CHECK_TERMS = prev


def _check_terms(**terms) -> None:
    if _CHECK_TERMS is not None:
        _CHECK_TERMS(terms)


def _panel(*views: torch.Tensor) -> torch.Tensor:
    """[N, D, H] f32 display panel of sample 0's mid-W slices of `views`
    (each [B, D, H, W], one class), detached. Under a 'spatial' mesh the
    rank's planes are gathered over its row, so rank 0's panel is the
    whole volume's."""
    with torch.no_grad():
        w2 = views[0].shape[3] // 2
        panel = torch.stack([v[0, :, :, w2].float() for v in views])
        mesh = sharding.spatial_mesh(views[0])
        if mesh is not None:
            panel = collectives.gather_spatial(panel, mesh)
    return panel


def _update(optimizer: torch.optim.Optimizer) -> None:
    """optimizer.step(), after the mesh's gradient mean when one is
    active."""
    mesh = sharding.current()
    if mesh is not None:
        collectives.mean_grads(
            [p for g in optimizer.param_groups for p in g["params"]], mesh)
    optimizer.step()


def _global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of a rank's slice `x` over the global batch's volume."""
    mesh = sharding.current()
    if mesh is None:
        return x.mean()
    total, n = x.sum(), x.numel() * mesh.n_data
    if sharding.spatial_mesh(x) is not None:
        total, n = collectives.spatial_sum(total, mesh), n * mesh.n_spatial
    return collectives.data_sum(total, mesh) / n


def make_vae_train_step(n_class: int, *, scale: float = 0.35,
                        kl_weight: float = 2e-5, eps: float = L.SOURCE_EPS,
                        return_display: bool = False) -> Callable:
    """The VAE shape-prior step (main_source.py:389-413; steps.py:142-188 of
    the JAX package with its fused reparam path):

        step(model, optimizer, label, generator) -> aux

    loss = (1 - avg_dsc(recon, onehot) over classes [1, n_class)) + kl_weight
    * KL, the latent sampled at reparam `scale` by ``ShapeVAE.
    reparameterize`` (one ``reparam_kl`` call: the kernel on the card, its
    seed drawn from ``generator``, which lives on the label's device).
    label [B, D, H, W] holds class values; the optimizer updates the
    ShapeVAE `model` in place; aux holds the detached 'dice_loss' and
    'kl_loss', and with return_display the reference's train panel
    'display' [gt class 0, gt class 1, recon class 1] (main_source.py:
    394-396)."""

    @refusing_batch_norm()
    def step(model, optimizer, label, generator):
        onehot = L.one_hot_label(label, n_class)
        optimizer.zero_grad(set_to_none=True)
        mean, std = model.encode(onehot)
        latent, klv = model.reparameterize(mean, std, scale, generator)
        recon = model.decode(latent)
        dsc_loss = 1.0 - L.avg_dsc(recon, onehot, botindex=1,
                                   topindex=n_class, eps=eps)
        _check_terms(dice_loss=dsc_loss, kl_loss=klv)
        (dsc_loss + kl_weight * klv).backward()
        _update(optimizer)
        aux = {"dice_loss": dsc_loss.detach(), "kl_loss": klv.detach()}
        if return_display:
            aux["display"] = _panel(onehot[..., 0], onehot[..., 1],
                                    recon[..., 1])
        return aux

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

    @refusing_batch_norm()
    def step(model, optimizer, image, label):
        img = image if image.dim() == 5 else image[..., None]
        onehot = L.one_hot_label(label, n_class)
        optimizer.zero_grad(set_to_none=True)
        pred = model(img)
        dsc_loss = 1.0 - L.avg_dsc(pred, onehot, botindex=1,
                                   topindex=n_class, eps=eps)
        _check_terms(dice_loss=dsc_loss)
        dsc_loss.backward()
        _update(optimizer)
        return {"dice_loss": dsc_loss.detach()}

    return step


def make_seg_replay_step(n_class: int, *, eps: float = L.SOURCE_EPS
                         ) -> Callable:
    """The source-replay step of --pseudo_list runs (main_target.py:
    668-691; steps.py:213-244 of the JAX package, on the logical model):

        step(student, optimizer, image, label) -> {'dice_loss'}

    loss = 1 - avg_dsc(student.segment(image), onehot) over classes
    [1, n_class) on a labelled source batch, its sums taken by one
    ``dice_sums`` pass (``multi_soft_dice``: avg_dsc's formula, its VJP on
    the card too); the gradient goes into the student's Seg through the
    adaptation step's optimizer (what it froze stays frozen; the VAE takes
    no part in the loss)."""

    @refusing_batch_norm()
    def step(student, optimizer, image, label):
        img = image if image.dim() == 5 else image[..., None]
        onehot = L.one_hot_label(label, n_class)
        optimizer.zero_grad(set_to_none=True)
        pred = student.segment(img)
        dsc = L.multi_soft_dice(pred, (onehot,), eps=eps)[0]
        dsc_loss = 1.0 - dsc[:, 1:n_class].mean()
        _check_terms(dice_loss=dsc_loss)
        dsc_loss.backward()
        _update(optimizer)
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
    display = None
    for _ in range(cfg.vae_mont_number):
        pred, recon, _, _ = model(img, dropout=True, generator=generator)
        d_pr, d_ps, d_po = L.multi_soft_dice(
            pred, (recon, pseudo, onehot), eps=L.EVAL_EPS)
        recon_loss = 1.0 - d_pr[:, 1:n].mean()
        fake_loss = 1.0 - d_ps[:, 1:n].mean()
        dsc_loss = 1.0 - d_po[:, 1:n].mean()
        pred_sq = _global_mean(pred.float().square()) \
            if cfg.domain_loss_type == 10 else 0.0
        final = adapt_loss(recon_loss, fake_loss, klv, pred_sq, cfg, sched,
                           variant=variant)
        tot_recon = tot_recon + recon_loss
        tot_fake = tot_fake + fake_loss
        tot_dsc = tot_dsc + dsc_loss
        tot_final = tot_final + final
        if cfg.return_display:   # the last MC draw's, as the JAX package
            display = _panel(recon[..., 1], onehot[..., 1], pred[..., 1],
                             pseudo[..., 1])
    m = cfg.vae_mont_number
    aux = {"recon_loss": tot_recon / m, "dice_loss_fake": tot_fake / m,
           "dice_loss": tot_dsc / m}
    if display is not None:
        aux["display"] = display
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
    'final_loss' and 'kl_loss' (and 'display' with ``cfg.return_display``).
    Gradients flow through the frozen student VAE into the student Seg; the
    teacher runs without gradients."""

    @refusing_batch_norm()
    def step(student, teacher, optimizer, image, label, generator, sched):
        img = image if image.dim() == 5 else image[..., None]
        onehot = L.one_hot_label(label, cfg.n_class)
        t_pred, t_mean, t_std = _teacher_forward(teacher, img, cfg.kl)
        pseudo = L.confident_binarize(t_pred) if cfg.use_confident_binarize \
            else L.binarize(t_pred)
        klv = torch.zeros((), device=img.device)
        if cfg.kl:
            klv = L.kl_loss(t_mean, t_std)
            mesh = sharding.current()
            if mesh is not None:
                klv = collectives.data_mean(klv, mesh)
        optimizer.zero_grad(set_to_none=True)
        final, aux = _student_mc_losses(student, img, onehot, pseudo, klv,
                                        cfg, sched, generator,
                                        variant=variant)
        _check_terms(**{k: v for k, v in aux.items() if k != "display"},
                     final_loss=final, kl_loss=klv)
        final.backward()
        _update(optimizer)
        aux = {k: v.detach() for k, v in aux.items()}
        aux["final_loss"] = final.detach()
        aux["kl_loss"] = klv
        return aux

    return step


def _class_mean(dsc: torch.Tensor, n_class: int) -> torch.Tensor:
    """Per-sample mean [B] of a [B, C] Dice over classes [1, n_class)."""
    return dsc[:, 1:n_class].mean(dim=1)


def make_joint_train_step(n_class: int, *, eps: float = L.SOURCE_EPS
                          ) -> Callable:
    """joint_train (main_source.py:448-478; steps.py:247-276 of the JAX
    package):

        step(model, optimizer, image, label, sched) -> aux

    loss = lambda_vae * (1 - dsc(pred, recon)) + (1 - dsc(pred, onehot))
    over classes [1, n_class) of the Joint `model`'s forward (no dropout),
    both Dices from one ``dice_sums`` pass; the gradient reaches the Seg
    directly and through the VAE (frozen by the optimizer's parameters).
    aux holds the detached 'recon_loss' and 'dice_loss'."""

    @refusing_batch_norm()
    def step(model, optimizer, image, label, sched):
        img = image if image.dim() == 5 else image[..., None]
        onehot = L.one_hot_label(label, n_class)
        optimizer.zero_grad(set_to_none=True)
        pred, recon, _, _ = model(img)
        d_pr, d_po = L.multi_soft_dice(pred, (recon, onehot), eps=eps)
        recon_loss = 1.0 - d_pr[:, 1:n_class].mean()
        dsc_loss = 1.0 - d_po[:, 1:n_class].mean()
        _check_terms(recon_loss=recon_loss, dice_loss=dsc_loss)
        (sched["lambda_vae"] * recon_loss + dsc_loss).backward()
        _update(optimizer)
        return {"recon_loss": recon_loss.detach(),
                "dice_loss": dsc_loss.detach()}

    return step


def make_cached_pseudo_adapt_step(cfg: AdaptConfig, *,
                                  eps: float = L.SOURCE_EPS) -> Callable:
    """The source CLI's domain_adaptation (main_source.py:480-544;
    steps.py:507-546 of the JAX package): the pseudo-label is a cached
    prediction, passed in, and the loss takes only the turn / warmup
    schedule (no dh types):

        step(model, optimizer, image, label, pseudo, sched) -> aux

    pseudo [B, D, H, W, n_class] (the cache's f32 holds bf16 values: cast
    to the prediction's dtype without loss); the three Dices of the Joint's
    prediction (against its reconstruction, the pseudo-label and the
    one-hot label) from one ``dice_sums`` pass; with ``cfg.turn_enabled``
    phase 0 trains on 2 lambda recon alone, else warmup * lambda * recon +
    fake. aux holds the detached 'recon_loss', 'dice_loss_fake',
    'dice_loss', 'final_loss' and 'pred' (this rank's slice; the CLI's
    --mode refresh writes it to the cache)."""
    n = cfg.n_class

    @refusing_batch_norm()
    def step(model, optimizer, image, label, pseudo, sched):
        img = image if image.dim() == 5 else image[..., None]
        onehot = L.one_hot_label(label, n)
        optimizer.zero_grad(set_to_none=True)
        pred, recon, _, _ = model(img)
        d_pr, d_ps, d_po = L.multi_soft_dice(
            pred, (recon, pseudo.to(pred.dtype), onehot), eps=eps)
        recon_loss = 1.0 - d_pr[:, 1:n].mean()
        fake_loss = 1.0 - d_ps[:, 1:n].mean()
        dsc_loss = 1.0 - d_po[:, 1:n].mean()
        lam = sched["lambda_vae"]
        if cfg.turn_enabled and sched["turn_phase"] == 0:
            final = 2.0 * lam * recon_loss      # main_source.py:527-531
        elif cfg.turn_enabled:
            final = lam * recon_loss + fake_loss
        else:                                   # main_source.py:532-535
            final = sched["warmup_scale"] * lam * recon_loss + fake_loss
        _check_terms(recon_loss=recon_loss, dice_loss_fake=fake_loss,
                     dice_loss=dsc_loss, final_loss=final)
        final.backward()
        _update(optimizer)
        return {"recon_loss": recon_loss.detach(),
                "dice_loss_fake": fake_loss.detach(),
                "dice_loss": dsc_loss.detach(), "final_loss": final.detach(),
                "pred": pred.detach()}

    return step


def make_sep_joint_train_step(n_class: int) -> Callable:
    """sep_joint_train (main_source.py:631-658; steps.py:661-690 of the JAX
    package): a student Joint and a frozen teacher Joint, per-sample Dice
    over classes [1, n_class):

        step(model, teacher, optimizer, image) -> aux

    final = 0.1 (1 - mean recon_dsc) + 1 - mean(dsc * recon_tea^2), with
    recon_dsc = dsc(pred, recon) and dsc = dsc(pred, pred_tea) from one
    ``dice_sums`` pass over the student's prediction, and recon_tea =
    dsc(pred_tea, recon_tea) of the teacher's forward, without gradient.
    The means run over the global batch (the Dices of ``multi_soft_dice``
    are the global batch's under a mesh). aux holds the detached
    'recon_loss' (1 - mean recon_dsc), 'dice_loss' (1 - mean dsc) and
    'final_loss'."""

    @refusing_batch_norm()
    def step(model, teacher, optimizer, image):
        img = image if image.dim() == 5 else image[..., None]
        with torch.no_grad():
            t_pred, t_recon, _, _ = teacher(img)
            recon_tea = _class_mean(L.multi_soft_dice(t_pred, (t_recon,))[0],
                                    n_class)
        optimizer.zero_grad(set_to_none=True)
        pred, recon, _, _ = model(img)
        d_pr, d_pt = L.multi_soft_dice(pred, (recon, t_pred))
        recon_dsc = _class_mean(d_pr, n_class)
        dsc = _class_mean(d_pt, n_class)
        recon_loss = 1.0 - recon_dsc.mean()
        final = 0.1 * recon_loss + 1.0 - (dsc * recon_tea.square()).mean()
        _check_terms(recon_loss=recon_loss, dice_loss=1.0 - dsc.mean(),
                     final_loss=final)
        final.backward()
        _update(optimizer)
        return {"recon_loss": recon_loss.detach(),
                "dice_loss": 1.0 - dsc.detach().mean(),
                "final_loss": final.detach()}

    return step


def _batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the global batch of a per-sample tensor `x` [B, ...]
    (a score or a latent, whole on every rank of a data row)."""
    mesh = sharding.current()
    return x.mean() if mesh is None else collectives.data_mean(x.mean(),
                                                               mesh)


def _dice_loss(x: torch.Tensor, onehot: torch.Tensor,
               n_class: int) -> torch.Tensor:
    """1 - the mean soft Dice of x against the one-hot label over classes
    [1, n_class), its sums from one ``dice_sums`` pass."""
    return 1.0 - L.multi_soft_dice(x, (onehot,))[0][:, 1:n_class].mean()


def make_discriminator_step() -> Callable:
    """discriminator_train (main_target.py:494-503; steps.py:693-707 of the
    JAX package):

        step(model, optimizer, mask, score) -> aux

    loss = mean((score - model(mask)[:, 0])^2) in f32, the ShapeEncoder's
    sigmoid score of the float mask [B, D, H, W] against the target score
    [B] of each case. aux holds the detached 'final_loss' and
    'score_out' [B]."""

    @refusing_batch_norm()
    def step(model, optimizer, mask, score):
        optimizer.zero_grad(set_to_none=True)
        out = model(mask[..., None].float())[:, 0]
        final = _batch_mean((score.float() - out).square())
        _check_terms(final_loss=final)
        final.backward()
        _update(optimizer)
        return {"final_loss": final.detach(), "score_out": out.detach()}

    return step


def make_adapt_dis_step(cfg: AdaptConfig) -> Callable:
    """domain_adaptation_dis (main_target.py:693-732; steps.py:710-743 of
    the JAX package): the discriminator's realism score in place of the
    VAE's reconstruction loss,

        step(student, teacher_seg, optimizer, image, label, generator,
             sched) -> aux

    a frozen teacher SegUNet's binarized (confident with
    ``cfg.use_confident_binarize``) pseudo-label, the Joint2 student's
    forward with the Seg's MC dropout drawn from ``generator``, and loss =
    warmup_scale * lambda_vae * (1 - mean score) + (1 - dsc(pred,
    pseudo)); the two Dices from one ``dice_sums`` pass. The Dis is frozen
    by the optimizer's parameters, its gradient flows through it into the
    Seg. aux holds the detached 'discriminator_loss', 'dice_loss_fake',
    'dice_loss' and 'final_loss'."""
    n = cfg.n_class

    @refusing_batch_norm()
    def step(student, teacher_seg, optimizer, image, label, generator,
             sched):
        img = image if image.dim() == 5 else image[..., None]
        onehot = L.one_hot_label(label, n)
        with torch.no_grad():
            t_pred = teacher_seg(img)
        pseudo = L.confident_binarize(t_pred) if cfg.use_confident_binarize \
            else L.binarize(t_pred)
        optimizer.zero_grad(set_to_none=True)
        pred, score = student(img, dropout=True, generator=generator)
        d_ps, d_po = L.multi_soft_dice(pred, (pseudo, onehot))
        fake_loss = 1.0 - d_ps[:, 1:n].mean()
        dsc_loss = 1.0 - d_po[:, 1:n].mean()
        dis_loss = 1.0 - _batch_mean(score)
        final = sched["warmup_scale"] * sched["lambda_vae"] * dis_loss \
            + fake_loss
        _check_terms(discriminator_loss=dis_loss, dice_loss_fake=fake_loss,
                     dice_loss=dsc_loss, final_loss=final)
        final.backward()
        _update(optimizer)
        return {"discriminator_loss": dis_loss.detach(),
                "dice_loss_fake": fake_loss.detach(),
                "dice_loss": dsc_loss.detach(), "final_loss": final.detach()}

    return step


def make_embed_train_step(n_class: int) -> Callable:
    """embed_train (main_source.py:546-589; steps.py:584-628 of the JAX
    package):

        step(model, optimizer, image, label, generator, enc_on) -> aux

    the Embed `model`'s test-mode forward (the gt branch's latent drawn
    from a seed out of ``generator``) and

        final = (d1 + d2 + inpaint) / 3 + mse / 10 + 2e-5 KL + recon

    with d1, d2, inpaint, recon the 1 - Dice losses of pred, init_seg,
    seg_recon and gt_recon against the one-hot label (one ``dice_sums``
    pass each), mse the mean squared distance of the Encoder's latent to
    the gt branch's mean latent and KL that of the gt branch's (mean,
    std). The Encoder's gradient is multiplied by `enc_on` (0 or 1: the
    JAX package's traced epoch-parity switch, so on an off epoch the
    Encoder's momentum still decays, where the reference skips it); the
    VAE is frozen by the optimizer's parameters. aux holds the detached
    terms 'dice_loss1', 'dice_loss2', 'mse_loss', 'inpaint_loss',
    'recon_loss', 'kl_loss' and 'final_loss'."""

    @refusing_batch_norm()
    def step(model, optimizer, image, label, generator, enc_on):
        img = image if image.dim() == 5 else image[..., None]
        onehot = L.one_hot_label(label, n_class)
        optimizer.zero_grad(set_to_none=True)
        out = model(img, onehot, test_mode=True, generator=generator)
        d1 = _dice_loss(out["pred"], onehot, n_class)
        d2 = _dice_loss(out["init_seg"], onehot, n_class)
        inpaint = _dice_loss(out["seg_recon"], onehot, n_class)
        recon = _dice_loss(out["gt_recon"], onehot, n_class)
        klv = out["kl"]
        mse = _batch_mean((out["latent_code"]
                           - out["latent_code_gt"]).square())
        final = (d1 + d2 + inpaint) / 3.0 + mse / 10.0 + 2e-5 * klv + recon
        terms = {"dice_loss1": d1, "dice_loss2": d2, "mse_loss": mse,
                 "inpaint_loss": inpaint, "recon_loss": recon,
                 "kl_loss": klv}
        _check_terms(**terms, final_loss=final)
        final.backward()
        for p in model.Encoder.parameters():
            if p.grad is not None:
                p.grad.mul_(enc_on)
        _update(optimizer)
        aux = {k: v.detach() for k, v in terms.items()}
        aux["final_loss"] = final.detach()
        return aux

    return step


def make_refine_vae_step(n_class: int) -> Callable:
    """refine_vae (main_source.py:592-635; steps.py:631-660 of the JAX
    package):

        step(model, optimizer, image, label, generator) -> aux

    the Embed `model`'s test-mode forward and final = inpaint + 2e-5 KL +
    recon (as ``make_embed_train_step``'s terms); 'init_loss', the
    init_seg's, is reported only. The VAE's encoder half is frozen by
    the optimizer's parameters (``optim.freeze_vae_encoder``). aux holds
    the detached 'recon_loss', 'inpaint_loss', 'init_loss', 'kl_loss' and
    'final_loss'."""

    @refusing_batch_norm()
    def step(model, optimizer, image, label, generator):
        img = image if image.dim() == 5 else image[..., None]
        onehot = L.one_hot_label(label, n_class)
        optimizer.zero_grad(set_to_none=True)
        out = model(img, onehot, test_mode=True, generator=generator)
        recon = _dice_loss(out["gt_recon"], onehot, n_class)
        inpaint = _dice_loss(out["seg_recon"], onehot, n_class)
        with torch.no_grad():
            init_loss = _dice_loss(out["init_seg"], onehot, n_class)
        klv = out["kl"]
        final = inpaint + 2e-5 * klv + recon
        terms = {"recon_loss": recon, "inpaint_loss": inpaint,
                 "init_loss": init_loss, "kl_loss": klv}
        _check_terms(**terms, final_loss=final)
        final.backward()
        _update(optimizer)
        aux = {k: v.detach() for k, v in terms.items()}
        aux["final_loss"] = final.detach()
        return aux

    return step
