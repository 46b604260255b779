"""EMA teacher update and parameter copy, in place on the device
(counterpart of vae_segmentation_tpu/train/ema.py; reference
main_target.py:508-518, 427-428)."""

from __future__ import annotations

import torch


@torch.no_grad()
def ema_update_seg(teacher: torch.nn.Module, student: torch.nn.Module,
                   alpha: float = 0.995) -> None:
    """teacher.Seg <- alpha * teacher.Seg + (1 - alpha) * student.Seg, in
    place; the teacher's VAE is left untouched (main_target.py:512-516).
    A bare SegUNet teacher (domain_adaptation_dis's) is its own Seg."""
    seg = getattr(teacher, "Seg", teacher)
    for t, s in zip(seg.parameters(), student.Seg.parameters()):
        t.mul_(alpha).add_(s.detach(), alpha=1.0 - alpha)


@torch.no_grad()
def copy_params(dst: torch.nn.Module, src: torch.nn.Module) -> None:
    """dst <- src for every parameter and buffer, in place
    (model_fix.load_state_dict(model.state_dict()))."""
    dst.load_state_dict(src.state_dict(), strict=True)
