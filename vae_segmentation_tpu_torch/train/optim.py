"""Optimizers and parameter freezing (counterpart of
vae_segmentation_tpu/train/optim.py).

The reference freezes a module by setting ``requires_grad=False``
(main_target.py:396-406); gradients still flow THROUGH a frozen module into
a trainable one (through the frozen VAE into the Seg, joint_model.py:450).
The port does the same: a ``freeze_*`` function sets ``requires_grad`` on
the model and returns the parameters left to train, and the kernels'
backwards skip every weight gradient that is not required (the JAX package
reaches the same saving with ``stop_gradient_frozen``).
"""

from __future__ import annotations

from typing import Callable, Iterable, List

import torch


def sgd(params: Iterable[torch.nn.Parameter], lr: float,
        momentum: float = 0.9, weight_decay: float = 0.0
        ) -> torch.optim.Optimizer:
    """torch.optim.SGD (main_source.py:279-280): buf = m * buf + g,
    p -= lr * buf, which the JAX package's ``optim.sgd`` reproduces."""
    return torch.optim.SGD(list(params), lr=lr, momentum=momentum,
                           weight_decay=weight_decay)


def adam(params: Iterable[torch.nn.Parameter], lr: float, b1: float = 0.9,
         b2: float = 0.999, weight_decay: float = 0.0
         ) -> torch.optim.Optimizer:
    """torch.optim.Adam (main_target.py:347-349); eps 1e-8 as optax's."""
    return torch.optim.Adam(list(params), lr=lr, betas=(b1, b2), eps=1e-8,
                            weight_decay=weight_decay)


def freeze_by_name(model: torch.nn.Module,
                   is_frozen: Callable[[str], bool]
                   ) -> List[torch.nn.Parameter]:
    """Set requires_grad = not is_frozen(name) on every parameter of
    `model`; returns the trainable ones, in ``named_parameters`` order."""
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(not is_frozen(name))
        if p.requires_grad:
            trainable.append(p)
    return trainable


def freeze_vae(model: torch.nn.Module) -> List[torch.nn.Parameter]:
    """Adaptation default: VAE frozen, Seg trainable
    (main_target.py:396-399)."""
    return freeze_by_name(model, lambda name: name.startswith("Vae."))


def freeze_all_but_seg_head(model: torch.nn.Module
                            ) -> List[torch.nn.Parameter]:
    """--fix_layer: only Seg.up5 and Seg.out_block train
    (main_target.py:400-406); the VAE stays frozen too."""
    return freeze_by_name(
        model, lambda name: not name.startswith(("Seg.up5.",
                                                 "Seg.out_block.")))


def build(params: Iterable[torch.nn.Parameter], adam_flag: bool, lr: float,
          weight_decay: float = 0.0, momentum: float = 0.9
          ) -> torch.optim.Optimizer:
    """The trainers' optimizer switch (main_target.py:347-352)."""
    return adam(params, lr, weight_decay=weight_decay) if adam_flag \
        else sgd(params, lr, momentum=momentum, weight_decay=weight_decay)
