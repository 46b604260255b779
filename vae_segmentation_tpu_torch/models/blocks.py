"""Conv building blocks in the logical channels-last representation
[B, D, H, W, C] (counterpart of vae_segmentation_tpu/models/blocks.py).

Structure (reference joint_model.py):
  * ConvNormAct = conv3^3 + InstanceNorm + ReLU               (:101-112)
  * DoubleConv  = 3 x (conv3^3 + InstanceNorm + ReLU)         (:35-52)
  * Down        = stride-2 2^3 conv (channel-preserving) + DoubleConv (:126-136)
  * Up          = stride-2 2^3 ConvTranspose + DoubleConv      (:114-124)

Every 3^3 conv is K1 (``ops.conv3``), every Down entry K2 and every Up entry
K3 (``ops.bridges``). The fusion points are the JAX TPU path's
(blocks.py:954-979, unet.py:92-120, vae.py:116-165): InstanceNorm
statistics come from K1's stats epilogue, an intra-DoubleConv norm+ReLU is
the next conv's prologue, and a deferred stage-final norm (``defer=True``)
rides into the consumer's prologue. Norms that feed a skip-add or a stage
boundary are applied here as plain elementwise ops.

The norm route (``use_pallas_norm``, VAESEG_PALLAS=1, the JAX package's
switch) is the JAX package's logical route with that switch on
(blocks.py:518-534, 886-921, 954-989 with no stats and no fold): every conv
runs K1 with no prologue and no stats epilogue, every norm+ReLU is
``ops.instance_norm.instance_norm_act`` on the stored conv output, and no
affine is deferred (the blocks hand their consumers ``None``).

Parameters keep the reference's torch ``state_dict`` keys and shapes
(models/torch_compat.py:8-28 of the JAX package). On a CUDA device a leaf
module derives the layout its kernel reads (bf16, tap-major) from ``weight``
on every call and keeps no copy, so no write to the weight, however made
(an optimizer step, an EMA update, a load, a write through ``.data``), can
leave a kernel reading old values. The JAX package's space-to-depth fold
and W-pack (ops/s2d.py) are not ported: they only filled the TPU's
128-lane tiles.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from vae_segmentation_tpu_torch.ops import bridges, conv3 as conv3_ops
from vae_segmentation_tpu_torch.ops.instance_norm import (
    affine_from_stats, instance_norm_act)

DEFAULT_FMAPS: Tuple[int, ...] = (8, 16, 32, 64, 128, 256)
Affine = Tuple[torch.Tensor, torch.Tensor]


def torch_uniform_init(shape: Sequence[int], fan_in: int,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)): what torch's default init gives
    conv/linear weights (kaiming_uniform_(a=sqrt(5))) and their biases."""
    bound = 1.0 / math.sqrt(fan_in)
    return torch.empty(tuple(shape)).uniform_(-bound, bound,
                                              generator=generator)


def use_pallas_norm() -> bool:
    """The norm route under VAESEG_PALLAS=1 (the JAX package's
    ``blocks.py::use_pallas_norm``), read on every forward as the JAX
    function is read at trace time."""
    return os.environ.get("VAESEG_PALLAS") == "1"


def apply_affine_relu(x: torch.Tensor, aff: Affine) -> torch.Tensor:
    """relu(x * s + t) in f32, stored in x.dtype: a norm applied where no
    kernel prologue can take it."""
    s, t = aff
    y = torch.relu(x.float() * s[:, None, None, None, :]
                   + t[:, None, None, None, :])
    return y.to(x.dtype)


class _KernelConv(nn.Module):
    """A conv whose ``weight`` is kept in torch layout (for state_dicts and
    the optimizer) and handed to its kernel in the kernel's layout."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)

    @staticmethod
    def kernel_layout(weight: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def kernel_weight(self) -> Optional[torch.Tensor]:
        """The weight in the kernel's layout (None on the CPU), derived
        from ``weight`` as it is now: one small permute-and-cast per call,
        nothing cached, so nothing can go stale."""
        w = self.weight
        return self.kernel_layout(w) if w.is_cuda else None


class Conv3(_KernelConv):
    """3^3 SAME conv (torch Conv3d weight [O, I, 3, 3, 3]) through K1."""

    def __init__(self, cin: int, cout: int,
                 generator: Optional[torch.Generator] = None):
        fan_in = 27 * cin
        super().__init__(torch_uniform_init((cout, cin, 3, 3, 3), fan_in,
                                            generator),
                         torch_uniform_init((cout,), fan_in, generator))

    kernel_layout = staticmethod(conv3_ops.kernel_weight)

    def forward(self, x: torch.Tensor, pre: Optional[Affine] = None,
                stats: bool = False, softmax: bool = False):
        return conv3_ops.conv3(x, self.weight, self.bias,
                               self.kernel_weight(), pre, stats, softmax)


class DownConv(_KernelConv):
    """Channel-preserving 2^3 stride-2 conv (torch Conv3d [C, C, 2, 2, 2])
    through K2."""

    def __init__(self, c: int, generator: Optional[torch.Generator] = None):
        super().__init__(torch_uniform_init((c, c, 2, 2, 2), 8 * c, generator),
                         torch_uniform_init((c,), 8 * c, generator))

    kernel_layout = staticmethod(bridges.down_kernel_weight)

    def forward(self, x: torch.Tensor, pre: Optional[Affine] = None):
        return bridges.down_k2s2(x, self.weight, self.bias,
                                 self.kernel_weight(), pre)


class TConv2(_KernelConv):
    """Channel-preserving 2^3 stride-2 ConvTranspose (torch ConvTranspose3d
    [C, C, 2, 2, 2]) through K3."""

    def __init__(self, c: int, generator: Optional[torch.Generator] = None):
        # torch takes a ConvTranspose's fan_in from weight dim 1: 8 * C_out
        super().__init__(torch_uniform_init((c, c, 2, 2, 2), 8 * c, generator),
                         torch_uniform_init((c,), 8 * c, generator))

    kernel_layout = staticmethod(bridges.up_kernel_weight)

    def forward(self, x: torch.Tensor):
        return bridges.up_k2s2(x, self.weight, self.bias,
                               self.kernel_weight())


def mc_dropout(x: torch.Tensor, rate: float,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """Functional MC dropout, active whenever rate > 0: the semantics of
    torch ``F.dropout(p, training=True)`` as used for decoder and Seg MC
    sampling (joint_model.py:256-264, 379-387; counterpart of the JAX
    package's ``blocks.mc_dropout``). The keep mask is drawn from
    ``generator``, which must live on x's device."""
    if not rate:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _n_spatial(x: torch.Tensor) -> int:
    return x.shape[1] * x.shape[2] * x.shape[3]


class ConvNormAct(nn.Module):
    """conv3^3 + InstanceNorm + ReLU (reference ``Conv``). Returns the raw
    conv output and its norm affine: the norm+ReLU is applied by the
    consumer (the down1 entry's K2 prologue), so the normalized tensor is
    never stored. On the norm route: the normalized output and None."""

    def __init__(self, cin: int, cout: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.ModuleDict({"0": Conv3(cin, cout, generator)})

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[Affine]]:
        if use_pallas_norm():
            return instance_norm_act(self.conv["0"](x)), None
        y, st = self.conv["0"](x, stats=True)
        return y, affine_from_stats(st, _n_spatial(y))


class DoubleConv(nn.Module):
    """3 x (conv3^3 + InstanceNorm + ReLU); the reference's ``DoubleConv``
    is a triple conv. Each norm's affine comes from the conv's stats
    epilogue and each norm+ReLU after the first two convs is the next
    conv's prologue. defer=True returns (raw, affine) for the chain-final
    norm instead of applying it. On the norm route every norm+ReLU is
    ``instance_norm_act`` and defer=True returns (normalized, None)."""

    _KEYS = ("0", "3", "6")  # reference indices (norm/ReLU at 1, 2, 4, ...)

    def __init__(self, cin: int, cout: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.ModuleDict({
            "0": Conv3(cin, cout, generator),
            "3": Conv3(cout, cout, generator),
            "6": Conv3(cout, cout, generator)})

    def forward(self, x: torch.Tensor, defer: bool = False):
        if use_pallas_norm():
            for key in self._KEYS:
                x = instance_norm_act(self.conv[key](x))
            return (x, None) if defer else x
        pre = None
        for key in self._KEYS:
            x, st = self.conv[key](x, pre=pre, stats=True)
            pre = affine_from_stats(st, _n_spatial(x))
        return (x, pre) if defer else apply_affine_relu(x, pre)


class Down(nn.Module):
    """K2 stride-2 conv (channel-preserving) then DoubleConv(cin -> cout).
    pre: the producing stage's deferred norm affine, applied as K2's
    prologue."""

    def __init__(self, cin: int, cout: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.ModuleDict({"0": DownConv(cin, generator),
                                   "1": DoubleConv(cin, cout, generator)})

    def forward(self, x: torch.Tensor, pre: Optional[Affine] = None):
        return self.conv["1"](self.conv["0"](x, pre=pre))


class Up(nn.Module):
    """K3 stride-2 ConvTranspose (channel-preserving) then
    DoubleConv(cin -> cout)."""

    def __init__(self, cin: int, cout: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.ModuleDict({"0": TConv2(cin, generator),
                                   "1": DoubleConv(cin, cout, generator)})

    def forward(self, x: torch.Tensor, defer: bool = False):
        return self.conv["1"](self.conv["0"](x), defer=defer)

