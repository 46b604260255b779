"""The group-sum ("GS") conv variants and the multi-scale GS segmentation
head (reference joint_model.py:17-33, 54-99, 140-202, 307-346; counterpart
of vae_segmentation_tpu/models/gs.py). No recipe of either package trains
them; they are part of the model zoo.

The reparametrised convs keep their parameter ``weight`` in torch's layout
(Conv3d [O, I, k...], ConvTranspose3d [I, O, k...]) and derive the weight
they convolve with from it in f32 on every call (``gs_normalize_weight``:
|w| over its sum in each input-channel group; ``SConv3d``: w less its
spatial mean); gradients reach ``weight`` through that derivation by
autograd. The conv itself goes by shape:
  * 3^3, stride 1, SAME: K1 (``ops.conv3``) on the derived weight;
  * 2^3, stride 2, VALID: K2 (``ops.bridges.down_k2s2``), and the
    transposed 2^3 stride-2 conv K3 (``up_k2s2``), with a zero bias where
    the module has none;
  * any other kernel, stride or padding, which the JAX modules also accept
    and compute with XLA: ``F.conv3d`` / ``F.conv_transpose3d`` in f32 on
    the weight rounded to the compute dtype. This is chosen by shape alone,
    never on a failure: a CUDA tensor at a kernel's shape launches that
    kernel or raises.

``ConvGS``, ``DoubleConvGS``, ``DownGS`` and ``UpGS`` are the conv + act
blocks with no norm (``blocks.Conv3``: K1; ``blocks.DownConv``: K2);
``UpGS`` and ``SegmentationGS`` upsample with ``F.interpolate(mode=
"trilinear", align_corners=False)`` in f32, which matches
``jax.image.resize(..., "trilinear")`` at the volume's edges too (JAX drops
the taps outside the volume and renormalizes; torch clamps the source
coordinate). The trilinear resize does not run under a 'spatial' mesh.

Keys. The reference's source of these modules is not in the repository, so
the port's keys follow the JAX param tree, in the blocks' idiom (a conv at
its Sequential index, the activation after it):
  * a bare conv: ``weight``, ``bias`` (``kernel``, ``bias`` in JAX);
  * ConvGS: ``conv.0.*`` (``Conv3_0``);
  * DoubleConvGS: ``conv.0.*``, ``conv.2.*`` (``Conv3_0``, ``Conv3_1``);
  * DownGS: ``conv.0.*`` (the 2^3 conv, ``Conv3_0``), ``conv.1.conv.{0,2}.*``
    (``DoubleConvGS_0``); UpGS: ``conv.1.conv.{0,2}.*``;
  * SegmentationGS: ``in_block`` (``ConvGS_0``), ``down1``-``down3``
    (``DownGS_0``-``DownGS_2``), ``fuse`` (``ConvGS_1``), ``out_block`` (the
    1^3 head, top-level ``Conv3_0``).
``models/weights.py::from_jax_params`` carries a SegmentationGS tree.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from vae_segmentation_tpu_torch.models.blocks import (
    DEFAULT_FMAPS, Conv3, DownConv, gs_norm, torch_uniform_init)
from vae_segmentation_tpu_torch.ops import bridges, conv3 as conv3_ops
from vae_segmentation_tpu_torch.parallel import sharding

Triple = Tuple[int, int, int]
Padding = Union[str, Sequence[Tuple[int, int]]]


def gs_normalize_weight(weight: torch.Tensor, num_group: int,
                        transpose: bool = False) -> torch.Tensor:
    """|w| over its sum in each of `num_group` input-channel groups, per
    tap and output channel, in f32 (the JAX package's
    ``gs._gs_normalize_kernel``, joint_model.py:153-159). `weight` is a
    Conv3d weight [O, I, k...], or with `transpose` a ConvTranspose3d
    weight [I, O, k...]."""
    k = weight.float().abs()
    if transpose:
        k = k.transpose(0, 1)
    o, i = k.shape[:2]
    g = k.reshape(o, num_group, i // num_group, *k.shape[2:])
    k = (g / g.sum(dim=2, keepdim=True)).reshape(k.shape)
    return k.transpose(0, 1) if transpose else k


def _triple(v) -> Triple:
    return tuple(int(a) for a in v) if isinstance(v, (tuple, list)) \
        else (int(v),) * 3


def pads_of(padding: Padding, spatial: Sequence[int], kernel: Triple,
            stride: Triple) -> Tuple[Tuple[int, int], ...]:
    """(lo, hi) pads of each spatial dim as ``jax.lax.conv_general_dilated``
    takes `padding`: "VALID", "SAME" (total max((ceil(n / s) - 1) * s + k
    - n, 0), the smaller half low) or explicit pairs."""
    if isinstance(padding, str):
        if padding == "VALID":
            return ((0, 0),) * 3
        if padding != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        out = []
        for n, k, s in zip(spatial, kernel, stride):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    return tuple((int(lo), int(hi)) for lo, hi in padding)


def _zeros_bias(bias: Optional[torch.Tensor], cout: int,
                ref: torch.Tensor) -> torch.Tensor:
    if bias is not None:
        return bias
    return torch.zeros(cout, dtype=torch.float32, device=ref.device)


def conv_gs(x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor], kernel: Triple, stride: Triple,
            padding: Padding) -> torch.Tensor:
    """The conv of a reparametrised module on [B, D, H, W, Cin] with the
    derived Conv3d `weight`, by shape: K1, K2, or ``F.conv3d`` (see the
    module's note); y in x.dtype."""
    pads = pads_of(padding, x.shape[1:4], kernel, stride)
    cout = weight.shape[0]
    if kernel == (3, 3, 3) and stride == (1, 1, 1) and pads == ((1, 1),) * 3:
        kw = conv3_ops.kernel_weight(weight) if x.is_cuda else None
        return conv3_ops.conv3(x, weight, _zeros_bias(bias, cout, x), kw)
    if kernel == (2, 2, 2) and stride == (2, 2, 2) and pads == ((0, 0),) * 3:
        kw = bridges.down_kernel_weight(weight) if x.is_cuda else None
        return bridges.down_k2s2(x, weight, _zeros_bias(bias, cout, x), kw)
    xin = F.pad(x.float().permute(0, 4, 1, 2, 3),
                [p for pair in reversed(pads) for p in pair])
    y = F.conv3d(xin, weight.to(x.dtype).float(),
                 None if bias is None else bias.float(), stride=stride)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


class GSConv3d(nn.Module):
    """Conv whose weight is |w| normalized to sum 1 over each input-channel
    group (joint_model.py:140-161; the JAX package's ``GSConv3d``)."""

    def __init__(self, cin: int, cout: int, num_group: int = 1,
                 kernel: Sequence[int] = (3, 3, 3),
                 stride: Sequence[int] = (1, 1, 1), padding: Padding = "SAME",
                 bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_group = num_group
        self.kernel, self.stride = _triple(kernel), _triple(stride)
        self.padding = padding
        fan_in = math.prod(self.kernel) * cin
        self.weight = nn.Parameter(torch_uniform_init(
            (cout, cin, *self.kernel), fan_in, generator))
        self.bias = nn.Parameter(torch_uniform_init((cout,), fan_in,
                                                    generator)) \
            if bias else None

    def derived_weight(self) -> torch.Tensor:
        return gs_normalize_weight(self.weight, self.num_group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_gs(x, self.derived_weight(), self.bias, self.kernel,
                       self.stride, self.padding)


class SConv3d(nn.Module):
    """Conv whose weight is w less its mean over the taps
    (joint_model.py:186-202; the JAX package's ``SConv3d``)."""

    def __init__(self, cin: int, cout: int,
                 kernel: Sequence[int] = (3, 3, 3),
                 stride: Sequence[int] = (1, 1, 1), padding: Padding = "SAME",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel, self.stride = _triple(kernel), _triple(stride)
        self.padding = padding
        fan_in = math.prod(self.kernel) * cin
        self.weight = nn.Parameter(torch_uniform_init(
            (cout, cin, *self.kernel), fan_in, generator))
        self.bias = nn.Parameter(torch_uniform_init((cout,), fan_in,
                                                    generator))

    def derived_weight(self) -> torch.Tensor:
        w = self.weight.float()
        return w - w.mean(dim=(2, 3, 4), keepdim=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_gs(x, self.derived_weight(), self.bias, self.kernel,
                       self.stride, self.padding)


class GSConvTranspose3d(nn.Module):
    """Transposed conv with the group-abs-normalized weight
    (joint_model.py:164-185; the JAX package's ``GSConvTranspose3d``,
    ``lax.conv_transpose`` with VALID padding: torch's ConvTranspose3d with
    the taps flipped, and ``output_padding`` s - k where the kernel is
    smaller than the stride). 2^3 stride 2 runs K3."""

    def __init__(self, cin: int, cout: int, num_group: int = 1,
                 kernel: Sequence[int] = (2, 2, 2),
                 stride: Sequence[int] = (2, 2, 2), bias: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_group = num_group
        self.kernel, self.stride = _triple(kernel), _triple(stride)
        # torch takes a ConvTranspose's fan_in from weight dim 1 (the JAX
        # package's "transpose" init); the bias bound is 8 * Cin there
        self.weight = nn.Parameter(torch_uniform_init(
            (cin, cout, *self.kernel), math.prod(self.kernel) * cout,
            generator))
        self.bias = nn.Parameter(torch_uniform_init((cout,), 8 * cin,
                                                    generator)) \
            if bias else None

    def derived_weight(self) -> torch.Tensor:
        return gs_normalize_weight(self.weight, self.num_group,
                                   transpose=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.derived_weight()
        cout = w.shape[1]
        if self.kernel == (2, 2, 2) and self.stride == (2, 2, 2):
            kw = bridges.up_kernel_weight(w) if x.is_cuda else None
            return bridges.up_k2s2(x, w, _zeros_bias(self.bias, cout, x), kw)
        extra = tuple(max(s - k, 0) for k, s in zip(self.kernel,
                                                     self.stride))
        y = F.conv_transpose3d(
            x.float().permute(0, 4, 1, 2, 3), w.to(x.dtype).float(),
            None if self.bias is None else self.bias.float(),
            stride=self.stride, output_padding=extra)
        return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def _act(y: torch.Tensor, soft: bool) -> torch.Tensor:
    z = F.softplus(y.float()).to(y.dtype) if soft \
        else torch.relu(y)
    return sharding.like(z, y)


def upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Trilinear resize of [B, D, H, W, C] by `factor` on each spatial dim
    (``jax.image.resize(..., "trilinear")``), in f32, stored in x.dtype."""
    if sharding.spatial_mesh(x) is not None:
        raise ValueError("the GS models' trilinear resize does not run "
                         "under a 'spatial' mesh")
    size = tuple(factor * n for n in x.shape[1:4])
    y = F.interpolate(x.float().permute(0, 4, 1, 2, 3), size=size,
                      mode="trilinear", align_corners=False)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


class ConvGS(nn.Module):
    """3^3 conv (K1) + act, no norm (joint_model.py:90-99)."""

    def __init__(self, cin: int, cout: int, soft: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.soft = soft
        self.conv = nn.ModuleDict({"0": Conv3(cin, cout, generator)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _act(self.conv["0"](x), self.soft)


class DoubleConvGS(nn.Module):
    """2 x (3^3 conv + act) (joint_model.py:54-66: the GS family's double
    conv really is two)."""

    def __init__(self, cin: int, cout: int, soft: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.soft = soft
        self.conv = nn.ModuleDict({"0": Conv3(cin, cout, generator),
                                   "2": Conv3(cout, cout, generator)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for key in ("0", "2"):
            x = _act(self.conv[key](x), self.soft)
        return x


class DownGS(nn.Module):
    """Channel-preserving 2^3 stride-2 conv (K2) then DoubleConvGS
    (joint_model.py:78-88)."""

    def __init__(self, cin: int, cout: int, soft: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.ModuleDict({
            "0": DownConv(cin, generator),
            "1": DoubleConvGS(cin, cout, soft, generator)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv["1"](self.conv["0"](x))


class UpGS(nn.Module):
    """Trilinear 2x upsample then DoubleConvGS (joint_model.py:67-77)."""

    def __init__(self, cin: int, cout: int, soft: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.ModuleDict({
            "1": DoubleConvGS(cin, cout, soft, generator)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv["1"](upsample(x, 2))


class Conv1(nn.Module):
    """1^3 conv (Conv3d weight [O, I, 1, 1, 1]) as a channel matmul in f32
    on the weight rounded to the compute dtype: the logits."""

    def __init__(self, cin: int, cout: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch_uniform_init((cout, cin, 1, 1, 1),
                                                      cin, generator))
        self.bias = nn.Parameter(torch_uniform_init((cout,), cin, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype).float().reshape(self.weight.shape[:2])
        return torch.matmul(x.float(), w.t()) + self.bias.float()


class SegmentationGS(nn.Module):
    """HED-style multi-scale segmentation head (joint_model.py:307-346):
    ConvGS and three DownGS stages, each scale's output GS-normalized at
    groups gcd(2 / 4 / 8 / 8, C) and upsampled to full resolution, their
    concat fused by ConvGS(32), then the 1^3 head and the class softmax in
    f32, stored in the compute dtype. [B, D, H, W, n_channels] ->
    [B, D, H, W, n_class]."""

    GROUPS = (2, 4, 8, 8)   # the reference's at fmaps (8, 16, 32, 64)

    def __init__(self, n_class: int = 2, fmaps: Sequence[int] = DEFAULT_FMAPS,
                 dtype: torch.dtype = torch.bfloat16, n_channels: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = tuple(fmaps)
        self.n_class = n_class
        self.dtype = dtype
        g = generator
        self.in_block = ConvGS(n_channels, f[0], generator=g)
        self.down1 = DownGS(f[0], f[1], generator=g)
        self.down2 = DownGS(f[1], f[2], generator=g)
        self.down3 = DownGS(f[2], f[3], generator=g)
        self.fuse = ConvGS(f[0] + f[1] + f[2] + f[3], 32, generator=g)
        self.out_block = Conv1(32, n_class, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.in_block(x.to(self.dtype))
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        feats = []
        for v, want, factor in zip((x1, x2, x3, x4), self.GROUPS,
                                   (1, 2, 4, 8)):
            v = gs_norm(v, math.gcd(want, v.shape[-1]))
            feats.append(v if factor == 1 else upsample(v, factor))
        h = self.fuse(torch.cat(feats, dim=-1))
        logits = self.out_block(h)
        return torch.softmax(logits, dim=-1).to(self.dtype)
