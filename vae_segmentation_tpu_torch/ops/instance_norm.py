"""The fused parameter-free InstanceNorm(+ReLU) over channels-last
[B, D, H, W, C] volumes, differentiable (counterpart of
vae_segmentation_tpu/ops/pallas/instance_norm.py): statistics in f32, the
stored result in x.dtype.

``instance_norm_act`` is what the norm route of the models calls
(``models/blocks.py::use_pallas_norm``): a ``torch.autograd.Function``
whose forward is ``norm_stats``, the fold to (scale, shift) =
(rstd, -mean * rstd) and ``norm_apply``, and whose backward is
``norm_bwd``: ``norm_bwd_sums`` (the masked cotangent's two sums), the
fold to their means, and ``norm_bwd_dx``.

Four hand-written kernels live here (``kernels/csrc/instance_norm.cu``),
each with its plain version, launched on CUDA tensors and counted in
``.launches``: ``norm_stats`` replaces ``instance_norm.py::_per_lane_stats``,
``norm_apply`` replaces ``::_apply_per_lane``, ``norm_bwd_sums`` and
``norm_bwd_dx`` replace the two ``pallas_call``s of ``::_bwd``. The TPU's
128-lane flat view and its zero padding are not ported: the kernels reduce
per (B, C) over the channels-last data as it is.

Numerics kept from the JAX function: the one-pass variance E[x^2] - mean^2
clamped at 0, eps 1e-5 (``_fold_lane_stats``), and xhat = x * scale +
shift rounded as every kernel of the port rounds a prologue (a multiply,
then an add: ``csrc/common.cuh::pre_activation``), so the backward's ReLU
mask is the forward's.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from vae_segmentation_tpu_torch.ops.conv3 import (
    _pre_activation, _ptr, check_affine, check_tensor, raise_if)

EPS = 1e-5
Affine = Tuple[torch.Tensor, torch.Tensor]


def _n_spatial(x: torch.Tensor) -> int:
    return math.prod(x.shape[1:-1])


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    """[B, C] -> broadcastable against [B, D, H, W, C]."""
    return v[:, None, None, None, :]


def affine_from_stats(st: torch.Tensor, n_spatial: int,
                      eps: float = EPS) -> Affine:
    """InstanceNorm (scale, shift), each [B, C] f32, from a [B, 2, C]
    (sum, sumsq) block (blocks.py:352-369 and instance_norm.py:166-177 of
    the JAX package): biased one-pass variance clamped at 0, eps 1e-5, as
    torch's InstanceNorm3d."""
    mean = st[:, 0] / n_spatial
    var = st[:, 1] / n_spatial - mean * mean
    rstd = torch.rsqrt(torch.clamp(var, min=0.0) + eps)
    return rstd, -mean * rstd


# ---- plain versions


def norm_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """[B, 2, C] f32: per (b, c), the sum and the sum of squares of x over
    every voxel."""
    x32 = x.float()
    return torch.stack([x32.sum(dim=(1, 2, 3)),
                        (x32 * x32).sum(dim=(1, 2, 3))], dim=1)


def norm_apply_plain(x: torch.Tensor, s: torch.Tensor, t: torch.Tensor,
                     relu: bool = True) -> torch.Tensor:
    """[relu](x * s + t) in f32, s and t [B, C] f32, stored in x.dtype."""
    y = _pre_activation(x, (s, t))
    return (torch.relu(y) if relu else y).to(x.dtype)


def _masked(x: torch.Tensor, g: torch.Tensor, s: torch.Tensor,
            t: torch.Tensor, relu: bool):
    """(g_m, xhat) in f32: xhat = x * s + t, g_m = g where xhat > 0 (every
    g without the ReLU)."""
    xhat = _pre_activation(x, (s, t))
    g32 = g.float()
    if relu:
        g32 = torch.where(xhat > 0, g32, torch.zeros((), dtype=g32.dtype,
                                                     device=g32.device))
    return g32, xhat


def norm_bwd_sums_plain(x: torch.Tensor, g: torch.Tensor, s: torch.Tensor,
                        t: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """[B, 2, C] f32: per (b, c), sum g_m and sum g_m * xhat over every
    voxel, the first pass of the backward."""
    gm, xhat = _masked(x, g, s, t, relu)
    return torch.stack([gm.sum(dim=(1, 2, 3)),
                        (gm * xhat).sum(dim=(1, 2, 3))], dim=1)


def norm_bwd_dx_plain(x: torch.Tensor, g: torch.Tensor, s: torch.Tensor,
                      t: torch.Tensor, m: torch.Tensor,
                      relu: bool = True) -> torch.Tensor:
    """dx = s * (g_m - m1 - xhat * m2) in f32, stored in x.dtype, with
    m [B, 2, C] f32 the two sums of ``norm_bwd_sums`` over the voxel count:
    the second pass of the backward (s is rstd)."""
    gm, xhat = _masked(x, g, s, t, relu)
    dx = _per_channel(s.float()) * (gm - _per_channel(m[:, 0])
                                    - xhat * _per_channel(m[:, 1]))
    return dx.to(x.dtype)


# ---- the kernels


def _launch(who: str, x: torch.Tensor, relu: bool,
            g: Optional[torch.Tensor] = None, aff: Optional[Affine] = None,
            m: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Check the inputs and launch one kernel of ``instance_norm.cu``:
    a reduction to [B, 2, C] (``norm_stats``, ``norm_bwd_sums``) or an
    elementwise pass to x's shape (``norm_apply``, ``norm_bwd_dx``)."""
    if x.device.type != "cuda":
        raise RuntimeError(f"{who}: no kernel for device {x.device}")
    from vae_segmentation_tpu_torch.ops.kernels import build

    if x.dim() != 5:
        raise ValueError(f"{who}: x must be [B, D, H, W, C], got "
                         f"{tuple(x.shape)}")
    b, c, dev = x.shape[0], x.shape[-1], x.device
    check_tensor(who, "x", x, dev, torch.bfloat16, tuple(x.shape))
    if g is not None:
        check_tensor(who, "g", g, dev, torch.bfloat16, tuple(x.shape))
    s = t = None
    if aff is not None:
        s, t = check_affine(who, aff, dev, b, c)
    if m is not None:
        check_tensor(who, "m", m, dev, torch.float32, (b, 2, c))
    reduce = who in ("norm_stats", "norm_bwd_sums")
    lib = build.library("instance_norm")
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = x.numel() // (b * c)
    with torch.cuda.device(dev):
        if reduce:
            # f64 across the kernel's blocks (sums of 2M voxels at 128^3
            # that cancel in the backward), rounded once here
            out = torch.zeros((b, 2, c), dtype=torch.float64, device=dev)
            rc = lib.vaeseg_norm_reduce(
                x.data_ptr(), _ptr(g), _ptr(s), _ptr(t), out.data_ptr(),
                int(relu), b, n, c, stream)
        else:
            out = torch.empty_like(x)
            rc = lib.vaeseg_norm_elementwise(
                x.data_ptr(), _ptr(g), s.data_ptr(), t.data_ptr(), _ptr(m),
                out.data_ptr(), int(relu), b, n, c, stream)
    raise_if(rc, lib, who)
    return out.float() if reduce else out


def norm_stats(x: torch.Tensor) -> torch.Tensor:
    """Row 15. Same contract as ``norm_stats_plain``; on CUDA, x must be
    contiguous bf16."""
    if x.device.type == "cpu":
        return norm_stats_plain(x)
    out = _launch("norm_stats", x, False)
    norm_stats.launches += 1
    return out


def norm_apply(x: torch.Tensor, s: torch.Tensor, t: torch.Tensor,
               relu: bool = True) -> torch.Tensor:
    """Row 16. Same contract as ``norm_apply_plain``; on CUDA, x must be
    contiguous bf16 and s, t [B, C] f32."""
    if x.device.type == "cpu":
        return norm_apply_plain(x, s, t, relu)
    out = _launch("norm_apply", x, relu, aff=(s, t))
    norm_apply.launches += 1
    return out


def norm_bwd_sums(x: torch.Tensor, g: torch.Tensor, s: torch.Tensor,
                  t: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """Row 17, first pass. Same contract as ``norm_bwd_sums_plain``; on
    CUDA, x and g must be contiguous bf16 of one shape."""
    if x.device.type == "cpu":
        return norm_bwd_sums_plain(x, g, s, t, relu)
    out = _launch("norm_bwd_sums", x, relu, g=g, aff=(s, t))
    norm_bwd_sums.launches += 1
    return out


def norm_bwd_dx(x: torch.Tensor, g: torch.Tensor, s: torch.Tensor,
                t: torch.Tensor, m: torch.Tensor,
                relu: bool = True) -> torch.Tensor:
    """Row 17, second pass. Same contract as ``norm_bwd_dx_plain``; on
    CUDA, x and g must be contiguous bf16 of one shape, m [B, 2, C] f32."""
    if x.device.type == "cpu":
        return norm_bwd_dx_plain(x, g, s, t, m, relu)
    out = _launch("norm_bwd_dx", x, relu, g=g, aff=(s, t), m=m)
    norm_bwd_dx.launches += 1
    return out


def norm_bwd(x: torch.Tensor, g: torch.Tensor, s: torch.Tensor,
             t: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """Row 17: the cotangent of x from the cotangent g of
    ``[relu](x * s + t)`` where (s, t) are x's own norm statistics:
    ``norm_bwd_sums``, their means, then ``norm_bwd_dx``
    (instance_norm.py:244-295)."""
    m = norm_bwd_sums(x, g, s, t, relu) / _n_spatial(x)
    return norm_bwd_dx(x, g, s, t, m, relu)


class _InstanceNormActFn(torch.autograd.Function):
    """InstanceNorm(+ReLU) with its backward kernels; x is the only
    differentiable input."""

    @staticmethod
    def forward(ctx, x, relu):
        s, t = affine_from_stats(norm_stats(x), _n_spatial(x))
        ctx.save_for_backward(x, s, t)
        ctx.relu = relu
        return norm_apply(x, s, t, relu)

    @staticmethod
    def backward(ctx, g):
        x, s, t = ctx.saved_tensors
        return norm_bwd(x, g.contiguous(), s, t, ctx.relu), None


def instance_norm_act(x: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """Parameter-free InstanceNorm over the spatial axes of [B, D, H, W, C]
    (+ ReLU), f32 statistics, stored in x.dtype; differentiable in x
    (instance_norm.py:187-206)."""
    return _InstanceNormActFn.apply(x.contiguous(), relu)


norm_stats.launches = 0
norm_apply.launches = 0
norm_bwd_sums.launches = 0
norm_bwd_dx.launches = 0
