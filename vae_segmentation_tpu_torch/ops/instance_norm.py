"""The fused parameter-free InstanceNorm(+ReLU) over channels-last
[B, D, H, W, C] volumes, differentiable (counterpart of
vae_segmentation_tpu/ops/pallas/instance_norm.py): statistics in f32, the
stored result in x.dtype.

``instance_norm_act`` is what the norm route of the models calls
(``models/blocks.py::use_pallas_norm``): a ``torch.autograd.Function``
whose forward is ``norm_stats``' f64 sums, then ``norm_apply``, which folds
them to (scale, shift) = (rstd, -mean * rstd) and applies them in one
launch, and whose backward is ``norm_bwd``: ``norm_bwd_sums`` (the masked
cotangent's two sums, f64), then ``norm_bwd_dx``, which takes their means
itself. On the card a norm is thus two or three launches each way.
Under a 'spatial' mesh axis (``mesh``: a rank holds D planes of the
volume) both f64 sums are added over the data row before the fold, so the
norm is the volume's.

Four hand-written kernels live here (``kernels/csrc/instance_norm.cu``),
each with its plain version, launched on CUDA tensors and counted in
``.launches``: ``norm_stats`` replaces ``instance_norm.py::_per_lane_stats``,
``norm_apply`` replaces ``::_apply_per_lane``, ``norm_bwd_sums`` and
``norm_bwd_dx`` replace the two ``pallas_call``s of ``::_bwd``. The TPU's
128-lane flat view and its zero padding are not ported: the kernels reduce
per (B, C) over the channels-last data as it is. The two reductions
(``norm_stats``, ``norm_bwd_sums``) follow ``norm_reduce_plan``: one launch
(a thread-block cluster a batch entry) for the small calls, two passes for
the large; the two elementwise passes (``norm_apply``, ``norm_bwd_dx``)
follow ``norm_apply_plan``. Every kernel reads 8 channels of a voxel in one
16-byte load where C % 8 == 0.

Numerics kept from the JAX function: the one-pass variance E[x^2] - mean^2
clamped at 0, eps 1e-5 (``_fold_lane_stats``), and xhat = x * scale +
shift rounded as every kernel of the port rounds a prologue (a multiply,
then an add: ``csrc/common.cuh::pre_activation``), so the backward's ReLU
mask is the forward's. The kernels round the f64 sums and fold them as
``affine_from_stats`` and ``norm_bwd_dx_plain`` do on the card, one
rounding per torch operation, so each gives its plain version's bits.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from vae_segmentation_tpu_torch.ops.conv3 import (
    _pre_activation, _ptr, check_affine, check_tensor, raise_if, sm_count)
from vae_segmentation_tpu_torch.parallel import collectives

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


def norm_stats_plain(x: torch.Tensor, f64: bool = False) -> torch.Tensor:
    """[B, 2, C] f32: per (b, c), the sum and the sum of squares of x over
    every voxel (with `f64`, the same values widened to f64)."""
    x32 = x.float()
    out = torch.stack([x32.sum(dim=(1, 2, 3)),
                       (x32 * x32).sum(dim=(1, 2, 3))], dim=1)
    return out.double() if f64 else out


def norm_apply_plain(x: torch.Tensor, s: torch.Tensor, t: torch.Tensor,
                     relu: bool = True) -> torch.Tensor:
    """[relu](x * s + t) in f32, s and t [B, C] f32, stored in x.dtype."""
    y = _pre_activation(x, (s, t))
    return (torch.relu(y) if relu else y).to(x.dtype)


def fold_apply_plain(x: torch.Tensor, sums: torch.Tensor,
                     relu: bool = True) -> Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """(y, s, t): the InstanceNorm(+ReLU) of x from its [B, 2, C] sums (f32
    or f64, ``norm_stats``' block): (s, t) = ``affine_from_stats`` of the
    sums rounded to f32, y = ``norm_apply_plain`` (x, s, t)."""
    s, t = affine_from_stats(sums.float(), _n_spatial(x))
    return norm_apply_plain(x, s, t, relu), s, t


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
                        t: torch.Tensor, relu: bool = True,
                        f64: bool = False) -> torch.Tensor:
    """[B, 2, C] f32: per (b, c), sum g_m and sum g_m * xhat over every
    voxel, the first pass of the backward (with `f64`, the same values
    widened to f64)."""
    gm, xhat = _masked(x, g, s, t, relu)
    out = torch.stack([gm.sum(dim=(1, 2, 3)),
                       (gm * xhat).sum(dim=(1, 2, 3))], dim=1)
    return out.double() if f64 else out


def norm_bwd_dx_plain(x: torch.Tensor, g: torch.Tensor, s: torch.Tensor,
                      t: torch.Tensor, sums: torch.Tensor,
                      relu: bool = True) -> torch.Tensor:
    """dx = s * (g_m - m1 - xhat * m2) in f32, stored in x.dtype, with
    (m1, m2) the [B, 2, C] sums of ``norm_bwd_sums`` (f32 or f64) rounded
    to f32 over the voxel count: the second pass of the backward (s is
    rstd)."""
    m = sums.float() / _n_spatial(x)
    gm, xhat = _masked(x, g, s, t, relu)
    dx = _per_channel(s.float()) * (gm - _per_channel(m[:, 0])
                                    - xhat * _per_channel(m[:, 1]))
    return dx.to(x.dtype)


# ---- the kernels


# the plans of the reduction (instance_norm.cu's norm_reduce_kernel and
# norm_reduce_cluster_kernel)
NORM_THREADS = 256           # threads a block of either plan
NORM_CLUSTER = 8             # blocks (a cluster) a batch entry, one launch
NORM_CLUSTER_MAX_C = 1024    # channels the one-launch plan takes
# items (8 channels of a voxel) a batch entry up to which one launch wins:
# 8^3 x 128 and below (NVIDIA H100 80GB HBM3, chip_smoke.py's norm_plans)
NORM_ONE_LAUNCH_ITEMS = 1 << 13
NORM_ITEMS_A_THREAD = 4      # the two-pass plan's items a thread, about
NORM_BLOCKS_A_SM = 4         # its blocks an SM over the batch, at most


@functools.lru_cache(maxsize=None)
def norm_reduce_plan(batch: int, nvox: int, c: int, vec: bool,
                     sms: int, one_launch: Optional[bool] = None) -> dict:
    """The plan of one ``norm_stats`` / ``norm_bwd_sums`` call on [batch,
    nvox, c]: ``parts`` 0 for one launch (a cluster of ``NORM_CLUSTER``
    blocks a batch entry; rank 0 adds the blocks' sums in f64), else the
    blocks a batch entry of the two passes (each block's [2, c] partial
    written once, then added in f64 by ``common.cuh::parts_reduce``).

    An item is 8 channels of one voxel (`vec`: c % 8 == 0 and x, g
    16-byte aligned) or one element; ``groups`` = c / 8 or c. A thread's
    items lie ``stride`` items apart, a multiple of ``groups``, so its
    channel group is fixed. One launch takes a batch entry of at most
    ``NORM_ONE_LAUNCH_ITEMS`` items (vec, c <= ``NORM_CLUSTER_MAX_C``,
    groups a power of two); two passes size the grid for about
    ``NORM_ITEMS_A_THREAD`` items a thread, at most ``NORM_BLOCKS_A_SM``
    blocks an SM over the batch, rounded up to keep the stride a multiple
    of ``groups``. `one_launch` True or False forces a plan (chip_smoke.py
    times both; True raises where one launch cannot take the call). The
    result is cached: do not modify it."""
    if batch < 1 or nvox < 1 or c < 1:
        raise ValueError(f"norm reduce: no call on [{batch}, {nvox}, {c}]")
    lanes = 8 if vec and c % 8 == 0 else 1
    groups = c // lanes
    items = nvox * c // lanes
    can = lanes == 8 and c <= NORM_CLUSTER_MAX_C \
        and groups & (groups - 1) == 0
    if one_launch and not can:
        raise ValueError(f"norm reduce: one launch cannot take C {c}")
    one = can and items <= NORM_ONE_LAUNCH_ITEMS if one_launch is None \
        else one_launch
    threads = NORM_THREADS
    if one:
        parts, blocks = 0, NORM_CLUSTER
    else:
        blocks = min(-(-items // (threads * NORM_ITEMS_A_THREAD)),
                     -(-NORM_BLOCKS_A_SM * sms // batch))
        q = groups // math.gcd(groups, threads)
        parts = blocks = -(-blocks // q) * q
    return {"parts": parts, "one_launch": one, "lanes": lanes,
            "groups": groups, "items": items, "blocks": blocks,
            "threads": threads, "stride": blocks * threads}


# the plan of the elementwise pass (instance_norm.cu's
# norm_elementwise_kernel: norm_apply, norm_bwd_dx)
NORM_APPLY_ITEMS_A_THREAD = 4   # items a thread, about (loaded at once)
NORM_APPLY_BLOCKS_A_SM = 8      # blocks an SM over the batch, at most


@functools.lru_cache(maxsize=None)
def norm_apply_plan(batch: int, nvox: int, c: int, vec: bool,
                    sms: int) -> dict:
    """The plan of one ``norm_apply`` / ``norm_bwd_dx`` call on [batch,
    nvox, c]: ``blocks`` a batch entry of ``threads`` threads. An item is 8
    channels of one voxel (`vec`: c % 8 == 0 and x, g, y 16-byte aligned;
    one 16-byte load and store) or one element (``lanes`` 8 or 1); thread
    i of a batch entry takes the items i + k ``stride``, a multiple of the
    ``groups`` = c / lanes, so its channel group i % groups is fixed. The
    grid is sized for about ``NORM_APPLY_ITEMS_A_THREAD`` items a thread,
    at most ``NORM_APPLY_BLOCKS_A_SM`` blocks an SM over the batch, rounded
    up to keep the stride a multiple of ``groups``. The result is cached:
    do not modify it."""
    if batch < 1 or nvox < 1 or c < 1:
        raise ValueError(f"norm apply: no call on [{batch}, {nvox}, {c}]")
    lanes = 8 if vec and c % 8 == 0 else 1
    groups = c // lanes
    items = nvox * c // lanes
    threads = NORM_THREADS
    blocks = min(-(-items // (threads * NORM_APPLY_ITEMS_A_THREAD)),
                 -(-NORM_APPLY_BLOCKS_A_SM * sms // batch))
    q = groups // math.gcd(groups, threads)
    blocks = -(-blocks // q) * q
    return {"lanes": lanes, "groups": groups, "items": items,
            "blocks": blocks, "threads": threads, "stride": blocks * threads}


def _aligned(*ts) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


def _check(who: str, x: torch.Tensor, g: Optional[torch.Tensor]):
    """Raise unless x (and g) can go to a kernel of ``instance_norm.cu``
    on the card: contiguous bf16 [B, D, H, W, C] of one shape."""
    if x.device.type != "cuda":
        raise RuntimeError(f"{who}: no kernel for device {x.device}")
    if x.dim() != 5:
        raise ValueError(f"{who}: x must be [B, D, H, W, C], got "
                         f"{tuple(x.shape)}")
    check_tensor(who, "x", x, x.device, torch.bfloat16, tuple(x.shape))
    if g is not None:
        check_tensor(who, "g", g, x.device, torch.bfloat16, tuple(x.shape))


def _launch(who: str, x: torch.Tensor, relu: bool,
            g: Optional[torch.Tensor] = None, aff: Optional[Affine] = None,
            plan: Optional[dict] = None) -> torch.Tensor:
    """Check the inputs and launch a reduction of ``instance_norm.cu`` to
    its [B, 2, C] f64 sums (``norm_stats``, or ``norm_bwd_sums`` with g and
    aff) under `plan`, a ``norm_reduce_plan`` of the call's shape (the
    call's own by default). Each block's f32 sums are added across the
    blocks in f64 in a fixed order (sums of 2M voxels at 128^3 that cancel
    in the backward)."""
    _check(who, x, g)
    from vae_segmentation_tpu_torch.ops.kernels import build

    b, c, dev = x.shape[0], x.shape[-1], x.device
    s = t = None
    if aff is not None:
        s, t = check_affine(who, aff, dev, b, c)
    lib = build.library("instance_norm")
    if plan is None:
        plan = reduce_plan(x, g)
    with torch.cuda.device(dev):
        part = None if plan["one_launch"] else torch.empty(
            (b, plan["parts"], 2, c), dtype=torch.float32, device=dev)
        out = torch.empty((b, 2, c), dtype=torch.float64, device=dev)
        rc = lib.vaeseg_norm_reduce(
            x.data_ptr(), _ptr(g), _ptr(s), _ptr(t), _ptr(part),
            plan["parts"], out.data_ptr(), int(relu), b,
            x.numel() // (b * c), c, torch.cuda.current_stream(dev).cuda_stream)
    raise_if(rc, lib, who)
    return out


def _launch_elementwise(who: str, x: torch.Tensor, sums: torch.Tensor,
                        relu: bool, g: Optional[torch.Tensor] = None,
                        aff: Optional[Affine] = None):
    """Check the inputs and launch the elementwise pass of
    ``instance_norm.cu`` under the call's ``norm_apply_plan``: without g,
    ``norm_apply`` (returns y and the folded (s, t)); with g and aff,
    ``norm_bwd_dx`` (returns dx). `sums` is the reduction's [B, 2, C] f64
    block."""
    _check(who, x, g)
    from vae_segmentation_tpu_torch.ops.kernels import build

    b, c, dev = x.shape[0], x.shape[-1], x.device
    check_tensor(who, "sums", sums, dev, torch.float64, (b, 2, c))
    if aff is not None:
        s, t = check_affine(who, aff, dev, b, c)
    else:
        s = torch.empty((b, c), dtype=torch.float32, device=dev)
        t = torch.empty_like(s)
    y = torch.empty_like(x)
    nvox = x.numel() // (b * c)
    plan = norm_apply_plan(b, nvox, c, _aligned(x, g, y),
                           sm_count(dev.index or 0))
    lib = build.library("instance_norm")
    with torch.cuda.device(dev):
        rc = lib.vaeseg_norm_elementwise(
            x.data_ptr(), _ptr(g), s.data_ptr(), t.data_ptr(),
            sums.data_ptr(), y.data_ptr(), int(relu), b, nvox, c,
            plan["blocks"], int(plan["lanes"] == 8),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_if(rc, lib, who)
    return y if g is not None else (y, s, t)


def reduce_plan(x: torch.Tensor, g: Optional[torch.Tensor] = None) -> dict:
    """The ``norm_reduce_plan`` a reduction over x (and g) on the card
    takes."""
    b, c = x.shape[0], x.shape[-1]
    return norm_reduce_plan(b, x.numel() // (b * c), c, _aligned(x, g),
                            sm_count(x.device.index or 0))


def norm_stats(x: torch.Tensor, f64: bool = False) -> torch.Tensor:
    """Row 15. Same contract as ``norm_stats_plain``; on CUDA, x must be
    contiguous bf16. With `f64` the kernel's f64 sums as they are (what
    ``norm_apply`` takes: no rounding node)."""
    if x.device.type == "cpu":
        return norm_stats_plain(x, f64)
    out = _launch("norm_stats", x, False)
    norm_stats.launches += 1
    return out if f64 else out.float()


def norm_apply(x: torch.Tensor, sums: torch.Tensor,
               relu: bool = True) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Row 16 with its fold. Same contract as ``fold_apply_plain``: (y, s,
    t); on CUDA, x must be contiguous bf16 and sums ``norm_stats``' [B, 2,
    C] f64 block."""
    if x.device.type == "cpu":
        return fold_apply_plain(x, sums, relu)
    out = _launch_elementwise("norm_apply", x, sums, relu)
    norm_apply.launches += 1
    return out


def norm_bwd_sums(x: torch.Tensor, g: torch.Tensor, s: torch.Tensor,
                  t: torch.Tensor, relu: bool = True,
                  f64: bool = False) -> torch.Tensor:
    """Row 17, first pass. Same contract as ``norm_bwd_sums_plain``; on
    CUDA, x and g must be contiguous bf16 of one shape. With `f64` the
    kernel's f64 sums as they are (what ``norm_bwd_dx`` takes)."""
    if x.device.type == "cpu":
        return norm_bwd_sums_plain(x, g, s, t, relu, f64)
    out = _launch("norm_bwd_sums", x, relu, g=g, aff=(s, t))
    norm_bwd_sums.launches += 1
    return out if f64 else out.float()


def norm_bwd_dx(x: torch.Tensor, g: torch.Tensor, s: torch.Tensor,
                t: torch.Tensor, sums: torch.Tensor,
                relu: bool = True) -> torch.Tensor:
    """Row 17, second pass. Same contract as ``norm_bwd_dx_plain``; on
    CUDA, x and g must be contiguous bf16 of one shape, sums
    ``norm_bwd_sums``' [B, 2, C] f64 block."""
    if x.device.type == "cpu":
        return norm_bwd_dx_plain(x, g, s, t, sums, relu)
    out = _launch_elementwise("norm_bwd_dx", x, sums, relu, g=g, aff=(s, t))
    norm_bwd_dx.launches += 1
    return out


def norm_bwd(x: torch.Tensor, g: torch.Tensor, s: torch.Tensor,
             t: torch.Tensor, relu: bool = True, mesh=None) -> torch.Tensor:
    """Row 17: the cotangent of x from the cotangent g of
    ``[relu](x * s + t)`` where (s, t) are x's own norm statistics:
    ``norm_bwd_sums``, then ``norm_bwd_dx``, which takes their means
    (instance_norm.py:244-295); under `mesh` the volume's
    (``volume_sums``)."""
    sums = volume_sums(norm_bwd_sums(x, g, s, t, relu, f64=True), mesh)
    return norm_bwd_dx(x, g, s, t, sums, relu)


def volume_sums(sums: torch.Tensor, mesh) -> torch.Tensor:
    """A slab's f64 [B, 2, C] sums -> the volume's, in the units of the
    slab's voxel count (the folds divide by x's own): added over the data
    row, then divided by n_spatial (exact for a power of 2). Unchanged
    without a mesh."""
    if mesh is None:
        return sums
    return collectives.spatial_sum(sums, mesh) / mesh.n_spatial


class _InstanceNormActFn(torch.autograd.Function):
    """InstanceNorm(+ReLU) with its backward kernels; x is the only
    differentiable input. Under a 'spatial' mesh both passes' sums are
    the volume's (``volume_sums``): the backward's all-reduce is the
    adjoint of the forward's."""

    @staticmethod
    def forward(ctx, x, relu, mesh):
        y, s, t = norm_apply(x, volume_sums(norm_stats(x, f64=True), mesh),
                             relu)
        ctx.save_for_backward(x, s, t)
        ctx.relu, ctx.mesh = relu, mesh
        return y

    @staticmethod
    def backward(ctx, g):
        x, s, t = ctx.saved_tensors
        return norm_bwd(x, g.contiguous(), s, t, ctx.relu, ctx.mesh), \
            None, None


def instance_norm_act(x: torch.Tensor, relu: bool = True,
                      mesh=None) -> torch.Tensor:
    """Parameter-free InstanceNorm over the spatial axes of [B, D, H, W, C]
    (+ ReLU), f32 statistics, stored in x.dtype; differentiable in x
    (instance_norm.py:187-206). `mesh`: x is this rank's D planes of the
    volume over the mesh's 'spatial' axis."""
    return _InstanceNormActFn.apply(x.contiguous(), relu, mesh)


norm_stats.launches = 0
norm_apply.launches = 0
norm_bwd_sums.launches = 0
norm_bwd_dx.launches = 0
