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

A soft stage (``soft=True``: the soft-ReLU ShapeVAE of --softrelu 1,
blocks.py:514-534, 867-989 of the JAX package) keeps K1's stats epilogue
but applies softplus in place of ReLU, so no norm rides into a prologue:
each of its norms is applied where it is made (``apply_affine_relu`` with
``soft``) and its blocks hand their consumers ``None``; on the norm route
it runs ``instance_norm_act`` without the ReLU, then softplus.

``norm_type`` (blocks.py:458-534, 867-1082 of the JAX package) picks the
norm of every block: 1 InstanceNorm (everything above), 2 BatchNorm, 3
GSNorm (``Norm``). For 2 and 3 each conv is K1 with no prologue and no
stats epilogue, then ``Norm``, then ReLU (softplus when soft): plain
PyTorch on the stored conv output, as the JAX package computes those norms
with XLA. The blocks hand their consumers ``None`` for the affine, as on
the norm route, and ``use_pallas_norm`` applies to norm_type 1 only. A
block's ``Norm`` sits at the reference's Sequential index beside its conv
(``conv.1`` of a ConvNormAct; ``conv.{1,4,7}`` of a DoubleConv); only
norm_type 2 has parameters and buffers there.

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

Under an active mesh (``parallel.sharding.active``, the train steps of a
multi-rank run) each rank holds its slice: its batch items and, over a
'spatial' axis, its D planes. The leaf modules are the JAX package's shard
wraps (blocks.py:149-311): ``Conv3`` exchanges the D halo planes
(``collectives.halo_exchange``), runs K1 on the slab with its valid-plane
range (``dlim``) and keeps the owned planes; with the stats epilogue it
subtracts the two halo planes' sums and adds the slabs' stats over the
data row (``stats_slab_correct``), so an InstanceNorm divides by the
volume's count (``sharding.global_voxels``). The bridges are plane-local
and split with no halo while the slab's D splits in pairs; otherwise (and
for a volume that is whole on the rank: ``sharding.mark_replicated``) they
run on the whole volume, as the JAX wraps fall back to the unsharded op,
and hand on this rank's planes wherever the next stage's D splits. On the
norm route each norm adds its slab's f64 sums over the data row before
the fold (``instance_norm_act``'s ``mesh``). A GSNorm is voxel-local and
runs on the slabs; a BatchNorm raises under any mesh (no JAX step runs
one).
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vae_segmentation_tpu_torch.ops import bridges, conv3 as conv3_ops
from vae_segmentation_tpu_torch.ops.instance_norm import (
    affine_from_stats, instance_norm_act)
from vae_segmentation_tpu_torch.parallel import collectives, sharding

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


def _act(soft: bool):
    return F.softplus if soft else torch.relu


def apply_affine_relu(x: torch.Tensor, aff: Affine,
                      soft: bool = False) -> torch.Tensor:
    """relu(x * s + t) in f32 (softplus with `soft`), stored in x.dtype: a
    norm applied where no kernel prologue can take it."""
    s, t = aff
    y = _act(soft)(x.float() * s[:, None, None, None, :]
                   + t[:, None, None, None, :])
    return sharding.like(y.to(x.dtype), x)



def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Parameter-free InstanceNorm over the spatial dims of [B, D, H, W, C]
    (the JAX package's ``blocks.instance_norm``): mean and biased variance
    in f32, the per-(B, C) scale and shift cast to x.dtype, one
    multiply-add in x.dtype. The models' norm_type 1 takes its statistics
    from K1's epilogue or the norm kernels instead; this is ``Norm(1)``."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2, 3), keepdim=True)
    var = x32.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return x * rstd.to(x.dtype) + (-mean * rstd).to(x.dtype)


def gs_norm(x: torch.Tensor, num_group: int = 1,
            eps: float = 1e-4) -> torch.Tensor:
    """Group-sum normalization (reference joint_model.py:17-33; the JAX
    package's ``blocks.gs_norm``): within each of `num_group` channel
    groups, x divided by the group's channel sum + eps, summed in f32 and
    cast back to x.dtype. Voxel-local. A sum near -eps gives very large
    values: the JAX function does the same."""
    c = x.shape[-1]
    x32 = x.float().reshape(*x.shape[:-1], num_group, c // num_group)
    denom = x32.sum(dim=-1, keepdim=True) + eps
    return (x32 / denom).reshape(x.shape).to(x.dtype)


_IN_STEP = False


@contextlib.contextmanager
def refusing_batch_norm():
    """Within (every train step and eval of ``train/steps.py`` and
    ``eval/evaluate.py``): a norm_type 2 ``Norm`` raises ValueError. The
    JAX package's steps and evals apply ``{"params": p}`` alone, which a
    BatchNorm's ``batch_stats`` collection refuses, so no JAX step runs
    one; norm_type 3 is stateless and runs."""
    global _IN_STEP
    prev, _IN_STEP = _IN_STEP, True
    try:
        yield
    finally:
        _IN_STEP = prev


class Norm(nn.Module):
    """The norm dispatch (reference joint_model.py:9-15; the JAX package's
    ``blocks.Norm``): norm_type 1 InstanceNorm (``instance_norm``), 2
    BatchNorm, 3 GSNorm (``gs_norm`` with `num_group`).

    The BatchNorm follows flax's ``nn.BatchNorm`` as the JAX package
    builds it (momentum 0.9, epsilon 1e-5, ``use_fast_variance`` and f32
    reductions): the statistics over (B, D, H, W) in f32 with var =
    mean(x^2) - mean^2 clipped at 0, y = (x - mean) * (rsqrt(var + eps) *
    weight) + bias in f32 cast to x.dtype, and each batch-statistics
    forward updates ``running = 0.9 * running + 0.1 * batch`` with the
    biased variance (torch's own update takes the unbiased one). Its keys
    are torch ``BatchNorm3d``'s (``weight``, ``bias``, ``running_mean``,
    ``running_var``, ``num_batches_tracked``), so a reference checkpoint
    loads strictly. The JAX models build every Norm with
    ``use_running_average=False``, so a port model normalises with batch
    statistics and updates its running buffers on every forward, whatever
    ``self.training`` is; ``use_running_average=True`` reads the buffers
    and updates nothing. A BatchNorm raises under an active mesh."""

    def __init__(self, norm_type: int, channels: int = 0, num_group: int = 1,
                 use_running_average: bool = False):
        super().__init__()
        if norm_type not in (1, 2, 3):
            raise ValueError(f"unknown norm_type={norm_type}")
        self.norm_type = norm_type
        self.num_group = num_group
        self.use_running_average = use_running_average
        if norm_type == 2:
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
            self.register_buffer("running_mean", torch.zeros(channels))
            self.register_buffer("running_var", torch.ones(channels))
            self.register_buffer("num_batches_tracked",
                                 torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm_type == 1:
            return instance_norm(x)
        if self.norm_type == 3:
            return gs_norm(x, self.num_group)
        return self._batch_norm(x)

    MOMENTUM, EPS = 0.9, 1e-5

    def _batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        if _IN_STEP:
            raise ValueError("norm_type 2 (BatchNorm) runs at the model "
                             "level only: no train step or eval of the JAX "
                             "package runs one")
        if sharding.current() is not None:
            raise ValueError("norm_type 2 (BatchNorm) does not run under a "
                             "mesh: no train step of the JAX package runs "
                             "one")
        x32 = x.float()
        if self.use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            dims = tuple(range(x.dim() - 1))
            mean = x32.mean(dim=dims)
            var = ((x32 * x32).mean(dim=dims) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1.0 - m) * var)
                self.num_batches_tracked += 1
        y = (x32 - mean) * (torch.rsqrt(var + self.EPS) * self.weight)
        return (y + self.bias).to(x.dtype)


def norm_act(norm: Norm, y: torch.Tensor, soft: bool = False
             ) -> torch.Tensor:
    """act(norm(y)) of a norm_type 2 or 3 block (the JAX package's
    ``_norm_act`` with no fold): ReLU, or softplus in f32 with `soft`,
    stored in y.dtype."""
    z = norm(y)
    z = F.softplus(z.float()).to(y.dtype) if soft else torch.relu(z)
    return sharding.like(z, y)


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
        mesh = sharding.spatial_mesh(x)
        if mesh is None:
            return sharding.like(conv3_ops.conv3(
                x, self.weight, self.bias, self.kernel_weight(), pre, stats,
                softmax), x)
        # the stencil shard wrap: K1 on the halo slab, the owned planes
        slab = collectives.halo_exchange(x, mesh)
        out = conv3_ops.conv3(slab, self.weight, self.bias,
                              self.kernel_weight(), pre, stats, softmax,
                              dlim=collectives.halo_dlim(mesh, slab.shape[1]))
        if not stats:
            return out[:, 1:-1].contiguous()
        y, st = out
        return y[:, 1:-1].contiguous(), stats_slab_correct(y, st, mesh)


def stats_slab_correct(y: torch.Tensor, st: torch.Tensor,
                       mesh: sharding.Mesh) -> torch.Tensor:
    """A halo slab's K1 stats [B, 2, C] -> the volume's (the JAX package's
    ``_stats_slab_correct``): less the (sum, sumsq) of the slab's two halo
    output planes (duplicates of the neighbours' boundary planes, or the
    edge's zero-padding planes), then summed over the data row. The kernel
    sums every plane in its fixed order; these two planes are read again
    (the design of ``ops/conv3.py``'s note, chosen over a second plane
    range in the stats epilogue)."""
    halo = torch.stack([y[:, 0], y[:, -1]], dim=1).float()
    corr = torch.stack([halo.sum(dim=(1, 2, 3)),
                        (halo * halo).sum(dim=(1, 2, 3))], dim=1)
    return collectives.spatial_sum(st - corr, mesh)


class DownConv(_KernelConv):
    """Channel-preserving 2^3 stride-2 conv (torch Conv3d [C, C, 2, 2, 2])
    through K2."""

    def __init__(self, c: int, generator: Optional[torch.Generator] = None):
        super().__init__(torch_uniform_init((c, c, 2, 2, 2), 8 * c, generator),
                         torch_uniform_init((c,), 8 * c, generator))

    kernel_layout = staticmethod(bridges.down_kernel_weight)

    def forward(self, x: torch.Tensor, pre: Optional[Affine] = None):
        mesh = sharding.spatial_mesh(x)
        if mesh is not None and x.shape[1] % 2:
            # the slab's planes do not pair up: the whole volume on each
            # rank of the row, whose output is whole too
            x = collectives.gather_spatial(x, mesh)
            return sharding.mark_replicated(bridges.down_k2s2(
                x, self.weight, self.bias, self.kernel_weight(), pre))
        return sharding.like(bridges.down_k2s2(
            x, self.weight, self.bias, self.kernel_weight(), pre), x)


class TConv2(_KernelConv):
    """Channel-preserving 2^3 stride-2 ConvTranspose (torch ConvTranspose3d
    [C, C, 2, 2, 2]) through K3."""

    def __init__(self, c: int, generator: Optional[torch.Generator] = None):
        # torch takes a ConvTranspose's fan_in from weight dim 1: 8 * C_out
        super().__init__(torch_uniform_init((c, c, 2, 2, 2), 8 * c, generator),
                         torch_uniform_init((c,), 8 * c, generator))

    kernel_layout = staticmethod(bridges.up_kernel_weight)

    def forward(self, x: torch.Tensor):
        mesh = sharding.spatial_mesh(x)
        whole = mesh is None      # x is the whole volume on this rank
        if mesh is not None and x.shape[1] % 2:
            # the JAX wrap's fallback where D does not split in pairs
            x, whole = collectives.gather_spatial(x, mesh), True
        y = bridges.up_k2s2(x, self.weight, self.bias, self.kernel_weight())
        return spread(y) if whole else y


def spread(y: torch.Tensor) -> torch.Tensor:
    """A volume computed whole on every rank of a data row (an unsharded
    stage under a 'spatial' axis): this rank's D planes when its D splits,
    else the whole volume, tagged so."""
    mesh = sharding.current()
    if mesh is None or mesh.n_spatial == 1:
        return y
    if y.shape[1] % mesh.n_spatial == 0:
        return sharding.take_planes(mesh, y)
    return sharding.mark_replicated(y)


def mc_dropout(x: torch.Tensor, rate: float,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """Functional MC dropout, active whenever rate > 0: the semantics of
    torch ``F.dropout(p, training=True)`` as used for decoder and Seg MC
    sampling (joint_model.py:256-264, 379-387; counterpart of the JAX
    package's ``blocks.mc_dropout``). The keep mask is drawn from
    ``generator``, which must live on x's device. Under a mesh every rank
    draws the mask of the global batch (the generator stays in step on
    every rank) and keeps its slice: replicated stages get the same mask
    on every rank of a data row, each slab its own, and the masks are one
    process's."""
    if not rate:
        return x
    mesh = sharding.current()
    if mesh is None:
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) >= rate
    else:
        b = x.shape[0]
        full = (b * mesh.n_data, sharding.global_depth(x), *x.shape[2:])
        keep = torch.rand(full, generator=generator,
                          device=x.device) >= rate
        keep = keep[mesh.data_index * b:(mesh.data_index + 1) * b]
        if sharding.spatial_mesh(x) is not None:
            keep = sharding.take_planes(mesh, keep)
    return sharding.like(torch.where(keep, x / (1.0 - rate),
                                     torch.zeros_like(x)), x)


def _n_spatial(x: torch.Tensor) -> int:
    return sharding.global_voxels(x)


def _norm(y: torch.Tensor, soft: bool = False) -> torch.Tensor:
    """The norm route's InstanceNorm+ReLU of a conv output (InstanceNorm
    then softplus with `soft`): the volume's norm when y is a slab of
    it."""
    mesh = sharding.spatial_mesh(y)
    if soft:
        z = instance_norm_act(y, relu=False, mesh=mesh)
        return sharding.like(F.softplus(z.float()).to(y.dtype), y)
    return sharding.like(instance_norm_act(y, mesh=mesh), y)


class ConvNormAct(nn.Module):
    """conv3^3 + InstanceNorm + ReLU (reference ``Conv``). Returns the raw
    conv output and its norm affine: the norm+ReLU is applied by the
    consumer (the down1 entry's K2 prologue), so the normalized tensor is
    never stored. On the norm route, and for a soft stage (softplus in
    place of ReLU): the normalized output and None. norm_type 2 or 3: K1
    without the stats epilogue, ``Norm`` (key ``conv.1``), the activation;
    the normalized output and None."""

    def __init__(self, cin: int, cout: int,
                 generator: Optional[torch.Generator] = None,
                 soft: bool = False, norm_type: int = 1):
        super().__init__()
        self.soft = soft
        self.norm_type = norm_type
        self.conv = nn.ModuleDict({"0": Conv3(cin, cout, generator)})
        if norm_type != 1:
            self.conv["1"] = Norm(norm_type, cout)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[Affine]]:
        if self.norm_type != 1:
            return norm_act(self.conv["1"], self.conv["0"](x), self.soft), \
                None
        if use_pallas_norm():
            return _norm(self.conv["0"](x), self.soft), None
        y, st = self.conv["0"](x, stats=True)
        aff = affine_from_stats(st, _n_spatial(y))
        if self.soft:
            return apply_affine_relu(y, aff, soft=True), None
        return y, aff


def _norm_key(conv_key: str) -> str:
    """The reference's Sequential index of the norm after a conv."""
    return str(int(conv_key) + 1)


class DoubleConv(nn.Module):
    """3 x (conv3^3 + InstanceNorm + ReLU); the reference's ``DoubleConv``
    is a triple conv. Each norm's affine comes from the conv's stats
    epilogue and each norm+ReLU after the first two convs is the next
    conv's prologue. defer=True returns (raw, affine) for the chain-final
    norm instead of applying it. On the norm route every norm+ReLU is
    ``instance_norm_act`` and defer=True returns (normalized, None). A soft
    chain applies each norm with softplus after its conv (stats epilogue,
    no prologue) and defer=True returns (normalized, None). norm_type 2 or
    3: each conv, its ``Norm`` (keys ``conv.{1,4,7}``) and the activation;
    defer=True returns (normalized, None)."""

    _KEYS = ("0", "3", "6")  # reference indices (norm/ReLU at 1, 2, 4, ...)

    def __init__(self, cin: int, cout: int,
                 generator: Optional[torch.Generator] = None,
                 soft: bool = False, norm_type: int = 1):
        super().__init__()
        self.soft = soft
        self.norm_type = norm_type
        self.conv = nn.ModuleDict()
        for i, key in enumerate(self._KEYS):
            self.conv[key] = Conv3(cout if i else cin, cout, generator)
            if norm_type != 1:
                self.conv[_norm_key(key)] = Norm(norm_type, cout)

    def forward(self, x: torch.Tensor, defer: bool = False):
        if self.norm_type != 1:
            for key in self._KEYS:
                x = norm_act(self.conv[_norm_key(key)], self.conv[key](x),
                             self.soft)
            return (x, None) if defer else x
        if use_pallas_norm():
            for key in self._KEYS:
                x = _norm(self.conv[key](x), self.soft)
            return (x, None) if defer else x
        if self.soft:
            for key in self._KEYS:
                x, st = self.conv[key](x, stats=True)
                x = apply_affine_relu(x, affine_from_stats(
                    st, _n_spatial(x)), soft=True)
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
                 generator: Optional[torch.Generator] = None,
                 soft: bool = False, norm_type: int = 1):
        super().__init__()
        self.conv = nn.ModuleDict({"0": DownConv(cin, generator),
                                   "1": DoubleConv(cin, cout, generator,
                                                   soft, norm_type)})

    def forward(self, x: torch.Tensor, pre: Optional[Affine] = None):
        return self.conv["1"](self.conv["0"](x, pre=pre))


class Up(nn.Module):
    """K3 stride-2 ConvTranspose (channel-preserving) then
    DoubleConv(cin -> cout)."""

    def __init__(self, cin: int, cout: int,
                 generator: Optional[torch.Generator] = None,
                 soft: bool = False, norm_type: int = 1):
        super().__init__()
        self.conv = nn.ModuleDict({"0": TConv2(cin, generator),
                                   "1": DoubleConv(cin, cout, generator,
                                                   soft, norm_type)})

    def forward(self, x: torch.Tensor, defer: bool = False):
        return self.conv["1"](self.conv["0"](x), defer=defer)

