"""Losses and metrics on channels-last masks [B, D, H, W, C], reductions
in f32.

Counterpart of vae_segmentation_tpu/ops/losses.py (dice, binarize,
confident_binarize, onehot_argmax, soft_dice_per_class, avg_dsc, kl_loss,
bce, one_hot_label), which mirrors the reference's utils/evaluation.py:6-80 and
main_source.py:150-182,390-392. The class axis is last; reductions run over
every axis but batch and class.

Three hand-written kernels live here (``kernels/csrc/losses.cu``), each
with its plain version, launched on CUDA tensors and counted in
``.launches``: ``softmax_vjp`` replaces the TPU's ``vae_segmentation_tpu/
ops/pallas/softmaxvjp.py::softmax_group_vjp`` (the cotangent of K1's
softmax epilogue; its grid and its 4-voxel items from
``softmax_vjp_plan``); ``dice_sums`` replaces ``ops/pallas/dicesums.py::
_run`` (every sum the adaptation loss's three soft Dices need, each volume
read once) and ``dice_sums_vjp`` the VJP attached to it there
(dicesums.py::_bwd), both over the 16-byte items of ``dice_sums_plan``.
``multi_soft_dice`` is their differentiable use.

Under a mesh (``parallel.sharding.active``) a rank holds a slice of the
batch: the per-item sums of its slab are added over the data row and
gathered over 'data' (``collectives.global_sums``, the JAX package's
dicesums.py:86-123 psum), so every nonlinear term of a loss sees the global
batch, as in one process, on every rank.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence

import torch
import torch.nn.functional as F

from vae_segmentation_tpu_torch.ops.conv3 import (
    check_tensor, on_device, raise_if, sm_count)
from vae_segmentation_tpu_torch.parallel import collectives, sharding

# eps used by utils/evaluation.py:72-79 (the target-domain trainer)
EVAL_EPS = 1e-6
# eps used by the duplicated copy in main_source.py:174-181 (source trainer)
SOURCE_EPS = 1e-4


def _reduce_dims(x: torch.Tensor):
    return tuple(range(1, x.dim() - 1))


def dice(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Global soft Dice over all elements (utils/evaluation.py:6-7)."""
    a32, b32 = a.float(), b.float()
    return 2.0 * (a32 * b32).sum() / (a32.sum() + b32.sum() + eps)


def binarize(a: torch.Tensor) -> torch.Tensor:
    """Hard threshold at 0.5, keeping the dtype (utils/evaluation.py:9-10)."""
    return (a >= 0.5).to(a.dtype)


def confident_binarize(a: torch.Tensor, hi: float = 0.8,
                       lo: float = 0.2) -> torch.Tensor:
    """Push confident probabilities to {0, 1}, keep the rest soft
    (utils/evaluation.py:12-18)."""
    return torch.where(a > hi, torch.ones((), dtype=a.dtype, device=a.device),
                       torch.where(a < lo, torch.zeros((), dtype=a.dtype,
                                                       device=a.device), a))


def onehot_argmax(probs: torch.Tensor) -> torch.Tensor:
    """Argmax over the class axis (first max on ties, like jnp.argmax),
    re-expanded to one-hot in the input dtype."""
    n_class = probs.shape[-1]
    return F.one_hot(torch.argmax(probs, dim=-1), n_class).to(probs.dtype)


def soft_dice_per_class(source: torch.Tensor, target: torch.Tensor,
                        eps: float = EVAL_EPS) -> torch.Tensor:
    """Per-sample, per-class soft Dice: [B, ..., C] x2 -> [B, C], f32 (of
    the global batch under a mesh)."""
    dims = _reduce_dims(source)
    s32, t32 = source.float(), target.float()
    sums = torch.stack([(s32 * t32).sum(dim=dims), s32.sum(dim=dims),
                        t32.sum(dim=dims)], dim=1)
    sums = collectives.global_sums(sums, source, sharding.current())
    return 2.0 * sums[:, 0] / (sums[:, 1] + sums[:, 2] + eps)


def avg_dsc(source: torch.Tensor, target: torch.Tensor, *,
            binary: bool = False, botindex: int = 0, topindex: int = 2,
            return_mean: bool = True, eps: float = EVAL_EPS) -> torch.Tensor:
    """Mean soft Dice over classes [botindex:topindex]
    (utils/evaluation.py:48-80). binary: argmax-one-hot both masks first.
    Scalar if return_mean, else per sample [B]. With C == 1 the class slice
    is skipped, as in the reference."""
    if binary:
        source = onehot_argmax(source)
        target = onehot_argmax(target)
    per_class = soft_dice_per_class(source, target, eps)
    if source.shape[-1] > 1:
        per_class = per_class[:, botindex:topindex]
    if return_mean:
        return per_class.mean()
    return per_class.mean(dim=1)


def one_hot_label(label: torch.Tensor, n_class: int,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Class-valued label volume [B, D, H, W] -> one-hot [B, D, H, W, C]
    (main_source.py:390-392), by float equality as the JAX package does."""
    classes = torch.arange(n_class, dtype=label.dtype, device=label.device)
    return (label[..., None] == classes).to(dtype)


def kl_loss(mean: torch.Tensor, std: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """VAE KL to a standard normal in the reference's parameterization
    (utils/evaluation.py:42-45): mean over the batch of
    0.5 * (sum std^2 + sum mean^2 - 2 * sum log(std + 1e-5))."""
    mean, std = mean.float(), std.float()
    per_sample = 0.5 * ((std ** 2).sum(dim=1) + (mean ** 2).sum(dim=1)
                        - 2.0 * torch.log(std + eps).sum(dim=1))
    return per_sample.mean()


def bce(source: torch.Tensor, target: torch.Tensor,
        eps: float = 1e-12) -> torch.Tensor:
    """Binary cross-entropy of probabilities (utils/evaluation.py:29-39;
    losses.py:122-128 of the JAX package): torch ``nn.BCELoss``'s mean over
    every element, source clamped to [eps, 1 - eps], f32. No step calls
    it, as in the JAX package."""
    source = torch.clamp(source.float(), eps, 1.0 - eps)
    target = target.float()
    return -(target * torch.log(source)
             + (1.0 - target) * torch.log1p(-source)).mean()


# ---- softmax VJP (the cotangent of K1's softmax epilogue)


def softmax_vjp_plain(g: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(g - sum_class(g * y)) * y in f32, stored in y.dtype: the cotangent
    of the logits from the cotangent g of the probabilities y (class axis
    last)."""
    g32, y32 = g.float(), y.float()
    return ((g32 - (g32 * y32).sum(dim=-1, keepdim=True)) * y32).to(y.dtype)


def _check_same(who: str, ref: torch.Tensor, others: Sequence[torch.Tensor]):
    if ref.dim() < 2:
        raise ValueError(f"{who}: needs [B, ..., C], got {tuple(ref.shape)}")
    for i, t in enumerate((ref, *others)):
        check_tensor(who, f"tensor {i}", t, ref.device, torch.bfloat16,
                     tuple(ref.shape))


# the plan of losses.cu's softmax_vjp kernels
SOFTMAX_THREADS = 256
SOFTMAX_ITEMS_A_THREAD = 4      # items (or voxels) a thread, about
SOFTMAX_BLOCKS_A_SM = 8         # blocks an SM, at most


@functools.lru_cache(maxsize=None)
def softmax_vjp_plan(nvox: int, c: int, vec: bool, sms: int) -> dict:
    """The plan of one ``softmax_vjp`` call on [nvox, c]: ``items``, the
    4-voxel items of the vector path (c == 2 and g, y, out 16-byte aligned,
    `vec`; 16 bytes of each), else 0; the ``tail`` voxels from 4 * items on
    take the element path in the same launch; ``blocks`` of ``threads``,
    sized for about ``SOFTMAX_ITEMS_A_THREAD`` items (or voxels) a thread,
    at most ``SOFTMAX_BLOCKS_A_SM`` blocks an SM. Thread i takes items and
    tail voxels i + k ``stride``. The result is cached: do not modify
    it."""
    if nvox < 1 or c < 1:
        raise ValueError(f"softmax_vjp: no call on [{nvox}, {c}]")
    items = nvox // 4 if vec and c == 2 else 0
    tail = nvox - 4 * items
    threads = SOFTMAX_THREADS
    blocks = min(-(-(items + tail) // (threads * SOFTMAX_ITEMS_A_THREAD)),
                 SOFTMAX_BLOCKS_A_SM * sms)
    return {"items": items, "tail": tail, "blocks": blocks,
            "threads": threads, "stride": blocks * threads}


def softmax_vjp(g: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Same contract as ``softmax_vjp_plain``; on CUDA, g and y must be
    contiguous bf16 of one shape."""
    if y.device.type == "cpu":
        return softmax_vjp_plain(g, y)
    if y.device.type != "cuda":
        raise RuntimeError(f"softmax_vjp: no kernel for device {y.device}")
    from vae_segmentation_tpu_torch.ops.kernels import build

    _check_same("softmax_vjp", y, (g,))
    out = torch.empty_like(y)
    c = y.shape[-1]
    nvox = y.numel() // c
    plan = softmax_vjp_plan(
        nvox, c, all(t.data_ptr() % 16 == 0 for t in (g, y, out)),
        sm_count(y.device.index or 0))
    lib = build.library("losses")
    with torch.cuda.device(y.device):
        rc = lib.vaeseg_softmax_vjp(
            g.data_ptr(), y.data_ptr(), out.data_ptr(), nvox, c,
            plan["items"], plan["blocks"],
            torch.cuda.current_stream(y.device).cuda_stream)
    raise_if(rc, lib, "softmax_vjp")
    softmax_vjp.launches += 1
    return out


# ---- fused Dice sums and their VJP

MAX_DICE_TARGETS = 3


def dice_sums_plain(pred: torch.Tensor, targets: Sequence[torch.Tensor]
                    ) -> torch.Tensor:
    """[B, 1 + 2K, C] f32 per batch and class: row 0 sum(pred), row
    1 + 2k sum(t_k), row 2 + 2k sum(pred * t_k), over every axis but the
    first and the last."""
    dims = _reduce_dims(pred)
    p32 = pred.float()
    rows = [p32.sum(dim=dims)]
    for t in targets:
        t32 = t.float()
        rows += [t32.sum(dim=dims), (p32 * t32).sum(dim=dims)]
    return torch.stack(rows, dim=1)


# the plan of losses.cu's dice kernels
DICE_THREADS = 256
DICE_ITEMS_A_THREAD = 4         # items (or elements) a thread, about
DICE_BLOCKS_A_SM = 8            # blocks an SM over the batch, at most


@functools.lru_cache(maxsize=None)
def dice_sums_plan(b: int, nvox: int, c: int, k: int, vec: bool,
                   sms: int) -> dict:
    """The plan of one ``dice_sums`` or ``dice_sums_vjp`` call on K = `k`
    targets of [b, nvox, c]: ``items``, a batch entry's 16-byte items of the
    vector path (8 bf16: 8 // c voxels of c classes; c dividing 8 and every
    volume 16-byte aligned, `vec`), else 0; the ``tail`` elements of a batch
    entry from 8 * items on take the element path in the same launch;
    ``blocks`` of ``threads`` a batch entry, sized for about
    ``DICE_ITEMS_A_THREAD`` items (or elements) a thread, at most
    ``DICE_BLOCKS_A_SM`` blocks an SM over the batch, and a multiple of c
    over the threads (``blocks * threads`` a multiple of c: a thread's
    elements keep one class); thread i takes items and tail elements i + j
    ``stride``. ``rows`` = 1 + 2k sums; the forward's f32 ``workspace``
    holds its [b, rows, c] result and the blocks' [b, blocks, rows, c]
    partials. The result is cached: do not modify it."""
    if b < 1 or nvox < 1 or c < 1 or not 1 <= k <= MAX_DICE_TARGETS:
        raise ValueError(f"dice_sums: no call on [{b}, {nvox}, {c}] with "
                         f"{k} targets")
    n = nvox * c
    items = n // 8 if vec and 8 % c == 0 else 0
    tail = n - 8 * items
    threads = DICE_THREADS
    blocks = min(-(-(items + tail) // (threads * DICE_ITEMS_A_THREAD)),
                 -(-DICE_BLOCKS_A_SM * sms // b))
    step = c // math.gcd(c, threads)
    blocks = -(-blocks // step) * step
    rows = 1 + 2 * k
    return {"items": items, "tail": tail, "blocks": blocks,
            "threads": threads, "stride": blocks * threads, "rows": rows,
            "workspace": b * rows * c * (1 + blocks)}


def _dice_vec(vols: Sequence[torch.Tensor]) -> bool:
    """Whether every volume (and so every batch entry's base, 8 elements a
    16-byte item) is 16-byte aligned."""
    b = vols[0].shape[0]
    n = vols[0].numel() // b
    return (b == 1 or n % 8 == 0) and all(t.data_ptr() % 16 == 0
                                           for t in vols)


def _dice_args(who: str, pred: torch.Tensor, targets: Sequence[torch.Tensor]):
    """Raise on a call no dice kernel or plain version takes."""
    if not 1 <= len(targets) <= MAX_DICE_TARGETS:
        raise ValueError(f"{who}: 1 to {MAX_DICE_TARGETS} targets, got "
                         f"{len(targets)}")
    if pred.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{who}: no kernel for device {pred.device}")


def dice_sums(pred: torch.Tensor, targets: Sequence[torch.Tensor]
              ) -> torch.Tensor:
    """Same contract as ``dice_sums_plain`` for K <= 3 targets; on CUDA,
    all volumes must be contiguous bf16 of one shape."""
    _dice_args("dice_sums", pred, targets)
    if pred.device.type == "cpu":
        return dice_sums_plain(pred, targets)
    from vae_segmentation_tpu_torch.ops.kernels import build

    _check_same("dice_sums", pred, targets)
    b, c = pred.shape[0], pred.shape[-1]
    k = len(targets)
    nvox = pred.numel() // (b * c)
    dev = pred.device
    plan = dice_sums_plan(b, nvox, c, k, _dice_vec((pred, *targets)),
                          sm_count(dev.index or 0))
    # the result and the blocks' partials (summed across the blocks in a
    # fixed order) in one allocation
    work = torch.empty(plan["workspace"], dtype=torch.float32, device=dev)
    out = work[:b * plan["rows"] * c].view(b, plan["rows"], c)
    ptrs = [t.data_ptr() for t in targets] + [None] * (MAX_DICE_TARGETS - k)
    lib = build.library("losses")
    with on_device(dev):
        rc = lib.vaeseg_dice_sums(
            pred.data_ptr(), *ptrs, work.data_ptr() + 4 * out.numel(),
            out.data_ptr(), b, nvox, c, k, plan["items"], plan["blocks"],
            torch.cuda.current_stream(dev).cuda_stream)
    raise_if(rc, lib, "dice_sums")
    dice_sums.launches += 1
    return out


def dice_sums_vjp_plain(g: torch.Tensor, pred: torch.Tensor,
                        targets: Sequence[torch.Tensor], need_pred: bool,
                        need_targets: Sequence[bool]) -> tuple:
    """The VJP of ``dice_sums`` for the cotangent g [B, 1 + 2K, C] of its
    sums (dicesums.py:130-141): (dp, d t_0, ..., d t_{K-1}), None where the
    `need_*` flag is False; dp = ((g0 + g2 t0) + g4 t1) + g6 t2 and
    d t_k = g(1 + 2k) + g(2 + 2k) pred, g broadcast over the voxels, f32
    math, stored in the volumes' dtypes."""
    g = g.float()
    lead = (slice(None),) + (None,) * (pred.dim() - 2)

    def row(i):
        return g[:, i][lead]

    dp = row(0).expand(pred.shape) if need_pred else None
    dts: List = []
    for i, (t, need) in enumerate(zip(targets, need_targets)):
        if dp is not None:
            dp = dp + row(2 + 2 * i) * t.float()
        dts.append((row(1 + 2 * i) + row(2 + 2 * i) * pred.float())
                   .to(t.dtype) if need else None)
    return (None if dp is None else dp.to(pred.dtype), *dts)


def dice_sums_vjp(g: torch.Tensor, pred: torch.Tensor,
                  targets: Sequence[torch.Tensor], need_pred: bool = True,
                  need_targets: Sequence[bool] = (True,) * MAX_DICE_TARGETS
                  ) -> tuple:
    """Same contract as ``dice_sums_vjp_plain`` (`need_targets` one flag a
    target, or more); on CUDA the volumes must be contiguous bf16 of one
    shape and g [B, 1 + 2K, C] f32: one launch writes every gradient that
    is needed, with the plain version's bits."""
    _dice_args("dice_sums_vjp", pred, targets)
    need_targets = tuple(bool(f) for f in need_targets[:len(targets)])
    if pred.device.type == "cpu":
        return dice_sums_vjp_plain(g, pred, targets, need_pred, need_targets)
    from vae_segmentation_tpu_torch.ops.kernels import build

    _check_same("dice_sums_vjp", pred, targets)
    b, c = pred.shape[0], pred.shape[-1]
    k = len(targets)
    dev = pred.device
    check_tensor("dice_sums_vjp", "g", g, dev, torch.float32,
                 (b, 1 + 2 * k, c))
    outs = [torch.empty_like(pred) if need else None
            for need in (need_pred, *need_targets)]
    if not any(o is not None for o in outs):
        return tuple(outs)
    nvox = pred.numel() // (b * c)
    vols = [pred, *targets, *(o for o in outs if o is not None)]
    plan = dice_sums_plan(b, nvox, c, k, _dice_vec(vols),
                          sm_count(dev.index or 0))
    ptrs = [t.data_ptr() for t in targets] + [None] * (MAX_DICE_TARGETS - k)
    optrs = [None if o is None else o.data_ptr() for o in outs] \
        + [None] * (MAX_DICE_TARGETS - k)
    lib = build.library("losses")
    with on_device(dev):
        rc = lib.vaeseg_dice_vjp(
            pred.data_ptr(), *ptrs, g.data_ptr(), *optrs, b, nvox, c, k,
            plan["items"], plan["blocks"],
            torch.cuda.current_stream(dev).cuda_stream)
    raise_if(rc, lib, "dice_sums_vjp")
    dice_sums_vjp.launches += 1
    return tuple(outs)


class _DiceSumsFn(torch.autograd.Function):
    """``dice_sums`` with the backward the JAX package leaves to XLA
    (dicesums.py:130-141), ``dice_sums_vjp``: d sum(p) / dp = 1,
    d sum(p * t) / dp = t, plain broadcasts, one launch on the card."""

    @staticmethod
    def forward(ctx, pred, *targets):
        ctx.save_for_backward(pred, *targets)
        return dice_sums(pred, targets)

    @staticmethod
    def backward(ctx, g):
        pred, *targets = ctx.saved_tensors
        if pred.device.type == "cuda":
            g = g.float().contiguous()
        return dice_sums_vjp(g, pred, targets, ctx.needs_input_grad[0],
                             ctx.needs_input_grad[1:])


def multi_soft_dice(pred: torch.Tensor, targets: Sequence[torch.Tensor],
                    eps: float = EVAL_EPS) -> List[torch.Tensor]:
    """Per-sample, per-class soft Dice [B, C] of pred against each target
    (``soft_dice_per_class``'s formula), all volumes read once by
    ``dice_sums``; differentiable in pred and in any target that requires
    a gradient. Under a mesh, [B, C] of the global batch."""
    sums = collectives.global_sums(_DiceSumsFn.apply(pred, *targets), pred,
                                   sharding.current())
    return [2.0 * sums[:, 2 + 2 * i] / (sums[:, 0] + sums[:, 1 + 2 * i] + eps)
            for i in range(len(targets))]


softmax_vjp.launches = 0
dice_sums.launches = 0
dice_sums_vjp.launches = 0
