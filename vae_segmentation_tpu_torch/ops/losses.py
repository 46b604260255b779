"""Losses and metrics on channels-last masks [B, D, H, W, C], reductions
in f32.

Counterpart of vae_segmentation_tpu/ops/losses.py (dice, binarize,
confident_binarize, onehot_argmax, soft_dice_per_class, avg_dsc, kl_loss,
one_hot_label), which mirrors the reference's utils/evaluation.py:6-80 and
main_source.py:150-182,390-392. The class axis is last; reductions run over
every axis but batch and class.

Two hand-written kernels live here (``kernels/csrc/losses.cu``), each with
its plain version, launched on CUDA tensors and counted in ``.launches``:
``softmax_vjp`` replaces the TPU's ``vae_segmentation_tpu/ops/pallas/
softmaxvjp.py::softmax_group_vjp`` (the cotangent of K1's softmax
epilogue) and ``dice_sums`` replaces ``ops/pallas/dicesums.py::_run`` (every
sum the adaptation loss's three soft Dices need, each volume read once).
``multi_soft_dice`` is the differentiable use of the latter.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from vae_segmentation_tpu_torch.ops.conv3 import check_tensor, raise_if

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
    """Per-sample, per-class soft Dice: [B, ..., C] x2 -> [B, C], f32."""
    dims = _reduce_dims(source)
    s32, t32 = source.float(), target.float()
    inter = (s32 * t32).sum(dim=dims)
    denom = s32.sum(dim=dims) + t32.sum(dim=dims)
    return 2.0 * inter / (denom + eps)


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
    lib = build.library("losses")
    with torch.cuda.device(y.device):
        rc = lib.vaeseg_softmax_vjp(
            g.data_ptr(), y.data_ptr(), out.data_ptr(),
            y.numel() // y.shape[-1], y.shape[-1],
            torch.cuda.current_stream(y.device).cuda_stream)
    raise_if(rc, lib, "softmax_vjp")
    softmax_vjp.launches += 1
    return out


# ---- fused Dice sums

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


def dice_sums(pred: torch.Tensor, targets: Sequence[torch.Tensor]
              ) -> torch.Tensor:
    """Same contract as ``dice_sums_plain`` for K <= 3 targets; on CUDA,
    all volumes must be contiguous bf16 of one shape."""
    if not 1 <= len(targets) <= MAX_DICE_TARGETS:
        raise ValueError(f"dice_sums: 1 to {MAX_DICE_TARGETS} targets, got "
                         f"{len(targets)}")
    if pred.device.type == "cpu":
        return dice_sums_plain(pred, targets)
    if pred.device.type != "cuda":
        raise RuntimeError(f"dice_sums: no kernel for device {pred.device}")
    from vae_segmentation_tpu_torch.ops.kernels import build

    _check_same("dice_sums", pred, targets)
    b, c = pred.shape[0], pred.shape[-1]
    k = len(targets)
    out = torch.zeros((b, 1 + 2 * k, c), dtype=torch.float32,
                      device=pred.device)
    ptrs = [t.data_ptr() for t in targets] + [None] * (MAX_DICE_TARGETS - k)
    lib = build.library("losses")
    with torch.cuda.device(pred.device):
        rc = lib.vaeseg_dice_sums(
            pred.data_ptr(), *ptrs, out.data_ptr(), b,
            pred.numel() // (b * c), c, k,
            torch.cuda.current_stream(pred.device).cuda_stream)
    raise_if(rc, lib, "dice_sums")
    dice_sums.launches += 1
    return out


class _DiceSumsFn(torch.autograd.Function):
    """``dice_sums`` with the backward the JAX package leaves to XLA
    (dicesums.py:130-141): d sum(p) / dp = 1, d sum(p * t) / dp = t, plain
    broadcasts."""

    @staticmethod
    def forward(ctx, pred, *targets):
        ctx.save_for_backward(pred, *targets)
        return dice_sums(pred, targets)

    @staticmethod
    def backward(ctx, g):
        pred, *targets = ctx.saved_tensors
        g = g.float()
        lead = (slice(None),) + (None,) * (pred.dim() - 2)

        def row(i):
            return g[:, i][lead]

        dp = row(0).expand(pred.shape) if ctx.needs_input_grad[0] else None
        dts: List = []
        for i, t in enumerate(targets):
            if dp is not None:
                dp = dp + row(2 + 2 * i) * t.float()
            dts.append((row(1 + 2 * i) + row(2 + 2 * i) * pred.float())
                       .to(t.dtype) if ctx.needs_input_grad[1 + i] else None)
        return (None if dp is None else dp.to(pred.dtype), *dts)


def multi_soft_dice(pred: torch.Tensor, targets: Sequence[torch.Tensor],
                    eps: float = EVAL_EPS) -> List[torch.Tensor]:
    """Per-sample, per-class soft Dice [B, C] of pred against each target
    (``soft_dice_per_class``'s formula), all volumes read once by
    ``dice_sums``; differentiable in pred and in any target that requires
    a gradient."""
    sums = _DiceSumsFn.apply(pred, *targets)
    return [2.0 * sums[:, 2 + 2 * i] / (sums[:, 0] + sums[:, 1 + 2 * i] + eps)
            for i in range(len(targets))]


softmax_vjp.launches = 0
dice_sums.launches = 0
