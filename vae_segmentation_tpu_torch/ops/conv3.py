"""K1: the 3^3 SAME stride-1 conv with its norm prologue and stats/softmax
epilogues, channels-last.

``conv3`` is what the models call. On a CPU tensor it runs ``conv3_plain``;
on a CUDA tensor it launches the hand-written kernel
(``kernels/csrc/conv3.cu``) or raises. It replaces the forward halves of
the TPU's Pallas stencil convs (``vae_segmentation_tpu/ops/pallas/
stencil3.py::_run_conv_grouped`` and ``::_run_conv``, i.e.
``conv3_stencil[_pre]``, ``conv3_stencil_folded[_pre]`` and
``conv3_stencil_folded_softmax[_pre]``). The source note in ``conv3.cu``
says what bounds it on the H100 and what its design does about that.

``conv3.launches`` counts kernel launches (never the plain version).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Affine = Tuple[torch.Tensor, torch.Tensor]


def kernel_weight(weight: torch.Tensor) -> torch.Tensor:
    """torch Conv3d weight [O, I, 3, 3, 3] -> the kernel's [27, I, O] bf16,
    tap = (kd * 3 + kh) * 3 + kw."""
    o, i = weight.shape[:2]
    return weight.detach().permute(2, 3, 4, 1, 0).reshape(27, i, o) \
        .to(torch.bfloat16).contiguous()


def _affine_relu(x: torch.Tensor, pre: Affine) -> torch.Tensor:
    s, t = pre
    return torch.relu(x.float() * s[:, None, None, None, :].float()
                      + t[:, None, None, None, :].float())


def _stats(y: torch.Tensor) -> torch.Tensor:
    y32 = y.float()
    return torch.stack([y32.sum(dim=(1, 2, 3)),
                        (y32 * y32).sum(dim=(1, 2, 3))], dim=1)


def conv3_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                pre: Optional[Affine] = None, stats: bool = False,
                softmax: bool = False):
    """The plain PyTorch version of K1, in f32 on the values it is given.

    x [B, D, H, W, Cin] in the compute dtype (bf16 or f32); weight is the
    torch layout [Cout, Cin, 3, 3, 3], rounded to x.dtype first (the kernel
    reads bf16 weights); bias [Cout] f32. pre = (s, t), each [B, Cin] f32:
    the input becomes relu(x * s + t) before the conv, and SAME pads that
    normalized tensor with zeros. Returns y [B, D, H, W, Cout] in x.dtype;
    with stats also the [B, 2, Cout] f32 (sum, sumsq) of the stored y; with
    softmax, y holds class probabilities over Cout."""
    if stats and softmax:
        raise ValueError("conv3: stats and softmax epilogues are exclusive")
    xin = x.float() if pre is None else _affine_relu(x, pre)
    w = weight.to(x.dtype).float()
    y = F.conv3d(xin.permute(0, 4, 1, 2, 3), w, bias.float(), padding=1)
    y = y.permute(0, 2, 3, 4, 1)
    if softmax:
        y = torch.softmax(y, dim=-1)
    y = y.to(x.dtype).contiguous()
    return (y, _stats(y)) if stats else y


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def check_tensor(who: str, name: str, t: torch.Tensor, device, dtype,
                 shape) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device`: what a kernel reads through a raw pointer."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{who}: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def conv3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          kweight: Optional[torch.Tensor] = None,
          pre: Optional[Affine] = None, stats: bool = False,
          softmax: bool = False):
    """K1. Same contract as ``conv3_plain``; on CUDA, x must be bf16 and
    ``kweight`` the weight in the kernel's layout (``kernel_weight``),
    converted once by the owning module."""
    if x.device.type == "cpu":
        return conv3_plain(x, weight, bias, pre, stats, softmax)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv3: no kernel for device {x.device}")
    from vae_segmentation_tpu_torch.ops.kernels import build

    if x.dim() != 5:
        raise ValueError(f"conv3: x must be [B, D, H, W, C], got {x.shape}")
    b, d, h, w, cin = x.shape
    if kweight is None:
        raise ValueError("conv3: CUDA launch needs the kernel-layout weight")
    cout = kweight.shape[-1]
    dev = x.device
    check_tensor("conv3", "x", x, dev, torch.bfloat16, (b, d, h, w, cin))
    check_tensor("conv3", "kweight", kweight, dev, torch.bfloat16,
                 (27, cin, cout))
    check_tensor("conv3", "bias", bias, dev, torch.float32, (cout,))
    s = t = None
    if pre is not None:
        s, t = pre[0].contiguous(), pre[1].contiguous()
        check_tensor("conv3", "s", s, dev, torch.float32, (b, cin))
        check_tensor("conv3", "t", t, dev, torch.float32, (b, cin))
    if stats and softmax:
        raise ValueError("conv3: stats and softmax epilogues are exclusive")
    y = torch.empty((b, d, h, w, cout), dtype=torch.bfloat16, device=dev)
    st = torch.zeros((b, 2, cout), dtype=torch.float32, device=dev) \
        if stats else None
    lib = build.library("conv3")
    with torch.cuda.device(dev):
        rc = lib.vaeseg_conv3(
            x.data_ptr(), kweight.data_ptr(), bias.data_ptr(), _ptr(s),
            _ptr(t), y.data_ptr(), _ptr(st), b, d, h, w, cin, cout,
            int(softmax), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("conv3 kernel launch failed: "
                           + lib.vaeseg_error_string(rc).decode())
    conv3.launches += 1
    return (y, st) if stats else y


conv3.launches = 0
