"""K2 and K3 and their backwards: the stage-boundary bridges, channels-last,
differentiable.

``down_k2s2`` (K2) is the Down entry: a 2^3 stride-2 VALID conv + bias with
an optional norm+ReLU prologue. ``up_k2s2`` (K3) is the Up entry: a 2^3
stride-2 ConvTranspose + bias in torch's semantics. Both are
``torch.autograd.Function``s: the forward is ``down_k2s2_op`` /
``up_k2s2_op`` (``kernels/csrc/bridge.cu``), replacing the forwards of the
TPU's ``vae_segmentation_tpu/ops/pallas/upbridge.py::down_bridge_w``,
``::down_bridge_w_pre`` and ``::up_bridge_w``; the backward is
``down_k2s2_bwd`` / ``up_k2s2_bwd`` (``kernels/csrc/bridge_bwd.cu``),
replacing ``upbridge.py::_run_down_bwd``, ``::_run_down_bwd_pre`` and
``::_run_bwd``: dx, dk, db and, with the prologue, its ds and dt. Each
wrapper launches its kernel on a CUDA tensor (or raises) and runs its plain
version on a CPU tensor; the source notes say what bounds them on the H100.

``down_k2s2.launches``, ``up_k2s2.launches``, ``down_k2s2_bwd.launches``
and ``up_k2s2_bwd.launches`` count kernel launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from vae_segmentation_tpu_torch.ops.conv3 import (
    _affine_relu, _pre_activation, _ptr, check_affine, check_tensor, raise_if,
    tap_major)

Affine = Tuple[torch.Tensor, torch.Tensor]


def down_kernel_weight(weight: torch.Tensor) -> torch.Tensor:
    """torch Conv3d weight [O, I, 2, 2, 2] -> the kernel's [8, I, O] bf16,
    a = (ad * 2 + ah) * 2 + aw."""
    return tap_major(weight.detach().permute(2, 3, 4, 1, 0))


def up_kernel_weight(weight: torch.Tensor) -> torch.Tensor:
    """torch ConvTranspose3d weight [I, O, 2, 2, 2] -> the kernel's
    [8, I, O] bf16."""
    return tap_major(weight.detach().permute(2, 3, 4, 0, 1))


def down_k2s2_plain(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, pre: Optional[Affine] = None
                    ) -> torch.Tensor:
    """Plain K2 in f32: y = conv3d(relu(x * s + t) or x, weight, stride 2)
    + bias, weight [Cout, Cin, 2, 2, 2] rounded to x.dtype, y in x.dtype."""
    xin = x.float() if pre is None else _affine_relu(x, pre)
    y = F.conv3d(xin.permute(0, 4, 1, 2, 3), weight.to(x.dtype).float(),
                 bias.float(), stride=2)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def up_k2s2_plain(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """Plain K3 in f32: y = conv_transpose3d(x, weight, stride 2) + bias,
    weight [Cin, Cout, 2, 2, 2] rounded to x.dtype, y in x.dtype."""
    y = F.conv_transpose3d(x.float().permute(0, 4, 1, 2, 3),
                           weight.to(x.dtype).float(), bias.float(), stride=2)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def _prepare(x, kweight, bias, who):
    if x.device.type != "cuda":
        raise RuntimeError(f"{who}: no kernel for device {x.device}")
    if x.dim() != 5:
        raise ValueError(f"{who}: x must be [B, D, H, W, C], got {x.shape}")
    if kweight is None:
        raise ValueError(f"{who}: CUDA launch needs the kernel-layout weight")
    b, d, h, w, cin = x.shape
    cout = kweight.shape[-1]
    dev = x.device
    check_tensor(who, "x", x, dev, torch.bfloat16, (b, d, h, w, cin))
    check_tensor(who, "kweight", kweight, dev, torch.bfloat16,
                 (8, cin, cout))
    check_tensor(who, "bias", bias, dev, torch.float32, (cout,))
    return b, d, h, w, cin, cout


def down_k2s2_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 kweight: Optional[torch.Tensor] = None,
                 pre: Optional[Affine] = None) -> torch.Tensor:
    """K2. Same contract as ``down_k2s2_plain``; on CUDA, x must be bf16
    and ``kweight`` the ``down_kernel_weight`` layout."""
    if x.device.type == "cpu":
        return down_k2s2_plain(x, weight, bias, pre)
    from vae_segmentation_tpu_torch.ops.kernels import build

    b, d, h, w, cin, cout = _prepare(x, kweight, bias, "down_k2s2")
    s = t = None
    if pre is not None:
        s, t = check_affine("down_k2s2", pre, x.device, b, cin)
    y = torch.empty((b, d // 2, h // 2, w // 2, cout), dtype=torch.bfloat16,
                    device=x.device)
    lib = build.library("bridge")
    with torch.cuda.device(x.device):
        rc = lib.vaeseg_down_k2s2(
            x.data_ptr(), kweight.data_ptr(), bias.data_ptr(), _ptr(s),
            _ptr(t), y.data_ptr(),
            b, d, h, w, cin, cout,
            torch.cuda.current_stream(x.device).cuda_stream)
    raise_if(rc, lib, "down_k2s2")
    down_k2s2.launches += 1
    return y


def up_k2s2_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               kweight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3. Same contract as ``up_k2s2_plain``; on CUDA, x must be bf16 and
    ``kweight`` the ``up_kernel_weight`` layout."""
    if x.device.type == "cpu":
        return up_k2s2_plain(x, weight, bias)
    from vae_segmentation_tpu_torch.ops.kernels import build

    b, d, h, w, cin, cout = _prepare(x, kweight, bias, "up_k2s2")
    y = torch.empty((b, 2 * d, 2 * h, 2 * w, cout), dtype=torch.bfloat16,
                    device=x.device)
    lib = build.library("bridge")
    with torch.cuda.device(x.device):
        rc = lib.vaeseg_up_k2s2(
            x.data_ptr(), kweight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            b, d, h, w, cin, cout,
            torch.cuda.current_stream(x.device).cuda_stream)
    raise_if(rc, lib, "up_k2s2")
    up_k2s2.launches += 1
    return y


def down_k2s2_bwd_plain(x: torch.Tensor, gy: torch.Tensor,
                        weight: torch.Tensor, pre: Optional[Affine] = None):
    """Plain backward of K2 in f32: (dx in x.dtype, dk [8, Cin, Cout] f32
    in the kernel layout, db [Cout] f32, dst). With the prologue, dx =
    gm * s with gm the cotangent of relu(x * s + t) masked where
    x * s + t > 0, and dst [B, 2, Cin] f32 = (sum gm * x, sum gm); without,
    dst is None."""
    cout, cin = weight.shape[:2]
    xin = x.float() if pre is None else _affine_relu(x, pre)
    g = gy.float().permute(0, 4, 1, 2, 3)
    gm = F.conv_transpose3d(g, weight.to(x.dtype).float(), stride=2) \
        .permute(0, 2, 3, 4, 1)
    dst = None
    if pre is not None:
        gm = torch.where(_pre_activation(x, pre) > 0, gm,
                         torch.zeros((), dtype=gm.dtype, device=gm.device))
        dst = torch.stack([(gm * x.float()).sum(dim=(1, 2, 3)),
                           gm.sum(dim=(1, 2, 3))], dim=1)
        gm = gm * pre[0][:, None, None, None, :].float()
    dw = torch.nn.grad.conv3d_weight(xin.permute(0, 4, 1, 2, 3),
                                     (cout, cin, 2, 2, 2), g, stride=2)
    dk = dw.permute(2, 3, 4, 1, 0).reshape(8, cin, cout).contiguous()
    return gm.to(x.dtype).contiguous(), dk, g.sum(dim=(0, 2, 3, 4)), dst


def up_k2s2_bwd_plain(x: torch.Tensor, gy: torch.Tensor,
                      weight: torch.Tensor):
    """Plain backward of K3 in f32: (dx in x.dtype, dk [8, Cin, Cout] f32
    in the kernel layout, db [Cout] f32)."""
    cin, cout = weight.shape[:2]
    g = gy.float().permute(0, 4, 1, 2, 3)
    dx = F.conv3d(g, weight.to(x.dtype).float(), stride=2)
    dw = torch.nn.grad.conv3d_weight(g, (cin, cout, 2, 2, 2),
                                     x.float().permute(0, 4, 1, 2, 3),
                                     stride=2)
    dk = dw.permute(2, 3, 4, 0, 1).reshape(8, cin, cout).contiguous()
    return (dx.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous(), dk,
            g.sum(dim=(0, 2, 3, 4)))


def _launch_bwd(who: str, up: bool, x, gy, kweight, pre, need_dx, need_dk):
    """Shared launch of ``bridge_bwd.cu``: x is the forward's input (the
    coarse grid for K3, the fine grid for K2), gy the output cotangent."""
    if x.device.type != "cuda":
        raise RuntimeError(f"{who}: no kernel for device {x.device}")
    from vae_segmentation_tpu_torch.ops.kernels import build

    if x.dim() != 5:
        raise ValueError(f"{who}: x must be [B, D, H, W, C], got {x.shape}")
    if kweight is None:
        raise ValueError(f"{who}: CUDA launch needs the kernel-layout weight")
    b, d, h, w, cin = x.shape
    cout = kweight.shape[-1]
    dev = x.device
    gshape = (b, 2 * d, 2 * h, 2 * w, cout) if up \
        else (b, d // 2, h // 2, w // 2, cout)
    check_tensor(who, "x", x, dev, torch.bfloat16, (b, d, h, w, cin))
    check_tensor(who, "gy", gy, dev, torch.bfloat16, gshape)
    check_tensor(who, "kweight", kweight, dev, torch.bfloat16,
                 (8, cin, cout))
    s = t = None
    if pre is not None:
        s, t = check_affine(who, pre, dev, b, cin)
    dx = torch.empty_like(x) if need_dx else None
    dst = torch.zeros((b, 2, cin), dtype=torch.float32, device=dev) \
        if need_dx and pre is not None else None
    dk = torch.zeros((8, cin, cout), dtype=torch.float32, device=dev) \
        if need_dk else None
    db = torch.zeros((cout,), dtype=torch.float32, device=dev) \
        if need_dk else None
    lib = build.library("bridge_bwd")
    with torch.cuda.device(dev):
        rc = lib.vaeseg_bridge_bwd(
            int(up), x.data_ptr(), gy.data_ptr(), kweight.data_ptr(), _ptr(s),
            _ptr(t), _ptr(dx), _ptr(dk), _ptr(db), _ptr(dst), b, d, h, w,
            cin, cout, torch.cuda.current_stream(dev).cuda_stream)
    raise_if(rc, lib, who)
    return dx, dk, db, dst


def down_k2s2_bwd(x: torch.Tensor, gy: torch.Tensor, weight: torch.Tensor,
                  kweight: Optional[torch.Tensor] = None,
                  pre: Optional[Affine] = None, need_dx: bool = True,
                  need_dk: bool = True):
    """Backward of K2: (dx, dk, db, dst) as ``down_k2s2_bwd_plain``; what
    is not needed is None and costs nothing on CUDA."""
    if x.device.type == "cpu":
        return down_k2s2_bwd_plain(x, gy, weight, pre)
    out = _launch_bwd("down_k2s2_bwd", False, x, gy, kweight, pre, need_dx,
                      need_dk)
    down_k2s2_bwd.launches += 1
    return out


def up_k2s2_bwd(x: torch.Tensor, gy: torch.Tensor, weight: torch.Tensor,
                kweight: Optional[torch.Tensor] = None, need_dx: bool = True,
                need_dk: bool = True):
    """Backward of K3: (dx, dk, db) as ``up_k2s2_bwd_plain``."""
    if x.device.type == "cpu":
        return up_k2s2_bwd_plain(x, gy, weight)
    out = _launch_bwd("up_k2s2_bwd", True, x, gy, kweight, None, need_dx,
                      need_dk)
    up_k2s2_bwd.launches += 1
    return out[:3]


class _DownFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, s, t, kweight):
        pre = None if s is None else (s, t)
        ctx.save_for_backward(x, weight, s, t, kweight)
        return down_k2s2_op(x, weight, bias, kweight, pre)

    @staticmethod
    def backward(ctx, gy):
        x, weight, s, t, kweight = ctx.saved_tensors
        need = ctx.needs_input_grad
        need_dx, need_dk = need[0] or need[3] or need[4], need[1] or need[2]
        dx, dk, db, dst = down_k2s2_bwd(
            x, gy.to(x.dtype).contiguous(), weight.detach(), kweight,
            None if s is None else (s, t), need_dx, need_dk)
        dw = ds = dt = None
        if need_dk:
            cout, cin = weight.shape[:2]
            dw = dk.reshape(2, 2, 2, cin, cout).permute(4, 3, 0, 1, 2) \
                .to(weight.dtype)
            db = db.to(weight.dtype)
        if dst is not None:
            ds, dt = dst[:, 0].to(s.dtype), dst[:, 1].to(t.dtype)
        return dx, dw, db if need_dk else None, ds, dt, None


class _UpFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, kweight):
        ctx.save_for_backward(x, weight, kweight)
        return up_k2s2_op(x, weight, bias, kweight)

    @staticmethod
    def backward(ctx, gy):
        x, weight, kweight = ctx.saved_tensors
        need = ctx.needs_input_grad
        need_dk = need[1] or need[2]
        dx, dk, db = up_k2s2_bwd(x, gy.to(x.dtype).contiguous(),
                                 weight.detach(), kweight, need[0], need_dk)
        dw = None
        if need_dk:
            cin, cout = weight.shape[:2]
            dw = dk.reshape(2, 2, 2, cin, cout).permute(3, 4, 0, 1, 2) \
                .to(weight.dtype)
            db = db.to(weight.dtype)
        return dx, dw, db if need_dk else None, None


def down_k2s2(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              kweight: Optional[torch.Tensor] = None,
              pre: Optional[Affine] = None) -> torch.Tensor:
    """The differentiable K2 (contract of ``down_k2s2_plain``); its
    backward is ``down_k2s2_bwd``."""
    s, t = (None, None) if pre is None else pre
    return _DownFn.apply(x, weight, bias, s, t, kweight)


def up_k2s2(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            kweight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The differentiable K3 (contract of ``up_k2s2_plain``); its backward
    is ``up_k2s2_bwd``."""
    return _UpFn.apply(x, weight, bias, kweight)


down_k2s2.launches = 0
up_k2s2.launches = 0
down_k2s2_bwd.launches = 0
up_k2s2_bwd.launches = 0
