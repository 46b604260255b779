"""K1 and its backward: the 3^3 SAME stride-1 conv with its norm prologue
and stats/softmax epilogues, channels-last, differentiable.

``conv3`` is what the models call: a ``torch.autograd.Function`` whose
forward is ``conv3_op`` (K1) and whose backward is two more kernel calls,
as the TPU's custom VJPs (``vae_segmentation_tpu/ops/pallas/stencil3.py::
_bwd_pre`` and its siblings): the dx conv is K1 itself on the flipped,
transposed weight, with the prologue's backward as its ``post`` epilogue;
dk and db come from ``conv3_dk``. The stats cotangent fold stays plain
torch, as the JAX package leaves it to XLA; the softmax head's cotangent is
``losses.softmax_vjp``.

Each wrapper (``conv3_op``, ``conv3_dk``) runs its plain PyTorch version
on a CPU tensor and launches its hand-written kernel
(``kernels/csrc/conv3.cu``, ``conv3_dk.cu``) on a CUDA tensor, or raises.
``conv3_op`` replaces ``stencil3.py::_run_conv_grouped`` and ``::_run_conv``;
``conv3_dk`` replaces ``::_run_dk_grouped`` and ``::_run_dk``. The source
notes say what bounds them on the H100.

Under ``VAESEG_MERGED_BWD=1`` (``use_merged_bwd``, the JAX package's
switch) a backward that needs both a dx-side gradient (x, s or t) and a
weight-side one (weight or bias) launches ``conv3_bwd`` once instead of the
pair: the merged kernel ``kernels/csrc/conv3_bwd.cu`` (replacing
``stencil3.py::_run_bwd_grouped``) reads x and gy once for dx, dk and db.

``conv3.launches`` / ``conv3_dk.launches`` / ``conv3_bwd.launches`` count
kernel launches (never the plain versions).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Affine = Tuple[torch.Tensor, torch.Tensor]
Post = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def kernel_weight(weight: torch.Tensor) -> torch.Tensor:
    """torch Conv3d weight [O, I, 3, 3, 3] -> the kernel's [27, I, O] bf16,
    tap = (kd * 3 + kh) * 3 + kw."""
    return tap_major(weight.detach().permute(2, 3, 4, 1, 0))


def tap_major(w: torch.Tensor) -> torch.Tensor:
    """A weight viewed as [k, k, k, I, O] -> contiguous bf16 [k^3, I, O]
    in one strided, converting copy: the models derive this layout on
    every call."""
    out = torch.empty(w.shape, dtype=torch.bfloat16, device=w.device)
    out.copy_(w)
    return out.view(-1, *w.shape[3:])


def _pre_activation(x: torch.Tensor, pre: Affine) -> torch.Tensor:
    """x * s + t in f32, one rounding per operation: the kernels compute
    the same two roundings, so forward and backward agree on the ReLU
    mask."""
    s, t = pre
    return x.float() * s[:, None, None, None, :].float() \
        + t[:, None, None, None, :].float()


def _affine_relu(x: torch.Tensor, pre: Affine) -> torch.Tensor:
    return torch.relu(_pre_activation(x, pre))


def _stats(y: torch.Tensor) -> torch.Tensor:
    y32 = y.float()
    return torch.stack([y32.sum(dim=(1, 2, 3)),
                        (y32 * y32).sum(dim=(1, 2, 3))], dim=1)


def conv3_plain(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor],
                pre: Optional[Affine] = None, stats: bool = False,
                softmax: bool = False, post: Optional[Post] = None):
    """The plain PyTorch version of K1, in f32 on the values it is given.

    x [B, D, H, W, Cin] in the compute dtype (bf16 or f32); weight is the
    torch layout [Cout, Cin, 3, 3, 3], rounded to x.dtype first (the kernel
    reads bf16 weights); bias [Cout] f32 or None. pre = (s, t), each
    [B, Cin] f32: the input becomes relu(x * s + t) before the conv, and
    SAME pads that normalized tensor with zeros. Returns y
    [B, D, H, W, Cout] in x.dtype; with stats also the [B, 2, Cout] f32
    (sum, sumsq) of the stored y; with softmax, y holds class probabilities
    over Cout.

    post = (xs, s, t) makes the call a dx conv: its f32 output g is the
    cotangent of relu(xs * s + t) and goes through that prologue's
    backward, gm = g where xs * s + t > 0 else 0. Returns (gm * s in
    x.dtype, dst [B, 2, Cout] f32 = (sum gm * xs, sum gm) over the
    volume)."""
    if sum((stats, softmax, post is not None)) > 1:
        raise ValueError("conv3: the stats, softmax and post epilogues are "
                         "exclusive")
    xin = x.float() if pre is None else _affine_relu(x, pre)
    w = weight.to(x.dtype).float()
    y = F.conv3d(xin.permute(0, 4, 1, 2, 3), w,
                 None if bias is None else bias.float(), padding=1)
    y = y.permute(0, 2, 3, 4, 1)
    if post is not None:
        xs, s, t = post
        gm = torch.where(_pre_activation(xs, (s, t)) > 0, y,
                         torch.zeros((), dtype=y.dtype, device=y.device))
        dst = torch.stack([(gm * xs.float()).sum(dim=(1, 2, 3)),
                           gm.sum(dim=(1, 2, 3))], dim=1)
        dx = gm * s[:, None, None, None, :].float()
        return dx.to(x.dtype).contiguous(), dst
    if softmax:
        y = torch.softmax(y, dim=-1)
    y = y.to(x.dtype).contiguous()
    return (y, _stats(y)) if stats else y


def conv3_dk_plain(x: torch.Tensor, gy: torch.Tensor,
                   pre: Optional[Affine] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain weight and bias gradient of K1 in f32: dk [27, Cin, Cout]
    (the kernel layout, tap-major) and db [Cout], summed over the batch and
    all voxels, from x (through the prologue; out-of-volume taps are 0)
    and the output cotangent gy."""
    xin = x.float() if pre is None else _affine_relu(x, pre)
    cin, cout = x.shape[-1], gy.shape[-1]
    g = gy.float().permute(0, 4, 1, 2, 3)
    dw = torch.nn.grad.conv3d_weight(xin.permute(0, 4, 1, 2, 3),
                                     (cout, cin, 3, 3, 3), g, padding=1)
    dk = dw.permute(2, 3, 4, 1, 0).reshape(27, cin, cout).contiguous()
    return dk, g.sum(dim=(0, 2, 3, 4))


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


def check_affine(who: str, pre: Affine, device, b: int, c: int) -> Affine:
    """The (s, t) pair as contiguous [b, c] f32 tensors, or raise."""
    s, t = pre[0].contiguous(), pre[1].contiguous()
    check_tensor(who, "s", s, device, torch.float32, (b, c))
    check_tensor(who, "t", t, device, torch.float32, (b, c))
    return s, t


def raise_if(rc: int, lib, who: str) -> None:
    """Turn a kernel library's return code into a RuntimeError."""
    if rc != 0:
        raise RuntimeError(f"{who} kernel launch failed: "
                           + lib.vaeseg_error_string(rc).decode())


def conv3_op(x: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor],
             kweight: Optional[torch.Tensor] = None,
             pre: Optional[Affine] = None, stats: bool = False,
             softmax: bool = False, post: Optional[Post] = None):
    """K1. Same contract as ``conv3_plain``; on CUDA, x must be bf16 and
    ``kweight`` the weight in the kernel's layout (``kernel_weight``)."""
    if x.device.type == "cpu":
        return conv3_plain(x, weight, bias, pre, stats, softmax, post)
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
    if bias is not None:
        check_tensor("conv3", "bias", bias, dev, torch.float32, (cout,))
    if sum((stats, softmax, post is not None)) > 1:
        raise ValueError("conv3: the stats, softmax and post epilogues are "
                         "exclusive")
    s = t = xs = ps = pt = None
    if pre is not None:
        s, t = check_affine("conv3", pre, dev, b, cin)
    if post is not None:
        xs = post[0]
        check_tensor("conv3", "post x", xs, dev, torch.bfloat16,
                     (b, d, h, w, cout))
        ps, pt = check_affine("conv3 post", post[1:], dev, b, cout)
    y = torch.empty((b, d, h, w, cout), dtype=torch.bfloat16, device=dev)
    # one [B, 2, Cout] f32 block serves either epilogue: the output's
    # (sum, sumsq), or the post epilogue's (ds, dt)
    st = torch.zeros((b, 2, cout), dtype=torch.float32, device=dev) \
        if stats or post is not None else None
    lib = build.library("conv3")
    with torch.cuda.device(dev):
        rc = lib.vaeseg_conv3(
            x.data_ptr(), kweight.data_ptr(), _ptr(bias), _ptr(s), _ptr(t),
            _ptr(xs), _ptr(ps), _ptr(pt), y.data_ptr(), _ptr(st),
            b, d, h, w, cin, cout, int(softmax),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_if(rc, lib, "conv3")
    conv3.launches += 1
    return y if st is None else (y, st)


def conv3_dk(x: torch.Tensor, gy: torch.Tensor,
             pre: Optional[Affine] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk [27, Cin, Cout] f32 and db [Cout] f32 of K1. Same contract as
    ``conv3_dk_plain``; on CUDA, x and gy must be bf16."""
    if x.device.type == "cpu":
        return conv3_dk_plain(x, gy, pre)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv3_dk: no kernel for device {x.device}")
    from vae_segmentation_tpu_torch.ops.kernels import build

    if x.dim() != 5:
        raise ValueError(f"conv3_dk: x must be [B, D, H, W, C], got {x.shape}")
    b, d, h, w, cin = x.shape
    cout = gy.shape[-1]
    dev = x.device
    check_tensor("conv3_dk", "x", x, dev, torch.bfloat16, (b, d, h, w, cin))
    check_tensor("conv3_dk", "gy", gy, dev, torch.bfloat16,
                 (b, d, h, w, cout))
    s = t = None
    if pre is not None:
        s, t = check_affine("conv3_dk", pre, dev, b, cin)
    # f64 across the kernel's blocks (a cancelling sum), rounded once here
    dk = torch.zeros((27, cin, cout), dtype=torch.float64, device=dev)
    db = torch.zeros((cout,), dtype=torch.float64, device=dev)
    lib = build.library("conv3_dk")
    with torch.cuda.device(dev):
        rc = lib.vaeseg_conv3_dk(
            x.data_ptr(), gy.data_ptr(), _ptr(s), _ptr(t), dk.data_ptr(),
            db.data_ptr(), b, d, h, w, cin, cout,
            torch.cuda.current_stream(dev).cuda_stream)
    raise_if(rc, lib, "conv3_dk")
    conv3_dk.launches += 1
    return dk.float(), db.float()


def use_merged_bwd() -> bool:
    """The merged dx + dk backward (``conv3_bwd``) under
    VAESEG_MERGED_BWD=1, read when a backward runs, as the JAX package's
    ``stencil3.py::use_merged_bwd`` is read at trace time. Off by default,
    as there: the TPU measured it slower than the pair."""
    return os.environ.get("VAESEG_MERGED_BWD", "0") == "1"


def conv3_bwd_plain(x: torch.Tensor, gy: torch.Tensor, weight: torch.Tensor,
                    pre: Optional[Affine] = None):
    """The plain merged backward of K1: the pair it replaces, the dx conv
    (``conv3_plain`` on the flipped, transposed weight, with the prologue's
    backward as its ``post`` epilogue) and ``conv3_dk_plain``. x
    [B, D, H, W, Cin] and gy [B, D, H, W, Cout] in the compute dtype,
    weight the torch layout [Cout, Cin, 3, 3, 3], pre = (s, t) [B, Cin] f32
    or None. Returns (dx in x.dtype, dk [27, Cin, Cout] f32, db [Cout] f32,
    dst [B, 2, Cin] f32 = (ds, dt) with the prologue, else None)."""
    w_t = weight.detach().flip(2, 3, 4).transpose(0, 1)
    if pre is None:
        dx, dst = conv3_plain(gy, w_t, None), None
    else:
        dx, dst = conv3_plain(gy, w_t, None, post=(x, *pre))
    dk, db = conv3_dk_plain(x, gy, pre)
    return dx, dk, db, dst


def conv3_bwd(x: torch.Tensor, gy: torch.Tensor, weight: torch.Tensor,
              kweight: Optional[torch.Tensor] = None,
              pre: Optional[Affine] = None):
    """Row 5, the merged backward: same contract as ``conv3_bwd_plain``; on
    CUDA, x and gy must be bf16 and ``kweight`` the forward's weight in the
    kernel's layout (``kernel_weight``), which the kernel reads flipped."""
    if x.device.type == "cpu":
        return conv3_bwd_plain(x, gy, weight, pre)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv3_bwd: no kernel for device {x.device}")
    from vae_segmentation_tpu_torch.ops.kernels import build

    if x.dim() != 5:
        raise ValueError(f"conv3_bwd: x must be [B, D, H, W, C], got "
                         f"{x.shape}")
    if kweight is None:
        raise ValueError("conv3_bwd: CUDA launch needs the kernel-layout "
                         "weight")
    b, d, h, w, cin = x.shape
    cout = gy.shape[-1]
    dev = x.device
    check_tensor("conv3_bwd", "x", x, dev, torch.bfloat16, (b, d, h, w, cin))
    check_tensor("conv3_bwd", "gy", gy, dev, torch.bfloat16,
                 (b, d, h, w, cout))
    check_tensor("conv3_bwd", "kweight", kweight, dev, torch.bfloat16,
                 (27, cin, cout))
    s = t = dst = None
    if pre is not None:
        s, t = check_affine("conv3_bwd", pre, dev, b, cin)
        dst = torch.zeros((b, 2, cin), dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    # f64 across the kernel's blocks (cancelling sums), rounded once here
    dk = torch.zeros((27, cin, cout), dtype=torch.float64, device=dev)
    db = torch.zeros((cout,), dtype=torch.float64, device=dev)
    lib = build.library("conv3_bwd")
    with torch.cuda.device(dev):
        rc = lib.vaeseg_conv3_bwd(
            x.data_ptr(), gy.data_ptr(), kweight.data_ptr(), _ptr(s),
            _ptr(t), dx.data_ptr(), _ptr(dst), dk.data_ptr(), db.data_ptr(),
            b, d, h, w, cin, cout,
            torch.cuda.current_stream(dev).cuda_stream)
    raise_if(rc, lib, "conv3_bwd")
    conv3_bwd.launches += 1
    return dx, dk.float(), db.float(), dst


def stats_cotangent(y: torch.Tensor, gy: Optional[torch.Tensor],
                    gst: Optional[torch.Tensor]) -> torch.Tensor:
    """Fold the cotangent of the (sum, sumsq) output into gy: d sum / dy
    = 1, d sumsq / dy = 2 y (stencil3.py::_stats_cotangent). One plain
    elementwise pass in f32, stored in y.dtype."""
    g = torch.zeros_like(y, dtype=torch.float32) if gy is None \
        else gy.float()
    if gst is not None:
        g = g + gst[:, 0, None, None, None, :] \
            + 2.0 * y.float() * gst[:, 1, None, None, None, :]
    return g.to(y.dtype)


class _Conv3Fn(torch.autograd.Function):
    """K1 with its backward kernels. Inputs (x, weight, bias, s, t) are
    differentiable; s and t are None without the prologue."""

    @staticmethod
    def forward(ctx, x, weight, bias, s, t, kweight, stats, softmax):
        pre = None if s is None else (s, t)
        out = conv3_op(x, weight, bias, kweight, pre, stats, softmax)
        y = out[0] if stats else out
        ctx.save_for_backward(x, weight, s, t, kweight,
                              y if (stats or softmax) else None)
        ctx.stats, ctx.softmax = stats, softmax
        return out

    @staticmethod
    def backward(ctx, *grads):
        from vae_segmentation_tpu_torch.ops.losses import softmax_vjp

        x, weight, s, t, kweight, y = ctx.saved_tensors
        pre = None if s is None else (s, t)
        need_x, need_w, need_b, need_s, need_t = ctx.needs_input_grad[:5]
        if ctx.stats:
            gy = stats_cotangent(y, grads[0], grads[1])
        else:
            gy = grads[0].to(x.dtype)
        if ctx.softmax:
            gy = softmax_vjp(gy.contiguous(), y)
        gy = gy.contiguous()
        dx = ds = dt = dw = db = dst = dk = None
        need_dx = need_x or need_s or need_t
        need_dk = need_w or need_b
        if need_dx and need_dk and use_merged_bwd():
            dx, dk, db, dst = conv3_bwd(x, gy, weight, kweight, pre)
        elif need_dx:
            # the dx conv: K1 on the flipped taps with Cin and Cout swapped
            w_t = weight.detach().flip(2, 3, 4).transpose(0, 1)
            kw_t = None if kweight is None else \
                kweight.flip(0).transpose(1, 2).contiguous()
            if pre is None:
                dx = conv3_op(gy, w_t, None, kw_t)
            else:
                dx, dst = conv3_op(gy, w_t, None, kw_t, post=(x, s, t))
        if dst is not None:
            ds, dt = dst[:, 0].to(s.dtype), dst[:, 1].to(t.dtype)
        if need_dk:
            if dk is None:
                dk, db = conv3_dk(x, gy, pre)
            cout, cin = weight.shape[:2]
            dw = dk.reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2) \
                .to(weight.dtype)
            db = db.to(weight.dtype)
        return dx, dw, db, ds, dt, None, None, None


def conv3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          kweight: Optional[torch.Tensor] = None,
          pre: Optional[Affine] = None, stats: bool = False,
          softmax: bool = False):
    """The differentiable K1: y, or (y, stats) with ``stats``; the contract
    of ``conv3_plain``. Gradients reach x, weight, bias and the prologue's
    (s, t) through ``conv3_op`` (dx, ds, dt) and ``conv3_dk`` (dk, db), or
    through one ``conv3_bwd`` under ``use_merged_bwd`` when both sides are
    needed; what does not require a gradient launches nothing."""
    s, t = (None, None) if pre is None else pre
    return _Conv3Fn.apply(x, weight, bias, s, t, kweight, stats, softmax)


conv3.launches = 0
conv3_dk.launches = 0
conv3_bwd.launches = 0
