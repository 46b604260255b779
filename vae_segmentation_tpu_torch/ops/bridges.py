"""K2 and K3: the stage-boundary bridges, channels-last.

``down_k2s2`` (K2) is the Down entry: a 2^3 stride-2 VALID conv + bias with
an optional norm+ReLU prologue. It replaces the forward of the TPU's
``vae_segmentation_tpu/ops/pallas/upbridge.py::down_bridge_w`` and
``::down_bridge_w_pre``. ``up_k2s2`` (K3) is the Up entry: a 2^3 stride-2
ConvTranspose + bias in torch's semantics, replacing the forward of
``upbridge.py::up_bridge_w``. Each launches ``kernels/csrc/bridge.cu`` on a
CUDA tensor (or raises) and runs its plain version on a CPU tensor; the
source note in ``bridge.cu`` says what bounds them on the H100.

``down_k2s2.launches`` / ``up_k2s2.launches`` count kernel launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from vae_segmentation_tpu_torch.ops.conv3 import check_tensor

Affine = Tuple[torch.Tensor, torch.Tensor]


def down_kernel_weight(weight: torch.Tensor) -> torch.Tensor:
    """torch Conv3d weight [O, I, 2, 2, 2] -> the kernel's [8, I, O] bf16,
    a = (ad * 2 + ah) * 2 + aw."""
    o, i = weight.shape[:2]
    return weight.detach().permute(2, 3, 4, 1, 0).reshape(8, i, o) \
        .to(torch.bfloat16).contiguous()


def up_kernel_weight(weight: torch.Tensor) -> torch.Tensor:
    """torch ConvTranspose3d weight [I, O, 2, 2, 2] -> the kernel's
    [8, I, O] bf16."""
    i, o = weight.shape[:2]
    return weight.detach().permute(2, 3, 4, 0, 1).reshape(8, i, o) \
        .to(torch.bfloat16).contiguous()


def down_k2s2_plain(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, pre: Optional[Affine] = None
                    ) -> torch.Tensor:
    """Plain K2 in f32: y = conv3d(relu(x * s + t) or x, weight, stride 2)
    + bias, weight [Cout, Cin, 2, 2, 2] rounded to x.dtype, y in x.dtype."""
    if pre is None:
        xin = x.float()
    else:
        s, t = pre
        xin = torch.relu(x.float() * s[:, None, None, None, :].float()
                         + t[:, None, None, None, :].float())
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


def _raise_if(rc: int, lib, who: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{who} kernel launch failed: "
                           + lib.vaeseg_bridge_error_string(rc).decode())


def down_k2s2(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
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
        s, t = pre[0].contiguous(), pre[1].contiguous()
        check_tensor("down_k2s2", "s", s, x.device, torch.float32, (b, cin))
        check_tensor("down_k2s2", "t", t, x.device, torch.float32, (b, cin))
    y = torch.empty((b, d // 2, h // 2, w // 2, cout), dtype=torch.bfloat16,
                    device=x.device)
    lib = build.library("bridge")
    with torch.cuda.device(x.device):
        rc = lib.vaeseg_down_k2s2(
            x.data_ptr(), kweight.data_ptr(), bias.data_ptr(),
            None if s is None else s.data_ptr(),
            None if t is None else t.data_ptr(), y.data_ptr(),
            b, d, h, w, cin, cout,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_if(rc, lib, "down_k2s2")
    down_k2s2.launches += 1
    return y


def up_k2s2(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
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
    _raise_if(rc, lib, "up_k2s2")
    up_k2s2.launches += 1
    return y


down_k2s2.launches = 0
up_k2s2.launches = 0
