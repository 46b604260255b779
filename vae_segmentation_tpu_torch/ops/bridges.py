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

The forward kernels' tile, chunk and warp plan is ``bridge_plan``; the
dx kernels' plans are ``up_dx_plan`` (K3) and ``down_dx_plan`` (K2, the
mirror of K3's forward on the tensor cores); ``down_k2s2.launches``,
``up_k2s2.launches``, ``down_k2s2_bwd.launches`` and
``up_k2s2_bwd.launches`` count kernel launches.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from vae_segmentation_tpu_torch.ops.conv3 import (
    _affine_relu, _ceil, _pre_activation, _ptr, check_affine, check_tensor,
    plan_arg, raise_if, row_stride, sm_count, tap_major, wgrad_plan,
    wgrad_workspace)

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


# ---- the plan of K2 and K3 (kernels/csrc/bridge.cu)

# the plan's fields, in the order bridge.cu's PlanField reads them
BRIDGE_FIELDS = ("td", "th", "tw", "tiles_d", "tiles_h", "tiles_w", "nc",
                 "mt", "wm", "wk", "kc", "tpb")
BRIDGE_KC = 256              # input channels a block stages at once, at most
BRIDGE_TPB = 8               # bricks a block walks, at most
SMEM_BYTES = 227 * 1024      # shared memory a block may use on an H100
WARPS = 8                    # a block of 256 threads


def bridge_smem(up: bool, pre: bool, nvox: int, kc: int, nc: int, wk: int,
                slots: int, kchunks: int) -> int:
    """The shared memory a K2 / K3 block lays out (bridge.cu::
    bridge_layout): a ring of `slots` staged inputs (K3: the brick's coarse
    rows; K2: its 8 nvox fine rows, and the [2, kc] f32 (s, t) under the
    prologue), the [8 kc, nc] weight rows (bf16, f32 under the prologue;
    in the ring when K has more than one chunk), the brick's geometry
    tables, 8 tap offsets, and the output staging (K3: the fine brick in
    bf16; K2 without the prologue: the warps' f32 partials)."""
    mpad = _ceil(nvox, 16) * 16
    rows = mpad if up else 8 * nvox
    slot = rows * row_stride(kc) * 2 + (2 * kc * 4 if pre else 0)
    wslot = 8 * kc * (nc * 4 if pre else row_stride(nc) * 2)
    wslots = slots if kchunks > 1 else 1
    tables = (2 * mpad + 8 * nvox if up else rows) * 4
    out = 8 * nvox * row_stride(nc) * 2 if up \
        else 0 if pre else wk * mpad * row_stride(nc) * 4
    return slots * slot + wslots * wslot + tables + 8 * 4 + out


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@functools.lru_cache(maxsize=None)
def bridge_plan(kind: str, batch: int, grid: Tuple[int, int, int], cin: int,
                cout: int, prologue: bool, sms: int,
                wk: Optional[int] = None) -> dict:
    """The plan of one K2 ("down") or K3 ("up") call (``kernels/csrc/
    bridge.cu``) on the input `grid`.

    A brick is td x th x tw coarse voxels (K3's input, K2's output; M,
    padded to m16 tiles) by a chunk of nc output channels (8 or 16); K is
    staged in chunks of at most kc input channels (K2 with C_in <= 8: one
    chunk of 8, two taps a k16 step). K3's brick holds at most 64 voxels
    (128 at nc 8: a warp's m16n8 tiles, at most 8); K2's about 32 KB of fine
    rows (256 voxels at C_in 8), at most 256 / (nc / 8) (one store a
    thread). Where the grid holds fewer than 2 blocks an SM the brick
    shrinks (down to 16 voxels), then nc falls to 8. K3's warps are its 8
    taps, each over all mt m16 tiles (wm = wk = 1). K2's 8 warps are
    wm x wk: wm split the m16 tiles (mt each), wk the k16 steps of each
    chunk, their partials added in warp order; ``wk=1`` forces the one-pass
    plan (wm = 8, warps past the brick's m16 tiles idle). K2 with the
    prologue runs on the CUDA cores (``tensor_cores`` False), a thread a
    coarse voxel and 8 channels. A block walks tpb bricks (at most
    ``BRIDGE_TPB``, and so many that the grid keeps 2 blocks an SM) through
    a two-slot input ring. Returns the fields the kernel reads
    (``BRIDGE_FIELDS``, in ``fields``; their ctypes array in ``arg``) and
    what they imply. The kernel lays out its shared memory from these
    fields and refuses a plan that does not fit; ``smem`` is that layout's
    size (``bridge_smem``), and a plan that would not fit halves kc, then
    the brick. The result is cached: do not modify it."""
    if kind not in ("up", "down"):
        raise ValueError(f"bridge: unknown kind {kind!r}")
    up = kind == "up"
    if up and prologue:
        raise ValueError("bridge: K3 has no prologue")
    d, h, w = grid
    coarse = grid if up else (d // 2, h // 2, w // 2)
    if min(coarse) < 1 or cin < 1 or cout < 1:
        raise ValueError(f"bridge: no {kind} call on {grid} x {cin} -> "
                         f"{cout}")
    cd, ch, cw = coarse
    cpad = 8 if not up and cin <= 8 else _ceil(cin, 16) * 16
    nc = 8 if cout <= 8 else 16
    # K3: MT x NT <= 8 m16n8 tiles a warp; K2: about 32 KB of fine rows a
    # brick, one thread a (coarse voxel, 8 channels) at the store
    mmax = (128 if nc == 8 else 64) if up \
        else min(256 * 8 // nc, max(16, 2048 // cpad))
    tw, th = min(cw, 8), min(ch, 8)
    tile = [min(cd, max(1, mmax // (tw * th))), th, tw]

    def blocks():
        return batch * _ceil(cout, nc) * _ceil(cd, tile[0]) \
            * _ceil(ch, tile[1]) * _ceil(cw, tile[2])

    while blocks() < 2 * sms and tile[0] * tile[1] * tile[2] > 16:
        axis = next(i for i in range(3) if tile[i] == max(tile))
        tile[axis] = _ceil(tile[axis], 2)
    if blocks() < 2 * sms:
        nc = 8
    kc = min(cpad, BRIDGE_KC)
    tpb = max(1, min(BRIDGE_TPB, blocks() // (2 * sms)))
    while True:
        nvox = tile[0] * tile[1] * tile[2]
        mtiles = _ceil(nvox, 16)
        if up:
            wm, wk_, mt = 1, 1, _pow2_at_least(mtiles)
        else:
            wm = WARPS if wk == 1 else 1 << (min(mtiles, WARPS).bit_length()
                                             - 1)
            wk_ = WARPS // wm
            mt = _pow2_at_least(_ceil(mtiles, wm))
        kchunks = _ceil(cpad, kc)
        slots = 2 if tpb * kchunks > 1 else 1
        smem = bridge_smem(up, prologue, nvox, kc, nc, wk_, slots, kchunks)
        if smem <= SMEM_BYTES:
            break
        if kc > 16:
            kc = _ceil(kc // 2, 16) * 16
        elif nvox > 16:
            axis = next(i for i in range(3) if tile[i] == max(tile))
            tile[axis] = _ceil(tile[axis], 2)
        else:
            raise ValueError(f"bridge: no {kind} plan fits {cin} -> {cout}")
    td, th, tw = tile
    tiles = (_ceil(cd, td), _ceil(ch, th), _ceil(cw, tw))
    ntiles = batch * tiles[0] * tiles[1] * tiles[2]
    plan = {"td": td, "th": th, "tw": tw, "tiles_d": tiles[0],
            "tiles_h": tiles[1], "tiles_w": tiles[2], "nc": nc, "mt": mt,
            "wm": wm, "wk": wk_, "kc": kc, "tpb": tpb}
    plan.update(fields=[plan[k] for k in BRIDGE_FIELDS], kind=kind,
                prologue=prologue, coarse=coarse, nvox=nvox,
                mpad=16 * mtiles, mtiles=mtiles, cpad=cpad,
                k_chunks=kchunks, co_chunks=_ceil(cout, nc),
                ntiles=ntiles, launch_grid=(_ceil(ntiles, tpb),
                                            _ceil(cout, nc)),
                smem=smem, tensor_cores=not prologue)
    plan["arg"] = plan_arg(plan["fields"])
    return plan


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


def bridge_launch(kind: str, x: torch.Tensor, kweight: torch.Tensor,
                  bias: torch.Tensor, pre: Optional[Affine] = None,
                  plan: Optional[dict] = None) -> torch.Tensor:
    """One launch of K2 ("down") or K3 ("up") on CUDA tensors, under
    `plan` (a ``bridge_plan`` of the call's shape) or the call's own.
    ``down_k2s2_op`` / ``up_k2s2_op`` count it; chip_smoke.py also times
    the one-pass plan beside one that splits K over the warps through
    here."""
    from vae_segmentation_tpu_torch.ops.kernels import build

    up = kind == "up"
    who = "up_k2s2" if up else "down_k2s2"
    b, d, h, w, cin, cout = _prepare(x, kweight, bias, who)
    s = t = None
    if pre is not None:
        s, t = check_affine(who, pre, x.device, b, cin)
    if plan is None:
        plan = bridge_plan(kind, b, (d, h, w), cin, cout, pre is not None,
                           sm_count(x.device.index or 0))
    if plan["kind"] != kind or (pre is not None) != plan["prologue"]:
        raise ValueError(f"{who}: the kind or prologue differs from the "
                         "plan's")
    shape = (b, 2 * d, 2 * h, 2 * w, cout) if up \
        else (b, d // 2, h // 2, w // 2, cout)
    y = torch.empty(shape, dtype=torch.bfloat16, device=x.device)
    lib = build.library("bridge")
    with torch.cuda.device(x.device):
        rc = lib.vaeseg_bridge(
            int(up), x.data_ptr(), kweight.data_ptr(), bias.data_ptr(),
            _ptr(s), _ptr(t), y.data_ptr(), b, d, h, w, cin, cout,
            plan["arg"], torch.cuda.current_stream(x.device).cuda_stream)
    raise_if(rc, lib, who)
    return y


def down_k2s2_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 kweight: Optional[torch.Tensor] = None,
                 pre: Optional[Affine] = None) -> torch.Tensor:
    """K2. Same contract as ``down_k2s2_plain``; on CUDA, x must be bf16
    and ``kweight`` the ``down_kernel_weight`` layout."""
    if x.device.type == "cpu":
        return down_k2s2_plain(x, weight, bias, pre)
    y = bridge_launch("down", x, kweight, bias, pre)
    down_k2s2.launches += 1
    return y


def up_k2s2_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               kweight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3. Same contract as ``up_k2s2_plain``; on CUDA, x must be bf16 and
    ``kweight`` the ``up_kernel_weight`` layout."""
    if x.device.type == "cpu":
        return up_k2s2_plain(x, weight, bias)
    y = bridge_launch("up", x, kweight, bias)
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


# the up dx plan's fields, in the order bridge_bwd.cu's DxField reads them
UP_DX_FIELDS = ("td", "th", "tw", "tiles_d", "tiles_h", "tiles_w", "nc")


def up_dx_plan(batch: int, grid: Tuple[int, int, int], cin: int,
               cout: int) -> dict:
    """The plan of K3's dx kernel (``bridge_bwd.cu::up_dx_kernel``): block
    (tile, chunk) takes a brick of td x th x tw coarse voxels of `grid`
    (at most 64, padded to kpad, a multiple of 16) and nc of the Cin output
    channels, and walks Cout in chunks of 16. Returns the fields the kernel
    reads (``UP_DX_FIELDS``, in ``fields``) and what they imply."""
    d, h, w = grid
    tw = min(w, 8)
    th = min(h, 4)
    td = min(d, max(1, 64 // (tw * th)))
    nvox = td * th * tw
    kpad = -(-nvox // 16) * 16
    nc = 16 if cin <= 16 else 32 if cin <= 32 else 64
    tiles = (-(-d // td), -(-h // th), -(-w // tw))
    plan = {"td": td, "th": th, "tw": tw, "tiles_d": tiles[0],
            "tiles_h": tiles[1], "tiles_w": tiles[2], "nc": nc}
    plan.update(fields=[plan[k] for k in UP_DX_FIELDS], nvox=nvox,
                kpad=kpad, blocks=batch * tiles[0] * tiles[1] * tiles[2],
                chunks=-(-cin // nc))
    return plan


# the down dx plan's fields, in the order bridge_bwd.cu's DownDxField reads
# them
DOWN_DX_FIELDS = ("td", "th", "tw", "tiles_d", "tiles_h", "tiles_w", "nc",
                  "mt", "tpb", "blocks")


def down_dx_smem(nvox: int, kpad: int, nc: int, slots: int,
                 prologue: bool) -> int:
    """The shared memory a block of K2's dx kernel lays out
    (bridge_bwd.cu::dd_layout): the ring of staged gy rows, the [8 nc,
    kpad] weight rows, the brick's tables, the fine brick (bf16, f32 under
    the prologue) and the warps' (ds, dt)."""
    mpad = _ceil(nvox, 16) * 16
    gstr = row_stride(kpad)
    out = 8 * nvox * ((nc + 4) * 4 if prologue else row_stride(nc) * 2)
    return (slots * mpad * gstr * 2 + 8 * nc * gstr * 2
            + (2 * mpad + 8 * nvox) * 4 + out + WARPS * 2 * 16 * 4)


@functools.lru_cache(maxsize=None)
def down_dx_plan(batch: int, grid: Tuple[int, int, int], cin: int,
                 cout: int, prologue: bool, sms: int) -> dict:
    """The plan of K2's dx kernel (``bridge_bwd.cu::down_dx_kernel``) on the
    fine `grid`, the mirror of K3's forward plan (``bridge_plan("up")``).

    The bricks tile the coarse voxels that cover the fine grid,
    ceil(fine / 2) an axis (an odd extent's last plane is written as 0 by
    the brick that holds it). A brick is td x th x tw coarse voxels (M,
    padded to m16 tiles; warp w computes tap w over all mt of them) by a
    chunk of nc (8 or 16) of the Cin output channels, K = Cout staged
    whole (kpad, a multiple of 16). It holds at most 128 voxels at nc 8,
    64 at 16 (a warp's m16n8 tiles, at most 8); where the grid holds fewer
    than 2 blocks an SM the brick shrinks (down to 16 voxels), then nc
    falls to 8, and where the shared memory would not fit the brick
    shrinks, then nc. A block takes one channel chunk of one batch entry
    and walks tpb bricks (at most ``BRIDGE_TPB``, so many that the grid
    keeps 2 blocks an SM) through a two-slot ring: ``blocks`` blocks a
    batch entry, each writing one [2, Cin] partial of (ds, dt) under the
    prologue. Returns the fields the kernel reads (``DOWN_DX_FIELDS``, in
    ``fields``; their ctypes array in ``arg``) and what they imply; raises
    ValueError for a call no plan fits. The result is cached: do not
    modify it."""
    if min(grid) < 2 or cin < 1 or cout < 1 or batch < 1:
        raise ValueError(f"down_dx: no K2 dx on {grid} x {cin} <- {cout}")
    cover = tuple(_ceil(e, 2) for e in grid)
    cd, ch, cw = cover
    kpad = _ceil(cout, 16) * 16
    nc = 8 if cin <= 8 else 16
    mmax = 128 if nc == 8 else 64
    tw, th = min(cw, 8), min(ch, 8)
    tile = [min(cd, max(1, mmax // (tw * th))), th, tw]

    def nvox():
        return tile[0] * tile[1] * tile[2]

    def halve():
        axis = next(i for i in range(3) if tile[i] == max(tile))
        tile[axis] = _ceil(tile[axis], 2)

    def blocks():
        return batch * _ceil(cin, nc) * _ceil(cd, tile[0]) \
            * _ceil(ch, tile[1]) * _ceil(cw, tile[2])

    while blocks() < 2 * sms and nvox() > 16:
        halve()
    if blocks() < 2 * sms:
        nc = 8
    tpb = max(1, min(BRIDGE_TPB, blocks() // (2 * sms)))
    while down_dx_smem(nvox(), kpad, nc, 2 if tpb > 1 else 1, prologue) \
            > SMEM_BYTES:
        if nvox() > 16:
            halve()
        elif nc > 8:
            nc = 8
        else:
            raise ValueError(f"down_dx: no plan fits Cout {cout}")
    td, th, tw = tile
    tiles = (_ceil(cd, td), _ceil(ch, th), _ceil(cw, tw))
    per_b = tiles[0] * tiles[1] * tiles[2]
    tpb = min(tpb, per_b)
    mtiles = _ceil(nvox(), 16)
    plan = {"td": td, "th": th, "tw": tw, "tiles_d": tiles[0],
            "tiles_h": tiles[1], "tiles_w": tiles[2], "nc": nc,
            "mt": _pow2_at_least(mtiles), "tpb": tpb,
            "blocks": _ceil(per_b, tpb)}
    plan.update(fields=[plan[k] for k in DOWN_DX_FIELDS], cover=cover,
                nvox=nvox(), mpad=16 * mtiles, kpad=kpad,
                chunks=_ceil(cin, nc), prologue=prologue,
                launch_grid=(plan["blocks"], _ceil(cin, nc), batch),
                smem=down_dx_smem(nvox(), kpad, nc, 2 if tpb > 1 else 1,
                                  prologue))
    plan["arg"] = plan_arg(plan["fields"])
    return plan


def _launch_bwd(who: str, up: bool, x, gy, kweight, pre, need_dx, need_dk):
    """Shared launch of ``bridge_bwd.cu``: x is the forward's input (the
    coarse grid for K3, the fine grid for K2), gy the output cotangent. dk
    and db come from the split plan ``conv3.wgrad_plan`` (mode "up" or
    "down"), dx from ``up_dx_plan`` (K3) or ``down_dx_plan`` (K2)."""
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
    sms = sm_count(dev.index or 0)
    dst = dpart = dx_plan = None
    if need_dx:
        plan = up_dx_plan(b, (d, h, w), cin, cout) if up else \
            down_dx_plan(b, (d, h, w), cin, cout, pre is not None, sms)
        dx_plan = plan_arg(plan["fields"])
        if pre is not None:
            # each block of K2's dx kernel writes one [2, Cin] partial; a
            # second pass adds the plan's blocks in a fixed order
            dst = torch.empty((b, 2, cin), dtype=torch.float32, device=dev)
            dpart = torch.empty((b, plan["blocks"], 2, cin),
                                dtype=torch.float32, device=dev)
    dk = db = ws = wsdb = dk_plan = None
    if need_dk:
        plan = wgrad_plan("up", b, (d, h, w), cout, cin, sms) if up else \
            wgrad_plan("down", b, gshape[1:4], cin, cout, sms)
        ws, wsdb = wgrad_workspace(plan, dev)
        dk = torch.empty((8, cin, cout), dtype=torch.float32, device=dev)
        db = torch.empty((cout,), dtype=torch.float32, device=dev)
        dk_plan = plan_arg(plan["fields"])
    lib = build.library("bridge_bwd")
    with torch.cuda.device(dev):
        rc = lib.vaeseg_bridge_bwd(
            int(up), x.data_ptr(), gy.data_ptr(), kweight.data_ptr(), _ptr(s),
            _ptr(t), _ptr(dx), _ptr(dk), _ptr(db), _ptr(dst), _ptr(dpart),
            _ptr(ws), _ptr(wsdb), b, d, h, w, cin, cout, dk_plan, dx_plan,
            torch.cuda.current_stream(dev).cuda_stream)
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
