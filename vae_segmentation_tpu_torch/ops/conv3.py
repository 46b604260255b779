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
notes say what bounds them on the H100. Both kernels run on the tensor
cores from a plan computed here (``conv3_plan``, ``wgrad_plan``): the
tiles, chunks and K splits of their blocks.

Under ``VAESEG_MERGED_BWD=1`` (``use_merged_bwd``, the JAX package's
switch) a backward that needs both a dx-side gradient (x, s or t) and a
weight-side one (weight or bias) launches ``conv3_bwd`` once instead of the
pair: the merged kernel ``kernels/csrc/conv3_bwd.cu`` (replacing
``stencil3.py::_run_bwd_grouped``) stages each brick of x and gy once for
dx, dk and db, on the tensor cores from its own plan (``conv3_bwd_plan``),
with every sum in a fixed order.

Every one of them, and its plain version, takes ``dlim``: the valid D-plane
range [lo, hi] of the TPU kernels' operand of that name (``stencil3.py::
_load_planes``, ``_apply_post``; default [0, D - 1]). Under the prologue
xn is 0 on planes outside it, in the forward, in dk and in the merged
backward; the dx conv's ``post`` epilogue leaves those planes out of
(ds, dt). A D-slab of a spatially sharded volume carries its neighbours'
boundary planes as halo (``models/blocks.py``); an edge slab's missing
neighbour is a zero plane, which the prologue would turn into relu(t) != 0.
The slab's stats are the whole slab's: the caller subtracts the halo
planes' sums (the JAX package's ``blocks.py::_stats_slab_correct``), so the
stats epilogue keeps one range and its f64 fixed-order second pass.

``conv3.launches`` / ``conv3_dk.launches`` / ``conv3_bwd.launches`` count
kernel launches (never the plain versions), and ``.dlim_launches`` those
of them with a valid-plane range.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Affine = Tuple[torch.Tensor, torch.Tensor]
Post = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
DLim = Tuple[int, int]


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


def dlim_range(dlim: Optional[DLim], d: int) -> DLim:
    """The valid D-plane range [lo, hi] of a call on `d` planes (all of
    them when dlim is None), or raise."""
    if dlim is None:
        return 0, d - 1
    lo, hi = (int(v) for v in dlim)
    if not 0 <= lo <= hi < d:
        raise ValueError(f"conv3: dlim {dlim} is no plane range of {d} "
                         "planes")
    return lo, hi


def _plane_mask(x: torch.Tensor, dlim: Optional[DLim]):
    """[1, D, 1, 1, 1] bool of the planes in dlim, or None for all."""
    if dlim is None:
        return None
    lo, hi = dlim_range(dlim, x.shape[1])
    d = torch.arange(x.shape[1], device=x.device)
    return ((d >= lo) & (d <= hi))[None, :, None, None, None]


def _masked(v: torch.Tensor, mask) -> torch.Tensor:
    return v if mask is None else torch.where(
        mask, v, torch.zeros((), dtype=v.dtype, device=v.device))


def _stats(y: torch.Tensor) -> torch.Tensor:
    y32 = y.float()
    return torch.stack([y32.sum(dim=(1, 2, 3)),
                        (y32 * y32).sum(dim=(1, 2, 3))], dim=1)


def conv3_plain(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor],
                pre: Optional[Affine] = None, stats: bool = False,
                softmax: bool = False, post: Optional[Post] = None,
                dlim: Optional[DLim] = None):
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
    volume).

    dlim = (lo, hi): the valid D-plane range of the prologue (xn is 0 on
    the other planes) and of the post sums (the other planes are left
    out); None is every plane."""
    if sum((stats, softmax, post is not None)) > 1:
        raise ValueError("conv3: the stats, softmax and post epilogues are "
                         "exclusive")
    mask = _plane_mask(x, dlim)
    xin = x.float() if pre is None else _masked(_affine_relu(x, pre), mask)
    w = weight.to(x.dtype).float()
    y = F.conv3d(xin.permute(0, 4, 1, 2, 3), w,
                 None if bias is None else bias.float(), padding=1)
    y = y.permute(0, 2, 3, 4, 1)
    if post is not None:
        xs, s, t = post
        gm = torch.where(_pre_activation(xs, (s, t)) > 0, y,
                         torch.zeros((), dtype=y.dtype, device=y.device))
        gs = _masked(gm, mask)
        dst = torch.stack([(gs * xs.float()).sum(dim=(1, 2, 3)),
                           gs.sum(dim=(1, 2, 3))], dim=1)
        dx = gm * s[:, None, None, None, :].float()
        return dx.to(x.dtype).contiguous(), dst
    if softmax:
        y = torch.softmax(y, dim=-1)
    y = y.to(x.dtype).contiguous()
    return (y, _stats(y)) if stats else y


def conv3_dk_plain(x: torch.Tensor, gy: torch.Tensor,
                   pre: Optional[Affine] = None, dlim: Optional[DLim] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain weight and bias gradient of K1 in f32: dk [27, Cin, Cout]
    (the kernel layout, tap-major) and db [Cout], summed over the batch and
    all voxels, from x (through the prologue, 0 on planes outside dlim;
    out-of-volume taps are 0) and the output cotangent gy."""
    xin = x.float() if pre is None else \
        _masked(_affine_relu(x, pre), _plane_mask(x, dlim))
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


def on_device(dev: torch.device):
    """The context a launch on CUDA device `dev` runs in: none where `dev`
    is the current device already, else a device guard."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def raise_if(rc: int, lib, who: str) -> None:
    """Turn a kernel library's return code into a RuntimeError."""
    if rc != 0:
        raise RuntimeError(f"{who} kernel launch failed: "
                           + lib.vaeseg_error_string(rc).decode())


def conv3_op(x: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor],
             kweight: Optional[torch.Tensor] = None,
             pre: Optional[Affine] = None, stats: bool = False,
             softmax: bool = False, post: Optional[Post] = None,
             dlim: Optional[DLim] = None):
    """K1. Same contract as ``conv3_plain``; on CUDA, x must be bf16 and
    ``kweight`` the weight in the kernel's layout (``kernel_weight``)."""
    if x.device.type == "cpu":
        return conv3_plain(x, weight, bias, pre, stats, softmax, post, dlim)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv3: no kernel for device {x.device}")
    if x.dim() != 5:
        raise ValueError(f"conv3: x must be [B, D, H, W, C], got {x.shape}")
    if kweight is None:
        raise ValueError("conv3: CUDA launch needs the kernel-layout weight")
    if sum((stats, softmax, post is not None)) > 1:
        raise ValueError("conv3: the stats, softmax and post epilogues are "
                         "exclusive")
    b, d, h, w, cin = x.shape
    epilogue = "stats" if stats else "softmax" if softmax \
        else "post" if post is not None else "none"
    plan = conv3_plan(b, (d, h, w), cin, kweight.shape[-1], pre is not None,
                      epilogue, sm_count(x.device.index or 0))
    out = conv3_launch(x, kweight, bias, plan, pre, post, dlim)
    conv3.launches += 1
    conv3.dlim_launches += dlim is not None
    return out


# ---- the plan of K1 (kernels/csrc/conv3.cu)

# the plan's fields, in the order conv3.cu's PlanField reads them
CONV3_FIELDS = ("td", "th", "tw", "tiles_d", "tiles_h", "tiles_w", "ci",
                "wm", "wn", "mt", "nt", "splits", "rvox", "parts")
CONV3_EPILOGUES = {"none": 0, "stats": 1, "softmax": 2, "post": 3}
CONV3_WS_BYTES = 32 << 20      # bound of a split plan's workspace
WARPS = 8                      # a block of 256 threads


def _warp_grid(mtiles: int, ntiles: int, sizes: Tuple[int, ...] = (1, 2, 4)
               ) -> Tuple[int, int, int, int]:
    """(wm, wn, mt, nt): the 8 warps as wm x wn over the tile's m16 tiles
    and the chunk's n8 tiles, mt x nt of them a warp (each one of `sizes`,
    the kernel's instantiations, at most 8 together: a thread holds two f32
    sets of them). The fewest tiles a warp, then the fewest shared-memory
    loads per MMA."""
    best = None
    for wn in (1, 2, 4, 8):
        if ntiles % wn:
            continue
        wm = WARPS // wn
        mt = next((m for m in sizes if m * wm >= mtiles), None)
        nt = ntiles // wn
        if mt is None or nt not in sizes or mt * nt > 8:
            continue
        key = (mt * nt, (mt + max(nt // 2, 1)) / (mt * nt))
        if best is None or key < best[0]:
            best = (key, (wm, wn, mt, nt))
    if best is None:
        raise ValueError(f"conv3: no warp grid for {mtiles} m16 x {ntiles} "
                         "n8 tiles")
    return best[1]


@functools.lru_cache(maxsize=None)
def conv3_plan(batch: int, grid: Tuple[int, int, int], cin: int, cout: int,
               prologue: bool, epilogue: str, sms: int,
               splits: Optional[int] = None) -> dict:
    """The plan of one K1 call (``kernels/csrc/conv3.cu``).

    A block takes a td x th x tw brick of output voxels (M, at most 512,
    padded to m16 tiles) of one batch element and a chunk of co output
    channels (N: 8, 16, 32 or 64), and walks K = (input-channel chunk of
    ci, tap, channel) in k16 steps: nks = ceil(27 ci / 16) a chunk. Where
    the grid holds fewer than 2 blocks an SM the brick shrinks (down to 64
    voxels), and where it still holds fewer than one a SM the K steps are
    split over the grid's z axis (split s takes steps [K s // splits,
    K (s + 1) // splits)), whose partials a second kernel adds, rvox voxels
    a block. ``splits`` forces a split count (1: the one-pass kernel).
    Returns the fields the kernel reads (``CONV3_FIELDS``, in ``fields``;
    their ctypes array in ``arg``) and what they imply: the workspace
    shapes ``ws_shape`` (f32 split partials, or None) and ``part_shape``
    (f32 per-block sums of the stats and post epilogues, or None). The
    kernel lays out its shared memory from these fields and refuses a plan
    that does not fit. The result is cached: do not modify it."""
    if epilogue not in CONV3_EPILOGUES:
        raise ValueError(f"conv3: unknown epilogue {epilogue!r}")
    if epilogue == "softmax" and cout > 8:
        raise ValueError(f"conv3: the softmax epilogue takes at most 8 "
                         f"classes on CUDA, got {cout}")
    d, h, w = grid
    ci = 8 if cin <= 8 else 16
    ci_chunks, nks = _ceil(cin, ci), _ceil(27 * ci, 16)
    co = next(c for c in (8, 16, 32, 64) if c >= cout or c == 64)
    co_chunks = _ceil(cout, co)
    mvox = {8: 512, 16: 512, 32: 256, 64: 128}[co]
    tile = [min(w, 8), min(h, 8)]
    tile = [min(d, max(1, mvox // (tile[0] * tile[1])))] + tile[::-1]

    def blocks(t):
        return batch * co_chunks * _ceil(d, t[0]) * _ceil(h, t[1]) \
            * _ceil(w, t[2])

    while blocks(tile) < 2 * sms and tile[0] * tile[1] * tile[2] > 64:
        axis = next(i for i in range(3) if tile[i] == max(tile))
        tile[axis] = _ceil(tile[axis], 2)
    td, th, tw = tile
    nvox, nvol = td * th * tw, d * h * w
    wm, wn, mt, nt = _warp_grid(_ceil(nvox, 16), co // 8)
    k_steps = ci_chunks * nks
    if splits is None:
        splits = 1
        if epilogue != "softmax" and blocks(tile) < sms \
                and cout in (8, 16, 32, 64, 128, 256):
            splits = min(_ceil(2 * sms, blocks(tile)), max(1, k_steps // 4),
                         max(1, CONV3_WS_BYTES // (4 * batch * nvol * cout)))
    if not 1 <= splits <= k_steps:
        raise ValueError(f"conv3: {splits} splits of {k_steps} k16 steps")
    tiles = (_ceil(d, td), _ceil(h, th), _ceil(w, tw))
    per_b = tiles[0] * tiles[1] * tiles[2]
    rvox = 0
    if splits > 1:
        rows = 256 // cout
        rvox = max(rows, _ceil(_ceil(batch * nvol, 2 * sms), rows) * rows)
    sums = epilogue in ("stats", "post")
    parts = (_ceil(nvol, rvox) if splits > 1 else per_b) if sums else 0
    plan = {"td": td, "th": th, "tw": tw, "tiles_d": tiles[0],
            "tiles_h": tiles[1], "tiles_w": tiles[2], "ci": ci, "wm": wm,
            "wn": wn, "mt": mt, "nt": nt, "splits": splits,
            "rvox": rvox, "parts": parts}
    plan.update(fields=[plan[k] for k in CONV3_FIELDS], co=co,
                co_chunks=co_chunks, ci_chunks=ci_chunks, nks=nks,
                k_steps=k_steps, nvox=nvox, mtiles=_ceil(nvox, 16),
                hrows=(td + 2) * (th + 2) * (tw + 2),
                launch_grid=(batch * per_b, co_chunks, splits),
                prologue=prologue, epilogue=epilogue,
                epi=CONV3_EPILOGUES[epilogue],
                ws_shape=(splits, batch * nvol * cout) if splits > 1 else None,
                part_shape=(batch, parts, 2, cout) if sums else None)
    plan["arg"] = plan_arg(plan["fields"])
    return plan


def conv3_launch(x: torch.Tensor, kweight: torch.Tensor,
                 bias: Optional[torch.Tensor], plan: dict,
                 pre: Optional[Affine] = None, post: Optional[Post] = None,
                 dlim: Optional[DLim] = None):
    """One launch of K1 on CUDA tensors under a given ``conv3_plan``, whose
    prologue and epilogue it takes: y, or (y, [B, 2, Cout] f32 sums) for
    the stats and post epilogues; dlim the valid D-plane range. ``conv3_op`` plans the call and counts
    it; chip_smoke.py also times the one-pass plan beside a split one
    through here."""
    from vae_segmentation_tpu_torch.ops.kernels import build

    b, d, h, w, cin = x.shape
    cout = kweight.shape[-1]
    dev = x.device
    lo, hi = dlim_range(dlim, d)
    check_tensor("conv3", "x", x, dev, torch.bfloat16, (b, d, h, w, cin))
    check_tensor("conv3", "kweight", kweight, dev, torch.bfloat16,
                 (27, cin, cout))
    if bias is not None:
        check_tensor("conv3", "bias", bias, dev, torch.float32, (cout,))
    s = t = xs = ps = pt = None
    if pre is not None:
        s, t = check_affine("conv3", pre, dev, b, cin)
    if post is not None:
        xs = post[0]
        check_tensor("conv3", "post x", xs, dev, torch.bfloat16,
                     (b, d, h, w, cout))
        ps, pt = check_affine("conv3 post", post[1:], dev, b, cout)
    if (pre is not None) != plan["prologue"] \
            or (post is not None) != (plan["epilogue"] == "post"):
        raise ValueError("conv3: the prologue or post epilogue differs from "
                         "the plan's")
    sums = plan["part_shape"] is not None
    y = torch.empty((b, d, h, w, cout), dtype=torch.bfloat16, device=dev)
    # one [B, 2, Cout] f32 block serves either epilogue: the output's
    # (sum, sumsq), or the post epilogue's (ds, dt)
    st = torch.empty((b, 2, cout), dtype=torch.float32, device=dev) \
        if sums else None
    ws = None if plan["ws_shape"] is None else \
        torch.empty(plan["ws_shape"], dtype=torch.float32, device=dev)
    part = torch.empty(plan["part_shape"], dtype=torch.float32,
                       device=dev) if sums else None
    lib = build.library("conv3")
    with torch.cuda.device(dev):
        rc = lib.vaeseg_conv3(
            x.data_ptr(), kweight.data_ptr(), _ptr(bias), _ptr(s), _ptr(t),
            _ptr(xs), _ptr(ps), _ptr(pt), y.data_ptr(), _ptr(st), _ptr(ws),
            _ptr(part), b, d, h, w, cin, cout, plan["epi"], lo, hi,
            plan["arg"],
            torch.cuda.current_stream(dev).cuda_stream)
    raise_if(rc, lib, "conv3")
    return y if st is None else (y, st)


# ---- the split plan of the weight-gradient kernels (kernels/csrc/wgrad.cuh)

WGRAD_MODES = {"conv3": 0, "down": 1, "up": 2}
# the plan's fields, in the order wgrad.cuh's PlanField reads them
WGRAD_FIELDS = ("mode", "td", "th", "tw", "tiles_d", "tiles_h", "tiles_w",
                "ci", "co", "t_chunks", "d_chunks", "splits", "mtw")
WGRAD_WS_BYTES = 64 << 20      # bound of a call's workspace
WGRAD_BLOCKS_PER_SM = 4        # blocks a call aims for, per SM


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def wgrad_plan(kind: str, batch: int, grid: Tuple[int, int, int],
               tc: int, dc: int, sms: int) -> dict:
    """The split plan of one weight-gradient call (``wgrad.cuh``).

    kind "conv3" (K1: T = x, D = gy on the volume `grid`), "down" (K2: T =
    x on the fine grid, D = gy on the coarse `grid`) or "up" (K3: T = gy on
    the fine grid, D = x on the coarse `grid`); tc / dc the channels of T /
    D. A block takes a brick of
    td x th x tw voxels of `grid` at a time, a T chunk of ci channels and a
    D chunk of co, and a contiguous range of the batch's tiles: split s of
    `splits` takes tiles [s * ntiles // splits, (s + 1) * ntiles //
    splits). The workspace is [splits, taps, Cin, Cout] f32 plus
    [splits, Cout] f64, at most ``WGRAD_WS_BYTES``. Returns the fields the
    kernel reads (``WGRAD_FIELDS``, in ``fields``) and what they imply. The
    kernel lays out its shared memory from these fields and refuses a plan
    that does not fit (``wgrad.cuh::dk_layout``)."""
    d, h, w = grid
    conv = kind == "conv3"
    taps = 27 if conv else 8
    tw = min(w, 8)
    th = min(h, 4)
    td = min(d, max(1, (128 if conv else 64) // (tw * th)))
    ci = 8 if tc <= 8 else 16
    # D chunks of 32 only beside T chunks of 8: a thread holds MTW x CO / 2
    # f32 sums twice (a tile's and the block's)
    co = 8 if dc <= 8 else 16 if dc <= 16 or ci == 16 else 32
    mtiles = _ceil(taps * ci // 8, 2)
    mtw = next(m for m in (1, 2, 4) if 8 * m >= mtiles)
    t_chunks, d_chunks = _ceil(tc, ci), _ceil(dc, co)
    tiles = (_ceil(d, td), _ceil(h, th), _ceil(w, tw))
    ntiles = batch * tiles[0] * tiles[1] * tiles[2]
    cin, cout = (dc, tc) if kind == "up" else (tc, dc)
    split_bytes = 4 * taps * cin * cout + 8 * cout
    splits = _ceil(WGRAD_BLOCKS_PER_SM * sms, t_chunks * d_chunks)
    splits = max(1, min(splits, ntiles, WGRAD_WS_BYTES // split_bytes))
    plan = {"mode": WGRAD_MODES[kind], "td": td, "th": th, "tw": tw,
            "tiles_d": tiles[0], "tiles_h": tiles[1], "tiles_w": tiles[2],
            "ci": ci, "co": co, "t_chunks": t_chunks, "d_chunks": d_chunks,
            "splits": splits, "mtw": mtw}
    plan.update(fields=[plan[k] for k in WGRAD_FIELDS], taps=taps,
                ntiles=ntiles, cin=cin, cout=cout,
                ws_shape=(splits, taps, cin, cout),
                wsdb_shape=(splits, cout),
                ws_bytes=splits * split_bytes)
    return plan


def plan_arg(fields) -> ctypes.Array:
    """A plan's fields as the int32 array the C function reads (ctypes
    passes an array argument as its address)."""
    return (ctypes.c_int * len(fields))(*fields)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def wgrad_workspace(plan: dict, device):
    """The partials a plan's blocks write once each: (ws f32, wsdb f64),
    uninitialised."""
    return (torch.empty(plan["ws_shape"], dtype=torch.float32,
                        device=device),
            torch.empty(plan["wsdb_shape"], dtype=torch.float64,
                        device=device))


def conv3_dk(x: torch.Tensor, gy: torch.Tensor,
             pre: Optional[Affine] = None, dlim: Optional[DLim] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk [27, Cin, Cout] f32 and db [Cout] f32 of K1. Same contract as
    ``conv3_dk_plain``; on CUDA, x and gy must be bf16."""
    if x.device.type == "cpu":
        return conv3_dk_plain(x, gy, pre, dlim)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv3_dk: no kernel for device {x.device}")
    from vae_segmentation_tpu_torch.ops.kernels import build

    if x.dim() != 5:
        raise ValueError(f"conv3_dk: x must be [B, D, H, W, C], got {x.shape}")
    b, d, h, w, cin = x.shape
    cout = gy.shape[-1]
    dev = x.device
    lo, hi = dlim_range(dlim, d)
    check_tensor("conv3_dk", "x", x, dev, torch.bfloat16, (b, d, h, w, cin))
    check_tensor("conv3_dk", "gy", gy, dev, torch.bfloat16,
                 (b, d, h, w, cout))
    s = t = None
    if pre is not None:
        s, t = check_affine("conv3_dk", pre, dev, b, cin)
    plan = wgrad_plan("conv3", b, (d, h, w), cin, cout,
                      sm_count(dev.index or 0))
    ws, wsdb = wgrad_workspace(plan, dev)
    dk = torch.empty((27, cin, cout), dtype=torch.float32, device=dev)
    db = torch.empty((cout,), dtype=torch.float32, device=dev)
    lib = build.library("conv3_dk")
    with torch.cuda.device(dev):
        rc = lib.vaeseg_conv3_dk(
            x.data_ptr(), gy.data_ptr(), _ptr(s), _ptr(t), ws.data_ptr(),
            wsdb.data_ptr(), dk.data_ptr(), db.data_ptr(), b, d, h, w, cin,
            cout, lo, hi, plan_arg(plan["fields"]),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_if(rc, lib, "conv3_dk")
    conv3_dk.launches += 1
    conv3_dk.dlim_launches += dlim is not None
    return dk, db


def use_merged_bwd() -> bool:
    """The merged dx + dk backward (``conv3_bwd``) under
    VAESEG_MERGED_BWD=1, read when a backward runs, as the JAX package's
    ``stencil3.py::use_merged_bwd`` is read at trace time. Off by default,
    as there: the TPU measured it slower than the pair."""
    return os.environ.get("VAESEG_MERGED_BWD", "0") == "1"


def conv3_bwd_plain(x: torch.Tensor, gy: torch.Tensor, weight: torch.Tensor,
                    pre: Optional[Affine] = None, dlim: Optional[DLim] = None):
    """The plain merged backward of K1: the pair it replaces, the dx conv
    (``conv3_plain`` on the flipped, transposed weight, with the prologue's
    backward as its ``post`` epilogue) and ``conv3_dk_plain``. x
    [B, D, H, W, Cin] and gy [B, D, H, W, Cout] in the compute dtype,
    weight the torch layout [Cout, Cin, 3, 3, 3], pre = (s, t) [B, Cin] f32
    or None, dlim the valid D-plane range of both. Returns (dx in x.dtype,
    dk [27, Cin, Cout] f32, db [Cout] f32, dst [B, 2, Cin] f32 = (ds, dt)
    with the prologue, else None)."""
    w_t = weight.detach().flip(2, 3, 4).transpose(0, 1)
    if pre is None:
        dx, dst = conv3_plain(gy, w_t, None), None
    else:
        dx, dst = conv3_plain(gy, w_t, None, post=(x, *pre), dlim=dlim)
    dk, db = conv3_dk_plain(x, gy, pre, dlim)
    return dx, dk, db, dst


# ---- the plan of the merged backward (kernels/csrc/conv3_bwd.cu)

# the plan's fields, in the order conv3_bwd.cu's PlanField reads them
CONV3_BWD_FIELDS = ("td", "th", "tw", "tiles_d", "tiles_h", "tiles_w", "ci",
                    "co", "wm", "wn", "mt", "nt", "splits", "rvox", "parts")
CONV3_BWD_WS_BYTES = 64 << 20   # bound of the dk workspace
SMEM_PER_SM = 113 << 10         # shared memory of one of two blocks an SM
SMEM_PER_BLOCK = 227 << 10      # the most a block may use


def row_stride(cw: int) -> int:
    """wgrad.cuh::row_stride: a shared-memory row of `cw` bf16 channels,
    an odd number of 16-byte units apart."""
    return cw if (cw // 8) % 2 == 1 else cw + 8


def conv3_bwd_smem(tile: Tuple[int, int, int], ci: int, co: int, wm: int,
                   prologue: bool) -> int:
    """The shared memory a merged-backward block lays out
    (conv3_bwd.cu::bwd_layout): the x halo ring (two slots; under the
    prologue also the lo half of xn), the gy halo ring (two slots, each
    with a zero row past the halo), the weight slice [ci][(tap, o)], the
    geometry tables, the warps' (ds, dt) sums and the f64 db parts."""
    td, th, tw = tile
    hrows = (td + 2) * (th + 2) * (tw + 2)
    kpad = _ceil(td * th * tw, 16) * 16
    xstr, gstr = row_stride(ci), row_stride(co)
    wstr = _ceil(27 * co, 16) * 16 + 8
    nbytes = (2 * hrows * xstr * 2 + (hrows * xstr * 2 if prologue else 0)
              + 2 * (hrows + 1) * gstr * 2 + ci * wstr * 2 + 32 * 4
              + hrows * 4 + 2 * kpad * 4 + wm * 2 * ci * 4)
    return _ceil(nbytes, 8) * 8 + 256 * 8


@functools.lru_cache(maxsize=None)
def conv3_bwd_plan(batch: int, grid: Tuple[int, int, int], cin: int,
                   cout: int, prologue: bool, sms: int) -> dict:
    """The plan of one merged backward call (``kernels/csrc/conv3_bwd.cu``).

    A block takes one input-channel chunk of ci (8 or 16), one
    output-channel chunk of co (8 or 16) and a contiguous range of the
    batch's td x th x tw bricks: split s of `splits` takes bricks
    [s * ntiles // splits, (s + 1) * ntiles // splits). The brick is the
    largest of at most 256 voxels whose block leaves room for two blocks
    an SM (else the largest that fits one), halved while the grid holds
    fewer than two blocks an SM, down to 64 voxels; the splits make the grid
    one wave of the blocks the card holds at once. dx's warp grid is K1's
    (``_warp_grid``, mt and nt 1 or 2). With several co chunks dx's f32
    partials go to a workspace [co_chunks, B D H W Cin] that a second
    kernel adds, rvox voxels a block (Cin at most 256).
    Returns the fields the kernel reads (``CONV3_BWD_FIELDS``, in
    ``fields``; their ctypes array in ``arg``) and what they imply: the
    workspace shapes ``dx_ws_shape`` (or None), ``ws_shape`` (f32 dk
    partials), ``wsdb_shape`` (f64 db partials), ``part_shape`` (f32
    (ds, dt) partials under the prologue, or None) and ``smem``. The kernel
    lays out its shared memory from these fields and refuses a plan that
    does not fit. The result is cached: do not modify it."""
    d, h, w = grid
    ci = 8 if cin <= 8 else 16
    co = 8 if cout <= 8 else 16
    ci_chunks, co_chunks = _ceil(cin, ci), _ceil(cout, co)
    pairs = ci_chunks * co_chunks
    if pairs > 65535:
        raise ValueError(f"conv3_bwd: {pairs} channel-chunk pairs")
    if co_chunks > 1 and cin > 256:
        raise ValueError(f"conv3_bwd: Cin {cin} > 256 with {co_chunks} "
                         "output-channel chunks")
    tw, th = min(w, 8), min(h, 8)
    tile = [min(d, max(1, 256 // (tw * th))), th, tw]

    def nvox(t):
        return t[0] * t[1] * t[2]

    def ntiles(t):
        return batch * _ceil(d, t[0]) * _ceil(h, t[1]) * _ceil(w, t[2])

    def smem(t):
        wm = _warp_grid(_ceil(nvox(t), 16), ci // 8, (1, 2))[0]
        return conv3_bwd_smem(tuple(t), ci, co, wm, prologue)

    def halve(t):
        axis = next(i for i in range(3) if t[i] == max(t))
        t[axis] = _ceil(t[axis], 2)

    while nvox(tile) > 64 and (smem(tile) > SMEM_PER_SM
                               or ntiles(tile) * pairs < 2 * sms):
        halve(tile)
    while smem(tile) > SMEM_PER_BLOCK and nvox(tile) > 1:
        halve(tile)
    td, th, tw = tile
    nv, nvol = nvox(tile), d * h * w
    wm, wn, mt, nt = _warp_grid(_ceil(nv, 16), ci // 8, (1, 2))
    n = ntiles(tile)
    split_bytes = 4 * 27 * cin * cout + 8 * cout
    # one wave: the blocks that fit the card at once (a block walks its
    # bricks in turn, so a second, partial wave doubles the time)
    resident = sms * (2 if smem(tile) <= SMEM_PER_SM else 1)
    splits = max(1, min(n, resident // pairs,
                        CONV3_BWD_WS_BYTES // split_bytes))
    tiles = (_ceil(d, td), _ceil(h, th), _ceil(w, tw))
    per_b = tiles[0] * tiles[1] * tiles[2]
    rvox = parts = 0
    if co_chunks > 1:
        cpad = 1 << (cin - 1).bit_length()
        rows = 256 // cpad
        rvox = max(rows, _ceil(_ceil(batch * nvol, 2 * sms), rows) * rows)
    if prologue:
        parts = _ceil(nvol, rvox) if co_chunks > 1 else per_b
    plan = {"td": td, "th": th, "tw": tw, "tiles_d": tiles[0],
            "tiles_h": tiles[1], "tiles_w": tiles[2], "ci": ci, "co": co,
            "wm": wm, "wn": wn, "mt": mt, "nt": nt, "splits": splits,
            "rvox": rvox, "parts": parts}
    plan.update(fields=[plan[k] for k in CONV3_BWD_FIELDS],
                ci_chunks=ci_chunks, co_chunks=co_chunks, nvox=nv,
                mtiles=_ceil(nv, 16), nks=_ceil(27 * co, 16), ntiles=n,
                hrows=(td + 2) * (th + 2) * (tw + 2), prologue=prologue,
                smem=smem(tile), launch_grid=(splits, pairs),
                dx_ws_shape=(co_chunks, batch * nvol * cin)
                if co_chunks > 1 else None,
                ws_shape=(splits, 27, cin, cout), wsdb_shape=(splits, cout),
                ws_bytes=splits * split_bytes,
                part_shape=(batch, parts, 2, cin) if prologue else None)
    plan["arg"] = plan_arg(plan["fields"])
    return plan


def conv3_bwd(x: torch.Tensor, gy: torch.Tensor, weight: torch.Tensor,
              kweight: Optional[torch.Tensor] = None,
              pre: Optional[Affine] = None, dlim: Optional[DLim] = None):
    """Row 5, the merged backward: same contract as ``conv3_bwd_plain``; on
    CUDA, x and gy must be bf16 and ``kweight`` the forward's weight in the
    kernel's layout (``kernel_weight``), which the kernel reads flipped."""
    if x.device.type == "cpu":
        return conv3_bwd_plain(x, gy, weight, pre, dlim)
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
    lo, hi = dlim_range(dlim, d)
    check_tensor("conv3_bwd", "x", x, dev, torch.bfloat16, (b, d, h, w, cin))
    check_tensor("conv3_bwd", "gy", gy, dev, torch.bfloat16,
                 (b, d, h, w, cout))
    check_tensor("conv3_bwd", "kweight", kweight, dev, torch.bfloat16,
                 (27, cin, cout))
    s = t = dst = part = wsx = None
    plan = conv3_bwd_plan(b, (d, h, w), cin, cout, pre is not None,
                          sm_count(dev.index or 0))
    if pre is not None:
        s, t = check_affine("conv3_bwd", pre, dev, b, cin)
        dst = torch.empty((b, 2, cin), dtype=torch.float32, device=dev)
        part = torch.empty(plan["part_shape"], dtype=torch.float32,
                           device=dev)
    if plan["dx_ws_shape"] is not None:
        wsx = torch.empty(plan["dx_ws_shape"], dtype=torch.float32,
                          device=dev)
    ws, wsdb = wgrad_workspace(plan, dev)
    dx = torch.empty_like(x)
    dk = torch.empty((27, cin, cout), dtype=torch.float32, device=dev)
    db = torch.empty((cout,), dtype=torch.float32, device=dev)
    lib = build.library("conv3_bwd")
    with torch.cuda.device(dev):
        rc = lib.vaeseg_conv3_bwd(
            x.data_ptr(), gy.data_ptr(), kweight.data_ptr(), _ptr(s),
            _ptr(t), dx.data_ptr(), _ptr(dst), dk.data_ptr(), db.data_ptr(),
            _ptr(wsx), ws.data_ptr(), wsdb.data_ptr(), _ptr(part), b, d, h,
            w, cin, cout, lo, hi, plan["arg"],
            torch.cuda.current_stream(dev).cuda_stream)
    raise_if(rc, lib, "conv3_bwd")
    conv3_bwd.launches += 1
    conv3_bwd.dlim_launches += dlim is not None
    return dx, dk, db, dst


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
    differentiable; s and t are None without the prologue; dlim goes to
    every kernel of the backward, as the TPU's ``_bwd_pre`` passes it."""

    @staticmethod
    def forward(ctx, x, weight, bias, s, t, kweight, stats, softmax, dlim):
        pre = None if s is None else (s, t)
        out = conv3_op(x, weight, bias, kweight, pre, stats, softmax,
                       dlim=dlim)
        y = out[0] if stats else out
        ctx.save_for_backward(x, weight, s, t, kweight,
                              y if (stats or softmax) else None)
        ctx.stats, ctx.softmax, ctx.dlim = stats, softmax, dlim
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
        dlim = ctx.dlim
        if need_dx and need_dk and use_merged_bwd():
            dx, dk, db, dst = conv3_bwd(x, gy, weight, kweight, pre, dlim)
        elif need_dx:
            # the dx conv: K1 on the flipped taps with Cin and Cout swapped
            w_t = weight.detach().flip(2, 3, 4).transpose(0, 1)
            kw_t = None if kweight is None else \
                kweight.flip(0).transpose(1, 2).contiguous()
            if pre is None:
                dx = conv3_op(gy, w_t, None, kw_t)
            else:
                dx, dst = conv3_op(gy, w_t, None, kw_t, post=(x, s, t),
                                   dlim=dlim)
        if dst is not None:
            ds, dt = dst[:, 0].to(s.dtype), dst[:, 1].to(t.dtype)
        if need_dk:
            if dk is None:
                dk, db = conv3_dk(x, gy, pre, dlim)
            cout, cin = weight.shape[:2]
            dw = dk.reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2) \
                .to(weight.dtype)
            db = db.to(weight.dtype)
        return dx, dw, db, ds, dt, None, None, None, None


def conv3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          kweight: Optional[torch.Tensor] = None,
          pre: Optional[Affine] = None, stats: bool = False,
          softmax: bool = False, dlim: Optional[DLim] = None):
    """The differentiable K1: y, or (y, stats) with ``stats``; the contract
    of ``conv3_plain``. Gradients reach x, weight, bias and the prologue's
    (s, t) through ``conv3_op`` (dx, ds, dt) and ``conv3_dk`` (dk, db), or
    through one ``conv3_bwd`` under ``use_merged_bwd`` when both sides are
    needed; what does not require a gradient launches nothing. dlim: the
    valid D-plane range of the prologue and of the backward's (ds, dt)."""
    s, t = (None, None) if pre is None else pre
    dlim = None if dlim is None else dlim_range(dlim, x.shape[1])
    return _Conv3Fn.apply(x, weight, bias, s, t, kweight, stats, softmax,
                          dlim)


conv3.launches = conv3.dlim_launches = 0
conv3_dk.launches = conv3_dk.dlim_launches = 0
conv3_bwd.launches = conv3_bwd.dlim_launches = 0
