"""K1 on the tensor cores (``kernels/csrc/conv3.cu``): its plans and a
plain-torch emulation of its arithmetic. The kernel itself runs only on the
card (tests/test_torch_cuda.py, chip_smoke.py); what decides its blocks,
and the precision those blocks keep, is checked here.

(a) ``conv3.conv3_plan`` for every K1 call of the main path (the forward
convs of a Joint and of a ShapeVAE, with their prologue, stats and softmax
epilogues, on the default route and on the norm route of VAESEG_PALLAS=1;
each conv's dx conv, Cin and Cout swapped, with the post epilogue under a
prologue), recorded from a forward at 32^3 and scaled to 128^3, at batches
1, 2 and 4, and at edge shapes: the tiles cover every voxel exactly once,
the channel chunks every channel, the K splits every k16 step, the warp
grid every m16 and n8 tile; the shared memory fits the 227 KB a block may
use, the grid the launch limits and the workspace its bound.
(b) The arithmetic of a K1 call, emulated: xn in f32 split into bf16 hi +
mid + lo, the k16 steps in the kernel's (chunk, tap, channel) order, chains of
``FOLD`` steps summed in f32 and folded into an f32 total with a rounded
add, the K splits added in f64 in order, bias and the epilogue, the
blocks' [2, C] partials added in f64. Held against ``conv3_plain`` under
chip_smoke.py's rules and against an f64 reference; a dropped tap and a
lost lo term fail the f64 gate. IEEE f32 sums stand in for the tensor
cores' accumulation here; the card tests and chip_smoke.py hold the kernel
itself.
"""

import functools
import os
import re
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vae_segmentation_tpu_torch.models import Joint
from vae_segmentation_tpu_torch.models.blocks import Conv3
from vae_segmentation_tpu_torch.ops import conv3

torch.set_num_threads(2)

H100_SMS = 132
SMEM_BYTES = 227 * 1024   # shared memory a block may use on an H100
CONV3_CU = (Path(conv3.__file__).parent / "kernels" / "csrc"
            / "conv3.cu").read_text()
# k16 steps a chain of MMAs, at most, as the kernel is built (conv3.cu)
FOLD = int(re.search(r"#define CONV3_FOLD (\d+)", CONV3_CU).group(1))
# the emulated f32 result (before the bf16 store) against its f64 value,
# over the largest |y|: hi + mid + lo xn and the f32 chains leave up to
# 9.7e-8 on these shapes; hi + mid alone (the lo term lost) 1.9e-6 to
# 2.2e-6, and one bf16 rounding of xn ~1e-3
F64_TOL = 5e-7


@functools.lru_cache(maxsize=None)
def main_path_calls():
    """{(grid, cin, cout, prologue, epilogue)}: every K1 call of the main
    path at 128^3. A Joint (the Seg and the ShapeVAE at full width) runs one
    forward at 32^3 with a 256-wide bottleneck (the same layers at a quarter
    of the extents), on the default route and on the norm route; each
    Conv3's input and options are recorded with its grid scaled by 4, and
    each conv also gives its dx conv (the cotangent's Cout channels in, Cin
    out, the post epilogue under a prologue)."""
    model = Joint(n_class=2, dim=16, bottleneck=256,
                  generator=torch.Generator().manual_seed(0))
    calls = set()

    def hook(module, args, kwargs, out):
        x = args[0]
        grid = tuple(4 * e for e in x.shape[1:4])
        pre = kwargs.get("pre", args[1] if len(args) > 1 else None) \
            is not None
        stats = kwargs.get("stats", args[2] if len(args) > 2 else False)
        softmax = kwargs.get("softmax", args[3] if len(args) > 3 else False)
        cin, cout = x.shape[-1], module.weight.shape[0]
        epi = "stats" if stats else "softmax" if softmax else "none"
        calls.add((grid, cin, cout, pre, epi))
        calls.add((grid, cout, cin, False, "post" if pre else "none"))

    handles = [m.register_forward_hook(hook, with_kwargs=True)
               for m in model.modules() if isinstance(m, Conv3)]
    with torch.no_grad():
        model(torch.zeros(1, 32, 32, 32, 1))
        with mock.patch.dict(os.environ, {"VAESEG_PALLAS": "1"}):
            model(torch.zeros(1, 32, 32, 32, 1))
    for h in handles:
        h.remove()
    return sorted(calls)


def _cover(extent, size, n):
    """How many of n bricks of `size` at k * size hold each index."""
    count = np.zeros(extent, np.int32)
    for k in range(n):
        count[k * size:(k + 1) * size] += 1
    return count


def _row_stride(cw):
    """wgrad.cuh::row_stride: a shared-memory row of `cw` bf16 channels,
    an odd number of 16-byte units apart."""
    return cw if (cw // 8) % 2 == 1 else cw + 8


def smem_bytes(plan, prologue):
    """The shared memory a K1 block lays out for `plan`
    (conv3.cu::conv_layout): the input halo (three times, hi, mid and lo,
    under the prologue), the chunk's weight rows, 32 tap offsets and the
    warps' [wm, 2, co] sums."""
    halo = plan["hrows"] * _row_stride(plan["ci"]) * 2
    wrows = plan["nks"] * 16
    return (halo * (3 if prologue else 1) + wrows * _row_stride(plan["co"]) * 2
            + 32 * 4 + plan["wm"] * 2 * plan["co"] * 4)


def _check_plan(plan, batch, grid, cin, cout, prologue, epilogue):
    d, h, w = grid
    assert plan["fields"] == [plan[k] for k in conv3.CONV3_FIELDS]
    assert list(plan["arg"]) == plan["fields"]
    # every voxel of a batch element in exactly one tile
    for extent, size, n in zip(grid, (plan["td"], plan["th"], plan["tw"]),
                               (plan["tiles_d"], plan["tiles_h"],
                                plan["tiles_w"])):
        assert (_cover(extent, size, n) == 1).all()
    # the warp grid holds every m16 tile of a tile and n8 tile of a chunk
    wm, wn, mt, nt = plan["wm"], plan["wn"], plan["mt"], plan["nt"]
    assert wm * wn == conv3.WARPS and mt in (1, 2, 4) and nt in (1, 2, 4)
    assert mt * nt <= 8 and wm * mt >= plan["mtiles"]
    assert plan["mtiles"] == -(-plan["nvox"] // 16)
    assert plan["co"] == wn * nt * 8 and plan["co"] in (8, 16, 32, 64)
    # channel chunks cover the channels, none empty
    ci, co = plan["ci"], plan["co"]
    assert ci in (8, 16)
    assert (plan["ci_chunks"] - 1) * ci < cin <= plan["ci_chunks"] * ci
    assert (plan["co_chunks"] - 1) * co < cout <= plan["co_chunks"] * co
    # every k16 step of every chunk in exactly one split; the last step of
    # an 8-channel chunk pairs tap 26 with the zero-weight padding tap 27
    assert plan["nks"] == -(-27 * ci // 16)
    k, s = plan["k_steps"], plan["splits"]
    assert k == plan["ci_chunks"] * plan["nks"] and 1 <= s <= k
    ranges = [range(k * i // s, k * (i + 1) // s) for i in range(s)]
    assert all(len(r) >= 1 for r in ranges)
    assert [x for r in ranges for x in r] == list(range(k))
    # launch limits, the shared memory, the workspace
    gx, gy, gz = plan["launch_grid"]
    assert gx == batch * plan["tiles_d"] * plan["tiles_h"] * plan["tiles_w"]
    assert gx < 2 ** 31 and gy <= 65535 and gz == s <= 65535
    assert plan["hrows"] == (plan["td"] + 2) * (plan["th"] + 2) \
        * (plan["tw"] + 2)
    assert smem_bytes(plan, prologue) <= SMEM_BYTES
    nvol = d * h * w
    sums = epilogue in ("stats", "post")
    if s > 1:
        # the second pass: 256 / Cout voxel rows a block, every voxel of a
        # batch element in exactly one block
        assert epilogue != "softmax" and cout in (8, 16, 32, 64, 128, 256)
        rows = 256 // cout
        assert plan["rvox"] % rows == 0 and plan["rvox"] >= rows
        assert plan["ws_shape"] == (s, batch * nvol * cout)
        assert 4 * s * batch * nvol * cout <= conv3.CONV3_WS_BYTES
        blocks = -(-nvol // plan["rvox"])
        assert (_cover(nvol, plan["rvox"], blocks) == 1).all()
        parts = blocks
    else:
        assert plan["ws_shape"] is None
        parts = gx // batch
    assert plan["parts"] == (parts if sums else 0)
    assert plan["part_shape"] == ((batch, parts, 2, cout) if sums else None)
    if epilogue == "softmax":
        assert cout <= 8 and co == 8 and s == 1


def test_main_path_plans():
    calls = main_path_calls()
    kinds = {(c[3], c[4]) for c in calls}
    # the forward's four kinds, the dx conv's two
    assert {(True, "stats"), (False, "stats"), (True, "softmax"),
            (False, "none"), (False, "post")} <= kinds
    split = 0
    for batch in (1, 2, 4):
        for grid, cin, cout, pre, epi in calls:
            plan = conv3.conv3_plan(batch, grid, cin, cout, pre, epi,
                                    H100_SMS)
            _check_plan(plan, batch, grid, cin, cout, pre, epi)
            split += plan["splits"] > 1
            # the one-pass plan exists at every shape (chip_smoke times it
            # beside a split one)
            one = conv3.conv3_plan(batch, grid, cin, cout, pre, epi,
                                   H100_SMS, splits=1)
            _check_plan(one, batch, grid, cin, cout, pre, epi)
    assert split > 0


@pytest.mark.parametrize("batch,grid,cin,cout,pre,epi", [
    (2, (5, 9, 19), 3, 5, True, "stats"),      # ragged tiles, odd channels
    (1, (3, 17, 7), 1, 8, False, "stats"),
    (1, (6, 10, 20), 16, 3, True, "softmax"),  # 3 classes
    (2, (4, 4, 4), 24, 48, False, "none"),     # no split: Cout 48
    (1, (1, 1, 1), 256, 256, True, "stats"),
    (1, (4, 4, 4), 256, 128, False, "post"),
    (8, (128, 128, 128), 16, 8, False, "stats"),
])
def test_edge_plans(batch, grid, cin, cout, pre, epi):
    plan = conv3.conv3_plan(batch, grid, cin, cout, pre, epi, H100_SMS)
    _check_plan(plan, batch, grid, cin, cout, pre, epi)


def test_plans_refuse_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):     # softmax over more than 8 classes
        conv3.conv3_plan(1, (8, 8, 8), 16, 9, False, "softmax", H100_SMS)
    with pytest.raises(ValueError):     # more splits than k16 steps
        conv3.conv3_plan(1, (8, 8, 8), 8, 8, False, "none", H100_SMS,
                         splits=15)
    with pytest.raises(ValueError):
        conv3.conv3_plan(1, (8, 8, 8), 8, 8, False, "max", H100_SMS)


# ---- (b) the kernel's arithmetic, emulated


def _taps(v: torch.Tensor) -> torch.Tensor:
    """[B, D, H, W, C] -> [B, D, H, W, 27, C]: each tap's input at each
    output voxel, zero outside the volume (SAME pads the normalized x)."""
    b, d, h, w, c = v.shape
    p = F.pad(v, (0, 0, 1, 1, 1, 1, 1, 1))
    return torch.stack([p[:, kd:kd + d, kh:kh + h, kw:kw + w]
                        for kd in range(3) for kh in range(3)
                        for kw in range(3)], dim=4)


def emulate(x, weight, bias, pre, post, epi, plan, drop_tap=None,
            lose_lo=False):
    """K1's arithmetic under `plan`: (f32 y before the store, bf16 y, the
    [B, 2, Cout] sums or None)."""
    b, d, h, w, cin = x.shape
    cout = weight.shape[0]
    ci = plan["ci"]
    cin_p = plan["ci_chunks"] * ci
    xn = x.float() if pre is None else conv3._affine_relu(x, pre)
    hi = xn.bfloat16().float()
    mid = (xn - hi).bfloat16().float()
    lo = (xn - hi - mid).bfloat16().float()
    if lose_lo:
        lo = torch.zeros_like(lo)
    wk = conv3.kernel_weight(weight).float()            # [27, Cin, Cout]
    if drop_tap is not None:
        wk[drop_tap] = 0.0

    def kcols(v):
        """[M, K]: the kernel's K order, (chunk, tap (27 + a zero one for
        8-channel chunks), channel), padded to nks k16 steps a chunk."""
        t = F.pad(_taps(v), (0, cin_p - cin)).reshape(-1, 27, cin_p)
        cols = []
        for c in range(plan["ci_chunks"]):
            blk = t[:, :, c * ci:(c + 1) * ci].reshape(t.shape[0], -1)
            cols.append(F.pad(blk, (0, plan["nks"] * 16 - blk.shape[1])))
        return torch.cat(cols, dim=1)

    wcols = []
    wp = F.pad(wk, (0, 0, 0, cin_p - cin))
    for c in range(plan["ci_chunks"]):
        blk = wp[:, c * ci:(c + 1) * ci].reshape(-1, cout)
        wcols.append(F.pad(blk, (0, 0, 0, plan["nks"] * 16 - blk.shape[0])))
    wmat = torch.cat(wcols, dim=0)                      # [K, Cout]
    terms = [kcols(t) for t in ((hi, mid, lo) if pre is not None else (hi,))]
    k, s = plan["k_steps"], plan["splits"]
    parts = []
    for i in range(s):
        total = torch.zeros(terms[0].shape[0], cout)
        acc = torch.zeros_like(total)
        chain = 0
        for ks in range(k * i // s, k * (i + 1) // s):
            cols = slice(16 * ks, 16 * ks + 16)
            for t in terms:
                acc = acc + t[:, cols] @ wmat[cols]
            chain += 1
            if chain == FOLD:
                total, acc, chain = total + acc, torch.zeros_like(acc), 0
        parts.append(total + acc)
    if s == 1:
        y32 = parts[0]
    else:
        y32 = torch.stack(parts).double().sum(dim=0).float()
    if bias is not None:
        y32 = y32 + bias.float()
    y32 = y32.reshape(b, d, h, w, cout)
    if epi == "softmax":
        y32 = torch.softmax(y32, dim=-1)
    sums = None
    if epi == "post":
        xs, ps, pt = post
        gm = torch.where(conv3._pre_activation(xs, (ps, pt)) > 0, y32,
                         torch.zeros(()))
        terms = (gm * xs.float(), gm)
        out = gm * ps[:, None, None, None, :]
    else:
        out = y32
        r = y32.bfloat16().float()
        terms = (r, r * r)
    if epi in ("stats", "post"):
        sums = _block_sums(terms, plan)
    return y32, out.bfloat16(), sums


def _block_sums(terms, plan):
    """[B, 2, C]: each block's f32 partial (a tile of the one-pass plan, a
    run of rvox voxels of the split plan's second pass), added in f64 in
    block order."""
    b, d, h, w, c = terms[0].shape
    out = torch.zeros(b, 2, c, dtype=torch.float64)
    for r, t in enumerate(terms):
        if plan["splits"] > 1:
            flat = t.reshape(b, -1, c)
            blocks = [flat[:, v:v + plan["rvox"]].sum(dim=1)
                      for v in range(0, flat.shape[1], plan["rvox"])]
        else:
            td, th, tw = plan["td"], plan["th"], plan["tw"]
            blocks = [t[:, i:i + td, j:j + th, k:k + tw].sum(dim=(1, 2, 3))
                      for i in range(0, d, td) for j in range(0, h, th)
                      for k in range(0, w, tw)]
        for blk in blocks:
            out[:, r] += blk.double()
    return out.float()


def _inputs(shape, cout, pre, epi, seed=0):
    rng = np.random.default_rng(seed)
    b, d, h, w, cin = shape

    def t(*s, scale=1.0):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                * scale)

    x = t(*shape).bfloat16()
    weight = t(cout, cin, 3, 3, 3, scale=(27 * cin) ** -0.5)
    bias = None if epi == "post" else t(cout)
    aff = (t(b, cin).abs() + 0.5, t(b, cin, scale=0.3)) if pre else None
    post = (t(b, d, h, w, cout).bfloat16(), t(b, cout).abs() + 0.5,
            t(b, cout, scale=0.3)) if epi == "post" else None
    return x, weight, bias, aff, post


def _reference(x, weight, bias, pre, epi):
    """The conv sum in f64 on the f32 xn and the bf16 weight."""
    xn = (x.float() if pre is None else conv3._affine_relu(x, pre)).double()
    wd = weight.to(torch.bfloat16).double()
    y = F.conv3d(xn.permute(0, 4, 1, 2, 3), wd,
                 None if bias is None else bias.double(), padding=1)
    y = y.permute(0, 2, 3, 4, 1)
    return torch.softmax(y, dim=-1) if epi == "softmax" else y


CASES = [  # shape, cout, prologue, epilogue, sms (plan), splits
    ((2, 5, 6, 7, 24), 16, True, "stats", 1, None),     # one pass, 2 chunks
    ((1, 4, 4, 4, 32), 64, False, "post", H100_SMS, None),  # split K
    ((1, 4, 4, 4, 32), 32, True, "stats", H100_SMS, 7),
    ((1, 6, 6, 6, 8), 2, True, "softmax", H100_SMS, None),  # tap pairs
    ((2, 4, 5, 4, 3), 8, False, "stats", 1, None),      # Cin 3 padded
]


@pytest.mark.parametrize("shape,cout,pre,epi,sms,splits", CASES)
def test_emulated_arithmetic(shape, cout, pre, epi, sms, splits):
    x, weight, bias, aff, post = _inputs(shape, cout, pre, epi)
    b, d, h, w, cin = shape
    plan = conv3.conv3_plan(b, (d, h, w), cin, cout, pre, epi, sms, splits)
    y32, y, sums = emulate(x, weight, bias, aff, post, epi, plan)
    # against f64: the hi/lo split and the folded chains keep f32 accuracy
    ref = _reference(x, weight, bias, aff, epi)
    scale = ref.abs().max().item()
    assert (y32.double() - ref).abs().max().item() <= F64_TOL * scale
    # against conv3_plain under chip_smoke.py's rules
    want = conv3.conv3_plain(x, weight, bias, aff, epi == "stats",
                             epi == "softmax", post)
    yw = want[0] if isinstance(want, tuple) else want
    err = (y.float() - yw.float()).abs().max().item()
    assert err <= (1e-2 if epi == "softmax"
                   else 1e-2 * yw.float().abs().max().item())
    if epi == "stats":
        sw = want[1]
        abs_sum = yw.float().abs().sum(dim=(1, 2, 3))
        assert ((sums[:, 0] - sw[:, 0]).abs() / abs_sum).max() <= 1e-3
        assert ((sums[:, 1] - sw[:, 1]).abs()
                / sw[:, 1].clamp_min(1e-30)).max() <= 1e-3
    if epi == "post":
        sw = want[1]
        assert (sums - sw).abs().max() <= 2e-4 * sw.abs().max()


@pytest.mark.parametrize("fault", ["drop_tap", "lose_lo"])
def test_planted_faults_fail_the_f64_gate(fault):
    """A dropped tap, or the prologue's xn as two bf16 terms (the lo term
    lost), lands outside F64_TOL; the emulation as the kernel runs it lands
    inside (test_emulated_arithmetic)."""
    shape, cout, pre, epi, sms, splits = CASES[0]
    x, weight, bias, aff, post = _inputs(shape, cout, pre, epi)
    b, d, h, w, cin = shape
    plan = conv3.conv3_plan(b, (d, h, w), cin, cout, pre, epi, sms, splits)
    kw = {"drop_tap": 13} if fault == "drop_tap" else {"lose_lo": True}
    y32 = emulate(x, weight, bias, aff, post, epi, plan, **kw)[0]
    ref = _reference(x, weight, bias, aff, epi)
    err = (y32.double() - ref).abs().max().item() / ref.abs().max().item()
    assert err > F64_TOL
