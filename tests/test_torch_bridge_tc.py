"""K2 and K3 on the tensor cores (``kernels/csrc/bridge.cu``): their plans,
a plain-torch emulation of their tiling, and the two gate rules that
chip_smoke.py holds the kernels to beside them. The kernels themselves run
only on the card (tests/test_torch_cuda.py, chip_smoke.py); what decides
their blocks and where each value goes is checked here.

(a) ``bridges.bridge_plan`` for every K2 and K3 call of the main path (the
Down and Up bridges of a Joint and of a ShapeVAE, on the default route and
on the norm route of VAESEG_PALLAS=1), recorded from a forward at 32^3 and
scaled to 128^3, at batches 1, 2 and 4, and at odd grids with C of 1, 12
and 40: the bricks cover the coarse grid exactly once and the blocks' walks
every brick once, the channel chunks every channel, the warps' shares every
k16 step; the shared memory fits the 227 KB a block may use; a call with
fewer blocks than two an SM has the smallest brick and channel chunk.
(b) The kernels' tiling, emulated: the rows a brick stages (each row's
position, zero outside the volume), the tap each fine-row offset reads, the
K order (chunk, tap, channel) and its split over the warps, the warps'
partials added in order, where each output lands. With integer-valued
inputs every f32 sum is exact, so the emulation must equal the plain
version exactly: an index error (two taps' offsets swapped) fails.
(c) The rules of chip_smoke.py's gates: K1's stats epilogue by its two
parts (``_compare``: its summation against the f64 sums of its own y, its
stored y against the f64 conv rounded to bf16 once) and phase 9's per-term
rule (``vae_gate``), each on synthetic tensors: a reordered sum passes, a
planted fault of the size the card check plants fails.
"""

import functools
import os
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke as cs
from vae_segmentation_tpu_torch.models import Joint
from vae_segmentation_tpu_torch.models.blocks import DownConv, TConv2
from vae_segmentation_tpu_torch.ops import bridges, conv3

torch.set_num_threads(2)

H100_SMS = 132
SMEM_BYTES = 227 * 1024   # shared memory a block may use on an H100
WARPS = 8


@functools.lru_cache(maxsize=None)
def main_path_calls():
    """{(kind, input grid, cin, cout, prologue)}: every K2 and K3 call of
    the main path at 128^3. A Joint (the Seg and the ShapeVAE at full width)
    runs one forward at 32^3 with a 256-wide bottleneck (the same layers at
    a quarter of the extents), on the default route and on the norm route;
    each bridge's input is recorded with its grid scaled by 4."""
    model = Joint(n_class=2, dim=16, bottleneck=256,
                  generator=torch.Generator().manual_seed(0))
    calls = set()

    def hook(module, args, kwargs, out):
        x = args[0]
        grid = tuple(4 * e for e in x.shape[1:4])
        pre = kwargs.get("pre", args[1] if len(args) > 1 else None)
        kind = "down" if isinstance(module, DownConv) else "up"
        cout = module.weight.shape[1 if kind == "up" else 0]
        calls.add((kind, grid, x.shape[-1], cout, pre is not None))

    handles = [m.register_forward_hook(hook, with_kwargs=True)
               for m in model.modules()
               if isinstance(m, (DownConv, TConv2))]
    with torch.no_grad():
        model(torch.zeros(1, 32, 32, 32, 1))
        with mock.patch.dict(os.environ, {"VAESEG_PALLAS": "1"}):
            model(torch.zeros(1, 32, 32, 32, 1))
    for h in handles:
        h.remove()
    return sorted(calls)


def _row_stride(cw):
    """wgrad.cuh::row_stride: a shared-memory row of `cw` bf16 channels,
    an odd number of 16-byte units apart."""
    return cw if (cw // 8) % 2 == 1 else cw + 8


def smem_bytes(plan, up, pre):
    """The shared memory a block lays out for `plan`
    (bridge.cu::bridge_layout), counted here on its own."""
    nvox, kc, nc = plan["nvox"], plan["kc"], plan["nc"]
    mpad = -(-nvox // 16) * 16
    rows = mpad if up else 8 * nvox
    slots = 2 if plan["tpb"] * plan["k_chunks"] > 1 else 1
    ring = slots * (rows * _row_stride(kc) * 2 + (8 * kc if pre else 0))
    weights = (slots if plan["k_chunks"] > 1 else 1) * 8 * kc \
        * (4 * nc if pre else 2 * _row_stride(nc))
    tables = 4 * (2 * mpad + 8 * nvox if up else rows) + 4 * 8
    if up:
        out = 8 * nvox * _row_stride(nc) * 2
    else:
        out = 0 if pre else plan["wk"] * mpad * _row_stride(nc) * 4
    return ring + weights + tables + out


def _cover(extent, size, n):
    count = np.zeros(extent, np.int32)
    for k in range(n):
        count[k * size:(k + 1) * size] += 1
    return count


def _check_plan(plan, kind, batch, grid, cin, cout, pre, sms=H100_SMS):
    up = kind == "up"
    assert plan["fields"] == [plan[k] for k in bridges.BRIDGE_FIELDS]
    assert list(plan["arg"]) == plan["fields"]
    coarse = grid if up else tuple(e // 2 for e in grid)
    assert plan["coarse"] == coarse
    # every coarse voxel in exactly one brick
    for extent, size, n in zip(coarse, (plan["td"], plan["th"], plan["tw"]),
                               (plan["tiles_d"], plan["tiles_h"],
                                plan["tiles_w"])):
        assert (_cover(extent, size, n) == 1).all()
    nvox = plan["td"] * plan["th"] * plan["tw"]
    assert plan["nvox"] == nvox and plan["mpad"] == -(-nvox // 16) * 16
    ntiles = batch * plan["tiles_d"] * plan["tiles_h"] * plan["tiles_w"]
    assert plan["ntiles"] == ntiles
    # the blocks' walks (bricks blk + k * grid, k < tpb) visit each brick
    # once
    blocks, chunks = plan["launch_grid"]
    walked = sorted(b + k * blocks for b in range(blocks)
                    for k in range(plan["tpb"]) if b + k * blocks < ntiles)
    assert walked == list(range(ntiles))
    assert 1 <= plan["tpb"] <= bridges.BRIDGE_TPB
    assert blocks < 2 ** 31 and chunks <= 65535
    # channel chunks, K chunks
    nc = plan["nc"]
    assert nc in (8, 16) and chunks == -(-cout // nc)
    assert (chunks - 1) * nc < cout <= chunks * nc
    cpad, kc = plan["cpad"], plan["kc"]
    assert cpad == (8 if not up and cin <= 8 else -(-cin // 16) * 16)
    assert kc == 8 if cpad == 8 else kc % 16 == 0
    assert plan["k_chunks"] == -(-cpad // kc) and cin <= cpad
    # the warp grid
    mtiles = plan["mpad"] // 16
    if up:
        assert plan["wm"] == plan["wk"] == 1
        assert plan["mt"] in (1, 2, 4, 8) and 16 * plan["mt"] >= nvox
        assert plan["mt"] * nc // 8 <= 8          # MT x NT m16n8 tiles
    else:
        assert plan["wm"] * plan["wk"] == WARPS
        assert plan["mt"] in (1, 2, 4) and plan["mt"] * plan["wm"] >= mtiles
        assert nvox * nc // 8 <= 256              # one store a thread
        # every k16 step of a chunk in exactly one warp's share
        for cw in {min(kc, cpad - c0) for c0 in range(0, cpad, kc)}:
            nks, wk = cw // 2, plan["wk"]
            shares = [range(nks * i // wk, nks * (i + 1) // wk)
                      for i in range(wk)]
            assert [s for r in shares for s in r] == list(range(nks))
    assert plan["tensor_cores"] == (not pre)
    assert smem_bytes(plan, up, pre) == plan["smem"] <= SMEM_BYTES
    # fewer blocks than two an SM: the smallest brick and channel chunk
    if ntiles * chunks < 2 * sms:
        assert nvox <= 16 and nc == 8


def test_main_path_calls_are_the_models():
    calls = main_path_calls()
    assert ("down", (128, 128, 128), 8, 8, True) in calls
    assert ("down", (128, 128, 128), 8, 8, False) in calls   # norm route
    assert ("down", (8, 8, 8), 128, 128, False) in calls
    assert ("up", (4, 4, 4), 256, 256, False) in calls
    assert ("up", (64, 64, 64), 16, 16, False) in calls
    assert len({c[0] for c in calls}) == 2


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_plans_of_the_main_path(batch):
    for kind, grid, cin, cout, pre in main_path_calls():
        plan = bridges.bridge_plan(kind, batch, grid, cin, cout, pre,
                                   H100_SMS)
        _check_plan(plan, kind, batch, grid, cin, cout, pre)
        if not pre and kind == "down" and plan["wk"] > 1:
            one = bridges.bridge_plan(kind, batch, grid, cin, cout, pre,
                                      H100_SMS, wk=1)
            _check_plan(one, kind, batch, grid, cin, cout, pre)
            assert one["wk"] == 1


@pytest.mark.parametrize("kind,batch,grid,cin,cout,pre", [
    ("up", 3, (5, 9, 19), 12, 40, False),
    ("up", 1, (1, 1, 1), 1, 1, False),
    ("up", 2, (3, 7, 2), 40, 12, False),
    ("up", 1, (6, 6, 6), 300, 24, False),     # K past one staged chunk
    ("down", 3, (5, 9, 19), 40, 12, False),   # odd fine extents
    ("down", 1, (7, 3, 2), 1, 1, True),
    ("down", 2, (9, 17, 5), 12, 40, True),
    ("down", 1, (6, 6, 6), 300, 24, False),
    ("down", 1, (12, 12, 12), 300, 12, True),
])
def test_edge_plans(kind, batch, grid, cin, cout, pre):
    plan = bridges.bridge_plan(kind, batch, grid, cin, cout, pre, H100_SMS)
    _check_plan(plan, kind, batch, grid, cin, cout, pre)


def test_plans_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):     # K3 has no prologue
        bridges.bridge_plan("up", 1, (4, 4, 4), 8, 8, True, H100_SMS)
    with pytest.raises(ValueError):     # no coarse voxel
        bridges.bridge_plan("down", 1, (1, 4, 4), 8, 8, False, H100_SMS)
    with pytest.raises(ValueError):
        bridges.bridge_plan("side", 1, (4, 4, 4), 8, 8, False, H100_SMS)


# ---- (b) the kernels' tiling, emulated


def _pack(d, h, w):
    return (d << 20) | (h << 10) | w


def _unpack(p):
    return p >> 20, (p >> 10) & 1023, p & 1023


def _bricks(plan, batch):
    """(b, d0, h0, w0) of each brick in the order blocks walk them."""
    blocks = plan["launch_grid"][0]
    per_b = plan["tiles_d"] * plan["tiles_h"] * plan["tiles_w"]
    for blk in range(blocks):
        for k in range(plan["tpb"]):
            tile = blk + k * blocks
            if tile >= plan["ntiles"]:
                break
            b, r = divmod(tile, per_b)
            kd, r = divmod(r, plan["tiles_h"] * plan["tiles_w"])
            kh, kw = divmod(r, plan["tiles_w"])
            yield b, kd * plan["td"], kh * plan["th"], kw * plan["tw"]


def emulate_up(x, weight, bias, plan, swap_taps=False):
    """K3's tiling on f32 tensors: each brick's coarse rows staged by their
    positions (zero past nvox and outside the volume), warp `tap` computing
    rows x [8, cpad, nc] weight rows tap * cpad + c, the sums + bias placed
    at the fine voxel mfine[m] + tap offset of the fine brick, each fine
    voxel stored inside the volume. Returns y (NaN where nothing landed)
    and how many times each output was written."""
    b, d, h, w, cin = x.shape
    cout = weight.shape[1]
    td, th, tw, nc = plan["td"], plan["th"], plan["tw"], plan["nc"]
    nvox, mpad, cpad = plan["nvox"], plan["mpad"], plan["cpad"]
    fh, fw = 2 * th, 2 * tw
    wk = weight.permute(2, 3, 4, 0, 1).reshape(8, cin, cout).float()
    wk = F.pad(wk, (0, -cout % nc, 0, cpad - cin))   # [8, cpad, nc chunks]
    pos, mfine = [], []
    for m in range(mpad):
        kd, kh, kw = m // (th * tw), (m // tw) % th, m % tw
        pos.append(_pack(kd, kh, kw) if m < nvox else -1)
        mfine.append((2 * kd * fh + 2 * kh) * fw + 2 * kw if m < nvox else -1)
    toff = [((t >> 2) * fh + ((t >> 1) & 1)) * fw + (t & 1) for t in range(8)]
    if swap_taps:
        toff[1], toff[2] = toff[2], toff[1]
    y = torch.full((b, 2 * d, 2 * h, 2 * w, cout), float("nan"))
    writes = torch.zeros(y.shape[:4] + (cout,), dtype=torch.int32)
    xp = F.pad(x.float(), (0, cpad - cin))
    for o0 in range(0, cout, nc):
        for bb, d0, h0, w0 in _bricks(plan, b):
            rows = torch.zeros(mpad, cpad)
            for m, p in enumerate(pos):
                if p < 0:
                    continue
                pd, ph, pw = _unpack(p)
                gd, gh, gw = d0 + pd, h0 + ph, w0 + pw
                if gd < d and gh < h and gw < w:
                    rows[m] = xp[bb, gd, gh, gw]
            ys = torch.zeros(8 * nvox, nc)
            for tap in range(8):
                out = rows @ wk[tap, :, o0:o0 + nc]
                bv = F.pad(bias.float()[o0:o0 + nc], (0, nc - len(
                    bias[o0:o0 + nc])))
                for m in range(mpad):
                    if mfine[m] >= 0:
                        ys[mfine[m] + toff[tap]] = out[m] + bv
            for v in range(8 * nvox):
                vd = 2 * d0 + v // (fh * fw)
                vh, vw = 2 * h0 + (v // fw) % fh, 2 * w0 + v % fw
                n = min(nc, cout - o0)
                if vd < 2 * d and vh < 2 * h and vw < 2 * w:
                    y[bb, vd, vh, vw, o0:o0 + n] = ys[v, :n]
                    writes[bb, vd, vh, vw, o0:o0 + n] += 1
    return y, writes


def emulate_down(x, weight, bias, pre, plan, swap_taps=False):
    """K2's tiling on f32 tensors: each brick's 8 nvox fine rows staged by
    their positions (zero outside the volume); without the prologue, A[m,
    k] for k = tap * cw + c of each K chunk read at fine row 2i(m) + the
    tap's offset, warp share wki of each chunk's k16 steps summed alone and
    the wk partials added in warp order; with it (the CUDA cores), xn =
    relu(x * s + t) and the (chunk, tap, channel) sum per coarse voxel;
    + bias, stored inside the coarse grid. Returns y (NaN where nothing
    landed) and how many times each output was written."""
    b, d, h, w, cin = x.shape
    cout = weight.shape[0]
    td, th, tw, nc = plan["td"], plan["th"], plan["tw"], plan["nc"]
    nvox, mpad, cpad, kc = plan["nvox"], plan["mpad"], plan["cpad"], \
        plan["kc"]
    dc, hc, wc = plan["coarse"]
    fh, fw = 2 * th, 2 * tw
    wk = weight.permute(2, 3, 4, 1, 0).reshape(8, cin, cout).float()
    wk = F.pad(wk, (0, -cout % nc, 0, cpad - cin))
    xp = F.pad(x.float(), (0, cpad - cin))
    if pre is not None:
        s = F.pad(pre[0].float(), (0, cpad - cin))
        t = F.pad(pre[1].float(), (0, cpad - cin))
    pos = [_pack(r // (fh * fw), (r // fw) % fh, r % fw)
           for r in range(8 * nvox)]
    toff = [((t_ >> 2) * fh + ((t_ >> 1) & 1)) * fw + (t_ & 1)
            for t_ in range(8)]
    if swap_taps:
        toff[1], toff[2] = toff[2], toff[1]
    arow = [(2 * (m // (th * tw)) * fh + 2 * ((m // tw) % th)) * fw
            + 2 * (m % tw) if m < nvox else 0 for m in range(mpad)]
    y = torch.full((b, dc, hc, wc, cout), float("nan"))
    writes = torch.zeros(y.shape, dtype=torch.int32)
    wkk = plan["wk"]
    for o0 in range(0, cout, nc):
        for bb, d0, h0, w0 in _bricks(plan, b):
            rows = torch.zeros(8 * nvox, cpad)
            for r, p in enumerate(pos):
                pd, ph, pw = _unpack(p)
                gd, gh, gw = 2 * d0 + pd, 2 * h0 + ph, 2 * w0 + pw
                if gd < d and gh < h and gw < w:
                    rows[r] = xp[bb, gd, gh, gw]
            if pre is not None:
                rows = torch.relu(rows * s[bb] + t[bb])
            parts = torch.zeros(wkk, mpad, nc)
            for c0 in range(0, cpad, kc):
                cw = min(kc, cpad - c0)
                # A [mpad, 8 cw] and the weight rows [8 cw, nc], K = (tap, c)
                a = torch.stack([rows[[ar + toff[k // cw] for ar in arow],
                                      c0 + k % cw] for k in range(8 * cw)],
                                dim=1)
                wrows = torch.stack([wk[k // cw, c0 + k % cw, o0:o0 + nc]
                                     for k in range(8 * cw)])
                if pre is not None:      # one thread sums all of K
                    parts[0] += a @ wrows
                    continue
                nks = cw // 2
                for i in range(wkk):
                    for ks in range(nks * i // wkk, nks * (i + 1) // wkk):
                        cols = slice(16 * ks, 16 * ks + 16)
                        parts[i] += a[:, cols] @ wrows[cols]
            out = parts[0]
            for i in range(1, wkk):
                out = out + parts[i]
            bv = F.pad(bias.float()[o0:o0 + nc],
                       (0, nc - len(bias[o0:o0 + nc])))
            for m in range(nvox):
                vd = d0 + m // (th * tw)
                vh, vw = h0 + (m // tw) % th, w0 + m % tw
                n = min(nc, cout - o0)
                if vd < dc and vh < hc and vw < wc:
                    y[bb, vd, vh, vw, o0:o0 + n] = (out[m] + bv)[:n]
                    writes[bb, vd, vh, vw, o0:o0 + n] += 1
    return y, writes


def _ints(gen, *shape, lo=-3, hi=3):
    return torch.randint(lo, hi + 1, shape, generator=gen).float()


def _down_case(shape, cout, pre, seed=0):
    gen = torch.Generator().manual_seed(seed)
    b, cin = shape[0], shape[-1]
    x = _ints(gen, *shape)
    weight = _ints(gen, cout, cin, 2, 2, 2, lo=-2, hi=2)
    bias = _ints(gen, cout)
    aff = None
    if pre:
        # x * s + t exact in f32: s in {0.5, 1, 2}, t an integer
        s = torch.tensor([0.5, 1.0, 2.0])[torch.randint(0, 3, (b, cin),
                                                        generator=gen)]
        aff = (s, _ints(gen, b, cin, lo=-1, hi=1))
    return x, weight, bias, aff


UP_CASES = [((2, 3, 5, 6, 12), 40), ((1, 2, 2, 2, 1), 1),
            ((1, 3, 4, 5, 40), 12), ((2, 4, 4, 4, 64), 64)]
DOWN_CASES = [((2, 7, 9, 10, 12), 40, False), ((2, 7, 9, 10, 12), 40, True),
              ((1, 6, 5, 4, 1), 1, True), ((1, 4, 6, 8, 40), 12, False),
              ((1, 8, 8, 8, 64), 64, False), ((2, 16, 16, 16, 8), 8, True),
              ((1, 16, 16, 16, 8), 8, False)]


@pytest.mark.parametrize("shape,cout", UP_CASES)
def test_up_tiling_equals_plain(shape, cout):
    gen = torch.Generator().manual_seed(1)
    x = _ints(gen, *shape)
    weight = _ints(gen, shape[-1], cout, 2, 2, 2, lo=-2, hi=2)
    bias = _ints(gen, cout)
    b, d, h, w, cin = shape
    plan = bridges.bridge_plan("up", b, (d, h, w), cin, cout, False,
                               H100_SMS)
    y, writes = emulate_up(x, weight, bias, plan)
    assert (writes == 1).all()
    assert torch.equal(y, bridges.up_k2s2_plain(x, weight, bias))


@pytest.mark.parametrize("shape,cout,pre", DOWN_CASES)
@pytest.mark.parametrize("one_pass", [False, True])
def test_down_tiling_equals_plain(shape, cout, pre, one_pass):
    x, weight, bias, aff = _down_case(shape, cout, pre)
    b, d, h, w, cin = shape
    plan = bridges.bridge_plan("down", b, (d, h, w), cin, cout, pre,
                               H100_SMS, wk=1 if one_pass else None)
    y, writes = emulate_down(x, weight, bias, aff, plan)
    assert (writes == 1).all()
    assert torch.equal(y, bridges.down_k2s2_plain(x, weight, bias, aff))


def test_a_tap_offset_error_fails_the_emulation():
    """Two taps' fine-row offsets swapped: the tiling no longer equals the
    plain version, so the emulation sees index errors without a card."""
    x, weight, bias, aff = _down_case((1, 4, 6, 8, 12), 12, False)
    plan = bridges.bridge_plan("down", 1, (4, 6, 8), 12, 12, False,
                               H100_SMS)
    y, _ = emulate_down(x, weight, bias, aff, plan, swap_taps=True)
    assert not torch.equal(y, bridges.down_k2s2_plain(x, weight, bias, aff))
    gen = torch.Generator().manual_seed(1)
    x = _ints(gen, 1, 3, 4, 5, 12)
    weight = _ints(gen, 12, 12, 2, 2, 2, lo=-2, hi=2)
    bias = _ints(gen, 12)
    plan = bridges.bridge_plan("up", 1, (3, 4, 5), 12, 12, False, H100_SMS)
    y, _ = emulate_up(x, weight, bias, plan, swap_taps=True)
    assert not torch.equal(y, bridges.up_k2s2_plain(x, weight, bias))


# ---- (d) K2's dx on the tensor cores (bridge_bwd.cu::down_dx_kernel)


def _down_dx_smem(plan, pre):
    """The shared memory a block of K2's dx kernel lays out
    (bridge_bwd.cu::dd_layout), counted here on its own."""
    nvox, nc, kpad = plan["nvox"], plan["nc"], plan["kpad"]
    mpad = -(-nvox // 16) * 16
    slots = 2 if plan["tpb"] > 1 else 1
    gstr = _row_stride(kpad)
    out = 8 * nvox * ((nc + 4) * 4 if pre else _row_stride(nc) * 2)
    return slots * mpad * gstr * 2 + 8 * nc * gstr * 2 \
        + (2 * mpad + 8 * nvox) * 4 + out + WARPS * 2 * 16 * 4


def _check_dx_plan(plan, batch, grid, cin, cout, pre, sms=H100_SMS):
    assert plan["fields"] == [plan[k] for k in bridges.DOWN_DX_FIELDS]
    assert list(plan["arg"]) == plan["fields"]
    cover = tuple(-(-e // 2) for e in grid)
    assert plan["cover"] == cover
    # every covering coarse voxel in exactly one brick
    for extent, size, n in zip(cover, (plan["td"], plan["th"], plan["tw"]),
                               (plan["tiles_d"], plan["tiles_h"],
                                plan["tiles_w"])):
        assert (_cover(extent, size, n) == 1).all()
    nvox = plan["td"] * plan["th"] * plan["tw"]
    assert plan["nvox"] == nvox and plan["mpad"] == -(-nvox // 16) * 16
    # a batch entry's blocks walk its bricks blk + k blocks (k < tpb) once
    per_b = plan["tiles_d"] * plan["tiles_h"] * plan["tiles_w"]
    blocks, tpb = plan["blocks"], plan["tpb"]
    assert blocks == -(-per_b // tpb) and 1 <= tpb <= bridges.BRIDGE_TPB
    walked = sorted(b + k * blocks for b in range(blocks)
                    for k in range(tpb) if b + k * blocks < per_b)
    assert walked == list(range(per_b))
    assert all(b < per_b for b in range(blocks))   # no block without one
    nc, chunks = plan["nc"], plan["chunks"]
    assert nc in (8, 16) and chunks == -(-cin // nc) <= 65535
    assert plan["launch_grid"] == (blocks, chunks, batch)
    assert plan["kpad"] == -(-cout // 16) * 16
    # warp = tap over all m16 tiles: MT x NT <= 8 m16n8 tiles, and at most
    # 4 store items a thread
    assert plan["mt"] in (1, 2, 4, 8) and 16 * plan["mt"] >= nvox
    assert plan["mt"] * nc // 8 <= 8 and 8 * nvox * nc // 8 <= 4 * 256
    assert 2 * max(plan["td"], plan["th"], plan["tw"]) <= 1023
    assert _down_dx_smem(plan, pre) == plan["smem"] <= SMEM_BYTES
    if batch * chunks * per_b < 2 * sms:
        assert nvox <= 16 and nc == 8


def down_calls():
    return [(g, cin, cout, pre) for kind, g, cin, cout, pre
            in main_path_calls() if kind == "down"]


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_down_dx_plans_of_the_main_path(batch):
    calls = down_calls()
    assert ((128, 128, 128), 8, 8, True) in calls and len(calls) == 6
    for grid, cin, cout, pre in calls:
        plan = bridges.down_dx_plan(batch, grid, cin, cout, pre, H100_SMS)
        _check_dx_plan(plan, batch, grid, cin, cout, pre)


@pytest.mark.parametrize("batch,grid,cin,cout,pre,sms", [
    (3, (5, 9, 19), 40, 12, True, H100_SMS),   # odd fine extents
    (1, (7, 3, 2), 1, 1, True, H100_SMS),
    (2, (9, 17, 5), 12, 40, False, H100_SMS),
    (1, (6, 6, 6), 300, 24, False, H100_SMS),  # Cin past 16: chunks
    (1, (12, 12, 12), 24, 300, True, H100_SMS),  # K past 8 k16 steps
    (2, (64, 64, 64), 16, 16, False, 2),       # bricks through the ring
    (1, (8, 8, 8), 16, 640, False, H100_SMS),   # the slice shrinks the brick
])
def test_down_dx_edge_plans(batch, grid, cin, cout, pre, sms):
    plan = bridges.down_dx_plan(batch, grid, cin, cout, pre, sms)
    _check_dx_plan(plan, batch, grid, cin, cout, pre, sms)


def test_down_dx_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):     # no coarse voxel
        bridges.down_dx_plan(1, (1, 4, 4), 8, 8, False, H100_SMS)
    with pytest.raises(ValueError):
        bridges.down_dx_plan(1, (4, 4, 4), 0, 8, False, H100_SMS)
    with pytest.raises(ValueError):     # the weight slice cannot fit
        bridges.down_dx_plan(1, (8, 8, 8), 16, 8192, False, H100_SMS)


def emulate_down_dx(x, gy, weight, pre, plan, swap_taps=False):
    """K2's dx kernel on f32 tensors, block by block: (batch entry,
    channel chunk, block) walks its bricks; a brick's gy rows staged by
    their positions (zero past nvox and outside the coarse grid), warp
    `tap` computing rows @ the weight rows [nc, kpad]^T, its sums placed at
    the fine voxel mfine[m] + the tap's offset of the fine brick, the fine
    brick stored item by item (fine voxel i // G, channel group i % G),
    thread tid = i % 256 taking items tid, tid + 256, ...; under the
    prologue gm = g where x * s + t > 0, dx = gm * s, and each thread's
    (ds, dt) summed over its items in order, then a butterfly over the lanes
    of its channel group, the warps in order, the block's partial written
    into dpart once; dst = the partials added in f64 as parts_reduce adds
    them. Returns dx (NaN where nothing landed), the writes of each dx
    element, dst and the writes of each dpart element."""
    b, fd, fh_, fw_, cin = x.shape
    cout = weight.shape[0]
    dc, hc, wc = fd // 2, fh_ // 2, fw_ // 2
    td, th, tw, nc = plan["td"], plan["th"], plan["tw"], plan["nc"]
    nvox, mpad, kpad = plan["nvox"], plan["mpad"], plan["kpad"]
    blocks, tpb, chunks = plan["blocks"], plan["tpb"], plan["chunks"]
    G = nc // 8
    fh, fw = 2 * th, 2 * tw
    wk = weight.permute(2, 3, 4, 1, 0).reshape(8, cin, cout).float()
    wk = F.pad(wk, (0, kpad - cout, 0, chunks * nc - cin))   # [8, c, o]
    gyp = F.pad(gy.float(), (0, kpad - cout))
    pos, mfine = [], []
    for m in range(mpad):
        kd, kh, kw = m // (th * tw), (m // tw) % th, m % tw
        pos.append(_pack(kd, kh, kw) if m < nvox else -1)
        mfine.append((2 * kd * fh + 2 * kh) * fw + 2 * kw if m < nvox else -1)
    fpos = [_pack(v // (fh * fw), (v // fw) % fh, v % fw)
            for v in range(8 * nvox)]
    toff = [((t >> 2) * fh + ((t >> 1) & 1)) * fw + (t & 1) for t in range(8)]
    if swap_taps:
        toff[1], toff[2] = toff[2], toff[1]
    dx = torch.full(x.shape, float("nan"))
    writes = torch.zeros(x.shape, dtype=torch.int32)
    dpart = torch.full((b, blocks, 2, cin), float("nan"))
    pwrites = torch.zeros(dpart.shape, dtype=torch.int32)
    hw = plan["tiles_h"] * plan["tiles_w"]
    per_b = plan["tiles_d"] * hw
    items = 8 * nvox * G
    for bb in range(b):
        if pre is not None:
            s = F.pad(pre[0][bb].float(), (0, chunks * nc - cin))
            t = F.pad(pre[1][bb].float(), (0, chunks * nc - cin))
        for ch in range(chunks):
            c0 = ch * nc
            for blk in range(blocks):
                sums = torch.zeros(256, 2, 8)    # each thread's (ds, dt)
                for k in range(tpb):
                    tile = blk + k * blocks
                    if tile >= per_b:
                        break
                    kd, r = divmod(tile, hw)
                    kh, kw = divmod(r, plan["tiles_w"])
                    d0, h0, w0 = kd * td, kh * th, kw * tw
                    rows = torch.zeros(mpad, kpad)
                    for m, p in enumerate(pos):
                        if p < 0:
                            continue
                        pd, ph, pw = _unpack(p)
                        gd, gh, gw = d0 + pd, h0 + ph, w0 + pw
                        if gd < dc and gh < hc and gw < wc:
                            rows[m] = gyp[bb, gd, gh, gw]
                    ys = torch.zeros(8 * nvox, nc)
                    for tap in range(8):
                        acc = rows @ wk[tap, c0:c0 + nc].T     # [mpad, nc]
                        for m in range(mpad):
                            if mfine[m] >= 0:
                                ys[mfine[m] + toff[tap]] = acc[m]
                    for it in range(4):
                        for tid in range(256):
                            i = tid + 256 * it
                            if i >= items:
                                break
                            v, u = divmod(i, G)
                            pd, ph, pw = _unpack(fpos[v])
                            vd, vh, vw = 2 * d0 + pd, 2 * h0 + ph, 2 * w0 + pw
                            cu = c0 + 8 * u
                            if vd >= fd or vh >= fh_ or vw >= fw_ or cu >= cin:
                                continue
                            n = min(8, cin - cu)
                            gv = ys[v, 8 * u:8 * u + 8]
                            if pre is None:
                                out = gv
                            else:
                                xv = F.pad(x[bb, vd, vh, vw, cu:cu + n]
                                           .float(), (0, 8 - n))
                                sv, tv = s[cu:cu + 8], t[cu:cu + 8]
                                gm = torch.where(xv * sv + tv > 0, gv,
                                                 torch.zeros(8))
                                out = gm * sv
                                sums[tid, 0] += gm * xv
                                sums[tid, 1] += gm
                            dx[bb, vd, vh, vw, cu:cu + n] = out[:n]
                            writes[bb, vd, vh, vw, cu:cu + n] += 1
                if pre is None:
                    continue
                # the butterfly over each group's lanes, the warps in order
                lanes = sums.view(8, 32, 2, 8)
                o = 16
                while o >= G:
                    lanes = lanes + lanes[:, torch.arange(32) ^ o]
                    o //= 2
                part = lanes[0, :G]
                for w in range(1, 8):
                    part = part + lanes[w, :G]
                for u in range(G):
                    for r in range(2):
                        for e in range(8):
                            c = c0 + 8 * u + e
                            if c < cin:
                                dpart[bb, blk, r, c] = part[u, r, e]
                                pwrites[bb, blk, r, c] += 1
    dst = None
    if pre is not None:
        # parts_reduce: warp w adds partials w, w + 32, ... in f64, then the
        # 32 warps' sums in order
        p64 = dpart.double()
        warp_sums = [p64[:, w::32].sum(dim=1) if w < blocks else
                     torch.zeros(b, 2, cin, dtype=torch.float64)
                     for w in range(32)]
        total = warp_sums[0]
        for w in range(1, 32):
            total = total + warp_sums[w]
        dst = total.float()
    return dx, writes, dst, pwrites


DOWN_DX_EMULATED = [
    ((2, 7, 9, 10, 12), 40, True, H100_SMS),    # odd fine extent, Cin 12
    ((2, 7, 9, 10, 12), 40, False, H100_SMS),
    ((1, 6, 5, 4, 1), 1, True, H100_SMS),
    ((1, 8, 8, 8, 40), 12, False, H100_SMS),    # three channel chunks
    ((1, 16, 16, 16, 8), 8, True, H100_SMS),
    ((2, 16, 12, 16, 8), 8, True, 1),           # bricks through the ring
    ((1, 6, 4, 4, 16), 160, False, H100_SMS),   # K past 8 k16 steps
]


@pytest.mark.parametrize("shape,cout,pre,sms", DOWN_DX_EMULATED)
def test_down_dx_tiling_equals_plain(shape, cout, pre, sms):
    """With integer-valued inputs every f32 sum is exact: the emulated
    blocks must equal down_k2s2_bwd_plain on the even part of the fine
    grid, each dx element written once, an odd extent's planes 0, each
    dpart element written once and dst equal."""
    b, d, h, w, cin = shape
    x, weight, _, aff = _down_case(shape, cout, pre)
    gen = torch.Generator().manual_seed(3)
    gy = _ints(gen, b, d // 2, h // 2, w // 2, cout)
    plan = bridges.down_dx_plan(b, (d, h, w), cin, cout, pre, sms)
    dx, writes, dst, pwrites = emulate_down_dx(x, gy, weight, aff, plan)
    assert (writes == 1).all()
    e = (2 * (d // 2), 2 * (h // 2), 2 * (w // 2))
    want_dx, _, _, want_dst = bridges.down_k2s2_bwd_plain(
        x[:, :e[0], :e[1], :e[2]].contiguous(), gy, weight, aff)
    assert torch.equal(dx[:, :e[0], :e[1], :e[2]], want_dx)
    rest = torch.ones(dx.shape, dtype=torch.bool)
    rest[:, :e[0], :e[1], :e[2]] = False
    assert (dx[rest] == 0).all()
    if pre:
        assert (pwrites == 1).all()
        assert torch.equal(dst, want_dst)
    if sms == 1:
        assert plan["tpb"] > 1


def test_a_tap_offset_error_fails_the_dx_emulation():
    """Two taps' fine-voxel offsets swapped in K2's dx: the emulated blocks
    no longer equal the plain version."""
    shape, cout = (1, 4, 6, 8, 12), 12
    x, weight, _, aff = _down_case(shape, cout, True)
    gy = _ints(torch.Generator().manual_seed(3), 1, 2, 3, 4, cout)
    plan = bridges.down_dx_plan(1, shape[1:4], 12, cout, True, H100_SMS)
    dx, _, dst, _ = emulate_down_dx(x, gy, weight, aff, plan,
                                    swap_taps=True)
    want_dx, _, _, want_dst = bridges.down_k2s2_bwd_plain(x, gy, weight, aff)
    assert not torch.equal(dx, want_dx)


_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_114down_dx_kernelILi8ELi1ELb1ELb0EEEvNS_10DownDxArgsE
\t.headerflags\t@"EF_CUDA_SM90"
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0110*/                   HMMA.16816.F32.BF16 R16, R8, R14, R16 ;
\t\tFunction : _ZN12_GLOBAL__N_112up_dx_kernelILi1EEEvNS_6DxArgsE
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
\t\tFunction : _ZN12_GLOBAL__N_114down_dx_kernelILi1ELi2ELb0ELb0EEEvNS_10DownDxArgsE
        /*0100*/                   FFMA R4, R8, R12, R4 ;
\t\tFunction : _ZN5wgrad9dk_kernelILi1ELi2ELi16ELb1EEEvNS_4ArgsE
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
"""


def test_phase1_counts_tensor_core_instructions_by_kernel():
    """chip_smoke.py's phase 1 counts a kernel's HMMA in its own functions
    (every template instance), not in the library's others."""
    assert cs.kernel_sass(_SASS, "down_dx_kernel") == {
        "HMMA": 2, "HGMMA": 0, "LDG.128": 0, "STG.128": 0, "functions": 2}
    assert cs.kernel_sass(_SASS, "up_dx_kernel")["HMMA"] == 1
    assert cs.kernel_sass(_SASS, "dk_kernel")["functions"] == 1
    assert cs.kernel_sass(_SASS, "norm_reduce_kernel")["functions"] == 0
    assert ("bridge_bwd", "down_dx_kernel") in cs.TENSOR_CORE_KERNELS


# ---- (c) the gate rules of chip_smoke.py


def _k1_call(seed=0):
    """A K1 call with the stats epilogue under the prologue at a 4^3
    stage (64 voxels a channel, where one bf16 flip of a large voxel moves
    the sumsq by ~1e-3): inputs and the plain version's output."""
    gen = torch.Generator().manual_seed(seed)
    b, c = 2, 32
    x = torch.randn(b, 4, 4, 4, c, generator=gen).bfloat16()
    w = torch.randn(c, c, 3, 3, 3, generator=gen) * (27 * c) ** -0.5
    bias = torch.randn(c, generator=gen)
    aff = (torch.rand(b, c, generator=gen) + 0.5,
           torch.randn(b, c, generator=gen) * 0.3)
    return (x, w, bias, aff), conv3.conv3_plain(x, w, bias, aff, stats=True)


def _bits(y, step):
    """bf16 y with each element `step` (a tensor or an int) representable
    values further from zero (nearer, where negative)."""
    return (y.view(torch.int16) + step).view(torch.bfloat16)


def _with_own_stats(y):
    """(y, the f32 stats of y summed in f64): a stats epilogue whose
    summation is exact, so that only y's rules can fail."""
    return y, cs.stats_of(torch, y).float()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k1_stats_rule_holds_a_reordered_sum(seed):
    """The plain version's own y with its stats summed as 64 partials in a
    shuffled order (what K1's per-block partials do): inside both parts of
    the rule, its summation far inside K1_SUM_TOL."""
    inputs, want = _k1_call(seed)
    y = want[0]
    reordered = cs._shuffled_stats(torch, seed)(y)
    rec = cs._compare(torch, "conv3", False, (y, reordered), want, inputs)
    assert rec["ok"], rec
    assert max(rec["stats_own_sum_err"], rec["stats_own_sumsq_rel"]) \
        < 0.1 * cs.K1_SUM_TOL
    assert rec["y_beyond_ulp"] == 0 and rec["y_flips"] <= rec["y_flip_limit"]


def test_k1_stats_rule_fails_a_dropped_bias():
    """One output channel's bias dropped (its largest), y and stats alike
    (the stats the sums of the faulted y): outside the rule by the stored
    y, its elements far beyond one ulp of the f64 conv, and by the bf16
    rule against the plain version; its summation alone is right."""
    inputs, want = _k1_call()
    x, w, bias, aff = inputs
    planted = bias.clone()
    planted[planted.abs().argmax()] = 0.0
    got = conv3.conv3_plain(x, w, planted, aff, stats=True)
    rec = cs._compare(torch, "conv3", False, got, want, inputs)
    assert not rec["ok"]
    assert rec["y_beyond_ulp"] >= 2 * 4 * 4 * 4
    assert rec["max_abs_err"] > 1e-2 * rec["max_abs_y"]
    assert max(rec["stats_own_sum_err"], rec["stats_own_sumsq_rel"]) \
        <= cs.K1_SUM_TOL


def test_k1_stats_rule_fails_a_summation_fault():
    """One channel's sumsq 1e-4 off (relative), y untouched: outside the
    summation rule, though its distance from the f64 stats stays under
    the former gate of 1e-3 on that distance."""
    inputs, want = _k1_call()
    y, st = want
    st = st.clone()
    st[:, 1, int(st[0, 1].argmax())] *= 1 + 1e-4
    rec = cs._compare(torch, "conv3", False, (y, st), want, inputs)
    assert not rec["ok"]
    assert rec["stats_own_sumsq_rel"] > cs.K1_SUM_TOL
    assert rec["stats_sumsq_rel"] < 1e-3
    assert rec["y_beyond_ulp"] == 0


def test_k1_stats_rule_fails_a_stored_y_two_ulps_off():
    """One element of y (the largest) two bf16 values off, its stats summed
    from it exactly: outside the rule by that one element."""
    inputs, want = _k1_call()
    y = want[0].clone()
    flat = y.view(-1)
    k = int(flat.float().abs().argmax())
    flat[k] = _bits(flat[k:k + 1], 2)[0]
    rec = cs._compare(torch, "conv3", False, _with_own_stats(y), want,
                      inputs)
    assert not rec["ok"]
    assert rec["y_beyond_ulp"] == 1


def _flipped(ref, n):
    """The f64 conv rounded to bf16 once, with its n elements nearest a
    rounding midpoint rounded the other way: each within one ulp."""
    ref = ref.contiguous()
    once = ref.to(torch.bfloat16)
    away = (once.double().abs() > ref.abs()).to(torch.int16)
    other = _bits(once, 1 - 2 * away)
    gap = ((ref - once.double()).abs() / cs.bf16_ulp(torch, ref)).view(-1)
    out = once.clone().view(-1)
    idx = gap.argsort(descending=True)[:n]
    out[idx] = other.view(-1)[idx]
    return out.view(once.shape)


def test_k1_stats_rule_takes_the_plain_versions_distance_where_larger():
    """Each element within one ulp, and K1's values off the once-rounded
    f64 conv up to twice the plain version's count pass; three times it
    fail."""
    inputs, _ = _k1_call()
    ref, _ = cs.k1_reference(torch, *inputs)
    plain = _flipped(ref, 12)
    want = _with_own_stats(plain)
    for n, ok in ((24, True), (36, False)):
        rec = cs._compare(torch, "conv3", False,
                          _with_own_stats(_flipped(ref, n)), want, inputs)
        assert rec["plain_y_flips"] == 12 and rec["y_flips"] == n
        assert rec["y_beyond_ulp"] == 0
        assert rec["ok"] == ok, rec


def test_k1_stats_rule_counts_a_value_many_voxels_share_once():
    """A constant input gives every interior voxel of a channel one sum: a
    path that rounds that one value the other way flips hundreds of
    elements, but one distinct value a batch entry, inside the floor; a
    path that flips as many distinct values as elements fails."""
    inputs, _ = _k1_call()
    x, w, bias, aff = inputs
    x = torch.ones(2, 8, 8, 8, x.shape[-1]).bfloat16()
    inputs = (x, w, bias, aff)
    ref, _ = cs.k1_reference(torch, *inputs)
    ref = ref.contiguous()
    once = ref.to(torch.bfloat16)
    want = _with_own_stats(once)
    away = (once.double().abs() > ref.abs()).to(torch.int16)
    other = _bits(once, 1 - 2 * away)
    y = once.clone()
    y[:, 1:-1, 1:-1, 1:-1, 0] = other[:, 1:-1, 1:-1, 1:-1, 0]
    rec = cs._compare(torch, "conv3", False, _with_own_stats(y), want,
                      inputs)
    assert rec["y_flip_elements"] == 2 * 6 ** 3 and rec["y_flips"] == 2
    assert rec["y_beyond_ulp"] == 0 and rec["ok"], rec
    rec = cs._compare(torch, "conv3", False,
                      _with_own_stats(_flipped(cs.k1_reference(
                          torch, *_k1_call()[0])[0], 40)),
                      _with_own_stats(_flipped(cs.k1_reference(
                          torch, *_k1_call()[0])[0], 0)), _k1_call()[0])
    assert rec["y_flips"] == rec["y_flip_elements"] == 40
    assert not rec["ok"]


def test_k1_stats_rule_has_a_floor_where_the_plain_version_flips_none():
    """A plain version with no element off the once-rounded value: K1 may
    have up to K1_FLIP_FLOOR."""
    inputs, _ = _k1_call()
    ref, _ = cs.k1_reference(torch, *inputs)
    want = _with_own_stats(_flipped(ref, 0))
    for n, ok in ((cs.K1_FLIP_FLOOR, True), (cs.K1_FLIP_FLOOR + 1, False)):
        rec = cs._compare(torch, "conv3", False,
                          _with_own_stats(_flipped(ref, n)), want, inputs)
        assert rec["plain_y_flips"] == 0 and rec["ok"] == ok, rec


def _terms(gen, base=None, noise=0.0):
    """A synthetic vae_terms result: `base` with every value moved by
    `noise` relative (a reordered sum's size), or a fresh one."""
    def move(t):
        return t + noise * t.abs().mean() * torch.randn(t.shape,
                                                        generator=gen)
    if base is None:
        grads = {f"enc{i}.weight": torch.randn(16, 8, generator=gen)
                 for i in range(6)}
        return {"losses": {"dice_loss": 0.62, "kl_loss": 890.1},
                "grads_dice": grads,
                "grads_kl": {k: torch.randn(16, 8, generator=gen)
                             for k in grads},
                "mean": torch.randn(4, 128, generator=gen),
                "std": torch.randn(4, 128, generator=gen).relu()}
    return {"losses": {k: v * (1 + noise * float(torch.randn(
                1, generator=gen))) for k, v in base["losses"].items()},
            "grads_dice": {k: move(v) for k, v in base["grads_dice"].items()},
            "grads_kl": {k: move(v) for k, v in base["grads_kl"].items()},
            "mean": move(base["mean"]), "std": move(base["std"]).relu()}


def _paths(noise=1e-4, seed=0):
    gen = torch.Generator().manual_seed(seed)
    p = _terms(gen)
    return p, _terms(gen, p, noise), [_terms(gen, p, noise)
                                      for _ in range(3)], \
        _terms(gen, p, noise)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_phase9_rule_holds_a_reordered_sum(seed):
    """A kernel path as far from the plain path as a reordered plain sum:
    every part of the rule holds."""
    p, r, s, k = _paths(seed=seed)
    rec = cs.vae_gate(torch, k, p, r, s)
    assert rec["ok"], rec
    assert rec["dice_worst_ratio"] < cs.DRIFT_MULTIPLE


def test_phase9_rule_fails_a_scaled_dice_gradient():
    """One Dice-term gradient tensor scaled by 1.01 (a weight gradient's
    fault of the size the card check plants)."""
    p, r, s, k = _paths()
    key = sorted(k["grads_dice"])[2]
    k["grads_dice"][key] = k["grads_dice"][key] * 1.01
    rec = cs.vae_gate(torch, k, p, r, s)
    assert not rec["ok"] and rec["dice_worst_tensor"] == key


def test_phase9_rule_fails_a_moved_latent():
    """The encoder's std moved by 1e-2 on average, far past the plain
    orders' drift."""
    p, r, s, k = _paths()
    k["std"] = k["std"] + 1e-2
    rec = cs.vae_gate(torch, k, p, r, s)
    assert not rec["ok"]
    assert rec["latent"]["std"]["kernel_vs_plain"] \
        > rec["latent"]["std"]["gate"]


def test_phase9_rule_does_not_hold_the_kl_term_end_to_end():
    """A unit's std near the ReLU's zero makes the KL term's gradient jump
    on any path (its gradient in std reaches 1e5): the end-to-end ratio is
    reported, the rule holds the term on one shared forward instead."""
    p, r, s, k = _paths()
    key = sorted(k["grads_kl"])[0]
    k["grads_kl"][key] = k["grads_kl"][key] * 50.0
    rec = cs.vae_gate(torch, k, p, r, s)
    assert rec["ok"]
    assert rec["kl_term_worst_ratio_not_gated"] > 100 * cs.DRIFT_MULTIPLE
