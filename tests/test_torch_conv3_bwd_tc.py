"""The merged conv backward on the tensor cores (``kernels/csrc/
conv3_bwd.cu``, row 5 of the TPU kernel table): its plans and a plain-torch
emulation of its blocks. The kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py, tools/conv3_bwd_calls.py); what
decides its blocks, and the order of every sum, is checked here.

(a) ``conv3.conv3_bwd_plan`` for every conv backward of the main path that
the merged route takes (the convs of a Joint, Seg and ShapeVAE, recorded
from a forward at 32^3 and scaled to 128^3), at batches 1, 2 and 4, and at
edge shapes (ragged bricks, Cin 3, one voxel, 4^3 x 256): the bricks cover
every voxel once, the chunks every channel, the splits every brick (each at
least one), the grid is one wave, the warp grid covers dx's tiles, the
shared memory fits the 227 KB a block may use and the workspace its bound.
(b) The kernel's blocks, emulated: each block (split, input-channel chunk,
output-channel chunk) walks its bricks, stages the x and gy halos (zero
outside the volume and past the channels), adds dk over the brick's voxels
in chains of ``FOLD`` k16 steps folded into an f32 total (xn as bf16 hi +
lo under the prologue), and dx over (tap, o) in k16 steps against the
flipped weight; every workspace element is written exactly once, the
splits and the output-channel chunks are added in f64 in order, (ds, dt)
by brick or by rvox voxels, in f64. With integer-valued inputs every sum
is exact, so the emulation must equal ``conv3_bwd_plain`` bit for bit;
with real inputs it is held to an f64 reference.
(c) Planted faults fail: a dropped tap, a lost lo term, a split added
twice.
(d) No kernel source of the port adds with atomics.
"""

import functools
import re
from pathlib import Path

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
CSRC = Path(conv3.__file__).parent / "kernels" / "csrc"
# k16 steps a chain of MMAs, at most, as the kernel is built
FOLD = int(re.search(r"constexpr int kFold = (\d+);",
                     (CSRC / "conv3_bwd.cu").read_text()).group(1))
# the emulated f32 dx and dk against their f64 value, over the largest
# element: hi + lo xn and the folded f32 chains leave up to 1.3e-7 of dx
# and 3.8e-6 of dk on these cases (a cotangent orthogonal to constants, as
# under an InstanceNorm, cancels dk far below its terms); xn rounded to
# bf16 once (the lo term lost) 1.8e-3 to 3.3e-3 of dk
DX_TOL, DK_TOL = 1e-6, 2e-5


@functools.lru_cache(maxsize=None)
def main_path_calls():
    """{(grid, cin, cout, prologue)}: every conv of a Joint (its Seg and its
    ShapeVAE at full width) at 128^3, from a forward at 32^3 with a
    256-wide bottleneck (the same layers at a quarter of the extents), on
    the default route; each conv's backward needs dx and dk on the merged
    route but the entry convs'."""
    model = Joint(n_class=2, dim=16, bottleneck=256,
                  generator=torch.Generator().manual_seed(0))
    calls = set()

    def hook(module, args, kwargs, out):
        x = args[0]
        pre = kwargs.get("pre", args[1] if len(args) > 1 else None)
        calls.add((tuple(4 * e for e in x.shape[1:4]), x.shape[-1],
                   module.weight.shape[0], pre is not None))

    handles = [m.register_forward_hook(hook, with_kwargs=True)
               for m in model.modules() if isinstance(m, Conv3)]
    with torch.no_grad():
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


def _check_plan(plan, batch, grid, cin, cout, prologue, sms=H100_SMS):
    d, h, w = grid
    assert plan["fields"] == [plan[k] for k in conv3.CONV3_BWD_FIELDS]
    assert list(plan["arg"]) == plan["fields"]
    tile = (plan["td"], plan["th"], plan["tw"])
    ntiles = (plan["tiles_d"], plan["tiles_h"], plan["tiles_w"])
    # every voxel of a batch element in exactly one brick
    for extent, size, n in zip(grid, tile, ntiles):
        assert (_cover(extent, size, n) == 1).all()
    n = batch * ntiles[0] * ntiles[1] * ntiles[2]
    assert plan["ntiles"] == n
    # every brick in exactly one split, each split at least one
    s = plan["splits"]
    ranges = [range(n * i // s, n * (i + 1) // s) for i in range(s)]
    assert all(len(r) >= 1 for r in ranges)
    assert [t for r in ranges for t in r] == list(range(n))
    # the channel chunks cover the channels, none empty
    ci, co = plan["ci"], plan["co"]
    assert ci in (8, 16) and co in (8, 16)
    assert (plan["ci_chunks"] - 1) * ci < cin <= plan["ci_chunks"] * ci
    assert (plan["co_chunks"] - 1) * co < cout <= plan["co_chunks"] * co
    pairs = plan["ci_chunks"] * plan["co_chunks"]
    assert plan["launch_grid"] == (s, pairs) and pairs <= 65535
    # one wave: the blocks that fit the card at once
    resident = sms * (2 if plan["smem"] <= conv3.SMEM_PER_SM else 1)
    assert s == 1 or s * pairs <= resident
    # dx's warp grid covers the brick's m16 tiles and the chunk's n8 tiles
    wm, wn, mt, nt = plan["wm"], plan["wn"], plan["mt"], plan["nt"]
    assert wm * wn == conv3.WARPS and mt in (1, 2) and nt in (1, 2)
    assert wm * mt >= plan["mtiles"] == -(-plan["nvox"] // 16)
    assert wn * nt * 8 == ci
    assert plan["nks"] == -(-27 * co // 16)
    # the shared memory and the workspaces
    assert plan["smem"] == conv3.conv3_bwd_smem(tile, ci, co, wm, prologue)
    assert plan["smem"] <= SMEM_BYTES
    assert plan["hrows"] == (tile[0] + 2) * (tile[1] + 2) * (tile[2] + 2)
    assert max(tile) + 2 <= 1023
    assert plan["ws_shape"] == (s, 27, cin, cout)
    assert plan["wsdb_shape"] == (s, cout)
    assert plan["ws_bytes"] <= conv3.CONV3_BWD_WS_BYTES or s == 1
    nvol = d * h * w
    if plan["co_chunks"] > 1:
        assert cin <= 256
        assert plan["dx_ws_shape"] == (plan["co_chunks"], batch * nvol * cin)
        cpad = 1 << (cin - 1).bit_length()
        assert plan["rvox"] % (256 // cpad) == 0 and plan["rvox"] > 0
        blocks = -(-nvol // plan["rvox"])
        assert (_cover(nvol, plan["rvox"], blocks) == 1).all()
        parts = blocks
    else:
        assert plan["dx_ws_shape"] is None and plan["rvox"] == 0
        parts = ntiles[0] * ntiles[1] * ntiles[2]
    assert plan["parts"] == (parts if prologue else 0)
    assert plan["part_shape"] == ((batch, parts, 2, cin) if prologue
                                  else None)


def test_main_path_plans():
    calls = main_path_calls()
    assert {c[3] for c in calls} == {True, False}
    assert ((4, 4, 4), 256, 256, True) in calls
    several = 0
    for batch in (1, 2, 4):
        for grid, cin, cout, pre in calls:
            plan = conv3.conv3_bwd_plan(batch, grid, cin, cout, pre,
                                        H100_SMS)
            _check_plan(plan, batch, grid, cin, cout, pre)
            several += plan["co_chunks"] > 1
    assert several > 0


@pytest.mark.parametrize("batch,grid,cin,cout,pre", [
    (2, (5, 9, 19), 3, 5, True),      # ragged bricks, odd channels
    (1, (3, 17, 7), 1, 8, False),
    (1, (1, 1, 1), 16, 16, True),     # one voxel
    (4, (4, 4, 4), 256, 256, True),   # the deepest stage at batch 4
    (2, (4, 4, 4), 24, 48, False),    # three output-channel chunks
    (1, (8, 16, 16), 16, 2, True),    # a head: Cout 2
    (8, (128, 128, 128), 16, 8, False),
])
def test_edge_plans(batch, grid, cin, cout, pre):
    plan = conv3.conv3_bwd_plan(batch, grid, cin, cout, pre, H100_SMS)
    _check_plan(plan, batch, grid, cin, cout, pre)
    few = conv3.conv3_bwd_plan(batch, grid, cin, cout, pre, 4)
    _check_plan(few, batch, grid, cin, cout, pre, sms=4)


def test_plans_refuse_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):    # dx's second pass: Cin <= 256
        conv3.conv3_bwd_plan(1, (4, 4, 4), 512, 32, False, H100_SMS)
    # one Cout chunk takes any Cin
    conv3.conv3_bwd_plan(1, (4, 4, 4), 512, 16, False, H100_SMS)


# ---- (b) the kernel's blocks, emulated


def _taps_of(halo, tile):
    """[27, nvox, C]: each tap's rows of a staged halo for the brick's
    voxels (voxel k = (kd, kh, kw), w fastest)."""
    td, th, tw = tile
    return torch.stack([halo[kd:kd + td, kh:kh + th, kw:kw + tw]
                        .reshape(td * th * tw, -1)
                        for kd in range(3) for kh in range(3)
                        for kw in range(3)])


def _chains(terms, steps, total=None):
    """The f32 sum of per-k16-step products `terms(step)` in chains of at
    most FOLD steps, each chain from zero, joined to `total` (a running
    f32 sum, or none) by an f32 add."""
    acc = None
    for i in range(steps):
        p = terms(i)
        acc = p if acc is None else acc + p
        if (i + 1) % FOLD == 0 or i + 1 == steps:
            total = acc if total is None else total + acc
            acc = None
    return total


def emulate(x, gy, weight, pre, plan, drop_tap=None, lose_lo=False,
            twice=None, f32_dx=False):
    """conv3_bwd's blocks under `plan`: (dx bf16, dk f32, db f32, dst f32 or
    None); with f32_dx, dx is dx's f32 sum before the epilogue. Every
    workspace element is written exactly once (asserted)."""
    b, d, h, w, cin = x.shape
    cout = gy.shape[-1]
    td, th, tw = plan["td"], plan["th"], plan["tw"]
    tiles = (plan["tiles_d"], plan["tiles_h"], plan["tiles_w"])
    per_b = tiles[0] * tiles[1] * tiles[2]
    ci, co, s = plan["ci"], plan["co"], plan["splits"]
    nvox, kpad = td * th * tw, -(-td * th * tw // 16) * 16
    nks = plan["nks"]
    # the volumes as staged: zero outside the volume (SAME pads the
    # normalized x) and past the channels; xn = hi + lo under the prologue
    xn = x.float() if pre is None else conv3._affine_relu(x, pre)
    hi = xn.bfloat16().float()
    lo = torch.zeros_like(hi) if lose_lo else (xn - hi).bfloat16().float()
    ext = [tiles[i] * (td, th, tw)[i] - (d, h, w)[i] for i in range(3)]

    def pad(v, cpad):
        return F.pad(v, (0, cpad - v.shape[-1], 1, 1 + ext[2], 1, 1 + ext[1],
                         1, 1 + ext[0]))

    cin_p, cout_p = plan["ci_chunks"] * ci, plan["co_chunks"] * co
    his, los = pad(hi, cin_p), pad(lo, cin_p)
    gys = pad(gy.float(), cout_p)
    wk = F.pad(conv3.kernel_weight(weight).float(),
               (0, cout_p - cout, 0, cin_p - cin))        # [27, Cin, Cout]
    if drop_tap is not None:
        wk[drop_tap] = 0.0
    ws = torch.zeros(s, 27, cin_p, cout_p)
    wsdb = torch.zeros(s, cout_p, dtype=torch.float64)
    wsx = torch.zeros(plan["co_chunks"], b, d, h, w, cin_p)
    written_dk = torch.zeros(s, 27, cin_p, cout_p, dtype=torch.int32)
    written_dx = torch.zeros(plan["co_chunks"], b, d, h, w, cin_p,
                             dtype=torch.int32)
    n = b * per_b
    for split in range(s):
        tile_range = range(n * split // s, n * (split + 1) // s)
        for cib in range(plan["ci_chunks"]):
            cs = slice(cib * ci, (cib + 1) * ci)
            for cob in range(plan["co_chunks"]):
                os_ = slice(cob * co, (cob + 1) * co)
                # the flipped weight slice: K row (tap, o), column c
                wsl = wk.flip(0)[:, cs, os_].permute(0, 2, 1).reshape(
                    27 * co, ci)
                wsl = F.pad(wsl, (0, 0, 0, nks * 16 - 27 * co))
                dk_total = None
                db_sum = torch.zeros(co, dtype=torch.float64)
                for tile in tile_range:
                    bb, r = divmod(tile, per_b)
                    d0 = r // (tiles[1] * tiles[2]) * td
                    h0 = (r // tiles[2]) % tiles[1] * th
                    w0 = r % tiles[2] * tw
                    box = (bb, slice(d0, d0 + td + 2), slice(h0, h0 + th + 2),
                           slice(w0, w0 + tw + 2))
                    xh, xl = his[box][..., cs], los[box][..., cs]
                    gh = gys[box][..., os_]
                    # dk: M = (tap, c), N = o, K = the brick's voxels
                    xt = F.pad(_taps_of(xh, (td, th, tw)),
                               (0, 0, 0, kpad - nvox))
                    lt = F.pad(_taps_of(xl, (td, th, tw)),
                               (0, 0, 0, kpad - nvox))
                    centre = F.pad(gh[1:td + 1, 1:th + 1, 1:tw + 1]
                                   .reshape(nvox, co), (0, 0, 0, kpad - nvox))

                    def dk_step(i):
                        k = slice(16 * i, 16 * i + 16)
                        g = centre[k]
                        out = torch.einsum("tkc,ko->tco", xt[:, k], g)
                        if pre is not None:
                            out = out + torch.einsum("tkc,ko->tco",
                                                     lt[:, k], g)
                        return out
                    dk_total = _chains(dk_step, kpad // 16, dk_total)
                    if cib == 0:
                        db_sum += centre.double().sum(dim=0)
                    # dx: M = the brick's voxels, N = c, K = (tap, o)
                    gt = _taps_of(gh, (td, th, tw)).permute(1, 0, 2) \
                        .reshape(nvox, 27 * co)
                    gt = F.pad(gt, (0, nks * 16 - 27 * co))
                    dxt = _chains(lambda i: gt[:, 16 * i:16 * i + 16]
                                  @ wsl[16 * i:16 * i + 16], nks)
                    dxt = dxt.reshape(td, th, tw, ci)
                    vd, vh, vw = (min(td, d - d0), min(th, h - h0),
                                  min(tw, w - w0))
                    at = (cob, bb, slice(d0, d0 + vd), slice(h0, h0 + vh),
                          slice(w0, w0 + vw), cs)
                    wsx[at] = dxt[:vd, :vh, :vw]
                    written_dx[at] += 1
                ws[split, :, cs, os_] = dk_total
                written_dk[split, :, cs, os_] += 1
                if cib == 0:
                    wsdb[split, os_] = db_sum
    assert (written_dk == 1).all() and (written_dx == 1).all()
    # the second passes: splits in f64 in order, co chunks in f64 in order
    order = list(range(s)) + ([twice] if twice is not None else [])
    dk = sum((ws[i].double() for i in order), torch.zeros(27, cin_p, cout_p,
                                                          dtype=torch.float64))
    db = sum((wsdb[i] for i in order), torch.zeros(cout_p,
                                                   dtype=torch.float64))
    g = wsx[0].double()
    for k in range(1, plan["co_chunks"]):
        g = g + wsx[k].double()
    g = g.float()[..., :cin]
    dst = None
    if f32_dx:
        return g, dk.float()[:, :cin, :cout], db.float()[:cout], dst
    if pre is not None:
        sv, tv = pre
        gm = torch.where(conv3._pre_activation(x, pre) > 0, g,
                         torch.zeros(()))
        dst = _part_sums((gm * x.float(), gm), plan)
        g = gm * sv[:, None, None, None, :]
    return (g.bfloat16(), dk.float()[:, :cin, :cout], db.float()[:cout],
            dst)


def _part_sums(terms, plan):
    """[B, 2, C]: (ds, dt) as the kernel adds them: an f32 partial a brick
    (one output-channel chunk) or a run of rvox voxels (several), the
    partials added in f64 in order."""
    b, d, h, w, c = terms[0].shape
    out = torch.zeros(b, 2, c, dtype=torch.float64)
    for r, t in enumerate(terms):
        if plan["co_chunks"] > 1:
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


def _ints(gen, *shape, lo=-2, hi=2):
    return torch.randint(lo, hi + 1, shape, generator=gen).float()


def _int_case(shape, cout, pre, seed=0):
    """Integer-valued inputs: every product and sum exact in f32 (and the
    prologue's x * s + t, with s and t integers)."""
    gen = torch.Generator().manual_seed(seed)
    b, cin = shape[0], shape[-1]
    x = _ints(gen, *shape).bfloat16()
    gy = _ints(gen, *shape[:-1], cout).bfloat16()
    weight = _ints(gen, cout, cin, 3, 3, 3)
    aff = (_ints(gen, b, cin, lo=1, hi=2), _ints(gen, b, cin, lo=-1, hi=1)) \
        if pre else None
    return x, gy, weight, aff


EXACT_CASES = [  # shape, cout, prologue, sms (the plan's)
    ((2, 5, 6, 7, 24), 16, True, H100_SMS),    # two Cin chunks, ragged
    ((1, 4, 4, 4, 32), 40, False, H100_SMS),   # three Cout chunks
    ((2, 4, 5, 4, 3), 8, True, 1),             # Cin 3, one split
    ((1, 6, 6, 9, 8), 2, True, 4),             # a head, 8-channel chunks
    ((2, 3, 9, 10, 16), 24, True, 3),          # several splits and chunks
]


@pytest.mark.parametrize("shape,cout,pre,sms", EXACT_CASES)
def test_emulated_blocks_equal_the_plain_version(shape, cout, pre, sms):
    x, gy, weight, aff = _int_case(shape, cout, pre)
    b, d, h, w, cin = shape
    plan = conv3.conv3_bwd_plan(b, (d, h, w), cin, cout, pre, sms)
    got = emulate(x, gy, weight, aff, plan)
    want = conv3.conv3_bwd_plain(x, gy, weight, aff)
    for g, wv in zip(got, want):
        assert (g is None) == (wv is None)
        if g is not None:
            assert torch.equal(g, wv)


def _real_case(shape, cout, pre, seed=0):
    """Real inputs; the cotangent orthogonal to constants, as under an
    InstanceNorm, so that dk and db cancel far below their terms."""
    rng = np.random.default_rng(seed)
    b, cin = shape[0], shape[-1]

    def t(*s, scale=1.0):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                * scale)

    x = t(*shape).bfloat16()
    g = t(*shape[:-1], cout)
    gy = (g - g.mean(dim=(1, 2, 3), keepdim=True)).bfloat16()
    weight = t(cout, cin, 3, 3, 3, scale=(27 * cin) ** -0.5)
    aff = (t(b, cin).abs() + 0.5, t(b, cin, scale=0.3)) if pre else None
    return x, gy, weight, aff


def _f64(x, gy, weight, pre):
    """dx before the epilogue and dk, in f64 from the same f32 xn and the
    bf16 weight."""
    xn = (x.float() if pre is None else conv3._affine_relu(x, pre)).double()
    cin, cout = x.shape[-1], gy.shape[-1]
    g = gy.double().permute(0, 4, 1, 2, 3)
    wd = weight.to(torch.bfloat16).double()
    dk = torch.nn.grad.conv3d_weight(xn.permute(0, 4, 1, 2, 3),
                                     (cout, cin, 3, 3, 3), g, padding=1)
    dxg = F.conv_transpose3d(g, wd, padding=1).permute(0, 2, 3, 4, 1)
    return dxg, dk.permute(2, 3, 4, 1, 0).reshape(27, cin, cout)


def _rel(a, ref):
    return ((a.double() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("shape,cout,pre,sms", EXACT_CASES[:3])
def test_emulated_arithmetic_holds_f64(shape, cout, pre, sms):
    """hi + lo xn, the folded f32 chains and the f64 sums of the splits and
    chunks keep dk within DK_TOL and dx within DX_TOL of their f64 value
    (dx's f32 sum compared before the post epilogue)."""
    x, gy, weight, aff = _real_case(shape, cout, pre)
    b, d, h, w, cin = shape
    plan = conv3.conv3_bwd_plan(b, (d, h, w), cin, cout, pre, sms)
    dx, dk = emulate(x, gy, weight, aff, plan)[:2]
    dxg, dk64 = _f64(x, gy, weight, aff)
    assert _rel(dk, dk64) <= DK_TOL
    dx32 = emulate(x, gy, weight, aff, plan, f32_dx=True)[0]
    assert _rel(dx32, dxg) <= DX_TOL


@pytest.mark.parametrize("fault", ["drop_tap", "twice", "lose_lo"])
def test_planted_faults_fail(fault):
    """A dropped tap and a split added twice break the exact equality; the
    prologue's xn as one bf16 term (the lo term lost) lands outside the f64
    gate on dk."""
    shape, cout, pre, sms = EXACT_CASES[4]
    b, d, h, w, cin = shape
    plan = conv3.conv3_bwd_plan(b, (d, h, w), cin, cout, pre, sms)
    assert plan["splits"] > 1
    if fault == "lose_lo":
        x, gy, weight, aff = _real_case(shape, cout, pre)
        dk = emulate(x, gy, weight, aff, plan, lose_lo=True)[1]
        assert _rel(dk, _f64(x, gy, weight, aff)[1]) > DK_TOL
        return
    x, gy, weight, aff = _int_case(shape, cout, pre)
    kw = {"drop_tap": 13} if fault == "drop_tap" else {"twice": 1}
    got = emulate(x, gy, weight, aff, plan, **kw)
    want = conv3.conv3_bwd_plain(x, gy, weight, aff)
    assert not all(torch.equal(g, wv) for g, wv in zip(got[:3], want[:3]))


# ---- (d) no atomics


def test_no_kernel_source_adds_with_atomics():
    """Every sum of every kernel is per-block partials added in a fixed
    order: no source under ops/kernels/csrc/ calls an atomic."""
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    assert any(p.name == "conv3_bwd.cu" for p in sources)
    for path in sources:
        assert not re.search(r"\batomic\w*\s*\(", path.read_text()), path
