"""The split plans of the tensor-core weight-gradient kernels
(``kernels/csrc/wgrad.cuh``: ``conv3_dk`` and the bridges' dk / db, and
``bridge_bwd.cu``'s dx of K3) and a plain-torch emulation of their
arithmetic. The kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py); what decides their blocks, and
the precision those blocks keep, is checked here.

(a) ``conv3.wgrad_plan`` and ``bridges.up_dx_plan`` for every conv and
bridge call of the main path (recorded from the models' forward, scaled to
128^3, at batches 1, 2 and 4) and for edge shapes: every voxel of every
batch element lies in exactly one tile of exactly one split, each split
takes at least one tile, the workspace stays under its bound, and nothing
exceeds what the kernels take (grid, warp tiles, tile coordinates). The
shared memory a plan needs is the kernels' own to lay out and check
(``wgrad.cuh::dk_layout``); the card tests reach that check.
(b) The arithmetic of a conv3_dk call under the prologue, emulated: xn in
f32 split into bf16 hi + lo, f32 partials over the plan's splits, the
splits added in f64 in order. On a cotangent orthogonal to constants (as
under an InstanceNorm) it lands within F32_TOL of the f64 value; rounding
xn to bf16 once lands outside it. IEEE f32 sums stand in for the tensor
cores' accumulation here; the card test and chip_smoke's exact gate hold
the kernel itself.
"""

import functools

import numpy as np
import pytest
import torch

from vae_segmentation_tpu_torch.models import Joint
from vae_segmentation_tpu_torch.models.blocks import Conv3, DownConv, TConv2
from vae_segmentation_tpu_torch.ops import bridges, conv3

torch.set_num_threads(2)

F32_TOL = 2e-4      # chip_smoke.py's gate on the weight gradients' sums
H100_SMS = 132


@functools.lru_cache(maxsize=None)
def main_path_calls():
    """{(kind, grid, cin, cout, split)}: the weight-gradient calls of the
    main path at batch 1, 128^3 (grid: K1's volume, the bridges' coarse
    grid; split: the call has K1's or K2's prologue). The Joint (the Seg
    and the ShapeVAE at full width) runs one forward at 32^3 with a
    256-wide bottleneck, which has the same layers at a quarter of the
    extents; every K1, K2 and K3 module's input is recorded and its grid
    scaled by 4."""
    model = Joint(n_class=2, dim=16, bottleneck=256,
                  generator=torch.Generator().manual_seed(0))
    calls = set()

    def hook(module, args, kwargs, out):
        x = args[0]
        grid = tuple(4 * e for e in x.shape[1:4])
        pre = kwargs.get("pre", args[1] if len(args) > 1 else None)
        cin = x.shape[-1]
        if isinstance(module, Conv3):
            calls.add(("conv3", grid, cin, module.weight.shape[0],
                       pre is not None))
        elif isinstance(module, DownConv):
            coarse = tuple(e // 2 for e in grid)
            calls.add(("down", coarse, cin, cin, pre is not None))
        elif isinstance(module, TConv2):
            calls.add(("up", grid, cin, cin, False))

    handles = [m.register_forward_hook(hook, with_kwargs=True)
               for m in model.modules()
               if isinstance(m, (Conv3, DownConv, TConv2))]
    with torch.no_grad():
        model(torch.zeros(1, 32, 32, 32, 1))
    for h in handles:
        h.remove()
    return sorted(calls)


def _plan(kind, batch, grid, cin, cout, sms=H100_SMS):
    """wgrad_plan for one call, as the wrappers make it: T is x (Cin) and
    D is gy (Cout), but for K3, whose T is the fine gy."""
    if kind == "up":
        return conv3.wgrad_plan("up", batch, grid, cout, cin, sms)
    return conv3.wgrad_plan(kind, batch, grid, cin, cout, sms)


def _split_tiles(plan):
    """Each split's tile range, as the kernel computes it."""
    n, s = plan["ntiles"], plan["splits"]
    return [range(n * i // s, n * (i + 1) // s) for i in range(s)]


def _voxel_tiles(plan, grid):
    """How many tiles of one batch element hold each voxel of `grid`, and
    the tiles of a batch element. A tile stages the td x th x tw brick at
    (i td, j th, k tw) clipped to the volume: a product of one interval
    along each axis, so each axis is counted alone."""
    count = np.ones(grid, np.int32)
    tiles = 1
    for axis, (extent, size, n) in enumerate(zip(
            grid, (plan["td"], plan["th"], plan["tw"]),
            (plan["tiles_d"], plan["tiles_h"], plan["tiles_w"]))):
        cover = np.zeros(extent, np.int32)
        for k in range(n):
            cover[k * size:(k + 1) * size] += 1
        shape = [1, 1, 1]
        shape[axis] = extent
        count = count * cover.reshape(shape)
        tiles *= n
    return count, tiles


def _check_plan(plan, batch, grid, cin, cout):
    taps = 27 if plan["mode"] == 0 else 8
    tc, dc = (cout, cin) if plan["mode"] == 2 else (cin, cout)
    assert plan["fields"] == [plan[k] for k in conv3.WGRAD_FIELDS]
    # every voxel of a batch element in exactly one tile; tiles of batch
    # element b are b * tiles_per_b + local
    count, per_b = _voxel_tiles(plan, grid)
    assert count.min() == 1 and count.max() == 1
    assert plan["ntiles"] == batch * per_b
    # every tile in exactly one split, every split at least one tile
    ranges = _split_tiles(plan)
    assert all(len(r) >= 1 for r in ranges)
    assert [t for r in ranges for t in r] == list(range(plan["ntiles"]))
    # channel chunks cover the channels, none empty
    ci, co = plan["ci"], plan["co"]
    assert ci in (8, 16) and co in (8, 16, 32)
    assert (plan["t_chunks"] - 1) * ci < tc <= plan["t_chunks"] * ci
    assert (plan["d_chunks"] - 1) * co < dc <= plan["d_chunks"] * co
    # the workspace: [splits, taps, Cin, Cout] f32 + [splits, Cout] f64
    assert plan["ws_shape"] == (plan["splits"], taps, cin, cout)
    assert plan["wsdb_shape"] == (plan["splits"], cout)
    assert plan["ws_bytes"] == plan["splits"] * (4 * taps * cin * cout
                                                 + 8 * cout)
    assert plan["ws_bytes"] <= conv3.WGRAD_WS_BYTES
    # the kernel's limits: grid, m16 tiles a warp, the 10-bit tile
    # coordinates
    assert plan["t_chunks"] * plan["d_chunks"] <= 65535
    assert 1 <= plan["splits"] < 2 ** 31
    mtiles = -(-taps * ci // 16)
    assert plan["mtw"] in ((2, 4) if taps == 27 else (1,))
    assert 8 * plan["mtw"] >= mtiles
    assert max(2 * plan["td"], 2 * plan["th"], 2 * plan["tw"]) + 1 < 1024


def _check_dx_plan(plan, batch, grid, cin):
    count, per_b = _voxel_tiles(plan, grid)
    assert count.min() == 1 and count.max() == 1
    assert plan["blocks"] == batch * per_b < 2 ** 31
    assert plan["nc"] in (16, 32, 64) and plan["kpad"] <= 64
    assert (plan["chunks"] - 1) * plan["nc"] < cin <= \
        plan["chunks"] * plan["nc"] and plan["chunks"] <= 65535
    assert plan["fields"] == [plan[k] for k in bridges.UP_DX_FIELDS]


def test_main_path_calls_are_the_models():
    """The recorded calls: K1 at every stage from the entry convs (Cin 1
    and 2) to 4^3 at 256 channels and the heads (Cout 2), K2 with and
    without its prologue, K3 from 4^3 x 256 to 64^3 x 16."""
    calls = main_path_calls()
    conv = {(g, ci, co) for k, g, ci, co, _ in calls if k == "conv3"}
    assert ((128,) * 3, 1, 8) in conv and ((128,) * 3, 2, 8) in conv
    assert ((128,) * 3, 8, 2) in conv and ((4,) * 3, 256, 256) in conv
    ups = {(g, c) for k, g, c, _, _ in calls if k == "up"}
    assert ups == {((4,) * 3, 256), ((8,) * 3, 128), ((16,) * 3, 64),
                   ((32,) * 3, 32), ((64,) * 3, 16)}
    downs = {(g, c, s) for k, g, c, _, s in calls if k == "down"}
    assert ((64,) * 3, 8, True) in downs and ((4,) * 3, 128, False) in downs


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_plans_of_the_main_path(batch):
    for kind, grid, cin, cout, _ in main_path_calls():
        plan = _plan(kind, batch, grid, cin, cout)
        _check_plan(plan, batch, grid, cin, cout)
        if kind == "up":
            _check_dx_plan(bridges.up_dx_plan(batch, grid, cin, cout), batch,
                           grid, cin)


# split: the call runs under a prologue (the kernel's hi/lo split, which
# the plan does not depend on)
@pytest.mark.parametrize("kind,batch,grid,cin,cout,split", [
    ("conv3", 2, (5, 9, 19), 3, 5, True),     # ragged tiles, odd channels
    ("conv3", 1, (3, 17, 7), 1, 8, False),    # the image's entry conv
    ("conv3", 2, (12, 8, 16), 2, 8, False),   # the mask's entry conv
    ("conv3", 1, (8, 8, 16), 16, 2, True),    # a head
    ("conv3", 3, (1, 1, 1), 5, 3, True),      # one voxel
    ("conv3", 4, (4, 4, 4), 256, 256, True),  # the deepest stage
    ("down", 2, (3, 5, 2), 3, 5, True),       # odd fine extents 6 x 10 x 4
    ("down", 1, (7, 4, 2), 8, 8, True),       # from a 15 x 9 x 5 fine grid
    ("up", 2, (3, 5, 2), 5, 3, False),
    ("up", 4, (4, 4, 4), 256, 256, False),
])
def test_plans_of_edge_shapes(kind, batch, grid, cin, cout, split):
    plan = _plan(kind, batch, grid, cin, cout)
    _check_plan(plan, batch, grid, cin, cout)
    if kind == "up":
        _check_dx_plan(bridges.up_dx_plan(batch, grid, cin, cout), batch,
                       grid, cin)


def test_the_workspace_bound_caps_the_splits(monkeypatch):
    """At 256 x 256 channels a split's partial is 7 MB: a 64 MB bound
    allows 9 splits, whatever the SM count asks for; a tighter bound
    fewer, and never none."""
    plan = conv3.wgrad_plan("conv3", 4, (32, 32, 32), 256, 256, 10 ** 6)
    assert plan["splits"] == 9 and plan["ws_bytes"] <= 64 << 20
    monkeypatch.setattr(conv3, "WGRAD_WS_BYTES", 1)
    tight = conv3.wgrad_plan("conv3", 4, (32, 32, 32), 256, 256, 10 ** 6)
    assert tight["splits"] == 1


def _taps_f32(xn):
    """[V, 27, C] f32: each voxel's 27 SAME-padded neighbours of xn
    [B, D, H, W, C], tap = (kd * 3 + kh) * 3 + kw (K1's order)."""
    b, d, h, w, c = xn.shape
    p = torch.nn.functional.pad(xn, (0, 0, 1, 1, 1, 1, 1, 1))
    cols = [p[:, kd:kd + d, kh:kh + h, kw:kw + w]
            for kd in range(3) for kh in range(3) for kw in range(3)]
    return torch.stack(cols, dim=4).reshape(b * d * h * w, 27, c)


def _split_of_voxels(plan, batch, grid):
    """[V] the split that sums each voxel (flattened b, d, h, w)."""
    d, h, w = grid
    bb, dd, hh, ww = np.meshgrid(np.arange(batch), np.arange(d),
                                 np.arange(h), np.arange(w), indexing="ij")
    tile = ((bb * plan["tiles_d"] + dd // plan["td"]) * plan["tiles_h"]
            + hh // plan["th"]) * plan["tiles_w"] + ww // plan["tw"]
    starts = np.array([r.start for r in _split_tiles(plan)])
    return np.searchsorted(starts, tile.reshape(-1), side="right") - 1


def _emulated_dk(cols, gy, split_of, splits):
    """f32 partial dk of each split (its voxels' products summed in f32),
    then the splits added in f64 in order: [27 * C, Cout] f64."""
    order = np.argsort(split_of, kind="stable")
    bounds = np.searchsorted(split_of[order], np.arange(splits + 1))
    cols, gy = cols[order], gy[order]
    total = torch.zeros(cols.shape[1], gy.shape[1], dtype=torch.float64)
    for s in range(splits):
        lo, hi = bounds[s], bounds[s + 1]
        total += (cols[lo:hi].T @ gy[lo:hi]).double()
    return total


def test_hi_lo_split_holds_a_cancelling_dk_to_f64():
    """conv3_dk's arithmetic under the prologue at 32^3, batch 2, 8 -> 8
    channels, the H100's plan (one split a tile): xn = relu(x * s + t) in
    f32, gy orthogonal to constants per (b, channel) as an InstanceNorm's
    backward leaves it. xn as bf16 hi + lo lands within F32_TOL of the
    f64 dk; xn as one bf16 lands outside it (the split is what keeps the
    gate)."""
    rng = np.random.default_rng(0)
    b, n, cin, cout = 2, 32, 8, 8
    x = torch.from_numpy(rng.normal(size=(b, n, n, n, cin))
                         .astype(np.float32)).bfloat16()
    s = torch.from_numpy((rng.normal(size=(b, cin)) * 0.5 + 1.0)
                         .astype(np.float32))
    t = torch.from_numpy((rng.normal(size=(b, cin)) * 0.3)
                         .astype(np.float32))
    g = rng.normal(size=(b, n, n, n, cout))
    g -= g.mean(axis=(1, 2, 3), keepdims=True)
    gy = torch.from_numpy(g.astype(np.float32)).bfloat16().float() \
        .reshape(-1, cout)
    xn = conv3._affine_relu(x, (s, t))                 # f32, as the kernel
    hi = xn.bfloat16().float()
    lo = (xn - hi).bfloat16().float()
    plan = conv3.wgrad_plan("conv3", b, (n, n, n), cin, cout, H100_SMS)
    assert plan["splits"] == plan["ntiles"] == 512
    split_of = _split_of_voxels(plan, b, (n, n, n))
    exact = _taps_f32(xn.double()).reshape(-1, 27 * cin).T @ gy.double()
    scale = exact.abs().max().item()

    def err(cols_list):
        got = sum(_emulated_dk(c.reshape(-1, 27 * cin), gy, split_of,
                               plan["splits"]) for c in cols_list)
        return (got - exact).abs().max().item() / scale

    # the terms cancel: the result is far below the sum of |terms|
    terms = _taps_f32(xn.double()).reshape(-1, 27 * cin).abs().T \
        @ gy.double().abs()
    assert scale < 0.05 * terms.max().item()
    assert err([_taps_f32(hi), _taps_f32(lo)]) <= F32_TOL
    assert err([_taps_f32(hi)]) > F32_TOL
    # and the reference checks itself against the plain version's f32 sum
    want = conv3.conv3_dk_plain(x, gy.reshape(b, n, n, n, cout).bfloat16(),
                                (s, t))[0].reshape(27 * cin, cout)
    assert (want.double() - exact).abs().max().item() <= F32_TOL * scale
