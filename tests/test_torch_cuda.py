"""Card-only tests of the port's CUDA kernels (marker ``cuda``): each kernel
against its plain PyTorch version at ragged shapes the main path does not
reach (tiles cut by the volume edge, odd channel counts, 3 classes), the
launch counters, the wrappers' input checks, and the gradients of each
``torch.autograd.Function`` (backward kernels) against autograd through the
plain forward. They skip without a GPU.
This file imports torch only, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import contextlib
from unittest import mock

import pytest
import torch

from vae_segmentation_tpu_torch.ops import (
    bridges, conv3, instance_norm, losses, reparam)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, *shape, scale=1.0):
    return torch.randn(*shape, device="cuda", generator=gen) * scale


def _close(got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(want.float().abs().max().item(), 1.0), err


@pytest.mark.parametrize("shape,cout,pre,stats,softmax", [
    ((2, 5, 9, 19, 3), 5, True, True, False),
    ((1, 3, 17, 7, 1), 8, False, True, False),
    ((1, 6, 10, 20, 16), 3, True, False, True),
    ((2, 4, 4, 4, 24), 48, False, False, False),
])
def test_conv3_kernel_matches_plain(gen, shape, cout, pre, stats, softmax):
    b, cin = shape[0], shape[-1]
    x = _rnd(gen, *shape).bfloat16()
    w = _rnd(gen, cout, cin, 3, 3, 3, scale=(27 * cin) ** -0.5)
    bias = _rnd(gen, cout)
    aff = (_rnd(gen, b, cin).abs() + 0.5, _rnd(gen, b, cin, scale=0.3)) \
        if pre else None
    before = conv3.conv3.launches
    got = conv3.conv3(x, w, bias, conv3.kernel_weight(w), aff, stats,
                      softmax)
    torch.cuda.synchronize()
    assert conv3.conv3.launches == before + 1
    want = conv3.conv3_plain(x, w, bias, aff, stats, softmax)
    if stats:
        _close(got[0], want[0], 1e-2)
        _close(got[1], want[1], 1e-3)
    else:
        _close(got, want, 1e-2)


# K2 and K3 on the tensor cores: odd grids (ragged bricks, an odd fine
# extent K2 never reads), channels of 1, 12 and 40 (plain loads, zero
# padding), C_in != C_out, batch 3, the prologue's three-term xn, the deep
# stages' K split over the warps and C_in past one staged chunk
BRIDGE_CASES = [
    ((2, 6, 10, 4, 3), 5, True), ((1, 8, 8, 8, 16), 16, False),
    ((3, 7, 9, 5, 12), 40, True), ((3, 9, 6, 11, 40), 12, False),
    ((1, 5, 3, 2, 1), 1, True), ((2, 3, 17, 6, 1), 12, False),
    ((3, 8, 8, 8, 128), 128, False), ((2, 16, 16, 16, 64), 64, False),
    ((1, 32, 32, 32, 8), 8, True), ((1, 6, 6, 6, 300), 24, False),
]


def _down_call(gen, shape, cout, pre):
    b, cin = shape[0], shape[-1]
    x = _rnd(gen, *shape).bfloat16()
    w = _rnd(gen, cout, cin, 2, 2, 2, scale=(8 * cin) ** -0.5)
    bias = _rnd(gen, cout)
    aff = (_rnd(gen, b, cin).abs() + 0.5, _rnd(gen, b, cin, scale=0.3)) \
        if pre else None
    return x, w, bias, aff


def _up_call(gen, shape, cout):
    cin = shape[-1]
    x = _rnd(gen, *shape).bfloat16()
    w = _rnd(gen, cin, cout, 2, 2, 2, scale=(8 * cout) ** -0.5)
    return x, w, _rnd(gen, cout)


def _repeats(run, first):
    return all(torch.equal(run(), first) for _ in range(2))


@pytest.mark.parametrize("shape,cout,pre", BRIDGE_CASES)
def test_down_kernel_matches_plain(gen, shape, cout, pre):
    """K2 against its plain version (bf16 rule), launched once by the
    wrapper, and the same bits on two more launches (no atomics)."""
    x, w, bias, aff = _down_call(gen, shape, cout, pre)
    kw = bridges.down_kernel_weight(w)
    before = bridges.down_k2s2.launches
    got = bridges.down_k2s2(x, w, bias, kw, aff)
    torch.cuda.synchronize()
    assert bridges.down_k2s2.launches == before + 1
    want = bridges.down_k2s2_plain(x, w, bias, aff)
    _close(got, want, 1e-2)
    assert _repeats(lambda: bridges.down_k2s2(x, w, bias, kw, aff), got)
    # the one-pass plan (no K split over the warps) computes the same
    b, d, h, w_, cin = x.shape
    one = bridges.bridge_plan("down", b, (d, h, w_), cin, cout, pre,
                              conv3.sm_count(0), wk=1)
    _close(bridges.bridge_launch("down", x, kw, bias, aff, one), want, 1e-2)


@pytest.mark.parametrize("shape,cout", [
    ((2, 3, 5, 2, 3), 5), ((1, 4, 4, 4, 32), 32),
    *[(s, c) for s, c, _ in BRIDGE_CASES]])
def test_up_kernel_matches_plain(gen, shape, cout):
    """K3 against its plain version (bf16 rule) on the K2 cases' inputs as
    coarse grids, launched once by the wrapper, and the same bits again."""
    x, w, bias = _up_call(gen, shape, cout)
    kw = bridges.up_kernel_weight(w)
    before = bridges.up_k2s2.launches
    got = bridges.up_k2s2(x, w, bias, kw)
    torch.cuda.synchronize()
    assert bridges.up_k2s2.launches == before + 1
    _close(got, bridges.up_k2s2_plain(x, w, bias), 1e-2)
    assert _repeats(lambda: bridges.up_k2s2(x, w, bias, kw), got)


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    x = _rnd(gen, 1, 4, 4, 4, 8)
    w = _rnd(gen, 8, 8, 3, 3, 3)
    bias = _rnd(gen, 8)
    with pytest.raises(ValueError):  # f32 activations
        conv3.conv3(x, w, bias, conv3.kernel_weight(w))
    with pytest.raises(ValueError):  # no kernel-layout weight
        conv3.conv3(x.bfloat16(), w, bias)
    with pytest.raises(ValueError):  # weight layout of another kernel
        bridges.down_k2s2(x.bfloat16(), w, bias, conv3.kernel_weight(w))


@pytest.mark.parametrize("write", ["data", "no_grad", "load"])
def test_modules_hand_their_kernels_the_weight_as_it_is_now(gen, write):
    """A leaf module's kernel reads the weight's current values after any
    kind of write, also one through ``.data`` that no version counter sees:
    the kernel's output follows the plain version's, which reads ``weight``
    itself."""
    from vae_segmentation_tpu_torch.models.blocks import Conv3

    m = Conv3(8, 8, torch.Generator().manual_seed(0)).cuda()
    x = _rnd(gen, 1, 6, 6, 6, 8).bfloat16()
    with torch.no_grad():
        first = m(x)
        if write == "data":
            m.weight.data.neg_()
        elif write == "no_grad":
            m.weight.neg_()
        else:
            m.load_state_dict({"weight": -m.weight.detach().clone(),
                               "bias": m.bias.detach().clone()})
        got = m(x)
    want = conv3.conv3_plain(x, m.weight, m.bias)
    _close(got, want, 1e-2)
    assert (got.float() - first.float()).abs().max().item() > 0.1


# ---- backward kernels


def _rel(got, want):
    """max abs error over the largest |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("shape,cout,pre", [
    ((2, 5, 9, 19, 3), 5, True),      # ragged tiles, odd channels
    ((1, 3, 17, 7, 1), 8, False),     # the 1-channel entry conv
    ((2, 12, 8, 16, 2), 8, False),    # the VAE's 2-channel entry conv
    ((1, 8, 8, 16, 16), 2, True),     # a head: Cout 2
    ((2, 4, 4, 4, 24), 48, False),    # a deep stage
    ((4, 4, 4, 4, 256), 256, True),   # the deepest stage at batch 4
    ((1, 64, 64, 64, 16), 16, True),  # a 64^3 stage
])
def test_conv3_backward_kernels_match_plain(gen, shape, cout, pre):
    """conv3_dk (dk, db) and K1's post epilogue (dx, ds, dt) against their
    plain versions: dx bf16 within 1e-2 of max|dx|, f32 sums within 1e-3
    of their largest element (the plain f32 sums and the kernel's split-K
    partials add in other orders)."""
    b, cin = shape[0], shape[-1]
    x = _rnd(gen, *shape).bfloat16()
    gy = _rnd(gen, *shape[:-1], cout).bfloat16()
    w = _rnd(gen, cout, cin, 3, 3, 3, scale=(27 * cin) ** -0.5)
    aff = (_rnd(gen, b, cin).abs() + 0.5, _rnd(gen, b, cin, scale=0.3)) \
        if pre else None
    before = conv3.conv3_dk.launches
    dk, db = conv3.conv3_dk(x, gy, aff)
    torch.cuda.synchronize()
    assert conv3.conv3_dk.launches == before + 1
    dk_p, db_p = conv3.conv3_dk_plain(x, gy, aff)
    assert _rel(dk, dk_p) <= 1e-3 and _rel(db, db_p) <= 1e-3
    w_t = w.flip(2, 3, 4).transpose(0, 1)
    kw_t = conv3.kernel_weight(w).flip(0).transpose(1, 2).contiguous()
    assert torch.equal(kw_t, conv3.kernel_weight(w_t))
    post = None if aff is None else (x, *aff)
    got = conv3.conv3_op(gy, w_t, None, kw_t, post=post)
    want = conv3.conv3_plain(gy, w_t, None, post=post)
    if pre:
        assert _rel(got[0], want[0]) <= 1e-2 and _rel(got[1], want[1]) <= 1e-3
    else:
        assert _rel(got, want) <= 1e-2


@pytest.mark.parametrize("up,shape,cout,pre", [
    (False, (2, 6, 10, 4, 3), 5, True), (False, (1, 8, 8, 8, 16), 16, False),
    (False, (1, 16, 16, 16, 8), 8, True), (True, (2, 3, 5, 2, 3), 5, False),
    (True, (1, 4, 4, 4, 32), 32, False),
    (False, (4, 8, 8, 8, 128), 128, False),   # the VAE's deepest Down
    (True, (4, 4, 4, 4, 256), 256, False),    # the VAE's up1 at batch 4
    (True, (1, 64, 64, 64, 16), 16, False),   # up5: 64^3 -> 128^3
    (False, (1, 128, 128, 128, 8), 8, True),  # down1: 128^3 -> 64^3
])
def test_bridge_backward_kernels_match_plain(gen, up, shape, cout, pre):
    b, d, h, w_, cin = shape
    x = _rnd(gen, *shape).bfloat16()
    aff = (_rnd(gen, b, cin).abs() + 0.5, _rnd(gen, b, cin, scale=0.3)) \
        if pre else None
    if up:
        gy = _rnd(gen, b, 2 * d, 2 * h, 2 * w_, cout).bfloat16()
        w = _rnd(gen, cin, cout, 2, 2, 2, scale=(8 * cout) ** -0.5)
        got = bridges.up_k2s2_bwd(x, gy, w, bridges.up_kernel_weight(w))
        want = bridges.up_k2s2_bwd_plain(x, gy, w)
    else:
        gy = _rnd(gen, b, d // 2, h // 2, w_ // 2, cout).bfloat16()
        w = _rnd(gen, cout, cin, 2, 2, 2, scale=(8 * cin) ** -0.5)
        got = bridges.down_k2s2_bwd(x, gy, w, bridges.down_kernel_weight(w),
                                    aff)
        want = bridges.down_k2s2_bwd_plain(x, gy, w, aff)
    assert _rel(got[0], want[0]) <= 1e-2
    assert _rel(got[1], want[1]) <= 1e-3 and _rel(got[2], want[2]) <= 1e-3
    if pre:
        assert _rel(got[3], want[3]) <= 1e-3
    # a frozen weight: only dx is computed; an input without gradient
    # (the first trainable layer under --fix_layer): only dk and db
    kw = (bridges.up_kernel_weight if up else bridges.down_kernel_weight)(w)
    only_dx = bridges._launch_bwd("bridge", up, x, gy, kw, aff, True, False)
    assert only_dx[1] is None and torch.equal(only_dx[0], got[0])
    only_dk = bridges._launch_bwd("bridge", up, x, gy, kw, aff, False, True)
    assert only_dk[0] is None and only_dk[3] is None
    assert _rel(only_dk[1], want[1]) <= 1e-3
    assert _rel(only_dk[2], want[2]) <= 1e-3


# K2's dx on the tensor cores (bridge_bwd.cu::down_dx_kernel): the
# main-path shapes (fine grid x Cin, Cout = Cin, batch 2), odd fine extents
# (the last plane written as 0) and channel counts that are not a multiple
# of 16 or of 8
DOWN_DX_CASES = [
    ((2, 128, 128, 128, 8), 8, True),    # the Down entry, with the prologue
    ((2, 128, 128, 128, 8), 8, False),   # its norm-route twin
    ((2, 64, 64, 64, 16), 16, False),
    ((2, 32, 32, 32, 32), 32, False),
    ((4, 16, 16, 16, 64), 64, False),
    ((2, 8, 8, 8, 128), 128, False),
    ((1, 8, 8, 8, 128), 256, True),      # K past 8 k16 steps: the fold
    ((2, 7, 9, 11, 12), 40, True),       # odd fine extents, Cin 12
    ((2, 7, 9, 11, 12), 40, False),
    ((1, 6, 10, 4, 3), 5, True),         # Cin and Cout not multiples of 8
    ((1, 5, 4, 6, 24), 8, False),        # Cin 24: a ragged channel chunk
]


@pytest.mark.parametrize("shape,cout,pre", DOWN_DX_CASES)
def test_down_dx_kernel_matches_plain(gen, shape, cout, pre):
    """K2's dx (and (ds, dt) under the prologue) alone against the plain
    version on the even part of the fine grid: dx bf16 within 1e-2 of
    max|dx|, (ds, dt) within 2e-4 of their largest element; the planes of an
    odd extent are 0; two more launches give the same bits."""
    b, d, h, w_, cin = shape
    x = _rnd(gen, *shape).bfloat16()
    gy = _rnd(gen, b, d // 2, h // 2, w_ // 2, cout).bfloat16()
    w = _rnd(gen, cout, cin, 2, 2, 2, scale=(8 * cout) ** -0.5)
    kw = bridges.down_kernel_weight(w)
    aff = (_rnd(gen, b, cin).abs() + 0.5, _rnd(gen, b, cin, scale=0.3)) \
        if pre else None

    def run():
        return bridges._launch_bwd("down_k2s2_bwd", False, x, gy, kw, aff,
                                   True, False)
    dx, _, _, dst = run()
    torch.cuda.synchronize()
    e = (2 * (d // 2), 2 * (h // 2), 2 * (w_ // 2))
    xe = x[:, :e[0], :e[1], :e[2]].contiguous()
    want_dx, _, _, want_dst = bridges.down_k2s2_bwd_plain(xe, gy, w, aff)
    assert _rel(dx[:, :e[0], :e[1], :e[2]], want_dx) <= 1e-2
    rest = torch.ones_like(dx, dtype=torch.bool)
    rest[:, :e[0], :e[1], :e[2]] = False
    assert not dx[rest].any()
    if pre:
        assert _rel(dst, want_dst) <= 2e-4
    else:
        assert dst is None
    for _ in range(2):
        again = run()
        assert torch.equal(again[0], dx)
        assert pre is False or torch.equal(again[3], dst)


def test_down_dx_plan_refuses_what_the_kernel_does_not_take(gen):
    """A plan of another call is refused by the kernel (its bricks do not
    cover the grid), and the plan raises for a Cout whose weight slice
    cannot fit."""
    x = _rnd(gen, 1, 8, 8, 8, 16).bfloat16()
    gy = _rnd(gen, 1, 4, 4, 4, 16).bfloat16()
    w = _rnd(gen, 16, 16, 2, 2, 2)
    other = bridges.down_dx_plan(1, (4, 4, 4), 16, 16, False,
                                 conv3.sm_count(0))
    with mock.patch.object(bridges, "down_dx_plan",
                           lambda *a, **k: other):
        with pytest.raises(RuntimeError):
            bridges._launch_bwd("down_k2s2_bwd", False, x, gy,
                                bridges.down_kernel_weight(w), None, True,
                                False)
    with pytest.raises(ValueError):
        bridges.down_dx_plan(1, (8, 8, 8), 16, 8192, False, 132)


# the reduction's two plans (instance_norm.cu): shapes on either side of
# the one-launch threshold, both modes, C a multiple of 8 and not
NORM_REDUCE_CASES = [
    (1, 128, 8), (2, 64, 16), (1, 32, 32), (2, 32, 32), (4, 16, 64),
    (2, 8, 128), (1, 4, 256), (2, 24, 24), (1, 9, 3),
]


def _norm_sums_f64(x, g=None, s=None, t=None, relu=True):
    """The [B, 2, C] sums in f64 of the bf16 inputs (xhat rounded in f32 as
    the kernel rounds it)."""
    x32 = x.float()
    if g is None:
        x64 = x32.double()
        return torch.stack([x64.sum(dim=(1, 2, 3)),
                            (x64 * x64).sum(dim=(1, 2, 3))], dim=1)
    xhat = x32 * s[:, None, None, None, :] + t[:, None, None, None, :]
    gm = g.float()
    if relu:
        gm = torch.where(xhat > 0, gm, torch.zeros_like(gm))
    gm, xhat = gm.double(), xhat.double()
    return torch.stack([gm.sum(dim=(1, 2, 3)),
                        (gm * xhat).sum(dim=(1, 2, 3))], dim=1)


@pytest.mark.parametrize("b,e,c", NORM_REDUCE_CASES)
def test_norm_reduce_plans_match_f64(gen, b, e, c):
    """norm_stats and norm_bwd_sums under the call's own plan and under the
    other plan (where C allows one launch) against their f64 value: within
    2e-5 of the largest |sum| (f32 sums of at most a few hundred terms,
    added in f64 across blocks); each plan repeats bit for bit."""
    x = (_rnd(gen, b, e, e, e, c) * 3 + 1).bfloat16()
    g = _rnd(gen, b, e, e, e, c).bfloat16()
    n = e ** 3
    st = instance_norm.norm_stats(x)
    s, t = instance_norm.affine_from_stats(st, n)
    own = instance_norm.reduce_plan(x)
    plans = [own]
    groups = c // 8
    if c % 8 == 0 and groups & (groups - 1) == 0:
        plans.append(instance_norm.norm_reduce_plan(
            b, n, c, True, conv3.sm_count(0),
            one_launch=not own["one_launch"]))
    for relu in (True, False):
        for who, args, want in (
                ("norm_stats", dict(), _norm_sums_f64(x)),
                ("norm_bwd_sums", dict(g=g, aff=(s, t)),
                 _norm_sums_f64(x, g, s, t, relu))):
            for plan in plans:
                def run():
                    return instance_norm._launch(who, x, relu, plan=plan,
                                                 **args)
                got = run()
                err = (got.double() - want).abs().max().item()
                assert err <= 2e-5 * want.abs().max().item(), (who, plan)
                assert torch.equal(run(), got) and torch.equal(run(), got)


def _weight_grads(kind, gen, pre):
    """One conv3_dk, down_k2s2_bwd or up_k2s2_bwd call's (dk, db) on inputs
    drawn from `gen`, and a closure that launches it again."""
    b, c = 2, 16
    x = _rnd(gen, b, 16, 16, 16, c).bfloat16()
    aff = (_rnd(gen, b, c).abs() + 0.5, _rnd(gen, b, c, scale=0.3)) \
        if pre else None
    if kind == "conv3":
        gy = _rnd(gen, b, 16, 16, 16, c).bfloat16()
        return lambda: conv3.conv3_dk(x, gy, aff)
    w = _rnd(gen, c, c, 2, 2, 2, scale=(8 * c) ** -0.5)
    if kind == "up":
        gy = _rnd(gen, b, 32, 32, 32, c).bfloat16()
        return lambda: bridges.up_k2s2_bwd(
            x, gy, w, bridges.up_kernel_weight(w), need_dx=False)[1:]
    gy = _rnd(gen, b, 8, 8, 8, c).bfloat16()
    return lambda: bridges.down_k2s2_bwd(
        x, gy, w, bridges.down_kernel_weight(w), aff, need_dx=False)[1:3]


@pytest.mark.parametrize("kind,pre", [("conv3", True), ("conv3", False),
                                      ("down", True), ("up", False)])
def test_weight_gradients_repeat_bit_for_bit(gen, kind, pre):
    """dk and db of the split-K kernels come out the same bits on every
    launch: each block writes its partial once and the splits are added in
    a fixed order (no atomics)."""
    run = _weight_grads(kind, gen, pre)
    first = [t.clone() for t in run()]
    for _ in range(3):
        again = run()
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_conv3_dk_holds_a_cancelling_cotangent_to_f64(gen):
    """Under an InstanceNorm the cotangent is orthogonal to constants, so
    dk cancels far below its terms and db is zero in exact arithmetic. The
    kernel (the prologue's xn as bf16 hi + lo, f32 partials, f64 across
    splits) stays within F32_TOL = 2e-4 of the largest element of the f64
    value computed from the same f32 xn, for dk and db."""
    b, cin, cout = 2, 16, 16
    x = _rnd(gen, b, 32, 32, 32, cin).bfloat16()
    aff = (_rnd(gen, b, cin).abs() + 0.5, _rnd(gen, b, cin, scale=0.3))
    g = _rnd(gen, b, 32, 32, 32, cout)
    gy = (g - g.mean(dim=(1, 2, 3), keepdim=True)).bfloat16()
    dk, db = conv3.conv3_dk(x, gy, aff)
    xn = conv3._affine_relu(x, aff).double().permute(0, 4, 1, 2, 3)
    g64 = gy.double().permute(0, 4, 1, 2, 3)
    want = torch.nn.grad.conv3d_weight(xn, (cout, cin, 3, 3, 3), g64,
                                       padding=1)
    want = want.permute(2, 3, 4, 1, 0).reshape(27, cin, cout)
    err = (dk.double() - want).abs().max() / want.abs().max()
    assert err.item() <= 2e-4
    db_want = g64.sum(dim=(0, 2, 3, 4))
    assert (db.double() - db_want).abs().max().item() \
        <= 2e-4 * db_want.abs().max().item()


@pytest.mark.parametrize("shape", [(2, 7, 9, 11, 2), (1, 5, 6, 7, 3),
                                   (2, 4, 4, 4, 8)])
def test_loss_kernels_match_plain(gen, shape):
    y = torch.softmax(_rnd(gen, *shape), dim=-1).bfloat16()
    g = _rnd(gen, *shape).bfloat16()
    got = losses.softmax_vjp(g, y)
    want = losses.softmax_vjp_plain(g, y)
    assert _rel(got, want) <= 1e-2
    targets = [torch.softmax(_rnd(gen, *shape), dim=-1).bfloat16()
               for _ in range(3)]
    for k in (1, 2, 3):
        before = losses.dice_sums.launches
        sums = losses.dice_sums(y, targets[:k])
        assert losses.dice_sums.launches == before + 1
        assert sums.shape == (shape[0], 1 + 2 * k, shape[-1])
        assert _rel(sums, losses.dice_sums_plain(y, targets[:k])) <= 1e-4


def _grads(fn, inputs):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    gen = torch.Generator(device="cuda").manual_seed(1)
    loss = sum((o.float() * torch.randn(o.shape, device="cuda",
                                        generator=gen)).sum() for o in outs)
    loss.backward()
    return [t.grad for t in leaves]


@pytest.mark.parametrize("stats,softmax", [(True, False), (False, True)])
def test_conv3_function_gradients(gen, stats, softmax):
    """The whole backward of the K1 Function on the card (stats cotangent
    fold, softmax VJP, dx with post, dk) against autograd through the
    plain forward, in bf16 at 5e-2 of each gradient's largest element."""
    b, cin, cout = 2, 8, 2 if softmax else 16
    x = _rnd(gen, b, 6, 10, 20, cin).bfloat16()
    w = _rnd(gen, cout, cin, 3, 3, 3, scale=(27 * cin) ** -0.5)
    bias = _rnd(gen, cout)
    s, t = _rnd(gen, b, cin).abs() + 0.5, _rnd(gen, b, cin, scale=0.3)

    def kernel(x, w, bias, s, t):
        return conv3.conv3(x, w, bias, conv3.kernel_weight(w), (s, t), stats,
                           softmax)

    def plain(x, w, bias, s, t):
        return conv3.conv3_plain(x, w, bias, (s, t), stats, softmax)

    before = (conv3.conv3.launches, conv3.conv3_dk.launches)
    got = _grads(kernel, (x, w, bias, s, t))
    assert (conv3.conv3.launches, conv3.conv3_dk.launches) == \
        (before[0] + 2, before[1] + 1)
    want = _grads(plain, (x, w, bias, s, t))
    for name, g_, w_ in zip(("dx", "dw", "db", "ds", "dt"), got, want):
        assert _rel(g_, w_) <= 5e-2, name


def test_bridge_function_gradients(gen):
    b, c = 2, 8
    x = _rnd(gen, b, 8, 8, 12, c).bfloat16()
    wd = _rnd(gen, c, c, 2, 2, 2, scale=(8 * c) ** -0.5)
    bias = _rnd(gen, c)
    s, t = _rnd(gen, b, c).abs() + 0.5, _rnd(gen, b, c, scale=0.3)
    got = _grads(lambda x, w, bias, s, t: bridges.down_k2s2(
        x, w, bias, bridges.down_kernel_weight(w), (s, t)),
        (x, wd, bias, s, t))
    want = _grads(lambda x, w, bias, s, t: bridges.down_k2s2_plain(
        x, w, bias, (s, t)), (x, wd, bias, s, t))
    for g_, w_ in zip(got, want):
        assert _rel(g_, w_) <= 5e-2
    got = _grads(lambda x, w, bias: bridges.up_k2s2(
        x, w, bias, bridges.up_kernel_weight(w)), (x, wd, bias))
    want = _grads(lambda x, w, bias: bridges.up_k2s2_plain(x, w, bias),
                  (x, wd, bias))
    for g_, w_ in zip(got, want):
        assert _rel(g_, w_) <= 5e-2


def test_multi_soft_dice_gradients(gen):
    shape = (2, 6, 7, 8, 2)
    pred, recon, pseudo = (torch.softmax(_rnd(gen, *shape), dim=-1).bfloat16()
                           for _ in range(3))

    def kernel(p, r):
        return tuple(losses.multi_soft_dice(p, (r, pseudo)))

    def plain(p, r):
        return (losses.soft_dice_per_class(p, r),
                losses.soft_dice_per_class(p, pseudo))

    for g_, w_ in zip(_grads(kernel, (pred, recon)),
                      _grads(plain, (pred, recon))):
        assert _rel(g_, w_) <= 2e-2


def test_fix_layer_kl_step_on_the_card(gen):
    """One adaptation step with --kl, --fix_layer and Adam at a small size:
    only Seg.up5 and Seg.out_block move; the backward launches a weight
    gradient for their four convs only and stops at Seg.up5's bridge (the
    VAE's five Down and five Up bridges and that one)."""
    from vae_segmentation_tpu_torch import ops, train as T
    from vae_segmentation_tpu_torch.models import Joint

    kw = dict(n_class=2, dim=16, fmaps=(4, 8, 8, 16, 16, 32), bottleneck=32)
    student = Joint(vae_decoder_dropout=0.5,
                    generator=torch.Generator().manual_seed(0), **kw).cuda()
    teacher = Joint(**kw).cuda()
    T.copy_params(teacher, student)
    before = {k: v.clone() for k, v in student.state_dict().items()}
    opt = T.optim.build(T.optim.freeze_all_but_seg_head(student), True, 1e-3)
    step = T.make_adapt_step(T.AdaptConfig(n_class=2, domain_loss_type=8,
                                           kl=True))
    image = _rnd(gen, 2, 32, 32, 32, scale=0.5)
    label = (torch.rand(2, 32, 32, 32, device="cuda", generator=gen)
             > 0.7).float()
    ops.reset_launch_counts()
    aux = step(student, teacher, opt, image, label, gen, T.default_sched(1.0))
    counts = ops.launch_counts()
    assert all(torch.isfinite(v) for v in aux.values()) and aux["kl_loss"] > 0
    assert counts["conv3_dk"] == 4
    assert (counts["up_k2s2_bwd"], counts["down_k2s2_bwd"]) == (6, 5)
    for k, v in student.state_dict().items():
        head = k.startswith(("Seg.up5.", "Seg.out_block."))
        assert torch.equal(v, before[k]) != head or \
            (head and k.endswith(".bias")), k


# ---- the reparam + KL kernel (kernels/csrc/reparam.cu)


def _seed(value):
    return torch.tensor([value], dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("b,d,kl_rel", [(4, 128, 1e-6), (3, 7, 1e-6),
                                        (64, 1000, 1e-5)])
def test_reparam_kernel_matches_plain(gen, b, d, kl_rel):
    """latent and KL against the plain version on the kernel's own eps, and
    that eps against the plain Philox draw of the same seed."""
    mean = _rnd(gen, b, d, scale=0.7)
    std = _rnd(gen, b, d).relu()            # exact zeros, as a ReLU gives
    before = reparam.reparam_kl.launches
    latent, kl, eps = reparam.reparam_kl_op(mean, std, 0.35, _seed(12345))
    torch.cuda.synchronize()
    assert reparam.reparam_kl.launches == before + 1
    want_latent, want_kl = reparam.reparam_kl_plain(mean, std, 0.35, eps)
    assert (latent - want_latent).abs().max().item() \
        <= 1e-6 * want_latent.abs().max().item()
    assert abs(kl.item() - want_kl.item()) <= kl_rel * abs(want_kl.item())
    plain_eps = reparam.philox_normal_plain(12345, (b, d), device="cuda")
    assert (eps - plain_eps).abs().max().item() <= 1e-5
    zero = reparam.reparam_kl_op(mean, std, 0.0, _seed(12345))[0]
    assert torch.equal(zero, mean)


def test_reparam_kernel_draws_a_standard_normal(gen):
    """One million draws from one call and 256 seeds of the train step's
    [4, 128]: mean, variance and tail shares within 5 standard errors;
    deterministic per seed, different across seeds."""
    big = reparam.reparam_kl_op(torch.zeros(1024, 1024, device="cuda"),
                                torch.ones(1024, 1024, device="cuda"), 1.0,
                                _seed(7))[2].double()
    m, s = torch.zeros(4, 128, device="cuda"), torch.ones(4, 128,
                                                           device="cuda")
    seeds = torch.cat([reparam.reparam_kl_op(m, s, 1.0, _seed(i))[2]
                       .reshape(-1) for i in range(256)]).double()
    for x in (big, seeds):
        n = x.numel()
        assert abs(x.mean().item()) < 5 / n ** 0.5
        assert abs(x.var().item() - 1.0) < 5 * (2.0 / n) ** 0.5
        for t, p in ((1.0, 0.31731), (2.0, 0.04550), (3.0, 0.0026998)):
            share = (x.abs() > t).double().mean().item()
            assert abs(share - p) < 5 * (p * (1 - p) / n) ** 0.5, (t, share)
    a = reparam.reparam_kl_op(m, s, 1.0, _seed(3))[2]
    assert torch.equal(a, reparam.reparam_kl_op(m, s, 1.0, _seed(3))[2])
    assert not torch.equal(a, reparam.reparam_kl_op(m, s, 1.0, _seed(4))[2])


def test_reparam_function_gradients(gen):
    mean = _rnd(gen, 4, 128).requires_grad_()
    std = _rnd(gen, 4, 128).relu().requires_grad_()
    g_latent = _rnd(gen, 4, 128)
    latent, kl, eps = reparam.reparam_kl(mean, std, 0.35, _seed(99))
    got = torch.autograd.grad((latent * g_latent).sum() + 0.3 * kl,
                              (mean, std))
    p_latent, p_kl = reparam.reparam_kl_plain(mean, std, 0.35, eps)
    want = torch.autograd.grad((p_latent * g_latent).sum() + 0.3 * p_kl,
                               (mean, std))
    for g_, w_ in zip(got, want):
        assert _rel(g_, w_) <= 1e-6


def test_reparam_wrapper_rejects_what_the_kernel_does_not_take(gen):
    mean, std = _rnd(gen, 4, 128), _rnd(gen, 4, 128).relu()
    with pytest.raises(ValueError):
        reparam.reparam_kl_op(mean.double(), std, 0.35, _seed(1))
    with pytest.raises(ValueError):
        reparam.reparam_kl_op(mean, std.t().contiguous().t(), 0.35, _seed(1))
    with pytest.raises(ValueError):
        reparam.reparam_kl_op(mean, std, 0.35, _seed(1).long())


def test_vae_train_step_on_the_card(gen):
    """One vae_train step at a small size: every weight moves (a conv bias
    under an InstanceNorm has a zero gradient in exact arithmetic), the
    reparam kernel launches once and each of the 32 convs launches its
    weight gradient."""
    from vae_segmentation_tpu_torch import ops, train as T
    from vae_segmentation_tpu_torch.models import ShapeVAE

    vae = ShapeVAE(n_class=2, dim=16, fmaps=(4, 8, 8, 16, 16, 32),
                   bottleneck=256,
                   generator=torch.Generator().manual_seed(0)).cuda()
    before = {k: v.clone() for k, v in vae.state_dict().items()}
    opt = T.optim.sgd(vae.parameters(), 1e-2)
    label = (torch.rand(2, 64, 64, 64, device="cuda", generator=gen)
             > 0.7).float()
    ops.reset_launch_counts()
    aux = T.make_vae_train_step(2)(vae, opt, label, gen)
    counts = ops.launch_counts()
    assert all(torch.isfinite(v) for v in aux.values())
    assert counts["reparam_kl"] == 1 and counts["conv3_dk"] == 32
    assert counts["dice_sums"] == 0 and counts["softmax_vjp"] == 1
    for k, v in vae.state_dict().items():
        if k.endswith(".weight"):
            assert not torch.equal(v, before[k]), k


# ---- the InstanceNorm kernels (kernels/csrc/instance_norm.cu) and the
# merged conv backward (kernels/csrc/conv3_bwd.cu)


@pytest.mark.parametrize("shape", [(2, 5, 9, 19, 3), (1, 8, 8, 8, 256),
                                   (2, 7, 6, 5, 16), (1, 4, 4, 4, 128)])
def test_norm_kernels_match_plain(gen, shape):
    """norm_stats and norm_bwd_sums within 1e-4 of their largest element
    (f64 across blocks against the plain f32 sums); norm_apply (y, s, t)
    and norm_bwd_dx equal to their plain versions on the kernels' own f64
    sums, bit for bit, relu on and off; one launch each."""
    b, c = shape[0], shape[-1]
    x = (_rnd(gen, *shape) * 3 + 1).bfloat16()
    g = _rnd(gen, *shape).bfloat16()
    before = {k: getattr(instance_norm, k).launches for k in (
        "norm_stats", "norm_apply", "norm_bwd_sums", "norm_bwd_dx")}
    st = instance_norm.norm_stats(x, f64=True)
    assert st.dtype == torch.float64
    st_plain = instance_norm.norm_stats_plain(x)
    for r in range(2):
        assert _rel(st[:, r], st_plain[:, r]) <= 1e-4, r
    for relu in (True, False):
        got = instance_norm.norm_apply(x, st, relu)
        want = instance_norm.fold_apply_plain(x, st, relu)
        assert all(torch.equal(a, w) for a, w in zip(got, want))
        y, s, t = got
        sums = instance_norm.norm_bwd_sums(x, g, s, t, relu, f64=True)
        want = instance_norm.norm_bwd_sums_plain(x, g, s, t, relu)
        for r in range(2):
            assert _rel(sums[:, r], want[:, r]) <= 1e-4, r
        assert torch.equal(
            instance_norm.norm_bwd_dx(x, g, s, t, sums, relu),
            instance_norm.norm_bwd_dx_plain(x, g, s, t, sums, relu))
    torch.cuda.synchronize()
    assert {k: getattr(instance_norm, k).launches - v
            for k, v in before.items()} == {
        "norm_stats": 1, "norm_apply": 2, "norm_bwd_sums": 2,
        "norm_bwd_dx": 2}


@pytest.mark.parametrize("c,n,offset", [(4096, 105, 0), (24, 105, 0),
                                        (3, 64, 0), (16, 105, 1)])
def test_norm_fold_gives_torch_bits(gen, c, n, offset):
    """The kernels' fold on arbitrary f64 sums (means up to 1e3, variances
    from 1e-12 to 1e6 and negative ones that clamp, a voxel count that is no
    power of two): norm_apply's (s, t) and y equal affine_from_stats +
    norm_apply_plain on the card bit for bit (ATen's f32 reciprocal of the
    count, its rsqrt), and norm_bwd_dx equals its plain version's means;
    on the vector path (C % 8 == 0), the element path (C 3) and a
    misaligned volume (offset 1: elements)."""
    b = 2
    mean = _rnd(gen, b, c, scale=100.0).double()
    var = torch.exp(_rnd(gen, b, c, scale=6.0)).double() \
        * torch.where(_rnd(gen, b, c) > -1.5, 1.0, -1e-3).double()
    sums = torch.stack([mean * n, (var + mean * mean) * n], dim=1)
    flat = (_rnd(gen, offset + b * n * c) * 3).bfloat16()
    x = flat[offset:].view(b, 1, 1, n, c)
    g = _rnd(gen, *x.shape).bfloat16()
    assert instance_norm._aligned(x) == (offset == 0)
    for relu in (True, False):
        y, s, t = instance_norm.norm_apply(x, sums, relu)
        ws, wt = instance_norm.affine_from_stats(sums.float(), n)
        assert torch.equal(s, ws) and torch.equal(t, wt)
        assert torch.equal(y, instance_norm.norm_apply_plain(x, s, t, relu))
        bsums = sums * 1e-3
        assert torch.equal(
            instance_norm.norm_bwd_dx(x, g, s, t, bsums, relu),
            instance_norm.norm_bwd_dx_plain(x, g, s, t, bsums, relu))


@pytest.mark.parametrize("shape,offset", [
    ((2, 7, 9, 11, 2), 0), ((1, 4, 4, 4, 2), 0), ((1, 3, 3, 3, 2), 0),
    ((1, 1, 1, 5, 2), 0), ((1, 1, 1, 3, 2), 0), ((2, 7, 9, 11, 2), 1),
    ((2, 32, 32, 32, 2), 0)])
def test_softmax_vjp_gives_plain_bits(gen, shape, offset):
    """softmax_vjp for two classes equals softmax_vjp_plain bit for bit:
    4-voxel items with tails of 0-3 voxels, no item (3 voxels), and a
    misaligned cotangent (element path); the same bits again."""
    n = 1
    for e in shape:
        n *= e
    y = torch.softmax(_rnd(gen, *shape), dim=-1).bfloat16()
    g = (_rnd(gen, offset + n)).bfloat16()[offset:].view(shape)
    got = losses.softmax_vjp(g, y)
    assert torch.equal(got, losses.softmax_vjp_plain(g, y))
    assert torch.equal(losses.softmax_vjp(g, y), got)


def test_instance_norm_function_gradients(gen):
    """instance_norm_act on the card (stats, apply; backward sums, dx)
    against autograd through the plain forward, bf16, 5e-2."""
    x = (_rnd(gen, 2, 6, 10, 20, 8) * 2 + 0.5).bfloat16()

    def plain(x):
        st = instance_norm.norm_stats_plain(x)
        s, t = instance_norm.affine_from_stats(st, 6 * 10 * 20)
        return instance_norm.norm_apply_plain(x, s, t)

    got = _grads(instance_norm.instance_norm_act, (x,))
    want = _grads(plain, (x,))
    assert _rel(got[0], want[0]) <= 5e-2


MERGED_CASES = [
    ((2, 5, 9, 19, 3), 5, True),      # ragged bricks, odd channels
    ((1, 3, 17, 7, 1), 8, False),
    ((1, 8, 8, 16, 16), 2, True),     # a head: Cout 2
    ((2, 4, 4, 4, 24), 48, False),    # three output-channel chunks
    ((1, 1, 1, 1, 16), 16, True),     # one voxel
    ((1, 4, 4, 4, 256), 256, True),
    # the deep stages of a vae_train step at batch 4: several output-channel
    # chunks (dx's partials added by the second pass), few bricks a block
    ((4, 4, 4, 4, 256), 256, True),
    ((4, 4, 4, 4, 128), 256, False),
    ((4, 8, 8, 8, 256), 128, False),
    ((4, 8, 8, 8, 128), 128, True),
    ((4, 16, 16, 16, 64), 64, True),
    ((2, 32, 32, 32, 32), 32, True),
]


def _merged_inputs(gen, shape, cout, pre):
    b, cin = shape[0], shape[-1]
    x = _rnd(gen, *shape).bfloat16()
    gy = _rnd(gen, *shape[:-1], cout).bfloat16()
    w = _rnd(gen, cout, cin, 3, 3, 3, scale=(27 * cin) ** -0.5)
    aff = (_rnd(gen, b, cin).abs() + 0.5, _rnd(gen, b, cin, scale=0.3)) \
        if pre else None
    return x, gy, w, aff


@pytest.mark.parametrize("shape,cout,pre", MERGED_CASES)
def test_conv3_merged_backward_matches_plain(gen, shape, cout, pre):
    """conv3_bwd against its plain version (the pair): dx within 1e-2 of
    max|dx| (bf16), dk, db, ds, dt within 1e-3 of their largest element;
    one launch."""
    x, gy, w, aff = _merged_inputs(gen, shape, cout, pre)
    before = conv3.conv3_bwd.launches
    got = conv3.conv3_bwd(x, gy, w, conv3.kernel_weight(w), aff)
    torch.cuda.synchronize()
    assert conv3.conv3_bwd.launches == before + 1
    want = conv3.conv3_bwd_plain(x, gy, w, aff)
    assert _rel(got[0], want[0]) <= 1e-2
    assert _rel(got[1], want[1]) <= 1e-3 and _rel(got[2], want[2]) <= 1e-3
    if pre:
        assert _rel(got[3], want[3]) <= 1e-3
    else:
        assert got[3] is None


@pytest.mark.parametrize("shape,cout,pre", [MERGED_CASES[i]
                                            for i in (0, 3, 5, 9)])
def test_conv3_merged_backward_repeats_bit_for_bit(gen, shape, cout, pre):
    """dx, dk, db and (ds, dt) of the merged kernel come out the same bits
    on every launch: each block writes its partials once and every sum is
    added in a fixed order (no atomics)."""
    x, gy, w, aff = _merged_inputs(gen, shape, cout, pre)
    kw = conv3.kernel_weight(w)
    first = [t.clone() for t in conv3.conv3_bwd(x, gy, w, kw, aff)
             if t is not None]
    for _ in range(3):
        again = [t for t in conv3.conv3_bwd(x, gy, w, kw, aff)
                 if t is not None]
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_conv3_merged_function_gradients(gen, monkeypatch):
    """The K1 Function's backward under VAESEG_MERGED_BWD=1: one merged
    launch for dx, dw, db, ds, dt, against autograd through the plain
    forward (bf16, 5e-2); with the weight frozen the pair's dx conv runs
    instead."""
    monkeypatch.setenv("VAESEG_MERGED_BWD", "1")
    b, cin, cout = 2, 8, 16
    x = _rnd(gen, b, 6, 10, 20, cin).bfloat16()
    w = _rnd(gen, cout, cin, 3, 3, 3, scale=(27 * cin) ** -0.5)
    bias = _rnd(gen, cout)
    s, t = _rnd(gen, b, cin).abs() + 0.5, _rnd(gen, b, cin, scale=0.3)

    def kernel(x, w, bias, s, t):
        return conv3.conv3(x, w, bias, conv3.kernel_weight(w), (s, t))

    def plain(x, w, bias, s, t):
        return conv3.conv3_plain(x, w, bias, (s, t))

    before = (conv3.conv3.launches, conv3.conv3_dk.launches,
              conv3.conv3_bwd.launches)
    got = _grads(kernel, (x, w, bias, s, t))
    assert (conv3.conv3.launches, conv3.conv3_dk.launches,
            conv3.conv3_bwd.launches) == (before[0] + 1, before[1],
                                          before[2] + 1)
    want = _grads(plain, (x, w, bias, s, t))
    for name, g_, w_ in zip(("dx", "dw", "db", "ds", "dt"), got, want):
        assert _rel(g_, w_) <= 5e-2, name
    xl = x.clone().requires_grad_(True)
    kernel(xl, w, bias, s, t).float().sum().backward()
    assert conv3.conv3_bwd.launches == before[2] + 1


def test_new_wrappers_reject_what_the_kernels_do_not_take(gen):
    x = _rnd(gen, 1, 4, 4, 4, 8)
    s, t = _rnd(gen, 1, 8).abs() + 0.5, _rnd(gen, 1, 8)
    with pytest.raises(ValueError):  # f32 activations
        instance_norm.norm_stats(x)
    with pytest.raises(ValueError):  # f32 sums: the kernel takes f64
        instance_norm.norm_apply(x.bfloat16(),
                                 torch.stack([s, t], dim=1))
    with pytest.raises(ValueError):  # an affine of the wrong shape
        instance_norm.norm_bwd_dx(x.bfloat16(), x.bfloat16(), s[:, :4],
                                  t[:, :4], torch.zeros(1, 2, 8).double())
    w = _rnd(gen, 8, 8, 3, 3, 3)
    with pytest.raises(ValueError):  # no kernel-layout weight
        conv3.conv3_bwd(x.bfloat16(), x.bfloat16(), w)
    with pytest.raises(ValueError):  # f32 cotangent
        conv3.conv3_bwd(x.bfloat16(), x, w, conv3.kernel_weight(w))


# ---- dice_sums over 16-byte items, its VJP and the reparam VJP
# (kernels/csrc/losses.cu, kernels/csrc/reparam.cu)

# shapes [B, D, H, W, C]: C 2 (every call of the nets) with nvox % 4 of
# 0-3 (items and an element tail), C 1, 4 and 8 (other items), C 3
# (element path only), batches 2 and 3 with nvox % 4 != 0 (batch bases
# off 16 bytes: element path)
DICE_CASES = [(1, 7, 9, 11, 2), (1, 4, 4, 4, 2), (1, 3, 3, 3, 2),
              (1, 1, 1, 5, 2), (1, 1, 1, 3, 2), (2, 7, 9, 11, 2),
              (3, 5, 6, 7, 2), (2, 6, 5, 4, 1), (2, 3, 5, 8, 4),
              (1, 5, 6, 7, 8), (2, 5, 6, 7, 3), (2, 32, 32, 32, 2)]


def _dice_vols(gen, shape, k, offset=0):
    """pred and k targets: softmax probabilities in bf16, the first
    target `offset` elements past a 16-byte boundary."""
    n = 1
    for e in shape:
        n *= e
    vols = [torch.softmax(_rnd(gen, *shape), dim=-1).bfloat16()
            for _ in range(1 + k)]
    if offset:
        t = torch.empty(n + offset, dtype=torch.bfloat16, device="cuda")
        t[offset:] = vols[1].reshape(-1)
        vols[1] = t[offset:].view(shape)
    return vols[0], vols[1:]


@pytest.mark.parametrize("shape", DICE_CASES)
@pytest.mark.parametrize("offset", [0, 1])
def test_dice_sums_matches_plain_and_f64(gen, shape, offset):
    """Each row within 1e-5 of the f64 sums (of the row's largest value:
    sums of probabilities do not cancel) and of the plain version; one
    launch a call; the same bits again."""
    for k in (1, 2, 3):
        pred, targets = _dice_vols(gen, shape, k, offset)
        before = losses.dice_sums.launches
        got = losses.dice_sums(pred, targets)
        assert losses.dice_sums.launches == before + 1
        dims = tuple(range(1, len(shape) - 1))
        p64 = pred.double()
        rows = [p64.sum(dim=dims)]
        for t in targets:
            t64 = t.double()
            rows += [t64.sum(dim=dims), (p64 * t64).sum(dim=dims)]
        want = torch.stack(rows, dim=1)
        assert got.shape == want.shape
        assert _rel(got.double(), want) <= 1e-5
        assert _rel(got, losses.dice_sums_plain(pred, targets)) <= 1e-5
        assert torch.equal(losses.dice_sums(pred, targets), got)


NEEDS = [(True, (True, False, False)), (True, (False,) * 3),
         (False, (True, True, True)), (True, (True, True, True)),
         (False, (False, True, False))]


@pytest.mark.parametrize("shape", DICE_CASES)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_dice_vjp_gives_plain_bits(gen, shape, k):
    """dice_sums_vjp equals dice_sums_vjp_plain bit for bit for every set
    of needed gradients (a gradient that is not needed is None), with one
    launch; a misaligned target takes the element path to the same
    bits."""
    for offset in (0, 1):
        pred, targets = _dice_vols(gen, shape, k, offset)
        g = _rnd(gen, shape[0], 1 + 2 * k, shape[-1])
        for need_pred, need_t in NEEDS:
            need_t = need_t[:k]
            before = losses.dice_sums_vjp.launches
            got = losses.dice_sums_vjp(g, pred, targets, need_pred, need_t)
            launched = need_pred or any(need_t)
            assert losses.dice_sums_vjp.launches == before + int(launched)
            want = losses.dice_sums_vjp_plain(g, pred, targets, need_pred,
                                              need_t)
            assert len(got) == 1 + k
            for o, w, need in zip(got, want, (need_pred, *need_t)):
                assert (o is None) == (w is None) == (not need)
                if need:
                    assert torch.equal(o, w)


def test_multi_soft_dice_honours_needs_input_grad(gen):
    """The adaptation loss's three Dices: pred and the reconstruction need
    a gradient, the pseudo-label and the one-hot label do not. One
    dice_sums_vjp launch writes dp and d recon only, with the bits of the
    plain backward."""
    shape = (2, 9, 8, 7, 2)
    pred, (recon, pseudo, onehot) = _dice_vols(gen, shape, 3)

    def grads(run_plain):
        p = pred.clone().requires_grad_(True)
        r = recon.clone().requires_grad_(True)
        patch = mock.patch.object(losses, "dice_sums_vjp",
                                  losses.dice_sums_vjp_plain) \
            if run_plain else contextlib.nullcontext()
        with patch:
            d = losses.multi_soft_dice(p, (r, pseudo, onehot))
            loss = sum(x[:, 1].mean() * (i + 1) for i, x in enumerate(d))
            return torch.autograd.grad(loss, (p, r))

    calls = []
    real = losses.dice_sums_vjp

    def spy(g, pred_, targets, need_pred=True, need_targets=(True,) * 3):
        calls.append((need_pred, tuple(need_targets)))
        return real(g, pred_, targets, need_pred, need_targets)

    # the wrapper counts its launch on the name it is called by
    spy.launches = 0
    with mock.patch.object(losses, "dice_sums_vjp", spy):
        got = grads(False)
    assert spy.launches == 1
    assert calls == [(True, (True, False, False))]
    want = grads(True)
    for o, w in zip(got, want):
        assert torch.equal(o, w)


@pytest.mark.parametrize("b,d", [(4, 128), (3, 7), (5, 33), (7, 1000)])
def test_reparam_vjp_gives_plain_bits(gen, b, d):
    """reparam_kl_vjp equals reparam_kl_vjp_plain bit for bit (odd batches:
    g_kl / B is ATen's product with the f32 reciprocal), with one launch;
    through the Function, the backward of a vae_train-like loss equals the
    plain backward's bits."""
    mean = _rnd(gen, b, d, scale=0.7)
    std = _rnd(gen, b, d).relu()            # exact zeros, as a ReLU gives
    eps = _rnd(gen, b, d)
    g_latent = _rnd(gen, b, d)
    g_kl = _rnd(gen, 1).reshape(())
    for scale in (0.35, 1.0, 0.0):
        before = reparam.reparam_kl_vjp.launches
        got = reparam.reparam_kl_vjp(mean, std, eps, g_latent, g_kl, scale)
        assert reparam.reparam_kl_vjp.launches == before + 1
        want = reparam.reparam_kl_vjp_plain(mean, std, eps, g_latent, g_kl,
                                            scale)
        for o, w in zip(got, want):
            assert torch.equal(o, w)

    def grads(plain):
        m, s = mean.clone().requires_grad_(), std.clone().requires_grad_()
        patch = mock.patch.object(reparam, "reparam_kl_vjp",
                                  reparam.reparam_kl_vjp_plain) if plain \
            else contextlib.nullcontext()
        with patch:
            latent, kl, _ = reparam.reparam_kl(m, s, 0.35, _seed(21))
            loss = (latent * g_latent).sum() + 0.3 * kl
            return torch.autograd.grad(loss, (m, s))

    before = reparam.reparam_kl_vjp.launches
    got = grads(False)
    assert reparam.reparam_kl_vjp.launches == before + 1
    for o, w in zip(got, grads(True)):
        assert torch.equal(o, w)


def test_dice_and_reparam_vjp_wrappers_reject_what_the_kernels_do_not_take(
        gen):
    pred, targets = _dice_vols(gen, (1, 4, 4, 4, 2), 2)
    g = _rnd(gen, 1, 5, 2)
    with pytest.raises(ValueError):  # rows of another K
        losses.dice_sums_vjp(g[:, :3], pred, targets)
    with pytest.raises(ValueError):  # f32 volumes
        losses.dice_sums_vjp(g, pred.float(), targets)
    with pytest.raises(ValueError):  # four targets
        losses.dice_sums_vjp(_rnd(gen, 1, 9, 2), pred, [targets[0]] * 4)
    m = _rnd(gen, 4, 8)
    with pytest.raises(ValueError):  # a non-contiguous cotangent
        reparam.reparam_kl_vjp(m, m, m, m.t().contiguous().t(), m[0, 0],
                               0.35)
    with pytest.raises(ValueError):  # f64 statistics
        reparam.reparam_kl_vjp(m.double(), m, m, m, m[0, 0], 0.35)


# ---- the sliding-window sweep at batch 4 (chip_smoke.py phase 14)


def test_sliding_window_sweep_matches_plain(gen):
    """A full-width SegUNet swept over one 160^3 phantom padded to 192^3
    (8 windows of 128^3 at overlap 0.5, 2 chunks of 4): the launches of 2
    SegUNet forwards, finite probabilities of the volume's shape, and the
    kernel path against the plain path under chip_smoke's rule (mean abs
    difference within DRIFT_MULTIPLE times the plain path's own drift under
    reordered f32 sums, Dice within 0.01)."""
    import numpy as np

    import chip_smoke
    from vae_segmentation_tpu_torch import ops
    from vae_segmentation_tpu_torch.cli.common import (
        sweep_volume, volume_dice)
    from vae_segmentation_tpu_torch.data.synthetic import make_phantom
    from vae_segmentation_tpu_torch.eval.sliding_window import (
        sliding_window_predict)
    from vae_segmentation_tpu_torch.models import SegUNet

    case = make_phantom(np.random.default_rng(5), 160)
    vol, shape = sweep_volume(case["image"], (128,) * 3, "cuda"), (160,) * 3
    assert tuple(vol.shape) == (192, 192, 192)
    net = SegUNet(n_class=2, generator=torch.Generator().manual_seed(0)
                  ).cuda()

    def sweep():
        probs = sliding_window_predict(net, vol, (128, 128, 128), 0.5, 4, 2)
        return probs[:shape[0], :shape[1], :shape[2]]

    ops.reset_launch_counts()
    with torch.no_grad():
        got = sweep()
        counts = ops.launch_counts()
        with chip_smoke.plain_ops():
            plain = sweep()
        with chip_smoke.plain_ops(reordered=True):
            reordered = sweep()
    assert (counts["conv3"], counts["down_k2s2"], counts["up_k2s2"]) == \
        (2 * 26, 2 * 4, 2 * 4)
    assert tuple(got.shape) == (160, 160, 160, 2)
    assert bool(torch.isfinite(got).all())
    err = (got - plain).abs().mean().item()
    drift = (plain - reordered).abs().mean().item()
    assert err <= chip_smoke.DRIFT_MULTIPLE * drift, (err, drift)
    dice = [volume_dice(torch.argmax(p, dim=-1),
                        case["label"].astype(np.float32), 2)
            for p in (got, plain)]
    assert abs(dice[0] - dice[1]) <= 0.01, dice


# ---- the cubic warp (--aug_order 3) and the source-replay step
# (chip_smoke.py phase 15)

# the cubic warp's f32 rule (tests/test_torch_augment_cubic.py::F32_TOL):
# within this fraction of the volume's largest |value| of the f64 warp
CUBIC_F32_TOL = 4e-6


def test_cubic_warp_matches_its_cpu_run_in_f64(gen):
    """spatial_augment's draws at order 3 on two 96^3 phantoms into 64^3:
    the card's f32 warp against the CPU's f64 warp at the same sampling
    grid, within CUBIC_F32_TOL of the largest |value|; the mask and the
    label equal."""
    import numpy as np

    from vae_segmentation_tpu_torch.data import augment
    from vae_segmentation_tpu_torch.data.synthetic import make_phantom

    rng = np.random.default_rng(0)
    cases = [make_phantom(rng, 96) for _ in range(2)]
    image = torch.from_numpy(np.stack([c["image"] for c in cases])
                             .astype(np.float32)).cuda()
    label = torch.from_numpy(np.stack([c["label"] for c in cases])
                             .astype(np.float32)).cuda()
    patch = (64, 64, 64)
    draw = augment.sample_affine_params(gen, 2, patch, image.shape[1:])
    coords = augment.affine_coords(*draw, patch)
    got = augment.warp_at(image, label, coords, order=3)
    want = augment.warp_at(image.double().cpu(), label.double().cpu(),
                           coords.double().cpu(), order=3)
    img, ref = got[0].double().cpu(), want[0]
    assert (img - ref).abs().max().item() <= \
        CUBIC_F32_TOL * image.abs().max().item()
    fill = augment.BORDER_CVAL_DATA
    assert torch.equal(img == fill, ref == fill)
    assert torch.equal(got[1].double().cpu(), want[1])


def test_replay_step_matches_the_plain_path(gen):
    """One source-replay step of a narrow Joint at 64^3, batch 2: its
    launches (the Seg forward, its backward, one dice_sums and its VJP),
    the Dice loss and every Seg gradient against the plain path under
    chip_smoke's rule (within DRIFT_MULTIPLE times the plain path's own
    drift under reordered f32 sums; the loss within 1e-3), the VAE without
    a gradient."""
    import chip_smoke
    from vae_segmentation_tpu_torch import ops, train as T
    from vae_segmentation_tpu_torch.models import Joint

    state = Joint(n_class=2, dim=16, fmaps=(4, 8, 8, 16, 16, 32),
                  bottleneck=256,
                  generator=torch.Generator().manual_seed(0)).state_dict()
    image = _rnd(gen, 2, 64, 64, 64)
    label = (torch.rand(2, 64, 64, 64, device="cuda", generator=gen)
             > 0.6).float()
    step = T.make_seg_replay_step(2)

    def run():
        net = Joint(n_class=2, dim=16, fmaps=(4, 8, 8, 16, 16, 32),
                    bottleneck=256).cuda()
        net.load_state_dict(state)
        opt = T.optim.sgd(T.optim.freeze_vae(net), 0.0)
        aux = step(net, opt, image, label)
        return aux["dice_loss"].item(), {
            k: p.grad.clone() for k, p in net.named_parameters()
            if p.grad is not None}

    ops.reset_launch_counts()
    loss_k, grads_k = run()
    counts = ops.launch_counts()
    with chip_smoke.plain_ops():
        loss_p, grads_p = run()
    with chip_smoke.plain_ops(reordered=True):
        loss_r, grads_r = run()
    assert counts["dice_sums"] == 1 and counts["dice_sums_vjp"] == 1
    assert counts["softmax_vjp"] == 1 and counts["conv3_dk"] == 26
    assert sorted(grads_k) == sorted(grads_p)
    assert all(k.startswith("Seg.") for k in grads_k)
    assert abs(loss_k - loss_p) <= max(
        chip_smoke.DRIFT_MULTIPLE * abs(loss_r - loss_p), 1e-3)
    _, _, worst = chip_smoke.drift_ratios(grads_k, grads_p, grads_r)
    assert max(worst.values()) <= chip_smoke.DRIFT_MULTIPLE, worst


# the valid-plane range (dlim) of rows 1-5: the halo slabs of a 'spatial'
# mesh, ragged tiles and odd channels among them; ranges of the first, an
# interior and the last slab, and one plane only
DLIM_CASES = [((2, 6, 9, 19, 3), 5, (1, 5)), ((1, 10, 8, 16, 8), 16, (0, 9)),
              ((2, 6, 16, 16, 16), 8, (0, 4)), ((1, 4, 4, 4, 256), 256, (1, 2)),
              ((1, 34, 32, 32, 16), 16, (1, 33)), ((2, 3, 5, 7, 24), 8, (1, 1))]


@pytest.mark.parametrize("shape,cout,dlim", DLIM_CASES)
def test_dlim_kernels_match_plain(gen, shape, cout, dlim):
    """K1 with the prologue and stats, K1's dx conv with post, conv3_dk and
    conv3_bwd under the prologue, each with a range, against their plain
    versions with it (y, dx within 1e-2 of the largest element; f32 sums
    within 1e-3), with a shift whose relu is nonzero where x is 0; one
    launch each, counted with a range; and the range changes the result
    (a zero halo plane outside it would turn into relu(t))."""
    b, cin = shape[0], shape[-1]
    x = _rnd(gen, *shape).bfloat16()
    x[:, 0] = 0
    x[:, -1] = 0
    gy = _rnd(gen, *shape[:-1], cout).bfloat16()
    w = _rnd(gen, cout, cin, 3, 3, 3, scale=(27 * cin) ** -0.5)
    bias = _rnd(gen, cout)
    aff = (_rnd(gen, b, cin).abs() + 0.5,
           _rnd(gen, b, cin, scale=0.3).abs() + 0.2)
    kw = conv3.kernel_weight(w)
    counts = (conv3.conv3.dlim_launches, conv3.conv3_dk.dlim_launches,
              conv3.conv3_bwd.dlim_launches)
    y, st = conv3.conv3_op(x, w, bias, kw, aff, True, dlim=dlim)
    y_p, st_p = conv3.conv3_plain(x, w, bias, aff, True, dlim=dlim)
    _close(y, y_p, 1e-2)
    assert _rel(st, st_p) <= 1e-3
    if dlim != (0, shape[1] - 1):
        assert not torch.equal(y, conv3.conv3_op(x, w, bias, kw, aff, True)[0])
    w_t = w.flip(2, 3, 4).transpose(0, 1)
    kw_t = kw.flip(0).transpose(1, 2).contiguous()
    dx, dst = conv3.conv3_op(gy, w_t, None, kw_t, post=(x, *aff), dlim=dlim)
    dx_p, dst_p = conv3.conv3_plain(gy, w_t, None, post=(x, *aff), dlim=dlim)
    _close(dx, dx_p, 1e-2)
    assert _rel(dst, dst_p) <= 1e-3
    dk, db = conv3.conv3_dk(x, gy, aff, dlim)
    dk_p, db_p = conv3.conv3_dk_plain(x, gy, aff, dlim)
    assert _rel(dk, dk_p) <= 1e-3 and _rel(db, db_p) <= 1e-3
    got = conv3.conv3_bwd(x, gy, w, kw, aff, dlim)
    want = conv3.conv3_bwd_plain(x, gy, w, aff, dlim)
    torch.cuda.synchronize()
    _close(got[0], want[0], 1e-2)
    for g, p in zip(got[1:], want[1:]):
        assert _rel(g, p) <= 1e-3
    assert (conv3.conv3.dlim_launches, conv3.conv3_dk.dlim_launches,
            conv3.conv3_bwd.dlim_launches) == (counts[0] + 2, counts[1] + 1,
                                               counts[2] + 1)


def test_dlim_kernels_refuse_a_range_outside_the_planes(gen):
    x = _rnd(gen, 1, 4, 8, 8, 8).bfloat16()
    w = _rnd(gen, 8, 8, 3, 3, 3, scale=0.05)
    aff = (_rnd(gen, 1, 8).abs() + 0.5, _rnd(gen, 1, 8))
    kw = conv3.kernel_weight(w)
    for dlim in ((0, 4), (-1, 2), (3, 1)):
        with pytest.raises(ValueError):
            conv3.conv3_op(x, w, None, kw, aff, dlim=dlim)
        with pytest.raises(ValueError):
            conv3.conv3_dk(x, x, aff, dlim)
        with pytest.raises(ValueError):
            conv3.conv3_bwd(x, x, w, kw, aff, dlim)


def _launch_counts():
    return (conv3.conv3.launches, bridges.down_k2s2.launches,
            bridges.up_k2s2.launches)


@pytest.mark.parametrize("kind", ["gsconv3d", "gsconv3d_k2", "sconv3d",
                                  "gsconvtranspose3d"])
def test_gs_convs_launch_their_kernel(gen, kind):
    """A reparametrised conv of models/gs.py at a kernel's shape launches
    that kernel on the card (K1, K2, K3) on its derived weight: the output
    against the same module's plain path on the CPU, the weight gradient
    through the reparametrisation too."""
    from vae_segmentation_tpu_torch.models import gs

    g = torch.Generator().manual_seed(1)
    m, launched = {
        "gsconv3d": (gs.GSConv3d(16, 24, num_group=4, generator=g), 0),
        "gsconv3d_k2": (gs.GSConv3d(16, 24, kernel=2, stride=2,
                                    padding="VALID", generator=g), 1),
        "sconv3d": (gs.SConv3d(16, 24, generator=g), 0),
        "gsconvtranspose3d": (gs.GSConvTranspose3d(16, 24, num_group=2,
                                                   generator=g), 2)}[kind]
    x = _rnd(gen, 2, 8, 12, 16, 16).bfloat16()
    before = _launch_counts()
    mc = m.cuda()
    y = mc(x)
    (y.float() * y.float()).sum().backward()
    torch.cuda.synchronize()
    after = _launch_counts()
    assert [a - b for a, b in zip(after, before)] == \
        [int(i == launched) for i in range(3)]
    grad = mc.weight.grad.cpu()
    m_cpu = mc.cpu()
    m_cpu.weight.grad = None
    y_cpu = m_cpu(x.cpu())
    (y_cpu.float() * y_cpu.float()).sum().backward()
    _close(y.cpu(), y_cpu, 1e-2)
    assert _rel(grad, m_cpu.weight.grad) <= 2e-2


@pytest.mark.parametrize("norm_type", [2, 3])
def test_norm_type_models_launch_the_kernels(gen, norm_type):
    """A norm_type 2 or 3 SegUNet and a SegmentationGS on the card: every
    3^3 conv through K1 (no prologue, no stats epilogue), every Down entry
    through K2 and Up entry through K3, finite probabilities summing to
    1."""
    from vae_segmentation_tpu_torch.models import SegmentationGS, SegUNet
    from vae_segmentation_tpu_torch.models.blocks import (
        Conv3, DownConv, TConv2)

    g = torch.Generator().manual_seed(2)
    nets = [SegUNet(fmaps=(8, 8, 16, 16, 32, 32), generator=g,
                    norm_type=norm_type).cuda()]
    if norm_type == 3:
        nets.append(SegmentationGS(fmaps=(8, 8, 16, 16), generator=g).cuda())
    x = _rnd(gen, 2, 32, 32, 32, 1)
    for net in nets:
        before = _launch_counts()
        with torch.no_grad():
            y = net(x)
        torch.cuda.synchronize()
        want = [sum(isinstance(m, c) for m in net.modules())
                for c in (Conv3, DownConv, TConv2)]
        assert [a - b for a, b in zip(_launch_counts(), before)] == want
        assert torch.isfinite(y.float()).all()
        assert (y.float().sum(-1) - 1).abs().max().item() <= 1e-2
