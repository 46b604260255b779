"""The port's backward kernels' plain versions (conv3 dx with the `post`
epilogue, conv3_dk, the bridge backwards, softmax_vjp, dice_sums) against
the JAX package's Pallas backward kernels run in interpret mode on the CPU.

On a CPU tensor each ``torch.autograd.Function`` of the port runs the plain
versions in its backward, so ``torch.autograd.grad`` through
``conv3.conv3`` / ``bridges.down_k2s2`` / ``bridges.up_k2s2`` is held to
``jax.vjp`` through the TPU ops (whose custom VJPs launch ``_run_dk``,
``_run_conv(post=...)``, ``_run_bwd``, ``_run_down_bwd[_pre]``,
``softmax_group_vjp``): same inputs and cotangents (numpy, seeded), f32, max
abs error <= 1e-5 * max|gradient|. The folded-rep kernels are compared
through the s2d fold/unfold and weight expansion, differentiated by JAX."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_segmentation_tpu.ops import s2d
from vae_segmentation_tpu.ops.pallas import dicesums as jdice
from vae_segmentation_tpu.ops.pallas.softmaxvjp import softmax_group_vjp
from vae_segmentation_tpu.ops.pallas.stencil3 import (
    conv3_stencil, conv3_stencil_folded_softmax_pre, conv3_stencil_pre)
from vae_segmentation_tpu.ops.pallas.upbridge import (
    down_bridge_w, down_bridge_w_pre, up_bridge_w)
from vae_segmentation_tpu_torch.ops import bridges, conv3, losses

torch.set_num_threads(2)

REL = 1e-5  # f32: max abs error <= REL * max|want|


def _close(got, want, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), (what, err, np.abs(want).max())


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
        .requires_grad_(grad)


def _affine(rng, b, c):
    return (rng.normal(size=(b, c)) * 0.5 + 1.0).astype(np.float32), \
        (rng.normal(size=(b, c)) * 0.3).astype(np.float32)


def _torch_grads(outs, leaves, cots):
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, leaves, [_t(c) for c in cots])


@pytest.mark.parametrize("shape,cout,pre", [
    ((2, 4, 8, 8, 8), 16, False),
    ((1, 5, 6, 16, 1), 8, False),     # the 1-channel entry conv
    ((2, 4, 8, 8, 16), 8, True),      # prologue: dx through `post`, ds, dt
])
def test_conv3_backward_vs_stencil(rng, shape, cout, pre):
    """dx, dk, db (and ds, dt) of K1 with the stats output's cotangent
    folded in == the VJP of conv3_stencil / conv3_stencil_pre."""
    b, cin = shape[0], shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(cout, cin, 3, 3, 3)) * 0.2).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    gy = rng.normal(size=shape[:-1] + (cout,)).astype(np.float32)
    gst = (rng.normal(size=(b, 2, cout)) * 0.1).astype(np.float32)
    k = jnp.asarray(w.transpose(2, 3, 4, 1, 0))
    xt, wt, bt = _t(x, True), _t(w, True), _t(bias, True)
    if pre:
        s, t = _affine(rng, b, cin)
        _, vjp = jax.vjp(
            lambda x, s, t, k, b: conv3_stencil_pre(x, s, t, k, b, None, True),
            jnp.asarray(x), jnp.asarray(s), jnp.asarray(t), k,
            jnp.asarray(bias))
        dx, ds, dt, dk, db = vjp((jnp.asarray(gy), jnp.asarray(gst)))
        st_, tt = _t(s, True), _t(t, True)
        got = _torch_grads(conv3.conv3(xt, wt, bt, pre=(st_, tt), stats=True),
                           (xt, wt, bt, st_, tt), (gy, gst))
        _close(got[3], ds, "ds")
        _close(got[4], dt, "dt")
    else:
        _, vjp = jax.vjp(lambda x, k, b: conv3_stencil(x, k, b, False, True),
                         jnp.asarray(x), k, jnp.asarray(bias))
        dx, dk, db = vjp((jnp.asarray(gy), jnp.asarray(gst)))
        got = _torch_grads(conv3.conv3(xt, wt, bt, stats=True),
                           (xt, wt, bt), (gy, gst))
    _close(got[0], dx, "dx")
    _close(got[1], np.asarray(dk).transpose(4, 3, 0, 1, 2), "dk")
    _close(got[2], db, "db")


def test_conv3_dk_plain_layout_and_padding(rng):
    """conv3_dk's plain version returns the kernel layout [27, Cin, Cout]
    and an out-of-volume tap contributes 0 after the prologue, not
    relu(t): an explicit tap sum over the zero-padded normalized input."""
    b, cin, cout = 2, 3, 5
    x = _t(rng.normal(size=(b, 4, 5, 6, cin)))
    gy = _t(rng.normal(size=(b, 4, 5, 6, cout)))
    s, t = (_t(a) for a in _affine(rng, b, cin))
    t = t.abs() + 0.5                       # relu(t) > 0 at the border
    dk, db = conv3.conv3_dk(x, gy, (s, t))
    xn = torch.relu(x * s[:, None, None, None] + t[:, None, None, None])
    xp = torch.nn.functional.pad(xn, (0, 0, 1, 1, 1, 1, 1, 1))
    for tap in range(27):
        kd, kh, kw = tap // 9, (tap // 3) % 3, tap % 3
        ref = torch.einsum("bdhwc,bdhwo->co",
                           xp[:, kd:kd + 4, kh:kh + 5, kw:kw + 6], gy)
        assert torch.allclose(dk[tap], ref, rtol=1e-4, atol=1e-4), tap
    assert torch.allclose(db, gy.sum(dim=(0, 1, 2, 3)), rtol=1e-5, atol=1e-5)


def test_softmax_head_backward_vs_folded_softmax_pre(rng):
    """The Seg/VAE head: K1 with prologue and softmax epilogue. Its
    backward (softmax_vjp, dx with post, dk) == the VJP of
    conv3_stencil_folded_softmax_pre on the W-packed folded rep."""
    nc, cin, b = 2, 4, 1
    x = rng.normal(size=(b, 8, 8, 32, cin)).astype(np.float32)
    w = (rng.normal(size=(nc, cin, 3, 3, 3)) * 0.3).astype(np.float32)
    bias = rng.normal(size=(nc,)).astype(np.float32)
    s, t = _affine(rng, b, cin)
    g = rng.normal(size=(b, 8, 8, 32, nc)).astype(np.float32)
    lanes = s2d.NB * s2d.WPACK

    def f(x, s, t, k, bias):
        ke = s2d.expand_kernel_w(s2d.expand_kernel3_fast(k))
        yf = conv3_stencil_folded_softmax_pre(
            s2d.fold_rep(x, True), jnp.tile(s, lanes), jnp.tile(t, lanes),
            ke, jnp.tile(bias, lanes), True, None, nc)
        return s2d.unfold_rep(yf, nc)

    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(s), jnp.asarray(t),
                     jnp.asarray(w.transpose(2, 3, 4, 1, 0)),
                     jnp.asarray(bias))
    dx, ds, dt, dk, db = vjp(jnp.asarray(g))
    leaves = [_t(a, True) for a in (x, w, bias, s, t)]
    xt, wt, bt, st_, tt = leaves
    got = _torch_grads(conv3.conv3(xt, wt, bt, pre=(st_, tt), softmax=True),
                       leaves, (g,))
    _close(got[0], dx, "dx")
    _close(got[1], np.asarray(dk).transpose(4, 3, 0, 1, 2), "dk")
    _close(got[2], db, "db")
    _close(got[3], ds, "ds")
    _close(got[4], dt, "dt")


@pytest.mark.parametrize("n_class", [2, 3])
def test_softmax_vjp_plain_vs_pallas(rng, n_class):
    shape = (2, 4, 8, 8, n_class)
    logits = rng.normal(size=shape).astype(np.float32)
    y = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    g = rng.normal(size=shape).astype(np.float32)
    want = softmax_group_vjp(jnp.asarray(g), jnp.asarray(y), n_class)
    _close(losses.softmax_vjp(_t(g), _t(y)), want)


@pytest.mark.parametrize("k", [1, 3])
def test_dice_sums_plain_vs_pallas(rng, k):
    """dice_sums (forward) and multi_soft_dice (values and gradients) ==
    the Pallas dice-sums kernel and its multi_soft_dice."""
    b, d, h, w, c = 2, 4, 8, 8, 2
    vols = [rng.random((b, d, h, w, c)).astype(np.float32)
            for _ in range(1 + k)]
    flat = [jnp.asarray(v).reshape(b, d, h, w * c) for v in vols]
    sums = np.asarray(jdice.dice_sums(*flat))              # [B, 8, W*C]
    want = sums.reshape(b, 8, w, c).sum(axis=2)[:, :1 + 2 * k]
    got = losses.dice_sums(_t(vols[0]), [_t(v) for v in vols[1:]])
    _close(got, want, "sums")

    cots = [rng.normal(size=(b, c)).astype(np.float32) for _ in range(k)]
    _, vjp = jax.vjp(
        lambda p, *ts: tuple(jdice.multi_soft_dice(p, ts, c, eps=1e-6)),
        *[jnp.asarray(v) for v in vols])
    want_g = vjp(tuple(jnp.asarray(g) for g in cots))
    leaves = [_t(v, True) for v in vols]
    dices = losses.multi_soft_dice(leaves[0], leaves[1:], eps=1e-6)
    got_g = _torch_grads(tuple(dices), leaves, cots)
    for i, (gg, wg) in enumerate(zip(got_g, want_g)):
        _close(gg, wg, f"grad {i}")


@pytest.mark.parametrize("pre", [False, True])
def test_down_backward_vs_down_bridge(rng, pre):
    """dx, dk, db (and ds, dt) of K2 == the VJP of down_bridge_w[_pre]."""
    b, c, o = 2, 4, 4
    x = rng.normal(size=(b, 16, 16, 16, c)).astype(np.float32)
    w = rng.normal(size=(o, c, 2, 2, 2)).astype(np.float32)
    bias = rng.normal(size=(o,)).astype(np.float32)
    g = rng.normal(size=(b, 8, 8, 8, o)).astype(np.float32)
    lanes = s2d.NB * s2d.WPACK
    k = jnp.asarray(w.transpose(2, 3, 4, 1, 0))
    xt, wt, bt = _t(x, True), _t(w, True), _t(bias, True)
    if pre:
        s, t = _affine(rng, b, c)
        _, vjp = jax.vjp(
            lambda x, s, t, k, bias: s2d.unfold(down_bridge_w_pre(
                s2d.fold_rep(x, True), jnp.tile(s, lanes),
                jnp.tile(t, lanes), k, bias)),
            jnp.asarray(x), jnp.asarray(s), jnp.asarray(t), k,
            jnp.asarray(bias))
        dx, ds, dt, dk, db = vjp(jnp.asarray(g))
        st_, tt = _t(s, True), _t(t, True)
        got = _torch_grads(bridges.down_k2s2(xt, wt, bt, pre=(st_, tt)),
                           (xt, wt, bt, st_, tt), (g,))
        _close(got[3], ds, "ds")
        _close(got[4], dt, "dt")
    else:
        _, vjp = jax.vjp(
            lambda x, k, bias: s2d.unfold(down_bridge_w(
                s2d.fold_rep(x, True), k, bias)),
            jnp.asarray(x), k, jnp.asarray(bias))
        dx, dk, db = vjp(jnp.asarray(g))
        got = _torch_grads(bridges.down_k2s2(xt, wt, bt), (xt, wt, bt), (g,))
    _close(got[0], dx, "dx")
    _close(got[1], np.asarray(dk).transpose(4, 3, 0, 1, 2), "dk")
    _close(got[2], db, "db")


def test_up_backward_vs_up_bridge(rng):
    """dx, dk, db of K3 == the VJP of up_bridge_w; the weight gradient
    crosses with torch_compat's tap flip."""
    b, c, o = 2, 4, 4
    x = rng.normal(size=(b, 8, 8, 16, c)).astype(np.float32)
    w = rng.normal(size=(c, o, 2, 2, 2)).astype(np.float32)
    bias = rng.normal(size=(o,)).astype(np.float32)
    g = rng.normal(size=(b, 16, 16, 32, o)).astype(np.float32)
    k_flax = jnp.asarray(np.ascontiguousarray(
        w.transpose(2, 3, 4, 0, 1)[::-1, ::-1, ::-1]))

    def f(x, k_flax, bias):
        k1 = s2d.expand_up_kernel(k_flax).reshape(c, s2d.NB * o)
        yf = up_bridge_w(s2d.fold(x), k1,
                         jnp.tile(bias, s2d.NB * s2d.WPACK))
        return s2d.unfold_rep(yf, o)

    _, vjp = jax.vjp(f, jnp.asarray(x), k_flax, jnp.asarray(bias))
    dx, dk, db = vjp(jnp.asarray(g))
    xt, wt, bt = _t(x, True), _t(w, True), _t(bias, True)
    got = _torch_grads(bridges.up_k2s2(xt, wt, bt), (xt, wt, bt), (g,))
    _close(got[0], dx, "dx")
    _close(got[1], np.asarray(dk)[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2),
           "dk")
    _close(got[2], db, "db")


def test_frozen_weights_and_inputs_skip_their_gradients(rng, monkeypatch):
    """What requires no gradient is not computed: a frozen conv calls no
    conv3_dk, an input without gradient no dx conv, and a frozen bridge
    asks its backward for dx only."""
    calls = {"dk": 0, "op": 0, "bridge": []}
    real_dk, real_op = conv3.conv3_dk, conv3.conv3_op
    real_down = bridges.down_k2s2_bwd

    def count_dk(*a, **k):
        calls["dk"] += 1
        return real_dk(*a, **k)

    def count_op(*a, **k):
        calls["op"] += 1
        return real_op(*a, **k)

    def count_down(x, gy, w, kw, pre, need_dx, need_dk):
        calls["bridge"].append((need_dx, need_dk))
        return real_down(x, gy, w, kw, pre, need_dx, need_dk)

    monkeypatch.setattr(conv3, "conv3_dk", count_dk)
    monkeypatch.setattr(conv3, "conv3_op", count_op)
    monkeypatch.setattr(bridges, "down_k2s2_bwd", count_down)
    x = _t(rng.normal(size=(1, 4, 4, 4, 2)))
    w = _t(rng.normal(size=(3, 2, 3, 3, 3)))
    bias = _t(rng.normal(size=(3,)))
    # frozen conv, input with gradient: forward + dx conv, no dk
    xg = x.clone().requires_grad_(True)
    conv3.conv3(xg, w, bias).sum().backward()
    assert (calls["op"], calls["dk"]) == (2, 0) and xg.grad is not None
    # trainable conv, input without gradient: forward + dk, no dx conv
    wg = w.clone().requires_grad_(True)
    conv3.conv3(x, wg, bias).sum().backward()
    assert (calls["op"], calls["dk"]) == (3, 1) and wg.grad is not None
    wd = _t(rng.normal(size=(2, 2, 2, 2, 2)))
    bd = _t(rng.normal(size=(2,)))
    xg = x.clone().requires_grad_(True)
    bridges.down_k2s2(xg, wd, bd).sum().backward()
    assert calls["bridge"] == [(True, False)]
