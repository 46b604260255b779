"""The valid D-plane range (``dlim``) of K1, ``conv3_dk`` and ``conv3_bwd``
(rows 1-5 of the TPU kernel table) on the CPU.

The plain versions with ``dlim`` against the JAX package's Pallas kernels
with the same operand, run in interpret mode: ``stencil3.py::_run_conv``
(the prologue + stats forward, and the dx conv with its ``post``
epilogue), ``_run_dk`` (dk under the prologue) and ``_run_bwd_grouped``
(the merged backward, reached through ``conv3_stencil_folded_pre``'s VJP
under VAESEG_MERGED_BWD=1 on the folded rep, where a folded plane is two
logical ones). Then the slab property that makes the range worth having:
the D-slabs of a volume, each with its neighbours' boundary planes as halo
(zeros past the volume's edge) and its range, give the owned planes, the
summed stats (less the halo planes' sums) and the summed (ds, dt), dk, db
of the unsharded call; a range off by one plane fails. Inputs from numpy
seeds; f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_segmentation_tpu.ops import s2d
from vae_segmentation_tpu.ops.pallas import stencil3
from vae_segmentation_tpu_torch.ops import conv3 as pconv3

torch.set_num_threads(2)

REL = 1e-5  # f32: max abs error <= REL * max|want| (tests/test_torch_kernels_bwd)


def _close(got, want, what="", rel=REL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (what, err)


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a, np.float32)).requires_grad_(grad)


def _inputs(shape, cout, seed):
    """x, gy, the JAX kernel k [3,3,3,Cin,Cout], bias and a prologue whose
    shift is mostly positive, so relu(t) != 0 where x is 0 (the fault the
    range exists for)."""
    rng = np.random.default_rng(seed)
    b, cin = shape[0], shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    gy = rng.normal(size=(*shape[:-1], cout)).astype(np.float32)
    k = (0.2 * rng.normal(size=(3, 3, 3, cin, cout))).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    s = (1.0 + 0.3 * rng.normal(size=(b, cin))).astype(np.float32)
    t = (0.5 + 0.3 * rng.normal(size=(b, cin))).astype(np.float32)
    return x, gy, k, bias, s, t


def _w(k):
    """JAX [3,3,3,I,O] -> torch [O, I, 3, 3, 3]."""
    return _t(k).permute(4, 3, 0, 1, 2)


# SP2 / SP4 slabs of 8^3-16^3 stages: [B, D/n + 2, H, W, C], W % 8 == 0 for
# the Pallas kernels; ranges of the first (lo 1), last (hi D2 - 2) and an
# interior slab (every plane)
RANGES = ["first", "last", "interior"]
SLABS = [((2, 6, 8, 8, 8), 8, "first"), ((2, 6, 8, 8, 8), 8, "last"),
         ((1, 10, 8, 16, 8), 16, "interior"), ((1, 6, 16, 8, 16), 8, "first")]


def _range(kind, d2):
    return {"first": (1, d2 - 1), "last": (0, d2 - 2),
            "interior": (0, d2 - 1)}[kind]


@pytest.mark.parametrize("shape,cout,kind", SLABS)
def test_forward_with_prologue_and_stats_matches_jax(shape, cout, kind):
    """conv3_plain(pre, stats, dlim) == stencil3._run_conv(pre, dlim,
    stats) in interpret mode: y and the slab's (sum, sumsq)."""
    x, _, k, bias, s, t = _inputs(shape, cout, sum(shape) + cout)
    dlim = _range(kind, shape[1])
    want_y, want_st = stencil3._run_conv(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), False,
        pre=(jnp.asarray(s), jnp.asarray(t)),
        dlim=jnp.asarray(dlim, jnp.int32), stats=True)
    y, st = pconv3.conv3_plain(_t(x), _w(k), _t(bias), pre=(_t(s), _t(t)),
                               stats=True, dlim=dlim)
    _close(y, want_y, "y")
    _close(st, want_st, "stats")


@pytest.mark.parametrize("shape,cout,kind", SLABS)
def test_dx_post_and_dk_match_jax(shape, cout, kind):
    """The dx conv's post sums and dk under the prologue with dlim:
    conv3_plain(post, dlim) == _run_conv(post, dlim) and conv3_dk_plain(
    pre, dlim) == _run_dk(pre, dlim)."""
    x, gy, k, _, s, t = _inputs(shape, cout, 7 * sum(shape) + cout)
    dlim = _range(kind, shape[1])
    jd = jnp.asarray(dlim, jnp.int32)
    k_t = np.ascontiguousarray(np.flip(k, (0, 1, 2)).transpose(0, 1, 2, 4, 3))
    want_dx, want_dst = stencil3._run_conv(
        jnp.asarray(gy), jnp.asarray(k_t),
        jnp.zeros((shape[-1],), jnp.float32), False,
        post=(jnp.asarray(x), jnp.asarray(s), jnp.asarray(t)), dlim=jd)
    dx, dst = pconv3.conv3_plain(_t(gy), _w(k_t), None,
                                 post=(_t(x), _t(s), _t(t)), dlim=dlim)
    _close(dx, want_dx, "dx")
    _close(dst, want_dst, "ds, dt")
    want_dk, want_db = stencil3._run_dk(
        jnp.asarray(x), jnp.asarray(gy),
        pre=(jnp.asarray(s), jnp.asarray(t)), dlim=jd)
    dk, db = pconv3.conv3_dk_plain(_t(x), _t(gy), (_t(s), _t(t)), dlim)
    _close(dk, np.asarray(want_dk).reshape(27, shape[-1], cout), "dk")
    _close(db, want_db, "db")


_FOLDED = {}


def _folded_grads(kind, wpack):
    """JAX's gradients through conv3_stencil_folded_pre with a folded-plane
    dlim under VAESEG_MERGED_BWD=1 (``_run_bwd_grouped``), unfolded to the
    logical tensors (x, s, t, k, b); the folded shape of
    tests/test_torch_merged_bwd.py, D 8 logical = 4 folded."""
    key = (kind, wpack)
    if key in _FOLDED:
        return _FOLDED[key]
    rng = np.random.default_rng(40 + 3 * wpack + RANGES.index(kind))
    c_in, c_out = (8, 8) if wpack else (16, 16)
    pack = s2d.NB * (s2d.WPACK if wpack else 1)
    x = rng.normal(size=(1, 8, 8, 32, c_in)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 3, c_in, c_out)) * 0.3).astype(np.float32)
    b = rng.normal(size=(c_out,)).astype(np.float32)
    s = (1.0 + 0.3 * rng.normal(size=(1, c_in))).astype(np.float32)
    t = (0.5 + 0.3 * rng.normal(size=(1, c_in))).astype(np.float32)
    tgt = rng.normal(size=(1, 8, 8, 32, c_out)).astype(np.float32)
    fl = _range(kind, 4)

    def loss(x, s, t, k, b):
        ke = s2d.expand_kernel3_fast(k)
        if wpack:
            ke = s2d.expand_kernel_w(ke)
        y = stencil3.conv3_stencil_folded_pre(
            s2d.fold_rep(x, wpack), jnp.tile(s, (1, pack)),
            jnp.tile(t, (1, pack)), ke, jnp.tile(b, pack), wpack,
            jnp.asarray(fl, jnp.int32))
        return jnp.mean(jnp.square(s2d.unfold_rep(y, c_out) - tgt))

    import jax
    with pytest.MonkeyPatch.context() as m:
        m.setenv("VAESEG_MERGED_BWD", "1")   # read while JAX traces
        grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
            *(jnp.asarray(a) for a in (x, s, t, k, b)))
    # a folded plane p holds logical planes 2p and 2p + 1
    _FOLDED[key] = ((x, s, t, k, b, tgt), (2 * fl[0], 2 * fl[1] + 1),
                    [np.asarray(g) for g in grads])
    return _FOLDED[key]


@pytest.mark.parametrize("wpack,kind", [(False, "first"), (True, "last"),
                                        (False, "interior")])
def test_merged_backward_matches_jax(monkeypatch, wpack, kind):
    """The K1 Function with dlim under VAESEG_MERGED_BWD=1 (one
    conv3_bwd_plain call with the range) against JAX's merged backward
    with the folded range: dx, ds, dt, dk, db within
    tests/test_torch_merged_bwd.py's prologue tolerance (2e-4 relative,
    2e-5 absolute)."""
    (x, s, t, k, b, tgt), dlim, want = _folded_grads(kind, wpack)
    monkeypatch.setenv("VAESEG_MERGED_BWD", "1")
    calls = []
    real = pconv3.conv3_bwd
    monkeypatch.setattr(pconv3, "conv3_bwd",
                        lambda *a: (calls.append(a[-1]), real(*a))[1])
    leaves = [_t(a, True) for a in (x, s, t, k, b)]
    xt, st, tt, kt, bt = leaves
    y = pconv3.conv3(xt, kt.permute(4, 3, 0, 1, 2), bt, None, (st, tt),
                     dlim=dlim)
    torch.mean(torch.square(y - _t(tgt))).backward()
    assert calls == [dlim]
    for name, leaf, g in zip("xstkb", leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), g, rtol=2e-4,
                                   atol=2e-5, err_msg=name)


def _slabs(v, n):
    """The n D-slabs of v [B, D, ...], each with its neighbours' boundary
    planes (zeros past the edge): what the halo exchange hands a rank."""
    d = v.shape[1] // n
    z = torch.zeros_like(v[:, :1])
    out = []
    for i in range(n):
        lo = v[:, i * d - 1:i * d] if i else z
        hi = v[:, (i + 1) * d:(i + 1) * d + 1] if i < n - 1 else z
        out.append(torch.cat([lo, v[:, i * d:(i + 1) * d], hi], dim=1))
    return out


def _slab_range(i, n, d2, shift=0):
    return 1 + shift if i == 0 else 0, d2 - 2 if i == n - 1 else d2 - 1


def _sharded(x, gy, w, bias, s, t, n, shift=0):
    """The slab run of one prologue + stats conv and its backward pieces,
    put together as a rank of an n-way 'spatial' axis would: y's owned
    planes, the stats less the halo planes' sums, summed; dx's owned
    planes plus the halo gradients the neighbours send back; ds, dt, dk,
    db summed. `shift` moves the first slab's lo by that many planes (a
    planted off-by-one)."""
    xs, gs = _slabs(x, n), _slabs(gy, n)
    d = x.shape[1] // n
    w_t = w.flip(2, 3, 4).transpose(0, 1)
    ys, st, dst, dk, db = [], 0, 0, 0, 0
    dx = torch.zeros_like(x)
    for i, (xi, gi) in enumerate(zip(xs, gs)):
        d2 = xi.shape[1]
        dlim = _slab_range(i, n, d2, shift)
        y, sti = pconv3.conv3_plain(xi, w, bias, pre=(s, t), stats=True,
                                    dlim=dlim)
        halo = torch.cat([y[:, :1], y[:, -1:]], dim=1).float()
        st = st + sti - torch.stack([halo.sum(dim=(1, 2, 3)),
                                     (halo * halo).sum(dim=(1, 2, 3))],
                                    dim=1)
        ys.append(y[:, 1:-1])
        # the backward sees the cotangent of the owned planes only
        gz = gi.clone()
        gz[:, 0] = 0
        gz[:, -1] = 0
        dxi, dsti = pconv3.conv3_plain(gz, w_t, None, post=(xi, s, t),
                                       dlim=dlim)
        dst = dst + dsti
        dx[:, i * d:(i + 1) * d] += dxi[:, 1:-1]
        if i:
            dx[:, i * d - 1] += dxi[:, 0]
        if i < n - 1:
            dx[:, (i + 1) * d] += dxi[:, -1]
        dki, dbi = pconv3.conv3_dk_plain(xi, gz, (s, t), dlim)
        dk, db = dk + dki, db + dbi
    return torch.cat(ys, dim=1), st, dx, dst, dk, db


@pytest.mark.parametrize("n", [2, 4])
def test_slabs_equal_the_unsharded_call(n):
    """Owned planes, summed corrected stats and summed gradient pieces of
    the slabs equal the unsharded conv's (summation order only: REL of the
    largest value)."""
    x, gy, k, bias, s, t = _inputs((2, 8, 8, 8, 8), 8, 100 + n)
    x, gy, w, bias, s, t = _t(x), _t(gy), _w(k), _t(bias), _t(s), _t(t)
    got = _sharded(x, gy, w, bias, s, t, n)
    y, st = pconv3.conv3_plain(x, w, bias, pre=(s, t), stats=True)
    dx, dst = pconv3.conv3_plain(gy, w.flip(2, 3, 4).transpose(0, 1), None,
                                 post=(x, s, t))
    dk, db = pconv3.conv3_dk_plain(x, gy, (s, t))
    for name, g, want in zip(("y", "stats", "dx", "ds dt", "dk", "db"),
                             got, (y, st, dx, dst, dk, db)):
        _close(g, want, name)


def test_an_off_by_one_range_fails():
    """The same slab run with the first slab's lo one plane low (its zero
    halo taken for a plane): relu(t) != 0 leaks into y's edge plane, the
    stats, ds / dt and dk."""
    x, gy, k, bias, s, t = _inputs((2, 8, 8, 8, 8), 8, 102)
    x, gy, w, bias, s, t = _t(x), _t(gy), _w(k), _t(bias), _t(s), _t(t)
    got = _sharded(x, gy, w, bias, s, t, 2, shift=-1)
    y, st = pconv3.conv3_plain(x, w, bias, pre=(s, t), stats=True)
    dx, dst = pconv3.conv3_plain(gy, w.flip(2, 3, 4).transpose(0, 1), None,
                                 post=(x, s, t))
    dk, _ = pconv3.conv3_dk_plain(x, gy, (s, t))
    for name, g, want in zip(("y", "stats", "ds dt", "dk"),
                             (got[0], got[1], got[3], got[4]),
                             (y, st, dst, dk)):
        with pytest.raises(AssertionError):
            _close(g, want, name)


def test_the_range_is_checked():
    """A range outside the call's planes raises, in every plain version."""
    x = torch.zeros(1, 4, 2, 2, 3)
    w = torch.zeros(3, 3, 3, 3, 3)
    aff = (torch.ones(1, 3), torch.zeros(1, 3))
    for dlim in ((-1, 2), (0, 4), (3, 2)):
        with pytest.raises(ValueError):
            pconv3.conv3_plain(x, w, None, pre=aff, dlim=dlim)
        with pytest.raises(ValueError):
            pconv3.conv3_dk_plain(x, x, aff, dlim)
        with pytest.raises(ValueError):
            pconv3.conv3(x, w, torch.zeros(3), pre=aff, dlim=dlim)
