"""The merged conv backward (VAESEG_MERGED_BWD=1: ``ops.conv3.conv3_bwd``,
dx, dk and db in one kernel launch, row 5 of the TPU kernel table) on the
CPU: its plain version against the pair it replaces, the K1 Function's
gradients with the switch set and unset against the JAX package's merged
backward (``stencil3.py::_run_bwd_grouped``, interpret mode) on the folded
reps of tests/test_stencil3.py, one vae_train step with and without the
switch, and ``source_main --method vae_train`` under the switch. Inputs
are drawn with numpy from a seed; f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_source_cli import _common, _scores
from vae_segmentation_tpu.ops import s2d
from vae_segmentation_tpu.ops.pallas.stencil3 import (
    conv3_stencil_folded, conv3_stencil_folded_pre)
from vae_segmentation_tpu_torch import train as pt
from vae_segmentation_tpu_torch.cli import source_main
from vae_segmentation_tpu_torch.data.synthetic import write_synthetic_dataset
from vae_segmentation_tpu_torch.models import ShapeVAE
from vae_segmentation_tpu_torch.ops import conv3 as pconv3

torch.set_num_threads(2)


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a, np.float32)).requires_grad_(grad)


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("shape,cout", [((2, 5, 6, 7, 3), 4),
                                        ((1, 4, 8, 8, 8), 16)])
def test_plain_merged_backward_is_the_pair(shape, cout, pre):
    """conv3_bwd_plain equals the dx conv with its post epilogue and
    conv3_dk_plain bit for bit (one function, so no tolerance)."""
    rng = np.random.default_rng(sum(shape) + cout)
    b, cin = shape[0], shape[-1]
    x, gy = _t(rng.normal(size=shape)), _t(rng.normal(size=(*shape[:-1],
                                                             cout)))
    w = _t(rng.normal(size=(cout, cin, 3, 3, 3)) * 0.2)
    aff = (_t(1 + 0.3 * rng.normal(size=(b, cin))),
           _t(0.3 * rng.normal(size=(b, cin)))) if pre else None
    dx, dk, db, dst = pconv3.conv3_bwd(x, gy, w, None, aff)
    w_t = w.flip(2, 3, 4).transpose(0, 1)
    if pre:
        want_dx, want_dst = pconv3.conv3_plain(gy, w_t, None,
                                               post=(x, *aff))
        assert torch.equal(dst, want_dst)
    else:
        want_dx = pconv3.conv3_plain(gy, w_t, None)
        assert dst is None
    want_dk, want_db = pconv3.conv3_dk_plain(x, gy, aff)
    for got, want in ((dx, want_dx), (dk, want_dk), (db, want_db)):
        assert torch.equal(got, want)


_JAX = {}


def _case(wpack, pre):
    """Inputs (tests/test_stencil3.py's shapes) and JAX's loss gradients
    through the folded conv with VAESEG_MERGED_BWD=1, unfolded to the
    logical tensors: (x, [s, t,] k, b)."""
    key = (wpack, pre)
    if key in _JAX:
        return _JAX[key]
    rng = np.random.default_rng(10 + 2 * wpack + pre)
    c_in, c_out = (8, 8) if wpack else (16, 16)
    pack = s2d.NB * (s2d.WPACK if wpack else 1)
    x = rng.normal(size=(1, 4, 8, 32, c_in)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 3, c_in, c_out)) * 0.3).astype(np.float32)
    b = rng.normal(size=(c_out,)).astype(np.float32)
    s = (1.0 + 0.3 * rng.normal(size=(1, c_in))).astype(np.float32)
    t = (0.3 * rng.normal(size=(1, c_in))).astype(np.float32)
    tgt = rng.normal(size=(1, 4, 8, 32, c_out)).astype(np.float32)

    def loss(x, s, t, k, b):
        ke = s2d.expand_kernel3_fast(k)
        if wpack:
            ke = s2d.expand_kernel_w(ke)
        xf = s2d.fold_rep(x, wpack)
        bf = jnp.tile(b, pack)
        if pre:
            y = conv3_stencil_folded_pre(xf, jnp.tile(s, (1, pack)),
                                         jnp.tile(t, (1, pack)), ke, bf,
                                         wpack)
        else:
            y = conv3_stencil_folded(xf, ke, bf, wpack)
        return jnp.mean(jnp.square(s2d.unfold_rep(y, c_out) - tgt))

    with pytest.MonkeyPatch.context() as m:
        m.setenv("VAESEG_MERGED_BWD", "1")   # read while JAX traces
        grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
            *(jnp.asarray(a) for a in (x, s, t, k, b)))
    _JAX[key] = ((x, s, t, k, b, tgt), [np.asarray(g) for g in grads])
    return _JAX[key]


@pytest.mark.parametrize("merged", ["0", "1"])
@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("wpack", [False, True])
def test_function_gradients_match_jax_merged_backward(monkeypatch, wpack,
                                                      pre, merged):
    """The port's K1 Function (logical rep) with VAESEG_MERGED_BWD set and
    unset: dx, ds, dt, dk, db equal JAX's merged-backward gradients through
    the fold within tests/test_stencil3.py's tolerances (3e-4; with the
    prologue 2e-4 relative, 2e-5 abs). The merged route launches the merged
    backward once and no dx conv or dk pass."""
    (x, s, t, k, b, tgt), want = _case(wpack, pre)
    monkeypatch.setenv("VAESEG_MERGED_BWD", merged)
    calls = {"bwd": 0, "dk": 0}
    real_bwd, real_dk = pconv3.conv3_bwd, pconv3.conv3_dk
    monkeypatch.setattr(pconv3, "conv3_bwd", lambda *a: (
        calls.__setitem__("bwd", calls["bwd"] + 1), real_bwd(*a))[1])
    monkeypatch.setattr(pconv3, "conv3_dk", lambda *a: (
        calls.__setitem__("dk", calls["dk"] + 1), real_dk(*a))[1])
    leaves = [_t(a, True) for a in (x, s, t, k, b)]
    xt, st, tt_, kt, bt = leaves
    w = kt.permute(4, 3, 0, 1, 2)
    y = pconv3.conv3(xt, w, bt, None, (st, tt_) if pre else None)
    torch.mean(torch.square(y - _t(tgt))).backward()
    assert calls == ({"bwd": 1, "dk": 0} if merged == "1"
                     else {"bwd": 0, "dk": 1})
    tol = dict(rtol=2e-4, atol=2e-5) if pre else dict(rtol=3e-4, atol=3e-4)
    for name, leaf, g in zip("xstkb", leaves, want):
        if name in "st" and not pre:
            assert leaf.grad is None
            continue
        np.testing.assert_allclose(leaf.grad.numpy(), g, err_msg=name, **tol)


def _vae_step(monkeypatch, merged):
    """One vae_train step at 32^3 from seeded weights and labels: the
    gradients and the merged / dk-only / conv3_op calls it made."""
    monkeypatch.setenv("VAESEG_MERGED_BWD", merged)
    counts = {"conv3_bwd": 0, "conv3_dk": 0, "conv3_op": 0}
    for name in counts:
        real = getattr(pconv3, name)
        monkeypatch.setattr(pconv3, name, (lambda n, r: lambda *a, **kw: (
            counts.__setitem__(n, counts[n] + 1), r(*a, **kw))[1])(
                name, real))
    vae = ShapeVAE(n_class=2, dim=16, fmaps=(4, 8, 8, 16, 16, 32),
                   bottleneck=32, dtype=torch.float32,
                   generator=torch.Generator().manual_seed(0))
    label = torch.from_numpy((np.random.default_rng(3).random(
        (2, 32, 32, 32)) > 0.7).astype(np.float32))
    opt = pt.optim.sgd(vae.parameters(), 0.0)
    pt.make_vae_train_step(2)(vae, opt, label,
                              torch.Generator().manual_seed(0))
    return {k: p.grad.clone() for k, p in vae.named_parameters()}, counts


def test_vae_train_step_is_the_same_with_the_merged_backward(monkeypatch):
    """Every VAE gradient of one vae_train step is bit-equal with and
    without the switch (on the CPU both run the same plain versions). With
    it the 31 convs that need dx and dk take the merged backward, the entry
    conv (its one-hot input needs no gradient) conv3_dk alone, and no dx
    conv runs: 32 conv3_op calls, the forwards."""
    with monkeypatch.context() as m:
        base, base_counts = _vae_step(m, "0")
    with monkeypatch.context() as m:
        got, counts = _vae_step(m, "1")
    assert base_counts == {"conv3_bwd": 0, "conv3_dk": 32, "conv3_op": 63}
    assert counts == {"conv3_bwd": 31, "conv3_dk": 1, "conv3_op": 32}
    assert sorted(got) == sorted(base)
    for k, g in got.items():
        assert torch.equal(g, base[k]), k


def test_source_cli_vae_train_with_the_merged_backward(tmp_path,
                                                       monkeypatch, capsys):
    """``source_main --method vae_train`` under VAESEG_MERGED_BWD=1 trains
    two outer epochs at 32^3 on the CPU through the merged backward and
    writes its scores and checkpoints."""
    write_synthetic_dataset(str(tmp_path / "data"), n_train=3, n_val=2,
                            size=40, seed=0)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("VAESEG_MERGED_BWD", "1")
    calls = []
    real = pconv3.conv3_bwd
    monkeypatch.setattr(pconv3, "conv3_bwd",
                        lambda *a: (calls.append(1), real(*a))[1])
    best = source_main.main(["vae", "--method", "vae_train",
                             *_common(tmp_path)])
    out = capsys.readouterr().out
    assert "[  1,   1] loss: " in out and 0.0 <= best <= 1.0
    assert len(calls) == 2 * 31      # one step an outer epoch
    for epoch in (0, 1):
        assert all(0.0 <= v <= 1.0 for v in _scores("vae", epoch).values())
    for name in ("best_model.ckpt", "model_epoch1.ckpt", "model_epoch2.ckpt"):
        assert (tmp_path / "3dmodel" / "vae" / name).exists(), name
