"""The port's kernel modules (vae_segmentation_tpu_torch/ops/conv3.py and
ops/bridges.py) against the JAX package's Pallas kernels run in interpret
mode on the CPU. On a CPU tensor each wrapper runs its plain PyTorch
version, which is what these tests hold to the TPU kernels: same inputs
(numpy, seeded), f32, max abs error <= 1e-5 * max|y|. The folded-rep
kernels are compared through the s2d fold/unfold, as tests/test_stencil3.py
and tests/test_pallas.py do."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vae_segmentation_tpu.ops import s2d
from vae_segmentation_tpu.ops.pallas.stencil3 import (
    conv3_stencil, conv3_stencil_folded_softmax,
    conv3_stencil_folded_softmax_pre, conv3_stencil_pre)
from vae_segmentation_tpu.ops.pallas.upbridge import (
    down_bridge_w, down_bridge_w_pre, up_bridge_w)
from vae_segmentation_tpu_torch import ops as port_ops
from vae_segmentation_tpu_torch.ops import bridges, conv3, reparam
from vae_segmentation_tpu_torch.ops.kernels import build

torch.set_num_threads(2)

REL = 1e-5  # f32: max abs error <= REL * max|y|


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), (what, err, np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _affine(rng, b, c):
    return (rng.normal(size=(b, c)) * 0.5 + 1.0).astype(np.float32), \
        (rng.normal(size=(b, c)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("shape,cout,pre", [
    ((2, 4, 8, 8, 8), 16, False),
    ((1, 5, 6, 16, 1), 8, False),     # the 1-channel entry conv (K = 27)
    ((2, 4, 8, 8, 16), 8, True),      # intra-DoubleConv prologue
])
def test_conv3_plain_vs_stencil(rng, shape, cout, pre):
    """K1 plain (with stats) == conv3_stencil / conv3_stencil_pre."""
    b, cin = shape[0], shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(cout, cin, 3, 3, 3)) * 0.2).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    k = jnp.asarray(w.transpose(2, 3, 4, 1, 0))
    if pre:
        s, t = _affine(rng, b, cin)
        want, want_st = conv3_stencil_pre(jnp.asarray(x), jnp.asarray(s),
                                          jnp.asarray(t), k,
                                          jnp.asarray(bias), None, True)
        pre_t = (_t(s), _t(t))
    else:
        want, want_st = conv3_stencil(jnp.asarray(x), k, jnp.asarray(bias),
                                      False, True)
        pre_t = None
    got, got_st = conv3.conv3(_t(x), _t(w), _t(bias), pre=pre_t, stats=True)
    _close(got, want, "y")
    _close(got_st, want_st, "stats")


@pytest.mark.parametrize("pre", [False, True])
def test_conv3_plain_softmax_vs_folded_softmax(rng, pre):
    """K1 plain softmax head == conv3_stencil_folded_softmax[_pre] on the
    W-packed folded rep, unfolded."""
    nc, cin, b = 2, 4, 1
    x = rng.normal(size=(b, 8, 8, 32, cin)).astype(np.float32)
    w = (rng.normal(size=(nc, cin, 3, 3, 3)) * 0.3).astype(np.float32)
    bias = rng.normal(size=(nc,)).astype(np.float32)
    ke = s2d.expand_kernel_w(s2d.expand_kernel3_fast(
        jnp.asarray(w.transpose(2, 3, 4, 1, 0))))
    lanes = s2d.NB * s2d.WPACK
    bias_f = jnp.tile(jnp.asarray(bias), lanes)
    xf = s2d.fold_rep(jnp.asarray(x), True)
    if pre:
        s, t = _affine(rng, b, cin)
        yf = conv3_stencil_folded_softmax_pre(
            xf, jnp.tile(jnp.asarray(s), lanes), jnp.tile(jnp.asarray(t), lanes),
            ke, bias_f, True, None, nc)
        pre_t = (_t(s), _t(t))
    else:
        yf = conv3_stencil_folded_softmax(xf, ke, bias_f, True, nc)
        pre_t = None
    want = s2d.unfold_rep(yf, nc)
    got = conv3.conv3(_t(x), _t(w), _t(bias), pre=pre_t, softmax=True)
    _close(got, want, "probs")


@pytest.mark.parametrize("pre", [False, True])
def test_down_plain_vs_down_bridge(rng, pre):
    """K2 plain == down_bridge_w[_pre] (W-packed folded fine in, plain folded
    coarse out), unfolded."""
    b, c, o = 2, 4, 4
    x = rng.normal(size=(b, 16, 16, 16, c)).astype(np.float32)
    w = rng.normal(size=(o, c, 2, 2, 2)).astype(np.float32)
    bias = rng.normal(size=(o,)).astype(np.float32)
    xf = s2d.fold_rep(jnp.asarray(x), True)
    k = jnp.asarray(w.transpose(2, 3, 4, 1, 0))
    if pre:
        s, t = _affine(rng, b, c)
        lanes = s2d.NB * s2d.WPACK
        yf = down_bridge_w_pre(xf, jnp.tile(jnp.asarray(s), lanes),
                               jnp.tile(jnp.asarray(t), lanes), k,
                               jnp.asarray(bias))
        pre_t = (_t(s), _t(t))
    else:
        yf = down_bridge_w(xf, k, jnp.asarray(bias))
        pre_t = None
    want = s2d.unfold(yf)
    got = bridges.down_k2s2(_t(x), _t(w), _t(bias), pre=pre_t)
    _close(got, want, "y")


def test_up_plain_vs_up_bridge(rng):
    """K3 plain (torch ConvTranspose3d semantics) == up_bridge_w (plain
    folded coarse in, W-packed folded fine out), unfolded; the weight
    crosses with torch_compat's tap flip."""
    b, c, o = 2, 4, 4
    x = rng.normal(size=(b, 8, 8, 16, c)).astype(np.float32)
    w = rng.normal(size=(c, o, 2, 2, 2)).astype(np.float32)
    bias = rng.normal(size=(o,)).astype(np.float32)
    k_flax = jnp.asarray(np.ascontiguousarray(
        w.transpose(2, 3, 4, 0, 1)[::-1, ::-1, ::-1]))
    k1 = s2d.expand_up_kernel(k_flax).reshape(c, s2d.NB * o)
    yf = up_bridge_w(s2d.fold(jnp.asarray(x)), k1,
                     jnp.tile(jnp.asarray(bias), s2d.NB * s2d.WPACK))
    want = s2d.unfold_rep(yf, o)
    got = bridges.up_k2s2(_t(x), _t(w), _t(bias))
    _close(got, want, "y")


def test_kernel_layouts_match_plain_semantics(rng):
    """The kernel-layout weights index the taps the plain versions use:
    an explicit tap sum with each layout equals the plain op."""
    x = _t(rng.normal(size=(1, 4, 4, 4, 3)))
    w3 = _t(rng.normal(size=(5, 3, 3, 3, 3)))
    b = torch.zeros(5)
    kw = conv3.kernel_weight(w3).float()
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    ref = torch.zeros(1, 4, 4, 4, 5)
    for tap in range(27):
        kd, kh, kw_ = tap // 9, (tap // 3) % 3, tap % 3
        ref += xp[:, kd:kd + 4, kh:kh + 4, kw_:kw_ + 4] @ kw[tap]
    plain = conv3.conv3_plain(x, w3.bfloat16().float(), b)
    assert torch.allclose(plain, ref, atol=1e-4)

    wd = _t(rng.normal(size=(5, 3, 2, 2, 2)))
    kd2 = bridges.down_kernel_weight(wd).float()
    ref = sum(x[:, a >> 2::2, (a >> 1) & 1::2, a & 1::2] @ kd2[a]
              for a in range(8))
    assert torch.allclose(bridges.down_k2s2_plain(x, wd.bfloat16().float(), b),
                          ref, atol=1e-4)

    wu = _t(rng.normal(size=(3, 5, 2, 2, 2)))
    ku = bridges.up_kernel_weight(wu).float()
    up = bridges.up_k2s2_plain(x, wu.bfloat16().float(), b)
    for a in range(8):
        sl = up[:, a >> 2::2, (a >> 1) & 1::2, a & 1::2]
        assert torch.allclose(sl, x @ ku[a], atol=1e-4)


def test_cpu_tensors_use_plain_versions_and_build_nothing(rng):
    """A CPU tensor runs the plain version: no launch is counted and no
    kernel library is built or loaded."""
    port_ops.reset_launch_counts()
    x = _t(rng.normal(size=(1, 4, 4, 4, 2))).bfloat16()
    w = _t(rng.normal(size=(2, 2, 3, 3, 3)))
    y, st = conv3.conv3(x, w, torch.zeros(2), stats=True)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    bridges.down_k2s2(x, _t(rng.normal(size=(2, 2, 2, 2, 2))), torch.zeros(2))
    bridges.up_k2s2(x, _t(rng.normal(size=(2, 2, 2, 2, 2))), torch.zeros(2))
    reparam.reparam_kl(torch.zeros(2, 8), torch.ones(2, 8), 0.35,
                       torch.tensor([3], dtype=torch.int32))
    conv3.conv3_bwd(x, y, w)
    counts = port_ops.launch_counts()
    assert sorted(counts) == sorted([
        "conv3", "down_k2s2", "up_k2s2", "conv3_dk", "down_k2s2_bwd",
        "up_k2s2_bwd", "softmax_vjp", "dice_sums", "reparam_kl", "conv3_bwd",
        "norm_stats", "norm_apply", "norm_bwd_sums", "norm_bwd_dx",
        "dice_sums_vjp", "reparam_kl_vjp"])
    assert set(counts.values()) == {0}
    assert build.loaded() == []
    with pytest.raises(ValueError):
        conv3.conv3(x, w, torch.zeros(2), stats=True, softmax=True)
