"""Card-only tests of the port's CUDA kernels (marker ``cuda``): each kernel
against its plain PyTorch version at ragged shapes the main path does not
reach (tiles cut by the volume edge, odd channel counts, 3 classes), the
launch counters, and the wrappers' input checks. They skip without a GPU.
This file imports torch only, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from vae_segmentation_tpu_torch.ops import bridges, conv3

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


@pytest.mark.parametrize("shape,cout,pre", [
    ((2, 6, 10, 4, 3), 5, True), ((1, 8, 8, 8, 16), 16, False)])
def test_down_kernel_matches_plain(gen, shape, cout, pre):
    b, cin = shape[0], shape[-1]
    x = _rnd(gen, *shape).bfloat16()
    w = _rnd(gen, cout, cin, 2, 2, 2, scale=(8 * cin) ** -0.5)
    bias = _rnd(gen, cout)
    aff = (_rnd(gen, b, cin).abs() + 0.5, _rnd(gen, b, cin, scale=0.3)) \
        if pre else None
    got = bridges.down_k2s2(x, w, bias, bridges.down_kernel_weight(w), aff)
    _close(got, bridges.down_k2s2_plain(x, w, bias, aff), 1e-2)


@pytest.mark.parametrize("shape,cout", [((2, 3, 5, 2, 3), 5),
                                        ((1, 4, 4, 4, 32), 32)])
def test_up_kernel_matches_plain(gen, shape, cout):
    cin = shape[-1]
    x = _rnd(gen, *shape).bfloat16()
    w = _rnd(gen, cin, cout, 2, 2, 2, scale=(8 * cout) ** -0.5)
    bias = _rnd(gen, cout)
    got = bridges.up_k2s2(x, w, bias, bridges.up_kernel_weight(w))
    _close(got, bridges.up_k2s2_plain(x, w, bias), 1e-2)


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
