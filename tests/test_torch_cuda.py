"""Card-only tests of the port's CUDA kernels (marker ``cuda``): each kernel
against its plain PyTorch version at ragged shapes the main path does not
reach (tiles cut by the volume edge, odd channel counts, 3 classes), the
launch counters, the wrappers' input checks, and the gradients of each
``torch.autograd.Function`` (backward kernels) against autograd through the
plain forward. They skip without a GPU.
This file imports torch only, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

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
    ((1, 8, 8, 16, 16), 2, True),     # a head: Cout 2
    ((2, 4, 4, 4, 24), 48, False),    # a deep stage
])
def test_conv3_backward_kernels_match_plain(gen, shape, cout, pre):
    """conv3_dk (dk, db) and K1's post epilogue (dx, ds, dt) against their
    plain versions: dx bf16 within 1e-2 of max|dx|, f32 sums within 1e-3
    of their largest element (atomics reorder them)."""
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
    (True, (1, 4, 4, 4, 32), 32, False)])
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
    (f64 across blocks against the plain f32 sums), norm_apply and
    norm_bwd_dx within 1e-2 of max|y| (bf16), relu on and off; one launch
    each."""
    b, c = shape[0], shape[-1]
    x = (_rnd(gen, *shape) * 3 + 1).bfloat16()
    g = _rnd(gen, *shape).bfloat16()
    n = x.numel() // (b * c)
    before = {k: getattr(instance_norm, k).launches for k in (
        "norm_stats", "norm_apply", "norm_bwd_sums", "norm_bwd_dx")}
    st = instance_norm.norm_stats(x)
    st_plain = instance_norm.norm_stats_plain(x)
    for r in range(2):
        assert _rel(st[:, r], st_plain[:, r]) <= 1e-4, r
    s, t = instance_norm.affine_from_stats(st, n)
    for relu in (True, False):
        _close(instance_norm.norm_apply(x, s, t, relu),
               instance_norm.norm_apply_plain(x, s, t, relu), 1e-2)
        sums = instance_norm.norm_bwd_sums(x, g, s, t, relu)
        want = instance_norm.norm_bwd_sums_plain(x, g, s, t, relu)
        for r in range(2):
            assert _rel(sums[:, r], want[:, r]) <= 1e-4, r
        m = want / n
        _close(instance_norm.norm_bwd_dx(x, g, s, t, m, relu),
               instance_norm.norm_bwd_dx_plain(x, g, s, t, m, relu), 1e-2)
    torch.cuda.synchronize()
    assert {k: getattr(instance_norm, k).launches - v
            for k, v in before.items()} == {
        "norm_stats": 1, "norm_apply": 2, "norm_bwd_sums": 2,
        "norm_bwd_dx": 2}


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


@pytest.mark.parametrize("shape,cout,pre", [
    ((2, 5, 9, 19, 3), 5, True),      # ragged tiles, odd channels
    ((1, 3, 17, 7, 1), 8, False),
    ((1, 8, 8, 16, 16), 2, True),     # a head: Cout 2
    ((2, 4, 4, 4, 24), 48, False),
    ((1, 4, 4, 4, 256), 256, True),   # the deepest stage: 2 channels a block
])
def test_conv3_merged_backward_matches_plain(gen, shape, cout, pre):
    """conv3_bwd against its plain version (the pair): dx within 1e-2 of
    max|dx| (bf16), dk, db, ds, dt within 1e-3 of their largest element;
    one launch."""
    b, cin = shape[0], shape[-1]
    x = _rnd(gen, *shape).bfloat16()
    gy = _rnd(gen, *shape[:-1], cout).bfloat16()
    w = _rnd(gen, cout, cin, 3, 3, 3, scale=(27 * cin) ** -0.5)
    aff = (_rnd(gen, b, cin).abs() + 0.5, _rnd(gen, b, cin, scale=0.3)) \
        if pre else None
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
    with pytest.raises(ValueError):  # an affine of the wrong shape
        instance_norm.norm_apply(x.bfloat16(), s[:, :4], t[:, :4])
    w = _rnd(gen, 8, 8, 3, 3, 3)
    with pytest.raises(ValueError):  # no kernel-layout weight
        conv3.conv3_bwd(x.bfloat16(), x.bfloat16(), w)
    with pytest.raises(ValueError):  # f32 cotangent
        conv3.conv3_bwd(x.bfloat16(), x, w, conv3.kernel_weight(w))
