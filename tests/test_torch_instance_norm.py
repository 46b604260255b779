"""The port's fused InstanceNorm(+ReLU) (vae_segmentation_tpu_torch/ops/
instance_norm.py) against the JAX package's Pallas function
(vae_segmentation_tpu/ops/pallas/instance_norm.py) in interpret mode on
the CPU, on the cases tests/test_pallas.py uses (C 8, 16, 128; spatial
(8, 8, 8) and (6, 10, 4), whose flat [S * C] tail is no multiple of the
TPU's 128 lanes) and on C 4 and 256. Inputs are drawn with numpy from a
seed. The models, a train step and the CLIs on the norm route are held in
tests/test_torch_norm_models.py and tests/test_torch_norm_step.py.

Tolerances (f32 unless stated): the forward within 2e-5 abs (test_pallas's
bound for the same function), the gradient within 1e-4 abs; the pieces
within 1e-5 of their largest element (the same sums in another order);
bf16 I/O within 1e-2 of the largest |y| (both sides compute f32 statistics
of the same bf16 values and round once to bf16, so they differ by the
roundings that the sums' order flips, one bf16 ulp, 2^-8 relative).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_segmentation_tpu.ops.pallas import instance_norm as jin
from vae_segmentation_tpu_torch import ops as port_ops
from vae_segmentation_tpu_torch.ops import instance_norm as pin
from vae_segmentation_tpu_torch.ops.kernels import build

torch.set_num_threads(2)

CASES = [(c, spatial) for c in (4, 8, 16, 128, 256)
         for spatial in ((8, 8, 8), (6, 10, 4))]


def _draw(seed, c, spatial, batch=2):
    """x (scaled and shifted like test_pallas.py's) and a cotangent."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(batch, *spatial, c)) * 3 + 1).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    return x, g


def _max_err(got, want):
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("c,spatial", CASES)
def test_instance_norm_act_and_gradient_match_jax(c, spatial, relu):
    """Forward within 2e-5 and the gradient of <y, g> within 1e-4 of
    ``jax.vjp`` of the Pallas function (interpret mode)."""
    x, g = _draw(c, c, spatial)
    want, vjp = jax.vjp(lambda v: jin.instance_norm_act(v, relu),
                        jnp.asarray(x))
    want_dx = vjp(jnp.asarray(g))[0]
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pin.instance_norm_act(xt, relu)
    got.backward(torch.from_numpy(g))
    assert got.dtype == torch.float32
    assert _max_err(got.detach(), want) <= 2e-5
    assert _max_err(xt.grad, want_dx) <= 1e-4


@pytest.mark.parametrize("c,spatial", [(16, (8, 8, 8)), (8, (6, 10, 4))])
def test_bf16_io_matches_jax(c, spatial):
    x, _ = _draw(1, c, spatial, batch=1)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jin.instance_norm_act(xb, True), np.float32)
    got = pin.instance_norm_act(
        torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    assert _max_err(got.float(), want) <= 1e-2 * np.abs(want).max()


def _lane_fold(lane, b, c, cycles):
    """JAX's per-lane [B, 2, L] sums -> [B, 2, C] (instance_norm.py:173)."""
    return np.asarray(jnp.asarray(lane).reshape(b, 2, cycles, c).sum(axis=2))


@pytest.mark.parametrize("c,spatial", [(8, (6, 10, 4)), (128, (8, 8, 8)),
                                       (4, (8, 8, 8))])
def test_pieces_match_their_jax_pieces(c, spatial):
    """norm_stats against ``_per_lane_stats`` (folded to channels),
    norm_apply against ``_apply_per_lane``, norm_bwd against ``_bwd``, each
    within 1e-5 of its largest element; norm_bwd_sums against its f64
    value (1e-5), and norm_bwd = norm_bwd_dx after norm_bwd_sums over the
    voxel count, for relu on and off."""
    x, g = _draw(7 + c, c, spatial)
    b, n = x.shape[0], math.prod(spatial)
    plan = jin._flatten_plan(x.shape)
    xf = jin._flat_view(jnp.asarray(x), *plan[:3])
    st_want = _lane_fold(jin._per_lane_stats(xf), b, c, plan[3])
    st = pin.norm_stats_plain(torch.from_numpy(x)).numpy()
    assert _max_err(st, st_want) <= 1e-5 * np.abs(st_want).max()
    s, t = pin.affine_from_stats(torch.from_numpy(st), n)
    for relu in (True, False):
        tile = (lambda v: jnp.tile(jnp.asarray(v.numpy()), (1, plan[3])))
        y_want = jin._unflatten(jin._apply_per_lane(
            xf, tile(s), tile(t), relu), x.shape)
        y = pin.norm_apply_plain(torch.from_numpy(x), s, t, relu)
        assert _max_err(y, y_want) <= 1e-5 * np.abs(np.asarray(y_want)).max()
        # the mean the fold took: JAX's shift -mean * rstd is then t
        mean = jnp.asarray((torch.from_numpy(st)[:, 0] / n).numpy())
        dx_want = jin._bwd(relu, (jnp.asarray(x), mean,
                                  jnp.asarray(s.numpy())), jnp.asarray(g))[0]
        xt, gt = torch.from_numpy(x), torch.from_numpy(g)
        dx = pin.norm_bwd(xt, gt, s, t, relu)
        assert _max_err(dx, dx_want) <= \
            1e-5 * np.abs(np.asarray(dx_want)).max()
        sums = pin.norm_bwd_sums_plain(xt, gt, s, t, relu)
        xhat = x.astype(np.float64) * s.double().numpy()[:, None, None, None] \
            + t.double().numpy()[:, None, None, None]
        gm = np.where(xhat > 0, g, 0.0) if relu else g.astype(np.float64)
        exact = np.stack([gm.sum(axis=(1, 2, 3)),
                          (gm * xhat).sum(axis=(1, 2, 3))], axis=1)
        assert _max_err(sums, exact) <= 1e-5 * np.abs(exact).max()
        torch.testing.assert_close(
            pin.norm_bwd_dx_plain(xt, gt, s, t, sums, relu), dx,
            rtol=0, atol=0)


def test_cpu_tensors_run_the_plain_versions_and_build_nothing():
    """On CPU tensors every wrapper is its plain version: no launch is
    counted and no kernel library is loaded."""
    x, g = _draw(3, 8, (4, 4, 4))
    xt, gt = torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16()
    port_ops.reset_launch_counts()
    st = pin.norm_stats(xt)
    s, t = pin.affine_from_stats(st, 64)
    y, s2, t2 = pin.norm_apply(xt, pin.norm_stats(xt, f64=True))
    torch.testing.assert_close(y, pin.norm_apply_plain(xt, s, t), rtol=0,
                               atol=0)
    assert torch.equal(s2, s) and torch.equal(t2, t)
    sums = pin.norm_bwd_sums(xt, gt, s, t)
    pin.norm_bwd_dx(xt, gt, s, t, sums)
    assert set(port_ops.launch_counts().values()) == {0}
    assert build.loaded() == []


# ---- the reduction's partition (instance_norm.cu's norm_reduce_kernel and
# norm_reduce_cluster_kernel under ``norm_reduce_plan``), emulated

H100_SMS = 132


def _terms(x, g, s, t, relu):
    """The two f32 terms a thread adds per element: (x, x^2) for norm_stats,
    (g_m, g_m * xhat) for norm_bwd_sums; [B, N * C] each."""
    b = x.shape[0]
    if g is None:
        x32 = x.float()
        return x32.reshape(b, -1), (x32 * x32).reshape(b, -1)
    gm, xhat = pin._masked(x, g, s, t, relu)
    return gm.reshape(b, -1), (gm * xhat).reshape(b, -1)


def emulate_norm_reduce(x, g, s, t, relu, plan):
    """The kernel's partition and order on f32 tensors: thread (block,
    tid) of a batch entry adds the items blk * threads + tid + k stride in
    order (an item: `lanes` channels of one voxel), a block adds its
    threads by a butterfly over the lanes of each channel group and the
    warps in order (or each channel's threads in order), and the blocks'
    [2, C] partials are added in f64: in rank order (one launch) or as
    parts_reduce adds them (two passes). Returns the [B, 2, C] f64 sums,
    how many times each item was read, and whether every thread's items
    held one channel group."""
    b, c = x.shape[0], x.shape[-1]
    lanes, groups, items = plan["lanes"], plan["groups"], plan["items"]
    T, nblk, stride = plan["threads"], plan["blocks"], plan["stride"]
    t0, t1 = (v.view(b, items, lanes) for v in _terms(x, g, s, t, relu))
    first = torch.arange(nblk * T)
    reads = torch.zeros(b, items, dtype=torch.int64)
    one_group = True
    out = torch.zeros(b, 2, c, dtype=torch.float64)
    for bb in range(b):
        acc = torch.zeros(nblk * T, 2, lanes)
        for k in range(-(-items // stride)):
            e = first + k * stride
            ok = e < items
            reads[bb] += torch.bincount(e[ok], minlength=items)
            one_group &= bool(((e[ok] % groups) == (first[ok] % groups))
                              .all())
            acc[ok, 0] += t0[bb, e[ok]]
            acc[ok, 1] += t1[bb, e[ok]]
        parts = torch.zeros(nblk, 2, c)
        for blk in range(nblk):
            a = acc[blk * T:(blk + 1) * T]
            g0 = blk * T % groups
            if g0 == 0 and groups <= 32 and groups & (groups - 1) == 0:
                lanes_ = a.view(T // 32, 32, 2, lanes)
                o = 16
                while o >= groups:
                    lanes_ = lanes_ + lanes_[:, torch.arange(32) ^ o]
                    o //= 2
                p = lanes_[0, :groups]
                for w in range(1, T // 32):
                    p = p + lanes_[w, :groups]
                parts[blk] = p.permute(1, 0, 2).reshape(2, c)
            else:
                p = torch.zeros(groups, 2, lanes)
                for k in range(T):
                    p[(g0 + k) % groups] += a[k]
                parts[blk] = p.permute(1, 0, 2).reshape(2, c)
        p64 = parts.double()
        if plan["one_launch"]:
            for r in range(nblk):
                out[bb] += p64[r]
        else:
            for w in range(32):
                out[bb] += p64[w::32].sum(dim=0) if w < nblk else 0.0
    return out, reads, one_group


@pytest.mark.parametrize("shape,one_launch,sms", [
    ((2, 6, 8, 5, 8), True, H100_SMS), ((2, 6, 8, 5, 8), False, 2),
    ((1, 8, 8, 8, 32), True, H100_SMS), ((1, 8, 8, 8, 32), False, 1),
    ((1, 4, 4, 4, 256), True, H100_SMS), ((2, 4, 4, 4, 256), False, 1),
    ((1, 8, 8, 8, 128), None, H100_SMS),   # the one-launch plan's largest
    ((2, 5, 9, 7, 24), None, 1),      # three channel groups: in order
    ((2, 5, 9, 7, 3), None, 1),       # C % 8 != 0: an element an item
    ((1, 16, 16, 16, 8), None, H100_SMS),
])
def test_norm_partition_reads_each_element_once(shape, one_launch, sms):
    """Both plans: every item read exactly once, each thread's channel group
    fixed, and the sums, in the kernel's partition and order, within f32 of
    their f64 value (1e-6 of the sum of the terms' magnitudes, a channel),
    for norm_stats and norm_bwd_sums."""
    x, g = _draw(5, shape[-1], shape[1:4], batch=shape[0])
    xt = torch.from_numpy(x).bfloat16()
    gt = torch.from_numpy(g).bfloat16()
    b, c = shape[0], shape[-1]
    n = math.prod(shape[1:4])
    plan = pin.norm_reduce_plan(b, n, c, True, sms, one_launch=one_launch)
    assert plan["stride"] % plan["groups"] == 0
    assert plan["one_launch"] == (plan["parts"] == 0)
    s, t = pin.affine_from_stats(pin.norm_stats_plain(xt), n)
    for args in ((None, None, None, False), (gt, s, t, True),
                 (gt, s, t, False)):
        got, reads, one_group = emulate_norm_reduce(xt, *args, plan)
        assert (reads == 1).all() and one_group
        t0, t1 = (v.double().view(b, n, c) for v in _terms(xt, *args))
        exact = torch.stack([t0.sum(dim=1), t1.sum(dim=1)], dim=1)
        mag = torch.stack([t0.abs().sum(dim=1), t1.abs().sum(dim=1)], dim=1)
        assert ((got - exact).abs() <= 1e-6 * mag).all()


def test_norm_partition_emulation_sees_a_stride_fault():
    """Planted partition faults the emulation must see: a stride (36
    items) that is no multiple of the channel groups (8) moves a thread's
    items across channels; a stride (28) shorter than the threads (32)
    reads items twice."""
    x, _ = _draw(5, 8, (4, 4, 4), batch=1)
    xt = torch.from_numpy(x).bfloat16()
    plan = dict(pin.norm_reduce_plan(1, 64, 8, True, 1, one_launch=False))
    plan.update(lanes=1, groups=8, items=512, threads=32, blocks=1,
                stride=36)
    _, reads, one_group = emulate_norm_reduce(xt, None, None, None, False,
                                              plan)
    assert not one_group
    plan.update(stride=28)
    _, reads, _ = emulate_norm_reduce(xt, None, None, None, False, plan)
    assert (reads > 1).any()


def test_norm_reduce_plans_of_the_main_path():
    """The norm route's shapes (C 8-256 at 128^3-4^3), batches 1, 2, 4:
    every norm has C % 8 == 0 (8 channels an item); the deep, small calls
    take one launch, the large two passes, whose grid stays within
    NORM_BLOCKS_A_SM blocks an SM and keeps the stride a multiple of the
    channel groups; one launch cannot take C % 8 != 0, and a forced plan
    that cannot run raises."""
    for b in (1, 2, 4):
        for e, c in ((128, 8), (64, 16), (32, 32), (16, 64), (8, 128),
                     (4, 256), (64, 8), (32, 16)):
            plan = pin.norm_reduce_plan(b, e ** 3, c, True, H100_SMS)
            assert plan["lanes"] == 8 and plan["groups"] == c // 8
            assert plan["one_launch"] == (
                e ** 3 * c // 8 <= pin.NORM_ONE_LAUNCH_ITEMS)
            assert plan["stride"] % plan["groups"] == 0
            if plan["one_launch"]:
                assert plan["blocks"] == pin.NORM_CLUSTER
            else:
                assert plan["parts"] * b <= pin.NORM_BLOCKS_A_SM * H100_SMS \
                    + b * plan["groups"]
    assert not pin.norm_reduce_plan(1, 64, 3, True, H100_SMS)["one_launch"]
    assert not pin.norm_reduce_plan(1, 64, 8, False, H100_SMS)["one_launch"]
    with pytest.raises(ValueError):
        pin.norm_reduce_plan(1, 64, 24, True, H100_SMS, one_launch=True)
    with pytest.raises(ValueError):
        pin.norm_reduce_plan(1, 0, 8, True, H100_SMS)


def test_chip_smoke_names_the_reduction_kernels():
    """chip_smoke.py's profile families name both plans' kernels of each
    mode, and its scan of the sources finds the cluster kernel."""
    import chip_smoke as cs

    names = cs.port_kernel_names()
    assert {"norm_reduce_kernel", "norm_reduce_cluster_kernel",
            "down_dx_kernel"} <= set(names)
    assert "__cluster_dims__" not in names
    ns = "void (anonymous namespace)::"
    assert cs._family(ns + "norm_reduce_kernel<0, true>(NormArgs)") \
        == "norm_stats"
    assert cs._family(ns + "norm_reduce_cluster_kernel<1>(NormArgs)") \
        == "norm_bwd_sums"
    assert cs._family(ns + "norm_elementwise_kernel<1>(NormArgs)") \
        == "norm_bwd_dx"
    assert cs._family(ns + "norm_elementwise_kernel<1, true>(NormArgs)") \
        == "norm_bwd_dx"
    assert cs._family(ns + "norm_elementwise_kernel<0, false>(NormArgs)") \
        == "norm_apply"
