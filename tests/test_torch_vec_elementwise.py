"""The port's two 16-byte elementwise passes on the CPU: the InstanceNorm's
``norm_apply`` with its fold and ``norm_bwd_dx``
(vae_segmentation_tpu_torch/ops/instance_norm.py, kernel
csrc/instance_norm.cu::norm_elementwise_kernel) and the softmax epilogue's
cotangent ``softmax_vjp`` (ops/losses.py, csrc/losses.cu::
softmax_vjp_c2_kernel). The kernels run only on the card; here:

- the row-16 plain version, the fold and the apply from the f64 sums,
  against the JAX package's ``_fold_lane_stats`` and ``_apply_per_lane``
  (vae_segmentation_tpu/ops/pallas/instance_norm.py) in interpret mode: s
  and t within 1e-6 of their largest element (one f32 rounding apart:
  XLA's and torch's rsqrt and division on the CPU), y within 1e-5 of its
  largest element (test_torch_instance_norm.py's bound for the apply);
- an exact emulation of each kernel's partition under its plan
  (``norm_apply_plan``, ``softmax_vjp_plan``): thread i of a batch entry
  takes the items i + k stride; an item is 8 channels of a voxel (the norm)
  or 4 voxels of two classes (the softmax), else one element or voxel, and
  the softmax voxels from 4 items on take the element path. Every element
  is written once, each norm thread's channel group is fixed, and the
  emulated result, each thread using its own registers' (s, t), equals the
  plain version bit for bit (the kernels round as the plain versions do);
  a planted stride fault fails each emulation.

Inputs are drawn with numpy from a seed.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vae_segmentation_tpu.ops.pallas import instance_norm as jin
from vae_segmentation_tpu_torch.ops import instance_norm as pin
from vae_segmentation_tpu_torch.ops import losses

torch.set_num_threads(2)

H100_SMS = 132


def _draw(seed, shape, dtype=torch.bfloat16):
    """x (scaled and shifted like test_pallas.py's), a cotangent g."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to(dtype), torch.from_numpy(g).to(dtype)


def _sums64(x):
    """[B, 2, C] f64 (sum, sumsq) of x: what norm_stats' kernel hands
    norm_apply."""
    x64 = x.double()
    return torch.stack([x64.sum(dim=(1, 2, 3)),
                        (x64 * x64).sum(dim=(1, 2, 3))], dim=1)


# ---- the row-16 plain version against the JAX package's


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("c,spatial", [(3, (6, 10, 4)), (8, (6, 10, 4)),
                                       (24, (5, 7, 3)), (8, (8, 8, 8))])
def test_fold_apply_plain_matches_jax(c, spatial, relu):
    """fold_apply_plain (x, f64 sums) -> (y, s, t) against
    ``_fold_lane_stats`` (one lane a channel, cycles 1) and
    ``_apply_per_lane`` on the same sums rounded to f32."""
    b = 2
    x, _ = _draw(c, (b, *spatial, c), torch.float32)
    n = math.prod(spatial)
    sums = _sums64(x)
    mean, rstd = jin._fold_lane_stats(jnp.asarray(sums.float().numpy()), c,
                                      1, n)
    y_want = np.asarray(jin._apply_per_lane(
        jnp.asarray(x.numpy().reshape(b, n, c)), rstd, -mean * rstd, relu))
    t_want = np.asarray(-mean * rstd)
    y, s, t = pin.fold_apply_plain(x, sums, relu)
    assert y.dtype == torch.float32 and s.shape == t.shape == (b, c)
    for got, want, tol in ((s, np.asarray(rstd), 1e-6), (t, t_want, 1e-6),
                           (y.reshape(b, n, c), y_want, 1e-5)):
        err = np.abs(got.numpy() - want).max()
        assert err <= tol * np.abs(want).max(), err


def test_norm_apply_on_the_cpu_is_its_plain_version():
    """On CPU tensors norm_apply is fold_apply_plain on the sums it is
    given, f32 or f64 (the f64 of norm_stats' f32 sums folds to the same
    bits), and norm_bwd_dx takes the sums' means as norm_bwd did."""
    x, g = _draw(4, (2, 4, 5, 6, 16))
    st = pin.norm_stats(x)
    y, s, t = pin.norm_apply(x, pin.norm_stats(x, f64=True), False)
    y32, s32, t32 = pin.fold_apply_plain(x, st, False)
    assert torch.equal(y, y32) and torch.equal(s, s32) and torch.equal(t, t32)
    assert torch.equal(s, pin.affine_from_stats(st, 120)[0])
    sums = pin.norm_bwd_sums(x, g, s, t, True, f64=True)
    assert sums.dtype == torch.float64
    assert torch.equal(sums.float(), pin.norm_bwd_sums(x, g, s, t, True))
    m = pin.norm_bwd_sums(x, g, s, t, True) / 120
    gm, xhat = pin._masked(x, g, s, t, True)
    want = (s[:, None, None, None] * (gm - m[:, None, None, None, 0]
            - xhat * m[:, None, None, None, 1])).to(x.dtype)
    assert torch.equal(pin.norm_bwd_dx(x, g, s, t, sums), want)


# ---- norm_elementwise_kernel's partition under norm_apply_plan, emulated


def emulate_norm_elementwise(x, sums, relu, plan, g=None, aff=None):
    """The kernel's partition on CPU tensors: thread i (of blocks x threads)
    of a batch entry stores the items i + k stride (the kernel's stride is
    blocks x threads; an item: `lanes`
    channels of a voxel), each element from the (s, t) (and (m1, m2)) of
    ITS OWN channel group i % groups, and block 0's threads write (s, t) of
    channels tid + k threads. Returns (y, s, t) (y alone with g), how many
    times each element was stored, how many times each channel's (s, t)
    was, and whether every item a thread stored held its channel group."""
    b, c = x.shape[0], x.shape[-1]
    lanes, groups, items = plan["lanes"], plan["groups"], plan["items"]
    stride, threads = plan["stride"], plan["threads"]
    n = x.numel() // (b * c)
    if g is None:
        s, t = pin.affine_from_stats(sums.float(), n)
        m = torch.zeros(b, 2, c)
    else:
        s, t = aff
        m = sums.float() / n
    regs = [v.reshape(b, groups, lanes) for v in (s, t, m[:, 0], m[:, 1])]
    xi = x.reshape(b, items, lanes)
    gi = None if g is None else g.reshape(b, items, lanes)
    y = torch.zeros_like(xi)
    stores = torch.zeros(b, items, dtype=torch.int64)
    one_group = True
    first = torch.arange(plan["blocks"] * threads)
    for bb in range(b):
        mine = [r[bb, first % groups] for r in regs]   # [stride, lanes]
        for k in range(-(-items // stride)):
            e = first + k * stride
            ok = e < items
            stores[bb] += torch.bincount(e[ok], minlength=items)
            one_group &= bool(((e[ok] % groups) == (first[ok] % groups))
                              .all())
            ts, tt, m1, m2 = (r[ok] for r in mine)
            xhat = xi[bb, e[ok]].float() * ts + tt
            if g is None:
                v = torch.relu(xhat) if relu else xhat
            else:
                gm = gi[bb, e[ok]].float()
                if relu:
                    gm = torch.where(xhat > 0, gm, torch.zeros(()))
                v = ts * (gm - m1 - xhat * m2)
            y[bb, e[ok]] = v.to(x.dtype)
    written = torch.bincount(torch.tensor(
        [cc for tid in range(threads) for cc in range(tid, c, threads)]),
        minlength=c)
    y = y.view(x.shape)
    return (y if g is not None else (y, s, t)), stores, written, one_group


NORM_CASES = [
    ((2, 6, 8, 5, 8), True, H100_SMS), ((2, 6, 8, 5, 8), True, 1),
    ((1, 8, 8, 8, 32), True, 2), ((1, 4, 4, 4, 256), True, H100_SMS),
    ((2, 5, 9, 7, 24), True, 1),      # three channel groups
    ((2, 5, 9, 7, 3), True, 1),       # C % 8 != 0: an element an item
    ((1, 6, 8, 5, 16), False, 1),     # not 16-byte aligned: elements
    ((1, 16, 16, 16, 8), True, H100_SMS),
]


@pytest.mark.parametrize("shape,vec,sms", NORM_CASES)
def test_norm_elementwise_partition_stores_each_element_once(shape, vec,
                                                             sms):
    """norm_apply and norm_bwd_dx (relu on and off) in the kernel's
    partition: every element stored once, each thread's channel group
    fixed, every channel's (s, t) written once, the vector path exactly
    where C % 8 == 0 and the volumes are aligned, and the result equal to
    the plain versions bit for bit."""
    b, c = shape[0], shape[-1]
    n = math.prod(shape[1:4])
    x, g = _draw(7 + c, shape)
    plan = pin.norm_apply_plan(b, n, c, vec, sms)
    assert plan["lanes"] == (8 if vec and c % 8 == 0 else 1)
    assert plan["stride"] % plan["groups"] == 0
    assert plan["blocks"] * b <= pin.NORM_APPLY_BLOCKS_A_SM * sms \
        + b * plan["groups"]
    sums = _sums64(x)
    for relu in (True, False):
        (y, s, t), stores, written, one_group = emulate_norm_elementwise(
            x, sums, relu, plan)
        assert (stores == 1).all() and (written == 1).all() and one_group
        y_p, s_p, t_p = pin.fold_apply_plain(x, sums, relu)
        assert torch.equal(y, y_p) and torch.equal(s, s_p) \
            and torch.equal(t, t_p)
        bsums = pin.norm_bwd_sums_plain(x, g, s, t, relu, f64=True)
        dx, stores, _, one_group = emulate_norm_elementwise(
            x, bsums, relu, plan, g, (s, t))
        assert (stores == 1).all() and one_group
        assert torch.equal(dx, pin.norm_bwd_dx_plain(x, g, s, t, bsums, relu))


def test_norm_elementwise_emulation_sees_a_stride_fault():
    """A stride (36 items) that is no multiple of the channel groups (8)
    moves a thread's items across channels: the group check and the values
    fail; a stride (28) shorter than the threads (32) stores items twice."""
    x, _ = _draw(5, (1, 4, 4, 4, 8))
    sums = _sums64(x)
    plan = dict(pin.norm_apply_plan(1, 64, 8, False, 1))
    plan.update(lanes=1, groups=8, items=512, threads=32, blocks=1,
                stride=36)
    (y, _, _), stores, _, one_group = emulate_norm_elementwise(
        x, sums, True, plan)
    assert not one_group
    assert not torch.equal(y, pin.fold_apply_plain(x, sums, True)[0])
    plan.update(stride=28)
    _, stores, _, _ = emulate_norm_elementwise(x, sums, True, plan)
    assert (stores > 1).any()


def test_norm_apply_plans_of_the_main_path():
    """The norm route's shapes (C 8-256 at 128^3-4^3), batches 1, 2, 4,
    aligned: 8 channels an item, the stride a multiple of the channel
    groups, at most NORM_APPLY_BLOCKS_A_SM blocks an SM over the batch
    (rounded to the groups), about NORM_APPLY_ITEMS_A_THREAD items a
    thread where the cap does not bind; a misaligned volume takes the
    element path."""
    for b in (1, 2, 4):
        for e, c in ((128, 8), (64, 16), (32, 32), (16, 64), (8, 128),
                     (4, 256), (64, 8), (32, 16)):
            plan = pin.norm_apply_plan(b, e ** 3, c, True, H100_SMS)
            assert plan["lanes"] == 8 and plan["groups"] == c // 8
            assert plan["items"] == e ** 3 * c // 8
            assert plan["stride"] % plan["groups"] == 0
            cap = -(-pin.NORM_APPLY_BLOCKS_A_SM * H100_SMS // b)
            assert plan["blocks"] <= cap + plan["groups"]
            per = plan["items"] / plan["stride"]
            assert per <= pin.NORM_APPLY_ITEMS_A_THREAD or \
                plan["blocks"] >= cap
    x = torch.zeros(1 + 2 * 4 * 4 * 4 * 8, dtype=torch.bfloat16)
    off = x[1:].view(2, 4, 4, 4, 8)
    assert pin._aligned(x) and not pin._aligned(off)
    assert pin.norm_apply_plan(2, 64, 8, pin._aligned(off), 1)["lanes"] == 1
    with pytest.raises(ValueError):
        pin.norm_apply_plan(1, 0, 8, True, H100_SMS)


# ---- softmax_vjp_c2_kernel's 4-voxel items under softmax_vjp_plan


def emulate_softmax_vjp(g, y, plan):
    """The kernel's partition: thread i stores the items i + k stride (4
    voxels each) and then the voxels 4 items + i + k stride (the element
    path), each voxel as the kernel computes it (the dot as two products
    and one sum, then (g - dot) * y, rounded once each). Returns the
    output and how many times each voxel was stored."""
    c = y.shape[-1]
    gv, yv = g.reshape(-1, c).float(), y.reshape(-1, c).float()
    nvox = gv.shape[0]
    out = torch.zeros(nvox, c, dtype=y.dtype)
    stores = torch.zeros(nvox, dtype=torch.int64)
    first = torch.arange(plan["blocks"] * plan["threads"])

    def store(v):
        dot = gv[v, 0] * yv[v, 0] + gv[v, 1] * yv[v, 1]
        out[v] = ((gv[v] - dot[:, None]) * yv[v]).to(y.dtype)
        stores.add_(torch.bincount(v, minlength=nvox))

    items = plan["items"]
    for k in range(-(-items // plan["stride"])):
        e = first + k * plan["stride"]
        e = e[e < items]
        store((4 * e[:, None] + torch.arange(4)).reshape(-1))
    for k in range(-(-plan["tail"] // plan["stride"])):
        v = 4 * items + first + k * plan["stride"]
        store(v[v < nvox])
    return out.view(y.shape), stores


SOFTMAX_CASES = [
    ((2, 3, 5, 7, 2), True, 1),       # nvox % 4 == 2
    ((1, 4, 4, 4, 2), True, 1),       # no tail
    ((1, 3, 3, 3, 2), True, 1),       # a tail of 3
    ((1, 1, 1, 5, 2), True, H100_SMS),   # a tail of 1
    ((1, 1, 1, 3, 2), True, 1),       # no item: every voxel an element
    ((2, 3, 5, 7, 2), False, 1),      # not 16-byte aligned: elements
    ((2, 16, 16, 16, 2), True, 2),
]


@pytest.mark.parametrize("shape,vec,sms", SOFTMAX_CASES)
def test_softmax_vjp_items_store_each_voxel_once(shape, vec, sms):
    """Every voxel stored once, by the vector path (4 voxels an item)
    where C == 2 and the tensors are aligned and by the element path for
    the tail of nvox % 4 (or every voxel), the result equal to
    softmax_vjp_plain bit for bit."""
    nvox = math.prod(shape[:-1])
    rng = np.random.default_rng(nvox)
    logits = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    y = torch.softmax(logits, dim=-1).bfloat16()
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
        .bfloat16()
    plan = losses.softmax_vjp_plan(nvox, 2, vec, sms)
    assert plan["items"] == (nvox // 4 if vec else 0)
    assert plan["tail"] == nvox - 4 * plan["items"]
    assert 1 <= plan["blocks"] <= losses.SOFTMAX_BLOCKS_A_SM * sms
    out, stores = emulate_softmax_vjp(g, y, plan)
    assert (stores == 1).all()
    assert torch.equal(out, losses.softmax_vjp_plain(g, y))


def test_softmax_vjp_emulation_sees_a_stride_fault():
    """A stride one short of the threads stores some voxels twice; one
    past them skips voxels."""
    shape = (1, 3, 5, 7, 2)
    y = torch.full(shape, 0.5, dtype=torch.bfloat16)
    g = torch.ones(shape, dtype=torch.bfloat16)
    plan = dict(losses.softmax_vjp_plan(105, 2, True, 1))
    plan.update(blocks=1, threads=8, stride=7)
    _, stores = emulate_softmax_vjp(g, y, plan)
    assert (stores > 1).any()
    plan.update(stride=9)
    _, stores = emulate_softmax_vjp(g, y, plan)
    assert (stores == 0).any()


def test_softmax_vjp_plans():
    """The main path's calls ([2, 128^3, 2] and [4, 128^3, 2]) take the
    vector path with no tail and a grid of at most SOFTMAX_BLOCKS_A_SM
    blocks an SM; C other than 2 has no items; no call on no voxel."""
    for b in (2, 4):
        plan = losses.softmax_vjp_plan(b * 128 ** 3, 2, True, H100_SMS)
        assert plan["items"] == b * 128 ** 3 // 4 and plan["tail"] == 0
        assert plan["blocks"] <= losses.SOFTMAX_BLOCKS_A_SM * H100_SMS
    assert losses.softmax_vjp_plan(64, 3, True, 1)["items"] == 0
    with pytest.raises(ValueError):
        losses.softmax_vjp_plan(0, 2, True, 1)


# ---- chip_smoke.py's phase 1: the 128-bit accesses in a kernel's own SASS

_SASS = """
\t\tFunction : _ZN12_GLOBAL__N_123norm_elementwise_kernelILi0ELb1EEEvNS_8NormArgsE
        /*0100*/                   LDG.E.EF.128 R4, desc[UR4][R2.64] ;
        /*0110*/                   STG.E.128 desc[UR4][R6.64], R8 ;
        /*0120*/                   LDG.E.64 R10, desc[UR4][R2.64] ;
\t\tFunction : _ZN12_GLOBAL__N_123norm_elementwise_kernelILi1ELb0EEEvNS_8NormArgsE
        /*0100*/                   LDG.E.U16 R4, desc[UR4][R2.64] ;
        /*0110*/                   STG.E.U16 desc[UR4][R6.64], R8 ;
\t\tFunction : _ZN12_GLOBAL__N_121softmax_vjp_c2_kernelEPK13__nv_bfloat16S2_PS0_ll
        /*0100*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0110*/                   STG.E.128 desc[UR4][R6.64], R8 ;
\t\tFunction : _ZN12_GLOBAL__N_118softmax_vjp_kernelEPK13__nv_bfloat16S2_PS0_li
        /*0100*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
"""


def test_phase1_counts_128_bit_accesses_by_kernel():
    """chip_smoke.py's phase 1 counts LDG.*.128 and STG.*.128 (any cache
    qualifier) in a kernel's own functions: every template instance of
    norm_elementwise_kernel, the namespace function softmax_vjp_c2_kernel
    and not its generic sibling; 64-bit and 16-bit accesses do not count."""
    import chip_smoke as cs

    assert cs.kernel_sass(_SASS, "norm_elementwise_kernel") == {
        "HMMA": 0, "HGMMA": 0, "LDG.128": 1, "STG.128": 1, "functions": 2}
    got = cs.kernel_sass(_SASS, "softmax_vjp_c2_kernel")
    assert (got["LDG.128"], got["STG.128"], got["functions"]) == (1, 1, 1)
    assert ("losses", "softmax_vjp_c2_kernel") in cs.VECTOR_KERNELS
    assert ("instance_norm", "norm_elementwise_kernel") in cs.VECTOR_KERNELS
