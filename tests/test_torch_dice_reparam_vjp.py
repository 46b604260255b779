"""The Dice sums' and the reparam's hand-written kernels on the CPU, where
they run their plain versions (vae_segmentation_tpu_torch/ops/losses.py,
kernels/csrc/losses.cu; ops/reparam.py, kernels/csrc/reparam.cu):

- ``dice_sums_vjp_plain`` against the JAX package's VJP of ``dice_sums``
  (vae_segmentation_tpu/ops/pallas/dicesums.py::_bwd) and
  ``reparam_kl_vjp_plain`` against ``reparam.py::_reparam_bwd``, from the
  same seeded numpy inputs, for every combination of inputs that need a
  gradient. Both compute the same f32 expression in the same order; the
  Dice VJP's bf16 results are held within one bf16 ulp of the JAX
  package's (XLA may contract a multiply and an add into one rounding
  before the cast), the reparam VJP's f32 results within 1e-6 of the
  largest element (test_torch_reparam.py's bound);
- an exact, integer-valued emulation of the two dice kernels' partition
  under ``dice_sums_plan``: thread i of a batch entry takes the 16-byte
  items i + j stride (8 bf16: 8 / C voxels, lane l of class l % C) and
  then the elements 8 items + i + j stride of the element path, whose
  class stays the thread's own. Every element is read (forward) or stored
  (VJP) once, the emulated sums equal ``dice_sums_plain`` exactly and the
  emulated VJP equals ``dice_sums_vjp_plain`` bit for bit, for C of 2, 3
  and 8, nvox % 4 tails, misaligned tensors and batch bases off 16 bytes;
  a planted stride fault fails;
- the reparam kernel's KL reduction (f64 terms a thread, a shuffle tree a
  warp, the warp sums by one warp, rounded to f32 once) equals the f64 sum
  rounded once.

Inputs are drawn with numpy from a seed.
"""

import itertools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vae_segmentation_tpu.ops.pallas import dicesums as jdice
from vae_segmentation_tpu.ops.pallas import reparam as jreparam
from vae_segmentation_tpu_torch import ops as port_ops
from vae_segmentation_tpu_torch.ops import losses, reparam
from vae_segmentation_tpu_torch.ops.kernels import build

torch.set_num_threads(2)

H100_SMS = 132
BF16_ULP = 2.0 ** -8        # bf16's unit roundoff, relative


def _vols(seed, shape, k):
    """pred and k targets: probabilities in bf16."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.random(shape).astype(np.float32))
            .bfloat16() for _ in range(1 + k)]


def _needs(k):
    """Every (need_pred, need_targets) of k targets."""
    return [(flags[0], flags[1:])
            for flags in itertools.product((False, True), repeat=1 + k)]


# ---- the plain VJPs against the JAX package's


@pytest.mark.parametrize("k", [1, 2, 3])
def test_dice_sums_vjp_plain_matches_jax_bwd(k):
    """dicesums._bwd on the lane-collapsed [B, D, H, W * C] volumes with
    the port's per-class cotangent broadcast over W: each needed gradient
    within one bf16 ulp of its element, the others None."""
    b, d, h, w, c = 2, 3, 4, 5, 2
    vols = _vols(10 + k, (b, d, h, w, c), k)
    rng = np.random.default_rng(k)
    g = rng.normal(size=(b, 1 + 2 * k, c)).astype(np.float32)
    g8 = np.zeros((b, 8, w * c), np.float32)
    g8[:, :1 + 2 * k] = np.tile(g, (1, 1, w))
    flat = [jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
            .reshape(b, d, h, w * c) for v in vols]
    want = [np.asarray(x.astype(jnp.float32)).reshape(b, d, h, w, c)
            for x in jdice._bwd((flat[0], tuple(flat[1:])), jnp.asarray(g8))]
    for need_pred, need_t in _needs(k):
        got = losses.dice_sums_vjp_plain(torch.from_numpy(g), vols[0],
                                         vols[1:], need_pred, need_t)
        assert len(got) == 1 + k
        for o, wnt, need in zip(got, want, (need_pred, *need_t)):
            if not need:
                assert o is None
                continue
            assert o.dtype == torch.bfloat16
            err = np.abs(o.float().numpy() - wnt)
            assert (err <= BF16_ULP * np.abs(wnt) + 1e-30).all()


@pytest.mark.parametrize("need", [(True, True), (True, False),
                                  (False, True)])
def test_reparam_kl_vjp_plain_matches_jax_bwd(need, monkeypatch):
    """reparam._reparam_bwd against reparam_kl_vjp_plain and the
    autograd Function on the CPU (mean, std or both needing a gradient),
    with JAX's sample as eps: within 1e-6 of each gradient's largest
    element; std holds exact zeros, where 1 / (std + 1e-5) is large."""
    rng = np.random.default_rng(7)
    b, d, scale = 4, 128, 0.35
    mean = (rng.normal(size=(b, d)) * 0.7).astype(np.float32)
    std = np.maximum(rng.normal(size=(b, d)), 0.0).astype(np.float32)
    eps = rng.normal(size=(b, d)).astype(np.float32)
    g_latent = rng.normal(size=(b, d)).astype(np.float32)
    g_kl = np.float32(0.3)
    res = (jnp.asarray(mean), jnp.asarray(std), jnp.float32(scale),
           jnp.asarray(eps), ())
    want = [np.asarray(x) for x in jreparam._reparam_bwd(
        res, (jnp.asarray(g_latent), jnp.asarray(g_kl)))[:2]]
    got = reparam.reparam_kl_vjp_plain(
        torch.from_numpy(mean), torch.from_numpy(std), torch.from_numpy(eps),
        torch.from_numpy(g_latent), torch.tensor(g_kl), scale)
    for o, wnt in zip(got, want):
        assert np.abs(o.numpy() - wnt).max() <= 1e-6 * np.abs(wnt).max()
    assert np.abs(want[1]).max() > 1e3

    m = torch.from_numpy(mean).requires_grad_(need[0])
    s = torch.from_numpy(std).requires_grad_(need[1])
    # hand the port JAX's sample in place of its own draw
    monkeypatch.setattr(reparam, "philox_normal_plain",
                        lambda *a, **kw: torch.from_numpy(eps))
    latent, kl, _ = reparam.reparam_kl(m, s, scale, torch.tensor([3]))
    leaves = [t for t, n in zip((m, s), need) if n]
    grads = torch.autograd.grad(
        (latent * torch.from_numpy(g_latent)).sum() + kl * float(g_kl),
        leaves)
    for gr, wnt in zip(grads, [w_ for w_, n in zip(want, need) if n]):
        assert np.abs(gr.numpy() - wnt).max() <= 1e-6 * np.abs(wnt).max()


def test_vjps_on_the_cpu_are_their_plain_versions():
    """A CPU tensor runs each VJP's plain version: no launch is counted
    and no kernel library is built."""
    port_ops.reset_launch_counts()
    pred, t0, t1 = _vols(0, (1, 2, 3, 4, 2), 2)
    g = torch.ones(1, 5, 2)
    got = losses.dice_sums_vjp(g, pred, (t0, t1), True, (False, True))
    assert got[1] is None
    for o, w in zip(got, losses.dice_sums_vjp_plain(
            g, pred, (t0, t1), True, (False, True))):
        assert (o is None and w is None) or torch.equal(o, w)
    m = torch.ones(2, 8)
    assert all(torch.equal(a, b) for a, b in zip(
        reparam.reparam_kl_vjp(m, m, m, m, torch.tensor(1.0), 0.35),
        reparam.reparam_kl_vjp_plain(m, m, m, m, torch.tensor(1.0), 0.35)))
    counts = port_ops.launch_counts()
    assert counts["dice_sums_vjp"] == 0 and counts["reparam_kl_vjp"] == 0
    assert build.loaded() == []
    with pytest.raises(ValueError):
        losses.dice_sums_vjp(torch.ones(1, 9, 2), pred, (t0,) * 4)


# ---- an exact emulation of the dice kernels' items under dice_sums_plan


def _threads(plan, b):
    """(batch entry, thread, block) of every thread of the grid."""
    t = torch.arange(plan["blocks"] * plan["threads"])
    return [(e, t, t // plan["threads"]) for e in range(b)]


def emulate_dice_sums(pred, targets, plan):
    """dice_sums_vec_kernel / dice_sums_kernel under `plan`: each thread's
    sums of its items (lane l of class l % C) and of its element-path
    elements (asserted all of one class, the thread's), added per block,
    then the blocks' partials in order; an element-path element goes to
    the class the kernel gives its thread (the thread's index mod C).
    Returns the [B, 1 + 2K, C] sums and how many times each element was
    read."""
    b, c = pred.shape[0], pred.shape[-1]
    vols = [v.reshape(b, -1).float() for v in (pred, *targets)]
    n = vols[0].shape[1]
    k = len(targets)
    reads = torch.zeros(b, n, dtype=torch.int64)
    part = torch.zeros(b, plan["blocks"], 1 + 2 * k, c)
    items, stride = plan["items"], plan["stride"]
    for e, tid, block in _threads(plan, b):
        idx, cls = [], []
        for j in range(-(-items // stride)):
            it = tid + j * stride
            keep = it < items
            lanes = 8 * it[keep, None] + torch.arange(8)
            idx.append((lanes, tid[keep, None].expand_as(lanes)))
            cls.append(torch.arange(8).expand_as(lanes) % c)
        for j in range(-(-plan["tail"] // stride)):
            el = 8 * items + tid + j * stride
            keep = el < n
            # a thread's element-path elements keep its class
            assert torch.equal(el[keep] % c, tid[keep] % c)
            idx.append((el[keep, None], tid[keep, None]))
            cls.append(tid[keep, None] % c)
        for (el, t), cl in zip(idx, cls):
            el, t, cl = el.reshape(-1), t.reshape(-1), cl.reshape(-1)
            reads[e].index_add_(0, el, torch.ones_like(el))
            p = vols[0][e, el]
            rows = [p] + [x for tv in vols[1:]
                          for x in (tv[e, el], p * tv[e, el])]
            for r, val in enumerate(rows):
                part[e].index_put_((block[t], torch.full_like(t, r), cl),
                                   val, accumulate=True)
    return part.sum(dim=1), reads


def emulate_dice_vjp(g, pred, targets, need_pred, need_t, plan):
    """dice_vjp_vec_kernel / dice_vjp_kernel under `plan`: each item's and
    each element's gradients from the class of its lane (l % C) or its
    index, with the plain version's f32 operations. Returns the gradients
    and how many times each element was stored."""
    b, c = pred.shape[0], pred.shape[-1]
    p = pred.reshape(b, -1).float()
    ts = [t.reshape(b, -1).float() for t in targets]
    n = p.shape[1]
    outs = [torch.zeros(b, n, dtype=torch.bfloat16) if need else None
            for need in (need_pred, *need_t)]
    stores = torch.zeros(b, n, dtype=torch.int64)
    items, stride = plan["items"], plan["stride"]

    def store(e, el, cl):
        stores[e].index_add_(0, el, torch.ones_like(el))
        gr = g[e][:, cl]                   # [rows, elements]
        if need_pred:
            dp = gr[0]
            for i, t in enumerate(ts):
                dp = dp + gr[2 + 2 * i] * t[e, el]
            outs[0][e, el] = dp.bfloat16()
        for i, need in enumerate(need_t):
            if need:
                outs[1 + i][e, el] = (gr[1 + 2 * i]
                                      + gr[2 + 2 * i] * p[e, el]).bfloat16()

    for e, tid, _ in _threads(plan, b):
        for j in range(-(-items // stride)):
            it = tid + j * stride
            it = it[it < items]
            lanes = (8 * it[:, None] + torch.arange(8)).reshape(-1)
            store(e, lanes, torch.arange(8).repeat(len(it)) % c)
        for j in range(-(-plan["tail"] // stride)):
            el = 8 * items + tid + j * stride
            el = el[el < n]
            store(e, el, el % c)
    return [None if o is None else o.view(pred.shape) for o in outs], stores


# [B, D, H, W, C], offset: C 2 with nvox % 4 of 0-3 (items and a tail),
# no item (3 voxels), C 8 (one voxel an item), C 3 (element path only), a
# misaligned target, batch bases off 16 bytes (B 2, nvox % 4 != 0)
DICE_CASES = [((1, 3, 5, 7, 2), 0), ((1, 4, 4, 4, 2), 0),
              ((1, 3, 3, 3, 2), 0), ((1, 1, 1, 5, 2), 0),
              ((1, 1, 1, 3, 2), 0), ((1, 2, 3, 5, 8), 0),
              ((2, 3, 4, 5, 3), 0), ((1, 4, 4, 4, 2), 1),
              ((2, 3, 5, 7, 2), 0), ((2, 4, 4, 4, 2), 0)]


def _int_vols(seed, shape, k, offset):
    """Integer-valued bf16 volumes (0-3: every product and sum exact in
    f32), the first target `offset` elements past an aligned start."""
    rng = np.random.default_rng(seed)
    vols = [torch.from_numpy(rng.integers(0, 4, size=shape)
                             .astype(np.float32)).bfloat16()
            for _ in range(1 + k)]
    if offset:
        buf = torch.zeros(vols[1].numel() + offset, dtype=torch.bfloat16)
        buf[offset:] = vols[1].reshape(-1)
        vols[1] = buf[offset:].view(shape)
    return vols


@pytest.mark.parametrize("shape,offset", DICE_CASES)
@pytest.mark.parametrize("sms", [1, H100_SMS])
def test_dice_items_read_each_element_once(shape, offset, sms):
    """The forward's partition: every element read once, the emulated
    sums equal dice_sums_plain exactly; the plan's items where C divides
    8 and every volume (and batch base) is aligned."""
    k = 3
    vols = _int_vols(sum(shape), shape, k, offset)
    b, c = shape[0], shape[-1]
    nvox = math.prod(shape[1:-1])
    vec = losses._dice_vec(vols)
    assert vec == (offset == 0 and (b == 1 or nvox * c % 8 == 0))
    plan = losses.dice_sums_plan(b, nvox, c, k, vec, sms)
    assert plan["items"] == (nvox * c // 8 if vec and 8 % c == 0 else 0)
    assert plan["tail"] == nvox * c - 8 * plan["items"]
    assert plan["stride"] % c == 0
    got, reads = emulate_dice_sums(vols[0], vols[1:], plan)
    assert (reads == 1).all()
    assert torch.equal(got, losses.dice_sums_plain(vols[0], vols[1:]))


@pytest.mark.parametrize("shape,offset", DICE_CASES)
def test_dice_vjp_items_store_each_element_once(shape, offset):
    """The VJP's partition: every needed gradient's elements stored once,
    the emulation equal to dice_sums_vjp_plain bit for bit (a cotangent
    that differs by class shows a lane of the wrong class)."""
    k = 2
    vols = _int_vols(7 * sum(shape), shape, k, offset)
    b, c = shape[0], shape[-1]
    g = torch.from_numpy(np.random.default_rng(c).normal(
        size=(b, 1 + 2 * k, c)).astype(np.float32))
    plan = losses.dice_sums_plan(b, math.prod(shape[1:-1]), c, k,
                                 losses._dice_vec(vols), 1)
    for need_pred, need_t in ((True, (True, False)), (False, (True, True))):
        got, stores = emulate_dice_vjp(g, vols[0], vols[1:], need_pred,
                                       need_t, plan)
        assert (stores == 1).all()
        want = losses.dice_sums_vjp_plain(g, vols[0], vols[1:], need_pred,
                                          need_t)
        for o, w in zip(got, want):
            assert (o is None and w is None) or torch.equal(o, w)


def test_dice_emulation_sees_a_stride_fault():
    """A stride one short of the threads reads some elements twice; one
    past them skips elements."""
    shape = (1, 3, 5, 7, 2)
    vols = _int_vols(0, shape, 1, 0)
    plan = dict(losses.dice_sums_plan(1, 105, 2, 1, True, 1))
    plan.update(blocks=1, threads=8, stride=6)
    _, reads = emulate_dice_sums(vols[0], vols[1:], plan)
    assert (reads > 1).any()
    plan.update(stride=10)
    _, reads = emulate_dice_sums(vols[0], vols[1:], plan)
    assert (reads == 0).any()


def test_dice_sums_plans():
    """The adaptation step's call ([2, 128^3, 2], K = 3) takes the vector
    path with no tail, at most DICE_BLOCKS_A_SM blocks an SM over the
    batch; its workspace holds the result and the partials; another C
    keeps a thread's class; no call on nothing or on four targets."""
    plan = losses.dice_sums_plan(2, 128 ** 3, 2, 3, True, H100_SMS)
    assert plan["items"] == 128 ** 3 // 4 and plan["tail"] == 0
    assert 2 * plan["blocks"] <= losses.DICE_BLOCKS_A_SM * H100_SMS
    assert plan["workspace"] == 2 * 7 * 2 * (1 + plan["blocks"])
    assert losses.dice_sums_plan(1, 64, 3, 1, True, 1)["items"] == 0
    for c in (3, 5, 6, 12):
        assert losses.dice_sums_plan(2, 1000, c, 2, False, 3)["stride"] \
            % c == 0
    for bad in ((1, 0, 2, 1), (1, 8, 2, 0), (1, 8, 2, 4), (0, 8, 2, 1)):
        with pytest.raises(ValueError):
            losses.dice_sums_plan(*bad, True, 1)


# ---- the reparam kernel's KL reduction


def emulate_kl(terms, batch, threads=512):
    """reparam_kl_kernel's KL: thread i adds its f32 terms i + j threads
    in f64 in order; a shuffle tree (offsets 16, 8, 4, 2, 1) adds each
    warp's 32 sums; warp 0 adds the warp sums (zeros past the last warp)
    by the same tree; 0.5 total / batch in f64, rounded to f32 once."""
    t = terms.double().reshape(-1)
    part = torch.zeros(threads, dtype=torch.float64)
    for j in range(-(-t.numel() // threads)):
        chunk = t[j * threads:(j + 1) * threads]
        part[:chunk.numel()] += chunk

    def tree(v):
        v = v.clone()
        for off in (16, 8, 4, 2, 1):
            v[:off] = v[:off] + v[off:2 * off]
        return v[0]

    warps = torch.zeros(32, dtype=torch.float64)
    warps[:threads // 32] = torch.stack([tree(w)
                                         for w in part.view(-1, 32)])
    return torch.tensor(0.5 * tree(warps).item() / batch,
                        dtype=torch.float64).float()


@pytest.mark.parametrize("b,d", [(4, 128), (3, 7), (64, 1000)])
def test_kl_fixed_order_reduction_equals_the_f64_sum(b, d):
    """The kernel's fixed-order f64 sum of the f32 KL terms, rounded to f32
    once, equals the f64 sum rounded once, and lies within 1e-6 of the
    plain version's f32 KL."""
    rng = np.random.default_rng(b * d)
    mean = torch.from_numpy((rng.normal(size=(b, d)) * 0.7)
                            .astype(np.float32))
    std = torch.from_numpy(np.maximum(rng.normal(size=(b, d)), 0.0)
                           .astype(np.float32))
    terms = std * std + mean * mean - 2.0 * torch.log(std + reparam.KL_EPS)
    kl = emulate_kl(terms, b)
    want = (0.5 * terms.double().sum() / b).float()
    assert torch.equal(kl, want)
    plain = reparam.reparam_kl_plain(mean, std, 0.35, torch.zeros(b, d))[1]
    assert abs(kl.item() - plain.item()) <= 1e-6 * abs(want.item())


# ---- chip_smoke.py's records of the new kernels

_SASS = """
\t\tFunction : _ZN12_GLOBAL__N_120dice_sums_vec_kernelILi2EEEvNS_8DiceArgsE
        /*0100*/                   LDG.E.128.EF R4, desc[UR4][R2.64] ;
        /*0110*/                   STG.E desc[UR4][R6.64], R8 ;
\t\tFunction : _ZN12_GLOBAL__N_116dice_sums_kernelENS_8DiceArgsE
        /*0100*/                   LDG.E.U16 R4, desc[UR4][R2.64] ;
\t\tFunction : _ZN12_GLOBAL__N_119dice_vjp_vec_kernelILi2EEEvNS_11DiceVjpArgsE
        /*0100*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*0110*/                   STG.E.128 desc[UR4][R6.64], R8 ;
"""


def test_chip_smoke_checks_and_names_the_new_kernels():
    """Phase 1 finds the dice kernels' 128-bit accesses in their own
    functions (the sums' reduction stores no item); the profile families
    name every new kernel; the launches a pass are derived from the
    models: one dice_sums_vjp an adaptation step (and in the backward
    alone), one reparam_kl_vjp a vae_train step, none a seg_train step."""
    import chip_smoke as cs
    from vae_segmentation_tpu_torch.models import Joint, SegUNet, ShapeVAE

    got = cs.kernel_sass(_SASS, "dice_sums_vec_kernel")
    assert (got["LDG.128"], got["STG.128"], got["functions"]) == (1, 0, 1)
    got = cs.kernel_sass(_SASS, "dice_vjp_vec_kernel")
    assert (got["LDG.128"], got["STG.128"], got["functions"]) == (1, 1, 1)
    for kernel in ("dice_sums_vec_kernel", "dice_vjp_vec_kernel"):
        assert ("losses", kernel) in cs.VECTOR_KERNELS
    assert cs.LOAD_ONLY_KERNELS == ("dice_sums_vec_kernel",)
    for name, family in (
            ("void (anonymous namespace)::dice_sums_vec_kernel<2>(DiceArgs)",
             "dice_sums"),
            ("(anonymous namespace)::dice_sums_kernel(DiceArgs)", "dice_sums"),
            ("(anonymous namespace)::dice_vjp_vec_kernel<2>(DiceVjpArgs)",
             "dice_sums_vjp"),
            ("(anonymous namespace)::dice_vjp_kernel(DiceVjpArgs)",
             "dice_sums_vjp"),
            ("(anonymous namespace)::reparam_kl_vjp_kernel(float const*)",
             "reparam_kl_vjp"),
            ("(anonymous namespace)::reparam_kl_kernel(float const*)",
             "reparam_kl"),
            ("(anonymous namespace)::launch_floor_kernel()",
             "launch_floor")):
        assert cs._family(name) == family, name
    assert {"dice_sums_vjp", "reparam_kl_vjp"} <= set(cs.KERNEL_NAMES)
    assert {"dice_sums_vjp", "reparam_kl_vjp"} <= set(cs.BITWISE)

    kw = dict(n_class=2, dim=8, fmaps=(2, 3, 4, 5, 6, 8), bottleneck=64,
              dtype=torch.float32)
    step = cs.expected_step_launches(Joint(**kw))
    assert step["dice_sums"] == step["dice_sums_vjp"] == 1
    assert step["reparam_kl_vjp"] == 0
    assert cs.expected_backward_launches(Joint(**kw))["dice_sums_vjp"] == 1
    vae = cs.expected_source_step_launches(ShapeVAE(**kw), sampled=True)
    assert vae["reparam_kl"] == vae["reparam_kl_vjp"] == 1
    seg = cs.expected_source_step_launches(
        SegUNet(n_class=2, fmaps=(2, 3, 4, 5, 6, 8), dtype=torch.float32),
        sampled=False)
    assert seg["reparam_kl_vjp"] == 0 and seg["dice_sums_vjp"] == 0
