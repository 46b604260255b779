"""The port's reparam + KL op (vae_segmentation_tpu_torch/ops/reparam.py)
against the JAX package's fused kernel (vae_segmentation_tpu/ops/pallas/
reparam.py) on the CPU, where ``_run`` runs its Pallas kernel in interpret
mode on a normal sample drawn from the host PRNG and returns that sample as
its third output. The port's plain version takes the same sample:
  * latent and KL within 1e-6 (relative to the largest |latent| / the KL);
  * the gradients in mean and std against ``jax.vjp`` of ``reparam_kl``
    with the same sample, within 1e-6 of the largest element (std holds
    exact zeros, a ReLU's output, where 1 / (std + 1e-5) is large);
  * at scale 0 the latent is mean, bit for bit, and so is the ShapeVAE's
    reconstruction with the sampled latent.
The kernel's own generator (Philox4x32-10 in ``kernels/csrc/reparam.cu``,
the same bits in ``philox_normal_plain``) is checked against the published
known-answer vectors of Philox4x32-10 and as a distribution. A CPU call
never builds a kernel."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_segmentation_tpu.ops.pallas import reparam as jreparam
from vae_segmentation_tpu_torch.models import ShapeVAE
from vae_segmentation_tpu_torch.ops import reparam
from vae_segmentation_tpu_torch.ops.kernels import build

torch.set_num_threads(2)

B, D = 4, 128


def _stats(rng, b=B, d=D):
    """mean [b, d] and a ReLU'd std with exact zeros, f32."""
    mean = (rng.normal(size=(b, d)) * 0.7).astype(np.float32)
    std = np.maximum(rng.normal(size=(b, d)), 0.0).astype(np.float32)
    return mean, std


def _jax_run(mean, std, scale, seed):
    latent, kl, eps = jreparam._run(jnp.asarray(mean), jnp.asarray(std),
                                    jnp.float32(scale), jnp.int32(seed))
    return np.array(latent), float(kl), np.array(eps)


@pytest.mark.parametrize("scale", [0.35, 1.0])
def test_plain_matches_the_pallas_kernel_on_its_sample(rng, scale):
    mean, std = _stats(rng)
    want_latent, want_kl, eps = _jax_run(mean, std, scale, 1234)
    latent, kl = reparam.reparam_kl_plain(
        torch.from_numpy(mean), torch.from_numpy(std), scale,
        torch.from_numpy(eps))
    assert np.abs(latent.numpy() - want_latent).max() \
        <= 1e-6 * np.abs(want_latent).max()
    assert float(kl) == pytest.approx(want_kl, rel=1e-6)


def test_gradients_match_jax_vjp(rng, monkeypatch):
    mean, std = _stats(rng)
    scale, seed = 0.35, 77
    g_latent = rng.normal(size=(B, D)).astype(np.float32)
    g_kl = np.float32(0.3)
    _, _, eps = _jax_run(mean, std, scale, seed)
    (_, _), vjp = jax.vjp(
        lambda m, s: jreparam.reparam_kl(m, s, jnp.float32(scale),
                                         jnp.int32(seed)),
        jnp.asarray(mean), jnp.asarray(std))
    want_m, want_s = (np.asarray(g) for g in
                      vjp((jnp.asarray(g_latent), jnp.asarray(g_kl))))
    # hand the port JAX's sample in place of its own draw
    monkeypatch.setattr(reparam, "philox_normal_plain",
                        lambda *a, **k: torch.from_numpy(eps))
    m = torch.from_numpy(mean).requires_grad_()
    s = torch.from_numpy(std).requires_grad_()
    latent, kl, got_eps = reparam.reparam_kl(m, s, scale,
                                             torch.tensor([seed]))
    assert torch.equal(got_eps, torch.from_numpy(eps))
    gm, gs = torch.autograd.grad(
        (latent * torch.from_numpy(g_latent)).sum() + kl * float(g_kl),
        (m, s))
    for got, want in ((gm, want_m), (gs, want_s)):
        assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    assert np.abs(want_s).max() > 1e3   # the zeros of std were exercised


def test_scale_zero_latent_is_mean_bit_for_bit(rng):
    mean, std = _stats(rng)
    m = torch.from_numpy(mean)
    latent, kl, eps = reparam.reparam_kl(m, torch.from_numpy(std), 0.0,
                                         torch.tensor([5]))
    assert torch.equal(latent, m) and bool(eps.abs().max() > 0)
    vae = ShapeVAE(n_class=2, fmaps=(2, 3, 4, 5, 6, 8), dim=8, bottleneck=64,
                   dtype=torch.float32,
                   generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy((rng.random((2, 64, 64, 64, 2)) > 0.5)
                         .astype(np.float32))
    with torch.no_grad():
        want = vae(x)[0]
        got = vae(x, if_random=True, scale=0.0,
                  generator=torch.Generator().manual_seed(3))[0]
        other = vae(x, if_random=True, scale=0.35,
                    generator=torch.Generator().manual_seed(3))[0]
    assert torch.equal(got, want) and not torch.equal(other, want)


def test_kl_is_the_batch_mean_of_the_reference_kl(rng):
    from vae_segmentation_tpu_torch.ops import losses

    mean, std = _stats(rng)
    _, kl = reparam.reparam_kl_plain(torch.from_numpy(mean),
                                     torch.from_numpy(std), 0.35,
                                     torch.zeros(B, D))
    want = losses.kl_loss(torch.from_numpy(mean), torch.from_numpy(std))
    assert float(kl) == pytest.approx(float(want), rel=1e-6)


# Philox4x32-10 known-answer vectors (Random123's kat_vectors): counter,
# key -> output words
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox_known_answers(counter, key, want):
    out = reparam.philox4x32_10(
        tuple(torch.tensor([c], dtype=torch.int64) for c in counter), key)
    assert tuple(int(w) for w in out) == want


def test_philox_normal_is_a_standard_normal():
    """One million draws (many seeds and one large call): mean, variance
    and the two-sided tail shares within 5 standard errors; deterministic
    per seed, different across seeds."""
    big = reparam.philox_normal_plain(11, (1024, 1024)).double()
    seeds = torch.cat([reparam.philox_normal_plain(s, (B, D)).reshape(-1)
                       for s in range(64)]).double()
    for x in (big, seeds):
        n = x.numel()
        assert abs(float(x.mean())) < 5 / n ** 0.5
        assert abs(float(x.var()) - 1.0) < 5 * (2.0 / n) ** 0.5
        for t, p in ((1.0, 0.31731), (2.0, 0.04550), (3.0, 0.0026998)):
            share = float((x.abs() > t).double().mean())
            assert abs(share - p) < 5 * (p * (1 - p) / n) ** 0.5, (t, share)
    a = reparam.philox_normal_plain(3, (B, D))
    assert torch.equal(a, reparam.philox_normal_plain(3, (B, D)))
    assert not torch.equal(a, reparam.philox_normal_plain(4, (B, D)))


def test_seed_draw_is_reproducible_and_the_cpu_never_builds():
    g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
    s1, s2 = reparam.draw_seed(g1, "cpu"), reparam.draw_seed(g2, "cpu")
    assert s1.dtype == torch.int32 and torch.equal(s1, s2)
    assert 0 <= int(s1) < reparam.SEED_MAX
    before = reparam.reparam_kl.launches
    m, s = torch.zeros(B, D), torch.ones(B, D)
    reparam.reparam_kl(m, s, 0.35, s1)
    assert reparam.reparam_kl.launches == before
    assert build.loaded() == []
