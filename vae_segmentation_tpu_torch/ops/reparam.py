"""The VAE's reparameterised latent and its KL term, fused, with the normal
sample drawn inside the kernel (counterpart of vae_segmentation_tpu/ops/
pallas/reparam.py; reference joint_model.py:246-250 and
utils/evaluation.py:42-45):

    latent = mean + eps * std * scale
    kl     = 0.5 * sum(std^2 + mean^2 - 2 log(std + 1e-5)) / B

over [B, D] f32 latent statistics, the KL being the batch mean of the
per-sample sums. ``reparam_kl_op`` launches the hand-written kernel
(``kernels/csrc/reparam.cu``, replacing ``reparam.py::_run``) on CUDA
tensors, or raises; on CPU tensors it runs the plain version. Both draw eps
from the same counter-based generator, Philox4x32-10 keyed by the seed, and
the TPU kernel's Box-Muller recipe (the top 24 bits of a word to a uniform,
u1 clamped at 1e-7, the cosine branch): the kernel in CUDA, the plain
``philox_normal_plain`` in PyTorch integer arithmetic. The stream is not
JAX's; tests hand JAX's eps to ``reparam_kl_plain``.

``reparam_kl`` is the differentiable use: a ``torch.autograd.Function``
whose backward is the analytic VJP of reparam.py:146-159 (plain torch, as
the JAX package leaves it to XLA); the seed gets no gradient and eps is a
residual. ``reparam_kl.launches`` counts kernel launches (never the plain
version).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from vae_segmentation_tpu_torch.ops.conv3 import check_tensor, raise_if

KL_EPS = 1e-5
SEED_MAX = 2 ** 31 - 1          # seeds are drawn from [0, SEED_MAX)

_M0, _M1 = 0xD2511F53, 0xCD9E8D57   # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85   # and key increments
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of m * x for int64 tensors x < 2^32, through
    16-bit limbs so that no product leaves int64."""
    m_hi, m_lo = m >> 16, m & 0xFFFF
    x_hi, x_lo = x >> 16, x & 0xFFFF
    lo_lo = m_lo * x_lo
    mid = m_hi * x_lo + m_lo * x_hi + (lo_lo >> 16)       # < 2^34
    lo = ((mid & 0xFFFF) << 16) | (lo_lo & 0xFFFF)
    hi = m_hi * x_hi + (mid >> 16)
    return hi & _MASK32, lo


def philox4x32_10(counter: Tuple[torch.Tensor, ...], key: Tuple[int, int]
                  ) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 on int64 tensors holding 32-bit words: four counter
    words, a two-word key; returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _uniform24(bits: torch.Tensor) -> torch.Tensor:
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def philox_normal_plain(seed: int, shape, device=None) -> torch.Tensor:
    """The kernel's standard normal draw in plain PyTorch: element i of the
    flattened `shape` takes Philox4x32-10 of the counter (i, 0, 0, 0) under
    the key (seed, 0), words 0 and 1 -> (u1, u2), then
    sqrt(-2 log max(u1, 1e-7)) * cos(2 pi u2) in f32."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    zero = torch.zeros_like(idx)
    w0, w1, _, _ = philox4x32_10((idx, zero, zero, zero),
                                 (int(seed) & _MASK32, 0))
    u1 = torch.clamp(_uniform24(w0), min=1e-7)
    u2 = _uniform24(w1)
    two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32, device=device)
    eps = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)
    return eps.reshape(shape)


def reparam_kl_plain(mean: torch.Tensor, std: torch.Tensor, scale: float,
                     eps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(latent [B, D], kl scalar) in f32 from the given eps (the JAX
    package's off-TPU path, reparam.py:97-107)."""
    mean, std, eps = mean.float(), std.float(), eps.float()
    latent = mean + eps * std * scale
    kl = 0.5 * (std * std + mean * mean
                - 2.0 * torch.log(std + KL_EPS)).sum() / mean.shape[0]
    return latent, kl


def reparam_kl_seeded_plain(mean: torch.Tensor, std: torch.Tensor,
                            scale: float, seed: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The plain version of the whole kernel, draw included: eps from
    ``philox_normal_plain``, then ``reparam_kl_plain``. Returns (latent, kl,
    eps) like ``reparam_kl_op``; reads the seed on the host."""
    eps = philox_normal_plain(int(seed.reshape(-1)[0]), tuple(mean.shape),
                              device=mean.device)
    return (*reparam_kl_plain(mean, std, scale, eps), eps)


def reparam_kl_op(mean: torch.Tensor, std: torch.Tensor, scale: float,
                  seed: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(latent [B, D], kl scalar, eps [B, D]), all f32. mean and std are
    [B, D] f32, seed one int32 on their device, drawn from
    [0, ``SEED_MAX``). On CUDA the kernel reads the seed on the device, so
    the caller never waits for the card."""
    if mean.dim() != 2:
        raise ValueError(f"reparam_kl: mean must be [B, D], got "
                         f"{tuple(mean.shape)}")
    if mean.device.type == "cpu":
        return reparam_kl_seeded_plain(mean, std, scale, seed)
    if mean.device.type != "cuda":
        raise RuntimeError(f"reparam_kl: no kernel for device {mean.device}")
    from vae_segmentation_tpu_torch.ops.kernels import build

    b, d = mean.shape
    dev = mean.device
    check_tensor("reparam_kl", "mean", mean, dev, torch.float32, (b, d))
    check_tensor("reparam_kl", "std", std, dev, torch.float32, (b, d))
    check_tensor("reparam_kl", "seed", seed.reshape(-1)[:1], dev, torch.int32,
                 (1,))
    latent = torch.empty_like(mean)
    eps = torch.empty_like(mean)
    kl = torch.empty((), dtype=torch.float32, device=dev)
    lib = build.library("reparam")
    with torch.cuda.device(dev):
        rc = lib.vaeseg_reparam_kl(
            mean.data_ptr(), std.data_ptr(), seed.data_ptr(), float(scale),
            latent.data_ptr(), kl.data_ptr(), eps.data_ptr(), b, d,
            torch.cuda.current_stream(dev).cuda_stream)
    raise_if(rc, lib, "reparam_kl")
    reparam_kl.launches += 1
    return latent, kl, eps


class _ReparamKLFn(torch.autograd.Function):
    """``reparam_kl_op`` with the analytic VJP of reparam.py:146-159:
    d_mean = g_latent + (g_kl / B) mean, d_std = g_latent eps scale +
    (g_kl / B) (std - 1 / (std + 1e-5))."""

    @staticmethod
    def forward(ctx, mean, std, seed, scale):
        latent, kl, eps = reparam_kl_op(mean, std, scale, seed)
        ctx.save_for_backward(mean, std, eps)
        ctx.scale = scale
        ctx.mark_non_differentiable(eps)
        return latent, kl, eps

    @staticmethod
    def backward(ctx, g_latent, g_kl, _g_eps):
        mean, std, eps = ctx.saved_tensors
        gk = g_kl.float() / mean.shape[0]
        mean32, std32 = mean.float(), std.float()
        d_mean = g_latent + gk * mean32
        d_std = g_latent * eps * ctx.scale \
            + gk * (std32 - 1.0 / (std32 + KL_EPS))
        return d_mean.to(mean.dtype), d_std.to(std.dtype), None, None


def reparam_kl(mean: torch.Tensor, std: torch.Tensor, scale: float,
               seed: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable (latent, kl, eps) in mean and std: the contract of
    ``reparam_kl_op``."""
    return _ReparamKLFn.apply(mean, std, seed, float(scale))


def draw_seed(generator: torch.Generator, device) -> torch.Tensor:
    """One int32 seed in [0, ``SEED_MAX``) from `generator`, on `device`
    (the generator's): the step draws it without waiting for the card."""
    return torch.randint(0, SEED_MAX, (1,), generator=generator,
                         device=device, dtype=torch.int32)


reparam_kl.launches = 0
