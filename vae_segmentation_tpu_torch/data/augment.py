"""The training ingest's random affine warp on the device (counterpart of
vae_segmentation_tpu/data/augment.py, which replaces batchgenerators'
augment_spatial as main_source.py:197-206 configures it):

  * per sample, a rotation drawn uniform in (-0.2, 0.2) rad about each axis,
    composed Rx @ Ry @ Rz and applied as M^T @ coords;
  * a scale from batchgenerators' split draw: half the time uniform in
    (0.85, 1), half the time in (1, 1.15), multiplying the zero-centred
    output coordinates;
  * a crop centre uniform in [p/2 - 5, n - (p/2 - 5)] per axis;
  * the image trilinear (order 1) with the hard border -1024, the label
    nearest with the border 0: every voxel whose coordinate leaves
    [0, n - 1] on any axis takes the fill value (scipy's 'constant' mode,
    an explicit ``inside`` mask).

The order-1 interpolation repeats ``jax.scipy.ndimage.map_coordinates``:
the same eight corner products in the same order for the image, and for
the label the nearest index rounded half away from zero (``lax.round``;
torch's rounding goes half to even). ``--aug_order 3`` takes the image
through ``map_coordinates_cubic`` instead, scipy's order-3 spline
(augment.py:106-218 of the JAX package): the mirror-boundary cubic
B-spline prefilter along each axis, then the 64 taps of the cubic B-spline
at mirrored indices, inside the same hard mask. The draws come from a
``torch.Generator`` on the batch's device, so the warp never waits for the
host. The host warp of ``--aug_host`` is ``data/host_augment.py``.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

BORDER_CVAL_DATA = -1024.0
ROT_RANGE = 0.2             # radians, per axis (main_source.py:201-202)
SCALE_RANGE = (0.85, 1.15)  # main_source.py:199


def sample_affine_params(generator: torch.Generator, batch: int,
                         patch_size: Sequence[int], in_shape: Sequence[int]
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(angles [B, 3], scale [B], centre [B, 3]), f32 on the generator's
    device: batchgenerators' law for the reference's configuration
    (augment.py:69-88 of the JAX package)."""
    dev = generator.device

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    angles = (2.0 * uniform(batch, 3) - 1.0) * ROT_RANGE
    zoom_in = uniform(batch) < 0.5
    u = uniform(batch)
    scale = torch.where(zoom_in,
                        SCALE_RANGE[0] + u * (1.0 - SCALE_RANGE[0]),
                        1.0 + u * (SCALE_RANGE[1] - 1.0))
    dist = torch.tensor([p // 2 - 5 for p in patch_size], dtype=torch.float32,
                        device=dev)
    shape = torch.tensor(list(in_shape), dtype=torch.float32, device=dev)
    centre = dist + uniform(batch, 3) * (shape - 2.0 * dist)
    return angles, scale, centre


def rotation_matrix(angles: torch.Tensor) -> torch.Tensor:
    """[..., 3] angles -> [..., 3, 3] Rx @ Ry @ Rz (batchgenerators'
    composition order), f32."""
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c[..., 0]), torch.zeros_like(c[..., 0])

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    rx = mat([[one, zero, zero], [zero, c[..., 0], -s[..., 0]],
              [zero, s[..., 0], c[..., 0]]])
    ry = mat([[c[..., 1], zero, s[..., 1]], [zero, one, zero],
              [-s[..., 1], zero, c[..., 1]]])
    rz = mat([[c[..., 2], -s[..., 2], zero], [s[..., 2], c[..., 2], zero],
              [zero, zero, one]])
    return _matmul3(_matmul3(rx, ry), rz)


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] @ [..., 3, 3] as explicit f32 products and sums (no
    reduced-precision matmul path on the card)."""
    return (a[..., :, 0, None] * b[..., 0, None, :]
            + a[..., :, 1, None] * b[..., 1, None, :]
            + a[..., :, 2, None] * b[..., 2, None, :])


def zero_centered_mesh(patch_size: Sequence[int], device=None,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[3, D, H, W] coordinate mesh centred at 0 (batchgenerators
    create_zero_centered_coordinate_mesh)."""
    axes = [torch.arange(p, dtype=dtype, device=device) - (p - 1) / 2.0
            for p in patch_size]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=0)


def affine_coords(angles: torch.Tensor, scale: torch.Tensor,
                  centre: torch.Tensor, patch_size: Sequence[int]
                  ) -> torch.Tensor:
    """The sampling grid [B, 3, *patch] of the given draws, in their dtype
    (f32 on the training path): M^T @ mesh, then * scale, then + centre
    (augment.py:91-102 of the JAX package)."""
    mesh = zero_centered_mesh(patch_size, angles.device,
                              angles.dtype).reshape(3, -1)
    m = rotation_matrix(angles)                          # [B, 3, 3]
    # (M^T @ mesh)[i] = sum_k M[k, i] mesh[k]
    coords = (m[:, 0, :, None] * mesh[0] + m[:, 1, :, None] * mesh[1]
              + m[:, 2, :, None] * mesh[2])              # [B, 3, N]
    coords = coords * scale[:, None, None] + centre[:, :, None]
    return coords.reshape(angles.shape[0], 3, *patch_size)


def _gather(vol: torch.Tensor, i0, i1, i2) -> torch.Tensor:
    """vol [B, D, H, W] at integer indices [B, N] (already in range)."""
    _, d, h, w = vol.shape
    flat = (i0 * h + i1) * w + i2
    return torch.gather(vol.reshape(vol.shape[0], -1), 1, flat)


# ---- the cubic spline of --aug_order 3 (scipy map_coordinates, order 3,
# mode 'constant': the mirror prefilter, mirrored taps, and the caller's
# hard mask; augment.py:106-190 of the JAX package)

SPLINE_POLE = float(np.sqrt(3.0) - 2.0)
SPLINE_GAIN = 6.0   # (1 - z) * (1 - 1/z) for the cubic pole


@functools.lru_cache(maxsize=None)
def prefilter_matrix(n: int) -> np.ndarray:
    """The cubic B-spline prefilter along an axis of length n, mirror
    boundary, as its exact linear map M (f64, [n, n]: coef = M @ x): the
    JAX package's recursion (the exact Unser init of the causal pass, then
    the anticausal pass) run on the identity in f64. One product with M
    replaces ~2n dependent steps of the recursion."""
    if n == 1:
        return np.eye(1)
    z = SPLINE_POLE
    x = np.eye(n) * SPLINE_GAIN
    k = np.arange(n, dtype=np.float64)
    w0 = z ** k + np.where((k > 0) & (k < n - 1), z ** (2.0 * (n - 1) - k),
                           0.0)
    w0[n - 1] = z ** (n - 1.0)
    cp = np.empty_like(x)
    cp[0] = (w0 @ x) / (1.0 - z ** (2.0 * (n - 1)))
    for i in range(1, n):
        cp[i] = x[i] + z * cp[i - 1]
    cm = np.empty_like(x)
    cm[n - 1] = z / (z * z - 1.0) * (z * cp[n - 2] + cp[n - 1])
    for i in range(n - 2, -1, -1):
        cm[i] = z * (cm[i + 1] - cp[i])
    return cm


def spline_coefficients(vol: torch.Tensor) -> torch.Tensor:
    """The cubic B-spline coefficients of a batch vol [B, D, H, W]: the
    prefilter along axes 1-3, each one f64 product with its
    ``prefilter_matrix`` (f64 takes no TF32 path), returned in vol's
    dtype."""
    coef = vol.to(torch.float64)
    for ax in (1, 2, 3):
        m = torch.from_numpy(prefilter_matrix(vol.shape[ax])).to(vol.device)
        coef = torch.movedim(torch.movedim(coef, ax, -1) @ m.T, -1, ax)
    return coef.to(vol.dtype)


def _bspline_weights(t: torch.Tensor):
    """The cubic B-spline basis at fraction t for the taps -1, 0, 1, 2."""
    t2, t3 = t * t, t * t * t
    return ((1.0 - t) ** 3 / 6.0,
            (3.0 * t3 - 6.0 * t2 + 4.0) / 6.0,
            (-3.0 * t3 + 3.0 * t2 + 3.0 * t + 1.0) / 6.0,
            t3 / 6.0)


def _mirror_idx(i: torch.Tensor, n: int) -> torch.Tensor:
    if n == 1:
        return torch.zeros_like(i)
    p = 2 * (n - 1)
    j = torch.remainder(i.abs(), p)
    return torch.where(j < n, j, p - j)


def _cubic(coef: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The spline with coefficients coef [B, D, H, W] at c [B, 3, N]:
    [B, N], the 64 taps accumulated in place in the JAX package's order."""
    sizes = coef.shape[1:]
    flat = coef.reshape(coef.shape[0], -1)
    lower = [torch.floor(c[:, ax]) for ax in range(3)]
    wts = [_bspline_weights(c[:, ax] - lower[ax]) for ax in range(3)]
    idx = [[_mirror_idx(lower[ax].to(torch.int64) + (k - 1), sizes[ax])
            for k in range(4)] for ax in range(3)]
    out = torch.zeros(c[:, 0].shape, dtype=coef.dtype, device=coef.device)
    for ka in range(4):
        base_a = idx[0][ka] * (sizes[1] * sizes[2])
        for kb in range(4):
            base = base_a + idx[1][kb] * sizes[2]
            wab = wts[0][ka] * wts[1][kb]
            for kc in range(4):
                out.add_(wab * wts[2][kc]
                         * torch.gather(flat, 1, base + idx[2][kc]))
    return out


def map_coordinates_cubic(vol: torch.Tensor, coords: torch.Tensor
                          ) -> torch.Tensor:
    """Order-3 interpolation of vol [D, H, W] at coords [3, *out] (or a
    batch: [B, D, H, W] at [B, 3, *out]), in vol's dtype; the taps use
    mirror extension as scipy does, and the out-of-domain mask is the
    caller's (``warp_at``)."""
    batched = vol.dim() == 4
    v = vol if batched else vol[None]
    c = coords if batched else coords[None]
    out = _cubic(spline_coefficients(v), c.reshape(c.shape[0], 3, -1))
    out = out.reshape(c.shape[0], *c.shape[2:])
    return out if batched else out[0]


def _trilinear(image: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Order 1 at c [B, 3, N]: per axis (lower index, 1 - frac), (lower +
    1, frac); the eight corners summed in map_coordinates' order, weights
    multiplied axis 0 first. Corners off the volume carry weight 0 inside
    the mask."""
    sizes = image.shape[1:]
    nodes = []
    for ax in range(3):
        lower = torch.floor(c[:, ax])
        upper_w = c[:, ax] - lower
        idx = lower.to(torch.int64)
        n = sizes[ax]
        nodes.append(((idx.clamp(0, n - 1), 1.0 - upper_w),
                      ((idx + 1).clamp(0, n - 1), upper_w)))
    img = None
    for i0, w0 in nodes[0]:
        for i1, w1 in nodes[1]:
            for i2, w2 in nodes[2]:
                term = w0 * w1 * w2 * _gather(image, i0, i1, i2)
                img = term if img is None else img + term
    return img


def warp_with_params(image: torch.Tensor, label: torch.Tensor,
                     angles: torch.Tensor, scale: torch.Tensor,
                     centre: torch.Tensor, patch_size: Sequence[int],
                     order: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp a batch (image, label [B, D, H, W]) with the given draws into
    [B, *patch] (augment.py:193-219 of the JAX package); order 1 trilinear,
    3 the cubic spline."""
    return warp_at(image, label, affine_coords(angles, scale, centre,
                                               patch_size), order)


def warp_at(image: torch.Tensor, label: torch.Tensor, coords: torch.Tensor,
            order: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp a batch (image, label [B, D, H, W]) at the sampling grid coords
    [B, 3, *patch] into [B, *patch]: the image at `order` (1 or 3), the
    label nearest, every voxel whose coordinate leaves [0, n - 1] on an
    axis the fill value."""
    if order not in (1, 3):
        raise ValueError(f"order {order}: the warp takes 1 or 3")
    patch_size = tuple(coords.shape[2:])
    b = image.shape[0]
    c = coords.reshape(b, 3, -1)
    sizes = image.shape[1:]
    inside = torch.ones_like(c[:, 0], dtype=torch.bool)
    for ax in range(3):
        inside &= (c[:, ax] >= 0.0) & (c[:, ax] <= sizes[ax] - 1.0)
    img = _cubic(spline_coefficients(image), c) if order == 3 \
        else _trilinear(image, c)

    # nearest, rounded half away from zero (exact in f32: c - floor(c) is)
    near = []
    for ax in range(3):
        f = torch.floor(c[:, ax])
        r = f + (c[:, ax] - f >= 0.5).to(f.dtype)
        near.append(r.to(torch.int64).clamp(0, sizes[ax] - 1))
    lab = _gather(label, *near)

    fill = torch.full_like(img, BORDER_CVAL_DATA)
    img = torch.where(inside, img, fill)
    lab = torch.where(inside, lab, torch.zeros_like(lab))
    out_shape = (b, *patch_size)
    return img.reshape(out_shape), lab.reshape(out_shape)


def spatial_augment(images: torch.Tensor, labels: torch.Tensor,
                    generator: torch.Generator,
                    patch_size: Sequence[int] = (128, 128, 128),
                    order: int = 1, items: Optional[slice] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random affine warp of a batch (images, labels [B, D, H, W] f32 on
    the generator's device) into [B, *patch]: one draw per sample
    (augment.py:229-237 of the JAX package); order 3 is --aug_order 3.
    `items`: warp only these items (a rank's share of the batch); the draws
    are the whole batch's all the same, so the generator moves as in one
    process and each item gets its one-process warp (a 3D warp mixes D, so
    a rank warps its items whole and keeps its planes afterwards)."""
    angles, scale, centre = sample_affine_params(
        generator, images.shape[0], patch_size, images.shape[1:])
    if items is not None:
        images, labels = images[items], labels[items]
        angles, scale, centre = angles[items], scale[items], centre[items]
    return warp_with_params(images, labels, angles, scale, centre,
                            patch_size, order)
