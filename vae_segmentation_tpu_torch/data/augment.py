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

The interpolation repeats ``jax.scipy.ndimage.map_coordinates``: the same
eight corner products in the same order for the image, and for the label
the nearest index rounded half away from zero (``lax.round``; torch's
rounding goes half to even). The draws come from a ``torch.Generator`` on
the batch's device, so the warp never waits for the host. The JAX package's
``--aug_order 3`` cubic spline and the host warp (``--aug_host``) are not
ported (ROADMAP queue 1, item 3).
"""

from __future__ import annotations

from typing import Sequence, Tuple

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


def zero_centered_mesh(patch_size: Sequence[int], device=None
                       ) -> torch.Tensor:
    """[3, D, H, W] coordinate mesh centred at 0 (batchgenerators
    create_zero_centered_coordinate_mesh)."""
    axes = [torch.arange(p, dtype=torch.float32, device=device) - (p - 1) / 2.0
            for p in patch_size]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=0)


def affine_coords(angles: torch.Tensor, scale: torch.Tensor,
                  centre: torch.Tensor, patch_size: Sequence[int]
                  ) -> torch.Tensor:
    """The sampling grid [B, 3, *patch] of the given draws, f32: M^T @ mesh,
    then * scale, then + centre (augment.py:91-102 of the JAX package)."""
    mesh = zero_centered_mesh(patch_size, angles.device).reshape(3, -1)
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


def warp_with_params(image: torch.Tensor, label: torch.Tensor,
                     angles: torch.Tensor, scale: torch.Tensor,
                     centre: torch.Tensor, patch_size: Sequence[int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp a batch (image, label [B, D, H, W] f32) with the given draws
    into [B, *patch] (augment.py:193-219 of the JAX package, order 1)."""
    coords = affine_coords(angles, scale, centre, patch_size)
    b = image.shape[0]
    c = coords.reshape(b, 3, -1)
    sizes = image.shape[1:]
    inside = torch.ones_like(c[:, 0], dtype=torch.bool)
    for ax in range(3):
        inside &= (c[:, ax] >= 0.0) & (c[:, ax] <= sizes[ax] - 1.0)

    # trilinear: per axis (lower index, 1 - frac), (lower + 1, frac); the
    # eight corners summed in map_coordinates' order, weights multiplied
    # axis 0 first. Corners off the volume carry weight 0 inside the mask.
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
                    patch_size: Sequence[int] = (128, 128, 128)
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random affine warp of a batch (images, labels [B, D, H, W] f32 on
    the generator's device) into [B, *patch]: one draw per sample
    (augment.py:229-237 of the JAX package, order 1)."""
    angles, scale, centre = sample_affine_params(
        generator, images.shape[0], patch_size, images.shape[1:])
    return warp_with_params(images, labels, angles, scale, centre,
                            patch_size)
