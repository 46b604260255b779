"""Auxiliary analysis utilities (reference utils/utils.py:639-924 — the
legacy/registration-era helpers that remain part of the public surface).
Copy of the JAX package's utils/legacy.py; ``get_parameter_number``
counts an ``nn.Module``'s parameters.

All are host-side numpy/scipy tooling; nothing here is in the device hot
loop. The reference's registration-model helpers (`align_volume`) and
SimpleITK IO are intentionally not carried over: no registration model
exists anywhere in the reference's shipped recipes, and NIfTI IO lives in
data/preprocess.py (nibabel).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
from scipy import ndimage


def get_synthesis_mask(data_dict: Dict, field: str = "venous") -> Dict:
    """Bone(>200 HU, dilated x2) + air(<0 HU) exclusion mask
    (utils/utils.py:647-655)."""
    bone = data_dict[field] > 200
    bone = ndimage.binary_dilation(bone, iterations=2)
    air = data_dict[field] < 0
    data_dict[field + "_syn_mask"] = (
        (~air) & (~bone)).astype(np.float32)
    return data_dict


def mutual_information_3d(x: np.ndarray, y: np.ndarray, sigma: float = 1,
                          normalized: bool = True) -> float:
    """(Normalized) mutual information from a smoothed 256x256 joint
    histogram (utils/utils.py:804-845; Studholme et al. 1998 NMI)."""
    eps = np.finfo(float).eps
    jh = np.histogram2d(np.ravel(x), np.ravel(y), bins=(256, 256))[0]
    ndimage.gaussian_filter(jh, sigma=sigma, mode="constant", output=jh)
    jh = jh + eps
    jh = jh / np.sum(jh)
    s1 = np.sum(jh, axis=0).reshape((-1, jh.shape[0]))
    s2 = np.sum(jh, axis=1).reshape((jh.shape[1], -1))
    if normalized:
        return float((np.sum(s1 * np.log(s1)) + np.sum(s2 * np.log(s2)))
                     / np.sum(jh * np.log(jh)) - 1)
    return float(np.sum(jh * np.log(jh)) - np.sum(s1 * np.log(s1))
                 - np.sum(s2 * np.log(s2)))


def plot_slides(v: np.ndarray, display_type: str = "TB") -> np.ndarray:
    """Slice mosaic of a [D, H, W] volume on a near-square board
    (utils/utils.py:846-882). 'TB' -> [0,1] floats; 'CV2' -> 0..255 ints."""
    d, h, w = v.shape
    side_w = int(np.ceil(np.sqrt(d)))
    side_h = int(np.ceil(float(d) / side_w))
    board = np.zeros(((h + 1) * side_h, (w + 1) * side_w, 3))
    lo, hi = float(np.min(v)), float(np.max(v))
    v_n = (v - lo) / (hi - lo + 1e-12)
    if display_type == "CV2":
        v_n = (v_n * 255).astype(int)
    for i in range(side_h):
        for j in range(side_w):
            if i * side_w + j >= d:
                break
            tile = v_n[i * side_w + j]
            for k in range(3):
                board[(h + 1) * i + 1:(h + 1) * (i + 1),
                      (w + 1) * j + 1:(w + 1) * (j + 1), k] = tile
    return board.astype(int) if display_type == "CV2" else board


def create_grid_images(source: np.ndarray, target: np.ndarray,
                       source_aligned: np.ndarray, save_folder: str,
                       slice_num: int = 20, min_win: float = -280,
                       max_win: float = 420) -> None:
    """Checkerboard alignment comparison panels saved as PNGs
    (utils/utils.py:692-740). Inputs are [D, H, W] numpy volumes (the
    reference took SimpleITK images; this takes arrays directly)."""
    import imageio.v2 as imageio
    from vae_segmentation_tpu_torch.data.resize import resize_volume

    def prep(vol):
        s = vol[slice_num]
        if s.shape[0] != 512:
            s = resize_volume(s[None], (1, 512, 512), order=1)[0]
        return s

    s_np, t_np, sa_np = prep(source), prep(target), prep(source_aligned)
    checkerboard = np.kron([[1, 0] * 16, [0, 1] * 16] * 16,
                           np.ones((16, 16)))
    orig_check = s_np * checkerboard + (1 - checkerboard) * t_np
    align_check = sa_np * checkerboard + (1 - checkerboard) * t_np

    os.makedirs(save_folder, exist_ok=True)
    names = ["source.png", "target.png", "source_align.png",
             "orig_check.png", "align_check.png"]
    for image, suffix in zip([s_np, t_np, sa_np, orig_check, align_check],
                             names):
        image = np.clip(image, min_win, max_win)
        image = (image - min_win) / (max_win - min_win) * 255
        imageio.imwrite(os.path.join(save_folder, suffix),
                        image.astype(np.uint8))


def masked_mse_loss(data_dict: Dict, do_mask: bool = True,
                    source_key: str = "align_arterial",
                    target_key: str = "venous",
                    mask_key: str = "venous_reg_mask") -> float:
    """The reference's `standard_loss` (utils/utils.py:884-911): MSE between
    target and (mask-blended) source(s); multi-output models contribute a
    summed loss."""
    sources = data_dict[source_key]
    if not isinstance(sources, list):
        sources = [sources]
    total = 0.0
    mask = data_dict.get(mask_key)
    target = data_dict[target_key]
    for im in sources:
        blended = mask * im + (1 - mask) * target if do_mask else im
        data_dict["dummy_align_venous"] = blended
        total += float(np.mean((target - blended) ** 2))
    return total


def smoothness_loss(data_dict: Dict) -> float:
    """utils/utils.py:912-914."""
    return float(np.mean(data_dict["smooth_dform"]))


def get_parameter_number(model) -> Dict[str, int]:
    """Total/trainable parameter counts of a torch ``nn.Module``
    (utils/utils.py:919-924; the JAX package counts a flax param tree,
    where every leaf is trainable)."""
    total = sum(p.numel() for p in model.parameters())
    trainable = sum(p.numel() for p in model.parameters()
                    if p.requires_grad)
    print("Total: {}".format(total))
    print("Trainable: {}".format(trainable))
    return {"Total": total, "Trainable": trainable}
