"""Host-side (numpy) data transforms — the pre-device part of the pipeline.

These reproduce, byte-for-byte where practical, the transform chain the
reference builds in main_source.py:189-228 up to the device boundary:

  NumpyLoader_Multi_merge (utils/utils.py:326-383)  -> load_merge_case
  CropResize              (utils/utils.py:220-293)  -> crop_resize
  pan_index mini-DSL      (main_source.py:92-95)    -> parse_pan_index

Copy of the JAX package's data/transforms.py: a case loads through the
native loader (``data/native_loader.py``) where the JAX package takes its
native path, numpy otherwise. Everything downstream (clip, center, one-hot)
runs on the device.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vae_segmentation_tpu_torch.data import native_loader
from vae_segmentation_tpu_torch.data.manifest import case_id
from vae_segmentation_tpu_torch.data.resize import resize_volume

MaskIndex = List[List]  # [[raw_label(s), class_id], ...]


def parse_pan_index(pan_index: str) -> MaskIndex:
    """The reference's pan_index mini-DSL (main_source.py:92-95):
    '1'  -> {1->1};  '10' -> {1,2}->1 (MSD);  '11' -> {11->1} (Synapse);
    comma lists -> multiclass."""
    if pan_index != "10":
        return [[0, 0]] + [[int(f), idx + 1]
                           for idx, f in enumerate(pan_index.split(","))]
    return [[0, 0], [[1, 2], 1]]


def remap_labels(raw: np.ndarray, mask_index: Optional[MaskIndex]) -> np.ndarray:
    """Raw dataset labels -> class ids per mask_index (utils/utils.py:366-374)."""
    if mask_index is None:
        return raw.astype(np.float32)
    out = np.zeros_like(raw, dtype=np.float32)
    for entry in mask_index:
        raw_labels, cls = entry
        if not isinstance(raw_labels, list):
            raw_labels = [raw_labels]
        for lab in raw_labels:
            out[raw == lab] = cls
    return out


def load_merge_case(root_dir: str, entry: str,
                    mask_index: Optional[MaskIndex] = None
                    ) -> Dict[str, np.ndarray]:
    """Load <root>/<case>/merge.npy: channel 0 image, channel 1 raw label
    (utils/utils.py:347-383). Returns {'id', 'image', 'label'} and, from
    the native loader, 'bbox' (the label's, for ``crop_resize``).

    The native loader (mmap, channel split, remap and bbox in one pass off
    the GIL) takes every case with a mask_index whose npy header is in its
    subset (``native_loader.in_subset``); ``load_merge_numpy`` the rest, as
    in the JAX package."""
    path = os.path.join(root_dir, entry)
    if mask_index is not None and native_loader.in_subset(path):
        out = native_loader.load_case(path, mask_index)
    else:
        out = load_merge_numpy(path, mask_index)
    out["id"] = case_id(entry)
    return out


def load_merge_numpy(path: str, mask_index: Optional[MaskIndex] = None
                     ) -> Dict[str, np.ndarray]:
    """The numpy path of ``load_merge_case``: {'image', 'label'}."""
    merge = np.load(path)
    return {"image": merge[..., 0].astype(np.float32),
            "label": remap_labels(merge[..., 1], mask_index)}


def _crop_bounds(center: np.ndarray, half: int, pad: int, shift: int,
                 shape: Sequence[int]) -> List[Tuple[int, int]]:
    return [(max(int(center[d]) - half - pad + shift, 0),
             min(int(center[d]) + half + pad + shift, shape[d]))
            for d in range(3)]


def label_bbox(label: np.ndarray):
    """(bbox_min, bbox_max) of label > 0 via axis projections (the argwhere
    sweep the reference does, utils/utils.py:259-263, costs ~0.6 s on a
    256^3 volume; three any-reductions cost ~30 ms). None when empty."""
    fg = label > 0
    proj = [np.any(fg, axis=ax) for ax in ((1, 2), (0, 2), (0, 1))]
    if not bool(proj[0].any()):
        return None
    nz = [np.nonzero(p)[0] for p in proj]
    return (np.array([n[0] for n in nz]), np.array([n[-1] for n in nz]))


def crop_resize(image: np.ndarray, label: np.ndarray,
                output_size: Sequence[int] = (128, 128, 128), *,
                shift: int = 0,
                bbox: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """ROI cube crop + resize to output_size (utils/utils.py:232-293).

    bbox of label>0; center cube of side L = max bbox extent, padded by
    int(0.1 * L); pad-to-cube with zeros; linear+AA resize for the image,
    nearest for the label. Empty-mask fallback center (64,64,64), L=32
    (utils/utils.py:264-267). `shift` offsets the crop (the --shift flag,
    main_target.py:81,204). `bbox` may carry a precomputed
    [dmin,hmin,wmin,dmax,hmax,wmax] (all -1 == empty) from the native
    loader; otherwise the projection-based sweep runs here.

    Returns {'image', 'label', 'ori_shape'} where ori_shape is the 6-vector
    [orig D,H,W, cropped D,H,W] the reference records (utils/utils.py:270-279).
    """
    if bbox is not None:
        bb = (None if int(bbox[3]) < 0
              else (np.asarray(bbox[:3]), np.asarray(bbox[3:])))
    else:
        bb = label_bbox(label)
    if bb is not None:
        bbox_min, bbox_max = bb
        center = (bbox_max + bbox_min) // 2
        L = int((bbox_max - bbox_min).max())
    else:
        center = np.array([64, 64, 64])
        L = 32
    pad_width = int(L * 0.1)
    half = L // 2
    ori_shape = list(label.shape)

    def crop_pad(vol: np.ndarray) -> np.ndarray:
        b = _crop_bounds(center, half, pad_width, shift, vol.shape)
        cropped = vol[b[0][0]:b[0][1], b[1][0]:b[1][1], b[2][0]:b[2][1]]
        target = L + pad_width * 2
        diff = [target - s for s in cropped.shape]
        axis_pad = [(int(d / 2), d - int(d / 2)) for d in diff]
        return np.pad(cropped, axis_pad)

    label_c = crop_pad(label)
    ori_shape += list(label_c.shape)
    image_c = crop_pad(image)
    return {
        "image": resize_volume(image_c, output_size, order=1),
        "label": resize_volume(label_c, output_size, order=0),
        "ori_shape": np.array(ori_shape),
    }
