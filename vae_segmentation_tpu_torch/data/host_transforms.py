"""Host-side composable transform library — the numpy dict-to-dict transform
surface of the reference (utils/utils.py:61-635), for offline tooling and
custom pipelines.

The shipped training path does NOT use these for the per-step hot loop: the
intensity/warp math moved on-device into the compiled step (data/augment.py),
and the IO + ROI-crop live in data/transforms.py / data/pipeline.py. This
module exists because the transform LIBRARY is part of the reference's public
surface (SURVEY.md C3/C7/C8) and is handy for scripting.

Every class mirrors the reference semantics at the cited lines; transforms
mutate and return the dict, and compose with `Compose`. Copy of the JAX
package's data/host_transforms.py.
"""

from __future__ import annotations

import random
from copy import copy
from typing import Dict, List, Optional, Sequence

import numpy as np

from vae_segmentation_tpu_torch.data.manifest import case_id
from vae_segmentation_tpu_torch.data.resize import resize_volume
from vae_segmentation_tpu_torch.data.transforms import remap_labels


class BaseTransform:
    """utils/utils.py:90-99: holds the field list; no-op base __call__."""

    def __init__(self, fields: Sequence[str]):
        self.fields = list(fields)

    def __call__(self, data_dict: Dict) -> Dict:
        return data_dict


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseDataset:
    """utils/utils.py:61-88: list-of-entries dataset; __getitem__ copies the
    entry and applies the composed transform chain."""

    def __init__(self, listdict: Sequence, transforms=None):
        self.listdict = list(listdict)
        self.transforms = transforms

    def __len__(self):
        return len(self.listdict)

    def __getitem__(self, idx: int):
        item = copy(self.listdict[idx])
        if self.transforms is not None:
            item = self.transforms(item)
        return item


class NumpyLoaderMultiMerge(BaseTransform):
    """utils/utils.py:326-383: manifest string -> {'id', <f>, <f>_pancreas}
    from <root>/<entry> merge.npy (ch 0 image, ch 1 raw label; labels
    remapped per mask_index; optional ch 2 pred / cached pseudo)."""

    def __init__(self, fields, root_dir="/", middle_path="/",
                 dtype=np.float32, load_mask=False, load_pred=False,
                 load_pseudo=False, mask_index=None):
        super().__init__(fields)
        self.root_dir = root_dir
        self.middle_path = middle_path
        self.dtype = dtype
        self.load_mask = load_mask
        self.load_pred = load_pred
        self.load_pseudo = load_pseudo
        self.mask_index = mask_index

    def __call__(self, input_string: str) -> Dict:
        import os

        out: Dict = {"id": case_id(input_string)}
        for f in self.fields:
            merge = np.load(os.path.join(self.root_dir, input_string))
            out[f] = merge[..., 0].astype(self.dtype)
            if self.load_mask:
                if self.mask_index is None:
                    out[f + "_pancreas"] = merge[..., 1].astype(self.dtype)
                else:
                    out[f + "_pancreas"] = remap_labels(
                        merge[..., 1], self.mask_index).astype(self.dtype)
            if self.load_pseudo:
                fn = os.path.join(self.middle_path,
                                  f"{out['id']}_pred.npy")
                out[f + "_pancreas_pseudo"] = np.load(fn)
            if self.load_pred:
                out[f + "_pancreas_pred"] = merge[..., 2].astype(self.dtype)
        return out


class NumpyLoader(BaseTransform):
    """utils/utils.py:182-218 (simplified surface): <root>/<entry> npy pairs
    <case>/img.npy + <case>/label.npy -> fields."""

    def __init__(self, fields, root_dir="/", dtype=np.float32,
                 load_mask=False):
        super().__init__(fields)
        self.root_dir = root_dir
        self.dtype = dtype
        self.load_mask = load_mask

    def __call__(self, input_string: str) -> Dict:
        import os

        case_dir = os.path.join(self.root_dir,
                                os.path.dirname(input_string))
        out: Dict = {"id": case_id(input_string)}
        for f in self.fields:
            out[f] = np.load(os.path.join(case_dir, "img.npy")) \
                .astype(self.dtype)
            if self.load_mask:
                out[f + "_pancreas"] = np.load(
                    os.path.join(case_dir, "label.npy")).astype(self.dtype)
        return out


class NumpyLoaderMulti(BaseTransform):
    """utils/utils.py:296-323: dict-path npy loader — each field (and,
    with load_mask/load_pred, its `<f>_pancreas` / `<f>_pancreas_pred`
    companion) holds a path relative to root_dir, replaced in place by the
    loaded array. Entries whose value is falsy are skipped, mirroring the
    reference's `data_dict.get(...)` guards."""

    def __init__(self, fields, root_dir="/", dtype=np.float32,
                 load_mask=False, load_pred=False):
        super().__init__(fields)
        self.root_dir = root_dir
        self.dtype = dtype
        self.load_mask = load_mask
        self.load_pred = load_pred

    def __call__(self, data_dict: Dict) -> Dict:
        import os

        out = dict(data_dict)
        for f in self.fields:
            if out.get(f) is not None:
                out[f] = np.load(os.path.join(self.root_dir, out[f])) \
                    .astype(self.dtype)
            if self.load_mask and out.get(f + "_pancreas", None):
                out[f + "_pancreas"] = np.load(os.path.join(
                    self.root_dir, out[f + "_pancreas"])).astype(self.dtype)
            if self.load_pred and out.get(f + "_pancreas_pred", None):
                out[f + "_pancreas_pred"] = np.load(os.path.join(
                    self.root_dir, out[f + "_pancreas_pred"])) \
                    .astype(self.dtype)
        return out


class ReadNPY(BaseTransform):
    """utils/utils.py:153-180: read already-loaded arrays from a dict entry
    {'img': path, 'label': path}."""

    def __init__(self, fields, dtype=np.float32):
        super().__init__(fields)
        self.dtype = dtype

    def __call__(self, entry: Dict) -> Dict:
        out = dict(entry)
        for f in self.fields:
            if isinstance(out.get(f), str):
                out[f] = np.load(out[f]).astype(self.dtype)
        return out


class NiiLoader(BaseTransform):
    """utils/utils.py:126-152 capability: load NIfTI volumes into fields.
    The reference used SimpleITK; this uses nibabel (the same library the
    preprocessing CLI depends on), imported lazily so the pure-npy pipeline
    has no NIfTI dependency."""

    def __init__(self, fields, root_dir="/", dtype=np.float32,
                 load_mask=False):
        super().__init__(fields)
        self.root_dir = root_dir
        self.dtype = dtype
        self.load_mask = load_mask

    def __call__(self, entry) -> Dict:
        import os

        import nibabel as nib

        out: Dict = dict(entry) if isinstance(entry, dict) else {}
        paths = entry if isinstance(entry, dict) else {f: entry
                                                       for f in self.fields}
        for f in self.fields:
            img = nib.load(os.path.join(self.root_dir, paths[f]))
            out[f] = np.asarray(img.dataobj).astype(self.dtype)
            out[f + "_affine"] = np.asarray(img.affine)
            if self.load_mask and isinstance(entry, dict) \
                    and entry.get(f + "_label"):
                lab = nib.load(os.path.join(self.root_dir,
                                            entry[f + "_label"]))
                out[f + "_pancreas"] = np.asarray(lab.dataobj) \
                    .astype(self.dtype)
        return out


class CopyField(BaseTransform):
    """utils/utils.py:102-123."""

    def __init__(self, fields, to_field):
        super().__init__(fields)
        assert len(self.fields) == 1
        self.to_field = to_field if isinstance(to_field, list) else [to_field]
        assert len(self.to_field) == 1

    def __call__(self, data_dict):
        data_dict[self.to_field[0]] = copy(data_dict[self.fields[0]])
        return data_dict


class PadToSize(BaseTransform):
    """utils/utils.py:387-459: center-pad up to `size` (image pad_val, mask
    seg_pad_val); when larger, crop a (random or max-corner) sub-window,
    applied consistently to the mask fields."""

    def __init__(self, fields, size, pad_val=0, seg_pad_val=0,
                 random_subpadding=True, load_mask=False):
        super().__init__(fields)
        self.size = np.array(size, dtype=int)
        self.pad_val = pad_val
        self.seg_pad_val = seg_pad_val
        self.random_subpadding = random_subpadding
        self.load_mask = load_mask

    def __call__(self, data_dict):
        for field in self.fields:
            val = data_dict.get(field)
            if val is None:
                continue
            orig = np.array(val.shape, dtype=int)
            mask_keys = [field + "_lung", field + "_pancreas"] \
                if self.load_mask else []
            if np.any(self.size > orig):
                diff = np.maximum(self.size - orig, 0)
                pw = [(int(d / 2), d - int(d / 2)) for d in diff]
                data_dict[field] = np.pad(val, pw, constant_values=self.pad_val)
                for mk in mask_keys:
                    if data_dict.get(mk) is not None:
                        data_dict[mk] = np.pad(
                            data_dict[mk], pw,
                            constant_values=self.seg_pad_val)
            if np.any(orig > self.size):
                maxes = [max(m, 0) for m in (orig - self.size)]
                if self.random_subpadding:
                    start = [random.randint(0, m) for m in maxes]
                else:
                    start = maxes
                sl = tuple(slice(s, s + z) for s, z in zip(start, self.size))
                data_dict[field] = data_dict[field][sl]
                for mk in mask_keys:
                    if data_dict.get(mk) is not None:
                        data_dict[mk] = data_dict[mk][sl]
        return data_dict


class Reshape(BaseTransform):
    """utils/utils.py:462-482: reshape to `reshape_view`, default
    [-1, 1, *shape]."""

    def __init__(self, fields, reshape_view=None):
        super().__init__(fields)
        self.reshape_view = reshape_view

    def __call__(self, data_dict):
        for field in self.fields:
            v = data_dict.get(field)
            if isinstance(v, np.ndarray):
                view = self.reshape_view if self.reshape_view is not None \
                    else [-1, 1] + list(v.shape)
                data_dict[field] = v.reshape(view)
        return data_dict


class ExtendSqueeze(BaseTransform):
    """utils/utils.py:485-505: mode 1 expand_dims, mode 0 squeeze."""

    def __init__(self, fields, dimension=-1, mode=1):
        super().__init__(fields)
        self.dimension = dimension
        self.mode = mode

    def __call__(self, data_dict):
        for field in self.fields:
            v = data_dict.get(field)
            if isinstance(v, np.ndarray):
                data_dict[field] = (np.expand_dims(v, self.dimension)
                                    if self.mode == 1
                                    else np.squeeze(v, self.dimension))
        return data_dict


class Clip(BaseTransform):
    """utils/utils.py:508-533."""

    def __init__(self, fields, new_min=0.0, new_max=1.0):
        super().__init__(fields)
        self.new_min = new_min
        self.new_max = new_max

    def __call__(self, data_dict):
        for field in self.fields:
            if data_dict.get(field) is not None:
                data_dict[field] = np.clip(data_dict[field], self.new_min,
                                           self.new_max)
        return data_dict


class CenterIntensities(BaseTransform):
    """utils/utils.py:572-618: (x - subtrahend) / divisor."""

    def __init__(self, fields, subtrahend=0.0, divisor=1.0):
        super().__init__(fields)
        self.subtrahend = subtrahend
        self.divisor = divisor

    def __call__(self, data_dict):
        for field in self.fields:
            if data_dict.get(field) is not None:
                data_dict[field] = (
                    (data_dict[field] - self.subtrahend) / self.divisor
                ).astype(np.float32)
        return data_dict


class Binarize(BaseTransform):
    """utils/utils.py:536-569: mask >= threshold -> {0, 1}."""

    def __init__(self, fields, threshold=0.5):
        super().__init__(fields)
        self.threshold = threshold

    def __call__(self, data_dict):
        for field in self.fields:
            if data_dict.get(field) is not None:
                data_dict[field] = (
                    data_dict[field] >= self.threshold).astype(np.float32)
        return data_dict


def image_resize(image: np.ndarray, output_size, *, is_label: bool = False
                 ) -> np.ndarray:
    """utils/utils.py:621-635: linear (antialiased) image resize / nearest
    label resize."""
    return resize_volume(image, output_size,
                         order=0 if is_label else 1,
                         anti_aliasing=not is_label)
