"""Input pipeline: ROI-cropped cases, the eval and train batching, and the
intensity normalization (counterparts of vae_segmentation_tpu/data/
pipeline.py::CaseDataset, ::Loader and data/augment.py::
intensity_normalize)."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from vae_segmentation_tpu_torch.data.transforms import (
    MaskIndex, crop_resize, load_merge_case)

# main_source.py:211-212, utils/utils.py:508-533,572-618
CLIP_MIN, CLIP_MAX = -200.0, 400.0
SUBTRAHEND, DIVISOR = 100.0, 300.0


class CaseDataset:
    """manifest entries -> {'image', 'label', 'ori_shape', 'id', 'index'}
    at output_size (BaseDataset + NumpyLoader_Multi_merge -> CropResize,
    utils/utils.py:61-88, main_source.py:191-192)."""

    def __init__(self, entries: Sequence[str], root_dir: str,
                 mask_index: Optional[MaskIndex] = None,
                 output_size: Sequence[int] = (128, 128, 128),
                 shift: int = 0):
        self.entries = list(entries)
        self.root_dir = root_dir
        self.mask_index = mask_index
        self.output_size = tuple(output_size)
        self.shift = shift

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        case = load_merge_case(self.root_dir, self.entries[idx],
                               self.mask_index)
        out = crop_resize(case["image"], case["label"], self.output_size,
                          shift=self.shift)
        out["id"] = case["id"]
        out["index"] = idx
        return out


def _collate(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {
        "image": np.stack([it["image"] for it in items]).astype(np.float32),
        "label": np.stack([it["label"] for it in items]).astype(np.float32),
        "ori_shape": np.stack([it["ori_shape"] for it in items]),
        "index": np.array([it["index"] for it in items], np.int32),
    }


def iterate_batches(dataset: CaseDataset, batch_size: int
                    ) -> Iterator[Dict[str, np.ndarray]]:
    """In-order batches of `batch_size` cases, the last one ragged (the eval
    loader's shuffle=False, drop_last=False)."""
    for start in range(0, len(dataset), batch_size):
        stop = min(start + batch_size, len(dataset))
        yield _collate([dataset[i] for i in range(start, stop)])


class TrainLoader:
    """The trainers' loader (shuffle=True, drop_last=True,
    main_source.py:237-241): every pass shuffles the case order with one
    numpy generator seeded at construction, the same draws as the JAX
    package's ``Loader``, and yields the full batches only. With
    num_workers > 0 the cases of a batch load in that many threads and the
    next batch loads while the caller works on the current one."""

    def __init__(self, dataset: CaseDataset, batch_size: int, seed: int = 0,
                 num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def batch_indices(self) -> List[np.ndarray]:
        """The next pass's batches of case indices (advances the shuffle)."""
        order = np.arange(len(self.dataset))
        self.rng.shuffle(order)
        return [order[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(len(self))]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self.batch_indices()
        if self.num_workers <= 0:
            for idx in batches:
                yield _collate([self.dataset[int(i)] for i in idx])
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            def submit(idx):
                return [pool.submit(self.dataset.__getitem__, int(i))
                        for i in idx]

            pending = submit(batches[0]) if batches else None
            for nxt in batches[1:] + [None]:
                current, pending = pending, \
                    (submit(nxt) if nxt is not None else None)
                yield _collate([f.result() for f in current])


def intensity_normalize(images: torch.Tensor) -> torch.Tensor:
    """Clip(-200, 400) then (x - 100) / 300."""
    return (torch.clamp(images, CLIP_MIN, CLIP_MAX) - SUBTRAHEND) / DIVISOR
