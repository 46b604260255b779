"""Synthetic dataset generation — ellipsoid "pancreas" phantoms in CT-like
volumes, written in the reference's merge.npy + Multi_all.json contract
(data/data_process.py:73-75, data/Multi_all.json) so every trainer, test and
benchmark can run end-to-end without the (license-gated) NIH/MSD/Synapse data.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np


def make_phantom(rng: np.random.Generator, size: int = 96,
                 n_class_labels: Sequence[int] = (1,)) -> Dict[str, np.ndarray]:
    """A random soft-tissue volume with an ellipsoid foreground organ."""
    d = size
    image = rng.normal(40.0, 30.0, (d, d, d)).astype(np.float32)
    # bone-ish shell + air pockets for realistic intensity spread
    image[:2] = -1000.0
    label = np.zeros((d, d, d), dtype=np.int16)
    center = rng.uniform(0.35 * d, 0.65 * d, 3)
    radii = rng.uniform(0.08 * d, 0.22 * d, 3)
    zz, yy, xx = np.mgrid[0:d, 0:d, 0:d]
    dist = (((zz - center[0]) / radii[0]) ** 2
            + ((yy - center[1]) / radii[1]) ** 2
            + ((xx - center[2]) / radii[2]) ** 2)
    lab_val = int(rng.choice(list(n_class_labels)))
    label[dist <= 1.0] = lab_val
    # organ is brighter than background
    image[dist <= 1.0] += 60.0
    return {"image": image, "label": label}


def write_synthetic_dataset(root: str, *, n_train: int = 8, n_val: int = 4,
                            size: int = 96, seed: int = 0,
                            labels: Sequence[int] = (1,),
                            train_key: str = "NIH_train",
                            val_key: str = "NIH_val",
                            manifest_name: str = "Multi_all.json") -> str:
    """Write merge.npy cases + manifest; returns the manifest path."""
    rng = np.random.default_rng(seed)
    manifest: Dict[str, List[str]] = {train_key: [], val_key: []}
    for split_key, n in ((train_key, n_train), (val_key, n_val)):
        for i in range(n):
            case = f"case{split_key}{i:04d}"
            case_dir = os.path.join(root, case)
            os.makedirs(case_dir, exist_ok=True)
            ph = make_phantom(rng, size, labels)
            merge = np.stack((ph["image"], ph["label"]), axis=-1).astype(np.int16)
            np.save(os.path.join(case_dir, "merge.npy"), merge)
            manifest[split_key].append(f"{case}/merge.npy")
    manifest_path = os.path.join(root, manifest_name)
    with open(manifest_path, "w") as f:
        json.dump(manifest, f)
    return manifest_path
