"""Offline CT preprocessing CLI — the C1 equivalent of the reference's
data/data_process.py (NIfTI -> merge.npy cases + manifest).

Pipeline per case (reference data_process.py:20-75):
  1. axis reorder: transpose to [y, x, z] and flip each axis whose affine
     diagonal is positive (data_process.py:26-30,39-41);
  2. resample to 1 mm isotropic — image linear (skimage default order-1 with
     anti-aliasing), label nearest, no anti-aliasing (:32-34,42);
  3. label-foreground bounding box, +/-32 voxel pad, take the enclosing CUBE
     of side L = max bbox extent centered on the bbox center, clamped to the
     volume (:45-69);
  4. write <case>/img.npy (int16), <case>/label.npy (int8), and
     <case>/merge.npy = stack(img, label, axis=-1) (int16) (:73-75).

Framework additions the reference lacks: argparse (the reference hard-codes
paths), a --manifest flag that also writes/updates the Multi_all.json split
file, multiprocess fan-out across cases, and a pure-numpy path (`nibabel` is
imported lazily so the module works for .npy-input tests without it).
Copy of the JAX package's data/preprocess.py: the resample goes through the
port's ``data/resize.py`` (the native resize by default), and the workers
start by ``spawn``.

Usage:
  python -m vae_segmentation_tpu_torch.data.preprocess \
      --image_dir .../Pancreas-CT/data \
      --label_dir .../TCIA_pancreas_labels-02-05-2017 \
      --out data/nih --dataset nih \
      --manifest lists/data/Multi_all.json --split NIH_train
"""

from __future__ import annotations

import argparse
import glob
import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np

from vae_segmentation_tpu_torch.data.resize import resize_volume

PAD = (32, 32, 32)


def _label_name(img_name: str, dataset: str) -> str:
    """Image filename -> label filename (data_process.py:21-23)."""
    if dataset == "synapse":
        return "label" + img_name.split("_")[0][5:8] + ".nii.gz"
    return "label" + img_name.split("_")[1]


def reorient(volume: np.ndarray, spacing: np.ndarray) -> np.ndarray:
    """Transpose to [y, x, z] then flip axes with positive affine diagonal
    (data_process.py:26-30; note the reference indexes ind as [1,0,2] after
    the transpose — axis i of the transposed volume is flipped by the sign
    of the ORIGINAL axis order [y, x, z])."""
    ind = (((-spacing > 0) - 0.5) * 2).astype(int)
    v = np.transpose(volume, (1, 0, 2))
    return v[::ind[1], ::ind[0], ::ind[2]]


def resample_iso(image: np.ndarray, label: np.ndarray,
                 spacing: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Resample both volumes to 1 mm isotropic (data_process.py:32-42)."""
    new_size = (np.array(image.shape) * np.abs(spacing)).astype(int)
    img = resize_volume(image.astype(np.float64), new_size, order=1,
                        anti_aliasing=True)
    lab = resize_volume(label.astype(np.float64), new_size, order=0,
                        anti_aliasing=False)
    return img, lab


def cube_crop(image: np.ndarray, label: np.ndarray,
              pad: Tuple[int, int, int] = PAD
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Foreground bbox +- pad, enclosing cube of side L = max extent,
    clamped to the volume (data_process.py:45-69)."""
    fg = np.array(np.where(label > 0))
    if fg.size == 0:
        raise ValueError("label volume has no foreground")
    bbox = np.array([
        [max(0, fg[i].min() - pad[i]), min(label.shape[i], fg[i].max() + pad[i])]
        for i in range(3)])
    center = np.mean(bbox, 1).astype(int)
    L = int(np.max(bbox[:, 1] - bbox[:, 0]))
    sl = tuple(
        slice(max(0, center[i] - L // 2),
              min(label.shape[i], center[i] - L // 2 + L))
        for i in range(3))
    return image[sl], label[sl]


def process_nifti_case(image_path: str, label_path: str, out_dir: str) -> str:
    """One NIfTI case -> <out_dir>/{img,label,merge}.npy. Returns out_dir."""
    import nibabel as nib  # lazy: offline-only dependency

    img_nii = nib.load(image_path)
    spacing = np.asarray(img_nii.affine)[[0, 1, 2], [0, 1, 2]]
    image = reorient(np.asarray(img_nii.dataobj), spacing)

    lab_nii = nib.load(label_path)
    lab_spacing = np.asarray(lab_nii.affine)[[0, 1, 2], [0, 1, 2]]
    label = reorient(np.asarray(lab_nii.dataobj), lab_spacing)

    image, label = resample_iso(image, label, spacing)
    image, label = cube_crop(image, label)

    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "img.npy"), image.astype(np.int16))
    np.save(os.path.join(out_dir, "label.npy"), label.astype(np.int8))
    np.save(os.path.join(out_dir, "merge.npy"),
            np.stack((image, label), axis=-1).astype(np.int16))
    return out_dir


def update_manifest(manifest_path: str, split: str, entries) -> None:
    data: Dict = {}
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            data = json.load(f)
    data[split] = sorted(set(data.get(split, [])) | set(entries))
    os.makedirs(os.path.dirname(manifest_path) or ".", exist_ok=True)
    with open(manifest_path, "w") as f:
        json.dump(data, f, indent=1)


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(
        description="NIfTI -> merge.npy preprocessing (reference "
                    "data/data_process.py)")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--label_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--dataset", choices=("nih", "msd", "synapse"),
                   default="nih")
    p.add_argument("--manifest", default=None,
                   help="Multi_all.json to update")
    p.add_argument("--split", default=None, help="manifest split key")
    p.add_argument("--workers", type=int, default=os.cpu_count() or 4)
    args = p.parse_args(argv)

    names = sorted(os.path.split(f)[1]
                   for f in glob.glob(os.path.join(args.image_dir, "*.gz")))
    jobs = []
    for img_name in names:
        case = img_name.split(".")[0]
        jobs.append((
            os.path.join(args.image_dir, img_name),
            os.path.join(args.label_dir, _label_name(img_name, args.dataset)),
            os.path.join(args.out, case),
        ))

    entries = []
    with ProcessPoolExecutor(
            max_workers=args.workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(process_nifti_case, *j) for j in jobs]
        for (img, _, out_dir), fut in zip(jobs, futures):
            try:
                fut.result()
                case = os.path.basename(out_dir)
                entries.append(f"{case}/merge.npy")
                print(f"{case}: ok")
            except Exception as e:  # keep going; report at the end
                print(f"{img}: FAILED: {e}")

    if args.manifest and args.split:
        update_manifest(args.manifest, args.split, entries)
        print(f"manifest {args.manifest}[{args.split}]: "
              f"{len(entries)} entries")


if __name__ == "__main__":
    main()
