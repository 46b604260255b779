"""ctypes bindings for the port's native case loader
(``data/csrc/fastloader.cpp``; counterpart of the JAX package's
data/native_loader.py).

A C++ thread pool mmaps a merge.npy case and does the channel split, the
label remap (NumpyLoader_Multi_merge semantics, utils/utils.py:366-374)
and the class-foreground bounding box in one pass, and runs the separable
anti-aliased resize of ``data/resize.py``, all off the GIL.

The library is built at first use, never at import, with ``$CXX`` (default
``g++``) into ``data/build/libfastloader-<hash>.so``
(``ops/kernels/build.py::build_host_library``: one build however many
processes and threads ask at once). A failed build or ``dlopen`` raises;
there is no silent numpy fallback. Which files the loader takes is decided
from the npy header in Python (``in_subset``): the numpy path of
``data/transforms.py`` keeps the rest, as in the JAX package. The pool has
``VAESEG_LOADER_THREADS`` threads (default 8), read when the library is
first loaded.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "fastloader.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
# the npy subset fastloader.cpp reads: dtype, C order, [D, H, W, 2]
DTYPES = ("<i2", "<f4", "|i1")

_P = ctypes.POINTER
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_record: Dict = {}


def loader_threads() -> int:
    """The pool's size: ``VAESEG_LOADER_THREADS``, default 8."""
    return int(os.environ.get("VAESEG_LOADER_THREADS", "8"))


def build(build_dir: Path = None) -> Tuple[ctypes.CDLL, Dict]:
    """Build (unless built) and open the library in ``build_dir`` (default
    ``BUILD_DIR``), with every function's argument and result types bound.
    Returns (library, {'path', 'built': whether this call compiled it,
    'seconds', 'log'}). Raises RuntimeError when the compiler or the
    ``dlopen`` fails."""
    from vae_segmentation_tpu_torch.ops.kernels.build import \
        build_host_library

    t0 = time.perf_counter()
    path, log = build_host_library(SOURCE, CXX_FLAGS,
                                   build_dir or BUILD_DIR)
    seconds = time.perf_counter() - t0
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"dlopen of the native loader {path} failed: {e}"
                           f"\n{log or ''}") from e
    i32, i64, f32 = _P(ctypes.c_int32), _P(ctypes.c_int64), \
        _P(ctypes.c_float)
    lib.vaeseg_init_pool.argtypes = [ctypes.c_int]
    lib.vaeseg_init_pool.restype = None
    lib.vaeseg_case_shape.argtypes = [ctypes.c_char_p, i64]
    lib.vaeseg_load_case.argtypes = [ctypes.c_char_p, i32, i32, ctypes.c_int,
                                     f32, f32, i64]
    lib.vaeseg_load_case_bbox.argtypes = lib.vaeseg_load_case.argtypes + [i64]
    lib.vaeseg_resize_volume.argtypes = [f32, i64, f32, i64, ctypes.c_int,
                                         ctypes.c_int]
    for fn in (lib.vaeseg_case_shape, lib.vaeseg_load_case,
               lib.vaeseg_load_case_bbox, lib.vaeseg_resize_volume):
        fn.restype = ctypes.c_int
    return lib, {"path": str(path), "built": log is not None,
                 "seconds": seconds, "log": log}


def library() -> ctypes.CDLL:
    """The process's loaded library, built at the first call, its pool
    started with ``loader_threads()`` threads."""
    global _lib
    with _lock:
        if _lib is None:
            lib, rec = build()
            lib.vaeseg_init_pool(loader_threads())
            _record.update(rec, threads=loader_threads())
            _lib = lib
        return _lib


def build_record() -> Dict:
    """How this process got the library: path, whether it compiled it,
    the seconds it took, the compiler's output, the pool's threads. Empty
    before the first ``library()``."""
    return dict(_record)


def _header(path: str):
    """(shape, fortran_order, dtype) from an npy file's header, None for a
    header version the loader does not parse (it reads 1 and 2). Raises
    FileNotFoundError for a missing file and ValueError for one that is
    no npy file or holds fewer bytes than its header's shape needs."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        if version not in ((1, 0), (2, 0)):
            return None
        read = np.lib.format.read_array_header_1_0 if version == (1, 0) \
            else np.lib.format.read_array_header_2_0
        shape, fortran, dtype = read(f)
        need = f.tell() + int(np.prod(shape)) * dtype.itemsize
        if os.fstat(f.fileno()).st_size < need:
            raise ValueError(f"{path}: truncated npy file (its header's "
                             f"shape {shape} needs {need} bytes)")
    return shape, fortran, dtype


def _takes(header) -> bool:
    if header is None:
        return False
    shape, fortran, dtype = header
    return (dtype.str in DTYPES and not fortran and len(shape) == 4
            and shape[3] == 2)


def in_subset(path: str) -> bool:
    """Whether the loader takes the npy file at ``path``, from its header:
    version 1 or 2, a dtype of ``DTYPES``, C order, shape [D, H, W, 2].
    Raises as ``_header``."""
    return _takes(_header(path))


def _mask_arrays(mask_index) -> Tuple[np.ndarray, np.ndarray]:
    """[[raw(s), cls], ...] -> flat (raw_labels, class_ids) int32 arrays."""
    raws, clss = [], []
    for raw_labels, cls in mask_index:
        if not isinstance(raw_labels, list):
            raw_labels = [raw_labels]
        for r in raw_labels:
            raws.append(int(r))
            clss.append(int(cls))
    return np.asarray(raws, np.int32), np.asarray(clss, np.int32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(_P(ctype))


def load_case(path: str, mask_index) -> Dict[str, np.ndarray]:
    """merge.npy -> {'image' f32, 'label' f32 (remapped by mask_index),
    'bbox' int64[6]}: the bbox [dmin, hmin, wmin, dmax, hmax, wmax]
    (inclusive) of label > 0, all -1 for an empty label. The file must be
    ``in_subset``; any failure raises with the path."""
    header = _header(path)
    if not _takes(header):
        raise ValueError(f"{path}: outside the native loader's npy subset "
                         f"({DTYPES}, C order, [D, H, W, 2])")
    lib = library()
    d, h, w, _ = header[0]
    img = np.empty((d, h, w), np.float32)
    lab = np.empty((d, h, w), np.float32)
    shape = np.zeros(3, np.int64)
    box = np.zeros(6, np.int64)
    raws, clss = _mask_arrays(mask_index)
    rc = lib.vaeseg_load_case_bbox(
        os.fsencode(path), _ptr(raws, ctypes.c_int32),
        _ptr(clss, ctypes.c_int32), len(raws), _ptr(img, ctypes.c_float),
        _ptr(lab, ctypes.c_float), _ptr(shape, ctypes.c_int64),
        _ptr(box, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError(f"native loader failed on {path} (code {rc})")
    if tuple(shape) != (d, h, w):
        raise RuntimeError(f"native loader read {path} as {tuple(shape)}, "
                           f"its header says {(d, h, w)}")
    return {"image": img, "label": lab, "bbox": box}


def resize_volume(vol: np.ndarray, output_size: Sequence[int], *,
                  order: int = 1, anti_aliasing: bool = True) -> np.ndarray:
    """The separable anti-aliased resize of a 3D volume in f32 (the
    contract of ``data/resize.py::resize_volume``: skimage.resize
    semantics, gaussian sigma max(0, (1/f - 1)/2) on downscaled axes
    when anti_aliasing, grid-mode linear (order 1) or nearest (order 0)
    resampling)."""
    vol = np.ascontiguousarray(vol, np.float32)
    out_shape = tuple(int(s) for s in output_size)
    if vol.ndim != 3 or len(out_shape) != 3 or order not in (0, 1):
        raise ValueError(f"native resize takes a 3D volume to a 3D shape at "
                         f"order 0 or 1, not {vol.shape} -> {out_shape} at "
                         f"order {order}")
    out = np.empty(out_shape, np.float32)
    in_dims = np.asarray(vol.shape, np.int64)
    out_dims = np.asarray(out_shape, np.int64)
    rc = library().vaeseg_resize_volume(
        _ptr(vol, ctypes.c_float), _ptr(in_dims, ctypes.c_int64),
        _ptr(out, ctypes.c_float), _ptr(out_dims, ctypes.c_int64),
        int(order), int(bool(anti_aliasing)))
    if rc != 0:
        raise RuntimeError(f"native resize failed for {vol.shape} -> "
                           f"{out_shape} (code {rc})")
    return out
