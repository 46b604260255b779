"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``ops/kernels/build/lib<name>-<hash>.so`` (the hash is of the source and
the shared ``*.cuh`` headers, so an edited source never loads a stale
library), then opened with ``ctypes``.
Building happens at first use, never at import: a process that only runs
CPU tensors never looks for ``nvcc``. ``build_all()`` starts one ``nvcc``
per source at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# exported C functions and their argument types, per source file
SIGNATURES = {
    "conv3": {
        "vaeseg_conv3": [_P] * 10 + [_I] * 7 + [_P],
        "vaeseg_error_string": [_I],
    },
    "conv3_dk": {
        "vaeseg_conv3_dk": [_P] * 6 + [_I] * 6 + [_P],
        "vaeseg_error_string": [_I],
    },
    "conv3_bwd": {
        "vaeseg_conv3_bwd": [_P] * 9 + [_I] * 6 + [_P],
        "vaeseg_error_string": [_I],
    },
    "instance_norm": {
        "vaeseg_norm_reduce": [_P] * 5 + [_I, _I, _L, _I, _P],
        "vaeseg_norm_elementwise": [_P] * 6 + [_I, _I, _L, _I, _P],
        "vaeseg_error_string": [_I],
    },
    "bridge": {
        "vaeseg_down_k2s2": [_P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _P],
        "vaeseg_up_k2s2": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "vaeseg_error_string": [_I],
    },
    "bridge_bwd": {
        "vaeseg_bridge_bwd": [_I] + [_P] * 9 + [_I] * 6 + [_P],
        "vaeseg_error_string": [_I],
    },
    "reparam": {
        "vaeseg_reparam_kl": [_P, _P, _P, ctypes.c_float, _P, _P, _P, _I, _I,
                              _P],
        "vaeseg_error_string": [_I],
    },
    "losses": {
        "vaeseg_softmax_vjp": [_P, _P, _P, _L, _I, _P],
        "vaeseg_dice_sums": [_P, _P, _P, _P, _P, _I, _L, _I, _I, _P],
        "vaeseg_error_string": [_I],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError(
            "nvcc not found (PATH or CUDA_HOME): the port's CUDA kernels are "
            "built from source at first use on the GPU machine")
    return cand


def _target(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _tmp(out: Path) -> Path:
    return out.parent / f"{out.stem}.{os.getpid()}.tmp.so"


def _start(name: str, out: Path) -> subprocess.Popen:
    tmp = _tmp(out)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_char_p if fn.endswith("error_string") \
            else ctypes.c_int
    return lib


def build_all(names: List[str] = None) -> Dict[str, str]:
    """Compile every missing library in parallel (one nvcc per source) and
    load them. Returns {name: ptxas/nvcc log} for the ones built now."""
    names = list(SIGNATURES) if names is None else names
    logs: Dict[str, str] = {}
    with _lock:
        todo = [n for n in names if n not in _libs]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {n: _start(n, _target(n)) for n in todo
                 if not _target(n).exists()}
        errors = []
        for n, proc in procs.items():
            out, _ = proc.communicate()
            logs[n] = out
            tmp = _tmp(_target(n))
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {n}.cu:\n{out}")
            else:
                os.replace(tmp, _target(n))
                (BUILD_DIR / f"{n}.log").write_text(out)
        if errors:
            raise RuntimeError("\n".join(errors))
        for n in todo:
            _libs[n] = _load(n, _target(n))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name]
    return lib


def loaded() -> List[str]:
    """Names of the kernel libraries this process has loaded."""
    return sorted(_libs)
