"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``ops/kernels/build/lib<name>-<hash>.so`` (the hash is of the source and
the shared ``*.cuh`` headers, so an edited source never loads a stale
library), then opened with ``ctypes``.
Building happens at first use, never at import: a process that only runs
CPU tensors never looks for ``nvcc``. ``build_all()`` starts one ``nvcc``
per source at once and waits for all of them, holding ``build/nvcc.lock``
(``flock``) meanwhile, so that the ranks of a world that start together
build each library once and the others load it.

``build_host_library()`` does the same for a host C++ source (the data
loader's ``data/csrc/fastloader.cpp``) with ``$CXX``, under a file lock,
so that concurrent processes build it once.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shlex
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

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
        "vaeseg_conv3": [_P] * 12 + [_I] * 9 + [_P, _P],
        "vaeseg_error_string": [_I],
    },
    "conv3_dk": {
        "vaeseg_conv3_dk": [_P] * 8 + [_I] * 8 + [_P, _P],
        "vaeseg_error_string": [_I],
    },
    "conv3_bwd": {
        "vaeseg_conv3_bwd": [_P] * 13 + [_I] * 8 + [_P, _P],
        "vaeseg_error_string": [_I],
    },
    "instance_norm": {
        "vaeseg_norm_reduce": [_P] * 5 + [_L, _P, _I, _I, _L, _I, _P],
        "vaeseg_norm_elementwise": [_P] * 6 + [_I, _I, _L, _I, _L, _I,
                                                _P],
        "vaeseg_error_string": [_I],
    },
    "bridge": {
        "vaeseg_bridge": [_I] + [_P] * 6 + [_I] * 6 + [_P, _P],
        "vaeseg_error_string": [_I],
    },
    "bridge_bwd": {
        "vaeseg_bridge_bwd": [_I] + [_P] * 12 + [_I] * 6 + [_P] * 3,
        "vaeseg_error_string": [_I],
    },
    "reparam": {
        "vaeseg_reparam_kl": [_P, _P, _P, ctypes.c_float, _P, _P, _P, _I, _I,
                              _P],
        "vaeseg_reparam_kl_vjp": [_P] * 5 + [ctypes.c_float] * 2
        + [_P, _P, _I, _I, _P],
        "vaeseg_launch_floor": [_P],
        "vaeseg_error_string": [_I],
    },
    "losses": {
        "vaeseg_softmax_vjp": [_P, _P, _P, _L, _I, _L, _L, _P],
        "vaeseg_dice_sums": [_P] * 6 + [_I, _L, _I, _I, _L, _L, _P],
        "vaeseg_dice_vjp": [_P] * 9 + [_I, _L, _I, _I, _L, _L, _P],
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
        if any(not _target(n).exists() for n in todo):
            with open(BUILD_DIR / "nvcc.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
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


def library_path(name: str) -> Path:
    """Where the library `name` of the current sources is built."""
    return _target(name)


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


def build_host_library(source: Path, flags: Sequence[str],
                       build_dir: Path) -> Tuple[Path, Optional[str]]:
    """Compile ``source`` with ``$CXX`` (default ``g++``) and ``flags`` into
    ``build_dir/lib<stem>-<hash>.so`` unless it is there; the hash covers
    the source and the whole command, so that an edited source, other flags
    or another compiler never load a stale library. Holds
    ``<library>.lock`` (``flock``, released if the process dies) while it
    checks and builds, and moves the library into place with one rename,
    so that a process or thread that finds the file finds it whole and a
    second caller waits and reuses it. Returns (path, the compiler's
    output, None when the library was already built). A compiler that is
    missing or fails raises RuntimeError with its output."""
    cmd = [*shlex.split(os.environ.get("CXX") or "g++"), *flags]
    h = hashlib.sha1(source.read_bytes())
    h.update("\0".join(cmd).encode())
    out = build_dir / f"lib{source.stem}-{h.hexdigest()[:12]}.so"
    if out.exists():
        return out, None
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out, None
        tmp = _tmp(out)
        try:
            res = subprocess.run([*cmd, "-o", str(tmp), str(source)],
                                 capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"{cmd[0]} could not run to build "
                               f"{source}: {e}") from e
        log = res.stdout + res.stderr
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{' '.join(cmd)} failed for {source}:\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    return out, log
