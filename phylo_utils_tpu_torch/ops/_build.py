"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles the package's own sources into one shared library with a
plain C interface at first use, into ``build/phylo_utils_tpu_torch/`` beside
the package, keyed by a hash of the sources and flags, under a file lock so
concurrent processes build once. The library is loaded with ``ctypes``.
There is no fallback: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

__all__ = ["load_library", "build_info"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "phylo_utils_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_info: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels cannot be built"
        )
    return found


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.pruning_forward_f32
    fn.argtypes = [vp] * 9 + [ci] * 8 + [vp]
    fn.restype = ci
    return lib


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(CSRC.glob("*.cu"))
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sources:
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
        key = digest.hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        target = BUILD_DIR / f"libphylo_kernels_{key}.so"
        t0 = time.perf_counter()
        log, built = "", False
        with open(BUILD_DIR / "lock", "w") as lock_fh:
            fcntl.flock(lock_fh, fcntl.LOCK_EX)
            try:
                if not target.exists():
                    tmp = BUILD_DIR / f"tmp{os.getpid()}_{target.name}"
                    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           *map(str, sources)]
                    res = subprocess.run(cmd, capture_output=True, text=True)
                    log = res.stdout + res.stderr
                    if res.returncode != 0:
                        raise RuntimeError(
                            f"nvcc failed ({res.returncode}):\n{log}"
                        )
                    os.replace(tmp, target)
                    built = True
            finally:
                fcntl.flock(lock_fh, fcntl.LOCK_UN)
        _lib = _bind(ctypes.CDLL(str(target)))
        _info.update(path=str(target), seconds=time.perf_counter() - t0,
                     built=built, log=log)
        return _lib


def build_info() -> dict:
    """Path, wall seconds and compiler output of the last ``load_library``
    (``log`` is empty when the library came from the build directory)."""
    return dict(_info)
