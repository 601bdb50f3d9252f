"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles the package's own sources (``csrc/*.cu``, which share
``csrc/*.cuh``) into one shared library with a plain C interface at first
use, into ``build/phylo_utils_tpu_torch/`` beside the package, keyed by a
hash of the sources, headers and flags, under a file lock so
concurrent processes build once. Each source compiles in its own ``nvcc``
process, all started together, and one more links them. The library is
loaded with ``ctypes``. There is no fallback: a missing ``nvcc`` or a failed
build raises.
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    """Every pointer and the stream as ``c_void_p``, every count as
    ``c_int``, in the order of the C signatures in ``csrc/``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, n_ptr, n_int in (
        ("pruning_forward_f32", 9, 8),
        ("pruning_saveall_f32", 7, 8),
        ("pruning_reverse_f32", 12, 9),
        ("pruning_slot_f32", 11, 8),
        ("pruning_stream_f32", 11, 8),
    ):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * n_ptr + [ci] * n_int + [vp]
        fn.restype = ci
    return lib


def _compile(sources, target: Path) -> str:
    """One ``nvcc -c`` per source, all running at once, then one link;
    returns the compilers' output. Raises on the first failure."""
    nvcc = _nvcc()
    objs = [target.with_name(f"{target.stem}_{src.stem}.o") for src in sources]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for src, obj in zip(sources, objs)
    ]
    logs, failed = [], []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    log = "".join(logs)
    if not failed:
        res = subprocess.run(
            [nvcc, "-shared", "-o", str(target), *map(str, objs)],
            capture_output=True, text=True)
        log += res.stdout + res.stderr
        if res.returncode != 0:
            failed.append(f"link ({res.returncode})")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{log}")
    return log


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(CSRC.glob("*.cu"))
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sources + sorted(CSRC.glob("*.cuh")):
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
                    log = _compile(sources, tmp)
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
