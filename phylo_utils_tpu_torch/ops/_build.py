"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles the package's own sources (``csrc/*.cu``, which share
``csrc/*.cuh``) into one shared library with a plain C interface at first
use, into ``build/phylo_utils_tpu_torch/`` beside the package, keyed by a
hash of the sources, headers and flags, under a file lock so
concurrent processes build once. Each source compiles in its own ``nvcc``
process, all started together, and one more links them. The library is
loaded with ``ctypes``. There is no fallback: a missing ``nvcc`` or a failed
build raises.

``csrc/pruning_static.cu`` (B8) is left out of that library: it is compiled
per tree topology and state count by ``load_static_library``, against a
header of constexpr arrays that this module writes into the build directory
(``static_topology_header``), with one ``nvcc``, into a library keyed by the
hash of the sources, the header and the flags, under its own file lock.
Each one's build seconds are kept (``static_build_info``); a second call
with the same topology and state count builds nothing.
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

__all__ = [
    "load_library",
    "build_info",
    "load_static_library",
    "static_build_info",
    "static_topology_header",
]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "phylo_utils_tpu_torch"
# compiled per topology by load_static_library, not into the main library
STATIC_SOURCE = CSRC / "pruning_static.cu"
STATIC_HEADER = "pruning_static_topology.h"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_info: dict = {}
# B8's libraries, under their own lock so that they build while the main
# library does
_static_lock = threading.Lock()
_static_libs: dict = {}     # key -> CDLL
_static_info: dict = {}     # key -> path, seconds, built, log, n_int, s


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
        ("pruning_classic_reverse_f32", 15, 11),
        ("pruning_fold_f32", 9, 9),
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
        sources = [src for src in sorted(CSRC.glob("*.cu"))
                   if src != STATIC_SOURCE]
        key = _digest(sources + sorted(CSRC.glob("*.cuh")))
        target = BUILD_DIR / f"libphylo_kernels_{key}.so"
        t0 = time.perf_counter()
        log, built = _build_once(target, BUILD_DIR / "lock",
                                 lambda tmp: _compile(sources, tmp))
        _lib = _bind(ctypes.CDLL(str(target)))
        _info.update(path=str(target), seconds=time.perf_counter() - t0,
                     built=built, log=log)
        return _lib


def _digest(files, extra: str = "") -> str:
    """16 hex digits of the hash of the flags, ``extra`` and the files'
    names and bytes."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(extra.encode())
    for src in files:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()[:16]


def _build_once(target: Path, lock: Path, compile_to):
    """(compiler output, built) after making ``target`` with
    ``compile_to(tmp_path)`` unless it exists, under the file lock ``lock``
    so that concurrent processes build it once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log, built = "", False
    with open(lock, "w") as lock_fh:
        fcntl.flock(lock_fh, fcntl.LOCK_EX)
        try:
            if not target.exists():
                tmp = BUILD_DIR / f"tmp{os.getpid()}_{target.name}"
                log = compile_to(tmp)
                os.replace(tmp, target)
                built = True
        finally:
            fcntl.flock(lock_fh, fcntl.LOCK_UN)
    return log, built


def build_info() -> dict:
    """Path, wall seconds and compiler output of the last ``load_library``
    (``log`` is empty when the library came from the build directory)."""
    return dict(_info)


def _c_array(values) -> str:
    return "{" + ", ".join(str(int(v)) for v in values) + "}"


def static_topology_header(order, children, counts, n_nodes: int,
                           n_leaves: int, s: int) -> str:
    """The generated header ``csrc/pruning_static.cu`` is compiled against:
    the post-order walk (``cuda_pruning._postorder_arrays``: internal nodes
    ``order`` (n_int,), their ``children`` (n_int, cmax), zero-padded, and
    child ``counts`` (n_int,)), the node and leaf counts and the state count
    as constexpr values in namespace ``topo``."""
    n_int, cmax = children.shape
    return "\n".join([
        "// Generated by phylo_utils_tpu_torch/ops/_build.py: one tree's",
        "// post-order walk for csrc/pruning_static.cu.",
        "#pragma once",
        "namespace topo {",
        f"constexpr int kS = {int(s)};",
        f"constexpr int kNNodes = {int(n_nodes)};",
        f"constexpr int kNLeaves = {int(n_leaves)};",
        f"constexpr int kNInt = {int(n_int)};",
        f"constexpr int kCmax = {int(cmax)};",
        f"constexpr int kOrder[kNInt] = {_c_array(order)};",
        "constexpr int kChildren[kNInt * kCmax] = "
        f"{_c_array(children.reshape(-1))};",
        f"constexpr int kCounts[kNInt] = {_c_array(counts)};",
        "}  // namespace topo",
        "",
    ])


def load_static_library(order, children, counts, n_nodes: int,
                        n_leaves: int, s: int) -> ctypes.CDLL:
    """The B8 library of one topology and state count (arguments as
    ``static_topology_header``'s), built on first use: the header is written
    to ``build/phylo_utils_tpu_torch/static_<key>/`` and
    ``csrc/pruning_static.cu`` compiled against it by one ``nvcc``. Raises
    where ``nvcc`` is missing or the build fails."""
    header = static_topology_header(order, children, counts, n_nodes,
                                    n_leaves, s)
    key = _digest([STATIC_SOURCE] + sorted(CSRC.glob("*.cuh")), header)
    with _static_lock:
        if key in _static_libs:
            return _static_libs[key]
    target = BUILD_DIR / f"libphylo_static_{key}.so"
    include = BUILD_DIR / f"static_{key}"

    def compile_to(tmp: Path) -> str:
        include.mkdir(parents=True, exist_ok=True)
        (include / STATIC_HEADER).write_text(header)
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-I", str(include), "-shared", "-o",
             str(tmp), str(STATIC_SOURCE)],
            capture_output=True, text=True)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {STATIC_SOURCE.name} ({res.returncode})\n"
                f"{log}")
        return log

    t0 = time.perf_counter()
    log, built = _build_once(target, BUILD_DIR / f"lock_static_{key}",
                             compile_to)
    lib = ctypes.CDLL(str(target))
    fn = lib.pruning_static_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with _static_lock:
        _static_libs[key] = lib
        _static_info[key] = dict(
            path=str(target), seconds=time.perf_counter() - t0, built=built,
            log=log, n_int=int(len(order)), s=int(s))
    return lib


def static_build_info() -> dict:
    """{key: path, wall seconds, built, compiler output, internal nodes,
    states} of every B8 library this process has loaded."""
    with _static_lock:
        return {k: dict(v) for k, v in _static_info.items()}
