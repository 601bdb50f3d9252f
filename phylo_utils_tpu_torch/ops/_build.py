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
header of constexpr arrays (the topology's live-row walk) that this module
writes into the build directory (``static_topology_header``), with one
``nvcc`` per lane count, all at once, into a library keyed by the hash of
the sources, the header, the lane counts and the flags, under its own file
lock.
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

# The sources compiled under their own ptxas setting, one each (nvcc for
# sm_90a): at the default register-usage level (5) ptxas held some of B9's
# kernels, whose lanes keep F x S / kL accumulators, to 80 or 128
# registers and spilled 8 to 32 bytes in them, and one of the flagship's B8
# objects 4; at these levels none of the fold kernels compiled
# (ops/cuda_pruning.py::FOLD_WIDTHS) nor the B8 objects of the flagship,
# config 4 and the wide node spill (PERF.md section 6)
PTXAS_FLAGS = {
    "pruning_fold.cu": ("-Xptxas", "--register-usage-level=10"),
    "pruning_static.cu": ("-Xptxas", "--register-usage-level=2"),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_info: dict = {}
# B8's libraries, under their own lock so that they build while the main
# library does
_static_lock = threading.Lock()
_static_libs: dict = {}     # key -> CDLL
_static_info: dict = {}     # key -> path, seconds, built, log, n_int, n_edges, s


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


# (entry point, device pointers, int arguments, strides) of the main
# library, in the order of the C signatures in csrc/: the pointers come
# first, then the counts, then the stream, then the per-batch strides in
# floats (``long long``: the leaves', and the deferred reverse's root
# frequencies')
SIGNATURES = (
    ("pruning_forward_f32", 8, 13, 1),
    ("pruning_saveall_f32", 7, 10, 1),
    ("pruning_reverse_f32", 15, 11, 2),
    ("pruning_slot_f32", 8, 13, 1),
    ("pruning_stream_f32", 11, 8, 1),
    ("pruning_classic_reverse_f32", 15, 13, 1),
    ("pruning_fold_f32", 8, 14, 1),
)
# B8's entry points (pruning_static_f32_l<lanes>), as pruning_forward_f32
STATIC_SIGNATURE = (8, 13, 1)


def _argtypes(n_ptr: int, n_int: int, n_stride: int) -> list:
    """Every pointer and the stream as ``c_void_p``, every count as
    ``c_int``, every stride as ``c_longlong``."""
    return ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
            + [ctypes.c_void_p] + [ctypes.c_longlong] * n_stride)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The argument types of every entry point, by ``SIGNATURES``."""
    for name, *counts in SIGNATURES:
        fn = getattr(lib, name)
        fn.argtypes = _argtypes(*counts)
        fn.restype = ctypes.c_int
    return lib


def _compile(units, target: Path) -> str:
    """One ``nvcc -c`` per unit, a (source, extra flags) pair, all running
    at once, then one link; returns the compilers' output. Raises on the
    first failure."""
    nvcc = _nvcc()
    objs = [target.with_name(f"{target.stem}_{i}_{src.stem}.o")
            for i, (src, _) in enumerate(units)]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, *flags, "-c", "-o", str(obj),
                          str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for (src, flags), obj in zip(units, objs)
    ]
    logs, failed = [], []
    for (src, flags), proc in zip(units, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src.name} {' '.join(flags)}\n{out}")
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
        units = [(src, PTXAS_FLAGS.get(src.name, ())) for src in sources]
        key = _digest(sources + sorted(CSRC.glob("*.cuh")), repr(units))
        target = BUILD_DIR / f"libphylo_kernels_{key}.so"
        t0 = time.perf_counter()
        log, built = _build_once(target, BUILD_DIR / "lock",
                                 lambda tmp: _compile(units, tmp))
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
    so that concurrent processes build it once. The output is kept beside
    ``target`` (``.log``), so that a library taken from the build directory
    still reports its ptxas lines."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    saved = target.with_suffix(".log")
    built = False
    with open(lock, "w") as lock_fh:
        fcntl.flock(lock_fh, fcntl.LOCK_EX)
        try:
            if not target.exists():
                tmp = BUILD_DIR / f"tmp{os.getpid()}_{target.name}"
                saved.write_text(compile_to(tmp))
                os.replace(tmp, target)
                built = True
            log = saved.read_text() if saved.exists() else ""
        finally:
            fcntl.flock(lock_fh, fcntl.LOCK_UN)
    return log, built


def build_info() -> dict:
    """Path, wall seconds, built and compiler output of the last
    ``load_library`` (the output of the build that made the library, where
    it came from the build directory)."""
    return dict(_info)


def _c_array(values) -> str:
    return "{" + ", ".join(str(int(v)) for v in values) + "}"


def static_topology_header(edges, eword, n_rows: int, n_nodes: int,
                           n_leaves: int, s: int, chunk: int) -> str:
    """The generated header ``csrc/pruning_static.cu`` is compiled against:
    one tree's live-row walk (``cuda_pruning.RowWalk``: the children of
    the walk's nodes in order, ``edges`` (n_edges,), their words ``eword``
    (n_edges + 1, 2), of which the last, read ahead by the other live-row
    kernels, is left out, and ``n_rows`` rows), the node and leaf counts,
    the state count and the step of ``chunk`` edges as constexpr values in
    namespace ``topo``."""
    n_edges = len(edges)
    return "\n".join([
        "// Generated by phylo_utils_tpu_torch/ops/_build.py: one tree's",
        "// live-row walk for csrc/pruning_static.cu.",
        "#pragma once",
        "namespace topo {",
        f"constexpr int kS = {int(s)};",
        f"constexpr int kNNodes = {int(n_nodes)};",
        f"constexpr int kNLeaves = {int(n_leaves)};",
        f"constexpr int kNEdges = {int(n_edges)};",
        f"constexpr int kNRows = {int(n_rows)};",
        f"constexpr int kChunk = {int(chunk)};",
        f"constexpr int kEdges[kNEdges] = {_c_array(edges)};",
        "constexpr int kEword[2 * kNEdges] = "
        f"{_c_array(eword[:n_edges].reshape(-1))};",
        "}  // namespace topo",
        "",
    ])


def load_static_library(edges, eword, n_rows: int, n_nodes: int,
                        n_leaves: int, s: int, chunk: int,
                        lanes) -> ctypes.CDLL:
    """The B8 library of one topology and state count (arguments as
    ``static_topology_header``'s), built on first use: the header is written
    to ``build/phylo_utils_tpu_torch/static_<key>/`` and
    ``csrc/pruning_static.cu`` compiled against it once for each of
    ``lanes`` (lane counts a column), one ``nvcc`` each, all at once, and
    linked; entry points ``pruning_static_f32_l<lanes>``. Raises where
    ``nvcc`` is missing or the build fails."""
    header = static_topology_header(edges, eword, n_rows, n_nodes, n_leaves,
                                    s, chunk)
    lanes = tuple(int(n) for n in lanes)
    key = _digest([STATIC_SOURCE] + sorted(CSRC.glob("*.cuh")),
                  header + f"lanes {lanes} {PTXAS_FLAGS[STATIC_SOURCE.name]}")
    with _static_lock:
        if key in _static_libs:
            return _static_libs[key]
    target = BUILD_DIR / f"libphylo_static_{key}.so"
    include = BUILD_DIR / f"static_{key}"

    def compile_to(tmp: Path) -> str:
        include.mkdir(parents=True, exist_ok=True)
        (include / STATIC_HEADER).write_text(header)
        return _compile([(STATIC_SOURCE, ("-I", str(include),
                                          f"-DPRUNING_STATIC_LANES={n}",
                                          *PTXAS_FLAGS[STATIC_SOURCE.name]))
                         for n in lanes], tmp)

    t0 = time.perf_counter()
    log, built = _build_once(target, BUILD_DIR / f"lock_static_{key}",
                             compile_to)
    lib = ctypes.CDLL(str(target))
    for n in lanes:
        fn = getattr(lib, f"pruning_static_f32_l{n}")
        fn.argtypes = _argtypes(*STATIC_SIGNATURE)
        fn.restype = ctypes.c_int
    with _static_lock:
        _static_libs[key] = lib
        _static_info[key] = dict(
            path=str(target), seconds=time.perf_counter() - t0, built=built,
            log=log, n_int=int((eword[:len(edges), 1] != -2).sum()),
            n_edges=int(len(edges)), s=int(s))
    return lib


def static_build_info() -> dict:
    """{key: path, wall seconds, built, compiler output, internal nodes,
    edges, states} of every B8 library this process has loaded."""
    with _static_lock:
        return {k: dict(v) for k, v in _static_info.items()}
