"""ctypes bindings for the native (C++) host data path (the PyTorch port's
copy of ``phylo_utils_tpu.native``).

``_phyloio.so`` is built from ``src/phyloio.cpp`` with ``g++`` at the first
call that needs it, not at import, into this directory (the build writes a
temporary file and renames it, so concurrent first calls do not race). A
failed build raises ``OSError``; callers (``io.load_compressed``) treat
``ImportError``/``OSError`` as "use the numpy path". Patterns come out in
order of first occurrence, as in the JAX package's native path.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import List, Tuple

import numpy as np

__all__ = [
    "compress_chars_native",
    "compress_matrix_native",
    "read_fasta_matrix_native",
    "native_available",
]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "_phyloio.so")
_SRC = os.path.join(_DIR, "src", "phyloio.cpp")

# ASCII uppercase fold LUT (non-letters pass through).
_UPPER = np.arange(256, dtype=np.uint8)
_UPPER[ord("a") : ord("z") + 1] = np.arange(ord("A"), ord("Z") + 1, dtype=np.uint8)

_LIB = None
_LOCK = threading.Lock()

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "pu_compress_columns": (ctypes.c_int64, [
        _U8P, ctypes.c_int64, ctypes.c_int64, _I32P, _I32P, _I64P]),
    "pu_map_bytes": (None, [_U8P, ctypes.c_int64, _U8P, _U8P]),
    "pu_fasta_scan": (ctypes.c_int64, [_U8P, ctypes.c_int64, _I64P]),
    "pu_fasta_parse": (ctypes.c_int64, [
        _U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _U8P, _U8P,
        _I64P]),
}


def _build() -> None:
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-o", tmp, _SRC],
            check=True, capture_output=True,
        )
        os.replace(tmp, _SO)
    except subprocess.CalledProcessError as e:
        raise OSError(f"g++ failed on {_SRC}: {e.stderr.decode()}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _lib() -> ctypes.CDLL:
    """The library, built on first use; raises OSError where it cannot be
    built or loaded."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            if not os.path.exists(_SO) or (
                os.path.getmtime(_SRC) > os.path.getmtime(_SO)
            ):
                _build()
            lib = ctypes.CDLL(_SO)
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _LIB = lib
        return _LIB


def native_available() -> bool:
    """True where the library builds and loads."""
    try:
        _lib()
    except OSError:
        return False
    return True


def _as_u8_ptr(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _compress(chars: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(uniq_cols, site_to_pattern, counts) of an uppercased C-contiguous
    (taxa, sites) uint8 matrix."""
    n_seqs, n_sites = chars.shape
    site_to_pattern = np.empty(n_sites, dtype=np.int32)
    pattern_sites = np.empty(n_sites, dtype=np.int32)
    counts = np.empty(n_sites, dtype=np.int64)
    n_pat = _lib().pu_compress_columns(
        _as_u8_ptr(chars), n_seqs, n_sites,
        site_to_pattern.ctypes.data_as(_I32P),
        pattern_sites.ctypes.data_as(_I32P),
        counts.ctypes.data_as(_I64P),
    )
    if n_pat < 0:
        raise MemoryError("native pattern compression failed")
    uniq_cols = chars[:, pattern_sites[:n_pat]]
    return uniq_cols, site_to_pattern, counts[:n_pat].astype(np.float64)


def compress_chars_native(
    seqs: List[str],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Uppercase + column-compress an equal-length sequence list.

    Returns ``(chars, uniq_cols, site_to_pattern, counts)``: ``chars``
    (taxa, sites) uint8 uppercased, ``uniq_cols`` (taxa, n_patterns) uint8.
    """
    n_seqs = len(seqs)
    if n_seqs == 0:
        raise ValueError("empty alignment")
    n_sites = len(seqs[0])
    raw = np.empty((n_seqs, n_sites), dtype=np.uint8)
    for i, s in enumerate(seqs):
        b = np.frombuffer(s.encode("ascii"), dtype=np.uint8)
        if b.shape[0] != n_sites:
            raise ValueError("sequences have unequal lengths")
        raw[i] = b
    chars = np.empty_like(raw)
    _lib().pu_map_bytes(
        _as_u8_ptr(raw), raw.size, _as_u8_ptr(_UPPER), _as_u8_ptr(chars)
    )
    return (chars, *_compress(chars))


def compress_matrix_native(
    chars: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Column-compress an already-uppercased (taxa, sites) uint8 matrix.
    Returns (uniq_cols, site_to_pattern, counts)."""
    return _compress(np.ascontiguousarray(chars, dtype=np.uint8))


def read_fasta_matrix_native(path: str) -> Tuple[List[str], np.ndarray]:
    """Parse a FASTA file straight into a (taxa, sites) uppercased uint8
    matrix: no per-character Python, no intermediate strings.

    Returns ``(names, matrix)``. Raises ValueError on ragged/empty input.
    """
    lib = _lib()
    buf = np.fromfile(path, dtype=np.uint8)
    seq_len = ctypes.c_int64(0)
    n_seqs = lib.pu_fasta_scan(_as_u8_ptr(buf), buf.size,
                               ctypes.byref(seq_len))
    if n_seqs == -2:
        raise ValueError(f"{path}: sequences have unequal lengths")
    if n_seqs == -3 or n_seqs <= 0:
        raise ValueError(f"{path}: no FASTA records found")
    matrix = np.empty((n_seqs, seq_len.value), dtype=np.uint8)
    name_ranges = np.empty(2 * n_seqs, dtype=np.int64)
    rc = lib.pu_fasta_parse(
        _as_u8_ptr(buf), buf.size, n_seqs, seq_len.value,
        _as_u8_ptr(_UPPER), _as_u8_ptr(matrix),
        name_ranges.ctypes.data_as(_I64P),
    )
    if rc != 0:
        raise ValueError(f"{path}: malformed FASTA")
    raw = buf.tobytes()
    names = []
    for i in range(n_seqs):
        parts = (
            raw[name_ranges[2 * i] : name_ranges[2 * i + 1]]
            .decode("utf-8", "replace")
            .split()
        )
        if not parts:  # '>' with an empty header line
            raise ValueError(f"{path}: record {i + 1} has an empty name")
        names.append(parts[0])
    return names, matrix
