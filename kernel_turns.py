#!/usr/bin/env python3
"""Time the port's walk kernels against an earlier version of their
sources, in turns, on one NVIDIA GPU: the forward walk (B1,
``pruning_forward_f32``), the slot walk (B4, ``pruning_slot_f32``), the
saveall walk (B2, ``pruning_saveall_f32``), the classic reverse (B7,
``pruning_classic_reverse_f32``), the deferred reverse (B3,
``pruning_reverse_f32``), the stream walk (B5, ``pruning_stream_f32``), the
fold walk (B9, ``pruning_fold_f32``) and the topology-compiled walk (B8,
``pruning_static_f32``).

Usage, from the root of a checkout::

    python3 kernel_turns.py --parent DIR [--out FILE]

``DIR`` holds the earlier ``pruning_forward.cu``, ``pruning_reverse.cu``,
``pruning_slot.cu``, ``pruning_classic_reverse.cu``, ``pruning_fold.cu``,
``pruning_static.cu`` and the headers they include, for example unpacked
from an earlier commit with ``git archive <commit>
phylo_utils_tpu_torch/csrc | tar -x -C DIR --strip-components 2``. The
script builds them with ``nvcc`` into ``build/kernel_turns/`` beside the
current library (``ops/_build.py``); the earlier B8 once per topology,
against a header of that topology's post-order, children and counts in
its own format. B1, B2, B3, B4, B5 and B7 keep the C signatures they had
before B8 and B9 took the live-row walk, so the earlier library runs them
under the current wrappers; B8 and B9 are bound with their earlier
signatures (a post-order with a children table, whole-tree scratch in
device memory). Then, on the same inputs, at
the flagship (64 taxa, GTR+G4, 1024 sites) at B = 1 and 64, on BASELINE
config 4's tree at 20 states (32 taxa, LG+G4, 1024 sites), the 1000-taxon
GTR+G4 tree and the 512-taxon LG+G4 tree at 8192 patterns, on the
wide-node tree (a root of 48 leaf children beside a 48-taxon subtree, kept
whole, 8192 patterns simulated down it) at 4 and 20 states, and for B9 at
12 categories on the flagship's tree and 60 on config 4's (the widths):

1. checks: B1's and B4's roots, with 0, 1 and all their rows in shared
   memory, bit for bit the earlier B1's (and the earlier B4's); B8's (at
   the flagship, config 4 and the wide node at 4 states) and B9's (F = 2,
   and every compiled F at config 4 and the widths), with 0, 1 and all
   rows in shared memory, bit for bit the earlier B1's and the earlier
   B8's and B9's; B2's
   residuals bit for bit the earlier B2's and its root row B1's; B7's dP
   within 1e-4 x max|dP| of the earlier B7's and of its plain version,
   bit-identical across two launches, with one seed (lambda pi at the
   root) and two (the root and an inner node), its dleaf bit for bit the
   earlier B7's and, where B3 runs, B3's; B3's dP and dleaf bit for bit the
   earlier B3's; B5's root the earlier one's and B1's;
2. times each kernel in turns (earlier, current, current, earlier; CUDA
   events over repeated launches), with its bound;
3. reads each kernel's device time per launch from ``torch.profiler``
   (B = 1 launches are paced by the host, so event times there are the
   host's);
4. sweeps, each setting timed in turns (a, b, ..., b, a): B1's and B4's
   lanes a column, columns a block and edges a step (``row_geometry``'s
   choices), and their rows in shared memory (0, 1, half, all); B9's F x
   lanes x edges a step x columns and B8's lanes x columns (its step is
   compiled in) at the flagship B = 64, config 4 and the widths; B2's edges
   per step (``_SAVEALL_CHUNK``) and lanes (``_SAVEALL_LANES``); B7's
   blocks per launch (``_CLASSIC_REVERSE_BLOCKS``) and block width
   (``_CLASSIC_REVERSE_TILE``), and its shared-memory budget on the wide
   node at 20 states (``_CLASSIC_STAGE_BYTES``);
5. counts global loads (``LDG``), shared-memory loads (``LDS`` by width),
   FMAs and barriers in the SASS of both builds' B1 and B4 (at 4 and 20
   states), B9 (every compiled F and lanes), B8 (the flagship's and config
   4's topologies) and 20-state B2, B7 and B3 (``cuobjdump -sass``), writes
   those functions' SASS to ``build/kernel_turns/``, and lists both
   builds' ptxas registers, shared memory and spills, B8's included (a
   spill in the current build fails the run), and each B8 build's
   seconds; counts the instructions in which each of B1's and B4's
   functions differs from the earlier build's (``sass_diff_b1_b4``: 0 is
   the same code); and compiles the live-row kernel alone at every fold
   width and lane count, those ``csrc/pruning_fold.cu`` leaves out
   included, for their ptxas lines (``ptxas_fold_pairs``).

It prints the card's ``nvidia-smi`` name and power limit, then one JSON
object, also written to ``--out`` (default ``build/kernel_turns.json``).
"""
import argparse
import collections
import ctypes
import difflib
import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
TOL = 1e-4     # x max|dP|: two f32 walks summing over sites in other orders
OUT_DIR = REPO / "build" / "kernel_turns"
PARENT_SOURCES = ("pruning_forward.cu", "pruning_reverse.cu",
                  "pruning_slot.cu", "pruning_classic_reverse.cu",
                  "pruning_fold.cu", "pruning_static.cu")
# built per topology, against a header of its own (_earlier_static_header)
STATIC_SOURCE = "pruning_static.cu"
# the entry points whose C signatures the earlier sources share
SHARED_ENTRIES = ("pruning_forward_f32", "pruning_slot_f32",
                  "pruning_saveall_f32", "pruning_reverse_f32",
                  "pruning_stream_f32", "pruning_classic_reverse_f32")
# mangled-name patterns of the kernels whose SASS is counted: B1 and B4 at
# both state counts (the current ones are the live-row walk, one in each
# of pruning_forward.cu's and pruning_slot.cu's objects), the others at 20
SASS_KERNELS = {
    "B1_B4": r"row_walk_kernelILi\d+ELi\d+E(?:Li1E)?EEv|"
             r"pruning_forward_kernelI|pruning_slot_kernelI",
    "B9": r"row_walk_kernelILi\d+ELi\d+ELi[2-9]EEEv|pruning_fold_kernelI",
    "B8": r"pruning_static_kernel",
    "B2": r"pruning_saveall_kernelILi20E",
    "B7": r"classic_reverse_walk_kernelILi20E",
    "B3": r"pruning_reverse_walk_kernelILi20E",
}


def _earlier_static_header(order, children, counts, n_nodes: int,
                           n_leaves: int, s: int) -> str:
    """The header the earlier ``pruning_static.cu`` (before B8 took the
    live-row walk) is compiled against: the level post-order walk
    (``cuda_pruning._postorder_arrays``: internal nodes ``order`` (n_int,),
    their ``children`` (n_int, cmax), zero-padded, and child ``counts``
    (n_int,)), the node and leaf counts and the state count as constexpr
    values in namespace ``topo``; a copy of that version of
    ``ops/_build.static_topology_header``."""
    def c_array(values):
        return "{" + ", ".join(str(int(v)) for v in values) + "}"

    n_int, cmax = children.shape
    return "\n".join([
        "#pragma once",
        "namespace topo {",
        f"constexpr int kS = {int(s)};",
        f"constexpr int kNNodes = {int(n_nodes)};",
        f"constexpr int kNLeaves = {int(n_leaves)};",
        f"constexpr int kNInt = {int(n_int)};",
        f"constexpr int kCmax = {int(cmax)};",
        f"constexpr int kOrder[kNInt] = {c_array(order)};",
        "constexpr int kChildren[kNInt * kCmax] = "
        f"{c_array(children.reshape(-1))};",
        f"constexpr int kCounts[kNInt] = {c_array(counts)};",
        "}  // namespace topo",
        "",
    ])


def _build_earlier_static(parent: Path, walk, s: int, label: str, nvcc_flags,
                          nvcc):
    """The earlier B8 for ``walk``'s topology at ``s`` states: (library
    bound with its earlier signature, path, build seconds, ptxas
    output)."""
    include = OUT_DIR / f"static_earlier_{label}"
    include.mkdir(parents=True, exist_ok=True)
    (include / "pruning_static_topology.h").write_text(_earlier_static_header(
        walk.order, walk.children, walk.counts, walk.n_nodes, walk.n_leaves,
        s))
    lib_path = OUT_DIR / f"libstatic_earlier_{label}.so"
    t0 = time.perf_counter()
    res = subprocess.run(
        [nvcc, *nvcc_flags, "-I", str(include), "-shared", "-o",
         str(lib_path), str(parent / STATIC_SOURCE)],
        capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on the earlier {STATIC_SOURCE}\n"
                           f"{res.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.pruning_static_f32.argtypes = ([ctypes.c_void_p] * 6
                                       + [ctypes.c_int] * 7
                                       + [ctypes.c_void_p])
    lib.pruning_static_f32.restype = ctypes.c_int
    return lib, lib_path, seconds, res.stdout + res.stderr


def _build_parent(parent: Path, nvcc_flags, nvcc):
    """The earlier sources but B8 as one library: (library bound for the
    shared entry points, library bound for the earlier B9, path, ptxas
    output)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = OUT_DIR / "libparent.so"
    res = subprocess.run(
        [nvcc, *nvcc_flags, "-shared", "-o", str(lib_path),
         *(str(parent / name) for name in PARENT_SOURCES
           if name != STATIC_SOURCE)],
        capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on the earlier sources\n{res.stderr}")
    from phylo_utils_tpu_torch.ops import _build

    vp, ci = ctypes.c_void_p, ctypes.c_int
    shared = ctypes.CDLL(str(lib_path))
    # the earlier entry points end at the stream: the current wrappers'
    # trailing strides (0, shared leaves) go past their last parameter
    for name, n_ptr, n_int, _ in _build.SIGNATURES:
        if name in SHARED_ENTRIES:
            fn = getattr(shared, name)
            fn.argtypes = [vp] * n_ptr + [ci] * n_int + [vp]
            fn.restype = ci
    walks = ctypes.CDLL(str(lib_path))
    walks.pruning_fold_f32.argtypes = [vp] * 9 + [ci] * 9 + [vp]
    walks.pruning_fold_f32.restype = ci
    return shared, walks, lib_path, res.stdout + res.stderr


def _sass(lib_path: Path, pattern: str):
    """{function: its SASS lines} of every function of ``lib_path`` whose
    mangled name matches ``pattern``."""
    text = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1) if re.search(pattern, m.group(1)) else None
            if name:
                out[name] = []
        elif name is not None:
            out[name].append(ln)
    return out


def _sass_counts(lines):
    """{opcode: count} of the global loads, shared-memory loads, FMAs and
    barriers in one function's SASS."""
    counts = collections.Counter()
    for ln in lines:
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                       ln)
        if op and op.group(1).startswith(("LDG", "LDS", "FFMA", "BAR")):
            counts[op.group(1)] += 1
    return dict(counts)


def _sass_key(fn: str) -> str:
    """A function's mangled name without its build's file hash and without
    B1's and B4's F = 1 (``row_walk_kernel<S, kL, 1>`` is the earlier
    ``row_walk_kernel<S, kL>``), so that both builds' functions pair up."""
    fn = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", fn)
    return re.sub(r"(row_walk_kernelILi\d+ELi\d+E)Li1E(EEv)", r"\1\2", fn)


def _sass_diff(earlier, current):
    """{function: instructions that differ} between two builds' SASS
    ({function: lines}, as ``_sass`` gives), each instruction without its
    address and encoding: 0 where the two builds emitted the same code."""
    def body(lines):
        return [m.group(1) for ln in lines
                for m in [re.search(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", ln)]
                if m]

    old = {_sass_key(fn): body(lines) for fn, lines in earlier.items()}
    out = {}
    for fn, lines in current.items():
        key = _sass_key(fn)
        if key in old:
            out[key] = sum(
                1 for ln in difflib.unified_diff(old[key], body(lines), n=0,
                                                 lineterm="")
                if ln[:1] in "+-" and not ln.startswith(("+++", "---")))
    return out


# every fold width the fold kernel is held to (2 and 4 at 4 states, 2 to 5
# at 20), at every lane count of its state count
_FOLD_PAIRS = {4: ((2, 4), (1, 2, 4)), 20: ((2, 3, 4, 5), (1, 2))}


def _fold_pairs_ptxas(nvcc, nvcc_flags):
    """ptxas's line ({kernel<S,kL,F>: registers ...; spills}) of the
    live-row kernel at every fold width and lane count of ``_FOLD_PAIRS``,
    compiled alone under ``nvcc_flags`` (the fold source's) from a
    generated source that
    takes each instantiation's address: the record of the (F, lanes) pairs
    that ``csrc/pruning_fold.cu`` leaves out for spilling."""
    from chip_smoke import _ptxas_table

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / "fold_pairs.cu"
    kernels = [f"(const void*)pruning::row_walk_kernel<{s}, {n}, {f}>"
               for s, (folds, lanes) in _FOLD_PAIRS.items()
               for f in folds for n in lanes]
    src.write_text('#include "pruning_rows.cuh"\n'
                   'extern "C" const void* fold_pairs[] = {\n    '
                   + ",\n    ".join(kernels) + "};\n")
    res = subprocess.run(
        [nvcc, *nvcc_flags, "-I", str(REPO / "phylo_utils_tpu_torch" / "csrc"),
         "-c", "-o", str(OUT_DIR / "fold_pairs.o"), str(src)],
        capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}\n{res.stderr}")
    return _ptxas_table(res.stdout + res.stderr)


def _turns(fns, reps, cuda_ms):
    """{label: mean ms} of each of ``fns`` (label -> callable) timed in
    turns: in order, then in reverse order."""
    order = list(fns) + list(fns)[::-1]
    runs = {label: [] for label in fns}
    for label in order:
        runs[label].append(cuda_ms(fns[label], reps))
    return {label: {"ms": sum(t) / len(t), "runs": t}
            for label, t in runs.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="directory of the earlier pruning_forward.cu, "
                    "pruning_reverse.cu, pruning_slot.cu, "
                    "pruning_classic_reverse.cu, pruning_fold.cu, "
                    "pruning_static.cu and the headers they include")
    ap.add_argument("--out", type=Path,
                    default=REPO / "build" / "kernel_turns.json",
                    help="where to write the JSON result")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_turns: torch.cuda.is_available() is False: this "
                 "script needs a GPU")
    from chip_smoke import (_bound, _cuda_ms, _device_us, _ptxas_table,
                            _wide_node_inputs)
    from phylo_utils_tpu_torch import models
    from phylo_utils_tpu_torch.ops import _build, cuda_pruning as cp
    from phylo_utils_tpu_torch.ops.cuda_pruning import (
        WalkSchedule, classic_reverse_walk, classic_reverse_walk_reference,
        fold_walk, forward_walk, reverse_walk, saveall_walk, slot_walk,
        static_walk)
    from phylo_utils_tpu_torch.ops.gamma import discrete_gamma
    from phylo_utils_tpu_torch.ops.pmatrix import (
        extend_p_identity, transition_matrices)
    from phylo_utils_tpu_torch.trees import compile_schedule, random_tree

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.load_library()
    cur_path = Path(_build.build_info()["path"])
    old, old_walks, old_path, old_log = _build_parent(
        args.parent, _build.NVCC_FLAGS, _build._nvcc())
    build_s = time.perf_counter() - t0
    log = _build.build_info()["log"]
    ptxas_current = _ptxas_table(log) if log else {}
    spilled = {k: v for k, v in ptxas_current.items()
               if not re.search(r"\b0 bytes spill stores", v)}
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rates = discrete_gamma(torch.tensor(0.5, dtype=torch.float64), 4).to(dev)
    eigs = {4: models.GTR.eigen({"rates": [1.2, 3.1, 0.7, 0.9, 4.2, 1.0],
                                 "freqs": [0.3, 0.2, 0.22, 0.28]},
                                dtype=torch.float64, device=dev),
            20: models.LG.eigen(dtype=torch.float64, device=dev)}

    def inputs(tree, sites, batch, s, k=4):
        """Schedule, f32 P (GTR at 4 states, LG at 20) of the gamma rates
        (k = 4) or of k rates from 0.1 to 3.0, one-hot leaves with 2%
        all-ones rows, f64 frequencies."""
        sched = compile_schedule(tree)
        lengths = np.asarray(tree.lengths)
        if batch > 1:
            lengths = lengths * rng.uniform(0.5, 2.0, (batch, 1))
        t = torch.as_tensor(lengths, dtype=torch.float64, device=dev)
        r = rates if k == 4 else torch.linspace(0.1, 3.0, k,
                                                dtype=torch.float64,
                                                device=dev)
        p = extend_p_identity(transition_matrices(
            eigs[s], t[..., None] * r, out_dtype=torch.float32),
            sched.n_nodes).contiguous()
        leaves = np.eye(s, dtype=np.float32)[
            rng.integers(0, s, (tree.n_leaves, sites))]
        leaves[rng.random((tree.n_leaves, sites)) < 0.02] = 1.0
        return (WalkSchedule(sched), p, torch.as_tensor(leaves, device=dev),
                eigs[s].freqs)

    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def earlier(fn, *a, **kw):
        """``fn`` (a current wrapper) run against the earlier library."""
        def run():
            saved = _build._lib
            _build._lib = old
            try:
                return fn(*a, **kw)
            finally:
                _build._lib = saved
        return run

    def old_lowering(walk, p, leaves, fold=1, lib=None):
        """The earlier B9 (``fold`` categories a thread) or, with ``lib``,
        the earlier B8: whole-tree scratch in device memory."""
        pb = p if p.dim() == 5 else p[None]
        b, _, k = pb.shape[:3]
        sites, s = leaves.shape[1:]
        n_inner = walk.n_nodes - walk.n_leaves
        order, children, counts = walk.on(dev)
        xs = torch.empty((b, k, n_inner, sites, s), device=dev)
        es = torch.empty((b, k, n_inner, sites), device=dev)
        root = torch.empty((b, k, sites, s), device=dev)
        root_e = torch.empty((b, k, sites), device=dev)
        buffers = (xs.data_ptr(), es.data_ptr(), root.data_ptr(),
                   root_e.data_ptr())
        if lib is None:
            rc = old_walks.pruning_fold_f32(
                pb.data_ptr(), leaves.data_ptr(), order.data_ptr(),
                children.data_ptr(), counts.data_ptr(), *buffers, b, k, s,
                fold, walk.n_nodes, walk.n_leaves, len(walk.order),
                children.shape[1], sites, stream())
        else:
            rc = lib.pruning_static_f32(
                pb.data_ptr(), leaves.data_ptr(), *buffers, b, k, s,
                walk.n_nodes, walk.n_leaves, len(walk.order), sites,
                stream())
        assert rc == 0, f"earlier B8 / B9: CUDA error {rc}"
        return (root, root_e) if p.dim() == 5 else (root[0], root_e[0])

    tree_flag = random_tree(64, seed=0)
    tree_config4 = random_tree(32, seed=13, mean_brlen=0.2)
    shapes = {
        "flagship_B1": inputs(tree_flag, 1024, 1, 4),
        "flagship_B64": inputs(tree_flag, 1024, 64, 4),
        "config4_S20": inputs(tree_config4, 1024, 1, 20),
        "dna1000": inputs(random_tree(1000, seed=10), 8192, 1, 4),
        "protein512_LG": inputs(random_tree(512, seed=11), 8192, 1, 20),
        "wide_node_S4": _wide_node_inputs(eigs[4], rates, 8192, rng, dev),
        "wide_node_S20": _wide_node_inputs(eigs[20], rates, 8192, rng, dev),
        # B9's widths: 12 categories at 4 states, 60 at 20
        "widths_S4_K12": inputs(tree_flag, 1024, 1, 4, 12),
        "widths_S20_K60": inputs(tree_config4, 1024, 1, 20, 60),
    }
    reps_of = {"flagship_B1": 200, "flagship_B64": 50, "config4_S20": 100,
               "dna1000": 20, "protein512_LG": 5, "wide_node_S4": 20,
               "wide_node_S20": 3, "widths_S4_K12": 50, "widths_S20_K60": 10}
    # the value walks only: the gradient kernels were not changed there
    value_only = ("config4_S20", "dna1000", "widths_S4_K12",
                  "widths_S20_K60")
    # B9's fold widths by shape (F = 2, the DNA pack's, and every compiled
    # F that divides K at config 4 and the widths)
    folds_of = {label: (2,) for label in (
        "flagship_B1", "flagship_B64", "wide_node_S4", "wide_node_S20")}
    folds_of.update({label: tuple(
        f_ for f_ in cp.FOLD_WIDTHS[shapes[label][2].shape[2]]
        if shapes[label][1].shape[-3] % f_ == 0)
        for label in ("config4_S20", "widths_S4_K12", "widths_S20_K60")})
    # B8 by shape: the topology its libraries are built for
    static_of = {"flagship_B1": "flagship", "flagship_B64": "flagship",
                 "config4_S20": "config4", "wide_node_S4": "wide_node_S4"}
    # B8's libraries, current and earlier, one topology at a time, so that
    # each build's seconds are its own
    static_old, static_cur, b8_build = {}, {}, {}
    for label, top in static_of.items():
        if top in static_old:
            continue
        walk, s = shapes[label][0], shapes[label][2].shape[2]
        before = set(_build.static_build_info())
        walk.static_library(s)
        (key,) = set(_build.static_build_info()) - before
        static_cur[top] = _build.static_build_info()[key]
        static_old[top] = _build_earlier_static(
            args.parent, walk, s, top, _build.NVCC_FLAGS, _build._nvcc())
        b8_build[top] = {"states": s, "edges": len(walk.slots.rows.edges),
                         "current_s": static_cur[top]["seconds"],
                         "earlier_s": static_old[top][2]}
    print(json.dumps({"b8_build_s": b8_build}), flush=True)
    for info in static_cur.values():
        spilled.update({k: v for k, v in _ptxas_table(info["log"]).items()
                        if not re.search(r"\b0 bytes spill stores", v)})
    result = {"card": smi, "build_s": build_s, "b8_build_s": b8_build,
              "checks": {}, "turns": {}, "device_us": {}, "sweeps": {}}
    failed = []
    for label, (walk, p, leaves, f64) in shapes.items():
        f = f64.float()
        s = leaves.shape[2]
        cmax = walk.children.shape[1]
        reps = reps_of[label]
        ob1 = earlier(forward_walk, p, leaves, walk, walk="classic")()
        chk = {"cmax": cmax, "rows_b1": walk.rows.n_rows,
               "rows_b4": walk.slots.rows.n_rows}
        ok = True
        # B1 and B4 with 0, 1 and all rows on the SM: the earlier B1's bits
        for kind in ("forward", "slot"):
            rows = (walk.rows if kind == "forward" else walk.slots.rows).n_rows
            b = p.shape[0] if p.dim() == 5 else 1
            fit = cp.row_geometry(b, p.shape[-3], leaves.shape[1], s,
                                  rows).smem_rows
            same = True
            for smem_rows in sorted({0, min(1, fit), fit}):
                got = cp._row_walk(p, leaves, walk, kind, smem_rows=smem_rows)
                torch.cuda.synchronize()
                same = same and torch.equal(got[0], ob1[0]) and torch.equal(
                    got[1], ob1[1])
            chk[f"b{1 if kind == 'forward' else 4}_equals_earlier_b1"] = same
            ok = ok and same
        ob4 = earlier(slot_walk, p, leaves, walk)()
        torch.cuda.synchronize()
        chk["earlier_b4_equals_earlier_b1"] = bool(
            torch.equal(ob4[0], ob1[0]) and torch.equal(ob4[1], ob1[1]))
        ok = ok and chk["earlier_b4_equals_earlier_b1"]
        kernels = {
            "B1": ("forward", functools.partial(
                forward_walk, p, leaves, walk, walk="classic"),
                earlier(forward_walk, p, leaves, walk, walk="classic")),
            "B4": ("slot", functools.partial(slot_walk, p, leaves, walk),
                   earlier(slot_walk, p, leaves, walk)),
        }
        if cmax <= 2:   # B5's ring holds 3 x cmax blocks
            sp, se = slot_walk(p, leaves, walk, stream=True)
            op, oe5 = earlier(slot_walk, p, leaves, walk, stream=True)()
            torch.cuda.synchronize()
            chk["b5_equals_earlier_and_b1"] = bool(
                torch.equal(sp, op) and torch.equal(se, oe5)
                and torch.equal(sp, ob1[0]) and torch.equal(se, ob1[1]))
            ok = ok and chk["b5_equals_earlier_and_b1"]
            kernels["B5"] = ("stream", functools.partial(
                slot_walk, p, leaves, walk, stream=True),
                earlier(slot_walk, p, leaves, walk, stream=True))
        if label not in value_only:
            # B3 holds the visit's children in its stage, or raises
            try:
                cp.reverse_tile(s, cmax)
                has_b3 = True
            except ValueError:
                has_b3 = False
            rx, re_ = saveall_walk(p, leaves, walk)
            ox, oe = earlier(saveall_walk, p, leaves, walk)()
            row = walk.root - walk.n_leaves
            lam = (1.0 / torch.einsum("...ksi,i->...ks",
                                      rx[..., row, :, :].double(), f64)
                   ).float().contiguous()
            gseed = (lam[..., None] * f).unsqueeze(-3).contiguous()
            root = [walk.root]
            seeds = [walk.root, int(walk.order[len(walk.order) // 2])]
            g2 = torch.as_tensor(rng.uniform(
                0.5, 1.5, gseed.shape[:-3] + (2,) + gseed.shape[-2:]),
                dtype=torch.float32, device=dev)
            d7, l7 = classic_reverse_walk(p, leaves, rx, re_, gseed, root,
                                          walk, True)
            d7b, _ = classic_reverse_walk(p, leaves, rx, re_, gseed, root,
                                          walk)
            o7, ol7 = earlier(classic_reverse_walk, p, leaves, rx, re_, gseed,
                              root, walk, True)()
            e7, el7 = classic_reverse_walk(p, leaves, rx, re_, g2, seeds,
                                           walk, True)
            oe7, oel7 = earlier(classic_reverse_walk, p, leaves, rx, re_, g2,
                                seeds, walk, True)()
            torch.cuda.synchronize()
            w7, wl7 = classic_reverse_walk_reference(p, leaves, rx, re_,
                                                     gseed, root, walk, True)
            scale = float(w7.abs().max())
            chk.update({
                "b2_equals_earlier": bool(torch.equal(rx, ox)
                                          and torch.equal(re_, oe)),
                "b2_root_equals_b1": bool(
                    torch.equal(rx[..., row, :, :], ob1[0])
                    and torch.equal(re_[..., row, :], ob1[1])),
                "b7_vs_plain": float((d7 - w7).abs().max()) / scale,
                "b7_dleaf_vs_plain": float((l7 - wl7).abs().max())
                / float(wl7.abs().max()),
                "b7_vs_earlier": float((d7 - o7).abs().max()) / scale,
                "b7_two_seeds_vs_earlier": float((e7 - oe7).abs().max())
                / float(oe7.abs().max()),
                "b7_dleaf_equals_earlier": bool(torch.equal(l7, ol7)
                                                and torch.equal(el7, oel7)),
                "b7_repeat_equal": bool(torch.equal(d7, d7b)),
                "b7_root_row_zero": float(
                    d7.select(-4, walk.root).abs().max()) == 0.0,
                "b7_stage_children": cp.classic_reverse_stage(s, cmax)[0],
            })
            ok = (ok and chk["b2_equals_earlier"] and chk["b2_root_equals_b1"]
                  and max(chk["b7_vs_plain"], chk["b7_vs_earlier"],
                          chk["b7_two_seeds_vs_earlier"]) <= TOL
                  and chk["b7_dleaf_equals_earlier"]
                  and chk["b7_repeat_equal"] and chk["b7_root_row_zero"])
            kernels["B2"] = ("saveall", functools.partial(
                saveall_walk, p, leaves, walk),
                earlier(saveall_walk, p, leaves, walk))
            kernels["B7"] = ("classic", functools.partial(
                classic_reverse_walk, p, leaves, rx, re_, gseed, root, walk),
                earlier(classic_reverse_walk, p, leaves, rx, re_, gseed, root,
                        walk))
            if has_b3:
                d3, l3 = reverse_walk(p, leaves, rx, re_, lam, f, walk, True)
                o3, ol3 = earlier(reverse_walk, p, leaves, rx, re_, lam, f,
                                  walk, True)()
                torch.cuda.synchronize()
                chk["b7_dleaf_equals_b3"] = bool(torch.equal(l7, l3))
                chk["b3_equals_earlier"] = bool(torch.equal(d3, o3)
                                                and torch.equal(l3, ol3))
                ok = (ok and chk["b7_dleaf_equals_b3"]
                      and chk["b3_equals_earlier"])
                kernels["B3"] = ("reverse", functools.partial(
                    reverse_walk, p, leaves, rx, re_, lam, f, walk),
                    earlier(reverse_walk, p, leaves, rx, re_, lam, f, walk))
                del d3, l3, o3, ol3
            del ox, oe, d7, d7b, o7, e7, oe7, w7, wl7
        # B9 (F categories a column) and B8 (the walk compiled in) with 0, 1
        # and all of the slot walk's rows on the SM: the earlier B1's bits,
        # and the earlier B9's and B8's
        rows = walk.slots.rows.n_rows
        lowerings = [(f"B9_F{f_}", functools.partial(fold_walk, p, leaves,
                                                     walk, f_),
                      functools.partial(old_lowering, walk, p, leaves, f_))
                     for f_ in folds_of.get(label, ())]
        if label in static_of:
            lowerings.append((
                "B8", functools.partial(static_walk, p, leaves, walk),
                functools.partial(old_lowering, walk, p, leaves,
                                  lib=static_old[static_of[label]][0])))
        for name, new_fn, old_fn in lowerings:
            same = True
            for smem_rows in sorted({0, 1, rows}):
                got = new_fn(smem_rows=smem_rows)
                torch.cuda.synchronize()
                same = same and torch.equal(got[0], ob1[0]) and torch.equal(
                    got[1], ob1[1])
            got = old_fn()
            torch.cuda.synchronize()
            chk[f"{name}_equals_earlier_b1"] = same
            chk[f"earlier_{name}_equals_earlier_b1"] = bool(
                torch.equal(got[0], ob1[0]) and torch.equal(got[1], ob1[1]))
            ok = (ok and same and chk[f"earlier_{name}_equals_earlier_b1"])
            kernels[name] = ("forward", new_fn, old_fn)
        result["checks"][label] = chk
        if not ok:
            failed.append(label)
            print(json.dumps({label: chk}), flush=True)
            continue
        for name, (kind, new_fn, old_fn) in kernels.items():
            t = [_cuda_ms(old_fn, reps), _cuda_ms(new_fn, reps),
                 _cuda_ms(new_fn, reps), _cuda_ms(old_fn, reps)]
            bound_ms, bound_by = _bound(kind, walk, p, leaves)
            new_ms, old_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            result["turns"][f"{name}_{label}"] = {
                "earlier_ms": old_ms, "ms": new_ms, "runs": t,
                "speedup": old_ms / new_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "bound_share": bound_ms / new_ms,
                "earlier_bound_share": bound_ms / old_ms}
            result["device_us"][f"{name}_{label}"] = {
                "earlier": _device_us(old_fn, min(reps, 20)),
                "current": _device_us(new_fn, min(reps, 20))}
        # sweeps of the launch settings, each in turns
        sweeps = {}
        b = p.shape[0] if p.dim() == 5 else 1
        for name, kind in (("B1", "forward"), ("B4", "slot")):
            if label.startswith(("wide_node", "widths")):
                break
            rows = (walk.rows if kind == "forward" else walk.slots.rows).n_rows
            geo = functools.partial(cp.row_geometry, b, p.shape[-3],
                                    leaves.shape[1], s, rows)
            fit = geo().smem_rows

            def takes(**kw):   # the geometry refuses a ring that cannot fit
                try:
                    geo(**kw)
                    return True
                except ValueError:
                    return False

            settings = {
                f"lanes{n}_cols{c}_chunk{k}_leaves{int(st)}": dict(
                    lanes=n, cols=c, chunk=k, stage_leaves=st)
                for n in cp._ROW_LANES[s] for c in (32, 64, 128, 256)
                if c * n <= 256 for k in (2, 4, 8, 16)
                for st in ((False, True) if s == 4 else (False,))
                if takes(lanes=n, cols=c, chunk=k, stage_leaves=st)}
            settings.update({f"smem_rows{m}": dict(smem_rows=m)
                             for m in sorted({0, min(1, fit), fit // 2, fit})})
            sweeps[name] = _turns({
                k: functools.partial(cp._row_walk, p, leaves, walk, kind, **v)
                for k, v in settings.items()}, reps, _cuda_ms)
        # B9's F x lanes x step x columns and B8's lanes x columns and rows
        # on the SM (its step is compiled in)
        if label in ("flagship_B64", "config4_S20", "widths_S20_K60"):
            k = p.shape[-3]
            rows = walk.slots.rows.n_rows
            for name, fold in [(f"B9_F{f_}", f_) for f_ in folds_of[label]] + (
                    [("B8", 1)] if label in static_of else []):
                chunks = (cp._STATIC_CHUNK,) if name == "B8" else (2, 4, 8)
                geo = functools.partial(cp.row_geometry, b, k,
                                        leaves.shape[1], s, rows, fold=fold)

                def takes(**kw):   # a ring that cannot fit is refused
                    try:
                        geo(**kw)
                        return True
                    except ValueError:
                        return False

                settings = {
                    f"lanes{n}_cols{c}_chunk{k_}": dict(lanes=n, cols=c,
                                                        chunk=k_)
                    for n in cp._ROW_LANES[s] for c in (32, 64, 128, 256)
                    if c * n <= 256 for k_ in chunks
                    if takes(lanes=n, cols=c, chunk=k_)}
                if name == "B8":
                    settings.update({f"smem_rows{m}": dict(smem_rows=m)
                                     for m in sorted({0, 1, rows})})
                run = kernels[name][1]
                sweeps[name] = _turns({
                    key: functools.partial(run, **kw)
                    for key, kw in settings.items()}, reps, _cuda_ms)
        if "B2" in kernels:
            b2 = kernels["B2"][1]
            b7 = kernels["B7"][1]
            saved = (dict(cp._SAVEALL_CHUNK), dict(cp._SAVEALL_LANES),
                     dict(cp._CLASSIC_REVERSE_BLOCKS),
                     cp._CLASSIC_REVERSE_TILE, cp._CLASSIC_STAGE_BYTES)

            def setting(**kw):
                def run(fn):
                    cp._SAVEALL_CHUNK[s] = kw.get("chunk", saved[0][s])
                    cp._SAVEALL_LANES[s] = kw.get("lanes", saved[1][s])
                    cp._CLASSIC_REVERSE_BLOCKS[s] = kw.get("blocks",
                                                           saved[2][s])
                    cp._CLASSIC_REVERSE_TILE = kw.get("tile", saved[3])
                    cp._CLASSIC_STAGE_BYTES = kw.get("stage_bytes", saved[4])
                    return fn()
                return run

            try:
                chunks = (16, 32, 64, 128) if s == 4 else (4, 8, 16)
                sweeps["B2"] = _turns({
                    f"chunk{c}_lanes{n}": functools.partial(
                        setting(chunk=c, lanes=n), b2)
                    for c in chunks for n in (1, 2)}, reps, _cuda_ms)
                b7_settings = {f"blocks{n}_tile256": dict(blocks=n, tile=256)
                               for n in (264, 528, 1056)}
                b7_settings["blocks1056_tile128"] = dict(blocks=1056, tile=128)
                if label == "wide_node_S20":
                    b7_settings.update({
                        f"stage_bytes{n}": dict(stage_bytes=n)
                        for n in (101_760, 132_160, 232_448)})
                sweeps["B7"] = _turns({
                    k: functools.partial(setting(**v), b7)
                    for k, v in b7_settings.items()}, reps, _cuda_ms)
            finally:
                (chunk, lanes, blocks, cp._CLASSIC_REVERSE_TILE,
                 cp._CLASSIC_STAGE_BYTES) = saved
                cp._SAVEALL_CHUNK.update(chunk)
                cp._SAVEALL_LANES.update(lanes)
                cp._CLASSIC_REVERSE_BLOCKS.update(blocks)
            del rx, re_
        result["sweeps"][label] = sweeps
        print(json.dumps({label: {"checks": chk, "turns": {
            k: v for k, v in result["turns"].items() if k.endswith(label)},
            "sweeps": sweeps}}), flush=True)
        del kernels
        torch.cuda.empty_cache()
    sass = {}
    libs = {"earlier": [old_path] + [v[1] for v in static_old.values()],
            "current": [cur_path] + [Path(v["path"])
                                     for v in static_cur.values()]}
    for kernel, pattern in SASS_KERNELS.items():
        for which, path in [(w, x) for w, paths in libs.items()
                            for x in paths]:
            for i, (fn, lines) in enumerate(_sass(path, pattern).items()):
                sass[f"{kernel} {which} {path.stem} {fn}"] = _sass_counts(
                    lines)
                (OUT_DIR / f"{kernel}_{which}_{path.stem}_{i}.sass"
                 ).write_text(f"{fn}\n" + "\n".join(lines))
    result["sass"] = sass
    # B1 and B4 (F = 1) instruction for instruction against the earlier
    # build's
    result["sass_diff_b1_b4"] = _sass_diff(
        _sass(old_path, SASS_KERNELS["B1_B4"]),
        _sass(cur_path, SASS_KERNELS["B1_B4"]))
    result["ptxas_fold_pairs"] = _fold_pairs_ptxas(
        _build._nvcc(), (*_build.NVCC_FLAGS,
                         *_build.PTXAS_FLAGS["pruning_fold.cu"]))
    result["ptxas_earlier"] = _ptxas_table(old_log)
    result["ptxas_b8"] = {
        top: {"earlier": _ptxas_table(static_old[top][3]),
              "current": _ptxas_table(static_cur[top]["log"])}
        for top in static_old}
    result["ptxas_current"] = ptxas_current or "library reused"
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    if failed or spilled:
        sys.exit(f"kernel_turns: checks failed at {failed}; spills: "
                 f"{spilled}")


if __name__ == "__main__":
    main()
