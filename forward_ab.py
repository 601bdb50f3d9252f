#!/usr/bin/env python3
"""Time the port's forward walk kernels against an earlier version of their
sources, in turns, on one NVIDIA GPU, at shapes whose batch shares one set
of leaves: B1 (``pruning_forward_f32``), B4 (``pruning_slot_f32``), B5
(``pruning_stream_f32``), B9 (``pruning_fold_f32``, two categories a
column) and B8 (``pruning_static_f32``, built per topology).

Usage, from the root of a checkout::

    python3 forward_ab.py --parent DIR [--out FILE] [--reps N]

``DIR`` holds the earlier ``csrc/`` sources, for example unpacked from an
earlier commit with ``git archive <commit> phylo_utils_tpu_torch/csrc |
tar -x -C DIR --strip-components 2``. Their entry points must take the
current ones' arguments up to the stream: the current wrappers pass the
trailing per-batch strides (0 for shared leaves), which an earlier library
without them ignores. Both libraries, and B8's for each topology, are built
with ``ops/_build.py``'s flags, every ``nvcc`` at once, into
``build/forward_ab/`` and ``build/phylo_utils_tpu_torch/``.

Shapes: the flagship (``random_tree(64, seed=0)``, 4 states, 4 categories,
1024 sites) at B = 1 and 64, BASELINE config 4's tree (32 taxa, 20 states)
and the vertebrate-mito tree (32 taxa, 64 states) at 1024 sites, and the
1000-taxon DNA and 512-taxon protein trees at 8192 patterns (B8 only on
the first three: the others are past its unrolled budget). P comes from a
random reversible model at each state count, the leaves are one-hot with
2% all-ones rows, made from a fixed seed.

For each shape and kernel it checks that the current build's root partials
and exponents are bit for bit the earlier build's, and times the two in
turns (earlier, current, current, earlier; CUDA events over ``--reps``
launches each, after a warm launch). It lists both builds' ptxas lines
(registers, spills) of every kernel. It prints the card's ``nvidia-smi``
name and power limit, then one JSON object, also written to ``--out``
(default ``build/forward_ab.json``), and exits 1 when a root differs or a
kernel of the current build spilled.
"""
import argparse
import concurrent.futures
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "build" / "forward_ab"
# (label, taxa, tree seed, mean branch length, states, sites, batch, B8)
SHAPES = (
    ("flagship_B1", 64, 0, 0.1, 4, 1024, 1, True),
    ("flagship_B64", 64, 0, 0.1, 4, 1024, 64, True),
    ("config4", 32, 13, 0.2, 20, 1024, 1, True),
    ("mito", 32, 28, 0.1, 64, 1024, 1, True),
    ("big_dna", 1000, 10, 0.1, 4, 8192, 1, False),
    ("big_protein", 512, 11, 0.1, 20, 8192, 1, False),
)
K = 4
FOLD = 2


def _ptxas(log: str) -> dict:
    """{kernel function: its ptxas usage line and spill line}."""
    out, name, spill = {}, None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "registers" in ln and name is not None:
            out[name] = f"{ln.split(':', 1)[1].strip()}; {spill}"
            name = None
    return out


def _build_earlier(parent: Path):
    """The earlier main library, bound as the current one: (library, ptxas
    output)."""
    from phylo_utils_tpu_torch.ops import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    units = [(src, _build.PTXAS_FLAGS.get(src.name, ()))
             for src in sorted(parent.glob("*.cu"))
             if src.name != _build.STATIC_SOURCE.name]
    target = OUT_DIR / "libearlier.so"
    log = _build._compile(units, target)
    return _build._bind(ctypes.CDLL(str(target))), log


def _build_earlier_static(parent: Path, walk, s: int, label: str):
    """The earlier B8 library of ``walk``'s topology at ``s`` states, at
    every lane count, bound as the current one: (library, ptxas output)."""
    from phylo_utils_tpu_torch.ops import _build, cuda_pruning

    rw = walk.slots.rows
    include = OUT_DIR / f"static_{label}"
    include.mkdir(parents=True, exist_ok=True)
    (include / _build.STATIC_HEADER).write_text(_build.static_topology_header(
        rw.edges, rw.eword, rw.n_rows, walk.n_nodes, walk.n_leaves, s,
        cuda_pruning._static_chunk(s)))
    lanes = cuda_pruning._ROW_LANES[s]
    flags = _build.PTXAS_FLAGS[_build.STATIC_SOURCE.name]
    target = OUT_DIR / f"libearlier_static_{label}.so"
    log = _build._compile(
        [(parent / _build.STATIC_SOURCE.name,
          ("-I", str(include), f"-DPRUNING_STATIC_LANES={n}", *flags))
         for n in lanes], target)
    lib = ctypes.CDLL(str(target))
    for n in lanes:
        fn = getattr(lib, f"pruning_static_f32_l{n}")
        fn.argtypes = _build._argtypes(*_build.STATIC_SIGNATURE)
        fn.restype = ctypes.c_int
    return lib, log


def _inputs(taxa, seed, mean_brlen, s, sites, batch, rng, dev):
    """(current walk, earlier walk, P (B?, n_nodes, K, S, S), leaves)."""
    import numpy as np
    import torch

    from phylo_utils_tpu_torch.models.base import eigen_reversible
    from phylo_utils_tpu_torch.ops.cuda_pruning import WalkSchedule
    from phylo_utils_tpu_torch.ops.pmatrix import (
        extend_p_identity,
        transition_matrices,
    )
    from phylo_utils_tpu_torch.trees import compile_schedule, random_tree

    tree = random_tree(taxa, seed=seed, mean_brlen=mean_brlen)
    sched = compile_schedule(tree)
    sym = rng.uniform(0.2, 3.0, (s, s))
    sym = torch.as_tensor(sym + sym.T)
    freqs = torch.as_tensor(rng.dirichlet(np.full(s, 5.0)))
    eig = eigen_reversible(sym, freqs)
    rates = torch.as_tensor([0.1, 0.5, 1.2, 2.2], dtype=torch.float64)
    lengths = torch.as_tensor(np.asarray(tree.lengths), dtype=torch.float64)
    if batch > 1:
        lengths = lengths * torch.as_tensor(rng.uniform(0.5, 2.0, (batch, 1)))
    p = transition_matrices(eig, lengths[..., None] * rates,
                            out_dtype=torch.float32)
    p = extend_p_identity(p, sched.n_nodes).contiguous().to(dev)
    codes = rng.integers(0, s, (tree.n_leaves, sites))
    leaves = np.eye(s, dtype=np.float32)[codes]
    leaves[rng.random((tree.n_leaves, sites)) < 0.02] = 1.0
    return (WalkSchedule(sched), WalkSchedule(sched), p,
            torch.as_tensor(leaves, device=dev))


def _cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="directory of the earlier csrc/ sources")
    ap.add_argument("--out", type=Path,
                    default=REPO / "build" / "forward_ab.json")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("forward_ab.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(REPO))
    from phylo_utils_tpu_torch.ops import _build, cuda_pruning

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(15)
    cases = [(label, s, batch, b8,
              _inputs(taxa, seed, mbl, s, sites, batch, rng, dev))
             for label, taxa, seed, mbl, s, sites, batch, b8 in SHAPES]

    # every build at once: the two main libraries and both B8s a topology
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        cur = pool.submit(_build.load_library)
        old = pool.submit(_build_earlier, args.parent)
        statics = [(label, pool.submit(walk.static_library, s),
                    pool.submit(_build_earlier_static, args.parent, walk_old,
                                s, label), walk_old, s)
                   for label, s, _, b8, (walk, walk_old, _, _) in cases if b8]
        current_lib = cur.result()
        earlier_lib, earlier_log = old.result()
        ptxas = {"current": _ptxas(_build.build_info()["log"]),
                 "earlier": _ptxas(earlier_log)}
        for label, cur_static, old_static, walk_old, s in statics:
            cur_static.result()
            lib, log = old_static.result()
            walk_old._static[s] = lib
            ptxas["earlier"].update(
                {f"{label}:{k}": v for k, v in _ptxas(log).items()})
    for key, info in _build.static_build_info().items():
        ptxas["current"].update(
            {f"static_{key[:6]}:{k}": v for k, v in _ptxas(info["log"]).items()})
    spilled = {k: v for k, v in ptxas["current"].items()
               if " 0 bytes spill stores" not in v}

    def use(lib):
        _build._lib = lib

    kernels = {
        "B1": lambda p, lv, w: cuda_pruning._row_walk(p, lv, w, "forward"),
        "B4": lambda p, lv, w: cuda_pruning._row_walk(p, lv, w, "slot"),
        "B5": lambda p, lv, w: cuda_pruning.slot_walk(p, lv, w, stream=True),
        "B9": lambda p, lv, w: cuda_pruning.fold_walk(p, lv, w, FOLD),
        "B8": lambda p, lv, w: cuda_pruning.static_walk(p, lv, w),
    }
    rows, same = [], True
    for label, s, batch, b8, (walk, walk_old, p, leaves) in cases:
        for name, fn in kernels.items():
            if name == "B8" and not b8:
                continue
            use(earlier_lib)
            want = fn(p, leaves, walk_old)
            use(current_lib)
            got = fn(p, leaves, walk)
            bits = all(torch.equal(a, b) for a, b in zip(got, want))
            same &= bits
            times = []
            for lib, w in ((earlier_lib, walk_old), (current_lib, walk),
                           (current_lib, walk), (earlier_lib, walk_old)):
                use(lib)
                times.append(_cuda_ms(lambda: fn(p, leaves, w), args.reps))
            earlier_ms = (times[0] + times[3]) / 2
            current_ms = (times[1] + times[2]) / 2
            rows.append({"shape": label, "states": s, "batch": batch,
                         "kernel": name, "bits_equal": bits,
                         "earlier_ms": earlier_ms, "current_ms": current_ms,
                         "current_over_earlier": current_ms / earlier_ms,
                         "turns_ms": times})
            print(json.dumps(rows[-1]), flush=True)
    use(current_lib)
    out = {"card": smi, "torch": torch.__version__,
           "cuda": torch.version.cuda, "parent": str(args.parent),
           "reps": args.reps, "rows": rows, "bits_equal": same,
           "current_spills": spilled, "ptxas": ptxas}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if k != "ptxas"}))
    sys.exit(0 if same and not spilled else 1)


if __name__ == "__main__":
    main()
