"""Times phases of ``chip_smoke.py`` alone, for one or more checkouts, on
the card (two versions are compared only within one call).

  python scripts/smoke_phases.py [--phases 30,31,32,33,34] [--logs DIR] \\
      ROOT [ROOT ...]

Each ROOT is the root of a checkout (this repo, or the parent commit
unpacked by ``git archive`` into a directory that ``.gitignore`` lists);
repeat a root to interleave them (parent, change, change, parent). For
each ROOT in the order given, a fresh process with ROOT first on its path:

- builds the kernels' library and the flagship topology's B8 library
  (phase 34 runs it) before any timing;
- times a fresh ``python -c "import torch"`` and ``python -c "import
  phylo_utils_tpu_torch.cli"`` (the median of 3 each: the import that
  every CLI subprocess of the phases pays);
- times a small engine's ``loglikelihood`` and ``value_and_grad``
  (``random_tree(8)`` x 200 random DNA sites, GTR+G4, f32, ``pruner=
  "cuda"``; the median of 50 calls, where the host's work a call
  dominates);
- runs the named phases of ROOT's ``chip_smoke.py`` in order, through its
  path functions (30 ``_simulation_path``, 31 ``_site_models_path``, 32
  ``_search_path``, 33 ``_partition_path``, 34 ``_analyses_path``, 35
  ``_sharding_path``, 36 ``_examples_path``), each timed by the host clock;
  they run their own checks, and a failed check ends the process; then,
  where ROOT's script queues the phases' subprocesses, runs them side by
  side (its phase 37, ``_run_deferred``), timed as "37".

Prints the card's name and power limit, then one JSON line a ROOT (the
phases' own lines go to ``--logs``, by default ``build/smoke_phases/``)
and a last line of the seconds a phase for each ROOT. Exits 1 if any
ROOT's process failed.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

_PATHS = {30: "_simulation_path", 31: "_site_models_path",
          32: "_search_path", 33: "_partition_path", 34: "_analyses_path",
          35: "_sharding_path", 36: "_examples_path"}
_COUNTERS = ("LAUNCHES", "SLOT_LAUNCHES", "STREAM_LAUNCHES",
             "SAVEALL_LAUNCHES", "REVERSE_LAUNCHES",
             "CLASSIC_REVERSE_LAUNCHES", "STATIC_LAUNCHES", "FOLD_LAUNCHES")


def _import_s(root: Path, module: str) -> float:
    """Median wall seconds of a fresh interpreter importing ``module``."""
    env = {**os.environ, "PYTHONPATH": str(root)}
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", f"import {module}"], cwd=root,
                       env=env, check=True)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _median_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _child(root: Path, phases, smi: str) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from phylo_utils_tpu_torch import models
    from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
    from phylo_utils_tpu_torch.ops import _build, cuda_pruning
    from phylo_utils_tpu_torch.ops.cuda_pruning import WalkSchedule
    from phylo_utils_tpu_torch.trees import compile_schedule, random_tree

    out = {"root": str(root)}
    t0 = time.perf_counter()
    _build.load_library()
    WalkSchedule(compile_schedule(random_tree(cs.TAXA, seed=0))
                 ).static_library(4)
    out["build_s"] = time.perf_counter() - t0
    out["import_torch_s"] = _import_s(root, "torch")
    out["import_cli_s"] = _import_s(root, "phylo_utils_tpu_torch.cli")

    tree = random_tree(8, seed=0)
    rng = np.random.default_rng(0)
    aln = {n: "".join(rng.choice(list("ACGT"), size=200))
           for n in tree.leaf_names}
    small = LikelihoodEngine(tree, aln, models.GTR, ncat=4,
                             dtype=torch.float32, pruner="cuda",
                             device="cuda")
    out["small_value_ms"] = _median_ms(small.loglikelihood, 50)
    out["small_value_and_grad_ms"] = _median_ms(small.value_and_grad, 50)

    def reset_counts():
        for name in _COUNTERS:
            setattr(cuda_pruning, name, 0)
        cuda_pruning.LAUNCHES_BY_STATES.clear()

    def read_counts():
        return {**{n: getattr(cuda_pruning, n) for n in _COUNTERS},
                **{f"{n}@{s}": v for (n, s), v in
                   sorted(cuda_pruning.LAUNCHES_BY_STATES.items())}}

    dev = torch.device(cs.DEVICE)
    out["phase_s"] = {}
    for phase in phases:
        fn = getattr(cs, _PATHS[phase])
        args = (dev, reset_counts, read_counts) + (() if phase == 30
                                                   else (smi,))
        t0 = time.perf_counter()
        fn(*args)
        out["phase_s"][str(phase)] = time.perf_counter() - t0
    if getattr(cs, "_DEFERRED", None):
        # the subprocesses those phases queued, side by side (phase 37)
        t0 = time.perf_counter()
        cs._run_deferred()
        out["phase_s"]["37"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python scripts/smoke_phases.py")
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--phases", default="30,31,32,33,34")
    ap.add_argument("--logs", default="build/smoke_phases")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--smi", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = [int(p) for p in args.phases.split(",")]
    if args.child:
        out = _child(Path(args.roots[0]).resolve(), phases, args.smi)
        print(json.dumps(out), flush=True)
        return 0

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    logs = Path(args.logs).resolve()
    logs.mkdir(parents=True, exist_ok=True)
    rows, failed = [], False
    for i, root in enumerate(args.roots):
        root = Path(root).resolve()
        log = logs / f"{i}_{root.name}.log"
        with open(log, "w") as fh:
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--child",
                 "--phases", args.phases, "--smi", smi, str(root)],
                cwd=root, env={**os.environ, "PYTHONPATH": str(root)},
                stdout=subprocess.PIPE, stderr=fh, text=True)
            fh.write(proc.stdout)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            failed = True
            rows.append({"root": str(root), "rc": proc.returncode,
                         "tail": lines[-3:]})
        else:
            rows.append(json.loads(lines[-1]))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"card": smi, "phase_s": [
        {"root": r["root"], **r.get("phase_s", {})} for r in rows]}),
        flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
