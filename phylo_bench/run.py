#!/usr/bin/env python3
"""The benchmark of ``phylo_utils_tpu_torch`` on one CUDA card.

    python3 phylo_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json``: makes the cell's inputs from the
seed on the card, builds the engine, warms it on the traffic's own shapes
(set-up), drives the traffic in a closed loop for ``--seconds`` (with
``--trace 1`` under ``torch.profiler`` for the traffic's
``trace_seconds``), then frees the engine and compares calls drawn from
the seed with the plain reference. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device``, ``breakdown`` when traced, and ``checks``, each number
compared beside its limit, which also close standard error. Earlier lines
hold the set-up's stages, the call times and counts, and the errors of
every gradient entry. Exits non-zero, printing no result, without a CUDA
card, or if ``jax``, ``jaxlib``, ``flax`` or ``phylo_utils_tpu`` is
loaded at its start or once the window has closed.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
T_IMPORT = time.time()
sys.path[:0] = [str(HERE), str(ROOT)]

FORBIDDEN = ("jax", "jaxlib", "flax", "phylo_utils_tpu")
# one host thread: a call's small host operations (the 61-state eigh, the
# autograd of P(t)) then never wait at a barrier for a pool thread that a
# busy core has descheduled, which spread the codon cell's calls
HOST_THREADS = 1
# the program's build and kernel caches: fixed directories in the checkout
CACHE = ROOT / "build" / "phylo_bench_cache"


def process_age() -> float:
    """Seconds since this process started (``/proc``), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time() - T_IMPORT


def forbidden_modules() -> list:
    """The forbidden top-level names among the loaded modules, each name
    compared whole (``phylo_utils_tpu_torch`` is not ``phylo_utils_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def refuse_forbidden() -> bool:
    """Whether a forbidden module is loaded, naming it on standard error."""
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
    return bool(bad)


def set_environment() -> None:
    """The program as it ships, no ``PHYLO_*`` switch set; the kernel
    caches in the checkout (the port's own build directory,
    ``build/phylo_utils_tpu_torch``, already is); the host's thread pools
    at ``HOST_THREADS``, set before torch loads."""
    for key in [k for k in os.environ if k.startswith("PHYLO_")]:
        del os.environ[key]
    for key in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[key] = str(HOST_THREADS)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")


def card_facts() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        return {"nvidia_smi": out}
    except (OSError, subprocess.SubprocessError):
        return {"nvidia_smi": "not read"}


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _profiled(program, traffic, seconds, device, host: bool, first: int):
    """A window of calls ``first``, ... under ``torch.profiler`` and its
    trace's summary. ``host=False`` traces the device alone, between two
    marker operations, so that the host runs at its untraced pace; with
    ``host`` the host's operations and the benchmark's spans too, whose
    cost slows the host, to name what it did through the idle gaps."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from drive import run_window
    from trace_reduce import WINDOW_SPAN, read_trace, summarize

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else []
    if host or not cuda:
        acts.insert(0, ProfilerActivity.CPU)
    marker = torch.zeros(1, device=device)
    with profile(activities=acts) as prof:
        marker.add_(1.0)
        with record_function(WINDOW_SPAN):
            window = run_window(program, traffic, seconds, spans=host,
                                first=first)
        marker.add_(1.0)
        _sync(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        summary = summarize(read_trace(path))
    finally:
        os.remove(path)
    return window, summary


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             make_program=None, log=None):
    """(result, checks) of one run of ``cell``: the result line's
    ``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` and
    ``breakdown``, and {number: {"value", "limit"}}. ``make_program``
    builds the program under test (default ``drive.build_program``)."""
    import torch

    from cells import metric_reader, reference_model
    from check import (draw_calls, entry_errors, errors, numbers,
                       reference_outputs)
    from drive import Traffic, build_program, percentile, run_window, warm_up
    from inputs import make_inputs
    from roofline import least_seconds, pruning_work

    log = log or (lambda line: print(line, flush=True))
    cuda = torch.device(device).type == "cuda"
    stages = {}
    mark = time.perf_counter()

    def stage(name):
        nonlocal mark
        _sync(device)
        now = time.perf_counter()
        stages[name] = now - mark
        mark = now

    torch.zeros(1, device=device)
    stages["imports_and_device_init"] = process_age()
    mark = time.perf_counter()
    counters = None
    if cuda:
        from phylo_utils_tpu_torch.ops import _build, cuda_pruning

        _build.load_library()
        counters = cuda_pruning.LAUNCHES_BY_STATES
    stage("library_load")
    config, spec = cell.config, cell.traffic
    model = reference_model(config, cell.root)
    inputs = make_inputs(config, model, seed, device)
    stage("inputs")
    program = (make_program or build_program)(config, spec, inputs, model,
                                             device)
    stage("engine")
    traffic = Traffic(spec, inputs, seed)
    warm_up(program, traffic)
    stage("warm_up")
    gc.collect()
    setup_s = process_age()
    before = dict(counters) if counters is not None else {}
    if trace:
        # the metrics from a trace of the device alone; the idle gaps'
        # names from a second window that traces the host too
        traced_s = min(seconds, spec["trace_seconds"])
        window, summary = _profiled(program, traffic, traced_s, device,
                                    host=False, first=0)
        traced_calls = len(window.calls) - window.failed
        named, host_summary = _profiled(program, traffic, traced_s, device,
                                        host=True, first=len(window.calls))
        summary.idle_gaps = host_summary.idle_gaps
        window = window.joined(named)
    else:
        window = run_window(program, traffic, seconds)
    launches = ({"@".join(map(str, k)): v - before.get(k, 0)
                 for k, v in counters.items()}
                if counters is not None else {})
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    engine_patterns = getattr(getattr(getattr(program, "engine", None),
                                      "_compressed", None), "n_patterns",
                              None)
    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    grad = cell.kind == "grad"
    drawn = draw_calls(window.outputs, spec["check_calls"], seed)
    t_ref = time.perf_counter()
    per_call = [errors(window.outputs[i], reference_outputs(
        inputs, config, model, window.calls[i], grad)) for i in drawn]
    _sync(device)
    ref_s = time.perf_counter() - t_ref
    got = numbers(per_call, grad)
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in got.items()}
    correct = (window.failed == 0 and bool(drawn)
               and all(c["value"] <= c["limit"] for c in checks.values()))

    done = len(window.calls) - window.failed
    sets = spec["sets"]
    tree = inputs.tree
    flops, nbytes = pruning_work(
        tree.n_leaves, tree.n_internal, tree.n_edges, inputs.n_patterns,
        sets, config["ncat"], config["states"], grad)
    least, bound_by = least_seconds(flops, nbytes)
    ms = [1e3 * (b - a) for a, b, out in zip(window.starts, window.ends,
                                             window.outputs)
          if out is not None]
    log(json.dumps({
        "cell": cell.name, "seed": seed, "trace": trace,
        "patterns": inputs.n_patterns, "engine_patterns": engine_patterns,
        "sets": sets, "calls": len(window.calls), "failed": window.failed,
        "window_s": window.seconds,
        "call_ms": {"n": len(ms),
                    "p50": percentile(ms, 50) if ms else None,
                    "p90": percentile(ms, 90) if ms else None,
                    "max": max(ms) if ms else None},
        "setup_s": setup_s, "setup_stages_s": stages,
        "least_ms_a_call": 1e3 * least, "bound_by": bound_by,
        "flops_a_call": flops, "bytes_a_call": nbytes,
        "launches_by_walk": launches, "drawn_calls": drawn,
        "reference_s": ref_s, "entry_errors": entry_errors(per_call),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        **(card_facts() if cuda else {})}, default=str))

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    metrics = {}
    breakdown = None
    if trace:
        dev["busy_s"], dev["window_s"] = summary.busy_s, summary.window_s
        ctx = SimpleNamespace(trace=summary, calls=traced_calls,
                              least_s=least * traced_calls, kind=cell.kind)
        for m in cell.per_layer:
            value = metric_reader(m["name"], cell.root).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": [list(x) for x in summary.device_ops],
                     "idle_gaps": [list(x) for x in summary.idle_gaps]}
    else:
        work = inputs.n_patterns * sets * done
        e2e = {f"{cell.kind}_patterns_per_s": work / window.seconds,
               "call_ms_p90": percentile(ms, 90) if ms else None,
               "peak_mem_gib": peak / 2 ** 30,
               "setup_s": setup_s}
        for m in cell.end_to_end:
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(window.calls),
              "failed": window.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, checks


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    set_environment()
    if refuse_forbidden():
        return 4

    from cells import find_cell

    cell = find_cell(args.workload)
    import torch

    torch.set_num_threads(HOST_THREADS)
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"the cell asks for {cell.chips} cards; "
              f"{torch.cuda.device_count()} are here", file=sys.stderr)
        return 3
    result, checks = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda")
    if refuse_forbidden():
        return 4
    emit(result, checks)
    return 0


def emit(result: dict, checks: dict, out=None, err=None) -> None:
    """Each number compared beside its limit as the last lines of standard
    error, then the result line, ``checks`` its last key, as the last line
    of standard output."""
    out, err = out or sys.stdout, err or sys.stderr
    for name, c in checks.items():
        if not math.isfinite(c["value"]):
            c["value"] = None           # no reading: not correct
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps({**result, "checks": checks}), file=out, flush=True)


if __name__ == "__main__":
    sys.exit(main())
