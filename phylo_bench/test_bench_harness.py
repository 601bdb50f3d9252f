"""The harness on the CPU at a tiny size: cells found by name from new
files alone, the result line's keys, the import guard, the reference held
to the program's semantics, the faults that ``correct`` must catch, and
the TF32 control that it must refuse."""
import io
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import run
from cells import (HERE, ROOT, find_cell, metric_reader, read_json,
                   reference_model)
from check import errors, reference_outputs
from drive import Traffic, build_program
from inputs import make_inputs

CELLS = [w["name"] for w in read_json(ROOT / "BENCHMARK.json")["workloads"]]
TINY = {"dna64_gtr_g4i_100k": dict(taxa=8, sites=300),
        "codon1000_gy94_g4_24k": dict(taxa=6, sites=120)}


def tiny(name, **traffic):
    """The cell ``name`` at a size the CPU runs in a second."""
    cell = find_cell(name)
    cell.config = dict(cell.config, **TINY[cell.config["name"]])
    sets = 1 if cell.traffic["sets"] == 1 else 4
    cell.traffic = dict(cell.traffic, sets=sets, check_calls=2,
                        trace_seconds=0.2, **traffic)
    return cell


def run_tiny(cell, make_program=None, trace=False, seed=2 ** 31 + 7):
    return run.run_cell(cell, seed, 0.3, trace, "cpu",
                        make_program=make_program, log=lambda line: None)


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct_on_the_cpu(name):
    result, checks = run_tiny(tiny(name))
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] >= 1


def test_new_files_alone_make_a_new_cell(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "phylo_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = read_json(ROOT / "BENCHMARK.json")
    here = root / "phylo_bench"
    (here / "configs" / "dna8_new.json").write_text(json.dumps(
        dict(read_json(here / "configs" / "dna64_gtr_g4i_100k.json"),
             name="dna8_new", taxa=8, sites=200)))
    (here / "traffic" / "grad_b2.json").write_text(json.dumps(
        dict(read_json(here / "traffic" / "grad.json"),
             entry="value_and_grad_many", sets=2, check_calls=1)))
    (here / "limits" / "dna8.grad_b2.json").write_text(json.dumps(
        {"logl_rel": 1e-6, "grad_rel": 3e-4}))
    (here / "metrics" / "calls_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.calls)\n")
    bench["workloads"].append({"name": "dna8.grad_b2", "config": "dna8_new",
                               "traffic": "grad_b2", "chips": 1,
                               "why": "new"})
    for m in bench["end_to_end"]:
        if m["name"] == "grad_patterns_per_s":
            m["workloads"].append("dna8.grad_b2")
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls",
                               "better": "higher", "source": "device_trace",
                               "layer": "device",
                               "moves": "grad_patterns_per_s",
                               "workloads": ["dna8.grad_b2"]})
    cell = find_cell("dna8.grad_b2", bench, root=root)
    assert cell.config["taxa"] == 8 and cell.traffic["sets"] == 2
    assert [m["name"] for m in cell.end_to_end] == [
        "grad_patterns_per_s", "peak_mem_gib", "setup_s"]
    assert "calls_traced" in [m["name"] for m in cell.per_layer]
    assert metric_reader("calls_traced", root=root).read(
        type("Ctx", (), {"calls": 3})) == 3.0
    # a stem's reader serves its suffixed names
    assert metric_reader("device_idle_pct.grad", root=root).__name__.endswith(
        "device_idle_pct")
    cell.traffic = dict(cell.traffic, trace_seconds=0.2)
    result, _ = run_tiny(cell, trace=True)
    assert result["correct"]
    assert result["metrics"]["calls_traced"]["value"] >= 1


class Stub:
    """A program that answers every call with the same wrong total."""

    def __call__(self, call):
        return {"total": np.full(len(call.sets), -1.0)}


def test_result_line_keys_from_a_stub_engine():
    cell = tiny("dna64x100k.score_b64")
    result, checks = run_tiny(cell, make_program=lambda *a: Stub())
    out, err = io.StringIO(), io.StringIO()
    run.emit(result, checks, out=out, err=err)
    line = json.loads(out.getvalue().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is False
    assert set(line["metrics"]) == {"value_patterns_per_s", "peak_mem_gib",
                                    "setup_s"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert err.getvalue().splitlines()[-1].startswith("check logl_rel ")
    traced, _ = run_tiny(cell, make_program=lambda *a: Stub(), trace=True)
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    assert "phylo_utils_tpu_torch" in sys.modules
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "phylo_utils_tpu.trees",
                        type(sys)("phylo_utils_tpu.trees"))
    monkeypatch.setitem(sys.modules, "jaxlibx", type(sys)("jaxlibx"))
    assert run.forbidden_modules() == ["phylo_utils_tpu"]


def test_a_run_loads_no_jax():
    script = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run\n"
        "from test_bench_harness import tiny, run_tiny\n"
        "for name in %r:\n"
        "    run_tiny(tiny(name))\n"
        "print(run.forbidden_modules())\n" % (str(HERE), str(ROOT), CELLS))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("name", CELLS)
def test_reference_holds_the_programs_semantics(name):
    """The reference against the program's plain pruner in float64, on
    the cell's model: rooting, gamma discretization, +I and the codon
    frequencies agree to rounding."""
    from phylo_utils_tpu_torch import models
    from phylo_utils_tpu_torch.likelihood import LikelihoodEngine

    cell = tiny(name)
    model = reference_model(cell.config)
    inputs = make_inputs(cell.config, model, 11, "cpu")
    call = Traffic(cell.traffic, inputs, 11).call(0)
    names = inputs.tree.leaf_names
    table = np.array([s.encode() for s in model.SYMBOLS])
    codes = inputs.states.numpy()
    aln = {n: b"".join(table[codes[i]]).decode() for i, n in enumerate(names)}
    engine = LikelihoodEngine(
        inputs.tree.newick(inputs.lengths), aln,
        getattr(models, cell.config["program_model"]),
        ncat=cell.config["ncat"], invariant_sites="pinv" in inputs.params,
        dtype=torch.float64, pruner="torch", device="cpu")
    params = {k: v.astype(np.float64) if not isinstance(v, dict) else
              {kk: vv.astype(np.float64) for kk, vv in v.items()}
              for k, v in call.params.items()}
    total, grads = engine.value_and_grad_many(call.sets.astype(np.float64),
                                              params)
    got = {"total": total.numpy(),
           "branch_lengths": grads["branch_lengths"].numpy()}
    got.update({f"model.{k}": v.numpy() for k, v in grads["model"].items()})
    got.update({k: grads[k].numpy() for k in ("alpha", "pinv")
                if k in grads})
    want = reference_outputs(inputs, cell.config, model, call, True)
    err = errors(got, want)
    assert err["logl_rel"] < 1e-12, err
    assert max(v for k, v in err.items() if k != "logl_rel") < 1e-8, err


class Fault:
    """The engine's outputs broken where they are produced."""

    def __init__(self, program, kind):
        self.program, self.kind = program, kind

    def __call__(self, call):
        if self.kind == "half_batch":
            half = len(call.sets) // 2
            out = self.program(type(call)(call.sets[:half], call.params))
            mean = {k: v.mean(axis=0, keepdims=True) for k, v in out.items()
                    if k in ("total", "branch_lengths")}
            for k, v in mean.items():
                out[k] = np.concatenate(
                    [out[k], np.repeat(v, len(call.sets) - half, axis=0)])
            for k in out:
                if k not in mean:           # summed over the sets
                    out[k] = out[k] * len(call.sets) / half
            return out
        out = self.program(call)
        if self.kind == "total_altered":
            out["total"][-1] *= 1.0 + 1e-3
        elif self.kind == "gradient_altered":
            g = out["branch_lengths"]
            g[-1, np.argmax(np.abs(g[-1]))] *= 1.01
        return out


FAULTS = [(name, kind) for name in CELLS
          for kind in ("total_altered", "gradient_altered", "half_batch")
          if (kind != "gradient_altered" or "grad" in name)
          and (kind != "half_batch" or "_b" in name)]


@pytest.mark.parametrize("name, kind", FAULTS)
def test_correct_catches_the_fault(name, kind):
    def faulty(*args):
        return Fault(build_program(*args), kind)

    result, checks = run_tiny(tiny(name), make_program=faulty)
    assert result["correct"] is False, checks


@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_fails_the_limits(name):
    """The control, run through the harness in the program's place, comes
    out not correct."""
    from control import run_control

    cell = tiny(name)
    cell.config = dict(cell.config, sites=find_cell(name).config["sites"]
                       // 50)
    result, checks = run_control(cell, 5, 0.3, "cpu", log=lambda line: None)
    assert result["correct"] is False, checks
    assert result["failed"] == 0 and result["attempted"] >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, cuda_device):
    """One short run of each cell at its full size on the card."""
    result, checks = run.run_cell(find_cell(name), 2 ** 31 + 11, 2.0, False,
                                  cuda_device, log=lambda line: None)
    assert result["correct"], checks
