#!/usr/bin/env python3
"""The control of a cell's ``correct``: the plain reference computed in
TF32 (``reference.likelihood``'s ``precision="tf32"``), the nearest
precision below the float32 that the configurations state, put in the
program's place and run through the harness's own ``run_cell`` at the
cell's size: its inputs, traffic, window and check. A limit that this run
passes is no check, so each seed's line has to read ``"correct": false``.

    python3 phylo_bench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 2
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


class Control:
    """The reference in TF32 answering the traffic's calls, keyed as the
    program's outputs."""

    def __init__(self, config, traffic, inputs, model, device):
        self.config, self.inputs, self.model = config, inputs, model
        self.grad = "grad" in traffic["entry"]

    def __call__(self, call):
        from check import reference_outputs

        return reference_outputs(self.inputs, self.config, self.model, call,
                                 self.grad, precision="tf32")


def run_control(cell, seed: int, seconds: float, device, log=None):
    """(result, checks) of one run of ``cell`` with the control in the
    program's place."""
    from run import run_cell

    return run_cell(cell, seed, seconds, False, device, make_program=Control,
                    log=log)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)

    import torch

    from cells import find_cell

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    cell = find_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result, checks = run_control(cell, seed, args.seconds, "cuda",
                                     log=lambda line: None)
        print(json.dumps({"cell": cell.name, "seed": seed,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "failed": result["failed"], "checks": checks,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
