"""Dry run of sharded training on N shards (the port's counterpart of the
JAX system's ``dryrun_multichip``).

  python -m phylo_utils_tpu_torch.parallel.dryrun N [--device cuda|cpu]

Fits an 8-taxon GTR+G2 engine sharded over N shards (``optimize.fit``,
3 L-BFGS steps) under both pruners: ``"torch"`` (the plain walk, float64)
and ``"cuda"`` (the pruning kernels on a card, their plain versions on the
CPU, float32). Both must start from the same logL and land on the same
optimum (1e-3 relative), and the unsharded engine's start logL must equal
the sharded one's. Then a partitioned fit on the same mesh, one engine a
locus and stacked, cross-checked the same way. The shards go round-robin
over the visible cards (``--device cuda``, the default: N shards on one
card share it) or all on the CPU. Prints one JSON line of the logLs;
raises on any mismatch.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

__all__ = ["dryrun", "main"]

_TOL = 1e-3


def _alignment(tree, n_sites: int, seed: int) -> Dict[str, str]:
    rng = np.random.default_rng(seed)
    return {n: "".join(rng.choice(list("ACGT"), size=n_sites))
            for n in tree.leaf_names}


def _check(what: str, a: float, b: float) -> None:
    if not (np.isfinite(a) and np.isfinite(b)) or abs(a - b) > _TOL * abs(a):
        raise RuntimeError(f"{what} mismatch in the sharded dry run: "
                           f"{a!r} against {b!r}")


def dryrun(n_shards: int, device: str = "cuda") -> Dict:
    """Run the dry run on ``n_shards`` shards; returns the logLs."""
    from phylo_utils_tpu_torch import models
    from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
    from phylo_utils_tpu_torch.optimize import fit
    from phylo_utils_tpu_torch.parallel import SiteSharding, make_mesh
    from phylo_utils_tpu_torch.partition import (
        Partition,
        PartitionedEngine,
        StackedPartitionedEngine,
    )
    from phylo_utils_tpu_torch.trees import random_tree

    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: torch.cuda.is_available() "
                               "is False")
        n_cards = torch.cuda.device_count()
        devices = [f"cuda:{i % n_cards}" for i in range(n_shards)]
    else:
        devices = ["cpu"] * n_shards
    mesh = make_mesh(devices)

    tree = random_tree(8, seed=0)
    aln = _alignment(tree, 64, seed=1)
    out: Dict = {"n_shards": n_shards, "device": device}
    for pruner, dtype in (("torch", "float64"), ("cuda", "float32")):
        kw = dict(ncat=2, pruner=pruner, dtype=dtype, device=devices[0])
        engine = LikelihoodEngine(tree, aln, models.GTR,
                                  sharding=SiteSharding(mesh), **kw)
        res = fit(engine, max_steps=3, steps_per_call=3)
        if res.n_steps < 3:
            raise RuntimeError(f"{pruner}: the fit under-stepped")
        single = LikelihoodEngine(tree, aln, models.GTR, **kw)
        _check(f"{pruner} sharded/unsharded start logL",
               single.loglikelihood(), float(res.trace[0]))
        out[pruner] = [float(res.trace[0]), float(res.loglik)]
    for which, a, b in zip(("start", "final"), out["torch"], out["cuda"]):
        _check(f"pruner {which}-logL", a, b)

    ptree = random_tree(8, seed=3)
    parts = [Partition(f"locus{i}", _alignment(ptree, 48, seed=10 + i),
                       models.GTR, ncat=2) for i in range(2)]
    for label, cls in (("looped", PartitionedEngine),
                       ("stacked", StackedPartitionedEngine)):
        pe = cls(ptree, parts, sharding=SiteSharding(mesh),
                 device=devices[0])
        res = fit(pe, max_steps=2, steps_per_call=2)
        out[label] = [float(res.trace[0]), float(res.loglik)]
    for which, a, b in zip(("start", "final"), out["looped"],
                           out["stacked"]):
        _check(f"partitioned {which}-logL", a, b)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m phylo_utils_tpu_torch.parallel.dryrun",
        description="sharded fit dry run on N shards")
    ap.add_argument("n_shards", type=int)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    print(json.dumps(dryrun(args.n_shards, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
