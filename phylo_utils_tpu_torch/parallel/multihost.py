"""Multi-process workers for site sharding across ranks (the port's
counterparts of the JAX system's multihost workers).

Run one process per rank; the ranks meet at ``tcp://127.0.0.1:PORT``.
Each rank owns ``--shards`` shards (default 4) on ``--device``, so two
ranks make one 8-shard global pattern axis; every rank builds the same
alignment and an engine with ``sharding=``, which keeps its own slice of
the padded pattern axis.

  python -m phylo_utils_tpu_torch.parallel.multihost loglik RANK WORLD PORT
      The globally reduced logL, sitewise values and gradient of a GTR
      engine against the same engine unsharded in this process, and
      whether ``SiteSharding.from_process_local`` of this rank's slice
      gives the sharded engine's own data. Default: a 12-taxon GTR+G4
      engine on 200 random sites at its default parameters; ``--tree``
      and ``--alignment`` (files), ``--invariant-sites`` (+I) and
      ``--params`` (JSON) choose another.

  python -m phylo_utils_tpu_torch.parallel.multihost fit RANK WORLD PORT \\
      MODE CHECKPOINT
      A 12-step Adam fit (lr 0.05) of an 8-taxon GTR+G2 engine (120
      sites). MODE ``clean`` runs it through; ``crash`` checkpoints every
      3 steps (rank 0 writes) and hard-exits (``os._exit(137)``) at step
      7; ``resume`` restarts from the checkpoint. Prints the sha256 of the
      parameters after step 12, which must be the same on every rank and
      in ``clean`` and ``resume``.

The ranks meet over gloo, which carries CPU and CUDA tensors, so two ranks
can share one card. Options: ``--device`` (default the card), ``--pruner
torch|cuda``, ``--dtype float32|float64``, ``--shards``. Each prints one
JSON line.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
from typing import Dict

import numpy as np
import torch

__all__ = ["main"]

FIT_STEPS = 12
CKPT_EVERY = 3
CRASH_STEP = 7


def _alignment(tree, n_sites: int, seed: int) -> Dict[str, str]:
    rng = np.random.default_rng(seed)
    return {n: "".join(rng.choice(list("ACGT"), size=n_sites))
            for n in tree.leaf_names}


def _digest(params) -> str:
    from phylo_utils_tpu_torch.convert import flatten_params

    h = hashlib.sha256()
    for name, leaf in zip(*flatten_params(params)):
        h.update("/".join(name).encode())
        h.update(leaf.detach().to("cpu", torch.float64).numpy().tobytes())
    return h.hexdigest()


def _data(tree_path, aln_path, n_taxa: int, tree_seed: int, n_sites: int,
          aln_seed: int):
    """(tree, alignment): read from ``tree_path`` and ``aln_path`` where
    given, else a seeded random tree and alignment."""
    from phylo_utils_tpu_torch.io import parse_newick, read_alignment
    from phylo_utils_tpu_torch.trees import random_tree

    if tree_path:
        with open(tree_path) as fh:
            return parse_newick(fh.read()), read_alignment(aln_path)
    tree = random_tree(n_taxa, seed=tree_seed)
    return tree, _alignment(tree, n_sites, aln_seed)


def _engine(args, tree, aln, ncat: int, sharded: bool,
            invariant_sites: bool = False):
    """A GTR engine on ``--device``; ``sharded``: over this rank's
    ``--shards`` shards of the global pattern axis."""
    from phylo_utils_tpu_torch import models
    from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
    from phylo_utils_tpu_torch.parallel import SiteSharding, make_mesh

    sharding = (SiteSharding(make_mesh([args.device] * args.shards))
                if sharded else None)
    return LikelihoodEngine(tree, aln, models.GTR, ncat=ncat,
                            invariant_sites=invariant_sites,
                            pruner=args.pruner, dtype=args.dtype,
                            device=args.device, sharding=sharding)


def _loglik(args) -> Dict:
    from phylo_utils_tpu_torch.convert import flatten_params

    tree, aln = _data(args.tree, args.alignment, 12, 7, 200, 8)
    engine = _engine(args, tree, aln, 4, True, args.invariant_sites)
    single = _engine(args, tree, aln, 4, False, args.invariant_sites)
    sharding = engine.sharding
    # ingestion: this rank's slice of the padded pattern axis, placed by
    # from_process_local, is the sharded engine's own data
    lp, w = sharding.pad(single._leaf_partials, single._weights)
    per_rank = lp.shape[1] // args.world
    sl = slice(args.rank * per_rank, (args.rank + 1) * per_rank)
    local = sharding.from_process_local(lp[:, sl], w[sl])
    ingest_equal = all(
        torch.equal(a, b) for mine, theirs in zip(
            local, (engine._leaf_partials, engine._weights))
        for a, b in zip(mine.shards, theirs.shards))
    params = json.loads(args.params) if args.params else None
    total, grad = engine.value_and_grad(params)
    sw = engine.sitewise_loglikelihoods(params, per_pattern=True)
    single_total, single_grad = single.value_and_grad(params)
    single_sw = single.sitewise_loglikelihoods(params, per_pattern=True)
    grad, single_grad = (torch.cat([g.reshape(-1).to("cpu", torch.float64)
                                    for g in flatten_params(gs)[1]])
                         for gs in (grad, single_grad))
    return {
        "rank": args.rank,
        "world": args.world,
        "global_shards": sharding.n_devices,
        "backend": torch.distributed.get_backend(),
        "ingest_equal": ingest_equal,
        "sharded_loglik": float(total),
        "local_loglik": float(single_total),
        "sitewise_patterns": int(sw.shape[-1]),
        "sitewise_max_rel": float(np.abs(sw - single_sw).max()
                                  / np.abs(single_sw).max()),
        "grad_max_rel": float((grad - single_grad).abs().max()
                              / single_grad.abs().max()),
    }


def _fit(args) -> Dict:
    from phylo_utils_tpu_torch.optimize import fit

    tree, aln = _data(None, None, 8, 11, 120, 12)
    engine = _engine(args, tree, aln, 2, True)
    endpoint = {}

    def callback(n, ll, params):
        if args.mode == "crash" and n >= CRASH_STEP:
            # an uncoordinated death mid-run: no cleanup, no shutdown; the
            # checkpoint on disk is all that survives
            os._exit(137)
        if n == FIT_STEPS:
            endpoint["params"] = params

    crash = args.mode == "crash"
    res = fit(
        engine,
        optimizer=lambda raw: torch.optim.Adam(raw, lr=0.05),
        max_steps=FIT_STEPS,
        patience=10_000,            # the whole budget: trajectories align
        callback=callback,
        checkpoint_path=args.checkpoint if crash else None,
        checkpoint_every=CKPT_EVERY if crash else 0,
        resume_from=args.checkpoint if args.mode == "resume" else None,
    )
    return {"rank": args.rank, "mode": args.mode, "n_steps": res.n_steps,
            "loglik": float(res.loglik),
            "digest": _digest(endpoint["params"])}


def main(argv=None) -> int:
    from phylo_utils_tpu_torch.parallel import distributed_init

    ap = argparse.ArgumentParser(
        prog="python -m phylo_utils_tpu_torch.parallel.multihost")
    sub = ap.add_subparsers(dest="what", required=True)
    for name in ("loglik", "fit"):
        p = sub.add_parser(name)
        p.add_argument("rank", type=int)
        p.add_argument("world", type=int)
        p.add_argument("port", type=int)
        if name == "fit":
            p.add_argument("mode", choices=["clean", "crash", "resume"])
            p.add_argument("checkpoint")
        p.add_argument("--device", default="cuda")
        p.add_argument("--pruner", default="torch", choices=["torch", "cuda"])
        p.add_argument("--dtype", default="float64",
                       choices=["float32", "float64"])
        p.add_argument("--shards", type=int, default=4)
        if name == "loglik":
            p.add_argument("--tree", help="Newick file (with --alignment)")
            p.add_argument("--alignment", help="FASTA or PHYLIP file")
            p.add_argument("--invariant-sites", action="store_true")
            p.add_argument("--params", help="JSON params to evaluate at")
    args = ap.parse_args(argv)
    distributed_init(init_method=f"tcp://127.0.0.1:{args.port}",
                     world_size=args.world, rank=args.rank,
                     backend="gloo", timeout=240)
    try:
        out = _loglik(args) if args.what == "loglik" else _fit(args)
    finally:
        torch.distributed.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
