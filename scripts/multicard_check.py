"""Site sharding over several cards of one host, held to the unsharded
engines on the first card.

  python scripts/multicard_check.py

The mesh is ``make_mesh()``: one shard on every visible card (run it
with two or more; on one card it checks the one-card mesh). Each
sharded engine is compared with the same engine unsharded on cuda:0:

- ``LikelihoodEngine`` GTR+G4+I, f32, ``pruner="cuda"``, on
  ``random_tree(64, seed=0)`` x SITES simulated sites: logL and
  sitewise values to 1e-6 relative, ``value_and_grad``'s gradient to
  5e-4 x max|g| (``chip_smoke.GRAD_TOL``), one forward walk, one B2 and
  one B3 a shard (counted), both engines' value and gradient medians;
  a 3-step L-BFGS fit to 1e-6;
- ``StackedPartitionedEngine`` and ``PartitionedEngine`` (6 GTR+G4 loci
  of 300-900 sites, f32, ``pruner="cuda"``): logL to 1e-6, the stack's
  gradient to 5e-4 x max|g|;
- ``TopologySetEngine`` (16 NNI candidates, f64, the plain level walk,
  whose schedule is copied to each card): logL to 1e-10, gradients to
  1e-8 x max|g|;
- the CLI's ``loglik --shard-sites --sitewise`` (every card) against the
  library's sharded engine, equal, and the unsharded logL to 1e-6;
- ``python -m phylo_utils_tpu_torch.parallel.dryrun 2N`` (the shards
  round-robin over the N cards).

Prints every card's name and power limit, then one JSON line of the
errors and times; exits 1 on any failed check.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

LOGL_RTOL, GRAD_TOL = 1e-6, 5e-4
SITES = 20_000
_FORWARDS = ("LAUNCHES", "SLOT_LAUNCHES", "STREAM_LAUNCHES",
             "STATIC_LAUNCHES", "FOLD_LAUNCHES")


def main() -> int:
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from phylo_utils_tpu_torch import cli, models
    from phylo_utils_tpu_torch.batched import TopologySetEngine
    from phylo_utils_tpu_torch.io import (
        read_alignment,
        write_fasta,
        write_newick,
    )
    from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
    from phylo_utils_tpu_torch.ops import cuda_pruning
    from phylo_utils_tpu_torch.optimize import fit
    from phylo_utils_tpu_torch.parallel import SiteSharding, make_mesh
    from phylo_utils_tpu_torch.partition import (
        Partition,
        PartitionedEngine,
        StackedPartitionedEngine,
    )
    from phylo_utils_tpu_torch.simulate import simulate_alignment
    from phylo_utils_tpu_torch.trees import nni_neighbors, random_tree

    if not torch.cuda.is_available():
        print("multicard_check: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    failures = []

    def check(ok, msg):
        if not ok:
            failures.append(msg)

    mesh = make_mesh()
    sharding = SiteSharding(mesh)
    out = {"cards": torch.cuda.device_count(),
           "devices": [str(d) for d in mesh.devices]}

    # LikelihoodEngine ------------------------------------------------------
    params = cs.FLAGSHIP_PARAMS
    tree = random_tree(64, seed=0)
    aln = simulate_alignment(35, tree, models.GTR, SITES,
                             params={**params["model"], "alpha": 0.5},
                             ncat=4, pinv=0.1, device="cuda:0")
    kw = dict(ncat=4, invariant_sites=True, dtype=torch.float32,
              pruner="cuda", device="cuda:0")
    single = LikelihoodEngine(tree, aln, models.GTR, **kw)
    sharded = LikelihoodEngine(tree, aln, models.GTR, sharding=sharding,
                               **kw)
    on = [str(t.device) for t in sharded._leaf_partials.shards]
    check(on == out["devices"], f"shards on {on}, not {out['devices']}")
    cuda_pruning.LAUNCHES_BY_STATES.clear()
    for name in (*_FORWARDS, "SAVEALL_LAUNCHES", "REVERSE_LAUNCHES"):
        setattr(cuda_pruning, name, 0)
    ll_d = sharded.loglikelihood(params)
    sw_d = sharded.sitewise_loglikelihoods(params, per_pattern=True)
    v_d, g_d = sharded.value_and_grad(params)
    counts = {n: getattr(cuda_pruning, n)
              for n in (*_FORWARDS, "SAVEALL_LAUNCHES", "REVERSE_LAUNCHES")}
    ll_s = single.loglikelihood(params)
    sw_s = single.sitewise_loglikelihoods(params, per_pattern=True)
    v_s, g_s = single.value_and_grad(params)
    n = mesh.size
    engine = {
        "patterns": int(single._weights.shape[0]),
        "loglik_rel_err": abs(ll_d - ll_s) / abs(ll_s),
        "sitewise_rel_err": float(np.abs(sw_d - sw_s).max()
                                  / np.abs(sw_s).max()),
        "value_and_grad_rel_err": abs(float(v_d) - float(v_s))
        / abs(float(v_s)),
        "grad_rel_err": cs._grad_errors(g_d, g_s), "launches": counts}
    check(max(engine["loglik_rel_err"], engine["sitewise_rel_err"],
              engine["value_and_grad_rel_err"]) <= LOGL_RTOL
          and max(engine["grad_rel_err"].values()) <= GRAD_TOL,
          f"sharded engine against unsharded: {engine}")
    check(sum(counts[k] for k in _FORWARDS) == 2 * n
          and counts["SAVEALL_LAUNCHES"] == n
          and counts["REVERSE_LAUNCHES"] == n,
          f"not one forward walk a shard a value call and one B2 and B3 a "
          f"shard a gradient: {counts}")
    for label, eng in (("unsharded", single), ("sharded", sharded)):
        engine[f"{label}_value_ms"] = cs._median_ms(
            lambda: eng.loglikelihood(params), 5)
        engine[f"{label}_value_and_grad_ms"] = cs._median_ms(
            lambda: eng.value_and_grad(params), 5)
    res_d = fit(sharded, params, max_steps=3)
    res_s = fit(single, params, max_steps=3)
    engine["fit_rel_err"] = abs(res_d.loglik - res_s.loglik) / abs(
        res_s.loglik)
    check(engine["fit_rel_err"] <= LOGL_RTOL,
          f"sharded fit {res_d.loglik} against {res_s.loglik}")
    out["engine"] = engine

    # partitioned engines ---------------------------------------------------
    ptree = random_tree(32, seed=3)
    rng = np.random.default_rng(3)
    parts = [Partition(f"locus{i}", simulate_alignment(
        40 + i, ptree, models.GTR, int(rng.integers(300, 901)),
        params={**params["model"], "alpha": 0.7}, ncat=4,
        device="cuda:0"), models.GTR, ncat=4)
        for i in range(6)]
    pkw = dict(dtype=torch.float32, pruner="cuda", device="cuda:0")
    stack = StackedPartitionedEngine(ptree, parts, **pkw)
    stack_d = StackedPartitionedEngine(ptree, parts, sharding=sharding, **pkw)
    general_d = PartitionedEngine(ptree, parts, sharding=sharding, **pkw)
    pll = stack.loglikelihood()
    _, pg = stack.value_and_grad()
    pv_d, pg_d = stack_d.value_and_grad()
    part = {"loglik_rel_err": max(abs(x - pll) / abs(pll) for x in (
        stack_d.loglikelihood(), float(pv_d), general_d.loglikelihood())),
        "grad_rel_err": max(cs._grad_errors(pg_d, pg).values())}
    check(part["loglik_rel_err"] <= LOGL_RTOL
          and part["grad_rel_err"] <= GRAD_TOL,
          f"sharded partitions against the unsharded stack: {part}")
    out["partitions"] = part

    # topology sets ---------------------------------------------------------
    cands = [tree] + nni_neighbors(tree)[:15]
    small = {k: v[:2000] for k, v in aln.items()}
    tse = TopologySetEngine(cands, small, models.GTR, ncat=4,
                            device="cuda:0")
    tse_d = TopologySetEngine(cands, small, models.GTR, ncat=4,
                              device="cuda:0", sharding=sharding)
    lls, lls_d = tse.loglikelihoods(), tse_d.loglikelihoods()
    topo = {"n": len(cands),
            "loglik_rel_err": float(np.max(np.abs(lls_d - lls)
                                           / np.abs(lls))),
            "grad_rel_err": max(cs._grad_errors(tse_d.gradients(),
                                                tse.gradients()).values())}
    check(topo["loglik_rel_err"] <= 1e-10 and topo["grad_rel_err"] <= 1e-8,
          f"sharded candidates against unsharded: {topo}")
    out["candidates"] = topo

    # the CLI and the dry run -----------------------------------------------
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    dry = subprocess.Popen(
        [sys.executable, "-m", "phylo_utils_tpu_torch.parallel.dryrun",
         str(2 * n), "--device", "cuda"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    with tempfile.TemporaryDirectory() as tmp:
        fasta, nwk = os.path.join(tmp, "a.fa"), os.path.join(tmp, "t.nwk")
        write_fasta(aln, path=fasta)
        Path(nwk).write_text(write_newick(tree))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["loglik", "--tree", nwk, "--alignment", fasta,
                           "--model", "GTR+G4+I", "--params",
                           json.dumps(params), "--dtype", "float32",
                           "--pruner", "cuda", "--device", "cuda",
                           "--sitewise",
                           "--shard-sites"])
        got = json.loads(buf.getvalue()) if rc == 0 else {}
        library = LikelihoodEngine(tree, read_alignment(fasta), models.GTR,
                                   sharding=SiteSharding(make_mesh()), **kw)
        want = {"loglik": library.loglikelihood(params),
                "sitewise": library.sitewise_loglikelihoods(params).tolist()}
    out["cli"] = {"rc": rc, "equal": got == want,
                  "loglik_rel_err": abs(got.get("loglik", 0.0) - ll_s)
                  / abs(ll_s)}
    check(rc == 0 and got == want
          and out["cli"]["loglik_rel_err"] <= LOGL_RTOL,
          f"loglik --shard-sites: {out['cli']}")
    stdout, stderr = dry.communicate(timeout=600)
    check(dry.returncode == 0, f"dry run exited {dry.returncode}: "
          f"{stderr[-2000:]}")
    if dry.returncode == 0:
        out["dryrun"] = json.loads(stdout.strip().splitlines()[-1])
    out["failures"] = failures
    print(json.dumps(out), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
