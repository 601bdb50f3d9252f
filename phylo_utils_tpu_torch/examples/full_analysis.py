"""Worked end-to-end analysis with phylo_utils_tpu_torch (the port's
``examples/full_analysis.py``).

Simulate data under a known model, then recover everything from scratch:
distances -> NJ tree -> NNI/SPR search -> model selection -> joint ML fit ->
rate/ancestral posteriors -> bootstrap + topology tests.

Run:  python -m phylo_utils_tpu_torch.examples.full_analysis --pruner cuda
      python -m phylo_utils_tpu_torch.examples.full_analysis --device cpu
"""
from __future__ import annotations

import phylo_utils_tpu_torch as pu
from phylo_utils_tpu_torch.ancestral import site_rate_posteriors
from phylo_utils_tpu_torch.examples import (
    Stages,
    checked_device,
    example_parser,
)
from phylo_utils_tpu_torch.optimize import ml_distance_matrix

# the JAX example's sizes (``simulate``'s), and its step and replicate
# counts (``run``'s)
SIZES = {"n_taxa": 10, "n_sites": 1500}
STEPS = {"max_rounds": 10, "compare_steps": 120, "fit_steps": 200,
         "n_boot": 200}
CANDIDATES = ["JC69", "K80+G", "HKY85+G", "GTR+G"]


def simulate(seed: int, n_taxa: int, n_sites: int, device):
    """(true tree, alignment): HKY85+G4 (kappa 4, alpha 0.4) sites on
    ``random_tree(n_taxa, seed=7, mean_brlen=0.15)``."""
    true_tree = pu.random_tree(n_taxa, seed=7, mean_brlen=0.15)
    aln = pu.simulate_alignment(
        seed, true_tree, pu.models.HKY85, n_sites,
        params={"kappa": 4.0, "alpha": 0.4}, ncat=4, device=device,
    )
    return true_tree, aln


def run(aln, true_tree, device="cuda", pruner="torch", max_rounds=10,
        compare_steps=120, fit_steps=200, n_boot=200):
    """The analysis of ``aln``; every number ``main`` prints, with the
    trees, fits, engine and arrays they come from, and ``stage_s``."""
    stages = Stages(device)
    # ---- de-novo tree: ML distances -> NJ -> NNI refinement ---------------
    d = ml_distance_matrix(aln, pu.models.K80, device=device)
    nj = pu.neighbor_joining(d, list(aln))
    stages.done("distances_nj")
    tree, ll_search, rounds = pu.nni_hill_climb(
        nj, aln, pu.models.K80, ncat=4, moves="both", max_rounds=max_rounds,
        device=device,
    )
    stages.done("search")

    # ---- model selection ---------------------------------------------------
    fits = pu.compare_models(tree, aln, candidates=CANDIDATES,
                             max_steps=compare_steps, device=device)
    stages.done("compare_models")

    # ---- joint ML fit under the winning model ------------------------------
    engine = pu.LikelihoodEngine(tree, aln, pu.models.HKY85, ncat=4,
                                 pruner=pruner, device=device)
    result = pu.fit(engine, max_steps=fit_steps, steps_per_call=10)
    stages.done("fit")

    # ---- posteriors --------------------------------------------------------
    gam = site_rate_posteriors(engine, result.params)
    post = pu.ancestral_posteriors(engine, result.params)
    stages.done("posteriors")

    # ---- uncertainty: bootstrap + topology tests ---------------------------
    boots = engine.bootstrap_loglikelihoods(n_boot, result.params, seed=1)
    stages.done("bootstrap")
    cands = [tree] + pu.nni_neighbors(tree)[:6]
    tse = pu.TopologySetEngine(cands, aln, pu.models.HKY85, ncat=4,
                               device=device)
    sw = tse.sitewise_loglikelihoods(
        {"model": result.params["model"], "alpha": result.params["alpha"]}
    )
    sh = pu.sh_test(sw)
    stages.done("topology_tests")
    return {
        "distances": d, "nj_tree": nj, "tree": tree,
        "search_loglik": float(ll_search), "search_rounds": int(rounds),
        "rf_to_truth": pu.robinson_foulds(true_tree, tree),
        "model_fits": fits,
        "model_ranking": [(f.name, float(f.bic)) for f in fits],
        "engine": engine, "fit": result, "fit_loglik": result.loglik,
        "kappa": float(result.params["model"]["kappa"]),
        "alpha": float(result.params["alpha"]),
        "site_rate_posteriors": gam, "ancestral_posteriors": post,
        "root_map_state_site0": int(post[-1, 0].argmax()),
        "bootstrap_logliks": boots, "bootstrap_sd": float(boots.std()),
        "candidates": cands, "sitewise": sw, "sh": sh,
        "sh_best": int(sh["best"]),
        "sh_rejected": int((sh["pvalue"] < 0.05).sum()),
        "stage_s": stages.seconds,
    }


def main(argv=None):
    args = example_parser(__doc__.splitlines()[0], 0,
                          {**SIZES, **STEPS}).parse_args(argv)
    device = checked_device(args.device)
    # ---- ground truth + simulated alignment -------------------------------
    true_tree, aln = simulate(args.seed, args.n_taxa, args.n_sites, device)
    print(f"simulated {len(aln)} taxa x {args.n_sites} sites under "
          f"HKY85+G4 (kappa=4)")
    out = run(aln, true_tree, device=device, pruner=args.pruner,
              **{k: getattr(args, k) for k in STEPS})
    print(f"NJ + {out['search_rounds']}-round NNI/SPR search: logL "
          f"{out['search_loglik']:.2f}, RF to truth = {out['rf_to_truth']}")
    print("model ranking (BIC):",
          [(name, round(bic, 1)) for name, bic in out["model_ranking"]])
    print(f"fit: logL {out['fit_loglik']:.2f}, kappa {out['kappa']:.2f}, "
          f"alpha {out['alpha']:.2f}")
    print(f"site-rate posteriors {out['site_rate_posteriors'].shape}, "
          f"root MAP state of site 0: {out['root_map_state_site0']}")
    print(f"bootstrap logL sd: {out['bootstrap_sd']:.2f}")
    print(f"SH test: best tree index {out['sh_best']}, "
          f"{out['sh_rejected']} neighbors rejected at 5%")


if __name__ == "__main__":
    main()
