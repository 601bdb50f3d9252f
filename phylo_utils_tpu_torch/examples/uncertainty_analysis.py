"""Worked example: quantifying phylogenetic uncertainty, end to end (the
port's ``examples/uncertainty_analysis.py``).

Simulates data under a known tree, then runs the uncertainty toolkit:
Felsenstein + Transfer (TBE) bootstrap supports with a majority-rule
consensus tree, the KH/SH/AU topology tests over a candidate set, joint
(Pupko) vs marginal ancestral reconstruction, posterior-mean site rates,
and parametric-bootstrap vs observed-Fisher standard errors for the model
parameters.

Run (on the card, or on the CPU with ``--device cpu``):

  python -m phylo_utils_tpu_torch.examples.uncertainty_analysis --pruner cuda
"""
from __future__ import annotations

import phylo_utils_tpu_torch as pu
from phylo_utils_tpu_torch.ancestral import (
    ancestral_posteriors,
    joint_ancestral_states,
    site_rates,
)
from phylo_utils_tpu_torch.batched import TopologySetEngine
from phylo_utils_tpu_torch.examples import (
    Stages,
    checked_device,
    example_parser,
)
from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
from phylo_utils_tpu_torch.optimize import (
    fit,
    parametric_bootstrap,
    standard_errors,
)
from phylo_utils_tpu_torch.supports import bootstrap_tree_support
from phylo_utils_tpu_torch.topology_tests import au_test, kh_test, sh_test
from phylo_utils_tpu_torch.trees import nni_neighbors

# the JAX example's sizes (``simulate``'s), and its step and replicate
# counts (``run``'s)
SIZES = {"n_taxa": 8, "n_sites": 1200}
STEPS = {"fit_steps": 300, "pb_reps": 10, "pb_steps": 150, "bs_reps": 50,
         "n_boot": 1000}


def simulate(seed: int, n_taxa: int, n_sites: int, device):
    """(true tree, alignment): K80+G4 (kappa 3.5, alpha 0.6) sites on
    ``random_tree(n_taxa, seed=11, mean_brlen=0.2)``."""
    true_tree = pu.random_tree(n_taxa, seed=11, mean_brlen=0.2)
    aln = pu.simulate_alignment(
        seed, true_tree, pu.models.K80, n_sites,
        params={"kappa": 3.5, "alpha": 0.6}, ncat=4, device=device,
    )
    return true_tree, aln


def run(aln, true_tree, device="cuda", pruner="torch", fit_steps=300,
        pb_reps=10, pb_steps=150, bs_reps=50, n_boot=1000):
    """The analysis of ``aln`` on ``true_tree``; every number ``main``
    prints, with the fits, engine and arrays they come from, and
    ``stage_s``."""
    stages = Stages(device)
    # ---- ML fit + two flavors of parameter uncertainty --------------------
    engine = LikelihoodEngine(true_tree, aln, pu.models.K80, ncat=4,
                              pruner=pruner, device=device)
    mle = fit(engine, max_steps=fit_steps)
    stages.done("fit")
    se = standard_errors(engine, mle.params)
    stages.done("standard_errors")
    pb = parametric_bootstrap(engine, mle.params, n_replicates=pb_reps,
                              max_steps=pb_steps)
    stages.done("parametric_bootstrap")

    # ---- branch supports: FBP vs TBE + consensus --------------------------
    bs = bootstrap_tree_support(true_tree, aln, pu.models.K80,
                                n_reps=bs_reps, consensus=True, tbe=True,
                                device=device)
    stages.done("supports")

    # ---- topology significance: KH / SH / AU ------------------------------
    kappa = float(mle.params["model"]["kappa"])
    alpha = float(mle.params["alpha"])
    candidates = [true_tree] + nni_neighbors(true_tree)[:6]
    tse = TopologySetEngine(candidates, aln, pu.models.K80, ncat=4,
                            device=device)
    sw = tse.sitewise_loglikelihoods({"model": {"kappa": kappa},
                                      "alpha": alpha})
    kh, sh, au = (f(sw, n_boot=n_boot, seed=0)
                  for f in (kh_test, sh_test, au_test))
    stages.done("topology_tests")

    # ---- ancestral states: marginal vs joint ------------------------------
    post = ancestral_posteriors(engine, mle.params)
    joint = joint_ancestral_states(engine, mle.params)
    r = site_rates(engine, mle.params)
    stages.done("ancestral")
    return {
        "engine": engine, "fit": mle, "fit_loglik": mle.loglik,
        "kappa": kappa, "alpha": alpha,
        "kappa_se": float(se["model"]["kappa"]), "standard_errors": se,
        "parametric_bootstrap": pb,
        "kappa_pb_se": float(pb["se"]["model"]["kappa"]),
        "supports": bs, "edges": [int(e) for e in bs["edges"]],
        "fbp": [float(f) for f in bs["support"]],
        "tbe": [float(t) for t in bs["tbe"]],
        "consensus": pu.write_newick(bs["consensus"]),
        "candidates": candidates, "sitewise": sw,
        "kh": kh, "sh": sh, "au": au,
        "delta": [float(x) for x in kh["delta"]],
        "p_kh": [float(x) for x in kh["pvalue"]],
        "p_sh": [float(x) for x in sh["pvalue"]],
        "p_au": [float(x) for x in au["pvalue"]],
        "ancestral_posteriors": post, "joint": joint,
        "marginal_joint_agreement": float(
            (post.argmax(axis=2) == joint["states"]).mean()),
        "site_rates": r, "site_rate_min": float(r.min()),
        "site_rate_max": float(r.max()), "site_rate_mean": float(r.mean()),
        "stage_s": stages.seconds,
    }


def main(argv=None):
    args = example_parser(__doc__.splitlines()[0], 1,
                          {**SIZES, **STEPS}).parse_args(argv)
    device = checked_device(args.device)
    true_tree, aln = simulate(args.seed, args.n_taxa, args.n_sites, device)
    print(f"simulated {len(aln)} taxa x {args.n_sites} sites, K80+G4 "
          f"(kappa=3.5)")
    out = run(aln, true_tree, device=device, pruner=args.pruner,
              **{k: getattr(args, k) for k in STEPS})
    print(f"\nMLE: kappa={out['kappa']:.3f} +- {out['kappa_se']:.3f} "
          f"(observed Fisher), alpha={out['alpha']:.3f}")
    print(f"parametric bootstrap ({args.pb_reps} reps): kappa SE = "
          f"{out['kappa_pb_se']:.3f} (vs Fisher {out['kappa_se']:.3f})")
    print("\nedge supports (FBP / TBE):")
    for e, f, t in zip(out["edges"], out["fbp"], out["tbe"]):
        print(f"  edge {e}: {f:.2f} / {t:.2f}")
    print("consensus:", out["consensus"])
    print("\ntree  dlnL    p(KH)  p(SH)  p(AU)")
    for i in range(len(out["candidates"])):
        print(f"  {i}  {out['delta'][i]:7.2f}  {out['p_kh'][i]:.3f}  "
              f"{out['p_sh'][i]:.3f}  {out['p_au'][i]:.3f}")
    print(f"\nmarginal-vs-joint ancestral agreement: "
          f"{out['marginal_joint_agreement']:.1%}")
    print(f"site rates: min {out['site_rate_min']:.2f}, max "
          f"{out['site_rate_max']:.2f} (mean {out['site_rate_mean']:.2f})")


if __name__ == "__main__":
    main()
