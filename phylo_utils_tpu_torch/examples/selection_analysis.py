"""Worked example: the codeml-style selection toolkit, end to end (the
port's ``examples/selection_analysis.py``).

Simulates codon data where one half of the sites evolves under positive
selection and one clade evolves faster, then runs the full battery:
empirical codon frequencies (F3x4), the M1a-vs-M2a site test with NEB and
BEB site scans, the branch-site Model A test on the fast clade, a
free-ratio branch model, and a molecular-clock LRT.

Run:  python -m phylo_utils_tpu_torch.examples.selection_analysis --pruner cuda
      python -m phylo_utils_tpu_torch.examples.selection_analysis --device cpu
"""
from __future__ import annotations

import numpy as np

from phylo_utils_tpu_torch import models
from phylo_utils_tpu_torch.branch_models import (
    BranchModelEngine,
    branch_site_test,
    free_ratio_classes,
    mark_clade,
)
from phylo_utils_tpu_torch.clock import clock_test
from phylo_utils_tpu_torch.examples import (
    Stages,
    checked_device,
    example_parser,
)
from phylo_utils_tpu_torch.io import encode_codon_alignment, parse_newick
from phylo_utils_tpu_torch.mixtures import (
    M1aEngine,
    M2aEngine,
    beb_site_posteriors,
    m1a_m2a_test,
    omega_posteriors,
)
from phylo_utils_tpu_torch.models.codon import empirical_codon_frequencies
from phylo_utils_tpu_torch.optimize import fit
from phylo_utils_tpu_torch.simulate import simulate_alignment

TREE = "(((a:0.1,b:0.1):0.1,(c:0.1,d:0.1):0.1):0.05,(e:0.2,f:0.2):0.05);"
# the JAX example's sizes (``simulate``'s: purifying codons, then
# positively selected ones), and its step counts (``run``'s)
SIZES = {"n_purifying": 150, "n_positive": 150}
STEPS = {"m1a_steps": 80, "m2a_steps": 100, "branch_site_steps": 80,
         "free_ratio_steps": 60, "clock_steps": 80}
FREE = ("branch_lengths", "shared.kappa")   # freqs fixed at F3x4 (codeml)


def simulate(seed: int, n_purifying: int, n_positive: int, device):
    """(tree, alignment): ``n_purifying`` GY94 codons at omega 0.1 (seed
    ``seed``), then ``n_positive`` at omega 4 (seed ``seed + 1``), kappa
    2.5, on ``TREE``."""
    tree = parse_newick(TREE)
    pur = simulate_alignment(seed, tree, models.GY94, n_purifying,
                             params={"omega": 0.1, "kappa": 2.5},
                             device=device)
    pos = simulate_alignment(seed + 1, tree, models.GY94, n_positive,
                             params={"omega": 4.0, "kappa": 2.5},
                             device=device)
    return tree, {n: pur[n] + pos[n] for n in pur}


def _called(posterior, n_purifying):
    """(sites with P(positive) > 0.95, the share of them in the positive
    half)."""
    called = np.where(posterior > 0.95)[0]
    frac = float(np.mean(called >= n_purifying)) if len(called) else 0.0
    return called, frac


def run(aln, tree, device="cuda", pruner="torch", n_purifying=150,
        m1a_steps=80, m2a_steps=100, branch_site_steps=80,
        free_ratio_steps=60, clock_steps=80):
    """The selection battery on ``aln`` (in-frame codons, the first
    ``n_purifying`` of them purifying) over ``tree``; every number ``main``
    prints, with the fits, engines and arrays they come from, and
    ``stage_s``."""
    kw = {"pruner": pruner, "device": device}
    stages = Stages(device)
    ca = encode_codon_alignment(aln)
    f3x4 = empirical_codon_frequencies(aln, "f3x4")
    params0 = {"shared": {"freqs": f3x4}}

    # --- M1a vs M2a -------------------------------------------------------
    m1a = M1aEngine(tree, ca, **kw)
    r1 = fit(m1a, params0=params0, free=FREE + ("proportions", "omega0"),
             max_steps=m1a_steps)
    m2a = M2aEngine(tree, ca, **kw)
    r2 = fit(m2a, params0=params0,
             free=FREE + ("proportions", "omega0", "omega2_delta"),
             max_steps=m2a_steps)
    lrt = m1a_m2a_test(r1.loglik, r2.loglik)
    stages.done("m1a_m2a")

    # NEB site scan: which sites are under positive selection?
    mean_omega, gam = omega_posteriors(m2a, r2.params)
    neb_called, neb_frac = _called(gam[:, -1], n_purifying)
    stages.done("neb")
    # BEB (codeml's published site table): integrates over parameter
    # uncertainty instead of plugging in the MLEs
    p_pos, beb_w = beb_site_posteriors(m2a, r2.params)
    beb_called, beb_frac = _called(p_pos, n_purifying)
    stages.done("beb")

    # --- branch-site Model A on the fast clade ----------------------------
    bs = branch_site_test(tree, ca, mark_clade(tree, ["e", "f"]),
                          params0=params0, engine_kwargs=kw,
                          max_steps=branch_site_steps)
    stages.done("branch_site")

    # --- free-ratio branch model (one omega per edge) ---------------------
    fr = BranchModelEngine(
        tree, ca, models.GY94, free_ratio_classes(tree),
        class_params=[{"omega": 1.0} for _ in range(tree.n_nodes)],
        shared={"freqs": f3x4}, **kw,
    )
    rfr = fit(fr, free=("branch_lengths", "classes"),
              max_steps=free_ratio_steps)
    om = (rfr.params["classes"]["omega"].detach().to("cpu").numpy()
          [: tree.n_nodes - 1])
    stages.done("free_ratio")

    # --- molecular clock on the nucleotide level --------------------------
    ct = clock_test(tree, dict(aln), models.HKY85, engine_kwargs=kw,
                    max_steps=clock_steps)
    stages.done("clock")
    return {
        "codons": ca, "f3x4": f3x4,
        "m1a": m1a, "m1a_fit": r1, "m1a_loglik": r1.loglik,
        "m2a": m2a, "m2a_fit": r2, "m2a_loglik": r2.loglik,
        "m1a_m2a_pvalue": lrt["pvalue"],
        "omega2": 1.0 + float(r2.params["omega2_delta"]),
        "neb_mean_omega": mean_omega, "neb_posteriors": gam,
        "neb_called": len(neb_called), "neb_frac_right": neb_frac,
        "beb_positive": p_pos, "beb_mean_omega": beb_w,
        "beb_called": len(beb_called), "beb_frac_right": beb_frac,
        "branch_site": bs, "branch_site_alt_loglik": bs["alt"].loglik,
        "branch_site_null_loglik": bs["null"].loglik,
        "branch_site_pvalue": bs["lrt"]["pvalue"],
        "free_ratio": fr, "free_ratio_fit": rfr,
        "free_ratio_loglik": rfr.loglik,
        "free_ratio_omega_min": float(om.min()),
        "free_ratio_omega_max": float(om.max()),
        "clock": ct, "clock_df": int(ct["df"]),
        "clock_pvalue": ct["lrt"]["pvalue"],
        "clock_loglik": ct["null"].loglik, "free_loglik": ct["alt"].loglik,
        "stage_s": stages.seconds,
    }


def main(argv=None):
    args = example_parser(__doc__.splitlines()[0], 0,
                          {**SIZES, **STEPS}).parse_args(argv)
    device = checked_device(args.device)
    # --- simulate: purifying + positively selected codon sites -------------
    tree, aln = simulate(args.seed, args.n_purifying, args.n_positive,
                         device)
    out = run(aln, tree, device=device, pruner=args.pruner,
              n_purifying=args.n_purifying,
              **{k: getattr(args, k) for k in STEPS})
    print(f"M1a lnL={out['m1a_loglik']:.2f}  M2a lnL={out['m2a_loglik']:.2f}"
          f"  p={out['m1a_m2a_pvalue']:.2e}")
    print(f"  positive class omega = {out['omega2']:.2f}")
    print(f"  NEB sites with P(positive)>0.95: {out['neb_called']} "
          f"({out['neb_frac_right']:.0%} in the truly positive half)")
    print(f"  BEB sites with P(positive)>0.95: {out['beb_called']} "
          f"({out['beb_frac_right']:.0%} in the truly positive half)")
    print(f"branch-site A: alt lnL={out['branch_site_alt_loglik']:.2f}  "
          f"null lnL={out['branch_site_null_loglik']:.2f}  "
          f"p={out['branch_site_pvalue']:.2e}")
    print(f"free-ratio: lnL={out['free_ratio_loglik']:.2f}  per-edge omega "
          f"in [{out['free_ratio_omega_min']:.2f}, "
          f"{out['free_ratio_omega_max']:.2f}]")
    print(f"clock LRT: df={out['clock_df']}  p={out['clock_pvalue']:.3f}  "
          f"(clock lnL={out['clock_loglik']:.2f}, free "
          f"lnL={out['free_loglik']:.2f})")


if __name__ == "__main__":
    main()
