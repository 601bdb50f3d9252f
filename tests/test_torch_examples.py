"""Port parity, the worked examples: ``phylo_utils_tpu_torch.examples``'s
``full_analysis``, ``uncertainty_analysis`` and ``selection_analysis``,
each ``run(..., device="cpu")`` (float64, ``pruner="torch"``) at a cut
size, against the JAX package's calls of the same steps on the same
alignment, and the examples' imports. The alignments are simulated here by
numpy under ``oracle``'s models (scipy's expm), the JAX example's models
and parameters.

Cut sizes: 6 taxa x 200 sites (full, uncertainty) and 6 taxa x 30 + 30
codons (selection); at most 30 fit steps (60 for the K80 fit below), 10
replicates and 10 RELL draws. The packages fit with different optimizers
(torch L-BFGS, optax L-BFGS), so one fit that both packages bring to its
optimum within those steps (the uncertainty example's K80 fit, the MLE
that example's later steps start from) is held to JAX's own fit with
``tests/test_torch_optimize.py``'s tolerances (logL 1e-5 absolute, the
parameters 2e-3 absolute; a two-child root's edges by their sum, the
only identifiable quantity), and every fit and later step at the port's
fitted
parameters: logL, sitewise values, bootstrap replicates and BIC 1e-10
relative, posteriors 1e-10 absolute, standard errors 1e-7 relative (both
packages take central differences there,
``tests/test_torch_uncertainty.py``), LRT p-values 1e-7 relative (the
statistic is a difference of two logLs); ML distances 1e-10 relative (one
Newton iteration in each); integers (RF distances, round counts, the BIC
order, the SH/AU best index and rejections, MAP and joint states, called
sites) and the bootstrap supports exactly. The parametric bootstrap's
replicates are simulated by the port (no stream parity with
``jax.random``; ``tests/test_torch_parametric_bootstrap.py`` refits one
with JAX), so its summary is held to its own replicates. One intra-op
thread.
"""
import ast
import importlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from oracle import core as oracle
from phylo_utils_tpu import ancestral as janc
from phylo_utils_tpu import branch_models as jbm
from phylo_utils_tpu import clock as jclock
from phylo_utils_tpu import mixtures as jmix
from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu import topology_tests as jtt
from phylo_utils_tpu.batched import TopologySetEngine as JaxTSE
from phylo_utils_tpu.batched import nni_hill_climb as j_hill_climb
from phylo_utils_tpu.io import encode_codon_alignment as j_encode_codons
from phylo_utils_tpu.io import parse_newick as j_parse_newick
from phylo_utils_tpu.io import write_newick as j_write_newick
from phylo_utils_tpu.likelihood import LikelihoodEngine as JaxEngine
from phylo_utils_tpu.model_selection import count_free_parameters
from phylo_utils_tpu.model_selection import likelihood_ratio_test as j_lrt
from phylo_utils_tpu.models.codon import (
    empirical_codon_frequencies as j_codon_freqs,
)
from phylo_utils_tpu.nj import neighbor_joining as j_nj
from phylo_utils_tpu.optimize import fit as j_fit
from phylo_utils_tpu.optimize import ml_distance_matrix as j_distances
from phylo_utils_tpu.optimize import standard_errors as j_standard_errors
from phylo_utils_tpu.supports import bootstrap_tree_support as j_supports
from phylo_utils_tpu_torch.convert import flatten_params, params_to_numpy
from phylo_utils_tpu_torch.examples import (
    full_analysis,
    selection_analysis,
    uncertainty_analysis,
)
from phylo_utils_tpu_torch.io import parse_newick, write_newick
from phylo_utils_tpu_torch.trees import random_tree, robinson_foulds

from torch_threads import one_thread  # noqa: F401

F64 = 1e-10
FIT_LOGL, FIT_PARAM = 1e-5, 2e-3       # tests/test_torch_optimize.py
SE_TOL = 1e-7                          # tests/test_torch_uncertainty.py
LRT_TOL = 1e-7
# GY94's 61 sense codons in oracle's (TCAG) order
_CODONS = [a + b + c for a in "TCAG" for b in "TCAG" for c in "TCAG"
           if a + b + c not in ("TAA", "TAG", "TGA")]
EXAMPLES = {"full_analysis": full_analysis,
            "uncertainty_analysis": uncertainty_analysis,
            "selection_analysis": selection_analysis}


def _jtree(tree):
    return j_parse_newick(write_newick(tree))


def _ptree(jtree):
    return parse_newick(j_write_newick(jtree))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def _abs(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64))))


def _simulate(tree, model, n_sites, seed, alpha=None, states="ACGT"):
    """{leaf name: sequence} of ``n_sites`` simulated by numpy down ``tree``
    under an ``oracle`` model (+G4 at ``alpha``: a category drawn a site)."""
    rng = np.random.default_rng(seed)
    rates = oracle.discrete_gamma(alpha, 4) if alpha else np.ones(1)
    cat = rng.integers(len(rates), size=n_sites)
    x = np.empty((tree.n_nodes, n_sites), np.int64)
    x[tree.root] = rng.choice(len(model.freqs), size=n_sites, p=model.freqs)
    todo = [tree.root]
    while todo:
        node = todo.pop()
        for child in tree.children[node]:
            for k, rate in enumerate(rates):
                sel = np.flatnonzero(cat == k)
                cdf = oracle.pmat(model, rate * tree.lengths[child]).cumsum(1)
                u = rng.random(sel.size)[:, None]
                x[child, sel] = np.minimum((u > cdf[x[node, sel]]).sum(1),
                                           len(states) - 1)
            todo.append(child)
    return {tree.names[i]: "".join(states[s] for s in x[i])
            for i in range(tree.n_leaves)}


def _at_port_fit(engine, fit, jengine):
    """The JAX engine's logL at the port's fitted parameters, held to the
    port engine's there (``F64``)."""
    want = float(jengine.loglikelihood(params_to_numpy(fit.params)))
    assert _rel(engine.loglikelihood(fit.params), want) <= F64
    return want


def _fits_agree(port, ref, tree):
    """Two packages' fits of one engine on ``tree`` at their optima: logL
    and every parameter (``FIT_LOGL``, ``FIT_PARAM`` absolute), a two-child
    root's edges by their sum (reversible models: the pulley principle)."""
    assert abs(port.loglik - float(ref.loglik)) <= FIT_LOGL

    def leaves(params):
        out = dict(zip(*flatten_params(params_to_numpy(params))))
        kids = tree.children[tree.root]
        if len(kids) == 2:
            bl = out[("branch_lengths",)].copy()
            bl[kids[0]] += bl[kids[1]]
            bl[kids[1]] = 0.0
            out[("branch_lengths",)] = bl
        return out

    got = leaves(port.params)
    want = leaves(jax.tree.map(np.asarray, ref.params))
    for name, g in got.items():
        assert _abs(g, want[name]) <= FIT_PARAM, name


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_imports_no_jax(name):
    """Each example module imports neither ``jax`` nor the JAX package, and
    its ``main`` runs on the card by default: without one it names
    ``--device cpu``."""
    path = Path(EXAMPLES[name].__file__)
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "phylo_utils_tpu"), mod
    module = importlib.import_module(f"phylo_utils_tpu_torch.examples.{name}")
    assert callable(module.run) and callable(module.main)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            module.main(["--device", "cuda"])


def test_full_analysis_matches_jax():
    """Distances, NJ, the NNI/SPR search (rounds, RF 0, logL 1e-8 as
    ``tests/test_torch_search.py``), the four candidates' logL and BIC at
    the port's fits and their order, then at the port's HKY85 fit its logL,
    the site-rate and ancestral posteriors, the bootstrap replicates, the
    candidate set's sitewise values and the SH test."""
    true = random_tree(6, seed=7, mean_brlen=0.15)
    aln = _simulate(true, oracle.hky85(4.0, [0.25] * 4), 200, seed=0,
                    alpha=0.4)
    steps = dict(max_rounds=1, compare_steps=5, fit_steps=10, n_boot=10)
    out = full_analysis.run(aln, true, device="cpu", **steps)

    jd = np.asarray(j_distances(aln, jmodels.K80))
    off = ~np.eye(len(aln), dtype=bool)
    assert _rel(out["distances"][off], jd[off]) <= F64
    assert robinson_foulds(out["nj_tree"],
                           _ptree(j_nj(jd, list(aln)))) == 0
    # from the port's NJ tree: distances 1e-15 apart may break the last
    # join's three-way tie elsewhere, and the SPR neighbourhood depends on
    # where the tree is rooted
    jt, jll, jr = j_hill_climb(_jtree(out["nj_tree"]), aln, jmodels.K80,
                               ncat=4, moves="both",
                               max_rounds=steps["max_rounds"])
    assert out["search_rounds"] == jr
    assert robinson_foulds(out["tree"], _ptree(jt)) == 0
    assert _rel(out["search_loglik"], jll) <= 1e-8
    assert out["rf_to_truth"] == robinson_foulds(true, _ptree(jt))
    jtree = _jtree(out["tree"])

    jbic = {}
    for f in out["model_fits"]:
        model, ncat, inv, _, rate_model = jmodels.parse_model_spec(f.name)
        je = JaxEngine(jtree, aln, model, ncat=ncat, invariant_sites=inv,
                       rate_model=rate_model)
        ll = je.loglikelihood(params_to_numpy(f.params))
        k = count_free_parameters(je)
        assert _rel(f.loglik, ll) <= F64 and f.k == k, f.name
        jbic[f.name] = k * np.log(200.0) - 2 * ll
        assert _rel(f.bic, jbic[f.name]) <= F64, f.name
    assert [n for n, _ in out["model_ranking"]] == sorted(jbic,
                                                          key=jbic.get)

    je = JaxEngine(jtree, aln, jmodels.HKY85, ncat=4)
    _at_port_fit(out["engine"], out["fit"], je)
    point = params_to_numpy(out["fit"].params)
    assert _abs(out["site_rate_posteriors"],
                janc.site_rate_posteriors(je, point)) <= F64
    jpost = np.asarray(janc.ancestral_posteriors(je, point))
    assert _abs(out["ancestral_posteriors"], jpost) <= F64
    assert out["root_map_state_site0"] == int(jpost[-1, 0].argmax())
    assert _rel(out["bootstrap_logliks"],
                je.bootstrap_loglikelihoods(steps["n_boot"], point,
                                            seed=1)) <= F64

    jtse = JaxTSE([_jtree(c) for c in out["candidates"]], aln,
                  jmodels.HKY85, ncat=4)
    jsw = jtse.sitewise_loglikelihoods({"model": point["model"],
                                        "alpha": point["alpha"]})
    assert _rel(out["sitewise"], jsw) <= F64
    jsh = jtt.sh_test(jsw)
    assert out["sh_best"] == int(jsh["best"])
    assert out["sh_rejected"] == int((jsh["pvalue"] < 0.05).sum())


def test_uncertainty_analysis_matches_jax():
    """The K80 fit against JAX's, then at the port's fit its standard
    errors, the FBP/TBE supports and consensus, the candidates' sitewise
    values and the KH/SH/AU tests, the marginal and joint ancestral states
    and the site rates; the parametric bootstrap against its own
    replicates."""
    true = random_tree(6, seed=11, mean_brlen=0.2)
    jtrue = _jtree(true)
    aln = _simulate(true, oracle.k80(3.5), 200, seed=1, alpha=0.6)
    steps = dict(fit_steps=60, pb_reps=2, pb_steps=5, bs_reps=10,
                 n_boot=10)
    out = uncertainty_analysis.run(aln, true, device="cpu", **steps)

    je = JaxEngine(jtrue, aln, jmodels.K80, ncat=4)
    _fits_agree(out["fit"], j_fit(je, max_steps=steps["fit_steps"]), true)
    _at_port_fit(out["engine"], out["fit"], je)
    point = params_to_numpy(out["fit"].params)
    jse = j_standard_errors(je, jax.tree.map(jax.numpy.asarray, point))
    assert _rel(out["kappa_se"], jse["model"]["kappa"]) <= SE_TOL

    pb = out["parametric_bootstrap"]
    kappas = pb["replicates"]["model"]["kappa"]
    assert kappas.shape == (steps["pb_reps"],) and np.isfinite(kappas).all()
    assert out["kappa_pb_se"] == pytest.approx(np.std(kappas, ddof=1),
                                               rel=1e-12)

    jbs = j_supports(jtrue, aln, jmodels.K80, n_reps=steps["bs_reps"],
                     consensus=True, tbe=True)
    assert out["edges"] == [int(e) for e in jbs["edges"]]
    np.testing.assert_array_equal(out["fbp"], np.asarray(jbs["support"]))
    assert _abs(out["tbe"], jbs["tbe"]) <= F64
    assert robinson_foulds(out["supports"]["consensus"],
                           _ptree(jbs["consensus"])) == 0

    jtse = JaxTSE([_jtree(c) for c in out["candidates"]], aln, jmodels.K80,
                  ncat=4)
    jsw = jtse.sitewise_loglikelihoods({"model": {"kappa": out["kappa"]},
                                        "alpha": out["alpha"]})
    assert _rel(out["sitewise"], jsw) <= F64
    for key, test in (("kh", jtt.kh_test), ("sh", jtt.sh_test),
                      ("au", jtt.au_test)):
        want = test(jsw, n_boot=steps["n_boot"], seed=0)
        assert int(out[key]["best"]) == int(want["best"]), key
        assert _abs(out[key]["delta"], want["delta"]) <= 1e-8, key
        np.testing.assert_allclose(out[key]["pvalue"], want["pvalue"],
                                   rtol=1e-8, atol=1e-12, err_msg=key)

    jpost = np.asarray(janc.ancestral_posteriors(je, point))
    assert _abs(out["ancestral_posteriors"], jpost) <= F64
    jjoint = janc.joint_ancestral_states(je, point)
    np.testing.assert_array_equal(out["joint"]["states"],
                                  np.asarray(jjoint["states"]))
    assert out["marginal_joint_agreement"] == float(
        (jpost.argmax(axis=2) == np.asarray(jjoint["states"])).mean())
    assert _abs(out["site_rates"], janc.site_rates(je, point)) <= F64


def test_selection_analysis_matches_jax():
    """F3x4, then at the port's fits M1a and M2a's logL and LRT, the NEB
    and BEB scans and their called sites, branch-site A's two engines and
    LRT, the free-ratio engine, the clock's two engines, LRT and df."""
    tree = parse_newick(selection_analysis.TREE)
    jtree = j_parse_newick(selection_analysis.TREE)
    codons = _CODONS
    pur = _simulate(tree, oracle.gy94(2.5, 0.1), 30, seed=0, states=codons)
    pos = _simulate(tree, oracle.gy94(2.5, 4.0), 30, seed=1, states=codons)
    aln = {n: pur[n] + pos[n] for n in pur}
    steps = dict(n_purifying=30, m1a_steps=20, m2a_steps=20,
                 branch_site_steps=10, free_ratio_steps=10, clock_steps=30)
    out = selection_analysis.run(aln, tree, device="cpu", **steps)

    f3x4 = np.asarray(j_codon_freqs(aln, "f3x4"))
    assert _abs(out["f3x4"], f3x4) <= 1e-15
    jca = j_encode_codons(aln)
    jm2a = jmix.M2aEngine(jtree, jca)
    ll1 = _at_port_fit(out["m1a"], out["m1a_fit"], jmix.M1aEngine(jtree, jca))
    ll2 = _at_port_fit(out["m2a"], out["m2a_fit"], jm2a)
    assert _rel(out["m1a_m2a_pvalue"],
                jmix.m1a_m2a_test(ll1, ll2)["pvalue"]) <= LRT_TOL
    p2 = params_to_numpy(out["m2a_fit"].params)

    jmean, jgam = jmix.omega_posteriors(jm2a, p2)
    assert _abs(out["neb_posteriors"], jgam) <= F64
    assert _abs(out["neb_mean_omega"], jmean) <= F64
    assert out["neb_called"] == int((np.asarray(jgam)[:, -1] > 0.95).sum())
    jpos, jw = jmix.beb_site_posteriors(jm2a, p2)
    assert _abs(out["beb_positive"], jpos) <= F64
    assert _abs(out["beb_mean_omega"], jw) <= F64
    assert out["beb_called"] == int((np.asarray(jpos) > 0.95).sum())

    bs = out["branch_site"]
    fg = jbm.mark_clade(jtree, ["e", "f"])
    ll = {key: _at_port_fit(bs[f"{key}_engine"], bs[key],
                            jbm.BranchSiteAEngine(jtree, jca, fg))
          for key in ("alt", "null")}
    assert _rel(out["branch_site_pvalue"], j_lrt(
        ll["null"], ll["alt"], df=1)["pvalue"]) <= LRT_TOL

    jfr = jbm.BranchModelEngine(
        jtree, jca, jmodels.GY94, jbm.free_ratio_classes(jtree),
        class_params=[{"omega": 1.0} for _ in range(jtree.n_nodes)],
        shared={"freqs": f3x4})
    _at_port_fit(out["free_ratio"], out["free_ratio_fit"], jfr)

    ct = out["clock"]
    ll_null = _at_port_fit(ct["null_engine"], ct["null"],
                           jclock.ClockEngine(jtree, aln, jmodels.HKY85))
    ll_alt = _at_port_fit(ct["alt_engine"], ct["alt"],
                          JaxEngine(jtree, aln, jmodels.HKY85))
    assert out["clock_df"] == 4
    assert _rel(out["clock_pvalue"], j_lrt(ll_null, ll_alt, df=4)["pvalue"]) \
        <= LRT_TOL
