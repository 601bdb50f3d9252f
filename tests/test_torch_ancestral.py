"""Port parity, ancestral reconstruction: ``phylo_utils_tpu_torch.ancestral``
(marginal posteriors, site-rate posteriors, site rates and the joint ML
states) against the JAX package on the same seeded inputs, and against
exhaustive enumeration over internal-state assignments as
``tests/test_ancestral.py``, ``tests/test_ancestral_mixture.py`` and
``tests/test_joint_ancestral.py`` hold the JAX package.

Tolerances: the f64 port (``pruner="torch"``) against the JAX f64 engine,
1e-9 absolute on posteriors and site-rate posteriors, 1e-9 relative on site
rates, joint states equal and their log_prob within 1e-10 relative; the f32
kernel path (``pruner="cuda"``: on CPU tensors the saveall walk's and the
value walks' plain versions, codons padded to 64 states) 2e-6 absolute
(``chip_smoke.POSTERIOR_TOL``), joint states equal and log_prob 1e-6
relative; the enumerations 1e-8 absolute (f64), as the JAX tests.
"""
import itertools

import numpy as np
import pytest
import scipy.linalg
import torch

import oracle.core as oracle
from phylo_utils_tpu import ancestral as janc
from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu.likelihood import LikelihoodEngine as JEngine
from phylo_utils_tpu.mixtures import ModelMixtureEngine as JModelMixture
from phylo_utils_tpu.profile_mixtures import (
    ProfileMixtureEngine as JProfileMixture,
)
from phylo_utils_tpu.trees import random_tree
from phylo_utils_tpu_torch import models
from phylo_utils_tpu_torch.alphabets import seq_to_partials
from phylo_utils_tpu_torch.ancestral import (
    _down_pass,
    _kernel_down_pass,
    ancestral_posteriors,
    joint_ancestral_states,
    site_rate_posteriors,
    site_rates,
)
from phylo_utils_tpu_torch.ascertainment import AscertainmentEngine
from phylo_utils_tpu_torch.batched import TopologySetEngine
from phylo_utils_tpu_torch.clock import ClockEngine
from phylo_utils_tpu_torch.io import parse_newick
from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
from phylo_utils_tpu_torch.mixtures import M1aEngine, ModelMixtureEngine
from phylo_utils_tpu_torch.model_selection import goldman_cox_test
from phylo_utils_tpu_torch.optimize import parametric_bootstrap
from phylo_utils_tpu_torch.partition import (
    Partition,
    PartitionedEngine,
    StackedPartitionedEngine,
)
from phylo_utils_tpu_torch.profile_mixtures import ProfileMixtureEngine
from phylo_utils_tpu_torch.simulate import simulate_alignment
from phylo_utils_tpu_torch.trees import Tree

from torch_threads import one_thread  # noqa: F401

POSTERIOR_TOL = 2e-6
T64 = dict(dtype="float64", device="cpu")
T32 = dict(dtype="float32", pruner="cuda", device="cpu")
GTR_PARAMS = {"model": {"rates": [1.2, 3.1, 0.7, 0.9, 4.2, 1.0],
                        "freqs": [0.3, 0.2, 0.22, 0.28]},
              "alpha": 0.7, "pinv": 0.15}
NWK = "((a:0.12,b:0.34):0.08,(c:0.21,d:0.05):0.15);"
ALN = {
    "a": "ACGTAAGTGGAATTCCGGTA",
    "b": "ACGTAGCAGGAATCCCGGTA",
    "c": "AGGTAAGAGTATTTCCGCTA",
    "d": "ACGAAAGTATAATTGCGGTA",
}
CHARMAP = {"A": 0, "C": 1, "G": 2, "T": 3}


def _port_tree(jtree):
    return Tree(jtree.names, jtree.parent, jtree.lengths, jtree.children,
                jtree.n_leaves)


def _jax_results(engine, params):
    return {
        "post": janc.ancestral_posteriors(engine, params),
        "srp": janc.site_rate_posteriors(engine, params),
        "rates": janc.site_rates(engine, params),
        "joint": janc.joint_ancestral_states(engine, params),
    }


@pytest.fixture(scope="module")
def dna_case():
    """GTR+G4+I on random_tree(8) x 200 sites (20 of them constant), and
    the JAX f64 engine's results, built once."""
    jtree = random_tree(8, seed=3)
    rng = np.random.default_rng(4)
    aln = {n: "".join(rng.choice(list("ACGT"), size=180)) + "A" * 10
           + "C" * 10 for n in jtree.leaf_names}
    je = JEngine(jtree, aln, jmodels.GTR, ncat=4, invariant_sites=True,
                 dtype="float64")
    return _port_tree(jtree), aln, _jax_results(je, GTR_PARAMS)


@pytest.fixture(scope="module")
def codon_case():
    """GY94 on random_tree(6) x 30 codons simulated by the port, and the
    JAX f64 engine's results at kappa 2.5, omega 0.4."""
    jtree = random_tree(6, seed=9)
    tree = _port_tree(jtree)
    aln = simulate_alignment(10, tree, models.GY94, 30,
                             params={"kappa": 2.5, "omega": 0.4},
                             device="cpu")
    params = {"model": {"kappa": 2.5, "omega": 0.4}}
    je = JEngine(jtree, aln, jmodels.GY94, dtype="float64")
    return tree, aln, params, _jax_results(je, params)


def _check(got, want, exact: bool):
    atol = 1e-9 if exact else POSTERIOR_TOL
    np.testing.assert_allclose(got["post"], want["post"], rtol=0, atol=atol)
    np.testing.assert_allclose(got["srp"], want["srp"], rtol=0, atol=atol)
    np.testing.assert_allclose(got["rates"], want["rates"],
                               rtol=1e-9 if exact else 1e-6)
    np.testing.assert_array_equal(got["joint"]["states"],
                                  want["joint"]["states"])
    np.testing.assert_array_equal(got["joint"]["category"],
                                  want["joint"]["category"])
    np.testing.assert_allclose(got["joint"]["log_prob"],
                               want["joint"]["log_prob"],
                               rtol=1e-10 if exact else 1e-6)


def _port_results(engine, params):
    return {
        "post": ancestral_posteriors(engine, params),
        "srp": site_rate_posteriors(engine, params),
        "rates": site_rates(engine, params),
        "joint": joint_ancestral_states(engine, params),
    }


@pytest.mark.parametrize("pruner", ["torch", "cuda"])
def test_dna_analyses_match_jax(dna_case, pruner):
    """Posteriors, site-rate posteriors, site rates and the joint states of
    a GTR+G4+I engine (the +I component mixed in log space) against
    JAX's."""
    tree, aln, want = dna_case
    kw = T64 if pruner == "torch" else T32
    engine = LikelihoodEngine(tree, aln, models.GTR, ncat=4,
                              invariant_sites=True, **kw)
    got = _port_results(engine, GTR_PARAMS)
    assert got["post"].shape == (7, 200, 4)
    _check(got, want, exact=pruner == "torch")


@pytest.mark.parametrize("pruner", ["torch", "cuda"])
def test_codon_analyses_match_jax(codon_case, pruner):
    """61 codon states: the kernel path pads to 64 states for the saveall
    walk and slices back, so the padded states carry no mass."""
    tree, aln, params, want = codon_case
    kw = T64 if pruner == "torch" else T32
    engine = LikelihoodEngine(tree, aln, models.GY94, **kw)
    got = _port_results(engine, params)
    assert got["post"].shape == (5, 30, 61)
    np.testing.assert_allclose(got["post"].sum(axis=2), 1.0, atol=1e-12)
    _check(got, want, exact=pruner == "torch")


def test_kernel_down_pass_equals_plain_down_pass():
    """The saveall walk's down pass (rescaled by powers of two, rows by
    node id - n_leaves) and the plain pass give each node the same
    partials up to the node's scale, and the same root logscale, on a
    tree with binarization pseudo-nodes."""
    tree = parse_newick("(a:0.1,b:0.2,c:0.3,(d:0.1,e:0.2,f:0.05):0.1);")
    rng = np.random.default_rng(0)
    aln = {n: "".join(rng.choice(list("ACGT"), size=40))
           for n in tree.leaf_names}
    engine = LikelihoodEngine(tree, aln, models.HKY85, ncat=2, **T32)
    assert engine.schedule.n_nodes > engine.schedule.n_real_nodes
    _, _, p, _ = engine._mixture_tensors(engine._full_params(None),
                                         torch.float64)
    lp = engine._leaf_partials
    kb, ks = _kernel_down_pass(engine, p, lp)
    pb, ps = _down_pass(engine.schedule, p.to(torch.float64),
                        lp.to(torch.float64))
    n = engine.schedule.n_nodes

    def norm(x):
        return x / x.sum(dim=-1, keepdim=True)

    np.testing.assert_allclose(norm(kb[:n].double()), norm(pb[:n]),
                               rtol=0, atol=1e-6)
    root = engine.schedule.root
    np.testing.assert_allclose(
        (torch.log(kb[root].double().amax(-1)) + ks[root]).numpy(),
        (torch.log(pb[root].amax(-1)) + ps[root]).numpy(), rtol=1e-6)


def test_multifurcation_reports_real_nodes_only():
    """Pseudo-nodes of the binarized schedule get no row: the JAX shapes
    and values on a tree with two multifurcations."""
    newick = "(a:0.1,b:0.2,c:0.3,(d:0.1,e:0.2,f:0.05):0.1);"
    rng = np.random.default_rng(1)
    aln = {n: "".join(rng.choice(list("ACGT"), size=30)) for n in "abcdef"}
    from phylo_utils_tpu.io import parse_newick as j_parse_newick

    je = JEngine(j_parse_newick(newick), aln, jmodels.HKY85, ncat=2,
                 dtype="float64")
    want = _jax_results(je, {"alpha": 0.5})
    for kw, exact in ((T64, True), (T32, False)):
        engine = LikelihoodEngine(parse_newick(newick), aln, models.HKY85,
                                  ncat=2, **kw)
        got = _port_results(engine, {"alpha": 0.5})
        assert got["post"].shape == (2, 30, 4)
        _check(got, want, exact)


def test_mixture_and_profile_engines_match_jax():
    """Model-mixture engines supply per-class (K, S) frequencies through
    the hook: a 2-class HKY85 kappa/freqs mixture with +I and a 3-profile
    HKY85 mixture with free class rates, against JAX's."""
    tree = parse_newick(NWK)
    from phylo_utils_tpu.io import parse_newick as j_parse_newick

    jtree = j_parse_newick(NWK)
    mixture = [{"kappa": 2.0, "freqs": [0.25] * 4},
               {"kappa": 6.0, "freqs": [0.4, 0.1, 0.2, 0.3]}]
    params = {"cat_weights": [0.6, 0.4], "pinv": 0.2}
    je = JModelMixture(jtree, ALN, jmodels.HKY85, mixture,
                       invariant_sites=True, dtype="float64")
    te = ModelMixtureEngine(tree, ALN, models.HKY85, mixture,
                            invariant_sites=True, **T64)
    np.testing.assert_allclose(ancestral_posteriors(te, params),
                               janc.ancestral_posteriors(je, params),
                               rtol=0, atol=1e-9)
    got, want = (joint_ancestral_states(te, params),
                 janc.joint_ancestral_states(je, params))
    np.testing.assert_array_equal(got["states"], want["states"])
    np.testing.assert_allclose(got["log_prob"], want["log_prob"],
                               rtol=1e-10)
    kw = dict(profiles=3, seed=2, class_rates="free")
    params = {"class_rates": [0.6, 1.0, 1.5]}
    je = JProfileMixture(jtree, ALN, jmodels.HKY85, dtype="float64", **kw)
    for tkw, atol in ((T64, 1e-9), (T32, POSTERIOR_TOL)):
        te = ProfileMixtureEngine(tree, ALN, models.HKY85, **tkw, **kw)
        np.testing.assert_allclose(ancestral_posteriors(te, params),
                                   janc.ancestral_posteriors(je, params),
                                   rtol=0, atol=atol)
        np.testing.assert_allclose(site_rate_posteriors(te, params),
                                   janc.site_rate_posteriors(je, params),
                                   rtol=0, atol=atol)


# -- exhaustive enumeration (tests/test_ancestral*.py, test_joint_*.py) ------


def _obs(tree, aln):
    return np.array([[CHARMAP[c] for c in aln[n]] for n in tree.leaf_names])


def _enum(tree, aln, cats, pinv=0.0):
    """(marginal posteriors, best log joint, best states, best category)
    over every (component, internal assignment); ``cats``: (Q, freqs,
    weight, rate) per category, the +I component last."""
    obs = _obs(tree, aln)
    n_nodes, n_leaves = len(tree.parent), tree.n_leaves
    internals = list(range(n_leaves, n_nodes))
    root = n_nodes - 1
    n_sites = obs.shape[1]
    tot = np.zeros(n_sites)
    acc = np.zeros((len(internals), n_sites, 4))
    best_lp = np.full(n_sites, -np.inf)
    best_states = np.zeros((len(internals), n_sites), int)
    best_cat = np.zeros(n_sites, int)
    fbar, wsum = np.zeros(4), 0.0
    for k, (q, freqs, w, r) in enumerate(cats):
        fbar += w * np.asarray(freqs)
        wsum += w
        p_edge = [scipy.linalg.expm(q * tree.lengths[v] * r)
                  for v in range(n_nodes)]
        for assign in itertools.product(range(4), repeat=len(internals)):
            st = dict(zip(internals, assign))
            pr = np.full(n_sites, (1 - pinv) * w * freqs[st[root]])
            for v in range(n_nodes):
                if v == root:
                    continue
                par = st[tree.parent[v]]
                pr = pr * (p_edge[v][par, obs[v]] if v < n_leaves
                           else p_edge[v][par, st[v]])
            tot += pr
            for i, v in enumerate(internals):
                acc[i, np.arange(n_sites), st[v]] += pr
            with np.errstate(divide="ignore"):
                lp = np.log(pr)
            b = lp > best_lp
            best_lp = np.where(b, lp, best_lp)
            best_cat = np.where(b, k, best_cat)
            for i, v in enumerate(internals):
                best_states[i] = np.where(b, st[v], best_states[i])
    if pinv > 0:
        fbar = fbar / wsum
        for x in range(4):
            ok = (obs == x).all(axis=0)
            pr = np.where(ok, pinv * fbar[x], 0.0)
            tot += pr
            for i in range(len(internals)):
                acc[i, np.arange(n_sites), x] += pr
            with np.errstate(divide="ignore"):
                lp = np.log(pr)
            b = lp > best_lp
            best_lp = np.where(b, lp, best_lp)
            best_cat = np.where(b, len(cats), best_cat)
            for i in range(len(internals)):
                best_states[i] = np.where(b, x, best_states[i])
    return acc / tot[None, :, None], best_lp, best_states, best_cat


@pytest.mark.parametrize("ncat,alpha", [(1, None), (3, 0.6)])
def test_ancestral_matches_brute_force(ncat, alpha):
    """Ambiguity codes and gaps at the leaves, one site per pattern."""
    tree = parse_newick("((a:0.15,b:0.3):0.1,(c:0.25,d:0.1):0.2);")
    aln = {"a": "ACGTAN", "b": "ACGTTC", "c": "AGGTAC", "d": "ACG-AC"}
    engine = LikelihoodEngine(tree, aln, models.HKY85, ncat=ncat,
                              compress=False, **T64)
    params = {"model": {"kappa": 2.5}}
    rates = np.array([1.0])
    if alpha is not None:
        params["alpha"] = alpha
        rates = np.asarray(oracle.discrete_gamma(alpha, ncat))
    post = ancestral_posteriors(engine, params)
    om = oracle.hky85(2.5, [0.25] * 4)
    leaves = {tree.leaf_index()[n]: np.asarray(seq_to_partials(s, "dna"))
              for n, s in aln.items()}
    internal = list(range(tree.n_leaves, tree.n_nodes))
    brute = np.zeros((len(internal), 6, 4))
    norm = np.zeros(6)
    for rate in rates:
        pm = {v: oracle.pmat(om, tree.lengths[v] * rate)
              for v in range(tree.n_nodes) if v != tree.root}
        for assign in itertools.product(range(4), repeat=len(internal)):
            st = dict(zip(internal, assign))
            prob = np.full(6, om.freqs[st[tree.root]] / len(rates))
            for v in range(tree.n_nodes):
                if v == tree.root:
                    continue
                pu = st[tree.parent[v]]
                prob = prob * (pm[v][pu] @ leaves[v].T if v < tree.n_leaves
                               else pm[v][pu, st[v]])
            norm += prob
            for i, v in enumerate(internal):
                brute[i, :, st[v]] += prob
    np.testing.assert_allclose(post, brute / norm[None, :, None], atol=5e-7)
    np.testing.assert_allclose(post.sum(axis=2), 1.0, atol=1e-6)


def test_site_rate_posteriors_bias():
    """Constant sites prefer slow categories, a hyper-variable site fast
    ones."""
    tree = parse_newick("((a:0.3,b:0.3):0.2,(c:0.3,d:0.3):0.2);")
    aln = {"a": "AAAAC", "b": "AAAAG", "c": "AAAAT", "d": "AAAAA"}
    engine = LikelihoodEngine(tree, aln, models.JC69, ncat=4,
                              compress=False, **T64)
    gam = site_rate_posteriors(engine, {"alpha": 0.5})
    assert gam.shape == (5, 4)
    np.testing.assert_allclose(gam.sum(axis=1), 1.0, atol=1e-6)
    rates = np.asarray(oracle.discrete_gamma(0.5, 4))
    assert gam[4] @ rates > gam[0] @ rates


def test_ancestral_map_states_are_sensible():
    tree = parse_newick("((a:0.05,b:0.05):0.05,(c:0.05,d:0.05):0.05);")
    aln = {"a": "AC", "b": "AC", "c": "AC", "d": "AC"}
    engine = LikelihoodEngine(tree, aln, models.JC69, compress=False, **T64)
    root_post = ancestral_posteriors(engine)[-1]
    assert root_post[0].argmax() == 0 and root_post[1].argmax() == 1
    assert root_post[0, 0] > 0.95


def _mixture_cats():
    f1 = np.array([0.25, 0.25, 0.25, 0.25])
    f2 = np.array([0.4, 0.1, 0.2, 0.3])
    mixture = [{"kappa": 2.0, "freqs": f1}, {"kappa": 6.0, "freqs": f2}]
    cats = [(oracle.hky85(2.0, f1).q, f1, 0.5, 1.0),
            (oracle.hky85(6.0, f2).q, f2, 0.5, 1.0)]
    return mixture, cats


def test_model_mixture_marginal_and_joint_match_enumeration():
    tree = parse_newick(NWK)
    mixture, cats = _mixture_cats()
    eng = ModelMixtureEngine(tree, ALN, models.HKY85, mixture, **T64)
    post, best_lp, best_states, _ = _enum(tree, ALN, cats)
    np.testing.assert_allclose(ancestral_posteriors(eng), post, atol=1e-8)
    res = joint_ancestral_states(eng)
    np.testing.assert_allclose(res["log_prob"], best_lp, rtol=1e-8)
    np.testing.assert_array_equal(res["states"], best_states)


def test_invariant_sites_marginal_and_joint_match_enumeration():
    """+I: the invariant component takes part in the marginal posteriors
    and competes in the joint maximization (category == ncat)."""
    tree = parse_newick(NWK)
    ncat, pinv, alpha, kappa = 2, 0.3, 0.7, 2.5
    eng = LikelihoodEngine(tree, ALN, models.HKY85, ncat=ncat,
                           invariant_sites=True, **T64)
    params = {"model": {"kappa": kappa}, "alpha": alpha, "pinv": pinv}
    m = oracle.hky85(kappa, [0.25] * 4)
    cats = [(m.q, m.freqs, 1.0 / ncat, r)
            for r in oracle.discrete_gamma(alpha, ncat)]
    post, best_lp, best_states, best_cat = _enum(tree, ALN, cats, pinv=pinv)
    np.testing.assert_allclose(ancestral_posteriors(eng, params), post,
                               atol=1e-8)
    res = joint_ancestral_states(eng, params)
    np.testing.assert_allclose(res["log_prob"], best_lp, rtol=1e-8)
    np.testing.assert_array_equal(res["states"], best_states)
    np.testing.assert_array_equal(res["category"], best_cat)
    assert (res["category"] == ncat).any()
    assert (res["log_prob"] <= eng.sitewise_loglikelihoods(params)
            + 1e-9).all()


@pytest.mark.parametrize("ncat", [1, 2])
def test_joint_matches_brute_force(ncat):
    tree = parse_newick(NWK)
    engine = LikelihoodEngine(tree, ALN, models.HKY85, ncat=ncat, **T64)
    params = {"model": {"kappa": 2.5}}
    rates = np.ones(1)
    if ncat > 1:
        params["alpha"] = 0.7
        rates = oracle.discrete_gamma(0.7, ncat)
    m = oracle.hky85(2.5, [0.25] * 4)
    cats = [(m.q, m.freqs, 1.0 / ncat, r) for r in rates]
    _, best_lp, best_states, _ = _enum(tree, ALN, cats)
    res = joint_ancestral_states(engine, params)
    np.testing.assert_allclose(res["log_prob"], best_lp, rtol=1e-8)
    np.testing.assert_array_equal(res["states"], best_states)


def test_joint_log_prob_bounded_by_marginal_likelihood():
    tree = parse_newick(NWK)
    engine = LikelihoodEngine(tree, ALN, models.GTR, ncat=3, **T64)
    res = joint_ancestral_states(engine)
    assert (res["log_prob"] <= engine.sitewise_loglikelihoods()
            + 1e-9).all()
    post = ancestral_posteriors(engine)
    strong = post.max(axis=2).min(axis=0) > 0.95
    if strong.any():
        agree = (post.argmax(axis=2) == res["states"])[:, strong]
        assert agree.mean() > 0.9


def test_site_rates_order_conserved_vs_variable():
    tree = parse_newick(NWK)
    aln = {"a": "AAAAACGT", "b": "AAAACGTA", "c": "AAAAGTAC",
           "d": "AAAATACG"}
    engine = LikelihoodEngine(tree, aln, models.JC69, ncat=4, **T64)
    r = site_rates(engine)
    assert r.shape == (8,)
    assert r[:4].max() < r[4:].min()
    assert 0.1 < r.mean() < 3.0


def test_joint_category_field_shape():
    tree = parse_newick(NWK)
    engine = LikelihoodEngine(tree, ALN, models.JC69, ncat=4, **T64)
    res = joint_ancestral_states(engine)
    assert res["states"].shape == (3, 20)
    assert res["log_prob"].shape == (20,) and res["category"].shape == (20,)
    assert res["category"].min() >= 0 and res["category"].max() < 4


# -- refusals and guards (tests/test_ancestral_mixture.py) -------------------


def _refused_engines():
    tree = parse_newick(NWK)
    variable = [i for i in range(len(ALN["a"]))
                if len({s[i] for s in ALN.values()}) > 1]
    parts = [Partition("p1", ALN, models.JC69),
             Partition("p2", ALN, models.K80)]
    return {
        "partitioned": lambda: PartitionedEngine(tree, parts, device="cpu"),
        "stacked": lambda: StackedPartitionedEngine(
            tree, [Partition("p1", ALN, models.K80),
                   Partition("p2", ALN, models.K80)], device="cpu"),
        "topology_set": lambda: TopologySetEngine(
            [tree, parse_newick("((a:0.1,c:0.3):0.08,(b:0.2,d:0.05):0.1);")],
            ALN, models.JC69, device="cpu"),
        # overrides _loglik_fn but keeps the base hook
        "ascertainment": lambda: AscertainmentEngine(
            tree, {n: "".join(s[i] for i in variable) for n, s in ALN.items()},
            models.JC69, correction="lewis", device="cpu"),
    }


@pytest.mark.parametrize("which", ["partitioned", "stacked", "topology_set",
                                   "ascertainment"])
def test_engines_without_the_hook_are_refused(which):
    eng = _refused_engines()[which]()
    for fn in (ancestral_posteriors, joint_ancestral_states,
               site_rate_posteriors):
        with pytest.raises(NotImplementedError, match="_mixture_tensors"):
            fn(eng)


def test_simulation_setup_rejects_non_base_engines():
    """parametric_bootstrap / goldman_cox_test refuse engines whose
    parameterization the simulator cannot generate under."""
    jtree = random_tree(5, seed=1)
    tree = _port_tree(jtree)
    caln = simulate_alignment(1, tree, models.GY94, 30,
                              params={"omega": 0.3}, device="cpu")
    daln = simulate_alignment(2, tree, models.K80, 60, device="cpu")
    for eng in (M1aEngine(tree, caln, ncat=1, device="cpu"),
                ClockEngine(tree, daln, models.K80, device="cpu")):
        with pytest.raises(ValueError, match="base LikelihoodEngine"):
            parametric_bootstrap(eng, n_replicates=1)
        with pytest.raises(ValueError, match="base LikelihoodEngine"):
            goldman_cox_test(eng, n_replicates=1)


def test_subclass_full_params_typo_guard():
    tree = _port_tree(random_tree(5, seed=1))
    caln = simulate_alignment(1, tree, models.GY94, 30,
                              params={"omega": 0.3}, device="cpu")
    daln = simulate_alignment(2, tree, models.K80, 60, device="cpu")
    m1a = M1aEngine(tree, caln, ncat=1, device="cpu")
    ce = ClockEngine(tree, daln, models.K80, device="cpu")
    with pytest.raises(ValueError, match="unknown parameter"):
        m1a._full_params({"hieght": 1.0})
    with pytest.raises(ValueError, match="unknown parameter"):
        ce._full_params({"root_hieght": 1.0})
    with pytest.raises(ValueError, match="unknown 'shared'"):
        m1a._full_params({"shared": {"kapa": 2.0}})

