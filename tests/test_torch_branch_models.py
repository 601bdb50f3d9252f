"""Port parity, branch models: ``phylo_utils_tpu_torch.branch_models``
(``BranchModelEngine``, ``BranchSiteAEngine``, ``branch_site_test``,
``beb_branch_site`` and the edge-class helpers) against the JAX package on
the same seeded inputs, and the cases of ``tests/test_branch_models.py``
against the float64 oracle with per-edge models.

Tolerances: the f64 port (``pruner="torch"``) against the JAX f64 engines,
1e-10 relative on logL and per site, gradients 1e-8 x max|g| per leaf, BEB
1e-8 absolute; the f32 kernel path (``pruner="cuda"``: on CPU tensors the
walks' plain versions, codons padded to 64 states) 1e-6 relative on logL,
5e-4 x max|g| (``chip_smoke.GRAD_TOL``) and BEB 1e-4 (``BEB_TOL``). The
branch-site LRT is held at the port's own fitted parameters: the JAX
engines' logL there gives JAX's ``likelihood_ratio_test`` the port's
statistic (the two packages fit with different optimizers); the power
replicates of the JAX test are not re-run.
"""
import jax
import numpy as np
import pytest
import torch

from oracle import core as oracle
from phylo_utils_tpu import branch_models as jbm
from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu.ancestral import ancestral_posteriors as j_posteriors
from phylo_utils_tpu.io import encode_codon_alignment as j_encode_codons
from phylo_utils_tpu.model_selection import (
    likelihood_ratio_test as j_lrt,
)
from phylo_utils_tpu.trees import random_tree
from phylo_utils_tpu_torch import models
from phylo_utils_tpu_torch.ancestral import ancestral_posteriors
from phylo_utils_tpu_torch.branch_models import (
    BranchModelEngine,
    BranchSiteAEngine,
    _branch_site_pair_logliks,
    beb_branch_site,
    branch_site_test,
    free_ratio_classes,
    mark_branches,
    mark_clade,
)
from phylo_utils_tpu_torch.convert import flatten_params, params_to_numpy
from phylo_utils_tpu_torch.io import encode_codon_alignment, parse_newick
from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
from phylo_utils_tpu_torch.mixtures import ModelMixtureEngine
from phylo_utils_tpu_torch.optimize import (
    fit,
    transform_params,
    untransform_params,
)
from phylo_utils_tpu_torch.simulate import (
    simulate_alignment,
    simulate_branch_alignment,
)
from phylo_utils_tpu_torch.trees import Tree

from torch_threads import one_thread  # noqa: F401

T64 = dict(dtype="float64", device="cpu")
T32 = dict(dtype="float32", pruner="cuda", device="cpu")
GRAD_TOL = 5e-4
BEB_TOL = 1e-4


def _port_tree(jtree):
    return Tree(jtree.names, jtree.parent, jtree.lengths, jtree.children,
                jtree.n_leaves)


@pytest.fixture(scope="module")
def dna_case():
    jtree = random_tree(8, seed=3)
    rng = np.random.default_rng(4)
    aln = {n: "".join(rng.choice(list("ACGT"), size=150))
           for n in jtree.leaf_names}
    return jtree, _port_tree(jtree), aln


@pytest.fixture(scope="module")
def codon_case():
    """60 GY94 codons simulated by the port on random_tree(6), a
    foreground clade of two leaves."""
    jtree = random_tree(6, seed=9)
    tree = _port_tree(jtree)
    aln = simulate_alignment(10, tree, models.GY94, 60,
                             params={"kappa": 2.0, "omega": 0.4},
                             device="cpu")
    fg = mark_clade(tree, tree.leaf_names[:2])
    return jtree, tree, aln, fg


def _by_path(tree) -> dict:
    names, leaves = flatten_params(params_to_numpy(tree))
    return dict(zip(names, leaves))


# each JAX engine's (logL, sitewise, gradient), built once for both pruners
_JAX_RESULTS = {}


def _jax_results(key, make_engine, params):
    if key not in _JAX_RESULTS:
        je = make_engine()
        _JAX_RESULTS[key] = (
            je.loglikelihood(params), je.sitewise_loglikelihoods(params),
            _by_path(jax.tree.map(np.asarray,
                                  je.gradient(je._full_params(params)))))
    return _JAX_RESULTS[key]


def _check_pair(want, te, params, rtol, gtol):
    """logL, sitewise logL and every gradient leaf of ``te`` against the
    JAX engine's ``want`` at ``params``."""
    ll, sw, grads = want
    assert te.loglikelihood(params) == pytest.approx(ll, rel=rtol)
    np.testing.assert_allclose(te.sitewise_loglikelihoods(params), sw,
                               rtol=rtol)
    got = _by_path(te.gradient(params))
    assert set(got) == set(grads)
    for path, w in grads.items():
        np.testing.assert_allclose(got[path], w, rtol=0,
                                   atol=gtol * np.abs(w).max(),
                                   err_msg=str(path))


def test_edge_class_helpers_match_jax(dna_case):
    jtree, tree, _ = dna_case
    names = tree.leaf_names
    np.testing.assert_array_equal(mark_branches(tree, names[:2]),
                                  jbm.mark_branches(jtree, names[:2]))
    for stem in (True, False):
        np.testing.assert_array_equal(
            mark_clade(tree, names[:3], include_stem=stem),
            jbm.mark_clade(jtree, names[:3], include_stem=stem))
    np.testing.assert_array_equal(free_ratio_classes(tree),
                                  jbm.free_ratio_classes(jtree))
    with pytest.raises(ValueError, match="no nodes named"):
        mark_branches(tree, ["nope"])
    with pytest.raises(ValueError, match="unknown leaf"):
        mark_clade(tree, ["nope"])


@pytest.mark.parametrize("pruner", ["torch", "cuda"])
@pytest.mark.parametrize("case", ["two_class", "free_ratio"])
def test_branch_model_engine_matches_jax(dna_case, case, pruner):
    """A two-class HKY85+G4+I kappa model and the free-ratio (paired) form:
    logL, sitewise and the gradient in every parameter."""
    jtree, tree, aln = dna_case
    if case == "two_class":
        kw = dict(branch_classes=mark_clade(tree, tree.leaf_names[:3]),
                  class_params=[{"kappa": 2.0}, {"kappa": 6.0}],
                  ncat=4, invariant_sites=True)
        params = {"alpha": 0.6, "pinv": 0.1,
                  "shared": {"freqs": [0.3, 0.2, 0.2, 0.3]}}
    else:
        kw = dict(branch_classes=free_ratio_classes(tree),
                  class_params=[{"kappa": 1.5 + 0.2 * i}
                                for i in range(tree.n_nodes)], ncat=2)
        params = {"alpha": 0.9}
    want = _jax_results(case, lambda: jbm.BranchModelEngine(
        jtree, aln, jmodels.HKY85, dtype="float64", **kw), params)
    te = BranchModelEngine(tree, aln, models.HKY85,
                           **(T64 if pruner == "torch" else T32), **kw)
    assert te._paired == (case == "free_ratio")
    rtol, gtol = (1e-10, 1e-8) if pruner == "torch" else (1e-6, GRAD_TOL)
    _check_pair(want, te, params, rtol, gtol)


@pytest.mark.parametrize("pruner", ["torch", "cuda"])
def test_branch_site_engine_matches_jax(codon_case, pruner):
    jtree, tree, aln, fg = codon_case
    params = {"proportions": [0.6, 0.25, 0.15], "omega0": 0.3,
              "omega2_delta": 2.5, "shared": {"kappa": 2.2}}
    want = _jax_results("branch_site", lambda: jbm.BranchSiteAEngine(
        jtree, j_encode_codons(aln), fg, dtype="float64"), params)
    te = BranchSiteAEngine(tree, encode_codon_alignment(aln), fg,
                           **(T64 if pruner == "torch" else T32))
    rtol, gtol = (1e-10, 1e-8) if pruner == "torch" else (1e-6, GRAD_TOL)
    _check_pair(want, te, params, rtol, gtol)


@pytest.mark.parametrize("pruner", ["torch", "cuda"])
def test_beb_branch_site_matches_jax(codon_case, pruner):
    """The BEB scan at d = 4: 25 (omega_bg, omega_fg) pairs in one chunk
    of the pruning's category axis, the grid sums in numpy."""
    jtree, tree, aln, fg = codon_case
    params = {"proportions": [0.5, 0.2, 0.3], "omega0": 0.2,
              "omega2_delta": 3.0}
    if "beb" not in _JAX_RESULTS:
        je = jbm.BranchSiteAEngine(jtree, aln, fg, dtype="float64")
        _JAX_RESULTS["beb"] = jbm.beb_branch_site(je, params, d=4)
    te = BranchSiteAEngine(tree, aln, fg,
                           **(T64 if pruner == "torch" else T32))
    tol = 1e-8 if pruner == "torch" else BEB_TOL
    for got, want in zip(beb_branch_site(te, params, d=4),
                         _JAX_RESULTS["beb"]):
        assert got.shape == (60,)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_pair_logliks_pad_the_last_chunk(codon_case):
    """40 pairs: a chunk of 32 and one of 8 padded to 32 (the surplus rows
    discarded), as JAX's."""
    jtree, tree, aln, fg = codon_case
    rng = np.random.default_rng(0)
    pairs = np.stack([rng.uniform(0.05, 1.0, 40),
                      rng.uniform(1.0, 8.0, 40)], axis=1)
    je = jbm.BranchSiteAEngine(jtree, aln, fg, dtype="float64")
    te = BranchSiteAEngine(tree, aln, fg, **T64)
    got = _branch_site_pair_logliks(te, te._full_params(None), pairs)
    want = np.asarray(jbm._branch_site_pair_logliks(
        je, je._full_params(None), pairs))
    n_pat = te._compressed.n_patterns
    # both packages' patterns, back in site order
    np.testing.assert_allclose(
        got[:, :n_pat][:, te._compressed.site_to_pattern],
        want[:, :n_pat][:, je._compressed.site_to_pattern], rtol=1e-10)


def test_branch_site_test_lrt_matches_jax_at_the_fits(codon_case):
    """The port's branch_site_test: the null fixes omega2 = 1 and the LRT
    (df = 1) is JAX's ``likelihood_ratio_test`` of the JAX engines' logL
    at the port's fitted null and alternative."""
    jtree, tree, aln, fg = codon_case
    ca = encode_codon_alignment(aln)
    out = branch_site_test(tree, ca, fg, engine_kwargs=T64, max_steps=15)
    assert float(out["null"].params["omega2_delta"]) == 0.0
    je = jbm.BranchSiteAEngine(jtree, j_encode_codons(aln), fg,
                               dtype="float64")
    ll = {k: je.loglikelihood(params_to_numpy(out[k].params))
          for k in ("null", "alt")}
    for k in ll:
        assert out[k].loglik == pytest.approx(ll[k], rel=1e-10)
    want = j_lrt(ll["null"], ll["alt"], df=1)
    assert out["lrt"]["df"] == want["df"] == 1
    assert out["lrt"]["statistic"] == pytest.approx(want["statistic"],
                                                    rel=1e-8, abs=1e-8)
    assert out["lrt"]["pvalue"] == pytest.approx(want["pvalue"], rel=1e-8)


def test_ancestral_posteriors_flow_through_hook(dna_case):
    jtree, tree, aln = dna_case
    kw = dict(branch_classes=mark_clade(tree, tree.leaf_names[:3]),
              class_params=[{"kappa": 2.0}, {"kappa": 8.0}], ncat=2)
    te = BranchModelEngine(tree, aln, models.HKY85, **T64, **kw)
    post = ancestral_posteriors(te)
    assert post.shape == (tree.n_nodes - tree.n_leaves, 150, 4)
    np.testing.assert_allclose(post.sum(axis=-1), 1.0, atol=1e-8)
    je = jbm.BranchModelEngine(jtree, aln, jmodels.HKY85, dtype="float64",
                               **kw)
    np.testing.assert_allclose(post, j_posteriors(je), rtol=0, atol=1e-9)


def test_flat_directions_follow_the_root_edges_classes(dna_case):
    """The root split is a flat direction only where both root edges carry
    one model stationary at the root frequencies."""
    _, tree, aln = dna_case
    names = [("branch_lengths",)]
    kids = list(tree.children[tree.root])

    def flats(cls, class_params):
        eng = BranchModelEngine(tree, aln, models.HKY85, cls, class_params,
                                **T64)
        return eng._flat_directions(names, None)

    same = np.zeros(tree.n_nodes, np.int32)
    split = same.copy()
    split[kids[0]] = 1
    (d,) = flats(same, [{"kappa": 2.0}, {"kappa": 3.0}])
    assert d[("branch_lengths",)][kids[0]] == 1.0
    assert d[("branch_lengths",)][kids[1]] == -1.0
    assert flats(split, [{"kappa": 2.0}, {"kappa": 3.0}]) == []
    both = same.copy()
    both[kids] = 1
    assert len(flats(both, [{"kappa": 2.0}, {"kappa": 3.0}])) == 1
    assert flats(both, [{"freqs": [0.25] * 4},
                        {"freqs": [0.4, 0.1, 0.2, 0.3]}]) == []


# -- the cases of tests/test_branch_models.py ---------------------------------


def test_identical_classes_equal_plain_engine(dna_case):
    _, tree, aln = dna_case
    plain = LikelihoodEngine(tree, aln, models.HKY85, ncat=4, **T64)
    be = BranchModelEngine(tree, aln, models.HKY85,
                           branch_classes=np.zeros(tree.n_nodes, np.int32),
                           class_params=[{"kappa": 2.0}, {"kappa": 2.0}],
                           ncat=4, **T64)
    assert be.loglikelihood() == pytest.approx(plain.loglikelihood(),
                                               abs=1e-9)


def test_free_ratio_identity_matches_plain(dna_case):
    _, tree, aln = dna_case
    plain = LikelihoodEngine(tree, aln, models.HKY85, ncat=4, **T64)
    fr = BranchModelEngine(tree, aln, models.HKY85,
                           branch_classes=free_ratio_classes(tree),
                           class_params=[{"kappa": 2.0}] * tree.n_nodes,
                           ncat=4, **T64)
    assert fr._paired
    assert fr.loglikelihood() == pytest.approx(plain.loglikelihood(),
                                               abs=1e-9)


def test_two_class_kappa_matches_oracle(dna_case):
    _, tree, aln = dna_case
    cls = mark_clade(tree, tree.leaf_names[:3])
    kappas = (2.0, 8.0)
    be = BranchModelEngine(tree, aln, models.HKY85, branch_classes=cls,
                           class_params=[{"kappa": k} for k in kappas],
                           ncat=4, **T64)
    node_models = [oracle.hky85(kappas[int(c)], np.full(4, 0.25))
                   for c in cls]
    expected = oracle.loglikelihood_branch_models(
        tree, aln, node_models,
        rates=np.asarray(oracle.discrete_gamma(0.5, 4)))
    assert be.loglikelihood() == pytest.approx(expected, abs=1e-8)


def test_two_ratio_codon_matches_oracle(codon_case):
    _, tree, aln, _ = codon_case
    cls = mark_branches(tree, tree.leaf_names[:2])
    omegas = (0.3, 2.5)
    ca = encode_codon_alignment(aln)
    be = BranchModelEngine(tree, ca, models.GY94, branch_classes=cls,
                           class_params=[{"omega": w} for w in omegas],
                           **T64)
    node_models = [oracle.gy94(2.0, omegas[int(c)]) for c in cls]
    expected = oracle.loglikelihood_branch_models(
        tree, aln, node_models, pattern_weights=np.asarray(ca.weights),
        leaf_partials=np.asarray(ca.partials, np.float64))
    assert be.loglikelihood() == pytest.approx(expected, abs=1e-7)


def test_mark_clade_marks_stem_and_inside(dna_case):
    _, tree, _ = dna_case
    internal = tree.n_leaves
    below, stack = [], [internal]
    while stack:
        x = stack.pop()
        if not tree.children[x]:
            below.append(x)
        stack.extend(tree.children[x])
    clade = [tree.names[i] for i in below]
    with_stem = mark_clade(tree, clade, include_stem=True)
    without = mark_clade(tree, clade, include_stem=False)
    assert with_stem.sum() == without.sum() + 1
    assert with_stem[internal] == 1 and without[internal] == 0
    leaf_ids = [tree.leaf_index()[n] for n in clade]
    assert sorted(i for i in range(tree.n_leaves)
                  if with_stem[i]) == sorted(leaf_ids)


def test_gradient_matches_finite_differences(dna_case):
    _, tree, aln = dna_case
    be = BranchModelEngine(tree, aln, models.HKY85,
                           branch_classes=mark_clade(tree,
                                                     tree.leaf_names[:3]),
                           class_params=[{"kappa": 2.0}, {"kappa": 6.0}],
                           **T64)
    kg = be.gradient()["classes"]["kappa"].numpy()
    eps = 1e-5
    for i in range(2):
        kp = np.array([2.0, 6.0])
        km = kp.copy()
        kp[i] += eps
        km[i] -= eps
        fd = (be.loglikelihood({"classes": {"kappa": kp}})
              - be.loglikelihood({"classes": {"kappa": km}})) / (2 * eps)
        assert kg[i] == pytest.approx(fd, rel=1e-5, abs=1e-7)


def test_branch_site_all_background_equals_site_mixture(codon_case):
    """With no foreground edge, Model A is a 4-class site mixture with
    omegas (w0, 1, w0, 1)."""
    _, tree, aln, _ = codon_case
    bs = BranchSiteAEngine(tree, aln,
                           foreground=np.zeros(tree.n_nodes, np.int32),
                           **T64)
    full = bs._full_params(None)
    w0 = float(full["omega0"])
    p0, p1, p2 = (full["proportions"] / full["proportions"].sum()).tolist()
    w = [p0, p1, p2 * p0 / (p0 + p1), p2 * p1 / (p0 + p1)]
    mm = ModelMixtureEngine(tree, aln, models.GY94,
                            mixture=[{"omega": w0}, {"omega": 1.0},
                                     {"omega": w0}, {"omega": 1.0}], **T64)
    assert bs.loglikelihood() == pytest.approx(
        mm.loglikelihood({"cat_weights": w}), abs=1e-8)


def test_branch_site_matches_oracle_mixture(codon_case):
    _, tree, aln, cls = codon_case
    ca = encode_codon_alignment(aln)
    bs = BranchSiteAEngine(tree, ca, foreground=cls, **T64)
    full = bs._full_params(None)
    w0 = float(full["omega0"])
    w2 = 1.0 + float(full["omega2_delta"])
    p0, p1, p2 = (full["proportions"] / full["proportions"].sum()).tolist()
    weights = [p0, p1, p2 * p0 / (p0 + p1), p2 * p1 / (p0 + p1)]
    sitewise = []
    for bg, fg in [(w0, w0), (1.0, 1.0), (w0, w2), (1.0, w2)]:
        node_models = [oracle.gy94(2.0, fg if cls[i] else bg)
                       for i in range(tree.n_nodes)]
        _, sw = oracle.loglikelihood_branch_models(
            tree, aln, node_models, return_sitewise=True,
            leaf_partials=np.asarray(ca.partials, np.float64))
        sitewise.append(sw)
    sitewise = np.stack(sitewise)
    m = sitewise.max(axis=0)
    mixed = np.log(np.sum(np.asarray(weights)[:, None]
                          * np.exp(sitewise - m[None, :]), axis=0)) + m
    expected = float((np.asarray(ca.weights) * mixed).sum())
    assert bs.loglikelihood() == pytest.approx(expected, abs=1e-7)


def test_branch_model_fit_recovers_class_difference(dna_case):
    _, tree, aln = dna_case
    be = BranchModelEngine(tree, aln, models.HKY85,
                           branch_classes=mark_clade(tree,
                                                     tree.leaf_names[:3]),
                           class_params=[{"kappa": 2.0}, {"kappa": 2.0}],
                           **T64)
    start = be.loglikelihood()
    res = fit(be, free=("classes",), max_steps=30)
    assert res.loglik > start
    kappa = be._full_params(res.params)["classes"]["kappa"]
    back = untransform_params(transform_params(be._full_params(res.params)))
    np.testing.assert_allclose(back["classes"]["kappa"].numpy(),
                               kappa.numpy(), rtol=1e-6)


def test_branch_site_transform_keys():
    params = {"omega0": torch.tensor(0.3),
              "proportions": torch.tensor([0.7, 0.2, 0.1]),
              "omega2_delta": torch.tensor(1.5)}
    back = untransform_params(transform_params(params))
    assert 0.0 < float(back["omega0"]) < 1.0
    assert float(back["omega0"]) == pytest.approx(0.3, rel=1e-6)
    np.testing.assert_allclose(back["proportions"].numpy(), [0.7, 0.2, 0.1],
                               rtol=1e-6)
    assert float(back["omega2_delta"]) == pytest.approx(1.5, rel=1e-6)


def test_simulate_branch_alignment_two_ratio_recovery():
    """Foreground omega 3 against background 0.15, simulated by the port:
    a two-ratio fit puts the classes on either side of 1."""
    tree = parse_newick("(((a:0.15,b:0.15):0.1,(c:0.15,d:0.15):0.1):0.08,"
                        "(e:0.25,f:0.25):0.08);")
    fg = mark_clade(tree, ["e", "f"])
    aln = simulate_branch_alignment(
        0, tree, models.GY94, fg,
        class_params=[{"omega": 0.15}, {"omega": 3.0}],
        shared={"kappa": 2.5}, n_sites=300, device="cpu")
    be = BranchModelEngine(tree, encode_codon_alignment(aln), models.GY94,
                           fg, class_params=[{"omega": 0.5}, {"omega": 1.0}],
                           **T64)
    res = fit(be, free=("branch_lengths", "classes", "shared"),
              max_steps=40, patience=10)
    om = res.params["classes"]["omega"].numpy()
    assert om[0] < 0.5 and om[1] > 1.5
