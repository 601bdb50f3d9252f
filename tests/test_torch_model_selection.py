"""Port parity, model selection: ``count_free_parameters``,
``likelihood_ratio_test``, ``compare_models`` and
``unconstrained_loglikelihood`` in the PyTorch port against the JAX
package's ``model_selection``, and ``goldman_cox_test`` by behaviour
(``tests/test_model_selection.py``'s case), on 6-taxon alignments simulated
by the port.

Tolerances: parameter counts, LRT dicts and criteria names equal; the
unconstrained logL 1e-12 relative (the same weights, summed in another
pattern order); ``compare_models``'s fits run another optimizer in each
package (torch L-BFGS, optax L-BFGS), and the JAX package's builds its
engines at its default float32 where the port's default is float64, so
they are held to one ranking and, per candidate, logL and the criteria to
1e-6 relative (the f32 logL bound). The Goldman-Cox replicates
are simulated by the port (no stream parity with ``jax.random``), so that
test holds the JAX test's verdicts, not its numbers. One intra-op thread.
"""
import numpy as np
import pytest

from phylo_utils_tpu import mixtures as jmix
from phylo_utils_tpu import model_selection as jms
from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu.io import parse_newick as j_parse_newick
from phylo_utils_tpu.likelihood import LikelihoodEngine as JaxEngine
from phylo_utils_tpu_torch import mixtures as tmix
from phylo_utils_tpu_torch import model_selection as tms
from phylo_utils_tpu_torch import models
from phylo_utils_tpu_torch.io import write_newick
from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
from phylo_utils_tpu_torch.optimize import fit
from phylo_utils_tpu_torch.simulate import simulate_alignment
from phylo_utils_tpu_torch.trees import random_tree

from torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def k80_data():
    """400 sites simulated by the port under K80 (kappa 8) on a 6-taxon
    tree, and the tree in both packages."""
    tree = random_tree(6, seed=1, mean_brlen=0.2)
    aln = simulate_alignment(1, tree, models.K80, 400,
                             params={"kappa": 8.0}, device="cpu")
    return tree, j_parse_newick(write_newick(tree)), aln


def test_count_free_parameters_equals_jax(k80_data):
    tree, jtree, aln = k80_data
    got = LikelihoodEngine(tree, aln, models.GTR, ncat=4,
                           invariant_sites=True, device="cpu")
    want = JaxEngine(jtree, aln, jmodels.GTR, ncat=4, invariant_sites=True)
    n_edges = tree.n_nodes - 1
    assert tms.count_free_parameters(got) == \
        jms.count_free_parameters(want) == 8 + n_edges + 1 + 1
    assert tms.count_free_parameters(LikelihoodEngine(
        tree, aln, models.JC69, device="cpu")) == n_edges
    codon = {n: "ATGGCTAAA" * 4 for n in tree.leaf_names}
    for name, kw in (("M2a", {}), ("M8", {"ncat": 4})):
        got = getattr(tmix, f"{name}Engine")(tree, codon, device="cpu", **kw)
        want = getattr(jmix, f"{name}Engine")(jtree, codon, **kw)
        assert tms.count_free_parameters(got) == \
            jms.count_free_parameters(want), name


@pytest.mark.parametrize("ll0,ll1,df", [(-1010.0, -1000.0, 1),
                                        (-1000.0, -1000.0, 2),
                                        (-250.5, -251.0, 2),
                                        (-88.0, -80.5, 3)])
def test_likelihood_ratio_test_equals_jax(ll0, ll1, df):
    got = tms.likelihood_ratio_test(ll0, ll1, df=df)
    assert got == jms.likelihood_ratio_test(ll0, ll1, df=df)
    assert set(got) == {"statistic", "df", "pvalue"}


def test_unconstrained_loglikelihood_equals_jax(k80_data):
    tree, jtree, aln = k80_data
    got = tms.unconstrained_loglikelihood(
        LikelihoodEngine(tree, aln, models.JC69, device="cpu"))
    want = jms.unconstrained_loglikelihood(JaxEngine(jtree, aln,
                                                     jmodels.JC69))
    assert got == pytest.approx(want, rel=1e-12)


def test_compare_models_matches_jax(k80_data):
    """Kappa-8 data: JC69 ranks last under BIC in both packages, each
    candidate's fit reaches the JAX fit's logL, and the rankings agree."""
    tree, jtree, aln = k80_data
    cands = ["JC69", "K80", "HKY85"]
    got = tms.compare_models(tree, aln, candidates=cands, max_steps=80,
                             patience=15, device="cpu")
    want = jms.compare_models(jtree, aln, candidates=cands, max_steps=80,
                              patience=15)
    assert [f.name for f in got] == [f.name for f in want]
    assert got[-1].name == "JC69"
    by_name = {f.name: f for f in want}
    for f in got:
        ref = by_name[f.name]
        assert (f.k, f.n) == (ref.k, ref.n)
        for crit in ("loglik", "aic", "aicc", "bic"):
            assert getattr(f, crit) == pytest.approx(getattr(ref, crit),
                                                     rel=1e-6), (f.name, crit)
        assert set(f.as_dict()) == set(ref.as_dict())
        assert set(f.params) == set(ref.params)


def test_fit_of_a_parameter_free_model_keeps_its_empty_model_dict(
        k80_data):
    """``fit`` with every parameter free on JC69 (whose ``model`` dict is
    empty) returns params with that empty dict, as the JAX package's pytree
    does; it raised KeyError('model') before, so ``compare_models`` could
    not fit its first default candidate."""
    tree, _, aln = k80_data
    eng = LikelihoodEngine(tree, aln, models.JC69, device="cpu")
    res = fit(eng, max_steps=5)
    assert res.params["model"] == {}
    assert np.isfinite(res.loglik) and res.loglik >= eng.loglikelihood()


def test_goldman_cox_adequacy():
    """The generating model family is not rejected; JC69 on strongly
    rate-heterogeneous HKY85 data is (10 replicates each, as the JAX
    package's test)."""
    tree = random_tree(6, seed=3, mean_brlen=0.2)
    aln = simulate_alignment(2, tree, models.HKY85, 400,
                             params={"kappa": 3.0}, device="cpu")
    eng = LikelihoodEngine(tree, aln, models.HKY85, device="cpu")
    mle = fit(eng, max_steps=200)
    res = tms.goldman_cox_test(eng, mle.params, n_replicates=10, refit=True,
                               max_steps=120, seed=1)
    assert res["unconstrained"] >= res["loglik"]
    assert res["null_deltas"].shape == (10,)
    assert res["pvalue"] > 0.1

    aln2 = simulate_alignment(4, tree, models.HKY85, 800,
                              params={"kappa": 3.0, "alpha": 0.2}, ncat=4,
                              device="cpu")
    eng2 = LikelihoodEngine(tree, aln2, models.JC69, device="cpu")
    mle2 = fit(eng2, max_steps=150)
    res2 = tms.goldman_cox_test(eng2, mle2.params, n_replicates=10,
                                refit=False, seed=1)
    assert res2["pvalue"] <= 0.1
    assert res2["delta"] > res["delta"]
    with pytest.raises(ValueError, match="goldman_cox_test"):
        tms.goldman_cox_test(tmix.M2aEngine(
            tree, {n: "ATGGCT" for n in tree.leaf_names}, device="cpu"))
