"""Port parity, branch supports (``phylo_utils_tpu_torch.supports``) against
the JAX package's on the same trees and alignments.

``alrt_supports`` fits the base tree's branch lengths with each package's
own L-BFGS, then re-optimizes every NNI alternative by Adam. Adam's first
step is lr x the sign of each gradient entry, and at a fitted start the
shared branches' entries are ~0, so a 2e-7 difference between the two
fits' lengths moves ``stat`` by ~3e-4 after 15 steps. The parity case
therefore gives both packages the same fitted lengths (each ``fit``
replaced by one that returns them) and holds the rest to the tolerances
below: equal edges, ``stat`` within 1e-6 absolute, ``alrt`` and ``abayes``
within 1e-8, ``sh_alrt`` equal. The unpinned run is held to JAX's edges,
base logL (1e-9 relative) and ``sh_alrt``.
``bootstrap_tree_support``: supports, TBE and the consensus (RF 0) equal;
``site_concordance`` and ``gene_concordance`` equal; the JAX package's
TBE, sCF and consensus tests mirrored as parametrised cases.
"""
import types

import jax
import numpy as np
import pytest
import torch

import phylo_utils_tpu.optimize as jax_optimize
import phylo_utils_tpu.supports as jsup
import phylo_utils_tpu_torch.optimize as port_optimize
import phylo_utils_tpu_torch.supports as sup
from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu.io import parse_newick as j_parse_newick
from phylo_utils_tpu.io import write_newick as j_write_newick
from phylo_utils_tpu.simulate import simulate_alignment
from phylo_utils_tpu_torch import models
from phylo_utils_tpu_torch.io import parse_newick, write_newick
from phylo_utils_tpu_torch.trees import (
    _splits,
    branch_score_distance,
    majority_rule_consensus,
    nni_neighbors,
    random_tree,
    reroot,
    robinson_foulds,
)

from torch_threads import one_thread  # noqa: F401


def _jax_tree(tree):
    return j_parse_newick(write_newick(tree))


def _port_tree(jax_tree):
    return parse_newick(j_write_newick(jax_tree))


@pytest.fixture(scope="module")
def setup():
    """An unrooted ``random_tree(8, seed=7)`` and 300 HKY85 sites simulated
    on it by the JAX package."""
    tree = random_tree(8, seed=7, rooted=False)
    aln = simulate_alignment(jax.random.PRNGKey(3), _jax_tree(tree),
                             jmodels.HKY85, n_sites=300)
    return tree, aln


def _pinned_fit(lengths, to_port):
    """A ``fit`` that returns ``lengths`` as the fitted branch lengths."""
    def fit(engine, params0=None, **_):
        full = engine._full_params(params0)
        full["branch_lengths"] = (
            torch.tensor(lengths, dtype=engine.dtype, device=engine.device)
            if to_port else np.asarray(lengths))
        return types.SimpleNamespace(params=full,
                                     loglik=engine.loglikelihood(full))
    return fit


def test_alrt_supports_match_jax(setup, monkeypatch):
    tree, aln = setup
    kw = dict(ncat=1, brlen_steps=15, n_boot=60, seed=11)
    want_free = jsup.alrt_supports(_jax_tree(tree), aln, jmodels.HKY85, **kw)
    got_free = sup.alrt_supports(tree, aln, models.HKY85, device="cpu", **kw)
    assert got_free["edges"] == want_free["edges"]
    assert len(got_free["edges"]) == 5                # n - 3 for 8 taxa
    assert abs(got_free["loglik"] - want_free["loglik"]) <= \
        1e-9 * abs(want_free["loglik"])
    np.testing.assert_array_equal(got_free["sh_alrt"], want_free["sh_alrt"])

    lengths = np.asarray(want_free["tree"].lengths)
    monkeypatch.setattr(jax_optimize, "fit", _pinned_fit(lengths, False))
    monkeypatch.setattr(port_optimize, "fit", _pinned_fit(lengths, True))
    want = jsup.alrt_supports(_jax_tree(tree), aln, jmodels.HKY85, **kw)
    got = sup.alrt_supports(tree, aln, models.HKY85, device="cpu", **kw)
    assert got["edges"] == want["edges"]
    np.testing.assert_allclose(got["stat"], want["stat"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["alrt"], want["alrt"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(got["abayes"], want["abayes"], rtol=0,
                               atol=1e-8)
    np.testing.assert_array_equal(got["sh_alrt"], want["sh_alrt"])
    np.testing.assert_allclose(got["tree"].lengths, lengths, rtol=1e-15)


def test_alrt_chunked_matches_unchunked(setup):
    tree, aln = setup
    kw = dict(ncat=1, brlen_steps=15, n_boot=60, seed=11, device="cpu")
    small = sup.alrt_supports(tree, aln, models.HKY85, batch_topologies=2,
                              **kw)
    full = sup.alrt_supports(tree, aln, models.HKY85, batch_topologies=None,
                             **kw)
    assert small["edges"] == full["edges"]
    np.testing.assert_allclose(small["stat"], full["stat"], rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(small["alrt"], full["alrt"], rtol=1e-8,
                               atol=1e-10)


def test_alrt_strong_and_weak_edges():
    """Strong edges get ~1.0, the 0.002 edge low support; aBayes in [0, 1]
    (the JAX package's test_alrt_supports)."""
    tree = parse_newick(
        "(((a:0.2,b:0.2):0.002,(c:0.2,d:0.2):0.2):0.1,(e:0.3,f:0.3):0.1);")
    aln = simulate_alignment(jax.random.key(5), _jax_tree(tree),
                             jmodels.HKY85, 800, params={"kappa": 3.0})
    out = sup.alrt_supports(tree, aln, models.HKY85, n_boot=400,
                            device="cpu")
    assert len(out["edges"]) == 3
    stats = dict(zip(out["edges"], out["stat"]))
    weak = min(stats, key=stats.get)
    assert stats[weak] < 2.0
    for e, a, s in zip(out["edges"], out["alrt"], out["sh_alrt"]):
        if e != weak:
            assert a > 0.99 and s > 0.95, (e, a, s)
    assert ((out["abayes"] >= 0) & (out["abayes"] <= 1)).all()


@pytest.mark.parametrize("model,reps,chunk", [("JC69", 7, 3),
                                              ("HKY85", 12, None)])
def test_bootstrap_tree_support_matches_jax(setup, model, reps, chunk):
    """Replicates drawn over the patterns in first-site order (JAX's), the
    (replicate x pair) Newton in chunks: supports, TBE and the consensus
    equal to JAX's."""
    tree, aln = setup
    params = {"kappa": 2.0} if model == "HKY85" else None
    kw = dict(n_reps=reps, seed=5, consensus=True, tbe=True, params=params,
              rep_chunk=chunk)
    got = sup.bootstrap_tree_support(tree, aln, getattr(models, model),
                                     device="cpu", **kw)
    want = jsup.bootstrap_tree_support(_jax_tree(tree), aln,
                                       getattr(jmodels, model), **kw)
    assert got["n_reps"] == want["n_reps"] == reps
    assert got["edges"] == want["edges"]
    np.testing.assert_array_equal(got["support"], want["support"])
    np.testing.assert_array_equal(got["tbe"], want["tbe"])
    assert robinson_foulds(got["consensus"],
                           _port_tree(want["consensus"])) == 0.0


def test_bootstrap_rep_chunk_is_exact(setup):
    """7 replicates in chunks of 3 give the single chunk's supports."""
    tree, aln = setup
    kw = dict(n_reps=7, seed=5, device="cpu")
    chunked = sup.bootstrap_tree_support(tree, aln, models.JC69,
                                         rep_chunk=3, **kw)
    whole = sup.bootstrap_tree_support(tree, aln, models.JC69, rep_chunk=7,
                                       **kw)
    assert chunked["edges"] == whole["edges"]
    np.testing.assert_array_equal(chunked["support"], whole["support"])


def _scf_inputs(name):
    if name == "clean":
        tree = random_tree(10, seed=5, mean_brlen=0.05)
        aln = simulate_alignment(jax.random.key(3), _jax_tree(tree),
                                 jmodels.JC69, 600)
    elif name == "noise":
        tree = random_tree(10, seed=5, mean_brlen=0.05)
        rng = np.random.default_rng(0)
        aln = {n: "".join(rng.choice(list("ACGT"), size=600))
               for n in tree.leaf_names}
    elif name == "protein_gaps":
        tree = random_tree(8, seed=2, mean_brlen=0.2)
        aln = simulate_alignment(jax.random.key(5), _jax_tree(tree),
                                 jmodels.LG, 200)
        aln = {k: ("-" + v[1:-1] + "X") for k, v in aln.items()}
    else:                                   # a trifurcating root
        tree = parse_newick(
            "((a:1,b:1):1,(c:1,d:1):1,((e:1,f:1):1,(g:1,h:1):1):1);")
        aln = {n: "ACGTACGTACGTACGT" for n in "abcdefgh"}
    return tree, aln


@pytest.mark.parametrize("name", ["clean", "noise", "protein_gaps",
                                  "trifurcating"])
def test_site_concordance_matches_jax(name):
    tree, aln = _scf_inputs(name)
    got = sup.site_concordance(tree, aln, n_quartets=40, seed=1)
    want = jsup.site_concordance(_jax_tree(tree), aln, n_quartets=40, seed=1)
    assert got["edges"] == want["edges"]
    for key in ("scf", "sdf1", "sdf2", "n_decisive"):
        np.testing.assert_array_equal(got[key], want[key])
    if name in ("clean", "noise"):
        np.testing.assert_allclose(got["scf"] + got["sdf1"] + got["sdf2"],
                                   100.0, atol=1e-9)
    if name == "trifurcating":
        assert set(got["edges"]) >= set(sup.nni_alternatives_by_edge(tree))


def _gcf_cases():
    ref = parse_newick("(((a:1,b:1):1,(c:1,d:1):1):1,((e:1,f:1):1,g:1):1);")
    sub = parse_newick("(((a:1,b:1):1,(c:1,d:1):1):1,e:1);")
    return ref, {"unanimous": [ref, ref, ref],
                 "one_conflict": [ref, ref, nni_neighbors(ref)[0]],
                 "missing_taxa": [ref, sub]}


@pytest.mark.parametrize("name", ["unanimous", "one_conflict",
                                  "missing_taxa"])
def test_gene_concordance_matches_jax(name):
    ref, cases = _gcf_cases()
    genes = cases[name]
    got = sup.gene_concordance(ref, genes)
    want = jsup.gene_concordance(_jax_tree(ref),
                                 [_jax_tree(g) for g in genes])
    assert got["edges"] == want["edges"]
    np.testing.assert_array_equal(got["gcf"], want["gcf"])
    np.testing.assert_array_equal(got["n_informative"],
                                  want["n_informative"])
    if name == "unanimous":
        np.testing.assert_allclose(got["gcf"], 100.0)


def _tbe_case(name):
    if name == "identical":
        t = random_tree(10, seed=4)
        return t, [t, t, t]
    if name == "nni":
        t = random_tree(12, seed=7)
        return t, [t] * 3 + nni_neighbors(t)[:5]
    t = parse_newick(
        "(((a:1,b:1):1,(c:1,d:1):1):1,((e:1,f:1):1,(g:1,h:1):1):1);")
    t2 = parse_newick(
        "(((a:1,h:1):1,(c:1,f:1):1):1,((e:1,d:1):1,(g:1,b:1):1):1);")
    return t, [t2]


@pytest.mark.parametrize("name", ["identical", "nni", "contradicting"])
def test_transfer_bootstrap_matches_jax(name):
    """JAX's TBE on the same replicates; full support on identical
    replicates, TBE >= the Felsenstein proportion, the floor on
    contradicting ones."""
    t, reps = _tbe_case(name)
    got = sup.transfer_bootstrap_supports(t, reps)
    want = jsup.transfer_bootstrap_supports(_jax_tree(t),
                                            [_jax_tree(r) for r in reps])
    assert got["edges"] == want["edges"] and got["n_reps"] == len(reps)
    np.testing.assert_array_equal(got["support"], want["support"])
    if name == "identical":
        np.testing.assert_allclose(got["support"], 1.0)
    elif name == "contradicting":
        assert ((got["support"] < 1.0) & (got["support"] >= 0.0)).all()
    else:
        leaf_index = {n: i for i, n in enumerate(sorted(t.leaf_names))}
        ind, _ = sup._edge_indicators(t, leaf_index)
        rk = t.children[t.root]
        edge_ids = sup._edge_indicators(t, leaf_index)[1]
        keep = [i for i, e in enumerate(edge_ids) if e != max(rk)]
        leafset, anchor = set(t.leaf_names), min(t.leaf_names)

        def canon(vec):
            names = {nm for nm, i in leaf_index.items() if vec[i]}
            return frozenset(names if anchor not in names
                             else leafset - names)

        rep_splits = [_splits(r) for r in reps]
        fbp = np.array([np.mean([canon(ind[i]) in rs for rs in rep_splits])
                        for i in keep])
        assert (got["support"] >= fbp - 1e-12).all()


def test_transfer_bootstrap_rejects_taxon_mismatch():
    with pytest.raises(ValueError, match="taxon set"):
        sup.transfer_bootstrap_supports(random_tree(6, seed=1),
                                        [random_tree(7, seed=1)])


@pytest.mark.parametrize("name", ["identical", "majority", "polytomy",
                                  "low_min_freq", "bsd"])
def test_consensus_cases(name):
    """The JAX package's consensus and branch-score tests, on the port's
    ``trees`` (which ``bootstrap_tree_support(consensus=True)`` calls)."""
    t = random_tree(8, seed=3)
    if name == "identical":
        cons = majority_rule_consensus([t, t, t])
        assert robinson_foulds(cons, t) == 0.0
    elif name == "majority":
        alt = nni_neighbors(t)[0]
        cons = majority_rule_consensus([t, t, alt])
        assert _splits(t) <= _splits(cons) | _splits(alt)
        assert robinson_foulds(cons, t) == 0.0
    elif name == "polytomy":
        ts = [parse_newick(s) for s in (
            "((a:1,b:1):1,(c:1,d:1):1);", "((a:1,c:1):1,(b:1,d:1):1);",
            "((a:1,d:1):1,(b:1,c:1):1);")]
        cons = majority_rule_consensus(ts)
        assert len(_splits(cons)) == 0 and cons.n_leaves == 4
    elif name == "low_min_freq":
        with pytest.raises(ValueError):
            majority_rule_consensus([t], min_freq=0.3)
    else:
        assert branch_score_distance(t, t) == 0.0
        assert branch_score_distance(t, reroot(t, 2)) == pytest.approx(
            0.0, abs=1e-12)
