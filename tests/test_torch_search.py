"""Port parity, branch-length optimization and tree search
(``phylo_utils_tpu_torch.batched``): ``optimize_branch_lengths`` against the
JAX package's (logL to 1e-8 and branch lengths to 1e-6 relative),
``nni_hill_climb`` under "nni", "spr" and "both" against JAX's (the same
round count and topology, RF 0, logL to 1e-8 relative), and the port's
chunking (``test_chunk_boundaries.py``'s tolerances: chunked against
unchunked logL 1e-10, lengths 1e-8, sitewise 1e-10; an engine reused across
calls bit for bit a fresh one) and recovery of true topologies. One
intra-op thread: these are hundreds of small batched passes.
"""
import jax
import numpy as np
import pytest

from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu.batched import TopologySetEngine as JaxTSE
from phylo_utils_tpu.batched import nni_hill_climb as jax_hill_climb
from phylo_utils_tpu.batched import optimize_branch_lengths as jax_optimize
from phylo_utils_tpu.io import parse_newick as j_parse_newick
from phylo_utils_tpu.io import write_newick as j_write_newick
from phylo_utils_tpu.simulate import simulate_alignment
from phylo_utils_tpu_torch import models
from phylo_utils_tpu_torch.batched import (
    TopologySetEngine,
    chunked_brlen_optimize,
    nni_hill_climb,
    optimize_branch_lengths,
)
from phylo_utils_tpu_torch.io import parse_newick, write_newick
from phylo_utils_tpu_torch.trees import (
    nni_neighbors,
    random_tree,
    robinson_foulds,
)

from torch_threads import one_thread  # noqa: F401


def _jax_tree(tree):
    return j_parse_newick(write_newick(tree))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


@pytest.fixture(scope="module")
def setup():
    """``random_tree(8, seed=7)`` and 300 HKY85 sites simulated on it by the
    JAX package (``test_chunk_boundaries.py``'s data)."""
    tree = random_tree(8, seed=7)
    aln = simulate_alignment(jax.random.PRNGKey(3), _jax_tree(tree),
                             jmodels.HKY85, n_sites=300)
    return tree, aln


def test_optimize_branch_lengths_matches_jax(setup):
    """12 Adam steps of 5 candidates' branch lengths under HKY85+G2, in the
    softplus space from the trees' own lengths."""
    tree, aln = setup
    cands = [tree] + nni_neighbors(tree)[:4]
    port = TopologySetEngine(cands, aln, models.HKY85, ncat=2, device="cpu")
    ref = JaxTSE([_jax_tree(t) for t in cands], aln, jmodels.HKY85, ncat=2)
    params = {"model": {"kappa": 2.5}, "alpha": 0.7}
    lls, bls = optimize_branch_lengths(port, params=params, steps=12)
    jlls, jbls = jax_optimize(ref, params=params, steps=12)
    assert lls.shape == (5,) and bls.shape == (5, tree.n_nodes)
    assert _rel(lls, jlls) <= 1e-8
    keep = np.asarray(jbls) > 0
    assert _rel(bls[keep], np.asarray(jbls)[keep]) <= 1e-6
    # the optimizer raised every candidate's logL
    assert (lls > port.loglikelihoods(params)).all()


def test_chunked_brlen_matches_unchunked(setup):
    """chunk 2 over 5 candidates: chunks of [2, 2, 1 + 1 pad]."""
    tree, aln = setup
    cands = [tree] + nni_neighbors(tree)[:4]
    kw = dict(ncat=2, steps=12, device="cpu")
    lls_c, bls_c, sw_c, _ = chunked_brlen_optimize(
        cands, aln, models.HKY85, batch_chunk=2, **kw)
    lls_u, bls_u, sw_u, _ = chunked_brlen_optimize(
        cands, aln, models.HKY85, batch_chunk=None, **kw)
    assert lls_c.shape == (5,) and sw_c.shape == (5, 300)
    np.testing.assert_allclose(lls_c, lls_u, rtol=1e-10)
    np.testing.assert_allclose(bls_c, bls_u, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(sw_c, sw_u, rtol=1e-10)


def test_chunked_engine_reuse_is_exact(setup):
    """A second call reusing the engine (swapped schedules) matches a fresh
    engine bit for bit, and leaves the first set's scores unchanged."""
    tree, aln = setup
    nbrs = nni_neighbors(tree)
    set_a = [tree] + nbrs[:3]
    set_b = [nbrs[4]] + nbrs[5:8]
    kw = dict(steps=10, batch_chunk=4, device="cpu")
    lls_a, _, _, eng = chunked_brlen_optimize(set_a, aln, models.HKY85, **kw)
    lls_b_reused, _, _, _ = chunked_brlen_optimize(
        set_b, aln, models.HKY85, engine=eng, **kw)
    lls_b_fresh, _, _, _ = chunked_brlen_optimize(set_b, aln, models.HKY85,
                                                  **kw)
    np.testing.assert_array_equal(lls_b_reused, lls_b_fresh)
    lls_a2, _, _, _ = chunked_brlen_optimize(set_a, aln, models.HKY85,
                                             engine=eng, **kw)
    np.testing.assert_array_equal(lls_a, lls_a2)


@pytest.mark.parametrize("moves", ["nni", "spr", "both"])
def test_nni_hill_climb_matches_jax(setup, moves):
    """From one NNI away: JAX's round count and topology (RF 0), logL to
    1e-8 relative; SPR neighborhoods drawn with ``seed=round``."""
    tree, aln = setup
    start = nni_neighbors(tree)[0]
    kw = dict(brlen_steps=15, max_rounds=3, moves=moves, spr_max_targets=2)
    got_t, got_ll, got_r = nni_hill_climb(start, aln, models.HKY85,
                                          device="cpu", **kw)
    want_t, want_ll, want_r = jax_hill_climb(_jax_tree(start), aln,
                                             jmodels.HKY85, **kw)
    assert got_r == want_r
    assert robinson_foulds(got_t, parse_newick(j_write_newick(want_t))) == 0.0
    assert abs(got_ll - want_ll) <= 1e-8 * abs(want_ll)


def test_nni_hill_climb_chunked_matches_unchunked(setup):
    tree, aln = setup
    start = nni_neighbors(tree)[0]
    kw = dict(brlen_steps=15, max_rounds=3, device="cpu")
    t_c, ll_c, r_c = nni_hill_climb(start, aln, models.HKY85,
                                    batch_topologies=3, **kw)
    t_u, ll_u, r_u = nni_hill_climb(start, aln, models.HKY85,
                                    batch_topologies=None, **kw)
    assert r_c == r_u
    assert abs(ll_c - ll_u) < 1e-8
    assert robinson_foulds(t_c, t_u) == 0.0


@pytest.mark.parametrize("k", [0, 3, 7])
def test_hill_climb_recovers_the_true_topology(k):
    """From the k-th NNI neighbor of the generating tree (6 taxa, 1200 JC69
    sites simulated by the JAX package) the search returns to it."""
    truth = random_tree(6, seed=11, mean_brlen=0.25)
    aln = simulate_alignment(jax.random.key(2), _jax_tree(truth),
                             jmodels.JC69, 1200)
    start = nni_neighbors(truth)[k]
    assert robinson_foulds(start, truth) > 0
    best, ll, rounds = nni_hill_climb(start, aln, models.JC69, max_rounds=5,
                                      brlen_steps=40, device="cpu")
    assert robinson_foulds(best, truth) == 0.0
    assert rounds >= 2 and np.isfinite(ll)


def test_nni_covers_root_edge():
    """With a bifurcating root, NNI across the fused root edge fixes a
    start tree that is wrong only there (the JAX package's regression)."""
    truth = parse_newick(
        "((a:0.15,b:0.15):0.15,((c:0.15,d:0.15):0.15,e:0.3):0.05);")
    for n in nni_neighbors(truth):
        assert robinson_foulds(truth, n) > 0
    start = parse_newick(
        "((a:0.15,c:0.15):0.15,((b:0.15,d:0.15):0.15,e:0.3):0.05);")
    aln = simulate_alignment(jax.random.key(8), _jax_tree(truth),
                             jmodels.HKY85, 500, params={"kappa": 3.0})
    best, _, _ = nni_hill_climb(start, aln, models.HKY85, max_rounds=4,
                                device="cpu")
    assert robinson_foulds(best, truth) == 0.0


def test_unknown_moves_refused(setup):
    tree, aln = setup
    with pytest.raises(ValueError, match="unknown moves"):
        nni_hill_climb(tree, aln, models.HKY85, moves="tbr", device="cpu")
