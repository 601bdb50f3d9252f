"""Port parity, topology sets (``phylo_utils_tpu_torch.batched``):
``pad_schedules`` and ``choose_regroup_width`` against the JAX package's
(equal arrays, equal widths), and ``TopologySetEngine`` against JAX's
engine on the same candidate trees and alignment: logL and sitewise logL
to 1e-10 relative and gradients to 1e-8 relative in float64, the float32
port to 1e-6 of the float64 port; plus the port's own properties (the trash
row is never read, ``set_candidates`` reuse equals a fresh engine, the
regrouped walk equals the level grid).
"""
import numpy as np
import pytest
import torch

from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu.batched import TopologySetEngine as JaxTSE
from phylo_utils_tpu.batched import choose_regroup_width as jax_choose
from phylo_utils_tpu.batched import pad_schedules as jax_pad
from phylo_utils_tpu.io import parse_newick as j_parse_newick
from phylo_utils_tpu.trees import compile_schedule as j_compile
from phylo_utils_tpu_torch import models
from phylo_utils_tpu_torch.batched import (
    TopologySetEngine,
    choose_regroup_width,
    pad_schedules,
)
from phylo_utils_tpu_torch.io import parse_newick, write_newick
from phylo_utils_tpu_torch.trees import (
    compile_schedule,
    nni_neighbors,
    random_tree,
    regroup_schedule,
    schedule_fill,
    spr_neighbors,
)

from torch_threads import one_thread  # noqa: F401


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-300))


def _jax_trees(trees):
    return [j_parse_newick(write_newick(t)) for t in trees]


def _caterpillar(n):
    nwk = "(a:1,b:1)"
    for i in range(n - 2):
        nwk = f"({nwk}:1,t{i}:1)"
    return parse_newick(nwk + ";")


def _sets():
    """Candidate sets by name: an NNI neighborhood (16 and 64 taxa), an SPR
    neighborhood, an unrooted tree's NNI set and a caterpillar."""
    t16 = random_tree(16, seed=3)
    t64 = random_tree(64, seed=0)
    un = random_tree(12, seed=4, rooted=False)
    return {
        "nni16": [t16] + nni_neighbors(t16),
        "nni64": [t64] + nni_neighbors(t64),
        "spr16": [t16] + spr_neighbors(t16, max_targets=3, seed=1),
        "unrooted12": [un] + nni_neighbors(un),
        "caterpillar": [_caterpillar(11)],
    }


@pytest.mark.parametrize("name", ["nni16", "nni64", "spr16", "unrooted12",
                                  "caterpillar"])
def test_regroup_width_and_padding_match_jax(name):
    """The same width (0 on the caterpillar, as JAX keeps it) and the same
    padded arrays, with and without a pinned minimum shape."""
    trees = _sets()[name]
    u, rg = choose_regroup_width([compile_schedule(t) for t in trees])
    ju, jrg = jax_choose([j_compile(t) for t in _jax_trees(trees)])
    assert u == ju
    if name == "caterpillar":
        assert u == 0
    for pad_to in (None, (40, 20, 3)):
        got = pad_schedules(rg, pad_to=pad_to)
        want = jax_pad(jrg, pad_to=pad_to)
        for key in ("nodes", "children", "mask"):
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def test_fill_factor_improves_on_nni_sets():
    """The regrouped grid packs a 64-taxon NNI set's padded slots at least
    1.5x fuller than the height-level grid (the JAX package's r5 gate)."""
    scheds = [compile_schedule(t) for t in _sets()["nni64"]]
    fill0 = schedule_fill(scheds)
    u, rg = choose_regroup_width(scheds)
    fill1 = schedule_fill(rg)
    assert fill0 < 0.35 and u > 0
    assert fill1 >= 0.4 and fill1 > fill0 * 1.5, (u, fill0, fill1)


@pytest.fixture(scope="module")
def tree_set():
    """6 random 8-taxon topologies over the same taxa (leaf-id order
    differs per topology: the per-tree leaf permutation handles it) x 120
    random sites, as the JAX package's test_batched.py."""
    trees = [random_tree(8, seed=s) for s in range(6)]
    rng = np.random.default_rng(9)
    aln = {n: "".join(rng.choice(list("ACGT"), size=120))
           for n in trees[0].leaf_names}
    return trees, aln


@pytest.fixture(scope="module")
def gtr_pair(tree_set):
    """(port engine, JAX engine) under GTR+G4, built once."""
    trees, aln = tree_set
    return (TopologySetEngine(trees, aln, models.GTR, ncat=4, device="cpu"),
            JaxTSE(_jax_trees(trees), aln, jmodels.GTR, ncat=4))


def test_loglik_and_sitewise_match_jax(gtr_pair):
    port, ref = gtr_pair
    assert _rel(port.loglikelihoods(), ref.loglikelihoods()) <= 1e-10
    sw, jsw = port.sitewise_loglikelihoods(), ref.sitewise_loglikelihoods()
    assert sw.shape == jsw.shape == (6, 120)
    assert np.max(np.abs(sw - jsw) / np.abs(jsw)) <= 1e-10
    assert port.best() == ref.best()


def test_gradients_match_jax(gtr_pair):
    """Every leaf of the gradient of the summed logL, branch lengths as
    (B, n_nodes), to 1e-8 relative of its largest entry."""
    port, ref = gtr_pair
    got, want = port.gradients(), ref.gradients()
    assert got["branch_lengths"].shape == (6, port.trees[0].n_nodes)
    assert _rel(got["branch_lengths"], want["branch_lengths"]) <= 1e-8
    for key in want["model"]:
        assert _rel(got["model"][key], want["model"][key]) <= 1e-8, key
    assert _rel(got["alpha"], want["alpha"]) <= 1e-8


def test_param_override_matches_jax(tree_set):
    """Doubled branch lengths and kappa 4 through the params dict change
    the scores as in JAX (1e-10 relative)."""
    trees, aln = tree_set
    port = TopologySetEngine(trees, aln, models.K80, device="cpu")
    ref = JaxTSE(_jax_trees(trees), aln, jmodels.K80)
    base = port.loglikelihoods()
    over = {"branch_lengths": 2.0 * np.stack([t.lengths for t in trees]),
            "model": {"kappa": 4.0}}
    scaled = port.loglikelihoods(over)
    assert not np.allclose(base, scaled)
    assert _rel(scaled, ref.loglikelihoods(over)) <= 1e-10
    with pytest.raises(ValueError, match="kapa"):
        port.loglikelihoods({"model": {"kapa": 4.0}})


def test_mixed_taxa_refused():
    with pytest.raises(ValueError, match="same taxon count"):
        pad_schedules([compile_schedule(random_tree(4, seed=0)),
                       compile_schedule(random_tree(5, seed=0))])
    aln = {f"t{i}": "ACGT" for i in range(5)}
    with pytest.raises(ValueError, match="same taxon count"):
        TopologySetEngine([random_tree(4, seed=0), random_tree(5, seed=0)],
                          aln, models.JC69, device="cpu")


def test_set_candidates_reuse_equals_fresh(tree_set):
    """A swapped-in set scores as a fresh engine does, bit for bit: the pad
    dims only grow, the regroup width stays the first set's, and each
    tree's leaf permutation is its own."""
    trees, aln = tree_set
    big = random_tree(8, seed=11)
    set_a, set_b = trees[:3], [big] + nni_neighbors(big)[:2]
    eng = TopologySetEngine(set_a, aln, models.HKY85, ncat=2, device="cpu")
    u, dims = eng._regroup_u, eng._pad_dims
    eng.set_candidates(set_b)
    assert eng._regroup_u == u
    assert all(a >= b for a, b in zip(eng._pad_dims, dims))
    fresh = TopologySetEngine(set_b, aln, models.HKY85, ncat=2,
                              regroup=u, pad_to=eng._pad_dims, device="cpu")
    np.testing.assert_array_equal(eng.loglikelihoods(),
                                  fresh.loglikelihoods())
    eng.set_candidates(set_a)
    np.testing.assert_array_equal(
        eng.loglikelihoods(),
        TopologySetEngine(set_a, aln, models.HKY85, ncat=2, regroup=u,
                          pad_to=eng._pad_dims,
                          device="cpu").loglikelihoods())


def test_regrouped_equals_level_grid():
    """The regrouped walk scores and differentiates as the height-level
    grid does: logL to 1e-10, gradients to 1e-8 relative."""
    tree = random_tree(12, seed=5)
    rng = np.random.default_rng(2)
    aln = {n: "".join(rng.choice(list("ACGT"), size=150))
           for n in tree.leaf_names}
    cands = [tree] + nni_neighbors(tree)[:6]
    level = TopologySetEngine(cands, aln, models.HKY85, ncat=2, regroup=0,
                              device="cpu")
    auto = TopologySetEngine(cands, aln, models.HKY85, ncat=2,
                             regroup="auto", device="cpu")
    assert auto._regroup_u > 0 and level._regroup_u == 0
    assert _rel(auto.loglikelihoods(), level.loglikelihoods()) <= 1e-10
    ga, gl = auto.gradients(), level.gradients()
    assert _rel(ga["branch_lengths"], gl["branch_lengths"]) <= 1e-8
    for key in gl["model"]:
        assert _rel(ga["model"][key], gl["model"][key]) <= 1e-8


@pytest.mark.parametrize("name", ["nni16", "spr16", "unrooted12",
                                  "caterpillar"])
def test_trash_row_is_never_read(name):
    """Padding slots all write the trash row (duplicate writes, in no
    fixed order on the card), which is harmless only while no child slot
    under a nonzero mask reads it: neither in the padded arrays nor in the
    engine's flat rows (each candidate's block ends in its trash row)."""
    trees = _sets()[name]
    scheds = [compile_schedule(t) for t in trees]
    for u in (0, 3):
        rg = scheds if u == 0 else [regroup_schedule(s, u) for s in scheds]
        padded = pad_schedules(rg, pad_to=(rg[0].n_levels + 2, 5, 2))
        n = rg[0].n_nodes
        live = padded["mask"] > 0
        assert not (padded["children"][live] == n).any()
        assert (padded["nodes"] == n).any()          # there is padding
    aln = {nm: "ACGTAC" for nm in trees[0].leaf_names}
    eng = TopologySetEngine(trees, aln, models.JC69, device="cpu")
    block = eng.n_nodes + 1
    trash = torch.arange(len(trees))[:, None, None, None] * block + \
        eng.n_nodes
    live = eng._sched["mask"] > 0
    assert not (eng._sched["child_rows"] == trash)[live].any()


def test_sharding_is_refused(tree_set):
    """Sharding, once refused, now runs: the port's engine over eight CPU
    shards with ``tile=7`` (the patterns padded to a multiple of 56) against
    JAX's sharded engine on its 8-device mesh, logL and sitewise logL to
    1e-10 relative and gradients to 1e-8, and against the port's unsharded
    engine."""
    from phylo_utils_tpu.parallel import SiteSharding as JaxSharding
    from phylo_utils_tpu.parallel import make_mesh as jax_make_mesh
    from phylo_utils_tpu_torch.parallel import SiteSharding, make_mesh

    trees, aln = tree_set
    sharding = SiteSharding(make_mesh(["cpu"] * 8), tile=7)
    port = TopologySetEngine(trees, aln, models.HKY85, ncat=2,
                             sharding=sharding, device="cpu")
    single = TopologySetEngine(trees, aln, models.HKY85, ncat=2,
                               device="cpu")
    ref = JaxTSE(_jax_trees(trees), aln, jmodels.HKY85, ncat=2,
                 sharding=JaxSharding(jax_make_mesh(), tile=7))
    assert port._leaf_partials.shape[1] == ref._leaf_partials.shape[1] == 168
    lls = port.loglikelihoods()
    assert _rel(lls, ref.loglikelihoods()) <= 1e-10
    assert _rel(lls, single.loglikelihoods()) <= 1e-12
    assert _rel(port.sitewise_loglikelihoods(),
                ref.sitewise_loglikelihoods()) <= 1e-10
    g, gj = port.gradients(), ref.gradients()
    assert _rel(g["branch_lengths"], gj["branch_lengths"]) <= 1e-8
    assert _rel(g["model"]["kappa"], gj["model"]["kappa"]) <= 1e-8
    assert _rel(g["alpha"], gj["alpha"]) <= 1e-8


def test_float32_matches_float64(tree_set, gtr_pair):
    """f32 partials (P(t), rates and the root reduction in f64) to 1e-6
    relative of the f64 port, and a gradient to 1e-5 of its largest
    entry."""
    trees, aln = tree_set
    port64, _ = gtr_pair
    port32 = TopologySetEngine(trees, aln, models.GTR, ncat=4,
                               dtype="float32", device="cpu")
    assert _rel(port32.loglikelihoods(), port64.loglikelihoods()) <= 1e-6
    g32 = port32.gradients()["branch_lengths"]
    assert g32.dtype == torch.float32
    assert _rel(g32, port64.gradients()["branch_lengths"]) <= 1e-5


def test_default_device_is_the_card(tree_set):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there")
    trees, aln = tree_set
    with pytest.raises(RuntimeError, match="cuda"):
        TopologySetEngine(trees, aln, models.JC69)


def test_unrest_gradient_at_uniform_rates_unlike_the_reference():
    """UNREST at its default (uniform) rates: the port's batched gradient
    of the rates is finite and matches central differences (1e-6 of its
    largest entry); the JAX package's is NaN there (its stationary
    distribution's least-squares solve differentiates through an SVD
    with repeated singular values; ROADMAP C)."""
    trees = [random_tree(6, seed=s) for s in range(3)]
    rng = np.random.default_rng(1)
    aln = {n: "".join(rng.choice(list("ACGT"), size=50))
           for n in trees[0].leaf_names}
    port = TopologySetEngine(trees, aln, models.UNREST, ncat=2,
                             device="cpu")
    got = port.gradients()["model"]["rates"].numpy()
    r0 = port.default_params()["model"]["rates"].numpy()
    fd = np.empty_like(r0)
    for i in range(r0.size):
        up, dn = r0.copy(), r0.copy()
        up[i] += 1e-6
        dn[i] -= 1e-6
        fd[i] = (port.loglikelihoods({"model": {"rates": up}}).sum()
                 - port.loglikelihoods({"model": {"rates": dn}}).sum()) / 2e-6
    assert np.isfinite(got).all() and _rel(got, fd) <= 1e-6
    ref = JaxTSE(_jax_trees(trees), aln, jmodels.UNREST, ncat=2)
    assert np.isnan(np.asarray(ref.gradients()["model"]["rates"])).any()
