"""Port parity, topology tests (``phylo_utils_tpu_torch.topology_tests``):
``rell_logliks``, ``kh_test``, ``sh_test`` and ``au_test`` against the JAX
package's on one sitewise matrix (the port's ``TopologySetEngine`` on 2000
K80 sites simulated by the JAX package), every array to 1e-12; and
``likelihood_mapping`` (float32 in both packages) against JAX's: points
within 1e-3 absolute, the same quartets and the same best pairing wherever
JAX's top two weights differ by more than 1e-2.
"""
import jax
import numpy as np
import pytest
import torch

from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu import topology_tests as jtt
from phylo_utils_tpu.io import parse_newick as j_parse_newick
from phylo_utils_tpu.simulate import simulate_alignment
from phylo_utils_tpu_torch import models
from phylo_utils_tpu_torch import topology_tests as tt
from phylo_utils_tpu_torch.batched import TopologySetEngine
from phylo_utils_tpu_torch.io import write_newick
from phylo_utils_tpu_torch.trees import nni_neighbors, random_tree

from torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def sitewise_matrix():
    """(8, 2000): the generating 7-taxon tree and 7 of its NNI neighbors
    under K80 (kappa 3)."""
    truth = random_tree(7, seed=3, mean_brlen=0.25)
    aln = simulate_alignment(jax.random.key(9),
                             j_parse_newick(write_newick(truth)),
                             jmodels.K80, 2000, params={"kappa": 3.0})
    cands = [truth] + nni_neighbors(truth)[:7]
    tse = TopologySetEngine(cands, aln, models.K80, device="cpu")
    return tse.sitewise_loglikelihoods({"model": {"kappa": 3.0}})


def _assert_equal_results(got, want):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                   np.asarray(want[key], np.float64),
                                   rtol=1e-12, atol=1e-12, err_msg=key)


@pytest.mark.parametrize("name,kw", [
    ("kh_test", dict(n_boot=500, seed=2)),
    ("sh_test", dict(n_boot=500, seed=2)),
    ("au_test", dict(n_boot=600, seed=4)),
])
def test_rell_tests_match_jax(sitewise_matrix, name, kw):
    got = getattr(tt, name)(sitewise_matrix, **kw)
    _assert_equal_results(got, getattr(jtt, name)(sitewise_matrix, **kw))
    assert got["best"] == 0                       # the generating tree
    assert (np.asarray(got["pvalue"])[1:] < 0.05).any()


def test_rell_logliks_match_jax(sitewise_matrix):
    got = tt.rell_logliks(sitewise_matrix, n_boot=200, seed=1)
    assert got.shape == (200, 8)
    np.testing.assert_allclose(
        got, jtt.rell_logliks(sitewise_matrix, n_boot=200, seed=1),
        rtol=1e-12)


def test_au_test_near_tied_rows():
    """Two indistinguishable rows split the BP mass and neither is
    rejected; a dominated third gets p ~ 0 (the JAX package's case), with
    JAX's numbers."""
    rng = np.random.default_rng(0)
    row = rng.normal(-3.0, 1.0, size=400)
    sw = np.stack([row, row + rng.normal(0, 0.05, size=400), row - 0.5])
    au = tt.au_test(sw, n_boot=400, seed=1)
    assert au["pvalue"][0] > 0.2 and au["pvalue"][1] > 0.2
    assert au["pvalue"][2] < 0.01 and au["bp"][2] == 0.0
    _assert_equal_results(au, jtt.au_test(sw, n_boot=400, seed=1))


@pytest.fixture(scope="module")
def lmap_data():
    tree = random_tree(10, seed=5, mean_brlen=0.15)
    aln = simulate_alignment(jax.random.key(3),
                             j_parse_newick(write_newick(tree)),
                             jmodels.K80, 400, params={"kappa": 3.0})
    rng = np.random.default_rng(0)
    noise = {n: "".join(rng.choice(list("ACGT"), size=400))
             for n in tree.leaf_names}
    return aln, noise


def test_likelihood_mapping_matches_jax(lmap_data):
    """30 quartets, 50 steps. On this data the smallest gap between JAX's
    top two weights is 0.271 and the largest point difference 6.1e-5
    (the packages sum float32 sites in another order)."""
    aln, _ = lmap_data
    kw = dict(params={"kappa": 3.0}, n_quartets=30, seed=1, steps=50)
    got = tt.likelihood_mapping(aln, models.K80, device="cpu", **kw)
    want = jtt.likelihood_mapping(aln, jmodels.K80, **kw)
    np.testing.assert_array_equal(got["quartets"], want["quartets"])
    assert list(got["names"]) == list(want["names"])
    assert np.abs(got["points"] - want["points"]).max() <= 1e-3
    top2 = np.sort(want["points"], axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-2
    np.testing.assert_array_equal(got["points"].argmax(1)[clear],
                                  want["points"].argmax(1)[clear])
    np.testing.assert_allclose(got["points"].sum(axis=1), 1.0, atol=1e-6)
    assert got["basins"].sum() == pytest.approx(1.0)


def test_likelihood_mapping_clean_vs_noise(lmap_data):
    """Tree-like data maps mostly to the corners; random columns do not."""
    aln, noise = lmap_data
    clean = tt.likelihood_mapping(aln, models.K80, params={"kappa": 3.0},
                                  n_quartets=30, seed=1, steps=50,
                                  device="cpu")
    flat = tt.likelihood_mapping(noise, models.K80, n_quartets=30, seed=1,
                                 steps=50, device="cpu")
    assert clean["resolved"] > 0.5
    assert flat["resolved"] < clean["resolved"] - 0.3


def test_likelihood_mapping_needs_four_taxa():
    with pytest.raises(ValueError, match=">= 4 taxa"):
        tt.likelihood_mapping({"a": "ACGT", "b": "ACGT", "c": "ACGA"},
                              models.JC69, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tt.likelihood_mapping({"a": "ACGT"}, models.JC69)
