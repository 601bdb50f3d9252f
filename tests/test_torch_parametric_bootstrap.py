"""Port parity, parametric bootstrap: ``optimize.parametric_bootstrap`` and
``optimize.simulation_setup`` of the port against the JAX package's, on
the CPU (``device="cpu"``, float64).

Tolerances: ``tests/test_parametric_bootstrap.py``'s criteria on the port
(the replicate mean of kappa within 1.5 of the MLE, the bootstrap SE
within 0.25-4x of the Hessian's); replicate 0's alignment, rebuilt from
the seed, refitted by the JAX package's ``fit`` from the same start to
the port replicate's logL within 1e-6 relative (the two packages run
different L-BFGS implementations, so their fits meet at the optimum, not
step by step).
"""
import numpy as np
import pytest
import torch

from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu.ascertainment import AscertainmentEngine as JAsc
from phylo_utils_tpu.likelihood import LikelihoodEngine as JEngine
from phylo_utils_tpu.mixtures import ModelMixtureEngine as JModelMixture
from phylo_utils_tpu.optimize import fit as j_fit
from phylo_utils_tpu.optimize import simulation_setup as j_setup
from phylo_utils_tpu.profile_mixtures import (
    ProfileMixtureEngine as JProfileMixture,
)
from phylo_utils_tpu_torch import models
from phylo_utils_tpu_torch.ascertainment import AscertainmentEngine
from phylo_utils_tpu_torch.convert import params_to_numpy
from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
from phylo_utils_tpu_torch.mixtures import ModelMixtureEngine
from phylo_utils_tpu_torch.optimize import (
    fit,
    parametric_bootstrap,
    simulation_setup,
    standard_errors,
)
from phylo_utils_tpu_torch.profile_mixtures import ProfileMixtureEngine
from phylo_utils_tpu_torch.simulate import simulate_alignment
from phylo_utils_tpu_torch.trees import random_tree

from torch_threads import one_thread  # noqa: F401

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def k80_mle():
    """300 K80 sites (kappa 3) on a 6-taxon tree, simulated by the port,
    and the port's MLE."""
    tree = random_tree(6, seed=1)
    aln = simulate_alignment(5, tree, models.K80, 300,
                             params={"kappa": 3.0}, **CPU)
    eng = LikelihoodEngine(tree, aln, models.K80, **CPU)
    return eng, fit(eng, max_steps=200)


@pytest.fixture(scope="module")
def k80_bootstrap(k80_mle):
    eng, mle = k80_mle
    return parametric_bootstrap(eng, mle.params, n_replicates=6, seed=0,
                                max_steps=120)


def test_parametric_bootstrap_consistent_with_hessian_se(k80_mle,
                                                         k80_bootstrap):
    eng, mle = k80_mle
    pb = k80_bootstrap
    reps = pb["replicates"]["model"]["kappa"]
    assert reps.shape == (6,)
    kappa_hat = float(mle.params["model"]["kappa"])
    assert abs(pb["mean"]["model"]["kappa"] - kappa_hat) < 1.5
    se_h = float(standard_errors(eng, mle.params)["model"]["kappa"])
    se_b = float(pb["se"]["model"]["kappa"])
    assert 0.25 * se_h < se_b < 4.0 * se_h
    assert np.isfinite(pb["loglik"]).all()
    assert pb["replicates"]["branch_lengths"].shape == (6, eng.tree.n_nodes)
    assert set(pb) == {"replicates", "mean", "se", "loglik"}


def test_replicate_zero_refits_to_the_jax_optimum(k80_mle, k80_bootstrap):
    """Replicate 0 is simulated from ``seed + 0``: rebuilt here and fitted
    by the JAX package from the same start, it reaches the port
    replicate's logL."""
    eng, mle = k80_mle
    _, tree_mle, n_sites, sim_params, pinv = simulation_setup(
        eng, mle.params, "test")
    aln = simulate_alignment(0, tree_mle, models.K80, n_sites,
                             params=sim_params, pinv=pinv, **CPU)
    start = params_to_numpy(eng._full_params(mle.params))
    je = JEngine(_jax_tree(tree_mle), aln, jmodels.K80)
    res = j_fit(je, params0=start, max_steps=120)
    port_ll = float(k80_bootstrap["loglik"][0])
    assert res.loglik == pytest.approx(port_ll, rel=1e-6)
    # the rebuilt alignment is the one the port replicate was fitted on
    rep = LikelihoodEngine(tree_mle, aln, models.K80, **CPU)
    rep_params = {"branch_lengths":
                  k80_bootstrap["replicates"]["branch_lengths"][0],
                  "model": {"kappa":
                            k80_bootstrap["replicates"]["model"]["kappa"][0]}}
    assert rep.loglikelihood(rep_params) == pytest.approx(port_ll, rel=1e-12)


def _jax_tree(tree):
    from phylo_utils_tpu.io import parse_newick as j_parse_newick
    from phylo_utils_tpu_torch.io import write_newick

    return j_parse_newick(write_newick(tree))


def _refused(setup, engine):
    try:
        setup(engine, None, "test")
    except ValueError:
        return True
    return False


def test_simulation_setup_refuses_the_same_engines():
    """Each package refuses the model and profile mixtures, the
    ascertainment engine and FreeRate rates, and takes the base engine
    (and its +G+I parameters, flattened for the simulator)."""
    tree = "((a:0.1,b:0.2):0.05,(c:0.3,d:0.15):0.07);"
    aln = {"a": "ACGTACGTGG", "b": "ACGTTGCAGG", "c": "AGGTACGAGT",
           "d": "ACGAACGTAT"}
    mk = {"a": "0101100110", "b": "0110101010", "c": "1010011001",
          "d": "1001010101"}
    mixture = [{"kappa": 1.0}, {"kappa": 8.0}]
    pairs = {
        "base": (JEngine(tree, aln, jmodels.HKY85, ncat=4,
                         invariant_sites=True),
                 LikelihoodEngine(tree, aln, models.HKY85, ncat=4,
                                  invariant_sites=True, **CPU)),
        "free_rates": (JEngine(tree, aln, jmodels.HKY85, ncat=3,
                               rate_model="free"),
                       LikelihoodEngine(tree, aln, models.HKY85, ncat=3,
                                        rate_model="free", **CPU)),
        "model_mixture": (JModelMixture(tree, aln, jmodels.HKY85, mixture),
                          ModelMixtureEngine(tree, aln, models.HKY85,
                                             mixture, **CPU)),
        "profile_mixture": (JProfileMixture(tree, aln, jmodels.HKY85,
                                            profiles=2),
                            ProfileMixtureEngine(tree, aln, models.HKY85,
                                                 profiles=2, **CPU)),
        "ascertainment": (JAsc(tree, mk, jmodels.get_model("MK2"),
                               ncat=4),
                          AscertainmentEngine(tree, mk,
                                              models.get_model("MK2"),
                                              ncat=4, **CPU)),
    }
    refused = {name: (_refused(j_setup, je), _refused(simulation_setup, te))
               for name, (je, te) in pairs.items()}
    assert refused == {"base": (False, False), "free_rates": (True, True),
                       "model_mixture": (True, True),
                       "profile_mixture": (True, True),
                       "ascertainment": (True, True)}
    je, te = pairs["base"]
    params = {"alpha": 0.7, "pinv": 0.2, "model": {"kappa": 2.5}}
    want = j_setup(je, params, "test")
    got = simulation_setup(te, params, "test")
    np.testing.assert_allclose(got[1].lengths, want[1].lengths, rtol=0)
    assert got[2] == want[2] == 10 and got[4] == want[4] == 0.2
    assert set(got[3]) == set(want[3]) == {"kappa", "freqs", "alpha"}
    for k in want[3]:
        np.testing.assert_allclose(got[3][k].numpy(), np.asarray(want[3][k]),
                                   rtol=1e-15)


def test_replicates_run_through_the_kernels_plain_walks():
    """``pruner="cuda"`` on CPU tensors runs the kernels' plain versions
    (float32 engine): the same seed gives the same replicates as a second
    call, and each refit's logL is finite."""
    tree = random_tree(5, seed=2)
    aln = simulate_alignment(1, tree, models.HKY85, 200, ncat=4,
                             params={"kappa": 2.0, "alpha": 0.8}, **CPU)
    eng = LikelihoodEngine(tree, aln, models.HKY85, ncat=4,
                           dtype=torch.float32, pruner="cuda", **CPU)
    runs = [parametric_bootstrap(eng, None, n_replicates=2, seed=4,
                                 pruner="cuda", max_steps=5)
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0]["loglik"], runs[1]["loglik"])
    assert np.isfinite(runs[0]["loglik"]).all()
    assert runs[0]["replicates"]["alpha"].shape == (2,)
