"""Port parity, engine: ``phylo_utils_tpu_torch.likelihood.LikelihoodEngine``
against the JAX engine and the f64 oracle, on a 16-taxon GTR+G4+I problem
with non-default parameters carried across by ``convert.params_from_jax``.

Both engines get the same CompressedAlignment arrays (so the same pattern
order). Tolerances: f32 walk vs JAX f32 Pallas, total 1e-6 relative and
sitewise 1e-5 absolute (f32 partials); f64 torch pruner vs JAX f64 XLA
pruner and vs the oracle, 1e-10 relative; bootstrap 1e-8 relative (same
numpy resampling, f64 sitewise values).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu.likelihood import LikelihoodEngine as JaxEngine
from phylo_utils_tpu.likelihood import (
    mixture_rates_and_p as j_mixture_rates_and_p,
)
from phylo_utils_tpu.trees import random_tree
from phylo_utils_tpu_torch import io as tio
from phylo_utils_tpu_torch import models as tmodels
from phylo_utils_tpu_torch import trees as ttrees
from phylo_utils_tpu_torch.convert import params_from_jax, params_to_numpy
from phylo_utils_tpu_torch.likelihood import (
    LikelihoodEngine,
    mixture_rates_and_p,
)

GTR_PARAMS = {
    "model": {"rates": [1.2, 3.1, 0.7, 0.9, 4.2, 1.0],
              "freqs": [0.3, 0.2, 0.22, 0.28]},
    "alpha": 0.7,
    "pinv": 0.15,
}
KW = dict(ncat=4, invariant_sites=True)


def _numpy_tree(d):
    return {k: _numpy_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in d.items()}


def _port_tree(jtree):
    return ttrees.Tree(jtree.names, jtree.parent, jtree.lengths,
                       jtree.children, jtree.n_leaves)


def _port_alignment(ca):
    return tio.CompressedAlignment(
        ca.names, np.asarray(ca.partials), np.asarray(ca.weights),
        np.asarray(ca.site_to_pattern))


@pytest.fixture(scope="module")
def problem():
    jtree = random_tree(16, seed=3)
    rng = np.random.default_rng(5)
    aln = {
        n: "".join(rng.choice(list("ACGT-N"), p=[.24, .24, .24, .24, .02, .02],
                              size=240))
        for n in jtree.leaf_names
    }
    aln["t1"] = aln["t0"][:120] + aln["t1"][120:]     # shared columns
    j64 = JaxEngine(jtree, aln, jmodels.GTR, dtype="float64", **KW)
    full = _numpy_tree(j64._full_params(GTR_PARAMS))
    return dict(jtree=jtree, aln=aln, j64=j64, full=full,
                tree=_port_tree(jtree), ca=_port_alignment(j64._compressed))


def _port_engine(problem, **kw):
    return LikelihoodEngine(problem["tree"], problem["ca"], tmodels.GTR,
                            **{**KW, "device": "cpu", **kw})


def test_f32_cuda_pruner_matches_jax_pallas(problem):
    j32 = JaxEngine(problem["jtree"], problem["aln"], jmodels.GTR,
                    dtype="float32", pruner="pallas", **KW)
    port = _port_engine(problem, dtype=torch.float32, pruner="cuda")
    params = params_from_jax(problem["full"])
    want = j32.loglikelihood(GTR_PARAMS)
    got = port.loglikelihood(params)
    assert abs(got - want) / abs(want) < 1e-6
    np.testing.assert_allclose(port.sitewise_loglikelihoods(params),
                               j32.sitewise_loglikelihoods(GTR_PARAMS),
                               rtol=0, atol=1e-5)
    # and the f32 walk stays within the f32 budget of the exact value
    exact = problem["j64"].loglikelihood(GTR_PARAMS)
    assert abs(got - exact) / abs(exact) < 1e-6


def test_f64_torch_pruner_matches_jax_xla_and_oracle(problem):
    port = _port_engine(problem, dtype=torch.float64, pruner="torch")
    params = params_from_jax(problem["full"])
    got = port.loglikelihood(params)
    want = problem["j64"].loglikelihood(GTR_PARAMS)
    assert abs(got - want) / abs(want) < 1e-10
    m = GTR_PARAMS["model"]
    gold = oracle.loglikelihood(
        problem["jtree"], problem["aln"], oracle.gtr(m["rates"], m["freqs"]),
        rates=oracle.discrete_gamma(GTR_PARAMS["alpha"], 4),
        pinv=GTR_PARAMS["pinv"])
    assert abs(got - gold) / abs(gold) < 1e-10
    np.testing.assert_allclose(
        port.sitewise_loglikelihoods(params),
        problem["j64"].sitewise_loglikelihoods(GTR_PARAMS), rtol=1e-10)


@pytest.mark.parametrize("pruner,dtype,tol", [
    ("torch", torch.float64, 1e-10),
    ("cuda", torch.float32, 1e-6),
])
def test_loglikelihood_many_matches_jax(problem, pruner, dtype, tol):
    port = _port_engine(problem, dtype=dtype, pruner=pruner)
    lengths = problem["jtree"].lengths
    bl = np.stack([lengths * s for s in (0.5, 1.0, 2.5)])
    want = problem["j64"].loglikelihood_many(bl, GTR_PARAMS)
    got = port.loglikelihood_many(bl, params_from_jax(problem["full"]))
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=tol)


def test_bootstrap_matches_jax(problem):
    port = _port_engine(problem, dtype=torch.float64)
    want = problem["j64"].bootstrap_loglikelihoods(20, GTR_PARAMS, seed=9)
    got = port.bootstrap_loglikelihoods(20, params_from_jax(problem["full"]),
                                        seed=9)
    np.testing.assert_allclose(got, want, rtol=1e-8)


def test_free_rates_match_jax(problem):
    fr = {"model": GTR_PARAMS["model"], "rates": [0.1, 0.5, 1.3, 2.9],
          "cat_weights": [0.1, 0.3, 0.4, 0.2]}
    j = JaxEngine(problem["jtree"], problem["aln"], jmodels.GTR, ncat=4,
                  rate_model="free", dtype="float64")
    port = LikelihoodEngine(problem["tree"], problem["ca"], tmodels.GTR,
                            ncat=4, rate_model="free", device="cpu")
    assert abs(port.loglikelihood(fr) - j.loglikelihood(fr)) < 1e-10 * abs(
        j.loglikelihood(fr))


@pytest.mark.parametrize("name,params", [
    ("K80", {"kappa": 3.3}),
    ("HKY85", {"kappa": 4.1, "freqs": [0.3, 0.2, 0.25, 0.25]}),
    ("TN93", {"alpha1": 3.0, "alpha2": 1.5, "beta": 0.8,
              "freqs": [0.22, 0.28, 0.31, 0.19]}),
    ("UNREST", {"rates": [0.5, 1.5, 0.7, 1.1, 0.3, 2.0,
                          1.3, 0.6, 0.9, 0.4, 1.8, 1.0]}),
])
def test_other_dna_models_match_jax(problem, name, params):
    p = {"model": params, "alpha": 1.3}
    j = JaxEngine(problem["jtree"], problem["aln"], getattr(jmodels, name),
                  ncat=4, dtype="float64")
    port = LikelihoodEngine(problem["tree"], problem["ca"],
                            tmodels.get_model(name), ncat=4, device="cpu")
    want = j.loglikelihood(p)
    assert abs(port.loglikelihood(p) - want) / abs(want) < 1e-10


@pytest.mark.parametrize("name,params", [
    ("GTR", GTR_PARAMS["model"]),
    ("UNREST", {"rates": [0.5, 1.5, 0.7, 1.1, 0.3, 2.0,
                          1.3, 0.6, 0.9, 0.4, 1.8, 1.0]}),
])
def test_mixture_rates_and_p_matches_jax(problem, name, params):
    """Both P(t) paths of ``mixture_rates_and_p``, the engine's cached
    eigensystem and the model rebuilt from its parameters (the reversible
    model through ``p_matrices_reversible``), against the JAX function:
    P entries to 1e-12 absolute (the JAX f64 eigensystem carries a ~1e-13
    tie-break jitter), rates to 1e-12 relative."""
    p = {"model": params, "alpha": 0.7}
    j = JaxEngine(problem["jtree"], problem["aln"], getattr(jmodels, name),
                  ncat=4, dtype="float64")
    port = LikelihoodEngine(problem["tree"], problem["ca"],
                            tmodels.get_model(name), ncat=4, device="cpu")
    jr, jw, jp, jf = j_mixture_rates_and_p(j, j._full_params(p), jnp.float64)
    full = port._full_params(p)
    for eig in (None, port.model_eigen(full)):
        r, w, pm, f = mixture_rates_and_p(port, full, torch.float64, eig=eig)
        assert pm.shape == jp.shape and pm.dtype == torch.float64
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-12)
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        np.testing.assert_allclose(pm.numpy(), np.asarray(jp), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0,
                                   atol=1e-14)


def test_dict_alignment_and_newick_input(problem):
    """Uncompressed dict input gives the same total as the compressed
    arrays (pattern order does not matter)."""
    from phylo_utils_tpu_torch.io import write_newick

    newick = write_newick(problem["tree"])
    port = LikelihoodEngine(newick, problem["aln"], tmodels.GTR,
                            compress=False, **KW, device="cpu")
    ref = LikelihoodEngine(tio.parse_newick(newick), problem["ca"],
                           tmodels.GTR, **KW, device="cpu")
    assert port.loglikelihood(GTR_PARAMS) == pytest.approx(
        ref.loglikelihood(GTR_PARAMS), rel=1e-12)
    assert port.sitewise_loglikelihoods(GTR_PARAMS).shape == (240,)


def test_params_round_trip_and_typo_guard(problem):
    port = _port_engine(problem)
    full = port._full_params(GTR_PARAMS)
    back = params_to_numpy(full)
    np.testing.assert_array_equal(back["model"]["rates"],
                                  GTR_PARAMS["model"]["rates"])
    assert port.loglikelihood(back) == port.loglikelihood(GTR_PARAMS)
    with pytest.raises(ValueError, match="unknown parameter"):
        port.loglikelihood({"aplha": 0.5})
    with pytest.raises(ValueError, match="unknown model parameter"):
        port.loglikelihood({"model": {"kapa": 2.0}})


def test_gradients_raise_not_implemented(problem):
    """Gradients run on both pruners and match the JAX f64 engine's
    (f32 walk: 5e-4 x max|g| per leaf, value 1e-6 relative); only the
    value-only cached eigensystem still raises for inputs that require
    grad, as in the JAX package."""
    params = params_from_jax(problem["full"])
    want_ll, want_g = problem["j64"].value_and_grad(GTR_PARAMS)
    for pruner in ("torch", "cuda"):
        port = _port_engine(problem, dtype=torch.float32, pruner=pruner)
        ll, g = port.value_and_grad(params)
        assert abs(float(ll) - float(want_ll)) < 1e-6 * abs(float(want_ll))
        for key in ("branch_lengths", "alpha", "pinv"):
            want = np.asarray(want_g[key])
            np.testing.assert_allclose(
                g[key].numpy(), want, rtol=0,
                atol=5e-4 * np.abs(want).max(), err_msg=f"{pruner} {key}")
        for key in ("rates", "freqs"):
            want = np.asarray(want_g["model"][key])
            np.testing.assert_allclose(
                g["model"][key].numpy(), want, rtol=0,
                atol=5e-4 * np.abs(want).max(), err_msg=f"{pruner} {key}")
    rates = torch.tensor(GTR_PARAMS["model"]["rates"], dtype=torch.float64,
                         requires_grad=True)
    with pytest.raises(NotImplementedError, match="value-only"):
        tmodels.GTR.eigen({"rates": rates})


def test_cuda_device_raises_without_cuda(problem):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        _port_engine(problem, device="cuda")


def test_float64_cuda_pruner_warns(problem):
    with pytest.warns(UserWarning, match="float32"):
        port = _port_engine(problem, dtype=torch.float64, pruner="cuda")
    want = problem["j64"].loglikelihood(GTR_PARAMS)
    assert abs(port.loglikelihood(GTR_PARAMS) - want) / abs(want) < 1e-6
