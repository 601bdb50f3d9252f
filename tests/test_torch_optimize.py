"""Port parity, fitting: ``phylo_utils_tpu_torch.optimize.fit`` mirrors
``tests/test_optimize.py`` and is held to the JAX package's ``fit`` on the
same simulated 6-taxon HKY85+G4 problem.

The two default optimizers differ (torch L-BFGS with a strong-Wolfe line
search against optax L-BFGS with a zoom line search), so the fits are
compared at their optima, not step by step: logL to 1e-5 absolute, the
model parameters, alpha and every branch length to 2e-3 absolute (the
surface is flat to ~1e-6 in logL over that range). Checkpoint resume is
bit-exact within the port.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu.likelihood import LikelihoodEngine as JaxEngine
from phylo_utils_tpu.optimize import fit as jax_fit
from phylo_utils_tpu.simulate import simulate_alignment
from phylo_utils_tpu.trees import random_tree
from phylo_utils_tpu_torch import models
from phylo_utils_tpu_torch import trees as ttrees
from phylo_utils_tpu_torch.convert import flatten_params
from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
from phylo_utils_tpu_torch.optimize import (
    fit,
    transform_params,
    untransform_params,
)
from phylo_utils_tpu_torch.utils.checkpoint import load_checkpoint

from torch_threads import one_thread  # noqa: F401


def _port_tree(jtree):
    return ttrees.Tree(jtree.names, jtree.parent, jtree.lengths,
                       jtree.children, jtree.n_leaves)


def _aln(tree, sites, seed=0):
    rng = np.random.default_rng(seed)
    return {n: "".join(rng.choice(list("ACGT"), size=sites))
            for n in tree.leaf_names}


@pytest.fixture(scope="module")
def simulated():
    """6 taxa, 300 sites simulated under HKY85+G4 (kappa 3, alpha 0.6), so
    the maximum-likelihood estimates are finite."""
    jtree = random_tree(6, seed=1, mean_brlen=0.15)
    aln = simulate_alignment(
        jax.random.key(3), jtree, jmodels.HKY85, 300,
        params={"kappa": 3.0, "freqs": [0.3, 0.2, 0.2, 0.3], "alpha": 0.6},
        ncat=4)
    return jtree, _port_tree(jtree), aln


def test_transform_roundtrip():
    params = {
        "branch_lengths": torch.tensor([0.1, 2.0, 1e-4], dtype=torch.float64),
        "model": {"kappa": torch.tensor(3.5, dtype=torch.float64),
                  "freqs": torch.tensor([0.1, 0.2, 0.3, 0.4],
                                        dtype=torch.float64)},
        "alpha": torch.tensor(0.47, dtype=torch.float64),
        "pinv": torch.tensor(0.23, dtype=torch.float64),
    }
    back = untransform_params(transform_params(params))
    for (pa, a), (pb, b) in zip(zip(*flatten_params(params)),
                                zip(*flatten_params(back))):
        assert pa == pb
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6)


@pytest.fixture(scope="module")
def port_fit(simulated):
    _, tree, aln = simulated
    engine = LikelihoodEngine(tree, aln, models.HKY85, ncat=4, device="cpu")
    return engine, engine.loglikelihood(), fit(engine, max_steps=150,
                                               patience=20)


def test_fit_matches_jax_fit(simulated, port_fit):
    jtree, tree, aln = simulated
    want = jax_fit(JaxEngine(jtree, aln, jmodels.HKY85, ncat=4),
                   max_steps=150, patience=20)
    _, start, got = port_fit
    assert got.loglik > start + 10.0
    assert abs(got.loglik - want.loglik) < 1e-5
    np.testing.assert_allclose(got.params["branch_lengths"].numpy(),
                               np.asarray(want.params["branch_lengths"]),
                               rtol=0, atol=2e-3)
    for key in ("kappa", "freqs"):
        np.testing.assert_allclose(got.params["model"][key].numpy(),
                                   np.asarray(want.params["model"][key]),
                                   rtol=0, atol=2e-3, err_msg=key)
    assert abs(float(got.params["alpha"]) - float(want.params["alpha"])) < 2e-3


def test_fit_improves_and_reaches_optimum_neighborhood(port_fit):
    """The gradient vanishes at the optimum for every free parameter off
    its boundary (one simulated branch fits to length ~0, where dlogL/dt
    stays negative)."""
    engine, ll0, res = port_fit
    assert res.converged and res.loglik > ll0 + 1.0
    assert res.trace.shape == (res.n_steps,) and np.isfinite(res.trace).all()
    g = engine.gradient(res.params)
    interior = res.params["branch_lengths"] > 1e-4
    assert int(interior.sum()) >= 8
    gnorm = max(float(x.abs().max()) for x in
                (g["branch_lengths"][interior], g["model"]["kappa"],
                 g["alpha"]))
    assert gnorm < 0.5


def test_fit_f32_cuda_pruner_runs_the_fused_gradient(simulated):
    """A float32 engine with pruner="cuda" fits through the fused Function
    (the saveall and reverse walks' plain versions on CPU tensors) and
    lands within 1e-3 of the float64 fit's logL."""
    _, tree, aln = simulated
    f64 = LikelihoodEngine(tree, aln, models.HKY85, ncat=4, device="cpu")
    f32 = LikelihoodEngine(tree, aln, models.HKY85, ncat=4,
                           dtype=torch.float32, pruner="cuda", device="cpu")
    want = fit(f64, max_steps=60, patience=20)
    got = fit(f32, max_steps=60, patience=20)
    assert got.loglik == pytest.approx(f32.loglikelihood(got.params), abs=1e-9)
    assert abs(got.loglik - want.loglik) < 1e-3


def test_fit_respects_free_subset():
    tree = _port_tree(random_tree(5, seed=3))
    engine = LikelihoodEngine(tree, _aln(tree, 100, seed=4), models.K80,
                              device="cpu")
    start = engine.default_params()
    res = fit(engine, start, free=("branch_lengths",), max_steps=40)
    np.testing.assert_array_equal(res.params["model"]["kappa"].numpy(),
                                  start["model"]["kappa"].numpy())
    assert not np.allclose(res.params["branch_lengths"].numpy(),
                           start["branch_lengths"].numpy())


def test_fit_dotted_free_keys():
    """'model.kappa' frees kappa while its sibling freqs stay frozen."""
    tree = _port_tree(random_tree(5, seed=11, mean_brlen=0.2))
    engine = LikelihoodEngine(tree, _aln(tree, 60, seed=9), models.HKY85,
                              device="cpu")
    freqs = [0.3, 0.2, 0.2, 0.3]
    res = fit(engine, params0={"model": {"freqs": freqs}},
              free=("branch_lengths", "model.kappa"), max_steps=25)
    np.testing.assert_allclose(res.params["model"]["freqs"].numpy(), freqs,
                               atol=1e-12)
    assert float(res.params["model"]["kappa"]) != pytest.approx(2.0)
    with pytest.raises(ValueError, match="unknown free"):
        fit(engine, free=("kapa",), max_steps=1)
    with pytest.raises(ValueError, match="both whole"):
        fit(engine, free=("model", "model.kappa"), max_steps=1)
    with pytest.raises(ValueError, match="not a nested dict"):
        fit(engine, free=("branch_lengths.x",), max_steps=1)


def test_fit_chunked_steps_matches_unchunked():
    """steps_per_call only sets when stopping and checkpoints are checked:
    a deterministic optimizer takes the same steps."""
    tree = _port_tree(random_tree(5, seed=21))
    engine = LikelihoodEngine(tree, _aln(tree, 150, seed=22), models.K80,
                              device="cpu")
    adam = functools.partial(torch.optim.Adam, lr=0.02)
    r1 = fit(engine, optimizer=adam, max_steps=40, patience=1000)
    r8 = fit(engine, optimizer=adam, max_steps=40, patience=1000,
             steps_per_call=8)
    np.testing.assert_array_equal(r1.trace, r8.trace)
    assert r1.n_steps == r8.n_steps == 40


def test_fit_returned_loglik_matches_returned_params():
    """FitResult.loglik is the logL OF FitResult.params even when the last
    optimizer step overshoots."""
    tree = _port_tree(random_tree(5, seed=31))
    engine = LikelihoodEngine(tree, _aln(tree, 120, seed=32), models.K80,
                              device="cpu")
    sgd = functools.partial(torch.optim.SGD, lr=5.0)
    for chunk in (1, 4):
        res = fit(engine, optimizer=sgd, max_steps=8, patience=100,
                  steps_per_call=chunk)
        assert res.loglik == pytest.approx(engine.loglikelihood(res.params),
                                           abs=1e-9)
        assert res.loglik >= res.trace.max() - 1e-9


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs"])
def test_fit_checkpoint_resume_bitexact(tmp_path, optimizer):
    """A fit stopped at step 10 and resumed from its checkpoint writes the
    same step-20 state (raw parameters and optimizer state) as an
    uninterrupted run, bit for bit."""
    tree = _port_tree(random_tree(6, seed=4))
    engine = LikelihoodEngine(tree, _aln(tree, 40, seed=5), models.HKY85,
                              device="cpu")
    opt = (functools.partial(torch.optim.Adam, lr=1e-2)
           if optimizer == "adam" else None)
    pa, pb = str(tmp_path / "a.pt"), str(tmp_path / "b.pt")
    kw = dict(optimizer=opt, patience=10_000, steps_per_call=5,
              checkpoint_every=10)
    full = fit(engine, max_steps=20, checkpoint_path=pa, **kw)
    fit(engine, max_steps=10, checkpoint_path=pb, **kw)      # stopped at 10
    res = fit(engine, max_steps=20, checkpoint_path=pb, resume_from=pb, **kw)
    assert res.n_steps == 20            # the total includes the restored 10
    np.testing.assert_array_equal(res.trace, full.trace[10:])
    (sa, na), (sb, nb) = load_checkpoint(pa), load_checkpoint(pb)
    assert na == nb == 20
    _assert_identical(sa, sb)


def _assert_identical(a, b, path="state"):
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_identical(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_identical(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path
