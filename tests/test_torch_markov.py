"""Port parity, ``markov.TransitionMatrix``: the port's facade against the
JAX package's (``tests/test_facades.py``'s transition-matrix cases), on
the CPU (``device="cpu"``).

Tolerances: P(t), dP/dt and d2P/dt2 to 1e-12 absolute in float64 against
the JAX facade (both reconstruct from a float64 eigensystem; UNREST's
matrix exponential to 1e-12 too), the JAX test's own bounds for the
finite differences and the oracle, and ``sample_states``' draws to 5
binomial sigma of the P(t) row they sample (and the JAX test's 0.012).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle.core as oracle
from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu.markov import TransitionMatrix as JaxTransitionMatrix
from phylo_utils_tpu_torch import models
from phylo_utils_tpu_torch.markov import TransitionMatrix, sample_rows

from torch_threads import one_thread  # noqa: F401

CASES = [
    ("HKY85", {"kappa": 3.0}),
    ("GTR", {"rates": [1.2, 3.1, 0.7, 0.9, 4.2, 1.0],
             "freqs": [0.3, 0.2, 0.22, 0.28]}),
    ("LG", None),
    ("UNREST", None),
]
TIMES = [0.0, 0.01, 0.2, 0.37, 1.5, 4.0]


@pytest.mark.parametrize("name,params", CASES)
def test_matrices_match_jax_facade(name, params):
    tm = TransitionMatrix(getattr(models, name), params, device="cpu")
    jtm = JaxTransitionMatrix(
        getattr(jmodels, name),
        None if params is None else {k: jnp.asarray(v, jnp.float64)
                                     for k, v in params.items()},
        dtype=jnp.float64)
    np.testing.assert_allclose(tm.freqs.numpy(), np.asarray(jtm.freqs),
                               atol=1e-12)
    np.testing.assert_allclose(tm.q.numpy(), np.asarray(jtm.q), atol=1e-12)
    t = np.asarray(TIMES)
    for ours, theirs in ((tm.get_p_matrix, jtm.get_p_matrix),
                         (tm.get_dp_matrix, jtm.get_dp_matrix),
                         (tm.get_d2p_matrix, jtm.get_d2p_matrix)):
        got = ours(torch.as_tensor(t)).numpy()
        assert got.shape == (len(TIMES),) + tuple(tm.q.shape)
        np.testing.assert_allclose(got, np.asarray(theirs(jnp.asarray(t))),
                                   atol=1e-12)
        np.testing.assert_allclose(ours(0.2).numpy(), got[2], atol=0)


def test_transition_matrix_properties():
    """``tests/test_facades.py::test_transition_matrix_properties`` on the
    port."""
    tm = TransitionMatrix(models.HKY85, {"kappa": 3.0}, device="cpu")
    p = tm.get_p_matrix(0.2).numpy()
    np.testing.assert_allclose(p.sum(axis=-1), 1.0, atol=1e-12)
    np.testing.assert_allclose(tm.get_p_matrix(0.0).numpy(), np.eye(4),
                               atol=1e-12)
    h = 1e-6
    plus, mid, minus = (tm.get_p_matrix(x).numpy()
                        for x in (0.2 + h, 0.2, 0.2 - h))
    np.testing.assert_allclose(tm.get_dp_matrix(0.2).numpy(),
                               (plus - minus) / (2 * h), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tm.get_d2p_matrix(0.2).numpy(),
                               (plus - 2 * mid + minus) / h ** 2,
                               rtol=1e-3, atol=1e-4)
    assert tm.get_p_matrix([0.1, 0.2, 0.3]).shape == (3, 4, 4)
    np.testing.assert_allclose(
        tm.get_p_matrix(0.37).numpy(),
        oracle.pmat(oracle.hky85(3.0, [0.25] * 4), 0.37), atol=1e-10)


@pytest.mark.parametrize("name,parent,t", [("JC69", 0, 0.5),
                                           ("LG", 7, 0.3)])
def test_sample_states_distribution(name, parent, t):
    """Children of one parent state follow its P(t) row (the JAX facade's
    draws follow the same row: both within 5 sigma a state)."""
    n = 20000
    tm = TransitionMatrix(getattr(models, name), device="cpu")
    gen = torch.Generator().manual_seed(0)
    kids = tm.sample_states(gen, torch.full((n,), parent), t).numpy()
    jtm = JaxTransitionMatrix(getattr(jmodels, name), dtype=jnp.float64)
    j_kids = np.asarray(jtm.sample_states(
        jax.random.key(0), jnp.full((n,), parent, jnp.int32), t))
    row = tm.get_p_matrix(t).numpy()[parent]
    s = row.shape[0]
    sigma5 = 5.0 * np.sqrt(row * (1.0 - row) / n)
    for draws in (kids, j_kids):
        emp = np.bincount(draws, minlength=s) / n
        assert emp.shape == (s,)
        assert (np.abs(emp - row) <= np.maximum(sigma5, 1.0 / n)).all()
        np.testing.assert_allclose(emp, row, atol=0.012)


def test_sample_rows_never_draws_a_zero_probability_state():
    """The inverse CDF lies in [0, S) by construction and never returns a
    state of probability zero, at either end of the row."""
    rows = torch.tensor([[0.0, 0.5, 0.5, 0.0], [0.0, 0.0, 0.0, 1.0],
                         [1.0, 0.0, 0.0, 0.0]], dtype=torch.float64)
    gen = torch.Generator().manual_seed(1)
    draws = sample_rows(gen, rows.expand(5000, -1, -1))
    assert set(draws[:, 0].tolist()) == {1, 2}
    assert set(draws[:, 1].tolist()) == {3}
    assert set(draws[:, 2].tolist()) == {0}
