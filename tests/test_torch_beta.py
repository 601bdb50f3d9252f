"""Port parity, ``ops/beta.py``: the incomplete beta function, the beta
quantile and the discrete-beta omega classes of M7/M8 in the PyTorch port
against the JAX package (``jax.scipy.special.betainc``,
``phylo_utils_tpu.ops.beta``) and scipy, in float64.

Tolerances: ``betainc`` 1e-13 absolute against both (each continued
fraction is within ~3e-14 of scipy over 0.1 <= p, q <= 21); ``beta_quantile``
1e-13 against JAX (the same 25 Newton steps) and 1e-12 against
``scipy.stats.beta.ppf``; ``discrete_beta`` 1e-12 against JAX over a (p, q)
grid from the U-shaped p, q < 1 to 12; its derivative, the JAX package's
central-difference rule in both packages, 1e-8 relative to ``jax.jvp``.
Where q is small and p large the mass sits against 1, and 25 Newton steps
in logit space leave both packages short of scipy by the same amount:
``test_small_q_corner_is_the_reference_scheme``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import scipy.stats
import torch

from phylo_utils_tpu.ops import beta as jbeta
from phylo_utils_tpu_torch.ops import beta as tbeta

from torch_threads import one_thread  # noqa: F401

GRID = [0.3, 0.6, 0.9, 1.5, 4.0, 12.0]


@pytest.fixture(scope="module")
def shapes():
    rng = np.random.default_rng(13)
    log_lo, log_hi = np.log(0.1), np.log(21.0)
    return (np.exp(rng.uniform(log_lo, log_hi, 300)),
            np.exp(rng.uniform(log_lo, log_hi, 300)), rng)


def test_betainc_matches_jax_and_scipy(shapes):
    a, b, rng = shapes
    x = np.concatenate([rng.uniform(0.0, 1.0, 280),
                        [0.0, 1.0, 1e-12, 1.0 - 1e-12] * 5])
    got = tbeta.betainc(torch.tensor(a), torch.tensor(b), torch.tensor(x))
    assert got.dtype == torch.float64
    got = got.numpy()
    want_jax = np.asarray(jax.scipy.special.betainc(a, b, x))
    np.testing.assert_allclose(got, want_jax, rtol=0, atol=1e-13)
    np.testing.assert_allclose(got, scipy.special.betainc(a, b, x), rtol=0,
                               atol=1e-13)
    # betaln is the lgamma sum, to f64 rounding of scipy's
    np.testing.assert_allclose(tbeta.betaln(a, b).numpy(),
                               scipy.special.betaln(a, b), rtol=1e-13,
                               atol=1e-13)


def test_beta_quantile_matches_jax_and_scipy(shapes):
    a, b, rng = shapes
    keep = b >= 0.3            # the small-q corner: see its own test
    a, b = a[keep], b[keep]
    prob = rng.uniform(0.01, 0.99, a.shape[0])
    got = tbeta.beta_quantile(a, b, prob).numpy()
    np.testing.assert_allclose(got, np.asarray(jbeta.beta_quantile(
        a, b, prob)), rtol=0, atol=1e-13)
    np.testing.assert_allclose(got, scipy.stats.beta.ppf(prob, a, b),
                               rtol=0, atol=1e-12)


def test_discrete_beta_matches_jax_over_a_grid():
    """One batched port call over the grid (as the M8 BEB makes it) against
    JAX's call per pair."""
    p, q = (a.ravel() for a in np.meshgrid(GRID, GRID, indexing="ij"))
    got = tbeta.discrete_beta(torch.tensor(p), torch.tensor(q), 10)
    assert got.shape == (len(p), 10) and got.dtype == torch.float64
    want = np.asarray(jax.jit(jax.vmap(
        lambda p_, q_: jbeta.discrete_beta(p_, q_, 10)))(p, q))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    # equal-probability bins of a distribution on (0, 1): increasing class
    # means whose average is the mean
    g = got.numpy()
    assert np.all(np.diff(g, axis=1) > 0) and np.all((g > 0) & (g < 1))
    np.testing.assert_allclose(g.mean(axis=1), p / (p + q), rtol=1e-12)
    # scalars give one row
    one = tbeta.discrete_beta(0.6, 1.5, 4)
    np.testing.assert_allclose(one.numpy(), np.asarray(
        jbeta.discrete_beta(0.6, 1.5, 4)), rtol=0, atol=1e-12)


JVP_PAIRS = [(0.3, 0.6), (0.6, 1.5), (1.5, 4.0), (4.0, 0.9), (12.0, 12.0)]
COT = np.linspace(0.5, 2.0, 6)


@pytest.fixture(scope="module")
def jax_jvps():
    """cot . d discrete_beta(p, q, 6) along p and along q, every pair in one
    compiled call."""
    def one(p, q):
        def along(dp, dq):
            _, t = jax.jvp(lambda a, b: jbeta.discrete_beta(a, b, 6),
                           (p, q), (dp, dq))
            return t @ COT
        return along(1.0, 0.0), along(0.0, 1.0)

    p, q = (jnp.asarray(v, jnp.float64) for v in zip(*JVP_PAIRS))
    gp, gq = jax.jit(jax.vmap(one))(p, q)
    return dict(zip(JVP_PAIRS, zip(np.asarray(gp), np.asarray(gq))))


@pytest.mark.parametrize("p,q", JVP_PAIRS)
def test_discrete_beta_gradient_matches_jax_jvp(jax_jvps, p, q):
    pt = torch.tensor(p, dtype=torch.float64, requires_grad=True)
    qt = torch.tensor(q, dtype=torch.float64, requires_grad=True)
    out = tbeta.discrete_beta(pt, qt, 6)
    gp, gq = torch.autograd.grad((out * torch.tensor(COT)).sum(), (pt, qt))
    want_p, want_q = jax_jvps[(p, q)]
    assert float(gp) == pytest.approx(float(want_p), rel=1e-8)
    assert float(gq) == pytest.approx(float(want_q), rel=1e-8)


def test_discrete_beta_gradient_batched_and_on_the_input_dtype():
    """A batch of pairs differentiates pair by pair; float32 inputs are
    computed in float64 and get float32 gradients."""
    p = torch.tensor([0.6, 1.5, 4.0], requires_grad=True)
    q = torch.tensor(0.9, dtype=torch.float32, requires_grad=True)
    out = tbeta.discrete_beta(p, q, 5)
    assert out.shape == (3, 5) and out.dtype == torch.float64
    out.sum().backward()
    assert p.grad.dtype == torch.float32 and p.grad.shape == (3,)
    assert q.grad.shape == ()
    for i in range(3):
        pi = torch.tensor(float(p[i].detach()), dtype=torch.float64,
                          requires_grad=True)
        qi = torch.tensor(float(q), dtype=torch.float64, requires_grad=True)
        tbeta.discrete_beta(pi, qi, 5).sum().backward()
        assert float(p.grad[i]) == pytest.approx(float(pi.grad), rel=1e-6)
    qi = torch.tensor(float(q), dtype=torch.float64, requires_grad=True)
    tbeta.discrete_beta(p.detach().double(), qi, 5).sum().backward()
    assert float(q.grad) == pytest.approx(float(qi.grad), rel=1e-6)


def test_small_q_corner_is_the_reference_scheme():
    """At q = 0.1 with p >= 2 the top bins' cuts lie within ~1e-10 of 1, and
    25 logit-space Newton steps leave the class means 3e-7 to 4e-6 from
    scipy's quantile in both packages alike (the JAX package's scheme,
    kept step for step)."""
    ps = np.array([2.0, 10.0, 20.0])
    got_all = tbeta.discrete_beta(torch.tensor(ps), 0.1, 10).numpy()
    ref_all = np.asarray(jax.jit(jax.vmap(
        lambda p_: jbeta.discrete_beta(p_, 0.1, 10)))(ps))
    for p, got, ref in zip(ps, got_all, ref_all):
        cuts = scipy.stats.beta.ppf(np.arange(1, 10) / 10, p, 0.1)
        up = scipy.special.betainc(p + 1.0, 0.1, cuts)
        exact = 10 * p / (p + 0.1) * (np.r_[up, 1.0] - np.r_[0.0, up])
        assert 1e-7 < np.max(np.abs(ref - exact)) < 1e-5
        assert np.max(np.abs(got - exact)) == pytest.approx(
            np.max(np.abs(ref - exact)), rel=1e-2)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)
