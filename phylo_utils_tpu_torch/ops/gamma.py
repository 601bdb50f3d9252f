"""Discrete-gamma rate heterogeneity (PyTorch port of
``phylo_utils_tpu.ops.gamma``), forward only.

PAML's Yang (1994) discretization: category boundaries from the gamma
quantile function (Wilson-Hilferty start + 12 Newton steps in log space),
category means from the regularized incomplete gamma at shape alpha+1.
Run it in float64.

``torch.special.gammainc`` is off by up to ~1e-9 relative at shape ~50
(measured against mpmath on torch 2.13 CPU), which moves the alpha = 50
rates by ~1e-11; ``gammainc`` below (series / continued fraction, as in
Numerical Recipes ``gser``/``gcf``) stays at f64 roundoff. Those need
~9 sqrt(a) terms near x = a, so shapes from 1e4 up use a 32-point
Gauss-Legendre quadrature of the integrand instead (as Numerical Recipes'
``gammpapprox`` does with 18 points), within ~2e-10 of scipy up to shape
1e6. Everything is plain torch arithmetic, so autograd gives
d(rates)/d(alpha) (it matches ``jax.jacfwd`` of the JAX function).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["gammainc", "gamma_quantile", "discrete_gamma"]

_TINY = 1e-300
_EPS = 2.0 ** -53
_MAX_TERMS = 2000
_CHECK_EVERY = 16
_QUAD_SHAPE = 1e4      # shapes from here on take the quadrature
_GL_NODES, _GL_WEIGHTS = np.polynomial.legendre.leggauss(32)


def _gamma_series(a, x):
    """sum_{n>=0} x^n / ((a+1)...(a+n)) / a, the P(a, x) series without its
    prefactor x^a e^-x / Gamma(a); converges fast for x < a + 1."""
    term = 1.0 / a
    total = term
    ap = a
    for n in range(1, _MAX_TERMS + 1):
        ap = ap + 1.0
        term = term * x / ap
        total = total + term
        if n % _CHECK_EVERY == 0 and bool(
                (term.abs() <= total.abs() * _EPS).all()):
            return total
    raise ArithmeticError("incomplete-gamma series did not converge")


def _gamma_cfrac(a, x):
    """Continued fraction (modified Lentz) for Q(a, x) without its prefactor;
    converges fast for x >= a + 1."""
    b = x + 1.0 - a
    c = torch.full_like(x, 1.0 / _TINY)
    d = 1.0 / b
    h = d
    for i in range(1, _MAX_TERMS + 1):
        an = -i * (i - a)
        b = b + 2.0
        d = an * d + b
        d = torch.where(d.abs() < _TINY, torch.full_like(d, _TINY), d)
        c = b + an / c
        c = torch.where(c.abs() < _TINY, torch.full_like(c, _TINY), c)
        d = 1.0 / d
        delta = d * c
        h = h * delta
        if i % _CHECK_EVERY == 0 and bool(
                ((delta - 1.0).abs() <= 4 * _EPS).all()):
            return h
    raise ArithmeticError("incomplete-gamma continued fraction did not "
                          "converge")


def _gamma_quadrature(a, x):
    """P(a, x) for large a: the integral of t^(a-1) e^-t / Gamma(a) from x
    to a point ~12 standard deviations beyond the mode (a - 1), by 32-point
    Gauss-Legendre quadrature, the integrand written around the mode with
    ``log1p`` so no large terms cancel."""
    a1 = a - 1.0
    sq = torch.sqrt(a1)
    upper = x > a1
    xu = torch.where(upper, torch.maximum(a1 + 11.5 * sq, x + 6.0 * sq),
                     torch.clamp(torch.minimum(a1 - 7.5 * sq, x - 5.0 * sq),
                                 min=0.0))
    nodes = torch.as_tensor(0.5 * (_GL_NODES + 1.0), dtype=x.dtype,
                            device=x.device)
    weights = torch.as_tensor(0.5 * _GL_WEIGHTS, dtype=x.dtype,
                              device=x.device)
    t = x[..., None] + (xu - x)[..., None] * nodes
    u = (t - a1[..., None]) / a1[..., None]
    integrand = torch.exp(a1[..., None] * (torch.log1p(u) - u))
    # Gamma(a) = a1^a1 e^-a1 Gamma(a) / (a1^a1 e^-a1): the prefactor of
    # the integrand written around the mode
    log_norm = a1 * torch.log(a1) - a1 - torch.lgamma(a)
    part = (integrand * weights).sum(-1) * (xu - x) * torch.exp(log_norm)
    # part = integral from x to xu: Q(a, x) above the mode, -P(a, x) below
    return torch.where(upper, 1.0 - part, -part)


def gammainc(a, x) -> torch.Tensor:
    """Regularized lower incomplete gamma P(a, x) (a > 0, x >= 0), float64:
    accurate to roundoff below shape 1e4, to ~2e-10 absolute above (the
    quadrature); ``a`` and ``x`` broadcast."""
    a, x = torch.broadcast_tensors(torch.as_tensor(a), torch.as_tensor(x))
    pos = x > 0
    xs = torch.where(pos, x, torch.ones_like(x))
    log_pre = a * torch.log(xs) - xs - torch.lgamma(a)
    quad = a >= _QUAD_SHAPE
    series = (xs < a + 1.0) & ~quad
    frac = ~(series | quad)
    out = torch.zeros_like(xs)
    if bool(quad.any()):
        out[quad] = _gamma_quadrature(a[quad], xs[quad])
    if bool(series.any()):
        p = _gamma_series(a[series], xs[series]) * torch.exp(log_pre[series])
        out[series] = p
    if bool(frac.any()):
        q = _gamma_cfrac(a[frac], xs[frac]) * torch.exp(log_pre[frac])
        out[frac] = 1.0 - q
    return torch.where(pos, out, torch.zeros_like(out))


def gamma_quantile(a, q) -> torch.Tensor:
    """Quantile of Gamma(shape=a, scale=1): x with gammainc(a, x) = q.

    Wilson-Hilferty init + Newton in log space (always-positive iterates,
    quadratic convergence); 12 iterations reach f64 roundoff with margin.
    ``a`` and ``q`` broadcast against each other.
    """
    a, q = torch.broadcast_tensors(torch.as_tensor(a), torch.as_tensor(q))
    z = torch.special.ndtri(q)
    wh = a * (1.0 - 1.0 / (9.0 * a) + z / (3.0 * torch.sqrt(a))) ** 3
    # Wilson-Hilferty can go nonpositive for small a; fall back to the
    # small-shape asymptote x ~ (q * Gamma(a+1))^(1/a).
    small = torch.exp((torch.log(q) + torch.lgamma(a + 1.0)) / a)
    x0 = torch.where(wh > 1e-300, wh, small).clamp_min(1e-300)
    y = torch.log(x0)
    lgamma_a = torch.lgamma(a)
    for _ in range(12):
        x = torch.exp(y)
        f = gammainc(a, x) - q
        # dF/dy = pdf(x) * x
        dfdy = torch.exp((a - 1.0) * torch.log(x) - x - lgamma_a + y)
        step = (f / dfdy.clamp_min(1e-300)).clamp(-4.0, 4.0)
        y = y - step
    return torch.exp(y)


def discrete_gamma(alpha, ncat: int, median: bool = False) -> torch.Tensor:
    """PAML-style discrete gamma category rates, mean 1 (Yang 1994).

    ``alpha``: 0-d tensor or float (a float becomes float64 on the CPU),
    or a tensor (...,) of shapes, one per locus of a stack. Returns
    (..., ncat) rates in ``alpha``'s dtype and device.
    """
    alpha = torch.as_tensor(alpha)
    if not alpha.is_floating_point():
        alpha = alpha.to(torch.float64)
    dtype, device = alpha.dtype, alpha.device
    edge = alpha.shape + (1,)      # one bin edge of every alpha
    if ncat == 1:
        return torch.ones(edge, dtype=dtype, device=device)
    alpha = alpha[..., None]       # against the categories
    if median:
        qs = (2.0 * torch.arange(ncat, dtype=dtype, device=device) + 1.0) / (
            2.0 * ncat
        )
        rates = gamma_quantile(alpha, qs) / alpha
        return rates * (ncat / rates.sum(dim=-1, keepdim=True))
    qs = torch.arange(1, ncat, dtype=dtype, device=device) / ncat
    cuts = gamma_quantile(alpha, qs) / alpha  # quantiles of Gamma(a, rate=a)
    # mean-in-bin via regularized incomplete gamma at shape alpha+1:
    # E[X 1{a<X<b}] = I(alpha+1, alpha*b) - I(alpha+1, alpha*a) for rate=alpha
    upper = gammainc(alpha + 1.0, cuts * alpha)
    hi = torch.cat([upper, torch.ones(edge, dtype=dtype, device=device)], -1)
    lo = torch.cat([torch.zeros(edge, dtype=dtype, device=device), upper], -1)
    return ncat * (hi - lo)
