"""Discrete-beta omega classes (PyTorch port of ``phylo_utils_tpu.ops.beta``).

Used by the M7/M8 codon site models (Yang et al. 2000): site omega values
follow Beta(p, q) on (0, 1), discretized into ``ncat`` equal-probability
classes whose value is the within-bin mean, PAML codeml's scheme.

torch has no incomplete beta function (``torch.special`` has ``gammainc``
only), so ``betainc`` here is the standard continued fraction (DLMF 8.17.22)
evaluated by the modified Lentz algorithm, after the symmetry swap
I_x(p, q) = 1 - I_{1-x}(q, p) where x > (p + 1) / (p + q + 2), with the
same partial numerators, tiny-value guard and iteration cap (600) as
``jax.scipy.special.betainc``; it stops once every factor is within 2 ulps
of 1. ``beta_quantile``
keeps the JAX package's scheme step for step: 25 fixed Newton steps in
logit space from the clipped mean, steps clamped to +-4, dF/dy floored at
1e-300. Everything runs in float64 on the host with numpy (a Newton step
over a continued fraction is hundreds of tiny operations, each a launch on
a card); the results come back as float64 tensors on the caller's device.

``discrete_beta`` is a ``torch.autograd.Function`` whose derivative in p
and q is the JAX package's ``custom_jvp`` rule, central differences with
h = eps^(1/3) max(1, |x|) (JAX defines no derivative of ``betainc`` in its
shape parameters). It takes tensors of p and q of one shape and returns
that shape with ``ncat`` appended, so many (p, q) pairs are one call (the
M8 BEB grid's 100). It always computes in float64, where the JAX package
uses its inputs' dtype (ROADMAP C, deliberate port/JAX differences).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["betainc", "betaln", "beta_quantile", "discrete_beta"]

_EPS = float(np.finfo(np.float64).eps)
_SMALL = _EPS / 2.0               # Lentz's tiny-value guard
# the fraction stops once every factor is within 2 ulps of 1 (JAX's runs on
# until each factor is 1 to the last bit, which in float64 often never
# happens before its cap; the last few factors move the result by ulps)
_CF_TOL = 2.0 * _EPS
_VERY_SMALL = float(np.finfo(np.float64).tiny) * 2.0
_CF_ITERATIONS = 600
_NEWTON_STEPS = 25


def _lgamma(x: np.ndarray) -> np.ndarray:
    return torch.lgamma(torch.from_numpy(np.asarray(x, np.float64))).numpy()


def _betaln(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return _lgamma(a) + _lgamma(b) - _lgamma(a + b)


def _betainc(a, b, x) -> np.ndarray:
    """Regularized incomplete beta I_x(a, b), float64 numpy, broadcast."""
    a, b, x = np.broadcast_arrays(*(np.asarray(v, np.float64)
                                    for v in (a, b, x)))
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        fast = x < (a + 1.0) / (a + b + 2.0)
        a, b = np.where(fast, a, b), np.where(fast, b, a)
        xs = np.where(fast, x, 1.0 - x)
        # continued fraction b0 + a1/(b1 + a2/(b2 + ...)): b0 = 0, every
        # other b_n = 1; a1 = 1, then d_1, d_2, ... of DLMF 8.17.22
        h = np.full(a.shape, _SMALL)
        c = h.copy()
        d = np.zeros(a.shape)
        for it in range(1, _CF_ITERATIONS):
            m = (it - 1) // 2
            if it == 1:
                num = np.ones(a.shape)
            elif it % 2 == 0:
                num = (-(a + b) * xs / (a + 1.0) if m == 0 else
                       -(a + m) * (a + b + m) * xs
                       / ((a + 2.0 * m) * (a + 2.0 * m + 1.0)))
            else:
                num = m * (b - m) * xs / ((a + 2.0 * m - 1.0)
                                          * (a + 2.0 * m))
            c = 1.0 + num / c
            c = np.where(np.abs(c) < _SMALL, _SMALL, c)
            d = 1.0 + num * d
            d = np.where(np.abs(d) < _SMALL, _SMALL, d)
            d = 1.0 / d
            delta = c * d
            h = h * delta
            if not (np.abs(delta - 1.0) > _CF_TOL).any():
                break
        lb_small = _lgamma(b) - _lgamma(a + b)
        lb = _lgamma(a) + lb_small
        factor = np.where(
            a < _VERY_SMALL, np.exp(np.log1p(-xs) * b - lb_small),
            np.exp(np.log(xs) * a + np.log1p(-xs) * b - lb) / a)
        out = h * factor
        out = np.where(fast, out, 1.0 - out)
        a0, b0 = np.where(fast, a, b), np.where(fast, b, a)   # unswapped
        a_zero = (a0 == 0.0) | (b0 == np.inf)
        b_zero = (b0 == 0.0) | (a0 == np.inf)
        out = np.where((b_zero & (x != 1.0)) | (a_zero & (x == 0.0)), 0.0,
                       out)
        out = np.where((a_zero & (x != 0.0)) | (b_zero & (x == 1.0)), 1.0,
                       out)
        bad = ((a0 < 0) | (b0 < 0) | (x < 0) | (x > 1) | (a_zero & b_zero)
               | np.isnan(a0) | np.isnan(b0) | np.isnan(x))
        return np.where(bad, np.nan, out)


def _sigmoid(y):
    return 1.0 / (1.0 + np.exp(-y))        # XLA's logistic, bit for bit


def _log_sigmoid(y):
    return -np.logaddexp(0.0, -y)


def _beta_quantile(p, q, prob) -> np.ndarray:
    p, q, prob = np.broadcast_arrays(*(np.asarray(v, np.float64)
                                       for v in (p, q, prob)))
    x0 = np.clip(p / (p + q), 1e-12, 1.0 - 1e-12)
    y = np.log(x0) - np.log1p(-x0)
    lb = _betaln(p, q)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for _ in range(_NEWTON_STEPS):
            x = _sigmoid(y)
            f = _betainc(p, q, x) - prob
            # dF/dy = pdf(x) x (1 - x), the sigmoid's chain rule
            dfdy = np.exp((p - 1.0) * np.log(x) + (q - 1.0) * np.log1p(-x)
                          - lb + _log_sigmoid(y) + _log_sigmoid(-y))
            step = np.clip(f / np.maximum(dfdy, 1e-300), -4.0, 4.0)
            y = y - step
    return _sigmoid(y)


def _discrete_beta_means(p, q, ncat: int) -> np.ndarray:
    """Within-bin means of Beta(p, q) over ``ncat`` equal-probability bins,
    shape p.shape + (ncat,): E[X 1{a < X < b}] = mean (I_b(p+1, q) -
    I_a(p+1, q)), divided by the bin mass 1/ncat."""
    p = np.asarray(p, np.float64)[..., None]
    q = np.asarray(q, np.float64)[..., None]
    cuts = _beta_quantile(p, q, np.arange(1, ncat, dtype=np.float64) / ncat)
    upper = _betainc(p + 1.0, q, cuts)
    ones = np.ones(upper.shape[:-1] + (1,))
    hi = np.concatenate([upper, ones], axis=-1)
    lo = np.concatenate([np.zeros_like(ones), upper], axis=-1)
    return ncat * (p / (p + q)) * (hi - lo)


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float64).numpy()
    return np.asarray(v, np.float64)


def _device_of(*values):
    for v in values:
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def _out(array, *like) -> torch.Tensor:
    return torch.as_tensor(np.asarray(array, np.float64),
                           device=_device_of(*like))


def betainc(p, q, x) -> torch.Tensor:
    """Regularized incomplete beta function I_x(p, q), float64, broadcast
    over its arguments (tensors, arrays or numbers); no derivative."""
    return _out(_betainc(_host(p), _host(q), _host(x)), p, q, x)


def betaln(p, q) -> torch.Tensor:
    """log B(p, q) = lgamma(p) + lgamma(q) - lgamma(p + q), float64."""
    return _out(_betaln(_host(p), _host(q)), p, q)


def beta_quantile(p, q, prob) -> torch.Tensor:
    """Quantile of Beta(p, q): x in (0, 1) with betainc(p, q, x) = prob,
    float64, broadcast; no derivative."""
    return _out(_beta_quantile(_host(p), _host(q), _host(prob)), p, q, prob)


class _DiscreteBeta(torch.autograd.Function):
    """Forward: the bin means. Backward: the JAX package's jvp rule, central
    differences in p and q, evaluated in the forward pass in one batch with
    the means themselves."""

    @staticmethod
    def forward(ctx, p, q, ncat):
        pv, qv = np.broadcast_arrays(_host(p), _host(q))
        if not (ctx.needs_input_grad[0] or ctx.needs_input_grad[1]):
            return _out(_discrete_beta_means(pv, qv, ncat), p, q)
        hp = _EPS ** (1.0 / 3.0) * np.maximum(1.0, np.abs(pv))
        hq = _EPS ** (1.0 / 3.0) * np.maximum(1.0, np.abs(qv))
        means = _discrete_beta_means(
            np.stack([pv, pv + hp, pv - hp, pv, pv]),
            np.stack([qv, qv, qv, qv + hq, qv - hq]), ncat)
        dfdp = (means[1] - means[2]) / (2.0 * hp[..., None])
        dfdq = (means[3] - means[4]) / (2.0 * hq[..., None])
        ctx.save_for_backward(_out(dfdp, p, q), _out(dfdq, p, q))
        ctx.shapes = (p.shape, q.shape)
        return _out(means[0], p, q)

    @staticmethod
    def backward(ctx, grad):
        dfdp, dfdq = ctx.saved_tensors
        out = []
        for df, shape, need in zip((dfdp, dfdq), ctx.shapes,
                                   ctx.needs_input_grad[:2]):
            if not need:
                out.append(None)
                continue
            g = (grad.to(df.dtype) * df).sum(-1)
            # undo the broadcast of p against q
            while g.dim() > len(shape):
                g = g.sum(0)
            for i, n in enumerate(shape):
                if n == 1 and g.shape[i] != 1:
                    g = g.sum(i, keepdim=True)
            out.append(g)
        return out[0], out[1], None


def discrete_beta(p, q, ncat: int) -> torch.Tensor:
    """M7/M8-style discrete Beta(p, q) class values: ``ncat`` within-bin
    means (equal class weights 1/ncat, codeml's discretization), float64,
    shape broadcast(p, q).shape + (ncat,). Differentiable in tensor p and q
    (central differences, as the JAX package's ``custom_jvp``)."""
    device = _device_of(p, q)
    p_t = torch.as_tensor(p, dtype=torch.float64, device=device)
    q_t = torch.as_tensor(q, dtype=torch.float64, device=device)
    return _DiscreteBeta.apply(p_t, q_t, int(ncat))
