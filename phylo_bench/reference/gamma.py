"""Discrete gamma category rates (Yang 1994, category means), float64 by
``scipy.special``, differentiable in the shape: the derivative is a
central difference of the same function, exact to ~1e-10 relative."""
from __future__ import annotations

import numpy as np
import torch
from scipy.special import gammainc, gammaincinv

_STEP = 1e-5          # relative step of the central difference


def gamma_rates_np(alpha: float, ncat: int) -> np.ndarray:
    """(ncat,) rates of mean 1: the mean of each equal-probability bin of
    Gamma(shape alpha, rate alpha)."""
    if ncat == 1:
        return np.ones(1)
    cuts = gammaincinv(alpha, np.arange(1, ncat) / ncat) / alpha
    upper = np.append(gammainc(alpha + 1.0, cuts * alpha), 1.0)
    lower = np.insert(gammainc(alpha + 1.0, cuts * alpha), 0, 0.0)
    return ncat * (upper - lower)


class _GammaRates(torch.autograd.Function):
    @staticmethod
    def forward(ctx, alpha, ncat):
        a = float(alpha)
        ctx.ncat, ctx.alpha = ncat, a
        ctx.device = alpha.device
        return torch.as_tensor(gamma_rates_np(a, ncat), dtype=torch.float64,
                               device=alpha.device)

    @staticmethod
    def backward(ctx, grad):
        h = _STEP * ctx.alpha
        d = (gamma_rates_np(ctx.alpha + h, ctx.ncat)
             - gamma_rates_np(ctx.alpha - h, ctx.ncat)) / (2.0 * h)
        d = torch.as_tensor(d, dtype=grad.dtype, device=ctx.device)
        return (grad * d).sum(), None


def gamma_rates(alpha: torch.Tensor, ncat: int) -> torch.Tensor:
    """``gamma_rates_np`` of a 0-d float64 tensor, with autograd."""
    return _GammaRates.apply(alpha, ncat)
