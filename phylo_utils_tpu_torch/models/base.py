"""Rate-matrix construction and reversible eigendecomposition (PyTorch).

Port of ``phylo_utils_tpu.models.base``: Q = S * diag(pi), diagonal =
-rowsum, normalized so the mean equilibrium rate is 1 (branch lengths in
expected substitutions/site); reversible models are diagonalized via the
pi^{1/2} symmetrization + ``eigh``, then de-symmetrized.

The S x S ``eigh`` always runs in float64 on the host (LAPACK through
``torch.linalg.eigh`` on CPU); the results are then cast to the caller's
dtype and moved to its device. The engine caches them by parameter value,
so the factorization is off the per-evaluation path. The factorization is
value-only: an input that requires grad raises instead of being silently
detached. Model-parameter gradients go through
``ops.pmatrix.p_matrices_reversible``, whose reverse rule holds the
eigensystem constant (non-reversible models: autograd through
``build_parts`` and ``torch.linalg.matrix_exp``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, NamedTuple, Optional, Tuple

import torch

__all__ = [
    "Eigen",
    "Model",
    "normalize_q",
    "build_rate_matrix",
    "eigen_reversible",
    "stationary_from_q",
]


class Eigen(NamedTuple):
    """Eigendecomposition of a (reversible) rate matrix Q = V diag(evals) Vi,
    plus the equilibrium frequencies. For non-reversible models ``evals`` is
    None and ``q`` is used directly with ``matrix_exp``."""

    evals: Optional[torch.Tensor]   # (S,)
    evecs: Optional[torch.Tensor]   # (S, S) = V
    ivecs: Optional[torch.Tensor]   # (S, S) = V^-1
    freqs: torch.Tensor             # (S,)
    q: torch.Tensor                 # (S, S) normalized rate matrix
    # recon[k, i, j] = V[i, k] * Vi[k, j], so P(t) = sum_k e^{lambda_k t}
    # recon[k]: one small (edges*cats, S) @ (S, S*S) product per evaluation.
    recon: Optional[torch.Tensor] = None


def _forward_only(*tensors: torch.Tensor) -> None:
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the eigendecomposition is value-only; differentiate through "
            "ops.pmatrix.p_matrices_reversible (the engine's uncached path)"
        )


def normalize_q(q: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Set diagonal to -rowsum and scale so -sum_i pi_i Q_ii == 1."""
    s = q.shape[-1]
    off = q * (1.0 - torch.eye(s, dtype=q.dtype, device=q.device))
    q = off - torch.diag(off.sum(dim=1))
    scale = -(freqs * torch.diagonal(q)).sum()
    return q / scale


def build_rate_matrix(sym_rates: torch.Tensor,
                      freqs: torch.Tensor) -> torch.Tensor:
    """Q from symmetric exchangeabilities S and frequencies pi (normalized)."""
    return normalize_q(sym_rates * freqs[None, :], freqs)


def eigen_reversible(sym_rates: torch.Tensor, freqs: torch.Tensor) -> Eigen:
    """Diagonalize the reversible Q via similarity to a symmetric matrix.

    B = diag(sqrt(pi)) Q diag(1/sqrt(pi)) is symmetric for reversible Q;
    eigh(B) -> (w, U); V = diag(1/sqrt(pi)) U, V^-1 = U^T diag(sqrt(pi)).
    Computed in float64 on the host; returned in ``sym_rates``' dtype on its
    device.
    """
    _forward_only(sym_rates, freqs)
    dtype, device = sym_rates.dtype, sym_rates.device
    sym = sym_rates.to("cpu", torch.float64)
    pi = freqs.to("cpu", torch.float64)
    q = build_rate_matrix(sym, pi)
    sqrtp = torch.sqrt(pi)
    b = (sqrtp[:, None] * q) / sqrtp[None, :]
    b = 0.5 * (b + b.T)  # exact symmetry against rounding
    w, u = torch.linalg.eigh(b)
    v = u / sqrtp[:, None]
    vi = u.T * sqrtp[None, :]
    recon = v.T[:, :, None] * vi[:, None, :]       # (S modes, S, S)
    out = [x.to(device=device, dtype=dtype) for x in (w, v, vi, pi, q, recon)]
    return Eigen(evals=out[0], evecs=out[1], ivecs=out[2], freqs=out[3],
                 q=out[4], recon=out[5])


def stationary_from_q(q: torch.Tensor) -> torch.Tensor:
    """Stationary distribution of a general rate matrix: solve pi Q = 0,
    sum(pi) = 1 via a bordered least-squares system."""
    s = q.shape[-1]
    a = torch.cat([q.T, torch.ones((1, s), dtype=q.dtype, device=q.device)])
    b = torch.cat([torch.zeros((s,), dtype=q.dtype, device=q.device),
                   torch.ones((1,), dtype=q.dtype, device=q.device)])
    return torch.linalg.lstsq(a, b[:, None]).solution[:, 0]


@dataclasses.dataclass(frozen=True)
class Model:
    """A substitution model spec.

    ``build`` maps keyword parameter tensors to either ``(sym_rates, freqs)``
    for reversible models, or a raw (normalized) ``q`` with its stationary
    ``freqs`` for non-reversible ones.
    """

    name: str
    n_states: int
    alphabet: str                      # "dna" | "protein" | ...
    param_defaults: Mapping[str, object]
    build: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    reversible: bool = True

    def defaults(self, dtype=torch.float64, device="cpu") -> dict:
        return {
            k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in self.param_defaults.items()
        }

    def build_parts(
        self, params: Optional[Mapping] = None, dtype=torch.float64,
        device="cpu",
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sym_rates, freqs) for reversible models; (Q, freqs) otherwise."""
        merged = dict(self.param_defaults)
        if params:
            merged.update(params)
        kw = {k: torch.as_tensor(v, dtype=dtype, device=device)
              for k, v in merged.items()}
        a, b = self.build(**kw)
        return (a.to(device=device, dtype=dtype),
                b.to(device=device, dtype=dtype))

    def eigen(self, params: Optional[Mapping] = None, dtype=torch.float64,
              device="cpu") -> Eigen:
        """Parameters -> Eigen (or matrix_exp-ready Q for non-reversible),
        factorized in float64 on the host, returned in ``dtype`` on
        ``device``."""
        if params:
            _forward_only(*(torch.as_tensor(v) for v in params.values()))
        if self.reversible:
            sym, freqs = self.build_parts(params, torch.float64, "cpu")
            eig = eigen_reversible(sym, freqs)
            return Eigen(*(None if x is None else
                           x.to(device=device, dtype=dtype) for x in eig))
        q, freqs = self.build_parts(params, torch.float64, "cpu")
        return Eigen(evals=None, evecs=None, ivecs=None,
                     freqs=freqs.to(device=device, dtype=dtype),
                     q=q.to(device=device, dtype=dtype))
