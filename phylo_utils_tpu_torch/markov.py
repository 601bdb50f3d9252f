"""Transition-matrix facade mirroring the reference's markov layer (PyTorch
port of ``phylo_utils_tpu.markov``).

``TransitionMatrix`` gives P(t) from the model's eigendecomposition,
dP/dt = Q P, d2P/dt2 = Q^2 P, the equilibrium frequencies, and row
sampling for simulation. It is a thin veneer over ``ops.pmatrix`` for users
migrating from the reference; the engine uses the function layer directly.
``t`` may be a scalar or any batch shape. Matrices are float64 on
``device`` unless ``dtype`` says otherwise; the randomness of
``sample_states`` is a ``torch.Generator`` where the JAX package takes a
key.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from phylo_utils_tpu_torch.models.base import Model
from phylo_utils_tpu_torch.ops.pmatrix import (
    d2p_matrices,
    dp_matrices,
    transition_matrices,
)

__all__ = ["TransitionMatrix", "sample_rows", "sample_cdf"]


def sample_cdf(generator: torch.Generator, cum: torch.Tensor
               ) -> torch.Tensor:
    """One state per row of ``cum`` (..., S), the float64 cumulative sums
    of unnormalized probability rows: an inverse CDF.

    u is uniform on (0, total], and the state is the count of the first
    S - 1 cumulative sums below u, so it lies in [0, S) by construction (no
    clamp) and a state of probability zero is never drawn.
    """
    u = 1.0 - torch.rand(cum.shape[:-1] + (1,), generator=generator,
                         dtype=torch.float64, device=cum.device)
    return (u * cum[..., -1:] > cum[..., :-1]).sum(dim=-1)


def sample_rows(generator: torch.Generator, rows: torch.Tensor
                ) -> torch.Tensor:
    """One state per row of ``rows`` (..., S), drawn with probability
    proportional to the row (``sample_cdf`` of its float64 cumsum)."""
    return sample_cdf(generator, torch.cumsum(rows.to(torch.float64), -1))


class TransitionMatrix:
    """P(t) evaluator for one model + parameter setting."""

    def __init__(self, model: Model, params: Optional[Mapping] = None,
                 dtype=torch.float64, device="cuda"):
        self.model = model
        self.params = params
        self.eigen = model.eigen(params, dtype=dtype, device=device)

    @property
    def freqs(self) -> torch.Tensor:
        """Equilibrium frequencies pi."""
        return self.eigen.freqs

    @property
    def q(self) -> torch.Tensor:
        """Normalized rate matrix (mean equilibrium rate 1)."""
        return self.eigen.q

    def _t(self, t) -> torch.Tensor:
        return torch.as_tensor(t, dtype=self.eigen.freqs.dtype,
                               device=self.eigen.freqs.device)

    def get_p_matrix(self, t) -> torch.Tensor:
        """P(t) = expm(Q t); t scalar or batched -> (..., S, S)."""
        return transition_matrices(self.eigen, self._t(t))

    def get_dp_matrix(self, t) -> torch.Tensor:
        """dP/dt = Q P(t)."""
        return dp_matrices(self.eigen, self._t(t))

    def get_d2p_matrix(self, t) -> torch.Tensor:
        """d2P/dt2 = Q^2 P(t)."""
        return d2p_matrices(self.eigen, self._t(t))

    def sample_states(self, generator: torch.Generator, parent_states,
                      t) -> torch.Tensor:
        """Draw child states from the P(t) rows of ``parent_states`` (the
        reference's weighted-choice simulation kernel, vectorized)."""
        p = self.get_p_matrix(t)
        parents = torch.as_tensor(parent_states, dtype=torch.long,
                                  device=p.device)
        return sample_rows(generator, p[parents, :])
