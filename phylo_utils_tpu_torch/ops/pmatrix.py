"""Batched transition matrices P(t) and their time-derivatives (PyTorch port
of ``phylo_utils_tpu.ops.pmatrix``).

P(t) = V diag(e^{lambda t}) V^-1 for reversible models, through the
precomputed spectral modes ``Eigen.recon``; ``torch.linalg.matrix_exp`` for
non-reversible ones. ``t`` may have any batch shape (batch x edges x rate
categories); the whole batch is one einsum. Float32 matrix products must
not run in TF32: the engine turns TF32 off for every CUDA device it uses.

``p_matrices_reversible`` is differentiable in (sym, freqs, t) through the
reverse-mode form of the JAX package's Daleckii-Krein derivative, which is
exact and smooth through degenerate eigenvalues (JC69, K80, F81).

A stack of models (one a locus of a partitioned analysis) is an ``Eigen``
whose fields have a leading model dim G (``eigen_reversible`` of (G, S, S)
exchangeabilities) with times ``t`` (G, ...): both functions then give each
model its own times' P, (G, ..., S, S), in one batched product.
"""
from __future__ import annotations

import torch

from phylo_utils_tpu_torch.models.base import (
    Eigen,
    build_rate_matrix,
    eigen_reversible,
)
from phylo_utils_tpu_torch.ops.pruning import first_derivative_only

__all__ = [
    "transition_matrices",
    "dp_matrices",
    "d2p_matrices",
    "p_matrices_reversible",
    "extend_p_identity",
]


def extend_p_identity(p: torch.Tensor, n_total: int) -> torch.Tensor:
    """Append exact-identity P blocks for binarization pseudo-nodes.

    ``trees.compile_schedule(binarize=True)`` splits multifurcations into
    binary combines through pseudo-nodes (ids >= n_real). Their "edge" is a
    structural zero-length connection whose transition matrix is the EXACT
    identity, so the pruning product through a pseudo-node is a bit-exact
    pass-through; the appended blocks are constants and take no gradient.

    ``p``: (..., n_real, K, S, S) -> (..., n_total, K, S, S).
    """
    extra = n_total - p.shape[-4]
    if extra <= 0:
        return p
    s = p.shape[-1]
    eye = torch.eye(s, dtype=p.dtype, device=p.device).expand(
        p.shape[:-4] + (extra,) + p.shape[-3:]
    )
    return torch.cat([p, eye], dim=-4)


def transition_matrices(eig: Eigen, t: torch.Tensor,
                        out_dtype=None) -> torch.Tensor:
    """P(t) for a batch of times. t: (...,) -> P: (..., S, S); for a stack
    of models (``eig``'s fields (G, ...)), t: (G, ...) -> (G, ..., S, S).

    ``out_dtype``: dtype of the RECONSTRUCT step (and the returned P). The
    eigenvalue exponentials e^{lambda t} stay in ``t``'s dtype (f64 under
    the precision plan: a biased e^{lambda t} acts like a systematic
    branch-length perturbation across every site), while the spectral-mode
    product runs in ``out_dtype``, whose rounding is incoherent across P
    entries and vanishes in the pattern sum.
    """
    t = torch.as_tensor(t)
    tm = _model_times(eig, t)                               # (..., M)
    if eig.evals is None:
        qt = eig.q[..., None, :, :] * tm[..., None, None]
        # f32 scaling-and-squaring can round tiny entries negative too
        p = torch.linalg.matrix_exp(qt).clamp_min(0.0)
        p = p if out_dtype is None else p.to(out_dtype)
        return p.reshape(t.shape + p.shape[-2:])
    ew = torch.exp(eig.evals[..., None, :] * tm[..., None])  # (..., M, S)
    if eig.recon is not None:
        recon = eig.recon
        if out_dtype is not None:
            ew = ew.to(out_dtype)
            recon = recon.to(out_dtype)
        p = torch.einsum("...mk,...kij->...mij", ew, recon)
    else:
        p = torch.einsum("...ik,...mk,...kj->...mij", eig.evecs, ew,
                         eig.ivecs)
        if out_dtype is not None:
            p = p.to(out_dtype)
    # True transition probabilities are >= 0, but the reconstruction rounds
    # tiny off-diagonals slightly negative for near-zero t, which can flip
    # a site likelihood negative deep in the pruning product. Clamp.
    return p.clamp_min(0.0).reshape(t.shape + p.shape[-2:])


def _model_times(eig: Eigen, t: torch.Tensor) -> torch.Tensor:
    """``t`` flattened to (M,) times, or to (G, M) for a stack of G models
    (``eig.freqs`` (G, S)): model g's times in row g."""
    return t.reshape(eig.freqs.shape[:-1] + (-1,))


def _exp_divided_difference(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """phi(x, y) = (e^x - e^y)/(x - y), continuously extended to e^x at x==y.

    With d = (x - y)/2: e^{(x+y)/2} sinh(d)/d, by its series for small d and
    else as e^{max(x, y)} (1 - e^{-2|d|}) / (2|d|). The JAX package's
    e^{(x+y)/2} sinh(d) is 0 x inf = NaN once |d| > ~710 (a long branch
    times a fast rate category); this form cannot overflow for the
    non-positive eigenvalues of a rate matrix.
    """
    d = 0.5 * (x - y)
    mid = 0.5 * (x + y)
    ad = d.abs()
    small = ad < 1e-5
    safe = torch.where(small, torch.ones_like(ad), ad)
    series = torch.exp(mid) * (1.0 + d * d / 6.0 * (1.0 + d * d / 20.0))
    wide = torch.exp(mid + ad) * -torch.expm1(-2.0 * safe) / (2.0 * safe)
    return torch.where(small, series, wide)


class _ReversibleP(torch.autograd.Function):
    """P(t) = expm(Q t) with Q = ``q`` (the graph-carrying output of
    ``build_rate_matrix``); ``eig`` is its eigensystem, a constant. For a
    stack of models, ``q`` (G, S, S), ``t`` (G, ...) and ``eig``'s fields
    have a leading G, and each model's Q_bar sums over its own times.

    Backward is the adjoint of the Daleckii-Krein derivative the JAX package
    uses as its JVP, dP = V (Phi o (V^-1 dA V)) V^-1 with A = Q t and
    Phi_ij = phi(lambda_i t, lambda_j t):
        A_bar = V^-T (Phi o (V^T P_bar V^-T)) V^T,
        Q_bar = sum_batch t A_bar,   t_bar = sum_ij Q_ij A_bar_ij.
    Like the JAX JVP it passes the cotangent through the >= 0 clamp. The
    rule holds the eigensystem constant, which is exact for the first
    derivative only, so the backward refuses to be differentiated
    (``first_derivative_only``): a second derivative through Q would miss
    the eigensystem's own derivative.
    """

    @staticmethod
    def forward(ctx, q, t, eig):
        ctx.save_for_backward(t)
        ctx.eig = eig
        return transition_matrices(eig, t)

    @staticmethod
    @first_derivative_only
    def backward(ctx, p_bar):
        (t,) = ctx.saved_tensors
        eig = ctx.eig
        v, vi, lam = eig.evecs, eig.ivecs, eig.evals
        tm = _model_times(eig, t)                              # (..., M)
        pm = p_bar.reshape(tm.shape + p_bar.shape[-2:])        # (..., M, S, S)
        lt = lam[..., None, :] * tm[..., None]                 # (..., M, S)
        phi = _exp_divided_difference(lt[..., :, None], lt[..., None, :])
        # V^T P_bar V^-T
        m = torch.einsum("...ki,...mkl,...jl->...mij", v, pm, vi)
        a_bar = torch.einsum("...ki,...mkl,...jl->...mij", vi, phi * m, v)
        q_bar = t_bar = None
        if ctx.needs_input_grad[0]:
            q_bar = torch.einsum("...m,...mij->...ij", tm, a_bar)
        if ctx.needs_input_grad[1]:
            t_bar = torch.einsum("...ij,...mij->...m", eig.q,
                                 a_bar).reshape(t.shape)
        return q_bar, t_bar, None


def p_matrices_reversible(sym: torch.Tensor, freqs: torch.Tensor,
                          t: torch.Tensor) -> torch.Tensor:
    """P(t) = expm(Q(sym, freqs) * t) for reversible models, batched over t.

    Equal in value to ``transition_matrices(eigen_reversible(sym, freqs),
    t)``. Differentiable in ``sym``, ``freqs`` and ``t``: the eigensystem is
    a constant of the backward (``_ReversibleP``), and autograd carries
    Q_bar through ``build_rate_matrix``. Plain autograd through ``eigh``
    would have 1/(lambda_i - lambda_j) terms, wrong or NaN at degenerate
    eigenvalues. ``sym`` (G, S, S) and ``freqs`` (G, S) are a stack of G
    models, with ``t`` (G, ...): one batched ``eigh``, P (G, ..., S, S).
    """
    eig = eigen_reversible(sym.detach(), freqs.detach())
    t = torch.as_tensor(t, dtype=eig.evals.dtype, device=eig.evals.device)
    return _ReversibleP.apply(build_rate_matrix(sym, freqs), t, eig)


def dp_matrices(eig: Eigen, t: torch.Tensor) -> torch.Tensor:
    """dP/dt = Q P(t) (used by Newton branch-length optimization)."""
    p = transition_matrices(eig, t)
    return torch.einsum("ik,...kj->...ij", eig.q, p)


def d2p_matrices(eig: Eigen, t: torch.Tensor) -> torch.Tensor:
    """d2P/dt2 = Q^2 P(t)."""
    p = transition_matrices(eig, t)
    q2 = eig.q @ eig.q
    return torch.einsum("ik,...kj->...ij", q2, p)
