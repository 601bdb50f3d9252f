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
"""
from __future__ import annotations

import torch

from phylo_utils_tpu_torch.models.base import (
    Eigen,
    build_rate_matrix,
    eigen_reversible,
)

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
    """P(t) for a batch of times. t: (...,) -> P: (..., S, S).

    ``out_dtype``: dtype of the RECONSTRUCT step (and the returned P). The
    eigenvalue exponentials e^{lambda t} stay in ``t``'s dtype (f64 under
    the precision plan: a biased e^{lambda t} acts like a systematic
    branch-length perturbation across every site), while the spectral-mode
    product runs in ``out_dtype``, whose rounding is incoherent across P
    entries and vanishes in the pattern sum.
    """
    t = torch.as_tensor(t)
    if eig.evals is None:
        qt = eig.q * t[..., None, None]
        # f32 scaling-and-squaring can round tiny entries negative too
        p = torch.linalg.matrix_exp(qt).clamp_min(0.0)
        return p if out_dtype is None else p.to(out_dtype)
    ew = torch.exp(eig.evals * t[..., None])               # (..., S)
    if eig.recon is not None:
        recon = eig.recon
        if out_dtype is not None:
            ew = ew.to(out_dtype)
            recon = recon.to(out_dtype)
        p = torch.einsum("...k,kij->...ij", ew, recon)
    else:
        p = torch.einsum("ik,...k,kj->...ij", eig.evecs, ew, eig.ivecs)
        if out_dtype is not None:
            p = p.to(out_dtype)
    # True transition probabilities are >= 0, but the reconstruction rounds
    # tiny off-diagonals slightly negative for near-zero t, which can flip
    # a site likelihood negative deep in the pruning product. Clamp.
    return p.clamp_min(0.0)


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
    ``build_rate_matrix``); ``eig`` is its eigensystem, a constant.

    Backward is the adjoint of the Daleckii-Krein derivative the JAX package
    uses as its JVP, dP = V (Phi o (V^-1 dA V)) V^-1 with A = Q t and
    Phi_ij = phi(lambda_i t, lambda_j t):
        A_bar = V^-T (Phi o (V^T P_bar V^-T)) V^T,
        Q_bar = sum_batch t A_bar,   t_bar = sum_ij Q_ij A_bar_ij.
    Like the JAX JVP it passes the cotangent through the >= 0 clamp.
    """

    @staticmethod
    def forward(ctx, q, t, eig):
        ctx.save_for_backward(t)
        ctx.eig = eig
        return transition_matrices(eig, t)

    @staticmethod
    def backward(ctx, p_bar):
        (t,) = ctx.saved_tensors
        eig = ctx.eig
        v, vi, lam = eig.evecs, eig.ivecs, eig.evals
        lt = lam * t[..., None]                                # (..., S)
        phi = _exp_divided_difference(lt[..., :, None], lt[..., None, :])
        m = torch.einsum("ki,...kl,jl->...ij", v, p_bar, vi)   # V^T P_bar V^-T
        a_bar = torch.einsum("ki,...kl,jl->...ij", vi, phi * m, v)
        q_bar = t_bar = None
        if ctx.needs_input_grad[0]:
            q_bar = torch.einsum("...,...ij->ij", t, a_bar)
        if ctx.needs_input_grad[1]:
            t_bar = torch.einsum("ij,...ij->...", eig.q, a_bar)
        return q_bar, t_bar, None


def p_matrices_reversible(sym: torch.Tensor, freqs: torch.Tensor,
                          t: torch.Tensor) -> torch.Tensor:
    """P(t) = expm(Q(sym, freqs) * t) for reversible models, batched over t.

    Equal in value to ``transition_matrices(eigen_reversible(sym, freqs),
    t)``. Differentiable in ``sym``, ``freqs`` and ``t``: the eigensystem is
    a constant of the backward (``_ReversibleP``), and autograd carries
    Q_bar through ``build_rate_matrix``. Plain autograd through ``eigh``
    would have 1/(lambda_i - lambda_j) terms, wrong or NaN at degenerate
    eigenvalues.
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
