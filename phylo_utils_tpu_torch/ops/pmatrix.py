"""Batched transition matrices P(t) (PyTorch port of
``phylo_utils_tpu.ops.pmatrix``), forward only.

P(t) = V diag(e^{lambda t}) V^-1 for reversible models, through the
precomputed spectral modes ``Eigen.recon``; ``torch.linalg.matrix_exp`` for
non-reversible ones. ``t`` may have any batch shape (batch x edges x rate
categories); the whole batch is one einsum. Float32 matrix products must
not run in TF32: the engine turns TF32 off for every CUDA device it uses.
"""
from __future__ import annotations

import torch

from phylo_utils_tpu_torch.models.base import Eigen, eigen_reversible

__all__ = [
    "transition_matrices",
    "p_matrices_reversible",
    "extend_p_identity",
]


def extend_p_identity(p: torch.Tensor, n_total: int) -> torch.Tensor:
    """Append exact-identity P blocks for binarization pseudo-nodes.

    ``trees.compile_schedule(binarize=True)`` splits multifurcations into
    binary combines through pseudo-nodes (ids >= n_real). Their "edge" is a
    structural zero-length connection whose transition matrix is the EXACT
    identity, so the pruning product through a pseudo-node is a bit-exact
    pass-through.

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


def p_matrices_reversible(sym: torch.Tensor, freqs: torch.Tensor,
                          t: torch.Tensor) -> torch.Tensor:
    """P(t) = expm(Q(sym, freqs) * t) for reversible models, batched over t.

    Forward only: the JAX package's Daleckii-Krein derivative becomes a
    reverse-mode rule in ROADMAP A5; ``eigen_reversible`` raises for inputs
    that require grad.
    """
    return transition_matrices(eigen_reversible(sym, freqs), t)
