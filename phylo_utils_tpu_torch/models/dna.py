"""DNA substitution models (state order A, C, G, T), PyTorch port of
``phylo_utils_tpu.models.dna``: JC69/K80/F81/F84/HKY85/TN93/GTR and the
non-reversible UNREST.

Transitions are A<->G (indices 0,2) and C<->T (indices 1,3). Each builder
takes 0-d or 1-d parameter tensors (one dtype and device) and returns
tensors on the same device.
"""
from __future__ import annotations

import torch

from phylo_utils_tpu_torch.models.base import (
    Model,
    normalize_q,
    stationary_from_q,
)

_QUARTER = (0.25, 0.25, 0.25, 0.25)


def _sym_from_six(ac, ag, at, cg, ct, gt):
    z = torch.zeros_like(ac)
    return torch.stack([
        torch.stack([z, ac, ag, at]),
        torch.stack([ac, z, cg, ct]),
        torch.stack([ag, cg, z, gt]),
        torch.stack([at, ct, gt, z]),
    ])


def _jc69_build():
    one = torch.ones((), dtype=torch.float64)
    s = _sym_from_six(one, one, one, one, one, one)
    return s, torch.full((4,), 0.25, dtype=s.dtype)


def _k80_build(kappa):
    one = torch.ones_like(kappa)
    s = _sym_from_six(one, kappa, one, one, kappa, one)
    return s, torch.full((4,), 0.25, dtype=kappa.dtype, device=kappa.device)


def _f81_build(freqs):
    return torch.ones((4, 4), dtype=freqs.dtype, device=freqs.device), freqs


def _hky85_build(kappa, freqs):
    one = torch.ones_like(kappa)
    return _sym_from_six(one, kappa, one, one, kappa, one), freqs


def _f84_build(kappa, freqs):
    pur = freqs[0] + freqs[2]
    pyr = freqs[1] + freqs[3]
    one = torch.ones_like(kappa)
    s = _sym_from_six(one, one + kappa / pur, one, one, one + kappa / pyr, one)
    return s, freqs


def _tn93_build(alpha1, alpha2, beta, freqs):
    return _sym_from_six(beta, alpha1, beta, beta, alpha2, beta), freqs


def _gtr_build(rates, freqs):
    return _sym_from_six(*rates.unbind()), freqs


def _unrest_build(rates):
    """12 off-diagonal rates, row-major (q_AC,q_AG,q_AT, q_CA,q_CG,q_CT,
    q_GA,q_GC,q_GT, q_TA,q_TC,q_TG). Returns (normalized Q, stationary pi)."""
    r = rates.unbind()
    z = torch.zeros_like(r[0])
    q = torch.stack([
        torch.stack([z, r[0], r[1], r[2]]),
        torch.stack([r[3], z, r[4], r[5]]),
        torch.stack([r[6], r[7], z, r[8]]),
        torch.stack([r[9], r[10], r[11], z]),
    ])
    q = q - torch.diag(q.sum(dim=1))
    pi = stationary_from_q(q)
    return normalize_q(q, pi), pi


JC69 = Model("JC69", 4, "dna", {}, _jc69_build)
K80 = Model("K80", 4, "dna", {"kappa": 2.0}, _k80_build)
F81 = Model("F81", 4, "dna", {"freqs": _QUARTER}, _f81_build)
F84 = Model("F84", 4, "dna", {"kappa": 1.0, "freqs": _QUARTER}, _f84_build)
HKY85 = Model("HKY85", 4, "dna", {"kappa": 2.0, "freqs": _QUARTER}, _hky85_build)
TN93 = Model(
    "TN93", 4, "dna",
    {"alpha1": 2.0, "alpha2": 2.0, "beta": 1.0, "freqs": _QUARTER},
    _tn93_build,
)
GTR = Model(
    "GTR", 4, "dna",
    {"rates": (1.0,) * 6, "freqs": _QUARTER},
    _gtr_build,
)
UNREST = Model("UNREST", 4, "dna", {"rates": (1.0,) * 12}, _unrest_build,
               reversible=False)
