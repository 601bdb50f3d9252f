"""Felsenstein pruning as a level-scheduled, batched PyTorch computation
(port of ``phylo_utils_tpu.ops.pruning``; the ``pruner="torch"`` path).

Each level of the schedule combines ALL its nodes for ALL rate categories
(and any leading batch) in one einsum over (width x children x categories x
sites x states), with per-(category, site) rescaling. Float32 partials are
rescaled by exact powers of two with integer exponent counts, so the port's
node partials and logscales match the JAX package's bit for bit up to the
rounding of the contraction itself.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from phylo_utils_tpu_torch.trees import PruningSchedule

__all__ = [
    "make_prune_fn",
    "mixture_loglik",
    "mixture_loglik_from_ll",
    "invariant_site_likelihood",
    "pow2_rescale",
    "exp2_int",
    "LN2",
]

LN2 = math.log(2.0)


def pow2_rescale(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """EXACT power-of-two rescale of a positive f32 tensor.

    Returns ``(scale, e)`` with ``scale = 2**-e`` bit-assembled from m's
    binary exponent (``e = floor(log2(m))``), so ``x * scale`` is an exact
    f32 operation and the accumulated exponents are exact small integers
    (stored in f32; adds are exact below 2^24). The exponent field is
    clamped to [1, 253] so both ``scale`` and ``2**e`` stay normal.
    """
    bits = m.view(torch.int32)
    eb = ((bits >> 23) & 0xFF).clamp(1, 253)
    scale = ((254 - eb) << 23).view(torch.float32)
    return scale, (eb - 127).to(torch.float32)


def exp2_int(k: torch.Tensor) -> torch.Tensor:
    """Exact ``2**k`` for an integer-VALUED f32 tensor (bit assembly)."""
    ki = k.clamp(-126.0, 127.0).to(torch.int32)
    return ((ki + 127) << 23).view(torch.float32)


def make_prune_fn(
    schedule: PruningSchedule,
) -> Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Compile a pruning schedule into a function of tensors.

    Returns ``prune(p_matrices, leaf_partials) -> (root_partials,
    root_logscale)`` with shapes:

    - ``p_matrices``    (..., n_nodes, K, S, S) — P for the edge above each
      node (root row unused); leading dims are a batch,
    - ``leaf_partials`` (n_leaves, sites, S),
    - ``root_partials`` (..., K, sites, S), ``root_logscale`` (..., K, sites)
      in ln units.
    """
    n_nodes = schedule.n_nodes
    n_leaves = schedule.n_leaves
    root = schedule.root
    levels = [
        (torch.from_numpy(np.asarray(schedule.level_nodes[lvl], np.int64)),
         torch.from_numpy(np.asarray(schedule.level_children[lvl], np.int64)),
         torch.from_numpy(np.asarray(schedule.level_childmask[lvl])))
        for lvl in range(schedule.n_levels)
    ]

    def prune(p_matrices: torch.Tensor, leaf_partials: torch.Tensor):
        dtype, device = leaf_partials.dtype, leaf_partials.device
        batch = tuple(p_matrices.shape[:-4])
        k = p_matrices.shape[-3]
        sites, s = leaf_partials.shape[1], leaf_partials.shape[2]
        tiny = torch.finfo(dtype).tiny
        nb = len(batch)
        p_nodes = p_matrices.movedim(-4, 0).to(dtype)   # (n_nodes, ..., K, S, S)

        # buffer rows: [leaves | internals | trash]; batch and categories
        # broadcast at leaves
        buf = leaf_partials.new_zeros((n_nodes + 1,) + batch + (k, sites, s))
        buf[:n_leaves] = leaf_partials.reshape(
            (n_leaves,) + (1,) * (nb + 1) + (sites, s)
        )
        logscale = leaf_partials.new_zeros((n_nodes + 1,) + batch + (k, sites))

        for nodes, children, mask in levels:
            nodes, children = nodes.to(device), children.to(device)
            mask = mask.to(device=device, dtype=dtype)
            child_p = buf[children]          # (W, C, ..., K, sites, S)
            child_sc = logscale[children]    # (W, C, ..., K, sites)
            p = p_nodes[children]            # (W, C, ..., K, S, S)
            contrib = torch.einsum("...ij,...sj->...si", p, child_p)
            mask_b = mask.reshape(mask.shape + (1,) * (nb + 3))
            contrib = contrib * mask_b + (1.0 - mask_b)
            partial = contrib.prod(dim=1)                        # (W, ..., K, sites, S)
            sc = (child_sc * mask.reshape(mask.shape + (1,) * (nb + 2))).sum(1)
            m = partial.amax(dim=-1).clamp_min(tiny)
            if dtype == torch.float32:
                # exact power-of-2 rescale: logscale accumulates binary
                # EXPONENT COUNTS, converted to ln units once at the root
                scale, e = pow2_rescale(m)
                partial = partial * scale[..., None]
                sc = sc + e
            else:
                partial = partial / m[..., None]
                sc = sc + torch.log(m)
            buf[nodes] = partial
            logscale[nodes] = sc
        root_sc = logscale[root]
        if dtype == torch.float32:
            root_sc = (root_sc.to(torch.float64) * LN2).to(dtype)
        return buf[root], root_sc

    return prune


def invariant_site_likelihood(leaf_partials: torch.Tensor,
                              freqs: torch.Tensor) -> torch.Tensor:
    """Per-site likelihood of the zero-rate (invariant) component:
    sum_i pi_i * prod_leaves leaf_partials[l, s, i]. (sites,)"""
    prod = leaf_partials.prod(dim=0)  # (sites, S)
    return prod @ freqs.to(prod.dtype)


def mixture_loglik(
    root_partials: torch.Tensor,     # (..., K, sites, S)
    root_logscale: torch.Tensor,     # (..., K, sites)
    freqs: torch.Tensor,             # (S,)
    cat_weights: torch.Tensor,       # (K,)
    pattern_weights: torch.Tensor,   # (sites,)
    pinv: Optional[torch.Tensor] = None,
    inv_lik: Optional[torch.Tensor] = None,   # (sites,) required with pinv
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Root reduction + rate-category mixing with scale re-alignment:
    L_s = pinv*I_s + (1-pinv)*sum_c w_c L_{s,c}. Leading dims are a batch.

    Returns (total_loglik (...,), sitewise_loglik (..., sites)).
    """
    dtype = root_partials.dtype
    site_lik = torch.einsum("...ksi,i->...ks", root_partials, freqs.to(dtype))
    m = root_logscale.amax(dim=-2)  # (..., sites)
    mixed = (
        cat_weights[:, None].to(dtype)
        * site_lik
        * torch.exp(root_logscale - m[..., None, :])
    ).sum(dim=-2)
    log_var = torch.log(mixed) + m
    if pinv is not None:
        sitewise = _mix_invariant(log_var, pinv, inv_lik, dtype)
    else:
        sitewise = log_var
    total = (pattern_weights.to(dtype) * sitewise).sum(dim=-1)
    return total, sitewise


def _mix_invariant(log_var, pinv, inv_lik, dtype):
    """+I mixing in log space: L_s = pinv*I_s + (1-pinv)*L_var,s."""
    if inv_lik is None:
        raise ValueError("inv_lik is required when pinv is given")
    pinv = torch.as_tensor(pinv, dtype=dtype, device=log_var.device)
    # variable sites have inv_lik == 0: their +I component is exactly -inf
    # in log space (clamping to `tiny` would floor sitewise logL at
    # log(pinv) + log(tiny)).
    inv_lik = inv_lik.to(dtype)
    log_inv = torch.where(
        inv_lik > 0,
        torch.log(torch.where(inv_lik > 0, inv_lik, torch.ones_like(inv_lik))),
        torch.full_like(inv_lik, -math.inf),
    )
    return torch.logaddexp(
        torch.log1p(-pinv) + log_var, torch.log(pinv) + log_inv
    )


def mixture_loglik_from_ll(
    ll: torch.Tensor,                # (..., K, sites) per-category logL
    cat_weights: torch.Tensor,       # (K,)
    pattern_weights: torch.Tensor,   # (sites,)
    pinv: Optional[torch.Tensor] = None,
    inv_lik: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Category mixing given per-category LOG likelihoods (fused-root path).

    Same semantics as ``mixture_loglik`` but starting from
    ``ll[..., k, s] = log L_{s|k}``: a weighted logsumexp over categories,
    optional +I, then the weighted pattern sum.
    """
    dtype = ll.dtype
    m = ll.amax(dim=-2)                                       # (..., sites)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # all--inf guard
    mixed = (
        cat_weights[:, None].to(dtype) * torch.exp(ll - m[..., None, :])
    ).sum(dim=-2)
    log_var = torch.log(mixed) + m
    if pinv is not None:
        sitewise = _mix_invariant(log_var, pinv, inv_lik, dtype)
    else:
        sitewise = log_var
    total = (pattern_weights.to(dtype) * sitewise).sum(dim=-1)
    return total, sitewise
