"""Log-likelihood of weighted site patterns under a rooted tree, a
reversible model, discrete-gamma rates and an optional +I component, with
its gradient by autograd, in plain PyTorch.

L_s = pinv I_s + (1 - pinv) / K sum_k L_{s,k}, where L_{s,k} is the
pruning recursion under P(t r_k) = expm(Q t r_k) and I_s = pi_x when every
leaf shows state x at pattern s (else 0). Q_ij = S_ij pi_j off the
diagonal, rows sum to 0, scaled so that -sum_i pi_i Q_ii = 1. Each node's
partials are divided by their column maximum, held constant under autograd
(a constant scale leaves the derivative of the log unchanged), and the
logs of the maxima carried beside them.

The patterns are walked in blocks sized to ``budget_bytes`` of saved
tensors; each block's gradient flows into P, the frequencies and pinv,
and one last backward pass carries them to the parameters.

``precision="tf32"`` is the control: partials in float32, every operand of
the child contractions rounded to TF32 (10 explicit mantissa bits, to
nearest even) as a TF32 tensor-core product would take them, forward and
backward; P(t), the root reduction and the mixing as in float64.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from reference.gamma import gamma_rates
from reference.tree import RefTree

_SAVED_PER_CELL = 5     # tensors autograd keeps a node, at one (B, K, P, S)


def rate_matrix(sym: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """The normalized rate matrix of exchangeabilities ``sym`` (S, S) and
    frequencies ``freqs`` (S,)."""
    s = sym.shape[-1]
    off = sym * freqs[None, :] * (1.0 - torch.eye(s, dtype=sym.dtype,
                                                  device=sym.device))
    q = off - torch.diag(off.sum(dim=1))
    return q / -(freqs * torch.diagonal(q)).sum()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 explicit mantissa bits, to nearest
    even (finite values)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & -8192
    return bits.view(torch.float32)


class _Tf32(torch.autograd.Function):
    """``round_tf32`` forward; the gradient rounded the same way."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


class _Tf32MatMul(torch.autograd.Function):
    """``x @ w`` with every operand rounded to TF32, forward and backward."""

    @staticmethod
    def forward(ctx, x, w):
        x, w = round_tf32(x), round_tf32(w)
        ctx.save_for_backward(x, w)
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = round_tf32(g)
        return g @ w.transpose(-1, -2), x.transpose(-1, -2) @ g


def _mixed(tree: RefTree, pats: torch.Tensor, p: torch.Tensor,
           freqs: torch.Tensor, pinv: Optional[torch.Tensor],
           tf32: bool) -> torch.Tensor:
    """(B, Pb) site log-likelihoods of one block of patterns ``pats``
    (n_leaves, Pb); ``p`` (B, N, K, S, S) in the partials' dtype."""
    tiny = torch.finfo(p.dtype).tiny
    parts: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
    for node in tree.internal_postorder():
        acc, logscale = None, 0.0
        for c in tree.children[node]:
            pc = p[:, c]                                    # (B, K, S, S)
            if c < tree.n_leaves:
                src = _Tf32.apply(pc) if tf32 else pc
                y = src[..., pats[c]].transpose(-1, -2)     # (B, K, Pb, S)
            else:
                x, sc = parts.pop(c)
                y = (_Tf32MatMul.apply(x, pc.transpose(-1, -2)) if tf32
                     else x @ pc.transpose(-1, -2))
                logscale = logscale + sc
            acc = y if acc is None else acc * y
        m = acc.detach().amax(dim=-1, keepdim=True).clamp_min(tiny)
        parts[node] = (acc / m,
                       logscale + torch.log(m[..., 0]).to(torch.float64))
    x, logscale = parts[tree.root]
    ll = torch.log(x.to(torch.float64) @ freqs) + logscale       # (B, K, Pb)
    k = ll.shape[1]
    log_var = torch.logsumexp(ll, dim=1) - math.log(k)
    if pinv is None:
        return log_var
    first = pats[0]
    same = (pats == first).all(dim=0)
    inv = torch.where(same, freqs[first], torch.zeros_like(freqs[first]))
    return torch.logaddexp(torch.log(pinv) + torch.log(inv),
                           torch.log1p(-pinv) + log_var)


def loglik_and_grad(
    tree: RefTree,
    pats: torch.Tensor,
    weights: torch.Tensor,
    build: Callable[..., Tuple[torch.Tensor, torch.Tensor]],
    params: Mapping,
    ncat: int,
    want_grad: bool,
    precision: str = "f64",
    budget_bytes: float = 8e9,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """(totals (B,) float64, gradient of their sum or None).

    ``pats`` (n_leaves, P) int64 leaf states and ``weights`` (P,) on the
    device of the computation. ``params``: ``branch_lengths`` (B, N), one
    set a row, ``model`` (keyword arguments of ``build``, which returns
    exchangeabilities and frequencies), ``alpha`` where ``ncat`` > 1 and
    ``pinv`` for +I, each a float64 tensor. The gradient has the structure
    of ``params``; ``branch_lengths`` keeps a row a set, every other entry
    is summed over the sets.
    """
    if precision not in ("f64", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    tf32 = precision == "tf32"
    work = torch.float32 if tf32 else torch.float64
    dev = pats.device
    leaves = {"branch_lengths": params["branch_lengths"],
              **{f"model.{k}": v for k, v in params["model"].items()},
              **{k: params[k] for k in ("alpha", "pinv") if k in params}}
    leaves = {k: torch.as_tensor(v, dtype=torch.float64, device=dev)
              .detach().requires_grad_(want_grad) for k, v in leaves.items()}
    with torch.set_grad_enabled(want_grad):
        sym, freqs = build(**{k[6:]: v for k, v in leaves.items()
                              if k.startswith("model.")})
        q = rate_matrix(sym, freqs)
        rates = (gamma_rates(leaves["alpha"], ncat) if ncat > 1 else
                 torch.ones(1, dtype=torch.float64, device=dev))
        t = leaves["branch_lengths"][..., None] * rates           # (B, N, K)
        p = torch.linalg.matrix_exp(q * t[..., None, None])
    pinv = leaves.get("pinv")
    roots = [r for r in (p, freqs, pinv) if r is not None]
    held = [r.detach().to(work if r is p else torch.float64)
            .requires_grad_(want_grad) for r in roots]
    b, _, k, s, _ = p.shape
    per_pattern = (tree.n_internal * b * k * s * _SAVED_PER_CELL
                   * torch.finfo(work).bits // 8)
    block = max(1, int(budget_bytes // per_pattern))
    totals = torch.zeros(b, dtype=torch.float64, device=dev)
    for lo in range(0, pats.shape[1], block):
        with torch.set_grad_enabled(want_grad):
            sw = _mixed(tree, pats[:, lo:lo + block], held[0], held[1],
                        held[2] if pinv is not None else None, tf32)
            part = (sw * weights[lo:lo + block]).sum(dim=-1)
        if want_grad:
            part.sum().backward()
        totals += part.detach()
    if not want_grad:
        return totals, None
    torch.autograd.backward(roots, [h.grad.to(r.dtype)
                                    for r, h in zip(roots, held)])
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    out = {"branch_lengths": grads["branch_lengths"],
           "model": {k[6:]: v for k, v in grads.items()
                     if k.startswith("model.")}}
    out.update({k: grads[k] for k in ("alpha", "pinv") if k in grads})
    return totals, out
