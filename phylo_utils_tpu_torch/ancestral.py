"""Ancestral state reconstruction (marginal / empirical-Bayes posteriors),
joint ML reconstruction and per-site rate-category posteriors (PyTorch port
of ``phylo_utils_tpu.ancestral``).

Two passes over the compiled level schedule:

- **down** (Felsenstein pruning): ``down[v]`` = P(data below v | state at
  v), per rate category, per-node rescaled. Under ``pruner="cuda"`` it is
  the saveall kernel's (``cuda_pruning.saveall_walk``: every internal node's
  partials, rescaled by powers of two, with their exponent counts; on CPU
  tensors its plain version), else the level-batched plain pass
  ``_down_pass``.
- **up** (pre-order, plain PyTorch batched over sites): ``out[v]`` =
  P(data outside v's subtree | state at v): ``out[root] = pi``; for child v
  of u with siblings c,
  ``out[v][i] = sum_j P_v[j, i] * out[u][j] * prod_c (P_c @ down[c])[j]``.

Posteriors: per category p_c(state=i) ∝ down*out (any per-node scale
cancels in the per-site normalization), mixed over categories with the
per-site category posterior gamma_{s,c} ∝ w_c * L_{s,c} * e^{scale_c}.
``site_rate_posteriors`` prunes through ``engine._prune`` (the value walks
B1/B4/B5/B8/B9 under ``pruner="cuda"``). The joint reconstruction is a
max-product pass with traceback in plain PyTorch.

Precision: the down pass runs in the engine's dtype (float32 in the
kernel); the up pass, the posteriors and the max-product pass run in
float64 (the engine's ``_reduce_dtype``), as P(t) and the root reduction do
in every engine of the port (the JAX package runs them in the engine's
dtype).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from phylo_utils_tpu_torch.parallel.sharding import gather_sites
from phylo_utils_tpu_torch.trees import PruningSchedule

__all__ = [
    "ancestral_posteriors",
    "site_rate_posteriors",
    "site_rates",
    "joint_ancestral_states",
]


def _level(schedule: PruningSchedule, lvl: int, device):
    """(nodes (W,), children (W, C), mask (W, C) bool, slots, kids) of level
    ``lvl`` as tensors on ``device``: ``slots`` the flat (W * C) positions
    of its real (node, child) slots and ``kids`` their child ids, found on
    the host (a boolean index on the device would wait for the card)."""
    mask = schedule.level_childmask[lvl] > 0
    children = schedule.level_children[lvl]
    slots = np.flatnonzero(mask.reshape(-1))

    def t(a, dtype=torch.int64):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return (t(schedule.level_nodes[lvl]), t(children), t(mask, torch.bool),
            t(slots), t(children.reshape(-1)[slots]))


def _apply_p(pm: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(P_c @ x_c) per (node, child, category, site): pm (W, C, K, S, S),
    x (W, C, K, sites, S) -> (W, C, K, sites, S)."""
    return torch.einsum("wckij,wcksj->wcksi", pm, x)


def _down_pass(schedule: PruningSchedule, p: torch.Tensor,
               leaf_partials: torch.Tensor):
    """Felsenstein pruning retaining ALL node buffers (for the up pass), in
    ``leaf_partials``' dtype: (buf (n_nodes + 1, K, sites, S), logscale
    (n_nodes + 1, K, sites)); row n_nodes is the padding slots' trash row."""
    dtype, device = leaf_partials.dtype, leaf_partials.device
    p = p.to(dtype)
    k = p.shape[1]
    sites, s = leaf_partials.shape[1:]
    n = schedule.n_nodes
    tiny = torch.finfo(dtype).tiny
    buf = torch.zeros((n + 1, k, sites, s), dtype=dtype, device=device)
    buf[: schedule.n_leaves] = leaf_partials[:, None]
    logscale = torch.zeros((n + 1, k, sites), dtype=dtype, device=device)
    for lvl in range(schedule.n_levels):
        nodes, children, mask, _, _ = _level(schedule, lvl, device)
        contrib = _apply_p(p[children], buf[children])
        contrib = torch.where(mask[:, :, None, None, None], contrib,
                              torch.ones((), dtype=dtype, device=device))
        partial = torch.prod(contrib, dim=1)
        sc = (logscale[children] * mask[:, :, None, None]).sum(dim=1)
        m = partial.amax(dim=-1).clamp_min(tiny)
        buf[nodes] = partial / m[..., None]
        logscale[nodes] = sc + torch.log(m)
    return buf, logscale


def _kernel_down_pass(engine, p: torch.Tensor, leaf_partials: torch.Tensor):
    """The down pass from the saveall kernel (B2): the same contract as
    ``_down_pass`` but per-node rescaled by powers of two, in float32. The
    kernel's rows are indexed by node id - n_leaves; the logscale is the
    exponent count x ln 2. States are padded to ``padded_states`` for the
    kernel (61 -> 64 for codons) and sliced back, so the padded states
    carry no mass."""
    from phylo_utils_tpu_torch.ops.cuda_pruning import (
        LN2,
        _pad_states,
        padded_states,
        saveall_walk,
    )

    schedule, walk = engine.schedule, engine._walk
    s = leaf_partials.shape[-1]
    s_pad = padded_states(s)
    p32 = _pad_states(p.to(torch.float32), s_pad, 2).contiguous()
    l32 = _pad_states(leaf_partials.to(torch.float32), s_pad,
                      1).contiguous()
    res_x, res_e = saveall_walk(p32, l32, walk)    # (K, n_inner, sites, S)
    k, _, sites = res_e.shape
    n, n_leaves = schedule.n_nodes, schedule.n_leaves
    buf = torch.empty((n + 1, k, sites, s), dtype=torch.float32,
                      device=p.device)
    buf[:n_leaves] = l32[:, None, :, :s]
    buf[n_leaves:n] = res_x.transpose(0, 1)[..., :s]
    buf[n] = 0.0
    logscale = torch.zeros((n + 1, k, sites), dtype=torch.float64,
                           device=p.device)
    logscale[n_leaves:n] = res_e.transpose(0, 1).to(torch.float64) * LN2
    return buf, logscale


def _check_engine_supported(engine, what: str) -> None:
    """Engines with bespoke likelihood plumbing that do NOT expose the
    ``_mixture_tensors`` hook (PartitionedEngine, StackedPartitionedEngine,
    TopologySetEngine) can't drive the two-pass machinery: fail with a
    clear message."""
    from phylo_utils_tpu_torch.likelihood import LikelihoodEngine

    cls = type(engine)
    mt = getattr(cls, "_mixture_tensors", None)
    ll = getattr(cls, "_loglik_fn", None)
    if mt is None or (
        ll is not LikelihoodEngine._loglik_fn
        and mt is LikelihoodEngine._mixture_tensors
    ):
        raise NotImplementedError(
            f"{what} needs the engine's _mixture_tensors hook; "
            f"{type(engine).__name__} has its own likelihood plumbing "
            "without one (run the analysis per partition / per topology "
            "on its underlying engines instead)"
        )


def _per_cat_freqs(freqs: torch.Tensor, k: int, dtype) -> torch.Tensor:
    """Frequencies normalized to shape (K, S): base engines supply (S,)
    (shared across categories), model-mixture engines supply (K, S)."""
    f = freqs.to(dtype)
    if f.dim() == 1:
        f = f[None, :].expand(k, f.shape[0])
    return f


def _up_pass(schedule: PruningSchedule, p: torch.Tensor, down: torch.Tensor,
             freqs: torch.Tensor) -> torch.Tensor:
    """Outside likelihoods out[v] for every node, pre-order, rescaled, in
    ``down``'s dtype. ``freqs``: (S,) shared or (K, S) per-category."""
    dtype, device = down.dtype, down.device
    p = p.to(dtype)
    n = schedule.n_nodes
    k, sites, s = down.shape[1:]
    fk = _per_cat_freqs(freqs, k, dtype)
    out = torch.zeros((n + 1, k, sites, s), dtype=dtype, device=device)
    out[schedule.root] = fk[:, None, :].expand(k, sites, s)
    tiny = torch.finfo(dtype).tiny
    one = torch.ones((), dtype=dtype, device=device)
    # reverse level order: parents' out is ready before their children's
    for lvl in range(schedule.n_levels - 1, -1, -1):
        nodes, children, mask, slots, kids = _level(schedule, lvl, device)
        pm = p[children]                           # (W, C, K, S, S)
        contrib = torch.where(mask[:, :, None, None, None],
                              _apply_p(pm, down[children]), one)
        # product over the OTHER children, formed directly (C is tiny): no
        # division, so a zero sibling term cannot blow up
        c = contrib.shape[1]
        sib = []
        for ci in range(c):
            acc = None
            for cj in range(c):
                if cj != ci:
                    term = contrib[:, cj]
                    acc = term if acc is None else acc * term
            sib.append(torch.ones_like(contrib[:, 0]) if acc is None else acc)
        msg = out[nodes][:, None] * torch.stack(sib, dim=1)
        # transpose-P application: child_out[i] = sum_j P[j, i] msg[j]
        child_out = torch.einsum("wckji,wcksj->wcksi", pm, msg)
        mx = child_out.amax(dim=-1, keepdim=True).clamp_min(tiny)
        child_out = child_out / mx
        out[kids] = child_out.reshape((-1,) + child_out.shape[2:])[slots]
    return out


def _pinv_of(engine, full) -> Optional[torch.Tensor]:
    return full.get("pinv") if getattr(engine, "invariant_sites",
                                       False) else None


def _to_sites(engine, x: torch.Tensor, axis: int) -> np.ndarray:
    """``x`` with its pattern axis expanded to per-site positions (real
    patterns only), on the device, then on the host."""
    idx = torch.as_tensor(engine._compressed.site_to_pattern,
                          dtype=torch.int64, device=x.device)
    return x.detach().index_select(axis, idx).to("cpu").numpy()


def ancestral_posteriors(
    engine, params: Optional[Mapping] = None
) -> np.ndarray:
    """Marginal posterior state probabilities at every internal node.

    Returns (n_internal, n_sites, S) float64: rows ordered by internal node
    id (``engine.tree`` ids ``n_leaves..n_nodes-1``; the last row is the
    root), expanded to per-site (not per-pattern) positions, normalized
    over states.
    """
    _check_engine_supported(engine, "ancestral_posteriors")
    schedule = engine.schedule
    full = engine._full_params(params)
    rdt = engine._reduce_dtype
    # the whole (padded) pattern axis of a sharded engine
    leaf_partials = gather_sites(engine._leaf_partials, engine.device)
    with torch.no_grad():
        # engine hook: per-edge-per-category P and the mixture weights;
        # branch-model and model-mixture engines plug in here too (the
        # latter supply per-category (K, S) frequencies)
        _, cat_weights, p, freqs = engine._mixture_tensors(full, rdt)
        k = p.shape[1]
        fk = _per_cat_freqs(freqs, k, rdt)
        cat_weights = cat_weights.to(rdt)
        # the down pass of the engine's pruner: the saveall kernel under
        # pruner="cuda", else the plain pass in the engine's dtype
        down, logscale = (
            _kernel_down_pass(engine, p, leaf_partials)
            if engine.pruner == "cuda"
            else _down_pass(schedule, p, leaf_partials))
        down = down.to(rdt)
        out = _up_pass(schedule, p, down, fk)
        # binarization pseudo-nodes (ids >= n_real_nodes) are not tree
        # nodes: posteriors for real internal nodes only
        internal = slice(schedule.n_leaves, schedule.n_real_nodes)
        joint = down[internal] * out[internal]          # (I, K, sites, S)
        per_cat = joint / joint.sum(dim=-1, keepdim=True).clamp_min(
            torch.finfo(rdt).tiny)
        # per-site category posterior from the root reduction
        root_lik = torch.einsum("ksi,ki->ks", down[schedule.root], fk)
        sc = logscale[schedule.root].to(rdt)
        m = sc.amax(dim=0)
        gam = cat_weights[:, None] * root_lik * torch.exp(sc - m[None, :])
        g_tot = gam.sum(dim=0)                          # (sites,)
        gam = gam / g_tot[None, :]                      # (K, sites)
        post = torch.einsum("iksj,ks->isj", per_cat, gam)
        pinv = _pinv_of(engine, full)
        if pinv is not None:
            # mix in the +I component: all nodes share one state x with
            # posterior ~ pinv * pi_bar_x * prod_leaves partial[x]; its
            # per-site mixing weight beta against the variable part (weight
            # (1-pinv) * e^m * sum_k gam_k) is computed in log space (e^m
            # under/overflows directly)
            pinv = pinv.to(rdt)
            prod = torch.prod(leaf_partials.to(rdt), dim=0)      # (s, S)
            fbar = torch.einsum("k,ki->i", cat_weights, fk)
            inv_unnorm = fbar[None, :] * prod
            inv_tot = inv_unnorm.sum(dim=-1)
            log_var = torch.log1p(-pinv) + m + torch.log(
                g_tot.clamp_min(torch.finfo(rdt).tiny))
            log_inv = torch.where(
                inv_tot > 0,
                torch.log(pinv) + torch.log(torch.where(
                    inv_tot > 0, inv_tot, torch.ones_like(inv_tot))),
                torch.full_like(inv_tot, -np.inf))
            beta = torch.sigmoid(log_inv - log_var)               # (s,)
            post_inv = inv_unnorm / inv_tot.clamp_min(
                torch.finfo(rdt).tiny)[:, None]
            post = ((1.0 - beta)[None, :, None] * post
                    + beta[None, :, None] * post_inv[None, :, :])
    return _to_sites(engine, post.to(torch.float64), axis=1)


def _site_rate_gamma(engine, full) -> torch.Tensor:
    """(K, patterns) category posteriors through ``engine._prune``."""
    rdt = engine._reduce_dtype
    _, cat_weights, p, freqs = engine._mixture_tensors(full, rdt)
    fk = _per_cat_freqs(freqs, p.shape[1], rdt)
    root_partials, root_logscale = engine._prune(p.to(engine.dtype),
                                                 engine._leaf_partials)
    lik = torch.einsum("ksi,ki->ks", root_partials.to(rdt), fk)
    root_logscale = root_logscale.to(rdt)
    m = root_logscale.amax(dim=0)
    gam = cat_weights.to(rdt)[:, None] * lik * torch.exp(
        root_logscale - m[None, :])
    return gam / gam.sum(dim=0, keepdim=True)


def site_rate_posteriors(
    engine, params: Optional[Mapping] = None
) -> np.ndarray:
    """Posterior probability of each rate category per site: (n_sites, K),
    float64."""
    _check_engine_supported(engine, "site_rate_posteriors")
    with torch.no_grad():
        gam = _site_rate_gamma(engine, engine._full_params(params))
    return _to_sites(engine, gam.T.to(torch.float64), axis=0)


def site_rates(engine, params: Optional[Mapping] = None) -> np.ndarray:
    """Posterior-mean evolutionary rate per site (rate4site-style):
    ``r_s = sum_k gamma_{s,k} * rate_k``, the empirical-Bayes point
    estimate of each site's relative rate under the engine's discrete RATE
    mixture. Returns (n_sites,). For ``invariant_sites`` engines this
    averages over the gamma categories only (the +I component is a separate
    mixture layer, not a rate category here)."""
    from phylo_utils_tpu_torch.likelihood import rate_categories

    full = engine._full_params(params)
    gam = site_rate_posteriors(engine, params)          # (sites, K)
    with torch.no_grad():
        rates, _ = rate_categories(engine, full, torch.float64)
    return gam @ rates.to("cpu").numpy()


def _maxprod_contract(pm: torch.Tensor, child_d: torch.Tensor):
    """Max-product "matmul" with argmax: for each parent state j,
    ``contrib[..., j] = max_i pm[..., j, i] * child_d[..., i]`` and
    ``amax[..., j] = argmax_i``.

    pm: (W, C, K, S, S); child_d: (W, C, K, sites, S) -> contrib/amax:
    (W, C, K, sites, S). A loop over the parent state keeps the peak
    intermediate at one (W, C, K, sites, S) slab instead of the (sites, S,
    S) outer product (gigabytes at 61 codon states).
    """
    s = pm.shape[-1]
    contrib = torch.empty_like(child_d)
    amax = torch.empty(child_d.shape, dtype=torch.int32,
                       device=child_d.device)
    for j in range(s):
        scores = pm[:, :, :, None, j, :] * child_d     # (W, C, K, sites, Si)
        val, idx = scores.max(dim=-1)
        contrib[..., j] = val
        amax[..., j] = idx.to(torch.int32)
    return contrib, amax


def joint_ancestral_states(
    engine, params: Optional[Mapping] = None
) -> Dict[str, np.ndarray]:
    """Joint maximum-likelihood ancestral reconstruction (Pupko, Pe'er,
    Shamir & Graur 2000, Mol. Biol. Evol. 17:890: the max-product dynamic
    program PAML's RateAncestor uses for joint reconstruction).

    Finds the single assignment of states to ALL internal nodes jointly
    maximizing P(states, data) per site. Rate mixtures run the pass per
    category and select, per site, the (category, assignment) pair
    maximizing w_k * P(states, data | r_k). For ``invariant_sites`` engines
    the +I component competes too: its weight is ``pinv`` (the gamma
    categories get ``(1 - pinv) * w_k``), its transition matrices are the
    identity, so its best assignment is the single state x maximizing
    pi_x * prod_leaves partial[x] (-inf on sites no single state explains).

    Returns {"states": (n_internal, n_sites) int32, ordered by internal
    node id, root last; "log_prob": (n_sites,) joint log P(states, data);
    "category": (n_sites,) winning rate-category index, where the value
    ``ncat`` denotes the invariant (+I) component}.
    """
    _check_engine_supported(engine, "joint_ancestral_states")
    schedule = engine.schedule
    full = engine._full_params(params)
    rdt = engine._reduce_dtype
    # the whole (padded) pattern axis of a sharded engine
    leaf_partials = gather_sites(engine._leaf_partials, engine.device)
    device = leaf_partials.device
    with torch.no_grad():
        _, cat_weights, p, freqs = engine._mixture_tensors(full, rdt)
        p = p.to(rdt)
        cat_weights = cat_weights.to(rdt)
        n = schedule.n_nodes
        k = p.shape[1]
        sites, s = leaf_partials.shape[1:]
        tiny = torch.finfo(rdt).tiny
        one = torch.ones((), dtype=rdt, device=device)

        # post-order max-product: d[v][j] = max prob of subtree(v) given
        # state(v)=j (rescaled); a[v][j] = argmax of v's state given its
        # PARENT is in state j
        d = torch.zeros((n + 1, k, sites, s), dtype=rdt, device=device)
        d[: schedule.n_leaves] = leaf_partials.to(rdt)[:, None]
        a = torch.zeros((n + 1, k, sites, s), dtype=torch.int32,
                        device=device)
        logscale = torch.zeros((n + 1, k, sites), dtype=rdt, device=device)
        for lvl in range(schedule.n_levels):
            nodes, children, mask, slots, kids = _level(schedule, lvl,
                                                        device)
            contrib, amax = _maxprod_contract(p[children], d[children])
            contrib = torch.where(mask[:, :, None, None, None], contrib, one)
            dv = torch.prod(contrib, dim=1)             # (W, K, sites, S)
            sc = (logscale[children] * mask[:, :, None, None]).sum(dim=1)
            m = dv.amax(dim=-1).clamp_min(tiny)
            d[nodes] = dv / m[..., None]
            logscale[nodes] = sc + torch.log(m)
            a[kids] = amax.reshape((-1,) + amax.shape[2:])[slots]

        # root decision + per-category joint log prob
        fk = _per_cat_freqs(freqs, k, rdt)
        root_scores = fk[:, None, :] * d[schedule.root]
        root_max, root_state = root_scores.max(dim=-1)        # (K, sites)
        lj = torch.log(root_max.clamp_min(tiny)) + logscale[schedule.root]

        # backtrack pre-order: children read their parent's chosen state
        states = torch.zeros((n + 1, k, sites), dtype=torch.int64,
                             device=device)
        states[schedule.root] = root_state
        for lvl in range(schedule.n_levels - 1, -1, -1):
            nodes, children, _, slots, kids = _level(schedule, lvl, device)
            ps = states[nodes]                          # (W, K, sites)
            ca = a[children]                            # (W, C, K, sites, S)
            child_state = torch.gather(
                ca, -1, ps[:, None, :, :, None].expand(
                    ca.shape[:-1] + (1,)))[..., 0]     # (W, C, K, sites)
            states[kids] = child_state.reshape(
                (-1,) + child_state.shape[2:])[slots].to(torch.int64)

        # per-site winning category: max_k log(w_k) + log joint_k
        log_w = torch.log(cat_weights)[:, None]
        pinv = _pinv_of(engine, full)
        if pinv is not None:
            pinv = pinv.to(rdt)
            log_w = log_w + torch.log1p(-pinv)
        score_k = log_w + lj
        log_prob, best_k = score_k.max(dim=0)           # (sites,)
        internal = slice(schedule.n_leaves, schedule.n_real_nodes)
        sel = torch.gather(states[internal], 1, best_k[None, None, :].expand(
            schedule.n_real_nodes - schedule.n_leaves, 1, sites))[:, 0]
        if pinv is not None:
            # +I component: identity P forces every node to one state x;
            # joint prob = pinv * pi_bar_x * prod_leaves partial[l, s, x]
            prod = torch.prod(leaf_partials.to(rdt), dim=0)     # (sites, S)
            fbar = torch.einsum("k,ki->i", cat_weights, fk)
            inv_max, inv_state = (fbar[None, :] * prod).max(dim=-1)
            inv_lp = torch.where(
                inv_max > 0.0,
                torch.log(pinv) + torch.log(inv_max.clamp_min(tiny)),
                torch.full_like(inv_max, -np.inf))
            inv_wins = inv_lp > log_prob
            sel = torch.where(inv_wins[None, :], inv_state[None, :], sel)
            log_prob = torch.maximum(log_prob, inv_lp)
            best_k = torch.where(inv_wins, torch.full_like(best_k, k),
                                 best_k)
    return {
        "states": _to_sites(engine, sel.to(torch.int32), axis=1),
        "log_prob": _to_sites(engine, log_prob.to(torch.float64), axis=0),
        "category": _to_sites(engine, best_k.to(torch.int32), axis=0),
    }
