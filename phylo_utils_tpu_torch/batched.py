"""Batched evaluation of MANY tree topologies against one alignment (PyTorch
port of ``phylo_utils_tpu.batched``).

All binary trees on n taxa have 2n-1 nodes, so their level schedules pad to
one common (levels, width, children) shape, and one level loop prunes every
candidate at once over a leading candidate axis: hundreds of candidate
trees are scored in one pass (tree search, supports, topology tests). The
schedule arrays are tensors of the engine, so ``set_candidates`` swaps in a
new topology set without rebuilding anything else.

The walk (``_LevelWalk``) is plain PyTorch on the engine's device. Each
level gathers its children's partials, contracts them with their P, and
writes its nodes into one buffer in place (``index_copy_``); its reverse
runs the levels backward, each re-running its own combine under autograd
and adding the cotangents into full-size gradient buffers in place, so a
gradient keeps the buffer and nothing per level.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from phylo_utils_tpu_torch import io as pio
from phylo_utils_tpu_torch import trees as ptrees
from phylo_utils_tpu_torch.convert import flatten_params, unflatten_params
from phylo_utils_tpu_torch.likelihood import (
    _canonical_dtype,
    _checked_device,
    validate_param_keys,
)
from phylo_utils_tpu_torch.models.base import Eigen, Model
from phylo_utils_tpu_torch.ops.cuda_pruning import _on_device
from phylo_utils_tpu_torch.ops.gamma import discrete_gamma
from phylo_utils_tpu_torch.ops.pmatrix import (
    extend_p_identity,
    p_matrices_reversible,
    transition_matrices,
)
from phylo_utils_tpu_torch.ops.pruning import (
    LN2,
    first_derivative_only,
    mixture_loglik,
    pow2_rescale,
)
from phylo_utils_tpu_torch.parallel.sharding import map_sites, place

__all__ = ["pad_schedules", "TopologySetEngine", "optimize_branch_lengths",
           "chunked_brlen_optimize", "nni_hill_climb",
           "choose_regroup_width"]


def choose_regroup_width(schedules: Sequence[ptrees.PruningSchedule],
                         candidates=(2, 3, 4, 6, 8, 12, 16),
                         max_level_factor: float = 1.6):
    """Pick the group width minimizing the padded level-grid area.

    Returns ``(width, regrouped_schedules)``; width 0 keeps the original
    height-level grid (it wins on caterpillar-like trees whose critical
    path IS the walk). ``trees.regroup_schedule`` packs near-full
    fixed-width groups where the height-level grid pads every level to the
    widest. Area is compared after common padding across the whole
    candidate set, so the choice is exact for the batch that will run.

    ``max_level_factor`` bounds the regrouped LEVEL COUNT at that multiple
    of the original grid's (the JAX package's rule, kept so both packages
    run the same schedules): a narrow width that minimizes area multiplies
    the level count, and with it the walk's launches, by G/L.
    """
    l0 = max(s.n_levels for s in schedules)
    area0 = l0 * max(s.width for s in schedules)
    cap = max(int(l0 * max_level_factor), 1)
    best_u, best_area, best_scheds = 0, area0, schedules
    for u in candidates:
        rg = [ptrees.regroup_schedule(s, u) for s in schedules]
        g = max(s.n_levels for s in rg)
        if g > cap:
            continue
        area = g * u
        if area < best_area:
            best_u, best_area, best_scheds = u, area, rg
    return best_u, best_scheds


def pad_schedules(schedules: Sequence[ptrees.PruningSchedule],
                  pad_to: Optional[tuple] = None):
    """Stack schedules into common-shape arrays.

    All schedules must share n_nodes/n_leaves (same taxon count). Returns
    dict of stacked numpy arrays: nodes (B, L, W), children (B, L, W, C),
    mask (B, L, W, C). Padding levels are rows of trash-node writes (node
    id == n_nodes) with zero child masks.

    ``pad_to=(L, W, C)`` pins MINIMUM level/width/children dims: callers
    that process one candidate set in several chunks pass the global max
    so every chunk shares one shape.
    """
    n_nodes = {s.n_nodes for s in schedules}
    n_leaves = {s.n_leaves for s in schedules}
    if len(n_nodes) != 1 or len(n_leaves) != 1:
        raise ValueError("all trees must have the same taxon count")
    n = n_nodes.pop()
    L = max(s.n_levels for s in schedules)
    W = max(s.width for s in schedules)
    C = max(s.n_children_max for s in schedules)
    if pad_to is not None:
        L, W, C = max(L, pad_to[0]), max(W, pad_to[1]), max(C, pad_to[2])
    B = len(schedules)
    nodes = np.full((B, L, W), n, dtype=np.int32)
    children = np.zeros((B, L, W, C), dtype=np.int32)
    mask = np.zeros((B, L, W, C), dtype=np.float32)
    for b, s in enumerate(schedules):
        l, w, c = (s.level_nodes.shape[0], s.level_nodes.shape[1],
                   s.level_children.shape[2])
        nodes[b, :l, :w] = s.level_nodes
        children[b, :l, :w, :c] = s.level_children
        mask[b, :l, :w, :c] = s.level_childmask
    return {"nodes": nodes, "children": children, "mask": mask}


def _products(child_p, p, mask):
    """(y, partial, m): each child's masked contribution y (B, W, C, K, P, S)
    = P x its partials (1 in an empty slot), their product over children
    (B, W, K, P, S) and its per-(category, site) maximum m (B, W, K, P),
    clamped to the dtype's tiny."""
    contrib = torch.matmul(child_p, p.transpose(-1, -2))
    mask_b = mask[..., None, None, None]
    y = contrib * mask_b + (1.0 - mask_b)
    # the product over children as a chain of multiplies (prod's backward
    # reads its zero count back to the host)
    partial = y[:, :, 0]
    for c in range(1, y.shape[2]):
        partial = partial * y[:, :, c]
    m = partial.amax(dim=-1).clamp_min(torch.finfo(partial.dtype).tiny)
    return y, partial, m


class _LevelWalk(torch.autograd.Function):
    """The level walk of B candidates and its reverse, written by hand.

    Forward: the buffer holds B blocks of n_nodes + 1 rows (each block's
    last row is the trash row padding slots write to; no child slot under
    a nonzero mask reads it); each level gathers its children's rows
    (``index_select``), multiplies their P-contributions, rescales them by
    the per-(category, site) maximum (by an exact power of two in float32,
    whose logscale counts binary exponents), and writes its nodes' rows in
    place (``index_copy_``). Every node is written once, so the final
    buffer holds every node's partials, and it is all the backward keeps.

    Backward: levels in reverse order. Each regathers its children,
    recomputes their contributions, and adds the children's and P's
    cotangents into full-size gradient buffers in place (``index_add_``):
    a node's cotangent is complete once its parent's level has run. The
    rescale's own path is left out: logL is invariant under x -> x t, sc
    -> sc - log t at every node, so its terms sum to zero exactly (they
    are rounding in an autograd of the forward). The first derivative
    only.
    """

    @staticmethod
    def forward(ctx, p_flat, leaf_partials, sched, root):
        b = leaf_partials.shape[0]
        n_leaves, sites, s = leaf_partials.shape[1:]
        k = p_flat.shape[1]
        rows_per = p_flat.shape[0] // b + 1
        buf = leaf_partials.new_zeros((b, rows_per, k, sites, s))
        buf[:, :n_leaves] = leaf_partials[:, :, None]
        buf = buf.view(b * rows_per, k, sites, s)
        logscale = leaf_partials.new_zeros((b * rows_per, k, sites))
        for rows, child_rows, p_rows, mask in sched["levels"]:
            shape = mask.shape
            child_p = buf.index_select(0, child_rows).view(shape + buf.shape[1:])
            _, partial, m = _products(
                child_p, p_flat.index_select(0, p_rows).view(
                    shape + p_flat.shape[1:]), mask)
            sc = (logscale.index_select(0, child_rows).view(
                shape + logscale.shape[1:]) * mask[..., None, None]).sum(2)
            if partial.dtype == torch.float32:
                scale, e = pow2_rescale(m)
                partial, sc = partial * scale[..., None], sc + e
            else:
                partial, sc = partial / m[..., None], sc + torch.log(m)
            buf.index_copy_(0, rows, partial.view((-1,) + buf.shape[1:]))
            logscale.index_copy_(0, rows, sc.view((-1,) + logscale.shape[1:]))
        root_rows = torch.arange(b, device=buf.device) * rows_per + root
        ctx.save_for_backward(buf, logscale, p_flat, root_rows)
        ctx.sched = sched
        return buf.index_select(0, root_rows), logscale.index_select(
            0, root_rows)

    @staticmethod
    @first_derivative_only
    def backward(ctx, g_root, g_root_sc):
        buf, logscale, p_flat, root_rows = ctx.saved_tensors
        gbuf = torch.zeros_like(buf)
        glog = torch.zeros_like(logscale)
        gp = torch.zeros_like(p_flat)
        if g_root is not None:
            gbuf.index_add_(0, root_rows, g_root)
        if g_root_sc is not None:
            glog.index_add_(0, root_rows, g_root_sc)
        for rows, child_rows, p_rows, mask in reversed(ctx.sched["levels"]):
            shape = mask.shape
            child_p = buf.index_select(0, child_rows).view(shape + buf.shape[1:])
            p = p_flat.index_select(0, p_rows).view(shape + p_flat.shape[1:])
            y, partial, m = _products(child_p, p, mask)
            g_out = gbuf.index_select(0, rows).view(partial.shape)
            if partial.dtype == torch.float32:
                g_prod = g_out * pow2_rescale(m)[0][..., None]
            else:
                g_prod = g_out / m[..., None]
            # d partial / d y_c: the product of the other children's y
            g_y = torch.stack([
                functools.reduce(torch.mul, [y[:, :, o] for o in range(
                    y.shape[2]) if o != c], g_prod)
                for c in range(y.shape[2])], dim=2)
            g_y = g_y * mask[..., None, None, None]
            gbuf.index_add_(0, child_rows, torch.matmul(g_y, p).view(
                (-1,) + buf.shape[1:]))
            gp.index_add_(0, p_rows, torch.matmul(
                g_y.transpose(-1, -2), child_p).view((-1,) + p_flat.shape[1:]))
            g_sc = glog.index_select(0, rows).view(partial.shape[:-1])
            glog.index_add_(0, child_rows, (
                g_sc[:, :, None] * mask[..., None, None]).view(
                (-1,) + logscale.shape[1:]))
        return gp, None, None, None


def _prune_dynamic(sched: Dict[str, torch.Tensor], p_matrices: torch.Tensor,
                   leaf_partials: torch.Tensor, root: int):
    """Level-loop pruning of B candidates at once (``_LevelWalk``).

    ``sched["levels"]``: per level, the flat buffer rows of its nodes
    (B * W,), of their children and of the children's P (B * W * C,), and
    the slot mask (B, W, C) in the partials' dtype; ``p_matrices`` (B, n_nodes, K, S, S),
    ``leaf_partials`` (B, n_leaves, P, S). Returns (root_partials (B, K, P,
    S), root_logscale (B, K, P)), the logscale in ln units.
    """
    b, n_nodes = p_matrices.shape[:2]
    root_p, root_sc = _LevelWalk.apply(
        p_matrices.reshape((b * n_nodes,) + p_matrices.shape[2:]),
        leaf_partials, sched, root)
    if leaf_partials.dtype == torch.float32:
        root_sc = (root_sc.to(torch.float64) * LN2).to(torch.float32)
    return root_p, root_sc


def _softplus(raw: torch.Tensor) -> torch.Tensor:
    """log(1 + e^raw), as ``jax.nn.softplus`` (``F.softplus`` turns into the
    identity above 20)."""
    return torch.logaddexp(raw, torch.zeros_like(raw))


class TopologySetEngine:
    """Score a set of candidate topologies against one alignment.

    One batched pass evaluates logL (and gradients w.r.t. per-tree branch
    lengths and shared model parameters) for ALL trees at once; the batch
    axis runs over (schedule, leaf permutation, branch lengths).
    ``set_candidates`` swaps in a new topology set: the chunked optimizer
    and the NNI searcher reuse ONE engine (its regroup width and padded
    dims) across every chunk and round.

    ``dtype``: partials dtype (None = float64); P(t), the rates and the
    root reduction run in float64. ``device``: "cuda" (default; raises
    where there is no card) or "cpu". ``sharding``
    (``parallel.SiteSharding``): the patterns are padded and sharded over
    its mesh; every candidate's walk runs shard by shard on the replicated
    schedules and P, reduced once (``parallel.sharding.map_sites``).
    """

    def __init__(
        self,
        trees: Sequence[Union[ptrees.Tree, str]],
        alignment: Union[Mapping[str, str], pio.CompressedAlignment],
        model: Model,
        ncat: int = 1,
        median: bool = False,
        dtype=None,
        compress: bool = True,
        pad_to: Optional[tuple] = None,
        sharding=None,
        regroup="auto",
        device="cuda",
    ):
        self.model = model
        self.sharding = sharding
        self.ncat = int(ncat)
        self.median = bool(median)
        self.dtype = _canonical_dtype(dtype)
        self.device = _checked_device(device)
        # regroup: "auto" (pick the area-minimizing fixed group width on
        # the first candidate set, see choose_regroup_width), an int
        # width, or 0/None to keep the height-level grid. Sticky after
        # the first set so swapped candidate sets keep the padded shape.
        self._regroup_u = None if regroup == "auto" else int(regroup or 0)

        if isinstance(alignment, pio.CompressedAlignment):
            ca = alignment
        elif compress:
            ca = pio.compress_patterns(alignment, model.alphabet)
        else:
            from phylo_utils_tpu_torch.alphabets import encode_alignment

            names, arr = encode_alignment(alignment, model.alphabet)
            ca = pio.CompressedAlignment(
                names=tuple(names), partials=arr,
                weights=np.ones(arr.shape[1]),
                site_to_pattern=np.arange(arr.shape[1], dtype=np.int32),
            )
        self._compressed = ca
        self._leaf_partials, self._weights = place(
            sharding, ca.partials, ca.weights, self.device, self.dtype,
            torch.float64)
        # padded (L, W, C) dims; grow monotonically so a pinned shape keeps
        # serving later candidate sets (pad_to pins the minimum)
        self._pad_dims = pad_to
        self.set_candidates(trees)

    def set_candidates(
        self, trees: Sequence[Union[ptrees.Tree, str]]
    ) -> "TopologySetEngine":
        """Swap in a new candidate set (same taxa). The padded schedule
        shape grows monotonically and the regroup width stays the first
        set's."""
        trees = [pio.parse_newick(t) if isinstance(t, str) else t
                 for t in trees]
        if not trees:
            raise ValueError("empty tree set")
        self.trees: List[ptrees.Tree] = trees
        ca = self._compressed
        schedules = [ptrees.compile_schedule(t) for t in trees]
        if self._regroup_u is None:
            self._regroup_u, schedules = choose_regroup_width(schedules)
        elif self._regroup_u:
            schedules = [ptrees.regroup_schedule(s, self._regroup_u)
                         for s in schedules]
        padded = pad_schedules(schedules, pad_to=self._pad_dims)
        self._pad_dims = (
            padded["nodes"].shape[1], padded["nodes"].shape[2],
            padded["children"].shape[3],
        )
        self.n_nodes = schedules[0].n_nodes
        self.root = schedules[0].root
        # flat rows of the walk's buffer (B blocks of n_nodes + 1 rows) and
        # of the (B * n_nodes) stack of P
        b = len(trees)
        block = (np.arange(b, dtype=np.int64) * (self.n_nodes + 1))
        p_block = np.arange(b, dtype=np.int64) * self.n_nodes
        children = padded["children"].astype(np.int64)
        dev = self.device
        rows = padded["nodes"] + block[:, None, None]
        child_rows = children + block[:, None, None, None]
        p_rows = (np.clip(children, 0, self.n_nodes - 1)
                  + p_block[:, None, None, None])
        mask = torch.from_numpy(padded["mask"]).to(dev, self.dtype)
        self._sched = {
            "child_rows": torch.from_numpy(child_rows).to(dev),
            "mask": mask,
            # per level: (rows (B*W,), child rows (B*W*C,), P rows
            # (B*W*C,), mask (B, W, C)), contiguous on the device
            "levels": [
                tuple(torch.from_numpy(np.ascontiguousarray(
                    a[:, lvl].reshape(-1))).to(dev)
                    for a in (rows, child_rows, p_rows))
                + (mask[:, lvl].contiguous(),)
                for lvl in range(rows.shape[1])],
        }
        # per-tree leaf permutation: row b maps tree-b leaf id -> pattern row
        perms = []
        for t in trees:
            missing = set(t.leaf_names) - set(ca.names)
            if missing:
                raise ValueError(f"alignment missing taxa {sorted(missing)}")
            perms.append([ca.names.index(nm) for nm in t.leaf_names])
        self._leaf_perm = torch.as_tensor(np.asarray(perms, np.int64),
                                          device=dev)
        self._brlens0 = torch.as_tensor(
            np.stack([t.lengths for t in trees]), dtype=self.dtype,
            device=dev)
        # the schedule and permutation on each other shard device
        self._walk_on = {}
        return self

    def _walk_arrays(self, device: torch.device):
        """(schedule arrays, leaf permutation) on ``device``: the engine's
        own, or copies made once per candidate set for a shard device."""
        if device == self._leaf_perm.device:
            return self._sched, self._leaf_perm
        sched = self._sched
        child_rows, mask, perm, *levels = _on_device(
            self._walk_on, device, (sched["child_rows"], sched["mask"],
                                    self._leaf_perm,
                                    *(a for lvl in sched["levels"]
                                      for a in lvl)))
        return ({"child_rows": child_rows, "mask": mask,
                 "levels": [tuple(levels[i:i + 4])
                            for i in range(0, len(levels), 4)]}, perm)

    def _tensor(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    def default_params(self) -> Dict:
        params: Dict = {
            "branch_lengths": self._brlens0,          # (B, n_nodes)
            "model": self.model.defaults(self.dtype, self.device),
        }
        if self.ncat > 1:
            params["alpha"] = self._tensor(0.5)
        return params

    def _full_params(self, params: Optional[Mapping]) -> Dict:
        full = self.default_params()
        if params:
            validate_param_keys(params, full, type(self).__name__,
                                nested="model")
            for k, v in params.items():
                if k == "model":
                    full["model"] = {**full["model"], **{
                        kk: self._tensor(vv) for kk, vv in v.items()
                    }}
                else:
                    full[k] = self._tensor(v)
        return full

    def _model_eigen(self, params) -> Eigen:
        """The f64 eigensystem of fixed model parameters (value calls and
        the branch-length optimizer, which differentiate only t)."""
        return self.model.eigen(
            {k: v.detach() for k, v in params["model"].items()},
            dtype=torch.float64, device=self.device)

    def _rates(self, params) -> torch.Tensor:
        if self.ncat <= 1:
            return torch.ones((1,), dtype=torch.float64, device=self.device)
        # on the host in float64, differentiably (as the base engine)
        alpha = params["alpha"].to("cpu", torch.float64)
        return discrete_gamma(alpha, self.ncat, self.median).to(
            device=self.device, dtype=torch.float64)

    def _core(self, params, eig: Optional[Eigen] = None,
              rates: Optional[torch.Tensor] = None):
        """(totals (B,), sitewise (B, P)) in float64 of every candidate.
        ``eig`` / ``rates``: precomputed for fixed model parameters / alpha;
        otherwise P(t) is differentiable in the model parameters."""
        rdt = torch.float64
        if rates is None:
            rates = self._rates(params)
        cat_weights = torch.full((self.ncat,), 1.0 / self.ncat, dtype=rdt,
                                 device=self.device)
        t = params["branch_lengths"].to(rdt)                 # (B, n_nodes)
        ts = t[..., None] * rates                            # (B, n_nodes, K)
        if eig is not None:
            freqs = eig.freqs
            p = transition_matrices(eig, ts)
        elif self.model.reversible:
            sym, freqs = self.model.build_parts(params["model"], dtype=rdt,
                                                device=self.device)
            p = p_matrices_reversible(sym, freqs, ts)
        else:
            q, freqs = self.model.build_parts(params["model"], dtype=rdt,
                                              device=self.device)
            p = transition_matrices(
                Eigen(evals=None, evecs=None, ivecs=None, freqs=freqs, q=q),
                ts)
        p = extend_p_identity(p, self.n_nodes).to(self.dtype)
        return map_sites(self._block_loglik, (p, freqs, cat_weights),
                         self._leaf_partials, self._weights, self.device)

    def _block_loglik(self, p, freqs, cat_weights, leaf_partials, weights):
        """(totals (B,), sitewise (B, P)) of one block of patterns (all of
        them, or one shard) for every candidate."""
        rdt = torch.float64
        sched, perm = self._walk_arrays(leaf_partials.device)
        leaves = leaf_partials[perm]                         # (B, n_leaves, P, S)
        rp, rsc = _prune_dynamic(sched, p, leaves, self.root)
        return mixture_loglik(rp.to(rdt), rsc.to(rdt), freqs, cat_weights,
                              weights)

    def _eval(self, params):
        full = self._full_params(params)
        with torch.no_grad():
            return self._core(full, eig=self._model_eigen(full),
                              rates=self._rates(full))

    # -- public API ----------------------------------------------------------

    def loglikelihoods(self, params: Optional[Mapping] = None) -> np.ndarray:
        """(n_trees,) float64 log-likelihoods in one batched pass."""
        return self._eval(params)[0].to("cpu").numpy()

    def sitewise_loglikelihoods(
        self, params: Optional[Mapping] = None
    ) -> np.ndarray:
        """(n_trees, n_sites) per-site log-likelihoods (for RELL/KH/SH
        topology tests; see topology_tests.py)."""
        sw = self._eval(params)[1].to("cpu").numpy()
        return sw[:, self._compressed.site_to_pattern]

    def gradients(self, params: Optional[Mapping] = None) -> Dict:
        """Gradient of the sum of logLs (per-tree branch-length gradients
        are independent): the full parameter dict's structure, with
        ``branch_lengths`` (B, n_nodes), tensors of the engine's dtype."""
        names, leaves = flatten_params(self._full_params(params))
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        with torch.enable_grad():
            full = unflatten_params(names, leaves)
            full.setdefault("model", {})
            total, _ = self._core(full)
            grads = torch.autograd.grad(total.sum(), leaves,
                                        allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        out = unflatten_params(names, grads)
        out.setdefault("model", {})
        return out

    def best(self, params: Optional[Mapping] = None) -> int:
        return int(np.argmax(self.loglikelihoods(params)))


_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


def optimize_branch_lengths(
    tse: "TopologySetEngine",
    params: Optional[Mapping] = None,
    steps: int = 60,
    lr: float = 0.05,
):
    """Optimize every candidate tree's branch lengths simultaneously.

    Each tree's logL depends only on its own branch-length row, so one Adam
    loop on the summed logL optimizes all B trees independently in
    parallel (per-tree gradients are block-diagonal; Adam is elementwise).
    Branch lengths are optimized as softplus(raw); the update is
    ``optax.adam``'s (bias-corrected moments, eps outside the square
    root). Returns (logliks (B,), branch_lengths (B, n_nodes)) as numpy.
    """
    full = tse._full_params(params)
    eig, rates = tse._model_eigen(full), tse._rates(full)
    fixed = {k: v for k, v in full.items() if k != "branch_lengths"}
    raw = torch.log(torch.expm1(full["branch_lengths"].detach()
                                .clamp_min(1e-6)))
    mu = torch.zeros_like(raw)
    nu = torch.zeros_like(raw)
    for step in range(1, int(steps) + 1):
        raw.requires_grad_(True)
        with torch.enable_grad():
            total, _ = tse._core({**fixed, "branch_lengths": _softplus(raw)},
                                 eig=eig, rates=rates)
            (g,) = torch.autograd.grad(-total.sum(), raw)
        with torch.no_grad():
            mu = (1.0 - _ADAM_B1) * g + _ADAM_B1 * mu
            nu = (1.0 - _ADAM_B2) * (g * g) + _ADAM_B2 * nu
            mu_hat = mu / (1.0 - _ADAM_B1 ** step)
            nu_hat = nu / (1.0 - _ADAM_B2 ** step)
            raw = raw.detach() + -lr * (mu_hat / (torch.sqrt(nu_hat)
                                                  + _ADAM_EPS))
    with torch.no_grad():
        brlens = _softplus(raw)
        lls, _ = tse._core({**fixed, "branch_lengths": brlens}, eig=eig,
                           rates=rates)
    return lls.to("cpu").numpy(), brlens.to("cpu", torch.float64).numpy()


def chunked_brlen_optimize(
    candidates: Sequence[ptrees.Tree],
    alignment,
    model,
    ncat: int = 1,
    steps: int = 40,
    params: Optional[Mapping] = None,
    batch_chunk: Optional[int] = 64,
    dtype=None,
    engine: Optional["TopologySetEngine"] = None,
    sharding=None,
    device="cuda",
):
    """``optimize_branch_lengths`` over a candidate set in fixed-size CHUNKS.

    The batched gradient keeps the walk's buffer and its cotangent, 2 x B x
    (n_nodes + 1) x K x patterns x S floats; chunking bounds that at
    ``batch_chunk`` candidates. ONE engine's schedule arrays are swapped
    per chunk (``set_candidates``) under a padded shape pinned to the
    candidate set's global (levels, width, children) dims, and the final
    chunk is padded by repeating its last tree. Pass ``engine`` (from a
    previous call with the same alignment/model/chunk size) to reuse it
    across calls, as the NNI searcher does across rounds. Returns
    (logliks (B,), brlens (B, n_nodes), sitewise (B, n_sites), engine).
    """
    if isinstance(alignment, pio.CompressedAlignment):
        ca = alignment
    else:
        ca = pio.compress_patterns(alignment, model.alphabet)
    # regroup + pad dims decided over the WHOLE candidate set up front so
    # every chunk shares one shape (a reused engine's sticky width wins)
    scheds = [ptrees.compile_schedule(t) for t in candidates]
    if engine is not None and engine._regroup_u is not None:
        u = engine._regroup_u
        if u:
            scheds = [ptrees.regroup_schedule(s, u) for s in scheds]
    else:
        u, scheds = choose_regroup_width(scheds)
    pad = (
        max(s.n_levels for s in scheds),
        max(s.width for s in scheds),
        max(s.n_children_max for s in scheds),
    )
    n = len(candidates)
    chunk = n if not batch_chunk else min(batch_chunk, n)
    tse = engine
    lls, bls, sws = [], [], []
    for b0 in range(0, n, chunk):
        sub = list(candidates[b0:b0 + chunk])
        pad_n = chunk - len(sub)
        if pad_n:
            sub = sub + [sub[-1]] * pad_n
        if tse is None:
            tse = TopologySetEngine(sub, ca, model, ncat=ncat, pad_to=pad,
                                    dtype=dtype, sharding=sharding,
                                    regroup=u, device=device)
        else:
            if tse._pad_dims is None or any(
                p > d for p, d in zip(pad, tse._pad_dims)
            ):
                tse._pad_dims = tuple(
                    max(p, d) for p, d in zip(
                        pad, tse._pad_dims or (0, 0, 0)
                    )
                )
            tse.set_candidates(sub)
        l, b = optimize_branch_lengths(tse, params=params, steps=steps)
        full = tse._full_params(params)
        full["branch_lengths"] = b
        sw = tse.sitewise_loglikelihoods(full)
        keep = chunk - pad_n
        lls.append(l[:keep])
        bls.append(b[:keep])
        sws.append(sw[:keep])
    return (np.concatenate(lls), np.concatenate(bls),
            np.concatenate(sws), tse)


def nni_hill_climb(
    tree,
    alignment,
    model,
    ncat: int = 1,
    max_rounds: int = 20,
    brlen_steps: int = 40,
    tol: float = 1e-6,
    verbose: bool = False,
    moves: str = "nni",
    spr_max_targets: Optional[int] = 8,
    batch_topologies: Optional[int] = 64,
    sharding=None,
    device="cuda",
):
    """Greedy tree search: score the whole rearrangement neighborhood (with
    per-candidate branch-length re-optimization) in chunked batched passes
    per round, move to the best neighbor until no improvement.

    ``moves``: "nni", "spr", or "both" (SPR explores long-range moves;
    ``spr_max_targets`` subsamples regraft edges per pruned subtree to
    bound neighborhood size). ``batch_topologies`` caps candidates per
    pass (the gradient's memory, see ``chunked_brlen_optimize``; None =
    one pass for the whole neighborhood). Returns (best_tree,
    best_loglik, n_rounds).
    """
    if moves not in ("nni", "spr", "both"):
        raise ValueError(f"unknown moves {moves!r}")
    if isinstance(tree, str):
        tree = pio.parse_newick(tree)
    current = tree
    current_ll = None
    engine = None   # persists across rounds: one width and padded shape
    for round_ in range(1, max_rounds + 1):
        nbrs = []
        if moves in ("nni", "both"):
            nbrs += ptrees.nni_neighbors(current)
        if moves in ("spr", "both"):
            nbrs += ptrees.spr_neighbors(current, max_targets=spr_max_targets,
                                         seed=round_)
        candidates = [current] + nbrs
        lls, brlens, _, engine = chunked_brlen_optimize(
            candidates, alignment, model, ncat=ncat, steps=brlen_steps,
            batch_chunk=batch_topologies, engine=engine, sharding=sharding,
            device=device,
        )
        best = int(np.argmax(lls))
        if verbose:
            print(f"round {round_}: current={lls[0]:.4f} "
                  f"best={lls[best]:.4f} (candidate {best})")
        if current_ll is None:
            current_ll = lls[0]
        if best == 0 or lls[best] <= lls[0] + tol:
            return current.with_lengths(brlens[0]), float(lls[0]), round_
        current = candidates[best].with_lengths(brlens[best])
        current_ll = lls[best]
    return current, float(current_ll), max_rounds
