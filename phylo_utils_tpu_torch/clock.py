"""Molecular clock models: branch lengths derived from node HEIGHTS (PyTorch
port of ``phylo_utils_tpu.clock``).

- ``ClockEngine``: strict clock (codeml clock=1): the tree is ULTRAMETRIC.
  Branch lengths are derived from free node heights; optional per-edge-class
  rate multipliers give LOCAL clocks (codeml clock=2).
- ``clock_test``: the molecular-clock LRT (Felsenstein 1981), strict clock
  (null) against free branch lengths, df = (identifiable branch lengths) -
  (clock parameters).
- ``node_height_errors``: delta-method standard errors of the node ages.
- ``penalized_likelihood_dating`` / ``cross_validate_lambda``: Sanderson's
  (2002) penalized-likelihood dating of a fitted phylogram, relative or
  calibrated, and the cross-validation of its smoothing strength.

Heights are a pure reparameterization of branch lengths, materialized inside
the likelihood: each non-root internal node carries a fraction f in (0, 1)
of its parent's height (sigmoid-constrained under ``fit``), the root a free
positive height, so ultrametricity and positive lengths hold by
construction. The map is one (static 0/1 ancestor matrix) @ log-fractions
product. ``ClockEngine`` overrides only the ``_mixture_tensors`` hook, so
its value and gradient are the base engine's (the fused kernels under
``pruner="cuda"``). The dating fits run Adam with optax's update (b1 0.9,
b2 0.999, eps 1e-8 added after the square root, bias-corrected), written
out in ``_adam`` and batched over a leading (mask, lambda) axis, so
``cross_validate_lambda``'s n_leaves x n_lambdas fits are one run.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from phylo_utils_tpu_torch.likelihood import (
    LikelihoodEngine,
    _checked_device,
    mixture_rates_and_p,
    validate_param_keys,
)
from phylo_utils_tpu_torch.trees import Tree

__all__ = ["ClockEngine", "clock_test", "node_height_errors",
           "penalized_likelihood_dating", "cross_validate_lambda", "mrca"]


def _clock_structure(tree: Tree):
    """Static index arrays for the height->branch-length map.

    Returns (internal_ids, anc, parent_slot, is_internal, node_slot,
    root_slot) where ``internal_ids[k]`` is the node id of internal slot k,
    ``anc[k, j] = 1`` iff non-root internal slot j is on the root->slot-k
    path (inclusive of k), and for every node i, ``parent_slot[i]`` is the
    internal slot of i's parent.
    """
    internal_ids = np.array(
        [i for i in range(tree.n_nodes) if tree.children[i]], np.int32
    )
    slot = {int(n): k for k, n in enumerate(internal_ids)}
    n_int = len(internal_ids)
    root_slot = slot[tree.root]
    # non-root internal slots, in the fractions vector's order
    frac_slots = [k for k in range(n_int) if k != root_slot]
    frac_pos = {k: p for p, k in enumerate(frac_slots)}
    anc = np.zeros((n_int, len(frac_slots)), np.float64)
    for k, nid in enumerate(internal_ids):
        node = int(nid)
        while node != -1:
            if tree.children[node] and node != tree.root:
                anc[k, frac_pos[slot[node]]] = 1.0
            node = int(tree.parent[node])
    parent_slot = np.array(
        [slot[int(tree.parent[i])] if tree.parent[i] != -1 else -1
         for i in range(tree.n_nodes)],
        np.int32,
    )
    is_internal = np.array(
        [1.0 if tree.children[i] else 0.0 for i in range(tree.n_nodes)]
    )
    node_slot = np.array(
        [slot.get(i, 0) for i in range(tree.n_nodes)], np.int32
    )
    return internal_ids, anc, parent_slot, is_internal, node_slot, root_slot


def _initial_heights(tree: Tree) -> np.ndarray:
    """Per-node initial height: mean root-to-leaf distance below the node
    (a least-squares-flavored ultrametricization of the input lengths)."""
    h = np.zeros(tree.n_nodes)
    counts = np.zeros(tree.n_nodes)
    for node in tree.postorder():
        kids = tree.children[node]
        if not kids:
            counts[node] = 1.0
            continue
        tot, n = 0.0, 0.0
        for c in kids:
            tot += (h[c] + tree.lengths[c]) * counts[c]
            n += counts[c]
        h[node] = tot / n
        counts[node] = n
    return h


class ClockEngine(LikelihoodEngine):
    """Likelihood engine under a strict (or local) molecular clock.

    Free parameters replace ``branch_lengths``:

    - ``root_height``: positive root age (in expected substitutions per
      site at rate 1).
    - ``height_fractions``: (n_internal - 1,) values in (0, 1); each
      non-root internal node's height is this fraction of its parent's.
    - ``rate_multipliers``: only with ``branch_classes`` (LOCAL clocks):
      one positive rate per class but class 0 (pinned to 1 for
      identifiability); edge lengths in class c are scaled by
      ``multipliers[c]``.

    Everything else (model params, +G/+I, pruner, device, gradients,
    posteriors) behaves as in ``LikelihoodEngine``; ``node_heights`` /
    ``chronogram`` expose the fitted ultrametric tree.
    """

    def __init__(self, tree, alignment, model,
                 branch_classes: Optional[Sequence[int]] = None, **kwargs):
        super().__init__(tree, alignment, model, **kwargs)
        (self._internal_ids, anc, parent_slot, is_internal, node_slot,
         self._root_slot) = _clock_structure(self.tree)
        dev = self.device
        self._anc = torch.as_tensor(anc, dtype=torch.float64, device=dev)
        self._parent_slot = torch.as_tensor(
            np.clip(parent_slot, 0, None), dtype=torch.int64, device=dev)
        self._is_internal = torch.as_tensor(is_internal, dtype=torch.float64,
                                            device=dev)
        self._node_slot = torch.as_tensor(node_slot, dtype=torch.int64,
                                          device=dev)
        self._not_root = torch.as_tensor(
            np.arange(self.tree.n_nodes) != self.tree.root, device=dev)
        self.n_internal = len(self._internal_ids)
        self._h0 = _initial_heights(self.tree)
        if branch_classes is not None:
            from phylo_utils_tpu_torch.branch_models import (
                _classes_from_mapping,
            )

            if isinstance(branch_classes, Mapping):
                cls = _classes_from_mapping(self.tree, branch_classes)
            else:
                cls = np.asarray(branch_classes, np.int32)
            if cls.shape != (self.tree.n_nodes,):
                raise ValueError(
                    f"branch_classes must have one entry per node "
                    f"({self.tree.n_nodes}), got {cls.shape}"
                )
            self.n_rate_classes = int(cls.max()) + 1
            self._cls = torch.as_tensor(cls, dtype=torch.int64, device=dev)
        else:
            self.n_rate_classes = 1
            self._cls = None

    # -- parameters -----------------------------------------------------

    def default_params(self) -> Dict:
        params = super().default_params()
        del params["branch_lengths"]
        h0 = self._h0
        root_h = max(float(h0[self.tree.root]), 1e-3)
        fracs = []
        for k, nid in enumerate(self._internal_ids):
            if k == self._root_slot:
                continue
            ph = max(float(h0[int(self.tree.parent[nid])]), 1e-9)
            fracs.append(min(max(float(h0[nid]) / ph, 0.05), 0.95))
        params["root_height"] = self._tensor(root_h)
        params["height_fractions"] = self._tensor(fracs)
        if self.n_rate_classes > 1:
            params["rate_multipliers"] = torch.ones(
                (self.n_rate_classes - 1,), dtype=self.dtype,
                device=self.device)
        return params

    def _full_params(self, params: Optional[Mapping]) -> Dict:
        full = self.default_params()
        if params:
            if "branch_lengths" in params:
                # more specific than the generic unknown-key guard
                raise ValueError(
                    "ClockEngine derives branch lengths from heights; "
                    "set root_height / height_fractions instead"
                )
            validate_param_keys(params, full, type(self).__name__,
                                nested="model")
            for k, v in params.items():
                if k == "model":
                    full["model"] = {**full["model"], **{
                        kk: self._tensor(vv) for kk, vv in v.items()}}
                else:
                    full[k] = self._tensor(v)
        return full

    # -- height -> branch-length map ------------------------------------

    def _heights(self, params, dtype) -> torch.Tensor:
        """(n_internal,) node heights from root_height + fractions."""
        h = params["root_height"].to(dtype).reshape(())
        f = params["height_fractions"].to(dtype).clamp(1e-6, 1.0 - 1e-6)
        # log h_k = log H + sum of log f over the root->k internal path (a
        # lone root: an empty sum, with the empty fractions in the graph)
        return h * torch.exp(self._anc.to(dtype) @ torch.log(f))

    def _branch_lengths(self, params, dtype) -> torch.Tensor:
        heights = self._heights(params, dtype)              # (n_int,)
        node_h = self._is_internal.to(dtype) * heights[self._node_slot]
        bl = heights[self._parent_slot] - node_h            # >= 0 by constr.
        if self._cls is not None:
            mult = torch.cat([
                torch.ones((1,), dtype=dtype, device=self.device),
                params["rate_multipliers"].to(dtype)])
            bl = bl * mult[self._cls]
        # the root's own entry is unused by the likelihood; zero it
        return torch.where(self._not_root, bl, torch.zeros_like(bl))

    def _mixture_tensors(self, params, dtype, eig=None, rates=None):
        """The base engine's mixture at the lengths the heights imply."""
        p2 = dict(params)
        p2["branch_lengths"] = self._branch_lengths(params, dtype)
        return mixture_rates_and_p(self, p2, dtype, eig=eig, rates=rates)

    # -- results ----------------------------------------------------------

    def node_heights(self,
                     params: Optional[Mapping] = None) -> Dict[int, float]:
        """Fitted height of every node (leaves are 0), keyed by node id."""
        full = self._full_params(params)
        with torch.no_grad():
            h = self._heights(full, self._reduce_dtype).to("cpu").numpy()
        out = {int(i): 0.0 for i in range(self.tree.n_leaves)}
        for k, nid in enumerate(self._internal_ids):
            out[int(nid)] = float(h[k])
        return out

    def chronogram(self, params: Optional[Mapping] = None) -> Tree:
        """The fitted ultrametric tree (lengths in height units, WITHOUT
        local-clock rate multipliers: a time tree)."""
        heights = self.node_heights(params)
        lengths = np.zeros(self.tree.n_nodes)
        for i in range(self.tree.n_nodes):
            p = int(self.tree.parent[i])
            if p != -1:
                lengths[i] = heights[p] - heights[i]
        return self.tree.with_lengths(lengths)


def clock_test(tree, alignment, model, ncat: int = 1,
               params0: Optional[Mapping] = None,
               engine_kwargs: Optional[Mapping] = None,
               **fit_kwargs) -> Dict:
    """Molecular-clock LRT (Felsenstein 1981): strict clock (null) vs.
    unconstrained branch lengths (alternative).

    df = identifiable branch lengths - clock height parameters. For a
    rooted binary tree of n extant taxa that is (2n-3) - (n-1) = n-2 (the
    two root edges are confounded without a clock). ``engine_kwargs`` go to
    both engines (``dtype``, ``pruner``, ``device``).
    """
    from phylo_utils_tpu_torch.model_selection import likelihood_ratio_test
    from phylo_utils_tpu_torch.optimize import fit

    engine_kwargs = dict(engine_kwargs or {})
    null = ClockEngine(tree, alignment, model, ncat=ncat, **engine_kwargs)
    alt = LikelihoodEngine(tree, alignment, model, ncat=ncat,
                           **engine_kwargs)
    null_fit = fit(null, params0=params0, **fit_kwargs)
    alt_fit = fit(alt, **fit_kwargs)
    n_edges = null.tree.n_nodes - 1
    root_children = len(null.tree.children[null.tree.root])
    n_bl = n_edges - (1 if root_children == 2 else 0)
    n_clock = null.n_internal + (null.n_rate_classes - 1)
    df = max(n_bl - n_clock, 1)
    lrt = likelihood_ratio_test(null_fit.loglik, alt_fit.loglik, df=df)
    return {
        "null": null_fit, "alt": alt_fit, "lrt": lrt, "df": df,
        "null_engine": null, "alt_engine": alt,
    }


def node_height_errors(engine: ClockEngine,
                       params: Optional[Mapping] = None) -> Dict[int, float]:
    """Asymptotic standard errors of the fitted node heights (ages).

    Delta method on the height map: var(h) = J cov J^T with J the exact
    Jacobian of the map (``torch.autograd.functional.jacobian``) and cov
    the observed-information covariance of the clock parameters at the MLEs
    (``optimize.fisher_covariance`` over root_height, height_fractions and
    the rate multipliers). Returns {node id: SE} for internal nodes.
    """
    from phylo_utils_tpu_torch.optimize import fisher_covariance

    full = engine._full_params(params)
    free = ["root_height"]
    if engine.n_internal > 1:
        free.append("height_fractions")
    if engine.n_rate_classes > 1:
        free.append("rate_multipliers")
    cov, (names, leaves, sizes) = fisher_covariance(engine, full,
                                                    free=tuple(free))
    keys = [path[0] for path in names]

    def heights_of(*vals):
        q = dict(full)
        q.update(zip(keys, vals))
        return engine._heights(q, torch.float64)

    jac = torch.autograd.functional.jacobian(
        heights_of, tuple(full[k].detach().to(torch.float64) for k in keys))
    n_h = engine.n_internal
    # columns in the covariance's (flattened) parameter order
    J = np.concatenate([j.detach().to("cpu").numpy().reshape(n_h, sz)
                        for j, sz in zip(jac, sizes)], axis=1)
    var = np.einsum("ip,pq,iq->i", J, np.nan_to_num(cov), J)
    var[~(var >= 0)] = np.nan
    se = np.sqrt(var)
    return {int(nid): float(se[k])
            for k, nid in enumerate(engine._internal_ids)}


def mrca(tree: Tree, names: Sequence[str]) -> int:
    """Node id of the most recent common ancestor of the named leaves."""
    idx = {n: i for i, n in enumerate(tree.leaf_names)}
    try:
        ids = [idx[n] for n in names]
    except KeyError as e:
        raise ValueError(f"unknown leaf name {e.args[0]!r}") from None
    if not ids:
        raise ValueError("mrca() needs at least one leaf name")

    def ancestors(i):
        out = []
        while i != -1:
            out.append(int(i))
            i = int(tree.parent[i])
        return out

    common = set(ancestors(ids[0]))
    for i in ids[1:]:
        common &= set(ancestors(i))
    # the MRCA is the first common entry walking up from any member
    for a in ancestors(ids[0]):
        if a in common:
            return a
    raise AssertionError("unreachable: the root is always common")


def _adam(params, grad_fn, steps: int, lr: float,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """``steps`` Adam steps from ``params`` (a list of tensors) with
    optax's ``adam`` update, minimizing: ``grad_fn(params)`` returns the
    gradients. m and v start at zero; the step is -lr m_hat / (sqrt(v_hat)
    + eps) with m_hat = m / (1 - b1^t), v_hat = v / (1 - b2^t)."""
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    for t in range(1, steps + 1):
        grads = grad_fn(params)
        new = []
        for i, (p, g) in enumerate(zip(params, grads)):
            m[i] = b1 * m[i] + (1.0 - b1) * g
            v[i] = b2 * v[i] + (1.0 - b2) * g * g
            m_hat = m[i] / (1.0 - b1 ** t)
            v_hat = v[i] / (1.0 - b2 ** t)
            new.append(p - lr * m_hat / (torch.sqrt(v_hat) + eps))
        params = new
    return params


class _PLProblem:
    """Shared machinery for penalized-likelihood dating fits.

    One batched Adam run serves any number of (Poisson mask, lambda)
    combinations: the fit's parameters carry a leading batch axis, one
    row a (mask, lambda) pair, and the objective sums the rows' (the rows
    are independent, so each row's gradient is its own fit's). That makes
    leave-one-out cross-validation over a lambda grid (n_leaves x n_lambdas
    fits) one run of ``steps`` steps. Float64 on ``device``.
    """

    def __init__(self, tree: Tree, n_sites: int, root_age: float,
                 free_root: bool, calib, calibration_weight: float,
                 steps: int, lr: float, device="cuda"):
        (internal_ids, anc, parent_slot, is_internal, node_slot,
         root_slot) = _clock_structure(tree)
        self.device = dev = _checked_device(device)
        f64 = torch.float64
        self.tree = tree
        self.n_sites = n_sites
        self.internal_ids = internal_ids
        self.n_int = n_int = len(internal_ids)
        self.root_slot = root_slot
        self.free_root = free_root
        self.root_age = root_age
        self.steps, self.lr = steps, lr
        self.calibration_weight = calibration_weight
        h0 = _initial_heights(tree)
        h0_int = np.maximum(h0[internal_ids], 1e-6)
        fr0 = []
        for k, nid in enumerate(internal_ids):
            if k == root_slot:
                continue
            par = int(tree.parent[int(nid)])
            fr0.append(
                min(max(h0_int[k] / max(h0[par], 1e-9), 1e-3), 1.0 - 1e-3)
            )
        fr0 = np.asarray(fr0, np.float64)
        r0 = max(float(h0[tree.root]) / max(root_age, 1e-9), 1e-6)

        def t(x, dtype=f64):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        root, n_nodes = tree.root, tree.n_nodes
        parent = np.asarray(tree.parent)
        self._counts = t(np.asarray(tree.lengths, np.float64) * n_sites)
        self._nonroot = t([0.0 if i == root else 1.0 for i in range(n_nodes)])
        self._parent_of = t([int(parent[i]) if parent[i] != -1 else 0
                             for i in range(n_nodes)], torch.int64)
        self._is_root_child = t([1.0 if int(parent[i]) == root else 0.0
                                 for i in range(n_nodes)])
        self._child_mask = t([1.0 if (parent[i] != -1 and parent[i] != root)
                              else 0.0 for i in range(n_nodes)])
        self._anc = t(anc)
        self._parent_slot = t(np.clip(parent_slot, 0, None), torch.int64)
        self._node_slot = t(node_slot, torch.int64)
        self._is_internal = t(is_internal)
        if calib:
            self._calib = (t([c[0] for c in calib], torch.int64),
                           t([c[1] for c in calib]), t([c[2] for c in calib]))
        else:
            self._calib = None
        self.raw0 = (t(np.log(fr0 / (1 - fr0))),
                     t(np.full(n_nodes, np.log(r0))),
                     t(np.log(max(root_age, 1e-9))))

    def _heights(self, raw_f, log_h):
        """(B, n_int) heights; raw_f (B, n_int - 1), log_h (B,)."""
        big_h = (torch.exp(log_h) if self.free_root
                 else torch.full_like(log_h, self.root_age))
        if self.n_int > 1:
            f = torch.sigmoid(raw_f)
            return big_h[:, None] * torch.exp(torch.log(f) @ self._anc.T)
        return big_h[:, None].expand(-1, 1)

    def durations(self, raw_f, log_h):
        """((B, n_nodes) edge durations >= 1e-9, (B, n_int) heights)."""
        h = self._heights(raw_f, log_h)
        node_h = self._is_internal * h[:, self._node_slot]
        parent_h = h[:, self._parent_slot]
        return (parent_h - node_h).clamp_min(1e-9), h

    def objective(self, raw, mask, lam):
        """(B,) penalized log-likelihoods: raw = (raw_f (B, n_int - 1),
        log_r (B, n_nodes), log_h (B,)), mask (B, n_nodes), lam (B,)."""
        raw_f, log_r, log_h = raw
        d, h = self.durations(raw_f, log_h)
        r = torch.exp(log_r)
        mu = r * d * self.n_sites
        m = self._nonroot * mask
        pois = (m * (self._counts * torch.log(mu) - mu)).sum(dim=-1)
        diff = ((r - r[:, self._parent_of]) ** 2 * self._child_mask).sum(
            dim=-1)
        rc = self._is_root_child
        nrc = rc.sum()
        mean_rc = (r * rc).sum(dim=-1) / nrc
        var_rc = (rc * (r - mean_rc[:, None]) ** 2).sum(dim=-1) / nrc
        obj = pois - lam * self.n_sites * (diff + var_rc)
        if self._calib is not None:
            slots, lo, hi = self._calib
            hc = h[:, slots]
            viol = ((lo - hc).clamp_min(0.0) ** 2
                    + (hc - hi).clamp_min(0.0) ** 2)
            obj = obj - self.calibration_weight * self.n_sites * viol.sum(
                dim=-1)
        return obj

    def fit(self, masks=None, lams=(1.0,)):
        """Fits of every row of ``masks`` (B, n_nodes) with its lambda
        (``lams`` (B,)) from the same start: (raw rows, (B,) objectives at
        the returned parameters)."""
        lam = torch.as_tensor(np.asarray(lams, np.float64),
                              device=self.device).reshape(-1)
        b = lam.shape[0]
        if masks is None:
            masks = torch.ones((b, self.tree.n_nodes), dtype=torch.float64,
                               device=self.device)
        masks = torch.as_tensor(masks, dtype=torch.float64,
                                device=self.device)
        raw0 = [x[None].expand((b,) + x.shape).clone() for x in self.raw0]

        def grads(raw):
            raw = [x.detach().requires_grad_(True) for x in raw]
            with torch.enable_grad():
                loss = -self.objective(raw, masks, lam).sum()
                # a fixed root leaves log_h out of the graph: gradient 0
                g = torch.autograd.grad(loss, raw, allow_unused=True)
            return [torch.zeros_like(x) if gi is None else gi
                    for x, gi in zip(raw, g)]

        raw = _adam(raw0, grads, self.steps, self.lr)
        with torch.no_grad():
            # the objective AT the returned parameters
            obj = self.objective(raw, masks, lam)
        return raw, obj

    def unpack(self, raw, row: int = 0):
        """(durations, heights, rates (root entry 0)) of one row, numpy."""
        with torch.no_grad():
            d, h = self.durations(raw[0][row:row + 1], raw[2][row:row + 1])
            rates = torch.exp(raw[1][row]).to("cpu").numpy().copy()
        rates[self.tree.root] = 0.0
        return d[0].to("cpu").numpy(), h[0].to("cpu").numpy(), rates


def _resolve_calibrations(tree: Tree, internal_ids, calibrations):
    """Normalize {node-spec: age or (lo, hi)} to [(slot, lo, hi), ...].

    A node-spec is an internal node id (int) or a sequence of leaf names
    (resolved to their MRCA). A scalar age is an exact calibration (lo ==
    hi); None bounds are open (lo=0 / hi=+inf).
    """
    slot_of = {int(n): k for k, n in enumerate(internal_ids)}
    out = []
    for spec, bounds in calibrations.items():
        node = spec if isinstance(spec, (int, np.integer)) else mrca(
            tree, tuple(spec)
        )
        if int(node) not in slot_of:
            raise ValueError(
                f"calibration target {spec!r} -> node {node} is not an "
                "internal node"
            )
        if np.isscalar(bounds):
            lo = hi = float(bounds)
        else:
            lo, hi = bounds
            lo = 0.0 if lo is None else float(lo)
            hi = np.inf if hi is None else float(hi)
        if lo > hi:
            raise ValueError(f"calibration {spec!r}: min {lo} > max {hi}")
        out.append((slot_of[int(node)], lo, hi))
    return out


def penalized_likelihood_dating(
    tree: Tree,
    n_sites: int,
    root_age: float = 1.0,
    lam: float = 1.0,
    steps: int = 2000,
    lr: float = 0.02,
    calibrations: Optional[Mapping] = None,
    calibration_weight: float = 1e3,
    device="cuda",
):
    """Penalized-likelihood divergence dating (Sanderson 2002, MBE 19:101:
    the r8s/ape-chronos semiparametric method).

    Takes a fitted PHYLOGRAM (branch lengths in expected substitutions per
    site) and estimates node AGES plus per-edge substitution rates by
    maximizing a Poisson likelihood of the per-branch substitution counts
    ``n_e = b_e * n_sites`` against ``r_e * d_e * n_sites`` (``d_e`` = branch
    duration from the ages), minus ``lam * n_sites * (sum over parent-child
    edge pairs of (r_child - r_parent)^2 + Var(rates at the root))``:
    Sanderson's autocorrelation penalty, scaled by the alignment length so
    ``lam`` is a per-site smoothing strength. Large ``lam`` approaches a
    strict clock. Choose ``lam`` with ``cross_validate_lambda``.

    Ages are parameterized as in ``ClockEngine`` (root age times per-node
    fractions, monotone by construction); ``steps`` Adam steps of rate
    ``lr`` (optax's update) from the ultrametricized input lengths.

    ``calibrations`` enables ABSOLUTE dating (r8s fixage/constrain): a
    mapping from node spec (an internal node id, or a sequence of leaf
    names resolved to their MRCA) to an exact age (scalar) or a ``(min_age,
    max_age)`` interval (either side None = open). With calibrations the
    root age is FREE (without them the Poisson term is scale-invariant in
    ages x rates, so the root is FIXED at ``root_age``). Calibrations are
    quadratic hinge penalties of weight ``calibration_weight * n_sites``.

    ``device``: where the fit runs (default the card; "cpu" to run there).
    Returns {"ages": {node id: age}, "rates": (n_nodes,) per-edge rates
    (root entry 0), "chronogram": Tree with branch lengths in time units,
    "objective": final penalized logL, "max_calibration_violation": worst
    hinge residual (0.0 without calibrations)}.
    """
    (internal_ids, _anc, _ps, _ii, _ns, _rs) = _clock_structure(tree)
    calib = (
        _resolve_calibrations(tree, internal_ids, calibrations)
        if calibrations else []
    )
    if calib:
        finite = [c[1] for c in calib if np.isfinite(c[1]) and c[1] > 0]
        finite += [c[2] for c in calib if np.isfinite(c[2]) and c[2] > 0]
        root_age = max(finite) * 1.5 if finite else root_age
    prob = _PLProblem(
        tree, n_sites, root_age, free_root=bool(calib), calib=calib,
        calibration_weight=calibration_weight, steps=steps, lr=lr,
        device=device,
    )
    raw, final_obj = prob.fit(lams=(lam,))
    d, h, rates = prob.unpack(raw)
    ages = {int(nid): float(h[k]) for k, nid in enumerate(internal_ids)}
    for i in range(tree.n_leaves):
        ages[i] = 0.0
    chron = tree.with_lengths(np.where(
        np.arange(tree.n_nodes) == tree.root, 0.0, d
    ))
    viol = 0.0
    for slot, lo, hi in calib:
        viol = max(viol, lo - float(h[slot]), float(h[slot]) - hi, 0.0)
    return {
        "ages": ages,
        "rates": rates,
        "chronogram": chron,
        "objective": float(final_obj[0]),
        "max_calibration_violation": float(viol),
    }


def cross_validate_lambda(
    tree: Tree,
    n_sites: int,
    lambdas: Sequence[float] = (0.01, 0.1, 1.0, 10.0, 100.0),
    root_age: float = 1.0,
    steps: int = 1500,
    lr: float = 0.02,
    device="cuda",
) -> Dict:
    """Sanderson's fitted cross-validation for the smoothing strength.

    For each lambda and each TERMINAL edge e: refit the dating problem with
    e's Poisson term masked out, predict its substitution count from the
    refitted ages and its parent edge's rate (``n_hat_e = r_parent * d_e *
    n_sites``; for children of the root, the mean rate of the root's other
    edges), and score ``sum_e (n_e - n_hat_e)^2 / n_hat_e`` (Sanderson 2002
    eq. 12). The lambda with the smallest CV score generalizes best.

    The n_leaves x n_lambdas fits run as one batched fit (``_PLProblem``),
    one row a (leaf, lambda) pair. Returns {"lambda": best, "scores":
    {lambda: score}}.
    """
    prob = _PLProblem(tree, n_sites, root_age, free_root=False, calib=[],
                      calibration_weight=0.0, steps=steps, lr=lr,
                      device=device)
    counts = np.asarray(tree.lengths, np.float64) * n_sites
    root = tree.root
    parent = np.asarray(tree.parent)
    rows = [(float(lam), leaf) for lam in lambdas
            for leaf in range(tree.n_leaves)]
    masks = np.ones((len(rows), tree.n_nodes))
    for i, (_, leaf) in enumerate(rows):
        masks[i, leaf] = 0.0
    raw, _ = prob.fit(masks=masks, lams=[lam for lam, _ in rows])
    scores: Dict[float, float] = {float(lam): 0.0 for lam in lambdas}
    for i, (lam, leaf) in enumerate(rows):
        d, _h, rates = prob.unpack(raw, i)
        p = int(parent[leaf])
        if p != root:
            r_pred = rates[p]
        else:
            sibs = [c for c in tree.children[root] if c != leaf]
            r_pred = float(np.mean([rates[c] for c in sibs]))
        n_hat = max(r_pred * d[leaf] * n_sites, 1e-9)
        scores[lam] += (counts[leaf] - n_hat) ** 2 / n_hat
    scores = {k: float(v) for k, v in scores.items()}
    best = min(scores, key=scores.get)
    return {"lambda": best, "scores": scores}
