"""Branch models: substitution parameters that vary ACROSS EDGES (PyTorch
port of ``phylo_utils_tpu.branch_models``).

Every edge carries a class label and each class has its own model
parameters (the PAML codeml extension family):

- ``BranchModelEngine``: general per-edge classes over any reversible
  model: two-ratio / multi-ratio omega models (codeml model=2), per-branch
  kappa, non-homogeneous GTR, and the free-ratio model (codeml model=1, one
  omega per edge). Composes with +G and +I.
- ``BranchSiteAEngine``: branch-site Model A (Yang & Nielsen 2002; Zhang et
  al. 2005): four site classes whose omega differs between FOREGROUND and
  BACKGROUND edges; ``branch_site_test`` is the LRT for positive selection
  on a lineage and ``beb_branch_site`` its Bayes Empirical Bayes site scan.

The per-class (sym, freqs) are built by one ``torch.func.vmap`` over the
model's builder, P(t) by one batched ``p_matrices_reversible`` over a
leading class dimension (one batched ``eigh``), and the per-edge matrix is
one gather. The engines override only the ``_mixture_tensors`` hook, so
everything downstream is the base engine's: under ``pruner="cuda"`` the
value walks (B1/B4/B5/B8/B9) and the gradient's saveall + reverse kernels
(B2 + B3 or B7), the fits, the standard errors and the ancestral analyses.
``_branch_site_pair_logliks`` sends chunks of 32 (omega_bg, omega_fg)
pairs through ``engine._prune`` as 32 categories of one walk.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence

import numpy as np
import torch

from phylo_utils_tpu_torch.likelihood import (
    LikelihoodEngine,
    rate_categories,
    validate_param_keys,
)
from phylo_utils_tpu_torch.ops.pmatrix import (
    extend_p_identity,
    p_matrices_reversible,
)
from phylo_utils_tpu_torch.parallel.sharding import gather_sites
from phylo_utils_tpu_torch.trees import Tree

__all__ = [
    "BranchModelEngine",
    "BranchSiteAEngine",
    "branch_site_test",
    "beb_branch_site",
    "mark_branches",
    "mark_clade",
    "free_ratio_classes",
]


# ---------------------------------------------------------------------------
# Edge-class construction helpers
# ---------------------------------------------------------------------------


def mark_branches(tree: Tree, names: Iterable[str], cls: int = 1,
                  base: Optional[np.ndarray] = None) -> np.ndarray:
    """Edge classes with the parent edges of the NAMED nodes set to ``cls``.

    ``names`` may contain leaf names or internal-node labels (as parsed
    from the Newick). Everything else keeps class 0 (or ``base``). This is
    the analog of codeml's ``#1`` branch marks.
    """
    out = (np.zeros(tree.n_nodes, np.int32) if base is None
           else np.asarray(base, np.int32).copy())
    wanted = set(names)
    found = set()
    for i, n in enumerate(tree.names):
        if n in wanted:
            out[i] = cls
            found.add(n)
    missing = wanted - found
    if missing:
        raise ValueError(f"tree has no nodes named {sorted(missing)}")
    return out


def mark_clade(tree: Tree, leaf_names: Iterable[str], cls: int = 1,
               include_stem: bool = True,
               base: Optional[np.ndarray] = None) -> np.ndarray:
    """Edge classes with every edge inside the clade spanned by
    ``leaf_names`` set to ``cls`` (codeml's ``$1`` clade marks).

    The clade is the subtree under the MRCA of ``leaf_names``;
    ``include_stem`` also marks the MRCA's own parent edge.
    """
    idx = tree.leaf_index()
    try:
        leaves = [idx[n] for n in leaf_names]
    except KeyError as e:
        raise ValueError(f"unknown leaf {e.args[0]!r}") from None
    if not leaves:
        raise ValueError("empty clade")
    paths = []
    for leaf in leaves:
        path, node = [], leaf
        while node != -1:
            path.append(node)
            node = int(tree.parent[node])
        paths.append(path)
    common = set(paths[0])
    for p in paths[1:]:
        common &= set(p)
    mrca = next(n for n in paths[0] if n in common)
    out = (np.zeros(tree.n_nodes, np.int32) if base is None
           else np.asarray(base, np.int32).copy())
    stack = list(tree.children[mrca])
    while stack:
        n = stack.pop()
        out[n] = cls
        stack.extend(tree.children[n])
    if include_stem and tree.parent[mrca] != -1:
        out[mrca] = cls
    return out


def free_ratio_classes(tree: Tree) -> np.ndarray:
    """One class per edge (codeml model=1, the free-ratio model)."""
    return np.arange(tree.n_nodes, dtype=np.int32)


def _normalize_classes(tree: Tree, branch_classes,
                       n_classes: int) -> np.ndarray:
    if isinstance(branch_classes, Mapping):
        branch_classes = _classes_from_mapping(tree, branch_classes)
    cls = np.asarray(branch_classes, np.int32)
    if cls.shape != (tree.n_nodes,):
        raise ValueError(
            f"branch_classes must have one entry per node "
            f"({tree.n_nodes}), got shape {cls.shape}"
        )
    if cls.min() < 0 or cls.max() >= n_classes:
        raise ValueError(
            f"branch class ids must be in [0, {n_classes}); "
            f"got [{cls.min()}, {cls.max()}]"
        )
    return cls


def _classes_from_mapping(tree: Tree,
                          mapping: Mapping[str, int]) -> np.ndarray:
    out = np.zeros(tree.n_nodes, np.int32)
    wanted = dict(mapping)
    for i, n in enumerate(tree.names):
        if n in wanted:
            out[i] = wanted.pop(n)
    if wanted:
        raise ValueError(f"tree has no nodes named {sorted(wanted)}")
    return out


def _stack_class_params(class_params: Sequence[Mapping], dtype,
                        device) -> Dict:
    keys = set(class_params[0].keys())
    for d in class_params[1:]:
        if set(d.keys()) != keys:
            raise ValueError("branch classes must share parameter names")
    return {
        k: torch.stack([torch.as_tensor(d[k], dtype=dtype, device=device)
                        for d in class_params])
        for k in keys
    }


def _class_builds(model, stacked: Mapping[str, torch.Tensor]):
    """(sym (C, S, S), freqs (C, S)): ``model``'s builder mapped over the
    stacked class parameters by ``torch.func.vmap`` (differentiable)."""
    keys = list(stacked)
    return torch.func.vmap(
        lambda *vals: model.build(**dict(zip(keys, vals))))(
        *stacked.values())


def _broadcast_shared(shared: Mapping, c: int, dtype) -> Dict:
    """The shared parameters repeated over ``c`` classes."""
    return {k: v.to(dtype)[None].expand((c,) + tuple(v.shape))
            for k, v in shared.items()}


# ---------------------------------------------------------------------------
# General per-edge-class engine
# ---------------------------------------------------------------------------


class BranchModelEngine(LikelihoodEngine):
    """Likelihood engine whose model parameters vary by EDGE CLASS.

    Parameters
    ----------
    tree, alignment, model : as LikelihoodEngine (model must be reversible)
    branch_classes : int array (n_nodes,): class of each node's parent
        edge (root entry unused), or a mapping ``{node name: class}`` with
        unnamed nodes defaulting to class 0. Build with ``mark_branches`` /
        ``mark_clade`` / ``free_ratio_classes``.
    class_params : list of per-class parameter dicts (same keys in every
        class, e.g. ``[{"omega": 0.2}, {"omega": 1.5}]`` for a two-ratio
        model). These become the free ``params["classes"]`` dict of
        (n_classes,) tensors.
    shared : overrides for the model parameters NOT listed per class
        (e.g. kappa, freqs); they are broadcast to every class and exposed
        as the free ``params["shared"]`` dict.
    ncat / invariant_sites : +G and +I compose as usual; rate categories
        scale branch lengths identically in every class.
    Other keyword arguments go to ``LikelihoodEngine`` (``dtype``,
    ``pruner``, ``device``).

    Root frequencies are those of the ROOT node's class (class 0 unless
    remapped), codeml's convention; supplying per-class ``freqs`` makes the
    process non-stationary and the root-class frequencies act as the root
    prior.
    """

    def __init__(self, tree, alignment, model, branch_classes,
                 class_params: Sequence[Mapping],
                 shared: Optional[Mapping] = None, **kwargs):
        if not model.reversible:
            raise ValueError("branch models require a reversible model")
        if len(class_params) < 1:
            raise ValueError("need at least one branch class")
        super().__init__(tree, alignment, model, **kwargs)
        self.n_classes = len(class_params)
        cls = _normalize_classes(self.tree, branch_classes, self.n_classes)
        self._cls_host = cls
        self._cls = torch.as_tensor(cls, dtype=torch.int64,
                                    device=self.device)
        self._root_class = int(cls[self.tree.root])
        # free-ratio-style: classes == edges, identity mapping -> pair the
        # class and edge axes instead of materializing the (C, E) cross
        # product (quadratic in tree size)
        self._paired = bool(
            self.n_classes == self.tree.n_nodes
            and np.array_equal(cls, np.arange(self.tree.n_nodes))
        )
        class_keys = set(class_params[0].keys())
        unknown = class_keys - set(model.param_defaults)
        if unknown:
            raise ValueError(f"unknown model parameters {sorted(unknown)}")
        self._class_params0 = [dict(d) for d in class_params]
        shared0 = {
            k: v for k, v in model.param_defaults.items()
            if k not in class_keys
        }
        if shared:
            unknown = set(shared) - set(shared0)
            if unknown:
                raise ValueError(
                    f"shared overrides {sorted(unknown)} are per-class "
                    f"parameters or unknown"
                )
            shared0.update(shared)
        self._shared0 = shared0

    # -- parameters -----------------------------------------------------

    def _rate_defaults(self, params: Dict) -> Dict:
        if self.ncat > 1:
            if self.rate_model == "free":
                params["rates"] = torch.linspace(
                    0.2, 2.0, self.ncat, dtype=self.dtype,
                    device=self.device)
                params["cat_weights"] = torch.full(
                    (self.ncat,), 1.0 / self.ncat, dtype=self.dtype,
                    device=self.device)
            else:
                params["alpha"] = self._tensor(0.5)
        if self.invariant_sites:
            params["pinv"] = self._tensor(0.2)
        return params

    def default_params(self) -> Dict:
        return self._rate_defaults({
            "branch_lengths": self._tensor(self.tree.lengths),
            "shared": {k: self._tensor(v) for k, v in self._shared0.items()},
            "classes": _stack_class_params(self._class_params0, self.dtype,
                                           self.device),
        })

    def _full_params(self, params: Optional[Mapping]) -> Dict:
        full = self.default_params()
        if params:
            validate_param_keys(params, full, type(self).__name__,
                                nested="shared")
            for k, v in params.items():
                if k in ("shared", "classes"):
                    full[k] = {**full[k], **{
                        kk: self._tensor(vv) for kk, vv in v.items()}}
                else:
                    full[k] = self._tensor(v)
        return full

    def _flat_directions(self, names, leaves):
        """The root split (``LikelihoodEngine._flat_directions``) only where
        both root edges carry one class whose model is stationary at the
        root's frequencies: that class is the root's, or the classes share
        their frequencies."""
        kids = self.tree.children[self.tree.root]
        if len(kids) != 2:
            return []
        c1, c2 = (int(self._cls_host[k]) for k in kids)
        if c1 != c2 or (c1 != self._root_class
                        and "freqs" in self._class_params0[0]):
            return []
        return super()._flat_directions(names, leaves)

    # -- mixture hook -----------------------------------------------------

    def _mixture_tensors(self, params, dtype, eig=None, rates=None):
        """(rates, cat_weights, P (n_nodes, K, S, S), root frequencies):
        the classes' models built by one vmap, their P by one batched
        product over the class dim, then one gather per edge. ``eig`` does
        not apply (no single model) and is ignored."""
        rates, cat_weights = rate_categories(self, params, dtype,
                                             rates=rates)
        t = params["branch_lengths"].to(dtype)
        ts = t[:, None] * rates[None, :]                     # (E, K)
        c = self.n_classes
        stacked = _broadcast_shared(params["shared"], c, dtype)
        stacked.update({k: v.to(dtype)
                        for k, v in params["classes"].items()})
        sym_c, freqs_c = _class_builds(self.model, stacked)  # (C,S,S),(C,S)
        sym_c, freqs_c = sym_c.to(dtype), freqs_c.to(dtype)
        if self._paired:
            # free-ratio: class i IS edge i, so pair the axes
            p = p_matrices_reversible(sym_c, freqs_c, ts)    # (E, K, S, S)
        else:
            p_c = p_matrices_reversible(
                sym_c, freqs_c, ts[None].expand((c,) + ts.shape))
            p = p_c[self._cls, torch.arange(ts.shape[0],
                                            device=self.device)]
        p = extend_p_identity(p, self.schedule.n_nodes)
        return rates, cat_weights, p, freqs_c[self._root_class]


# ---------------------------------------------------------------------------
# Branch-site Model A
# ---------------------------------------------------------------------------


class BranchSiteAEngine(LikelihoodEngine):
    """Branch-site Model A (Yang & Nielsen 2002; Zhang et al. 2005).

    Codon sites fall into four classes that differ between FOREGROUND
    (class-1) and BACKGROUND (class-0) edges:

    ========  ==========  ==========  ================================
    class     background  foreground  weight
    ========  ==========  ==========  ================================
    0         omega0      omega0      p0
    1         1           1           p1
    2a        omega0      omega2      (1-p0-p1) * p0/(p0+p1)
    2b        1           omega2      (1-p0-p1) * p1/(p0+p1)
    ========  ==========  ==========  ================================

    with 0 < omega0 < 1 <= omega2. Free parameters: ``proportions`` (p0,
    p1, p2 simplex), ``omega0`` (unit interval), ``omega2_delta`` (omega2 =
    1 + delta, softplus-positive under ``fit``), ``shared`` (kappa, codon
    frequencies), branch lengths. The null model of the branch-site
    positive-selection test fixes omega2 = 1 (``free`` without
    ``omega2_delta`` and ``omega2_delta = 0``); ``branch_site_test`` runs
    both fits and the df=1 LRT.
    """

    def __init__(self, tree, alignment, foreground, model=None, **kwargs):
        if model is None:
            from phylo_utils_tpu_torch.models import GY94 as model
        if not model.reversible:
            raise ValueError("branch-site models require a reversible model")
        if "omega" not in model.param_defaults:
            raise ValueError("branch-site Model A needs an 'omega' parameter")
        kwargs.pop("ncat", None)
        super().__init__(tree, alignment, model, ncat=4, **kwargs)
        cls = (_classes_from_mapping(self.tree, foreground)
               if isinstance(foreground, Mapping)
               else np.asarray(foreground, np.int32))
        self._cls_host = _normalize_classes(self.tree, cls, 2)
        self._cls = torch.as_tensor(self._cls_host, dtype=torch.int64,
                                    device=self.device)
        self._shared0 = {
            k: v for k, v in model.param_defaults.items() if k != "omega"
        }

    def default_params(self) -> Dict:
        params: Dict = {
            "branch_lengths": self._tensor(self.tree.lengths),
            "shared": {k: self._tensor(v) for k, v in self._shared0.items()},
            "proportions": self._tensor([0.7, 0.2, 0.1]),
            "omega0": self._tensor(0.2),
            "omega2_delta": self._tensor(1.0),
        }
        if self.invariant_sites:
            params["pinv"] = self._tensor(0.2)
        return params

    def _full_params(self, params: Optional[Mapping]) -> Dict:
        full = self.default_params()
        if params:
            validate_param_keys(params, full, type(self).__name__,
                                nested="shared")
            for k, v in params.items():
                if k == "shared":
                    full["shared"] = {**full["shared"], **{
                        kk: self._tensor(vv) for kk, vv in v.items()}}
                else:
                    full[k] = self._tensor(v)
        return full

    def _flat_directions(self, names, leaves):
        """The root split where both root edges are background or both
        foreground: each site class then has one model on both."""
        kids = self.tree.children[self.tree.root]
        if len(kids) != 2 or (self._cls_host[kids[0]]
                              != self._cls_host[kids[1]]):
            return []
        return super()._flat_directions(names, leaves)

    # site-class omega table: rows = the 4 site classes, cols = edge class
    # (0 background, 1 foreground), entries index into (omega0, 1, omega2)
    _OMEGA_IDX = np.array([[0, 0], [1, 1], [0, 2], [1, 2]], np.int64)

    def _mixture_tensors(self, params, dtype, eig=None, rates=None):
        """(ones (4,), site-class weights (4,), P (n_nodes, 4, S, S),
        frequencies): three models (omega0, 1, omega2) built by one vmap,
        their P by one batched product, each edge's four site classes
        gathered from them. ``eig`` and ``rates`` do not apply."""
        t = params["branch_lengths"].to(dtype)               # (E,)
        n_edges = t.shape[0]
        om0 = params["omega0"].to(dtype).clamp(1e-8, 1.0 - 1e-8)
        om2 = 1.0 + params["omega2_delta"].to(dtype)
        omegas = torch.stack([om0, torch.ones_like(om0), om2])  # (3,)
        stacked = _broadcast_shared(params["shared"], 3, dtype)
        stacked["omega"] = omegas
        sym_u, freqs_u = _class_builds(self.model, stacked)
        sym_u, freqs_u = sym_u.to(dtype), freqs_u.to(dtype)
        p_u = p_matrices_reversible(sym_u, freqs_u,
                                    t[None].expand(3, n_edges))  # (3,E,S,S)
        midx = torch.as_tensor(self._OMEGA_IDX, device=self.device)[
            :, self._cls]                                     # (4, E)
        p = p_u[midx, torch.arange(n_edges, device=self.device)[None, :]]
        p = extend_p_identity(p.transpose(0, 1), self.schedule.n_nodes)

        prop = params["proportions"].to(dtype)
        prop = prop / prop.sum()
        p0, p1, p2 = prop[0], prop[1], prop[2]
        denom = (p0 + p1).clamp_min(1e-30)
        cat_weights = torch.stack([p0, p1, p2 * p0 / denom,
                                   p2 * p1 / denom])
        return (torch.ones((4,), dtype=dtype, device=self.device),
                cat_weights, p, freqs_u[0])


def branch_site_test(tree, alignment, foreground, model=None,
                     params0: Optional[Mapping] = None,
                     engine_kwargs: Optional[Mapping] = None,
                     **fit_kwargs) -> Dict:
    """Branch-site positive-selection LRT: Model A vs. Model A with omega2 =
    1 (the Zhang et al. 2005 recommended null), df = 1.

    codeml's convention: the null distribution is conservatively taken as
    chi2(1) here; the exact asymptotic null is a 50:50 mixture of chi2(0)
    and chi2(1), so halving the returned p-value is also defensible.
    ``engine_kwargs`` go to both engines (``dtype``, ``pruner``,
    ``device``), ``fit_kwargs`` to both fits. Returns the alt/null engines,
    fits and the LRT dict.
    """
    from phylo_utils_tpu_torch.model_selection import likelihood_ratio_test
    from phylo_utils_tpu_torch.optimize import fit

    engine_kwargs = dict(engine_kwargs or {})
    alt = BranchSiteAEngine(tree, alignment, foreground, model=model,
                            **engine_kwargs)
    null = BranchSiteAEngine(tree, alignment, foreground, model=model,
                             **engine_kwargs)
    alt_fit = fit(alt, params0=params0, **fit_kwargs)
    null0 = dict(params0 or {})
    null0["omega2_delta"] = 0.0
    free = tuple(k for k in null.default_params() if k != "omega2_delta")
    null_fit = fit(null, params0=null0, free=free, **fit_kwargs)
    lrt = likelihood_ratio_test(null_fit.loglik, alt_fit.loglik, df=1)
    return {
        "alt": alt_fit, "null": null_fit, "lrt": lrt,
        "alt_engine": alt, "null_engine": null,
    }


def _branch_site_pair_p(engine: "BranchSiteAEngine", full, block):
    """(P (n_nodes, k, S, S), root frequencies (S,)) in the engine's
    reduce dtype for k (omega_background, omega_foreground) pairs
    ``block`` (k, 2): category i's background edges at pair i's first
    omega, its foreground edges at its second; kappa, the codon
    frequencies and the branch lengths from ``full``."""
    rdt, device = engine._reduce_dtype, engine.device
    t = full["branch_lengths"].to(rdt)
    n_edges, k = t.shape[0], block.shape[0]
    # one model per pair-slot omega: background rows [0, k), foreground
    # rows [k, 2k); they share kappa and the frequencies
    stacked = _broadcast_shared(full["shared"], 2 * k, rdt)
    stacked["omega"] = torch.as_tensor(np.asarray(block).T.reshape(-1),
                                       dtype=rdt, device=device)
    sym_u, freqs_u = _class_builds(engine.model, stacked)
    sym_u, freqs_u = sym_u.to(rdt), freqs_u.to(rdt)
    p_u = p_matrices_reversible(sym_u, freqs_u,
                                t[None].expand(2 * k, n_edges))
    cat_idx = torch.arange(k, device=device)[:, None]
    midx = torch.where(engine._cls[None, :] == 0, cat_idx, cat_idx + k)
    p = p_u[midx, torch.arange(n_edges, device=device)[None, :]]
    return (extend_p_identity(p.transpose(0, 1), engine.schedule.n_nodes),
            freqs_u[0])


def _branch_site_pair_logliks(engine: "BranchSiteAEngine", full, pairs,
                              chunk: int = 32) -> np.ndarray:
    """Sitewise LOG-likelihoods for (omega_background, omega_foreground)
    pairs: (n_pairs, n_patterns) float64. Each chunk of pairs rides the
    pruning pass's category axis in ONE walk (``engine._prune``: under
    ``pruner="cuda"`` the value walk at K = ``chunk``); the last chunk is
    padded to ``chunk`` pairs (the surplus rows are discarded). Kappa, the
    codon frequencies and the branch lengths stay at ``full``'s values (the
    MLEs, codeml's BEB convention)."""
    rdt = engine._reduce_dtype
    pairs = np.asarray(pairs, np.float64)
    out = []
    with torch.no_grad():
        for lo in range(0, pairs.shape[0], chunk):
            block = pairs[lo:lo + chunk]
            n_real = block.shape[0]
            if n_real < chunk and lo > 0:
                block = np.concatenate(
                    [block, np.repeat(block[-1:], chunk - n_real, axis=0)])
            p, freqs = _branch_site_pair_p(engine, full, block)
            root, logscale = engine._prune(p.to(engine.dtype),
                                           engine._leaf_partials)
            lik = torch.einsum("ksi,i->ks", root.to(rdt), freqs)
            res = torch.log(lik) + logscale.to(rdt)
            out.append(res[:n_real].to("cpu", torch.float64).numpy())
    return np.concatenate(out, axis=0)


def beb_branch_site(engine: "BranchSiteAEngine",
                    params: Optional[Mapping] = None, d: int = 10):
    """Bayes Empirical Bayes site scan for branch-site Model A.

    Yang, Wong & Nielsen (2005) applied to Model A as codeml does for its
    site classes: integrate the per-site class posteriors over a uniform
    prior grid on (p0, p1, omega0, omega2): omega0 at ``d`` midpoints of
    (0,1), omega2 at ``d`` midpoints of (1,11), and (p0, p1) at the d x d
    square midpoints folded onto the 2-simplex, each grid point weighted by
    its posterior given the data. Branch lengths, kappa and codon
    frequencies stay at their MLEs. The (d + 1)(d + 1) class likelihoods
    come from ``_branch_site_pair_logliks``; the grid sums run in numpy in
    the JAX package's order.

    Returns ``(p_positive, mean_omega_fg)`` per site: the BEB posterior
    probability that the site is under positive selection ON THE FOREGROUND
    branches (classes 2a + 2b), and the BEB posterior mean foreground omega.
    """
    if not isinstance(engine, BranchSiteAEngine):
        raise TypeError("beb_branch_site is implemented for "
                        "BranchSiteAEngine")
    full = engine._full_params(params)
    w0 = (np.arange(d) + 0.5) / d                     # omega0 grid
    w2 = 1.0 + (np.arange(d) + 0.5) * (10.0 / d)      # omega2 grid

    # class sitewise log-liks over the grid:
    #   class 0  at (w0_i, w0_i)      -> d pairs
    #   class 1  at (1, 1)            -> 1 pair
    #   class 2a at (w0_i, w2_j)      -> d*d pairs
    #   class 2b at (1, w2_j)         -> d pairs
    pairs = (
        [(a, a) for a in w0]
        + [(1.0, 1.0)]
        + [(a, b) for a in w0 for b in w2]
        + [(1.0, b) for b in w2]
    )
    logf = _branch_site_pair_logliks(engine, full, pairs)
    n_pat = engine._compressed.n_patterns
    logf = logf[:, :n_pat]
    weights = gather_sites(engine._weights).to(
        "cpu", torch.float64).numpy()[:n_pat]
    m = logf.max(axis=0)
    f = np.exp(logf - m[None, :])
    f0 = f[:d]                                        # (d, P)
    f1 = f[d]                                         # (P,)
    f2a = f[d + 1: d + 1 + d * d].reshape(d, d, -1)   # (d, d, P)
    f2b = f[d + 1 + d * d:]                           # (d, P)

    # folded 2-simplex midpoints for (p0, p1)
    g0, g1 = np.meshgrid((np.arange(d) + 0.5) / d,
                         (np.arange(d) + 0.5) / d, indexing="ij")
    p0g, p1g = g0.ravel().copy(), g1.ravel().copy()
    over = p0g + p1g > 1.0
    p0g[over], p1g[over] = 1.0 - p0g[over], 1.0 - p1g[over]
    p2g = 1.0 - p0g - p1g
    denom = np.maximum(p0g + p1g, 1e-30)
    w2a = p2g * p0g / denom
    w2b = p2g * p1g / denom

    log_post = np.empty((d, d, p0g.shape[0]))
    for i in range(d):
        for j in range(d):
            lik = (p0g[:, None] * f0[i][None, :]
                   + p1g[:, None] * f1[None, :]
                   + w2a[:, None] * f2a[i, j][None, :]
                   + w2b[:, None] * f2b[j][None, :])
            log_post[i, j] = (weights[None, :] * np.log(lik)).sum(axis=1)
    lp = log_post - log_post.max()
    post_g = np.exp(lp)
    post_g /= post_g.sum()

    acc_pos = np.zeros(n_pat)
    acc_w = np.zeros(n_pat)
    for i in range(d):
        for j in range(d):
            pg = post_g[i, j]
            if pg.max() < 1e-12:
                continue
            c0 = p0g[:, None] * f0[i][None, :]
            c1 = p1g[:, None] * f1[None, :]
            ca = w2a[:, None] * f2a[i, j][None, :]
            cb = w2b[:, None] * f2b[j][None, :]
            tot = c0 + c1 + ca + cb
            acc_pos += pg @ ((ca + cb) / tot)
            # foreground omega by class: w0_i, 1, w2_j, w2_j
            acc_w += pg @ (
                (w0[i] * c0 + c1 + w2[j] * (ca + cb)) / tot
            )
    s2p = engine._compressed.site_to_pattern
    return acc_pos[s2p], acc_w[s2p]
