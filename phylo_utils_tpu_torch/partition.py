"""Partitioned (multi-locus) analyses: one tree, per-partition models
(PyTorch port of ``phylo_utils_tpu.partition``).

Multi-gene datasets score each locus under its own substitution model and
rate mixture while sharing the tree topology and branch lengths; a
per-partition rate multiplier ("proportional branch lengths") absorbs rate
differences between loci:

  logL(theta) = sum_p logL_p(branch_lengths * r_p; model_p, mixture_p)

The partition terms are independent given the shared branch lengths, so the
joint gradient is one autograd pass and ``optimize.fit``,
``standard_errors`` and ``fisher_covariance`` drive both engines unchanged
(they read ``_full_params``, ``model_eigen`` / ``model_rates`` (None here),
``_loglik_fn``, ``_leaf_partials``, ``_weights``, ``device`` and
``dtype``). Rate multipliers are normalized to site-weighted mean 1,
keeping shared branch lengths in expected substitutions/site.

``PartitionedEngine`` holds one ``LikelihoodEngine`` per locus: any mix of
models, alphabets and mixtures, one walk per locus.
``StackedPartitionedEngine`` takes loci of one model family and mixture:
their patterns pad to one count
and stack, (G, n_leaves, P, S), their eigensystems (one batched ``eigh``),
gamma rates and P come from batched calls, and ONE walk scores the G loci:
``pruner="cuda"`` launches each kernel once over (G, ...) P, leaves and root
frequencies (the per-batch operands of ``ops.cuda_pruning``), as the JAX
engine ``vmap``s one engine over the stack.

Both engines run on the card (``device="cuda"``) unless ``device="cpu"`` is
given. ``sharding`` (``parallel.SiteSharding``): ``PartitionedEngine``'s
loci each shard their own pattern axis; the stack pads its common pattern
count to the sharding's multiple and shards (G, n_leaves, P, S) along P,
so one walk per shard scores every locus's slice.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from phylo_utils_tpu_torch import io as pio
from phylo_utils_tpu_torch import trees as ptrees
from phylo_utils_tpu_torch.likelihood import (
    LikelihoodEngine,
    _check_nans,
    _value_key,
    root_split,
)
from phylo_utils_tpu_torch.models.base import Eigen, Model, eigen_reversible
from phylo_utils_tpu_torch.ops.gamma import discrete_gamma
from phylo_utils_tpu_torch.ops.pmatrix import (
    extend_p_identity,
    p_matrices_reversible,
    transition_matrices,
)
from phylo_utils_tpu_torch.ops.pruning import (
    invariant_site_likelihood,
    mixture_loglik,
    mixture_loglik_from_ll,
)
from phylo_utils_tpu_torch.parallel.sharding import (
    gather_sites,
    map_sites,
    place,
)
from phylo_utils_tpu_torch.simulate import Seed, simulate_alignment

__all__ = ["Partition", "PartitionedEngine", "StackedPartitionedEngine",
           "partitions_from_file", "codon_position_partitions",
           "simulate_partitions"]


class Partition:
    """One locus: (name, alignment, model, mixture options)."""

    def __init__(self, name: str, alignment, model: Model, ncat: int = 1,
                 invariant_sites: bool = False, rate_model: str = "gamma"):
        self.name = name
        self.alignment = alignment
        self.model = model
        self.ncat = ncat
        self.invariant_sites = invariant_sites
        self.rate_model = rate_model


def _locus(params, name: str) -> Dict:
    """Partition ``name``'s parameter dict, with an empty ``model`` where a
    parameter-free model (JC69) has none: its empty dicts carry no leaf
    through the optimizer's flat list, and drop out there."""
    return {"model": {}, **params.get("partitions", {}).get(name, {})}


def _copy_dicts(tree: Mapping) -> Dict:
    """``tree`` with every dict copied and every tensor shared."""
    return {k: _copy_dicts(v) if isinstance(v, Mapping) else v
            for k, v in tree.items()}


def _checked_partitions(tree, partitions):
    """(tree, partitions list) after the checks both engines share."""
    if isinstance(tree, str):
        tree = pio.parse_newick(tree)
    if not partitions:
        raise ValueError("no partitions given")
    names = [p.name for p in partitions]
    if len(set(names)) != len(names):
        raise ValueError("partition names must be unique")
    return tree, list(partitions)


class PartitionedEngine:
    """Joint likelihood over partitions sharing one tree: one port
    ``LikelihoodEngine`` per locus (``pruner`` "torch" or "cuda", ``dtype``,
    ``device`` and ``sharding`` as there: each locus shards its own
    patterns)."""

    def __init__(
        self,
        tree: Union[ptrees.Tree, str],
        partitions: Sequence[Partition],
        dtype=None,
        pruner: str = "torch",
        link_rates: bool = True,
        sharding=None,
        device="cuda",
    ):
        tree, partitions = _checked_partitions(tree, partitions)
        self.tree = tree
        self.partitions = partitions
        self.link_rates = bool(link_rates)
        self.sharding = sharding
        self.pruner = pruner
        self._engines = [
            LikelihoodEngine(
                tree, p.alignment, p.model, ncat=p.ncat,
                invariant_sites=p.invariant_sites, dtype=dtype,
                pruner=pruner, rate_model=p.rate_model, device=device,
                sharding=sharding,
            )
            for p in partitions
        ]
        self.dtype = self._engines[0].dtype
        self.device = self._engines[0].device
        # surface consumed by optimize.fit
        self._leaf_partials = tuple(e._leaf_partials for e in self._engines)
        self._weights = tuple(e._weights for e in self._engines)
        self._set_site_counts([float(w.sum()) for w in self._weights])
        self._n_sites = [e._compressed.n_sites for e in self._engines]

    def _set_site_counts(self, counts: List[float]) -> None:
        # float64: the rates' normalization is part of the reduction
        self._site_counts = torch.tensor(counts, dtype=torch.float64,
                                         device=self.device)

    # -- parameters ----------------------------------------------------------

    def _tensor(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    def _locus_defaults(self, i: int) -> Dict:
        return {k: v for k, v in self._engines[i].default_params().items()
                if k != "branch_lengths"}

    def default_params(self) -> Dict:
        """The default parameters: new dicts, over tensors made on the
        device once (nothing writes a parameter tensor in place), so a call
        with G loci copies nothing to the card."""
        if getattr(self, "_defaults", None) is None:
            params: Dict = {
                "branch_lengths": self._tensor(self.tree.lengths),
                "partitions": {p.name: self._locus_defaults(i)
                               for i, p in enumerate(self.partitions)},
            }
            if self.link_rates and len(self.partitions) > 1:
                params["partition_rates"] = torch.ones(
                    (len(self.partitions),), dtype=self.dtype,
                    device=self.device)
            self._defaults = params
        return _copy_dicts(self._defaults)

    def _full_params(self, params: Optional[Mapping]) -> Dict:
        full = self.default_params()
        for k, v in (params or {}).items():
            if k not in full:
                raise ValueError(
                    f"unknown parameter {k!r} for this engine; available: "
                    f"{sorted(full.keys())}")
            if k != "partitions":
                full[k] = self._tensor(v)
                continue
            for pname, pv in v.items():
                if pname not in full["partitions"]:
                    raise ValueError(
                        f"unknown partition {pname!r}; available: "
                        f"{sorted(full['partitions'])}")
                cur = dict(full["partitions"][pname])
                for kk, vv in pv.items():
                    if kk not in cur:
                        raise ValueError(
                            f"unknown parameter {kk!r} of partition "
                            f"{pname!r}; available: {sorted(cur)}")
                    if kk == "model":
                        unknown = set(vv) - set(cur["model"])
                        if unknown:
                            raise ValueError(
                                f"unknown model parameter(s) "
                                f"{sorted(unknown)} of partition {pname!r}")
                        cur["model"] = {**cur["model"], **{
                            m: self._tensor(x) for m, x in vv.items()}}
                    else:
                        cur[kk] = self._tensor(vv)
                full["partitions"][pname] = cur
        return full

    def _flat_directions(self, names, leaves):
        """The likelihood's flat directions (see
        ``LikelihoodEngine._flat_directions``): the split of a two-child
        root's edges when every locus's model is reversible, and the
        partition rates' common scale (their site-weighted mean is 1, so
        the rates r and c r score the same)."""
        out = (root_split(self.tree, names)
               if all(p.model.reversible for p in self.partitions) else [])
        if ("partition_rates",) in names:
            r = leaves[names.index(("partition_rates",))]
            out.append({("partition_rates",): r.to("cpu").numpy()})
        return out

    def model_eigen(self, full_params):
        """None: each locus has its own model (``optimize.fit`` then builds
        P from the parameters)."""
        return None

    def model_rates(self, full_params):
        """None: each locus has its own rate mixture."""
        return None

    # -- computation ---------------------------------------------------------

    def _partition_rates(self, params) -> torch.Tensor:
        """(G,) float64 rate multipliers, site-weighted mean 1."""
        sc = self._site_counts
        if "partition_rates" not in params:
            return torch.ones_like(sc)
        r = params["partition_rates"].to(torch.float64)
        # site-weighted mean 1: sum_p n_p r_p / sum_p n_p == 1
        return r * sc.sum() / (sc * r).sum()

    def _locus_params(self, params) -> List[Dict]:
        """Each locus's parameter dict, the shared lengths times its rate
        (in float64, as the engines build P)."""
        t = params["branch_lengths"].to(torch.float64)
        r = self._partition_rates(params)
        subs = []
        for i, p in enumerate(self.partitions):
            sub = _locus(params, p.name)
            sub["branch_lengths"] = t * r[i]
            subs.append(sub)
        return subs

    def _loglik_fn(self, params, leaf_partials, weights, eig=None,
                   rates=None, cached=False):
        """(total logL, per-locus sitewise tuple), float64. ``cached``:
        each locus's P from its engine's cached eigensystem and gamma rates
        (the value path)."""
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        sitewise = []
        for e, sub, lp, w in zip(self._engines, self._locus_params(params),
                                 leaf_partials, weights):
            kw = ({"eig": e.model_eigen(sub), "rates": e.model_rates(sub)}
                  if cached else {})
            ll, sw = e._loglik_fn(sub, lp, w, **kw)
            total = total + ll
            sitewise.append(sw)
        return total, tuple(sitewise)

    def _eval(self, full):
        with torch.no_grad():
            total, sws = self._loglik_fn(full, self._leaf_partials,
                                         self._weights, cached=True)
        _check_nans("log-likelihood", total, *sws)
        return total, sws

    # -- public API ----------------------------------------------------------

    def loglikelihood(self, params: Optional[Mapping] = None) -> float:
        return float(self._eval(self._full_params(params))[0])

    def partition_loglikelihoods(
        self, params: Optional[Mapping] = None
    ) -> Dict[str, float]:
        _, sws = self._eval(self._full_params(params))
        return {p.name: float((gather_sites(w, self.device).to(torch.float64)
                               * sw).sum())
                for p, w, sw in zip(self.partitions, self._weights, sws)}

    # (total, gradient dict of the full parameters), the base engine's
    _value_and_grad = LikelihoodEngine._value_and_grad

    def value_and_grad(self, params: Optional[Mapping] = None):
        """(total logL as a 0-d float64 tensor, gradient dict with the
        structure of the full parameters)."""
        return self._value_and_grad(self._full_params(params))

    def gradient(self, params: Optional[Mapping] = None) -> Dict:
        return self.value_and_grad(params)[1]


class StackedPartitionedEngine(PartitionedEngine):
    """Partitioned likelihood with the loci STACKED on one batch axis.

    When every locus shares the model FAMILY and mixture config (the common
    many-locus case: per-locus GTR+G4), the per-locus term is one function
    at different parameters: leaf partials pad to a common pattern count
    (all-ones partials, zero weights: logL-exact) and stack to (G,
    n_leaves, P, S), per-locus model parameters stack leaf-wise, and one
    template engine's walk scores the stack in one call: G loci are one
    launch of each kernel under ``pruner="cuda"``. Same parameter tree,
    optimizer surface and public API as ``PartitionedEngine``;
    heterogeneous mixes (DNA + protein, differing ncat) need the general
    engine.
    """

    def __init__(
        self,
        tree: Union[ptrees.Tree, str],
        partitions: Sequence[Partition],
        dtype=None,
        pruner: str = "torch",
        link_rates: bool = True,
        sharding=None,
        device="cuda",
    ):
        tree, partitions = _checked_partitions(tree, partitions)
        first = partitions[0]
        for p in partitions[1:]:
            if (
                p.model is not first.model
                or p.ncat != first.ncat
                or p.invariant_sites != first.invariant_sites
                or p.rate_model != first.rate_model
            ):
                raise ValueError(
                    "StackedPartitionedEngine requires every partition to "
                    "share the model family and mixture config "
                    f"(partition {p.name!r} differs from {first.name!r}); "
                    "use PartitionedEngine for heterogeneous loci"
                )
        self.tree = tree
        self.partitions = partitions
        self.link_rates = bool(link_rates)
        self.sharding = sharding
        self.pruner = pruner

        # ONE template engine supplies the schedule, the walk and the
        # mixture config
        self._template = LikelihoodEngine(
            tree, first.alignment, first.model, ncat=first.ncat,
            invariant_sites=first.invariant_sites, dtype=dtype,
            pruner=pruner, rate_model=first.rate_model, device=device,
            sharding=sharding,
        )
        self.dtype = self._template.dtype
        self.device = self._template.device
        self._engines = [self._template] * len(partitions)

        # per-locus compression, padded to a common pattern count
        comps = [
            p.alignment if isinstance(p.alignment, pio.CompressedAlignment)
            else pio.compress_patterns(p.alignment, first.model.alphabet)
            for p in partitions
        ]
        for p, ca in zip(partitions, comps):
            missing = set(tree.leaf_names) - set(ca.names)
            if missing:
                raise ValueError(
                    f"partition {p.name!r} missing taxa {sorted(missing)}"
                )
        pmax = max(ca.partials.shape[1] for ca in comps)
        if sharding is not None:
            pmax = sharding.padded_size(pmax)
        np_dtype = np.float32 if self.dtype == torch.float32 else np.float64
        lps, ws = [], []
        for ca in comps:
            order = [ca.names.index(n) for n in tree.leaf_names]
            lp = np.asarray(ca.partials, np_dtype)[np.asarray(order)]
            w = np.asarray(ca.weights, np.float64)
            pad = pmax - lp.shape[1]
            if pad:
                lp = np.concatenate(
                    [lp, np.ones((lp.shape[0], pad, lp.shape[2]), np_dtype)],
                    axis=1)
                w = np.concatenate([w, np.zeros(pad)])
            lps.append(lp)
            ws.append(w)
        self._compressed = comps
        self._n_sites = [ca.n_sites for ca in comps]
        self._n_patterns = [ca.partials.shape[1] for ca in comps]
        # (G, n_leaves, P, S) and (G, P); sharded along P, one contiguous
        # (G, n_leaves, P / n, S) block a shard
        self._leaf_partials, self._weights = place(
            sharding, np.stack(lps), np.stack(ws), self.device,
            weight_dtype=self.dtype)
        self._set_site_counts([float(w.sum()) for w in ws])
        self._model_keys = list(first.model.param_defaults)
        self._eig_key = self._eig = None
        self._rates_key = self._rates = None

    def _locus_defaults(self, i: int) -> Dict:
        # one set of the template's tensors, shared by the loci
        if getattr(self, "_template_defaults", None) is None:
            self._template_defaults = {
                k: v for k, v in self._template.default_params().items()
                if k != "branch_lengths"}
        return _copy_dicts(self._template_defaults)

    @property
    def padded_fraction(self) -> float:
        """Share of the stacked pattern columns that are padding."""
        g, p = self._weights.shape
        return 1.0 - sum(self._n_patterns) / (g * p)

    # -- the loci's model, rates and P as stacks ------------------------------

    def _stack(self, params, key: str) -> torch.Tensor:
        """(G, ...) float64: the loci's ``key`` entries in partition
        order."""
        return torch.stack([_locus(params, p.name)[key].to(torch.float64)
                            for p in self.partitions])

    def _model_stack(self, params) -> Dict[str, torch.Tensor]:
        """{model parameter: (G, ...)} float64, in partition order."""
        model = self.partitions[0].model
        out = {}
        for k in self._model_keys:
            rows = []
            for p in self.partitions:
                v = _locus(params, p.name)["model"].get(
                    k, model.param_defaults[k])
                rows.append(torch.as_tensor(v, dtype=torch.float64,
                                            device=self.device))
            out[k] = torch.stack(rows)
        return out

    def _build_parts(self, stack) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sym (G, S, S), freqs (G, S)) or, non-reversible, (Q, freqs):
        the model's builder mapped over the loci by ``torch.func.vmap``,
        one batched call (differentiable)."""
        model = self.partitions[0].model
        g = len(self.partitions)
        if not stack:        # a parameter-free model: one build for all
            a, b = model.build_parts(None, torch.float64, self.device)
            return (a.expand((g,) + a.shape), b.expand((g,) + b.shape))
        keys = list(stack)
        a, b = torch.func.vmap(
            lambda *vals: model.build(**dict(zip(keys, vals))))(
            *stack.values())
        return a.to(torch.float64), b.to(torch.float64)

    def _stacked_eigen(self, params) -> Eigen:
        """The loci's eigensystems (G, ...) on the device, from one batched
        ``eigh`` on the host, cached by parameter VALUE (the value path)."""
        stack = self._model_stack(params)
        key = tuple((k, _value_key(v)) for k, v in stack.items())
        if key != self._eig_key:
            a, b = self._build_parts(stack)
            if self.partitions[0].model.reversible:
                self._eig = eigen_reversible(a, b)
            else:
                self._eig = Eigen(evals=None, evecs=None, ivecs=None,
                                  freqs=b, q=a)
            self._eig_key = key
        return self._eig

    def _stacked_gamma(self, alpha: torch.Tensor) -> torch.Tensor:
        """(G, K) gamma rates of the loci's alphas, one batched call on the
        host in float64 (differentiable in alpha)."""
        return discrete_gamma(alpha.to("cpu", torch.float64),
                              self._template.ncat).to(self.device)

    def _stacked_rates(self, params) -> Optional[torch.Tensor]:
        """The value path's (G, K) gamma rates, cached by VALUE; None where
        the rates are not a function of alpha alone."""
        t = self._template
        if t.ncat <= 1 or t.rate_model != "gamma":
            return None
        alpha = self._stack(params, "alpha")
        key = _value_key(alpha)
        if key != self._rates_key:
            self._rates = self._stacked_gamma(alpha)
            self._rates_key = key
        return self._rates

    def _rate_categories(self, params, rates=None):
        """(rates (G, K), category weights (K,) or (G, K)) of the loci's
        rate mixtures, float64."""
        t, f64, g = self._template, torch.float64, len(self.partitions)
        k = t.ncat
        if k > 1 and t.rate_model == "free":
            cw = self._stack(params, "cat_weights")
            cw = cw / cw.sum(dim=-1, keepdim=True)
            r = self._stack(params, "rates")
            return r / (cw * r).sum(dim=-1, keepdim=True), cw
        cw = torch.full((k,), 1.0 / k, dtype=f64, device=self.device)
        if k > 1:
            if rates is None:
                rates = self._stacked_gamma(self._stack(params, "alpha"))
            return rates, cw
        return torch.ones((g, 1), dtype=f64, device=self.device), cw

    def _loglik_fn(self, params, leaf_partials, weights, eig=None,
                   rates=None, cached=False):
        """(total logL, sitewise (G, P)), float64, from one walk over the
        stacked loci. ``cached``: P from the cached eigensystems and gamma
        rates (the value path)."""
        t, f64 = self._template, torch.float64
        if cached:
            eig, rates = self._stacked_eigen(params), self._stacked_rates(
                params)
        r = self._partition_rates(params)
        bl = params["branch_lengths"].to(f64)[None, :] * r[:, None]
        rates, cat_weights = self._rate_categories(params, rates)
        ts = bl[:, :, None] * rates[:, None, :]          # (G, n_real, K)
        if eig is not None:
            freqs = eig.freqs.to(f64)
            p = transition_matrices(eig, ts)
        else:
            a, freqs = self._build_parts(self._model_stack(params))
            if self.partitions[0].model.reversible:
                p = p_matrices_reversible(a, freqs, ts)
            else:
                p = transition_matrices(Eigen(evals=None, evecs=None,
                                              ivecs=None, freqs=freqs, q=a),
                                        ts)
        p = extend_p_identity(p, t.schedule.n_nodes).to(self.dtype)
        pinv = (self._stack(params, "pinv")[:, None] if t.invariant_sites
                else None)
        totals, sw = map_sites(self._stack_loglik,
                               (p, freqs, cat_weights, pinv),
                               leaf_partials, weights, self.device)
        return totals.sum(), sw

    def _stack_loglik(self, p, freqs, cat_weights, pinv, leaf_partials,
                      weights):
        """(totals (G,), sitewise (G, P)) of one block of the stacked
        patterns (all of them, or one shard), from ONE walk."""
        t, f64 = self._template, torch.float64
        inv = (invariant_site_likelihood(leaf_partials.to(f64), freqs)
               if pinv is not None else None)
        if t._fused_ll is not None:
            ll = t._fused_ll(p, leaf_partials, freqs)     # (G, K, P)
            return mixture_loglik_from_ll(
                ll, cat_weights, weights.to(f64), pinv=pinv, inv_lik=inv)
        root, logscale = t._prune(p, leaf_partials)
        return mixture_loglik(
            root.to(f64), logscale.to(f64), freqs, cat_weights,
            weights.to(f64), pinv=pinv, inv_lik=inv)

    def partition_loglikelihoods(
        self, params: Optional[Mapping] = None
    ) -> Dict[str, float]:
        _, sws = self._eval(self._full_params(params))
        per = (gather_sites(self._weights, self.device).to(torch.float64)
               * sws).sum(dim=-1).cpu()
        return {p.name: float(per[i]) for i, p in enumerate(self.partitions)}


def codon_position_partitions(
    name_prefix: str,
    alignment,
    model: Model,
    split: str = "12_3",
    **kwargs,
):
    """Partition an in-frame coding DNA alignment by codon position.

    The classic '1+2 vs 3' (``split="12_3"``) or fully separate
    (``split="1_2_3"``) partitioning for ``PartitionedEngine``: third
    positions evolve much faster, and proportional branch lengths across
    the partitions capture that with one extra parameter per partition.
    """
    lens = {len(s) for s in alignment.values()}
    if len(lens) != 1 or next(iter(lens)) % 3:
        raise ValueError("alignment must be equal-length, in-frame codons")
    groups = {"12_3": [(0, 1), (2,)], "1_2_3": [(0,), (1,), (2,)]}[split]
    parts = []
    for g in groups:
        sub = {
            n: "".join(s[i] for i in range(len(s)) if i % 3 in g)
            for n, s in alignment.items()
        }
        label = name_prefix + "_pos" + "".join(str(p + 1) for p in g)
        parts.append(Partition(label, sub, model, **kwargs))
    return parts


def _expand_ranges(ranges, n_sites: int) -> list:
    """1-based inclusive (start, end, stride) triples -> sorted 0-based
    column indices, validated against the alignment width."""
    cols = []
    for start, end, stride in ranges:
        if end > n_sites:
            raise ValueError(
                f"site range {start}-{end} exceeds alignment length "
                f"{n_sites}"
            )
        cols.extend(range(start - 1, end, stride))
    return sorted(set(cols))


_DATATYPE_MODELS = {
    # RAxML-style data-type keywords -> the default model for that type
    "DNA": "GTR",
    "AA": "LG",
    "PROT": "LG",
    "PROTEIN": "LG",
}


def partitions_from_file(
    path_or_text: str,
    alignment: Mapping[str, str],
    default_model: str = "GTR",
    get_model=None,
) -> Tuple[list, Dict]:
    """Build :class:`Partition` objects from a RAxML/IQ-TREE-style
    partition file (or NEXUS charsets) over one concatenated alignment.

    Per-partition model strings use the shared +G[n]/+R[n]/+I/+F
    convention; RAxML data-type keywords (DNA, AA/PROT) map to GTR/LG.
    Entries without a model (NEXUS charsets) use ``default_model``.

    Returns ``(partitions, init_params)``: ``init_params`` carries the
    per-partition observed equilibrium frequencies for '+F' entries
    (frequencies are engine *parameters* here, not Partition state), in
    the shape ``PartitionedEngine._full_params`` consumes.
    """
    from phylo_utils_tpu_torch.alphabets import empirical_frequencies
    from phylo_utils_tpu_torch.models import parse_model_spec

    specs = pio.parse_partition_file(path_or_text)
    lens = {len(s) for s in alignment.values()}
    if len(lens) != 1:
        raise ValueError("sequences have unequal lengths")
    (n_sites,) = lens
    parts = []
    init: Dict = {}
    for spec in specs:
        mstr = spec["model"] or default_model
        head, _, rest = mstr.partition("+")
        mapped = _DATATYPE_MODELS.get(head.upper())
        if mapped:
            mstr = mapped + (("+" + rest) if rest else "")
        model, ncat, inv, emp, rate_model = parse_model_spec(
            mstr, get_model=get_model
        )
        cols = _expand_ranges(spec["ranges"], n_sites)
        sub = {
            name: "".join(s[i] for i in cols)
            for name, s in alignment.items()
        }
        parts.append(Partition(
            spec["name"], sub, model, ncat=ncat, invariant_sites=inv,
            rate_model=rate_model,
        ))
        if emp:
            if "freqs" not in model.param_defaults:
                raise ValueError(
                    f"partition {spec['name']!r}: model {model.name!r} "
                    "has no 'freqs' parameter for '+F'"
                )
            init.setdefault("partitions", {})[spec["name"]] = {
                "model": {"freqs": empirical_frequencies(
                    sub, model.alphabet, pseudocount=0.5
                ).tolist()},
            }
    return parts, init


def simulate_partitions(seed: Seed, engine: PartitionedEngine,
                        params: Optional[Mapping] = None) -> Dict:
    """Simulate one alignment per partition at the engine's parameters.

    Each partition simulates under its own model/mixture with the SHARED
    branch lengths scaled by its (normalized) partition rate: the
    generative counterpart of the engines' ``_loglik_fn``. Site counts
    follow each partition's observed alignment. ``seed``: an int (locus i
    draws from ``seed + i``, as ``parametric_bootstrap`` seeds its
    replicates) or a ``torch.Generator`` the loci draw from in turn, on the
    engine's device (``simulate.simulate_alignment``; no stream parity with
    ``jax.random``). Returns ``{partition_name: {taxon: sequence}}``;
    concatenate in partition order for a multi-locus matrix.
    """
    full = engine._full_params(params)
    t = full["branch_lengths"].detach().to("cpu", torch.float64).numpy()
    r = engine._partition_rates(full).detach().cpu().numpy()
    out: Dict = {}
    for i, p in enumerate(engine.partitions):
        if p.rate_model == "free":
            raise ValueError(
                f"partition {p.name!r}: FreeRate simulation is not "
                "supported (no generative alpha); use a gamma partition"
            )
        sub = full["partitions"][p.name]
        sim_params = {k: v.detach() for k, v in sub.get("model", {}).items()}
        if p.ncat > 1 and "alpha" in sub:
            sim_params["alpha"] = sub["alpha"].detach()
        pinv = float(sub["pinv"]) if p.invariant_sites else 0.0
        out[p.name] = simulate_alignment(
            seed if isinstance(seed, torch.Generator) else int(seed) + i,
            engine.tree.with_lengths(t * r[i]),
            p.model,
            engine._n_sites[i],
            params=sim_params,
            ncat=p.ncat,
            pinv=pinv,
            device=engine.device,
        )
    return out
