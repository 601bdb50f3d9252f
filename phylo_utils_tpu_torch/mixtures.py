"""Model mixtures: categories that differ in model parameters, not just in
rate (PyTorch port of the ``ModelMixtureEngine`` part of
``phylo_utils_tpu.mixtures``).

Each of K categories has its own substitution-model parameters (e.g. HKY85
with two kappa classes) or its own model (``class_models``, the LG4M/LG4X
family); the class weights are a free simplex parameter. The pruning pass
already carries a category axis: one Q, and one P batch, per category, then
a root reduction with per-category frequencies. The engine prunes through
``self._prune``: the plain pruner under ``pruner="torch"``, and under
``pruner="cuda"`` ``ops.cuda_pruning.make_cuda_prune_fn`` (the kernels
forward, whichever walk and lowering ``forward_walk`` picks; the plain
pruner replayed backward).

Precision: P(t) and the root reduction run in float64 and the walk in the
engine's dtype, the port's precision plan for every engine (the JAX
package's mixture runs its reduction in the engine dtype).
``loglikelihood``, ``sitewise_loglikelihoods``, ``value_and_grad``,
``bootstrap_loglikelihoods`` and ``category_posteriors`` work as the JAX
engine's do;
``loglikelihood_many`` raises, as JAX's does on a mixture engine, and so does
``value_and_grad_many``. The codon site models (``SharedOmegaMixtureEngine``,
M1a-M8a), BEB and ``omega_posteriors`` wait for ``ops/beta.py`` (ROADMAP
A15; the codon models they build on are ported).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from phylo_utils_tpu_torch.likelihood import (
    LikelihoodEngine,
    validate_param_keys,
)
from phylo_utils_tpu_torch.ops.pmatrix import (
    extend_p_identity,
    p_matrices_reversible,
)
from phylo_utils_tpu_torch.ops.pruning import invariant_site_likelihood

__all__ = ["ModelMixtureEngine"]


def _stack_params(param_dicts: Sequence[Mapping], dtype, device) -> Dict:
    """List of per-category param dicts -> one dict of stacked tensors."""
    keys = set(param_dicts[0].keys())
    for d in param_dicts[1:]:
        if set(d.keys()) != keys:
            raise ValueError("mixture categories must share parameter names")
    return {
        k: torch.stack([torch.as_tensor(d[k], dtype=dtype, device=device)
                        for d in param_dicts])
        for k in keys
    }


class ModelMixtureEngine(LikelihoodEngine):
    """LikelihoodEngine whose categories have independent model parameters.

    ``mixture``: list of K parameter dicts for ``model`` (same keys each);
    weights start uniform and are a free simplex parameter
    (``cat_weights``). ``class_models``: optional list of per-class Models
    (one per category) that replace ``model``'s rate matrix class by class,
    the LG4M/LG4X family; all must be reversible and share the state count
    and parameter names. Other keyword arguments go to ``LikelihoodEngine``
    (``dtype``, ``pruner``, ``device``, ``invariant_sites``, ``compress``).
    """

    def __init__(self, tree, alignment, model, mixture: Sequence[Mapping],
                 class_models: Optional[Sequence] = None, **kwargs):
        if not model.reversible:
            raise ValueError("model mixtures require a reversible model")
        if len(mixture) < 2:
            raise ValueError("need at least 2 mixture categories")
        if class_models is not None:
            if len(class_models) != len(mixture):
                raise ValueError(
                    f"class_models has {len(class_models)} entries for "
                    f"{len(mixture)} mixture classes"
                )
            for cm in class_models:
                if not cm.reversible:
                    raise ValueError(
                        f"class model {cm.name!r} is not reversible"
                    )
                if cm.n_states != model.n_states:
                    raise ValueError(
                        f"class model {cm.name!r} has {cm.n_states} "
                        f"states, expected {model.n_states}"
                    )
                if set(cm.param_defaults) != set(model.param_defaults):
                    raise ValueError(
                        f"class model {cm.name!r} parameter names "
                        f"{sorted(cm.param_defaults)} differ from the "
                        f"base model's {sorted(model.param_defaults)}"
                    )
        kwargs.pop("ncat", None)
        super().__init__(tree, alignment, model, ncat=len(mixture), **kwargs)
        self._class_models = list(class_models) if class_models else None
        self._mixture0 = [
            {**(class_models[i] if class_models else model).param_defaults,
             **dict(m)}
            for i, m in enumerate(mixture)
        ]

    def default_params(self) -> Dict:
        params = {
            "branch_lengths": self._tensor(self.tree.lengths),
            "mixture": _stack_params(self._mixture0, self.dtype,
                                     self.device),
            "cat_weights": torch.full((self.ncat,), 1.0 / self.ncat,
                                      dtype=self.dtype, device=self.device),
        }
        if self.invariant_sites:
            params["pinv"] = self._tensor(0.2)
        return params

    def _full_params(self, params: Optional[Mapping]) -> Dict:
        full = self.default_params()
        if params:
            validate_param_keys(params, full, type(self).__name__,
                                nested="mixture")
            for k, v in params.items():
                if k == "mixture":
                    full["mixture"] = {**full["mixture"], **{
                        kk: self._tensor(vv) for kk, vv in v.items()
                    }}
                else:
                    full[k] = self._tensor(v)
        return full

    def _category_model_params(self, params):
        """(stacked per-category model-param dict, normalised class
        weights); the hook through which subclasses derive the stacked
        parameters from hyperparameters."""
        cat_weights = params["cat_weights"]
        return params["mixture"], cat_weights / cat_weights.sum()

    def _class_syms_freqs(self, mixture, dtype):
        """Per-class (sym (K, S, S), freqs (K, S)) from the stacked mixture
        params, each class built by its own model (``class_models``) or the
        shared one: a host loop over K small builds (JAX vmaps the shared
        build)."""
        pairs = [
            (self._class_models[i] if self._class_models else self.model)
            .build_parts({k: v[i] for k, v in mixture.items()}, dtype=dtype,
                         device=self.device)
            for i in range(self.ncat)
        ]
        return (torch.stack([a for a, _ in pairs]),
                torch.stack([b for _, b in pairs]))

    def _class_p(self, sym_k, freqs_k, t_k):
        """(n_nodes, K, S, S) P from per-class (sym, freqs) and per-class
        branch lengths t_k (K, n_real_nodes), identity blocks appended."""
        p_k = torch.stack([p_matrices_reversible(sym_k[i], freqs_k[i], t_k[i])
                           for i in range(self.ncat)])
        return extend_p_identity(p_k.transpose(0, 1), self.schedule.n_nodes)

    def _mixture_tensors(self, params, dtype):
        """(class rates, cat_weights, P (n_nodes, K, S, S), per-class
        frequencies (K, S)) in ``dtype``: what ``_loglik_fn`` and
        ``category_posteriors`` share."""
        mixture, cat_weights = self._category_model_params(params)
        t = params["branch_lengths"].to(dtype)                # (n_nodes,)
        sym_k, freqs_k = self._class_syms_freqs(mixture, dtype)
        ones = torch.ones((self.ncat,), dtype=dtype, device=self.device)
        p = self._class_p(sym_k, freqs_k, t[None, :].expand(self.ncat, -1))
        return ones, cat_weights.to(dtype), p, freqs_k

    def _root_terms(self, params, leaf_partials):
        """(cat_weights, per-class site likelihoods (K, sites) without their
        scale, root logscales (K, sites), per-class frequencies), float64."""
        rdt = self._reduce_dtype
        _, cat_weights, p, freqs_k = self._mixture_tensors(params, rdt)
        root_partials, root_logscale = self._prune(p.to(self.dtype),
                                                   leaf_partials)
        site_lik = torch.einsum("ksi,ki->ks", root_partials.to(rdt), freqs_k)
        return cat_weights, site_lik, root_logscale.to(rdt), freqs_k

    def _loglik_fn(self, params, leaf_partials, weights, eig=None,
                   rates=None):
        """(total, sitewise): the mixture root reduction with per-class
        frequencies. ``eig`` and ``rates`` (the base engine's caches) do not
        apply to a mixture and are ignored."""
        rdt = self._reduce_dtype
        cat_weights, site_lik, root_logscale, freqs_k = self._root_terms(
            params, leaf_partials)
        m = root_logscale.amax(dim=0)
        mixed = (cat_weights[:, None] * site_lik
                 * torch.exp(root_logscale - m[None, :])).sum(dim=0)
        log_var = torch.log(mixed) + m
        if self.invariant_sites:
            pinv = params["pinv"].to(rdt)
            # the invariant component under the weight-averaged frequencies
            freqs_bar = torch.einsum("k,ki->i", cat_weights, freqs_k)
            inv = invariant_site_likelihood(leaf_partials.to(rdt), freqs_bar)
            log_inv = torch.where(
                inv > 0, torch.log(torch.where(inv > 0, inv,
                                               torch.ones_like(inv))),
                torch.full_like(inv, -np.inf))
            sitewise = torch.logaddexp(torch.log1p(-pinv) + log_var,
                                       torch.log(pinv) + log_inv)
        else:
            sitewise = log_var
        total = (weights.to(rdt) * sitewise).sum()
        return total, sitewise

    def loglikelihood_many(self, branch_length_sets, params=None):
        raise NotImplementedError(
            f"{type(self).__name__} has no batched branch-length evaluation "
            "(nor has the JAX package's mixture engine); call loglikelihood "
            "per set")

    def value_and_grad_many(self, branch_length_sets, params=None):
        raise NotImplementedError(
            f"{type(self).__name__} has no batched branch-length gradient; "
            "call value_and_grad per set")

    def category_posteriors(self, params: Optional[Mapping] = None
                            ) -> np.ndarray:
        """Per-site posterior class membership (n_sites, K), float64."""
        with torch.no_grad():
            cat_weights, site_lik, root_logscale, _ = self._root_terms(
                self._full_params(params), self._leaf_partials)
            m = root_logscale.amax(dim=0)
            gam = cat_weights[:, None] * site_lik * torch.exp(
                root_logscale - m[None, :])
            gam = (gam / gam.sum(dim=0, keepdim=True)).T
        gam = gam.to("cpu", torch.float64).numpy()[: self._compressed.n_patterns]
        return gam[self._compressed.site_to_pattern]
