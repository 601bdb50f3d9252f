"""Model mixtures: categories that differ in model parameters, not just in
rate (PyTorch port of ``phylo_utils_tpu.mixtures``).

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
``value_and_grad_many``.

The codeml site models are mixtures whose classes differ only in omega
(``SharedOmegaMixtureEngine``: M1a, M2a, M7, M8, M8a over GY94 by default),
the class omegas and weights derived from a few hyperparameters in float64
(M7/M8's beta classes through ``ops.beta.discrete_beta``), kappa and the
codon frequencies shared (``params["shared"]``). ``omega_posteriors`` is
the NEB site scan; ``beb_site_posteriors`` (M2a) and
``beb_site_posteriors_m8`` the Bayes Empirical Bayes scans (Yang, Wong &
Nielsen 2005), one pruning pass over an omega grid as the category axis
(21 classes for M2a, 30 for M8 at their defaults) and the grid sums in
numpy in the JAX package's order; ``m1a_m2a_test``,
``positive_selection_test`` (M7 vs M8) and ``m8_m8a_test`` the LRTs.
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
from phylo_utils_tpu_torch.parallel.sharding import gather_sites, map_sites

__all__ = ["ModelMixtureEngine", "M1aEngine", "M2aEngine",
           "M7Engine", "M8Engine", "M8aEngine",
           "omega_posteriors", "beb_site_posteriors",
           "beb_site_posteriors_m8",
           "positive_selection_test", "m1a_m2a_test", "m8_m8a_test"]


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
        params (K classes, the stack's length), each class built by its own
        model (``class_models``) or the shared one: a host loop over K small
        builds (JAX vmaps the shared build)."""
        k = next(iter(mixture.values())).shape[0]
        pairs = [
            (self._class_models[i] if self._class_models else self.model)
            .build_parts({n: v[i] for n, v in mixture.items()}, dtype=dtype,
                         device=self.device)
            for i in range(k)
        ]
        return (torch.stack([a for a, _ in pairs]),
                torch.stack([b for _, b in pairs]))

    def _class_p(self, sym_k, freqs_k, t_k):
        """(n_nodes, K, S, S) P from per-class (sym, freqs) and per-class
        branch lengths t_k (K, n_real_nodes), identity blocks appended; K is
        the classes given (the BEB scans prune more classes than ``ncat``)."""
        p_k = torch.stack([p_matrices_reversible(sym_k[i], freqs_k[i], t_k[i])
                           for i in range(sym_k.shape[0])])
        return extend_p_identity(p_k.transpose(0, 1), self.schedule.n_nodes)

    def _mixture_tensors(self, params, dtype, eig=None, rates=None):
        """(class rates, cat_weights, P (n_nodes, K, S, S), per-class
        frequencies (K, S)) in ``dtype``: what ``_loglik_fn``,
        ``category_posteriors`` and the ancestral analyses share. ``eig``
        and ``rates`` (the base engine's caches) do not apply to a mixture
        and are ignored."""
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
        _, cat_weights, p, freqs_k = self._mixture_tensors(params, rdt)
        pinv = params["pinv"].to(rdt) if self.invariant_sites else None
        return map_sites(self._site_loglik,
                         (p.to(self.dtype), freqs_k, cat_weights, pinv),
                         leaf_partials, weights, self.device)

    def _site_loglik(self, p, freqs_k, cat_weights, pinv, leaf_partials,
                     weights):
        """(total, sitewise) of one block of patterns (the whole alignment,
        or one shard)."""
        rdt = self._reduce_dtype
        root_partials, root_logscale = self._prune(p, leaf_partials)
        site_lik = torch.einsum("ksi,ki->ks", root_partials.to(rdt), freqs_k)
        root_logscale = root_logscale.to(rdt)
        m = root_logscale.amax(dim=0)
        mixed = (cat_weights[:, None] * site_lik
                 * torch.exp(root_logscale - m[None, :])).sum(dim=0)
        log_var = torch.log(mixed) + m
        if pinv is not None:
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


class SharedOmegaMixtureEngine(ModelMixtureEngine):
    """Omega-class site mixtures whose non-omega parameters are shared.

    The codeml site-model family (M1a/M2a/M7/M8): K site classes that differ
    only in omega, derived from a few free hyperparameters, while kappa and
    the codon frequencies (``shared``) are common to all classes. ``model``
    defaults to GY94. Subclass hooks: ``_n_classes()`` (the class count),
    ``_hyper_defaults()`` (the omega hyperparameters) and
    ``_class_omegas_weights(params) -> (omegas, weights)``, both float64.
    """

    def __init__(self, tree, alignment, model=None, **kwargs):
        if model is None:
            from phylo_utils_tpu_torch.models import GY94 as model
        if "omega" not in model.param_defaults:
            raise ValueError(
                "omega site mixtures need a model with an 'omega' parameter"
            )
        mixture = [
            dict(model.param_defaults) for _ in range(self._n_classes())
        ]
        super().__init__(tree, alignment, model, mixture, **kwargs)

    def _n_classes(self) -> int:
        raise NotImplementedError

    def _hyper_defaults(self) -> Dict:
        raise NotImplementedError

    def default_params(self) -> Dict:
        params = {
            "branch_lengths": self._tensor(self.tree.lengths),
            "shared": {k: self._tensor(v)
                       for k, v in self.model.param_defaults.items()
                       if k != "omega"},
        }
        for k, v in self._hyper_defaults().items():
            params[k] = self._tensor(v)
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
                        kk: self._tensor(vv) for kk, vv in v.items()
                    }}
                else:
                    full[k] = self._tensor(v)
        return full

    def _class_omegas_weights(self, params):
        raise NotImplementedError

    def _category_model_params(self, params):
        om, w = self._class_omegas_weights(params)
        k = om.shape[0]
        mixture = {kk: vv[None].expand((k,) + vv.shape)
                   for kk, vv in params["shared"].items()}
        return {**mixture, "omega": om}, w

    def _f64(self, value) -> torch.Tensor:
        return torch.as_tensor(value).to(device=self.device,
                                         dtype=torch.float64)


class M1aEngine(SharedOmegaMixtureEngine):
    """codeml M1a "nearly neutral" (Nielsen & Yang 1998; Wong et al. 2004).

    Two site classes: purifying ``0 < omega0 < 1`` (weight p0) and neutral
    ``omega = 1`` (weight 1 - p0). Free parameters: ``proportions``
    (2-simplex), ``omega0`` (unit interval, sigmoid under ``fit``),
    ``shared`` (kappa, codon freqs), branch lengths. The null model of the
    M1a-vs-M2a positive-selection LRT (``m1a_m2a_test``).
    """

    def _n_classes(self) -> int:
        return 2

    def _hyper_defaults(self) -> Dict:
        return {"proportions": [0.7, 0.3], "omega0": 0.2}

    def _class_omegas_weights(self, params):
        om0 = self._f64(params["omega0"]).clamp(1e-8, 1.0 - 1e-8)
        om = torch.stack([om0, torch.ones_like(om0)])
        w = self._f64(params["proportions"])
        return om, w / w.sum()


class M2aEngine(M1aEngine):
    """codeml M2a "positive selection" (Wong et al. 2004; Yang et al. 2005).

    M1a plus a third class ``omega2 = 1 + omega2_delta > 1`` (weight p2;
    ``omega2_delta`` softplus-positive under ``fit``). The per-site posterior
    weight on the last class (``omega_posteriors``) is the NEB
    positively-selected-site scan. Alternative model of ``m1a_m2a_test``
    (df = 2).
    """

    def _n_classes(self) -> int:
        return 3

    def _hyper_defaults(self) -> Dict:
        return {"proportions": [0.6, 0.3, 0.1], "omega0": 0.2,
                "omega2_delta": 1.0}

    def _class_omegas_weights(self, params):
        om, _ = super()._class_omegas_weights(params)
        om2 = 1.0 + self._f64(params["omega2_delta"])
        w = self._f64(params["proportions"])
        return torch.cat([om, om2[None]]), w / w.sum()


class M7Engine(SharedOmegaMixtureEngine):
    """Yang et al. (2000) M7: site omega ~ Beta(p, q), discretized.

    ``ncat`` equal-weight classes whose omega is the within-bin Beta mean
    (codeml's discretization, ``ops.beta.discrete_beta``), kappa and the
    codon frequencies shared. Free parameters: ``beta_p``, ``beta_q``
    (positive), ``shared``, branch lengths, all differentiable, so ``fit``
    optimizes the beta shape directly. The null model of the M7-vs-M8 test
    (``positive_selection_test``).
    """

    _EXTRA_KEYS: tuple = ()

    def __init__(self, tree, alignment, model=None, ncat: int = 10,
                 **kwargs):
        self.n_beta = int(ncat)
        super().__init__(tree, alignment, model=model, **kwargs)

    def _n_classes(self) -> int:
        return self.n_beta + (1 if self._EXTRA_KEYS else 0)

    def _hyper_defaults(self) -> Dict:
        return {"beta_p": 1.0, "beta_q": 1.0, **self._extra_defaults()}

    def _extra_defaults(self) -> Dict:
        return {}

    def _beta_classes(self, params):
        """(the n_beta beta-class omegas, their equal weights), float64."""
        from phylo_utils_tpu_torch.ops.beta import discrete_beta

        om = discrete_beta(self._f64(params["beta_p"]),
                           self._f64(params["beta_q"]), self.n_beta)
        return om, torch.full((self.n_beta,), 1.0 / self.n_beta,
                              dtype=torch.float64, device=self.device)

    def _class_omegas_weights(self, params):
        return self._beta_classes(params)

    def _with_extra_class(self, params, omega_extra):
        """The beta classes at weight p0, plus one class of ``omega_extra``
        at weight 1 - p0 (M8, M8a)."""
        om, w = self._beta_classes(params)
        p0 = self._f64(params["p0"]).clamp(1e-6, 1.0 - 1e-6)
        return (torch.cat([om, omega_extra.reshape(1)]),
                torch.cat([w * p0, (1.0 - p0)[None]]))


class M8Engine(M7Engine):
    """Yang et al. (2000) M8: Beta(p, q) plus one omega > 1 class.

    With proportion ``p0`` sites follow the discretized Beta; with
    proportion 1 - p0 they evolve under ``omega = 1 + omega_delta`` (the +1
    floor keeps the class in the omega > 1 regime codeml constrains it to,
    the delta softplus-positive under ``fit``). Compare against M7 with
    ``positive_selection_test``.
    """

    _EXTRA_KEYS = ("p0", "omega_delta")

    def _extra_defaults(self) -> Dict:
        return {"p0": 0.9, "omega_delta": 1.0}

    def _class_omegas_weights(self, params):
        return self._with_extra_class(
            params, 1.0 + self._f64(params["omega_delta"]))


class M8aEngine(M8Engine):
    """M8a (Swanson et al. 2003; Wong et al. 2004): the M8 null with the
    extra class's omega fixed at 1, Beta(p, q) plus a neutral class of
    proportion 1 - p0. Under the null omega sits on the omega = 1 boundary,
    so ``m8_m8a_test`` uses the 1/2 chi2_0 + 1/2 chi2_1 mixture."""

    _EXTRA_KEYS = ("p0",)

    def _extra_defaults(self) -> Dict:
        return {"p0": 0.9}

    def _class_omegas_weights(self, params):
        return self._with_extra_class(
            params, torch.ones((), dtype=torch.float64, device=self.device))


def positive_selection_test(ll_m7: float, ll_m8: float) -> Dict:
    """M7-vs-M8 LRT for positive selection (2 extra params -> df=2)."""
    from phylo_utils_tpu_torch.model_selection import likelihood_ratio_test

    return likelihood_ratio_test(ll_m7, ll_m8, df=2)


def m8_m8a_test(ll_m8a: float, ll_m8: float) -> Dict:
    """M8-vs-M8a LRT with the boundary-mixture null: 2(lnL_M8 - lnL_M8a) ~
    1/2 chi2_0 + 1/2 chi2_1 (codeml practice; Self & Liang 1987). Returns
    {"statistic", "pvalue"}."""
    from scipy.stats import chi2

    stat = 2.0 * (ll_m8 - ll_m8a)
    p = 0.5 * float(chi2.sf(max(stat, 0.0), 1)) if stat > 0 else 1.0
    return {"statistic": float(stat), "pvalue": p}


def m1a_m2a_test(ll_m1a: float, ll_m2a: float) -> Dict:
    """M1a-vs-M2a LRT for positive selection (p2, omega2 extra -> df=2)."""
    from phylo_utils_tpu_torch.model_selection import likelihood_ratio_test

    return likelihood_ratio_test(ll_m1a, ll_m2a, df=2)


def omega_posteriors(engine: ModelMixtureEngine,
                     params: Optional[Mapping] = None):
    """Per-site (posterior mean omega, class posteriors (n_sites, K)) for an
    omega mixture over GY94: the M3/M7/M8 site scan (for M2a and M8 the
    posterior weight on the last class is the per-site positive-selection
    probability, the NEB analogue of codeml's BEB table)."""
    with torch.no_grad():
        mixture, _ = engine._category_model_params(
            engine._full_params(params))
        omegas = mixture["omega"].to("cpu", torch.float64).numpy()
    gam = engine.category_posteriors(params)
    return gam @ omegas, gam


# ---------------------------------------------------------------------------
# Bayes Empirical Bayes (Yang, Wong & Nielsen 2005)
# ---------------------------------------------------------------------------


def _omega_class_p(engine, full, omegas):
    """(P (n_nodes, K, S, S), per-class frequencies (K, S)), float64: the
    omega grid ``omegas`` as the category axis (K = len(omegas), not the
    engine's class count), kappa and the codon frequencies from
    ``full['shared']``, the branch lengths from ``full``."""
    rdt = engine._reduce_dtype
    om = torch.as_tensor(np.asarray(omegas, np.float64), dtype=rdt,
                         device=engine.device)
    k = om.shape[0]
    stacked = {kk: vv.to(rdt)[None].expand((k,) + vv.shape)
               for kk, vv in full["shared"].items()}
    sym_k, freqs_k = engine._class_syms_freqs({**stacked, "omega": om}, rdt)
    t = full["branch_lengths"].to(rdt)
    return engine._class_p(sym_k, freqs_k, t[None, :].expand(k, -1)), freqs_k


def _site_class_logliks(engine, params, omegas) -> np.ndarray:
    """Per-omega sitewise log-likelihoods (len(omegas), n_patterns), float64:
    one pruning pass with the omega grid as the category axis, at the MLEs
    of ``params`` (``_omega_class_p``)."""
    rdt = engine._reduce_dtype
    with torch.no_grad():
        p, freqs_k = _omega_class_p(engine, engine._full_params(params),
                                    omegas)
        root, logscale = engine._prune(p.to(engine.dtype),
                                       engine._leaf_partials)
        lik = torch.einsum("ksi,ki->ks", root.to(rdt), freqs_k)
        out = torch.log(lik) + logscale.to(rdt)
    return out.to("cpu", torch.float64).numpy()


def _beb_omega_grid(d: int = 10, n_fine: Optional[int] = None) -> np.ndarray:
    """The omega categories of one BEB pruning pass: M2a's (``n_fine``
    None) omega0 at d midpoints of (0,1), omega = 1, omega2 at d midpoints
    of (1,11); M8's ``n_fine`` midpoints of (0,1), then omega_s at the d
    midpoints of (1,11)."""
    high = 1.0 + (np.arange(d) + 0.5) * (10.0 / d)
    if n_fine is None:
        return np.concatenate([(np.arange(d) + 0.5) / d, [1.0], high])
    return np.concatenate([(np.arange(n_fine) + 0.5) / n_fine, high])


def beb_site_posteriors(engine, params: Optional[Mapping] = None,
                        d: int = 10):
    """Bayes Empirical Bayes positive-selection site scan for M2a.

    Yang, Wong & Nielsen (2005): instead of plugging in the MLEs of the
    mixture proportions and omegas (NEB, ``omega_posteriors``), integrate
    the site-class posteriors over a uniform prior grid on (p0, p1, omega0,
    omega2), weighting each grid point by its posterior given the data
    (branch lengths, kappa and codon frequencies stay at their MLEs, as in
    codeml). Grid (codeml's): omega0 at d midpoints of (0,1); omega2 at d
    midpoints of (1,11); (p0,p1) at the d x d square midpoints folded onto
    the 2-simplex.

    Returns ``(p_positive, mean_omega)`` per site (not per pattern): the BEB
    posterior probability that the site is in the omega2 class, and the BEB
    posterior mean omega.
    """
    if not isinstance(engine, M2aEngine):
        raise TypeError("BEB is implemented for M2aEngine")
    full = engine._full_params(params)
    omegas = _beb_omega_grid(d)                       # (2d+1,)
    w0, w2 = omegas[:d], omegas[d + 1:]
    logf = _site_class_logliks(engine, full, omegas)  # (2d+1, P)
    n_pat = engine._compressed.n_patterns
    weights = gather_sites(engine._weights).to(
        "cpu", torch.float64).numpy()[:n_pat]
    logf = logf[:, :n_pat]

    # proportion grid: square midpoints folded onto the triangle
    g0, g1 = np.meshgrid((np.arange(d) + 0.5) / d,
                         (np.arange(d) + 0.5) / d, indexing="ij")
    p0g, p1g = g0.ravel().copy(), g1.ravel().copy()
    over = p0g + p1g > 1.0
    p0g[over], p1g[over] = 1.0 - p0g[over], 1.0 - p1g[over]
    p2g = 1.0 - p0g - p1g                            # (d^2,)

    # grid = (props x omega0 x omega2); class likelihoods per grid point
    # are rows of f: class 0 -> w0[i], class 1 -> row d, class 2 -> w2[j]
    m = logf.max(axis=0)                             # (P,)
    f = np.exp(logf - m[None, :])                    # (2d+1, P) scaled
    f1 = f[d]                                        # omega = 1 row
    log_post = np.empty((d, d, p0g.shape[0]))        # grid marginal logL
    acc_pos = np.zeros(n_pat)
    acc_w = np.zeros(n_pat)
    # pass 1: grid posterior weights
    for i in range(d):
        for j in range(d):
            lik = (p0g[:, None] * f[i][None, :]
                   + p1g[:, None] * f1[None, :]
                   + p2g[:, None] * f[d + 1 + j][None, :])
            log_post[i, j] = (weights[None, :] * np.log(lik)).sum(axis=1)
    lp = log_post - log_post.max()
    post_g = np.exp(lp)
    post_g /= post_g.sum()                           # (d, d, n_prop)
    # pass 2: accumulate site posteriors under each grid point
    for i in range(d):
        for j in range(d):
            pg = post_g[i, j]                        # (n_prop,)
            if pg.max() < 1e-12:
                continue
            c0 = p0g[:, None] * f[i][None, :]
            c1 = p1g[:, None] * f1[None, :]
            c2 = p2g[:, None] * f[d + 1 + j][None, :]
            tot = c0 + c1 + c2
            acc_pos += pg @ (c2 / tot)
            acc_w += pg @ ((w0[i] * c0 + c1 + w2[j] * c2) / tot)
    s2p = engine._compressed.site_to_pattern
    return acc_pos[s2p], acc_w[s2p]


def beb_site_posteriors_m8(engine, params: Optional[Mapping] = None,
                           d: int = 10, n_fine: int = 20):
    """Bayes Empirical Bayes positive-selection scan for M8.

    Grid (after Yang, Wong & Nielsen 2005): ``p0`` at d midpoints of (0,1);
    the beta parameters ``p``/``q`` at d midpoints of (0,2); ``omega_s`` at
    d midpoints of (1,11). The beta class omegas of each (p,q) pair are the
    equal-probability bin means snapped to a fixed ``n_fine``-point omega
    grid on (0,1), so the whole scan needs one pruning pass with ``n_fine +
    d`` omega categories; the d^2 pairs' bin means are one batched
    ``discrete_beta`` call. Branch lengths, kappa and codon frequencies stay
    at their MLEs (codeml convention).

    Returns ``(p_positive, mean_omega)`` per site.
    """
    if not isinstance(engine, M8Engine):
        raise TypeError("M8 BEB is implemented for M8Engine")
    from phylo_utils_tpu_torch.ops.beta import discrete_beta

    full = engine._full_params(params)
    omegas = _beb_omega_grid(d, n_fine)                   # (n_fine+d,)
    w_s = omegas[n_fine:]                                # (1,11) grid
    logf = _site_class_logliks(engine, full, omegas)     # (n_fine+d, P)
    n_pat = engine._compressed.n_patterns
    weights = gather_sites(engine._weights).to(
        "cpu", torch.float64).numpy()[:n_pat]
    logf = logf[:, :n_pat]
    m = logf.max(axis=0)
    f = np.exp(logf - m[None, :])                        # scaled liks
    f_beta, f_ws = f[:n_fine], f[n_fine:]                # views

    # beta-bin means per (p,q), snapped to the fine grid -> averaging
    # matrices B (n_pq, n_fine): 1/n_beta at each snapped bin index, and
    # Bw: the bin's mean omega / n_beta there
    pq = (np.arange(d) + 0.5) * (2.0 / d)
    n_beta = engine.n_beta
    pairs = [(p, q) for p in pq for q in pq]
    all_means = discrete_beta(
        torch.tensor([p for p, _ in pairs], dtype=torch.float64),
        torch.tensor([q for _, q in pairs], dtype=torch.float64),
        n_beta).numpy()                                  # (n_pq, n_beta)
    B = np.zeros((len(pairs), n_fine))
    Bw = np.zeros((len(pairs), n_fine))
    for r, means in enumerate(all_means):
        idx = np.clip((means * n_fine).astype(int), 0, n_fine - 1)
        for mo, i in zip(means, idx):
            B[r, i] += 1.0 / n_beta
            Bw[r, i] += mo / n_beta
    mixed_beta = B @ f_beta                              # (n_pq, P)
    mixed_beta_w = Bw @ f_beta                           # (n_pq, P)

    p0g = (np.arange(d) + 0.5) / d                       # (d,)
    # pass 1: grid posterior. lik[a,b,c] = p0_a*mixed[b] + (1-p0_a)*f_ws[c]
    log_post = np.empty((d, len(pairs), d))
    for a in range(d):
        base = p0g[a] * mixed_beta                       # (n_pq, P)
        for c in range(d):
            lik = base + (1.0 - p0g[a]) * f_ws[c][None, :]
            log_post[a, :, c] = (weights[None, :] * np.log(lik)).sum(axis=1)
    lp = log_post - log_post.max()
    post_g = np.exp(lp)
    post_g /= post_g.sum()

    # pass 2: site posteriors
    acc_pos = np.zeros(n_pat)
    acc_w = np.zeros(n_pat)
    for a in range(d):
        for c in range(d):
            pg = post_g[a, :, c]                         # (n_pq,)
            if pg.max() < 1e-14:
                continue
            beta_part = p0g[a] * mixed_beta              # (n_pq, P)
            pos_part = (1.0 - p0g[a]) * f_ws[c][None, :]
            tot = beta_part + pos_part
            acc_pos += pg @ (pos_part / tot)
            acc_w += pg @ (
                (p0g[a] * mixed_beta_w + w_s[c] * pos_part) / tot
            )
    s2p = engine._compressed.site_to_pattern
    return acc_pos[s2p], acc_w[s2p]
