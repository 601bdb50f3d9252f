"""Likelihood engine: models x rate mixtures x trees -> logL(params)
(PyTorch port of ``phylo_utils_tpu.likelihood``).

The engine holds static data (compiled schedule, encoded patterns, on one
explicit device) and evaluates ``logL(params)`` where params is a dict
``{'branch_lengths', 'model', 'alpha'?, 'pinv'?}`` of tensors. Pruners:
``"torch"`` (level-batched plain PyTorch, ``ops.pruning.make_prune_fn``) and
``"cuda"`` (the hand-written pruning kernels, ``ops.cuda_pruning``; CPU
tensors take their plain-PyTorch walks; the engines that take the root
partials themselves prune through ``make_cuda_prune_fn``, the kernels
forward and the plain pruner backward). ``gradient`` and ``value_and_grad``
differentiate the float64 total with respect to every parameter through
torch autograd: P(t) through the reverse rule of
``ops.pmatrix.p_matrices_reversible``, the gamma rates through the port's
own ``gammainc``, and, with ``pruner="cuda"``, the walk through the saveall
kernel and a reverse kernel: the deferred one while its scratch fits the
card, else the classic one (``cuda_pruning.choose_reverse``,
``PHYLO_DEFERRED_VJP``). With ``sharding=`` (``parallel.SiteSharding``)
the patterns are padded and placed once, one contiguous shard per device,
and every walk runs shard by shard on the same kernels, reduced once
(``parallel.sharding.map_sites``). ``GammaMixture`` is the stateful facade
of the JAX package's (and its reference's) API over one engine.
"""
from __future__ import annotations

import warnings
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from phylo_utils_tpu_torch import io as pio
from phylo_utils_tpu_torch import trees as ptrees
from phylo_utils_tpu_torch.convert import (
    empty_paths,
    flatten_params,
    unflatten_params,
)
from phylo_utils_tpu_torch.models.base import Eigen, Model
from phylo_utils_tpu_torch.ops.cuda_pruning import (
    WalkSchedule,
    make_cuda_prune_fn,
    make_fused_loglik_fn,
)
from phylo_utils_tpu_torch.ops.gamma import discrete_gamma
from phylo_utils_tpu_torch.ops.pmatrix import (
    extend_p_identity,
    p_matrices_reversible,
    transition_matrices,
)
from phylo_utils_tpu_torch.ops.pruning import (
    invariant_site_likelihood,
    make_prune_fn,
    mixture_loglik,
    mixture_loglik_from_ll,
)
from phylo_utils_tpu_torch.parallel.sharding import (
    map_sites,
    place,
    sharded_prune,
)

__all__ = ["LikelihoodEngine", "GammaMixture", "rate_categories",
           "mixture_rates_and_p", "validate_param_keys", "root_split"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _canonical_dtype(dtype) -> torch.dtype:
    if dtype is None:
        return torch.float64
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        out = _DTYPES.get(np.dtype(dtype).name)
    if out not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, not {dtype!r}")
    return out


def _checked_device(device) -> torch.device:
    """``device`` as a torch device: "cpu", or "cuda" where there is a card
    (else RuntimeError)."""
    out = torch.device(device)
    if out.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} requested but "
                "torch.cuda.is_available() is False"
            )
        # float32 products must stay full float32: TF32 keeps ~3
        # decimal digits, far outside the 1e-6 logL budget
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif out.type != "cpu":
        raise ValueError(f"device must be cpu or cuda, not {device!r}")
    return out


def rate_categories(engine, params, dtype, rates=None):
    """(rates, cat_weights) for the engine's RATE mixture (gamma/FreeRate/
    none). ``rates``: precomputed gamma category rates (cached by parameter
    value, see ``LikelihoodEngine.model_rates``); only valid for the
    equal-weight gamma mixture."""
    ncat, device = engine.ncat, engine.device
    if rates is not None and ncat > 1:
        rates = torch.as_tensor(rates, dtype=dtype, device=device)
        return rates, torch.full((ncat,), 1.0 / ncat, dtype=dtype,
                                 device=device)
    if ncat > 1 and engine.rate_model == "free":
        cat_weights = params["cat_weights"].to(dtype)
        cat_weights = cat_weights / cat_weights.sum()
        rates = params["rates"].to(dtype)
        rates = rates / (cat_weights * rates).sum()       # weighted mean 1
    elif ncat > 1:
        # on the host in float64 (an f32 discretization error is coherent
        # across every site), differentiably: the incomplete-gamma loops
        # test convergence every few terms, a device sync each on a card
        alpha = params["alpha"].to("cpu", torch.float64)
        rates = discrete_gamma(alpha, ncat, engine.median).to(
            device=device, dtype=dtype)
        cat_weights = torch.full((ncat,), 1.0 / ncat, dtype=dtype,
                                 device=device)
    else:
        rates = torch.ones((1,), dtype=dtype, device=device)
        cat_weights = torch.ones((1,), dtype=dtype, device=device)
    return rates, cat_weights


def mixture_rates_and_p(engine, params, dtype, eig=None, rates=None):
    """Shared mixture construction: (rates, cat_weights, p, freqs).

    ``p`` is (..., n_nodes, K, S, S), with the leading dims of
    ``params['branch_lengths']`` (..., n_real_nodes) as a batch. ``eig``: a
    precomputed ``Eigen`` for the current model parameters; P(t) is then
    reconstructed from it in ``dtype`` and cast to the engine's dtype,
    instead of re-decomposing Q. (The JAX package reconstructs in the
    engine's dtype: in float32 the modes' rounding then puts an ordered Mk
    chain's logL, which rests on small multi-step entries, past the 1e-6
    bound; cast from float64 the value path keeps the gradient path's
    precision.)
    """
    rates, cat_weights = rate_categories(engine, params, dtype, rates=rates)
    t = params["branch_lengths"].to(dtype)
    ts = t[..., :, None] * rates                           # (..., n_nodes, K)
    if eig is not None:
        freqs = eig.freqs.to(dtype)
        p = transition_matrices(eig, ts).to(engine.dtype)
    elif engine.model.reversible:
        sym, freqs = engine.model.build_parts(params["model"], dtype=dtype,
                                              device=engine.device)
        p = p_matrices_reversible(sym, freqs, ts)
    else:
        # non-reversible: matrix_exp of the normalized Q, differentiable
        # through build_parts (no eigendecomposition)
        q, freqs = engine.model.build_parts(params["model"], dtype=dtype,
                                            device=engine.device)
        p = transition_matrices(
            Eigen(evals=None, evecs=None, ivecs=None, freqs=freqs, q=q), ts)
    # identity blocks for binarization pseudo-nodes (no-op on binary trees)
    p = extend_p_identity(p, engine.schedule.n_nodes)
    return rates, cat_weights, p, freqs


def validate_param_keys(params, full, where: str,
                        nested: str = None) -> None:
    """Raise on unknown top-level parameter names, and, when ``nested`` is
    given, on unknown sub-keys of that nested dict: the typo guard of the
    mixture engines' ``_full_params`` (a misspelled key would otherwise be
    stored and silently ignored)."""
    unknown = set(params) - set(full)
    if unknown:
        raise ValueError(
            f"unknown parameter(s) {sorted(unknown)} for {where}; "
            f"available: {sorted(full.keys())}"
        )
    if nested and nested in params:
        sub_unknown = set(params[nested]) - set(full[nested])
        if sub_unknown:
            raise ValueError(
                f"unknown {nested!r} parameter(s) {sorted(sub_unknown)} "
                f"for {where}; available: {sorted(full[nested].keys())}"
            )


def root_split(tree, names) -> list:
    """[{("branch_lengths",): +1 at the root's first child, -1 at its
    second}] when the branch lengths are free and the root has two
    children, else []: under a reversible, stationary model only the sum
    of the two root edges is identifiable."""
    kids = tree.children[tree.root]
    if ("branch_lengths",) not in names or len(kids) != 2:
        return []
    v = np.zeros(tree.n_nodes)
    v[kids[0]], v[kids[1]] = 1.0, -1.0
    return [{("branch_lengths",): v}]


# set by ``utils.metrics.enable_debug_checks``: an engine's value or
# gradient that holds a NaN raises FloatingPointError
DEBUG_NANS = False


def _check_nans(what: str, *tensors: torch.Tensor) -> None:
    if DEBUG_NANS and any(bool(torch.isnan(t).any()) for t in tensors):
        raise FloatingPointError(f"NaN in the engine's {what}")


def _value_key(t) -> bytes:
    return torch.as_tensor(t).detach().cpu().numpy().tobytes()


class LikelihoodEngine:
    """Likelihood evaluator for one (topology, model) pair on one device.

    Parameters
    ----------
    tree : Tree or newick str
    alignment : dict name->seq, or CompressedAlignment
    model : Model
    ncat : rate categories (1 = no rate heterogeneity)
    invariant_sites : add a +I mixture component (param 'pinv')
    median : use median instead of mean gamma discretization
    dtype : partials dtype (None = float64). With float32, P(t) build, root
        reduction and mixing still run in float64.
    compress : collapse identical columns to weighted patterns
    pruner : "torch" (plain PyTorch) or "cuda" (the CUDA pruning kernels on
        CUDA tensors, their plain-PyTorch walks on CPU tensors)
    rate_model : "gamma" (param 'alpha') or "free" (FreeRate: 'rates' and
        'cat_weights' are free, rates renormalized to weighted mean 1)
    device : torch device for every tensor of the engine ("cuda" default;
        raises where there is no card: pass device="cpu" to run on the CPU)
    sharding : optional ``parallel.SiteSharding``: the patterns are padded
        and placed shard by shard on its mesh, each shard walked on its
        device; totals, sitewise values and gradients land on ``device``
    """

    def __init__(
        self,
        tree: Union[ptrees.Tree, str],
        alignment: Union[Mapping[str, str], pio.CompressedAlignment],
        model: Model,
        ncat: int = 1,
        invariant_sites: bool = False,
        median: bool = False,
        dtype=None,
        compress: bool = True,
        pruner: str = "torch",
        rate_model: str = "gamma",
        device="cuda",
        sharding=None,
    ):
        if isinstance(tree, str):
            tree = pio.parse_newick(tree)
        self.tree = tree
        self.model = model
        self.sharding = sharding
        self.ncat = int(ncat)
        self.median = bool(median)
        if rate_model not in ("gamma", "free"):
            raise ValueError(f"unknown rate_model {rate_model!r}")
        self.rate_model = rate_model
        self.invariant_sites = bool(invariant_sites)
        self.dtype = _canonical_dtype(dtype)
        self.device = _checked_device(device)

        # Precision plan: partials stay in `dtype` through the pruning walk
        # (that's where the work is); P(t) construction, the root
        # reduction, rate-category mixing and the final weighted pattern
        # sum run in float64.
        self._reduce_dtype = torch.float64

        if isinstance(alignment, pio.CompressedAlignment):
            ca = alignment
        elif compress:
            ca = pio.compress_patterns(alignment, model.alphabet,
                                       dtype=np.float64)
        else:
            from phylo_utils_tpu_torch.alphabets import encode_alignment

            names, arr = encode_alignment(alignment, model.alphabet)
            ca = pio.CompressedAlignment(
                names=tuple(names),
                partials=arr,
                weights=np.ones(arr.shape[1]),
                site_to_pattern=np.arange(arr.shape[1], dtype=np.int32),
            )
        self._compressed = ca

        missing = set(tree.leaf_names) - set(ca.names)
        if missing:
            raise ValueError(f"alignment is missing taxa {sorted(missing)}")
        if ca.partials.shape[2] != model.n_states:
            raise ValueError(
                f"alignment encodes {ca.partials.shape[2]} states but model "
                f"{model.name!r} has {model.n_states} (wrong alphabet?)"
            )
        order = [ca.names.index(n) for n in tree.leaf_names]
        # (n_leaves, P, S); no host copy when the rows are in tree order
        leaf_partials = (ca.partials if order == list(range(len(ca.names)))
                         else ca.partials[order])

        self.schedule = ptrees.compile_schedule(tree)
        self._prune = None
        self._fused_ll = None
        if pruner == "cuda":
            if self.dtype == torch.float64:
                warnings.warn(
                    "pruner='cuda' computes partials in float32; results "
                    "carry f32 precision. Use pruner='torch' for full-f64 "
                    "parity runs.",
                    stacklevel=2,
                )
            # value and gradient of the base engine in one Function; the
            # engines that take the root partials prune through _prune,
            # and the ancestral down pass walks _walk through B2
            self._walk = WalkSchedule(self.schedule)
            self._fused_ll = make_fused_loglik_fn(self.schedule, self._walk)
            self._prune = make_cuda_prune_fn(self.schedule, self._walk)
        elif pruner == "torch":
            self._prune = make_prune_fn(self.schedule)
        else:
            raise ValueError(
                f"unknown pruner {pruner!r}; use 'torch' or 'cuda'"
            )
        self.pruner = pruner
        # takes SiteShards leaves too: the roots of every shard, in order
        self._prune = sharded_prune(self._prune, self.device)

        self._leaf_partials, self._weights = place(
            sharding, leaf_partials, ca.weights, self.device, self.dtype)
        self._eig_cache_key = None
        self._eig_cache = None
        self._rates_cache_key = None
        self._rates_cache = None

    def model_eigen(self, full_params):
        """Eigen system for ``full_params['model']`` on the engine's device,
        cached by parameter VALUE (the eigendecomposition lives with the
        model and is not redone per evaluation). None for engines whose
        parameters have no single ``model`` entry (the mixtures)."""
        if "model" not in full_params:
            return None
        key = tuple((k, _value_key(v))
                    for k, v in sorted(full_params["model"].items()))
        if key != self._eig_cache_key:
            self._eig_cache = self.model.eigen(
                full_params["model"], dtype=self._reduce_dtype,
                device=self.device,
            )
            self._eig_cache_key = key
        return self._eig_cache

    def model_rates(self, full_params):
        """Discrete-gamma category rates for ``full_params['alpha']`` on the
        engine's device, computed in float64 on the host and cached by
        parameter VALUE. None when the rates are not a function of alpha
        alone (FreeRate / no rate heterogeneity)."""
        if (self.ncat <= 1 or self.rate_model != "gamma"
                or "alpha" not in full_params):
            return None
        key = (_value_key(full_params["alpha"]), self.ncat, self.median)
        if key != self._rates_cache_key:
            alpha = full_params["alpha"].detach().to("cpu", torch.float64)
            self._rates_cache = discrete_gamma(
                alpha, self.ncat, self.median
            ).to(device=self.device, dtype=self._reduce_dtype)
            self._rates_cache_key = key
        return self._rates_cache

    # -- parameters ---------------------------------------------------------

    def _tensor(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    def default_params(self) -> Dict:
        params: Dict = {
            "branch_lengths": self._tensor(self.tree.lengths),
            "model": self.model.defaults(self.dtype, self.device),
        }
        if self.ncat > 1:
            if self.rate_model == "free":
                params["rates"] = torch.linspace(
                    0.2, 2.0, self.ncat, dtype=self.dtype, device=self.device
                )
                params["cat_weights"] = torch.full(
                    (self.ncat,), 1.0 / self.ncat, dtype=self.dtype,
                    device=self.device,
                )
            else:
                params["alpha"] = self._tensor(0.5)
        if self.invariant_sites:
            params["pinv"] = self._tensor(0.2)
        return params

    def _full_params(self, params: Optional[Mapping]) -> Dict:
        full = self.default_params()
        if params:
            for k, v in params.items():
                if k not in full:
                    # typos would otherwise be SILENTLY ignored (the key
                    # is stored but nothing reads it) — e.g. "aplha"
                    raise ValueError(
                        f"unknown parameter {k!r} for this engine; "
                        f"available: {sorted(full.keys())}"
                    )
                if k == "model":
                    unknown = set(v) - set(full["model"])
                    if unknown:
                        raise ValueError(
                            f"unknown model parameter(s) {sorted(unknown)} "
                            f"for {self.model.name}; available: "
                            f"{sorted(full['model'].keys())}"
                        )
                    full["model"] = {**full["model"], **{
                        kk: self._tensor(vv) for kk, vv in v.items()
                    }}
                else:
                    full[k] = self._tensor(v)
        return full

    # -- core computation ----------------------------------------------------

    def _mixture_tensors(self, params, dtype, eig=None, rates=None):
        """Hook: (rates, cat_weights, p, freqs) for this engine's mixture.

        ``p`` is the (n_nodes, K, S, S) batch of per-edge-per-category
        transition matrices. Subclasses whose P(t) varies per EDGE as well
        as per category (branch models: per-edge omega classes) or whose
        branch lengths derive from other parameters (the clock) override
        only this: the value and gradient (the fused kernels under
        ``pruner="cuda"``), the fits and the ancestral analyses all flow
        through it unchanged."""
        return mixture_rates_and_p(self, params, dtype, eig=eig, rates=rates)

    def _loglik_fn(self, params, leaf_partials, weights, eig=None,
                   rates=None):
        rdt = self._reduce_dtype
        # P(t), rates, weights, freqs built in the high-precision dtype;
        # only the pruning pass itself runs in `dtype`.
        _, cat_weights, p, freqs = self._mixture_tensors(
            params, rdt, eig=eig, rates=rates
        )
        pinv = params.get("pinv") if self.invariant_sites else None
        return map_sites(self._site_loglik,
                         (p.to(self.dtype), freqs, cat_weights, pinv),
                         leaf_partials, weights, self.device)

    def _site_loglik(self, p, freqs, cat_weights, pinv, leaf_partials,
                     weights):
        """(total, sitewise) of one block of patterns (the whole alignment,
        or one shard) from the replicated mixture tensors."""
        rdt = self._reduce_dtype
        inv = (
            invariant_site_likelihood(leaf_partials.to(rdt), freqs)
            if self.invariant_sites
            else None
        )
        if self._fused_ll is not None:
            # per-category sitewise logL straight from the walk (root
            # reduction fused)
            ll = self._fused_ll(p, leaf_partials, freqs)
            return mixture_loglik_from_ll(
                ll, cat_weights, weights.to(rdt), pinv=pinv, inv_lik=inv
            )
        root_partials, root_logscale = self._prune(p, leaf_partials)
        return mixture_loglik(
            root_partials.to(rdt), root_logscale.to(rdt), freqs,
            cat_weights, weights.to(rdt), pinv=pinv, inv_lik=inv,
        )

    def _flat_directions(self, names, leaves):
        """Directions of the free parameters (``names``, ``leaves`` as
        ``fisher_covariance`` flattens them) along which the likelihood is
        flat for every data set: a list of {key path: array of the leaf's
        shape}. Here the split of a two-child root's edges under a
        reversible model (the pulley principle)."""
        if not self.model.reversible:
            return []
        return root_split(self.tree, names)

    # -- public API ----------------------------------------------------------

    def _eval(self, full, branch_lengths=None):
        """(total, sitewise) through the cached eigen system and gamma
        rates; ``branch_lengths`` (B, n_nodes) replaces the parameter with
        a batch."""
        with torch.no_grad():
            eig = self.model_eigen(full)
            rates = self.model_rates(full)
            if branch_lengths is not None:
                full = {**full, "branch_lengths": branch_lengths}
            total, sw = self._loglik_fn(full, self._leaf_partials,
                                        self._weights, eig=eig, rates=rates)
        _check_nans("log-likelihood", total, sw)
        return total, sw

    def loglikelihood(self, params: Optional[Mapping] = None) -> float:
        total, _ = self._eval(self._full_params(params))
        return float(total)

    def sitewise_loglikelihoods(
        self, params: Optional[Mapping] = None, per_pattern: bool = False
    ) -> np.ndarray:
        """Per-site (or per-pattern) log-likelihoods, float64."""
        _, sw = self._eval(self._full_params(params))
        sw = sw.to("cpu", torch.float64).numpy()[: self._compressed.n_patterns]
        if per_pattern:
            return sw
        return sw[self._compressed.site_to_pattern]

    def loglikelihood_many(
        self, branch_length_sets, params: Optional[Mapping] = None
    ) -> np.ndarray:
        """logL for MANY branch-length vectors under one fixed model.

        ``branch_length_sets``: (B, n_nodes). All B evaluations run as one
        batched pass (the walk takes the batch as a launch axis); the model
        eigendecomposition and gamma rates are computed once.
        """
        bl = self._check_sets(branch_length_sets)
        total, _ = self._eval(self._full_params(params), branch_lengths=bl)
        return total.to("cpu", torch.float64).numpy()

    def _check_sets(self, branch_length_sets) -> torch.Tensor:
        bl = self._tensor(branch_length_sets)
        if bl.dim() != 2 or bl.shape[1] != len(self.tree.lengths):
            raise ValueError(
                f"branch_length_sets must be (B, {len(self.tree.lengths)}); "
                f"got {tuple(bl.shape)}"
            )
        return bl

    def _value_and_grad(self, full: Dict) -> Tuple[torch.Tensor, Dict]:
        """(total, d sum(total) / d full): the uncached path (P(t) rebuilt
        from the model parameters, gamma rates from alpha); leaf partials
        are data and get no gradient."""
        names, leaves = flatten_params(full)
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        # a parameter-free model's (JC69, Mk) empty dict has no leaves
        empty = empty_paths(full)
        with torch.enable_grad():
            total, _ = self._loglik_fn(
                unflatten_params(names, leaves, empty),
                self._leaf_partials, self._weights)
            grads = torch.autograd.grad(total.sum(), leaves,
                                        allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        _check_nans("value_and_grad", total, *grads)
        return total.detach(), unflatten_params(names, grads, empty)

    def value_and_grad(
        self, params: Optional[Mapping] = None
    ) -> Tuple[torch.Tensor, Dict]:
        """(total logL as a 0-d float64 tensor, gradient dict).

        The gradient has the structure of the full parameter dict (every
        entry, defaults included) with tensors of the engine's dtype on its
        device.
        """
        return self._value_and_grad(self._full_params(params))

    def value_and_grad_many(
        self, branch_length_sets, params: Optional[Mapping] = None
    ) -> Tuple[torch.Tensor, Dict]:
        """``value_and_grad`` for MANY branch-length vectors under one model,
        as one batched pass (the walk takes the batch as a launch axis).

        ``branch_length_sets``: (B, n_nodes). Returns the (B,) float64
        totals and the gradient of their sum: ``branch_lengths`` (B,
        n_nodes) holds each set's own gradient (the sets are independent);
        every other entry is summed over the batch.
        """
        full = self._full_params(params)
        full["branch_lengths"] = self._check_sets(branch_length_sets)
        return self._value_and_grad(full)

    def gradient(self, params: Optional[Mapping] = None) -> Dict:
        """d logL / d params, with the structure of the full params dict."""
        return self.value_and_grad(params)[1]

    def bootstrap_loglikelihoods(
        self,
        n_replicates: int,
        params: Optional[Mapping] = None,
        seed: int = 0,
    ) -> np.ndarray:
        """Nonparametric-bootstrap logL for ``n_replicates`` resamples.

        Sites are resampled with replacement, which on a pattern-compressed
        engine only changes the pattern weights: the pruning pass runs once
        and each replicate is a weighted sum of the sitewise vector.

        The multinomial is drawn over the patterns in order of their first
        site, whatever order they are stored in: that is the JAX package's
        storage order, so one seed gives both packages the same replicates.
        """
        _, sw = self._eval(self._full_params(params))
        n_pat = self._compressed.n_patterns
        _, first_site = np.unique(self._compressed.site_to_pattern,
                                  return_index=True)
        order = np.argsort(first_site)
        sw = sw.to("cpu", torch.float64).numpy()[:n_pat][order]
        w = np.asarray(self._compressed.weights, np.float64)[:n_pat][order]
        n_sites = int(w.sum())
        rng = np.random.default_rng(seed)
        boot_w = rng.multinomial(n_sites, w / n_sites, size=n_replicates)
        return boot_w @ sw


class GammaMixture:
    """Stateful facade with the reference's ``GammaMixture`` API (port of
    ``phylo_utils_tpu.likelihood.GammaMixture``): ``set_alignment`` /
    ``set_tree`` / ``update_alpha`` / ``update_substitution_model`` /
    ``update_branch_lengths`` / ``update_pinv`` / ``get_likelihood`` /
    ``get_sitewise_likelihoods`` / ``get_gradient`` / ``optimise``.

    Every update edits a parameter dict; the engine is rebuilt only by
    ``set_tree`` (or a new model or alignment). ``pruner`` and ``device``
    pass through to ``LikelihoodEngine`` (default the card).
    """

    def __init__(self, alpha: float, ncat: int, model: Model,
                 invariant_sites: bool = False, pinv: float = 0.2,
                 dtype=None, pruner: str = "torch", device="cuda"):
        self.model = model
        self.ncat = int(ncat)
        self.invariant_sites = bool(invariant_sites)
        self._dtype = dtype
        self._pruner = pruner
        self._device = device
        self._engine: Optional[LikelihoodEngine] = None
        self._alignment = None
        self._params: Dict = {"alpha": alpha}
        if invariant_sites:
            self._params["pinv"] = pinv

    # -- wiring --------------------------------------------------------------

    def set_alignment(self, alignment) -> "GammaMixture":
        self._alignment = alignment
        if self._engine is not None:
            self.set_tree(self._engine.tree)
        return self

    def set_tree(self, tree) -> "GammaMixture":
        if self._alignment is None:
            raise ValueError("call set_alignment() before set_tree()")
        self._engine = LikelihoodEngine(
            tree, self._alignment, self.model, ncat=self.ncat,
            invariant_sites=self.invariant_sites, dtype=self._dtype,
            pruner=self._pruner, device=self._device,
        )
        self._params.pop("branch_lengths", None)
        return self

    def _require_engine(self) -> LikelihoodEngine:
        if self._engine is None:
            raise ValueError("call set_alignment() and set_tree() first")
        return self._engine

    # -- updates (reference method names) ------------------------------------

    def update_alpha(self, alpha: float) -> None:
        self._params["alpha"] = alpha

    def update_substitution_model(self, model: Model = None,
                                  **params) -> None:
        if model is not None and model is not self.model:
            self.model = model
            # the previous model's parameters mean nothing to the new one
            self._params.pop("model", None)
            if self._engine is not None:
                self.set_tree(self._engine.tree)
        if params:
            merged = dict(self._params.get("model", {}))
            merged.update(params)
            self._params["model"] = merged

    def update_branch_lengths(self, lengths) -> None:
        self._params["branch_lengths"] = np.asarray(lengths, dtype=np.float64)

    def update_pinv(self, pinv: float) -> None:
        self._params["pinv"] = pinv

    # -- queries --------------------------------------------------------------

    def get_likelihood(self) -> float:
        return self._require_engine().loglikelihood(self._params)

    def get_sitewise_likelihoods(self) -> np.ndarray:
        return self._require_engine().sitewise_loglikelihoods(self._params)

    def get_gradient(self) -> Dict:
        return self._require_engine().gradient(self._params)

    def optimise(self, **kwargs):
        """Joint ML fit of all free parameters (``optimize.fit``); updates
        this object's parameters in place and returns the ``FitResult``."""
        from phylo_utils_tpu_torch.optimize import fit

        res = fit(self._require_engine(), self._params, **kwargs)
        self._params = dict(res.params)
        return res
