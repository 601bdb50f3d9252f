"""Joint branch-length and model-parameter fit with exact gradients
(PyTorch port of the ``fit`` half of ``phylo_utils_tpu.optimize``).

Every branch length and model parameter is optimized jointly on the
engine's differentiated logL. Parameters live in an unconstrained space
(softplus for positive values, softmax for frequency-like simplices,
sigmoid for proportions) in float64 on the engine's device. The default
optimizer is ``torch.optim.LBFGS`` with a strong-Wolfe line search, one
L-BFGS iteration per fit step (the JAX package's default is optax L-BFGS
with a zoom line search; the two take different steps, so a port fit is
held to the JAX fit's final logL and estimates, not its trajectory).

Also here: single-branch Newton (``newton_branch_length``), the 1-D
minimizers (``golden_section``, ``brent_minimize``), pairwise ML distances
(``ml_distance_matrix``), multistart fits (``fit_multistart``) and the
observed-information covariance and standard errors (``fisher_covariance``,
``standard_errors``), and the parametric bootstrap (``simulation_setup``,
``parametric_bootstrap``: simulate at the fitted model with
``simulate.simulate_alignment``, refit each replicate).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from phylo_utils_tpu_torch.convert import (
    empty_paths,
    flatten_params,
    unflatten_params,
)
from phylo_utils_tpu_torch.models.base import Eigen
from phylo_utils_tpu_torch.ops.pmatrix import transition_matrices

__all__ = [
    "transform_params",
    "untransform_params",
    "fit",
    "FitResult",
    "default_optimizer",
    "fit_multistart",
    "fisher_covariance",
    "standard_errors",
    "newton_branch_length",
    "golden_section",
    "brent_minimize",
    "ml_distance_matrix",
    "simulation_setup",
    "parametric_bootstrap",
]

# ---------------------------------------------------------------------------
# Reparameterization: constrained model space <-> unconstrained optimizer space
# ---------------------------------------------------------------------------

_SIMPLEX_KEYS = {"freqs", "cat_weights", "proportions",
                 "nuc_freqs"}          # softmax rows (sum to 1)
_UNIT_KEYS = {"pinv", "p0", "omega0", "height_fractions"}  # sigmoid (0, 1)
# everything else positive-valued: softplus-parameterized


def _inv_softplus(y: torch.Tensor) -> torch.Tensor:
    # log(expm1(y)), stable for large y
    return torch.where(y > 20.0, y, torch.log(torch.expm1(y.clamp_min(1e-10))))


def _leaf_transform(key: str, value, inverse: bool) -> torch.Tensor:
    value = torch.as_tensor(value)
    if key in _SIMPLEX_KEYS:
        if inverse:
            logits = torch.log(value.clamp_min(1e-12))
            return logits - logits.mean()
        return torch.softmax(value, dim=-1)
    if key in _UNIT_KEYS:
        if inverse:
            v = value.clamp(1e-8, 1.0 - 1e-8)
            return torch.log(v) - torch.log1p(-v)
        return torch.sigmoid(value)
    return _inv_softplus(value) if inverse else torch.nn.functional.softplus(
        value)


def _map_params(params: Mapping, inverse: bool) -> Dict:
    out: Dict = {}
    for k, v in params.items():
        if isinstance(v, Mapping):
            out[k] = _map_params(v, inverse)
        else:
            out[k] = _leaf_transform(k, v, inverse)
    return out


def untransform_params(raw: Mapping) -> Dict:
    """Unconstrained optimizer dict -> constrained model parameters."""
    return _map_params(raw, inverse=False)


def transform_params(params: Mapping) -> Dict:
    """Constrained model parameters -> unconstrained optimizer dict."""
    return _map_params(params, inverse=True)


# ---------------------------------------------------------------------------
# Joint gradient-based fit
# ---------------------------------------------------------------------------


def _split_free(base: Mapping, free) -> tuple:
    """Split params into (frozen, start) by the ``free`` name list.

    Plain names claim a whole top-level entry; dotted names
    ('model.kappa') claim one entry of a nested dict, leaving its
    siblings frozen. Unknown names raise (catches typos that would
    otherwise silently freeze a parameter)."""
    top = set()
    nested: Dict = {}
    for name in free:
        if "." in name:
            head, rest = name.split(".", 1)
            nested.setdefault(head, []).append(rest)
        else:
            top.add(name)
    unknown = (top | set(nested)) - set(base.keys())
    if unknown:
        raise ValueError(
            f"unknown free parameter(s) {sorted(unknown)}; "
            f"available: {sorted(base.keys())}"
        )
    both = top & set(nested)
    if both:
        raise ValueError(
            f"{sorted(both)} listed both whole ('k') and nested ('k.sub')"
        )
    frozen: Dict = {}
    start: Dict = {}
    for k, v in base.items():
        if k in top:
            start[k] = v
        elif k in nested:
            if not isinstance(v, Mapping):
                raise ValueError(f"'{k}' is not a nested dict; use '{k}'")
            sub_frozen, sub_start = _split_free(v, nested[k])
            if sub_frozen:
                frozen[k] = sub_frozen
            if sub_start:
                start[k] = sub_start
        else:
            frozen[k] = v
    return frozen, start


def _merge_params(frozen: Mapping, opt: Mapping) -> Dict:
    """Recombine frozen and optimized params (recursive dict merge)."""
    out = dict(frozen)
    for k, v in opt.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = _merge_params(out[k], v)
        else:
            out[k] = v
    return out


class FitResult(NamedTuple):
    params: Dict                 # constrained, best seen
    loglik: float                # logL of ``params``, re-evaluated
    trace: np.ndarray            # logL per step
    n_steps: int
    converged: bool


def default_optimizer(params: List[torch.Tensor]) -> torch.optim.Optimizer:
    """L-BFGS, one iteration with a strong-Wolfe line search per step.

    ``max_eval`` is set explicitly: torch gives the line search
    ``max_eval`` minus the evaluations already made in the step, and its
    default (``max_iter * 5 // 4``, 1 here) would leave it none, so a first
    trial that fails the Armijo test would end the fit."""
    return torch.optim.LBFGS(params, lr=1.0, max_iter=1, max_eval=25,
                             history_size=10, line_search_fn="strong_wolfe")


def fit(
    engine,
    params0: Optional[Mapping] = None,
    free: Optional[Tuple[str, ...]] = None,
    optimizer: Optional[Callable[[List[torch.Tensor]],
                                 torch.optim.Optimizer]] = None,
    max_steps: int = 500,
    tol: float = 1e-8,
    patience: int = 20,
    callback: Optional[Callable[[int, float, Dict], None]] = None,
    steps_per_call: int = 1,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume_from: Optional[str] = None,
) -> FitResult:
    """Maximize logL over branch lengths and model parameters jointly.

    Parameters
    ----------
    engine : LikelihoodEngine
    params0 : starting constrained parameters (default engine defaults)
    free : parameter names to optimize (default: all). Names address the
        top level of the params dict ('branch_lengths', 'model', 'alpha',
        'pinv'); dotted names address nested entries ('model.kappa') so
        sibling parameters stay frozen. Non-free parameters are held at
        their starting value; unknown names raise.
    optimizer : a callable that takes the list of unconstrained parameter
        tensors and returns a ``torch.optim.Optimizer``, e.g.
        ``functools.partial(torch.optim.Adam, lr=1e-2)``; default
        ``default_optimizer`` (L-BFGS, strong-Wolfe line search).
    tol : stop when the best logL improves by < tol over `patience` steps
    steps_per_call : steps between two checks of the stopping rule and of
        the checkpoint schedule (eager PyTorch has no dispatch to fuse, so
        this is only the granularity of early stopping and checkpoints)
    checkpoint_path / checkpoint_every : when both set, the full optimizer
        state ``{raw, optimizer}`` (unconstrained space) plus the step
        counter is written atomically every ``checkpoint_every`` steps
        (at chunk granularity); a killed run restarted with
        ``resume_from=checkpoint_path`` replays the remaining steps
        bit-exactly.
    resume_from : checkpoint path to restore (raw, optimizer, step) from
        before stepping. ``max_steps`` bounds the TOTAL step count
        including the restored steps.

    The model's eigensystem (model frozen) and the gamma rates (alpha
    frozen) are constants of the fit and come from the engine's caches.
    The returned ``loglik`` is the engine's logL at the returned params.
    """
    from phylo_utils_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    base = engine._full_params(params0)
    if free is None:
        free = tuple(base.keys())
    frozen, start = _split_free(base, free)
    free_tops = {k.split(".", 1)[0] for k in free}
    eig = engine.model_eigen(base) if "model" not in free_tops else None
    rates = engine.model_rates(base) if "alpha" not in free_tops else None
    data_lp, data_w = engine._leaf_partials, engine._weights

    # the unconstrained vector lives in float64 whatever the engine's
    # dtype: the engine casts to its compute dtype itself
    names, raw0 = flatten_params(transform_params(start))
    raw = [t.detach().to(device=engine.device, dtype=torch.float64)
           .clone().requires_grad_(True) for t in raw0]
    opt = (optimizer or default_optimizer)(raw)

    # a parameter-free model's (JC69, Mk) empty dict has no leaves to
    # carry it through the flat list
    empty = empty_paths(start)

    def params_of(tensors) -> Dict:
        return _merge_params(frozen, untransform_params(
            unflatten_params(names, tensors, empty)))

    def closure():
        opt.zero_grad()
        total, _ = engine._loglik_fn(params_of(raw), data_lp, data_w,
                                     eig=eig, rates=rates)
        loss = -total.to(torch.float64)
        loss.backward()
        finite = torch.isfinite(torch.cat(
            [loss.detach().reshape(1)] + [t.grad.reshape(-1) for t in raw]))
        if not bool(finite.all()):
            # a line-search trial at extreme values (alpha or a branch
            # length near 0) whose logL or gradient is not finite: an
            # infinite loss makes the search step back instead of
            # carrying NaN into the next direction
            return torch.full_like(loss.detach(), float("inf"))
        return loss

    def snapshot():
        return [t.detach().clone() for t in raw]

    n = 0
    if resume_from:
        state, n = load_checkpoint(resume_from, map_location=engine.device)
        with torch.no_grad():
            for t, name in zip(raw, names):
                t.copy_(state["raw"]["/".join(name)])
        opt.load_state_dict(state["optimizer"])

    # Bookkeeping: a step returns the loss of the raw it was GIVEN, so each
    # recorded (ll, raw) pair uses the pre-step raw. `best_trace` (any
    # step value) drives patience; `best_ret` drives the returned params.
    trace: List[float] = []
    best_trace = best_ret = -np.inf
    best_raw = snapshot()
    since_best = 0
    last_ckpt = n
    while n < max_steps:
        for _ in range(min(steps_per_call, max_steps - n)):
            raw_start = snapshot()
            ll = -float(opt.step(closure).detach())
            n += 1
            trace.append(ll)
            if callback is not None:
                with torch.no_grad():
                    callback(n, ll, untransform_params(
                        unflatten_params(names, snapshot())))
            if ll > best_trace + tol:
                best_trace, since_best = ll, 0
            else:
                since_best += 1
            if ll > best_ret:
                best_ret, best_raw = ll, raw_start
        if (checkpoint_path and checkpoint_every
                and n - last_ckpt >= checkpoint_every):
            save_checkpoint(checkpoint_path, {
                "raw": {"/".join(name): t.detach().clone()
                        for name, t in zip(names, raw)},
                "optimizer": opt.state_dict(),
            }, step=n)
            last_ckpt = n
        if since_best >= patience:
            break
    with torch.no_grad():
        # the current raw was never evaluated: it may be the optimum
        final_candidate_ll = engine.loglikelihood(params_of(raw))
        if final_candidate_ll > best_ret:
            best_ret, best_raw = final_candidate_ll, snapshot()
        params = params_of(best_raw)
        # report the logL OF THE RETURNED PARAMS, re-evaluated
        final_ll = engine.loglikelihood(params)
    return FitResult(
        params=params,
        loglik=float(final_ll),
        trace=np.asarray(trace),
        n_steps=n,
        converged=since_best >= patience,
    )


# ---------------------------------------------------------------------------
# Multistart fit
# ---------------------------------------------------------------------------


def _perturb(raw: Mapping, rng: np.random.Generator, scale: float) -> Dict:
    """``raw`` plus N(0, scale) noise, drawn leaf by leaf in sorted-key order
    (the order in which ``jax.tree.map`` visits a dict, so one seed draws
    the same numbers for the same leaves as the JAX package)."""
    out: Dict = {}
    for k in sorted(raw):
        v = raw[k]
        if isinstance(v, Mapping):
            out[k] = _perturb(v, rng, scale)
        else:
            x = v.detach().to("cpu", torch.float64).numpy()
            out[k] = torch.as_tensor(x + rng.normal(0.0, scale, x.shape),
                                     dtype=torch.float64, device=v.device)
    return out


def fit_multistart(
    engine,
    params0: Optional[Mapping] = None,
    n_starts: int = 4,
    perturb: float = 0.5,
    seed: int = 0,
    free: Optional[Tuple[str, ...]] = None,
    **fit_kwargs,
) -> FitResult:
    """Multi-start ML fit: ``fit`` from the given/default start plus
    ``n_starts - 1`` randomized starts (Gaussian noise of scale ``perturb``
    in the unconstrained space, drawn from ``numpy.random.default_rng(seed)``,
    so constraints hold automatically); returns the best FitResult.

    Only the FREE parameters are perturbed: with ``free`` given, frozen
    parameters stay exactly at their ``params0`` values in every start.
    """
    base = engine._full_params(params0)
    free_names = tuple(base.keys()) if free is None else tuple(free)
    frozen, start_free = _split_free(base, free_names)
    rng = np.random.default_rng(seed)
    best: Optional[FitResult] = None
    for i in range(n_starts):
        if i == 0:
            start = base
        else:
            noisy = _perturb(transform_params(start_free), rng, perturb)
            start = _merge_params(frozen, untransform_params(noisy))
        res = fit(engine, start, free=free, **fit_kwargs)
        if best is None or res.loglik > best.loglik:
            best = res
    return best


# ---------------------------------------------------------------------------
# Observed information: covariance and standard errors
# ---------------------------------------------------------------------------


def fd_step(dtype) -> float:
    """Relative central-difference step of ``_hessian_fd_of_gradient``:
    eps^(1/3) of the dtype the gradient is computed in (the engine's
    partials dtype), 6.1e-6 for float64 and 4.9e-3 for float32. The step
    balances the O(h^2) truncation against the gradient's roundoff over
    2h; a float32 walk's gradient carries ~1e-7 relative roundoff, which
    the float64 step would amplify past the curvature itself. (The JAX
    package takes eps^(1/3) of its session dtype, float64 under x64.)"""
    return float(torch.finfo(dtype).eps ** (1.0 / 3.0))


def _hessian_fd_of_gradient(negll, point: torch.Tensor,
                            rel_h: float) -> np.ndarray:
    """Observed information by central differences of the exact gradient:
    H[:, i] ~= (grad(x + h_i e_i) - grad(x - h_i e_i)) / 2 h_i with
    h_i = rel_h max(|x_i|, 1e-2); accurate to O(h^2) with exact scores."""

    def grad_at(vec: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(vec, dtype=point.dtype,
                            device=point.device).requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(negll(x), x)
        return g.detach().to("cpu", torch.float64).numpy()

    flat = point.detach().to("cpu", torch.float64).numpy()
    n = flat.size
    h = np.zeros((n, n))
    for i in range(n):
        step = rel_h * max(abs(flat[i]), 1e-2)
        vp, vm = flat.copy(), flat.copy()
        vp[i] += step
        vm[i] -= step
        h[:, i] = (grad_at(vp) - grad_at(vm)) / (2.0 * step)
    return h


def fisher_covariance(
    engine,
    params: Mapping,
    free: Optional[Tuple[str, ...]] = None,
):
    """(cov, (names, leaves, sizes)): observed-information covariance of the
    free parameters at ``params`` (flattened in ``flatten_params`` order of
    the free sub-dict: key paths ``names``, float64 ``leaves`` of ``sizes``
    elements). Boundary/non-finite rows are dropped (their variance reads
    nan).

    The Hessian of -logL is exact (``torch.autograd.functional.hessian``)
    where the path has a second derivative, else central differences of
    the exact gradient (``_hessian_fd_of_gradient``, step ``fd_step`` of
    the engine's dtype). As in ``fit``, a frozen model reuses the engine's
    cached eigensystem and a frozen alpha its cached gamma rates, so with
    ``pruner="torch"`` branch lengths (and alpha, through the port's own
    ``gammainc``) differentiate twice exactly. A free reversible model
    takes the difference: P(t)'s reverse rule holds the eigensystem
    constant, which is exact once but not twice, so it refuses a second
    derivative. ``pruner="cuda"`` always takes the difference: the
    kernels' Function has no second derivative. On the difference path
    the directions along which the likelihood is flat for every data set
    (``_flat_basis``) are left out of the inverse, where the exact
    Hessian's ``pinv`` drops them: the entries then read as JAX's.
    """
    base = engine._full_params(params)
    if free is None:
        free = tuple(base.keys())
    frozen, point = _split_free(base, free)
    free_tops = {k.split(".", 1)[0] for k in free}
    eig = engine.model_eigen(base) if "model" not in free_tops else None
    rates = engine.model_rates(base) if "alpha" not in free_tops else None
    lp, w = engine._leaf_partials, engine._weights
    names, leaves = flatten_params(point)
    leaves = [t.detach().to(torch.float64) for t in leaves]
    shapes = [tuple(t.shape) for t in leaves]
    sizes = [t.numel() for t in leaves]
    vec = torch.cat([t.reshape(-1) for t in leaves])

    def negll(x: torch.Tensor) -> torch.Tensor:
        parts, off = [], 0
        for shape, size in zip(shapes, sizes):
            parts.append(x[off:off + size].reshape(shape))
            off += size
        full = _merge_params(frozen, unflatten_params(names, parts))
        total, _ = engine._loglik_fn(full, lp, w, eig=eig, rates=rates)
        return -total.to(torch.float64)

    flat = None
    try:
        with torch.enable_grad():
            h = torch.autograd.functional.hessian(negll, vec)
        h = h.detach().to("cpu", torch.float64).numpy()
    except (RuntimeError, NotImplementedError) as e:
        if "derivative" not in str(e):     # a fault, not a missing rule
            raise
        # no second derivative on this path (see above): central
        # differences OF THE EXACT GRADIENT, the standard "numerical
        # observed information from analytic scores"
        h = _hessian_fd_of_gradient(negll, vec, fd_step(engine.dtype))
        flat = _flat_basis(engine, names, leaves, sizes, h)
    h = 0.5 * (h + h.T)
    n = vec.numel()
    finite = np.isfinite(h).all(axis=0) & np.isfinite(h).all(axis=1)
    cov = np.full((n, n), np.nan)
    if finite.any():
        hf = h[np.ix_(finite, finite)]
        if flat is None:
            cov[np.ix_(finite, finite)] = np.linalg.pinv(hf)
        else:
            q = _complement(flat[finite])
            cov[np.ix_(finite, finite)] = (
                q @ np.linalg.pinv(q.T @ hf @ q) @ q.T)
    return cov, (names, leaves, sizes)


def _flat_basis(engine, names, leaves, sizes, h: np.ndarray) -> np.ndarray:
    """(n, m) directions of the flattened free parameters along which the
    likelihood is flat for every data set: the engine's
    (``_flat_directions``: a two-child root's edge split under a reversible
    model, the partition rates' common scale) and each parameter the
    likelihood never reads (an exactly zero row and column of the
    difference Hessian, as in the exact one). An exact Hessian is zero
    along them; central differences of the gradient there are noise, which
    ``pinv`` would invert, so ``fisher_covariance`` inverts the Hessian on
    their orthogonal complement instead."""
    offsets = dict(zip(names, np.cumsum([0] + sizes[:-1])))
    n = sum(sizes)
    cols = []
    hook = getattr(engine, "_flat_directions", None)
    for direction in (hook(names, leaves) if hook else []):
        v = np.zeros(n)
        for path, d in direction.items():
            d = np.asarray(d, np.float64).reshape(-1)
            v[offsets[path]:offsets[path] + d.size] = d
        cols.append(v)
    for i in np.flatnonzero((h == 0).all(axis=0) & (h == 0).all(axis=1)):
        cols.append(np.eye(n)[i])
    return np.stack(cols, axis=1) if cols else np.zeros((n, 0))


def _complement(u: np.ndarray) -> np.ndarray:
    """Orthonormal basis (n, n - rank) of the complement of span(u)."""
    if u.shape[1] == 0:
        return np.eye(u.shape[0])
    left, sv, _ = np.linalg.svd(u, full_matrices=True)
    rank = int((sv > 1e-12 * sv.max()).sum()) if sv.size else 0
    return left[:, rank:]


def standard_errors(
    engine,
    params: Mapping,
    free: Optional[Tuple[str, ...]] = None,
) -> Dict:
    """Asymptotic standard errors of MLEs from the observed Fisher
    information (``fisher_covariance``), in the constrained space.

    ``params`` should be the fitted MLEs (e.g. ``FitResult.params``);
    ``free`` selects which parameters the information matrix covers (same
    semantics as ``fit``, dotted names included). Entries whose curvature
    is not positive (a boundary, a flat direction such as a root edge)
    get nan; confounded directions are resolved by the pseudo-inverse.
    Returns a dict shaped like the free parameters of float64 numpy
    arrays.
    """
    cov, (names, leaves, sizes) = fisher_covariance(engine, params, free)
    var = np.diag(cov).copy()
    var[~(var > 0)] = np.nan
    se_flat = np.sqrt(var)
    out, off = [], 0
    for t, size in zip(leaves, sizes):
        out.append(se_flat[off:off + size].reshape(tuple(t.shape)))
        off += size
    return unflatten_params(names, out)


# ---------------------------------------------------------------------------
# Single-branch Newton (analytic derivatives)
# ---------------------------------------------------------------------------


def _tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` by a fixed pairwise tree of elementwise adds (zero
    padded to a power of two). Each output element is the same sequence
    of IEEE adds whatever the other dims hold, where a library reduction
    or matmul may split its sum by the shape of the batch."""
    n = x.shape[dim]
    width = 1 << max(n - 1, 0).bit_length()
    if width > n:
        pad = list(x.shape)
        pad[dim] = width - n
        x = torch.cat([x, x.new_zeros(pad)], dim)
    while x.shape[dim] > 1:
        half = x.shape[dim] // 2
        x = x.narrow(dim, 0, half) + x.narrow(dim, half, half)
    return x.squeeze(dim)


def _branch_lnl_derivs(eig: Eigen, partials_a: torch.Tensor,
                       partials_b: torch.Tensor, weights: torch.Tensor, t):
    """(lnL, dlnL/dt, d2lnL/dt2) for the likelihood across a single branch,
    L_s = sum_ij pi_i a_si P_ij(t) b_sj. ``partials_a``/``partials_b``
    (..., sites, S), ``weights`` (sites,), ``t`` with the leading dims
    (a batch of branches, e.g. taxon pairs).

    The math of ``transition_matrices`` (clamped), ``dp_matrices`` (Q P)
    and ``d2p_matrices`` (Q^2 P), written as elementwise products and
    ``_tree_sum``s, so one branch's values do not depend on the batch it
    is computed in."""
    dt = partials_a.dtype
    t = torch.as_tensor(t, dtype=dt, device=partials_a.device)
    if eig.evals is None:       # non-reversible: matrix_exp of Q t
        p = transition_matrices(eig, t)
    else:
        recon = (eig.recon if eig.recon is not None else torch.einsum(
            "ik,kj->kij", eig.evecs, eig.ivecs)).to(dt)
        ew = torch.exp(eig.evals.to(dt) * t[..., None])        # (..., k)
        p = _tree_sum(ew[..., :, None, None] * recon, -3).clamp_min(0.0)
    q = eig.q.to(dt)
    qp = _tree_sum(q[:, :, None] * p[..., None, :, :], -2)
    q2p = _tree_sum((q @ q)[:, :, None] * p[..., None, :, :], -2)
    wa = partials_a * eig.freqs.to(dt)

    def site_dot(mat):          # sum_i wa_si sum_j mat_ij b_sj
        mb = _tree_sum(mat[..., None, :, :] * partials_b[..., :, None, :], -1)
        return _tree_sum(wa * mb, -1)

    f = site_dot(p).clamp_min(torch.finfo(dt).tiny)
    d1 = site_dot(qp) / f
    d2 = site_dot(q2p) / f - d1 * d1
    return (_tree_sum(weights * torch.log(f), -1),
            _tree_sum(weights * d1, -1), _tree_sum(weights * d2, -1))


def newton_branch_length(
    eig: Eigen,
    partials_a: torch.Tensor,
    partials_b: torch.Tensor,
    weights: torch.Tensor,
    t0: float = 0.1,
    min_t: float = 1e-8,
    max_t: float = 20.0,
    iters: int = 20,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Optimize one branch length (or a batch: the partials' leading dims)
    by safeguarded Newton-Raphson on analytic first and second logL
    derivatives: a positivity clamp, and a x1.5 / x0.5 step uphill when
    the curvature is not negative. A fixed iteration count. Returns
    (t*, lnL*)."""
    t = torch.full(partials_a.shape[:-2], float(t0), dtype=partials_a.dtype,
                   device=partials_a.device)
    for _ in range(iters):
        _, d1, d2 = _branch_lnl_derivs(eig, partials_a, partials_b, weights,
                                       t)
        newton = t - d1 / torch.where(d2 < 0, d2, -torch.ones_like(d2))
        fallback = torch.where(d1 > 0, t * 1.5, t * 0.5)
        t = torch.where(d2 < 0, newton, fallback).clamp(min_t, max_t)
    lnl, _, _ = _branch_lnl_derivs(eig, partials_a, partials_b, weights, t)
    return t, lnl


# ---------------------------------------------------------------------------
# 1-D safeguarded minimizers
# ---------------------------------------------------------------------------

_GOLD = 0.3819660112501051  # 2 - phi


def golden_section(
    fn: Callable[[torch.Tensor], torch.Tensor],
    lo: float,
    hi: float,
    iters: int = 60,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Golden-section minimization of ``fn`` on [lo, hi] in float64.

    Interior points x1 < x2 at the golden ratio; each iteration shrinks the
    bracket to [lo, x2] or [x1, hi], reusing the surviving interior point
    so ``fn`` is evaluated once per iteration. Returns (x, fn(x)).
    """
    invphi = 1.0 - _GOLD  # 0.618...
    lo = torch.as_tensor(lo, dtype=torch.float64)
    hi = torch.as_tensor(hi, dtype=torch.float64)
    x1 = hi - invphi * (hi - lo)
    x2 = lo + invphi * (hi - lo)
    f1, f2 = fn(x1), fn(x2)
    for _ in range(iters):
        if bool(f1 < f2):       # keep [lo, x2]; x1 survives as the new x2
            hi, x2, f2 = x2, x1, f1
            x1 = hi - invphi * (hi - lo)
            f1 = fn(x1)
        else:                   # keep [x1, hi]; x2 survives as the new x1
            lo, x1, f1 = x1, x2, f2
            x2 = lo + invphi * (hi - lo)
            f2 = fn(x2)
    return (x1, f1) if bool(f1 < f2) else (x2, f2)


def brent_minimize(
    fn: Callable[[torch.Tensor], torch.Tensor],
    lo: float,
    hi: float,
    tol: float = 1e-10,
    iters: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brent's method (parabolic interpolation + golden fallback) on
    [lo, hi], the JAX package's loop step for step on float64 scalars;
    ``fn`` takes and returns 0-d tensors. Returns (x, fn(x))."""

    def f(x: float) -> float:
        return float(fn(torch.tensor(x, dtype=torch.float64)))

    a, b = float(lo), float(hi)
    x = w = v = a + _GOLD * (b - a)
    fx = fw = fv = f(x)
    d = e = 0.0
    for _ in range(iters):
        m = 0.5 * (a + b)
        tol1 = tol * abs(x) + 1e-12
        if not abs(x - m) > 2 * tol1 - 0.5 * (b - a):
            break
        # parabolic fit through (x, fx), (w, fw), (v, fv)
        r = (x - w) * (fx - fv)
        q = (x - v) * (fx - fw)
        p = (x - v) * q - (x - w) * r
        q2 = 2.0 * (q - r)
        if q2 > 0:
            p = -p
        q2 = abs(q2)
        use_para = (abs(p) < abs(0.5 * q2 * e)
                    and p > q2 * (a - x) and p < q2 * (b - x))
        e_gold = b - x if x < m else a - x
        if use_para:
            d, e = p / (1.0 if q2 == 0 else q2), d
        else:
            d, e = _GOLD * e_gold, e_gold
        if abs(d) >= tol1:
            u = x + d
        else:
            u = x + ((d > 0) - (d < 0)) * tol1
        fu = f(u)
        if fu <= fx:
            if u >= x:
                a = x
            else:
                b = x
            v, fv, w, fw, x, fx = w, fw, x, fx, u, fu
        else:
            if u < x:
                a = u
            else:
                b = u
            if fu <= fw or w == x:
                v, fv, w, fw = w, fw, u, fu
            elif fu <= fv or v == x or v == w:
                v, fv = u, fu
    return (torch.tensor(x, dtype=torch.float64),
            torch.tensor(fx, dtype=torch.float64))


# ---------------------------------------------------------------------------
# Pairwise ML distances
# ---------------------------------------------------------------------------

# host bytes one chunk of taxon pairs may take on the CPU
_HOST_PAIR_BYTES = 1 << 30


def _pair_chunk(n_pairs: int, n_pat: int, s: int, dtype: torch.dtype,
                device: torch.device) -> int:
    """Pairs per Newton batch: each pair holds its two taxa's partials and
    a few per-site vectors (~4 S + 8 values per pattern) and, inside
    ``site_dot``, the (sites, S, S) products with their padded tree sums
    (~3 S^2 values per pattern); half the card's free memory, or
    ``_HOST_PAIR_BYTES`` on the CPU."""
    per_pair = (3 * s * s + 4 * s + 8) * n_pat * torch.finfo(dtype).bits // 8
    if device.type == "cuda":
        budget = torch.cuda.mem_get_info(device)[0] // 2
    else:
        budget = _HOST_PAIR_BYTES
    return max(1, min(n_pairs, budget // per_pair))


def ml_distance_matrix(
    alignment,
    model,
    params: Optional[Mapping] = None,
    t0: float = 0.1,
    max_t: float = 20.0,
    dtype=None,
    device="cuda",
) -> np.ndarray:
    """Maximum-likelihood pairwise evolutionary distances.

    Every pair's safeguarded Newton iteration (``newton_branch_length``)
    runs at once: the n(n-1)/2 pairs are one batch dimension, cut into
    chunks of as many pairs as fit free memory (``_pair_chunk``). A pair's
    arithmetic does not depend on its chunk (``_branch_lnl_derivs`` sums
    in a fixed order). Pattern compression is applied once globally. ``dtype``:
    float64 (default) or float32; ``device``: "cuda" (default) or "cpu".
    Returns a dense symmetric (n, n) float64 numpy matrix (diagonal 0)
    ordered like the alignment; access names via ``list(alignment)``.
    """
    from phylo_utils_tpu_torch import io as pio

    ca = (alignment if isinstance(alignment, pio.CompressedAlignment)
          else pio.compress_patterns(alignment, model.alphabet))
    dt = torch.float64 if dtype is None else (
        dtype if isinstance(dtype, torch.dtype)
        else getattr(torch, np.dtype(dtype).name))
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} requested but "
                           "torch.cuda.is_available() is False")
    eig = model.eigen(params, dtype=dt, device=device)
    partials = torch.as_tensor(np.ascontiguousarray(ca.partials), dtype=dt,
                               device=device)            # (n, P, S)
    weights = torch.as_tensor(ca.weights, dtype=dt, device=device)
    n, n_pat, s = partials.shape
    ii, jj = np.triu_indices(n, k=1)
    chunk = _pair_chunk(len(ii), n_pat, s, dt, device)
    ts = []
    for c0 in range(0, len(ii), chunk):
        i = torch.as_tensor(ii[c0:c0 + chunk], device=device)
        j = torch.as_tensor(jj[c0:c0 + chunk], device=device)
        t, _ = newton_branch_length(eig, partials[i], partials[j], weights,
                                    t0=t0, max_t=max_t)
        ts.append(t.to("cpu", torch.float64))
    out = np.zeros((n, n))
    if ts:
        flat = torch.cat(ts).numpy()
        out[ii, jj] = flat
        out[jj, ii] = flat
    return out


# ---------------------------------------------------------------------------
# Parametric bootstrap
# ---------------------------------------------------------------------------

_SIMULABLE_KEYS = {"branch_lengths", "model", "alpha", "pinv"}


def simulation_setup(engine, params, what: str):
    """(full, tree_at_mle, n_sites, flat sim params, pinv) for
    simulate-at-the-fitted-model workflows (``parametric_bootstrap``).

    Only an engine that computes the base ``LikelihoodEngine``'s likelihood
    under the plain gamma (or no) rate mixture is taken, as in the JAX
    package. The check is on behaviour: the engine's parameters must be
    those ``simulate_alignment`` consumes (the model's, ``alpha``,
    ``pinv``: the mixture engines add classes, weights and profiles), its
    rates gamma rates (``rate_model="free"`` has FreeRate rates and
    weights), and its log-likelihood at ``params`` the base engine's on
    the same data (``AscertainmentEngine`` conditions on variable sites,
    which the simulator does not). Simulating such an engine under factory
    defaults would make the bootstrap null meaningless.
    """
    from phylo_utils_tpu_torch.likelihood import LikelihoodEngine

    def refuse():
        raise ValueError(
            f"{what} supports the base LikelihoodEngine only; "
            f"{type(engine).__name__} has its own parameterization that "
            "simulate_alignment cannot generate under (simulate with the "
            "matching simulator (simulate_mixture_alignment / "
            "simulate_branch_alignment) and drive the analysis manually)"
        )

    if (not isinstance(engine, LikelihoodEngine)
            or set(engine.default_params()) - _SIMULABLE_KEYS):
        refuse()
    if engine.rate_model != "gamma":
        raise ValueError(
            f"{what} supports the (equal-weight) gamma rate mixture "
            "only: simulate_alignment cannot generate under "
            f"rate_model={engine.rate_model!r} (FreeRate rates/weights)"
        )
    full = engine._full_params(params)
    with torch.no_grad():
        data = (full, engine._leaf_partials, engine._weights)
        cached = dict(eig=engine.model_eigen(full),
                      rates=engine.model_rates(full))
        own, _ = engine._loglik_fn(*data, **cached)
        base, _ = LikelihoodEngine._loglik_fn(engine, *data, **cached)
    if not torch.equal(own, base):
        refuse()
    tree_mle = engine.tree.with_lengths(
        full["branch_lengths"].detach().to("cpu", torch.float64).numpy())
    n_sites = int(round(float(engine._weights.sum())))
    sim_params = {k: v.detach() for k, v in full.get("model", {}).items()}
    if "alpha" in full:
        sim_params["alpha"] = full["alpha"].detach()
    pinv = float(full["pinv"]) if "pinv" in full else 0.0
    return full, tree_mle, n_sites, sim_params, pinv


def parametric_bootstrap(
    engine,
    params: Optional[Mapping] = None,
    n_replicates: int = 100,
    seed: int = 0,
    free: Optional[Tuple[str, ...]] = None,
    max_steps: int = 200,
    pruner: str = "torch",
    **fit_kwargs,
):
    """Parametric bootstrap of the ML estimates (seq-gen + refit).

    Simulates ``n_replicates`` alignments of the original length under the
    engine's model AT ``params`` (pass the MLE from ``fit``), refits each
    replicate from those values, and returns the sampling distribution of
    the estimates: the finite-sample complement to the asymptotic
    ``standard_errors``, and the standard way to expose estimator bias.

    Replicate ``i`` is simulated from a generator seeded ``seed + i`` on
    the engine's device (as the JAX package keys ``seed + i``), so any
    replicate's alignment can be rebuilt. The replicate engines take the
    engine's device and dtype and ``pruner`` ("torch", as the JAX
    package's "xla", or "cuda").

    Returns a dict with "replicates" (the params dict with each leaf a
    stacked (n_replicates, ...) float64 numpy array), "mean"/"se" (per
    leaf) and "loglik" per replicate. Base ``LikelihoodEngine`` only
    (``simulation_setup``).
    """
    from phylo_utils_tpu_torch.convert import params_to_numpy
    from phylo_utils_tpu_torch.simulate import simulate_alignment

    full, tree_mle, n_sites, sim_params, pinv = simulation_setup(
        engine, params, what="parametric_bootstrap"
    )
    reps, lls = [], []
    for i in range(n_replicates):
        aln = simulate_alignment(
            seed + i, tree_mle, engine.model, n_sites, params=sim_params,
            ncat=engine.ncat, pinv=pinv, median=engine.median,
            device=engine.device,
        )
        rep_engine = type(engine)(
            tree_mle, aln, engine.model, ncat=engine.ncat,
            invariant_sites=engine.invariant_sites, median=engine.median,
            dtype=engine.dtype, pruner=pruner, device=engine.device,
        )
        res = fit(rep_engine, params0=full, free=free, max_steps=max_steps,
                  **fit_kwargs)
        reps.append(flatten_params(params_to_numpy(res.params)))
        lls.append(res.loglik)

    names = reps[0][0]
    stacked = [np.stack([leaves[j] for _, leaves in reps])
               for j in range(len(names))]
    return {
        "replicates": unflatten_params(names, stacked),
        "mean": unflatten_params(names, [a.mean(axis=0) for a in stacked]),
        "se": unflatten_params(names, [a.std(axis=0, ddof=1)
                                       for a in stacked]),
        "loglik": np.asarray(lls),
    }
