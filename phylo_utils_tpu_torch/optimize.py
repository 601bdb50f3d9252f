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

Newton branch lengths, the 1-D minimizers, ML distances, Fisher standard
errors, multistart fits and the parametric bootstrap are not ported yet
(ROADMAP A10).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from phylo_utils_tpu_torch.convert import flatten_params, unflatten_params

__all__ = [
    "transform_params",
    "untransform_params",
    "fit",
    "FitResult",
    "default_optimizer",
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

    def params_of(tensors) -> Dict:
        return _merge_params(frozen, untransform_params(
            unflatten_params(names, tensors)))

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
