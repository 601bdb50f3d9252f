"""Decides ``correct``: what the timed calls returned against the plain
reference, on calls drawn from the seed after the window has closed.

Numbers compared, each against the cell's limit (``limits/<cell>.json``):

- ``logl_rel``: the largest |total - reference| / |reference| over the
  drawn calls' sets;
- ``grad_rel`` (gradient cells): over the drawn calls and every entry of
  the gradient (branch lengths a set, each model parameter, alpha,
  pinv), the largest max |g - reference| / max |reference| of an entry.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from drive import Call
from inputs import Inputs
from reference import loglik_and_grad

# bytes of saved tensors a block of the reference's patterns may hold
REFERENCE_BUDGET = 16e9


def draw_calls(outputs: List, n: int, seed: int) -> List[int]:
    """Up to ``n`` of the calls that returned, drawn from ``seed``."""
    done = [i for i, out in enumerate(outputs) if out is not None]
    rng = np.random.default_rng([seed, 2])
    return sorted(rng.choice(done, size=min(n, len(done)),
                             replace=False).tolist())


def reference_outputs(inputs: Inputs, config: Dict, model, call: Call,
                      want_grad: bool, precision: str = "f64"
                      ) -> Dict[str, np.ndarray]:
    """The reference's totals (and gradient) for ``call``, keyed as the
    program's outputs."""
    dev = inputs.pats.device
    f64 = dict(dtype=torch.float64, device=dev)
    params = {"branch_lengths": torch.as_tensor(call.sets, **f64),
              "model": {k: torch.as_tensor(v, **f64)
                        for k, v in call.params["model"].items()}}
    params.update({k: torch.as_tensor(v, **f64)
                   for k, v in call.params.items() if k != "model"})
    totals, grads = loglik_and_grad(
        inputs.tree, inputs.pats, inputs.weights.to(dev), model.build,
        params, config["ncat"], want_grad, precision=precision,
        budget_bytes=REFERENCE_BUDGET)
    out = {"total": totals.cpu().numpy()}
    if grads is not None:
        out["branch_lengths"] = grads["branch_lengths"].cpu().numpy()
        out.update({f"model.{k}": v.detach().cpu().numpy()
                    for k, v in grads["model"].items()})
        out.update({k: grads[k].detach().cpu().numpy()
                    for k in ("alpha", "pinv") if k in grads})
    return out


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    scale = max(float(np.abs(want).max()), 1e-300)
    return float(np.abs(got - want).max()) / scale


def errors(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]
           ) -> Dict[str, float]:
    """{"logl_rel": ..., and for a gradient one entry a parameter}."""
    tot = np.abs(got["total"] - want["total"]) / np.abs(want["total"])
    out = {"logl_rel": float(tot.max())}
    for key, ref in want.items():
        if key == "total":
            continue
        if key not in got or np.shape(got[key]) != np.shape(ref):
            out[key] = float("inf")
        elif key == "branch_lengths":
            out[key] = max(_rel(g, r) for g, r in zip(got[key], ref))
        else:
            out[key] = _rel(got[key], ref)
    return out


def numbers(per_call: List[Dict[str, float]], grad: bool
            ) -> Dict[str, float]:
    """The numbers compared, over the drawn calls' ``errors``; none is
    read where no call returned, which fails every limit."""
    worst = entry_errors(per_call)
    out = {"logl_rel": worst.get("logl_rel", float("inf"))}
    if grad:
        out["grad_rel"] = max((v for k, v in worst.items()
                               if k != "logl_rel"), default=float("inf"))
    return out


def entry_errors(per_call: List[Dict[str, float]]) -> Dict[str, float]:
    """The worst reading of each gradient entry, for the run's log."""
    if not per_call:
        return {}
    return {k: max(e[k] for e in per_call) for k in per_call[0]}
