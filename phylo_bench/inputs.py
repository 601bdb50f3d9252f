"""A cell's inputs from ``--seed``, made by the benchmark's own plain
PyTorch: a tree (the configuration's topology and base branch lengths,
fixed by its ``topology_seed``), the parameters (the configuration's
values, some derived by the reference model's functions), and an
alignment simulated down the tree under them on the device from the seed.
The same seed gives the same inputs."""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from reference import RefTree, random_topology, rate_matrix
from reference.gamma import gamma_rates_np


@dataclasses.dataclass
class Inputs:
    tree: RefTree
    lengths: np.ndarray          # (N,) float32, the root's entry 0
    params: Dict                 # {"model": {...}, "alpha"?, "pinv"?}
    kinds: Dict                  # the same keys: how a call jitters each
    states: torch.Tensor         # (n_leaves, sites) int64 on the device
    pats: torch.Tensor           # (n_leaves, P) int64, distinct columns
    weights: torch.Tensor        # (P,) float64 column counts
    inverse: torch.Tensor        # (sites,) int64, pattern of each site

    @property
    def n_patterns(self) -> int:
        return int(self.pats.shape[1])


def resolve_params(spec: Dict, model) -> tuple:
    """({name: float32 value}, {name: jitter kind}) of a configuration's
    ``params``: a leaf is ``{"value": v, "jitter": kind}`` or ``{f: arg,
    "jitter": kind}``, whose value is ``model.f(arg)``."""
    values, kinds = {}, {}
    for key, leaf in spec.items():
        if "jitter" not in leaf:
            values[key], kinds[key] = resolve_params(leaf, model)
            continue
        kinds[key] = leaf["jitter"]
        if "value" in leaf:
            v = leaf["value"]
        else:
            (fn, arg), = [(k, a) for k, a in leaf.items() if k != "jitter"]
            v = getattr(model, fn)(arg)
        values[key] = np.asarray(v, dtype=np.float32)
    return values, kinds


def _simulate(tree: RefTree, lengths: np.ndarray, params: Dict, model,
              ncat: int, sites: int, gen: torch.Generator,
              device) -> torch.Tensor:
    """(n_leaves, sites) states evolved from the root down the tree: each
    site draws a gamma category (or, with ``pinv``, the invariant class of
    rate 0), the root state from the frequencies, each child's state from
    its parent's row of P(t r)."""
    f64 = dict(dtype=torch.float64, device=device)
    mp = {k: torch.as_tensor(v, **f64) for k, v in params["model"].items()}
    sym, freqs = model.build(**mp)
    q = rate_matrix(sym, freqs)
    rates = gamma_rates_np(float(params["alpha"]), ncat) if ncat > 1 \
        else np.ones(1)
    weights = np.full(ncat, 1.0 / ncat)
    if "pinv" in params:
        pinv = float(params["pinv"])
        rates = np.append(rates, 0.0)
        weights = np.append(weights * (1.0 - pinv), pinv)
    t = torch.as_tensor(lengths, **f64)[:, None] * torch.as_tensor(rates,
                                                                   **f64)
    p = torch.linalg.matrix_exp(q * t[..., None, None])   # (N, K', S, S)
    cat = torch.multinomial(torch.as_tensor(weights, **f64), sites,
                            replacement=True, generator=gen)
    states = torch.empty((tree.n_nodes, sites), dtype=torch.int64,
                         device=device)
    states[tree.root] = torch.multinomial(freqs, sites, replacement=True,
                                          generator=gen)
    s = q.shape[0]
    for parent, child in tree.preorder_edges():
        cum = torch.cumsum(p[child, cat, states[parent]], dim=1)
        u = torch.rand((sites, 1), generator=gen, **f64) * cum[:, -1:]
        states[child] = (u > cum).sum(dim=1).clamp_max(s - 1)
    return states[:tree.n_leaves]


def make_inputs(config: Dict, model, seed: int, device) -> Inputs:
    """The inputs of a run with ``seed``: the tree is the configuration's
    (topology and branch lengths, exponential with mean
    ``mean_branch_length``, from ``topology_seed``), so that every seed
    gives the same amount of work; the alignment is the seed's."""
    tree = random_topology(config["taxa"], config["topology_seed"])
    rng = np.random.default_rng([config["topology_seed"], 0])
    lengths = rng.exponential(config["mean_branch_length"],
                              tree.n_nodes).astype(np.float32)
    lengths[tree.root] = 0.0
    params, kinds = resolve_params(config["params"], model)
    gen = torch.Generator(device=device).manual_seed(seed)
    states = _simulate(tree, lengths, params, model, config["ncat"],
                       config["sites"], gen, device)
    pats, inverse, counts = torch.unique(states, dim=1, return_inverse=True,
                                         return_counts=True)
    return Inputs(tree=tree, lengths=lengths, params=params, kinds=kinds,
                  states=states, pats=pats,
                  weights=counts.to(torch.float64), inverse=inverse)

