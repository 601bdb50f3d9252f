"""Parameter dictionaries between the JAX package, JSON and the port.

The engine's parameters (``branch_lengths``, ``model{...}``, ``alpha``,
``pinv``, ...; the mixture engines' nested ``mixture{...}`` of per-class
stacks, ``cat_weights`` and ``class_rates``; the codon site models' nested
``shared{kappa, freqs}`` beside ``proportions``, ``omega0``,
``omega2_delta``, ``beta_p``, ``beta_q``, ``p0`` and ``omega_delta``) are
the system's weights.
``params_from_jax`` takes the JAX engine's dict as numpy arrays
(``np.asarray`` of each leaf of ``engine._full_params(...)``, or anything
``np.asarray`` accepts: lists, tuples of per-class rows) at any nesting and
returns the port's dict of tensors; ``params_to_numpy`` goes the other way,
for JSON.
Neither imports JAX. ``flatten_params``/``unflatten_params`` turn a nested
dict into the flat tensor list that autograd and optimizers take, and back
(with ``empty_paths``, the empty dicts a parameter-free model leaves, at
any depth: a partitioned engine's JC69 locus).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

__all__ = [
    "params_from_jax",
    "params_to_numpy",
    "flatten_params",
    "unflatten_params",
    "empty_paths",
]


def params_from_jax(full_params: Mapping, device="cpu",
                    dtype=torch.float64) -> dict:
    """Nested dict of arrays -> the same nesting of tensors on ``device``."""
    out = {}
    for k, v in full_params.items():
        if isinstance(v, Mapping):
            out[k] = params_from_jax(v, device=device, dtype=dtype)
        else:
            out[k] = torch.tensor(np.array(v, np.float64), dtype=dtype,
                                  device=device)
    return out


def params_to_numpy(params: Mapping) -> dict:
    """Nested dict of tensors -> the same nesting of float64 numpy arrays."""
    out = {}
    for k, v in params.items():
        if isinstance(v, Mapping):
            out[k] = params_to_numpy(v)
        elif isinstance(v, torch.Tensor):
            out[k] = v.detach().to("cpu", torch.float64).numpy()
        else:
            out[k] = np.asarray(v, np.float64)
    return out


def flatten_params(tree: Mapping, prefix: Tuple[str, ...] = ()
                   ) -> Tuple[List[Tuple[str, ...]], List]:
    """Nested dict -> (key paths, leaves), depth first in insertion order."""
    paths, leaves = [], []
    for k, v in tree.items():
        if isinstance(v, Mapping):
            sub_paths, sub_leaves = flatten_params(v, prefix + (k,))
            paths += sub_paths
            leaves += sub_leaves
        else:
            paths.append(prefix + (k,))
            leaves.append(v)
    return paths, leaves


def empty_paths(tree: Mapping, prefix: Tuple[str, ...] = ()
                ) -> List[Tuple[str, ...]]:
    """Key paths of the empty dicts in ``tree`` at any depth (a
    parameter-free model's ``model``): ``flatten_params`` has no leaf to
    carry them."""
    out = []
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out += empty_paths(v, prefix + (k,)) if v else [prefix + (k,)]
    return out


def unflatten_params(paths, leaves, empty=()) -> Dict:
    """Inverse of ``flatten_params``; ``empty``: key paths of empty dicts
    to put back (``empty_paths``)."""
    out: Dict = {}
    for path in empty:
        node = out
        for k in path:
            node = node.setdefault(k, {})
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out
