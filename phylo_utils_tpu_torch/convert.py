"""Parameter dictionaries between the JAX package, JSON and the port.

The engine's parameters (``branch_lengths``, ``model{...}``, ``alpha``,
``pinv``, ...) are the system's weights. ``params_from_jax`` takes the JAX
engine's dict as numpy arrays (``np.asarray`` of each leaf of
``engine._full_params(...)``, or anything ``np.asarray`` accepts) and returns
the port's dict of tensors; ``params_to_numpy`` goes the other way, for JSON.
Neither imports JAX.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_numpy"]


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
