"""Empirical protein models LG and WAG (20 states, PAML order), PyTorch
port of ``phylo_utils_tpu.models.protein``.

The exchangeabilities are fixed constants; ``freqs`` is the one parameter,
the one that "+F" sets to the observed frequencies.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from phylo_utils_tpu_torch.data import LG_FREQS, LG_RATES, WAG_FREQS, WAG_RATES
from phylo_utils_tpu_torch.models.base import Model

__all__ = ["LG", "WAG", "empirical_model_from_dat"]


def _fixed_rates_build(rates: np.ndarray):
    """``build`` function of a model with fixed exchangeabilities ``rates``
    (20, 20)."""

    def build(freqs):
        return (torch.as_tensor(rates, dtype=freqs.dtype, device=freqs.device),
                freqs)

    return build


LG = Model("LG", 20, "protein", {"freqs": tuple(LG_FREQS.tolist())},
           _fixed_rates_build(LG_RATES))
WAG = Model("WAG", 20, "protein", {"freqs": tuple(WAG_FREQS.tolist())},
            _fixed_rates_build(WAG_RATES))


def empirical_model_from_dat(source: str, name: Optional[str] = None) -> Model:
    """Build an empirical 20-state model from a PAML-format ``.dat`` file.

    ``source`` is a file path or the file's literal text. PAML layout: the
    190 lower-triangle exchangeabilities ``S[i][j]`` (19 rows, row ``i``
    holding ``i`` entries), then the 20 equilibrium frequencies, both in
    PAML state order A R N D C Q E G H I L K M F P S T W Y V (the protein
    alphabet's order). Everything after the 210th number is ignored;
    non-numeric tokens among the numbers are skipped.
    """
    text = source
    if os.path.exists(source):
        if name is None:
            name = os.path.splitext(os.path.basename(source))[0]
        with open(source) as f:
            text = f.read()
    elif not text.strip() or (len(text.splitlines()) == 1
                              and text.strip().lower().endswith(".dat")):
        raise FileNotFoundError(f"no such .dat file: {source!r}")
    need = 20 * 19 // 2 + 20
    vals = []
    for tok in text.split():
        try:
            vals.append(float(tok))
        except ValueError:
            continue
        if len(vals) == need:
            break
    if len(vals) < need:
        raise ValueError(
            f"PAML .dat parse: found {len(vals)} numbers, need {need} "
            "(190 lower-triangle exchangeabilities + 20 frequencies)"
        )
    tri = np.asarray(vals[:190], dtype=np.float64)
    freqs = np.asarray(vals[190:need], dtype=np.float64)
    if np.any(tri < 0.0):
        raise ValueError("PAML .dat parse: negative exchangeability")
    if np.any(freqs <= 0.0):
        raise ValueError("PAML .dat parse: non-positive frequency")
    rates = np.zeros((20, 20), dtype=np.float64)
    k = 0
    for i in range(1, 20):
        rates[i, :i] = tri[k:k + i]
        rates[:i, i] = tri[k:k + i]
        k += i
    freqs = freqs / freqs.sum()
    return Model(name or "custom_dat", 20, "protein",
                 {"freqs": tuple(freqs.tolist())}, _fixed_rates_build(rates))
