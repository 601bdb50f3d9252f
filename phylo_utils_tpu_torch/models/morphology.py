"""Morphological substitution models (Lewis 2001 Mk family): PyTorch port
of ``phylo_utils_tpu.models.morphology``.

The reference library has no morphological support at all (SURVEY.md §2
— its alphabets are DNA and protein only); this module is a capability
extension matching what IQ-TREE/RAxML/MrBayes users expect for discrete
character matrices:

- ``mk_model(k)`` — the Mk model: k states, all exchange rates equal,
  uniform stationary frequencies (JC69 generalized to k states).
- ``mk_model(k, ordered=True)`` — the ordered variant: only i <-> i+1
  transitions are allowed (additive/Wagner characters).

States are coded ``0-9`` then ``A-V`` (the usual convention, up to 32
states); ``-`` and ``?`` are fully ambiguous. Combine with
:class:`phylo_utils_tpu_torch.ascertainment.AscertainmentEngine` for the Mkv
variable-sites-only correction.
"""
from __future__ import annotations

import functools

import torch

from phylo_utils_tpu_torch.alphabets import Alphabet
from phylo_utils_tpu_torch.models.base import Model

__all__ = ["mk_model", "multistate_alphabet", "MAX_MORPH_STATES"]

_STATE_CHARS = "0123456789ABCDEFGHIJKLMNOPQRSTUV"
MAX_MORPH_STATES = len(_STATE_CHARS)


@functools.lru_cache(maxsize=None)
def multistate_alphabet(k: int) -> Alphabet:
    """k-state morphological alphabet, states '0'..'9','A'..; -/? ambiguous."""
    if not 2 <= k <= MAX_MORPH_STATES:
        raise ValueError(
            f"morphological alphabets support 2..{MAX_MORPH_STATES} states, "
            f"got {k}"
        )
    states = _STATE_CHARS[:k]
    charmap = {c: (i,) for i, c in enumerate(states)}
    allstates = tuple(range(k))
    for c in ("-", "?", "."):
        charmap[c] = allstates
    return Alphabet(f"morph{k}", states, charmap)


def _mk_build(k: int):
    def build():
        s = torch.ones((k, k), dtype=torch.float64)
        return s, torch.full((k,), 1.0 / k, dtype=torch.float64)

    return build


def _mk_ordered_build(k: int):
    def build():
        off = torch.ones((k - 1,), dtype=torch.float64)
        s = torch.diag(off, 1) + torch.diag(off, -1)
        return s, torch.full((k,), 1.0 / k, dtype=torch.float64)

    return build


@functools.lru_cache(maxsize=None)
def mk_model(k: int, ordered: bool = False) -> Model:
    """Lewis (2001) Mk model with ``k`` states (ordered: additive variant).

    Parameter-free (like JC69): uniform frequencies, equal rates, Q
    normalized to mean rate 1 so branch lengths are expected
    changes/character.
    """
    alpha = multistate_alphabet(k)
    return Model(
        name=(f"ORDERED{k}" if ordered else f"MK{k}"),
        n_states=k,
        alphabet=alpha,
        param_defaults={},
        build=_mk_ordered_build(k) if ordered else _mk_build(k),
    )
