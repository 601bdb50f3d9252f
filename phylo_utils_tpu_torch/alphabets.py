"""Alphabets and sequence -> partial-likelihood encoding.

Reference capability: ``phylo_utils`` ``seq_to_partials`` + DNA/protein
charmaps incl. IUPAC ambiguity codes (SURVEY.md §2, [HIGH capability]).
Gaps / unknowns map to an all-ones row (no information); ambiguity codes map
to multi-hot rows.

Host-side, pure numpy: encoding happens once per alignment before anything is
put on device. Copied unchanged from ``phylo_utils_tpu.alphabets`` (the
JAX package's optional C++ encoder is not ported yet).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

__all__ = [
    "empirical_frequencies",
    "Alphabet",
    "DNA",
    "PROTEIN",
    "BINARY",
    "seq_to_partials",
    "encode_alignment",
    "recode_alignment",
    "RECODING_SCHEMES",
]


@dataclasses.dataclass(frozen=True)
class Alphabet:
    """A state alphabet plus its character -> state-set map.

    ``charmap`` maps an (upper-case) character to a tuple of state indices the
    character is compatible with. Characters not present map to *all* states
    (treated as fully ambiguous, like a gap).
    """

    name: str
    states: str  # one char per state, index = state id
    charmap: Mapping[str, Tuple[int, ...]]

    @property
    def n_states(self) -> int:
        return len(self.states)

    def state_index(self, char: str) -> Tuple[int, ...]:
        return self.charmap.get(char.upper(), tuple(range(self.n_states)))

    def row(self, char: str, dtype=np.float64) -> np.ndarray:
        out = np.zeros(self.n_states, dtype=dtype)
        out[list(self.state_index(char))] = 1.0
        return out


def _dna_alphabet() -> Alphabet:
    # State order A, C, G, T. Purines {A,G} = {0,2}; pyrimidines {C,T} = {1,3}.
    base = {"A": (0,), "C": (1,), "G": (2,), "T": (3,), "U": (3,)}
    iupac = {
        "R": (0, 2),        # puRine A/G
        "Y": (1, 3),        # pYrimidine C/T
        "S": (1, 2),        # Strong C/G
        "W": (0, 3),        # Weak A/T
        "K": (2, 3),        # Keto G/T
        "M": (0, 1),        # aMino A/C
        "B": (1, 2, 3),     # not A
        "D": (0, 2, 3),     # not C
        "H": (0, 1, 3),     # not G
        "V": (0, 1, 2),     # not T
        "N": (0, 1, 2, 3),
        "X": (0, 1, 2, 3),
        "-": (0, 1, 2, 3),
        "?": (0, 1, 2, 3),
        ".": (0, 1, 2, 3),
    }
    return Alphabet("dna", "ACGT", {**base, **iupac})


def _protein_alphabet() -> Alphabet:
    # PAML/empirical-matrix state order, so LG/WAG data needs no permutation.
    states = "ARNDCQEGHILKMFPSTWYV"
    charmap: Dict[str, Tuple[int, ...]] = {c: (i,) for i, c in enumerate(states)}
    n = states.index("N")
    d = states.index("D")
    q = states.index("Q")
    e = states.index("E")
    i_, l_ = states.index("I"), states.index("L")
    charmap["B"] = (n, d)       # Asn or Asp
    charmap["Z"] = (q, e)       # Gln or Glu
    charmap["J"] = (i_, l_)     # Ile or Leu
    allstates = tuple(range(20))
    for c in ("X", "-", "?", ".", "*"):
        charmap[c] = allstates
    return Alphabet("protein", states, charmap)


def _binary_alphabet() -> Alphabet:
    charmap = {"0": (0,), "1": (1,), "-": (0, 1), "?": (0, 1)}
    return Alphabet("binary", "01", charmap)


DNA = _dna_alphabet()
PROTEIN = _protein_alphabet()
BINARY = _binary_alphabet()

_ALPHABETS = {"dna": DNA, "protein": PROTEIN, "binary": BINARY}


def get_alphabet(name_or_alphabet) -> Alphabet:
    if isinstance(name_or_alphabet, Alphabet):
        return name_or_alphabet
    try:
        return _ALPHABETS[str(name_or_alphabet).lower()]
    except KeyError:
        raise ValueError(
            f"unknown alphabet {name_or_alphabet!r}; "
            f"expected one of {sorted(_ALPHABETS)} or an Alphabet"
        ) from None


def _charmap_table(alphabet: Alphabet, dtype) -> np.ndarray:
    """(256, n_states) lookup table for vectorized encoding over raw bytes."""
    table = np.ones((256, alphabet.n_states), dtype=dtype)
    for ch, idxs in alphabet.charmap.items():
        row = np.zeros(alphabet.n_states, dtype=dtype)
        row[list(idxs)] = 1.0
        table[ord(ch)] = row
        table[ord(ch.lower())] = row
    return table


def seq_to_partials(seq: str, alphabet="dna", dtype=np.float64) -> np.ndarray:
    """Encode one sequence into a (sites, states) partial-likelihood array.

    Known characters -> one-hot rows; IUPAC ambiguity -> multi-hot; gaps and
    unknown characters -> all-ones.
    """
    alpha = get_alphabet(alphabet)
    table = _charmap_table(alpha, dtype)
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return table[raw]


def encode_alignment(
    sequences: Mapping[str, str] | Sequence[Tuple[str, str]],
    alphabet="dna",
    dtype=np.float64,
) -> Tuple[List[str], np.ndarray]:
    """Encode an alignment into (names, (n_taxa, sites, states)) leaf partials.

    All sequences must have equal length (it is an *alignment*).
    """
    if isinstance(sequences, Mapping):
        items = list(sequences.items())
    else:
        items = list(sequences)
    if not items:
        raise ValueError("empty alignment")
    names = [k for k, _ in items]
    lengths = {len(v) for _, v in items}
    if len(lengths) != 1:
        raise ValueError(f"sequences have unequal lengths: {sorted(lengths)}")
    arrs = [seq_to_partials(v, alphabet, dtype) for _, v in items]
    return names, np.stack(arrs)


def empirical_frequencies(
    sequences, alphabet="dna", pseudocount: float = 0.0
) -> np.ndarray:
    """Observed state frequencies across an alignment ("+F" estimation).

    Ambiguity codes contribute fractionally (their partial row normalized);
    fully-ambiguous characters (gaps, N/X) contribute nothing. Optional
    Laplace pseudocount guards zero frequencies for sparse data.
    """
    alpha = get_alphabet(alphabet)
    table = _charmap_table(alpha, np.float64)
    # fractional: each char's row normalized to sum 1; all-ones rows (fully
    # ambiguous) carry no information -> weight 0
    rowsum = table.sum(axis=1, keepdims=True)
    informative = (rowsum.squeeze(1) < alpha.n_states) & (rowsum.squeeze(1) > 0)
    frac = np.where(
        informative[:, None], table / np.maximum(rowsum, 1.0), 0.0
    )
    counts = np.full(alpha.n_states, float(pseudocount))
    for seq in sequences.values():
        arr = np.frombuffer(seq.upper().encode("ascii"), dtype=np.uint8)
        counts += frac[arr].sum(axis=0)
    total = counts.sum()
    if total == 0:
        raise ValueError("no informative characters in alignment")
    return counts / total


# Character-recoding schemes for saturation/compositional-bias analyses.
# Each scheme: (source alphabet, ordered state groups). Recoded characters
# are the morphological digits '0','1',..., so the result pairs with
# models.morphology.mk_model(len(groups)); characters whose ambiguity set
# spans more than one group become '?'.
RECODING_SCHEMES = {
    # purine/pyrimidine: removes transition saturation and GC-content bias
    "ry": ("dna", ("AG", "CT")),
    # Dayhoff 6-class amino-acid groups (Hrdy et al. / Embley-lab usage)
    "dayhoff6": (
        "protein", ("AGPST", "C", "DENQ", "FWY", "HKR", "ILMV")
    ),
    # Susko-Roger (2007) 6-class recoding
    "sr6": ("protein", ("APST", "DENG", "QKR", "MIVL", "WC", "FYH")),
    # Kosiol-Goldman-Buttimore (2004) 6-class recoding
    "kgb6": ("protein", ("AGPS", "DENQHKRT", "MIL", "W", "FY", "CV")),
}


def recode_alignment(
    alignment: Mapping[str, str], scheme: str = "ry"
) -> Dict[str, str]:
    """Recode an alignment into grouped states ('0','1',...).

    ``scheme``: one of ``RECODING_SCHEMES`` (case-insensitive). The
    output uses morphological digit characters, so analyze it with
    ``mk_model(n_groups)`` (e.g. RY-coded DNA under ``MK2``). A character
    maps to a group only if its ENTIRE ambiguity set lies inside that
    group (e.g. IUPAC ``R`` = A/G maps to the purine group under "ry",
    but ``S`` = C/G becomes '?'); gaps and unknowns stay fully ambiguous
    as '?'.
    """
    try:
        src_name, groups = RECODING_SCHEMES[scheme.lower()]
    except KeyError:
        raise ValueError(
            f"unknown recoding scheme {scheme!r}; "
            f"expected one of {sorted(RECODING_SCHEMES)}"
        ) from None
    src = get_alphabet(src_name)
    state_to_group = {}
    for g, members in enumerate(groups):
        for c in members:
            state_to_group[src.states.index(c)] = g
    digits = "0123456789"
    charmap = {}
    for ch, states in src.charmap.items():
        gs = {state_to_group[s] for s in states}
        charmap[ch] = digits[next(iter(gs))] if len(gs) == 1 else "?"
    out = {}
    for name, seq in alignment.items():
        out[name] = "".join(charmap.get(c, "?") for c in seq.upper())
    return out
