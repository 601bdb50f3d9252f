"""GY94 (Goldman and Yang 1994) over the 61 sense codons of the standard
genetic code, in TCAG order (TTT, TTC, TTA, ...): exchangeability
kappa^[transition] omega^[nonsynonymous] between codons one nucleotide
apart, 0 between others. ``f3x4`` gives codeml's CodonFreq = 2
frequencies from per-position nucleotide frequencies."""
import itertools

import numpy as np
import torch

_BASES = "TCAG"
_CODE = ("FFLLSSSSYY**CC*W" "LLLLPPPPHHQQRRRR"
         "IIIMTTTTNNKKSSRR" "VVVVAAAADDEEGGGG")
_ALL = ["".join(c) for c in itertools.product(_BASES, repeat=3)]
CODONS = tuple(c for c, aa in zip(_ALL, _CODE) if aa != "*")
_AA = {c: aa for c, aa in zip(_ALL, _CODE) if aa != "*"}
N_STATES = len(CODONS)
SYMBOLS = CODONS
_TRANSITIONS = ({"A", "G"}, {"C", "T"})


def _masks():
    n = N_STATES
    single, ts, nonsyn = (np.zeros((n, n)) for _ in range(3))
    for i, a in enumerate(CODONS):
        for j, b in enumerate(CODONS):
            diffs = [(x, y) for x, y in zip(a, b) if x != y]
            if len(diffs) != 1:
                continue
            single[i, j] = 1.0
            ts[i, j] = float(set(diffs[0]) in _TRANSITIONS)
            nonsyn[i, j] = float(_AA[a] != _AA[b])
    return single, ts, nonsyn


_SINGLE, _TS, _NONSYN = _masks()


def build(kappa: torch.Tensor, omega: torch.Tensor, freqs: torch.Tensor):
    """(exchangeabilities (61, 61), frequencies (61,))."""
    single, ts, nonsyn = (torch.as_tensor(m, dtype=kappa.dtype,
                                          device=kappa.device)
                          for m in (_SINGLE, _TS, _NONSYN))
    return single * kappa ** ts * omega ** nonsyn, freqs


def f3x4(by_position) -> np.ndarray:
    """(61,) codon frequencies: the product of the three positions'
    nucleotide frequencies (each row A, C, G, T), renormalized over the
    sense codons."""
    f = np.asarray(by_position, dtype=np.float64)
    f = f / f.sum(axis=1, keepdims=True)
    idx = {"A": 0, "C": 1, "G": 2, "T": 3}
    out = np.array([f[0, idx[c[0]]] * f[1, idx[c[1]]] * f[2, idx[c[2]]]
                    for c in CODONS])
    return out / out.sum()
