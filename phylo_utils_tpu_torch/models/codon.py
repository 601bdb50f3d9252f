"""Codon substitution models (61 sense codons, standard genetic code):
PyTorch port of ``phylo_utils_tpu.models.codon``.

Beyond the reference (which stops at DNA + empirical protein models): the
Goldman-Yang-style GY94 model with transition/transversion ratio kappa and
nonsynonymous/synonymous ratio omega (dN/dS) — the workhorse of selection
analysis. Reversible: q_ij = pi_j * h_ij with symmetric
h_ij = kappa^[ts] * omega^[nonsyn] for codon pairs differing at exactly one
position, so the engine's eigh-expm path and Daleckii-Krein gradients apply
unchanged; on the card 61 (or 60) states pad to the kernels' compiled
width of 64 (``ops.cuda_pruning.padded_states``). The code tables are
copied here, as numpy, so the port imports nothing of the JAX package.
"""
from __future__ import annotations

import functools
import itertools
from typing import Dict, List, Tuple

import numpy as np
import torch

from phylo_utils_tpu_torch.models.base import Model, build_rate_matrix

__all__ = [
    "CODONS",
    "CODON_TO_AA",
    "GENETIC_CODES",
    "GY94",
    "MG94",
    "code_tables",
    "codon_index",
    "dn_ds_by_branch",
    "empirical_codon_frequencies",
    "f3x4_frequencies",
    "make_gy94",
    "make_mg94",
]

_BASES = "TCAG"
# Standard genetic code over TCAG-major codon order (TTT, TTC, TTA, ...).
_CODE = (
    "FFLLSSSSYY**CC*W"
    "LLLLPPPPHHQQRRRR"
    "IIIMTTTTNNKKSSRR"
    "VVVVAAAADDEEGGGG"
)


def _mito_code() -> str:
    """NCBI transl_table=2 (vertebrate mitochondrial): AGA/AGG -> stop,
    ATA -> M, TGA -> W relative to the standard code."""
    rank = {b: i for i, b in enumerate(_BASES)}

    def idx(codon):
        return 16 * rank[codon[0]] + 4 * rank[codon[1]] + rank[codon[2]]

    c = list(_CODE)
    c[idx("AGA")] = "*"
    c[idx("AGG")] = "*"
    c[idx("ATA")] = "M"
    c[idx("TGA")] = "W"
    return "".join(c)


GENETIC_CODES: Dict[str, str] = {
    "standard": _CODE,
    "vertebrate_mito": _mito_code(),
}

_ALL = ["".join(c) for c in itertools.product(_BASES, repeat=3)]
_TRANSITIONS = {("A", "G"), ("G", "A"), ("C", "T"), ("T", "C")}


def _code_string(code: str) -> str:
    try:
        return GENETIC_CODES[code]
    except KeyError:
        raise ValueError(
            f"unknown genetic code {code!r}; "
            f"available: {sorted(GENETIC_CODES)}"
        ) from None


@functools.lru_cache(maxsize=None)
def code_tables(code: str = "standard"):
    """Per-genetic-code constants: (codons, codon_to_aa, index dict)."""
    cs = _code_string(code)
    codons = tuple(c for c, aa in zip(_ALL, cs) if aa != "*")
    to_aa = {c: aa for c, aa in zip(_ALL, cs) if aa != "*"}
    return codons, to_aa, {c: i for i, c in enumerate(codons)}


CODONS, CODON_TO_AA, _INDEX = code_tables("standard")


def codon_index(codon: str, code: str = "standard") -> int:
    """Index of a sense codon in the model's state order (raises on stops)."""
    return code_tables(code)[2][codon.upper().replace("U", "T")]


@functools.lru_cache(maxsize=None)
def _build_structure(code: str = "standard"):
    """(single, ts, nonsyn) masks over the code's sense codons; entries are
    only meaningful where codons differ at exactly one position (else all 0
    and the pair's rate is 0)."""
    codons, to_aa, _ = code_tables(code)
    n = len(codons)
    single = np.zeros((n, n), dtype=np.float64)
    ts = np.zeros((n, n), dtype=np.float64)
    nonsyn = np.zeros((n, n), dtype=np.float64)
    for i, ci in enumerate(codons):
        for j, cj in enumerate(codons):
            if i == j:
                continue
            diffs = [(a, b) for a, b in zip(ci, cj) if a != b]
            if len(diffs) != 1:
                continue
            single[i, j] = 1.0
            if diffs[0] in _TRANSITIONS:
                ts[i, j] = 1.0
            if to_aa[ci] != to_aa[cj]:
                nonsyn[i, j] = 1.0
    return single, ts, nonsyn


_SINGLE, _TS, _NONSYN = _build_structure("standard")


def f3x4_frequencies(nuc_freqs_by_position, code: str = "standard"
                     ) -> np.ndarray:
    """F3x4 codon frequencies from per-position nucleotide frequencies.

    ``nuc_freqs_by_position``: (3, 4) array in A,C,G,T order per position.
    Stop codons (of the chosen genetic ``code``) are excluded and the
    result renormalized.
    """
    f = np.asarray(nuc_freqs_by_position, dtype=np.float64)
    if f.shape != (3, 4):
        raise ValueError("expected (3, 4) per-position A,C,G,T frequencies")
    codons = code_tables(code)[0]
    order = {"A": 0, "C": 1, "G": 2, "T": 3}
    out = np.array([
        f[0][order[c[0]]] * f[1][order[c[1]]] * f[2][order[c[2]]]
        for c in codons
    ])
    return out / out.sum()


def empirical_codon_frequencies(
    sequences: Dict[str, str], method: str = "f3x4", code: str = "standard"
) -> np.ndarray:
    """Observed codon frequencies from an in-frame nucleotide alignment.

    codeml's ``CodonFreq`` estimators: ``f1x4`` (one shared nucleotide
    distribution), ``f3x4`` (per-codon-position nucleotide distributions,
    codeml's default), or ``f61`` (observed codon proportions, stops
    excluded). Gaps and ambiguity codes are ignored in the counts; ``f61``
    adds a pseudocount so unobserved sense codons keep nonzero frequency
    (a zero equilibrium frequency would make Q reducible). Returns a
    (61,) simplex in the model's codon order — pass as
    ``{"freqs": ...}`` / ``{"shared": {"freqs": ...}}``.
    """
    seqs = list(sequences.values())
    if not seqs:
        raise ValueError("empty alignment")
    chars = np.concatenate([
        np.frombuffer(
            s.upper().replace("U", "T").encode("ascii"), dtype=np.uint8
        )
        for s in seqs
    ])
    if chars.size % 3:
        raise ValueError("sequence lengths must be divisible by 3")
    # nucleotide lookup: A,C,G,T -> 0..3, everything else -> 4 (ignored)
    lut = np.full(256, 4, np.int8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
    nuc = lut[chars].reshape(-1, 3)                   # (total_codons, 3)
    if method == "f1x4":
        counts = np.bincount(nuc[nuc < 4], minlength=4).astype(np.float64)
        if counts.sum() == 0:
            raise ValueError("no unambiguous nucleotides in alignment")
        by_pos = np.tile(counts / counts.sum(), (3, 1))
        return f3x4_frequencies(by_pos, code)
    if method == "f3x4":
        by_pos = np.zeros((3, 4))
        for p in range(3):
            col = nuc[:, p]
            by_pos[p] = np.bincount(col[col < 4], minlength=4)
            if by_pos[p].sum() == 0:
                raise ValueError(
                    f"no unambiguous nucleotides at codon position {p + 1}"
                )
            by_pos[p] /= by_pos[p].sum()
        return f3x4_frequencies(by_pos, code)
    if method == "f61":
        valid = (nuc < 4).all(axis=1)
        # base-4 codon key over TCAG order to match CODONS indexing
        tcag = np.array([2, 1, 3, 0])  # A,C,G,T code -> TCAG rank
        key = (
            tcag[nuc[valid, 0]] * 16
            + tcag[nuc[valid, 1]] * 4
            + tcag[nuc[valid, 2]]
        )
        all64 = np.bincount(key, minlength=64).astype(np.float64)
        sense = np.array([_ALL.index(c) for c in code_tables(code)[0]])
        counts = all64[sense] + 0.5   # pseudocount: keep Q irreducible
        return counts / counts.sum()
    raise ValueError(f"unknown method {method!r}; use f1x4|f3x4|f61")


def _make_gy94_build(code: str):
    single_np, ts_np, nonsyn_np = _build_structure(code)

    def _gy94_build(kappa, omega, freqs):
        dtype, device = kappa.dtype, kappa.device
        single = torch.as_tensor(single_np, dtype=dtype, device=device)
        ts = torch.as_tensor(ts_np, dtype=dtype, device=device)
        nonsyn = torch.as_tensor(nonsyn_np, dtype=dtype, device=device)
        sym = single * torch.pow(kappa, ts) * torch.pow(omega, nonsyn)
        return sym, freqs.to(dtype)

    return _gy94_build


@functools.lru_cache(maxsize=None)
def make_gy94(code: str = "standard") -> Model:
    """GY94 over an alternative genetic code (see ``GENETIC_CODES``)."""
    codons = code_tables(code)[0]
    n = len(codons)
    return Model(
        f"GY94[{code}]" if code != "standard" else "GY94",
        n,
        "codon" if code == "standard" else f"codon:{code}",
        {
            "kappa": 2.0,
            "omega": 1.0,
            "freqs": tuple(np.full(n, 1.0 / n).tolist()),
        },
        _make_gy94_build(code),
    )


@functools.lru_cache(maxsize=None)
def _build_target_structure(code: str = "standard"):
    """(3, n, n) one-hot: slot [p, i, j] = 1 iff codons i,j differ only
    at position p; and (3, n, n) int index of j's nucleotide at that
    position (A,C,G,T order), 0 where not a single-diff pair. Plus the
    per-codon position-nucleotide index (3, n)."""
    codons = code_tables(code)[0]
    n = len(codons)
    order = {"A": 0, "C": 1, "G": 2, "T": 3}
    pos_mask = np.zeros((3, n, n))
    tgt = np.zeros((3, n, n), np.int32)
    for i, ci in enumerate(codons):
        for j, cj in enumerate(codons):
            if i == j:
                continue
            diffs = [p for p in range(3) if ci[p] != cj[p]]
            if len(diffs) != 1:
                continue
            p = diffs[0]
            pos_mask[p, i, j] = 1.0
            tgt[p, i, j] = order[cj[p]]
    codon_nuc = np.array(
        [[order[c[p]] for c in codons] for p in range(3)], np.int32
    )
    return pos_mask, tgt, codon_nuc


_POS_MASK, _TGT, _CODON_NUC = _build_target_structure("standard")


def _make_mg94_build(code: str):
    pos_mask, tgt, codon_nuc = _build_target_structure(code)
    single_np, ts_np, nonsyn_np = _build_structure(code)

    def _mg94_build(kappa, omega, nuc_freqs):
        """Muse-Gaut (1994) x HKY-style codon model, F3x4 parameterized.

        q_ij (single-nucleotide change at position p, to nucleotide b) =
        kappa^[ts] * omega^[nonsyn] * pi_b^(p); stationary distribution
        is the F3x4 product over sense codons (detailed balance holds:
        the product frequencies differ exactly by the changed position's
        nucleotide ratio). Exposed as (sym, freqs) for the engine's
        symmetrized-eigh path; sym is symmetrized explicitly to kill
        float rounding asymmetry.
        """
        dtype, device = kappa.dtype, kappa.device
        f = nuc_freqs.to(dtype)                     # (3, 4)
        f = f / torch.sum(f, dim=1, keepdim=True)
        pos = torch.as_tensor(codon_nuc, dtype=torch.long, device=device)
        prod = f[0, pos[0]] * f[1, pos[1]] * f[2, pos[2]]
        freqs = prod / torch.sum(prod)
        tgt_freq = sum(
            torch.as_tensor(pos_mask[p], dtype=dtype, device=device)
            * f[p, torch.as_tensor(tgt[p], dtype=torch.long, device=device)]
            for p in range(3)
        )                                           # (n, n)
        single = torch.as_tensor(single_np, dtype=dtype, device=device)
        ts = torch.as_tensor(ts_np, dtype=dtype, device=device)
        nonsyn = torch.as_tensor(nonsyn_np, dtype=dtype, device=device)
        q_off = (single * torch.pow(kappa, ts) * torch.pow(omega, nonsyn)
                 * tgt_freq)
        sym = q_off / torch.clamp(freqs[None, :], min=1e-30)
        sym = 0.5 * (sym + sym.T)                   # exact symmetry
        return sym, freqs

    return _mg94_build


@functools.lru_cache(maxsize=None)
def make_mg94(code: str = "standard") -> Model:
    """MG94 over an alternative genetic code (see ``GENETIC_CODES``)."""
    codons = code_tables(code)[0]
    return Model(
        f"MG94[{code}]" if code != "standard" else "MG94",
        len(codons),
        "codon" if code == "standard" else f"codon:{code}",
        {
            "kappa": 2.0,
            "omega": 1.0,
            "nuc_freqs": tuple(
                tuple(np.full(4, 0.25).tolist()) for _ in range(3)
            ),
        },
        _make_mg94_build(code),
    )


MG94 = make_mg94("standard")


GY94 = make_gy94("standard")


def dn_ds_by_branch(model: Model, params=None, branch_lengths=None,
                    code: str = None):
    """codeml-style dN/dS decomposition of branch lengths.

    Given a GY94/MG94-family model at ``params`` and branch lengths in
    expected substitutions per CODON, computes the standard Goldman–Yang
    accounting: S and N mutational-opportunity site counts (from the
    omega = 1 model, scaled so S + N = 3 per codon), the expected
    synonymous/nonsynonymous substitution counts per branch, and
    dS = syn/(S/3 · t-units), dN = nonsyn/(N/3 · t-units) — the numbers
    codeml prints per branch. By construction dN/dS == omega for these
    models (asserted-by-test invariant).

    Returns a dict of numpy arrays: {"t", "dN", "dS", "S", "N",
    "omega"}; with ``branch_lengths=None`` the per-unit rates only.
    """
    if code is None:
        alpha = model.alphabet
        if not str(alpha).startswith("codon"):
            raise ValueError(
                "dn_ds_by_branch needs a codon model (GY94/MG94 family); "
                f"got model {model.name!r} with alphabet {alpha!r}"
            )
        code = "standard" if alpha == "codon" else alpha.split(":", 1)[1]
    single, _, nonsyn = _build_structure(code)
    syn = single * (1.0 - nonsyn)

    full = {**model.defaults(torch.float64), **{
        k: torch.as_tensor(v, dtype=torch.float64).detach().cpu()
        for k, v in (params or {}).items()
    }}

    def flows(p):
        sym, freqs = model.build(**p)
        q = build_rate_matrix(sym, freqs).numpy()
        pi = freqs.numpy()
        rho_n = float(np.sum(pi[:, None] * q * nonsyn))
        rho_s = float(np.sum(pi[:, None] * q * syn))
        return rho_n, rho_s

    rho_n, rho_s = flows(full)
    p1 = dict(full)
    p1["omega"] = torch.tensor(1.0, dtype=torch.float64)
    rho_n1, rho_s1 = flows(p1)
    # mutational-opportunity sites per codon (omega = 1 flows), S + N = 3
    s_sites = 3.0 * rho_s1 / (rho_s1 + rho_n1)
    n_sites = 3.0 - s_sites
    out = {
        "S": s_sites,
        "N": n_sites,
        "omega": float(full["omega"]),
        "rho_N": rho_n,
        "rho_S": rho_s,
    }
    if branch_lengths is not None:
        t = np.asarray(branch_lengths, np.float64)
        # expected subs per codon on the branch, split by type
        en = t * rho_n
        es = t * rho_s
        out.update(
            t=t,
            dN=en / (n_sites / 3.0),
            dS=es / (s_sites / 3.0),
            expected_nonsyn_subs=en,
            expected_syn_subs=es,
        )
    return out
