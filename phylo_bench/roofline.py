"""The least time the card could take for a call's pruning work, whatever
walk or kernel does it.

Operations per column (one set x one rate category x one pattern), at the
model's own state count S (61 codons, not the 64 they are padded to): per
child edge an S x S contraction (2 S^2) and the product (S), per internal
node the rescale (2 S); a gradient adds the least reverse any
implementation must do, without leaf cotangents: per edge the derivative
of its P block applied to the child's row (2 S^2), the parent's
cotangent times the siblings' rows and its dot with that derivative
(3 S), and per internal node but the root
the transposed contraction into its children's seed (2 S^2). The
siblings' rows are taken as kept from the forward: an implementation that
recomputes them does more than this count.

Bytes: each input read once (leaf partials, float32, shared by the sets;
the P blocks) and each output written once (the per-pattern, per-category
log-likelihoods, float32, and the totals, float64; for a gradient the dP
blocks). What an implementation keeps or recomputes between the forward
and the reverse is its own choice and is not counted.

The least time is the larger of the operations over the card's float32
rate outside the tensor cores and the bytes over its memory rate (NVIDIA
H100 SXM data sheet, at its 700 W limit).
"""
from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def pruning_work(n_leaves: int, n_internal: int, n_edges: int,
                 patterns: int, sets: int, ncat: int, states: int,
                 grad: bool) -> tuple:
    """(operations, bytes) of one call."""
    s = states
    cols = sets * ncat * patterns
    flops = cols * (n_edges * (2 * s * s + s) + n_internal * 2 * s)
    p_blocks = sets * n_edges * ncat * s * s
    nbytes = 4 * (n_leaves * patterns * s + p_blocks + cols) + 8 * sets
    if grad:
        flops += cols * ((n_internal - 1) * 2 * s * s
                         + n_edges * (2 * s * s + 3 * s))
        nbytes += 4 * p_blocks
    return flops, nbytes


def least_seconds(flops: float, nbytes: float) -> tuple:
    """(seconds, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
