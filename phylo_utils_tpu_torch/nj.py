"""Neighbor-joining tree construction from a distance matrix (copy of
``phylo_utils_tpu.nj`` on the port's ``trees``; numpy only).

Completes the de-novo pipeline: alignment -> ML distances
(``optimize.ml_distance_matrix``, every pair's Newton iteration as one
batch) -> NJ starting tree. Saitou-Nei with the standard Studier-Keppler
O(n^3) update; negative NJ branch lengths are clamped to 0 (conventional).
Returns a trifurcating-rooted :class:`trees.Tree` (the usual unrooted
representation).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from phylo_utils_tpu_torch.trees import Tree, TreeBuilder

__all__ = ["neighbor_joining"]


def neighbor_joining(
    distances: np.ndarray, names: Sequence[str]
) -> Tree:
    """Build an NJ tree from a symmetric (n, n) distance matrix."""
    d = np.array(distances, dtype=np.float64)
    n = d.shape[0]
    if d.shape != (n, n) or n != len(names):
        raise ValueError("distance matrix / names size mismatch")
    if n < 2:
        raise ValueError("need at least 2 taxa")
    if not np.allclose(d, d.T, atol=1e-8):
        raise ValueError("distance matrix must be symmetric")

    b = TreeBuilder()
    # active: node-builder-id per current cluster; lengths assigned on join
    active = [b.add_node(name=str(nm), length=None, children=[])
              for nm in names]
    # lengths are set when a cluster is joined; keep pending values
    pending_len = {i: 0.0 for i in range(len(active))}

    idx = list(range(n))                     # rows of d still active
    while len(idx) > 3:
        m = len(idx)
        sub = d[np.ix_(idx, idx)]
        r = sub.sum(axis=1)
        q = (m - 2) * sub - r[:, None] - r[None, :]
        np.fill_diagonal(q, np.inf)
        i_, j_ = np.unravel_index(np.argmin(q), q.shape)
        if i_ > j_:
            i_, j_ = j_, i_
        di = 0.5 * sub[i_, j_] + (r[i_] - r[j_]) / (2.0 * (m - 2))
        dj = sub[i_, j_] - di
        di, dj = max(di, 0.0), max(dj, 0.0)
        gi, gj = idx[i_], idx[j_]
        new = b.add_node(name=None, length=None, children=[])
        # record the children with their branch lengths
        _attach(b, new, active[gi], di + pending_len.pop(gi))
        _attach(b, new, active[gj], dj + pending_len.pop(gj))
        # distances from the new cluster to the rest
        rest = [k for k in idx if k not in (gi, gj)]
        dij = sub[i_, j_]
        for k in rest:
            d[gi, k] = d[k, gi] = 0.5 * (d[gi, k] + d[gj, k] - dij)
        active[gi] = new
        pending_len[gi] = 0.0
        idx = [k for k in idx if k != gj]

    # final join: remaining 2 or 3 clusters under the root
    if len(idx) == 3:
        a_, b_, c_ = idx
        la = 0.5 * (d[a_, b_] + d[a_, c_] - d[b_, c_])
        lb = 0.5 * (d[a_, b_] + d[b_, c_] - d[a_, c_])
        lc = 0.5 * (d[a_, c_] + d[b_, c_] - d[a_, b_])
        kids = [(active[a_], la + pending_len[a_]),
                (active[b_], lb + pending_len[b_]),
                (active[c_], lc + pending_len[c_])]
    else:
        a_, b_ = idx
        half = 0.5 * d[a_, b_]
        kids = [(active[a_], half + pending_len[a_]),
                (active[b_], half + pending_len[b_])]
    root = b.add_node(name=None, length=None, children=[])
    for node, ln in kids:
        _attach(b, root, node, ln)
    return b.build(root)


def _attach(builder: TreeBuilder, parent: int, child: int, length: float):
    """Register child under parent with a (clamped) branch length."""
    builder._children[parent].append(child)
    builder._lengths[child] = max(float(length), 0.0)
