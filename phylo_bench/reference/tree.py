"""The reference's tree: a rooted tree with node ids in the canonical order
of a Newick string (leaves left to right, internal nodes in post-order,
the root last), so that any parser that numbers nodes that way reads the
same ids back from ``newick()``."""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class RefTree:
    parent: np.ndarray                       # (N,) int64, the root's is -1
    children: Tuple[Tuple[int, ...], ...]    # per node
    n_leaves: int

    @property
    def n_nodes(self) -> int:
        return len(self.children)

    @property
    def root(self) -> int:
        return self.n_nodes - 1

    @property
    def n_internal(self) -> int:
        return self.n_nodes - self.n_leaves

    @property
    def n_edges(self) -> int:
        return self.n_nodes - 1

    @property
    def leaf_names(self) -> List[str]:
        return [f"t{i}" for i in range(self.n_leaves)]

    def internal_postorder(self) -> range:
        """Internal nodes, children before parents (ids are post-order)."""
        return range(self.n_leaves, self.n_nodes)

    def preorder_edges(self) -> List[Tuple[int, int]]:
        """(parent, child) pairs, every parent before its children."""
        return [(node, c) for node in reversed(self.internal_postorder())
                for c in self.children[node]]

    def newick(self, lengths) -> str:
        """Newick text of the tree with ``lengths[i]`` above node ``i``."""
        names = self.leaf_names

        def text(node: int) -> str:
            if node < self.n_leaves:
                return names[node]
            return "(" + ",".join(f"{text(c)}:{float(lengths[c])!r}"
                                  for c in self.children[node]) + ")"

        return text(self.root) + ";"


def random_topology(n_taxa: int, seed: int) -> RefTree:
    """A random rooted binary topology of ``n_taxa`` leaves by sequential
    random joins, renumbered to the canonical order."""
    rng = np.random.default_rng(seed)
    kids: List[Tuple[int, ...]] = [()] * n_taxa
    pool = list(range(n_taxa))
    while len(pool) > 1:
        i, j = sorted(rng.choice(len(pool), size=2, replace=False))
        kids.append((pool[i], pool[j]))
        pool = [x for k, x in enumerate(pool) if k not in (i, j)] + [
            len(kids) - 1]
    # canonical ids: a depth-first walk from the root, leaves in visit
    # order, internal nodes as they close
    leaves: List[int] = []
    internal: List[int] = []
    stack = [(pool[0], False)]
    while stack:
        node, closed = stack.pop()
        if not kids[node]:
            leaves.append(node)
        elif closed:
            internal.append(node)
        else:
            stack.append((node, True))
            stack.extend((c, False) for c in reversed(kids[node]))
    new = {old: i for i, old in enumerate(leaves + internal)}
    children: List[Tuple[int, ...]] = [()] * len(new)
    parent = np.full(len(new), -1, np.int64)
    for old, i in new.items():
        children[i] = tuple(new[c] for c in kids[old])
        for c in children[i]:
            parent[c] = i
    return RefTree(parent=parent, children=tuple(children), n_leaves=n_taxa)
