"""Tree topology and its compilation to a static-shape pruning schedule.

The reference attaches per-node mutable state to dendropy node objects and
walks dendropy's post-order iterator in Python (SURVEY.md §1/§3.2 [HIGH]).
That is the one design we deliberately do NOT reproduce: on TPU the topology
is compiled once into padded integer index arrays — a *level schedule* — so
the whole pruning pass is a jit-compiled pure function of
``(P_matrices, leaf_partials, schedule)`` with static shapes. Recompilation
happens only on topology change, never on parameter change.

Level schedule: internal nodes are grouped by height (1 + max child height;
leaves = 0). All nodes in one level depend only on lower levels, so each
level is one batched combine over (nodes_in_level x categories x sites).
Levels are padded to the widest level; padded slots write to a trash row
(index ``n_nodes``) and gather masked children whose contribution is
replaced by ones.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Tree",
    "TreeBuilder",
    "PruningSchedule",
    "compile_schedule",
    "random_tree",
    "nni_neighbors",
    "spr_neighbors",
    "robinson_foulds",
    "branch_score_distance",
    "majority_rule_consensus",
    "reroot",
    "midpoint_root",
    "tree_ascii",
]


@dataclasses.dataclass(frozen=True)
class Tree:
    """Immutable tree. Node ids: leaves are [0, n_leaves) in left-to-right
    Newick order; internal nodes follow in post-order; the root is the last id.

    ``lengths[i]`` is the length of the edge *above* node i (root entry 0).
    """

    names: Tuple[str, ...]              # per node; internal may be ""
    parent: np.ndarray                  # (N,) int32; root's parent == -1
    lengths: np.ndarray                 # (N,) float64
    children: Tuple[Tuple[int, ...], ...]
    n_leaves: int

    @property
    def n_nodes(self) -> int:
        return len(self.names)

    @property
    def root(self) -> int:
        return self.n_nodes - 1

    @property
    def leaf_names(self) -> Tuple[str, ...]:
        return self.names[: self.n_leaves]

    def leaf_index(self) -> Dict[str, int]:
        return {n: i for i, n in enumerate(self.leaf_names)}

    def postorder(self):
        """Yield node ids in post-order (children before parents)."""
        stack = [(self.root, False)]
        while stack:
            node, expanded = stack.pop()
            if expanded or not self.children[node]:
                yield node
            else:
                stack.append((node, True))
                for c in reversed(self.children[node]):
                    stack.append((c, False))

    def with_lengths(self, lengths) -> "Tree":
        arr = np.asarray(lengths, dtype=np.float64)
        if arr.shape != self.lengths.shape:
            raise ValueError("length vector shape mismatch")
        return dataclasses.replace(self, lengths=arr)


class TreeBuilder:
    """Incremental builder used by the Newick parser."""

    def __init__(self):
        self._names: List[Optional[str]] = []
        self._lengths: List[Optional[float]] = []
        self._children: List[List[int]] = []

    def add_node(self, name: Optional[str], length: Optional[float],
                 children: Sequence[int]) -> int:
        self._names.append(name)
        self._lengths.append(length)
        self._children.append(list(children))
        return len(self._names) - 1

    def build(self, root: int) -> Tree:
        # Renumber: leaves first (in left-to-right order), then internal nodes
        # in post-order, root last.
        order_leaves: List[int] = []
        order_internal: List[int] = []
        stack = [(root, False)]
        while stack:
            node, expanded = stack.pop()
            kids = self._children[node]
            if not kids:
                order_leaves.append(node)
            elif expanded:
                order_internal.append(node)
            else:
                stack.append((node, True))
                for c in reversed(kids):
                    stack.append((c, False))
        remap = {old: new for new, old in enumerate(order_leaves + order_internal)}
        n = len(remap)
        names = [""] * n
        lengths = np.zeros(n, dtype=np.float64)
        children: List[Tuple[int, ...]] = [()] * n
        parent = np.full(n, -1, dtype=np.int32)
        for old, new in remap.items():
            names[new] = self._names[old] or ""
            lengths[new] = self._lengths[old] if self._lengths[old] is not None else 0.0
            kids = tuple(remap[c] for c in self._children[old])
            children[new] = kids
            for c in kids:
                parent[c] = new
        n_leaves = len(order_leaves)
        leaf_names = [names[i] for i in range(n_leaves)]
        if len(set(leaf_names)) != n_leaves:
            raise ValueError("duplicate leaf names in tree")
        return Tree(
            names=tuple(names),
            parent=parent,
            lengths=lengths,
            children=tuple(children),
            n_leaves=n_leaves,
        )


@dataclasses.dataclass(frozen=True)
class PruningSchedule:
    """Padded level schedule for Felsenstein pruning (all numpy, host-side).

    Shapes: L = number of levels, W = widest level, C = max children/node.

    ``level_nodes``    (L, W) int32 — destination node id; padding = n_nodes
                        (a trash row appended to the partials buffer).
    ``level_children`` (L, W, C) int32 — source child node ids; padding = 0.
    ``level_childmask``(L, W, C) float32 — 1.0 for a real (node, child) slot.
    """

    n_nodes: int
    n_leaves: int
    root: int
    n_children_max: int
    level_nodes: np.ndarray
    level_children: np.ndarray
    level_childmask: np.ndarray
    # Nodes < n_real_nodes are real tree nodes; ids in
    # [n_real_nodes, n_nodes) are binarization pseudo-nodes (see
    # compile_schedule) whose transition matrix is the exact identity
    # (ops.pmatrix.extend_p_identity).
    n_real_nodes: int = -1

    def __post_init__(self):
        if self.n_real_nodes < 0:
            object.__setattr__(self, "n_real_nodes", self.n_nodes)

    @property
    def n_levels(self) -> int:
        return self.level_nodes.shape[0]

    @property
    def width(self) -> int:
        return self.level_nodes.shape[1]


def compile_schedule(tree: Tree, binarize: bool = True) -> PruningSchedule:
    """Group internal nodes into dependency levels and pad to rectangles.

    ``binarize`` (default): multifurcations are split into chains of
    binary combines through appended *pseudo-nodes* (ids >= tree.n_nodes;
    the root keeps its id). A pseudo-node's "edge" is the exact identity
    matrix, so the likelihood is mathematically unchanged — but the
    schedule's max-children drops to 2, which removes the masked third
    contraction every *binary* node would otherwise pay in both pruner
    paths: an unrooted tree's single trifurcating root previously forced
    cmax=3 on all ~2N nodes (+50% contraction FLOPs). Consumers that
    build P(t) from branch lengths must append identity blocks for the
    pseudo-nodes via ``ops.pmatrix.extend_p_identity``. Binary trees
    produce bit-identical schedules with or without ``binarize``.
    """
    n_real = tree.n_nodes
    children_map: List[List[int]] = [list(tree.children[i])
                                     for i in range(n_real)]
    if binarize:
        for node in range(n_real):
            kids = children_map[node]
            while len(kids) > 2:
                a, b = kids[0], kids[1]
                pseudo = len(children_map)
                children_map.append([a, b])
                kids = [pseudo] + kids[2:]
            children_map[node] = kids
    n = len(children_map)

    height = np.zeros(n, dtype=np.int64)
    internal_by_level: Dict[int, List[int]] = {}
    stack = [(tree.root, False)]
    while stack:
        node, expanded = stack.pop()
        kids = children_map[node]
        if not kids:
            continue
        if expanded:
            h = 1 + max(int(height[c]) for c in kids)
            height[node] = h
            internal_by_level.setdefault(h, []).append(node)
        else:
            stack.append((node, True))
            for c in reversed(kids):
                stack.append((c, False))

    n_levels = max(internal_by_level) if internal_by_level else 0
    width = max((len(v) for v in internal_by_level.values()), default=0)
    cmax = max((len(k) for k in children_map if k), default=0)

    level_nodes = np.full((n_levels, width), n, dtype=np.int32)  # pad -> trash row
    level_children = np.zeros((n_levels, width, cmax), dtype=np.int32)
    level_childmask = np.zeros((n_levels, width, cmax), dtype=np.float32)
    for lvl in range(1, n_levels + 1):
        for w, node in enumerate(internal_by_level.get(lvl, [])):
            level_nodes[lvl - 1, w] = node
            for c, child in enumerate(children_map[node]):
                level_children[lvl - 1, w, c] = child
                level_childmask[lvl - 1, w, c] = 1.0
    return PruningSchedule(
        n_nodes=n,
        n_leaves=tree.n_leaves,
        root=tree.root,
        n_children_max=cmax,
        level_nodes=level_nodes,
        level_children=level_children,
        level_childmask=level_childmask,
        n_real_nodes=n_real,
    )


def regroup_schedule(schedule: PruningSchedule,
                     width: int) -> PruningSchedule:
    """Re-pack a level schedule into fixed-width dependency GROUPS.

    The height-level grid pads every level to the widest one — measured
    fill factors of 14–22% on 64-taxon NNI candidate sets (APPBENCH r4).
    Hu's-algorithm list scheduling (unit tasks on an in-tree, priority =
    distance to root — makespan-optimal for ``width`` machines) packs the
    same combines into near-full groups of exactly ``width`` slots:
    no node is a child of another in its own group, so each group is a
    valid "level" for the scan-based pruner, and the padded area drops
    from L×W_max to ceil-ish(n_internal/width)×width (bounded below by
    the critical path). Padding slots keep the level-grid convention
    (node id = n_nodes trash row, zero child mask).
    """
    ln, lc, lm = (schedule.level_nodes, schedule.level_children,
                  schedule.level_childmask)
    n, n_leaves = schedule.n_nodes, schedule.n_leaves
    cmax = schedule.n_children_max
    # flatten the level grid back to (node -> children) + depth-to-root
    kids = {}
    for lvl in range(ln.shape[0]):
        for w in range(ln.shape[1]):
            node = int(ln[lvl, w])
            if node >= n:
                continue
            kids[node] = [int(lc[lvl, w, c]) for c in range(cmax)
                          if lm[lvl, w, c] > 0]
    parent = {c: p for p, ks in kids.items() for c in ks if c in kids}
    root = schedule.root
    depth = {root: 0}
    # BFS from the root for depths
    frontier = [root]
    while frontier:
        nxt = []
        for p in frontier:
            for c in kids.get(p, ()):
                if c in kids:
                    depth[c] = depth[p] + 1
                    nxt.append(c)
        frontier = nxt
    pend = {p: sum(1 for c in ks if c in kids) for p, ks in kids.items()}
    ready = [p for p, v in pend.items() if v == 0]
    groups = []
    scheduled = 0
    while scheduled < len(kids):
        ready.sort(key=lambda x: -depth[x])
        take = ready[:width]
        ready = ready[width:]
        groups.append(take)
        scheduled += len(take)
        for node in take:
            p = parent.get(node)
            if p is not None and p in pend:
                pend[p] -= 1
                if pend[p] == 0:
                    ready.append(p)
    g = len(groups)
    nodes = np.full((g, width), n, dtype=np.int32)
    children = np.zeros((g, width, cmax), dtype=np.int32)
    mask = np.zeros((g, width, cmax), dtype=np.float32)
    for gi, grp in enumerate(groups):
        for w, node in enumerate(grp):
            nodes[gi, w] = node
            for c, child in enumerate(kids[node]):
                children[gi, w, c] = child
                mask[gi, w, c] = 1.0
    return PruningSchedule(
        n_nodes=n,
        n_leaves=n_leaves,
        root=root,
        n_children_max=cmax,
        level_nodes=nodes,
        level_children=children,
        level_childmask=mask,
        n_real_nodes=schedule.n_real_nodes,
    )


def schedule_fill(schedules) -> float:
    """Real combine slots / padded level-grid slots after common padding
    (the APPBENCH `pad_schedules_fill` diagnostic)."""
    L = max(s.n_levels for s in schedules)
    W = max(s.width for s in schedules)
    real = sum(int((s.level_nodes < s.n_nodes).sum()) for s in schedules)
    return real / float(len(schedules) * L * W)


def random_tree(
    n_taxa: int,
    seed: int = 0,
    mean_brlen: float = 0.1,
    rooted: bool = True,
    names: Optional[Sequence[str]] = None,
) -> Tree:
    """Random binary topology (sequential random joins) with exponential
    branch lengths — used by benchmarks and property tests."""
    rng = np.random.default_rng(seed)
    if names is None:
        names = [f"t{i}" for i in range(n_taxa)]
    b = TreeBuilder()
    nodes = [
        b.add_node(name=names[i], length=float(rng.exponential(mean_brlen)), children=[])
        for i in range(n_taxa)
    ]
    while len(nodes) > (2 if rooted else 3):
        i, j = sorted(rng.choice(len(nodes), size=2, replace=False))
        a, c = nodes[i], nodes[j]
        merged = b.add_node(
            name=None, length=float(rng.exponential(mean_brlen)), children=[a, c]
        )
        nodes = [x for k, x in enumerate(nodes) if k not in (i, j)] + [merged]
    root = b.add_node(name=None, length=None, children=nodes)
    return b.build(root)


def _rebuild_with_children(tree: Tree, children_map,
                           root: Optional[int] = None) -> Tree:
    """Rebuild (renumber) a tree from an edited child map, preserving names
    and the branch length attached to each moved subtree's root."""
    if root is None:
        root = tree.root
    b = TreeBuilder()
    # iterative post-order to avoid recursion limits on deep trees
    new_id: Dict[int, int] = {}
    stack = [(root, False)]
    while stack:
        node, expanded = stack.pop()
        kids = children_map[node]
        if expanded or not kids:
            new_id[node] = b.add_node(
                name=tree.names[node] or None,
                length=None if node == root else float(tree.lengths[node]),
                children=[new_id[k] for k in kids],
            )
        else:
            stack.append((node, True))
            for k in reversed(kids):
                stack.append((k, False))
    return b.build(new_id[root])


def nni_neighbors(tree: Tree) -> List[Tree]:
    """All nearest-neighbor-interchange rearrangements of ``tree``.

    For every internal edge (u -> v) with v internal, each child subtree of v
    is exchanged with each sibling subtree of v. Branch lengths travel with
    their subtrees. Designed to feed ``batched.TopologySetEngine`` (all
    neighbors share the taxon set, so the whole neighborhood is scored in
    one device program — a tree-search step the reference would loop over).
    """
    base = {n: list(tree.children[n]) for n in range(tree.n_nodes)}
    out: List[Tree] = []
    root = tree.root
    root_bifurcating = len(tree.children[root]) == 2
    for v in range(tree.n_leaves, tree.n_nodes):
        if v == root:
            continue
        u = int(tree.parent[v])
        if u == root and root_bifurcating:
            # A bifurcating root fuses its two child edges into ONE
            # unrooted edge: swapping v's child with the WHOLE sibling is
            # a no-op re-rooting (verified: RF 0). The real NNI exchanges
            # a child of v with a child of the sibling. Emit it once (for
            # the lower-id internal side).
            (s,) = [k for k in tree.children[u] if k != v]
            if s < tree.n_leaves or s < v:
                continue   # pendant root edge, or already emitted via s
            for c in tree.children[v]:
                for c2 in tree.children[s]:
                    cm = {n: list(k) for n, k in base.items()}
                    cm[v] = [c2 if k == c else k for k in cm[v]]
                    cm[s] = [c if k == c2 else k for k in cm[s]]
                    out.append(_rebuild_with_children(tree, cm))
            continue
        for s in tree.children[u]:
            if s == v:
                continue
            for c in tree.children[v]:
                cm = {n: list(k) for n, k in base.items()}
                cm[v] = [s if k == c else k for k in cm[v]]
                cm[u] = [c if k == s else k for k in cm[u]]
                out.append(_rebuild_with_children(tree, cm))
    return out


def spr_neighbors(tree: Tree, max_targets: Optional[int] = None,
                  seed: int = 0) -> List[Tree]:
    """Subtree-prune-and-regraft rearrangements of ``tree``.

    For every pruneable subtree v (its parent must have exactly two
    children, so the detach frees one node id that becomes the regraft
    junction — node count stays invariant, which the batched topology
    scorer requires), reattach v onto every other edge, splitting that
    edge's length in half. ``max_targets`` randomly subsamples regraft
    edges per pruned subtree (None = all). Trees with multifurcations are
    supported; subtrees hanging off a >2-child node are skipped as prune
    candidates (NNI covers those locally).
    """
    rng = np.random.default_rng(seed)
    n = tree.n_nodes
    children0 = {i: list(tree.children[i]) for i in range(n)}
    out: List[Tree] = []

    for v in range(n):
        if v == tree.root:
            continue
        u = int(tree.parent[v])
        if len(children0[u]) != 2:
            continue
        (w,) = [c for c in children0[u] if c != v]
        # nodes inside the pruned subtree are invalid regraft targets
        desc = set()
        stack = [v]
        while stack:
            x = stack.pop()
            desc.add(x)
            stack.extend(children0[x])

        targets = [
            c for c in range(n)
            if c not in desc and c != tree.root and c != u and c != w
        ]
        if max_targets is not None and len(targets) > max_targets:
            targets = list(rng.choice(targets, size=max_targets,
                                      replace=False))
        for c in targets:
            cm = {i: list(k) for i, k in children0.items()}
            lengths = tree.lengths.copy()
            # detach v; contract u (its id becomes the new junction)
            if u == tree.root:
                new_root = w          # w becomes the root
                # unrooted edge v--w had length l_v + l_w; the whole edge
                # travels with the pruned subtree (conserves total length)
                lengths[v] = lengths[v] + lengths[w]
                cm[u] = []
            else:
                p = int(tree.parent[u])
                cm[p] = [w if x == u else x for x in cm[p]]
                lengths[w] = lengths[w] + lengths[u]
                cm[u] = []
                new_root = tree.root
            pc = int(tree.parent[c])
            if pc == u:               # c's parent was contracted away
                pc = int(tree.parent[u]) if u != tree.root else new_root
            # insert junction u into the edge above c
            cm[pc] = [u if x == c else x for x in cm[pc]]
            cm[u] = [c, v]
            half = lengths[c] * 0.5
            lengths[u] = half
            lengths[c] = half
            nt = _rebuild_with_children(
                dataclasses.replace(tree, lengths=lengths),
                cm,
                root=new_root,
            )
            out.append(nt)
    return out


def _splits(tree: Tree) -> set:
    """Non-trivial unrooted bipartitions as frozensets of leaf names
    (canonicalized to the side not containing the first leaf name)."""
    all_names = frozenset(tree.leaf_names)
    # deterministic SHARED anchor: two trees over the same taxa must
    # canonicalize each bipartition to the same side regardless of their
    # internal leaf order (rerooting reorders leaves)
    anchor = min(all_names)
    below: Dict[int, frozenset] = {}
    splits = set()
    for node in tree.postorder():
        kids = tree.children[node]
        if not kids:
            below[node] = frozenset((tree.names[node],))
            continue
        s = frozenset().union(*(below[c] for c in kids))
        below[node] = s
        if node != tree.root and 1 < len(s) < len(all_names) - 1:
            side = s if anchor not in s else all_names - s
            splits.add(side)
    return splits


def robinson_foulds(t1: Tree, t2: Tree, normalized: bool = False) -> float:
    """Robinson-Foulds (symmetric-difference) topology distance.

    Trees must share a taxon set. ``normalized=True`` divides by the
    maximum possible distance (sum of non-trivial splits in both trees).
    """
    if set(t1.leaf_names) != set(t2.leaf_names):
        raise ValueError("trees have different taxon sets")
    s1, s2 = _splits(t1), _splits(t2)
    rf = len(s1 ^ s2)
    if not normalized:
        return float(rf)
    denom = len(s1) + len(s2)
    return rf / denom if denom else 0.0


def _split_lengths(tree: Tree) -> Dict[frozenset, float]:
    """Every unrooted edge's canonical bipartition -> branch length.

    Includes trivial (leaf) splits. On a rooted binary tree the two root
    children carry complementary clusters — canonicalization maps both to
    the same split and their lengths SUM, which is exactly the single
    unrooted edge they jointly represent."""
    all_names = frozenset(tree.leaf_names)
    anchor = min(all_names)
    below: Dict[int, frozenset] = {}
    out: Dict[frozenset, float] = {}
    for node in tree.postorder():
        kids = tree.children[node]
        if not kids:
            below[node] = frozenset((tree.names[node],))
        else:
            below[node] = frozenset().union(*(below[c] for c in kids))
        if node != tree.root:
            s = below[node]
            side = s if anchor not in s else all_names - s
            if side and len(side) < len(all_names):
                out[side] = out.get(side, 0.0) + float(tree.lengths[node])
    return out


def branch_score_distance(t1: Tree, t2: Tree) -> float:
    """Kuhner-Felsenstein (1994) branch-score distance: sqrt of the sum
    of squared branch-length differences over the union of bipartitions
    (a split absent from a tree contributes length 0). Unlike RF this is
    continuous in the branch lengths; BSD(t, t) == 0 under rerooting."""
    if set(t1.leaf_names) != set(t2.leaf_names):
        raise ValueError("trees have different taxon sets")
    m1, m2 = _split_lengths(t1), _split_lengths(t2)
    total = 0.0
    for s in set(m1) | set(m2):
        d = m1.get(s, 0.0) - m2.get(s, 0.0)
        total += d * d
    return float(np.sqrt(total))


def majority_rule_consensus(
    trees: Sequence[Tree], min_freq: float = 0.5
) -> Tree:
    """Majority-rule consensus of a tree sample (bootstrap replicates,
    posterior samples): keeps every non-trivial bipartition appearing in
    MORE than ``min_freq`` of the input trees (strict majority splits are
    always pairwise compatible, so the consensus is well-defined for
    min_freq >= 0.5). Internal node names carry the split's support as an
    integer percentage; branch lengths are the mean over the trees
    containing the split (leaf edges: mean over all trees)."""
    if min_freq < 0.5:
        raise ValueError("min_freq < 0.5 can yield incompatible splits")
    trees = list(trees)
    if not trees:
        raise ValueError("no trees given")
    taxa = set(trees[0].leaf_names)
    for t in trees[1:]:
        if set(t.leaf_names) != taxa:
            raise ValueError("trees have different taxon sets")
    n = len(trees)
    counts: Dict[frozenset, int] = {}
    lensum: Dict[frozenset, float] = {}
    for t in trees:
        m = _split_lengths(t)
        for s, ln in m.items():
            lensum[s] = lensum.get(s, 0.0) + ln
        for s in _splits(t):
            counts[s] = counts.get(s, 0) + 1
    kept = [s for s, c in counts.items() if c / n > min_freq]
    kept.sort(key=len)                       # children before parents
    anchor = min(taxa)

    def mean_len(side: frozenset, present: int) -> float:
        return lensum.get(side, 0.0) / max(present, 1)

    builder = TreeBuilder()
    node_of: Dict[frozenset, int] = {}
    claimed: Dict = {}                        # leaf/split -> parent split
    for s in kept:
        kids = []
        for leaf in sorted(s):
            if leaf not in claimed:
                side = (
                    frozenset((leaf,))
                    if leaf != anchor
                    else frozenset(taxa - {leaf})
                )
                kids.append(
                    builder.add_node(leaf, mean_len(side, n), ())
                )
                claimed[leaf] = s
        for s2 in kept:
            if s2 is not s and s2 in node_of and s2 < s \
                    and claimed.get(s2) is None:
                kids.append(node_of[s2])
                claimed[s2] = s
        support = round(100.0 * counts[s] / n)
        node_of[s] = builder.add_node(
            str(support), mean_len(s, counts[s]), kids
        )
        claimed.setdefault(s, None)
    root_kids = []
    for leaf in sorted(taxa):
        if leaf not in claimed:
            side = (
                frozenset((leaf,))
                if leaf != anchor
                else frozenset(taxa - {leaf})
            )
            root_kids.append(builder.add_node(leaf, mean_len(side, n), ()))
    for s in kept:
        if claimed.get(s) is None:
            root_kids.append(node_of[s])
    root = builder.add_node("", None, root_kids)
    return builder.build(root)


def reroot(tree: Tree, node: int, fraction: float = 0.5) -> Tree:
    """New tree rooted ON THE EDGE above ``node``.

    The new root splits that edge: ``fraction`` of its length goes to the
    ``node`` side (0.5 = middle). The old root, if it becomes a
    degree-two pass-through, is spliced out (its two edge lengths sum).
    For reversible models the likelihood is invariant to this operation
    (Felsenstein's pulley principle) — tested against the engine.
    """
    node = int(node)
    if node == tree.root:
        raise ValueError("cannot reroot on the root's (nonexistent) edge")
    if not 0.0 <= fraction <= 1.0:
        raise ValueError("fraction must be in [0, 1]")
    t_edge = float(tree.lengths[node])
    orig = {n: float(tree.lengths[n]) for n in range(tree.n_nodes)}
    ch = {n: list(tree.children[n]) for n in range(tree.n_nodes)}
    ln = dict(orig)
    path = []                                 # old_parent(node) .. old_root
    q = int(tree.parent[node])
    while q != -1:
        path.append(q)
        q = int(tree.parent[q])
    old_root = tree.root
    prev = node
    for q in path:                            # flip the chain
        ch[q] = [c for c in ch[q] if c != prev]
        if q != old_root:
            ch[q].append(int(tree.parent[q]))
        # new edge above q = the old edge (prev, q): the split upper part
        # for the first hop, the ORIGINAL edge above prev otherwise
        ln[q] = (1.0 - fraction) * t_edge if prev == node else orig[prev]
        prev = q
    ln[node] = fraction * t_edge
    top_kids = [node, path[0]]
    # splice a now-degree-2 old root (original bifurcating root)
    if len(ch[old_root]) == 1:
        only = ch[old_root][0]
        ln[only] = orig[only] + ln[old_root]
        if path[0] == old_root:
            top_kids = [node, only]
        else:
            adopter = path[path.index(old_root) - 1]
            ch[adopter] = [only if c == old_root else c
                           for c in ch[adopter]]

    b = TreeBuilder()
    new_id: Dict[int, int] = {}
    NEW_ROOT = -2

    def kids_of(n):
        return top_kids if n == NEW_ROOT else ch[n]

    stack = [(NEW_ROOT, False)]
    while stack:
        n, expanded = stack.pop()
        kids = kids_of(n)
        if expanded or not kids:
            new_id[n] = b.add_node(
                name=None if n == NEW_ROOT else (tree.names[n] or None),
                length=None if n == NEW_ROOT else ln[n],
                children=[new_id[k] for k in kids],
            )
        else:
            stack.append((n, True))
            for k in reversed(kids):
                stack.append((k, False))
    return b.build(new_id[NEW_ROOT])


def midpoint_root(tree: Tree) -> Tree:
    """Reroot at the midpoint of the longest leaf-to-leaf path.

    The standard outgroup-free rooting for clock analyses
    (``clock.ClockEngine`` assumes a meaningfully rooted tree).
    """
    # node depths from the current root; path distances via upward walks
    def root_path(leaf):
        path, node, dist = [], leaf, []
        while node != -1:
            path.append(node)
            dist.append(float(tree.lengths[node]))
            node = int(tree.parent[node])
        return path, dist

    def leaf_dists(src):
        """distance from leaf `src` to every node (upward then downward)."""
        d = {}
        path, dist = root_path(src)
        acc = 0.0
        for n, ln in zip(path, dist):
            d[n] = acc
            acc += ln
        # downward sweep from each path node
        for start in path:
            stack = [start]
            while stack:
                n = stack.pop()
                for c in tree.children[n]:
                    if c in d:
                        continue
                    d[c] = d[n] + float(tree.lengths[c])
                    stack.append(c)
        return d

    leaves = range(tree.n_leaves)
    d0 = leaf_dists(0)
    u = max(leaves, key=lambda i: d0[i])
    du = leaf_dists(u)
    v = max(leaves, key=lambda i: du[i])
    diameter = du[v]
    if diameter <= 0:
        return tree
    # walk from v toward u: v's root path + u's root path meet at the LCA
    pu, _ = root_path(u)
    pv, _ = root_path(v)
    onpath_u = set(pu)
    lca = next(n for n in pv if n in onpath_u)
    # nodes from v up to lca, then down to u — accumulate from v
    chain = []
    for n in pv:
        chain.append(n)
        if n == lca:
            break
    down = []
    for n in pu:
        if n == lca:
            break
        down.append(n)
    chain += down[::-1]
    # edges along the chain: above each node except the lca entry
    half = diameter / 2.0
    acc = 0.0
    for i, n in enumerate(chain):
        if n == lca and i == len(chain) - 1:
            break
        # edge above n if we're ascending (before lca), else edge above
        # the NEXT node (descending side)
        edge_node = n if i < chain.index(lca) else chain[i + 1]
        ln = float(tree.lengths[edge_node])
        if acc + ln >= half - 1e-12:
            frac_from_below = (half - acc) / max(ln, 1e-30)
            if edge_node == n:      # ascending: below-end is n (v side)
                fraction = frac_from_below
            else:                   # descending: below-end is edge_node
                fraction = 1.0 - frac_from_below
            fraction = min(max(fraction, 0.0), 1.0)
            return reroot(tree, edge_node, fraction)
        acc += ln
    return reroot(tree, chain[0], 0.5)  # numerical fallback


def tree_ascii(tree: Tree, width: int = 72,
               supports: Optional[Dict[int, float]] = None) -> str:
    """Plain-text rendering of the tree (CLI/report output).

    Branch lengths scale the horizontal extent; ``supports`` (node id ->
    value, e.g. from ``supports.alrt_supports``) annotates internal
    nodes.
    """
    depth = np.zeros(tree.n_nodes)
    order = [n for n in tree.postorder()][::-1]
    for n in order:
        p = int(tree.parent[n])
        if p != -1:
            depth[n] = depth[p] + max(float(tree.lengths[n]), 0.0)
    maxd = float(depth.max()) or 1.0
    name_w = max((len(n) for n in tree.leaf_names), default=0)
    plot_w = max(width - name_w - 2, 8)

    def col(n):
        return int(round(depth[n] / maxd * (plot_w - 1)))

    # leaf rows top-down in tree order; internal nodes centered
    row = {}
    next_row = 0
    for n in tree.postorder():
        if not tree.children[n]:
            row[n] = next_row
            next_row += 2
        else:
            kids = tree.children[n]
            row[n] = (row[kids[0]] + row[kids[-1]]) // 2
    height = next_row - 1
    grid = [[" "] * (plot_w + name_w + 2) for _ in range(height)]
    for n in range(tree.n_nodes):
        p = int(tree.parent[n])
        r, c = row[n], col(n)
        if p != -1:
            cp = col(p)
            for x in range(cp + 1, c):
                grid[r][x] = "-"
            grid[r][cp] = "+"
            # vertical connector on the parent's column
            lo, hi = sorted((row[p], r))
            for y in range(lo + 1, hi):
                if grid[y][cp] == " ":
                    grid[y][cp] = "|"
        if tree.children[n]:
            label = ""
            if supports and n in supports:
                label = f"{supports[n]:.2f}"
            elif tree.names[n]:
                label = tree.names[n]
            for k, ch in enumerate(label):
                if c + 1 + k < len(grid[r]):
                    grid[r][c + 1 + k] = ch
        else:
            name = tree.names[n]
            for k, ch in enumerate(" " + name):
                if c + k < len(grid[r]):
                    grid[r][c + k] = ch
    return "\n".join("".join(line).rstrip() for line in grid)
