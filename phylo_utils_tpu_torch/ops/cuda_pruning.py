"""Fused pruning on the GPU: the port of the whole-tree and big-tree paths
of ``phylo_utils_tpu.ops.pallas_pruning``.

Five hand-written CUDA kernels, compiled for 4 (DNA) and 20 (protein)
states, each with a plain-PyTorch version beside it that CPU tensors take (a
CUDA tensor launches the kernel or raises):

- ``forward_walk(..., walk="classic")`` (``csrc/pruning_forward.cu``,
  replaces the TPU kernel ``_dynamic_kernel``): a post-order walk that forms
  y_c = P_c . x_c per child, multiplies the y's, and rescales each node by an
  exact power of two with integer exponent counts; returns the root. Plain
  version ``forward_walk_reference``.
- ``slot_walk`` (``csrc/pruning_slot.cu``): the same walk in DFS post-order
  over reusable slots (``SlotSchedule``), so its scratch is O(depth) rows
  instead of one per internal node; ``pruning_slot_f32`` reads P from device
  memory (replaces ``_dynamic_slot_kernel``), ``pruning_stream_f32`` stages
  each node's P blocks in shared memory one node ahead (replaces
  ``_dynamic_slot_stream_kernel``). Both roots are bit for bit the forward
  kernel's. Plain version ``slot_walk_reference``. ``forward_walk`` picks
  among the three walks (``choose_walk``).
- ``saveall_walk`` (same source, replaces ``_dynamic_saveall_kernel``): the
  same walk keeping every internal node's partials and exponent count, the
  residuals of the gradient. Plain version ``saveall_walk_reference``.
- ``reverse_walk`` (``csrc/pruning_reverse.cu``, replaces
  ``_dynamic_bwd2_kernel``): the deferred-edge reverse walk from a root
  cotangent, then dP = sum_sites gy x^T per edge (and optionally the leaf
  partials' cotangent). Plain version ``reverse_walk_reference``.
- ``classic_reverse_walk`` (``csrc/pruning_classic_reverse.cu``, replaces
  ``_dynamic_bwd_kernel``): the classic reverse from any set of seeds, each
  child's dP summed inside the walk, outside vectors in the O(depth) slots
  of ``ReverseSchedule``; it stores no gy. Plain version
  ``classic_reverse_walk_reference``.

- ``static_walk`` (``csrc/pruning_static.cu``, replaces ``_static_kernel``):
  the classic walk compiled for one topology (``ops/_build.py`` builds it
  per tree and state count), every node id a compile-time constant; and
  ``fold_walk`` (``csrc/pruning_fold.cu``, replaces the category-fold and
  DNA-pack lowerings of ``_dynamic_kernel``): one thread walks F categories
  of a column, loading each leaf row once for all F. Both roots are bit for
  bit the forward kernel's; their plain version is
  ``forward_walk_reference``.

``forward_walk(walk="auto")`` picks the walk (``choose_walk``) and, where
that is the classic walk, its lowering as the JAX package's
``_pallas_forward`` does (``choose_lowering``: static while the internal
nodes are at most ``STATIC_UNROLL_MAX``, env ``PHYLO_STATIC_UNROLL_MAX``;
else the fold of 2 under ``PHYLO_PACK_DNA=1`` at 4 states, or of
``_pick_fold``'s F under ``PHYLO_FOLD_CATEGORIES``; else the forward
kernel). All three knobs are off by default.

``make_fused_loglik_fn`` ties them into a differentiable per-(category,
site) log-likelihood: value calls run ``forward_walk``; calls that need a
gradient run ``saveall_walk`` forward and, backward, ``reverse_walk`` while
its gy store fits the card, else ``classic_reverse_walk``
(``choose_reverse``, ``PHYLO_DEFERRED_VJP``). ``make_cuda_prune_fn`` is the
pruning function of the engines above ``LikelihoodEngine`` (root partials
and logscale): ``forward_walk`` forward, the plain pruner replayed under
autograd backward. ``LAUNCHES``, ``SLOT_LAUNCHES``, ``STREAM_LAUNCHES``,
``SAVEALL_LAUNCHES``, ``REVERSE_LAUNCHES``, ``CLASSIC_REVERSE_LAUNCHES``,
``STATIC_LAUNCHES`` and ``FOLD_LAUNCHES`` count kernel launches, so a run
can show its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from phylo_utils_tpu_torch.ops.pruning import (
    LN2,
    exp2_int,
    first_derivative_only,
    make_prune_fn,
    pow2_rescale,
)
from phylo_utils_tpu_torch.trees import PruningSchedule

__all__ = [
    "LAUNCHES",
    "SLOT_LAUNCHES",
    "STREAM_LAUNCHES",
    "SAVEALL_LAUNCHES",
    "REVERSE_LAUNCHES",
    "CLASSIC_REVERSE_LAUNCHES",
    "STATIC_LAUNCHES",
    "FOLD_LAUNCHES",
    "CLASSIC_SCRATCH_BUDGET",
    "STATIC_UNROLL_MAX",
    "FOLD_WIDTHS",
    "WalkSchedule",
    "SlotSchedule",
    "ReverseSchedule",
    "choose_walk",
    "choose_reverse",
    "choose_lowering",
    "forward_walk",
    "forward_walk_reference",
    "slot_walk",
    "slot_walk_reference",
    "static_walk",
    "fold_walk",
    "saveall_walk",
    "saveall_walk_reference",
    "reverse_walk",
    "reverse_walk_reference",
    "classic_reverse_walk",
    "classic_reverse_walk_reference",
    "classic_reverse_scratch",
    "make_fused_loglik_fn",
    "make_cuda_prune_fn",
]

LAUNCHES = 0                  # pruning_forward_f32
SLOT_LAUNCHES = 0             # pruning_slot_f32
STREAM_LAUNCHES = 0           # pruning_stream_f32
SAVEALL_LAUNCHES = 0          # pruning_saveall_f32
REVERSE_LAUNCHES = 0          # pruning_reverse_f32
CLASSIC_REVERSE_LAUNCHES = 0  # pruning_classic_reverse_f32
STATIC_LAUNCHES = 0           # pruning_static_f32
FOLD_LAUNCHES = 0             # pruning_fold_f32

# internal-node count up to which the classic walk is the topology-compiled
# static kernel (B8); read at import, as the JAX package reads it; 0 (the
# default) never
STATIC_UNROLL_MAX = int(os.environ.get("PHYLO_STATIC_UNROLL_MAX", "0"))
# the categories per thread the fold kernel (B9) is compiled for, by state
# count (csrc/pruning_fold.cu's FoldWidths): the widths ptxas takes without
# spills, where the TPU's fold stopped at its 128 lanes
FOLD_WIDTHS = {4: (2, 4), 20: (2, 3, 4, 5)}

# CUDA caps gridDim.z (the batch axis of the launch) at 65535
_MAX_GRID_Z = 65535
# share of the free device memory one launch's scratch may take
_MEM_FRACTION = 0.9
# the state counts the kernels are compiled for (DNA, protein)
_KERNEL_STATES = (4, 20)
# sites per block of the classic reverse kernel (its kThreads)
_CLASSIC_REVERSE_TILE = 256
# blocks per classic reverse launch, over (site rows, K, B): two per SM of
# an H100's 132; each block owns one dP partial row, so this caps the rows
_CLASSIC_REVERSE_BLOCKS = 264
# bytes of whole-tree scratch up to which the value path takes the classic
# walk (see choose_walk): the H100's 50 MB L2. On an NVIDIA H100 80GB HBM3
# (700 W) the classic walk was the fastest of the three at 5 and 21 MB of
# scratch (64-taxon DNA, B = 1 and 4) and the slot walk 26% faster than it
# at 83 MB (B = 16) (chip_smoke.py phase 16)
CLASSIC_SCRATCH_BUDGET = 50 * 2 ** 20


def _postorder_arrays(schedule: PruningSchedule):
    """Flatten the level schedule into per-internal-node post-order arrays.

    Levels are already a valid topological order; concatenating the real
    (non-padded) slots of each level in order gives a post-order walk.
    """
    order, children, counts = [], [], []
    cmax = schedule.n_children_max
    for lvl in range(schedule.n_levels):
        for w in range(schedule.width):
            node = int(schedule.level_nodes[lvl, w])
            if node >= schedule.n_nodes:  # padding slot
                continue
            mask = schedule.level_childmask[lvl, w]
            kids = [int(schedule.level_children[lvl, w, c])
                    for c in range(cmax) if mask[c] > 0]
            order.append(node)
            counts.append(len(kids))
            children.append(kids + [0] * (cmax - len(kids)))
    return (
        np.asarray(order, np.int32),
        np.asarray(children, np.int32).reshape(len(order), cmax),
        np.asarray(counts, np.int32),
    )


def _dfs_postorder(schedule: PruningSchedule):
    """(internal nodes in DFS post-order, {node: children}, cmax): the walk
    order of the JAX package's ``_dfs_slot_schedule``."""
    order, children, counts = _postorder_arrays(schedule)
    n_leaves = schedule.n_leaves
    kids = {
        int(order[i]): [int(children[i, c]) for c in range(int(counts[i]))]
        for i in range(order.shape[0])
    }
    post = []
    stack = [(int(order[-1]), False)]
    while stack:
        node, done = stack.pop()
        if node < n_leaves:
            continue
        if done:
            post.append(node)
        else:
            stack.append((node, True))
            for ch in kids[node]:
                stack.append((ch, False))
    return post, kids, children.shape[1]


def _dfs_slot_schedule(schedule: PruningSchedule):
    """DFS-post-order walk with register-style slot allocation (array for
    array the JAX package's ``_dfs_slot_schedule``).

    In DFS post-order a node's partials are dead as soon as its parent is
    combined, so a free list assigns each internal node a reusable slot (a
    node may take one of its children's); the live set is O(tree depth).
    Leaves never get slots.

    Returns ``(nslot, child_node, child_src, child_isleaf, counts,
    n_slots, root_slot)`` where ``child_node`` indexes P and ``child_src``
    is a leaf id or a slot id according to ``child_isleaf``.
    """
    post, kids, cmax = _dfs_postorder(schedule)
    n_leaves = schedule.n_leaves
    root = post[-1]
    slot_of: dict = {}
    free: list = []
    next_slot = 0
    nn = len(post)
    nslot = np.zeros(nn, np.int32)
    child_node = np.zeros((nn, cmax), np.int32)
    child_src = np.zeros((nn, cmax), np.int32)
    child_isleaf = np.zeros((nn, cmax), np.int32)
    counts2 = np.zeros(nn, np.int32)
    for i, node in enumerate(post):
        ks = kids[node]
        counts2[i] = len(ks)
        for c, ch in enumerate(ks):
            child_node[i, c] = ch
            if ch < n_leaves:
                child_src[i, c] = ch
                child_isleaf[i, c] = 1
            else:
                child_src[i, c] = slot_of[ch]
        # children slots die here; the parent may reuse one
        for ch in ks:
            if ch >= n_leaves:
                free.append(slot_of.pop(ch))
        if free:
            s = free.pop()
        else:
            s = next_slot
            next_slot += 1
        slot_of[node] = s
        nslot[i] = s
    return (
        nslot, child_node, child_src, child_isleaf, counts2,
        next_slot, slot_of[root],
    )


def _gslot_schedule(schedule: PruningSchedule):
    """The classic reverse walk's order and its outside-vector slots.

    The walk visits the internal nodes in the reverse of the DFS post-order
    (a pre-order). A node's outside vector g is written when its parent is
    visited and read first thing when the node itself is, so a free list
    gives it a slot only between the two; the node's slot is free again
    once read, and one of its children may take it. Live g's are at most
    the unvisited siblings along the current path plus one node's
    children: O(depth x cmax) slots. Leaves get none (their g is dleaf).

    Returns ``(rnode, gslot, children, cslot, counts, n_gslots)``: visit i
    reads g of ``rnode[i]`` from slot ``gslot[i]`` (-1: the node has no
    parent, the root) and writes g of child ``children[i, c]`` to slot
    ``cslot[i, c]`` (-1 for a leaf).
    """
    post, kids, cmax = _dfs_postorder(schedule)
    n_leaves = schedule.n_leaves
    nn = len(post)
    rnode = np.zeros(nn, np.int32)
    gslot = np.full(nn, -1, np.int32)
    children = np.zeros((nn, cmax), np.int32)
    cslot = np.full((nn, cmax), -1, np.int32)
    counts = np.zeros(nn, np.int32)
    slot_of: dict = {}
    free: list = []
    next_slot = 0
    for i, node in enumerate(reversed(post)):
        rnode[i] = node
        counts[i] = len(kids[node])
        if node in slot_of:
            gslot[i] = slot_of.pop(node)
            free.append(int(gslot[i]))
        for c, ch in enumerate(kids[node]):
            children[i, c] = ch
            if ch >= n_leaves:
                if free:
                    s = free.pop()
                else:
                    s = next_slot
                    next_slot += 1
                slot_of[ch] = s
                cslot[i, c] = s
    return rnode, gslot, children, cslot, counts, next_slot


def _on_device(cache: dict, device: torch.device, arrays):
    """``arrays`` as contiguous int32 tensors on ``device``, made once."""
    if device not in cache:
        cache[device] = tuple(torch.from_numpy(a).to(device).contiguous()
                              for a in arrays)
    return cache[device]


class SlotSchedule:
    """The DFS slot walk of one schedule (``_dfs_slot_schedule``): host
    arrays plus their int32 copies on each device that has used them."""

    def __init__(self, schedule: PruningSchedule):
        (self.nslot, self.child_node, self.child_src, self.child_isleaf,
         self.counts, self.n_slots, self.root_slot) = _dfs_slot_schedule(
            schedule)
        self._on_device = {}

    def on(self, device: torch.device):
        """(nslot, child_node, child_src, child_isleaf, counts) on device."""
        return _on_device(self._on_device, device, (
            self.nslot, self.child_node, self.child_src, self.child_isleaf,
            self.counts))


class ReverseSchedule:
    """The classic reverse walk of one schedule (``_gslot_schedule``): host
    arrays plus their int32 copies on each device that has used them."""

    def __init__(self, schedule: PruningSchedule):
        (self.rnode, self.gslot, self.children, self.cslot, self.counts,
         self.n_gslots) = _gslot_schedule(schedule)
        self.n_nodes = schedule.n_nodes
        self._on_device = {}

    def on(self, device: torch.device):
        """(rnode, gslot, children, cslot, counts) on device."""
        return _on_device(self._on_device, device, (
            self.rnode, self.gslot, self.children, self.cslot, self.counts))

    def node_seed(self, seed_ids: np.ndarray, device: torch.device):
        """(n_nodes,) int32 on device: j where node == seed_ids[j], else -1
        (made once per seed set and device)."""
        key = ("seed", tuple(seed_ids.tolist()))
        if (device, key) not in self._on_device:
            arr = np.full(self.n_nodes, -1, np.int32)
            arr[seed_ids] = np.arange(len(seed_ids), dtype=np.int32)
            self._on_device[(device, key)] = torch.from_numpy(arr).to(device)
        return self._on_device[(device, key)]


class WalkSchedule:
    """The post-order walk of one schedule: host arrays plus their int32
    copies on each device that has used them, and (built at first use) the
    schedule's DFS slot walk, ``slots``, its classic reverse walk,
    ``reverse``, and its topology-compiled kernel library per state count,
    ``static_library``."""

    def __init__(self, schedule: PruningSchedule):
        self.order, self.children, self.counts = _postorder_arrays(schedule)
        if len(self.order) == 0:
            raise ValueError("the tree has no internal node to walk")
        self.n_nodes = schedule.n_nodes
        self.n_leaves = schedule.n_leaves
        self.root = int(self.order[-1])    # the root is last in post-order
        self._schedule = schedule
        self._slots = None
        self._reverse = None
        self._static = {}
        self._on_device = {}

    def static_library(self, s: int):
        """B8's library for this topology at ``s`` states (built by
        ``_build.load_static_library`` at first use)."""
        if s not in self._static:
            from phylo_utils_tpu_torch.ops._build import load_static_library

            self._static[s] = load_static_library(
                self.order, self.children, self.counts, self.n_nodes,
                self.n_leaves, s)
        return self._static[s]

    @property
    def slots(self) -> SlotSchedule:
        if self._slots is None:
            self._slots = SlotSchedule(self._schedule)
        return self._slots

    @property
    def reverse(self) -> ReverseSchedule:
        if self._reverse is None:
            self._reverse = ReverseSchedule(self._schedule)
        return self._reverse

    def on(self, device: torch.device):
        """(order, children, counts) as contiguous int32 tensors on device."""
        return _on_device(self._on_device, device,
                          (self.order, self.children, self.counts))


def _check(p: torch.Tensor, leaves: torch.Tensor, walk: WalkSchedule):
    if p.dim() not in (4, 5):
        raise ValueError(
            f"P must be (n_nodes, K, S, S) or (B, n_nodes, K, S, S); got "
            f"{tuple(p.shape)}"
        )
    if leaves.dim() != 3:
        raise ValueError(
            f"leaves must be (n_leaves, sites, S); got {tuple(leaves.shape)}"
        )
    s = leaves.shape[2]
    if p.shape[-4] != walk.n_nodes or p.shape[-2:] != (s, s):
        raise ValueError(
            f"P {tuple(p.shape)} does not match {walk.n_nodes} nodes x "
            f"{s} states"
        )
    if leaves.shape[0] != walk.n_leaves:
        raise ValueError(
            f"leaves has {leaves.shape[0]} rows; the tree has "
            f"{walk.n_leaves} leaves"
        )
    if p.dtype != torch.float32 or leaves.dtype != torch.float32:
        raise TypeError(
            f"the pruning walk takes float32; got P {p.dtype}, leaves "
            f"{leaves.dtype}"
        )
    if p.device != leaves.device:
        raise ValueError(
            f"P is on {p.device} but leaves are on {leaves.device}"
        )


def _not_differentiable(name: str, *tensors: torch.Tensor):
    """The walks are not autograd functions themselves: a caller that wants
    a gradient goes through ``make_fused_loglik_fn``, whose backward is the
    reverse kernel. (Inside that Function's forward grad mode is off.)"""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} is not differentiable; differentiate through "
            "make_fused_loglik_fn (saveall + reverse kernels)"
        )


def _node_partials(pb, leaves, n_leaves, kids, x_of, e_of):
    """One node of the plain walk: (rescaled partials, exponent count) from
    its children, batched over (B, K, sites)."""
    acc, esum = None, None
    for c in kids:
        if c < n_leaves:
            y = torch.einsum("bkij,sj->bksi", pb[:, c], leaves[c])
        else:
            y = torch.einsum("bkij,bksj->bksi", pb[:, c], x_of(c))
            ec = e_of(c)
            esum = ec if esum is None else esum + ec
        acc = y if acc is None else acc * y
    tiny = torch.finfo(torch.float32).tiny
    scale, en = pow2_rescale(acc.amax(dim=-1).clamp_min(tiny))
    return acc * scale[..., None], (en if esum is None else esum + en)


def _walk_nodes(walk: WalkSchedule):
    """(node, real children) in post-order."""
    return [(node, kids[:cnt]) for node, kids, cnt in zip(
        walk.order.tolist(), walk.children.tolist(), walk.counts.tolist())]


def forward_walk_reference(
    p: torch.Tensor, leaves: torch.Tensor, walk: WalkSchedule
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch version of the forward kernel: the same post-order walk
    with the same rescale, vectorised over (batch, category, site).

    ``p`` (n_nodes, K, S, S) or (B, n_nodes, K, S, S), float32;
    ``leaves`` (n_leaves, sites, S), float32. Returns the root partials
    (B?, K, sites, S) and the root exponent count (B?, K, sites), float32.
    """
    _check(p, leaves, walk)
    batched = p.dim() == 5
    pb = p if batched else p[None]
    x, e = {}, {}
    for node, kids in _walk_nodes(walk):
        x[node], e[node] = _node_partials(pb, leaves, walk.n_leaves, kids,
                                          x.pop, e.pop)
    root_p, root_e = x[walk.root], e[walk.root]
    return (root_p, root_e) if batched else (root_p[0], root_e[0])


def slot_walk_reference(
    p: torch.Tensor, leaves: torch.Tensor, walk: WalkSchedule
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch version of the slot and stream kernels: the DFS
    post-order walk over ``walk.slots``, each node written to its slot
    (perhaps a child's) after its children are read, vectorised over (batch,
    category, site). Same contract as ``forward_walk_reference``, and bit
    for bit its result: the per-node arithmetic and child order are the
    same, only the order of independent subtrees differs.
    """
    _check(p, leaves, walk)
    batched = p.dim() == 5
    pb = p if batched else p[None]
    sl = walk.slots
    x = [None] * sl.n_slots
    e = [None] * sl.n_slots
    for i in range(len(sl.nslot)):
        kids = sl.child_node[i, :sl.counts[i]].tolist()
        src = dict(zip(kids, sl.child_src[i, :sl.counts[i]].tolist()))
        xi, ei = _node_partials(pb, leaves, walk.n_leaves, kids,
                                lambda c: x[src[c]], lambda c: e[src[c]])
        x[sl.nslot[i]], e[sl.nslot[i]] = xi, ei
    root_p, root_e = x[sl.root_slot], e[sl.root_slot]
    return (root_p, root_e) if batched else (root_p[0], root_e[0])


def saveall_walk_reference(
    p: torch.Tensor, leaves: torch.Tensor, walk: WalkSchedule
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch version of the saveall kernel: the forward walk keeping
    every internal node, the root included.

    Returns ``res_x`` (B?, K, n_inner, sites, S) and ``res_e`` (B?, K,
    n_inner, sites), float32, indexed by node id - n_leaves
    (n_inner = n_nodes - n_leaves).
    """
    _check(p, leaves, walk)
    batched = p.dim() == 5
    pb = p if batched else p[None]
    n_leaves = walk.n_leaves
    b, _, k = pb.shape[:3]
    sites, s = leaves.shape[1:]
    n_inner = walk.n_nodes - n_leaves
    res_x = pb.new_empty((b, k, n_inner, sites, s))
    res_e = pb.new_empty((b, k, n_inner, sites))
    for node, kids in _walk_nodes(walk):
        res_x[:, :, node - n_leaves], res_e[:, :, node - n_leaves] = (
            _node_partials(pb, leaves, n_leaves, kids,
                           lambda c: res_x[:, :, c - n_leaves],
                           lambda c: res_e[:, :, c - n_leaves]))
    return (res_x, res_e) if batched else (res_x[0], res_e[0])


def _check_residuals(p, leaves, res_x, res_e, walk, freqs=None,
                     **cotangents):
    """Shapes, dtype and device of the reverse walks' inputs: the
    residuals, ``freqs`` (S,) when given, and each of ``cotangents``,
    ``name=(tensor, its shape after the batch dims of P)``."""
    _check(p, leaves, walk)
    lead = tuple(p.shape[:-4])
    k, sites, s = p.shape[-3], leaves.shape[1], leaves.shape[2]
    n_inner = walk.n_nodes - walk.n_leaves
    want = {
        "res_x": (res_x, lead + (k, n_inner, sites, s)),
        "res_e": (res_e, lead + (k, n_inner, sites)),
    }
    want.update({name: (t, lead + shape)
                 for name, (t, shape) in cotangents.items()})
    if freqs is not None:
        want["freqs"] = (freqs, (s,))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {t.dtype}")
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, P on {p.device}")


def _child_terms(pb, leaves, rx, n_leaves):
    """(x_of, y_of) of the plain reverse walks: a node's partials (a leaf
    row or its residual) and y = P x, batched over (B, K, sites)."""

    def x_of(c):
        return leaves[c] if c < n_leaves else rx[:, :, c - n_leaves]

    def y_of(c):
        eq = "bkij,sj->bksi" if c < n_leaves else "bkij,bksj->bksi"
        return torch.einsum(eq, pb[:, c], x_of(c))

    return x_of, y_of


def reverse_walk_reference(
    p: torch.Tensor, leaves: torch.Tensor, res_x: torch.Tensor,
    res_e: torch.Tensor, lam: torch.Tensor, freqs: torch.Tensor,
    walk: WalkSchedule, want_dleaf: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain-PyTorch version of the reverse kernel: an explicit pre-order
    walk vectorised over (batch, category, site), with the kernel's math
    (not autograd).

    ``res_x``/``res_e``: ``saveall_walk``'s residuals; ``lam`` (B?, K,
    sites): the root cotangent ct / (pi . x_root); ``freqs`` (S,). All
    float32. Returns ``dp`` (B?, n_nodes, K, S, S), the layout of P, with a
    zero root row, and, when ``want_dleaf``, ``dleaf`` (B?, K, n_leaves,
    sites, S) = P_l^T gy_l per leaf (else None).
    """
    _check_residuals(p, leaves, res_x, res_e, walk, freqs=freqs,
                     lam=(lam, (p.shape[-3], leaves.shape[1])))
    batched = p.dim() == 5
    pb, rx, re, lm = ((p, res_x, res_e, lam) if batched else
                      (p[None], res_x[None], res_e[None], lam[None]))
    n_leaves = walk.n_leaves
    x_of, y_of = _child_terms(pb, leaves, rx, n_leaves)
    gy = {}
    for node, kids in reversed(_walk_nodes(walk)):
        if node == walk.root:
            g = lm[..., None] * freqs
        else:
            g = torch.einsum("bkji,bksj->bksi", pb[:, node], gy[node])
        esum = torch.zeros_like(lm)
        for c in kids:
            if c >= n_leaves:
                esum = esum + re[:, :, c - n_leaves]
        inv_m = exp2_int(esum - re[:, :, node - n_leaves])[..., None]
        for c in kids:
            sib = torch.ones_like(g)
            for c2 in kids:
                if c2 != c:
                    sib = sib * y_of(c2)
            gy[c] = g * sib * inv_m
    dp = torch.zeros_like(pb)
    for node, g in gy.items():
        eq = "bksi,sj->bkij" if node < n_leaves else "bksi,bksj->bkij"
        dp[:, node] = torch.einsum(eq, g, x_of(node))
    dleaf = None
    if want_dleaf:
        dleaf = torch.stack([
            torch.einsum("bkji,bksj->bksi", pb[:, leaf], gy[leaf])
            for leaf in range(n_leaves)], dim=2)
    if not batched:
        dp = dp[0]
        dleaf = None if dleaf is None else dleaf[0]
    return dp, dleaf


def _seed_array(seed_ids, walk: WalkSchedule) -> np.ndarray:
    seeds = np.asarray(seed_ids, dtype=np.int64).reshape(-1)
    if (seeds.size == 0 or len(set(seeds.tolist())) != seeds.size
            or seeds.min() < 0 or seeds.max() >= walk.n_nodes):
        raise ValueError(
            f"seed_ids must be distinct node ids in [0, {walk.n_nodes}); "
            f"got {seeds.tolist()}")
    return seeds.astype(np.int32)


def _check_classic(p, leaves, res_x, res_e, gseeds, seeds, walk):
    _check_residuals(p, leaves, res_x, res_e, walk, gseeds=(
        gseeds, (p.shape[-3], len(seeds)) + tuple(leaves.shape[1:])))


def classic_reverse_walk_reference(
    p: torch.Tensor, leaves: torch.Tensor, res_x: torch.Tensor,
    res_e: torch.Tensor, gseeds: torch.Tensor, seed_ids: Sequence[int],
    walk: WalkSchedule, want_dleaf: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain-PyTorch version of the classic reverse kernel, the math of the
    JAX package's ``_dynamic_bwd_kernel``, vectorised over (batch,
    category, site).

    Outside vectors g start at zero, with g[seed_ids[j]] = gseeds[..., j,
    :, :]; then, for every internal node n in pre-order (``walk.reverse``),
    with y_c = P_c x_c for each child c and inv_m = 2^(sum_c e_c - e_n):
        gy_c = g_n prod_{c' != c} y_c' inv_m,
        dP[c] += sum_sites gy_c x_c^T,      g_c += P_c^T gy_c.
    ``res_x``/``res_e``: ``saveall_walk``'s residuals; ``gseeds`` (B?, K,
    n_seed, sites, S) the cotangents of the seeds' rescaled partials; all
    float32. Returns ``dp`` (B?, n_nodes, K, S, S), the layout of P, with
    rows only for children (the root's stays zero), and, when
    ``want_dleaf``, ``dleaf`` (B?, K, n_leaves, sites, S) = g of the leaves
    (else None). With one seed at the root, gseeds = lambda pi, it gives
    ``reverse_walk_reference``'s result bit for bit: the per-node
    arithmetic is the same.
    """
    seeds = _seed_array(seed_ids, walk)
    _check_classic(p, leaves, res_x, res_e, gseeds, seeds, walk)
    batched = p.dim() == 5
    pb, rx, re, gs = ((p, res_x, res_e, gseeds) if batched else
                      (p[None], res_x[None], res_e[None], gseeds[None]))
    n_leaves = walk.n_leaves
    x_of, y_of = _child_terms(pb, leaves, rx, n_leaves)
    seed_of = {int(node): j for j, node in enumerate(seeds)}
    g = {node: gs[:, :, j] for node, j in seed_of.items()}
    dp = torch.zeros_like(pb)
    rs = walk.reverse
    for i, node in enumerate(rs.rnode.tolist()):
        kids = rs.children[i, :rs.counts[i]].tolist()
        gn = g.pop(node, None)
        if gn is None:       # neither a seed nor reached from one
            gn = torch.zeros_like(gs[:, :, 0])
        esum = torch.zeros_like(re[:, :, 0])
        for c in kids:
            if c >= n_leaves:
                esum = esum + re[:, :, c - n_leaves]
        inv_m = exp2_int(esum - re[:, :, node - n_leaves])[..., None]
        for c in kids:
            sib = torch.ones_like(gn)
            for c2 in kids:
                if c2 != c:
                    sib = sib * y_of(c2)
            gy = gn * sib * inv_m
            eq = "bksi,sj->bkij" if c < n_leaves else "bksi,bksj->bkij"
            dp[:, c] += torch.einsum(eq, gy, x_of(c))
            gc = torch.einsum("bkji,bksj->bksi", pb[:, c], gy)
            g[c] = gc + g[c] if c in g else gc
    dleaf = None
    if want_dleaf:
        dleaf = torch.stack([g[leaf] for leaf in range(n_leaves)], dim=2)
    if not batched:
        dp = dp[0]
        dleaf = None if dleaf is None else dleaf[0]
    return dp, dleaf


def _device_budget(need: int, device: torch.device) -> int:
    """Bytes a launch may allocate on ``device``: torch's unused cached
    blocks when they already hold ``need`` (no device query), else
    ``_MEM_FRACTION`` of free plus cached memory.

    ``torch.cuda.mem_get_info`` took from 0.02 to 2.5 ms of host time per
    call on an NVIDIA H100 80GB HBM3 (700 W limit), against 0.055 ms for the
    B = 1 flagship kernel, so the steady state of repeated calls (which free
    their scratch) skips it. The allocator's stats are read once:
    ``memory_reserved`` and ``memory_allocated`` each flatten and sort the
    whole stats dict."""
    stats = torch.cuda.memory_stats_as_nested_dict(device)
    cached = (stats["reserved_bytes"]["all"]["current"]
              - stats["allocated_bytes"]["all"]["current"])
    if need <= cached:
        return cached
    free, _ = torch.cuda.mem_get_info(device)
    return int(_MEM_FRACTION * (free + cached))


def _batch_chunk(b: int, bytes_per_b: int, device: torch.device) -> int:
    """How many batch elements one launch may take so its scratch fits the
    device memory that is free now; raises when not even one fits."""
    budget = _device_budget(b * bytes_per_b, device)
    if bytes_per_b > budget:
        raise MemoryError(
            f"the pruning walk needs {bytes_per_b} bytes of scratch per "
            f"batch element but only {budget} bytes are free on {device}; "
            "use fewer sites per call"
        )
    return min(b, budget // bytes_per_b, _MAX_GRID_Z)


def _check_cuda(p: torch.Tensor, *tensors: torch.Tensor):
    """Raises on CUDA inputs the kernels do not take."""
    if p.device.type != "cuda":
        raise ValueError(f"the pruning kernels run on cpu or cuda, not "
                         f"{p.device}")
    if not all(t.is_contiguous() for t in (p,) + tensors):
        raise ValueError("the kernels' inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (p,) + tensors):
        raise ValueError("the kernels' inputs must be 16-byte aligned")
    s = p.shape[-1]
    if s not in _KERNEL_STATES:
        raise NotImplementedError(
            f"the CUDA walks are built for {_KERNEL_STATES} states, not {s} "
            "(codon is ROADMAP A14)"
        )


def _cuda_library(p: torch.Tensor, *tensors: torch.Tensor):
    """The kernels' library for CUDA inputs; raises on what they do not
    take."""
    _check_cuda(p, *tensors)
    from phylo_utils_tpu_torch.ops._build import load_library

    return load_library()


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def choose_walk(b: int, k: int, n_inner: int, sites: int, s: int) -> str:
    """The value path's walk for a launch of ``b`` batch elements, ``k``
    categories, ``n_inner`` internal nodes, ``sites`` sites, ``s`` states.

    The classic walk while its whole-tree scratch, b k n_inner sites (s + 1)
    float32, fits ``CLASSIC_SCRATCH_BUDGET`` bytes; beyond that the O(depth)
    slot walk, with P staged in shared memory ("stream") at 20 states and
    more, read from device memory ("slot") below.
    """
    if b * k * n_inner * sites * (s + 1) * 4 <= CLASSIC_SCRATCH_BUDGET:
        return "classic"
    return "stream" if s >= 20 else "slot"


def _pick_fold(k: int, s: int) -> int:
    """Categories per thread of the fold lowering under
    ``PHYLO_FOLD_CATEGORIES``, with the JAX package's ``_pick_fold``
    semantics: "0" (the default) 1; "auto" as many as divide ``k``, at 20
    states only; "<int>" at most that many. The widest F is the widest
    ``FOLD_WIDTHS`` compiles at ``s`` (the TPU's was 128 lanes), and F must
    divide ``k``: a K that no compiled F divides is not folded (never
    padded)."""
    env = os.environ.get("PHYLO_FOLD_CATEGORIES", "0")
    widths = FOLD_WIDTHS.get(s, ())
    if env == "0" or k <= 1 or not widths:
        return 1
    if env == "auto":
        if s < 16:
            return 1
        f = k
    else:
        f = min(int(env), k)
    while f > 1 and (k % f or f not in widths):
        f -= 1
    return max(f, 1)


def choose_lowering(k: int, n_int: int, s: int) -> Tuple[str, int]:
    """The classic walk's lowering, by the precedence of the JAX package's
    ``_pallas_forward``: ("static", 1) while ``n_int`` internal nodes are at
    most ``STATIC_UNROLL_MAX``; else ("fold", 2) under ``PHYLO_PACK_DNA=1``
    at 4 states with ``k`` even (JAX's pack is a fold of 2); else ("fold",
    F) when ``_pick_fold`` gives F > 1; else ("classic", 1), the forward
    kernel."""
    if n_int <= STATIC_UNROLL_MAX:
        return "static", 1
    if (os.environ.get("PHYLO_PACK_DNA", "0") == "1" and s == 4
            and k >= 2 and k % 2 == 0):
        return "fold", 2
    fold = _pick_fold(k, s)
    return ("fold", fold) if fold > 1 else ("classic", 1)


_WALKS = ("auto", "classic", "slot", "stream")


def forward_walk(
    p: torch.Tensor, leaves: torch.Tensor, schedule: WalkSchedule,
    walk: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Root partials and root exponent count of the pruning walk.

    Same contract as ``forward_walk_reference``. ``walk``: "classic" (every
    internal node kept, the forward kernel), "slot" or "stream"
    (``slot_walk``), or "auto": ``choose_walk``, and where that gives the
    classic walk, ``choose_lowering`` (``static_walk``, ``fold_walk`` or the
    forward kernel). All give the same bits. CPU tensors take the plain
    versions; CUDA tensors launch the kernel (one launch per batch chunk
    that fits free device memory) on the current stream.
    """
    if walk not in _WALKS:
        raise ValueError(f"walk must be one of {_WALKS}, not {walk!r}")
    _check(p, leaves, schedule)
    _not_differentiable("forward_walk", p, leaves)
    b = p.shape[0] if p.dim() == 5 else 1
    k = p.shape[-3]
    sites, s = leaves.shape[1:]
    n_inner = schedule.n_nodes - schedule.n_leaves
    if walk == "auto":
        walk = choose_walk(b, k, n_inner, sites, s)
        if walk == "classic":
            lowering, fold = choose_lowering(k, len(schedule.order), s)
            if lowering == "static":
                return static_walk(p, leaves, schedule)
            if lowering == "fold":
                return fold_walk(p, leaves, schedule, fold)
    if walk != "classic":
        return slot_walk(p, leaves, schedule, stream=walk == "stream")
    if p.device.type == "cpu":
        return forward_walk_reference(p, leaves, schedule)
    return _classic_launch("forward", _cuda_library(p, leaves), p, leaves,
                           schedule)


def _classic_launch(kind: str, lib, p, leaves, walk: WalkSchedule,
                    fold: int = 1):
    """Root and root exponent count from B1 ("forward"), B9 ("fold", ``fold``
    categories a thread) or B8 ("static", ``lib`` the topology's library):
    the same scratch, (B, K, n_inner, sites, S + 1) float32, one launch per
    batch chunk that fits free device memory, on the current stream."""
    global LAUNCHES, FOLD_LAUNCHES, STATIC_LAUNCHES
    batched = p.dim() == 5
    pb = p if batched else p[None]
    b, _, k = pb.shape[:3]
    sites, s = leaves.shape[1:]
    n_inner = walk.n_nodes - walk.n_leaves
    n_int = len(walk.order)
    device = p.device
    order, children, counts = walk.on(device)
    cmax = children.shape[1]
    root = torch.empty((b, k, sites, s), dtype=torch.float32, device=device)
    root_e = torch.empty((b, k, sites), dtype=torch.float32, device=device)
    chunk = _batch_chunk(b, k * n_inner * sites * (s + 1) * 4, device)
    stream = _stream(device)
    for b0 in range(0, b, chunk):
        nb = min(chunk, b - b0)
        scratch = torch.empty((nb, k, n_inner, sites, s),
                              dtype=torch.float32, device=device)
        scratch_e = torch.empty((nb, k, n_inner, sites),
                                dtype=torch.float32, device=device)
        ptrs = (scratch.data_ptr(), scratch_e.data_ptr(),
                root[b0:b0 + nb].data_ptr(), root_e[b0:b0 + nb].data_ptr())
        walk_ptrs = (order.data_ptr(), children.data_ptr(),
                     counts.data_ptr())
        if kind == "static":
            name = "pruning_static_f32"
            rc = lib.pruning_static_f32(
                pb[b0:b0 + nb].data_ptr(), leaves.data_ptr(), *ptrs, nb, k,
                s, walk.n_nodes, walk.n_leaves, n_int, sites, stream)
        elif kind == "fold":
            name = "pruning_fold_f32"
            rc = lib.pruning_fold_f32(
                pb[b0:b0 + nb].data_ptr(), leaves.data_ptr(), *walk_ptrs,
                *ptrs, nb, k, s, fold, walk.n_nodes, walk.n_leaves, n_int,
                cmax, sites, stream)
        else:
            name = "pruning_forward_f32"
            rc = lib.pruning_forward_f32(
                pb[b0:b0 + nb].data_ptr(), leaves.data_ptr(), *walk_ptrs,
                *ptrs, nb, k, s, walk.n_nodes, walk.n_leaves, n_int, cmax,
                sites, stream)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
        if kind == "static":
            STATIC_LAUNCHES += 1
        elif kind == "fold":
            FOLD_LAUNCHES += 1
        else:
            LAUNCHES += 1
        del scratch, scratch_e
    return (root, root_e) if batched else (root[0], root_e[0])


def static_walk(
    p: torch.Tensor, leaves: torch.Tensor, walk: WalkSchedule
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Root partials and root exponent count by the walk compiled for this
    topology (B8, ``pruning_static_f32``). Same contract as
    ``forward_walk_reference`` and the forward kernel's bits. CPU tensors
    take ``forward_walk_reference``; CUDA tensors build the topology's
    library at first use (``WalkSchedule.static_library``; no fallback when
    the build fails) and launch it."""
    _check(p, leaves, walk)
    _not_differentiable("static_walk", p, leaves)
    if p.device.type == "cpu":
        return forward_walk_reference(p, leaves, walk)
    _check_cuda(p, leaves)
    return _classic_launch("static", walk.static_library(leaves.shape[2]),
                           p, leaves, walk)


def fold_walk(
    p: torch.Tensor, leaves: torch.Tensor, walk: WalkSchedule, fold: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Root partials and root exponent count with ``fold`` categories per
    thread (B9, ``pruning_fold_f32``; the DNA pack is ``fold=2`` at 4
    states). Same contract as ``forward_walk_reference`` and the forward
    kernel's bits. ``fold`` must divide K and, on the card, be one of
    ``FOLD_WIDTHS`` at the state count. CPU tensors take
    ``forward_walk_reference``."""
    _check(p, leaves, walk)
    _not_differentiable("fold_walk", p, leaves)
    k, s = p.shape[-3], leaves.shape[2]
    if fold < 1 or k % fold:
        raise ValueError(f"fold {fold} does not divide {k} categories")
    if p.device.type == "cpu":
        return forward_walk_reference(p, leaves, walk)
    lib = _cuda_library(p, leaves)
    if fold not in FOLD_WIDTHS[s]:
        raise NotImplementedError(
            f"pruning_fold_f32 is compiled for {FOLD_WIDTHS[s]} categories "
            f"per thread at {s} states, not {fold}")
    return _classic_launch("fold", lib, p, leaves, walk, fold)


def slot_walk(
    p: torch.Tensor, leaves: torch.Tensor, walk: WalkSchedule,
    stream: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Root partials and root exponent count by the DFS slot walk, whose
    scratch is (B, K, n_slots, sites, S + 1) float32 instead of one row per
    internal node. Same contract as ``forward_walk_reference`` and the same
    bits. CPU tensors take ``slot_walk_reference``; CUDA tensors launch
    ``pruning_stream_f32`` (``stream``: P staged in shared memory) or
    ``pruning_slot_f32``, once per batch chunk that fits free device
    memory, on the current stream."""
    global SLOT_LAUNCHES, STREAM_LAUNCHES
    _check(p, leaves, walk)
    _not_differentiable("slot_walk", p, leaves)
    if p.device.type == "cpu":
        return slot_walk_reference(p, leaves, walk)
    lib = _cuda_library(p, leaves)
    batched = p.dim() == 5
    pb = p if batched else p[None]
    b, _, k = pb.shape[:3]
    sites, s = leaves.shape[1:]
    device = p.device
    sl = walk.slots
    nslot, cnode, csrc, cleaf, counts = sl.on(device)
    root = torch.empty((b, k, sites, s), dtype=torch.float32, device=device)
    root_e = torch.empty((b, k, sites), dtype=torch.float32, device=device)
    chunk = _batch_chunk(b, k * sl.n_slots * sites * (s + 1) * 4, device)
    name = "pruning_stream_f32" if stream else "pruning_slot_f32"
    launch = getattr(lib, name)
    cuda_stream = _stream(device)
    for b0 in range(0, b, chunk):
        nb = min(chunk, b - b0)
        slots = torch.empty((nb, k, sl.n_slots, sites, s),
                            dtype=torch.float32, device=device)
        slots_e = torch.empty((nb, k, sl.n_slots, sites),
                              dtype=torch.float32, device=device)
        rc = launch(
            pb[b0:b0 + nb].data_ptr(), leaves.data_ptr(), nslot.data_ptr(),
            cnode.data_ptr(), csrc.data_ptr(), cleaf.data_ptr(),
            counts.data_ptr(), slots.data_ptr(), slots_e.data_ptr(),
            root[b0:b0 + nb].data_ptr(), root_e[b0:b0 + nb].data_ptr(), nb,
            k, s, walk.n_nodes, sl.n_slots, len(sl.nslot), cnode.shape[1],
            sites, cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
        if stream:
            STREAM_LAUNCHES += 1
        else:
            SLOT_LAUNCHES += 1
        del slots, slots_e
    return (root, root_e) if batched else (root[0], root_e[0])


def saveall_walk(
    p: torch.Tensor, leaves: torch.Tensor, walk: WalkSchedule
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every internal node's partials and exponent count (the gradient's
    residuals). Same contract as ``saveall_walk_reference``; CUDA tensors
    launch the saveall kernel. The residuals of the whole batch are one
    output, so they must fit free device memory at once (else
    ``MemoryError``); launches split only at the grid's batch limit."""
    global SAVEALL_LAUNCHES
    _check(p, leaves, walk)
    _not_differentiable("saveall_walk", p, leaves)
    if p.device.type == "cpu":
        return saveall_walk_reference(p, leaves, walk)
    lib = _cuda_library(p, leaves)
    batched = p.dim() == 5
    pb = p if batched else p[None]
    b, _, k = pb.shape[:3]
    sites, s = leaves.shape[1:]
    n_inner = walk.n_nodes - walk.n_leaves
    device = p.device
    need = b * k * n_inner * sites * (s + 1) * 4
    budget = _device_budget(need, device)
    if need > budget:
        raise MemoryError(
            f"the gradient's residuals need {need} bytes but only {budget} "
            f"bytes are free on {device}; they bound the whole-tree "
            "gradient (past the deferred reverse's gy store the classic "
            "reverse runs, which stores none): use fewer sites or a "
            "smaller batch"
        )
    order, children, counts = walk.on(device)
    res_x = torch.empty((b, k, n_inner, sites, s), dtype=torch.float32,
                        device=device)
    res_e = torch.empty((b, k, n_inner, sites), dtype=torch.float32,
                        device=device)
    stream = _stream(device)
    for b0 in range(0, b, _MAX_GRID_Z):
        nb = min(_MAX_GRID_Z, b - b0)
        rc = lib.pruning_saveall_f32(
            pb[b0:b0 + nb].data_ptr(), leaves.data_ptr(), order.data_ptr(),
            children.data_ptr(), counts.data_ptr(),
            res_x[b0:b0 + nb].data_ptr(), res_e[b0:b0 + nb].data_ptr(), nb,
            k, s, walk.n_nodes, walk.n_leaves, len(walk.order),
            children.shape[1], sites, stream,
        )
        if rc != 0:
            raise RuntimeError(f"pruning_saveall_f32 launch failed: CUDA "
                               f"error {rc}")
        SAVEALL_LAUNCHES += 1
    return (res_x, res_e) if batched else (res_x[0], res_e[0])


def reverse_walk(
    p: torch.Tensor, leaves: torch.Tensor, res_x: torch.Tensor,
    res_e: torch.Tensor, lam: torch.Tensor, freqs: torch.Tensor,
    walk: WalkSchedule, want_dleaf: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """dP (and optionally the leaves' cotangent) of the pruning walk.

    Same contract as ``reverse_walk_reference``. CUDA tensors launch the
    reverse kernel (walk, then the deterministic dP reduction) once per
    batch chunk whose gy scratch, (K, n_nodes, sites, S) float32 per batch
    element, fits free device memory."""
    global REVERSE_LAUNCHES
    _check_residuals(p, leaves, res_x, res_e, walk, freqs=freqs,
                     lam=(lam, (p.shape[-3], leaves.shape[1])))
    _not_differentiable("reverse_walk", p, leaves, res_x, res_e, lam, freqs)
    if p.device.type == "cpu":
        return reverse_walk_reference(p, leaves, res_x, res_e, lam, freqs,
                                      walk, want_dleaf)
    lib = _cuda_library(p, leaves, res_x, res_e, lam, freqs)
    batched = p.dim() == 5
    pb, rx, re, lm = ((p, res_x, res_e, lam) if batched else
                      (p[None], res_x[None], res_e[None], lam[None]))
    b, n_nodes, k = pb.shape[:3]
    sites, s = leaves.shape[1:]
    device = p.device
    order, children, counts = walk.on(device)
    dp = torch.empty_like(pb)
    dleaf = (torch.empty((b, k, walk.n_leaves, sites, s),
                         dtype=torch.float32, device=device)
             if want_dleaf else None)
    chunk = _batch_chunk(b, k * n_nodes * sites * s * 4, device)
    stream = _stream(device)
    for b0 in range(0, b, chunk):
        nb = min(chunk, b - b0)
        gy = torch.empty((nb, k, n_nodes, sites, s), dtype=torch.float32,
                         device=device)
        rc = lib.pruning_reverse_f32(
            pb[b0:b0 + nb].data_ptr(), leaves.data_ptr(), order.data_ptr(),
            children.data_ptr(), counts.data_ptr(),
            rx[b0:b0 + nb].data_ptr(), re[b0:b0 + nb].data_ptr(),
            lm[b0:b0 + nb].data_ptr(), freqs.data_ptr(), gy.data_ptr(),
            dp[b0:b0 + nb].data_ptr(),
            None if dleaf is None else dleaf[b0:b0 + nb].data_ptr(),
            nb, k, s, n_nodes, walk.n_leaves, len(walk.order),
            children.shape[1], sites, walk.root, stream,
        )
        if rc != 0:
            raise RuntimeError(f"pruning_reverse_f32 launch failed: CUDA "
                               f"error {rc}")
        REVERSE_LAUNCHES += 1
        del gy
    if not batched:
        dp = dp[0]
        dleaf = None if dleaf is None else dleaf[0]
    return dp, dleaf


def classic_reverse_scratch(b: int, k: int, n_nodes: int, n_gslots: int,
                            sites: int, s: int) -> Tuple[int, int, int]:
    """(dP rows per (batch, category), bytes of g slots, bytes of one dP
    row over the batch) of a classic reverse launch. Each block owns one
    row of per-node S x S partial sums and walks every ``rows``-th tile of
    ``_CLASSIC_REVERSE_TILE`` sites, so the rows are capped by the launch's
    block count, not by the sites: its scratch is the g slots, (b, k,
    n_gslots, sites, S) float32, and rows x (b, k, n_nodes, S, S) float32,
    against the deferred reverse's (b, k, n_nodes, sites, S) gy store."""
    n_tiles = -(-sites // _CLASSIC_REVERSE_TILE)
    rows = min(n_tiles, max(1, -(-_CLASSIC_REVERSE_BLOCKS // (b * k))))
    return (rows, 4 * b * k * max(n_gslots, 1) * sites * s,
            4 * b * k * n_nodes * s * s)


def _classic_rows(b: int, k: int, n_nodes: int, n_gslots: int, sites: int,
                  s: int, device: torch.device) -> int:
    """dP rows per (batch, category) of a classic reverse launch whose
    scratch (``classic_reverse_scratch``) fits free device memory: fewer
    rows where only that many fit; raises when not even one does."""
    rows, slot_bytes, row_bytes = classic_reverse_scratch(
        b, k, n_nodes, n_gslots, sites, s)
    budget = _device_budget(slot_bytes + rows * row_bytes, device)
    if slot_bytes + row_bytes > budget:
        raise MemoryError(
            f"the classic reverse walk needs {slot_bytes + row_bytes} bytes "
            f"of scratch but only {budget} bytes are free on {device}; use "
            "fewer sites or a smaller batch")
    return min(rows, (budget - slot_bytes) // row_bytes)


def classic_reverse_walk(
    p: torch.Tensor, leaves: torch.Tensor, res_x: torch.Tensor,
    res_e: torch.Tensor, gseeds: torch.Tensor, seed_ids: Sequence[int],
    walk: WalkSchedule, want_dleaf: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """dP (and optionally the leaves' cotangent) of the pruning walk from
    the cotangents ``gseeds`` of the nodes ``seed_ids``, by the classic
    reverse.

    Same contract as ``classic_reverse_walk_reference``. CUDA tensors
    launch ``pruning_classic_reverse_f32`` (the walk with each child's dP
    summed per block inside it, then a fixed-order sum of the blocks'
    rows) on the current stream, once per 65535 batch elements, after
    checking that its scratch (``classic_reverse_scratch``) fits free
    device memory (``MemoryError`` if not, fewer dP rows if only that
    many fit)."""
    global CLASSIC_REVERSE_LAUNCHES
    seeds = _seed_array(seed_ids, walk)
    _check_classic(p, leaves, res_x, res_e, gseeds, seeds, walk)
    _not_differentiable("classic_reverse_walk", p, leaves, res_x, res_e,
                        gseeds)
    if p.device.type == "cpu":
        return classic_reverse_walk_reference(p, leaves, res_x, res_e,
                                              gseeds, seeds, walk, want_dleaf)
    lib = _cuda_library(p, leaves, res_x, res_e, gseeds)
    batched = p.dim() == 5
    pb, rx, re, gs = ((p, res_x, res_e, gseeds) if batched else
                      (p[None], res_x[None], res_e[None], gseeds[None]))
    b, n_nodes, k = pb.shape[:3]
    sites, s = leaves.shape[1:]
    device = p.device
    rs = walk.reverse
    rows = _classic_rows(b, k, n_nodes, rs.n_gslots, sites, s, device)
    rnode, gslot, children, cslot, counts = rs.on(device)
    node_seed = rs.node_seed(seeds, device)
    dp = torch.empty_like(pb)
    dleaf = (torch.empty((b, k, walk.n_leaves, sites, s),
                         dtype=torch.float32, device=device)
             if want_dleaf else None)
    stream = _stream(device)
    for b0 in range(0, b, _MAX_GRID_Z):
        nb = min(_MAX_GRID_Z, b - b0)
        g_slots = torch.empty((nb, k, max(rs.n_gslots, 1), sites, s),
                              dtype=torch.float32, device=device)
        dp_rows = torch.zeros((nb, k, rows, n_nodes, s, s),
                              dtype=torch.float32, device=device)
        rc = lib.pruning_classic_reverse_f32(
            pb[b0:b0 + nb].data_ptr(), leaves.data_ptr(), rnode.data_ptr(),
            gslot.data_ptr(), children.data_ptr(), cslot.data_ptr(),
            counts.data_ptr(), node_seed.data_ptr(),
            rx[b0:b0 + nb].data_ptr(), re[b0:b0 + nb].data_ptr(),
            gs[b0:b0 + nb].data_ptr(), g_slots.data_ptr(),
            dp_rows.data_ptr(), dp[b0:b0 + nb].data_ptr(),
            None if dleaf is None else dleaf[b0:b0 + nb].data_ptr(),
            nb, k, s, n_nodes, walk.n_leaves, len(rs.rnode),
            children.shape[1], sites, len(seeds), max(rs.n_gslots, 1), rows,
            stream,
        )
        if rc != 0:
            raise RuntimeError(f"pruning_classic_reverse_f32 launch failed: "
                               f"CUDA error {rc}")
        CLASSIC_REVERSE_LAUNCHES += 1
        del g_slots, dp_rows
    if not batched:
        dp = dp[0]
        dleaf = None if dleaf is None else dleaf[0]
    return dp, dleaf


def choose_reverse(b: int, k: int, n_nodes: int, sites: int, s: int,
                   device) -> str:
    """The gradient's reverse walk: "deferred" (``reverse_walk``, B3) or
    "classic" (``classic_reverse_walk``, B7).

    ``PHYLO_DEFERRED_VJP`` is read as the JAX package reads it: "0" forces
    the classic reverse, "1" the deferred one, anything else ("auto") the
    rule: the deferred reverse while one batch element's gy store, (K,
    n_nodes, sites, S) float32, fits ``_device_budget`` (B3 splits a batch
    into launches that fit), else the classic one, whose scratch does not
    grow with n_nodes x sites. CPU tensors take the deferred reverse's plain
    version under "auto": the rule weighs the card's memory."""
    env = os.environ.get("PHYLO_DEFERRED_VJP", "auto")
    if env == "0":
        return "classic"
    if env == "1" or torch.device(device).type == "cpu":
        return "deferred"
    need = 4 * k * n_nodes * sites * s
    return "deferred" if need <= _device_budget(need, device) else "classic"


def _root_loglik(root_p, root_e, freqs):
    """(ll, pi . x_root, x_root) in ``freqs``' dtype from the walk's root."""
    root_r = root_p.to(freqs.dtype)
    dot = torch.einsum("...ksi,i->...ks", root_r, freqs)
    return torch.log(dot) + root_e.to(freqs.dtype) * LN2, dot, root_r


class _FusedLoglik(torch.autograd.Function):
    """ll = log(pi . x_root) + e_root ln 2 per (batch, category, site), with
    the walk's kernels on both sides: saveall forward, reverse backward
    (the whole-tree ``custom_vjp`` of ``pallas_pruning.make_pallas_loglik_fn``:
    one seed at the root, leaves shared across categories, zero leaf
    logscales). The backward seeds the walk with lambda = ct / (pi . x_root)
    computed in the reduction dtype and cast to float32 (the classic
    reverse takes the seed lambda pi, formed in float32 as the deferred
    kernel forms it), takes the reverse ``choose_reverse`` names, and forms
    dfreqs = sum lambda x_root outside the kernel in that dtype. It has no
    second derivative (``first_derivative_only``)."""

    @staticmethod
    def forward(ctx, p, leaves, freqs, walk):
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            res_x, res_e = saveall_walk(p, leaves, walk)
            row = walk.root - walk.n_leaves
            root_p, root_e = res_x[..., row, :, :], res_e[..., row, :]
        else:   # only freqs: the root suffices
            res_x = res_e = None
            root_p, root_e = forward_walk(p, leaves, walk)
        ll, dot, root_r = _root_loglik(root_p, root_e, freqs)
        ctx.walk = walk
        ctx.save_for_backward(p, leaves, freqs, res_x, res_e, dot, root_r)
        return ll

    @staticmethod
    @first_derivative_only
    def backward(ctx, ct):
        p, leaves, freqs, res_x, res_e, dot, root_r = ctx.saved_tensors
        lam = ct / dot
        dp = dleaf = dfreqs = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            walk = ctx.walk
            lam32 = lam.to(torch.float32).contiguous()
            f32 = freqs.to(torch.float32).contiguous()
            sites, s = leaves.shape[1:]
            b = p.shape[0] if p.dim() == 5 else 1
            if choose_reverse(b, p.shape[-3], walk.n_nodes, sites, s,
                              p.device) == "deferred":
                dp, dleaf_k = reverse_walk(
                    p, leaves, res_x, res_e, lam32, f32, walk,
                    want_dleaf=ctx.needs_input_grad[1])
            else:
                gseed = (lam32[..., None] * f32).unsqueeze(-3).contiguous()
                dp, dleaf_k = classic_reverse_walk(
                    p, leaves, res_x, res_e, gseed, [walk.root], walk,
                    want_dleaf=ctx.needs_input_grad[1])
            if not ctx.needs_input_grad[0]:
                dp = None
            if dleaf_k is not None:   # leaves are shared by batch and category
                dleaf = dleaf_k.sum(dim=tuple(range(dleaf_k.dim() - 3)))
        if ctx.needs_input_grad[2]:
            dfreqs = torch.einsum("...ks,...ksi->i", lam, root_r)
        return dp, dleaf, dfreqs, None


def make_fused_loglik_fn(schedule: PruningSchedule):
    """Counterpart of the whole-tree ``pallas_pruning.make_pallas_loglik_fn``.

    Returns ``f(p_matrices (B?, n_nodes, K, S, S), leaf_partials
    (n_leaves, sites, S), freqs (S,)) -> ll (B?, K, sites)`` with
    ``ll[k, s] = log(sum_i freqs_i * true_root_partials[k, s, i])``. The
    walk runs in float32; the root reduction and the exponent count x ln 2
    run in ``freqs.dtype`` (pass float64 freqs for the precision plan).

    Differentiable in all three inputs. When P or the leaves require grad
    (and grad mode is on), the saveall kernel runs forward and a reverse
    kernel backward (``choose_reverse``: the deferred one while its gy
    store fits, else the classic one), over the whole tree; otherwise one
    forward walk runs
    alone, chosen by ``choose_walk``: the classic walk while the launch's
    whole-tree scratch fits ``CLASSIC_SCRATCH_BUDGET``, else the slot walk
    (DNA) or the stream walk (protein). The leaves' cotangent is computed
    only when they require grad (the engine passes them as data).
    """
    walk = WalkSchedule(schedule)

    def fused_ll(p_matrices, leaf_partials, freqs):
        p32 = p_matrices.to(torch.float32).contiguous()
        l32 = leaf_partials.to(torch.float32).contiguous()
        if torch.is_grad_enabled() and (
                p32.requires_grad or l32.requires_grad or freqs.requires_grad):
            return _FusedLoglik.apply(p32, l32, freqs, walk)
        return _root_loglik(*forward_walk(p32, l32, walk), freqs)[0]

    return fused_ll


# bytes of level buffers one backward replay of the plain pruner may hold;
# past that it replays the sites in slices (the pruning has no coupling
# across sites, so the gradients of the slices add up)
_REPLAY_BYTES = 2 ** 31


class _CudaPrune(torch.autograd.Function):
    """(root partials, root logscale in ln units) with the kernels forward
    and the plain pruner replayed backward: ``make_pallas_prune_fn``'s
    ``custom_vjp``, whose backward is ``jax.vjp`` of the XLA pruner on the
    saved inputs. The replay runs in the inputs' own dtypes, over site
    slices of at most ``_REPLAY_BYTES`` of level buffers. It has no second
    derivative (``first_derivative_only``)."""

    @staticmethod
    def forward(ctx, p, leaves, walk, plain):
        root, root_e = forward_walk(
            p.to(torch.float32).contiguous(),
            leaves.to(torch.float32).contiguous(), walk)
        ctx.walk, ctx.plain = walk, plain
        ctx.save_for_backward(p, leaves)
        return root.to(leaves.dtype), root_e.to(torch.float64) * LN2

    @staticmethod
    @first_derivative_only
    def backward(ctx, ct_root, ct_logscale):
        p, leaves = ctx.saved_tensors
        need_p, need_l = ctx.needs_input_grad[:2]
        sites, s = leaves.shape[1:]
        per_site = (ctx.walk.n_nodes * p.shape[-3] * s * leaves.element_size()
                    * (p.shape[0] if p.dim() == 5 else 1))
        step = max(1, _REPLAY_BYTES // per_site)
        dp = None
        dleaf = torch.zeros_like(leaves) if need_l else None
        for s0 in range(0, sites, step):
            sl = slice(s0, min(sites, s0 + step))
            with torch.enable_grad():
                pp = p.detach().requires_grad_(need_p)
                ll = leaves[:, sl].detach().requires_grad_(need_l)
                root, logscale = ctx.plain(pp, ll)
                inputs = [t for t, need in ((pp, need_p), (ll, need_l))
                          if need]
                # in float32 the logscale is exponent counts: no graph
                outs = [(out, ct.to(out.dtype)) for out, ct in (
                    (root, ct_root[..., sl, :]),
                    (logscale, ct_logscale[..., sl])) if out.requires_grad]
                grads = torch.autograd.grad(
                    [o for o, _ in outs], inputs, [c for _, c in outs],
                    allow_unused=True)
            grads = list(grads)
            if need_p:
                g = grads.pop(0)
                if g is not None:
                    dp = g if dp is None else dp + g
            if need_l and grads[0] is not None:
                dleaf[:, sl] = grads[0]
        if need_p and dp is None:
            dp = torch.zeros_like(p)
        return dp, dleaf, None, None


def make_cuda_prune_fn(schedule: PruningSchedule):
    """Counterpart of ``pallas_pruning.make_pallas_prune_fn``: the pruning
    function of the engines that take the root partials themselves (model
    and profile mixtures).

    Returns ``prune(p_matrices (B?, n_nodes, K, S, S), leaf_partials
    (n_leaves, sites, S)) -> (root_partials (B?, K, sites, S), root_logscale
    (B?, K, sites))``: the walk runs in float32 through ``forward_walk``,
    whatever walk and lowering it picks; the root partials come back in the
    leaves' dtype and the logscale, in ln units, in float64 (JAX's comes in
    the leaves' dtype; float64 keeps the exponent count x ln 2 exact for the
    engines' float64 root reduction). Differentiable in both inputs: the
    backward replays ``ops.pruning.make_prune_fn`` under autograd on the
    saved inputs, as ``make_pallas_prune_fn`` replays the XLA pruner.
    """
    walk = WalkSchedule(schedule)
    plain = make_prune_fn(schedule)

    def prune(p_matrices, leaf_partials):
        return _CudaPrune.apply(p_matrices, leaf_partials, walk, plain)

    return prune
