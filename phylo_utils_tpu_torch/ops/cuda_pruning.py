"""Fused pruning on the GPU: the port of the whole-tree and big-tree paths
of ``phylo_utils_tpu.ops.pallas_pruning``.

Hand-written CUDA kernels, every one compiled for 4 (DNA), 20 (protein)
and 64 states, each with a plain-PyTorch version beside it that CPU
tensors take (a CUDA tensor launches the kernel or raises). The entry
points the engines call, ``make_fused_loglik_fn`` and
``make_cuda_prune_fn``, pad every other state count with zero states up to
the next compiled width (``padded_states``: 2-3 -> 4, 5-19 -> 20, 21-63 ->
64, so codon's 61 and Mk's 2-32 states run):

- ``forward_walk(..., walk="classic")`` (``csrc/pruning_forward.cu``,
  replaces the TPU kernel ``_dynamic_kernel``): a post-order walk that forms
  y_c = P_c . x_c per child, multiplies the y's, and rescales each node by an
  exact power of two with integer exponent counts; returns the root. It
  keeps only the rows live at once (``WalkSchedule.rows``, a free list over
  its level post-order) in shared memory, all of them in device memory
  where they do not fit (``row_geometry``). Plain version
  ``forward_walk_reference``.
- ``slot_walk`` (``csrc/pruning_slot.cu``): the same walk in DFS post-order
  over reusable slots (``SlotSchedule``), O(depth) rows instead of one per
  internal node; ``pruning_slot_f32`` (replaces ``_dynamic_slot_kernel``)
  is B1's live-row body (``csrc/pruning_rows.cuh``) over the slots
  (``SlotSchedule.rows``), ``pruning_stream_f32`` stages each node's P
  blocks in shared memory two nodes ahead, its slots in device memory
  (replaces ``_dynamic_slot_stream_kernel``). Both roots are bit for bit
  the forward kernel's. Plain version ``slot_walk_reference``.
  ``forward_walk`` picks among the three walks (``choose_walk``).
- ``saveall_walk`` (same source, replaces ``_dynamic_saveall_kernel``): the
  same walk keeping every internal node's partials and exponent count, the
  residuals of the gradient, with P staged in shared memory by chunks of
  the walk's edges (``saveall_stage``), so a node of any number of
  children runs.
  Plain version ``saveall_walk_reference``.
- ``reverse_walk`` (``csrc/pruning_reverse.cu``, replaces
  ``_dynamic_bwd2_kernel``): the deferred-edge reverse walk from a root
  cotangent, dP = sum_sites gy x^T per edge (and optionally the leaf
  partials' cotangent), P staged in shared memory and outside vectors in
  the O(depth) slots of ``ReverseSchedule``, dP summed inside the walk
  into one row per block and the rows summed by a second kernel; it
  stores no gy (``reverse_scratch``). Plain version
  ``reverse_walk_reference``.
- ``classic_reverse_walk`` (``csrc/pruning_classic_reverse.cu``, replaces
  ``_dynamic_bwd_kernel``): the classic reverse from any set of seeds, each
  child's dP summed inside the walk, outside vectors in the O(depth) slots
  of ``ReverseSchedule``, P staged in shared memory for every visit whose
  children fit the stage (``classic_reverse_stage``) and read through L1
  for a wider one; it stores no gy and takes a node of any number of
  children. At 64 states both reverses take four lanes a column and sum dP
  over a block of 64 columns (``csrc/pruning_common.cuh``'s wide_*
  helpers). Plain version ``classic_reverse_walk_reference``.

- ``static_walk`` (``csrc/pruning_static.cu``, replaces ``_static_kernel``):
  the live-row walk over the DFS slots compiled for one topology
  (``ops/_build.py`` builds it per tree and state count), every edge's word
  a compile-time constant; and ``fold_walk`` (``csrc/pruning_fold.cu``,
  replaces the category-fold and DNA-pack lowerings of ``_dynamic_kernel``):
  the live-row walk over the DFS slots with F categories a column, each
  leaf row read once for all F. Both roots are bit for bit the forward
  kernel's; their plain version is ``forward_walk_reference``.

``forward_walk(walk="auto")`` picks the walk (``choose_walk``, which reads
``PHYLO_FORCE_STREAM`` as the JAX package does) and, where that is the
classic walk, its lowering as the JAX package's ``_pallas_forward`` does
(``choose_lowering``: static while the internal nodes are at most
``STATIC_UNROLL_MAX``, env ``PHYLO_STATIC_UNROLL_MAX``; else the fold of 2
under ``PHYLO_PACK_DNA=1`` at 4 states, or of ``_pick_fold``'s F under
``PHYLO_FOLD_CATEGORIES``; else the forward kernel); the static walk also
precedes a forced stream. The three lowering knobs are off by default.

``make_fused_loglik_fn`` ties them into a differentiable per-(category,
site) log-likelihood: value calls run ``forward_walk``; calls that need a
gradient run ``saveall_walk`` forward and, backward, ``reverse_walk`` while
its scratch fits the card, else ``classic_reverse_walk``
(``choose_reverse``, ``PHYLO_DEFERRED_VJP``). ``make_cuda_prune_fn`` is the
pruning function of the engines above ``LikelihoodEngine`` (root partials
and logscale): ``forward_walk`` forward, the plain pruner replayed under
autograd backward. ``LAUNCHES``, ``SLOT_LAUNCHES``, ``STREAM_LAUNCHES``,
``SAVEALL_LAUNCHES``, ``REVERSE_LAUNCHES``, ``CLASSIC_REVERSE_LAUNCHES``,
``STATIC_LAUNCHES`` and ``FOLD_LAUNCHES`` count kernel launches, so a run
can show its main path went through the kernels, and
``LAUNCHES_BY_STATES[(counter, S)]`` counts the same launches by state
count.
"""
from __future__ import annotations

import collections
import ctypes
import functools
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
    "LAUNCHES_BY_STATES",
    "KERNEL_STATES",
    "CLASSIC_SCRATCH_BUDGET",
    "STATIC_UNROLL_MAX",
    "FOLD_WIDTHS",
    "WalkSchedule",
    "SlotSchedule",
    "RowWalk",
    "RowGeometry",
    "ReverseSchedule",
    "choose_walk",
    "padded_states",
    "row_geometry",
    "row_smem_bytes",
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
    "classic_reverse_stage",
    "reverse_scratch",
    "saveall_stage",
    "reverse_tile",
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
# the same launches by (counter name, state count)
LAUNCHES_BY_STATES = collections.Counter()

# internal-node count up to which the classic walk is the topology-compiled
# static kernel (B8); read at import, as the JAX package reads it; 0 (the
# default) never
STATIC_UNROLL_MAX = int(os.environ.get("PHYLO_STATIC_UNROLL_MAX", "0"))
# the categories a column the fold kernel (B9) is compiled for, by state
# count, each with the lane counts a column it is compiled for
# (csrc/pruning_fold.cu's FoldWidths and fold_compiled): the lane counts
# of _ROW_LANES at which ptxas takes the width without a spill (F = 4 at 4
# states spilled at one and four lanes), where the TPU's fold stopped at
# its 128 lanes (at 64 states F = 2, its widest there, at two lanes: four
# spilled)
FOLD_WIDTHS = {4: {2: (1, 2, 4), 4: (2,)},
               20: {2: (1, 2), 3: (1, 2), 4: (1, 2), 5: (1, 2)},
               64: {2: (2,)}}

# CUDA caps gridDim.z (the batch axis of the launch) at 65535
_MAX_GRID_Z = 65535
# share of the free device memory one launch's scratch may take
_MEM_FRACTION = 0.9
# the state counts every kernel is compiled for: DNA, protein and 64, the
# width codon's 61 (or 60) states pad to; every other count is padded up to
# the next (padded_states)
KERNEL_STATES = (4, 20, 64)
# sites per block of the deferred reverse kernel, widest first
# (reverse_tile)
_REVERSE_TILES = (256, 128, 64, 32)
# shared memory one block may take: an H100 SM's 227 KB
_REVERSE_SMEM = 232_448
# columns a block of the reverses at 64 states (csrc/pruning_common.cuh
# kWideTile: B3's pruning_reverse_wide_kernel and B7's
# classic_reverse_wide_kernel, four lanes each, 256 threads), and floats
# between the rows of a P block staged in shared memory at 64 states
# (csrc/pruning_common.cuh p_row; the reverses' gy and x tiles too): 4 more
# than 64, so that the rows a column's four lanes read at once fall in four
# bank quads
_WIDE_TILE, _WIDE_ROW = 64, 68
# edges of the walk a step of the saveall kernel stages (saveall_stage),
# and lanes that share one of its columns, by state count: two lanes, each
# forming half the rows, at 20 states (1.73 against 2.50 ms at 512 taxa x
# 8192 LG patterns), one at 4 (0.246 against 0.276 ms at the flagship's
# B = 64); 64 and 8 edges a step were the fastest or within 2% of it at
# every shape (kernel_turns.py sweeps, NVIDIA H100 80GB HBM3, 700 W)
# At 64 states four lanes (16 rows each beside the child's 64-entry row)
# and 2 edges a step: a ring of 96 KB, two blocks an SM
_SAVEALL_CHUNK = {4: 64, 20: 8, 64: 2}
_SAVEALL_LANES = {4: 1, 20: 2, 64: 4}
# sites per block of the classic reverse kernel at 4 and 20 states: 128 was
# slower than 256 at every shape but B = 1 (kernel_turns.py, NVIDIA H100
# 80GB HBM3, 700 W); at 64 states its block is _WIDE_TILE columns
# (_classic_reverse_tile)
_CLASSIC_REVERSE_TILE = 256
# blocks per classic reverse launch, over (site rows, K, B), by state
# count. Each block owns one dP partial row, so this caps the rows. At 4
# states eight per SM of an H100's 132, so that the flagship's B = 64
# walks one tile a block (0.58 ms against 0.65 at 264 blocks); at 20
# states two, which its registers let an SM hold: more blocks measured
# the same where the sites allowed them and would grow the rows that keep
# the classic reverse's scratch small (kernel_turns.py). At 64 states one
# an SM, which a block of 139 KB (two staged children) or 191 KB (three) of
# shared memory fills: 5.94 ms at 100 taxa x 4096 codon patterns, against
# 6.10 at 264 and 528 blocks (chip_smoke.py phase 27, in turns; NVIDIA H100
# 80GB HBM3, 700 W)
_CLASSIC_REVERSE_BLOCKS = {4: 1056, 20: 264, 64: 132}
# shared memory a classic reverse block may take to stage a visit's P
# (classic_reverse_stage): the whole SM's; a budget that staged 2 or 3
# children at 20 states and left the rest to L1, which a wider visit
# reads its P through, measured the same on a node of 49 children
_CLASSIC_STAGE_BYTES = _REVERSE_SMEM
# bytes of whole-tree scratch up to which the value path takes the classic
# walk (see choose_walk): the H100's 50 MB L2. It was the scratch of B1's
# first body and of the classic walk's lowerings (B8, B9) before they took
# the live-row body; they keep their rows on the SM and allocate only rows
# that do not fit there. With B1 and B4 on one body
# (csrc/pruning_rows.cuh) the line still falls where the turns put it: on an
# NVIDIA H100 80GB HBM3 (700 W) B1 and B4 took the same device time at the
# flagship B = 1 (5 MB), config 4 (11 MB) and config 5's tree, and B4 was
# 2.4x faster at B = 16 (83 MB) and 1.7x at B = 64 (330 MB), where B1's 24
# rows a column cost warps (chip_smoke.py phase 16, PERF.md section 6)
CLASSIC_SCRATCH_BUDGET = 50 * 2 ** 20
# B1's and B4's launch geometry (row_geometry): the lanes a column may take
# by state count (csrc/pruning_rows.cuh compiles these; at 64 states, B1
# only, one lane's 64 accumulators would cost warps) and the edges a step
# of the ring may copy ahead
_ROW_LANES = {4: (1, 2, 4), 20: (1, 2), 64: (2, 4)}
_ROW_CHUNKS = (2, 4, 8)
# B8's step, compiled into its library (csrc/pruning_static.cu's kChunk): a
# constant step lets each edge's stage and P offset fold to immediates; 8
# edges is the longest of _ROW_CHUNKS, which row_geometry takes for B4 at
# the main-path shapes
_STATIC_CHUNK = 8
# the warps an SM a row-walk launch aims for: the fewest lanes a column
# that reach it, else the lanes that put the most warps on an SM. Below it
# at one lane a column, a 4-state launch also stages its leaf rows in the
# ring (latency, not warps, bounds it there); at 20 states and in larger
# launches the ring's leaf rows cost more warps than they save
_ROW_WARPS = 12
# an H100: its SMs, and what one SM holds (shared memory with the 1 KB a
# block reserves, blocks, threads)
_SMS, _SM_SMEM, _SM_BLOCKS, _SM_THREADS = 132, 233_472, 32, 2048


def _static_chunk(s: int) -> int:
    """B8's compiled step at ``s`` states: ``_STATIC_CHUNK``, and at 64
    states the shortest of ``_ROW_CHUNKS``, 2 edges, which row_geometry
    takes for B1 there (a ring of 8 edges of 64 x 68-float P blocks, 418
    KB, would not fit a block)."""
    return _ROW_CHUNKS[0] if s == KERNEL_STATES[-1] else _STATIC_CHUNK


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
    """``arrays`` (numpy arrays or tensors) as contiguous tensors of their
    own dtype on ``device``, made once."""
    if device not in cache:
        cache[device] = tuple(torch.as_tensor(a).to(device).contiguous()
                              for a in arrays)
    return cache[device]


def _live_rows(order, children, counts, n_leaves: int):
    """B1's live rows over its own post-order: (nrow (n_int,), erow
    (n_edges,), n_rows). A node's row is live from its own visit to its
    parent's, so a free list gives each internal node but the root (which
    the walk writes to its output) a reusable row; a node may take a row
    one of its children freed, after every child is read. ``erow[f]`` is
    the row of the f-th child in walk order (``WalkSchedule.edges``), -1
    for a leaf; ``nrow`` is -1 for the root."""
    row_of: dict = {}
    free: list = []
    n_rows = 0
    nrow = np.full(len(order), -1, np.int32)
    erow = []
    for i, (node, kids, cnt) in enumerate(zip(order.tolist(),
                                               children.tolist(),
                                               counts.tolist())):
        for ch in kids[:cnt]:
            erow.append(row_of.get(ch, -1))
            if ch >= n_leaves:     # read: its row is free again
                free.append(row_of.pop(ch))
        if i == len(order) - 1:
            break
        if free:
            r = free.pop()
        else:
            r = n_rows
            n_rows += 1
        row_of[node] = nrow[i] = r
    return nrow, np.asarray(erow, np.int32), n_rows


class RowWalk:
    """A walk as B1's and B4's kernel takes it (``csrc/pruning_rows.cuh``):
    the children of the nodes in walk order, flattened (``edges``), and one
    word an edge (``eword``): the child's row (``erow``, the row it was
    written to) or -1 - leaf for a leaf, and -2 or, on a node's last child,
    the row the node writes (``nrow``; -1 for the root, last, which writes
    the output); one more word that the kernel reads ahead; ``n_rows``
    rows. Built from the walk's ``erow`` (-1 for a leaf), child ``counts``
    and ``nrow``; with int32 copies on each device that has used it."""

    def __init__(self, edges, erow, counts, nrow, n_rows: int):
        self.edges = np.ascontiguousarray(edges, dtype=np.int32)
        word = np.full((len(self.edges) + 1, 2), -2, np.int32)
        word[:-1, 0] = np.where(np.asarray(erow) >= 0, erow, -1 - self.edges)
        word[np.cumsum(counts) - 1, 1] = nrow
        word[-1, 0] = 0
        self.eword = word
        self.n_rows = int(n_rows)
        self._on_device = {}

    def on(self, device: torch.device):
        """(edges, eword) on device."""
        return _on_device(self._on_device, device, (self.edges, self.eword))


class SlotSchedule:
    """The DFS slot walk of one schedule (``_dfs_slot_schedule``): host
    arrays plus their int32 copies on each device that has used them, and
    ``rows``, the walk as B4's kernel takes it."""

    def __init__(self, schedule: PruningSchedule):
        (self.nslot, self.child_node, self.child_src, self.child_isleaf,
         self.counts, self.n_slots, self.root_slot) = _dfs_slot_schedule(
            schedule)
        self._on_device = {}
        real = [slice(0, int(c)) for c in self.counts]
        self.rows = RowWalk(
            np.concatenate([a[sl] for a, sl in zip(self.child_node, real)]),
            np.concatenate([np.where(leaf[sl] > 0, -1, src[sl]) for src, leaf,
                            sl in zip(self.child_src, self.child_isleaf,
                                      real)]),
            self.counts, np.append(self.nslot[:-1], -1), self.n_slots)

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
    copies on each device that has used them, and (built at first use) B1's
    live rows, ``rows``, the schedule's DFS slot walk, ``slots``, its
    classic reverse walk, ``reverse``, and its topology-compiled kernel
    library per state count, ``static_library``."""

    def __init__(self, schedule: PruningSchedule):
        self.order, self.children, self.counts = _postorder_arrays(schedule)
        if len(self.order) == 0:
            raise ValueError("the tree has no internal node to walk")
        # the children of order[0], then of order[1], ...: the saveall
        # kernel's flat list of edges
        self.edges = np.concatenate([
            kids[:cnt] for kids, cnt in zip(self.children, self.counts)]
        ).astype(np.int32)
        self._edges_on_device = {}
        self.n_nodes = schedule.n_nodes
        self.n_leaves = schedule.n_leaves
        self.root = int(self.order[-1])    # the root is last in post-order
        self._schedule = schedule
        self._rows = None
        self._slots = None
        self._reverse = None
        self._static = {}
        self._on_device = {}

    def static_library(self, s: int):
        """B8's library for this topology at ``s`` states: the DFS slot
        walk (``slots.rows``) compiled in, with a step of
        ``_static_chunk(s)`` edges, at each lane count of ``_ROW_LANES[s]``
        (built by ``_build.load_static_library`` at first use)."""
        if s not in self._static:
            from phylo_utils_tpu_torch.ops._build import load_static_library

            rw = self.slots.rows
            self._static[s] = load_static_library(
                rw.edges, rw.eword, rw.n_rows, self.n_nodes, self.n_leaves,
                s, _static_chunk(s), _ROW_LANES[s])
        return self._static[s]

    @property
    def rows(self) -> RowWalk:
        """The level post-order with B1's live rows (``_live_rows``)."""
        if self._rows is None:
            nrow, erow, n_rows = _live_rows(self.order, self.children,
                                            self.counts, self.n_leaves)
            self._rows = RowWalk(self.edges, erow, self.counts, nrow, n_rows)
        return self._rows

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

    def edges_on(self, device: torch.device) -> torch.Tensor:
        """``edges`` as a contiguous int32 tensor on device."""
        return _on_device(self._edges_on_device, device, (self.edges,))[0]


def _check(p: torch.Tensor, leaves: torch.Tensor, walk: WalkSchedule):
    if p.dim() not in (4, 5):
        raise ValueError(
            f"P must be (n_nodes, K, S, S) or (B, n_nodes, K, S, S); got "
            f"{tuple(p.shape)}"
        )
    if leaves.dim() == 4 and not (p.dim() == 5
                                  and leaves.shape[0] == p.shape[0]):
        raise ValueError(
            f"leaves (B, n_leaves, sites, S) {tuple(leaves.shape)} need P "
            f"(B, n_nodes, K, S, S) of the same B; got {tuple(p.shape)}"
        )
    if leaves.dim() not in (3, 4):
        raise ValueError(
            f"leaves must be (n_leaves, sites, S) or (B, n_leaves, sites, "
            f"S); got {tuple(leaves.shape)}"
        )
    s = leaves.shape[-1]
    if p.shape[-4] != walk.n_nodes or p.shape[-2:] != (s, s):
        raise ValueError(
            f"P {tuple(p.shape)} does not match {walk.n_nodes} nodes x "
            f"{s} states"
        )
    if leaves.shape[-3] != walk.n_leaves:
        raise ValueError(
            f"leaves has {leaves.shape[-3]} rows; the tree has "
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


def _leaf_term(eq: str, a: torch.Tensor, leaves: torch.Tensor,
               c: int) -> torch.Tensor:
    """``einsum(eq, a, leaf c's rows)`` over a batch (B, ...) of ``a``: with
    leaves (n_leaves, sites, S) the rows every batch element shares; with
    leaves (B, n_leaves, sites, S) batch element b's own rows, by the
    product a walk with b's leaves alone forms, so that a batch of loci
    gives each locus its own walk's bits."""
    if leaves.dim() == 3:
        return torch.einsum(eq, a, leaves[c])
    return torch.cat([torch.einsum(eq, a[b:b + 1], leaves[b, c])
                      for b in range(leaves.shape[0])])


def _node_partials(pb, leaves, n_leaves, kids, x_of, e_of):
    """One node of the plain walk: (rescaled partials, exponent count) from
    its children, batched over (B, K, sites)."""
    acc, esum = None, None
    for c in kids:
        if c < n_leaves:
            y = _leaf_term("bkij,sj->bksi", pb[:, c], leaves, c)
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
    ``leaves`` (n_leaves, sites, S), shared by the batch, or, with a
    batched P, (B, n_leaves, sites, S), one set a batch element (a stack of
    loci), float32. Returns the root partials (B?, K, sites, S) and the
    root exponent count (B?, K, sites), float32. Every walk takes leaves
    both ways.
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
    sites, s = leaves.shape[-2:]
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
    residuals, ``freqs`` (S,) or, with a batched P, (B, S) when given, and
    each of ``cotangents``, ``name=(tensor, its shape after the batch dims
    of P)``."""
    _check(p, leaves, walk)
    lead = tuple(p.shape[:-4])
    k, sites, s = p.shape[-3], leaves.shape[-2], leaves.shape[-1]
    n_inner = walk.n_nodes - walk.n_leaves
    want = {
        "res_x": (res_x, lead + (k, n_inner, sites, s)),
        "res_e": (res_e, lead + (k, n_inner, sites)),
    }
    want.update({name: (t, lead + shape)
                 for name, (t, shape) in cotangents.items()})
    if freqs is not None:
        want["freqs"] = (freqs, (lead + (s,)) if freqs.dim() == 2 else (s,))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {t.dtype}")
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, P on {p.device}")


def _child_terms(pb, leaves, rx, n_leaves):
    """(y_of, dp_of) of the plain reverse walks, batched over (B, K,
    sites): y = P x of a node (x a leaf row or its residual) and its dP
    term sum_sites gy x^T."""

    def y_of(c):
        if c < n_leaves:
            return _leaf_term("bkij,sj->bksi", pb[:, c], leaves, c)
        return torch.einsum("bkij,bksj->bksi", pb[:, c],
                            rx[:, :, c - n_leaves])

    def dp_of(c, gy):
        if c < n_leaves:
            return _leaf_term("bksi,sj->bkij", gy, leaves, c)
        return torch.einsum("bksi,bksj->bkij", gy, rx[:, :, c - n_leaves])

    return y_of, dp_of


def reverse_walk_reference(
    p: torch.Tensor, leaves: torch.Tensor, res_x: torch.Tensor,
    res_e: torch.Tensor, lam: torch.Tensor, freqs: torch.Tensor,
    walk: WalkSchedule, want_dleaf: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain-PyTorch version of the reverse kernel: an explicit pre-order
    walk vectorised over (batch, category, site), with the kernel's math
    (not autograd).

    ``res_x``/``res_e``: ``saveall_walk``'s residuals; ``lam`` (B?, K,
    sites): the root cotangent ct / (pi . x_root); ``freqs`` (S,), or, with
    a batched P, (B, S): each batch element's root frequencies. All
    float32. Returns ``dp`` (B?, n_nodes, K, S, S), the layout of P, with a
    zero root row, and, when ``want_dleaf``, ``dleaf`` (B?, K, n_leaves,
    sites, S) = P_l^T gy_l per leaf (else None).
    """
    _check_residuals(p, leaves, res_x, res_e, walk, freqs=freqs,
                     lam=(lam, (p.shape[-3], leaves.shape[-2])))
    batched = p.dim() == 5
    pb, rx, re, lm = ((p, res_x, res_e, lam) if batched else
                      (p[None], res_x[None], res_e[None], lam[None]))
    n_leaves = walk.n_leaves
    y_of, dp_of = _child_terms(pb, leaves, rx, n_leaves)
    pi = freqs if freqs.dim() == 1 else freqs[:, None, None, :]
    gy = {}
    for node, kids in reversed(_walk_nodes(walk)):
        if node == walk.root:
            g = lm[..., None] * pi
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
        dp[:, node] = dp_of(node, g)
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
        gseeds, (p.shape[-3], len(seeds)) + tuple(leaves.shape[-2:])))


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
    y_of, dp_of = _child_terms(pb, leaves, rx, n_leaves)
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
            dp[:, c] += dp_of(c, gy)
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
    if bytes_per_b == 0:
        return min(b, _MAX_GRID_Z)
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
    if s not in KERNEL_STATES:
        raise NotImplementedError(
            f"the CUDA walks are built for {KERNEL_STATES} states, not {s}; "
            "make_fused_loglik_fn and make_cuda_prune_fn pad to them "
            "(padded_states)"
        )


def padded_states(s: int) -> int:
    """The compiled width ``s`` states run at: the smallest of
    ``KERNEL_STATES`` that holds them (2-3 -> 4, 5-19 -> 20, 21-63 -> 64),
    the port's counterpart of the JAX package's ``_state_pad``; ``s``
    itself past the widest (the card then refuses it)."""
    return next((w for w in KERNEL_STATES if s <= w), s)


def _cuda_library(p: torch.Tensor, *tensors: torch.Tensor):
    """The kernels' library for CUDA inputs; raises on what they do not
    take."""
    _check_cuda(p, *tensors)
    from phylo_utils_tpu_torch.ops._build import load_library

    return load_library()


def _leaf_args(leaves: torch.Tensor, b0: int, nb: int) -> Tuple[int, int]:
    """(pointer, stride in floats) of the leaves of batch elements [b0, b0
    + nb) for one launch: the shared (n_leaves, sites, S) leaves with a
    stride of 0, or, from (B, n_leaves, sites, S) leaves, those elements'
    own sets, n_leaves sites S floats apart."""
    if leaves.dim() == 3:
        return leaves.data_ptr(), 0
    return leaves[b0:b0 + nb].data_ptr(), leaves[0].numel()


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _on_p_device(launcher):
    """Runs ``launcher(p, ...)`` with ``p``'s card as the current device:
    the kernels launch through the runtime on ``_stream(p.device)``, which
    the runtime refuses while another card is current (a shard on cuda:1,
    an autograd backward on another thread)."""

    @functools.wraps(launcher)
    def run(p, *args, **kwargs):
        if p.device.type != "cuda":
            return launcher(p, *args, **kwargs)
        with torch.cuda.device(p.device):
            return launcher(p, *args, **kwargs)

    return run


def _stream_forced(s: int) -> bool:
    """Whether the value path streams whatever the size at ``s`` states:
    ``PHYLO_FORCE_STREAM`` read as the JAX package's ``_pallas_forward``
    reads it, "1" at every width, "auto" (the default) at 32 states and
    more, anything else ("0") never."""
    env = os.environ.get("PHYLO_FORCE_STREAM", "auto")
    return env == "1" or (env == "auto" and s >= 32)


def choose_walk(b: int, k: int, n_inner: int, sites: int, s: int) -> str:
    """The value path's walk for a launch of ``b`` batch elements, ``k``
    categories, ``n_inner`` internal nodes, ``sites`` sites, ``s`` states.

    The stream walk (B5) where ``_stream_forced``: under
    ``PHYLO_FORCE_STREAM=1`` at every width, and by default at 32 states
    and more (codon's 64), as the JAX package's ``_pallas_forward`` takes
    its streaming kernel by default at a padded width of 32 or more.
    Otherwise the classic walk while a whole-tree scratch, b k n_inner
    sites (s + 1) float32, would fit ``CLASSIC_SCRATCH_BUDGET`` bytes (the
    line the turns put it at; no walk allocates that scratch now); beyond
    that the O(depth) slot walk: the stream walk at 20 states, the slot
    walk (B4) at 4 and, under ``PHYLO_FORCE_STREAM=0``, at 64, where JAX
    takes ``_dynamic_slot_kernel``.
    """
    if _stream_forced(s):
        return "stream"
    if b * k * n_inner * sites * (s + 1) * 4 <= CLASSIC_SCRATCH_BUDGET:
        return "classic"
    return "stream" if 20 <= s < 32 else "slot"


RowGeometry = collections.namedtuple(
    "RowGeometry", "lanes cols chunk stage_leaves smem_rows smem_bytes")


def _p_row(s: int) -> int:
    """Floats between the rows of a P block staged in shared memory
    (``csrc/pruning_common.cuh`` ``p_row``): S, and ``_WIDE_ROW`` at 64
    states, where a column's lanes form interleaved rows."""
    return _WIDE_ROW if s == KERNEL_STATES[-1] else s


def row_smem_bytes(s: int, cols: int, chunk: int, stage_leaves: bool,
                   smem_rows: int, fold: int = 1) -> int:
    """Dynamic shared memory of one B1 / B4 / B8 / B9 block
    (``csrc/pruning_rows.cuh`` ``row_smem_bytes``): a 3-stage ring, each
    stage the P blocks of ``chunk`` edges for ``fold`` categories (rows
    ``_p_row`` apart) and, with ``stage_leaves``, a leaf row of each edge
    for every one of ``cols`` columns, then ``smem_rows`` rows of S floats
    and an exponent for each category of a column."""
    stage = (chunk * fold * s * _p_row(s)
             + (chunk * cols * s if stage_leaves else 0))
    return 4 * (3 * stage + smem_rows * fold * cols * (s + 1))


def _rows_that_fit(s, cols, chunk, stage_leaves, fold=1) -> int:
    free = _REVERSE_SMEM - row_smem_bytes(s, cols, chunk, stage_leaves, 0,
                                          fold)
    return max(0, free // (4 * fold * cols * (s + 1)))


def _occupancy(b, groups, sites, s, rows, lanes, cols, chunk, stage_leaves,
               fold=1):
    """(warps an SM holds on average over the card, SMs the launch's blocks
    reach) for one geometry of ``groups`` column groups (categories over
    ``fold``): the blocks an SM can hold by threads, blocks and shared
    memory, capped by the launch's blocks over the SMs."""
    smem = row_smem_bytes(s, cols, chunk, stage_leaves, min(
        rows, _rows_that_fit(s, cols, chunk, stage_leaves, fold)), fold)
    threads = cols * lanes
    per_sm = min(_SM_BLOCKS, _SM_THREADS // threads, _SM_SMEM // (smem + 1024))
    blocks = -(-sites // cols) * groups * b
    return min(per_sm, blocks / _SMS) * threads / 32, min(blocks, _SMS)


@functools.lru_cache(maxsize=1024)   # a pure function of its arguments
def row_geometry(b: int, k: int, sites: int, s: int, rows: int, *,
                 lanes: Optional[int] = None, cols: Optional[int] = None,
                 chunk: Optional[int] = None,
                 stage_leaves: Optional[bool] = None,
                 smem_rows: Optional[int] = None,
                 fold: int = 1) -> RowGeometry:
    """The launch geometry of B1, B4, B8 or B9 for ``b`` batch elements,
    ``k`` categories, ``sites`` sites, ``s`` states and a walk of ``rows``
    rows, ``fold`` categories a column (B9's F: one of ``FOLD_WIDTHS[s]``,
    dividing ``k``, with its compiled lane counts; else 1); a keyword given
    fixes that choice. A column is a (batch element, group of ``fold``
    categories, site), and its rows take ``fold`` times the shared memory.

    Leaf rows go through the ring (``stage_leaves``) at 4 states in a
    launch of fewer than ``_ROW_WARPS`` warps an SM at one lane a column.
    Lanes a column (``_ROW_LANES``), columns a block (``cols``, a power of
    two from 32 to 256 / lanes) and edges a step (``_ROW_CHUNKS``) are the
    ones that put the most warps on an SM (``_occupancy``): the fewest
    lanes that reach ``_ROW_WARPS``, else the lanes with the most; for
    those lanes the most warps, then on the most SMs, then the longest
    step, then the widest block, among the blocks whose shared memory holds
    every row (or the ``smem_rows`` given). Where not even 32 columns hold
    them at the shortest step, every row lives in device memory
    (``smem_rows`` 0): keeping the rows that fit on the SM cost more in
    warps than it saved (B1 at 512-taxon LG: 8.77 ms with 82 of its 170
    rows on the SM, 1.76 ms with none; NVIDIA H100 80GB HBM3, 700 W,
    kernel_turns.py, PERF.md section 6). Shared memory never passes an
    H100 block's 232,448 bytes."""
    if fold != 1 and fold not in FOLD_WIDTHS.get(s, ()):
        raise ValueError(f"the fold kernel is compiled for "
                         f"{tuple(FOLD_WIDTHS.get(s, ()))} categories a "
                         f"column at {s} states, not {fold}")
    compiled = _ROW_LANES[s] if fold == 1 else FOLD_WIDTHS[s][fold]
    if lanes is not None and lanes not in compiled:
        raise ValueError(f"lanes must be one of {compiled} at {s} states "
                         f"and {fold} categories a column, not {lanes}")
    if k % fold:
        raise ValueError(f"fold {fold} does not divide {k} categories")
    groups = k // fold
    if stage_leaves is None:
        stage_leaves = s == 4 and b * groups * sites < _SMS * _ROW_WARPS * 32
    chunks = _ROW_CHUNKS if chunk is None else (chunk,)
    held_rows = rows if smem_rows is None else smem_rows
    if held_rows > _rows_that_fit(s, 32, min(chunks), stage_leaves, fold):
        held_rows = 0   # they do not fit: all in device memory
    best = None
    for n in (compiled if lanes is None else (lanes,)):
        shapes = [(k_, c) for k_ in chunks for c in (
            (256, 128, 64, 32) if cols is None else (cols,)) if c * n <= 256]
        if cols is None:
            shapes = [(k_, c) for k_, c in shapes
                      if _rows_that_fit(s, c, k_, stage_leaves,
                                        fold) >= held_rows]
        # the most warps, then on the most SMs, the longest step, the
        # widest block
        (warps, _), k_, c = max(
            (_occupancy(b, groups, sites, s, held_rows, n, c, k_,
                        stage_leaves, fold), k_, c) for k_, c in shapes)
        if best is None or warps > best[0]:
            best = (warps, n, c, k_)
        if warps >= _ROW_WARPS:
            break
    _, lanes, cols, chunk = best
    if row_smem_bytes(s, cols, chunk, stage_leaves, 0, fold) > _REVERSE_SMEM:
        raise ValueError(f"a ring of {chunk} edges x {cols} columns does not "
                         f"fit a block's shared memory at {s} states")
    fit = min(rows, _rows_that_fit(s, cols, chunk, stage_leaves, fold))
    if smem_rows is None:
        smem_rows = min(held_rows, fit)
    elif not 0 <= smem_rows <= fit:
        raise ValueError(f"smem_rows {smem_rows} is not in [0, {fit}]: "
                         f"{rows} rows, {fit} fit at {cols} columns")
    return RowGeometry(lanes, cols, chunk, bool(stage_leaves), smem_rows,
                       row_smem_bytes(s, cols, chunk, stage_leaves,
                                      smem_rows, fold))


def _pick_fold(k: int, s: int) -> int:
    """Categories per thread of the fold lowering under
    ``PHYLO_FOLD_CATEGORIES``, with the JAX package's ``_pick_fold``
    semantics: "0" (the default) 1; "auto" as many as divide ``k``, at 20
    and 64 states (not at 4); "<int>" at most that many. The widest F is
    the widest ``FOLD_WIDTHS`` compiles at ``s`` (the TPU's was 128 lanes:
    F = 2 at 64 states in both packages), and F must
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
    sites, s = leaves.shape[-2:]
    n_inner = schedule.n_nodes - schedule.n_leaves
    if walk == "auto":
        if _stream_forced(s) and len(schedule.order) <= STATIC_UNROLL_MAX:
            # the topology-compiled walk precedes streaming, as in
            # _pallas_forward
            return static_walk(p, leaves, schedule)
        walk = choose_walk(b, k, n_inner, sites, s)
        if walk == "classic":
            lowering, fold = choose_lowering(k, len(schedule.order), s)
            if lowering == "static":
                return static_walk(p, leaves, schedule)
            if lowering == "fold":
                return fold_walk(p, leaves, schedule, fold)
    if walk != "classic":
        return slot_walk(p, leaves, schedule, stream=walk == "stream")
    return _row_walk(p, leaves, schedule, "forward")


# the live-row kernels by kind: (entry point, launch counter)
_ROW_KERNELS = {
    "forward": ("pruning_forward_f32", "LAUNCHES"),
    "slot": ("pruning_slot_f32", "SLOT_LAUNCHES"),
    "fold": ("pruning_fold_f32", "FOLD_LAUNCHES"),
    "static": ("pruning_static_f32", "STATIC_LAUNCHES"),
}


@_on_p_device
def _row_walk(p: torch.Tensor, leaves: torch.Tensor, walk: WalkSchedule,
              kind: str, fold: int = 1,
              **geometry) -> Tuple[torch.Tensor, torch.Tensor]:
    """Root partials and root exponent count from the live-row walk of
    ``csrc/pruning_rows.cuh``: B1 (``kind`` "forward": ``walk.rows``), B4
    ("slot": ``walk.slots.rows``), B9 ("fold": the slots with ``fold``
    categories a column) or B8 ("static": the slots compiled into the
    topology's library, ``walk.static_library``). ``geometry``: keywords of
    ``row_geometry`` that fix its choices (``smem_rows``: rows kept in
    shared memory, the rest in device memory; ``lanes``, ``cols``,
    ``chunk``, ``stage_leaves``); B8's step is the one compiled in
    (``_static_chunk``), and another raises. CPU tensors take the plain
    version (``slot_walk_reference`` for B4, else
    ``forward_walk_reference``); CUDA tensors launch the kernel, once per
    batch chunk whose spilled rows fit free device memory, on the current
    stream."""
    s = leaves.shape[-1]
    if p.device.type == "cpu":
        plain = slot_walk_reference if kind == "slot" else forward_walk_reference
        return plain(p, leaves, walk)
    if kind == "static":
        step = _static_chunk(s)
        if geometry.setdefault("chunk", step) != step:
            raise ValueError(f"B8 is compiled for a step of {step} "
                             f"edges, not {geometry['chunk']}")
        _check_cuda(p, leaves)
        lib = walk.static_library(s)
    else:
        lib = _cuda_library(p, leaves)
    rw = walk.rows if kind == "forward" else walk.slots.rows
    batched = p.dim() == 5
    pb = p if batched else p[None]
    b, _, k = pb.shape[:3]
    sites = leaves.shape[-2]
    geo = row_geometry(b, k, sites, s, rw.n_rows, fold=fold, **geometry)
    n_spill = rw.n_rows - geo.smem_rows
    device = p.device
    edges, eword = rw.on(device)
    root = torch.empty((b, k, sites, s), dtype=torch.float32, device=device)
    root_e = torch.empty((b, k, sites), dtype=torch.float32, device=device)
    chunk = _batch_chunk(b, k * n_spill * sites * (s + 1) * 4, device)
    name, counter = _ROW_KERNELS[kind]
    if kind == "static":    # one entry point per compiled lane count
        name = f"{name}_l{geo.lanes}"
    launch = getattr(lib, name)
    # B9 takes its fold after the state count
    states = (s, fold) if kind == "fold" else (s,)
    stream = _stream(device)
    for b0 in range(0, b, chunk):
        nb = min(chunk, b - b0)
        spill = spill_e = None
        if n_spill:
            spill = torch.empty((nb, k, n_spill, sites, s),
                                dtype=torch.float32, device=device)
            spill_e = torch.empty((nb, k, n_spill, sites),
                                  dtype=torch.float32, device=device)
        leaf_ptr, leaf_batch = _leaf_args(leaves, b0, nb)
        rc = launch(
            pb[b0:b0 + nb].data_ptr(), leaf_ptr, edges.data_ptr(),
            eword.data_ptr(), None if spill is None else spill.data_ptr(),
            None if spill_e is None else spill_e.data_ptr(),
            root[b0:b0 + nb].data_ptr(), root_e[b0:b0 + nb].data_ptr(), nb,
            k, *states, walk.n_nodes, walk.n_leaves, len(rw.edges), sites,
            rw.n_rows, geo.smem_rows, geo.lanes, geo.cols, geo.chunk,
            int(geo.stage_leaves), stream, leaf_batch)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
        globals()[counter] += 1
        LAUNCHES_BY_STATES[(counter, s)] += 1
        del spill, spill_e
    return (root, root_e) if batched else (root[0], root_e[0])


def static_walk(
    p: torch.Tensor, leaves: torch.Tensor, walk: WalkSchedule, **geometry
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Root partials and root exponent count by the walk compiled for this
    topology (B8, ``pruning_static_f32``: the live-row walk over the DFS
    slots, every edge's word a constant). Same contract as
    ``forward_walk_reference`` and the forward kernel's bits. CPU tensors
    take ``forward_walk_reference``; CUDA tensors build the topology's
    library at first use (``WalkSchedule.static_library``; no fallback when
    the build fails) and launch it (``_row_walk``; ``geometry`` as there)."""
    _check(p, leaves, walk)
    _not_differentiable("static_walk", p, leaves)
    if p.device.type == "cpu":
        return forward_walk_reference(p, leaves, walk)
    return _row_walk(p, leaves, walk, "static", **geometry)


def fold_walk(
    p: torch.Tensor, leaves: torch.Tensor, walk: WalkSchedule, fold: int,
    **geometry
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Root partials and root exponent count with ``fold`` categories a
    column (B9, ``pruning_fold_f32``: the live-row walk over the DFS slots;
    the DNA pack is ``fold=2`` at 4 states). Same contract as
    ``forward_walk_reference`` and the forward kernel's bits. ``fold`` must
    divide K and, on the card, be one of ``FOLD_WIDTHS`` at the state
    count. CPU tensors take ``forward_walk_reference``; CUDA tensors launch
    the kernel (``_row_walk``; ``geometry`` as there)."""
    _check(p, leaves, walk)
    _not_differentiable("fold_walk", p, leaves)
    k, s = p.shape[-3], leaves.shape[-1]
    if fold < 1 or k % fold:
        raise ValueError(f"fold {fold} does not divide {k} categories")
    if p.device.type == "cpu":
        return forward_walk_reference(p, leaves, walk)
    if fold not in FOLD_WIDTHS[s]:
        raise NotImplementedError(
            f"pruning_fold_f32 is compiled for {tuple(FOLD_WIDTHS[s])} "
            f"categories a column at {s} states, not {fold}")
    return _row_walk(p, leaves, walk, "fold", fold=fold, **geometry)


@_on_p_device
def slot_walk(
    p: torch.Tensor, leaves: torch.Tensor, walk: WalkSchedule,
    stream: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Root partials and root exponent count by the DFS slot walk, whose
    rows are O(depth) slots instead of one per internal node. Same contract
    as ``forward_walk_reference`` and the same bits. CPU tensors take
    ``slot_walk_reference``; CUDA tensors launch ``pruning_slot_f32`` (B4,
    the slots in shared memory: ``_row_walk``) or, with ``stream``,
    ``pruning_stream_f32`` (B5: P staged in shared memory, the slots in
    device memory, (B, K, n_slots, sites, S + 1) float32, one launch per
    batch chunk that fits free device memory), on the current stream.
    """
    global STREAM_LAUNCHES
    _check(p, leaves, walk)
    _not_differentiable("slot_walk", p, leaves)
    if not stream:
        return _row_walk(p, leaves, walk, "slot")
    if p.device.type == "cpu":
        return slot_walk_reference(p, leaves, walk)
    lib = _cuda_library(p, leaves)
    batched = p.dim() == 5
    pb = p if batched else p[None]
    b, _, k = pb.shape[:3]
    sites, s = leaves.shape[-2:]
    device = p.device
    sl = walk.slots
    nslot, cnode, csrc, cleaf, counts = sl.on(device)
    if 4 * 3 * cnode.shape[1] * s * _p_row(s) > _REVERSE_SMEM:
        raise ValueError(
            f"the stream walk's P stage does not hold a node of "
            f"{cnode.shape[1]} children at {s} states; compile the schedule "
            "binarized")
    root = torch.empty((b, k, sites, s), dtype=torch.float32, device=device)
    root_e = torch.empty((b, k, sites), dtype=torch.float32, device=device)
    chunk = _batch_chunk(b, k * sl.n_slots * sites * (s + 1) * 4, device)
    cuda_stream = _stream(device)
    for b0 in range(0, b, chunk):
        nb = min(chunk, b - b0)
        slots = torch.empty((nb, k, sl.n_slots, sites, s),
                            dtype=torch.float32, device=device)
        slots_e = torch.empty((nb, k, sl.n_slots, sites),
                              dtype=torch.float32, device=device)
        leaf_ptr, leaf_batch = _leaf_args(leaves, b0, nb)
        rc = lib.pruning_stream_f32(
            pb[b0:b0 + nb].data_ptr(), leaf_ptr, nslot.data_ptr(),
            cnode.data_ptr(), csrc.data_ptr(), cleaf.data_ptr(),
            counts.data_ptr(), slots.data_ptr(), slots_e.data_ptr(),
            root[b0:b0 + nb].data_ptr(), root_e[b0:b0 + nb].data_ptr(), nb,
            k, s, walk.n_nodes, sl.n_slots, len(sl.nslot), cnode.shape[1],
            sites, cuda_stream, leaf_batch,
        )
        if rc != 0:
            raise RuntimeError(f"pruning_stream_f32 launch failed: CUDA "
                               f"error {rc}")
        STREAM_LAUNCHES += 1
        LAUNCHES_BY_STATES[("STREAM_LAUNCHES", s)] += 1
        del slots, slots_e
    return (root, root_e) if batched else (root[0], root_e[0])


def saveall_stage(s: int, n_edges: int) -> Tuple[int, int]:
    """(edges a step stages, bytes of shared memory) of a saveall launch at
    ``s`` states over a walk of ``n_edges`` edges (``WalkSchedule.edges``):
    the kernel stages P in a ring of 3 steps, each the P blocks of
    ``_SAVEALL_CHUNK[s]`` consecutive edges of the walk (fewer where the
    walk has fewer), whatever node they belong to, so the ring does not
    depend on the widest node's children (rows ``_p_row`` apart)."""
    chunk = max(1, min(n_edges, _SAVEALL_CHUNK[s]))
    return chunk, 4 * 3 * chunk * s * _p_row(s)


@_on_p_device
def saveall_walk(
    p: torch.Tensor, leaves: torch.Tensor, walk: WalkSchedule
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every internal node's partials and exponent count (the gradient's
    residuals). Same contract as ``saveall_walk_reference``; CUDA tensors
    launch the saveall kernel with ``saveall_stage``'s chunks of edges and
    ``_SAVEALL_LANES`` lanes a column. The residuals of the whole batch are
    one output, so they must fit free device memory at once (else
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
    sites, s = leaves.shape[-2:]
    n_inner = walk.n_nodes - walk.n_leaves
    device = p.device
    need = b * k * n_inner * sites * (s + 1) * 4
    budget = _device_budget(need, device)
    if need > budget:
        raise MemoryError(
            f"the gradient's residuals need {need} bytes but only {budget} "
            f"bytes are free on {device}; they bound the whole-tree "
            "gradient (past the deferred reverse's scratch the classic "
            "reverse runs, which stores no gy): use fewer sites or a "
            "smaller batch"
        )
    order, _, counts = walk.on(device)
    edges = walk.edges_on(device)
    chunk, _ = saveall_stage(s, len(walk.edges))
    res_x = torch.empty((b, k, n_inner, sites, s), dtype=torch.float32,
                        device=device)
    res_e = torch.empty((b, k, n_inner, sites), dtype=torch.float32,
                        device=device)
    stream = _stream(device)
    for b0 in range(0, b, _MAX_GRID_Z):
        nb = min(_MAX_GRID_Z, b - b0)
        leaf_ptr, leaf_batch = _leaf_args(leaves, b0, nb)
        rc = lib.pruning_saveall_f32(
            pb[b0:b0 + nb].data_ptr(), leaf_ptr, order.data_ptr(),
            edges.data_ptr(), counts.data_ptr(),
            res_x[b0:b0 + nb].data_ptr(), res_e[b0:b0 + nb].data_ptr(), nb,
            k, s, walk.n_nodes, walk.n_leaves, len(walk.order),
            len(walk.edges), sites, chunk, _SAVEALL_LANES[s], stream,
            leaf_batch,
        )
        if rc != 0:
            raise RuntimeError(f"pruning_saveall_f32 launch failed: CUDA "
                               f"error {rc}")
        SAVEALL_LAUNCHES += 1
        LAUNCHES_BY_STATES[("SAVEALL_LAUNCHES", s)] += 1
    return (res_x, res_e) if batched else (res_x[0], res_e[0])


def _reverse_smem_bytes(tile: int, cmax: int, s: int) -> int:
    """Shared memory of one deferred reverse block of ``tile`` sites: the
    3-stage P ring, two visits' warp dP sums and, at 20 states, each warp's
    gy and x rows (csrc/pruning_reverse.cu); at 64 states the P ring with
    rows ``_WIDE_ROW`` floats apart and the block's gy and x tiles."""
    if s == KERNEL_STATES[-1]:
        return 4 * _WIDE_ROW * (3 * cmax * s + 2 * tile)
    warps = tile // 32
    floats = (3 + 2 * warps) * cmax * s * s
    if s != 4:
        floats += warps * 2 * 32 * s
    return 4 * floats


def reverse_tile(s: int, cmax: int) -> int:
    """Sites per block of a deferred reverse launch at ``s`` states with at
    most ``cmax`` children a node: the widest of ``_REVERSE_TILES`` whose
    block fits ``_REVERSE_SMEM`` bytes of shared memory. The widest was the
    fastest at every shape measured on an NVIDIA H100 80GB HBM3 (700 W),
    and at B = 1 every width took the same device time (kernel_turns.py,
    PERF.md section 6). At 64 states the block is ``_WIDE_TILE`` sites (256
    threads, four a column), so a node of at most 3 children fits. Raises
    where not even one warp's block fits (a node of very many children; the
    classic reverse takes any)."""
    for tile in ((_WIDE_TILE,) if s == KERNEL_STATES[-1] else _REVERSE_TILES):
        if _reverse_smem_bytes(tile, cmax, s) <= _REVERSE_SMEM:
            return tile
    raise ValueError(
        f"the deferred reverse's shared memory does not hold a node of "
        f"{cmax} children at {s} states; use PHYLO_DEFERRED_VJP=0")


def reverse_scratch(b: int, k: int, n_nodes: int, n_gslots: int,
                    sites: int, s: int, cmax: int) -> Tuple[int, int]:
    """(sites per block, bytes of scratch) of a deferred reverse launch
    (``reverse_tile``). The walk keeps internal nodes' outside vectors in
    the g slots of ``ReverseSchedule``, (b, k, n_gslots, sites, S) float32,
    and sums dP inside the walk into one row per block, (b, k,
    ceil(sites / tile), n_nodes, S, S) float32: S / tile of a gy store per
    whole tile of sites, which it does not keep."""
    tile = reverse_tile(s, cmax)
    slot_bytes = 4 * b * k * max(n_gslots, 1) * sites * s
    return tile, slot_bytes + 4 * b * k * -(-sites // tile) * n_nodes * s * s


@_on_p_device
def reverse_walk(
    p: torch.Tensor, leaves: torch.Tensor, res_x: torch.Tensor,
    res_e: torch.Tensor, lam: torch.Tensor, freqs: torch.Tensor,
    walk: WalkSchedule, want_dleaf: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """dP (and optionally the leaves' cotangent) of the pruning walk.

    Same contract as ``reverse_walk_reference``. CUDA tensors launch the
    reverse kernel (the walk in the order of ``walk.reverse``, then its
    deterministic dP pass) once per batch chunk whose scratch
    (``reverse_scratch``) fits free device memory, on the current stream."""
    global REVERSE_LAUNCHES
    _check_residuals(p, leaves, res_x, res_e, walk, freqs=freqs,
                     lam=(lam, (p.shape[-3], leaves.shape[-2])))
    _not_differentiable("reverse_walk", p, leaves, res_x, res_e, lam, freqs)
    if p.device.type == "cpu":
        return reverse_walk_reference(p, leaves, res_x, res_e, lam, freqs,
                                      walk, want_dleaf)
    lib = _cuda_library(p, leaves, res_x, res_e, lam, freqs)
    batched = p.dim() == 5
    pb, rx, re, lm = ((p, res_x, res_e, lam) if batched else
                      (p[None], res_x[None], res_e[None], lam[None]))
    b, n_nodes, k = pb.shape[:3]
    sites, s = leaves.shape[-2:]
    device = p.device
    rs = walk.reverse
    n_gslots = max(rs.n_gslots, 1)
    rnode, gslot, children, cslot, counts = rs.on(device)
    dp = torch.empty_like(pb)
    dleaf = (torch.empty((b, k, walk.n_leaves, sites, s),
                         dtype=torch.float32, device=device)
             if want_dleaf else None)
    cmax = children.shape[1]
    tile, nbytes = reverse_scratch(b, k, n_nodes, n_gslots, sites, s, cmax)
    chunk = _batch_chunk(b, -(-nbytes // b), device)
    stream = _stream(device)
    for b0 in range(0, b, chunk):
        nb = min(chunk, b - b0)
        g_slots = torch.empty((nb, k, n_gslots, sites, s),
                              dtype=torch.float32, device=device)
        rows = torch.empty((nb, k, -(-sites // tile), n_nodes, s, s),
                           dtype=torch.float32, device=device)
        leaf_ptr, leaf_batch = _leaf_args(leaves, b0, nb)
        per_b = freqs.dim() == 2      # (B, S): each element's own freqs
        rc = lib.pruning_reverse_f32(
            pb[b0:b0 + nb].data_ptr(), leaf_ptr, rnode.data_ptr(),
            gslot.data_ptr(), children.data_ptr(), cslot.data_ptr(),
            counts.data_ptr(), rx[b0:b0 + nb].data_ptr(),
            re[b0:b0 + nb].data_ptr(), lm[b0:b0 + nb].data_ptr(),
            (freqs[b0:b0 + nb] if per_b else freqs).data_ptr(),
            g_slots.data_ptr(), rows.data_ptr(),
            dp[b0:b0 + nb].data_ptr(),
            None if dleaf is None else dleaf[b0:b0 + nb].data_ptr(),
            nb, k, s, n_nodes, walk.n_leaves, len(rs.rnode), cmax, sites,
            n_gslots, tile, walk.root, stream, leaf_batch, s if per_b else 0,
        )
        if rc != 0:
            raise RuntimeError(f"pruning_reverse_f32 launch failed: CUDA "
                               f"error {rc}")
        REVERSE_LAUNCHES += 1
        LAUNCHES_BY_STATES[("REVERSE_LAUNCHES", s)] += 1
        del g_slots, rows
    if not batched:
        dp = dp[0]
        dleaf = None if dleaf is None else dleaf[0]
    return dp, dleaf


def _classic_reverse_tile(s: int) -> int:
    """Sites a block of the classic reverse at ``s`` states:
    ``_WIDE_TILE`` at 64 states (its four-lane layout), else
    ``_CLASSIC_REVERSE_TILE``."""
    return _WIDE_TILE if s == KERNEL_STATES[-1] else _CLASSIC_REVERSE_TILE


def classic_reverse_scratch(b: int, k: int, n_nodes: int, n_gslots: int,
                            sites: int, s: int) -> Tuple[int, int, int]:
    """(dP rows per (batch, category), bytes of g slots, bytes of one dP
    row over the batch) of a classic reverse launch. Each block owns one
    row of per-node S x S partial sums and walks every ``rows``-th tile of
    ``_classic_reverse_tile`` sites, so the rows are capped by the launch's
    block count, not by the sites: its scratch is the g slots, (b, k,
    n_gslots, sites, S) float32, and rows x (b, k, n_nodes, S, S) float32
    (the deferred reverse's rows grow with its site tiles,
    ``reverse_scratch``)."""
    n_tiles = -(-sites // _classic_reverse_tile(s))
    rows = min(n_tiles, max(1, -(-_CLASSIC_REVERSE_BLOCKS[s] // (b * k))))
    return (rows, 4 * b * k * max(n_gslots, 1) * sites * s,
            4 * b * k * n_nodes * s * s)


def classic_reverse_stage(s: int, cmax: int) -> Tuple[int, int]:
    """(children a staged visit may have, bytes of shared memory) of a
    classic reverse block of ``_classic_reverse_tile`` sites at ``s``
    states whose widest node has ``cmax`` children: the deferred reverse's
    block layout (``_reverse_smem_bytes``: the 3-stage P ring, two steps'
    warp dP sums and, at 20 states, each warp's gy and x rows; at 64 states
    the ring with rows ``_WIDE_ROW`` apart and the gy and x tiles, 3
    children at most) for the most children up to ``cmax`` that fit
    ``_CLASSIC_STAGE_BYTES`` (at least one). A visit with more children
    reads its P through L1, in groups of that many, so the block does not
    grow with ``cmax`` past them."""
    tile = _classic_reverse_tile(s)
    per_child = _reverse_smem_bytes(tile, 2, s) - _reverse_smem_bytes(
        tile, 1, s)
    fixed = _reverse_smem_bytes(tile, 1, s) - per_child
    children = max(1, min(cmax, (_CLASSIC_STAGE_BYTES - fixed) // per_child))
    return children, _reverse_smem_bytes(tile, children, s)


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


@_on_p_device
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
    summed per block inside it, P staged as ``classic_reverse_stage``
    sizes it, then a fixed-order sum of the blocks' rows) on the current
    stream, once per 65535 batch elements, after
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
    sites, s = leaves.shape[-2:]
    device = p.device
    rs = walk.reverse
    rows = _classic_rows(b, k, n_nodes, rs.n_gslots, sites, s, device)
    rnode, gslot, children, cslot, counts = rs.on(device)
    stage_children, _ = classic_reverse_stage(s, children.shape[1])
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
        leaf_ptr, leaf_batch = _leaf_args(leaves, b0, nb)
        rc = lib.pruning_classic_reverse_f32(
            pb[b0:b0 + nb].data_ptr(), leaf_ptr, rnode.data_ptr(),
            gslot.data_ptr(), children.data_ptr(), cslot.data_ptr(),
            counts.data_ptr(), node_seed.data_ptr(),
            rx[b0:b0 + nb].data_ptr(), re[b0:b0 + nb].data_ptr(),
            gs[b0:b0 + nb].data_ptr(), g_slots.data_ptr(),
            dp_rows.data_ptr(), dp[b0:b0 + nb].data_ptr(),
            None if dleaf is None else dleaf[b0:b0 + nb].data_ptr(),
            nb, k, s, n_nodes, walk.n_leaves, len(rs.rnode),
            children.shape[1], sites, len(seeds), max(rs.n_gslots, 1), rows,
            _classic_reverse_tile(s), stage_children, stream, leaf_batch,
        )
        if rc != 0:
            raise RuntimeError(f"pruning_classic_reverse_f32 launch failed: "
                               f"CUDA error {rc}")
        CLASSIC_REVERSE_LAUNCHES += 1
        LAUNCHES_BY_STATES[("CLASSIC_REVERSE_LAUNCHES", s)] += 1
        del g_slots, dp_rows
    if not batched:
        dp = dp[0]
        dleaf = None if dleaf is None else dleaf[0]
    return dp, dleaf


def choose_reverse(b: int, k: int, n_nodes: int, n_gslots: int,
                   sites: int, s: int, device, cmax: int) -> str:
    """The gradient's reverse walk: "deferred" (``reverse_walk``, B3) or
    "classic" (``classic_reverse_walk``, B7).

    ``PHYLO_DEFERRED_VJP`` is read as the JAX package reads it: "0" forces
    the classic reverse, "1" the deferred one, anything else ("auto") the
    rule: the deferred reverse while one batch element's share of its
    scratch (``reverse_scratch``: g slots and dP rows) fits
    ``_device_budget`` (B3 splits a batch into launches that fit) and its
    block's shared memory holds a node of ``cmax`` children, else the
    classic one, whose dP rows are capped by its block count. CPU tensors
    take the deferred reverse's plain version under "auto": the rule weighs
    the card's memory."""
    env = os.environ.get("PHYLO_DEFERRED_VJP", "auto")
    if env == "0":
        return "classic"
    if env == "1" or torch.device(device).type == "cpu":
        return "deferred"
    try:
        _, nbytes = reverse_scratch(b, k, n_nodes, n_gslots, sites, s, cmax)
    except ValueError:
        return "classic"
    need = -(-nbytes // b)
    return "deferred" if need <= _device_budget(need, device) else "classic"


def _root_loglik(root_p, root_e, freqs):
    """(ll, pi . x_root, x_root) in ``freqs``' dtype from the walk's root;
    ``freqs`` (S,), or (B, S) for a batched root (B, K, sites, S)."""
    root_r = root_p.to(freqs.dtype)
    if freqs.dim() == 1:
        dot = torch.einsum("...ksi,i->...ks", root_r, freqs)
    else:
        dot = torch.einsum("bksi,bi->bks", root_r, freqs)
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
    dfreqs = sum lambda x_root outside the kernel in that dtype. Per-batch
    leaves (B, n_leaves, sites, S) and freqs (B, S), a stack of loci, get
    their own cotangents: dleaf summed over the categories only, dfreqs
    (B, S). It has no second derivative (``first_derivative_only``)."""

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
            sites, s = leaves.shape[-2:]
            b = p.shape[0] if p.dim() == 5 else 1
            if choose_reverse(b, p.shape[-3], walk.n_nodes,
                              walk.reverse.n_gslots, sites, s, p.device,
                              walk.children.shape[1]) == "deferred":
                dp, dleaf_k = reverse_walk(
                    p, leaves, res_x, res_e, lam32, f32, walk,
                    want_dleaf=ctx.needs_input_grad[1])
            else:
                pi = f32 if f32.dim() == 1 else f32[:, None, None, :]
                gseed = (lam32[..., None] * pi).unsqueeze(-3).contiguous()
                dp, dleaf_k = classic_reverse_walk(
                    p, leaves, res_x, res_e, gseed, [walk.root], walk,
                    want_dleaf=ctx.needs_input_grad[1])
            if not ctx.needs_input_grad[0]:
                dp = None
            if dleaf_k is not None and leaves.dim() == 4:   # per batch
                dleaf = dleaf_k.sum(dim=1)
            elif dleaf_k is not None:   # shared by batch and category
                dleaf = dleaf_k.sum(dim=tuple(range(dleaf_k.dim() - 3)))
        if ctx.needs_input_grad[2]:
            dfreqs = (torch.einsum("...ks,...ksi->i", lam, root_r)
                      if freqs.dim() == 1 else
                      torch.einsum("bks,bksi->bi", lam, root_r))
        return dp, dleaf, dfreqs, None


def _pad_states(t: torch.Tensor, s_pad: int, dims: int) -> torch.Tensor:
    """``t`` with its last ``dims`` dimensions (each S long) padded with
    zeros to ``s_pad`` (differentiable: the gradient is the slice)."""
    d = s_pad - t.shape[-1]
    return torch.nn.functional.pad(t, (0, d) * dims) if d else t


class _PaddedLeaves:
    """The leaves padded to ``padded_states``, made once per leaf tensor and
    kept: the engines pass the same leaves on every call, and at 100 taxa x
    4096 codon patterns the padded copy is 105 MB. Leaves that require grad
    are padded per call (their cotangent flows back through the pad)."""

    def __init__(self):
        self._src = self._version = self._padded = None

    def __call__(self, leaves: torch.Tensor, s_pad: int) -> torch.Tensor:
        if leaves.shape[-1] == s_pad:
            return leaves
        if leaves.requires_grad and torch.is_grad_enabled():
            return _pad_states(leaves, s_pad, 1)
        if (leaves is not self._src or leaves._version != self._version
                or self._padded.shape[-1] != s_pad):
            self._padded = _pad_states(leaves.detach(), s_pad, 1).contiguous()
            self._src, self._version = leaves, leaves._version
        return self._padded


def make_fused_loglik_fn(schedule: PruningSchedule, walk=None):
    """Counterpart of the whole-tree ``pallas_pruning.make_pallas_loglik_fn``.

    Returns ``f(p_matrices (B?, n_nodes, K, S, S), leaf_partials
    (n_leaves, sites, S), freqs (S,)) -> ll (B?, K, sites)`` with
    ``ll[k, s] = log(sum_i freqs_i * true_root_partials[k, s, i])``. The
    walk runs in float32; the root reduction and the exponent count x ln 2
    run in ``freqs.dtype`` (pass float64 freqs for the precision plan).
    With P (B, n_nodes, K, S, S) the leaves may be (B, n_leaves, sites, S)
    and ``freqs`` (B, S), one set a batch element: a stack of loci, as the
    JAX function under ``vmap`` takes them; one launch of each walk scores
    the whole stack.

    Differentiable in all three inputs. When P or the leaves require grad
    (and grad mode is on), the saveall kernel runs forward and a reverse
    kernel backward (``choose_reverse``: the deferred one while its
    scratch fits, else the classic one), over the whole tree; otherwise one
    forward walk runs
    alone, chosen by ``choose_walk``: the classic walk while the classic
    lowerings' whole-tree scratch would fit ``CLASSIC_SCRATCH_BUDGET``,
    else the slot walk (DNA) or the stream walk (protein; at 64 states
    always unless ``PHYLO_FORCE_STREAM=0``, and at every width under
    ``PHYLO_FORCE_STREAM=1``). The leaves' cotangent is computed only when
    they require grad (the engine passes them as data).

    A state count that is not compiled (``KERNEL_STATES``) is padded with
    zero states to ``padded_states``: P with zero rows and columns, the
    leaves with zero columns (kept across calls), ``freqs`` with zeros. The
    padded states stay exact zeros through every walk, so the real states'
    fmaf chains and the rescale's maximum are those of the unpadded walk,
    and the gradients are sliced back to S. ``walk``: the schedule's
    ``WalkSchedule`` where the caller keeps one (the engine's).
    """
    walk = WalkSchedule(schedule) if walk is None else walk
    pad_leaves = _PaddedLeaves()

    def fused_ll(p_matrices, leaf_partials, freqs):
        s_pad = padded_states(leaf_partials.shape[-1])
        p32 = _pad_states(p_matrices.to(torch.float32), s_pad, 2).contiguous()
        l32 = pad_leaves(leaf_partials.to(torch.float32).contiguous(), s_pad)
        freqs = _pad_states(freqs, s_pad, 1)
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
        sites, s = leaves.shape[-2:]
        per_site = (ctx.walk.n_nodes * p.shape[-3] * s * leaves.element_size()
                    * (p.shape[0] if p.dim() == 5 else 1))
        step = max(1, _REPLAY_BYTES // per_site)
        dp = None
        dleaf = torch.zeros_like(leaves) if need_l else None
        for s0 in range(0, sites, step):
            sl = slice(s0, min(sites, s0 + step))
            with torch.enable_grad():
                pp = p.detach().requires_grad_(need_p)
                ll = leaves[..., sl, :].detach().requires_grad_(need_l)
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
                dleaf[..., sl, :] = grads[0]
        if need_p and dp is None:
            dp = torch.zeros_like(p)
        return dp, dleaf, None, None


def make_cuda_prune_fn(schedule: PruningSchedule, walk=None):
    """Counterpart of ``pallas_pruning.make_pallas_prune_fn``: the pruning
    function of the engines that take the root partials themselves (model
    and profile mixtures).

    Returns ``prune(p_matrices (B?, n_nodes, K, S, S), leaf_partials
    (n_leaves, sites, S), or (B, n_leaves, sites, S) with a batched P) ->
    (root_partials (B?, K, sites, S), root_logscale (B?, K, sites))``: the
    walk runs in float32 through ``forward_walk``,
    whatever walk and lowering it picks; the root partials come back in the
    leaves' dtype and the logscale, in ln units, in float64 (JAX's comes in
    the leaves' dtype; float64 keeps the exponent count x ln 2 exact for the
    engines' float64 root reduction). Differentiable in both inputs: the
    backward replays ``ops.pruning.make_prune_fn`` under autograd on the
    saved inputs, as ``make_pallas_prune_fn`` replays the XLA pruner.
    A state count that is not compiled is padded with zero states to
    ``padded_states`` as in ``make_fused_loglik_fn`` (the leaves kept across
    calls), and the root partials are sliced back to S. ``walk`` as in
    ``make_fused_loglik_fn``.
    """
    walk = WalkSchedule(schedule) if walk is None else walk
    plain = make_prune_fn(schedule)
    pad_leaves = _PaddedLeaves()

    def prune(p_matrices, leaf_partials):
        s = leaf_partials.shape[-1]
        s_pad = padded_states(s)
        root, logscale = _CudaPrune.apply(
            _pad_states(p_matrices, s_pad, 2),
            pad_leaves(leaf_partials, s_pad), walk, plain)
        return root[..., :s], logscale

    return prune
