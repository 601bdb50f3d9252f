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

``make_fused_loglik_fn`` ties them into a differentiable per-(category,
site) log-likelihood: value calls run ``forward_walk``; calls that need a
gradient run ``saveall_walk`` forward and ``reverse_walk`` backward.
``LAUNCHES``, ``SLOT_LAUNCHES``, ``STREAM_LAUNCHES``, ``SAVEALL_LAUNCHES``
and ``REVERSE_LAUNCHES`` count kernel launches, so a run can show its main
path went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from phylo_utils_tpu_torch.ops.pruning import LN2, exp2_int, pow2_rescale
from phylo_utils_tpu_torch.trees import PruningSchedule

__all__ = [
    "LAUNCHES",
    "SLOT_LAUNCHES",
    "STREAM_LAUNCHES",
    "SAVEALL_LAUNCHES",
    "REVERSE_LAUNCHES",
    "CLASSIC_SCRATCH_BUDGET",
    "WalkSchedule",
    "SlotSchedule",
    "choose_walk",
    "forward_walk",
    "forward_walk_reference",
    "slot_walk",
    "slot_walk_reference",
    "saveall_walk",
    "saveall_walk_reference",
    "reverse_walk",
    "reverse_walk_reference",
    "make_fused_loglik_fn",
]

LAUNCHES = 0            # pruning_forward_f32
SLOT_LAUNCHES = 0       # pruning_slot_f32
STREAM_LAUNCHES = 0     # pruning_stream_f32
SAVEALL_LAUNCHES = 0    # pruning_saveall_f32
REVERSE_LAUNCHES = 0    # pruning_reverse_f32

# CUDA caps gridDim.z (the batch axis of the launch) at 65535
_MAX_GRID_Z = 65535
# share of the free device memory one launch's scratch may take
_MEM_FRACTION = 0.9
# the state counts the kernels are compiled for (DNA, protein)
_KERNEL_STATES = (4, 20)
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
    order, children, counts = _postorder_arrays(schedule)
    n_leaves = schedule.n_leaves
    cmax = children.shape[1]
    kids = {
        int(order[i]): [int(children[i, c]) for c in range(int(counts[i]))]
        for i in range(order.shape[0])
    }
    root = int(order[-1])
    post = []
    stack = [(root, False)]
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


class WalkSchedule:
    """The post-order walk of one schedule: host arrays plus their int32
    copies on each device that has used them, and (built at first use) the
    schedule's DFS slot walk, ``slots``."""

    def __init__(self, schedule: PruningSchedule):
        self.order, self.children, self.counts = _postorder_arrays(schedule)
        if len(self.order) == 0:
            raise ValueError("the tree has no internal node to walk")
        self.n_nodes = schedule.n_nodes
        self.n_leaves = schedule.n_leaves
        self.root = int(self.order[-1])    # the root is last in post-order
        self._schedule = schedule
        self._slots = None
        self._on_device = {}

    @property
    def slots(self) -> SlotSchedule:
        if self._slots is None:
            self._slots = SlotSchedule(self._schedule)
        return self._slots

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


def _check_residuals(p, leaves, res_x, res_e, lam, freqs, walk):
    _check(p, leaves, walk)
    lead = tuple(p.shape[:-4])
    k, sites, s = p.shape[-3], leaves.shape[1], leaves.shape[2]
    n_inner = walk.n_nodes - walk.n_leaves
    want = {
        "res_x": (res_x, lead + (k, n_inner, sites, s)),
        "res_e": (res_e, lead + (k, n_inner, sites)),
        "lam": (lam, lead + (k, sites)),
        "freqs": (freqs, (s,)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {t.dtype}")
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, P on {p.device}")


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
    _check_residuals(p, leaves, res_x, res_e, lam, freqs, walk)
    batched = p.dim() == 5
    pb, rx, re, lm = ((p, res_x, res_e, lam) if batched else
                      (p[None], res_x[None], res_e[None], lam[None]))
    n_leaves = walk.n_leaves

    def x_of(c):
        return leaves[c] if c < n_leaves else rx[:, :, c - n_leaves]

    def y_of(c):
        eq = "bkij,sj->bksi" if c < n_leaves else "bkij,bksj->bksi"
        return torch.einsum(eq, pb[:, c], x_of(c))

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


def _cuda_library(p: torch.Tensor, *tensors: torch.Tensor):
    """The kernels' library for CUDA inputs; raises on what they do not
    take."""
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


_WALKS = ("auto", "classic", "slot", "stream")


def forward_walk(
    p: torch.Tensor, leaves: torch.Tensor, schedule: WalkSchedule,
    walk: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Root partials and root exponent count of the pruning walk.

    Same contract as ``forward_walk_reference``. ``walk``: "classic" (every
    internal node kept), "slot" or "stream" (``slot_walk``), or "auto"
    (``choose_walk``); all give the same bits. CPU tensors take the plain
    versions; CUDA tensors launch the kernel (one launch per batch chunk
    that fits free device memory) on the current stream.
    """
    global LAUNCHES
    if walk not in _WALKS:
        raise ValueError(f"walk must be one of {_WALKS}, not {walk!r}")
    _check(p, leaves, schedule)
    _not_differentiable("forward_walk", p, leaves)
    batched = p.dim() == 5
    pb = p if batched else p[None]
    b, _, k = pb.shape[:3]
    sites, s = leaves.shape[1:]
    n_inner = schedule.n_nodes - schedule.n_leaves
    if walk == "auto":
        walk = choose_walk(b, k, n_inner, sites, s)
    if walk != "classic":
        return slot_walk(p, leaves, schedule, stream=walk == "stream")
    if p.device.type == "cpu":
        return forward_walk_reference(p, leaves, schedule)
    lib = _cuda_library(p, leaves)
    device = p.device
    order, children, counts = schedule.on(device)
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
        rc = lib.pruning_forward_f32(
            pb[b0:b0 + nb].data_ptr(), leaves.data_ptr(), order.data_ptr(),
            children.data_ptr(), counts.data_ptr(), scratch.data_ptr(),
            scratch_e.data_ptr(), root[b0:b0 + nb].data_ptr(),
            root_e[b0:b0 + nb].data_ptr(), nb, k, s, schedule.n_nodes,
            schedule.n_leaves, len(schedule.order), children.shape[1],
            sites, stream,
        )
        if rc != 0:
            raise RuntimeError(f"pruning_forward_f32 launch failed: CUDA "
                               f"error {rc}")
        LAUNCHES += 1
        del scratch, scratch_e
    return (root, root_e) if batched else (root[0], root_e[0])


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
            f"bytes are free on {device}; use fewer sites or a smaller batch"
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
    _check_residuals(p, leaves, res_x, res_e, lam, freqs, walk)
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
    computed in the reduction dtype and cast to float32, and forms
    dfreqs = sum lambda x_root outside the kernel in that dtype."""

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
    def backward(ctx, ct):
        p, leaves, freqs, res_x, res_e, dot, root_r = ctx.saved_tensors
        lam = ct / dot
        dp = dleaf = dfreqs = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            dp, dleaf_k = reverse_walk(
                p, leaves, res_x, res_e, lam.to(torch.float32).contiguous(),
                freqs.to(torch.float32).contiguous(), ctx.walk,
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
    (and grad mode is on), the saveall kernel runs forward and the reverse
    kernel backward, over the whole tree; otherwise one forward walk runs
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
