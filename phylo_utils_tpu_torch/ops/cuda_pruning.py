"""Fused pruning forward on the GPU: the port of the forward half of
``phylo_utils_tpu.ops.pallas_pruning``.

``forward_walk`` wraps the hand-written CUDA kernel
``csrc/pruning_forward.cu`` (which replaces the TPU kernel
``pallas_pruning._dynamic_kernel``): a post-order walk that forms
y_c = P_c . x_c per child, multiplies the y's, and rescales each node by an
exact power of two with integer exponent counts. On a CUDA tensor it
launches the kernel or raises; on a CPU tensor it runs
``forward_walk_reference``, the same walk in plain PyTorch. ``LAUNCHES``
counts kernel launches, so a run can show its main path went through the
kernel.

Gradients (the saveall and deferred-reverse kernels) are ROADMAP B2/B3.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from phylo_utils_tpu_torch.ops.pruning import LN2, pow2_rescale
from phylo_utils_tpu_torch.trees import PruningSchedule

__all__ = [
    "LAUNCHES",
    "WalkSchedule",
    "forward_walk",
    "forward_walk_reference",
    "make_fused_loglik_fn",
]

LAUNCHES = 0

# CUDA caps gridDim.z (the batch axis of the launch) at 65535
_MAX_GRID_Z = 65535
# share of the free device memory one launch's scratch may take
_MEM_FRACTION = 0.9


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


class WalkSchedule:
    """The post-order walk of one schedule: host arrays plus their int32
    copies on each device that has used them."""

    def __init__(self, schedule: PruningSchedule):
        self.order, self.children, self.counts = _postorder_arrays(schedule)
        if len(self.order) == 0:
            raise ValueError("the tree has no internal node to walk")
        self.n_nodes = schedule.n_nodes
        self.n_leaves = schedule.n_leaves
        self._on_device = {}

    def on(self, device: torch.device):
        """(order, children, counts) as contiguous int32 tensors on device."""
        if device not in self._on_device:
            self._on_device[device] = tuple(
                torch.from_numpy(a).to(device).contiguous()
                for a in (self.order, self.children, self.counts)
            )
        return self._on_device[device]


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
    if p.requires_grad or leaves.requires_grad:
        raise NotImplementedError(
            "gradients through the pruning kernel are not ported yet "
            "(ROADMAP B2/B3, A9)"
        )
    if p.device != leaves.device:
        raise ValueError(
            f"P is on {p.device} but leaves are on {leaves.device}"
        )


def forward_walk_reference(
    p: torch.Tensor, leaves: torch.Tensor, walk: WalkSchedule
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch version of the kernel: the same post-order walk with
    the same rescale, vectorised over (batch, category, site).

    ``p`` (n_nodes, K, S, S) or (B, n_nodes, K, S, S), float32;
    ``leaves`` (n_leaves, sites, S), float32. Returns the root partials
    (B?, K, sites, S) and the root exponent count (B?, K, sites), float32.
    """
    _check(p, leaves, walk)
    batched = p.dim() == 5
    pb = p if batched else p[None]
    n_leaves = walk.n_leaves
    tiny = torch.finfo(torch.float32).tiny
    x, e = {}, {}
    for node, kids, cnt in zip(walk.order.tolist(), walk.children.tolist(),
                               walk.counts.tolist()):
        acc, esum = None, None
        for c in kids[:cnt]:
            if c < n_leaves:
                y = torch.einsum("bkij,sj->bksi", pb[:, c], leaves[c])
            else:
                y = torch.einsum("bkij,bksj->bksi", pb[:, c], x.pop(c))
                ec = e.pop(c)
                esum = ec if esum is None else esum + ec
            acc = y if acc is None else acc * y
        scale, en = pow2_rescale(acc.amax(dim=-1).clamp_min(tiny))
        x[node] = acc * scale[..., None]
        e[node] = en if esum is None else esum + en
    root = int(walk.order[-1])
    root_p, root_e = x[root], e[root]
    return (root_p, root_e) if batched else (root_p[0], root_e[0])


def _batch_chunk(b: int, bytes_per_b: int, device: torch.device) -> int:
    """How many batch elements one launch may take so its scratch fits the
    device memory that is free now (torch's unused cached blocks
    included); raises when not even one fits.

    When torch's allocator already holds enough unused memory (the steady
    state of repeated calls, which free their scratch), the device is not
    queried: ``torch.cuda.mem_get_info`` took from 0.02 to 2.5 ms of host
    time per call on an NVIDIA H100 80GB HBM3 (700 W limit), against
    0.055 ms for the B = 1 flagship kernel. The allocator's stats are read
    once:
    ``memory_reserved`` and ``memory_allocated`` each flatten and sort the
    whole stats dict."""
    stats = torch.cuda.memory_stats_as_nested_dict(device)
    cached = (stats["reserved_bytes"]["all"]["current"]
              - stats["allocated_bytes"]["all"]["current"])
    if b * bytes_per_b <= cached:
        return min(b, _MAX_GRID_Z)
    free, _ = torch.cuda.mem_get_info(device)
    budget = int(_MEM_FRACTION * (free + cached))
    if bytes_per_b > budget:
        raise MemoryError(
            f"the pruning walk needs {bytes_per_b} bytes of scratch per "
            f"batch element but only {budget} bytes are free on {device}; "
            "use fewer sites per call"
        )
    return min(b, budget // bytes_per_b, _MAX_GRID_Z)


def forward_walk(
    p: torch.Tensor, leaves: torch.Tensor, walk: WalkSchedule
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Root partials and root exponent count of the pruning walk.

    Same contract as ``forward_walk_reference``. CPU tensors take that plain
    version; CUDA tensors launch the kernel (one launch per batch chunk
    that fits free device memory) on the current stream.
    """
    global LAUNCHES
    _check(p, leaves, walk)
    if p.device.type == "cpu":
        return forward_walk_reference(p, leaves, walk)
    if p.device.type != "cuda":
        raise ValueError(f"forward_walk runs on cpu or cuda, not {p.device}")
    if not (p.is_contiguous() and leaves.is_contiguous()):
        raise ValueError("P and leaves must be contiguous")
    s = leaves.shape[2]
    if s != 4:
        raise NotImplementedError(
            f"the CUDA walk is built for 4 states, not {s} (protein is "
            "ROADMAP A11, codon A14)"
        )
    from phylo_utils_tpu_torch.ops._build import load_library

    lib = load_library()
    batched = p.dim() == 5
    pb = p if batched else p[None]
    b, _, k = pb.shape[:3]
    sites = leaves.shape[1]
    n_inner = walk.n_nodes - walk.n_leaves
    device = p.device
    order, children, counts = walk.on(device)
    root = torch.empty((b, k, sites, s), dtype=torch.float32, device=device)
    root_e = torch.empty((b, k, sites), dtype=torch.float32, device=device)
    chunk = _batch_chunk(b, k * n_inner * sites * (s + 1) * 4, device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
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
            root_e[b0:b0 + nb].data_ptr(), nb, k, s, walk.n_nodes,
            walk.n_leaves, len(walk.order), children.shape[1], sites, stream,
        )
        if rc != 0:
            raise RuntimeError(f"pruning_forward_f32 launch failed: CUDA "
                               f"error {rc}")
        LAUNCHES += 1
        del scratch, scratch_e
    return (root, root_e) if batched else (root[0], root_e[0])


def make_fused_loglik_fn(schedule: PruningSchedule):
    """Forward-only counterpart of ``pallas_pruning.make_pallas_loglik_fn``.

    Returns ``f(p_matrices (B?, n_nodes, K, S, S), leaf_partials
    (n_leaves, sites, S), freqs (S,)) -> ll (B?, K, sites)`` with
    ``ll[k, s] = log(sum_i freqs_i * true_root_partials[k, s, i])``. The
    walk runs in float32; the root reduction and the exponent count x ln 2
    run in ``freqs.dtype`` (pass float64 freqs for the precision plan).
    """
    walk = WalkSchedule(schedule)

    def fused_ll(p_matrices, leaf_partials, freqs):
        root_p, root_e = forward_walk(
            p_matrices.to(torch.float32).contiguous(),
            leaf_partials.to(torch.float32).contiguous(),
            walk,
        )
        rdt = freqs.dtype
        dot = torch.einsum("...ksi,i->...ks", root_p.to(rdt), freqs)
        return torch.log(dot) + root_e.to(rdt) * LN2

    return fused_ll
