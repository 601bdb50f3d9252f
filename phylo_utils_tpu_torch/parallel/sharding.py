"""Data-parallel site sharding (PyTorch port of
``phylo_utils_tpu.parallel.sharding``).

Alignment site patterns are the data-parallel axis: sites are
conditionally independent given the tree, so the pruning walk runs on
each pattern slice alone, and the one cross-shard reduction is the
weighted logL sum (and its gradient). Model parameters, the schedule and
P(t) are small and replicated.

A mesh here is the list of this process's shard devices; a device may
repeat (four shards on one card, eight on ``"cpu"``). ``SiteSharding``
pads the pattern count to a multiple of ``n_devices * tile`` (all-ones
partials, zero weights: an exact no-op) and places one CONTIGUOUS tensor
per shard on its device (``SiteShards``), once. An engine then walks each
shard with the same kernels (``map_sites``): the totals are summed in
float64 and the sitewise values concatenated in pattern order.

Across processes (``torch.distributed``: NCCL for cards, gloo for the
CPU), each rank holds its shards of the global pattern axis. The total is
all-reduced and the sitewise values all-gathered; in the backward pass the
gradient of every replicated input of a shard's walk (P, frequencies,
category weights, pinv) is all-reduced, so every rank's replicated
parameters receive the global gradient and all ranks take the same
optimizer steps.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["make_mesh", "SiteSharding", "distributed_init", "Mesh",
           "SiteShards", "place", "map_sites", "shard_map", "gather_sites"]

# what torch.distributed's env:// rendezvous reads
_ENV_RENDEZVOUS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def distributed_init(timeout: Optional[float] = None, **kwargs) -> None:
    """Initialize the default process group (call once per process, before
    building a ``SiteSharding``).

    A thin wrapper over ``torch.distributed.init_process_group``; the
    backend defaults to NCCL where there is a card and gloo otherwise.
    With kwargs (``init_method``, ``world_size``, ``rank``, ``backend``,
    ...) a failure raises a ``RuntimeError`` naming the rendezvous address
    and the rank. Without kwargs the rendezvous comes from the environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); where none
    is configured the process runs standalone. ``timeout`` (seconds)
    bounds the wait for the peers.
    """
    explicit = bool(kwargs)
    if not explicit:
        if not all(k in os.environ for k in _ENV_RENDEZVOUS):
            return                  # no rendezvous configured: standalone
        kwargs = {"init_method": "env://"}
    if timeout is not None:
        kwargs.setdefault("timeout", datetime.timedelta(seconds=timeout))
    kwargs.setdefault("backend",
                      "nccl" if torch.cuda.is_available() else "gloo")
    try:
        dist.init_process_group(**kwargs)
    except (RuntimeError, ValueError, TimeoutError) as exc:
        where = kwargs.get("init_method") or "env://"
        if where == "env://":
            where += " " + ":".join(os.environ.get(k, "?") for k in
                                    ("MASTER_ADDR", "MASTER_PORT"))
        rank = kwargs.get("rank", os.environ.get("RANK", "?"))
        world = kwargs.get("world_size", os.environ.get("WORLD_SIZE", "?"))
        raise RuntimeError(
            f"process-group init failed (rendezvous {where}, rank "
            f"{rank}/{world}, backend {kwargs['backend']}): {exc}. Check "
            "that every process started within the timeout and that the "
            "rendezvous address and port are reachable from each of them."
        ) from exc


@dataclass(frozen=True)
class Mesh:
    """This process's shard devices along one named axis."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"mesh device {str(d)!r} requested but "
                "torch.cuda.is_available() is False")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    elif d.type != "cpu":
        raise ValueError(f"mesh devices must be cpu or cuda, not {d!r}")
    return d


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = "sites") -> Mesh:
    """The shard devices of this process, one entry per shard.

    Default: every visible card (raises where there is none; name the
    devices, e.g. ``make_mesh(["cpu"] * 8)``, to shard on the CPU). A device
    may repeat: ``make_mesh(["cuda:0"] * 4)`` runs four shards on one card.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: torch.cuda.is_available() is False; name the "
                "devices (e.g. make_mesh(['cpu'] * 8)) to shard on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = tuple(_device(d) for d in devices)
    if not devs:
        raise ValueError("make_mesh: no devices given")
    return Mesh(devs, (axis_name,))


class SiteShards:
    """One pattern-sharded tensor: this process's shards, each contiguous
    on its device, in pattern order along ``axis``. ``shape`` is the global
    (padded) shape; ``full()`` gathers the whole tensor onto one device."""

    def __init__(self, shards: Sequence[torch.Tensor], axis: int,
                 sharding: "SiteSharding"):
        self.shards = tuple(shards)
        self.axis = axis
        self.sharding = sharding

    @property
    def shape(self) -> torch.Size:
        out = list(self.shards[0].shape)
        out[self.axis] = (sum(t.shape[self.axis] for t in self.shards)
                          * self.sharding.world_size)
        return torch.Size(out)

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def numel(self) -> int:
        return math.prod(self.shape)

    def sum(self) -> torch.Tensor:
        """The global sum, a 0-d tensor on the first shard's device."""
        dev = self.device
        total = torch.stack([t.sum().to(dev) for t in self.shards]).sum()
        if self.sharding.world_size > 1:
            dist.all_reduce(total)
        return total

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first shard's),
        gathered from every rank when the process group spans several."""
        dev = torch.device(device) if device is not None else self.device
        local = torch.cat([t.to(dev) for t in self.shards], dim=self.axis)
        if self.sharding.world_size == 1:
            return local
        return _GatherRanks.apply(self.axis, local)

    def __repr__(self) -> str:
        return (f"SiteShards(shape={tuple(self.shape)}, axis={self.axis}, "
                f"shards={len(self.shards)}, world={self.sharding.world_size})")


class SiteSharding:
    """Shards (pattern-compressed) alignment data over a mesh's site axis.

    Parameters
    ----------
    mesh : Mesh (default: ``make_mesh()``, every visible card)
    axis : the mesh axis holding sites
    tile : pad the pattern count to a multiple of ``n_devices * tile``

    ``n_devices`` counts the shards of every rank: this process's mesh size
    times the size of the default process group, where one is initialized.
    Padded pattern slots hold all-ones partials and zero weights: an
    all-ones column has site likelihood sum_i pi_i = 1, so padding changes
    nothing and never puts -inf or NaN in the log.
    """

    def __init__(self, mesh: Optional[Mesh] = None, axis: str = "sites",
                 tile: int = 1):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.axis = axis
        self.tile = int(tile)
        if axis not in self.mesh.axis_names:
            raise ValueError(f"mesh has no axis named {axis!r}")
        if dist.is_available() and dist.is_initialized():
            self.world_size = dist.get_world_size()
            self.rank = dist.get_rank()
        else:
            self.world_size, self.rank = 1, 0
        self.devices = self.mesh.devices
        self.n_local = len(self.devices)
        self.n_devices = self.n_local * self.world_size

    # -- padding -------------------------------------------------------------

    def padded_size(self, n_patterns: int) -> int:
        q = self.n_devices * max(self.tile, 1)
        return max(int(math.ceil(n_patterns / q)) * q, q)

    def pad(self, leaf_partials, weights):
        """Pad (..., n_leaves, P, S) partials with ones and (..., P) weights
        with zeros to a device-divisible pattern count (numpy arrays or
        tensors)."""
        n_patterns = leaf_partials.shape[-2]
        extra = self.padded_size(n_patterns) - n_patterns
        if extra == 0:
            return leaf_partials, weights
        lp_shape = (*leaf_partials.shape[:-2], extra, leaf_partials.shape[-1])
        w_shape = (*weights.shape[:-1], extra)
        if isinstance(leaf_partials, torch.Tensor):
            return (
                torch.cat([leaf_partials,
                           leaf_partials.new_ones(lp_shape)], dim=-2),
                torch.cat([weights, weights.new_zeros(w_shape)], dim=-1),
            )
        return (
            np.concatenate([leaf_partials,
                            np.ones(lp_shape, leaf_partials.dtype)], axis=-2),
            np.concatenate([weights, np.zeros(w_shape, weights.dtype)],
                           axis=-1),
        )

    # -- placement -----------------------------------------------------------

    def _place(self, parts, axis: int, dtype) -> SiteShards:
        out = []
        for part, dev in zip(parts, self.devices):
            t = part if isinstance(part, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(part))
            # moved in the array's own dtype and cast on the device
            t = t.to(dev)
            out.append((t if dtype is None else t.to(dtype)).contiguous())
        return SiteShards(out, axis, self)

    @staticmethod
    def _split(x, axis: int, n: int, first: int, count: int):
        size = x.shape[axis]
        if size % n:
            raise ValueError(
                f"pattern axis of {size} does not split into {n} shards; "
                "pad it first (SiteSharding.pad / padded_size)")
        step = size // n
        if isinstance(x, torch.Tensor):
            return [x.narrow(axis, (first + i) * step, step)
                    for i in range(count)]
        idx = [slice(None)] * x.ndim
        out = []
        for i in range(count):
            idx[axis] = slice((first + i) * step, (first + i + 1) * step)
            out.append(x[tuple(idx)])
        return out

    def _shard(self, x, axis: int, dtype=None) -> SiteShards:
        """This process's shards of the GLOBAL padded ``x`` along ``axis``
        (every rank passes the same array)."""
        parts = self._split(x, axis, self.n_devices,
                            self.rank * self.n_local, self.n_local)
        return self._place(parts, axis, dtype)

    def put_leaves(self, leaf_partials, dtype=None) -> SiteShards:
        """(..., n_leaves, P, S): one contiguous tensor per shard."""
        return self._shard(leaf_partials, leaf_partials.ndim - 2, dtype)

    def put_sites(self, arr, dtype=None) -> SiteShards:
        """(..., P): one contiguous tensor per shard."""
        return self._shard(arr, arr.ndim - 1, dtype)

    def from_process_local(self, local_leaf_partials, local_weights,
                           dtype=None) -> Tuple[SiteShards, SiteShards]:
        """Multi-process ingestion: each rank passes its own slice of the
        padded pattern axis (rank r: slice r of ``world_size`` equal
        slices) and gets its shards of the global sharded data."""
        lp = local_leaf_partials
        w = local_weights
        lp_axis, w_axis = lp.ndim - 2, w.ndim - 1
        return (
            self._place(self._split(lp, lp_axis, self.n_local, 0,
                                    self.n_local), lp_axis, dtype),
            self._place(self._split(w, w_axis, self.n_local, 0,
                                    self.n_local), w_axis, dtype),
        )


def place(sharding: Optional[SiteSharding], leaf_partials, weights, device,
          dtype=None, weight_dtype=None):
    """An engine's (leaves, weights) from numpy arrays, each moved in its
    own dtype and cast on the device (a big f32 alignment for an f64
    engine is not doubled on the host): plain tensors on ``device``
    without a sharding; with one, padded once (``SiteSharding.pad``) and
    placed once, one contiguous shard a device (``SiteShards``).
    ``dtype=None`` keeps the leaves' dtype; the weights take
    ``weight_dtype``, by default ``dtype``."""
    weight_dtype = dtype if weight_dtype is None else weight_dtype
    leaf_partials = np.ascontiguousarray(leaf_partials)
    weights = np.ascontiguousarray(weights)
    if sharding is not None:
        leaf_partials, weights = sharding.pad(leaf_partials, weights)
        return (sharding.put_leaves(leaf_partials, dtype),
                sharding.put_sites(weights, weight_dtype))
    lp = torch.from_numpy(leaf_partials).to(device)
    return ((lp if dtype is None else lp.to(dtype)),
            torch.from_numpy(weights).to(device=device, dtype=weight_dtype))


# -- collectives with the gradient rules of replicated parameters ------------

class _Replicated(torch.autograd.Function):
    """Identity forward; backward sums the gradient over the ranks (the
    inputs are replicated, each rank's walk sees its own patterns)."""

    @staticmethod
    def forward(ctx, *tensors):
        ctx.likes = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(shape, dtype=dtype, device=device) if g is None
                 else g for g, (shape, dtype, device) in zip(grads, ctx.likes)]
        flat = torch.cat([g.reshape(-1).to(torch.float64) for g in grads])
        dist.all_reduce(flat)
        out, off = [], 0
        for g in grads:
            out.append(flat[off:off + g.numel()].reshape(g.shape).to(g.dtype))
            off += g.numel()
        return tuple(out)


class _SumRanks(torch.autograd.Function):
    """All-reduce sum forward; identity backward (every rank computes the
    same function of the sum)."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, grad):
        return grad


class _GatherRanks(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward keeps this rank's slice
    of the gradient (every rank computes the same function of the
    gathered tensor)."""

    @staticmethod
    def forward(ctx, dim, t):
        ctx.dim, ctx.size = dim, t.shape[dim]
        ctx.rank = dist.get_rank()
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return None, grad.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size)


def shard_map(fn: Callable, replicated: Sequence, data: Sequence[SiteShards],
              combine: Sequence, device) -> tuple:
    """Run ``fn(*replicated, *data_shard_i)`` on every shard and combine.

    ``replicated``: tensors (or None) copied to each shard's device.
    ``data``: SiteShards of one layout. ``combine``: per output of ``fn``,
    ``"sum"`` (summed over shards and ranks) or a dim to concatenate along
    (in pattern order, gathered over ranks). Results land on ``device``.
    """
    multi = data[0].sharding.world_size > 1
    replicated = list(replicated)
    if multi:
        idx = [i for i, t in enumerate(replicated)
               if isinstance(t, torch.Tensor) and t.requires_grad]
        if idx:
            outs = _Replicated.apply(*[replicated[i] for i in idx])
            for i, t in zip(idx, outs):
                replicated[i] = t
    device = torch.device(device)
    outs = []
    for i, first in enumerate(data[0].shards):
        dev = first.device
        args = [t.to(dev) if isinstance(t, torch.Tensor) else t
                for t in replicated]
        # the shard's card current while its walk launches
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            outs.append(fn(*args, *(d.shards[i] for d in data)))
    result = []
    for j, how in enumerate(combine):
        parts = [o[j].to(device) for o in outs]
        if how == "sum":
            r = parts[0] if len(parts) == 1 else torch.stack(parts).sum(0)
            if multi:
                r = _SumRanks.apply(r)
        else:
            r = parts[0] if len(parts) == 1 else torch.cat(parts, dim=how)
            if multi:
                r = _GatherRanks.apply(how, r)
        result.append(r)
    return tuple(result)


def map_sites(fn: Callable, replicated: Sequence, leaf_partials, weights,
              device) -> tuple:
    """``(total, sitewise) = fn(*replicated, leaf_partials, weights)`` over
    a pattern block, shard by shard when the data are ``SiteShards``: the
    totals summed in float64, the sitewise values concatenated along the
    last axis."""
    if isinstance(leaf_partials, SiteShards):
        return shard_map(fn, replicated, (leaf_partials, weights),
                         ("sum", -1), device)
    return fn(*replicated, leaf_partials, weights)


def sharded_prune(prune: Callable, device) -> Callable:
    """``prune(p, leaf_partials) -> (root partials, root logscales)`` that
    also takes ``SiteShards`` leaves: each shard walked on its device, the
    roots concatenated in pattern order on ``device``."""

    def run(p, leaf_partials):
        if not isinstance(leaf_partials, SiteShards):
            return prune(p, leaf_partials)
        return shard_map(prune, (p,), (leaf_partials,), (-2, -1), device)

    return run


def gather_sites(x, device=None):
    """``x`` itself if a tensor; the gathered whole of a ``SiteShards``."""
    return x.full(device) if isinstance(x, SiteShards) else x
