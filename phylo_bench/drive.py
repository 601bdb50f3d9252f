"""The general traffic generator, the program under test and the closed
loop that drives it.

A traffic mix is data (``traffic/<name>.json``): ``entry``, the engine's
public method each call goes to; ``sets``, the branch-length sets a call
(``*_many`` entries take them as a (sets, N) matrix, the others one
vector inside the parameters); ``brlen_jitter_sd``, the log-normal jitter
of every branch length around the input's; ``param_jitter_sd``, the
jitter of the other parameters (each by its kind: ``log`` multiplies by a
log-normal, ``logit`` moves the logit, ``simplex`` multiplies by
log-normals and renormalizes, ``none`` keeps it; 0 keeps them all, so the
engine's caches keyed by value hit); ``check_calls``, the calls compared
with the reference; ``trace_seconds``, the traced window. Call ``k``'s
inputs come from ``(seed, k)`` alone, so the reference regenerates them
after the window.
"""
from __future__ import annotations

import dataclasses
import math
import time
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from inputs import Inputs

# call indices of the warm-up calls (never those of the window), and
# their number: the first call allocates, the second finds it all in place
WARM_BASE = 1 << 40
WARM_CALLS = 2


def _jitter(value: np.ndarray, kind: str, sd: float,
            rng: np.random.Generator) -> np.ndarray:
    z = rng.standard_normal(value.shape)
    if kind == "none" or sd == 0.0:
        return value
    if kind == "log":
        out = value * np.exp(sd * z)
    elif kind == "logit":
        logit = np.log(value) - np.log1p(-value)
        out = 1.0 / (1.0 + np.exp(-(logit + sd * z)))
    elif kind == "simplex":
        out = value * np.exp(sd * z)
        out = out / out.sum()
    else:
        raise ValueError(f"unknown jitter kind {kind!r}")
    return out.astype(np.float32)


def _jitter_tree(values: Dict, kinds: Dict, sd: float,
                 rng: np.random.Generator) -> Dict:
    return {k: (_jitter_tree(v, kinds[k], sd, rng) if isinstance(v, dict)
                else _jitter(v, kinds[k], sd, rng))
            for k, v in values.items()}


@dataclasses.dataclass
class Call:
    """One call's inputs: ``sets`` (B, N) float32 branch lengths and the
    other parameters, float32."""
    sets: np.ndarray
    params: Dict


class Traffic:
    """Call ``k`` of a traffic mix over a run's inputs."""

    def __init__(self, spec: Dict, inputs: Inputs, seed: int):
        self.spec, self.inputs, self.seed = spec, inputs, seed
        self.many = spec["entry"].endswith("_many")
        if not self.many and spec["sets"] != 1:
            raise ValueError(f"{spec['entry']} takes one set a call")

    def call(self, k: int) -> Call:
        rng = np.random.default_rng([self.seed, 1, k])
        n = self.inputs.lengths.shape[0]
        z = rng.standard_normal((self.spec["sets"], n))
        sets = (self.inputs.lengths * np.exp(self.spec["brlen_jitter_sd"] * z)
                ).astype(np.float32)
        params = _jitter_tree(self.inputs.params, self.inputs.kinds,
                              self.spec["param_jitter_sd"], rng)
        return Call(sets=sets, params=params)


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


class Program:
    """The engine of ``phylo_utils_tpu_torch`` and the traffic's entry on
    it. ``__call__`` returns what reached the host: ``{"total": (B,)}``
    and, for a gradient, one float64 array a parameter (``branch_lengths``
    (B, N), the others as the engine gives them)."""

    def __init__(self, engine, entry: str, many: bool):
        self.engine, self.entry, self.many = engine, entry, many
        self.method = getattr(engine, entry)

    def __call__(self, call: Call) -> Dict[str, np.ndarray]:
        if self.many:
            out = self.method(call.sets, call.params)
        else:
            out = self.method({**call.params,
                               "branch_lengths": call.sets[0]})
        if not isinstance(out, tuple):
            return {"total": np.asarray(out, dtype=np.float64).reshape(-1)}
        total, grads = out
        flat = {"total": total, **_flatten(grads)}
        # one copy to the host: the call ends when all of it is there
        host = torch.cat([v.detach().reshape(-1).to(torch.float64)
                          for v in flat.values()]).cpu().numpy()
        res, lo = {}, 0
        for k, v in flat.items():
            res[k] = host[lo:lo + v.numel()].reshape(v.shape)
            lo += v.numel()
        res["total"] = res["total"].reshape(-1)
        if self.many is False:
            res["branch_lengths"] = res["branch_lengths"][None]
        return res


def build_program(config: Dict, traffic: Dict, inputs: Inputs, model,
                  device) -> Program:
    """The engine the configuration states, on the run's alignment: the
    sequences (``program_input`` "sequences", written in the reference
    ``model``'s symbols and compressed by the engine) or the benchmark's
    one-hot patterns ("patterns")."""
    from phylo_utils_tpu_torch import models
    from phylo_utils_tpu_torch.io import CompressedAlignment
    from phylo_utils_tpu_torch.likelihood import LikelihoodEngine

    tree = inputs.tree
    names = tree.leaf_names
    if config["program_input"] == "sequences":
        table = np.array([s.encode() for s in model.SYMBOLS])
        codes = inputs.states.cpu().numpy()
        alignment = {n: b"".join(table[codes[i]]).decode()
                     for i, n in enumerate(names)}
    else:
        s = config["states"]
        onehot = torch.zeros(inputs.pats.shape + (s,), dtype=torch.float32,
                             device=inputs.pats.device)
        onehot.scatter_(2, inputs.pats[..., None], 1.0)
        alignment = CompressedAlignment(
            tuple(names), onehot.cpu().numpy(),
            inputs.weights.cpu().numpy(),
            inputs.inverse.to(torch.int32).cpu().numpy())
        del onehot
    engine = LikelihoodEngine(
        tree.newick(inputs.lengths), alignment,
        getattr(models, config["program_model"]), ncat=config["ncat"],
        invariant_sites="pinv" in inputs.params,
        dtype=getattr(torch, config["dtype"]), pruner="cuda",
        device=device)
    if list(engine.tree.parent) != list(tree.parent):
        raise RuntimeError("the engine numbered the tree's nodes otherwise")
    return Program(engine, traffic["entry"], traffic["entry"].endswith(
        "_many"))


@dataclasses.dataclass
class Window:
    calls: List[Call]
    outputs: List[Optional[Dict[str, np.ndarray]]]    # None: failed
    starts: List[float]
    ends: List[float]
    start: float
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def failed(self) -> int:
        return sum(o is None for o in self.outputs)

    def joined(self, later: "Window") -> "Window":
        """This window's calls, then ``later``'s."""
        return Window(self.calls + later.calls, self.outputs + later.outputs,
                      self.starts + later.starts, self.ends + later.ends,
                      self.start, later.end)


def _finite(out: Dict[str, np.ndarray]) -> bool:
    return all(np.isfinite(v).all() for v in out.values())


def run_window(program: Callable, traffic: Traffic, seconds: float,
               spans: bool = False, first: int = 0) -> Window:
    """Calls ``first``, ``first`` + 1, ... in a closed loop, each sent
    when the previous one's result is on the host, until ``seconds`` have
    passed; the window ends when the last call returns. A call that raises or returns a value that
    is not finite has failed. ``spans`` records the benchmark's own
    profiler spans around each step of a call."""
    span = (torch.profiler.record_function if spans
            else lambda name: nullcontext())
    calls, outputs, starts, ends = [], [], [], []
    start = time.perf_counter()
    k = first
    while time.perf_counter() - start < seconds:
        with span("bench.make_call"):
            call = traffic.call(k)
        t0 = time.perf_counter()
        with span("bench.engine_call"):
            try:
                out = program(call)
            except (RuntimeError, ValueError, FloatingPointError,
                    ArithmeticError) as exc:
                print(f"call {k} failed: {exc!r}", flush=True)
                out = None
        t1 = time.perf_counter()
        if out is not None and not _finite(out):
            out = None
        calls.append(call)
        outputs.append(out)
        starts.append(t0)
        ends.append(t1)
        k += 1
    return Window(calls, outputs, starts, ends, start, time.perf_counter())


def warm_up(program: Callable, traffic: Traffic) -> None:
    """The traffic's own shapes, on calls the window never makes."""
    for j in range(WARM_CALLS):
        program(traffic.call(WARM_BASE + j))


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile by linear interpolation between ranks."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
