"""Reduces a ``torch.profiler`` Chrome trace of a traced window to what the
per-layer metrics and the ``breakdown`` read: the device operations
(kernels, copies, sets) inside the window, their union (busy time), the
kernels launched, the time by kernel name, and the idle gaps named after
what the host was doing through them.

The window is the benchmark's ``bench.window`` span where the trace has
host events; a trace of the device alone (no host events, so no tracing
cost on the host) is bounded by its first and last device operations,
which the benchmark launches itself as markers around the window.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import heapq
import json
from typing import Dict, List, Tuple

WINDOW_SPAN = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
NO_EVENT = "host (no event)"
# the longest gaps named after the host's activity
GAPS_NAMED = 1000


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    launches: int                         # kernels in the window
    device_ops: List[Tuple[str, float]]   # seconds by name, most first
    idle_gaps: List[Tuple[str, float]]    # idle seconds by host activity

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def _short(name: str) -> str:
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:120]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


class _HostIndex:
    """Host events by start time, to find those that overlap an interval;
    events longer than ``LONG_US`` are scanned whole."""

    LONG_US = 10_000.0

    def __init__(self, host: List[dict]):
        self.long = [e for e in host if e["dur"] > self.LONG_US]
        self.short = sorted((e for e in host if e["dur"] <= self.LONG_US),
                            key=lambda e: e["ts"])
        self.starts = [e["ts"] for e in self.short]

    def overlapping(self, lo: float, hi: float) -> List[dict]:
        first = bisect.bisect_left(self.starts, lo - self.LONG_US)
        last = bisect.bisect_left(self.starts, hi)
        return [e for e in self.long + self.short[first:last]
                if e["ts"] < hi and e["ts"] + e["dur"] > lo]


def _innermost(lo: float, hi: float, events: List[dict],
               into: Dict[str, float]) -> None:
    """Adds to ``into`` each stretch of [lo, hi] under the name of the
    shortest (innermost) host event running through it."""
    events = sorted(events, key=lambda e: e["ts"])
    cuts = sorted({lo, hi} | {min(max(t, lo), hi) for e in events
                              for t in (e["ts"], e["ts"] + e["dur"])})
    live: list = []
    k = 0
    for a, b in zip(cuts, cuts[1:]):
        while k < len(events) and events[k]["ts"] <= a:
            e = events[k]
            heapq.heappush(live, (e["dur"], e["ts"] + e["dur"], k, e["name"]))
            k += 1
        while live and live[0][1] <= a:
            heapq.heappop(live)
        into[live[0][3] if live else NO_EVENT] += (b - a) * 1e-6


def summarize(events: List[dict], top: int = 10) -> TraceSummary:
    """The summary of the Chrome-trace ``events`` inside the window (times
    in microseconds)."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in spans if e.get("cat") in DEVICE_CATS]
    win = [e for e in spans if e.get("cat") == "user_annotation"
           and e.get("name") == WINDOW_SPAN]
    if win:
        w_lo, w_hi = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    elif dev:
        w_lo = min(e["ts"] for e in dev)
        w_hi = max(e["ts"] + e["dur"] for e in dev)
    else:
        raise ValueError("the trace has neither a window span nor a "
                         "device operation")
    dev = [e for e in dev if w_lo <= e["ts"] < w_hi]
    busy = _union([(e["ts"], min(e["ts"] + e["dur"], w_hi)) for e in dev])
    by_name: Dict[str, float] = collections.Counter()
    for e in dev:
        by_name[_short(e["name"])] += e["dur"] * 1e-6
    gaps, t = [], w_lo
    for lo, hi in busy:
        if lo > t:
            gaps.append((t, lo))
        t = max(t, hi)
    if t < w_hi:
        gaps.append((t, w_hi))
    host = [e for e in spans if e.get("cat") in HOST_CATS
            and e["ts"] < w_hi and e["ts"] + e["dur"] > w_lo]
    idle: Dict[str, float] = collections.Counter()
    if host:
        index = _HostIndex(host)
        for lo, hi in sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_NAMED]:
            _innermost(lo, hi, index.overlapping(lo, hi), idle)
    return TraceSummary(
        window_s=(w_hi - w_lo) * 1e-6,
        busy_s=sum(hi - lo for lo, hi in busy) * 1e-6,
        launches=sum(e.get("cat") == "kernel" for e in dev),
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1])[:top],
    )


def read_trace(path: str) -> List[dict]:
    with open(path) as fh:
        return json.load(fh)["traceEvents"]
