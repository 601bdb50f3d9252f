"""Structured metrics, timing, tracing and debug checks (PyTorch port of
``phylo_utils_tpu.utils.metrics``).

Per-step records (logL, patterns/s, ...) stream to JSONL and optionally
stdout. The port runs one process per card, so every process writes (the
JAX package writes from its process 0 only). ``Timer`` waits for the card
before it stops its clock, ``trace`` records a ``torch.profiler`` trace
(the JAX package's ``jax.profiler.trace``) and ``enable_debug_checks``
turns on autograd's anomaly mode and the engines' NaN check.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

import torch

__all__ = ["MetricsLogger", "Timer", "trace", "enable_debug_checks"]


class MetricsLogger:
    """Append-only JSONL metrics stream."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._fh = open(path, "a", buffering=1) if path else None

    def log(self, step: int, **metrics: Any) -> Dict[str, Any]:
        rec = {"step": int(step), "time": time.time(), **{
            k: (float(v) if hasattr(v, "__float__") else v)
            for k, v in metrics.items()
        }}
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
        if self.echo:
            print(line)
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices of the tensors in ``value`` (nested dicts, lists,
    tuples)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, out)
    return out


class Timer:
    """Wall-clock timer that waits for device results.

    >>> with Timer() as t:
    ...     out = fn(*args)
    ...     t.block(out)
    >>> t.seconds

    ``block`` synchronizes every CUDA device that holds a tensor of
    ``value`` (tensors at any nesting of dicts, lists and tuples): CUDA
    calls return before the card has finished.
    """

    def __enter__(self):
        self.seconds = None
        self._t0 = time.perf_counter()
        return self

    def block(self, value):
        for device in _cuda_devices(value, set()):
            torch.cuda.synchronize(device)
        return value

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """A ``torch.profiler`` trace of the block (the host, and the card
    where there is one), written to ``logdir/trace.json`` (Chrome trace
    format) when a logdir is given; no-op otherwise."""
    if not logdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def enable_debug_checks(nans: bool = True, checks: bool = False) -> None:
    """Turn on runtime debugging (the JAX package's ``jax_debug_nans`` /
    ``jax_enable_checks``).

    ``nans=True`` makes every engine's log-likelihood, sitewise values and
    gradients raise ``FloatingPointError`` where they hold a NaN, and a
    backward op that returns a NaN raise at that op (autograd anomaly mode
    with ``check_nan``); ``checks=True`` adds anomaly mode's traceback of
    the forward op behind a failing backward (slow). Use in tests and
    debug sessions, not production.
    """
    from phylo_utils_tpu_torch import likelihood

    if nans:
        likelihood.DEBUG_NANS = True
    if nans or checks:
        torch.autograd.set_detect_anomaly(True, check_nan=nans)
