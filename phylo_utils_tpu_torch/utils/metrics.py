"""Structured metrics (PyTorch port of ``MetricsLogger`` from
``phylo_utils_tpu.utils.metrics``).

Per-step records (logL, patterns/s, ...) stream to JSONL and optionally
stdout. The port runs one process per card, so every process writes (the
JAX package writes from its process 0 only).
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, Optional

__all__ = ["MetricsLogger"]


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
