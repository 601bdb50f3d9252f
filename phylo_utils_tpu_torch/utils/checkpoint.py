"""Checkpoint / resume for optimizer runs (PyTorch port of
``phylo_utils_tpu.utils.checkpoint``).

The whole state of a fit, ``{raw parameters, optimizer state_dict}`` plus
the step counter, is plain tensors and numbers, so a checkpoint is exact:
a run restored from one continues bit for bit. Format: one ``torch.save``
file, written to a temporary file in the target's directory and renamed
over the target, so a reader never sees a half-written checkpoint. Loading
uses ``weights_only=True``: tensors, containers and numbers only. Across
processes only rank 0 writes.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Tuple

import torch

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(path: str, state: Dict[str, Any], step: int = 0) -> None:
    """Atomically write ``state`` (a dict of tensors, containers and
    numbers) with its step counter to ``path``.

    Multi-process safe: where a ``torch.distributed`` process group is
    initialized, only rank 0 writes; the other ranks return at once (their
    replicated state is the same).
    """
    if (torch.distributed.is_available()
            and torch.distributed.is_initialized()
            and torch.distributed.get_rank() != 0):
        return
    payload = {"state": state, "step": int(step)}
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory)
    try:
        with os.fdopen(fd, "wb") as fh:
            torch.save(payload, fh)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, map_location=None
                    ) -> Tuple[Dict[str, Any], int]:
    """``(state, step)`` from ``path``; tensors go to ``map_location``
    (default: where they were saved)."""
    payload = torch.load(path, map_location=map_location, weights_only=True)
    return payload["state"], payload["step"]
