"""Worked examples of the PyTorch port: the counterparts of the JAX
package's ``examples/full_analysis.py``, ``uncertainty_analysis.py`` and
``selection_analysis.py``, each an end-to-end composition of the public
API.

Run each as ``python -m phylo_utils_tpu_torch.examples.<name>``: on the card
by default, ``--device cpu`` on the CPU, ``--pruner cuda`` for the
hand-written kernels (``torch``, plain PyTorch, is the default, as the JAX
package's ``xla``). The sizes, step counts and replicate counts are options
that default to the JAX example's own. Each module's ``run(...)`` takes the
alignment and the true tree and returns every number its ``main()`` prints,
so that one alignment can be fed to the port and to the JAX package. The
simulated data differ from the JAX example's: ``torch`` cannot replay
``jax.random``.
"""
from __future__ import annotations

import argparse
import time
from typing import Mapping

import torch


def example_parser(description: str, seed: int,
                   options: Mapping[str, int]) -> argparse.ArgumentParser:
    """``--device``, ``--pruner``, ``--seed`` (default ``seed``, the JAX
    example's key) and one integer option a name of ``options`` (its
    default the value), ``--n-sites`` for ``n_sites``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the engines run (default: the card)")
    ap.add_argument("--pruner", default="torch", choices=["torch", "cuda"],
                    help="the pruning walk of every engine the example "
                         "builds: plain PyTorch or the hand-written kernels")
    ap.add_argument("--seed", type=int, default=seed,
                    help="simulation seed")
    for name, default in options.items():
        ap.add_argument("--" + name.replace("_", "-"), type=int,
                        default=default)
    return ap


def checked_device(device: str) -> str:
    """``device``, or SystemExit naming ``--device cpu`` where the card is
    asked for and there is none, as the CLI says."""
    from phylo_utils_tpu_torch.likelihood import _checked_device

    try:
        _checked_device(device)
    except RuntimeError as e:
        raise SystemExit(f"{e}; pass --device cpu to run on the CPU")
    return device


class Stages:
    """Host seconds of each stage of a run, the card synchronized at the end
    of each (``seconds``: {stage: s}, in order)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds = {}
        self._t0 = time.perf_counter()

    def done(self, name: str):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[name] = now - self._t0
        self._t0 = now
