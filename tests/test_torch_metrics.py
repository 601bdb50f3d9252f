"""The port's ``utils.metrics`` additions: ``enable_debug_checks`` (the
JAX package's ``tests/test_cli_utils.py::test_enable_debug_checks_catches_nan``
on the port's engines), ``Timer`` and ``trace``, on the CPU."""
import json
import math

import numpy as np
import pytest
import torch

from phylo_utils_tpu_torch import likelihood, models
from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
from phylo_utils_tpu_torch.utils import Timer, enable_debug_checks, trace

from torch_threads import one_thread  # noqa: F401

TREE = "((a:0.1,b:0.2):0.05,(c:0.3,d:0.15):0.07);"
ALN = {"a": "ACGTACGTGG", "b": "ACGTTGCAGG", "c": "AGGTACGAGT",
       "d": "ACGAACGTAT"}


def test_enable_debug_checks_catches_nan():
    """A NaN branch length gives a NaN logL; under the debug checks the
    engine raises FloatingPointError instead, for values and gradients."""
    eng = LikelihoodEngine(TREE, ALN, models.HKY85, device="cpu")
    bad = {"branch_lengths": np.r_[np.nan, np.full(6, 0.1)]}
    assert math.isnan(eng.loglikelihood(bad))
    enable_debug_checks(nans=True)
    try:
        with pytest.raises(FloatingPointError):
            eng.loglikelihood(bad)
        with pytest.raises(FloatingPointError):
            eng.sitewise_loglikelihoods(bad)
        with pytest.raises((FloatingPointError, RuntimeError)):
            eng.value_and_grad(bad)
        assert np.isfinite(eng.loglikelihood())
    finally:
        likelihood.DEBUG_NANS = False
        torch.autograd.set_detect_anomaly(False)


def test_timer_waits_and_times():
    x = torch.randn(64, 64)
    with Timer() as t:
        out = t.block({"y": [x @ x]})
    assert out["y"][0].shape == (64, 64)
    assert t.seconds is not None and t.seconds >= 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")):
        torch.randn(32, 32) @ torch.randn(32, 32)
    with open(tmp_path / "prof" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    with trace(None):
        pass
