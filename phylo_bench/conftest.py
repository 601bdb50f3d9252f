"""Test set-up of the benchmark's own tests (``pytest phylo_bench``): its
modules import one another by their file names, as ``run.py`` runs them,
and every torch op here runs on one thread."""
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
for path in (str(HERE.parent), str(HERE)):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``gpu``; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
