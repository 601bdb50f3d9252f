"""The one-thread fixture that every ``tests/test_torch_*.py`` module imports.

Under the tier-1 run's six xdist workers, each worker's torch intra-op pool
is as wide as the machine, so the port's small CPU calls (thousands of tiny
ops: engines, fits, walks) spin seven helper threads each and slow one
another several times over (a fit of 1 s alone took 96 s beside six busy
processes). A module imports the fixture by name::

    from torch_threads import one_thread  # noqa: F401

``tests/test_torch_threads.py`` fails for a port test module that does not.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread for the module's tests, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
