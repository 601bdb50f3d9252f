"""Every port test module runs on one torch intra-op thread.

Reads each ``tests/test_torch_*.py`` as text (it imports none of them) and
asserts that it imports ``torch_threads.one_thread`` or defines its own
module-scoped autouse fixture that calls ``torch.set_num_threads(1)``. A
module without it lets torch's pools, each as wide as the machine, slow the
tier-1 run's six workers several times over.
"""
import ast
from pathlib import Path

import pytest

from torch_threads import one_thread  # noqa: F401

TESTS = Path(__file__).resolve().parent
MODULES = sorted(p.name for p in TESTS.glob("test_torch_*.py"))


def _imports_shared(tree):
    return any(isinstance(node, ast.ImportFrom)
               and node.module == "torch_threads"
               and any(a.name == "one_thread" and a.asname is None
                       for a in node.names)
               for node in tree.body)


def _module_autouse(decorator):
    if not isinstance(decorator, ast.Call):
        return False
    kw = {k.arg: k.value for k in decorator.keywords}
    return (ast.unparse(decorator.func) == "pytest.fixture"
            and isinstance(kw.get("autouse"), ast.Constant)
            and kw["autouse"].value is True
            and isinstance(kw.get("scope"), ast.Constant)
            and kw["scope"].value == "module")


def _sets_one_thread(func):
    return any(isinstance(node, ast.Call)
               and ast.unparse(node.func) == "torch.set_num_threads"
               and len(node.args) == 1
               and isinstance(node.args[0], ast.Constant)
               and node.args[0].value == 1
               for node in ast.walk(func))


def _defines_own(tree):
    return any(isinstance(node, ast.FunctionDef)
               and any(_module_autouse(d) for d in node.decorator_list)
               and _sets_one_thread(node)
               for node in tree.body)


def test_the_guard_reads_the_port_modules():
    assert "test_torch_threads.py" in MODULES and len(MODULES) > 1


@pytest.mark.parametrize("name", MODULES)
def test_port_module_pins_one_torch_thread(name):
    tree = ast.parse((TESTS / name).read_text(), filename=name)
    assert _imports_shared(tree) or _defines_own(tree), (
        f"{name} neither imports torch_threads.one_thread nor defines a "
        "module-scoped autouse fixture calling torch.set_num_threads(1)")


@pytest.mark.parametrize("source, pinned", [
    ("from torch_threads import one_thread  # noqa: F401\n", True),
    ("from torch_threads import one_thread as other\n", False),
    ("import torch\n\n@pytest.fixture(autouse=True, scope='module')\n"
     "def _t():\n    torch.set_num_threads(1)\n    yield\n", True),
    ("import torch\n\n@pytest.fixture(scope='module')\n"
     "def _t():\n    torch.set_num_threads(1)\n    yield\n", False),
    ("import torch\n\n@pytest.fixture(autouse=True)\n"
     "def _t():\n    torch.set_num_threads(1)\n    yield\n", False),
    ("import torch\n\n@pytest.fixture(autouse=True, scope='module')\n"
     "def _t():\n    torch.set_num_threads(2)\n    yield\n", False),
    ("import torch\n\ndef test_x():\n    torch.set_num_threads(1)\n", False),
])
def test_the_guard_tells_pinned_from_unpinned(source, pinned):
    tree = ast.parse(source)
    assert (_imports_shared(tree) or _defines_own(tree)) is pinned
