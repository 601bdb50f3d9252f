"""The round's first done-condition, checkable: every public name of the
JAX package's ``__init__`` (each name its ``from ... import`` statements
bind) is either exported by ``phylo_utils_tpu_torch`` under the same name,
or not ported yet and mapped here to the ROADMAP item that ports it (all
67 are ported). The
port exports nothing the JAX package lacks: a name beyond the JAX
``__init__``'s must be a public name of the JAX module that corresponds to
the port module defining it (``fit_multistart`` of ``optimize``, ...).
"""
import ast
import importlib
import os
import re

import phylo_utils_tpu_torch

from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each JAX public name the port does not export yet -> its ROADMAP item:
# none since the A18 analyses (ancestral, branch models, the clock)
NOT_PORTED = {}


def _imported_names(package: str):
    """The names an ``__init__``'s ``from ... import`` statements bind."""
    path = os.path.join(REPO, package, "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    return [alias.asname or alias.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for alias in node.names]


def test_every_jax_name_is_ported_or_mapped_to_an_item():
    jax_names = _imported_names("phylo_utils_tpu")
    port_names = set(_imported_names("phylo_utils_tpu_torch"))
    assert len(jax_names) == len(set(jax_names)) == 67
    missing = [n for n in jax_names if n not in port_names]
    unmapped = sorted(set(missing) - set(NOT_PORTED))
    assert not unmapped, f"not ported and not mapped to an item: {unmapped}"
    stale = sorted(set(NOT_PORTED) - set(missing))
    assert not stale, f"ported but still mapped as missing: {stale}"
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        roadmap = f.read()
    for item in set(NOT_PORTED.values()):       # an item of a queue
        assert re.search(rf"\*\*{item}\b", roadmap), item
    ported = [n for n in jax_names if n in port_names]
    assert len(ported) == 67
    for name in ported:
        assert hasattr(phylo_utils_tpu_torch, name), name


def test_port_exports_no_name_the_jax_package_lacks():
    jax_names = set(_imported_names("phylo_utils_tpu"))
    for name in _imported_names("phylo_utils_tpu_torch"):
        if name in jax_names:
            continue
        obj = getattr(phylo_utils_tpu_torch, name)
        module = obj.__module__.replace("phylo_utils_tpu_torch",
                                        "phylo_utils_tpu", 1)
        assert hasattr(importlib.import_module(module), name), (
            f"{name} ({obj.__module__}) has no counterpart in {module}")
