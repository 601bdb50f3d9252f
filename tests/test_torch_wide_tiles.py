"""The 64-state tiled walks' shared memory (B5's ``pruning_stream_wide_
kernel``, B3's ``pruning_reverse_wide_kernel`` and B7's
``classic_reverse_wide_kernel``): the wrappers' byte counts
(``cuda_pruning.stream_smem_bytes``, ``_reverse_smem_bytes``) against the
formulas the kernels launch with, read from ``csrc/`` and evaluated here,
for every node width the walks take, and the widths that fit an SM's
232,448 bytes. The kernels themselves run only on the card."""
import re
from pathlib import Path

import pytest

from phylo_utils_tpu_torch.ops import cuda_pruning

CSRC = Path(cuda_pruning.__file__).resolve().parent.parent / "csrc"
SMEM = 232_448


def _body(source: str, name: str) -> str:
    """The returned expression of the one-statement function ``name`` in
    ``csrc/<source>``."""
    text = (CSRC / source).read_text()
    m = re.search(re.escape(name) + r"\([^)]*\)\s*\{\s*return (.*?);\s*\}",
                  text, re.S)
    assert m, f"{name} not found in {source}"
    return " ".join(m.group(1).split())


def _py(expr: str) -> str:
    """A C++ expression of these helpers as Python: casts and namespaces
    dropped, template calls made plain, a ternary made a conditional."""
    expr = expr.replace("pruning::", "")
    expr = re.sub(r"static_cast<size_t>\((\w+)\)", r"\1", expr)
    expr = re.sub(r"(\w+)<S>\(\)", r"\1()", expr)
    m = re.fullmatch(r"(.+?) \? (.+?) : (.+)", expr)
    return f"({m.group(2)} if {m.group(1)} else {m.group(3)})" if m else expr


def _kernel_floats():
    """(B5's floats per block, the reverses' floats per block), each a
    function of the staged children, from the sources."""
    common = (CSRC / "pruning_common.cuh").read_text()
    tile = int(re.search(r"constexpr int kWideTile = (\d+);", common)[1])
    row = eval(_py(_body("pruning_common.cuh", "p_row")), {"S": 64})
    env = {"kWideTile": tile,
           "wide_tile_floats": lambda: tile * row,
           "wide_gy_tiles": lambda children: eval(
               _py(_body("pruning_common.cuh", "wide_gy_tiles")),
               {"children": children})}
    stream = _py(_body("pruning_slot.cu", "stream_wide_smem_floats"))
    reverse = _py(_body("pruning_common.cuh", "wide_smem_floats"))
    return (lambda cmax: eval(stream, dict(env, cmax=cmax)),
            lambda children: eval(reverse, dict(env, children=children)))


@pytest.mark.parametrize("cmax", [1, 2, 3, 4, 5])
def test_stream_wide_smem_matches_the_kernel(cmax):
    """B5 at 64 states: the wrapper's bytes are the kernel's floats x 4
    (two stages of P blocks, one of x tiles, two rows of column maxima);
    nodes of up to 4 children fit, as before the tiles, and two blocks of
    a binary tree share an SM."""
    stream, _ = _kernel_floats()
    nbytes = cuda_pruning.stream_smem_bytes(64, cmax)
    assert nbytes == 4 * stream(cmax)
    assert nbytes == 4 * (3 * cmax * 64 * 68 + 2 * 64)
    assert (nbytes <= SMEM) == (cmax <= 4)
    if cmax == 2:
        assert 2 * (nbytes + 1024) <= 233_472     # two blocks an SM
    # 4 and 20 states keep their ring of 3 stages of P blocks
    assert cuda_pruning.stream_smem_bytes(20, cmax) == 4 * 3 * cmax * 400


@pytest.mark.parametrize("children", [1, 2, 3, 4])
def test_wide_reverse_smem_matches_the_kernel(children):
    """B3 and B7 at 64 states: the wrapper's bytes are the kernels' floats
    x 4 (a ring of two stages of P blocks and x tiles, then two gy tiles
    up to two children and one past them); B3 takes a node of at most 3
    children, and B7 stages 3 and reads wider visits through L1."""
    _, reverse = _kernel_floats()
    nbytes = cuda_pruning._reverse_smem_bytes(64, children, 64)
    gy = 2 if children <= 2 else 1
    assert nbytes == 4 * reverse(children)
    assert nbytes == 4 * 64 * 68 * (4 * children + gy)
    assert (nbytes <= SMEM) == (children <= 3)
    if children <= 3:
        assert cuda_pruning.reverse_tile(64, children) == 64
    else:
        with pytest.raises(ValueError, match="PHYLO_DEFERRED_VJP"):
            cuda_pruning.reverse_tile(64, children)
    staged, stage_bytes = cuda_pruning.classic_reverse_stage(64, children)
    assert staged == min(children, 3)
    assert stage_bytes == 4 * reverse(staged) <= SMEM
