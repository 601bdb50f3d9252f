"""The 64-state tiled walks' shared memory (B5's ``pruning_stream_wide_
kernel``, B3's ``pruning_reverse_wide_kernel``, B7's
``classic_reverse_wide_kernel``, B2's ``pruning_saveall_wide_kernel`` and
the live-row body's ``row_walk_wide_kernel``): the wrappers' byte counts
(``cuda_pruning.stream_smem_bytes``, ``_reverse_smem_bytes``,
``saveall_stage``, ``row_smem_bytes``) against the formulas the kernels
launch with, read from ``csrc/`` and evaluated here, for every node width
the walks take, and the widths and rows that fit an SM's 232,448 bytes.
The kernels themselves run only on the card."""
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


def _saveall_wide_floats():
    """B2's floats per 64-state block, a function of the children a step
    stages, and the most it compiles for, from ``csrc/pruning_forward.cu``."""
    common = (CSRC / "pruning_common.cuh").read_text()
    tile = int(re.search(r"constexpr int kWideTile = (\d+);", common)[1])
    row = eval(_py(_body("pruning_common.cuh", "p_row")), {"S": 64})
    expr = _py(_body("pruning_forward.cu", "saveall_wide_smem_floats"))
    most = int(re.search(r"constexpr int kSaveallWideMaxChunk = (\d+);",
                         (CSRC / "pruning_forward.cu").read_text())[1])
    return (lambda chunk: eval(expr, {"chunk": chunk,
                                      "wide_tile_floats": lambda: tile * row}),
            most)


@pytest.mark.parametrize("chunk", [1, 2, 3, 4])
def test_saveall_wide_smem_matches_the_kernel(monkeypatch, chunk):
    """B2 at 64 states: ``saveall_stage``'s bytes are the kernel's floats x
    4 (two stages of a step's P blocks, one of its x tiles), whatever the
    widest node (a step is up to ``chunk`` children of one node, so a node
    of any width runs in steps); the kernel takes the steps that fit an
    SM, and two blocks of 2-children steps share one."""
    floats, most = _saveall_wide_floats()
    monkeypatch.setitem(cuda_pruning._SAVEALL_CHUNK, 64, chunk)
    for n_edges in (chunk, 2 * chunk + 1, 10 ** 6):
        assert cuda_pruning.saveall_stage(64, n_edges) == (
            chunk, 4 * floats(chunk))
    nbytes = 4 * floats(chunk)
    assert nbytes == 4 * 3 * chunk * 64 * 68
    assert (chunk <= most) == (chunk <= 3)
    assert nbytes <= SMEM
    if chunk == 2:
        assert 2 * (nbytes + 1024) <= 233_472     # two blocks an SM
    monkeypatch.undo()
    assert cuda_pruning._SAVEALL_CHUNK[64] <= most
    assert cuda_pruning._SAVEALL_LANES[64] == 4   # four threads a column


def _row_smem_bytes_of_the_header():
    """``pruning_rows.cuh``'s ``row_smem_bytes`` (and ``row_stage_floats``)
    as a Python function of (s, cols, chunk, stage_leaves, smem_rows,
    fold)."""
    text = (CSRC / "pruning_rows.cuh").read_text()
    m = re.search(r"row_stage_floats\([^)]*\)\s*\{\s*const int p_rows = "
                  r"(.*?);.*?return (.*?);\s*\}", text, re.S)
    assert m, "row_stage_floats not found"

    def cond(expr):   # C's "(c ? a : b)" inside an expression
        return re.sub(r"\((\w+) \? ([^:()]+) : ([^()]+)\)",
                      r"((\2) if \1 else (\3))", " ".join(expr.split()))

    p_rows, stage = _py(m[1]), cond(m[2])
    common = (CSRC / "pruning_common.cuh").read_text()
    stages = int(re.search(r"constexpr int kPStages = (\d+);", common)[1])
    total = _py(_body("pruning_rows.cuh", "row_smem_bytes")).replace(
        "sizeof(float)", "4")

    def stage_floats(s, cols, chunk, stage_leaves, fold):
        return eval(stage, {"s": s, "cols": cols, "chunk": chunk,
                            "stage_leaves": stage_leaves, "fold": fold,
                            "p_rows": eval(p_rows, {"s": s})})

    return lambda s, cols, chunk, stage_leaves, smem_rows, fold: eval(
        total, {"s": s, "cols": cols, "chunk": chunk,
                "stage_leaves": stage_leaves, "smem_rows": smem_rows,
                "fold": fold, "kPStages": stages,
                "row_stage_floats": stage_floats})


@pytest.mark.parametrize("fold", [1, 2])
def test_live_row_wide_smem_matches_the_kernel(fold):
    """The live-row body at 64 states (B1, B4, B8; B9 at F = 2): the
    wrapper's bytes are the header's (a ring of 3 steps of P blocks, rows
    68 floats apart, and leaf rows where staged; then the rows on the SM,
    64 floats and an exponent a column); four threads a column, whole
    warps of 8 columns; at phase 27's shape (100 taxa x 4096 sites, 4
    categories) the rows leave the SM, so two blocks share one, and the
    rows that fit a block of 64 and 32 columns at a step of 2."""
    header = _row_smem_bytes_of_the_header()
    for cols in (32, 64):
        for chunk in (2, 4, 8):
            for staged in (False, True):
                for rows in (0, 1, 5, 7):
                    assert cuda_pruning.row_smem_bytes(
                        64, cols, chunk, staged, rows, fold) == header(
                        64, cols, chunk, int(staged), rows, fold)
    assert cuda_pruning._ROW_LANES[64] == (4,)
    assert cuda_pruning.FOLD_WIDTHS[64] == {2: (4,)}
    assert cuda_pruning._rows_that_fit(64, 64, 2, False, fold) == (
        7 if fold == 1 else 0)
    assert cuda_pruning._rows_that_fit(64, 32, 2, False, fold) == (
        15 if fold == 1 else 1)
    for rows in (5, 30):      # B4's slots and B1's live rows at phase 27
        geo = cuda_pruning.row_geometry(1, 4, 4096, 64, rows, fold=fold)
        assert (geo.lanes, geo.cols, geo.chunk, geo.smem_rows) == (
            4, 64, 2, 0)
        assert geo.smem_bytes == header(64, 64, 2, 0, 0, fold) <= SMEM
        assert (geo.cols * geo.lanes) % 32 == 0
        if fold == 1:
            assert 2 * (geo.smem_bytes + 1024) <= 233_472
    # a launch of fewer blocks than SMs keeps the rows that fit
    geo = cuda_pruning.row_geometry(1, 4, 1000, 64, 3, fold=fold)
    assert geo.smem_rows == (3 if fold == 1 else 0)
    assert geo.smem_bytes <= SMEM
