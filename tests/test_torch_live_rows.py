"""Port parity, B1's live rows and B4's slots as the live-row kernel takes
them (``cuda_pruning.WalkSchedule.rows``, ``SlotSchedule.rows``,
``row_geometry``, ``csrc/pruning_rows.cuh``), and B9's F categories a
column over the slots (``fold_walk``).

A plain replay of the kernel's data flow (each child read from the leaf
array or from its row, each node written to its row after its children,
rows held by (row, category of the fold, column) as the kernel holds them)
gives ``forward_walk_reference``'s root bit for bit: the per-node
arithmetic is the plain walk's, so a row overwritten too early, or a
category read from another's row, would show as a different root. Against
the JAX Pallas pruner (interpret mode, under the fold knobs where the
replay folds) the per-site log-likelihood agrees to 1e-5 absolute, as in
``tests/test_torch_pruning.py``. The kernels themselves run only on the card
(tests marked ``gpu``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from phylo_utils_tpu import io as jio
from phylo_utils_tpu.ops.pallas_pruning import make_pallas_prune_fn
from phylo_utils_tpu.trees import compile_schedule as j_compile_schedule
from phylo_utils_tpu_torch import io as tio
from phylo_utils_tpu_torch import models as tmodels
from phylo_utils_tpu_torch.io import write_newick
from phylo_utils_tpu_torch.ops import cuda_pruning
from phylo_utils_tpu_torch.ops.cuda_pruning import (
    WalkSchedule,
    fold_walk,
    forward_walk,
    forward_walk_reference,
    row_geometry,
    row_smem_bytes,
    slot_walk,
    slot_walk_reference,
    static_walk,
)
from phylo_utils_tpu_torch.ops.pmatrix import (
    extend_p_identity,
    transition_matrices,
)
from phylo_utils_tpu_torch.ops.pruning import LN2
from phylo_utils_tpu_torch.trees import compile_schedule, random_tree

MODELS = {4: (tmodels.GTR, {"rates": [1.2, 3.1, 0.7, 0.9, 4.2, 1.0],
                            "freqs": [0.3, 0.2, 0.22, 0.28]}),
          20: (tmodels.LG, None)}
RATES = np.array([0.1, 0.6, 1.2, 2.1])
TOL = 1e-5
SMEM = 232_448      # an H100 block's shared memory


def _wide_root(n_star=9, seed=3):
    """A root of ``n_star`` leaf children beside a 6-taxon subtree."""
    rng = np.random.default_rng(seed)
    sub = write_newick(random_tree(6, seed=seed)).strip().rstrip(";")
    star = ",".join(f"w{i}:{rng.uniform(0.2, 0.5):.3f}"
                    for i in range(n_star))
    return f"({star},{sub}:0.1);"


TREES = {
    "random14": lambda: write_newick(random_tree(14, seed=5)),
    "wide_root": _wide_root,
}


def _inputs(newick, s, sites, binarize=True, batch_scales=None, seed=0,
            rates=RATES):
    """numpy-made f32 P (identity blocks for pseudo-nodes) over ``rates``
    (one category each) and one-hot leaves with 5% all-ones rows, for ``s``
    states."""
    tree = tio.parse_newick(newick)
    sched = compile_schedule(tree, binarize=binarize)
    model, params = MODELS[s]
    rng = np.random.default_rng(seed)
    lp = np.eye(s, dtype=np.float32)[rng.integers(0, s, (tree.n_leaves,
                                                          sites))]
    lp[rng.random((tree.n_leaves, sites)) < 0.05] = 1.0
    lengths = np.asarray(tree.lengths)
    if batch_scales is not None:
        lengths = np.stack([lengths * b for b in batch_scales])
    t = torch.from_numpy(lengths[..., None] * rates)
    p = extend_p_identity(transition_matrices(model.eigen(params), t),
                          sched.n_nodes)
    return sched, p.to(torch.float32).contiguous(), torch.from_numpy(lp)


def _replay(p, leaves, walk, rw, fold=1):
    """The live-row kernel's data flow in plain PyTorch over ``rw`` (a
    ``RowWalk``), edge by edge through its words: edge f reads child
    ``edges[f]`` from the leaf array (``eword[f, 0]`` = -1 - leaf, one read
    for every category) or from row ``eword[f, 0]``; on a node's last child
    (``eword[f, 1]`` != -2) the node is formed and written to row
    ``eword[f, 1]``, or is the root (-1). Rows are held as the kernel holds
    them with ``fold`` categories a column: (row, f, column), a column
    being (batch element, category group g, site) and category g fold +
    f."""
    batched = p.dim() == 5
    pb = p if batched else p[None]
    b, _, k = pb.shape[:3]
    sites, s = leaves.shape[1:]
    groups = k // fold
    xs = torch.full((rw.n_rows, fold, b, groups, sites, s), float("nan"))
    es = torch.full((rw.n_rows, fold, b, groups, sites), float("nan"))

    def read(buf, r):   # (fold, b, groups, ...) -> (b, k, ...)
        x = buf[r].movedim(0, 2)
        return x.reshape(b, k, *x.shape[3:])

    def write(buf, r, x):   # (b, k, ...) -> (fold, b, groups, ...)
        buf[r] = x.reshape(b, groups, fold, *x.shape[2:]).movedim(2, 0)

    kids, row = [], {}
    for ch, (src, dst) in zip(rw.edges.tolist(), rw.eword[:-1].tolist()):
        if src < 0:
            assert ch == -1 - src < walk.n_leaves
        else:
            row[ch] = src
        kids.append(ch)
        if dst == -2:
            continue
        x, e = cuda_pruning._node_partials(
            pb, leaves, walk.n_leaves, kids, lambda c: read(xs, row[c]),
            lambda c: read(es, row[c]))
        kids, row = [], {}
        if dst == -1:
            return (x, e) if batched else (x[0], e[0])
        write(xs, dst, x)
        write(es, dst, e)


def _site_ll(root_p, root_e, freqs):
    return (np.log(root_p.double().numpy() @ freqs)
            + root_e.double().numpy() * LN2)


@pytest.mark.parametrize("binarize", [True, False])
@pytest.mark.parametrize("case", sorted(TREES))
@pytest.mark.parametrize("s", [4, 20])
def test_live_row_replay_matches_plain_walk_and_pallas(s, case, binarize):
    """B1's live rows and B4's slots, replayed, give the plain walk's root
    bit for bit, and JAX's Pallas pruner's per-site logL to 1e-5."""
    newick = TREES[case]()
    sched, p, lp = _inputs(newick, s, 40, binarize=binarize)
    walk = WalkSchedule(sched)
    want = forward_walk_reference(p, lp, walk)
    for rw in (walk.rows, walk.slots.rows):
        got = _replay(p, lp, walk, rw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert walk.slots.rows.n_rows <= walk.rows.n_rows
    if not binarize and case == "wide_root":
        assert walk.children.shape[1] >= 10   # the root kept whole
    jsched = j_compile_schedule(jio.parse_newick(newick), binarize=binarize)
    r, sc = make_pallas_prune_fn(jsched)(jnp.asarray(p.numpy()),
                                         jnp.asarray(lp.numpy()))
    freqs = np.full(s, 1.0 / s)
    jax_ll = np.log(np.asarray(r, np.float64) @ freqs) + np.asarray(sc)
    np.testing.assert_allclose(_site_ll(*want, freqs), jax_ll, rtol=0,
                               atol=TOL)


# (states, categories, F, the JAX knob under which its Pallas pruner folds
# the same categories: the DNA pack is a fold of 2; at 4 states JAX folds
# only to a width of 24 lanes or more, so 4)
FOLDS = [(4, 4, 2, {"PHYLO_PACK_DNA": "1"}),
         (4, 4, 4, {"PHYLO_FOLD_CATEGORIES": "4"}),
         (20, 3, 3, {"PHYLO_FOLD_CATEGORIES": "auto"}),
         (20, 4, 2, {"PHYLO_FOLD_CATEGORIES": "2"})]


@pytest.mark.parametrize("s,k,fold,knob", FOLDS)
def test_fold_replay_matches_plain_walk_and_pallas(monkeypatch, s, k, fold,
                                                   knob):
    """B9's data flow, F categories a column over the slots (rows as (row,
    f, column)), replayed single and batched on a root of many children
    kept whole: the plain walk's root bit for bit, and JAX's Pallas
    pruner's per-site logL under the fold knob to 1e-5."""
    newick = TREES["wide_root"]()
    sched, p, lp = _inputs(newick, s, 37, binarize=False,
                           batch_scales=(0.5, 2.0), rates=RATES[:k])
    walk = WalkSchedule(sched)
    assert cuda_pruning.row_geometry(2, k, 37, s, walk.slots.rows.n_rows,
                                     fold=fold).smem_bytes <= SMEM
    want = forward_walk_reference(p, lp, walk)
    got = _replay(p, lp, walk, walk.slots.rows, fold)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = fold_walk(p[1], lp, walk, fold)     # the CPU takes the plain walk
    assert torch.equal(got[0], want[0][1]) and torch.equal(got[1], want[1][1])
    for name, value in knob.items():
        monkeypatch.setenv(name, value)
    jsched = j_compile_schedule(jio.parse_newick(newick), binarize=False)
    r, sc = make_pallas_prune_fn(jsched)(jnp.asarray(p[1].numpy()),
                                         jnp.asarray(lp.numpy()))
    freqs = np.full(s, 1.0 / s)
    jax_ll = np.log(np.asarray(r, np.float64) @ freqs) + np.asarray(sc)
    np.testing.assert_allclose(_site_ll(want[0][1], want[1][1], freqs),
                               jax_ll, rtol=0, atol=TOL)


def test_live_row_replay_batched():
    sched, p, lp = _inputs(TREES["random14"](), 4, 23,
                           batch_scales=(0.5, 1.0, 3.0))
    walk = WalkSchedule(sched)
    want = forward_walk_reference(p, lp, walk)
    got = _replay(p, lp, walk, walk.rows)
    assert got[0].shape == (3, 4, 23, 4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _random_newick(rng, n):
    """A random tree of ``n`` taxa whose internal nodes have 2 to 5
    children."""
    nodes = [f"t{i}:{rng.uniform(0.05, 0.5):.3f}" for i in range(n)]
    while len(nodes) > 1:
        k = min(len(nodes), int(rng.integers(2, 6)))
        pick = sorted(rng.choice(len(nodes), k, replace=False).tolist(),
                      reverse=True)
        group = [nodes.pop(j) for j in pick]
        nodes.append(f"({','.join(group)}):{rng.uniform(0.05, 0.5):.3f}")
    return nodes[0].rsplit(":", 1)[0] + ";"


@settings(max_examples=40, deadline=None)
@given(n=st.integers(2, 60), seed=st.integers(0, 2 ** 31 - 1),
       binarize=st.booleans())
def test_live_rows_never_overwrite_a_row_still_to_be_read(n, seed,
                                                          binarize):
    tree = tio.parse_newick(_random_newick(np.random.default_rng(seed), n))
    walk = WalkSchedule(compile_schedule(tree, binarize=binarize))
    rw = walk.rows
    n_inner = walk.n_nodes - walk.n_leaves
    assert rw.n_rows <= n_inner
    assert rw.edges.tolist() == walk.edges.tolist()
    holder = {}
    nodes = iter(walk.order.tolist())
    ends = 0
    for ch, (src, dst) in zip(rw.edges.tolist(), rw.eword[:-1].tolist()):
        if ch >= walk.n_leaves:
            assert holder.pop(src) == ch    # its own value, unread
        else:
            assert src == -1 - ch
        if dst == -2:
            continue
        ends += 1
        node = next(nodes)
        if dst == -1:
            assert node == walk.root
        else:
            assert 0 <= dst < rw.n_rows
            assert dst not in holder    # no row still to be read is lost
            holder[dst] = node
    assert ends == n_inner and not holder and rw.eword[-2, 1] == -1


@pytest.mark.parametrize("taxa,seed,brlen,rows", [
    (32, 13, 0.2, 11),      # BASELINE config 4's tree
    (64, 0, None, 24),      # the flagship's
    (128, 5, None, 47),     # config 5's
])
def test_live_row_counts_of_the_repos_trees(taxa, seed, brlen, rows):
    kw = {} if brlen is None else {"mean_brlen": brlen}
    walk = WalkSchedule(compile_schedule(random_tree(taxa, seed=seed, **kw)))
    assert walk.rows.n_rows == rows
    assert walk.slots.rows.n_rows == walk.slots.n_slots < rows


def _fits_at_32(s, rows, stage_leaves):
    return row_smem_bytes(s, 32, min(cuda_pruning._ROW_CHUNKS), stage_leaves,
                          rows) <= SMEM


@pytest.mark.parametrize("b", [1, 4, 16, 64])
@pytest.mark.parametrize("s", [4, 20])
def test_row_geometry_bounds(s, b):
    """Shared memory within an H100 block's, at least 32 columns a block,
    and rows left in device memory exactly where they do not fit at 32
    columns (then all of them)."""
    for rows in list(range(1, 64)) + list(range(64, 501, 7)) + [500]:
        for sites in (37, 1024, 8192):
            geo = row_geometry(b, 4, sites, s, rows)
            assert geo.smem_bytes <= SMEM
            assert geo.smem_bytes == row_smem_bytes(
                s, geo.cols, geo.chunk, geo.stage_leaves, geo.smem_rows)
            # leaf rows through the ring at 4 states in small launches only
            assert geo.stage_leaves == (s == 4 and 4 * b * sites < 50_688)
            assert geo.cols >= 32 and geo.cols * geo.lanes <= 256
            assert (geo.cols * geo.lanes) % 32 == 0
            assert geo.lanes in cuda_pruning._ROW_LANES[s]
            assert geo.chunk in cuda_pruning._ROW_CHUNKS
            assert (geo.smem_rows < rows) == (
                not _fits_at_32(s, rows, geo.stage_leaves))
            if geo.smem_rows < rows:    # then none stays on the SM
                assert geo.smem_rows == 0


def test_row_geometry_spreads_b1_and_takes_forced_settings():
    """The flagship B = 1 launch (4 categories x 1024 sites) spreads over
    ~128 blocks; forced settings are taken, and rows that do not fit are
    refused."""
    for s, rows in ((4, 24), (20, 11)):
        geo = row_geometry(1, 4, 1024, s, rows)
        assert -(-1024 // geo.cols) * 4 >= 128
        assert geo.lanes == max(cuda_pruning._ROW_LANES[s])
        assert geo.smem_rows == rows
    geo = row_geometry(1, 4, 1024, 4, 24, smem_rows=1, lanes=2, cols=64,
                       chunk=4, stage_leaves=False)
    assert (geo.smem_rows, geo.lanes, geo.cols, geo.chunk,
            geo.stage_leaves) == (1, 2, 64, 4, False)
    assert row_geometry(1, 4, 1024, 4, 24, smem_rows=0).smem_rows == 0
    with pytest.raises(ValueError, match="smem_rows"):
        row_geometry(1, 4, 1024, 4, 24, smem_rows=25)
    with pytest.raises(ValueError, match="lanes"):
        row_geometry(1, 4, 1024, 20, 24, lanes=4)
    big = row_geometry(1, 4, 8192, 20, 170)         # 512-taxon LG's rows
    assert big.smem_rows == 0 and big.cols > 32
    assert row_geometry(1, 4, 8192, 20, 170, smem_rows=1).smem_rows == 1


@pytest.mark.parametrize("s", [4, 20])
def test_row_geometry_with_fold(s):
    """F categories a column: shared memory within an H100 block's, the
    rows held F times a column, only the lane counts compiled for F taken,
    forced settings honoured, an uncompiled F, lane count or an F that
    does not divide K refused."""
    widths = cuda_pruning.FOLD_WIDTHS[s]
    for fold in widths:
        k = 4 * fold
        for b in (1, 16, 64):
            for rows in (3, 4, 8, 24, 170):
                geo = row_geometry(b, k, 1024, s, rows, fold=fold)
                assert geo.smem_bytes <= SMEM
                assert geo.smem_bytes == row_smem_bytes(
                    s, geo.cols, geo.chunk, geo.stage_leaves, geo.smem_rows,
                    fold)
                assert geo.smem_bytes - row_smem_bytes(
                    s, geo.cols, geo.chunk, geo.stage_leaves, 0, fold) == (
                    4 * geo.smem_rows * fold * geo.cols * (s + 1))
                assert geo.smem_rows in (0, rows)
                # leaf rows through the ring only where the launch's
                # columns, b x k / F x sites, are few (4 states)
                assert geo.stage_leaves == (
                    s == 4 and b * (k // fold) * 1024 < 50_688)
        for lanes in widths[fold]:
            geo = row_geometry(1, k, 1024, s, 4, fold=fold, lanes=lanes,
                               cols=64, chunk=2, stage_leaves=False,
                               smem_rows=1)
            assert (geo.lanes, geo.cols, geo.chunk, geo.stage_leaves,
                    geo.smem_rows) == (lanes, 64, 2, False, 1)
        for lanes in set(cuda_pruning._ROW_LANES[s]) - set(widths[fold]):
            with pytest.raises(ValueError, match="lanes"):
                row_geometry(1, k, 1024, s, 4, fold=fold, lanes=lanes)
        assert row_geometry(16, k, 1024, s, 4, fold=fold).lanes in widths[
            fold]
        with pytest.raises(ValueError, match="does not divide"):
            row_geometry(1, 4 * fold + 1, 1024, s, 4, fold=fold)
    for fold in (3, 6) if s == 4 else (6, 8):
        with pytest.raises(ValueError, match="compiled"):
            row_geometry(1, 24, 1024, s, 4, fold=fold)


def test_row_walk_on_cpu_takes_the_plain_versions(monkeypatch):
    """On CPU tensors B1, B4, B8 and B9 take their plain versions, whatever
    the forced geometry, and launch nothing (B8 builds nothing)."""
    sched, p, lp = _inputs(TREES["random14"](), 4, 29)
    walk = WalkSchedule(sched)
    calls = []
    for name in ("forward_walk_reference", "slot_walk_reference"):
        real = getattr(cuda_pruning, name)
        monkeypatch.setattr(
            cuda_pruning, name,
            lambda *a, _real=real, _name=name: calls.append(_name)
            or _real(*a))
    counters = ("LAUNCHES", "SLOT_LAUNCHES", "FOLD_LAUNCHES",
                "STATIC_LAUNCHES")
    before = [getattr(cuda_pruning, c) for c in counters]
    a = cuda_pruning._row_walk(p, lp, walk, "forward", smem_rows=0)
    c = cuda_pruning._row_walk(p, lp, walk, "slot", smem_rows=1)
    f = fold_walk(p, lp, walk, 2, smem_rows=1, lanes=2)
    g = static_walk(p, lp, walk, smem_rows=0)
    assert calls == ["forward_walk_reference", "slot_walk_reference",
                     "forward_walk_reference", "forward_walk_reference"]
    for x in (c, f, g):
        assert torch.equal(a[0], x[0]) and torch.equal(a[1], x[1])
    assert [getattr(cuda_pruning, c) for c in counters] == before
    assert walk._static == {}


# -- on the card -----------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("s", [4, 20])
def test_live_row_kernels_with_forced_rows_on_card(s):
    """B1 and B4 on the card with 0, 1 and all rows in shared memory: roots
    bit for bit across the settings, between B1 and B4 and against B5 (P
    staged, slots in device memory), single and batched, a root of many
    children kept whole included; within 1e-5 of the plain version."""
    _cuda_or_skip()
    freqs = np.full(s, 1.0 / s)
    for case, binarize in (("random14", True), ("wide_root", False)):
        sched, p, lp = _inputs(TREES[case](), s, 301, binarize=binarize,
                               batch_scales=(0.5, 1.0, 3.0))
        walk = WalkSchedule(sched)
        pd, ld = p.cuda(), lp.cuda()
        want = slot_walk(pd, ld, walk, stream=True)
        plain = forward_walk_reference(pd, ld, walk)
        for kind, rw in (("forward", walk.rows), ("slot", walk.slots.rows)):
            for smem_rows in sorted({0, 1, rw.n_rows}):
                got = cuda_pruning._row_walk(pd, ld, walk, kind,
                                             smem_rows=smem_rows)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (case, kind, smem_rows)
                np.testing.assert_allclose(
                    _site_ll(got[0].cpu(), got[1].cpu(), freqs),
                    _site_ll(plain[0].cpu(), plain[1].cpu(), freqs),
                    rtol=0, atol=TOL)
        got = forward_walk(pd[1], ld, walk, walk="classic")
        assert torch.equal(got[0], want[0][1])
        got = slot_walk(pd[1], ld, walk)
        assert torch.equal(got[0], want[0][1])


@pytest.mark.gpu
def test_live_row_kernels_every_geometry_on_card():
    """Every compiled lane count, several block widths and steps (one that
    divides no node's children), leaf rows staged or not: the same
    bits."""
    _cuda_or_skip()
    for s in (4, 20):
        sched, p, lp = _inputs(TREES["random14"](), s, 301)
        walk = WalkSchedule(sched)
        pd, ld = p.cuda(), lp.cuda()
        want = forward_walk(pd, ld, walk, walk="classic")
        for lanes in cuda_pruning._ROW_LANES[s]:
            for cols in (32, 256 // lanes):
                for chunk in (1, 3, 8):
                    for staged in (False, True):
                        got = cuda_pruning._row_walk(
                            pd, ld, walk, "slot", lanes=lanes, cols=cols,
                            chunk=chunk, stage_leaves=staged)
                        torch.cuda.synchronize()
                        assert torch.equal(got[0], want[0]) and torch.equal(
                            got[1], want[1]), (s, lanes, cols, chunk, staged)
