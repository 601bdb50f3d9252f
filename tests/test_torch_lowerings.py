"""Port parity, the classic walk's lowerings: the topology-compiled walk
(B8, ``cuda_pruning.static_walk``, kernel ``pruning_static_f32``) and the
category-fold walk (B9, ``fold_walk``, kernel ``pruning_fold_f32``; the DNA
pack is its fold of 2), the choice among them (``choose_lowering``,
``_pick_fold``) and ``make_cuda_prune_fn``, against the JAX package.

The JAX side runs ``make_pallas_prune_fn`` in interpret mode under the same
knob (``STATIC_UNROLL_MAX``, ``PHYLO_FOLD_CATEGORIES``, ``PHYLO_PACK_DNA``)
on the inputs of ``tests/test_pallas_pruning.py`` and
``tests/test_grouped_walk.py``, and its XLA pruner; the port runs the plain
versions on CPU tensors. Tolerances are the JAX tests' own for its Pallas
kernels against XLA (root partials 2e-5 relative + 2e-6, logscales 2e-5 +
2e-4; gradients 1e-4): the same f32 products summed in another order. The
kernels run only on the card (the test marked ``gpu``).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_utils_tpu import io as jio
from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu.ops import pallas_pruning as jpp
from phylo_utils_tpu.ops.pmatrix import p_matrices_reversible
from phylo_utils_tpu.ops.pruning import make_prune_fn as j_make_prune_fn
from phylo_utils_tpu.trees import compile_schedule as j_compile_schedule
from phylo_utils_tpu_torch import io as tio
from phylo_utils_tpu_torch.io import write_newick
from phylo_utils_tpu_torch.ops import _build, cuda_pruning
from phylo_utils_tpu_torch.ops.cuda_pruning import (
    WalkSchedule,
    choose_lowering,
    fold_walk,
    forward_walk,
    forward_walk_reference,
    make_cuda_prune_fn,
    static_walk,
)
from phylo_utils_tpu_torch.trees import compile_schedule, random_tree

MULTIFURCATING = (
    "((a:0.1,b:0.2,c:0.05):0.1,(d:0.3,e:0.1,f:0.2,g:0.15):0.2,"
    "(h:0.1,(i:0.2,j:0.3):0.05):0.1,k:0.4,l:0.25);"
)
KNOBS = ("PHYLO_FOLD_CATEGORIES", "PHYLO_PACK_DNA", "PHYLO_FORCE_STREAM")


@pytest.fixture(autouse=True)
def _knobs_off(monkeypatch):
    """Every test starts with the lowering knobs at their defaults (off)
    and ``PHYLO_FORCE_STREAM`` at its own ("auto")."""
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(cuda_pruning, "STATIC_UNROLL_MAX", 0)
    monkeypatch.setattr(jpp, "STATIC_UNROLL_MAX", 0)


def _trees(n_taxa, seed):
    """(newick, JAX tree) of one random tree; both packages parse the
    newick, so their node ids agree."""
    newick = write_newick(random_tree(n_taxa, seed=seed))
    return newick, jio.parse_newick(newick)


def _pallas_setup(n_taxa, sites, n_states=4, seed=0, ncat=4):
    """``tests/test_pallas_pruning.py``'s ``_setup``: f32 GTR or LG P over
    linspace rates, leaves of random 0/1 rows floored at 1e-3. Returns
    (newick, JAX schedule, P, leaves)."""
    newick, tree = _trees(n_taxa, seed)
    sched = j_compile_schedule(tree)
    rng = np.random.default_rng(seed)
    lp = (rng.random((n_taxa, sites, n_states)) > 0.5).astype(np.float32)
    lp = np.maximum(lp, 1e-3)
    model = jmodels.GTR if n_states == 4 else jmodels.LG
    sym, freqs = model.build_parts(dtype=jnp.float32)
    rates = jnp.linspace(0.2, 2.0, ncat, dtype=jnp.float32)
    t = jnp.asarray(tree.lengths, jnp.float32)[:, None] * rates[None, :]
    p = p_matrices_reversible(sym, freqs, t)
    return newick, sched, np.asarray(p), lp


def _codon_width_setup(n_taxa=8, sites=100, s=61, seed=5):
    """A codon width (61 states, padded to 64 by the port and to S_pad 64 by
    the JAX package): f32 P of a seeded random reversible model over
    linspace rates, leaves of random 0/1 rows floored at 1e-3, on ``n_taxa``
    taxa and one 128-site tile. Returns (newick, JAX schedule, P, leaves)."""
    newick, tree = _trees(n_taxa, seed)
    sched = j_compile_schedule(tree)
    rng = np.random.default_rng(seed)
    lp = np.maximum((rng.random((n_taxa, sites, s)) > 0.5).astype(
        np.float32), 1e-3)
    sym = rng.uniform(0.2, 2.0, (s, s))
    freqs = rng.dirichlet(np.full(s, 4.0))
    rates = jnp.linspace(0.2, 2.0, 4, dtype=jnp.float32)
    t = jnp.asarray(tree.lengths, jnp.float32)[:, None] * rates[None, :]
    p = p_matrices_reversible(jnp.asarray(sym + sym.T, jnp.float32),
                              jnp.asarray(freqs, jnp.float32), t)
    return newick, sched, np.array(p), lp


def _grouped_setup(seed_tree=10, seed=11, k=4, sites=260, s=4):
    """``tests/test_grouped_walk.py``'s ``_rand_inputs``: Dirichlet P rows,
    leaves of 0/1 rows plus 0.1."""
    newick, tree = _trees(16, seed_tree)
    sched = j_compile_schedule(tree)
    rng = np.random.default_rng(seed)
    pmat = rng.dirichlet(np.ones(s), size=(sched.n_nodes, k, s)).astype(
        np.float32)
    leaves = ((rng.random((sched.n_leaves, sites, s)) < 0.3).astype(
        np.float32) + 0.1)
    return newick, sched, pmat, leaves


def _walk(newick):
    return WalkSchedule(compile_schedule(tio.parse_newick(newick)))


# -- the choice ---------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3, 4, 7, 16, 20])
def test_pick_fold_auto_matches_jax_at_20_states(monkeypatch, k):
    """Under "auto" at 20 states the port folds as many categories as JAX
    (whose cap is 128 lanes over S_pad 24, the port's the widest compiled
    F, 5): 3 -> 3, 4 -> 4, 16 -> 4, 20 -> 5, and no fold for K = 1 or a K
    that no width divides (7)."""
    monkeypatch.setenv("PHYLO_FOLD_CATEGORIES", "auto")
    got = cuda_pruning._pick_fold(k, 20)
    assert got == jpp._pick_fold(k, jpp._state_pad(20))
    assert got == {1: 1, 3: 3, 4: 4, 7: 1, 16: 4, 20: 5}[k]


def test_pick_fold_env_values(monkeypatch):
    """"0" (and unset) never folds; "auto" folds only at 20 states; "<int>"
    folds at most that many, down to a compiled width that divides K."""
    pick = cuda_pruning._pick_fold
    assert pick(4, 20) == 1                              # unset
    monkeypatch.setenv("PHYLO_FOLD_CATEGORIES", "0")
    assert pick(4, 20) == pick(4, 4) == 1
    monkeypatch.setenv("PHYLO_FOLD_CATEGORIES", "auto")
    assert pick(4, 4) == 1 and pick(4, 20) == 4
    monkeypatch.setenv("PHYLO_FOLD_CATEGORIES", "2")
    assert pick(4, 4) == 2 and pick(12, 20) == 2 and pick(3, 20) == 1
    monkeypatch.setenv("PHYLO_FOLD_CATEGORIES", "3")
    assert pick(4, 4) == 2 and pick(6, 4) == 2 and pick(3, 4) == 1
    assert pick(3, 20) == 3 and pick(6, 20) == 3
    monkeypatch.setenv("PHYLO_FOLD_CATEGORIES", "8")
    assert pick(16, 20) == 4 and pick(16, 4) == 4 and pick(20, 20) == 5
    assert pick(8, 4) == 4 and pick(9, 4) == 1 and pick(9, 20) == 3
    for k, s in ((16, 20), (20, 20), (12, 4)):
        f = pick(k, s)
        assert k % f == 0 and f in cuda_pruning.FOLD_WIDTHS[s]
    monkeypatch.setenv("PHYLO_FOLD_CATEGORIES", "5")
    assert pick(5, 4) == 1 and pick(7, 20) == 1         # nothing divides


def test_choose_lowering_precedence(monkeypatch):
    """JAX's ``_pallas_forward`` order: static while the internal nodes are
    at most STATIC_UNROLL_MAX, else pack (4 states, K even), else fold,
    else the forward kernel; with every knob off, the forward kernel."""
    assert choose_lowering(4, 63, 4) == choose_lowering(4, 31, 20) == (
        "classic", 1)
    monkeypatch.setenv("PHYLO_PACK_DNA", "1")
    assert choose_lowering(4, 63, 4) == ("fold", 2)
    assert choose_lowering(3, 63, 4) == ("classic", 1)    # K odd: no pack
    assert choose_lowering(4, 31, 20) == ("classic", 1)   # pack is DNA only
    monkeypatch.setenv("PHYLO_FOLD_CATEGORIES", "auto")
    assert choose_lowering(4, 31, 20) == ("fold", 4)
    assert choose_lowering(4, 63, 4) == ("fold", 2)       # pack first
    monkeypatch.setenv("PHYLO_PACK_DNA", "0")
    monkeypatch.setenv("PHYLO_FOLD_CATEGORIES", "4")
    assert choose_lowering(4, 63, 4) == ("fold", 4)
    monkeypatch.setattr(cuda_pruning, "STATIC_UNROLL_MAX", 63)
    assert choose_lowering(4, 63, 4) == ("static", 1)
    assert choose_lowering(4, 64, 4) == ("fold", 4)


def _spy(monkeypatch, calls):
    """Record which of the lowering wrappers and walks forward_walk calls."""
    for name in ("static_walk", "fold_walk", "slot_walk",
                 "forward_walk_reference"):
        real = getattr(cuda_pruning, name)
        monkeypatch.setattr(
            cuda_pruning, name,
            lambda *a, _real=real, _name=name, **kw: calls.append(_name)
            or _real(*a, **kw))


@pytest.mark.parametrize("s", [4, 20])
def test_forward_walk_routes_lowerings_only_on_the_classic_walk(
        monkeypatch, s):
    """Under the knobs "auto" takes B8 or B9 where ``choose_walk`` gives the
    classic walk, with the same bits as the forward kernel's plain walk;
    the slot and stream walks, and an explicit walk="classic", are never
    replaced; CPU tensors launch nothing."""
    newick, _, p, lp = _pallas_setup(16, 37, n_states=s)
    walk = _walk(newick)
    p, lp = torch.from_numpy(p), torch.from_numpy(lp)
    want = forward_walk_reference(p, lp, walk)
    counters = ("LAUNCHES", "STATIC_LAUNCHES", "FOLD_LAUNCHES")
    before = [getattr(cuda_pruning, c) for c in counters]
    calls = []
    _spy(monkeypatch, calls)
    monkeypatch.setattr(cuda_pruning, "STATIC_UNROLL_MAX", 10 ** 6)
    monkeypatch.setenv("PHYLO_PACK_DNA", "1")
    monkeypatch.setenv("PHYLO_FOLD_CATEGORIES", "auto")
    got = [forward_walk(p, lp, walk)]
    monkeypatch.setattr(cuda_pruning, "STATIC_UNROLL_MAX", 0)
    got.append(forward_walk(p, lp, walk))
    monkeypatch.setenv("PHYLO_PACK_DNA", "0")
    got.append(forward_walk(p, lp, walk))
    assert calls == ["static_walk", "forward_walk_reference",
                     "fold_walk", "forward_walk_reference",
                     *(["fold_walk", "forward_walk_reference"] if s == 20
                       else ["forward_walk_reference"])]
    for r, e in got:
        assert torch.equal(r, want[0]) and torch.equal(e, want[1])
    calls.clear()
    monkeypatch.setattr(cuda_pruning, "STATIC_UNROLL_MAX", 10 ** 6)
    forward_walk(p, lp, walk, walk="classic")
    monkeypatch.setattr(cuda_pruning, "CLASSIC_SCRATCH_BUDGET", 0)
    forward_walk(p, lp, walk)
    assert calls == ["forward_walk_reference", "slot_walk"]
    assert [getattr(cuda_pruning, c) for c in counters] == before


def test_fold_walk_refuses_a_fold_that_does_not_divide_k():
    newick, _, p, lp = _pallas_setup(8, 20, ncat=3)
    walk = _walk(newick)
    with pytest.raises(ValueError, match="does not divide"):
        fold_walk(torch.from_numpy(p), torch.from_numpy(lp), walk, 2)
    got = fold_walk(torch.from_numpy(p), torch.from_numpy(lp), walk, 3)
    want = static_walk(torch.from_numpy(p), torch.from_numpy(lp), walk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -- B8's generated header ----------------------------------------------------


def _header_arrays(text):
    def ints(name):
        m = re.search(rf"constexpr int {name}(?:\[[^\]]*\])? = \{{([^}}]*)\}};",
                      text)
        return np.array([int(v) for v in m.group(1).split(",")], np.int32)

    def scalar(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    return ints, scalar


@pytest.mark.parametrize("case", ["random16", "multifurcating",
                                  "caterpillar12"])
@pytest.mark.parametrize("s", [4, 20])
def test_static_header_holds_jax_postorder_arrays(case, s):
    """The header B8 is compiled against holds the live-row walk B8 takes,
    ``RowWalk``'s edges and words for the schedule's DFS slots
    (``SlotSchedule.rows``), its row count, the node, leaf and state counts
    and the step, as constexpr arrays; that walk visits JAX's
    ``_postorder_arrays`` nodes (post-order, children, counts), each once,
    with the same children in the same order, children before parents. It
    is written without nvcc."""
    newick = {
        "random16": lambda: write_newick(random_tree(16, seed=4)),
        "multifurcating": lambda: MULTIFURCATING,
        "caterpillar12": lambda: "(" * 11 + "t0:0.3" + "".join(
            f",t{i}:0.3)" + (":0.3" if i < 11 else "") for i in range(1, 12))
        + ";",
    }[case]()
    sched = compile_schedule(tio.parse_newick(newick))
    walk = WalkSchedule(sched)
    rw = walk.slots.rows
    text = _build.static_topology_header(rw.edges, rw.eword, rw.n_rows,
                                         walk.n_nodes, walk.n_leaves, s,
                                         cuda_pruning._STATIC_CHUNK)
    ints, scalar = _header_arrays(text)
    edges, words = ints("kEdges"), ints("kEword").reshape(-1, 2)
    np.testing.assert_array_equal(edges, rw.edges)
    np.testing.assert_array_equal(words, rw.eword[:-1])
    assert scalar("kS") == s and scalar("kNEdges") == len(rw.edges)
    assert scalar("kNRows") == rw.n_rows
    assert scalar("kChunk") == cuda_pruning._STATIC_CHUNK
    assert (scalar("kNNodes"), scalar("kNLeaves")) == (sched.n_nodes,
                                                        sched.n_leaves)
    order, children, counts = jpp._postorder_arrays(
        j_compile_schedule(jio.parse_newick(newick)))
    node_of = {tuple(children[i, :counts[i]].tolist()): int(order[i])
               for i in range(len(order))}
    done, kids = [], []
    for child, (_, out) in zip(edges.tolist(), words.tolist()):
        assert child < sched.n_leaves or child in done   # children first
        kids.append(child)
        if out != -2:
            done.append(node_of.pop(tuple(kids)))
            kids = []
    assert not node_of and not kids and done[-1] == int(order[-1])
    assert sorted(done) == sorted(order.tolist())


# -- make_cuda_prune_fn against make_pallas_prune_fn -------------------------


CASES = {
    # tests/test_pallas_pruning.py:82-93, static on and off (16 taxa, 150)
    "static_off": dict(setup=lambda: _pallas_setup(16, 150), knob={}),
    "static_on": dict(setup=lambda: _pallas_setup(16, 150),
                      knob={"STATIC_UNROLL_MAX": 10 ** 6}),
    # :348-371, fold "auto" at 20 states with an odd K = 3 (8 taxa, 100)
    "fold_auto_k3": dict(
        setup=lambda: _pallas_setup(8, 100, n_states=20, ncat=3),
        knob={"PHYLO_FOLD_CATEGORIES": "auto"}),
    # tests/test_grouped_walk.py:123-140, the DNA pack (16 taxa, 260, K = 4)
    "pack": dict(setup=_grouped_setup, knob={"PHYLO_PACK_DNA": "1"}),
    # a codon width (61 states, 8 taxa, one 128-site tile): the static walk,
    # which precedes streaming there, and the fold of 2 with streaming off
    "static_on_s61": dict(setup=_codon_width_setup,
                          knob={"STATIC_UNROLL_MAX": 10 ** 6}),
    "fold_auto_s61": dict(setup=_codon_width_setup,
                          knob={"PHYLO_FOLD_CATEGORIES": "auto",
                                "PHYLO_FORCE_STREAM": "0"}),
}
LOWERING = {"static_off": "forward_walk_reference", "static_on": "static_walk",
            "fold_auto_k3": "fold_walk", "pack": "fold_walk",
            "static_on_s61": "static_walk", "fold_auto_s61": "fold_walk"}


def _set_knob(monkeypatch, knob):
    for name, value in knob.items():
        if name == "STATIC_UNROLL_MAX":
            monkeypatch.setattr(cuda_pruning, name, value)
            monkeypatch.setattr(jpp, name, value)
        else:
            monkeypatch.setenv(name, value)


def _loss_weights(s, sites, seed=3):
    rng = np.random.default_rng(seed)
    return rng.dirichlet(np.ones(s)), rng.uniform(0.5, 2.0, sites)


def test_built_library_keeps_its_compiler_output(monkeypatch, tmp_path):
    """A library taken from the build directory reports the compiler output
    of the build that made it (the ptxas lines the spill checks read), and
    is not built again."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    target = tmp_path / "libwalk.so"
    builds = []

    def compile_to(tmp):
        builds.append(tmp)
        tmp.write_bytes(b"library")
        return "ptxas info    : Used 40 registers, 0 bytes spill stores"

    log, built = _build._build_once(target, tmp_path / "lock", compile_to)
    assert built and "40 registers" in log
    assert target.read_bytes() == b"library"
    again, built_again = _build._build_once(target, tmp_path / "lock",
                                            compile_to)
    assert not built_again and again == log and len(builds) == 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_prune_fn_matches_pallas_prune_fn(monkeypatch, case):
    """Root partials and logscales against JAX's kernel pruner under the
    same knob and its XLA pruner, the port's lowering taken; then the VJP
    of a sitewise log-likelihood through the plain backward against
    ``jax.grad`` through the XLA pruner (``make_pallas_prune_fn``'s
    backward is ``jax.vjp`` of the XLA pruner on the same inputs, so its
    gradient is that one)."""
    newick, jsched, p, lp = CASES[case]["setup"]()
    _set_knob(monkeypatch, CASES[case]["knob"])
    jxla = j_make_prune_fn(jsched)
    r_xla, s_xla = jxla(jnp.asarray(p), jnp.asarray(lp))
    r_pal, s_pal = jpp.make_pallas_prune_fn(jsched)(jnp.asarray(p),
                                                    jnp.asarray(lp))
    calls = []
    _spy(monkeypatch, calls)
    prune = make_cuda_prune_fn(compile_schedule(tio.parse_newick(newick)))
    pt, lt = torch.from_numpy(p), torch.from_numpy(lp)
    r, sc = prune(pt, lt)
    assert calls[0] == LOWERING[case]
    assert r.dtype == torch.float32 and sc.dtype == torch.float64
    assert r.shape == r_pal.shape and sc.shape == s_pal.shape
    for want_r, want_s in ((r_pal, s_pal), (r_xla, s_xla)):
        np.testing.assert_allclose(r.numpy(), np.asarray(want_r),
                                   rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(sc.numpy(), np.asarray(want_s),
                                   rtol=2e-5, atol=2e-4)

    w_s, w_site = _loss_weights(p.shape[-1], lp.shape[1])

    def j_loss(pm):
        rr, ss = jxla(pm, jnp.asarray(lp))
        return jnp.sum(w_site * (jnp.log(rr @ w_s) + ss))

    g_want = np.asarray(jax.grad(j_loss)(jnp.asarray(p)))
    pg = pt.clone().requires_grad_(True)
    rr, ss = prune(pg, lt)
    loss = (torch.from_numpy(w_site) * (torch.log(rr.double()
            @ torch.from_numpy(w_s)) + ss)).sum()
    (g,) = torch.autograd.grad(loss, (pg,))
    np.testing.assert_allclose(g.numpy(), g_want, rtol=1e-4, atol=1e-4)


def test_cuda_prune_fn_replays_in_site_slices(monkeypatch):
    """Past ``_REPLAY_BYTES`` the backward replays the plain pruner over
    site slices; dP and the leaves' cotangent are the whole replay's up to
    the order of the site sums (float64 inputs: 1e-12)."""
    newick, _, p, lp = _pallas_setup(8, 50)
    prune = make_cuda_prune_fn(compile_schedule(tio.parse_newick(newick)))
    w_s, w_site = _loss_weights(4, 50)

    def grads():
        pg = torch.from_numpy(p).double().requires_grad_(True)
        lg = torch.from_numpy(lp).double().requires_grad_(True)
        rr, ss = prune(pg, lg)
        assert rr.dtype == torch.float64
        loss = (torch.from_numpy(w_site) * (torch.log(
            rr @ torch.from_numpy(w_s)) + ss)).sum()
        return torch.autograd.grad(loss, (pg, lg))

    whole = grads()
    monkeypatch.setattr(cuda_pruning, "_REPLAY_BYTES", 1)
    sliced = grads()
    for a, b in zip(sliced, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12)
    pg = torch.from_numpy(p).double().requires_grad_(True)
    rr, _ = prune(pg, torch.from_numpy(lp).double())
    with pytest.raises(RuntimeError, match="no second derivative"):
        (g,) = torch.autograd.grad(rr.sum(), (pg,), create_graph=True)


def test_engine_prune_under_cuda_pruner():
    """``pruner="cuda"`` gives the engine a ``_prune`` (the engines above
    ``LikelihoodEngine`` prune through it), as the JAX engine's
    ``pruner="pallas"`` does; ``pruner="torch"`` the plain one."""
    from phylo_utils_tpu_torch import models as tmodels
    from phylo_utils_tpu_torch.likelihood import LikelihoodEngine

    tree = random_tree(6, seed=1)
    aln = {n: "ACGTACGTAAGG" for n in tree.leaf_names}
    e = LikelihoodEngine(tree, aln, tmodels.GTR, ncat=2, device="cpu",
                         dtype=torch.float32, pruner="cuda")
    assert e._prune is not None and e._fused_ll is not None
    p = torch.rand((e.schedule.n_nodes, 2, 4, 4))
    r, s = e._prune(p, e._leaf_partials)
    assert r.shape == (2, e._leaf_partials.shape[1], 4)


# -- on the card --------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("s", [4, 20])
def test_static_and_fold_kernels_on_card(s):
    """B8 and B9 on the card: roots and exponent counts bit for bit the
    forward kernel's, single and batched, B8 at every compiled lane count
    and B9 at every compiled fold width x lane count, each with 0, 1 and
    all of the walk's rows in shared memory; a second B8 call on one
    topology builds nothing, and a step B8 was not compiled for is
    refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    newick, _, p, lp = _pallas_setup(16, 301, n_states=s, ncat=12)
    walk = _walk(newick)
    rows = walk.slots.rows.n_rows
    pd = torch.from_numpy(p).cuda()
    ld = torch.from_numpy(lp).cuda()
    for pp in (pd, torch.stack([pd, pd * 0.5]).contiguous()):
        want = forward_walk(pp, ld, walk, walk="classic")
        for lanes in cuda_pruning._ROW_LANES[s]:
            for smem_rows in sorted({0, 1, rows}):
                got = static_walk(pp, ld, walk, lanes=lanes,
                                  smem_rows=smem_rows)
                torch.cuda.synchronize()
                assert torch.equal(got[0], want[0]) and torch.equal(
                    got[1], want[1]), ("B8", lanes, smem_rows)
        n_built = len(_build.static_build_info())
        static_walk(pp, ld, walk)
        assert len(_build.static_build_info()) == n_built
        with pytest.raises(ValueError, match="step"):
            static_walk(pp, ld, walk, chunk=cuda_pruning._STATIC_CHUNK // 2)
        for fold in cuda_pruning.FOLD_WIDTHS[s]:
            k = 12 - 12 % fold
            sub = pp[..., :k, :, :].contiguous()
            ref = forward_walk(sub, ld, walk, walk="classic")
            for lanes in cuda_pruning.FOLD_WIDTHS[s][fold]:
                for smem_rows in sorted({0, 1, rows}):
                    got = fold_walk(sub, ld, walk, fold, lanes=lanes,
                                    smem_rows=smem_rows)
                    torch.cuda.synchronize()
                    assert torch.equal(got[0], ref[0]) and torch.equal(
                        got[1], ref[1]), ("B9", fold, lanes, smem_rows)
