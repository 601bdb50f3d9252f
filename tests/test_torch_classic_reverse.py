"""Port parity, the classic reverse walk (kernel B7's plain version,
``classic_reverse_walk_reference``): against the JAX package's classic
reverse (``_dynamic_bwd_kernel`` through ``make_pallas_loglik_fn`` under
``PHYLO_DEFERRED_VJP=0``, and ``_backward_call`` with two seeds; interpret
mode on the CPU) on the same numpy-made float32 P matrices and leaves; its
outside-vector slot schedule; the choice between the deferred and the
classic reverse; and the fused Function under both.

Tolerances: dP, dleaf and dfreqs to 1e-5 x max|g| against JAX (both are
float32 walks; dP sums over sites in another order); the deferred and the
classic reverse's plain versions to 1e-6 x max|g| (the same per-node
arithmetic).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_utils_tpu import io as jio
from phylo_utils_tpu.ops import pallas_pruning as jpp
from phylo_utils_tpu.trees import compile_schedule as j_compile_schedule
from phylo_utils_tpu_torch import io as tio
from phylo_utils_tpu_torch import models as tmodels
from phylo_utils_tpu_torch.ops import cuda_pruning
from phylo_utils_tpu_torch.ops.cuda_pruning import (
    WalkSchedule,
    choose_reverse,
    classic_reverse_scratch,
    classic_reverse_walk,
    classic_reverse_walk_reference,
    make_fused_loglik_fn,
    reverse_walk_reference,
    saveall_walk,
)
from phylo_utils_tpu_torch.ops.pmatrix import (
    extend_p_identity,
    transition_matrices,
)
from phylo_utils_tpu_torch.trees import compile_schedule, random_tree
from phylo_utils_tpu_torch.io import write_newick

from torch_threads import one_thread  # noqa: F401

GTR = {"rates": [1.2, 3.1, 0.7, 0.9, 4.2, 1.0],
       "freqs": [0.3, 0.2, 0.22, 0.28]}
RATES = np.array([0.1, 0.6, 1.2, 2.1])
SITES = 83
TOL = 1e-5

MULTIFURCATING = (
    "((a:0.1,b:0.2,c:0.05):0.1,(d:0.3,e:0.1,f:0.2,g:0.15):0.2,"
    "(h:0.1,(i:0.2,j:0.3):0.05):0.1,k:0.4,l:0.25);"
)


def _caterpillar(n, brlen):
    return "(" * (n - 1) + f"t0:{brlen}" + "".join(
        f",t{i}:{brlen})" + (f":{brlen}" if i < n - 1 else "")
        for i in range(1, n)) + ";"


CASES = {
    "multifurcating": (MULTIFURCATING, 4),
    "random12": (None, 4),
    "caterpillar40": (_caterpillar(40, 1.5), 4),
    "random8_lg": ("random8", 20),
    # 61 states (a codon width, padded to 64 by the port): JAX's whole-tree
    # _dynamic_bwd_kernel fits its VMEM budget at S_pad 64 at 6 taxa
    "random6_s61": ("random6", 61),
}


def _wide_node_newick(n_star=48, n_sub=48, seed=7):
    """A root with ``n_star`` leaf children on short branches (a polytomy
    of collapsed branches) beside a ``random_tree(n_sub)`` subtree: kept
    whole (``binarize=False``), a node wider than the deferred reverse's
    stage at 20 states."""
    rng = np.random.default_rng(seed)
    sub = write_newick(random_tree(n_sub, seed=seed)).strip().rstrip(";")
    star = ",".join(f"w{i}:{rng.uniform(0.002, 0.02):.4f}"
                    for i in range(n_star))
    return f"({star},{sub}:0.1);"


def _newick(case):
    text = CASES[case][0]
    if text is None:
        return write_newick(random_tree(12, seed=7))
    if text == "random8":
        return write_newick(random_tree(8, seed=3, mean_brlen=0.2))
    if text == "random6":
        return write_newick(random_tree(6, seed=3, mean_brlen=0.2))
    return text


def _inputs(newick, s, batch_scales=None, seed=0):
    """Numpy f32 P (GTR at 4 states, LG at 20, a seeded random reversible
    model at any other count), leaves with 5% all-ones rows, and the
    model's float64 frequencies."""
    tree = tio.parse_newick(newick)
    sched = compile_schedule(tree)
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, s, (tree.n_leaves, SITES))
    lp = np.eye(s, dtype=np.float32)[codes]
    lp[rng.random((tree.n_leaves, SITES)) < 0.05] = 1.0
    if s == 4:
        eig = tmodels.GTR.eigen(GTR)
    elif s == 20:
        eig = tmodels.LG.eigen()
    else:
        sym = rng.uniform(0.2, 2.0, (s, s))
        eig = tmodels.base.eigen_reversible(
            torch.from_numpy(sym + sym.T),
            torch.from_numpy(rng.dirichlet(np.full(s, 4.0))))
    lengths = np.asarray(tree.lengths)
    if batch_scales is not None:
        lengths = np.stack([lengths * b for b in batch_scales])
    t = torch.from_numpy(lengths[..., None] * RATES)
    p = extend_p_identity(transition_matrices(eig, t), sched.n_nodes)
    return sched, p.to(torch.float32).numpy(), lp, eig.freqs.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_classic_reverse_matches_pallas_classic_vjp(case, monkeypatch):
    """The fused Function under PHYLO_DEFERRED_VJP=0 (its backward runs
    ``classic_reverse_walk``, on CPU tensors the plain version) against
    ``jax.vjp`` of ``make_pallas_loglik_fn(..., diff_leaves=True)`` made
    under the same setting (its backward: ``_backward_call``)."""
    newick, s = _newick(case), CASES[case][1]
    sched, p, lp, freqs = _inputs(newick, s, seed=4)
    ct = np.random.default_rng(8).uniform(0.5, 2.0, (4, SITES))
    monkeypatch.setenv("PHYLO_DEFERRED_VJP", "0")
    calls = []
    real = cuda_pruning.classic_reverse_walk_reference

    def spy(*args, **kwargs):
        calls.append(args[5])
        return real(*args, **kwargs)

    monkeypatch.setattr(cuda_pruning, "classic_reverse_walk_reference", spy)
    pt = torch.from_numpy(p).double().requires_grad_(True)
    lt = torch.from_numpy(lp).requires_grad_(True)
    ft = torch.from_numpy(freqs).requires_grad_(True)
    ll = make_fused_loglik_fn(sched)(pt, lt, ft)
    got = torch.autograd.grad(ll, (pt, lt, ft), torch.from_numpy(ct))
    assert len(calls) == 1 and list(calls[0]) == [WalkSchedule(sched).root]
    jfn = jpp.make_pallas_loglik_fn(
        j_compile_schedule(jio.parse_newick(newick)), n_states=s,
        diff_leaves=True)
    _, vjp = jax.vjp(jax.jit(jfn), jnp.asarray(p), jnp.asarray(lp),
                     jnp.asarray(freqs))
    want = [np.asarray(g) for g in vjp(jnp.asarray(ct))]
    for name, g, w in zip(("dP", "dleaf", "dfreqs"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TOL * np.abs(w).max(), err_msg=name)


def _jax_residuals(newick, p, lp):
    """JAX ``_saveall_call`` (interpret mode): padded inputs and residuals
    in the kernel layout, plus the schedule arrays."""
    sched = j_compile_schedule(jio.parse_newick(newick))
    order, children, counts = jpp._postorder_arrays(sched)
    sites_pad = jpp._round_up(SITES, jpp.LANE)
    p_pad, lp_pad = jpp._pad_inputs(jnp.asarray(p), jnp.asarray(lp), 4, 8,
                                    SITES, sites_pad)
    k = p.shape[1]
    lp_k = jnp.broadcast_to(lp_pad[None], (k,) + lp_pad.shape)
    lsc_k = jnp.zeros((k, sched.n_leaves, 1, sites_pad), jnp.float32)
    common = dict(order=order, children=children, counts=counts,
                  n_nodes=sched.n_nodes, n_leaves=sched.n_leaves,
                  tile=16 * jpp.LANE, interpret=True)
    buf, ls = jpp._saveall_call(p_pad, lp_k, lsc_k, n_real=4, group=0,
                                **common)
    return p_pad, buf, ls, common


def test_two_seeds_match_backward_call():
    """Seeds at the root and at an internal node below it (their
    cotangents add up there) against ``_backward_call`` on the JAX
    package's own residuals, which the port reads in its layout."""
    newick = _newick("random12")
    sched, p, lp, _ = _inputs(newick, 4, seed=2)
    p_pad, buf, ls, common = _jax_residuals(newick, p, lp)
    n_leaves, k = sched.n_leaves, p.shape[1]
    walk = WalkSchedule(sched)
    seeds = [walk.root, int(walk.order[len(walk.order) // 2])]
    rng = np.random.default_rng(6)
    gseeds = rng.uniform(0.2, 1.5, (k, 2, SITES, 4)).astype(np.float32)
    gs_pad = np.zeros((k, 2, 8, buf.shape[-1]), np.float32)
    gs_pad[:, :, :4, :SITES] = np.swapaxes(gseeds, -1, -2)
    dp_pad, dleaf_k = jpp._backward_call(
        p_pad, jnp.swapaxes(p_pad, -1, -2), buf, ls, jnp.asarray(gs_pad),
        np.asarray(seeds, np.int32), n_real=4, **common)
    res_x = np.ascontiguousarray(np.swapaxes(
        np.asarray(buf)[:, n_leaves:, :4, :SITES], -1, -2))
    res_e = np.ascontiguousarray(np.asarray(ls)[:, n_leaves:, 0, :SITES])
    dp, dl = classic_reverse_walk(
        torch.from_numpy(p), torch.from_numpy(lp), torch.from_numpy(res_x),
        torch.from_numpy(res_e), torch.from_numpy(gseeds), seeds, walk,
        want_dleaf=True)
    want_dp = np.swapaxes(np.asarray(dp_pad)[:, :, :4, :4], 0, 1)
    want_dl = np.swapaxes(np.asarray(dleaf_k)[:, :, :4, :SITES], -1, -2)
    assert dp.shape == want_dp.shape and dl.shape == want_dl.shape
    for got, want in ((dp.numpy(), want_dp), (dl.numpy(), want_dl)):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TOL * np.abs(want).max())
    assert dp[walk.root].abs().max() == 0      # the root has no parent edge
    # a batch of two is two independent walks
    pb = torch.from_numpy(np.stack([p, p * 0.5]))
    rxb = torch.from_numpy(np.stack([res_x, res_x]))
    reb = torch.from_numpy(np.stack([res_e, res_e]))
    gb = torch.from_numpy(np.stack([gseeds, 2 * gseeds]))
    dpb, dlb = classic_reverse_walk_reference(
        pb, torch.from_numpy(lp), rxb, reb, gb, seeds, walk, want_dleaf=True)
    assert torch.equal(dpb[0], dp) and torch.equal(dlb[0], dl)


@pytest.mark.parametrize("case", ["multifurcating", "random12",
                                  "caterpillar40"])
def test_gslot_schedule_invariants(case):
    """The walk is a pre-order (the reverse of the DFS post-order); each
    internal non-root node's g is written once, by its parent, into a free
    slot, and read once, at its own visit, before that slot is written
    again; on the caterpillar the slots number at most depth x cmax + 1."""
    sched = compile_schedule(tio.parse_newick(_newick(case)))
    walk = WalkSchedule(sched)
    rs = walk.reverse
    post, _, cmax = cuda_pruning._dfs_postorder(sched)
    assert rs.rnode.tolist() == post[::-1]
    n_leaves = sched.n_leaves
    holder = {}                     # slot -> node whose g it holds
    written, read = set(), set()
    for i, node in enumerate(rs.rnode.tolist()):
        slot = int(rs.gslot[i])
        if node == walk.root:
            assert slot == -1
        else:
            assert node in written and node not in read
            assert holder.pop(slot) == node
            read.add(node)
        for c in range(int(rs.counts[i])):
            child, cs = int(rs.children[i, c]), int(rs.cslot[i, c])
            if child < n_leaves:
                assert cs == -1
                continue
            assert 0 <= cs < rs.n_gslots and cs not in holder
            holder[cs] = child
            written.add(child)
    assert not holder
    assert read == set(range(n_leaves, sched.n_nodes)) - {walk.root}
    if case == "caterpillar40":
        parent = {int(c): int(n) for n, kids in cuda_pruning._walk_nodes(walk)
                  for c in kids}

        def depth(n):
            d = 0
            while n in parent:
                n, d = parent[n], d + 1
            return d

        tree_depth = max(depth(n) for n in range(sched.n_nodes))
        assert rs.n_gslots <= tree_depth * cmax + 1
        assert rs.n_gslots <= 2         # a caterpillar keeps one g live


def test_choose_reverse_and_env_knob(monkeypatch):
    """PHYLO_DEFERRED_VJP: "0" classic, "1" deferred, else the rule: the
    deferred reverse while one batch element's share of its scratch
    (``reverse_scratch``: the g slots, (K, n_gslots, sites, S) float32,
    and one (n_nodes, S, S) dP row per block of sites) fits the device
    budget and its block holds a node's children; CPU tensors take the
    deferred reverse's plain version under "auto"."""
    budget = {"bytes": 0}
    monkeypatch.setattr(cuda_pruning, "_device_budget",
                        lambda need, device: budget["bytes"])
    # K = 4, 1000 taxa, LG, 8 g slots, 256-site blocks (313 per category)
    need = 4 * 4 * 8 * 80_000 * 20 + 4 * 4 * 313 * 1999 * 400
    monkeypatch.delenv("PHYLO_DEFERRED_VJP", raising=False)
    budget["bytes"] = need
    assert choose_reverse(1, 4, 1999, 8, 80_000, 20, "cuda", 2) == "deferred"
    assert choose_reverse(8, 4, 1999, 8, 80_000, 20, "cuda", 2) == "deferred"
    budget["bytes"] = need - 1
    assert choose_reverse(1, 4, 1999, 8, 80_000, 20, "cuda", 2) == "classic"
    assert choose_reverse(1, 4, 1999, 8, 80_000, 20, "cpu", 2) == "deferred"
    # at 4 states the rows are 16 floats a node per block: far smaller
    assert choose_reverse(1, 4, 1999, 8, 80_000, 4, "cuda", 2) == "deferred"
    # a node of 64 children at 20 states does not fit a block's stage
    budget["bytes"] = 10 * need
    assert choose_reverse(1, 4, 1999, 8, 80_000, 20, "cuda",
                          64) == "classic"
    budget["bytes"] = need - 1
    for env, want in (("0", "classic"), ("1", "deferred"),
                      ("auto", "classic")):
        monkeypatch.setenv("PHYLO_DEFERRED_VJP", env)
        assert choose_reverse(1, 4, 1999, 8, 80_000, 20, "cuda", 2) == want
    monkeypatch.setenv("PHYLO_DEFERRED_VJP", "0")
    assert choose_reverse(1, 4, 7, 2, 10, 4, "cpu", 2) == "classic"


@pytest.mark.parametrize("case,b,sites,s", [
    ("random12", 1, 1024, 4),
    ("random12", 64, 1024, 4),
    ("random12", 1, 8192, 20),
    ("random12", 2, 83, 20),
    ("multifurcating", 16, 1000, 20),
    ("caterpillar40", 4, 83, 4),
])
def test_reverse_scratch_and_row_sizing(case, b, sites, s):
    """B3's tile is the widest whose block's shared memory fits; its
    scratch is the g slots of ``walk.reverse`` plus one dP row per block,
    (b, K, ceil(sites / tile), n_nodes, S, S): S / tile of a gy store per
    whole tile of sites."""
    sched, *_ = _inputs(_newick(case), 4)
    walk = WalkSchedule(sched)
    n, g = walk.n_nodes, walk.reverse.n_gslots
    cmax = walk.children.shape[1]
    assert cuda_pruning.reverse_tile(s, cmax) == 256
    tile, nbytes = cuda_pruning.reverse_scratch(b, 4, n, g, sites, s, cmax)
    slots = 4 * b * 4 * max(g, 1) * sites * s
    rows = 4 * b * 4 * -(-sites // tile) * n * s * s
    assert tile == 256 and nbytes == slots + rows
    assert rows < 4 * b * 4 * n * sites * s     # the gy store it keeps not
    assert cuda_pruning._reverse_smem_bytes(tile, cmax, s) <= 232_448
    # seven children at 20 states: a 256-site block's stage would not fit
    assert cuda_pruning.reverse_tile(20, 7) == 128


@pytest.mark.parametrize("cmax", [2, 3, 8, 48, 200])
@pytest.mark.parametrize("s", [4, 20, 64])
def test_classic_reverse_stage_sizing(s, cmax):
    """B7's shared memory: the deferred reverse's block layout for the most
    children up to cmax that fit the stage's budget, itself within an SM's
    232,448 bytes; one more child would not fit, unless cmax is reached. A
    wider visit reads its P through L1 in groups of that many, so the block
    does not grow with cmax past them, and every child is covered in
    ceil(cmax / children) groups. At 64 states the block is B3's tiled
    one (64 columns; a ring of two stages of the children's P blocks and
    x tiles, rows 68 floats apart, then two gy tiles up to two children
    and one past them), which holds 3 children."""
    children, nbytes = cuda_pruning.classic_reverse_stage(s, cmax)
    tile = cuda_pruning._classic_reverse_tile(s)
    assert tile == (64 if s == 64 else cuda_pruning._CLASSIC_REVERSE_TILE)
    if s == 64:
        assert children == min(cmax, 3)
        assert nbytes == 4 * 64 * 68 * (4 * children
                                         + (2 if children <= 2 else 1))
    budget = cuda_pruning._CLASSIC_STAGE_BYTES
    assert budget <= 232_448
    assert 1 <= children <= cmax
    assert nbytes == cuda_pruning._reverse_smem_bytes(tile, children, s)
    assert nbytes <= budget
    if children < cmax:
        assert cuda_pruning._reverse_smem_bytes(tile, children + 1,
                                                s) > budget
    groups = -(-cmax // children)
    assert (groups - 1) * children < cmax <= groups * children
    widest = cuda_pruning.classic_reverse_stage(s, 10 ** 6)
    assert nbytes <= widest[1]
    if cmax >= widest[0]:
        assert (children, nbytes) == widest


def test_choose_reverse_takes_classic_for_a_wide_protein_node(monkeypatch):
    """A node of 48 children at 20 states does not fit the deferred
    reverse's stage at any block width, so "auto" takes the classic
    reverse before it reads the device's memory; at 4 states the deferred
    one holds it."""
    def no_memory_read(need, device):
        raise AssertionError("choose_reverse read the device's memory")

    monkeypatch.setattr(cuda_pruning, "_device_budget", no_memory_read)
    monkeypatch.delenv("PHYLO_DEFERRED_VJP", raising=False)
    with pytest.raises(ValueError, match="48 children"):
        cuda_pruning.reverse_tile(20, 48)
    assert choose_reverse(1, 4, 191, 3, 8192, 20, "cuda", 48) == "classic"
    assert cuda_pruning.reverse_tile(4, 48) == 256


def _wide_node_inputs(newick, s, sites, seed=11):
    """The tree with its multifurcations kept (``binarize=False``): its
    schedule, f32 P (GTR at 4 states, LG at 20), one-hot f32 leaves of
    ``sites`` sites evolved down it (each in one category, so a polytomy's
    leaves agree as real ones do: random leaves under a root of 49 children
    underflow its f32 product before its rescale) and the model's float64
    frequencies."""
    tree = tio.parse_newick(newick)
    sched = compile_schedule(tree, binarize=False)
    rng = np.random.default_rng(seed)
    if s == 4:
        eig = tmodels.GTR.eigen(GTR)
    elif s == 20:
        eig = tmodels.LG.eigen()
    else:
        sym = rng.uniform(0.2, 2.0, (s, s))
        eig = tmodels.base.eigen_reversible(
            torch.from_numpy(sym + sym.T),
            torch.from_numpy(rng.dirichlet(np.full(s, 4.0))))
    t = torch.from_numpy(np.asarray(tree.lengths)[:, None] * RATES)
    p64 = transition_matrices(eig, t).numpy()
    freqs = eig.freqs.numpy()
    cat = rng.integers(0, len(RATES), sites)
    states = np.zeros((tree.n_nodes, sites), np.int64)
    states[tree.root] = rng.choice(s, sites, p=freqs / freqs.sum())
    for node in range(tree.n_nodes - 1, -1, -1):     # ids are post-order
        for child in tree.children[node]:
            cum = np.cumsum(p64[child, cat, states[node]], axis=1)
            states[child] = (rng.random(sites)[:, None] * cum[:, -1:]
                             > cum).sum(axis=1)
    lp = np.eye(s, dtype=np.float32)[states[:tree.n_leaves]]
    return sched, p64.astype(np.float32), lp, freqs


@pytest.mark.parametrize("s", [4, 20])
def test_wide_node_walks_match_jax_pruner(s, monkeypatch):
    """The wide-node tree with its root of 49 children kept
    (``binarize=False``), 64 patterns simulated down it: the fused
    Function under PHYLO_DEFERRED_VJP=0, whose forward runs the saveall
    walk's plain version and whose backward the classic reverse's, against
    the JAX package's f64 plain pruner (``ops.pruning.make_prune_fn``) and
    its autograd on the same P, leaves and frequencies: log-likelihoods to
    1e-6 relative, dP, dleaf and dfreqs to 5e-4 x their max (an f32 walk
    against f64)."""
    from phylo_utils_tpu.ops.pruning import make_prune_fn as j_make_prune_fn

    newick = _wide_node_newick()
    sched, p32, lp, freqs = _wide_node_inputs(newick, s, 64)
    assert sched.n_children_max == 49
    rng = np.random.default_rng(12)
    calls = {"saveall_walk_reference": 0,
             "classic_reverse_walk_reference": 0}
    for name in calls:
        real = getattr(cuda_pruning, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(cuda_pruning, name, spy)
    monkeypatch.setenv("PHYLO_DEFERRED_VJP", "0")
    pt = torch.from_numpy(p32).requires_grad_(True)
    lt = torch.from_numpy(lp).requires_grad_(True)
    ft = torch.from_numpy(freqs).requires_grad_(True)
    ll = make_fused_loglik_fn(sched)(pt, lt, ft)
    ct = torch.from_numpy(rng.uniform(0.5, 2.0, (4, 64)))
    got = torch.autograd.grad(ll, (pt, lt, ft), ct)
    assert calls == {"saveall_walk_reference": 1,
                     "classic_reverse_walk_reference": 1}
    prune = j_make_prune_fn(j_compile_schedule(jio.parse_newick(newick),
                                               binarize=False))

    @jax.jit
    def jll(p, l, f):
        root, scale = prune(p, l)
        return jnp.log(root @ f) + scale

    args = (jnp.asarray(p32, jnp.float64), jnp.asarray(lp, jnp.float64),
            jnp.asarray(freqs))
    want_ll, vjp = jax.vjp(jll, *args)
    np.testing.assert_allclose(ll.detach().numpy(), np.asarray(want_ll),
                               rtol=1e-6, atol=0)
    for name, g, w in zip(("dP", "dleaf", "dfreqs"), got,
                          vjp(jnp.asarray(ct.numpy()))):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0,
                                   atol=5e-4 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("batch", [None, (0.5, 1.0, 3.0)])
def test_fused_gradients_equal_under_both_reverses(batch, monkeypatch):
    """The fused Function's (dP, dleaf, dfreqs) with the deferred and with
    the classic reverse (plain versions on the CPU), single and batched."""
    newick = _newick("caterpillar40")
    sched, p, lp, freqs = _inputs(newick, 4, batch_scales=batch, seed=5)
    ct = torch.from_numpy(np.random.default_rng(3).uniform(
        0.5, 2.0, p.shape[:-4] + (4, SITES)))
    grads = {}
    for env in ("1", "0"):
        monkeypatch.setenv("PHYLO_DEFERRED_VJP", env)
        pt = torch.from_numpy(p).requires_grad_(True)
        lt = torch.from_numpy(lp).requires_grad_(True)
        ft = torch.from_numpy(freqs).requires_grad_(True)
        ll = make_fused_loglik_fn(sched)(pt, lt, ft)
        grads[env] = torch.autograd.grad(ll, (pt, lt, ft), ct)
    for name, d, c in zip(("dP", "dleaf", "dfreqs"), grads["1"], grads["0"]):
        np.testing.assert_allclose(c.numpy(), d.numpy(), rtol=0,
                                   atol=1e-6 * d.abs().max().item(),
                                   err_msg=name)


def test_classic_matches_deferred_reference_bit_for_bit():
    """One seed at the root with gseed = lambda pi: the classic and the
    deferred plain walks do the same per-node arithmetic."""
    sched, p, lp, freqs = _inputs(_newick("multifurcating"), 4, seed=1)
    walk = WalkSchedule(sched)
    pt, lt = torch.from_numpy(p), torch.from_numpy(lp)
    rx, re = saveall_walk(pt, lt, walk)
    row = walk.root - walk.n_leaves
    lam = (1.0 / torch.einsum("ksi,i->ks", rx[:, row].double(),
                              torch.from_numpy(freqs))).float()
    f32 = torch.from_numpy(freqs).float()
    gseed = (lam[..., None] * f32).unsqueeze(-3).contiguous()
    d7, l7 = classic_reverse_walk_reference(pt, lt, rx, re, gseed,
                                            [walk.root], walk, True)
    d3, l3 = reverse_walk_reference(pt, lt, rx, re, lam, f32, walk, True)
    assert torch.equal(d7, d3) and torch.equal(l7, l3)


def test_classic_reverse_walk_rejects_bad_inputs():
    sched, p, lp, _ = _inputs(MULTIFURCATING, 4)
    walk = WalkSchedule(sched)
    pt, lt = torch.from_numpy(p), torch.from_numpy(lp)
    rx, re = saveall_walk(pt, lt, walk)
    g = torch.ones((4, 1, SITES, 4))
    for seeds in ([], [walk.root, walk.root], [-1], [sched.n_nodes]):
        with pytest.raises(ValueError, match="seed_ids"):
            classic_reverse_walk(pt, lt, rx, re, g, seeds, walk)
    with pytest.raises(ValueError, match="gseeds"):
        classic_reverse_walk(pt, lt, rx, re, g, [walk.root, 0], walk)
    with pytest.raises(NotImplementedError, match="make_fused_loglik_fn"):
        classic_reverse_walk(pt, lt, rx, re, g.requires_grad_(True),
                             [walk.root], walk)


def test_classic_scratch_does_not_grow_with_the_tree_times_sites(
        monkeypatch):
    """B7's scratch: g slots (B, K, n_gslots, sites, S) and dP rows capped
    by the launch's blocks, so it grows with depth x sites and n_nodes,
    never with n_nodes x sites; the launch takes fewer rows where only
    that many fit, and raises where not even one does."""
    rows, slot_bytes, row_bytes = classic_reverse_scratch(
        1, 4, 1999, 8, 80_000, 20)
    assert rows == 66 and slot_bytes == 4 * 4 * 8 * 80_000 * 20
    assert row_bytes == 4 * 4 * 1999 * 400
    rows2, slot2, _ = classic_reverse_scratch(1, 4, 1999, 8, 800_000, 20)
    assert rows2 == rows and slot2 == 10 * slot_bytes
    assert classic_reverse_scratch(1, 4, 1999, 8, 100, 20)[0] == 1
    gy = 4 * 4 * 1999 * 80_000 * 20
    assert slot_bytes + rows * row_bytes < gy / 30
    budget = {"bytes": slot_bytes + 10 * row_bytes}
    monkeypatch.setattr(cuda_pruning, "_device_budget",
                        lambda need, device: budget["bytes"])
    assert cuda_pruning._classic_rows(1, 4, 1999, 8, 80_000, 20,
                                      "cuda") == 10
    budget["bytes"] = slot_bytes + row_bytes - 1
    with pytest.raises(MemoryError, match="classic reverse"):
        cuda_pruning._classic_rows(1, 4, 1999, 8, 80_000, 20, "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("s", [4, 20, 64])
def test_classic_kernel_takes_a_wide_node_on_card(s):
    """B7 on the wide-node tree (a root of 49 children: staged at 4
    states, read through L1 in groups at 20 and at 64, a small codon
    shape of 61 states padded) against its plain version, two seeds with
    dleaf; dP bit-identical across two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    sched, p, lp, _ = _wide_node_inputs(_wide_node_newick(),
                                        61 if s == 64 else s, SITES)
    walk = WalkSchedule(sched)
    assert walk.children.shape[1] == 49
    pd, ld = torch.from_numpy(p).cuda(), torch.from_numpy(lp).cuda()
    if s == 64:
        pd = cuda_pruning._pad_states(pd, s, 2).contiguous()
        ld = cuda_pruning._pad_states(ld, s, 1).contiguous()
    rx, re = saveall_walk(pd, ld, walk)
    g = torch.rand((4, 2, SITES, s), device="cuda") + 0.5
    seeds = [walk.root, int(walk.order[len(walk.order) // 2])]
    dp, dl = classic_reverse_walk(pd, ld, rx, re, g, seeds, walk, True)
    dp2, _ = classic_reverse_walk(pd, ld, rx, re, g, seeds, walk)
    torch.cuda.synchronize()
    assert torch.equal(dp, dp2)
    wp, wl = classic_reverse_walk_reference(pd, ld, rx, re, g, seeds, walk,
                                            True)
    for got, ref in ((dp, wp), (dl, wl)):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=0, atol=1e-4 * ref.abs().max().item())


@pytest.mark.gpu
def test_classic_kernel_matches_reference_on_card():
    """B7 against its plain version on the card, one and two seeds, with
    and without dleaf; dP bit-identical across two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    sched, p, lp, freqs = _inputs(_newick("caterpillar40"), 4,
                                  batch_scales=(0.5, 1.0, 3.0))
    walk = WalkSchedule(sched)
    pd, ld = torch.from_numpy(p).cuda(), torch.from_numpy(lp).cuda()
    rx, re = saveall_walk(pd, ld, walk)
    g = torch.rand((3, 4, 2, SITES, 4), device="cuda") + 0.5
    seeds = [walk.root, int(walk.order[len(walk.order) // 2])]
    before = cuda_pruning.CLASSIC_REVERSE_LAUNCHES
    dp, dl = classic_reverse_walk(pd, ld, rx, re, g, seeds, walk, True)
    dp2, none = classic_reverse_walk(pd, ld, rx, re, g, seeds, walk)
    torch.cuda.synchronize()
    assert cuda_pruning.CLASSIC_REVERSE_LAUNCHES == before + 2
    assert torch.equal(dp, dp2) and none is None
    wp, wl = classic_reverse_walk_reference(pd, ld, rx, re, g, seeds, walk,
                                            True)
    for got, ref in ((dp, wp), (dl, wl)):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=0, atol=1e-4 * ref.abs().max().item())
