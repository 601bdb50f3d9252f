"""Port parity, pruning walk: ``phylo_utils_tpu_torch.ops.cuda_pruning``
against the JAX package's Pallas pruner (interpret mode on the CPU) on the
same numpy-made P matrices and leaf partials, in float32.

Tolerances: the root per-site log-likelihood log(pi . x_root) + e ln2 agrees
to 1e-5 absolute. Both walks do the same f32 contraction and the same exact
power-of-two rescale, but the contraction's summation order differs, so a
node's exponent may flip by one at a power-of-two boundary with its
partials scaled to compensate: compare the log-likelihood, or x 2^e, not e
alone. The saveall residuals agree as x 2^e to 1e-5 relative per node. The
gradient (dP, dleaf, dfreqs of the fused logL) agrees to 1e-4 x max|g|:
both are f32 walks, and dP sums over sites in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_utils_tpu import io as jio
from phylo_utils_tpu.ops import pallas_pruning as jpp
from phylo_utils_tpu.ops.pallas_pruning import make_pallas_prune_fn
from phylo_utils_tpu.trees import compile_schedule as j_compile_schedule
from phylo_utils_tpu_torch import io as tio
from phylo_utils_tpu_torch import models as tmodels
from phylo_utils_tpu_torch.ops import _build, cuda_pruning
from phylo_utils_tpu_torch.ops.cuda_pruning import (
    WalkSchedule,
    forward_walk,
    forward_walk_reference,
    make_fused_loglik_fn,
    reverse_walk,
    reverse_walk_reference,
    saveall_walk,
    saveall_walk_reference,
)
from phylo_utils_tpu_torch.ops.pmatrix import (
    extend_p_identity,
    transition_matrices,
)
from phylo_utils_tpu_torch.ops.pruning import LN2, make_prune_fn
from phylo_utils_tpu_torch.trees import compile_schedule, random_tree
from phylo_utils_tpu_torch.io import write_newick

FREQS = np.array([0.3, 0.2, 0.22, 0.28])
GTR = {"rates": [1.2, 3.1, 0.7, 0.9, 4.2, 1.0], "freqs": list(FREQS)}
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


def _inputs(newick, batch_scales=None, seed=0):
    """Same numpy P (f32) and leaves for both packages."""
    tree = tio.parse_newick(newick)
    sched = compile_schedule(tree)
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (tree.n_leaves, SITES))
    lp = np.eye(4, dtype=np.float32)[codes]
    lp[rng.random((tree.n_leaves, SITES)) < 0.05] = 1.0      # gaps / N
    eig = tmodels.GTR.eigen(GTR)
    lengths = np.asarray(tree.lengths)
    if batch_scales is not None:
        lengths = np.stack([lengths * s for s in batch_scales])
    t = torch.from_numpy(lengths[..., None] * RATES)
    p = extend_p_identity(transition_matrices(eig, t), sched.n_nodes)
    return tree, sched, p.to(torch.float32).numpy(), lp


def _site_ll_port(root_p, root_e):
    return (np.log(root_p.double().numpy() @ FREQS)
            + root_e.double().numpy() * LN2)


def _site_ll_jax(newick, p, lp):
    sched = j_compile_schedule(jio.parse_newick(newick))
    prune = make_pallas_prune_fn(sched)
    r, s = prune(jnp.asarray(p), jnp.asarray(lp))
    return np.log(np.asarray(r, np.float64) @ FREQS) + np.asarray(s, np.float64)


CASES = {
    "multifurcating": MULTIFURCATING,
    "random12": None,
    "caterpillar40": _caterpillar(40, 1.5),
}


def _newick(case):
    text = CASES[case]
    return text if text is not None else write_newick(random_tree(12, seed=7))


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_walk_matches_pallas(case):
    newick = _newick(case)
    tree, sched, p, lp = _inputs(newick)
    walk = WalkSchedule(sched)
    root_p, root_e = forward_walk(torch.from_numpy(p), torch.from_numpy(lp),
                                  walk)
    assert root_p.shape == (4, SITES, 4) and root_e.shape == (4, SITES)
    assert root_p.dtype == torch.float32 and root_e.dtype == torch.float32
    got = _site_ll_port(root_p, root_e)
    want = _site_ll_jax(newick, p, lp)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    if case == "caterpillar40":
        assert root_e.min() < -60     # the deep walk really rescaled


def test_forward_walk_batched_matches_pallas():
    newick = _newick("random12")
    tree, sched, p, lp = _inputs(newick, batch_scales=(0.5, 1.0, 3.0))
    root_p, root_e = forward_walk(torch.from_numpy(p), torch.from_numpy(lp),
                                  WalkSchedule(sched))
    assert root_p.shape == (3, 4, SITES, 4) and root_e.shape == (3, 4, SITES)
    got = _site_ll_port(root_p, root_e)
    for b in range(3):
        np.testing.assert_allclose(got[b], _site_ll_jax(newick, p[b], lp),
                                   rtol=0, atol=TOL, err_msg=f"batch {b}")


def test_forward_walk_matches_torch_pruner():
    """The walk and the level-batched plain pruner are the same math."""
    newick = _caterpillar(40, 1.5)
    tree, sched, p, lp = _inputs(newick, seed=3)
    root_p, root_e = forward_walk_reference(
        torch.from_numpy(p), torch.from_numpy(lp), WalkSchedule(sched))
    r, s = make_prune_fn(sched)(torch.from_numpy(p), torch.from_numpy(lp))
    want = np.log(r.double().numpy() @ FREQS) + s.double().numpy()
    np.testing.assert_allclose(_site_ll_port(root_p, root_e), want,
                               rtol=0, atol=TOL)


def test_fused_loglik_on_cpu_counts_no_launch():
    tree, sched, p, lp = _inputs(MULTIFURCATING)
    before = cuda_pruning.LAUNCHES
    ll = make_fused_loglik_fn(sched)(
        torch.from_numpy(p), torch.from_numpy(lp),
        torch.from_numpy(FREQS))
    assert ll.dtype == torch.float64 and ll.shape == (4, SITES)
    np.testing.assert_allclose(ll.numpy(), _site_ll_jax(MULTIFURCATING, p, lp),
                               rtol=0, atol=TOL)
    assert cuda_pruning.LAUNCHES == before   # CPU tensors take the plain walk


def test_forward_walk_rejects_bad_inputs():
    tree, sched, p, lp = _inputs(MULTIFURCATING)
    walk = WalkSchedule(sched)
    pt, lt = torch.from_numpy(p), torch.from_numpy(lp)
    with pytest.raises(TypeError):
        forward_walk(pt.double(), lt, walk)
    with pytest.raises(ValueError):
        forward_walk(pt[:-1], lt, walk)
    with pytest.raises(ValueError):
        forward_walk(pt, lt[:-1], walk)
    # the walks are not autograd functions: gradients go through
    # make_fused_loglik_fn (saveall forward, reverse backward)
    with pytest.raises(NotImplementedError, match="make_fused_loglik_fn"):
        forward_walk(pt.clone().requires_grad_(True), lt, walk)
    with pytest.raises(NotImplementedError, match="make_fused_loglik_fn"):
        saveall_walk(pt, lt.clone().requires_grad_(True), walk)
    with torch.no_grad():       # a value call with grad mode off is fine
        forward_walk(pt.clone().requires_grad_(True), lt, walk)
    rx, re = saveall_walk(pt, lt, walk)
    lam = torch.ones(pt.shape[1], SITES)
    with pytest.raises(ValueError, match="lam"):
        reverse_walk(pt, lt, rx, re, lam[:, :-1], torch.ones(4), walk)
    with pytest.raises(TypeError, match="freqs"):
        reverse_walk(pt, lt, rx, re, lam, torch.ones(4).double(), walk)


@pytest.mark.parametrize("entry", [s[0] for s in _build.SIGNATURES])
def test_bindings_match_c_signatures(entry):
    """``_build.SIGNATURES`` (the ctypes argument types) against the
    ``extern "C"`` signature in csrc/: as many pointers and ints, in that
    order, then the stream. ctypes cannot check a call's arity against the
    library, so a mismatch would show only on the card."""
    import re

    _, n_ptr, n_int = next(s for s in _build.SIGNATURES if s[0] == entry)
    src = "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    assert m, entry
    kinds = ["ptr" if "*" in a else "int" for a in m.group(1).split(",")]
    assert kinds == ["ptr"] * n_ptr + ["int"] * n_int + ["ptr"]


@pytest.mark.parametrize("cmax", [2, 3, 8, 48, 200])
@pytest.mark.parametrize("s", [4, 20, 64])
def test_saveall_stage_sizing(s, cmax):
    """B2's shared memory on a star of ``cmax`` leaves beside a 12-taxon
    tree: a ring of three steps, each the S x S blocks of ``chunk``
    consecutive edges of the walk, whatever node they belong to. It fits an
    SM's 232,448 bytes, ceil(n_edges / chunk) steps cover every edge, the
    edges are each node's children in walk order, and the ring does not
    grow with the widest node."""
    star = ",".join(f"w{i}:0.1" for i in range(cmax - 1))
    sub = _newick("random12").strip().rstrip(";")
    sched = compile_schedule(tio.parse_newick(f"({star},{sub}:0.1);"),
                             binarize=False)
    walk = WalkSchedule(sched)
    assert walk.children.shape[1] == max(cmax, 2)
    assert walk.edges.tolist() == [
        c for kids, n in zip(walk.children.tolist(), walk.counts.tolist())
        for c in kids[:n]]
    n_edges = len(walk.edges)
    chunk, nbytes = cuda_pruning.saveall_stage(s, n_edges)
    assert 1 <= chunk <= n_edges
    # rows of a staged P block are 68 floats apart at 64 states
    assert nbytes == 4 * 3 * chunk * s * (68 if s == 64 else s) <= 232_448
    steps = -(-n_edges // chunk)
    assert (steps - 1) * chunk < n_edges <= steps * chunk
    assert cuda_pruning.saveall_stage(s, 10 ** 6) == cuda_pruning.saveall_stage(
        s, 10 ** 7)
    assert nbytes <= cuda_pruning.saveall_stage(s, 10 ** 6)[1]


def _jax_saveall(newick, p, lp, group):
    """JAX ``_saveall_call`` (interpret mode) on the same inputs, sliced to
    the real states, sites and nodes: (K, n_nodes, S, sites) partials and
    (K, n_nodes, sites) exponent counts."""
    sched = j_compile_schedule(jio.parse_newick(newick))
    order, children, counts = jpp._postorder_arrays(sched)
    sites = lp.shape[1]
    sites_pad = jpp._round_up(sites, jpp.LANE)
    p_pad, lp_pad = jpp._pad_inputs(jnp.asarray(p), jnp.asarray(lp), 4, 8,
                                    sites, sites_pad)
    k = p.shape[1]
    lp_k = jnp.broadcast_to(lp_pad[None], (k,) + lp_pad.shape)
    lsc_k = jnp.zeros((k, sched.n_leaves, 1, sites_pad), jnp.float32)
    buf, ls = jpp._saveall_call(
        p_pad, lp_k, lsc_k, order=order, children=children, counts=counts,
        n_nodes=sched.n_nodes, n_leaves=sched.n_leaves, tile=16 * jpp.LANE,
        interpret=True, n_real=4, group=group)
    n = sched.n_nodes
    return (np.asarray(buf)[:, :n, :4, :sites],
            np.asarray(ls)[:, :n, 0, :sites])


@pytest.mark.parametrize("case,group", [
    ("multifurcating", 0), ("random12", 0), ("random12", 4),
    ("caterpillar40", 0)])
def test_saveall_reference_matches_pallas_saveall(case, group):
    """Every internal node's residual, as x 2^e, against the JAX saveall
    kernel (serial and grouped walks); the root row is bit-identical to
    the forward walk's root."""
    newick = _newick(case)
    tree, sched, p, lp = _inputs(newick)
    walk = WalkSchedule(sched)
    rx, re = saveall_walk(torch.from_numpy(p), torch.from_numpy(lp), walk)
    n_inner = sched.n_nodes - sched.n_leaves
    assert rx.shape == (4, n_inner, SITES, 4) and re.shape == (4, n_inner,
                                                                SITES)
    jx, je = _jax_saveall(newick, p, lp, group)
    got = rx.double().numpy() * np.exp2(re.double().numpy())[..., None]
    want = (np.transpose(jx[:, sched.n_leaves:], (0, 1, 3, 2))
            * np.exp2(je[:, sched.n_leaves:])[..., None])
    scale = np.abs(want).max(axis=-1, keepdims=True)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-5)
    root_p, root_e = forward_walk(torch.from_numpy(p), torch.from_numpy(lp),
                                  walk)
    row = walk.root - walk.n_leaves
    assert torch.equal(rx[:, row], root_p) and torch.equal(re[:, row], root_e)


def _jax_vjp(newick, p, lp, freqs, ct):
    """(dP, dleaf, dfreqs) of the JAX fused logL (Pallas saveall + deferred
    reverse, interpret mode) for cotangent ``ct``; a leading batch axis of
    ``p`` and ``ct`` goes through ``jax.vmap`` (leaves and freqs shared)."""
    sched = j_compile_schedule(jio.parse_newick(newick))
    fn = jpp.make_pallas_loglik_fn(sched, n_states=4, diff_leaves=True)
    if p.ndim == 5:
        fn = jax.vmap(fn, in_axes=(0, None, None))
    _, vjp = jax.vjp(fn, jnp.asarray(p), jnp.asarray(lp), jnp.asarray(freqs))
    return [np.asarray(g) for g in vjp(jnp.asarray(ct))]


@pytest.mark.parametrize("case,batch", [
    ("multifurcating", None), ("random12", None), ("caterpillar40", None),
    ("random12", (0.5, 1.0, 3.0))])
def test_fused_loglik_vjp_matches_pallas(case, batch):
    """The fused Function's (dP, dleaf, dfreqs) against ``jax.vjp`` of
    ``make_pallas_loglik_fn(..., diff_leaves=True)``, single and batched;
    on CPU tensors it runs the saveall and reverse walks' plain versions
    and launches nothing."""
    newick = _newick(case)
    tree, sched, p, lp = _inputs(newick, batch_scales=batch, seed=4)
    rng = np.random.default_rng(8)
    ct = rng.uniform(0.5, 2.0, p.shape[:-4] + (4, SITES))
    pt = torch.from_numpy(p).double().requires_grad_(True)
    lt = torch.from_numpy(lp).requires_grad_(True)
    ft = torch.from_numpy(FREQS).requires_grad_(True)
    before = (cuda_pruning.LAUNCHES, cuda_pruning.SAVEALL_LAUNCHES,
              cuda_pruning.REVERSE_LAUNCHES)
    ll = make_fused_loglik_fn(sched)(pt, lt, ft)
    assert ll.dtype == torch.float64 and ll.shape == ct.shape
    dp, dl, df = torch.autograd.grad(ll, (pt, lt, ft),
                                     torch.from_numpy(ct))
    assert before == (cuda_pruning.LAUNCHES, cuda_pruning.SAVEALL_LAUNCHES,
                      cuda_pruning.REVERSE_LAUNCHES)
    want = _jax_vjp(newick, p, lp, FREQS, ct)
    for name, got, ref in zip(("dP", "dleaf", "dfreqs"), (dp, dl, df), want):
        assert got.shape == ref.shape, name
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


def test_fused_loglik_freqs_only_grad_runs_forward_walk(monkeypatch):
    """With only freqs requiring grad the Function walks forward alone (no
    residuals, no reverse walk); dfreqs matches ``jax.vjp`` to 1e-4 x
    max|g|."""
    newick = _newick("random12")
    tree, sched, p, lp = _inputs(newick, seed=4)
    ct = np.random.default_rng(8).uniform(0.5, 2.0, (4, SITES))
    fn = make_fused_loglik_fn(sched)

    def no_residuals(*args, **kwargs):
        raise AssertionError("saveall/reverse walk ran for a freqs-only grad")

    monkeypatch.setattr(cuda_pruning, "saveall_walk", no_residuals)
    monkeypatch.setattr(cuda_pruning, "reverse_walk", no_residuals)
    ft = torch.from_numpy(FREQS).requires_grad_(True)
    ll = fn(torch.from_numpy(p), torch.from_numpy(lp), ft)
    (df,) = torch.autograd.grad(ll, (ft,), torch.from_numpy(ct))
    want = _jax_vjp(newick, p, lp, FREQS, ct)[2]
    np.testing.assert_allclose(df.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_reverse_walk_reference_matches_autograd():
    """The explicit pre-order walk (no autograd) against torch autograd
    through a float64 plain forward walk on the same float32-valued
    inputs: dP and dleaf to 1e-5 x max|g| (the reference walks in
    float32)."""
    newick = _caterpillar(40, 1.5)
    tree, sched, p, lp = _inputs(newick, batch_scales=(0.7, 1.3), seed=5)
    walk = WalkSchedule(sched)
    pt, lt = torch.from_numpy(p), torch.from_numpy(lp)
    rx, re = saveall_walk(pt, lt, walk)
    row = walk.root - walk.n_leaves
    freqs = torch.from_numpy(FREQS)
    dot = torch.einsum("bksi,i->bks", rx[:, :, row].double(), freqs)
    lam = (1.0 / dot).float()
    dp, dl = reverse_walk_reference(pt, lt, rx, re, lam, freqs.float(), walk,
                                    want_dleaf=True)
    # autograd of sum log(pi . x_root) through an f64 plain walk, rescale
    # held constant (exact: logL does not depend on it)
    p64 = pt.double().requires_grad_(True)
    l64 = lt.double().requires_grad_(True)
    x = {}
    for node, kids in cuda_pruning._walk_nodes(walk):
        acc = None
        for c in kids:
            xc = l64[c] if c < walk.n_leaves else x[c]
            eq = "bkij,sj->bksi" if c < walk.n_leaves else "bkij,bksj->bksi"
            y = torch.einsum(eq, p64[:, c], xc)
            acc = y if acc is None else acc * y
        x[node] = acc / acc.detach().amax(dim=-1, keepdim=True)
    total = torch.log(torch.einsum("bksi,i->bks", x[walk.root], freqs)).sum()
    gp, gl = torch.autograd.grad(total, (p64, l64))
    np.testing.assert_allclose(dp.double().numpy(), gp.numpy(), rtol=0,
                               atol=1e-5 * gp.abs().max().item())
    np.testing.assert_allclose(dl.double().sum(dim=(0, 1)).numpy(),
                               gl.numpy(), rtol=0,
                               atol=1e-5 * gl.abs().max().item())
    assert dp[:, walk.root].abs().max() == 0


@pytest.mark.gpu
def test_kernel_matches_reference_on_card():
    """The CUDA kernel against its plain version, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    newick = _caterpillar(40, 1.5)
    tree, sched, p, lp = _inputs(newick, batch_scales=(0.5, 1.0, 3.0))
    walk = WalkSchedule(sched)
    pd, ld = torch.from_numpy(p).cuda(), torch.from_numpy(lp).cuda()
    before = cuda_pruning.LAUNCHES
    kp, ke = forward_walk(pd, ld, walk)
    torch.cuda.synchronize()
    assert cuda_pruning.LAUNCHES > before
    rp, re = forward_walk_reference(pd, ld, walk)
    np.testing.assert_allclose(_site_ll_port(kp.cpu(), ke.cpu()),
                               _site_ll_port(rp.cpu(), re.cpu()),
                               rtol=0, atol=TOL)


def test_batch_chunk_splits_or_raises(monkeypatch):
    """The launch's memory check, with the device's memory faked: scratch
    that fits the allocator's unused cache needs no device query; else B is
    split to fit free memory, and a batch element that cannot fit raises."""
    state = {"reserved": 0, "allocated": 0, "free": 0, "queries": 0}

    def mem_get_info(device):
        state["queries"] += 1
        return state["free"], 80 << 30

    def stats(device):
        return {"reserved_bytes": {"all": {"current": state["reserved"]}},
                "allocated_bytes": {"all": {"current": state["allocated"]}}}

    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", stats)
    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    chunk = cuda_pruning._batch_chunk
    state.update(reserved=1000, allocated=200)
    assert chunk(8, 100, "cuda") == 8 and state["queries"] == 0
    state.update(free=1000)                   # budget 0.9 * (1000 + 800)
    assert chunk(64, 100, "cuda") == 16 and state["queries"] == 1
    assert chunk(10 ** 6, 1, "cuda") == 1620
    state.update(reserved=10 ** 7)            # grid z caps a launch's batch
    assert chunk(10 ** 6, 1, "cuda") == 65535 and state["queries"] == 2
    state.update(reserved=1000)
    with pytest.raises(MemoryError, match="scratch"):
        chunk(2, 10 ** 6, "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("s", [4, 20])
def test_saveall_kernel_takes_a_wide_node_on_card(s):
    """B2 on a tree whose root has 13 children (steps of at most
    ``saveall_stage``'s chunk): residuals to 1e-6 relative as x 2^e
    against the plain walk, the root row bit for bit the forward
    kernel's, with one and two lanes a column."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    star = ",".join(f"w{i}:{0.05 * (i + 1)}" for i in range(12))
    sub = _newick("random12").strip().rstrip(";")
    tree = tio.parse_newick(f"({star},{sub}:0.1);")
    sched = compile_schedule(tree, binarize=False)
    walk = WalkSchedule(sched)
    assert walk.children.shape[1] == 13
    rng = np.random.default_rng(9)
    eig = tmodels.GTR.eigen(GTR) if s == 4 else tmodels.LG.eigen()
    t = torch.from_numpy(np.asarray(tree.lengths)[:, None] * RATES)
    pd = extend_p_identity(transition_matrices(eig, t), sched.n_nodes).to(
        torch.float32).cuda().contiguous()
    ld = torch.from_numpy(np.eye(s, dtype=np.float32)[rng.integers(
        0, s, (tree.n_leaves, 301))]).cuda()
    wx, we = saveall_walk_reference(pd, ld, walk)
    kp, ke = forward_walk(pd, ld, walk, walk="classic")
    row = walk.root - walk.n_leaves
    lanes = dict(cuda_pruning._SAVEALL_LANES)
    try:
        for n in (1, 2):
            cuda_pruning._SAVEALL_LANES[s] = n
            rx, re = saveall_walk(pd, ld, walk)
            torch.cuda.synchronize()
            assert torch.equal(rx[:, row], kp) and torch.equal(re[:, row], ke)
            np.testing.assert_allclose(
                (rx.double() * torch.exp2(re.double())[..., None]).cpu(),
                (wx.double() * torch.exp2(we.double())[..., None]).cpu(),
                rtol=1e-6, atol=0)
    finally:
        cuda_pruning._SAVEALL_LANES.update(lanes)


@pytest.mark.gpu
def test_saveall_and_reverse_kernels_match_reference_on_card():
    """B2 and B3 against their plain versions on the card: residuals to
    1e-6 relative as x 2^e and the root row bit-identical to the forward
    kernel's; dP and dleaf to 1e-4 x max|g| (site sums in another order),
    and dP bit-identical across two launches (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    newick = _caterpillar(40, 1.5)
    tree, sched, p, lp = _inputs(newick, batch_scales=(0.5, 1.0, 3.0))
    walk = WalkSchedule(sched)
    pd, ld = torch.from_numpy(p).cuda(), torch.from_numpy(lp).cuda()
    rx, re = saveall_walk(pd, ld, walk)
    wx, we = saveall_walk_reference(pd, ld, walk)
    np.testing.assert_allclose(
        (rx.double() * torch.exp2(re.double())[..., None]).cpu().numpy(),
        (wx.double() * torch.exp2(we.double())[..., None]).cpu().numpy(),
        rtol=1e-6, atol=0)
    kp, ke = forward_walk(pd, ld, walk)
    row = walk.root - walk.n_leaves
    assert torch.equal(rx[:, :, row], kp) and torch.equal(re[:, :, row], ke)
    freqs = torch.from_numpy(FREQS).float().cuda()
    lam = (1.0 / torch.einsum("bksi,i->bks", kp, freqs)).contiguous()
    dp, dl = reverse_walk(pd, ld, rx, re, lam, freqs, walk, want_dleaf=True)
    dp2, _ = reverse_walk(pd, ld, rx, re, lam, freqs, walk)
    torch.cuda.synchronize()
    assert torch.equal(dp, dp2)
    wp, wl = reverse_walk_reference(pd, ld, rx, re, lam, freqs, walk,
                                    want_dleaf=True)
    for got, ref in ((dp, wp), (dl, wl)):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=0, atol=1e-4 * ref.abs().max().item())


def _wide_inputs(s, seed=3, sites=37, newick=None, sched=None):
    """P (n_nodes, 4, S, S) f32 of a random reversible S-state model and
    one-hot leaves with 5% all-ones rows, on a 9-taxon tree (or
    ``newick``, compiled as ``sched`` where given), made with numpy: the
    shapes of codon (61) and Mk (2)."""
    rng = np.random.default_rng(seed)
    tree = tio.parse_newick(newick or write_newick(random_tree(9, seed=4)))
    sched = sched or compile_schedule(tree)
    sym = rng.uniform(0.2, 2.0, (s, s))
    eig = tmodels.base.eigen_reversible(
        torch.from_numpy(sym + sym.T), torch.from_numpy(
            rng.dirichlet(np.full(s, 4.0))))
    t = torch.from_numpy(np.asarray(tree.lengths)[:, None] * RATES)
    p = extend_p_identity(transition_matrices(eig, t), sched.n_nodes)
    lp = np.eye(s, dtype=np.float32)[rng.integers(0, s, (tree.n_leaves,
                                                          sites))]
    lp[rng.random((tree.n_leaves, sites)) < 0.05] = 1.0
    return (sched, p.to(torch.float32), torch.from_numpy(lp),
            eig.freqs)


@pytest.mark.parametrize("s,s_pad", [(2, 4), (3, 4), (6, 20), (24, 64),
                                     (60, 64), (61, 64)])
def test_padded_walk_equals_unpadded_plain_walk(s, s_pad):
    """``make_cuda_prune_fn`` and ``make_fused_loglik_fn`` pad S states with
    zero states to ``padded_states(S)``; their roots (and the fused logL)
    equal the unpadded plain walk's bit for bit, and the padded leaves are
    made once per leaf tensor. (At 2 and 3 states the CPU einsum of the
    plain walk sums 2 or 3 products in another order than the padded 4:
    there the roots agree to 4 ulps, the exponent counts bit for bit. The
    kernels' fmaf chains run in j order, so the padding's fmaf(0, 0, y)
    leaves y as it was.)"""
    assert cuda_pruning.padded_states(s) == s_pad
    sched, p, lp, freqs = _wide_inputs(s)
    walk = WalkSchedule(sched)
    want_p, want_e = forward_walk_reference(p, lp, walk)
    prune = cuda_pruning.make_cuda_prune_fn(sched)
    root, logscale = prune(p, lp)
    assert root.shape == want_p.shape
    if s >= 4:
        assert torch.equal(root, want_p)
    else:
        np.testing.assert_allclose(root.numpy(), want_p.numpy(),
                                   rtol=2.0 ** -21, atol=0)
    assert torch.equal(logscale, want_e.double() * LN2)
    fused = make_fused_loglik_fn(sched)
    ll = fused(p, lp, freqs)
    want_ll = cuda_pruning._root_loglik(want_p, want_e, freqs)[0]
    np.testing.assert_allclose(ll.numpy(), want_ll.numpy(),
                               rtol=1e-15 if s >= 4 else 2.0 ** -21, atol=0)
    # the gradient is the unpadded walk's, sliced back to S states
    pg = p.clone().requires_grad_(True)
    fg = freqs.clone().requires_grad_(True)
    fused(pg, lp, fg).sum().backward()
    pr = p.clone().requires_grad_(True)
    fr = freqs.clone().requires_grad_(True)
    rx, re = saveall_walk_reference(p, lp, walk)
    row = walk.root - walk.n_leaves
    cuda_pruning._root_loglik(rx[:, row], re[:, row], fr)[0].sum().backward()
    assert pg.grad.shape == p.shape and fg.grad.shape == freqs.shape
    np.testing.assert_allclose(fg.grad.numpy(), fr.grad.numpy(),
                               rtol=1e-12 if s >= 4 else 2.0 ** -21)
    if s_pad != s:
        padded = cuda_pruning._PaddedLeaves()
        first = padded(lp, s_pad)
        assert first.shape == lp.shape[:-1] + (s_pad,)
        assert padded(lp, s_pad) is first               # kept
        assert torch.equal(first[..., s:], torch.zeros_like(first[..., s:]))
        lp2 = lp.clone()
        assert padded(lp2, s_pad) is not first          # another tensor


def test_wide_walk_routing_and_sizes():
    """At 32 states and more the value path streams (B5) whatever the size,
    as ``_pallas_forward`` does at a padded width of 32; B3's block at 64
    states holds a node of at most 3 children; B2 stages 2 edges a step."""
    for b, sites in ((1, 8), (64, 100_000)):
        assert cuda_pruning.choose_walk(b, 4, 99, sites, 64) == "stream"
    assert cuda_pruning.choose_walk(1, 4, 99, 8, 20) == "classic"
    for cmax in (2, 3):
        assert cuda_pruning.reverse_tile(64, cmax) == 64
        assert cuda_pruning._reverse_smem_bytes(64, cmax, 64) <= 232_448
    with pytest.raises(ValueError, match="PHYLO_DEFERRED_VJP"):
        cuda_pruning.reverse_tile(64, 4)
    assert cuda_pruning.saveall_stage(64, 100) == (2, 4 * 3 * 2 * 64 * 68)
    geo = cuda_pruning.row_geometry(1, 4, 4096, 64, 40)
    assert geo.lanes in (2, 4) and geo.smem_bytes <= 232_448


def test_every_kernel_runs_at_64_states(monkeypatch):
    """B4, B7, B8 and B9 run at 64 states (61 padded) like the other four:
    on the CPU their wrappers take the plain versions and launch nothing;
    B4's, B8's and B9's roots equal B1's bit for bit, and B7's dP from one
    root seed equals B3's plain dP (within 1e-10 x max|dP| in float64: the
    same per-node arithmetic), its dleaf too. The fused gradient takes B7
    under PHYLO_DEFERRED_VJP=0 (B2 first) with B3's gradient, and the
    value path takes B8 where PHYLO_STATIC_UNROLL_MAX asks for it, which
    precedes streaming."""
    sched, p, lp, freqs = _wide_inputs(61)
    p64 = cuda_pruning._pad_states(p, 64, 2).contiguous()
    l64 = cuda_pruning._pad_states(lp, 64, 1).contiguous()
    walk = WalkSchedule(sched)
    calls = []
    for name in ("forward_walk_reference", "slot_walk_reference",
                 "classic_reverse_walk_reference", "saveall_walk"):
        real = getattr(cuda_pruning, name)
        monkeypatch.setattr(
            cuda_pruning, name,
            lambda *a, _real=real, _name=name, **kw: calls.append(_name)
            or _real(*a, **kw))
    counters = ("LAUNCHES", "SLOT_LAUNCHES", "STATIC_LAUNCHES",
                "FOLD_LAUNCHES", "CLASSIC_REVERSE_LAUNCHES")
    before = [getattr(cuda_pruning, c) for c in counters]
    kp, ke = forward_walk(p64, l64, walk, walk="classic")
    runs = {"B4": (cuda_pruning.slot_walk(p64, l64, walk),
                   "slot_walk_reference"),
            "B4 via walk=slot": (forward_walk(p64, l64, walk, walk="slot"),
                                 "slot_walk_reference"),
            "B8": (cuda_pruning.static_walk(p64, l64, walk),
                   "forward_walk_reference"),
            "B9": (cuda_pruning.fold_walk(p64, l64, walk, 2),
                   "forward_walk_reference")}
    assert calls[0] == "forward_walk_reference"
    for (name, ((rp, re_), plain)), called in zip(runs.items(), calls[1:]):
        assert called == plain, name
        assert torch.equal(rp, kp) and torch.equal(re_, ke), name
    rx, re = saveall_walk_reference(p64, l64, walk)
    row = walk.root - walk.n_leaves
    assert torch.equal(kp, rx[:, row])
    lam = (1.0 / torch.einsum("ksi,i->ks", kp.double(),
                              cuda_pruning._pad_states(freqs, 64, 1))).float()
    f32 = cuda_pruning._pad_states(freqs, 64, 1).float()
    gseed = (lam[..., None] * f32).unsqueeze(-3).contiguous()
    d7, l7 = cuda_pruning.classic_reverse_walk(p64, l64, rx, re, gseed,
                                               [walk.root], walk,
                                               want_dleaf=True)
    assert calls[-1] == "classic_reverse_walk_reference"
    d3, l3 = reverse_walk_reference(p64, l64, rx, re, lam, f32, walk,
                                    want_dleaf=True)
    for got, want in ((d7, d3), (l7, l3)):
        np.testing.assert_allclose(
            got.double().numpy(), want.double().numpy(), rtol=0,
            atol=1e-10 * float(want.double().abs().max()))
    assert [getattr(cuda_pruning, c) for c in counters] == before
    fused = make_fused_loglik_fn(sched)
    grads = {}
    for env in ("0", "1"):
        monkeypatch.setenv("PHYLO_DEFERRED_VJP", env)
        calls.clear()
        pg = p.clone().requires_grad_(True)
        fused(pg, lp, freqs).sum().backward()
        grads[env] = pg.grad
        assert calls[0] == "saveall_walk"
        assert ("classic_reverse_walk_reference" in calls) == (env == "0")
    np.testing.assert_allclose(
        grads["0"].numpy(), grads["1"].numpy(), rtol=0,
        atol=1e-10 * float(grads["1"].abs().max()))
    monkeypatch.setattr(cuda_pruning, "STATIC_UNROLL_MAX", 1000)
    monkeypatch.setattr(cuda_pruning, "static_walk",
                        lambda *a, _real=cuda_pruning.static_walk:
                        calls.append("static_walk") or _real(*a))
    calls.clear()
    ll = fused(p, lp, freqs)
    assert calls[0] == "static_walk"
    want = cuda_pruning._root_loglik(
        kp, ke, cuda_pruning._pad_states(freqs, 64, 1))[0]
    assert torch.equal(ll, want)


@pytest.mark.gpu
def test_codon_width_kernels_match_reference_on_card():
    """Every kernel at 64 states (61 padded) on the card: B5's, B4's, B8's
    (F = 1) and B9's (F = 2) roots and B2's root row bit for bit B1's, the
    site log-likelihoods to the plain walk's within a few f32 roundings a
    node, B3's and B7's dP and dleaf to 1e-4 x max|g| of their plain
    versions, B7's dP to 1e-4 x max|dP| of B3's and bit-identical across
    two launches, B3's too; and B7 with two seeds and on a node of 5
    children (a schedule kept whole, past B7's 3 staged children, on sites
    simulated down the tree so that no product underflows: ROADMAP C)
    against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    sched, p, lp, freqs = _wide_inputs(61, sites=300)
    walk = WalkSchedule(sched)
    pd = cuda_pruning._pad_states(p, 64, 2).contiguous().cuda()
    ld = cuda_pruning._pad_states(lp, 64, 1).contiguous().cuda()
    fd = cuda_pruning._pad_states(freqs, 64, 1).cuda()
    kp, ke = forward_walk(pd, ld, walk, walk="classic")
    sp, se = cuda_pruning.slot_walk(pd, ld, walk, stream=True)
    rx, re = saveall_walk(pd, ld, walk)
    row = walk.root - walk.n_leaves
    assert torch.equal(kp, sp) and torch.equal(ke, se)
    assert torch.equal(rx[:, row], kp) and torch.equal(re[:, row], ke)
    rp, rpe = forward_walk_reference(pd, ld, walk)
    got = torch.log(kp.double() @ fd) + ke.double() * LN2
    want = torch.log(rp.double() @ fd) + rpe.double() * LN2
    assert float((got - want).abs().max()) <= len(walk.order) * 2.0 ** -21
    lam = (1.0 / torch.einsum("ksi,i->ks", kp.double(), fd)).float()
    f32 = fd.float().contiguous()
    dp, dl = reverse_walk(pd, ld, rx, re, lam, f32, walk, want_dleaf=True)
    dp2, _ = reverse_walk(pd, ld, rx, re, lam, f32, walk)
    torch.cuda.synchronize()
    assert torch.equal(dp, dp2)
    wp, wl = reverse_walk_reference(pd, ld, rx, re, lam, f32, walk,
                                    want_dleaf=True)
    for got, ref in ((dp, wp), (dl, wl)):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=0, atol=1e-4 * ref.abs().max().item())
    for name, (rp_, re_) in (
            ("B4", cuda_pruning.slot_walk(pd, ld, walk)),
            ("B8", cuda_pruning.static_walk(pd, ld, walk)),
            ("B9", cuda_pruning.fold_walk(pd, ld, walk, 2))):
        torch.cuda.synchronize()
        assert torch.equal(rp_, kp) and torch.equal(re_, ke), name
    gseed = (lam[..., None] * f32).unsqueeze(-3).contiguous()
    d7, l7 = cuda_pruning.classic_reverse_walk(pd, ld, rx, re, gseed,
                                               [walk.root], walk,
                                               want_dleaf=True)
    d7b, _ = cuda_pruning.classic_reverse_walk(pd, ld, rx, re, gseed,
                                               [walk.root], walk)
    torch.cuda.synchronize()
    assert torch.equal(d7, d7b)
    w7, wl7 = cuda_pruning.classic_reverse_walk_reference(
        pd, ld, rx, re, gseed, [walk.root], walk, want_dleaf=True)
    for got, ref in ((d7, w7), (l7, wl7), (d7, dp)):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=0, atol=1e-4 * ref.abs().max().item())
    # two seeds, and a node of 5 children on simulated sites
    seeds = [walk.root, int(walk.order[len(walk.order) // 2])]
    g2 = torch.rand((4, 2) + tuple(ld.shape[1:]), device="cuda") + 0.5
    got2 = cuda_pruning.classic_reverse_walk(pd, ld, rx, re, g2, seeds,
                                             walk, want_dleaf=True)
    want2 = cuda_pruning.classic_reverse_walk_reference(
        pd, ld, rx, re, g2, seeds, walk, want_dleaf=True)
    star = ",".join(f"w{i}:0.05" for i in range(4))
    sub = write_newick(random_tree(6, seed=2)).strip().rstrip(";")
    tree5 = tio.parse_newick(f"({star},{sub}:0.1);")
    sched5 = compile_schedule(tree5, binarize=False)
    walk5 = WalkSchedule(sched5)
    assert walk5.children.shape[1] == 5
    assert cuda_pruning.classic_reverse_stage(64, 5)[0] == 3
    _, p5, _, f5 = _wide_inputs(61, newick=f"({star},{sub}:0.1);",
                                sched=sched5)
    rng = np.random.default_rng(5)
    p5_64 = cuda_pruning._pad_states(p5, 64, 2).contiguous().cuda()
    states = _simulate_codes(tree5, p5.double().numpy(), 256, f5.numpy(), rng)
    l5 = torch.zeros((tree5.n_leaves, 256, 64))
    l5.scatter_(2, torch.from_numpy(states)[..., None], 1.0)
    l5 = l5.cuda()
    rx5, re5 = saveall_walk(p5_64, l5, walk5)
    row5 = walk5.root - walk5.n_leaves
    f5d = cuda_pruning._pad_states(f5, 64, 1).cuda()
    lam5 = (1.0 / torch.einsum("ksi,i->ks", rx5[:, row5].double(),
                               f5d)).float()
    g5 = (lam5[..., None] * f5d.float()).unsqueeze(-3).contiguous()
    got5 = cuda_pruning.classic_reverse_walk(p5_64, l5, rx5, re5, g5,
                                             [walk5.root], walk5,
                                             want_dleaf=True)
    want5 = cuda_pruning.classic_reverse_walk_reference(
        p5_64, l5, rx5, re5, g5, [walk5.root], walk5, want_dleaf=True)
    torch.cuda.synchronize()
    for got, ref in zip(got2 + got5, want2 + want5):
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=0, atol=1e-4 * ref.abs().max().item())


def _simulate_codes(tree, p_edges, n_sites, freqs, rng):
    """(n_leaves, n_sites) states evolved down ``tree`` under ``p_edges``
    (n_nodes, K, S, S) float64, a category drawn per site, the root from
    ``freqs``."""
    k, s = p_edges.shape[1], p_edges.shape[-1]
    states = np.zeros((tree.n_nodes, n_sites), np.int64)
    cat = rng.integers(0, k, n_sites)
    states[tree.root] = rng.choice(s, n_sites, p=freqs / freqs.sum())
    for node in range(tree.n_nodes - 1, -1, -1):  # ids are post-order
        for child in tree.children[node]:
            cum = np.cumsum(p_edges[child, cat, states[node]], axis=1)
            u = rng.random(n_sites)[:, None] * cum[:, -1:]
            states[child] = (u > cum).sum(axis=1)
    return states[:tree.n_leaves]
