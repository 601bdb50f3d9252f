"""Port parity, pruning walk: ``phylo_utils_tpu_torch.ops.cuda_pruning``
against the JAX package's Pallas pruner (interpret mode on the CPU) on the
same numpy-made P matrices and leaf partials, in float32.

Tolerance: the root per-site log-likelihood log(pi . x_root) + e ln2 agrees
to 1e-5 absolute. Both walks do the same f32 contraction and the same exact
power-of-two rescale, but the contraction's summation order differs, so a
node's exponent may flip by one at a power-of-two boundary with its
partials scaled to compensate: compare the log-likelihood, not e alone.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_utils_tpu import io as jio
from phylo_utils_tpu.ops.pallas_pruning import make_pallas_prune_fn
from phylo_utils_tpu.trees import compile_schedule as j_compile_schedule
from phylo_utils_tpu_torch import io as tio
from phylo_utils_tpu_torch import models as tmodels
from phylo_utils_tpu_torch.ops import cuda_pruning
from phylo_utils_tpu_torch.ops.cuda_pruning import (
    WalkSchedule,
    forward_walk,
    forward_walk_reference,
    make_fused_loglik_fn,
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
    with pytest.raises(NotImplementedError, match="B2/B3"):
        forward_walk(pt.clone().requires_grad_(True), lt, walk)


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
