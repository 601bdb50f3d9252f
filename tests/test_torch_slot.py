"""Port parity, big-tree walks: the DFS slot schedule, the slot and stream
walks (``cuda_pruning.slot_walk``, kernels ``pruning_slot_f32`` and
``pruning_stream_f32``) and the value path's choice among the classic, slot
and stream walks, against the JAX package.

The slot schedule's arrays are identical to JAX's ``_dfs_slot_schedule``.
The slot walk's plain version is bit for bit the classic walk's plain
version (same per-node arithmetic and child order) at 4 and 20 states. Its
root agrees with the JAX Pallas pruner forced onto its slot and stream
kernels (interpret mode) to 1e-5 absolute in the per-site log-likelihood:
both walks do the same f32 contraction and exact power-of-two rescale, but
sum the contraction in another order (``tests/test_torch_pruning.py``). The
kernels themselves run only on the card (tests marked ``gpu``).
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
from phylo_utils_tpu_torch.io import write_newick
from phylo_utils_tpu_torch.ops import cuda_pruning
from phylo_utils_tpu_torch.ops.cuda_pruning import (
    WalkSchedule,
    choose_walk,
    forward_walk,
    forward_walk_reference,
    make_fused_loglik_fn,
    reverse_walk,
    reverse_walk_reference,
    saveall_walk,
    saveall_walk_reference,
    slot_walk,
    slot_walk_reference,
)
from phylo_utils_tpu_torch.ops.pmatrix import (
    extend_p_identity,
    transition_matrices,
)
from phylo_utils_tpu_torch.ops.pruning import LN2
from phylo_utils_tpu_torch.trees import compile_schedule, random_tree

from torch_threads import one_thread  # noqa: F401

MULTIFURCATING = (
    "((a:0.1,b:0.2,c:0.05):0.1,(d:0.3,e:0.1,f:0.2,g:0.15):0.2,"
    "(h:0.1,(i:0.2,j:0.3):0.05):0.1,k:0.4,l:0.25);"
)
MODELS = {4: (tmodels.GTR, {"rates": [1.2, 3.1, 0.7, 0.9, 4.2, 1.0],
                            "freqs": [0.3, 0.2, 0.22, 0.28]}),
          20: (tmodels.LG, None),
          # a codon width: GY94's 61 states, padded to 64 as the engines'
          # entry points pad them
          64: (tmodels.GY94, None)}
RATES = np.array([0.1, 0.6, 1.2, 2.1])
TOL = 1e-5


def _caterpillar(n, brlen):
    return "(" * (n - 1) + f"t0:{brlen}" + "".join(
        f",t{i}:{brlen})" + (f":{brlen}" if i < n - 1 else "")
        for i in range(1, n)) + ";"


TREES = {
    "random16": lambda: write_newick(random_tree(16, seed=4)),
    "random40": lambda: write_newick(random_tree(40, seed=5)),
    "caterpillar30": lambda: _caterpillar(30, 0.4),
    "multifurcating": lambda: MULTIFURCATING,
}


def _inputs(newick, s, sites, batch_scales=None, seed=0):
    """numpy-made f32 P (identity blocks for pseudo-nodes) and one-hot
    leaves with 5% all-ones rows, for ``s`` states (at 64, GY94's 61
    padded with zero states)."""
    tree = tio.parse_newick(newick)
    sched = compile_schedule(tree)
    model, params = MODELS[s]
    n = 61 if s == 64 else s
    rng = np.random.default_rng(seed)
    lp = np.eye(n, dtype=np.float32)[rng.integers(0, n, (tree.n_leaves,
                                                          sites))]
    lp[rng.random((tree.n_leaves, sites)) < 0.05] = 1.0
    lengths = np.asarray(tree.lengths)
    if batch_scales is not None:
        lengths = np.stack([lengths * b for b in batch_scales])
    t = torch.from_numpy(lengths[..., None] * RATES)
    p = extend_p_identity(transition_matrices(model.eigen(params), t),
                          sched.n_nodes).to(torch.float32)
    lp = torch.from_numpy(lp)
    if s != n:
        p = cuda_pruning._pad_states(p, s, 2)
        lp = cuda_pruning._pad_states(lp, s, 1)
    return sched, p.contiguous(), lp.contiguous()


@pytest.mark.parametrize("case", sorted(TREES))
def test_slot_schedule_matches_jax(case):
    newick = TREES[case]()
    got = cuda_pruning._dfs_slot_schedule(
        compile_schedule(tio.parse_newick(newick)))
    want = jpp._dfs_slot_schedule(j_compile_schedule(jio.parse_newick(newick)))
    assert len(got) == len(want) == 7
    for name, a, b in zip(("nslot", "child_node", "child_src",
                           "child_isleaf", "counts"), got[:5], want[:5]):
        assert a.dtype == np.int32, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got[5:] == want[5:]          # n_slots, root_slot
    sched = compile_schedule(tio.parse_newick(newick))
    assert got[5] < sched.n_nodes - sched.n_leaves
    if case == "caterpillar30":
        assert got[5] == 1              # every node reuses its child's slot


@pytest.mark.parametrize("s", [4, 20])
@pytest.mark.parametrize("case", ["random40", "caterpillar30",
                                  "multifurcating"])
def test_slot_reference_bit_identical_to_forward_reference(case, s):
    sched, p, lp = _inputs(TREES[case](), s, 37, batch_scales=(0.5, 1.0, 3.0))
    walk = WalkSchedule(sched)
    want = forward_walk_reference(p, lp, walk)
    got = slot_walk_reference(p, lp, walk)
    assert got[0].shape == want[0].shape == (3, 4, 37, s)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    single = slot_walk_reference(p[1], lp, walk)
    assert torch.equal(single[0], want[0][1])
    if case == "caterpillar30":
        assert want[1].min() < -20       # the deep walk really rescaled


def _site_ll(root_p, root_e, freqs):
    return (np.log(root_p.double().numpy() @ freqs)
            + root_e.double().numpy() * LN2)


@pytest.mark.parametrize("s,sites", [(4, 200), (20, 130)])
@pytest.mark.parametrize("kind", ["slot", "stream"])
def test_slot_walk_matches_pallas_slot_kernels(monkeypatch, kind, s, sites):
    """The port's slot walk against JAX ``make_pallas_prune_fn`` with
    ``VMEM_BUDGET`` patched so its classic kernel does not fit and only the
    slot (or only the stream) kernel does, as
    ``tests/test_pallas_pruning.py`` forces them."""
    newick = TREES["random16"]()
    sched, p, lp = _inputs(newick, s, sites, seed=3)
    jsched = j_compile_schedule(jio.parse_newick(newick))
    s_pad = jpp._state_pad(s)
    n_slots = jpp._slot_count(jsched)
    size = {m: jpp._working_bytes(jpp.LANE, jsched.n_nodes, jsched.n_leaves,
                                  s_pad, m, n_slots)
            for m in ("fwd", "slot", "stream")}
    assert size["stream"] < size["slot"] < size["fwd"]
    budget = ((size["slot"] + size["fwd"]) // 2 if kind == "slot"
              else (size["stream"] + size["slot"]) // 2)
    monkeypatch.setattr(jpp, "VMEM_BUDGET", budget)
    r, sc = jax.jit(jpp.make_pallas_prune_fn(jsched))(
        jnp.asarray(p.numpy()), jnp.asarray(lp.numpy()))
    freqs = np.full(s, 1.0 / s)
    want = np.log(np.asarray(r, np.float64) @ freqs) + np.asarray(sc)
    walk = WalkSchedule(sched)
    got = slot_walk(p, lp, walk, stream=kind == "stream")
    np.testing.assert_allclose(_site_ll(*got, freqs), want, rtol=0, atol=TOL)
    assert torch.equal(got[0], forward_walk(p, lp, walk, walk=kind)[0])


def test_choose_walk_rule():
    """Classic while the launch's whole-tree scratch fits the budget; then
    the slot walk for DNA and the stream walk for protein. The shapes of
    the main paths: the B = 1 DNA flagship stays classic (5.2 MB), the
    1000-taxon DNA and 512-taxon protein trees at 8192 patterns leave it
    (655 MB and 1.41 GB)."""
    assert choose_walk(1, 4, 63, 1024, 4) == "classic"
    assert choose_walk(1, 4, 999, 8192, 4) == "slot"
    assert choose_walk(1, 4, 511, 8192, 20) == "stream"
    budget = cuda_pruning.CLASSIC_SCRATCH_BUDGET
    n = budget // (4 * 5 * 4)             # B x n_inner x sites at the edge
    assert choose_walk(1, 4, 1, n, 4) == "classic"
    assert choose_walk(1, 4, 1, n + 1, 4) == "slot"
    assert choose_walk(1, 4, 1, n + 1, 20) == "stream"


@pytest.mark.parametrize("env", ["0", "1", "auto"])
def test_force_stream_rule(monkeypatch, env):
    """``PHYLO_FORCE_STREAM`` as ``_pallas_forward`` reads it: "1" streams
    at every width (4 states included); "auto" (the default) streams at 32
    states and more and is the rule of ``test_choose_walk_rule`` below;
    "0" at 64 states is that rule too, the classic walk within
    ``CLASSIC_SCRATCH_BUDGET`` and the slot walk (B4) past it, where JAX
    takes ``_dynamic_slot_kernel``. Within and past the budget at 4, 20
    and 64 states; "auto" and "0" agree below 32 states."""
    monkeypatch.setenv("PHYLO_FORCE_STREAM", env)
    budget = cuda_pruning.CLASSIC_SCRATCH_BUDGET
    for s in (4, 20, 64):
        n = budget // (4 * (s + 1) * 4)     # B x n_inner x sites at the edge
        within = choose_walk(1, 4, 1, n, s)
        past = choose_walk(1, 4, 1, n + 1, s)
        if env == "1" or (env == "auto" and s >= 32):
            assert (within, past) == ("stream", "stream"), s
        else:
            assert within == "classic", s
            assert past == ("stream" if s == 20 else "slot"), s
    monkeypatch.delenv("PHYLO_FORCE_STREAM")
    if env != "1":
        for s in (4, 20):
            for sites in (8, 10 ** 6):
                monkeypatch.setenv("PHYLO_FORCE_STREAM", env)
                got = choose_walk(1, 4, 99, sites, s)
                monkeypatch.delenv("PHYLO_FORCE_STREAM")
                assert got == choose_walk(1, 4, 99, sites, s)


def test_force_stream_routes_the_value_walk(monkeypatch):
    """``forward_walk(walk="auto")`` under ``PHYLO_FORCE_STREAM``: "1"
    takes the stream walk at 4 states where the default takes the classic
    one, and B8 still precedes it under ``STATIC_UNROLL_MAX``; "0" at 64
    states takes the classic walk within the budget and B4 past it; every
    walk gives the same bits (the plain versions on the CPU)."""
    sched, p, lp = _inputs(TREES["random40"](), 4, 29)
    walk = WalkSchedule(sched)
    calls = []
    for name in ("static_walk", "slot_walk", "forward_walk_reference"):
        real = getattr(cuda_pruning, name)
        monkeypatch.setattr(
            cuda_pruning, name,
            lambda *a, _real=real, _name=name, **kw: calls.append(
                (_name, kw.get("stream"))) or _real(*a, **kw))
    want = forward_walk_reference(p, lp, walk)
    calls.clear()
    monkeypatch.setenv("PHYLO_FORCE_STREAM", "1")
    got = [forward_walk(p, lp, walk)]
    monkeypatch.setattr(cuda_pruning, "STATIC_UNROLL_MAX", 10 ** 6)
    got.append(forward_walk(p, lp, walk))
    monkeypatch.setattr(cuda_pruning, "STATIC_UNROLL_MAX", 0)
    assert [c for c in calls if c[0] != "forward_walk_reference"] == [
        ("slot_walk", True), ("static_walk", None)]
    p64 = cuda_pruning._pad_states(p, 64, 2).contiguous()
    l64 = cuda_pruning._pad_states(lp, 64, 1).contiguous()
    want64 = forward_walk_reference(p64, l64, walk)
    monkeypatch.setenv("PHYLO_FORCE_STREAM", "0")
    calls.clear()
    got64 = [forward_walk(p64, l64, walk)]
    monkeypatch.setattr(cuda_pruning, "CLASSIC_SCRATCH_BUDGET", 1024)
    got64.append(forward_walk(p64, l64, walk))
    assert calls == [("forward_walk_reference", None), ("slot_walk", False)]
    for (r, e), (wr, we) in [(g, want) for g in got] + [
            (g, want64) for g in got64]:
        assert torch.equal(r, wr) and torch.equal(e, we)


def test_forward_walk_routes_by_walk_argument(monkeypatch):
    """``walk=`` forces each walk; "auto" follows ``choose_walk``; on CPU
    tensors each takes its plain version and launches nothing."""
    sched, p, lp = _inputs(TREES["random40"](), 4, 29)
    walk = WalkSchedule(sched)
    calls = []
    for name in ("forward_walk_reference", "slot_walk_reference"):
        real = getattr(cuda_pruning, name)
        monkeypatch.setattr(
            cuda_pruning, name,
            lambda *a, _real=real, _name=name: calls.append(_name)
            or _real(*a))
    counts = lambda: (cuda_pruning.LAUNCHES, cuda_pruning.SLOT_LAUNCHES,
                      cuda_pruning.STREAM_LAUNCHES)
    before = counts()
    want = forward_walk(p, lp, walk, walk="classic")
    for kind in ("slot", "stream"):
        got = forward_walk(p, lp, walk, walk=kind)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert calls == ["forward_walk_reference", "slot_walk_reference",
                     "slot_walk_reference"]
    calls.clear()
    forward_walk(p, lp, walk)                        # 5 KB: classic
    monkeypatch.setattr(cuda_pruning, "CLASSIC_SCRATCH_BUDGET", 1024)
    forward_walk(p, lp, walk, walk="auto")
    assert calls == ["forward_walk_reference", "slot_walk_reference"]
    assert counts() == before
    with pytest.raises(ValueError, match="walk must be one of"):
        forward_walk(p, lp, walk, walk="levels")


def test_fused_loglik_value_path_routes_and_gradient_stays_whole_tree(
        monkeypatch):
    """Past the budget the engine's value path takes the slot walk (same
    bits); a gradient still runs the whole-tree saveall and reverse
    walks."""
    sched, p, lp = _inputs(TREES["random40"](), 4, 29, seed=2)
    freqs = torch.tensor(MODELS[4][1]["freqs"], dtype=torch.float64)
    fn = make_fused_loglik_fn(sched)
    want = fn(p, lp, freqs)
    calls = []
    real = cuda_pruning.slot_walk_reference
    monkeypatch.setattr(cuda_pruning, "slot_walk_reference",
                        lambda *a: calls.append("slot") or real(*a))
    monkeypatch.setattr(cuda_pruning, "CLASSIC_SCRATCH_BUDGET", 0)
    assert torch.equal(fn(p, lp, freqs), want) and calls == ["slot"]
    pg = p.double().requires_grad_(True)
    (dp,) = torch.autograd.grad(fn(pg, lp, freqs).sum(), (pg,))
    assert calls == ["slot"] and dp.shape == p.shape


def test_default_engine_device_is_the_card():
    """An engine made without ``device=`` runs on the card; without one it
    raises (it never carries on quietly on the CPU)."""
    from phylo_utils_tpu_torch.likelihood import LikelihoodEngine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tree = random_tree(6, seed=1)
    aln = {n: "ACGTACGTAA" for n in tree.leaf_names}
    with pytest.raises(RuntimeError, match="cuda"):
        LikelihoodEngine(tree, aln, tmodels.GTR)
    assert LikelihoodEngine(tree, aln, tmodels.GTR,
                            device="cpu").device.type == "cpu"


# -- on the card -----------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("s", [4, 20, 64])
def test_slot_and_stream_kernels_on_card(s):
    """B4 and B5 on the card: bit-identical to the forward kernel and to
    their plain version, at 4 and 20 states and at 64 (a small codon
    shape: 301 sites leave the last 64-column tile ragged), single and
    batched."""
    _cuda_or_skip()
    for case in ("random40", "caterpillar30", "multifurcating"):
        sched, p, lp = _inputs(TREES[case](), s, 301,
                               batch_scales=(0.5, 1.0, 3.0))
        walk = WalkSchedule(sched)
        pd, ld = p.cuda(), lp.cuda()
        want = forward_walk(pd, ld, walk, walk="classic")
        plain = slot_walk_reference(pd, ld, walk)
        for stream in (False, True):
            before = (cuda_pruning.SLOT_LAUNCHES,
                      cuda_pruning.STREAM_LAUNCHES)
            got = slot_walk(pd, ld, walk, stream=stream)
            torch.cuda.synchronize()
            after = (cuda_pruning.SLOT_LAUNCHES, cuda_pruning.STREAM_LAUNCHES)
            assert after[int(stream)] > before[int(stream)]
            for g, w in zip(got, want):
                assert torch.equal(g, w), (case, stream)
            np.testing.assert_allclose(
                _site_ll(got[0].cpu(), got[1].cpu(), np.full(s, 1.0 / s)),
                _site_ll(plain[0].cpu(), plain[1].cpu(), np.full(s, 1.0 / s)),
                rtol=0, atol=TOL)


@pytest.mark.gpu
def test_protein_gradient_kernels_on_card():
    """B2 and B3 at 20 states against their plain versions on the card:
    the saveall root row bit-identical to the forward kernel's root, dP
    and dleaf to 1e-4 x max|g|, dP bit-identical across two launches."""
    _cuda_or_skip()
    sched, p, lp = _inputs(TREES["random40"](), 20, 301,
                           batch_scales=(0.5, 1.0))
    walk = WalkSchedule(sched)
    pd, ld = p.cuda(), lp.cuda()
    rx, re = saveall_walk(pd, ld, walk)
    kp, ke = forward_walk(pd, ld, walk, walk="classic")
    row = walk.root - walk.n_leaves
    assert torch.equal(rx[:, :, row], kp) and torch.equal(re[:, :, row], ke)
    wx, we = saveall_walk_reference(pd, ld, walk)
    np.testing.assert_allclose(
        (rx.double() * torch.exp2(re.double())[..., None]).cpu().numpy(),
        (wx.double() * torch.exp2(we.double())[..., None]).cpu().numpy(),
        rtol=1e-5, atol=0)
    freqs = torch.from_numpy(tmodels.LG.eigen().freqs.numpy()).float().cuda()
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


# a trifurcating root and a 4-child node: the walks' P stages and dP sums
# hold cmax = 4 children
WIDE_ROOT = ("((a:0.1,b:0.2,c:0.3,d:0.1):0.1,(e:0.2,(f:0.1,g:0.3):0.2):0.3,"
             "h:0.2);")


@pytest.mark.gpu
@pytest.mark.parametrize("s", [4, 20, 64])
def test_stream_kernel_with_multifurcations_on_card(s):
    """B5 on a tree with a trifurcating root and a 4-child node, at a
    ragged site count: bit-identical to the forward kernel and within TOL
    of its plain version."""
    _cuda_or_skip()
    sched, p, lp = _inputs(WIDE_ROOT, s, 301, batch_scales=(0.5, 2.0))
    walk = WalkSchedule(sched)
    pd, ld = p.cuda(), lp.cuda()
    want = forward_walk(pd, ld, walk, walk="classic")
    before = cuda_pruning.STREAM_LAUNCHES
    got = slot_walk(pd, ld, walk, stream=True)
    torch.cuda.synchronize()
    assert cuda_pruning.STREAM_LAUNCHES == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    plain = slot_walk_reference(pd, ld, walk)
    np.testing.assert_allclose(
        _site_ll(got[0].cpu(), got[1].cpu(), np.full(s, 1.0 / s)),
        _site_ll(plain[0].cpu(), plain[1].cpu(), np.full(s, 1.0 / s)),
        rtol=0, atol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [4, 20])
def test_reverse_kernel_with_multifurcations_on_card(s):
    """B3 on a tree with a trifurcating root and a 4-child node, at a
    ragged site count: dP and dleaf within 1e-4 x max|g| of its plain
    version, dP bit-identical across two launches, the root's row zero."""
    _cuda_or_skip()
    sched, p, lp = _inputs(WIDE_ROOT, s, 301, batch_scales=(0.5, 2.0))
    walk = WalkSchedule(sched)
    pd, ld = p.cuda(), lp.cuda()
    rx, re = saveall_walk(pd, ld, walk)
    freqs = torch.full((s,), 1.0 / s, device="cuda")
    row = walk.root - walk.n_leaves
    lam = (1.0 / torch.einsum("bksi,i->bks", rx[:, :, row], freqs)
           ).contiguous()
    before = cuda_pruning.REVERSE_LAUNCHES
    dp, dl = reverse_walk(pd, ld, rx, re, lam, freqs, walk, want_dleaf=True)
    dp2, _ = reverse_walk(pd, ld, rx, re, lam, freqs, walk)
    torch.cuda.synchronize()
    assert cuda_pruning.REVERSE_LAUNCHES == before + 2
    assert torch.equal(dp, dp2)
    assert float(dp[:, walk.root].abs().max()) == 0.0
    wp, wl = reverse_walk_reference(pd, ld, rx, re, lam, freqs, walk,
                                    want_dleaf=True)
    for got, ref in ((dp, wp), (dl, wl)):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=0, atol=1e-4 * ref.abs().max().item())
