"""The plain walks' bit contract on any CPU: ``cuda_pruning.plain_contract``
(the one contraction of every plain version in ``ops/cuda_pruning.py``),
``forward_walk_reference`` and ``saveall_walk_reference`` give the same
bits for a child row in einsum's permuted layout and its contiguous copy,
for a batch of two and each element alone, and for S states and the same
states with zero states padded onto S. A BLAS kernel's summation order
depends on all three, so a CPU einsum kept none of them on some hosts (an
AMD EPYC with AVX512 under MKL). Every comparison is ``torch.equal``.
"""
import numpy as np
import pytest
import torch

from phylo_utils_tpu_torch.ops import cuda_pruning
from phylo_utils_tpu_torch.ops.cuda_pruning import (
    WalkSchedule,
    forward_walk_reference,
    plain_contract,
    saveall_walk_reference,
)
from phylo_utils_tpu_torch.trees import compile_schedule, random_tree

from torch_threads import one_thread  # noqa: F401

SITES = 37
K = 3
# the plain walks' contractions: y = P x, P^T g and dP = sum_sites gy x^T,
# with the child row per batch element or a leaf's rows shared
EQUATIONS = ("bkij,bksj->bksi", "bkij,sj->bksi", "bkji,bksj->bksi",
             "bksi,bksj->bkij", "bksi,sj->bkij")
# state counts: 2-3, 6 and 24 are padded to 4, 20 and 64, the others are
# compiled widths, each also padded onto 64
STATES = (2, 3, 4, 6, 20, 24, 61, 64)


def _permuted(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its last two dims stored the other way round (the
    layout einsum returned for a child row: states outer, sites inner)."""
    return t.transpose(-1, -2).contiguous().transpose(-1, -2)


def _operands(eq: str, s: int, b: int = 1, seed: int = 0):
    """Random f32 operands of ``eq`` at ``s`` states, sizes b, K, SITES."""
    rng = np.random.default_rng(seed)
    sizes = {"b": b, "k": K, "s": SITES, "i": s, "j": s}
    ins = eq.split("->")[0].split(",")
    return [torch.from_numpy(rng.uniform(0.0, 1.0, [sizes[d] for d in idx])
                             .astype(np.float32)) for idx in ins]


def _pad(t: torch.Tensor, idx: str, s_pad: int) -> torch.Tensor:
    """``t`` with zero states appended to each of its state dims (i, j)."""
    out = t
    for dim, d in enumerate(idx):
        if d in "ij":
            shape = list(out.shape)
            shape[dim] = s_pad - out.shape[dim]
            out = torch.cat([out, out.new_zeros(shape)], dim=dim)
    return out


@pytest.mark.parametrize("eq", EQUATIONS)
def test_contract_ignores_layout(eq):
    """Operands in a permuted layout give their contiguous copies' bits,
    and the result is the einsum's to float32 rounding."""
    a, b = _operands(eq, 61)
    got = plain_contract(eq, a, b)
    assert torch.equal(got, plain_contract(eq, _permuted(a), _permuted(b)))
    assert torch.equal(got, plain_contract(eq, a.contiguous(),
                                           _permuted(b)))
    want = torch.einsum(eq, a.double(), b.double())
    np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                               rtol=2e-6, atol=0)


@pytest.mark.parametrize("eq", EQUATIONS)
def test_contract_batch_of_two_is_two_contractions(eq):
    """A batch of two gives each element the bits it has alone."""
    a, b = _operands(eq, 20, b=2, seed=1)
    got = plain_contract(eq, a, b)
    ia, ib = eq.split("->")[0].split(",")
    for i in range(2):
        one = plain_contract(eq, a[i:i + 1] if "b" in ia else a,
                             b[i:i + 1] if "b" in ib else b)
        assert torch.equal(got[i], one[0])


@pytest.mark.parametrize("s", STATES)
@pytest.mark.parametrize("eq", EQUATIONS)
def test_contract_zero_padded_states(eq, s):
    """Zero states padded onto S, to ``padded_states(S)`` and to 64, leave
    the S states' bits as they were and give zeros past them."""
    a, b = _operands(eq, s, seed=2)
    want = plain_contract(eq, a, b)
    ia, ib = eq.split("->")[0].split(",")
    out = eq.split("->")[1]
    for s_pad in sorted({cuda_pruning.padded_states(s), 64}):
        got = plain_contract(eq, _pad(a, ia, s_pad), _pad(b, ib, s_pad))
        sl = tuple(slice(0, s) if d in "ij" else slice(None) for d in out)
        assert torch.equal(got[sl], want)
        rest = got.clone()
        rest[sl] = 0.0
        assert not rest.any()     # zeros past the S states


@pytest.mark.parametrize("eq", EQUATIONS)
def test_contract_in_slices_is_the_whole_contraction(monkeypatch, eq):
    """Products of more than ``_PLAIN_CHUNK`` elements are formed in
    slices of the widest output dim: the same bits."""
    a, b = _operands(eq, 20, b=2, seed=6)
    whole = plain_contract(eq, a, b)
    monkeypatch.setattr(cuda_pruning, "_PLAIN_CHUNK", 1000)
    assert torch.equal(plain_contract(eq, a, b), whole)


def _walk_inputs(s: int, b: int = 1, seed: int = 3):
    """A 12-taxon walk, P (b?, n_nodes, K, S, S) of row-stochastic f32
    matrices and one-hot leaves (n_leaves, SITES, S) with 5% all-ones
    rows, made with numpy."""
    rng = np.random.default_rng(seed)
    sched = compile_schedule(random_tree(12, seed=seed))
    shape = ((b,) if b > 1 else ()) + (sched.n_nodes, K, s, s)
    p = rng.gamma(0.5, 1.0, shape) + 1e-3
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    lp = np.eye(s, dtype=np.float32)[rng.integers(0, s, (sched.n_leaves,
                                                         SITES))]
    lp[rng.random((sched.n_leaves, SITES)) < 0.05] = 1.0
    return WalkSchedule(sched), torch.from_numpy(p), torch.from_numpy(lp)


@pytest.mark.parametrize("s", (4, 20, 61, 64))
def test_plain_walks_ignore_layout(s):
    """P and leaves in a permuted layout give the forward and saveall
    walks' bits, and saveall's root row is the forward walk's root."""
    walk, p, lp = _walk_inputs(s)
    root_p, root_e = forward_walk_reference(p, lp, walk)
    perm_p, perm_e = forward_walk_reference(_permuted(p), _permuted(lp),
                                            walk)
    assert torch.equal(root_p, perm_p) and torch.equal(root_e, perm_e)
    rx, re = saveall_walk_reference(p, lp, walk)
    px, pe = saveall_walk_reference(_permuted(p), _permuted(lp), walk)
    assert torch.equal(rx, px) and torch.equal(re, pe)
    row = walk.root - walk.n_leaves
    assert torch.equal(rx[:, row], root_p) and torch.equal(re[:, row],
                                                           root_e)


@pytest.mark.parametrize("shared", (True, False))
@pytest.mark.parametrize("s", (4, 20, 61, 64))
def test_plain_walks_batch_of_two(s, shared):
    """A batch of two, with shared leaves or one set each, gives each
    element the bits of its walk alone."""
    walk, p, lp = _walk_inputs(s, b=2, seed=4)
    leaves = lp if shared else torch.stack([lp, lp.flip(0)])
    root_p, root_e = forward_walk_reference(p, leaves, walk)
    rx, re = saveall_walk_reference(p, leaves, walk)
    for i in range(2):
        one = lp if shared else leaves[i]
        op, oe = forward_walk_reference(p[i], one, walk)
        assert torch.equal(root_p[i], op) and torch.equal(root_e[i], oe)
        ox, oe2 = saveall_walk_reference(p[i], one, walk)
        assert torch.equal(rx[i], ox) and torch.equal(re[i], oe2)


@pytest.mark.parametrize("s", STATES)
def test_plain_walks_zero_padded_states(s):
    """The walks on S states padded with zero states (as the engines' entry
    points pad them) give the unpadded walk's partials on the S states,
    zeros past them, and its exponent counts."""
    walk, p, lp = _walk_inputs(s, seed=5)
    root_p, root_e = forward_walk_reference(p, lp, walk)
    rx, re = saveall_walk_reference(p, lp, walk)
    for s_pad in sorted({cuda_pruning.padded_states(s), 64}):
        pp = cuda_pruning._pad_states(p, s_pad, 2)
        lpp = cuda_pruning._pad_states(lp, s_pad, 1)
        got_p, got_e = forward_walk_reference(pp, lpp, walk)
        assert torch.equal(got_p[..., :s], root_p)
        assert torch.equal(got_e, root_e)
        assert not got_p[..., s:].any()
        gx, ge = saveall_walk_reference(pp, lpp, walk)
        assert torch.equal(gx[..., :s], rx) and torch.equal(ge, re)
