"""Port parity, morphology: the Mk family (``MK<k>``, ``ORDERED<k>``) and the
ascertainment-bias corrections (``AscertainmentEngine``: lewis,
felsenstein, stamatakis) in the PyTorch port against the JAX package, on the
same random variable-only character matrices (7 taxa x 48 characters,
``?`` and ``-`` ambiguous), +G4.

Tolerances: the f64 port (``pruner="torch"``) against the JAX f64 XLA
engine, 1e-10 relative on logL and per site, 1e-10 x max|g| per gradient
leaf; the f32 walk (``pruner="cuda"``: its plain versions on the CPU, the
states padded to the compiled widths: 2 -> 4, 5 and 6 -> 20, 24 -> 64)
against the same f64 reference, 1e-6 relative on logL and per site (the
BASELINE limit) and 5e-4 x max|g| per gradient leaf. The Lewis identity
(corrected pattern likelihoods over all variable patterns sum to 1) to
1e-10.
"""
import itertools

import jax
import numpy as np
import pytest
import torch

from phylo_utils_tpu.ascertainment import AscertainmentEngine as JaxAsc
from phylo_utils_tpu.likelihood import LikelihoodEngine as JaxEngine
from phylo_utils_tpu.models import get_model as jget_model
from phylo_utils_tpu.models.morphology import (
    multistate_alphabet as jmultistate_alphabet,
)
from phylo_utils_tpu.trees import random_tree
from phylo_utils_tpu_torch import models as tmodels
from phylo_utils_tpu_torch import trees as ttrees
from phylo_utils_tpu_torch.ascertainment import AscertainmentEngine
from phylo_utils_tpu_torch.convert import flatten_params, params_from_jax
from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
from phylo_utils_tpu_torch.models.morphology import (
    MAX_MORPH_STATES,
    mk_model,
    multistate_alphabet,
)
from phylo_utils_tpu_torch.ops import cuda_pruning

from torch_threads import one_thread  # noqa: F401

STATES = "0123456789ABCDEFGHIJKLMNOPQRSTUV"
TREE3 = "(a:0.2,b:0.35,c:0.15);"


def _variable_matrix(names, n_chars, k, seed):
    """Random characters of ``k`` states, every column variable, a few
    cells ``?`` or ``-``."""
    rng = np.random.default_rng(seed)
    cols = []
    while len(cols) < n_chars:
        col = rng.integers(0, k, len(names))
        if len(set(col.tolist())) > 1:
            cols.append(col)
    chars = np.array([[STATES[s] for s in col] for col in cols]).T
    chars[rng.random(chars.shape) < 0.03] = "?"
    chars[0, 0] = "-"
    return {n: "".join(row) for n, row in zip(names, chars)}


def _flat(grads):
    return dict(zip(*flatten_params(grads)))


def _jax_reference(j64, jp):
    """The JAX f64 engine's values at ``jp``, made once per model and held
    against both of the port's pruners."""
    lj, gj = j64.value_and_grad(jp)
    return dict(
        params=params_from_jax(jax.tree.map(np.asarray,
                                            j64._full_params(jp))),
        loglik=j64.loglikelihood(jp),
        sitewise=np.asarray(j64.sitewise_loglikelihoods(jp)),
        value=float(lj), grads=_flat(jax.tree.map(np.asarray, gj)))


def _check_pair(ref, port, tol, grad_tol):
    """logL, sitewise and value_and_grad of ``port`` against ``ref``."""
    params = ref["params"]
    got = port.loglikelihood(params)
    want = ref["loglik"]
    assert np.isfinite(got) and abs(got - want) / abs(want) < tol
    np.testing.assert_allclose(port.sitewise_loglikelihoods(params),
                               ref["sitewise"], rtol=tol, atol=0)
    lt, gt = port.value_and_grad(params)
    assert abs(float(lt) - ref["value"]) < tol * abs(ref["value"])
    got_g = _flat(gt)
    assert set(got_g) == set(ref["grads"])
    for path, g in got_g.items():
        w = ref["grads"][path]
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0,
                                   atol=grad_tol * np.abs(w).max(),
                                   err_msg=str(path))


@pytest.fixture(scope="module")
def tree7():
    jtree = random_tree(7, seed=11, mean_brlen=0.25)
    return jtree, ttrees.Tree(jtree.names, jtree.parent, jtree.lengths,
                              jtree.children, jtree.n_leaves)


@pytest.fixture(scope="module", params=[("MK2", 2), ("MK6", 6),
                                        ("ORDERED5", 5)],
                ids=["MK2", "MK6", "ORDERED5"])
def mk_problem(request, tree7):
    name, k = request.param
    jtree, tree = tree7
    aln = _variable_matrix(jtree.leaf_names, 48, k, seed=k)
    j64 = JaxEngine(jtree, aln, jget_model(name), ncat=4, dtype="float64")
    return name, tree, aln, _jax_reference(j64, {"alpha": 0.8})


@pytest.fixture(scope="module", params=[
    ("lewis", None), ("felsenstein", 37.0),
    ("stamatakis", [11.0, 4.0, 9.0])],
    ids=["lewis", "felsenstein", "stamatakis"])
def asc_problem(request, tree7):
    correction, counts = request.param
    jtree, tree = tree7
    aln = _variable_matrix(jtree.leaf_names, 48, 3, seed=7)
    j64 = JaxAsc(jtree, aln, jget_model("MK3"), correction=correction,
                 const_counts=counts, ncat=4, dtype="float64")
    return correction, counts, tree, aln, _jax_reference(j64, {"alpha": 0.6})


PRUNERS = [("torch", torch.float64, 1e-10, 1e-10),
           ("cuda", torch.float32, 1e-6, 5e-4)]


@pytest.mark.parametrize("pruner,dtype,tol,grad_tol", PRUNERS)
def test_mk_engine_matches_jax_xla(mk_problem, pruner, dtype, tol,
                                   grad_tol):
    name, tree, aln, ref = mk_problem
    port = LikelihoodEngine(tree, aln, tmodels.get_model(name), ncat=4,
                            dtype=dtype, pruner=pruner, device="cpu")
    _check_pair(ref, port, tol, grad_tol)


@pytest.mark.parametrize("pruner,dtype,tol,grad_tol", PRUNERS)
def test_ascertainment_engine_matches_jax(asc_problem, pruner, dtype, tol,
                                          grad_tol):
    correction, counts, tree, aln, ref = asc_problem
    port = AscertainmentEngine(tree, aln, tmodels.get_model("MK3"),
                               correction=correction, const_counts=counts,
                               ncat=4, dtype=dtype, pruner=pruner,
                               device="cpu")
    _check_pair(ref, port, tol, grad_tol)


def test_lewis_corrected_likelihoods_sum_to_one():
    """Over ALL variable binary patterns of 3 taxa the corrected pattern
    likelihoods sum to 1, through the padded f32 walk too (1e-6)."""
    pats = [p for p in itertools.product("01", repeat=3) if len(set(p)) > 1]
    aln = {n: "".join(p[i] for p in pats) for i, n in enumerate("abc")}
    for kw, tol in ((dict(dtype=torch.float64), 1e-10),
                    (dict(dtype=torch.float32, pruner="cuda"), 1e-6)):
        eng = AscertainmentEngine(TREE3, aln, mk_model(2), ncat=4,
                                  device="cpu", **kw)
        sw = eng.sitewise_loglikelihoods({"alpha": 0.5}, per_pattern=True)
        assert abs(np.exp(sw).sum() - 1.0) < tol


def test_ascertainment_refusals_match_jax():
    pats = [p for p in itertools.product("01", repeat=3) if len(set(p)) > 1]
    aln = {n: "".join(p[i] for p in pats) for i, n in enumerate("abc")}
    const = {k: v + "1" for k, v in aln.items()}
    for bad, match in (
            (dict(alignment=const), "constant"),
            (dict(invariant_sites=True), r"\+I"),
            (dict(correction="nope"), "correction"),
            (dict(const_counts=3.0), "const_counts"),
            (dict(correction="stamatakis", const_counts=[1.0]), "per-state"),
            (dict(correction="felsenstein", const_counts=-1.0), ">= 0")):
        kw = {"alignment": aln, **bad}
        with pytest.raises(ValueError, match=match):
            AscertainmentEngine(TREE3, model=mk_model(2), device="cpu", **kw)
        with pytest.raises(ValueError, match=match):
            JaxAsc(TREE3, model=jget_model("MK2"), **kw)


@pytest.mark.parametrize("k", [2, 12, MAX_MORPH_STATES])
def test_multistate_alphabet_and_models_match_jax(k):
    got, want = multistate_alphabet(k), jmultistate_alphabet(k)
    assert (got.name, got.states, dict(got.charmap)) == (
        want.name, want.states, dict(want.charmap))
    for ordered in (False, True):
        port = mk_model(k, ordered=ordered)
        jax_m = jget_model(f"{'ORDERED' if ordered else 'MK'}{k}")
        assert port.name == jax_m.name and port.n_states == k
        sym, freqs = port.build_parts()
        jsym, jfreqs = jax_m.build_parts()
        np.testing.assert_array_equal(sym.numpy(), np.asarray(jsym))
        np.testing.assert_array_equal(freqs.numpy(), np.asarray(jfreqs))
    assert tmodels.get_model(f"mk{k}") is mk_model(k, ordered=False)
    with pytest.raises(ValueError):
        multistate_alphabet(MAX_MORPH_STATES + 1)
    with pytest.raises(ValueError):
        tmodels.get_model("MKx")


def test_mk24_runs_padded_to_64_states(tree7, monkeypatch):
    """MK24 (24 states) runs through the padded walk at 64 states: the
    value call takes the stream walk, the gradient saveall and the deferred
    reverse, each at 64; f32 against the f64 engine (1e-6 on logL, 5e-4 x
    max|g|)."""
    jtree, tree = tree7
    aln = _variable_matrix(jtree.leaf_names, 24, 24, seed=24)
    seen = []
    for name in ("slot_walk_reference", "saveall_walk_reference",
                 "reverse_walk_reference", "forward_walk_reference"):
        orig = getattr(cuda_pruning, name)

        def spy(p, leaves, *a, _orig=orig, _name=name, **kw):
            seen.append((_name, leaves.shape[-1]))
            return _orig(p, leaves, *a, **kw)

        monkeypatch.setattr(cuda_pruning, name, spy)
    f64 = LikelihoodEngine(tree, aln, mk_model(24), ncat=4,
                           dtype=torch.float64, device="cpu")
    f32 = LikelihoodEngine(tree, aln, mk_model(24), ncat=4,
                           dtype=torch.float32, pruner="cuda", device="cpu")
    p = {"alpha": 0.7}
    want = f64.loglikelihood(p)
    assert abs(f32.loglikelihood(p) - want) < 1e-6 * abs(want)
    assert seen == [("slot_walk_reference", 64)]
    seen.clear()
    lw, gw = f64.value_and_grad(p)
    lg, gg = f32.value_and_grad(p)
    assert seen == [("saveall_walk_reference", 64),
                    ("reverse_walk_reference", 64)]
    for key in ("branch_lengths", "alpha"):
        w = gw[key].numpy()
        np.testing.assert_allclose(gg[key].double().numpy(), w, rtol=0,
                                   atol=5e-4 * np.abs(w).max())
