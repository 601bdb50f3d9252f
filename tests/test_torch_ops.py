"""Port parity, ops layer: the PyTorch port (``phylo_utils_tpu_torch``) held
against the JAX package on the same numpy-made inputs.

Tolerances: bit-exact where both sides do the same integer/bit work
(rescale, schedules, encodings); 1e-12 relative for the f64 gamma
discretization (two gammainc implementations, both at f64 roundoff);
1e-13 absolute for f64 P(t) entries (probabilities <= 1) and 1e-6 with an
f32 reconstruct (f32 rounding); 1e-12 relative for the f64 pruner.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import scipy.special
import torch

from phylo_utils_tpu import io as jio
from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu import trees as jtrees
from phylo_utils_tpu.ops import gamma as jgamma
from phylo_utils_tpu.ops import pmatrix as jpmatrix
from phylo_utils_tpu.ops import pruning as jpruning
from phylo_utils_tpu.ops.pallas_pruning import (
    _postorder_arrays as j_postorder_arrays,
)
from phylo_utils_tpu_torch import io as tio
from phylo_utils_tpu_torch import models as tmodels
from phylo_utils_tpu_torch import trees as ttrees
from phylo_utils_tpu_torch.ops import gamma as tgamma
from phylo_utils_tpu_torch.ops import pmatrix as tpmatrix
from phylo_utils_tpu_torch.ops import pruning as tpruning
from phylo_utils_tpu_torch.ops.cuda_pruning import (
    _postorder_arrays as t_postorder_arrays,
)

from torch_threads import one_thread  # noqa: F401

MULTIFURCATING = (
    "((a:0.1,b:0.2,c:0.05):0.1,(d:0.3,e:0.1,f:0.2,g:0.15):0.2,"
    "(h:0.1,(i:0.2,j:0.3):0.05):0.1,k:0.4,l:0.25);"
)


def _f32(values):
    return np.asarray(values, np.float32)


RESCALE_INPUTS = _f32([
    1.0, 2.0, 0.5, 2.0 ** -100, 2.0 ** 100, 2.0 ** -126, 2.0 ** 127,
    np.finfo(np.float32).tiny, np.finfo(np.float32).tiny * 1.5,
    1e-40, 1e-45, 3e-39,                     # subnormals
    1e30, 3.4e38, 0.75, 1.5, 1.0 - 2 ** -24, 123456.789, 7e-20,
])


def test_pow2_rescale_bit_exact():
    rng = np.random.default_rng(0)
    m = np.concatenate([RESCALE_INPUTS,
                        _f32(10.0 ** rng.uniform(-44, 38, 200))])
    js, je = jpruning.pow2_rescale(jnp.asarray(m))
    ts, te = tpruning.pow2_rescale(torch.from_numpy(m))
    assert ts.dtype == torch.float32 and te.dtype == torch.float32
    np.testing.assert_array_equal(
        ts.numpy().view(np.int32), np.asarray(js).view(np.int32))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_exp2_int_bit_exact():
    k = _f32(np.arange(-200, 201))
    j = np.asarray(jpruning.exp2_int(jnp.asarray(k)))
    t = tpruning.exp2_int(torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(t.view(np.int32), j.view(np.int32))


def _tree_pair(kind):
    if kind == "random":
        jt = jtrees.random_tree(12, seed=4)
        tt = ttrees.random_tree(12, seed=4)
    elif kind == "multifurcating":
        jt = jio.parse_newick(MULTIFURCATING)
        tt = tio.parse_newick(MULTIFURCATING)
    else:
        text = "(" * 19 + "t0:1.0" + "".join(
            f",t{i}:1.0):1.0" for i in range(1, 20)) + ";"
        jt, tt = jio.parse_newick(text), tio.parse_newick(text)
    return jt, tt


@pytest.mark.parametrize("kind", ["random", "multifurcating", "caterpillar"])
def test_schedules_and_postorder_arrays_identical(kind):
    jt, tt = _tree_pair(kind)
    assert jt.names == tt.names
    np.testing.assert_array_equal(jt.parent, tt.parent)
    np.testing.assert_array_equal(jt.lengths, tt.lengths)
    js, ts = jtrees.compile_schedule(jt), ttrees.compile_schedule(tt)
    for field in ("level_nodes", "level_children", "level_childmask"):
        np.testing.assert_array_equal(getattr(js, field), getattr(ts, field))
    assert (js.n_nodes, js.n_leaves, js.root) == (ts.n_nodes, ts.n_leaves,
                                                  ts.root)
    for a, b in zip(j_postorder_arrays(js), t_postorder_arrays(ts)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_compress_patterns_same_sites():
    rng = np.random.default_rng(2)
    names = [f"s{i}" for i in range(7)]
    aln = {n: "".join(rng.choice(list("ACGTRY-N"), size=150)) for n in names}
    aln["s1"] = aln["s0"][:75] + aln["s1"][75:]     # repeated columns
    j = jio.compress_patterns(aln, "dna")
    t = tio.compress_patterns(aln, "dna")
    assert t.names == j.names
    assert t.weights.sum() == j.weights.sum() == 150
    # pattern order may differ (numpy vs native); per-site rows may not
    np.testing.assert_array_equal(
        t.partials[:, t.site_to_pattern], j.partials[:, j.site_to_pattern])
    # the codon alphabet compresses codon columns, as the JAX package's
    codons = {n: v.replace("-", "N")[:150] for n, v in aln.items()}
    for n, v in codons.items():     # no stop codon: TAA/TAG/TGA -> TAC
        trip = [v[i:i + 3] for i in range(0, 150, 3)]
        codons[n] = "".join("TAC" if t in ("TAA", "TAG", "TGA", "TAR", "TRA")
                            or t[:2] in ("TA", "TR") else t for t in trip)
    jc = jio.compress_patterns(codons, "codon")
    tc = tio.compress_patterns(codons, "codon")
    np.testing.assert_array_equal(tc.partials, np.asarray(jc.partials))
    np.testing.assert_array_equal(tc.weights, np.asarray(jc.weights))


def test_gammainc_matches_scipy():
    a = np.array([0.05, 0.5, 1.0, 1.05, 5.0, 51.0, 300.0])
    x = np.concatenate([[0.0, 1e-12, 1e-3], np.geomspace(0.01, 600.0, 40)])
    aa, xx = np.meshgrid(a, x)
    got = tgamma.gammainc(torch.from_numpy(aa), torch.from_numpy(xx)).numpy()
    want = scipy.special.gammainc(aa, xx)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-300)


@functools.cache
def _jax_discrete_gamma(ncat, median):
    """JAX's ``discrete_gamma`` at (ncat, median), compiled once for the
    module: traced op by op it rebuilds its Newton scan at every call."""
    return jax.jit(lambda a: jgamma.discrete_gamma(a, ncat, median))


@pytest.mark.parametrize("alpha", [0.05, 0.5, 1.0, 5.0, 50.0])
def test_discrete_gamma_matches_jax(alpha):
    for ncat in (1, 4, 8):
        for median in (False, True):
            j = np.asarray(_jax_discrete_gamma(ncat, median)(
                jnp.asarray(alpha, jnp.float64)))
            t = tgamma.discrete_gamma(
                torch.tensor(alpha, dtype=torch.float64), ncat, median)
            assert t.dtype == torch.float64 and t.shape == (ncat,)
            np.testing.assert_allclose(t.numpy(), j, rtol=1e-12, atol=0,
                                       err_msg=f"ncat={ncat} median={median}")


MODEL_PARAMS = {
    "JC69": {},
    "K80": {"kappa": 3.3},
    "F81": {"freqs": [0.1, 0.4, 0.3, 0.2]},
    "F84": {"kappa": 1.7, "freqs": [0.35, 0.15, 0.2, 0.3]},
    "HKY85": {"kappa": 4.1, "freqs": [0.3, 0.2, 0.25, 0.25]},
    "TN93": {"alpha1": 3.0, "alpha2": 1.5, "beta": 0.8,
             "freqs": [0.22, 0.28, 0.31, 0.19]},
    "GTR": {"rates": [1.2, 3.1, 0.7, 0.9, 4.2, 1.0],
            "freqs": [0.3, 0.2, 0.22, 0.28]},
    "UNREST": {"rates": [0.5, 1.5, 0.7, 1.1, 0.3, 2.0,
                         1.3, 0.6, 0.9, 0.4, 1.8, 1.0]},
}


@pytest.mark.parametrize("name", sorted(MODEL_PARAMS))
def test_transition_matrices_match_jax(name):
    params = MODEL_PARAMS[name]
    jm = getattr(jmodels, name)
    tm = tmodels.get_model(name)
    t = np.array([[0.0, 1e-6, 0.01], [0.1, 0.4, 1.0]])   # (edges, K)
    jeig = jm.eigen({k: jnp.asarray(v, jnp.float64)
                     for k, v in params.items()}, dtype=jnp.float64)
    teig = tm.eigen(params, dtype=torch.float64)
    np.testing.assert_allclose(teig.q.numpy(), np.asarray(jeig.q),
                               rtol=0, atol=1e-13)
    j64 = np.asarray(jpmatrix.transition_matrices(jeig, jnp.asarray(t)))
    t64 = tpmatrix.transition_matrices(teig, torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(t64, j64, rtol=0, atol=1e-13)
    j32 = np.asarray(jpmatrix.transition_matrices(
        jeig, jnp.asarray(t), out_dtype=jnp.float32))
    t32 = tpmatrix.transition_matrices(
        teig, torch.from_numpy(t), out_dtype=torch.float32)
    assert t32.dtype == torch.float32
    np.testing.assert_allclose(t32.numpy(), j32, rtol=0, atol=1e-6)
    assert (t64 >= 0).all()
    # Longer branches against the exact expm: the JAX f64 eigensystem adds
    # a ~1e-13 tie-break jitter to the diagonal (a TPU eigh workaround the
    # port leaves out), which alone moves its P(3.0) by ~1e-13.
    q = teig.q.numpy()
    long_t = np.array([3.0, 10.0])
    exact = np.stack([scipy.linalg.expm(q * x) for x in long_t])
    t_long = tpmatrix.transition_matrices(teig, torch.from_numpy(long_t))
    np.testing.assert_allclose(t_long.numpy(), exact, rtol=0, atol=1e-13)


def test_extend_p_identity_matches_jax():
    p = np.random.default_rng(1).random((2, 5, 3, 4, 4))
    j = np.asarray(jpmatrix.extend_p_identity(jnp.asarray(p), 7))
    t = tpmatrix.extend_p_identity(torch.from_numpy(p), 7).numpy()
    np.testing.assert_array_equal(t, j)


def _prune_inputs(tree_kind, dtype):
    jt, tt = _tree_pair(tree_kind)
    js, ts = jtrees.compile_schedule(jt), ttrees.compile_schedule(tt)
    rng = np.random.default_rng(7)
    sites = 83
    lp = (rng.random((jt.n_leaves, sites, 4)) > 0.4).astype(dtype)
    lp[lp.sum(-1) == 0] = 1.0
    eig = tmodels.GTR.eigen(MODEL_PARAMS["GTR"])
    rates = np.array([0.1, 0.6, 1.2, 2.1])
    t = torch.from_numpy(tt.lengths[:, None] * rates[None, :])
    p = tpmatrix.transition_matrices(eig, t).numpy()
    p = tpmatrix.extend_p_identity(torch.from_numpy(p), ts.n_nodes).numpy()
    return js, ts, p.astype(dtype), lp


@pytest.mark.parametrize("tree_kind", ["random", "multifurcating"])
def test_make_prune_fn_f64_matches_jax(tree_kind):
    js, ts, p, lp = _prune_inputs(tree_kind, np.float64)
    jr, jsc = jax.jit(jpruning.make_prune_fn(js))(jnp.asarray(p),
                                                  jnp.asarray(lp))
    tr, tsc = tpruning.make_prune_fn(ts)(torch.from_numpy(p),
                                         torch.from_numpy(lp))
    assert tr.shape == jr.shape and tsc.shape == jsc.shape
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-12,
                               atol=1e-300)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-12,
                               atol=1e-12)


def test_make_prune_fn_batched_equals_loop():
    _, ts, p, lp = _prune_inputs("random", np.float64)
    prune = tpruning.make_prune_fn(ts)
    pb = torch.from_numpy(np.stack([p, p ** 1.01, p * 0.9]))
    rb, sb = prune(pb, torch.from_numpy(lp))
    for b in range(3):
        r, s = prune(pb[b], torch.from_numpy(lp))
        np.testing.assert_allclose(rb[b].numpy(), r.numpy(), rtol=1e-14)
        np.testing.assert_allclose(sb[b].numpy(), s.numpy(), rtol=1e-14,
                                   atol=1e-14)


def test_mixture_reductions_match_jax():
    rng = np.random.default_rng(3)
    root = rng.random((4, 50, 4)) + 0.01
    ls = -rng.integers(0, 40, (4, 50)).astype(np.float64)
    freqs = np.array([0.3, 0.2, 0.22, 0.28])
    w = rng.integers(1, 5, 50).astype(np.float64)
    cw = np.full(4, 0.25)
    inv = np.where(rng.random(50) > 0.7, rng.random(50) * 1e-3, 0.0)
    j = jpruning.mixture_loglik(*map(jnp.asarray, (root, ls, freqs, cw, w)),
                                pinv=jnp.asarray(0.2),
                                inv_lik=jnp.asarray(inv))
    t = tpruning.mixture_loglik(*map(torch.from_numpy,
                                     (root, ls, freqs, cw, w)),
                                pinv=torch.tensor(0.2, dtype=torch.float64),
                                inv_lik=torch.from_numpy(inv))
    np.testing.assert_allclose(float(t[0]), float(j[0]), rtol=1e-13)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=1e-13)
    ll = np.log(root @ freqs) + ls
    j = jpruning.mixture_loglik_from_ll(jnp.asarray(ll), jnp.asarray(cw),
                                        jnp.asarray(w))
    t = tpruning.mixture_loglik_from_ll(torch.from_numpy(ll),
                                        torch.from_numpy(cw),
                                        torch.from_numpy(w))
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=1e-13)
    j_inv = np.asarray(jpruning.invariant_site_likelihood(
        jnp.asarray(root), jnp.asarray(freqs)))
    t_inv = tpruning.invariant_site_likelihood(torch.from_numpy(root),
                                               torch.from_numpy(freqs))
    np.testing.assert_allclose(t_inv.numpy(), j_inv, rtol=1e-13)


def test_model_registry_and_spec():
    model, ncat, inv, emp, rm = tmodels.parse_model_spec("GTR+G4+I")
    assert (model.name, ncat, inv, emp, rm) == ("GTR", 4, True, False,
                                                "gamma")
    assert tmodels.parse_model_spec("hky85+R3")[1:] == (3, False, False,
                                                        "free")
    assert tmodels.get_model("lg") is tmodels.LG
    assert tmodels.get_model("WAG") is tmodels.WAG
    for name, states in (("GY94", 61), ("MG94", 61), ("MK4", 4),
                         ("ORDERED5", 5)):
        assert tmodels.get_model(name).n_states == states
        assert tmodels.parse_model_spec(name + "+G4")[0].name == name
    with pytest.raises(ValueError):
        tmodels.get_model("nonsense")
