"""Port parity, gradients: the reverse rule of P(t), d(rates)/d(alpha), and
``LikelihoodEngine.value_and_grad`` of the PyTorch port against the JAX
package (``jax.grad`` / ``jax.jacfwd`` / the engine's ``value_and_grad``)
and against central finite differences, on numpy-made inputs.

Tolerances: float64 ops 1e-10 relative to the largest entry (the JAX
eigensystem carries a ~1e-13 tie-break jitter); the f32 engine (walk in
float32) 1e-4 relative on the value and 5e-4 x max|g| per gradient leaf,
as the JAX package holds its own Pallas gradients to its XLA ones; the f64
engine 1e-10 relative; finite differences at the JAX package's own
tolerances (``tests/test_gradients.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu.likelihood import LikelihoodEngine as JaxEngine
from phylo_utils_tpu.ops import gamma as jgamma
from phylo_utils_tpu.ops import pmatrix as jpmatrix
from phylo_utils_tpu.trees import random_tree
from phylo_utils_tpu_torch import io as tio
from phylo_utils_tpu_torch import models as tmodels
from phylo_utils_tpu_torch import trees as ttrees
from phylo_utils_tpu_torch.convert import flatten_params, params_from_jax
from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
from phylo_utils_tpu_torch.ops import cuda_pruning
from phylo_utils_tpu_torch.ops import gamma as tgamma
from phylo_utils_tpu_torch.ops import pmatrix as tpmatrix

from torch_threads import one_thread  # noqa: F401

MODELS = {
    "JC69": {},
    "K80": {"kappa": 2.5},
    "HKY85": {"kappa": 3.0, "freqs": [0.1, 0.2, 0.3, 0.4]},
    "GTR": {"rates": [1.2, 3.1, 0.7, 0.9, 4.2, 1.0],
            "freqs": [0.3, 0.2, 0.22, 0.28]},
}


def _port_tree(jtree):
    return ttrees.Tree(jtree.names, jtree.parent, jtree.lengths,
                       jtree.children, jtree.n_leaves)


def _port_alignment(ca):
    return tio.CompressedAlignment(
        ca.names, np.asarray(ca.partials), np.asarray(ca.weights),
        np.asarray(ca.site_to_pattern))


def _assert_close_rel_max(got, want, tol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * (np.abs(want).max() + 1e-300),
                               err_msg=name)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_p_matrices_reversible_grad_matches_jax(name):
    """d/d(model params, t) of sum(W * P(t)) through the reverse rule
    against jax.grad through the JAX custom JVP; JC69/K80 have degenerate
    eigenvalues."""
    rng = np.random.default_rng(0)
    t = rng.uniform(0.01, 2.0, (5, 4))
    w = rng.normal(size=(5, 4, 4, 4))
    jmod, tmod = getattr(jmodels, name), tmodels.get_model(name)

    def jloss(params, tt):
        sym, fr = jmod.build_parts(params, dtype=jnp.float64)
        return jnp.sum(jpmatrix.p_matrices_reversible(sym, fr, tt) * w)

    jp = {k: jnp.asarray(v, jnp.float64) for k, v in MODELS[name].items()}
    gj_params, gj_t = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jp, jnp.asarray(t))
    tp = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
          for k, v in MODELS[name].items()}
    tt = torch.tensor(t, requires_grad=True)
    sym, fr = tmod.build_parts(tp)
    p = tpmatrix.p_matrices_reversible(sym, fr, tt)
    # same value as the forward-only path
    np.testing.assert_allclose(
        p.detach().numpy(),
        tpmatrix.transition_matrices(tmod.eigen(MODELS[name]), tt.detach())
        .numpy(), rtol=0, atol=1e-15)
    (p * torch.from_numpy(w)).sum().backward()
    _assert_close_rel_max(tt.grad, gj_t, 1e-10, "t")
    for k in MODELS[name]:
        _assert_close_rel_max(tp[k].grad, gj_params[k], 1e-10, k)


def test_exp_divided_difference_matches_jax_and_stays_finite():
    rng = np.random.default_rng(1)
    x = -rng.uniform(0, 30, 500)
    y = -rng.uniform(0, 30, 500)
    y[:50] = x[:50] + rng.normal(0, 1e-7, 50)       # the series branch
    want = np.asarray(jpmatrix._exp_divided_difference(jnp.asarray(x),
                                                       jnp.asarray(y)))
    got = tpmatrix._exp_divided_difference(torch.tensor(x),
                                           torch.tensor(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13)
    # a 3000-unit branch in a fast category: (e^x - e^y)/(x - y) stays
    # finite where e^{(x+y)/2} sinh((x-y)/2) is 0 x inf
    far = tpmatrix._exp_divided_difference(
        torch.tensor([-3000.0, 0.0, -2000.0], dtype=torch.float64),
        torch.tensor([0.0, -3000.0, -2001.0], dtype=torch.float64))
    np.testing.assert_allclose(far.numpy(), [1 / 3000, 1 / 3000, 0.0],
                               rtol=1e-15, atol=0)


def test_dp_d2p_matrices_match_jax():
    params = MODELS["GTR"]
    t = np.array([0.0, 0.03, 0.4, 2.5])
    jeig = jmodels.GTR.eigen({k: jnp.asarray(v) for k, v in params.items()},
                             dtype=jnp.float64)
    teig = tmodels.GTR.eigen(params)
    for jf, tf in ((jpmatrix.dp_matrices, tpmatrix.dp_matrices),
                   (jpmatrix.d2p_matrices, tpmatrix.d2p_matrices)):
        np.testing.assert_allclose(tf(teig, torch.from_numpy(t)).numpy(),
                                   np.asarray(jf(jeig, jnp.asarray(t))),
                                   rtol=0, atol=1e-12)


@functools.cache
def _jax_discrete_gamma_jacobian(ncat, median):
    """jax.jacfwd of JAX's ``discrete_gamma`` at (ncat, median), compiled
    once for the module: traced op by op it rebuilds its Newton scan at
    every call."""
    return jax.jit(jax.jacfwd(
        lambda a: jgamma.discrete_gamma(a, ncat, median)))


@pytest.mark.parametrize("alpha", [0.2, 0.5, 2.0, 50.0])
def test_discrete_gamma_alpha_grad_matches_jax(alpha):
    """Plain autograd through the port's own gammainc (series / continued
    fraction, unrolled Newton quantile) against jax.jacfwd, 1e-10
    relative."""
    for ncat, median in ((4, False), (8, False), (4, True)):
        want = np.asarray(_jax_discrete_gamma_jacobian(ncat, median)(
            jnp.float64(alpha)))
        got = torch.autograd.functional.jacobian(
            lambda a: tgamma.discrete_gamma(a, ncat, median),
            torch.tensor(alpha, dtype=torch.float64))
        _assert_close_rel_max(got, want, 1e-10, f"ncat={ncat} {median}")


def test_gammainc_large_shape_matches_scipy():
    """Shapes from 1e4 up take the quadrature (the series would need ~9
    sqrt(a) terms): within 2e-10 of scipy, and the rates stay finite and
    close to JAX's at alpha = 1e4 and 1e5 (1e-8 relative)."""
    for a in (1e4, 3e4, 1e5, 1e6):
        x = a + np.sqrt(a) * np.array([-8.0, -3, -1, -0.1, 0, 0.1, 1, 3, 8])
        got = tgamma.gammainc(torch.tensor(a, dtype=torch.float64),
                              torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, scipy.special.gammainc(a, x),
                                   rtol=0, atol=2e-10)
    for alpha in (1e4, 1e5):
        got = tgamma.discrete_gamma(torch.tensor(alpha, dtype=torch.float64),
                                    4).numpy()
        want = np.asarray(jax.jit(jgamma.discrete_gamma, static_argnums=1)(
            jnp.float64(alpha), 4))
        np.testing.assert_allclose(got, want, rtol=1e-8)


# -- engine ----------------------------------------------------------------


@pytest.fixture(scope="module")
def gappy12():
    """tests/test_pallas_pruning.py::test_fused_loglik_value_and_grad_match_xla's
    problem: 12 taxa, 97 sites with gaps, GTR+G4+I, non-default params."""
    jtree = random_tree(12, seed=11)
    rng = np.random.default_rng(3)
    aln = {n: "".join(rng.choice(list("ACGT-N"), size=97))
           for n in jtree.leaf_names}
    kw = dict(ncat=4, invariant_sites=True)
    j32 = JaxEngine(jtree, aln, jmodels.GTR, dtype="float32",
                    pruner="pallas", **kw)
    p = j32.default_params()
    p["branch_lengths"] = np.abs(rng.normal(0.15, 0.1, jtree.n_nodes)) + 1e-3
    p["model"] = dict(MODELS["GTR"])
    p["alpha"], p["pinv"] = 0.7, 0.15
    full = jax.tree.map(np.asarray, j32._full_params(p))
    return dict(jtree=jtree, aln=aln, kw=kw, j32=j32, p=p, full=full,
                tree=_port_tree(jtree), ca=_port_alignment(j32._compressed))


def _flat(grads):
    return dict(zip(*flatten_params(grads)))


@pytest.mark.parametrize("pruner", ["cuda", "torch"])
def test_value_and_grad_matches_jax_pallas(gappy12, pruner):
    """f32 port (walk kernel's plain versions on CPU, or the plain pruner)
    against the JAX f32 Pallas engine's value_and_grad."""
    lj, gj = gappy12["j32"].value_and_grad(gappy12["p"])
    port = LikelihoodEngine(gappy12["tree"], gappy12["ca"], tmodels.GTR,
                            dtype=torch.float32, pruner=pruner,
                            **gappy12["kw"], device="cpu")
    before = cuda_pruning.LAUNCHES
    lt, gt = port.value_and_grad(params_from_jax(gappy12["full"]))
    assert cuda_pruning.LAUNCHES == before          # CPU: no kernel launch
    assert lt.dtype == torch.float64 and lt.dim() == 0
    assert abs(float(lt) - float(lj)) < 1e-4 * abs(float(lj))
    want = _flat(jax.tree.map(np.asarray, gj))
    got = _flat(gt)
    assert set(got) == set(want)
    for path, g in got.items():
        assert g.dtype == torch.float32, path
        _assert_close_rel_max(g.numpy(), want[path], 5e-4, str(path))
    np.testing.assert_allclose(port.gradient(gappy12["full"])["alpha"],
                               gt["alpha"], rtol=1e-6)


@pytest.mark.parametrize("pruner", ["cuda", "torch"])
def test_value_and_grad_many_matches_single_calls(gappy12, pruner):
    """B branch-length sets in one batched pass: each set's value and
    branch-length gradient equal its own call's (f32 walk: 1e-6 relative
    and 1e-4 x max|g|, batched and single reductions round differently);
    the model gradients are the batch sums."""
    port = LikelihoodEngine(gappy12["tree"], gappy12["ca"], tmodels.GTR,
                            dtype=torch.float32, pruner=pruner,
                            **gappy12["kw"], device="cpu")
    params = params_from_jax(gappy12["full"])
    bl = np.asarray(gappy12["full"]["branch_lengths"])[None] * np.array(
        [[0.5], [1.0], [2.0]])
    totals, grads = port.value_and_grad_many(bl, params)
    assert totals.shape == (3,) and grads["branch_lengths"].shape == bl.shape
    singles = [port.value_and_grad({**params, "branch_lengths": b})
               for b in bl]
    np.testing.assert_allclose(totals.numpy(),
                               [float(v) for v, _ in singles], rtol=1e-6)
    # the value path reconstructs P in float32 from the cached
    # eigensystem, the gradient path rebuilds it in float64: 1e-7
    np.testing.assert_allclose(port.loglikelihood_many(bl, params),
                               totals.numpy(), rtol=1e-7)
    for b, (_, g) in enumerate(singles):
        _assert_close_rel_max(grads["branch_lengths"][b].numpy(),
                              g["branch_lengths"].numpy(), 1e-4, str(b))
    _assert_close_rel_max(grads["alpha"].numpy(),
                          sum(g["alpha"] for _, g in singles).numpy(), 1e-4)
    with pytest.raises(ValueError, match="branch_length_sets"):
        port.value_and_grad_many(bl[:, :-1], params)


def test_f64_value_and_grad_matches_jax_xla(gappy12):
    j64 = JaxEngine(gappy12["jtree"], gappy12["aln"], jmodels.GTR,
                    dtype="float64", **gappy12["kw"])
    lj, gj = j64.value_and_grad(gappy12["p"])
    port = LikelihoodEngine(gappy12["tree"], gappy12["ca"], tmodels.GTR,
                            dtype=torch.float64, pruner="torch",
                            **gappy12["kw"], device="cpu")
    full = jax.tree.map(np.asarray, j64._full_params(gappy12["p"]))
    lt, gt = port.value_and_grad(params_from_jax(full))
    assert abs(float(lt) - float(lj)) < 1e-10 * abs(float(lj))
    want = _flat(jax.tree.map(np.asarray, gj))
    for path, g in _flat(gt).items():
        _assert_close_rel_max(g.numpy(), want[path], 1e-10, str(path))


@pytest.mark.parametrize("name,params", [
    ("UNREST", {"rates": [0.5, 1.5, 0.7, 1.1, 0.3, 2.0,
                          1.3, 0.6, 0.9, 0.4, 1.8, 1.0]}),
    ("K80", {"kappa": 3.3}),
])
def test_other_models_gradient_matches_jax(gappy12, name, params):
    """The non-reversible model differentiates through build_parts and
    matrix_exp; K80's Q has degenerate eigenvalues. f64, 1e-9 x max|g|
    (UNREST: scaling-and-squaring expm on both sides)."""
    p = {"model": params, "alpha": 1.3}
    j = JaxEngine(gappy12["jtree"], gappy12["aln"], getattr(jmodels, name),
                  ncat=4, dtype="float64")
    port = LikelihoodEngine(gappy12["tree"], gappy12["ca"],
                            tmodels.get_model(name), ncat=4, device="cpu")
    want = _flat(jax.tree.map(np.asarray, j.gradient(p)))
    for path, g in _flat(port.gradient(p)).items():
        _assert_close_rel_max(g.numpy(), want[path], 1e-9, str(path))


def _fd_grad(fn, x, h=1e-6):
    x = np.asarray(x, dtype=np.float64)
    g = np.zeros_like(x)
    for i in range(x.size):
        xp, xm = x.copy().ravel(), x.copy().ravel()
        xp[i] += h
        xm[i] -= h
        g.ravel()[i] = (fn(xp.reshape(x.shape))
                        - fn(xm.reshape(x.shape))) / (2 * h)
    return g


def test_model_parameter_gradients_vs_fd():
    """Mirrors tests/test_gradients.py::test_model_parameter_gradients_vs_fd
    (f64, the JAX test's tolerances)."""
    tree = _port_tree(random_tree(8, seed=5, mean_brlen=0.1))
    rng = np.random.default_rng(1)
    aln = {n: "".join(rng.choice(list("ACGT"), size=60))
           for n in tree.leaf_names}
    engine = LikelihoodEngine(tree, aln, tmodels.GTR, ncat=4,
                              invariant_sites=True, device="cpu")
    p0 = {"alpha": 0.8, "pinv": 0.1,
          "model": {"rates": [1.5, 4.0, 0.8, 1.2, 5.0, 1.0],
                    "freqs": [0.35, 0.2, 0.18, 0.27]}}
    g = engine.gradient(p0)

    def ll_model(key):
        return lambda v: engine.loglikelihood(
            {**p0, "model": {**p0["model"], key: v}})

    np.testing.assert_allclose(
        g["model"]["rates"].numpy(),
        _fd_grad(ll_model("rates"), p0["model"]["rates"]),
        rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(
        g["model"]["freqs"].numpy(),
        _fd_grad(ll_model("freqs"), p0["model"]["freqs"]),
        rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(
        g["alpha"].numpy(),
        _fd_grad(lambda a: engine.loglikelihood({**p0, "alpha": a[()]}),
                 p0["alpha"]), rtol=1e-4)
    np.testing.assert_allclose(
        g["pinv"].numpy(),
        _fd_grad(lambda x: engine.loglikelihood({**p0, "pinv": x[()]}),
                 p0["pinv"]), rtol=1e-4)
    bl = np.asarray(tree.lengths)
    np.testing.assert_allclose(
        g["branch_lengths"].numpy(),
        _fd_grad(lambda b: engine.loglikelihood({**p0, "branch_lengths": b}),
                 bl), rtol=2e-5, atol=1e-7)


def test_kappa_gradient_vs_fd():
    """Mirrors tests/test_gradients.py::test_kappa_gradient_vs_fd: K80's
    degenerate eigenvalues through the reverse rule."""
    tree = _port_tree(random_tree(6, seed=9, mean_brlen=0.15))
    rng = np.random.default_rng(2)
    aln = {n: "".join(rng.choice(list("ACGT"), size=50))
           for n in tree.leaf_names}
    engine = LikelihoodEngine(tree, aln, tmodels.K80, device="cpu")
    g = engine.gradient({"model": {"kappa": 2.5}})["model"]["kappa"]
    fd = _fd_grad(lambda k: engine.loglikelihood({"model": {"kappa": k[()]}}),
                  np.asarray(2.5))
    np.testing.assert_allclose(g.numpy(), fd, rtol=1e-6)
