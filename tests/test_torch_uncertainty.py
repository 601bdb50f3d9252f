"""Port parity, uncertainty and de-novo trees: the rest of A10
(``newton_branch_length``, ``golden_section``, ``brent_minimize``,
``ml_distance_matrix``, ``fit_multistart``, ``fisher_covariance`` /
``standard_errors``) and ``nj.neighbor_joining``, against their twins in
the JAX package on the inputs of ``tests/test_optimize.py`` and
``tests/test_nj.py``.

Tolerances: 1e-10 relative in float64 where both packages compute the same
thing the same way (branch derivatives, Newton, the 1-D minimizers, ML
distances); NJ trees are identical. Standard errors where one package takes
the exact Hessian and the other central differences of the exact gradient
agree to 1e-4 relative (the difference's O(h^2) truncation at h = 6e-6
relative); where both take differences, to 1e-7 relative (the gradients'
roundoff over 2h). Which branch each package takes is asserted in each
case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu import optimize as jopt
from phylo_utils_tpu.io import parse_newick as j_parse_newick
from phylo_utils_tpu.likelihood import LikelihoodEngine as JaxEngine
from phylo_utils_tpu.nj import neighbor_joining as j_neighbor_joining
from phylo_utils_tpu.simulate import simulate_alignment
from phylo_utils_tpu.trees import random_tree as j_random_tree
from phylo_utils_tpu_torch import models
from phylo_utils_tpu_torch import optimize as topt
from phylo_utils_tpu_torch import trees as ttrees
from phylo_utils_tpu_torch.convert import (
    flatten_params,
    params_from_jax,
    params_to_numpy,
)
from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
from phylo_utils_tpu_torch.nj import neighbor_joining

from torch_threads import one_thread  # noqa: F401

F64 = 1e-10


def _port_tree(jtree):
    return ttrees.Tree(jtree.names, jtree.parent, jtree.lengths,
                       jtree.children, jtree.n_leaves)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-300))


def _pair_inputs():
    """The inputs of ``test_newton_branch_length_matches_scan_optimum``."""
    rng = np.random.default_rng(0)
    a = np.maximum((rng.random((60, 4)) > 0.5).astype(float), 1e-6)
    b = np.maximum((rng.random((60, 4)) > 0.5).astype(float), 1e-6)
    return a, b, np.ones(60)


@pytest.mark.parametrize("t", [1e-3, 0.1, 0.5, 2.0])
def test_branch_lnl_derivs_match_jax(t):
    a, b, w = _pair_inputs()
    jeig = jmodels.HKY85.eigen({"kappa": 2.0}, dtype=jnp.float64)
    teig = models.HKY85.eigen({"kappa": 2.0})
    want = jopt._branch_lnl_derivs(jeig, jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(w), jnp.asarray(t))
    got = topt._branch_lnl_derivs(teig, torch.from_numpy(a),
                                  torch.from_numpy(b), torch.from_numpy(w), t)
    for name, g, v in zip(("lnL", "d1", "d2"), got, want):
        assert _rel(g.numpy(), v) <= F64, name


def test_newton_branch_length_matches_jax_single_and_batched():
    a, b, w = _pair_inputs()
    jeig = jmodels.HKY85.eigen({"kappa": 2.0}, dtype=jnp.float64)
    teig = models.HKY85.eigen({"kappa": 2.0})
    jt, jl = jopt.newton_branch_length(jeig, jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(w), t0=0.5)
    tt, tl = topt.newton_branch_length(teig, torch.from_numpy(a),
                                       torch.from_numpy(b),
                                       torch.from_numpy(w), t0=0.5)
    assert tt.shape == () and _rel(tt, jt) <= F64 and _rel(tl, jl) <= F64
    # a batch of branches: each row is its own Newton iteration
    pa = torch.from_numpy(np.stack([a, b, a]))
    pb = torch.from_numpy(np.stack([b, a, a]))
    bt, bl = topt.newton_branch_length(teig, pa, pb, torch.from_numpy(w),
                                       t0=0.5)
    assert bt.shape == (3,)
    assert _rel(bt[:2], [float(tt)] * 2) <= F64
    assert _rel(bl[:2], [float(tl)] * 2) <= F64
    assert float(bt[2]) < 0.05          # identical sequences: t -> 0


FUNCTIONS = {
    "quadratic": lambda x: (x - 1.234) ** 2 + 0.5,
    "quartic": lambda x: (x - 0.3) ** 4 - x * 0.01 + 2.0,
}


@pytest.mark.parametrize("fn", sorted(FUNCTIONS))
@pytest.mark.parametrize("which", ["golden_section", "brent_minimize"])
def test_1d_minimizers_match_jax(which, fn):
    f = FUNCTIONS[fn]
    jx, jf = getattr(jopt, which)(f, 0.0, 10.0)
    tx, tf = getattr(topt, which)(f, 0.0, 10.0)
    assert tx.dtype == torch.float64 and tf.dtype == torch.float64
    assert abs(float(tx) - float(jx)) <= F64 * max(abs(float(jx)), 1.0)
    assert abs(float(tf) - float(jf)) <= F64 * max(abs(float(jf)), 1.0)
    if fn == "quadratic":
        assert abs(float(tx) - 1.234) < 1e-4
        assert abs(float(tf) - 0.5) < 1e-7


def _three_taxa():
    """The inputs of ``test_ml_distance_matrix_two_taxa_matches_newton``."""
    rng = np.random.default_rng(3)
    base = rng.choice(list("ACGT"), size=2000)

    def mutate(seq, p):
        out = seq.copy()
        hit = rng.random(seq.size) < p
        out[hit] = rng.choice(list("ACGT"), size=int(hit.sum()))
        return out

    return {"x": "".join(base), "y": "".join(mutate(base, 0.15)),
            "z": "".join(mutate(base, 0.35))}


def test_ml_distance_matrix_matches_jax_and_closed_form():
    aln = _three_taxa()
    got = topt.ml_distance_matrix(aln, models.JC69, device="cpu")
    want = jopt.ml_distance_matrix(aln, jmodels.JC69)
    assert got.shape == (3, 3) and got.dtype == np.float64
    np.testing.assert_array_equal(got, got.T)
    assert np.all(np.diag(got) == 0)
    assert _rel(got, want) <= F64
    names = list(aln)
    for a in range(3):
        for b in range(a + 1, 3):
            p = np.mean([c1 != c2 for c1, c2 in zip(aln[names[a]],
                                                     aln[names[b]])])
            closed = -0.75 * np.log(1 - 4 * p / 3)
            assert got[a, b] == pytest.approx(closed, rel=1e-3, abs=1e-4)


@pytest.fixture(scope="module")
def denovo():
    """The inputs of ``test_full_denovo_pipeline_recovers_topology``."""
    true_tree = j_random_tree(7, seed=3, mean_brlen=0.2)
    aln = simulate_alignment(jax.random.key(4), true_tree, jmodels.K80, 2000,
                             params={"kappa": 3.0})
    return true_tree, aln


def test_ml_distances_chunking_changes_no_value(denovo, monkeypatch):
    """Pairs in chunks of 1, 4 and all 21 (as free memory would size them)
    give the same bits; the K80 distances match JAX's at 1e-10."""
    _, aln = denovo
    kw = dict(params={"kappa": 3.0}, device="cpu")
    whole = topt.ml_distance_matrix(aln, models.K80, **kw)
    for chunk in (1, 4):
        monkeypatch.setattr(topt, "_pair_chunk", lambda *a, c=chunk: c)
        np.testing.assert_array_equal(
            topt.ml_distance_matrix(aln, models.K80, **kw), whole)
    want = jopt.ml_distance_matrix(aln, jmodels.K80, params={"kappa": 3.0})
    assert _rel(whole, want) <= F64


def test_denovo_pipeline_matches_jax(denovo):
    """ML distances -> NJ: the port's tree is the JAX package's (same
    topology, names and branch lengths to 1e-10) and recovers the truth."""
    true_tree, aln = denovo
    d = topt.ml_distance_matrix(aln, models.K80, params={"kappa": 3.0},
                                device="cpu")
    nj = neighbor_joining(d, list(aln))
    jnj = j_neighbor_joining(
        jopt.ml_distance_matrix(aln, jmodels.K80, params={"kappa": 3.0}),
        list(aln))
    assert nj.names == jnj.names
    np.testing.assert_array_equal(nj.parent, jnj.parent)
    assert _rel(nj.lengths, jnj.lengths) <= F64
    assert ttrees.robinson_foulds(_port_tree(true_tree), nj) == 0.0


def _patristic(tree):
    n = tree.n_leaves
    out = np.zeros((n, n))
    anc = {}
    for leaf in range(n):
        path, node, dist = {}, leaf, 0.0
        while node != tree.root:
            path[node] = dist
            dist += float(tree.lengths[node])
            node = int(tree.parent[node])
        path[tree.root] = dist
        anc[leaf] = path
    for i in range(n):
        for j in range(i + 1, n):
            shared = set(anc[i]) & set(anc[j])
            out[i, j] = out[j, i] = min(anc[i][s] + anc[j][s] for s in shared)
    return out


@pytest.mark.parametrize("seed", [1, 5, 9])
def test_nj_matches_jax_on_additive_distances(seed):
    """The inputs of ``test_nj_exact_on_additive_distances``: the same tree
    bit for bit as the JAX package's, and the true topology."""
    jtree = j_random_tree(8, seed=seed, mean_brlen=0.3)
    d = _patristic(jtree)
    nj = neighbor_joining(d, jtree.leaf_names)
    jnj = j_neighbor_joining(d, jtree.leaf_names)
    assert nj.names == jnj.names and nj.children == jnj.children
    np.testing.assert_array_equal(nj.lengths, jnj.lengths)
    assert ttrees.robinson_foulds(_port_tree(jtree), nj) == 0.0


def test_nj_validations():
    with pytest.raises(ValueError):
        neighbor_joining(np.zeros((3, 2)), ["a", "b", "c"])
    with pytest.raises(ValueError):
        neighbor_joining(np.array([[0.0, 1.0], [2.0, 0.0]]), ["a", "b"])


def test_fit_multistart_at_least_single_start():
    """The inputs of ``test_fit_multistart_at_least_single_start`` (fewer
    steps: start 0 is the single fit itself, so the best of three can only
    match or beat it); the perturbed starts draw the JAX package's numbers
    for one seed."""
    jtree = j_random_tree(6, seed=2)
    aln = simulate_alignment(jax.random.key(3), jtree, jmodels.HKY85, 200,
                             params={"kappa": 3.0})
    eng = LikelihoodEngine(_port_tree(jtree), aln, models.HKY85, device="cpu")
    single = topt.fit(eng, max_steps=15)
    multi = topt.fit_multistart(eng, n_starts=3, max_steps=15, seed=1)
    assert multi.loglik >= single.loglik - 1e-6
    assert float(multi.params["model"]["kappa"]) > 0
    # the noise of the reference's start 1, drawn the way it draws it
    start = eng._full_params(None)
    jraw = jopt.transform_params(jax.tree.map(jnp.asarray,
                                              params_to_numpy(start)))
    rng = np.random.default_rng(1)
    want = jax.tree.map(lambda x: np.asarray(x, np.float64)
                        + rng.normal(0.0, 0.5, np.shape(x)), jraw)
    got = topt._perturb(topt.transform_params(start),
                        np.random.default_rng(1), 0.5)
    for path, g in zip(*flatten_params(got)):
        w = want
        for k in path:
            w = w[k]
        assert _rel(g.numpy(), w) <= F64, path


@pytest.fixture(scope="module")
def fitted():
    """``test_standard_errors_with_free_alpha_fd_fallback``'s K80+G4 data
    (400 sites simulated on its rooted 4-taxon tree), scored on the same
    tree unrooted (the two root edges joined: a reversible model gives the
    same likelihood, and no direction of the information is confounded)
    and fitted by the port; both packages are then evaluated at the same
    parameters."""
    truth = j_parse_newick("((a:0.12,b:0.18):0.1,(c:0.25,d:0.08):0.15);")
    aln = simulate_alignment(jax.random.key(7), truth, jmodels.K80, 400,
                             params={"kappa": 3.0, "alpha": 0.6}, ncat=4)
    unrooted = "(a:0.12,b:0.18,(c:0.25,d:0.08):0.25);"
    eng = LikelihoodEngine(unrooted, aln, models.K80, ncat=4, device="cpu")
    res = topt.fit(eng, max_steps=60)
    jeng = JaxEngine(j_parse_newick(unrooted), aln, jmodels.K80, ncat=4)
    return eng, jeng, params_to_numpy(res.params)


def _spy_fd(monkeypatch, module, calls):
    real = module._hessian_fd_of_gradient

    def spy(*args, **kwargs):
        calls.append(module.__name__)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, "_hessian_fd_of_gradient", spy)


def _no_jax_hessian(*args, **kwargs):
    raise NotImplementedError("this case holds the port to JAX's differences")


# (free, port takes differences, JAX made to take differences, tolerance)
SE_CASES = {
    "all": (None, True, False, 1e-7),
    "branches_alpha": (("branch_lengths", "alpha"), False, False, 1e-4),
    "branches_model": (("branch_lengths", "model"), True, True, 1e-7),
    "branches": (("branch_lengths",), False, True, 1e-4),
}


@pytest.mark.parametrize("case", sorted(SE_CASES))
def test_standard_errors_match_jax(fitted, monkeypatch, case):
    """The port takes central differences where the model is free (P(t)'s
    reverse rule refuses a second derivative) and the exact Hessian
    otherwise; JAX takes differences where alpha is free (no second
    derivative of its igamma). Where JAX would take its exact Hessian,
    ``jax.hessian`` is made to raise, so JAX takes its differences (its
    exact-Hessian compile costs ~20 s a case on the CPU). Both packages
    difference at eps^(1/3) of float64: 1e-7 where both difference (the
    gradients' roundoff over 2h), 1e-4 where one side is exact (the
    differences' O(h^2) truncation)."""
    free, port_fd, force_jax_fd, tol = SE_CASES[case]
    eng, jeng, point = fitted
    calls = []
    _spy_fd(monkeypatch, topt, calls)
    _spy_fd(monkeypatch, jopt, calls)
    if force_jax_fd:
        monkeypatch.setattr(jax, "hessian", _no_jax_hessian)
    got = topt.standard_errors(eng, params_from_jax(point), free=free)
    port_calls = len(calls)
    want = jopt.standard_errors(
        jeng, jax.tree.map(jnp.asarray, point), free=free)
    assert (port_calls > 0) == port_fd
    assert len(calls) > port_calls       # JAX differences in every case
    for path, g in zip(*flatten_params(got)):
        w = want
        for k in path:
            w = w[k]
        g, w = np.asarray(g), np.asarray(w)
        assert np.array_equal(np.isnan(g), np.isnan(w)), path
        ok = ~np.isnan(w)
        assert np.all(g[ok] > 0), path
        assert _rel(g[ok], w[ok]) <= tol, (path, _rel(g[ok], w[ok]))


def test_fisher_step_follows_the_gradient_dtype():
    assert topt.fd_step(torch.float64) == pytest.approx(6.055e-6, rel=1e-3)
    assert topt.fd_step(torch.float32) == pytest.approx(4.921e-3, rel=1e-3)


def test_standard_errors_cuda_pruner_same_under_both_reverses(
        fitted, monkeypatch):
    """``pruner="cuda"`` on CPU tensors (the kernels' plain versions) always
    takes differences (the kernels' Function has no second derivative),
    with the float32 step; the deferred and the classic reverse give the
    same standard errors bit for bit, and they track the float64 engine's
    to 1e-2 relative."""
    ref_eng, _, point = fitted
    eng = LikelihoodEngine(ref_eng.tree, ref_eng._compressed, models.K80,
                           ncat=4, dtype=torch.float32, pruner="cuda",
                           device="cpu")
    free = ("model", "alpha")
    calls = []
    _spy_fd(monkeypatch, topt, calls)
    params = params_from_jax(point)
    monkeypatch.setenv("PHYLO_DEFERRED_VJP", "1")
    deferred = topt.standard_errors(eng, params, free=free)
    monkeypatch.setenv("PHYLO_DEFERRED_VJP", "0")
    classic = topt.standard_errors(eng, params, free=free)
    assert len(calls) == 2
    exact = topt.standard_errors(ref_eng, params, free=free)
    for path, d in zip(*flatten_params(deferred)):
        c, x = classic, exact
        for k in path:
            c, x = c[k], x[k]
        np.testing.assert_array_equal(d, c)
        assert np.all(np.isfinite(d)) and np.all(d > 0)
        assert _rel(d, x) <= 1e-2, (path, _rel(d, x))


def test_first_derivative_rules_refuse_a_second_derivative():
    """P(t)'s reverse rule holds the eigensystem constant and the kernels'
    Function has no double backward: under ``create_graph=True`` both
    raise, so a Hessian falls back to differences. With
    ``once_differentiable`` the Hessian of a P(t) sum in kappa silently
    lost the eigensystem's term (autograd.grad prunes its error node)."""
    from phylo_utils_tpu_torch.ops.cuda_pruning import make_fused_loglik_fn
    from phylo_utils_tpu_torch.ops.pmatrix import p_matrices_reversible
    from phylo_utils_tpu_torch.trees import compile_schedule

    kappa = torch.tensor(3.0, dtype=torch.float64, requires_grad=True)
    sym, freqs = models.K80.build_parts({"kappa": kappa})
    p = p_matrices_reversible(sym, freqs, torch.tensor([[0.1], [0.3]]))
    with pytest.raises(RuntimeError, match="no second derivative"):
        torch.autograd.grad((p ** 2).sum(), kappa, create_graph=True)
    (g,) = torch.autograd.grad((p ** 2).sum(), kappa)   # first order: fine
    assert torch.isfinite(g)
    tree = ttrees.random_tree(5, seed=1)
    sched = compile_schedule(tree)
    pt = torch.rand((sched.n_nodes, 2, 4, 4), dtype=torch.float32)
    pt = (pt / pt.sum(-1, keepdim=True)).requires_grad_(True)
    leaves = torch.eye(4)[torch.randint(0, 4, (5, 7))]
    ll = make_fused_loglik_fn(sched)(pt, leaves, torch.full((4,), 0.25))
    with pytest.raises(RuntimeError, match="no second derivative"):
        torch.autograd.grad(ll.sum(), pt, create_graph=True)
