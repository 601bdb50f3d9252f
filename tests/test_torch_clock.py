"""Port parity, the molecular clock: ``phylo_utils_tpu_torch.clock``
(``ClockEngine``, ``clock_test``, ``node_height_errors``, ``mrca``,
penalized-likelihood dating and its cross-validation) against the JAX
package on the same seeded inputs, and the cases of ``tests/test_clock.py``
in the port alone. The node-height standard errors are
``tests/test_torch_clock_errors.py`` (JAX's first Hessian alone takes ~30
s on the CPU, so the test workers run that file beside this one).

Tolerances: the f64 port (``pruner="torch"``) against the JAX f64 engine,
1e-10 relative on logL and per site, gradients 1e-8 x max|g|; the f32
kernel path (``pruner="cuda"``, the walks' plain versions on CPU tensors)
1e-6 relative and 5e-4 x max|g|; the dating fits' ages 1e-6 relative from
the same start (the same Adam update as optax's, ``_adam``, held to optax
itself at 1e-12), their objectives and cross-validation scores 1e-8
relative. The clock LRT is held at the port's own fitted parameters (the
packages fit with different optimizers); JAX's power and size replicates
are not re-run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from phylo_utils_tpu import clock as jclock
from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu.io import parse_newick as j_parse_newick
from phylo_utils_tpu.model_selection import (
    likelihood_ratio_test as j_lrt,
)
from phylo_utils_tpu.trees import random_tree
from phylo_utils_tpu_torch import models
from phylo_utils_tpu_torch.branch_models import mark_clade
from phylo_utils_tpu_torch.clock import (
    ClockEngine,
    _adam,
    _initial_heights,
    clock_test,
    cross_validate_lambda,
    mrca,
    penalized_likelihood_dating,
)
from phylo_utils_tpu_torch.convert import flatten_params, params_to_numpy
from phylo_utils_tpu_torch.io import parse_newick
from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
from phylo_utils_tpu_torch.optimize import fit
from phylo_utils_tpu_torch.simulate import simulate_alignment
from phylo_utils_tpu_torch.trees import Tree

from torch_threads import one_thread  # noqa: F401

T64 = dict(dtype="float64", device="cpu")
T32 = dict(dtype="float32", pruner="cuda", device="cpu")
ULTRA = ("(((a:0.1,b:0.1):0.1,(c:0.1,d:0.1):0.1):0.05,"
         "(e:0.2,f:0.2):0.05);")
CLOCK_PARAMS = {"root_height": 0.3, "height_fractions": [0.6, 0.5, 0.4, 0.7],
                "model": {"kappa": 3.0}, "alpha": 0.8}


def _port_tree(jtree):
    return Tree(jtree.names, jtree.parent, jtree.lengths, jtree.children,
                jtree.n_leaves)


def _depth(tree, i):
    d = 0.0
    while tree.parent[i] != -1:
        d += tree.lengths[i]
        i = int(tree.parent[i])
    return d


@pytest.fixture(scope="module")
def ultra_case():
    """600 HKY85 sites (kappa 3) simulated by the port on the ultrametric
    6-taxon tree."""
    tree = parse_newick(ULTRA)
    aln = simulate_alignment(0, tree, models.HKY85, 600,
                             params={"kappa": 3.0}, device="cpu")
    return tree, aln


@pytest.fixture
def small():
    tree = parse_newick("((a:0.1,b:0.1):0.05,(c:0.15,d:0.15):0.0);")
    aln = {"a": "ACGTACGTGG", "b": "ACGTTGCAGG",
           "c": "AGGTACGAGT", "d": "ACGAACGTAT"}
    return tree, aln


def _by_path(tree) -> dict:
    names, leaves = flatten_params(params_to_numpy(tree))
    return dict(zip(names, leaves))


_JAX_ENGINES = {}


@pytest.mark.parametrize("pruner", ["torch", "cuda"])
@pytest.mark.parametrize("local", [False, True])
def test_clock_engine_matches_jax(ultra_case, local, pruner):
    """logL, sitewise and the gradient in every parameter (heights,
    fractions, the local clock's rate multiplier, kappa, alpha) at the same
    parameters; the implied branch lengths and node heights."""
    tree, aln = ultra_case
    jtree = j_parse_newick(ULTRA)
    cls = mark_clade(tree, ["e", "f"]) if local else None
    params = dict(CLOCK_PARAMS)
    if local:
        params["rate_multipliers"] = [1.7]
    if local not in _JAX_ENGINES:        # one JAX engine for both pruners
        je = jclock.ClockEngine(jtree, aln, jmodels.HKY85, ncat=2,
                                branch_classes=cls, dtype="float64")
        _JAX_ENGINES[local] = (je, je.loglikelihood(params),
                               je.sitewise_loglikelihoods(params),
                               _by_path(jax.tree.map(np.asarray, je.gradient(
                                   je._full_params(params)))))
    je, ll, sw, want = _JAX_ENGINES[local]
    te = ClockEngine(tree, aln, models.HKY85, ncat=2, branch_classes=cls,
                     **(T64 if pruner == "torch" else T32))
    rtol, gtol = (1e-10, 1e-8) if pruner == "torch" else (1e-6, 5e-4)
    assert te.loglikelihood(params) == pytest.approx(ll, rel=rtol)
    np.testing.assert_allclose(te.sitewise_loglikelihoods(params), sw,
                               rtol=rtol)
    got = _by_path(te.gradient(params))
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0,
                                   atol=gtol * np.abs(w).max(),
                                   err_msg=str(path))
    # the parameters in the engine's dtype: f32 rounds them
    ptol = 1e-12 if pruner == "torch" else 1e-6
    full = te._full_params(params)
    np.testing.assert_allclose(
        te._branch_lengths(full, torch.float64).numpy(),
        np.asarray(je._branch_lengths(je._full_params(params), jnp.float64)),
        rtol=ptol)
    assert te.node_heights(params) == pytest.approx(je.node_heights(params),
                                                    rel=ptol)
    np.testing.assert_allclose(te.chronogram(params).lengths,
                               je.chronogram(params).lengths, rtol=ptol)
    for k, v in je.default_params().items():
        if k != "model":
            np.testing.assert_allclose(te.default_params()[k].numpy(),
                                       np.asarray(v), rtol=ptol)


def test_clock_equals_plain_engine_at_same_lengths(small):
    tree, aln = small
    ce = ClockEngine(tree, aln, models.HKY85, ncat=2, **T64)
    full = ce._full_params(None)
    bl = ce._branch_lengths(full, torch.float64)
    pe = LikelihoodEngine(tree, aln, models.HKY85, ncat=2, **T64)
    assert ce.loglikelihood(full) == pytest.approx(
        pe.loglikelihood({"branch_lengths": bl, "alpha": full["alpha"]}),
        abs=1e-9)
    h = ce.node_heights(full)
    for i in range(tree.n_nodes):
        p = int(tree.parent[i])
        if p != -1:
            assert h[p] >= h[i] - 1e-12
    assert all(h[i] == 0.0 for i in range(tree.n_leaves))


def test_clock_fit_is_ultrametric_and_nested(small):
    tree, aln = small
    ce = ClockEngine(tree, aln, models.HKY85, **T64)
    res = fit(ce, max_steps=60, patience=10)
    chron = ce.chronogram(res.params)
    depths = [_depth(chron, i) for i in range(tree.n_leaves)]
    assert max(depths) - min(depths) < 1e-9
    res_u = fit(LikelihoodEngine(tree, aln, models.HKY85, **T64),
                max_steps=60, patience=10)
    assert res.loglik <= res_u.loglik + 1e-6
    with pytest.raises(ValueError, match="heights"):
        ce.loglikelihood({"branch_lengths": np.ones(tree.n_nodes)})


def test_clock_test_lrt_matches_jax_at_the_fits(ultra_case):
    """The clock LRT's df (n - 2 for 6 taxa) and statistic: JAX's
    ``likelihood_ratio_test`` of the JAX engines' logL at the port's fitted
    null and alternative."""
    tree, aln = ultra_case
    out = clock_test(tree, aln, models.HKY85, max_steps=40, patience=10,
                     engine_kwargs=T64)
    assert out["df"] == 4
    jtree = j_parse_newick(ULTRA)
    jnull = jclock.ClockEngine(jtree, aln, jmodels.HKY85, dtype="float64")
    from phylo_utils_tpu.likelihood import LikelihoodEngine as JEngine

    jalt = JEngine(jtree, aln, jmodels.HKY85, dtype="float64")
    ll_null = jnull.loglikelihood(params_to_numpy(out["null"].params))
    ll_alt = jalt.loglikelihood(params_to_numpy(out["alt"].params))
    assert out["null"].loglik == pytest.approx(ll_null, rel=1e-10)
    assert out["alt"].loglik == pytest.approx(ll_alt, rel=1e-10)
    want = j_lrt(ll_null, ll_alt, df=4)
    assert out["lrt"]["statistic"] == pytest.approx(want["statistic"],
                                                    rel=1e-7, abs=1e-7)
    assert out["lrt"]["pvalue"] == pytest.approx(want["pvalue"], rel=1e-7)
    # clock-like data: the strict clock is not rejected
    assert out["lrt"]["pvalue"] > 0.01


def test_local_clock_recovers_rate_multiplier():
    base = parse_newick(ULTRA)
    cls = mark_clade(base, ["e", "f"])
    stretched = np.array(base.lengths)
    stretched[cls.astype(bool)] *= 3.0
    aln = simulate_alignment(2, base.with_lengths(stretched), models.HKY85,
                             500, params={"kappa": 3.0}, device="cpu")
    res_s = fit(ClockEngine(base, aln, models.HKY85, **T64), max_steps=80,
                patience=12)
    local = ClockEngine(base, aln, models.HKY85, branch_classes=cls, **T64)
    res_l = fit(local, max_steps=80, patience=12)
    assert res_l.loglik >= res_s.loglik - 1e-6
    assert float(res_l.params["rate_multipliers"][0]) > 2.0
    chron = local.chronogram(res_l.params)
    depths = [_depth(chron, i) for i in range(base.n_leaves)]
    assert max(depths) - min(depths) < 1e-9


def test_clock_gradients_flow(small):
    tree, aln = small
    ce = ClockEngine(tree, aln, models.JC69, **T64)
    g = ce.gradient()
    assert np.isfinite(float(g["root_height"]))
    assert torch.isfinite(g["height_fractions"]).all()
    assert g["height_fractions"].shape == (ce.n_internal - 1,)


def test_clock_edge_cases():
    """2-leaf trees (no fractions), multifurcations, and a trifurcating
    root's clock_test df."""
    ce = ClockEngine(parse_newick("(a:0.1,b:0.2);"),
                     {"a": "ACGTACGT", "b": "ACCTACGA"}, models.JC69, **T64)
    r = fit(ce, max_steps=30, patience=8)
    assert np.isfinite(r.loglik) and float(r.params["root_height"]) > 0
    tm = parse_newick("((a:0.1,b:0.1,c:0.1):0.05,(d:0.15,e:0.15):0.0);")
    cem = ClockEngine(tm, {n: "ACGTACGTGG" for n in "abcde"}, models.JC69,
                      **T64)
    assert np.isfinite(cem.loglikelihood())
    t3 = parse_newick("(a:0.1,b:0.2,(c:0.3,d:0.1):0.2);")
    aln = {"a": "ACGTACGTGG", "b": "ACGTTGCAGG",
           "c": "AGGTACGAGT", "d": "ACGAACGTAT"}
    out = clock_test(t3, aln, models.JC69, max_steps=25, patience=6,
                     engine_kwargs=T64)
    assert out["df"] >= 1 and np.isfinite(out["lrt"]["pvalue"])


# -- penalized-likelihood dating --------------------------------------------


def test_adam_is_optax_adam():
    """``_adam`` takes optax.adam's steps on a batch of quadratics."""
    rng = np.random.default_rng(0)
    a, b = rng.uniform(0.5, 3.0, (3, 4)), rng.normal(size=(3, 4))
    x0 = rng.normal(size=(3, 4))

    def grad(x):
        return 2.0 * a * (x - b)

    got = _adam([torch.as_tensor(x0)],
                lambda p: [torch.as_tensor(grad(p[0].numpy()))], 60, 0.05)
    opt = optax.adam(0.05)
    x, st = jnp.asarray(x0), opt.init(jnp.asarray(x0))
    for _ in range(60):
        upd, st = opt.update(jnp.asarray(grad(np.asarray(x))), st, x)
        x = optax.apply_updates(x, upd)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(x), rtol=1e-12,
                               atol=1e-14)


def _dating_case(seed_tree=7, n=10, rate_sd=0.3):
    jtree = random_tree(n, seed=seed_tree, mean_brlen=0.1)
    h = jclock._initial_heights(jtree)
    dur = np.zeros(jtree.n_nodes)
    for i in range(jtree.n_nodes):
        p = int(jtree.parent[i])
        if p != -1:
            dur[i] = h[p] - h[i]
    rates = np.exp(np.random.default_rng(1).normal(0, rate_sd, jtree.n_nodes))
    jgram = jtree.with_lengths(dur * rates)
    return jgram, _port_tree(jgram), h


def test_penalized_likelihood_dating_matches_jax():
    """Relative and calibrated dating from the same start: ages, rates and
    the objective, against JAX's Adam scan."""
    jgram, gram, h = _dating_case()
    root_age = float(h[jgram.root])
    clade = tuple(jgram.leaf_names[:3])
    for kw in ({"root_age": root_age, "lam": 0.5},
               {"calibrations": {clade: 0.4 * root_age,
                                 jgram.root: (None, 2.0 * root_age)}}):
        got = penalized_likelihood_dating(gram, 2000, steps=300,
                                          device="cpu", **kw)
        want = jclock.penalized_likelihood_dating(jgram, 2000, steps=300,
                                                  **kw)
        assert set(got["ages"]) == set(want["ages"])
        for k, v in want["ages"].items():
            assert got["ages"][k] == pytest.approx(v, rel=1e-6, abs=1e-12)
        np.testing.assert_allclose(got["rates"], want["rates"], rtol=1e-6)
        np.testing.assert_allclose(got["chronogram"].lengths,
                                   want["chronogram"].lengths, rtol=1e-6,
                                   atol=1e-12)
        assert got["objective"] == pytest.approx(want["objective"],
                                                 rel=1e-8)
        assert got["max_calibration_violation"] == pytest.approx(
            want["max_calibration_violation"], rel=1e-6, abs=1e-9)


def test_cross_validate_lambda_matches_jax():
    """The n_leaves x n_lambdas fits as one batched run: JAX's scores
    (fit by fit) and choice."""
    jgram, gram, h = _dating_case(seed_tree=11, n=8, rate_sd=0.2)
    kw = dict(lambdas=(0.01, 1.0, 100.0), root_age=float(h[jgram.root]),
              steps=200)
    got = cross_validate_lambda(gram, 2000, device="cpu", **kw)
    want = jclock.cross_validate_lambda(jgram, 2000, **kw)
    assert got["lambda"] == want["lambda"]
    assert set(got["scores"]) == set(want["scores"])
    for k, v in want["scores"].items():
        assert got["scores"][k] == pytest.approx(v, rel=1e-8)


def test_penalized_likelihood_dating_recovers_ages():
    """Exact ages on a strict-clock phylogram; high age correlation under
    lognormal rate variation."""
    base = _port_tree(random_tree(10, seed=7, mean_brlen=0.1))
    h = _initial_heights(base)
    dur = np.zeros(base.n_nodes)
    for i in range(base.n_nodes):
        p = int(base.parent[i])
        if p != -1:
            dur[i] = h[p] - h[i]
    root_age = h[base.root]
    internal = range(base.n_leaves, base.n_nodes)
    tru = np.array([h[n] for n in internal])
    out = penalized_likelihood_dating(base.with_lengths(dur), n_sites=2000,
                                      root_age=root_age, lam=1.0,
                                      device="cpu")
    est = np.array([out["ages"][int(n)] for n in internal])
    assert (np.abs(est - tru) / root_age).max() < 0.05
    r = out["rates"][out["rates"] > 0]
    assert abs(r.mean() - 1.0) < 0.1
    assert out["ages"][base.root] == pytest.approx(root_age)
    rates = np.exp(np.random.default_rng(1).normal(0, 0.3, base.n_nodes))
    out2 = penalized_likelihood_dating(base.with_lengths(dur * rates),
                                       n_sites=2000, root_age=root_age,
                                       lam=0.5, device="cpu")
    est2 = np.array([out2["ages"][int(n)] for n in internal])
    assert np.corrcoef(est2, tru)[0, 1] > 0.9


def test_calibration_validation_and_mrca():
    jtree = random_tree(6, seed=1)
    base = _port_tree(jtree)
    with pytest.raises(ValueError, match="min"):
        penalized_likelihood_dating(base, n_sites=100, device="cpu",
                                    calibrations={base.root: (5.0, 1.0)})
    with pytest.raises(ValueError, match="not an internal node"):
        penalized_likelihood_dating(base, n_sites=100, device="cpu",
                                    calibrations={0: 1.0})
    with pytest.raises(ValueError, match="unknown leaf"):
        mrca(base, ["nope"])
    names = base.leaf_names
    for group in (names[:2], names[1:4], names):
        assert mrca(base, group) == jclock.mrca(jtree, group)
