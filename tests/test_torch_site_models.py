"""Port parity, the codon site models: M1a, M2a, M7, M8 and M8a
(``SharedOmegaMixtureEngine`` over GY94), the NEB scan
(``omega_posteriors``), the BEB scans (``beb_site_posteriors``,
``beb_site_posteriors_m8``) and the three LRTs in the PyTorch port against
the JAX package, on one codon alignment simulated by the port under an
M2a-like mixture (omega 0.1 / 1 / 4 at 50 / 30 / 20%, kappa 2; 6 taxa x
120 codons), F3x4 frequencies, 4 beta classes for M7/M8/M8a.

Tolerances: the f64 port (``pruner="torch"``) against the JAX f64 XLA
engine, 1e-10 relative on logL and per site, 1e-8 x max|g| per gradient
leaf (the beta classes' derivative is a central difference in both
packages); the f32 walk (``pruner="cuda"``: the plain versions of the walks
padded to 64 states on the CPU) against the same reference, 2e-5 relative
on logL and per site and 5e-4 x max|g|; the NEB and BEB posteriors in f64,
1e-10 absolute. Every parameter dict reaches the port through
``convert.params_from_jax``. The M7-vs-M8 recovery, fitted in the port
alone, is ``tests/test_torch_site_recovery.py``.
"""
import jax
import numpy as np
import pytest
import torch

from phylo_utils_tpu import io as jio
from phylo_utils_tpu import mixtures as jmix
from phylo_utils_tpu.trees import random_tree
from phylo_utils_tpu_torch import mixtures as tmix
from phylo_utils_tpu_torch import models as tmodels
from phylo_utils_tpu_torch import trees as ttrees
from phylo_utils_tpu_torch.convert import flatten_params, params_from_jax
from phylo_utils_tpu_torch.io import encode_codon_alignment
from phylo_utils_tpu_torch.models.codon import empirical_codon_frequencies
from phylo_utils_tpu_torch.ops import cuda_pruning
from phylo_utils_tpu_torch.ops.beta import discrete_beta
from phylo_utils_tpu_torch.simulate import simulate_mixture_alignment

from torch_threads import one_thread  # noqa: F401

# engine -> (its hyperparameters away from the defaults, constructor kw)
ENGINES = {
    "M1a": ({"proportions": [0.65, 0.35], "omega0": 0.15}, {}),
    "M2a": ({"proportions": [0.5, 0.3, 0.2], "omega0": 0.15,
             "omega2_delta": 2.2}, {}),
    "M7": ({"beta_p": 0.6, "beta_q": 1.8}, {"ncat": 4}),
    "M8": ({"beta_p": 0.6, "beta_q": 1.8, "p0": 0.8, "omega_delta": 2.5},
           {"ncat": 4}),
    "M8a": ({"beta_p": 0.6, "beta_q": 1.8, "p0": 0.8}, {"ncat": 4}),
}


def _flat(tree):
    return dict(zip(*flatten_params(tree)))


@pytest.fixture(scope="module")
def problem():
    jtree = random_tree(6, seed=11, mean_brlen=0.2)
    tree = ttrees.Tree(jtree.names, jtree.parent, jtree.lengths,
                       jtree.children, jtree.n_leaves)
    aln, classes = simulate_mixture_alignment(
        13, tree, tmodels.GY94, 120,
        [{"omega": 0.1}, {"omega": 1.0}, {"omega": 4.0}],
        weights=[0.5, 0.3, 0.2], shared={"kappa": 2.0}, device="cpu")
    freqs = empirical_codon_frequencies(aln, "f3x4")
    return dict(jtree=jtree, tree=tree, aln=aln, classes=classes,
                jca=jio.encode_codon_alignment(aln),
                ca=encode_codon_alignment(aln), freqs=freqs)


@pytest.fixture(scope="module")
def references(problem):
    """Each engine's JAX f64 XLA reference, built once: logL, sitewise logL
    and gradient at parameters away from the defaults."""
    refs = {}
    for name, (hyper, kw) in ENGINES.items():
        j64 = getattr(jmix, f"{name}Engine")(problem["jtree"],
                                             problem["jca"],
                                             dtype="float64", **kw)
        p = {**hyper, "shared": {"kappa": 2.3, "freqs": problem["freqs"]},
             "branch_lengths": np.asarray(problem["jtree"].lengths) * 1.1}
        ll, g = j64.value_and_grad(p)
        refs[name] = dict(
            j64=j64, p=p, ll=float(ll),
            sitewise=np.asarray(j64.sitewise_loglikelihoods(p)),
            grad=_flat(jax.tree.map(np.asarray, g)),
            full=jax.tree.map(np.asarray, j64._full_params(p)))
    return refs


def _port(problem, name, dtype=torch.float64, pruner="torch"):
    return getattr(tmix, f"{name}Engine")(
        problem["tree"], problem["ca"], dtype=dtype, pruner=pruner,
        device="cpu", **ENGINES[name][1])


@pytest.mark.parametrize("pruner,dtype,tol,grad_tol", [
    ("torch", torch.float64, 1e-10, 1e-8),
    ("cuda", torch.float32, 2e-5, 5e-4),
])
@pytest.mark.parametrize("name", list(ENGINES))
def test_site_engine_matches_jax_xla(problem, references, name, pruner,
                                     dtype, tol, grad_tol):
    ref = references[name]
    port = _port(problem, name, dtype, pruner)
    params = params_from_jax(ref["full"])
    got = port.loglikelihood(params)
    assert np.isfinite(got) and abs(got - ref["ll"]) <= tol * abs(ref["ll"])
    np.testing.assert_allclose(port.sitewise_loglikelihoods(params),
                               ref["sitewise"], rtol=tol, atol=0)
    value, grads = port.value_and_grad(params)
    assert abs(float(value) - ref["ll"]) <= tol * abs(ref["ll"])
    got_g = _flat(grads)
    assert set(got_g) == set(ref["grad"])
    for path, g in got_g.items():
        want = ref["grad"][path]
        np.testing.assert_allclose(g.double().numpy(), want, rtol=0,
                                   atol=grad_tol * np.abs(want).max(),
                                   err_msg=str(path))


def test_site_engines_walk_at_64_states_with_their_class_counts(
        problem, monkeypatch):
    """Under pruner="cuda" every value call and both BEB passes take the
    stream walk's plain version at 64 states, with K = the engine's classes
    (2, 3, 5) or the BEB grid's (2d + 1 = 13 at d = 6; n_fine + d = 15)."""
    seen = []
    orig = cuda_pruning.slot_walk_reference

    def spy(p, leaves, *a, **kw):
        seen.append((p.shape[-3], leaves.shape[-1]))
        return orig(p, leaves, *a, **kw)

    monkeypatch.setattr(cuda_pruning, "slot_walk_reference", spy)
    m2a = _port(problem, "M2a", torch.float32, "cuda")
    m8 = _port(problem, "M8", torch.float32, "cuda")
    m1a = _port(problem, "M1a", torch.float32, "cuda")
    m1a.loglikelihood()
    m2a.loglikelihood()
    m8.loglikelihood()
    tmix.beb_site_posteriors(m2a, d=6)
    tmix.beb_site_posteriors_m8(m8, d=3, n_fine=12)
    assert seen == [(2, 64), (3, 64), (5, 64), (13, 64), (15, 64)]


@pytest.mark.parametrize("name", ["M2a", "M7", "M8"])
def test_omega_posteriors_match_jax(problem, references, name):
    ref = references[name]
    port = _port(problem, name)
    mean_w, gam = tmix.omega_posteriors(port, params_from_jax(ref["full"]))
    want_w, want_gam = jmix.omega_posteriors(ref["j64"], ref["p"])
    assert gam.shape == (120, port.ncat)
    np.testing.assert_allclose(gam, np.asarray(want_gam), rtol=0, atol=1e-10)
    np.testing.assert_allclose(mean_w, np.asarray(want_w), rtol=0,
                               atol=1e-10)


def test_beb_site_posteriors_match_jax(problem, references):
    ref = references["M2a"]
    port = _port(problem, "M2a")
    p_pos, mean_w = tmix.beb_site_posteriors(
        port, params_from_jax(ref["full"]), d=6)
    want_pos, want_w = jmix.beb_site_posteriors(ref["j64"], ref["p"], d=6)
    assert p_pos.shape == mean_w.shape == (120,)
    np.testing.assert_allclose(p_pos, want_pos, rtol=0, atol=1e-10)
    np.testing.assert_allclose(mean_w, want_w, rtol=0, atol=1e-10)
    # the positive class's sites rank above the purifying ones
    cls = problem["classes"]
    assert p_pos[cls == 2].mean() > p_pos[cls == 0].mean() + 0.2


def test_beb_site_posteriors_m8_match_jax(problem, references):
    ref = references["M8"]
    port = _port(problem, "M8")
    p_pos, mean_w = tmix.beb_site_posteriors_m8(
        port, params_from_jax(ref["full"]), d=3, n_fine=12)
    want_pos, want_w = jmix.beb_site_posteriors_m8(ref["j64"], ref["p"],
                                                   d=3, n_fine=12)
    np.testing.assert_allclose(p_pos, want_pos, rtol=0, atol=1e-10)
    np.testing.assert_allclose(mean_w, want_w, rtol=0, atol=1e-10)
    assert np.all((p_pos >= 0) & (p_pos <= 1.0 + 1e-9))
    with pytest.raises(TypeError, match="M8Engine"):
        tmix.beb_site_posteriors_m8(_port(problem, "M7"))
    with pytest.raises(TypeError, match="M2aEngine"):
        tmix.beb_site_posteriors(_port(problem, "M1a"))


@pytest.mark.parametrize("ll0,ll1", [(-1010.0, -1000.0), (-500.0, -500.0),
                                     (-300.0, -300.5), (-77.25, -75.0)])
def test_lrt_functions_equal_jax(ll0, ll1):
    for name in ("positive_selection_test", "m1a_m2a_test", "m8_m8a_test"):
        got = getattr(tmix, name)(ll0, ll1)
        want = getattr(jmix, name)(ll0, ll1)
        assert got == want, name


def test_m7_matches_explicit_mixture(problem):
    """M7's logL equals a ModelMixtureEngine over the same discretized-beta
    omega classes; gradients flow into the beta shape."""
    p, q = 0.7, 1.9
    m7 = _port(problem, "M7")
    ll7 = m7.loglikelihood({"beta_p": p, "beta_q": q})
    omegas = discrete_beta(p, q, 4).numpy()
    explicit = tmix.ModelMixtureEngine(
        problem["tree"], problem["ca"], tmodels.GY94,
        mixture=[{"omega": w} for w in omegas], dtype=torch.float64,
        device="cpu")
    assert ll7 == pytest.approx(explicit.loglikelihood(), abs=1e-8)
    g = m7.gradient({"beta_p": p, "beta_q": q})
    assert abs(float(g["beta_p"])) > 0 and abs(float(g["beta_q"])) > 0


def test_m1a_matches_explicit_mixture(problem):
    m1a = _port(problem, "M1a")
    hyper = {"proportions": [0.8, 0.2], "omega0": 0.15}
    ll = m1a.loglikelihood(hyper)
    explicit = tmix.ModelMixtureEngine(
        problem["tree"], problem["ca"], tmodels.GY94,
        mixture=[{"omega": 0.15}, {"omega": 1.0}], dtype=torch.float64,
        device="cpu")
    assert ll == pytest.approx(
        explicit.loglikelihood({"cat_weights": [0.8, 0.2]}), abs=1e-8)
    g = m1a.gradient(hyper)
    assert abs(float(g["omega0"])) > 0
    assert bool((g["proportions"].abs() > 0).any())


def test_m8a_nests_in_m8_and_boundary_test(problem):
    """M8a is M8 with the extra class's omega pinned at 1; the M8-vs-M8a
    LRT's null is the boundary mixture (p = 0.5 chi2_1 tail)."""
    from scipy.stats import chi2

    m8a = _port(problem, "M8a")
    full = m8a._full_params(None)
    om, w = m8a._class_omegas_weights(full)
    assert float(om[-1]) == 1.0 and "omega_delta" not in full
    assert float(w.sum()) == pytest.approx(1.0, abs=1e-12)
    ll_a = m8a.loglikelihood()
    ll_8 = _port(problem, "M8").loglikelihood({"omega_delta": 1e-8})
    assert abs(ll_a - ll_8) < 1e-6
    t = tmix.m8_m8a_test(ll_a, ll_a + 3.0)
    assert t["pvalue"] == pytest.approx(0.5 * chi2.sf(6.0, 1))
    assert tmix.m8_m8a_test(ll_a, ll_a)["pvalue"] == 1.0


def test_site_model_validation(problem):
    m2a = _port(problem, "M2a")
    with pytest.raises(ValueError, match="'shared' parameter"):
        m2a.loglikelihood({"shared": {"kapa": 2.0}})
    with pytest.raises(ValueError, match="unknown parameter"):
        m2a.loglikelihood({"omega2": 3.0})
    with pytest.raises(ValueError, match="'omega' parameter"):
        tmix.M1aEngine(problem["tree"], problem["ca"], tmodels.HKY85,
                       device="cpu")
    assert set(m2a.default_params()) == {
        "branch_lengths", "shared", "proportions", "omega0", "omega2_delta"}
    assert set(m2a.default_params()["shared"]) == {"kappa", "freqs"}
    assert _port(problem, "M8").ncat == 5 and m2a.ncat == 3
