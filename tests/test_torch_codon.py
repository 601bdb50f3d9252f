"""Port parity, codon models: GY94, MG94 and GY94 over the vertebrate
mitochondrial code (60 states) in the PyTorch port against the JAX package,
on the same codon alignment (random sense codons with gaps and IUPAC
codes, 6 taxa x 40 codons), +G4.

Tolerances: the f64 port (``pruner="torch"``) against the JAX f64 XLA
engine (the JAX package's plain reference, not Pallas), 1e-10 relative on
logL and per site, 1e-10 x max|g| per gradient leaf; the f32 walk
(``pruner="cuda"``: the padded walk's plain versions on the CPU, 61 or 60
states padded to 64) against the same f64 reference, 2e-5 relative on logL
and per site (the JAX package's own f32 codon bound on logL,
``tests/test_codon.py``; per site it holds because the port reconstructs
P(t) in float64 and casts it, where the JAX f32 engine reconstructs from
61 modes in float32 and sits further from its f64 engine) and 5e-4 x
max|g| per gradient leaf. Encoding,
frequencies and dN/dS are numpy on both sides: equal arrays, or 1e-12.
"""
import jax
import numpy as np
import pytest
import torch

from phylo_utils_tpu import io as jio
from phylo_utils_tpu.likelihood import LikelihoodEngine as JaxEngine
from phylo_utils_tpu.models import codon as jcodon
from phylo_utils_tpu.trees import random_tree
from phylo_utils_tpu_torch import io as tio
from phylo_utils_tpu_torch import models as tmodels
from phylo_utils_tpu_torch import trees as ttrees
from phylo_utils_tpu_torch.convert import flatten_params, params_from_jax
from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
from phylo_utils_tpu_torch.models import codon as tcodon
from phylo_utils_tpu_torch.ops import cuda_pruning

from torch_threads import one_thread  # noqa: F401

NUC_FREQS = [[0.3, 0.2, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25],
             [0.15, 0.35, 0.2, 0.3]]


def _codon_alignment(names, n_codons, code, seed):
    """Random sense codons of ``code``, a few positions gapped or IUPAC
    coded (never making a codon compatible with stops only)."""
    rng = np.random.default_rng(seed)
    codons = tcodon.code_tables(code)[0]
    aln = {}
    for name in names:
        seq = [list(c) for c in rng.choice(codons, size=n_codons)]
        for i in rng.choice(n_codons, size=4, replace=False):
            seq[i][rng.integers(3)] = rng.choice(list("-NRY"))
        aln[name] = "".join("".join(c) for c in seq)
    return aln


def _flat(grads):
    return dict(zip(*flatten_params(grads)))


def _tree(jtree):
    return ttrees.Tree(jtree.names, jtree.parent, jtree.lengths,
                       jtree.children, jtree.n_leaves)


@pytest.fixture(scope="module", params=["GY94", "MG94", "GY94_mito"])
def codon_problem(request):
    name = request.param
    code = "vertebrate_mito" if name.endswith("mito") else "standard"
    jtree = random_tree(6, seed=3, mean_brlen=0.2)
    aln = _codon_alignment(jtree.leaf_names, 40, code, seed=5)
    if name == "MG94":
        jmodel, tmodel = jcodon.MG94, tmodels.MG94
        p = {"model": {"kappa": 2.5, "omega": 0.35, "nuc_freqs": NUC_FREQS},
             "alpha": 0.6}
    else:
        jmodel, tmodel = jcodon.make_gy94(code), tcodon.make_gy94(code)
        freqs = jcodon.empirical_codon_frequencies(aln, "f3x4", code)
        p = {"model": {"kappa": 2.5, "omega": 0.35, "freqs": freqs},
             "alpha": 0.6}
    jca = jio.encode_codon_alignment(aln, code=code)
    j64 = JaxEngine(jtree, jca, jmodel, ncat=4, dtype="float64")
    return dict(name=name, code=code, aln=aln, jtree=jtree, j64=j64,
                tmodel=tmodel, p=p, tree=_tree(jtree),
                full=jax.tree.map(np.asarray, j64._full_params(p)))


@pytest.mark.parametrize("pruner,dtype,tol,site_tol,grad_tol", [
    ("torch", torch.float64, 1e-10, 1e-10, 1e-10),
    ("cuda", torch.float32, 2e-5, 2e-5, 5e-4),
])
def test_codon_engine_matches_jax_xla(codon_problem, pruner, dtype, tol,
                                      site_tol, grad_tol):
    """logL, sitewise logL and value_and_grad of the port's engine, built
    from the nucleotide dict (its own codon encoding, the genetic code
    taken from the model's alphabet), against the JAX f64 XLA engine."""
    cp = codon_problem
    j64 = cp["j64"]
    port = LikelihoodEngine(cp["tree"], cp["aln"], cp["tmodel"], ncat=4,
                            dtype=dtype, pruner=pruner, device="cpu")
    params = params_from_jax(cp["full"])
    want = j64.loglikelihood(cp["p"])
    before = cuda_pruning.LAUNCHES + cuda_pruning.STREAM_LAUNCHES
    got = port.loglikelihood(params)
    assert cuda_pruning.LAUNCHES + cuda_pruning.STREAM_LAUNCHES == before
    assert np.isfinite(got) and abs(got - want) / abs(want) < tol
    np.testing.assert_allclose(port.sitewise_loglikelihoods(params),
                               j64.sitewise_loglikelihoods(cp["p"]),
                               rtol=site_tol, atol=0)
    lj, gj = j64.value_and_grad(cp["p"])
    lt, gt = port.value_and_grad(params)
    assert abs(float(lt) - float(lj)) < tol * abs(float(lj))
    want_g = _flat(jax.tree.map(np.asarray, gj))
    got_g = _flat(gt)
    assert set(got_g) == set(want_g)
    for path, g in got_g.items():
        w = want_g[path]
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0,
                                   atol=grad_tol * np.abs(w).max(),
                                   err_msg=str(path))


def test_codon_walk_runs_padded_to_64_states(codon_problem, monkeypatch):
    """Under pruner="cuda" the walk sees 64 states: value calls take the
    stream walk's plain version (``choose_walk`` at 32 states and more),
    gradients the saveall and deferred reverse's, each at 64."""
    cp = codon_problem
    seen = []
    for name in ("slot_walk_reference", "saveall_walk_reference",
                 "reverse_walk_reference"):
        orig = getattr(cuda_pruning, name)

        def spy(p, leaves, *a, _orig=orig, _name=name, **kw):
            seen.append((_name, leaves.shape[-1]))
            return _orig(p, leaves, *a, **kw)

        monkeypatch.setattr(cuda_pruning, name, spy)
    port = LikelihoodEngine(cp["tree"], cp["aln"], cp["tmodel"], ncat=4,
                            dtype=torch.float32, pruner="cuda",
                            device="cpu")
    port.loglikelihood()
    assert seen == [("slot_walk_reference", 64)]
    seen.clear()
    port.value_and_grad()
    assert seen == [("saveall_walk_reference", 64),
                    ("reverse_walk_reference", 64)]


def _spy_walks(monkeypatch, names):
    """Record the calls of ``cuda_pruning``'s ``names`` (wrappers and plain
    versions) in order."""
    seen = []
    for name in names:
        orig = getattr(cuda_pruning, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            seen.append(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(cuda_pruning, name, spy)
    return seen


def _assert_matches_jax(cp, port, params):
    """The f32 walk's logL, sitewise logL and value_and_grad against the
    JAX f64 XLA engine: 2e-5 relative, 5e-4 x max|g| per leaf."""
    j64 = cp["j64"]
    want = j64.loglikelihood(cp["p"])
    got = port.loglikelihood(params)
    assert np.isfinite(got) and abs(got - want) / abs(want) < 2e-5
    np.testing.assert_allclose(port.sitewise_loglikelihoods(params),
                               j64.sitewise_loglikelihoods(cp["p"]),
                               rtol=2e-5, atol=0)
    lj, gj = j64.value_and_grad(cp["p"])
    lt, gt = port.value_and_grad(params)
    assert abs(float(lt) - float(lj)) < 2e-5 * abs(float(lj))
    want_g = _flat(jax.tree.map(np.asarray, gj))
    for path, g in _flat(gt).items():
        w = want_g[path]
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0,
                                   atol=5e-4 * np.abs(w).max(),
                                   err_msg=str(path))


def test_codon_gradient_through_classic_reverse(codon_problem, monkeypatch):
    """The fault's pin (ROADMAP C): GY94, MG94 and mito GY94 +G4
    ``value_and_grad`` under ``PHYLO_DEFERRED_VJP=0``, ``pruner="cuda"``
    on the CPU, takes B2 and then B7 at 64 states (their plain versions)
    and matches the JAX f64 XLA engine, which returns under the same
    variable. (Before B7 was built at 64 the fused Function raised
    ``NotImplementedError`` here, before B2 ran.)"""
    cp = codon_problem
    monkeypatch.setenv("PHYLO_DEFERRED_VJP", "0")
    seen = _spy_walks(monkeypatch, ("saveall_walk_reference",
                                    "classic_reverse_walk_reference",
                                    "reverse_walk_reference"))
    port = LikelihoodEngine(cp["tree"], cp["aln"], cp["tmodel"], ncat=4,
                            dtype=torch.float32, pruner="cuda", device="cpu")
    params = params_from_jax(cp["full"])
    port.value_and_grad(params)
    assert seen == ["saveall_walk_reference",
                    "classic_reverse_walk_reference"]
    _assert_matches_jax(cp, port, params)


# each knob the JAX package reads, with the walk the port's value call
# takes under it at 6 taxa x 40 codons (within CLASSIC_SCRATCH_BUDGET)
WALK_KNOBS = {
    "force_stream_0": ({"PHYLO_FORCE_STREAM": "0"}, "forward_walk_reference"),
    "force_stream_1": ({"PHYLO_FORCE_STREAM": "1"}, "slot_walk"),
    "force_stream_0_past_budget": ({"PHYLO_FORCE_STREAM": "0",
                                    "CLASSIC_SCRATCH_BUDGET": 0},
                                   "slot_walk"),
    "static_unroll": ({"STATIC_UNROLL_MAX": 10 ** 6}, "static_walk"),
    "fold_auto": ({"PHYLO_FORCE_STREAM": "0",
                   "PHYLO_FOLD_CATEGORIES": "auto"}, "fold_walk"),
    "fold_2": ({"PHYLO_FORCE_STREAM": "0", "PHYLO_FOLD_CATEGORIES": "2"},
               "fold_walk"),
    "static_over_force_stream_1": ({"PHYLO_FORCE_STREAM": "1",
                                    "STATIC_UNROLL_MAX": 10 ** 6},
                                   "static_walk"),
    "deferred_vjp_1": ({"PHYLO_DEFERRED_VJP": "1"}, "slot_walk"),
}


@pytest.mark.parametrize("knob", sorted(WALK_KNOBS))
def test_codon_engine_under_walk_knobs(codon_problem, monkeypatch, knob):
    """Under each value-walk knob (``PHYLO_FORCE_STREAM``,
    ``PHYLO_STATIC_UNROLL_MAX``, ``PHYLO_FOLD_CATEGORIES``), and under
    ``PHYLO_DEFERRED_VJP=1``, the f32 codon engine's value calls take the
    walk the JAX package's rule names (B1, B4 past the classic budget under
    "0", B5 under "1" and by default, B8, B9 with F = 2), all at 64 states,
    and logL, sitewise logL and value_and_grad match the JAX f64 XLA
    engine."""
    cp = codon_problem
    settings, first = WALK_KNOBS[knob]
    for name, value in settings.items():
        if name.isupper() and name.startswith("PHYLO_"):
            monkeypatch.setenv(name, value)
        else:
            monkeypatch.setattr(cuda_pruning, name, value)
    seen = _spy_walks(monkeypatch, ("static_walk", "fold_walk", "slot_walk",
                                    "forward_walk_reference"))
    port = LikelihoodEngine(cp["tree"], cp["aln"], cp["tmodel"], ncat=4,
                            dtype=torch.float32, pruner="cuda", device="cpu")
    params = params_from_jax(cp["full"])
    port.loglikelihood(params)
    assert seen[0] == first
    _assert_matches_jax(cp, port, params)


@pytest.mark.parametrize("code", ["standard", "vertebrate_mito"])
def test_encode_codon_alignment_matches_jax(code):
    aln = _codon_alignment([f"t{i}" for i in range(5)], 30, code, seed=9)
    aln["t4"] = aln["t0"]                       # repeated patterns too
    want = jio.encode_codon_alignment(aln, code=code)
    for got in (tio.encode_codon_alignment(aln, code=code),
                tio.compress_patterns(
                    aln, "codon" if code == "standard" else f"codon:{code}")):
        assert got.names == want.names
        np.testing.assert_array_equal(got.partials, np.asarray(want.partials))
        np.testing.assert_array_equal(got.weights, np.asarray(want.weights))
        np.testing.assert_array_equal(got.site_to_pattern,
                                      np.asarray(want.site_to_pattern))
    with pytest.raises(ValueError, match="stop codon"):
        tio.encode_codon_alignment({"a": "TAAATG", "b": "ATGATG"})
    with pytest.raises(ValueError, match="divisible by 3"):
        tio.encode_codon_alignment({"a": "ATGA", "b": "ATGA"})


@pytest.mark.parametrize("method", ["f1x4", "f3x4", "f61"])
@pytest.mark.parametrize("code", ["standard", "vertebrate_mito"])
def test_empirical_codon_frequencies_match_jax(method, code):
    aln = _codon_alignment([f"t{i}" for i in range(4)], 25, code, seed=2)
    np.testing.assert_array_equal(
        tcodon.empirical_codon_frequencies(aln, method, code),
        jcodon.empirical_codon_frequencies(aln, method, code))


def test_codon_tables_and_q_match_jax():
    """The copied tables, the GY94/MG94 rate matrices (to 1e-14) and the
    registry names."""
    from phylo_utils_tpu.models.base import build_rate_matrix as jbuild

    for code in jcodon.GENETIC_CODES:
        assert tcodon.code_tables(code) == jcodon.code_tables(code)
    assert tcodon.CODONS == jcodon.CODONS
    assert tmodels.get_model("gy94") is tmodels.GY94
    assert tmodels.get_model("MG94") is tmodels.MG94
    for tm, jm, p in (
            (tmodels.GY94, jcodon.GY94, {"kappa": 3.0, "omega": 0.4}),
            (tmodels.MG94, jcodon.MG94,
             {"kappa": 3.0, "omega": 0.4, "nuc_freqs": NUC_FREQS})):
        got = tm.eigen(p)
        sym, freqs = jm.build_parts(p)
        np.testing.assert_allclose(got.q.numpy(),
                                   np.asarray(jbuild(sym, freqs)), rtol=0,
                                   atol=1e-14)
        np.testing.assert_allclose(got.freqs.numpy(), np.asarray(freqs),
                                   rtol=0, atol=1e-15)


@pytest.mark.parametrize("name", ["GY94", "MG94"])
def test_dn_ds_by_branch_matches_jax(name):
    t = np.random.default_rng(4).uniform(0.05, 0.5, 9)
    p = {"kappa": 2.2, "omega": 0.27}
    if name == "MG94":
        p["nuc_freqs"] = NUC_FREQS
    got = tcodon.dn_ds_by_branch(getattr(tmodels, name), p, t)
    want = jcodon.dn_ds_by_branch(getattr(jcodon, name), p, t)
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-12, atol=0,
                                   err_msg=key)
    np.testing.assert_allclose(got["dN"] / got["dS"], 0.27, rtol=1e-12)
    assert abs(got["S"] + got["N"] - 3.0) < 1e-12
