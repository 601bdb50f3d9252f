"""Port parity, mixtures: ``ModelMixtureEngine``, ``ProfileMixtureEngine``
(profiles, weights, class rates, per-class matrices), the ``models.nex``
loader, ``GammaMixture`` and the CLI's ``--profile-mixture``, against the
JAX package on the same inputs (``tests/test_mixtures.py``,
``tests/test_profile_mixtures.py`` and ``tests/test_matrix_mixtures.py``).

Tolerances: 1e-10 (relative in logL, absolute in sitewise logL, posteriors
and gradients x max|g|) where both packages run float64 through their plain
pruners; the port's ``pruner="cuda"`` runs its kernels' plain walks in
float32 on CPU tensors (P and the root reduction in float64), held at 1e-6
relative in logL and 5e-4 x max|g| in gradients, the bounds the port holds
its kernels to on the card. JAX's mixture engine raises on
``loglikelihood_many`` (a TypeError: its ``_loglik_fn`` takes no ``eig``);
the port's raises ``NotImplementedError``.
"""
import json

import jax
import numpy as np
import pytest
import torch

from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu.cli import main as jax_main
from phylo_utils_tpu.io import parse_newick as j_parse_newick
from phylo_utils_tpu.io import write_fasta
from phylo_utils_tpu.likelihood import GammaMixture as JGammaMixture
from phylo_utils_tpu.mixtures import ModelMixtureEngine as JModelMixture
from phylo_utils_tpu.models.base import Model as JModel
from phylo_utils_tpu.profile_mixtures import (
    ProfileMixtureEngine as JProfileMixture,
)
from phylo_utils_tpu.profile_mixtures import (
    parse_nexus_models as j_parse_nexus_models,
)
from phylo_utils_tpu.profile_mixtures import (
    profile_mixture_from_nexus as j_profile_mixture_from_nexus,
)
from phylo_utils_tpu.simulate import simulate_mixture_alignment
from phylo_utils_tpu_torch import cli
from phylo_utils_tpu_torch import models as tmodels
from phylo_utils_tpu_torch.convert import flatten_params, params_from_jax
from phylo_utils_tpu_torch.data import LG_FREQS, LG_RATES, WAG_FREQS
from phylo_utils_tpu_torch.io import parse_newick, write_newick
from phylo_utils_tpu_torch.likelihood import GammaMixture
from phylo_utils_tpu_torch.mixtures import ModelMixtureEngine
from phylo_utils_tpu_torch.models.base import Model
from phylo_utils_tpu_torch.optimize import fit
from phylo_utils_tpu_torch.profile_mixtures import (
    ProfileMixtureEngine,
    parse_nexus_models,
    profile_mixture_from_nexus,
)
from phylo_utils_tpu_torch.trees import random_tree

from torch_threads import one_thread  # noqa: F401

AA = "ARNDCQEGHILKMFPSTWYV"
TREE4 = "((a:0.1,b:0.2):0.05,(c:0.3,d:0.15):0.07);"
ALN4 = {"a": "ACGTACGTGG", "b": "ACGTTGCAGG", "c": "AGGTACGAGT",
        "d": "ACGAACGTAT"}
F64 = dict(dtype="float64")
T64 = dict(dtype=torch.float64, device="cpu", pruner="torch")
T32 = dict(dtype=torch.float32, device="cpu", pruner="cuda")


def _profiles():
    """``tests/test_profile_mixtures.py``'s three synthetic profiles."""
    prof = np.tile(np.full(20, 0.02), (3, 1))
    for k, boost in enumerate([("A", "V", "I", "L", "F", "M"),
                               ("D", "E", "K", "R", "H"),
                               ("G", "S", "T", "N", "P")]):
        for ch in boost:
            prof[k, AA.index(ch)] = 0.12
    return prof / prof.sum(axis=1, keepdims=True)


@pytest.fixture(scope="module")
def het_data():
    """200 sites simulated by the JAX package under a 3-profile LG mixture
    on a 10-taxon tree (``tests/test_profile_mixtures.py``'s fixture, cut
    from 12 taxa x 600 sites); the newick is the port's ``random_tree``."""
    newick = write_newick(random_tree(10, seed=4, mean_brlen=0.25))
    aln, _ = simulate_mixture_alignment(
        jax.random.key(1), j_parse_newick(newick), jmodels.LG, 200,
        mixture=[{"freqs": tuple(p.tolist())} for p in _profiles()],
        weights=[0.5, 0.3, 0.2])
    return newick, aln


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x,
                      np.float64)


def _grad_err(got, want):
    """max |got - want| / max |want| over every leaf of the gradients."""
    jpaths, jleaves = flatten_params(want)
    tgot = dict(zip(*flatten_params(got)))
    scale = max(np.abs(_np(w)).max() for w in jleaves)
    return max(np.abs(_np(tgot[p]) - _np(w)).max()
               for p, w in zip(jpaths, jleaves)) / scale


def _check_engine_pair(je, te, params, rtol, gtol):
    """logL, sitewise, category posteriors and value_and_grad of one JAX
    and one port engine at ``params``."""
    ll_j, ll_t = je.loglikelihood(params), te.loglikelihood(params)
    assert abs(ll_t - ll_j) <= rtol * abs(ll_j)
    sw_j = je.sitewise_loglikelihoods(params)
    sw_t = te.sitewise_loglikelihoods(params)
    assert sw_t.shape == sw_j.shape
    np.testing.assert_allclose(sw_t, sw_j, rtol=rtol, atol=rtol)
    np.testing.assert_allclose(te.category_posteriors(params),
                               np.asarray(je.category_posteriors(params)),
                               rtol=0, atol=max(rtol, 1e-10) * 10)
    vj, gj = je.value_and_grad(params)
    vt, gt = te.value_and_grad(params)
    assert abs(float(vt) - float(vj)) <= rtol * abs(float(vj))
    assert _grad_err(gt, gj) <= gtol
    return gt


def test_kappa_mixture_matches_jax():
    """``tests/test_mixtures.py:33-48``: HKY85 over two kappa classes,
    weights (0.3, 0.7), in float64 (1e-10) and through the kernels' plain
    walks (float32 walk, 1e-6); a batched call raises in both packages."""
    mixture = [{"kappa": 1.0}, {"kappa": 8.0}]
    je = JModelMixture(j_parse_newick(TREE4), ALN4, jmodels.HKY85, mixture,
                       compress=False, **F64)
    params = {"cat_weights": [0.3, 0.7]}
    for kw, rtol, gtol in ((T64, 1e-10, 1e-10), (T32, 1e-6, 5e-4)):
        te = ModelMixtureEngine(parse_newick(TREE4), ALN4, tmodels.HKY85,
                                mixture, compress=False, **kw)
        assert set(te.default_params()) == {"branch_lengths", "mixture",
                                            "cat_weights"}
        g = _check_engine_pair(je, te, params, rtol, gtol)
        assert g["mixture"]["kappa"].shape == (2,)
        assert g["mixture"]["freqs"].shape == (2, 4)
    with pytest.raises(TypeError):
        je.loglikelihood_many(np.ones((2, 6)))
    with pytest.raises(NotImplementedError):
        te.loglikelihood_many(np.ones((2, 6)))
    with pytest.raises(NotImplementedError):
        te.value_and_grad_many(np.ones((2, 6)))


def test_kappa_mixture_with_invariant_sites_and_bootstrap():
    """+I under the weight-averaged frequencies, and the bootstrap (one
    pruning pass, reweighted) as JAX's."""
    mixture = [{"kappa": 1.5}, {"kappa": 6.0}]
    aln = {n: s + s[::-1] for n, s in ALN4.items()}
    je = JModelMixture(j_parse_newick(TREE4), aln, jmodels.HKY85, mixture,
                       invariant_sites=True, **F64)
    te = ModelMixtureEngine(parse_newick(TREE4), aln, tmodels.HKY85,
                            mixture, invariant_sites=True, **T64)
    params = {"cat_weights": [0.6, 0.4], "pinv": 0.15}
    _check_engine_pair(je, te, params, 1e-10, 1e-10)
    np.testing.assert_allclose(
        te.bootstrap_loglikelihoods(20, params, seed=2),
        je.bootstrap_loglikelihoods(20, params, seed=2), rtol=1e-10)


@pytest.mark.parametrize("pruner", ["torch", "cuda"])
def test_profile_mixture_matches_jax(het_data, pruner):
    """Three profiles with weights (0.5, 0.3, 0.2) and free class rates,
    held to JAX's f64 engine: logL, sitewise, posteriors, and the gradient
    in every parameter (branch lengths, profiles, weights, class rates)."""
    newick, aln = het_data
    kw = dict(profiles=_profiles(), weights=[0.5, 0.3, 0.2],
              class_rates="free")
    je = JProfileMixture(j_parse_newick(newick), aln, jmodels.LG, **kw,
                         **F64)
    te = ProfileMixtureEngine(parse_newick(newick), aln, tmodels.LG, **kw,
                              **(T64 if pruner == "torch" else T32))
    params = {"class_rates": [0.7, 1.0, 1.6]}
    rtol, gtol = (1e-10, 1e-10) if pruner == "torch" else (1e-6, 5e-4)
    g = _check_engine_pair(je, te, params, rtol, gtol)
    assert set(g) == {"branch_lengths", "mixture", "cat_weights",
                      "class_rates"}
    # the JAX engine's parameters carried across give the same logL
    full = params_from_jax({k: (np.asarray(v) if not isinstance(v, dict)
                                else {kk: np.asarray(vv)
                                      for kk, vv in v.items()})
                            for k, v in je._full_params(params).items()})
    assert te.loglikelihood(full) == pytest.approx(
        je.loglikelihood(params), rel=rtol)


def test_profile_mixture_random_start_and_equal_rates(het_data):
    """``profiles=K`` draws the JAX package's seeded perturbation of the
    base frequencies; "equal" class rates add no parameter."""
    newick, aln = het_data
    je = JProfileMixture(j_parse_newick(newick), aln, jmodels.LG,
                         profiles=4, seed=3, **F64)
    te = ProfileMixtureEngine(parse_newick(newick), aln, tmodels.LG,
                              profiles=4, seed=3, **T64)
    np.testing.assert_allclose(
        _np(te.default_params()["mixture"]["freqs"]),
        np.asarray(je.default_params()["mixture"]["freqs"]), rtol=1e-15)
    assert "class_rates" not in te.default_params()
    assert te.loglikelihood() == pytest.approx(je.loglikelihood(), rel=1e-10)


def _variant(rates, power):
    """``tests/test_matrix_mixtures.py``'s deterministic exchangeability
    variant."""
    v = np.asarray(rates, np.float64) ** power
    np.fill_diagonal(v, 0.0)
    return v


def _class_models(package):
    """LG, WAG and an LG variant as per-class Models of either package
    (``tests/test_matrix_mixtures.py:87-113``'s classes, three of four)."""
    from phylo_utils_tpu.data import LG_RATES as J_LG_RATES
    from phylo_utils_tpu.data import WAG_RATES as J_WAG_RATES

    syms = [np.asarray(J_LG_RATES, np.float64),
            np.asarray(J_WAG_RATES, np.float64), _variant(LG_RATES, 0.6)]
    freqs = [np.asarray(f, np.float64) / np.sum(f)
             for f in (LG_FREQS, WAG_FREQS, WAG_FREQS)]
    out = []
    for i, (s, f) in enumerate(zip(syms, freqs)):
        if package == "jax":
            import jax.numpy as jnp

            def build(freqs, s=s):
                freqs = jnp.asarray(freqs)
                return jnp.asarray(s, freqs.dtype), freqs
            out.append(JModel(f"mat{i}", 20, "protein",
                              {"freqs": tuple(f.tolist())}, build))
        else:
            def build(freqs, s=s):
                return torch.as_tensor(s, dtype=freqs.dtype,
                                       device=freqs.device), freqs
            out.append(Model(f"mat{i}", 20, "protein",
                             {"freqs": tuple(f.tolist())}, build))
    return out, np.stack(freqs)


def test_matrix_mixture_matches_jax(het_data):
    """Per-class exchangeability matrices (``class_models``) with weights
    and explicit class rates, float64, and their validation errors."""
    newick, aln = het_data
    jcm, prof = _class_models("jax")
    tcm, _ = _class_models("torch")
    kw = dict(profiles=prof, weights=[0.4, 0.35, 0.25],
              class_rates=[0.5, 1.0, 1.5])
    je = JProfileMixture(j_parse_newick(newick), aln, jmodels.LG,
                         class_models=jcm, **kw, **F64)
    te = ProfileMixtureEngine(parse_newick(newick), aln, tmodels.LG,
                              class_models=tcm, **kw, **T64)
    _check_engine_pair(je, te, None, 1e-10, 1e-10)
    with pytest.raises(ValueError, match="entries for"):
        ProfileMixtureEngine(parse_newick(newick), aln, tmodels.LG,
                             profiles=prof, class_models=tcm[:2], **T64)


def _nexus_text(prof):
    """``tests/test_profile_mixtures.py``'s FMIX text over two of the
    profiles, and ``tests/test_matrix_mixtures.py``'s MIX text (a GTR20
    matrix definition, a frequency vector, LG and WAG)."""
    f1, f2 = (" ".join(f"{x:.6f}" for x in prof[i]) for i in (0, 1))
    var = _variant(LG_RATES, 0.6)
    tri = " ".join(f"{var[i, j]:.6f}" for i in range(1, 20)
                   for j in range(i))
    fv = " ".join(f"{x:.6f}" for x in WAG_FREQS / np.sum(WAG_FREQS))
    return (
        "#nexus\nbegin models;\n"
        "    [ synthetic test mixtures ]\n"
        f"    frequency TESTpi1 = {f1};\n    frequency TESTpi2 = {f2};\n"
        "    model TEST = LG+FMIX{TESTpi1:1.0:0.6,TESTpi2:1.0:0.4};\n"
        "    model TESTR = LG+FMIX{TESTpi1:0.5:0.6,TESTpi2:2.0:0.4};\n"
        f"    model VARMAT = {tri} {fv};\n"
        f"    frequency FALT = {f1};\n"
        "    model TESTMIX = MIX{VARMAT:1.0:0.5,LG+FU{FALT}:1.0:0.3,"
        "WAG:1.0:0.2};\n"
        "end;\n"
    )


def test_nexus_loader_matches_jax(het_data, tmp_path):
    """``parse_nexus_models`` returns JAX's dict on the same text, and
    ``profile_mixture_from_nexus`` JAX's engines (FMIX with equal and with
    per-class rates, and the MIX matrix mixture)."""
    newick, aln = het_data
    path = tmp_path / "models.nex"
    path.write_text(_nexus_text(_profiles()))
    got, want = parse_nexus_models(str(path)), j_parse_nexus_models(str(path))
    assert got["models"] == want["models"]
    for part in ("frequencies", "matrices"):
        assert set(got[part]) == set(want[part])
    for name, f in want["frequencies"].items():
        np.testing.assert_array_equal(got["frequencies"][name], f)
    for key in ("sym", "freqs"):
        np.testing.assert_array_equal(got["matrices"]["VARMAT"][key],
                                      want["matrices"]["VARMAT"][key])
    for name in ("TEST", "TESTR", "TESTMIX"):
        je = j_profile_mixture_from_nexus(str(path), name,
                                          j_parse_newick(newick), aln,
                                          jmodels.LG, **F64)
        te = profile_mixture_from_nexus(str(path), name,
                                        parse_newick(newick), aln,
                                        tmodels.LG, **T64)
        assert te.ncat == je.ncat
        assert set(te.default_params()) == set(je.default_params())
        assert te.loglikelihood() == pytest.approx(je.loglikelihood(),
                                                   rel=1e-10)
    with pytest.raises(ValueError, match="not in file"):
        profile_mixture_from_nexus(str(path), "C60", parse_newick(newick),
                                   aln, tmodels.LG, **T64)


def test_profile_validation_errors():
    """``tests/test_profile_mixtures.py:186`` and the class-rate checks:
    the port raises where JAX raises, with the same messages."""
    tree, aln = parse_newick(TREE4), {n: "ARND" for n in "abcd"}
    jtree = j_parse_newick(TREE4)
    prof = _profiles()
    cases = [
        (dict(profiles=np.zeros((2, 20))), "positive"),
        (dict(profiles=np.full((2, 4), 0.25)), "states"),
        (dict(profiles=prof, class_rates=[1.0, -1.0, 1.0]), "positive"),
        (dict(profiles=prof, class_rates=[1.0, 2.0]), "shape"),
        (dict(profiles=prof, class_rates="fast"), "class_rates"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            JProfileMixture(jtree, aln, jmodels.LG, **kw)
        with pytest.raises(ValueError, match=match):
            ProfileMixtureEngine(tree, aln, tmodels.LG, **kw, **T64)
    te = ProfileMixtureEngine(tree, aln, tmodels.LG, profiles=prof, **T64)
    with pytest.raises(ValueError, match="unknown parameter"):
        te.loglikelihood({"cat_weight": [0.5, 0.3, 0.2]})
    with pytest.raises(ValueError, match="unknown 'mixture' parameter"):
        te.loglikelihood({"mixture": {"freq": prof}})
    with pytest.raises(ValueError, match="at least 2"):
        ModelMixtureEngine(tree, ALN4, tmodels.HKY85, [{"kappa": 2.0}],
                           **T64)


def test_mixture_fit_raises_loglik(het_data):
    """A few L-BFGS steps over branch lengths and class weights through the
    kernels' plain walks raise logL, and the result is the engine's logL at
    the returned params."""
    newick, aln = het_data
    te = ProfileMixtureEngine(parse_newick(newick), aln, tmodels.LG,
                              profiles=_profiles(), **T32)
    start = te.loglikelihood()
    res = fit(te, free=("branch_lengths", "cat_weights"), max_steps=3,
              patience=10)
    assert res.loglik > start and res.n_steps == 3
    assert te.loglikelihood(res.params) == res.loglik
    w = _np(res.params["cat_weights"])
    assert w.shape == (3,) and abs(w.sum() - 1.0) < 1e-12


def test_gamma_mixture_facade_matches_jax():
    """``GammaMixture``: the reference API over one engine, against JAX's
    facade (``tests/test_facades.py``'s inputs), then one small fit (K80's
    kappa, which both optimizers take to its optimum in a few steps) held
    to JAX's at its final logL and estimate (the optimizers differ)."""
    aln = {"a": "ACGTACGTGGACTGAC", "b": "ACGTTGCAGGACTGAC",
           "c": "AGGTACGAGTTCTGAC", "d": "ACGAACGTATACTGAC"}
    jg = JGammaMixture(alpha=0.5, ncat=4, model=jmodels.HKY85, dtype="float64")
    tg = GammaMixture(alpha=0.5, ncat=4, model=tmodels.HKY85,
                      dtype=torch.float64, device="cpu")
    for g, tree in ((jg, j_parse_newick(TREE4)), (tg, parse_newick(TREE4))):
        g.set_alignment(aln).set_tree(tree)
        g.update_substitution_model(kappa=2.5)
        g.update_alpha(1.2)
        g.update_branch_lengths(np.full(7, 0.12))
    assert tg.get_likelihood() == pytest.approx(jg.get_likelihood(),
                                                rel=1e-12)
    np.testing.assert_allclose(tg.get_sitewise_likelihoods(),
                               jg.get_sitewise_likelihoods(), atol=1e-12)
    assert _grad_err(tg.get_gradient(), jg.get_gradient()) <= 1e-10
    with pytest.raises(ValueError, match="set_alignment"):
        GammaMixture(alpha=0.5, ncat=2, model=tmodels.JC69,
                     device="cpu").get_likelihood()
    tg.update_substitution_model(tmodels.K80)
    jg.update_substitution_model(jmodels.K80)
    assert tg.get_likelihood() == pytest.approx(jg.get_likelihood(),
                                                rel=1e-12)
    ll0 = tg.get_likelihood()
    rt = tg.optimise(free=("model",), max_steps=12, patience=4)
    rj = jg.optimise(free=("model",), max_steps=12, patience=4)
    assert rt.loglik > ll0
    assert rt.loglik == pytest.approx(rj.loglik, rel=1e-8)
    assert float(rt.params["model"]["kappa"]) == pytest.approx(
        float(rj.params["model"]["kappa"]), rel=1e-3)
    assert tg.get_likelihood() == pytest.approx(rt.loglik, abs=1e-9)


@pytest.fixture
def nexus_cli_inputs(het_data, tmp_path):
    newick, aln = het_data
    fasta = tmp_path / "aln.fa"
    write_fasta(aln, path=str(fasta))
    nex = tmp_path / "models.nex"
    nex.write_text(_nexus_text(_profiles()))
    return newick, str(fasta), str(nex)


def test_cli_profile_mixture_matches_jax_cli(nexus_cli_inputs, capsys):
    """``loglik --profile-mixture FILE.nex:NAME --sitewise`` against the JAX
    CLI's JSON (1e-10), and its refusals: +G/+I, --recode,
    --shard-sites."""
    newick, fasta, nex = nexus_cli_inputs
    args = ["loglik", "--tree", newick, "--alignment", fasta, "--model",
            "LG", "--dtype", "float64", "--profile-mixture",
            f"{nex}:TESTR", "--sitewise"]
    assert jax_main(args) == 0
    want = json.loads(capsys.readouterr().out)
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["loglik"] == pytest.approx(want["loglik"], rel=1e-10)
    np.testing.assert_allclose(got["sitewise"], want["sitewise"], atol=1e-10)
    base = ["loglik", "--tree", newick, "--alignment", fasta, "--device",
            "cpu", "--profile-mixture", f"{nex}:TEST"]
    for extra, match in ((["--model", "LG+G4"], "does not compose"),
                         (["--invariant-sites"], "does not compose"),
                         (["--recode", "dayhoff6"], "does not support"),
                         (["--shard-sites"], "does not support"),
                         (["--partitions", "p.txt"], "does not support")):
        with pytest.raises(SystemExit, match=match):
            cli.main(base + extra)
    with pytest.raises(SystemExit, match="FILE.nex:MODELNAME"):
        cli.main(base[:-1] + ["models.nex"])
    with pytest.raises(SystemExit, match="not in file"):
        cli.main(base[:-1] + [f"{nex}:C20"])
