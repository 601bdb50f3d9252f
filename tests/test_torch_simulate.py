"""Port parity, simulation: ``phylo_utils_tpu_torch.simulate`` against
``phylo_utils_tpu.simulate`` (``tests/test_simulate.py``'s cases on the
port), on the CPU (``device="cpu"``).

torch cannot reproduce ``jax.random``'s streams, so the two packages are
held to the same distribution, not the same draws: each package's output
is tested against expectations computed from the JAX package's transition
matrices. Bounds, fixed before any run:
- a frequency or identity fraction: 5 binomial sigma around its
  expectation (``_sigma5``);
- the joint leaf-pair table over 16 cells: its chi-square statistic below
  the 1 - 1e-6 quantile of chi-square with 15 degrees of freedom
  (``CHI2_BOUND``), for the port's and the JAX package's draws alike;
- the JAX package's own tolerances where a case mirrors one of its tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu import simulate as jsim
from phylo_utils_tpu.io import parse_newick as j_parse_newick
from phylo_utils_tpu.models.codon import make_gy94 as j_make_gy94
from phylo_utils_tpu.ops.pmatrix import transition_matrices as j_pmat
from phylo_utils_tpu.trees import random_tree as j_random_tree
from phylo_utils_tpu_torch import models
from phylo_utils_tpu_torch.io import parse_newick
from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
from phylo_utils_tpu_torch.models.codon import make_gy94
from phylo_utils_tpu_torch.optimize import fit
from phylo_utils_tpu_torch.simulate import (
    SequenceSimulator,
    simulate_alignment,
    simulate_branch_alignment,
    simulate_mixture_alignment,
    simulate_states,
)
from phylo_utils_tpu_torch.trees import random_tree

from torch_threads import one_thread  # noqa: F401

CHI2_BOUND = float(scipy.stats.chi2.isf(1e-6, 15))
DNA_INDEX = {c: i for i, c in enumerate("ACGT")}


def _sigma5(p, n):
    return 5.0 * np.sqrt(p * (1.0 - p) / n)


def _codes(seq):
    return np.asarray([DNA_INDEX[c] for c in seq])


def test_reproducible_and_shapes():
    tree = random_tree(6, seed=0)
    a1 = simulate_alignment(42, tree, models.HKY85, 50, ncat=4,
                            device="cpu")
    a2 = simulate_alignment(42, tree, models.HKY85, 50, ncat=4,
                            device="cpu")
    a3 = simulate_alignment(43, tree, models.HKY85, 50, ncat=4,
                            device="cpu")
    assert a1 == a2 and a1 != a3
    gen = torch.Generator().manual_seed(42)
    assert simulate_alignment(gen, tree, models.HKY85, 50, ncat=4) == a1
    assert set(a1) == set(tree.leaf_names)
    assert all(len(s) == 50 for s in a1.values())
    assert set("".join(a1.values())) <= set("ACGT")


def test_root_states_follow_equilibrium():
    freqs = [0.4, 0.3, 0.2, 0.1]
    n = 20000
    states, _ = simulate_states(0, parse_newick("(a:0.1,b:0.1);"),
                                models.F81, n, params={"freqs": freqs},
                                device="cpu")
    j_states, _ = jsim.simulate_states(
        jax.random.key(0), j_parse_newick("(a:0.1,b:0.1);"), jmodels.F81, n,
        params={"freqs": freqs})
    for root in (states[2].numpy(), np.asarray(j_states[2])):
        emp = np.bincount(root, minlength=4) / n
        np.testing.assert_allclose(emp, freqs, atol=0.015)
        assert (np.abs(emp - freqs) <= _sigma5(np.asarray(freqs), n)).all()


def test_substitution_fraction_matches_jc69_expectation():
    """Leaf-vs-root identity fraction on one branch ~ P_ii(t)."""
    t, n = 0.3, 40000
    states, _ = simulate_states(1, parse_newick(f"(a:{t},b:{t});"),
                                models.JC69, n, device="cpu")
    st = states.numpy()
    p_same = 0.25 + 0.75 * np.exp(-4.0 * t / 3.0)
    for leaf in range(2):
        frac_same = np.mean(st[leaf] == st[2])
        assert frac_same == pytest.approx(p_same, abs=0.01)
        assert abs(frac_same - p_same) <= _sigma5(p_same, n)


@pytest.mark.parametrize("model", ["GTR", "HKY85"])
def test_leaf_pair_frequencies_match_jax_transition_matrices(model):
    """The joint (a, b) state table on ``(a:t1,b:t2);`` over 40,000 sites
    is pi_i P_ij(t1 + t2), with P from the JAX package; the port's and the
    JAX package's draws both pass the same chi-square bound."""
    t1, t2, n = 0.15, 0.35, 40000
    params = ({"rates": [1.2, 3.1, 0.7, 0.9, 4.2, 1.0],
               "freqs": [0.3, 0.2, 0.22, 0.28]} if model == "GTR"
              else {"kappa": 4.0, "freqs": [0.1, 0.2, 0.3, 0.4]})
    newick = f"(a:{t1},b:{t2});"
    eig = getattr(jmodels, model).eigen(
        {k: jnp.asarray(v) for k, v in params.items()})
    pi = np.asarray(eig.freqs)
    expected = n * pi[:, None] * np.asarray(j_pmat(eig, jnp.asarray(t1 + t2)))
    port = simulate_alignment(7, newick, getattr(models, model), n,
                              params=params, device="cpu")
    jax_aln = jsim.simulate_alignment(
        jax.random.key(7), newick, getattr(jmodels, model), n,
        params=params)
    for aln in (port, jax_aln):
        table = np.zeros((4, 4))
        np.add.at(table, (_codes(aln["a"]), _codes(aln["b"])), 1.0)
        chi2 = float(((table - expected) ** 2 / expected).sum())
        assert chi2 < CHI2_BOUND, (chi2, CHI2_BOUND)


def test_invariant_sites_are_invariant():
    tree = random_tree(8, seed=2, mean_brlen=0.5)
    states, site_rates = simulate_states(3, tree, models.GTR, 2000, ncat=4,
                                         pinv=0.3, device="cpu")
    st, inv = states.numpy(), site_rates.numpy() == 0.0
    assert 0.2 < inv.mean() < 0.4
    assert abs(inv.mean() - 0.3) <= _sigma5(0.3, 2000)
    assert (st[:, inv] == st[tree.root, inv][None, :]).all()
    assert (st[:, ~inv] != st[tree.root, ~inv][None, :]).any()


def test_fit_recovers_simulated_kappa():
    """End-to-end loop: simulate under K80 kappa=4, fit recovers it (the
    JAX test's 15% bound)."""
    tree = random_tree(8, seed=4, mean_brlen=0.15)
    aln = simulate_alignment(5, tree, models.K80, 3000,
                             params={"kappa": 4.0}, device="cpu")
    engine = LikelihoodEngine(tree, aln, models.K80, device="cpu")
    res = fit(engine, max_steps=100, patience=15)
    assert float(res.params["model"]["kappa"]) == pytest.approx(4.0, rel=0.15)


def test_oo_facade():
    sim = SequenceSimulator("(a:0.1,(b:0.2,c:0.05):0.1);", models.LG, seed=7,
                            device="cpu")
    aln = sim.simulate(30)
    assert set(aln) == {"a", "b", "c"}
    assert set("".join(aln.values())) <= set("ARNDCQEGHILKMFPSTWYV")
    assert aln != sim.simulate(30)          # the generator advances
    again = SequenceSimulator("(a:0.1,(b:0.2,c:0.05):0.1);", models.LG,
                              seed=7, device="cpu")
    assert again.simulate(30) == aln


def test_simulate_with_explicit_alpha():
    """params={'alpha': ...} with ncat > 1 reaches the rates, not the model
    builder, and alpha changes the site-rate dispersion."""
    tree = random_tree(6, seed=20, mean_brlen=0.3)
    _, r_small = simulate_states(5, tree, models.JC69, 4000,
                                 params={"alpha": 0.05}, ncat=8,
                                 device="cpu")
    _, r_big = simulate_states(5, tree, models.JC69, 4000,
                               params={"alpha": 50.0}, ncat=8, device="cpu")
    assert float(r_small.std()) > float(r_big.std())


@pytest.mark.parametrize("code", ["standard", "vertebrate_mito"])
def test_codon_alignment_is_three_characters_a_site(code):
    model = (models.GY94 if code == "standard"
             else make_gy94("vertebrate_mito"))
    aln = simulate_alignment(0, random_tree(4, seed=0), model, 10,
                             device="cpu")
    assert all(len(s) == 30 for s in aln.values())
    from phylo_utils_tpu_torch.models.codon import code_tables

    sense = set(code_tables(code)[0])
    assert all(s[i:i + 3] in sense for s in aln.values()
               for i in range(0, 30, 3))


def test_mito_mixture_sites_are_codons_unlike_the_reference():
    """``simulate_mixture_alignment`` on a vertebrate-mito codon model
    writes 3 characters a site. The JAX package cuts each site one
    character wide there (its alphabet test is ``== "codon"``, not
    ``startswith``): a reference fault pinned here (ROADMAP C)."""
    mixture = [{"omega": 0.1}, {"omega": 2.0}]
    port, cls = simulate_mixture_alignment(
        0, random_tree(4, seed=0), make_gy94("vertebrate_mito"), 10,
        mixture, device="cpu")
    assert cls.shape == (10,)
    assert all(len(s) == 30 for s in port.values())
    j_aln, _ = jsim.simulate_mixture_alignment(
        jax.random.key(0), j_random_tree(4, seed=0),
        j_make_gy94("vertebrate_mito"), 10, mixture)
    assert all(len(s) == 10 for s in j_aln.values())


def test_simulate_mixture_alignment():
    """Shapes and class draws of the GY94 mixture case of the JAX test, and
    each class's sites simulated under its own omega: the synonymous share
    of codon differences is higher where omega is low."""
    from phylo_utils_tpu_torch.models.codon import code_tables

    tree = random_tree(6, seed=3, mean_brlen=0.25)
    n = 600
    aln, cls = simulate_mixture_alignment(
        4, tree, models.GY94, n, mixture=[{"omega": 0.05}, {"omega": 8.0}],
        weights=[0.6, 0.4], shared={"kappa": 2.0}, device="cpu")
    assert cls.shape == (n,)
    assert all(len(s) == 3 * n for s in aln.values())
    assert abs(float((cls == 1).mean()) - 0.4) <= _sigma5(0.4, n)
    to_aa = code_tables("standard")[1]
    seqs = list(aln.values())
    syn = np.zeros(2)
    diff = np.zeros(2)
    for i in range(n):
        cods = {s[3 * i:3 * i + 3] for s in seqs}
        if len(cods) > 1:
            diff[cls[i]] += 1
            syn[cls[i]] += len({to_aa[c] for c in cods}) == 1
    assert syn[0] / diff[0] > syn[1] / diff[1] + 0.2


def test_branch_alignment_identity_fractions_per_class():
    """Two cherries, one under each edge class (HKY85, shared frequencies,
    kappa 1 and 30): each cherry's identity fraction is
    sum_j pi_j P_jj(2 t) of its class (reversibility), for the port's and
    the JAX package's draws alike (5 sigma)."""
    t, n = 0.5, 20000
    newick = f"((a:{t},b:{t}):0.1,(c:{t},d:{t}):0.1);"
    shared = {"freqs": [0.1, 0.2, 0.3, 0.4]}
    class_params = [{"kappa": 1.0}, {"kappa": 30.0}]
    # node ids: a b c d (0-3), ab (4), cd (5), root (6)
    classes = [0, 0, 1, 1, 0, 1, 0]
    port = simulate_branch_alignment(0, newick, models.HKY85, classes,
                                     class_params, n, shared=shared,
                                     device="cpu")
    jax_aln = jsim.simulate_branch_alignment(
        jax.random.key(0), newick, jmodels.HKY85, classes, class_params, n,
        shared=shared)
    expect = []
    for c in range(2):
        eig = jmodels.HKY85.eigen({k: jnp.asarray(v) for k, v in
                                   {**shared, **class_params[c]}.items()})
        p = np.asarray(j_pmat(eig, jnp.asarray(2 * t)))
        expect.append(float(np.asarray(eig.freqs) @ np.diag(p)))
    assert abs(expect[0] - expect[1]) > 4 * _sigma5(expect[0], n)
    for aln in (port, jax_aln):
        for c, (x, y) in enumerate((("a", "b"), ("c", "d"))):
            frac = float(np.mean(_codes(aln[x]) == _codes(aln[y])))
            assert abs(frac - expect[c]) <= _sigma5(expect[c], n), (c, frac)


def test_simulate_and_recover_omega():
    """Simulate GY94 under purifying selection (omega=0.2); the fit
    recovers omega < 0.5 (``tests/test_codon.py``'s case)."""
    tree = random_tree(6, seed=2, mean_brlen=0.15)
    aln = simulate_alignment(3, tree, models.GY94, 400,
                             params={"kappa": 2.0, "omega": 0.2},
                             device="cpu")
    assert all(len(s) == 1200 for s in aln.values())
    engine = LikelihoodEngine(tree, aln, models.GY94, device="cpu")
    res = fit(engine, {"model": {"kappa": 2.0, "omega": 1.0}},
              free=("branch_lengths", "model"), max_steps=80, patience=15)
    assert float(res.params["model"]["omega"]) < 0.5


def test_default_device_is_the_card():
    """Without a device or a generator the simulator runs on the card, and
    raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        simulate_alignment(0, "(a:0.1,b:0.1);", models.JC69, 5)
