"""Port parity, partitions: ``phylo_utils_tpu_torch.partition`` and
``io.parse_partition_file`` mirror ``tests/test_partition.py`` and are held
to the JAX package on the same loci.

Tolerances (float64, ``pruner="torch"``): total and per-partition logL to
1e-10 relative against the JAX engines, gradients to ``rtol=1e-8,
atol=1e-10``; a fit's logL to 1e-8 relative against the JAX engine's logL
at the fitted parameters; standard errors to 1e-4 relative against the JAX
package's at the same parameters (the port takes central differences of
the exact gradient where the model is free, JAX its exact Hessian);
``parse_partition_file``'s dicts and the '+F' initial frequencies equal.
The simulator is held by shape and distribution (torch cannot replay
``jax.random``).
"""
import jax
import numpy as np
import pytest
import torch

from phylo_utils_tpu import io as jio
from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu import partition as jpart
from phylo_utils_tpu.optimize import standard_errors as jax_standard_errors
from phylo_utils_tpu.trees import random_tree
from phylo_utils_tpu_torch import io as tio
from phylo_utils_tpu_torch import models
from phylo_utils_tpu_torch.convert import flatten_params, params_to_numpy
from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
from phylo_utils_tpu_torch.optimize import fit, standard_errors
from phylo_utils_tpu_torch.partition import (
    Partition,
    PartitionedEngine,
    codon_position_partitions,
    partitions_from_file,
    simulate_partitions,
)
from phylo_utils_tpu_torch.simulate import simulate_alignment
from phylo_utils_tpu_torch.trees import Tree

from jax_reference import jitted_hessian
from torch_threads import one_thread  # noqa: F401

REL = 1e-10


def _port_tree(jtree):
    return Tree(jtree.names, jtree.parent, jtree.lengths, jtree.children,
                jtree.n_leaves)


def _aln(tree, sites, seed=0, chars="ACGT"):
    rng = np.random.default_rng(seed)
    return {n: "".join(rng.choice(list(chars), size=sites))
            for n in tree.leaf_names}


def _by_path(tree) -> dict:
    names, leaves = flatten_params(params_to_numpy(tree))
    return dict(zip(names, leaves))


def _jax_tree(tree) -> dict:
    return jax.tree.map(np.asarray, tree)


def _numpy_params(params) -> dict:
    """The port's parameter dict as nested numpy, for the JAX engines."""
    return params_to_numpy(params)


@pytest.fixture(scope="module")
def setup():
    jtree = random_tree(6, seed=1)
    specs = [("gene1", 90, 2, "HKY85", 4), ("gene2", 60, 3, "GTR", 1),
             ("gene3", 120, 4, "K80", 2)]
    alns = {name: _aln(jtree, n, seed) for name, n, seed, _, _ in specs}
    jparts = [jpart.Partition(name, alns[name], getattr(jmodels, m), ncat=k)
              for name, _, _, m, k in specs]
    parts = [Partition(name, alns[name], getattr(models, m), ncat=k)
             for name, _, _, m, k in specs]
    return jtree, _port_tree(jtree), jparts, parts


@pytest.fixture(scope="module")
def jax_linked(setup):
    """The JAX engine over ``setup``'s loci, rates linked (its default),
    built once so its compiled calls serve every test that reads it."""
    jtree, _, jparts, _ = setup
    return jpart.PartitionedEngine(jtree, jparts)


def test_partitioned_equals_sum_of_engines(setup):
    jtree, tree, jparts, parts = setup
    pe = PartitionedEngine(tree, parts, link_rates=False, device="cpu")
    total = pe.loglikelihood()
    singles = sum(
        LikelihoodEngine(tree, p.alignment, p.model, ncat=p.ncat,
                         device="cpu").loglikelihood()
        for p in parts
    )
    assert total == pytest.approx(singles, abs=1e-9)
    per = pe.partition_loglikelihoods()
    assert set(per) == {"gene1", "gene2", "gene3"}
    assert sum(per.values()) == pytest.approx(total, abs=1e-9)
    jpe = jpart.PartitionedEngine(jtree, jparts, link_rates=False)
    assert total == pytest.approx(jpe.loglikelihood(), rel=REL)
    for name, ll in jpe.partition_loglikelihoods().items():
        assert per[name] == pytest.approx(ll, rel=REL)


def test_partition_rates_normalized(setup, jax_linked):
    jtree, tree, jparts, parts = setup
    pe = PartitionedEngine(tree, parts, device="cpu")  # link_rates=True
    base = pe.loglikelihood()
    # scaling all partition rates by a constant changes nothing (mean-1)
    scaled = pe.loglikelihood({"partition_rates": np.array([3.0, 3.0, 3.0])})
    assert scaled == pytest.approx(base, abs=1e-9)
    uneq = {"partition_rates": np.array([0.3, 1.0, 2.0])}
    assert abs(pe.loglikelihood(uneq) - base) > 1e-6
    jpe = jax_linked
    assert pe.loglikelihood(uneq) == pytest.approx(jpe.loglikelihood(uneq),
                                                   rel=REL)
    got = _by_path(pe.gradient(uneq))
    want = _by_path(_jax_tree(jpe.gradient(jpe._full_params(uneq))))
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-8, atol=1e-10,
                                   err_msg=str(path))


def test_partitioned_fit_improves_and_fits_per_partition_params(setup,
                                                                jax_linked):
    jtree, tree, jparts, parts = setup
    pe = PartitionedEngine(tree, parts, device="cpu")
    ll0 = pe.loglikelihood()
    res = fit(pe, max_steps=60, patience=20)
    assert res.loglik > ll0 + 1.0
    fitted = res.params
    k1 = float(fitted["partitions"]["gene1"]["model"]["kappa"])
    k3 = float(fitted["partitions"]["gene3"]["model"]["kappa"])
    assert k1 != pytest.approx(k3, abs=1e-3)
    r = fitted["partition_rates"].numpy()
    assert r.max() / r.min() > 1.0 + 1e-4
    # the JAX engine's logL at the fitted parameters
    assert res.loglik == pytest.approx(
        jax_linked.loglikelihood(_numpy_params(fitted)), rel=1e-8)


def test_mixed_alphabet_partitions(setup):
    jtree, tree, _, _ = setup
    dna, prot = _aln(tree, 60, seed=5), _aln(
        tree, 40, seed=6, chars="ACDEFGHIKLMNPQRSTVWY")
    pe = PartitionedEngine(tree, [
        Partition("dna", dna, models.GTR, ncat=2),
        Partition("prot", prot, models.LG)], device="cpu")
    jpe = jpart.PartitionedEngine(jtree, [
        jpart.Partition("dna", dna, jmodels.GTR, ncat=2),
        jpart.Partition("prot", prot, jmodels.LG)])
    assert np.isfinite(pe.loglikelihood())
    assert pe.loglikelihood() == pytest.approx(jpe.loglikelihood(), rel=REL)
    g = pe.gradient()
    assert np.isfinite(g["branch_lengths"].numpy()).all()
    want = _by_path(_jax_tree(jpe.gradient()))
    got = _by_path(g)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-8, atol=1e-10,
                                   err_msg=str(path))


def test_duplicate_partition_names_rejected(setup):
    _, tree, _, parts = setup
    with pytest.raises(ValueError, match="unique"):
        PartitionedEngine(tree, [parts[0], parts[0]], device="cpu")
    with pytest.raises(ValueError, match="unknown partition"):
        PartitionedEngine(tree, parts, device="cpu").loglikelihood(
            {"partitions": {"gene9": {"alpha": 1.0}}})


def test_parse_partition_file_raxml_and_nexus():
    text = ("# comment\n"
            "DNA, gene1 = 1-500\n"
            "GTR+G4, gene2 = 501-900\\3, 1000-1100\n"
            "LG, prot = 1-100\n")
    specs = tio.parse_partition_file(text)
    assert specs == jio.parse_partition_file(text)
    assert [s["name"] for s in specs] == ["gene1", "gene2", "prot"]
    assert specs[0]["model"] == "DNA"
    assert specs[1]["ranges"] == [(501, 900, 3), (1000, 1100, 1)]
    nexus = ("#NEXUS\nbegin sets;\n  charset g1 = 1-30;\n"
             "  charset g2 = 31-60; [a comment]\nend;\n")
    nex = tio.parse_partition_file(nexus)
    assert nex == jio.parse_partition_file(nexus)
    assert [s["name"] for s in nex] == ["g1", "g2"]
    assert all(s["model"] is None for s in nex)
    for bad, match in (("DNA, gene1 1-500", "missing '='"),
                       ("DNA, g = 0-10", "1-based"),
                       ("DNA, g = 1-10\\0", "bad stride"),
                       ("#NEXUS\nbegin sets;\nend;\n", "no charset")):
        with pytest.raises(ValueError, match=match):
            tio.parse_partition_file(bad)
        with pytest.raises(ValueError, match=match):
            jio.parse_partition_file(bad)


def test_partitions_from_file_logl_matches_manual_split(setup):
    """File-driven partitions == manually sliced sub-alignments == JAX."""
    jtree, tree, _, _ = setup
    aln = _aln(tree, 60, seed=9)
    text = "HKY85+G2, left = 1-30\nGTR, right = 31-60"
    parts, init = partitions_from_file(text, aln)
    assert init == {}
    ll = PartitionedEngine(tree, parts, link_rates=False,
                           device="cpu").loglikelihood()
    manual = [
        Partition("left", {n: s[:30] for n, s in aln.items()},
                  models.HKY85, ncat=2),
        Partition("right", {n: s[30:] for n, s in aln.items()}, models.GTR),
    ]
    assert abs(ll - PartitionedEngine(tree, manual, link_rates=False,
                                      device="cpu").loglikelihood()) < 1e-9
    jparts, _ = jpart.partitions_from_file(text, aln)
    want = jpart.PartitionedEngine(jtree, jparts,
                                   link_rates=False).loglikelihood()
    assert ll == pytest.approx(want, rel=REL)


def test_partitions_from_file_stride_and_plus_f(setup):
    """Codon-position strides pick every 3rd column; '+F' entries return
    observed-frequency init params equal to JAX's; out-of-range sites are
    rejected."""
    _, tree, _, _ = setup
    aln = _aln(tree, 30, seed=11)
    text = "DNA+F, p12 = 1-30\\3, 2-30\\3\nDNA, p3 = 3-30\\3"
    parts, init = partitions_from_file(text, aln)
    jparts, jinit = jpart.partitions_from_file(text, aln)
    assert len(parts[0].alignment[tree.leaf_names[0]]) == 20
    assert len(parts[1].alignment[tree.leaf_names[0]]) == 10
    for p, jp in zip(parts, jparts):
        assert p.alignment == jp.alignment and p.name == jp.name
        assert (p.model.name, p.ncat, p.invariant_sites, p.rate_model) == (
            jp.model.name, jp.ncat, jp.invariant_sites, jp.rate_model)
    f = np.asarray(init["partitions"]["p12"]["model"]["freqs"])
    assert f.shape == (4,) and abs(f.sum() - 1.0) < 1e-9
    np.testing.assert_allclose(
        f, np.asarray(jinit["partitions"]["p12"]["model"]["freqs"]),
        rtol=1e-12)
    with pytest.raises(ValueError, match="exceeds alignment length"):
        partitions_from_file("DNA, g = 1-31", aln)


def test_codon_position_partitions_match_jax(setup):
    _, tree, _, _ = setup
    aln = _aln(tree, 33, seed=12)
    for split in ("12_3", "1_2_3"):
        got = codon_position_partitions("cds", aln, models.HKY85,
                                        split=split, ncat=2)
        want = jpart.codon_position_partitions("cds", aln, jmodels.HKY85,
                                               split=split, ncat=2)
        assert [(p.name, p.alignment, p.ncat) for p in got] == [
            (p.name, p.alignment, p.ncat) for p in want]
    with pytest.raises(ValueError, match="in-frame"):
        codon_position_partitions("x", _aln(tree, 31), models.JC69)


def test_simulate_partitions_rates_and_models():
    """Partitioned simulation: taxa and lengths per partition, locus i drawn
    from ``seed + i``, and the partition-rate multiplier visibly changes
    the substitution density (the fast partition has more variable columns
    than the slow one)."""
    tree = "((a:0.05,b:0.05):0.02,(c:0.05,d:0.05):0.02);"
    rng = np.random.default_rng(1)

    def rand_aln(n):
        m = rng.integers(0, 4, size=(4, n))
        return {t: "".join("ACGT"[s] for s in m[i])
                for i, t in enumerate("abcd")}

    eng = PartitionedEngine(tree, [
        Partition("fast", rand_aln(150), models.JC69),
        Partition("slow", rand_aln(120), models.HKY85, ncat=4),
    ], device="cpu")
    params = {"partition_rates": [6.0, 0.2],
              "partitions": {"slow": {"alpha": 0.9}}}
    sim = simulate_partitions(5, eng, params)
    assert set(sim) == {"fast", "slow"}
    assert set(sim["fast"]) == set("abcd")
    assert {len(s) for s in sim["fast"].values()} == {150}
    assert {len(s) for s in sim["slow"].values()} == {120}

    def var_frac(aln):
        cols = list(zip(*aln.values()))
        return np.mean([len(set(c)) > 1 for c in cols])

    assert var_frac(sim["fast"]) > var_frac(sim["slow"]) + 0.1
    # locus 1 is the simulator's draw from seed + 1 at its scaled lengths
    r = eng._partition_rates(eng._full_params(params)).numpy()
    again = simulate_alignment(
        6, eng.tree.with_lengths(np.asarray(eng.tree.lengths) * r[1]),
        models.HKY85, 120, params={"alpha": 0.9}, ncat=4, device="cpu")
    assert again == sim["slow"]
    gen = torch.Generator().manual_seed(0)
    assert set(simulate_partitions(gen, eng)) == {"fast", "slow"}


def test_simulate_partitions_rejects_freerate():
    tree = "((a:0.1,b:0.1):0.1,(c:0.1,d:0.1):0.1);"
    aln = {t: "ACGTACGT" for t in "abcd"}
    eng = PartitionedEngine(tree, [
        Partition("x", aln, models.JC69, ncat=2, rate_model="free"),
        Partition("y", aln, models.JC69),
    ], device="cpu")
    with pytest.raises(ValueError, match="FreeRate"):
        simulate_partitions(0, eng)


def test_partitioned_standard_errors():
    """standard_errors through PartitionedEngine against the JAX package's
    at the same parameters, every entry: finite positive SEs for the
    identifiable shared branch lengths and a nested per-partition model
    parameter, and JAX's values along the directions where the information
    is flat for every data set. Tree-like data (simulated under the tree),
    so the MLE is interior.

    The information is flat along the partition rates' common scale (their
    site-weighted mean is 1), along the split of the root's two edges, and
    in the root's own length, which the likelihood never reads. JAX's
    Hessian is exact there and its pseudo-inverse drops those directions;
    the port's Hessian is central differences of the gradient (its P
    reverse rule has no second derivative), so ``fisher_covariance``
    inverts it on their orthogonal complement: the root edges read JAX's
    split SE, the partition rates JAX's SEs, and the root's own length nan
    as in JAX. JAX's Hessian is taken under one ``jax.jit``
    (``jax_reference.jitted_hessian``)."""
    newick = "((a:0.1,b:0.2):0.05,(c:0.3,d:0.15):0.07);"
    sim_eng = PartitionedEngine(newick, [
        Partition("g1", {t: "A" * 150 for t in "abcd"}, models.JC69),
        Partition("g2", {t: "A" * 150 for t in "abcd"}, models.K80),
    ], device="cpu")
    sim = simulate_partitions(
        7, sim_eng, {"partitions": {"g2": {"model": {"kappa": 4.0}}}})
    eng = PartitionedEngine(newick, [Partition("g1", sim["g1"], models.JC69),
                                     Partition("g2", sim["g2"], models.K80)],
                            device="cpu")
    res = fit(eng, max_steps=40)
    assert res.params["partitions"]["g1"]["model"] == {}
    se = standard_errors(eng, res.params)
    bl = se["branch_lengths"]
    assert bl.shape == tuple(res.params["branch_lengths"].shape)
    assert se["partition_rates"].shape == (2,)
    assert np.isfinite(bl[:6]).all() and (bl[:6] > 0).all()
    assert np.isnan(bl[6])
    kappa_se = float(se["partitions"]["g2"]["model"]["kappa"])
    assert np.isfinite(kappa_se) and kappa_se > 0
    jeng = jpart.PartitionedEngine(newick, [
        jpart.Partition("g1", sim["g1"], jmodels.JC69),
        jpart.Partition("g2", sim["g2"], jmodels.K80)])
    with jitted_hessian():
        want = _by_path(_jax_tree(jax_standard_errors(
            jeng, jeng._full_params(_numpy_params(res.params)))))
    got = _by_path(se)
    assert set(got) == {p for p, w in want.items() if np.size(w)}
    for path, g in got.items():
        w = np.asarray(want[path])
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w),
                                      err_msg=str(path))
        np.testing.assert_allclose(g[~np.isnan(w)], w[~np.isnan(w)],
                                   rtol=1e-4, err_msg=str(path))