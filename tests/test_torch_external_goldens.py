"""Port parity, external anchors: ``tests/test_external_goldens.py``'s
published constants and closed forms held against the port, on the CPU
(``device="cpu"``, float64).

- Yang (1994): the mean-discretized 4-category gamma rates for alpha=0.5,
  (0.0334, 0.2519, 0.8203, 2.8944), as printed; alpha=1, 2 categories:
  exactly 1 -+ ln 2.
- Jukes & Cantor (1969) distance d = -3/4 ln(1 - 4p/3); Kimura (1980)
  distance and kappa from the transition and transversion proportions;
  the two-sequence JC69 logL in closed form.
- Yang, "Computational Molecular Evolution" (2006), section 1.4: human vs
  orangutan 12s rRNA, 948 sites (84 transitions, 6 transversions), JC69
  lnL = -1710.58 at d = 0.1015 and K80 lnL = -1637.90 at d = 0.1046,
  kappa ~ 30.8.

Tolerances are the JAX tests' own, each stated at its assertion.
"""
import math

import numpy as np
import pytest
import torch

from phylo_utils_tpu_torch import models
from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
from phylo_utils_tpu_torch.ops.gamma import discrete_gamma
from phylo_utils_tpu_torch.optimize import fit, ml_distance_matrix

from torch_threads import one_thread  # noqa: F401

CPU = dict(device="cpu")
YANG94_ALPHA05_K4 = (0.0334, 0.2519, 0.8203, 2.8944)
YANG_CME_N, YANG_CME_TS, YANG_CME_TV = 948, 84, 6
YANG_CME_JC69_LNL, YANG_CME_JC69_D = -1710.58, 0.1015
YANG_CME_K80_LNL, YANG_CME_K80_D = -1637.90, 0.1046


def test_discrete_gamma_matches_yang94_published_rates():
    rates = discrete_gamma(torch.tensor(0.5, dtype=torch.float64), 4)
    np.testing.assert_allclose(rates.numpy(), YANG94_ALPHA05_K4, atol=5e-5)


def test_discrete_gamma_exponential_closed_form():
    """alpha=1 is Exp(1): the 2-category means are exactly 1 -+ ln 2."""
    rates = discrete_gamma(torch.tensor(1.0, dtype=torch.float64), 2)
    np.testing.assert_allclose(
        rates.numpy(), [1.0 - math.log(2.0), 1.0 + math.log(2.0)], atol=1e-9)


def _two_seq_alignment(n, diffs):
    """Two sequences of length n differing at the first sites by the given
    kinds ('ts' A<->G, 'tv' A<->C)."""
    a, b = ["A"] * n, ["A"] * n
    i = 0
    for kind, count in diffs:
        for _ in range(count):
            b[i] = "G" if kind == "ts" else "C"
            i += 1
    return {"x": "".join(a), "y": "".join(b)}


def test_jc69_distance_formula():
    n, nd = 500, 80
    aln = _two_seq_alignment(n, [("ts", 50), ("tv", 30)])
    d_formula = -0.75 * math.log1p(-4.0 * (nd / n) / 3.0)
    d_hat = ml_distance_matrix(aln, models.JC69, **CPU)[0, 1]
    assert d_hat == pytest.approx(d_formula, rel=1e-4)


def test_k80_ml_fit_matches_kimura1980_closed_form():
    """The joint fit of (branch lengths, kappa) on a two-taxon K80 engine
    lands on Kimura's closed-form MLEs."""
    n, n_ts, n_tv = 600, 90, 24
    aln = _two_seq_alignment(n, [("ts", n_ts), ("tv", n_tv)])
    p, q = n_ts / n, n_tv / n
    a = -math.log(1.0 - 2.0 * p - q)
    b = -math.log(1.0 - 2.0 * q)
    engine = LikelihoodEngine("(x:0.05,y:0.05);", aln, models.K80,
                              compress=True, **CPU)
    res = fit(engine, max_steps=300, tol=1e-12)
    d_hat = float(res.params["branch_lengths"].sum())
    assert d_hat == pytest.approx(0.5 * a + 0.25 * b, rel=2e-3)
    assert float(res.params["model"]["kappa"]) == pytest.approx(
        (2.0 * a - b) / b, rel=2e-2)


def _yang_cme_alignment():
    return _two_seq_alignment(YANG_CME_N, [("ts", YANG_CME_TS),
                                           ("tv", YANG_CME_TV)])


def test_yang_cme_jc69_published_absolute_loglik():
    engine = LikelihoodEngine("(x:0.05,y:0.05);", _yang_cme_alignment(),
                              models.JC69, **CPU)
    d = YANG_CME_JC69_D
    ll = engine.loglikelihood({"branch_lengths": [d / 2, d / 2, 0.0]})
    assert ll == pytest.approx(YANG_CME_JC69_LNL, abs=0.02)


def test_yang_cme_k80_published_absolute_loglik_and_mles():
    engine = LikelihoodEngine("(x:0.05,y:0.05);", _yang_cme_alignment(),
                              models.K80, **CPU)
    res = fit(engine, max_steps=400, tol=1e-12)
    d_hat = float(res.params["branch_lengths"].sum())
    assert d_hat == pytest.approx(YANG_CME_K80_D, abs=2e-4)
    assert float(res.params["model"]["kappa"]) == pytest.approx(30.84,
                                                                abs=0.05)
    assert res.loglik == pytest.approx(YANG_CME_K80_LNL, abs=0.02)


def test_jc69_two_sequence_loglik_closed_form():
    n, nd = 300, 60
    aln = _two_seq_alignment(n, [("ts", 40), ("tv", 20)])
    d = 0.31
    e = math.exp(-4.0 * d / 3.0)
    gold = ((n - nd) * math.log(0.25 * (0.25 + 0.75 * e))
            + nd * math.log(0.25 * (0.25 - 0.25 * e)))
    engine = LikelihoodEngine("(x:0.155,y:0.155);", aln, models.JC69, **CPU)
    ll = engine.loglikelihood({"branch_lengths": [d / 2, d / 2, 0.0]})
    assert ll == pytest.approx(gold, abs=1e-6)


# --- Codon models against the independent f64 oracle (``oracle.gy94``,
# ``oracle.mg94``: the JAX package's tests/test_codon.py anchors) ---------

def test_gy94_q_and_logl_match_oracle():
    """GY94's rate matrix (1e-12) and logL on a 4-taxon alignment with an
    ambiguous codon (1e-8) equal the oracle's independent construction."""
    import oracle.core as oracle
    from phylo_utils_tpu_torch.io import encode_codon_alignment, parse_newick

    eig = models.GY94.eigen({"kappa": 3.0, "omega": 0.4})
    np.testing.assert_allclose(eig.q.numpy(), oracle.gy94(3.0, 0.4).q,
                               atol=1e-12)
    tree = parse_newick("((a:0.1,b:0.2):0.05,(c:0.3,d:0.15):0.07);")
    aln = {"a": "ATGGCACGTAAG", "b": "ATGGCTCGTAAA",
           "c": "ATGGGACGAAAG", "d": "ATGGCACGTANG"}
    ca = encode_codon_alignment(aln)
    engine = LikelihoodEngine(tree, ca, models.GY94, **CPU)
    ll = engine.loglikelihood({"model": {"kappa": 2.5, "omega": 0.3}})
    gold = oracle.loglikelihood(
        tree, aln, oracle.gy94(2.5, 0.3),
        pattern_weights=np.asarray(ca.weights),
        leaf_partials=np.asarray(ca.partials, np.float64))
    assert ll == pytest.approx(gold, abs=1e-8)


def test_mg94_q_and_logl_match_oracle():
    """MG94's rate matrix and frequencies (1e-12), and its logL on 40
    codons simulated by the port (1e-7), equal the oracle's."""
    import oracle.core as oracle
    from phylo_utils_tpu_torch.io import encode_codon_alignment
    from phylo_utils_tpu_torch.models.base import build_rate_matrix
    from phylo_utils_tpu_torch.simulate import simulate_alignment
    from phylo_utils_tpu_torch.trees import random_tree

    nf = np.array([[0.3, 0.2, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25],
                   [0.15, 0.35, 0.2, 0.3]])
    sym, freqs = models.MG94.build_parts(
        {"kappa": 3.0, "omega": 0.4, "nuc_freqs": nf})
    om = oracle.mg94(3.0, 0.4, nf)
    np.testing.assert_allclose(build_rate_matrix(sym, freqs).numpy(), om.q,
                               atol=1e-12)
    np.testing.assert_allclose(freqs.numpy(), om.freqs, atol=1e-12)
    tree = random_tree(5, seed=6, mean_brlen=0.2)
    params = {"omega": 0.5, "kappa": 3.0, "nuc_freqs": nf}
    ca = encode_codon_alignment(simulate_alignment(
        7, tree, models.MG94, 40, params=params, **CPU))
    eng = LikelihoodEngine(tree, ca, models.MG94, **CPU)
    gold = oracle.loglikelihood(
        tree, {}, oracle.mg94(3.0, 0.5, nf),
        pattern_weights=np.asarray(ca.weights),
        leaf_partials=np.asarray(ca.partials, np.float64))
    assert eng.loglikelihood({"model": params}) == pytest.approx(gold,
                                                                 abs=1e-7)
