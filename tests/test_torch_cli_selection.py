"""Port parity, the CLI's model-selection surfaces: ``site-test``
(codeml's M1a-vs-M2a LRT with the NEB and BEB site scans), ``compare``
(AIC/AICc/BIC ranking) and ``--recode`` in ``python -m
phylo_utils_tpu_torch.cli`` against the JAX package's CLI on the same
files, with ``--device cpu`` and one intra-op thread (their fits are
thousands of tiny ops, which several test workers' thread pools, each as
wide as the machine, slow several times over). Kept apart from
``tests/test_torch_cli.py`` so that the test workers run them side by
side.

Tolerances: ``--recode`` 1e-10 relative (the same computation);
``compare`` and ``site-test`` fit with another optimizer in each package
(and the JAX ``compare``'s engines run at its default float32), so they
are held to JAX's keys, ranking and shapes, ``compare``'s logL and
criteria to 1e-6 relative, ``site-test``'s 15-step logLs to 1e-4
relative, and the port's printed numbers to its own library's at the
printed parameters, bit for bit.
"""
import contextlib
import io
import json

import jax
import pytest

from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu.cli import main as jax_main
from phylo_utils_tpu.io import parse_newick as j_parse_newick
from phylo_utils_tpu.io import write_fasta
from phylo_utils_tpu.simulate import simulate_alignment
from phylo_utils_tpu_torch import cli
from phylo_utils_tpu_torch.io import parse_newick

from torch_threads import one_thread  # noqa: F401

TREE = "((a:0.1,b:0.2):0.05,(c:0.3,d:0.15):0.07);"


def _run(main, args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(args) == 0
    return json.loads(out.getvalue())


def _both(args):
    """(port JSON, JAX JSON) of one command line."""
    return _run(cli.main, args + ["--device", "cpu"]), _run(jax_main, args)


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-300)


@pytest.fixture
def small_inputs(tmp_path):
    fasta = tmp_path / "aln.fa"
    fasta.write_text(
        ">a\nACGTACGTGG\n>b\nACGTTGCAGG\n>c\nAGGTACGAGT\n>d\nACGAACGTAT\n"
    )
    return TREE, str(fasta)


@pytest.fixture(scope="module")
def simulated(tmp_path_factory):
    """300 K80+G4 sites simulated by the JAX package on an unrooted 6-taxon
    tree."""
    tree = "(a:0.1,b:0.2,(c:0.15,(d:0.1,(e:0.2,f:0.05):0.1):0.12):0.08);"
    aln = simulate_alignment(jax.random.key(5), j_parse_newick(tree),
                             jmodels.K80, 300,
                             params={"kappa": 3.0, "alpha": 0.8}, ncat=4)
    path = tmp_path_factory.mktemp("sim") / "sim.fa"
    write_fasta(aln, path=str(path))
    return tree, str(path)


@pytest.mark.parametrize("scheme,model", [("ry", "MK2"),
                                          ("ry", "MK2+G4")])
def test_recode_matches_jax_cli(small_inputs, scheme, model):
    """``loglik --recode ry`` recodes the DNA into purine/pyrimidine states
    ('0'/'1', '?' for the rest) before the engine, as the JAX CLI does
    (1e-10 relative); an unknown scheme exits naming the flag."""
    tree, fasta = small_inputs
    port, want = _both(["loglik", "--tree", tree, "--alignment", fasta,
                        "--model", model, "--recode", scheme, "--sitewise"])
    assert _rel(port["loglik"], want["loglik"]) <= 1e-10
    assert len(port["sitewise"]) == len(want["sitewise"]) == 10
    for got, ref in zip(port["sitewise"], want["sitewise"]):
        assert _rel(got, ref) <= 1e-10
    with pytest.raises(SystemExit, match="--recode"):
        cli.main(["loglik", "--tree", tree, "--alignment", fasta, "--model",
                  "MK2", "--recode", "xy6", "--device", "cpu"])


def test_compare_matches_jax_cli(simulated):
    """``compare`` fits each candidate and ranks them: the same ranking and
    criterion as the JAX CLI, each logL and criterion within 1e-6 relative
    (another optimizer in each package, and the JAX package's engines at
    its default float32, the port's at float64)."""
    tree, fasta = simulated
    port, want = _both(["compare", "--tree", tree, "--alignment", fasta,
                        "--models", "JC69,K80", "--criterion", "aic",
                        "--max-steps", "60"])
    assert set(port) == set(want) == {"ranked", "best", "criterion"}
    assert port["best"] == want["best"] and port["criterion"] == "aic"
    assert [r["model"] for r in port["ranked"]] == \
        [r["model"] for r in want["ranked"]]
    for got, ref in zip(port["ranked"], want["ranked"]):
        assert set(got) == set(ref) and got["k"] == ref["k"]
        for key in ("loglik", "aic", "aicc", "bic"):
            assert _rel(got[key], ref[key]) <= 1e-6, (got["model"], key)


@pytest.fixture(scope="module")
def site_test_inputs(tmp_path_factory):
    """``tests/test_cli_utils.py``'s site-test input: 40 codons simulated by
    the JAX package under GY94 (omega 0.5, kappa 2) on a 5-taxon tree."""
    from phylo_utils_tpu.io import write_newick as j_write_newick
    from phylo_utils_tpu.trees import random_tree

    tree = random_tree(5, seed=7, mean_brlen=0.2)
    aln = simulate_alignment(jax.random.key(3), tree, jmodels.GY94, 40,
                             params={"omega": 0.5, "kappa": 2.0})
    path = tmp_path_factory.mktemp("site") / "codon.fa"
    write_fasta(aln, path=str(path))
    return j_write_newick(tree), str(path)


def test_site_test_matches_jax_cli(site_test_inputs):
    """``site-test --test m1a-m2a --sites --beb`` at 15 steps (a smoke
    length, as ``tests/test_cli_utils.py``'s): JAX's keys and shapes, each
    logL within 1e-4 relative of the JAX CLI's after 15 steps of another
    optimizer, a p-value in [0, 1]; and the port's numbers are its
    library's: logL of ``M2aEngine`` at the printed parameters, NEB and BEB
    scans there, to the last bit. ``--beb`` needs m1a-m2a."""
    from phylo_utils_tpu_torch.convert import params_from_jax
    from phylo_utils_tpu_torch.io import encode_codon_alignment, read_fasta
    from phylo_utils_tpu_torch.mixtures import (
        M2aEngine,
        beb_site_posteriors,
        omega_posteriors,
    )

    tree, fasta = site_test_inputs
    args = ["site-test", "--tree", tree, "--alignment", fasta, "--test",
            "m1a-m2a", "--max-steps", "15", "--sites", "--beb"]
    port, want = _both(args)
    assert set(port) == set(want)
    assert set(port["lrt"]) == set(want["lrt"])
    assert port["test"] == want["test"] == "m1a-m2a"
    assert set(port["alt_params"]) == set(want["alt_params"])
    assert set(port["alt_params"]["shared"]) == set(
        want["alt_params"]["shared"])
    for key in ("site_mean_omega", "site_positive_posterior",
                "beb_positive_posterior", "beb_mean_omega"):
        assert len(port[key]) == len(want[key]) == 40, key
    for key in ("loglik_null", "loglik_alt"):
        assert _rel(port[key], want[key]) <= 1e-4, key
    assert 0.0 <= port["lrt"]["pvalue"] <= 1.0
    assert port["loglik_alt"] >= port["loglik_null"] - 0.5
    m2a = M2aEngine(parse_newick(tree),
                    encode_codon_alignment(read_fasta(fasta)), device="cpu")
    params = params_from_jax(port["alt_params"])
    assert m2a.loglikelihood(params) == port["loglik_alt"]
    mean_w, gam = omega_posteriors(m2a, params)
    assert mean_w.tolist() == port["site_mean_omega"]
    assert gam[:, -1].tolist() == port["site_positive_posterior"]
    p_pos, beb_w = beb_site_posteriors(m2a, params)
    assert p_pos.tolist() == port["beb_positive_posterior"]
    assert beb_w.tolist() == port["beb_mean_omega"]
    with pytest.raises(SystemExit, match="--beb requires"):
        cli.main(["site-test", "--tree", tree, "--alignment", fasta,
                  "--test", "m7-m8", "--beb", "--device", "cpu"])
