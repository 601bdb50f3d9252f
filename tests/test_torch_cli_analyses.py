"""Port parity, the CLI's A18 analyses: ``ancestral`` (with ``--joint``,
``--full`` and ``--out-fasta``), ``date`` (relative with a cross-validated
lambda, and calibrated), ``clock-test`` and ``branch-site-test`` in
``python -m phylo_utils_tpu_torch.cli`` against the JAX package's CLI on the
same files, with ``--device cpu`` and one intra-op thread.

Tolerances: ``ancestral`` in float64 (``--dtype float64``, GTR+G2 at
unequal rates and frequencies) 1e-9 absolute on the posteriors, the MAP
states equal but at exact ties (there the port's is one of JAX's maxima),
the joint states and the sequences equal, the joint log_prob 1e-10
relative; ``date`` (the same Adam steps from the same start) 1e-6 relative
on the ages and the chronogram's lengths, 1e-8 on the objective and the
cross-validation scores. ``clock-test`` fits with another optimizer in
each package, so its logLs are held to JAX's at 1e-4 relative (both fits
converge on these clock-like data), its df and keys exactly, and the port's
printed numbers to its own library's call on the same inputs, bit for bit;
``branch-site-test`` by its keys and its library's numbers (the JAX CLI's
codon fits are ~20 s of compiles; ``tests/test_torch_branch_models.py``
holds the LRT to JAX's at the fits).
"""
import contextlib
import io
import json

import numpy as np
import pytest

from phylo_utils_tpu import branch_models as jbm
from phylo_utils_tpu.cli import main as jax_main
from phylo_utils_tpu.io import parse_newick as j_parse_newick
from phylo_utils_tpu_torch import cli, models
from phylo_utils_tpu_torch.branch_models import branch_site_test, mark_clade
from phylo_utils_tpu_torch.clock import clock_test
from phylo_utils_tpu_torch.io import (
    encode_codon_alignment,
    parse_newick,
    read_alignment,
    read_fasta,
    write_fasta,
    write_newick,
)
from phylo_utils_tpu_torch.models.codon import empirical_codon_frequencies
from phylo_utils_tpu_torch.simulate import simulate_alignment

from torch_threads import one_thread  # noqa: F401

ULTRA = ("(((a:0.1,b:0.1):0.1,(c:0.1,d:0.1):0.1):0.05,"
         "(e:0.2,f:0.2):0.05);")


def _run(main, args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(args) == 0
    return json.loads(out.getvalue())


def _both(args):
    """(port JSON, JAX JSON) of one command line."""
    return _run(cli.main, args + ["--device", "cpu"]), _run(jax_main, args)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """120 HKY85+G4 sites (kappa 3, alpha 0.6) and 40 GY94 codons simulated
    by the port on the ultrametric 6-taxon tree."""
    d = tmp_path_factory.mktemp("analyses")
    tree = parse_newick(ULTRA)
    dna = simulate_alignment(3, tree, models.HKY85, 120,
                             params={"kappa": 3.0, "alpha": 0.6}, ncat=4,
                             device="cpu")
    codons = simulate_alignment(4, tree, models.GY94, 40,
                                params={"kappa": 2.0, "omega": 0.5},
                                device="cpu")
    paths = {"tree": str(d / "tree.nwk"), "dna": str(d / "dna.fa"),
             "codons": str(d / "codons.fa"), "dir": d}
    with open(paths["tree"], "w") as f:
        f.write(ULTRA)
    write_fasta(dna, path=paths["dna"])
    write_fasta(codons, path=paths["codons"])
    return paths


def test_ancestral_matches_jax_cli(files):
    base = ["ancestral", "--tree", files["tree"], "--alignment",
            files["dna"], "--model", "GTR", "--ncat", "2", "--params",
            json.dumps({"model": {"rates": [1.2, 3.1, 0.7, 0.9, 4.2, 1.0],
                                  "freqs": [0.3, 0.2, 0.22, 0.28]},
                        "alpha": 0.6}),
            "--dtype", "float64", "--joint", "--full"]
    got = _run(cli.main, base + ["--out-fasta",
                                 str(files["dir"] / "port.fa"), "--device",
                                 "cpu"])
    want = _run(jax_main, base + ["--out-fasta",
                                  str(files["dir"] / "jax.fa")])
    assert set(got) == set(want)
    for k in ("n_internal_nodes", "n_sites"):
        assert got[k] == want[k], k
    for k, tol in (("posteriors", 1e-9), ("max_posterior", 1e-9),
                   ("site_rate_posteriors", 1e-9)):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)
    np.testing.assert_allclose(got["joint_log_prob"], want["joint_log_prob"],
                               rtol=1e-10)
    # the MAP states equal JAX's but at exact ties (which the last bit
    # breaks either way): there the port's state is one of JAX's maxima
    post = np.asarray(want["posteriors"])
    got_map = np.asarray(got["map_states"])
    tie = np.sort(post, axis=2)[..., -2] > post.max(axis=2) - 1e-12
    np.testing.assert_array_equal(got_map[~tie],
                                  np.asarray(want["map_states"])[~tie])
    picked = np.take_along_axis(post, got_map[..., None], axis=2)[..., 0]
    np.testing.assert_allclose(picked, post.max(axis=2), rtol=0, atol=1e-12)
    assert got["joint_states"] == want["joint_states"]
    chars = np.array(list("ACGT"))
    for key, states in (("map_sequences", got_map),
                        ("joint_sequences", np.asarray(got["joint_states"]))):
        assert list(got[key]) == list(want[key])
        assert list(got[key].values()) == ["".join(chars[row])
                                           for row in states]
    for suffix, key in (("", "map_sequences"), (".joint", "joint_sequences")):
        assert read_fasta(str(files["dir"] / "port.fa") + suffix) == got[key]
        assert (read_fasta(str(files["dir"] / "jax.fa") + suffix)
                == want[key])


def _lengths(newick):
    return np.asarray(parse_newick(newick).lengths)


@pytest.mark.parametrize("mode", ["cv", "calibrated"])
def test_date_matches_jax_cli(files, mode):
    # a phylogram with per-edge rates around 1
    tree = parse_newick(ULTRA)
    rates = np.exp(np.random.default_rng(5).normal(0, 0.3, tree.n_nodes))
    gram = files["dir"] / "gram.nwk"
    gram.write_text(write_newick(tree.with_lengths(tree.lengths * rates)))
    args = ["date", "--tree", str(gram), "--sites", "1500", "--steps",
            "200"]
    args += (["--cv-lambda", "0.1,10"] if mode == "cv"
             else ["--calibrate", "a,b=12", "--calibrate", "a,c=20:40"])
    got, want = _both(args)
    assert set(got) == set(want)
    assert got["lambda"] == want["lambda"]
    assert set(got["ages"]) == set(want["ages"])
    for k, v in want["ages"].items():
        assert got["ages"][k] == pytest.approx(v, rel=1e-6, abs=1e-12), k
    np.testing.assert_allclose(_lengths(got["chronogram"]),
                               _lengths(want["chronogram"]), rtol=1e-6,
                               atol=1e-9)
    assert got["objective"] == pytest.approx(want["objective"], rel=1e-8)
    assert got["max_calibration_violation"] == pytest.approx(
        want["max_calibration_violation"], rel=1e-6, abs=1e-9)
    if mode == "cv":
        for k, v in want["cv_scores"].items():
            assert got["cv_scores"][k] == pytest.approx(v, rel=1e-8)


def test_clock_test_matches_jax_cli(files):
    args = ["clock-test", "--tree", files["tree"], "--alignment",
            files["dna"], "--model", "HKY85", "--max-steps", "60"]
    # both CLIs run their engines' default f64
    got = _run(cli.main, args + ["--device", "cpu"])
    want = _run(jax_main, args)
    assert set(got) == set(want)
    assert got["df"] == want["df"] == 4
    for k in ("loglik_clock", "loglik_unconstrained"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    # the port's printed numbers are its library's
    lib = clock_test(parse_newick(ULTRA), read_alignment(files["dna"]),
                     models.HKY85, max_steps=60,
                     engine_kwargs={"device": "cpu"})
    assert got["loglik_clock"] == lib["null"].loglik
    assert got["loglik_unconstrained"] == lib["alt"].loglik
    assert got["lrt"] == lib["lrt"]


def test_branch_site_test_prints_the_library_result(files):
    """The port's printed numbers are its library's branch_site_test on the
    same inputs, and its keys the JAX CLI's (its ``alt_params`` the JAX
    engine's parameters). The JAX CLI's own fits are not run here (~20 s
    of compiles); ``tests/test_torch_branch_models.py`` holds the LRT to
    JAX's at the fits."""
    args = ["branch-site-test", "--tree", files["tree"], "--alignment",
            files["codons"], "--foreground", "e,f", "--clade",
            "--max-steps", "8", "--dtype", "float64", "--device", "cpu"]
    got = _run(cli.main, args)
    assert set(got) == {"loglik_null", "loglik_alt", "lrt", "alt_params"}
    jtree = j_parse_newick(ULTRA)
    aln = read_alignment(files["codons"])
    je = jbm.BranchSiteAEngine(jtree, aln, jbm.mark_clade(jtree, ["e", "f"]))
    assert set(got["alt_params"]) == set(je.default_params())
    assert got["lrt"]["df"] == 1
    tree = parse_newick(ULTRA)
    lib = branch_site_test(
        tree, encode_codon_alignment(aln), mark_clade(tree, ["e", "f"]),
        params0={"shared": {"freqs": empirical_codon_frequencies(
            aln, "f3x4").tolist()}},
        engine_kwargs={"dtype": "float64", "device": "cpu"}, max_steps=8)
    assert got["loglik_null"] == lib["null"].loglik
    assert got["loglik_alt"] == lib["alt"].loglik
    assert got["lrt"] == lib["lrt"]
