"""Port parity, CLI: ``python -m phylo_utils_tpu_torch.cli`` against the JAX
package's CLI on the same files (``tests/test_cli_utils.py``'s inputs, and
a 6-taxon alignment simulated for the fit and the tree build), with
``--device cpu``.

Tolerances: 1e-10 relative in float64 where both CLIs compute the same
thing (loglik, sitewise, bootstrap replicates, distances, NJ branch
lengths; NJ topologies identical). ``fit`` runs another optimizer in each
package (torch L-BFGS, optax L-BFGS), so the fits are held to their final
logL (1e-6 relative) and estimates (1e-3 relative), and the standard errors
at each package's own optimum to 1e-2 relative.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu.cli import main as jax_main
from phylo_utils_tpu.io import parse_newick as j_parse_newick
from phylo_utils_tpu.io import write_fasta
from phylo_utils_tpu.simulate import simulate_alignment
from phylo_utils_tpu_torch import cli
from phylo_utils_tpu_torch.io import parse_newick, read_alignment, write_newick
from phylo_utils_tpu_torch.trees import robinson_foulds

from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREE = "((a:0.1,b:0.2):0.05,(c:0.3,d:0.15):0.07);"


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
    tree (no two branch lengths confounded)."""
    tree = "(a:0.1,b:0.2,(c:0.15,(d:0.1,(e:0.2,f:0.05):0.1):0.12):0.08);"
    aln = simulate_alignment(jax.random.key(5), j_parse_newick(tree),
                             jmodels.K80, 300,
                             params={"kappa": 3.0, "alpha": 0.8}, ncat=4)
    path = tmp_path_factory.mktemp("sim") / "sim.fa"
    write_fasta(aln, path=str(path))
    return tree, str(path)


def _run(main, args, capsys):
    assert main(args) == 0
    return json.loads(capsys.readouterr().out)


def _both(args, capsys):
    """(port JSON, JAX JSON) of one command line."""
    port = _run(cli.main, args + ["--device", "cpu"], capsys)
    return port, _run(jax_main, args, capsys)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-300))


@pytest.mark.parametrize("model", ["HKY85+G4", "GTR+G4+I+F", "JC69"])
def test_loglik_matches_jax_cli(small_inputs, capsys, model):
    tree, fasta = small_inputs
    port, want = _both(["loglik", "--tree", tree, "--alignment", fasta,
                        "--model", model, "--sitewise"], capsys)
    assert _rel(port["loglik"], want["loglik"]) <= 1e-10
    assert len(port["sitewise"]) == 10
    assert _rel(port["sitewise"], want["sitewise"]) <= 1e-10


def test_loglik_params_json_and_empirical_freqs(small_inputs, capsys):
    """--params goes through convert.params_from_jax; '+F' and
    --empirical-freqs are one flag, and --params wins over it."""
    tree, fasta = small_inputs
    params = json.dumps({"model": {"kappa": 2.5}, "alpha": 0.7})
    base = ["loglik", "--tree", tree, "--alignment", fasta,
            "--params", params]
    port, want = _both(base + ["--model", "HKY85+G4", "--empirical-freqs"],
                       capsys)
    assert _rel(port["loglik"], want["loglik"]) <= 1e-10
    plus_f = _run(cli.main, base + ["--model", "HKY85+G4+F", "--device",
                                    "cpu"], capsys)
    assert plus_f["loglik"] == port["loglik"]


def test_distances_match_jax_cli(small_inputs, capsys):
    _, fasta = small_inputs
    port, want = _both(["distances", "--alignment", fasta, "--model",
                        "JC69"], capsys)
    assert port["names"] == want["names"]
    assert _rel(port["distances"], want["distances"]) <= 1e-10
    assert cli.main(["distances", "--alignment", fasta, "--format", "phylip",
                     "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert jax_main(["distances", "--alignment", fasta, "--format",
                     "phylip"]) == 0
    assert text == capsys.readouterr().out


def test_bootstrap_matches_jax_cli(small_inputs, capsys):
    """Replicates are multinomial draws over the compressed patterns; the
    port draws them in first-occurrence order, the JAX package's storage
    order, so each replicate matches."""
    tree, fasta = small_inputs
    port, want = _both(["bootstrap", "--tree", tree, "--alignment", fasta,
                        "--model", "JC69", "--replicates", "50", "--seed",
                        "3", "--full"], capsys)
    assert port["n_replicates"] == 50
    assert _rel(port["logliks"], want["logliks"]) <= 1e-10
    for q in ("q025", "q500", "q975"):
        assert _rel(port["quantiles"][q], want["quantiles"][q]) <= 1e-10


def test_build_tree_matches_jax_cli(simulated, tmp_path, capsys):
    _, fasta = simulated
    out = str(tmp_path / "nj.nwk")
    params = json.dumps({"kappa": 3.0})
    port, want = _both(["build-tree", "--alignment", fasta, "--model", "K80",
                        "--params", params, "--out", out], capsys)
    assert port["method"] == want["method"] == "nj"
    got, ref = parse_newick(port["tree"]), parse_newick(want["tree"])
    assert robinson_foulds(got, ref) == 0.0
    assert got.names == ref.names
    assert _rel(got.lengths, ref.lengths) <= 1e-10
    with open(out) as f:
        assert f.read().strip() == write_newick(got)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float64)


def test_fit_se_matches_jax_cli(simulated, tmp_path, capsys):
    """``fit --se`` with every parameter free: both packages take central
    differences of the exact gradient (the port for the free model, JAX
    for the free alpha); compared at each package's own optimum."""
    tree, fasta = simulated
    metrics = str(tmp_path / "m.jsonl")
    args = ["fit", "--tree", tree, "--alignment", fasta, "--model",
            "K80+G4", "--max-steps", "200", "--se"]
    port = _run(cli.main, args + ["--device", "cpu", "--metrics", metrics],
                capsys)
    want = _run(jax_main, args, capsys)
    assert _rel(port["loglik"], want["loglik"]) <= 1e-6
    assert port["loglik"] >= want["loglik"] - 1e-6 * abs(want["loglik"])
    got_se, want_se = dict(_leaves(port["standard_errors"])), dict(
        _leaves(want["standard_errors"]))
    assert set(got_se) == set(want_se)
    for path, g in _leaves(port["params"]):
        w = dict(_leaves(want["params"]))[path]
        keep = w > 1e-3               # leave out boundary branch lengths
        assert _rel(g[keep], w[keep]) <= 1e-3, path
        s, ws = got_se[path], want_se[path]
        ok = keep & np.isfinite(ws)
        assert np.all(np.isfinite(s[ok])) and np.all(s[ok] > 0), path
        assert _rel(s[ok], ws[ok]) <= 1e-2, path
    lines = [json.loads(line) for line in open(metrics)]
    assert lines and "loglik" in lines[0] and "patterns_per_s" in lines[0]


@pytest.fixture(scope="module")
def codon_inputs(tmp_path_factory):
    """60 codons simulated by the JAX package under GY94 (kappa 2.5, omega
    0.3) on a 5-taxon tree (one codon gapped), their F3x4 frequencies as
    --params JSON."""
    from phylo_utils_tpu.models.codon import empirical_codon_frequencies

    tree = "(a:0.2,b:0.3,(c:0.25,(d:0.2,e:0.3):0.15):0.2);"
    aln = simulate_alignment(jax.random.key(8), j_parse_newick(tree),
                             jmodels.GY94, 60,
                             params={"kappa": 2.5, "omega": 0.3})
    aln["e"] = "---" + aln["e"][3:]
    path = tmp_path_factory.mktemp("codon") / "codon.fa"
    write_fasta(aln, path=str(path))
    freqs = empirical_codon_frequencies(aln, "f3x4").tolist()
    return tree, str(path), freqs


@pytest.mark.parametrize("model", ["GY94", "MG94+G4"])
def test_codon_loglik_matches_jax_cli(codon_inputs, capsys, model):
    tree, fasta, freqs = codon_inputs
    params = {"model": {"kappa": 2.5, "omega": 0.3}}
    if model == "GY94":
        params["model"]["freqs"] = freqs
    port, want = _both(["loglik", "--tree", tree, "--alignment", fasta,
                        "--model", model, "--sitewise", "--params",
                        json.dumps(params)], capsys)
    assert _rel(port["loglik"], want["loglik"]) <= 1e-10
    assert len(port["sitewise"]) == 60
    assert _rel(port["sitewise"], want["sitewise"]) <= 1e-10


def test_codon_fit_dn_ds_matches_jax_cli(codon_inputs, capsys):
    """``fit --model GY94`` with kappa, omega and the branch lengths free
    (codeml's F3x4 frequencies held): logL to 1e-6 relative, estimates to
    1e-3, and the ``dn_ds`` block to 1e-3 at each package's own estimates
    (omega == dN/dS, S + N == 3)."""
    tree, fasta, freqs = codon_inputs
    args = ["fit", "--tree", tree, "--alignment", fasta, "--model", "GY94",
            "--params", json.dumps({"model": {"freqs": freqs}}), "--free",
            "branch_lengths,model.kappa,model.omega", "--max-steps", "200"]
    port, want = _both(args, capsys)
    assert _rel(port["loglik"], want["loglik"]) <= 1e-6
    for key in ("kappa", "omega"):
        assert _rel(port["params"]["model"][key],
                    want["params"]["model"][key]) <= 1e-3, key
    got, ref = port["dn_ds"], want["dn_ds"]
    assert set(got) == set(ref)
    for key in ("omega", "S", "N", "dN", "dS"):
        assert _rel(got[key], ref[key]) <= 1e-3, key
    assert abs(got["S"] + got["N"] - 3.0) < 1e-12
    np.testing.assert_allclose(np.asarray(got["dN"]) / np.asarray(got["dS"]),
                               got["omega"], rtol=1e-10)


@pytest.mark.parametrize("asc,counts", [("lewis", None),
                                        ("felsenstein", "25"),
                                        ("stamatakis", "10,15")])
def test_mk_asc_loglik_matches_jax_cli(tmp_path, capsys, asc, counts):
    """``loglik --model MK2 --asc ...`` on a variable-only binary matrix."""
    rng = np.random.default_rng(3)
    cols = [c for c in rng.integers(0, 2, (60, 5)) if len(set(c)) > 1]
    aln = {n: "".join(str(c[i]) for c in cols) for i, n in enumerate("abcde")}
    fasta = tmp_path / "mk.fa"
    write_fasta(aln, path=str(fasta))
    tree = "(a:0.1,b:0.2,(c:0.15,(d:0.1,e:0.2):0.1):0.08);"
    args = ["loglik", "--tree", tree, "--alignment", str(fasta), "--model",
            "MK2+G4", "--asc", asc, "--sitewise"]
    if counts:
        args += ["--asc-counts", counts]
    port, want = _both(args, capsys)
    assert _rel(port["loglik"], want["loglik"]) <= 1e-10
    assert _rel(port["sitewise"], want["sitewise"]) <= 1e-10
    with pytest.raises(SystemExit, match="requires --asc"):
        cli.main(["loglik", "--tree", tree, "--alignment", str(fasta),
                  "--model", "MK2", "--asc-counts", "3", "--device", "cpu"])


def test_fit_checkpoint_and_resume(small_inputs, tmp_path, capsys):
    """A final-params checkpoint seeds a resumed fit; a full-state one
    (--checkpoint-every) resumes bit for bit."""
    tree, fasta = small_inputs
    base = ["fit", "--tree", tree, "--alignment", fasta, "--model", "K80",
            "--device", "cpu"]
    final = str(tmp_path / "final.pt")
    out = _run(cli.main, base + ["--max-steps", "20", "--checkpoint", final],
               capsys)
    again = _run(cli.main, base + ["--max-steps", "3", "--resume", final],
                 capsys)
    assert again["loglik"] >= out["loglik"] - 1e-9
    full = str(tmp_path / "full.pt")
    whole = _run(cli.main, base + ["--max-steps", "6", "--steps-per-call",
                                   "1"], capsys)
    _run(cli.main, base + ["--max-steps", "3", "--steps-per-call", "1",
                           "--checkpoint", full, "--checkpoint-every", "3"],
         capsys)
    resumed = _run(cli.main, base + ["--max-steps", "6", "--steps-per-call",
                                     "1", "--resume", full], capsys)
    assert resumed["params"] == whole["params"]


@pytest.mark.parametrize("model,sites,width,alphabet", [
    ("HKY85", 120, 1, "ACGT"), ("GY94", 40, 3, "ACGT"),
    ("LG", 60, 1, "ARNDCQEGHILKMFPSTWYV")])
def test_simulate_writes_fasta_that_loglik_reads(tmp_path, capsys, model,
                                                 sites, width, alphabet):
    """``simulate --device cpu`` writes FASTA through ``write_fasta`` (the
    tree's leaf names, ``sites`` x the state width, the model's
    alphabet); the same seed prints the same text to stdout; the port's
    and the JAX CLI's ``loglik`` read the file back to the same logL
    (1e-10 relative)."""
    out = str(tmp_path / "sim.fa")
    args = ["simulate", "--tree", TREE, "--model", model, "--sites",
            str(sites), "--ncat", "4", "--params", '{"alpha": 0.7}',
            "--seed", "11", "--device", "cpu"]
    assert cli.main(args + ["--out", out]) == 0
    with open(out) as f:
        text = f.read()
    assert cli.main(args) == 0
    assert capsys.readouterr().out == text
    from phylo_utils_tpu_torch.io import read_fasta

    aln = read_fasta(out)
    assert list(aln) == ["a", "b", "c", "d"]
    assert {len(s) for s in aln.values()} == {sites * width}
    assert set("".join(aln.values())) <= set(alphabet)
    port, want = _both(["loglik", "--tree", TREE, "--alignment", out,
                        "--model", model + "+G4"], capsys)
    assert np.isfinite(port["loglik"])
    assert _rel(port["loglik"], want["loglik"]) <= 1e-10


def test_simulate_on_the_card_by_default(tmp_path):
    """Without --device the simulator runs on the card, and says so where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there")
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["simulate", "--tree", TREE, "--sites", "10", "--out",
                  str(tmp_path / "x.fa")])


# the subcommands refused until their ROADMAP item was ported, and the keys
# each prints now (``tests/test_torch_cli_analyses.py`` holds the values to
# the JAX CLI's; ``benchmark``'s are held to the JAX CLI's here)
_NOW_PORTED = {
    "ancestral": {"n_internal_nodes", "n_sites", "map_states",
                  "max_posterior", "map_sequences"},
    "branch-site-test": {"loglik_null", "loglik_alt", "lrt", "alt_params"},
    "clock-test": {"loglik_clock", "loglik_unconstrained", "df", "lrt",
                   "chronogram"},
    "date": {"lambda", "ages", "max_calibration_violation", "objective",
             "chronogram"},
}

# each package's default pruner, and the kernels' pruner
_PRUNERS = {"xla": "torch", "pallas": "cuda"}


@pytest.mark.parametrize("name", ["ancestral", "benchmark",
                                  "branch-site-test", "clock-test", "date"])
def test_unported_subcommands_name_their_roadmap_item(name, small_inputs,
                                                      capsys):
    """Every subcommand refused until its ROADMAP item was ported now runs
    (no subcommand is refused): the four A18 analyses print the JAX CLI's
    keys, and ``benchmark`` (A2) prints the JAX CLI's six keys with its
    pattern count and the counterpart of its default pruner, on one
    device (the JAX CLI counts conftest's 8 virtual CPU devices)."""
    assert cli.NOT_PORTED == {}
    tree, fasta = small_inputs
    if name == "benchmark":
        port, ref = _both(["benchmark", "--tree", tree, "--alignment", fasta,
                           "--iters", "2"], capsys)
        assert set(port) == set(ref) == {
            "patterns_per_s", "patterns_per_s_per_chip", "step_ms",
            "n_patterns", "n_devices", "pruner"}
        assert port["n_patterns"] == ref["n_patterns"] == 10
        assert port["pruner"] == _PRUNERS[ref["pruner"]]
        assert port["n_devices"] == 1
        assert port["step_ms"] > 0 and port["patterns_per_s"] == \
            port["patterns_per_s_per_chip"]
        return
    codons = os.path.join(os.path.dirname(fasta), "codons.fa")
    with open(codons, "w") as f:
        f.write(">a\nATGAAACGT\n>b\nATGAAGCGT\n>c\nATGCAACGC\n"
                ">d\nTTGAAACGA\n")
    args = {
        "ancestral": ["--alignment", fasta, "--model", "HKY85"],
        "branch-site-test": ["--alignment", codons, "--foreground", "a,b",
                             "--clade", "--max-steps", "2"],
        "clock-test": ["--alignment", fasta, "--model", "JC69",
                       "--max-steps", "3"],
        "date": ["--sites", "100", "--steps", "20"],
    }[name]
    assert cli.main([name, "--tree", tree, "--device", "cpu"] + args) == 0
    assert set(json.loads(capsys.readouterr().out)) == _NOW_PORTED[name]


@pytest.mark.parametrize("flag,item", [
    pytest.param(["--partitions", "parts.txt"], "A16", id="flag0-A16"),
    pytest.param(["--shard-sites"], "A12", id="flag2-A12"),
])
def test_unported_flags_name_their_roadmap_item(small_inputs, flag, item,
                                                tmp_path, monkeypatch,
                                                capsys):
    """--shard-sites (A12) and --partitions (A16), each refused until its
    item was ported, now run: --shard-sites (one CPU shard under --device
    cpu) prints the JAX CLI's JSON on its 8-device mesh, logL and sitewise
    values to 1e-10 relative; --partitions prints the JAX CLI's keys
    (``tests/test_torch_cli_partition.py`` holds its values to JAX's)."""
    tree, fasta = small_inputs
    args = ["loglik", "--tree", tree, "--alignment", fasta, "--device",
            "cpu"] + flag
    if item == "A16":
        monkeypatch.chdir(tmp_path)
        n = len(next(iter(read_alignment(fasta).values())))
        (tmp_path / "parts.txt").write_text(
            f"DNA, a = 1-{n // 2}\nDNA, b = {n // 2 + 1}-{n}\n")
        assert cli.main(args) == 0
        out = json.loads(capsys.readouterr().out)
        assert set(out) == {"loglik", "partition_logliks"}
        assert set(out["partition_logliks"]) == {"a", "b"}
        return
    args += ["--model", "GTR+G4+I", "--sitewise"]
    port = _run(cli.main, args, capsys)
    want = _run(jax_main, [a for a in args if a not in ("--device", "cpu")],
                capsys)
    assert set(port) == set(want) == {"loglik", "sitewise"}
    assert _rel(port["loglik"], want["loglik"]) <= 1e-10
    assert _rel(port["sitewise"], want["sitewise"]) <= 1e-10


@pytest.mark.parametrize("flag,item", [(["--refine"], "A17"),
                                       (["--bootstrap", "10"], "A18")])
def test_build_tree_unported_options(small_inputs, flag, item, capsys):
    """build-tree's --refine (A17) and --bootstrap (A18), refused until
    their items were ported, now run and print the JAX CLI's keys
    (``tests/test_torch_cli_search.py`` holds their values to JAX's)."""
    _, fasta = small_inputs
    assert cli.main(["build-tree", "--alignment", fasta, "--device",
                     "cpu"] + flag) == 0
    out = json.loads(capsys.readouterr().out)
    keys = {"tree", "loglik", "method"}
    if item == "A17":
        assert out["method"] == "nj+nni" and out["loglik"] is not None
    else:
        keys |= {"bootstrap_support", "tbe_support", "consensus_tree"}
        assert all(0.0 <= v <= 1.0 for v in out["bootstrap_support"].values())
    assert set(out) == keys


def test_default_device_is_the_card(small_inputs):
    """Without --device the engine runs on the card, and says so where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there")
    tree, fasta = small_inputs
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["loglik", "--tree", tree, "--alignment", fasta])


def test_module_entry_points(small_inputs):
    """``python -m phylo_utils_tpu_torch.cli`` and ``python -m
    phylo_utils_tpu_torch`` print the same JSON in a fresh process, which
    imports nothing of JAX or the JAX package. The two processes run side
    by side, each on one intra-op thread."""
    tree, fasta = small_inputs
    args = ["loglik", "--tree", tree, "--alignment", fasta, "--model",
            "HKY85", "--device", "cpu"]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = []
    for mod in ("phylo_utils_tpu_torch.cli", "phylo_utils_tpu_torch"):
        probe = (
            "import runpy, sys\n"
            f"sys.argv = ['x'] + {args!r}\n"
            "try:\n"
            f"    runpy.run_module({mod!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "import phylo_utils_tpu_torch.nj, phylo_utils_tpu_torch.optimize\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'phylo_utils_tpu', 'oracle'))\n"
            "assert not bad, bad\n")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", probe], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert outs[0] == outs[1] and outs[0]["loglik"] < 0


def test_package_exports_the_ported_names():
    """``phylo_utils_tpu_torch`` exports the ported public names of the JAX
    package's ``__init__`` under the same names."""
    import phylo_utils_tpu
    import phylo_utils_tpu_torch

    names = ("LikelihoodEngine", "EngineServer", "fit", "brent_minimize",
             "golden_section", "newton_branch_length", "neighbor_joining",
             "Tree", "compile_schedule", "random_tree", "robinson_foulds",
             "midpoint_root", "reroot", "nni_neighbors", "spr_neighbors")
    for name in names:
        assert hasattr(phylo_utils_tpu, name), name
        assert callable(getattr(phylo_utils_tpu_torch, name)), name
    for name in ("fit_multistart", "fisher_covariance", "standard_errors",
                 "ml_distance_matrix"):
        assert getattr(phylo_utils_tpu_torch, name).__module__ == \
            "phylo_utils_tpu_torch.optimize"


def test_bootstrap_replicates_do_not_depend_on_pattern_order():
    """The port stores patterns in ``np.unique`` order, the JAX package in
    order of first occurrence. An engine over either storage draws the JAX
    engine's replicates for one seed."""
    from phylo_utils_tpu.io import compress_patterns as j_compress
    from phylo_utils_tpu.likelihood import LikelihoodEngine as JaxEngine
    from phylo_utils_tpu_torch import models
    from phylo_utils_tpu_torch.io import CompressedAlignment
    from phylo_utils_tpu_torch.io import compress_patterns as t_compress
    from phylo_utils_tpu_torch.likelihood import LikelihoodEngine

    rng = np.random.default_rng(2)
    cols = rng.choice(list("ACGTN-"), size=(4, 40), p=[.3, .3, .2, .1, .05,
                                                      .05])
    perm = rng.permutation(120)               # each column three times
    aln = {n: "".join(np.repeat(cols[i], 3)[perm])
           for i, n in enumerate("abcd")}
    j, t = j_compress(aln, "dna"), t_compress(aln, "dna")
    assert t.n_patterns < 120
    assert not np.array_equal(t.site_to_pattern, j.site_to_pattern)
    first = CompressedAlignment(tuple(j.names), np.asarray(j.partials),
                                np.asarray(j.weights),
                                np.asarray(j.site_to_pattern))
    want = JaxEngine(j_parse_newick(TREE), aln, jmodels.JC69,
                     dtype="float64").bootstrap_loglikelihoods(30, seed=4)
    for ca in (t, first):
        got = LikelihoodEngine(parse_newick(TREE), ca, models.JC69,
                               device="cpu").bootstrap_loglikelihoods(
                                   30, seed=4)
        assert _rel(got, want) <= 1e-10
