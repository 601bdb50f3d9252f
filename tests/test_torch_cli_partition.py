"""Port parity, partitioned CLI and server: ``phylo_utils_tpu_torch.cli``'s
``--partitions`` (``loglik``, ``fit``) and ``partitionfinder`` against the
JAX CLI on the same files (``--device cpu``), and ``EngineServer``'s
``/partitions`` and ``/health`` on both partitioned engines.

Tolerances: ``loglik`` and ``partition_logliks`` to 1e-10 relative (f64);
``fit`` prints the JAX CLI's keys and its logL equals the JAX CLI's
``loglik`` at the fitted parameters to 1e-8 relative (the two packages'
optimizers differ); ``partitionfinder`` prints the JAX CLI's keys and
scheme (names, models, site counts, merges), each subset's logL to 1e-5
absolute.
"""
import json
import urllib.error
import urllib.request

import jax
import pytest

from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu.cli import main as jax_main
from phylo_utils_tpu.io import parse_newick as j_parse_newick
from phylo_utils_tpu.io import write_fasta
from phylo_utils_tpu.simulate import simulate_alignment
from phylo_utils_tpu_torch import cli
from phylo_utils_tpu_torch.io import read_alignment
from phylo_utils_tpu_torch.partition import (
    PartitionedEngine,
    StackedPartitionedEngine,
    partitions_from_file,
)
from phylo_utils_tpu_torch.server import EngineServer

from torch_threads import one_thread  # noqa: F401

TREE = "(a:0.1,b:0.2,(c:0.15,(d:0.1,(e:0.2,f:0.05):0.1):0.12):0.08);"
# RAxML-style: a '+F' entry, a codon-position stride and gamma categories
STACKED = ("DNA+G4+F, p12 = 1-120\\3, 2-120\\3\n"
           "DNA+G4, p3 = 3-120\\3\n")
MIXED = "HKY85+G4, left = 1-60\nJC69, right = 61-120\n"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """120 GTR+G4 sites simulated by the JAX package on a 6-taxon tree, and
    partition files over them."""
    aln = simulate_alignment(jax.random.key(9), j_parse_newick(TREE),
                             jmodels.GTR, 120,
                             params={"alpha": 0.8,
                                     "rates": [1, 3, 1, 1, 3, 1]}, ncat=4)
    d = tmp_path_factory.mktemp("parts")
    write_fasta(aln, path=str(d / "aln.fa"))
    for name, text in (("stacked.txt", STACKED), ("mixed.txt", MIXED),
                       ("subsets.txt", "DNA, s1 = 1-60\nDNA, s2 = 61-120\n")):
        (d / name).write_text(text)
    return {name: str(d / name) for name in
            ("aln.fa", "stacked.txt", "mixed.txt", "subsets.txt")}


def _run(main, args, capsys):
    assert main(args) == 0
    return json.loads(capsys.readouterr().out)


def _both(args, capsys):
    return (_run(cli.main, args + ["--device", "cpu"], capsys),
            _run(jax_main, args, capsys))


def _rel(got, want):
    return abs(got - want) / abs(want)


@pytest.mark.parametrize("which", ["stacked.txt", "mixed.txt"])
def test_loglik_partitions_matches_jax_cli(files, capsys, which):
    args = ["loglik", "--tree", TREE, "--alignment", files["aln.fa"],
            "--partitions", files[which], "--params",
            json.dumps({"partition_rates": [0.7, 1.6]})]
    port, want = _both(args, capsys)
    assert set(port) == set(want) == {"loglik", "partition_logliks"}
    assert _rel(port["loglik"], want["loglik"]) <= 1e-10
    assert set(port["partition_logliks"]) == set(want["partition_logliks"])
    for name, ll in want["partition_logliks"].items():
        assert _rel(port["partition_logliks"][name], ll) <= 1e-10
    with pytest.raises(SystemExit, match="--sitewise is not supported"):
        cli.main(args + ["--device", "cpu", "--sitewise"])


def test_partitions_engine_choice_and_refusals(files):
    """One model family stacks; a mix takes one engine a locus; the
    file's '+F' rides on the engine; --empirical-freqs and a bad file are
    refused as the JAX CLI refuses them."""
    base = ["--tree", TREE, "--alignment", files["aln.fa"], "--device",
            "cpu"]

    def build(extra):
        return cli._build_engine(_namespace(base + extra))

    stacked = build(["--partitions", files["stacked.txt"]])
    assert isinstance(stacked, StackedPartitionedEngine)
    assert set(stacked._partition_init_params["partitions"]) == {"p12"}
    mixed = build(["--partitions", files["mixed.txt"]])
    assert type(mixed) is PartitionedEngine
    with pytest.raises(SystemExit, match="per-partition under"):
        build(["--partitions", files["stacked.txt"], "--empirical-freqs"])
    with pytest.raises(SystemExit, match="--partitions: .*exceeds"):
        build(["--partitions", "DNA, g = 1-500"])


def _namespace(args):
    """The ``loglik`` subcommand's parsed arguments."""
    import argparse

    ap = argparse.ArgumentParser()
    cli._add_engine_args(ap)
    return ap.parse_args(args)


def test_fit_partitions_matches_jax_cli(files, capsys):
    args = ["fit", "--tree", TREE, "--alignment", files["aln.fa"],
            "--partitions", files["stacked.txt"], "--max-steps", "5"]
    port, want = _both(args, capsys)
    assert set(port) == set(want)
    assert set(port["params"]) == set(want["params"])
    for name, sub in want["params"]["partitions"].items():
        assert set(port["params"]["partitions"][name]) == set(sub)
    # the JAX CLI's logL at the port's fitted parameters
    at = _run(jax_main, ["loglik", "--tree", TREE, "--alignment",
                         files["aln.fa"], "--partitions",
                         files["stacked.txt"], "--params",
                         json.dumps(port["params"])], capsys)
    assert _rel(port["loglik"], at["loglik"]) <= 1e-8


def test_partitionfinder_matches_jax_cli(files, capsys):
    args = ["partitionfinder", "--tree", TREE, "--alignment",
            files["aln.fa"], "--subsets", files["subsets.txt"], "--models",
            "JC69,K80", "--max-steps", "20"]
    port, want = _both(args, capsys)
    assert set(port) == set(want)
    assert port["merged_from"] == want["merged_from"]
    assert port["n_rounds"] == want["n_rounds"]
    for got, ref in zip(port["scheme"], want["scheme"]):
        assert set(got) == set(ref)
        for key in ("name", "model", "k", "n_sites"):
            assert got[key] == ref[key], key
        assert abs(got["loglik"] - ref["loglik"]) < 1e-5


def _url(srv, route):
    return f"http://127.0.0.1:{srv.port}{route}"


def _post(srv, route, body=None):
    req = urllib.request.Request(
        _url(srv, route), data=json.dumps(body or {}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("which", ["stacked.txt", "mixed.txt"])
def test_server_partitions_and_health(files, which):
    aln = read_alignment(files["aln.fa"])
    with open(files[which]) as f:
        parts, _ = partitions_from_file(f.read(), aln)
    cls = (StackedPartitionedEngine if which == "stacked.txt"
           else PartitionedEngine)
    engine = cls(TREE, parts, device="cpu", pruner="cuda",
                 dtype="float32")
    srv = EngineServer(engine, port=0)
    srv.start()
    try:
        with urllib.request.urlopen(_url(srv, "/health"), timeout=30) as r:
            h = json.loads(r.read())
        assert h["model"] == {p.name: p.model.name for p in parts}
        assert h["n_patterns"] == sum(
            len(set(zip(*p.alignment.values()))) for p in parts)
        assert h["pruner"] == "cuda" and h["device"] == "cpu"
        body = {"params": {"partition_rates": [0.7, 1.6]}}
        got = _post(srv, "/partitions", body)["partitions"]
        want = engine.partition_loglikelihoods(body["params"])
        assert got == want
        assert _post(srv, "/loglik", body)["loglik"] == pytest.approx(
            sum(want.values()), rel=1e-12)
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(srv, "/sitewise", body)
        assert exc.value.code == 501
    finally:
        srv.stop()
