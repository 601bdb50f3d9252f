"""Port parity, the CLI's search and support surfaces: ``topologies --test
all``, ``search``, ``supports`` (with ``--scf``), ``lmap``, ``consense``
and ``build-tree --refine --bootstrap`` in ``python -m
phylo_utils_tpu_torch.cli`` against the JAX package's CLI on the same
files, with ``--device cpu`` and one intra-op thread.

Each JSON has JAX's keys. Tolerances: logLs 1e-8 relative (1e-10 for
``topologies``, a single scoring pass), topologies RF 0, the RELL tests'
numbers 1e-9 relative, supports, TBE and round counts equal, ``lmap``'s
rounded points within 1e-3 and its fractions equal, ``consense``'s newick
text equal. ``supports`` runs with both packages' base ``fit`` returning
the same fitted lengths, as in ``tests/test_torch_supports.py`` (their
L-BFGS runs differ in the last digits, which Adam's first sign step
amplifies).
"""
import contextlib
import io
import json
import types

import jax
import numpy as np
import pytest
import torch

import phylo_utils_tpu.optimize as jax_optimize
import phylo_utils_tpu_torch.optimize as port_optimize
from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu.cli import main as jax_main
from phylo_utils_tpu.io import parse_newick as j_parse_newick
from phylo_utils_tpu.io import write_fasta
from phylo_utils_tpu.simulate import simulate_alignment
from phylo_utils_tpu_torch import cli
from phylo_utils_tpu_torch.io import parse_newick, write_newick
from phylo_utils_tpu_torch.trees import (
    nni_neighbors,
    random_tree,
    robinson_foulds,
)

from torch_threads import one_thread  # noqa: F401


def _run(main, args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(args) == 0
    return json.loads(out.getvalue())


def _both(args):
    """(port JSON, JAX JSON) of one command line."""
    return _run(cli.main, args + ["--device", "cpu"]), _run(jax_main, args)


def _rf(a, b):
    return robinson_foulds(parse_newick(a), parse_newick(b))


def _close(got, want, rtol, path="out"):
    """Nested JSON equal up to ``rtol`` on floats."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], rtol, f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, rtol, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= rtol * max(abs(want), 1.0), (path, got,
                                                                want)
    else:
        assert got == want, path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """An 8-taxon tree, 300 HKY85 sites simulated on it by the JAX package,
    and a file of 8 candidate trees (the tree and 7 NNI neighbors)."""
    tree = random_tree(8, seed=7)
    aln = simulate_alignment(jax.random.PRNGKey(3),
                             j_parse_newick(write_newick(tree)),
                             jmodels.HKY85, n_sites=300)
    d = tmp_path_factory.mktemp("search")
    fasta, tree_path, trees_path = (str(d / n) for n in (
        "aln.fa", "t.nwk", "cands.nwk"))
    write_fasta(aln, path=fasta)
    with open(tree_path, "w") as f:
        f.write(write_newick(nni_neighbors(tree)[0]) + "\n")
    with open(trees_path, "w") as f:
        f.write("\n".join(write_newick(t) for t in
                          [tree] + nni_neighbors(tree)[:7]) + "\n")
    return tree, fasta, tree_path, trees_path


def test_topologies_matches_jax_cli(files):
    _, fasta, _, trees_path = files
    base = ["topologies", "--trees", trees_path, "--alignment", fasta,
            "--model", "HKY85", "--ncat", "2"]
    port, want = _both(base)
    assert set(port) == set(want) == {"n_trees", "logliks", "best_index"}
    _close(port, want, 1e-10)
    port, want = _both(base + ["--test", "all", "--n-boot", "300"])
    assert set(port) == set(want) == {"n_trees", "logliks", "best_index",
                                      "kh", "sh", "au"}
    _close(port, want, 1e-9)


@pytest.mark.parametrize("moves,rounds", [("nni", "3"), ("both", "1")])
def test_search_matches_jax_cli(files, moves, rounds, tmp_path):
    _, fasta, tree_path, _ = files
    args = ["search", "--tree", tree_path, "--alignment", fasta, "--model",
            "HKY85", "--moves", moves, "--max-rounds", rounds]
    port, want = _both(args + ["--out", str(tmp_path / "best.nwk")])
    assert set(port) == set(want) == {"loglik", "rounds", "tree"}
    assert port["rounds"] == want["rounds"]
    assert _rf(port["tree"], want["tree"]) == 0.0
    assert abs(port["loglik"] - want["loglik"]) <= 1e-8 * abs(want["loglik"])
    with open(tmp_path / "best.nwk") as f:
        assert _rf(f.read().strip(), want["tree"]) == 0.0


def test_supports_matches_jax_cli(files, monkeypatch):
    tree, fasta, _, _ = files
    lengths = np.array(tree.lengths) * 0.9

    def pinned(to_port):
        def fit(engine, params0=None, **_):
            full = engine._full_params(params0)
            full["branch_lengths"] = (
                torch.tensor(lengths, dtype=engine.dtype)
                if to_port else lengths)
            return types.SimpleNamespace(params=full,
                                         loglik=engine.loglikelihood(full))
        return fit

    monkeypatch.setattr(jax_optimize, "fit", pinned(False))
    monkeypatch.setattr(port_optimize, "fit", pinned(True))
    port, want = _both(["supports", "--tree", write_newick(tree),
                        "--alignment", fasta, "--model", "HKY85",
                        "--replicates", "200", "--scf", "20"])
    assert set(port) == set(want) == {"loglik", "tree", "edges", "scf"}
    assert abs(port["loglik"] - want["loglik"]) <= 1e-10 * abs(want["loglik"])
    assert port["scf"] == want["scf"]
    assert len(port["edges"]) == len(want["edges"]) == 5
    for got, ref in zip(port["edges"], want["edges"]):
        assert set(got) == set(ref)
        assert got["node"] == ref["node"] and got["clade"] == ref["clade"]
        assert abs(got["stat"] - ref["stat"]) <= 1e-6
        assert abs(got["alrt"] - ref["alrt"]) <= 1e-8
        assert abs(got["abayes"] - ref["abayes"]) <= 1e-8
        assert got["sh_alrt"] == ref["sh_alrt"]


def test_lmap_matches_jax_cli(files):
    _, fasta, _, _ = files
    port, want = _both(["lmap", "--alignment", fasta, "--model", "K80",
                        "--n-quartets", "20", "--seed", "3", "--points",
                        "--params", '{"model": {"kappa": 2.0}}'])
    assert set(port) == set(want) == {"basins", "resolved", "star",
                                      "n_quartets", "points"}
    assert port["n_quartets"] == want["n_quartets"] == 20
    assert np.abs(np.asarray(port["points"])
                  - np.asarray(want["points"])).max() <= 1e-3
    for key in ("basins", "resolved", "star"):
        assert port[key] == want[key], key
    with pytest.raises(SystemExit, match="single-rate"):
        cli.main(["lmap", "--alignment", fasta, "--model", "K80+G4",
                  "--device", "cpu"])


def test_consense_matches_jax_cli(files, tmp_path):
    _, _, _, trees_path = files
    port, want = _both(["consense", "--trees", trees_path, "--min-freq",
                        "0.5", "--out", str(tmp_path / "cons.nwk")])
    assert set(port) == set(want) == {"n_trees", "consensus"}
    assert port == want
    with open(tmp_path / "cons.nwk") as f:
        assert f.read().strip() == want["consensus"]


def test_build_tree_refine_bootstrap_matches_jax_cli(files, tmp_path):
    """NJ, the NNI hill-climb and 10 bootstrap replicates: JAX's tree (RF
    0), logL, method, supports, TBE and consensus."""
    _, fasta, _, _ = files
    out = str(tmp_path / "bt.nwk")
    port, want = _both(["build-tree", "--alignment", fasta, "--model",
                        "HKY85", "--refine", "--bootstrap", "10", "--out",
                        out])
    assert set(port) == set(want) == {
        "tree", "loglik", "method", "bootstrap_support", "tbe_support",
        "consensus_tree"}
    assert port["method"] == want["method"] == "nj+nni"
    assert _rf(port["tree"], want["tree"]) == 0.0
    assert abs(port["loglik"] - want["loglik"]) <= 1e-8 * abs(want["loglik"])
    assert port["bootstrap_support"] == want["bootstrap_support"]
    assert port["tbe_support"] == want["tbe_support"]
    assert _rf(port["consensus_tree"], want["consensus_tree"]) == 0.0
    with open(out + ".consensus") as f:
        assert f.read().strip() == port["consensus_tree"]
