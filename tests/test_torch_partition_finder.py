"""Port parity, PartitionFinder-style scheme selection:
``phylo_utils_tpu_torch.model_selection.partition_finder`` mirrors
``tests/test_partition_finder.py`` (construction-guaranteed merge
decisions) and is held to the JAX package's ``partition_finder`` on the
same subsets: the same scheme (subset names, columns, chosen models,
parameter counts, rounds and merge history), each subset's fitted logL to
1e-5 absolute (the two packages' L-BFGS differ, so the fits agree at their
optima, as ``tests/test_torch_optimize.py`` holds them).
"""
import numpy as np
import pytest

from phylo_utils_tpu.model_selection import (
    partition_finder as jax_partition_finder,
)
from phylo_utils_tpu_torch.model_selection import partition_finder

from torch_threads import one_thread  # noqa: F401

TREE4 = "((a:0.12,b:0.23):0.05,(c:0.31,d:0.17):0.08);"


def _sim(seed, n, model="jc"):
    """Tiny DNA columns: iid uniform (jc-ish) or AT-rich biased."""
    rng = np.random.default_rng(seed)
    chars = "ACGT"
    if model == "jc":
        m = rng.integers(0, 4, size=(4, n))
    else:
        m = rng.choice([0, 3, 3, 0, 1, 2], size=(4, n))
    return {t: "".join(chars[s] for s in m[i])
            for i, t in enumerate("abcd")}


def _concat(*alns):
    return {k: "".join(a[k] for a in alns) for k in alns[0]}


def test_no_merge_ranks_each_subset():
    aln = _concat(_sim(0, 30), _sim(1, 30))
    res = partition_finder(
        TREE4, aln, {"p1": range(0, 30), "p2": range(30, 60)},
        candidates=["JC69", "K80"], merge=False, max_steps=60, device="cpu",
    )
    assert len(res["scheme"]) == 2
    assert {r["name"] for r in res["scheme"]} == {"p1", "p2"}
    for r in res["scheme"]:
        assert r["model"] in ("JC69", "K80")
        assert r["k"] > 0 and np.isfinite(r["loglik"])
    assert res["n_rounds"] == 0


def test_identical_subsets_always_merge_as_jax_does():
    """Two subsets with literally identical columns: the merged subset has
    the same MLE (logL exactly additive) but HALF the branch-length
    parameters, so any penalized criterion merges them; the JAX package
    picks the same scheme."""
    a = _sim(2, 40)
    aln = _concat(a, a)
    kw = dict(candidates=["JC69"], criterion="bic", max_steps=80)
    subsets = {"x": range(0, 40), "y": range(40, 80)}
    res = partition_finder(TREE4, aln, subsets, device="cpu", **kw)
    assert len(res["scheme"]) == 1
    (row,) = res["scheme"]
    assert sorted(res["merged_from"][row["name"]]) == ["x", "y"]
    assert row["name"] == "x+y"
    assert len(row["columns"]) == 80
    want = jax_partition_finder(TREE4, aln, subsets, **kw)
    assert res["merged_from"] == want["merged_from"]
    assert (res["n_rounds"], res["criterion"]) == (want["n_rounds"],
                                                   want["criterion"])
    for got, ref in zip(res["scheme"], want["scheme"]):
        assert set(got) == set(ref)
        for key in ("name", "columns", "model", "k"):
            assert got[key] == ref[key], key
        assert abs(got["loglik"] - ref["loglik"]) < 1e-5
        assert got["bic"] == pytest.approx(ref["bic"], abs=1e-4)
    assert res["score"] == pytest.approx(want["score"], abs=1e-4)


def test_validation_errors():
    aln = _sim(3, 20)
    with pytest.raises(ValueError, match="out-of-range"):
        partition_finder(TREE4, aln, {"p": [0, 25]}, candidates=["JC69"],
                         device="cpu")
    with pytest.raises(ValueError, match="no subsets"):
        partition_finder(TREE4, aln, {}, device="cpu")
    bad = dict(aln)
    bad["a"] = bad["a"][:-1]
    with pytest.raises(ValueError, match="unequal"):
        partition_finder(TREE4, bad, {"p": [0, 1]}, candidates=["JC69"],
                         device="cpu")


def test_scheme_score_matches_rows_and_jax():
    aln = _concat(_sim(4, 25), _sim(5, 25, model="biased"))
    kw = dict(candidates=["JC69", "HKY85"], criterion="aic", merge=False,
              max_steps=60)
    subsets = {"p1": range(0, 25), "p2": range(25, 50)}
    res = partition_finder(TREE4, aln, subsets, device="cpu", **kw)
    k = sum(r["k"] for r in res["scheme"])
    ll = sum(r["loglik"] for r in res["scheme"])
    assert res["score"] == pytest.approx(2 * k - 2 * ll, rel=1e-12)
    want = jax_partition_finder(TREE4, aln, subsets, **kw)
    assert [(r["name"], r["model"], r["k"]) for r in res["scheme"]] == [
        (r["name"], r["model"], r["k"]) for r in want["scheme"]]
