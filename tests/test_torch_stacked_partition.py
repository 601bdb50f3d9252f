"""Port parity, stacked partitions: ``phylo_utils_tpu_torch.partition.
StackedPartitionedEngine`` mirrors ``tests/test_stacked_partition.py`` and
is held to the port's ``PartitionedEngine`` and to the JAX package's
engines on the same loci.

Tolerances: against the port's general engine, as the JAX test holds its
own pair, logL to 1e-12 relative and gradients to ``rtol=1e-8,
atol=1e-10`` (float64, ``pruner="torch"``); against the JAX package, f64
total and per-partition logL to 1e-10 relative, gradients to ``rtol=1e-8,
atol=1e-10``, fitted logL to 1e-8 relative against the port's general
engine's fit (same optimizer, same steps). The one JAX Pallas case (the
stacked engine under ``pruner="pallas"``, interpret mode) holds the port's
``pruner="cuda"`` (the kernels' plain versions on the CPU) at JAX's own
bounds for that pair: 1e-6 relative and ``rtol=1e-4, atol=1e-6``.
"""
import jax
import numpy as np
import pytest
import torch

from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu.partition import Partition as JaxPartition
from phylo_utils_tpu.partition import PartitionedEngine as JaxPartitioned
from phylo_utils_tpu.partition import (
    StackedPartitionedEngine as JaxStacked,
)
from phylo_utils_tpu.simulate import simulate_alignment
from phylo_utils_tpu.trees import random_tree
from phylo_utils_tpu_torch import models
from phylo_utils_tpu_torch.convert import flatten_params, params_to_numpy
from phylo_utils_tpu_torch.ops import cuda_pruning
from phylo_utils_tpu_torch.optimize import fit
from phylo_utils_tpu_torch.partition import (
    Partition,
    PartitionedEngine,
    StackedPartitionedEngine,
)
from phylo_utils_tpu_torch.trees import Tree

from torch_threads import one_thread  # noqa: F401

PARAMS = {
    "partition_rates": [0.5, 1.5, 2.0],
    "partitions": {
        "locus1": {"model": {"freqs": [0.4, 0.2, 0.2, 0.2]}, "alpha": 0.7},
    },
}


def _port_tree(jtree):
    return Tree(jtree.names, jtree.parent, jtree.lengths, jtree.children,
                jtree.n_leaves)


def _by_path(tree) -> dict:
    """{key path: float64 array} of a nested parameter dict (either
    package's), whatever its key order."""
    names, leaves = flatten_params(params_to_numpy(
        jax.tree.map(np.asarray, tree) if not _is_port(tree) else tree))
    return dict(zip(names, leaves))


def _is_port(tree) -> bool:
    return any(isinstance(v, torch.Tensor) for v in flatten_params(tree)[1])


def _assert_grads_close(got, want, rtol=1e-8, atol=1e-10):
    got, want = _by_path(got), _by_path(want)
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=rtol, atol=atol,
                                   err_msg=str(path))


@pytest.fixture(scope="module")
def setup():
    """8 taxa, 3 GTR+G2 loci of 60, 80 and 100 sites simulated on the
    tree by the JAX package."""
    jtree = random_tree(8, seed=3)
    alns = [simulate_alignment(jax.random.PRNGKey(i), jtree, jmodels.GTR,
                               n_sites=60 + 20 * i, ncat=2)
            for i in range(3)]
    jparts = [JaxPartition(f"locus{i}", a, jmodels.GTR, ncat=2)
              for i, a in enumerate(alns)]
    parts = [Partition(f"locus{i}", a, models.GTR, ncat=2)
             for i, a in enumerate(alns)]
    return jtree, _port_tree(jtree), jparts, parts


def test_stacked_matches_general(setup):
    _, tree, _, parts = setup
    gen = PartitionedEngine(tree, parts, device="cpu")
    stk = StackedPartitionedEngine(tree, parts, device="cpu")
    assert stk.loglikelihood() == pytest.approx(gen.loglikelihood(),
                                                rel=1e-12)
    pg, ps = gen.partition_loglikelihoods(), stk.partition_loglikelihoods()
    for k in pg:
        assert ps[k] == pytest.approx(pg[k], rel=1e-10)
    _assert_grads_close(stk.gradient(), gen.gradient())


@pytest.fixture(scope="module")
def jax_at_params(setup):
    """The JAX package's general and stacked engines at PARAMS, built and
    evaluated once for both pruners' cases: the general engine's total,
    per-partition logL and gradient, the stacked engine's total."""
    jtree, _, jparts, _ = setup
    jgen = JaxPartitioned(jtree, jparts)
    return dict(total=jgen.loglikelihood(PARAMS),
                stacked=JaxStacked(jtree, jparts).loglikelihood(PARAMS),
                parts=jgen.partition_loglikelihoods(PARAMS),
                gradient=jgen.gradient(jgen._full_params(PARAMS)))


@pytest.mark.parametrize("pruner", ["torch", "cuda"])
def test_stacked_matches_jax_with_params_and_rates(setup, jax_at_params,
                                                   pruner):
    """The JAX package's general and stacked engines at PARAMS: f64
    totals, per-partition logL and the gradient (``pruner="cuda"`` in f32:
    the walks' plain versions, held to the f64 JAX engine at f32
    bounds)."""
    jtree, tree, jparts, parts = setup
    want = jax_at_params["total"]
    assert jax_at_params["stacked"] == pytest.approx(want, rel=1e-12)
    dtype = "float32" if pruner == "cuda" else None
    stk = StackedPartitionedEngine(tree, parts, device="cpu", pruner=pruner,
                                   dtype=dtype)
    rel, grad_tol = (1e-10, 1e-8) if pruner == "torch" else (1e-6, 1e-3)
    assert stk.loglikelihood(PARAMS) == pytest.approx(want, rel=rel)
    got_parts = stk.partition_loglikelihoods(PARAMS)
    for name, ll in jax_at_params["parts"].items():
        assert got_parts[name] == pytest.approx(ll, rel=rel)
    _assert_grads_close(stk.gradient(PARAMS), jax_at_params["gradient"],
                        rtol=grad_tol, atol=grad_tol * 1e-2)


def test_stacked_free_rates_and_invariant_sites(setup):
    """FreeRate (+R3) with +I loci, one stack against one engine a locus
    and against the JAX package's stacked engine."""
    jtree, tree, jparts, parts = setup
    kw = dict(ncat=3, invariant_sites=True, rate_model="free")
    jparts = [JaxPartition(p.name, p.alignment, jmodels.HKY85, **kw)
              for p in jparts]
    parts = [Partition(p.name, p.alignment, models.HKY85, **kw)
             for p in parts]
    params = {"partitions": {
        "locus0": {"rates": [0.2, 1.0, 2.5], "pinv": 0.1},
        "locus2": {"cat_weights": [0.5, 0.3, 0.2],
                   "model": {"kappa": 4.0}}}}
    stk = StackedPartitionedEngine(tree, parts, device="cpu")
    gen = PartitionedEngine(tree, parts, device="cpu")
    jstk = JaxStacked(jtree, jparts)
    assert stk.loglikelihood(params) == pytest.approx(
        gen.loglikelihood(params), rel=1e-12)
    assert stk.loglikelihood(params) == pytest.approx(
        jstk.loglikelihood(params), rel=1e-10)
    _assert_grads_close(stk.gradient(params), gen.gradient(params))
    _assert_grads_close(stk.gradient(params),
                        jstk._jit_grad(jstk._full_params(params),
                                       jstk._leaf_partials, jstk._weights))


def test_stacked_fit_matches_general(setup):
    _, tree, _, parts = setup
    rg = fit(PartitionedEngine(tree, parts, device="cpu"), max_steps=5,
             steps_per_call=5)
    rs = fit(StackedPartitionedEngine(tree, parts, device="cpu"),
             max_steps=5, steps_per_call=5)
    assert rs.loglik == pytest.approx(rg.loglik, rel=1e-8)


def test_stacked_rejects_heterogeneous(setup):
    """Loci of two model families are refused; a sharded stack (eight CPU
    shards, the (G, n_leaves, P, S) stack split along P) equals the
    unsharded stack: logL to 1e-12 relative, per locus to 1e-10, gradients
    to ``rtol=1e-8, atol=1e-10``."""
    from phylo_utils_tpu_torch.parallel import SiteSharding, make_mesh

    jtree = random_tree(6, seed=0)
    a = simulate_alignment(jax.random.PRNGKey(0), jtree, jmodels.JC69,
                           n_sites=60)
    het = [Partition("x", a, models.JC69), Partition("y", a, models.HKY85)]
    with pytest.raises(ValueError, match="share the model family"):
        StackedPartitionedEngine(_port_tree(jtree), het, device="cpu")
    _, tree, _, parts = setup
    stk = StackedPartitionedEngine(tree, parts, device="cpu")
    sharded = StackedPartitionedEngine(
        tree, parts, device="cpu",
        sharding=SiteSharding(make_mesh(["cpu"] * 8)))
    lp = sharded._leaf_partials
    assert len(lp.shards) == 8 and lp.axis == 2
    assert lp.shape[2] % 8 == 0 and lp.shape[2] >= stk._leaf_partials.shape[2]
    assert sharded.loglikelihood(PARAMS) == pytest.approx(
        stk.loglikelihood(PARAMS), rel=1e-12)
    ps, pd = (stk.partition_loglikelihoods(PARAMS),
              sharded.partition_loglikelihoods(PARAMS))
    for k in ps:
        assert pd[k] == pytest.approx(ps[k], rel=1e-10)
    _assert_grads_close(sharded.gradient(PARAMS), stk.gradient(PARAMS))


def test_stacked_walk_is_one_call(setup, monkeypatch):
    """Under ``pruner="cuda"`` the stack's value is one forward walk and its
    gradient one saveall and one reverse walk, over (G, ...) P, leaves and
    frequencies: not one walk a locus."""
    _, tree, _, parts = setup
    calls = []

    def counted(name):
        inner = getattr(cuda_pruning, name)

        def wrapper(p, leaves, *args, **kwargs):
            calls.append((name, tuple(p.shape), tuple(leaves.shape)))
            return inner(p, leaves, *args, **kwargs)
        return wrapper

    for name in ("forward_walk", "saveall_walk", "reverse_walk"):
        monkeypatch.setattr(cuda_pruning, name, counted(name))
    stk = StackedPartitionedEngine(tree, parts, device="cpu", pruner="cuda",
                                   dtype="float32")
    g, pmax = len(parts), stk._weights.shape[1]
    stk.loglikelihood(PARAMS)
    assert [c[0] for c in calls] == ["forward_walk"]
    assert calls[0][1][0] == g and calls[0][2] == (g, 8, pmax, 4)
    calls.clear()
    stk.value_and_grad(PARAMS)
    assert [c[0] for c in calls] == ["saveall_walk", "reverse_walk"]
    assert all(c[1][0] == g and c[2][0] == g for c in calls)


def test_stacked_pallas_pruner():
    """JAX's stacked engine under ``pruner="pallas"`` (the Pallas kernels
    in interpret mode, vmapped over the loci) against the port's stacked
    engine under ``pruner="cuda"`` (the kernels' plain versions, one walk
    over the stack): 6 taxa, 3 loci of at most 64 sites."""
    jtree = random_tree(6, seed=5)
    alns = [simulate_alignment(jax.random.PRNGKey(10 + i), jtree,
                               jmodels.GTR, n_sites=40 + 12 * i, ncat=2)
            for i in range(3)]
    jstk = JaxStacked(jtree, [JaxPartition(f"l{i}", a, jmodels.GTR, ncat=2)
                              for i, a in enumerate(alns)], pruner="pallas")
    stk = StackedPartitionedEngine(
        _port_tree(jtree), [Partition(f"l{i}", a, models.GTR, ncat=2)
                            for i, a in enumerate(alns)],
        device="cpu", pruner="cuda", dtype="float32")
    assert stk.loglikelihood() == pytest.approx(jstk.loglikelihood(),
                                                rel=1e-6)
    _assert_grads_close(stk.gradient(), jstk.gradient(), rtol=1e-4,
                        atol=1e-6)
