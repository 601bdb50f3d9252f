"""Port parity, site sharding through the application layer: mirrors
``tests/test_sharding_app.py`` (partitioned logL, gradient and fit,
topology-set scoring, the batched branch-length optimizer, the chunked
optimizer and the NNI search) on the same trees, alignments and
tolerances.

The port shards over ``make_mesh(["cpu"] * 8)``; the JAX side runs on the 8
virtual CPU devices of ``tests/conftest.py``. Each case holds the sharded
port against the unsharded port at the JAX test's tolerance for its pair,
and against JAX's sharded engines: at the same tolerance where that is
looser than the packages' f64 difference (~1e-12), else at the repo's
cross-package bound of 1e-10 relative (``CROSS``). The partitioned fit is
held to the unsharded port's fit (the packages' L-BFGS differ).
"""
import jax
import numpy as np
import pytest
import torch

from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu.batched import TopologySetEngine as JaxTSE
from phylo_utils_tpu.batched import chunked_brlen_optimize as jax_chunked
from phylo_utils_tpu.batched import nni_hill_climb as jax_hill_climb
from phylo_utils_tpu.batched import optimize_branch_lengths as jax_optimize
from phylo_utils_tpu.io import parse_newick as j_parse_newick
from phylo_utils_tpu.io import write_newick as j_write_newick
from phylo_utils_tpu.parallel import SiteSharding as JaxSharding
from phylo_utils_tpu.parallel import make_mesh as jax_make_mesh
from phylo_utils_tpu.partition import Partition as JaxPartition
from phylo_utils_tpu.partition import PartitionedEngine as JaxPartitioned
from phylo_utils_tpu_torch import models
from phylo_utils_tpu_torch.batched import (
    TopologySetEngine,
    chunked_brlen_optimize,
    nni_hill_climb,
    optimize_branch_lengths,
)
from phylo_utils_tpu_torch.convert import flatten_params
from phylo_utils_tpu_torch.io import parse_newick, write_newick
from phylo_utils_tpu_torch.optimize import fit
from phylo_utils_tpu_torch.parallel import SiteSharding, make_mesh
from phylo_utils_tpu_torch.partition import Partition, PartitionedEngine
from phylo_utils_tpu_torch.trees import (
    nni_neighbors,
    random_tree,
    robinson_foulds,
)

from torch_threads import one_thread  # noqa: F401

CROSS = 1e-10       # port against JAX, f64


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) == 8, "the JAX side runs on the 8-device mesh"
    return jax_make_mesh()


@pytest.fixture(scope="module")
def tree():
    return random_tree(10, seed=1)


def _aln(tree, sites, seed=0):
    rng = np.random.default_rng(seed)
    return {n: "".join(rng.choice(list("ACGT"), size=sites))
            for n in tree.leaf_names}


def _jax(tree):
    return j_parse_newick(write_newick(tree))


def _flat(grads):
    names, leaves = flatten_params(grads)
    return {"/".join(n): torch.as_tensor(np.asarray(v)).to(
        "cpu", torch.float64).numpy() for n, v in zip(names, leaves)}


def _jflat(grads, prefix=""):
    out = {}
    for k, v in grads.items():
        if isinstance(v, dict):
            out.update(_jflat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float64)
    return out


def _assert_grads(got, want, **tol):
    for k in want:
        if k in got:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)
        else:       # a parameter-free model's empty dict
            assert want[k].size == 0, k


def test_partitioned_sharded_logl_and_grad(mesh, jax_mesh, tree):
    alns = [_aln(tree, 83, seed=2), _aln(tree, 61, seed=3)]
    parts = [Partition("locus1", alns[0], models.GTR, ncat=2),
             Partition("locus2", alns[1], models.HKY85)]
    jparts = [JaxPartition("locus1", alns[0], jmodels.GTR, ncat=2),
              JaxPartition("locus2", alns[1], jmodels.HKY85)]
    single = PartitionedEngine(tree, parts, device="cpu")
    sharded = PartitionedEngine(tree, parts, sharding=SiteSharding(mesh),
                                device="cpu")
    ref = JaxPartitioned(_jax(tree), jparts, sharding=JaxSharding(jax_mesh))
    ll_d = sharded.loglikelihood()
    assert ll_d == pytest.approx(single.loglikelihood(), rel=1e-12,
                                 abs=1e-9)
    assert ll_d == pytest.approx(ref.loglikelihood(), rel=CROSS)
    per_s, per_d = single.partition_loglikelihoods(), \
        sharded.partition_loglikelihoods()
    per_j = ref.partition_loglikelihoods()
    for k in per_s:
        assert per_d[k] == pytest.approx(per_s[k], rel=1e-10)
        assert per_d[k] == pytest.approx(per_j[k], rel=1e-10)
    g_d = _flat(sharded.gradient())
    _assert_grads(g_d, _flat(single.gradient()), rtol=1e-8, atol=1e-10)
    _assert_grads(g_d, _jflat(ref.gradient()), rtol=1e-8, atol=1e-10)


def test_partitioned_sharded_fit_runs(mesh, jax_mesh, tree):
    alns = [_aln(tree, 40, seed=4), _aln(tree, 56, seed=5)]
    parts = [Partition("a", alns[0], models.JC69),
             Partition("b", alns[1], models.K80)]
    sharded = PartitionedEngine(tree, parts, sharding=SiteSharding(mesh),
                                device="cpu")
    single = PartitionedEngine(tree, parts, device="cpu")
    ref = JaxPartitioned(_jax(tree), [
        JaxPartition("a", alns[0], jmodels.JC69),
        JaxPartition("b", alns[1], jmodels.K80)],
        sharding=JaxSharding(jax_mesh))
    res_d = fit(sharded, max_steps=4, steps_per_call=2)
    res_s = fit(single, max_steps=4, steps_per_call=2)
    assert np.isfinite(res_d.loglik)
    assert res_d.loglik == pytest.approx(res_s.loglik, rel=1e-6)
    # the fit's start is the JAX sharded engine's logL
    assert res_d.trace[0] == pytest.approx(ref.loglikelihood(), rel=CROSS)


def test_topology_set_sharded_matches(mesh, jax_mesh, tree):
    aln = _aln(tree, 75, seed=6)    # 75 patterns: padded to 80
    cands = [tree] + nni_neighbors(tree)[:5]
    single = TopologySetEngine(cands, aln, models.HKY85, ncat=2,
                               device="cpu")
    sharded = TopologySetEngine(cands, aln, models.HKY85, ncat=2,
                                sharding=SiteSharding(mesh), device="cpu")
    ref = JaxTSE([_jax(t) for t in cands], aln, jmodels.HKY85, ncat=2,
                 sharding=JaxSharding(jax_mesh))
    lls = sharded.loglikelihoods()
    np.testing.assert_allclose(lls, single.loglikelihoods(), rtol=1e-10,
                               atol=1e-9)
    np.testing.assert_allclose(lls, ref.loglikelihoods(), rtol=CROSS,
                               atol=1e-9)
    sw = sharded.sitewise_loglikelihoods()
    np.testing.assert_allclose(sw, single.sitewise_loglikelihoods(),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(sw, ref.sitewise_loglikelihoods(),
                               rtol=1e-8, atol=1e-10)
    g_d = _flat(sharded.gradients())
    _assert_grads(g_d, _flat(single.gradients()), rtol=1e-7, atol=1e-9)
    _assert_grads(g_d, _jflat(ref.gradients()), rtol=1e-7, atol=1e-9)


def test_topology_set_schedule_copied_once_per_shard_device(tree):
    """A shard on another device walks copies of the candidates' schedule
    and leaf permutation, made once a device (the meta device stands in
    for a second card); the engine's own device takes the originals."""
    cands = [tree] + nni_neighbors(tree)[:3]
    eng = TopologySetEngine(cands, _aln(tree, 20), models.HKY85, ncat=2,
                            device="cpu")
    meta = torch.device("meta")
    sched, perm = eng._walk_arrays(meta)
    assert eng._walk_arrays(meta)[1] is perm
    own_sched, own_perm = eng._walk_arrays(torch.device("cpu"))
    assert own_sched is eng._sched and own_perm is eng._leaf_perm
    pairs = [(perm, eng._leaf_perm),
             (sched["child_rows"], eng._sched["child_rows"]),
             (sched["mask"], eng._sched["mask"])]
    assert len(sched["levels"]) == len(eng._sched["levels"])
    for got, want in zip(sched["levels"], eng._sched["levels"]):
        assert len(got) == len(want) == 4
        pairs += list(zip(got, want))
    for got, want in pairs:
        assert got.device == meta and got.is_contiguous()
        assert (got.shape, got.dtype) == (want.shape, want.dtype)


def test_sharded_brlen_optimize_matches(mesh, jax_mesh, tree):
    aln = _aln(tree, 52, seed=7)
    cands = [tree] + nni_neighbors(tree)[:3]
    single = TopologySetEngine(cands, aln, models.K80, device="cpu")
    sharded = TopologySetEngine(cands, aln, models.K80,
                                sharding=SiteSharding(mesh), device="cpu")
    ref = JaxTSE([_jax(t) for t in cands], aln, jmodels.K80,
                 sharding=JaxSharding(jax_mesh))
    lls_d, bls_d = optimize_branch_lengths(sharded, steps=10)
    lls_s, bls_s = optimize_branch_lengths(single, steps=10)
    lls_j, bls_j = jax_optimize(ref, steps=10)
    np.testing.assert_allclose(lls_d, lls_s, rtol=1e-9)
    np.testing.assert_allclose(bls_d, bls_s, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(lls_d, np.asarray(lls_j), rtol=1e-9)
    np.testing.assert_allclose(bls_d, np.asarray(bls_j), rtol=1e-6,
                               atol=1e-9)


def test_sharded_chunked_and_search(mesh, jax_mesh, tree):
    aln = _aln(tree, 44, seed=8)
    cands = [tree] + nni_neighbors(tree)[:4]
    lls_s, _, sw_s, _ = chunked_brlen_optimize(
        cands, aln, models.JC69, steps=8, batch_chunk=2, device="cpu")
    lls_d, _, sw_d, _ = chunked_brlen_optimize(
        cands, aln, models.JC69, steps=8, batch_chunk=2, device="cpu",
        sharding=SiteSharding(mesh))
    lls_j, _, sw_j, _ = jax_chunked(
        [_jax(t) for t in cands], aln, jmodels.JC69, steps=8,
        batch_chunk=2, sharding=JaxSharding(jax_mesh))
    np.testing.assert_allclose(lls_d, lls_s, rtol=1e-9)
    np.testing.assert_allclose(sw_d, sw_s, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(lls_d, np.asarray(lls_j), rtol=1e-9)
    np.testing.assert_allclose(sw_d, np.asarray(sw_j), rtol=1e-7, atol=1e-10)

    start = nni_neighbors(tree)[0]
    t_s, ll_s, r_s = nni_hill_climb(start, aln, models.JC69, brlen_steps=8,
                                    max_rounds=2, device="cpu")
    t_d, ll_d, r_d = nni_hill_climb(start, aln, models.JC69, brlen_steps=8,
                                    max_rounds=2, device="cpu",
                                    sharding=SiteSharding(mesh))
    t_j, ll_j, r_j = jax_hill_climb(_jax(start), aln, jmodels.JC69,
                                    brlen_steps=8, max_rounds=2,
                                    sharding=JaxSharding(jax_mesh))
    assert r_s == r_d == r_j
    assert ll_d == pytest.approx(ll_s, rel=1e-8)
    assert ll_d == pytest.approx(ll_j, rel=1e-8)
    assert robinson_foulds(t_d, parse_newick(j_write_newick(t_j))) == 0.0
    assert robinson_foulds(t_d, t_s) == 0.0
