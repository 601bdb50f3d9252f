"""Port parity, site sharding (``phylo_utils_tpu_torch.parallel``): mirrors
``tests/test_sharding.py`` on the same trees, alignments and tolerances.

The port shards over ``make_mesh(["cpu"] * 8)``, eight shards on the CPU,
as the JAX tests run on the 8 virtual CPU devices of ``tests/conftest.py``;
under ``pruner="cuda"`` each shard runs the kernels' plain versions. Each
case holds the sharded port against the unsharded port at the JAX test's
tolerance for its sharded/unsharded pair (f64 logL 1e-12 relative,
gradients ``rtol=1e-8``, sitewise ``rtol=1e-10``; f32 logL 1e-6 relative,
gradients ``rtol=1e-4``), and against JAX's sharded engine on its mesh: f64
logL and sitewise values at the repo's cross-package bound of 1e-10
relative (the two packages' P(t) and gamma rates differ at ~1e-12, which
JAX's 1e-12 leaves no room for), gradients at ``rtol=1e-8``; the f32 port at
the f32 bound of 1e-6.
"""
import os
import socket

import numpy as np
import pytest
import torch

from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu.io import parse_newick as j_parse_newick
from phylo_utils_tpu.likelihood import LikelihoodEngine as JaxEngine
from phylo_utils_tpu.parallel import SiteSharding as JaxSharding
from phylo_utils_tpu.parallel import make_mesh as jax_make_mesh
from phylo_utils_tpu_torch import models
from phylo_utils_tpu_torch.convert import flatten_params
from phylo_utils_tpu_torch.io import write_newick
from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
from phylo_utils_tpu_torch.parallel import (
    SiteSharding,
    distributed_init,
    make_mesh,
)
from phylo_utils_tpu_torch.parallel.dryrun import dryrun
from phylo_utils_tpu_torch.trees import random_tree

from torch_threads import one_thread  # noqa: F401

CROSS = 1e-10       # port against JAX, f64


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def jax_mesh():
    import jax

    assert len(jax.devices()) == 8, "the JAX side runs on the 8-device mesh"
    return jax_make_mesh()


def _aln(tree, sites, seed=0):
    rng = np.random.default_rng(seed)
    return {n: "".join(rng.choice(list("ACGT"), size=sites))
            for n in tree.leaf_names}


def _jax(tree):
    return j_parse_newick(write_newick(tree))


def _flat(grads):
    """Gradient leaves in sorted key order, float64 numpy."""
    names, leaves = flatten_params(grads)
    return {"/".join(n): torch.as_tensor(np.asarray(v)).to(
        "cpu", torch.float64).numpy() for n, v in zip(names, leaves)}


def _jflat(grads):
    out = {}
    for k, v in grads.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": np.asarray(vv, np.float64)
                        for kk, vv in v.items()})
        else:
            out[k] = np.asarray(v, np.float64)
    return out


def _assert_grads(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def test_sharded_logl_equals_unsharded(mesh, jax_mesh):
    tree = random_tree(16, seed=2)
    aln = _aln(tree, 97, seed=3)   # 97 patterns: not divisible by 8
    single = LikelihoodEngine(tree, aln, models.GTR, ncat=4, device="cpu")
    sharded = LikelihoodEngine(tree, aln, models.GTR, ncat=4, device="cpu",
                               sharding=SiteSharding(mesh))
    ref = JaxEngine(_jax(tree), aln, jmodels.GTR, ncat=4,
                    sharding=JaxSharding(jax_mesh))
    ll_d = sharded.loglikelihood()
    assert sharded._leaf_partials.shape[1] == 104
    assert ll_d == pytest.approx(single.loglikelihood(), rel=1e-12,
                                 abs=1e-9)
    assert ll_d == pytest.approx(ref.loglikelihood(), rel=CROSS)


def test_sharded_gradient_equals_unsharded(mesh, jax_mesh):
    tree = random_tree(8, seed=5)
    aln = _aln(tree, 50, seed=6)
    single = LikelihoodEngine(tree, aln, models.HKY85, ncat=2, device="cpu")
    sharded = LikelihoodEngine(tree, aln, models.HKY85, ncat=2,
                               device="cpu", sharding=SiteSharding(mesh))
    ref = JaxEngine(_jax(tree), aln, jmodels.HKY85, ncat=2,
                    sharding=JaxSharding(jax_mesh))
    g_d = _flat(sharded.gradient())
    _assert_grads(g_d, _flat(single.gradient()), rtol=1e-8)
    _assert_grads(g_d, _jflat(ref.gradient()), rtol=1e-8)


def test_sharding_actually_distributes(mesh, jax_mesh):
    """Eight contiguous shards of P/8 patterns, one per mesh entry, as
    JAX's eight addressable shards."""
    tree = random_tree(8, seed=5)
    aln = _aln(tree, 64, seed=6)
    engine = LikelihoodEngine(tree, aln, models.JC69, device="cpu",
                              sharding=SiteSharding(mesh))
    ref = JaxEngine(_jax(tree), aln, jmodels.JC69,
                    sharding=JaxSharding(jax_mesh))
    lp, w = engine._leaf_partials, engine._weights
    assert len(lp.shards) == len(w.shards) == 8
    assert tuple(lp.shape) == tuple(ref._leaf_partials.shape)
    want = {tuple(s.data.shape) for s in ref._leaf_partials.addressable_shards}
    assert {tuple(t.shape) for t in lp.shards} == want
    assert all(t.is_contiguous() and t.device.type == "cpu"
               for t in lp.shards + w.shards)
    # in pattern order: the shards concatenate to the unsharded engine's
    # partials, padded with all-ones columns (JAX stores its patterns in
    # another order, ROADMAP C)
    single = LikelihoodEngine(tree, aln, models.JC69, device="cpu")
    whole = lp.full().numpy()
    n = single._leaf_partials.shape[1]
    np.testing.assert_array_equal(whole[:, :n], single._leaf_partials.numpy())
    assert (whole[:, n:] == 1.0).all() and (w.full()[n:] == 0).all()
    assert float(w.sum()) == float(np.asarray(ref._weights).sum()) == 64


def test_sharded_pinv_and_sitewise(mesh, jax_mesh):
    tree = random_tree(8, seed=9)
    aln = _aln(tree, 40, seed=10)
    kw = dict(ncat=2, invariant_sites=True)
    single = LikelihoodEngine(tree, aln, models.GTR, device="cpu", **kw)
    sharded = LikelihoodEngine(tree, aln, models.GTR, device="cpu",
                               sharding=SiteSharding(mesh), **kw)
    ref = JaxEngine(_jax(tree), aln, jmodels.GTR,
                    sharding=JaxSharding(jax_mesh), **kw)
    p = {"alpha": 0.7, "pinv": 0.15}
    ll_d = sharded.loglikelihood(p)
    assert ll_d == pytest.approx(single.loglikelihood(p), rel=1e-12)
    assert ll_d == pytest.approx(ref.loglikelihood(p), rel=CROSS)
    sw_d = sharded.sitewise_loglikelihoods(p)
    np.testing.assert_allclose(sw_d, single.sitewise_loglikelihoods(p),
                               rtol=1e-10)
    np.testing.assert_allclose(sw_d, ref.sitewise_loglikelihoods(p),
                               rtol=CROSS)
    # the bootstrap never draws a padded pattern: the unsharded replicates
    np.testing.assert_array_equal(sharded.bootstrap_loglikelihoods(4, p),
                                  single.bootstrap_loglikelihoods(4, p))


def test_sharded_cuda_pruner_matches_unsharded(mesh, jax_mesh):
    """``pruner="cuda"`` in f32 on eight shards (the kernels' plain
    versions on the CPU): logL to 1e-6 relative and the gradient to
    ``rtol=1e-4`` of the unsharded f32 port, and the logL to 1e-6 of JAX's
    sharded f64 engine."""
    tree = random_tree(12, seed=20)
    aln = _aln(tree, 96, seed=21)
    kw = dict(ncat=2, pruner="cuda", dtype="float32", device="cpu")
    single = LikelihoodEngine(tree, aln, models.GTR, **kw)
    sharded = LikelihoodEngine(tree, aln, models.GTR,
                               sharding=SiteSharding(mesh), **kw)
    ref = JaxEngine(_jax(tree), aln, jmodels.GTR, ncat=2,
                    sharding=JaxSharding(jax_mesh))
    ll_d = sharded.loglikelihood()
    assert ll_d == pytest.approx(single.loglikelihood(), rel=1e-6)
    assert ll_d == pytest.approx(ref.loglikelihood(), rel=1e-6)
    g, gs = sharded.gradient(), single.gradient()
    np.testing.assert_allclose(g["branch_lengths"].numpy(),
                               gs["branch_lengths"].numpy(), rtol=1e-4)


def test_dryrun_on_eight_cpu_shards():
    out = dryrun(8, device="cpu")
    assert out["n_shards"] == 8
    assert all(np.isfinite(out[k]).all()
               for k in ("torch", "cuda", "looped", "stacked"))


def test_make_mesh_and_distributed_init():
    """``make_mesh()`` takes the cards and raises without one unless the
    devices are named; ``distributed_init`` runs standalone with no
    rendezvous configured, and names the rendezvous and the rank when one
    fails."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="name the devices"):
            make_mesh()
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh(["cuda:0"])
    mesh = make_mesh(["cpu"] * 3)
    assert mesh.size == 3 and mesh.axis_names == ("sites",)
    with pytest.raises(ValueError, match="no axis"):
        SiteSharding(mesh, axis="taxa")
    sh = SiteSharding(mesh, tile=2)
    assert (sh.n_devices, sh.padded_size(7), sh.padded_size(1)) == (3, 12, 6)
    env = {k: os.environ.pop(k) for k in ("MASTER_ADDR", "MASTER_PORT",
                                          "WORLD_SIZE", "RANK")
           if k in os.environ}
    try:
        distributed_init()
        assert not torch.distributed.is_initialized()
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        with pytest.raises(RuntimeError, match=rf"127\.0\.0\.1:{port}.*"
                           r"rank 1/2"):
            distributed_init(init_method=f"tcp://127.0.0.1:{port}",
                             world_size=2, rank=1, backend="gloo", timeout=2)
        assert not torch.distributed.is_initialized()
    finally:
        os.environ.update(env)
