"""Port parity, protein models: LG and WAG (20 states) in the PyTorch port
against the JAX package, on BASELINE config 4's problem
(``tests/test_likelihood.py::test_config4_protein_gamma_32taxon``: 32 taxa,
80 random amino-acid sites, +G4), with non-default frequencies (the "+F"
parameter) carried across by ``convert.params_from_jax``.

Both engines get the same CompressedAlignment arrays. Tolerances: the f64
port (``pruner="torch"``) against the JAX f64 XLA engine, 1e-10 relative on
logL and 1e-10 x max|g| per gradient leaf (the JAX eigensystem carries a
~1e-13 tie-break jitter); the f32 walk (``pruner="cuda"``, its plain
versions on the CPU) against the same f64 reference, 1e-6 relative on logL
(the BASELINE limit), 1e-5 relative per site and 5e-4 x max|g| per
gradient leaf, as the JAX package holds its own f32 gradients. The per-site
bound is wider than at 4 states because the precision plan reconstructs
P(t) from 20 spectral modes in float32: the JAX f32 engine itself sits
4.6e-6 relative per site from its f64 engine on this problem, while the
pattern sum stays within 1e-7.
"""
import jax
import numpy as np
import pytest
import torch

from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu.likelihood import LikelihoodEngine as JaxEngine
from phylo_utils_tpu.trees import random_tree
from phylo_utils_tpu_torch import io as tio
from phylo_utils_tpu_torch import models as tmodels
from phylo_utils_tpu_torch import trees as ttrees
from phylo_utils_tpu_torch.convert import flatten_params, params_from_jax
from phylo_utils_tpu_torch.data import LG_FREQS, LG_RATES
from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
from phylo_utils_tpu_torch.ops import cuda_pruning
from phylo_utils_tpu_torch.ops.pmatrix import transition_matrices

from torch_threads import one_thread  # noqa: F401

AMINO = "ARNDCQEGHILKMFPSTWYV"


def _flat(grads):
    return dict(zip(*flatten_params(grads)))


@pytest.fixture(scope="module", params=["LG", "WAG"])
def config4(request):
    """32 taxa x 80 sites (the JAX test's tree and alignment recipe), +G4,
    alpha 0.9, frequencies drawn away from the model's."""
    name = request.param
    jtree = random_tree(32, seed=13, mean_brlen=0.2)
    rng = np.random.default_rng(4)
    aln = {n: "".join(rng.choice(list(AMINO * 8), size=80))
           for n in jtree.leaf_names}
    j64 = JaxEngine(jtree, aln, getattr(jmodels, name), ncat=4,
                    dtype="float64")
    freqs = np.random.default_rng(7).dirichlet(np.full(20, 5.0))
    p = {"model": {"freqs": freqs}, "alpha": 0.9}
    full = jax.tree.map(np.asarray, j64._full_params(p))
    ca = j64._compressed
    return dict(
        name=name, j64=j64, p=p, full=full,
        tree=ttrees.Tree(jtree.names, jtree.parent, jtree.lengths,
                         jtree.children, jtree.n_leaves),
        ca=tio.CompressedAlignment(ca.names, np.asarray(ca.partials),
                                   np.asarray(ca.weights),
                                   np.asarray(ca.site_to_pattern)))


def _port(config4, **kw):
    return LikelihoodEngine(config4["tree"], config4["ca"],
                            tmodels.get_model(config4["name"]), ncat=4,
                            device="cpu", **kw)


@pytest.mark.parametrize("pruner,dtype,tol,site_tol,grad_tol", [
    ("torch", torch.float64, 1e-10, 1e-10, 1e-10),
    ("cuda", torch.float32, 1e-6, 1e-5, 5e-4),
])
def test_protein_engine_matches_jax_xla(config4, pruner, dtype, tol,
                                        site_tol, grad_tol):
    """logL, sitewise logL and value_and_grad against the JAX f64 XLA
    engine; the 20 frequencies come across through params_from_jax."""
    j64 = config4["j64"]
    params = params_from_jax(config4["full"])
    assert params["model"]["freqs"].shape == (20,)
    port = _port(config4, dtype=dtype, pruner=pruner)
    want = j64.loglikelihood(config4["p"])
    before = cuda_pruning.LAUNCHES
    got = port.loglikelihood(params)
    assert cuda_pruning.LAUNCHES == before       # CPU tensors: plain walks
    assert abs(got - want) / abs(want) < tol
    np.testing.assert_allclose(port.sitewise_loglikelihoods(params),
                               j64.sitewise_loglikelihoods(config4["p"]),
                               rtol=site_tol, atol=0)
    lj, gj = j64.value_and_grad(config4["p"])
    lt, gt = port.value_and_grad(params)
    assert abs(float(lt) - float(lj)) < tol * abs(float(lj))
    want_g = _flat(jax.tree.map(np.asarray, gj))
    got_g = _flat(gt)
    assert set(got_g) == set(want_g)
    for path, g in got_g.items():
        w = want_g[path]
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0,
                                   atol=grad_tol * np.abs(w).max(),
                                   err_msg=str(path))


def test_protein_eigensystem_at_20_states():
    """The host-f64 eigh path of ``models/base.py`` at 20 states: V diag(l)
    V^-1 rebuilds Q, P(t) rows sum to 1, and P(t) matches the JAX model's
    (1e-12 absolute; the JAX f64 eigensystem carries its tie-break
    jitter)."""
    freqs = np.random.default_rng(2).dirichlet(np.full(20, 3.0))
    for name in ("LG", "WAG"):
        eig = tmodels.get_model(name).eigen({"freqs": freqs})
        assert eig.evecs.shape == (20, 20)
        q = eig.evecs @ torch.diag(eig.evals) @ eig.ivecs
        np.testing.assert_allclose(q.numpy(), eig.q.numpy(), rtol=0,
                                   atol=1e-12)
        assert abs(float(eig.evals.max())) < 1e-12     # one zero mode
        t = torch.tensor([[0.01], [0.3], [2.5]], dtype=torch.float64)
        p = transition_matrices(eig, t)
        np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, rtol=0,
                                   atol=1e-12)
        jeig = getattr(jmodels, name).eigen({"freqs": freqs})
        from phylo_utils_tpu.ops.pmatrix import transition_matrices as jtm
        want = np.asarray(jtm(jeig, np.asarray(t)))
        np.testing.assert_allclose(p.numpy(), want, rtol=0, atol=1e-12)


def _paml_text(rates, freqs):
    rows = [" ".join(f"{rates[i, j]:.6f}" for j in range(i))
            for i in range(1, 20)]
    return ("\n".join(rows) + "\n\n" + " ".join(f"{f:.6f}" for f in freqs)
            + "\n\nLe & Gascuel 2008\n")


def test_empirical_model_from_dat_matches_jax(tmp_path):
    """LG's constants written out as PAML text, read by both packages: the
    same model (Q to 1e-14), from a path or the text itself, and within the
    text's six decimals of the built-in LG."""
    from phylo_utils_tpu.models import empirical_model_from_dat as jdat

    text = _paml_text(LG_RATES, LG_FREQS)
    path = tmp_path / "lg.dat"
    path.write_text(text)
    port = tmodels.empirical_model_from_dat(str(path))
    want = jdat(str(path))
    assert port.name == want.name == "lg"
    assert port.n_states == 20 and port.alphabet == "protein"
    np.testing.assert_allclose(port.param_defaults["freqs"],
                               want.param_defaults["freqs"], rtol=1e-15)
    np.testing.assert_allclose(port.eigen().q.numpy(),
                               np.asarray(want.eigen().q), rtol=0,
                               atol=1e-14)
    from_text = tmodels.empirical_model_from_dat(text, name="lg_text")
    np.testing.assert_allclose(from_text.eigen().q.numpy(),
                               port.eigen().q.numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(port.eigen().q.numpy(),
                               tmodels.LG.eigen().q.numpy(), rtol=0,
                               atol=1e-5)   # the text keeps 6 decimals
    with pytest.raises(FileNotFoundError):
        tmodels.empirical_model_from_dat("missing.dat")
    with pytest.raises(ValueError, match="need 210"):
        tmodels.empirical_model_from_dat("0.5 0.7 1.0")


def test_parse_model_spec_protein():
    from phylo_utils_tpu.models import parse_model_spec as jparse

    for spec in ("LG+G4+F", "wag+I+G8", "LG"):
        got = tmodels.parse_model_spec(spec)
        want = jparse(spec)
        assert got[0].name == want[0].name and got[1:] == want[1:]
    model, ncat, inv, emp, rate_model = tmodels.parse_model_spec("LG+G4+F")
    assert (model is tmodels.LG, ncat, inv, emp, rate_model) == (
        True, 4, False, True, "gamma")
