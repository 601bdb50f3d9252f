"""Port parity, node-height standard errors: ``clock.node_height_errors``
(the delta method over ``optimize.fisher_covariance`` and the exact
Jacobian of the height map) against the JAX package's at the port's fitted
strict clock, on 600 HKY85 sites simulated by the port on an ultrametric
6-taxon tree. Kept apart from ``tests/test_torch_clock.py``, so that the
test workers run the two side by side.

Tolerances: 1e-4 relative with ``pruner="torch"`` (the port's exact
Hessian with a frozen model, as JAX's); 1e-2 through the f32 walk
(``pruner="cuda"``, its plain versions on CPU tensors), whose Hessian is
central differences of the gradient. JAX's bootstrap of the root age is
not re-run.
"""
import pytest

from phylo_utils_tpu import clock as jclock
from phylo_utils_tpu import models as jmodels
from phylo_utils_tpu.io import parse_newick as j_parse_newick
from phylo_utils_tpu_torch import models
from phylo_utils_tpu_torch.clock import ClockEngine, node_height_errors
from phylo_utils_tpu_torch.convert import params_to_numpy
from phylo_utils_tpu_torch.io import parse_newick
from phylo_utils_tpu_torch.optimize import fit
from phylo_utils_tpu_torch.simulate import simulate_alignment

from jax_reference import jitted_hessian
from torch_threads import one_thread  # noqa: F401

T64 = dict(dtype="float64", device="cpu")
T32 = dict(dtype="float32", pruner="cuda", device="cpu")
ULTRA = ("(((a:0.1,b:0.1):0.1,(c:0.1,d:0.1):0.1):0.05,"
         "(e:0.2,f:0.2):0.05);")


@pytest.fixture(scope="module")
def ultra_case():
    tree = parse_newick(ULTRA)
    aln = simulate_alignment(0, tree, models.HKY85, 600,
                             params={"kappa": 3.0}, device="cpu")
    return tree, aln


@pytest.fixture(scope="module")
def height_errors(ultra_case):
    """A port fit of the strict clock, and JAX's node-height SEs at the
    fitted parameters (JAX's exact Hessian, under one ``jax.jit``), built
    once."""
    tree, aln = ultra_case
    ce = ClockEngine(tree, aln, models.HKY85, **T64)
    res = fit(ce, max_steps=100, patience=15)
    je = jclock.ClockEngine(j_parse_newick(ULTRA), aln, jmodels.HKY85,
                            dtype="float64")
    with jitted_hessian():
        want = jclock.node_height_errors(je, params_to_numpy(res.params))
    return res.params, want


@pytest.mark.parametrize("pruner", ["torch", "cuda"])
def test_node_height_errors_match_jax(ultra_case, height_errors, pruner):
    tree, aln = ultra_case
    params, want = height_errors
    ce = ClockEngine(tree, aln, models.HKY85,
                     **(T64 if pruner == "torch" else T32))
    se = node_height_errors(ce, params)
    assert set(se) == set(want) == {6, 7, 8, 9, 10}
    assert all(v > 0 for v in se.values())
    rtol = 1e-4 if pruner == "torch" else 1e-2
    for k in se:
        assert se[k] == pytest.approx(want[k], rel=rtol), k
