"""How some port test modules evaluate a JAX reference: the same JAX
function, compiled once instead of traced and dispatched op by op."""
import contextlib

import jax
import pytest


@contextlib.contextmanager
def jitted_hessian():
    """``jax.hessian`` returns a jitted Hessian while the block runs.

    The JAX package's ``optimize.fisher_covariance`` evaluates
    ``jax.hessian(negll)(point)`` eagerly, so each primitive of the
    forward-over-reverse pass is compiled on its own (about a minute on
    the CPU for a two-locus partitioned engine); under one ``jax.jit`` the
    same Hessian compiles once, in seconds. A model without a second
    derivative still raises ``NotImplementedError`` when it is traced,
    and ``fisher_covariance`` then takes its differences as before.
    """
    hessian = jax.hessian
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "hessian",
                   lambda fun, *args, **kwargs: jax.jit(
                       hessian(fun, *args, **kwargs)))
        yield
