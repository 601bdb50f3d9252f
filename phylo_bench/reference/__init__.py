"""The benchmark's plain reference: Felsenstein pruning in plain PyTorch,
float64, with gradients by autograd.

A frozen rewrite of the formulas of the repository's serial oracle
(``oracle/core.py``): P(t) by ``torch.linalg.matrix_exp``, the discrete
gamma rates by ``scipy.special``, per-node rescaling by each column's
maximum, category mixing and the +I component in log space. It has a tree
type of its own and imports nothing of the program under test: it takes
the tree, the leaf states and the parameters that the benchmark made.
"""
from reference.tree import RefTree, random_topology  # noqa: F401
from reference.likelihood import loglik_and_grad, rate_matrix  # noqa: F401
