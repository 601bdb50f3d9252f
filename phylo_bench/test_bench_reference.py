"""The plain reference against closed forms and finite differences, and
the roofline's counts against a hand count (CPU)."""
import importlib.util
import itertools
import math

import numpy as np
import pytest
import scipy.linalg
import torch

from cells import HERE, load_module
from reference import RefTree, loglik_and_grad, rate_matrix
from reference.gamma import gamma_rates_np
from roofline import least_seconds, pruning_work

GTR = load_module(HERE / "reference" / "models" / "gtr.py")
GY94 = load_module(HERE / "reference" / "models" / "gy94.py")
F64 = dict(dtype=torch.float64)


def _tree(children, n_leaves):
    parent = np.full(len(children), -1)
    for node, kids in enumerate(children):
        for c in kids:
            parent[c] = node
    return RefTree(parent=parent, children=tuple(children),
                   n_leaves=n_leaves)


# ((t0, t1), (t2, t3)): leaves 0-3, internal 4 and 5, the root 6
QUARTET = _tree([(), (), (), (), (0, 1), (2, 3), (4, 5)], 4)
PAIR = _tree([(), (), (0, 1)], 2)


def _jc_p(t):
    e = math.exp(-4.0 * t / 3.0)
    return np.where(np.eye(4, dtype=bool), 0.25 + 0.75 * e, 0.25 - 0.25 * e)


def _ref(tree, pats, build, params, ncat=1, grad=False, weights=None):
    pats = torch.as_tensor(pats, dtype=torch.int64)
    w = torch.ones(pats.shape[1], **F64) if weights is None else weights
    return loglik_and_grad(tree, pats, w, build, params, ncat, grad)


def _jc_params(lengths):
    return {"branch_lengths": torch.tensor([lengths], **F64),
            "model": {"rates": torch.ones(6, **F64),
                      "freqs": torch.full((4,), 0.25, **F64)}}


def test_jc69_quartet_closed_form():
    lengths = [0.1, 0.2, 0.05, 0.3, 0.15, 0.25, 0.0]
    pats = list(itertools.product(range(4), repeat=4))[::7]
    got, _ = _ref(QUARTET, np.array(pats).T, GTR.build, _jc_params(lengths))
    p = [_jc_p(t) for t in lengths]
    want = 0.0
    for a, b, c, d in pats:
        left = p[4] * (p[0][:, a] * p[1][:, b])[None, :]     # root x -> 4
        right = p[5] * (p[2][:, c] * p[3][:, d])[None, :]
        want += math.log(0.25 * (left.sum(1) * right.sum(1)).sum())
    assert float(got[0]) == pytest.approx(want, rel=1e-12)


def test_gy94_one_branch_closed_form():
    kappa, omega, t = 2.4, 0.25, 0.37
    freqs = GY94.f3x4([[0.26, 0.22, 0.32, 0.2], [0.3, 0.23, 0.18, 0.29],
                       [0.22, 0.28, 0.24, 0.26]])
    # Q written out from the definition, independently of gy94.build
    n = len(GY94.CODONS)
    aa = dict(zip(("".join(c) for c in itertools.product("TCAG", repeat=3)),
                  "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVV"
                  "AAAADDEEGGGG"))
    q = np.zeros((n, n))
    for i, a in enumerate(GY94.CODONS):
        for j, b in enumerate(GY94.CODONS):
            diff = [(x, y) for x, y in zip(a, b) if x != y]
            if len(diff) == 1:
                ts = {diff[0][0], diff[0][1]} in ({"A", "G"}, {"C", "T"})
                q[i, j] = (kappa if ts else 1.0) * (
                    omega if aa[a] != aa[b] else 1.0) * freqs[j]
    q -= np.diag(q.sum(1))
    q /= -(freqs * np.diag(q)).sum()
    pm = scipy.linalg.expm(q * t)
    pats = np.array([[0, 5, 17, 60], [0, 9, 17, 33]])
    params = {"branch_lengths": torch.tensor([[t, 0.0, 0.0]], **F64),
              "model": {"kappa": torch.tensor(kappa, **F64),
                        "omega": torch.tensor(omega, **F64),
                        "freqs": torch.as_tensor(freqs, **F64)}}
    got, _ = _ref(PAIR, pats, GY94.build, params)
    want = sum(math.log(freqs[y] * pm[y, x]) for x, y in pats.T)
    assert float(got[0]) == pytest.approx(want, rel=1e-11)


def test_gamma_rates_mean_one_and_known_value():
    r = gamma_rates_np(0.5, 4)
    assert r.mean() == pytest.approx(1.0, rel=1e-14)
    # Yang (1994), alpha 0.5, 4 categories, means: 0.0334, 0.2519, 0.8203,
    # 2.8944
    assert r == pytest.approx([0.0334, 0.2519, 0.8203, 2.8944], abs=1e-4)


def _fd_case(kind):
    rng = np.random.default_rng(3)
    pats = rng.integers(0, 4 if kind == "dna" else 61, (4, 24))
    lengths = torch.tensor([[0.1, 0.2, 0.05, 0.3, 0.15, 0.25, 0.0],
                            [0.2, 0.1, 0.15, 0.1, 0.05, 0.3, 0.0]], **F64)
    if kind == "dna":
        pats[:, :6] = pats[0, :6]                  # constant columns for +I
        model = {"rates": torch.tensor([1.2, 3.1, 0.7, 0.9, 4.2, 1.0], **F64),
                 "freqs": torch.tensor([0.3, 0.2, 0.22, 0.28], **F64)}
        params = {"branch_lengths": lengths, "model": model,
                  "alpha": torch.tensor(0.5, **F64),
                  "pinv": torch.tensor(0.1, **F64)}
        return pats, GTR.build, params
    model = {"kappa": torch.tensor(2.4, **F64),
             "omega": torch.tensor(0.25, **F64),
             "freqs": torch.as_tensor(GY94.f3x4(np.full((3, 4), 0.25)),
                                      **F64)}
    return pats, GY94.build, {"branch_lengths": lengths, "model": model,
                              "alpha": torch.tensor(0.6, **F64)}


def _entries(kind):
    common = [("branch_lengths", (1, 2)), ("alpha", ())]
    if kind == "dna":
        return common + [("model.rates", (1,)), ("model.freqs", (2,)),
                         ("pinv", ())]
    return common + [("model.kappa", ()), ("model.omega", ()),
                     ("model.freqs", (7,))]


def _get(tree, key):
    for k in key.split("."):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("kind", ["dna", "codon"])
def test_gradient_against_finite_differences(kind):
    pats, build, params = _fd_case(kind)
    _, grads = _ref(QUARTET, pats, build, params, ncat=4, grad=True)
    for key, idx in _entries(kind):
        h = 1e-6
        values = []
        for sign in (1.0, -1.0):
            moved = {**params, "model": dict(params["model"])}
            leaf = _get(moved, key).clone()
            leaf[idx] += sign * h
            if "." in key:
                moved["model"][key.split(".")[1]] = leaf
            else:
                moved[key] = leaf
            values.append(_ref(QUARTET, pats, build, moved, ncat=4)[0].sum())
        fd = float(values[0] - values[1]) / (2 * h)
        assert float(_get(grads, key)[idx]) == pytest.approx(
            fd, rel=1e-6, abs=1e-6), key


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from reference.likelihood import round_tf32

    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -1.0 - 2.0 ** -12])
    assert round_tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0,
                                      1.0 + 2.0 ** -9, -1.0]


def test_rate_matrix_rows_and_mean_rate():
    q = rate_matrix(torch.ones(4, 4, **F64) - torch.eye(4, **F64),
                    torch.tensor([0.1, 0.2, 0.3, 0.4], **F64))
    assert torch.allclose(q.sum(1), torch.zeros(4, **F64), atol=1e-15)
    assert float(-(torch.tensor([0.1, 0.2, 0.3, 0.4], **F64)
                   * q.diagonal()).sum()) == pytest.approx(1.0)


@pytest.mark.parametrize("states, value, grad, nbytes, grad_bytes", [
    (4, 240, 568, 460, 844),
    (61, 45384, 106018, 4 * (4 * 61 + 6 * 3721 + 1) + 8,
     4 * (4 * 61 + 12 * 3721 + 1) + 8),
])
def test_roofline_hand_count(states, value, grad, nbytes, grad_bytes):
    # the quartet: 4 leaves, 3 internal nodes, 6 edges; one set, one
    # category, one pattern. Value: 6 edges x (2 S^2 + S) + 3 x 2 S; the
    # gradient adds 2 x 2 S^2 + 6 x (2 S^2 + 3 S)
    assert pruning_work(4, 3, 6, 1, 1, 1, states, False) == (value, nbytes)
    assert pruning_work(4, 3, 6, 1, 1, 1, states, True) == (grad,
                                                            grad_bytes)
    flops, b = pruning_work(4, 3, 6, 100_000, 64, 4, states, True)
    seconds, by = least_seconds(flops, b)
    assert seconds == pytest.approx(max(flops / 67e12, b / 3.35e12))
    assert by == "operations"


def test_reference_imports_nothing_of_the_program():
    import ast

    for path in (HERE / "reference").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                top = name.split(".")[0]
                assert top in {"reference", "numpy", "scipy", "torch",
                               "math", "itertools", "dataclasses", "typing",
                               "__future__"}, (path, name)
    assert importlib.util.find_spec("reference") is not None
