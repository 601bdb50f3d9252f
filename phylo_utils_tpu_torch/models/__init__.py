"""Substitution models (PyTorch port of ``phylo_utils_tpu.models``).

A model is a frozen spec + functions of parameter tensors. The DNA family
and the empirical protein models LG and WAG (plus any PAML ``.dat``
matrix, ``empirical_model_from_dat``) are ported; codon and Mk (ROADMAP
A14) names are recognized and raise ``NotImplementedError``.
"""
from phylo_utils_tpu_torch.models.base import (  # noqa: F401
    Eigen,
    Model,
    build_rate_matrix,
    eigen_reversible,
    normalize_q,
    stationary_from_q,
)
from phylo_utils_tpu_torch.models.dna import (  # noqa: F401
    JC69,
    K80,
    F81,
    F84,
    HKY85,
    TN93,
    GTR,
    UNREST,
)
from phylo_utils_tpu_torch.models.protein import (  # noqa: F401
    LG,
    WAG,
    empirical_model_from_dat,
)

_REGISTRY = {
    "jc69": JC69,
    "k80": K80,
    "f81": F81,
    "f84": F84,
    "hky85": HKY85,
    "tn93": TN93,
    "gtr": GTR,
    "unrest": UNREST,
    "lg": LG,
    "wag": WAG,
}

_NOT_PORTED = {"gy94": "A14", "mg94": "A14"}


def get_model(name: str) -> Model:
    low = name.lower()
    try:
        return _REGISTRY[low]
    except KeyError:
        pass
    item = _NOT_PORTED.get(low)
    for prefix in ("ordered", "mk"):
        if low.startswith(prefix) and low[len(prefix):].isdigit():
            item = "A14"
    if item is not None:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP {item})"
        )
    raise ValueError(
        f"unknown model {name!r}; expected one of {sorted(_REGISTRY)}"
    )


def parse_model_spec(spec: str):
    """'GTR+G4+I+F' -> (model, ncat, inv, emp, rate_model).

    +G[n] discrete gamma (default 4 categories), +R[n] FreeRate (default 4),
    +I invariant sites, +F observed equilibrium frequencies. +G and +R are
    mutually exclusive."""
    parts = spec.split("+")
    model = get_model(parts[0])
    ncat, inv, emp, rate_model = 1, False, False, "gamma"
    saw_g = False
    for flag in parts[1:]:
        up = flag.upper()
        if up.startswith("G"):
            ncat = int(up[1:]) if up[1:] else 4
            saw_g = True
        elif up.startswith("R"):
            ncat = int(up[1:]) if up[1:] else 4
            rate_model = "free"
        elif up == "I":
            inv = True
        elif up == "F":
            emp = True
        else:
            raise ValueError(
                f"unknown model-string flag '+{flag}' in {spec!r} "
                "(supported: +G[n], +R[n], +I, +F)"
            )
    if rate_model == "free" and saw_g:
        raise ValueError(f"{spec!r}: +G and +R are mutually exclusive")
    return model, ncat, inv, emp, rate_model
