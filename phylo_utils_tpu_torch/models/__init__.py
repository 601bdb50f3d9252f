"""Substitution models (PyTorch port of ``phylo_utils_tpu.models``).

A model is a frozen spec + functions of parameter tensors: the DNA family,
the empirical protein models LG and WAG (plus any PAML ``.dat`` matrix,
``empirical_model_from_dat``), the codon models GY94 and MG94
(``models.codon``) and the morphological Mk family, ``MK<k>`` and
``ORDERED<k>`` (``models.morphology``).
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
from phylo_utils_tpu_torch.models.codon import (  # noqa: F401
    GY94,
    MG94,
    CODONS,
    f3x4_frequencies,
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
    "gy94": GY94,
    "mg94": MG94,
}


def get_model(name: str) -> Model:
    low = name.lower()
    try:
        return _REGISTRY[low]
    except KeyError:
        pass
    # morphological Mk family: MK<k> / ORDERED<k> (e.g. MK4, ORDERED5)
    for prefix, ordered in (("ordered", True), ("mk", False)):
        if low.startswith(prefix) and low[len(prefix):].isdigit():
            from phylo_utils_tpu_torch.models.morphology import mk_model

            return mk_model(int(low[len(prefix):]), ordered=ordered)
    raise ValueError(
        f"unknown model {name!r}; expected one of {sorted(_REGISTRY)} "
        "or MK<k>/ORDERED<k>"
    )


def parse_model_spec(spec: str, get_model=None):
    """'GTR+G4+I+F' -> (model, ncat, inv, emp, rate_model).

    +G[n] discrete gamma (default 4 categories), +R[n] FreeRate (default 4),
    +I invariant sites, +F observed equilibrium frequencies. +G and +R are
    mutually exclusive. ``get_model`` resolves the leading model name
    (default: the registry lookup; the CLI passes a resolver that also
    accepts PAML .dat paths)."""
    resolve = get_model if get_model is not None else globals()["get_model"]
    parts = spec.split("+")
    model = resolve(parts[0])
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
