"""Protein profile mixtures: the C10-C60 frequency-profile family and the
LG4M/LG4X matrix family (PyTorch port of
``phylo_utils_tpu.profile_mixtures``).

K classes differ in equilibrium frequency profiles (C10-C60: Quang, Gascuel
& Lartillot 2008; PhyloBayes CAT), in per-class rates (``class_rates``,
normalised to weighted mean 1 so branch lengths keep their expected
substitutions per site), and, in the LG4M/LG4X family (Le, Dang & Gascuel
2012), in the per-class rate matrices (``class_models``). Built on
``mixtures.ModelMixtureEngine``, so under ``pruner="cuda"`` the K classes
prune through the kernels (``ops.cuda_pruning.make_cuda_prune_fn``).

Profiles come from an IQ-TREE ``models.nex`` file (``parse_nexus_models``,
``profile_mixture_from_nexus``: ``frequency`` definitions, ``FMIX{}``
frequency mixtures, GTR20-style matrix definitions and ``MIX{}`` matrix
mixtures); the published C10-C60/LG4X tables are not vendored in this
repository, as the JAX package does not vendor them. Or as free parameters
(``fit(engine, free=("mixture", "cat_weights", ...))``), or as an array of
(K, n_states) profiles.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from phylo_utils_tpu_torch.mixtures import ModelMixtureEngine
from phylo_utils_tpu_torch.models.base import Model

__all__ = ["ProfileMixtureEngine", "parse_nexus_models",
           "profile_mixture_from_nexus"]


class ProfileMixtureEngine(ModelMixtureEngine):
    """Frequency-profile mixture; optionally per-class rate MATRICES.

    Parameters
    ----------
    tree, alignment : as LikelihoodEngine
    model : a reversible Model whose only free parameter is ``freqs`` (LG,
        WAG, any PAML ``.dat`` empirical model); its exchangeability matrix
        is shared by every class unless ``class_models`` is given.
    class_models : optional list of per-class Models (same state count and
        parameter names): each class then evolves under its own
        exchangeability matrix, the LG4M/LG4X family (four matrices coupled
        with four free rates through ``class_rates``).
    profiles : (K, n_states) array of per-class equilibrium frequencies, or
        an int K to start from the model's base frequencies perturbed per
        class by a numpy generator seeded with ``seed`` (the ML-estimation
        starting point; the JAX package draws the same numbers).
    weights : optional (K,) starting class weights (uniform default); free
        simplex parameter ``cat_weights`` under ``fit``.
    class_rates : "free" (per-class rates, free positive parameters
        normalised to weighted mean 1), "equal" (all 1), or an explicit
        (K,) array used as the starting value of the free parameter.
    perturb : relative jitter of the ``profiles=K`` starting point.
    Other keyword arguments go to ``LikelihoodEngine`` (``dtype``,
    ``pruner``, ``device``, ...).
    """

    def __init__(self, tree, alignment, model: Model,
                 profiles: Union[int, Sequence], weights=None,
                 class_rates: Union[str, Sequence] = "equal",
                 perturb: float = 0.25, seed: int = 0,
                 class_models: Optional[Sequence[Model]] = None, **kwargs):
        if isinstance(profiles, (int, np.integer)):
            k = int(profiles)
            base = np.asarray(model.param_defaults["freqs"], np.float64)
            rng = np.random.default_rng(seed)
            prof = base[None, :] * np.exp(
                rng.normal(0.0, perturb, size=(k, base.shape[0]))
            )
            prof = prof / prof.sum(axis=1, keepdims=True)
        else:
            prof = np.asarray(profiles, np.float64)
            if prof.ndim != 2:
                raise ValueError("profiles must be (K, n_states)")
            if np.any(prof <= 0):
                raise ValueError("profiles must be strictly positive")
            prof = prof / prof.sum(axis=1, keepdims=True)
        if prof.shape[1] != model.n_states:
            raise ValueError(
                f"profiles have {prof.shape[1]} states but model "
                f"{model.name!r} has {model.n_states}"
            )
        mixture = [{"freqs": tuple(row.tolist())} for row in prof]
        super().__init__(tree, alignment, model, mixture,
                         class_models=class_models, **kwargs)
        self._weights0 = (
            None if weights is None
            else np.asarray(weights, np.float64)
        )
        if isinstance(class_rates, str):
            if class_rates not in ("free", "equal"):
                raise ValueError(
                    f"class_rates must be 'free', 'equal', or an array; "
                    f"got {class_rates!r}"
                )
            self._rates0 = (
                np.ones(self.ncat) if class_rates == "free" else None
            )
        else:
            r = np.asarray(class_rates, np.float64)
            if r.shape != (self.ncat,):
                raise ValueError(
                    f"class_rates must have shape ({self.ncat},)"
                )
            if np.any(r <= 0):
                raise ValueError("class_rates must be positive")
            self._rates0 = r

    def default_params(self) -> Dict:
        params = super().default_params()
        if self._weights0 is not None:
            params["cat_weights"] = self._tensor(
                self._weights0 / self._weights0.sum())
        if self._rates0 is not None:
            params["class_rates"] = self._tensor(self._rates0)
        return params

    def _mixture_tensors(self, params, dtype, eig=None, rates=None):
        """Per-class P with the optional per-class branch-rate coupling
        (``eig`` and ``rates`` ignored, as in ``ModelMixtureEngine``)."""
        mixture, cat_weights = self._category_model_params(params)
        cat_weights = cat_weights.to(dtype)
        t = params["branch_lengths"].to(dtype)               # (n_nodes,)
        if "class_rates" in params:
            r = params["class_rates"].to(dtype)
            # weighted mean 1: branch lengths stay in subs/site overall
            r = r / (cat_weights * r).sum()
        else:
            r = torch.ones((self.ncat,), dtype=dtype, device=self.device)
        sym_k, freqs_k = self._class_syms_freqs(mixture, dtype)
        p = self._class_p(sym_k, freqs_k, t[None, :] * r[:, None])
        return r, cat_weights, p, freqs_k


_FREQ_RE = re.compile(
    r"frequency\s+(\S+)\s*=\s*([^;]+);", re.IGNORECASE)
_MODEL_RE = re.compile(
    r"model\s+(\S+)\s*=\s*([^;]+);", re.IGNORECASE)
_FMIX_RE = re.compile(r"FMIX\{([^}]*)\}", re.IGNORECASE)
# one level of brace nesting: class tokens may carry +FU{freqname}
_MIX_RE = re.compile(r"MIX\{((?:[^{}]|\{[^{}]*\})*)\}", re.IGNORECASE)
_FU_RE = re.compile(r"\+FU?\{(\S+?)\}", re.IGNORECASE)


def parse_nexus_models(path_or_text: str) -> Dict:
    """Parse the IQ-TREE ``models.nex`` interchange format (subset).

    Understands:

    - ``frequency <name> = <floats>;`` definitions,
    - ``model <name> = <base>+FMIX{<freq>[:<rate>[:<weight>]],...};``
      frequency-profile mixtures (C10-C60 distribution format),
    - ``model <name> = <190 exchangeabilities> <20 freqs>;`` full
      GTR20-style MATRIX definitions (IQ-TREE's custom-matrix syntax:
      lower-triangle row-wise, then the equilibrium frequencies),
    - ``model <name> = MIX{<mat>[+FU{<freq>}][:<rate>[:<weight>]],...};``
      MATRIX mixtures — the LG4M/LG4X family, each class carrying its
      own rate matrix (and optionally its own frequency vector via
      ``+FU{...}``; otherwise the matrix definition's frequencies).

    Returns::

        {"frequencies": {name: (n_states,) ndarray},
         "matrices": {name: {"sym": (S, S) ndarray, "freqs": (S,)}},
         "models": {name: {"base": ..., "classes": [...]} |
                    {"matrix_classes": [(mat, freq|None, rate, weight)]}}

    Comments (``[...]``) are stripped; anything this subset doesn't
    recognize is ignored (the full NEXUS grammar is not needed to load
    mixture definitions).
    """
    try:
        with open(path_or_text) as fh:
            text = fh.read()
    except (OSError, ValueError):
        text = path_or_text
    text = re.sub(r"\[[^\]]*\]", " ", text)    # NEXUS comments

    freqs = {}
    for name, body in _FREQ_RE.findall(text):
        vals = np.asarray([float(x) for x in body.split()], np.float64)
        if np.any(vals <= 0):
            raise ValueError(f"frequency {name!r} has non-positive entries")
        freqs[name] = vals / vals.sum()

    models: Dict = {}
    matrices: Dict = {}
    for name, body in _MODEL_RE.findall(text):
        toks = body.split()
        if toks and all(_is_float(t) for t in toks):
            # GTR20-style full matrix definition: 190 lower-triangle
            # exchangeabilities + 20 frequencies (protein); generally
            # S(S-1)/2 + S numbers for an S-state alphabet
            n = len(toks)
            s = int(round((np.sqrt(1 + 8 * n) - 1) / 2))  # S(S+1)/2 = n
            if s * (s + 1) // 2 != n or s < 2:
                raise ValueError(
                    f"matrix model {name!r}: {n} numbers do not form a "
                    "lower triangle + frequency vector for any state count"
                )
            vals = np.asarray([float(t) for t in toks], np.float64)
            tri, fv = vals[: n - s], vals[n - s:]
            if np.any(tri < 0) or np.any(fv <= 0):
                raise ValueError(
                    f"matrix model {name!r}: negative exchangeability or "
                    "non-positive frequency"
                )
            sym = np.zeros((s, s), np.float64)
            kk = 0
            for i in range(1, s):
                sym[i, :i] = tri[kk:kk + i]
                sym[:i, i] = tri[kk:kk + i]
                kk += i
            matrices[name] = {"sym": sym, "freqs": fv / fv.sum()}
            continue
        m = _MIX_RE.search(body)
        if m and not _FMIX_RE.search(body):
            classes = []
            for part in m.group(1).split(","):
                bits = [b.strip() for b in part.split(":")]
                comp = bits[0]
                fu = _FU_RE.search(comp)
                fname = fu.group(1) if fu else None
                mat = _FU_RE.sub("", comp).strip().strip("+")
                rate = float(bits[1]) if len(bits) > 1 and bits[1] else 1.0
                weight = (
                    float(bits[2]) if len(bits) > 2 and bits[2] else None
                )
                classes.append((mat, fname, rate, weight))
            models[name] = {"matrix_classes": classes}
            continue
        m = _FMIX_RE.search(body)
        if not m:
            continue                    # not a mixture model
        base = _FMIX_RE.sub("", body).strip().strip("+")
        classes = []
        for part in m.group(1).split(","):
            bits = [b.strip() for b in part.split(":")]
            fname = bits[0]
            rate = float(bits[1]) if len(bits) > 1 and bits[1] else 1.0
            weight = float(bits[2]) if len(bits) > 2 and bits[2] else None
            classes.append((fname, rate, weight))
        models[name] = {"base": base, "classes": classes}
    return {"frequencies": freqs, "matrices": matrices, "models": models}


def _is_float(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def profile_mixture_from_nexus(
    path: str,
    name: str,
    tree,
    alignment,
    base_model: Model,
    free_weights: bool = False,
    **kwargs,
) -> ProfileMixtureEngine:
    """Build a ProfileMixtureEngine from a ``models.nex`` definition.

    ``name`` selects the FMIX model (e.g. "C10", "C20"); ``base_model``
    supplies the shared exchangeability matrix (the file's base-model
    token, e.g. POISSON or LG, names the intended one — pass the matching
    Model). Class rates/weights from the file are used as starting
    values; weights stay free parameters under ``fit`` regardless (fix
    them by excluding 'cat_weights' from ``free``).
    """
    defs = parse_nexus_models(path)
    if name not in defs["models"]:
        raise ValueError(
            f"model {name!r} not in file; available: "
            f"{sorted(defs['models'])}"
        )
    spec = defs["models"][name]

    if "matrix_classes" in spec:
        # LG4M/LG4X-style matrix mixture: each class gets its OWN Model
        # wrapping its matrix; frequencies come from +FU{...}, else the
        # matrix definition's own vector
        class_models, prof = [], []
        for mat, fname, _, _ in spec["matrix_classes"]:
            if mat in defs["matrices"]:
                md = defs["matrices"][mat]
                sym, mfreqs = md["sym"], md["freqs"]
            elif mat.upper() in ("LG", "WAG"):
                from phylo_utils_tpu_torch import models as _m

                builtin = getattr(_m, mat.upper())
                sym = builtin.build_parts(dtype=torch.float64)[0].numpy()
                mfreqs = np.asarray(
                    builtin.param_defaults["freqs"], np.float64
                )
            else:
                raise ValueError(
                    f"model {name!r} references undefined matrix "
                    f"{mat!r} (define it as 'model {mat} = <lower "
                    "triangle + freqs>;' or use LG/WAG)"
                )
            if fname is not None:
                try:
                    f = defs["frequencies"][fname]
                except KeyError:
                    raise ValueError(
                        f"model {name!r} references undefined "
                        f"frequency {fname!r}"
                    ) from None
            else:
                f = mfreqs
            prof.append(np.asarray(f, np.float64))

            def _mk_build(sym_const):
                def _build(freqs):
                    return torch.as_tensor(sym_const, dtype=freqs.dtype,
                                           device=freqs.device), freqs
                return _build

            class_models.append(Model(
                mat, sym.shape[0], base_model.alphabet,
                {"freqs": tuple(np.asarray(f, np.float64).tolist())},
                _mk_build(sym),
            ))
        prof = np.stack(prof)
        rates = np.asarray(
            [r for _, _, r, _ in spec["matrix_classes"]], np.float64
        )
        weights = [w for _, _, _, w in spec["matrix_classes"]]
        weights = (
            None if any(w is None for w in weights)
            else np.asarray(weights, np.float64)
        )
        return ProfileMixtureEngine(
            tree, alignment, base_model, profiles=prof, weights=weights,
            class_rates=(rates if not np.allclose(rates, 1.0)
                         else "free"),
            class_models=class_models, **kwargs,
        )

    try:
        prof = np.stack([defs["frequencies"][f] for f, _, _ in
                         spec["classes"]])
    except KeyError as e:
        raise ValueError(
            f"model {name!r} references undefined frequency "
            f"{e.args[0]!r}"
        ) from None
    rates = np.asarray([r for _, r, _ in spec["classes"]], np.float64)
    weights = [w for _, _, w in spec["classes"]]
    weights = (
        None if any(w is None for w in weights)
        else np.asarray(weights, np.float64)
    )
    return ProfileMixtureEngine(
        tree, alignment, base_model, profiles=prof, weights=weights,
        class_rates=(rates if not np.allclose(rates, 1.0) else "equal"),
        **kwargs,
    )
