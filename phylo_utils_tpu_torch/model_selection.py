"""Model selection (PyTorch port of ``phylo_utils_tpu.model_selection``):
fit a family of models and rank them by AIC/AICc/BIC, nested-model LRTs,
and the Goldman-Cox adequacy test.

Each candidate is fitted by ``optimize.fit`` (exact gradients through the
pruning pass); parameter counts follow the JAX package's conventions
(branch lengths + free model parameters + mixture parameters). The engines
run on the card unless ``device="cpu"`` is given. ``partition_finder``
selects a model per subset of a partition scheme and merges subsets
greedily (PartitionFinder's "greedy" algorithm).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from phylo_utils_tpu_torch import models as _models
from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
from phylo_utils_tpu_torch.optimize import fit

__all__ = ["count_free_parameters", "compare_models", "ModelFit",
           "likelihood_ratio_test", "goldman_cox_test",
           "unconstrained_loglikelihood", "partition_finder"]


_MODEL_K = {
    # free model parameters (exchangeabilities/freqs conventions)
    "JC69": 0,
    "K80": 1,            # kappa
    "F81": 3,            # freqs (simplex)
    "F84": 4,            # kappa + freqs
    "HKY85": 4,          # kappa + freqs
    "TN93": 5,           # alpha1, alpha2 (beta fixed by scaling) + freqs
    "GTR": 8,            # 5 free exchangeabilities + 3 freqs
    "UNREST": 11,        # 12 rates - 1 scale
    "LG": 0,
    "WAG": 0,
    "GY94": 2 + 60,      # kappa, omega + 60 codon freqs
}


def count_free_parameters(engine: LikelihoodEngine) -> int:
    k = _MODEL_K.get(engine.model.name, 0)
    k += engine.tree.n_nodes - 1          # branch lengths (root has no edge)
    if engine.ncat > 1:
        if getattr(engine, "rate_model", "gamma") == "free":
            k += 2 * engine.ncat - 2      # rates + weights, both normalized
        else:
            k += 1                        # alpha
    if engine.invariant_sites:
        k += 1                            # pinv
    return k


class ModelFit:
    def __init__(self, name, loglik, k, n, aic, aicc, bic, params):
        self.name = name
        self.loglik = loglik
        self.k = k
        self.n = n
        self.aic = aic
        self.aicc = aicc
        self.bic = bic
        self.params = params

    def as_dict(self) -> Dict:
        return {
            "model": self.name, "loglik": self.loglik, "k": self.k,
            "aic": self.aic, "aicc": self.aicc, "bic": self.bic,
        }


def compare_models(
    tree,
    alignment,
    candidates: Optional[Sequence[Union[str, Tuple]]] = None,
    criterion: str = "bic",
    max_steps: int = 200,
    device="cuda",
    **fit_kwargs,
) -> List[ModelFit]:
    """Fit each candidate and return ModelFits sorted by ``criterion``.

    ``candidates`` entries are model names ("GTR"), optionally with mixture
    suffixes "+G" (gamma-4) and "+I" ("GTR+G+I"). Default: the standard DNA
    ladder JC69 -> GTR+G+I. Each candidate's ``LikelihoodEngine`` runs on
    ``device`` (its default dtype and pruner); other keywords go to ``fit``.
    """
    if candidates is None:
        candidates = [
            "JC69", "K80", "HKY85", "GTR",
            "JC69+G", "K80+G", "HKY85+G", "GTR+G", "GTR+G+I",
        ]
    results: List[ModelFit] = []
    for spec in candidates:
        model, ncat, inv, _emp, rate_model = _models.parse_model_spec(spec)
        engine = LikelihoodEngine(tree, alignment, model, ncat=ncat,
                                  invariant_sites=inv, rate_model=rate_model,
                                  device=device)
        res = fit(engine, max_steps=max_steps, **fit_kwargs)
        k = count_free_parameters(engine)
        n = float(np.asarray(engine._compressed.weights).sum())
        aic = 2 * k - 2 * res.loglik
        aicc = aic + (2 * k * (k + 1)) / max(n - k - 1, 1.0)
        bic = k * np.log(n) - 2 * res.loglik
        results.append(ModelFit(spec, res.loglik, k, n, aic, aicc, bic,
                                res.params))
    return sorted(results, key=lambda r: getattr(r, criterion))


def likelihood_ratio_test(
    loglik_null: float, loglik_alt: float, df: int
) -> Dict[str, float]:
    """LRT for nested models: 2*(lnL1 - lnL0) ~ chi2(df) under H0.

    Returns {"statistic", "df", "pvalue"}. Use e.g. to test rate
    heterogeneity (GTR vs GTR+G, df=1) or positive selection (M1a vs M2a,
    M7 vs M8, df=2).
    """
    from scipy.stats import chi2

    stat = 2.0 * (loglik_alt - loglik_null)
    return {
        "statistic": float(stat),
        "df": int(df),
        "pvalue": float(chi2.sf(max(stat, 0.0), df)),
    }


def unconstrained_loglikelihood(engine) -> float:
    """Multinomial unconstrained maximum: sum_p n_p log(n_p / N) over site
    patterns, the best any iid-sites model could do. The gap to the model's
    logL is the Goldman (1993) adequacy statistic."""
    w = np.asarray(engine._compressed.weights, np.float64)
    w = w[: engine._compressed.n_patterns]
    n = w.sum()
    return float(np.sum(w * np.log(w / n)))


def goldman_cox_test(
    engine,
    params: Optional[Mapping] = None,
    n_replicates: int = 50,
    seed: int = 0,
    refit: bool = True,
    max_steps: int = 150,
    **fit_kwargs,
) -> Dict:
    """Goldman-Cox model-adequacy test (Goldman 1993, J Mol Evol 36:182).

    The statistic is delta = lnL_unconstrained - lnL_model (how far the
    model falls short of the multinomial ceiling). Its null distribution is
    built by parametric bootstrap: simulate ``n_replicates`` alignments
    under the fitted model, refit each (``refit=False`` evaluates at the
    generating values instead: faster, slightly conservative), and
    recompute delta. p-value = fraction of replicate deltas >= the observed
    one; a small p means the model is an inadequate description of the
    data even if it is the best of the candidates compared.

    Replicate ``i`` is simulated from a generator seeded ``seed + i`` on the
    engine's device, as ``optimize.parametric_bootstrap`` does; the
    replicate engines take the engine's device, dtype and pruner. Base
    ``LikelihoodEngine`` with the gamma/no-rate mixture only
    (``optimize.simulation_setup``).
    """
    from phylo_utils_tpu_torch.optimize import simulation_setup
    from phylo_utils_tpu_torch.simulate import simulate_alignment

    full, tree_mle, n_sites, sim_params, pinv = simulation_setup(
        engine, params, what="goldman_cox_test"
    )
    ll_model = engine.loglikelihood(full)
    delta_obs = unconstrained_loglikelihood(engine) - ll_model

    deltas = np.empty(n_replicates)
    for i in range(n_replicates):
        aln = simulate_alignment(
            seed + i, tree_mle, engine.model, n_sites, params=sim_params,
            ncat=engine.ncat, pinv=pinv, median=engine.median,
            device=engine.device,
        )
        rep = type(engine)(
            tree_mle, aln, engine.model, ncat=engine.ncat,
            invariant_sites=engine.invariant_sites, median=engine.median,
            dtype=engine.dtype, pruner=engine.pruner, device=engine.device,
        )
        if refit:
            res = fit(rep, params0=full, max_steps=max_steps, **fit_kwargs)
            ll_rep = res.loglik
        else:
            ll_rep = rep.loglikelihood(full)
        deltas[i] = unconstrained_loglikelihood(rep) - ll_rep
    pvalue = float((deltas >= delta_obs).mean())
    return {
        "delta": float(delta_obs),
        "null_deltas": deltas,
        "pvalue": pvalue,
        "loglik": float(ll_model),
        "unconstrained": float(unconstrained_loglikelihood(engine)),
    }


def _scheme_score(fits, criterion: str) -> float:
    """Joint criterion for a partition scheme: additive logL and k, one
    shared penalty at the total sample size."""
    ll = sum(f.loglik for f in fits)
    k = sum(f.k for f in fits)
    n = sum(f.n for f in fits)
    if criterion == "aic":
        return 2 * k - 2 * ll
    if criterion == "aicc":
        return 2 * k - 2 * ll + (2 * k * (k + 1)) / max(n - k - 1, 1.0)
    if criterion == "bic":
        return k * np.log(n) - 2 * ll
    raise ValueError(f"unknown criterion {criterion!r}")


def partition_finder(
    tree,
    alignment: Mapping[str, str],
    subsets: Mapping[str, Sequence[int]],
    candidates: Optional[Sequence[str]] = None,
    criterion: str = "bic",
    merge: bool = True,
    max_steps: int = 200,
    device="cuda",
    **fit_kwargs,
) -> Dict:
    """PartitionFinder-style model selection over a partition scheme.

    For every subset (name -> 0-based column indices into the
    concatenated ``alignment``) the best-fitting model among
    ``candidates`` is chosen by ``compare_models``; with ``merge=True``
    the scheme is then greedily coarsened (PartitionFinder's "greedy"
    algorithm, Lanfear et al. 2012): at each round the pair merge that
    most improves the joint ``criterion`` is accepted, until no merge
    improves it. Subsets are fitted independently (unlinked branch
    lengths — each subset's k includes its own branch lengths), so the
    joint criterion is additive with one shared penalty at the total
    sample size.

    Returns ``{"scheme": [{"name", "columns", "model", "loglik", "k",
    criterion: ...}], "score", "criterion", "n_rounds", "merged_from"}``.
    The result's subsets feed ``partition.Partition`` /
    ``PartitionedEngine`` directly for a final joint fit. Every fit runs
    on ``device`` (``compare_models``).
    """
    if not subsets:
        raise ValueError("no subsets given")
    lens = {len(s) for s in alignment.values()}
    if len(lens) != 1:
        raise ValueError("sequences have unequal lengths")
    (n_sites,) = lens
    for nm, cols in subsets.items():
        bad = [c for c in cols if not 0 <= c < n_sites]
        if bad:
            raise ValueError(
                f"subset {nm!r} has out-of-range columns {bad[:3]}"
            )

    cache: Dict[Tuple[int, ...], ModelFit] = {}

    def best_fit(cols: Tuple[int, ...]) -> ModelFit:
        if cols not in cache:
            sub = {k: "".join(s[i] for i in cols)
                   for k, s in alignment.items()}
            cache[cols] = compare_models(
                tree, sub, candidates=candidates, criterion=criterion,
                max_steps=max_steps, device=device, **fit_kwargs,
            )[0]
        return cache[cols]

    scheme = {nm: tuple(sorted(cols)) for nm, cols in subsets.items()}
    fits = {nm: best_fit(cols) for nm, cols in scheme.items()}
    merged_from: Dict[str, List[str]] = {nm: [nm] for nm in scheme}
    score = _scheme_score(list(fits.values()), criterion)
    n_rounds = 0

    while merge and len(scheme) > 1:
        n_rounds += 1
        names = sorted(scheme)
        best = None  # (new_score, a, b, merged_cols, merged_fit)
        for i in range(len(names)):
            for j in range(i + 1, len(names)):
                a, b = names[i], names[j]
                cols = tuple(sorted(scheme[a] + scheme[b]))
                f = best_fit(cols)
                others = [fits[nm] for nm in names if nm not in (a, b)]
                s = _scheme_score(others + [f], criterion)
                if s < score and (best is None or s < best[0]):
                    best = (s, a, b, cols, f)
        if best is None:
            break
        s, a, b, cols, f = best
        new_name = f"{a}+{b}"
        merged_from[new_name] = merged_from.pop(a) + merged_from.pop(b)
        for nm in (a, b):
            del scheme[nm], fits[nm]
        scheme[new_name] = cols
        fits[new_name] = f
        score = s

    return {
        "scheme": [
            {
                "name": nm,
                "columns": list(scheme[nm]),
                "model": fits[nm].name,
                "loglik": fits[nm].loglik,
                "k": fits[nm].k,
                criterion: getattr(fits[nm], criterion),
            }
            for nm in sorted(scheme)
        ],
        "score": score,
        "criterion": criterion,
        "n_rounds": n_rounds,
        "merged_from": merged_from,
    }
