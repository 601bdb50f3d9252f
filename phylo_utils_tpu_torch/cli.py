"""Command-line entry points of the PyTorch port (``phylo_utils_tpu.cli``'s
flags and JSON output).

Run as ``python -m phylo_utils_tpu_torch.cli <subcommand> ...`` (or
``python -m phylo_utils_tpu_torch``). Ported subcommands: ``loglik``,
``fit``, ``distances``, ``build-tree`` (with ``--refine``, the NNI/SPR
hill-climb, and ``--bootstrap``, NJ bootstrap supports), ``bootstrap``,
``serve``, ``simulate`` (FASTA through ``io.write_fasta``), ``benchmark``
(the value call's pruning throughput), ``compare``
(model selection by AIC/AICc/BIC), ``site-test`` (codeml's M1a-vs-M2a and
M7-vs-M8 positive-selection LRTs, with the NEB site scan under ``--sites``
and the M2a BEB scan under ``--beb``), ``topologies`` (a candidate set
scored in one batched pass, with the KH/SH/AU tests), ``search`` (NNI/SPR
hill-climb), ``supports`` (aLRT, SH-aLRT, aBayes, sCF), ``lmap``
(likelihood mapping), ``consense``, ``partitionfinder`` (a model per
subset of a partition file and greedy merging of subsets), ``ancestral``
(marginal posteriors and MAP sequences, with ``--joint`` the joint ML
reconstruction), ``branch-site-test`` (branch-site Model A LRT on a
foreground lineage), ``clock-test`` (strict clock against free branch
lengths) and ``date`` (penalized-likelihood dating of a phylogram,
calibrated or with a cross-validated lambda). Engines, the dating fits and
the simulator run on the card (``--device cuda``, the default) unless
``--device cpu`` is given; ``--pruner`` is ``torch`` (plain PyTorch, the
default, as the JAX CLI's ``xla``) or ``cuda`` (the hand-written kernels).
``--params`` JSON is read through ``convert.params_from_jax``, so both
packages read one file alike. The port has all twenty of the JAX CLI's
subcommands.
``--profile-mixture FILE.nex:NAME`` builds a ``ProfileMixtureEngine`` from an IQ-TREE
``models.nex`` definition, with ``--model`` as the shared exchangeability
matrix. ``--model`` takes the codon models GY94 and MG94 (on an in-frame
nucleotide alignment; ``fit`` then prints the codeml-style ``dn_ds`` block)
and the Mk family, ``MK<k>`` / ``ORDERED<k>``; ``--asc lewis|felsenstein|
stamatakis`` (with ``--asc-counts``) builds an ``AscertainmentEngine``;
``--recode ry|dayhoff6|sr6|kgb6`` recodes the alignment into grouped
states first (pair it with ``--model MK2`` / ``MK6``). ``--partitions
FILE`` (RAxML/IQ-TREE lines or NEXUS charsets) scores per-locus models over
one tree: a ``StackedPartitionedEngine`` where every locus shares one model
family and mixture, else a ``PartitionedEngine``; ``loglik`` then also
prints ``partition_logliks``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np

MODEL_NAMES = (
    "JC69", "K80", "F81", "F84", "HKY85", "TN93", "GTR", "UNREST", "LG",
    "WAG", "GY94", "MG94"
)

# the JAX CLI's subcommands that the port does not have yet, by ROADMAP item
NOT_PORTED: dict = {}

# the flags --profile-mixture refuses with its own message, as the JAX CLI
# refuses --recode and --shard-sites (the JAX CLI builds a partitioned
# engine and drops the profile mixture under --partitions)
_PROFILE_REFUSED = ("recode", "shard_sites", "partitions")


def _not_ported(what: str, item: str):
    raise SystemExit(f"{what} is not ported to phylo_utils_tpu_torch yet "
                     f"(ROADMAP {item})")


def _get_model(name: str):
    from phylo_utils_tpu_torch import models

    if name.lower().endswith(".dat") or os.sep in name:
        try:
            return models.empirical_model_from_dat(name)
        except (OSError, ValueError) as e:
            raise SystemExit(f"cannot load PAML .dat model {name!r}: {e}")
    try:
        return models.get_model(name)
    except NotImplementedError as e:
        raise SystemExit(str(e))
    except ValueError:
        raise SystemExit(
            f"unknown model {name!r}; choose from {', '.join(MODEL_NAMES)}, "
            "MK<k>/ORDERED<k> (morphological), or a PAML .dat file path"
        )


def _parse_model_spec(spec: str):
    """'GTR+G4+I+F' -> (model, ncat, inv, emp, rate_model)."""
    from phylo_utils_tpu_torch.models import parse_model_spec

    try:
        return parse_model_spec(spec, get_model=_get_model)
    except ValueError as e:
        raise SystemExit(str(e))


def _read_tree(arg: str):
    from phylo_utils_tpu_torch.io import parse_newick

    try:
        with open(arg) as f:
            text = f.read()
    except OSError:
        text = arg
    return parse_newick(text)


def _read_aln(path: str) -> Dict[str, str]:
    from phylo_utils_tpu_torch.io import read_alignment

    return read_alignment(path)


def _json_params(arg: Optional[str]) -> Optional[Dict]:
    from phylo_utils_tpu_torch.convert import params_from_jax

    return params_from_jax(json.loads(arg)) if arg else None


def _to_json(tree) -> Dict:
    """Nested dict of tensors/arrays -> the same nesting of lists."""
    from phylo_utils_tpu_torch.convert import params_to_numpy

    return {k: (_to_json(v) if isinstance(v, dict) else v.tolist())
            for k, v in params_to_numpy(tree).items()}


def _engine_params(args, engine) -> Optional[Dict]:
    """--params JSON, plus --empirical-freqs observed '+F' frequencies (per
    partition under --partitions: the file's '+F' entries)."""
    params = _json_params(args.params) or {}
    init = getattr(engine, "_partition_init_params", None)
    if init:
        # per-partition '+F' observed frequencies; explicit --params wins
        user_parts = dict(params.get("partitions") or {})
        for name, pv in init.get("partitions", {}).items():
            up = dict(user_parts.get(name, {}))
            um = dict(up.get("model", {}))
            for k, v in pv["model"].items():
                um.setdefault(k, v)
            up["model"] = um
            user_parts[name] = up
        params["partitions"] = user_parts
    if getattr(args, "empirical_freqs", False):
        if "freqs" not in engine.model.param_defaults:
            raise SystemExit(
                f"model {engine.model.name!r} has no 'freqs' parameter"
            )
        from phylo_utils_tpu_torch.alphabets import empirical_frequencies

        model_p = dict(params.get("model", {}))
        model_p.setdefault("freqs", empirical_frequencies(
            _read_aln(args.alignment), engine.model.alphabet,
            pseudocount=0.5).tolist())
        params["model"] = model_p
    return params or None


def _add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the engine runs (default: the card)")


def _add_engine_args(p: argparse.ArgumentParser):
    p.add_argument("--tree", required=True, help="newick file or literal")
    p.add_argument("--alignment", required=True, help="FASTA/PHYLIP file")
    p.add_argument("--model", default="GTR",
                   help="|".join(MODEL_NAMES) + " with optional "
                        "+G[n]/+R[n]/+I/+F suffixes (e.g. GTR+G4+I+F, "
                        "HKY85+R4)")
    p.add_argument("--ncat", type=int, default=1, help="gamma categories")
    p.add_argument("--invariant-sites", dest="invariant_sites",
                   action="store_true", help="+I mixture")
    p.add_argument("--params", help="JSON params override")
    p.add_argument("--empirical-freqs", dest="empirical_freqs",
                   action="store_true",
                   help="set model equilibrium frequencies from observed "
                        "character counts (the '+F' convention)")
    p.add_argument("--dtype", default=None, help="float32|float64")
    p.add_argument("--pruner", default="torch", choices=["torch", "cuda"])
    _add_device_arg(p)
    p.add_argument("--shard-sites", action="store_true",
                   help="shard patterns over all devices")
    p.add_argument("--partitions", default=None,
                   help="RAxML/IQ-TREE-style partition file (or NEXUS "
                        "charsets): per-locus models over one tree; "
                        "entries without a model use --model")
    p.add_argument("--asc", default=None,
                   choices=["lewis", "felsenstein", "stamatakis"],
                   help="ascertainment-bias correction for variable-sites-"
                        "only data (Mk matrices, SNPs); felsenstein/"
                        "stamatakis need --asc-counts")
    p.add_argument("--asc-counts", default=None,
                   help="removed constant-site counts: one number "
                        "(felsenstein) or comma-separated per-state counts "
                        "(stamatakis)")
    p.add_argument("--recode", default=None,
                   help="recode the alignment before analysis: ry (DNA->"
                        "purine/pyrimidine), dayhoff6/sr6/kgb6 (protein->"
                        "6 classes); pair with --model MK2 / MK6")
    p.add_argument("--profile-mixture", default=None,
                   metavar="FILE.nex:NAME",
                   help="frequency-profile mixture (C10-C60/LG4X family) "
                        "from an IQ-TREE models.nex definition; --model "
                        "supplies the shared exchangeability matrix "
                        "(e.g. LG)")


def _profile_mixture_engine(args):
    """The ``--profile-mixture FILE.nex:NAME`` engine, with the JAX CLI's
    refusals: +G/+I (the profile classes are the mixture axis), --recode
    and --shard-sites; and --partitions."""
    from phylo_utils_tpu_torch.profile_mixtures import (
        profile_mixture_from_nexus,
    )

    spec = args.profile_mixture
    if ":" not in spec:
        raise SystemExit("--profile-mixture expects FILE.nex:MODELNAME")
    path, _, name = spec.rpartition(":")
    base, spec_ncat, spec_inv, _, _ = _parse_model_spec(args.model)
    if spec_ncat > 1 or getattr(args, "ncat", 1) > 1 or spec_inv or \
            getattr(args, "invariant_sites", False):
        raise SystemExit(
            "--profile-mixture does not compose with +G/+I rate "
            "heterogeneity (the profile classes are the mixture axis); use "
            "the file's class rates, or drop the suffix"
        )
    if any(getattr(args, attr, None) for attr in _PROFILE_REFUSED):
        raise SystemExit("--profile-mixture does not support --recode/"
                         "--shard-sites/--partitions")
    try:
        return profile_mixture_from_nexus(
            path, name, _read_tree(args.tree), _read_aln(args.alignment),
            base, dtype=args.dtype, pruner=args.pruner, device=args.device,
        )
    except (OSError, ValueError) as e:
        raise SystemExit(f"--profile-mixture: {e}")


def _partitioned_engine(args):
    """The ``--partitions FILE`` engine: the loci stacked on one batch axis
    of one engine where they share one model family and mixture, else one
    engine per locus, as the JAX CLI builds it; the file's '+F'
    frequencies ride on the engine for ``_engine_params``."""
    from phylo_utils_tpu_torch.partition import (
        PartitionedEngine,
        StackedPartitionedEngine,
        partitions_from_file,
    )

    if getattr(args, "empirical_freqs", False):
        raise SystemExit(
            "--empirical-freqs is per-partition under --partitions: use "
            "'+F' in the partition file's model strings"
        )
    try:
        parts, init = partitions_from_file(
            args.partitions, _read_aln(args.alignment),
            default_model=args.model, get_model=_get_model,
        )
    except ValueError as e:
        raise SystemExit(f"--partitions: {e}")
    tree = _read_tree(args.tree)
    try:
        kw = dict(dtype=args.dtype, pruner=args.pruner, device=args.device,
                  sharding=_site_sharding(args))
        try:
            engine = StackedPartitionedEngine(tree, parts, **kw)
        except ValueError as e:
            if "share the model family" not in str(e):
                raise SystemExit(f"--partitions: {e}")
            engine = PartitionedEngine(tree, parts, **kw)
    except RuntimeError as e:       # no card behind --device cuda
        raise SystemExit(f"{e}; pass --device cpu to run on the CPU")
    engine._partition_init_params = init
    return engine


def _site_sharding(args):
    """``--shard-sites``: a ``SiteSharding`` over this process's cards (the
    CPU, one device, under ``--device cpu``) and over the process group
    where the environment configures one (torch.distributed's env://
    variables); None without the flag."""
    if not getattr(args, "shard_sites", False):
        return None
    from phylo_utils_tpu_torch.parallel import (
        SiteSharding,
        distributed_init,
        make_mesh,
    )

    distributed_init()
    return SiteSharding(make_mesh(["cpu"] if args.device == "cpu" else None))


def _build_engine(args):
    from phylo_utils_tpu_torch.likelihood import LikelihoodEngine

    profile = getattr(args, "profile_mixture", None)
    if getattr(args, "partitions", None) and not profile:
        return _partitioned_engine(args)
    if profile:
        try:
            return _profile_mixture_engine(args)
        except RuntimeError as e:       # no card behind --device cuda
            raise SystemExit(f"{e}; pass --device cpu to run on the CPU")
    model, spec_ncat, spec_inv, spec_emp, rate_model = \
        _parse_model_spec(args.model)
    # model-string suffixes compose with (and never reduce) the flags:
    # --model GTR+G4+I == --model GTR --ncat 4 --invariant-sites
    args.ncat = max(args.ncat, spec_ncat)
    args.invariant_sites = args.invariant_sites or spec_inv
    if spec_emp:
        args.empirical_freqs = True
    cls, extra = LikelihoodEngine, {}
    if getattr(args, "asc", None):
        from phylo_utils_tpu_torch.ascertainment import AscertainmentEngine

        cls = AscertainmentEngine
        extra["correction"] = args.asc
        if args.asc_counts is not None:
            counts = [float(x) for x in args.asc_counts.split(",")]
            extra["const_counts"] = counts[0] if len(counts) == 1 else counts
    elif getattr(args, "asc_counts", None):
        raise SystemExit("--asc-counts requires --asc")
    aln = _read_aln(args.alignment)
    if getattr(args, "recode", None):
        from phylo_utils_tpu_torch.alphabets import recode_alignment

        try:
            aln = recode_alignment(aln, args.recode)
        except ValueError as e:
            raise SystemExit(f"--recode: {e}")
    try:
        return cls(
            _read_tree(args.tree), aln, model,
            ncat=args.ncat, invariant_sites=args.invariant_sites,
            rate_model=rate_model, dtype=args.dtype, pruner=args.pruner,
            device=args.device, sharding=_site_sharding(args), **extra,
        )
    except RuntimeError as e:       # no card behind --device cuda
        raise SystemExit(f"{e}; pass --device cpu to run on the CPU")
    except ValueError as e:
        if getattr(args, "asc", None):
            raise SystemExit(f"--asc: {e}")
        raise


def cmd_loglik(args) -> int:
    engine = _build_engine(args)
    params = engine._full_params(_engine_params(args, engine))
    out = {"loglik": engine.loglikelihood(params)}
    if hasattr(engine, "partition_loglikelihoods"):
        out["partition_logliks"] = engine.partition_loglikelihoods(params)
    if args.sitewise:
        if hasattr(engine, "partition_loglikelihoods"):
            raise SystemExit(
                "--sitewise is not supported with --partitions (use the "
                "per-partition totals in 'partition_logliks')"
            )
        out["sitewise"] = engine.sitewise_loglikelihoods(params).tolist()
    print(json.dumps(out))
    return 0


def cmd_fit(args) -> int:
    import torch

    from phylo_utils_tpu_torch.optimize import fit, standard_errors
    from phylo_utils_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from phylo_utils_tpu_torch.utils.metrics import MetricsLogger

    engine = _build_engine(args)
    params0 = _engine_params(args, engine)
    resume_from = None
    if args.resume:
        # full-state checkpoints (written by --checkpoint-every) hold
        # {raw, optimizer} and resume bit-exactly inside fit(); a final
        # params checkpoint just seeds params0
        state, _ = load_checkpoint(args.resume, map_location=engine.device)
        if "raw" in state:
            resume_from = args.resume
        else:
            params0 = state["params"]
    free = tuple(args.free.split(",")) if args.free else None
    t0 = time.perf_counter()
    # patterns a step scores (a stack of loci: its padded columns too)
    n_pat = (sum(int(w.shape[0]) for w in engine._weights)
             if isinstance(engine._weights, tuple)
             else int(engine._weights.numel()))
    with MetricsLogger(args.metrics, echo=args.verbose) as logger:

        def callback(step, ll, params):
            logger.log(step, loglik=ll, patterns_per_s=n_pat * step
                       / (time.perf_counter() - t0))

        res = fit(
            engine, params0, free=free, max_steps=args.max_steps,
            steps_per_call=args.steps_per_call,
            callback=callback if (args.metrics or args.verbose) else None,
            checkpoint_path=args.checkpoint if args.checkpoint_every else None,
            checkpoint_every=args.checkpoint_every,
            resume_from=resume_from,
        )
    if args.checkpoint and not args.checkpoint_every:
        save_checkpoint(args.checkpoint, {
            "params": res.params,
            "loglik": torch.tensor(res.loglik, dtype=torch.float64),
        }, step=res.n_steps)
    out = {
        "loglik": res.loglik,
        "n_steps": res.n_steps,
        "converged": res.converged,
        "params": _to_json(res.params),
    }
    if args.se:
        out["standard_errors"] = _to_json(
            standard_errors(engine, res.params, free=free))
    model = getattr(engine, "model", None)   # the mixture engines have none
    if (model is not None and str(model.alphabet).startswith("codon")
            and "omega" in model.param_defaults):
        from phylo_utils_tpu_torch.models.codon import dn_ds_by_branch

        dd = dn_ds_by_branch(
            model, res.params["model"],
            branch_lengths=res.params["branch_lengths"].detach().cpu()
            .numpy())
        out["dn_ds"] = {
            "omega": dd["omega"], "S": dd["S"], "N": dd["N"],
            "dN": dd["dN"].tolist(), "dS": dd["dS"].tolist(),
        }
    print(json.dumps(out))
    return 0


def cmd_benchmark(args) -> int:
    """The engine's value call (``_loglik_fn``, the JAX CLI's ``_jit_fn``)
    timed over ``--iters`` calls after one warm-up, the card synchronized
    before the clock starts and before it stops."""
    import torch

    engine = _build_engine(args)
    params = engine._full_params(_json_params(args.params))
    fargs = (params, engine._leaf_partials, engine._weights)

    def sync():
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)

    with torch.no_grad():
        engine._loglik_fn(*fargs)
        sync()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            engine._loglik_fn(*fargs)
        sync()
        dt = (time.perf_counter() - t0) / args.iters
    n_pat = int(engine._weights.shape[0])
    # the JAX CLI counts jax.devices(): the cards here, the CPU as one
    n_dev = torch.cuda.device_count() if args.device == "cuda" else 1
    print(json.dumps({
        "patterns_per_s": n_pat / dt,
        "patterns_per_s_per_chip": n_pat / dt / n_dev,
        "step_ms": dt * 1e3,
        "n_patterns": n_pat,
        "n_devices": n_dev,
        "pruner": args.pruner,
    }))
    return 0


def cmd_distances(args) -> int:
    from phylo_utils_tpu_torch.optimize import ml_distance_matrix

    model = _get_model(args.model)
    aln = _read_aln(args.alignment)
    d = ml_distance_matrix(aln, model, params=_json_params(args.params),
                           device=args.device)
    names = list(aln)
    if args.format == "phylip":
        lines = [str(len(names))]
        for i, nm in enumerate(names):
            lines.append(nm + "  " + " ".join(f"{x:.6f}" for x in d[i]))
        print("\n".join(lines))
    else:
        print(json.dumps({"names": names, "distances": d.tolist()}))
    return 0


def cmd_bootstrap(args) -> int:
    engine = _build_engine(args)
    boots = engine.bootstrap_loglikelihoods(
        args.replicates, _engine_params(args, engine), seed=args.seed
    )
    print(json.dumps({
        "n_replicates": len(boots),
        "mean": float(boots.mean()),
        "std": float(boots.std()),
        "quantiles": {
            "q025": float(np.quantile(boots, 0.025)),
            "q500": float(np.quantile(boots, 0.5)),
            "q975": float(np.quantile(boots, 0.975)),
        },
        "logliks": boots.tolist() if args.full else None,
    }))
    return 0


def _on_card(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, exiting with a hint where ``--device cuda``
    finds no card."""
    try:
        return fn(*args, **kwargs)
    except RuntimeError as e:
        if "torch.cuda.is_available() is False" not in str(e):
            raise
        raise SystemExit(f"{e}; pass --device cpu to run on the CPU")


def cmd_build_tree(args) -> int:
    from phylo_utils_tpu_torch.io import write_newick
    from phylo_utils_tpu_torch.nj import neighbor_joining
    from phylo_utils_tpu_torch.optimize import ml_distance_matrix

    model = _get_model(args.model)
    aln = _read_aln(args.alignment)
    d = _on_card(ml_distance_matrix, aln, model,
                 params=_json_params(args.params), device=args.device)
    tree = neighbor_joining(d, list(aln))
    ll = None
    if args.refine:
        from phylo_utils_tpu_torch.batched import nni_hill_climb

        tree, ll, _ = nni_hill_climb(tree, aln, model, ncat=args.ncat,
                                     moves=args.moves, device=args.device)
    text = write_newick(tree)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    out = {"tree": text, "loglik": ll,
           "method": "nj+" + args.moves if args.refine else "nj"}
    if args.bootstrap:
        from phylo_utils_tpu_torch.supports import bootstrap_tree_support

        bs = bootstrap_tree_support(
            tree, aln, model, n_reps=args.bootstrap,
            params=_json_params(args.params), consensus=True, tbe=True,
            device=args.device,
        )
        out["bootstrap_support"] = {
            str(int(e)): float(s)
            for e, s in zip(bs["edges"], bs["support"])
        }
        out["tbe_support"] = {
            str(int(e)): float(s)
            for e, s in zip(bs["edges"], bs["tbe"])
        }
        out["consensus_tree"] = write_newick(bs["consensus"])
        if args.out:
            with open(args.out + ".consensus", "w") as f:
                f.write(out["consensus_tree"] + "\n")
    print(json.dumps(out))
    return 0


def cmd_lmap(args) -> int:
    """Likelihood mapping: quartet-resolution diagnostic of an alignment."""
    from phylo_utils_tpu_torch.topology_tests import likelihood_mapping

    model, ncat, inv, emp, _rate_model = _parse_model_spec(args.model)
    if ncat > 1 or inv or emp:
        raise SystemExit(
            "lmap uses a plain single-rate model (drop +G/+R/+I/+F; pass "
            "explicit frequencies via --params if needed)"
        )
    out = _on_card(
        likelihood_mapping, _read_aln(args.alignment), model,
        params=(_json_params(args.params) or {}).get("model"),
        n_quartets=args.n_quartets, seed=args.seed, device=args.device,
    )
    print(json.dumps({
        "basins": out["basins"].tolist(),
        "resolved": out["resolved"],
        "star": out["star"],
        "n_quartets": int(out["points"].shape[0]),
        "points": out["points"].round(4).tolist() if args.points else None,
    }))
    return 0


def cmd_consense(args) -> int:
    """Majority-rule consensus of a newick tree sample."""
    from phylo_utils_tpu_torch.io import parse_newick_forest, write_newick
    from phylo_utils_tpu_torch.trees import majority_rule_consensus

    trees = parse_newick_forest(args.trees)
    cons = majority_rule_consensus(trees, min_freq=args.min_freq)
    text = write_newick(cons)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(json.dumps({"n_trees": len(trees), "consensus": text}))
    return 0


def _finite_or_none(v):
    """+-inf (AU's degenerate-BP d statistic) is not valid JSON."""
    if isinstance(v, list):
        return [_finite_or_none(x) for x in v]
    if isinstance(v, float) and not np.isfinite(v):
        return None
    return v


def cmd_topologies(args) -> int:
    from phylo_utils_tpu_torch.batched import TopologySetEngine
    from phylo_utils_tpu_torch.io import parse_newick_forest

    trees = parse_newick_forest(args.trees)
    model = _get_model(args.model)
    tse = _on_card(
        TopologySetEngine, trees, _read_aln(args.alignment), model,
        ncat=args.ncat, dtype=args.dtype, device=args.device,
    )
    params = _json_params(args.params)
    out = {"n_trees": len(trees)}
    if args.test:
        from phylo_utils_tpu_torch.topology_tests import (
            au_test,
            kh_test,
            sh_test,
        )

        sw = tse.sitewise_loglikelihoods(params)
        out["logliks"] = sw.sum(axis=1).tolist()
        out["best_index"] = int(np.argmax(out["logliks"]))
        which = (("kh", "sh", "au") if args.test == "all"
                 else (args.test,))
        runners = {"kh": kh_test, "sh": sh_test, "au": au_test}
        for name in which:
            res = runners[name](sw, n_boot=args.n_boot, seed=args.seed)
            out[name] = {
                k: _finite_or_none(v.tolist() if hasattr(v, "tolist") else v)
                for k, v in res.items()
            }
    else:
        lls = tse.loglikelihoods(params)
        out["logliks"] = lls.tolist()
        out["best_index"] = int(lls.argmax())
    print(json.dumps(out))
    return 0


def cmd_search(args) -> int:
    from phylo_utils_tpu_torch.batched import nni_hill_climb
    from phylo_utils_tpu_torch.io import write_newick

    best_tree, best_ll, rounds = _on_card(
        nni_hill_climb,
        _read_tree(args.tree),
        _read_aln(args.alignment),
        _get_model(args.model),
        ncat=args.ncat,
        max_rounds=args.max_rounds,
        moves=args.moves,
        verbose=args.verbose,
        device=args.device,
    )
    out = {
        "loglik": best_ll,
        "rounds": rounds,
        "tree": write_newick(best_tree),
    }
    if args.out:
        with open(args.out, "w") as f:
            f.write(out["tree"] + "\n")
    print(json.dumps(out))
    return 0


def _in_clade(tree, anc: int, leaf: int) -> bool:
    n = leaf
    while n != -1:
        if n == anc:
            return True
        n = int(tree.parent[n])
    return False


def cmd_supports(args) -> int:
    """aLRT / SH-aLRT branch supports on a fixed topology."""
    from phylo_utils_tpu_torch.io import write_newick
    from phylo_utils_tpu_torch.supports import (
        alrt_supports,
        site_concordance,
    )

    scf = None
    if args.scf:
        scf = site_concordance(
            _read_tree(args.tree), _read_aln(args.alignment),
            n_quartets=args.scf,
        )
    out = _on_card(
        alrt_supports, _read_tree(args.tree), _read_aln(args.alignment),
        _get_model(args.model), ncat=args.ncat,
        params=_json_params(args.params), n_boot=args.replicates,
        device=args.device,
    )
    tree = out["tree"]
    payload = {
        "loglik": out["loglik"],
        "tree": write_newick(tree),
        "edges": [{
            "node": int(e),
            "clade": sorted(
                n for i, n in enumerate(tree.leaf_names)
                if _in_clade(tree, int(e), i)
            ),
            "stat": float(s),
            "alrt": float(a),
            "sh_alrt": float(sh),
            "abayes": float(ab),
        } for e, s, a, sh, ab in zip(out["edges"], out["stat"],
                                     out["alrt"], out["sh_alrt"],
                                     out["abayes"])],
    }
    if scf is not None:
        payload["scf"] = {
            str(int(e)): {"scf": float(c), "sdf1": float(d1),
                          "sdf2": float(d2)}
            for e, c, d1, d2 in zip(scf["edges"], scf["scf"],
                                    scf["sdf1"], scf["sdf2"])
        }
    print(json.dumps(payload))
    return 0


def cmd_simulate(args) -> int:
    from phylo_utils_tpu_torch.io import write_fasta
    from phylo_utils_tpu_torch.simulate import simulate_alignment

    try:
        aln = simulate_alignment(
            args.seed, _read_tree(args.tree), _get_model(args.model),
            args.sites, params=_json_params(args.params), ncat=args.ncat,
            pinv=args.pinv, device=args.device,
        )
    except RuntimeError as e:       # no card behind --device cuda
        raise SystemExit(f"{e}; pass --device cpu to run on the CPU")
    text = write_fasta(aln, path=args.out)
    if not args.out:
        sys.stdout.write(text)
    return 0


def cmd_compare(args) -> int:
    from phylo_utils_tpu_torch.model_selection import compare_models

    try:
        fits = compare_models(
            _read_tree(args.tree), _read_aln(args.alignment),
            candidates=args.models.split(",") if args.models else None,
            criterion=args.criterion, max_steps=args.max_steps,
            device=args.device,
        )
    except RuntimeError as e:       # no card behind --device cuda
        raise SystemExit(f"{e}; pass --device cpu to run on the CPU")
    print(json.dumps({
        "ranked": [f.as_dict() for f in fits],
        "best": fits[0].name,
        "criterion": args.criterion,
    }))
    return 0


def cmd_partition_finder(args) -> int:
    from phylo_utils_tpu_torch.io import parse_partition_file
    from phylo_utils_tpu_torch.model_selection import partition_finder
    from phylo_utils_tpu_torch.partition import _expand_ranges

    aln = _read_aln(args.alignment)
    n_sites = len(next(iter(aln.values())))
    try:
        specs = parse_partition_file(args.subsets)
        subsets = {
            s["name"]: _expand_ranges(s["ranges"], n_sites) for s in specs
        }
        res = _on_card(
            partition_finder, _read_tree(args.tree), aln, subsets,
            candidates=args.models.split(",") if args.models else None,
            criterion=args.criterion, merge=not args.no_merge,
            max_steps=args.max_steps, device=args.device,
        )
    except ValueError as e:
        raise SystemExit(str(e))
    for row in res["scheme"]:
        row["n_sites"] = len(row.pop("columns"))
    print(json.dumps(res))
    return 0


def _codon_freq_setup(aln, method):
    """(params0, base_free) for codon engines: empirical codon frequencies
    held fixed (codeml's CodonFreq convention) with kappa free, or the
    uniform default with the whole shared block free."""
    if method == "uniform":
        return None, ("branch_lengths", "shared")
    from phylo_utils_tpu_torch.models.codon import (
        empirical_codon_frequencies,
    )

    f = empirical_codon_frequencies(aln, method)
    return ({"shared": {"freqs": f.tolist()}},
            ("branch_lengths", "shared.kappa"))


def cmd_site_test(args) -> int:
    """codeml-style site-model positive-selection LRTs (M1a/M2a, M7/M8)."""
    from phylo_utils_tpu_torch.io import encode_codon_alignment
    from phylo_utils_tpu_torch.mixtures import (
        M1aEngine,
        M2aEngine,
        M7Engine,
        M8Engine,
        beb_site_posteriors,
        m1a_m2a_test,
        omega_posteriors,
        positive_selection_test,
    )
    from phylo_utils_tpu_torch.optimize import fit

    if args.beb and args.test != "m1a-m2a":
        raise SystemExit("--beb requires --test m1a-m2a (M2a BEB)")
    tree = _read_tree(args.tree)
    aln = _read_aln(args.alignment)
    ca = encode_codon_alignment(aln)
    kw = {"dtype": args.dtype, "pruner": args.pruner, "device": args.device}
    # codeml convention: codon frequencies fixed at their empirical
    # estimate (CodonFreq); kappa free through the dotted parameter name
    params0, base_free = _codon_freq_setup(aln, args.codon_freqs)
    if args.test == "m1a-m2a":
        null_cls, alt_cls, extra = M1aEngine, M2aEngine, {}
        free = base_free + ("proportions", "omega0")
        alt_free, test = free + ("omega2_delta",), m1a_m2a_test
    else:
        null_cls, alt_cls, extra = M7Engine, M8Engine, {"ncat": args.ncat}
        free = base_free + ("beta_p", "beta_q")
        alt_free, test = free + ("p0", "omega_delta"), positive_selection_test
    try:
        null = null_cls(tree, ca, **extra, **kw)
    except RuntimeError as e:       # no card behind --device cuda
        raise SystemExit(f"{e}; pass --device cpu to run on the CPU")
    res_null = fit(null, params0=params0, free=free,
                   max_steps=args.max_steps)
    alt = alt_cls(tree, ca, **extra, **kw)
    res_alt = fit(alt, params0=params0, free=alt_free,
                  max_steps=args.max_steps)
    out = {
        "test": args.test,
        "loglik_null": res_null.loglik,
        "loglik_alt": res_alt.loglik,
        "lrt": test(res_null.loglik, res_alt.loglik),
        "alt_params": _to_json(res_alt.params),
    }
    if args.sites:
        # NEB site scan: the last class is the omega > 1 class in both tests
        mean_omega, gam = omega_posteriors(alt, res_alt.params)
        out["site_mean_omega"] = mean_omega.tolist()
        out["site_positive_posterior"] = gam[:, -1].tolist()
    if args.beb:
        p_pos, mean_w = beb_site_posteriors(alt, res_alt.params)
        out["beb_positive_posterior"] = p_pos.tolist()
        out["beb_mean_omega"] = mean_w.tolist()
    print(json.dumps(out))
    return 0


def _node_label(tree, nid: int) -> str:
    return tree.names[nid] or f"node{nid}"


def cmd_ancestral(args) -> int:
    from phylo_utils_tpu_torch.ancestral import (
        ancestral_posteriors,
        joint_ancestral_states,
        site_rate_posteriors,
    )
    from phylo_utils_tpu_torch.io import write_fasta
    from phylo_utils_tpu_torch.simulate import _state_chars

    engine = _build_engine(args)
    params = _json_params(args.params)
    post = ancestral_posteriors(engine, params)
    map_states = post.argmax(axis=2)
    out = {
        "n_internal_nodes": post.shape[0],
        "n_sites": post.shape[1],
        "map_states": map_states.tolist(),
        "max_posterior": post.max(axis=2).tolist(),
    }
    # MAP sequences: per-state characters from the model's alphabet
    chars = _state_chars(engine.model)
    tree = engine.tree
    seqs = {_node_label(tree, tree.n_leaves + k): "".join(chars[row])
            for k, row in enumerate(map_states)}
    out["map_sequences"] = seqs
    if args.out_fasta:
        write_fasta(seqs, path=args.out_fasta)
    if args.joint:
        joint = joint_ancestral_states(engine, params)
        out["joint_states"] = joint["states"].tolist()
        out["joint_log_prob"] = joint["log_prob"].tolist()
        jseqs = {_node_label(tree, tree.n_leaves + k): "".join(chars[row])
                 for k, row in enumerate(joint["states"])}
        out["joint_sequences"] = jseqs
        if args.out_fasta:
            # a path of its own: the marginal MAP FASTA went to out_fasta
            write_fasta(jseqs, path=args.out_fasta + ".joint")
    if args.full:
        out["posteriors"] = post.tolist()
    if args.ncat > 1:
        out["site_rate_posteriors"] = site_rate_posteriors(
            engine, params).tolist()
    print(json.dumps(out))
    return 0


def cmd_branch_site_test(args) -> int:
    """Branch-site Model A positive-selection LRT on a foreground clade."""
    from phylo_utils_tpu_torch.branch_models import (
        branch_site_test,
        mark_branches,
        mark_clade,
    )
    from phylo_utils_tpu_torch.io import encode_codon_alignment

    tree = _read_tree(args.tree)
    aln = _read_aln(args.alignment)
    ca = encode_codon_alignment(aln)
    names = args.foreground.split(",")
    fg = (mark_clade(tree, names) if args.clade and len(names) > 1
          else mark_branches(tree, names))
    params0, _ = _codon_freq_setup(aln, args.codon_freqs)
    res = _on_card(
        branch_site_test, tree, ca, fg, params0=params0,
        engine_kwargs={"dtype": args.dtype, "pruner": args.pruner,
                       "device": args.device},
        max_steps=args.max_steps,
    )
    print(json.dumps({
        "loglik_null": res["null"].loglik,
        "loglik_alt": res["alt"].loglik,
        "lrt": res["lrt"],
        "alt_params": _to_json(res["alt"].params),
    }))
    return 0


def cmd_clock_test(args) -> int:
    """Molecular-clock LRT: strict clock vs unconstrained branch lengths."""
    from phylo_utils_tpu_torch.clock import clock_test
    from phylo_utils_tpu_torch.io import write_newick

    out = _on_card(
        clock_test, _read_tree(args.tree), _read_aln(args.alignment),
        _get_model(args.model), ncat=args.ncat, max_steps=args.max_steps,
        engine_kwargs={"device": args.device},
    )
    print(json.dumps({
        "loglik_clock": out["null"].loglik,
        "loglik_unconstrained": out["alt"].loglik,
        "df": out["df"],
        "lrt": out["lrt"],
        "chronogram": write_newick(
            out["null_engine"].chronogram(out["null"].params)),
    }))
    return 0


def _calibrations(specs) -> Dict:
    """--calibrate LEAF,...=AGE | LEAF,...=MIN:MAX -> {leaves: age or
    (lo, hi)}."""
    out = {}
    for spec in specs:
        if "=" not in spec:
            raise SystemExit(
                f"--calibrate {spec!r}: expected LEAF,...=AGE or "
                "LEAF,...=MIN:MAX"
            )
        leaves, _, bounds = spec.partition("=")
        key = tuple(s.strip() for s in leaves.split(","))
        if ":" in bounds:
            lo, _, hi = bounds.partition(":")
            out[key] = (float(lo) if lo else None, float(hi) if hi else None)
        else:
            out[key] = float(bounds)
    return out


def cmd_date(args) -> int:
    """Penalized-likelihood dating: relative, CV-lambda, or calibrated."""
    from phylo_utils_tpu_torch.clock import (
        cross_validate_lambda,
        penalized_likelihood_dating,
    )
    from phylo_utils_tpu_torch.io import write_newick

    tree = _read_tree(args.tree)
    calibrations = _calibrations(args.calibrate)
    lam, cv = args.lam, None
    if args.cv_lambda:
        grid = tuple(float(x) for x in args.cv_lambda.split(","))
        cv = _on_card(cross_validate_lambda, tree, args.sites, lambdas=grid,
                      root_age=args.root_age, steps=args.steps,
                      device=args.device)
        lam = cv["lambda"]
    out = _on_card(
        penalized_likelihood_dating, tree, args.sites,
        root_age=args.root_age, lam=lam, steps=args.steps,
        calibrations=calibrations or None, device=args.device,
    )
    payload = {
        "lambda": lam,
        "ages": {str(k): v for k, v in out["ages"].items()},
        "max_calibration_violation": out["max_calibration_violation"],
        "objective": out["objective"],
        "chronogram": write_newick(out["chronogram"]),
    }
    if cv is not None:
        payload["cv_scores"] = {str(k): v for k, v in cv["scores"].items()}
    print(json.dumps(payload))
    return 0


def cmd_serve(args) -> int:
    from phylo_utils_tpu_torch.server import serve

    serve(_build_engine(args), host=args.host, port=args.port)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="phylo_utils_tpu_torch",
        description="phylogenetic likelihood engine on an NVIDIA GPU "
                    "(PyTorch port of phylo_utils_tpu)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("loglik", help="compute log-likelihood")
    _add_engine_args(p)
    p.add_argument("--sitewise", action="store_true")
    p.set_defaults(fn=cmd_loglik)

    p = sub.add_parser("fit", help="optimize branch lengths + model params")
    _add_engine_args(p)
    p.add_argument("--max-steps", type=int, default=500)
    p.add_argument("--steps-per-call", type=int, default=10,
                   help="steps between two checks of the stopping rule "
                        "and the checkpoint schedule")
    p.add_argument("--free", help="comma-separated free parameter names")
    p.add_argument("--checkpoint", help="write final params checkpoint here "
                   "(with --checkpoint-every: resumable full optimizer "
                   "state, written periodically)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint cadence in optimizer steps (0 = only "
                        "final params)")
    p.add_argument("--resume", help="resume from checkpoint (full-state "
                   "checkpoints resume bit-exactly incl. optimizer state)")
    p.add_argument("--metrics", help="JSONL metrics path")
    p.add_argument("--se", action="store_true",
                   help="report asymptotic standard errors (observed "
                        "information)")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("distances", help="pairwise ML distance matrix")
    p.add_argument("--alignment", required=True)
    p.add_argument("--model", default="JC69")
    p.add_argument("--params", help="JSON model params")
    p.add_argument("--format", default="json", choices=["json", "phylip"])
    _add_device_arg(p)
    p.set_defaults(fn=cmd_distances)

    p = sub.add_parser("ancestral", help="ancestral state reconstruction")
    _add_engine_args(p)
    p.add_argument("--full", action="store_true",
                   help="emit full posterior tensors (large)")
    p.add_argument("--out-fasta", dest="out_fasta",
                   help="write MAP ancestral sequences as FASTA here")
    p.add_argument("--joint", action="store_true",
                   help="also run JOINT ML reconstruction (Pupko 2000 "
                        "max-product DP); with --out-fasta the joint "
                        "sequences go to <out>.joint")
    p.set_defaults(fn=cmd_ancestral)

    p = sub.add_parser("bootstrap", help="bootstrap logL replicates")
    _add_engine_args(p)
    p.add_argument("--replicates", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--full", action="store_true", help="emit all replicates")
    p.set_defaults(fn=cmd_bootstrap)

    p = sub.add_parser("build-tree", help="de novo: ML distances -> NJ")
    p.add_argument("--alignment", required=True)
    p.add_argument("--model", default="JC69")
    p.add_argument("--ncat", type=int, default=1)
    p.add_argument("--params", help="JSON model params")
    p.add_argument("--refine", action="store_true",
                   help="NNI/SPR hill-climb from the NJ tree")
    p.add_argument("--moves", default="nni", choices=["nni", "spr", "both"])
    p.add_argument("--out", help="write newick here")
    p.add_argument("--bootstrap", type=int, default=0, metavar="B",
                   help="B Felsenstein bootstrap replicates: per-edge "
                        "supports + majority-rule consensus tree "
                        "(written to <out>.consensus)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_build_tree)

    p = sub.add_parser("lmap",
                       help="likelihood mapping (quartet resolution "
                            "diagnostic, Strimmer-von Haeseler)")
    p.add_argument("--alignment", required=True)
    p.add_argument("--model", default="JC69")
    p.add_argument("--params", help="JSON params ({'model': {...}})")
    p.add_argument("--n-quartets", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--points", action="store_true",
                   help="include the simplex points in the output")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_lmap)

    p = sub.add_parser("consense",
                       help="majority-rule consensus of a tree sample")
    p.add_argument("--trees", required=True,
                   help="newick file with multiple ';'-separated trees")
    p.add_argument("--min-freq", type=float, default=0.5,
                   help="keep splits in MORE than this fraction (>=0.5)")
    p.add_argument("--out", help="write consensus newick here")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_consense)

    p = sub.add_parser("topologies",
                       help="score a set of candidate trees in one pass")
    p.add_argument("--trees", required=True,
                   help="newick file with multiple ';'-separated trees")
    p.add_argument("--alignment", required=True)
    p.add_argument("--model", default="GTR")
    p.add_argument("--ncat", type=int, default=1)
    p.add_argument("--params", help="JSON params")
    p.add_argument("--dtype", default=None)
    p.add_argument("--test", choices=["kh", "sh", "au", "all"],
                   help="RELL topology significance test(s) to run")
    p.add_argument("--n-boot", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_topologies)

    p = sub.add_parser("search", help="greedy NNI/SPR tree search")
    p.add_argument("--tree", required=True, help="starting tree")
    p.add_argument("--alignment", required=True)
    p.add_argument("--model", default="GTR")
    p.add_argument("--ncat", type=int, default=1)
    p.add_argument("--moves", default="nni", choices=["nni", "spr", "both"])
    p.add_argument("--max-rounds", type=int, default=20)
    p.add_argument("--out", help="write best tree (newick) here")
    p.add_argument("--verbose", action="store_true")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser("simulate", help="simulate an alignment")
    p.add_argument("--tree", required=True)
    p.add_argument("--model", default="JC69")
    p.add_argument("--sites", type=int, required=True)
    p.add_argument("--ncat", type=int, default=1)
    p.add_argument("--pinv", type=float, default=0.0)
    p.add_argument("--params", help="JSON params")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", help="output FASTA path (default stdout)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("benchmark", help="pruning throughput")
    _add_engine_args(p)
    p.add_argument("--iters", type=int, default=30)
    p.set_defaults(fn=cmd_benchmark)

    p = sub.add_parser("serve", help="HTTP inference server for one engine")
    _add_engine_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("compare", help="model selection (AIC/AICc/BIC)")
    p.add_argument("--tree", required=True)
    p.add_argument("--alignment", required=True)
    p.add_argument("--models", help="comma list, e.g. JC69,HKY85+G,GTR+G+I")
    p.add_argument("--criterion", default="bic",
                   choices=["aic", "aicc", "bic"])
    p.add_argument("--max-steps", type=int, default=200)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser(
        "partitionfinder",
        help="best model per subset + greedy scheme merging "
             "(PartitionFinder-style)",
    )
    p.add_argument("--tree", required=True)
    p.add_argument("--alignment", required=True)
    p.add_argument("--subsets", required=True,
                   help="partition file defining the INITIAL subsets "
                        "(RAxML lines or NEXUS charsets; models in the "
                        "file are ignored: selection picks them)")
    p.add_argument("--models", help="comma list of candidate model strings")
    p.add_argument("--criterion", default="bic",
                   choices=["aic", "aicc", "bic"])
    p.add_argument("--no-merge", action="store_true",
                   help="only pick per-subset models; skip greedy merging")
    p.add_argument("--max-steps", type=int, default=200)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_partition_finder)

    p = sub.add_parser(
        "site-test",
        help="positive-selection LRT over sites (codeml M1a/M2a, M7/M8)",
    )
    p.add_argument("--tree", required=True)
    p.add_argument("--alignment", required=True,
                   help="in-frame codon alignment (FASTA/PHYLIP)")
    p.add_argument("--test", default="m1a-m2a",
                   choices=["m1a-m2a", "m7-m8"])
    p.add_argument("--ncat", type=int, default=10,
                   help="beta discretization classes (m7-m8)")
    p.add_argument("--max-steps", type=int, default=200)
    p.add_argument("--sites", action="store_true",
                   help="emit the per-site NEB positive-selection scan")
    p.add_argument("--beb", action="store_true",
                   help="emit the BEB site scan (Yang-Wong-Nielsen 2005; "
                        "m1a-m2a only)")
    p.add_argument("--codon-freqs", default="f3x4",
                   choices=["f3x4", "f1x4", "f61", "uniform"],
                   help="empirical codon frequencies, held fixed "
                        "(codeml CodonFreq; 'uniform' frees the whole "
                        "shared block instead)")
    p.add_argument("--dtype", default=None)
    p.add_argument("--pruner", default="torch", choices=["torch", "cuda"])
    _add_device_arg(p)
    p.set_defaults(fn=cmd_site_test)

    p = sub.add_parser(
        "branch-site-test",
        help="branch-site Model A LRT (foreground lineage selection)",
    )
    p.add_argument("--tree", required=True)
    p.add_argument("--alignment", required=True,
                   help="in-frame codon alignment (FASTA/PHYLIP)")
    p.add_argument("--foreground", required=True,
                   help="comma-separated node names marking foreground edges")
    p.add_argument("--clade", action="store_true",
                   help="treat --foreground names as a clade (mark the whole "
                        "subtree under their MRCA)")
    p.add_argument("--codon-freqs", default="f3x4",
                   choices=["f3x4", "f1x4", "f61", "uniform"],
                   help="empirical codon frequencies, held fixed "
                        "(codeml CodonFreq; 'uniform' frees the whole "
                        "shared block instead)")
    p.add_argument("--max-steps", type=int, default=200)
    p.add_argument("--dtype", default=None)
    p.add_argument("--pruner", default="torch", choices=["torch", "cuda"])
    _add_device_arg(p)
    p.set_defaults(fn=cmd_branch_site_test)

    p = sub.add_parser(
        "clock-test",
        help="molecular-clock LRT (strict clock vs free branch lengths)",
    )
    p.add_argument("--tree", required=True)
    p.add_argument("--alignment", required=True)
    p.add_argument("--model", default="GTR")
    p.add_argument("--ncat", type=int, default=1)
    p.add_argument("--max-steps", type=int, default=200)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_clock_test)

    p = sub.add_parser(
        "date",
        help="penalized-likelihood divergence dating (Sanderson/r8s)",
    )
    p.add_argument("--tree", required=True,
                   help="fitted phylogram (lengths in subs/site)")
    p.add_argument("--sites", type=int, required=True,
                   help="alignment length the phylogram was fitted on")
    p.add_argument("--lam", type=float, default=1.0,
                   help="rate-autocorrelation smoothing strength")
    p.add_argument("--cv-lambda", default=None,
                   help="comma list of lambdas: pick by Sanderson "
                        "cross-validation instead of --lam")
    p.add_argument("--root-age", type=float, default=1.0,
                   help="relative-mode root age (ignored with --calibrate)")
    p.add_argument("--calibrate", action="append", default=[],
                   metavar="LEAF,LEAF,...=AGE | LEAF,...=MIN:MAX",
                   help="absolute age (or min:max interval) for the MRCA "
                        "of the listed leaves; repeatable")
    p.add_argument("--steps", type=int, default=2000)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_date)

    p = sub.add_parser(
        "supports", help="aLRT / SH-aLRT branch supports (NNI-based)"
    )
    p.add_argument("--tree", required=True)
    p.add_argument("--alignment", required=True)
    p.add_argument("--model", default="GTR")
    p.add_argument("--ncat", type=int, default=1)
    p.add_argument("--params", help="JSON model params (held fixed)")
    p.add_argument("--replicates", type=int, default=1000,
                   help="RELL replicates for SH-aLRT")
    p.add_argument("--scf", type=int, default=0, metavar="Q",
                   help="also report site concordance factors from Q "
                        "sampled quartets per branch (IQ-TREE --scf)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_supports)

    for name, item in NOT_PORTED.items():
        p = sub.add_parser(name, help=f"not ported yet (ROADMAP {item})")
        p.set_defaults(fn=lambda args, name=name, item=item: _not_ported(
            f"the {name!r} subcommand", item))

    args, rest = ap.parse_known_args(argv)
    if rest and args.cmd not in NOT_PORTED:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
