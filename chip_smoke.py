#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``phylo_utils_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It builds the
CUDA kernels from ``phylo_utils_tpu_torch/csrc`` (one ``nvcc`` per source,
all at once) and runs, in order, printing one line per phase:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the ``nvcc`` build, with its wall time: the library of every kernel and
   B8's libraries for three topologies (the flagship at 4 states, config 4
   at 20, phase 27's vertebrate-mito tree at 64), all at once; any ptxas
   spill fails it;
3. the forward kernel (the classic walk) against its plain-PyTorch walk on
   the card, at the flagship shapes (64 taxa, 4 categories, 1024 and 1000
   sites, B = 1 and 64), on a 512-taxon caterpillar tree, and at 20 states
   (LG) on BASELINE config 4's 32-taxon shape and the 512-taxon protein
   tree at 8192 patterns (whose live rows outgrow shared memory), and bit
   for bit against itself with 0 and 1 of its live rows in shared memory;
4. the flagship engine (64 taxa, 1024 sites, GTR+G4+I, f32 ``pruner="cuda"``)
   against the port's own f64 ``pruner="torch"`` path, single and batched;
5. the same at 64 taxa x 100,000 sites;
6. ``EngineServer`` on localhost answering /health, /loglik, /sitewise and
   /bootstrap with the engine's values;
7. the saveall kernel against its plain version at phase 3's shapes and on
   the wide-node tree (a root of 48 leaf children beside a 48-taxon
   subtree, kept whole, 8192 patterns simulated down it) at 4 and 20
   states, its root row bit-identical to the forward kernel's root, with
   the count of rows whose product underflowed before its rescale;
8. the reverse kernel against its plain version at the same shapes (dP and
   the leaves' cotangent), dP bit-identical across two launches, the
   root's dP row zero;
9. flagship ``value_and_grad`` (f32 ``pruner="cuda"``) against the f64
   ``pruner="torch"`` autograd: B = 1, a batch of 64 branch-length sets,
   and 64 taxa x 100,000 sites; a value call then launches only the forward
   kernel;
10. ``optimize.fit`` at BASELINE config 5's shape (128 taxa, GTR+G4, 1024
    sites simulated on the tree, every parameter free), 15 L-BFGS steps;
    its logL rises, equals the engine's at the returned params, and agrees
    with the f64 engine there;
11. the server's /gradient and /fit against the engine and ``fit``;
12. the slot and stream kernels against their plain version and bit for
    bit against the forward kernel, at 4 and 20 states, on the 1000-taxon
    DNA and 512-taxon protein trees (8192 patterns), the 512-taxon
    caterpillar and the wide-node tree (the stream kernel there at 4
    states only), the slot kernel also with 0 and 1 of its slots in shared
    memory;
13. BASELINE config 4: 32-taxon LG and WAG +G4 at 1024 patterns, f32
    ``pruner="cuda"`` (the classic walk at 20 states) against the f64 path;
14. big DNA: a 1000-taxon GTR+G4 engine at 8192 patterns, whose value
    calls (``loglikelihood``, ``sitewise_loglikelihoods``,
    ``loglikelihood_many`` at B = 16) take the slot walk, against the f64
    path, and the value calls' times;
15. big protein: a 512-taxon LG+G4 engine at 8192 patterns, whose
    ``loglikelihood`` takes the stream walk and whose ``value_and_grad``
    runs the saveall and reverse kernels at 20 states, against the f64
    path and autograd; ``EngineServer`` answers /loglik and /gradient;
    the engine's ``loglikelihood`` and ``value_and_grad`` times;
16. each kernel's time against its plain version's (CUDA events, in turns:
    plain, kernel, kernel, plain) and its bound, the three forward walks
    (classic, slot, stream) in turns at the flagship from B = 1 to 64, at
    config 4 and at both big shapes, the engine's evaluation and
    ``value_and_grad`` times with each pruner, and fit steps per second;
    the reverse kernel's walk and dP pass apart, the reverse and stream
    kernels at B = 1, and the forward and slot kernels at the flagship
    (B = 1 and 64), config 4 and big DNA, by device time per call from
    ``torch.profiler``;
17. the classic reverse kernel (B7) against its plain version (dP to
    9.5e-7 x max|dP|) and against the deferred reverse (B3) on the same
    residuals and seed (dleaf bit for bit), at phase 3's shapes and on the
    wide-node tree (B3 only at 4 states: its stage cannot hold 49 children
    at 20), with dleaf on and off and with two seeds; dP bit-identical
    across two launches; B3 and B7 timed in turns at each shape, with each
    one's scratch;
18. flagship ``value_and_grad`` and ``value_and_grad_many`` under
    ``PHYLO_DEFERRED_VJP=0`` against the f64 autograd: B7 runs, B3 not;
19. the full-width gradient: 1000 taxa x 80,000 random LG+G4 patterns,
    whose whole-tree gy store (51 GB) B3 no longer keeps, so
    ``value_and_grad`` takes B3 under "auto", and B7 under
    ``PHYLO_DEFERRED_VJP=0``; values against the f64 path on 4 pattern
    slices, B3's gradient against B7's; kernel times and peak memory;
20. the uncertainty path: ``standard_errors`` at phase 10's fitted config-5
    params under B3 and under B7, ``ml_distance_matrix`` and
    ``neighbor_joining`` on the card against the CPU, and the CLI's ``fit
    --se`` and ``build-tree`` as subprocesses against the same calls made
    in this process;
21. the fold kernel (B9) against its plain version and bit for bit against
    the forward kernel (B1), with 0, 1 and all of its rows in shared
    memory: the DNA pack (F = 2) at the flagship, B = 1 and 64, F = 2 and
    fold "auto" at config 4, "auto" on a 16-class LG profile mixture's P
    (32 taxa x 512 patterns), every compiled F at every compiled lane
    count (12 categories at 4 states, 60 at 20), and the wide-node tree at
    4 and 20 states, with its count of underflowed root rows beside B1's;
    B1, the slot kernel (B4) and B9 in turns; B9's device time per launch
    at B = 1 and config 4 from ``torch.profiler``;
22. the topology-compiled kernel (B8) the same way at every compiled lane
    count, at the flagship (B = 1 and 64, S = 4), config 4 (S = 20) and
    the wide-node tree (S = 4), with the build seconds of each topology
    (the flagship's and config 4's built in phase 2 beside the main
    library, the wide node's here; ptxas spills nothing in any library)
    and a second call with the same topology that builds
    nothing; B1, B4 and B8 in turns, B8's device time at B = 1 and config
    4;
23. the engine's value calls under each knob: ``loglikelihood`` and
    ``sitewise_loglikelihoods`` at the flagship under
    ``PHYLO_STATIC_UNROLL_MAX`` (B8) and ``PHYLO_PACK_DNA=1`` (B9), at
    config 4 under ``PHYLO_FOLD_CATEGORIES=auto`` (B9), against the f64
    path; B1 does not run, and with the knobs unset it does; each
    ``loglikelihood`` timed with its knob off and on, in turns;
24. the mixture path at full width: a ``ProfileMixtureEngine`` with LG and
    20 seeded Dirichlet profiles (a C20-shaped mixture) on a 100-taxon
    tree, 10,000 amino-acid sites simulated under the mixture here, f32
    ``pruner="cuda"`` (value calls through the stream walk, gradients
    through the plain backward): logL, sitewise, ``category_posteriors``
    and ``value_and_grad`` against the f64 ``pruner="torch"`` engine (the
    gradient over pattern slices), 3 fit steps, times and peak memory; and
    a 4-class HKY85 kappa ``ModelMixtureEngine`` on the flagship tree;
25. the CLI's ``loglik --profile-mixture FILE.nex:NAME`` in process, on a
    ``models.nex`` written from phase 24's profiles, against the engine;
26. the wide-node tree at 20 states (LG+G4, 8192 patterns) through
    ``make_fused_loglik_fn`` on its schedule compiled with
    ``binarize=False``, value and gradient under "auto": B2 and B7 run,
    B3 not (its stage cannot hold the root's 49 children); logL to 1e-6
    and dP, dfreqs to 5e-4 x max against the f64 plain pruner's autograd;
    its time and peak memory; and the engine on the same tree and sites,
    which splits the root into binary pseudo-nodes and runs B2 and B3;
27. codon at full width: GY94+G4 with F3x4 frequencies on a 100-taxon tree,
    4096 codon patterns simulated here under the port's P (61 states,
    padded to 64 by the walk's entry points): the stream (B5), classic
    (B1), saveall (B2) and deferred reverse (B3) kernels at 64 states
    against their plain versions on the padded inputs (B1 and B5 bit for
    bit, B2's root row B1's, B3's dP to 1e-4 x max|dP| and bit-identical
    across two launches), and again on a vertebrate-mitochondrial
    alignment (60 states); the f32 ``pruner="cuda"`` engine's
    ``loglikelihood``, ``sitewise_loglikelihoods`` (2e-5 relative, the JAX
    package's f32 codon bound) and ``value_and_grad`` (5e-4 x max|g|)
    against the f64 ``pruner="torch"`` engine; value calls launch B5 at 64
    and no B1, the gradient B2 and B3 at 64; 5 L-BFGS steps with kappa,
    omega and the branch lengths free (logL rises; dN/dS == omega and
    S + N == 3 per ``dn_ds_by_branch``); the other four kernels at 64
    states: B4 (codon shape) and B8 and B9 with F = 2 (the
    vertebrate-mito shape, within the classic budget) bit for bit against
    B1, B7 against its plain version (one and two seeds) and B3 (dleaf bit
    for bit, dP bit for bit where every block walks one tile), B7's blocks
    a launch in turns; the engine under the knobs (counted): value calls
    through B4 under ``PHYLO_FORCE_STREAM=0``, the gradient through B2 + B7
    under ``PHYLO_DEFERRED_VJP=0``, the mito engine's values through B8
    (``PHYLO_STATIC_UNROLL_MAX``) and B9 (``PHYLO_FOLD_CATEGORIES=auto``)
    with streaming off; B5 and B1 in turns, each 64-state kernel's time in
    turns with its plain version, device time and bound, the engine's
    times and peak memory;
28. the Mk family and the ascertainment engine: MK2 with the lewis
    correction on the flagship tree over 1024 simulated variable binary
    characters (2 states padded to 4), MK6 and ORDERED5 (padded to 20) and
    MK24 (padded to 64), f32 ``pruner="cuda"`` against the f64 path (logL
    to 1e-6, gradients to 5e-4 x max|g|); the CLI's ``loglik --model MK2
    --asc lewis`` and ``fit --model GY94`` as subprocesses against the same
    calls made in this process;
29. codon at full width: GY94+G4 (F3x4) on a 1000-taxon tree x 24,000
    codon patterns simulated on the card (a ``torch.Generator``), whose
    deferred reverse's dP rows (B3: one 64 x 64 row per node per 64-site
    block, ~49 GB) no longer fit beside the leaves and residuals, so
    ``value_and_grad`` under "auto" takes B2 and B7 and no B3; its value
    and gradient against the same engine summed over 4 pattern slices,
    which take B3 (logL to 1e-6 relative, gradients to 5e-4 x max|g|); the
    reckoned scratch, its time, device times and peak memory.

Every check raises, so any failure exits non-zero without the final line.
The launch counts are set to 0 just before each path and read just after
it: phases 4-6 (serving), 9-11 (gradient and fit), 13, 14, 15, 18-20 and
23-29; the kernel-against-plain phases are not counted. The last two lines
are a JSON record of the kernels, each with its time, its plain version's,
its bound (the larger of its bytes over 3.35 TB/s and its f32 operations
over 67 TFLOP/s, the H100 SXM data sheet's peaks) and its main-path
launches (also by state count), and the same at 64 states
(``states_64``), and
``{"ok": true, "device": {...}}``.
"""
import concurrent.futures
import contextlib
import functools
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parent

FLAGSHIP_PARAMS = {
    "model": {"rates": [1.2, 3.1, 0.7, 0.9, 4.2, 1.0],
              "freqs": [0.3, 0.2, 0.22, 0.28]},
    "alpha": 0.5,
    "pinv": 0.1,
}
LOGL_RTOL = 1e-6          # f32 partials vs the f64 path (BASELINE metric)
# f32 walk against the f64 autograd, per gradient leaf, x max|g| (the JAX
# package holds its Pallas gradients to its XLA ones at this bound)
GRAD_TOL = 5e-4
# kernel against plain version, x max|dP|: the same f32 products, but P^T gy
# and the dP site sums are summed in another order
REVERSE_TOL = 1e-4
# the classic reverse's dP from one root seed against its plain version,
# x max|dP|: its site sums are compensated across blocks, and its first
# version came within this on an NVIDIA H100 80GB HBM3 (700 W); with two
# seeds it is held to REVERSE_TOL, as before
CLASSIC_TOL = 9.5e-7
# mixture class posteriors, f32 walk against f64, absolute: a per-class
# log-likelihood error e_k moves a posterior by gamma_k (e_k - sum_j
# gamma_j e_j), and the f32 walk's e_k is ~1e-6 at 100 taxa x 20 states
# (the full-width mixture's first run on an NVIDIA H100 80GB HBM3, 700 W,
# came to 1.005e-6)
POSTERIOR_TOL = 2e-6

# shapes (the flagship, BASELINE configs 4 and 5, the big trees)
DEVICE = "cuda"
TAXA, SITES, BATCH, BIG_SITES, CATERPILLAR = 64, 1024, 64, 100_000, 512
CONFIG5_TAXA, FIT_STEPS = 128, 15
CONFIG4_TAXA = 32
BIG_DNA_TAXA, BIG_PROTEIN_TAXA, BIG_PATTERNS, BIG_BATCH = 1000, 512, 8192, 16
# the full-width gradient (phase 19) and its reference slices
WIDE_TAXA, WIDE_PATTERNS, WIDE_SLICES = 1000, 80_000, 4
CLI_FIT_STEPS = 3
# B9's 16-class LG profile mixture shape (phase 21) and the full-width
# mixture path (phase 24): a C20-shaped profile mixture, 20 classes x 20
# states, 100 taxa x 10,000 simulated amino-acid patterns
PROFILE16_TAXA, PROFILE16_PATTERNS = 32, 512
MIXTURE_TAXA, MIXTURE_PATTERNS, MIXTURE_CLASSES = 100, 10_000, 20
MIX_FIT_STEPS, MIX_SLICES = 3, 8
BIG_DNA_PARAMS = {"model": FLAGSHIP_PARAMS["model"], "alpha": 0.5}
PROTEIN_PARAMS = {"alpha": 0.7}
AMINO = "ARNDCQEGHILKMFPSTWYV"
# the wide-node tree (phases 7, 17 and 26): a root of 48 leaf children
# beside a 48-taxon subtree, 8192 patterns simulated down it
WIDE_NODE_STAR, WIDE_NODE_SUB, WIDE_NODE_PATTERNS = 48, 48, 8192
# codon at full width (phase 27): 100 taxa x 4096 simulated codon patterns
# (GY94+G4, F3x4), 5 fit steps; the vertebrate-mitochondrial check's shape;
# the Mk characters of phase 28 and its CLI fit's codon shape
CODON_TAXA, CODON_PATTERNS, CODON_FIT_STEPS = 100, 4096, 5
# codon at full width (phase 29): a 1000-taxon tree x 24,000 simulated codon
# patterns, past B3's scratch on an 80 GB card, and its reference slices
CODON_WIDE_TAXA, CODON_WIDE_PATTERNS, CODON_WIDE_SLICES = 1000, 24_000, 4
MITO_TAXA, MITO_PATTERNS = 32, 1024
MK_CHARS, CLI_CODON_TAXA, CLI_CODON_PATTERNS = 1024, 16, 256
# f32 codon logL against f64, relative: the JAX package's own f32 codon
# bound (tests/test_codon.py)
CODON_RTOL = 2e-5
CODON_PARAMS = {"model": {"kappa": 2.4, "omega": 0.25}, "alpha": 0.6}
# H100 SXM data sheet peaks, for each kernel's bound
PEAK_BYTES_PER_S, PEAK_F32_FLOPS = 3.35e12, 67e12


def _fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def _check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


_T0 = time.perf_counter()


def _emit(phase, **fields):
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": round(time.perf_counter() - _T0, 2)}),
          flush=True)


def _caterpillar(n, brlen):
    return "(" * (n - 1) + f"t0:{brlen}" + "".join(
        f",t{i}:{brlen})" + (f":{brlen}" if i < n - 1 else "")
        for i in range(1, n)) + ";"


def _simulate_states(tree, p_edges, n_sites, freqs, rng, weights=None):
    """(n_leaves, n_sites) state indices evolved down ``tree``: ``p_edges``
    (n_nodes, K, S, S) float64 numpy transition matrices per edge and
    category; each site draws a category (uniformly, or by ``weights``),
    the root draws from ``freqs`` (S,) or, per category, (K, S)."""
    import numpy as np

    k, s = p_edges.shape[1], p_edges.shape[-1]
    states = np.zeros((tree.n_nodes, n_sites), np.int64)
    if weights is None:
        cat = rng.integers(0, k, n_sites)
    else:
        cat = rng.choice(k, n_sites, p=weights)
    if np.ndim(freqs) == 1:
        states[tree.root] = rng.choice(s, n_sites, p=freqs)
    else:
        cum = np.cumsum(np.asarray(freqs)[cat], axis=1)
        states[tree.root] = (rng.random(n_sites)[:, None] * cum[:, -1:]
                             > cum).sum(axis=1)
    for node in range(tree.n_nodes - 1, -1, -1):  # ids are post-order
        for child in tree.children[node]:
            cum = np.cumsum(p_edges[child, cat, states[node]], axis=1)
            u = rng.random(n_sites)[:, None] * cum[:, -1:]
            states[child] = (u > cum).sum(axis=1)
    return states[:tree.n_leaves]


def _simulate(tree, p_edges, n_sites, freqs, rng, weights=None,
              chars=b"ACGT"):
    """An alignment of ``_simulate_states``' sites, ``chars`` naming the
    S states."""
    import numpy as np

    codes = np.frombuffer(chars, np.uint8)[
        _simulate_states(tree, p_edges, n_sites, freqs, rng, weights)]
    return {name: codes[i].tobytes().decode()
            for i, name in enumerate(tree.leaf_names)}


def _wide_node_tree(seed=7):
    """A root of ``WIDE_NODE_STAR`` leaf children on short branches (0.002
    to 0.02: a polytomy of collapsed near-zero branches) beside a
    ``random_tree(WIDE_NODE_SUB)`` subtree: with ``binarize=False`` a node
    wider than the deferred reverse's shared-memory stage at 20 states.
    (At 0.005 to 0.05 a few of 8192 x 4 simulated LG sites' root products
    underflow f32 before the root's rescale: ROADMAP C.)"""
    import numpy as np

    from phylo_utils_tpu_torch.io import parse_newick, write_newick
    from phylo_utils_tpu_torch.trees import random_tree

    rng = np.random.default_rng(seed)
    sub = write_newick(random_tree(WIDE_NODE_SUB, seed=seed)).strip()
    star = ",".join(f"w{i}:{rng.uniform(0.002, 0.02):.4f}"
                    for i in range(WIDE_NODE_STAR))
    return parse_newick(f"({star},{sub.rstrip(';')}:0.1);")


def _wide_node_inputs(eig, rates, sites, rng, device):
    """The wide-node tree at ``eig``'s state count: (its ``WalkSchedule``
    with the wide node kept, f32 P (n_nodes, K, S, S) of its branch lengths
    x ``rates``, one-hot f32 leaves of ``sites`` sites simulated down it
    under that P, the f64 frequencies), on ``device``. Random leaves would
    underflow the root's product of 49 children in f32 before its rescale
    (ROADMAP C)."""
    import numpy as np
    import torch

    from phylo_utils_tpu_torch.ops.cuda_pruning import WalkSchedule
    from phylo_utils_tpu_torch.ops.pmatrix import transition_matrices
    from phylo_utils_tpu_torch.trees import compile_schedule

    tree = _wide_node_tree()
    t = torch.as_tensor(np.asarray(tree.lengths), dtype=torch.float64,
                        device=device)
    p64 = transition_matrices(eig, t[:, None] * rates)
    states = _simulate_states(tree, p64.cpu().numpy(), sites,
                              eig.freqs.cpu().numpy(), rng)
    leaves = np.eye(p64.shape[-1], dtype=np.float32)[states]
    return (WalkSchedule(compile_schedule(tree, binarize=False)),
            p64.float().contiguous(), torch.as_tensor(leaves, device=device),
            eig.freqs)


def _max_rel(got, want):
    """max |got - want| / max |want| over all entries."""
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-300))


def _err_to_plain(kp, ke, rp, re):
    """(max |x 2^(e - e_plain) - x_plain|, that over max |x_plain|): a walk's
    root partials and exponent counts against its plain version's (an
    exponent may differ by one at a power of two, with the partials scaled
    to compensate; rescaled partials are below 2)."""
    shifted = kp.double() * (ke - re).double().exp2()[..., None]
    abs_err = float((shifted - rp.double()).abs().max())
    return abs_err, abs_err / float(rp.double().abs().max())


def _grad_errors(got, want):
    from phylo_utils_tpu_torch.convert import flatten_params

    paths, g = flatten_params(got)
    _, w = flatten_params(want)
    return {".".join(p): _max_rel(a, b) for p, a, b in zip(paths, g, w)}


def _chunked_value_and_grad(engine_kw, ca, params, n_chunks,
                            engine_cls=None):
    """``value_and_grad`` of an engine on ``ca``, summed over engines on
    ``n_chunks`` slices of its patterns: the logL is a weighted sum over
    patterns, so value and gradient add up. The f64 ``pruner="torch"``
    autograd keeps every level's intermediates: at 512 taxa x 8192 protein
    patterns x 4 categories it ran out of an 80 GB H100's memory with 76 GB
    allocated; a slice keeps a share of that. ``engine_cls`` defaults to
    ``LikelihoodEngine``."""
    import numpy as np

    from phylo_utils_tpu_torch.io import CompressedAlignment
    from phylo_utils_tpu_torch.likelihood import LikelihoodEngine

    total, grads = 0.0, None
    for sl in np.array_split(np.arange(ca.n_patterns), n_chunks):
        part = CompressedAlignment(ca.names, ca.partials[:, sl], ca.weights[sl],
                                   np.arange(len(sl), dtype=np.int32))
        v, g = (engine_cls or LikelihoodEngine)(
            alignment=part, **engine_kw).value_and_grad(params)
        total += float(v)
        grads = g if grads is None else {
            k: ({kk: grads[k][kk] + vv for kk, vv in g[k].items()}
                if isinstance(g[k], dict) else grads[k] + g[k])
            for k in g}
    return total, grads


def _ptxas_table(log):
    """{kernel<template args>: registers, barriers, static shared memory and
    spills} of every instantiation, from ``nvcc -Xptxas -v`` output."""
    import re

    out, name, spill = {}, None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            k = re.search(r"\d((?:pruning|classic|row)_\w+?)I((?:L[ib]\d+E)+)E",
                          m.group(1))
            name = (f"{k.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', k.group(2)))}>"
                    if k else m.group(1))
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "registers" in ln and name is not None:
            out[name] = f"{ln.split(':', 1)[1].strip()}; {spill}"
            name = None
    return out


@contextlib.contextmanager
def _env(**values):
    """Runs its body with the environment variables ``values`` set (e.g.
    PHYLO_DEFERRED_VJP="0": the classic reverse; PHYLO_PACK_DNA="1"), then
    restores them."""
    prev = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _static_unroll(cuda_pruning, n):
    """Runs its body with ``cuda_pruning.STATIC_UNROLL_MAX`` (the module
    constant ``PHYLO_STATIC_UNROLL_MAX`` sets at import) at ``n``."""
    prev = cuda_pruning.STATIC_UNROLL_MAX
    cuda_pruning.STATIC_UNROLL_MAX = n
    try:
        yield
    finally:
        cuda_pruning.STATIC_UNROLL_MAX = prev


def _write_fasta(aln, path):
    with open(path, "w") as fh:
        for name, seq in aln.items():
            fh.write(f">{name}\n{seq}\n")


def _random_alignment(names, n_sites, chars, seed):
    import numpy as np

    codes = np.frombuffer(chars.encode(), np.uint8)[
        np.random.default_rng(seed).integers(0, len(chars),
                                             (len(names), n_sites))]
    return {n: codes[i].tobytes().decode() for i, n in enumerate(names)}


def _bound(kind, walk, p, leaves, want_dleaf=False):
    """(bound_ms, bound_by) of one launch of kernel ``kind`` on these
    inputs: each input read once and each output written once at the
    card's memory rate, against the walk's f32 operations at the peak f32
    rate of the CUDA cores. Operations per (batch, category, site) column:
    per child edge an S x S contraction (2 S^2) and the product (S), per
    node the rescale (2 S); the reverse walk adds P^T per internal node,
    a sibling contraction and the gy product per edge, and dP (2 S^2) per
    edge; the classic reverse recomputes y and forms dP per edge (4 S^2),
    and P^T gy (2 S^2) per edge into an internal node, and into a leaf
    only where ``want_dleaf``: without dleaf it does the deferred
    reverse's work."""
    s = leaves.shape[-1]
    cols = (p.shape[0] if p.dim() == 5 else 1) * p.shape[-3] * leaves.shape[1]
    n_int, edges = len(walk.order), int(walk.counts.sum())
    n_inner = walk.n_nodes - walk.n_leaves
    nbytes = 4 * (p.numel() + leaves.numel())
    flops = cols * (edges * (2 * s * s + s) + n_int * 2 * s)
    if kind == "saveall":
        nbytes += 4 * cols * n_inner * (s + 1)
    elif kind == "reverse":
        nbytes += 4 * (cols * n_inner * (s + 1) + cols + s + p.numel())
        flops = cols * ((n_int - 1) * 2 * s * s + edges * (4 * s * s + 3 * s))
    elif kind == "classic":     # one seed: residuals and the seed
        nbytes += 4 * (cols * n_inner * (s + 1) + cols * s + p.numel())
        into_leaves = walk.n_leaves if want_dleaf else 0
        flops = cols * ((n_int - 1 + into_leaves) * 2 * s * s
                        + edges * (4 * s * s + 3 * s))
        if want_dleaf:
            nbytes += 4 * cols * walk.n_leaves * s
    else:   # forward, slot, stream: the root and its exponent count
        nbytes += 4 * cols * (s + 1)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _cuda_ms(fn, reps):
    """Milliseconds per call of ``fn`` by CUDA events over ``reps`` calls,
    after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_us(fn, reps):
    """{kernel: {"us": device microseconds per launch, "launches": the
    launches the profiler recorded, "calls": ``reps``}} over ``reps`` calls
    of ``fn``, from torch.profiler (a B = 1 launch's CUDA events are paced
    by the host; the profiler reads each kernel's own time on the card), or
    a note where the profiler saw no device time. The time is per launch,
    each kernel's total over its recorded launches: in a process that
    profiles many windows the profiler may keep only some of a window's
    launches, and a call that runs in batch chunks launches more than once;
    "launches" against "calls" shows which."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us > 0 and any(w in ev.key for w in ("pruning", "classic",
                                                "row_walk")):
            name = ev.key.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("(")[0]
            seen = out.setdefault(name, {"total": 0.0, "launches": 0})
            seen["total"] += us
            seen["launches"] += ev.count
    return {name: {"us": v["total"] / v["launches"],
                   "launches": v["launches"], "calls": reps}
            for name, v in out.items()} or "the profiler showed no device time"


def main():
    if not (REPO / "phylo_utils_tpu_torch" / "__init__.py").is_file():
        _fail("phylo_utils_tpu_torch/ is not beside this script; run it "
              "from the root of a checkout")
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script needs a GPU")
    # full float32 products: TF32 keeps ~3 decimal digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from phylo_utils_tpu_torch import cli as port_cli
    from phylo_utils_tpu_torch import models
    from phylo_utils_tpu_torch.io import parse_newick
    from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
    from phylo_utils_tpu_torch.ops import _build, cuda_pruning
    from phylo_utils_tpu_torch.convert import flatten_params
    from phylo_utils_tpu_torch.ops.cuda_pruning import (
        WalkSchedule,
        classic_reverse_scratch,
        classic_reverse_walk,
        reverse_scratch,
        classic_reverse_walk_reference,
        fold_walk,
        forward_walk,
        forward_walk_reference,
        make_fused_loglik_fn,
        reverse_walk,
        reverse_walk_reference,
        saveall_walk,
        saveall_walk_reference,
        slot_walk_reference,
        static_walk,
    )
    from phylo_utils_tpu_torch.mixtures import ModelMixtureEngine
    from phylo_utils_tpu_torch.profile_mixtures import ProfileMixtureEngine
    from phylo_utils_tpu_torch.ops.gamma import discrete_gamma
    from phylo_utils_tpu_torch.ops.pmatrix import (
        extend_p_identity,
        transition_matrices,
    )
    from phylo_utils_tpu_torch.ops.pruning import LN2, make_prune_fn
    from phylo_utils_tpu_torch.io import (
        CompressedAlignment,
        read_alignment,
        write_newick,
    )
    from phylo_utils_tpu_torch.nj import neighbor_joining
    from phylo_utils_tpu_torch.optimize import (
        fit,
        ml_distance_matrix,
        standard_errors,
    )
    from phylo_utils_tpu_torch.server import EngineServer
    from phylo_utils_tpu_torch.trees import (
        compile_schedule,
        random_tree,
        robinson_foulds,
    )

    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    counters = ("LAUNCHES", "SLOT_LAUNCHES", "STREAM_LAUNCHES",
                "SAVEALL_LAUNCHES", "REVERSE_LAUNCHES",
                "CLASSIC_REVERSE_LAUNCHES", "STATIC_LAUNCHES",
                "FOLD_LAUNCHES")

    def reset_counts():
        for name in counters:
            setattr(cuda_pruning, name, 0)
        cuda_pruning.LAUNCHES_BY_STATES.clear()

    def read_counts():
        """{counter: launches} and {"counter@S": launches at S states}."""
        return {**{name: getattr(cuda_pruning, name) for name in counters},
                **{f"{name}@{s}": n for (name, s), n in
                   sorted(cuda_pruning.LAUNCHES_BY_STATES.items())}}

    # 1. the card ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _emit(1, device=kind, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build: the library of csrc/*.cu and B8's libraries for the
    # flagship topology at 4 states, config 4's at 20 and phase 27's
    # vertebrate-mito tree's at 64, every nvcc at once (phase 22 builds the
    # wide-node tree's)
    flagship_tree = random_tree(TAXA, seed=0)
    config4_tree = random_tree(CONFIG4_TAXA, seed=13, mean_brlen=0.2)
    mito_tree = random_tree(MITO_TAXA, seed=28)
    static_walks = {
        "flagship_S4": (WalkSchedule(compile_schedule(flagship_tree)), 4),
        "config4_S20": (WalkSchedule(compile_schedule(config4_tree)), 20),
        "mito_S64": (WalkSchedule(compile_schedule(mito_tree)), 64)}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1 + len(static_walks)) as pool:
        futures = [pool.submit(_build.load_library)] + [
            pool.submit(w.static_library, s_) for w, s_ in
            static_walks.values()]
        for fut in futures:
            fut.result()
    build_s = time.perf_counter() - t0
    info = _build.build_info()
    ptxas = _ptxas_table(info["log"])
    def b8_builds():
        """{topology: seconds, built, edges, library, ptxas} of every B8
        library built so far; raises where ptxas spilled in any."""
        out = {
            f"{b['n_int']}_internal_S{b['s']}": {
                "seconds": b["seconds"], "built": b["built"],
                "edges": b["n_edges"],
                "library": str(Path(b["path"]).relative_to(REPO)),
                "ptxas": _ptxas_table(b["log"])}
            for b in _build.static_build_info().values()}
        spilled = {name: line for b in out.values()
                   for name, line in b["ptxas"].items()
                   if " 0 bytes spill stores" not in line}
        _check(not spilled, f"ptxas spilled in B8: {spilled}")
        return out

    static_builds = b8_builds()
    spilled = {name: line for name, line in ptxas.items()
               if " 0 bytes spill stores" not in line}
    _check(not spilled, f"ptxas spilled: {spilled}")
    _emit(2, build_s=round(build_s, 3), built=info["built"],
          library=str(Path(info["path"]).relative_to(REPO)),
          library_s=info["seconds"], ptxas=ptxas,
          static_builds=static_builds)

    # 3. forward kernel vs plain walk on the card ----------------------------
    freqs = torch.tensor(FLAGSHIP_PARAMS["model"]["freqs"],
                         dtype=torch.float64, device=dev)
    eig = models.GTR.eigen(FLAGSHIP_PARAMS["model"], dtype=torch.float64,
                           device=dev)
    rates = discrete_gamma(torch.tensor(FLAGSHIP_PARAMS["alpha"],
                                        dtype=torch.float64), 4).to(dev)
    lg_eig = models.LG.eigen(dtype=torch.float64, device=dev)
    rng = np.random.default_rng(0)

    def walk_inputs(tree, sites, batch, s=4):
        """Schedule, f32 P (GTR at 4 states, LG at 20) and one-hot leaves
        with 2% all-ones rows, and the f64 frequencies of the model."""
        sched = compile_schedule(tree)
        lengths = np.asarray(tree.lengths)
        if batch > 1:
            lengths = lengths * rng.uniform(0.5, 2.0, (batch, 1))
        t = torch.as_tensor(lengths, dtype=torch.float64, device=dev)
        e = eig if s == 4 else lg_eig
        p = transition_matrices(e, t[..., None] * rates,
                                out_dtype=torch.float32)
        p = extend_p_identity(p, sched.n_nodes).contiguous()
        codes = rng.integers(0, s, (tree.n_leaves, sites))
        leaves = np.eye(s, dtype=np.float32)[codes]
        leaves[rng.random((tree.n_leaves, sites)) < 0.02] = 1.0
        return (WalkSchedule(sched), p, torch.as_tensor(leaves, device=dev),
                e.freqs)

    def site_ll(root_p, root_e, f):
        return torch.log(root_p.double() @ f) + root_e.double() * LN2

    caterpillar = parse_newick(_caterpillar(CATERPILLAR, 0.3))
    big_dna_tree = random_tree(BIG_DNA_TAXA, seed=10)
    big_protein_tree = random_tree(BIG_PROTEIN_TAXA, seed=11)
    cases = [("flagship", flagship_tree, s, b, 4)
             for b in (1, BATCH) for s in (SITES, SITES - 24)]
    cases += [(f"caterpillar{CATERPILLAR}", caterpillar, SITES, 1, 4),
              ("config4", config4_tree, SITES, 1, 20),
              (f"protein{BIG_PROTEIN_TAXA}", big_protein_tree, BIG_PATTERNS,
               1, 20)]
    max_err = 0.0
    errors, b1_rows = {}, {}
    case_inputs = {}
    for name, tree, sites, batch, s in cases:
        walk, p, leaves, f = walk_inputs(tree, sites, batch, s)
        kp, ke = forward_walk(p, leaves, walk, walk="classic")
        torch.cuda.synchronize()
        rp, re = forward_walk_reference(p, leaves, walk)
        got, want = site_ll(kp, ke, f), site_ll(rp, re, f)
        _check(bool(torch.isfinite(got).all()),
               f"{name}: non-finite kernel output")
        err = float((got - want).abs().max())
        # worst case: each internal node adds a few f32 roundings to the
        # root's relative error; the two walks round differently
        tol = len(walk.order) * 2.0 ** -21
        _check(err <= tol, f"{name} B={batch} sites={sites}: kernel vs "
               f"plain walk max |dlogL| {err:.3e} > {tol:.3e}")
        key = f"{name}_B{batch}_S{sites}"
        errors[key] = err
        max_err = max(max_err, err)
        case_inputs[key] = (walk, p, leaves, f)
        # its live rows all in device memory, and one on the SM: same bits
        b1_rows[key] = [walk.rows.n_rows, cuda_pruning.row_geometry(
            batch, p.shape[-3], sites, s, walk.rows.n_rows).smem_rows]
        for smem_rows in (0, 1):
            fp, fe = cuda_pruning._row_walk(p, leaves, walk, "forward",
                                            smem_rows=smem_rows)
            torch.cuda.synchronize()
            _check(torch.equal(fp, kp) and torch.equal(fe, ke),
                   f"{key}: B1 with {smem_rows} rows in shared memory is "
                   "not B1's root bit for bit")
    _emit(3, max_abs_err=errors, rows_and_rows_on_the_sm=b1_rows,
          forced_smem_rows_bit_identical=[0, 1])
    timing_inputs = {b: case_inputs[f"flagship_B{b}_S{SITES}"]
                     for b in (1, BATCH)}
    protein_key = f"protein{BIG_PROTEIN_TAXA}_B1_S{BIG_PATTERNS}"

    # 4. flagship engine, main path ------------------------------------------
    rng_aln = np.random.default_rng(1)
    aln = {n: "".join(rng_aln.choice(list("ACGT"), size=SITES))
           for n in flagship_tree.leaf_names}
    kw = dict(ncat=4, invariant_sites=True, device=DEVICE)
    eng = LikelihoodEngine(flagship_tree, aln, models.GTR,
                           dtype=torch.float32, pruner="cuda", **kw)
    ref = LikelihoodEngine(flagship_tree, aln, models.GTR,
                           dtype=torch.float64, pruner="torch", **kw)
    reset_counts()
    ll = eng.loglikelihood(FLAGSHIP_PARAMS)
    _check(cuda_pruning.LAUNCHES > 0, "the engine did not launch the kernel")
    ll_ref = ref.loglikelihood(FLAGSHIP_PARAMS)
    rel = abs(ll - ll_ref) / abs(ll_ref)
    _check(math.isfinite(ll) and rel <= LOGL_RTOL,
           f"flagship logL {ll} vs f64 {ll_ref}: rel {rel:.3e}")
    sw = eng.sitewise_loglikelihoods(FLAGSHIP_PARAMS)
    sw_ref = ref.sitewise_loglikelihoods(FLAGSHIP_PARAMS)
    _check(sw.shape == (SITES,) and np.isfinite(sw).all(), "bad sitewise")
    bl = np.asarray(flagship_tree.lengths) * np.random.default_rng(3).uniform(
        0.5, 2.0, (BATCH, 1))
    many = eng.loglikelihood_many(bl, FLAGSHIP_PARAMS)
    many_ref = ref.loglikelihood_many(bl, FLAGSHIP_PARAMS)
    rel_many = float(np.max(np.abs(many - many_ref) / np.abs(many_ref)))
    _check(many.shape == (BATCH,) and rel_many <= LOGL_RTOL,
           f"loglikelihood_many rel {rel_many:.3e}")
    _emit(4, loglik=ll, loglik_f64=ll_ref, rel_err=rel,
          sitewise_max_abs_err=float(np.max(np.abs(sw - sw_ref))),
          many_B64_max_rel_err=rel_many, launches=cuda_pruning.LAUNCHES)

    # 5. realistic scale: 64 taxa x 100,000 sites ----------------------------
    rng_big = np.random.default_rng(2)
    chars = np.frombuffer(b"ACGT", np.uint8)[
        rng_big.integers(0, 4, (TAXA, BIG_SITES))]
    aln_big = {n: chars[i].tobytes().decode()
               for i, n in enumerate(flagship_tree.leaf_names)}
    big = LikelihoodEngine(flagship_tree, aln_big, models.GTR,
                           dtype=torch.float32, pruner="cuda", **kw)
    big_ref = LikelihoodEngine(flagship_tree, aln_big, models.GTR,
                               dtype=torch.float64, pruner="torch", **kw)
    big.loglikelihood(FLAGSHIP_PARAMS)       # first call: caches, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ll_big = big.loglikelihood(FLAGSHIP_PARAMS)
    big_ms = 1e3 * (time.perf_counter() - t0)
    ll_big_ref = big_ref.loglikelihood(FLAGSHIP_PARAMS)
    rel_big = abs(ll_big - ll_big_ref) / abs(ll_big_ref)
    _check(math.isfinite(ll_big) and rel_big <= LOGL_RTOL,
           f"100k-site logL {ll_big} vs f64 {ll_big_ref}: rel {rel_big:.3e}")
    _emit(5, patterns=big._compressed.n_patterns, loglik=ll_big,
          loglik_f64=ll_big_ref, rel_err=rel_big, eval_ms_host=big_ms)

    # 6. server --------------------------------------------------------------
    def post(base, route, body):
        req = urllib.request.Request(
            base + route, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    srv = EngineServer(eng, port=0)
    base = f"http://127.0.0.1:{srv.start()}"
    try:
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        _check(health["status"] == "ok" and health["device_name"] == kind,
               f"bad /health {health}")
        got = post(base, "/loglik", {"params": FLAGSHIP_PARAMS})["loglik"]
        _check(abs(got - ll) <= 1e-12 * abs(ll), f"/loglik {got} != {ll}")
        got_sw = np.asarray(post(base, "/sitewise",
                                 {"params": FLAGSHIP_PARAMS})["sitewise"])
        _check(got_sw.shape == sw.shape
               and float(np.max(np.abs(got_sw - sw))) <= 1e-9,
               "/sitewise disagrees with the engine")
        boots = np.asarray(post(base, "/bootstrap",
                                {"n": 100, "seed": 4,
                                 "params": FLAGSHIP_PARAMS})["logliks"])
        want_boots = eng.bootstrap_loglikelihoods(100, FLAGSHIP_PARAMS, seed=4)
        _check(boots.shape == (100,) and np.allclose(boots, want_boots,
                                                     rtol=1e-12, atol=0),
               "/bootstrap disagrees with the engine")
    finally:
        srv.stop()
    serve_counts = read_counts()
    _emit(6, health=health, loglik=got, sitewise_n=int(got_sw.shape[0]),
          bootstrap_mean=float(boots.mean()), launches=serve_counts)

    # 7. saveall kernel vs its plain version and the forward root -----------
    # the wide-node tree, its root of 49 children kept, at 4 and 20 states
    wide_inputs = {
        f"wide_node_S{s_}": _wide_node_inputs(e_, rates, WIDE_NODE_PATTERNS,
                                              rng, dev)
        for s_, e_ in ((4, eig), (20, lg_eig))}
    b2_err, b2_max, b2_underflow = {}, 0.0, {}
    for key, (walk, p, leaves, _) in {**case_inputs, **wide_inputs}.items():
        rx, re = saveall_walk(p, leaves, walk)
        kp, ke = forward_walk(p, leaves, walk, walk="classic")
        torch.cuda.synchronize()
        row = walk.root - walk.n_leaves
        _check(torch.equal(rx[..., row, :, :], kp)
               and torch.equal(re[..., row, :], ke),
               f"{key}: the saveall root row is not the forward kernel's")
        wx, we = saveall_walk_reference(p, leaves, walk)
        # compare x 2^(e - e_plain) with x_plain: an exponent may flip by
        # one at a power of two with the partials scaled to compensate
        shifted = rx.double() * torch.exp2((re - we).double())[..., None]
        err = float((shifted - wx.double()).abs().max())
        tol = len(walk.order) * 2.0 ** -21   # rescaled partials are < 2
        _check(err <= tol and bool(torch.isfinite(rx).all()),
               f"{key}: saveall vs plain max |dx| {err:.3e} > {tol:.3e}")
        b2_err[key] = err
        b2_max = max(b2_max, err)
        # (category, site) columns whose rescaled partials lost their
        # leading bits at some node: a product of children below FLT_MIN
        # before the node's rescale (ROADMAP C)
        b2_underflow[key] = int((rx.amax(dim=-1) < 1.0).sum())
        del rx, re, wx, we, shifted
    _emit(7, max_abs_err=b2_err, root_row_equals_forward=True,
          underflowed_rows=b2_underflow,
          cmax={k: int(v[0].children.shape[1])
                for k, v in {**case_inputs, **wide_inputs}.items()})

    # 8. reverse kernel vs its plain version --------------------------------
    f32_freqs = freqs.float()
    b3_err, b3_max = {}, 0.0
    for key, (walk, p, leaves, f) in case_inputs.items():
        rx, re = saveall_walk(p, leaves, walk)
        row = walk.root - walk.n_leaves
        dot = torch.einsum("...ksi,i->...ks", rx[..., row, :, :].double(), f)
        weights = torch.as_tensor(
            rng.integers(0, 4, dot.shape[-1]), dtype=torch.float64,
            device=dev)                  # pattern weights, zeros included
        lam = (weights / dot).float().contiguous()
        f32 = f.float()
        dp, dl = reverse_walk(p, leaves, rx, re, lam, f32, walk,
                              want_dleaf=True)
        dp2, _ = reverse_walk(p, leaves, rx, re, lam, f32, walk)
        torch.cuda.synchronize()
        _check(torch.equal(dp, dp2), f"{key}: dP differs between launches")
        _check(float(dp.select(-4, walk.root).abs().max()) == 0.0,
               f"{key}: B3 wrote the root's dP row")
        wp, wl = reverse_walk_reference(p, leaves, rx, re, lam, f32, walk,
                                        want_dleaf=True)
        rel_p, rel_l = _max_rel(dp, wp), _max_rel(dl, wl)
        _check(bool(torch.isfinite(dp).all()) and rel_p <= REVERSE_TOL
               and rel_l <= REVERSE_TOL,
               f"{key}: reverse vs plain dP {rel_p:.3e}, dleaf {rel_l:.3e} "
               f"(x max|g|) > {REVERSE_TOL}")
        abs_err = float((dp.double() - wp.double()).abs().max())
        b3_err[key] = {"dP_abs": abs_err, "dP_rel_max": rel_p,
                       "dleaf_rel_max": rel_l}
        b3_max = max(b3_max, abs_err)
        del rx, re, dp, dl, dp2, wp, wl
    torch.cuda.empty_cache()
    _emit(8, errors=b3_err, deterministic=True)

    # 9. engine value_and_grad, main path -----------------------------------
    reset_counts()
    v, g = eng.value_and_grad(FLAGSHIP_PARAMS)
    _check(cuda_pruning.SAVEALL_LAUNCHES > 0
           and cuda_pruning.REVERSE_LAUNCHES > 0,
           f"value_and_grad did not run the gradient kernels: {read_counts()}")
    v_ref, g_ref = ref.value_and_grad(FLAGSHIP_PARAMS)
    rel_v = abs(float(v) - float(v_ref)) / abs(float(v_ref))
    g_err = _grad_errors(g, g_ref)
    _check(rel_v <= LOGL_RTOL and max(g_err.values()) <= GRAD_TOL,
           f"value_and_grad: value rel {rel_v:.3e}, grads {g_err}")
    vm, gm = eng.value_and_grad_many(bl, FLAGSHIP_PARAMS)
    vm_ref, gm_ref = ref.value_and_grad_many(bl, FLAGSHIP_PARAMS)
    rel_vm = float(((vm - vm_ref).abs() / vm_ref.abs()).max())
    gm_err = _grad_errors(gm, gm_ref)
    _check(rel_vm <= LOGL_RTOL and max(gm_err.values()) <= GRAD_TOL,
           f"value_and_grad_many: value rel {rel_vm:.3e}, grads {gm_err}")
    vb, gb = big.value_and_grad(FLAGSHIP_PARAMS)
    vb_ref, gb_ref = big_ref.value_and_grad(FLAGSHIP_PARAMS)
    rel_vb = abs(float(vb) - float(vb_ref)) / abs(float(vb_ref))
    gb_err = _grad_errors(gb, gb_ref)
    _check(rel_vb <= LOGL_RTOL and max(gb_err.values()) <= GRAD_TOL,
           f"100k-site value_and_grad: value rel {rel_vb:.3e}, "
           f"grads {gb_err}")
    del big, big_ref
    before = read_counts()
    eng.loglikelihood(FLAGSHIP_PARAMS)
    after = read_counts()
    _check(after["LAUNCHES"] > before["LAUNCHES"]
           and after["SAVEALL_LAUNCHES"] == before["SAVEALL_LAUNCHES"]
           and after["REVERSE_LAUNCHES"] == before["REVERSE_LAUNCHES"],
           f"a value call launched {before} -> {after}")
    _emit(9, value_rel_err=rel_v, grad_rel_err=g_err,
          many_B64_value_rel_err=rel_vm, many_B64_grad_rel_err=gm_err,
          big_value_rel_err=rel_vb, big_grad_rel_err=gb_err,
          launches=read_counts())

    # 10. fit at BASELINE config 5's shape ----------------------------------
    tree5 = random_tree(CONFIG5_TAXA, seed=5)
    true5 = {"model": {"rates": [1.3, 4.1, 0.8, 1.1, 3.7, 1.0],
                       "freqs": [0.28, 0.22, 0.24, 0.26]}, "alpha": 0.6}
    eig5 = models.GTR.eigen(true5["model"])
    p5 = transition_matrices(
        eig5, torch.as_tensor(np.asarray(tree5.lengths))[:, None]
        * discrete_gamma(torch.tensor(true5["alpha"], dtype=torch.float64),
                         4)).numpy()
    aln5 = _simulate(tree5, p5, SITES, np.asarray(true5["model"]["freqs"]),
                     np.random.default_rng(6))
    kw5 = dict(ncat=4, device=DEVICE)
    fit_eng = LikelihoodEngine(tree5, aln5, models.GTR, dtype=torch.float32,
                               pruner="cuda", **kw5)
    fit_ref = LikelihoodEngine(tree5, aln5, models.GTR, dtype=torch.float64,
                               pruner="torch", **kw5)
    start5 = fit_eng.loglikelihood()
    # warm the path: the first optimizer step of a process imports parts
    # of torch it had not loaded (seconds on the host)
    t0 = time.perf_counter()
    fit(fit_eng, max_steps=1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = fit(fit_eng, max_steps=FIT_STEPS, patience=10 ** 6)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    again = fit_eng.loglikelihood(res.params)
    ll5_ref = fit_ref.loglikelihood(res.params)
    rel5 = abs(res.loglik - ll5_ref) / abs(ll5_ref)
    _check(res.n_steps == FIT_STEPS and float(res.trace.max()) > start5
           and res.loglik > start5,
           f"fit did not raise logL: start {start5}, trace {res.trace}")
    _check(res.loglik == again,
           f"fit logL {res.loglik} != engine at its params {again}")
    _check(rel5 <= LOGL_RTOL,
           f"fit logL {res.loglik} vs f64 engine {ll5_ref}: rel {rel5:.3e}")
    _emit(10, taxa=CONFIG5_TAXA, sites=SITES, start_loglik=start5,
          fit_loglik=res.loglik, fit_loglik_f64=ll5_ref, rel_err=rel5,
          n_steps=res.n_steps, trace=res.trace.tolist(),
          first_fit_1step_s=warm_s, fit_s=fit_s,
          steps_per_s=res.n_steps / fit_s, launches=read_counts())

    # 11. server: /gradient and /fit -----------------------------------------
    srv = EngineServer(eng, port=0)
    base = f"http://127.0.0.1:{srv.start()}"
    try:
        got_g = post(base, "/gradient", {"params": FLAGSHIP_PARAMS})["gradient"]
        want_g = eng.gradient(FLAGSHIP_PARAMS)
        route_err = {k: float(np.max(np.abs(np.asarray(got_g[k])
                                            - want_g[k].cpu().numpy())))
                     for k in ("branch_lengths", "alpha", "pinv")}
        route_err.update({f"model.{k}": float(np.max(np.abs(
            np.asarray(got_g["model"][k]) - want_g["model"][k].cpu().numpy())))
            for k in ("rates", "freqs")})
        scale = max(float(t.abs().max()) for t in (
            want_g["branch_lengths"], want_g["alpha"], want_g["pinv"],
            want_g["model"]["rates"], want_g["model"]["freqs"]))
        _check(max(route_err.values()) <= 1e-12 * scale,
               f"/gradient differs from engine.gradient: {route_err}")
        fit_body = {"params": FLAGSHIP_PARAMS, "max_steps": 3,
                    "free": ["branch_lengths", "alpha", "pinv"]}
        got_fit = post(base, "/fit", fit_body)
        want_fit = fit(eng, FLAGSHIP_PARAMS, free=tuple(fit_body["free"]),
                       max_steps=3)
        again = eng.loglikelihood(got_fit["params"])
        _check(got_fit["n_steps"] == 3
               and abs(got_fit["loglik"] - want_fit.loglik) <= 1e-9 * abs(ll)
               and abs(got_fit["loglik"] - again) <= 1e-12 * abs(ll)
               and got_fit["loglik"] >= ll,
               f"/fit {got_fit['loglik']} vs fit {want_fit.loglik}, engine "
               f"at its params {again}, start {ll}")
    finally:
        srv.stop()
    grad_counts = read_counts()
    _emit(11, gradient_max_abs_diff=route_err, fit_loglik=got_fit["loglik"],
          fit_n_steps=got_fit["n_steps"], launches=grad_counts)

    # 12. slot and stream kernels vs their plain version and the forward ----
    big_dna_key = f"dna{BIG_DNA_TAXA}_B1_S{BIG_PATTERNS}"
    case_inputs[big_dna_key] = walk_inputs(big_dna_tree, BIG_PATTERNS, 1)
    slot_cases = {
        big_dna_key: case_inputs[big_dna_key],
        protein_key: case_inputs[protein_key],
        f"caterpillar{CATERPILLAR}_S4": case_inputs[
            f"caterpillar{CATERPILLAR}_B1_S{SITES}"],
        f"caterpillar{CATERPILLAR}_S20": walk_inputs(caterpillar, SITES, 1,
                                                     20),
    }
    # B4 also on the wide-node tree (its root of 49 children kept whole);
    # B5's ring of 3 x 49 P blocks fits at 4 states only
    slot_cases.update(wide_inputs)
    slot_err = {"slot": {}, "stream": {}}
    for key, (walk, p, leaves, f) in slot_cases.items():
        kp, ke = forward_walk(p, leaves, walk, walk="classic")
        rp, re = slot_walk_reference(p, leaves, walk)
        want = site_ll(rp, re, f)
        tol = len(walk.order) * 2.0 ** -21
        walks = [("slot", {}), ("slot", {"smem_rows": 0}),
                 ("slot", {"smem_rows": 1})]
        if not (key.startswith("wide_node") and leaves.shape[2] == 20):
            walks.append(("stream", {}))
        for how, forced in walks:
            if forced:
                sp, se = cuda_pruning._row_walk(p, leaves, walk, "slot",
                                                **forced)
            else:
                sp, se = forward_walk(p, leaves, walk, walk=how)
            torch.cuda.synchronize()
            _check(torch.equal(sp, kp) and torch.equal(se, ke),
                   f"{key}: the {how} walk's root {forced} is not the "
                   "forward kernel's bit for bit")
            err = float((site_ll(sp, se, f) - want).abs().max())
            _check(err <= tol, f"{key}: {how} kernel {forced} vs plain walk "
                   f"max |dlogL| {err:.3e} > {tol:.3e}")
            if not forced:
                slot_err[how][key] = err
        del kp, ke, rp, re, sp, se
    _emit(12, max_abs_err=slot_err, bit_identical_to_forward=True,
          forced_smem_rows_bit_identical=[0, 1],
          n_slots={k: v[0].slots.n_slots for k, v in slot_cases.items()})

    # 13. BASELINE config 4: LG and WAG at 32 taxa, main path ---------------
    aln4 = _random_alignment(config4_tree.leaf_names, SITES, AMINO, 12)
    reset_counts()
    config4_rel = {}
    for name in ("LG", "WAG"):
        kw4 = dict(ncat=4, device=DEVICE)
        e32 = LikelihoodEngine(config4_tree, aln4, models.get_model(name),
                               dtype=torch.float32, pruner="cuda", **kw4)
        e64 = LikelihoodEngine(config4_tree, aln4, models.get_model(name),
                               dtype=torch.float64, pruner="torch", **kw4)
        ll4, ll4_ref = (e.loglikelihood(PROTEIN_PARAMS) for e in (e32, e64))
        config4_rel[name] = abs(ll4 - ll4_ref) / abs(ll4_ref)
        _check(math.isfinite(ll4) and config4_rel[name] <= LOGL_RTOL,
               f"config 4 {name}: logL {ll4} vs f64 {ll4_ref}")
    config4_counts = read_counts()
    _check(config4_counts["LAUNCHES"] > 0
           and config4_counts["SLOT_LAUNCHES"] == 0
           and config4_counts["STREAM_LAUNCHES"] == 0,
           f"config 4 did not take the classic walk: {config4_counts}")
    _emit(13, patterns=e32._compressed.n_patterns, rel_err=config4_rel,
          launches=config4_counts)

    # 14. big DNA: 1000 taxa x 8192 patterns, slot walk, main path ----------
    aln_dna = _random_alignment(big_dna_tree.leaf_names, BIG_PATTERNS,
                                "ACGT", 14)
    kw_big = dict(ncat=4, device=DEVICE)
    dna32 = LikelihoodEngine(big_dna_tree, aln_dna, models.GTR,
                             dtype=torch.float32, pruner="cuda", **kw_big)
    dna64 = LikelihoodEngine(big_dna_tree, aln_dna, models.GTR,
                             dtype=torch.float64, pruner="torch", **kw_big)
    reset_counts()
    ll_dna = dna32.loglikelihood(BIG_DNA_PARAMS)
    sw_dna = dna32.sitewise_loglikelihoods(BIG_DNA_PARAMS)
    bl_dna = np.asarray(big_dna_tree.lengths) * np.random.default_rng(
        15).uniform(0.5, 2.0, (BIG_BATCH, 1))
    many_dna = dna32.loglikelihood_many(bl_dna, BIG_DNA_PARAMS)
    dna_counts = read_counts()
    _check(dna_counts["SLOT_LAUNCHES"] > 0 and dna_counts["LAUNCHES"] == 0,
           f"the 1000-taxon value calls did not take the slot walk: "
           f"{dna_counts}")
    ll_dna_ref = dna64.loglikelihood(BIG_DNA_PARAMS)
    rel_dna = abs(ll_dna - ll_dna_ref) / abs(ll_dna_ref)
    sw_dna_err = float(np.max(np.abs(
        sw_dna - dna64.sitewise_loglikelihoods(BIG_DNA_PARAMS))))
    many_ref = np.array([dna64.loglikelihood({**BIG_DNA_PARAMS,
                                              "branch_lengths": b})
                         for b in bl_dna])
    rel_many_dna = float(np.max(np.abs(many_dna - many_ref)
                                / np.abs(many_ref)))
    _check(math.isfinite(ll_dna) and rel_dna <= LOGL_RTOL
           and sw_dna.shape == (BIG_PATTERNS,) and np.isfinite(sw_dna).all()
           and rel_many_dna <= LOGL_RTOL,
           f"1000-taxon DNA: logL rel {rel_dna:.3e}, B={BIG_BATCH} rel "
           f"{rel_many_dna:.3e}")
    _emit(14, taxa=BIG_DNA_TAXA, patterns=dna32._compressed.n_patterns,
          loglik=ll_dna, loglik_f64=ll_dna_ref, rel_err=rel_dna,
          sitewise_max_abs_err=sw_dna_err,
          many_max_rel_err=rel_many_dna, launches=dna_counts,
          loglik_ms=_cuda_ms(lambda: dna32.loglikelihood(BIG_DNA_PARAMS), 5),
          many_ms=_cuda_ms(
              lambda: dna32.loglikelihood_many(bl_dna, BIG_DNA_PARAMS), 3))
    del dna32, dna64
    torch.cuda.empty_cache()

    # 15. big protein: 512 taxa x 8192 patterns, stream walk + gradient -----
    aln_prot = _random_alignment(big_protein_tree.leaf_names, BIG_PATTERNS,
                                 AMINO, 16)
    prot32 = LikelihoodEngine(big_protein_tree, aln_prot, models.LG,
                              dtype=torch.float32, pruner="cuda", **kw_big)
    prot64 = LikelihoodEngine(big_protein_tree, aln_prot, models.LG,
                              dtype=torch.float64, pruner="torch", **kw_big)
    reset_counts()
    ll_prot = prot32.loglikelihood(PROTEIN_PARAMS)
    _check(cuda_pruning.STREAM_LAUNCHES > 0 and cuda_pruning.LAUNCHES == 0,
           f"the 512-taxon protein logL did not take the stream walk: "
           f"{read_counts()}")
    vp, gp = prot32.value_and_grad(PROTEIN_PARAMS)
    _check(cuda_pruning.SAVEALL_LAUNCHES > 0
           and cuda_pruning.REVERSE_LAUNCHES > 0,
           f"protein value_and_grad did not run the gradient kernels: "
           f"{read_counts()}")
    srv = EngineServer(prot32, port=0)
    base = f"http://127.0.0.1:{srv.start()}"
    try:
        got_ll = post(base, "/loglik", {"params": PROTEIN_PARAMS})["loglik"]
        got_g = post(base, "/gradient",
                     {"params": PROTEIN_PARAMS})["gradient"]
    finally:
        srv.stop()
    prot_counts = read_counts()
    _check(abs(got_ll - ll_prot) <= 1e-12 * abs(ll_prot),
           f"/loglik {got_ll} != {ll_prot}")
    route_g = dict(zip(*flatten_params(got_g)))
    g_scale = max(float(g.abs().max()) for g in flatten_params(gp)[1])
    for path, g in zip(*flatten_params(gp)):
        diff = np.max(np.abs(np.asarray(route_g[path])
                             - g.double().cpu().numpy()))
        _check(diff <= 1e-12 * g_scale,
               f"/gradient {'.'.join(path)} differs from value_and_grad by "
               f"{diff:.3e}")
    ll_prot_ref = prot64.loglikelihood(PROTEIN_PARAMS)
    rel_prot = abs(ll_prot - ll_prot_ref) / abs(ll_prot_ref)
    del prot64
    vp_ref, gp_ref = _chunked_value_and_grad(
        dict(tree=big_protein_tree, model=models.LG, dtype=torch.float64,
             pruner="torch", **kw_big),
        prot32._compressed, PROTEIN_PARAMS, 16)
    rel_vp = abs(float(vp) - vp_ref) / abs(vp_ref)
    gp_err = _grad_errors(gp, gp_ref)
    _check(math.isfinite(ll_prot) and rel_prot <= LOGL_RTOL
           and rel_vp <= LOGL_RTOL and max(gp_err.values()) <= GRAD_TOL,
           f"512-taxon protein: logL rel {rel_prot:.3e}, value rel "
           f"{rel_vp:.3e}, grads {gp_err}")
    _emit(15, taxa=BIG_PROTEIN_TAXA, patterns=prot32._compressed.n_patterns,
          loglik=ll_prot, loglik_f64=ll_prot_ref, rel_err=rel_prot,
          value_rel_err=rel_vp, grad_rel_err=gp_err, launches=prot_counts,
          loglik_ms=_cuda_ms(lambda: prot32.loglikelihood(PROTEIN_PARAMS), 5),
          value_and_grad_ms=_cuda_ms(
              lambda: prot32.value_and_grad(PROTEIN_PARAMS), 3))
    del prot32, vp, gp, vp_ref, gp_ref
    torch.cuda.empty_cache()

    # 16. timing --------------------------------------------------------------
    def in_turns(kernel, plain, reps, plain_reps):
        t = [_cuda_ms(plain, plain_reps), _cuda_ms(kernel, reps),
             _cuda_ms(kernel, reps), _cuda_ms(plain, plain_reps)]
        return {"ms": (t[1] + t[2]) / 2, "plain_ms": (t[0] + t[3]) / 2,
                "runs": t}

    timings, b3_device = {}, {}
    grad_shapes = [(f"B{b}", timing_inputs[b], 200 if b == 1 else 50, 5)
                   for b in sorted(timing_inputs)]
    grad_shapes.append(("protein", case_inputs[protein_key], 10, 1))
    for label, (walk, p, leaves, f), reps, plain_reps in grad_shapes:
        rx, re = saveall_walk(p, leaves, walk)
        row = walk.root - walk.n_leaves
        lam = (1.0 / torch.einsum("...ksi,i->...ks",
                                  rx[..., row, :, :].double(), f)
               ).float().contiguous()
        f32 = f.float()
        timings[f"forward_{label}"] = in_turns(
            functools.partial(forward_walk, p, leaves, walk, walk="classic"),
            functools.partial(forward_walk_reference, p, leaves, walk),
            reps, plain_reps)
        timings[f"saveall_{label}"] = in_turns(
            functools.partial(saveall_walk, p, leaves, walk),
            functools.partial(saveall_walk_reference, p, leaves, walk),
            reps, plain_reps)
        timings[f"reverse_{label}"] = in_turns(
            functools.partial(reverse_walk, p, leaves, rx, re, lam, f32,
                              walk),
            functools.partial(reverse_walk_reference, p, leaves, rx, re,
                              lam, f32, walk),
            reps, max(1, plain_reps - 2))
        for what in ("forward", "saveall", "reverse"):
            timings[f"{what}_{label}"].update(zip(
                ("bound_ms", "bound_by"), _bound(what, walk, p, leaves)))
        # B3's walk and its dP pass apart, by device time per call
        b3_device[label] = _device_us(functools.partial(
            reverse_walk, p, leaves, rx, re, lam, f32, walk),
            20 if label == "B1" else 3)
        del rx, re
    # the three forward walks in turns (classic, slot, stream, stream,
    # slot, classic) at the flagship from B = 1 to 64 (5 to 330 MB of
    # classic scratch), config 4 and both big shapes: the budget of the
    # value path's choice between them
    walk_shapes = {f"flagship_B{b}": timing_inputs[b] if b in timing_inputs
                   else walk_inputs(flagship_tree, SITES, b)
                   for b in (1, 4, 16, BATCH)}
    walk_shapes["config4"] = case_inputs[f"config4_B1_S{SITES}"]
    walk_shapes["dna_big"] = case_inputs[big_dna_key]
    walk_shapes["protein_big"] = case_inputs[protein_key]
    walk_times = {}
    for label, (walk, p, leaves, _) in walk_shapes.items():
        reps = 20 if label == "flagship_B1" else 5
        fns = {how: functools.partial(forward_walk, p, leaves, walk,
                                      walk=how)
               for how in ("classic", "slot", "stream")}
        order = ["classic", "slot", "stream", "stream", "slot", "classic"]
        runs = {how: [] for how in fns}
        for how in order:
            runs[how].append(_cuda_ms(fns[how], reps))
        walk_times[label] = {
            how: {"ms": sum(t) / len(t), "runs": t}
            for how, t in runs.items()}
        dims = (p.shape[0] if p.dim() == 5 else 1, p.shape[-3],
                walk.n_nodes - walk.n_leaves, leaves.shape[1],
                leaves.shape[2])
        walk_times[label]["classic_scratch_bytes"] = math.prod(
            dims[:4]) * (dims[4] + 1) * 4
        walk_times[label]["choice"] = cuda_pruning.choose_walk(*dims)
    # B1's and B4's device time per launch at their main-path shapes
    row_device = {
        label: {how: _device_us(functools.partial(
            forward_walk, walk_shapes[label][1], walk_shapes[label][2],
            walk_shapes[label][0], walk=how), reps)
            for how in ("classic", "slot")}
        for label, reps in (("flagship_B1", 20), (f"flagship_B{BATCH}", 5),
                            ("config4", 10), ("dna_big", 3))}
    b5_device = {
        label: _device_us(functools.partial(
            forward_walk, inputs[1], inputs[2], inputs[0], walk="stream"),
            reps)
        for label, inputs, reps in (("flagship_B1", timing_inputs[1], 20),
                                    ("protein_big", case_inputs[protein_key],
                                     3))}
    for how, key in (("slot", big_dna_key), ("stream", protein_key)):
        walk, p, leaves, _ = case_inputs[key]
        timings[how] = in_turns(
            functools.partial(forward_walk, p, leaves, walk, walk=how),
            functools.partial(slot_walk_reference, p, leaves, walk), 20, 2)
        timings[how].update(zip(("bound_ms", "bound_by"),
                                _bound(how, walk, p, leaves)))
    eng_torch = LikelihoodEngine(flagship_tree, aln, models.GTR,
                                 dtype=torch.float32, pruner="torch", **kw)
    for label, e in (("cuda", eng), ("torch", eng_torch)):
        timings[f"engine_loglik_{label}_ms"] = _cuda_ms(
            lambda: e.loglikelihood(FLAGSHIP_PARAMS), 10)
        timings[f"engine_many_B64_{label}_ms"] = _cuda_ms(
            lambda: e.loglikelihood_many(bl, FLAGSHIP_PARAMS), 3)
        timings[f"engine_value_and_grad_{label}_ms"] = _cuda_ms(
            lambda: e.value_and_grad(FLAGSHIP_PARAMS), 5)
        timings[f"engine_value_and_grad_many_B64_{label}_ms"] = _cuda_ms(
            lambda: e.value_and_grad_many(bl, FLAGSHIP_PARAMS), 3)
    adam = functools.partial(torch.optim.Adam, lr=1e-2)
    fit(fit_eng, optimizer=adam, max_steps=2, patience=10 ** 6)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit(fit_eng, optimizer=adam, max_steps=20, patience=10 ** 6)
    torch.cuda.synchronize()
    timings["config5_fit_lbfgs_steps_per_s"] = res.n_steps / fit_s
    timings["config5_fit_adam_steps_per_s"] = 20 / (time.perf_counter() - t0)
    _emit(16, shapes=f"{TAXA} taxa, K=4, {SITES} sites, S=4; protein "
          f"{BIG_PROTEIN_TAXA} taxa, {BIG_PATTERNS} patterns, S=20",
          timings=timings, walks=walk_times, b3_device_us=b3_device,
          b5_device_us=b5_device, b1_b4_device_us=row_device)

    # 17. classic reverse kernel (B7) vs its plain version and B3 ----------
    b7_err, b7_max, b7_times = {}, 0.0, {}
    b7_keys = [f"flagship_B{b}_S{s_}" for b in (1, BATCH)
               for s_ in (SITES, SITES - 24)]
    b7_keys += [f"caterpillar{CATERPILLAR}_B1_S{SITES}",
                f"config4_B1_S{SITES}", protein_key, *wide_inputs]
    for key in b7_keys:
        walk, p, leaves, f = {**case_inputs, **wide_inputs}[key]
        s_, cmax = leaves.shape[2], walk.children.shape[1]
        try:    # B3 runs where its stage holds a visit's children
            cuda_pruning.reverse_tile(s_, cmax)
            has_b3 = True
        except ValueError:
            has_b3 = False
        rx, re = saveall_walk(p, leaves, walk)
        row = walk.root - walk.n_leaves
        dot = torch.einsum("...ksi,i->...ks", rx[..., row, :, :].double(), f)
        weights = torch.as_tensor(
            rng.integers(0, 4, dot.shape[-1]), dtype=torch.float64,
            device=dev)
        lam = (weights / dot).float().contiguous()
        f32 = f.float()
        gseed = (lam[..., None] * f32).unsqueeze(-3).contiguous()
        root = [walk.root]
        dp, dl = classic_reverse_walk(p, leaves, rx, re, gseed, root, walk,
                                      want_dleaf=True)
        dp2, none = classic_reverse_walk(p, leaves, rx, re, gseed, root, walk)
        torch.cuda.synchronize()
        _check(torch.equal(dp, dp2) and none is None,
               f"{key}: B7's dP differs between two launches (dleaf on, off)")
        _check(float(dp.select(-4, walk.root).abs().max()) == 0.0,
               f"{key}: B7 wrote the root's dP row")
        wp, wl = classic_reverse_walk_reference(p, leaves, rx, re, gseed,
                                                root, walk, want_dleaf=True)
        seeds = [walk.root, int(walk.order[len(walk.order) // 2])]
        g2 = torch.as_tensor(rng.uniform(
            0.5, 1.5, gseed.shape[:-3] + (2,) + gseed.shape[-2:]),
            dtype=torch.float32, device=dev)
        d2, l2 = classic_reverse_walk(p, leaves, rx, re, g2, seeds, walk,
                                      want_dleaf=True)
        d2b, _ = classic_reverse_walk(p, leaves, rx, re, g2, seeds, walk)
        torch.cuda.synchronize()
        _check(torch.equal(d2, d2b),
               f"{key}: B7's two-seed dP differs between two launches")
        w2, wl2 = classic_reverse_walk_reference(p, leaves, rx, re, g2, seeds,
                                                 walk, want_dleaf=True)
        errs = {"dP_rel_max": _max_rel(dp, wp), "dleaf_rel_max": _max_rel(dl, wl),
                "two_seed_dP_rel_max": _max_rel(d2, w2),
                "two_seed_dleaf_rel_max": _max_rel(l2, wl2)}
        _check(bool(torch.isfinite(dp).all()) and bool(torch.isfinite(d2).all())
               and errs["dP_rel_max"] <= CLASSIC_TOL
               and max(errs.values()) <= REVERSE_TOL,
               f"{key}: B7 vs plain (x max|g|) {errs} > {CLASSIC_TOL} (one "
               f"seed's dP), {REVERSE_TOL}")
        abs_err = float((dp.double() - wp.double()).abs().max())
        b7_err[key] = {"dP_abs": abs_err, "cmax": int(cmax),
                       "staged_children": cuda_pruning.classic_reverse_stage(
                           s_, cmax)[0], **errs}
        b7_max = max(b7_max, abs_err)
        reps = 50 if key.startswith("flagship_B1_") else (
            3 if key in (protein_key, "wide_node_S20") else 10)
        b7_fn = functools.partial(classic_reverse_walk, p, leaves, rx, re,
                                  gseed, root, walk)
        b, k = (p.shape[0] if p.dim() == 5 else 1), p.shape[-3]
        sites = leaves.shape[1]
        rows, slot_bytes, row_bytes = classic_reverse_scratch(
            b, k, walk.n_nodes, walk.reverse.n_gslots, sites, s_)
        b7_times[key] = {
            "b7_scratch_bytes": slot_bytes + rows * row_bytes,
            "b7_gslots": walk.reverse.n_gslots, "b7_dp_rows": rows,
            **dict(zip(("b7_bound_ms", "b7_bound_by"),
                       _bound("classic", walk, p, leaves)))}
        if has_b3:
            # B3 on the same residuals and seed: dleaf bit for bit, and
            # B3 and B7 in turns on the engine's path (one root seed, no
            # dleaf)
            d3, l3 = reverse_walk(p, leaves, rx, re, lam, f32, walk,
                                  want_dleaf=True)
            errs3 = {"vs_B3_dP_rel_max": _max_rel(dp, d3),
                     "dleaf_equals_B3": bool(torch.equal(dl, l3))}
            b7_err[key].update(errs3)
            _check(errs3["dleaf_equals_B3"]
                   and errs3["vs_B3_dP_rel_max"] <= REVERSE_TOL,
                   f"{key}: B7 against B3 {errs3}")
            b3_fn = functools.partial(reverse_walk, p, leaves, rx, re, lam,
                                      f32, walk)
            t = [_cuda_ms(b3_fn, reps), _cuda_ms(b7_fn, reps),
                 _cuda_ms(b7_fn, reps), _cuda_ms(b3_fn, reps)]
            b3_tile, b3_bytes = reverse_scratch(
                b, k, walk.n_nodes, walk.reverse.n_gslots, sites, s_, cmax)
            b7_times[key].update({
                "b3_ms": (t[0] + t[3]) / 2, "b7_ms": (t[1] + t[2]) / 2,
                "runs": t, "b3_scratch_bytes": b3_bytes, "b3_tile": b3_tile})
            del d3, l3
        else:
            b7_times[key]["b7_ms"] = _cuda_ms(b7_fn, reps)
        if key == f"flagship_B{BATCH}_S{SITES}":
            timings[f"classic_B{BATCH}"] = in_turns(
                b7_fn, functools.partial(classic_reverse_walk_reference, p,
                                         leaves, rx, re, gseed, root, walk),
                50, 3)
            timings[f"classic_B{BATCH}"].update(zip(
                ("bound_ms", "bound_by"), _bound("classic", walk, p, leaves)))
        del rx, re, dp, dl, dp2, wp, wl, d2, d2b, l2, w2, wl2
    torch.cuda.empty_cache()
    _emit(17, errors=b7_err, times=b7_times, deterministic=True,
          classic_B64=timings[f"classic_B{BATCH}"])

    # 18. flagship value_and_grad through B7, main path ----------------------
    with _env(PHYLO_DEFERRED_VJP="0"):
        reset_counts()
        v7, g7 = eng.value_and_grad(FLAGSHIP_PARAMS)
        vm7, gm7 = eng.value_and_grad_many(bl, FLAGSHIP_PARAMS)
        classic_counts = read_counts()
    _check(classic_counts["CLASSIC_REVERSE_LAUNCHES"] > 0
           and classic_counts["REVERSE_LAUNCHES"] == 0
           and classic_counts["SAVEALL_LAUNCHES"] > 0,
           f"PHYLO_DEFERRED_VJP=0 did not take B7 alone: {classic_counts}")
    rel_v7 = abs(float(v7) - float(v_ref)) / abs(float(v_ref))
    g7_err = _grad_errors(g7, g_ref)
    rel_vm7 = float(((vm7 - vm_ref).abs() / vm_ref.abs()).max())
    gm7_err = _grad_errors(gm7, gm_ref)
    _check(max(rel_v7, rel_vm7) <= LOGL_RTOL
           and max(g7_err.values()) <= GRAD_TOL
           and max(gm7_err.values()) <= GRAD_TOL,
           f"value_and_grad through B7: value rel {rel_v7:.3e} / "
           f"{rel_vm7:.3e}, grads {g7_err} {gm7_err}")
    _emit(18, value_rel_err=rel_v7, grad_rel_err=g7_err,
          many_B64_value_rel_err=rel_vm7, many_B64_grad_rel_err=gm7_err,
          launches=classic_counts)

    # 19. full width: 1000 taxa x 80,000 LG+G4 patterns, main path ---------
    wide_tree = random_tree(WIDE_TAXA, seed=10)
    walk_w = WalkSchedule(compile_schedule(wide_tree))
    n_inner_w = walk_w.n_nodes - walk_w.n_leaves
    gslots_w, cmax_w = walk_w.reverse.n_gslots, walk_w.children.shape[1]
    rows_w, slots_w, row_w = classic_reverse_scratch(
        1, 4, walk_w.n_nodes, gslots_w, WIDE_PATTERNS, 20)
    reckoned = {
        "residual_bytes": 4 * 4 * n_inner_w * WIDE_PATTERNS * 21,
        # the gy store B3 kept before it summed dP inside its walk
        "gy_store_bytes": 4 * 4 * walk_w.n_nodes * WIDE_PATTERNS * 20,
        "b3_scratch_bytes": reverse_scratch(
            1, 4, walk_w.n_nodes, gslots_w, WIDE_PATTERNS, 20, cmax_w)[1],
        "leaf_bytes": 4 * WIDE_TAXA * WIDE_PATTERNS * 20,
        "b7_scratch_bytes": slots_w + rows_w * row_w,
    }
    _emit(19, stage="reckoned", taxa=WIDE_TAXA, patterns=WIDE_PATTERNS,
          **reckoned)
    t_start = time.perf_counter()
    codes = np.random.default_rng(19).integers(
        0, 20, (WIDE_TAXA, WIDE_PATTERNS), dtype=np.uint8)
    ca_w = CompressedAlignment(
        tuple(wide_tree.leaf_names), np.eye(20, dtype=np.float32)[codes],
        np.ones(WIDE_PATTERNS), np.arange(WIDE_PATTERNS, dtype=np.int32))
    del codes
    kw_w = dict(tree=wide_tree, model=models.LG, ncat=4, device=DEVICE)
    wide = LikelihoodEngine(alignment=ca_w, dtype=torch.float32,
                            pruner="cuda", **kw_w)
    torch.cuda.synchronize()
    stage_s = {"data_and_engine": time.perf_counter() - t_start}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    vw, gw = wide.value_and_grad(PROTEIN_PARAMS)
    wide_counts = read_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    _check(wide_counts["REVERSE_LAUNCHES"] > 0
           and wide_counts["CLASSIC_REVERSE_LAUNCHES"] == 0,
           f"the full-width gradient did not take B3 under auto: "
           f"{wide_counts}")
    wide_vg_ms = _cuda_ms(lambda: wide.value_and_grad(PROTEIN_PARAMS), 1)
    # the same gradient through B7, the classic reverse
    with _env(PHYLO_DEFERRED_VJP="0"):
        reset_counts()
        vw7, gw7 = wide.value_and_grad(PROTEIN_PARAMS)
        wide7_counts = read_counts()
        wide7_vg_ms = _cuda_ms(lambda: wide.value_and_grad(PROTEIN_PARAMS), 1)
    _check(wide7_counts["CLASSIC_REVERSE_LAUNCHES"] > 0
           and wide7_counts["REVERSE_LAUNCHES"] == 0,
           f"PHYLO_DEFERRED_VJP=0 did not take B7 at full width: "
           f"{wide7_counts}")
    stage_s["gradients"] = time.perf_counter() - t_start - sum(
        stage_s.values())
    t_w = torch.as_tensor(np.asarray(wide_tree.lengths), dtype=torch.float64,
                          device=dev)
    rates_w = discrete_gamma(torch.tensor(PROTEIN_PARAMS["alpha"],
                                          dtype=torch.float64), 4).to(dev)
    p_w = extend_p_identity(transition_matrices(
        lg_eig, t_w[:, None] * rates_w, out_dtype=torch.float32),
        walk_w.n_nodes).contiguous()
    leaves_w = wide._leaf_partials
    wide_saveall_ms = _cuda_ms(lambda: saveall_walk(p_w, leaves_w, walk_w), 1)
    rx, re = saveall_walk(p_w, leaves_w, walk_w)
    b3_budget = cuda_pruning._device_budget(reckoned["b3_scratch_bytes"],
                                            dev)
    choice = cuda_pruning.choose_reverse(1, 4, walk_w.n_nodes, gslots_w,
                                         WIDE_PATTERNS, 20, dev, cmax_w)
    _check(reckoned["b3_scratch_bytes"] <= b3_budget and choice == "deferred",
           f"B3's scratch ({reckoned['b3_scratch_bytes']} bytes) does not "
           f"fit the {b3_budget} free, or auto chose {choice}")
    row = walk_w.root - walk_w.n_leaves
    lam_w = (1.0 / torch.einsum("ksi,i->ks", rx[:, row].double(),
                                lg_eig.freqs)).float().contiguous()
    f32_w = lg_eig.freqs.float()
    gseed_w = (lam_w[..., None] * f32_w).unsqueeze(-3).contiguous()
    wide_reverse_ms = _cuda_ms(functools.partial(
        reverse_walk, p_w, leaves_w, rx, re, lam_w, f32_w, walk_w), 1)
    wide_classic_ms = _cuda_ms(functools.partial(
        classic_reverse_walk, p_w, leaves_w, rx, re, gseed_w, [walk_w.root],
        walk_w), 1)
    wide_reverse_bound = _bound("reverse", walk_w, p_w, leaves_w)
    wide_classic_bound = _bound("classic", walk_w, p_w, leaves_w)
    del rx, re, wide, leaves_w, p_w
    torch.cuda.empty_cache()
    stage_s["timings"] = time.perf_counter() - t_start - sum(stage_s.values())
    vw_f64 = 0.0
    for sl in np.array_split(np.arange(WIDE_PATTERNS), WIDE_SLICES):
        part = CompressedAlignment(ca_w.names, ca_w.partials[:, sl],
                                   ca_w.weights[sl],
                                   np.arange(len(sl), dtype=np.int32))
        vw_f64 += LikelihoodEngine(alignment=part, dtype=torch.float64,
                                   pruner="torch", **kw_w).loglikelihood(
            PROTEIN_PARAMS)
    del ca_w, part
    torch.cuda.empty_cache()
    stage_s["f64_slices"] = time.perf_counter() - t_start - sum(
        stage_s.values())
    rel_vw = abs(float(vw) - vw_f64) / abs(vw_f64)
    rel_vw7 = abs(float(vw7) - vw_f64) / abs(vw_f64)
    gw_err = _grad_errors(gw, gw7)
    _check(math.isfinite(float(vw)) and max(rel_vw, rel_vw7) <= LOGL_RTOL
           and max(gw_err.values()) <= GRAD_TOL,
           f"full-width gradient: value rel {rel_vw:.3e} / {rel_vw7:.3e} vs "
           f"f64, B3 grads vs B7 {gw_err}")
    _emit(19, stage="measured", loglik=float(vw), loglik_f64=vw_f64,
          value_rel_err=rel_vw, b7_value_rel_err=rel_vw7,
          grad_rel_err_b3_vs_b7=gw_err, launches=wide_counts,
          b7_launches=wide7_counts, b3_budget_bytes=b3_budget,
          peak_allocated_bytes=peak_bytes, value_and_grad_ms=wide_vg_ms,
          b7_value_and_grad_ms=wide7_vg_ms, saveall_ms=wide_saveall_ms,
          reverse_ms=wide_reverse_ms, reverse_bound=wide_reverse_bound,
          classic_reverse_ms=wide_classic_ms,
          classic_reverse_bound=wide_classic_bound,
          b7_gslots=gslots_w, stage_s=stage_s)

    # 20. uncertainty path at config 5's shape, main path -------------------
    se_free = ("model", "alpha")
    reset_counts()
    t0 = time.perf_counter()
    se_b3 = standard_errors(fit_eng, res.params, free=se_free)
    se_b3_s = time.perf_counter() - t0
    se_b3_counts = read_counts()
    with _env(PHYLO_DEFERRED_VJP="0"):
        t0 = time.perf_counter()
        se_b7 = standard_errors(fit_eng, res.params, free=se_free)
        se_b7_s = time.perf_counter() - t0
    unc_counts = read_counts()
    _check(se_b3_counts["REVERSE_LAUNCHES"] > 0
           and se_b3_counts["CLASSIC_REVERSE_LAUNCHES"] == 0
           and unc_counts["CLASSIC_REVERSE_LAUNCHES"] > 0
           and unc_counts["REVERSE_LAUNCHES"]
           == se_b3_counts["REVERSE_LAUNCHES"],
           f"standard errors did not take B3, then B7: {se_b3_counts} "
           f"{unc_counts}")
    se_paths, se3 = flatten_params(se_b3)
    se7 = dict(zip(*flatten_params(se_b7)))
    se_rel = {}
    for path, a in zip(se_paths, se3):
        b = se7[path]
        name = ".".join(path)
        if name == "model.rates":
            # Q is normalised, so the six rates are identifiable only up to
            # scale: that direction's curvature is the differences' noise,
            # and so are these entries (reported, not compared)
            continue
        _check(np.all(np.isfinite(a)) and np.all(a > 0)
               and np.all(np.isfinite(b)) and np.all(b > 0),
               f"standard error {name} not finite and positive: {a} {b}")
        se_rel[name] = float(np.max(np.abs(a - b) / np.abs(a)))
    _check(max(se_rel.values()) <= 1e-3,
           f"standard errors under B3 and B7 differ: {se_rel}")
    sim_p = transition_matrices(
        models.GTR.eigen(FLAGSHIP_PARAMS["model"]),
        torch.as_tensor(np.asarray(flagship_tree.lengths))[:, None]
        * discrete_gamma(torch.tensor(FLAGSHIP_PARAMS["alpha"],
                                      dtype=torch.float64), 4)).numpy()
    aln_sim = _simulate(flagship_tree, sim_p, SITES,
                        np.asarray(FLAGSHIP_PARAMS["model"]["freqs"]),
                        np.random.default_rng(20))
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_",
                                     dir=build) as tmp:
        tree_path, aln5_path, sim_path = (os.path.join(tmp, n) for n in (
            "config5.nwk", "config5.fa", "flagship_sim.fa"))
        with open(tree_path, "w") as fh:
            fh.write(write_newick(tree5) + "\n")
        _write_fasta(aln5, aln5_path)
        _write_fasta(aln_sim, sim_path)
        cli = [sys.executable, "-m", "phylo_utils_tpu_torch.cli"]
        fit_cmd = cli + ["fit", "--tree", tree_path, "--alignment",
                         aln5_path, "--model", "GTR+G4", "--dtype",
                         "float32", "--pruner", "cuda", "--free",
                         ",".join(se_free), "--max-steps",
                         str(CLI_FIT_STEPS), "--se"]
        nj_cmd = cli + ["build-tree", "--alignment", sim_path, "--model",
                        "GTR", "--params",
                        json.dumps(FLAGSHIP_PARAMS["model"])]
        env = {**os.environ, "PYTHONPATH": str(REPO)}
        # the two CLI processes start (seconds of imports and CUDA set-up)
        # while this one computes the distances and the in-process twins
        t_cli = time.perf_counter()
        procs = [subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE)
                 for cmd in (fit_cmd, nj_cmd)]
        try:
            t0 = time.perf_counter()
            d_gpu = ml_distance_matrix(aln_sim, models.GTR,
                                       params=FLAGSHIP_PARAMS["model"],
                                       device=DEVICE)
            dist_gpu_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            d_cpu = ml_distance_matrix(aln_sim, models.GTR,
                                       params=FLAGSHIP_PARAMS["model"],
                                       device="cpu")
            dist_cpu_s = time.perf_counter() - t0
            dist_rel = float(np.max(np.abs(d_gpu - d_cpu))
                             / np.max(np.abs(d_cpu)))
            nj_gpu = neighbor_joining(d_gpu, list(aln_sim))
            nj_cpu = neighbor_joining(d_cpu, list(aln_sim))
            nj_rel = float(np.max(np.abs(np.asarray(nj_gpu.lengths)
                                         - np.asarray(nj_cpu.lengths))))
            _check(dist_rel <= 1e-10 and robinson_foulds(nj_gpu, nj_cpu) == 0.0
                   and nj_rel <= 1e-10,
                   f"distances on the card vs the CPU: rel {dist_rel:.3e}, "
                   f"NJ RF {robinson_foulds(nj_gpu, nj_cpu)}, lengths "
                   f"{nj_rel:.3e}")
            eng_cli = LikelihoodEngine(
                parse_newick(open(tree_path).read()),
                read_alignment(aln5_path), models.GTR, ncat=4,
                dtype=torch.float32, pruner="cuda", device=DEVICE)
            fit_cli = fit(eng_cli, None, free=se_free,
                          max_steps=CLI_FIT_STEPS, steps_per_call=10)
            se_cli = standard_errors(eng_cli, fit_cli.params, free=se_free)
            nj_text = write_newick(neighbor_joining(
                ml_distance_matrix(read_alignment(sim_path), models.GTR,
                                   params=FLAGSHIP_PARAMS["model"],
                                   device=DEVICE), list(aln_sim)))
            outs = []
            for proc in procs:
                out, err = proc.communicate(timeout=600)
                _check(proc.returncode == 0,
                       f"{' '.join(proc.args[2:4])} exited "
                       f"{proc.returncode}: {err[-2000:]}")
                outs.append(json.loads(out.strip().splitlines()[-1]))
            cli_s = time.perf_counter() - t_cli
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    cli_fit, cli_nj = outs
    cli_err = {"loglik": abs(cli_fit["loglik"] - fit_cli.loglik)
               / abs(fit_cli.loglik)}
    for label, got, want in (("params", cli_fit["params"], fit_cli.params),
                             ("se", cli_fit["standard_errors"], se_cli)):
        got_leaves = dict(zip(*flatten_params(got)))
        for path, w in zip(*flatten_params(want)):
            w = np.asarray(w.cpu() if torch.is_tensor(w) else w, np.float64)
            g = np.asarray(got_leaves[path], np.float64)
            _check(np.array_equal(np.isnan(g), np.isnan(w)),
                   f"CLI {label} {path}: nan pattern {g} vs {w}")
            ok = ~np.isnan(w)
            cli_err[f"{label}.{'.'.join(path)}"] = float(
                np.max(np.abs(g[ok] - w[ok]), initial=0.0)
                / max(np.max(np.abs(w[ok]), initial=0.0), 1e-300))
    _check(cli_fit["n_steps"] == fit_cli.n_steps
           and max(cli_err.values()) <= 1e-9 and cli_nj["tree"] == nj_text,
           f"the CLI's JSON differs from the in-process calls: {cli_err}, "
           f"tree equal {cli_nj['tree'] == nj_text}")
    _emit(20, se_free=list(se_free), se_b3_vs_b7_rel=se_rel,
          se_rates_b3=se_b3["model"]["rates"].tolist(),
          se_rates_b7=se_b7["model"]["rates"].tolist(),
          se_b3_s=se_b3_s, se_b7_s=se_b7_s, launches=unc_counts,
          distances_rel_gpu_vs_cpu=dist_rel, distances_gpu_s=dist_gpu_s,
          distances_cpu_s=dist_cpu_s, nj_lengths_max_abs_diff=nj_rel,
          nj_rf_vs_true=robinson_foulds(flagship_tree, nj_gpu),
          cli_fit_vs_in_process=cli_err, cli_wall_s=cli_s)

    # 21. fold kernel (B9) vs its plain version and bit for bit vs B1 ------
    def rate_inputs(tree, sites, k, s):
        """Schedule, f32 P of ``k`` rate categories (rates 0.1-3.0; GTR at 4
        states, LG at 20) and one-hot leaves with 2% all-ones rows."""
        sched = compile_schedule(tree)
        rates_k = torch.linspace(0.1, 3.0, k, dtype=torch.float64,
                                 device=dev)
        t = torch.as_tensor(np.asarray(tree.lengths), dtype=torch.float64,
                            device=dev)
        e = eig if s == 4 else lg_eig
        p = extend_p_identity(transition_matrices(
            e, t[:, None] * rates_k, out_dtype=torch.float32),
            sched.n_nodes).contiguous()
        leaves = np.eye(s, dtype=np.float32)[
            rng.integers(0, s, (tree.n_leaves, sites))]
        leaves[rng.random((tree.n_leaves, sites)) < 0.02] = 1.0
        return (WalkSchedule(sched), p, torch.as_tensor(leaves, device=dev),
                e.freqs)

    def underflowed(root_p):
        """(category, site) root rows whose rescaled partials lost their
        leading bits: a product of children below FLT_MIN before a node's
        rescale (ROADMAP C)."""
        return int((root_p.amax(dim=-1) < 1.0).sum())

    def lowering_checks(key, run, walk, p, leaves, lanes):
        """``run(**geometry)`` (B8 or B9) bit for bit B1 with 0, 1 and all
        of the slot walk's rows in shared memory, at each of ``lanes`` lane
        counts, and within n_int 2^-21 x max of the plain version; returns
        (B1's root, abs error, error x max)."""
        bp, be = forward_walk(p, leaves, walk, walk="classic")
        rows = walk.slots.rows.n_rows
        forced = [{}] + [{"smem_rows": m} for m in sorted({0, 1, rows})]
        forced += [{"lanes": n} for n in lanes]
        for geometry in forced:
            kp, ke = run(**geometry)
            torch.cuda.synchronize()
            _check(torch.equal(kp, bp) and torch.equal(ke, be),
                   f"{key} {geometry}: not B1's root bit for bit")
        rp, re = forward_walk_reference(p, leaves, walk)
        abs_err, err = _err_to_plain(kp, ke, rp, re)
        _check(err <= len(walk.order) * 2.0 ** -21,
               f"{key}: vs plain {err:.3e} x max")
        return bp, abs_err, err

    def lowering_turns(fn, walk, p, leaves, reps):
        """B1, B4 and ``fn`` in turns (B1, B4, fn, fn, B4, B1), ms by CUDA
        events."""
        fns = {"b1": functools.partial(forward_walk, p, leaves, walk,
                                       walk="classic"),
               "b4": functools.partial(forward_walk, p, leaves, walk,
                                       walk="slot"),
               "kernel": fn}
        runs = {name: [] for name in fns}
        for name in ["b1", "b4", "kernel", "kernel", "b4", "b1"]:
            runs[name].append(_cuda_ms(fns[name], reps))
        return {f"{name}_ms": sum(t) / 2 for name, t in runs.items()} | {
            "runs": runs}

    prof_rng = np.random.default_rng(21)
    prof16_tree = random_tree(PROFILE16_TAXA, seed=21, mean_brlen=0.2)
    prof16 = ProfileMixtureEngine(
        prof16_tree, _random_alignment(prof16_tree.leaf_names,
                                       PROFILE16_PATTERNS, AMINO, 21),
        models.LG, profiles=prof_rng.dirichlet(np.ones(20), 16),
        dtype=torch.float32, pruner="cuda", device=DEVICE)
    p16 = prof16._mixture_tensors(prof16._full_params(None),
                                  torch.float64)[2].float().contiguous()
    with _env(PHYLO_FOLD_CATEGORIES="auto"):
        fold_auto = {
            "config4": cuda_pruning._pick_fold(4, 20),
            "profile16": cuda_pruning._pick_fold(16, 20)}
    fold_cases = {
        f"pack_flagship_B{b}": (timing_inputs[b], 2) for b in (1, BATCH)}
    fold_cases["auto_config4"] = (case_inputs[f"config4_B1_S{SITES}"],
                                  fold_auto["config4"])
    fold_cases["F2_config4"] = (case_inputs[f"config4_B1_S{SITES}"], 2)
    fold_cases[f"auto_profile16_{PROFILE16_TAXA}x{PROFILE16_PATTERNS}"] = (
        (WalkSchedule(prof16.schedule), p16, prof16._leaf_partials, None),
        fold_auto["profile16"])
    for s_, tree, k in ((4, flagship_tree, 12), (20, config4_tree, 60)):
        inputs = rate_inputs(tree, SITES, k, s_)
        for f_ in cuda_pruning.FOLD_WIDTHS[s_]:
            fold_cases[f"widths_S{s_}_K{k}_F{f_}"] = (inputs, f_)
    for key, inputs in wide_inputs.items():
        fold_cases[key] = (inputs, 2)
    b9_err, b9_max, b9_times, underflow = {}, 0.0, {}, {}
    for key, ((walk, p, leaves, _), f_) in fold_cases.items():
        _check(f_ > 1, f"{key}: no fold chosen")
        # every compiled F x lanes at the widths cases
        bp, abs_err, err = lowering_checks(
            f"{key}: B9 (F={f_})",
            functools.partial(fold_walk, p, leaves, walk, f_), walk, p,
            leaves, cuda_pruning.FOLD_WIDTHS[leaves.shape[2]][f_]
            if key.startswith("widths") else ())
        b9_err[key] = {"F": f_, "K": p.shape[-3], "abs": abs_err,
                       "rel_to_max": err}
        b9_max = max(b9_max, abs_err)
        if key.startswith("wide_node"):
            underflow[key] = {"B1": underflowed(bp), "B9": underflowed(
                fold_walk(p, leaves, walk, f_)[0])}
        reps = 20 if "B1" in key or "profile16" in key else 5
        b9_times[key] = lowering_turns(
            functools.partial(fold_walk, p, leaves, walk, f_), walk, p,
            leaves, reps)
        del bp
    # device time per launch at B = 1 and config 4 (F = 2 and "auto")
    b9_device = {}
    for key in ("pack_flagship_B1", "F2_config4", "auto_config4"):
        (walk, p, leaves, _), f_ = fold_cases[key]
        b9_device[key] = _device_us(functools.partial(
            fold_walk, p, leaves, walk, f_), 10)
    walk, p, leaves, _ = timing_inputs[BATCH]
    timings[f"fold_B{BATCH}"] = in_turns(
        functools.partial(fold_walk, p, leaves, walk, 2),
        functools.partial(forward_walk_reference, p, leaves, walk), 50, 3)
    timings[f"fold_B{BATCH}"].update(zip(("bound_ms", "bound_by"),
                                         _bound("forward", walk, p, leaves)))
    _emit(21, errors=b9_err, times=b9_times, device_us=b9_device,
          auto=fold_auto, underflowed_rows=underflow,
          widths_and_lanes={
              str(k): {str(f_): n for f_, n in v.items()}
              for k, v in cuda_pruning.FOLD_WIDTHS.items()},
          bit_identical_to_B1=True, forced_smem_rows_bit_identical=[0, 1])

    # 22. static kernel (B8) vs its plain version and bit for bit vs B1 ----
    static_cases = {f"flagship_B{b}": timing_inputs[b] for b in (1, BATCH)}
    static_cases["config4"] = case_inputs[f"config4_B1_S{SITES}"]
    static_cases["wide_node_S4"] = wide_inputs["wide_node_S4"]
    b8_err, b8_max, b8_times, b8_underflow = {}, 0.0, {}, {}
    for key, (walk, p, leaves, _) in static_cases.items():
        # every compiled lane count, and 0, 1 and all rows on the SM
        bp, abs_err, err = lowering_checks(
            f"{key}: B8", functools.partial(static_walk, p, leaves, walk),
            walk, p, leaves, cuda_pruning._ROW_LANES[leaves.shape[2]])
        b8_err[key] = {"abs": abs_err, "rel_to_max": err}
        b8_max = max(b8_max, abs_err)
        if key.startswith("wide_node"):
            b8_underflow[key] = {"B1": underflowed(bp), "B8": underflowed(
                static_walk(p, leaves, walk)[0])}
        reps = 20 if key == "flagship_B1" else 5
        b8_times[key] = lowering_turns(
            functools.partial(static_walk, p, leaves, walk), walk, p, leaves,
            reps)
        del bp
    b8_device = {}
    for key in ("flagship_B1", "config4"):
        walk, p, leaves, _ = static_cases[key]
        b8_device[key] = _device_us(functools.partial(
            static_walk, p, leaves, walk), 10)
    n_static = len(_build.static_build_info())
    # a second call with the same topology (a new schedule object) builds
    # nothing: the library comes from this process's cache
    walk = WalkSchedule(compile_schedule(flagship_tree))
    t0 = time.perf_counter()
    again = walk.static_library(4)
    again_s = time.perf_counter() - t0
    _check(len(_build.static_build_info()) == n_static
           and again is static_walks["flagship_S4"][0].static_library(4),
           "a second call with the flagship topology built B8 again")
    walk, p, leaves, _ = timing_inputs[BATCH]
    timings[f"static_B{BATCH}"] = in_turns(
        functools.partial(static_walk, p, leaves, walk),
        functools.partial(forward_walk_reference, p, leaves, walk), 50, 3)
    timings[f"static_B{BATCH}"].update(zip(("bound_ms", "bound_by"),
                                           _bound("forward", walk, p, leaves)))
    _emit(22, errors=b8_err, times=b8_times, device_us=b8_device,
          underflowed_rows=b8_underflow, builds=b8_builds(),
          second_call_s=again_s, bit_identical_to_B1=True,
          forced_smem_rows_bit_identical=[0, 1])

    # 23. the engine's value calls under each knob, main path --------------
    knob_err, knob_counts, knob_ms = {}, {}, {}
    e4_32 = LikelihoodEngine(config4_tree, aln4, models.LG, ncat=4,
                             dtype=torch.float32, pruner="cuda",
                             device=DEVICE)
    e4_64 = LikelihoodEngine(config4_tree, aln4, models.LG, ncat=4,
                             dtype=torch.float64, pruner="torch",
                             device=DEVICE)
    ll4_ref = e4_64.loglikelihood(PROTEIN_PARAMS)
    sw4_ref = e4_64.sitewise_loglikelihoods(PROTEIN_PARAMS)
    knobs = (
        ("static_flagship", "STATIC_LAUNCHES", eng, FLAGSHIP_PARAMS,
         (ll_ref, sw_ref), lambda: _static_unroll(cuda_pruning, 10 ** 6)),
        ("pack_flagship", "FOLD_LAUNCHES", eng, FLAGSHIP_PARAMS,
         (ll_ref, sw_ref), lambda: _env(PHYLO_PACK_DNA="1")),
        ("fold_auto_config4", "FOLD_LAUNCHES", e4_32, PROTEIN_PARAMS,
         (ll4_ref, sw4_ref), lambda: _env(PHYLO_FOLD_CATEGORIES="auto")),
    )
    for label, counter, e, prm, (want_ll, want_sw), knob in knobs:
        with knob():
            reset_counts()
            got_ll = e.loglikelihood(prm)
            got_sw = e.sitewise_loglikelihoods(prm)
            knob_counts[label] = read_counts()
        rel = abs(got_ll - want_ll) / abs(want_ll)
        _check(knob_counts[label][counter] > 0
               and knob_counts[label]["LAUNCHES"] == 0,
               f"{label}: the value calls did not take {counter} alone: "
               f"{knob_counts[label]}")
        _check(rel <= LOGL_RTOL and np.isfinite(got_sw).all(),
               f"{label}: logL {got_ll} vs f64 {want_ll}: rel {rel:.3e}")
        knob_err[label] = {"rel_err": rel, "sitewise_max_abs_err": float(
            np.max(np.abs(got_sw - want_sw)))}
        # the value call with the knob off and on, in turns (off, on, on,
        # off), ms by CUDA events
        runs = {"off": [], "on": []}
        for how in ("off", "on", "on", "off"):
            with knob() if how == "on" else contextlib.nullcontext():
                runs[how].append(_cuda_ms(functools.partial(
                    e.loglikelihood, prm), 10))
        knob_ms[label] = {f"{how}_ms": sum(v) / 2 for how, v in runs.items()}
    reset_counts()
    eng.loglikelihood(FLAGSHIP_PARAMS)
    _check(read_counts()["LAUNCHES"] > 0
           and read_counts()["STATIC_LAUNCHES"] == 0
           and read_counts()["FOLD_LAUNCHES"] == 0,
           f"with the knobs unset the value call left B1: {read_counts()}")
    del e4_32, e4_64
    _emit(23, errors=knob_err, launches=knob_counts,
          loglikelihood_ms=knob_ms)

    # 24. the mixture path at full width, main path ------------------------
    mix_tree = random_tree(MIXTURE_TAXA, seed=24, mean_brlen=0.1)
    mix_rng = np.random.default_rng(24)
    mix_prof = mix_rng.dirichlet(np.ones(20), MIXTURE_CLASSES)
    mix_prof = np.maximum(mix_prof, 1e-4)
    mix_prof /= mix_prof.sum(axis=1, keepdims=True)
    mix_w = mix_rng.dirichlet(np.full(MIXTURE_CLASSES, 5.0))
    n_inner_m = mix_tree.n_nodes - mix_tree.n_leaves
    mix_reckoned = {
        "classic_scratch_bytes": 4 * MIXTURE_CLASSES * n_inner_m
        * MIXTURE_PATTERNS * 21,
        "classic_budget_bytes": cuda_pruning.CLASSIC_SCRATCH_BUDGET,
        "walk": cuda_pruning.choose_walk(1, MIXTURE_CLASSES, n_inner_m,
                                         MIXTURE_PATTERNS, 20),
        "leaf_bytes": 4 * MIXTURE_TAXA * MIXTURE_PATTERNS * 20,
        "p_bytes": 4 * mix_tree.n_nodes * MIXTURE_CLASSES * 400,
        "plain_replay_level_bytes_f32": 4 * mix_tree.n_nodes
        * MIXTURE_CLASSES * MIXTURE_PATTERNS * 20,
    }
    _check(mix_reckoned["walk"] == "stream",
           f"the full-width mixture does not take the stream walk: "
           f"{mix_reckoned}")
    _emit(24, stage="reckoned", taxa=MIXTURE_TAXA, classes=MIXTURE_CLASSES,
          patterns=MIXTURE_PATTERNS, **mix_reckoned)
    t_start = time.perf_counter()
    lg_sym = models.LG.build_parts(dtype=torch.float64)[0]
    p_mix = np.stack([
        transition_matrices(
            models.base.eigen_reversible(lg_sym, torch.as_tensor(f_)),
            torch.as_tensor(np.asarray(mix_tree.lengths))).numpy()
        for f_ in mix_prof], axis=1)             # (n_nodes, K, 20, 20)
    aln_mix = _simulate(mix_tree, p_mix, MIXTURE_PATTERNS, mix_prof,
                        mix_rng, weights=mix_w, chars=AMINO.encode())
    mix_kw = dict(profiles=mix_prof, weights=mix_w, device=DEVICE)
    mix32 = ProfileMixtureEngine(mix_tree, aln_mix, models.LG,
                                 dtype=torch.float32, pruner="cuda", **mix_kw)
    mix64 = ProfileMixtureEngine(mix_tree, aln_mix, models.LG,
                                 dtype=torch.float64, pruner="torch",
                                 **mix_kw)
    torch.cuda.synchronize()
    mix_s = {"data_and_engines": time.perf_counter() - t_start}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ll_mix = mix32.loglikelihood()
    sw_mix = mix32.sitewise_loglikelihoods()
    post_mix = mix32.category_posteriors()
    value_counts = read_counts()
    value_peak = torch.cuda.max_memory_allocated()
    _check(value_counts["STREAM_LAUNCHES"] > 0
           and value_counts["LAUNCHES"] == 0,
           f"the mixture's value calls did not take the stream walk: "
           f"{value_counts}")
    torch.cuda.reset_peak_memory_stats()
    vmix, gmix = mix32.value_and_grad()
    grad_peak = torch.cuda.max_memory_allocated()
    res_mix = fit(mix32, free=("branch_lengths", "cat_weights"),
                  max_steps=MIX_FIT_STEPS, patience=10 ** 6)
    mix_counts = read_counts()
    mix_times = {
        "loglik_ms": _cuda_ms(lambda: mix32.loglikelihood(), 3),
        "sitewise_ms": _cuda_ms(lambda: mix32.sitewise_loglikelihoods(), 3),
        "category_posteriors_ms": _cuda_ms(
            lambda: mix32.category_posteriors(), 3),
        "value_and_grad_ms": _cuda_ms(lambda: mix32.value_and_grad(), 1),
    }
    mix_s["port_calls"] = time.perf_counter() - t_start - sum(mix_s.values())
    ll_mix_ref = mix64.loglikelihood()
    post_ref = mix64.category_posteriors()
    sw_mix_ref = mix64.sitewise_loglikelihoods()
    rel_mix = abs(ll_mix - ll_mix_ref) / abs(ll_mix_ref)
    post_err = float(np.max(np.abs(post_mix - post_ref)))
    del mix64
    torch.cuda.empty_cache()
    vmix_ref, gmix_ref = _chunked_value_and_grad(
        dict(tree=mix_tree, model=models.LG, dtype=torch.float64,
             pruner="torch", **mix_kw), mix32._compressed, None, MIX_SLICES,
        engine_cls=ProfileMixtureEngine)
    mix_s["f64_reference"] = time.perf_counter() - t_start - sum(
        mix_s.values())
    rel_vmix = abs(float(vmix) - vmix_ref) / abs(vmix_ref)
    gmix_err = _grad_errors(gmix, gmix_ref)
    _check(math.isfinite(ll_mix) and rel_mix <= LOGL_RTOL
           and post_err <= POSTERIOR_TOL and rel_vmix <= LOGL_RTOL
           and max(gmix_err.values()) <= GRAD_TOL,
           f"full-width mixture: logL rel {rel_mix:.3e}, posteriors "
           f"{post_err:.3e}, value rel {rel_vmix:.3e}, grads {gmix_err}")
    _check(float(res_mix.trace.max()) > ll_mix and res_mix.loglik > ll_mix,
           f"the mixture fit did not raise logL: start {ll_mix}, trace "
           f"{res_mix.trace}")
    # a 4-class HKY85 kappa mixture on the flagship DNA tree (B1: classic)
    kappa_mix = [{"kappa": k_} for k_ in (1.0, 2.0, 4.0, 8.0)]
    hky32 = ModelMixtureEngine(flagship_tree, aln, models.HKY85, kappa_mix,
                               dtype=torch.float32, pruner="cuda",
                               device=DEVICE)
    hky64 = ModelMixtureEngine(flagship_tree, aln, models.HKY85, kappa_mix,
                               dtype=torch.float64, pruner="torch",
                               device=DEVICE)
    hky_w = {"cat_weights": [0.1, 0.2, 0.3, 0.4]}
    ll_hky = hky32.loglikelihood(hky_w)
    vh, gh = hky32.value_and_grad(hky_w)
    mix_counts_all = read_counts()
    _check(mix_counts_all["LAUNCHES"] > 0,
           f"the HKY85 mixture did not take B1: {mix_counts_all}")
    ll_hky_ref = hky64.loglikelihood(hky_w)
    vh_ref, gh_ref = hky64.value_and_grad(hky_w)
    rel_hky = abs(ll_hky - ll_hky_ref) / abs(ll_hky_ref)
    gh_err = _grad_errors(gh, gh_ref)
    sw_hky_err = float(np.max(np.abs(hky32.sitewise_loglikelihoods(hky_w)
                                     - hky64.sitewise_loglikelihoods(hky_w))))
    _check(rel_hky <= LOGL_RTOL and max(gh_err.values()) <= GRAD_TOL,
           f"HKY85 kappa mixture: logL rel {rel_hky:.3e}, grads {gh_err}")
    mix_counts = read_counts()
    del hky32, hky64
    _emit(24, stage="measured", patterns=mix32._compressed.n_patterns,
          loglik=ll_mix, loglik_f64=ll_mix_ref,
          rel_err=rel_mix, sitewise_max_abs_err=float(
              np.max(np.abs(sw_mix - sw_mix_ref))),
          posteriors_max_abs_err=post_err, value_rel_err=rel_vmix,
          grad_rel_err=gmix_err, fit_trace=res_mix.trace.tolist(),
          fit_loglik=res_mix.loglik, times=mix_times,
          value_peak_allocated_bytes=value_peak,
          grad_peak_allocated_bytes=grad_peak, value_launches=value_counts,
          launches=mix_counts, stage_s=mix_s,
          hky85_kappa_mixture={"rel_err": rel_hky, "grad_rel_err": gh_err,
                               "sitewise_max_abs_err": sw_hky_err})

    # 25. the CLI's loglik --profile-mixture, in process, main path --------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nex_",
                                     dir=build) as tmp:
        nex = os.path.join(tmp, "models.nex")
        with open(nex, "w") as fh:
            fh.write("#nexus\nbegin models;\n")
            for i, row in enumerate(mix_prof):
                fh.write(f"frequency SEEDpi{i + 1} = "
                         + " ".join(repr(float(x)) for x in row) + ";\n")
            fh.write("model SEED20 = LG+FMIX{" + ",".join(
                f"SEEDpi{i + 1}:1.0:{float(w_)!r}"
                for i, w_ in enumerate(mix_w)) + "};\nend;\n")
        tree_path, fasta = (os.path.join(tmp, n) for n in ("mix.nwk",
                                                           "mix.fa"))
        with open(tree_path, "w") as fh:
            fh.write(write_newick(mix_tree) + "\n")
        _write_fasta(aln_mix, fasta)
        out = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = port_cli.main(["loglik", "--tree", tree_path, "--alignment",
                           fasta, "--model", "LG", "--dtype", "float32",
                           "--pruner", "cuda", "--device", DEVICE,
                           "--profile-mixture", f"{nex}:SEED20"])
        cli_mix_s = time.perf_counter() - t0
        cli_counts = read_counts()
    cli_ll = json.loads(out.getvalue().strip().splitlines()[-1])["loglik"]
    cli_rel = abs(cli_ll - ll_mix) / abs(ll_mix)
    _check(rc == 0 and cli_rel <= 1e-9
           and cli_counts["STREAM_LAUNCHES"] > 0,
           f"CLI --profile-mixture logL {cli_ll} vs engine {ll_mix}: rel "
           f"{cli_rel:.3e}, launches {cli_counts}")
    _emit(25, loglik=cli_ll, rel_to_engine=cli_rel, wall_s=cli_mix_s,
          launches=cli_counts)
    del mix32, gmix, gmix_ref
    torch.cuda.empty_cache()

    # 26. a node wider than B3's stage under "auto", main path -----------
    # The engine splits a multifurcation into binary pseudo-nodes (as the
    # JAX engine does), so a 49-child node reaches the kernels whole only
    # through the kernel-level loglik function on a schedule compiled with
    # binarize=False (the counterpart of JAX's make_pallas_loglik_fn, which
    # takes such schedules): there "auto" runs B2 and B7, not B3. The
    # engine on the same tree and sites runs B2 and B3 over its pseudo-nodes.
    tree_w = _wide_node_tree()
    sched_w = compile_schedule(tree_w, binarize=False)
    rates_w = discrete_gamma(torch.tensor(PROTEIN_PARAMS["alpha"],
                                          dtype=torch.float64), 4).to(dev)
    p_w64 = transition_matrices(lg_eig, torch.as_tensor(
        np.asarray(tree_w.lengths), dtype=torch.float64,
        device=dev)[:, None] * rates_w)
    states_w = _simulate_states(tree_w, p_w64.cpu().numpy(),
                                WIDE_NODE_PATTERNS,
                                lg_eig.freqs.cpu().numpy(),
                                np.random.default_rng(26))
    leaves_w = torch.as_tensor(np.eye(20, dtype=np.float32)[states_w],
                               device=dev)
    p_w32 = p_w64.float().contiguous()
    fused_w = make_fused_loglik_fn(sched_w)
    prune_w = make_prune_fn(sched_w)

    def wide_value_and_grad(fn, p_, leaves_, slices=1):
        """logL (categories mixed evenly, sites summed) and its gradient in
        P and the frequencies, by autograd through ``fn(P, leaves, freqs)
        -> ll (K, sites)``, summed over ``slices`` slices of the sites (the
        f64 plain pruner pads every level to the root's 49 children, and
        its whole autograd graph ran out of the card's 80 GB)."""
        out = None
        for sl in np.array_split(np.arange(leaves_.shape[1]), slices):
            p_g = p_.detach().requires_grad_(True)
            fr = lg_eig.freqs.detach().clone().requires_grad_(True)
            total = (torch.logsumexp(fn(p_g, leaves_[:, sl], fr), dim=0)
                     - math.log(p_.shape[-3])).sum()
            part = (total.detach(),) + torch.autograd.grad(total, (p_g, fr))
            out = part if out is None else tuple(
                a + b for a, b in zip(out, part))
        return out

    def wide_plain(p_, leaves_, fr):
        root_p, root_s = prune_w(p_, leaves_)
        return torch.log(root_p @ fr) + root_s

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    v_w, dp_w, df_w = wide_value_and_grad(fused_w, p_w32, leaves_w)
    wide_auto_counts = read_counts()
    peak_w = torch.cuda.max_memory_allocated()
    _check(wide_auto_counts["SAVEALL_LAUNCHES"] > 0
           and wide_auto_counts["CLASSIC_REVERSE_LAUNCHES"] > 0
           and wide_auto_counts["REVERSE_LAUNCHES"] == 0,
           f"the wide node under auto did not take B2 and B7 alone: "
           f"{wide_auto_counts}")
    wide_auto_ms = _cuda_ms(
        lambda: wide_value_and_grad(fused_w, p_w32, leaves_w), 3)
    v_ref, dp_ref, df_ref = wide_value_and_grad(
        wide_plain, p_w32.double(), leaves_w.double(), slices=16)
    wide_err = {"value_rel": abs(float(v_w) - float(v_ref))
                / abs(float(v_ref)),
                "dP": _max_rel(dp_w, dp_ref), "dfreqs": _max_rel(df_w, df_ref)}
    _check(math.isfinite(float(v_w)) and wide_err["value_rel"] <= LOGL_RTOL
           and max(wide_err["dP"], wide_err["dfreqs"]) <= GRAD_TOL,
           f"the wide node under auto against the f64 autograd: {wide_err}")
    # the engine on the same tree and sites: binarized, B2 and B3
    aln_w = {name: "".join(AMINO[c] for c in states_w[i])
             for i, name in enumerate(tree_w.leaf_names)}
    eng_w = LikelihoodEngine(tree_w, aln_w, models.LG, ncat=4,
                             dtype=torch.float32, pruner="cuda",
                             device=DEVICE)
    reset_counts()
    v_eng, _ = eng_w.value_and_grad(PROTEIN_PARAMS)
    wide_engine_counts = read_counts()
    _check(wide_engine_counts["REVERSE_LAUNCHES"] > 0
           and wide_engine_counts["CLASSIC_REVERSE_LAUNCHES"] == 0
           and abs(float(v_eng) - float(v_ref)) <= LOGL_RTOL * abs(
               float(v_ref)),
           f"the engine on the wide-node tree: logL {float(v_eng)} vs f64 "
           f"{float(v_ref)}, launches {wide_engine_counts}")
    wide_engine_ms = _cuda_ms(
        lambda: eng_w.value_and_grad(PROTEIN_PARAMS), 3)
    _emit(26, taxa=tree_w.n_leaves, root_children=int(
        sched_w.n_children_max), patterns=WIDE_NODE_PATTERNS,
          loglik=float(v_w), loglik_f64=float(v_ref), errors=wide_err,
          launches=wide_auto_counts, value_and_grad_ms=wide_auto_ms,
          peak_allocated_bytes=peak_w, engine_loglik=float(v_eng),
          engine_launches=wide_engine_counts,
          engine_value_and_grad_ms=wide_engine_ms,
          engine_internal_nodes=eng_w.schedule.n_nodes - tree_w.n_leaves)
    del eng_w, dp_w, dp_ref, p_w64, p_w32, leaves_w
    torch.cuda.empty_cache()

    # 27. codon at full width, main path ---------------------------------
    # GY94+G4 with F3x4 frequencies, 61 states: the walk's entry points pad
    # them to 64 (cuda_pruning.padded_states), the width B1, B2, B3 and B5
    # are compiled for; value calls stream (B5) at 32 states and more, as
    # the JAX package's _pallas_forward does
    from phylo_utils_tpu_torch.ascertainment import AscertainmentEngine
    from phylo_utils_tpu_torch.likelihood import mixture_rates_and_p
    from phylo_utils_tpu_torch.models.codon import (
        code_tables,
        dn_ds_by_branch,
        f3x4_frequencies,
        make_gy94,
    )

    def simulated_states(tree, model, params, n, seed, ncat=4):
        """(alignment states (n_leaves, n), the f64 eigensystem) of ``n``
        sites simulated down ``tree`` under ``model`` + G``ncat`` at
        ``params``, with P from the port's own eigensystem."""
        eig_s = model.eigen(params.get("model"), dtype=torch.float64,
                            device=dev)
        t = torch.as_tensor(np.asarray(tree.lengths), dtype=torch.float64,
                            device=dev)
        r = discrete_gamma(torch.tensor(params["alpha"],
                                        dtype=torch.float64), ncat).to(dev)
        p_s = transition_matrices(eig_s, t[:, None] * r)
        return _simulate_states(tree, p_s.cpu().numpy(), n,
                                eig_s.freqs.cpu().numpy(),
                                np.random.default_rng(seed)), eig_s

    def codon_alignment(tree, model, params, n, seed, code="standard"):
        states, _ = simulated_states(tree, model, params, n, seed)
        codons = np.array(code_tables(code)[0])
        return {name: "".join(codons[states[i]])
                for i, name in enumerate(tree.leaf_names)}

    def padded_walk_inputs(engine, params):
        """The engine's walk inputs padded to 64 states, as its entry point
        pads them: (walk, f32 P, f32 leaves, f64 freqs)."""
        full = engine._full_params(params)
        _, _, p_e, f_e = mixture_rates_and_p(
            engine, full, torch.float64, eig=engine.model_eigen(full),
            rates=engine.model_rates(full))
        s_pad = cuda_pruning.padded_states(p_e.shape[-1])
        return (WalkSchedule(engine.schedule),
                cuda_pruning._pad_states(p_e.float(), s_pad, 2).contiguous(),
                cuda_pruning._pad_states(engine._leaf_partials.float(), s_pad,
                                         1).contiguous(),
                cuda_pruning._pad_states(f_e, s_pad, 1))

    def wide_kernel_checks(label, walk, p, leaves, f):
        """B1, B5, B2 and B3 at 64 states against their plain versions on
        the card; raises on a miss. Returns the errors."""
        kp, ke = forward_walk(p, leaves, walk, walk="classic")
        sp, se = cuda_pruning.slot_walk(p, leaves, walk, stream=True)
        rp, re = forward_walk_reference(p, leaves, walk)
        torch.cuda.synchronize()
        tol = len(walk.order) * 2.0 ** -21
        err = {"B1": float((site_ll(kp, ke, f) - site_ll(rp, re, f))
                           .abs().max()),
               "B5": float((site_ll(sp, se, f) - site_ll(rp, re, f))
                           .abs().max())}
        _check(torch.equal(kp, sp) and torch.equal(ke, se),
               f"{label}: B5's root is not B1's bit for bit at 64 states")
        rx, rex = saveall_walk(p, leaves, walk)
        row = walk.root - walk.n_leaves
        _check(torch.equal(rx[:, row], kp) and torch.equal(rex[:, row], ke),
               f"{label}: B2's root row is not B1's bit for bit")
        px, pe = saveall_walk_reference(p, leaves, walk)
        err["B2"] = _err_to_plain(rx, rex, px, pe)[1]
        lam = (1.0 / torch.einsum("ksi,i->ks", kp.double(), f)
               ).float().contiguous()
        f32 = f.float().contiguous()
        dp, dl = reverse_walk(p, leaves, rx, rex, lam, f32, walk,
                              want_dleaf=True)
        dp2, _ = reverse_walk(p, leaves, rx, rex, lam, f32, walk,
                              want_dleaf=True)
        rdp, rdl = reverse_walk_reference(p, leaves, rx, rex, lam, f32, walk,
                                          want_dleaf=True)
        torch.cuda.synchronize()
        err["B3_dP"] = _max_rel(dp, rdp)
        err["B3_dleaf"] = _max_rel(dl, rdl)
        _check(max(err["B1"], err["B5"]) <= tol and err["B2"] <= tol
               and max(err["B3_dP"], err["B3_dleaf"]) <= REVERSE_TOL
               and torch.equal(dp, dp2)
               and not bool(dp[walk.root].any()),
               f"{label}: 64-state kernels against their plain versions "
               f"{err} (tolerance {tol:.3e}, B3 {REVERSE_TOL}), B3 "
               f"repeatable {torch.equal(dp, dp2)}")
        return err

    codon_tree = random_tree(CODON_TAXA, seed=27)
    nuc = np.random.default_rng(27).dirichlet(np.full(4, 8.0), size=3)
    codon_params = {**CODON_PARAMS, "model": {
        **CODON_PARAMS["model"], "freqs": f3x4_frequencies(nuc).tolist()}}
    aln_c = codon_alignment(codon_tree, models.GY94, codon_params,
                            CODON_PATTERNS, 27)
    c32 = LikelihoodEngine(codon_tree, aln_c, models.GY94, ncat=4,
                           dtype=torch.float32, pruner="cuda", device=DEVICE)
    c64 = LikelihoodEngine(codon_tree, c32._compressed, models.GY94, ncat=4,
                           dtype=torch.float64, pruner="torch",
                           device=DEVICE)
    codon_inputs = padded_walk_inputs(c32, codon_params)
    codon_err = {"gy94": wide_kernel_checks("codon", *codon_inputs)}
    mito = make_gy94("vertebrate_mito")
    mito_params = {**CODON_PARAMS, "model": {**CODON_PARAMS["model"],
                                             "freqs": f3x4_frequencies(
                                                 nuc, "vertebrate_mito")}}
    m32 = LikelihoodEngine(
        mito_tree, codon_alignment(mito_tree, mito, mito_params,
                                   MITO_PATTERNS, 28, "vertebrate_mito"),
        mito, ncat=4, dtype=torch.float32, pruner="cuda", device=DEVICE)
    mito_inputs = padded_walk_inputs(m32, mito_params)
    codon_err["gy94_vertebrate_mito"] = wide_kernel_checks(
        "vertebrate mito", *mito_inputs)
    ll_m = m32.loglikelihood(mito_params)
    # the engine, main path: values through B5, the gradient B2 + B3
    reset_counts()
    ll_c = c32.loglikelihood(codon_params)
    sw_c = c32.sitewise_loglikelihoods(codon_params)
    codon_value_counts = read_counts()
    _check(codon_value_counts.get("STREAM_LAUNCHES@64", 0) > 0
           and codon_value_counts["LAUNCHES"] == 0,
           f"codon value calls did not stream at 64 states alone: "
           f"{codon_value_counts}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    v_c, g_c = c32.value_and_grad(codon_params)
    codon_grad_counts = read_counts()
    peak_c = torch.cuda.max_memory_allocated()
    _check(codon_grad_counts.get("SAVEALL_LAUNCHES@64", 0) > 0
           and codon_grad_counts.get("REVERSE_LAUNCHES@64", 0) > 0,
           f"the codon gradient did not run B2 and B3 at 64 states: "
           f"{codon_grad_counts}")
    ll_c64 = c64.loglikelihood(codon_params)
    sw_c64 = c64.sitewise_loglikelihoods(codon_params)
    v_c64, g_c64 = c64.value_and_grad(codon_params)
    codon_engine_err = {
        "loglik_rel": abs(ll_c - ll_c64) / abs(ll_c64),
        "sitewise_rel": float(np.max(np.abs(sw_c - sw_c64)
                                     / np.abs(sw_c64))),
        "value_rel": abs(float(v_c) - float(v_c64)) / abs(float(v_c64)),
        "grad_rel": _grad_errors(g_c, g_c64)}
    _check(math.isfinite(ll_c)
           and max(codon_engine_err["loglik_rel"],
                   codon_engine_err["sitewise_rel"],
                   codon_engine_err["value_rel"]) <= CODON_RTOL
           and max(codon_engine_err["grad_rel"].values()) <= GRAD_TOL,
           f"codon engine against the f64 path: {codon_engine_err}")
    del c64, g_c64
    torch.cuda.empty_cache()
    # a fit: kappa, omega and the branch lengths free, F3x4 held
    reset_counts()
    t0 = time.perf_counter()
    fit_c = fit(c32, codon_params, free=("branch_lengths", "model.kappa",
                                         "model.omega"),
                max_steps=CODON_FIT_STEPS)
    codon_fit_s = time.perf_counter() - t0
    codon_fit_counts = read_counts()
    dd = dn_ds_by_branch(models.GY94, fit_c.params["model"],
                         branch_lengths=fit_c.params["branch_lengths"]
                         .detach().cpu().numpy())
    omega_fit = float(fit_c.params["model"]["omega"])
    _check(fit_c.loglik > ll_c and dd["omega"] == omega_fit
           and abs(dd["S"] + dd["N"] - 3.0) < 1e-12
           and np.allclose(dd["dN"] / dd["dS"], omega_fit, rtol=1e-10)
           and codon_fit_counts.get("REVERSE_LAUNCHES@64", 0) > 0,
           f"codon fit: logL {ll_c} -> {fit_c.loglik}, omega {omega_fit}, "
           f"S + N {dd['S'] + dd['N']}, launches {codon_fit_counts}")
    # B4, B7, B8 and B9 at 64 states, not counted: B4 on the codon shape
    # and B8 (F = 1) and B9 (F = 2) on the vertebrate-mito shape, whose
    # classic scratch (32 taxa x 1024 patterns: 33 MB) is within the budget,
    # bit for bit against B1; B7 against its plain version and B3
    walk_c, p_c, l_c, f_c = codon_inputs
    walk_m, p_m, l_m, f_m = mito_inputs
    b1_c = forward_walk(p_c, l_c, walk_c, walk="classic")
    b1_m = forward_walk(p_m, l_m, walk_m, walk="classic")
    plain_c = site_ll(*forward_walk_reference(p_c, l_c, walk_c), f_c)
    plain_m = site_ll(*forward_walk_reference(p_m, l_m, walk_m), f_m)
    for name, got, want, plain, f_, err in (
            ("B4", cuda_pruning.slot_walk(p_c, l_c, walk_c), b1_c, plain_c,
             f_c, codon_err["gy94"]),
            ("B8", static_walk(p_m, l_m, walk_m), b1_m, plain_m, f_m,
             codon_err["gy94_vertebrate_mito"]),
            ("B9", fold_walk(p_m, l_m, walk_m, 2), b1_m, plain_m, f_m,
             codon_err["gy94_vertebrate_mito"])):
        torch.cuda.synchronize()
        _check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
               f"{name}'s root is not B1's bit for bit at 64 states")
        # the kernel's own site-logL error against the plain walk
        err[name] = float((site_ll(*got, f_) - plain).abs().max())
    del plain_c, plain_m
    rx_c, re_c = saveall_walk(p_c, l_c, walk_c)
    lam_c = (1.0 / torch.einsum("ksi,i->ks", rx_c[:, walk_c.root
                                                   - walk_c.n_leaves].double(),
                                f_c)).float().contiguous()
    f32_c = f_c.float().contiguous()
    gseed_c = (lam_c[..., None] * f32_c).unsqueeze(-3).contiguous()
    root_c = [walk_c.root]
    d7, l7 = classic_reverse_walk(p_c, l_c, rx_c, re_c, gseed_c, root_c,
                                  walk_c, want_dleaf=True)
    d7b, _ = classic_reverse_walk(p_c, l_c, rx_c, re_c, gseed_c, root_c,
                                  walk_c, want_dleaf=True)
    d3, l3 = reverse_walk(p_c, l_c, rx_c, re_c, lam_c, f32_c, walk_c,
                          want_dleaf=True)
    w7, wl7 = classic_reverse_walk_reference(p_c, l_c, rx_c, re_c, gseed_c,
                                             root_c, walk_c, want_dleaf=True)
    seeds_c = [walk_c.root, int(walk_c.order[len(walk_c.order) // 2])]
    g2_c = torch.as_tensor(np.random.default_rng(27).uniform(
        0.5, 1.5, (4, 2) + tuple(l_c.shape[1:])), dtype=torch.float32,
        device=dev)
    d72, l72 = classic_reverse_walk(p_c, l_c, rx_c, re_c, g2_c, seeds_c,
                                    walk_c, want_dleaf=True)
    w72, wl72 = classic_reverse_walk_reference(p_c, l_c, rx_c, re_c, g2_c,
                                               seeds_c, walk_c,
                                               want_dleaf=True)
    torch.cuda.synchronize()
    b7_64 = {"dP_rel_max": _max_rel(d7, w7),
             "dleaf_rel_max": _max_rel(l7, wl7),
             "vs_B3_dP_rel_max": _max_rel(d7, d3),
             "two_seed_dP_rel_max": _max_rel(d72, w72),
             "two_seed_dleaf_rel_max": _max_rel(l72, wl72)}
    _check(max(b7_64.values()) <= REVERSE_TOL and torch.equal(d7, d7b)
           and torch.equal(l7, l3) and not bool(d7[walk_c.root].any()),
           f"B7 at 64 states against its plain version and B3: {b7_64}, "
           f"repeatable {torch.equal(d7, d7b)}, dleaf B3's "
           f"{torch.equal(l7, l3)}")
    codon_err["gy94"]["B7_dP"] = b7_64["dP_rel_max"]
    codon_err["gy94"]["B7"] = b7_64
    del d7b, w7, wl7, d72, l72, w72, wl72, g2_c
    # B7 on the wide-node tree at 64 states (the root's 49 children past
    # its 3 staged ones: P read through L1 in groups), codon sites
    # simulated down it so that no product underflows
    eig_c = models.GY94.eigen(codon_params["model"], dtype=torch.float64,
                              device=dev)
    rates_c = discrete_gamma(torch.tensor(codon_params["alpha"],
                                          dtype=torch.float64), 4).to(dev)
    walk_n, p_n, l_n, f_n = _wide_node_inputs(
        eig_c, rates_c, WIDE_NODE_PATTERNS // 8, np.random.default_rng(27),
        dev)
    p_n = cuda_pruning._pad_states(p_n, 64, 2).contiguous()
    l_n = cuda_pruning._pad_states(l_n, 64, 1).contiguous()
    f_n = cuda_pruning._pad_states(f_n, 64, 1)
    rx_n, re_n = saveall_walk(p_n, l_n, walk_n)
    row_n = walk_n.root - walk_n.n_leaves
    lam_n = (1.0 / torch.einsum("ksi,i->ks", rx_n[:, row_n].double(),
                                f_n)).float()
    g_n = (lam_n[..., None] * f_n.float()).unsqueeze(-3).contiguous()
    d7n, l7n = classic_reverse_walk(p_n, l_n, rx_n, re_n, g_n, [walk_n.root],
                                    walk_n, want_dleaf=True)
    w7n, wl7n = classic_reverse_walk_reference(
        p_n, l_n, rx_n, re_n, g_n, [walk_n.root], walk_n, want_dleaf=True)
    torch.cuda.synchronize()
    b7_64["wide_node"] = {
        "root_children": int(walk_n.children.shape[1]),
        "staged_children": cuda_pruning.classic_reverse_stage(
            64, walk_n.children.shape[1])[0],
        "dP_rel_max": _max_rel(d7n, w7n), "dleaf_rel_max": _max_rel(l7n, wl7n),
        "ms": _cuda_ms(functools.partial(
            classic_reverse_walk, p_n, l_n, rx_n, re_n, g_n, [walk_n.root],
            walk_n), 3)}
    _check(bool(torch.isfinite(d7n).all()) and bool(torch.isfinite(l7n).all())
           and max(b7_64["wide_node"]["dP_rel_max"],
                   b7_64["wide_node"]["dleaf_rel_max"]) <= REVERSE_TOL,
           f"B7 on the wide node at 64 states: {b7_64['wide_node']}")
    del walk_n, p_n, l_n, rx_n, re_n, d7n, l7n, w7n, wl7n
    # B7's blocks a launch, in turns (132, 264, 528, 528, 264, 132): at 264
    # every block walks one 64-site tile, so its dP is B3's bit for bit
    b7_blocks, saved_blocks = {}, cuda_pruning._CLASSIC_REVERSE_BLOCKS[64]
    b7_fn = functools.partial(classic_reverse_walk, p_c, l_c, rx_c, re_c,
                              gseed_c, root_c, walk_c)
    try:
        for blocks in (132, 264, 528, 528, 264, 132):
            cuda_pruning._CLASSIC_REVERSE_BLOCKS[64] = blocks
            seen = b7_blocks.setdefault(blocks, {"runs": [], "rows": (
                classic_reverse_scratch(1, 4, walk_c.n_nodes,
                                        walk_c.reverse.n_gslots,
                                        l_c.shape[1], 64)[0])})
            seen["runs"].append(_cuda_ms(b7_fn, 5))
        cuda_pruning._CLASSIC_REVERSE_BLOCKS[64] = 4 * 64
        one_tile = classic_reverse_walk(p_c, l_c, rx_c, re_c, gseed_c,
                                        root_c, walk_c)[0]
    finally:
        cuda_pruning._CLASSIC_REVERSE_BLOCKS[64] = saved_blocks
    torch.cuda.synchronize()
    _check(torch.equal(one_tile, d3),
           "B7 with one 64-site tile a block is not B3's dP bit for bit")
    b7_blocks = {str(b): {"ms": sum(v["runs"]) / 2, **v}
                 for b, v in b7_blocks.items()}
    del one_tile, d7, l7, d3, l3
    # the engine under the knobs, main path: values through B4 under
    # PHYLO_FORCE_STREAM=0 (past the classic budget), the gradient through
    # B2 + B7 under PHYLO_DEFERRED_VJP=0; the mito engine's values through
    # B8 (PHYLO_STATIC_UNROLL_MAX) and B9 (PHYLO_FOLD_CATEGORIES=auto) with
    # streaming off, within the budget
    with _env(PHYLO_FORCE_STREAM="0"):
        reset_counts()
        ll_b4 = c32.loglikelihood(codon_params)
        sw_b4 = c32.sitewise_loglikelihoods(codon_params)
        b4_counts = read_counts()
    with _env(PHYLO_DEFERRED_VJP="0"):
        reset_counts()
        v_b7, g_b7 = c32.value_and_grad(codon_params)
        b7_counts = read_counts()
    with _env(PHYLO_FORCE_STREAM="0"), _static_unroll(cuda_pruning, 10 ** 6):
        reset_counts()
        ll_b8 = m32.loglikelihood(mito_params)
        b8_counts = read_counts()
    with _env(PHYLO_FORCE_STREAM="0", PHYLO_FOLD_CATEGORIES="auto"):
        reset_counts()
        ll_b9 = m32.loglikelihood(mito_params)
        b9_counts = read_counts()
    knob_64 = {
        "B4_loglik_rel": abs(ll_b4 - ll_c) / abs(ll_c),
        "B4_sitewise_max_abs": float(np.max(np.abs(sw_b4 - sw_c))),
        "B7_value_rel": abs(float(v_b7) - float(v_c64)) / abs(float(v_c64)),
        "B7_grad_rel_to_B3": _grad_errors(g_b7, g_c),
        "B8_loglik_rel": abs(ll_b8 - ll_m) / abs(ll_m),
        "B9_loglik_rel": abs(ll_b9 - ll_m) / abs(ll_m)}
    _check(b4_counts.get("SLOT_LAUNCHES@64", 0) > 0
           and b4_counts.get("STREAM_LAUNCHES@64", 0) == 0
           and b7_counts.get("CLASSIC_REVERSE_LAUNCHES@64", 0) > 0
           and b7_counts.get("REVERSE_LAUNCHES@64", 0) == 0
           and b8_counts.get("STATIC_LAUNCHES@64", 0) > 0
           and b9_counts.get("FOLD_LAUNCHES@64", 0) > 0
           and b8_counts["STREAM_LAUNCHES"] + b9_counts["STREAM_LAUNCHES"]
           + b8_counts["LAUNCHES"] + b9_counts["LAUNCHES"] == 0,
           f"the knobs did not take B4, B7, B8 and B9 at 64 states: B4 "
           f"{b4_counts}, B7 {b7_counts}, B8 {b8_counts}, B9 {b9_counts}")
    _check(max(knob_64["B4_loglik_rel"], knob_64["B8_loglik_rel"],
               knob_64["B9_loglik_rel"]) == 0.0
           and knob_64["B4_sitewise_max_abs"] == 0.0
           and knob_64["B7_value_rel"] <= CODON_RTOL
           and max(knob_64["B7_grad_rel_to_B3"].values()) <= GRAD_TOL,
           f"the codon engine under the knobs: {knob_64}")
    del g_b7
    # times: B5 and B1 in turns (B5, B1, B1, B5), each kernel in turns with
    # its plain version, device time per launch, bounds; the engine
    fns_64 = {
        "stream": (functools.partial(cuda_pruning.slot_walk, p_c, l_c, walk_c,
                                     stream=True),
                   functools.partial(slot_walk_reference, p_c, l_c, walk_c),
                   codon_inputs),
        "forward": (functools.partial(forward_walk, p_c, l_c, walk_c,
                                      walk="classic"),
                    functools.partial(forward_walk_reference, p_c, l_c,
                                      walk_c), codon_inputs),
        "saveall": (functools.partial(saveall_walk, p_c, l_c, walk_c),
                    functools.partial(saveall_walk_reference, p_c, l_c,
                                      walk_c), codon_inputs),
        "reverse": (functools.partial(reverse_walk, p_c, l_c, rx_c, re_c,
                                      lam_c, f32_c, walk_c),
                    functools.partial(reverse_walk_reference, p_c, l_c, rx_c,
                                      re_c, lam_c, f32_c, walk_c),
                    codon_inputs),
        "slot": (functools.partial(cuda_pruning.slot_walk, p_c, l_c, walk_c),
                 functools.partial(slot_walk_reference, p_c, l_c, walk_c),
                 codon_inputs),
        "classic": (b7_fn, functools.partial(
            classic_reverse_walk_reference, p_c, l_c, rx_c, re_c, gseed_c,
            root_c, walk_c), codon_inputs),
        "static": (functools.partial(static_walk, p_m, l_m, walk_m),
                   functools.partial(forward_walk_reference, p_m, l_m,
                                     walk_m), mito_inputs),
        "fold": (functools.partial(fold_walk, p_m, l_m, walk_m, 2),
                 functools.partial(forward_walk_reference, p_m, l_m, walk_m),
                 mito_inputs),
    }
    t_b5_b1 = [_cuda_ms(fns_64[how][0], 10)
               for how in ("stream", "forward", "forward", "stream")]
    timings_64 = {}
    for what, (fn, plain, inputs) in fns_64.items():
        timings_64[what] = in_turns(fn, plain, 5, 1)
        timings_64[what].update(zip(
            ("bound_ms", "bound_by"),
            _bound({"slot": "forward", "static": "forward",
                    "fold": "forward"}.get(what, what), *inputs[:3])))
        timings_64[what]["shape"] = (
            f"{MITO_TAXA} taxa x {MITO_PATTERNS} vertebrate-mito codon "
            "patterns, GY94+G4" if inputs is mito_inputs else
            f"{CODON_TAXA} taxa x {CODON_PATTERNS} codon patterns, GY94+G4")
        # device us per launch (torch.profiler; 3 calls recorded none)
        timings_64[what]["device"] = _device_us(fn, 10)
    del rx_c, re_c
    codon_ms = {"loglikelihood": _cuda_ms(
        lambda: c32.loglikelihood(codon_params), 5),
        "value_and_grad": _cuda_ms(
            lambda: c32.value_and_grad(codon_params), 3)}
    _emit(27, taxa=CODON_TAXA, patterns=c32._compressed.n_patterns,
          states=61, padded_states=p_c.shape[-1],
          kernel_errors=codon_err, loglik=ll_c, loglik_f64=ll_c64,
          engine_errors=codon_engine_err, value_launches=codon_value_counts,
          grad_launches=codon_grad_counts, fit_loglik=fit_c.loglik,
          fit_steps=fit_c.n_steps, fit_s=codon_fit_s,
          fit_launches=codon_fit_counts,
          dn_ds={"omega": dd["omega"], "S": dd["S"], "N": dd["N"]},
          knob_errors=knob_64, knob_launches={
              "B4_force_stream_0": b4_counts, "B7_deferred_vjp_0": b7_counts,
              "B8_static_unroll": b8_counts, "B9_fold_auto": b9_counts},
          b7_blocks=b7_blocks,
          stream_vs_classic_ms={"B5": (t_b5_b1[0] + t_b5_b1[3]) / 2,
                                "B1": (t_b5_b1[1] + t_b5_b1[2]) / 2,
                                "runs": t_b5_b1},
          kernels_64=timings_64, engine_ms=codon_ms,
          value_and_grad_peak_bytes=peak_c,
          leaves_padded_bytes=l_c.numel() * 4)
    del c32, m32, fit_c, codon_inputs, mito_inputs, p_c, l_c, p_m, l_m
    del fns_64, b7_fn
    torch.cuda.empty_cache()

    # 28. the Mk family and the ascertainment engine, main path ----------
    mk_tree = flagship_tree
    mk2 = models.get_model("MK2")
    states_mk, _ = simulated_states(mk_tree, mk2, {"alpha": 0.5},
                                    4 * MK_CHARS, 28)
    variable = np.flatnonzero(states_mk.min(axis=0) != states_mk.max(axis=0))
    _check(len(variable) >= MK_CHARS, f"only {len(variable)} variable "
           f"binary characters of {4 * MK_CHARS}")
    states_mk = states_mk[:, variable[:MK_CHARS]]
    aln_mk = {name: "".join("01"[c] for c in states_mk[i])
              for i, name in enumerate(mk_tree.leaf_names)}
    mk_err, mk_counts = {}, {}
    for label, kw in (("MK2_lewis", dict(model=mk2, correction="lewis")),
                      ("MK6", dict(model=models.get_model("MK6"))),
                      ("ORDERED5", dict(model=models.get_model("ORDERED5"))),
                      ("MK24", dict(model=models.get_model("MK24")))):
        if label == "MK2_lewis":
            aln_k, cls = aln_mk, AscertainmentEngine
        else:
            k = kw["model"].n_states
            st, _ = simulated_states(mk_tree, kw["model"], {"alpha": 0.5},
                                     MK_CHARS, 28 + k)
            aln_k = {name: "".join("0123456789ABCDEFGHIJKLMNOPQRSTUV"[c]
                                   for c in st[i])
                     for i, name in enumerate(mk_tree.leaf_names)}
            cls = LikelihoodEngine
        mk_params = {"alpha": 0.5}
        e32 = cls(mk_tree, aln_k, ncat=4, dtype=torch.float32,
                  pruner="cuda", device=DEVICE, **kw)
        e64 = cls(mk_tree, aln_k, ncat=4, dtype=torch.float64,
                  pruner="torch", device=DEVICE, **kw)
        reset_counts()
        ll_k = e32.loglikelihood(mk_params)
        sw_k = e32.sitewise_loglikelihoods(mk_params)
        v_k, g_k = e32.value_and_grad(mk_params)
        mk_counts[label] = read_counts()
        ll_k64 = e64.loglikelihood(mk_params)
        v_k64, g_k64 = e64.value_and_grad(mk_params)
        mk_err[label] = {
            "padded_states": cuda_pruning.padded_states(
                kw["model"].n_states),
            "loglik_rel": abs(ll_k - ll_k64) / abs(ll_k64),
            "sitewise_max_abs": float(np.max(np.abs(
                sw_k - e64.sitewise_loglikelihoods(mk_params)))),
            "value_rel": abs(float(v_k) - float(v_k64)) / abs(float(v_k64)),
            "grad_rel": _grad_errors(g_k, g_k64)}
        s_pad = mk_err[label]["padded_states"]
        _check(math.isfinite(ll_k)
               and max(mk_err[label]["loglik_rel"],
                       mk_err[label]["value_rel"]) <= LOGL_RTOL
               and max(mk_err[label]["grad_rel"].values()) <= GRAD_TOL
               and mk_counts[label].get(f"SAVEALL_LAUNCHES@{s_pad}", 0) > 0
               and mk_counts[label].get(f"REVERSE_LAUNCHES@{s_pad}", 0) > 0,
               f"{label} against the f64 path: {mk_err[label]}, launches "
               f"{mk_counts[label]}")
        if label == "MK2_lewis":
            ll_mk2, sw_mk2 = ll_k, sw_k
        del e32, e64
    # the CLI as subprocesses against the same calls in this process
    cli_tree = random_tree(CLI_CODON_TAXA, seed=29)
    aln_cli = codon_alignment(cli_tree, models.GY94, codon_params,
                              CLI_CODON_PATTERNS, 29)
    cli_params = json.dumps({"model": {
        "freqs": codon_params["model"]["freqs"]}})
    cli_free = "branch_lengths,model.kappa,model.omega"
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_",
                                     dir=build) as tmp:
        mk_tree_path, mk_fa, c_tree_path, c_fa = (
            os.path.join(tmp, n) for n in ("mk.nwk", "mk.fa", "codon.nwk",
                                           "codon.fa"))
        for path, tree_ in ((mk_tree_path, mk_tree), (c_tree_path, cli_tree)):
            with open(path, "w") as fh:
                fh.write(write_newick(tree_) + "\n")
        _write_fasta(aln_mk, mk_fa)
        _write_fasta(aln_cli, c_fa)
        cli = [sys.executable, "-m", "phylo_utils_tpu_torch.cli"]
        common = ["--dtype", "float32", "--pruner", "cuda"]
        cmds = {
            "loglik_MK2_lewis": cli + ["loglik", "--tree", mk_tree_path,
                                       "--alignment", mk_fa, "--model",
                                       "MK2+G4", "--asc", "lewis",
                                       "--params", '{"alpha": 0.5}',
                                       "--sitewise"] + common,
            "fit_GY94": cli + ["fit", "--tree", c_tree_path, "--alignment",
                               c_fa, "--model", "GY94", "--params",
                               cli_params, "--free", cli_free,
                               "--max-steps", str(CLI_FIT_STEPS)] + common,
        }
        env = {**os.environ, "PYTHONPATH": str(REPO)}
        t_cli = time.perf_counter()
        procs = {name: subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE)
                 for name, cmd in cmds.items()}
        try:
            reset_counts()
            eng_cf = LikelihoodEngine(
                parse_newick(open(c_tree_path).read()),
                read_alignment(c_fa), models.GY94, dtype=torch.float32,
                pruner="cuda", device=DEVICE)
            fit_cf = fit(eng_cf, json.loads(cli_params),
                         free=tuple(cli_free.split(",")),
                         max_steps=CLI_FIT_STEPS, steps_per_call=10)
            cli_counts_28 = read_counts()
            dd_cf = dn_ds_by_branch(
                models.GY94, fit_cf.params["model"],
                branch_lengths=fit_cf.params["branch_lengths"].detach()
                .cpu().numpy())
            outs = {}
            for name, proc in procs.items():
                out, err = proc.communicate(timeout=600)
                _check(proc.returncode == 0,
                       f"{name} exited {proc.returncode}: {err[-2000:]}")
                outs[name] = json.loads(out.strip().splitlines()[-1])
            cli_s_28 = time.perf_counter() - t_cli
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    cli_err_28 = {
        "mk2_loglik_rel": abs(outs["loglik_MK2_lewis"]["loglik"] - ll_mk2)
        / abs(ll_mk2),
        "mk2_sitewise_max_abs": float(np.max(np.abs(
            np.asarray(outs["loglik_MK2_lewis"]["sitewise"]) - sw_mk2))),
        "gy94_fit_loglik_rel": abs(outs["fit_GY94"]["loglik"]
                                   - fit_cf.loglik) / abs(fit_cf.loglik),
        "gy94_dn_ds_rel": max(
            _max_rel(torch.as_tensor(outs["fit_GY94"]["dn_ds"][key],
                                     dtype=torch.float64),
                     torch.as_tensor(dd_cf[key], dtype=torch.float64))
            for key in ("omega", "S", "N", "dN", "dS"))}
    _check(max(cli_err_28.values()) <= 1e-9
           and cli_counts_28.get("REVERSE_LAUNCHES@64", 0) > 0,
           f"the CLI against the same calls in this process: {cli_err_28}, "
           f"launches {cli_counts_28}")
    _emit(28, characters=MK_CHARS, errors=mk_err, launches=mk_counts,
          cli_errors=cli_err_28, cli_wall_s=cli_s_28,
          cli_fit_launches=cli_counts_28)
    torch.cuda.empty_cache()

    # 29. codon at full width, past B3's scratch, main path ---------------
    # GY94+G4 (F3x4) on a 1000-taxon tree x 24,000 codon patterns simulated
    # on the card: B3's dP rows (one 64 x 64 row per node per 64-site
    # block) no longer fit beside the leaves and residuals, so "auto" takes
    # B7; held against the same engine summed over pattern slices, which
    # take B3
    wide_c_tree = random_tree(CODON_WIDE_TAXA, seed=29)
    walk_cw = WalkSchedule(compile_schedule(wide_c_tree))
    n_inner_cw = walk_cw.n_nodes - walk_cw.n_leaves
    gslots_cw, cmax_cw = walk_cw.reverse.n_gslots, walk_cw.children.shape[1]
    rows_cw, slots_cw, row_cw = classic_reverse_scratch(
        1, 4, walk_cw.n_nodes, gslots_cw, CODON_WIDE_PATTERNS, 64)
    reckoned_cw = {
        "leaf_bytes": 4 * CODON_WIDE_TAXA * CODON_WIDE_PATTERNS * 61,
        "padded_leaf_bytes": 4 * CODON_WIDE_TAXA * CODON_WIDE_PATTERNS * 64,
        "residual_bytes": 4 * 4 * n_inner_cw * CODON_WIDE_PATTERNS * 65,
        "b3_scratch_bytes": reverse_scratch(
            1, 4, walk_cw.n_nodes, gslots_cw, CODON_WIDE_PATTERNS, 64,
            cmax_cw)[1],
        "b7_scratch_bytes": slots_cw + rows_cw * row_cw,
        "b7_dp_rows": rows_cw}
    _emit(29, stage="reckoned", taxa=CODON_WIDE_TAXA,
          patterns=CODON_WIDE_PATTERNS, **reckoned_cw)
    t_start = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(29)
    eig_cw = models.GY94.eigen(codon_params["model"], dtype=torch.float64,
                               device=dev)
    rates_cw = discrete_gamma(torch.tensor(codon_params["alpha"],
                                           dtype=torch.float64), 4).to(dev)
    t_cw = torch.as_tensor(np.asarray(wide_c_tree.lengths),
                           dtype=torch.float64, device=dev)
    p_sim = transition_matrices(eig_cw, t_cw[:, None] * rates_cw)
    states = torch.empty((wide_c_tree.n_nodes, CODON_WIDE_PATTERNS),
                         dtype=torch.long, device=dev)
    cat = torch.randint(0, 4, (CODON_WIDE_PATTERNS,), generator=gen,
                        device=dev)
    states[wide_c_tree.root] = torch.multinomial(
        eig_cw.freqs, CODON_WIDE_PATTERNS, replacement=True, generator=gen)
    for node in range(wide_c_tree.n_nodes - 1, -1, -1):  # ids are post-order
        for child in wide_c_tree.children[node]:
            cum = torch.cumsum(p_sim[child, cat, states[node]], dim=1)
            u = torch.rand((CODON_WIDE_PATTERNS, 1), generator=gen,
                           dtype=torch.float64, device=dev) * cum[:, -1:]
            states[child] = (u > cum).sum(dim=1).clamp_max(60)
    codes = states[:wide_c_tree.n_leaves].to(torch.uint8).cpu().numpy()
    del p_sim, states, cat
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t_start
    ca_cw = CompressedAlignment(
        tuple(wide_c_tree.leaf_names), np.eye(61, dtype=np.float32)[codes],
        np.ones(CODON_WIDE_PATTERNS),
        np.arange(CODON_WIDE_PATTERNS, dtype=np.int32))
    del codes
    kw_cw = dict(tree=wide_c_tree, model=models.GY94, ncat=4,
                 dtype=torch.float32, pruner="cuda", device=DEVICE)
    wide_c = LikelihoodEngine(alignment=ca_cw, **kw_cw)
    torch.cuda.synchronize()
    stage_cw = {"simulate": sim_s,
                "engine": time.perf_counter() - t_start - sim_s}
    torch.cuda.empty_cache()
    free_cw = torch.cuda.mem_get_info(dev)[0]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    v_cw, g_cw = wide_c.value_and_grad(codon_params)
    torch.cuda.synchronize()
    stage_cw["value_and_grad_first"] = time.perf_counter() - t0
    cw_counts = read_counts()
    peak_cw = torch.cuda.max_memory_allocated()
    _check(cw_counts.get("CLASSIC_REVERSE_LAUNCHES@64", 0) > 0
           and cw_counts["REVERSE_LAUNCHES"] == 0
           and cw_counts.get("SAVEALL_LAUNCHES@64", 0) > 0,
           f"the full-width codon gradient did not take B2 and B7 alone "
           f"under auto: {cw_counts}")
    # B2's and B7's bounds at this shape (shapes alone: meta tensors)
    p_meta = torch.empty((walk_cw.n_nodes, 4, 64, 64), device="meta")
    l_meta = torch.empty((CODON_WIDE_TAXA, CODON_WIDE_PATTERNS, 64),
                         device="meta")
    bounds_cw = {what: _bound(what, walk_cw, p_meta, l_meta)
                 for what in ("saveall", "classic")}
    cw_vg_ms = _cuda_ms(lambda: wide_c.value_and_grad(codon_params), 1)
    cw_device = _device_us(lambda: wide_c.value_and_grad(codon_params), 1)
    stage_cw["timings"] = (time.perf_counter() - t_start
                           - sum(stage_cw.values()))
    del wide_c
    torch.cuda.empty_cache()
    reset_counts()
    v_ref_cw, g_ref_cw = _chunked_value_and_grad(
        {k: v for k, v in kw_cw.items()}, ca_cw, codon_params,
        CODON_WIDE_SLICES)
    slice_counts = read_counts()
    stage_cw["slices"] = (time.perf_counter() - t_start
                          - sum(stage_cw.values()))
    del ca_cw
    torch.cuda.empty_cache()
    rel_cw = abs(float(v_cw) - v_ref_cw) / abs(v_ref_cw)
    g_err_cw = _grad_errors(g_cw, g_ref_cw)
    _check(slice_counts.get("REVERSE_LAUNCHES@64", 0) > 0
           and slice_counts["CLASSIC_REVERSE_LAUNCHES"] == 0,
           f"the pattern slices did not take B3: {slice_counts}")
    _check(math.isfinite(float(v_cw)) and rel_cw <= LOGL_RTOL
           and max(g_err_cw.values()) <= GRAD_TOL,
           f"full-width codon gradient through B7 against B3 on "
           f"{CODON_WIDE_SLICES} pattern slices: value rel {rel_cw:.3e}, "
           f"grads {g_err_cw}")
    _emit(29, stage="measured", loglik=float(v_cw), loglik_slices=v_ref_cw,
          value_rel_err=rel_cw, grad_rel_err=g_err_cw, launches=cw_counts,
          slice_launches=slice_counts,
          free_bytes_before_the_call=free_cw, peak_allocated_bytes=peak_cw,
          value_and_grad_ms=cw_vg_ms,
          device_us=cw_device, bounds=bounds_cw, b7_gslots=gslots_cw,
          stage_s=stage_cw)
    del g_cw, g_ref_cw

    path_counts = (serve_counts, grad_counts, config4_counts, dna_counts,
                   prot_counts, classic_counts, wide_counts, wide7_counts,
                   unc_counts, wide_auto_counts, wide_engine_counts,
                   *knob_counts.values(), mix_counts, cli_counts,
                   codon_value_counts, codon_grad_counts, codon_fit_counts,
                   b4_counts, b7_counts, b8_counts, b9_counts,
                   *mk_counts.values(), cli_counts_28, cw_counts)

    def launches(name):
        return sum(c[name] for c in path_counts)

    def launches_by_states(name):
        return {str(s_): sum(c.get(f"{name}@{s_}", 0) for c in path_counts)
                for s_ in cuda_pruning.KERNEL_STATES}

    def kernel(name, source, line, counter, err, timing, what, inputs,
               wide=None):
        """The kernel's entry; ``wide``: (its phase-27 key, its error) at 64
        states, reported as ``states_64``."""
        bound_ms, bound_by = _bound(what, *inputs[:3])
        entry = {"name": name, "route": "cuda",
                 "source": f"phylo_utils_tpu_torch/csrc/{source}",
                 "replaces": f"phylo_utils_tpu/ops/pallas_pruning.py:{line}",
                 "launches": launches(counter),
                 "launches_by_states": launches_by_states(counter),
                 "max_abs_err": err,
                 "ms": timing["ms"], "plain_ms": timing["plain_ms"],
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": None}
        if wide is not None:
            t64 = timings_64[wide[0]]
            entry["states_64"] = {
                "shape": t64["shape"], "launches": launches_by_states(
                    counter)["64"],
                "max_abs_err": wide[1], "ms": t64["ms"],
                "plain_ms": t64["plain_ms"], "bound_ms": t64["bound_ms"],
                "bound_by": t64["bound_by"], "device": t64["device"]}
        return entry

    flagship = timing_inputs[BATCH]
    print(json.dumps({"kernels": [
        kernel("pruning_forward_f32", "pruning_forward.cu", 520, "LAUNCHES",
               max_err, timings[f"forward_B{BATCH}"], "forward", flagship,
               ("forward", codon_err["gy94"]["B1"])),
        kernel("pruning_saveall_f32", "pruning_forward.cu", 840,
               "SAVEALL_LAUNCHES", b2_max, timings[f"saveall_B{BATCH}"],
               "saveall", flagship, ("saveall", codon_err["gy94"]["B2"])),
        kernel("pruning_reverse_f32", "pruning_reverse.cu", 966,
               "REVERSE_LAUNCHES", b3_max, timings[f"reverse_B{BATCH}"],
               "reverse", flagship, ("reverse", codon_err["gy94"]["B3_dP"])),
        kernel("pruning_slot_f32", "pruning_slot.cu", 642, "SLOT_LAUNCHES",
               max(slot_err["slot"].values()), timings["slot"], "slot",
               case_inputs[big_dna_key], ("slot", codon_err["gy94"]["B4"])),
        kernel("pruning_stream_f32", "pruning_slot.cu", 704,
               "STREAM_LAUNCHES", max(slot_err["stream"].values()),
               timings["stream"], "stream", case_inputs[protein_key],
               ("stream", codon_err["gy94"]["B5"])),
        kernel("pruning_classic_reverse_f32", "pruning_classic_reverse.cu",
               879, "CLASSIC_REVERSE_LAUNCHES", b7_max,
               timings[f"classic_B{BATCH}"], "classic", flagship,
               ("classic", codon_err["gy94"]["B7_dP"])),
        kernel("pruning_fold_f32", "pruning_fold.cu", 333, "FOLD_LAUNCHES",
               b9_max, timings[f"fold_B{BATCH}"], "forward", flagship,
               ("fold", codon_err["gy94_vertebrate_mito"]["B9"])),
        kernel("pruning_static_f32", "pruning_static.cu", 402,
               "STATIC_LAUNCHES", b8_max, timings[f"static_B{BATCH}"],
               "forward", flagship,
               ("static", codon_err["gy94_vertebrate_mito"]["B8"])),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
