#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``phylo_utils_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It builds the
CUDA kernels from ``phylo_utils_tpu_torch/csrc`` (one ``nvcc`` per source,
all at once) and runs, in order, printing one line per phase:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the ``nvcc`` build, with its wall time;
3. the forward kernel (the classic walk) against its plain-PyTorch walk on
   the card, at the flagship shapes (64 taxa, 4 categories, 1024 and 1000
   sites, B = 1 and 64), on a 512-taxon caterpillar tree, and at 20 states
   (LG) on BASELINE config 4's 32-taxon shape and the 512-taxon protein
   tree at 8192 patterns;
4. the flagship engine (64 taxa, 1024 sites, GTR+G4+I, f32 ``pruner="cuda"``)
   against the port's own f64 ``pruner="torch"`` path, single and batched;
5. the same at 64 taxa x 100,000 sites;
6. ``EngineServer`` on localhost answering /health, /loglik, /sitewise and
   /bootstrap with the engine's values;
7. the saveall kernel against its plain version at phase 3's shapes, its
   root row bit-identical to the forward kernel's root;
8. the reverse kernel against its plain version at the same shapes (dP and
   the leaves' cotangent), dP bit-identical across two launches;
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
    DNA and 512-taxon protein trees (8192 patterns) and the 512-taxon
    caterpillar;
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
    ``value_and_grad`` times with each pruner, and fit steps per second.

Every check raises, so any failure exits non-zero without the final line.
The launch counts are set to 0 just before each path and read just after
it: phases 4-6 (serving), 9-11 (gradient and fit), 13, 14 and 15; the
kernel-against-plain phases are not counted. The last two lines are a JSON
record of the kernels, each with its time, its plain version's, and its
bound (the larger of its bytes over 3.35 TB/s and its f32 operations over
67 TFLOP/s, the H100 SXM data sheet's peaks), and
``{"ok": true, "device": {...}}``.
"""
import functools
import json
import math
import subprocess
import sys
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

# shapes (the flagship, BASELINE configs 4 and 5, the big trees)
DEVICE = "cuda"
TAXA, SITES, BATCH, BIG_SITES, CATERPILLAR = 64, 1024, 64, 100_000, 512
CONFIG5_TAXA, FIT_STEPS = 128, 15
CONFIG4_TAXA = 32
BIG_DNA_TAXA, BIG_PROTEIN_TAXA, BIG_PATTERNS, BIG_BATCH = 1000, 512, 8192, 16
BIG_DNA_PARAMS = {"model": FLAGSHIP_PARAMS["model"], "alpha": 0.5}
PROTEIN_PARAMS = {"alpha": 0.7}
AMINO = "ARNDCQEGHILKMFPSTWYV"
# H100 SXM data sheet peaks, for each kernel's bound
PEAK_BYTES_PER_S, PEAK_F32_FLOPS = 3.35e12, 67e12


def _fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def _check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def _emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _caterpillar(n, brlen):
    return "(" * (n - 1) + f"t0:{brlen}" + "".join(
        f",t{i}:{brlen})" + (f":{brlen}" if i < n - 1 else "")
        for i in range(1, n)) + ";"


def _simulate(tree, p_edges, n_sites, freqs, rng):
    """DNA sites evolved down ``tree``: ``p_edges`` (n_nodes, K, 4, 4) float64
    numpy transition matrices per edge and rate category; each site draws a
    category, the root draws from ``freqs``."""
    import numpy as np

    k = p_edges.shape[1]
    cat = rng.integers(0, k, n_sites)
    states = np.zeros((tree.n_nodes, n_sites), np.int64)
    states[tree.root] = rng.choice(4, n_sites, p=freqs)
    for node in range(tree.n_nodes - 1, -1, -1):  # ids are post-order
        for child in tree.children[node]:
            cum = np.cumsum(p_edges[child, cat, states[node]], axis=1)
            u = rng.random(n_sites)[:, None] * cum[:, -1:]
            states[child] = (u > cum).sum(axis=1)
    chars = np.frombuffer(b"ACGT", np.uint8)[states[:tree.n_leaves]]
    return {name: chars[i].tobytes().decode()
            for i, name in enumerate(tree.leaf_names)}


def _max_rel(got, want):
    """max |got - want| / max |want| over all entries."""
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-300))


def _grad_errors(got, want):
    from phylo_utils_tpu_torch.convert import flatten_params

    paths, g = flatten_params(got)
    _, w = flatten_params(want)
    return {".".join(p): _max_rel(a, b) for p, a, b in zip(paths, g, w)}


def _chunked_value_and_grad(engine_kw, ca, params, n_chunks):
    """``value_and_grad`` of an engine on ``ca``, summed over engines on
    ``n_chunks`` slices of its patterns: the logL is a weighted sum over
    patterns, so value and gradient add up. The f64 ``pruner="torch"``
    autograd keeps every level's intermediates: at 512 taxa x 8192 protein
    patterns x 4 categories it ran out of an 80 GB H100's memory with 76 GB
    allocated; a slice keeps a share of that."""
    import numpy as np

    from phylo_utils_tpu_torch.io import CompressedAlignment
    from phylo_utils_tpu_torch.likelihood import LikelihoodEngine

    total, grads = 0.0, None
    for sl in np.array_split(np.arange(ca.n_patterns), n_chunks):
        part = CompressedAlignment(ca.names, ca.partials[:, sl], ca.weights[sl],
                                   np.arange(len(sl), dtype=np.int32))
        v, g = LikelihoodEngine(alignment=part, **engine_kw).value_and_grad(
            params)
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
            k = re.search(r"\d(pruning_\w+?)I((?:L[ib]\d+E)+)E", m.group(1))
            name = (f"{k.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', k.group(2)))}>"
                    if k else m.group(1))
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "registers" in ln and name is not None:
            out[name] = f"{ln.split(':', 1)[1].strip()}; {spill}"
            name = None
    return out


def _random_alignment(names, n_sites, chars, seed):
    import numpy as np

    codes = np.frombuffer(chars.encode(), np.uint8)[
        np.random.default_rng(seed).integers(0, len(chars),
                                             (len(names), n_sites))]
    return {n: codes[i].tobytes().decode() for i, n in enumerate(names)}


def _bound(kind, walk, p, leaves):
    """(bound_ms, bound_by) of one launch of kernel ``kind`` on these
    inputs: each input read once and each output written once at the
    card's memory rate, against the walk's f32 operations at the peak f32
    rate of the CUDA cores. Operations per (batch, category, site) column:
    per child edge an S x S contraction (2 S^2) and the product (S), per
    node the rescale (2 S); the reverse walk adds P^T per internal node,
    a sibling contraction and the gy product per edge, and dP (2 S^2) per
    edge."""
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
    else:   # forward, slot, stream: the root and its exponent count
        nbytes += 4 * cols * (s + 1)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


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

    from phylo_utils_tpu_torch import models
    from phylo_utils_tpu_torch.io import parse_newick
    from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
    from phylo_utils_tpu_torch.ops import _build, cuda_pruning
    from phylo_utils_tpu_torch.convert import flatten_params
    from phylo_utils_tpu_torch.ops.cuda_pruning import (
        WalkSchedule,
        forward_walk,
        forward_walk_reference,
        reverse_walk,
        reverse_walk_reference,
        saveall_walk,
        saveall_walk_reference,
        slot_walk_reference,
    )
    from phylo_utils_tpu_torch.ops.gamma import discrete_gamma
    from phylo_utils_tpu_torch.ops.pmatrix import (
        extend_p_identity,
        transition_matrices,
    )
    from phylo_utils_tpu_torch.ops.pruning import LN2
    from phylo_utils_tpu_torch.optimize import fit
    from phylo_utils_tpu_torch.server import EngineServer
    from phylo_utils_tpu_torch.trees import compile_schedule, random_tree

    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    counters = ("LAUNCHES", "SLOT_LAUNCHES", "STREAM_LAUNCHES",
                "SAVEALL_LAUNCHES", "REVERSE_LAUNCHES")

    def reset_counts():
        for name in counters:
            setattr(cuda_pruning, name, 0)

    def read_counts():
        return {name: getattr(cuda_pruning, name) for name in counters}

    def cuda_ms(fn, reps):
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

    # 1. the card ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _emit(1, device=kind, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    info = _build.build_info()
    ptxas = _ptxas_table(info["log"])
    _emit(2, build_s=round(time.perf_counter() - t0, 3), built=info["built"],
          library=str(Path(info["path"]).relative_to(REPO)), ptxas=ptxas)

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

    flagship_tree = random_tree(TAXA, seed=0)
    caterpillar = parse_newick(_caterpillar(CATERPILLAR, 0.3))
    big_dna_tree = random_tree(BIG_DNA_TAXA, seed=10)
    big_protein_tree = random_tree(BIG_PROTEIN_TAXA, seed=11)
    config4_tree = random_tree(CONFIG4_TAXA, seed=13, mean_brlen=0.2)
    cases = [("flagship", flagship_tree, s, b, 4)
             for b in (1, BATCH) for s in (SITES, SITES - 24)]
    cases += [(f"caterpillar{CATERPILLAR}", caterpillar, SITES, 1, 4),
              ("config4", config4_tree, SITES, 1, 20),
              (f"protein{BIG_PROTEIN_TAXA}", big_protein_tree, BIG_PATTERNS,
               1, 20)]
    max_err = 0.0
    errors = {}
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
    _emit(3, max_abs_err=errors)
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
    b2_err, b2_max = {}, 0.0
    for key, (walk, p, leaves, _) in case_inputs.items():
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
        del rx, re, wx, we, shifted
    _emit(7, max_abs_err=b2_err)

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
    slot_err = {"slot": {}, "stream": {}}
    for key, (walk, p, leaves, f) in slot_cases.items():
        kp, ke = forward_walk(p, leaves, walk, walk="classic")
        rp, re = slot_walk_reference(p, leaves, walk)
        want = site_ll(rp, re, f)
        tol = len(walk.order) * 2.0 ** -21
        for how in ("slot", "stream"):
            sp, se = forward_walk(p, leaves, walk, walk=how)
            torch.cuda.synchronize()
            _check(torch.equal(sp, kp) and torch.equal(se, ke),
                   f"{key}: the {how} walk's root is not the forward "
                   "kernel's bit for bit")
            err = float((site_ll(sp, se, f) - want).abs().max())
            _check(err <= tol, f"{key}: {how} kernel vs plain walk max "
                   f"|dlogL| {err:.3e} > {tol:.3e}")
            slot_err[how][key] = err
        del kp, ke, rp, re, sp, se
    _emit(12, max_abs_err=slot_err, bit_identical_to_forward=True,
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
          loglik_ms=cuda_ms(lambda: dna32.loglikelihood(BIG_DNA_PARAMS), 5),
          many_ms=cuda_ms(
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
          loglik_ms=cuda_ms(lambda: prot32.loglikelihood(PROTEIN_PARAMS), 5),
          value_and_grad_ms=cuda_ms(
              lambda: prot32.value_and_grad(PROTEIN_PARAMS), 3))
    del prot32, vp, gp, vp_ref, gp_ref
    torch.cuda.empty_cache()

    # 16. timing --------------------------------------------------------------
    def in_turns(kernel, plain, reps, plain_reps):
        t = [cuda_ms(plain, plain_reps), cuda_ms(kernel, reps),
             cuda_ms(kernel, reps), cuda_ms(plain, plain_reps)]
        return {"ms": (t[1] + t[2]) / 2, "plain_ms": (t[0] + t[3]) / 2,
                "runs": t}

    timings = {}
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
        reps = 100 if label == "flagship_B1" else 20
        fns = {how: functools.partial(forward_walk, p, leaves, walk,
                                      walk=how)
               for how in ("classic", "slot", "stream")}
        order = ["classic", "slot", "stream", "stream", "slot", "classic"]
        runs = {how: [] for how in fns}
        for how in order:
            runs[how].append(cuda_ms(fns[how], reps))
        walk_times[label] = {
            how: {"ms": sum(t) / len(t), "runs": t}
            for how, t in runs.items()}
        dims = (p.shape[0] if p.dim() == 5 else 1, p.shape[-3],
                walk.n_nodes - walk.n_leaves, leaves.shape[1],
                leaves.shape[2])
        walk_times[label]["classic_scratch_bytes"] = math.prod(
            dims[:4]) * (dims[4] + 1) * 4
        walk_times[label]["choice"] = cuda_pruning.choose_walk(*dims)
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
        timings[f"engine_loglik_{label}_ms"] = cuda_ms(
            lambda: e.loglikelihood(FLAGSHIP_PARAMS), 20)
        timings[f"engine_many_B64_{label}_ms"] = cuda_ms(
            lambda: e.loglikelihood_many(bl, FLAGSHIP_PARAMS), 5)
        timings[f"engine_value_and_grad_{label}_ms"] = cuda_ms(
            lambda: e.value_and_grad(FLAGSHIP_PARAMS), 10)
        timings[f"engine_value_and_grad_many_B64_{label}_ms"] = cuda_ms(
            lambda: e.value_and_grad_many(bl, FLAGSHIP_PARAMS), 5)
    adam = functools.partial(torch.optim.Adam, lr=1e-2)
    fit(fit_eng, optimizer=adam, max_steps=2, patience=10 ** 6)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit(fit_eng, optimizer=adam, max_steps=50, patience=10 ** 6)
    torch.cuda.synchronize()
    timings["config5_fit_lbfgs_steps_per_s"] = res.n_steps / fit_s
    timings["config5_fit_adam_steps_per_s"] = 50 / (time.perf_counter() - t0)
    _emit(16, shapes=f"{TAXA} taxa, K=4, {SITES} sites, S=4; protein "
          f"{BIG_PROTEIN_TAXA} taxa, {BIG_PATTERNS} patterns, S=20",
          timings=timings, walks=walk_times)

    path_counts = (serve_counts, grad_counts, config4_counts, dna_counts,
                   prot_counts)

    def launches(name):
        return sum(c[name] for c in path_counts)

    def kernel(name, source, line, counter, err, timing, what, inputs):
        bound_ms, bound_by = _bound(what, *inputs[:3])
        return {"name": name, "route": "cuda",
                "source": f"phylo_utils_tpu_torch/csrc/{source}",
                "replaces": f"phylo_utils_tpu/ops/pallas_pruning.py:{line}",
                "launches": launches(counter), "max_abs_err": err,
                "ms": timing["ms"], "plain_ms": timing["plain_ms"],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None}

    flagship = timing_inputs[BATCH]
    print(json.dumps({"kernels": [
        kernel("pruning_forward_f32", "pruning_forward.cu", 520, "LAUNCHES",
               max_err, timings[f"forward_B{BATCH}"], "forward", flagship),
        kernel("pruning_saveall_f32", "pruning_forward.cu", 840,
               "SAVEALL_LAUNCHES", b2_max, timings[f"saveall_B{BATCH}"],
               "saveall", flagship),
        kernel("pruning_reverse_f32", "pruning_reverse.cu", 966,
               "REVERSE_LAUNCHES", b3_max, timings[f"reverse_B{BATCH}"],
               "reverse", flagship),
        kernel("pruning_slot_f32", "pruning_slot.cu", 642, "SLOT_LAUNCHES",
               max(slot_err["slot"].values()), timings["slot"], "slot",
               case_inputs[big_dna_key]),
        kernel("pruning_stream_f32", "pruning_slot.cu", 704,
               "STREAM_LAUNCHES", max(slot_err["stream"].values()),
               timings["stream"], "stream", case_inputs[protein_key]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
