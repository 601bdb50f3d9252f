#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``phylo_utils_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It builds the
CUDA pruning kernel from ``phylo_utils_tpu_torch/csrc`` and runs, in order,
printing one line per phase:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the ``nvcc`` build, with its wall time;
3. the kernel against its plain-PyTorch walk on the card, at the flagship
   shapes (64 taxa, 4 categories, 1024 and 1000 sites, B = 1 and 64) and on
   a 512-taxon caterpillar tree;
4. the flagship engine (64 taxa, 1024 sites, GTR+G4+I, f32 ``pruner="cuda"``)
   against the port's own f64 ``pruner="torch"`` path, single and batched;
5. the same at 64 taxa x 100,000 sites;
6. ``EngineServer`` on localhost answering /health, /loglik, /sitewise and
   /bootstrap with the engine's values;
7. kernel time against the plain walk's time (CUDA events), plus the
   engine's evaluation time with each pruner.

Every check raises, so any failure exits non-zero without the final line.
The kernel launch count is reset just before phase 4 and read after phase 6:
it counts the launches of the main path only. The last two lines are a JSON
record of the kernel and ``{"ok": true, "device": {...}}``.
"""
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
    from phylo_utils_tpu_torch.ops.cuda_pruning import (
        WalkSchedule,
        forward_walk,
        forward_walk_reference,
    )
    from phylo_utils_tpu_torch.ops.gamma import discrete_gamma
    from phylo_utils_tpu_torch.ops.pmatrix import (
        extend_p_identity,
        transition_matrices,
    )
    from phylo_utils_tpu_torch.ops.pruning import LN2
    from phylo_utils_tpu_torch.server import EngineServer
    from phylo_utils_tpu_torch.trees import compile_schedule, random_tree

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

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
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    _emit(2, build_s=round(time.perf_counter() - t0, 3), built=info["built"],
          library=str(Path(info["path"]).relative_to(REPO)), ptxas=ptxas)

    # 3. kernel vs plain walk on the card ------------------------------------
    freqs = torch.tensor(FLAGSHIP_PARAMS["model"]["freqs"],
                         dtype=torch.float64, device=dev)
    eig = models.GTR.eigen(FLAGSHIP_PARAMS["model"], dtype=torch.float64,
                           device=dev)
    rates = discrete_gamma(torch.tensor(FLAGSHIP_PARAMS["alpha"],
                                        dtype=torch.float64), 4).to(dev)
    rng = np.random.default_rng(0)

    def walk_inputs(tree, sites, batch):
        sched = compile_schedule(tree)
        lengths = np.asarray(tree.lengths)
        if batch > 1:
            lengths = lengths * rng.uniform(0.5, 2.0, (batch, 1))
        t = torch.as_tensor(lengths, dtype=torch.float64, device=dev)
        p = transition_matrices(eig, t[..., None] * rates,
                                out_dtype=torch.float32)
        p = extend_p_identity(p, sched.n_nodes).contiguous()
        codes = rng.integers(0, 4, (tree.n_leaves, sites))
        leaves = np.eye(4, dtype=np.float32)[codes]
        leaves[rng.random((tree.n_leaves, sites)) < 0.02] = 1.0
        return WalkSchedule(sched), p, torch.as_tensor(leaves, device=dev)

    def site_ll(root_p, root_e):
        return torch.log(root_p.double() @ freqs) + root_e.double() * LN2

    flagship_tree = random_tree(64, seed=0)
    cases = [("flagship", flagship_tree, s, b)
             for b in (1, 64) for s in (1024, 1000)]
    cases.append(("caterpillar512", parse_newick(_caterpillar(512, 0.3)),
                  1024, 1))
    max_err = 0.0
    errors = {}
    timing_inputs = {}
    for name, tree, sites, batch in cases:
        walk, p, leaves = walk_inputs(tree, sites, batch)
        kp, ke = forward_walk(p, leaves, walk)
        torch.cuda.synchronize()
        rp, re = forward_walk_reference(p, leaves, walk)
        got, want = site_ll(kp, ke), site_ll(rp, re)
        _check(bool(torch.isfinite(got).all()),
               f"{name}: non-finite kernel output")
        err = float((got - want).abs().max())
        # worst case: each internal node adds a few f32 roundings to the
        # root's relative error; the two walks round differently
        tol = len(walk.order) * 2.0 ** -21
        _check(err <= tol, f"{name} B={batch} sites={sites}: kernel vs "
               f"plain walk max |dlogL| {err:.3e} > {tol:.3e}")
        errors[f"{name}_B{batch}_S{sites}"] = err
        max_err = max(max_err, err)
        if name == "flagship" and sites == 1024:
            timing_inputs[batch] = (walk, p, leaves)
    _emit(3, max_abs_err=errors)

    # 4. flagship engine, main path ------------------------------------------
    rng_aln = np.random.default_rng(1)
    aln = {n: "".join(rng_aln.choice(list("ACGT"), size=1024))
           for n in flagship_tree.leaf_names}
    kw = dict(ncat=4, invariant_sites=True, device="cuda")
    eng = LikelihoodEngine(flagship_tree, aln, models.GTR,
                           dtype=torch.float32, pruner="cuda", **kw)
    ref = LikelihoodEngine(flagship_tree, aln, models.GTR,
                           dtype=torch.float64, pruner="torch", **kw)
    cuda_pruning.LAUNCHES = 0
    ll = eng.loglikelihood(FLAGSHIP_PARAMS)
    _check(cuda_pruning.LAUNCHES > 0, "the engine did not launch the kernel")
    ll_ref = ref.loglikelihood(FLAGSHIP_PARAMS)
    rel = abs(ll - ll_ref) / abs(ll_ref)
    _check(math.isfinite(ll) and rel <= LOGL_RTOL,
           f"flagship logL {ll} vs f64 {ll_ref}: rel {rel:.3e}")
    sw = eng.sitewise_loglikelihoods(FLAGSHIP_PARAMS)
    sw_ref = ref.sitewise_loglikelihoods(FLAGSHIP_PARAMS)
    _check(sw.shape == (1024,) and np.isfinite(sw).all(), "bad sitewise")
    bl = np.asarray(flagship_tree.lengths) * np.random.default_rng(3).uniform(
        0.5, 2.0, (64, 1))
    many = eng.loglikelihood_many(bl, FLAGSHIP_PARAMS)
    many_ref = ref.loglikelihood_many(bl, FLAGSHIP_PARAMS)
    rel_many = float(np.max(np.abs(many - many_ref) / np.abs(many_ref)))
    _check(many.shape == (64,) and rel_many <= LOGL_RTOL,
           f"loglikelihood_many rel {rel_many:.3e}")
    _emit(4, loglik=ll, loglik_f64=ll_ref, rel_err=rel,
          sitewise_max_abs_err=float(np.max(np.abs(sw - sw_ref))),
          many_B64_max_rel_err=rel_many, launches=cuda_pruning.LAUNCHES)

    # 5. realistic scale: 64 taxa x 100,000 sites ----------------------------
    rng_big = np.random.default_rng(2)
    chars = np.frombuffer(b"ACGT", np.uint8)[
        rng_big.integers(0, 4, (64, 100_000))]
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
    del big, big_ref

    # 6. server --------------------------------------------------------------
    srv = EngineServer(eng, port=0)
    port = srv.start()
    try:
        base = f"http://127.0.0.1:{port}"

        def post(route, body):
            req = urllib.request.Request(
                base + route, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.loads(r.read())

        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        _check(health["status"] == "ok" and health["device_name"] == kind,
               f"bad /health {health}")
        got = post("/loglik", {"params": FLAGSHIP_PARAMS})["loglik"]
        _check(abs(got - ll) <= 1e-12 * abs(ll), f"/loglik {got} != {ll}")
        got_sw = np.asarray(post("/sitewise",
                                 {"params": FLAGSHIP_PARAMS})["sitewise"])
        _check(got_sw.shape == sw.shape
               and float(np.max(np.abs(got_sw - sw))) <= 1e-9,
               "/sitewise disagrees with the engine")
        boots = np.asarray(post("/bootstrap", {"n": 100, "seed": 4,
                                               "params": FLAGSHIP_PARAMS})
                           ["logliks"])
        want_boots = eng.bootstrap_loglikelihoods(100, FLAGSHIP_PARAMS, seed=4)
        _check(boots.shape == (100,) and np.allclose(boots, want_boots,
                                                     rtol=1e-12, atol=0),
               "/bootstrap disagrees with the engine")
    finally:
        srv.stop()
    main_launches = cuda_pruning.LAUNCHES
    _emit(6, health=health, loglik=got, sitewise_n=int(got_sw.shape[0]),
          bootstrap_mean=float(boots.mean()), launches=main_launches)

    # 7. timing --------------------------------------------------------------
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

    timings = {}
    for batch, (walk, p, leaves) in sorted(timing_inputs.items()):
        def kernel():
            forward_walk(p, leaves, walk)

        def plain():
            forward_walk_reference(p, leaves, walk)

        # in turns on one card: plain, kernel, kernel, plain
        reps = 200 if batch == 1 else 50
        t = [cuda_ms(plain, 5), cuda_ms(kernel, reps),
             cuda_ms(kernel, reps), cuda_ms(plain, 5)]
        timings[f"B{batch}"] = {"ms": (t[1] + t[2]) / 2,
                                "plain_ms": (t[0] + t[3]) / 2,
                                "runs": t}
    eng_torch = LikelihoodEngine(flagship_tree, aln, models.GTR,
                                 dtype=torch.float32, pruner="torch", **kw)
    for label, e in (("cuda", eng), ("torch", eng_torch)):
        timings[f"engine_loglik_{label}_ms"] = cuda_ms(
            lambda: e.loglikelihood(FLAGSHIP_PARAMS), 20)
        timings[f"engine_many_B64_{label}_ms"] = cuda_ms(
            lambda: e.loglikelihood_many(bl, FLAGSHIP_PARAMS), 5)
    _emit(7, shapes="64 taxa, K=4, 1024 sites, S=4", timings=timings)

    print(json.dumps({"kernels": [{
        "name": "pruning_forward_f32",
        "route": "cuda",
        "source": "phylo_utils_tpu_torch/csrc/pruning_forward.cu",
        "replaces": "phylo_utils_tpu/ops/pallas_pruning.py:520",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": timings["B64"]["ms"],
        "plain_ms": timings["B64"]["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
