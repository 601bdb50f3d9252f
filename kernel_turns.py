#!/usr/bin/env python3
"""Time the deferred reverse (B3, ``pruning_reverse_f32``) and the stream
walk (B5, ``pruning_stream_f32``) against an earlier version of their
sources, in turns, on one NVIDIA GPU.

Usage, from the root of a checkout::

    python3 kernel_turns.py --parent DIR

``DIR`` holds the earlier ``pruning_reverse.cu``, ``pruning_slot.cu`` and
``pruning_common.cuh``, for example unpacked from an earlier commit with
``git archive <commit> phylo_utils_tpu_torch/csrc | tar -x -C DIR
--strip-components 2``. The script builds them with ``nvcc`` into
``build/kernel_turns/`` beside the current library (``ops/_build.py``), and
binds them with the C signatures they had before the deferred reverse took
``ReverseSchedule``'s arrays and summed dP inside its walk (B3: order,
children and counts, a gy store and dP; B5: unchanged). Then, on the same inputs:

1. checks: the current B5 root bit for bit the earlier one's and the
   forward kernel's; the current B3 dP within 1e-4 x max|dP| of the
   earlier one's and of its plain version, bit-identical across two
   launches, with a zero root row; also on a tree with a trifurcating root
   and a 4-child node;
2. times each kernel in turns (earlier, current, current, earlier; CUDA
   events over repeated launches) at the flagship (64 taxa, GTR+G4, 1024
   sites) at B = 1 and 64 and on the 512-taxon LG+G4 tree at 8192
   patterns;
3. reads each kernel's device time per launch from ``torch.profiler``
   (B = 1 launches are paced by the host, so event times there are the
   host's), and times B3 at each block width (``reverse_tile`` picks the
   widest that fits);
4. counts shared-memory loads (``LDS`` by width) and FMAs in the SASS of
   both stream kernels at 20 states (``cuobjdump -sass``), and lists both
   builds' ptxas registers and spills.

It prints the card's ``nvidia-smi`` name and power limit, then one JSON
object, also written to ``--out`` (default ``build/kernel_turns.json``).
"""
import argparse
import collections
import ctypes
import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
TOL = 1e-4     # x max|dP|: two f32 walks summing over sites in other orders
WIDE_ROOT = ("((a:0.1,b:0.2,c:0.3,d:0.1):0.1,(e:0.2,(f:0.1,g:0.3):0.2):0.3,"
             "h:0.2);")


def _build_parent(parent: Path, nvcc_flags, nvcc):
    """The earlier B3 and B5 sources as one library; (library, ptxas
    output)."""
    out_dir = REPO / "build" / "kernel_turns"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libparent.so"
    res = subprocess.run(
        [nvcc, *nvcc_flags, "-shared", "-o", str(lib_path),
         str(parent / "pruning_reverse.cu"), str(parent / "pruning_slot.cu")],
        capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on the earlier sources\n{res.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.pruning_reverse_f32.argtypes = [vp] * 12 + [ci] * 9 + [vp]
    lib.pruning_stream_f32.argtypes = [vp] * 11 + [ci] * 8 + [vp]
    lib.pruning_reverse_f32.restype = ci
    lib.pruning_stream_f32.restype = ci
    return lib, lib_path, res.stdout + res.stderr


def _sass_counts(lib_path: Path, pattern: str):
    """{function: {opcode: count}} of the LDS and FFMA instructions of
    every function whose mangled name matches ``pattern``."""
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1) if re.search(pattern, m.group(1)) else None
            if name:
                counts[name] = collections.Counter()
            continue
        if name is None:
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                       ln)
        if op and (op.group(1).startswith("LDS") or op.group(1) == "FFMA"):
            counts[name][op.group(1)] += 1
    return {k: dict(v) for k, v in counts.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="directory of the earlier pruning_reverse.cu, "
                    "pruning_slot.cu and pruning_common.cuh")
    ap.add_argument("--out", type=Path,
                    default=REPO / "build" / "kernel_turns.json",
                    help="where to write the JSON result")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_turns: torch.cuda.is_available() is False: this "
                 "script needs a GPU")
    from chip_smoke import _bound, _cuda_ms, _device_us, _ptxas_table
    from phylo_utils_tpu_torch import models
    from phylo_utils_tpu_torch.io import parse_newick
    from phylo_utils_tpu_torch.ops import _build, cuda_pruning
    from phylo_utils_tpu_torch.ops.cuda_pruning import (
        WalkSchedule, forward_walk, reverse_walk, reverse_walk_reference,
        saveall_walk, slot_walk)
    from phylo_utils_tpu_torch.ops.gamma import discrete_gamma
    from phylo_utils_tpu_torch.ops.pmatrix import (
        extend_p_identity, transition_matrices)
    from phylo_utils_tpu_torch.trees import compile_schedule, random_tree

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.load_library()
    cur_path = Path(_build.build_info()["path"])
    old, old_path, old_log = _build_parent(args.parent, _build.NVCC_FLAGS,
                                           _build._nvcc())
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rates = discrete_gamma(torch.tensor(0.5, dtype=torch.float64), 4).to(dev)
    eigs = {4: models.GTR.eigen({"rates": [1.2, 3.1, 0.7, 0.9, 4.2, 1.0],
                                 "freqs": [0.3, 0.2, 0.22, 0.28]},
                                dtype=torch.float64, device=dev),
            20: models.LG.eigen(dtype=torch.float64, device=dev)}

    def inputs(tree, sites, batch, s):
        sched = compile_schedule(tree)
        lengths = np.asarray(tree.lengths)
        if batch > 1:
            lengths = lengths * rng.uniform(0.5, 2.0, (batch, 1))
        t = torch.as_tensor(lengths, dtype=torch.float64, device=dev)
        p = extend_p_identity(transition_matrices(
            eigs[s], t[..., None] * rates, out_dtype=torch.float32),
            sched.n_nodes).contiguous()
        leaves = np.eye(s, dtype=np.float32)[
            rng.integers(0, s, (tree.n_leaves, sites))]
        leaves[rng.random((tree.n_leaves, sites)) < 0.02] = 1.0
        return (WalkSchedule(sched), p, torch.as_tensor(leaves, device=dev),
                eigs[s].freqs.float())

    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def old_reverse(walk, p, leaves, rx, re, lam, f):
        pb, rxb, reb, lmb = (p, rx, re, lam) if p.dim() == 5 else (
            p[None], rx[None], re[None], lam[None])
        b, n_nodes, k = pb.shape[:3]
        sites, s = leaves.shape[1:]
        order, children, counts = walk.on(dev)
        gy = torch.empty((b, k, n_nodes, sites, s), device=dev)
        dp = torch.empty_like(pb)
        rc = old.pruning_reverse_f32(
            pb.data_ptr(), leaves.data_ptr(), order.data_ptr(),
            children.data_ptr(), counts.data_ptr(), rxb.data_ptr(),
            reb.data_ptr(), lmb.data_ptr(), f.data_ptr(), gy.data_ptr(),
            dp.data_ptr(), None, b, k, s, n_nodes, walk.n_leaves,
            len(walk.order), children.shape[1], sites, walk.root, stream())
        assert rc == 0, f"earlier pruning_reverse_f32: CUDA error {rc}"
        return dp if p.dim() == 5 else dp[0]

    def old_stream(walk, p, leaves):
        pb = p if p.dim() == 5 else p[None]
        b, _, k = pb.shape[:3]
        sites, s = leaves.shape[1:]
        sl = walk.slots
        nslot, cnode, csrc, cleaf, counts = sl.on(dev)
        slots = torch.empty((b, k, sl.n_slots, sites, s), device=dev)
        slots_e = torch.empty((b, k, sl.n_slots, sites), device=dev)
        root = torch.empty((b, k, sites, s), device=dev)
        root_e = torch.empty((b, k, sites), device=dev)
        rc = old.pruning_stream_f32(
            pb.data_ptr(), leaves.data_ptr(), nslot.data_ptr(),
            cnode.data_ptr(), csrc.data_ptr(), cleaf.data_ptr(),
            counts.data_ptr(), slots.data_ptr(), slots_e.data_ptr(),
            root.data_ptr(), root_e.data_ptr(), b, k, s, walk.n_nodes,
            sl.n_slots, len(sl.nslot), cnode.shape[1], sites, stream())
        assert rc == 0, f"earlier pruning_stream_f32: CUDA error {rc}"
        return (root, root_e) if p.dim() == 5 else (root[0], root_e[0])

    tree_flag = random_tree(64, seed=0)
    tree_lg = random_tree(512, seed=11)
    shapes = {
        "flagship_B1": inputs(tree_flag, 1024, 1, 4),
        "flagship_B64": inputs(tree_flag, 1024, 64, 4),
        "protein512_LG": inputs(tree_lg, 8192, 1, 20),
        "wide_root_S4_B3": inputs(parse_newick(WIDE_ROOT), 301, 3, 4),
        "wide_root_S20_B3": inputs(parse_newick(WIDE_ROOT), 301, 3, 20),
    }
    result = {"card": smi, "build_s": build_s, "checks": {}, "turns": {},
              "device_us": {}, "b3_tiles": {}}
    for label, (walk, p, leaves, f) in shapes.items():
        rx, re = saveall_walk(p, leaves, walk)
        row = walk.root - walk.n_leaves
        lam = (1.0 / torch.einsum("...ksi,i->...ks",
                                  rx[..., row, :, :].double(), f.double())
               ).float().contiguous()
        new_b3 = functools.partial(reverse_walk, p, leaves, rx, re, lam, f,
                                   walk)
        old_b3 = functools.partial(old_reverse, walk, p, leaves, rx, re, lam,
                                   f)
        new_b5 = functools.partial(slot_walk, p, leaves, walk, stream=True)
        old_b5 = functools.partial(old_stream, walk, p, leaves)
        dp, _ = new_b3()
        dp2, _ = new_b3()
        dpo = old_b3()
        torch.cuda.synchronize()
        wp, _ = reverse_walk_reference(p, leaves, rx, re, lam, f, walk)
        scale = float(wp.abs().max())
        kp, ke = forward_walk(p, leaves, walk, walk="classic")
        sp, se = new_b5()
        op, oe = old_b5()
        torch.cuda.synchronize()
        chk = {
            "b3_vs_plain": float((dp - wp).abs().max()) / scale,
            "b3_vs_earlier": float((dp - dpo).abs().max()) / scale,
            "b3_repeat_equal": bool(torch.equal(dp, dp2)),
            "b3_root_row_zero": float(dp.select(-4, walk.root).abs().max())
            == 0.0,
            "b5_equals_earlier": bool(torch.equal(sp, op)
                                      and torch.equal(se, oe)),
            "b5_equals_forward": bool(torch.equal(sp, kp)
                                      and torch.equal(se, ke)),
        }
        result["checks"][label] = chk
        ok = (chk["b3_vs_plain"] <= TOL and chk["b3_vs_earlier"] <= TOL
              and chk["b3_repeat_equal"] and chk["b3_root_row_zero"]
              and chk["b5_equals_earlier"] and chk["b5_equals_forward"])
        if not ok:
            print(json.dumps(result), flush=True)
            sys.exit(f"kernel_turns: {label} failed its checks: {chk}")
        if label.startswith("wide_root"):
            continue
        reps = {"flagship_B1": 200, "flagship_B64": 50}.get(label, 5)
        for name, new_fn, old_fn, kind in (("B3", new_b3, old_b3, "reverse"),
                                           ("B5", new_b5, old_b5, "stream")):
            t = [_cuda_ms(old_fn, reps), _cuda_ms(new_fn, reps),
                 _cuda_ms(new_fn, reps), _cuda_ms(old_fn, reps)]
            bound_ms, bound_by = _bound(kind, walk, p, leaves)
            new_ms, old_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            result["turns"][f"{name}_{label}"] = {
                "earlier_ms": old_ms, "ms": new_ms, "runs": t,
                "speedup": old_ms / new_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "bound_share": bound_ms / new_ms,
                "earlier_bound_share": bound_ms / old_ms}
            result["device_us"][f"{name}_{label}"] = {
                "earlier": _device_us(old_fn, min(reps, 20)),
                "current": _device_us(new_fn, min(reps, 20))}
        # B3's block width: each tile alone, against the one the rule picks
        sweep, saved = {}, cuda_pruning._REVERSE_TILES
        try:
            for tile in saved:
                cuda_pruning._REVERSE_TILES = (tile,)
                dev_us = _device_us(new_b3, min(reps, 20))
                sweep[tile] = {"ms": _cuda_ms(new_b3, reps), "device_us": (
                    sum(dev_us.values()) if isinstance(dev_us, dict)
                    else dev_us)}
        finally:
            cuda_pruning._REVERSE_TILES = saved
        result["b3_tiles"][label] = {
            "chosen": cuda_pruning.reverse_tile(leaves.shape[2],
                                                walk.children.shape[1]),
            "each": sweep}
        del rx, re, dp, dp2, dpo, wp
        torch.cuda.empty_cache()
    result["sass_stream_S20"] = {
        "earlier": _sass_counts(old_path, r"pruning_slot_kernelILi20ELb1E"),
        "current": _sass_counts(cur_path, r"pruning_stream_kernelILi20E")}
    result["ptxas_earlier"] = _ptxas_table(old_log)
    log = _build.build_info()["log"]
    result["ptxas_current"] = _ptxas_table(log) if log else "library reused"
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
