"""Port parity, site sharding across processes: mirrors
``tests/test_multihost.py`` with two gloo processes on the CPU
(``python -m phylo_utils_tpu_torch.parallel.multihost``), four shards
each, one global 8-shard pattern axis.

The global logL equals the single-process engine's to 1e-9 (JAX's bound),
the same on both ranks, the sitewise values to 1e-10 of their largest,
and each rank's gradient equals the single-process gradient to 1e-12 of
its largest entry; ``from_process_local`` of a rank's slice gives the
sharded engine's own data. A two-process fit,
hard-killed at step 7, resumes from rank 0's step-6 checkpoint and ends bit
for bit where the uninterrupted 12-step run ends, on both ranks. Each
worker runs on one intra-op thread.
"""
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from torch_threads import one_thread  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_ports(n):
    """``n`` distinct free ports, all bound at once while they are read."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO
    env["OMP_NUM_THREADS"] = "1"
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    return env


def _start_pair(args, port):
    return [
        subprocess.Popen(
            [sys.executable, "-m", "phylo_utils_tpu_torch.parallel.multihost",
             args[0], str(rank), "2", str(port), *args[1:], "--device",
             "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=_env(),
            cwd=_REPO, text=True)
        for rank in range(2)
    ]


def _finish_pair(procs):
    results = []
    for p in procs:
        out, err = p.communicate(timeout=280)
        results.append((p.returncode, out, err))
    return results


def _spawn_pair(args):
    return _finish_pair(_start_pair(args, _free_ports(1)[0]))


def _rows(results):
    rows = []
    for rc, out, err in results:
        assert rc == 0, f"worker failed:\n{err[-2000:]}"
        rows.append(json.loads(out.strip().splitlines()[-1]))
    return rows


def test_two_process_global_loglik():
    rows = _rows(_spawn_pair(["loglik"]))
    assert [r["rank"] for r in rows] == [0, 1]
    assert all(r["global_shards"] == 8 and r["backend"] == "gloo"
               for r in rows)
    for r in rows:
        assert abs(r["sharded_loglik"] - r["local_loglik"]) < 1e-9, r
        assert r["sitewise_patterns"] == 200   # 200 patterns, no padding
        assert r["sitewise_max_rel"] <= 1e-10, r
        assert r["grad_max_rel"] <= 1e-12, r
        # this rank's slice through from_process_local is the engine's data
        assert r["ingest_equal"], r
    # both ranks observe the same globally reduced logL
    assert rows[0]["sharded_loglik"] == rows[1]["sharded_loglik"]


def test_two_process_fit_killed_and_resumed_bitexact(tmp_path):
    clean_ckpt, ckpt = (str(tmp_path / n) for n in ("clean.ckpt",
                                                     "fit.ckpt"))
    # the uninterrupted run and the run killed at step 7, side by side
    clean_port, crash_port = _free_ports(2)
    clean_pair = _start_pair(["fit", "clean", clean_ckpt], clean_port)
    crashed = _finish_pair(_start_pair(["fit", "crash", ckpt], crash_port))
    clean = _rows(_finish_pair(clean_pair))
    assert clean[0]["digest"] == clean[1]["digest"]
    assert not os.path.exists(clean_ckpt)

    # killed at step 7: rank 0's step-6 checkpoint survives
    for rc, _, err in crashed:
        assert rc == 137, f"crash worker exited {rc}:\n{err[-2000:]}"
    assert os.path.exists(ckpt), "no checkpoint survived the kill"
    assert torch.load(ckpt, weights_only=True)["step"] == 6

    resumed = _rows(_spawn_pair(["fit", "resume", ckpt]))
    assert resumed[0]["digest"] == resumed[1]["digest"]
    assert resumed[0]["digest"] == clean[0]["digest"], (
        "the resumed trajectory left the uninterrupted run's")
    assert resumed[0]["loglik"] == clean[0]["loglik"]


@pytest.mark.parametrize("rank", [0, 1])
def test_checkpoint_written_by_rank_zero_only(tmp_path, rank, monkeypatch):
    """``save_checkpoint`` writes on rank 0 and returns at once elsewhere."""
    from phylo_utils_tpu_torch.utils.checkpoint import save_checkpoint

    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: rank)
    path = tmp_path / "c.pt"
    save_checkpoint(str(path), {"x": torch.ones(2)}, step=3)
    assert path.exists() == (rank == 0)
