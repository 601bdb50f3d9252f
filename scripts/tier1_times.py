"""Wall time and per-file times of the tier-1 run, on this host's CPU.

  python scripts/tier1_times.py run [--timeout 1470] [--repo DIR] OUT
  python scripts/tier1_times.py summary OUT [OUT ...]
  python scripts/tier1_times.py threads [--repo DIR] [--busy 4] FILE ...

``run`` runs ROADMAP.md's "Tier-1 verify" command in the checkout DIR (by
default this one): ``python -m pytest tests/`` with ``-m 'not slow'``, six
xdist workers, ``--dist loadfile`` and ``JAX_PLATFORMS=cpu``, under
``timeout -k 10 TIMEOUT``, adding only ``--durations=0`` and a junit XML in
OUT (which changes no test). Raise ``--timeout`` to time a tree that the
1470 s limit would cut: pytest writes neither report when it is killed.
It samples ``/proc/loadavg`` every 30 s into OUT/load.txt, writes the exit
code and wall seconds to OUT/result.json, and prints ``summary OUT``.

``summary`` reads OUT/t1.xml (and the two other files where present) and
prints, for each OUT: the exit code, wall seconds and counts; the load
average's median and maximum; the summed test time (setup, call and
teardown), a sixth of it, and its split between the port's files
(``test_torch_*``) and the rest; the largest files; and the makespan of
``--dist loadfile`` replayed from the per-test times: files dispatched
largest test count first (xdist's ``--loadscope-reorder``), a worker
taking the next file once two or fewer of its tests are pending.
Given several OUTs, the file table puts their times side by side.

``threads`` runs each test FILE of the checkout DIR as its own pytest
process, side by side, beside BUSY processes that spin on the CPU (the
other workers' stand-in), and prints for each its wall seconds, its CPU
seconds and the CPU seconds of its busiest threads, by thread name, read
from ``/proc`` every 2 s.
"""
from __future__ import annotations

import argparse
import collections
import heapq
import json
import os
import shlex
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import xml.etree.ElementTree as ET
from pathlib import Path

WORKERS = 6
REPO = Path(__file__).resolve().parent.parent


def _pytest_args(out: Path):
    return ["python", "-m", "pytest", "tests/", "-q", "-m", "not slow",
            "--continue-on-collection-errors", "-p", "no:cacheprovider",
            "-p", "xdist", "-n", str(WORKERS), "--dist", "loadfile",
            f"--junitxml={out / 't1.xml'}", "-p", "no:randomly",
            "--durations=0"]


def run(repo: Path, out: Path, timeout: int) -> int:
    out.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "ALLOW_MULTIPLE_LIBTPU_LOAD": "1"}
    cmd = ["timeout", "-k", "10", str(timeout)] + _pytest_args(out)
    done = threading.Event()

    def sample():
        with open(out / "load.txt", "w") as fh:
            while not done.wait(30.0 if fh.tell() else 0.0):
                with open("/proc/loadavg") as la:
                    fh.write(f"{time.time():.0f} {la.read()}")
                fh.flush()

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.perf_counter()
    with open(out / "t1.log", "w") as log:
        rc = subprocess.call(cmd, cwd=repo, env=env, stdout=log,
                             stderr=subprocess.STDOUT)
    wall = time.perf_counter() - t0
    done.set()
    sampler.join()
    (out / "result.json").write_text(json.dumps({
        "rc": rc, "wall_s": wall, "repo": str(repo), "timeout": timeout,
        "command": shlex.join(cmd)}) + "\n")
    summary([out])
    return rc


def _tests(xml: Path):
    """{file stem: [seconds of each test, in report order]} and counts."""
    files = collections.OrderedDict()
    counts = collections.Counter()
    for tc in ET.parse(xml).getroot().iter("testcase"):
        stem = (tc.get("classname") or "").split(".")[-1]
        files.setdefault(stem, []).append(float(tc.get("time") or 0.0))
        kind = next((c.tag for c in tc if c.tag in ("skipped", "failure",
                                                     "error")), "passed")
        counts[kind] += 1
    return files, counts


def makespan(files, workers: int = WORKERS) -> float:
    """``--dist loadfile`` replayed: seconds until the last worker ends."""
    queue = collections.deque(sorted(sorted(files),
                                     key=lambda f: -len(files[f])))
    pending = [collections.deque() for _ in range(workers)]

    def take(w):
        pending[w].extend(files[queue.popleft()])

    for w in range(workers):
        take(w)
    for w in range(workers):
        if queue and len(pending[w]) <= 2:
            take(w)
    heap = [(0.0, w) for w in range(workers)]
    end = 0.0
    while heap:
        t, w = heapq.heappop(heap)
        if not pending[w]:
            end = max(end, t)
            continue
        t += pending[w].popleft()
        if queue and len(pending[w]) <= 2:
            take(w)
        heapq.heappush(heap, (t, w))
    return end


def summary(outs, top: int = 10) -> None:
    runs = []
    for out in outs:
        out = Path(out)
        files, counts = _tests(out / "t1.xml")
        res = (json.loads((out / "result.json").read_text())
               if (out / "result.json").exists() else {})
        loads = ([float(line.split()[1]) for line in
                  (out / "load.txt").read_text().splitlines()]
                 if (out / "load.txt").exists() else [])
        total = sum(map(sum, files.values()))
        port = sum(sum(v) for f, v in files.items()
                   if f.startswith("test_torch_"))
        print(f"{out}: rc {res.get('rc')} wall {res.get('wall_s', 0):.1f} s;"
              f" {counts['passed']} passed, {counts['skipped']} skipped, "
              f"{counts['failure'] + counts['error']} failed; load average "
              f"median {statistics.median(loads) if loads else 0:.2f} max "
              f"{max(loads, default=0):.2f} on {os.cpu_count()} cores")
        print(f"  summed test time {total:.1f} s (port {port:.1f}, rest "
              f"{total - port:.1f}); a sixth {total / WORKERS:.1f} s; "
              f"loadfile makespan {makespan(files):.1f} s; longest file "
              f"{max(files, key=lambda f: sum(files[f]))} "
              f"{max(map(sum, files.values())):.1f} s")
        runs.append(files)
    names = sorted(runs[0], key=lambda f: -sum(runs[0][f]))[:top]
    print("  largest files (s, tests): " + " | ".join(
        f"{f} " + " / ".join(f"{sum(r.get(f, [])):.1f}" for r in runs)
        + f" ({len(runs[0][f])})" for f in names))


def _watch(repo: Path, test_file: str, env, result: dict) -> None:
    log = tempfile.TemporaryFile("w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytest", test_file, "-q", "-p",
         "no:cacheprovider", "-p", "no:randomly"], cwd=repo, env=env,
        stdout=log, stderr=subprocess.STDOUT, text=True)
    tick = os.sysconf("SC_CLK_TCK")
    cpu, threads = 0.0, {}
    while proc.poll() is None:
        try:
            fields = Path(f"/proc/{proc.pid}/stat").read_text().rsplit(
                ")", 1)[1].split()
            cpu = (int(fields[11]) + int(fields[12])) / tick
            for task in Path(f"/proc/{proc.pid}/task").iterdir():
                f = (task / "stat").read_text().rsplit(")", 1)[1].split()
                threads[task.name] = ((task / "comm").read_text().strip(),
                                      (int(f[11]) + int(f[12])) / tick)
        except (FileNotFoundError, ProcessLookupError):
            pass
        time.sleep(2.0)
    with log:
        log.seek(0)
        out = log.read()
    result.update(file=test_file, rc=proc.returncode,
                  wall_s=time.perf_counter() - t0, cpu_s=cpu,
                  threads=len(threads),
                  busiest=sorted(threads.values(), key=lambda t: -t[1])[:9],
                  last_line=out.strip().splitlines()[-1] if out else "")


def threads(repo: Path, files, busy: int) -> int:
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    spinners = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
                for _ in range(busy)]
    results = [{} for _ in files]
    try:
        watchers = [threading.Thread(target=_watch, args=(repo, f, env, r))
                    for f, r in zip(files, results)]
        for w in watchers:
            w.start()
        for w in watchers:
            w.join()
    finally:
        for sp in spinners:
            sp.kill()
            sp.wait()
    for r in results:
        print(f"{r['file']} ({repo}): rc {r['rc']} wall {r['wall_s']:.1f} s,"
              f" CPU {r['cpu_s']:.1f} s, {r['threads']} threads; busiest: "
              + " ".join(f"{name} {sec:.1f}" for name, sec in r["busiest"])
              + f"; {r['last_line']}")
    return max(r["rc"] for r in results)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python scripts/tier1_times.py")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--timeout", type=int, default=1470)
    r.add_argument("--repo", default=str(REPO))
    r.add_argument("out")
    s = sub.add_parser("summary")
    s.add_argument("outs", nargs="+")
    s.add_argument("--top", type=int, default=10)
    t = sub.add_parser("threads")
    t.add_argument("--repo", default=str(REPO))
    t.add_argument("--busy", type=int, default=4)
    t.add_argument("files", nargs="+")
    args = ap.parse_args(argv)
    if args.cmd == "run":
        return run(Path(args.repo).resolve(), Path(args.out).resolve(),
                   args.timeout)
    if args.cmd == "threads":
        return threads(Path(args.repo).resolve(), args.files, args.busy)
    summary(args.outs, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
