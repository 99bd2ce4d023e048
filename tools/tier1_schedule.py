#!/usr/bin/env python
"""Simulate the tier-1 run's scheduling from a junit report.

    python tools/tier1_schedule.py run.xml [--workers 6] [--top 12]

The tier-1 command (ROADMAP.md) runs ``pytest -n 6 --dist loadfile``:
pytest-xdist queues the test files largest first by test count (a stable
sort, so files of one count stay in collection order), gives each worker one
file, then one more to any worker left with at most 2 pending tests, and
after every finished test gives the next file to a worker whose pending
tests have dropped to 2 or fewer (``xdist/scheduler/loadscope.py``).  This
replays that queue with each test's junit time (setup, call and teardown)
and prints one JSON object: the simulated wall, each worker's end, and the
start and end of the files that end last, with their test counts.  Pass
``--move FILE=N`` to see a file as N tests (the queue position a split
would give its parts is that of the smaller count).  ``--draws N`` replays
the queue N more times with each test's time scaled by a uniform factor in
1 ± ``JITTER`` (drawn from ``SEED``) and adds the walls' median and 90th percentile, and,
for each ``--same-worker A,B``, the share of draws in which files A and B
ran on one worker."""

from __future__ import annotations

import argparse
import collections
import json
import random
import statistics
import xml.etree.ElementTree as ET

JITTER = 0.15   # each test's time varies by up to this share between runs
SEED = 0


def file_times(path: str):
    """{test file: [test seconds in run order]} from a junit report."""
    files = collections.OrderedDict()
    for case in ET.parse(path).getroot().iter("testcase"):
        mod = case.get("classname", "")
        parts = mod.split(".")
        # tests.test_x or tests.test_x.TestClass -> tests/test_x.py
        depth = next((i for i, p in enumerate(parts) if p.startswith("test_")), len(parts) - 1)
        name = "/".join(parts[:depth + 1]) + ".py"
        files.setdefault(name, []).append(float(case.get("time", 0.0)))
    return files


def simulate(files, workers: int = 6, counts=None):
    """(wall, per-worker end times, {file: (start, end, worker)})."""
    counts = counts or {}
    queue = sorted(sorted(files), key=lambda f: -counts.get(f, len(files[f])))
    pending = [collections.deque() for _ in range(workers)]   # (file, seconds) per test
    clock = [0.0] * workers
    spans = {}

    def assign(w):
        f = queue.pop(0)
        for s in files[f]:
            pending[w].append((f, s))

    for w in range(workers):
        if queue:
            assign(w)
    for w in range(workers):
        if queue and len(pending[w]) <= 2:
            assign(w)
    while any(pending):
        w = min((i for i in range(workers) if pending[i]), key=lambda i: clock[i])
        f, s = pending[w].popleft()
        start, _, _ = spans.get(f, (clock[w], None, w))
        clock[w] += s
        spans[f] = (start, clock[w], w)
        if queue and len(pending[w]) <= 2:
            assign(w)
    return max(clock), clock, spans


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("junit")
    p.add_argument("--workers", type=int, default=6)
    p.add_argument("--top", type=int, default=12)
    p.add_argument("--move", action="append", default=[], help="FILE=N: count FILE as N tests")
    p.add_argument("--draws", type=int, default=0)
    p.add_argument("--same-worker", action="append", default=[], help="A,B: two test files")
    args = p.parse_args(argv)
    files = file_times(args.junit)
    counts = {k: int(v) for k, v in (m.split("=") for m in args.move)}
    wall, ends, spans = simulate(files, args.workers, counts)
    last = sorted(spans.items(), key=lambda kv: -kv[1][1])[:args.top]
    out = {
        "simulated_wall_s": wall, "worker_end_s": ends, "tests": sum(map(len, files.values())),
        "files": len(files), "test_seconds": sum(map(sum, files.values())),
        "last_files": [{"file": f, "tests": len(files[f]), "start_s": a, "end_s": b,
                        "seconds": sum(files[f]), "worker": w} for f, (a, b, w) in last],
    }
    if args.draws:
        rng = random.Random(SEED)
        pairs = [tuple(p.split(",")) for p in args.same_worker]
        walls, together = [], collections.Counter()
        for _ in range(args.draws):
            jittered = {f: [t * rng.uniform(1 - JITTER, 1 + JITTER) for t in ts]
                        for f, ts in files.items()}
            w, _, sp = simulate(jittered, args.workers, counts)
            walls.append(w)
            together.update(pair for pair in pairs if sp[pair[0]][2] == sp[pair[1]][2])
        walls.sort()
        out["draws"] = {"n": args.draws, "jitter": JITTER, "seed": SEED,
                        "median_wall_s": statistics.median(walls),
                        "p90_wall_s": walls[int(0.9 * (len(walls) - 1))],
                        "same_worker_share": {",".join(pr): together[pr] / args.draws
                                              for pr in pairs}}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
