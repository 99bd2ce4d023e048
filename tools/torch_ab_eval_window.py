#!/usr/bin/env python3
"""Eval-window time of two checkouts of the port, alternated on one GPU.

    python3 tools/torch_ab_eval_window.py PARENT_DIR CHANGE_DIR [--rounds 2]

Each round runs PARENT, CHANGE, CHANGE, PARENT, each in a fresh process that
imports the port from its own directory, builds its kernels, warms up, and
times 6 repetitions of ``chip_smoke.py``'s three full-width 10x384x640 bf16
eval windows with CUDA events.  Prints one JSON line per process and, last,
each side's median, quartiles and minimum ms/window over all repetitions, and
how many of the round's two (parent, change) process pairs the change won on
its process median.  The host shares its cores, so whole processes can read
10-40 % slow: compare quartiles and pairs, never single readings.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPS = 6


def time_tree() -> dict:
    """Run inside the checkout (the working directory)."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke
    from openvis_tpu_torch import train
    from openvis_tpu_torch.convert import init_params

    chip_smoke.phase_build()
    cfg = chip_smoke._full_config()
    model = init_params(train.build_model(cfg), seed=chip_smoke.SEED)
    model = model.to(device="cuda", dtype=torch.bfloat16).eval()
    eval_fn = train.make_eval_fn(cfg, model)
    rng = np.random.RandomState(chip_smoke.SEED)
    windows = [torch.from_numpy(rng.randn(10, 384, 640, 3).astype(np.float32))
               .to("cuda", torch.bfloat16) for _ in range(3)]
    text = torch.from_numpy(chip_smoke._text(rng)).to("cuda", torch.bfloat16)
    eval_fn(windows[0], text)
    torch.cuda.synchronize()
    reps = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for w in windows:
            eval_fn(w, text)
        end.record()
        torch.cuda.synchronize()
        reps.append(start.elapsed_time(end) / len(windows))
    return {"ms_per_window": reps}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--one", action="store_true", help="time the working directory only")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(time_tree()), flush=True)
        return 0
    parent, change = (os.path.abspath(t) for t in args.trees)
    here = os.path.abspath(__file__)
    results = {"parent": [], "change": []}
    wins = pairs = 0
    for _ in range(args.rounds):
        medians = {}
        for order, side in enumerate(("parent", "change", "change", "parent")):
            tree = parent if side == "parent" else change
            out = subprocess.run([sys.executable, here, "--one"], cwd=tree, check=True,
                                 capture_output=True, text=True).stdout
            reps = json.loads(out.strip().splitlines()[-1])["ms_per_window"]
            results[side] += reps
            medians[(side, order < 2)] = statistics.median(reps)
            print(json.dumps({"side": side, "ms_per_window": reps}), flush=True)
        for first in (True, False):  # pairs (P, C) and (C, P) of the round
            pairs += 1
            wins += medians[("change", first)] < medians[("parent", first)]
    summary = {}
    for side, v in results.items():
        q1, _, q3 = statistics.quantiles(v, n=4)
        summary[side] = {"median_ms_per_window": statistics.median(v), "q1": q1, "q3": q3,
                         "min": min(v), "n": len(v)}
    summary["pairs"], summary["change_wins"] = pairs, wins
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
