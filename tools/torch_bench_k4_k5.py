#!/usr/bin/env python3
"""Times K4 (batched Hungarian) and K5 (shared-point sampler forward) on one
GPU, through their wrappers and on the device alone.

    python3 tools/torch_bench_k4_k5.py [--rounds 3] [--iters 100] [--label NAME]

K4 runs ``chip_smoke.py``'s cases (tracking 9x100x100 on uniform, cosine
and integer-tie costs; the matcher's 20x40x100 on the warp solver and the
200-query matcher's 20x40x200 on the block solver), each held against
scipy's optimal cost and, element for element, against ``hungarian_plain``'s
assignment, with each problem's Dijkstra steps where the checkout's
``hungarian_plain`` counts them. K5 runs the train step's three call shapes
(``matcher``, ``loss_candidates``, ``loss_random``) on bf16 maps and y-sorted
points, as the AMP train step calls it, held against the plain sampler with
``chip_smoke.py``'s tolerances. Each round times every case once: the
wrapper with CUDA events (mean of ``--iters`` calls), the kernel alone with
``torch.profiler`` in the first round.

Run it from the root of a checkout: it imports the port and ``chip_smoke``
from the working directory, so two checkouts can be compared in one call
(``cd parent && python3 /path/to/tools/torch_bench_k4_k5.py --label parent``,
then the same from the change, in turns). Prints the card, then one JSON line
per case with the median, minimum and maximum of the rounds' wrapper times,
the device time, and the checks.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy.optimize import linear_sum_assignment  # noqa: E402

import chip_smoke as cs  # noqa: E402
from openvis_tpu_torch.ops import hungarian_cuda, point_sample_cuda  # noqa: E402
from openvis_tpu_torch.ops.hungarian import hungarian_plain  # noqa: E402
from openvis_tpu_torch.ops.point_sample import (  # noqa: E402
    sample_maps_shared_plain,
    sorted_uniform_points,
)

K5_CASES = ("matcher", "loss_candidates", "loss_random")


def device_ms(fn, kernel: str, iters: int) -> float:
    """Mean device time of one launch of the kernel whose name contains
    ``kernel`` (a copy of ``chip_smoke.device_ms``, which older checkouts
    lack)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    # the profiler may drop an event at the edge of its window
    return sum(us) / len(us) / 1e3 if iters // 2 <= len(us) <= iters else float("nan")


def k4_cases():
    """name -> (call, checks): chip_smoke.py's costs, in its order and seed."""
    rng = np.random.RandomState(cs.SEED)
    counts = "return_steps" in inspect.signature(hungarian_plain).parameters
    out = {}
    for name, (b, n, m) in cs.HUNGARIAN_CASES.items():
        cost = cs._hungarian_costs(name, b, n, m, rng)
        dev = torch.from_numpy(cost).to(cs.DEVICE)
        cols = hungarian_cuda.batched_hungarian_cuda(dev).cpu().numpy()
        gap, same, steps = 0.0, True, []
        for bi in range(b):
            c64 = cost[bi].astype(np.float64)
            r, c = linear_sum_assignment(c64)
            best = c64[r, c].sum()
            gap = max(gap, abs(c64[np.arange(n), cols[bi]].sum() - best) / max(abs(best), 1e-30))
            plain = hungarian_plain(torch.from_numpy(cost[bi]), **({"return_steps": True} if counts else {}))
            if counts:
                plain, s = plain
                steps.append(s)
            same &= bool(np.array_equal(plain.numpy(), cols[bi]))
        checks = {"shape": [b, n, m], "cost_rel_gap_vs_scipy": gap, "equal_to_plain": same,
                  "steps_max": max(steps) if steps else None}
        out[name] = (lambda d=dev: hungarian_cuda.batched_hungarian_cuda(d), checks)
    return out


def k5_cases(gen):
    out = {}
    for name in K5_CASES:
        b, r, h, w, p = cs.SAMPLER_CASES[name]
        maps = (torch.randn(b, r, h, w, device=cs.DEVICE, generator=gen) * 4).to(torch.bfloat16)
        coords = sorted_uniform_points(gen, (b,), p)
        got = point_sample_cuda.point_sample_fwd_cuda(maps, coords)
        ref = sample_maps_shared_plain(maps, coords, f32_policy=True)
        ok, err, _ = cs._check_close(got, ref, cs.SAMPLER_REL_TO_MAX, cs.SAMPLER_RTOL)
        checks = {"maps": [b, r, h, w], "points": p, "within_tol": ok, "max_abs_err": err}
        if hasattr(point_sample_cuda, "fwd_plan"):
            checks["plan"] = vars(point_sample_cuda.fwd_plan(maps.shape, p))
        out[name] = (lambda m=maps, c=coords: point_sample_cuda.point_sample_fwd_cuda(m, c), checks)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    cs.phase_build()
    cases = {("K4", k): v for k, v in k4_cases().items()}
    cases.update({("K5", k): v for k, v in k5_cases(torch.Generator(device=cs.DEVICE)
                                                    .manual_seed(cs.SEED + 5)).items()})
    names = {"K4": "hungarian", "K5": "point_sample_fwd_kernel"}
    times = {key: [] for key in cases}
    dev = {}
    for r in range(args.rounds):
        for key, (call, _) in cases.items():
            if r == 0:
                dev[key] = device_ms(call, names[key[0]], iters=20)
            times[key].append(cs.time_cuda(call, iters=args.iters))
    for key, (_, checks) in cases.items():
        ts = times[key]
        print(json.dumps({"label": args.label, "kernel": key[0], "case": key[1], **checks,
                          "ms_median": statistics.median(ts), "ms_min": min(ts),
                          "ms_max": max(ts), "device_ms": dev[key], "rounds": len(ts),
                          "iters": args.iters}), flush=True)
    bad = [k for k, (_, c) in cases.items()
           if not c.get("within_tol", True) or c.get("cost_rel_gap_vs_scipy", 0) > cs.HUNGARIAN_RTOL]
    print(json.dumps({"label": args.label, "seconds": time.perf_counter() - t0,
                      "all_checks_pass": not bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
