#!/usr/bin/env python3
"""Forces and times each branch of the scatter kernels K3 (MSDA dValue) and
K6 (point-sampler dValue) on one GPU.

    python3 tools/torch_bench_scatter_variants.py [--rounds 3] [--iters 100]

Both kernels bin their adds by the pixel of a band of output rows in shared
memory, and sum each pixel once, where the band fits their plan's room, and
add straight into the output elsewhere. For each
case this tool forces each branch through the plan (``auto``: the plan as
the wrappers make it; ``global``: no band room, every add goes straight to
the output; ``band_16k``: 16 KB of bins, 2047 pixels; ``band_max``: all the
shared memory a block may have), holds the
result against the plain version with ``chip_smoke.py``'s tolerances, and
times the wrapper with CUDA events (mean of ``--iters`` calls; the rounds
alternate the branches) and the kernel alone with ``torch.profiler``.
Inputs: K6 at the criterion's loss shapes on y-sorted points (as the
criterion draws them) and on the same points shuffled; K3 at the train
encoder's shape on random locations, on the first encoder layer's inputs
recorded from one full-width train step (bf16 AMP), and on those inputs with
the queries shuffled.

Run it from the root of a checkout: it imports the port and ``chip_smoke``
from the working directory, so two checkouts can be compared in one call. A
checkout whose wrappers have no ``dvalue_plan`` (before the shared-memory
bands) is timed as it is, under the branch name ``as_built``. Prints the
card, then one JSON line per (kernel, case, inputs, dtype, branch) with the
median, minimum and maximum of the rounds' times, the device time and the
share of corner adds that the branch sends through shared memory.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from openvis_tpu_torch import train  # noqa: E402
from openvis_tpu_torch.convert import init_params  # noqa: E402
from openvis_tpu_torch.ops import msda_cuda, point_sample_cuda  # noqa: E402
from openvis_tpu_torch.ops.msda import ms_deform_attn_bwd_plain  # noqa: E402
from openvis_tpu_torch.ops.point_sample import (  # noqa: E402
    sample_maps_dvalue_plain,
    sorted_uniform_points,
)

K6_CASES = ("loss_candidates", "loss_random")


def device_ms(fn, kernel: str, iters: int) -> float:
    """Mean device time of one launch of the kernel named ``kernel`` (a copy
    of ``chip_smoke.device_ms``: older checkouts' ``chip_smoke`` has none)."""
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


def branches(module):
    """branch name -> the plan's forced arguments (empty: the plan's own),
    or the checkout's one design."""
    if not hasattr(module, "dvalue_plan"):
        return {"as_built": {}}
    return {"auto": {}, "global": {"band_bytes": 0}, "band_16k": {"band_bytes": 16 * 1024},
            "band_max": {"band_bytes": 1 << 30}}


def forcing(module, forced):
    """Context in which ``module``'s wrapper plans with ``forced``."""
    class _Force:
        def __enter__(self):
            self.real = getattr(module, "dvalue_plan", None)
            if self.real is not None and forced:
                module.dvalue_plan = functools.partial(self.real, **forced)

        def __exit__(self, *exc):
            if self.real is not None:
                module.dvalue_plan = self.real
    return _Force()


def recorded_train_inputs():
    """K2's (and so K3's) inputs of the first encoder layer in one full-width
    bf16 AMP train step from ``chip_smoke.py``'s weights and batch, on the
    host."""
    cfg = cs._full_config()
    model = init_params(train.build_model(cfg), seed=cs.SEED)
    step = train.build_train_step(cfg, model, cs.K_CLASSES)
    batch = cs._train_batch(np.random.RandomState(cs.SEED), cs.TRAIN_H, cs.TRAIN_W,
                            cs.TRAIN_N, cs.DEVICE)
    rec = cs.MsdaRecorder()
    with rec:
        step(batch, torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED))
    torch.cuda.synchronize()
    del model, step, batch
    torch.cuda.empty_cache()
    return rec.dcoord[0]


def run(kernel, case, inputs, dtype, module, call, check, plan_share, name, args):
    times = {b: [] for b in branches(module)}
    dev, share, ok = {}, {}, {}
    for r in range(args.rounds):
        for branch, band in branches(module).items():
            with forcing(module, band):
                if r == 0:
                    ok[branch] = check(call())
                    dev[branch] = device_ms(call, name, args.iters)
                    share[branch] = plan_share()
                    if not ok[branch]:
                        raise AssertionError(f"{kernel} {case} {inputs} {dtype} {branch}: "
                                             "disagrees with the plain version")
                times[branch].append(cs.time_cuda(call, iters=args.iters))
    for branch, ts in times.items():
        print(json.dumps({"kernel": kernel, "case": case, "inputs": inputs,
                          "dtype": str(dtype).replace("torch.", ""), "branch": branch,
                          "within_tol": ok[branch], "band_share": share[branch],
                          "ms_median": statistics.median(ts), "ms_min": min(ts),
                          "ms_max": max(ts), "device_ms": dev[branch], "rounds": len(ts),
                          "iters": args.iters}), flush=True)


def bench_k6(args, gen):
    for case in K6_CASES:
        b, r, h, w, p = cs.SAMPLER_CASES[case]
        for dtype in (torch.bfloat16, torch.float32):
            for order in ("sorted", "unsorted"):
                pts = sorted_uniform_points(gen, (b,), p)
                if order == "unsorted":
                    pts = pts[:, torch.randperm(p, device=cs.DEVICE, generator=gen)].contiguous()
                shape = (b, r, h, w)
                g = torch.randn(b, r, p, device=cs.DEVICE, generator=gen)
                ref = sample_maps_dvalue_plain(torch.zeros(shape, dtype=dtype, device=cs.DEVICE),
                                               pts, g)
                call = lambda: point_sample_cuda.point_sample_dvalue_cuda(pts, g, shape, dtype)
                check = lambda got: cs._check_close(got, ref, cs.BWD_REL_TO_MAX,
                                                    cs.BWD_RTOL[dtype])[0]

                def share():
                    if not hasattr(point_sample_cuda, "dvalue_plan"):
                        return None
                    return point_sample_cuda.band_share(
                        pts, shape, point_sample_cuda.dvalue_plan(shape, p))

                run("K6", case, order, dtype, point_sample_cuda, call, check, share,
                    "point_sample_dvalue_kernel", args)


def bench_k3(args, gen, recorded):
    b, levels = cs.MSDA_BWD_CASES["train_encoder"]
    sets = []
    for dtype in (torch.bfloat16, torch.float32):
        value, loc, attn = cs._msda_inputs(b, levels, dtype, gen)
        g = torch.randn(b, loc.shape[1], cs.MSDA_HEADS * cs.MSDA_CH, device=cs.DEVICE,
                        generator=gen).to(dtype)
        sets.append(("random", levels, value, loc, attn, g))
    if recorded is not None:
        value, levels_r, loc, attn, g = (t.to(cs.DEVICE) if torch.is_tensor(t) else t
                                         for t in recorded)
        sets.append(("recorded", levels_r, value, loc, attn, g))
        perm = torch.randperm(loc.shape[1], device=cs.DEVICE, generator=gen)
        sets.append(("recorded_queries_shuffled", levels_r, value, loc[:, perm].contiguous(),
                     attn[:, perm].contiguous(), g[:, perm].contiguous()))
    for inputs, lv, value, loc, attn, g in sets:
        ref = ms_deform_attn_bwd_plain(value, lv, loc, attn, g, dcoords=False)[0]
        call = lambda: msda_cuda.msda_dvalue_cuda(value, lv, loc, attn, g)
        check = lambda got: cs._check_close(got, ref, cs.BWD_REL_TO_MAX,
                                            cs.BWD_RTOL[value.dtype])[0]

        def share():
            if not hasattr(msda_cuda, "dvalue_plan"):
                return None
            return msda_cuda.band_share(lv, loc, msda_cuda.dvalue_plan(value, loc))

        run("K3", "train_encoder", inputs, value.dtype, msda_cuda, call, check, share,
            "msda_dvalue_kernel", args)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--no-recorded", action="store_true",
                    help="skip the train step that records K3's inputs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    print(cs.card_line(), flush=True)
    cs.phase_build()
    recorded = None if args.no_recorded else recorded_train_inputs()
    gen = torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED + 7)
    bench_k6(args, gen)
    bench_k3(args, gen, recorded)
    return 0


if __name__ == "__main__":
    sys.exit(main())
