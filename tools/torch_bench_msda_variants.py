#!/usr/bin/env python3
"""Times each instantiation of the MSDA kernels K1 (forward) and K2 (dCoord)
on one GPU, at ``chip_smoke.py``'s train, eval and one-level MSDA shapes.

    python3 tools/torch_bench_msda_variants.py [--rounds 5] [--iters 200]

Run it from the root of a checkout: it imports the port and ``chip_smoke``
from the working directory, so two checkouts can be compared in one call.
For each case and dtype it forces every instantiation that can take the
shape through ``msda_cuda.launch_plan``, holds the result against the plain
version with ``chip_smoke.py``'s tolerances, and times it with CUDA events
(mean of ``--iters`` calls); the rounds alternate the instantiations.
Prints the card, then one JSON line per (kernel, case, dtype, instantiation)
with the median, minimum and maximum of the rounds' times, and which
instantiation ``launch_plan`` picks for the case by itself.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from openvis_tpu_torch.ops import msda_cuda  # noqa: E402
from openvis_tpu_torch.ops.msda import ms_deform_attn_bwd_plain, ms_deform_attn_plain  # noqa: E402

CASES = ("train_encoder", "eval_main_path", "one_level_v1")
# instantiation -> (its code, 16-byte loads)
VARIANTS = {"main": (msda_cuda.MAIN, True), "generic": (msda_cuda.GENERIC, False)}


def forced(code, wide):
    """A ``launch_plan`` that always picks instantiation ``code``."""
    def plan(value, loc, attn, grad=None):
        b, _, nh, ch = value.shape
        vec = 16 // value.element_size() if wide else 1
        lanes = 1
        while lanes < min(-(-ch // vec), 32):
            lanes *= 2
        groups = b * loc.shape[1] * nh
        return msda_cuda.LaunchPlan(code, vec, lanes, -(-groups * lanes // msda_cuda.THREADS))
    return plan


def check(case, dtype, value, levels, loc, attn, g, ref, ref_loc, ref_attn):
    got = msda_cuda.ms_deform_attn_cuda(value, levels, loc, attn)
    dloc, dattn = msda_cuda.msda_dcoord_cuda(value, levels, loc, attn, g)
    torch.cuda.synchronize()
    atol, rtol = cs.MSDA_TOL[dtype]
    ok = {"k1": bool(((got.float() - ref.float()).abs() <= atol + rtol * ref.float().abs()).all()),
          "k2_dloc": cs._check_close(dloc, ref_loc, cs.BWD_REL_TO_MAX, cs.BWD_RTOL[torch.float32])[0],
          "k2_dattn": cs._check_close(dattn, ref_attn, cs.BWD_REL_TO_MAX, cs.BWD_RTOL[dtype])[0]}
    if not all(ok.values()):
        raise AssertionError(f"{case} {dtype}: disagrees with the plain version: {ok}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    print(cs.card_line(), flush=True)
    cs.phase_build()
    gen = torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED)
    real = msda_cuda.launch_plan
    for case in CASES:
        batch, levels = cs.MSDA_CASES[case]
        for dtype in (torch.bfloat16, torch.float32):
            value, loc, attn = cs._msda_inputs(batch, levels, dtype, gen)
            g = torch.randn(batch, loc.shape[1], cs.MSDA_HEADS * cs.MSDA_CH,
                            device=cs.DEVICE, generator=gen).to(dtype)
            ref = ms_deform_attn_plain(value, levels, loc, attn)
            _, ref_loc, ref_attn = ms_deform_attn_bwd_plain(value, levels, loc, attn, g,
                                                            dvalue=False)
            natural = cs._plan(value, loc, attn)["variant"]
            names = [n for n in VARIANTS if n != "main" or len(levels) == 3]
            times = {(k, n): [] for k in ("k1", "k2") for n in names}
            for r in range(args.rounds):
                for n in names:
                    msda_cuda.launch_plan = forced(*VARIANTS[n])
                    try:
                        if r == 0:
                            check(case, dtype, value, levels, loc, attn, g, ref, ref_loc, ref_attn)
                        times[("k1", n)].append(cs.time_cuda(
                            lambda: msda_cuda.ms_deform_attn_cuda(value, levels, loc, attn),
                            iters=args.iters))
                        times[("k2", n)].append(cs.time_cuda(
                            lambda: msda_cuda.msda_dcoord_cuda(value, levels, loc, attn, g),
                            iters=args.iters))
                    finally:
                        msda_cuda.launch_plan = real
            for (kernel, n), ts in times.items():
                print(json.dumps({"kernel": kernel, "case": case, "batch": batch,
                                  "levels": levels, "dtype": str(dtype).replace("torch.", ""),
                                  "instantiation": n, "picked_by_launch_plan": n == natural,
                                  "ms_median": statistics.median(ts), "ms_min": min(ts),
                                  "ms_max": max(ts), "rounds": len(ts), "iters": args.iters}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
