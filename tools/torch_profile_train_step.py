#!/usr/bin/env python3
"""Where the time of the port's train step goes, on one GPU.

    python3 tools/torch_profile_train_step.py [--steps 3]

Runs ``chip_smoke.py``'s full-width train step (SimpleBaselineOnline-R50,
1x2x480x864, N=40, bf16 AMP, random weights from seed 0) and prints one JSON
line with:

  * ``spans``: per step, the device time (CUDA events) and host time of the
    model forward, the criterion, the backward (gradients and their norm) and
    the AdamW update, from wrappers put around those calls from outside the
    package;
  * ``profile``: one step under ``torch.profiler``: device time by kernel
    (top 15) and by category, the device's busy share of the step's wall time
    (union of kernel intervals), and the number of kernel launches.

Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from openvis_tpu_torch import train  # noqa: E402
from openvis_tpu_torch.convert import init_params  # noqa: E402
from openvis_tpu_torch.parallel import train_step  # noqa: E402

SPANS = ("forward", "criterion", "backward", "optimizer")
CATEGORIES = (  # first match wins, on the lower-cased kernel name
    ("port kernels", ("msda_", "point_sample_", "hungarian")),
    ("gemm", ("gemm", "cutlass", "xmma", "cublas", "matmul")),
    ("convolution", ("conv", "cudnn", "winograd", "implicit", "wgrad", "dgrad")),
    ("sort / top-k", ("sort", "topk", "radix", "select")),
    ("reduction", ("reduce", "norm", "softmax")),
    ("index / scatter", ("index", "scatter", "gather")),
    ("elementwise / copy", ("elementwise", "copy", "fill", "cat", "vectorized")),
)


class Spans:
    """CUDA-event and host-clock spans around named calls."""

    def __init__(self):
        self.marks = []

    def wrap(self, name, fn):
        def wrapped(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.marks.append((name, start, end, time.perf_counter() - t0))
            return out
        return wrapped

    def totals(self):
        torch.cuda.synchronize()
        dev = {n: 0.0 for n in SPANS}
        host = {n: 0.0 for n in SPANS}
        for name, start, end, host_s in self.marks:
            dev[name] += start.elapsed_time(end)
            host[name] += host_s * 1e3
        return dev, host


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def busy_ms(events) -> float:
    """Union of the kernels' device intervals, in ms."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3  # us -> ms


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = chip_smoke.card_line()
    cfg = chip_smoke._full_config()
    model = init_params(train.build_model(cfg), seed=chip_smoke.SEED)
    spans = Spans()
    # spans from outside the package: the forward, the criterion and the
    # update are module-level calls of train.py and train_step.py
    train.torch.func.functional_call = spans.wrap("forward", torch.func.functional_call)
    train.simple_baseline_loss = spans.wrap("criterion", train.simple_baseline_loss)
    train_step.AdamW.step = spans.wrap("optimizer", train_step.AdamW.step)
    train_step.torch.autograd.grad = spans.wrap("backward", torch.autograd.grad)
    step = train.build_train_step(cfg, model, chip_smoke.K_CLASSES)
    batch = chip_smoke._train_batch(np.random.RandomState(chip_smoke.SEED), chip_smoke.TRAIN_H,
                                    chip_smoke.TRAIN_W, chip_smoke.TRAIN_N, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    step(batch, gen)
    torch.cuda.synchronize()
    spans.marks.clear()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step(batch, gen)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    dev, host = spans.totals()

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch, gen)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name, by_cat = {}, {}
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        by_cat[category(e.name)] = by_cat.get(category(e.name), 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    busy = busy_ms(kernels)
    print(json.dumps({
        "card": card, "steps": args.steps, "wall_ms_per_step": wall_ms,
        "spans_device_ms_per_step": {k: v / args.steps for k, v in dev.items()},
        "spans_host_ms_per_step": {k: v / args.steps for k, v in host.items()},
        "profile": {"wall_ms": prof_wall_ms, "kernel_launches": len(kernels),
                    "device_busy_ms": busy, "device_busy_share": busy / prof_wall_ms,
                    "device_ms_by_category": by_cat,
                    "top_kernels_ms": [[n[:120], ms] for n, ms in top]},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
