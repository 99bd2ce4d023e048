#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``openvis_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises (non-zero exit):

  0. device: refuses to run without CUDA; prints the card's name and power limit
  1. build: compiles the hand-written kernels from ``openvis_tpu_torch/csrc``,
     one ``nvcc`` per source, all at once; each kernel's registers, stack and
     spills from ptxas
  2. K1 (MSDA forward) against ``ms_deform_attn_plain`` on the card, at the
     eval, above-the-TPU-gate, train and one-level shapes, with the
     instantiation each takes
  3. K4 (batched Hungarian) against scipy and ``hungarian_plain``
  4. K2 / K3 (MSDA backward) against the plain backward at the train, eval
     and one-level encoder shapes, f32 and bf16, on random locations (K3's
     direct adds for the big levels; the two small ones fit its bins whole),
     with K3's plan and the share of its corner adds binned in shared memory
  5. K5 / K6 (shared-point sampler and its dValue) against the plain sampler
     and its autograd at the three train shapes, bf16 and f32 maps, on
     y-sorted points (K6's shared-memory bins where its tiles are dense), the
     same shuffled (its direct adds) and y-sorted points on pixel centres and
     the map's borders, with K6's plan and the share binned, and
     ``F.grid_sample`` and its backward timed as yardsticks
  6. the SimpleBaselineOnline-R50 eval path at full width (random weights from
     a seed, bf16): three 10x384x640 windows, with the kernels' launch counts
  7. the same eval path in f32 on the card (kernels) against the CPU (plain)
  8. the train step at full width: 1x2x480x864, N=40, bf16 AMP with f32
     masters, AdamW; one warm-up and three timed steps, with the launch counts
     of all six kernels, frozen parameters fixed and the encoder's
     sampling-offset weights moved
  8b. K1, K2 and K3 on the inputs the first encoder layer gave them in the
     warm-up window of phase 6 and the warm-up step of phase 8, against the
     plain versions, timed beside their bounds
  9. one f32 train-step loss and gradient on the card (kernels) against the
     CPU (plain) at 1x2x192x320, N=8, from the same weights and points

The line before the last lists every kernel with its launches on the train
path (phase 8; ``launches_by_path`` adds the eval path of phase 6), its error
against its plain version, its time (``ms``: the wrapper's call from CUDA
events; ``device_ms``: the kernel alone, from ``torch.profiler``), the plain
time, the yardstick library time where one PyTorch call computes the same
function, and its bound; the last line is ``{"ok": true, "device": {...}}``.
Imports no JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from openvis_tpu_torch import Config, train
from openvis_tpu_torch.convert import init_params
from openvis_tpu_torch.losses import criterion
from openvis_tpu_torch.models.backbone.resnet import FrozenAffine
from openvis_tpu_torch.models.pixel_decoder import MSDeformAttnModule
from openvis_tpu_torch.ops import cuda_build, hungarian_cuda, msda_cuda, point_sample_cuda
from openvis_tpu_torch.ops.hungarian import hungarian_plain
from openvis_tpu_torch.ops.msda import ms_deform_attn_bwd_plain, ms_deform_attn_plain
from openvis_tpu_torch.ops.point_sample import (
    KERNEL_MAX_HW,
    sample_maps_dvalue_plain,
    sample_maps_shared_plain,
    sorted_uniform_points,
)
from openvis_tpu_torch.parallel.train_step import config_labels, global_norm, stop_frozen_gradients
from openvis_tpu_torch.structures import ClipTargets

SEED = 0
DEVICE = "cuda"
SOURCES = ("msda_fwd", "msda_bwd", "hungarian", "point_sample")
# eval main-path shapes: 10 frames at 384x640 -> encoder levels at strides 32/16/8
WINDOW_FRAMES, FRAME_H, FRAME_W = 10, 384, 640
NUM_WINDOWS = 3
K_CLASSES, TEXT_DIM = 40, 512
MSDA_CASES = {  # name -> (batch, levels)
    "eval_main_path": (WINDOW_FRAMES, [(12, 20), (24, 40), (48, 80)]),
    # a 768x1344 input: above the TPU fused kernel's 12 MB VMEM gate
    "above_tpu_vmem_gate": (WINDOW_FRAMES, [(24, 42), (48, 84), (96, 168)]),
    # the train step's encoder: 2 frames at 480x864
    "train_encoder": (2, [(15, 27), (30, 54), (60, 108)]),
    # one level per launch, as the TPU's per-level v1 kernels sample: the
    # train encoder's largest level (the generic instantiation)
    "one_level_v1": (2, [(60, 108)]),
}
MSDA_HEADS, MSDA_CH, MSDA_POINTS = 8, 32, 4
HUNGARIAN_CASES = {  # name -> (batch, rows, cols)
    "tracking_uniform": (9, 100, 100),
    "tracking_cosine": (9, 100, 100),
    "integer_ties": (9, 100, 100),
    # the matcher: 10 decoder layers x 2 frames, one launch
    "matcher_uniform": (20, 40, 100),
}
CHECK_FRAMES = 2     # phase 7 window
TIMING_ITERS = 20
# train path (phase 8): bench.py's simplebsl_online_r50_train_step batch
TRAIN_T, TRAIN_H, TRAIN_W, TRAIN_N = 2, 480, 864, 40
TRAIN_STEPS = 3
# phase 9: full width at a reduced frame size, so the CPU side stays short
CHECK_TRAIN_H, CHECK_TRAIN_W, CHECK_TRAIN_N = 192, 320, 8
# phase 4: MSDA backward at the train encoder (B = 2 frames at 480x864) and the
# eval encoder shapes
MSDA_BWD_CASES = {
    "train_encoder": (2, [(15, 27), (30, 54), (60, 108)]),
    "eval_encoder": (10, [(12, 20), (24, 40), (48, 80)]),
    "one_level_v1": (2, [(60, 108)]),
}
# phase 5: the sampler's train shapes (B = 2 frames, 120x216 mask logits)
SAMPLER_CASES = {  # name -> (batch, rows, H, W, points)
    "matcher": (2, 100, 120, 216, 12544),
    "loss_candidates": (2, 40, 120, 216, 37632),
    "loss_random": (2, 40, 120, 216, 3136),
}
# the points' order in phase 5: K6 bins its adds in shared memory on y-sorted
# points (dense tiles) and adds straight to the output on unsorted ones
SAMPLER_POINTS = ("sorted", "unsorted", "border_centres")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 (non-tensor) flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# K1 and K2 per sample (a corner inside its level) and channel: four corner
# multiply-adds (K1: out += w_c v_c; K2: S_c += g v_c), 8 f32 operations
MSDA_FLOPS = 8.0

# stated tolerances: |kernel - plain| <= ATOL + RTOL * |plain|, elementwise
MSDA_TOL = {
    # same f32 arithmetic; the sums run in another order
    torch.float32: (1e-4, 1e-4),
    # plus one bf16 rounding of the output (relative spacing <= 2^-7)
    torch.bfloat16: (1e-3, 2 ** -7),
}
# backward kernels: |kernel - plain| <= REL_TO_MAX * max|plain| + RTOL * |plain|.
# Both sides compute in f32 from the same inputs; the channel, corner and
# (K3, K6) atomic sums run in other orders, and a difference of two corners
# (the slopes) can cancel, so the bound is relative to the largest element.
# A bf16 output (dattn, dvalue, dmaps) adds one bf16 rounding (2^-7).
BWD_REL_TO_MAX = 1e-4
BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}
# K5: the same four products summed in the same order; the kernel may fuse a
# multiply-add (one rounding fewer)
SAMPLER_REL_TO_MAX, SAMPLER_RTOL = 1e-5, 1e-5
HUNGARIAN_RTOL = 1e-6  # total cost against scipy's optimum
# phase 7, GPU kernels vs CPU plain in f32, TF32 off: summation order differs
# through ~50 layers of random weights, and the decoder's attention mask reads
# the sign of resized mask logits
SLICE_SCORE_ATOL = 5e-3
SLICE_MASK_REL_TO_MAX = 1e-2
SLICE_SIGN_AGREE = 0.999
# phase 9, the same f32 train step on the card and on the CPU, TF32 off: the
# sums run in other orders (cuBLAS/cuDNN vs CPU, atomics in K3/K6) through
# ~60 layers forward and backward, and the decoder's attention mask and the
# uncertain-point selection read signs and ranks of near-equal logits
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_NORM_RTOL = 1e-3
TRAIN_GRAD_REL_TO_MAX = 2e-2
TRAIN_CHECK_PARAMS = (
    "segmenter.pixel_decoder.encoder.layer0.self_attn.sampling_offsets.weight",
    "segmenter.pixel_decoder.encoder.layer0.self_attn.value_proj.weight",
    "segmenter.predictor.heads.mask_embed.layer2.weight",
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_cuda(fn, iters: int = TIMING_ITERS, warmup: int = 3) -> float:
    """Mean milliseconds per call from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str, iters: int = TIMING_ITERS) -> float:
    """Mean device time of one launch of the kernel whose name contains
    ``kernel``, from ``torch.profiler``'s CUDA kernel events over ``iters``
    calls of ``fn`` after warm-up: the kernel alone, without the wrapper's
    host work or its other launches (zeroing, casts)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    # the profiler may drop an event at the edge of its window
    if not iters // 2 <= len(us) <= iters:
        raise AssertionError(f"the profiler saw {len(us)} launches of {kernel} in {iters} calls")
    return sum(us) / len(us) / 1e3


def bound(nbytes: float, flops: float):
    """(least ms, what bounds it) on an H100 SXM: bytes over HBM rate or f32
    operations over the f32 peak, whichever is larger."""
    ms_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ms_ops = flops / F32_FLOPS * 1e3
    return (ms_bytes, "bytes") if ms_bytes >= ms_ops else (ms_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def phase_build():
    t0 = time.perf_counter()
    cuda_build.build_all(SOURCES)
    msda_cuda.library()
    msda_cuda.bwd_library()
    hungarian_cuda.library()
    point_sample_cuda.library()
    ptxas = {name: ptxas_report(log) for name, (_, log) in cuda_build.build_logs.items()}
    scatter = [k for name in ("msda_bwd", "point_sample") for k in ptxas.get(name, [])
               if "dvalue_kernel" in k["kernel"]]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": {k: v[0] for k, v in cuda_build.build_logs.items()}, "ptxas": ptxas,
          "k3_k6_instantiations": len(scatter),
          # null where the libraries were built before this run
          "k3_k6_stack_and_spill_free": all(
              k.get("stack", 0) == 0 and k.get("spill_stores", 0) == 0 for k in scatter)
          if scatter else None})


def ptxas_report(log: str):
    """Registers, stack and spills of each kernel from ``-Xptxas -v``."""
    kernels, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            kernels.append({"kernel": name})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and kernels:
            kernels[-1].update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", ln)
        if m and kernels:
            kernels[-1]["registers"] = int(m[1])
    try:  # readable template arguments where binutils is installed
        names = subprocess.run(["c++filt"], input="\n".join(k["kernel"] for k in kernels),
                               capture_output=True, text=True, timeout=60, check=True)
        for k, n in zip(kernels, names.stdout.splitlines()):
            k["kernel"] = n.replace("(anonymous namespace)::", "").split("(")[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return kernels


def _msda_inputs(b, levels, dtype, gen):
    nl = len(levels)
    length = sum(h * w for h, w in levels)
    nh, ch, p = MSDA_HEADS, MSDA_CH, MSDA_POINTS
    value = torch.randn(b, length, nh, ch, device=DEVICE, generator=gen).to(dtype)
    # [-0.1, 1.1]: some points fall outside the map
    loc = torch.rand(b, length, nh, nl, p, 2, device=DEVICE, generator=gen) * 1.2 - 0.1
    attn = torch.randn(b, length, nh, nl * p, device=DEVICE, generator=gen)
    attn = torch.softmax(attn, dim=-1).view(b, length, nh, nl, p).to(dtype)
    return value, loc, attn


def _msda_in_range(levels, loc) -> int:
    """Samples with a corner inside their level (the ones the kernels work on)."""
    n = 0
    for lvl, (h, w) in enumerate(levels):
        x = loc[:, :, :, lvl, :, 0] * w - 0.5
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        n += int(((x > -1) & (y > -1) & (x < w) & (y < h)).sum())
    return n


def _plan(*tensors):
    """The K1 (three tensors) or K2 (four) instantiation these inputs take."""
    plan = msda_cuda.launch_plan(*tensors)
    names = {msda_cuda.MAIN: "main", msda_cuda.GENERIC: "generic"}
    return {"variant": names[plan.variant], "vec": plan.vec, "lanes": plan.lanes,
            "blocks": plan.blocks, "threads": msda_cuda.THREADS}


def phase_msda():
    """K1 against its plain version; returns its JSON fields at the train
    encoder shape in bf16 (the AMP train step's)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    worst, main = 0.0, None
    for case, (batch, levels) in MSDA_CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            value, loc, attn = _msda_inputs(batch, levels, dtype, gen)
            got = msda_cuda.ms_deform_attn_cuda(value, levels, loc, attn)
            ref = ms_deform_attn_plain(value, levels, loc, attn)
            torch.cuda.synchronize()
            atol, rtol = MSDA_TOL[dtype]
            diff = (got.float() - ref.float()).abs()
            ok = bool((diff <= atol + rtol * ref.float().abs()).all())
            max_abs = diff.max().item()
            k_ms = time_cuda(lambda: msda_cuda.ms_deform_attn_cuda(value, levels, loc, attn))
            p_ms = time_cuda(lambda: ms_deform_attn_plain(value, levels, loc, attn))
            b_ms, b_by = bound(nbytes(value, loc, attn, got),
                               MSDA_FLOPS * _msda_in_range(levels, loc) * MSDA_CH)
            emit({"phase": "k1_msda_fwd", "case": case, "levels": levels,
                  "batch": batch, "dtype": str(dtype).replace("torch.", ""),
                  "plan": _plan(value, loc, attn),
                  "max_abs_err": max_abs,
                  "max_rel_err": max_abs / max(ref.float().abs().max().item(), 1e-30),
                  "tol": {"atol": atol, "rtol": rtol}, "within_tol": ok,
                  "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by})
            if not ok:
                raise AssertionError(f"K1 disagrees with its plain version ({case}, {dtype})")
            worst = max(worst, max_abs)
            if case == "train_encoder" and dtype == torch.bfloat16:
                dev = device_ms(lambda: msda_cuda.ms_deform_attn_cuda(value, levels, loc, attn),
                                "msda_fwd_kernel")
                main = {"ms": k_ms, "device_ms": dev, "plain_ms": p_ms, "bound_ms": b_ms,
                        "bound_by": b_by}
    return {"max_abs_err": worst, **main}


def _hungarian_costs(name, b, n, m, rng):
    if name == "tracking_cosine":
        e = rng.randn(b, 2, n, 256).astype(np.float32)
        e /= np.linalg.norm(e, axis=-1, keepdims=True)
        return (1.0 - np.einsum("bqc,bkc->bqk", e[:, 0], e[:, 1])).astype(np.float32)
    if name == "integer_ties":
        return rng.randint(1, 5, size=(b, n, m)).astype(np.float32)
    return (rng.rand(b, n, m) * 5).astype(np.float32)


def phase_hungarian():
    """K4 against scipy and the plain loop; returns its JSON fields at the
    matcher's shape (one launch per train step)."""
    rng = np.random.RandomState(SEED)
    worst, main = 0.0, None
    for name, (b, n, m) in HUNGARIAN_CASES.items():
        cost = _hungarian_costs(name, b, n, m, rng)
        cost_dev = torch.from_numpy(cost).to(DEVICE)
        cols = hungarian_cuda.batched_hungarian_cuda(cost_dev).cpu().numpy()
        errs = []
        for bi in range(b):
            if len(set(cols[bi].tolist())) != n:
                raise AssertionError(f"K4 {name}[{bi}]: not an injective column map")
            c64 = cost[bi].astype(np.float64)
            r, c = linear_sum_assignment(c64)
            total = c64[np.arange(n), cols[bi]].sum()
            best = c64[r, c].sum()
            if abs(total - best) > HUNGARIAN_RTOL * abs(best):
                raise AssertionError(f"K4 {name}[{bi}]: cost {total} vs scipy {best}")
            errs.append(abs(total - best))
        # the plain loop runs on the CPU: it syncs on every Dijkstra step
        t0 = time.perf_counter()
        plain = [hungarian_plain(torch.from_numpy(cost[bi])).numpy() for bi in range(b)]
        plain_ms = (time.perf_counter() - t0) * 1e3
        for bi in range(b):
            c64 = cost[bi].astype(np.float64)
            kernel_total = c64[np.arange(n), cols[bi]].sum()
            if abs(c64[np.arange(n), plain[bi]].sum() - kernel_total) > (
                    HUNGARIAN_RTOL * abs(kernel_total)):
                raise AssertionError(f"K4 {name}[{bi}] disagrees with hungarian_plain")
        t0 = time.perf_counter()
        for bi in range(b):
            linear_sum_assignment(cost[bi].astype(np.float64))
        scipy_ms = (time.perf_counter() - t0) * 1e3
        k_ms = time_cuda(lambda: hungarian_cuda.batched_hungarian_cuda(cost_dev))
        b_ms, b_by = bound(cost.nbytes + b * n * 4, 0.0)
        emit({"phase": "k4_hungarian", "case": name, "shape": [b, n, m],
              "max_abs_cost_err_vs_scipy": max(errs), "rtol": HUNGARIAN_RTOL,
              "kernel_ms": k_ms, "plain_cpu_ms_per_batch": plain_ms,
              "scipy_cpu_ms_per_batch": scipy_ms, "bound_ms": b_ms})
        worst = max(worst, max(errs))
        if name == "matcher_uniform":
            dev = device_ms(lambda: hungarian_cuda.batched_hungarian_cuda(cost_dev),
                            "hungarian_kernel")
            main = {"ms": k_ms, "device_ms": dev, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by}
    return {"max_abs_err": worst, **main}


def _check_close(got, ref, rel_to_max, rtol):
    """(within tolerance, max abs error, max abs error over max |ref|)."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    scale = ref.abs().max().item()
    ok = bool((diff <= rel_to_max * scale + rtol * ref.abs()).all())
    max_abs = diff.max().item()
    return ok, max_abs, max_abs / max(scale, 1e-30)


def _k3_plan(value, levels, loc):
    """K3's plan for these inputs and the share of its corner adds that go
    through the shared-memory bins (computed on the host side, untimed)."""
    plan = msda_cuda.dvalue_plan(value, loc)
    return {"k3_plan": dataclasses.asdict(plan),
            "k3_band_share": msda_cuda.band_share(levels, loc, plan)}


def phase_msda_bwd():
    """K2 and K3 against the plain backward; returns their JSON fields at the
    train encoder shape in bf16 (the AMP train step's dtypes)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    out = {"msda_dcoord": {"max_abs_err": 0.0}, "msda_dvalue": {"max_abs_err": 0.0}}
    for case, (b, levels) in MSDA_BWD_CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            value, loc, attn = _msda_inputs(b, levels, dtype, gen)
            g = torch.randn(b, loc.shape[1], MSDA_HEADS * MSDA_CH, device=DEVICE,
                            generator=gen).to(dtype)
            dloc, dattn = msda_cuda.msda_dcoord_cuda(value, levels, loc, attn, g)
            dvalue = msda_cuda.msda_dvalue_cuda(value, levels, loc, attn, g)
            ref_v, ref_loc, ref_attn = ms_deform_attn_bwd_plain(value, levels, loc, attn, g)
            torch.cuda.synchronize()
            checks = {
                "dloc": _check_close(dloc, ref_loc, BWD_REL_TO_MAX, BWD_RTOL[torch.float32]),
                "dattn": _check_close(dattn, ref_attn, BWD_REL_TO_MAX, BWD_RTOL[dtype]),
                "dvalue": _check_close(dvalue, ref_v, BWD_REL_TO_MAX, BWD_RTOL[dtype]),
            }
            k2_ms = time_cuda(lambda: msda_cuda.msda_dcoord_cuda(value, levels, loc, attn, g))
            k3_ms = time_cuda(lambda: msda_cuda.msda_dvalue_cuda(value, levels, loc, attn, g))
            k2_plain = time_cuda(lambda: ms_deform_attn_bwd_plain(
                value, levels, loc, attn, g, dvalue=False), iters=5)
            k3_plain = time_cuda(lambda: ms_deform_attn_bwd_plain(
                value, levels, loc, attn, g, dcoords=False), iters=5)
            samples = _msda_in_range(levels, loc)
            k2_b = bound(nbytes(value, loc, attn, g, dloc, dattn), MSDA_FLOPS * samples * MSDA_CH)
            k3_b = bound(nbytes(loc, attn, g, dvalue), 9.0 * samples * MSDA_CH)
            main = case == "train_encoder" and dtype == torch.bfloat16
            if main:
                k2_dev = device_ms(lambda: msda_cuda.msda_dcoord_cuda(value, levels, loc, attn, g),
                                   "msda_dcoord_kernel")
                k3_dev = device_ms(lambda: msda_cuda.msda_dvalue_cuda(value, levels, loc, attn, g),
                                   "msda_dvalue_kernel")
            emit({"phase": "k2_k3_msda_bwd", "case": case, "batch": b, "levels": levels,
                  "dtype": str(dtype).replace("torch.", ""),
                  "k2_plan": _plan(value, loc, attn, g), **_k3_plan(value, levels, loc),
                  "errors": {k: {"within_tol": c[0], "max_abs_err": c[1],
                                 "max_err_rel_to_max": c[2]} for k, c in checks.items()},
                  "tol": {"rel_to_max": BWD_REL_TO_MAX, "rtol_f32_outputs": BWD_RTOL[torch.float32],
                          "rtol_outputs_in_dtype": BWD_RTOL[dtype]},
                  "k2_ms": k2_ms, "k3_ms": k3_ms,
                  "k2_plain_ms": k2_plain, "k3_plain_ms": k3_plain,
                  "k2_bound_ms": k2_b[0], "k2_bound_by": k2_b[1],
                  "k3_bound_ms": k3_b[0], "k3_bound_by": k3_b[1]})
            bad = [k for k, c in checks.items() if not c[0]]
            if bad:
                raise AssertionError(f"K2/K3 disagree with the plain backward ({case}, {dtype}): {bad}")
            out["msda_dcoord"]["max_abs_err"] = max(out["msda_dcoord"]["max_abs_err"],
                                                    checks["dloc"][1], checks["dattn"][1])
            out["msda_dvalue"]["max_abs_err"] = max(out["msda_dvalue"]["max_abs_err"],
                                                    checks["dvalue"][1])
            if main:
                out["msda_dcoord"].update(ms=k2_ms, device_ms=k2_dev, plain_ms=k2_plain,
                                          bound_ms=k2_b[0], bound_by=k2_b[1])
                out["msda_dvalue"].update(ms=k3_ms, device_ms=k3_dev, plain_ms=k3_plain,
                                          bound_ms=k3_b[0], bound_by=k3_b[1])
    return out


class MsdaRecorder:
    """Wraps the K1 and K2 wrappers for one run of a path and keeps host
    copies of the first encoder layer's inputs (so that they add nothing to
    the paths' peak device memory): K1's first call (layer 0 runs first in
    the forward) and K2's last (layer 0's gradient comes last), with the
    instantiation each call took."""

    def __enter__(self):
        self.fwd = self.dcoord = None
        self._k1, self._k2 = msda_cuda.ms_deform_attn_cuda, msda_cuda.msda_dcoord_cuda

        def k1(value, shapes, loc, attn):
            if self.fwd is None:
                self.fwd = ((value.cpu(), list(shapes), loc.cpu(), attn.cpu()),
                            _plan(value, loc, attn))
            return self._k1(value, shapes, loc, attn)

        def k2(value, shapes, loc, attn, g):
            self.dcoord = ((value.cpu(), list(shapes), loc.cpu(), attn.cpu(), g.cpu()),
                           _plan(value, loc, attn, g))
            return self._k2(value, shapes, loc, attn, g)

        msda_cuda.ms_deform_attn_cuda, msda_cuda.msda_dcoord_cuda = k1, k2
        return self

    def __exit__(self, *exc):
        msda_cuda.ms_deform_attn_cuda, msda_cuda.msda_dcoord_cuda = self._k1, self._k2


def _on_pixel_centres(levels, loc) -> float:
    """Share of the samples whose pixel coordinates are whole numbers (the
    ring-bias init's samples), where the bilinear slope is one-sided."""
    hits, n = 0, 0
    for lvl, (h, w) in enumerate(levels):
        x = loc[:, :, :, lvl, :, 0] * w - 0.5
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        hits += int(((x == x.floor()) & (y == y.floor())).sum())
        n += x.numel()
    return hits / max(n, 1)


def _bound_parts(nbytes_moved, flops):
    """The two times whose larger is ``bound``'s, as JSON fields."""
    return {"bound_bytes_ms": nbytes_moved / HBM_BYTES_PER_S * 1e3,
            "bound_operations_ms": flops / F32_FLOPS * 1e3}


def phase_msda_recorded(eval_rec: MsdaRecorder, train_rec: MsdaRecorder):
    """K1, K2 and K3 on the inputs the first encoder layer gave them on the
    paths (phases 6 and 8: a full-width eval window and train step; K3 takes
    K2's inputs), against the plain versions with the tolerances of phases 2
    and 4, timed beside their bounds; returns the kernels line's
    recorded-input times."""
    out = {}
    for path, rec in (("eval", eval_rec), ("train", train_rec)):
        (value, levels, loc, attn), plan = rec.fwd
        value, loc, attn = (t.to(DEVICE) for t in (value, loc, attn))
        got = msda_cuda.ms_deform_attn_cuda(value, levels, loc, attn)
        ref = ms_deform_attn_plain(value, levels, loc, attn)
        torch.cuda.synchronize()
        atol, rtol = MSDA_TOL[value.dtype]
        diff = (got.float() - ref.float()).abs()
        ok = bool((diff <= atol + rtol * ref.float().abs()).all())
        k_ms = time_cuda(lambda: msda_cuda.ms_deform_attn_cuda(value, levels, loc, attn))
        moved = nbytes(value, loc, attn, got)
        flops = MSDA_FLOPS * _msda_in_range(levels, loc) * MSDA_CH
        b_ms, b_by = bound(moved, flops)
        emit({"phase": "k1_recorded_inputs", "path": path, "layer": 0,
              "batch": value.shape[0], "levels": levels,
              "dtypes": [str(t.dtype).replace("torch.", "") for t in (value, loc, attn)],
              "plan": plan, "on_pixel_centres": _on_pixel_centres(levels, loc),
              "max_abs_err": diff.max().item(), "tol": {"atol": atol, "rtol": rtol},
              "within_tol": ok, "kernel_ms": k_ms, "bound_ms": b_ms, "bound_by": b_by,
              **_bound_parts(moved, flops)})
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version on the {path} inputs")
        out.setdefault("msda_fwd", {})[f"recorded_{path}_ms"] = k_ms

    (value, levels, loc, attn, g), plan = train_rec.dcoord
    value, loc, attn, g = (t.to(DEVICE) for t in (value, loc, attn, g))
    dloc, dattn = msda_cuda.msda_dcoord_cuda(value, levels, loc, attn, g)
    dvalue = msda_cuda.msda_dvalue_cuda(value, levels, loc, attn, g)
    ref_v, ref_loc, ref_attn = ms_deform_attn_bwd_plain(value, levels, loc, attn, g)
    torch.cuda.synchronize()
    checks = {"dloc": _check_close(dloc, ref_loc, BWD_REL_TO_MAX, BWD_RTOL[torch.float32]),
              "dattn": _check_close(dattn, ref_attn, BWD_REL_TO_MAX, BWD_RTOL[attn.dtype]),
              "dvalue": _check_close(dvalue, ref_v, BWD_REL_TO_MAX, BWD_RTOL[value.dtype])}
    k2_ms = time_cuda(lambda: msda_cuda.msda_dcoord_cuda(value, levels, loc, attn, g))
    k3_ms = time_cuda(lambda: msda_cuda.msda_dvalue_cuda(value, levels, loc, attn, g))
    k3_dev = device_ms(lambda: msda_cuda.msda_dvalue_cuda(value, levels, loc, attn, g),
                       "msda_dvalue_kernel")
    moved = nbytes(value, loc, attn, g, dloc, dattn)
    flops = MSDA_FLOPS * _msda_in_range(levels, loc) * MSDA_CH
    b_ms, b_by = bound(moved, flops)
    k3_b = bound(nbytes(loc, attn, g, dvalue), 9.0 * _msda_in_range(levels, loc) * MSDA_CH)
    emit({"phase": "k2_k3_recorded_inputs", "path": "train", "layer": 0,
          "batch": value.shape[0], "levels": levels,
          "dtypes": [str(t.dtype).replace("torch.", "") for t in (value, loc, attn, g)],
          "plan": plan, **_k3_plan(value, levels, loc),
          "on_pixel_centres": _on_pixel_centres(levels, loc),
          "errors": {k: {"within_tol": c[0], "max_abs_err": c[1], "max_err_rel_to_max": c[2]}
                     for k, c in checks.items()},
          "tol": {"rel_to_max": BWD_REL_TO_MAX, "rtol_f32_outputs": BWD_RTOL[torch.float32],
                  "rtol_outputs_in_dtype": BWD_RTOL[attn.dtype],
                  "rtol_dvalue": BWD_RTOL[value.dtype]},
          "k2_ms": k2_ms, "k2_bound_ms": b_ms, "k2_bound_by": b_by, "k3_ms": k3_ms,
          "k3_device_ms": k3_dev, "k3_bound_ms": k3_b[0], "k3_bound_by": k3_b[1],
          **{f"k2_{k}": v for k, v in _bound_parts(moved, flops).items()}})
    if not all(c[0] for c in checks.values()):
        raise AssertionError("K2/K3 disagree with the plain backward on the train inputs")
    out["msda_dvalue"] = {"recorded_train_ms": k3_ms, "recorded_train_device_ms": k3_dev}
    out["msda_dcoord"] = {"recorded_train_ms": k2_ms}
    return out


def _grid_sample(maps, coords):
    """One PyTorch call computing K5's function (a yardstick only)."""
    grid = (coords * 2 - 1)[:, None]                      # (B, 1, P, 2)
    return F.grid_sample(maps, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)[:, :, 0]


def _sampler_points(kind, gen, b, h, w, p):
    """(B, P, 2) points: ``sorted`` by y as the criterion draws them;
    ``unsorted``, the same shuffled; ``border_centres``, a third of them on
    pixel centres (x from -1 to W-1 and y from -1 to H-1 in pixels) and a
    third on the borders x = -1 and x = W-1, then sorted by y."""
    pts = sorted_uniform_points(gen, (b,), p)
    if kind == "unsorted":
        return pts[:, torch.randperm(p, device=DEVICE, generator=gen)].contiguous()
    if kind == "border_centres":
        n = p // 3
        px = torch.randint(-1, w, (b, n), device=DEVICE, generator=gen).float()
        py = torch.randint(-1, h, (b, n), device=DEVICE, generator=gen).float()
        pts[:, :n, 0] = (px + 0.5) / w
        pts[:, :n, 1] = (py + 0.5) / h
        side = torch.rand(b, n, device=DEVICE, generator=gen) < 0.5
        pts[:, n:2 * n, 0] = torch.where(side, -0.5 / w, (w - 0.5) / w)
        order = pts[..., 1].argsort(dim=-1)
        pts = torch.gather(pts, 1, order[..., None].expand(b, p, 2)).contiguous()
    return pts


def phase_sampler():
    """K5 and K6 against the plain sampler and its autograd; returns their
    JSON fields at the loss-candidate shape with bf16 maps and sorted points
    (the AMP train step)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    out = {"point_sample_fwd": {"max_abs_err": 0.0},
           "point_sample_dvalue": {"max_abs_err": 0.0}}
    for (case, (b, r, h, w, p)), kind in itertools.product(SAMPLER_CASES.items(), SAMPLER_POINTS):
        for dtype in (torch.bfloat16, torch.float32):
            maps = (torch.randn(b, r, h, w, device=DEVICE, generator=gen) * 4).to(dtype)
            coords = _sampler_points(kind, gen, b, h, w, p)
            g = torch.randn(b, r, p, device=DEVICE, generator=gen)
            got = point_sample_cuda.point_sample_fwd_cuda(maps, coords)
            ref = sample_maps_shared_plain(maps, coords, f32_policy=True)
            dgot = point_sample_cuda.point_sample_dvalue_cuda(coords, g, maps.shape, maps.dtype)
            dref = sample_maps_dvalue_plain(maps, coords, g)
            torch.cuda.synchronize()
            fwd = _check_close(got, ref, SAMPLER_REL_TO_MAX, SAMPLER_RTOL)
            bwd = _check_close(dgot, dref, BWD_REL_TO_MAX, BWD_RTOL[dtype])
            plan = point_sample_cuda.dvalue_plan(maps.shape, p)
            share = point_sample_cuda.band_share(coords, maps.shape, plan)
            k5_ms = time_cuda(lambda: point_sample_cuda.point_sample_fwd_cuda(maps, coords))
            k6_ms = time_cuda(lambda: point_sample_cuda.point_sample_dvalue_cuda(
                coords, g, maps.shape, maps.dtype))
            k5_plain = time_cuda(lambda: sample_maps_shared_plain(maps, coords, True), iters=5)
            k6_plain = time_cuda(lambda: sample_maps_dvalue_plain(maps, coords, g), iters=5)
            # the yardstick samples the maps widened to f32 outside the timing:
            # grid_sample takes one dtype for maps and grid
            m32 = maps.float().requires_grad_()
            lib_fwd = time_cuda(lambda: _grid_sample(m32.detach(), coords))

            def lib_bwd():
                with torch.enable_grad():
                    torch.autograd.grad(_grid_sample(m32, coords), (m32,), g)

            lib_bwd_ms = time_cuda(lib_bwd)
            emit({"phase": "k5_k6_point_sample", "case": case, "points_order": kind,
                  "maps": [b, r, h, w], "points": p, "dtype": str(dtype).replace("torch.", ""),
                  "k5": {"within_tol": fwd[0], "max_abs_err": fwd[1], "max_err_rel_to_max": fwd[2]},
                  "k6": {"within_tol": bwd[0], "max_abs_err": bwd[1], "max_err_rel_to_max": bwd[2]},
                  "tol": {"k5_rel_to_max": SAMPLER_REL_TO_MAX, "k5_rtol": SAMPLER_RTOL,
                          "k6_rel_to_max": BWD_REL_TO_MAX, "k6_rtol": BWD_RTOL[dtype]},
                  "k6_plan": dataclasses.asdict(plan), "k6_band_share": share,
                  "k5_ms": k5_ms, "k6_ms": k6_ms, "k5_plain_ms": k5_plain,
                  "k6_plain_ms": k6_plain, "grid_sample_ms": lib_fwd,
                  "grid_sample_backward_ms": lib_bwd_ms})
            if not (fwd[0] and bwd[0]):
                raise AssertionError(f"K5/K6 disagree with the plain sampler ({case}, {kind}, {dtype})")
            out["point_sample_fwd"]["max_abs_err"] = max(out["point_sample_fwd"]["max_abs_err"], fwd[1])
            out["point_sample_dvalue"]["max_abs_err"] = max(
                out["point_sample_dvalue"]["max_abs_err"], bwd[1])
            if case == "loss_candidates" and kind == "sorted" and dtype == torch.bfloat16:
                x = coords[..., 0] * w - 0.5
                y = coords[..., 1] * h - 0.5
                inside = int(((x > -1) & (y > -1) & (x < w) & (y < h)).sum()) * r
                k5_b = bound(nbytes(maps, coords, got), 12.0 * inside)
                k6_b = bound(nbytes(coords, g, dgot), 8.0 * inside)
                k5_dev = device_ms(lambda: point_sample_cuda.point_sample_fwd_cuda(maps, coords),
                                   "point_sample_fwd_kernel")
                k6_dev = device_ms(lambda: point_sample_cuda.point_sample_dvalue_cuda(
                    coords, g, maps.shape, maps.dtype), "point_sample_dvalue_kernel")
                out["point_sample_fwd"].update(ms=k5_ms, device_ms=k5_dev, plain_ms=k5_plain,
                                               library_ms=lib_fwd, bound_ms=k5_b[0],
                                               bound_by=k5_b[1])
                out["point_sample_dvalue"].update(ms=k6_ms, device_ms=k6_dev, plain_ms=k6_plain,
                                                  library_ms=lib_bwd_ms, bound_ms=k6_b[0],
                                                  bound_by=k6_b[1])
    return out


def _full_config(**solver):
    cfg = Config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, num_classes=K_CLASSES),
        solver=dataclasses.replace(cfg.solver, **solver))


def _text(rng):
    text = rng.randn(K_CLASSES, TEXT_DIM).astype(np.float32)
    return text / np.linalg.norm(text, axis=-1, keepdims=True)


def _check_outputs(out, q, k, t, h, w, where):
    topk = 10
    shapes = {"scores": (topk,), "labels": (topk,), "query_idx": (topk,),
              "entropy": (topk,), "mask_logits": (topk, t, h // 4, w // 4)}
    for name, shape in shapes.items():
        if tuple(out[name].shape) != shape:
            raise AssertionError(f"{where}: {name} shape {tuple(out[name].shape)} != {shape}")
        if not torch.isfinite(out[name].float()).all():
            raise AssertionError(f"{where}: {name} is not finite")
    if not ((out["labels"] >= 0).all() and (out["labels"] < k).all()
            and (out["query_idx"] >= 0).all() and (out["query_idx"] < q).all()):
        raise AssertionError(f"{where}: labels or query_idx out of range")


def reset_counts() -> None:
    msda_cuda.launches = msda_cuda.dcoord_launches = msda_cuda.dvalue_launches = 0
    hungarian_cuda.launches = 0
    point_sample_cuda.fwd_launches = point_sample_cuda.dvalue_launches = 0


def read_counts():
    return {"msda_fwd": msda_cuda.launches, "msda_dcoord": msda_cuda.dcoord_launches,
            "msda_dvalue": msda_cuda.dvalue_launches, "hungarian": hungarian_cuda.launches,
            "point_sample_fwd": point_sample_cuda.fwd_launches,
            "point_sample_dvalue": point_sample_cuda.dvalue_launches}


def phase_slice(card: str, rec: MsdaRecorder):
    """The eval path at full width, bf16: three windows; returns the launch
    counts of the timed run.  The warm-up window's MSDA inputs go to ``rec``."""
    cfg = _full_config()
    model = init_params(train.build_model(cfg), seed=SEED)
    model = model.to(dtype=torch.bfloat16).eval()
    eval_fn = train.make_eval_fn(cfg, model)
    rng = np.random.RandomState(SEED)
    t, h, w = WINDOW_FRAMES, FRAME_H, FRAME_W
    windows = [
        torch.from_numpy(rng.randn(t, h, w, 3).astype(np.float32)).to(DEVICE, torch.bfloat16)
        for _ in range(NUM_WINDOWS)
    ]
    text = torch.from_numpy(_text(rng)).to(DEVICE, torch.bfloat16)

    with rec:
        eval_fn(windows[0], text)  # warm-up: cuDNN autotuning, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts()
    start.record()
    outs = [eval_fn(x, text) for x in windows]
    end.record()
    torch.cuda.synchronize()
    launches = read_counts()
    ms = start.elapsed_time(end)
    q = cfg.model.transformer_decoder.num_queries
    for i, out in enumerate(outs):
        _check_outputs(out, q, K_CLASSES, t, h, w, f"window {i}")
    enc_layers = cfg.model.pixel_decoder.transformer_enc_layers
    expected = {**{k: 0 for k in launches},
                "msda_fwd": enc_layers * NUM_WINDOWS, "hungarian": NUM_WINDOWS}
    emit({"phase": "slice_full_width", "dtype": "bfloat16", "windows": NUM_WINDOWS,
          "frames_per_window": t, "frame_hw": [h, w], "launches": launches,
          "expected_launches": expected, "ms_per_window": ms / NUM_WINDOWS,
          "frames_per_s": NUM_WINDOWS * t / (ms / 1e3),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "card": card})
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    return launches


def phase_slice_vs_plain():
    """One f32 window of CHECK_FRAMES frames: card (kernels) vs CPU (plain)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _full_config()
    cpu_model = init_params(train.build_model(cfg, device="cpu"), seed=SEED + 1).eval()
    gpu_model = copy.deepcopy(cpu_model).to(DEVICE)
    rng = np.random.RandomState(SEED + 1)
    frames = torch.from_numpy(
        rng.randn(CHECK_FRAMES, FRAME_H, FRAME_W, 3).astype(np.float32))
    text = torch.from_numpy(_text(rng))
    ref = train.make_eval_fn(cfg, cpu_model)(frames, text)
    got = {k: v.cpu() for k, v in train.make_eval_fn(cfg, gpu_model)(
        frames.to(DEVICE), text.to(DEVICE)).items()}
    q = cfg.model.transformer_decoder.num_queries
    _check_outputs(got, q, K_CLASSES, CHECK_FRAMES, FRAME_H, FRAME_W, "kernel slice")
    score_err = (got["scores"] - ref["scores"]).abs().max().item()
    same_pairs = bool(torch.equal(got["labels"], ref["labels"])
                      and torch.equal(got["query_idx"], ref["query_idx"]))
    mref, mgot = ref["mask_logits"], got["mask_logits"]
    mask_rel = ((mgot - mref).abs().max() / mref.abs().max()).item()
    sign_agree = ((mgot > 0) == (mref > 0)).float().mean().item()
    emit({"phase": "slice_kernels_vs_plain", "dtype": "float32", "tf32": False,
          "frames": CHECK_FRAMES, "frame_hw": [FRAME_H, FRAME_W],
          "max_abs_score_err": score_err, "labels_and_query_idx_equal": same_pairs,
          "mask_max_err_rel_to_max": mask_rel, "mask_sign_agree": sign_agree,
          "tol": {"score_atol": SLICE_SCORE_ATOL, "mask_rel_to_max": SLICE_MASK_REL_TO_MAX,
                  "sign_agree": SLICE_SIGN_AGREE}})
    if not (same_pairs and score_err <= SLICE_SCORE_ATOL
            and mask_rel <= SLICE_MASK_REL_TO_MAX and sign_agree >= SLICE_SIGN_AGREE):
        raise AssertionError("the kernel slice disagrees with the plain slice")


def _train_batch(rng, h, w, n, device):
    """bench.py's synthetic train batch: 1 clip of TRAIN_T frames, n targets
    with 10 % foreground masks, all valid."""
    t = TRAIN_T
    pixels = torch.from_numpy(rng.randn(1, t, h, w, 3).astype(np.float32))
    targets = ClipTargets(
        labels=torch.from_numpy(rng.randint(0, K_CLASSES, (1, n))),
        masks=torch.from_numpy(rng.rand(1, n, t, h, w) > 0.9),
        valid=torch.ones(1, n, dtype=torch.bool),
        frame_valid=torch.ones(1, n, t, dtype=torch.bool),
    )
    return {"pixels": pixels.to(device), "targets": targets.to(device),
            "text_feats": torch.from_numpy(_text(rng)).to(device)}


def phase_train(card: str, rec: MsdaRecorder):
    """The train step at full width, bf16 AMP; returns the launch counts of
    the timed steps.  The warm-up step's MSDA inputs go to ``rec``."""
    cfg = _full_config()
    model = init_params(train.build_model(cfg), seed=SEED)
    frozen_params = [p for m in model.modules() if isinstance(m, FrozenAffine)
                     for p in m.parameters()]
    frozen_before = [p.detach().clone() for p in frozen_params]
    offsets = model.segmenter.pixel_decoder.encoder.layer0.self_attn.sampling_offsets.weight
    offsets_before = offsets.detach().clone()
    step = train.build_train_step(cfg, model, K_CLASSES)
    batch = _train_batch(np.random.RandomState(SEED), TRAIN_H, TRAIN_W, TRAIN_N, DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    with rec:
        step(batch, gen)  # warm-up: cuDNN autotuning, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts()
    start.record()
    metrics = [step(batch, gen) for _ in range(TRAIN_STEPS)]
    end.record()
    torch.cuda.synchronize()
    launches = read_counts()
    ms = start.elapsed_time(end) / TRAIN_STEPS
    layers = cfg.model.transformer_decoder.dec_layers + 1
    enc = cfg.model.pixel_decoder.transformer_enc_layers
    # per decoder layer K5 samples the masks for the matcher and for the two
    # loss point sets, K6 takes the two loss samplings' gradients; targets
    # above KERNEL_MAX_HW pixels (480x864) take the plain gather path
    target_samplings = 3 if TRAIN_H * TRAIN_W <= KERNEL_MAX_HW else 0
    per_step = {"msda_fwd": enc, "msda_dcoord": enc, "msda_dvalue": enc, "hungarian": 1,
                "point_sample_fwd": (3 + target_samplings) * layers,
                "point_sample_dvalue": 2 * layers}
    expected = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    values = [{k: float(v) for k, v in m.items()} for m in metrics]
    frozen_fixed = all(torch.equal(p, b) for p, b in zip(frozen_params, frozen_before))
    offsets_moved = not torch.equal(offsets.detach(), offsets_before)
    emit({"phase": "train_full_width", "dtype": "bf16 AMP, f32 masters",
          "batch": [1, TRAIN_T, TRAIN_H, TRAIN_W], "targets": TRAIN_N,
          "points": cfg.model.criterion.train_num_points, "steps": TRAIN_STEPS,
          "ms_per_step": ms, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "metrics": values, "launches": launches, "expected_launches": expected,
          "frozen_affine_params": len(frozen_params), "frozen_fixed": frozen_fixed,
          "encoder_sampling_offsets_moved": offsets_moved, "card": card})
    if launches != expected:
        raise AssertionError(f"train-step kernel launches {launches} != {expected}")
    if not all(np.isfinite(v) for m in values for v in m.values()):
        raise AssertionError("a train-step loss or grad norm is not finite")
    if not frozen_fixed:
        raise AssertionError("a frozen FrozenAffine parameter changed")
    if not offsets_moved:
        raise AssertionError("the encoder's sampling offsets did not move: MSDA lost its gradient")
    return launches


def _loss_and_grads(cfg, model, batch, records):
    """Loss, metrics, gradients of the trainable parameters and the matcher's
    assignments of one f32 train-step forward and backward."""
    stop_frozen_gradients(model, config_labels(cfg, model))
    loss_fn = train.make_loss_fn(cfg, model, K_CLASSES)
    params = dict(model.named_parameters())
    names = [n for n, p in params.items() if p.requires_grad]
    solve = criterion.batched_hungarian

    def recording(cost):
        cols = solve(cost)
        records.append((cost.cpu(), cols.cpu()))
        return cols

    criterion.batched_hungarian = recording
    try:
        loss, metrics = loss_fn(params, batch, torch.Generator().manual_seed(SEED))
    finally:
        criterion.batched_hungarian = solve
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    return loss.item(), {k: v.item() for k, v in metrics.items()}, dict(zip(names, grads))


def phase_train_vs_plain():
    """One f32 train-step loss and gradient: card (kernels) vs CPU (plain),
    from the same weights and the same criterion points (drawn on a CPU
    generator on both sides)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the CPU side's oneDNN f32 convolution weight-gradient differs from a
    # float64 run by up to 1.5 % of its largest element in one ResNet layer;
    # PyTorch's own CPU convolution does not
    torch.backends.mkldnn.enabled = False
    cfg = _full_config(amp=False)
    cpu_model = init_params(train.build_model(cfg, device="cpu"), seed=SEED + 2)
    # move every encoder sample off the pixel centres where the ring-bias init
    # puts it: there the bilinear slope is one-sided and an ulp picks the side
    gen = torch.Generator().manual_seed(SEED + 2)
    with torch.no_grad():
        for m in cpu_model.modules():
            if isinstance(m, MSDeformAttnModule):
                m.sampling_offsets.weight.copy_(
                    torch.randn(m.sampling_offsets.weight.shape, generator=gen) * 0.02)
    gpu_model = copy.deepcopy(cpu_model).to(DEVICE)
    batch = _train_batch(np.random.RandomState(SEED + 2), CHECK_TRAIN_H, CHECK_TRAIN_W,
                         CHECK_TRAIN_N, "cpu")
    gpu_batch = {"pixels": batch["pixels"].to(DEVICE), "targets": batch["targets"].to(DEVICE),
                 "text_feats": batch["text_feats"].to(DEVICE)}
    ref_rec, got_rec = [], []
    t0 = time.perf_counter()
    ref_loss, ref_m, ref_g = _loss_and_grads(cfg, cpu_model, batch, ref_rec)
    cpu_s = time.perf_counter() - t0
    reset_counts()
    got_loss, got_m, got_g = _loss_and_grads(cfg, gpu_model, gpu_batch, got_rec)
    torch.cuda.synchronize()
    launches = read_counts()
    ref_norm = global_norm(ref_g.values()).item()
    got_norm = global_norm(t.cpu() for t in got_g.values()).item()
    losses = {"total": (got_loss, ref_loss), **{k: (got_m[k], ref_m[k]) for k in ref_m}}
    loss_rel = {k: abs(a - b) / max(abs(b), 1e-30) for k, (a, b) in losses.items()}
    grad_rel = {}
    for name in TRAIN_CHECK_PARAMS:
        r, a = ref_g[name], got_g[name].cpu()
        grad_rel[name] = ((a - r).abs().max() / r.abs().max()).item()
    (ref_cost, ref_cols), (_, got_cols) = ref_rec[0], got_rec[0]
    same_assign = bool(torch.equal(ref_cols, got_cols))
    cost_gap = 0.0
    if not same_assign:
        rows = torch.arange(ref_cost.shape[1])
        for c, a, b in zip(ref_cost.double(), got_cols, ref_cols):
            gap = abs(c[rows, a].sum() - c[rows, b].sum()).item()
            cost_gap = max(cost_gap, gap / max(abs(c[rows, b].sum().item()), 1e-30))
    emit({"phase": "train_kernels_vs_plain", "dtype": "float32", "tf32": False,
          "batch": [1, TRAIN_T, CHECK_TRAIN_H, CHECK_TRAIN_W], "targets": CHECK_TRAIN_N,
          "losses_kernel_plain": losses, "loss_rel_err": loss_rel,
          "grad_norm_kernel_plain": [got_norm, ref_norm],
          "grad_norm_rel_err": abs(got_norm - ref_norm) / ref_norm,
          "grad_max_err_rel_to_max": grad_rel, "assignments_equal": same_assign,
          "assignment_cost_rel_gap": cost_gap, "kernel_launches": launches,
          "cpu_seconds": cpu_s,
          "tol": {"loss_rtol": TRAIN_LOSS_RTOL, "grad_norm_rtol": TRAIN_GRAD_NORM_RTOL,
                  "grad_rel_to_max": TRAIN_GRAD_REL_TO_MAX,
                  "assignment_cost_rtol": HUNGARIAN_RTOL}})
    torch.backends.mkldnn.enabled = True
    if not (all(v <= TRAIN_LOSS_RTOL for v in loss_rel.values())
            and abs(got_norm - ref_norm) <= TRAIN_GRAD_NORM_RTOL * ref_norm
            and all(v <= TRAIN_GRAD_REL_TO_MAX for v in grad_rel.values())
            and cost_gap <= HUNGARIAN_RTOL):
        raise AssertionError("the kernel train step disagrees with the plain train step")
    if min(launches.values()) == 0:
        raise AssertionError(f"the card's train step skipped a kernel: {launches}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")
    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    phase_build()
    fields = {"msda_fwd": phase_msda(), "hungarian": phase_hungarian()}
    fields.update(phase_msda_bwd())
    fields.update(phase_sampler())
    eval_rec, train_rec = MsdaRecorder(), MsdaRecorder()
    eval_launches = phase_slice(card, eval_rec)
    phase_slice_vs_plain()
    train_launches = phase_train(card, train_rec)
    for name, extra in phase_msda_recorded(eval_rec, train_rec).items():
        fields[name].update(extra)
    phase_train_vs_plain()
    leaked = [m for m in ("jax", "openvis_tpu") if m in sys.modules]
    if leaked:
        raise AssertionError(f"the port imported {leaked}")
    meta = {
        "msda_fwd": ("msda_fwd.cu", "openvis_tpu/ops/msda_pallas.py:667"),
        "msda_dcoord": ("msda_bwd.cu", "openvis_tpu/ops/msda_pallas.py:1421"),
        "msda_dvalue": ("msda_bwd.cu", "openvis_tpu/ops/msda_pallas.py:1497"),
        "hungarian": ("hungarian.cu", "openvis_tpu/ops/hungarian_pallas.py:135"),
        "point_sample_fwd": ("point_sample.cu", "openvis_tpu/ops/point_sample_pallas.py:252"),
        "point_sample_dvalue": ("point_sample.cu", "openvis_tpu/ops/point_sample_pallas.py:317"),
    }
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": f"openvis_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": train_launches[name],
         "launches_by_path": {"eval": eval_launches[name], "train": train_launches[name]},
         "max_abs_err": fields[name]["max_abs_err"], "ms": fields[name]["ms"],
         "device_ms": fields[name]["device_ms"],
         "plain_ms": fields[name]["plain_ms"], "bound_ms": fields[name]["bound_ms"],
         "bound_by": fields[name]["bound_by"],
         "library_ms": fields[name].get("library_ms"),
         **{k: v for k, v in fields[name].items() if k.startswith("recorded_")}}
        for name, (src, replaces) in meta.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
