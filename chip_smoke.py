#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``openvis_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises (non-zero exit):

  0. device: refuses to run without CUDA; prints the card's name and power limit
  1. build: compiles the hand-written kernels from ``openvis_tpu_torch/csrc``,
     one ``nvcc`` per source, all at once; each kernel's registers, stack and
     spills from ptxas, and whether the K3/K6 and the K4/K5 instantiations
     are free of stack and spills
  2. K1 (MSDA forward) against ``ms_deform_attn_plain`` on the card, at the
     eval, above-the-TPU-gate, train and one-level shapes, with the
     instantiation each takes
  3. K4 (batched Hungarian) against scipy (total cost) and ``hungarian_plain``
     (the assignment, element for element) at the tracking and matcher
     shapes, with its plan, each problem's Dijkstra steps, and the wrapper's
     and the device's time per case
  4. K2 / K3 (MSDA backward) against the plain backward at the train, eval
     and one-level encoder shapes, f32 and bf16, on random locations (K3's
     direct adds for the big levels; the two small ones fit its bins whole),
     with K3's plan and the share of its corner adds binned in shared memory
  5. K5 / K6 (shared-point sampler and its dValue) against the plain sampler
     and its autograd at the three train shapes, bf16 and f32 maps, on
     y-sorted points (K6's shared-memory bins where its tiles are dense), the
     same shuffled (its direct adds) and y-sorted points on pixel centres and
     the map's borders, with K5's and K6's plans and the share binned, and
     ``F.grid_sample`` and its backward timed as yardsticks; K5's device time
     and bound at each of the three shapes (bf16 maps, sorted points); then
     K5 and K6 on points far outside the maps (beyond 2^31 pixels, infinite)
  6. the SimpleBaselineOnline-R50 eval path at full width (random weights from
     a seed, bf16): three 10x384x640 windows, with the kernels' launch counts;
     then K4 on the tracking costs of the warm-up window, held element for
     element to ``hungarian_plain`` and timed against the window (its share
     of the window)
  7. the same eval path in f32 on the card (kernels) against the CPU (plain)
  8. the train step at full width: 1x2x480x864, N=40, bf16 AMP with f32
     masters, AdamW; one warm-up and three timed steps, with the launch counts
     of all six kernels (K5's also by call shape, which must be phase 5's
     three), frozen parameters fixed and the encoder's sampling-offset
     weights moved
  8b. K1, K2 and K3 on the inputs the first encoder layer gave them in the
     warm-up window of phase 6 and the warm-up step of phase 8, against the
     plain versions, timed beside their bounds
  9. one f32 train-step loss and gradient on the card (kernels) against the
     CPU (plain) at 1x2x192x320, N=8, from the same weights and points
  10. the eval engine (``engine.evaluate_dataset``) over a synthetic dataset
     in the YTVIS-2019 format written to a temporary directory (36 frames at
     720x1280, 19 at 480x640, 133 at 360x640; moving rectangles), at full
     width with Config()'s eval settings (bf16 AMP, the whole video as one
     window of up to 128 frames): windows of 10 first (K4's results recorded),
     then the whole video, timed end to end with its split (mapper, model
     windows, tracking and top-k, resize and threshold, RLE, evaluation) and
     its peak memory; the K1/K4 launch counts; K4 held element for element to
     ``hungarian_plain`` on the engine's own tracking costs; the two runs
     against each other; then one short f32 video through the engine on the
     card (kernels) against the CPU (plain)
  11. the CLI (``train_net_torch.py``) at full width with the recipe
     ``configs/openvoc_ytvis_coco/simplebsl_online_R50_bs8_12000st.yaml``
     (bf16 AMP, 8 one-frame clips a step, 12544 points), the text bank
     replaced by seeded rows (the CLIP text tower is not ported): synthetic
     YTVIS (720x1280) and COCO (480x640) train sets mixed 1.0 : 0.75 and a
     small eval set, written to a temporary directory; (1) 6 steps from
     scratch with checkpoints at 3 and 6 (ms a step from CUDA events, the
     loader's wait, each save's ms and size, peak memory, the launches);
     (2) ``--resume`` from the step-3 checkpoint to 6, the restored state
     equal to the file bit for bit; (3) ``--eval-only --weights <checkpoints>``;
     then, on the API, 2 + 2 steps resumed against 4 on fixed batches (their
     update's distance beside a second uninterrupted run and two faulty
     resumes), with the first step's K1-K6 inputs held against the plain
     versions; one step of the global batch of 8 on 2 gloo processes (4
     clips each) against 1 process, in f32 and in bf16; and one step through
     ``--distributed`` under NCCL with a world of 1

The line before the last lists every kernel with its launches on the train
path (phase 8; ``launches_by_path`` adds the eval path of phase 6, the
engine's whole-video run of phase 10 and the CLI's training and eval runs of
phase 11), its error
against its plain version, its time (``ms``: the wrapper's call from CUDA
events; ``device_ms``: the kernel alone, from ``torch.profiler``), the plain
time, the yardstick library time where one PyTorch call computes the same
function, and its bound; the last line is ``{"ok": true, "device": {...}}``.
Imports no JAX.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import functools
import itertools
import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from openvis_tpu_torch import Config, engine, train
from openvis_tpu_torch.checkpoint import (
    latest_step,
    load_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from openvis_tpu_torch.config import load_config
from openvis_tpu_torch.convert import init_params
from openvis_tpu_torch.data import catalog, rle, synthetic
from openvis_tpu_torch.data.loader import TrainLoader
from openvis_tpu_torch.evals import ytvis_eval
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
    # the eval engine's whole-video window: 128 frames on the 480x864 canvas
    "engine_whole_video": (128, [(15, 27), (30, 54), (60, 108)]),
}
# the cases K1 meets in bf16 only (the engine runs its long windows under AMP)
MSDA_BF16_ONLY = ("engine_whole_video",)
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
# phase 10: the eval engine over a synthetic dataset in the YTVIS-2019 format
# (its 40 categories), with Config()'s eval settings (the whole video as one
# window of up to test.max_frames = 128 frames, bf16 AMP, min_size_test 360)
ENGINE_DATASET = "synthetic_ytvis_2019_val"
ENGINE_VIDEOS = (  # (height, width, frames, instances)
    (720, 1280, 36, 3),   # the common YTVIS-2019 val size and length
    (480, 640, 19, 2),
    (360, 640, 133, 1),   # longer than max_frames, as OVIS and LV-VIS videos are
)
ENGINE_WINDOW = 10        # the re-run with test.window_inference: windows of 10
# f32 card (kernels) against CPU (plain): one short video on a small canvas
# (min_size_test and pad_size cut to its size) in windows of 4, so that the
# CPU side stays short
ENGINE_CHECK_VIDEO = (192, 320, 7, 2)
ENGINE_CHECK_WINDOW = 4
# windows of 10 against the whole video, bf16, one card: cuDNN picks other
# algorithms at other batch sizes, and the scores are a softmax of 100 *
# cosine of near-tied random embeddings, so the bound is the port's bf16 one
# (tests/test_torch_port_slice.py): each video's sorted top-10 scores within
# 0.1; a prediction of both runs (same video, track and category) agrees on
# 98 % of its pixels in the frames where both runs' tracks follow the same
# query
ENGINE_BF16_SCORE_ATOL = 0.1
ENGINE_BF16_MASK_AGREE = 0.98
# f32 card vs CPU: phase 7's score bound; the masks are compared after the
# > 0 threshold, where only pixels with a logit near 0 may flip; one flipped
# pixel may move one match across one of the 10 IoU thresholds, which moves
# AP by at most 1 / (10 x the GT instances of its category) = 0.05
ENGINE_F32_SCORE_ATOL = SLICE_SCORE_ATOL
ENGINE_F32_MASK_AGREE = 0.999
ENGINE_F32_METRIC_ATOL = 0.05
# phase 11: the CLI with the recipe, on synthetic data in the YTVIS-2019
# taxonomy (40 categories): videos at YTVIS-2019's common 720x1280, COCO
# images at COCO's common 480x640
CLI_CONFIG = os.path.join("configs", "openvoc_ytvis_coco", "simplebsl_online_R50_bs8_12000st.yaml")
CLI_TRAIN_VIDEOS = tuple((720, 1280, 8, 1 + i % 3) for i in range(6))  # (h, w, frames, instances)
CLI_TRAIN_IMAGES = tuple((480, 640, 1 + i % 3) for i in range(8))      # (h, w, instances)
CLI_EVAL_VIDEOS = ((720, 1280, 6, 2), (480, 640, 5, 1))
CLI_MAX_ITER, CLI_PERIOD = 6, 3
# 2 + 2 steps resumed against 4 on the card, bf16 AMP: the distance of the
# final parameters over the norm of the uninterrupted run's update.  K3/K6's
# atomics are not deterministic, and Adam's first steps (+-lr where a
# gradient is near zero) amplify their roundings: two uninterrupted runs
# read 8.9-11.0 % apart on an H100, a resume with AdamW's mu zeroed 35.7-36.4 %
CLI_RESUME_UPDATE_DIFF = 0.2
# step 3 from the same restored state in both runs: the same parameters,
# batch and points; the mask losses differ only where a sum's order does
# (they were equal on an H100; 2.0e-3 and 4.9e-3 apart with the stream one
# step off)
CLI_RESUME_LOSS_RTOL = 1e-4
# one step of the global batch on 2 gloo processes (4 clips each) against 1
# process (8 clips) on the card, from the same weights and points.  f32 with
# TF32 off: the sums run in other orders (batch 4 against 8 in cuDNN and
# cuBLAS, the reduce, K3/K6's atomics), as phase 9's card-vs-CPU; bf16 AMP:
# other algorithms at another batch size round differently, and a near-tied
# matching cost can hand a target to another query (its mask and class
# gradients move with it)
DP_TOL = {"float32": {"loss_rtol": 1e-3, "grad_norm_rtol": 1e-3, "grad_diff_rel_norm": 1e-2},
          "bf16 AMP": {"loss_rtol": 2e-2, "grad_norm_rtol": 2e-2, "grad_diff_rel_norm": 0.1}}
DP_JOIN_S = 600


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
    k4_k5 = [k for name in ("hungarian", "point_sample") for k in ptxas.get(name, [])
             if "hungarian_" in k["kernel"] or "point_sample_fwd_kernel" in k["kernel"]]

    def clean(kernels):  # null where the libraries were built before this run
        if not kernels:
            return None
        return all(k.get("stack", 0) == 0 and k.get("spill_stores", 0) == 0 for k in kernels)

    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": {k: v[0] for k, v in cuda_build.build_logs.items()}, "ptxas": ptxas,
          "k3_k6_instantiations": len(scatter), "k3_k6_stack_and_spill_free": clean(scatter),
          "k4_k5_instantiations": len(k4_k5), "k4_k5_stack_and_spill_free": clean(k4_k5)})


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
        dtypes = (torch.bfloat16,) if case in MSDA_BF16_ONLY else (torch.float32, torch.bfloat16)
        for dtype in dtypes:
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


def _k4_plan(n, m, b):
    plan = hungarian_cuda.launch_plan(n, m)
    return {"variant": {hungarian_cuda.WARP: "warp", hungarian_cuda.BLOCK: "block"}[plan.variant],
            "blocks": b, "threads": plan.threads, "smem_bytes": plan.smem_bytes}


def phase_hungarian():
    """K4 against scipy (total cost) and the plain loop (the assignment,
    element for element: the kernel takes the same steps in the same f32
    arithmetic), timed per case; returns its JSON fields at the matcher's
    shape (one launch per train step), with every case's times under
    ``cases``."""
    rng = np.random.RandomState(SEED)
    worst, main, cases = 0.0, None, {}
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
        plain = [hungarian_plain(torch.from_numpy(cost[bi]), return_steps=True) for bi in range(b)]
        plain_ms = (time.perf_counter() - t0) * 1e3
        steps = [s for _, s in plain]
        differ = [bi for bi in range(b) if not np.array_equal(cols[bi], plain[bi][0].numpy())]
        t0 = time.perf_counter()
        for bi in range(b):
            linear_sum_assignment(cost[bi].astype(np.float64))
        scipy_ms = (time.perf_counter() - t0) * 1e3
        k_ms = time_cuda(lambda: hungarian_cuda.batched_hungarian_cuda(cost_dev))
        dev = device_ms(lambda: hungarian_cuda.batched_hungarian_cuda(cost_dev), "hungarian_")
        b_ms, b_by = bound(cost.nbytes + b * n * 8, 0.0)
        # the problems run side by side: the longest chain of steps sets the time
        ns_step = dev * 1e6 / max(steps)
        emit({"phase": "k4_hungarian", "case": name, "shape": [b, n, m], "plan": _k4_plan(n, m, b),
              "max_abs_cost_err_vs_scipy": max(errs), "rtol": HUNGARIAN_RTOL,
              "equal_to_plain": not differ, "problems_differing_from_plain": differ,
              "steps_per_problem": {"mean": float(np.mean(steps)), "max": max(steps)},
              "ns_per_step": ns_step, "kernel_ms": k_ms, "device_ms": dev,
              "plain_cpu_ms_per_batch": plain_ms, "scipy_cpu_ms_per_batch": scipy_ms,
              "bound_ms": b_ms})
        if differ:
            raise AssertionError(f"K4 {name}: problems {differ} differ from hungarian_plain")
        worst = max(worst, max(errs))
        cases[name] = {"ms": k_ms, "device_ms": dev, "bound_ms": b_ms, "steps_max": max(steps),
                       "ns_per_step": ns_step}
        if name == "matcher_uniform":
            main = {"ms": k_ms, "device_ms": dev, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by}
    return {"max_abs_err": worst, **main, "cases": cases}


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


class SamplerShapes:
    """Wraps the K5 wrapper for one run of a path and counts its launches by
    call shape (B, R, H, W, P)."""

    def __enter__(self):
        self.counts = collections.Counter()
        self._k5 = point_sample_cuda.point_sample_fwd_cuda

        def k5(maps, coords):
            out = self._k5(maps, coords)
            self.counts[(*maps.shape, coords.shape[1])] += 1
            return out

        point_sample_cuda.point_sample_fwd_cuda = k5
        return self

    def __exit__(self, *exc):
        point_sample_cuda.point_sample_fwd_cuda = self._k5


class SamplerInputs:
    """Wraps the K5 and K6 wrappers for one run of a path and keeps host
    copies of the first call's inputs of each call shape: K5's (maps,
    coords) by (B, R, H, W, P), K6's (coords, grad, maps' shape and dtype)
    by (B, R, H, W, P)."""

    def __enter__(self):
        self.fwd, self.dvalue = {}, {}
        self._k5, self._k6 = (point_sample_cuda.point_sample_fwd_cuda,
                              point_sample_cuda.point_sample_dvalue_cuda)

        def k5(maps, coords):
            self.fwd.setdefault((*maps.shape, coords.shape[1]), (maps.cpu(), coords.cpu()))
            return self._k5(maps, coords)

        def k6(coords, grad, map_shape, map_dtype):
            self.dvalue.setdefault((*map_shape, coords.shape[1]),
                                   (coords.cpu(), grad.cpu(), tuple(map_shape), map_dtype))
            return self._k6(coords, grad, map_shape, map_dtype)

        point_sample_cuda.point_sample_fwd_cuda, point_sample_cuda.point_sample_dvalue_cuda = k5, k6
        return self

    def __exit__(self, *exc):
        point_sample_cuda.point_sample_fwd_cuda, point_sample_cuda.point_sample_dvalue_cuda = (
            self._k5, self._k6)


class HungarianRecorder:
    """Wraps the K4 wrapper for one run of a path and keeps host copies of
    every cost it is given and of the kernel's assignment of each."""

    def __enter__(self):
        self.costs, self.cols = [], []
        self._k4 = hungarian_cuda.batched_hungarian_cuda

        def k4(cost):
            cols = self._k4(cost)
            self.costs.append(cost.cpu())
            self.cols.append(cols.cpu())
            return cols

        hungarian_cuda.batched_hungarian_cuda = k4
        return self

    def __exit__(self, *exc):
        hungarian_cuda.batched_hungarian_cuda = self._k4


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


def _hold_k1(path: str, rec: MsdaRecorder) -> float:
    """K1 on the first encoder layer's inputs recorded on ``path`` against
    the plain version with phase 2's tolerance; returns its time."""
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
    return k_ms


def _hold_k2_k3(path: str, rec: MsdaRecorder):
    """K2 and K3 on the first encoder layer's backward inputs recorded on
    ``path`` (K3 takes K2's inputs) against the plain backward with phase
    4's tolerances; returns (K2 ms, K3 ms, K3 device ms)."""
    (value, levels, loc, attn, g), plan = rec.dcoord
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
    emit({"phase": "k2_k3_recorded_inputs", "path": path, "layer": 0,
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
        raise AssertionError(f"K2/K3 disagree with the plain backward on the {path} inputs")
    return k2_ms, k3_ms, k3_dev


def phase_msda_recorded(eval_rec: MsdaRecorder, train_rec: MsdaRecorder):
    """K1, K2 and K3 on the inputs the first encoder layer gave them on the
    paths (phases 6 and 8: a full-width eval window and train step), against
    the plain versions, timed beside their bounds; returns the kernels
    line's recorded-input times."""
    out = {"msda_fwd": {f"recorded_{path}_ms": _hold_k1(path, rec)
                        for path, rec in (("eval", eval_rec), ("train", train_rec))}}
    k2_ms, k3_ms, k3_dev = _hold_k2_k3("train", train_rec)
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
            k5_plan = point_sample_cuda.fwd_plan(maps.shape, p)
            x = coords[..., 0] * w - 0.5
            y = coords[..., 1] * h - 0.5
            inside = int(((x > -1) & (y > -1) & (x < w) & (y < h)).sum()) * r
            k5_b = bound(nbytes(maps, coords, got), 12.0 * inside)
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
                  "k5_plan": {**dataclasses.asdict(k5_plan), "grid": k5_plan.grid(b, r, p)},
                  "k6_plan": dataclasses.asdict(plan), "k6_band_share": share,
                  "k5_ms": k5_ms, "k5_bound_ms": k5_b[0], "k5_bound_by": k5_b[1],
                  "k6_ms": k6_ms, "k5_plain_ms": k5_plain,
                  "k6_plain_ms": k6_plain, "grid_sample_ms": lib_fwd,
                  "grid_sample_backward_ms": lib_bwd_ms})
            if not (fwd[0] and bwd[0]):
                raise AssertionError(f"K5/K6 disagree with the plain sampler ({case}, {kind}, {dtype})")
            out["point_sample_fwd"]["max_abs_err"] = max(out["point_sample_fwd"]["max_abs_err"], fwd[1])
            out["point_sample_dvalue"]["max_abs_err"] = max(
                out["point_sample_dvalue"]["max_abs_err"], bwd[1])
            if kind == "sorted" and dtype == torch.bfloat16:
                # the train step's calls at this shape (launches: phase 8)
                k5_dev = device_ms(lambda: point_sample_cuda.point_sample_fwd_cuda(maps, coords),
                                   "point_sample_fwd_kernel")
                out["point_sample_fwd"].setdefault("cases", {})[case] = {
                    "ms": k5_ms, "device_ms": k5_dev, "plain_ms": k5_plain, "library_ms": lib_fwd,
                    "bound_ms": k5_b[0], "bound_by": k5_b[1]}
                emit({"phase": "k5_device_time", "case": case, "maps": [b, r, h, w], "points": p,
                      "dtype": "bfloat16", "points_order": kind, "k5_ms": k5_ms,
                      "k5_device_ms": k5_dev, "k5_bound_ms": k5_b[0], "grid_sample_ms": lib_fwd})
            if case == "loss_candidates" and kind == "sorted" and dtype == torch.bfloat16:
                k6_b = bound(nbytes(coords, g, dgot), 8.0 * inside)
                k6_dev = device_ms(lambda: point_sample_cuda.point_sample_dvalue_cuda(
                    coords, g, maps.shape, maps.dtype), "point_sample_dvalue_kernel")
                out["point_sample_fwd"].update(ms=k5_ms, device_ms=k5_dev, plain_ms=k5_plain,
                                               library_ms=lib_fwd, bound_ms=k5_b[0],
                                               bound_by=k5_b[1])
                out["point_sample_dvalue"].update(ms=k6_ms, device_ms=k6_dev, plain_ms=k6_plain,
                                                  library_ms=lib_bwd_ms, bound_ms=k6_b[0],
                                                  bound_by=k6_b[1])
    _sampler_far_points(gen)
    return out


def _sampler_far_points(gen):
    """K5 and K6 on points far outside the maps, up to 2^31 pixels and
    beyond (where a float-to-int conversion saturates) in x, y or both,
    against the plain sampler; and K5 on infinite coordinates, whose samples
    are 0 (the plain version's are NaN: inf - inf in its weights), the other
    points' samples unchanged.  A corner offset that overflows faults the
    launch."""
    b, r, h, w, p = SAMPLER_CASES["loss_random"]
    far = torch.tensor([1e8, -1e8, 3e9, -3e9, 2.0 ** 31 / w, -(2.0 ** 31) / w, 1.5, -0.5],
                       device=DEVICE)
    n = far.numel()
    coords = sorted_uniform_points(gen, (b,), p)
    coords[:, :n, 0] = far
    coords[:, n:2 * n, 1] = far
    coords[:, 2 * n:3 * n, 0] = far
    coords[:, 2 * n:3 * n, 1] = far.flip(0)
    inf = float("inf")
    coords_inf = coords.clone()
    coords_inf[:, :4] = torch.tensor([[inf, 0.5], [-inf, 0.5], [0.5, inf], [0.5, -inf]],
                                     device=DEVICE)
    for dtype in (torch.bfloat16, torch.float32):
        maps = (torch.randn(b, r, h, w, device=DEVICE, generator=gen) * 4).to(dtype)
        g = torch.randn(b, r, p, device=DEVICE, generator=gen)
        got = point_sample_cuda.point_sample_fwd_cuda(maps, coords)
        dgot = point_sample_cuda.point_sample_dvalue_cuda(coords, g, maps.shape, maps.dtype)
        got_inf = point_sample_cuda.point_sample_fwd_cuda(maps, coords_inf)
        torch.cuda.synchronize()
        fwd = _check_close(got, sample_maps_shared_plain(maps, coords, f32_policy=True),
                           SAMPLER_REL_TO_MAX, SAMPLER_RTOL)
        bwd = _check_close(dgot, sample_maps_dvalue_plain(maps, coords, g),
                           BWD_REL_TO_MAX, BWD_RTOL[dtype])
        inf_zero = bool((got_inf[..., :4] == 0).all())
        inf_rest = bool(torch.equal(got_inf[..., 4:], got[..., 4:]))
        far_zero = bool((got[..., :3 * n] == 0).all())
        emit({"phase": "k5_k6_far_points", "maps": [b, r, h, w], "points": p,
              "far_points": 3 * n, "dtype": str(dtype).replace("torch.", ""),
              "k5": {"within_tol": fwd[0], "max_abs_err": fwd[1]},
              "k6": {"within_tol": bwd[0], "max_abs_err": bwd[1]},
              "k5_far_samples_zero": far_zero, "k5_infinite_samples_zero": inf_zero,
              "k5_other_samples_unchanged_by_infinite": inf_rest})
        if not (fwd[0] and bwd[0] and far_zero and inf_zero and inf_rest):
            raise AssertionError(f"K5/K6 on far points disagree with the plain sampler ({dtype})")


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

    with rec, HungarianRecorder() as tracking:
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
    # K4 on the window's own tracking costs (near-ties with random weights)
    cost = tracking.costs[0].to(DEVICE)
    k4_ms = time_cuda(lambda: hungarian_cuda.batched_hungarian_cuda(cost))
    k4_dev = device_ms(lambda: hungarian_cuda.batched_hungarian_cuda(cost), "hungarian_")
    plain = [hungarian_plain(c, return_steps=True) for c in tracking.costs[0]]
    steps = [s for _, s in plain]
    cols = hungarian_cuda.batched_hungarian_cuda(cost).cpu()
    differ = [i for i, (c, _) in enumerate(plain) if cols[i].tolist() != c.tolist()]
    emit({"phase": "k4_in_the_window", "shape": list(cost.shape), "kernel_ms": k4_ms,
          "device_ms": k4_dev, "steps_per_problem": {"mean": float(np.mean(steps)),
                                                     "max": max(steps)},
          "equal_to_plain": not differ, "problems_differing_from_plain": differ,
          "ms_per_window": ms / NUM_WINDOWS, "device_share_of_window": k4_dev / (ms / NUM_WINDOWS),
          "card": card})
    if differ:
        raise AssertionError(f"K4 on the window's costs: problems {differ} differ from "
                             "hungarian_plain")
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
    with SamplerShapes() as shapes:
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
    # K5 by call shape: the matcher's and the two loss point sets' samplings
    by_shape = {case: shapes.counts.pop(shape, 0) for case, shape in SAMPLER_CASES.items()}
    other_shapes = {str(k): v for k, v in shapes.counts.items()}
    values = [{k: float(v) for k, v in m.items()} for m in metrics]
    frozen_fixed = all(torch.equal(p, b) for p, b in zip(frozen_params, frozen_before))
    offsets_moved = not torch.equal(offsets.detach(), offsets_before)
    emit({"phase": "train_full_width", "dtype": "bf16 AMP, f32 masters",
          "batch": [1, TRAIN_T, TRAIN_H, TRAIN_W], "targets": TRAIN_N,
          "points": cfg.model.criterion.train_num_points, "steps": TRAIN_STEPS,
          "ms_per_step": ms, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "metrics": values, "launches": launches, "expected_launches": expected,
          "k5_launches_by_shape": by_shape, "k5_launches_at_other_shapes": other_shapes,
          "frozen_affine_params": len(frozen_params), "frozen_fixed": frozen_fixed,
          "encoder_sampling_offsets_moved": offsets_moved, "card": card})
    if launches != expected:
        raise AssertionError(f"train-step kernel launches {launches} != {expected}")
    if other_shapes or min(by_shape.values()) == 0:
        raise AssertionError(f"K5's train-step shapes {by_shape}, others {other_shapes}, are "
                             f"not phase 5's {SAMPLER_CASES}")
    if not all(np.isfinite(v) for m in values for v in m.values()):
        raise AssertionError("a train-step loss or grad norm is not finite")
    if not frozen_fixed:
        raise AssertionError("a frozen FrozenAffine parameter changed")
    if not offsets_moved:
        raise AssertionError("the encoder's sampling offsets did not move: MSDA lost its gradient")
    return launches, by_shape


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


class EngineSpans:
    """Wraps the eval engine's stages for one ``evaluate_dataset`` run: host
    seconds of the mapper (``data``), of the evaluator's ``process`` and, in
    it, of resize + threshold + the masks' copy (``threshold``) and of the RLE
    encoding (``rle``), and of ``_finalize``; CUDA events around each model
    window and around tracking + top-k (device time); the frames; and each
    prediction with the track (frame-0 query) it came from and each video's
    track indices (T, Q), left on the device until ``track_indices``."""

    PATCHED = ((engine, "test_videos"), (engine, "make_window_fn"),
               (engine, "make_postprocess_fn"), (engine, "_finalize"),
               (ytvis_eval, "threshold_masks"), (rle, "encode_transposed"),
               (ytvis_eval.YTVISEvaluator, "process"), (engine, "track_by_embeds"))

    def __enter__(self):
        self.host = collections.Counter()
        self.events = {"windows": [], "tracking_topk": []}
        self.frames, self.preds = 0, []   # preds: (video, track, category, score, segs)
        self._tracks = []
        self._orig = [getattr(obj, name) for obj, name in self.PATCHED]
        videos, window_fn, post_fn, finalize, threshold, encode, process, track = self._orig

        def host_timed(key, fn):
            def timed(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.host[key] += time.perf_counter() - t0
            return timed

        def event_timed(key, make):
            def made(*args):
                fn = make(*args)

                def timed(*a):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = fn(*a)
                    end.record()
                    self.events[key].append((start, end))
                    return out
                return timed
            return made

        def test_videos(*args):
            items = videos(*args)
            while True:
                t0 = time.perf_counter()
                try:
                    rec, sample = next(items)
                except StopIteration:
                    return
                finally:
                    self.host["data"] += time.perf_counter() - t0
                self.frames += sample["pixels"].shape[0]
                yield rec, sample

        def record_process(ev, video_id, topk_out, *args, **kwargs):
            n0 = len(ev.predictions)
            host_timed("process", process)(ev, video_id, topk_out, *args, **kwargs)
            kept = [q for q, sc in zip(topk_out["query_idx"].tolist(),
                                       topk_out["scores"].float().tolist())
                    if sc > ev.score_threshold]
            for q, pred in zip(kept, ev.predictions[n0:]):
                self.preds.append((video_id, q, pred["category_id"], pred["score"],
                                   pred["segmentations"]))

        def record_track(embeds, *args, **kwargs):
            indices = track(embeds, *args, **kwargs)
            self._tracks.append(indices[0])
            return indices

        patches = (test_videos, event_timed("windows", window_fn),
                   event_timed("tracking_topk", post_fn), host_timed("finalize", finalize),
                   host_timed("threshold", threshold), host_timed("rle", encode),
                   record_process, record_track)
        for (obj, name), fn in zip(self.PATCHED, patches):
            setattr(obj, name, fn)
        return self

    def __exit__(self, *exc):
        for (obj, name), fn in zip(self.PATCHED, self._orig):
            setattr(obj, name, fn)

    def device_seconds(self, key) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events[key]) / 1e3

    def track_indices(self):
        """Each video's (T, Q) track indices on the host, in video order."""
        return [t.cpu() for t in self._tracks]


def _one_thread():
    torch.set_num_threads(1)


def _plain_assignments(costs):
    """``hungarian_plain`` of every problem of ``costs`` (a list of (B, N, M)),
    with its Dijkstra steps: one problem is a long chain of small torch
    operations, so the problems go to a pool of processes, one a core."""
    problems = [c for cost in costs for c in cost]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1), mp_context=ctx,
                             initializer=_one_thread) as pool:
        return list(pool.map(functools.partial(hungarian_plain, return_steps=True), problems,
                             chunksize=4))


def _engine_config(root, **test):
    cfg = _full_config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, test=dataclasses.replace(cfg.model.test, **test)),
        datasets=dataclasses.replace(cfg.datasets, root=root, test=(ENGINE_DATASET,)),
        output_dir=os.path.join(root, "out"))


def _masks_agree(a, b) -> float:
    ma = np.stack([rle.decode(x) for x in a])
    mb = np.stack([rle.decode(x) for x in b])
    return float((ma == mb).mean())


def _engine_run(cfg, model, text, device):
    """One evaluate_dataset over the registered ENGINE_DATASET: (metrics,
    spans, wall seconds, launches)."""
    reset_counts()
    with EngineSpans() as spans:
        t0 = time.perf_counter()
        metrics = engine.evaluate_dataset(cfg, model, ENGINE_DATASET, text, device=device)
        wall = time.perf_counter() - t0
    return metrics, spans, wall, read_counts()


def phase_engine(card: str):
    """The eval engine over a synthetic YTVIS-2019-format dataset at full
    width, bf16 AMP: windows of 10 (K4 recorded), then the whole video as in
    Config() (timed, with its split); K4 on the engine's own tracking costs
    against hungarian_plain; the two runs against each other; then a small f32
    run on the card against the CPU.  Returns the launch counts of the
    whole-video run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = tempfile.mkdtemp(prefix="chip_smoke_engine_")
    try:
        ytvis19 = catalog.get("ytvis_2019_val")
        cats = [{"id": cid, "name": ytvis19.thing_classes[i]} for cid, i in ytvis19.id_map.items()]
        t0 = time.perf_counter()
        catalog.register(dataclasses.replace(
            synthetic.write_ytvis_dataset(root, "synth", ENGINE_VIDEOS, cats, seed=SEED),
            name=ENGINE_DATASET))
        write_s = time.perf_counter() - t0
        cfg = _engine_config(root)
        windowed = _engine_config(root, window_inference=True, window_size=ENGINE_WINDOW)
        model = init_params(train.build_model(cfg, device=DEVICE), seed=SEED)
        masters = {n: p.detach().clone() for n, p in model.named_parameters()}
        text = _text(np.random.RandomState(SEED))

        with HungarianRecorder() as tracking:
            met_w, spans_w, wall_w, launches_w = _engine_run(windowed, model, text, DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics, spans, wall, launches = _engine_run(cfg, model, text, DEVICE)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        masters_kept = all(torch.equal(p, masters[n]) for n, p in model.named_parameters())
        del masters

        max_frames = cfg.model.test.max_frames
        enc = cfg.model.pixel_decoder.transformer_enc_layers
        zero = {k: 0 for k in launches}
        expected = {**zero, "msda_fwd": enc * sum(-(-t // max_frames) for _, _, t, _ in ENGINE_VIDEOS),
                    "hungarian": sum(t > 1 for _, _, t, _ in ENGINE_VIDEOS)}
        expected_w = {**expected,
                      "msda_fwd": enc * sum(-(-t // ENGINE_WINDOW) for _, _, t, _ in ENGINE_VIDEOS)}
        data, process = spans.host["data"], spans.host["process"]
        split = {
            "data_mapper_host": data,
            "model_windows_device": spans.device_seconds("windows"),
            "tracking_topk_device": spans.device_seconds("tracking_topk"),
            "process_host": process,
            "resize_threshold_copy_host": spans.host["threshold"],
            "rle_host": spans.host["rle"],
            "wait_for_topk_host": process - spans.host["threshold"] - spans.host["rle"],
            "finalize_evaluate_host": spans.host["finalize"],
            "other_host": wall - data - process - spans.host["finalize"],
        }
        finite = all(np.isfinite(v) for v in metrics.values())
        emit({"phase": "engine_full_width", "dataset": "synthetic YTVIS-2019 format, 40 classes",
              "videos_hwtn": ENGINE_VIDEOS, "dtype": "bf16 AMP", "window": max_frames,
              "metrics": metrics, "metrics_finite": finite, "predictions": len(spans.preds),
              "launches": launches, "expected_launches": expected,
              "frames": spans.frames, "wall_s": wall, "frames_per_s": spans.frames / wall,
              "split_s": split, "peak_mem_gib": peak, "callers_f32_params_unchanged": masters_kept,
              "windowed_run": {"window": ENGINE_WINDOW, "wall_s": wall_w,
                               "frames_per_s": spans_w.frames / wall_w,
                               "launches": launches_w, "expected_launches": expected_w},
              "dataset_write_s": write_s, "card": card})
        if launches != expected or launches_w != expected_w:
            raise AssertionError(f"engine launches {launches}, {launches_w} != "
                                 f"{expected}, {expected_w}")
        if not finite or set(metrics) < {"AP", "AP50", "AR10"} or not spans.preds:
            raise AssertionError(f"engine metrics {metrics}, {len(spans.preds)} predictions")
        if not masters_kept:
            raise AssertionError("evaluate_dataset changed the caller's f32 parameters")

        # K4 on the engine's own tracking costs, one launch per video
        t0 = time.perf_counter()
        plain = _plain_assignments(tracking.costs)
        plain_s = time.perf_counter() - t0
        cols = [c for cost_cols in tracking.cols for c in cost_cols]
        differ = [i for i, ((ref, _), got) in enumerate(zip(plain, cols))
                  if not torch.equal(ref, got)]
        steps = [n for _, n in plain]
        # windows of 10 against the whole video: the sorted scores of each
        # video, and the masks of the predictions of both runs on the frames
        # where both runs' tracks follow the same query (near-tied tracking
        # costs let a bf16 rounding hand a track to another query)
        score_gap, agree, agree_all, same_frames, frames = 0.0, [], [], 0, 0
        whole = {(v, q, c): segs for v, q, c, _, segs in spans.preds}
        tracks_w, tracks_v = spans_w.track_indices(), spans.track_indices()
        for vid in range(1, len(ENGINE_VIDEOS) + 1):
            a = sorted(sc for v, _, _, sc, _ in spans_w.preds if v == vid)
            b = sorted(sc for v, _, _, sc, _ in spans.preds if v == vid)
            if len(a) != len(b):
                raise AssertionError(f"video {vid}: {len(a)} windowed, {len(b)} whole predictions")
            score_gap = max([score_gap] + [abs(x - y) for x, y in zip(a, b)])
        for v, q, c, _, segs in spans_w.preds:
            if (v, q, c) not in whole:
                continue
            same = (tracks_w[v - 1][:, q] == tracks_v[v - 1][:, q]).numpy()
            ma = np.stack([rle.decode(x) for x in segs])
            mb = np.stack([rle.decode(x) for x in whole[(v, q, c)]])
            agree_all.append(float((ma == mb).mean()))
            frames += len(same)
            same_frames += int(same.sum())
            if same.any():
                agree.append(float((ma[same] == mb[same]).mean()))
        emit({"phase": "engine_checks", "k4_batches": [list(c.shape) for c in tracking.costs],
              "k4_equal_to_plain": not differ, "k4_problems_differing": differ,
              "k4_steps_per_problem": {"mean": float(np.mean(steps)), "max": max(steps)},
              "k4_plain_seconds": plain_s,
              "windowed_vs_whole": {"max_sorted_score_gap": score_gap,
                                    "common_predictions": len(agree_all),
                                    "frames_on_the_same_query": [same_frames, frames],
                                    "min_mask_agreement_same_query": min(agree, default=None),
                                    "min_mask_agreement_all_frames": min(agree_all, default=None),
                                    "metrics_windowed": met_w},
              "tol": {"score_atol": ENGINE_BF16_SCORE_ATOL, "mask_agree": ENGINE_BF16_MASK_AGREE}})
        if differ or len(tracking.costs) != expected["hungarian"]:
            raise AssertionError(f"K4 on the engine's costs differs from hungarian_plain: {differ}")
        if score_gap > ENGINE_BF16_SCORE_ATOL or not agree or min(agree) < ENGINE_BF16_MASK_AGREE:
            raise AssertionError("the windowed and the whole-video runs disagree")
        del model
        phase_engine_vs_plain(root, cats)
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_engine_vs_plain(root, cats):
    """One short f32 video through the engine on the card (kernels) and on
    the CPU (plain), from one model."""
    name = ENGINE_DATASET + "_check"
    catalog.register(dataclasses.replace(
        synthetic.write_ytvis_dataset(root, "check", [ENGINE_CHECK_VIDEO], cats, seed=SEED + 3),
        name=name))
    h, w = ENGINE_CHECK_VIDEO[:2]
    base = _engine_config(root, window_inference=True, window_size=ENGINE_CHECK_WINDOW, amp=False)
    base = dataclasses.replace(
        base, input=dataclasses.replace(base.input, min_size_test=h, pad_size=(h, w)),
        datasets=dataclasses.replace(base.datasets, test=(name,)))
    model = init_params(train.build_model(base, device="cpu"), seed=SEED + 3)
    text = _text(np.random.RandomState(SEED + 3))
    runs = {}
    for device in ("cpu", DEVICE):
        cfg = dataclasses.replace(base, output_dir=os.path.join(root, f"check_{device}"))
        reset_counts()
        t0 = time.perf_counter()
        metrics = engine.evaluate_dataset(cfg, model, name, text, device=device)
        seconds = time.perf_counter() - t0
        with open(os.path.join(cfg.output_dir, f"results_{name}.json")) as f:
            runs[device] = (metrics, json.load(f), seconds, read_counts())
    (m_ref, p_ref, s_ref, _), (m_got, p_got, s_got, launches) = runs["cpu"], runs[DEVICE]
    same = [(p["category_id"]) for p in p_got] == [(p["category_id"]) for p in p_ref]
    score_err = max((abs(a["score"] - b["score"]) for a, b in zip(p_got, p_ref)), default=0.0)
    agree = min((_masks_agree(a["segmentations"], b["segmentations"])
                 for a, b in zip(p_got, p_ref)), default=1.0)
    metric_err = max(abs(m_got[k] - m_ref[k]) for k in m_ref)
    emit({"phase": "engine_kernels_vs_plain", "dtype": "float32", "tf32": False,
          "video_hwtn": ENGINE_CHECK_VIDEO, "window": ENGINE_CHECK_WINDOW,
          "predictions": [len(p_got), len(p_ref)], "categories_equal": same,
          "max_abs_score_err": score_err, "min_mask_agreement": agree,
          "max_abs_metric_err": metric_err, "metrics_kernel": m_got, "metrics_plain": m_ref,
          "kernel_launches": launches, "seconds_card_cpu": [s_got, s_ref],
          "tol": {"score_atol": ENGINE_F32_SCORE_ATOL, "mask_agree": ENGINE_F32_MASK_AGREE,
                  "metric_atol": ENGINE_F32_METRIC_ATOL}})
    if not (same and len(p_got) == len(p_ref) and score_err <= ENGINE_F32_SCORE_ATOL
            and agree >= ENGINE_F32_MASK_AGREE and metric_err <= ENGINE_F32_METRIC_ATOL):
        raise AssertionError("the engine on the card disagrees with the engine on the CPU")
    if launches["msda_fwd"] == 0 or launches["hungarian"] == 0:
        raise AssertionError(f"the card's engine run skipped a kernel: {launches}")


class _TextBank:
    """Seeded unit rows in place of the CLIP text bank (not ported yet)."""

    def encode(self, names):
        rng = np.random.RandomState(SEED + len(names))
        text = rng.randn(len(names), TEXT_DIM).astype(np.float32)
        return text / np.linalg.norm(text, axis=-1, keepdims=True)


def _cli_data(root):
    """The synthetic train and eval sets, registered; returns the config
    overrides that point the recipe at them."""
    ytvis19 = catalog.get("ytvis_2019_val")
    cats = [{"id": cid, "name": ytvis19.thing_classes[i]} for cid, i in ytvis19.id_map.items()]
    names = ("synthetic_ytvis_2019_train", "synthetic_coco_train", "synthetic_ytvis_2019_eval")
    infos = (
        dataclasses.replace(synthetic.write_ytvis_dataset(root, "ytvis_train", CLI_TRAIN_VIDEOS,
                                                          cats, seed=SEED), eval_type="none"),
        synthetic.write_coco_dataset(root, "coco_train", CLI_TRAIN_IMAGES, cats, seed=SEED + 1),
        synthetic.write_ytvis_dataset(root, "ytvis_eval", CLI_EVAL_VIDEOS, cats, seed=SEED + 2),
    )
    for name, info in zip(names, infos):
        catalog.register(dataclasses.replace(info, name=name))
    return [f"datasets.root={root}", f"datasets.train=[{names[0]},{names[1]}]",
            f"datasets.test=[{names[2]}]", f"solver.max_iter={CLI_MAX_ITER}",
            f"solver.checkpoint_period={CLI_PERIOD}", "model.clip_adapter.clip_ensemble=false"]


def _metrics_lines(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(x) for x in f]


def _state_copy(state):
    """A CPU copy of a TrainState's state dict."""
    sd = state.state_dict()
    return {k: ({n: t.cpu().clone() for n, t in v.items()} if isinstance(v, dict) else v)
            for k, v in sd.items()}


def _states_equal(a, b) -> bool:
    return (a["step"] == b["step"] and a["count"] == b["count"]
            and all(set(a[k]) == set(b[k]) and all(torch.equal(a[k][n], b[k][n]) for n in a[k])
                    for k in ("params", "mu", "nu")))


def _to_device(batch, device):
    t = batch["targets"]
    return {"pixels": batch["pixels"].to(device), "targets": t.to(device),
            "text_feats": batch["text_feats"].to(device)}


def _trace_busy(path):
    """Device events of a ``torch.profiler`` Chrome trace: how many, and the
    share of the span from the first to the last in which one runs."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not spans:
        raise AssertionError(f"the trace {path} holds no device events")
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = end - spans[0][0]
    return {"device_events": len(spans), "device_busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "device_busy_share": busy / span}


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_cli(card: str):
    """The CLI at full width: train, resume, eval; then the resume, the
    2-process and the NCCL checks.  Returns the launch counts of the train
    run (1) and of the eval run (3), and the recorded-input kernel times."""
    import train_net_torch as cli

    # PyTorch's defaults, as a user runs the CLI (earlier phases switch TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    saves, restored = [], []
    orig = cli.build_text_bank, cli.save_checkpoint, cli.restore_checkpoint

    def timed_save(directory, step, state):
        t0 = time.perf_counter()
        path = orig[1](directory, step, state)
        saves.append({"step": step, "ms": (time.perf_counter() - t0) * 1e3,
                      "bytes": os.path.getsize(path)})
        return path

    def recorded_restore(src, state):
        out = orig[2](src, state)
        if out is not None:
            restored.append(_state_copy(state))
            restored[-1]["lr_next"] = state.opt.lr(state.opt.count)
        return out

    cli.build_text_bank = lambda cfg: _TextBank()
    cli.save_checkpoint, cli.restore_checkpoint = timed_save, recorded_restore
    try:
        t0 = time.perf_counter()
        common = _cli_data(root)
        write_s = time.perf_counter() - t0
        emit({"phase": "cli_setup", "config": CLI_CONFIG, "overrides": common + ["output_dir=..."],
              "train_videos_hwtn": CLI_TRAIN_VIDEOS, "train_images_hwn": CLI_TRAIN_IMAGES,
              "eval_videos_hwtn": CLI_EVAL_VIDEOS, "dataset_write_s": write_s})

        def run(out, *flags, extra=()):
            reset_counts()
            t0 = time.perf_counter()
            cli.main(["--config-file", CLI_CONFIG, *flags, *common, f"output_dir={out}", *extra])
            torch.cuda.synchronize()
            return time.perf_counter() - t0, read_counts()

        # 1. from scratch
        out = os.path.join(root, "out")
        torch.cuda.reset_peak_memory_stats()
        wall, launches = run(out)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        lines = _metrics_lines(out)
        cfg = load_config(CLI_CONFIG, common)
        layers = cfg.model.transformer_decoder.dec_layers + 1
        enc = cfg.model.pixel_decoder.transformer_enc_layers
        h, w = cfg.input.pad_size
        target_samplings = 3 if h * w <= KERNEL_MAX_HW else 0
        per_step = {"msda_fwd": enc, "msda_dcoord": enc, "msda_dvalue": enc, "hungarian": 1,
                    "point_sample_fwd": (3 + target_samplings) * layers,
                    "point_sample_dvalue": 2 * layers}
        expected = {k: v * CLI_MAX_ITER for k, v in per_step.items()}
        ckpt_dir = os.path.join(out, "checkpoints")
        steps_ms = [r["step_s"] * 1e3 for r in lines]
        waits_ms = [r["data_wait_s"] * 1e3 for r in lines]
        finite = all(np.isfinite(r[k]) for r in lines
                     for k in ("total_loss", "loss_ce", "loss_mask", "loss_dice", "grad_norm"))
        emit({"phase": "cli_train", "batch": [cfg.solver.ims_per_batch,
                                              cfg.input.sampling_frame_num],
              "points": cfg.model.criterion.train_num_points, "amp": cfg.solver.amp,
              "steps": [r["step"] for r in lines], "ms_per_step": steps_ms,
              "ms_per_step_after_first": float(np.mean(steps_ms[1:])),
              "loader_wait_ms": waits_ms,
              "loader_wait_ms_after_first": float(np.mean(waits_ms[1:])),
              "losses": [r["total_loss"] for r in lines],
              "grad_norms": [r["grad_norm"] for r in lines],
              "checkpoint_saves": saves, "checkpoints": sorted(os.listdir(ckpt_dir)),
              "peak_mem_gib": peak, "wall_s": wall, "launches": launches,
              "expected_launches": expected, "card": card})
        if launches != expected:
            raise AssertionError(f"CLI train launches {launches} != {expected}")
        if [r["step"] for r in lines] != list(range(1, CLI_MAX_ITER + 1)) or not finite:
            raise AssertionError("the CLI's metrics.jsonl is not 6 finite steps")
        if sorted(s["step"] for s in saves) != [CLI_PERIOD, CLI_MAX_ITER]:
            raise AssertionError(f"checkpoints saved at {saves}")
        train_launches = launches

        # 2. --resume from the step-3 checkpoint
        src = os.path.join(root, "resume_from")
        os.makedirs(src)
        ckpt3 = os.path.join(ckpt_dir, f"ckpt_{CLI_PERIOD:08d}.pt")
        shutil.copy(ckpt3, src)
        out2 = os.path.join(root, "out_resume")
        traces = os.path.join(root, "trace")
        # --profile-dir traces steps 4-6 (a run of under 14 steps traces its first 3)
        wall2, launches2 = run(out2, "--resume", "--weights", src, "--profile-dir", traces)
        lines2 = _metrics_lines(out2)
        busy = _trace_busy(os.path.join(traces, "trace_rank0.json"))
        file3 = load_checkpoint(src)
        equal = len(restored) == 1 and _states_equal(restored[0], file3)
        lr_next = restored[0]["lr_next"] if restored else None
        emit({"phase": "cli_resume", "restored_step": restored[0]["step"] if restored else None,
              "restored_equal_to_checkpoint_bitwise": equal, "lr_of_step_4": lr_next,
              "steps": [r["step"] for r in lines2], "losses": [r["total_loss"] for r in lines2],
              "latest_checkpoint": latest_step(os.path.join(out2, "checkpoints")),
              "ms_per_step_traced": [r["step_s"] * 1e3 for r in lines2],
              "profiler_trace_of_steps_4_6": busy, "wall_s": wall2, "launches": launches2,
              "card": card})
        del file3
        if not equal or restored[0]["step"] != CLI_PERIOD:
            raise AssertionError("the resumed state differs from its checkpoint")
        if [r["step"] for r in lines2] != list(range(CLI_PERIOD + 1, CLI_MAX_ITER + 1)) or \
                not all(np.isfinite(r["total_loss"]) for r in lines2) or \
                min(launches2.values()) == 0:
            raise AssertionError(f"the resumed run did not continue: {lines2}, {launches2}")
        restored.clear()

        # 3. --eval-only from the checkpoints
        wall3, launches3 = run(out, "--eval-only", "--weights", ckpt_dir)
        ds = cfg.datasets.test[0]
        files = {k: os.path.exists(os.path.join(out, f"{k}_{ds}.json"))
                 for k in ("metrics", "results")}
        with open(os.path.join(out, f"metrics_{ds}.json")) as f:
            metrics = json.load(f)
        expected3 = {**{k: 0 for k in launches3},
                     "msda_fwd": enc * len(CLI_EVAL_VIDEOS), "hungarian": len(CLI_EVAL_VIDEOS)}
        emit({"phase": "cli_eval", "metrics": metrics, "files": files, "wall_s": wall3,
              "launches": launches3, "expected_launches": expected3, "card": card})
        if not all(files.values()) or not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"the CLI's eval wrote {files}, {metrics}")
        if launches3 != expected3:
            raise AssertionError(f"CLI eval launches {launches3} != {expected3}")

        batches, recorded = _api_resume_check(cfg, root)
        _dp_check(common, batches[0], root)

        # 5. one step through --distributed under NCCL, a world of 1
        out5 = os.path.join(root, "out_nccl")
        wall5, launches5 = run(out5, "--distributed", "--coordinator", f"localhost:{_free_port()}",
                               "--num-processes", "1", "--process-id", "0",
                               extra=["solver.max_iter=1"])
        lines5 = _metrics_lines(out5)
        emit({"phase": "cli_nccl_world_1", "steps": [r["step"] for r in lines5],
              "losses": [r["total_loss"] for r in lines5], "launches": launches5,
              "process_group_destroyed": not torch.distributed.is_initialized(), "wall_s": wall5})
        if [r["step"] for r in lines5] != [1] or not np.isfinite(lines5[0]["total_loss"]) or \
                min(launches5.values()) == 0 or torch.distributed.is_initialized():
            raise AssertionError("the NCCL step did not run")
        return train_launches, launches3, recorded
    finally:
        cli.build_text_bank, cli.save_checkpoint, cli.restore_checkpoint = orig
        shutil.rmtree(root, ignore_errors=True)


def _fixed_batches(cfg, n):
    loader = TrainLoader(cfg, seed=SEED)
    try:
        batches = [next(loader) for _ in range(n)]
    finally:
        loader.close()
    k = len(catalog.get(cfg.datasets.train[0]).thing_classes)
    text = torch.from_numpy(_TextBank().encode(range(k)))
    return [dict(b, text_feats=text) for b in batches]


def _fresh_step(cfg, seed, k):
    model = init_params(train.build_model(cfg, DEVICE), seed=seed)
    return train.build_train_step(cfg, model, k, DEVICE)


def _hold_cli_recorded(msda_rec: MsdaRecorder, k4_rec: HungarianRecorder,
                       sampler_rec: SamplerInputs) -> None:
    """K1-K6 on the inputs one step of the CLI's recipe gave them (8 clips:
    the first encoder layer's K1 and K2/K3 inputs, the matcher's costs, K5's
    and K6's first call of each shape) against their plain versions, with
    the tolerances of phases 2-6; returns the kernels line's times of K1,
    K2 and K3 on these inputs."""
    k1_ms = _hold_k1("cli_train", msda_rec)
    k2_ms, k3_ms, k3_dev = _hold_k2_k3("cli_train", msda_rec)
    plain = _plain_assignments(k4_rec.costs)
    cols = [c for batch_cols in k4_rec.cols for c in batch_cols]
    differ = [i for i, ((ref, _), got) in enumerate(zip(plain, cols)) if not torch.equal(ref, got)]
    steps = [n for _, n in plain]
    emit({"phase": "k4_recorded_inputs", "path": "cli_train",
          "shapes": [list(c.shape) for c in k4_rec.costs], "equal_to_plain": not differ,
          "problems_differing": differ,
          "steps_per_problem": {"mean": float(np.mean(steps)), "max": max(steps)}})
    if differ or len(k4_rec.costs) != 1:
        raise AssertionError(f"K4 on the CLI step's costs differs from hungarian_plain: {differ}")
    for shape, (maps, coords) in sorted(sampler_rec.fwd.items()):
        maps, coords = maps.to(DEVICE), coords.to(DEVICE)
        got = point_sample_cuda.point_sample_fwd_cuda(maps, coords)
        ref = sample_maps_shared_plain(maps, coords, f32_policy=True)
        torch.cuda.synchronize()
        ok, err, rel = _check_close(got, ref, SAMPLER_REL_TO_MAX, SAMPLER_RTOL)
        emit({"phase": "k5_recorded_inputs", "path": "cli_train", "maps_points": shape,
              "dtype": str(maps.dtype).replace("torch.", ""), "within_tol": ok,
              "max_abs_err": err, "max_err_rel_to_max": rel,
              "tol": {"rel_to_max": SAMPLER_REL_TO_MAX, "rtol": SAMPLER_RTOL}})
        if not ok:
            raise AssertionError(f"K5 disagrees with the plain sampler on the CLI step's {shape}")
    for shape, (coords, grad, map_shape, dtype) in sorted(sampler_rec.dvalue.items()):
        coords, grad = coords.to(DEVICE), grad.to(DEVICE)
        got = point_sample_cuda.point_sample_dvalue_cuda(coords, grad, map_shape, dtype)
        ref = sample_maps_dvalue_plain(torch.empty(map_shape, dtype=dtype, device=DEVICE),
                                       coords, grad)
        torch.cuda.synchronize()
        ok, err, rel = _check_close(got, ref, BWD_REL_TO_MAX, BWD_RTOL[dtype])
        emit({"phase": "k6_recorded_inputs", "path": "cli_train", "maps_points": shape,
              "dtype": str(dtype).replace("torch.", ""), "within_tol": ok,
              "max_abs_err": err, "max_err_rel_to_max": rel,
              "tol": {"rel_to_max": BWD_REL_TO_MAX, "rtol": BWD_RTOL[dtype]}})
        if not ok:
            raise AssertionError(f"K6 disagrees with the plain sampler on the CLI step's {shape}")
    if not sampler_rec.fwd or not sampler_rec.dvalue:
        raise AssertionError("the CLI step launched no K5 or no K6")
    return {"msda_fwd": {"recorded_cli_train_ms": k1_ms},
            "msda_dcoord": {"recorded_cli_train_ms": k2_ms},
            "msda_dvalue": {"recorded_cli_train_ms": k3_ms,
                            "recorded_cli_train_device_ms": k3_dev}}


def _metrics(step, batch):
    return {k: v.item() for k, v in step(_to_device(batch, DEVICE)).items()}


def _run_steps(cfg, k, batches, seed=SEED, start=None, tamper=None):
    """A fresh train step from the seeded init, restored from ``start`` (a
    checkpoint directory) and passed to ``tamper`` if given, run over
    ``batches``; returns it and its first step's metrics."""
    step = _fresh_step(cfg, seed, k)
    if start is not None:
        restore_checkpoint(start, step.state)
    if tamper is not None:
        tamper(step.state)
    metrics = [_metrics(step, b) for b in batches]
    return step, metrics[0]


def _zero_mu(state):
    for t in state.opt.mu.values():
        t.zero_()


def _stream_off_by_one(state):
    state.step += 1


def _api_resume_check(cfg, root):
    """2 + 2 steps through a checkpoint against 4 uninterrupted, on fixed
    loader batches, in the recipe's bf16 AMP.  The resumed state must equal
    the checkpoint bit for bit.  Step 3 then starts from the same state in
    both runs, so its mask losses (point-sampled) must agree within
    ``CLI_RESUME_LOSS_RTOL``.  K3/K6's atomics make any two runs' updates
    differ, so the final parameters are held by their distance over the norm
    of the uninterrupted run's update, within ``CLI_RESUME_UPDATE_DIFF``,
    which lies above this card's noise floor (a second uninterrupted run).
    Two faulty resumes must fail: AdamW's ``mu`` zeroed (the distance) and
    the step's stream one step off (the losses).  The first step's K1-K6
    inputs are recorded and held against the plain versions.  Returns the
    batches (on the host) and ``_hold_cli_recorded``'s times."""
    batches = _fixed_batches(cfg, 4)
    k = batches[0]["text_feats"].shape[0]
    d = os.path.join(root, "api_ckpt")
    whole = _fresh_step(cfg, SEED, k)
    init = {n: p.detach().clone() for n, p in whole.state.model.named_parameters()}
    with MsdaRecorder() as msda_rec, HungarianRecorder() as k4_rec, \
            SamplerInputs() as sampler_rec:
        _metrics(whole, batches[0])
    _metrics(whole, batches[1])
    save_checkpoint(d, whole.state.step, whole.state.state_dict())
    saved = _state_copy(whole.state)
    step3 = _metrics(whole, batches[2])
    _metrics(whole, batches[3])
    final = {n: p.detach() for n, p in whole.state.model.named_parameters()}
    upd = sum(((final[n] - init[n]).double() ** 2).sum().item() for n in final) ** 0.5
    del init

    def read(step, first):
        """The run's distance from ``whole`` and, if ``first`` holds its
        step 3's metrics, their mask losses' difference from ``whole``'s."""
        out = {"update_diff_rel_norm": sum(
            ((p.detach() - final[n]).double() ** 2).sum().item()
            for n, p in step.state.model.named_parameters()) ** 0.5 / upd,
            "count": step.state.opt.count}
        if first is not None:
            out["step3_mask_loss_rel_diff"] = max(abs(first[k_] - step3[k_]) / abs(step3[k_])
                                                  for k_ in ("loss_mask", "loss_dice"))
        return out

    noise = read(_run_steps(cfg, k, batches)[0], None)
    torch.cuda.empty_cache()
    resumed = _fresh_step(cfg, SEED + 1, k)
    restore_checkpoint(d, resumed.state)
    equal = _states_equal(_state_copy(resumed.state), saved)
    del saved
    first = _metrics(resumed, batches[2])
    _metrics(resumed, batches[3])
    got = read(resumed, first)
    del resumed
    faults = {}
    for name, fault in (("mu_zeroed", _zero_mu), ("stream_off_by_one", _stream_off_by_one)):
        torch.cuda.empty_cache()
        faults[name] = read(*_run_steps(cfg, k, batches[2:], SEED + 1, d, fault))
    limit, loss_tol = CLI_RESUME_UPDATE_DIFF, CLI_RESUME_LOSS_RTOL
    emit({"phase": "cli_resume_vs_uninterrupted", "steps": [2, 2], "against": 4,
          "dtype": "bf16 AMP", "restored_equal_bitwise": equal, "resumed": got,
          "noise_floor_second_uninterrupted": noise, "faulty_resumes": faults,
          "limits": {"update_diff_rel_norm": limit, "step3_mask_loss_rel_diff": loss_tol},
          "update_norm": upd, "uninterrupted_count": whole.state.opt.count})
    del whole, final
    torch.cuda.empty_cache()
    if not equal or got["count"] != 4 or got["update_diff_rel_norm"] > limit or \
            got["step3_mask_loss_rel_diff"] > loss_tol:
        raise AssertionError("2 + 2 resumed steps disagree with 4 uninterrupted")
    if noise["update_diff_rel_norm"] > limit or \
            faults["mu_zeroed"]["update_diff_rel_norm"] <= limit or \
            faults["stream_off_by_one"]["step3_mask_loss_rel_diff"] <= loss_tol:
        raise AssertionError(f"the resume check's limits do not part the noise floor {noise} "
                             f"from the faulty resumes {faults}")
    return batches, _hold_cli_recorded(msda_rec, k4_rec, sampler_rec)


def _step_with_grads(cfg, batch, k):
    """One step from the seeded init: (metrics, the reduced gradients on the
    host, launches)."""
    step = _fresh_step(cfg, SEED, k)
    grads, opt_step = {}, step.state.opt.step

    def recording(params, g, norm=None):
        grads.update({n: v.float().cpu() for n, v in g.items()})
        opt_step(params, g, norm)

    step.state.opt.step = recording
    reset_counts()
    metrics = {k_: v.item() for k_, v in step(_to_device(batch, DEVICE)).items()}
    return metrics, grads, read_counts()


def _dp_configs(cfg):
    return {"float32": dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, amp=False)),
            "bf16 AMP": cfg}


def dp_rank(args_json: str) -> None:
    """One of the 2 gloo processes on the card (run as a script by phase 11)."""
    a = json.loads(args_json)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(CLI_CONFIG, a["overrides"])
    torch.cuda.set_device(0)
    torch.distributed.init_process_group("gloo", init_method=f"file://{a['rendezvous']}",
                                         world_size=2, rank=a["rank"])
    try:
        batch = torch.load(a["batch"], weights_only=False)
        b = batch["pixels"].shape[0] // 2
        t = batch["targets"]
        s = slice(a["rank"] * b, (a["rank"] + 1) * b)
        part = {"pixels": batch["pixels"][s], "text_feats": batch["text_feats"],
                "targets": ClipTargets(t.labels[s], t.masks[s], t.valid[s], t.frame_valid[s])}
        out = {name: _step_with_grads(c, part, batch["text_feats"].shape[0])
               for name, c in _dp_configs(cfg).items()}
    finally:
        torch.distributed.destroy_process_group()
    if a["rank"] == 0:
        torch.save(out, a["result"])


def _dp_check(overrides, batch, root):
    """One step of the global batch on 2 gloo processes on the card against
    1 process, f32 (TF32 off) and bf16 AMP."""
    cfg = load_config(CLI_CONFIG, overrides)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k = batch["text_feats"].shape[0]
    t0 = time.perf_counter()
    one = {name: _step_with_grads(c, batch, k) for name, c in _dp_configs(cfg).items()}
    one_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    path = os.path.join(root, "dp_batch.pt")
    torch.save(batch, path)
    args = {"overrides": overrides, "rendezvous": os.path.join(root, "dp_rdv"), "batch": path,
            "result": os.path.join(root, "dp_rank0.pt")}
    code = "import sys, chip_smoke as c; c.dp_rank(sys.argv[1])"
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", code, json.dumps(dict(args, rank=r))],
                              cwd=os.path.dirname(os.path.abspath(__file__)))
             for r in range(2)]
    try:
        codes = [p.wait(timeout=DP_JOIN_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    two_s = time.perf_counter() - t0
    if any(codes):
        raise AssertionError(f"the gloo processes exited with {codes}")
    two = torch.load(args["result"], weights_only=False)
    report, ok = {}, True
    for name, ((m1, g1, l1), (m2, g2, l2)) in ((n, (one[n], two[n])) for n in one):
        tol = DP_TOL[name]
        loss_rel = {k_: abs(m2[k_] - m1[k_]) / max(abs(m1[k_]), 1e-30)
                    for k_ in ("total_loss", "loss_ce", "loss_mask", "loss_dice")}
        norm_rel = abs(m2["grad_norm"] - m1["grad_norm"]) / m1["grad_norm"]
        num = sum(((g2[n] - g) ** 2).sum().item() for n, g in g1.items())
        den = sum((g ** 2).sum().item() for g in g1.values())
        # k_proj biases have an exact gradient of 0 (softmax is shift-invariant)
        worst = max((((g2[n] - g).abs().max() / g.abs().max()).item(), n)
                    for n, g in g1.items() if not n.endswith("k_proj.bias"))
        diff_rel = (num / den) ** 0.5
        good = (max(loss_rel.values()) <= tol["loss_rtol"] and norm_rel <= tol["grad_norm_rtol"]
                and diff_rel <= tol["grad_diff_rel_norm"] and set(g1) == set(g2))
        ok = ok and good
        report[name] = {"losses_1_2": {k_: [m1[k_], m2[k_]] for k_ in loss_rel},
                        "loss_rel_err": loss_rel,
                        "grad_norm_1_2": [m1["grad_norm"], m2["grad_norm"]],
                        "grad_norm_rel_err": norm_rel, "grad_diff_rel_norm": diff_rel,
                        "worst_tensor_err_rel_to_its_max": worst, "launches_1": l1,
                        "launches_rank0": l2, "tol": tol, "ok": good}
    emit({"phase": "cli_two_processes_vs_one",
          "backend": "gloo",
          "global_batch": batch["pixels"].shape[0], "per_process": batch["pixels"].shape[0] // 2,
          "one_process_s": one_s, "two_processes_s": two_s, **report})
    if not ok:
        raise AssertionError("2 processes disagree with 1")


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
    train_launches, k5_by_shape = phase_train(card, train_rec)
    for case, n in k5_by_shape.items():
        fields["point_sample_fwd"]["cases"][case]["launches"] = n
    for name, extra in phase_msda_recorded(eval_rec, train_rec).items():
        fields[name].update(extra)
    phase_train_vs_plain()
    engine_launches = phase_engine(card)
    cli_launches, cli_eval_launches, cli_recorded = phase_cli(card)
    for name, extra in cli_recorded.items():
        fields[name].update(extra)
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
         "launches_by_path": {"eval": eval_launches[name], "train": train_launches[name],
                              "engine": engine_launches[name], "cli_train": cli_launches[name],
                              "cli_eval": cli_eval_launches[name]},
         "max_abs_err": fields[name]["max_abs_err"], "ms": fields[name]["ms"],
         "device_ms": fields[name]["device_ms"],
         "plain_ms": fields[name]["plain_ms"], "bound_ms": fields[name]["bound_ms"],
         "bound_by": fields[name]["bound_by"],
         "library_ms": fields[name].get("library_ms"),
         **{k: v for k, v in fields[name].items() if k.startswith("recorded_") or k == "cases"}}
        for name, (src, replaces) in meta.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
