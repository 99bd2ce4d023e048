#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``openvis_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises (non-zero exit):

  0. device: refuses to run without CUDA; prints the card's name and power limit
  1. build: compiles the hand-written kernels from ``openvis_tpu_torch/csrc``
  2. K1 (MSDA forward) against ``ms_deform_attn_plain`` on the card
  3. K4 (batched Hungarian) against scipy and ``hungarian_plain``
  4. the SimpleBaselineOnline-R50 eval path at full width (random weights from
     a seed, bf16): three 10x384x640 windows, with the kernels' launch counts
  5. the same path in f32 on the card (kernels) against the CPU (plain versions)

The line before the last lists every kernel with its launches on the main path
(phase 4), its error against its plain version and both times; the last line
is ``{"ok": true, "device": {...}}``.  Imports no JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from openvis_tpu_torch import Config, train
from openvis_tpu_torch.convert import init_params
from openvis_tpu_torch.ops import cuda_build, hungarian_cuda, msda_cuda
from openvis_tpu_torch.ops.hungarian import hungarian_plain
from openvis_tpu_torch.ops.msda import ms_deform_attn_plain

SEED = 0
DEVICE = "cuda"
# main-path shapes: 10 frames at 384x640 -> encoder levels at strides 32/16/8
WINDOW_FRAMES, FRAME_H, FRAME_W = 10, 384, 640
NUM_WINDOWS = 3
K_CLASSES, TEXT_DIM = 40, 512
MSDA_CASES = {
    "main_path": [(12, 20), (24, 40), (48, 80)],
    # a 768x1344 input: above the TPU fused kernel's 12 MB VMEM gate
    "above_tpu_vmem_gate": [(24, 42), (48, 84), (96, 168)],
}
MSDA_HEADS, MSDA_CH, MSDA_POINTS = 8, 32, 4
HUNGARIAN_CASES = {  # name -> (batch, rows, cols)
    "tracking_uniform": (9, 100, 100),
    "tracking_cosine": (9, 100, 100),
    "integer_ties": (9, 100, 100),
    "rectangular": (4, 40, 100),
}
CHECK_FRAMES = 2     # phase 5 window
TIMING_ITERS = 20

# stated tolerances: |kernel - plain| <= ATOL + RTOL * |plain|, elementwise
MSDA_TOL = {
    # same f32 arithmetic; grid_sample derives the pixel coordinate from
    # 2*loc-1, a few f32 ulps away from loc*size-0.5
    torch.float32: (1e-4, 1e-4),
    # plus one bf16 rounding of the output (relative spacing <= 2^-7)
    torch.bfloat16: (1e-3, 2 ** -7),
}
HUNGARIAN_RTOL = 1e-6  # total cost against scipy's optimum
# phase 5, GPU kernels vs CPU plain in f32, TF32 off: summation order differs
# through ~50 layers of random weights, and the decoder's attention mask reads
# the sign of resized mask logits
SLICE_SCORE_ATOL = 5e-3
SLICE_MASK_REL_TO_MAX = 1e-2
SLICE_SIGN_AGREE = 0.999


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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def phase_build():
    t0 = time.perf_counter()
    msda_cuda.library()
    hungarian_cuda.library()
    ptxas = {
        name: [ln.strip() for ln in log.splitlines() if "Used" in ln]
        for name, (_, log) in cuda_build.build_logs.items()
    }
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": {k: v[0] for k, v in cuda_build.build_logs.items()},
          "ptxas": ptxas})


def _msda_inputs(levels, dtype, gen):
    nl = len(levels)
    length = sum(h * w for h, w in levels)
    b, nh, ch, p = WINDOW_FRAMES, MSDA_HEADS, MSDA_CH, MSDA_POINTS
    value = torch.randn(b, length, nh, ch, device=DEVICE, generator=gen).to(dtype)
    # [-0.1, 1.1]: some points fall outside the map
    loc = torch.rand(b, length, nh, nl, p, 2, device=DEVICE, generator=gen) * 1.2 - 0.1
    attn = torch.randn(b, length, nh, nl * p, device=DEVICE, generator=gen)
    attn = torch.softmax(attn, dim=-1).view(b, length, nh, nl, p).to(dtype)
    return value, loc, attn


def phase_msda():
    """K1 against its plain version; returns (max abs error, kernel ms, plain ms)
    at the main-path shape in bf16."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    worst, main_times = 0.0, None
    for case, levels in MSDA_CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            value, loc, attn = _msda_inputs(levels, dtype, gen)
            got = msda_cuda.ms_deform_attn_cuda(value, levels, loc, attn)
            ref = ms_deform_attn_plain(value, levels, loc, attn)
            torch.cuda.synchronize()
            atol, rtol = MSDA_TOL[dtype]
            diff = (got.float() - ref.float()).abs()
            ok = bool((diff <= atol + rtol * ref.float().abs()).all())
            max_abs = diff.max().item()
            k_ms = time_cuda(lambda: msda_cuda.ms_deform_attn_cuda(value, levels, loc, attn))
            p_ms = time_cuda(lambda: ms_deform_attn_plain(value, levels, loc, attn))
            emit({"phase": "k1_msda_fwd", "case": case, "levels": levels,
                  "batch": WINDOW_FRAMES, "dtype": str(dtype).replace("torch.", ""),
                  "max_abs_err": max_abs,
                  "max_rel_err": max_abs / max(ref.float().abs().max().item(), 1e-30),
                  "tol": {"atol": atol, "rtol": rtol}, "within_tol": ok,
                  "kernel_ms": k_ms, "plain_ms": p_ms})
            if not ok:
                raise AssertionError(f"K1 disagrees with its plain version ({case}, {dtype})")
            worst = max(worst, max_abs)
            if case == "main_path" and dtype == torch.bfloat16:
                main_times = (k_ms, p_ms)
    return worst, *main_times


def _hungarian_costs(name, b, n, m, rng):
    if name == "tracking_cosine":
        e = rng.randn(b, 2, n, 256).astype(np.float32)
        e /= np.linalg.norm(e, axis=-1, keepdims=True)
        return (1.0 - np.einsum("bqc,bkc->bqk", e[:, 0], e[:, 1])).astype(np.float32)
    if name == "integer_ties":
        return rng.randint(1, 5, size=(b, n, m)).astype(np.float32)
    return (rng.rand(b, n, m) * 5).astype(np.float32)


def phase_hungarian():
    """K4 against scipy and the plain loop; returns (max abs total-cost error,
    kernel ms, plain ms) at the tracking shape."""
    rng = np.random.RandomState(SEED)
    worst, main_times = 0.0, None
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
        emit({"phase": "k4_hungarian", "case": name, "shape": [b, n, m],
              "max_abs_cost_err_vs_scipy": max(errs), "rtol": HUNGARIAN_RTOL,
              "kernel_ms": k_ms, "plain_cpu_ms_per_batch": plain_ms,
              "scipy_cpu_ms_per_batch": scipy_ms})
        worst = max(worst, max(errs))
        if name == "tracking_cosine":
            main_times = (k_ms, plain_ms)
    return worst, *main_times


def _full_config():
    cfg = Config()
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, num_classes=K_CLASSES))


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


def phase_slice(card: str):
    """The main path at full width, bf16: three windows; returns the launch
    counts of the timed run."""
    cfg = _full_config()
    model = init_params(train.build_model(cfg), seed=SEED)
    model = model.to(device=DEVICE, dtype=torch.bfloat16).eval()
    eval_fn = train.make_eval_fn(cfg, model)
    rng = np.random.RandomState(SEED)
    t, h, w = WINDOW_FRAMES, FRAME_H, FRAME_W
    windows = [
        torch.from_numpy(rng.randn(t, h, w, 3).astype(np.float32)).to(DEVICE, torch.bfloat16)
        for _ in range(NUM_WINDOWS)
    ]
    text = torch.from_numpy(_text(rng)).to(DEVICE, torch.bfloat16)

    eval_fn(windows[0], text)  # warm-up: cuDNN autotuning, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    msda_cuda.launches = 0
    hungarian_cuda.launches = 0
    start.record()
    outs = [eval_fn(x, text) for x in windows]
    end.record()
    torch.cuda.synchronize()
    launches = {"msda_fwd": msda_cuda.launches, "hungarian": hungarian_cuda.launches}
    ms = start.elapsed_time(end)
    q = cfg.model.transformer_decoder.num_queries
    for i, out in enumerate(outs):
        _check_outputs(out, q, K_CLASSES, t, h, w, f"window {i}")
    enc_layers = cfg.model.pixel_decoder.transformer_enc_layers
    expected = {"msda_fwd": enc_layers * NUM_WINDOWS, "hungarian": NUM_WINDOWS}
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
    cpu_model = init_params(train.build_model(cfg), seed=SEED + 1).eval()
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")
    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    phase_build()
    k1_err, k1_ms, k1_plain_ms = phase_msda()
    k4_err, k4_ms, k4_plain_ms = phase_hungarian()
    launches = phase_slice(card)
    phase_slice_vs_plain()
    if "jax" in sys.modules:
        raise AssertionError("the port imported JAX")
    emit({"kernels": [
        {"name": "msda_fwd", "route": "cuda", "source": "openvis_tpu_torch/csrc/msda_fwd.cu",
         "replaces": "openvis_tpu/ops/msda_pallas.py:321", "launches": launches["msda_fwd"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "hungarian", "route": "cuda", "source": "openvis_tpu_torch/csrc/hungarian.cu",
         "replaces": "openvis_tpu/ops/hungarian_pallas.py:36", "launches": launches["hungarian"],
         "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain_ms},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
