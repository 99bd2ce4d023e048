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
     shapes (the 200-query matcher's on the block solver), with its plan,
     each problem's Dijkstra steps, and the wrapper's and the device's time
     per case
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
     (bf16 AMP, 8 one-frame clips a step, 12544 points), its text bank from
     the CLIP text tower and its eval through the CLIP ensemble (random
     ViT-B/16 weights in OpenAI's layout and a tiny BPE merge file, written
     from the seed to a temporary directory): synthetic
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
  12. SimpleBaselineOnline's CLIP ensemble through the engine over phase 10's
     second video at full width, bf16 AMP, with the recipe's ``clip_adapter``
     (``bg_clip``, ViT-B/16, the vild prompts, weight 0.5) and phase 11's
     CLIP files: the text bank of the 40 categories, a warm-up over the first
     video, then the timed run with phase 10's split plus the CLIP crop
     scoring, its ``roi_crop``s (device) and the text bank (host), its peak
     and the K1/K4 launches; the full-width tower in f32 on 8 crops, card
     against CPU, and the bf16 tower's time on a frame's 100 crops; the
     whole ensemble engine at the test-tiny CLIP shape on phase 10's f32
     check video, card (kernels) against CPU (plain)

  13. SANOnline with its recipe's model
     (``configs/openvoc_ytvis_coco/san_online_R50_bs16_6000st.yaml``: the
     side-adapter CLIP split of a random ViT-B/16 in OpenAI's layout, read by
     the CLI's reader from phase 11's CLIP files): three 10x384x640 bf16
     windows with their split (CLIP front, segmenter, CLIP post, tracking and
     top-k) and TFLOP/s against FLOPS.json's ``san_online_r50_inference``; an
     f32 window at 192x320 on the card against the CPU; the train step at
     1x2x480x864 (bf16 AMP, the aux layers' CLIP logits), the tower bit-equal
     after it and SAN's own parameters moved; its f32 loss and gradients at
     1x2x192x320, card against CPU; the engine with the recipe's eval settings
     over phase 10's second video, K4 on its tracking costs against
     ``hungarian_plain``; the CLI as users train it (16 clips of 2 frames, 3
     steps, a checkpoint), then ``--eval-only``
  14. BriVIS with its recipe's model
     (``configs/openvoc_ytvis_coco/brivis_R50_bs16_6000st.yaml``: phase 13's
     model frozen, a temporal resampler of 6 layers): three 10x384x640 bf16
     windows of bench.py's staged path (frame stack, tracking, resampler,
     heads with the biased CLIP post-encode, top-k) with their split and
     TFLOP/s against FLOPS.json's ``brivis_r50_inference``; an f32 window at
     192x320 on the card against the CPU; the train step at 1x3x480x864 (bf16
     AMP) under each matcher source, K1/K4/K5/K6 on its first step's inputs
     against the plain versions, the frozen stage 1 bit-equal and without
     AdamW state, the resampler moved; its f32 loss and gradients at
     1x3x192x320, card against CPU; the engine over phase 10's dataset with
     its split, K4 on its tracking costs against ``hungarian_plain``, and the
     decoupled and raw resamplers on one f32 video each, card against CPU;
     the CLI's stage 2 from phase 13's SAN checkpoint (16 clips of 3 frames,
     2 steps across the matcher switch, a checkpoint whose grafted subtrees
     equal stage 1's), then ``--eval-only``
  15. OpenVISOnline with its recipe's model
     (``configs/openvoc_ytvis_coco/openvis_online_R50_bs16_6000st.yaml``: the
     class-agnostic proposal segmenter; every query's mask cropped and
     classified by the frozen ViT-B/16 of phase 11's CLIP files): three
     10x384x640 bf16 windows of bench.py's ``make_openvis_eval`` through the
     engine's parts, with their split (segmenter, tracking, the crops and
     their ``roi_crop``s, scores and top-k) and TFLOP/s against FLOPS.json's
     ``openvis_online_r50_inference``; an f32 window at 192x320 on the card
     against the CPU (the crops through the test-tiny tower); the train step
     at 1x2x480x864 (bf16 AMP) and its f32 loss and gradients at 1x2x192x320,
     card against CPU; the engine with the recipe's eval settings over phase
     10's second video and its text bank, K4 on its tracking costs against
     ``hungarian_plain``; the CLI as users train it (16 clips of 2 frames, 2
     steps, a checkpoint), then ``--eval-only`` through the tower
  16. BURST evaluation (``configs/openvoc_ytvis_coco/eval_burst.yaml``:
     SANOnline over the 482 LVIS classes, HOTA and TrackMAP) over a synthetic
     BURST dataset (TAO schema; sequences at 720x1280 and 480x640, tracks
     entering and leaving): the engine's run with the host seconds of HOTA and
     of TrackMAP, K4 against ``hungarian_plain``; one f32 sequence card
     against CPU; then ``--eval-only`` on phase 13's SAN checkpoint
  17. the offline (clip-level) archs, the video decoder evaluated single-shot:
     offline SimpleBaseline-R50
     (``configs/openvoc_ytvis_coco/simplebsl_R50_bs8_12000st.yaml``) in three
     timed 10x384x640 bf16 shots with their split (backbone, pixel decoder,
     video decoder, scores and top-k) and one shot of test.max_frames = 128
     frames on the 480x864 canvas with its peak; the same model in f32 on 5
     frames padded to 8 at 192x320, card against CPU; its clip-level train
     step at 1x2x480x864 (K1-K6 launches, K5's clip-level call shapes, K1-K6
     on the first step's recorded inputs against the plain versions) and its
     f32 loss and gradients at 1x2x192x320, card against CPU; the engine over
     phase 10's dataset through the ensemble (single shots of 40 and 24
     frames, the 133-frame video in two windows of 128; K1 only). Offline
     OpenVIS (``openvis_R50_bs16_6000st.yaml``, ``model.weights`` emptied):
     its train step and engine (phase 10's last two videos: the second's
     single shot, the 133-frame video in windows of 128); the
     ``frame_proposal`` recipe's engine on phase 10's f32 check video, card
     against CPU. Offline SAN (``san_R50_bs16_6000st.yaml``): three timed
     shots with their split (CLIP front, segmenter, CLIP post, top-k), an f32
     shot card against CPU, the engine (the last two videos), its train step
     refused with its named error.
     VideoMaskFormer and MinVIS: an f32 window each card against CPU, MinVIS
     through the engine on the check video card against CPU with K4 on its
     tracking costs against ``hungarian_plain``. The CLI: the offline
     SimpleBaseline recipe as users train it (8 clips of 2 frames, 2 steps)
     and ``--eval-only``; offline SAN ``--eval-only`` on phase 13's SANOnline
     checkpoint
  18. OV2Seg with its recipe's model
     (``configs/openvoc_ytvis_coco/ov2seg_online_R50.yaml``: the two-head
     decoder, D = 512): three 10x384x640 bf16 windows through
     ``make_eval_fn`` (padded to 16 frames, the EMA chain: 16 dependent K4
     launches a window, the gated top-k) with their split; an f32 window at
     192x320 on the card against the CPU; the train step at 1x2x480x864 with
     K1-K6 on its recorded inputs against the plain versions, and its f32
     loss and gradients at 1x2x192x320, card against CPU; the engine over
     phase 10's dataset (K4 200 launches: each video's chain over
     ``_bucket(t)`` frames), K4 on all its costs against ``hungarian_plain``;
     the 133-frame video's chain alone (136 launches), timed; one f32 video
     card against CPU; the CLI (16 clips of 2 frames, 2 steps) and
     ``--eval-only``. Then the SAN Swin-B recipes
     (``configs/openvoc_ytvis_coco/swin/``: Swin-B, windows of 12, a random
     ViT-L/14@336px side CLIP split at block 21): three 10x480x864 bf16
     windows with their split; the train step at 1x2x480x864 with the
     recipe's drop path; the Swin segmenter (Swin-B cut to 2 blocks a stage
     under the R50 SAN recipe's ViT-B/16) in f32 at 192x320, window and step
     (drop path 0), card against CPU; the CLI at 2 clips of 2 frames from a
     stand-in init checkpoint (``_swin_init``) and ``--eval-only``;
     ``san_SwinB`` ``--eval-only`` on its checkpoint; 2 ``brivis_SwinB``
     stage-2 steps from it and ``--eval-only`` (the three CLIs with the
     trunk cut to 2 blocks a stage, ``SWIN_CLI_OVERRIDES``)
  19. MasQCLIP as the CLI builds it from
     ``configs/openvoc_ytvis_coco/simplebsl_R50_bs8_12000st.yaml`` with
     ``model.meta_architecture=MasQCLIP`` and the ``video_proposal`` decoder
     (the ViT-B/16 MasQ tower: 100 mask tokens beside 197 tokens a frame):
     three 10x384x640 bf16 shots against K=40 text rows with their split
     (segmenter, MasQ tower, the rest) and peak; an f32 shot at 192x320 (5
     frames padded to 8), card against CPU; the train step at 1x2x480x864
     (K1 6 and K5 1 a step, nothing else; the segmenter's Adam moments zero
     while its weights decay) with K1 and K5 on its recorded inputs against
     the plain versions; its f32 loss, pseudo-labels and gradients at
     1x2x192x320, card against CPU, the segmenter's gradients exactly zero;
     the engine over phase 10's last two videos (a single shot, the 133-frame
     video in windows of 128); the CLI (8
     clips of 2 frames, 2 steps) and ``--eval-only``
  20. SimpleBaselineOnline-R50 from phase 11's recipe with
     ``model.pixel_decoder.name=transformer_enc solver.optimizer=sgd`` (the
     FPN pixel decoder behind 6 DETR encoder layers over res5; no MSDA, so no
     K1-K3): three 10x384x640 bf16 windows with their split (backbone, pixel
     decoder, frame decoder, tracking), K4 once a window and on its costs
     against ``hungarian_plain``; the SGD train step at 1x2x480x864 (K4 1, K5
     30, K6 20 a step; the decayed parameters moved, the frozen ones fixed)
     with K4, K5 and K6 on its recorded inputs against the plain versions;
     card against CPU in f32 at 192x320 for ``fpn`` and ``transformer_enc``
     (the window, the step's loss and gradients, one SGD update), the
     ``frame_zero_shot`` and ``video_zero_shot`` segmenters and a full-width
     ``DETRTransformer``; the CLI (8 one-frame clips, 2 steps, ``--resume``
     for a third with SGD's trace restored, ``--eval-only``)
  21. the Swin-L OpenVIS recipe
     (``configs/openvoc_ytvis_coco/swin/openvis_swinL_bs16_6000st_ViT-L-336.yaml``:
     offline OpenVIS over the ``frame_proposal`` head with 200 queries, Swin-L,
     the ``mask`` adapter's frozen ViT-L/14@336px of phase 18's file): three
     10x384x640 bf16 single shots as the engine runs them (padded to 16
     frames, the frame head's logits averaged, no tracking: K1 6 a shot, no
     K4) with their split (Swin-L trunk, pixel decoder, frame decoder, the
     rest) and peak, and one 128-frame shot at 480x864 with its peak; the
     train step at 1x2x480x864 (AdamW, drop path 0.3; K1-K3 6, K4 1 on the
     block solver for the matcher's (20, 40, 200) costs, K5 30, K6 20 a
     step) with K4, K5 and K6 on its recorded inputs against the plain
     versions; Swin-L cut to 2 blocks a stage in f32 at 192x320, a shot and a
     step, card against CPU; the CLI at 2 clips of 2 frames from a stand-in
     Swin-L init and ``--eval-only``.  Then ``eval_lvvis.yaml`` (SANOnline over
     lvvis_val's 1196 classes) ``--eval-only`` on phase 13's checkpoint over a
     synthetic lvvis_val in the dataset's own layout: the 16,744-prompt
     text bank's host seconds, the engine's frames/s, the evaluator's host
     seconds over the 1196 ids, the K1 and K4 launches
  22. the mask-adapted CLIP towers: phase 15's three 10x384x640 bf16
     OpenVISOnline windows with ``model.clip_adapter.name=adapted`` (the
     mask-prompted ViT-B/16 of phase 11's file with a nonzero
     ``visual.mask_embedding``), their split printed beside phase 15's plain
     tower's, K1 on the first encoder layer's recorded inputs against its
     plain version; that window in f32 at 192x320, card against CPU (the
     test-tiny mask-prompted tower); SimpleBaselineOnline's ensemble with
     ``bg_adapted`` through the engine over phase 10's second video (K4 on
     its tracking costs against ``hungarian_plain``) and ``--eval-only`` of
     the recipe with that override over the same video; random RN50 and
     RN101 files in OpenAI's layout read by the port's reader: each tower's
     ms and TFLOP/s on a frame's 100 bf16 crops at 224, unmasked and masked
     (a quarter of the crops covered whole: NaN rows, as in JAX), in f32 on
     8 crops card against CPU with the NaN rows equal; RN50 as ``bg_adapted``
     through the ensemble engine, the segmenter's text width 1024

The line before the last lists every kernel with its launches on the train
path (phase 8; ``launches_by_path`` adds the eval path of phase 6, the
engine's whole-video run of phase 10, the CLI's training and eval runs of
phase 11, the ensemble's run of phase 12, SAN's window, train step,
engine and CLI runs of phase 13, BriVIS's of phase 14, OpenVIS's of phase 15,
the BURST engine and CLI runs of phase 16, the offline paths of phase 17,
OV2Seg's and the Swin recipes' of phase 18, MasQCLIP's of phase 19, the
FPN/SGD path's of phase 20, the Swin-L OpenVIS and LV-VIS paths' of phase
21 and the mask-adapted towers' of phase 22),
its error
against its plain version, its time (``ms``: the wrapper's call from CUDA
events; ``device_ms``: the kernel alone, from ``torch.profiler``), the plain
time, the yardstick library time where one PyTorch call computes the same
function, and its bound; the last line is ``{"ok": true, "device": {...}}``.
Imports no JAX.
"""

from __future__ import annotations

import atexit
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

from openvis_tpu_torch import Config, clip_towers, engine, train
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
from openvis_tpu_torch.evals import burst_eval, ytvis_eval
from openvis_tpu_torch.losses import criterion
from openvis_tpu_torch.models import clip_adapter
from openvis_tpu_torch.models.backbone.resnet import FrozenAffine
from openvis_tpu_torch.models.clip import synthetic as clip_synthetic
from openvis_tpu_torch.models.clip.model import model_shape
from openvis_tpu_torch.models.meta import brivis as brivis_meta
from openvis_tpu_torch.models.meta import masqclip as masqclip_meta
from openvis_tpu_torch.models.meta import ov2seg as ov2seg_meta
from openvis_tpu_torch.models import pixel_decoder
from openvis_tpu_torch.models.pixel_decoder import MSDeformAttnModule
from openvis_tpu_torch.models.position_encoding import position_encoding_2d
from openvis_tpu_torch.models.postprocess import inference_video_topk
from openvis_tpu_torch.models.segmenter import Segmenter
from openvis_tpu_torch.ops import cuda_build, hungarian_cuda, msda_cuda, point_sample_cuda
from openvis_tpu_torch.ops.hungarian import hungarian_plain
from openvis_tpu_torch.ops.msda import ms_deform_attn_bwd_plain, ms_deform_attn_plain
from openvis_tpu_torch.ops.point_sample import (
    KERNEL_MAX_HW,
    sample_maps_dvalue_plain,
    sample_maps_shared_plain,
    sorted_uniform_points,
)
from openvis_tpu_torch.parallel.train_step import (
    config_labels,
    global_norm,
    label_params,
    make_lr_schedule,
    make_optimizer,
    stop_frozen_gradients,
)
from openvis_tpu_torch.structures import ClipTargets
from openvis_tpu_torch.utils.image import resize_bilinear_torch_hw

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
    # the Swin-L OpenVIS recipe's matcher (200 queries, phase 21): 201
    # columns, above the warp solver's, so the block solver
    "matcher_200_queries": (20, 40, 200),
}
CHECK_FRAMES = 2     # phase 7 window
TIMING_ITERS = 20
PROFILE_WINDOWS = 4  # device_ms: profiler windows before it gives up
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
# the online engine runs of phases 12, 13 and 15 read the second video
# alone: their path through the engine is phase 10's, which reads all three
# (as do phase 14's BriVIS, for its resampler, phase 17's offline
# SimpleBaseline and phase 18's OV2Seg, for its EMA chain); the offline runs
# of phases 17 (OpenVIS and SAN) and 19 read the last two: a single shot of
# 19 -> 24 frames and the 133-frame video in windows of 128 (their windowed
# single shot). A run reads its videos through _engine_subset and warms up
# on the first of them.
ONLINE_ENGINE_VIDEOS = ENGINE_VIDEOS[1:2]
OFFLINE_ENGINE_VIDEOS = ENGINE_VIDEOS[1:]
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
# phase 12: SimpleBaselineOnline's CLIP ensemble over phase 10's dataset with
# the recipe's clip_adapter (CLI_CONFIG: bg_clip, ViT-B/16, the vild prompts,
# weight 0.5), random ViT-B/16 weights in OpenAI's layout from the seed and a
# tiny BPE merge file (neither OpenAI's weights nor its vocabulary are in the
# repository)
BF16_FLOPS = 989e12       # H100 SXM dense bf16 peak (the tower's products)
CLIP_TOWER_CROPS = 8      # the full-width tower in f32, card against CPU
# 12 blocks of f32 products (TF32 off) summed in another order on the card:
# the features within 1e-4 of their largest element
CLIP_TOWER_REL_TO_MAX = 1e-4
# the whole ensemble engine, card against CPU in f32, at the test-tiny CLIP
# shape (a ViT-B/16 on 700 crops would take minutes on the CPU) on phase
# 10's check video, held to phase 10's f32 bounds
ENSEMBLE_CHECK_CLIP = "test-tiny"
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
# phase 13: SANOnline with its recipe's model (ResNet-50, 6 encoder layers, the
# side-adapter decoder with 100 queries and 9+1 layers, a random ViT-B/16 split
# at block 9 with taps 3, 6, 9); the CLI trains it as users do (16 clips of 2
# frames a step) for SAN_CLI_STEPS steps
SAN_CONFIG = os.path.join("configs", "openvoc_ytvis_coco", "san_online_R50_bs16_6000st.yaml")
SAN_CLI_STEPS = 3
# the parameters SAN adds that train, each of which must move in a step (the
# tower under clip_adapter.visual must not)
SAN_TRAINED = ("clip_adapter.bg_embed", "clip_adapter.logit_scale",
               "clip_adapter.attn_proj0.weight",
               "segmenter.predictor.heads.attn_embed.layer0.weight")
# phase 14: BriVIS with its recipe's model (SAN's, its segmenter and
# clip_adapter frozen, and a temporal resampler of 6 layers with k5/k3
# convolutions) on clips of 3 frames (bench.py:147-148); the train step runs
# BRIVIS_TRAIN_STEPS steps under each matcher source, the CLI BRIVIS_CLI_STEPS
# steps from phase 13's SAN checkpoint, its matcher switching at half of them
BRIVIS_CONFIG = os.path.join("configs", "openvoc_ytvis_coco", "brivis_R50_bs16_6000st.yaml")
BRIVIS_T = 3
BRIVIS_TRAIN_STEPS = 2
BRIVIS_CLI_STEPS = 2
# the engine's other resamplers, each one f32 video card against CPU
BRIVIS_ENGINE_CHECKS = ("decoupled", "raw")
# parameters BriVIS trains, each of which must move in a step (segmenter.*
# and clip_adapter.* must not), and whose gradients phase 14.4 holds
BRIVIS_TRAINED = ("resampler.short0_conv1.weight", "resampler.long0.q_proj.weight",
                  "resampler.mask_embed.layer2.weight", "resampler.attn_embed.layer0.weight",
                  "brownian_proj.weight")
# phase 15: OpenVISOnline with its recipe's model (SimpleBaseline's segmenter
# with the class-agnostic proposal head; at eval every query's mask is cropped
# and classified by the frozen CLIP ViT-B/16 tower of clip_adapter.weights)
OPENVIS_CONFIG = os.path.join("configs", "openvoc_ytvis_coco",
                              "openvis_online_R50_bs16_6000st.yaml")
OPENVIS_CLI_STEPS = 2
# the window card against CPU in f32 runs the test-tiny tower (a ViT-B/16 on
# 200 crops in f32 would take minutes on the CPU), held to phase 7's bounds
OPENVIS_CHECK_CLIP = "test-tiny"
# phase 16: BURST evaluation (HOTA and TrackMAP over its 482 LVIS classes) of
# SANOnline with eval_burst.yaml's settings, over a synthetic BURST (TAO
# schema) dataset: sequences at TAO's common 720x1280 and 480x640, tracks
# that enter and leave
BURST_CONFIG = os.path.join("configs", "openvoc_ytvis_coco", "eval_burst.yaml")
BURST_DATASET = "synthetic_burst_val"
BURST_SEQUENCES = ((720, 1280, 24, 4), (480, 640, 30, 3), (720, 1280, 12, 2))
BURST_CHECK_SEQUENCE = (192, 320, 7, 3)   # card against CPU, f32, windows of 4
# phase 17: the offline (clip-level) archs with their recipes' models: the
# video decoder over the whole clip (one query set a clip, its cross-attention
# over the clip's T*h*w tokens a level), evaluated single-shot
OFFLINE_CONFIG = os.path.join("configs", "openvoc_ytvis_coco", "simplebsl_R50_bs8_12000st.yaml")
OPENVIS_OFFLINE_CONFIG = os.path.join("configs", "openvoc_ytvis_coco",
                                      "openvis_R50_bs16_6000st.yaml")
OPENVIS_FRAME_CONFIG = os.path.join("configs", "openvoc_ytvis", "openvis_R50_bs16_6000st.yaml")
SAN_OFFLINE_CONFIG = os.path.join("configs", "openvoc_ytvis_coco", "san_R50_bs16_6000st.yaml")
OFFLINE_CAP_T, OFFLINE_CAP_H, OFFLINE_CAP_W = 128, 480, 864  # test.max_frames, the canvas
OFFLINE_CHECK_T = 5       # 17.2: one shot padded to 8 frames, card against CPU
OFFLINE_CLI_STEPS = 2
# phase 18: OV2Seg with its recipe's model (ResNet-50, 6 encoder layers, 100
# queries, the two-head decoder with D = 512; tracked by its EMA chain, one K4
# launch a frame of the video padded to _bucket(T)), and the SAN Swin-B
# recipes (Swin-B: embed 128, depths 2-2-18-2, windows of 12; a random
# ViT-L/14@336px side CLIP split at block 21 with taps 6, 12, 18)
OV2SEG_CONFIG = os.path.join("configs", "openvoc_ytvis_coco", "ov2seg_online_R50.yaml")
OV2SEG_EMA_T = 133        # the engine's long video: _bucket(133) = 136 solves
OV2SEG_CLI_STEPS = 2
SWIN_DIR = os.path.join("configs", "openvoc_ytvis_coco", "swin")
SAN_SWIN_CONFIG = os.path.join(SWIN_DIR, "san_online_SwinB_bs16_6000st_ViT-L-336.yaml")
SAN_SWIN_OFFLINE_CONFIG = os.path.join(SWIN_DIR, "san_SwinB_bs16_6000st_ViT-L-336.yaml")
BRIVIS_SWIN_CONFIG = os.path.join(SWIN_DIR, "brivis_SwinB_bs16_6000st_ViT-L-336.yaml")
SWIN_CLIP = "ViT-L/14@336px"
# the recipes' pretrained/m2f_swinB.msgpack is not in the repository: the
# CLI trains from a stand-in (``_swin_init``), the offline eval needs none
SWIN_OVERRIDES = ("model.weights=",)
SWIN_WINDOW_H, SWIN_WINDOW_W = 480, 864   # min_size_test 480 on the 480x864 canvas
# the CLI as the reference trains it a card: 16 clips over 8 GPUs, 2 a card
SWIN_CLI_CLIPS, SWIN_CLI_STEPS = 2, 2
# phase 18's Swin-B CLIs (SAN online, san_SwinB, BriVIS) run the trunk cut to
# 2 blocks a stage (its widths, heads and windows kept): the full depth runs
# in 18.8-18.9 and in phase 21's Swin-L CLI
SWIN_CLI_OVERRIDES = ("model.backbone.swin_depths=[2,2,2,2]",)
# phase 19: MasQCLIP as the CLI builds it from the offline SimpleBaseline
# recipe, over the video proposal decoder (JAX tests/test_engine.py:249)
MASQ_OVERRIDES = ("model.meta_architecture=MasQCLIP",
                  "model.transformer_decoder.name=video_proposal")
MASQ_CLI_STEPS = 2
MASQ_CHECK_GRADS = ("clip_adapter.mask_embeddings", "clip_adapter.proj",
                    "clip_adapter.resblock0.attn.new_q_proj.weight",
                    "clip_adapter.resblock11.attn.new_q_proj.weight",
                    "clip_adapter.resblock5.mlp_c_fc.weight", "clip_adapter.ln_post.ln.weight")
# the f32 card-against-CPU checks: the SAN R50 recipe's ViT-B/16 split (phase
# 11's CLIP files) over the Swin-B trunk cut to 2 blocks a stage, drop path 0
SWIN_CHECK_OVERRIDES = ("model.backbone.name=swin", "model.backbone.swin_embed_dim=128",
                        "model.backbone.swin_depths=[2,2,2,2]",
                        "model.backbone.swin_num_heads=[4,8,16,32]",
                        "model.backbone.swin_window_size=12", "model.backbone.swin_pretrain_img_size=384",
                        "model.backbone.swin_drop_path_rate=0.0")
SWIN_TRAINED = ("segmenter.backbone.stage2_block17.attn.relative_position_bias_table",
                "segmenter.backbone.patch_embed.weight", "clip_adapter.attn_proj0.weight")
# phase 20: SimpleBaselineOnline-R50 from its recipe (CLI_CONFIG) with the
# FPN pixel decoder behind a DETR encoder over res5, trained with SGD
FPN_OVERRIDES = ("model.pixel_decoder.name=transformer_enc", "solver.optimizer=sgd")
FPN_CLI_STEPS, FPN_RESUME_STEPS = 2, 1
# 20.3: the one SGD step card against CPU at a rate whose updates (decay
# included) stand well above the f32 masters' rounding
FPN_CHECK_LR = 1.0
# f32, TF32 off, card against CPU: the same arithmetic in other orders through
# the segmenter (~60 layers) or the DETR transformer (12 layers)
ZERO_SHOT_REL_TO_MAX = 1e-3
DETR_REL_TO_MAX = 1e-4
# phase 21: the Swin-L OpenVIS recipe (offline OpenVIS over the frame_proposal
# head with 200 queries; Swin-L: embed 192, depths 2-2-18-2, heads 6-12-24-48,
# windows of 12; at eval the mask adapter's frozen ViT-L/14@336px, phase 18's
# file), evaluated single-shot as the engine runs the offline archs; then
# eval_lvvis.yaml (SANOnline over lvvis_val's 1196 classes) through the CLI
OPENVIS_SWINL_CONFIG = os.path.join(SWIN_DIR, "openvis_swinL_bs16_6000st_ViT-L-336.yaml")
LVVIS_CONFIG = os.path.join("configs", "openvoc_ytvis_coco", "eval_lvvis.yaml")
LVVIS_DATASET = "lvvis_val"
# synthetic LV-VIS val videos at its common 720x1280 and 480x640 (instances of
# the 1196 categories), written in lvvis_val's own layout
LVVIS_VIDEOS = ((720, 1280, 24, 3), (480, 640, 19, 2))
# the f32 card-against-CPU check: Swin-L's widths, heads and windows, cut to
# 2 blocks a stage, drop path 0
SWINL_CHECK_OVERRIDES = ("model.backbone.swin_depths=[2,2,2,2]",
                         "model.backbone.swin_drop_path_rate=0.0")
SWINL_TRAINED = ("segmenter.backbone.stage2_block17.attn.relative_position_bias_table",
                 "segmenter.backbone.patch_embed.weight",
                 "segmenter.predictor.heads.class_embed.weight")


# phase 22: the mask-adapted towers
ADAPTED_RN_TOWERS = ("RN50", "RN101")
ADAPTED_RN_CROPS = 100        # a frame's crops, timed in bf16
ADAPTED_RN_CHECK_CROPS = 8    # f32, card against CPU
ADAPTED_RN_REL_TO_MAX = 1e-4  # CLIP_TOWER_REL_TO_MAX: TF32 off, the same arithmetic

_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _START}
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
    host work or its other launches (zeroing, casts).

    The profiler may drop kernel events of a window (one at its edge is
    common; H100 runs saw 8 of 20, in every window of one run), so a window
    that saw fewer than half of the calls' launches, or more launches than
    calls, is profiled again, up to ``PROFILE_WINDOWS`` times, then in
    windows of a quarter as many calls.  A line beside the reading gives the
    window it came from and the (calls, launches seen) of those refused."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    seen = []
    for calls in (iters, max(2, iters // 4)):
        for _ in range(PROFILE_WINDOWS):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            us = [e.time_range.end - e.time_range.start for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
            if calls // 2 <= len(us) <= calls:
                ms = sum(us) / len(us) / 1e3
                emit({"phase": "device_ms_window", "kernel": kernel, "device_ms": ms,
                      "calls": calls, "launches_seen": len(us), "windows_refused": seen})
                return ms
            seen.append((calls, len(us)))
    raise AssertionError(f"the profiler saw (calls, launches of {kernel}) {seen}")


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


def _text(rng, dim=TEXT_DIM, k=K_CLASSES):
    text = rng.randn(k, dim).astype(np.float32)
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
    cfg = _full_config()
    cpu_model = init_params(train.build_model(cfg, device="cpu"), seed=SEED + 1)
    _hold_window_to_plain("slice_kernels_vs_plain", cfg, cpu_model, FRAME_H, FRAME_W)


def _hold_window_to_plain(phase, cfg, cpu_model, h, w, make_eval=None, text_dim=None,
                          frames=CHECK_FRAMES, kernels=("msda_fwd", "hungarian")):
    """Phase 7's comparison: one f32 window of ``frames`` frames at (h, w)
    through ``make_eval_fn`` of ``cpu_model`` on the CPU (plain) and of a copy
    on the card (kernels), TF32 off.  ``make_eval(model, device)``: another
    window function (frames, text) -> top-k; ``text_dim``: its text width;
    ``kernels``: those the card's window must launch (the offline archs
    track nothing: no K4)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    make_eval = make_eval or (lambda model, device: train.make_eval_fn(cfg, model))
    cpu_model = cpu_model.eval()
    gpu_model = copy.deepcopy(cpu_model).to(DEVICE)
    rng = np.random.RandomState(SEED + 1)
    t = frames
    frames = torch.from_numpy(rng.randn(t, h, w, 3).astype(np.float32))
    text = torch.from_numpy(_text(rng) if text_dim is None else _text(rng, text_dim))
    t0 = time.perf_counter()
    ref = make_eval(cpu_model, "cpu")(frames, text)
    cpu_s = time.perf_counter() - t0
    reset_counts()
    got = {k: v.cpu() for k, v in make_eval(gpu_model, DEVICE)(
        frames.to(DEVICE), text.to(DEVICE)).items()}
    launches = read_counts()
    q = cfg.model.transformer_decoder.num_queries
    _check_outputs(got, q, K_CLASSES, t, h, w, phase)
    score_err = (got["scores"] - ref["scores"]).abs().max().item()
    same_pairs = bool(torch.equal(got["labels"], ref["labels"])
                      and torch.equal(got["query_idx"], ref["query_idx"]))
    mref, mgot = ref["mask_logits"], got["mask_logits"]
    mask_rel = ((mgot - mref).abs().max() / mref.abs().max()).item()
    sign_agree = ((mgot > 0) == (mref > 0)).float().mean().item()
    emit({"phase": phase, "dtype": "float32", "tf32": False,
          "frames": t, "frame_hw": [h, w],
          "max_abs_score_err": score_err, "labels_and_query_idx_equal": same_pairs,
          "mask_max_err_rel_to_max": mask_rel, "mask_sign_agree": sign_agree,
          "kernel_launches": launches, "cpu_s": cpu_s,
          "tol": {"score_atol": SLICE_SCORE_ATOL, "mask_rel_to_max": SLICE_MASK_REL_TO_MAX,
                  "sign_agree": SLICE_SIGN_AGREE}})
    if not (same_pairs and score_err <= SLICE_SCORE_ATOL
            and mask_rel <= SLICE_MASK_REL_TO_MAX and sign_agree >= SLICE_SIGN_AGREE):
        raise AssertionError(f"{phase}: the kernel window disagrees with the plain window")
    if any(launches[k] == 0 for k in kernels):
        raise AssertionError(f"{phase}: the card's window skipped a kernel: {launches}")


def _train_batch(rng, h, w, n, device, t=TRAIN_T, text_dim=TEXT_DIM):
    """bench.py's synthetic train batch: 1 clip of ``t`` frames, n targets
    with 10 % foreground masks, all valid; text rows ``text_dim`` wide."""
    pixels = torch.from_numpy(rng.randn(1, t, h, w, 3).astype(np.float32))
    targets = ClipTargets(
        labels=torch.from_numpy(rng.randint(0, K_CLASSES, (1, n))),
        masks=torch.from_numpy(rng.rand(1, n, t, h, w) > 0.9),
        valid=torch.ones(1, n, dtype=torch.bool),
        frame_valid=torch.ones(1, n, t, dtype=torch.bool),
    )
    return {"pixels": pixels.to(device), "targets": targets.to(device),
            "text_feats": torch.from_numpy(_text(rng, text_dim)).to(device)}


def _msda_layers(cfg) -> int:
    """K1's launches a forward: one an encoder layer of the deformable pixel
    decoder; the FPN decoders (``fpn``, ``transformer_enc``) run no MSDA."""
    pd = cfg.model.pixel_decoder
    return pd.transformer_enc_layers if pd.name == "msdeform" else 0


def _train_launches(cfg, h, w, steps, t=TRAIN_T):
    """K1-K6 launches of ``steps`` train steps on an (h, w) canvas: per
    decoder layer K5 samples the masks for the matcher and for the two loss
    point sets (and, at most KERNEL_MAX_HW pixels, the targets at the same
    three), K6 takes the two loss samplings' gradients; K4 once a step.
    BriVIS (clips of ``t`` frames, stacked into one tall frame): the frozen
    encoder has no backward (no K2/K3); K4 tracks and matches (twice a
    step); one matching, on one layer, and the two loss samplings of each of
    the image layer and the resampler's L+1 layers; K6 for the resampler's
    layers only (the image layer is frozen).  MasQCLIP: K1 in the forward,
    K5 in ``label_assign``, nothing else."""
    enc = _msda_layers(cfg)
    if cfg.model.meta_architecture == "BriVIS":
        layers = cfg.model.resampler.num_layers + 1
        targets = 2 if t * h * w <= KERNEL_MAX_HW else 1
        per_step = {"msda_fwd": enc, "msda_dcoord": 0, "msda_dvalue": 0, "hungarian": 2,
                    "point_sample_fwd": (1 + 2 * (layers + 1)) * targets,
                    "point_sample_dvalue": 2 * layers}
        return {k: v * steps for k, v in per_step.items()}
    if cfg.model.meta_architecture == "MasQCLIP":
        # the segmenter's forward without a graph; label_assign samples the
        # predicted masks once, and the targets too where they fit K5
        return {**{k: 0 for k in read_counts()}, "msda_fwd": enc * steps,
                "point_sample_fwd": (1 + int(h * w <= KERNEL_MAX_HW)) * steps}
    layers = cfg.model.transformer_decoder.dec_layers + 1
    target_samplings = 3 if h * w <= KERNEL_MAX_HW else 0
    per_step = {"msda_fwd": enc, "msda_dcoord": enc, "msda_dvalue": enc, "hungarian": 1,
                "point_sample_fwd": (3 + target_samplings) * layers,
                "point_sample_dvalue": 2 * layers}
    return {k: v * steps for k, v in per_step.items()}


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
    expected = _train_launches(cfg, TRAIN_H, TRAIN_W, TRAIN_STEPS)
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


def _loss_and_grads(cfg, model, batch, records, assign=None):
    """Loss, metrics, gradients of the trainable parameters and the matcher's
    (cost, assignment) pairs, in ``records``, of one f32 train-step forward
    and backward.  ``assign``: the assignments, in call order, that the loss
    takes in place of the matcher's own (which are still recorded)."""
    stop_frozen_gradients(model, config_labels(cfg, model))
    loss_fn = train.make_loss_fn(cfg, model, K_CLASSES)
    params = dict(model.named_parameters())
    names = [n for n, p in params.items() if p.requires_grad]
    solve = criterion.batched_hungarian

    def recording(cost):
        cols = solve(cost)
        records.append((cost.cpu(), cols.cpu()))
        return cols if assign is None else assign[len(records) - 1].to(cols.device)

    criterion.batched_hungarian = ov2seg_meta.batched_hungarian = recording
    try:
        loss, metrics = loss_fn(params, batch, torch.Generator().manual_seed(SEED))
    finally:
        criterion.batched_hungarian = ov2seg_meta.batched_hungarian = solve
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    return loss.item(), {k: v.item() for k, v in metrics.items()}, dict(zip(names, grads))


def _hold_update_to_plain(phase, cfg, cpu_model, gpu_model, ref_g, got_g, check_params):
    """One step of ``make_optimizer(cfg, ...)`` on the CPU model from the CPU's
    gradients and on the card's from the card's (``_hold_train_to_plain``:
    the same assignments); the parameters after it: the update of each of
    ``check_params`` held to the CPU's relative to its largest element (the
    gradients' bound) beyond the rounding of the new f32 masters, each of
    them moved, the frozen parameters unmoved on both sides."""
    masters = {n: p.detach().clone() for n, p in cpu_model.named_parameters()}
    updates, kinds = [], []
    for model, grads in ((cpu_model, ref_g), (gpu_model, got_g)):
        labels = config_labels(cfg, model)
        params = dict(model.named_parameters())
        before = {n: p.detach().clone() for n, p in params.items()}
        opt = make_optimizer(cfg, params, labels)
        opt.step(params, {n: grads[n] for n in opt.hyper})
        updates.append({n: (p.detach() - before[n]).cpu() for n, p in params.items()})
        kinds.append(type(opt).__name__)
    ref_u, got_u = updates
    frozen = [n for n, g in config_labels(cfg, cpu_model).items() if g == "frozen"]
    frozen_moved = [n for n in frozen if ref_u[n].any() or got_u[n].any()]
    # the key projections' biases: their exact gradient is 0 (softmax is
    # shift-invariant), so both sides update them by rounding noise alone,
    # held below a thousandth of the largest update
    noise = [n for n in ref_u if n.endswith("k_proj.bias")]
    largest = max(u.abs().max().item() for u in ref_u.values())
    noise_max = max((max(ref_u[n].abs().max().item(), got_u[n].abs().max().item())
                     for n in noise), default=0.0)
    # each side rounds its new masters to f32, so equal updates may read an
    # ulp of the parameter apart (phase 20.4's bound)
    eps = torch.finfo(torch.float32).eps
    rel = {n: _rel_to_max(got_u[n], ref_u[n], 2 * eps * (masters[n].abs() + ref_u[n].abs()))
           for n in check_params}
    held_unmoved = [n for n in check_params if not ref_u[n].any()]
    moved = sum(int(u.any()) for n, u in ref_u.items() if n not in frozen)
    unmoved = [n for n, u in ref_u.items() if n not in frozen and not u.any()]
    worst = sorted(rel.items(), key=lambda kv: -kv[1])
    emit({"phase": f"{phase}_update", "optimizer": kinds, "lr": cfg.solver.base_lr,
          "tensors_moved": moved, "tensors_unmoved": unmoved[:5],
          "frozen": len(frozen), "frozen_moved": frozen_moved[:5],
          "update_tensors_held": len(rel),
          "update_max_err_beyond_rounding_rel_to_max": dict(worst[:8]),
          "k_proj_bias_update_max_rel_to_largest": noise_max / largest,
          "tol": {"rel_to_max": TRAIN_GRAD_REL_TO_MAX, "k_proj_bias_rel_to_largest": 1e-3}})
    if frozen_moved or held_unmoved or worst[0][1] > TRAIN_GRAD_REL_TO_MAX \
            or noise_max > 1e-3 * largest:
        raise AssertionError(f"{phase}: the card's {kinds[1]} update disagrees with the CPU's")


def _offsets_off_centres(model, seed):
    """Move every encoder sample off the pixel centres where the ring-bias
    init puts it: there the bilinear slope is one-sided and an ulp picks the
    side."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MSDeformAttnModule):
                m.sampling_offsets.weight.copy_(
                    torch.randn(m.sampling_offsets.weight.shape, generator=gen) * 0.02)
    return model


def phase_train_vs_plain():
    """One f32 train-step loss and gradient: card (kernels) vs CPU (plain),
    from the same weights and the same criterion points (drawn on a CPU
    generator on both sides)."""
    cfg = _full_config(amp=False)
    cpu_model = init_params(train.build_model(cfg, device="cpu"), seed=SEED + 2)
    _hold_train_to_plain("train_kernels_vs_plain", cfg, _offsets_off_centres(cpu_model, SEED + 2),
                         TRAIN_CHECK_PARAMS)


def _hold_train_to_plain(phase, cfg, cpu_model, check_params, t=TRAIN_T):
    """Phase 9's comparison of ``cpu_model`` (f32) on the CPU and a copy on
    the card, with the gradients of ``check_params`` held element for
    element, on a clip of ``t`` frames; every kernel of the path (BriVIS's
    has no K2/K3) must launch.  The CPU's loss takes the card's matcher
    assignments, each held to the CPU's own optimum within HUNGARIAN_RTOL of
    its cost: at a near-tie the two matchers may pick different ones, and
    the losses' gradients would then differ beyond any bound.  Returns the
    card's model and the (CPU, card) gradients."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the CPU side's oneDNN f32 convolution weight-gradient differs from a
    # float64 run by up to 1.5 % of its largest element in one ResNet layer;
    # PyTorch's own CPU convolution does not
    torch.backends.mkldnn.enabled = False
    gpu_model = copy.deepcopy(cpu_model).to(DEVICE)
    batch = _train_batch(np.random.RandomState(SEED + 2), CHECK_TRAIN_H, CHECK_TRAIN_W,
                         CHECK_TRAIN_N, "cpu", t)
    gpu_batch = {"pixels": batch["pixels"].to(DEVICE), "targets": batch["targets"].to(DEVICE),
                 "text_feats": batch["text_feats"].to(DEVICE)}
    ref_rec, got_rec = [], []
    reset_counts()
    got_loss, got_m, got_g = _loss_and_grads(cfg, gpu_model, gpu_batch, got_rec)
    torch.cuda.synchronize()
    launches = read_counts()
    t0 = time.perf_counter()
    ref_loss, ref_m, ref_g = _loss_and_grads(cfg, cpu_model, batch, ref_rec,
                                             assign=[cols for _, cols in got_rec])
    cpu_s = time.perf_counter() - t0
    ref_norm = global_norm(ref_g.values()).item()
    got_norm = global_norm(t.cpu() for t in got_g.values()).item()
    losses = {"total": (got_loss, ref_loss), **{k: (got_m[k], ref_m[k]) for k in ref_m}}
    loss_rel = {k: abs(a - b) / max(abs(b), 1e-30) for k, (a, b) in losses.items()}
    grad_rel = {name: _rel_to_max(got_g[name], ref_g[name]) for name in check_params}
    same_assign = all(torch.equal(r, g) for (_, r), (_, g) in zip(ref_rec, got_rec))
    cost_gap = 0.0
    for (cost, ref_cols), (_, got_cols) in zip(ref_rec, got_rec):
        rows = torch.arange(cost.shape[1])
        for c, a, b in zip(cost.double(), got_cols, ref_cols):
            best = c[rows, b].sum().item()
            cost_gap = max(cost_gap, abs(c[rows, a].sum().item() - best) / max(abs(best), 1e-30))
    worst = sorted(grad_rel.items(), key=lambda kv: -kv[1])
    emit({"phase": phase, "dtype": "float32", "tf32": False,
          "batch": [1, t, CHECK_TRAIN_H, CHECK_TRAIN_W], "targets": CHECK_TRAIN_N,
          "losses_kernel_plain": losses, "loss_rel_err": loss_rel,
          "grad_norm_kernel_plain": [got_norm, ref_norm],
          "grad_norm_rel_err": abs(got_norm - ref_norm) / ref_norm,
          "grad_tensors_held": len(grad_rel), "grad_max_err_rel_to_max": dict(worst[:8]),
          "matcher_calls": len(got_rec), "assignments_equal": same_assign,
          "assignment_cost_rel_gap": cost_gap, "kernel_launches": launches,
          "cpu_seconds": cpu_s,
          "tol": {"loss_rtol": TRAIN_LOSS_RTOL, "grad_norm_rtol": TRAIN_GRAD_NORM_RTOL,
                  "grad_rel_to_max": TRAIN_GRAD_REL_TO_MAX,
                  "assignment_cost_rtol": HUNGARIAN_RTOL}})
    torch.backends.mkldnn.enabled = True
    if not (all(v <= TRAIN_LOSS_RTOL for v in loss_rel.values())
            and abs(got_norm - ref_norm) <= TRAIN_GRAD_NORM_RTOL * ref_norm
            and all(v <= TRAIN_GRAD_REL_TO_MAX for v in grad_rel.values())
            and len(ref_rec) == len(got_rec) and cost_gap <= HUNGARIAN_RTOL):
        raise AssertionError("the kernel train step disagrees with the plain train step")
    path = _train_launches(cfg, CHECK_TRAIN_H, CHECK_TRAIN_W, 1, t)
    if any(launches[k] == 0 for k, n in path.items() if n):
        raise AssertionError(f"the card's train step skipped a kernel: {launches}")
    return gpu_model, ref_g, got_g


def _rel_to_max(got, ref, slack=0.0) -> float:
    """max |got - ref| beyond ``slack`` (elementwise) over max |ref| (0 where
    both are all zero)."""
    err = ((got.cpu() - ref).abs() - slack).clamp(min=0).max().item()
    top = ref.abs().max().item()
    return err / top if top else (0.0 if err == 0 else float("inf"))


class EngineSpans:
    """Wraps the eval engine's stages for one ``evaluate_dataset`` run: host
    seconds of the mapper (``data``), of the evaluator's ``process`` (or the
    BURST evaluator's ``process_video``) and, in it, of resize + threshold +
    the masks' copy (``threshold``) and of the RLE encoding (``rle``), and of
    ``_finalize`` (with BURST: its ``evaluate``, and in it ``hota_for_class``)
    and, in the evaluation, of the RLE strings' decoding and of
    ``YTVOSEval.accumulate`` (the IoUs and the matching);
    CUDA events around each model window and around tracking + top-k (device
    time), and around each single shot and single-shot window of the offline
    archs (their forward, scores and, without the ensemble, top-k); the frames; and each prediction with the track (frame-0 query) it
    came from and each video's track indices (T, Q), left on the device until
    ``track_indices``.  With the mask-crop CLIP scoring (SimpleBaseline's
    ensemble, OpenVIS): CUDA events around each video's scoring (tracking,
    CLIP crop scores, the scores and top-k), around its CLIP crop scoring and
    around each ``roi_crop``."""

    PATCHED = ((engine, "test_videos"), (engine, "make_window_fn"),
               (engine, "make_postprocess_fn"), (engine, "_finalize"),
               (ytvis_eval, "threshold_masks"), (burst_eval, "threshold_masks"),
               (rle, "encode_transposed"), (ytvis_eval.YTVISEvaluator, "process"),
               (burst_eval.BURSTEvaluator, "process_video"), (engine, "track_by_embeds"),
               (engine, "make_ensemble_fn"), (engine, "make_openvis_fn"),
               (clip_towers, "clip_crop_scores"), (clip_adapter, "roi_crop"),
               (burst_eval.BURSTEvaluator, "evaluate"), (burst_eval, "hota_for_class"),
               (rle, "string_to_counts"), (ytvis_eval.YTVOSEval, "accumulate"),
               (engine, "make_single_shot_fn"), (engine, "make_single_shot_window_fn"))

    def __enter__(self):
        self.host = collections.Counter()
        self.events = {"windows": [], "tracking_topk": [], "ensemble_topk": [],
                       "openvis_topk": [], "clip_crops": [], "roi_crop": [],
                       "single_shot": [], "single_shot_windows": []}
        self.frames, self.preds = 0, []   # preds: (video, track, category, score, segs)
        self._tracks = []
        self._orig = {key: getattr(*key) for key in self.PATCHED}
        orig = {name: fn for (_, name), fn in self._orig.items()}

        def host_timed(key, fn):
            def timed(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.host[key] += time.perf_counter() - t0
            return timed

        def events_around(key, fn):
            def timed(*a, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*a, **kw)
                end.record()
                self.events[key].append((start, end))
                return out
            return timed

        def event_timed(key, make):
            def made(*args, **kwargs):
                return events_around(key, make(*args, **kwargs))
            return made

        def test_videos(*args):
            items = orig["test_videos"](*args)
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

        def recording(process):
            def record_process(ev, video_id, topk_out, *args, **kwargs):
                n0 = len(ev.predictions)
                host_timed("process", process)(ev, video_id, topk_out, *args, **kwargs)
                threshold = getattr(ev, "score_threshold", None)
                kept = [q for q, sc in zip(topk_out["query_idx"].tolist(),
                                           topk_out["scores"].float().tolist())
                        if threshold is None or sc > threshold]
                # the BURST evaluator keeps no query order (it drops empty tracks)
                for pred in ev.predictions[n0:]:
                    q = kept.pop(0) if threshold is not None else None
                    self.preds.append((video_id, q, pred["category_id"], pred["score"],
                                       pred["segmentations"]))
            return record_process

        def record_track(embeds, *args, **kwargs):
            indices = orig["track_by_embeds"](embeds, *args, **kwargs)
            self._tracks.append(indices[0])
            return indices

        patches = {
            "test_videos": test_videos,
            "make_window_fn": event_timed("windows", orig["make_window_fn"]),
            "make_postprocess_fn": event_timed("tracking_topk", orig["make_postprocess_fn"]),
            "_finalize": host_timed("finalize", orig["_finalize"]),
            "threshold_masks": host_timed("threshold", orig["threshold_masks"]),
            "encode_transposed": host_timed("rle", orig["encode_transposed"]),
            "process": recording(orig["process"]),
            "process_video": recording(orig["process_video"]),
            "track_by_embeds": record_track,
            "make_ensemble_fn": event_timed("ensemble_topk", orig["make_ensemble_fn"]),
            "make_openvis_fn": event_timed("openvis_topk", orig["make_openvis_fn"]),
            "clip_crop_scores": events_around("clip_crops", orig["clip_crop_scores"]),
            "roi_crop": events_around("roi_crop", orig["roi_crop"]),
            "evaluate": host_timed("burst_evaluate", orig["evaluate"]),
            "hota_for_class": host_timed("hota", orig["hota_for_class"]),
            "string_to_counts": host_timed("rle_decode", orig["string_to_counts"]),
            "accumulate": host_timed("ytvos_accumulate", orig["accumulate"]),
            "make_single_shot_fn": event_timed("single_shot", orig["make_single_shot_fn"]),
            "make_single_shot_window_fn": event_timed("single_shot_windows",
                                                      orig["make_single_shot_window_fn"]),
        }
        for obj, name in self.PATCHED:
            setattr(obj, name, patches[name])
        return self

    def __exit__(self, *exc):
        for (obj, name), fn in self._orig.items():
            setattr(obj, name, fn)

    def device_seconds(self, key) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events[key]) / 1e3

    def track_indices(self):
        """Each video's (T, Q) track indices on the host, in video order."""
        return [t.cpu() for t in self._tracks]


def _one_thread():
    torch.set_num_threads(1)


_PLAIN_POOL = None


def _plain_pool() -> ProcessPoolExecutor:
    """The pool of spawned processes, one a core, that every K4 plain check
    shares: a process takes ~8 s to start (it imports torch and the port), and
    the script makes a dozen such checks.  ``main`` shuts it down."""
    global _PLAIN_POOL
    if _PLAIN_POOL is None:
        _PLAIN_POOL = ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                                          mp_context=multiprocessing.get_context("spawn"),
                                          initializer=_one_thread)
    return _PLAIN_POOL


def _plain_assignments(costs):
    """``hungarian_plain`` of every problem of ``costs`` (a list of (B, N, M)),
    with its Dijkstra steps: one problem is a long chain of small torch
    operations, so the problems go to the pool of processes."""
    problems = [c for cost in costs for c in cost]
    return list(_plain_pool().map(functools.partial(hungarian_plain, return_steps=True),
                                  problems, chunksize=4))


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


def _engine_run(cfg, model, text, device, clip_visual_apply=None, videos=ENGINE_VIDEOS):
    """One evaluate_dataset over ``videos`` of the registered ENGINE_DATASET
    (``_engine_subset``): (metrics, spans, wall seconds, launches)."""
    dataset = _engine_subset(videos)
    reset_counts()
    with EngineSpans() as spans:
        t0 = time.perf_counter()
        metrics = engine.evaluate_dataset(cfg, model, dataset, text,
                                          clip_visual_apply=clip_visual_apply, device=device)
        wall = time.perf_counter() - t0
    return metrics, spans, wall, read_counts()


def _engine_warm_up(cfg, model, text, clip_visual_apply=None, dataset=None):
    """One engine run over the first video of ``dataset`` (ENGINE_DATASET's
    unless given): cuDNN's and cuBLAS's choices, the allocator; then the
    peak is reset."""
    engine.evaluate_dataset(dataclasses.replace(cfg, output_dir=cfg.output_dir + "_warm"),
                            model, dataset or ENGINE_DATASET, text, max_videos=1,
                            clip_visual_apply=clip_visual_apply, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def _engine_subset(videos):
    """The name of a dataset that holds ``videos`` (entries of ENGINE_VIDEOS)
    of ENGINE_DATASET: ENGINE_DATASET itself for all of them, else the same
    frames under annotations cut to those videos (written once a run beside
    the dataset's own, registered under their ids)."""
    if tuple(videos) == ENGINE_VIDEOS:
        return ENGINE_DATASET
    src, info, _, _ = _ENGINE_DATA
    ids = [ENGINE_VIDEOS.index(v) + 1 for v in videos]
    tag = "_".join(map(str, ids))
    json_file = os.path.join(os.path.dirname(info.json_file), f"annotations_{tag}.json")
    if not os.path.exists(os.path.join(src, json_file)):
        with open(os.path.join(src, info.json_file)) as f:
            js = json.load(f)
        js["videos"] = [v for v in js["videos"] if v["id"] in ids]
        js["annotations"] = [a for a in js["annotations"] if a["video_id"] in ids]
        with open(os.path.join(src, json_file), "w") as f:
            json.dump(js, f)
    name = f"{ENGINE_DATASET}_{tag}"
    catalog.register(dataclasses.replace(info, name=name, json_file=json_file))
    return name


def _engine_split(spans, wall):
    """The run's seconds by stage (host clock; device stages by CUDA events)."""
    data, process = spans.host["data"], spans.host["process"]
    return {
        "data_mapper_host": data,
        "model_windows_device": spans.device_seconds("windows"),
        "tracking_topk_device": spans.device_seconds("tracking_topk"),
        "process_host": process,
        "resize_threshold_copy_host": spans.host["threshold"],
        "rle_host": spans.host["rle"],
        "wait_for_topk_host": process - spans.host["threshold"] - spans.host["rle"],
        "finalize_evaluate_host": spans.host["finalize"],
        "rle_string_decode_host": spans.host["rle_decode"],
        "ytvos_accumulate_host": spans.host["ytvos_accumulate"],
        "other_host": wall - data - process - spans.host["finalize"],
    }


def _engine_expected(cfg, launches, videos=None):
    """K1 once an encoder layer a forward, no other kernel but K4 once a
    tracked video of more than one frame (OV2Seg: ``_bucket(t)`` times, its
    EMA chain); ``videos`` (h, w, frames,
    instances) default to ENGINE_VIDEOS.  The windowed path runs a forward
    a window; the single-shot path (the offline archs) one a video of
    ``_bucket(t) <= test.max_frames`` frames, else one a window, and tracks
    nothing."""
    videos = ENGINE_VIDEOS if videos is None else videos
    window = engine.window_size(cfg)
    enc = _msda_layers(cfg)
    if engine.is_single_shot(cfg.model.meta_architecture):
        shots = sum(1 if engine._bucket(t) <= cfg.model.test.max_frames else -(-t // window)
                    for _, _, t, _ in videos)
        return {**{k: 0 for k in launches}, "msda_fwd": enc * shots}
    # OV2Seg's EMA chain: one solve a frame of the video padded to _bucket(t)
    tracked = ((lambda t: engine._bucket(t)) if cfg.model.meta_architecture.startswith("OV2Seg")
               else (lambda t: int(t > 1)))
    return {**{k: 0 for k in launches},
            "msda_fwd": enc * sum(-(-t // window) for _, _, t, _ in videos),
            "hungarian": sum(tracked(t) for _, _, t, _ in videos)}


_ENGINE_DATA = None  # (directory, info, categories, seconds): written once a run


def _write_engine_dataset(root):
    """Phase 10's synthetic dataset (the YTVIS-2019 categories) under
    ``root``, registered as ENGINE_DATASET; returns its categories and the
    seconds its write took.  It is written once a run (a dozen phases read
    it, 2-5 s a write) into a directory removed at exit, and linked into
    each ``root``: the engine reads the same files."""
    global _ENGINE_DATA
    if _ENGINE_DATA is None:
        cats = catalog.category_table("ytvis_2019_val")
        src = tempfile.mkdtemp(prefix="chip_smoke_engine_data_")
        atexit.register(shutil.rmtree, src, True)
        t0 = time.perf_counter()
        info = synthetic.write_ytvis_dataset(src, "synth", ENGINE_VIDEOS, cats, seed=SEED)
        _ENGINE_DATA = (src, info, cats, time.perf_counter() - t0)
    src, info, cats, seconds = _ENGINE_DATA
    for name in os.listdir(src):
        os.symlink(os.path.join(src, name), os.path.join(root, name))
    catalog.register(dataclasses.replace(info, name=ENGINE_DATASET))
    return cats, seconds


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
        cats, write_s = _write_engine_dataset(root)
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
        expected = _engine_expected(cfg, launches)
        expected_w = {**expected,
                      "msda_fwd": enc * sum(-(-t // ENGINE_WINDOW) for _, _, t, _ in ENGINE_VIDEOS)}
        split = _engine_split(spans, wall)
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


def _write_check_video(root, cats):
    """Phase 10's f32 check video under ``root``, registered; returns its
    dataset's name."""
    name = ENGINE_DATASET + "_check"
    catalog.register(dataclasses.replace(
        synthetic.write_ytvis_dataset(root, "check", [ENGINE_CHECK_VIDEO], cats, seed=SEED + 3),
        name=name))
    return name


def _check_config(cfg, root, name):
    """``cfg`` evaluating the check video ``name`` under ``root`` in f32, in
    windows of ENGINE_CHECK_WINDOW, its canvas cut to the video's size."""
    h, w = ENGINE_CHECK_VIDEO[:2]
    test = dataclasses.replace(cfg.model.test, window_inference=True,
                               window_size=ENGINE_CHECK_WINDOW, amp=False)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, test=test),
        input=dataclasses.replace(cfg.input, min_size_test=h, pad_size=(h, w)),
        datasets=dataclasses.replace(cfg.datasets, root=root, test=(name,)))


def phase_engine_vs_plain(root, cats, clip_weights=None):
    """One short f32 video through the engine on the card (kernels) and on
    the CPU (plain), from one model; with ``clip_weights`` (a test-tiny CLIP
    checkpoint) through the recipe's CLIP ensemble, the model's text width
    cut to the tower's."""
    name = _write_check_video(root, cats)
    base = _check_config(_engine_config(root), root, name)
    dim = TEXT_DIM
    if clip_weights is not None:
        dim = model_shape(ENSEMBLE_CHECK_CLIP)["embed_dim"]
        ca = dataclasses.replace(load_config(CLI_CONFIG).model.clip_adapter,
                                 clip_model_name=ENSEMBLE_CHECK_CLIP, weights=clip_weights)
        base = dataclasses.replace(base, model=dataclasses.replace(
            base.model, clip_adapter=ca, transformer_decoder=dataclasses.replace(
                base.model.transformer_decoder, clip_embed_dim=dim)))
    model = init_params(train.build_model(base, device="cpu"), seed=SEED + 3)
    text = _text(np.random.RandomState(SEED + 3), dim)
    _hold_engine_to_plain("engine_kernels_vs_plain" if clip_weights is None else
                          "ensemble_kernels_vs_plain", base, model, text, name, root,
                          clip=clip_weights is not None,
                          extra={"clip": None if clip_weights is None else ENSEMBLE_CHECK_CLIP})


def _hold_engine_to_plain(phase, base, model, text, name, root, clip=False,
                          kernels=("msda_fwd", "hungarian"), extra=None):
    """The engine with ``base`` over the check video ``name``, f32, on the card
    (kernels) and on the CPU (plain), from one model, held to phase 10's f32
    bounds; ``clip``: through the CLIP tower of ``base``'s clip_adapter;
    ``kernels``: those the card's run must launch.  Returns the card run's
    launches and its K4 recorder."""
    runs, tracking = {}, None
    for device in ("cpu", DEVICE):
        cfg = dataclasses.replace(base, output_dir=os.path.join(root, f"{phase}_{device}"))
        visual = clip_towers.build_clip_visual(cfg, device) if clip else None
        reset_counts()
        t0 = time.perf_counter()
        with HungarianRecorder() as tracking:
            metrics = engine.evaluate_dataset(cfg, model, name, text, clip_visual_apply=visual,
                                              device=device)
        seconds = time.perf_counter() - t0
        with open(os.path.join(cfg.output_dir, f"results_{name}.json")) as f:
            runs[device] = (metrics, json.load(f), seconds, read_counts())
    (m_ref, p_ref, s_ref, _), (m_got, p_got, s_got, launches) = runs["cpu"], runs[DEVICE]
    same = [(p["category_id"]) for p in p_got] == [(p["category_id"]) for p in p_ref]
    score_err = max((abs(a["score"] - b["score"]) for a, b in zip(p_got, p_ref)), default=0.0)
    agree = min((_masks_agree(a["segmentations"], b["segmentations"])
                 for a, b in zip(p_got, p_ref)), default=1.0)
    metric_err = max(abs(m_got[k] - m_ref[k]) for k in m_ref)
    emit({"phase": phase, "dtype": "float32", "tf32": False, **(extra or {}),
          "video_hwtn": ENGINE_CHECK_VIDEO, "window": ENGINE_CHECK_WINDOW,
          "predictions": [len(p_got), len(p_ref)], "categories_equal": same,
          "max_abs_score_err": score_err, "min_mask_agreement": agree,
          "max_abs_metric_err": metric_err, "metrics_kernel": m_got, "metrics_plain": m_ref,
          "kernel_launches": launches, "seconds_card_cpu": [s_got, s_ref],
          "tol": {"score_atol": ENGINE_F32_SCORE_ATOL, "mask_agree": ENGINE_F32_MASK_AGREE,
                  "metric_atol": ENGINE_F32_METRIC_ATOL}})
    if not (same and len(p_got) == len(p_ref) and score_err <= ENGINE_F32_SCORE_ATOL
            and agree >= ENGINE_F32_MASK_AGREE and metric_err <= ENGINE_F32_METRIC_ATOL):
        raise AssertionError(f"{phase}: the engine on the card disagrees with the engine on "
                             "the CPU")
    if any(launches[k] == 0 for k in kernels):
        raise AssertionError(f"{phase}: the card's engine run skipped a kernel: {launches}")
    return launches, tracking


def write_clip_files(root):
    """Random ViT-B/16 weights in OpenAI's key layout (f16, as released; from
    the seed) and a tiny BPE merge file, under ``root``: (weights, bpe)."""
    weights = os.path.join(root, "ViT-B-16.pt")
    torch.save(clip_synthetic.openai_state_dict("ViT-B/16", seed=SEED), weights)
    return weights, clip_synthetic.write_bpe(os.path.join(root, "bpe_tiny.txt.gz"))


def _ensemble_config(root, clip):
    """Phase 10's engine config with the recipe's clip_adapter and the CLIP
    files ``clip`` (weights, bpe)."""
    cfg = _engine_config(root)
    ca = dataclasses.replace(load_config(CLI_CONFIG).model.clip_adapter, weights=clip[0],
                             bpe_vocab=clip[1])
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, clip_adapter=ca))


def vit_flops(shape) -> float:
    """Operations (2 a multiply-add) of one crop through a ViT tower: the
    patch embedding, per block the q/k/v/out and MLP products (12 L w^2) and
    the attention's two products (2 L^2 w), and the projection."""
    p, w, layers = shape["vision_patch"], shape["vision_width"], shape["vision_layers"]
    n = (shape["image_size"] // p) ** 2
    tokens = n + 1
    macs = n * 3 * p * p * w + layers * (12 * tokens * w * w + 2 * tokens * tokens * w) \
        + w * shape["embed_dim"]
    return 2.0 * macs


def _clip_tower_vs_cpu(cfg, visual, card: str):
    """The full-width tower in f32 (TF32 off) on CLIP_TOWER_CROPS crops, card
    against CPU; then the bf16 tower's time on one frame's Q crops."""
    f32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, test=dataclasses.replace(cfg.model.test, amp=False)))
    res = model_shape(cfg.model.clip_adapter.clip_model_name)["image_size"]
    rng = np.random.RandomState(SEED + 4)
    x = torch.from_numpy(rng.randn(CLIP_TOWER_CROPS, res, res, 3).astype(np.float32))
    t0 = time.perf_counter()
    ref = clip_towers.build_clip_visual(f32, "cpu")(x)
    cpu_s = time.perf_counter() - t0
    got = clip_towers.build_clip_visual(f32, DEVICE)(x.to(DEVICE)).cpu()
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    q = cfg.model.transformer_decoder.num_queries
    crops = torch.from_numpy(rng.randn(q, res, res, 3).astype(np.float32))
    crops = crops.to(DEVICE, torch.bfloat16)
    ms = time_cuda(lambda: visual(crops), iters=5, warmup=2)
    flop_per_s = vit_flops(model_shape(cfg.model.clip_adapter.clip_model_name)) * q / ms * 1e3
    emit({"phase": "clip_tower_vs_cpu", "model": cfg.model.clip_adapter.clip_model_name,
          "crops": CLIP_TOWER_CROPS, "dtype": "float32", "tf32": False,
          "max_abs_err_rel_to_max": err, "tol_rel_to_max": CLIP_TOWER_REL_TO_MAX,
          "cpu_s": cpu_s, "bf16_ms_per_frame_of_crops": ms, "crops_per_frame": q,
          "bf16_tflop_per_s": flop_per_s / 1e12, "bf16_peak_share": flop_per_s / BF16_FLOPS,
          "card": card})
    if not err <= CLIP_TOWER_REL_TO_MAX:
        raise AssertionError(f"the CLIP tower on the card disagrees with the CPU: {err}")


def phase_ensemble(card: str, clip):
    """Phase 12: SimpleBaselineOnline's CLIP ensemble through the engine over
    phase 10's second video at full width, bf16 AMP, with the recipe's
    clip_adapter and the CLIP files ``clip``: the text bank of the 40
    categories, a warm-up over that video, then the timed run with its
    split (phase 10's stages, the CLIP crop scoring and its roi_crops on the
    device, the text bank's host time), its peak and launches; the
    full-width tower in f32 against the CPU; the whole ensemble engine at
    the test-tiny CLIP shape on the card against the CPU.  Returns the
    launch counts of the timed run."""
    import train_net_torch as cli

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = tempfile.mkdtemp(prefix="chip_smoke_ensemble_")
    try:
        cats, write_s = _write_engine_dataset(root)
        cfg = _ensemble_config(root, clip)
        model = init_params(train.build_model(cfg, device=DEVICE), seed=SEED)
        masters = {n: p.detach().clone() for n, p in model.named_parameters()}
        t0 = time.perf_counter()
        text = cli.build_text_bank(cfg, DEVICE).encode(
            list(catalog.get(ENGINE_DATASET).thing_classes))
        bank_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        visual = clip_towers.build_clip_visual(cfg, DEVICE)
        tower_s = time.perf_counter() - t0
        # cuDNN's and cuBLAS's choices for the tower's shapes, the allocator
        engine.evaluate_dataset(dataclasses.replace(cfg, output_dir=os.path.join(root, "warm")),
                                model, _engine_subset(ONLINE_ENGINE_VIDEOS), text,
                                max_videos=1, clip_visual_apply=visual, device=DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics, spans, wall, launches = _engine_run(cfg, model, text, DEVICE, visual,
                                                     ONLINE_ENGINE_VIDEOS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        masters_kept = all(torch.equal(p, masters[n]) for n, p in model.named_parameters())
        del masters
        expected = _engine_expected(cfg, launches, ONLINE_ENGINE_VIDEOS)
        q = cfg.model.transformer_decoder.num_queries
        shape = model_shape(cfg.model.clip_adapter.clip_model_name)
        crops = q * spans.frames
        clip_s = spans.device_seconds("clip_crops")
        roi_s = spans.device_seconds("roi_crop")
        res = shape["image_size"]
        # roi_crop's least time: each frame (bf16) and each mask slot read
        # once, each crop written once (bf16)
        h, w = cfg.input.pad_size
        roi_bytes = 2 * spans.frames * (h * w * 3 + q * (h // 4) * (w // 4) + q * res * res * 4)
        split = {**_engine_split(spans, wall),
                 "ensemble_tracking_clip_topk_device": spans.device_seconds("ensemble_topk"),
                 "clip_crops_device": clip_s, "roi_crop_device": roi_s,
                 "text_bank_host": bank_s, "clip_tower_load_host": tower_s}
        finite = all(np.isfinite(v) for v in metrics.values())
        emit({"phase": "ensemble_full_width", "dataset": "synthetic YTVIS-2019 format, 40 classes",
              "videos_hwtn": ONLINE_ENGINE_VIDEOS, "dtype": "bf16 AMP",
              "window": cfg.model.test.max_frames,
              "clip_adapter": dataclasses.asdict(cfg.model.clip_adapter),
              "metrics": metrics, "metrics_finite": finite, "predictions": len(spans.preds),
              "launches": launches, "expected_launches": expected,
              "frames": spans.frames, "wall_s": wall, "frames_per_s": spans.frames / wall,
              "split_s": split, "peak_mem_gib": peak, "callers_f32_params_unchanged": masters_kept,
              "crops": crops, "clip_tflop": crops * vit_flops(shape) / 1e12,
              "clip_tflop_per_s": crops * vit_flops(shape) / clip_s / 1e12,
              "clip_bf16_peak_share": crops * vit_flops(shape) / clip_s / BF16_FLOPS,
              "roi_crop_calls": len(spans.events["roi_crop"]),
              "roi_crop_bound_s": roi_bytes / HBM_BYTES_PER_S,
              "dataset_write_s": write_s, "card": card})
        if launches != expected:
            raise AssertionError(f"ensemble launches {launches} != {expected}")
        if not finite or set(metrics) < {"AP", "AP50", "AR10"} or not spans.preds:
            raise AssertionError(f"ensemble metrics {metrics}, {len(spans.preds)} predictions")
        if len(spans.events["ensemble_topk"]) != len(ONLINE_ENGINE_VIDEOS) or \
                not spans.events["roi_crop"]:
            raise AssertionError("the engine did not run the CLIP ensemble")
        if not masters_kept:
            raise AssertionError("evaluate_dataset changed the caller's f32 parameters")
        _clip_tower_vs_cpu(cfg, visual, card)
        del model, visual
        torch.cuda.empty_cache()
        tiny = os.path.join(root, "clip_tiny.pt")
        torch.save(clip_synthetic.openai_state_dict(ENSEMBLE_CHECK_CLIP, seed=SEED + 3), tiny)
        phase_engine_vs_plain(root, cats, clip_weights=tiny)
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _cli_data(root):
    """The synthetic train and eval sets, registered; returns the config
    overrides that point the recipe at them (its CLIP files apart)."""
    cats = catalog.category_table("ytvis_2019_val")
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
            f"solver.checkpoint_period={CLI_PERIOD}"]


def _metrics_lines(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(x) for x in f]


def _state_copy(state):
    """A CPU copy of a TrainState's state dict."""
    sd = state.state_dict()
    return {k: ({n: t.cpu().clone() for n, t in v.items()} if isinstance(v, dict) else v)
            for k, v in sd.items()}


def _states_equal(a, b) -> bool:
    """The step, the count, the parameters and the optimizer's state (AdamW's
    ``mu``/``nu`` or SGD's ``trace``) of ``b`` (a checkpoint) all in ``a``,
    bit for bit."""
    return (a["step"] == b["step"] and a["count"] == b["count"]
            and all(k in a and set(a[k]) == set(v)
                    and all(torch.equal(a[k][n], v[n]) for n in v)
                    for k, v in b.items() if isinstance(v, dict)))


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


def phase_cli(card: str, clip):
    """The CLI at full width with the recipe's text bank and CLIP ensemble
    (the CLIP files ``clip``: weights, bpe): train, resume, eval; then the
    resume, the 2-process and the NCCL checks.  Returns the launch counts of
    the train run (1) and of the eval run (3), and the recorded-input kernel
    times."""
    import train_net_torch as cli

    # PyTorch's defaults, as a user runs the CLI (earlier phases switch TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    saves, restored = [], []
    orig = cli.save_checkpoint, cli.restore_checkpoint

    def timed_save(directory, step, state):
        t0 = time.perf_counter()
        path = orig[0](directory, step, state)
        saves.append({"step": step, "ms": (time.perf_counter() - t0) * 1e3,
                      "bytes": os.path.getsize(path)})
        return path

    def recorded_restore(src, state):
        out = orig[1](src, state)
        if out is not None:
            restored.append(_state_copy(state))
            restored[-1]["lr_next"] = state.opt.lr(state.opt.count)
        return out

    cli.save_checkpoint, cli.restore_checkpoint = timed_save, recorded_restore
    try:
        t0 = time.perf_counter()
        common = _cli_data(root) + [f"model.clip_adapter.weights={clip[0]}",
                                    f"model.clip_adapter.bpe_vocab={clip[1]}"]
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
        enc = cfg.model.pixel_decoder.transformer_enc_layers
        expected = _train_launches(cfg, *cfg.input.pad_size, CLI_MAX_ITER)
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

        text = torch.from_numpy(cli.build_text_bank(cfg, DEVICE).encode(
            list(catalog.get(cfg.datasets.train[0]).thing_classes)))
        batches, recorded = _api_resume_check(cfg, root, text)
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
        cli.save_checkpoint, cli.restore_checkpoint = orig
        shutil.rmtree(root, ignore_errors=True)


def _fixed_batches(cfg, n, text):
    loader = TrainLoader(cfg, seed=SEED)
    try:
        batches = [next(loader) for _ in range(n)]
    finally:
        loader.close()
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
    _hold_k4_k5_k6("cli_train", k4_rec, sampler_rec, k4_calls=1)
    return {"msda_fwd": {"recorded_cli_train_ms": k1_ms},
            "msda_dcoord": {"recorded_cli_train_ms": k2_ms},
            "msda_dvalue": {"recorded_cli_train_ms": k3_ms,
                            "recorded_cli_train_device_ms": k3_dev}}


def _hold_k4_k5_k6(path: str, k4_rec: HungarianRecorder, sampler_rec: SamplerInputs,
                   k4_calls: int) -> None:
    """K4 on every cost recorded on ``path`` (``k4_calls`` calls) against
    ``hungarian_plain``, and K5 and K6 on their first call of each shape
    against the plain sampler, with phases 3 and 5's tolerances."""
    _hold_k4(path, k4_rec, k4_calls)
    _hold_k5(path, sampler_rec)
    for shape, (coords, grad, map_shape, dtype) in sorted(sampler_rec.dvalue.items()):
        coords, grad = coords.to(DEVICE), grad.to(DEVICE)
        got = point_sample_cuda.point_sample_dvalue_cuda(coords, grad, map_shape, dtype)
        ref = sample_maps_dvalue_plain(torch.empty(map_shape, dtype=dtype, device=DEVICE),
                                       coords, grad)
        torch.cuda.synchronize()
        ok, err, rel = _check_close(got, ref, BWD_REL_TO_MAX, BWD_RTOL[dtype])
        emit({"phase": "k6_recorded_inputs", "path": path, "maps_points": shape,
              "dtype": str(dtype).replace("torch.", ""), "within_tol": ok,
              "max_abs_err": err, "max_err_rel_to_max": rel,
              "tol": {"rel_to_max": BWD_REL_TO_MAX, "rtol": BWD_RTOL[dtype]}})
        if not ok:
            raise AssertionError(f"K6 disagrees with the plain sampler on the {path} {shape}")
    if not sampler_rec.fwd or not sampler_rec.dvalue:
        raise AssertionError(f"the {path} step launched no K5 or no K6")


def _hold_k4(path: str, k4_rec: HungarianRecorder, k4_calls: int) -> None:
    """K4 on every cost recorded on ``path`` (``k4_calls`` calls) against
    ``hungarian_plain``, element for element."""
    plain = _plain_assignments(k4_rec.costs)
    cols = [c for batch_cols in k4_rec.cols for c in batch_cols]
    differ = [i for i, ((ref, _), got) in enumerate(zip(plain, cols)) if not torch.equal(ref, got)]
    steps = [n for _, n in plain]
    emit({"phase": "k4_recorded_inputs", "path": path,
          "shapes": [list(c.shape) for c in k4_rec.costs], "equal_to_plain": not differ,
          "problems_differing": differ,
          "steps_per_problem": {"mean": float(np.mean(steps)), "max": max(steps)}})
    if differ or len(k4_rec.costs) != k4_calls:
        raise AssertionError(f"K4 on the {path} costs differs from hungarian_plain: {differ}")


def _hold_k5(path: str, sampler_rec: SamplerInputs):
    """K5 on its first call of each shape recorded on ``path`` against the
    plain sampler with phase 5's tolerance, timed beside its bound and the
    plain version; returns the times by shape."""
    times = {}
    for shape, (maps, coords) in sorted(sampler_rec.fwd.items()):
        maps, coords = maps.to(DEVICE), coords.to(DEVICE)
        got = point_sample_cuda.point_sample_fwd_cuda(maps, coords)
        ref = sample_maps_shared_plain(maps, coords, f32_policy=True)
        torch.cuda.synchronize()
        ok, err, rel = _check_close(got, ref, SAMPLER_REL_TO_MAX, SAMPLER_RTOL)
        h, w = maps.shape[-2:]
        x, y = coords[..., 0] * w - 0.5, coords[..., 1] * h - 0.5
        inside = int(((x > -1) & (y > -1) & (x < w) & (y < h)).sum()) * maps.shape[1]
        b_ms, b_by = bound(nbytes(maps, coords, got), 12.0 * inside)
        ms = time_cuda(lambda: point_sample_cuda.point_sample_fwd_cuda(maps, coords))
        plain_ms = time_cuda(lambda: sample_maps_shared_plain(maps, coords, True), iters=5)
        times[shape] = ms
        emit({"phase": "k5_recorded_inputs", "path": path, "maps_points": shape,
              "dtype": str(maps.dtype).replace("torch.", ""), "within_tol": ok,
              "max_abs_err": err, "max_err_rel_to_max": rel, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": b_ms, "bound_by": b_by,
              "tol": {"rel_to_max": SAMPLER_REL_TO_MAX, "rtol": SAMPLER_RTOL}})
        if not ok:
            raise AssertionError(f"K5 disagrees with the plain sampler on the {path} {shape}")
    return times


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


def _api_resume_check(cfg, root, text):
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
    batches = _fixed_batches(cfg, 4, text)
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


class SanSpans:
    """CUDA events around SAN's stages in each window of ``make_eval_fn``:
    the CLIP front encode, the segmenter, the CLIP post encode, and from the
    start of tracking to the window's end (tracking and top-k)."""

    STAGES = ("clip_front", "segmenter", "clip_post")

    def __init__(self, model):
        self._targets = ((model.clip_adapter, "front_encode"), (model.segmenter, "forward"),
                         (model.clip_adapter, "post_encode"))

    def __enter__(self):
        self.events = {k: [] for k in (*self.STAGES, "windows")}
        self._track_starts = []
        self._track = train.track_by_embeds

        def around(key, fn):
            def timed(*a, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*a, **kw)
                end.record()
                self.events[key].append((start, end))
                return out
            return timed

        def track(*a, **kw):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._track_starts.append(ev)
            return self._track(*a, **kw)

        for key, (obj, name) in zip(self.STAGES, self._targets):
            setattr(obj, name, around(key, getattr(obj, name)))
        train.track_by_embeds = track
        self.window = lambda fn: around("windows", fn)
        return self

    def __exit__(self, *exc):
        for obj, name in self._targets:
            del obj.__dict__[name]  # the class's method again
        train.track_by_embeds = self._track

    def split_ms(self):
        """Milliseconds of each stage summed over the windows."""
        torch.cuda.synchronize()
        out = {k: sum(a.elapsed_time(b) for a, b in self.events[k]) for k in self.STAGES}
        out["tracking_topk"] = sum(t.elapsed_time(end) for t, (_, end)
                                   in zip(self._track_starts, self.events["windows"]))
        return out


def _san_config(clip, *overrides):
    """The SAN recipe with the CLIP files ``clip`` (weights, bpe) and ``overrides``."""
    return load_config(SAN_CONFIG, [f"model.clip_adapter.weights={clip[0]}",
                                    f"model.clip_adapter.bpe_vocab={clip[1]}", *overrides])


def _san_model(cfg, tree, device, seed):
    """SANOnline from the seed, its CLIP tower from ``tree`` through the CLI's reader."""
    import train_net_torch as cli

    model = init_params(train.build_model(cfg, device=device), seed=seed)
    cli.load_clip_visual(model, tree)
    return model


def phase_san_window(card, cfg, tree):
    """13.1: the SANOnline eval window at full width, bf16, three windows, with
    its split and TFLOP/s against FLOPS.json's count; returns the launches."""
    model = _san_model(cfg, tree, DEVICE, SEED).to(dtype=torch.bfloat16).eval()
    eval_fn = train.make_eval_fn(cfg, model)
    rng = np.random.RandomState(SEED)
    t, h, w = WINDOW_FRAMES, FRAME_H, FRAME_W
    windows = [torch.from_numpy(rng.randn(t, h, w, 3).astype(np.float32)).to(
        DEVICE, torch.bfloat16) for _ in range(NUM_WINDOWS)]
    text = torch.from_numpy(_text(rng)).to(DEVICE, torch.bfloat16)
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
    ms = start.elapsed_time(end) / NUM_WINDOWS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the split, from a second pass with events around each stage
    with SanSpans(model) as spans:
        timed = spans.window(eval_fn)
        for x in windows:
            timed(x, text)
    split = {k: v / NUM_WINDOWS for k, v in spans.split_ms().items()}
    q = cfg.model.transformer_decoder.num_queries
    for i, out in enumerate(outs):
        _check_outputs(out, q, K_CLASSES, t, h, w, f"SAN window {i}")
    enc = cfg.model.pixel_decoder.transformer_enc_layers
    expected = {**{k: 0 for k in launches}, "msda_fwd": enc * NUM_WINDOWS,
                "hungarian": NUM_WINDOWS}
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "FLOPS.json")) as f:
        flop = json.load(f)["san_online_r50_inference"]["flops"]
    emit({"phase": "san_window_full_width", "config": SAN_CONFIG, "dtype": "bfloat16",
          "windows": NUM_WINDOWS, "frames_per_window": t, "frame_hw": [h, w],
          "ms_per_window": ms, "frames_per_s": t / (ms / 1e3),
          "split_ms_per_window": split, "peak_mem_gib": peak,
          "flops_json_tflop_per_window": flop / 1e12,
          "tflop_per_s": flop / (ms / 1e3) / 1e12, "bf16_peak_share": flop / (ms / 1e3) / BF16_FLOPS,
          "launches": launches, "expected_launches": expected, "card": card})
    if launches != expected:
        raise AssertionError(f"SAN window launches {launches} != {expected}")
    return launches


def phase_san_vs_plain(cfg, tree):
    """13.2: one f32 SAN window at full width on the card (kernels) against
    the CPU (plain), TF32 off, at a frame size the CPU can take."""
    _hold_window_to_plain("san_kernels_vs_plain", cfg, _san_model(cfg, tree, "cpu", SEED + 1),
                          CHECK_TRAIN_H, CHECK_TRAIN_W)


def phase_san_train(card, cfg, tree):
    """13.3: the SAN train step at full width (bench.py's shape), bf16 AMP with
    f32 masters and the aux layers' CLIP logits; returns the launches."""
    model = _san_model(cfg, tree, DEVICE, SEED)
    visual = {n: p.detach().clone() for n, p in model.clip_adapter.visual.named_parameters()}
    trained = {n: p for n, p in model.named_parameters() if n in SAN_TRAINED}
    before = {n: p.detach().clone() for n, p in trained.items()}
    step = train.build_train_step(cfg, model, K_CLASSES, device=DEVICE)
    batch = _train_batch(np.random.RandomState(SEED), TRAIN_H, TRAIN_W, TRAIN_N, DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
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
    expected = _train_launches(cfg, TRAIN_H, TRAIN_W, TRAIN_STEPS)
    values = [{k: float(v) for k, v in m.items()} for m in metrics]
    tower_fixed = all(torch.equal(p, visual[n])
                      for n, p in model.clip_adapter.visual.named_parameters())
    moved = {n: not torch.equal(p.detach(), before[n]) for n, p in trained.items()}
    frozen = sum(p.numel() for p in model.clip_adapter.visual.parameters())
    emit({"phase": "san_train_full_width", "dtype": "bf16 AMP, f32 masters",
          "supervise_aux_logits": model.supervise_aux_logits,
          "batch": [1, TRAIN_T, TRAIN_H, TRAIN_W], "targets": TRAIN_N,
          "points": cfg.model.criterion.train_num_points, "steps": TRAIN_STEPS,
          "ms_per_step": ms, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "metrics": values, "launches": launches, "expected_launches": expected,
          "clip_visual_params": frozen, "clip_visual_bit_equal": tower_fixed,
          "trained_moved": moved, "card": card})
    if launches != expected:
        raise AssertionError(f"SAN train-step launches {launches} != {expected}")
    if not all(np.isfinite(v) for m in values for v in m.values()):
        raise AssertionError("a SAN train-step loss or grad norm is not finite")
    if not tower_fixed or not all(moved.values()) or len(moved) != len(SAN_TRAINED):
        raise AssertionError(f"the frozen tower changed or a trained parameter did not: {moved}")
    return launches


def phase_san_train_vs_plain(cfg, tree):
    """13.4: one f32 SAN train-step loss and gradient, card against CPU."""
    f32 = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, amp=False))
    cpu_model = _offsets_off_centres(_san_model(f32, tree, "cpu", SEED + 2), SEED + 2)
    _hold_train_to_plain("san_train_kernels_vs_plain", f32, cpu_model,
                         TRAIN_CHECK_PARAMS + SAN_TRAINED)


def phase_san_engine(card, clip, tree):
    """13.5: the engine with the SAN recipe's eval settings over phase 10's
    dataset's second video: a warm-up over it, then the timed run with its
    split and peak, K4 recorded; K4 on the engine's own costs against
    hungarian_plain.  Returns the launches of the timed run."""
    root = tempfile.mkdtemp(prefix="chip_smoke_san_engine_")
    try:
        _, write_s = _write_engine_dataset(root)
        cfg = _san_config(clip, f"datasets.root={root}", f"datasets.test=[{ENGINE_DATASET}]",
                          f"output_dir={os.path.join(root, 'out')}")
        model = _san_model(cfg, tree, DEVICE, SEED)
        text = _text(np.random.RandomState(SEED))
        _engine_warm_up(cfg, model, text, dataset=_engine_subset(ONLINE_ENGINE_VIDEOS))
        with HungarianRecorder() as tracking:
            metrics, spans, wall, launches = _engine_run(cfg, model, text, DEVICE,
                                                         videos=ONLINE_ENGINE_VIDEOS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        expected = _engine_expected(cfg, launches, ONLINE_ENGINE_VIDEOS)
        finite = all(np.isfinite(v) for v in metrics.values())
        t0 = time.perf_counter()
        plain = _plain_assignments(tracking.costs)
        plain_s = time.perf_counter() - t0
        cols = [c for cost_cols in tracking.cols for c in cost_cols]
        differ = [i for i, ((ref, _), got) in enumerate(zip(plain, cols))
                  if not torch.equal(ref, got)]
        emit({"phase": "san_engine_full_width", "config": SAN_CONFIG,
              "dataset": "synthetic YTVIS-2019 format, 40 classes",
              "videos_hwtn": ONLINE_ENGINE_VIDEOS,
              "dtype": "bf16 AMP" if cfg.model.test.amp else "float32",
              "window": engine.window_size(cfg), "metrics": metrics, "metrics_finite": finite,
              "predictions": len(spans.preds), "launches": launches,
              "expected_launches": expected, "frames": spans.frames, "wall_s": wall,
              "frames_per_s": spans.frames / wall, "split_s": _engine_split(spans, wall),
              "peak_mem_gib": peak, "k4_problems": len(plain), "k4_equal_to_plain": not differ,
              "k4_problems_differing": differ, "k4_plain_seconds": plain_s,
              "dataset_write_s": write_s, "card": card})
        if launches != expected:
            raise AssertionError(f"SAN engine launches {launches} != {expected}")
        if not finite or set(metrics) < {"AP", "AP50", "AR10"} or not spans.preds:
            raise AssertionError(f"SAN engine metrics {metrics}, {len(spans.preds)} predictions")
        if differ or len(tracking.costs) != expected["hungarian"]:
            raise AssertionError(f"K4 on the SAN engine's costs differs from hungarian_plain: "
                                 f"{differ}")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _recipe_cli(card, clip, config, steps, label, keep_checkpoints=None, overrides=()):
    """The CLI with the recipe ``config`` as users train it (16 clips of 2
    frames a step), ``steps`` steps and a checkpoint, then ``--eval-only``;
    returns the launches of the two runs.  ``keep_checkpoints``: a directory
    the run's checkpoint directory moves to; ``overrides``: more dotted
    config overrides."""
    import train_net_torch as cli

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    root = tempfile.mkdtemp(prefix=f"chip_smoke_{label}_cli_")
    saves = []
    orig = cli.save_checkpoint

    def timed_save(directory, step, state):
        t0 = time.perf_counter()
        path = orig(directory, step, state)
        saves.append({"step": step, "ms": (time.perf_counter() - t0) * 1e3,
                      "bytes": os.path.getsize(path)})
        return path

    cli.save_checkpoint = timed_save
    try:
        out = os.path.join(root, "out")
        common = _cli_data(root) + [f"model.clip_adapter.weights={clip[0]}",
                                    f"model.clip_adapter.bpe_vocab={clip[1]}",
                                    f"solver.max_iter={steps}",
                                    f"solver.checkpoint_period={steps}",
                                    f"output_dir={out}", *overrides]

        def run(*flags):
            reset_counts()
            t0 = time.perf_counter()
            cli.main(["--config-file", config, *flags, *common])
            torch.cuda.synchronize()
            return time.perf_counter() - t0, read_counts()

        torch.cuda.reset_peak_memory_stats()
        wall, launches = run()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        lines = _metrics_lines(out)
        cfg = load_config(config, common)
        expected = _train_launches(cfg, *cfg.input.pad_size, steps)
        steps_ms = [r["step_s"] * 1e3 for r in lines]
        waits_ms = [r["data_wait_s"] * 1e3 for r in lines]
        finite = all(np.isfinite(r[k]) for r in lines
                     for k in ("total_loss", "loss_ce", "loss_mask", "loss_dice", "grad_norm"))
        emit({"phase": f"{label}_cli_train", "config": config,
              "batch": [cfg.solver.ims_per_batch, cfg.input.sampling_frame_num],
              "points": cfg.model.criterion.train_num_points, "amp": cfg.solver.amp,
              "steps": [r["step"] for r in lines], "ms_per_step": steps_ms,
              "ms_per_step_after_first": float(np.mean(steps_ms[1:])),
              "loader_wait_ms": waits_ms, "losses": [r["total_loss"] for r in lines],
              "grad_norms": [r["grad_norm"] for r in lines], "checkpoint_saves": saves,
              "peak_mem_gib": peak, "wall_s": wall, "launches": launches,
              "expected_launches": expected, "card": card})
        if launches != expected:
            raise AssertionError(f"{label} CLI train launches {launches} != {expected}")
        if [r["step"] for r in lines] != list(range(1, steps + 1)) or not finite:
            raise AssertionError(f"the {label} CLI's metrics.jsonl is not {steps} finite steps")
        if [s["step"] for s in saves] != [steps]:
            raise AssertionError(f"{label} checkpoints saved at {saves}")

        ckpt_dir = os.path.join(out, "checkpoints")
        wall2, launches2 = run("--eval-only", "--weights", ckpt_dir)
        ds = cfg.datasets.test[0]
        with open(os.path.join(out, f"metrics_{ds}.json")) as f:
            metrics = json.load(f)
        expected2 = _engine_expected(cfg, launches2, CLI_EVAL_VIDEOS)
        emit({"phase": f"{label}_cli_eval", "metrics": metrics, "wall_s": wall2,
              "launches": launches2, "expected_launches": expected2, "card": card})
        if not metrics or not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"the {label} CLI's eval wrote {metrics}")
        if launches2 != expected2:
            raise AssertionError(f"{label} CLI eval launches {launches2} != {expected2}")
        if keep_checkpoints is not None:
            shutil.move(ckpt_dir, keep_checkpoints)
        return launches, launches2
    finally:
        cli.save_checkpoint = orig
        shutil.rmtree(root, ignore_errors=True)


def phase_san_cli(card, clip, keep_checkpoints=None):
    """13.6: the CLI with the SAN recipe, SAN_CLI_STEPS steps (``_recipe_cli``);
    ``keep_checkpoints``: where its checkpoint directory goes (phase 14's
    stage 1)."""
    return _recipe_cli(card, clip, SAN_CONFIG, SAN_CLI_STEPS, "san", keep_checkpoints)


def phase_san(card, clip, keep_checkpoints=None):
    """Phase 13: SANOnline with the recipe's model (the side-adapter CLIP
    split over a random ViT-B/16 in OpenAI's layout from ``clip``); returns
    its paths' launch counts by name.  ``keep_checkpoints``: where the CLI
    run's checkpoint directory goes (``phase_san_cli``)."""
    import train_net_torch as cli

    cfg = _san_config(clip)
    tree = cli.read_clip(cfg)
    launches = {"san_eval": phase_san_window(card, cfg, tree)}
    phase_san_vs_plain(cfg, tree)
    launches["san_train"] = phase_san_train(card, cfg, tree)
    phase_san_train_vs_plain(cfg, tree)
    launches["san_engine"] = phase_san_engine(card, clip, tree)
    del tree
    launches["san_cli_train"], launches["san_cli_eval"] = phase_san_cli(card, clip,
                                                                       keep_checkpoints)
    return launches


class BrivisSpans:
    """CUDA events around BriVIS's stages in one run (class methods of the
    model, so that the engine's copies and ``torch.func.functional_call`` are
    timed too): the frozen frame stack, the resampler over the whole video
    (``resample``, or the raw resampler's halves), the heads with the biased
    CLIP post-encode (``predict_window``), and tracking (``track_by_embeds``
    of the module that calls it)."""

    STAGES = {"frame_stack": ("frame_stack",), "resample": ("resample", "raw_temporal",
                                                            "raw_frame", "raw_finalize"),
              "heads": ("predict_window",)}

    def __init__(self, *tracking_modules):
        self._tracking = tracking_modules

    def __enter__(self):
        self.events = {k: [] for k in (*self.STAGES, "tracking")}
        self._orig = {}

        def around(key, fn):
            def timed(*a, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*a, **kw)
                end.record()
                self.events[key].append((start, end))
                return out
            return timed

        for key, names in self.STAGES.items():
            for name in names:
                self._orig[(brivis_meta.BriVISModel, name)] = getattr(brivis_meta.BriVISModel, name)
                setattr(brivis_meta.BriVISModel, name,
                        around(key, getattr(brivis_meta.BriVISModel, name)))
        for mod in self._tracking:
            self._orig[(mod, "track_by_embeds")] = mod.track_by_embeds
            mod.track_by_embeds = around("tracking", mod.track_by_embeds)
        return self

    def __exit__(self, *exc):
        for (obj, name), fn in self._orig.items():
            setattr(obj, name, fn)

    def split_ms(self):
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in ev) for k, ev in self.events.items()}


def _brivis_config(clip, *overrides):
    """The BriVIS recipe with the CLIP files ``clip`` (weights, bpe) and
    ``overrides``; its stage-1 ``model.weights`` (a flax .msgpack) cleared."""
    return load_config(BRIVIS_CONFIG, ["model.weights=", f"model.clip_adapter.weights={clip[0]}",
                                       f"model.clip_adapter.bpe_vocab={clip[1]}", *overrides])


def _brivis_window(model, frames, text, topk):
    """bench.py's ``make_brivis_eval`` staged path over one window: the frozen
    frame stack, tracking, the resampler, the last layer's heads with the
    biased CLIP post-encode, the frame-mean scores' top-k."""
    out = model.frame_stack(frames, frames.shape[0])
    idx = brivis_meta.track_by_embeds(out["pred_embeds"])
    final = model.resample(brivis_meta.apply_track_indices(out["pred_embeds"], idx))
    masks, logits = model.predict_window(final[0], out["mask_feats"], out["attn_feats"],
                                         out["bk_tokens"], text)
    probs = torch.softmax(logits.float().mean(0), dim=-1)[:, :-1]
    return inference_video_topk(probs, masks.transpose(0, 1), topk)


def phase_brivis_window(card, cfg, tree):
    """14.1: the BriVIS eval window at full width, bf16, three windows of
    bench.py's staged path, with its split and TFLOP/s against FLOPS.json's
    count; returns the launches."""
    model = train.eval_model(_san_model(cfg, tree, DEVICE, SEED).to(dtype=torch.bfloat16).eval())
    rng = np.random.RandomState(SEED)
    t, h, w = WINDOW_FRAMES, FRAME_H, FRAME_W
    windows = [torch.from_numpy(rng.randn(t, h, w, 3).astype(np.float32)).to(
        DEVICE, torch.bfloat16) for _ in range(NUM_WINDOWS)]
    text = torch.from_numpy(_text(rng)).to(DEVICE, torch.bfloat16)
    topk = cfg.model.test.topk_per_video
    with torch.inference_mode():
        _brivis_window(model, windows[0], text, topk)  # warm-up: cuDNN autotuning, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(NUM_WINDOWS + 1)]
        reset_counts()
        marks[0].record()
        outs = []
        for x, mark in zip(windows, marks[1:]):
            outs.append(_brivis_window(model, x, text, topk))
            mark.record()
        torch.cuda.synchronize()
        launches = read_counts()
        each_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        ms = sum(each_ms) / NUM_WINDOWS
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        # the split, from a second pass with events around each stage; what
        # falls outside the stages (top-k, the gaps between them) is its rest
        with BrivisSpans(brivis_meta) as spans:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for x in windows:
                _brivis_window(model, x, text, topk)
            end.record()
        split = {k: v / NUM_WINDOWS for k, v in spans.split_ms().items()}
    split_pass_ms = start.elapsed_time(end) / NUM_WINDOWS
    split["topk_and_other"] = split_pass_ms - sum(split.values())
    q = cfg.model.transformer_decoder.num_queries
    for i, out in enumerate(outs):
        _check_outputs(out, q, K_CLASSES, t, h, w, f"BriVIS window {i}")
    enc = cfg.model.pixel_decoder.transformer_enc_layers
    expected = {**{k: 0 for k in launches}, "msda_fwd": enc * NUM_WINDOWS,
                "hungarian": NUM_WINDOWS}
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "FLOPS.json")) as f:
        flop = json.load(f)["brivis_r50_inference"]["flops"]
    emit({"phase": "brivis_window_full_width", "config": BRIVIS_CONFIG, "dtype": "bfloat16",
          "resampler": [cfg.model.resampler.name, cfg.model.resampler.num_layers],
          "windows": NUM_WINDOWS, "frames_per_window": t, "frame_hw": [h, w],
          "ms_per_window": ms, "ms_each_window": each_ms, "frames_per_s": t / (ms / 1e3),
          "split_pass_ms_per_window": split_pass_ms, "split_ms_per_window": split,
          "peak_mem_gib": peak, "flops_json_tflop_per_window": flop / 1e12,
          "tflop_per_s": flop / (ms / 1e3) / 1e12,
          "bf16_peak_share": flop / (ms / 1e3) / BF16_FLOPS,
          "launches": launches, "expected_launches": expected, "card": card})
    if launches != expected:
        raise AssertionError(f"BriVIS window launches {launches} != {expected}")
    return launches


def phase_brivis_vs_plain(cfg, tree):
    """14.2: one f32 BriVIS window (``make_eval_fn``: the model's forward) on
    the card (kernels) against the CPU (plain), TF32 off, at 192x320."""
    _hold_window_to_plain("brivis_kernels_vs_plain", cfg,
                          _san_model(cfg, tree, "cpu", SEED + 1), CHECK_TRAIN_H, CHECK_TRAIN_W)


def _subtrees(model, prefixes=("segmenter.", "clip_adapter.")):
    return {n: p for n, p in model.named_parameters() if n.startswith(prefixes)}


def phase_brivis_train(card, cfg, tree):
    """14.3: the BriVIS train step at full width (1x3x480x864, N=40, bf16 AMP,
    f32 masters) under each matcher source, with K1, K4, K5 and K6 held to
    their plain versions on the inputs of the first step; the frozen stage 1
    bit-equal after it, the resampler and brownian_proj moved.  Returns the
    launches of the timed steps of both sources."""
    model = _san_model(cfg, tree, DEVICE, SEED)
    frozen = {n: p.detach().clone() for n, p in _subtrees(model).items()}
    trained = {n: p for n, p in model.named_parameters() if n in BRIVIS_TRAINED}
    before = {n: p.detach().clone() for n, p in trained.items()}
    step = train.build_train_step(cfg, model, K_CLASSES, device=DEVICE)
    batch = _train_batch(np.random.RandomState(SEED), TRAIN_H, TRAIN_W, TRAIN_N, DEVICE,
                         BRIVIS_T)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    with MsdaRecorder() as msda_rec, HungarianRecorder() as k4_rec, SamplerInputs() as s_rec:
        step(batch, gen)  # warm-up: cuDNN autotuning, allocator; its inputs recorded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs, launches = {}, collections.Counter()
    for image_matcher in (True, False):
        train.use_brivis_matcher(step, cfg, K_CLASSES, image_matcher)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reset_counts()
        start.record()
        metrics = [step(batch, gen) for _ in range(BRIVIS_TRAIN_STEPS)]
        end.record()
        torch.cuda.synchronize()
        launches.update(read_counts())
        runs["image_matcher" if image_matcher else "resampler_matcher"] = {
            "ms_per_step": start.elapsed_time(end) / BRIVIS_TRAIN_STEPS,
            "metrics": [{k: float(v) for k, v in m.items()} for m in metrics]}
    launches = dict(launches)
    expected = _train_launches(cfg, TRAIN_H, TRAIN_W, 2 * BRIVIS_TRAIN_STEPS, BRIVIS_T)
    frozen_fixed = all(torch.equal(p, frozen[n]) for n, p in _subtrees(model).items())
    moved = {n: not torch.equal(p.detach(), before[n]) for n, p in trained.items()}
    no_state = [n for n in frozen if n in step.state.opt.mu]
    emit({"phase": "brivis_train_full_width", "config": BRIVIS_CONFIG,
          "dtype": "bf16 AMP, f32 masters", "batch": [1, BRIVIS_T, TRAIN_H, TRAIN_W],
          "targets": TRAIN_N, "points": cfg.model.criterion.train_num_points,
          "steps_per_matcher": BRIVIS_TRAIN_STEPS, "runs": runs,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "launches": launches, "expected_launches": expected,
          "frozen_params": sum(p.numel() for p in frozen.values()),
          "frozen_bit_equal": frozen_fixed, "frozen_with_adamw_state": len(no_state),
          "trained_moved": moved, "card": card})
    del frozen
    if launches != expected:
        raise AssertionError(f"BriVIS train-step launches {launches} != {expected}")
    if not all(np.isfinite(v) for r in runs.values() for m in r["metrics"] for v in m.values()):
        raise AssertionError("a BriVIS train-step loss or grad norm is not finite")
    if not frozen_fixed or no_state or not all(moved.values()) or len(moved) != len(BRIVIS_TRAINED):
        raise AssertionError(f"the frozen stage 1 changed or a trained parameter did not: {moved}")
    _hold_k1("brivis_train", msda_rec)
    _hold_k4_k5_k6("brivis_train", k4_rec, s_rec, k4_calls=2)
    return launches


def phase_brivis_train_vs_plain(cfg, tree):
    """14.4: one f32 BriVIS train-step loss and gradient, card against CPU, on
    a clip of 3 frames at 192x320."""
    f32 = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, amp=False))
    _hold_train_to_plain("brivis_train_kernels_vs_plain", f32,
                         _san_model(f32, tree, "cpu", SEED + 2), BRIVIS_TRAINED, BRIVIS_T)


def _brivis_engine_vs_plain(root, cats, clip, tree, resampler):
    """One short f32 video through the engine with a BriVIS of ``resampler``
    on the card (kernels) and on the CPU (plain), phase 10's check video and
    bounds; returns the card's launches."""
    name = ENGINE_DATASET + "_brivis_check"
    catalog.register(dataclasses.replace(
        synthetic.write_ytvis_dataset(root, "brivis_check", [ENGINE_CHECK_VIDEO], cats,
                                      seed=SEED + 3), name=name))
    h, w = ENGINE_CHECK_VIDEO[:2]
    base = _brivis_config(clip, f"model.resampler.name={resampler}", f"datasets.root={root}",
                          f"datasets.test=[{name}]", "model.test.window_inference=true",
                          f"model.test.window_size={ENGINE_CHECK_WINDOW}", "model.test.amp=false",
                          f"input.min_size_test={h}", f"input.pad_size=[{h},{w}]")
    model = _san_model(base, tree, "cpu", SEED + 3)
    text = _text(np.random.RandomState(SEED + 3))
    runs = {}
    for device in ("cpu", DEVICE):
        cfg = dataclasses.replace(base, output_dir=os.path.join(root, f"brivis_{device}"))
        reset_counts()
        t0 = time.perf_counter()
        metrics = engine.evaluate_dataset(cfg, model, name, text, device=device)
        seconds = time.perf_counter() - t0
        with open(os.path.join(cfg.output_dir, f"results_{name}.json")) as f:
            runs[device] = (metrics, json.load(f), seconds, read_counts())
    (m_ref, p_ref, s_ref, _), (m_got, p_got, s_got, launches) = runs["cpu"], runs[DEVICE]
    same = [p["category_id"] for p in p_got] == [p["category_id"] for p in p_ref]
    score_err = max((abs(a["score"] - b["score"]) for a, b in zip(p_got, p_ref)), default=0.0)
    agree = min((_masks_agree(a["segmentations"], b["segmentations"])
                 for a, b in zip(p_got, p_ref)), default=1.0)
    metric_err = max(abs(m_got[k] - m_ref[k]) for k in m_ref)
    emit({"phase": "brivis_engine_kernels_vs_plain", "resampler": resampler, "dtype": "float32",
          "tf32": False, "video_hwtn": ENGINE_CHECK_VIDEO, "window": ENGINE_CHECK_WINDOW,
          "predictions": [len(p_got), len(p_ref)], "categories_equal": same,
          "max_abs_score_err": score_err, "min_mask_agreement": agree,
          "max_abs_metric_err": metric_err, "kernel_launches": launches,
          "seconds_card_cpu": [s_got, s_ref],
          "tol": {"score_atol": ENGINE_F32_SCORE_ATOL, "mask_agree": ENGINE_F32_MASK_AGREE,
                  "metric_atol": ENGINE_F32_METRIC_ATOL}})
    if not (same and len(p_got) == len(p_ref) and score_err <= ENGINE_F32_SCORE_ATOL
            and agree >= ENGINE_F32_MASK_AGREE and metric_err <= ENGINE_F32_METRIC_ATOL):
        raise AssertionError(f"the BriVIS ({resampler}) engine on the card disagrees with the CPU")
    if launches["msda_fwd"] == 0 or launches["hungarian"] == 0:
        raise AssertionError(f"the card's BriVIS engine run skipped a kernel: {launches}")


def phase_brivis_engine(card, clip, tree):
    """14.5: the engine with the BriVIS recipe's eval settings over phase 10's
    dataset (the temporal resampler over each whole video, padded to the
    JAX engine's time bucket): a warm-up over the first video, then the timed
    run with its split and peak, K4 recorded; K4 on the engine's own costs against
    hungarian_plain; then the decoupled and the raw resamplers, one f32
    video each, card against CPU.  Returns the launches of the timed run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = tempfile.mkdtemp(prefix="chip_smoke_brivis_engine_")
    try:
        cats, write_s = _write_engine_dataset(root)
        cfg = _brivis_config(clip, f"datasets.root={root}", f"datasets.test=[{ENGINE_DATASET}]",
                             f"output_dir={os.path.join(root, 'out')}")
        model = _san_model(cfg, tree, DEVICE, SEED)
        text = _text(np.random.RandomState(SEED))
        _engine_warm_up(cfg, model, text)
        with HungarianRecorder() as tracking, BrivisSpans(engine) as stages:
            metrics, spans, wall, launches = _engine_run(cfg, model, text, DEVICE)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        enc = cfg.model.pixel_decoder.transformer_enc_layers
        window = engine.window_size(cfg)
        expected = {**{k: 0 for k in launches},
                    "msda_fwd": enc * sum(-(-t // window) for _, _, t, _ in ENGINE_VIDEOS),
                    "hungarian": len(ENGINE_VIDEOS)}
        finite = all(np.isfinite(v) for v in metrics.values())
        t0 = time.perf_counter()
        plain = _plain_assignments(tracking.costs)
        plain_s = time.perf_counter() - t0
        cols = [c for cost_cols in tracking.cols for c in cost_cols]
        differ = [i for i, ((ref, _), got) in enumerate(zip(plain, cols))
                  if not torch.equal(ref, got)]
        split = _engine_split(spans, wall)
        split.update({f"{k}_device": v / 1e3 for k, v in stages.split_ms().items()})
        emit({"phase": "brivis_engine_full_width", "config": BRIVIS_CONFIG,
              "dataset": "synthetic YTVIS-2019 format, 40 classes", "videos_hwtn": ENGINE_VIDEOS,
              "dtype": "bf16 AMP" if cfg.model.test.amp else "float32", "window": window,
              "resampled_frames": [engine._bucket(t) for _, _, t, _ in ENGINE_VIDEOS],
              "metrics": metrics, "metrics_finite": finite, "predictions": len(spans.preds),
              "launches": launches, "expected_launches": expected, "frames": spans.frames,
              "wall_s": wall, "frames_per_s": spans.frames / wall, "split_s": split,
              "peak_mem_gib": peak, "k4_problems": len(plain), "k4_equal_to_plain": not differ,
              "k4_problems_differing": differ, "k4_plain_seconds": plain_s,
              "dataset_write_s": write_s, "card": card})
        if launches != expected:
            raise AssertionError(f"BriVIS engine launches {launches} != {expected}")
        if not finite or set(metrics) < {"AP", "AP50", "AR10"} or not spans.preds:
            raise AssertionError(f"BriVIS engine metrics {metrics}, {len(spans.preds)} predictions")
        if differ or len(tracking.costs) != expected["hungarian"]:
            raise AssertionError(f"K4 on the BriVIS engine's costs differs from hungarian_plain: "
                                 f"{differ}")
        del model
        for resampler in BRIVIS_ENGINE_CHECKS:
            _brivis_engine_vs_plain(root, cats, clip, tree, resampler)
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_brivis_cli(card, clip, stage1, config=BRIVIS_CONFIG, label="brivis",
                     steps=BRIVIS_CLI_STEPS, overrides=()):
    """14.6: the CLI with the BriVIS recipe as users run stage 2 (16 clips of
    3 frames a step) from the SANOnline checkpoint directory ``stage1``
    (phase 13's CLI run), BRIVIS_CLI_STEPS steps across the matcher switch
    and a checkpoint, then ``--eval-only``; the grafted segmenter and
    clip_adapter equal the stage-1 checkpoint's bit for bit, the resampler
    moved from its init.  Returns the launches of the two runs.  18.10 runs
    it with ``config`` brivis_SwinB on the Swin CLI's checkpoint, ``steps``
    steps and ``overrides``."""
    import train_net_torch as cli

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    root = tempfile.mkdtemp(prefix=f"chip_smoke_{label}_cli_")
    saves, switched = [], []
    orig_save, orig_switch = cli.save_checkpoint, cli.use_brivis_matcher

    def timed_save(directory, step, state):
        t0 = time.perf_counter()
        path = orig_save(directory, step, state)
        saves.append({"step": step, "ms": (time.perf_counter() - t0) * 1e3,
                      "bytes": os.path.getsize(path)})
        return path

    def recording_switch(step, cfg, num_text_classes, image_matcher):
        switched.append([step.state.step, image_matcher])
        orig_switch(step, cfg, num_text_classes, image_matcher)

    cli.save_checkpoint, cli.use_brivis_matcher = timed_save, recording_switch
    try:
        out = os.path.join(root, "out")
        common = _cli_data(root) + [f"model.weights={stage1}",
                                    f"model.clip_adapter.weights={clip[0]}",
                                    f"model.clip_adapter.bpe_vocab={clip[1]}",
                                    f"solver.max_iter={steps}",
                                    f"solver.checkpoint_period={steps}",
                                    f"output_dir={out}", *overrides]

        def run(*flags):
            reset_counts()
            t0 = time.perf_counter()
            cli.main(["--config-file", config, *flags, *common])
            torch.cuda.synchronize()
            return time.perf_counter() - t0, read_counts()

        torch.cuda.reset_peak_memory_stats()
        wall, launches = run()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        lines = _metrics_lines(out)
        cfg = load_config(config, common)
        t = cfg.input.sampling_frame_num
        expected = _train_launches(cfg, *cfg.input.pad_size, steps, t)
        steps_ms = [r["step_s"] * 1e3 for r in lines]
        finite = all(np.isfinite(r[k]) for r in lines
                     for k in ("total_loss", "loss_ce", "loss_mask", "loss_dice", "bc_loss",
                               "htm_loss", "grad_norm"))
        ckpt_dir = os.path.join(out, "checkpoints")
        stage2 = load_checkpoint(ckpt_dir)["params"]
        stage1_params = load_checkpoint(stage1)["params"]
        grafted = [k for k in stage2 if k.startswith(("segmenter.", "clip_adapter."))]
        graft_equal = (set(grafted) == set(stage1_params)
                       and all(torch.equal(stage2[k], stage1_params[k]) for k in grafted))
        del stage1_params
        fresh = init_params(train.build_model(cfg, device="cpu"), seed=cfg.seed).state_dict()
        moved = sum(not torch.equal(fresh[k], stage2[k]) for k in fresh
                    if k.startswith(("resampler.", "brownian_proj.")))
        emit({"phase": f"{label}_cli_train", "config": config, "stage1": "a SANOnline CLI run",
              "batch": [cfg.solver.ims_per_batch, t],
              "points": cfg.model.criterion.train_num_points, "amp": cfg.solver.amp,
              "steps": [r["step"] for r in lines], "ms_per_step": steps_ms,
              "loader_wait_ms": [r["data_wait_s"] * 1e3 for r in lines],
              "losses": [r["total_loss"] for r in lines],
              "bc_htm": [[r["bc_loss"], r["htm_loss"]] for r in lines],
              "grad_norms": [r["grad_norm"] for r in lines], "matcher_switched_at": switched,
              "checkpoint_saves": saves, "grafted_params": len(grafted),
              "grafted_bit_equal": graft_equal, "resampler_params_moved": moved,
              "peak_mem_gib": peak, "wall_s": wall, "launches": launches,
              "expected_launches": expected, "card": card})
        if launches != expected:
            raise AssertionError(f"{label} CLI train launches {launches} != {expected}")
        if [r["step"] for r in lines] != list(range(1, steps + 1)) or not finite:
            raise AssertionError(f"the {label} CLI's metrics.jsonl is not {steps} finite steps")
        if switched != [[steps // 2, False]]:
            raise AssertionError(f"the BriVIS matcher switched at {switched}")
        if not grafted or not graft_equal or not moved:
            raise AssertionError("the grafted stage 1 changed or the resampler did not move")

        wall2, launches2 = run("--eval-only", "--weights", ckpt_dir)
        ds = cfg.datasets.test[0]
        with open(os.path.join(out, f"metrics_{ds}.json")) as f:
            metrics = json.load(f)
        expected2 = _engine_expected(cfg, launches2, CLI_EVAL_VIDEOS)
        emit({"phase": f"{label}_cli_eval", "metrics": metrics, "wall_s": wall2,
              "launches": launches2, "expected_launches": expected2, "card": card})
        if not metrics or not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"the BriVIS CLI's eval wrote {metrics}")
        if launches2 != expected2:
            raise AssertionError(f"{label} CLI eval launches {launches2} != {expected2}")
        return launches, launches2
    finally:
        cli.save_checkpoint, cli.use_brivis_matcher = orig_save, orig_switch
        shutil.rmtree(root, ignore_errors=True)


def phase_brivis(card, clip, stage1):
    """Phase 14: BriVIS with its recipe's model (SAN's, frozen, and a temporal
    resampler of 6 layers) over ``clip``'s random ViT-B/16, stage 2 of the
    SANOnline checkpoint directory ``stage1``; returns its paths' launch
    counts by name."""
    import train_net_torch as cli

    cfg = _brivis_config(clip)
    tree = cli.read_clip(cfg)
    launches = {"brivis_eval": phase_brivis_window(card, cfg, tree)}
    phase_brivis_vs_plain(cfg, tree)
    launches["brivis_train"] = phase_brivis_train(card, cfg, tree)
    phase_brivis_train_vs_plain(cfg, tree)
    launches["brivis_engine"] = phase_brivis_engine(card, clip, tree)
    del tree
    launches["brivis_cli_train"], launches["brivis_cli_eval"] = phase_brivis_cli(card, clip,
                                                                                 stage1)
    return launches


class OpenvisSpans:
    """CUDA events around OpenVIS's stages in each window of
    ``_openvis_window``: the segmenter, tracking (``engine.track_by_embeds``),
    the CLIP crop scoring (``clip_towers.clip_crop_scores``: the frames'
    upload, ``roi_crop`` and the tower) and, in it, each ``roi_crop``; the
    scores and top-k run from the end of the crops to the end of the window."""

    def __init__(self, model):
        self._targets = {"segmenter": (model.segmenter, "forward"),
                         "tracking": (engine, "track_by_embeds"),
                         "crops": (clip_towers, "clip_crop_scores"),
                         "roi_crop": (clip_adapter, "roi_crop")}

    def __enter__(self):
        self.events = {k: [] for k in (*self._targets, "windows")}
        self._orig = {key: getattr(obj, name) for key, (obj, name) in self._targets.items()}

        def around(key, fn):
            def timed(*a, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*a, **kw)
                end.record()
                self.events[key].append((start, end))
                return out
            return timed

        for key, (obj, name) in self._targets.items():
            setattr(obj, name, around(key, self._orig[key]))
        self.window = lambda fn: around("windows", fn)
        return self

    def __exit__(self, *exc):
        for key, (obj, name) in self._targets.items():
            if key == "segmenter":
                del obj.__dict__[name]  # the class's method again
            else:
                setattr(obj, name, self._orig[key])

    def split_ms(self):
        """Milliseconds of each stage summed over the windows."""
        torch.cuda.synchronize()
        out = {k: sum(a.elapsed_time(b) for a, b in self.events[k]) for k in self._targets}
        out["scores_topk"] = sum(c.elapsed_time(w) for (_, c), (_, w)
                                 in zip(self.events["crops"], self.events["windows"]))
        return out


def _openvis_config(clip, *overrides):
    """The OpenVISOnline recipe with the CLIP files ``clip`` (weights, bpe) and
    ``overrides``."""
    return load_config(OPENVIS_CONFIG, [f"model.clip_adapter.weights={clip[0]}",
                                        f"model.clip_adapter.bpe_vocab={clip[1]}", *overrides])


def _openvis_window(cfg, model, visual, text):
    """bench.py's ``make_openvis_eval`` through the engine's own parts: the
    window's outputs (``engine.make_window_fn``), then ``engine.make_openvis_fn``
    (tracking once, the masks of all queries aligned, the mask-crop CLIP
    logits of the frames, averaged over each query's valid frames, the
    top-k).  f(frames (T, H, W, 3) on the card, the same frames on the host)."""
    params = dict(model.named_parameters())
    window_fn = engine.make_window_fn(cfg, model)
    openvis_fn = engine.make_openvis_fn(cfg, visual, text)

    @torch.inference_mode()
    def fn(frames, pixels):
        out = window_fn(params, frames, text)
        return openvis_fn(out["logits"], out["masks"], out["embeds"], pixels)

    return fn


def phase_openvis_window(card, cfg, visual, label="openvis_window_full_width", extra=None):
    """15.1: the OpenVISOnline eval window at full width, bf16, three windows
    of 10x384x640 with K=40 text rows, with its split and TFLOP/s against
    FLOPS.json's count; returns the launches and the split.  ``label``: the
    phase's name; ``extra``: more fields for its line."""
    model = init_params(train.build_model(cfg, device=DEVICE), seed=SEED).to(
        dtype=torch.bfloat16).eval()
    rng = np.random.RandomState(SEED)
    t, h, w = WINDOW_FRAMES, FRAME_H, FRAME_W
    pixels = [rng.randn(t, h, w, 3).astype(np.float32) for _ in range(NUM_WINDOWS)]
    windows = [torch.from_numpy(x).to(DEVICE, torch.bfloat16) for x in pixels]
    text = torch.from_numpy(_text(rng)).to(DEVICE, torch.bfloat16)
    window = _openvis_window(cfg, model, visual, text)
    window(windows[0], pixels[0])  # warm-up: cuDNN and cuBLAS choices, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts()
    start.record()
    outs = [window(x, p) for x, p in zip(windows, pixels)]
    end.record()
    torch.cuda.synchronize()
    launches = read_counts()
    ms = start.elapsed_time(end) / NUM_WINDOWS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with OpenvisSpans(model) as spans:
        timed = spans.window(window)
        for x, p in zip(windows, pixels):
            timed(x, p)
    split = {k: v / NUM_WINDOWS for k, v in spans.split_ms().items()}
    q = cfg.model.transformer_decoder.num_queries
    for i, out in enumerate(outs):
        _check_outputs(out, q, K_CLASSES, t, h, w, f"OpenVIS window {i}")
    enc = cfg.model.pixel_decoder.transformer_enc_layers
    expected = {**{k: 0 for k in launches}, "msda_fwd": enc * NUM_WINDOWS,
                "hungarian": NUM_WINDOWS}
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "FLOPS.json")) as f:
        flop = json.load(f)["openvis_online_r50_inference"]["flops"]
    shape = model_shape(cfg.model.clip_adapter.clip_model_name)
    crops_flop = vit_flops(shape) * q * t
    emit({"phase": label, "config": OPENVIS_CONFIG, "dtype": "bfloat16",
          "clip_adapter": cfg.model.clip_adapter.name,
          "windows": NUM_WINDOWS, "frames_per_window": t, "frame_hw": [h, w],
          "ms_per_window": ms, "frames_per_s": t / (ms / 1e3),
          "split_ms_per_window": split, "peak_mem_gib": peak,
          "flops_json_tflop_per_window": flop / 1e12,
          "tflop_per_s": flop / (ms / 1e3) / 1e12, "bf16_peak_share": flop / (ms / 1e3) / BF16_FLOPS,
          "crops_per_window": q * t,
          "tower_tflop_per_s": crops_flop / (split["crops"] - split["roi_crop"]) / 1e9,
          "valid_queries_scored": [int((o["scores"] > 0).sum()) for o in outs],
          "launches": launches, "expected_launches": expected, **(extra or {}), "card": card})
    if launches != expected:
        raise AssertionError(f"OpenVIS window launches {launches} != {expected}")
    return launches, split


def phase_openvis_vs_plain(cfg, root, phase="openvis_kernels_vs_plain"):
    """15.2: one f32 OpenVIS window at full width at 192x320 on the card
    (kernels) against the CPU (plain), TF32 off, the crops through the
    test-tiny tower (for the ``adapted`` adapter a mask-prompted one, its
    prompt table drawn nonzero)."""
    weights = os.path.join(root, "clip_check.pt")
    depth = (cfg.model.clip_adapter.mask_prompt_depth
             if cfg.model.clip_adapter.name in clip_towers.ADAPTED else 0)
    torch.save(clip_synthetic.openai_state_dict(OPENVIS_CHECK_CLIP, seed=SEED + 5,
                                                mask_prompt_depth=depth), weights)
    f32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, test=dataclasses.replace(cfg.model.test, amp=False),
        clip_adapter=dataclasses.replace(cfg.model.clip_adapter,
                                         clip_model_name=OPENVIS_CHECK_CLIP, weights=weights)))

    def make_eval(model, device):
        visual = clip_towers.build_clip_visual(f32, device)

        def fn(frames, text):
            return _openvis_window(f32, model, visual, text)(frames, frames.cpu().numpy())
        return fn

    cpu_model = init_params(train.build_model(f32, device="cpu"), seed=SEED + 1)
    _hold_window_to_plain(phase, f32, cpu_model, CHECK_TRAIN_H,
                          CHECK_TRAIN_W, make_eval, model_shape(OPENVIS_CHECK_CLIP)["embed_dim"])


def phase_openvis_train(card, cfg):
    """15.3: the OpenVIS train step at full width (bench.py's shape), bf16 AMP
    with f32 masters, class-agnostic; returns the launches."""
    model = init_params(train.build_model(cfg, device=DEVICE), seed=SEED)
    head = model.segmenter.predictor.heads.class_embed.weight
    before = head.detach().clone()
    step = train.build_train_step(cfg, model, K_CLASSES, device=DEVICE)
    batch = _train_batch(np.random.RandomState(SEED), TRAIN_H, TRAIN_W, TRAIN_N, DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
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
    expected = _train_launches(cfg, TRAIN_H, TRAIN_W, TRAIN_STEPS)
    values = [{k: float(v) for k, v in m.items()} for m in metrics]
    moved = not torch.equal(head.detach(), before)
    emit({"phase": "openvis_train_full_width", "dtype": "bf16 AMP, f32 masters",
          "batch": [1, TRAIN_T, TRAIN_H, TRAIN_W], "targets": TRAIN_N,
          "points": cfg.model.criterion.train_num_points, "steps": TRAIN_STEPS,
          "ms_per_step": ms, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "metrics": values, "launches": launches, "expected_launches": expected,
          "proposal_head_moved": moved, "card": card})
    if launches != expected:
        raise AssertionError(f"OpenVIS train-step launches {launches} != {expected}")
    if not all(np.isfinite(v) for m in values for v in m.values()) or not moved:
        raise AssertionError("an OpenVIS loss is not finite or the proposal head did not move")
    return launches


def phase_openvis_train_vs_plain(cfg):
    """15.3b: one f32 OpenVIS train-step loss and gradient, card against CPU."""
    f32 = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, amp=False))
    cpu_model = _offsets_off_centres(
        init_params(train.build_model(f32, device="cpu"), seed=SEED + 2), SEED + 2)
    _hold_train_to_plain("openvis_train_kernels_vs_plain", f32, cpu_model,
                         TRAIN_CHECK_PARAMS + ("segmenter.predictor.heads.class_embed.weight",))


def phase_openvis_engine(card, clip, visual):
    """15.4: the engine with the OpenVIS recipe's eval settings (windows of
    10, bf16 AMP) over phase 10's dataset's second video, the crops through
    the recipe's tower and the text bank of its 40 categories: a warm-up over
    that video, then the timed run with its split (phase 10's stages, the crops
    and their roi_crops on the device) and peak, K4 recorded and held against
    hungarian_plain.  Returns the launches of the timed run."""
    import train_net_torch as cli

    root = tempfile.mkdtemp(prefix="chip_smoke_openvis_engine_")
    try:
        _, write_s = _write_engine_dataset(root)
        cfg = _openvis_config(clip, f"datasets.root={root}", f"datasets.test=[{ENGINE_DATASET}]",
                              f"output_dir={os.path.join(root, 'out')}")
        model = init_params(train.build_model(cfg, device=DEVICE), seed=SEED)
        t0 = time.perf_counter()
        text = cli.build_text_bank(cfg, DEVICE).encode(
            list(catalog.get(ENGINE_DATASET).thing_classes))
        bank_s = time.perf_counter() - t0
        _engine_warm_up(cfg, model, text, visual, _engine_subset(ONLINE_ENGINE_VIDEOS))
        with HungarianRecorder() as tracking:
            metrics, spans, wall, launches = _engine_run(cfg, model, text, DEVICE, visual,
                                                         ONLINE_ENGINE_VIDEOS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        expected = _engine_expected(cfg, launches, ONLINE_ENGINE_VIDEOS)
        finite = all(np.isfinite(v) for v in metrics.values())
        plain = _plain_assignments(tracking.costs)
        cols = [c for cost_cols in tracking.cols for c in cost_cols]
        differ = [i for i, ((ref, _), got) in enumerate(zip(plain, cols))
                  if not torch.equal(ref, got)]
        q = cfg.model.transformer_decoder.num_queries
        shape = model_shape(cfg.model.clip_adapter.clip_model_name)
        crops = q * spans.frames
        clip_s = spans.device_seconds("clip_crops")
        split = {**_engine_split(spans, wall),
                 "openvis_tracking_clip_topk_device": spans.device_seconds("openvis_topk"),
                 "clip_crops_device": clip_s, "roi_crop_device": spans.device_seconds("roi_crop"),
                 "text_bank_host": bank_s}
        emit({"phase": "openvis_engine_full_width", "config": OPENVIS_CONFIG,
              "dataset": "synthetic YTVIS-2019 format, 40 classes",
              "videos_hwtn": ONLINE_ENGINE_VIDEOS,
              "dtype": "bf16 AMP" if cfg.model.test.amp else "float32",
              "window": engine.window_size(cfg), "metrics": metrics, "metrics_finite": finite,
              "predictions": len(spans.preds), "launches": launches,
              "expected_launches": expected, "frames": spans.frames, "wall_s": wall,
              "frames_per_s": spans.frames / wall, "split_s": split, "peak_mem_gib": peak,
              "crops": crops, "clip_tflop_per_s": crops * vit_flops(shape) / clip_s / 1e12,
              "k4_problems": len(plain), "k4_equal_to_plain": not differ,
              "k4_problems_differing": differ, "dataset_write_s": write_s, "card": card})
        if launches != expected:
            raise AssertionError(f"OpenVIS engine launches {launches} != {expected}")
        if not finite or set(metrics) < {"AP", "AP50", "AR10"} or not spans.preds:
            raise AssertionError(f"OpenVIS engine metrics {metrics}, {len(spans.preds)} predictions")
        if len(spans.events["openvis_topk"]) != len(ONLINE_ENGINE_VIDEOS) or \
                not spans.events["roi_crop"]:
            raise AssertionError("the engine did not score the crops with CLIP")
        if differ or len(tracking.costs) != expected["hungarian"]:
            raise AssertionError(f"K4 on the OpenVIS engine's costs differs from hungarian_plain: "
                                 f"{differ}")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_openvis(card, clip):
    """Phase 15: OpenVISOnline with the recipe's model and its CLIP tower (a
    random ViT-B/16 in OpenAI's layout from ``clip``); returns its paths'
    launch counts by name and the window's split (ms by span), which phase 22
    prints beside the adapted tower's."""
    cfg = _openvis_config(clip)
    visual = clip_towers.build_clip_visual(cfg, DEVICE)
    launches = {}
    launches["openvis_eval"], split_ms = phase_openvis_window(card, cfg, visual)
    root = tempfile.mkdtemp(prefix="chip_smoke_openvis_")
    try:
        phase_openvis_vs_plain(cfg, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches["openvis_train"] = phase_openvis_train(card, cfg)
    phase_openvis_train_vs_plain(cfg)
    launches["openvis_engine"] = phase_openvis_engine(card, clip, visual)
    del visual
    torch.cuda.empty_cache()
    launches["openvis_cli_train"], launches["openvis_cli_eval"] = _recipe_cli(
        card, clip, OPENVIS_CONFIG, OPENVIS_CLI_STEPS, "openvis")
    return launches, split_ms


def _burst_config(clip, root, name, *overrides):
    """eval_burst.yaml (the SAN recipe on BURST) over the dataset ``name`` under
    ``root``, with the CLIP files ``clip``."""
    return load_config(BURST_CONFIG, [f"model.clip_adapter.weights={clip[0]}",
                                      f"model.clip_adapter.bpe_vocab={clip[1]}",
                                      f"datasets.root={root}", f"datasets.test=[{name}]",
                                      f"output_dir={os.path.join(root, name)}", *overrides])


def _burst_engine_vs_plain(root, clip, tree):
    """16.2: one short f32 BURST sequence through SAN's engine and the BURST
    evaluator on the card (kernels) and on the CPU (plain), from one model,
    held to phase 10's f32 bounds."""
    name = BURST_DATASET + "_check"
    catalog.register(dataclasses.replace(synthetic.write_burst_dataset(
        root, "burst_check", [BURST_CHECK_SEQUENCE], seed=SEED + 3), name=name))
    h, w = BURST_CHECK_SEQUENCE[:2]
    base = _burst_config(clip, root, name, "model.test.amp=false",
                         "model.test.window_inference=true",
                         f"model.test.window_size={ENGINE_CHECK_WINDOW}",
                         f"input.min_size_test={h}", f"input.pad_size=[{h},{w}]")
    model = _san_model(base, tree, "cpu", SEED + 3)
    text = _text(np.random.RandomState(SEED + 3), k=len(catalog.get(name).thing_classes))
    runs = {}
    for device in ("cpu", DEVICE):
        cfg = dataclasses.replace(base, output_dir=os.path.join(root, f"burst_check_{device}"))
        reset_counts()
        t0 = time.perf_counter()
        metrics = engine.evaluate_dataset(cfg, model, name, text, device=device)
        seconds = time.perf_counter() - t0
        with open(os.path.join(cfg.output_dir, f"results_{name}.json")) as f:
            runs[device] = (metrics, json.load(f), seconds, read_counts())
    (m_ref, p_ref, s_ref, _), (m_got, p_got, s_got, launches) = runs["cpu"], runs[DEVICE]
    same = [p["category_id"] for p in p_got] == [p["category_id"] for p in p_ref]
    # a frame present on one side only: its mask is at most twice min_area
    # (a few pixels at the > 0 threshold may cross the rule's line)
    one_sided = [rle.area(x or y) for a, b in zip(p_got, p_ref)
                 for x, y in zip(a["segmentations"], b["segmentations"])
                 if (x is None) != (y is None)]
    same = same and all(area <= 2 * 20 for area in one_sided)
    score_err = max((abs(a["score"] - b["score"]) for a, b in zip(p_got, p_ref)), default=0.0)
    agree = min((float((rle.decode(x) == rle.decode(y)).mean())
                 for a, b in zip(p_got, p_ref)
                 for x, y in zip(a["segmentations"], b["segmentations"]) if x is not None and
                 y is not None), default=1.0)
    metric_err = max(abs(m_got[k] - m_ref[k]) for k in m_ref)
    emit({"phase": "burst_kernels_vs_plain", "dtype": "float32", "tf32": False,
          "sequence_hwtn": BURST_CHECK_SEQUENCE, "window": ENGINE_CHECK_WINDOW,
          "predictions": [len(p_got), len(p_ref)], "categories_equal": same,
          "frames_present_on_one_side": one_sided,
          "max_abs_score_err": score_err, "min_mask_agreement": agree,
          "max_abs_metric_err": metric_err, "metrics_kernel": m_got, "metrics_plain": m_ref,
          "kernel_launches": launches, "seconds_card_cpu": [s_got, s_ref],
          "tol": {"score_atol": ENGINE_F32_SCORE_ATOL, "mask_agree": ENGINE_F32_MASK_AGREE,
                  "metric_atol": ENGINE_F32_METRIC_ATOL}})
    if not (same and len(p_got) == len(p_ref) and score_err <= ENGINE_F32_SCORE_ATOL
            and agree >= ENGINE_F32_MASK_AGREE and metric_err <= ENGINE_F32_METRIC_ATOL):
        raise AssertionError("the BURST engine on the card disagrees with the engine on the CPU")
    if launches["msda_fwd"] == 0 or launches["hungarian"] == 0:
        raise AssertionError(f"the card's BURST engine run skipped a kernel: {launches}")


def phase_burst(card, clip, stage1):
    """Phase 16: BURST evaluation of SANOnline (eval_burst.yaml) over a
    synthetic BURST dataset written from the seed: a warm-up over the first
    sequence, then the timed engine run (HOTA, DetA, AssA, mAP; the host
    seconds of HOTA and of TrackMAP; K4 recorded and held against
    hungarian_plain); one f32 sequence card against CPU; then
    ``train_net_torch.py --eval-only`` with eval_burst.yaml on phase 13's SAN
    checkpoint ``stage1``.  Returns the launches of the engine's and the CLI's
    runs."""
    import train_net_torch as cli

    tree = cli.read_clip(_san_config(clip))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = tempfile.mkdtemp(prefix="chip_smoke_burst_")
    try:
        t0 = time.perf_counter()
        info = synthetic.write_burst_dataset(root, "burst", BURST_SEQUENCES, seed=SEED)
        catalog.register(dataclasses.replace(info, name=BURST_DATASET))
        write_s = time.perf_counter() - t0
        cfg = _burst_config(clip, root, BURST_DATASET)
        model = _san_model(cfg, tree, DEVICE, SEED)
        k = len(info.thing_classes)
        text = _text(np.random.RandomState(SEED), k=k)
        _engine_warm_up(cfg, model, text, dataset=BURST_DATASET)
        reset_counts()
        with HungarianRecorder() as tracking, EngineSpans() as spans:
            t0 = time.perf_counter()
            metrics = engine.evaluate_dataset(cfg, model, BURST_DATASET, text, device=DEVICE)
            wall = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        expected = _engine_expected(cfg, launches, BURST_SEQUENCES)
        finite = all(np.isfinite(v) for v in metrics.values())
        plain = _plain_assignments(tracking.costs)
        cols = [c for cost_cols in tracking.cols for c in cost_cols]
        differ = [i for i, ((ref, _), got) in enumerate(zip(plain, cols))
                  if not torch.equal(ref, got)]
        hota_s = spans.host["hota"]
        emit({"phase": "burst_engine_full_width", "config": BURST_CONFIG,
              "dataset": "synthetic BURST (TAO schema), 482 LVIS classes",
              "sequences_hwtn": BURST_SEQUENCES, "classes": k,
              "dtype": "bf16 AMP" if cfg.model.test.amp else "float32",
              "window": engine.window_size(cfg), "metrics": metrics, "metrics_finite": finite,
              "tracks_predicted": len(spans.preds), "launches": launches,
              "expected_launches": expected, "frames": spans.frames, "wall_s": wall,
              "frames_per_s": spans.frames / wall, "split_s": _engine_split(spans, wall),
              "hota_host_s": hota_s, "trackmap_host_s": spans.host["burst_evaluate"] - hota_s,
              "peak_mem_gib": peak, "k4_problems": len(plain), "k4_equal_to_plain": not differ,
              "k4_problems_differing": differ, "dataset_write_s": write_s, "card": card})
        if launches != expected:
            raise AssertionError(f"BURST engine launches {launches} != {expected}")
        if not finite or set(metrics) < {"HOTA", "DetA", "AssA", "mAP"} or not spans.preds:
            raise AssertionError(f"BURST engine metrics {metrics}, {len(spans.preds)} tracks")
        if differ or len(tracking.costs) != expected["hungarian"]:
            raise AssertionError(f"K4 on the BURST engine's costs differs from hungarian_plain: "
                                 f"{differ}")
        del model
        _burst_engine_vs_plain(root, clip, tree)

        out = os.path.join(root, "cli")
        reset_counts()
        t0 = time.perf_counter()
        cli.main(["--config-file", BURST_CONFIG, "--eval-only", "--weights", stage1,
                  f"model.clip_adapter.weights={clip[0]}", f"model.clip_adapter.bpe_vocab={clip[1]}",
                  f"datasets.root={root}", f"datasets.test=[{BURST_DATASET}]",
                  f"output_dir={out}"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        cli_launches = read_counts()
        with open(os.path.join(out, f"metrics_{BURST_DATASET}.json")) as f:
            cli_metrics = json.load(f)
        emit({"phase": "burst_cli_eval", "config": BURST_CONFIG, "weights": "phase 13's SAN "
              "checkpoint", "metrics": cli_metrics, "wall_s": cli_s, "launches": cli_launches,
              "expected_launches": expected, "card": card})
        if set(cli_metrics) < {"HOTA", "DetA", "AssA", "mAP"} or \
                not all(np.isfinite(v) for v in cli_metrics.values()):
            raise AssertionError(f"the BURST CLI eval wrote {cli_metrics}")
        if cli_launches != expected:
            raise AssertionError(f"BURST CLI eval launches {cli_launches} != {expected}")
        return {"burst_engine": launches, "burst_cli_eval": cli_launches}
    finally:
        shutil.rmtree(root, ignore_errors=True)


class StageSpans:
    """CUDA events around named stages (``name -> (object, attribute)``: the
    callable is patched on the object for the run) and around each call of a
    window function wrapped by ``window``."""

    def __init__(self, targets):
        self._targets = targets

    def __enter__(self):
        self.events = {k: [] for k in (*self._targets, "windows")}
        self._orig = {k: (getattr(obj, name), name in vars(obj))
                      for k, (obj, name) in self._targets.items()}

        def around(key, fn):
            def timed(*a, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*a, **kw)
                end.record()
                self.events[key].append((start, end))
                return out
            return timed

        for key, (obj, name) in self._targets.items():
            setattr(obj, name, around(key, self._orig[key][0]))
        self.window = lambda fn: around("windows", fn)
        return self

    def __exit__(self, *exc):
        for key, (obj, name) in self._targets.items():
            fn, own = self._orig[key]
            if own:
                setattr(obj, name, fn)
            else:
                delattr(obj, name)  # a module's forward: the class's method again

    def split_ms(self, rest: str, windows: int):
        """Milliseconds of each stage a window, and ``rest``: the windows' time
        less the stages'."""
        torch.cuda.synchronize()
        out = {k: sum(a.elapsed_time(b) for a, b in self.events[k]) / windows
               for k in self._targets}
        total = sum(a.elapsed_time(b) for a, b in self.events["windows"]) / windows
        out[rest] = total - sum(out.values())
        return out


def _offline_config(config, clip, *overrides):
    """An offline recipe with the CLIP files ``clip`` (weights, bpe) and
    ``overrides``."""
    return load_config(config, [f"model.clip_adapter.weights={clip[0]}",
                                f"model.clip_adapter.bpe_vocab={clip[1]}", *overrides])


def _timed_shots(model, cfg, clips, text, eval_fn=None):
    """Three timed shots of ``eval_fn`` (``train.make_eval_fn``'s unless
    given) after a warm-up: (outputs, ms a shot, peak GiB, launches)."""
    eval_fn = eval_fn or train.make_eval_fn(cfg, model)
    eval_fn(clips[0], text)  # warm-up: cuDNN autotuning, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts()
    start.record()
    outs = [eval_fn(x, text) for x in clips]
    end.record()
    torch.cuda.synchronize()
    launches = read_counts()
    return (outs, start.elapsed_time(end) / len(clips),
            torch.cuda.max_memory_allocated() / 2 ** 30, launches)


def _cap_shot(eval_fn, text, q, k, where):
    """The single-shot cap: one shot of test.max_frames = 128 frames on the
    480x864 canvas every test video is padded to, through ``eval_fn``, cold
    then warm; its outputs checked (``q`` queries, ``k`` classes).  Returns
    the reading (ms cold and warm, frames/s, peak GiB)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    frames = torch.randn(OFFLINE_CAP_T, OFFLINE_CAP_H, OFFLINE_CAP_W, 3, generator=gen,
                         device=DEVICE).to(torch.bfloat16)
    ms = []
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = eval_fn(frames, text)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _check_outputs(out, q, k, OFFLINE_CAP_T, OFFLINE_CAP_H, OFFLINE_CAP_W, where)
    del frames, out
    torch.cuda.empty_cache()
    return {"frames": OFFLINE_CAP_T, "frame_hw": [OFFLINE_CAP_H, OFFLINE_CAP_W],
            "ms_cold_warm": ms, "frames_per_s": OFFLINE_CAP_T / (ms[1] / 1e3),
            "peak_mem_gib": peak}


def _random_clips(rng, n, t, h, w):
    return [torch.from_numpy(rng.randn(t, h, w, 3).astype(np.float32)).to(DEVICE, torch.bfloat16)
            for _ in range(n)]


def phase_offline_shot(card, cfg):
    """17.1: offline SimpleBaseline-R50 (the recipe's model, random weights from
    the seed, bf16) through ``train.make_eval_fn``: three single shots of
    10x384x640 with their split (backbone, pixel decoder, video decoder, the
    scores and top-k); then one shot of test.max_frames = 128 frames on the
    480x864 canvas (twice: cold, then warm) with its peak memory.  Returns
    the launches of the three shots."""
    model = init_params(train.build_model(cfg, device=DEVICE), seed=SEED).to(
        dtype=torch.bfloat16).eval()
    rng = np.random.RandomState(SEED)
    t, h, w = WINDOW_FRAMES, FRAME_H, FRAME_W
    clips = _random_clips(rng, NUM_WINDOWS, t, h, w)
    text = torch.from_numpy(_text(rng)).to(DEVICE, torch.bfloat16)
    outs, ms, peak, launches = _timed_shots(model, cfg, clips, text)
    seg = model.segmenter
    with StageSpans({"backbone": (seg.backbone, "forward"),
                     "pixel_decoder": (seg.pixel_decoder, "forward"),
                     "video_decoder": (seg.predictor, "forward")}) as spans:
        timed = spans.window(train.make_eval_fn(cfg, model))
        for x in clips:
            timed(x, text)
    split = spans.split_ms("scores_topk", NUM_WINDOWS)
    q = cfg.model.transformer_decoder.num_queries
    for i, out in enumerate(outs):
        _check_outputs(out, q, K_CLASSES, t, h, w, f"offline shot {i}")
    enc = cfg.model.pixel_decoder.transformer_enc_layers
    expected = {**{k: 0 for k in launches}, "msda_fwd": enc * NUM_WINDOWS}
    del outs, clips
    cap = _cap_shot(train.make_eval_fn(cfg, model), text, q, K_CLASSES, "offline cap")
    tokens = OFFLINE_CAP_T * (OFFLINE_CAP_H // 8) * (OFFLINE_CAP_W // 8)
    emit({"phase": "offline_shot_full_width", "config": OFFLINE_CONFIG, "dtype": "bfloat16",
          "shots": NUM_WINDOWS, "frames_per_shot": t, "frame_hw": [h, w], "ms_per_shot": ms,
          "frames_per_s": t / (ms / 1e3), "split_ms_per_shot": split, "peak_mem_gib": peak,
          "launches": launches, "expected_launches": expected,
          "cap_shot": {**cap, "level2_tokens": tokens}, "card": card})
    if launches != expected:
        raise AssertionError(f"offline shot launches {launches} != {expected}")
    del model
    torch.cuda.empty_cache()
    return launches


def _single_shot_eval(cfg):
    """``make_eval`` for ``_hold_window_to_plain``: the engine's single shot of
    a clip padded to ``_bucket(t)`` frames with its last frame, the top-k
    masks cut to the t real frames."""
    def make_eval(model, device):
        shot = engine.make_single_shot_fn(cfg, model)
        params = {n: p.detach() for n, p in model.named_parameters()}

        @torch.inference_mode()
        def fn(frames, text):
            t = frames.shape[0]
            tb = engine._bucket(t)
            out = shot(params, engine._pad_frames(frames, tb), text,
                       torch.arange(tb, device=frames.device) < t)
            return {**out, "mask_logits": out["mask_logits"][:, :t]}
        return fn
    return make_eval


def phase_offline_vs_plain(cfg):
    """17.2: the same model in f32 at 192x320 on T=5 frames padded to 8 (the
    engine's single shot), card (kernels) against CPU (plain), phase 7's
    bounds."""
    cpu_model = init_params(train.build_model(cfg, device="cpu"), seed=SEED + 1)
    _hold_window_to_plain("offline_kernels_vs_plain", cfg, cpu_model, CHECK_TRAIN_H,
                          CHECK_TRAIN_W, make_eval=_single_shot_eval(cfg),
                          frames=OFFLINE_CHECK_T, kernels=("msda_fwd",))


def phase_offline_train(card, cfg, label, hold=True):
    """17.3 / 17.5: the clip-level train step at full width (1x2x480x864,
    N=40, bf16 AMP, f32 masters): one warm-up and three timed steps, the
    launches of K1-K6, K5's call shapes (clip-level rows: Q*T and N*T); with
    ``hold``, K1, K2, K3, K4, K5 and K6 on the warm-up step's recorded inputs
    against their plain versions.  Returns the launches of the timed steps."""
    model = init_params(train.build_model(cfg, device=DEVICE), seed=SEED)
    head = model.segmenter.predictor.heads.class_embed
    before = [p.detach().clone() for p in head.parameters()]
    step = train.build_train_step(cfg, model, K_CLASSES, device=DEVICE)
    batch = _train_batch(np.random.RandomState(SEED), TRAIN_H, TRAIN_W, TRAIN_N, DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    with MsdaRecorder() as msda_rec, HungarianRecorder() as k4_rec, SamplerInputs() as s_rec:
        step(batch, gen)  # warm-up: cuDNN autotuning, allocator; its inputs recorded
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
    expected = _train_launches(cfg, TRAIN_H, TRAIN_W, TRAIN_STEPS)
    # K5's calls: phase 5's three samplings, their rows a clip's Q*T masks
    # (the matcher) and N*T targets (the losses)
    clip_shapes = {case: (1, rows * TRAIN_T, h, w, p)
                   for case, (_, rows, h, w, p) in SAMPLER_CASES.items()}
    by_shape = {case: shapes.counts.pop(shape, 0) for case, shape in clip_shapes.items()}
    other_shapes = {str(k): v for k, v in shapes.counts.items()}
    values = [{k: float(v) for k, v in m.items()} for m in metrics]
    moved = not all(torch.equal(p.detach(), b) for p, b in zip(head.parameters(), before))
    emit({"phase": f"{label}_full_width", "config": cfg.model.meta_architecture,
          "decoder": cfg.model.transformer_decoder.name, "dtype": "bf16 AMP, f32 masters",
          "batch": [1, TRAIN_T, TRAIN_H, TRAIN_W], "targets": TRAIN_N,
          "points": cfg.model.criterion.train_num_points, "steps": TRAIN_STEPS,
          "ms_per_step": ms, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "metrics": values, "launches": launches, "expected_launches": expected,
          "k5_launches_by_shape": {c: [list(clip_shapes[c]), n] for c, n in by_shape.items()},
          "k5_launches_at_other_shapes": other_shapes, "class_head_moved": moved,
          "card": card})
    if launches != expected:
        raise AssertionError(f"{label} launches {launches} != {expected}")
    if other_shapes or min(by_shape.values()) == 0:
        raise AssertionError(f"{label}: K5's shapes {by_shape}, others {other_shapes}, are not "
                             f"the clip-level {clip_shapes}")
    if not all(np.isfinite(v) for m in values for v in m.values()) or not moved:
        raise AssertionError(f"{label}: a loss is not finite or the class head did not move")
    if hold:
        _hold_k1(label, msda_rec)
        _hold_k2_k3(label, msda_rec)
        _hold_k4_k5_k6(label, k4_rec, s_rec, k4_calls=1)
    del model, step
    torch.cuda.empty_cache()
    return launches


def phase_offline_train_vs_plain(cfg):
    """17.3b: one f32 clip-level train-step loss and gradient at 1x2x192x320,
    card against CPU, phase 9's bounds."""
    f32 = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, amp=False))
    cpu_model = _offsets_off_centres(
        init_params(train.build_model(f32, device="cpu"), seed=SEED + 2), SEED + 2)
    _hold_train_to_plain("offline_train_kernels_vs_plain", f32, cpu_model,
                         TRAIN_CHECK_PARAMS + ("segmenter.predictor.heads.class_embed.layer1.weight",))


def phase_offline_engine(card, cfg, label, model, text, visual=None, videos=ENGINE_VIDEOS):
    """17.4 / 17.5 / 17.6: the engine with an offline recipe's eval settings
    over ``videos`` of phase 10's dataset (written to ``cfg.datasets.root``;
    ``_engine_subset``): a warm-up over the first of them, then the timed
    run, single-shot (36 -> 40 and 19 -> 24 frames; the 133-frame video in
    windows of ``window_size``), with its split (the shots, the windows, the
    CLIP crops), its peak and its launches: K1 only.  Returns the launches
    of the timed run."""
    _engine_warm_up(cfg, model, text, visual, _engine_subset(videos))
    with HungarianRecorder() as tracking:
        metrics, spans, wall, launches = _engine_run(cfg, model, text, DEVICE, visual, videos)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = _engine_expected(cfg, launches, videos)
    finite = all(np.isfinite(v) for v in metrics.values())
    split = {**_engine_split(spans, wall),
             "single_shots_device": spans.device_seconds("single_shot"),
             "single_shot_windows_device": spans.device_seconds("single_shot_windows"),
             "clip_crops_device": spans.device_seconds("clip_crops"),
             "roi_crop_device": spans.device_seconds("roi_crop")}
    max_frames, window = cfg.model.test.max_frames, engine.window_size(cfg)
    forwards = [[engine._bucket(t)] if engine._bucket(t) <= max_frames else
                [window] * -(-t // window) for _, _, t, _ in videos]
    emit({"phase": f"{label}_full_width", "config": cfg.model.meta_architecture,
          "decoder": cfg.model.transformer_decoder.name,
          "dataset": "synthetic YTVIS-2019 format, 40 classes", "videos_hwtn": videos,
          "forward_frames_per_video": forwards, "ensemble": visual is not None,
          "dtype": "bf16 AMP" if cfg.model.test.amp else "float32",
          "max_frames": max_frames, "window": window, "metrics": metrics,
          "metrics_finite": finite, "predictions": len(spans.preds), "launches": launches,
          "expected_launches": expected, "frames": spans.frames, "wall_s": wall,
          "frames_per_s": spans.frames / wall, "split_s": split, "peak_mem_gib": peak,
          "card": card})
    if launches != expected or tracking.costs:
        raise AssertionError(f"{label} launches {launches} != {expected}")
    if not finite or set(metrics) < {"AP", "AP50", "AR10"} or not spans.preds:
        raise AssertionError(f"{label} metrics {metrics}, {len(spans.preds)} predictions")
    shots = len(spans.events["single_shot"]) + len(spans.events["single_shot_windows"])
    if shots != sum(map(len, forwards)) or (visual is not None and not spans.events["roi_crop"]):
        raise AssertionError(f"{label}: {shots} single-shot forwards, crops "
                             f"{len(spans.events['roi_crop'])}")
    return launches


def _engine_root_config(config, clip, root, *overrides):
    return _offline_config(config, clip, f"datasets.root={root}",
                           f"datasets.test=[{ENGINE_DATASET}]",
                           f"output_dir={os.path.join(root, 'out')}", *overrides)


def phase_offline_simple_baseline(card, clip):
    """17.1-17.4: offline SimpleBaseline-R50; returns its paths' launches."""
    import train_net_torch as cli

    cfg = _offline_config(OFFLINE_CONFIG, clip)
    launches = {"offline_eval": phase_offline_shot(card, cfg)}
    phase_offline_vs_plain(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, test=dataclasses.replace(cfg.model.test, amp=False))))
    launches["offline_train"] = phase_offline_train(card, cfg, "offline_train")
    phase_offline_train_vs_plain(cfg)
    root = tempfile.mkdtemp(prefix="chip_smoke_offline_engine_")
    try:
        _write_engine_dataset(root)
        cfg = _engine_root_config(OFFLINE_CONFIG, clip, root)
        model = init_params(train.build_model(cfg, device=DEVICE), seed=SEED)
        text = cli.build_text_bank(cfg, DEVICE).encode(
            list(catalog.get(ENGINE_DATASET).thing_classes))
        visual = clip_towers.build_clip_visual(cfg, DEVICE)
        launches["offline_engine"] = phase_offline_engine(card, cfg, "offline_engine", model,
                                                          text, visual)
        del model, visual
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def phase_offline_openvis(card, clip):
    """17.5: offline OpenVIS (the recipe's model, ``model.weights`` left empty:
    the converted Mask2Former checkpoint is not in the repository): its train
    step, its engine over phase 10's dataset (scored on the objectness, as the
    JAX engine does: no tower), and the ``frame_proposal`` recipe's engine on
    phase 10's f32 check video, card against CPU.  Returns its paths'
    launches."""
    cfg = _offline_config(OPENVIS_OFFLINE_CONFIG, clip, "model.weights=")
    launches = {"openvis_offline_train": phase_offline_train(card, cfg, "openvis_offline_train",
                                                             hold=False)}
    root = tempfile.mkdtemp(prefix="chip_smoke_openvis_offline_")
    try:
        cats, _ = _write_engine_dataset(root)
        cfg = _engine_root_config(OPENVIS_OFFLINE_CONFIG, clip, root, "model.weights=")
        model = init_params(train.build_model(cfg, device=DEVICE), seed=SEED)
        launches["openvis_offline_engine"] = phase_offline_engine(
            card, cfg, "openvis_offline_engine", model, _text(np.random.RandomState(SEED)),
            videos=OFFLINE_ENGINE_VIDEOS)
        del model
        torch.cuda.empty_cache()
        name = _write_check_video(root, cats)
        base = _check_config(_offline_config(OPENVIS_FRAME_CONFIG, clip), root, name)
        cpu_model = init_params(train.build_model(base, device="cpu"), seed=SEED + 3)
        launches["openvis_frame_check"], _ = _hold_engine_to_plain(
            "openvis_frame_engine_kernels_vs_plain", base, cpu_model,
            _text(np.random.RandomState(SEED + 3)), name, root, kernels=("msda_fwd",),
            extra={"config": OPENVIS_FRAME_CONFIG, "decoder": "frame_proposal"})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def phase_offline_san(card, clip):
    """17.6: offline SAN (the recipe's model: the video side-adapter decoder
    over the CLIP split of phase 11's random ViT-B/16): three timed 10x384x640
    bf16 shots with their split (CLIP front, segmenter, CLIP post, top-k);
    an f32 shot at 192x320, card against CPU; the engine over phase 10's
    dataset with its peak; its train step raising its named error.  Returns
    its paths' launches."""
    import train_net_torch as cli

    cfg = _offline_config(SAN_OFFLINE_CONFIG, clip)
    tree = cli.read_clip(cfg)
    model = _san_model(cfg, tree, DEVICE, SEED).to(dtype=torch.bfloat16).eval()
    rng = np.random.RandomState(SEED)
    t, h, w = WINDOW_FRAMES, FRAME_H, FRAME_W
    clips = _random_clips(rng, NUM_WINDOWS, t, h, w)
    text = torch.from_numpy(_text(rng)).to(DEVICE, torch.bfloat16)
    outs, ms, peak, eval_launches = _timed_shots(model, cfg, clips, text)
    with StageSpans({"clip_front": (model.clip_adapter, "front_encode"),
                     "segmenter": (model.segmenter, "forward"),
                     "clip_post": (model.clip_adapter, "post_encode")}) as spans:
        timed = spans.window(train.make_eval_fn(cfg, model))
        for x in clips:
            timed(x, text)
    split = spans.split_ms("scores_topk", NUM_WINDOWS)
    q = cfg.model.transformer_decoder.num_queries
    for i, out in enumerate(outs):
        _check_outputs(out, q, K_CLASSES, t, h, w, f"offline SAN shot {i}")
    enc = cfg.model.pixel_decoder.transformer_enc_layers
    expected = {**{k: 0 for k in eval_launches}, "msda_fwd": enc * NUM_WINDOWS}
    try:
        train.build_train_step(cfg, model.float(), K_CLASSES, device=DEVICE)
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    emit({"phase": "san_offline_shot_full_width", "config": SAN_OFFLINE_CONFIG,
          "dtype": "bfloat16", "shots": NUM_WINDOWS, "frames_per_shot": t, "frame_hw": [h, w],
          "ms_per_shot": ms, "frames_per_s": t / (ms / 1e3), "split_ms_per_shot": split,
          "peak_mem_gib": peak, "launches": eval_launches, "expected_launches": expected,
          "train_step_refused": refused, "card": card})
    if eval_launches != expected:
        raise AssertionError(f"offline SAN shot launches {eval_launches} != {expected}")
    if not refused or "criterion.py:290" not in refused or "ROADMAP.md §3" not in refused:
        raise AssertionError(f"offline SAN's train step did not raise its named error: {refused}")
    del outs, clips, model
    torch.cuda.empty_cache()
    f32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, test=dataclasses.replace(cfg.model.test, amp=False)))
    _hold_window_to_plain("san_offline_kernels_vs_plain", f32,
                          _san_model(f32, tree, "cpu", SEED + 1), CHECK_TRAIN_H, CHECK_TRAIN_W,
                          kernels=("msda_fwd",))
    root = tempfile.mkdtemp(prefix="chip_smoke_san_offline_")
    try:
        _write_engine_dataset(root)
        cfg = _engine_root_config(SAN_OFFLINE_CONFIG, clip, root)
        model = _san_model(cfg, tree, DEVICE, SEED)
        engine_launches = phase_offline_engine(card, cfg, "san_offline_engine", model,
                                               _text(np.random.RandomState(SEED)),
                                               videos=OFFLINE_ENGINE_VIDEOS)
        del model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"san_offline_eval": eval_launches, "san_offline_engine": engine_launches}


def phase_video_maskformer_minvis(card):
    """17.7: VideoMaskFormer (``video``) and MinVIS (``frame``), the class head
    over Config()'s 40 classes: an f32 window each at 192x320, card against
    CPU; then MinVIS through the engine on phase 10's f32 check video, card
    against CPU, with K4 on its tracking costs held to ``hungarian_plain``.
    Returns the MinVIS engine run's launches."""
    def arch(name, decoder):
        cfg = _full_config(amp=False)
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, meta_architecture=name, transformer_decoder=dataclasses.replace(
                cfg.model.transformer_decoder, name=decoder)))

    vmf, minvis = arch("VideoMaskFormer", "video"), arch("MinVIS", "frame")
    _hold_window_to_plain("video_maskformer_kernels_vs_plain", vmf,
                          init_params(train.build_model(vmf, device="cpu"), seed=SEED + 1),
                          CHECK_TRAIN_H, CHECK_TRAIN_W, kernels=("msda_fwd",))
    _hold_window_to_plain("minvis_kernels_vs_plain", minvis,
                          init_params(train.build_model(minvis, device="cpu"), seed=SEED + 1),
                          CHECK_TRAIN_H, CHECK_TRAIN_W)
    root = tempfile.mkdtemp(prefix="chip_smoke_minvis_")
    try:
        cats = catalog.category_table("ytvis_2019_val")
        name = _write_check_video(root, cats)
        base = _check_config(minvis, root, name)
        model = init_params(train.build_model(base, device="cpu"), seed=SEED + 3)
        launches, tracking = _hold_engine_to_plain(
            "minvis_engine_kernels_vs_plain", base, model, _text(np.random.RandomState(SEED + 3)),
            name, root, extra={"config": "MinVIS", "decoder": "frame"})
        plain = _plain_assignments(tracking.costs)
        cols = [c for cost_cols in tracking.cols for c in cost_cols]
        differ = [i for i, ((ref, _), got) in enumerate(zip(plain, cols))
                  if not torch.equal(ref, got)]
        emit({"phase": "k4_recorded_inputs", "path": "minvis_engine",
              "shapes": [list(c.shape) for c in tracking.costs], "equal_to_plain": not differ,
              "problems_differing": differ})
        if differ or len(tracking.costs) != 1:
            raise AssertionError(f"K4 on MinVIS's tracking costs differs from hungarian_plain: "
                                 f"{differ}")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_san_offline_cli(card, clip, stage1, config=SAN_OFFLINE_CONFIG, label="san_offline",
                          overrides=()):
    """17.8b / 18.9: ``train_net_torch.py --eval-only`` with the offline SAN
    recipe ``config`` (san_R50_bs16_6000st.yaml) on a SANOnline checkpoint
    ``stage1`` (the same parameter tree; phase 13's): the single-shot eval
    over phase 11's eval set.  Returns its launches."""
    import train_net_torch as cli

    root = tempfile.mkdtemp(prefix=f"chip_smoke_{label}_cli_")
    try:
        out = os.path.join(root, "out")
        common = _cli_data(root) + [f"model.clip_adapter.weights={clip[0]}",
                                    f"model.clip_adapter.bpe_vocab={clip[1]}",
                                    f"output_dir={out}", *overrides]
        reset_counts()
        t0 = time.perf_counter()
        cli.main(["--config-file", config, "--eval-only", "--weights", stage1, *common])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        cfg = load_config(config, common)
        with open(os.path.join(out, f"metrics_{cfg.datasets.test[0]}.json")) as f:
            metrics = json.load(f)
        expected = _engine_expected(cfg, launches, CLI_EVAL_VIDEOS)
        emit({"phase": f"{label}_cli_eval", "config": config,
              "weights": "a SANOnline checkpoint of the CLI", "metrics": metrics, "wall_s": wall,
              "launches": launches, "expected_launches": expected, "card": card})
        if not metrics or not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"the offline SAN CLI eval wrote {metrics}")
        if launches != expected:
            raise AssertionError(f"offline SAN CLI eval launches {launches} != {expected}")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_offline(card, clip, stage1):
    """Phase 17: the offline (clip-level) archs; returns their paths' launch
    counts by name.  ``stage1``: phase 13's SANOnline checkpoint directory."""
    launches = phase_offline_simple_baseline(card, clip)
    launches.update(phase_offline_openvis(card, clip))
    launches.update(phase_offline_san(card, clip))
    launches["minvis_engine"] = phase_video_maskformer_minvis(card)
    launches["offline_cli_train"], launches["offline_cli_eval"] = _recipe_cli(
        card, clip, OFFLINE_CONFIG, OFFLINE_CLI_STEPS, "offline")
    launches["san_offline_cli_eval"] = phase_san_offline_cli(card, clip, stage1)
    return launches


def _ov2seg_config(clip, *overrides):
    """The OV2Seg recipe with the CLIP files ``clip`` (weights, bpe) and ``overrides``."""
    return load_config(OV2SEG_CONFIG, [f"model.clip_adapter.weights={clip[0]}",
                                       f"model.clip_adapter.bpe_vocab={clip[1]}", *overrides])


def phase_ov2seg_window(card, cfg):
    """18.1: OV2Seg's eval window at full width, bf16: three 10x384x640 windows
    through ``train.make_eval_fn`` (padded to 16 frames, the EMA chain, the
    gated top-k) with their split; returns the launches."""
    model = init_params(train.build_model(cfg, device=DEVICE), seed=SEED).to(
        dtype=torch.bfloat16).eval()
    rng = np.random.RandomState(SEED)
    t, h, w = WINDOW_FRAMES, FRAME_H, FRAME_W
    clips = _random_clips(rng, NUM_WINDOWS, t, h, w)
    text = torch.from_numpy(_text(rng)).to(DEVICE, torch.bfloat16)
    outs, ms, peak, launches = _timed_shots(model, cfg, clips, text)
    with StageSpans({"segmenter": (model.segmenter, "forward"),
                     "ema_tracking": (engine, "track_by_embeds")}) as spans:
        timed = spans.window(train.make_eval_fn(cfg, model))
        for x in clips:
            timed(x, text)
    split = spans.split_ms("scores_topk_gate", NUM_WINDOWS)
    q = cfg.model.transformer_decoder.num_queries
    for i, out in enumerate(outs):
        _check_outputs(out, q, K_CLASSES, t, h, w, f"OV2Seg window {i}")
    enc = cfg.model.pixel_decoder.transformer_enc_layers
    expected = {**{k: 0 for k in launches}, "msda_fwd": enc * NUM_WINDOWS,
                "hungarian": engine._bucket(t) * NUM_WINDOWS}
    emit({"phase": "ov2seg_window_full_width", "config": OV2SEG_CONFIG, "dtype": "bfloat16",
          "windows": NUM_WINDOWS, "frames_per_window": t, "padded_to": engine._bucket(t),
          "frame_hw": [h, w], "ms_per_window": ms, "frames_per_s": t / (ms / 1e3),
          "split_ms_per_window": split, "peak_mem_gib": peak, "launches": launches,
          "expected_launches": expected, "card": card})
    if launches != expected:
        raise AssertionError(f"OV2Seg window launches {launches} != {expected}")
    del model
    torch.cuda.empty_cache()
    return launches


def phase_ov2seg_vs_plain(cfg):
    """18.2: one f32 OV2Seg window at 192x320 (2 frames padded to 8), card
    (kernels) against CPU (plain), phase 7's bounds."""
    cpu_model = init_params(train.build_model(cfg, device="cpu"), seed=SEED + 1)
    _hold_window_to_plain("ov2seg_kernels_vs_plain", cfg, cpu_model, CHECK_TRAIN_H, CHECK_TRAIN_W)


def phase_ov2seg_train(card, cfg):
    """18.3: OV2Seg's train step at full width (1x2x480x864, N=40, bf16 AMP,
    f32 masters): one warm-up and three timed steps, the launches of K1-K6,
    K5's call shapes (phase 5's: every frame its own sample), the heads
    moved, K1-K6 on the warm-up step's recorded inputs against their plain
    versions.  Returns the launches of the timed steps."""
    model = init_params(train.build_model(cfg, device=DEVICE), seed=SEED)
    heads = model.segmenter.predictor.heads
    trained = {"zs_fc2.weight": heads.zs_fc2.weight, "object_embed.weight": heads.object_embed.weight}
    before = {n: p.detach().clone() for n, p in trained.items()}
    step = train.build_train_step(cfg, model, K_CLASSES, device=DEVICE)
    batch = _train_batch(np.random.RandomState(SEED), TRAIN_H, TRAIN_W, TRAIN_N, DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    with MsdaRecorder() as msda_rec, HungarianRecorder() as k4_rec, SamplerInputs() as s_rec:
        step(batch, gen)  # warm-up: cuDNN autotuning, allocator; its inputs recorded
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
    expected = _train_launches(cfg, TRAIN_H, TRAIN_W, TRAIN_STEPS)
    by_shape = {case: shapes.counts.pop(shape, 0) for case, shape in SAMPLER_CASES.items()}
    other_shapes = {str(k): v for k, v in shapes.counts.items()}
    values = [{k: float(v) for k, v in m.items()} for m in metrics]
    moved = {n: not torch.equal(p.detach(), before[n]) for n, p in trained.items()}
    emit({"phase": "ov2seg_train_full_width", "config": OV2SEG_CONFIG,
          "dtype": "bf16 AMP, f32 masters", "batch": [1, TRAIN_T, TRAIN_H, TRAIN_W],
          "targets": TRAIN_N, "points": cfg.model.criterion.train_num_points,
          "steps": TRAIN_STEPS, "ms_per_step": ms,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "metrics": values,
          "launches": launches, "expected_launches": expected, "k5_launches_by_shape": by_shape,
          "k5_launches_at_other_shapes": other_shapes, "heads_moved": moved, "card": card})
    if launches != expected:
        raise AssertionError(f"OV2Seg train launches {launches} != {expected}")
    if other_shapes or min(by_shape.values()) == 0:
        raise AssertionError(f"OV2Seg: K5's shapes {by_shape}, others {other_shapes}, are not "
                             f"phase 5's {SAMPLER_CASES}")
    if not all(np.isfinite(v) for m in values for v in m.values()) or not all(moved.values()):
        raise AssertionError(f"OV2Seg: a loss is not finite or a head did not move: {moved}")
    _hold_k1("ov2seg_train", msda_rec)
    _hold_k2_k3("ov2seg_train", msda_rec)
    _hold_k4_k5_k6("ov2seg_train", k4_rec, s_rec, k4_calls=1)
    del model, step
    torch.cuda.empty_cache()
    return launches


def phase_ov2seg_train_vs_plain(cfg):
    """18.4: one f32 OV2Seg train-step loss and gradient at 1x2x192x320, card
    against CPU, phase 9's bounds."""
    f32 = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, amp=False))
    cpu_model = _offsets_off_centres(
        init_params(train.build_model(f32, device="cpu"), seed=SEED + 2), SEED + 2)
    _hold_train_to_plain("ov2seg_train_kernels_vs_plain", f32, cpu_model,
                         TRAIN_CHECK_PARAMS + ("segmenter.predictor.heads.zs_fc2.weight",
                                               "segmenter.predictor.heads.object_embed.weight"))


def phase_ov2seg_engine(card, clip):
    """18.5-18.7: the engine with the OV2Seg recipe's eval settings over phase
    10's dataset (bf16, windows of 10; each video's outputs padded to
    _bucket(T) and tracked by the EMA chain: 40 + 24 + 136 K4 launches), with
    its split and peak, K4 on every one of its costs against hungarian_plain;
    then the 133-frame video's EMA chain alone on its recorded embeddings,
    timed, its launches (_bucket(133)) and its assignment the engine's; then
    one f32 video through the engine, card against CPU.  Returns (the timed
    run's launches, the chain's)."""
    root = tempfile.mkdtemp(prefix="chip_smoke_ov2seg_engine_")
    try:
        cats, write_s = _write_engine_dataset(root)
        cfg = _ov2seg_config(clip, f"datasets.root={root}", f"datasets.test=[{ENGINE_DATASET}]",
                             f"output_dir={os.path.join(root, 'out')}")
        model = init_params(train.build_model(cfg, device=DEVICE), seed=SEED)
        text = _text(np.random.RandomState(SEED))
        _engine_warm_up(cfg, model, text)
        long_t = engine._bucket(OV2SEG_EMA_T)
        chains, track = [], engine.track_by_embeds

        def keep_long(embeds, *a, **kw):
            if embeds.shape[1] == long_t:
                chains.append(embeds.detach().clone())
            return track(embeds, *a, **kw)

        engine.track_by_embeds = keep_long
        try:
            with HungarianRecorder() as tracking:
                metrics, spans, wall, launches = _engine_run(cfg, model, text, DEVICE)
        finally:
            engine.track_by_embeds = track
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        expected = _engine_expected(cfg, launches)
        finite = all(np.isfinite(v) for v in metrics.values())
        t0 = time.perf_counter()
        plain = _plain_assignments(tracking.costs)
        plain_s = time.perf_counter() - t0
        cols = [c for cost_cols in tracking.cols for c in cost_cols]
        differ = [i for i, ((ref, _), got) in enumerate(zip(plain, cols))
                  if not torch.equal(ref, got)]
        emit({"phase": "ov2seg_engine_full_width", "config": OV2SEG_CONFIG,
              "dataset": "synthetic YTVIS-2019 format, 40 classes", "videos_hwtn": ENGINE_VIDEOS,
              "dtype": "bf16 AMP" if cfg.model.test.amp else "float32",
              "window": engine.window_size(cfg), "metrics": metrics, "metrics_finite": finite,
              "predictions": len(spans.preds), "launches": launches,
              "expected_launches": expected, "frames": spans.frames, "wall_s": wall,
              "frames_per_s": spans.frames / wall, "split_s": _engine_split(spans, wall),
              "peak_mem_gib": peak, "k4_problems": len(plain), "k4_equal_to_plain": not differ,
              "k4_problems_differing": differ, "k4_plain_seconds": plain_s,
              "dataset_write_s": write_s, "card": card})
        if launches != expected:
            raise AssertionError(f"OV2Seg engine launches {launches} != {expected}")
        if not finite or set(metrics) < {"AP", "AP50", "AR10"} or not spans.preds:
            raise AssertionError(f"OV2Seg engine metrics {metrics}, {len(spans.preds)} predictions")
        if differ or len(tracking.costs) != expected["hungarian"]:
            raise AssertionError(f"K4 on the OV2Seg engine's costs differs from hungarian_plain: "
                                 f"{differ}")
        # the long video's chain alone: 136 dependent (1, 100, 100) solves
        embeds = chains[-1]
        chain = functools.partial(engine.track_by_embeds, embeds,
                                  ema_alpha=engine.OV2SEG_EMA_ALPHA)
        reset_counts()
        indices = chain()
        torch.cuda.synchronize()
        chain_launches = read_counts()
        ms = time_cuda(chain, iters=5, warmup=1)
        first = len(tracking.costs) - long_t
        engine_cols = torch.stack([c[0] for c in tracking.cols[first:]])
        same = bool(torch.equal(indices[0].cpu(), engine_cols))
        chain_expected = {**{k: 0 for k in chain_launches}, "hungarian": long_t}
        emit({"phase": "ov2seg_ema_chain", "frames": OV2SEG_EMA_T, "padded_to": long_t,
              "embeds": list(embeds.shape), "dtype": str(embeds.dtype).replace("torch.", ""),
              "ms": ms, "ms_per_solve": ms / long_t, "launches": chain_launches,
              "expected_launches": chain_expected, "equal_to_the_engine_run": same,
              "card": card})
        if chain_launches != chain_expected or not same:
            raise AssertionError(f"the EMA chain launched {chain_launches} (expected "
                                 f"{chain_expected}) or differs from the engine's: {same}")
        del model, chains
        torch.cuda.empty_cache()
        name = _write_check_video(root, cats)
        base = _check_config(cfg, root, name)
        check_model = init_params(train.build_model(base, device="cpu"), seed=SEED + 3)
        _hold_engine_to_plain("ov2seg_engine_kernels_vs_plain", base, check_model,
                              _text(np.random.RandomState(SEED + 3)), name, root)
        return launches, chain_launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_ov2seg(card, clip):
    """Phase 18a: OV2Seg with its recipe's model; returns its paths' launch
    counts by name."""
    cfg = _ov2seg_config(clip)
    launches = {"ov2seg_eval": phase_ov2seg_window(card, cfg)}
    phase_ov2seg_vs_plain(cfg)
    launches["ov2seg_train"] = phase_ov2seg_train(card, cfg)
    phase_ov2seg_train_vs_plain(cfg)
    launches["ov2seg_engine"], launches["ov2seg_ema_chain"] = phase_ov2seg_engine(card, clip)
    launches["ov2seg_cli_train"], launches["ov2seg_cli_eval"] = _recipe_cli(
        card, clip, OV2SEG_CONFIG, OV2SEG_CLI_STEPS, "ov2seg")
    return launches


def write_swin_clip_file(root, clip):
    """Random ViT-L/14@336px weights in OpenAI's key layout (f16, from the
    seed) under ``root``, written once for phases 18 and 21; returns the CLIP
    files (weights, ``clip``'s merge file)."""
    t0 = time.perf_counter()
    weights = os.path.join(root, "ViT-L-14-336px.pt")
    torch.save(clip_synthetic.openai_state_dict(SWIN_CLIP, seed=SEED), weights)
    emit({"phase": "swin_clip_files", "clip": SWIN_CLIP, "seconds": time.perf_counter() - t0,
          "bytes": os.path.getsize(weights)})
    return weights, clip[1]


def _swin_config(clip, *overrides):
    """The SAN Swin-B recipe with the CLIP files ``clip`` (weights, bpe)."""
    return load_config(SAN_SWIN_CONFIG, [f"model.clip_adapter.weights={clip[0]}",
                                         f"model.clip_adapter.bpe_vocab={clip[1]}",
                                         *SWIN_OVERRIDES, *overrides])


def phase_swin_window(card, cfg, tree):
    """18.8: SANOnline-SwinB with the ViT-L/14@336px split, bf16: three
    10x480x864 windows (min_size_test 480 on the canvas) with their split
    (CLIP front, segmenter, CLIP post, tracking and top-k); returns the
    launches."""
    model = _san_model(cfg, tree, DEVICE, SEED).to(dtype=torch.bfloat16).eval()
    eval_fn = train.make_eval_fn(cfg, model)
    rng = np.random.RandomState(SEED)
    t, h, w = WINDOW_FRAMES, SWIN_WINDOW_H, SWIN_WINDOW_W
    dim = model_shape(SWIN_CLIP)["embed_dim"]
    windows = _random_clips(rng, NUM_WINDOWS, t, h, w)
    text = torch.from_numpy(_text(rng, dim)).to(DEVICE, torch.bfloat16)
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
    ms = start.elapsed_time(end) / NUM_WINDOWS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with SanSpans(model) as spans:
        timed = spans.window(eval_fn)
        for x in windows:
            timed(x, text)
    split = {k: v / NUM_WINDOWS for k, v in spans.split_ms().items()}
    q = cfg.model.transformer_decoder.num_queries
    for i, out in enumerate(outs):
        _check_outputs(out, q, K_CLASSES, t, h, w, f"SAN-SwinB window {i}")
    enc = cfg.model.pixel_decoder.transformer_enc_layers
    expected = {**{k: 0 for k in launches}, "msda_fwd": enc * NUM_WINDOWS,
                "hungarian": NUM_WINDOWS}
    emit({"phase": "san_swin_window_full_width", "config": SAN_SWIN_CONFIG, "dtype": "bfloat16",
          "clip": SWIN_CLIP, "windows": NUM_WINDOWS, "frames_per_window": t, "frame_hw": [h, w],
          "ms_per_window": ms, "frames_per_s": t / (ms / 1e3), "split_ms_per_window": split,
          "peak_mem_gib": peak, "launches": launches, "expected_launches": expected,
          "card": card})
    if launches != expected:
        raise AssertionError(f"SAN-SwinB window launches {launches} != {expected}")
    del model, outs
    torch.cuda.empty_cache()
    return launches


def phase_swin_train(card, cfg, tree):
    """18.9: the SAN-SwinB train step at 1x2x480x864 (bf16 AMP, f32 masters,
    the recipe's drop path 0.3 drawn from the step's generator): one warm-up
    and three timed steps, the tower and the trunk's frozen LayerNorms
    bit-equal after them, the trunk's bias tables and patch embedding and
    SAN's projections moved; returns the launches."""
    model = _san_model(cfg, tree, DEVICE, SEED)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.startswith("clip_adapter.visual.") or
              (n.startswith("segmenter.backbone.") and "norm" in n)}
    trained = {n: p for n, p in model.named_parameters() if n in SWIN_TRAINED}
    before = {n: p.detach().clone() for n, p in trained.items()}
    step = train.build_train_step(cfg, model, K_CLASSES, device=DEVICE)
    batch = _train_batch(np.random.RandomState(SEED), TRAIN_H, TRAIN_W, TRAIN_N, DEVICE,
                         text_dim=model_shape(SWIN_CLIP)["embed_dim"])
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
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
    expected = _train_launches(cfg, TRAIN_H, TRAIN_W, TRAIN_STEPS)
    values = [{k: float(v) for k, v in m.items()} for m in metrics]
    params = dict(model.named_parameters())
    fixed = all(torch.equal(params[n], v) for n, v in frozen.items())
    moved = {n: not torch.equal(p.detach(), before[n]) for n, p in trained.items()}
    emit({"phase": "san_swin_train_full_width", "config": SAN_SWIN_CONFIG,
          "dtype": "bf16 AMP, f32 masters", "clip": SWIN_CLIP,
          "drop_path_rate": cfg.model.backbone.swin_drop_path_rate,
          "batch": [1, TRAIN_T, TRAIN_H, TRAIN_W], "targets": TRAIN_N,
          "points": cfg.model.criterion.train_num_points, "steps": TRAIN_STEPS,
          "ms_per_step": ms, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "metrics": values, "launches": launches, "expected_launches": expected,
          "frozen_params": len(frozen), "frozen_bit_equal": fixed, "trained_moved": moved,
          "card": card})
    if launches != expected:
        raise AssertionError(f"SAN-SwinB train launches {launches} != {expected}")
    if not all(np.isfinite(v) for m in values for v in m.values()):
        raise AssertionError("a SAN-SwinB train-step loss or grad norm is not finite")
    if not fixed or not all(moved.values()) or len(moved) != len(SWIN_TRAINED):
        raise AssertionError(f"a frozen parameter changed or a trained one did not: {moved}")
    del model, step
    torch.cuda.empty_cache()
    return launches


def phase_swin_vs_plain(clip):
    """18.10: the Swin segmenter in f32, card against CPU, at 192x320 with the
    Swin-B trunk cut to 2 blocks a stage under the SAN R50 recipe's ViT-B/16
    split (phase 11's CLIP files): one window (phase 7's bounds) and one
    train step with drop path 0 (phase 9's)."""
    import train_net_torch as cli

    cfg = _san_config(clip, *SWIN_CHECK_OVERRIDES)
    tree = cli.read_clip(cfg)
    _hold_window_to_plain("swin_kernels_vs_plain", cfg, _san_model(cfg, tree, "cpu", SEED + 1),
                          CHECK_TRAIN_H, CHECK_TRAIN_W)
    f32 = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, amp=False))
    cpu_model = _offsets_off_centres(_san_model(f32, tree, "cpu", SEED + 2), SEED + 2)
    _hold_train_to_plain("swin_train_kernels_vs_plain", f32, cpu_model,
                         TRAIN_CHECK_PARAMS + (
                             "segmenter.backbone.stage2_block1.attn.relative_position_bias_table",
                             "segmenter.backbone.patch_embed.weight"))


def _swin_init(root, cfg, name="swin_init"):
    """A port checkpoint directory ``root/name`` that stands in for the
    recipe's Mask2Former Swin init (``pretrained/m2f_swinB.msgpack``,
    ``m2f_swinL.msgpack``; neither is in the repository):
    the segmenter from the seed with the trunk's biases drawn N(0, 0.02), as
    a trained trunk's are nonzero.  With every bias zero, a window of padded
    (zero) pixels stays exactly zero through the trunk, and each LayerNorm's
    backward scales the gradient there by 1/sqrt(eps) = 1e3: the first step's
    gradient overflows, in the JAX package too (ROADMAP.md §3)."""
    seg = init_params(Segmenter(cfg.model), seed=SEED + 7)
    gen = torch.Generator().manual_seed(SEED + 7)
    with torch.no_grad():
        for name, p in seg.backbone.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    path = os.path.join(root, name)
    save_checkpoint(path, 0, {"step": 0, "params": {f"segmenter.{n}": p for n, p
                                                    in seg.state_dict().items()}})
    return path


def phase_swin(card, clip, big, clip_dir):
    """Phase 18b: the SAN Swin-B recipes with the random ViT-L/14@336px
    ``big`` (``write_swin_clip_file``; ``clip``: phase 11's files); the CLIs
    at SWIN_CLI_OVERRIDES' depth.  Returns the paths' launch counts by
    name."""
    import train_net_torch as cli

    cfg = _swin_config(big)
    tree = cli.read_clip(cfg)
    launches = {"san_swin_eval": phase_swin_window(card, cfg, tree)}
    launches["san_swin_train"] = phase_swin_train(card, cfg, tree)
    del tree
    phase_swin_vs_plain(clip)
    stage1 = os.path.join(clip_dir, "san_swin_checkpoints")
    clips = f"solver.ims_per_batch={SWIN_CLI_CLIPS}"
    init = f"model.weights={_swin_init(clip_dir, _swin_config(big, *SWIN_CLI_OVERRIDES))}"
    launches["san_swin_cli_train"], launches["san_swin_cli_eval"] = _recipe_cli(
        card, big, SAN_SWIN_CONFIG, SWIN_CLI_STEPS, "san_swin", stage1,
        (init, clips, *SWIN_CLI_OVERRIDES))
    launches["san_swin_offline_cli_eval"] = phase_san_offline_cli(
        card, big, stage1, SAN_SWIN_OFFLINE_CONFIG, "san_swin_offline",
        SWIN_OVERRIDES + SWIN_CLI_OVERRIDES)
    launches["brivis_swin_cli_train"], launches["brivis_swin_cli_eval"] = phase_brivis_cli(
        card, big, stage1, BRIVIS_SWIN_CONFIG, "brivis_swin", SWIN_CLI_STEPS,
        (clips, *SWIN_CLI_OVERRIDES))
    return launches


def _masq_config(clip, *overrides):
    """MasQCLIP as the CLI builds it: the offline SimpleBaseline recipe with
    ``MASQ_OVERRIDES``, the CLIP files ``clip`` (weights, bpe) and ``overrides``."""
    return _offline_config(OFFLINE_CONFIG, clip, *MASQ_OVERRIDES, *overrides)


def phase_masq_shot(card, cfg):
    """19.1: MasQCLIP at full width (R50, the 6-layer MSDA pixel decoder, 100
    queries over 9+1 layers, the ViT-B/16 MasQ tower: 100 mask tokens beside
    197 tokens a frame), random weights from the seed, bf16: three 10x384x640
    shots through ``train.make_eval_fn`` against K=40 text rows, with their
    split (segmenter, MasQ tower, the rest: the resizes, the scores and the
    top-k) and peak; the last row is never a label.  Returns the launches."""
    model = init_params(train.build_model(cfg, device=DEVICE), seed=SEED).to(
        dtype=torch.bfloat16).eval()
    rng = np.random.RandomState(SEED)
    t, h, w = WINDOW_FRAMES, FRAME_H, FRAME_W
    clips = _random_clips(rng, NUM_WINDOWS, t, h, w)
    text = torch.from_numpy(_text(rng)).to(DEVICE, torch.bfloat16)
    outs, ms, peak, launches = _timed_shots(model, cfg, clips, text)
    with StageSpans({"segmenter": (model.segmenter, "forward"),
                     "masq_tower": (model.clip_adapter, "forward")}) as spans:
        timed = spans.window(train.make_eval_fn(cfg, model))
        for x in clips:
            timed(x, text)
    split = spans.split_ms("resizes_scores_topk", NUM_WINDOWS)
    q = cfg.model.transformer_decoder.num_queries
    for i, out in enumerate(outs):
        _check_outputs(out, q, K_CLASSES - 1, t, h, w, f"MasQCLIP shot {i}")
    enc = cfg.model.pixel_decoder.transformer_enc_layers
    expected = {**{k: 0 for k in launches}, "msda_fwd": enc * NUM_WINDOWS}
    emit({"phase": "masqclip_shot_full_width", "config": OFFLINE_CONFIG,
          "overrides": MASQ_OVERRIDES, "clip": cfg.model.clip_adapter.clip_model_name,
          "dtype": "bfloat16", "shots": NUM_WINDOWS, "frames_per_shot": t, "frame_hw": [h, w],
          "text_rows": K_CLASSES, "ms_per_shot": ms, "frames_per_s": t / (ms / 1e3),
          "split_ms_per_shot": split, "peak_mem_gib": peak, "launches": launches,
          "expected_launches": expected, "card": card})
    if launches != expected:
        raise AssertionError(f"MasQCLIP shot launches {launches} != {expected}")
    del outs, clips, model
    torch.cuda.empty_cache()
    return launches


def phase_masq_vs_plain(cfg):
    """19.2: the same model in f32 at 192x320 on T=5 frames padded to 8 (the
    engine's single shot), card (kernels) against CPU (plain), phase 7's
    bounds."""
    f32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, test=dataclasses.replace(cfg.model.test, amp=False)))
    cpu_model = init_params(train.build_model(f32, device="cpu"), seed=SEED + 1)
    _hold_window_to_plain("masqclip_kernels_vs_plain", f32, cpu_model, CHECK_TRAIN_H,
                          CHECK_TRAIN_W, make_eval=_single_shot_eval(f32),
                          frames=OFFLINE_CHECK_T, kernels=("msda_fwd",))


class AssignRecorder:
    """Wraps ``masqclip.label_assign`` for one run of a path and keeps host
    copies of its outputs (labels, valid, target index), one list a call."""

    def __enter__(self):
        self.calls = []
        self._assign = masqclip_meta.label_assign

        def recording(*args, **kwargs):
            out = self._assign(*args, **kwargs)
            self.calls.append([t.cpu() for t in out])
            return out

        masqclip_meta.label_assign = recording
        return self

    def __exit__(self, *exc):
        masqclip_meta.label_assign = self._assign


def _own_proposal_targets(model, batch, n):
    """``batch`` with its target masks replaced by the model's own first ``n``
    proposals thresholded at the input resolution, so that queries take
    pseudo-labels (random masks leave every query background, and then the
    loss can be ~0 with random weights)."""
    pixels = batch["pixels"]
    b, t, h, w, _ = pixels.shape
    with torch.no_grad():
        own = model.segmenter(pixels.reshape(b * t, h, w, 3), t)
    masks = resize_bilinear_torch_hw(own["pred_masks"][:, :n].float(), (h, w)) > 0
    tg = batch["targets"]
    return {**batch, "targets": ClipTargets(tg.labels, masks, tg.valid, tg.frame_valid)}


def phase_masq_train(card, cfg):
    """19.3: MasQCLIP's train step at full width (1x2x480x864, N=40, 12544
    points, bf16 AMP, f32 masters, AdamW): one warm-up and three timed steps,
    the launches (K1 6 a step in the segmenter's forward, K5 once a step in
    ``label_assign`` at (1, Q*T, 120, 216); the targets, 414,720 pixels, take
    the plain gather), the segmenter's Adam moments zero after all four steps
    (its gradients are exact zeros) while its weights decay, the tower's
    ``new_q_proj`` and mask token moved; the targets the model's first 40
    proposals (``_own_proposal_targets``); K1 and K5 on the warm-up step's
    recorded inputs against their plain versions.  Returns (the launches, K1's
    and K5's times on the recorded inputs)."""
    model = init_params(train.build_model(cfg, device=DEVICE), seed=SEED)
    tower = model.clip_adapter
    trained = {"new_q_proj": tower.resblock0.attn.new_q_proj.weight,
               "mask_embeddings": tower.mask_embeddings}
    decaying = model.segmenter.predictor.heads.class_embed.weight
    before = {n: p.detach().clone() for n, p in trained.items()}
    decay_before = decaying.detach().clone()
    batch = _own_proposal_targets(model, _train_batch(np.random.RandomState(SEED), TRAIN_H,
                                                      TRAIN_W, TRAIN_N, DEVICE), TRAIN_N)
    step = train.build_train_step(cfg, model, K_CLASSES, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    with MsdaRecorder() as msda_rec, SamplerInputs() as s_rec, AssignRecorder() as assigned:
        step(batch, gen)  # warm-up: cuDNN autotuning, allocator; its inputs recorded
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
    expected = _train_launches(cfg, TRAIN_H, TRAIN_W, TRAIN_STEPS)
    q = cfg.model.transformer_decoder.num_queries
    k5_shape = (1, q * TRAIN_T, TRAIN_H // 4, TRAIN_W // 4,
                cfg.model.criterion.train_num_points)
    k5_by_shape = {str(k): v for k, v in shapes.counts.items()}
    values = [{k: float(v) for k, v in m.items()} for m in metrics]
    opt = step.state.opt
    seg = [n for n in opt.hyper if n.startswith("segmenter.")]
    seg_mu_zero = all(not opt.mu[n].any() for n in seg)
    moved = {n: not torch.equal(p.detach(), before[n]) for n, p in trained.items()}
    decayed = not torch.equal(decaying.detach(), decay_before)
    emit({"phase": "masqclip_train_full_width", "config": OFFLINE_CONFIG,
          "overrides": MASQ_OVERRIDES, "dtype": "bf16 AMP, f32 masters",
          "batch": [1, TRAIN_T, TRAIN_H, TRAIN_W], "targets": TRAIN_N,
          "points": cfg.model.criterion.train_num_points, "steps": TRAIN_STEPS,
          "ms_per_step": ms, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "metrics": values, "launches": launches, "expected_launches": expected,
          "k5_launches_by_shape": k5_by_shape,
          "queries_assigned_warm_up": int(assigned.calls[0][1].sum()),
          "segmenter_params": len(seg),
          "segmenter_adam_moments_zero": seg_mu_zero, "segmenter_class_head_decayed": decayed,
          "tower_moved": moved, "card": card})
    if launches != expected or k5_by_shape != {str(k5_shape): TRAIN_STEPS}:
        raise AssertionError(f"MasQCLIP train launches {launches} != {expected} or K5's shapes "
                             f"{k5_by_shape} are not {k5_shape}")
    if not (all(np.isfinite(v) for m in values for v in m.values())
            and all(m["total_loss"] > 0 for m in values)):
        raise AssertionError("a MasQCLIP train-step loss is zero or not finite")
    if not (seg_mu_zero and decayed and all(moved.values())):
        raise AssertionError(f"MasQCLIP: the segmenter got a gradient ({not seg_mu_zero}) or "
                             f"did not decay ({decayed}), or the tower did not move: {moved}")
    k1_ms = _hold_k1("masqclip_train", msda_rec)
    k5_ms = _hold_k5("masqclip_train", s_rec)
    if list(k5_ms) != [k5_shape]:
        raise AssertionError(f"MasQCLIP's recorded K5 calls {list(k5_ms)} are not {k5_shape}")
    del model, step
    torch.cuda.empty_cache()
    return launches, k1_ms, k5_ms[k5_shape]


def _masq_loss_and_grads(cfg, model, batch):
    """Loss, metrics, ``label_assign``'s outputs and the gradients (None where
    the loss does not reach) of one f32 MasQCLIP train-step forward and
    backward, the points from a CPU generator."""
    stop_frozen_gradients(model, config_labels(cfg, model))
    loss_fn = train.make_loss_fn(cfg, model, K_CLASSES)
    params = dict(model.named_parameters())
    names = [n for n, p in params.items() if p.requires_grad]
    with AssignRecorder() as assigned:
        loss, metrics = loss_fn(params, batch, torch.Generator().manual_seed(SEED))
    grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
    return (loss.item(), {k: v.item() for k, v in metrics.items()}, assigned.calls[0],
            dict(zip(names, grads)))


def phase_masq_train_vs_plain(cfg):
    """19.4: one f32 MasQCLIP train-step loss and gradient at 1x2x192x320,
    card (kernels) against CPU (plain), from the same weights and points, the
    N=8 targets the model's own first proposals at the input resolution (so
    that queries take pseudo-labels): the losses, the pseudo-labels (equal),
    the gradient norm and the tower's gradients within phase 9's bounds, the
    segmenter's gradients exactly zero on both sides."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.mkldnn.enabled = False  # see _hold_train_to_plain
    f32 = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, amp=False))
    cpu_model = _offsets_off_centres(
        init_params(train.build_model(f32, device="cpu"), seed=SEED + 2), SEED + 2)
    gpu_model = copy.deepcopy(cpu_model).to(DEVICE)
    h, w, n = CHECK_TRAIN_H, CHECK_TRAIN_W, CHECK_TRAIN_N
    batch = _own_proposal_targets(
        cpu_model, _train_batch(np.random.RandomState(SEED + 2), h, w, n, "cpu"), n)
    gpu_batch = _to_device(batch, DEVICE)
    t0 = time.perf_counter()
    ref_loss, ref_m, ref_lab, ref_g = _masq_loss_and_grads(f32, cpu_model, batch)
    cpu_s = time.perf_counter() - t0
    reset_counts()
    got_loss, got_m, got_lab, got_g = _masq_loss_and_grads(f32, gpu_model, gpu_batch)
    torch.cuda.synchronize()
    launches = read_counts()
    torch.backends.mkldnn.enabled = True
    seg_zero = all((g is None or not g.any()) for name, g in [*ref_g.items(), *got_g.items()]
                   if name.startswith("segmenter."))
    rest = [k for k in ref_g if not k.startswith("segmenter.") and ref_g[k] is not None]
    ref_norm = global_norm(ref_g[k] for k in rest).item()
    got_norm = global_norm(got_g[k].cpu() for k in rest).item()
    losses = {"total": (got_loss, ref_loss), **{k: (got_m[k], ref_m[k]) for k in ref_m}}
    loss_rel = {k: abs(a - b) / max(abs(b), 1e-30) for k, (a, b) in losses.items()}
    grad_rel = {k: ((got_g[k].cpu() - ref_g[k]).abs().max() / ref_g[k].abs().max()).item()
                for k in MASQ_CHECK_GRADS}
    labels_equal = all(torch.equal(a, b) for a, b in zip(got_lab, ref_lab))
    expected = _train_launches(f32, h, w, 1)
    emit({"phase": "masqclip_train_kernels_vs_plain", "dtype": "float32", "tf32": False,
          "batch": [1, TRAIN_T, h, w], "targets": n, "losses_kernel_plain": losses,
          "loss_rel_err": loss_rel, "pseudo_labels_equal": labels_equal,
          "queries_assigned": int(ref_lab[1].sum()), "segmenter_grads_zero": seg_zero,
          "grad_norm_kernel_plain": [got_norm, ref_norm],
          "grad_norm_rel_err": abs(got_norm - ref_norm) / ref_norm,
          "grad_max_err_rel_to_max": grad_rel, "kernel_launches": launches,
          "expected_launches": expected, "cpu_seconds": cpu_s,
          "tol": {"loss_rtol": TRAIN_LOSS_RTOL, "grad_norm_rtol": TRAIN_GRAD_NORM_RTOL,
                  "grad_rel_to_max": TRAIN_GRAD_REL_TO_MAX}})
    if not (all(v <= TRAIN_LOSS_RTOL for v in loss_rel.values()) and labels_equal and seg_zero
            and abs(got_norm - ref_norm) <= TRAIN_GRAD_NORM_RTOL * ref_norm
            and all(v <= TRAIN_GRAD_REL_TO_MAX for v in grad_rel.values())):
        raise AssertionError("the kernel MasQCLIP step disagrees with the plain step")
    if launches != expected:
        raise AssertionError(f"the card's MasQCLIP step launched {launches}, not {expected}")


def phase_masq_engine(card, clip):
    """19.5: the engine with the recipe's eval settings (bf16 AMP,
    ``test.max_frames`` 128, no window inference) over phase 10's dataset's
    last two videos: a single shot of 24 frames, the 133-frame video in
    windows of 128 (MasQCLIP's windowed reduction); K1 only.  Returns
    the launches."""
    root = tempfile.mkdtemp(prefix="chip_smoke_masqclip_engine_")
    try:
        _write_engine_dataset(root)
        cfg = _engine_root_config(OFFLINE_CONFIG, clip, root, *MASQ_OVERRIDES)
        model = init_params(train.build_model(cfg, device=DEVICE), seed=SEED)
        launches = phase_offline_engine(card, cfg, "masqclip_engine", model,
                                        _text(np.random.RandomState(SEED)),
                                        videos=OFFLINE_ENGINE_VIDEOS)
        del model
        torch.cuda.empty_cache()
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_masqclip(card, clip):
    """Phase 19: MasQCLIP; returns its paths' launch counts by name and the
    kernels line's times of K1 and K5 on its step's recorded inputs."""
    t0 = time.perf_counter()
    cfg = _masq_config(clip)
    launches = {"masqclip_eval": phase_masq_shot(card, cfg)}
    phase_masq_vs_plain(cfg)
    launches["masqclip_train"], k1_ms, k5_ms = phase_masq_train(card, cfg)
    phase_masq_train_vs_plain(cfg)
    launches["masqclip_engine"] = phase_masq_engine(card, clip)
    launches["masqclip_cli_train"], launches["masqclip_cli_eval"] = _recipe_cli(
        card, clip, OFFLINE_CONFIG, MASQ_CLI_STEPS, "masqclip", overrides=MASQ_OVERRIDES)
    emit({"phase": "masqclip_done", "seconds": time.perf_counter() - t0})
    return launches, {"msda_fwd": {"recorded_masqclip_train_ms": k1_ms},
                      "point_sample_fwd": {"recorded_masqclip_train_ms": k5_ms}}


def _fpn_config(clip, *overrides):
    """The SimpleBaselineOnline recipe (CLI_CONFIG) with FPN_OVERRIDES, the
    CLIP files ``clip`` (weights, bpe) and ``overrides``."""
    return load_config(CLI_CONFIG, [f"model.clip_adapter.weights={clip[0]}",
                                    f"model.clip_adapter.bpe_vocab={clip[1]}", *FPN_OVERRIDES,
                                    *overrides])


def phase_fpn_window(card, cfg):
    """20.1: the eval window at full width, bf16: three 10x384x640 windows
    through ``train.make_eval_fn`` with their split (backbone, pixel decoder,
    frame decoder, tracking); K4 once a window and no K1-K3; K4 on the
    windows' own tracking costs against ``hungarian_plain``.  Returns the
    launches."""
    model = init_params(train.build_model(cfg, device=DEVICE), seed=SEED).to(
        dtype=torch.bfloat16).eval()
    rng = np.random.RandomState(SEED)
    t, h, w = WINDOW_FRAMES, FRAME_H, FRAME_W
    clips = _random_clips(rng, NUM_WINDOWS, t, h, w)
    text = torch.from_numpy(_text(rng)).to(DEVICE, torch.bfloat16)
    outs, ms, peak, launches = _timed_shots(model, cfg, clips, text)
    seg = model.segmenter
    with HungarianRecorder() as tracking, StageSpans({
            "backbone": (seg.backbone, "forward"), "pixel_decoder": (seg.pixel_decoder, "forward"),
            "frame_decoder": (seg.predictor, "forward"),
            "tracking": (train, "track_by_embeds")}) as spans:
        timed = spans.window(train.make_eval_fn(cfg, model))
        for x in clips:
            timed(x, text)
    split = spans.split_ms("scores_topk", NUM_WINDOWS)
    q = cfg.model.transformer_decoder.num_queries
    for i, out in enumerate(outs):
        _check_outputs(out, q, K_CLASSES, t, h, w, f"FPN window {i}")
    expected = {**{k: 0 for k in launches}, "hungarian": NUM_WINDOWS}
    pd = cfg.model.pixel_decoder
    emit({"phase": "fpn_window_full_width", "config": CLI_CONFIG, "overrides": FPN_OVERRIDES,
          "pixel_decoder": {"name": pd.name, "encoder_layers": pd.transformer_enc_layers,
                            "heads": pd.num_heads, "ffn": pd.dim_feedforward,
                            "conv_dim": pd.conv_dim},
          "dtype": "bfloat16", "windows": NUM_WINDOWS, "frames_per_window": t,
          "frame_hw": [h, w], "ms_per_window": ms, "frames_per_s": t / (ms / 1e3),
          "split_ms_per_window": split, "peak_mem_gib": peak, "launches": launches,
          "expected_launches": expected, "card": card})
    if launches != expected:
        raise AssertionError(f"FPN window launches {launches} != {expected}")
    _hold_k4("fpn_eval", tracking, NUM_WINDOWS)
    del model
    torch.cuda.empty_cache()
    return launches


def phase_fpn_train(card, cfg):
    """20.2: the train step at full width (1x2x480x864, N=40, bf16 AMP, f32
    masters, SGD): one warm-up and three timed steps; K4 1, K5 30 and K6 20 a
    step, no K1-K3; every decayed parameter moved, the frozen ones bit-equal
    and without SGD state; K4, K5 and K6 on the warm-up step's recorded
    inputs against their plain versions.  Returns the launches of the timed
    steps."""
    model = init_params(train.build_model(cfg, device=DEVICE), seed=SEED)
    labels = config_labels(cfg, model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = train.build_train_step(cfg, model, K_CLASSES, device=DEVICE)
    batch = _train_batch(np.random.RandomState(SEED), TRAIN_H, TRAIN_W, TRAIN_N, DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    with HungarianRecorder() as k4_rec, SamplerInputs() as s_rec:
        step(batch, gen)  # warm-up: cuDNN autotuning, allocator; its inputs recorded
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
    expected = _train_launches(cfg, TRAIN_H, TRAIN_W, TRAIN_STEPS)
    by_shape = {case: shapes.counts.pop(shape, 0) for case, shape in SAMPLER_CASES.items()}
    other_shapes = {str(k): v for k, v in shapes.counts.items()}
    values = [{k: float(v) for k, v in m.items()} for m in metrics]
    opt = step.state.opt
    moved = {n: not torch.equal(p.detach(), before[n]) for n, p in model.named_parameters()}
    frozen = [n for n, g in labels.items() if g == "frozen"]
    decayed = [n for n, (_, wd) in opt.hyper.items() if wd]
    emit({"phase": "fpn_train_full_width", "config": CLI_CONFIG, "overrides": FPN_OVERRIDES,
          "optimizer": type(opt).__name__, "dtype": "bf16 AMP, f32 masters",
          "batch": [1, TRAIN_T, TRAIN_H, TRAIN_W], "targets": TRAIN_N,
          "points": cfg.model.criterion.train_num_points, "steps": TRAIN_STEPS,
          "ms_per_step": ms, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "metrics": values, "launches": launches, "expected_launches": expected,
          "k5_launches_by_shape": by_shape, "k5_launches_at_other_shapes": other_shapes,
          "tensors_moved": sum(moved[n] for n in opt.hyper), "tensors_trained": len(opt.hyper),
          "decayed_unmoved": [n for n in decayed if not moved[n]][:5],
          "frozen": len(frozen), "frozen_moved": [n for n in frozen if moved[n]][:5],
          "card": card})
    if type(opt).__name__ != "SGD" or set(opt.trace) != set(opt.hyper) or \
            set(opt.hyper) & set(frozen):
        raise AssertionError(f"FPN train: the optimizer is {type(opt).__name__}, or it keeps "
                             "state for a frozen parameter")
    if launches != expected:
        raise AssertionError(f"FPN train launches {launches} != {expected}")
    if other_shapes or min(by_shape.values()) == 0:
        raise AssertionError(f"FPN train: K5's shapes {by_shape}, others {other_shapes}, are not "
                             f"phase 5's {SAMPLER_CASES}")
    if not all(np.isfinite(v) for m in values for v in m.values()):
        raise AssertionError(f"FPN train: a metric is not finite: {values}")
    if any(moved[n] for n in frozen) or not all(moved[n] for n in decayed):
        raise AssertionError("FPN train: SGD moved a frozen parameter or left a decayed one")
    _hold_k4_k5_k6("fpn_train", k4_rec, s_rec, k4_calls=1)
    del model, step, before
    torch.cuda.empty_cache()
    return launches


def phase_fpn_vs_plain(clip):
    """20.3: card (kernels) against CPU (plain) in f32, TF32 off, at
    1x2x192x320: for ``fpn`` and ``transformer_enc``, the window's scores and
    masks, the step's loss and the gradients of every trainable tensor
    (phase 9's bounds, both sides on the card's assignments) and the update
    of one SGD step from them; the ``frame_zero_shot`` (over ``fpn``) and
    ``video_zero_shot`` (over ``transformer_enc``) segmenters' logits and
    masks; one full-width ``DETRTransformer`` forward (6 + 6 layers, 100
    queries over res5's 12x20 tokens)."""
    for name in ("fpn", "transformer_enc"):
        cfg = _fpn_config(clip, f"model.pixel_decoder.name={name}", "solver.amp=false",
                          f"solver.base_lr={FPN_CHECK_LR}")
        cpu_model = init_params(train.build_model(cfg, device="cpu"), seed=SEED + 1)
        _hold_window_to_plain(f"{name}_kernels_vs_plain", cfg, cpu_model, CHECK_TRAIN_H,
                              CHECK_TRAIN_W, kernels=("hungarian",))
        # every trainable tensor but the key projections' biases, whose exact
        # gradient is 0 (``_hold_update_to_plain`` holds their noise)
        labels = config_labels(cfg, cpu_model)
        held = [n for n, g in labels.items() if g != "frozen" and not n.endswith("k_proj.bias")]
        step = f"{name}_train_kernels_vs_plain"
        gpu_model, ref_g, got_g = _hold_train_to_plain(step, cfg, cpu_model.train(), held)
        _hold_update_to_plain(step, cfg, cpu_model, gpu_model, ref_g, got_g, held)
        del gpu_model, ref_g, got_g
        del cpu_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(SEED + 4)
    frames = torch.from_numpy(rng.randn(CHECK_FRAMES, CHECK_TRAIN_H, CHECK_TRAIN_W, 3)
                              .astype(np.float32))
    for pixel, decoder in (("fpn", "frame_zero_shot"), ("transformer_enc", "video_zero_shot")):
        cfg = _fpn_config(clip, f"model.pixel_decoder.name={pixel}",
                          f"model.transformer_decoder.name={decoder}")
        seg = init_params(Segmenter(cfg.model), seed=SEED + 4).eval()
        gpu = copy.deepcopy(seg).to(DEVICE)
        with torch.no_grad():
            ref = seg(frames, CHECK_FRAMES)
            got = gpu(frames.to(DEVICE), CHECK_FRAMES)
        hidden = cfg.model.transformer_decoder.hidden_dim
        rel = {k: _rel_to_max(got[k], ref[k]) for k in ("pred_logits_all", "pred_masks_all")}
        shapes = {k: list(got[k].shape) for k in rel}
        emit({"phase": f"{decoder}_kernels_vs_plain", "pixel_decoder": pixel, "dtype": "float32",
              "tf32": False, "frames": CHECK_FRAMES, "frame_hw": [CHECK_TRAIN_H, CHECK_TRAIN_W],
              "shapes": shapes, "max_err_rel_to_max": rel,
              "tol": {"rel_to_max": ZERO_SHOT_REL_TO_MAX}})
        if shapes["pred_logits_all"][-1] != hidden + 2 or \
                max(rel.values()) > ZERO_SHOT_REL_TO_MAX:
            raise AssertionError(f"{decoder}: the card's segmenter disagrees with the CPU's")
        del seg, gpu
    detr = init_params(pixel_decoder.DETRTransformer(), seed=SEED + 5).eval()
    gen = torch.Generator().manual_seed(SEED + 5)
    src = torch.randn(2, 256, FRAME_H // 32, FRAME_W // 32, generator=gen)
    pos = position_encoding_2d(FRAME_H // 32, FRAME_W // 32, 128).permute(2, 0, 1)[None]
    query = torch.randn(100, 256, generator=gen)
    gpu = copy.deepcopy(detr).to(DEVICE)
    with torch.no_grad():
        ref = detr(src, query, pos)
        got = gpu(src.to(DEVICE), query.to(DEVICE), pos.to(DEVICE))
    rel = {"hs": _rel_to_max(got[0], ref[0]), "memory": _rel_to_max(got[1], ref[1])}
    emit({"phase": "detr_transformer_kernels_vs_plain", "dtype": "float32", "tf32": False,
          "src": list(src.shape), "queries": 100, "hs": list(got[0].shape),
          "max_err_rel_to_max": rel, "tol": {"rel_to_max": DETR_REL_TO_MAX}})
    if max(rel.values()) > DETR_REL_TO_MAX:
        raise AssertionError("DETRTransformer: the card disagrees with the CPU")


def phase_fpn_cli(card, clip):
    """20.4: the CLI with the recipe and FPN_OVERRIDES as users train it (8
    one-frame clips a step over phase 11's synthetic sets): FPN_CLI_STEPS
    steps and a checkpoint, ``--resume`` for FPN_RESUME_STEPS more (the SGD
    state restored from the file bit for bit, its trace carried into the
    step: the update is the rate times the new trace), then ``--eval-only``.
    Returns the launches of the first training run and of the eval."""
    import train_net_torch as cli

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    root = tempfile.mkdtemp(prefix="chip_smoke_fpn_cli_")
    restored, orig = [], cli.restore_checkpoint

    def recorded_restore(src, state):
        out = orig(src, state)
        if out is not None:
            restored.append(_state_copy(state))
        return out

    cli.restore_checkpoint = recorded_restore
    try:
        out = os.path.join(root, "out")
        steps = FPN_CLI_STEPS + FPN_RESUME_STEPS
        common = _cli_data(root) + [f"model.clip_adapter.weights={clip[0]}",
                                    f"model.clip_adapter.bpe_vocab={clip[1]}", *FPN_OVERRIDES,
                                    f"solver.checkpoint_period={FPN_CLI_STEPS}",
                                    f"output_dir={out}"]

        def run(*flags, max_iter=FPN_CLI_STEPS):
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            cli.main(["--config-file", CLI_CONFIG, *flags, *common,
                      f"solver.max_iter={max_iter}"])
            torch.cuda.synchronize()
            return (time.perf_counter() - t0, read_counts(),
                    torch.cuda.max_memory_allocated() / 2 ** 30)

        wall, launches, peak = run()
        cfg = load_config(CLI_CONFIG, common)
        ckpt_dir = os.path.join(out, "checkpoints")
        first = load_checkpoint(ckpt_dir)
        wall2, launches2, peak2 = run("--resume", max_iter=steps)
        last = load_checkpoint(ckpt_dir)
        lines = _metrics_lines(out)
        expected = _train_launches(cfg, *cfg.input.pad_size, FPN_CLI_STEPS)
        expected2 = _train_launches(cfg, *cfg.input.pad_size, FPN_RESUME_STEPS)
        equal = len(restored) == 1 and _states_equal(restored[0], first)
        # the resumed step moved each parameter by the rate times the trace it
        # left, to the f32 masters' rounding
        lr = make_lr_schedule(cfg)(FPN_CLI_STEPS)
        groups = label_params(first["params"].items(), freeze_at=cfg.model.backbone.freeze_at)
        mult = {n: cfg.solver.backbone_multiplier if g.startswith("backbone") else 1.0
                for n, g in groups.items() if g != "frozen"}
        eps = torch.finfo(torch.float32).eps
        off = 0.0
        for n, m in mult.items():
            step_n = lr * m * last["trace"][n]
            gap = ((first["params"][n] - last["params"][n]) - step_n).abs()
            ulps = 2 * eps * (first["params"][n].abs() + step_n.abs()) + 1e-30
            off = max(off, (gap / ulps).max().item())
        carried = sum(int(first["trace"][n].any()) for n in mult)
        ms = [r["step_s"] * 1e3 for r in lines]
        emit({"phase": "fpn_cli_train", "config": CLI_CONFIG, "overrides": FPN_OVERRIDES,
              "batch": [cfg.solver.ims_per_batch, cfg.input.sampling_frame_num],
              "points": cfg.model.criterion.train_num_points, "amp": cfg.solver.amp,
              "steps": [r["step"] for r in lines], "ms_per_step": ms,
              "loader_wait_ms": [r["data_wait_s"] * 1e3 for r in lines],
              "losses": [r["total_loss"] for r in lines],
              "grad_norms": [r["grad_norm"] for r in lines], "peak_mem_gib": [peak, peak2],
              "wall_s": [wall, wall2], "launches": [launches, launches2],
              "expected_launches": [expected, expected2],
              "restored_equal_to_checkpoint_bitwise": equal,
              "restored_trace_tensors_nonzero": carried, "count_after_resume": last["count"],
              "resumed_update_vs_rate_times_trace_in_ulps": off, "card": card})
        finite = all(np.isfinite(r[k]) for r in lines
                     for k in ("total_loss", "loss_ce", "loss_mask", "loss_dice", "grad_norm"))
        if [launches, launches2] != [expected, expected2]:
            raise AssertionError(f"FPN CLI train launches {[launches, launches2]} != "
                                 f"{[expected, expected2]}")
        if [r["step"] for r in lines] != list(range(1, steps + 1)) or not finite:
            raise AssertionError(f"the FPN CLI's metrics.jsonl is not {steps} finite steps")
        if not equal or set(first) != {"step", "params", "trace", "count"} or not carried or \
                last["count"] != steps or off > 1.0:
            raise AssertionError("the FPN CLI's --resume did not carry SGD's trace on")
        del first, last, restored[:]
        wall3, launches3, _ = run("--eval-only", "--weights", ckpt_dir)
        ds = cfg.datasets.test[0]
        with open(os.path.join(out, f"metrics_{ds}.json")) as f:
            metrics = json.load(f)
        expected3 = _engine_expected(cfg, launches3, CLI_EVAL_VIDEOS)
        emit({"phase": "fpn_cli_eval", "metrics": metrics, "wall_s": wall3,
              "launches": launches3, "expected_launches": expected3, "card": card})
        if not metrics or not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"the FPN CLI's eval wrote {metrics}")
        if launches3 != expected3:
            raise AssertionError(f"FPN CLI eval launches {launches3} != {expected3}")
        return launches, launches3
    finally:
        cli.restore_checkpoint = orig
        shutil.rmtree(root, ignore_errors=True)


def phase_fpn(card, clip):
    """Phase 20: SimpleBaselineOnline-R50 with the ``transformer_enc`` pixel
    decoder and SGD; returns its paths' launch counts by name."""
    t0 = time.perf_counter()
    cfg = _fpn_config(clip)
    launches = {"fpn_eval": phase_fpn_window(card, cfg)}
    launches["fpn_train"] = phase_fpn_train(card, cfg)
    phase_fpn_vs_plain(clip)
    launches["fpn_cli_train"], launches["fpn_cli_eval"] = phase_fpn_cli(card, clip)
    emit({"phase": "fpn_done", "seconds": time.perf_counter() - t0})
    return launches


def _swinl_config(clip, *overrides):
    """The Swin-L OpenVIS recipe with the CLIP files ``clip`` (weights, bpe);
    its ``pretrained/m2f_swinL.msgpack`` is not in the repository."""
    return _offline_config(OPENVIS_SWINL_CONFIG, clip, *SWIN_OVERRIDES, *overrides)


def phase_swinl_shot(card, cfg):
    """21.1 / 21.2: the Swin-L OpenVIS recipe's model (random weights from the
    seed, bf16) through the engine's single shot (``_single_shot_eval``: the
    clip padded to ``_bucket(t)`` frames, the frame head's logits averaged
    over the real ones, the objectness top-k; no tracking): three 10x384x640
    shots with their split (Swin-L trunk, pixel decoder, frame decoder, the
    rest) and peak; then one shot of test.max_frames = 128 frames on the
    480x864 canvas of the recipe's min_size_test (cold, then warm) with its
    peak.  Returns the launches of the three shots.  ``train.make_eval_fn``
    would take its tracking branch for a frame decoder, as the JAX
    package's does; the engine evaluates the OpenVIS arch single-shot."""
    model = init_params(train.build_model(cfg, device=DEVICE), seed=SEED).to(
        dtype=torch.bfloat16).eval()
    rng = np.random.RandomState(SEED)
    t, h, w = WINDOW_FRAMES, FRAME_H, FRAME_W
    clips = _random_clips(rng, NUM_WINDOWS, t, h, w)
    text = torch.from_numpy(_text(rng)).to(DEVICE, torch.bfloat16)
    shot = _single_shot_eval(cfg)(model, DEVICE)
    outs, ms, peak, launches = _timed_shots(model, cfg, clips, text, shot)
    seg = model.segmenter
    with StageSpans({"swin_trunk": (seg.backbone, "forward"),
                     "pixel_decoder": (seg.pixel_decoder, "forward"),
                     "frame_decoder": (seg.predictor, "forward")}) as spans:
        timed = spans.window(shot)
        for x in clips:
            timed(x, text)
    split = spans.split_ms("scores_topk_rest", NUM_WINDOWS)
    q = cfg.model.transformer_decoder.num_queries
    for i, out in enumerate(outs):
        _check_outputs(out, q, 1, t, h, w, f"Swin-L OpenVIS shot {i}")
    expected = {**{k: 0 for k in launches}, "msda_fwd": _msda_layers(cfg) * NUM_WINDOWS}
    del outs, clips
    cap = _cap_shot(shot, text, q, 1, "Swin-L OpenVIS cap")
    emit({"phase": "openvis_swinl_shot_full_width", "config": OPENVIS_SWINL_CONFIG,
          "dtype": "bfloat16", "queries": q, "shots": NUM_WINDOWS, "frames_per_shot": t,
          "padded_to": engine._bucket(t), "frame_hw": [h, w], "ms_per_shot": ms,
          "frames_per_s": t / (ms / 1e3), "split_ms_per_shot": split, "peak_mem_gib": peak,
          "launches": launches, "expected_launches": expected,
          "cap_shot": cap, "params": sum(p.numel() for p in model.parameters()),
          "card": card})
    if launches != expected:
        raise AssertionError(f"Swin-L OpenVIS shot launches {launches} != {expected}")
    del model
    torch.cuda.empty_cache()
    return launches


def phase_swinl_train(card, cfg):
    """21.3: the Swin-L OpenVIS train step at 1x2x480x864 (N=40, bf16 AMP, f32
    masters, AdamW, the recipe's drop path 0.3 drawn from the step's
    generator): one warm-up and three timed steps, the launches (K1-K3 6 a
    step, K4 once: the per-frame matcher's (20, 40, 200) problems, on the
    block solver; K5 and K6 by call shape), the trunk's LayerNorms fixed and
    its bias tables, patch embedding and the objectness head moved; K4, K5
    and K6 on the warm-up step's recorded inputs against their plain
    versions.  Returns the launches of the timed steps."""
    model = init_params(train.build_model(cfg, device=DEVICE), seed=SEED)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.startswith("segmenter.backbone.") and "norm" in n}
    trained = {n: p for n, p in model.named_parameters() if n in SWINL_TRAINED}
    before = {n: p.detach().clone() for n, p in trained.items()}
    step = train.build_train_step(cfg, model, K_CLASSES, device=DEVICE)
    batch = _train_batch(np.random.RandomState(SEED), TRAIN_H, TRAIN_W, TRAIN_N, DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    with HungarianRecorder() as k4_rec, SamplerInputs() as s_rec:
        step(batch, gen)  # warm-up: cuDNN autotuning, allocator; its inputs recorded
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
    expected = _train_launches(cfg, TRAIN_H, TRAIN_W, TRAIN_STEPS)
    values = [{k: float(v) for k, v in m.items()} for m in metrics]
    params = dict(model.named_parameters())
    fixed = all(torch.equal(params[n], v) for n, v in frozen.items())
    moved = {n: not torch.equal(p.detach(), before[n]) for n, p in trained.items()}
    k4_shapes = sorted({tuple(c.shape) for c in k4_rec.costs})
    plans = [_k4_plan(n, m, b) for b, n, m in k4_shapes]
    emit({"phase": "openvis_swinl_train_full_width", "config": OPENVIS_SWINL_CONFIG,
          "dtype": "bf16 AMP, f32 masters", "optimizer": cfg.solver.optimizer,
          "drop_path_rate": cfg.model.backbone.swin_drop_path_rate,
          "queries": cfg.model.transformer_decoder.num_queries,
          "batch": [1, TRAIN_T, TRAIN_H, TRAIN_W], "targets": TRAIN_N,
          "points": cfg.model.criterion.train_num_points, "steps": TRAIN_STEPS,
          "ms_per_step": ms, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "metrics": values, "launches": launches, "expected_launches": expected,
          "k4_costs": [list(c) for c in k4_shapes], "k4_plan": plans,
          "k5_launches_by_shape": {str(k): v for k, v in shapes.counts.items()},
          "frozen_params": len(frozen), "frozen_bit_equal": fixed, "trained_moved": moved,
          "card": card})
    if launches != expected:
        raise AssertionError(f"Swin-L OpenVIS train launches {launches} != {expected}")
    if k4_shapes != [(TRAIN_T * (cfg.model.transformer_decoder.dec_layers + 1), TRAIN_N,
                      cfg.model.transformer_decoder.num_queries)] \
            or [p["variant"] for p in plans] != ["block"]:
        raise AssertionError(f"the Swin-L matcher's K4 costs {k4_shapes} did not take the "
                             f"block solver: {plans}")
    if not all(np.isfinite(v) for m in values for v in m.values()):
        raise AssertionError("a Swin-L OpenVIS train-step loss or grad norm is not finite")
    if not fixed or not all(moved.values()) or len(moved) != len(SWINL_TRAINED):
        raise AssertionError(f"a frozen parameter changed or a trained one did not: {moved}")
    _hold_k4_k5_k6("openvis_swinl_train", k4_rec, s_rec, k4_calls=1)
    del model, step
    torch.cuda.empty_cache()
    return launches


def phase_swinl_vs_plain(clip):
    """21.4: the Swin-L OpenVIS model in f32, card against CPU, at 192x320 with
    Swin-L's widths, heads and windows cut to 2 blocks a stage (drop path 0):
    the engine's single shot of 5 frames padded to 8 (phase 7's bounds) and
    one train step (phase 9's; the CPU's loss takes the card's assignments,
    the block solver's on (16, 8, 200) costs)."""
    cfg = _swinl_config(clip, *SWINL_CHECK_OVERRIDES)
    f32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, test=dataclasses.replace(cfg.model.test, amp=False)),
        solver=dataclasses.replace(cfg.solver, amp=False))
    cpu_model = init_params(train.build_model(f32, device="cpu"), seed=SEED + 1)
    _hold_window_to_plain("openvis_swinl_kernels_vs_plain", f32, cpu_model, CHECK_TRAIN_H,
                          CHECK_TRAIN_W, make_eval=_single_shot_eval(f32),
                          frames=OFFLINE_CHECK_T, kernels=("msda_fwd",))
    cpu_model = _offsets_off_centres(
        init_params(train.build_model(f32, device="cpu"), seed=SEED + 2), SEED + 2)
    _hold_train_to_plain("openvis_swinl_train_kernels_vs_plain", f32, cpu_model,
                         TRAIN_CHECK_PARAMS + (
                             "segmenter.backbone.stage3_block1.attn.relative_position_bias_table",
                             "segmenter.backbone.patch_embed.weight",
                             "segmenter.predictor.heads.class_embed.weight"))


def phase_lvvis(card, clip, stage1):
    """21.6: ``train_net_torch.py --eval-only`` with ``eval_lvvis.yaml``
    (SANOnline over lvvis_val's 1196 classes) on phase 13's SANOnline
    checkpoint ``stage1``, over a synthetic lvvis_val written in the
    dataset's own layout (``lvvis/val/JPEGImages``,
    ``lvvis/val_ytvis_style.json``) with the LV-VIS category table, so that
    the recipe's dataset name resolves unchanged: the host seconds of the
    16,744-prompt text bank, the engine's frames/s and split, the
    evaluator's host seconds over the 1196 ids, the K1 and K4 launches.
    Returns the launches."""
    import train_net_torch as cli

    root = tempfile.mkdtemp(prefix="chip_smoke_lvvis_")
    banks, walls = [], []
    encode, evaluate = cli.TextEmbeddingBank.encode, engine.evaluate_dataset

    def timed_encode(bank, names):
        t0 = time.perf_counter()
        out = encode(bank, names)
        banks.append({"classes": len(names), "prompts": len(names) * len(bank.templates),
                      "host_s": time.perf_counter() - t0})
        return out

    def timed_evaluate(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return evaluate(*args, **kwargs)
        finally:
            walls.append(time.perf_counter() - t0)

    cli.TextEmbeddingBank.encode, engine.evaluate_dataset = timed_encode, timed_evaluate
    try:
        info = catalog.get(LVVIS_DATASET)
        t0 = time.perf_counter()
        synthetic.write_ytvis_dataset(root, info.name, LVVIS_VIDEOS,
                                      catalog.category_table(info.name), seed=SEED, layout=info)
        write_s = time.perf_counter() - t0
        out = os.path.join(root, "out")
        common = [f"datasets.root={root}", f"model.clip_adapter.weights={clip[0]}",
                  f"model.clip_adapter.bpe_vocab={clip[1]}", f"output_dir={out}"]
        cfg = load_config(LVVIS_CONFIG, common)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with EngineSpans() as spans:
            t0 = time.perf_counter()
            cli.main(["--config-file", LVVIS_CONFIG, "--eval-only", "--weights", stage1,
                      *common])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
        launches = read_counts()
        with open(os.path.join(out, f"metrics_{info.name}.json")) as f:
            metrics = json.load(f)
        with open(os.path.join(out, f"results_{info.name}.json")) as f:
            results = json.load(f)
        expected = _engine_expected(cfg, launches, LVVIS_VIDEOS)
        wall = walls[0] if walls else float("nan")
        emit({"phase": "lvvis_cli_eval", "config": LVVIS_CONFIG, "dataset": info.name,
              "classes": len(info.thing_classes), "videos_hwtn": LVVIS_VIDEOS,
              "weights": "phase 13's SANOnline CLI checkpoint", "text_bank": banks,
              "metrics": metrics, "predictions": len(results),
              "categories_predicted": len({r["category_id"] for r in results}),
              "engine_wall_s": wall, "frames": spans.frames,
              "frames_per_s": spans.frames / wall, "split_s": _engine_split(spans, wall),
              "evaluator_host_s": spans.host["finalize"],
              "ytvos_accumulate_host_s": spans.host["ytvos_accumulate"],
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "cli_s": cli_s, "dataset_write_s": write_s, "launches": launches,
              "expected_launches": expected, "card": card})
        if launches != expected:
            raise AssertionError(f"LV-VIS CLI eval launches {launches} != {expected}")
        if [b["classes"] for b in banks] != [len(info.thing_classes)] or len(walls) != 1:
            raise AssertionError(f"the LV-VIS bank encoded {banks}, the engine ran {walls}")
        if not metrics or not all(np.isfinite(v) for v in metrics.values()) or not results \
                or not {r["category_id"] for r in results} <= set(info.id_map):
            raise AssertionError(f"the LV-VIS eval wrote {metrics}, {len(results)} results")
        return launches
    finally:
        cli.TextEmbeddingBank.encode, engine.evaluate_dataset = encode, evaluate
        shutil.rmtree(root, ignore_errors=True)


def phase_swinl(card, clip, big, clip_dir, stage1):
    """Phase 21: the Swin-L OpenVIS recipe over the random ViT-L/14@336px
    ``big`` (phase 18's file) and eval_lvvis.yaml on phase 13's SANOnline
    checkpoint ``stage1``; returns the paths' launch counts by name."""
    t0 = time.perf_counter()
    cfg = _swinl_config(big)
    launches = {"openvis_swinl_eval": phase_swinl_shot(card, cfg)}
    launches["openvis_swinl_train"] = phase_swinl_train(card, cfg)
    phase_swinl_vs_plain(big)
    init = f"model.weights={_swin_init(clip_dir, cfg, 'swinl_init')}"
    launches["openvis_swinl_cli_train"], launches["openvis_swinl_cli_eval"] = _recipe_cli(
        card, big, OPENVIS_SWINL_CONFIG, SWIN_CLI_STEPS, "openvis_swinl",
        overrides=(init, f"solver.ims_per_batch={SWIN_CLI_CLIPS}"))
    launches["lvvis_cli_eval"] = phase_lvvis(card, clip, stage1)
    emit({"phase": "swinl_lvvis_done", "seconds": time.perf_counter() - t0})
    return launches


def write_adapted_clip_file(root, clip, depth):
    """Phase 11's ViT-B/16 file with a mask-adapted fine-tune's learned prompt
    table, ``visual.mask_embedding`` (depth, 196, 768), drawn nonzero from the
    seed: (weights, bpe)."""
    state = torch.load(clip[0], map_location="cpu", weights_only=True)
    width = state["visual.conv1.weight"].shape[0]
    grid = state["visual.positional_embedding"].shape[0] - 1
    gen = torch.Generator().manual_seed(SEED + 22)
    state["visual.mask_embedding"] = (torch.randn((depth, grid, width), generator=gen)
                                      * width ** -0.5).to(state["visual.proj"].dtype)
    path = os.path.join(root, "ViT-B-16-mask-adapted.pt")
    torch.save(state, path)
    return path, clip[1]


def _hold_k4_recorded(phase, rec: HungarianRecorder) -> int:
    """K4's assignment of every cost ``rec`` saw, element for element against
    ``hungarian_plain``; returns the problems held."""
    plain = _plain_assignments(rec.costs)
    cols = [c for cost_cols in rec.cols for c in cost_cols]
    differ = [i for i, ((ref, _), got) in enumerate(zip(plain, cols)) if not torch.equal(ref, got)]
    emit({"phase": f"{phase}_k4_vs_plain", "problems": len(plain), "differing": differ})
    if differ or not plain:
        raise AssertionError(f"{phase}: K4 differs from hungarian_plain on {differ} "
                             f"of {len(plain)} problems")
    return len(plain)


def phase_adapted_openvis(card, clip_adapted, plain_split_ms):
    """22.1-22.2: the OpenVISOnline recipe with ``model.clip_adapter.name=adapted``
    (the mask-prompted ViT-B/16 of ``clip_adapted``): phase 15.1's three bf16
    windows with their split beside phase 15's plain tower's (``plain_split_ms``) and K1 on the
    first encoder layer's inputs (recorded in the warm-up window) against its
    plain version; then 15.2's f32 window at 192x320, card (K1, K4) against
    CPU (plain)."""
    cfg = _openvis_config(clip_adapted, "model.clip_adapter.name=adapted")
    visual = clip_towers.build_clip_visual(cfg, DEVICE)
    with MsdaRecorder() as k1_rec:
        launches, _ = phase_openvis_window(
            card, cfg, visual, label="openvis_adapted_window_full_width",
            extra={"plain_tower_split_ms_per_window": plain_split_ms,
                   "mask_prompt_depth": cfg.model.clip_adapter.mask_prompt_depth})
    _hold_k1("openvis_adapted_eval", k1_rec)
    del visual
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_adapted_")
    try:
        phase_openvis_vs_plain(cfg, root, "openvis_adapted_kernels_vs_plain")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def _adapted_ensemble_config(root, clip, **ca):
    """Phase 12's engine config (SimpleBaselineOnline, the recipe's
    ``clip_adapter``) with ``bg_adapted``, the CLIP files ``clip`` and
    ``ca``; the segmenter's text width is the tower's embed width."""
    cfg = _ensemble_config(root, clip)
    ca = dataclasses.replace(cfg.model.clip_adapter, name="bg_adapted", **ca)
    dim = model_shape(ca.clip_model_name)["embed_dim"]
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, clip_adapter=ca, transformer_decoder=dataclasses.replace(
            cfg.model.transformer_decoder, clip_embed_dim=dim)))


def _adapted_ensemble_engine(card, clip, label, **ca):
    """22.3 (and 22.4's RN50): SimpleBaselineOnline's ensemble through the
    engine over phase 10's second video, bf16 AMP, with ``bg_adapted`` and
    the CLIP files ``clip``: the text bank, a warm-up, the timed run with its
    split, K4 on every tracking cost against ``hungarian_plain``; returns the
    launches."""
    import train_net_torch as cli

    root = tempfile.mkdtemp(prefix=f"chip_smoke_{label}_")
    try:
        _write_engine_dataset(root)
        cfg = _adapted_ensemble_config(root, clip, **ca)
        model = init_params(train.build_model(cfg, device=DEVICE), seed=SEED)
        t0 = time.perf_counter()
        text = cli.build_text_bank(cfg, DEVICE).encode(
            list(catalog.get(ENGINE_DATASET).thing_classes))
        bank_s = time.perf_counter() - t0
        visual = clip_towers.build_clip_visual(cfg, DEVICE)
        _engine_warm_up(cfg, model, text, visual, _engine_subset(ONLINE_ENGINE_VIDEOS))
        with HungarianRecorder() as tracking:
            metrics, spans, wall, launches = _engine_run(cfg, model, text, DEVICE, visual,
                                                         ONLINE_ENGINE_VIDEOS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        expected = _engine_expected(cfg, launches, ONLINE_ENGINE_VIDEOS)
        nan_preds = sum(1 for p in spans.preds if not np.isfinite(p[3]))
        finite = all(np.isfinite(v) for v in metrics.values())
        q = cfg.model.transformer_decoder.num_queries
        emit({"phase": label, "clip_adapter": dataclasses.asdict(cfg.model.clip_adapter),
              "clip_embed_dim": cfg.model.transformer_decoder.clip_embed_dim,
              "videos_hwtn": ONLINE_ENGINE_VIDEOS, "dtype": "bf16 AMP", "metrics": metrics,
              "metrics_finite": finite, "predictions": len(spans.preds),
              "nan_scored_predictions": nan_preds, "launches": launches,
              "expected_launches": expected, "frames": spans.frames, "wall_s": wall,
              "frames_per_s": spans.frames / wall, "crops": q * spans.frames,
              "split_s": {**_engine_split(spans, wall),
                          "ensemble_tracking_clip_topk_device":
                              spans.device_seconds("ensemble_topk"),
                          "clip_crops_device": spans.device_seconds("clip_crops"),
                          "roi_crop_device": spans.device_seconds("roi_crop"),
                          "text_bank_host": bank_s},
              "peak_mem_gib": peak, "card": card})
        if launches != expected:
            raise AssertionError(f"{label} launches {launches} != {expected}")
        if set(metrics) < {"AP", "AP50", "AR10"} or not spans.preds or not (finite or nan_preds):
            raise AssertionError(f"{label} metrics {metrics}, {len(spans.preds)} predictions")
        if len(spans.events["ensemble_topk"]) != len(ONLINE_ENGINE_VIDEOS) or \
                not spans.events["roi_crop"]:
            raise AssertionError(f"{label}: the engine did not run the CLIP ensemble")
        _hold_k4_recorded(label, tracking)
        if len(tracking.costs) != expected["hungarian"]:
            raise AssertionError(f"{label}: {len(tracking.costs)} K4 calls recorded, "
                                 f"{expected['hungarian']} launched")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _adapted_cli_eval(card, clip):
    """22.3: ``train_net_torch.py --eval-only`` with the SimpleBSL online recipe
    and ``model.clip_adapter.name=bg_adapted`` over phase 10's second video
    (the seeded init: no checkpoint); returns the launches."""
    import train_net_torch as cli

    root = tempfile.mkdtemp(prefix="chip_smoke_adapted_cli_")
    try:
        _write_engine_dataset(root)
        out = os.path.join(root, "out")
        opts = [f"model.clip_adapter.weights={clip[0]}", f"model.clip_adapter.bpe_vocab={clip[1]}",
                "model.clip_adapter.name=bg_adapted", f"datasets.root={root}",
                f"datasets.test=[{_engine_subset(ONLINE_ENGINE_VIDEOS)}]", f"output_dir={out}"]
        cfg = load_config(CLI_CONFIG, opts)
        reset_counts()
        t0 = time.perf_counter()
        cli.main(["--config-file", CLI_CONFIG, "--eval-only", *opts])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        ds = cfg.datasets.test[0]
        with open(os.path.join(out, f"metrics_{ds}.json")) as f:
            metrics = json.load(f)
        with open(os.path.join(out, f"results_{ds}.json")) as f:
            preds = json.load(f)
        expected = _engine_expected(cfg, launches, ONLINE_ENGINE_VIDEOS)
        emit({"phase": "ensemble_bg_adapted_cli_eval", "config": CLI_CONFIG,
              "overrides": opts[2:3], "metrics": metrics, "predictions": len(preds),
              "wall_s": wall, "launches": launches, "expected_launches": expected,
              "card": card})
        if not metrics or not all(np.isfinite(v) for v in metrics.values()) or not preds:
            raise AssertionError(f"the bg_adapted CLI eval wrote {metrics}, {len(preds)} "
                                 "predictions")
        if launches != expected:
            raise AssertionError(f"bg_adapted CLI eval launches {launches} != {expected}")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _rn_masks(rng, n, res):
    """Soft crop masks (n, res, res): a rectangle at 0.9 on 0.1, and every
    fourth crop covered whole (its attention pool masks every key: NaN)."""
    m = np.full((n, res, res), 0.1, np.float32)
    for i in range(n):
        y0, x0 = rng.randint(0, res // 2, size=2)
        m[i, y0:y0 + rng.randint(res // 4, res), x0:x0 + rng.randint(res // 4, res)] = 0.9
        if i % 4 == 3:
            m[i] = 0.9
    return m


def phase_rn_towers(card, clip_dir, bpe):
    """22.4: the RN50 and RN101 towers (``bg_adapted``), each from a random
    OpenAI-layout file read by the port's reader: the bf16 tower's ms on a
    frame's 100 crops at 224, unmasked and masked, with TFLOP/s (the
    operations counted by ``FlopCounterMode`` on those calls); then in f32
    (TF32 off) on 8 crops, card against CPU, unmasked and masked, the NaN
    rows (crops covered whole) equal.  Returns {name: weights path}."""
    from torch.utils.flop_counter import FlopCounterMode

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paths = {}
    for i, name in enumerate(ADAPTED_RN_TOWERS):
        path = os.path.join(clip_dir, f"{name}.pt")
        t0 = time.perf_counter()
        torch.save(clip_synthetic.openai_state_dict(name, seed=SEED + 7 + i), path)
        write_s = time.perf_counter() - t0
        paths[name] = path
        base = _adapted_ensemble_config(clip_dir, (path, bpe), clip_model_name=name)
        res = model_shape(name)["image_size"]
        rng = np.random.RandomState(SEED + 7)
        t0 = time.perf_counter()
        visual = clip_towers.build_clip_visual(base, DEVICE)
        load_s = time.perf_counter() - t0
        crops = torch.from_numpy(rng.randn(ADAPTED_RN_CROPS, res, res, 3).astype(np.float32))
        masks = torch.from_numpy(_rn_masks(rng, ADAPTED_RN_CROPS, res))
        crops, masks = crops.to(DEVICE, torch.bfloat16), masks.to(DEVICE, torch.bfloat16)
        timing = {}
        for key, args in (("unmasked", (crops,)), ("masked", (crops, masks))):
            with FlopCounterMode(display=False) as counter:
                out = visual(*args)
            ms = time_cuda(lambda: visual(*args), iters=10, warmup=2)
            flop = counter.get_total_flops()
            timing[key] = {"ms_per_frame_of_crops": ms, "tflop": flop / 1e12,
                           "tflop_per_s": flop / ms / 1e9, "bf16_peak_share": flop / ms * 1e3 /
                           BF16_FLOPS, "nan_rows": int(torch.isnan(out.float()).any(1).sum())}
        f32 = dataclasses.replace(base, model=dataclasses.replace(
            base.model, test=dataclasses.replace(base.model.test, amp=False)))
        x = crops[:ADAPTED_RN_CHECK_CROPS].float().cpu()
        m = masks[:ADAPTED_RN_CHECK_CROPS].float().cpu()
        cpu_vis, gpu_vis = (clip_towers.build_clip_visual(f32, d) for d in ("cpu", DEVICE))
        checks = {}
        for key, args in (("unmasked", (x,)), ("masked", (x, m))):
            ref = cpu_vis(*args)
            got = gpu_vis(*(a.to(DEVICE) for a in args)).cpu()
            nan_ref, nan_got = torch.isnan(ref).any(1), torch.isnan(got).any(1)
            keep = ~nan_ref
            err = ((got[keep] - ref[keep]).abs().max() / ref[keep].abs().max()).item()
            checks[key] = {"max_abs_err_rel_to_max": err, "nan_rows": int(nan_ref.sum()),
                           "nan_rows_equal": bool(torch.equal(nan_ref, nan_got))}
        emit({"phase": "rn_tower", "model": name, "shape": model_shape(name),
              "file_write_s": write_s, "tower_load_s": load_s, "crops": ADAPTED_RN_CROPS,
              "bf16": timing, "f32_card_vs_cpu": checks, "check_crops": ADAPTED_RN_CHECK_CROPS,
              "tol_rel_to_max": ADAPTED_RN_REL_TO_MAX, "card": card})
        for key, c in checks.items():
            if not (c["max_abs_err_rel_to_max"] <= ADAPTED_RN_REL_TO_MAX and c["nan_rows_equal"]):
                raise AssertionError(f"the {name} tower ({key}) on the card disagrees with the "
                                     f"CPU: {c}")
        if not checks["masked"]["nan_rows"] or checks["unmasked"]["nan_rows"]:
            raise AssertionError(f"{name}: the covered crops' NaN rows are not where expected")
        del visual, cpu_vis, gpu_vis
        torch.cuda.empty_cache()
    return paths


def phase_mask_adapted(card, clip, clip_dir, plain_split_ms):
    """Phase 22: the mask-adapted towers, the adapted OpenVIS window beside
    phase 15's plain one (``plain_split_ms``); returns their paths' launch
    counts by name."""
    cfg = _openvis_config(clip, "model.clip_adapter.name=adapted")
    adapted = write_adapted_clip_file(clip_dir, clip, cfg.model.clip_adapter.mask_prompt_depth)
    launches = {"openvis_adapted_eval": phase_adapted_openvis(card, adapted, plain_split_ms)}
    launches["ensemble_bg_adapted_engine"] = _adapted_ensemble_engine(
        card, adapted, "ensemble_bg_adapted_engine")
    launches["ensemble_bg_adapted_cli_eval"] = _adapted_cli_eval(card, adapted)
    rn = phase_rn_towers(card, clip_dir, clip[1])
    name = ADAPTED_RN_TOWERS[0]  # RN50: its text bank and the segmenter 1024 wide
    launches["ensemble_rn50_engine"] = _adapted_ensemble_engine(
        card, (rn[name], clip[1]), "ensemble_rn50_bg_adapted_engine", clip_model_name=name)
    return launches


def main() -> int:
    try:
        return _main()
    finally:
        if _PLAIN_POOL is not None:
            _PLAIN_POOL.shutdown()


def _main() -> int:
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
    clip_dir = tempfile.mkdtemp(prefix="chip_smoke_clip_")
    try:
        clip = write_clip_files(clip_dir)
        cli_launches, cli_eval_launches, cli_recorded = phase_cli(card, clip)
        ensemble_launches = phase_ensemble(card, clip)
        stage1 = os.path.join(clip_dir, "san_checkpoints")
        san_launches = phase_san(card, clip, keep_checkpoints=stage1)
        brivis_launches = phase_brivis(card, clip, stage1)
        openvis_launches, openvis_split_ms = phase_openvis(card, clip)
        burst_launches = phase_burst(card, clip, stage1)
        offline_launches = phase_offline(card, clip, stage1)
        ov2seg_launches = phase_ov2seg(card, clip)
        big = write_swin_clip_file(clip_dir, clip)
        swin_launches = phase_swin(card, clip, big, clip_dir)
        masq_launches, masq_recorded = phase_masqclip(card, clip)
        fpn_launches = phase_fpn(card, clip)
        swinl_launches = phase_swinl(card, clip, big, clip_dir, stage1)
        adapted_launches = phase_mask_adapted(card, clip, clip_dir, openvis_split_ms)
    finally:
        shutil.rmtree(clip_dir, ignore_errors=True)
    for name, extra in (*cli_recorded.items(), *masq_recorded.items()):
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
                              "cli_eval": cli_eval_launches[name],
                              "ensemble": ensemble_launches[name],
                              **{path: n[name] for path, n in san_launches.items()},
                              **{path: n[name] for path, n in brivis_launches.items()},
                              **{path: n[name] for path, n in openvis_launches.items()},
                              **{path: n[name] for path, n in burst_launches.items()},
                              **{path: n[name] for path, n in offline_launches.items()},
                              **{path: n[name] for path, n in ov2seg_launches.items()},
                              **{path: n[name] for path, n in swin_launches.items()},
                              **{path: n[name] for path, n in masq_launches.items()},
                              **{path: n[name] for path, n in fpn_launches.items()},
                              **{path: n[name] for path, n in swinl_launches.items()},
                              **{path: n[name] for path, n in adapted_launches.items()}},
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
