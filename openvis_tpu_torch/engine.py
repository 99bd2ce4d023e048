"""Evaluation engine: windowed and single-shot video inference + evaluator loop.

Port of ``openvis_tpu/engine.py``.  The path of the frame-decoder (online)
SimpleBaseline, OpenVIS, SAN and MinVIS: each video runs through the per-frame stack
in windows of ``window_size(cfg)`` frames, the windows' outputs are
concatenated over time, identity is restored by embedding tracking over the
whole video (``minvis.py:320-338``), the top-k (query, class) pairs are kept
and their masks go to the evaluator.

BriVIS (JAX ``_evaluate_brivis_windowed``, ``_evaluate_brivis_raw_windowed``,
``engine.py:585-800``): the frozen frame stack runs in windows, its small
outputs stay on the device, the whole video's embeds are tracked and
resampled once, and the resampler's heads with the biased CLIP post-encode
run per window; the class scores are the softmax of the logits' mean over the
real frames.  The raw resampler interleaves: each layer's temporal half runs
over the whole video, its frame half per window against that window's token
maps.

Differences from the JAX engine, none of which changes a result on the real
frames:

* No padding to static shapes.  The JAX engine pads every window to
  ``window`` frames and the time axis to a multiple of 8 for XLA; here each
  window runs at its real length and tracking and the frame mean see the T
  real frames only.  The per-frame stack is independent across frames and
  tracking is causal, so the real frames' outputs are the same.  The BriVIS
  resampler is the exception: its temporal self-attention is not masked, so
  frames appended to the video change the real frames' outputs.  The port
  pads its input to ``_bucket(t)`` frames by repeating the last one, as the
  JAX engine does, so that the two agree (the reference runs it over the
  real T; ROADMAP.md records the difference).  OV2Seg's post-process is
  padded the same way (below): its video score averages the padded frames.
* The windows' outputs stay on the device; the only blocking copies of a
  video are the top-k scores and labels, and each prediction's thresholded
  masks (``evals/ytvis_eval.py``), which are resized on the device.
* AMP eval (``test.amp``) runs the model through ``torch.func.functional_call``
  on bf16 copies of its parameters, so the caller's f32 parameters are never
  touched.
* SANOnline runs without its aux layers' CLIP logits (``train.eval_model``;
  JAX ``engine.py:315-317``); the CLIP ensemble is SimpleBaseline's only
  (JAX ``train_net.py:250-253``).

With a CLIP visual tower (``clip_towers.build_clip_visual``) and
``clip_adapter.clip_ensemble``, SimpleBaselineOnline's open-vocabulary
ensemble (JAX ``engine.py:341-356``, ``:457-504``) scores the video: tracking
once, the masks aligned by track, mask-crop CLIP scores over the real
frames, the model's own tracked scores, their geometric mean, the top-k of
the aligned masks.  OpenVISOnline (JAX ``engine.py:340-345``, ``:452-495``)
needs the tower: its class-agnostic proposals are tracked once, the masks of
all Q queries aligned by track, and the mask-crop CLIP logits over the real
frames (against the text rows, no no-object row) averaged over each query's
valid frames before one softmax replace the model's scores; a query valid in
no frame scores 0.  That the port runs each window at its real length
changes nothing here either: tracking is causal and the crops read only the
real frames.

A dataset whose ``eval_type`` is ``burst`` goes to the BURST evaluator
(``evals/burst_eval.py``: HOTA and TrackMAP over the class splits), its GT
tracks read from the BURST json (``data/mapper.load_burst_records``).

Under a process group (``parallel/dist.py``) process p reads and evaluates
videos p, p + P, ... (``max_videos`` counted globally); rank 0 gathers the
predictions (``torch.distributed``, no shared file system) and scores them;
the other processes return ``{}``.

The offline (video-decoder) archs, SimpleBaseline, OpenVIS, SAN,
VideoMaskFormer and MasQCLIP, evaluate single-shot (JAX ``_evaluate_single_shot``,
``engine.py:216-295``, ``:836-939``): a video of ``_bucket(t) <=
test.max_frames`` frames runs as one forward of ``_bucket(t)`` frames, padded
with its last frame repeated as the JAX engine pads it (the video decoder's
attention over the clip is not masked, so the padded frames change the real
frames' outputs); a longer one runs in windows of ``window_size(cfg)``, the
tail padded to a whole window, its per-window scores summed and divided by
T, its masks joined over the real frames.  A clip-level head scores
``softmax(logits)`` less the no-object column; a frame-level head (OpenVIS's
``frame_proposal``, SAN's per-frame CLIP logits) averages its logits over the
real frames first.  Offline SimpleBaseline with the CLIP tower and
``clip_ensemble`` ensembles every query's scores with the mask-crop CLIP
scores over the real frames before the top-k; nothing is tracked.  Offline
OpenVIS is scored on its objectness, as in the JAX engine (ROADMAP.md §3
records that the reference crops with CLIP there too).

OV2Seg (JAX ``engine.py:133-134``, ``:145-171``, ``:442-450``) runs the
windowed path and then follows the JAX engine's padding: the logits,
objectness logits, embeddings and masks of the T real frames are padded to
``_bucket(T)`` frames with the last one repeated, tracked by the EMA chain
(alpha 0.7, one Hungarian solve a frame), scored by ``ov2seg_eval_scores``
on the aligned logits, whose frame mean runs over all ``_bucket(T)`` frames
(the repeated last frame enters the video score; ROADMAP.md §3 records that
the reference averages the real frames), reduced to the top-k and gated per
frame; the masks go to the evaluator cut to the T real frames.

MasQCLIP evaluates single-shot (JAX ``engine.py:243-246``, ``:280-287``,
``:921-923``): a shot's scores are ``masqclip_eval_scores`` (the objectness
and the MasQ tower's CLIP logits fused, both averaged over all the shot's
frames, the padded ones too, as in JAX); a window's are those scores times
its real frames, summed over the windows and divided by T with no softmax.
"""

from __future__ import annotations

import json
import logging
import os
from itertools import accumulate
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from openvis_tpu_torch.config import Config
from openvis_tpu_torch.data import catalog
from openvis_tpu_torch.data.loader import test_videos
from openvis_tpu_torch.data.mapper import load_burst_records
from openvis_tpu_torch.evals.burst_eval import BURSTEvaluator
from openvis_tpu_torch.evals.ytvis_eval import YTVISEvaluator
from openvis_tpu_torch.models.clip_adapter import frame_average_scores
from openvis_tpu_torch.models.meta.masqclip import MasQCLIPModel, masqclip_eval_scores
from openvis_tpu_torch.models.meta.ov2seg import ov2seg_eval_scores, ov2seg_frame_gate
from openvis_tpu_torch.models.meta.simple_baseline import eval_scores
from openvis_tpu_torch.models.postprocess import inference_video_topk
from openvis_tpu_torch.models.tracking import apply_track_indices, track_by_embeds
from openvis_tpu_torch.parallel import dist
from openvis_tpu_torch.train import check_arch, eval_model, resolve_device

logger = logging.getLogger(__name__)

OV2SEG_EMA_ALPHA = 0.7  # OV2Seg's tracker (JAX engine.py:145)
# the offline (clip-level) archs: the JAX engine's list less BriVIS, which it
# dispatches first (its own whole-video path here too)
_OFFLINE_ARCHS = ("VideoMaskFormer", "SimpleBaseline", "OpenVIS", "SAN", "MasQCLIP")


def verify_expected_results(expected, dataset_name: str, metrics: Dict) -> bool:
    """Check eval metrics against config expectations — the reference's
    ``verify_results(cfg, res)`` over ``TEST.EXPECTED_RESULTS``
    (train_net.py:294-295).  ``expected`` is the config's
    ``model.test.expected_results``: [dataset, metric, value, tolerance]
    rows; rows for other datasets are skipped.  Logs each comparison and
    returns False if any row for this dataset is missing or out of
    tolerance."""
    ok = True
    for row in expected:
        ds, metric, want, tol = row
        if ds != dataset_name:
            continue
        if metric not in metrics:
            logger.error("expected_results: %s has no metric %r (have %s)",
                         dataset_name, metric, sorted(metrics))
            ok = False
            continue
        got = float(metrics[metric])
        good = abs(got - float(want)) <= float(tol)
        (logger.info if good else logger.error)(
            "expected_results: %s %s = %.4f, expected %.4f ± %.4f -> %s",
            dataset_name, metric, got, float(want), float(tol),
            "OK" if good else "FAIL",
        )
        ok = ok and good
    return ok


def make_evaluator(info: catalog.DatasetInfo):
    """The dataset's evaluator (Trainer.build_evaluator, reference
    train_net.py:78-88): HOTA and TrackMAP for BURST datasets, the YTVIS
    COCO-protocol suite for the rest."""
    if info.eval_type == "burst":
        return BURSTEvaluator(class_splits=catalog.burst_class_splits(), dataset_info=info)
    return YTVISEvaluator(info)


def window_size(cfg: Config) -> int:
    """Effective inference window.  ``test.window_inference: false`` (the
    reference's ``MODEL.MASK_FORMER.TEST.WINDOW_INFERENCE`` default) evaluates
    a video as one window of up to ``test.max_frames`` frames; longer videos
    are windowed regardless, so no frame is dropped."""
    t = cfg.model.test
    return t.window_size if t.window_inference else t.max_frames


def eval_dtype(cfg: Config) -> torch.dtype:
    """bf16 under AMP eval (``test.amp``, the reference's autocast
    evaluation, train_net.py:241-242), else f32."""
    return torch.bfloat16 if cfg.model.test.amp else torch.float32


def amp_cast(cfg: Config, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every f32 tensor cast to bf16 under AMP eval (new tensors: the inputs
    are not modified); other dtypes pass through."""
    if not cfg.model.test.amp:
        return tensors
    return {k: (v.to(torch.bfloat16) if v.dtype == torch.float32 else v)
            for k, v in tensors.items()}


def make_window_fn(cfg: Config, model: nn.Module) -> Callable:
    """f(params, frames (W, H, Wd, 3), text_feats) -> the window's raw outputs:
    logits (W, Q, C), masks (Q, W, h, w) and embeds (W, Q, C); OV2Seg's also
    its objectness logits ``obj_logits`` (W, Q, 2).  ``params`` maps the
    model's parameter names to the tensors to run it with."""
    model = eval_model(model)
    ov2seg = cfg.model.meta_architecture.startswith("OV2Seg")

    def fn(params, frames, text_feats):
        out = torch.func.functional_call(model, params, (frames, frames.shape[0], text_feats))
        res = {"logits": out["pred_logits"][0], "masks": out["pred_masks"][0],
               "embeds": out["pred_embeds"][0]}
        if ov2seg:
            res["obj_logits"] = out["pred_object_logits"][0]
        return res

    return fn


def ov2seg_topk(logits, masks, embeds, obj_logits, topk: int) -> Dict[str, torch.Tensor]:
    """OV2Seg's post-process of a video's T real frames (JAX ``engine.py:145-171``
    after its padding, ``:442-450``): everything padded to ``_bucket(T)``
    frames with the last one, the EMA tracker, ``ov2seg_eval_scores`` on the
    aligned logits (their mean over all ``_bucket(T)`` frames), the top-k,
    the per-frame gate; the top-k masks cut to the T real frames."""
    t = logits.shape[0]
    tb = _bucket(t)
    logits, embeds, obj_logits = (_pad_frames(x, tb) for x in (logits, embeds, obj_logits))
    masks = _pad_frames(masks, tb, dim=1)
    indices = track_by_embeds(embeds[None], ema_alpha=OV2SEG_EMA_ALPHA)     # (1, Tb, Q)
    logits = apply_track_indices(logits[None], indices)[0]
    obj = apply_track_indices(obj_logits[None], indices)[0]
    video, per_frame = ov2seg_eval_scores(logits, obj)
    out = inference_video_topk(video, masks, topk, track_indices=indices[0])
    sel = per_frame[:, out["query_idx"]]                                     # (Tb, topk, K)
    pf_sel = torch.gather(sel, 2, out["labels"][None, :, None].expand(tb, -1, 1))[..., 0]
    out["mask_logits"] = ov2seg_frame_gate(out["mask_logits"], out["scores"], pf_sel)[:, :t]
    return out


def make_postprocess_fn(cfg: Config) -> Callable:
    """f(logits (T, Q, C), masks (Q, T, h, w), embeds (T, Q, C), obj_logits=None)
    -> top-k dict over the video's T frames: tracking, the frame-mean scores
    without the no-object column, the top-k (query, class) pairs and their
    masks; OV2Seg's: ``ov2seg_topk`` with its (T, Q, 2) objectness logits."""
    topk = cfg.model.test.topk_per_video
    ov2seg = cfg.model.meta_architecture.startswith("OV2Seg")

    def fn(logits, masks, embeds, obj_logits=None):
        if ov2seg:
            return ov2seg_topk(logits, masks, embeds, obj_logits, topk)
        # masks stay in raw per-frame query order; tracking alignment is
        # fused into the top-k gather, so only the selected masks move
        indices = track_by_embeds(embeds[None])                # (1, T, Q)
        scores = eval_scores(apply_track_indices(logits[None], indices))[0]
        return inference_video_topk(scores, masks, topk, track_indices=indices[0])

    return fn


def make_ensemble_fn(cfg: Config, clip_visual_apply, params: Dict[str, torch.Tensor],
                     text: torch.Tensor) -> Callable:
    """f(logits (T, Q, C), masks (Q, T, h, w), embeds (T, Q, C), pixels (T, H,
    W, 3) on the host) -> top-k dict of SimpleBaselineOnline's CLIP ensemble
    (simplebsl.py:122-163): tracking once, the masks aligned by track, the
    mask-crop CLIP scores over the frames, the tracked frame-mean scores
    without the no-object column, their geometric mean, and the top-k of the
    aligned masks."""
    from openvis_tpu_torch import clip_towers  # it imports this module's eval_dtype

    topk = cfg.model.test.topk_per_video
    window = window_size(cfg)
    weight = cfg.model.clip_adapter.clip_ensemble_weight
    score_fn = clip_towers.make_openvis_score_fn(cfg, clip_visual_apply)
    text_crop, crop_has_bg = clip_towers.crop_text_with_bg(cfg, params, text)

    def fn(logits, masks, embeds, pixels):
        t = logits.shape[0]
        indices = track_by_embeds(embeds[None])                        # (1, T, Q)
        aligned = apply_track_indices(masks.transpose(0, 1)[None], indices)[0]  # (T, Q, h, w)
        clip_lg, clip_vd = clip_towers.clip_crop_scores(cfg, score_fn, pixels, aligned,
                                                        text_crop, window, t)
        scores = eval_scores(apply_track_indices(logits[None], indices))[0]
        scores = clip_towers.apply_clip_ensemble(scores, clip_lg, clip_vd, weight,
                                                 drop_last=crop_has_bg)
        return inference_video_topk(scores, aligned.transpose(0, 1), topk)

    return fn


def make_openvis_fn(cfg: Config, clip_visual_apply, text: torch.Tensor) -> Callable:
    """f(logits (T, Q, 2), masks (Q, T, h, w), embeds (T, Q, C), pixels (T, H,
    W, 3) on the host) -> top-k dict of OpenVIS's open-vocabulary inference
    (openvis.py:110-147, ``:244-281``): tracking once, the masks of all
    queries aligned by track, the mask-crop CLIP logits over the real frames
    against ``text`` (no no-object row), their mean over each query's valid
    frames and one softmax, 0 for a query valid in no frame, the top-k of the
    aligned masks.  The proposal logits are not read."""
    from openvis_tpu_torch import clip_towers  # it imports this module's eval_dtype

    topk = cfg.model.test.topk_per_video
    window = window_size(cfg)
    score_fn = clip_towers.make_openvis_score_fn(cfg, clip_visual_apply)

    def fn(logits, masks, embeds, pixels):
        t = embeds.shape[0]
        indices = track_by_embeds(embeds[None])                        # (1, T, Q)
        aligned = apply_track_indices(masks.transpose(0, 1)[None], indices)[0]  # (T, Q, h, w)
        clip_lg, clip_vd = clip_towers.clip_crop_scores(cfg, score_fn, pixels, aligned, text,
                                                        window, t)
        scores, qvalid = frame_average_scores(clip_lg, clip_vd, mode="logits_then_softmax")
        scores = torch.where(qvalid[:, None], scores, 0.0)
        return inference_video_topk(scores, aligned.transpose(0, 1), topk)

    return fn


def _bucket(n: int, step: int = 8) -> int:
    """The JAX engine's time bucket: a multiple of ``step``, at least ``step``."""
    return max(step, -(-n // step) * step)


class _Method(nn.Module):
    """``model.<name>`` as a module's forward, so ``torch.func.functional_call``
    can run it with other parameters (the names take a ``model.`` prefix)."""

    def __init__(self, model: nn.Module, name: str):
        super().__init__()
        self.model, self.name = model, name

    def forward(self, *args):
        return getattr(self.model, self.name)(*args)


def make_brivis_video_fn(cfg: Config, model: nn.Module, params: Dict[str, torch.Tensor]
                         ) -> Callable:
    """f(pixels (T, H, W, 3) on the host, text (K, D), device, dtype) -> top-k
    dict of one video through BriVIS: the frozen frame stack in windows, the
    embeds padded to ``_bucket(T)`` frames with the last one, tracked and
    resampled over the whole video, the heads and the biased CLIP post-encode
    per window of real frames, the top-k of the frame-mean scores."""
    model = eval_model(model)
    window = window_size(cfg)
    topk = cfg.model.test.topk_per_video
    raw = cfg.model.resampler.name == "raw"
    nlayers = cfg.model.resampler.num_layers
    prefixed = {f"model.{n}": p for n, p in params.items()}
    methods = {}

    def call(name, *args):
        if name not in methods:
            methods[name] = _Method(model, name)
        return torch.func.functional_call(methods[name], prefixed, args)

    def raw_layers(aligned, stack, t, tb):
        """The raw resampler's layers: (Tb, Q, C) aligned -> normed (Tb, Q, C)."""
        ms = [torch.cat([p["ms_feats"][lvl] for p in stack]) for lvl in range(3)]
        ms_pos = stack[0]["ms_pos"]
        # the padded frames cross-attend into the last real frame's tokens
        frame = torch.arange(tb, device=aligned.device).clamp(max=t - 1)
        x = aligned.transpose(0, 1)                                   # (Q, Tb, C)
        for i in range(nlayers):
            pf = call("raw_temporal", x, i).transpose(0, 1)           # (Tb, Q, C)
            lvl = i % 3
            pf = torch.cat([call("raw_frame", pf[j:j + window], ms[lvl][frame[j:j + window]],
                                 ms_pos[lvl], i) for j in range(0, tb, window)])
            x = pf.transpose(0, 1)
        return call("raw_finalize", x.transpose(0, 1))

    def fn(pixels, text, device, dtype):
        t = pixels.shape[0]
        stack = [call("frame_stack", torch.from_numpy(pixels[i:i + window]).to(
                     device, dtype, non_blocking=True), min(window, t - i))
                 for i in range(0, t, window)]
        embeds = torch.cat([p["pred_embeds"][0] for p in stack])       # (T, Q, C)
        tb = _bucket(t)
        padded = _pad_frames(embeds, tb)
        indices = track_by_embeds(padded[None])                        # (1, Tb, Q)
        aligned = apply_track_indices(padded[None], indices)
        final = raw_layers(aligned[0], stack, t, tb) if raw else call("resample", aligned)[0]
        final = final[:t]                                              # the real frames
        feats = {k: torch.cat([p[k] for p in stack])
                 for k in ("mask_feats", "attn_feats", "bk_tokens")}
        heads = [call("predict_window", final[i:i + window],
                      *(feats[k][i:i + window] for k in ("mask_feats", "attn_feats",
                                                         "bk_tokens")), text)
                 for i in range(0, t, window)]
        masks = torch.cat([m for m, _ in heads])                      # (T, Q, h, w)
        logits = torch.cat([lg for _, lg in heads])                   # (T, Q, K+1)
        scores = torch.softmax(logits.float().mean(0), dim=-1)[:, :-1]
        return inference_video_topk(scores, masks.transpose(0, 1), topk)

    return fn


def is_single_shot(arch: str) -> bool:
    """The offline (clip-level) archs evaluate the whole bucketed video in one
    forward."""
    return arch in _OFFLINE_ARCHS


def _frame_mean(logits: torch.Tensor, frame_valid: torch.Tensor) -> torch.Tensor:
    """(T, Q, C) logits -> (Q, C) f32 sums over the valid frames."""
    return (logits.float() * frame_valid[:, None, None].float()).sum(0)


def _shot(model: nn.Module, params, frames: torch.Tensor, text_feats: torch.Tensor):
    """One clip's forward: (masks (Q, T, h, w), logits (Q, C) or (T, Q, C));
    MasQCLIP's "logits" are its fused probabilities (Q, K-1)."""
    out = torch.func.functional_call(model, params, (frames, frames.shape[0], text_feats))
    scores = (masqclip_eval_scores(out) if isinstance(model, MasQCLIPModel)
              else out["pred_logits"])[0]
    # a copy: the slice would hold every layer's masks alive
    return out["pred_masks"][0].clone(), scores


def make_single_shot_fn(cfg: Config, model: nn.Module, pre_topk: bool = False) -> Callable:
    """f(params, frames (T, H, W, 3), text_feats, frame_valid (T,)) -> top-k dict
    of one video's single shot (JAX ``engine.py:236-262``): the clip-level
    head's ``softmax(logits)`` less the no-object column, a frame-level
    head's logits averaged over the valid frames first (scores in f32).
    ``pre_topk`` returns ``(probs (Q, K), masks (Q, T, h, w))`` of all queries
    instead: the SimpleBaseline ensemble scores every query with the CLIP
    crops before the top-k."""
    topk = cfg.model.test.topk_per_video
    model = eval_model(model)
    masq = cfg.model.meta_architecture == "MasQCLIP"

    def fn(params, frames, text_feats, frame_valid):
        masks, logits = _shot(model, params, frames, text_feats)
        if masq:                                                   # already fused (Q, K-1)
            probs = logits
        else:
            if logits.dim() == 3:                                  # (T, Q, C): frame head
                logits = _frame_mean(logits, frame_valid) / frame_valid.sum().clamp(min=1)
            probs = torch.softmax(logits.float(), dim=-1)[..., :-1]
        if pre_topk:
            return probs, masks
        return inference_video_topk(probs, masks, topk)

    return fn


def make_single_shot_window_fn(cfg: Config, model: nn.Module) -> Callable:
    """f(params, frames (W, H, Wd, 3), text_feats, frame_valid (W,)) ->
    (score sums (Q, C) f32, masks (Q, W, h, w)) of one window of a video
    longer than ``test.max_frames`` (JAX ``engine.py:265-298``, the
    reference's ``run_window_inference``): a clip-level head's logits times
    the window's valid frames, a frame-level head's logits summed over them;
    the caller sums the windows and divides by T.  MasQCLIP's: its fused
    probabilities (Q, K-1) times the window's valid frames."""
    model = eval_model(model)

    def fn(params, frames, text_feats, frame_valid):
        masks, logits = _shot(model, params, frames, text_feats)
        if logits.dim() == 3:                                      # (W, Q, C): frame head
            return _frame_mean(logits, frame_valid), masks
        return logits.float() * frame_valid.sum(), masks

    return fn


def _pad_frames(x: torch.Tensor, n: int, dim: int = 0) -> torch.Tensor:
    """``x`` padded to ``n`` frames along ``dim`` with its last frame repeated,
    as the JAX engine pads."""
    shape = list(x.shape)
    shape[dim] = n - x.shape[dim]
    return torch.cat([x, x.narrow(dim, x.shape[dim] - 1, 1).expand(shape)], dim=dim)


def _evaluate_single_shot(cfg: Config, model: nn.Module, params: Dict[str, torch.Tensor],
                          dataset_name: str, text: torch.Tensor, max_videos, evaluator,
                          clip_visual_apply, device, dtype) -> List[int]:
    """The offline archs' eval loop (JAX ``engine.py:840-944``); returns the
    predictions of each video, in this process's order."""
    arch = cfg.model.meta_architecture
    topk = cfg.model.test.topk_per_video
    max_frames = cfg.model.test.max_frames
    window = window_size(cfg)
    ensemble = (arch == "SimpleBaseline" and cfg.model.clip_adapter.clip_ensemble
                and clip_visual_apply is not None)
    shot_fn = make_single_shot_fn(cfg, model, pre_topk=ensemble)
    window_fn = make_single_shot_window_fn(cfg, model)
    if ensemble:
        from openvis_tpu_torch import clip_towers  # it imports this module's eval_dtype

        score_fn = clip_towers.make_openvis_score_fn(cfg, clip_visual_apply)
        text_crop, crop_has_bg = clip_towers.crop_text_with_bg(cfg, params, text)
        weight = cfg.model.clip_adapter.clip_ensemble_weight

    def ensembled_topk(probs, masks, pixels, t):
        clip_lg, clip_vd = clip_towers.clip_crop_scores(cfg, score_fn, pixels,
                                                        masks.transpose(0, 1), text_crop,
                                                        window, t)
        scores = clip_towers.apply_clip_ensemble(probs, clip_lg, clip_vd, weight,
                                                 drop_last=crop_has_bg)
        return inference_video_topk(scores, masks, topk)

    counts = []
    for rec, sample in test_videos(cfg, dataset_name, max_videos, dist.rank(), dist.world()):
        pixels = sample["pixels"]                                  # (T, H, W, 3) numpy
        t = pixels.shape[0]
        tb = _bucket(t)
        frames = torch.from_numpy(pixels).to(device, dtype, non_blocking=True)
        if tb <= max_frames:
            fv = torch.arange(tb, device=device) < t
            out = shot_fn(params, _pad_frames(frames, tb), text, fv)
            topk_out = ensembled_topk(*out, pixels, t) if ensemble else out
        else:
            # longer than the single-shot cap: the reference's windowed
            # decomposition, no frame dropped
            logger.info("video %s: t=%d > max_frames=%d, windowed offline eval",
                        rec["video_id"], t, max_frames)
            acc, parts = 0.0, []
            for i in range(0, t, window):
                keep = min(window, t - i)
                lg, mk = window_fn(params, _pad_frames(frames[i:i + window], window), text,
                                   torch.arange(window, device=device) < keep)
                acc = acc + lg
                parts.append(mk[:, :keep])
            masks = _pad_frames(torch.cat(parts, dim=1), tb, dim=1)  # (Q, Tb, h, w)
            # MasQCLIP's windows sum fused probabilities: no softmax
            probs = acc / t if arch == "MasQCLIP" else torch.softmax(acc / t, dim=-1)[..., :-1]
            topk_out = (ensembled_topk(probs, masks, pixels, t) if ensemble
                        else inference_video_topk(probs, masks, topk))
        del frames
        topk_out["mask_logits"] = topk_out["mask_logits"][:, :t]
        _process(evaluator, rec, sample, topk_out, counts)
    return counts


def evaluate_dataset(
    cfg: Config,
    model: nn.Module,
    dataset_name: str,
    text_feats,
    max_videos: Optional[int] = None,
    clip_visual_apply=None,
    device="cuda",
) -> Dict[str, float]:
    """Evaluate ``model`` (built by ``train.build_model``) on a registered
    dataset with text embeddings ``text_feats`` (K, D) and return the
    evaluator's metrics.  Runs on ``device`` (the card unless the caller
    passes ``"cpu"``); the model's parameters are read, never modified.
    ``clip_visual_apply`` (``clip_towers.build_clip_visual``, on the same
    device) is OpenVISOnline's classifier, which needs it, and turns on
    SimpleBaseline's CLIP ensemble where ``clip_adapter.clip_ensemble`` asks
    for it, as in the JAX engine; the offline archs evaluate single-shot
    (offline OpenVIS on its objectness, without the tower).  Under a
    process group every process calls it; rank 0 returns the metrics of all
    the processes' videos, the others ``{}``."""
    arch = cfg.model.meta_architecture
    check_arch(arch)
    device = resolve_device(device)
    evaluator = make_evaluator(catalog.get(dataset_name))
    dtype = eval_dtype(cfg)
    window = window_size(cfg)
    params = amp_cast(cfg, {n: p.detach().to(device) for n, p in model.named_parameters()})
    text = torch.as_tensor(text_feats).to(device, dtype)
    if is_single_shot(arch):
        with torch.inference_mode():
            counts = _evaluate_single_shot(cfg, model, params, dataset_name, text, max_videos,
                                           evaluator, clip_visual_apply, device, dtype)
        return _finalize(cfg, dataset_name, evaluator, counts)
    # after the single-shot dispatch, as in the JAX engine: offline OpenVIS
    # evaluates without the tower
    if arch.startswith("OpenVIS") and clip_visual_apply is None:
        raise ValueError("OpenVISOnline's evaluation needs the CLIP visual tower: pass "
                         "clip_visual_apply (clip_towers.build_clip_visual)")
    window_fn = make_window_fn(cfg, model)
    post_fn = make_postprocess_fn(cfg)
    video_fn = crop_fn = None  # crop_fn: the mask-crop CLIP scoring of a video
    if arch == "BriVIS":
        video_fn = make_brivis_video_fn(cfg, model, params)
    elif arch.startswith("OpenVIS"):
        crop_fn = make_openvis_fn(cfg, clip_visual_apply, text)
    elif (clip_visual_apply is not None and cfg.model.clip_adapter.clip_ensemble
            and arch.startswith("SimpleBaseline")):
        crop_fn = make_ensemble_fn(cfg, clip_visual_apply, params, text)

    counts = []  # predictions of each video, in this process's order
    with torch.inference_mode():
        for rec, sample in test_videos(cfg, dataset_name, max_videos, dist.rank(),
                                       dist.world()):
            pixels = sample["pixels"]                          # (T, H, W, 3) numpy
            t = pixels.shape[0]
            if video_fn is not None:
                _process(evaluator, rec, sample, video_fn(pixels, text, device, dtype), counts)
                continue
            # the uploads do not wait for the stream: a blocking copy would
            # hold the host behind the previous window's queued work
            parts = [window_fn(params, torch.from_numpy(pixels[i:i + window]).to(
                         device, dtype, non_blocking=True), text)
                     for i in range(0, t, window)]
            logits = torch.cat([p["logits"] for p in parts])            # (T, Q, C)
            masks = torch.cat([p["masks"] for p in parts], dim=1)       # (Q, T, h, w)
            embeds = torch.cat([p["embeds"] for p in parts])            # (T, Q, C)
            extra = ({"obj_logits": torch.cat([p["obj_logits"] for p in parts])}
                     if "obj_logits" in parts[0] else {})
            del parts
            if crop_fn is None:
                topk = post_fn(logits, masks, embeds, **extra)
            else:
                topk = crop_fn(logits, masks, embeds, pixels)
            del logits, masks, embeds, extra
            _process(evaluator, rec, sample, topk, counts)
    return _finalize(cfg, dataset_name, evaluator, counts)


def _process(evaluator, rec, sample, topk, counts: List[int]) -> None:
    """A video's top-k to the evaluator (JAX ``_emit``); its number of
    predictions to ``counts``."""
    n = len(evaluator.predictions)
    emit = (evaluator.process_video if isinstance(evaluator, BURSTEvaluator)
            else evaluator.process)
    emit(rec["video_id"], topk, sample["image_size"], sample["orig_size"],
         sample["pixels"].shape[1:3])
    counts.append(len(evaluator.predictions) - n)


def _record_order(parts: List[Tuple[List[Dict], List[int]]]) -> List[Dict]:
    """Process p evaluated records p, p + P, ... (``test_videos``): interleave
    the processes' runs of per-video predictions back into record order."""
    runs = []
    for preds, counts in parts:
        runs.append([preds[e - c:e] for c, e in zip(counts, accumulate(counts))])
    return [p for j in range(max(map(len, runs))) for run in runs if j < len(run)
            for p in run[j]]


def _burst_gt_tracks(info: catalog.DatasetInfo, root: str) -> List[Dict]:
    """The GT tracks of a BURST dataset, one dict a track (JAX ``engine.py:545-555``)."""
    return [{"video_id": rec["video_id"], "category_id": ann["category_id"],
             "segmentations": ann["segmentations"]}
            for rec in load_burst_records(info, root) for ann in rec["annotations"]]


def _finalize(cfg: Config, dataset_name: str, evaluator, counts: List[int]) -> Dict[str, float]:
    """Gather the predictions on rank 0 (in record order, as one process
    makes them; ``counts``: this process's predictions of each of its
    videos), dump them next to the metrics (ytvis_eval.py:136-175) and score
    them against the dataset's GT (its json; a BURST dataset's tracks over
    its LVIS ids); ``{}`` on the other ranks."""
    info = catalog.get(dataset_name)
    if dist.initialized():
        parts = dist.gather_to_rank0((evaluator.predictions, counts))
        if parts is None:
            return {}
        evaluator.predictions = _record_order(parts)
    if cfg.output_dir:
        os.makedirs(cfg.output_dir, exist_ok=True)
        path = os.path.join(cfg.output_dir, f"results_{dataset_name}.json")
        with open(path, "w") as f:
            json.dump(evaluator.predictions, f)
        logger.info("wrote %d predictions to %s", len(evaluator.predictions), path)

    if isinstance(evaluator, BURSTEvaluator):
        gts = _burst_gt_tracks(info, cfg.datasets.root)
        if not gts:
            logger.warning("%s has no GT tracks; writing predictions only", dataset_name)
            return {"num_predictions": float(len(evaluator.predictions))}
        return evaluator.evaluate(gts, sorted(info.id_map))
    with open(os.path.join(cfg.datasets.root, info.json_file)) as f:
        gt_json = json.load(f)
    if not gt_json.get("annotations"):
        logger.warning("%s has no GT annotations; writing predictions only", dataset_name)
        return {"num_predictions": float(len(evaluator.predictions))}
    metrics = evaluator.evaluate(gt_json)
    per_cat = getattr(evaluator, "per_category", None)
    if per_cat and cfg.output_dir:
        with open(os.path.join(cfg.output_dir, f"percat_{dataset_name}.json"), "w") as f:
            json.dump(per_cat, f)
        shown = sorted(((n, v) for n, v in per_cat.items() if v == v), key=lambda kv: -kv[1])
        table = "\n".join(f"  {n:<28s} {v * 100:6.2f}" for n, v in shown)
        logger.info("per-category AP (%s):\n%s", dataset_name, table)
    return metrics
