"""Evaluation engine: windowed video inference + evaluator loop.

Port of ``openvis_tpu/engine.py``, the path of the frame-decoder (online)
SimpleBaseline: each video runs through the per-frame stack in windows of
``window_size(cfg)`` frames, the windows' outputs are concatenated over time,
identity is restored by embedding tracking over the whole video
(``minvis.py:320-338``), the top-k (query, class) pairs are kept and their
masks go to the YTVIS evaluator.

Differences from the JAX engine, none of which changes a result on the real
frames:

* No padding to static shapes.  The JAX engine pads every window to
  ``window`` frames and the time axis to a multiple of 8 for XLA; here each
  window runs at its real length and tracking and the frame mean see the T
  real frames only.  The per-frame stack is independent across frames and
  tracking is causal, so the real frames' outputs are the same.
* The windows' outputs stay on the device; the only blocking copies of a
  video are the top-k scores and labels, and each prediction's thresholded
  masks (``evals/ytvis_eval.py``), which are resized on the device.
* AMP eval (``test.amp``) runs the model through ``torch.func.functional_call``
  on bf16 copies of its parameters, so the caller's f32 parameters are never
  touched.

Under a process group (``parallel/dist.py``) process p reads and evaluates
videos p, p + P, ... (``max_videos`` counted globally); rank 0 gathers the
predictions (``torch.distributed``, no shared file system) and scores them;
the other processes return ``{}``.

Everything the JAX engine dispatches elsewhere (BriVIS, the offline archs,
OpenVIS, OV2Seg, the CLIP ensemble, BURST) raises ``NotImplementedError``
naming its ROADMAP.md item.
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
from openvis_tpu_torch.evals.ytvis_eval import YTVISEvaluator
from openvis_tpu_torch.models.meta.simple_baseline import eval_scores
from openvis_tpu_torch.models.postprocess import inference_video_topk
from openvis_tpu_torch.models.tracking import apply_track_indices, track_by_embeds
from openvis_tpu_torch.parallel import dist
from openvis_tpu_torch.train import resolve_device

logger = logging.getLogger(__name__)

# the ROADMAP.md queue 1 item that ports each other meta architecture's eval
_ITEM_OF_ARCH = {"SANOnline": 5, "SAN": 5, "BriVIS": 6, "OpenVIS": 7, "OpenVISOnline": 7}


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, queue 1 item {item})")


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


def make_evaluator(info: catalog.DatasetInfo) -> YTVISEvaluator:
    """The dataset's evaluator (Trainer.build_evaluator, reference
    train_net.py:78-88): the YTVIS COCO-protocol suite."""
    if info.eval_type == "burst":
        raise _not_ported("BURST evaluation", 8)
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
    logits (W, Q, C), masks (Q, W, h, w) and embeds (W, Q, C).  ``params``
    maps the model's parameter names to the tensors to run it with."""

    def fn(params, frames, text_feats):
        out = torch.func.functional_call(model, params, (frames, frames.shape[0], text_feats))
        return {"logits": out["pred_logits"][0], "masks": out["pred_masks"][0],
                "embeds": out["pred_embeds"][0]}

    return fn


def make_postprocess_fn(cfg: Config) -> Callable:
    """f(logits (T, Q, C), masks (Q, T, h, w), embeds (T, Q, C)) -> top-k dict
    over the video's T frames: tracking, the frame-mean scores without the
    no-object column, the top-k (query, class) pairs and their masks."""
    topk = cfg.model.test.topk_per_video

    def fn(logits, masks, embeds):
        # masks stay in raw per-frame query order; tracking alignment is
        # fused into the top-k gather, so only the selected masks move
        indices = track_by_embeds(embeds[None])                # (1, T, Q)
        scores = eval_scores(apply_track_indices(logits[None], indices))[0]
        return inference_video_topk(scores, masks, topk, track_indices=indices[0])

    return fn


def _check_ported(cfg: Config, clip_visual_apply) -> None:
    arch = cfg.model.meta_architecture
    if arch != "SimpleBaselineOnline":
        raise _not_ported(f"the evaluation of {arch!r}", _ITEM_OF_ARCH.get(arch, 8))
    if clip_visual_apply is not None:
        raise _not_ported("the CLIP visual tower and the mask-crop ensemble", 4)


def build_clip_visual(cfg: Config):
    """The frozen CLIP visual tower of the mask-crop ensemble (the JAX
    engine's ``build_clip_visual``)."""
    raise _not_ported("the CLIP visual tower and the mask-crop ensemble", 4)


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
    Under a process group every process calls it; rank 0 returns the metrics
    of all the processes' videos, the others ``{}``."""
    _check_ported(cfg, clip_visual_apply)
    device = resolve_device(device)
    evaluator = make_evaluator(catalog.get(dataset_name))
    dtype = eval_dtype(cfg)
    window = window_size(cfg)
    params = amp_cast(cfg, {n: p.detach().to(device) for n, p in model.named_parameters()})
    text = torch.as_tensor(text_feats).to(device, dtype)
    window_fn = make_window_fn(cfg, model)
    post_fn = make_postprocess_fn(cfg)

    counts = []  # predictions of each video, in this process's order
    with torch.inference_mode():
        for rec, sample in test_videos(cfg, dataset_name, max_videos, dist.rank(),
                                       dist.world()):
            pixels = sample["pixels"]                          # (T, H, W, 3) numpy
            t = pixels.shape[0]
            # the uploads do not wait for the stream: a blocking copy would
            # hold the host behind the previous window's queued work
            parts = [window_fn(params, torch.from_numpy(pixels[i:i + window]).to(
                         device, dtype, non_blocking=True), text)
                     for i in range(0, t, window)]
            logits = torch.cat([p["logits"] for p in parts])            # (T, Q, C)
            masks = torch.cat([p["masks"] for p in parts], dim=1)       # (Q, T, h, w)
            embeds = torch.cat([p["embeds"] for p in parts])            # (T, Q, C)
            del parts
            topk = post_fn(logits, masks, embeds)
            del logits, masks, embeds
            n = len(evaluator.predictions)
            evaluator.process(rec["video_id"], topk, sample["image_size"],
                              sample["orig_size"], pixels.shape[1:3])
            counts.append(len(evaluator.predictions) - n)
    return _finalize(cfg, dataset_name, evaluator, counts)


def _record_order(parts: List[Tuple[List[Dict], List[int]]]) -> List[Dict]:
    """Process p evaluated records p, p + P, ... (``test_videos``): interleave
    the processes' runs of per-video predictions back into record order."""
    runs = []
    for preds, counts in parts:
        runs.append([preds[e - c:e] for c, e in zip(counts, accumulate(counts))])
    return [p for j in range(max(map(len, runs))) for run in runs if j < len(run)
            for p in run[j]]


def _finalize(cfg: Config, dataset_name: str, evaluator: YTVISEvaluator,
              counts: List[int]) -> Dict[str, float]:
    """Gather the predictions on rank 0 (in record order, as one process
    makes them; ``counts``: this process's predictions of each of its
    videos), dump them next to the metrics (ytvis_eval.py:136-175) and score
    them against the dataset's GT json; ``{}`` on the other ranks."""
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
