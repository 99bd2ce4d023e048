"""Model assembly and the windowed video eval entry point.

Port of ``openvis_tpu/train.py::build_model`` (``:25``) and ``make_eval_fn``
(``:177-203``) for SimpleBaseline(Online).  The train step is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from openvis_tpu.config import Config
from openvis_tpu_torch.models.meta.simple_baseline import (
    SimpleBaselineModel,
    eval_scores,
)
from openvis_tpu_torch.models.postprocess import inference_video_topk
from openvis_tpu_torch.models.tracking import apply_track_indices, track_by_embeds


def build_model(cfg: Config) -> SimpleBaselineModel:
    """The module for ``cfg`` with zero-filled parameters: load them with
    ``convert.load_flax_params`` or draw them with ``convert.init_params``."""
    name = cfg.model.meta_architecture
    if name in ("SimpleBaseline", "SimpleBaselineOnline"):
        return SimpleBaselineModel(cfg.model)
    raise NotImplementedError(
        f"meta architecture {name!r} is not ported yet (ROADMAP.md, queue 1)"
    )


def make_eval_fn(cfg: Config, model: SimpleBaselineModel) -> Callable:
    """Returns f(frames (T, H, W, 3), text_feats (K, D)) -> top-k dict for one
    video window (B = 1), on the device of the model and inputs.  Online
    (frame-decoder) eval: ``build_model`` refuses the video decoder."""
    topk = cfg.model.test.topk_per_video

    @torch.inference_mode()
    def eval_fn(frames: torch.Tensor, text_feats: torch.Tensor) -> Dict[str, torch.Tensor]:
        t = frames.shape[0]
        out = model(frames, t, text_feats)
        # align logits only; masks are aligned inside the top-k gather
        indices = track_by_embeds(out["pred_embeds"])
        logits = apply_track_indices(out["pred_logits"], indices)
        scores = eval_scores(logits)[0]                        # (Q, K)
        return inference_video_topk(scores, out["pred_masks"][0], topk,
                                    track_indices=indices[0])

    return eval_fn
