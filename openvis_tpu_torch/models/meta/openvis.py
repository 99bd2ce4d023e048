"""OpenVIS(Online) meta-architecture.

Port of ``openvis_tpu/models/meta/openvis.py``: a class-agnostic proposal
segmenter (the decoder's ``proposal`` head, ``Linear(hidden, 2)``
objectness, over the frame decoder or, offline, the video decoder) trained
with every label zeroed and ``num_classes == 1`` (``:48-83``; per frame
online, clip-level over the video decoder).  OpenVISOnline's
open-vocabulary classification happens only at inference, where every
predicted mask is mask-cropped and classified by the frozen CLIP tower, and
the per-query frame-averaged logits replace the objectness scores
(``openvis_ov_scores``, ``:86-112``; the eval engine's windowed branch is
``engine.make_openvis_fn``).  Offline OpenVIS evaluates single-shot on its
objectness, as the JAX engine does (``engine._evaluate_single_shot``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from openvis_tpu_torch.config import ModelConfig
from openvis_tpu_torch.losses.criterion import CriterionSettings, set_criterion
from openvis_tpu_torch.models.clip_adapter import clip_crop_classify, frame_average_scores
from openvis_tpu_torch.models.meta.simple_baseline import (
    frame_reshape_outputs,
    frame_reshape_targets,
)
from openvis_tpu_torch.models.segmenter import Segmenter
from openvis_tpu_torch.ops.point_sample import sorted_uniform_points
from openvis_tpu_torch.structures import ClipTargets


class OpenVISModel(nn.Module):
    """The segmenter with the binary proposal head; the text rows are unused
    (the open vocabulary enters through the CLIP crops, outside this
    module)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.segmenter = Segmenter(cfg)

    def forward(self, frames: torch.Tensor, num_frames: int,
                text_feats: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        return self.segmenter(frames, num_frames)


def openvis_loss(
    generator: torch.Generator,
    outputs: Dict[str, Any],
    targets: ClipTargets,
    cfg: ModelConfig,
    num_text_classes: int = 0,
    online: bool = True,
    draw_points=sorted_uniform_points,
) -> Dict[str, torch.Tensor]:
    """Class-agnostic training (openvis.py:71-72): every label is 0 and the
    criterion has one class; ``num_text_classes`` is ignored (the train
    step's loss closure passes every architecture's)."""
    c = cfg.criterion
    s = CriterionSettings(
        num_classes=1,
        class_weight=c.class_weight,
        mask_weight=c.mask_weight,
        dice_weight=c.dice_weight,
        eos_coef=c.no_object_weight,
        num_points=c.train_num_points,
        oversample_ratio=c.oversample_ratio,
        importance_sample_ratio=c.importance_sample_ratio,
        bf16_sampling=c.bf16_masks,
        deep_supervision=c.deep_supervision,
    )
    targets = ClipTargets(labels=torch.zeros_like(targets.labels), masks=targets.masks,
                          valid=targets.valid, frame_valid=targets.frame_valid)
    logits_all = outputs["pred_logits_all"]
    masks_all = outputs["pred_masks_all"]
    if online:
        logits_all, masks_all = frame_reshape_outputs(logits_all, masks_all)
        targets = frame_reshape_targets(targets)
    losses, _ = set_criterion(generator, logits_all, masks_all, targets, s, draw_points)
    return losses


def openvis_ov_scores(
    visual_apply,
    frames_raw: torch.Tensor,   # (T, H, W, 3) in [0, 255]
    mask_logits: torch.Tensor,  # (Q, T, H, W) at the input resolution
    text_feats: torch.Tensor,   # (K, D)
    chunk: int = 5,
    input_resolution: int = 224,
    sampling_ratio: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Open-vocabulary inference scores (openvis.py:110-147): the CLIP crop
    classification in chunks of ``chunk`` frames, the logits averaged over
    each query's valid frames, then one softmax.  Returns (scores (Q, K),
    query_valid (Q,))."""
    t = frames_raw.shape[0]
    masks = torch.sigmoid(mask_logits.transpose(0, 1))                 # (T, Q, H, W)
    logits, valid = [], []
    for i in range(0, t, chunk):
        lg, va = clip_crop_classify(visual_apply, frames_raw[i:i + chunk], masks[i:i + chunk],
                                    text_feats, input_resolution=input_resolution,
                                    sampling_ratio=sampling_ratio)
        logits.append(lg)
        valid.append(va)
    return frame_average_scores(torch.cat(logits), torch.cat(valid), mode="logits_then_softmax")
