"""VideoMaskFormer (offline) and MinVIS (online) closed-vocabulary
meta-architectures.

Port of ``openvis_tpu/models/meta/video_maskformer.py`` (the reference's
``video_maskformer.py:23-298`` and ``minvis.py:76-368``): the plain
Mask2Former segmenter with the ``class`` head, a Linear to
``num_classes + 1``, over the video decoder (VideoMaskFormer, ``video``) or
the frame decoder (MinVIS, ``frame``: every frame its own sample in training,
the embedding tracker at inference).  The base classes that every
open-vocabulary variant extends.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from openvis_tpu_torch.config import ModelConfig
from openvis_tpu_torch.losses.criterion import set_criterion
from openvis_tpu_torch.models.meta.simple_baseline import (
    criterion_settings,
    frame_reshape_outputs,
    frame_reshape_targets,
)
from openvis_tpu_torch.models.segmenter import Segmenter
from openvis_tpu_torch.ops.point_sample import sorted_uniform_points
from openvis_tpu_torch.structures import ClipTargets


class VideoMaskFormerModel(nn.Module):
    """The segmenter alone; ``text_feats`` is accepted and ignored, so every
    architecture shares one call signature."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.segmenter = Segmenter(cfg)

    def forward(self, frames: torch.Tensor, num_frames: int,
                text_feats: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        return self.segmenter(frames, num_frames)


def video_maskformer_loss(
    generator: torch.Generator,
    outputs: Dict[str, Any],
    targets: ClipTargets,
    cfg: ModelConfig,
    num_text_classes: int = 0,
    online: bool = False,
    draw_points=sorted_uniform_points,
) -> Dict[str, torch.Tensor]:
    """The set criterion over ``cfg.num_classes`` classes, clip-level (the
    video decoder's (L, B, Q, C+1) logits) or, ``online`` (MinVIS), per
    frame; ``num_text_classes`` is ignored (the train step's loss closure
    passes every architecture's)."""
    s = criterion_settings(cfg, cfg.num_classes)
    logits_all = outputs["pred_logits_all"]
    masks_all = outputs["pred_masks_all"]
    if online:
        logits_all, masks_all = frame_reshape_outputs(logits_all, masks_all)
        targets = frame_reshape_targets(targets)
    losses, _ = set_criterion(generator, logits_all, masks_all, targets, s, draw_points)
    return losses
