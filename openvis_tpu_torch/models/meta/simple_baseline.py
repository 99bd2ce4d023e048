"""SimpleBaseline(Online) meta-architecture.

Port of ``openvis_tpu/models/meta/simple_baseline.py``: a segmenter whose
decoder head projects queries into CLIP text space; classification logits are
``100 * normalize(embeds) @ text.T`` with a learned, normalized no-object row
appended (``:38-69``), over the frame decoder (SimpleBaselineOnline) or the
video decoder (SimpleBaseline: one embedding a query and clip); the training
loss, per frame online (every frame its own sample) or clip-level offline
(``:72-132``), and the eval scores (``:135-145``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from openvis_tpu_torch.config import ModelConfig
from openvis_tpu_torch.losses.criterion import CriterionSettings, set_criterion
from openvis_tpu_torch.models.segmenter import Segmenter
from openvis_tpu_torch.ops.point_sample import sorted_uniform_points
from openvis_tpu_torch.structures import ClipTargets


def _normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


class SimpleBaselineModel(nn.Module):
    def __init__(self, cfg: ModelConfig, temperature: float = 100.0):
        super().__init__()
        self.temperature = temperature
        self.segmenter = Segmenter(cfg)
        self.non_object_embedding = nn.Parameter(
            torch.zeros(1, cfg.transformer_decoder.clip_embed_dim)
        )

    def forward(
        self,
        frames: torch.Tensor,      # (B*T, H, W, 3) normalized NHWC
        num_frames: int,
        text_feats: torch.Tensor,  # (K, D) normalized rows
    ) -> Dict[str, Any]:
        out = self.segmenter(frames, num_frames)
        text_full = torch.cat(
            [text_feats, _normalize(self.non_object_embedding)], dim=0
        )                                                    # (K+1, D)
        embeds_all = out["pred_logits_all"]           # (L, B, T, Q, D); video: (L, B, Q, D)
        # bf16 embeddings against f32 text (the AMP train step) compute in
        # f32, as JAX promotes
        dt = torch.promote_types(embeds_all.dtype, text_full.dtype)
        logits_all = self.temperature * torch.einsum(
            "...d,kd->...k", _normalize(embeds_all).to(dt), text_full.to(dt)
        )
        out["pred_logits_all"] = logits_all
        out["pred_logits"] = logits_all[-1]
        return out


def eval_scores(pred_logits: torch.Tensor, online: bool = True) -> torch.Tensor:
    """-> (B, Q, K) softmax probabilities without the no-object column: online,
    of the (B, T, Q, K+1) track-aligned logits averaged over the frames;
    offline, of the video decoder's (B, Q, K+1) logits."""
    if online:
        pred_logits = pred_logits.mean(dim=1)
    return torch.softmax(pred_logits, dim=-1)[..., :-1]


def frame_reshape_outputs(
    pred_logits_all: torch.Tensor,  # (L, B, T, Q, C)
    pred_masks_all: torch.Tensor,   # (L, B, Q, T, H, W)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MinVIS frame_decoder_loss_reshape: each frame becomes a batch item
    with a single-frame mask axis."""
    l, b, t, q, c = pred_logits_all.shape
    h, w = pred_masks_all.shape[-2:]
    logits = pred_logits_all.reshape(l, b * t, q, c)
    masks = pred_masks_all.transpose(2, 3).reshape(l, b * t, q, 1, h, w)
    return logits, masks


def frame_reshape_targets(targets: ClipTargets) -> ClipTargets:
    """(B, N, ...) per-clip targets -> (B*T, N, ...) per-frame copies."""
    b, n, t = targets.frame_valid.shape
    h, w = targets.masks.shape[-2:]
    labels = targets.labels[:, None].expand(b, t, n).reshape(b * t, n)
    valid = targets.valid[:, None].expand(b, t, n).reshape(b * t, n)
    masks = targets.masks.transpose(1, 2).reshape(b * t, n, 1, h, w)
    frame_valid = targets.valid[:, None, :, None].expand(b, t, n, 1).reshape(b * t, n, 1)
    return ClipTargets(labels=labels, masks=masks, valid=valid, frame_valid=frame_valid)


def criterion_settings(cfg: ModelConfig, num_text_classes: int) -> CriterionSettings:
    c = cfg.criterion
    return CriterionSettings(
        num_classes=num_text_classes,
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


def simple_baseline_loss(
    generator: torch.Generator,
    outputs: Dict[str, Any],
    targets: ClipTargets,
    cfg: ModelConfig,
    num_text_classes: int,
    online: bool = True,
    draw_points=sorted_uniform_points,
) -> Dict[str, torch.Tensor]:
    """The set criterion over all decoder layers; online: per frame;
    offline: the video decoder's clip-level (L, B, Q, K+1) logits."""
    s = criterion_settings(cfg, num_text_classes)
    logits_all = outputs["pred_logits_all"]
    masks_all = outputs["pred_masks_all"]
    if online:
        logits_all, masks_all = frame_reshape_outputs(logits_all, masks_all)
        targets = frame_reshape_targets(targets)
    losses, _ = set_criterion(generator, logits_all, masks_all, targets, s, draw_points)
    return losses
