"""MasQCLIP meta-architecture.

Port of ``openvis_tpu/models/meta/masqclip.py:34-145`` (the reference's
``masqclip.py:24-236``): the segmenter proposes masks, and the MasQ tower
(``models/clip_masq.py``, under ``clip_adapter``) classifies each proposal
with its mask class token.

* ``MasQCLIPModel``: the segmenter's outputs are detached (its forward runs
  without a graph), the frames un-normalised and resized bicubic to the
  tower's S, each frame's masks bilinear to (S, S); ``clip_logits`` are
  ``100 * feats @ text.T`` averaged over the T frames (all of them: the
  engine's padded frames too, as in JAX), ``base_logits`` the segmenter's
  last-layer logits.  The LAST text row is the background class.
* ``label_assign``: one y-sorted point set a clip; each query's point dice
  against every valid target (``inf`` for the invalid ones); the argmin,
  valid when its dice is below 0.4.  The predicted masks (at most
  ``KERNEL_MAX_HW`` pixels) are sampled by K5 on the card, under the f32
  policy; the full-resolution targets by the plain gather, as the
  criterion's targets.
* ``masqclip_loss``: the CE over the text rows with the pseudo-labels, the
  unassigned queries and those assigned the last row's class taking the last
  row with weight ``no_object_weight``; ``loss_mask``/``loss_dice`` zero.
* ``masqclip_eval_scores``: ``exp(log_softmax(base)[..., :1] +
  log_softmax(clip))[..., :-1]`` in f32, a frame head's base logits averaged
  over T.

JAX's engine and CLI pass the dataset's K class rows as they are, so the last
real class is the background row and is never scored (ROADMAP.md §3).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from openvis_tpu_torch.config import ModelConfig
from openvis_tpu_torch.losses.criterion import process_draw, target_rows_t
from openvis_tpu_torch.models.clip.model import vit_shape
from openvis_tpu_torch.models.clip_masq import MasQCLIPVisual, preprocess_frames
from openvis_tpu_torch.models.meta.ov2seg import _weighted_nll
from openvis_tpu_torch.models.segmenter import Segmenter
from openvis_tpu_torch.ops.point_sample import (
    sample_maps_shared,
    sample_maps_shared_t,
    sorted_uniform_points,
)
from openvis_tpu_torch.structures import ClipTargets
from openvis_tpu_torch.utils.image import resize_bilinear_torch_hw

LOGIT_SCALE = 100.0
DICE_THRESHOLD = 0.40


class MasQCLIPModel(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.segmenter = Segmenter(cfg)
        s = vit_shape(cfg.clip_adapter.clip_model_name, "MasQCLIP's tower")
        self.clip_adapter = MasQCLIPVisual(s["vision_patch"], s["vision_width"],
                                           s["vision_layers"], s["vision_heads"],
                                           s["embed_dim"], s["image_size"])
        self.image_size = s["image_size"]
        self.pixel_mean = tuple(cfg.pixel_mean)
        self.pixel_std = tuple(cfg.pixel_std)

    def forward(self, frames: torch.Tensor, num_frames: int,
                text_feats: torch.Tensor) -> Dict[str, Any]:
        """frames (B*T, H, W, 3) dataset-normalised; text_feats (K, D), the
        last row the background."""
        t = num_frames
        with torch.no_grad():
            out = self.segmenter(frames, t)
        masks = out["pred_masks"]                                        # (B, Q, T, h, w)
        b, q = masks.shape[:2]
        s = self.image_size
        mean = torch.tensor(self.pixel_mean, dtype=frames.dtype, device=frames.device)
        std = torch.tensor(self.pixel_std, dtype=frames.dtype, device=frames.device)
        clip_in = preprocess_frames(frames * std + mean, s)
        m = masks.transpose(1, 2).reshape(b * t, q, *masks.shape[-2:])
        m = resize_bilinear_torch_hw(m, (s, s))
        feats = self.clip_adapter(clip_in, m)                             # (B*T, Q, D)
        # bf16 features against f32 text compute in f32, as JAX promotes
        dt = torch.promote_types(feats.dtype, text_feats.dtype)
        logits = LOGIT_SCALE * torch.einsum("nqd,kd->nqk", feats.to(dt), text_feats.to(dt))
        out["clip_logits"] = logits.reshape(b, t, q, -1).mean(dim=1)     # (B, Q, K)
        out["base_logits"] = out["pred_logits_all"][-1]
        return out


def label_assign(generator: torch.Generator, pred_masks: torch.Tensor, targets: ClipTargets,
                 num_points: int = 12544, dice_threshold: float = DICE_THRESHOLD,
                 draw_points=sorted_uniform_points
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """pred_masks (B, Q, T, H, W) logits -> (labels (B, Q), valid (B, Q),
    gt_idx (B, Q)): each query's least point-dice target among the valid
    ones, valid when the dice is below ``dice_threshold``."""
    b, qn, t, h, w = pred_masks.shape
    n = targets.labels.shape[1]
    th, tw = targets.masks.shape[-2:]
    coords = process_draw(generator, draw_points, pred_masks.device)(b, num_points)
    out_pts = sample_maps_shared(pred_masks.reshape(b, qn * t, h, w), coords, f32_policy=True)
    tgt_pts = sample_maps_shared_t(target_rows_t(targets), th, tw, coords, f32_policy=True)
    out_pts = out_pts.float().reshape(b, qn, t * num_points)
    tgt_pts = tgt_pts.float().reshape(b, n, t * num_points)
    sig = torch.sigmoid(out_pts)
    numer = 2.0 * torch.einsum("bqp,bnp->bqn", sig, tgt_pts)
    denom = sig.sum(-1)[:, :, None] + tgt_pts.sum(-1)[:, None, :]
    dice = 1.0 - (numer + 1.0) / (denom + 1.0)                           # (B, Q, N)
    dice = torch.where(targets.valid[:, None, :], dice, float("inf"))
    gt_idx = dice.argmin(dim=-1)
    valid = torch.gather(dice, 2, gt_idx[..., None])[..., 0] < dice_threshold
    labels = torch.gather(targets.labels, 1, gt_idx)
    return labels, valid, gt_idx


def masqclip_loss(
    generator: torch.Generator,
    outputs: Dict[str, Any],
    targets: ClipTargets,
    cfg: ModelConfig,
    num_text_classes: int = 0,
    online: bool = False,
    draw_points=sorted_uniform_points,
) -> Dict[str, torch.Tensor]:
    """CE over the text rows against the pseudo-labels of ``label_assign``;
    ``num_text_classes`` and ``online`` are ignored (the train step's loss
    closure passes every architecture's).  The weight sum is the global
    batch's under a process group."""
    with torch.no_grad():
        labels, valid, _ = label_assign(generator, outputs["pred_masks"], targets,
                                        cfg.criterion.train_num_points,
                                        draw_points=draw_points)
    logits = outputs["clip_logits"]                                      # (B, Q, K)
    k = logits.shape[-1] - 1
    tc = torch.where(valid, labels, k)                                   # background: last row
    w = torch.where(tc == k, cfg.criterion.no_object_weight, 1.0)
    nll, wsum = _weighted_nll(logits, tc, w)
    loss = nll / wsum
    zero = torch.zeros(1, device=loss.device)
    return {"loss_ce": loss[None], "total": loss, "loss_mask": zero, "loss_dice": zero}


def masqclip_eval_scores(outputs: Dict[str, Any]) -> torch.Tensor:
    """(B, Q, K-1) fused scores (JAX ``masqclip.py:138-145``), in f32 (the
    port's engine scores in f32; JAX in the outputs' dtype)."""
    base = outputs["base_logits"].float()
    if base.dim() == 4:  # (B, T, Q, C) frame head: the mean over T
        base = base.mean(dim=1)
    obj = torch.log_softmax(base, dim=-1)[..., :1]
    clip = torch.log_softmax(outputs["clip_logits"].float(), dim=-1)
    return torch.exp(obj + clip)[..., :-1]
