"""OV2Seg meta-architecture.

Port of ``openvis_tpu/models/meta/ov2seg.py``: an online per-frame segmenter
whose decoder carries two heads (the ``ov2seg`` head of
``models/transformer_decoder.py``): a zero-shot classifier embedding, whose
logits are ``50 * normalize(e) @ [text; 0].T`` with an all-zero background
row, and a 2-way objectness head.

Training (``ov2seg_loss``), every frame its own sample: the matcher's class
probability is ``[sqrt(sigmoid(cls) * p_obj[0] + 1e-12), p_obj[1]]`` beside
the point mask and dice costs, all layers' problems in one Hungarian call
(kernel K4 on the card); the losses are the weighted CE over K+1 on the
zero-shot logits (``eos_coef``), the 2-way objectness CE with an empty-object
weight of 0.4, and the point-sampled mask and dice losses (kernels K5/K6 on
the card).  Inference (the engine's OV2Seg branch): the EMA tracker (alpha
0.7), the video score ``sqrt(sigmoid(mean cls) * softmax(mean obj)[0])``
(``ov2seg_eval_scores``) and the per-frame gate (``ov2seg_frame_gate``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from openvis_tpu_torch.config import ModelConfig
from openvis_tpu_torch.losses.criterion import (
    _class_targets,
    _loss_masks,
    _sampling_masks,
    match_costs,
    num_masks_normalizer,
    process_draw,
    target_rows_t,
)
from openvis_tpu_torch.models.meta.simple_baseline import (
    _normalize,
    criterion_settings,
    frame_reshape_targets,
)
from openvis_tpu_torch.models.segmenter import Segmenter
from openvis_tpu_torch.ops.hungarian import batched_hungarian
from openvis_tpu_torch.ops.point_sample import sorted_uniform_points
from openvis_tpu_torch.parallel import dist
from openvis_tpu_torch.structures import ClipTargets

NORM_TEMP = 50.0
EMPTY_OBJECT_WEIGHT = 0.4


class OV2SegModel(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.segmenter = Segmenter(cfg)
        self.clip_dim = cfg.transformer_decoder.clip_embed_dim

    def forward(self, frames: torch.Tensor, num_frames: int,
                text_feats: torch.Tensor) -> Dict[str, Any]:
        out = self.segmenter(frames, num_frames)
        packed = out["pred_logits_all"]                     # (L, B, T, Q, D+2)
        emb, obj = packed[..., :self.clip_dim], packed[..., self.clip_dim:]
        text_bg = torch.cat([text_feats, torch.zeros_like(text_feats[:1])])   # (K+1, D)
        # bf16 embeddings against f32 text compute in f32, as JAX promotes
        dt = torch.promote_types(emb.dtype, text_bg.dtype)
        cls = NORM_TEMP * torch.einsum("...d,kd->...k", _normalize(emb).to(dt), text_bg.to(dt))
        out["pred_logits_all"] = cls                        # (L, B, T, Q, K+1)
        out["pred_object_logits_all"] = obj                 # (L, B, T, Q, 2)
        out["pred_logits"] = cls[-1]
        out["pred_object_logits"] = obj[-1]
        return out


def _fused_prob(cls_logits: torch.Tensor, obj_logits: torch.Tensor) -> torch.Tensor:
    """[sqrt(sigmoid(cls) * p_obj0 + 1e-12), p_obj1] (ov2seg.py:211-213)."""
    p_obj = torch.softmax(obj_logits, dim=-1)
    cls_p = torch.sqrt(torch.sigmoid(cls_logits[..., :-1]) * p_obj[..., :1] + 1e-12)
    return torch.cat([cls_p, p_obj[..., 1:]], dim=-1)


def _weighted_nll(logits: torch.Tensor, target: torch.Tensor, weight: torch.Tensor):
    """(sum of weight * NLL, sum of weight over the global batch)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, target[..., None])[..., 0]
    wsum = weight.sum()
    if dist.initialized():
        wsum = dist.all_reduce_sum(wsum)
    return (weight * nll).sum(), wsum


def ov2seg_loss(
    generator: torch.Generator,
    outputs: Dict[str, Any],
    targets: ClipTargets,
    cfg: ModelConfig,
    num_text_classes: int,
    online: bool = True,
    draw_points=sorted_uniform_points,
) -> Dict[str, torch.Tensor]:
    """Per-frame matching and losses over every decoder layer; returns
    ``loss_ce``, ``loss_object_ce``, ``loss_mask``, ``loss_dice`` of shape (L,)
    and the scalar ``total``."""
    s = criterion_settings(cfg, num_text_classes)
    la = outputs["pred_logits_all"]
    oa = outputs["pred_object_logits_all"]
    ma = outputs["pred_masks_all"]
    l, b, t, q, k1 = la.shape
    h, w = ma.shape[-2:]
    la = la.reshape(l, b * t, q, k1).float()
    oa = oa.reshape(l, b * t, q, 2).float()
    ma = ma.transpose(2, 3).reshape(l, b * t, q, 1, h, w)
    tg = frame_reshape_targets(targets)
    n = tg.labels.shape[1]
    dev = ma.device
    draw = process_draw(generator, draw_points, dev)
    nm = num_masks_normalizer(tg)
    tgt_t = target_rows_t(tg)
    masks = [_sampling_masks(ma[i], s) for i in range(l)]
    labels = tg.labels.clamp(0, k1 - 1)[:, None, :].expand(b * t, q, n)
    costs = []
    with torch.no_grad():
        for i in range(l):
            cost = match_costs(draw, None, masks[i], tg, s, tgt_t)           # (BT, N, Q)
            cost_class = -torch.gather(_fused_prob(la[i], oa[i]), 2, labels)
            costs.append(cost + torch.where(tg.valid[:, :, None],
                                            s.class_weight * cost_class.transpose(1, 2),
                                            torch.zeros((), device=dev)))
    # all layers' problems in one solve
    assignments = batched_hungarian(torch.cat(costs)).view(l, b * t, n)
    lcs, los, lms, lds = [], [], [], []
    for i in range(l):
        tc, wce = _class_targets(la[i], assignments[i], tg, s)   # invalid slots dropped
        ce, ce_w = _weighted_nll(la[i], tc, wce)
        t_obj = (tc == num_text_classes).to(torch.int64)
        wobj = torch.where(t_obj == 1, EMPTY_OBJECT_WEIGHT, 1.0)
        obj, obj_w = _weighted_nll(oa[i], t_obj, wobj)
        lm, ld = _loss_masks(draw, masks[i], assignments[i], tg, nm, s, tgt_t)
        lcs.append(ce / ce_w)
        los.append(obj / obj_w)
        lms.append(lm)
        lds.append(ld)
    losses = {"loss_ce": torch.stack(lcs), "loss_object_ce": torch.stack(los),
              "loss_mask": torch.stack(lms), "loss_dice": torch.stack(lds)}
    losses["total"] = (s.class_weight * (losses["loss_ce"].sum() + losses["loss_object_ce"].sum())
                       + s.mask_weight * losses["loss_mask"].sum()
                       + s.dice_weight * losses["loss_dice"].sum())
    return losses


def ov2seg_eval_scores(cls_logits: torch.Tensor, obj_logits: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Aligned (T, Q, K+1) and (T, Q, 2) logits -> (video scores (Q, K),
    per-frame scores (T, Q, K)): ``sqrt(sigmoid(cls) * p_obj[0] + 1e-12)`` of
    the frame-mean and of the per-frame logits (ov2seg.py:853-856, 926-940)."""
    mean_cls = cls_logits.mean(0)[..., :-1]
    mean_obj = torch.softmax(obj_logits.mean(0), dim=-1)[..., :1]
    video = torch.sqrt(torch.sigmoid(mean_cls) * mean_obj + 1e-12)
    pf_obj = torch.softmax(obj_logits, dim=-1)[..., :1]
    per_frame = torch.sqrt(torch.sigmoid(cls_logits[..., :-1]) * pf_obj + 1e-12)
    return video, per_frame


def ov2seg_frame_gate(mask_logits: torch.Tensor, video_scores: torch.Tensor,
                      per_frame_scores: torch.Tensor) -> torch.Tensor:
    """(topk, T, h, w) mask logits with the frames whose score (T, topk) is
    under 10 % of the video score (topk,) set to -1 (ov2seg.py:867-868)."""
    gate = per_frame_scores.T < (video_scores[:, None] * 0.1)              # (topk, T)
    return torch.where(gate[:, :, None, None], torch.full((), -1.0, dtype=mask_logits.dtype,
                                                          device=mask_logits.device),
                       mask_logits)
