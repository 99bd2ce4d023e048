"""BriVIS meta-architecture (stage 2 on top of SANOnline).

Port of ``openvis_tpu/models/meta/brivis.py``: SAN's per-frame stack (the
side adapter's CLIP front, the segmenter, the frozen image logits' CLIP post
encode) runs frozen under ``torch.no_grad()``, so it keeps no activations and
its encoder launches no backward kernel; its per-frame queries are
MinVIS-aligned (``track_by_embeds``) and a temporal resampler
(``models/resampler.py``) refines the aligned tracks over T.  The resampler's
L+1 layers' attention biases go through ONE batched CLIP post-encode in
training (``supervise_aux_logits``); evaluation reads the last layer only,
and skips the frozen image outputs, which only the loss reads.

The loss (``brivis_loss``) is the set criterion on "tall" clips, the T frames
stacked on the height axis as one frame: the resampler layers' logits are
(first + last frame) / 2, the frozen image logits the mean over T and come
first as an extra layer; one assignment, from the image outputs or from the
resampler's last layer, is reused by every layer; then the Brownian-bridge
and head-tail terms (``losses/brownian.py``) on ``brownian_proj`` of the
resampler's last-layer embeds.

The windowed methods (``frame_stack``, ``resample``, ``raw_temporal``,
``raw_frame``, ``raw_finalize``, ``predict_window``) let the engine run the
frame stack and the heads in windows and the resampler over the whole video.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from openvis_tpu_torch.config import ModelConfig
from openvis_tpu_torch.losses.brownian import brownian_bridge_loss
from openvis_tpu_torch.losses.criterion import match, process_draw, set_criterion
from openvis_tpu_torch.models.meta.simple_baseline import criterion_settings
from openvis_tpu_torch.models.resampler import build_resampler
from openvis_tpu_torch.models.segmenter import Segmenter
from openvis_tpu_torch.models.side_adapter import SideAdapter
from openvis_tpu_torch.models.tracking import apply_track_indices, track_by_embeds
from openvis_tpu_torch.ops.point_sample import sorted_uniform_points
from openvis_tpu_torch.structures import ClipTargets


class BriVISModel(nn.Module):
    """``clip_adapter`` and ``segmenter`` (SAN's, frozen), ``resampler`` and
    ``brownian_proj``, named as the JAX package's subtrees."""

    def __init__(self, cfg: ModelConfig, supervise_aux_logits: bool = True):
        super().__init__()
        self.supervise_aux_logits = supervise_aux_logits
        self.pixel_mean, self.pixel_std = tuple(cfg.pixel_mean), tuple(cfg.pixel_std)
        ca, td, rs = cfg.clip_adapter, cfg.transformer_decoder, cfg.resampler
        self.raw = rs.name == "raw"
        self.clip_adapter = SideAdapter(ca.clip_model_name, cfg.pixel_decoder.conv_dim,
                                        ca.broken_id, ca.merge_ids, td.num_queries)
        self.segmenter = Segmenter(cfg)
        self.resampler = build_resampler(
            rs.name, hidden_dim=td.hidden_dim, feed_dim=td.dim_feedforward, nheads=td.nheads,
            nlayers=rs.num_layers, conv_kernels=tuple(rs.conv_kernels), nqueries=td.num_queries)
        self.brownian_proj = nn.Linear(td.hidden_dim, td.hidden_dim)

    @torch.no_grad()
    def _frame_stack(self, frames: torch.Tensor, num_frames: int
                     ) -> Tuple[Dict[str, Any], torch.Tensor, Tuple[int, int]]:
        """The frozen stage-1 stack: the CLIP front and the segmenter."""
        mean = torch.tensor(self.pixel_mean, dtype=frames.dtype, device=frames.device)
        std = torch.tensor(self.pixel_std, dtype=frames.dtype, device=frames.device)
        mg_feats, bk_tokens, grid = self.clip_adapter.front_encode(frames * std + mean)
        out = self.segmenter(frames, num_frames, extra_features=mg_feats[::-1])
        return out, bk_tokens, grid

    @torch.no_grad()
    def _image_outputs(self, image_out, bk_tokens, grid, text_full, indices, b, t):
        """The frozen per-frame CLIP logits (B, T, Q, K+1) and masks (B, Q, T,
        H, W), in track order."""
        biases = image_out["class_attn_biases"]                  # (B, T, nH, Q, h, w)
        nh, q = biases.shape[2:4]
        feats = self.clip_adapter.post_encode(
            bk_tokens, biases.reshape(b * t, nh, q, *biases.shape[-2:]), grid)
        logits = self.clip_adapter.sim_logits(text_full, feats).reshape(b, t, q, -1)
        masks = apply_track_indices(image_out["pred_masks"].transpose(1, 2), indices)
        return apply_track_indices(logits, indices), masks.transpose(1, 2)

    def forward(
        self,
        frames: torch.Tensor,      # (B*T, H, W, 3) normalized NHWC
        num_frames: int,
        text_feats: torch.Tensor,  # (K, D) normalized rows
    ) -> Dict[str, Any]:
        t = num_frames
        bt = frames.shape[0]
        b = bt // t
        adapter = self.clip_adapter
        image_out, bk_tokens, grid = self._frame_stack(frames, t)
        with torch.no_grad():
            text_full = adapter.text_with_bg(text_feats)
            pred_embeds = image_out["pred_embeds"]                # (B, T, Q, C)
            indices = track_by_embeds(pred_embeds)                # (B, T, Q)
            frame_embeds = apply_track_indices(pred_embeds, indices)
        feats = [image_out["mask_feats"], image_out["attn_feats"]]
        if self.raw:
            feats += [image_out["ms_feats"], image_out["ms_pos"]]
        res = self.resampler(frame_embeds, *feats)

        ab = res["attn_biases_all"]                               # (L+1, B*T, nH, Q, h, w)
        l1, q = ab.shape[0], ab.shape[3]
        if self.supervise_aux_logits:
            toks = bk_tokens[None].expand(l1, *bk_tokens.shape).reshape(
                l1 * bt, *bk_tokens.shape[1:])
            img = adapter.post_encode(toks, ab.reshape(l1 * bt, *ab.shape[2:]), grid)
            logits_all = adapter.sim_logits(text_full, img).reshape(l1, b, t, q, -1)
        else:
            img = adapter.post_encode(bk_tokens, ab[-1], grid)
            logits = adapter.sim_logits(text_full, img).reshape(b, t, q, -1)
            logits_all = logits[None].expand(l1, *logits.shape)
        out = {
            "pred_logits_all": logits_all,                        # (L+1, B, T, Q, K+1)
            "pred_masks_all": res["pred_masks_all"],              # (L+1, B, Q, T, H, W)
            "pred_logits": logits_all[-1],
            "pred_masks": res["pred_masks_all"][-1],
            "pred_embeds": res["pred_embeds"],
            "brownian_embeds": self.brownian_proj(res["pred_embeds"]),
        }
        if self.supervise_aux_logits:
            out["image_logits"], out["image_masks"] = self._image_outputs(
                image_out, bk_tokens, grid, text_full, indices, b, t)
        return out

    # ---- windowed whole-video inference: the frame stack per window, the
    # resampler's temporal work once over the whole video, the heads and the
    # biased CLIP post-encode per window ----

    def frame_stack(self, frames: torch.Tensor, num_frames: int) -> Dict[str, Any]:
        """One window of the frozen stack -> what the resampler and the heads
        read: ``pred_embeds`` (B, T, Q, C), ``mask_feats`` (B*T, H, W, C),
        ``attn_feats`` (B*T, nH, h, w, C), ``bk_tokens`` (B*T, 1+L, W); the
        raw resampler's ``ms_feats`` (three (B*T, hw_l, C)) and ``ms_pos``
        (three (1, hw_l, C)) too."""
        image_out, bk_tokens, _ = self._frame_stack(frames, num_frames)
        keys = ("pred_embeds", "mask_feats", "attn_feats") + (
            ("ms_feats", "ms_pos") if self.raw else ())
        return {"bk_tokens": bk_tokens, **{k: image_out[k] for k in keys}}

    def resample(self, aligned_embeds: torch.Tensor) -> torch.Tensor:
        """(B, T, Q, C) aligned -> the last layer's per-frame embeds (B, T, Q, C)."""
        return self.resampler.final_embeds(aligned_embeds)

    def raw_temporal(self, x: torch.Tensor, i: int) -> torch.Tensor:
        return self.resampler.temporal_half(x, i)

    def raw_frame(self, pf, ms_feat, ms_pos, i: int) -> torch.Tensor:
        return self.resampler.frame_half(pf, ms_feat, ms_pos, i)

    def raw_finalize(self, pf: torch.Tensor) -> torch.Tensor:
        return self.resampler.finalize_embeds(pf)

    def predict_window(
        self,
        embeds: torch.Tensor,      # (N, Q, C) last-layer per-frame embeds
        mask_feats: torch.Tensor,  # (N, H, W, C)
        attn_feats: torch.Tensor,  # (N, nH, h, w, C)
        bk_tokens: torch.Tensor,   # (N, 1+L, W)
        text_feats: torch.Tensor,  # (K, D)
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The last layer's heads and biased CLIP for a window -> (masks (N,
        Q, H, W), logits (N, Q, K+1))."""
        masks, biases = self.resampler.predict_frames(embeds, mask_feats, attn_feats)
        g = int(round((bk_tokens.shape[1] - 1) ** 0.5))             # square CLIP grid
        feats = self.clip_adapter.post_encode(bk_tokens, biases, (g, g))
        text_full = self.clip_adapter.text_with_bg(text_feats)
        return masks, self.clip_adapter.sim_logits(text_full, feats)


def _tall(masks: torch.Tensor) -> torch.Tensor:
    """(..., N, T, H, W) -> (..., N, 1, T*H, W)."""
    *lead, t, h, w = masks.shape
    return masks.reshape(*lead, 1, t * h, w)


def brivis_loss(generator: torch.Generator, outputs: Dict[str, Any], targets: ClipTargets,
                cfg: ModelConfig, num_text_classes: int, online: bool = True,
                draw_points=sorted_uniform_points,
                image_matcher: bool = True) -> Dict[str, torch.Tensor]:
    """JAX ``brivis.py:251-313``; ``image_matcher``: the assignment from the
    frozen image outputs (the first half of training) or from the
    resampler's last layer.  ``online`` is unused (the clips are tall)."""
    s = criterion_settings(cfg, num_text_classes)
    la = outputs["pred_logits_all"]
    layer_logits = (la[:, :, 0] + la[:, :, -1]) / 2.0            # (L+1, B, Q, K+1)
    layer_masks = _tall(outputs["pred_masks_all"])                # (L+1, B, Q, 1, T*H, W)
    img_logits = outputs["image_logits"].mean(dim=1)              # (B, Q, K+1)
    img_masks = _tall(outputs["image_masks"])
    # the image layer first, so the last entry stays the resampler's last
    # layer.  The layers stay a list: JAX's concatenation promotes a bf16
    # stack to f32, which the sampler's f32 policy reads exactly as it is,
    # and the frozen image layer, outside the resampler's graph, gets no
    # gradient
    logits_all = torch.cat([img_logits[None], layer_logits])
    masks_all = [img_masks, *layer_masks]
    tall = ClipTargets(labels=targets.labels, masks=_tall(targets.masks), valid=targets.valid,
                       frame_valid=torch.ones((*targets.valid.shape, 1), dtype=torch.bool,
                                              device=targets.valid.device))
    draw = process_draw(generator, draw_points, layer_masks.device)
    if image_matcher:
        assignment = match(draw, img_logits, img_masks, tall, s)
    else:
        assignment = match(draw, layer_logits[-1], layer_masks[-1], tall, s)
    losses, _ = set_criterion(generator, logits_all, masks_all, tall, s, draw_points,
                              fixed_assignment=assignment)
    bc, htm = brownian_bridge_loss(generator, outputs["brownian_embeds"],
                                   neg_log=cfg.criterion.brownian_neg_log)
    losses["bc_loss"], losses["htm_loss"] = bc, htm
    losses["total"] = losses["total"] + bc + htm
    return losses
