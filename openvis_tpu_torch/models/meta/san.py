"""SAN(Online) meta-architecture.

Port of ``openvis_tpu/models/meta/san.py``: the frozen CLIP runs once a
frame.  Its blocks ``0..broken_idx-1`` give the taps that the pixel decoder
adds to its levels; the side-adapter decoder predicts per-query attention-bias
maps; CLIP's blocks ``broken_idx..`` run again with sos tokens steered by
those biases, and the sos features against the text rows (with a learned
background row) are the classification logits, for every decoder layer in
training (``san.py:230-237``).

The raw (0-255) frames CLIP needs are rebuilt from the normalised input in
its own dtype, as the JAX package does (the reference keeps a second,
unnormalised image list, ``san.py:212-219``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from openvis_tpu_torch.config import ModelConfig
from openvis_tpu_torch.models.meta.simple_baseline import simple_baseline_loss
from openvis_tpu_torch.models.segmenter import Segmenter
from openvis_tpu_torch.models.side_adapter import SideAdapter
from openvis_tpu_torch.ops.point_sample import sorted_uniform_points
from openvis_tpu_torch.structures import ClipTargets


class SANModel(nn.Module):
    """``clip_adapter`` (the side adapter) and ``segmenter``, named as the JAX
    package's subtrees.  ``supervise_aux_logits``: CLIP logits for every
    decoder layer (training); without it only the last layer's go through the
    post-encode, broadcast over the layers (evaluation)."""

    def __init__(self, cfg: ModelConfig, supervise_aux_logits: bool = True):
        super().__init__()
        self.supervise_aux_logits = supervise_aux_logits
        self.pixel_mean, self.pixel_std = tuple(cfg.pixel_mean), tuple(cfg.pixel_std)
        ca = cfg.clip_adapter
        self.clip_adapter = SideAdapter(ca.clip_model_name, cfg.pixel_decoder.conv_dim,
                                        ca.broken_id, ca.merge_ids,
                                        cfg.transformer_decoder.num_queries)
        self.segmenter = Segmenter(cfg)

    def forward(
        self,
        frames: torch.Tensor,      # (B*T, H, W, 3) normalized NHWC
        num_frames: int,
        text_feats: torch.Tensor,  # (K, D) normalized rows
    ) -> Dict[str, Any]:
        adapter = self.clip_adapter
        mean = torch.tensor(self.pixel_mean, dtype=frames.dtype, device=frames.device)
        std = torch.tensor(self.pixel_std, dtype=frames.dtype, device=frames.device)
        mg_feats, bk_tokens, grid = adapter.front_encode(frames * std + mean)
        # the pixel decoder takes the taps top-down (res5, res4, res3)
        out = self.segmenter(frames, num_frames, extra_features=mg_feats[::-1])
        text_full = adapter.text_with_bg(text_feats)                    # (K+1, D)
        biases_all = out["class_attn_biases_all"]            # (L, B, T, nH, Q, h, w)
        l, b, t, nh, q, hh, ww = biases_all.shape
        if self.supervise_aux_logits:
            # every layer through the post-encode as one batch of L*B*T
            toks = bk_tokens[None].expand(l, *bk_tokens.shape).reshape(
                l * b * t, *bk_tokens.shape[1:])
            feats = adapter.post_encode(toks, biases_all.reshape(l * b * t, nh, q, hh, ww),
                                        grid)
            logits_all = adapter.sim_logits(text_full, feats).reshape(l, b, t, q, -1)
        else:
            feats = adapter.post_encode(bk_tokens, biases_all[-1].reshape(b * t, nh, q, hh, ww),
                                        grid)
            logits = adapter.sim_logits(text_full, feats).reshape(b, t, q, -1)
            logits_all = logits[None].expand(l, *logits.shape)
        out["pred_logits_all"] = logits_all
        out["pred_logits"] = logits_all[-1]
        return out


def san_loss(generator: torch.Generator, outputs: Dict[str, Any], targets: ClipTargets,
             cfg: ModelConfig, num_text_classes: int, online: bool = True,
             draw_points=sorted_uniform_points) -> Dict[str, torch.Tensor]:
    """The set criterion over every layer's CLIP logits and masks (JAX
    ``san.py:96-127``): the criterion settings and the per-frame reshape of
    ``simple_baseline_loss``, which it calls."""
    return simple_baseline_loss(generator, outputs, targets, cfg, num_text_classes, online,
                                draw_points)
