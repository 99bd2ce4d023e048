"""SimpleBaseline(Online) meta-architecture, eval side.

Port of ``openvis_tpu/models/meta/simple_baseline.py:38-69`` and ``:135-145``:
a segmenter whose decoder head projects queries into CLIP text space;
classification logits are ``100 * normalize(embeds) @ text.T`` with a learned,
normalized no-object row appended.  The training loss is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from openvis_tpu.config import ModelConfig
from openvis_tpu_torch.models.segmenter import Segmenter


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
        embeds_all = out["pred_logits_all"]                  # (L, B, T, Q, D)
        logits_all = self.temperature * torch.einsum(
            "...d,kd->...k", _normalize(embeds_all), text_full
        )
        out["pred_logits_all"] = logits_all
        out["pred_logits"] = logits_all[-1]
        return out


def eval_scores(pred_logits: torch.Tensor) -> torch.Tensor:
    """(B, T, Q, K+1) track-aligned logits -> (B, Q, K) softmax probabilities
    of the frame-averaged logits, without the no-object column (the online
    branch; the offline video decoder is not ported)."""
    return torch.softmax(pred_logits.mean(dim=1), dim=-1)[..., :-1]
