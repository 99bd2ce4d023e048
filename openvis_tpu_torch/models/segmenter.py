"""Segmenter: backbone -> pixel decoder -> masked transformer decoder.

Port of ``openvis_tpu/models/segmenter.py:66-153``: the ResNet backbone, the
``msdeform`` pixel decoder (with SAN's CLIP taps as its ``extra_features``)
and the transformer decoder that ``transformer_decoder.name`` names, by the
JAX package's ``_DECODER_KINDS``: the frame decoders (``frame``,
``frame_embedding``, ``frame_proposal``, ``side_adapter_frame``) and the video
decoders of the offline archs (``video``, ``video_embedding``,
``video_proposal``, ``side_adapter_video``), whose mask features go in as
(B, T, ...).  OV2Seg's decoder and the zero-shot decoders raise
``NotImplementedError`` naming their ROADMAP.md items (queue 1 items 8.5 and
8.8), as do OV2Seg's ``timm_resnet`` (8.5), Swin (8.6) and the other pixel
decoders (8.8).  Input is the flattened
frame batch (B*T, H, W, 3) in NHWC, as in the JAX package; the trunk runs
NCHW.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from openvis_tpu_torch.config import ModelConfig
from openvis_tpu_torch.models.backbone.resnet import ResNet, feature_channels
from openvis_tpu_torch.models.pixel_decoder import MSDeformAttnPixelDecoder
from openvis_tpu_torch.models.transformer_decoder import MaskedTransformerDecoder


# ported decoder name -> (mode, head), the JAX package's _DECODER_KINDS
DECODER_KINDS = {
    "video": ("video", "class"),
    "frame": ("frame", "class"),
    "video_embedding": ("video", "embedding"),
    "frame_embedding": ("frame", "embedding"),
    "video_proposal": ("video", "proposal"),
    "frame_proposal": ("frame", "proposal"),
    "side_adapter_frame": ("frame", "side_adapter"),
    "side_adapter_video": ("video", "side_adapter"),
}
# what is still to port and its ROADMAP.md queue 1 item
_UNPORTED_DECODERS = {"ov2seg_frame": "8.5", "frame_zero_shot": "8.8",
                      "video_zero_shot": "8.8"}
_UNPORTED_BACKBONES = {"timm_resnet": "8.5", "swin": "8.6"}
_UNPORTED_PIXEL_DECODERS = {"fpn": "8.8", "transformer_enc": "8.8"}


def _not_ported(what: str, where: str = "queue 1") -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, {where})")


class Segmenter(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        b, pd, td = cfg.backbone, cfg.pixel_decoder, cfg.transformer_decoder
        if b.name != "resnet":
            raise _not_ported(f"backbone {b.name!r}",
                              f"queue 1 item {_UNPORTED_BACKBONES.get(b.name, 8)}")
        if pd.name != "msdeform":
            raise _not_ported(f"pixel decoder {pd.name!r}",
                              f"queue 1 item {_UNPORTED_PIXEL_DECODERS.get(pd.name, 8)}")
        if td.name in _UNPORTED_DECODERS:
            raise _not_ported(f"transformer decoder {td.name!r}",
                              f"queue 1 item {_UNPORTED_DECODERS[td.name]}")
        if td.name not in DECODER_KINDS:
            raise ValueError(f"unknown transformer decoder {td.name!r}")
        mode, head = DECODER_KINDS[td.name]
        self.video = mode == "video"
        self.backbone = ResNet(b.depth, b.stem_out_channels, b.stride_in_1x1,
                               tuple(b.out_features))
        self.pixel_decoder = MSDeformAttnPixelDecoder(
            feature_channels(b.depth, b.stem_out_channels),
            conv_dim=pd.conv_dim, mask_dim=pd.mask_dim,
            transformer_in_features=tuple(pd.transformer_in_features),
            enc_layers=pd.transformer_enc_layers, n_heads=pd.num_heads,
            n_points=pd.num_points, d_ffn=pd.dim_feedforward,
        )
        self.predictor = MaskedTransformerDecoder(
            mode=mode, head=head, hidden_dim=td.hidden_dim,
            num_queries=td.num_queries, nheads=td.nheads,
            dim_feedforward=td.dim_feedforward, dec_layers=td.dec_layers,
            pre_norm=td.pre_norm, mask_dim=td.mask_dim, num_classes=cfg.num_classes,
            clip_dim=td.clip_embed_dim,
            clip_heads=cfg.clip_adapter.clip_num_heads, in_channels=pd.conv_dim,
        )

    def forward(self, frames: torch.Tensor, num_frames: int,
                extra_features: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, Any]:
        """frames (B*T, H, W, 3) normalized NHWC; ``extra_features`` the
        pixel decoder's per-level additions, top-down."""
        feats = self.backbone(frames.permute(0, 3, 1, 2).contiguous())
        mask_features, _, ms_features = self.pixel_decoder(feats, extra_features)
        if self.video:  # (B*T, Cm, H, W) -> (B, T, Cm, H, W)
            mask_features = mask_features.reshape(-1, num_frames, *mask_features.shape[1:])
        return self.predictor(ms_features, mask_features, num_frames)
