"""Segmenter: backbone -> pixel decoder -> masked transformer decoder.

Port of ``openvis_tpu/models/segmenter.py:33-153``: the backbone
(``resnet``; OV2Seg's ``timm_resnet``, the same trunk with
``stride_in_1x1=False``; ``swin``, whose stages' widths ``embed_dim * 2^i``
go to the pixel decoder's input projections), the pixel decoder that
``pixel_decoder.name`` names (``msdeform``, with SAN's CLIP taps as its
``extra_features``; ``fpn`` and ``transformer_enc``, the FPN with a DETR
encoder over res5, which ignore them as the JAX package does) and the
transformer decoder that ``transformer_decoder.name`` names, by the JAX
package's ``_DECODER_KINDS``: the frame decoders (``frame``,
``frame_embedding``, ``frame_proposal``, ``side_adapter_frame``,
``ov2seg_frame``, ``frame_zero_shot``) and the video decoders (``video``,
``video_embedding``, ``video_proposal``, ``side_adapter_video``,
``video_zero_shot``), whose mask features go in as (B, T, ...).  An unknown
name raises ``ValueError``.  Input is the flattened frame batch (B*T, H, W,
3) in NHWC, as in the JAX package; the trunk runs NCHW.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from openvis_tpu_torch.config import ModelConfig, PixelDecoderConfig
from openvis_tpu_torch.models.backbone import swin
from openvis_tpu_torch.models.backbone.resnet import ResNet, feature_channels
from openvis_tpu_torch.models.pixel_decoder import BasePixelDecoder, MSDeformAttnPixelDecoder
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
    "ov2seg_frame": ("frame", "ov2seg"),
    "frame_zero_shot": ("frame", "zero_shot"),
    "video_zero_shot": ("video", "zero_shot"),
}


def build_backbone(cfg: ModelConfig):
    """(trunk, its feature channels by name) for ``model.backbone``."""
    b = cfg.backbone
    if b.name in ("resnet", "timm_resnet"):
        trunk = ResNet(b.depth, b.stem_out_channels,
                       False if b.name == "timm_resnet" else b.stride_in_1x1,
                       tuple(b.out_features))
        return trunk, feature_channels(b.depth, b.stem_out_channels)
    if b.name == "swin":
        trunk = swin.SwinTransformer(
            embed_dim=b.swin_embed_dim, depths=tuple(b.swin_depths),
            num_heads=tuple(b.swin_num_heads), window_size=b.swin_window_size,
            mlp_ratio=b.swin_mlp_ratio, patch_size=b.swin_patch_size,
            qkv_bias=b.swin_qkv_bias, drop_path_rate=b.swin_drop_path_rate,
            patch_norm=b.swin_patch_norm, ape=b.swin_ape,
            pretrain_img_size=b.swin_pretrain_img_size, out_features=tuple(b.out_features))
        return trunk, swin.feature_channels(b.swin_embed_dim)
    raise ValueError(f"unknown backbone {b.name!r}")


def build_pixel_decoder(pd: PixelDecoderConfig, channels: Dict[str, int]) -> nn.Module:
    """``pixel_decoder.name``'s module (JAX ``segmenter.py:102-122``)."""
    if pd.name in ("fpn", "transformer_enc"):
        return BasePixelDecoder(
            channels, conv_dim=pd.conv_dim, mask_dim=pd.mask_dim,
            transformer_enc_layers=(pd.transformer_enc_layers
                                    if pd.name == "transformer_enc" else 0),
            nheads=pd.num_heads, dim_feedforward=pd.dim_feedforward)
    if pd.name == "msdeform":
        return MSDeformAttnPixelDecoder(
            channels, conv_dim=pd.conv_dim, mask_dim=pd.mask_dim,
            transformer_in_features=tuple(pd.transformer_in_features),
            enc_layers=pd.transformer_enc_layers, n_heads=pd.num_heads,
            n_points=pd.num_points, d_ffn=pd.dim_feedforward)
    raise ValueError(f"unknown pixel decoder {pd.name!r}")


class Segmenter(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        pd, td = cfg.pixel_decoder, cfg.transformer_decoder
        if td.name not in DECODER_KINDS:
            raise ValueError(f"unknown transformer decoder {td.name!r}")
        mode, head = DECODER_KINDS[td.name]
        self.video = mode == "video"
        self.backbone, channels = build_backbone(cfg)
        self.pixel_decoder = build_pixel_decoder(pd, channels)
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
