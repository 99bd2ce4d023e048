"""Segmenter: backbone -> pixel decoder -> masked transformer decoder.

Port of ``openvis_tpu/models/segmenter.py:85-153``, the ported routes: ResNet
backbone, ``msdeform`` pixel decoder and the ``frame_embedding`` decoder,
OpenVIS's ``frame_proposal`` decoder, or SAN's ``side_adapter_frame``
decoder with the CLIP taps as the pixel decoder's ``extra_features``.  Any
other route raises ``NotImplementedError`` (ROADMAP.md, queue 1; the video
decoders item 8).  Input is the flattened frame
batch (B*T, H, W, 3) in NHWC, as in the JAX package; the trunk runs NCHW.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from openvis_tpu_torch.config import ModelConfig
from openvis_tpu_torch.models.backbone.resnet import ResNet, feature_channels
from openvis_tpu_torch.models.pixel_decoder import MSDeformAttnPixelDecoder
from openvis_tpu_torch.models.transformer_decoder import MaskedTransformerDecoder


# ported decoder name -> head (the frame mode's entries of the JAX _DECODER_KINDS)
_FRAME_HEADS = {"frame_embedding": "embedding", "frame_proposal": "proposal",
                "side_adapter_frame": "side_adapter"}
# the video decoder's names (offline archs): ROADMAP.md queue 1 item 8
_VIDEO_DECODERS = ("video", "video_embedding", "video_proposal", "side_adapter_video")


def _not_ported(what: str, where: str = "queue 1") -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, {where})")


class Segmenter(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        b, pd, td = cfg.backbone, cfg.pixel_decoder, cfg.transformer_decoder
        if b.name != "resnet":
            raise _not_ported(f"backbone {b.name!r}")
        if pd.name != "msdeform":
            raise _not_ported(f"pixel decoder {pd.name!r}")
        if td.name in _VIDEO_DECODERS:  # the offline archs' video decoder
            raise _not_ported(f"transformer decoder {td.name!r}", "queue 1 item 8")
        if td.name not in _FRAME_HEADS:
            raise _not_ported(f"transformer decoder {td.name!r}")
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
            mode="frame", head=_FRAME_HEADS[td.name], hidden_dim=td.hidden_dim,
            num_queries=td.num_queries, nheads=td.nheads,
            dim_feedforward=td.dim_feedforward, dec_layers=td.dec_layers,
            pre_norm=td.pre_norm, mask_dim=td.mask_dim, clip_dim=td.clip_embed_dim,
            clip_heads=cfg.clip_adapter.clip_num_heads, in_channels=pd.conv_dim,
        )

    def forward(self, frames: torch.Tensor, num_frames: int,
                extra_features: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, Any]:
        """frames (B*T, H, W, 3) normalized NHWC; ``extra_features`` the
        pixel decoder's per-level additions, top-down."""
        feats = self.backbone(frames.permute(0, 3, 1, 2).contiguous())
        mask_features, _, ms_features = self.pixel_decoder(feats, extra_features)
        return self.predictor(ms_features, mask_features, num_frames)
