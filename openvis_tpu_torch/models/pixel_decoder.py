"""MSDeformAttn pixel decoder: deformable encoder + FPN tail.

Port of ``openvis_tpu/models/pixel_decoder.py`` (``MSDeformAttnModule``,
``MSDeformAttnEncoderLayer``, ``encoder_reference_points``,
``MSDeformAttnEncoder``, ``MSDeformAttnPixelDecoder``):

  * 1x1 input projections (+GroupNorm-32) on {res5, res4, res3};
  * deformable self-attention encoder layers over the flattened 3-level token
    sequence (post-norm, ReLU FFN), with a learned ``level_embed`` added to the
    sine position encoding;
  * FPN tail down to the stride-4 ``mask_features``.

Feature maps are NCHW; tokens are (B, Len, C) in the maps' row-major order.
Not ported yet: the SAN ``extra_features`` hook, ``BasePixelDecoder`` and
``DETRTransformer`` (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from openvis_tpu_torch.models.amp import amp_norm, softmax_f32
from openvis_tpu_torch.models.position_encoding import position_encoding_2d
from openvis_tpu_torch.ops.msda import ms_deform_attn
from openvis_tpu_torch.utils.image import resize_bilinear_torch_hw

LN_EPS = 1e-6  # flax LayerNorm / GroupNorm default


def ring_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Initial sampling-offset bias (reference ``MSDeformAttn._reset_parameters``):
    each head's points on a ring, scaled by point index.  Flat (nh*nl*P*2,)."""
    thetas = np.arange(n_heads, dtype=np.float64) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], axis=-1)  # (nh, 2)
    grid = grid / np.abs(grid).max(axis=-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


class MSDeformAttnModule(nn.Module):
    """Deformable attention: value projection, offset and weight heads, op."""

    def __init__(self, d_model: int = 256, n_levels: int = 3, n_heads: int = 8,
                 n_points: int = 4):
        super().__init__()
        self.n_heads, self.n_levels, self.n_points = n_heads, n_levels, n_points
        self.value_proj = nn.Linear(d_model, d_model)
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(
        self,
        query: torch.Tensor,             # (B, Lq, C) content + position
        reference_points: torch.Tensor,  # (B, Lq, n_levels, 2) normalized (x, y)
        value_src: torch.Tensor,         # (B, Len_in, C)
        spatial_shapes: Sequence[Tuple[int, int]],
        normalizer: torch.Tensor,        # (n_levels, 2) f32 (W, H): level_normalizer
    ) -> torch.Tensor:
        b, lq, d = query.shape
        nh, nl, p = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(value_src).view(b, -1, nh, d // nh)
        offsets = self.sampling_offsets(query).view(b, lq, nh, nl, p, 2)
        attn = self.attention_weights(query).view(b, lq, nh, nl * p)
        attn = softmax_f32(attn, dim=-1).view(b, lq, nh, nl, p)
        # sampling LOCATIONS are f32 whatever the compute dtype (a bf16
        # coordinate is ~2 px off on wide maps)
        ref = reference_points.float()
        loc = (ref[:, :, None, :, None, :]
               + offsets.float() / normalizer[None, None, None, :, None, :])
        out = ms_deform_attn(value, spatial_shapes, loc, attn)
        return self.output_proj(out)


class MSDeformAttnEncoderLayer(nn.Module):
    def __init__(self, d_model: int = 256, d_ffn: int = 1024, n_levels: int = 3,
                 n_heads: int = 8, n_points: int = 4):
        super().__init__()
        self.self_attn = MSDeformAttnModule(d_model, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, pos, reference_points, spatial_shapes, normalizer):
        attn_out = self.self_attn(src + pos, reference_points, src, spatial_shapes,
                                  normalizer)
        src = amp_norm(self.norm1, src + attn_out)
        ff = self.linear2(F.relu(self.linear1(src)))
        return amp_norm(self.norm2, src + ff)


def level_normalizer(spatial_shapes, device=None) -> torch.Tensor:
    """(n_levels, 2) f32 (W, H) of each level, the divisor of the sampling
    offsets; built once per encoder call.  The host-to-device copy does not
    wait for the stream (a blocking copy would stall the host behind the
    backbone's queued work)."""
    return torch.tensor([[w, h] for (h, w) in spatial_shapes],
                        dtype=torch.float32).to(device, non_blocking=True)


def encoder_reference_points(spatial_shapes, device=None) -> torch.Tensor:
    """(Len_in, n_levels, 2) f32 normalized (x, y) centre of each token,
    broadcast across levels (valid ratios are 1: one padded canvas)."""
    pts = []
    for (h, w) in spatial_shapes:
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1))
    ref = torch.cat(pts, dim=0)
    return ref[:, None, :].expand(ref.shape[0], len(spatial_shapes), 2)


class MSDeformAttnEncoder(nn.Module):
    def __init__(self, num_layers: int = 6, d_model: int = 256, d_ffn: int = 1024,
                 n_levels: int = 3, n_heads: int = 8, n_points: int = 4):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", MSDeformAttnEncoderLayer(
                d_model, d_ffn, n_levels, n_heads, n_points))

    def forward(self, src, pos, spatial_shapes):
        ref = encoder_reference_points(spatial_shapes, src.device)
        ref = ref[None].expand(src.shape[0], *ref.shape)
        normalizer = level_normalizer(spatial_shapes, src.device)
        for i in range(self.num_layers):
            src = getattr(self, f"layer{i}")(src, pos, ref, spatial_shapes, normalizer)
        return src


class MSDeformAttnPixelDecoder(nn.Module):
    """features (NCHW dict) -> (mask_features, transformer_encoder_feature,
    multi_scale_features): the 3 encoder levels top-down (stride 32, 16, 8)
    and the stride-4 mask feature map."""

    def __init__(self, in_channels: Dict[str, int], conv_dim: int = 256,
                 mask_dim: int = 256,
                 transformer_in_features: Sequence[str] = ("res3", "res4", "res5"),
                 enc_layers: int = 6, n_heads: int = 8, n_points: int = 4,
                 d_ffn: int = 1024):
        super().__init__()
        self.conv_dim = conv_dim
        self.tif = list(transformer_in_features)[::-1]  # top-down: res5, res4, res3
        nl = len(self.tif)
        self.level_embed = nn.Parameter(torch.zeros(nl, conv_dim))
        for idx, f in enumerate(self.tif):
            self.add_module(f"input_proj{idx}_conv", nn.Conv2d(in_channels[f], conv_dim, 1))
            self.add_module(f"input_proj{idx}_norm", nn.GroupNorm(32, conv_dim, eps=LN_EPS))
        self.encoder = MSDeformAttnEncoder(enc_layers, conv_dim, d_ffn, nl, n_heads, n_points)
        self.fpn_features = [
            f for f in ("res2", "res3", "res4") if f not in transformer_in_features
        ][::-1]
        for idx, f in enumerate(self.fpn_features):
            self.add_module(f"adapter{idx}_conv",
                            nn.Conv2d(in_channels[f], conv_dim, 1, bias=False))
            self.add_module(f"adapter{idx}_norm", nn.GroupNorm(32, conv_dim, eps=LN_EPS))
            self.add_module(f"layer{idx}_conv",
                            nn.Conv2d(conv_dim, conv_dim, 3, padding=1, bias=False))
            self.add_module(f"layer{idx}_norm", nn.GroupNorm(32, conv_dim, eps=LN_EPS))
        self.mask_features = nn.Conv2d(conv_dim, mask_dim, 1)

    def forward(self, features: Dict[str, torch.Tensor]):
        srcs, poses, shapes = [], [], []
        for idx, f in enumerate(self.tif):
            x = features[f]
            h, w = x.shape[-2:]
            s = getattr(self, f"input_proj{idx}_conv")(x)
            s = amp_norm(getattr(self, f"input_proj{idx}_norm"), s)
            pe = position_encoding_2d(h, w, self.conv_dim // 2, s.device).to(s.dtype)
            srcs.append(s.flatten(2).transpose(1, 2))
            poses.append(pe.reshape(1, h * w, self.conv_dim) + self.level_embed[idx])
            shapes.append((h, w))
        y = self.encoder(torch.cat(srcs, dim=1), torch.cat(poses, dim=1), shapes)

        # split back into maps (top-down: 1/32, 1/16, 1/8)
        outs: List[torch.Tensor] = []
        start = 0
        for (h, w) in shapes:
            outs.append(y[:, start : start + h * w].transpose(1, 2).reshape(-1, self.conv_dim, h, w))
            start += h * w

        for idx, f in enumerate(self.fpn_features):
            x = features[f]
            lat = amp_norm(getattr(self, f"adapter{idx}_norm"),
                           getattr(self, f"adapter{idx}_conv")(x))
            z = lat + resize_bilinear_torch_hw(outs[-1], tuple(x.shape[-2:]))
            z = amp_norm(getattr(self, f"layer{idx}_norm"), getattr(self, f"layer{idx}_conv")(z))
            outs.append(F.relu(z))

        return self.mask_features(outs[-1]), outs[0], outs[:3]
