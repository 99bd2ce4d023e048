"""Pixel decoders: the MSDeformAttn decoder (deformable encoder + FPN tail),
the FPN decoder with its optional DETR encoder over res5, and the plain DETR
transformer.

Port of ``openvis_tpu/models/pixel_decoder.py`` (``MSDeformAttnModule``,
``MSDeformAttnEncoderLayer``, ``encoder_reference_points``,
``MSDeformAttnEncoder``, ``MSDeformAttnPixelDecoder``, ``BasePixelDecoder``,
``DETRTransformerEncoderLayer``, ``DETRTransformerDecoderLayer``,
``DETRTransformer``).  The MSDeformAttn decoder:

  * 1x1 input projections (+GroupNorm-32) on {res5, res4, res3}, plus SAN's
    ``extra_features`` (the CLIP taps, resized bilinearly to the level where
    the sizes differ) after the norm;
  * deformable self-attention encoder layers over the flattened 3-level token
    sequence (post-norm, ReLU FFN), with a learned ``level_embed`` added to the
    sine position encoding;
  * FPN tail down to the stride-4 ``mask_features``.

``BasePixelDecoder`` (``pixel_decoder.name`` ``fpn``, or ``transformer_enc``
with a DETR encoder over res5 first) ignores ``extra_features``, as the JAX
package does: SAN's CLIP taps do not reach it.  ``DETRTransformer`` is
instantiated by no model, as in the JAX package.

Feature maps are NCHW; tokens are (B, Len, C) in the maps' row-major order.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from openvis_tpu_torch.models.amp import amp_norm, softmax_f32
from openvis_tpu_torch.models.position_encoding import position_encoding_2d
from openvis_tpu_torch.models.transformer_decoder import (
    FFNLayer,
    MultiheadAttention,
    SelfAttentionLayer,
)
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

    def forward(self, features: Dict[str, torch.Tensor],
                extra_features: Optional[Sequence[torch.Tensor]] = None):
        """``extra_features``: one NCHW map a level, top-down (res5, res4,
        res3), added to the level's normed projection (``msdeformattn.py:338-344``)."""
        srcs, poses, shapes = [], [], []
        for idx, f in enumerate(self.tif):
            x = features[f]
            h, w = x.shape[-2:]
            s = getattr(self, f"input_proj{idx}_conv")(x)
            s = amp_norm(getattr(self, f"input_proj{idx}_norm"), s)
            if extra_features is not None:
                s = s + resize_bilinear_torch_hw(extra_features[idx], (h, w))
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


class BasePixelDecoder(nn.Module):
    """The FPN pixel decoder: from res5 down to res2, a 1x1 lateral without
    bias and a GroupNorm, plus the bilinear top-down resize of the level
    above (res4 and below), then a 3x3 conv without bias, a GroupNorm and a
    ReLU; ``mask_features`` a 1x1 conv with bias on the res2 map.  With
    ``transformer_enc_layers > 0`` res5 instead goes through ``input_proj``
    (1x1 with bias) and that many [self-attention with the 2-D sine encoding
    on q and k, post-norm -> FFN] layers, with no final norm, before
    ``layer0``.  features (NCHW dict) -> (mask_features, the res5 output, the
    3 deepest outputs top-down)."""

    def __init__(self, in_channels: Dict[str, int], conv_dim: int = 256,
                 mask_dim: int = 256, transformer_enc_layers: int = 0, nheads: int = 8,
                 dim_feedforward: int = 2048):
        super().__init__()
        self.conv_dim, self.enc_layers = conv_dim, transformer_enc_layers
        self.names = ("res5", "res4", "res3", "res2")
        for idx, f in enumerate(self.names):
            if idx == 0 and transformer_enc_layers > 0:
                self.input_proj = nn.Conv2d(in_channels[f], conv_dim, 1)
                for li in range(transformer_enc_layers):
                    self.add_module(f"enc_attn{li}", SelfAttentionLayer(conv_dim, nheads))
                    self.add_module(f"enc_ffn{li}", FFNLayer(conv_dim, dim_feedforward))
            else:
                self.add_module(f"adapter{idx}_conv",
                                nn.Conv2d(in_channels[f], conv_dim, 1, bias=False))
                self.add_module(f"adapter{idx}_norm", nn.GroupNorm(32, conv_dim, eps=LN_EPS))
            self.add_module(f"layer{idx}_conv",
                            nn.Conv2d(conv_dim, conv_dim, 3, padding=1, bias=False))
            self.add_module(f"layer{idx}_norm", nn.GroupNorm(32, conv_dim, eps=LN_EPS))
        self.mask_features = nn.Conv2d(conv_dim, mask_dim, 1)

    def _encode_res5(self, x: torch.Tensor) -> torch.Tensor:
        n, _, h, w = x.shape
        tok = self.input_proj(x).flatten(2).transpose(1, 2)          # (N, h*w, C)
        pe = position_encoding_2d(h, w, self.conv_dim // 2, x.device).to(tok.dtype)
        pe = pe.reshape(1, h * w, self.conv_dim)
        for li in range(self.enc_layers):
            tok = getattr(self, f"enc_attn{li}")(tok, pe)
            tok = getattr(self, f"enc_ffn{li}")(tok)
        return tok.transpose(1, 2).reshape(n, self.conv_dim, h, w)

    def forward(self, features: Dict[str, torch.Tensor],
                extra_features: Optional[Sequence[torch.Tensor]] = None):
        """``extra_features`` is accepted and not read (JAX
        ``pixel_decoder.py:186``)."""
        outs: List[torch.Tensor] = []
        y = None
        for idx, f in enumerate(self.names):
            x = features[f]
            if idx == 0 and self.enc_layers > 0:
                y = self._encode_res5(x)
            else:
                lat = amp_norm(getattr(self, f"adapter{idx}_norm"),
                               getattr(self, f"adapter{idx}_conv")(x))
                y = lat if y is None else lat + resize_bilinear_torch_hw(y, tuple(x.shape[-2:]))
            z = amp_norm(getattr(self, f"layer{idx}_norm"), getattr(self, f"layer{idx}_conv")(y))
            y = F.relu(z)
            outs.append(y)
        return self.mask_features(outs[-1]), outs[0], outs[:3]


def _activation(name: str):
    # flax's nn.gelu is the tanh approximation
    return {"relu": F.relu, "gelu": functools.partial(F.gelu, approximate="tanh")}[name]


class DETRTransformerEncoderLayer(nn.Module):
    """A DETR encoder layer: self-attention with the encoding added to q and
    k only, then the FFN; post- or pre-norm."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 pre_norm: bool = False, activation: str = "relu"):
        super().__init__()
        self.pre_norm, self.act = pre_norm, _activation(activation)
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, pos):
        def attn(x):
            qk = x + pos
            return self.self_attn(qk, qk, x)

        def ffn(x):
            return self.linear2(self.act(self.linear1(x)))

        if self.pre_norm:
            src = src + attn(amp_norm(self.norm1, src))
            return src + ffn(amp_norm(self.norm2, src))
        src = amp_norm(self.norm1, src + attn(src))
        return amp_norm(self.norm2, src + ffn(src))


class DETRTransformerDecoderLayer(nn.Module):
    """A DETR decoder layer: self-attention (query encoding on q and k),
    cross-attention (query encoding on q, the sine encoding on k), FFN;
    post- or pre-norm."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 pre_norm: bool = False, activation: str = "relu"):
        super().__init__()
        self.pre_norm, self.act = pre_norm, _activation(activation)
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.multihead_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt, memory, pos, query_pos):
        def sattn(x):
            qk = x + query_pos
            return self.self_attn(qk, qk, x)

        def cattn(x):
            return self.multihead_attn(x + query_pos, memory + pos, memory)

        def ffn(x):
            return self.linear2(self.act(self.linear1(x)))

        if self.pre_norm:
            tgt = tgt + sattn(amp_norm(self.norm1, tgt))
            tgt = tgt + cattn(amp_norm(self.norm2, tgt))
            return tgt + ffn(amp_norm(self.norm3, tgt))
        tgt = amp_norm(self.norm1, tgt + sattn(tgt))
        tgt = amp_norm(self.norm2, tgt + cattn(tgt))
        return amp_norm(self.norm3, tgt + ffn(tgt))


class DETRTransformer(nn.Module):
    """The plain DETR transformer, encoder and decoder: ``encoder_norm`` only
    under pre-norm; the decoder starts from zeros and returns every layer's
    output, each through the shared ``decoder_norm``.  src (B, C, H, W),
    pos_embed (B or 1, C, H, W), query_embed (Q, C) -> (hs (L, B, Q, C),
    memory (B, C, H, W))."""

    def __init__(self, d_model: int = 256, nhead: int = 8, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, dim_feedforward: int = 2048,
                 pre_norm: bool = False, activation: str = "relu"):
        super().__init__()
        self.pre_norm = pre_norm
        self.num_encoder_layers, self.num_decoder_layers = num_encoder_layers, num_decoder_layers
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_layer{i}", DETRTransformerEncoderLayer(
                d_model, nhead, dim_feedforward, pre_norm, activation))
        if pre_norm:
            self.encoder_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_layer{i}", DETRTransformerDecoderLayer(
                d_model, nhead, dim_feedforward, pre_norm, activation))
        self.decoder_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, query_embed, pos_embed):
        b, c, h, w = src.shape
        x = src.flatten(2).transpose(1, 2)
        pos = pos_embed.flatten(2).transpose(1, 2).to(x.dtype)
        for i in range(self.num_encoder_layers):
            x = getattr(self, f"encoder_layer{i}")(x, pos)
        if self.pre_norm:
            x = amp_norm(self.encoder_norm, x)
        memory = x
        qpos = query_embed[None].to(x.dtype).expand(b, -1, -1)
        tgt = torch.zeros_like(qpos)
        inter = []
        for i in range(self.num_decoder_layers):
            tgt = getattr(self, f"decoder_layer{i}")(tgt, memory, pos, qpos)
            inter.append(amp_norm(self.decoder_norm, tgt))
        return torch.stack(inter), memory.transpose(1, 2).reshape(b, c, h, w)
