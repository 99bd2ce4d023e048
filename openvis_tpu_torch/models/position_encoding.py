"""Sine 2-D and 3-D position encodings (DETR style, ``normalize=True``, scale
2*pi, temperature 10000).  Port of ``openvis_tpu/models/position_encoding.py:21-64``
(the frame decoder's 2-D encoding and the video decoder's 3-D one); the 1-D
encoding belongs to no ported path."""

from __future__ import annotations

import math

import torch


def _sine_embed(pos: torch.Tensor, num_pos_feats: int, temperature: float = 10000.0):
    """pos: (n,) normalized*scale positions -> (n, num_pos_feats), sin/cos
    interleaved."""
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)
    p = pos[:, None] / dim_t
    return torch.stack([p[:, 0::2].sin(), p[:, 1::2].cos()], dim=-1).reshape(
        pos.shape[0], num_pos_feats
    )


def position_encoding_2d(
    h: int, w: int, num_pos_feats: int = 128, device=None
) -> torch.Tensor:
    """(h, w, 2*num_pos_feats) f32 -- concat(y_embed, x_embed) like DETR."""
    scale = 2 * math.pi
    y = (torch.arange(h, dtype=torch.float32, device=device) + 1.0) / (h + 1e-6) * scale
    x = (torch.arange(w, dtype=torch.float32, device=device) + 1.0) / (w + 1e-6) * scale
    pe_y = _sine_embed(y, num_pos_feats)[:, None, :].expand(h, w, num_pos_feats)
    pe_x = _sine_embed(x, num_pos_feats)[None, :, :].expand(h, w, num_pos_feats)
    return torch.cat([pe_y, pe_x], dim=-1)


def position_encoding_3d(t: int, h: int, w: int, hidden_dim: int = 256,
                         device=None) -> torch.Tensor:
    """(t, h, w, hidden_dim) f32: the spatial concat(pos_y, pos_x) of
    ``hidden_dim // 2`` features each, with a temporal pos_z of ``hidden_dim``
    features **added** to it (the reference's ``PositionEmbeddingSine3D``)."""
    scale = 2 * math.pi
    z = (torch.arange(t, dtype=torch.float32, device=device) + 1.0) / (t + 1e-6) * scale
    pe = position_encoding_2d(h, w, hidden_dim // 2, device)            # (h, w, hidden)
    return pe[None] + _sine_embed(z, hidden_dim)[:, None, None, :]
