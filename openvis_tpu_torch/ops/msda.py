"""Multi-scale deformable attention (MSDeformAttn).

Port of ``openvis_tpu/ops/msda.py``.  Semantics: for each query, each head
samples ``P`` bilinear points per feature level (zero padding outside,
``align_corners=False``: pixel coordinate = loc * size - 0.5) and sums them
with softmaxed attention weights.

``ms_deform_attn`` dispatches by the device of its tensors: a CUDA tensor goes
to the hand-written kernel (``ops/msda_cuda.py``), a CPU tensor to
``ms_deform_attn_plain``, the ``F.grid_sample`` composition of the reference
op (``ms_deform_attn_func.py:52-72`` upstream).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def ms_deform_attn(
    value: torch.Tensor,                         # (B, Len_in, n_heads, ch)
    spatial_shapes: Sequence[Tuple[int, int]],   # [(H_l, W_l)] per level
    sampling_locations: torch.Tensor,            # (B, Len_q, n_heads, n_levels, P, 2) in [0,1]
    attention_weights: torch.Tensor,             # (B, Len_q, n_heads, n_levels, P)
) -> torch.Tensor:                               # (B, Len_q, n_heads * ch)
    if value.device.type == "cuda":
        from openvis_tpu_torch.ops.msda_cuda import ms_deform_attn_cuda

        return ms_deform_attn_cuda(
            value, spatial_shapes, sampling_locations, attention_weights
        )
    if value.device.type == "cpu":
        return ms_deform_attn_plain(
            value, spatial_shapes, sampling_locations, attention_weights
        )
    raise ValueError(f"ms_deform_attn: no implementation for {value.device}")


def ms_deform_attn_plain(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """``F.grid_sample`` composition, computed in f32, returned in the value's
    dtype.  Defines the semantics the CUDA kernel is held to."""
    b, len_in, nh, ch = value.shape
    lq, p = sampling_locations.shape[1], sampling_locations.shape[-2]
    if sum(h * w for h, w in spatial_shapes) != len_in:
        raise ValueError(f"value length {len_in} != sum of {list(spatial_shapes)}")
    v32 = value.float()
    loc = sampling_locations.float()
    attn = attention_weights.float()
    out = v32.new_zeros((b * nh, ch, lq))
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = v32[:, start : start + h * w]                # (B, hw, nh, ch)
        start += h * w
        v = v.permute(0, 2, 3, 1).reshape(b * nh, ch, h, w)
        grid = loc[:, :, :, lvl] * 2 - 1                 # (B, Lq, nh, P, 2)
        grid = grid.permute(0, 2, 1, 3, 4).reshape(b * nh, lq, p, 2)
        sampled = F.grid_sample(
            v, grid, mode="bilinear", padding_mode="zeros", align_corners=False
        )                                                # (B*nh, ch, Lq, P)
        a = attn[:, :, :, lvl].permute(0, 2, 1, 3).reshape(b * nh, 1, lq, p)
        out = out + (sampled * a).sum(-1)
    out = out.view(b, nh, ch, lq).permute(0, 3, 1, 2).reshape(b, lq, nh * ch)
    return out.to(value.dtype)
