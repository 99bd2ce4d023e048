"""AMP dtype policy: norm and softmax arithmetic in f32, result in the input
dtype.  Port of ``openvis_tpu/models/amp.py``; both are identity in f32."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def amp_norm(norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply a LayerNorm / GroupNorm with f32 arithmetic (its parameters are
    upcast too), cast back to ``x.dtype``."""
    xf = x.float()
    weight = norm.weight.float()
    bias = norm.bias.float()
    if isinstance(norm, nn.LayerNorm):
        y = F.layer_norm(xf, norm.normalized_shape, weight, bias, norm.eps)
    elif isinstance(norm, nn.GroupNorm):
        y = F.group_norm(xf, norm.num_groups, weight, bias, norm.eps)
    else:
        raise TypeError(f"amp_norm: unsupported norm {type(norm).__name__}")
    return y.to(x.dtype)


def softmax_f32(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax computed in f32, result in ``logits.dtype``."""
    return torch.softmax(logits.float(), dim=dim).to(logits.dtype)
