"""ResNet backbone with frozen-BN affines (NCHW).

Port of ``openvis_tpu/models/backbone/resnet.py``: Detectron2 basic stem,
bottleneck blocks [3, 4, 6, 3] for R50, ``stride_in_1x1`` selectable, frozen
BatchNorm folded into a per-channel affine.  Returns ``res2..res5`` at strides
4/8/16/32.  Module names mirror the flax ones so parameters carry across
(``openvis_tpu_torch/convert.py``).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

_STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def feature_channels(depth: int = 50, stem: int = 64) -> Dict[str, int]:
    return {f"res{i + 2}": stem * (2 ** i) * 4 for i in range(4)}


class FrozenAffine(nn.Module):
    """Per-channel affine y = x * scale + bias (a folded, frozen BatchNorm).

    The arithmetic is f32 and the result is cast back to the input dtype, so
    f32 affine parameters never promote a bf16 trunk."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.float() * self.scale.float()[:, None, None] + self.bias.float()[:, None, None]
        return y.to(x.dtype)


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, bottleneck_channels: int,
                 stride: int = 1, stride_in_1x1: bool = False,
                 has_shortcut: bool = False):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        if has_shortcut:
            self.shortcut_conv = nn.Conv2d(in_channels, out_channels, 1, stride=stride, bias=False)
            self.shortcut_norm = FrozenAffine(out_channels)
        self.has_shortcut = has_shortcut
        self.conv1 = nn.Conv2d(in_channels, bottleneck_channels, 1, stride=s1, bias=False)
        self.norm1 = FrozenAffine(bottleneck_channels)
        self.conv2 = nn.Conv2d(bottleneck_channels, bottleneck_channels, 3, stride=s3,
                               padding=1, bias=False)
        self.norm2 = FrozenAffine(bottleneck_channels)
        self.conv3 = nn.Conv2d(bottleneck_channels, out_channels, 1, bias=False)
        self.norm3 = FrozenAffine(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.has_shortcut:
            shortcut = self.shortcut_norm(self.shortcut_conv(x))
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        return F.relu(y + shortcut)


class ResNet(nn.Module):
    """ResNet-{50,101,152} trunk: NCHW image -> {res2..res5} NCHW features."""

    def __init__(self, depth: int = 50, stem_out_channels: int = 64,
                 stride_in_1x1: bool = False,
                 out_features: Sequence[str] = ("res2", "res3", "res4", "res5")):
        super().__init__()
        self.out_features = tuple(out_features)
        self.stem_conv1 = nn.Conv2d(3, stem_out_channels, 7, stride=2, padding=3, bias=False)
        self.stem_norm1 = FrozenAffine(stem_out_channels)
        self.blocks = []
        in_ch = stem_out_channels
        for stage_idx, n_blocks in enumerate(_STAGE_BLOCKS[depth]):
            width = stem_out_channels * (2 ** stage_idx)
            out_ch = width * 4  # bottleneck expansion
            for b in range(n_blocks):
                name = f"res{stage_idx + 2}_block{b}"
                self.add_module(name, Bottleneck(
                    in_ch, out_ch, width,
                    stride=2 if (b == 0 and stage_idx > 0) else 1,
                    stride_in_1x1=stride_in_1x1, has_shortcut=(b == 0),
                ))
                self.blocks.append((f"res{stage_idx + 2}", name, b == n_blocks - 1))
                in_ch = out_ch

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = F.relu(self.stem_norm1(self.stem_conv1(x)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        outs = {}
        for stage, name, last in self.blocks:
            y = getattr(self, name)(y)
            if last and stage in self.out_features:
                outs[stage] = y
        return outs
