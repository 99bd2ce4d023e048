"""Bilinear and bicubic resizes with torch ``F.interpolate`` semantics.

Port of ``openvis_tpu/utils/image.py::resize_bilinear_torch{,_hw}`` and
``resize_bicubic_torch``.  The JAX package builds exact
``F.interpolate(align_corners=False, antialias=False)`` weight matrices
(bicubic with the a = -0.75 kernel) because ``jax.image.resize`` antialiases
downscales and uses a = -0.5; here the operator itself is the reference.  The
port keeps maps NCHW, so only the trailing-(H, W) form is needed.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _resize_hw(x: torch.Tensor, size: Tuple[int, int], mode: str) -> torch.Tensor:
    h, w = x.shape[-2:]
    if (h, w) == tuple(size):
        return x
    lead = x.shape[:-2]
    y = F.interpolate(
        x.reshape(1, -1, h, w), size=tuple(size), mode=mode,
        align_corners=False, antialias=False,
    )
    return y.reshape(*lead, *size)


def resize_bilinear_torch_hw(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W) -> (..., th, tw), no antialias; identity when sizes match."""
    return _resize_hw(x, size, "bilinear")


def resize_bicubic_torch_hw(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W) -> (..., th, tw), bicubic (a = -0.75, border-clamped taps),
    no antialias; identity when sizes match."""
    return _resize_hw(x, size, "bicubic")
