"""Bilinear resize with torch ``F.interpolate`` semantics.

Port of ``openvis_tpu/utils/image.py::resize_bilinear_torch{,_hw}``.  The JAX
package builds exact ``F.interpolate(mode="bilinear", align_corners=False)``
weight matrices because ``jax.image.resize`` antialiases downscales; here the
operator itself is the reference.  The port keeps maps NCHW, so only the
trailing-(H, W) form is needed.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear_torch_hw(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W) -> (..., th, tw), no antialias; identity when sizes match."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(size):
        return x
    lead = x.shape[:-2]
    y = F.interpolate(
        x.reshape(1, -1, h, w), size=tuple(size), mode="bilinear",
        align_corners=False, antialias=False,
    )
    return y.reshape(*lead, *size)
