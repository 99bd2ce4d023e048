"""Order statistics.  Port of ``openvis_tpu/ops/select.py::kth_largest``.

The JAX package finds the k-th largest value by a radix bit descent because
``lax.top_k`` sorts k payload columns on the TPU; the value is the same as the
k-th output of a top-k, which is what the port computes.
"""

from __future__ import annotations

import torch


def kth_largest(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th largest value of ``x`` along the last axis (k >= 1), in f32,
    shape ``x.shape[:-1]``.  Ties are by value, so ``x >= kth`` selects the
    same set as the JAX version."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    return torch.topk(x.float(), k, dim=-1).values[..., -1]
