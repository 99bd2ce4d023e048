"""Batch structures.  Port of ``openvis_tpu/structures.py::ClipTargets``."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class ClipTargets:
    """Padded ground truth of one batch of clips.

    labels:      (B, N) int64, class index per instance slot (arbitrary where
                 the slot is invalid);
    masks:       (B, N, T, H, W) bool or 0/1 float, per-frame masks at the
                 input resolution;
    valid:       (B, N) bool, slot occupancy;
    frame_valid: (B, N, T) bool, the instance is visible in frame t.
    """

    labels: torch.Tensor
    masks: torch.Tensor
    valid: torch.Tensor
    frame_valid: torch.Tensor

    def to(self, device) -> "ClipTargets":
        return ClipTargets(self.labels.to(device), self.masks.to(device),
                           self.valid.to(device), self.frame_valid.to(device))
