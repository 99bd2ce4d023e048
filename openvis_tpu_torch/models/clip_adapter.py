"""Mask-crop CLIP classification.

Port of ``openvis_tpu/models/clip_adapter.py`` (the reference's
``ClipAdapter`` / ``BgClipAdapter``, ``openvis/modeling/clip_adapter/adapter.py:34-161``):
masks binarized at 0.5 -> per-(frame, query) boxes -> top-left-anchored
square crops -> bilinear resample of the frame and the soft mask to the
tower's resolution -> background zeroed -> CLIP -> 100 x cosine against the
text rows.

As in the JAX package, every (frame, query) slot goes through CLIP, an empty
mask as the box [0, 0, 1, 1], and a validity mask drops it downstream: the
slots are not compacted, so the path needs no host synchronisation.  Regions
go through one frame at a time (``clip_crop_classify``): a frame's Q crops
fill the card's matrix units (Q x 197 tokens a product at ViT-B/16), while
the live set stays near Q crops' attention probabilities (~0.2 GB at Q = 100
in f32).
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from openvis_tpu_torch.models.clip.model import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD


def mask_square_boxes(masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """masks (R, H, W) soft [0, 1] -> (boxes (R, 4) xyxy f32, valid (R,)).
    The box of mask > 0.5, extended to a square from its top-left corner
    (adapter.py:93-99's sboxes); [0, 0, 1, 1] where the mask is empty."""
    h, w = masks.shape[-2:]
    binm = masks > 0.5
    valid = binm.flatten(1).any(dim=1)
    cols = binm.any(dim=-2)                                  # (R, W)
    rows = binm.any(dim=-1)                                  # (R, H)
    xs = torch.arange(w, device=masks.device)
    ys = torch.arange(h, device=masks.device)
    x0 = torch.where(cols, xs, w).amin(dim=-1)
    x1 = torch.where(cols, xs + 1, 0).amax(dim=-1)
    y0 = torch.where(rows, ys, h).amin(dim=-1)
    y1 = torch.where(rows, ys + 1, 0).amax(dim=-1)
    side = torch.maximum(x1 - x0, y1 - y0)
    boxes = torch.stack([x0, y0, x0 + side, y0 + side], dim=-1).float()
    empty = torch.tensor([0.0, 0.0, 1.0, 1.0], device=masks.device)
    return torch.where(valid[:, None], boxes, empty), valid


def _axis_taps(lo: torch.Tensor, hi: torch.Tensor, size: int, s: int, sr: int,
               tk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """roi_align's sub-sample average along one axis folded into a ``tk``-wide
    tap window: (base (R, s) int64, the first source index; weights
    (R, s, tk) f32, the sub-samples' tents times their in-bounds indicator,
    divided by ``sr``).  Bilinear sampling, the average, the [-1, size] zero
    cut and the edge clamp all factor per axis, so the 2-D sample mean is
    exactly the outer product of the two axes' windows."""
    scale = (hi - lo) / s                                        # (R,)
    grid = (torch.arange(s * sr, dtype=torch.float32, device=lo.device) + 0.5) / sr
    cx = lo[:, None] + grid[None, :] * scale[:, None]            # (R, s*sr)
    inb = (cx >= -1.0) & (cx <= size)
    cx = cx.clamp(0.0, size - 1)
    fx = cx.floor()
    lx = (cx - fx).reshape(-1, s, sr)
    fi = fx.long().reshape(-1, s, sr)
    base = fi[:, :, 0]                                           # (R, s)
    off = fi - base[:, :, None]                                  # (R, s, sr) >= 0
    contrib = inb.float().reshape(-1, s, sr) / sr
    zero = torch.zeros((), device=lo.device)
    wts = []
    for j in range(tk):
        wt = torch.where(off == j, (1.0 - lx) * contrib, zero).sum(-1)
        if j:
            wt = wt + torch.where(off == j - 1, lx * contrib, zero).sum(-1)
        wts.append(wt)
    return base, torch.stack(wts, dim=-1)


def _tap_width(size: int, s: int, sr: int) -> int:
    """Static tap-window bound: one output bin's sub-samples spread
    ``scale * (sr - 1) / sr`` source pixels, and bilinear adds a tap each
    side.  Box spans must not exceed ``size`` (``mask_square_boxes``' sides
    are at most the larger image extent)."""
    return 2 + int(math.ceil(max(1.0, size / s) * (sr - 1) / sr))


def roi_crop(images: torch.Tensor, boxes: torch.Tensor, out_size: int,
             sampling_ratio: int = 1) -> torch.Tensor:
    """Bilinear crop-resize of each region to (out_size, out_size).

    images (R | 1, H, W, C): one image per region, or one shared by all;
    boxes (R, 4) xyxy -> (R, out_size, out_size, C) in the images' dtype.

    torchvision's ``roi_align(aligned=False)`` (the reference's call,
    adapter.py:108) with a static ``sampling_ratio``: samples at
    ``x0 + (j + (k + 0.5) / sr) * bin_w`` on the integer pixel grid, zero
    outside [-1, size], clamped inside, averaged over the sr x sr
    sub-samples of a bin.  The mean is separable, so each axis is ``tk``
    whole-row gathers (``index_select`` / advanced indexing along rows) and
    multiply-adds of the per-region tap weights: x first, on the transposed
    image, then y."""
    _, h, w, c = images.shape
    r = boxes.shape[0]
    s, sr = out_size, sampling_ratio
    # square boxes: either axis's span can reach max(h, w)
    tk = _tap_width(max(h, w), s, sr)
    bx, wx = _axis_taps(boxes[:, 0], boxes[:, 2], w, s, sr, tk)
    by, wy = _axis_taps(boxes[:, 1], boxes[:, 3], h, s, sr, tk)
    wx = wx.to(images.dtype)
    wy = wy.to(images.dtype)
    regions = torch.arange(r, device=images.device)[:, None]

    imt = images.transpose(1, 2).contiguous()                    # (R|1, W, H, C)
    acc = None
    for j in range(tk):
        idx = (bx + j).clamp(0, w - 1)                           # (R, s)
        if images.shape[0] == 1:
            rows = imt[0].index_select(0, idx.reshape(-1)).reshape(r, s, h, c)
        else:
            rows = imt[regions, idx]                             # (R, s, H, C)
        term = rows * wx[:, :, None, j:j + 1]
        acc = term if acc is None else acc + term
    acc = acc.transpose(1, 2)                                    # (R, H, s, C)

    out = None
    for j in range(tk):
        idx = (by + j).clamp(0, h - 1)
        term = acc[regions, idx] * wy[:, :, None, j:j + 1]       # (R, s, s, C)
        out = term if out is None else out + term
    return out


def clip_crop_classify(
    visual_apply: Callable[[torch.Tensor], torch.Tensor],  # (R, S, S, 3) normalized -> (R, D)
    frames_raw: torch.Tensor,   # (T, H, W, 3) RGB in [0, 255]
    masks: torch.Tensor,        # (T, Q, h, w) sigmoid probabilities
    text_feats: torch.Tensor,   # (K, D) normalized (may include the bg row)
    input_resolution: int = 224,
    temperature: float = 100.0,
    mask_stride: int = 1,       # masks on a coarser grid: boxes x stride for the frame crop
    sampling_ratio: int = 1,
    mask_prompt: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits (T, Q, K), valid (T, Q)); ``ClipAdapter.forward`` with
    ``_preprocess_image`` (adapter.py:56-116), one frame at a time.  With
    ``mask_prompt`` the tower also takes the soft mask crops (Q, S, S):
    ``visual_apply(crops, mask_crops)``, the mask-adapted towers' prompt
    (``clip_mask_adapted.adapted_clip_crop_classify``)."""
    mean = torch.tensor(CLIP_PIXEL_MEAN, dtype=frames_raw.dtype, device=frames_raw.device)
    std = torch.tensor(CLIP_PIXEL_STD, dtype=frames_raw.dtype, device=frames_raw.device)
    logits, valid = [], []
    for frame, masks_f in zip(frames_raw, masks):               # (H, W, 3), (Q, h, w)
        boxes, ok = mask_square_boxes(masks_f)
        crops = roi_crop(frame[None], boxes * mask_stride, input_resolution, sampling_ratio)
        mask_crops = roi_crop(masks_f[..., None], boxes, input_resolution, sampling_ratio)
        blended = crops * mask_crops                             # bg -> 0 (adapter.py:115)
        clip_in = (blended / 255.0 - mean) / std
        feats = (visual_apply(clip_in, mask_crops[..., 0]) if mask_prompt
                 else visual_apply(clip_in))                     # (Q, D)
        feats = feats / (torch.linalg.vector_norm(feats, dim=-1, keepdim=True) + 1e-6)
        logits.append(temperature * feats @ text_feats.T)
        valid.append(ok)
    return torch.stack(logits), torch.stack(valid)


def frame_average_scores(
    clip_logits: torch.Tensor,  # (T, Q, K)
    valid: torch.Tensor,        # (T, Q)
    mode: str = "logits_then_softmax",
    drop_last: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query average over the valid frames, in either of the reference's
    orders: the mean of the logits, then one softmax (OpenVIS,
    openvis.py:138-142, ``logits_then_softmax``); or the bg column dropped, a
    softmax a frame, then the mean of the probabilities (the SimpleBSL
    ensemble, simplebsl.py:139-152, ``softmax_then_mean``).  Returns
    (scores (Q, K'), query_valid (Q,))."""
    x = clip_logits[..., :-1] if drop_last else clip_logits
    v = valid[..., None].to(x.dtype)
    cnt = v.sum(dim=0).clamp(min=1.0)
    if mode == "logits_then_softmax":
        scores = torch.softmax((x * v).sum(dim=0) / cnt, dim=-1)
    elif mode == "softmax_then_mean":
        scores = (torch.softmax(x, dim=-1) * v).sum(dim=0) / cnt
    else:
        raise ValueError(mode)
    return scores, valid.any(dim=0)
