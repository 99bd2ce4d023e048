"""Fixed-shape video inference postprocessing.

Port of ``openvis_tpu/models/postprocess.py:19-57``: flatten the (Q, K) score
grid, keep the top-k (query, class) pairs, gather their mask logits and report
each prediction's entropy.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def inference_video_topk(
    scores: torch.Tensor,                 # (Q, K) softmaxed, no no-object column
    mask_logits: torch.Tensor,            # (Q, T, H, W) raw per-frame query order
    topk: int,
    track_indices: Optional[torch.Tensor] = None,  # (T, Q): track k -> raw query at frame t
) -> Dict[str, torch.Tensor]:
    """The scores are in track order.  With ``track_indices`` only the
    selected masks are gathered from the raw per-frame order; without them
    the masks are already in track order (the CLIP ensemble aligns them all).
    The order is ``jax.lax.top_k``'s on the CPU: ties to the lower index, and
    a NaN score (an all-covered ModifiedResNet crop's) below every number, as
    XLA's total order puts the NaNs the CPU computes (sign bit set); the NaN
    scores themselves are kept."""
    q, k = scores.shape
    topk = min(topk, q * k)
    flat = scores.reshape(-1)
    key = torch.where(torch.isnan(flat), float("-inf"), flat)
    top_idx = torch.sort(key, descending=True, stable=True).indices[:topk]
    top_scores = flat[top_idx]
    labels = top_idx % k
    query_idx = torch.div(top_idx, k, rounding_mode="floor")
    sel_scores = scores[query_idx]                            # (topk, K)
    entropy = -(sel_scores * torch.log(sel_scores + 1e-12)).sum(dim=-1)
    if track_indices is None:
        masks = mask_logits[query_idx]                        # (topk, T, H, W)
    else:
        sel_idx = track_indices[:, query_idx]                 # (T, topk)
        frames = torch.arange(track_indices.shape[0], device=mask_logits.device)
        masks = mask_logits[sel_idx.T, frames[None, :]]       # (topk, T, H, W)
    return {
        "scores": top_scores,
        "labels": labels,
        "query_idx": query_idx,
        "entropy": entropy,
        "mask_logits": masks,
    }
