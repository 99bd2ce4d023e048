"""Query-embedding tracking (MinVIS).

Port of ``openvis_tpu/models/tracking.py:30-100`` for ``ema_alpha == 1``:
frame t's queries are aligned to frame t-1's by a Hungarian assignment on
(1 - cosine similarity).  The carried reference is the previous raw frame
row-permuted, so all T-1 consecutive-frame problems go to ONE batched solve
and the permutations are then composed in order.
"""

from __future__ import annotations

import torch

from openvis_tpu_torch.ops.hungarian import batched_hungarian


def _normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def track_by_embeds(pred_embeds: torch.Tensor, ema_alpha: float = 1.0) -> torch.Tensor:
    """pred_embeds (B, T, Q, C) -> indices (B, T, Q) int64 such that
    ``aligned[t, k] = raw[t, indices[t, k]]`` keeps identity k (frame-0 query
    order) over time.  Ties in the assignment may resolve otherwise than in the
    JAX package; both are optimal."""
    if ema_alpha != 1.0:
        raise NotImplementedError(
            "EMA tracking (OV2Seg) is not ported yet (ROADMAP.md, queue 1 item 8.5)"
        )
    embeds = _normalize(pred_embeds.detach())
    b, t, q, c = embeds.shape
    ident = torch.arange(q, device=embeds.device).expand(b, q)
    if t == 1:
        return ident[:, None].expand(b, t, q)
    prev = embeds[:, :-1].reshape(b * (t - 1), q, c)
    cur = embeds[:, 1:].reshape(b * (t - 1), q, c)
    cos = torch.einsum("bqc,bkc->bqk", prev, cur)
    # r[:, s, i] = frame-(s+1) column matched to frame-s row i
    r = batched_hungarian(1.0 - cos).view(b, t - 1, q)
    perms = [ident]
    for s in range(t - 1):
        perms.append(torch.gather(r[:, s], 1, perms[-1]))
    return torch.stack(perms, dim=1)


def apply_track_indices(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """x (B, T, Q, ...), indices (B, T, Q) -> x gathered into track order."""
    idx = indices.reshape(*indices.shape, *([1] * (x.dim() - 3))).expand_as(x)
    return torch.gather(x, 2, idx)
