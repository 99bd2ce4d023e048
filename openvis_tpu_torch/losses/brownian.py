"""Brownian-bridge contrastive criterion (BriVIS).

Port of ``openvis_tpu/losses/brownian.py``: a track's normalised per-frame
embeddings should follow a Brownian bridge from its head (frame 0) to its tail
(frame T-1).  A random middle frame's deviation from the bridge,
``exp(-||e_mid - (1-a) e_head - a e_tail||^2 / (2 sigma^2))``, is contrasted
against the 5 hardest negatives: every other track's embedding at the same
frame.  A Softplus head-tail matching term joins it.

The (n, n) negative distances come from two contractions (``||e_j||^2 +
||p_i||^2 - 2 e_j . p_i``), never the (n, n, t, c) tensor.  The middle frames
come from an explicit ``torch.Generator`` through ``draw_mid(generator, n,
t) -> (n,)`` (default ``uniform_mid``), so a test can hand in JAX's draws.

Under a process group (``parallel/dist.py``) the pool is the global batch's,
as under the JAX package's jit over a mesh: the embeddings are gathered with
their gradient returned to their owners, every process draws the global
batch's middle frames and keeps its slice, and both terms are divided by the
global track count, so the processes' losses sum to the global loss.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from openvis_tpu_torch.parallel import dist

DrawMid = Callable[[torch.Generator, int, int], torch.Tensor]


def uniform_mid(generator: torch.Generator, n: int, t: int) -> torch.Tensor:
    """(n,) middle frames uniform in [1, t-1), as ``jax.random.randint``."""
    return torch.randint(1, t - 1, (n,), generator=generator, device=generator.device)


def brownian_bridge_loss(
    generator: torch.Generator,
    embeds: torch.Tensor,  # (B, T, Q, C) projected frame embeds
    delta: float = 0.3,
    topk: int = 5,
    neg_log: bool = True,
    draw_mid: DrawMid = uniform_mid,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (bc_loss, htm_loss), each this process's share of the global mean."""
    b, t, q, c = embeds.shape
    if t < 3:
        raise ValueError(f"the brownian bridge needs >= 3 frames, got {t}")
    n = b * q
    e = embeds.transpose(1, 2).reshape(n, t, c)
    e = e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-6)
    pool = dist.all_gather_rows(e)                              # (N, t, c)
    total = pool.shape[0]
    first = dist.rank() * n                                     # this process's rows
    mid = draw_mid(generator, total, t)[first:first + n].to(e.device)

    head, tail = e[:, 0], e[:, -1]                              # (n, c)
    midf = mid.float()
    alpha = (midf / (t - 1))[:, None]
    sigma = alpha[:, 0] * ((t - 1) - midf)
    e_mid = torch.gather(e, 1, mid[:, None, None].expand(n, 1, c))[:, 0]
    proj = (1 - alpha) * head + alpha * tail                    # (n, c)
    d_pos = -((e_mid - proj) ** 2).sum(-1) / (2 * sigma ** 2)   # (n,)

    # negatives: every other track's embedding at our middle frame
    dots_all = (proj @ pool.reshape(total * t, c).T).view(n, total, t)
    dots = torch.gather(dots_all, 2, mid[:, None, None].expand(n, total, 1))[..., 0]
    nsq = (pool * pool).sum(-1).T[mid]                          # (n, N): ||e_j[mid_i]||^2
    psq = (proj * proj).sum(-1)[:, None]
    d_neg = -(nsq + psq - 2.0 * dots) / (2 * sigma[:, None] ** 2)
    rows = torch.arange(n, device=e.device)[:, None]
    own = torch.arange(total, device=e.device)[None, :] == rows + first
    d_neg = torch.where(own, torch.full((), -10000.0, device=e.device), d_neg)
    d_top = torch.topk(d_neg, min(topk, total - 1) if total > 1 else 1, dim=-1).values

    numer = torch.exp(d_pos)
    ratio = numer / (numer + torch.exp(d_top).sum(-1))
    bc = (-torch.log(ratio + 1e-12) if neg_log else ratio).sum() / total
    score = (head * tail).sum(-1)
    htm = torch.logaddexp(delta - score, torch.zeros((), device=e.device)).sum() / total
    return bc, htm
