"""Batched Hungarian assignment (Jonker-Volgenant shortest augmenting path).

Port of ``openvis_tpu/ops/hungarian.py``: rows are targets (N), columns are
predictions (M), N <= M, exact minimum total cost (ties may resolve otherwise
than scipy's ``linear_sum_assignment``; compare assignments by cost).

``batched_hungarian`` dispatches by the tensor's device: a CUDA tensor goes to
the hand-written kernel (``ops/hungarian_cuda.py``), a CPU tensor to
``hungarian_plain``, one problem at a time.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

_INF = 1e15


def hungarian_plain(cost: torch.Tensor, return_steps: bool = False
                    ) -> Union[torch.Tensor, Tuple[torch.Tensor, int]]:
    """(N, M) cost, N <= M -> (N,) int64 column of each row; with
    ``return_steps``, also the number of Dijkstra steps the solve took (the
    sequential chain whose length sets the kernel's time).

    The e-maxx loop of ``openvis_tpu/ops/hungarian.py:28-97`` in f32, with
    each Dijkstra relaxation one vectorized O(M) update."""
    n, m = cost.shape
    if n > m:
        raise ValueError(f"hungarian needs rows <= cols, got {tuple(cost.shape)}")
    cost = cost.to(torch.float32)
    dev = cost.device
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros(m + 1, dtype=torch.float32, device=dev)
    p = torch.full((m + 1,), -1, dtype=torch.int64, device=dev)
    steps = 0
    for i in range(n):
        p[m] = i
        minv = torch.full((m,), _INF, dtype=torch.float32, device=dev)
        used = torch.zeros(m + 1, dtype=torch.bool, device=dev)
        way = torch.zeros(m, dtype=torch.int64, device=dev)
        j0 = m
        while int(p[j0]) >= 0:
            steps += 1
            used[j0] = True
            i0 = int(p[j0])
            cur = cost[i0] - u[i0] - v[:m]
            better = (cur < minv) & ~used[:m]
            minv = torch.where(better, cur, minv)
            way = torch.where(better, j0, way)
            cand = torch.where(used[:m], _INF, minv)
            j1 = int(torch.argmin(cand))   # first minimum, like jnp.argmin
            delta = cand[j1]
            u[p[used]] += delta            # used columns own distinct rows
            v = v - torch.where(used, delta, 0.0)
            minv = minv - torch.where(used[:m], 0.0, delta)
            j0 = j1
        while j0 != m:
            j1 = int(way[j0])
            p[j0] = p[j1]
            j0 = j1
    col_of_row = torch.zeros(n, dtype=torch.int64, device=dev)
    assigned = p[:m] >= 0
    col_of_row[p[:m][assigned]] = torch.arange(m, device=dev)[assigned]
    return (col_of_row, steps) if return_steps else col_of_row


def batched_hungarian(cost: torch.Tensor) -> torch.Tensor:
    """(B, N, M) -> (B, N) int64.  Assignment is not differentiable: the cost
    is detached."""
    cost = cost.detach().to(torch.float32).contiguous()
    if cost.device.type == "cuda":
        from openvis_tpu_torch.ops.hungarian_cuda import batched_hungarian_cuda

        return batched_hungarian_cuda(cost)
    if cost.device.type == "cpu":
        return torch.stack([hungarian_plain(c) for c in cost])
    raise ValueError(f"batched_hungarian: no implementation for {cost.device}")
