"""Multi-process data parallelism over ``torch.distributed``, one process a card.

Counterpart of ``openvis_tpu/parallel/mesh.py``.  The JAX package runs one
program over a global array and XLA inserts the reductions; here each process
holds its slice of the global batch and the collectives are explicit:

  * ``init_distributed``: the rendezvous (``mesh.py:23-41``'s arguments, or
    ``torchrun``'s environment), NCCL for CUDA and gloo for the CPU;
  * ``rank`` / ``world``: 0 / 1 without a process group;
  * ``per_process_batch``: the split of ``solver.ims_per_batch``;
  * ``all_reduce_sum`` and ``all_reduce_grads``: sums over the processes, the
    gradients as one flat f32 buffer (one call, not one per tensor);
  * ``all_gather_rows``: the processes' tensors concatenated on the first
    axis, differentiable (BriVIS's global brownian pool);
  * ``gather_to_rank0`` and ``barrier``.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world() -> int:
    return dist.get_world_size() if initialized() else 1


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device="cuda") -> None:
    """Join the process group.  ``coordinator``: ``host:port`` of rank 0 (or
    an init-method URL such as ``file://...``); omitted arguments are read
    from ``torchrun``'s environment (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``).  On CUDA the process takes the
    card ``LOCAL_RANK`` (else ``process_id`` modulo the cards)."""
    device = torch.device(device)
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if coordinator:
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    else:
        init_method = "env://"
    kwargs = {"backend": "gloo"}
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kwargs = {"backend": "nccl", "device_id": torch.device("cuda", local)}
    dist.init_process_group(init_method=init_method, world_size=num_processes, rank=process_id,
                            **kwargs)


def per_process_batch(ims_per_batch: int) -> int:
    """This process's share of the global batch (the reference's per-rank
    DataLoader split, build.py:23-37)."""
    n = world()
    if ims_per_batch % n:
        raise ValueError(f"solver.ims_per_batch={ims_per_batch} must divide by the "
                         f"{n} processes")
    return ims_per_batch // n


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the processes, in place; ``t`` without a process
    group."""
    if not initialized():
        return t
    dist.all_reduce(t)
    return t


def all_reduce_grads(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The f32 tensors summed over the processes through one flat buffer;
    the tensors themselves without a process group."""
    if not initialized():
        return list(tensors)
    flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in tensors]))
    return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


class _AllGatherRows(torch.autograd.Function):
    """Forward: every process's (n, ...) rows concatenated in rank order.
    Backward: the gradient of the concatenation summed over the processes
    (each process's loss reads every row), of which this process keeps its
    own rows; an all-reduce, as gloo has no reduce-scatter."""

    @staticmethod
    def forward(ctx, x):
        ctx.n = x.shape[0]
        parts = [torch.empty_like(x) for _ in range(world())]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = all_reduce_sum(grad.contiguous().clone())
        return grad[rank() * ctx.n:(rank() + 1) * ctx.n]


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The processes' ``x`` (same shape on each) concatenated on axis 0 in
    rank order, with the gradient returned to each row's owner; ``x``
    without a process group."""
    if not initialized():
        return x
    return _AllGatherRows.apply(x)


def gather_to_rank0(obj: Any) -> Optional[List[Any]]:
    """Every process's ``obj`` on rank 0, in rank order (None elsewhere)."""
    out = [None] * world() if rank() == 0 else None
    dist.gather_object(obj, out, dst=0)
    return out


def barrier() -> None:
    if initialized():
        dist.barrier()
