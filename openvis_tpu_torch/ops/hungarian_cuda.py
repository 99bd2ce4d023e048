"""ctypes wrapper of the CUDA batched Hungarian kernel (``csrc/hungarian.cu``).

Counterpart of ``openvis_tpu/ops/hungarian_pallas.py::batched_hungarian_pallas``.
The kernel is built at first use; a CUDA tensor either launches it or raises,
there is no fallback.  ``launches`` counts the successful launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from openvis_tpu_torch.ops import cuda_build

launches = 0

_MAX_SMEM = 232448  # shared memory one block may use on sm_90


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = cuda_build.load("hungarian")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hungarian_solve.argtypes = [p, p, i, i, i, p]
    lib.hungarian_solve.restype = ctypes.c_int
    return lib


def smem_bytes(n: int, m: int) -> int:
    """Shared memory of one problem: the cost rows plus the solver state
    (``smem_bytes`` in hungarian.cu)."""
    return 4 * (n * m + n + 5 * m + 3)


def batched_hungarian_cuda(cost: torch.Tensor) -> torch.Tensor:
    """cost (B, N, M) float32 on the card, N <= M -> (B, N) int64 column of
    each row; the assignment has minimum total cost."""
    global launches
    if not cost.is_cuda:
        raise ValueError("batched_hungarian_cuda needs a CUDA tensor")
    if cost.dtype != torch.float32:
        raise TypeError(f"cost must be float32, got {cost.dtype}")
    if cost.dim() != 3:
        raise ValueError(f"cost must be (B, N, M), got {tuple(cost.shape)}")
    if not cost.is_contiguous():
        raise ValueError("batched_hungarian_cuda needs a contiguous tensor")
    b, n, m = cost.shape
    if n > m:
        raise ValueError(f"hungarian needs rows <= cols, got {tuple(cost.shape)}")
    if smem_bytes(n, m) > _MAX_SMEM:
        raise ValueError(
            f"a {n}x{m} problem needs {smem_bytes(n, m)} B of shared memory, "
            f"more than the {_MAX_SMEM} B a block may use"
        )
    out = torch.empty((b, n), dtype=torch.int32, device=cost.device)
    if b == 0 or n == 0:
        return out.long()
    stream = torch.cuda.current_stream(cost.device).cuda_stream
    err = library().hungarian_solve(cost.data_ptr(), out.data_ptr(), b, n, m, stream)
    if err != 0:
        raise RuntimeError(f"hungarian kernel launch failed: CUDA error {err}")
    launches += 1
    return out.long()
