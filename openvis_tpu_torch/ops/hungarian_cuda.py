"""ctypes wrapper of the CUDA batched Hungarian kernel (``csrc/hungarian.cu``).

Counterpart of ``openvis_tpu/ops/hungarian_pallas.py::batched_hungarian_pallas``.
The kernel is built at first use; a CUDA tensor either launches it or raises,
there is no fallback.  ``launches`` counts the successful launches.

Two instantiations: the warp solver (one warp per problem, its state in
registers) for M + 1 <= ``WARP_MAX_COLS`` columns, the virtual column
included, and the block solver (one block per problem, its state in shared
memory) for wider problems.  ``launch_plan`` makes the choice here, so that a
CPU test can hold it; the C side keeps its own copy of the limits and refuses
a plan beyond them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from openvis_tpu_torch.ops import cuda_build

launches = 0

# as in csrc/hungarian.cu: kWarpSolver, kBlockSolver, kWarpCols,
# kBlockMaxThreads, kMaxSmem
WARP, BLOCK = 0, 1
WARP_COLS = 4                      # columns per lane of the warp solver
WARP_MAX_COLS = 32 * WARP_COLS     # M + 1 the warp solver takes
BLOCK_MAX_THREADS = 256
MAX_SMEM = 232448 - 1024           # dynamic shared memory a block may use on sm_90


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    variant: int      # WARP or BLOCK
    smem_bytes: int   # dynamic shared memory of a block
    threads: int      # a block takes one problem


def warp_problem_bytes(n: int, m: int) -> int:
    """Shared memory of one warp-solver problem: its cost rows, shifted by up
    to 3 floats to the source's 16-byte phase, rounded to 16 bytes."""
    return 4 * (-(-(n * m + 3) // 4) * 4)


def block_smem_bytes(n: int, m: int) -> int:
    """Shared memory of one block-solver problem: the cost rows plus the
    solver state (u, v, minv, p, way, used)."""
    return 4 * (n * m + n + 5 * m + 3)


def launch_plan(n: int, m: int) -> LaunchPlan:
    """The instantiation, threads and shared memory of the block that takes
    one problem of n rows and m columns; raises for what neither solver
    takes.  A problem is one latency-bound chain of steps, so each has a
    block (on the main path, 9 or 20 problems: an SM each)."""
    if n > m:
        raise ValueError(f"hungarian needs rows <= cols, got {n}x{m}")
    if m + 1 <= WARP_MAX_COLS:
        return LaunchPlan(WARP, warp_problem_bytes(n, m), 32)
    smem = block_smem_bytes(n, m)
    if smem > MAX_SMEM:
        raise ValueError(f"a {n}x{m} problem needs {smem} B of shared memory, more than "
                         f"the {MAX_SMEM} B a block may use")
    return LaunchPlan(BLOCK, smem, min(BLOCK_MAX_THREADS, -(-(m + 1) // 32) * 32))


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = cuda_build.load("hungarian")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hungarian_solve.argtypes = [p, p, i, i, i, i, i, p]
    lib.hungarian_solve.restype = ctypes.c_int
    return lib


def batched_hungarian_cuda(cost: torch.Tensor) -> torch.Tensor:
    """cost (B, N, M) float32 on the card, N <= M -> (B, N) int64 column of
    each row; the assignment has minimum total cost."""
    global launches
    if cost.dtype != torch.float32:
        raise TypeError(f"cost must be float32, got {cost.dtype}")
    if cost.dim() != 3:
        raise ValueError(f"cost must be (B, N, M), got {tuple(cost.shape)}")
    if not cost.is_contiguous():
        raise ValueError("batched_hungarian_cuda needs a contiguous tensor")
    b, n, m = cost.shape
    plan = launch_plan(n, m)
    with cuda_build.launch_on(cost) as stream:
        out = torch.empty((b, n), dtype=torch.int64, device=cost.device)
        if b == 0 or n == 0:
            return out
        err = library().hungarian_solve(cost.data_ptr(), out.data_ptr(), b, n, m,
                                        plan.variant, plan.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"hungarian kernel launch failed: CUDA error {err}")
    launches += 1
    return out
