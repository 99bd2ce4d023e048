"""ctypes wrappers of the CUDA shared-point sampler (``csrc/point_sample.cu``):
K5 forward and K6 dValue, joined by :class:`SharedPointSample`.

Counterparts of ``openvis_tpu/ops/point_sample_pallas.py::_ps_fwd`` /
``_ps_bwd`` behind ``_ps_op``'s custom VJP: the maps get a gradient, the
points none.  The kernels are built at first use; a CUDA tensor either
launches them or raises, there is no fallback.  ``fwd_launches`` (K5) and
``dvalue_launches`` (K6) count the successful launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from openvis_tpu_torch.ops import cuda_build

fwd_launches = 0
dvalue_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = cuda_build.load("point_sample")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.point_sample_fwd.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.point_sample_fwd.restype = ctypes.c_int
    lib.point_sample_dvalue.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.point_sample_dvalue.restype = ctypes.c_int
    return lib


def _check_coords(coords: torch.Tensor, b: int, device) -> int:
    if not coords.is_cuda or coords.device != device:
        raise ValueError("the point-sampler kernels need all tensors on one CUDA device")
    if coords.dtype != torch.float32:
        raise TypeError(f"points must be float32, got {coords.dtype}")
    if coords.dim() != 3 or coords.shape[0] != b or coords.shape[2] != 2:
        raise ValueError(f"points must be ({b}, P, 2), got {tuple(coords.shape)}")
    if not coords.is_contiguous():
        raise ValueError("the point-sampler kernels need contiguous tensors")
    return coords.shape[1]


def point_sample_fwd_cuda(maps: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """K5: maps (B, R, H, W) f32 | bf16, coords (B, P, 2) f32 normalized
    (x, y) -> (B, R, P) f32 samples, computed in f32."""
    global fwd_launches
    if not maps.is_cuda:
        raise ValueError("point_sample_fwd_cuda needs CUDA tensors")
    if maps.dtype not in _DTYPE_CODES:
        raise TypeError(f"maps must be float32 or bfloat16, got {maps.dtype}")
    if maps.dim() != 4 or not maps.is_contiguous():
        raise ValueError(f"maps must be a contiguous (B, R, H, W), got {tuple(maps.shape)}")
    b, r, h, w = maps.shape
    p = _check_coords(coords, b, maps.device)
    out = torch.empty((b, r, p), dtype=torch.float32, device=maps.device)
    stream = torch.cuda.current_stream(maps.device).cuda_stream
    err = library().point_sample_fwd(maps.data_ptr(), coords.data_ptr(), out.data_ptr(),
                                     _DTYPE_CODES[maps.dtype], b, r, h, w, p, stream)
    if err != 0:
        raise RuntimeError(f"point_sample_fwd kernel launch failed: CUDA error {err}")
    fwd_launches += 1
    return out


def point_sample_dvalue_cuda(coords: torch.Tensor, grad: torch.Tensor,
                             map_shape, map_dtype: torch.dtype) -> torch.Tensor:
    """K6: the maps' gradient (B, R, H, W) in ``map_dtype`` from the samples'
    gradient ``grad`` (B, R, P) f32; f32 atomics into a zeroed scratch."""
    global dvalue_launches
    if not grad.is_cuda:
        raise ValueError("point_sample_dvalue_cuda needs CUDA tensors")
    b, r, h, w = map_shape
    p = _check_coords(coords, b, grad.device)
    if grad.dtype != torch.float32 or tuple(grad.shape) != (b, r, p):
        raise ValueError(f"grad must be float32 ({b}, {r}, {p}), got "
                         f"{grad.dtype} {tuple(grad.shape)}")
    if not grad.is_contiguous():
        raise ValueError("the point-sampler kernels need contiguous tensors")
    dmaps = torch.zeros((b, r, h, w), dtype=torch.float32, device=grad.device)
    stream = torch.cuda.current_stream(grad.device).cuda_stream
    err = library().point_sample_dvalue(coords.data_ptr(), grad.data_ptr(),
                                        dmaps.data_ptr(), b, r, h, w, p, stream)
    if err != 0:
        raise RuntimeError(f"point_sample_dvalue kernel launch failed: CUDA error {err}")
    dvalue_launches += 1
    return dmaps.to(map_dtype)


class SharedPointSample(torch.autograd.Function):
    """K5 forward, K6 backward; the points get no gradient."""

    @staticmethod
    def forward(ctx, maps, coords):
        maps, coords = maps.contiguous(), coords.contiguous()
        ctx.save_for_backward(coords)
        ctx.map_shape, ctx.map_dtype = tuple(maps.shape), maps.dtype
        return point_sample_fwd_cuda(maps, coords)

    @staticmethod
    def backward(ctx, grad):
        (coords,) = ctx.saved_tensors
        dmaps = None
        if ctx.needs_input_grad[0]:
            dmaps = point_sample_dvalue_cuda(coords, grad.float().contiguous(),
                                             ctx.map_shape, ctx.map_dtype)
        return dmaps, None
