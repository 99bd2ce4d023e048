"""ctypes wrappers of the CUDA MSDA kernels: K1 forward (``csrc/msda_fwd.cu``),
K2 dCoord/dAttn and K3 dValue (``csrc/msda_bwd.cu``).

Counterparts of ``openvis_tpu/ops/msda_pallas.py::_msda_fused`` (forward) and
``_msda_bwd_fused`` (backward).  The kernels are built at first use; a CUDA
tensor either launches them or raises, there is no fallback.  ``launches``
(K1), ``dcoord_launches`` (K2) and ``dvalue_launches`` (K3) count the
successful launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from openvis_tpu_torch.ops import cuda_build

launches = 0
dcoord_launches = 0
dvalue_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_LEVELS = 8  # kMaxLevels in msda_fwd.cu and msda_bwd.cu


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = cuda_build.load("msda_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.msda_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p, p]
    lib.msda_fwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def bwd_library() -> ctypes.CDLL:
    lib = cuda_build.load("msda_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.msda_bwd_dcoord.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p, p]
    lib.msda_bwd_dcoord.restype = ctypes.c_int
    lib.msda_bwd_dvalue.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p, p]
    lib.msda_bwd_dvalue.restype = ctypes.c_int
    return lib


def _check(value, spatial_shapes, sampling_locations, attention_weights,
           grad_out=None) -> List[int]:
    """Validate the kernels' inputs; returns the flat (h, w, start) level
    table."""
    tensors = [value, sampling_locations, attention_weights]
    if grad_out is not None:
        tensors.append(grad_out)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the MSDA kernels need CUDA tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the MSDA kernels: tensors on different devices")
    if value.dtype not in _DTYPE_CODES or attention_weights.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"value/attention dtypes must be float32 or bfloat16, got "
            f"{value.dtype}/{attention_weights.dtype}"
        )
    if sampling_locations.dtype != torch.float32:
        raise TypeError(
            f"sampling locations must be float32, got {sampling_locations.dtype}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the MSDA kernels need contiguous tensors")
    b, len_in, nh, ch = value.shape
    nl = len(spatial_shapes)
    _, lq, _, _, p, _ = sampling_locations.shape
    if not 1 <= nl <= _MAX_LEVELS:
        raise ValueError(f"1..{_MAX_LEVELS} levels supported, got {nl}")
    if sampling_locations.shape != (b, lq, nh, nl, p, 2):
        raise ValueError(f"bad sampling_locations shape {tuple(sampling_locations.shape)}")
    if attention_weights.shape != (b, lq, nh, nl, p):
        raise ValueError(f"bad attention_weights shape {tuple(attention_weights.shape)}")
    if grad_out is not None:
        if grad_out.shape != (b, lq, nh * ch):
            raise ValueError(f"bad grad_out shape {tuple(grad_out.shape)}")
        if grad_out.dtype != value.dtype:
            raise TypeError(f"grad_out must be {value.dtype}, got {grad_out.dtype}")
    hws, start = [], 0
    for h, w in spatial_shapes:
        hws += [int(h), int(w), start]
        start += int(h) * int(w)
    if start != len_in:
        raise ValueError(f"value length {len_in} != sum of {list(spatial_shapes)}")
    return hws


def ms_deform_attn_cuda(
    value: torch.Tensor,                         # (B, Len_in, nh, ch) f32 | bf16
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,            # (B, Lq, nh, nl, P, 2) f32
    attention_weights: torch.Tensor,             # (B, Lq, nh, nl, P) f32 | bf16
) -> torch.Tensor:                               # (B, Lq, nh * ch), value dtype
    """K1: the MSDA forward."""
    global launches
    hws = _check(value, spatial_shapes, sampling_locations, attention_weights)
    b, len_in, nh, ch = value.shape
    _, lq, _, nl, p, _ = sampling_locations.shape
    out = torch.empty((b, lq, nh * ch), dtype=value.dtype, device=value.device)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    err = library().msda_fwd(
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[value.dtype], _DTYPE_CODES[attention_weights.dtype],
        b, len_in, lq, nh, ch, nl, p, (ctypes.c_int * len(hws))(*hws), stream,
    )
    if err != 0:
        raise RuntimeError(f"msda_fwd kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _bwd_args(value, spatial_shapes, sampling_locations, attention_weights, grad_out):
    hws = _check(value, spatial_shapes, sampling_locations, attention_weights, grad_out)
    b, len_in, nh, ch = value.shape
    _, lq, _, nl, p, _ = sampling_locations.shape
    dims = (_DTYPE_CODES[value.dtype], _DTYPE_CODES[attention_weights.dtype],
            b, len_in, lq, nh, ch, nl, p, (ctypes.c_int * len(hws))(*hws),
            torch.cuda.current_stream(value.device).cuda_stream)
    return dims


def msda_dcoord_cuda(value, spatial_shapes, sampling_locations, attention_weights,
                     grad_out) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: (dloc f32, dattn in the weights' dtype)."""
    global dcoord_launches
    dims = _bwd_args(value, spatial_shapes, sampling_locations, attention_weights, grad_out)
    dloc = torch.empty_like(sampling_locations)
    dattn = torch.empty_like(attention_weights)
    err = bwd_library().msda_bwd_dcoord(
        value.data_ptr(), sampling_locations.data_ptr(), attention_weights.data_ptr(),
        grad_out.data_ptr(), dloc.data_ptr(), dattn.data_ptr(), *dims,
    )
    if err != 0:
        raise RuntimeError(f"msda_bwd_dcoord kernel launch failed: CUDA error {err}")
    dcoord_launches += 1
    return dloc, dattn


def msda_dvalue_cuda(value, spatial_shapes, sampling_locations, attention_weights,
                     grad_out) -> torch.Tensor:
    """K3: dvalue in the value's dtype, from f32 atomics into a zeroed
    scratch."""
    global dvalue_launches
    dims = _bwd_args(value, spatial_shapes, sampling_locations, attention_weights, grad_out)
    dvalue32 = torch.zeros(value.shape, dtype=torch.float32, device=value.device)
    err = bwd_library().msda_bwd_dvalue(
        sampling_locations.data_ptr(), attention_weights.data_ptr(),
        grad_out.data_ptr(), dvalue32.data_ptr(), *dims,
    )
    if err != 0:
        raise RuntimeError(f"msda_bwd_dvalue kernel launch failed: CUDA error {err}")
    dvalue_launches += 1
    return dvalue32.to(value.dtype)


def ms_deform_attn_bwd_cuda(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    grad_out: torch.Tensor,                      # (B, Lq, nh * ch), value dtype
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 then K3: (dvalue in value's dtype, dloc f32, dattn in the weights'
    dtype)."""
    dloc, dattn = msda_dcoord_cuda(value, spatial_shapes, sampling_locations,
                                   attention_weights, grad_out)
    dvalue = msda_dvalue_cuda(value, spatial_shapes, sampling_locations,
                              attention_weights, grad_out)
    return dvalue, dloc, dattn
