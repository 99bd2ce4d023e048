"""ctypes wrapper of the CUDA MSDA forward kernel (``csrc/msda_fwd.cu``).

Counterpart of ``openvis_tpu/ops/msda_pallas.py::ms_deform_attn_pallas_fwd``
(the fused all-level kernel).  The kernel is built at first use; a CUDA tensor
either launches it or raises, there is no fallback.  ``launches`` counts the
successful launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from openvis_tpu_torch.ops import cuda_build

launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_LEVELS = 8  # kMaxLevels in msda_fwd.cu


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = cuda_build.load("msda_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.msda_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p, p]
    lib.msda_fwd.restype = ctypes.c_int
    return lib


def ms_deform_attn_cuda(
    value: torch.Tensor,                         # (B, Len_in, nh, ch) f32 | bf16
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,            # (B, Lq, nh, nl, P, 2) f32
    attention_weights: torch.Tensor,             # (B, Lq, nh, nl, P) f32 | bf16
) -> torch.Tensor:                               # (B, Lq, nh * ch), value dtype
    global launches
    tensors = (value, sampling_locations, attention_weights)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("ms_deform_attn_cuda needs CUDA tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("ms_deform_attn_cuda: tensors on different devices")
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
        raise ValueError("ms_deform_attn_cuda needs contiguous tensors")
    b, len_in, nh, ch = value.shape
    nl = len(spatial_shapes)
    _, lq, _, _, p, _ = sampling_locations.shape
    if not 1 <= nl <= _MAX_LEVELS:
        raise ValueError(f"1..{_MAX_LEVELS} levels supported, got {nl}")
    if sampling_locations.shape != (b, lq, nh, nl, p, 2):
        raise ValueError(f"bad sampling_locations shape {tuple(sampling_locations.shape)}")
    if attention_weights.shape != (b, lq, nh, nl, p):
        raise ValueError(f"bad attention_weights shape {tuple(attention_weights.shape)}")
    hws, start = [], 0
    for h, w in spatial_shapes:
        hws += [int(h), int(w), start]
        start += int(h) * int(w)
    if start != len_in:
        raise ValueError(f"value length {len_in} != sum of {list(spatial_shapes)}")

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
