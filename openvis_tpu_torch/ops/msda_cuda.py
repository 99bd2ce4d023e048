"""ctypes wrappers of the CUDA MSDA kernels: K1 forward (``csrc/msda_fwd.cu``),
K2 dCoord/dAttn and K3 dValue (``csrc/msda_bwd.cu``).

Counterparts of ``openvis_tpu/ops/msda_pallas.py::_msda_fused`` (forward) and
``_msda_bwd_fused`` (backward).  The kernels are built at first use; a CUDA
tensor either launches them or raises, there is no fallback.  ``launches``
(K1), ``dcoord_launches`` (K2) and ``dvalue_launches`` (K3) count the
successful launches.

K1 and K2 come in two instantiations of one kernel each; ``launch_plan``
picks one from the shape, the value dtype and the pointers' alignment, and
computes the grid:

  * ``MAIN``: the main path's 3 levels, 4 points and 32 channels, specialised
    at compile time, with 16-byte loads (8 bf16 or 4 f32 values) of values,
    locations and weights and int32 offsets (every pointer 16-byte aligned,
    the extents below 2**31);
  * ``GENERIC``: everything else, one value per load and int64 offsets.

Each (batch, query, head) is a group of ``lanes`` consecutive threads (a
power of two up to 32); each lane owns ``vec`` consecutive channels, or every
``lanes * vec``-th run of them when the channels are more.  Outputs are fresh
``torch.empty`` tensors, which the caching allocator aligns to 512 bytes.

K3 has its own plan, ``dvalue_plan``: the channels per lane and the lanes
per (batch, query, head), the queries of one block's tile and the most
pixels a level's band may have to be binned in shared memory;
``band_share`` says how much of a call's work the bins take.

The plans are made here, not in the C launchers, so that the choice can be
tested without ``nvcc`` or a card (``tests/test_torch_port_msda_launch.py``,
``tests/test_torch_port_scatter_plan.py``), reported by ``chip_smoke.py``,
and forced to time one instantiation or branch against the other
(``tools/torch_bench_msda_variants.py``,
``tools/torch_bench_scatter_variants.py``).  The C side keeps its own copy
of the constants and checks each plan's preconditions again, only to refuse
a plan whose kernel would read or write out of bounds or misaligned.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from openvis_tpu_torch.ops import cuda_build

launches = 0
dcoord_launches = 0
dvalue_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# as in csrc/msda_common.cuh: kMaxLevels, the variants (kMain, kGeneric), the
# main path's (levels, points, channels) and kThreads
_MAX_LEVELS = 8
MAIN, GENERIC = 0, 1
MAIN_SHAPE = (3, 4, 32)
THREADS = 256  # per block
_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    variant: int     # MAIN or GENERIC
    vec: int         # channels per load: 16 bytes' worth, or 1
    lanes: int       # threads per (batch, query, head)
    blocks: int      # of THREADS threads

    @property
    def lanes_log2(self) -> int:
        return self.lanes.bit_length() - 1


def launch_plan(value, sampling_locations, attention_weights, grad_out=None) -> LaunchPlan:
    """The K1 (``grad_out`` None) or K2 instantiation and grid for these
    tensors; reads only their shapes, dtypes and data pointers."""
    b, len_in, nh, ch = value.shape
    _, lq, _, nl, p, _ = sampling_locations.shape
    vec16 = 16 // value.element_size()
    tensors = [value, sampling_locations, attention_weights]
    if grad_out is not None:
        tensors.append(grad_out)
    groups = b * lq * nh
    if ((nl, p, ch) == MAIN_SHAPE and all(t.data_ptr() % 16 == 0 for t in tensors)
            and groups * (ch // vec16) <= _INT32_MAX and len_in * nh * ch <= _INT32_MAX):
        variant, vec = MAIN, vec16
    else:
        variant, vec = GENERIC, 1
    lanes = 1
    while lanes < min(-(-ch // vec), 32):
        lanes *= 2
    return LaunchPlan(variant, vec, lanes, -(-groups * lanes // THREADS))


# as in csrc/msda_bwd.cu: K3's table and binned-list bytes per sample, the
# 16-bit fields of a list entry, and the most dynamic shared memory a block
# may use on sm_90 (less 1 KB for static shared variables)
DV_TABLE_BYTES = 24
DV_LIST_BYTES = 16
DV_MAX_ENTRIES = 1 << 16
MAX_SMEM = 232448 - 1024
# K3's choices: queries per block, a block's shared memory (six blocks fit
# on an SM) and the least of it left to the band's bins (2047 pixels)
DV_TILE_QUERIES = 64
DV_SMEM_TARGET = 34 * 1024
DV_MIN_BAND_BYTES = 16 * 1024
# a level's band is binned only where it has at most this many pixels per
# corner add of the tile (as for K6)
DV_BIN_PIXELS_PER_ADD = 2


@dataclasses.dataclass(frozen=True)
class DValuePlan:
    vec: int           # channels per lane and reduction: 4, or 1
    lanes: int         # threads per (batch, query, head) or band pixel
    tile_queries: int  # consecutive queries per block (one head)
    band_pixels: int   # the most pixels a level's band may have to be binned
    fixed_bytes: int   # the table, the gradient tile and the list

    @property
    def lanes_log2(self) -> int:
        return self.lanes.bit_length() - 1

    @property
    def smem_bytes(self) -> int:
        return self.fixed_bytes + 4 * (2 * self.band_pixels + 1)

    def grid(self, batch: int, len_q: int, n_heads: int):
        return (-(-len_q // self.tile_queries), n_heads, batch)


def _dv_fixed_bytes(tq: int, p: int, ch: int) -> int:
    """csrc/msda_bwd.cu's dv_smem_bytes without the bins."""
    return (-(-tq * p * DV_TABLE_BYTES // 16) * 16 + 4 * (-(-tq * ch // 4) * 4)
            + DV_LIST_BYTES * tq * p)


def dvalue_plan(value, sampling_locations, band_bytes: Optional[int] = None) -> DValuePlan:
    """K3's plan for these shapes: 4 channels a lane where the channels are a
    multiple of 4; DV_TILE_QUERIES queries a block (fewer if the table,
    gradient tile and list would leave the bins less than
    DV_MIN_BAND_BYTES of DV_SMEM_TARGET).
    ``band_bytes`` (default: what DV_SMEM_TARGET leaves, and at most
    DV_BIN_PIXELS_PER_ADD pixels per corner add) is the room of the band's
    bins, 8 bytes a pixel; 0 sends every level straight to the output."""
    ch = value.shape[3]
    p = sampling_locations.shape[4]
    vec = 4 if ch % 4 == 0 else 1
    lanes = 1
    while lanes < min(-(-ch // vec), 32):
        lanes *= 2
    tq = DV_TILE_QUERIES
    while tq > 1 and (_dv_fixed_bytes(tq, p, ch) > DV_SMEM_TARGET - DV_MIN_BAND_BYTES
                      or 4 * tq * p > DV_MAX_ENTRIES):
        tq //= 2
    fixed = _dv_fixed_bytes(tq, p, ch)
    if fixed + 4 > MAX_SMEM or 4 * tq * p > DV_MAX_ENTRIES:
        raise ValueError(f"K3 cannot take {p} points and {ch} channels in one block's shared memory")
    if band_bytes is None:
        band_bytes = min(DV_SMEM_TARGET - fixed, 4 + 8 * DV_BIN_PIXELS_PER_ADD * 4 * tq * p)
    band_bytes = max(4, min(band_bytes, MAX_SMEM - fixed))
    return DValuePlan(vec, lanes, tq, (band_bytes - 4) // 8, fixed)


def band_share(spatial_shapes, sampling_locations, plan: DValuePlan) -> float:
    """The share of K3's corner adds that go through the shared-memory bins
    for these locations and this plan, by the kernel's rule (host side, any
    device): a (batch, head, tile, level) is binned when its corner rows x
    the level's width fit ``plan.band_pixels``."""
    b, lq, nh = sampling_locations.shape[:3]
    tq = plan.tile_queries
    pad = -(-lq // tq) * tq - lq
    total = band = 0.0
    for lvl, (h, w) in enumerate(spatial_shapes):
        loc = sampling_locations[:, :, :, lvl].float()          # (B, Lq, nh, P, 2)
        x = loc[..., 0] * float(w) - 0.5
        y = loc[..., 1] * float(h) - 0.5
        inside = (x > -1) & (y > -1) & (x < w) & (y < h)
        x0, y0 = torch.floor(x), torch.floor(y)
        corners = (((y0 >= 0) & (x0 >= 0)).int() + ((y0 >= 0) & (x0 + 1 < w)).int()
                   + ((y0 + 1 < h) & (x0 >= 0)).int() + ((y0 + 1 < h) & (x0 + 1 < w)).int())
        corners = torch.where(inside, corners, 0)
        lo = torch.where(inside, y0.clamp(min=0), float(h))
        hi = torch.where(inside, (y0 + 1).clamp(max=h - 1), -1.0)

        def tiles(t, v, reduce):  # (B, Lq, nh, P) -> (B, nh, tiles)
            t = torch.nn.functional.pad(t.permute(0, 2, 3, 1), (0, pad), value=v)
            return reduce(t.reshape(b, nh, t.shape[2], -1, tq), (2, 4))

        lo = tiles(lo, float(h), torch.amin)
        hi = tiles(hi, -1.0, torch.amax)
        n = tiles(corners.double(), 0.0, torch.sum)
        fits = (hi - lo + 1).clamp(min=0) * w <= plan.band_pixels
        total += n.sum().item()
        band += n[fits].sum().item()
    return band / total if total else 0.0


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = cuda_build.load("msda_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    q = ctypes.c_longlong
    lib.msda_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p, i, i, q, p]
    lib.msda_fwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def bwd_library() -> ctypes.CDLL:
    lib = cuda_build.load("msda_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    q = ctypes.c_longlong
    lib.msda_bwd_dcoord.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p, i, i, q, p]
    lib.msda_bwd_dcoord.restype = ctypes.c_int
    lib.msda_bwd_dvalue.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p, i, i, i, i, p]
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
    return _validate(value, spatial_shapes, sampling_locations, attention_weights, grad_out)


def _validate(value, spatial_shapes, sampling_locations, attention_weights,
              grad_out=None) -> List[int]:
    """The checks of ``_check`` that do not depend on the device."""
    tensors = [value, sampling_locations, attention_weights]
    if grad_out is not None:
        tensors.append(grad_out)
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
    plan = launch_plan(value, sampling_locations, attention_weights)
    out = torch.empty((b, lq, nh * ch), dtype=value.dtype, device=value.device)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    err = library().msda_fwd(
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[value.dtype], _DTYPE_CODES[attention_weights.dtype],
        b, len_in, lq, nh, ch, nl, p, (ctypes.c_int * len(hws))(*hws),
        plan.variant, plan.lanes_log2, plan.blocks, stream,
    )
    if err != 0:
        raise RuntimeError(f"msda_fwd kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _bwd_args(value, spatial_shapes, sampling_locations, attention_weights, grad_out):
    """The dtype codes, extents and level table of both backward kernels."""
    hws = _check(value, spatial_shapes, sampling_locations, attention_weights, grad_out)
    b, len_in, nh, ch = value.shape
    _, lq, _, nl, p, _ = sampling_locations.shape
    return (_DTYPE_CODES[value.dtype], _DTYPE_CODES[attention_weights.dtype],
            b, len_in, lq, nh, ch, nl, p, (ctypes.c_int * len(hws))(*hws))


def msda_dcoord_cuda(value, spatial_shapes, sampling_locations, attention_weights,
                     grad_out) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: (dloc f32, dattn in the weights' dtype)."""
    global dcoord_launches
    dims = _bwd_args(value, spatial_shapes, sampling_locations, attention_weights, grad_out)
    plan = launch_plan(value, sampling_locations, attention_weights, grad_out)
    dloc = torch.empty_like(sampling_locations)
    dattn = torch.empty_like(attention_weights)
    err = bwd_library().msda_bwd_dcoord(
        value.data_ptr(), sampling_locations.data_ptr(), attention_weights.data_ptr(),
        grad_out.data_ptr(), dloc.data_ptr(), dattn.data_ptr(), *dims,
        plan.variant, plan.lanes_log2, plan.blocks,
        torch.cuda.current_stream(value.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"msda_bwd_dcoord kernel launch failed: CUDA error {err}")
    dcoord_launches += 1
    return dloc, dattn


def msda_dvalue_cuda(value, spatial_shapes, sampling_locations, attention_weights,
                     grad_out) -> torch.Tensor:
    """K3: dvalue in the value's dtype, from f32 adds (binned by band pixel
    in shared memory and summed, or straight) into a zeroed scratch."""
    global dvalue_launches
    dims = _bwd_args(value, spatial_shapes, sampling_locations, attention_weights, grad_out)
    plan = dvalue_plan(value, sampling_locations)
    dvalue32 = torch.zeros(value.shape, dtype=torch.float32, device=value.device)
    err = bwd_library().msda_bwd_dvalue(
        sampling_locations.data_ptr(), attention_weights.data_ptr(),
        grad_out.data_ptr(), dvalue32.data_ptr(), *dims,
        plan.vec, plan.lanes_log2, plan.tile_queries, plan.band_pixels,
        torch.cuda.current_stream(value.device).cuda_stream,
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
