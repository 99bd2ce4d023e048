"""ctypes wrappers of the CUDA shared-point sampler (``csrc/point_sample.cu``):
K5 forward and K6 dValue, joined by :class:`SharedPointSample`.

Counterparts of ``openvis_tpu/ops/point_sample_pallas.py::_ps_fwd`` /
``_ps_bwd`` behind ``_ps_op``'s custom VJP: the maps get a gradient, the
points none.  The kernels are built at first use; a CUDA tensor either
launches them or raises, there is no fallback.  ``fwd_launches`` (K5) and
``dvalue_launches`` (K6) count the successful launches.

K5 is a row-looping gather: one block per (batch item, tile of points, chunk
of rows), a thread computing its points' corners and weights once and then
sampling them in every row of the chunk; ``fwd_plan`` picks the points per
thread and the chunk.

K6 is a scatter privatised in shared memory: one block per (batch item, tile
of ``tile_points`` points, chunk of ``row_chunk`` rows) bins its corner adds
by the pixel of the band of map rows they land on, in shared memory, and
sums each pixel once, when the band has at most ``band_pixels`` pixels;
otherwise it adds straight into the output.  ``dvalue_plan`` makes the plan
here, so that a CPU test can hold it, ``band_share`` says how much of a
call's work the bins take, and ``tools/torch_bench_scatter_variants.py``
can force either branch.  The C side keeps its own copy of the limits and
refuses a plan beyond them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import torch

from openvis_tpu_torch.ops import cuda_build

fwd_launches = 0
dvalue_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# as in csrc/point_sample.cu: kFwdThreads, kMaxGridYZ
FWD_THREADS = 128
MAX_GRID_YZ = 65535
# K5's plan: rows per block, and the fewest blocks a call should have (two per
# SM of an H100, which has 132) before the chunk is cut to make more
FWD_ROW_CHUNK = 8
FWD_MIN_BLOCKS = 2 * 132
# as in csrc/point_sample.cu: kThreads, kMaxTilePoints, kTableBytes,
# kListBytes, kMaxRowChunk, kMaxSmem
THREADS = 256
MAX_TILE_POINTS = 1024
TABLE_BYTES = 32      # per point: four int32 corner offsets, four f32 weights
LIST_BYTES = 16       # per point: four binned-list entries
ROW_CHUNK = 8         # rows a block takes, summed in registers
MAX_SMEM = 232448 - 1024     # dynamic shared memory a block may use on sm_90
# the plan's choice of a block's shared memory (five blocks fit on an SM)
SMEM_TARGET = 40 * 1024
# a band is binned only where it has at most this many pixels per corner add
# of its tile: each binned pixel costs a scan step and a visit, and sparse
# tiles (the criterion's 3136 random points) are faster with direct adds
BIN_PIXELS_PER_ADD = 2


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    vec: int         # consecutive points per thread (2: 8-byte stores)
    row_chunk: int   # rows per block, sharing each thread's corners and weights

    @property
    def tile_points(self) -> int:
        return FWD_THREADS * self.vec

    def grid(self, batch: int, rows: int, n_points: int):
        return (-(-n_points // self.tile_points), -(-rows // self.row_chunk), batch)


def fwd_plan(map_shape, n_points: int, aligned: bool = True) -> FwdPlan:
    """K5's points per thread and rows per block for maps (B, R, H, W) and P
    points: 2 points where 16-byte point loads and 8-byte stores are aligned
    (P even and ``aligned``, the points' address a multiple of 16), else 1;
    FWD_ROW_CHUNK rows, halved while the call has fewer than FWD_MIN_BLOCKS
    blocks, and never so few that the chunks overrun the grid."""
    b, r, _, _ = map_shape
    if b > MAX_GRID_YZ:
        raise ValueError(f"K5 takes at most {MAX_GRID_YZ} batch items, got {b}")
    vec = 2 if n_points % 2 == 0 and aligned else 1
    plan = FwdPlan(vec, max(1, min(r, FWD_ROW_CHUNK)))
    while plan.row_chunk > 1 and math.prod(plan.grid(b, r, n_points)) < FWD_MIN_BLOCKS:
        plan = FwdPlan(vec, -(-plan.row_chunk // 2))
    return FwdPlan(vec, max(plan.row_chunk, -(-r // MAX_GRID_YZ)))


@dataclasses.dataclass(frozen=True)
class DValuePlan:
    tile_points: int   # consecutive points per block
    row_chunk: int     # rows per block, sharing the tile's corner table and bins
    band_pixels: int   # the most pixels a tile's band may have to be binned

    @property
    def smem_bytes(self) -> int:
        fixed = self.tile_points * (TABLE_BYTES + LIST_BYTES + 4 * self.row_chunk)
        return fixed + 4 * (2 * self.band_pixels + 1)

    def grid(self, batch: int, rows: int, n_points: int):
        return (-(-n_points // self.tile_points), -(-rows // self.row_chunk), batch)


def dvalue_plan(map_shape, n_points: int, band_bytes: Optional[int] = None) -> DValuePlan:
    """K6's tiles and band room for maps (B, R, H, W) and P points.  A tile
    holds about P/H points (a multiple of 32, 32..1024): y-sorted points then
    span ~1 map row, so with the bilinear corners a band of ~3 rows; a block
    takes ROW_CHUNK rows.  ``band_bytes`` (default: what SMEM_TARGET leaves
    beside the table, the list and the gradient rows, and at most
    BIN_PIXELS_PER_ADD pixels per corner add) is the room of the band's
    bins, 8 bytes a pixel; 0 sends every tile straight to the output."""
    _, r, h, _ = map_shape
    tp = -(-n_points // max(h, 1))
    tp = min(max(-(-tp // 32) * 32, 32), MAX_TILE_POINTS)
    rc = max(1, min(r, ROW_CHUNK))
    fixed = tp * (TABLE_BYTES + LIST_BYTES + 4 * rc)
    if band_bytes is None:
        band_bytes = min(SMEM_TARGET - fixed, 4 + 8 * BIN_PIXELS_PER_ADD * 4 * tp)
    band_bytes = max(4, min(band_bytes, MAX_SMEM - fixed))
    return DValuePlan(tp, rc, (band_bytes - 4) // 8)


def _pixel(c: torch.Tensor, size: int) -> torch.Tensor:
    """c * size - 0.5 in f32, two roundings, as the kernels compute it."""
    return c.float() * float(size) - 0.5


def band_share(coords: torch.Tensor, map_shape, plan: DValuePlan) -> float:
    """The share of K6's corner adds that go through the shared-memory bins
    for these points and this plan, by the kernel's rule (host side, any
    device): a tile is binned when its corner rows x W pixels fit
    ``plan.band_pixels``."""
    b, r, h, w = map_shape
    p = coords.shape[1]
    tp = plan.tile_points
    pad = -(-p // tp) * tp - p
    x = _pixel(coords[..., 0], w)
    y = _pixel(coords[..., 1], h)
    inside = (x > -1) & (y > -1) & (x < w) & (y < h)
    x0, y0 = torch.floor(x), torch.floor(y)
    corners = (((y0 >= 0) & (x0 >= 0)).int() + ((y0 >= 0) & (x0 + 1 < w)).int()
               + ((y0 + 1 < h) & (x0 >= 0)).int() + ((y0 + 1 < h) & (x0 + 1 < w)).int())
    corners = torch.where(inside, corners, 0)
    lo = torch.where(inside, y0.clamp(min=0), float(h))
    hi = torch.where(inside, (y0 + 1).clamp(max=h - 1), -1.0)
    pad_ = lambda t, v: torch.nn.functional.pad(t, (0, pad), value=v).view(b, -1, tp)
    lo = pad_(lo, float(h)).amin(-1)
    hi = pad_(hi, -1.0).amax(-1)
    per_tile = pad_(corners, 0).sum(-1).double()            # (B, tiles)
    fits = (hi - lo + 1).clamp(min=0) * w <= plan.band_pixels
    total = per_tile.sum().item()
    return per_tile[fits].sum().item() / total if total else 0.0


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = cuda_build.load("point_sample")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.point_sample_fwd.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
    lib.point_sample_fwd.restype = ctypes.c_int
    lib.point_sample_dvalue.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
    lib.point_sample_dvalue.restype = ctypes.c_int
    return lib


def _check_coords(coords: torch.Tensor, b: int) -> int:
    if coords.dtype != torch.float32:
        raise TypeError(f"points must be float32, got {coords.dtype}")
    if coords.dim() != 3 or coords.shape[0] != b or coords.shape[2] != 2:
        raise ValueError(f"points must be ({b}, P, 2), got {tuple(coords.shape)}")
    if not coords.is_contiguous():
        raise ValueError("the point-sampler kernels need contiguous tensors")
    return coords.shape[1]


def point_sample_fwd_cuda(maps: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """K5: maps (B, R, H, W) f32 | bf16, coords (B, P, 2) f32 normalized
    (x, y) -> (B, R, P) f32 samples, computed in f32 as the plain version
    does (the same products summed in the same order)."""
    global fwd_launches
    if maps.dtype not in _DTYPE_CODES:
        raise TypeError(f"maps must be float32 or bfloat16, got {maps.dtype}")
    if maps.dim() != 4 or not maps.is_contiguous():
        raise ValueError(f"maps must be a contiguous (B, R, H, W), got {tuple(maps.shape)}")
    b, r, h, w = maps.shape
    p = _check_coords(coords, b)
    plan = fwd_plan(maps.shape, p, aligned=coords.data_ptr() % 16 == 0)
    with cuda_build.launch_on(maps, coords) as stream:
        out = torch.empty((b, r, p), dtype=torch.float32, device=maps.device)
        err = library().point_sample_fwd(maps.data_ptr(), coords.data_ptr(), out.data_ptr(),
                                         _DTYPE_CODES[maps.dtype], b, r, h, w, p, plan.vec,
                                         plan.row_chunk, stream)
    if err != 0:
        raise RuntimeError(f"point_sample_fwd kernel launch failed: CUDA error {err}")
    fwd_launches += 1
    return out


def point_sample_dvalue_cuda(coords: torch.Tensor, grad: torch.Tensor,
                             map_shape, map_dtype: torch.dtype) -> torch.Tensor:
    """K6: the maps' gradient (B, R, H, W) in ``map_dtype`` from the samples'
    gradient ``grad`` (B, R, P) f32; f32 adds (binned in shared memory and
    summed per pixel, or direct atomics) into a zeroed scratch."""
    global dvalue_launches
    b, r, h, w = map_shape
    p = _check_coords(coords, b)
    if grad.dtype != torch.float32 or tuple(grad.shape) != (b, r, p):
        raise ValueError(f"grad must be float32 ({b}, {r}, {p}), got "
                         f"{grad.dtype} {tuple(grad.shape)}")
    if not grad.is_contiguous():
        raise ValueError("the point-sampler kernels need contiguous tensors")
    plan = dvalue_plan(map_shape, p)
    with cuda_build.launch_on(coords, grad) as stream:
        dmaps = torch.zeros((b, r, h, w), dtype=torch.float32, device=grad.device)
        err = library().point_sample_dvalue(coords.data_ptr(), grad.data_ptr(),
                                            dmaps.data_ptr(), b, r, h, w, p, plan.tile_points,
                                            plan.row_chunk, plan.band_pixels, stream)
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
