"""Point sampling of mask logits for the criterion.

Port of ``openvis_tpu/ops/point_sample.py``: bilinear sampling of (H, W) maps
at normalized [0, 1]^2 points with the ``grid_sample(align_corners=False)``
convention (pixel = p * size - 0.5, zero padding), written as 4-corner
gathers.  The JAX package's corner- and bit-packed target tables
(``:101-281``) are bit-exact repackings for TPU gathers; the port keeps the
plain layout.

Routing of the batched samplers, as in the JAX package (``:337-389``): maps
of at most ``KERNEL_MAX_HW`` pixels on a CUDA device go to the hand-written
kernels K5/K6 (``ops/point_sample_cuda.py``, which compute in f32); larger
maps (the full-resolution targets) and CPU tensors take the gather
composition here, differentiated by autograd.
"""

from __future__ import annotations

from typing import Sequence

import torch

from openvis_tpu_torch.ops import point_sample_cuda

# the JAX package's _PALLAS_MAX_HW: the stride-4 prediction masks take the
# kernel, the full-resolution target masks the gather composition
KERNEL_MAX_HW = 1 << 16


def _corners(coords: torch.Tensor, h: int, w: int, cdt: torch.dtype):
    """Per point, the 4 (flat index, weight x in-bounds) pairs, in the order
    (0, 0), (0, 1), (1, 0), (1, 1)."""
    x = coords[..., 0] * w - 0.5
    y = coords[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    lx = (x - x0).to(cdt)
    ly = (y - y0).to(cdt)
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    one = torch.ones((), dtype=cdt, device=coords.device)
    out = []
    for dy, dx, wgt in ((0, 0, (one - ly) * (one - lx)), (0, 1, (one - ly) * lx),
                        (1, 0, ly * (one - lx)), (1, 1, ly * lx)):
        yy = y0i + dy
        xx = x0i + dx
        inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        out.append((idx, wgt * inb.to(cdt)))
    return out


def point_sample(maps: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """maps (..., H, W), coords (..., P, 2) in [0, 1] (x, y) with the same
    batch dims -> (..., P), in the maps' dtype."""
    h, w = maps.shape[-2:]
    flat = maps.reshape(*maps.shape[:-2], h * w)
    out = None
    for idx, wgt in _corners(coords, h, w, maps.dtype):
        term = torch.gather(flat, -1, idx) * wgt
        out = term if out is None else out + term
    return out


def point_sample_shared_t(flat_t: torch.Tensor, h: int, w: int, coords: torch.Tensor,
                          f32_policy: bool = False) -> torch.Tensor:
    """``point_sample_shared`` on a pre-transposed (H*W, R) matrix; coords
    (P, 2) -> (R, P).  ``f32_policy``: rows are widened to f32 after the
    gather (exact for bf16 rows)."""
    cdt = torch.float32 if f32_policy else flat_t.dtype
    out = None
    for idx, wgt in _corners(coords, h, w, cdt):
        term = flat_t[idx].to(cdt) * wgt[:, None]     # (P, R) row gather
        out = term if out is None else out + term
    return out.T


def point_sample_shared(maps: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """maps (R, H, W) all sampled at the points (P, 2) -> (R, P)."""
    r, h, w = maps.shape
    return point_sample_shared_t(maps.reshape(r, h * w).T, h, w, coords)


def sorted_uniform_points(generator: torch.Generator, batch: Sequence[int],
                          p: int) -> torch.Tensor:
    """(*batch, P, 2) f32 random points (x, y) with y ascending per batch
    item, drawn on the generator's device: P iid U(0, 1)^2 points sorted by
    y, generated as the normalized partial sums of P + 1 iid Exp(1) spacings
    (the order statistics), with x iid uniform."""
    batch = tuple(batch)
    dev = generator.device
    e = torch.empty((*batch, p + 1), dtype=torch.float32, device=dev)
    e.exponential_(generator=generator)
    s = torch.cumsum(e, dim=-1)
    ys = s[..., :-1] / s[..., -1:]
    xs = torch.rand((*batch, p), generator=generator, dtype=torch.float32, device=dev)
    return torch.stack([xs, ys], dim=-1)


def sample_maps_shared_t_plain(flat_t: torch.Tensor, h: int, w: int, coords: torch.Tensor,
                               f32_policy: bool = False) -> torch.Tensor:
    """Batched ``point_sample_shared_t``: (B, H*W, R), (B, P, 2) -> (B, R, P)."""
    return torch.stack([point_sample_shared_t(ft, h, w, c, f32_policy)
                        for ft, c in zip(flat_t, coords)])


def sample_maps_shared_plain(maps: torch.Tensor, coords: torch.Tensor,
                             f32_policy: bool = False) -> torch.Tensor:
    """The gather composition of the batched sampler: maps (B, R, H, W),
    coords (B, P, 2) -> (B, R, P); the plain version K5 is held to."""
    b, r, h, w = maps.shape
    if f32_policy:
        maps = maps.float()
    return sample_maps_shared_t_plain(maps.reshape(b, r, h * w).transpose(1, 2), h, w, coords)


def sample_maps_dvalue_plain(maps: torch.Tensor, coords: torch.Tensor,
                             grad: torch.Tensor) -> torch.Tensor:
    """The maps' gradient of ``sample_maps_shared_plain`` (f32 policy) by
    autograd, in the maps' dtype; the plain version K6 is held to."""
    with torch.enable_grad():
        m = maps.detach().float().requires_grad_()
        out = sample_maps_shared_plain(m, coords)
        (dm,) = torch.autograd.grad(out, (m,), grad.float())
    return dm.to(maps.dtype)


def _use_kernel(t: torch.Tensor, h: int, w: int, f32_policy: bool) -> bool:
    if t.device.type != "cuda" or h * w > KERNEL_MAX_HW:
        return False
    if t.dtype == torch.bfloat16 and not f32_policy:
        raise NotImplementedError(
            "bf16 point sampling (criterion.bf16_masks) has no CUDA kernel yet"
        )
    return True


def sample_maps_shared(maps: torch.Tensor, coords: torch.Tensor,
                       f32_policy: bool = False) -> torch.Tensor:
    """maps (B, R, H, W), coords (B, P, 2) -> (B, R, P).  ``f32_policy``:
    sample bf16 maps in f32 (exact widening)."""
    h, w = maps.shape[-2:]
    if _use_kernel(maps, h, w, f32_policy):
        return point_sample_cuda.SharedPointSample.apply(maps, coords.float())
    return sample_maps_shared_plain(maps, coords, f32_policy)


def sample_maps_shared_t(flat_t: torch.Tensor, h: int, w: int, coords: torch.Tensor,
                         f32_policy: bool = False) -> torch.Tensor:
    """Pre-transposed rows (B, H*W, R), coords (B, P, 2) -> (B, R, P)."""
    if _use_kernel(flat_t, h, w, f32_policy):
        b, hw, r = flat_t.shape
        maps = flat_t.transpose(1, 2).reshape(b, r, h, w)
        return point_sample_cuda.SharedPointSample.apply(maps, coords.float())
    return sample_maps_shared_t_plain(flat_t, h, w, coords, f32_policy)
