"""Multi-scale deformable attention (MSDeformAttn).

Port of ``openvis_tpu/ops/msda.py``.  Semantics: for each query, each head
samples ``P`` bilinear points per feature level (zero padding outside,
``align_corners=False``: pixel coordinate = loc * size - 0.5) and sums them
with softmaxed attention weights.

``ms_deform_attn`` dispatches by the device of its tensors:

  * a CUDA tensor goes through :class:`MSDeformAttnFunction`, whose forward
    is the hand-written kernel K1 and whose backward is K2 (sampling
    locations and attention weights) and K3 (values), all in
    ``ops/msda_cuda.py``;
  * a CPU tensor goes to ``ms_deform_attn_plain``, the 4-corner gather
    composition of ``ms_deform_attn_xla``, differentiated by autograd.

``ms_deform_attn_bwd_plain`` is that composition's gradient, the plain version
the backward kernels are held to.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from openvis_tpu_torch.ops import msda_cuda


def ms_deform_attn(
    value: torch.Tensor,                         # (B, Len_in, n_heads, ch)
    spatial_shapes: Sequence[Tuple[int, int]],   # [(H_l, W_l)] per level
    sampling_locations: torch.Tensor,            # (B, Len_q, n_heads, n_levels, P, 2) in [0,1]
    attention_weights: torch.Tensor,             # (B, Len_q, n_heads, n_levels, P)
) -> torch.Tensor:                               # (B, Len_q, n_heads * ch)
    if value.device.type == "cuda":
        return MSDeformAttnFunction.apply(
            value, sampling_locations, attention_weights,
            tuple((int(h), int(w)) for h, w in spatial_shapes),
        )
    if value.device.type == "cpu":
        return ms_deform_attn_plain(
            value, spatial_shapes, sampling_locations, attention_weights
        )
    raise ValueError(f"ms_deform_attn: no implementation for {value.device}")


class MSDeformAttnFunction(torch.autograd.Function):
    """K1 forward, K2 + K3 backward (``_make_msda``'s custom VJP in the JAX
    package).  Saves value, locations and weights; the gradients come back in
    the dtypes of their inputs (locations f32)."""

    @staticmethod
    def forward(ctx, value, loc, attn, spatial_shapes):
        value, loc, attn = value.contiguous(), loc.contiguous(), attn.contiguous()
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, loc, attn)
        return msda_cuda.ms_deform_attn_cuda(value, spatial_shapes, loc, attn)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        dvalue, dloc, dattn = msda_cuda.ms_deform_attn_bwd_cuda(
            value, ctx.spatial_shapes, loc, attn, grad_out.contiguous()
        )
        return dvalue, dloc, dattn, None


def ms_deform_attn_plain(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """4-corner gather composition of ``openvis_tpu/ops/msda.py::
    _sample_level``, computed in f32, returned in the value's dtype.  Defines
    the semantics the CUDA kernels are held to, gradients included: the pixel
    coordinate is ``loc * size - 0.5`` rounded as two f32 operations, so a
    point on a pixel centre (the ring-bias init puts every encoder sample
    there) takes the same side of the bilinear kink as in the JAX package
    and the kernels (``F.grid_sample`` rounds ``2 * loc - 1`` otherwise)."""
    b, len_in, nh, ch = value.shape
    lq, p = sampling_locations.shape[1], sampling_locations.shape[-2]
    if sum(h * w for h, w in spatial_shapes) != len_in:
        raise ValueError(f"value length {len_in} != sum of {list(spatial_shapes)}")
    v32 = value.float().transpose(1, 2)                  # (B, nh, Len, ch)
    loc = sampling_locations.float()
    attn = attention_weights.float()
    out = v32.new_zeros((b, nh, lq, ch))
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = v32[:, :, start : start + h * w]             # (B, nh, hw, ch)
        start += h * w
        x = loc[:, :, :, lvl, :, 0] * w - 0.5            # (B, Lq, nh, P)
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        lx, ly = x - x0, y - y0
        x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
        a = attn[:, :, :, lvl]
        for dy, dx, wgt in ((0, 0, (1 - ly) * (1 - lx)), (0, 1, (1 - ly) * lx),
                            (1, 0, ly * (1 - lx)), (1, 1, ly * lx)):
            yy, xx = y0i + dy, x0i + dx
            inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
            cw = (wgt * a * inb).permute(0, 2, 1, 3)     # (B, nh, Lq, P)
            idx = idx.permute(0, 2, 1, 3).reshape(b, nh, lq * p, 1)
            g = torch.gather(v, 2, idx.expand(b, nh, lq * p, ch))
            out = out + torch.einsum("bhqp,bhqpc->bhqc", cw, g.view(b, nh, lq, p, ch))
    return out.transpose(1, 2).reshape(b, lq, nh * ch).to(value.dtype)


def ms_deform_attn_bwd_plain(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    grad_out: torch.Tensor,                      # (B, Len_q, n_heads * ch)
    dvalue: bool = True,
    dcoords: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dvalue, dloc, dattn) of ``ms_deform_attn_plain`` by autograd, in f32
    arithmetic, returned in the dtypes of value, locations and weights.
    ``dvalue`` / ``dcoords`` select the gradients computed (K3's and K2's);
    the others are None."""
    with torch.enable_grad():
        v = value.detach().float().requires_grad_(dvalue)
        loc = sampling_locations.detach().float().requires_grad_(dcoords)
        attn = attention_weights.detach().float().requires_grad_(dcoords)
        out = ms_deform_attn_plain(v, spatial_shapes, loc, attn)
        wanted = [t for t in (v, loc, attn) if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad_out.float()))
    dv = next(grads).to(value.dtype) if dvalue else None
    dloc = next(grads).to(sampling_locations.dtype) if dcoords else None
    dattn = next(grads).to(attention_weights.dtype) if dcoords else None
    return dv, dloc, dattn
