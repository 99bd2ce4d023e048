"""Swin Transformer backbone (T/S/B/L).

Port of ``openvis_tpu/models/backbone/swin.py``: a 4x4 patch embedding,
stages of [W-MSA | SW-MSA] blocks with a relative position bias, patch
merging between stages and a LayerNorm on each output stage; features
(C, 2C, 4C, 8C) at strides (4, 8, 16, 32).  The blocks run NHWC, as in the
JAX package; the trunk takes and returns NCHW maps like the ResNet.

  * each block pads its map after ``norm1`` to whole windows, rolls it by
    ``ws // 2`` on odd blocks (whatever the map's size) with the shift mask
    built on the padded grid, and crops after the attention;
  * the attention adds the relative position bias and, shifted, the mask,
    and takes its softmax in f32;
  * the MLP's GELU is the exact (erf) one;
  * the absolute position embedding (``ape``) is resized from the
    pretraining grid with torch's bicubic (a = -0.75, no antialias);
  * stochastic depth follows ``linspace(0, drop_path_rate, sum(depths))``
    and is active only inside ``dropout_generator(generator)``, which the
    train step's loss enters (the JAX package applies it only when a
    ``dropout`` rng is given): one keep draw per sample from that generator,
    the kept samples scaled by ``1 / keep``.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from openvis_tpu_torch.models.amp import amp_norm, softmax_f32
from openvis_tpu_torch.utils.image import resize_bicubic_torch_hw

LN_EPS = 1e-6  # flax LayerNorm default

SWIN_SHAPES = {
    "tiny": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "small": dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "base": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
    "large": dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48)),
}

_DROPOUT: contextvars.ContextVar[Optional[torch.Generator]] = contextvars.ContextVar(
    "swin_dropout_generator", default=None)


@contextlib.contextmanager
def dropout_generator(generator: torch.Generator):
    """Stochastic depth on, drawing from ``generator``, for the forwards run
    inside (the train step's loss)."""
    token = _DROPOUT.set(generator)
    try:
        yield
    finally:
        _DROPOUT.reset(token)


def feature_channels(embed_dim: int) -> Dict[str, int]:
    return {f"res{i + 2}": embed_dim * 2 ** i for i in range(4)}


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C); H, W divisible by ws."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(wins: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = wins.shape[0] // ((h // ws) * (w // ws))
    x = wins.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) index into the ((2 ws - 1)^2, heads) bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return (rel[:, :, 0] * (2 * ws - 1) + rel[:, :, 1]).astype(np.int64)


def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws*ws, ws*ws) additive mask of the shifted windows on the (h, w)
    grid: -100 between tokens of different regions."""
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    wins = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    mask = wins[:, None, :] - wins[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(window_size).reshape(-1)), persistent=False)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        bnw, n, c = x.shape
        h = self.num_heads
        dh = c // h
        qkv = self.qkv(x).reshape(bnw, n, 3, h, dh)
        q, k, v = qkv.unbind(2)
        # sqrt(dh) rounded to the compute dtype, as the JAX package divides
        scale = torch.tensor(float(dh), dtype=q.dtype).sqrt().item()
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) / scale
        bias = self.relative_position_bias_table[self.relative_position_index]
        attn = attn + bias.reshape(n, n, h).permute(2, 0, 1)[None].to(attn.dtype)
        if attn_mask is not None:                                    # (nW, n, n)
            nw = attn_mask.shape[0]
            attn = (attn.reshape(bnw // nw, nw, h, n, n)
                    + attn_mask[None, :, None].to(attn.dtype)).reshape(bnw, h, n, n)
        attn = softmax_f32(attn, dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(bnw, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift: int = 0,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, drop_path: float = 0.0):
        super().__init__()
        self.window_size, self.shift, self.drop_path = window_size, shift, drop_path
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, num_heads, window_size, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self._masks: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}

    def _drop(self, y: torch.Tensor) -> torch.Tensor:
        gen = _DROPOUT.get()
        if self.drop_path == 0.0 or gen is None:
            return y
        keep = 1.0 - self.drop_path
        p = torch.full((y.shape[0], 1, 1, 1), keep, device=gen.device)
        mask = torch.bernoulli(p, generator=gen).to(y.device, y.dtype)
        return y * mask / keep

    def _shift_mask(self, ph: int, pw: int, device) -> torch.Tensor:
        key = (ph, pw, torch.device(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(
                shift_attn_mask(ph, pw, self.window_size, self.shift)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:              # (B, H, W, C)
        b, h, w, c = x.shape
        ws, s = self.window_size, self.shift
        ph, pw = -(-h // ws) * ws, -(-w // ws) * ws
        y = F.pad(amp_norm(self.norm1, x), (0, 0, 0, pw - w, 0, ph - h))
        mask = None
        if s > 0:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
            mask = self._shift_mask(ph, pw, y.device)
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, ph, pw)
        if s > 0:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + self._drop(y[:, :h, :w])
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(amp_norm(self.norm2, x))))
        return x + self._drop(y)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = x.reshape(b, (h + h % 2) // 2, 2, (w + w % 2) // 2, 2, c)
        # torch's order: (0::2, 0::2), (1::2, 0::2), (0::2, 1::2), (1::2, 1::2)
        x = torch.cat([x[:, :, 0, :, 0], x[:, :, 1, :, 0], x[:, :, 0, :, 1], x[:, :, 1, :, 1]],
                      dim=-1)
        return self.reduction(amp_norm(self.norm, x))


class SwinTransformer(nn.Module):
    """NCHW image -> {res2..res5} NCHW features of widths C, 2C, 4C, 8C."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, patch_size: int = 4, qkv_bias: bool = True,
                 drop_path_rate: float = 0.0, patch_norm: bool = True, ape: bool = False,
                 pretrain_img_size: int = 224,
                 out_features: Sequence[str] = ("res2", "res3", "res4", "res5")):
        super().__init__()
        self.depths, self.out_features = tuple(depths), tuple(out_features)
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.patch_norm = nn.LayerNorm(embed_dim, eps=LN_EPS) if patch_norm else None
        self.absolute_pos_embed = None
        if ape:
            g = pretrain_img_size // patch_size
            self.absolute_pos_embed = nn.Parameter(torch.zeros(1, g, g, embed_dim))
        rates = np.linspace(0, drop_path_rate, sum(depths))
        dim, cur = embed_dim, 0
        for si, depth in enumerate(depths):
            for bi in range(depth):
                self.add_module(f"stage{si}_block{bi}", SwinBlock(
                    dim, num_heads[si], window_size,
                    shift=0 if bi % 2 == 0 else window_size // 2, mlp_ratio=mlp_ratio,
                    qkv_bias=qkv_bias, drop_path=float(rates[cur + bi])))
            cur += depth
            if f"res{si + 2}" in self.out_features:
                self.add_module(f"out_norm{si}", nn.LayerNorm(dim, eps=LN_EPS))
            if si < len(depths) - 1:
                self.add_module(f"downsample{si}", PatchMerging(dim))
                dim *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.patch_embed(x).permute(0, 2, 3, 1)                  # NHWC
        if self.patch_norm is not None:
            x = amp_norm(self.patch_norm, x)
        if self.absolute_pos_embed is not None:
            pe = resize_bicubic_torch_hw(self.absolute_pos_embed.float().permute(0, 3, 1, 2),
                                         tuple(x.shape[1:3]))
            x = x + pe.permute(0, 2, 3, 1).to(x.dtype)
        outs = {}
        for si, depth in enumerate(self.depths):
            for bi in range(depth):
                x = getattr(self, f"stage{si}_block{bi}")(x)
            name = f"res{si + 2}"
            if name in self.out_features:
                y = amp_norm(getattr(self, f"out_norm{si}"), x)
                outs[name] = y.permute(0, 3, 1, 2).contiguous()
            if si < len(self.depths) - 1:
                x = getattr(self, f"downsample{si}")(x)
        return outs
