"""MasQCLIP's CLIP tower: a CLIP ViT with mask class tokens.

Port of ``openvis_tpu/models/clip_masq.py:38-162`` (the reference's
``MasQCLIPAdapter``, ``masqclip_adapter.py:45-265``).  Q mask class tokens
(``mask_embeddings`` + ``class_embedding``, no positional embedding) go in
front of the CLIP tokens (cls + patches).  In every block the CLIP tokens run
plain self-attention among themselves on a DETACHED copy of their LayerNorm
output, and each mask token queries the CLIP tokens' keys and values through
its own ``new_q_proj``, restricted to its instance's patches and the cls
token.  So the loss reaches the tower only through the mask tokens: the
projections' ``k``/``v``/``out``, the MLPs, the norms, ``new_q_proj``,
``class_embedding``, ``mask_embeddings`` and ``proj`` get gradients; ``conv1``,
``positional_embedding`` and ``q_proj`` none.

The allow mask (JAX ``:127-141``): the masks bilinear (no antialias) to the
patch grid's pixels, max-pooled by the patch, ``> 0``; the cls column is
always allowed, so an all-empty mask still attends to one key.  The
disallowed columns carry ``-inf`` in the activations' dtype.

Parameter names are JAX's: ``conv1``, ``class_embedding``,
``positional_embedding``, ``mask_embeddings``, ``ln_pre``,
``resblock{i}/attn/{q,k,v,out,new_q}_proj``, ``resblock{i}/ln_{1,2}``,
``resblock{i}/mlp_c_fc``, ``resblock{i}/mlp_c_proj``, ``ln_post``, ``proj``.

Dtypes under AMP follow JAX op by op: everything runs in the activations'
dtype (bf16) except the LayerNorms, which compute in f32 and cast back.  The
softmaxes take and return the activations' dtype (torch's kernel accumulates
in f32 inside; JAX's runs in bf16), and so does the final normalisation
``f / (|f| + 1e-6)``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from openvis_tpu_torch.models.clip.model import (
    CLIP_PIXEL_MEAN,
    CLIP_PIXEL_STD,
    LayerNormF32,
    quick_gelu,
    resize_pos_embed,
)
from openvis_tpu_torch.utils.image import resize_bicubic_torch_hw, resize_bilinear_torch_hw


def _scale(dh: int, dtype: torch.dtype) -> float:
    """1 / sqrt(dh) rounded to ``dtype`` (JAX: ``1 / sqrt(asarray(dh, dtype))``),
    computed on the host."""
    return float(1.0 / torch.tensor(float(dh), dtype=dtype).sqrt())


class MasQAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        for name in ("q_proj", "k_proj", "v_proj", "new_q_proj", "out_proj"):
            self.add_module(name, nn.Linear(width, width))

    def forward(self, x: torch.Tensor, nq: int, bias: torch.Tensor) -> torch.Tensor:
        """x (B, nq+1+L, C), the mask tokens first; ``bias`` (B, 1, nq, 1+L)
        additive, 0 where a mask token may attend and -inf elsewhere."""
        b, n, c = x.shape
        h = self.heads
        dh = c // h
        clip_tok = x[:, nq:].detach()                                    # (B, 1+L, C)
        lk = n - nq

        def heads(t, length):
            return t.reshape(b, length, h, dh).transpose(1, 2)           # (B, H, len, dh)

        q = heads(self.q_proj(clip_tok), lk)
        k = heads(self.k_proj(clip_tok), lk)
        v = heads(self.v_proj(clip_tok), lk)
        scale = _scale(dh, x.dtype)
        clip_out = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1) @ v
        new_q = heads(self.new_q_proj(x[:, :nq]), nq)
        mask_out = torch.softmax((new_q @ k.transpose(-1, -2)) * scale + bias, dim=-1) @ v
        out = torch.cat([mask_out, clip_out], dim=2)                     # (B, H, n, dh)
        return self.out_proj(out.transpose(1, 2).reshape(b, n, c))


class MasQBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = LayerNormF32(width)
        self.attn = MasQAttention(width, heads)
        self.ln_2 = LayerNormF32(width)
        self.mlp_c_fc = nn.Linear(width, width * 4)
        self.mlp_c_proj = nn.Linear(width * 4, width)

    def forward(self, x: torch.Tensor, nq: int, bias: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), nq, bias)
        return x + self.mlp_c_proj(quick_gelu(self.mlp_c_fc(self.ln_2(x))))


def allow_bias(masks: torch.Tensor, grid_hw: Tuple[int, int], patch: int,
               dtype: torch.dtype) -> torch.Tensor:
    """masks (B, Q, H, W) logits -> (B, 1, Q, 1+h*w) additive attention bias:
    0 for the cls column and for a patch whose max-pooled mask (bilinear to
    the grid's pixels first) is > 0, -inf elsewhere, in ``dtype``."""
    b, q = masks.shape[:2]
    gh, gw = grid_hw
    m = resize_bilinear_torch_hw(masks, (gh * patch, gw * patch))
    m = F.max_pool2d(m.reshape(b * q, 1, gh * patch, gw * patch), patch, patch)
    allow = torch.cat([torch.ones(b, q, 1, dtype=torch.bool, device=masks.device),
                       m.reshape(b, q, gh * gw) > 0.0], dim=-1)
    zero = torch.zeros((), dtype=dtype, device=masks.device)
    return torch.where(allow, zero, float("-inf"))[:, None]


class MasQCLIPVisual(nn.Module):
    """The CLIP ViT with ``new_q_proj`` in every block and the mask token."""

    def __init__(self, patch_size: int = 16, width: int = 768, layers: int = 12,
                 heads: int = 12, embed_dim: int = 512, image_size: int = 224):
        super().__init__()
        g = image_size // patch_size
        self.patch_size = patch_size
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(1 + g * g, width))
        self.mask_embeddings = nn.Parameter(torch.empty(width))
        self.ln_pre = LayerNormF32(width)
        for i in range(layers):
            self.add_module(f"resblock{i}", MasQBlock(width, heads))
        self.blocks = [getattr(self, f"resblock{i}") for i in range(layers)]
        self.ln_post = LayerNormF32(width)
        self.proj = nn.Parameter(torch.empty(width, embed_dim))

    def forward(self, images: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """images (B, S, S, 3) CLIP-normalised; masks (B, Q, S, S) logits at the
        input resolution -> (B, Q, D) mask-token features of unit norm."""
        b, q = masks.shape[:2]
        x = self.conv1(images.permute(0, 3, 1, 2))                      # (B, C, h, w)
        c, h, w = x.shape[1:]
        x = x.flatten(2).transpose(1, 2)                                 # (B, hw, C)
        cls = self.class_embedding.to(x.dtype).expand(b, 1, c)
        pos = resize_pos_embed(self.positional_embedding, (h, w))[None].to(x.dtype)
        clip_tok = torch.cat([cls, x], dim=1) + pos
        mask_tok = (self.mask_embeddings + self.class_embedding).to(x.dtype).expand(b, q, c)
        tokens = self.ln_pre(torch.cat([mask_tok, clip_tok], dim=1))
        bias = allow_bias(masks, (h, w), self.patch_size, tokens.dtype)
        for block in self.blocks:
            tokens = block(tokens, q, bias)
        feats = self.ln_post(tokens[:, :q]) @ self.proj
        return feats / (torch.linalg.vector_norm(feats, dim=-1, keepdim=True) + 1e-6)


def preprocess_frames(frames_raw: torch.Tensor, size: int) -> torch.Tensor:
    """(N, H, W, 3) in [0, 255] -> (N, size, size, 3) CLIP-normalised, bicubic
    (a = -0.75, no antialias; JAX ``clip_masq.py:155-162``)."""
    x = resize_bicubic_torch_hw((frames_raw / 255.0).permute(0, 3, 1, 2), (size, size))
    x = x.permute(0, 2, 3, 1)
    mean = torch.tensor(CLIP_PIXEL_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_PIXEL_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std
