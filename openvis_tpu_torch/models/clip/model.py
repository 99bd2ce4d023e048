"""CLIP text and vision towers.

Port of ``openvis_tpu/models/clip/model.py`` (OpenAI's CLIP architecture):

  * QuickGELU, LayerNorm in f32 (eps 1e-5) cast back to the input's dtype;
  * attention as explicit products with an f32 softmax, as the JAX package
    writes it (no fused library call), so that under AMP the dtype islands
    are the same and in f32 the CPU parity is exact up to summation order;
  * the text tower: token and positional embeddings, a causal transformer,
    ``ln_final``, the feature at the EOT (argmax token) position, projected
    by ``text_projection``;
  * the ViT vision tower: patch conv, class token, positional embedding
    resized bicubically to the input's patch grid, ``ln_pre``, blocks,
    ``ln_post`` and ``proj``, with the block API ``embed`` /
    ``run_blocks(lo, hi, attn_bias, taps, sos_q)`` / ``finalize``;
  * SAN's biased attention (``side_adapter.py:237-270``): a per-head
    additive ``attn_bias``, or with ``sos_q`` the sos-split form whose bias
    covers the sos rows' context columns only;
  * ``_MODEL_SHAPES`` of the ViT and ModifiedResNet (RN50, RN101) CLIPs:
    ``vision_tower`` builds the ModifiedResNet of a tuple ``vision_layers``
    from ``models/clip_mask_adapted.py``.

Module and parameter names mirror the flax ones (``resblock{i}``, the
LayerNorm's inner ``ln``), so ``convert.params_from_flax`` maps a JAX or a
converted OpenAI tree onto the ``state_dict``.  Images are NHWC, as in the
JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from openvis_tpu_torch.utils.image import resize_bicubic_torch_hw

NEG_INF = -1e9


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class LayerNormF32(nn.Module):
    """LayerNorm computed in float32 then cast back (CLIP ``LayerNorm``)."""

    def __init__(self, width: int):
        super().__init__()
        self.ln = nn.LayerNorm(width, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ln = self.ln
        y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(),
                         ln.eps)
        return y.to(x.dtype)


class CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                attn_bias: Optional[torch.Tensor] = None, sos_q: int = 0) -> torch.Tensor:
        """x (B, L, C); ``attn_mask`` (L, L) and ``attn_bias`` (B, H, L, L)
        additive.

        ``sos_q > 0`` selects SAN's sos-split form: the first ``sos_q`` tokens
        are sos queries, the rest the context (cls and patches).  The
        reference's dense bias puts -100 on every context row's sos columns
        (e^-100 is below f32 resolution), so context rows are plain attention
        over the context; a sos row sees itself (bias 0, its column first) and
        the context, and ``attn_bias`` is then (B, H, sos_q, L - sos_q) on
        those context columns.  The dense (B, H, L, L) bias is never built."""
        b, l, c = x.shape
        h = self.heads
        dh = c // h
        q = self.q_proj(x).reshape(b, l, h, dh).transpose(1, 2)     # (B, H, L, dh)
        k = self.k_proj(x).reshape(b, l, h, dh).transpose(1, 2)
        v = self.v_proj(x).reshape(b, l, h, dh).transpose(1, 2)
        scale = math.sqrt(dh)
        if sos_q:
            if attn_mask is not None:
                raise ValueError("sos_q takes no attn_mask")
            q_s, q_c = q[:, :, :sos_q], q[:, :, sos_q:]
            k_s, k_c = k[:, :, :sos_q], k[:, :, sos_q:]
            v_s, v_c = v[:, :, :sos_q], v[:, :, sos_q:]
            ac = torch.softmax(((q_c @ k_c.transpose(-1, -2)) / scale).float(), dim=-1)
            out_c = ac.to(x.dtype) @ v_c                                 # (B, H, Lc, dh)
            l_self = (q_s * k_s).sum(-1, keepdim=True) / scale          # (B, H, sos_q, 1)
            l_ctx = (q_s @ k_c.transpose(-1, -2)) / scale
            if attn_bias is not None:
                l_ctx = l_ctx + attn_bias
            a = torch.softmax(torch.cat([l_self, l_ctx], dim=-1).float(), dim=-1).to(x.dtype)
            out_s = a[..., :1] * v_s + a[..., 1:] @ v_c
            out = torch.cat([out_s, out_c], dim=2)
        else:
            logits = (q @ k.transpose(-1, -2)) / scale
            if attn_mask is not None:
                logits = logits + attn_mask
            if attn_bias is not None:
                logits = logits + attn_bias
            out = torch.softmax(logits.float(), dim=-1).to(x.dtype) @ v
        return self.out_proj(out.transpose(1, 2).reshape(b, l, c))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = LayerNormF32(width)
        self.attn = CLIPAttention(width, heads)
        self.ln_2 = LayerNormF32(width)
        self.mlp_c_fc = nn.Linear(width, width * 4)
        self.mlp_c_proj = nn.Linear(width * 4, width)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                attn_bias: Optional[torch.Tensor] = None, sos_q: int = 0) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), attn_mask, attn_bias, sos_q)
        return x + self.mlp_c_proj(quick_gelu(self.mlp_c_fc(self.ln_2(x))))


def _blocks(owner: nn.Module, width: int, heads: int, layers: int):
    """``resblock{i}`` submodules (the flax names), returned in order."""
    for i in range(layers):
        owner.add_module(f"resblock{i}", ResidualAttentionBlock(width, heads))
    return [getattr(owner, f"resblock{i}") for i in range(layers)]


class CLIPTextEncoder(nn.Module):
    """Causal text transformer -> EOT feature @ text_projection."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 512,
                 heads: int = 8, layers: int = 12, embed_dim: int = 512):
        super().__init__()
        self.context_length = context_length
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.blocks = _blocks(self, width, heads, layers)
        self.ln_final = LayerNormF32(width)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, L) int, L <= context_length: the prompts may be cut after
        their last EOT, which no earlier position attends to."""
        l = tokens.shape[1]
        x = self.token_embedding(tokens) + self.positional_embedding[None, :l]
        causal = torch.full((l, l), NEG_INF, dtype=x.dtype, device=x.device).triu(1)
        for block in self.blocks:
            x = block(x, attn_mask=causal)
        x = self.ln_final(x)
        eot = tokens.argmax(dim=-1)  # EOT has the highest token id
        return x[torch.arange(x.shape[0], device=x.device), eot] @ self.text_projection


def resize_pos_embed(pos: torch.Tensor, grid_hw: Tuple[int, int],
                     src_grid: Optional[int] = None) -> torch.Tensor:
    """Resize a (1+G*G, C) ViT positional embedding to an (H', W') patch grid,
    bicubic without antialias (``side_adapter.py:41-67``); (1+H'*W', C)."""
    n, c = pos.shape
    g = src_grid or int(round((n - 1) ** 0.5))
    if (g, g) == tuple(grid_hw):
        return pos
    grid = pos[1:].reshape(g, g, c).permute(2, 0, 1)
    grid = resize_bicubic_torch_hw(grid, tuple(grid_hw))
    return torch.cat([pos[:1], grid.permute(1, 2, 0).reshape(-1, c)], dim=0)


class CLIPVisionTransformer(nn.Module):
    """ViT vision tower with block-level access."""

    def __init__(self, patch_size: int = 16, width: int = 768, layers: int = 12,
                 heads: int = 12, embed_dim: int = 512, image_size: int = 224):
        super().__init__()
        g = image_size // patch_size
        self.patch_size = patch_size
        self.layers = layers
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(1 + g * g, width))
        self.ln_pre = LayerNormF32(width)
        self.blocks = _blocks(self, width, heads, layers)
        self.ln_post = LayerNormF32(width)
        self.proj = nn.Parameter(torch.empty(width, embed_dim))

    def patch_tokens(self, images: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """images (B, H, W, 3) normalized, H and W multiples of the patch ->
        ((B, hw, C) patch tokens, (h, w))."""
        if images.shape[1] % self.patch_size or images.shape[2] % self.patch_size:
            raise ValueError(f"image size {tuple(images.shape[1:3])} is not a multiple of the "
                             f"patch size {self.patch_size}")
        x = self.conv1(images.permute(0, 3, 1, 2))                   # (B, C, h, w)
        return x.flatten(2).transpose(1, 2), tuple(x.shape[2:])

    def embed_tokens(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        """(B, hw, C) patch tokens -> (B, 1+hw, C): the class token, the
        positional embedding at the grid ``hw`` and ``ln_pre``."""
        b, _, c = x.shape
        cls = self.class_embedding.to(x.dtype).expand(b, 1, c)
        x = torch.cat([cls, x], dim=1)
        x = x + resize_pos_embed(self.positional_embedding, hw)[None].to(x.dtype)
        return self.ln_pre(x)

    def embed(self, images: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """images (B, H, W, 3) normalized -> ((B, 1+hw, C), (h, w))."""
        x, hw = self.patch_tokens(images)
        return self.embed_tokens(x, hw), hw

    def run_blocks(self, x: torch.Tensor, lo: int, hi: int, attn_bias=None,
                   taps: Sequence[int] = (), sos_q: int = 0
                   ) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
        """Run blocks [lo, hi); ``taps``: 1-based block indices whose output
        to record (SAN's ``merge_ids``); ``attn_bias``: one additive bias (or
        None) a block, of the form ``sos_q`` selects (``CLIPAttention``)."""
        tapped: Dict[int, torch.Tensor] = {}
        for i in range(lo, hi):
            bias = attn_bias[i - lo] if attn_bias is not None else None
            x = self.blocks[i](x, attn_bias=bias, sos_q=sos_q)
            if (i + 1) in taps:
                tapped[i + 1] = x
        return x, tapped

    def finalize(self, x: torch.Tensor, project: bool = True) -> torch.Tensor:
        """``ln_post`` on the class token (or all tokens) and the projection."""
        y = self.ln_post(x)
        return y @ self.proj if project else y

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x, _ = self.embed(images)
        x, _ = self.run_blocks(x, 0, self.layers)
        return self.finalize(x[:, 0])


class CLIP(nn.Module):
    """Both towers and the logit scale."""

    def __init__(self, embed_dim: int = 512, vision_patch: int = 16, vision_width: int = 768,
                 vision_layers: int = 12, vision_heads: int = 12, image_size: int = 224,
                 text_width: int = 512, text_heads: int = 8, text_layers: int = 12,
                 vocab_size: int = 49408, context_length: int = 77):
        super().__init__()
        self.visual = CLIPVisionTransformer(vision_patch, vision_width, vision_layers,
                                            vision_heads, embed_dim, image_size)
        self.text = CLIPTextEncoder(vocab_size, context_length, text_width, text_heads,
                                    text_layers, embed_dim)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual(images)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.text(tokens)

    def forward(self, images: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        img = self.encode_image(images)
        txt = self.encode_text(tokens)
        img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
        txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
        return self.logit_scale.exp() * img @ txt.T


# OpenAI CLIP preprocessing constants (RGB in [0,1])
CLIP_PIXEL_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_PIXEL_STD = (0.26862954, 0.26130258, 0.27577711)

_MODEL_SHAPES = {
    "ViT-B/16": dict(embed_dim=512, vision_patch=16, vision_width=768,
                     vision_layers=12, vision_heads=12, image_size=224,
                     text_width=512, text_heads=8, text_layers=12),
    "ViT-B/32": dict(embed_dim=512, vision_patch=32, vision_width=768,
                     vision_layers=12, vision_heads=12, image_size=224,
                     text_width=512, text_heads=8, text_layers=12),
    "ViT-L/14": dict(embed_dim=768, vision_patch=14, vision_width=1024,
                     vision_layers=24, vision_heads=16, image_size=224,
                     text_width=768, text_heads=12, text_layers=12),
    "ViT-L/14@336px": dict(embed_dim=768, vision_patch=14, vision_width=1024,
                           vision_layers=24, vision_heads=16, image_size=336,
                           text_width=768, text_heads=12, text_layers=12),
    # ModifiedResNet towers (vision_layers is a tuple; mask_adapted_clip/model.py:387-401)
    "RN50": dict(embed_dim=1024, vision_patch=None, vision_width=64,
                 vision_layers=(3, 4, 6, 3), vision_heads=32, image_size=224,
                 text_width=512, text_heads=8, text_layers=12),
    "RN101": dict(embed_dim=512, vision_patch=None, vision_width=64,
                  vision_layers=(3, 4, 23, 3), vision_heads=32,
                  image_size=224, text_width=512, text_heads=8,
                  text_layers=12),
    # tiny shape for tests/smoke runs (not a real OpenAI checkpoint)
    "test-tiny": dict(embed_dim=32, vision_patch=8, vision_width=64,
                      vision_layers=4, vision_heads=4, image_size=64,
                      text_width=64, text_heads=4, text_layers=2,
                      vocab_size=512, context_length=16),
    "test-tiny-rn": dict(embed_dim=32, vision_patch=None, vision_width=8,
                         vision_layers=(1, 1, 1, 1), vision_heads=4,
                         image_size=64, text_width=64, text_heads=4,
                         text_layers=2, vocab_size=512, context_length=16),
}


def model_shape(model_name: str) -> Dict:
    """The shape of a CLIP: a ViT, or a ModifiedResNet (``vision_layers`` a
    tuple of blocks a stage, ``vision_patch`` None)."""
    if model_name not in _MODEL_SHAPES:
        raise ValueError(f"unknown CLIP model {model_name!r}")
    return _MODEL_SHAPES[model_name]


def vit_shape(model_name: str, user: str) -> Dict:
    """The shape of a ViT CLIP; ``user`` (a tower that reads the ViT's blocks)
    refuses a ModifiedResNet with a ValueError, as the JAX package cannot
    build it either."""
    s = model_shape(model_name)
    if is_resnet(s):
        raise ValueError(f"{user} needs a ViT CLIP, not the ModifiedResNet {model_name!r}")
    return s


def is_resnet(shape: Dict) -> bool:
    return isinstance(shape["vision_layers"], tuple)


def vision_tower(model_name: str) -> nn.Module:
    """The visual tower of ``model_name``: the ViT, or the ModifiedResNet with
    its maskable attention pool."""
    s = model_shape(model_name)
    if is_resnet(s):
        # imported here: clip_mask_adapted builds on this module's blocks
        from openvis_tpu_torch.models.clip_mask_adapted import MaskAdaptedModifiedResNet

        return MaskAdaptedModifiedResNet(s["vision_layers"], s["vision_width"], s["embed_dim"],
                                         s["vision_heads"], s["image_size"])
    return CLIPVisionTransformer(s["vision_patch"], s["vision_width"], s["vision_layers"],
                                 s["vision_heads"], s["embed_dim"], s["image_size"])


def text_tower(model_name: str, vocab_size: int, context_length: int) -> CLIPTextEncoder:
    """The text tower of ``model_name`` with the vocabulary and context
    length of its weights (as OpenAI's ``build_model`` reads them from the
    state dict)."""
    s = model_shape(model_name)
    return CLIPTextEncoder(vocab_size, context_length, s["text_width"], s["text_heads"],
                           s["text_layers"], s["embed_dim"])
