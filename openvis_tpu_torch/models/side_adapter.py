"""SAN's side adapter: the frozen CLIP ViT split in two, steered by attention
biases.

Port of ``openvis_tpu/models/side_adapter.py`` (``SideAdapter``,
``adaptive_max_pool``):

  * ``front_encode``: the raw frames resized to the CLIP resolution (/255,
    bicubic without antialias, CLIP's mean and std), embedded, and run
    through blocks ``0..broken_idx-1``; the outputs of the 1-based blocks
    ``merge_ids`` are projected by 1x1 convolutions to the pixel decoder's
    width (the ``extra_features``);
  * ``post_encode``: ``num_queries`` sos tokens (copies of the class token)
    are put before the tokens, and blocks ``broken_idx..`` run in the
    sos-split form of ``CLIPAttention``: a sos row's bias is -100 on the
    class column and the decoder's bias maps, max-pooled to the patch grid,
    on the patches; the sos outputs, through ``ln_post`` and ``proj``, are
    normalised;
  * ``text_with_bg`` appends the learned, normalised background row to the
    text rows, and ``sim_logits`` is ``exp(logit_scale) * img @ text.T``.

The JAX package pools with power-of-two tables and one-hot products because
gathers of small rows serialise on the TPU; its semantics are
``F.adaptive_max_pool2d``'s (``tests/test_san.py:46``), which the port calls.
Maps are NCHW, as elsewhere in the port.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from openvis_tpu_torch.models.clip.model import (
    CLIP_PIXEL_MEAN,
    CLIP_PIXEL_STD,
    vision_tower,
    vit_shape,
)
from openvis_tpu_torch.utils.image import resize_bicubic_torch_hw


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6)


def adaptive_max_pool(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W) -> (..., th, tw) adaptive max pool (window
    [floor(i*H/th), ceil((i+1)*H/th))); identity when the sizes match."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(out_hw):
        return x
    lead = x.shape[:-2]
    return F.adaptive_max_pool2d(x.reshape(1, -1, h, w), tuple(out_hw)).reshape(*lead, *out_hw)


class SideAdapter(nn.Module):
    """The frozen CLIP vision tower (``visual``), the tap projections
    ``attn_proj{i}``, the background row ``bg_embed`` and ``logit_scale``."""

    def __init__(self, clip_model_name: str = "ViT-B/16", out_dims: int = 256,
                 broken_idx: int = 9, merge_ids: Sequence[int] = (3, 6, 9),
                 num_queries: int = 100):
        super().__init__()
        shape = vit_shape(clip_model_name, "SAN's side adapter")
        self.broken_idx, self.merge_ids = broken_idx, tuple(merge_ids)
        self.num_queries = num_queries
        self.input_resolution = shape["image_size"]
        self.visual = vision_tower(clip_model_name)
        for i in range(len(self.merge_ids)):
            self.add_module(f"attn_proj{i}", nn.Conv2d(shape["vision_width"], out_dims, 1))
        self.bg_embed = nn.Parameter(torch.zeros(1, shape["embed_dim"]))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def preprocess(self, frames_raw: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) in [0, 255] -> (N, S, S, 3) CLIP-normalised at the
        tower's resolution (``side_adapter.py:150-154``)."""
        s = self.input_resolution
        x = resize_bicubic_torch_hw((frames_raw / 255.0).permute(0, 3, 1, 2), (s, s))
        x = x.permute(0, 2, 3, 1)
        mean = torch.tensor(CLIP_PIXEL_MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(CLIP_PIXEL_STD, dtype=x.dtype, device=x.device)
        return (x - mean) / std

    def front_encode(self, frames_raw: torch.Tensor
                     ) -> Tuple[List[torch.Tensor], torch.Tensor, Tuple[int, int]]:
        """-> (the taps projected, each (N, out_dims, h, w), in ``merge_ids``
        order; the tokens (N, 1 + h*w, W) after block ``broken_idx``; (h, w))."""
        tokens, (h, w) = self.visual.embed(self.preprocess(frames_raw))
        tokens, tapped = self.visual.run_blocks(tokens, 0, self.broken_idx, taps=self.merge_ids)
        mg_feats = []
        for i, mid in enumerate(self.merge_ids):
            f = tapped[mid][:, 1:]                                     # patch tokens
            f = f.transpose(1, 2).reshape(f.shape[0], f.shape[2], h, w)
            mg_feats.append(getattr(self, f"attn_proj{i}")(f))
        return mg_feats, tokens, (h, w)

    def post_encode(self, bk_tokens: torch.Tensor, attn_biases: torch.Tensor,
                    grid_hw: Tuple[int, int]) -> torch.Tensor:
        """``bk_tokens`` (N, 1+L, W) from ``front_encode``, ``attn_biases``
        (N, nH, Q, h', w') the decoder's maps -> (N, Q, D) normalised sos
        features (``side_adapter.py:176-209``)."""
        n, _, width = bk_tokens.shape
        q = self.num_queries
        nh = attn_biases.shape[1]
        h, w = grid_hw
        ab = adaptive_max_pool(attn_biases, (h, w)).reshape(n, nh, q, h * w)
        neg_cls = torch.full((n, nh, q, 1), -100.0, dtype=bk_tokens.dtype, device=ab.device)
        sos_bias = torch.cat([neg_cls, ab.to(bk_tokens.dtype)], dim=-1)  # (N, nH, Q, 1+L)
        x = torch.cat([bk_tokens[:, :1].expand(n, q, width), bk_tokens], dim=1)
        layers = self.visual.layers
        x, _ = self.visual.run_blocks(x, self.broken_idx, layers,
                                      attn_bias=[sos_bias] * (layers - self.broken_idx),
                                      sos_q=q)
        return _normalize(self.visual.finalize(x[:, :q]))

    def text_with_bg(self, text_feats: torch.Tensor) -> torch.Tensor:
        return torch.cat([text_feats, _normalize(self.bg_embed).to(text_feats.dtype)], dim=0)

    def sim_logits(self, text_feats: torch.Tensor, img_feats: torch.Tensor) -> torch.Tensor:
        """``exp(logit_scale) * img @ text.T``; the scale multiplies the
        image rows first, and bf16 rows against f32 text compute in f32, as
        JAX evaluates and promotes."""
        img = self.logit_scale.exp() * img_feats
        dt = torch.promote_types(img.dtype, text_feats.dtype)
        return img.to(dt) @ text_feats.to(dt).T
