"""Mask-adapted CLIP: the mask-prompted vision towers and their crop classifier.

Port of ``openvis_tpu/models/clip_mask_adapted.py``, the JAX package's
rebuild of the fork the reference vendors under
``third_parties/mask_adapted_clip`` (``model.py:73-363``) and its adapter
(``modeling/clip_adapter/mask_adapted_adapter.py:35-165``):

  * ``MaskAdaptedVisual``: the ViT tower (``CLIPVisionTransformer``'s
    parameters plus ``mask_embedding`` (depth, g^2, width), zero at init).
    The soft mask is average-pooled to the patch grid, clipped to [0, 1]
    and ceiled, so any positive pixel marks its patch; background patches
    take ``mask_embedding[0]`` before ``ln_pre`` and ``mask_embedding[i+1]``
    after block i while i + 1 < depth.  On a grid other than the pretrain
    grid every patch takes the table's first token.
  * ``MaskAdaptedModifiedResNet``: the RN50/RN101 tower, a 3-conv stem and
    an average pool, four stages of bottlenecks whose BatchNorms are folded
    into ``FrozenAffine`` (eval-mode statistics of a frozen tower: exact),
    and the attention pool.  The mask enters the pool as the fork's
    key-padding vector ``[mask > 0.5 on the final grid ; True]`` against the
    tokens ``[mean ; patches]``, misaligned by one as the fork has it
    (``model.py:88-96``): masked logits are -inf, so a crop whose mask
    covers every cell of the grid masks every key and its features are NaN,
    as in JAX and in the fork.
  * ``adapted_clip_crop_classify``: the plain classifier's square crops and
    blend, with the soft mask crop passed to the tower (``clip_crop_classify``
    with ``mask_prompt``).

Images are NHWC and CLIP-normalised, as in the JAX package; parameter names
are the flax ones, so ``convert.params_from_flax`` maps a converted tree.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from openvis_tpu_torch.models.backbone.resnet import FrozenAffine
from openvis_tpu_torch.models.clip.model import CLIPVisionTransformer, resize_pos_embed
from openvis_tpu_torch.models.clip_adapter import clip_crop_classify


class MaskAdaptedVisual(CLIPVisionTransformer):
    """The mask-prompted ViT (``mask_adapted_clip/model.py:288-363``)."""

    def __init__(self, patch_size: int = 16, width: int = 768, layers: int = 12,
                 heads: int = 12, embed_dim: int = 512, image_size: int = 224,
                 mask_prompt_depth: int = 3):
        super().__init__(patch_size, width, layers, heads, embed_dim, image_size)
        g = image_size // patch_size
        self.mask_prompt_depth = mask_prompt_depth
        self.mask_embedding = nn.Parameter(torch.zeros(mask_prompt_depth, g * g, width))

    def forward(self, images: torch.Tensor, masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        """images (N, S, S, 3) normalized; masks (N, S, S) in [0, 1] or None
        -> (N, D)."""
        if masks is None:
            return super().forward(images)
        x, (h, w) = self.patch_tokens(images)
        n, hw, c = x.shape
        p = self.patch_size
        m = F.avg_pool2d(masks[:, None], p, p).reshape(n, hw, 1).clamp(0.0, 1.0).ceil()
        me = self.mask_embedding.to(x.dtype)
        if me.shape[1] != hw:  # another grid than the pretrain grid: the first token
            me = me[:, :1].expand(-1, hw, -1)
        x = self.embed_tokens(x * m + me[0][None] * (1.0 - m), (h, w))
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i + 1 < self.mask_prompt_depth:
                x = torch.cat([x[:, :1], x[:, 1:] * m + me[i + 1][None] * (1.0 - m)], dim=1)
        return self.finalize(x[:, 0])


class _RNBottleneck(nn.Module):
    """CLIP's ModifiedResNet bottleneck (``mask_adapted_clip/model.py:14-71``):
    every conv at stride 1, an average pool after conv2 when ``stride`` > 1,
    the shortcut an average pool and a 1x1 conv."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenAffine(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FrozenAffine(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenAffine(planes * 4)
        self.has_downsample = has_downsample
        if has_downsample:
            self.downsample_conv = nn.Conv2d(inplanes, planes * 4, 1, bias=False)
            self.downsample_bn = FrozenAffine(planes * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        if self.stride > 1:
            y = F.avg_pool2d(y, self.stride)
        y = self.bn3(self.conv3(y))
        idn = x
        if self.has_downsample:
            if self.stride > 1:
                idn = F.avg_pool2d(idn, self.stride)
            idn = self.downsample_bn(self.downsample_conv(idn))
        return F.relu(y + idn)


def _nearest_pool_mask(masks: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """(N, H, W) -> (N, gh, gw) by torch's legacy ``nearest`` rule, index =
    floor(i * in / out) (not ``nearest-exact``), as the JAX package computes it."""
    h, w = masks.shape[-2:]
    yi = torch.clamp(torch.arange(gh, device=masks.device) * h // gh, max=h - 1)
    xi = torch.clamp(torch.arange(gw, device=masks.device) * w // gw, max=w - 1)
    return masks[..., yi[:, None], xi[None, :]]


class MaskAdaptedModifiedResNet(nn.Module):
    """CLIP's ``ModifiedResNet`` with the maskable ``AttentionPool2d``
    (``mask_adapted_clip/model.py:73-221``); without a mask it is the plain
    RN50/RN101 tower."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 embed_dim: int = 1024, heads: int = 32, image_size: int = 224):
        super().__init__()
        self.heads = heads
        self.grid = image_size // 32
        for i, (cin, cout, stride) in enumerate(((3, width // 2, 2), (width // 2, width // 2, 1),
                                                  (width // 2, width, 1))):
            self.add_module(f"stem_conv{i + 1}", nn.Conv2d(cin, cout, 3, stride, 1, bias=False))
            self.add_module(f"stem_bn{i + 1}", FrozenAffine(cout))
        blocks = []
        inplanes = width
        for si, n_blocks in enumerate(layers):
            planes = width * 2 ** si
            for b in range(n_blocks):
                stride = 2 if b == 0 and si > 0 else 1
                has_ds = b == 0 and (stride > 1 or inplanes != planes * 4)
                self.add_module(f"layer{si + 1}_block{b}",
                                _RNBottleneck(inplanes, planes, stride, has_ds))
                blocks.append(getattr(self, f"layer{si + 1}_block{b}"))
                inplanes = planes * 4
        self.blocks = blocks
        c = inplanes
        self.positional_embedding = nn.Parameter(torch.empty(self.grid ** 2 + 1, c))
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)
        self.v_proj = nn.Linear(c, c)
        self.c_proj = nn.Linear(c, embed_dim)

    def forward(self, images: torch.Tensor, masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        """images (N, S, S, 3) normalized; masks (N, S, S) soft crop masks or
        None -> (N, embed_dim) pooled features."""
        x = images.permute(0, 3, 1, 2)
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"stem_bn{i}")(getattr(self, f"stem_conv{i}")(x)))
        x = F.avg_pool2d(x, 2)
        for block in self.blocks:
            x = block(x)
        n, c, gh, gw = x.shape
        toks = x.flatten(2).transpose(1, 2)                           # (N, L, C)
        toks = torch.cat([toks.mean(dim=1, keepdim=True), toks], dim=1)
        toks = toks + resize_pos_embed(self.positional_embedding, (gh, gw),
                                       src_grid=self.grid)[None].to(toks.dtype)
        h = self.heads
        dh = c // h
        # only the mean token's row is read (``out[:, 0]``): its query alone
        q = self.q_proj(toks[:, :1]).reshape(n, 1, h, dh).transpose(1, 2)   # (N, H, 1, dh)
        k = self.k_proj(toks).reshape(n, -1, h, dh).transpose(1, 2)
        v = self.v_proj(toks).reshape(n, -1, h, dh).transpose(1, 2)
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(dh)                   # (N, H, 1, L+1)
        if masks is not None:
            covered = _nearest_pool_mask(masks, gh, gw).reshape(n, gh * gw) > 0.5
            pad = torch.cat([covered, covered.new_ones(n, 1)], dim=1)         # the fork's vector
            logits = logits.masked_fill(pad[:, None, None, :], float("-inf"))
        attn = torch.softmax(logits.float(), dim=-1).to(toks.dtype)
        return self.c_proj((attn @ v).reshape(n, c))


# ``AdaptedClipAdapter.forward`` (mask_adapted_adapter.py:59-121): the plain
# adapter's square crops and blend, the soft mask crops forwarded to the
# mask-prompted tower (``mask_prompt=False`` is the fork's ``mask_prompt_fwd``
# off); one frame at a time.
adapted_clip_crop_classify = functools.partial(clip_crop_classify, mask_prompt=True)
