"""Mask2Former masked transformer decoder, frame and video modes, with the
class, embedding, proposal and side-adapter heads.

Port of ``openvis_tpu/models/transformer_decoder.py`` (``MLP``,
``MultiheadAttention``, the self/cross/FFN layers, ``attn_bias_from_mask_logits``,
``PredictionHeads``, ``MaskedTransformerDecoder``):

  * ``dec_layers`` layers round-robin over the 3 feature levels (``i % 3``),
    each masked cross-attention -> self-attention -> FFN;
  * prediction heads run on the learned queries before layer 0 and after every
    layer (``dec_layers + 1`` prediction sets, stacked on a leading axis);
  * masked cross-attention: tokens where the previous prediction's resized
    mask logit is negative (``sigmoid < 0.5``) get an additive ``NEG_INF``
    bias, except for a query whose mask is off everywhere;
  * heads: ``class`` (one Linear to ``num_classes + 1``, VideoMaskFormer and
    MinVIS), ``embedding`` (a 2-layer MLP to the CLIP width, per query),
    OpenVIS's ``proposal`` (one Linear to 2 objectness logits,
    ``frame_mask2former_transformer_decoder.py:199-207``), OV2Seg's ``ov2seg``
    (``zs_fc1`` to D/2, ReLU, ``zs_fc2`` to D, beside ``object_embed`` to 2
    objectness logits, packed as ``[e | obj]``; JAX
    ``transformer_decoder.py:224-230``), the ``zero_shot`` head (the normed
    decoder output itself beside a 2-layer ``object_embed`` MLP to 2
    objectness logits, packed as ``[x | obj]``, width ``hidden_dim + 2``;
    JAX ``transformer_decoder.py:217-223``: matched against the text
    outside the decoder, and no meta-architecture reads it) and SAN's
    ``side_adapter`` (per CLIP head, attention-bias maps
    ``einsum(attn_embed(x), attn_features)`` over the mask features
    downsampled by 4 and run through three 1x1 convolutions,
    ``side_adapter_frame_...py:48-169``);
  * ``mode="frame"``: every frame is a batch item with 2-D position encodings;
    ``mode="video"`` (the offline archs, ``video_mask2former_transformer_decoder.py``):
    one query set a clip attends over the clip's T*h*w tokens of a level,
    t-major, with 3-D position encodings, and its masks span the T frames.
    The attention over a clip is not masked by frame: frames appended to a
    clip change the real frames' outputs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from openvis_tpu_torch.models.amp import amp_norm, softmax_f32
from openvis_tpu_torch.models.position_encoding import (
    position_encoding_2d,
    position_encoding_3d,
)
from openvis_tpu_torch.utils.image import resize_bilinear_torch_hw

NEG_INF = -1e9
LN_EPS = 1e-6  # flax LayerNorm default


class MLP(nn.Module):
    """N-layer perceptron with ReLU between layers."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            self.add_module(f"layer{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


class MultiheadAttention(nn.Module):
    """Batch-major MHA (torch ``nn.MultiheadAttention`` semantics) with an
    optional additive bias (B, 1|H, Lq, Lk); softmax in f32."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, q, k, v, attn_bias: Optional[torch.Tensor] = None):
        d, h = self.d_model, self.num_heads
        dh = d // h
        b, lq, _ = q.shape
        lk = k.shape[1]
        qp = self.q_proj(q).view(b, lq, h, dh)
        kp = self.k_proj(k).view(b, lk, h, dh)
        vp = self.v_proj(v).view(b, lk, h, dh)
        # sqrt(dh) rounded to the compute dtype, as the JAX package divides
        scale = torch.tensor(float(dh), dtype=qp.dtype).sqrt().item()
        logits = torch.einsum("bqhd,bkhd->bhqk", qp, kp) / scale
        if attn_bias is not None:
            logits = logits + attn_bias
        attn = softmax_f32(logits, dim=-1).to(vp.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, vp).reshape(b, lq, d)
        return self.out_proj(out)


class SelfAttentionLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, pre_norm: bool = False):
        super().__init__()
        self.pre_norm = pre_norm
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt, query_pos):
        def attn(x):
            qk = x + query_pos
            return self.self_attn(qk, qk, x)

        if self.pre_norm:
            return tgt + attn(amp_norm(self.norm, tgt))
        return amp_norm(self.norm, tgt + attn(tgt))


class CrossAttentionLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, pre_norm: bool = False):
        super().__init__()
        self.pre_norm = pre_norm
        self.multihead_attn = MultiheadAttention(d_model, nhead)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt, memory, pos, query_pos, attn_bias=None):
        def attn(x):
            return self.multihead_attn(x + query_pos, memory + pos, memory, attn_bias)

        if self.pre_norm:
            return tgt + attn(amp_norm(self.norm, tgt))
        return amp_norm(self.norm, tgt + attn(tgt))


class FFNLayer(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int, pre_norm: bool = False):
        super().__init__()
        self.pre_norm = pre_norm
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt):
        def ff(x):
            return self.linear2(F.relu(self.linear1(x)))

        if self.pre_norm:
            return tgt + ff(amp_norm(self.norm, tgt))
        return amp_norm(self.norm, tgt + ff(tgt))


def attn_bias_from_mask_logits(
    mask_logits: torch.Tensor, size: Tuple[int, int]
) -> torch.Tensor:
    """(B, Q, H, W) or (B, Q, T, H, W) mask logits -> (B, 1, Q, h*w) or (B, 1,
    Q, T*h*w) additive bias (each frame resized to ``size``, t-major): 0 where
    attention is allowed, ``NEG_INF`` where the resized logit is negative,
    unless the whole row is negative.  Carries no gradient."""
    r = resize_bilinear_torch_hw(mask_logits.detach(), size)
    disallowed = r.flatten(2) < 0.0                # sigmoid < 0.5 <=> logit < 0
    all_masked = disallowed.all(dim=-1, keepdim=True)
    disallowed = disallowed & ~all_masked
    bias = torch.zeros(disallowed.shape, dtype=mask_logits.dtype, device=mask_logits.device)
    return bias.masked_fill(disallowed, NEG_INF)[:, None]


class PredictionHeads(nn.Module):
    """decoder_norm -> the head's logits and the 3-layer mask-embed MLP dotted
    with the mask features.  ``class``: one Linear to ``num_classes + 1``;
    ``embedding``: a 2-layer MLP to the CLIP width; ``proposal``: OpenVIS's
    class-agnostic objectness, one Linear to 2 logits; ``ov2seg``: the
    zero-shot embedding (hidden -> D/2 -> D) and 2 objectness logits packed
    on the last axis; ``zero_shot``: the normed output and 2 objectness
    logits from a 2-layer MLP, packed on the last axis; ``side_adapter``: a
    3-layer MLP whose queries dot the attention features into per-head bias
    maps."""

    def __init__(self, hidden_dim: int, mask_dim: int, head: str = "embedding",
                 clip_dim: int = 512, num_classes: int = 0):
        super().__init__()
        self.head = head
        self.decoder_norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        if head == "class":
            self.class_embed = nn.Linear(hidden_dim, num_classes + 1)
        elif head == "embedding":
            self.class_embed = MLP(hidden_dim, clip_dim * 2, clip_dim, 2)
        elif head == "proposal":
            self.class_embed = nn.Linear(hidden_dim, 2)
        elif head == "ov2seg":
            self.zs_fc1 = nn.Linear(hidden_dim, clip_dim // 2)
            self.zs_fc2 = nn.Linear(clip_dim // 2, clip_dim)
            self.object_embed = nn.Linear(hidden_dim, 2)
        elif head == "zero_shot":
            self.object_embed = MLP(hidden_dim, hidden_dim, 2, 2)
        elif head == "side_adapter":
            self.attn_embed = MLP(hidden_dim, hidden_dim, hidden_dim, 3)
        else:
            # the JAX package's "none" head has no decoder name (_DECODER_KINDS)
            raise ValueError(f"unknown decoder head {head!r}")
        self.mask_embed = MLP(hidden_dim, hidden_dim, mask_dim, 3)

    def forward(self, output, mask_features, attn_features=None):
        """Frame mode: output (N, Q, C); mask_features (N, Cm, H, W);
        attn_features (N, nH, C, h, w) for ``side_adapter`` -> (logits (N, Q,
        D) or biases (N, nH, Q, h, w), masks (N, Q, H, W), normed output).
        Video mode (5-D mask features (B, Cm, T, H, W), channels first so the
        mask einsum is one batched matmul): output (B, Q, C); attn_features
        (B*T, nH, C, h, w) -> (logits (B, Q, D) or biases (B, T, nH, Q, h, w),
        masks (B, Q, T, H, W), normed output)."""
        x = amp_norm(self.decoder_norm, output)
        video = mask_features.dim() == 5
        if self.head == "ov2seg":
            logits = torch.cat([self.zs_fc2(F.relu(self.zs_fc1(x))), self.object_embed(x)],
                               dim=-1)
        elif self.head == "zero_shot":
            logits = torch.cat([x, self.object_embed(x)], dim=-1)
        elif self.head != "side_adapter":
            logits = self.class_embed(x)
        elif video:
            # per-clip queries against per-frame attention features
            af = attn_features.reshape(x.shape[0], -1, *attn_features.shape[1:])
            logits = torch.einsum("bqc,btnchw->btnqhw", self.attn_embed(x), af)
        else:
            logits = torch.einsum("bqc,bnchw->bnqhw", self.attn_embed(x), attn_features)
        spec = "bqc,bcthw->bqthw" if video else "bqc,bchw->bqhw"
        masks = torch.einsum(spec, self.mask_embed(x), mask_features)
        return logits, masks, x


class MaskedTransformerDecoder(nn.Module):
    """``mode="frame"``: every frame is a batch item with 2-D position
    encodings; ``mode="video"``: one query set a clip over its T*h*w tokens
    a level with 3-D encodings."""

    def __init__(self, mode: str = "frame", head: str = "embedding",
                 hidden_dim: int = 256, num_queries: int = 100, nheads: int = 8,
                 dim_feedforward: int = 2048, dec_layers: int = 9,
                 pre_norm: bool = False, mask_dim: int = 256, num_classes: int = 0,
                 clip_dim: int = 512, clip_heads: int = 12, in_channels: int = 256):
        super().__init__()
        if mode not in ("frame", "video"):
            raise ValueError(f"unknown decoder mode {mode!r}")
        self.video = mode == "video"
        self.nlvl = 3
        self.hidden_dim, self.num_queries, self.dec_layers = hidden_dim, num_queries, dec_layers
        self.head, self.clip_heads = head, clip_heads
        self.level_embed = nn.Parameter(torch.zeros(self.nlvl, hidden_dim))
        self.query_feat = nn.Parameter(torch.zeros(num_queries, hidden_dim))
        self.query_embed = nn.Parameter(torch.zeros(num_queries, hidden_dim))
        self.input_project = in_channels != hidden_dim
        if self.input_project:
            for i in range(self.nlvl):
                self.add_module(f"input_proj{i}", nn.Conv2d(in_channels, hidden_dim, 1))
        if head == "side_adapter":
            self.attn_mlp0 = nn.Conv2d(mask_dim, hidden_dim, 1)
            self.attn_mlp1 = nn.Conv2d(hidden_dim, hidden_dim, 1)
            self.attn_mlp2 = nn.Conv2d(hidden_dim, hidden_dim * clip_heads, 1)
        self.heads = PredictionHeads(hidden_dim, mask_dim, head, clip_dim, num_classes)
        for i in range(dec_layers):
            self.add_module(f"cross_attn{i}", CrossAttentionLayer(hidden_dim, nheads, pre_norm))
            self.add_module(f"self_attn{i}", SelfAttentionLayer(hidden_dim, nheads, pre_norm))
            self.add_module(f"ffn{i}", FFNLayer(hidden_dim, dim_feedforward, pre_norm))

    def forward(
        self,
        x: Sequence[torch.Tensor],       # 3 NCHW maps, top-down; N = B*T
        mask_features: torch.Tensor,     # frame: (B*T, Cm, H, W); video: (B, T, Cm, H, W)
        num_frames: int,
    ) -> Dict[str, Any]:
        t = num_frames
        video = self.video
        bs = x[0].shape[0] // t
        nb = bs if video else bs * t
        srcs: List[torch.Tensor] = []
        poses: List[torch.Tensor] = []
        size_list: List[Tuple[int, int]] = []
        for i in range(self.nlvl):
            f = x[i]
            h, w = f.shape[-2:]
            size_list.append((h, w))
            if self.input_project:
                f = getattr(self, f"input_proj{i}")(f)
            if video:
                # (B*T, C, h, w) -> (B, T*h*w, C): t-major, as the JAX
                # package's NHWC reshape orders the tokens
                pe = position_encoding_3d(t, h, w, self.hidden_dim, f.device).to(f.dtype)
                poses.append(pe.reshape(1, t * h * w, self.hidden_dim))
                srcs.append(f.permute(0, 2, 3, 1).reshape(bs, t * h * w, self.hidden_dim)
                            + self.level_embed[i])
            else:
                pe = position_encoding_2d(h, w, self.hidden_dim // 2, f.device).to(f.dtype)
                poses.append(pe.reshape(1, h * w, self.hidden_dim))
                srcs.append(f.flatten(2).transpose(1, 2) + self.level_embed[i])

        output = self.query_feat[None].expand(nb, -1, -1)
        qpos = self.query_embed[None].expand(nb, -1, -1)

        af = None
        if self.head == "side_adapter":
            # (hm // 4, wm // 4), as the JAX package sizes it: the reference's
            # scale_factor=0.25 differs where hm or wm is not a multiple of 4
            base = mask_features.flatten(0, 1) if video else mask_features  # (B*T, Cm, H, W)
            hm, wm = base.shape[-2:]
            af = resize_bilinear_torch_hw(base, (hm // 4, wm // 4))
            af = self.attn_mlp2(F.relu(self.attn_mlp1(F.relu(self.attn_mlp0(af)))))
            af = af.reshape(bs * t, self.clip_heads, self.hidden_dim, *af.shape[-2:])

        # the heads' mask features: video (B, Cm, T, H, W), once for all layers
        mf = mask_features.transpose(1, 2).contiguous() if video else mask_features
        all_logits, all_masks = [], []
        logits, masks, _ = self.heads(output, mf, af)
        all_logits.append(logits)
        all_masks.append(masks)
        attn_bias = attn_bias_from_mask_logits(masks, size_list[0])

        for i in range(self.dec_layers):
            lvl = i % self.nlvl
            output = getattr(self, f"cross_attn{i}")(
                output, srcs[lvl], poses[lvl], qpos, attn_bias
            )
            output = getattr(self, f"self_attn{i}")(output, qpos)
            output = getattr(self, f"ffn{i}")(output)
            logits, masks, dec_out = self.heads(output, mf, af)
            all_logits.append(logits)
            all_masks.append(masks)
            attn_bias = attn_bias_from_mask_logits(masks, size_list[(i + 1) % self.nlvl])

        if video:
            # masks (B, Q, T, H, W); logits (B, Q, C) or biases (B, T, nH, Q, h, w)
            masks_all = torch.stack(all_masks)
            logits_all = torch.stack(all_logits)
            out = {"pred_masks_all": masks_all, "pred_masks": masks_all[-1]}
        else:
            def to_video_masks(m):  # (B*T, Q, h, w) -> (B, Q, T, h, w)
                return m.reshape(bs, t, *m.shape[1:]).transpose(1, 2)

            masks_all = torch.stack([to_video_masks(m) for m in all_masks])
            logits_all = torch.stack(
                [lg.reshape(bs, t, *lg.shape[1:]) for lg in all_logits]
            )                             # (L+1, B, T, Q, D) or (L+1, B, T, nH, Q, h, w)
            out = {
                "pred_masks_all": masks_all,
                # per-frame query embeddings for tracking: decoder_norm(output)
                # of the last prediction
                "pred_embeds": dec_out.reshape(bs, t, self.num_queries, self.hidden_dim),
                "pred_masks": masks_all[-1],
                # BriVIS's resampler reads these, in JAX's layouts: the mask
                # features NHWC, the three token maps (N, hw_l, C) with their
                # level embeds and their encodings (1, hw_l, C)
                "mask_feats": mask_features.permute(0, 2, 3, 1),
                "ms_feats": srcs,
                "ms_pos": poses,
            }
        if af is None:
            out.update(pred_logits_all=logits_all, pred_logits=logits_all[-1])
        else:
            out.update(class_attn_biases_all=logits_all, class_attn_biases=logits_all[-1],
                       attn_feats=af.permute(0, 1, 3, 4, 2))    # (N, nH, h, w, C), as JAX's
        return out
