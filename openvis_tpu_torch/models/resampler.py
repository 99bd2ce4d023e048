"""Temporal instance resamplers (BriVIS).

Port of ``openvis_tpu/models/resampler.py``: ``TemporalResampler``,
``DecoupledTemporalResampler`` and ``RawTemporalResampler``.  Each of L
layers runs over the MinVIS-aligned per-frame query embeddings (B, T, Q, C)
viewed as B*Q sequences of length T: self-attention over T (``long{i}``,
post-norm), a replicate-padded 1-D convolution pair k5 -> ReLU -> k3 over T
with a residual (``short{i}_conv1/2``), a LayerNorm and an FFN.  The
decoupled variant then decodes learnable queries (``query_emb``,
``query_pos``) from each frame's refined embeds; the raw variant's layers
cross-attend each frame's queries into its multi-scale pixel tokens at level
``i % 3``.

The heads never feed back into the layers, so the L+1 layer outputs are
stacked and ``decode_norm`` and the heads (``mask_embed`` x mask features,
``attn_embed`` x attention features) run once over the stack.  The split
methods (``final_embeds`` + ``predict_frames``; the raw variant's
``temporal_half``, ``frame_half`` and ``finalize_embeds``) give the same
result in pieces, so the engine can run the heads window by window.

Module names are flax's, so ``convert`` maps the parameters by its rules; the
convolutions are ``nn.Conv1d`` on (B*Q, C, T), where JAX's ``nn.Conv`` runs
channels-last on (B*Q, T, C).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from openvis_tpu_torch.models.amp import amp_norm
from openvis_tpu_torch.models.transformer_decoder import (
    LN_EPS,
    MLP,
    CrossAttentionLayer,
    FFNLayer,
    MultiheadAttention,
    SelfAttentionLayer,
)


def _check_odd_kernels(ks: Sequence[int]) -> None:
    # replicate-pad k//2 per side + a VALID width-k conv keeps T only for odd k
    if any(k % 2 == 0 for k in ks):
        raise ValueError(
            f"resampler.conv_kernels={tuple(ks)}: all entries must be odd "
            "(replicate-pad + VALID conv must preserve the frame count)"
        )


def _to_sequences(x: torch.Tensor) -> torch.Tensor:
    """(B, T, Q, C) -> (B*Q, T, C)."""
    b, t, q, c = x.shape
    return x.transpose(1, 2).reshape(b * q, t, c)


def _to_frames(x: torch.Tensor, b: int) -> torch.Tensor:
    """(B*Q, T, C) -> (B*T, Q, C)."""
    bq, t, c = x.shape
    return x.reshape(b, bq // b, t, c).transpose(1, 2).reshape(b * t, bq // b, c)


class _TemporalStack(nn.Module):
    """The layers' shared temporal half and the heads."""

    def __init__(self, hidden_dim: int, feed_dim: int, nheads: int, nlayers: int,
                 conv_kernels: Sequence[int]):
        super().__init__()
        _check_odd_kernels(conv_kernels)
        self.nlayers = nlayers
        self.conv_kernels = tuple(conv_kernels)
        for i in range(nlayers):
            self.add_module(f"long{i}", MultiheadAttention(hidden_dim, nheads))
            self.add_module(f"long_norm{i}", nn.LayerNorm(hidden_dim, eps=LN_EPS))
            self.add_module(f"short{i}_conv1",
                            nn.Conv1d(hidden_dim, hidden_dim, self.conv_kernels[0]))
            self.add_module(f"short{i}_conv2",
                            nn.Conv1d(hidden_dim, hidden_dim, self.conv_kernels[1]))
            self.add_module(f"agg_norm{i}", nn.LayerNorm(hidden_dim, eps=LN_EPS))
        self.decode_norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.mask_embed = MLP(hidden_dim, hidden_dim, hidden_dim, 3)
        self.attn_embed = MLP(hidden_dim, hidden_dim, hidden_dim, 3)

    def temporal_half(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """Layer ``i``'s long/short temporal stack over (B*Q, T, C)."""
        x = amp_norm(getattr(self, f"long_norm{i}"), x + getattr(self, f"long{i}")(x, x, x))
        y = x.transpose(1, 2)                                       # (B*Q, C, T)
        k0, k1 = self.conv_kernels[0] // 2, self.conv_kernels[1] // 2
        y = getattr(self, f"short{i}_conv1")(F.pad(y, (k0, k0), mode="replicate"))
        y = getattr(self, f"short{i}_conv2")(F.pad(F.relu(y), (k1, k1), mode="replicate"))
        return amp_norm(getattr(self, f"agg_norm{i}"), y.transpose(1, 2) + x)

    def predict_frames(self, per_frame_embeds: torch.Tensor, mask_feats: torch.Tensor,
                       attn_feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Heads for a window: embeds (N, Q, C) normed, mask_feats (N, H, W, C),
        attn_feats (N, nH, h, w, C) -> (masks (N, Q, H, W), attention biases
        (N, nH, Q, h, w))."""
        me = self.mask_embed(per_frame_embeds)
        ae = self.attn_embed(per_frame_embeds)
        masks = torch.einsum("nqc,nhwc->nqhw", me, mask_feats)
        biases = torch.einsum("nqc,nmhwc->nmqhw", ae, attn_feats)
        return masks, biases

    def _heads(self, stacked: torch.Tensor, mask_feats: torch.Tensor,
               attn_feats: torch.Tensor, b: int) -> Dict[str, torch.Tensor]:
        """``stacked`` (L+1, B*T, Q, C) normed -> the layers' masks (L+1, B,
        Q, T, H, W), biases (L+1, B*T, nH, Q, h, w) and the last layer's
        embeds (B, T, Q, C)."""
        l1, bt, q, c = stacked.shape
        t = bt // b
        masks = torch.einsum("lnqc,nhwc->lnqhw", self.mask_embed(stacked), mask_feats)
        biases = torch.einsum("lnqc,nmhwc->lnmqhw", self.attn_embed(stacked), attn_feats)
        h, w = mask_feats.shape[1:3]
        return {"pred_masks_all": masks.reshape(l1, b, t, q, h, w).transpose(2, 3),
                "attn_biases_all": biases,
                "pred_embeds": stacked[-1].reshape(b, t, q, c)}


class TemporalResampler(_TemporalStack):
    """Per layer: the temporal half and an FFN (``ffn{i}``); heads on the
    aligned input and after every layer."""

    def __init__(self, hidden_dim: int = 256, feed_dim: int = 2048, nheads: int = 8,
                 nlayers: int = 6, conv_kernels: Sequence[int] = (5, 3)):
        super().__init__(hidden_dim, feed_dim, nheads, nlayers, conv_kernels)
        for i in range(nlayers):
            self.add_module(f"ffn{i}", FFNLayer(hidden_dim, feed_dim))

    def _encode_layers(self, frame_embeds: torch.Tensor) -> torch.Tensor:
        """(B, T, Q, C) -> normed stacked layer outputs (L+1, B*Q, T, C)."""
        x = _to_sequences(frame_embeds)
        outs = [x]
        for i in range(self.nlayers):
            x = getattr(self, f"ffn{i}")(self.temporal_half(x, i))
            outs.append(x)
        return amp_norm(self.decode_norm, torch.stack(outs))

    def final_embeds(self, frame_embeds: torch.Tensor) -> torch.Tensor:
        """(B, T, Q, C) -> the last layer's normed per-frame embeds (B, T, Q, C)."""
        b, t, q, c = frame_embeds.shape
        return self._encode_layers(frame_embeds)[-1].reshape(b, q, t, c).transpose(1, 2)

    def forward(self, frame_embeds: torch.Tensor, mask_feats: torch.Tensor,
                attn_feats: torch.Tensor) -> Dict[str, torch.Tensor]:
        """frame_embeds (B, T, Q, C) aligned; mask_feats (B*T, H, W, C);
        attn_feats (B*T, nH, h, w, C)."""
        b = frame_embeds.shape[0]
        normed = self._encode_layers(frame_embeds)                  # (L+1, B*Q, T, C)
        per_frame = torch.stack([_to_frames(x, b) for x in normed])  # (L+1, B*T, Q, C)
        return self._heads(per_frame, mask_feats, attn_feats, b)


class DecoupledTemporalResampler(_TemporalStack):
    """The temporal stack, then per layer learnable queries cross-attend to
    their frame's refined embeds (``tgt_ca{i}``), self-attend
    (``tgt_sa{i}``) and pass an FFN (``tgt_ffn{i}``); heads on the queries
    before the layers and after every layer."""

    def __init__(self, hidden_dim: int = 256, feed_dim: int = 2048, nheads: int = 8,
                 nlayers: int = 6, conv_kernels: Sequence[int] = (5, 3),
                 nqueries: int = 100):
        super().__init__(hidden_dim, feed_dim, nheads, nlayers, conv_kernels)
        self.nqueries = nqueries
        for i in range(nlayers):
            self.add_module(f"ffn{i}", FFNLayer(hidden_dim, feed_dim))
            self.add_module(f"tgt_ca{i}", CrossAttentionLayer(hidden_dim, nheads))
            self.add_module(f"tgt_sa{i}", SelfAttentionLayer(hidden_dim, nheads))
            self.add_module(f"tgt_ffn{i}", FFNLayer(hidden_dim, feed_dim))
        self.query_emb = nn.Parameter(torch.zeros(nqueries, hidden_dim))
        self.query_pos = nn.Parameter(torch.zeros(nqueries, hidden_dim))

    def _tgt_layers(self, frame_embeds: torch.Tensor) -> List[torch.Tensor]:
        """(B, T, Q, C) -> the L+1 query states (B*T, nQ, C), before decode_norm."""
        b, t, q, c = frame_embeds.shape
        x = _to_sequences(frame_embeds)
        tgt = self.query_emb[None].expand(b * t, -1, -1).to(frame_embeds.dtype)
        qpos = self.query_pos[None].to(frame_embeds.dtype)
        tgts = [tgt]
        for i in range(self.nlayers):
            x = getattr(self, f"ffn{i}")(self.temporal_half(x, i))
            mem = _to_frames(x, b)                                  # (B*T, Q, C)
            tgt = getattr(self, f"tgt_ca{i}")(tgt, mem, torch.zeros_like(mem[:1]), qpos)
            tgt = getattr(self, f"tgt_sa{i}")(tgt, qpos)
            tgt = getattr(self, f"tgt_ffn{i}")(tgt)
            tgts.append(tgt)
        return tgts

    def final_embeds(self, frame_embeds: torch.Tensor) -> torch.Tensor:
        """(B, T, Q, C) -> the last layer's normed query embeds (B, T, nQ, C)."""
        b, t, _, c = frame_embeds.shape
        out = amp_norm(self.decode_norm, self._tgt_layers(frame_embeds)[-1])
        return out.reshape(b, t, self.nqueries, c)

    def forward(self, frame_embeds, mask_feats, attn_feats) -> Dict[str, torch.Tensor]:
        stacked = amp_norm(self.decode_norm, torch.stack(self._tgt_layers(frame_embeds)))
        return self._heads(stacked, mask_feats, attn_feats, frame_embeds.shape[0])


class RawTemporalResampler(_TemporalStack):
    """The temporal half, then per frame a cross-attention into the frame's
    pixel tokens at level ``i % 3`` (``cross{i}``), a query self-attention
    (``self{i}``) and an FFN (``ffn{i}``); heads on the aligned input and
    after every layer."""

    def __init__(self, hidden_dim: int = 256, feed_dim: int = 2048, nheads: int = 8,
                 nlayers: int = 6, conv_kernels: Sequence[int] = (5, 3)):
        super().__init__(hidden_dim, feed_dim, nheads, nlayers, conv_kernels)
        for i in range(nlayers):
            self.add_module(f"cross{i}", CrossAttentionLayer(hidden_dim, nheads))
            self.add_module(f"self{i}", SelfAttentionLayer(hidden_dim, nheads))
            self.add_module(f"ffn{i}", FFNLayer(hidden_dim, feed_dim))

    def frame_half(self, pf: torch.Tensor, ms_feat: torch.Tensor, ms_pos: torch.Tensor,
                   i: int) -> torch.Tensor:
        """Layer ``i``'s per-frame half over (N, Q, C) against the frames'
        tokens ``ms_feat`` (N, hw, C) of the caller's level and ``ms_pos``
        (1, hw, C).  Frames never mix, so windows of frames give the same
        result."""
        zeros = torch.zeros((1, *pf.shape[1:]), dtype=pf.dtype, device=pf.device)
        pf = getattr(self, f"cross{i}")(pf, ms_feat, ms_pos, zeros)
        pf = getattr(self, f"self{i}")(pf, zeros)
        return getattr(self, f"ffn{i}")(pf)

    def finalize_embeds(self, pf: torch.Tensor) -> torch.Tensor:
        """``decode_norm``: the heads read normed embeds."""
        return amp_norm(self.decode_norm, pf)

    def forward(self, frame_embeds, mask_feats, attn_feats, ms_feats: Sequence[torch.Tensor],
                ms_pos: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """ms_feats / ms_pos: the frame decoder's three token maps (B*T, hw_l,
        C) and their encodings (1, hw_l, C), top-down."""
        b, t, q, c = frame_embeds.shape
        x = _to_sequences(frame_embeds)
        outs = [frame_embeds.reshape(b * t, q, c)]
        for i in range(self.nlayers):
            lvl = i % len(ms_feats)
            pf = self.frame_half(_to_frames(self.temporal_half(x, i), b), ms_feats[lvl],
                                 ms_pos[lvl], i)
            outs.append(pf)
            x = _to_sequences(pf.reshape(b, t, q, c))
        stacked = self.finalize_embeds(torch.stack(outs))
        return self._heads(stacked, mask_feats, attn_feats, b)


def build_resampler(name: str, **kw) -> nn.Module:
    """``model.resampler.name`` -> its module; ``nqueries`` is the decoupled
    variant's only."""
    nqueries = kw.pop("nqueries")
    if name == "decoupled":
        return DecoupledTemporalResampler(nqueries=nqueries, **kw)
    if name == "raw":
        return RawTemporalResampler(**kw)
    if name == "temporal":
        return TemporalResampler(**kw)
    raise ValueError(f"unknown resampler {name!r}")
