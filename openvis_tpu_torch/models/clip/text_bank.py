"""Prompt-ensembled text-embedding bank.

Port of ``openvis_tpu/models/clip/text_bank.py`` (the reference's
``ClipAdapter.encode_text`` cache, ``openvis/modeling/clip_adapter/adapter.py:121-138``):
each class name is encoded once under every template, the per-template
embeddings are L2-normalized, averaged and normalized again.  The text tower
runs on the bank's device in chunks of ``batch_size`` prompts, each cut after
its last EOT token (the causal tower's features there read no later
position); the chunks are not padded to one shape (nothing is traced), and
the rows equal the JAX bank's.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from openvis_tpu_torch.models.clip.model import CLIPTextEncoder
from openvis_tpu_torch.models.clip.tokenizer import SimpleTokenizer, tokenize


def normalize(x: np.ndarray, axis: int = -1, eps: float = 0.0) -> np.ndarray:
    n = np.linalg.norm(x, axis=axis, keepdims=True)
    return x / (n + eps)


class TextEmbeddingBank:
    def __init__(self, text_encoder: CLIPTextEncoder, tokenizer: SimpleTokenizer,
                 templates: Sequence[str], device, batch_size: int = 256):
        self.device = torch.device(device)
        self.encoder = text_encoder.to(self.device).eval()
        self.tokenizer = tokenizer
        self.templates = list(templates)
        self.batch_size = batch_size
        self.cache: Dict[str, np.ndarray] = {}

    @torch.inference_mode()
    def _encode_tokens(self, tokens: np.ndarray) -> np.ndarray:
        """Each chunk cut after its last EOT (the highest token id): the
        causal tower's EOT feature reads no later position, so the rows are
        those of the whole context (a prompt of the vild set is ~10 of 77)."""
        outs = []
        for i in range(0, len(tokens), self.batch_size):
            chunk = tokens[i:i + self.batch_size]
            chunk = chunk[:, :int(chunk.argmax(axis=1).max()) + 1]
            chunk = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device, torch.long)
            outs.append(self.encoder(chunk).float().cpu().numpy())
        return np.concatenate(outs, axis=0)

    def encode(self, class_names: Sequence[str]) -> np.ndarray:
        """-> (K, D) float32, prompt-ensembled and normalized."""
        new = [n for n in class_names if n not in self.cache]
        if new:
            per_template = []
            for tmpl in self.templates:
                toks = tokenize(self.tokenizer, [tmpl.format(n) for n in new],
                                self.encoder.context_length)
                per_template.append(normalize(self._encode_tokens(toks)))
            emb = normalize(np.stack(per_template).mean(0))
            for i, n in enumerate(new):
                self.cache[n] = emb[i].astype(np.float32)
        return np.stack([self.cache[n] for n in class_names])
