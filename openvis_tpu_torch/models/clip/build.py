"""CLIP weights from a local file.

Port of ``openvis_tpu/models/clip/build.py::build_clip_params`` for local
files: an OpenAI JIT archive (``ViT-B-16.pt`` as OpenAI publishes it) or a
plain state-dict ``.pt``, converted by ``weights.convert_clip`` into the
flax-layout tree that ``convert.params_from_flax`` maps onto the towers, or
the JAX package's converted ``.msgpack`` (``tools/convert_weights.py clip``),
which already is that tree (``utils/flax_msgpack.py``).  Fetching a model by
name or URL (the JAX package's rank-0 download) is ROADMAP.md queue 1 item 8.
"""

from __future__ import annotations

import os
import zipfile
from typing import Dict

import numpy as np
import torch

from openvis_tpu_torch.utils.flax_msgpack import read_msgpack
from openvis_tpu_torch.weights import convert_clip, load_torch_state


def _is_jit_archive(path: str) -> bool:
    """TorchScript archives hold ``constants.pkl``; ``torch.save`` files do not."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return any(n.endswith("/constants.pkl") for n in z.namelist())


def load_clip_state(path: str) -> Dict[str, np.ndarray]:
    """An OpenAI CLIP checkpoint's tensors as f32 numpy arrays by name."""
    if not os.path.isfile(path):
        raise ValueError(
            f"CLIP weights {path!r}: not a local file; fetching a CLIP model by name or URL "
            "is not ported yet (ROADMAP.md, queue 1 item 8): pass the path of the "
            "checkpoint (.pt)")
    if path.endswith(".msgpack"):
        raise ValueError(f"{path}: a converted flax tree, not a checkpoint's tensors; "
                         "build_clip_params reads it")
    if _is_jit_archive(path):
        state = torch.jit.load(path, map_location="cpu").state_dict()
        return {k: v.float().numpy() for k, v in state.items()}
    return load_torch_state(path)


def build_clip_params(path: str) -> Dict:
    """A local CLIP checkpoint as the tree ``{visual, text, logit_scale}``; a
    ``.msgpack`` is that tree already (JAX ``build.py:127-128``)."""
    if path.endswith(".msgpack") and os.path.isfile(path):
        return read_msgpack(path)
    return convert_clip(load_clip_state(path))
