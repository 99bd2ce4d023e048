"""Parameters between the JAX package and the port, and the port's own init.

``params_from_flax`` maps a flax parameter tree (nested dicts of numpy arrays)
onto the port's ``state_dict`` keys.  The port's module names mirror the flax
ones, so the key is the flax path joined by dots, and the leaves map as:

  * Dense ``kernel`` (in, out)      -> ``weight`` (out, in)
  * Conv ``kernel`` HWIO            -> ``weight`` OIHW
  * LayerNorm/GroupNorm ``scale``   -> ``weight``
  * everything else as it is: ``bias``, the ``FrozenAffine`` ``scale``/``bias``
    of the ResNet, ``level_embed``, ``query_feat``, ``query_embed``,
    ``non_object_embedding``.

``load_flax_params`` loads such a tree strictly: a missing, unknown or
misshapen key raises.  ``init_params`` draws the port's own seeded init.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from openvis_tpu_torch.models.backbone.resnet import FrozenAffine
from openvis_tpu_torch.models.pixel_decoder import MSDeformAttnModule, ring_bias

_RESNET_BLOCK = re.compile(r"res\d+_block\d+")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), val


def _is_frozen_affine(path: Tuple[str, ...]) -> bool:
    """The ResNet's folded BatchNorms: the stem norm and the norms directly
    inside a ``res<k>_block<b>``."""
    return path[-2].startswith("stem_norm") or (
        len(path) >= 3 and _RESNET_BLOCK.fullmatch(path[-3]) is not None
    )


def _to_torch(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch.from_numpy
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # a writable, contiguous copy


def params_from_flax(np_tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax parameter tree -> the port's state_dict."""
    state: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(np_tree):
        *mods, leaf = path
        arr = np.asarray(arr)
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim}")
            leaf = "weight"
        elif leaf == "scale" and not _is_frozen_affine(path):
            leaf = "weight"
        state[".".join([*mods, leaf])] = _to_torch(arr)
    return state


def flax_path(key: str, ndim: int) -> Tuple[str, ...]:
    """The flax path of the port's parameter ``key`` of rank ``ndim``: a
    Dense/Conv ``weight`` is flax's ``kernel``, a norm ``weight`` its
    ``scale``."""
    *mods, leaf = key.split(".")
    if leaf == "weight":
        leaf = "kernel" if ndim in (2, 4) else "scale"
    return (*mods, leaf)


def flax_from_state_dict(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_flax` (f32 numpy leaves)."""
    tree: Dict[str, Any] = {}
    for key, t in state.items():
        arr = t.detach().cpu().float().numpy()
        *mods, leaf = flax_path(key, arr.ndim)
        if leaf == "kernel":
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.array(arr)  # a copy: never a view of a live tensor
    return tree


def load_flax_params(model: nn.Module, np_tree: Mapping) -> nn.Module:
    """Load a flax tree into ``model``; raises on missing or unknown keys and
    on shape mismatches."""
    model.load_state_dict(params_from_flax(np_tree), strict=True)
    return model


def _lecun_normal_(w: torch.Tensor, g: torch.Generator) -> None:
    """flax's default kernel init: truncated normal (+-2 sigma) with variance
    1 / fan_in."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # truncation correction
    draw = torch.fmod(torch.randn(w.shape, generator=g), 2.0)
    w.copy_(draw * std)


@torch.no_grad()
def init_params(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random init following the JAX package's initializers: lecun-normal
    kernels with zero biases, unit norms, identity frozen affines, N(0, 1)
    level/query embeddings, N(0, hidden^-1/2) no-object embedding, and the
    MSDeformAttn ring bias with zero sampling-offset and attention-weight
    kernels.  Draws on the CPU, so a seed gives the same weights everywhere."""
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            _lecun_normal_(mod.weight, g)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, FrozenAffine):
            mod.scale.fill_(1.0)
            mod.bias.zero_()
        for name, p in mod.named_parameters(recurse=False):
            if name in ("level_embed", "query_feat", "query_embed"):
                p.copy_(torch.randn(p.shape, generator=g))
            elif name == "non_object_embedding":
                hidden = mod.segmenter.predictor.hidden_dim
                p.copy_(torch.randn(p.shape, generator=g) * hidden ** -0.5)
    # after the generic pass, which reaches a module's Linears after the module
    for mod in model.modules():
        if isinstance(mod, MSDeformAttnModule):
            mod.sampling_offsets.weight.zero_()
            mod.sampling_offsets.bias.copy_(torch.from_numpy(
                ring_bias(mod.n_heads, mod.n_levels, mod.n_points)))
            mod.attention_weights.weight.zero_()
            mod.attention_weights.bias.zero_()
    return model
