"""Checkpoint save and restore with ``torch.save``, and pretrained init.

Port of ``openvis_tpu/checkpoint.py`` (orbax there).  A checkpoint directory
holds ``ckpt_<step>.pt`` files, each a ``TrainState.state_dict()``: the step,
the f32 parameters and the optimizer's state (AdamW's moments ``mu``/``nu``
or SGD's ``trace``, and ``count``), as CPU tensors and ints only, so they load
with ``weights_only=True``.  A checkpoint of one optimizer restored under the
other raises, naming both.  A file is
written under a temporary name, synced and renamed, so a run killed while
saving leaves the previous checkpoint readable; the latest ``keep`` (5, as
orbax's ``max_to_keep`` there) are kept.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import torch

_NAME = re.compile(r"ckpt_(\d+)\.pt")


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.fullmatch, os.listdir(directory)) if m)


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.pt")


def _to_cpu(obj):
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    return obj


def save_checkpoint(directory: str, step: int, state: Dict, keep: int = 5) -> str:
    """Write ``state`` (a ``TrainState.state_dict()``) as step ``step``;
    returns the file's path."""
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        torch.save(_to_cpu(state), f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    for old in _steps(directory)[:-keep]:
        os.remove(_path(directory, old))
    return path


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def load_checkpoint(directory: str) -> Optional[Dict]:
    """The latest state dict on the CPU, or None if the directory holds no
    checkpoint."""
    step = latest_step(directory)
    if step is None:
        return None
    return torch.load(_path(directory, step), map_location="cpu", weights_only=True)


def restore_checkpoint(directory: str, state):
    """Load the latest checkpoint into ``state`` (a ``TrainState``) in place;
    returns it, or None if the directory holds no checkpoint."""
    sd = load_checkpoint(directory)
    if sd is None:
        return None
    state.load_state_dict(sd)
    return state


def load_params_from_checkpoint(directory: str) -> Optional[Dict[str, torch.Tensor]]:
    """The ``params`` of the latest checkpoint (the port's state_dict keys),
    for grafting onto a fresh init with :func:`merge_pretrained`; None if the
    directory holds no checkpoint."""
    sd = load_checkpoint(directory)
    if sd is None:
        return None
    if "params" not in sd:
        raise ValueError(f"checkpoint in {directory} has no 'params'")
    return sd["params"]


def merge_pretrained(params: Dict[str, torch.Tensor], pretrained: Dict[str, torch.Tensor],
                     subtree: str = "") -> Dict[str, torch.Tensor]:
    """Graft ``pretrained`` (state_dict keys, under ``subtree`` if given)
    onto ``params``: its keys override, everything else keeps its value (the
    d2 checkpointer's partial load)."""
    prefix = f"{subtree}." if subtree else ""
    out = dict(params)
    out.update({prefix + k: v for k, v in pretrained.items()})
    return out
