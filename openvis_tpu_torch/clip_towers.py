"""The frozen CLIP visual tower and the mask-crop score paths of the eval
engine.

Port of ``openvis_tpu/clip_towers.py`` for SimpleBaselineOnline's
open-vocabulary ensemble (``simplebsl.py:122-163``): the plain ViT tower of
``clip_adapter.name`` "clip" or "bg_clip", the crop text rows with the
learned no-object row, the chunked mask-crop scoring over a video's real
frames and the geometric-mean ensemble.  The mask-adapted towers
("adapted", "bg_adapted") and the ModifiedResNet towers raise, naming
ROADMAP.md queue 1 item 8.6.

Under AMP eval (``test.amp``) the tower runs in bf16 with its LayerNorms and
softmaxes in f32, as the JAX package's ``amp_cast`` of the tower does.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from openvis_tpu_torch.config import Config
from openvis_tpu_torch.convert import params_from_flax
from openvis_tpu_torch.engine import eval_dtype
from openvis_tpu_torch.models.clip.build import build_clip_params
from openvis_tpu_torch.models.clip.model import model_shape, vision_tower
from openvis_tpu_torch.models.clip_adapter import clip_crop_classify, frame_average_scores


def _adapted_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, queue 1 item 8.6)")


def build_clip_visual(cfg: Config, device) -> Callable[[torch.Tensor], torch.Tensor]:
    """The frozen CLIP visual tower of ``clip_adapter.clip_model_name`` from
    the local checkpoint ``clip_adapter.weights``, on ``device``, in the eval
    dtype: ``visual_apply`` maps (R, S, S, 3) normalized crops to (R, D)
    features (the JAX package's ``(visual_apply, adapted)`` without the flag:
    the mask-adapted towers raise)."""
    ca = cfg.model.clip_adapter
    if ca.name in ("adapted", "bg_adapted"):
        raise _adapted_not_ported(f"the mask-adapted CLIP tower ({ca.name!r})")
    if not ca.weights:
        raise ValueError("model.clip_adapter.weights is empty: the CLIP visual tower needs the "
                         "path of a CLIP checkpoint (.pt)")
    vis = vision_tower(ca.clip_model_name)
    vis.load_state_dict(params_from_flax(build_clip_params(ca.weights)["visual"]), strict=True)
    vis = vis.to(device, eval_dtype(cfg)).eval().requires_grad_(False)

    def visual_apply(images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return vis(images)

    return visual_apply


def crop_text_with_bg(cfg: Config, params: Dict[str, torch.Tensor],
                      text: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """Text rows of the mask-crop classifier: the Bg adapters classify
    against the class rows plus the learned, normalized no-object row
    (``BgClipAdapter.encode_text``, adapter.py:150-161), the model's own
    ``non_object_embedding``.  Returns ``(rows, has_bg)``; ``has_bg`` drops
    that column before the ensemble's softmax."""
    bg = params.get("non_object_embedding")
    if not cfg.model.clip_adapter.name.startswith("bg") or bg is None:
        return text, False
    bg = bg.float()
    bg = bg / (torch.linalg.vector_norm(bg, dim=-1, keepdim=True) + 1e-6)
    return torch.cat([text, bg.to(text.dtype).reshape(1, -1)], dim=0), True


def apply_clip_ensemble(
    scores: torch.Tensor,       # (Q, K) softmaxed text-matching scores
    clip_logits: torch.Tensor,  # (T, Q, K [+1]) mask-crop CLIP logits (bg row last)
    valid: torch.Tensor,        # (T, Q)
    weight: float,
    drop_last: bool = True,
) -> torch.Tensor:
    """SimpleBSL's open_vocabulary_ensemble (simplebsl.py:122-163): the
    geometric mean ``scores^(1-w) * clip^w`` with the CLIP probabilities
    softmaxed a frame and averaged over the valid frames; a query valid in
    no frame keeps its scores.  ``drop_last`` removes the no-object column
    of a Bg adapter before the softmax."""
    clip_scores, qvalid = frame_average_scores(clip_logits, valid, mode="softmax_then_mean",
                                               drop_last=drop_last)
    clip_scores = torch.where(qvalid[:, None], clip_scores, 1.0)
    if weight <= 0:
        return torch.where(qvalid[:, None], clip_scores, scores)
    return torch.pow(scores, 1.0 - weight) * torch.pow(clip_scores, weight)


def make_openvis_score_fn(cfg: Config, clip_visual_apply) -> Callable:
    """f(frames_raw (T, H, W, 3) 0-255, masks (T, Q, h, w) logits at the
    mask stride, text rows) -> (logits (T, Q, K), valid (T, Q)): the crops
    at the tower's own resolution (the reference reads
    ``clip_model.visual.input_resolution``, adapter.py:40)."""
    ca = cfg.model.clip_adapter
    if ca.name in ("adapted", "bg_adapted"):
        raise _adapted_not_ported("the mask-adapted crop classifier")
    res = model_shape(ca.clip_model_name)["image_size"]

    def fn(frames_raw, masks_q, text_feats):
        return clip_crop_classify(
            clip_visual_apply, frames_raw, torch.sigmoid(masks_q), text_feats,
            input_resolution=res, mask_stride=cfg.model.pixel_decoder.common_stride,
            sampling_ratio=ca.crop_sampling_ratio,
        )

    return fn


def raw_frames(cfg: Config, pixels: np.ndarray, device) -> torch.Tensor:
    """The model's normalization undone on ``device``: the crops sample the
    original 0-255 frames (the reference feeds ``batched_inputs[0]["image"]``,
    simplebsl.py:297), in the eval dtype.  Computed in f64 and rounded once,
    as the JAX package's host numpy does."""
    x = torch.from_numpy(pixels).to(device, non_blocking=True)
    std = torch.tensor(cfg.model.pixel_std, dtype=torch.float64, device=device)
    mean = torch.tensor(cfg.model.pixel_mean, dtype=torch.float64, device=device)
    return (x.double() * std + mean).to(eval_dtype(cfg))


def clip_crop_scores(cfg: Config, score_fn, pixels: np.ndarray, masks_tq: torch.Tensor,
                     text_crop: torch.Tensor, window: int, t: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask-crop CLIP scoring over a video's ``t`` real frames in chunks of
    ``window`` frames (the reference's ``part_len`` chunks,
    simplebsl.py:127-136).  ``pixels``: the video's (T, H, W, 3) normalized
    frames on the host; ``masks_tq``: (T', Q, h, w) mask logits in track
    order, on the device.  Masks past ``t`` are dropped, so each mask pairs
    with its own frame (069751a).  Returns (logits (t, Q, K'), valid (t, Q))."""
    masks_tq = masks_tq[:t]
    lgs, vds = [], []
    for i in range(0, t, window):
        lg, vd = score_fn(raw_frames(cfg, pixels[i:i + window], masks_tq.device),
                          masks_tq[i:i + window], text_crop)
        lgs.append(lg)
        vds.append(vd)
    return torch.cat(lgs), torch.cat(vds)
