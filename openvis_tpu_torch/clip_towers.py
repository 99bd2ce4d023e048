"""The frozen CLIP visual tower and the mask-crop score paths of the eval
engine.

Port of ``openvis_tpu/clip_towers.py``: the towers of ``clip_adapter.name``
"clip" and "bg_clip" (the plain ViT, or the ModifiedResNet for RN50/RN101)
and "adapted" and "bg_adapted" (the mask-prompted towers of
``models/clip_mask_adapted.py``), the crop text rows with the learned
no-object row, the chunked mask-crop scoring over a video's real frames and
SimpleBaselineOnline's geometric-mean ensemble (``simplebsl.py:122-163``).

Under AMP eval (``test.amp``) the tower runs in bf16 with its LayerNorms and
softmaxes in f32, as the JAX package's ``amp_cast`` of the tower does.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from openvis_tpu_torch.config import Config
from openvis_tpu_torch.convert import params_from_flax
from openvis_tpu_torch.engine import eval_dtype
from openvis_tpu_torch.models.clip.build import build_clip_params
from openvis_tpu_torch.models.clip.model import is_resnet, model_shape, vision_tower
from openvis_tpu_torch.models.clip_adapter import clip_crop_classify, frame_average_scores
from openvis_tpu_torch.models.clip_mask_adapted import MaskAdaptedVisual


ADAPTED = ("adapted", "bg_adapted")


def build_clip_visual(cfg: Config, device) -> Callable:
    """The frozen CLIP visual tower of ``clip_adapter.clip_model_name`` from
    the local checkpoint ``clip_adapter.weights``, on ``device``, in the eval
    dtype, dispatched as the JAX package's ``build_clip_visual``
    (``openvis_tpu/clip_towers.py:38-111``): a ModifiedResNet name builds the
    maskable RN tower whatever the adapter, "adapted"/"bg_adapted" the
    mask-prompted ViT (a plain OpenAI file grafts in with a zero
    ``mask_embedding``, the reference's ``torch.zeros`` init), else the plain
    ViT, which leaves a file's ``mask_embedding`` unread as JAX's does.
    ``visual_apply`` maps (R, S, S, 3) normalized crops, and for the
    adapted adapters optional (R, S, S) soft masks, to (R, D) features.
    Under AMP every parameter is cast to bf16, as ``amp_cast`` casts the
    tree (the folded BatchNorms too, which ``FrozenAffine`` upcasts)."""
    ca = cfg.model.clip_adapter
    if not ca.weights:
        raise ValueError("model.clip_adapter.weights is empty: the CLIP visual tower needs the "
                         "path of a CLIP checkpoint (.pt)")
    shape = model_shape(ca.clip_model_name)
    vtree = build_clip_params(ca.weights)["visual"]
    if ca.name in ADAPTED and not is_resnet(shape):
        vis = MaskAdaptedVisual(shape["vision_patch"], shape["vision_width"],
                                shape["vision_layers"], shape["vision_heads"],
                                shape["embed_dim"], shape["image_size"], ca.mask_prompt_depth)
        if "mask_embedding" not in vtree:
            vtree = dict(vtree, mask_embedding=np.zeros(tuple(vis.mask_embedding.shape),
                                                        np.float32))
    else:  # a mask-adapted file's prompt table has no place in the plain towers
        vis = vision_tower(ca.clip_model_name)
        vtree = {k: v for k, v in vtree.items() if k != "mask_embedding"}
    vis.load_state_dict(params_from_flax(vtree), strict=True)
    vis = vis.to(device, eval_dtype(cfg)).eval().requires_grad_(False)

    def visual_apply(images: torch.Tensor, masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        with torch.inference_mode():
            return vis(images) if masks is None else vis(images, masks)

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
    ``clip_model.visual.input_resolution``, adapter.py:40); the adapted
    adapters hand the tower the soft mask crops when ``mask_prompt_fwd``
    (``adapted_clip_crop_classify``, ``mask_adapted_adapter.py:59-76``)."""
    ca = cfg.model.clip_adapter
    res = model_shape(ca.clip_model_name)["image_size"]
    stride = cfg.model.pixel_decoder.common_stride
    mask_prompt = ca.name in ADAPTED and ca.mask_prompt_fwd

    def fn(frames_raw, masks_q, text_feats):
        return clip_crop_classify(
            clip_visual_apply, frames_raw, torch.sigmoid(masks_q), text_feats,
            input_resolution=res, mask_stride=stride, sampling_ratio=ca.crop_sampling_ratio,
            mask_prompt=mask_prompt,
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
