"""Host-side clip-consistent image transforms (numpy + PIL).

Rebuild of the reference's clip-consistent augmentations
(``openvis/data/augmentation.py``): ``ResizeShortestEdge`` (choice-by-clip),
``RandomFlip`` (flip-by-clip), ``RandomRotationClip`` (clip-level base angle
with per-frame jitter, used for COCO pseudo-clips).  The reference replays a
cached random draw for ``clip_frame_cnt`` consecutive single-frame calls
(``augmentation.py:42-50``); here every transform takes the whole clip at
once, so clip consistency is structural instead of stateful.

All functions transform frames (uint8 HWC RGB) and per-instance masks
(uint8 HW) identically.

Copy of ``openvis_tpu/data/transforms.py`` for the PyTorch port.  PIL is
imported inside the functions that use it, so the port imports without it.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np


def resize_shortest_edge_size(
    h: int, w: int, short: int, max_size: int
) -> Tuple[int, int]:
    """d2 ResizeShortestEdge sizing: scale so min side == short, cap max
    side at max_size."""
    scale = short / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    return nh, nw


def resize_frame(frame: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    from PIL import Image

    img = Image.fromarray(frame)
    return np.asarray(img.resize((size_hw[1], size_hw[0]), Image.BILINEAR))


def resize_mask(mask: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    from PIL import Image

    img = Image.fromarray(mask)
    return np.asarray(img.resize((size_hw[1], size_hw[0]), Image.NEAREST))


def hflip_frame(frame: np.ndarray) -> np.ndarray:
    return frame[:, ::-1]


def rotate_frame(
    frame: np.ndarray, angle_deg: float, center_rel: Tuple[float, float],
    resample=None,
) -> np.ndarray:
    """Rotate around a relative center without expanding (d2
    RandomRotation(expand=False) semantics); ``resample`` defaults to
    ``Image.BILINEAR``."""
    from PIL import Image

    if resample is None:
        resample = Image.BILINEAR
    h, w = frame.shape[:2]
    img = Image.fromarray(frame)
    out = img.rotate(
        angle_deg,
        resample=resample,
        center=(center_rel[0] * w, center_rel[1] * h),
        expand=False,
        fillcolor=0,
    )
    return np.asarray(out)


def _blend(img: np.ndarray, src, w: float) -> np.ndarray:
    """d2 BlendTransform: ``src*(1-w) + img*w`` clipped to uint8."""
    out = src * (1.0 - w) + img.astype(np.float32) * w
    return np.clip(out, 0, 255).astype(np.uint8)


def color_jitter(
    rng: np.random.RandomState, img: np.ndarray, kinds: Sequence[str],
    lo: float = 0.9, hi: float = 1.1,
) -> np.ndarray:
    """d2 RandomBrightness/Contrast/Saturation(0.9, 1.1), applied in the
    reference's build order (augmentation.py:356-361).  Draws are per FRAME
    (the reference appends plain per-call ``T.Random*`` transforms)."""
    if "brightness" in kinds:
        img = _blend(img, 0.0, rng.uniform(lo, hi))
    if "contrast" in kinds:
        img = _blend(img, img.astype(np.float32).mean(), rng.uniform(lo, hi))
    if "saturation" in kinds:
        gray = img.astype(np.float32) @ np.asarray([0.299, 0.587, 0.114])
        img = _blend(img, gray[:, :, None], rng.uniform(lo, hi))
    return img


def resize_scale_clip_size(
    rng: np.random.RandomState, h: int, w: int,
    min_scale: float, max_scale: float, target_h: int, target_w: int,
) -> Tuple[int, int]:
    """``ResizeScaleClip`` (augmentation.py:127-182): ONE clip-level scale
    draw in [min_scale, max_scale]; the image is scaled to fit inside the
    scaled target box, aspect ratio kept (the TF 'resize_and_crop' resize
    half).  Returns the output (H', W') — np.round like the reference."""
    s = rng.uniform(min_scale, max_scale)
    out_scale = min(target_h * s / h, target_w * s / w)
    nh, nw = np.round(np.multiply((h, w), out_scale)).astype(int)
    return int(nh), int(nw)


def fixed_size_crop_clip(
    rng: np.random.RandomState,
    frames: List[np.ndarray],
    masks_per_frame: Optional[List[List[np.ndarray]]],
    crop_hw: Tuple[int, int],
    pad_value: float = 128.0,
):
    """``FixedSizeCropClip`` (augmentation.py:258-313): ONE offset draw per
    clip — a SINGLE scalar uniform multiplies both max offsets (the
    reference's ``np.multiply(max_offset, np.random.uniform(0.0, 1.0))``) —
    crop when the input is larger, pad bottom/right to ``crop_hw`` when
    smaller (frames with ``pad_value``, masks with 0)."""
    ch, cw = crop_hw
    h, w = frames[0].shape[:2]
    max_off = np.maximum(np.subtract((h, w), (ch, cw)), 0)
    off = np.round(max_off * rng.uniform(0.0, 1.0)).astype(int)
    y0, x0 = int(off[0]), int(off[1])

    def one(img: np.ndarray, pad: float) -> np.ndarray:
        img = img[y0 : y0 + ch, x0 : x0 + cw]
        ph, pw = ch - img.shape[0], cw - img.shape[1]
        if ph > 0 or pw > 0:
            pad_width = [(0, ph), (0, pw)] + [(0, 0)] * (img.ndim - 2)
            img = np.pad(img, pad_width, constant_values=pad)
        return img

    out_frames = [one(f, pad_value).astype(np.uint8) for f in frames]
    out_masks = None
    if masks_per_frame is not None:
        out_masks = [[one(m, 0) for m in ms] for ms in masks_per_frame]
    return out_frames, out_masks


class ClipAugmenter:
    """Samples one set of random draws per clip and applies them to every
    frame (+ masks), in the reference's composition order
    (``build_augmentation``, augmentation.py:315-377):

      RandomApply(0.5)[resize {400,500,600} + crop] -> resize (choice by
      clip) -> flip (by clip) -> brightness/contrast/saturation (per frame)
      -> rotation (by clip; per-frame jitter for COCO pseudo-clips).
    """

    def __init__(
        self,
        min_sizes: Sequence[int],
        max_size: int,
        flip: bool = True,
        augmentations: Sequence[str] = (),
        rotation_range: Tuple[float, float] = (-15.0, 15.0),
        is_train: bool = True,
        crop: bool = False,
        crop_type: str = "absolute_range",
        crop_size: Tuple[int, int] = (600, 720),
        crop_prob: float = 0.5,
        crop_pre_sizes: Sequence[int] = (400, 500, 600),
        sampling: str = "choice_by_clip",
    ):
        # d2 ResizeShortestEdge sampling styles (the clip-consistent wrapper
        # draws ONE size per clip either way — "choice_by_clip" is the
        # reference's name for that, ytvis_dataset_mapper.py:310-318):
        # choice/choice_by_clip pick from min_sizes, range draws uniformly in
        # [min(min_sizes), max(min_sizes)].
        if sampling not in ("choice", "choice_by_clip", "range"):
            raise ValueError(
                f"min_size_train_sampling={sampling!r}: expected 'choice', "
                "'choice_by_clip', or 'range'"
            )
        self.sampling = sampling
        self.min_sizes = list(min_sizes)
        self.max_size = max_size
        self.flip = flip
        self.augmentations = tuple(augmentations)
        self.rotation = "rotation" in self.augmentations
        self.rotation_range = rotation_range
        self.is_train = is_train
        self.crop = crop
        self.crop_type = crop_type
        self.crop_size = tuple(crop_size)
        self.crop_prob = crop_prob
        self.crop_pre_sizes = list(crop_pre_sizes)

    def _crop_box(self, rng, h: int, w: int) -> Tuple[int, int, int, int]:
        """Clip-consistent crop box (RandomCropClip, augmentation.py:214-227;
        d2 absolute_range semantics: crop H in [size0, size1] capped at h)."""
        c0, c1 = self.crop_size
        if self.crop_type == "absolute_range":
            ch = min(h, rng.randint(min(c0, h), min(c1, h) + 1))
            cw = min(w, rng.randint(min(c0, w), min(c1, w) + 1))
        elif self.crop_type == "absolute":
            ch, cw = min(c0, h), min(c1, w)
        else:  # relative / relative_range
            ch = int(h * (c0 + (1 - c0) * rng.rand())) if self.crop_type == "relative_range" else int(h * c0)
            cw = int(w * (c1 + (1 - c1) * rng.rand())) if self.crop_type == "relative_range" else int(w * c1)
        y0 = rng.randint(0, h - ch + 1)
        x0 = rng.randint(0, w - cw + 1)
        return y0, x0, ch, cw

    def __call__(
        self,
        rng: np.random.RandomState,
        frames: List[np.ndarray],
        masks_per_frame: Optional[List[List[np.ndarray]]] = None,
        per_frame_rotation: bool = False,
    ):
        h, w = frames[0].shape[:2]

        # 1. RandomApply(0.5)[pre-resize {400,500,600} + crop], by clip
        #    (augmentation.py:326-333)
        pre_size = None
        crop_box = None
        if self.crop and self.is_train and rng.rand() < self.crop_prob:
            pre_short = self.crop_pre_sizes[
                rng.randint(len(self.crop_pre_sizes))
            ]
            pre_size = resize_shortest_edge_size(h, w, pre_short, 1333)
            crop_box = self._crop_box(rng, pre_size[0], pre_size[1])
            h, w = crop_box[2], crop_box[3]

        # 2. main resize, one draw per clip (style per min_size_train_sampling)
        if self.is_train:
            if self.sampling == "range":
                short = rng.randint(min(self.min_sizes), max(self.min_sizes) + 1)
            else:  # choice / choice_by_clip
                short = self.min_sizes[rng.randint(len(self.min_sizes))]
        else:
            short = self.min_sizes[0]
        size = resize_shortest_edge_size(h, w, short, self.max_size)

        # 3. flip by clip
        do_flip = self.is_train and self.flip and rng.rand() < 0.5

        # 5. rotation base draw, by clip (RandomRotationClip)
        if self.rotation and self.is_train:
            base_angle = rng.uniform(*self.rotation_range)
            cx = rng.uniform(0.4, 0.6)
            cy = rng.uniform(0.4, 0.6)
        else:
            base_angle = 0.0
            cx = cy = 0.5

        color_kinds = tuple(
            k for k in ("brightness", "contrast", "saturation")
            if k in self.augmentations
        ) if self.is_train else ()

        out_frames, out_masks = [], []
        for fi, frame in enumerate(frames):
            # per-frame draws happen in a fixed order regardless of masks
            angle = base_angle
            if per_frame_rotation and self.rotation and self.is_train:
                angle = base_angle + rng.uniform(-2.0, 2.0)
            f = frame
            if pre_size is not None:
                y0, x0, ch, cw = crop_box
                f = resize_frame(f, pre_size)[y0 : y0 + ch, x0 : x0 + cw]
            f = resize_frame(f, size)
            if do_flip:
                f = hflip_frame(f)
            if color_kinds:  # 4. per-frame color jitter
                f = color_jitter(rng, f, color_kinds)
            if angle != 0.0:
                f = rotate_frame(f, angle, (cx, cy))
            out_frames.append(f)
            if masks_per_frame is not None:
                ms = []
                for m in masks_per_frame[fi]:
                    mm = m
                    if pre_size is not None:
                        y0, x0, ch, cw = crop_box
                        mm = resize_mask(mm, pre_size)[
                            y0 : y0 + ch, x0 : x0 + cw
                        ]
                    mm = resize_mask(mm, size)
                    if do_flip:
                        mm = mm[:, ::-1]
                    if angle != 0.0:
                        from PIL import Image

                        mm = rotate_frame(mm, angle, (cx, cy), Image.NEAREST)
                    ms.append(mm)
                out_masks.append(ms)
        return out_frames, (out_masks if masks_per_frame is not None else None), size
