"""Dataset mappers: video record -> fixed-shape numpy training sample.

Rebuild of ``YTVISDatasetMapper`` (``openvis/data/ytvis_dataset_mapper.py:
131-347``) and ``CocoClipDatasetMapper`` (``:350-541``):

  * ``select_frames``: pick a random reference frame, sample
    ``sampling_frame_num - 1`` more within ±``sampling_frame_range``, sort
    (optional shuffle/reverse) (``:210-261``);
  * stable instance identity across frames via an annotation-id -> slot map,
    with absent-in-frame instances getting empty masks (``:285-346``'s
    dummy-anno scheme);
  * COCO pseudo-clips: one still image re-augmented per frame with rotation
    jitter so image data trains the video pipeline (``:472-541``);
  * TPU delta: every sample is padded on the host to the static
    ``(T, pad_h, pad_w)`` canvas and ``max_instances`` slot count, so the
    device only ever sees one (orientation-bucketed) shape.

Samples are plain dicts of numpy arrays (the JAX package's ``collate``
stacks them into its ``ImageBatch`` / ``ClipTargets`` structures).

Copy of ``openvis_tpu/data/mapper.py`` for the PyTorch port; PIL is imported
inside the mappers' calls, so the port imports without it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from openvis_tpu_torch.config import InputConfig
from openvis_tpu_torch.data.catalog import DatasetInfo
from openvis_tpu_torch.data.rle import segm_to_mask
from openvis_tpu_torch.data.transforms import ClipAugmenter


def load_ytvis_records(info: DatasetInfo, root: str, is_train: bool) -> List[Dict]:
    """Parse a YTVIS-format json into per-video records
    (``load_ytvis_json``, ytvis.py:145-271)."""
    path = os.path.join(root, info.json_file)
    with open(path) as f:
        data = json.load(f)
    anns_by_vid: Dict[int, List[dict]] = {}
    for ann in data.get("annotations", []) or []:
        anns_by_vid.setdefault(ann["video_id"], []).append(ann)
    records = []
    for vid in sorted(data["videos"], key=lambda v: v["id"]):
        records.append({
            "file_names": [
                os.path.join(root, info.image_root, fn) for fn in vid["file_names"]
            ],
            "height": vid["height"],
            "width": vid["width"],
            "length": vid["length"],
            "video_id": vid["id"],
            "annotations": anns_by_vid.get(vid["id"], []),
        })
    return records


def load_burst_records(info: DatasetInfo, root: str) -> List[Dict]:
    """Parse a BURST (TAO) json into YTVIS-style per-video records
    (``load_burst_json``, burst.py:538-583): sequences carry per-frame
    {track_id: {rle}} dicts which we pivot into track-major annotations so
    the standard clip mapper applies unchanged."""
    path = os.path.join(root, info.json_file)
    with open(path) as f:
        data = json.load(f)
    records = []
    for seq_id, seq in enumerate(data["sequences"]):
        h, w = seq["height"], seq["width"]
        t = len(seq["annotated_image_paths"])
        track_cats = seq["track_category_ids"]
        tracks: Dict[str, Dict] = {}
        for fi, segm in enumerate(seq["segmentations"][:t]):
            for tid, anno in segm.items():
                tr = tracks.setdefault(tid, {
                    "id": int(tid),
                    "video_id": seq.get("id", seq_id + 1),
                    "category_id": track_cats[tid],
                    "segmentations": [None] * t,
                    "bboxes": [None] * t,
                    "iscrowd": 0,
                })
                tr["segmentations"][fi] = {
                    "size": [h, w], "counts": anno["rle"]
                }
        records.append({
            "file_names": [
                os.path.join(root, info.image_root, seq["dataset"],
                             seq["seq_name"], x)
                for x in seq["annotated_image_paths"]
            ],
            "height": h,
            "width": w,
            "length": t,
            "video_id": seq.get("id", seq_id + 1),
            "annotations": list(tracks.values()),
        })
    return records


def load_coco_records(info: DatasetInfo, root: str) -> List[Dict]:
    """Parse a COCO-format json into per-image records for pseudo-clips."""
    path = os.path.join(root, info.json_file)
    with open(path) as f:
        data = json.load(f)
    anns_by_img: Dict[int, List[dict]] = {}
    for ann in data.get("annotations", []) or []:
        if ann.get("iscrowd", 0):
            continue
        anns_by_img.setdefault(ann["image_id"], []).append(ann)
    records = []
    for img in data["images"]:
        records.append({
            "file_name": os.path.join(root, info.image_root, img["file_name"]),
            "height": img["height"],
            "width": img["width"],
            "image_id": img["id"],
            "annotations": anns_by_img.get(img["id"], []),
        })
    return records


def select_frames(
    rng: np.random.RandomState,
    video_length: int,
    num: int,
    frame_range: int,
    shuffle: bool = False,
    reverse: bool = False,
    ratio: float = 1.0,
) -> List[int]:
    """ytvis_dataset_mapper.py:210-261 — all three reference regimes:

      * ``ratio < 1``: single-frame subsampling (``:219-228``) — the video
        is viewed as ``round(len * ratio)`` evenly spaced frames and ONE of
        them is the sample (middle frame if only one survives);
      * ``frame_range * 2 + 1 == num``: a CONTIGUOUS window of ``num``
        frames at a random start (``:231-246``; short videos resample extra
        indices with replacement);
      * otherwise: a reference frame plus ``num - 1`` draws from its
        ``frame_range`` neighborhood (``:247-261``)."""
    if ratio < 1.0:
        assert num == 1, "only support subsampling for a single frame"
        sub = max(int(np.round(video_length * ratio)), 1)
        if sub > 1:
            spaced = np.linspace(
                0, video_length, num=sub, endpoint=False
            ).astype(int)
            return [int(spaced[rng.randint(sub)])]
        return [video_length // 2]
    if frame_range * 2 + 1 == num:
        if num > video_length:
            extra = rng.choice(video_length, num - video_length)
            idxs = sorted(range(video_length)) + [int(i) for i in extra]
            idxs = sorted(idxs)
        else:
            start = 0 if video_length == num else rng.randint(
                video_length - num
            )
            idxs = list(range(start, start + num))
        if reverse and rng.rand() < 0.5:
            idxs = idxs[::-1]
        return idxs
    ref = rng.randint(video_length)
    start = max(0, ref - frame_range)
    end = min(video_length, ref + frame_range + 1)
    pool = [i for i in range(start, end) if i != ref]
    if len(pool) >= num - 1:
        picks = rng.choice(len(pool), num - 1, replace=False)
    else:
        picks = rng.choice(len(pool), num - 1, replace=True) if pool else np.array([], int)
    idxs = sorted([ref] + [pool[i] for i in picks]) if num > 1 else [ref]
    if shuffle:
        rng.shuffle(idxs)
    if reverse and rng.rand() < 0.5:
        idxs = idxs[::-1]
    return idxs


def _pad_sample(
    frames: List[np.ndarray],
    masks: np.ndarray,           # (N_real, T, h, w) uint8
    labels: np.ndarray,          # (N_real,)
    frame_valid: np.ndarray,     # (N_real, T)
    inp: InputConfig,
    pixel_mean, pixel_std,
    div: int = 0,
) -> Dict[str, np.ndarray]:
    t = len(frames)
    h, w = frames[0].shape[:2]
    ph, pw = inp.pad_size if h <= w else (inp.pad_size[1], inp.pad_size[0])
    ph, pw = max(ph, h), max(pw, w)
    # canvas rounding: train uses input.train_size_divisibility; eval mappers
    # pass model.size_divisibility (the reference's ImageList padding knob,
    # MODEL.MASK_FORMER.SIZE_DIVISIBILITY, video_maskformer.py:186-189)
    div = div or inp.train_size_divisibility
    ph, pw = -(-ph // div) * div, -(-pw // div) * div
    n = inp.max_instances

    pixels = np.zeros((t, ph, pw, 3), np.float32)
    mean = np.asarray(pixel_mean, np.float32)
    std = np.asarray(pixel_std, np.float32)
    for i, f in enumerate(frames):
        pixels[i, :h, :w] = (f.astype(np.float32) - mean) / std

    n_real = min(len(labels), n)
    out_masks = np.zeros((n, t, ph, pw), bool)
    out_labels = np.zeros((n,), np.int32)
    out_valid = np.zeros((n,), bool)
    out_fv = np.zeros((n, t), bool)
    if n_real:
        out_masks[:n_real, :, :h, :w] = masks[:n_real].astype(bool)
        out_labels[:n_real] = labels[:n_real]
        out_valid[:n_real] = True
        out_fv[:n_real] = frame_valid[:n_real]
    return {
        "pixels": pixels,
        "image_size": np.asarray([h, w], np.int32),
        "labels": out_labels,
        "masks": out_masks,
        "valid": out_valid,
        "frame_valid": out_fv,
    }


class YTVISClipMapper:
    def __init__(
        self,
        info: DatasetInfo,
        inp: InputConfig,
        pixel_mean,
        pixel_std,
        is_train: bool = True,
        size_divisibility: int = 0,
    ):
        self.info = info
        self.inp = inp
        self.is_train = is_train
        self.pixel_mean = pixel_mean
        self.pixel_std = pixel_std
        self.size_divisibility = size_divisibility
        sizes = inp.min_size_train if is_train else (inp.min_size_test,)
        self.aug = ClipAugmenter(
            sizes,
            inp.max_size_train if is_train else inp.max_size_test,
            flip=is_train and inp.random_flip != "none",
            augmentations=inp.augmentations,
            is_train=is_train,
            crop=is_train and inp.crop_enabled,
            crop_type=inp.crop_type,
            crop_size=inp.crop_size,
            sampling=inp.min_size_train_sampling if is_train else "choice_by_clip",
        )

    def __call__(self, rng: np.random.RandomState, record: Dict) -> Dict:
        from PIL import Image

        t_total = record["length"]
        if self.is_train:
            idxs = select_frames(
                rng, t_total, self.inp.sampling_frame_num,
                self.inp.sampling_frame_range,
                self.inp.sampling_frame_shuffle, self.inp.sampling_frame_reverse,
                ratio=self.inp.sampling_frame_ratio,
            )
        else:
            idxs = list(range(t_total))

        frames = [
            np.asarray(Image.open(record["file_names"][i]).convert("RGB"))
            for i in idxs
        ]
        h, w = record["height"], record["width"]

        annos = record["annotations"]
        # stable slot per annotation id, visible in >=1 selected frame
        slots: List[dict] = []
        for ann in annos:
            segs = ann.get("segmentations") or []
            if any(i < len(segs) and segs[i] for i in idxs):
                slots.append(ann)
        n_real = len(slots)
        masks = np.zeros((n_real, len(idxs), h, w), np.uint8)
        fv = np.zeros((n_real, len(idxs)), bool)
        labels = np.zeros((n_real,), np.int32)
        for si, ann in enumerate(slots):
            labels[si] = self.info.id_map[ann["category_id"]]
            segs = ann.get("segmentations") or []
            for fi, i in enumerate(idxs):
                seg = segs[i] if i < len(segs) else None
                if seg:
                    masks[si, fi] = segm_to_mask(seg, h, w)
                    fv[si, fi] = True

        masks_per_frame = [
            [masks[si, fi] for si in range(n_real)] for fi in range(len(idxs))
        ]
        frames, masks_pf, size = self.aug(rng, frames, masks_per_frame)
        if n_real:
            masks = np.stack(
                [np.stack(ms) for ms in masks_pf], axis=1
            )  # (N, T, h', w')
        else:
            masks = np.zeros((0, len(idxs), *size), np.uint8)

        sample = _pad_sample(
            frames, masks, labels, fv, self.inp, self.pixel_mean,
            self.pixel_std, div=self.size_divisibility,
        )
        sample["orig_size"] = np.asarray([record["height"], record["width"]], np.int32)
        sample["video_id"] = record["video_id"]
        sample["frame_idxs"] = np.asarray(idxs, np.int32)
        sample["num_frames_total"] = t_total
        return sample


class CocoClipMapper:
    """Still image -> pseudo-clip (CocoClipDatasetMapper, :472-541)."""

    def __init__(
        self,
        info: DatasetInfo,
        inp: InputConfig,
        pixel_mean,
        pixel_std,
    ):
        self.info = info
        self.inp = inp
        self.pixel_mean = pixel_mean
        self.pixel_std = pixel_std
        self.aug = ClipAugmenter(
            inp.pseudo_min_size_train,
            inp.pseudo_max_size_train,
            flip=inp.random_flip != "none",
            augmentations=inp.pseudo_augmentations,
            is_train=True,
            sampling=inp.min_size_train_sampling,
        )

    def __call__(self, rng: np.random.RandomState, record: Dict) -> Dict:
        from PIL import Image

        t = self.inp.sampling_frame_num
        img = np.asarray(Image.open(record["file_name"]).convert("RGB"))
        h, w = img.shape[:2]
        annos = [a for a in record["annotations"] if a.get("segmentation")]
        n_real = len(annos)
        base_masks = np.zeros((n_real, h, w), np.uint8)
        labels = np.zeros((n_real,), np.int32)
        for si, ann in enumerate(annos):
            labels[si] = self.info.id_map[ann["category_id"]]
            base_masks[si] = segm_to_mask(ann["segmentation"], h, w)

        frames = [img] * t
        masks_per_frame = [[base_masks[si] for si in range(n_real)]] * t
        frames, masks_pf, size = self.aug(
            rng, frames, masks_per_frame, per_frame_rotation=True
        )
        if n_real:
            masks = np.stack([np.stack(ms) for ms in masks_pf], axis=1)
        else:
            masks = np.zeros((0, t, *size), np.uint8)
        fv = np.ones((n_real, t), bool)
        sample = _pad_sample(
            frames, masks, labels, fv, self.inp, self.pixel_mean, self.pixel_std
        )
        sample["orig_size"] = np.asarray([h, w], np.int32)
        sample["video_id"] = -record["image_id"]
        sample["frame_idxs"] = np.arange(t, dtype=np.int32)
        sample["num_frames_total"] = t
        return sample
