"""Synthetic datasets in the YTVIS and COCO formats, made from a seed.

``write_ytvis_dataset`` writes JPEG frames and a YTVIS json (``videos``,
``annotations`` with per-frame compressed RLEs, ``categories``) in the layout
``data/mapper.load_ytvis_records`` reads; ``write_coco_dataset`` writes JPEG
images and a COCO json (``images``, ``annotations`` with one compressed RLE
each, ``categories``) in the layout ``data/mapper.load_coco_records`` reads,
for the COCO pseudo-clips the recipes mix into training; ``write_burst_dataset``
writes JPEG frames and a BURST (TAO-schema) json (``sequences`` with per-frame
``{track id: {rle}}`` maps and ``track_category_ids`` of LVIS ids) in the
layout ``data/mapper.load_burst_records`` reads.  Each instance is a
rectangle of its own colour (moving across the frames of a video) over a
smooth background, as in the JAX package's engine tests
(``tests/test_engine.py``).  No dataset is downloaded: the port's tests and
``chip_smoke.py`` use these.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from openvis_tpu_torch.data import catalog, rle
from openvis_tpu_torch.data.catalog import DatasetInfo, _id_map, _thing_classes


def _rectangles(rng: np.random.RandomState, h: int, w: int, t: int, n: int):
    """Per instance: box size and start/end corners; it moves linearly."""
    boxes = []
    for _ in range(n):
        bh, bw = int(h * rng.uniform(0.2, 0.4)), int(w * rng.uniform(0.15, 0.3))
        y0, y1 = rng.randint(0, h - bh, size=2)
        x0, x1 = rng.randint(0, w - bw, size=2)
        boxes.append((bh, bw, y0, x0, y1, x1))
    return boxes


def _box_at(box, f: int, t: int) -> Tuple[int, int, int, int]:
    bh, bw, y0, x0, y1, x1 = box
    a = f / max(t - 1, 1)
    y, x = int(round(y0 + a * (y1 - y0))), int(round(x0 + a * (x1 - x0)))
    return y, x, bh, bw


def _background(h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([xx / w * 200, yy / h * 200, (xx + yy) / (h + w) * 120 + 60], -1)


def write_ytvis_dataset(
    root: str,
    name: str,
    videos: Sequence[Tuple[int, int, int, int]],
    categories: List[Dict],
    seed: int = 0,
    layout: Optional[DatasetInfo] = None,
) -> DatasetInfo:
    """Write ``videos`` ((height, width, frames, instances) each) under
    ``root/name`` and return the dataset's ``DatasetInfo`` (not registered).
    Instances get categories drawn from ``categories`` (``id``, ``name``).
    With ``layout`` (a registered dataset's ``DatasetInfo``) the frames and
    the json go to its ``image_root`` and ``json_file`` under ``root``
    instead, so that a recipe's dataset name resolves unchanged."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    image_root = layout.image_root if layout else os.path.join(name, "JPEGImages")
    js = {"videos": [], "annotations": [], "categories": list(categories)}
    cat_ids = [c["id"] for c in categories]
    ann_id = 0
    for vi, (h, w, t, n) in enumerate(videos, start=1):
        vdir = os.path.join(root, image_root, f"v{vi}")
        os.makedirs(vdir, exist_ok=True)
        boxes = _rectangles(rng, h, w, t, n)
        colours = rng.randint(0, 256, size=(n, 3))
        base = _background(h, w)
        segs: List[List] = [[] for _ in range(n)]
        fns = []
        for f in range(t):
            img = base + rng.uniform(-8, 8, size=(1, 1, 3))
            for j, box in enumerate(boxes):
                y, x, bh, bw = _box_at(box, f, t)
                img[y:y + bh, x:x + bw] = colours[j]
                m = np.zeros((h, w), np.uint8)
                m[y:y + bh, x:x + bw] = 1
                segs[j].append(rle.encode(m))
            fn = f"v{vi}/{f:05d}.jpg"
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                os.path.join(root, image_root, fn), quality=90)
            fns.append(fn)
        js["videos"].append({"id": vi, "height": h, "width": w, "length": t, "file_names": fns})
        for j in range(n):
            ann_id += 1
            bbox = [[float(x), float(y), float(bw), float(bh)]
                    for y, x, bh, bw in (_box_at(boxes[j], f, t) for f in range(t))]
            js["annotations"].append({
                "id": ann_id, "video_id": vi, "category_id": int(rng.choice(cat_ids)),
                "segmentations": segs[j], "bboxes": bbox,
                "areas": [float(boxes[j][0] * boxes[j][1])] * t, "iscrowd": 0,
            })
    json_file = layout.json_file if layout else os.path.join(name, "annotations.json")
    with open(os.path.join(root, json_file), "w") as fh:
        json.dump(js, fh)
    return DatasetInfo(
        name=name, image_root=image_root, json_file=json_file,
        thing_classes=tuple(_thing_classes(categories)), id_map=_id_map(categories),
    )


def write_coco_dataset(
    root: str,
    name: str,
    images: Sequence[Tuple[int, int, int]],
    categories: List[Dict],
    seed: int = 0,
) -> DatasetInfo:
    """Write ``images`` ((height, width, instances) each) under ``root/name``
    in the COCO format and return the dataset's ``DatasetInfo`` (kind
    ``coco_clip``, not registered).  Instances get categories drawn from
    ``categories`` (``id``, ``name``)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    image_root = os.path.join(name, "images")
    os.makedirs(os.path.join(root, image_root), exist_ok=True)
    js = {"images": [], "annotations": [], "categories": list(categories)}
    cat_ids = [c["id"] for c in categories]
    ann_id = 0
    for ii, (h, w, n) in enumerate(images, start=1):
        img = _background(h, w) + rng.uniform(-8, 8, size=(1, 1, 3))
        colours = rng.randint(0, 256, size=(n, 3))
        for j, box in enumerate(_rectangles(rng, h, w, 1, n)):
            y, x, bh, bw = _box_at(box, 0, 1)
            img[y:y + bh, x:x + bw] = colours[j]
            m = np.zeros((h, w), np.uint8)
            m[y:y + bh, x:x + bw] = 1
            ann_id += 1
            js["annotations"].append({
                "id": ann_id, "image_id": ii, "category_id": int(rng.choice(cat_ids)),
                "segmentation": rle.encode(m), "bbox": [float(x), float(y), float(bw), float(bh)],
                "area": float(bh * bw), "iscrowd": 0,
            })
        fn = f"{ii:012d}.jpg"
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            os.path.join(root, image_root, fn), quality=90)
        js["images"].append({"id": ii, "file_name": fn, "height": h, "width": w})
    json_file = os.path.join(name, "annotations.json")
    with open(os.path.join(root, json_file), "w") as fh:
        json.dump(js, fh)
    return DatasetInfo(
        name=name, image_root=image_root, json_file=json_file,
        thing_classes=tuple(_thing_classes(categories)), id_map=_id_map(categories),
        kind="coco_clip", eval_type="none",
    )


def write_burst_dataset(
    root: str,
    name: str,
    sequences: Sequence[Tuple[int, int, int, int]],
    seed: int = 0,
) -> DatasetInfo:
    """Write ``sequences`` ((height, width, frames, tracks) each) under
    ``root/name`` in the BURST format and return the dataset's
    ``DatasetInfo`` (``burst_val``'s 482 LVIS categories, kind and eval type
    ``burst``; not registered).  Each track is present over a span of frames
    drawn from the seed (BURST tracks enter and leave) and takes an LVIS
    category drawn from the whole table."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    table = catalog.get("burst_val")
    lvis_ids = sorted(table.id_map)
    image_root = os.path.join(name, "frames")
    js = {"sequences": []}
    for si, (h, w, t, n) in enumerate(sequences, start=1):
        seq, source = f"seq{si}", "YFCC100M"
        os.makedirs(os.path.join(root, image_root, source, seq), exist_ok=True)
        boxes = _rectangles(rng, h, w, t, n)
        colours = rng.randint(0, 256, size=(n, 3))
        spans = [sorted(rng.randint(0, t, size=2)) for _ in range(n)]
        base = _background(h, w)
        paths, segmentations = [], []
        for f in range(t):
            img = base + rng.uniform(-8, 8, size=(1, 1, 3))
            frame = {}
            for j, box in enumerate(boxes):
                if not spans[j][0] <= f <= spans[j][1]:
                    continue
                y, x, bh, bw = _box_at(box, f, t)
                img[y:y + bh, x:x + bw] = colours[j]
                m = np.zeros((h, w), np.uint8)
                m[y:y + bh, x:x + bw] = 1
                frame[str(j + 1)] = {"rle": rle.encode(m)["counts"]}
            fn = f"frame{f:04d}.jpg"
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                os.path.join(root, image_root, source, seq, fn), quality=90)
            paths.append(fn)
            segmentations.append(frame)
        js["sequences"].append({
            "id": si, "width": w, "height": h, "seq_name": seq, "dataset": source,
            "annotated_image_paths": paths, "segmentations": segmentations,
            "track_category_ids": {str(j + 1): int(rng.choice(lvis_ids)) for j in range(n)},
        })
    json_file = os.path.join(name, "all_classes.json")
    with open(os.path.join(root, json_file), "w") as fh:
        json.dump(js, fh)
    return DatasetInfo(name=name, image_root=image_root, json_file=json_file,
                       thing_classes=table.thing_classes, id_map=dict(table.id_map),
                       kind="burst", eval_type="burst")
