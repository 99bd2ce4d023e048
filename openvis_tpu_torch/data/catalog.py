"""Dataset catalog: registry of video-instance datasets + metadata.

Replaces the reference's import-time Detectron2 ``DatasetCatalog`` /
``MetadataCatalog`` registrations (``openvis/data/datasets/*.py``) with a
plain dict.  Category tables are JSON assets under ``catalogs/`` (public
dataset metadata: YTVIS-2019/2021 40 classes, OVIS 25, LVVIS 1196, BURST 482
LVIS classes, merged YTVIS∪COCO 101-class taxonomy), matching
``ytvis.py:27-112``, ``ovis.py:19``, ``lvvis_cat.py``, ``burst.py:26``,
``ytvis_coco.py:29``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

_CATALOG_DIR = os.path.join(os.path.dirname(__file__), "catalogs")


def _load(name: str):
    with open(os.path.join(_CATALOG_DIR, name)) as f:
        return json.load(f)


def _thing_classes(categories: List[dict]) -> List[str]:
    cats = sorted(categories, key=lambda c: c["id"])
    return [c["name"] for c in cats]


def _id_map(categories: List[dict]) -> Dict[int, int]:
    """dataset category id -> contiguous [0, K) index."""
    cats = sorted(categories, key=lambda c: c["id"])
    return {c["id"]: i for i, c in enumerate(cats)}


@dataclass(frozen=True)
class DatasetInfo:
    name: str
    image_root: str              # relative to datasets root
    json_file: str               # relative to datasets root
    thing_classes: Tuple[str, ...]
    id_map: Dict[int, int]       # category id -> contiguous index
    kind: str = "ytvis"          # "ytvis" | "coco_clip" | "burst"
    eval_type: str = "ytvis"     # "ytvis" | "burst" | "none"


_REGISTRY: Dict[str, DatasetInfo] = {}


def register(info: DatasetInfo):
    _REGISTRY[info.name] = info


def get(name: str) -> DatasetInfo:
    if name not in _REGISTRY:
        raise KeyError(
            f"dataset {name!r} not registered; have {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def list_datasets() -> List[str]:
    return sorted(_REGISTRY)


def category_table(name: str) -> List[dict]:
    """The registered dataset ``name``'s categories as a json's
    ``categories`` (``id``, ``name``), in id order."""
    info = get(name)
    return [{"id": cid, "name": info.thing_classes[i]}
            for cid, i in sorted(info.id_map.items())]


def burst_class_splits() -> Dict[str, List[int]]:
    """LVIS-id class splits for BURST metric reporting: "common" = the
    COCO-overlapping known classes, "uncommon" = the rest (the reference's
    hardcoded ``known_list``, ``data/evals/bursteval.py:63-70``)."""
    return {
        "common": [c["lvis_id"] for c in _load("common_burst_categories.json")],
        "uncommon": [c["lvis_id"] for c in _load("uncommon_burst_categories.json")],
    }


def _register_all():
    ytvis19 = _load("ytvis_categories_2019.json")
    ytvis21 = _load("ytvis_categories_2021.json")
    ovis = _load("ovis_categories.json")
    lvvis = _load("lvvis_categories.json")
    ytvis_coco = _load("ytvis_coco_categories.json")
    burst = _load("all_burst_categories.json")

    # YTVIS 2019/2021 + OVIS splits (ytvis.py:302-327, ovis.py:88-99)
    splits = {
        "ytvis_2019_train": ("ytvis_2019/train/JPEGImages",
                             "ytvis_2019/train.json", ytvis19),
        "ytvis_2019_val": ("ytvis_2019/valid/JPEGImages",
                           "ytvis_2019/valid.json", ytvis19),
        "ytvis_2019_test": ("ytvis_2019/test/JPEGImages",
                            "ytvis_2019/test.json", ytvis19),
        "ytvis_2021_train": ("ytvis_2021/train/JPEGImages",
                             "ytvis_2021/train.json", ytvis21),
        "ytvis_2021_val": ("ytvis_2021/valid/JPEGImages",
                           "ytvis_2021/valid.json", ytvis21),
        "ovis_train": ("ovis/train", "ovis/annotations_train.json", ovis),
        "ovis_val": ("ovis/valid", "ovis/annotations_valid.json", ovis),
        # LVVIS (lvvis.py:57-66): 1196 open-vocab categories
        "lvvis_train": ("lvvis/train/JPEGImages", "lvvis/train_ytvis_style.json", lvvis),
        "lvvis_val": ("lvvis/val/JPEGImages", "lvvis/val_ytvis_style.json", lvvis),
        # merged YTVIS∪COCO taxonomy (ytvis_coco.py:20-26)
        "ytvis_2019_train2coco": ("ytvis_2019/train/JPEGImages",
                                  "ytvis_2019/ytvis_2019_train2coco.json", ytvis_coco),
        "ytvis_2021_train2coco": ("ytvis_2021/train/JPEGImages",
                                  "ytvis_2021/ytvis_2021_train2coco.json", ytvis_coco),
    }
    for name, (img, js, cats) in splits.items():
        register(DatasetInfo(
            name=name, image_root=img, json_file=js,
            thing_classes=tuple(_thing_classes(cats)), id_map=_id_map(cats),
            kind="ytvis", eval_type="none" if "train" in name else "ytvis",
        ))

    # COCO pseudo-video splits (coco_ytvis.py:18-31): COCO images re-labeled
    # into the target taxonomy by the prep scripts
    coco_splits = {
        "coco2ytvis2019_train": ("coco/train2017", "coco/coco2ytvis2019_train.json", ytvis19),
        "coco2ytvis2021_train": ("coco/train2017", "coco/coco2ytvis2021_train.json", ytvis21),
        "coco2ovis_train": ("coco/train2017", "coco/coco2ovis_train.json", ovis),
        "coco_2017_train": ("coco/train2017", "coco/ytvis_coco_train.json", ytvis_coco),
    }
    for name, (img, js, cats) in coco_splits.items():
        register(DatasetInfo(
            name=name, image_root=img, json_file=js,
            thing_classes=tuple(_thing_classes(cats)), id_map=_id_map(cats),
            kind="coco_clip", eval_type="none",
        ))

    # BURST (burst.py:612+): TAO frames with 482 LVIS categories.  BURST
    # annotations carry **LVIS ids** (``track_category_ids``), mapped to
    # contiguous [0, 481] in table order (burst.py:523-531) — the id_map key
    # is ``lvis_id``, not the table's own contiguous ``id``.
    burst_sorted = sorted(burst, key=lambda c: c["id"])
    burst_id_map = {c["lvis_id"]: i for i, c in enumerate(burst_sorted)}
    register(DatasetInfo(
        name="burst_val", image_root="burst/frames/val",
        json_file="burst/val/all_classes.json",
        thing_classes=tuple(c["name"] for c in burst_sorted),
        id_map=burst_id_map, kind="burst", eval_type="burst",
    ))
    register(DatasetInfo(
        name="burst_train", image_root="burst/frames/train",
        json_file="burst/train/train.json",
        thing_classes=tuple(c["name"] for c in burst_sorted),
        id_map=burst_id_map, kind="burst", eval_type="none",
    ))


_register_all()
