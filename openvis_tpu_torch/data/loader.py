"""Test-time video loader.

Port of ``openvis_tpu/data/loader.py::test_videos`` (``:186-201``): one
mapper-processed whole video at a time, as numpy samples (the original module
imports JAX for ``collate``; the train loader and ``collate`` are not ported
yet, ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

from openvis_tpu_torch.config import Config
from openvis_tpu_torch.data import catalog
from openvis_tpu_torch.data.mapper import (
    YTVISClipMapper,
    load_burst_records,
    load_ytvis_records,
)


def test_videos(cfg: Config, dataset_name: str) -> Iterator[Tuple[Dict, Dict]]:
    """Yields (record, mapper-processed full-video sample) pairs for eval.
    Test batch size is 1 video (build.py:207-241)."""
    info = catalog.get(dataset_name)
    root = cfg.datasets.root
    if info.kind == "burst":
        records = load_burst_records(info, root)
    else:
        records = load_ytvis_records(info, root, is_train=False)
    mapper = YTVISClipMapper(
        info, cfg.input, cfg.model.pixel_mean, cfg.model.pixel_std,
        is_train=False, size_divisibility=cfg.model.size_divisibility,
    )
    rng = np.random.RandomState(0)
    for rec in records:
        yield rec, mapper(rng, rec)
