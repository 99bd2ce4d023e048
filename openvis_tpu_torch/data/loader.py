"""Train and test loaders: ratio-mixed sampling and same-shape batching.

Port of ``openvis_tpu/data/loader.py``: ``bucket_batches`` (``:33``),
``collate`` (``:47``), ``TrainLoader`` (``:64-183``) and ``test_videos``
(``:186-201``).  The combined loader samples the source datasets with the
configured ratios (``datasets.dataset_ratio``, e.g. YTVIS:COCO = 1.0:0.75) by
one categorical draw per sample; a batch groups samples of one padded shape.

Differences from the original:

* ``collate`` builds CPU torch tensors and the port's ``ClipTargets`` (the
  original builds ``jnp`` arrays);
* a ``TrainLoader`` built for a CUDA device pins each batch in its assembler
  thread, and ``__next__`` copies it to the card without blocking: the copy is
  queued behind the step the host has already enqueued, so the host does not
  wait for the card to drain before it enqueues the next step.

The random streams are the original's (``np.random.RandomState(seed * 1000 +
i)`` per worker, one ``rng.choice`` per sample): with one worker the port and
the JAX package yield the same batches.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from openvis_tpu_torch.config import Config
from openvis_tpu_torch.data import catalog
from openvis_tpu_torch.data.mapper import (
    CocoClipMapper,
    YTVISClipMapper,
    load_burst_records,
    load_coco_records,
    load_ytvis_records,
)
from openvis_tpu_torch.structures import ClipTargets


def bucket_batches(samples, batch_size: int):
    """Group a sample stream into same-shape batches without discarding:
    each sample joins the bucket of its padded-canvas shape and a batch is
    emitted the moment any bucket holds ``batch_size`` samples."""
    buckets: Dict[tuple, List[Dict]] = {}
    for s in samples:
        key = tuple(s["pixels"].shape)
        bucket = buckets.setdefault(key, [])
        bucket.append(s)
        if len(bucket) == batch_size:
            yield collate(bucket)
            buckets[key] = []


def collate(samples: List[Dict]) -> Dict:
    """Stack same-shape samples into CPU tensors: ``pixels`` (B, T, H, W, 3),
    ``image_sizes``, ``orig_sizes`` and ``targets`` (``ClipTargets``, int64
    labels: the criterion gathers with them)."""

    def stack(key):
        return torch.from_numpy(np.stack([s[key] for s in samples]))

    return {
        "pixels": stack("pixels"),
        "image_sizes": stack("image_size"),
        "orig_sizes": stack("orig_size"),
        "targets": ClipTargets(labels=stack("labels").long(), masks=stack("masks"),
                               valid=stack("valid"), frame_valid=stack("frame_valid")),
    }


def _map_batch(batch: Dict, fn) -> Dict:
    out = {k: fn(v) for k, v in batch.items() if k != "targets"}
    t = batch["targets"]
    out["targets"] = ClipTargets(fn(t.labels), fn(t.masks), fn(t.valid), fn(t.frame_valid))
    return out


class TrainLoader:
    """Infinite iterator of fixed-shape batches.

    Host pipeline (the reference's per-rank DataLoader workers): ``num_workers``
    threads decode JPEGs and augment into a shared, bounded sample queue; an
    assembler thread groups samples into per-shape buckets and emits a batch
    whenever a bucket fills.  No decoded sample is discarded.  ``device``: where
    ``__next__`` puts the batch (a CUDA device: pinned host memory, copied
    without blocking; the CPU: as collated).  ``close()`` stops the threads.
    """

    def __init__(
        self,
        cfg: Config,
        seed: int = 0,
        prefetch: Optional[int] = None,
        num_workers: Optional[int] = None,
        device="cpu",
    ):
        self.cfg = cfg
        self.device = torch.device(device)
        root = cfg.datasets.root
        inp = cfg.input
        mean, std = cfg.model.pixel_mean, cfg.model.pixel_std

        self.sources: List[Tuple[List[Dict], object]] = []
        for name in cfg.datasets.train:
            info = catalog.get(name)
            if info.kind == "coco_clip":
                records = load_coco_records(info, root)
                mapper = CocoClipMapper(info, inp, mean, std)
            elif info.kind == "burst":
                records = load_burst_records(info, root)
                mapper = YTVISClipMapper(info, inp, mean, std, is_train=True)
            else:
                records = load_ytvis_records(info, root, is_train=True)
                mapper = YTVISClipMapper(info, inp, mean, std, is_train=True)
            records = [r for r in records if r.get("annotations")]
            self.sources.append((records, mapper))

        ratios = np.asarray(cfg.datasets.dataset_ratio, np.float64)
        if len(ratios) != len(self.sources):
            # fail here: a mismatch inside a worker thread would only
            # surface at the first batch
            raise ValueError(
                f"datasets.dataset_ratio has {len(ratios)} entries for "
                f"{len(self.sources)} train datasets {cfg.datasets.train}"
            )
        self.probs = ratios / ratios.sum()
        self.batch_size = cfg.solver.ims_per_batch
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        if num_workers is None:
            num_workers = cfg.dataloader.num_workers
        if prefetch is None:
            prefetch = cfg.dataloader.prefetch
        self.num_workers = max(1, num_workers)
        # a bounded sample queue gives back-pressure to the decode threads
        self._samples: "queue.Queue" = queue.Queue(maxsize=max(2 * self.batch_size, 8))
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._threads = []
        for i in range(self.num_workers):
            th = threading.Thread(target=self._produce,
                                  args=(np.random.RandomState(seed * 1000 + i),), daemon=True)
            th.start()
            self._threads.append(th)
        asm = threading.Thread(target=self._assemble, daemon=True)
        asm.start()
        self._threads.append(asm)

    def _sample(self, rng: np.random.RandomState) -> Dict:
        while True:
            si = rng.choice(len(self.sources), p=self.probs)
            records, mapper = self.sources[si]
            rec = records[rng.randint(len(records))]
            try:
                s = mapper(rng, rec)
            except FileNotFoundError:
                continue
            if s["valid"].any():
                return s

    def _put(self, q: "queue.Queue", item) -> bool:
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _produce(self, rng: np.random.RandomState):
        try:
            while self._put(self._samples, self._sample(rng)):
                pass
        except BaseException as e:  # noqa: BLE001 -- raised again by __next__
            self._error = e

    def _assemble(self):
        def stream():
            while not self._stop.is_set():
                try:
                    yield self._samples.get(timeout=0.1)
                except queue.Empty:
                    pass

        pin = self.device.type == "cuda"
        try:
            for batch in bucket_batches(stream(), self.batch_size):
                if pin:
                    batch = _map_batch(batch, torch.Tensor.pin_memory)
                if not self._put(self._queue, batch):
                    return
        except BaseException as e:  # noqa: BLE001 -- raised again by __next__
            self._error = e

    def close(self, timeout: float = 10.0) -> None:
        """Stop the threads and wait for them (each ends within one sample)."""
        self._stop.set()
        for th in self._threads:
            th.join(timeout)

    def __iter__(self) -> Iterator[Dict]:
        return self

    def __next__(self) -> Dict:
        # poll, so that a dead worker surfaces as an exception and not as a
        # hang; assembled batches drain first (the error is read only on an
        # empty poll), so a late failure does not discard good batches
        while True:
            try:
                batch = self._queue.get(timeout=1.0)
                break
            except queue.Empty:
                if self._error is not None:
                    raise RuntimeError("data loader worker failed") from self._error
        if self.device.type == "cpu":
            return batch
        return _map_batch(batch, lambda t: t.to(self.device, non_blocking=True))


def test_videos(cfg: Config, dataset_name: str, max_videos: Optional[int] = None,
                rank: int = 0, world: int = 1) -> Iterator[Tuple[Dict, Dict]]:
    """Yields (record, mapper-processed full-video sample) pairs for eval.
    Test batch size is 1 video (build.py:207-241).  Of the first
    ``max_videos`` videos, only videos ``rank``, ``rank + world``, ... are
    read (the JAX engine's ``_host_videos``, which maps every video on every
    process; the test mapper draws nothing random that changes a sample)."""
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
    for rec in records[:max_videos][rank::world]:
        yield rec, mapper(rng, rec)
