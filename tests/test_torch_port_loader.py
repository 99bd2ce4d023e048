"""PyTorch port, the train loader: ``bucket_batches``, ``collate`` and
``TrainLoader`` against ``openvis_tpu/data/loader.py`` on the same synthetic
data (a YTVIS set and a COCO set mixed 1.0 : 0.75, as the recipes mix them,
landscape and portrait so that two buckets fill), and the loader's fail-fast
checks (``tests/test_loader.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

import openvis_tpu.config as jax_config
from openvis_tpu.data import catalog as jax_catalog
from openvis_tpu.data.loader import TrainLoader as JaxTrainLoader
from openvis_tpu_torch import config as port_config
from openvis_tpu_torch.data import catalog, synthetic
from openvis_tpu_torch.data.loader import TrainLoader, bucket_batches
from openvis_tpu_torch.structures import ClipTargets

YTVIS, COCO = "torch_port_loader_ytvis", "torch_port_loader_coco"
CATEGORIES = [{"id": 1, "name": "c1"}, {"id": 3, "name": "c3"}]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny model's many small operations run no
    faster on more, and the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fake_sample(shape, tag):
    t, h, w = shape
    return {
        "pixels": np.zeros((t, h, w, 3), np.float32) + tag,
        "image_size": np.asarray([h, w]),
        "orig_size": np.asarray([h, w]),
        "labels": np.zeros((2,), np.int32),
        "masks": np.zeros((2, t, h, w), bool),
        "valid": np.ones((2,), bool),
        "frame_valid": np.ones((2, t), bool),
    }


def test_bucket_batches_no_discard():
    """Every sample lands in exactly one emitted batch; batches are
    shape-homogeneous and ``collate`` makes CPU tensors and ClipTargets."""
    land, port = (2, 8, 12), (2, 12, 8)
    stream = [_fake_sample(land if i % 2 == 0 else port, i) for i in range(8)]
    batches = list(bucket_batches(iter(stream), batch_size=2))
    assert len(batches) == 4
    seen = []
    for b in batches:
        assert isinstance(b["pixels"], torch.Tensor) and b["pixels"].shape[0] == 2
        assert isinstance(b["targets"], ClipTargets)
        assert b["targets"].labels.dtype == torch.int64
        assert b["targets"].masks.dtype == torch.bool
        seen.extend(int(b["pixels"][i].flatten()[0]) for i in range(2))
    assert sorted(seen) == list(range(8))
    assert {tuple(b["pixels"].shape[2:4]) for b in batches[:2]} == {(8, 12), (12, 8)}


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("loader"))
    infos = [
        dataclasses.replace(synthetic.write_ytvis_dataset(
            root, YTVIS, [(48, 64, 5, 2), (64, 48, 4, 1), (48, 64, 3, 1)], CATEGORIES, seed=1),
            eval_type="none"),
        synthetic.write_coco_dataset(root, COCO, [(48, 64, 2), (64, 48, 1), (40, 64, 3)],
                                     CATEGORIES, seed=2),
    ]
    for info in infos:
        catalog.register(info)
        jax_catalog.register(jax_catalog.DatasetInfo(**dataclasses.asdict(info)))
    return root


def _cfg(mod, root, train=(YTVIS, COCO), ratio=(1.0, 0.75)):
    cfg = mod.Config()
    return dataclasses.replace(
        cfg,
        input=dataclasses.replace(
            cfg.input, min_size_train=(40, 48), max_size_train=96,
            pseudo_min_size_train=(40, 48), pseudo_max_size_train=96,
            pad_size=(64, 96), max_instances=4, sampling_frame_num=2),
        datasets=dataclasses.replace(cfg.datasets, root=root, train=train,
                                     dataset_ratio=ratio),
        solver=dataclasses.replace(cfg.solver, ims_per_batch=2))


def test_train_loader_equals_jax_bit_for_bit(data_root):
    """One worker: the same records, augmentations and buckets, so the same
    first three batches."""
    ours = TrainLoader(_cfg(port_config, data_root), seed=5, num_workers=1, prefetch=1)
    theirs = JaxTrainLoader(_cfg(jax_config, data_root), seed=5, num_workers=1, prefetch=1)
    try:
        shapes = set()
        for _ in range(3):
            a, b = next(ours), next(theirs)
            for key in ("pixels", "image_sizes", "orig_sizes"):
                np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]), err_msg=key)
            for key in ("labels", "masks", "valid", "frame_valid"):
                np.testing.assert_array_equal(getattr(a["targets"], key).numpy(),
                                              np.asarray(getattr(b["targets"], key)),
                                              err_msg=key)
            shapes.add(tuple(a["pixels"].shape))
        assert len(shapes) == 2, shapes  # landscape and portrait buckets
    finally:
        ours.close()


def test_loader_ratio_mismatch_fails_fast(data_root):
    with pytest.raises(ValueError, match="dataset_ratio"):
        TrainLoader(_cfg(port_config, data_root, train=(YTVIS,)), seed=0, num_workers=1,
                    prefetch=1)


def test_loader_worker_error_propagates(data_root, monkeypatch):
    def boom(self, rng):
        raise RuntimeError("decode exploded")

    monkeypatch.setattr(TrainLoader, "_sample", boom)
    loader = TrainLoader(_cfg(port_config, data_root), seed=0, num_workers=1, prefetch=1)
    with pytest.raises(RuntimeError, match="worker failed"):
        next(loader)
    loader.close()


def test_close_stops_the_threads(data_root):
    loader = TrainLoader(_cfg(port_config, data_root), seed=0, num_workers=2, prefetch=1)
    next(loader)
    loader.close()
    assert not any(th.is_alive() for th in loader._threads)
