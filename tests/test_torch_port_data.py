"""PyTorch port, the test data path: the port's copies of the catalog, the
RLE codec with its native library, the transforms, the YTVIS mapper and
``test_videos`` against the JAX package's originals on the same inputs, and
the native library's build (into ``_build/`` only; it raises when ``cc``
fails)."""

import dataclasses
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import openvis_tpu.config as jax_config
from openvis_tpu.data import catalog as jax_catalog
from openvis_tpu.data import loader as jax_loader
from openvis_tpu.data import mapper as jax_mapper
from openvis_tpu.data import rle as jax_rle
from openvis_tpu.data import transforms as jax_transforms
from openvis_tpu.native import native_iou_matrix as jax_native_iou_matrix
from openvis_tpu_torch import config as port_config
from openvis_tpu_torch import native
from openvis_tpu_torch.data import catalog, loader, mapper, rle, synthetic, transforms
from torch_port_common import one_thread_fixture

one_thread = one_thread_fixture()

REPO = Path(__file__).resolve().parent.parent
DATASET = "torch_port_data_synth"


def _fresh(path: Path):
    """A fresh import of a catalog module: only its built-in registrations."""
    name = f"fresh_catalog_of_{path.parent.parent.name}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses resolve their annotations there
    try:
        spec.loader.exec_module(mod)
    finally:
        del sys.modules[name]
    return mod


def test_catalog_copy_matches_original():
    ours = _fresh(REPO / "openvis_tpu_torch" / "data" / "catalog.py")
    theirs = _fresh(REPO / "openvis_tpu" / "data" / "catalog.py")
    assert ours.list_datasets() == theirs.list_datasets()
    for name in theirs.list_datasets():
        assert dataclasses.asdict(ours.get(name)) == dataclasses.asdict(theirs.get(name)), name
    assert ours.burst_class_splits() == theirs.burst_class_splits()
    src = REPO / "openvis_tpu" / "data" / "catalogs"
    dst = REPO / "openvis_tpu_torch" / "data" / "catalogs"
    assert sorted(p.name for p in dst.iterdir()) == sorted(p.name for p in src.iterdir())
    for p in src.iterdir():
        assert (dst / p.name).read_bytes() == p.read_bytes(), p.name


def _masks(rng):
    yield np.zeros((7, 9), np.uint8)
    yield np.ones((7, 9), np.uint8)
    m = np.zeros((1, 1), np.uint8)
    yield m
    for shape, p in [((37, 53), 0.6), ((40, 60), 0.5), ((16, 24), 0.05), ((5, 300), 0.95)]:
        yield (rng.rand(*shape) > p).astype(np.uint8)


def test_rle_encode_decode_area_match_original_and_plain():
    rng = np.random.RandomState(0)
    for m in _masks(rng):
        counts = rle.encode_counts(m)                   # the C library
        assert counts == rle.encode_counts_plain(m)     # its plain version
        assert counts == list(jax_rle.encode_counts(m))
        enc = rle.encode(m)
        assert enc == jax_rle.encode(m)
        assert rle.encode_transposed(np.ascontiguousarray(m.T)) == enc
        assert rle.string_to_counts(enc["counts"]) == jax_rle.string_to_counts(enc["counts"])
        np.testing.assert_array_equal(rle.decode(enc), m)
        np.testing.assert_array_equal(native.native_decode(np.asarray(counts), *m.shape), m)
        assert rle.area(enc) == jax_rle.area(enc) == int(m.sum())


def test_rle_intersection_union_matches_original():
    rng = np.random.RandomState(1)
    for _ in range(10):
        a = (rng.rand(40, 60) > rng.rand()).astype(np.uint8)
        b = (rng.rand(40, 60) > rng.rand()).astype(np.uint8)
        ea, eb = rle.encode(a), rle.encode(b)
        got = rle.rle_intersection_union(ea, eb)
        assert got == jax_rle.rle_intersection_union(ea, eb)
        assert got == (int((a & b).sum()), int((a | b).sum()))
    counts = [np.asarray(rle.encode_counts((rng.rand(30, 20) > p).astype(np.uint8)))
              for p in (0.0, 0.3, 0.6, 0.9, 1.0)]
    crowd = np.asarray([0, 1, 0, 0, 1], bool)
    np.testing.assert_array_equal(native.native_iou_matrix(counts, counts[::-1], crowd),
                                  jax_native_iou_matrix(counts, counts[::-1], crowd))


def test_native_library_builds_into_the_build_dir_only():
    lib = native.build()
    assert lib.parent == REPO / "openvis_tpu_torch" / "_build"
    assert lib == native.library_path() and lib.exists()
    assert sorted(p.name for p in (REPO / "openvis_tpu_torch" / "native").iterdir()
                  if p.name != "__pycache__") == ["__init__.py", "rle_ops.c"]


def test_native_build_raises_when_cc_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.subprocess, "run", lambda *a, **k: subprocess.CompletedProcess(
        a[0], 1, stdout="", stderr="cc: error: no input"))
    with pytest.raises(RuntimeError, match="cc failed"):
        native.build()

    def missing(*a, **k):
        raise FileNotFoundError("cc")

    monkeypatch.setattr(native.subprocess, "run", missing)
    with pytest.raises(RuntimeError, match="cannot run cc"):
        native.build()
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("hw", [(48, 64), (72, 96), (720, 1280), (480, 640), (360, 640),
                                (1080, 607)])
def test_transform_sizes_and_resizes_match_original(hw):
    for short, max_size in [(360, 1333), (48, 96), (480, 640)]:
        size = transforms.resize_shortest_edge_size(*hw, short, max_size)
        assert size == jax_transforms.resize_shortest_edge_size(*hw, short, max_size)
    rng = np.random.RandomState(0)
    frame = rng.randint(0, 256, (*hw, 3), np.uint8)
    mask = (rng.rand(*hw) > 0.5).astype(np.uint8)
    size = transforms.resize_shortest_edge_size(*hw, 48, 96)
    np.testing.assert_array_equal(transforms.resize_frame(frame, size),
                                  jax_transforms.resize_frame(frame, size))
    np.testing.assert_array_equal(transforms.resize_mask(mask, size),
                                  jax_transforms.resize_mask(mask, size))


def _cfg(mod, root):
    cfg = mod.Config()
    inp = dataclasses.replace(cfg.input, min_size_test=48, max_size_test=96,
                              pad_size=(64, 96), max_instances=6)
    return dataclasses.replace(cfg, input=inp,
                               datasets=dataclasses.replace(cfg.datasets, root=root))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    info = synthetic.write_ytvis_dataset(
        root, DATASET, [(48, 64, 3, 2), (72, 96, 4, 1), (96, 72, 2, 3)],
        [{"id": 1, "name": "c1"}, {"id": 3, "name": "c3"}], seed=1)
    catalog.register(info)
    jax_catalog.register(jax_catalog.DatasetInfo(**dataclasses.asdict(info)))
    return root, info


def test_test_mapper_matches_original(synth):
    root, info = synth
    pcfg, jcfg = _cfg(port_config, root), _cfg(jax_config, root)
    records = mapper.load_ytvis_records(info, root, is_train=False)
    assert records == jax_mapper.load_ytvis_records(jax_catalog.get(DATASET), root, False)
    ours = mapper.YTVISClipMapper(info, pcfg.input, pcfg.model.pixel_mean, pcfg.model.pixel_std,
                                  is_train=False, size_divisibility=32)
    theirs = jax_mapper.YTVISClipMapper(jax_catalog.get(DATASET), jcfg.input,
                                        jcfg.model.pixel_mean, jcfg.model.pixel_std,
                                        is_train=False, size_divisibility=32)
    for rec in records:
        a, b = ours(np.random.RandomState(0), rec), theirs(np.random.RandomState(0), rec)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        # the 72x96 video is resized to 48x64 on a canvas padded to 64x96
        h, w = rec["height"], rec["width"]
        assert a["orig_size"].tolist() == [h, w]
        assert a["pixels"].shape[1] % 32 == 0 and a["pixels"].shape[2] % 32 == 0


def test_test_videos_match_original(synth):
    root, _ = synth
    ours = list(loader.test_videos(_cfg(port_config, root), DATASET))
    theirs = list(jax_loader.test_videos(_cfg(jax_config, root), DATASET))
    assert len(ours) == len(theirs) == 3
    for (ra, sa), (rb, sb) in zip(ours, theirs):
        assert ra == rb
        assert set(sa) == set(sb)
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
