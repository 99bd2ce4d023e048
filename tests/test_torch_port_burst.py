"""PyTorch port, the BURST evaluator against the JAX package's on the CPU:
``hota_for_class`` and ``BURSTEvaluator.evaluate`` (HOTA, DetA, AssA and the
TrackMAP of each class split) on seeded tracks; ``process_video`` (the
``min_area`` rule, dropped tracks, the LVIS ids) from logits at the canvas
and at 1/4 resolution; and ``engine.evaluate_dataset`` with SimpleBaseline
(the tiny shapes of ``tests/test_torch_port_engine.py``, f32, windows of 4)
over the JAX tests' synthetic BURST sequence (``synth_burst_root``) against
the JAX engine."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openvis_tpu.config as jax_config
import openvis_tpu.engine as jax_engine
from openvis_tpu.data import catalog as jax_catalog
from openvis_tpu.data import rle as jax_rle
from openvis_tpu.evals import burst_eval as jax_burst
from openvis_tpu.train import build_model as jax_build_model
from openvis_tpu.utils.image import resize_bilinear_torch_hw as jax_resize_hw
from openvis_tpu_torch import config as port_config
from openvis_tpu_torch import engine, train
from openvis_tpu_torch.convert import flax_from_state_dict, init_params
from openvis_tpu_torch.data import catalog, rle
from openvis_tpu_torch.evals import burst_eval
from test_engine import synth_burst_root  # noqa: F401  (the JAX tests' BURST sequence)
from test_torch_port_engine import _cfg

# the same float64 sums in the same order on both sides
METRIC_EXACT = 1e-12
# tests/test_torch_port_engine.py's f32 bounds for the engine
SCORE_ATOL = 2e-3
MASK_AGREE = 0.999
METRIC_ATOL = 1e-6
# tests/test_torch_port_evaluator.py's bound: f32 against f64 at the > 0 threshold
MAX_PIXEL_SHARE_DIFFERING = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tracks(rng, n_videos, cats, h=24, w=32):
    """GT tracks and predictions of moving boxes, with absent frames, ragged
    lengths, missed and spurious tracks, and some predictions of the wrong
    category."""
    def track(t, y, x, bh, bw, jitter):
        segs = []
        for f in range(t):
            if rng.rand() < 0.2:
                segs.append(None)
                continue
            m = np.zeros((h, w), np.uint8)
            yy, xx = y + f + rng.randint(-jitter, jitter + 1), x + rng.randint(-jitter,
                                                                              jitter + 1)
            m[max(yy, 0):max(yy + bh, 0), max(xx, 0):max(xx + bw, 0)] = 1
            segs.append(rle.encode(m))
        return segs

    gts, dts = [], []
    for vid in range(1, n_videos + 1):
        t = rng.randint(3, 8)
        for _ in range(rng.randint(1, 4)):
            cat = int(rng.choice(cats))
            box = rng.randint(0, h // 2), rng.randint(0, w // 2), rng.randint(4, 9), \
                rng.randint(4, 11)
            gts.append({"video_id": vid, "category_id": cat,
                        "segmentations": track(t, *box, jitter=0)})
            for _ in range(rng.randint(0, 3)):
                pcat = cat if rng.rand() < 0.8 else int(rng.choice(cats))
                dts.append({"video_id": vid, "category_id": pcat, "score": float(rng.rand()),
                            "segmentations": track(t, *box, jitter=2)})
        dts.append({"video_id": vid, "category_id": int(rng.choice(cats)),
                    "score": float(rng.rand()),
                    "segmentations": track(t, 0, 0, 5, 5, jitter=3)})
    return gts, dts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hota_for_class_matches_jax(seed):
    gts, dts = _tracks(np.random.RandomState(seed), 5, [1])
    gt, dt = {}, {}
    for g in gts:
        gt.setdefault(g["video_id"], []).append(g)
    for d in dts:
        dt.setdefault(d["video_id"], []).append(d)
    ours = burst_eval.hota_for_class(gt, dt)
    theirs = jax_burst.hota_for_class(gt, dt)
    assert set(ours) == {"HOTA", "DetA", "AssA"} and 0.0 < ours["HOTA"] < 1.0
    for k in theirs:
        assert abs(ours[k] - theirs[k]) <= METRIC_EXACT, k


def test_burst_evaluator_matches_jax():
    """Every metric of both evaluators on tracks over LVIS ids of both
    splits, with BURST's class splits."""
    splits = catalog.burst_class_splits()
    assert splits == jax_catalog.burst_class_splits()
    cats = splits["common"][:3] + splits["uncommon"][:3]
    gts, dts = _tracks(np.random.RandomState(4), 6, cats)
    ours = burst_eval.BURSTEvaluator(class_splits=splits)
    theirs = jax_burst.BURSTEvaluator(class_splits=splits)
    for d in dts:
        ours.process(d)
        theirs.process(d)
    got = ours.evaluate(gts, sorted(cats))
    ref = theirs.evaluate(gts, sorted(cats))
    assert set(got) == set(ref) == {"HOTA", "DetA", "AssA", "mAP", "mAP_common",
                                    "mAP_uncommon"}
    assert 0.0 < got["HOTA"] < 1.0 and 0.0 < got["mAP"] < 1.0
    for k in ref:
        assert abs(got[k] - ref[k]) <= METRIC_EXACT, k


def _info(mod):
    return mod.get("burst_val")


def _boxes(areas, t, h, w):
    """(len(areas), t, h, w) logits: +4 inside a box of the given area
    (1 x area, at the top left) on each frame, -4 outside; area 0 is no box."""
    out = np.full((len(areas), t, h, w), -4.0, np.float32)
    for i, per_frame in enumerate(areas):
        for f, a in enumerate(per_frame):
            out[i, f, 2, 3:3 + a] = 4.0
    return out


def test_process_video_min_area_and_lvis_ids_match_jax():
    """Logits at the original size: a frame of at most ``min_area`` (20)
    pixels is None, 21 is kept; a track with no frame left is dropped; the
    contiguous labels come back as LVIS ids."""
    h, w, t = 24, 40, 3
    areas = [(21, 20, 30), (20, 5, 0), (0, 21, 25)]
    logits = _boxes(areas, t, h, w)
    scores = np.asarray([0.9, 0.8, 0.3], np.float32)
    labels = np.asarray([0, 5, 481], np.int64)
    ours = burst_eval.BURSTEvaluator(dataset_info=_info(catalog))
    ours.process_video(3, {"scores": torch.from_numpy(scores), "labels": torch.from_numpy(labels),
                           "mask_logits": torch.from_numpy(logits)}, (h, w), (h, w), (h, w))
    theirs = jax_burst.BURSTEvaluator(dataset_info=_info(jax_catalog))
    theirs.process_video(3, {"scores": scores, "labels": labels, "mask_logits": logits},
                         (h, w), (h, w))
    inverse = {v: k for k, v in _info(catalog).id_map.items()}
    assert ours.predictions == theirs.predictions
    assert [p["category_id"] for p in ours.predictions] == [inverse[0], inverse[481]]
    kept = [[s is not None for s in p["segmentations"]] for p in ours.predictions]
    assert kept == [[True, False, True], [False, True, True]]
    assert rle.area(ours.predictions[0]["segmentations"][0]) == 21


def test_process_video_from_quarter_resolution_matches_jax():
    """The engine's path: 1/4-resolution logits resized on the device to the
    padded canvas, cropped and resized to the original size; the JAX engine
    hands its evaluator canvas logits (resized on the host)."""
    rng = np.random.RandomState(5)
    topk, t, canvas, image_size, orig_size = 4, 5, (64, 96), (48, 64), (72, 96)
    quarter = (rng.randn(topk, t, 16, 24) * 2 - 1).astype(np.float32)
    quarter[2:] = -20.0
    quarter[2, :3, 5, 7] = 1.0               # a few pixels: under min_area
    quarter[2, 3:, 4:7, 6:9] = 20.0
    quarter[3, :, 5, 7] = 1.0                # under min_area in every frame: dropped
    scores = rng.rand(topk).astype(np.float32)
    labels = rng.randint(0, 482, topk)
    ours = burst_eval.BURSTEvaluator(dataset_info=_info(catalog))
    ours.process_video(9, {"scores": torch.from_numpy(scores), "labels": torch.from_numpy(labels),
                           "mask_logits": torch.from_numpy(quarter)}, image_size, orig_size,
                       canvas)
    up = np.asarray(jax_resize_hw(jnp.asarray(quarter), canvas))
    theirs = jax_burst.BURSTEvaluator(dataset_info=_info(jax_catalog))
    theirs.process_video(9, {"scores": scores, "labels": labels, "mask_logits": up},
                         image_size, orig_size)
    assert [(p["category_id"], p["score"]) for p in ours.predictions] == \
        [(p["category_id"], p["score"]) for p in theirs.predictions]
    assert len(ours.predictions) == topk - 1
    assert [s is None for s in ours.predictions[-1]["segmentations"]] == [True] * 3 + [False] * 2
    for a, b in zip(ours.predictions, theirs.predictions):
        assert [s is None for s in a["segmentations"]] == [s is None for s in b["segmentations"]]
        for x, y in zip(a["segmentations"], b["segmentations"]):
            if x is not None:
                differ = (jax_rle.decode(x) != jax_rle.decode(y)).mean()
                assert differ <= MAX_PIXEL_SHARE_DIFFERING


def _predictions(cfg):
    with open(os.path.join(cfg.output_dir, "results_synth_burst.json")) as f:
        return json.load(f)


def test_evaluate_dataset_on_burst_matches_jax(synth_burst_root):  # noqa: F811
    root = synth_burst_root
    info = jax_catalog.get("synth_burst")
    catalog.register(catalog.DatasetInfo(**dataclasses.asdict(info)))
    cfgs = []
    for mod, out in ((jax_config, "jax"), (port_config, "port")):
        cfg = _cfg(mod, root, True, False, out)
        cfgs.append(dataclasses.replace(cfg, datasets=dataclasses.replace(
            cfg.datasets, test=("synth_burst",))))
    jcfg, pcfg = cfgs
    assert isinstance(engine.make_evaluator(catalog.get("synth_burst")),
                      burst_eval.BURSTEvaluator)
    rng = np.random.RandomState(0)
    text = rng.randn(2, 32).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    model = init_params(train.build_model(pcfg, device="cpu"), seed=2)
    params = jax.tree.map(jnp.asarray, flax_from_state_dict(model.state_dict()))
    jmet = jax_engine.evaluate_dataset(jcfg, jax_build_model(jcfg), params, "synth_burst", text)
    pmet = engine.evaluate_dataset(pcfg, model, "synth_burst", text, device="cpu")
    jpred, ppred = _predictions(jcfg), _predictions(pcfg)
    assert ppred and [(p["video_id"], p["category_id"]) for p in ppred] == \
        [(p["video_id"], p["category_id"]) for p in jpred]
    assert {p["category_id"] for p in ppred} <= {5, 7}
    for p, j in zip(ppred, jpred):
        assert abs(p["score"] - j["score"]) <= SCORE_ATOL
        assert [s is None for s in p["segmentations"]] == [s is None for s in j["segmentations"]]
        for x, y in zip(p["segmentations"], j["segmentations"]):
            if x is not None:
                assert (jax_rle.decode(x) == jax_rle.decode(y)).mean() >= MASK_AGREE
    assert set(pmet) == set(jmet) >= {"HOTA", "DetA", "AssA", "mAP"}
    for k in jmet:
        assert abs(pmet[k] - jmet[k]) <= METRIC_ATOL, k
