"""PyTorch port, the YTVIS evaluator: ``YTVOSEval`` and ``YTVISEvaluator``
against the JAX package's on one fixed set of predictions (made from the GT
masks by shifting them, so that AP lies strictly between 0 and 1), and the
port's device-side conversion of mask logits to per-frame RLEs
(``F.interpolate`` in f32, ``> 0``, the native encoder) against the
original's host-side one (exact bilinear weight matrices in f64), with an
upscale, a downscale and the engine's first resize from 1/4 resolution."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from openvis_tpu.data import catalog as jax_catalog
from openvis_tpu.data import rle as jax_rle
from openvis_tpu.evals import ytvis_eval as jax_eval
from openvis_tpu.utils.image import resize_bilinear_torch_hw as jax_resize_hw
from openvis_tpu_torch.data import catalog, rle
from openvis_tpu_torch.evals import ytvis_eval
from torch_port_common import one_thread_fixture

one_thread = one_thread_fixture()

# f32 against f64 arithmetic at the > 0 threshold: only pixels whose logit
# lies within a few f32 ulps of 0 may differ (observed: none)
MAX_PIXEL_SHARE_DIFFERING = 1e-4
CATEGORIES = [{"id": 1, "name": "c1"}, {"id": 2, "name": "c2"}, {"id": 5, "name": "c5"}]
H, W, T = 40, 56, 5


def _box(t, y, x, bh, bw, dy, dx):
    m = np.zeros((H, W), np.uint8)
    y, x = y + dy * t, x + dx * t
    m[max(y, 0):max(y + bh, 0), max(x, 0):max(x + bw, 0)] = 1
    return m


def _gt_and_predictions():
    """Three videos of moving boxes; predictions are the GT boxes shifted by
    0-8 pixels (IoU from 1 down to ~0.3), some with the wrong category, plus
    false positives and frames a prediction or a GT leaves empty."""
    rng = np.random.RandomState(0)
    videos, anns, preds = [], [], []
    for vid in (1, 2, 3):
        videos.append({"id": vid, "height": H, "width": W, "length": T,
                       "file_names": [f"v{vid}/{t}.jpg" for t in range(T)]})
        for k in range(3):
            cat = CATEGORIES[(vid + k) % 3]["id"]
            y, x = rng.randint(0, H // 2), rng.randint(0, W // 2)
            bh, bw = rng.randint(6, 18), rng.randint(6, 24)
            dy, dx = rng.randint(-1, 2), rng.randint(-1, 2)
            segs = [rle.encode(_box(t, y, x, bh, bw, dy, dx)) for t in range(T)]
            if k == 2:
                segs[0] = None  # an instance absent from the first frame
            anns.append({"id": len(anns) + 1, "video_id": vid, "category_id": cat,
                         "segmentations": segs, "iscrowd": 0})
            for shift in rng.choice(9, size=2, replace=False):
                pcat = cat if rng.rand() < 0.8 else CATEGORIES[rng.randint(3)]["id"]
                psegs = [rle.encode(_box(t, y + shift, x - shift // 2, bh, bw, dy, dx))
                         for t in range(T)]
                preds.append({"video_id": vid, "category_id": pcat,
                              "score": float(rng.rand()), "segmentations": psegs})
        preds.append({"video_id": vid, "category_id": CATEGORIES[0]["id"],
                      "score": float(rng.rand()),
                      "segmentations": [rle.encode(_box(t, 0, W - 10, 8, 8, 0, 0))
                                        for t in range(T)]})
    gt = {"videos": videos, "annotations": anns, "categories": CATEGORIES}
    return gt, preds


def _info(mod):
    return mod.DatasetInfo(name="torch_port_eval_synth", image_root="", json_file="",
                           thing_classes=("c1", "c2", "c5"), id_map={1: 0, 2: 1, 5: 2})


def test_ytvoseval_matches_original():
    gt, preds = _gt_and_predictions()
    gts = [{k: a[k] for k in ("video_id", "category_id", "segmentations", "iscrowd")}
           for a in gt["annotations"]]
    cats = [c["id"] for c in CATEGORIES]
    ours, theirs = ytvis_eval.YTVOSEval(gts, preds, cats), jax_eval.YTVOSEval(gts, preds, cats)
    ours.accumulate()
    theirs.accumulate()
    np.testing.assert_array_equal(ours.precision, theirs.precision)
    np.testing.assert_array_equal(ours.recall, theirs.recall)
    got = ours.summarize()
    assert got == theirs.summarize()
    assert 0.0 < got["AP"] < 1.0 and 0.0 < got["AR10"] < 1.0
    assert ours.per_category_ap() == theirs.per_category_ap()
    for d in preds[:6]:
        for g in gts[:3]:
            assert ytvis_eval.video_iou(d["segmentations"], g["segmentations"]) == \
                jax_eval.video_iou(d["segmentations"], g["segmentations"])


def test_ytvis_evaluator_matches_original():
    gt, preds = _gt_and_predictions()
    ours = ytvis_eval.YTVISEvaluator(_info(catalog))
    theirs = jax_eval.YTVISEvaluator(_info(jax_catalog))
    ours.predictions, theirs.predictions = list(preds), list(preds)
    got = ours.evaluate(gt)
    assert got == theirs.evaluate(gt)
    assert 0.0 < got["AP"] < 1.0
    assert ours.per_category == theirs.per_category


def _logits(rng, t, h, w):
    """Smooth logits with both signs (a blurred random field)."""
    x = torch.from_numpy(rng.randn(t, 1, max(h // 4, 2), max(w // 4, 2)).astype(np.float32))
    return torch.nn.functional.interpolate(x, size=(h, w), mode="bicubic",
                                           align_corners=False)[:, 0].numpy()


def _differing_share(ours, theirs):
    a = np.stack([rle.decode(s) for s in ours])
    b = np.stack([jax_rle.decode(s) for s in theirs])
    assert a.shape == b.shape
    return float((a != b).mean())


@pytest.mark.parametrize("image_size,orig_size", [
    ((48, 64), (72, 96)),    # upscale
    ((48, 64), (30, 41)),    # downscale
    ((48, 64), (48, 64)),    # crop only
])
def test_masks_to_video_rles_match_original(image_size, orig_size):
    rng = np.random.RandomState(sum(orig_size))
    canvas = _logits(rng, 6, 64, 96)
    ours = ytvis_eval.masks_to_video_rles(torch.from_numpy(canvas), image_size, orig_size,
                                          canvas.shape[1:])
    theirs = jax_eval.masks_to_video_rles(canvas, image_size, orig_size)
    assert [s["size"] for s in ours] == [list(orig_size)] * 6
    assert _differing_share(ours, theirs) <= MAX_PIXEL_SHARE_DIFFERING


def test_process_from_quarter_resolution_matches_original():
    """The engine's path: 1/4-res top-k logits (bf16 under AMP) resized to
    the padded canvas, cropped, resized to the original size; the JAX
    engine resizes to the canvas first (f32 weight matrices) and hands the
    evaluator canvas logits."""
    rng = np.random.RandomState(3)
    topk, canvas, image_size, orig_size = 4, (64, 96), (48, 64), (72, 96)
    quarter = _logits(rng, topk * 5, 16, 24).reshape(topk, 5, 16, 24)
    scores = np.asarray([0.9, 0.0, 0.5, 0.25], np.float32)  # one at the threshold
    labels = np.asarray([0, 2, 1, 2], np.int64)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.from_numpy(quarter).to(dtype)
        ours = ytvis_eval.YTVISEvaluator(_info(catalog))
        ours.process(7, {"scores": torch.from_numpy(scores), "labels": torch.from_numpy(labels),
                         "mask_logits": q}, image_size, orig_size, canvas)
        up = np.asarray(jax_resize_hw(jnp.asarray(q.float().numpy()), canvas))
        theirs = jax_eval.YTVISEvaluator(_info(jax_catalog))
        theirs.process(7, {"scores": scores, "labels": labels, "mask_logits": up},
                       image_size, orig_size)
        assert [(p["video_id"], p["category_id"]) for p in ours.predictions] == \
            [(p["video_id"], p["category_id"]) for p in theirs.predictions] == \
            [(7, 1), (7, 2), (7, 5)]
        for a, b in zip(ours.predictions, theirs.predictions):
            assert a["score"] == pytest.approx(b["score"], abs=1e-6)
            assert _differing_share(a["segmentations"], b["segmentations"]) <= \
                MAX_PIXEL_SHARE_DIFFERING
