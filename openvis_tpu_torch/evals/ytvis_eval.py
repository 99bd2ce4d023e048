"""YTVIS-style video instance segmentation evaluation.

Rebuild of the reference's evaluator chain
(``openvis/data/evals/ytvis_eval.py:29-335`` + vendored youtubevos
``ytvos.py`` / ``ytvoseval.py``): predictions are per-video (category,
score, per-frame RLE masks); matching uses the **spatio-temporal IoU**
``iou_seq = sum_t |d∩g| / sum_t |d∪g|`` (``ytvoseval.py:207-225``), and the
metric suite is COCO-protocol AP/AP50/AP75/APs/APm/APl/AR1/AR10
(``ytvis_eval.py:207``).

Port of ``openvis_tpu/evals/ytvis_eval.py``.  The metric code is a copy (host
side, numpy).  The conversion of a prediction's mask logits runs where the
logits lie (on the card in the engine): they go to f32, are resized to the
padded canvas, cropped to the valid image and resized to the original video
size, all with ``F.interpolate`` (bilinear, no antialias: the reference's
``F.interpolate`` before ``> 0``, ``video_maskformer.py:263-298``), then
thresholded at 0; only the uint8 masks reach the host, for the native RLE
encoder.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from openvis_tpu_torch.data import rle as rle_util
from openvis_tpu_torch.utils.image import resize_bilinear_torch_hw


def threshold_masks(
    mask_logits: torch.Tensor,                 # (T, h, w) one prediction, any float dtype
    image_size,                                # valid (h, w) on the padded canvas
    orig_size,                                 # original video (H, W)
    canvas_size,                               # the padded canvas (H, W)
) -> np.ndarray:
    """The prediction's foreground per frame at the original size, as a host
    (T, W, H) uint8 array: each frame transposed, so that its bytes are the
    (H, W) mask in the column-major order of the RLE.  The logits (the
    engine's are at 1/4 resolution) are resized to the padded canvas first;
    logits at the canvas already pass through that resize unchanged."""
    h, w = int(image_size[0]), int(image_size[1])
    oh, ow = int(orig_size[0]), int(orig_size[1])
    m = resize_bilinear_torch_hw(mask_logits.float(),
                                 (int(canvas_size[0]), int(canvas_size[1])))
    m = resize_bilinear_torch_hw(m[:, :h, :w], (oh, ow))
    return (m > 0).transpose(1, 2).contiguous().cpu().numpy().view(np.uint8)


def masks_to_video_rles(
    mask_logits: torch.Tensor,
    image_size,
    orig_size,
    canvas_size,
) -> List[Optional[Dict]]:
    """Per-frame COCO RLEs of one prediction (``threshold_masks``, then the
    native encoder)."""
    fg = threshold_masks(mask_logits, image_size, orig_size, canvas_size)
    return [rle_util.encode_transposed(f) for f in fg]


def video_iou(d_segs, g_segs, iscrowd: bool = False) -> float:
    """Spatio-temporal IoU over per-frame RLEs (ytvoseval.py:207-225);
    None/missing frames contribute nothing."""
    inter = 0
    union = 0
    d_area = 0
    for d, g in zip(d_segs, g_segs):
        if d is not None:
            d_area += rle_util.area(d)
        if d is None and g is None:
            continue
        if d is None:
            union += rle_util.area(g)
        elif g is None:
            union += rle_util.area(d)
        else:
            i, u = rle_util.rle_intersection_union(d, g)
            inter += i
            union += u
    if iscrowd:  # crowd GT: IoU = inter / det area
        union = d_area
    if union == 0:
        return 0.0
    return inter / union


class YTVOSEval:
    """COCO-protocol evaluation over whole-video predictions."""

    IOU_THRS = np.linspace(0.5, 0.95, 10)
    REC_THRS = np.linspace(0.0, 1.0, 101)
    AREA_RNG = {
        "all": (0.0, 1e10),
        "small": (0.0, 128 ** 2),
        "medium": (128 ** 2, 256 ** 2),
        "large": (256 ** 2, 1e10),
    }
    MAX_DETS = (1, 10, 100)

    def __init__(self, gts: List[Dict], dts: List[Dict], cat_ids: Sequence[int]):
        """gts/dts: lists of dicts with keys video_id, category_id,
        segmentations (list of per-frame RLE or None), score (dts only),
        plus optional iscrowd (gts).  Areas computed as mean per-frame area
        over present frames (ytvos.py annToRLE/area semantics)."""
        self.cat_ids = list(cat_ids)
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for g in gts:
            g = dict(g)
            areas = [rle_util.area(s) for s in g["segmentations"] if s]
            g["area"] = float(np.mean(areas)) if areas else 0.0
            g.setdefault("iscrowd", 0)
            g["ignore"] = g.get("ignore", 0) or g["iscrowd"]
            self._gts[(g["video_id"], g["category_id"])].append(g)
        for d in dts:
            d = dict(d)
            areas = [rle_util.area(s) for s in d["segmentations"] if s]
            d["area"] = float(np.mean(areas)) if areas else 0.0
            self._dts[(d["video_id"], d["category_id"])].append(d)
        self.video_ids = sorted(
            {k[0] for k in self._gts} | {k[0] for k in self._dts}
        )
        self._ious: Dict = {}

    def _sorted_dts_and_ious(self, vid, cat):
        """The (video, category)'s predictions by descending score and their
        IoUs with its GT (in GT order), computed once: every area range and
        detection cap reads them."""
        key = (vid, cat)
        if key not in self._ious:
            gts = self._gts[key]
            dts = sorted(self._dts[key], key=lambda d: -d["score"])
            ious = np.zeros((len(dts), len(gts)))
            for di, d in enumerate(dts):
                for gi, g in enumerate(gts):
                    ious[di, gi] = video_iou(
                        d["segmentations"], g["segmentations"], bool(g["iscrowd"])
                    )
            self._ious[key] = (dts, ious)
        return self._ious[key]

    def _evaluate_vid_cat(self, vid, cat, area_rng, max_det):
        gts = self._gts[(vid, cat)]
        dts, ious = self._sorted_dts_and_ious(vid, cat)
        dts = dts[:max_det]
        if not gts and not dts:
            return None
        g_ignore = [
            g["ignore"] or g["area"] < area_rng[0] or g["area"] > area_rng[1]
            for g in gts
        ]
        # sort gts: non-ignored first
        order = np.argsort([int(i) for i in g_ignore], kind="stable")
        gts = [gts[i] for i in order]
        g_ignore = [g_ignore[i] for i in order]
        ious = ious[:len(dts)][:, order]

        T = len(self.IOU_THRS)
        dt_m = np.zeros((T, len(dts)), dtype=np.int64) - 1
        gt_m = np.zeros((T, len(gts)), dtype=np.int64) - 1
        dt_ig = np.zeros((T, len(dts)), dtype=bool)
        for ti, thr in enumerate(self.IOU_THRS):
            for di, d in enumerate(dts):
                best = min(thr, 1 - 1e-10)
                match = -1
                for gi, g in enumerate(gts):
                    if gt_m[ti, gi] >= 0 and not g["iscrowd"]:
                        continue
                    if match >= 0 and not g_ignore[match] and g_ignore[gi]:
                        break  # can't beat a non-ignored match with ignored
                    if ious[di, gi] < best:
                        continue
                    best = ious[di, gi]
                    match = gi
                if match >= 0:
                    dt_m[ti, di] = match
                    gt_m[ti, match] = di
                    dt_ig[ti, di] = bool(g_ignore[match])
        # unmatched dts outside area range are ignored
        d_out = np.asarray(
            [d["area"] < area_rng[0] or d["area"] > area_rng[1] for d in dts]
        )
        if len(dts):
            dt_ig |= (dt_m == -1) & d_out[None, :]
        return {
            "scores": np.asarray([d["score"] for d in dts]),
            "dt_matched": dt_m,
            "dt_ignore": dt_ig,
            "num_gt": int(sum(1 for i in g_ignore if not i)),
        }

    def accumulate(self):
        T = len(self.IOU_THRS)
        R = len(self.REC_THRS)
        K = len(self.cat_ids)
        A = len(self.AREA_RNG)
        M = len(self.MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        for ki, cat in enumerate(self.cat_ids):
            for ai, (aname, arng) in enumerate(self.AREA_RNG.items()):
                for mi, max_det in enumerate(self.MAX_DETS):
                    evals = [
                        self._evaluate_vid_cat(v, cat, arng, max_det)
                        for v in self.video_ids
                    ]
                    evals = [e for e in evals if e is not None]
                    if not evals:
                        continue
                    scores = np.concatenate([e["scores"] for e in evals])
                    order = np.argsort(-scores, kind="mergesort")
                    dt_m = np.concatenate([e["dt_matched"] for e in evals], axis=1)[:, order]
                    dt_ig = np.concatenate([e["dt_ignore"] for e in evals], axis=1)[:, order]
                    npig = sum(e["num_gt"] for e in evals)
                    if npig == 0:
                        continue
                    tps = (dt_m >= 0) & ~dt_ig
                    fps = (dt_m == -1) & ~dt_ig
                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    for ti in range(T):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.finfo(float).eps)
                        recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0.0
                        # precision envelope
                        q = np.zeros(R)
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, self.REC_THRS, side="left")
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q
        self.precision = precision
        self.recall = recall

    def summarize(self) -> Dict[str, float]:
        def ap(iou_thr=None, area="all", max_det=100):
            ai = list(self.AREA_RNG).index(area)
            mi = self.MAX_DETS.index(max_det)
            p = self.precision[:, :, :, ai, mi]
            if iou_thr is not None:
                ti = int(np.argmin(np.abs(self.IOU_THRS - iou_thr)))
                p = p[ti : ti + 1]
            p = p[p > -1]
            return float(p.mean()) if p.size else -1.0

        def ar(area="all", max_det=100):
            ai = list(self.AREA_RNG).index(area)
            mi = self.MAX_DETS.index(max_det)
            r = self.recall[:, :, ai, mi]
            r = r[r > -1]
            return float(r.mean()) if r.size else -1.0

        return {
            "AP": ap(),
            "AP50": ap(iou_thr=0.5),
            "AP75": ap(iou_thr=0.75),
            "APs": ap(area="small"),
            "APm": ap(area="medium"),
            "APl": ap(area="large"),
            "AR1": ar(max_det=1),
            "AR10": ar(max_det=10),
        }

    def per_category_ap(self) -> Dict[int, float]:
        """AP per category id (all IoU thresholds, area=all, maxDets=100) —
        the reference's per-category table (ytvis_eval.py:241-252).
        Categories with no GT report nan."""
        ai = list(self.AREA_RNG).index("all")
        mi = self.MAX_DETS.index(100)
        out: Dict[int, float] = {}
        for ki, cat in enumerate(self.cat_ids):
            p = self.precision[:, :, ki, ai, mi]
            p = p[p > -1]
            out[int(cat)] = float(p.mean()) if p.size else float("nan")
        return out


class YTVISEvaluator:
    """Accumulates model top-k outputs and computes the metric suite.
    Mirrors ``YTVISEvaluator.process/evaluate`` (ytvis_eval.py:29-335)."""

    def __init__(self, dataset_info, score_threshold: float = 0.0):
        self.info = dataset_info
        self.score_threshold = score_threshold
        self.predictions: List[Dict] = []
        self._contig_to_dataset_id = {
            v: k for k, v in dataset_info.id_map.items()
        }

    def process(
        self,
        video_id: int,
        topk_out: Dict[str, torch.Tensor],  # scores/labels/mask_logits
        image_size,
        orig_size,
        canvas_size,
    ):
        """``topk_out["mask_logits"]`` (topk, T, h, w) stays where it lies
        and is resized to ``canvas_size`` first (``threshold_masks``); the
        scores and labels come to the host once."""
        scores = torch.as_tensor(topk_out["scores"]).float().tolist()
        labels = torch.as_tensor(topk_out["labels"]).tolist()
        masks = torch.as_tensor(topk_out["mask_logits"])
        for i in range(len(scores)):
            if scores[i] <= self.score_threshold:
                continue
            segs = masks_to_video_rles(masks[i], image_size, orig_size, canvas_size)
            self.predictions.append({
                "video_id": int(video_id),
                "category_id": self._contig_to_dataset_id[int(labels[i])],
                "score": float(scores[i]),
                "segmentations": segs,
            })

    def evaluate(self, gt_json: Dict) -> Dict[str, float]:
        gts = []
        for ann in gt_json.get("annotations", []) or []:
            h, w = None, None
            for v in gt_json["videos"]:
                if v["id"] == ann["video_id"]:
                    h, w = v["height"], v["width"]
                    break
            segs = []
            for s in ann["segmentations"]:
                if not s:
                    segs.append(None)
                elif isinstance(s, dict) and isinstance(s["counts"], list):
                    segs.append(rle_util.encode(
                        rle_util.decode_counts(s["counts"], *s["size"])
                    ))
                elif isinstance(s, dict):
                    segs.append(s)
                else:
                    segs.append(rle_util.encode(
                        rle_util.polygons_to_mask(s, h, w)
                    ))
            gts.append({
                "video_id": ann["video_id"],
                "category_id": ann["category_id"],
                "segmentations": segs,
                "iscrowd": ann.get("iscrowd", 0),
            })
        cat_ids = sorted({c["id"] for c in gt_json["categories"]})
        ev = YTVOSEval(gts, self.predictions, cat_ids)
        ev.accumulate()
        # per-category table kept for observability (ytvis_eval.py:241-252)
        names = {c["id"]: c.get("name", str(c["id"]))
                 for c in gt_json["categories"]}
        self.per_category = {
            names[cid]: ap_c for cid, ap_c in ev.per_category_ap().items()
        }
        return ev.summarize()
