"""BURST evaluation: HOTA and TrackMAP over class splits.

Port of ``openvis_tpu/evals/burst_eval.py`` (the reference's BURST chain,
``openvis/data/evals/burst_eval.py:24-177``, TrackEval's ``hota.py``
semantics): predictions are per-video tracks of per-frame masks.

* **HOTA**, per class, each video a sequence: per frame ONE Hungarian
  matching on ``global_alignment_score * similarity``, then per alpha in
  {0.05, ..., 0.95} the matches with ``similarity >= alpha - eps`` count.
  The global alignment score is the Jaccard of the per-frame
  Jaccard-normalised similarities.  DetA = TP / (TP + FN + FP), AssA = the
  sum over matched pairs of ``m * m / (gtc + dtc - m)`` over TP (sequences
  combine by summing the counters), HOTA = the mean over alphas of
  sqrt(DetA * AssA); the metrics are averaged over the classes with GT.
* **TrackMAP**: track-level AP with the spatio-temporal IoU, the YTVIS
  evaluator's ``YTVOSEval``, for the splits all / common / uncommon.

The per-frame mask IoU matrices run through the native C library
(``native.native_iou_matrix``), one ``linear_sum_assignment`` per (video,
frame).  ``BURSTEvaluator.process_video`` follows the YTVIS evaluator's
idiom: a prediction's mask logits are resized and thresholded where they lie
(on the card in the engine), and only the uint8 masks reach the host, where
a frame covering at most ``min_area`` pixels is dropped and the rest are
RLE-encoded.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from openvis_tpu_torch.data import rle as rle_util
from openvis_tpu_torch.evals.ytvis_eval import YTVOSEval, threshold_masks
from openvis_tpu_torch.native import native_iou_matrix

ALPHAS = np.arange(0.05, 0.99, 0.05)
_EPS = float(np.finfo("float").eps)


def _iou_matrix(counts_a: List[np.ndarray], counts_b: List[np.ndarray]) -> np.ndarray:
    """(na, nb) pairwise RLE IoU through the native library (it is built at
    first use or raises, so the JAX package's numpy fallback has no place)."""
    return native_iou_matrix(counts_a, counts_b)


def _track_counts(tracks: List[Dict], t: int):
    """-> (present (N, T) bool, counts[n][f] int64 RLE-count arrays)."""
    n = len(tracks)
    present = np.zeros((n, t), bool)
    counts = [[None] * t for _ in range(n)]
    for i, tr in enumerate(tracks):
        segs = tr["segmentations"]
        for f in range(min(t, len(segs))):
            if segs[f] is not None:
                present[i, f] = True
                counts[i][f] = np.asarray(rle_util._counts_list(segs[f]), np.int64)
    return present, counts


def hota_for_class(
    gt_tracks: Dict[int, List[Dict]],
    dt_tracks: Dict[int, List[Dict]],
) -> Dict[str, float]:
    """gt_tracks/dt_tracks: video_id -> list of {segmentations: [rle|None]}.
    Returns HOTA / DetA / AssA for one class (TrackEval hota.py semantics;
    videos are sequences, combined by summing TP/FN/FP and the TP-weighted
    AssA numerator)."""
    from scipy.optimize import linear_sum_assignment  # ~1.5 s to import: only here

    n_a = len(ALPHAS)
    tp = np.zeros(n_a)
    fn = np.zeros(n_a)
    fp = np.zeros(n_a)
    ass_sum = np.zeros(n_a)  # sum over pairs of m * m/(gtc+dtc-m)

    for vid in sorted(set(gt_tracks) | set(dt_tracks)):
        gts = gt_tracks.get(vid, [])
        dts = dt_tracks.get(vid, [])
        t = max((len(tr["segmentations"]) for tr in gts + dts), default=0)
        present_g, counts_g = _track_counts(gts, t)
        present_d, counts_d = _track_counts(dts, t)
        n_g, n_d = len(gts), len(dts)

        # pass 1: per-frame similarity and the Jaccard-normalised potential
        # (TrackEval hota.py:40-58)
        sims = {}
        pot = np.zeros((n_g, n_d))
        for f in range(t):
            gi = np.flatnonzero(present_g[:, f])
            di = np.flatnonzero(present_d[:, f])
            if len(gi) and len(di):
                s = _iou_matrix([counts_g[i][f] for i in gi], [counts_d[j][f] for j in di])
                sims[f] = (gi, di, s)
                denom = s.sum(0)[None, :] + s.sum(1)[:, None] - s
                sim_iou = np.zeros_like(s)
                m = denom > _EPS
                sim_iou[m] = s[m] / denom[m]
                pot[np.ix_(gi, di)] += sim_iou
        gt_cnt = present_g.sum(1).astype(float)
        dt_cnt = present_d.sum(1).astype(float)
        pair_cnt = gt_cnt[:, None] + dt_cnt[None, :]
        glob = pot / np.maximum(pair_cnt - pot, _EPS)

        # pass 2: ONE matching per frame on glob * sim, kept per alpha by the
        # similarity threshold (TrackEval hota.py:60-92)
        matches = np.zeros((n_a, n_g, n_d))
        for f in range(t):
            gi = np.flatnonzero(present_g[:, f])
            di = np.flatnonzero(present_d[:, f])
            if len(gi) == 0:
                fp += len(di)
                continue
            if len(di) == 0:
                fn += len(gi)
                continue
            gi, di, s = sims[f]
            score = glob[np.ix_(gi, di)] * s
            r, c = linear_sum_assignment(-score)
            msim = s[r, c]
            keep = msim[None, :] >= ALPHAS[:, None] - _EPS  # (n_a, n_match)
            nm = keep.sum(1)
            tp += nm
            fn += len(gi) - nm
            fp += len(di) - nm
            for ai in np.flatnonzero(nm):
                sel = keep[ai]
                matches[ai, gi[r[sel]], di[c[sel]]] += 1.0

        # the association numerator of this sequence (hota.py:95-101)
        den = np.maximum(pair_cnt[None] - matches, _EPS)
        ass_sum += (matches * (matches / den)).sum(axis=(1, 2))

    det_a = tp / np.maximum(1.0, tp + fn + fp)
    ass_a = ass_sum / np.maximum(1.0, tp)
    hota = np.sqrt(det_a * ass_a)
    return {"HOTA": float(hota.mean()), "DetA": float(det_a.mean()),
            "AssA": float(ass_a.mean())}


class BURSTEvaluator:
    """Accumulates track predictions; computes HOTA and TrackMAP per split."""

    def __init__(
        self,
        class_splits: Optional[Dict[str, Sequence[int]]] = None,
        dataset_info=None,
        min_area: int = 20,
    ):
        self.predictions: List[Dict] = []
        self.class_splits = class_splits or {}
        self.min_area = min_area
        self._contig_to_dataset_id = (
            {v: k for k, v in dataset_info.id_map.items()} if dataset_info is not None else None
        )

    def process(self, prediction: Dict):
        """prediction: {video_id, category_id, score, segmentations}."""
        self.predictions.append(prediction)

    def process_video(
        self,
        video_id: int,
        topk_out: Dict[str, torch.Tensor],  # scores/labels/mask_logits (topk, T, h, w)
        image_size,
        orig_size,
        canvas_size,
    ):
        """The model's top-k to track predictions.  A frame whose mask covers
        at most ``min_area`` pixels at the original size is absent (None),
        the reference's ``m.sum() > 20`` rule (``data/evals/burst_eval.py:
        203-218``); a track with no frame left is dropped; the contiguous
        labels map back to LVIS ids (``:146-160``)."""
        if self._contig_to_dataset_id is None:
            raise ValueError("BURSTEvaluator.process_video needs the dataset_info's id_map")
        scores = torch.as_tensor(topk_out["scores"]).float().tolist()
        labels = torch.as_tensor(topk_out["labels"]).tolist()
        masks = torch.as_tensor(topk_out["mask_logits"])
        for i in range(len(scores)):
            fg = threshold_masks(masks[i], image_size, orig_size, canvas_size)  # (T, W, H)
            areas = fg.reshape(len(fg), -1).sum(1, dtype=np.int64)
            segs = [rle_util.encode_transposed(f) if a > self.min_area else None
                    for f, a in zip(fg, areas)]
            if all(s is None for s in segs):
                continue
            self.predictions.append({
                "video_id": int(video_id),
                "category_id": self._contig_to_dataset_id[int(labels[i])],
                "score": float(scores[i]),
                "segmentations": segs,
            })

    def evaluate(self, gts: List[Dict], cat_ids: Sequence[int]) -> Dict[str, float]:
        results: Dict[str, float] = {}

        # HOTA: averaged over the classes with GT
        hotas = []
        for cat in cat_ids:
            gt_c = defaultdict(list)
            dt_c = defaultdict(list)
            for g in gts:
                if g["category_id"] == cat:
                    gt_c[g["video_id"]].append(g)
            for d in self.predictions:
                if d["category_id"] == cat:
                    dt_c[d["video_id"]].append(d)
            if not gt_c:
                continue
            hotas.append(hota_for_class(gt_c, dt_c))
        if hotas:
            for k in ("HOTA", "DetA", "AssA"):
                results[k] = float(np.mean([h[k] for h in hotas]))

        # TrackMAP (COCO protocol, spatio-temporal IoU)
        splits = {"all": list(cat_ids), **{k: list(v) for k, v in self.class_splits.items() if v}}
        for split, cats in splits.items():
            ev = YTVOSEval(
                [g for g in gts if g["category_id"] in cats],
                [d for d in self.predictions if d["category_id"] in cats],
                cats,
            )
            ev.accumulate()
            s = ev.summarize()
            suffix = "" if split == "all" else f"_{split}"
            results[f"mAP{suffix}"] = s["AP"]
        return results
