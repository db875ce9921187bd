"""COCO-protocol detection/segmentation evaluator, box and mask mAP (the
port's copy of ``tce_rvos_tpu/eval/coco_eval.py``).

A numpy re-implementation of the pycocotools ``COCOeval`` protocol the
reference drives through ``datasets/coco_eval.py`` and
``engine.py:100-160``: ``CocoEvaluator(coco_gt, iou_types, useCats=False)``
per dataset, fed postprocessor outputs keyed by image id, read as the
12-number COCO stats vector per iou_type. The matching rules follow the
published protocol:

  * IoU thresholds 0.50:0.05:0.95, recall grid 0:0.01:1 (101 points)
  * greedy score-ordered matching per threshold; crowd GTs may match many
    detections and are scored as ignores (IoU vs crowd = inter/det_area)
  * area-range filtering (all / small<32^2 / medium / large>96^2) with the
    out-of-range-GT -> ignore, unmatched-out-of-range-det -> ignore rules
  * maxDets (1, 10, 100); AP at maxDet=100

The reference's ``useCats=False`` pools all classes into one; that is the
only mode here too.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from tce_rvos_tpu_torch.utils import rle as rle_util

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
MAX_DETS = (1, 10, 100)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}

STAT_NAMES = (
    "AP", "AP50", "AP75", "AP_small", "AP_medium", "AP_large",
    "AR@1", "AR@10", "AR@100", "AR_small", "AR_medium", "AR_large",
)


def box_iou_xyxy(dets: np.ndarray, gts: np.ndarray, crowd: np.ndarray) -> np.ndarray:
    """IoU matrix [n_det, n_gt]; for crowd GTs the denominator is the det
    area only (pycocotools ``iscrowd`` semantics)."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    x1 = np.maximum(dets[:, None, 0], gts[None, :, 0])
    y1 = np.maximum(dets[:, None, 1], gts[None, :, 1])
    x2 = np.minimum(dets[:, None, 2], gts[None, :, 2])
    y2 = np.minimum(dets[:, None, 3], gts[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    det_a = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])
    gt_a = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
    union = np.where(
        crowd[None, :], det_a[:, None], det_a[:, None] + gt_a[None, :] - inter
    )
    return inter / np.maximum(union, 1e-9)


def _mask_iou(det_rles: List[Dict], gt_rles: List[Dict], crowd: np.ndarray) -> np.ndarray:
    out = np.zeros((len(det_rles), len(gt_rles)))
    det_masks = [rle_util.decode(r).astype(bool) for r in det_rles]
    gt_masks = [rle_util.decode(r).astype(bool) for r in gt_rles]
    for j, (gm, cr) in enumerate(zip(gt_masks, crowd)):
        for i, dm in enumerate(det_masks):
            inter = np.logical_and(dm, gm).sum()
            denom = dm.sum() if cr else dm.sum() + gm.sum() - inter
            out[i, j] = inter / max(denom, 1e-9)
    return out


class CocoEvaluator:
    """Accumulating evaluator over postprocessor outputs.

    gt_by_image: image_id -> list of annotation dicts with keys
      ``bbox`` (xywh), ``area``, ``iscrowd`` and, for the ``segm`` iou_type,
      ``segmentation`` (an RLE dict as produced by utils/rle.py).
    Predictions passed to :meth:`update` map image_id -> the dicts returned
    by ``coco_postprocess_bbox`` / ``coco_postprocess_segm``
    (models/postprocessors.py): ``scores`` [N], ``boxes`` [N,4] xyxy and,
    for segm, ``masks`` [N,1,H,W] or ``rle_masks``.
    """

    def __init__(
        self,
        gt_by_image: Dict,
        iou_types: Sequence[str] = ("bbox",),
        use_cats: bool = False,
    ):
        for t in iou_types:
            if t not in ("bbox", "segm"):
                raise ValueError(f"unsupported iou_type {t}")
        if use_cats:
            raise NotImplementedError(
                "the reference always evaluates class-agnostic "
                "(engine.py useCats=False); per-category AP is out of scope"
            )
        self.gt_by_image = gt_by_image
        self.iou_types = tuple(iou_types)
        # per iou_type: list of per-image eval records
        self._per_image: Dict[str, List[Dict]] = {t: [] for t in self.iou_types}
        self._seen: set = set()

    # ---- per-image evaluation (pycocotools evaluateImg equivalent) ----

    def _eval_image(self, iou_type: str, image_id, pred: Dict) -> Dict:
        gts = self.gt_by_image.get(image_id, [])
        scores = np.asarray(pred.get("scores", np.zeros(0)), np.float64)
        order = np.argsort(-scores, kind="mergesort")[: max(MAX_DETS)]
        scores = scores[order]
        n_det, n_gt = len(scores), len(gts)

        gt_crowd = np.array([bool(g.get("iscrowd", 0)) for g in gts])
        gt_area = np.array([float(g["area"]) for g in gts])

        if iou_type == "bbox":
            boxes = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)[order]
            gt_xyxy = np.array(
                [
                    [b[0], b[1], b[0] + b[2], b[1] + b[3]]
                    for b in (g["bbox"] for g in gts)
                ]
            ).reshape(n_gt, 4)
            det_area = np.maximum(
                (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]), 0
            )
            ious = box_iou_xyxy(boxes, gt_xyxy, gt_crowd)
        else:
            if "rle_masks" in pred:
                det_rles = [pred["rle_masks"][i] for i in order]
            else:
                masks = np.asarray(pred["masks"])[order]
                det_rles = [
                    rle_util.encode(np.asarray(m).squeeze().astype(np.uint8))
                    for m in masks
                ]
            gt_rles = [g["segmentation"] for g in gts]
            det_area = np.array([rle_util.area(r) for r in det_rles], np.float64)
            ious = _mask_iou(det_rles, gt_rles, gt_crowd)

        return {
            "scores": scores,
            "det_area": det_area,
            "gt_area": gt_area,
            "gt_crowd": gt_crowd,
            "ious": ious,
        }

    def update(self, predictions: Dict):
        for image_id, pred in predictions.items():
            if image_id in self._seen:
                continue
            self._seen.add(image_id)
            for t in self.iou_types:
                self._per_image[t].append(self._eval_image(t, image_id, pred))

    # ---- matching + accumulation ----

    @staticmethod
    def _match(rec: Dict, area_rng, max_det: int):
        """Greedy per-threshold matching (pycocotools evaluateImg core).
        Returns (det_scores, det_matched[T, D], det_ignore[T, D], n_pos_gt)."""
        lo, hi = area_rng
        scores = rec["scores"][:max_det]
        ious = rec["ious"][:max_det]
        det_area = rec["det_area"][:max_det]
        gt_crowd, gt_area = rec["gt_crowd"], rec["gt_area"]
        n_det, n_gt = len(scores), len(gt_area)

        gt_ig = gt_crowd | (gt_area < lo) | (gt_area > hi)
        # ignores sort to the end (pycocotools gtind)
        gt_order = np.argsort(gt_ig, kind="mergesort")
        gt_ig = gt_ig[gt_order]
        crowd_s = gt_crowd[gt_order]
        ious_s = ious[:, gt_order] if n_gt else ious

        T = len(IOU_THRS)
        dtm = np.zeros((T, n_det), dtype=bool)
        dt_ig = np.zeros((T, n_det), dtype=bool)
        for ti, thr in enumerate(IOU_THRS):
            gt_taken = np.zeros(n_gt, dtype=bool)
            for di in range(n_det):
                best, best_j = min(thr, 1 - 1e-10), -1
                for j in range(n_gt):
                    if gt_taken[j] and not crowd_s[j]:
                        continue
                    # gts are sorted non-ignored first: once we hold a real
                    # match, never trade it for an ignored one
                    if best_j > -1 and not gt_ig[best_j] and gt_ig[j]:
                        break
                    if ious_s[di, j] < best:
                        continue
                    best, best_j = ious_s[di, j], j
                if best_j == -1:
                    continue
                gt_taken[best_j] = True
                dtm[ti, di] = True
                dt_ig[ti, di] = gt_ig[best_j]
        # unmatched dets outside the area range don't count as FPs
        out_of_rng = (det_area < lo) | (det_area > hi)
        dt_ig |= (~dtm) & out_of_rng[None, :]
        n_pos = int((~gt_ig).sum())
        return scores, dtm, dt_ig, n_pos

    def _accumulate(self, iou_type: str):
        """precision[T, R, A, M] / recall[T, A, M] grids."""
        T, R = len(IOU_THRS), len(REC_THRS)
        A, M = len(AREA_RNGS), len(MAX_DETS)
        precision = -np.ones((T, R, A, M))
        recall = -np.ones((T, A, M))
        records = self._per_image[iou_type]
        for ai, rng in enumerate(AREA_RNGS.values()):
            for mi, max_det in enumerate(MAX_DETS):
                matched = [self._match(r, rng, max_det) for r in records]
                n_pos = sum(m[3] for m in matched)
                if n_pos == 0:
                    continue
                all_scores = np.concatenate([m[0] for m in matched])
                order = np.argsort(-all_scores, kind="mergesort")
                dtm = np.concatenate([m[1] for m in matched], axis=1)[:, order]
                dt_ig = np.concatenate([m[2] for m in matched], axis=1)[:, order]
                tp = np.cumsum(dtm & ~dt_ig, axis=1).astype(np.float64)
                fp = np.cumsum(~dtm & ~dt_ig, axis=1).astype(np.float64)
                for ti in range(T):
                    rc = tp[ti] / n_pos
                    pr = tp[ti] / np.maximum(tp[ti] + fp[ti], 1e-9)
                    recall[ti, ai, mi] = rc[-1] if len(rc) else 0.0
                    # precision envelope then sample the recall grid
                    for i in range(len(pr) - 2, -1, -1):
                        pr[i] = max(pr[i], pr[i + 1])
                    idx = np.searchsorted(rc, REC_THRS, side="left")
                    q = np.zeros(R)
                    valid = idx < len(pr)
                    q[valid] = pr[idx[valid]]
                    precision[ti, :, ai, mi] = q
        return precision, recall

    def summarize(self) -> Dict[str, Dict[str, float]]:
        """Returns iou_type -> the 12 named COCO stats (AP at maxDet=100)."""
        out = {}
        for t in self.iou_types:
            precision, recall = self._accumulate(t)
            area_idx = {k: i for i, k in enumerate(AREA_RNGS)}
            md_idx = {m: i for i, m in enumerate(MAX_DETS)}

            def ap(thr=None, area="all", max_det=100):
                p = precision[:, :, area_idx[area], md_idx[max_det]]
                if thr is not None:
                    p = p[np.isclose(IOU_THRS, thr)]
                p = p[p > -1]
                return float(p.mean()) if p.size else -1.0

            def ar(area="all", max_det=100):
                r = recall[:, area_idx[area], md_idx[max_det]]
                r = r[r > -1]
                return float(r.mean()) if r.size else -1.0

            out[t] = {
                "AP": ap(),
                "AP50": ap(thr=0.5),
                "AP75": ap(thr=0.75),
                "AP_small": ap(area="small"),
                "AP_medium": ap(area="medium"),
                "AP_large": ap(area="large"),
                "AR@1": ar(max_det=1),
                "AR@10": ar(max_det=10),
                "AR@100": ar(max_det=100),
                "AR_small": ar(area="small"),
                "AR_medium": ar(area="medium"),
                "AR_large": ar(area="large"),
            }
        return out

    def stats(self, iou_type: str = "bbox") -> List[float]:
        """The pycocotools-ordered 12-number stats vector
        (reference engine.py:154-157 reads ``coco_eval['bbox'].stats``)."""
        s = self.summarize()[iou_type]
        return [s[k] for k in STAT_NAMES]
