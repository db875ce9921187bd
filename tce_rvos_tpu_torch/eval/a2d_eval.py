"""A2D-Sentences / JHMDB-Sentences metrics (the port's copy of
``tce_rvos_tpu/eval/a2d_eval.py``).

Parity with reference datasets/a2d_eval.py:20-45 (precision@{0.5..0.9},
overall IoU, mean IoU over best-scoring predictions per ground truth) and
the COCO mAP protocol the reference drives through pycocotools
(engine.py:332-348, segm, useCats=0): a self-contained AP over RLE masks.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from tce_rvos_tpu_torch.utils import rle as rle_util


def calculate_precision_at_k_and_iou_metrics(
    gt_by_image: Dict, preds: List[Dict]
) -> Tuple[List[float], float, float]:
    """Args mirror the reference semantics: for every image, the top-scoring
    prediction is compared with its (single) GT mask.

    gt_by_image: image_id -> gt RLE dict.
    preds: list of {'image_id', 'score', 'rle'}.
    Returns ([P@0.5..0.9], overall_iou, mean_iou).
    """
    best: Dict = {}
    for p in preds:
        cur = best.get(p["image_id"])
        if cur is None or p["score"] > cur["score"]:
            best[p["image_id"]] = p

    ious = []
    total_inter = 0
    total_union = 0
    for image_id, gt in gt_by_image.items():
        pred = best.get(image_id)
        gm = rle_util.decode(gt).astype(bool)
        pm = (
            rle_util.decode(pred["rle"]).astype(bool)
            if pred is not None
            else np.zeros_like(gm)
        )
        inter = np.logical_and(gm, pm).sum()
        union = np.logical_or(gm, pm).sum()
        ious.append(inter / union if union else 0.0)
        total_inter += inter
        total_union += union
    ious = np.asarray(ious)
    precision_at_k = [float((ious > th).mean()) for th in (0.5, 0.6, 0.7, 0.8, 0.9)]
    overall_iou = float(total_inter / total_union) if total_union else 0.0
    mean_iou = float(ious.mean()) if len(ious) else 0.0
    return precision_at_k, overall_iou, mean_iou


def _ap_at_iou(
    gt_by_image: Dict, preds: List[Dict], iou_thr: float
) -> float:
    """Single-category COCO-style AP (101-point interpolation); each image
    has exactly one GT instance (the A2D setting)."""
    preds = sorted(preds, key=lambda p: -p["score"])
    if not preds:
        return 0.0
    n_gt = len(gt_by_image)
    matched = set()
    tp = np.zeros(len(preds))
    fp = np.zeros(len(preds))
    for i, p in enumerate(preds):
        gid = p["image_id"]
        gt = gt_by_image.get(gid)
        if gt is None:
            fp[i] = 1
            continue
        iou = rle_util.iou(p["rle"], gt)
        if iou >= iou_thr and gid not in matched:
            tp[i] = 1
            matched.add(gid)
        else:
            fp[i] = 1
    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    recall = ctp / max(n_gt, 1)
    precision = ctp / np.maximum(ctp + cfp, 1e-9)
    # precision envelope + 101-point interpolation (COCO)
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    rec_points = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, rec_points, side="left")
    prec_at = np.where(
        idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0
    )
    return float(prec_at.mean())


def calculate_map(gt_by_image: Dict, preds: List[Dict]) -> Dict[str, float]:
    """mAP@[0.5:0.95:0.05] + AP50/AP75 over single-instance images."""
    thrs = np.arange(0.5, 1.0, 0.05)
    aps = [_ap_at_iou(gt_by_image, preds, t) for t in thrs]
    return {
        "mAP 0.5:0.95": float(np.mean(aps)),
        "AP 0.5": aps[0],
        "AP 0.75": aps[5],
    }
