"""RefCOCO/+/g pretraining evaluation: Precision@{1,5,10} at IoU>=0.5 (the
port's copy of ``tce_rvos_tpu/eval/refexp_eval.py``; parity with reference
datasets/refexp_eval.py:13-85)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def _iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,4] x [M,4] -> [N,M] IoU of xyxy boxes (``utils/boxes.py::box_iou``
    in numpy, in float32 as the JAX package computes it)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        return inter / (area_a[:, None] + area_b[None, :] - inter)


class RefExpEvaluator:
    def __init__(self, gt_boxes_by_image: Dict, k: tuple = (1, 5, 10),
                 thresh_iou: float = 0.5):
        """gt_boxes_by_image: image_id -> [n_gt, 4] xyxy arrays."""
        self.gt = gt_boxes_by_image
        self.k = k
        self.thresh_iou = thresh_iou
        self.predictions: Dict = {}

    def update(self, predictions: Dict):
        """predictions: image_id -> {'scores': [n], 'boxes': [n, 4]}."""
        self.predictions.update(predictions)

    def summarize(self) -> Dict[str, float]:
        hits = {k: 0 for k in self.k}
        total = 0
        for image_id, gt in self.gt.items():
            pred = self.predictions.get(image_id)
            if pred is None:
                total += 1
                continue
            order = np.argsort(-np.asarray(pred["scores"]))
            boxes = np.asarray(pred["boxes"])[order]
            iou = _iou_xyxy(boxes, np.asarray(gt).reshape(-1, 4))
            best_per_rank = iou.max(axis=1)
            for k in self.k:
                if (best_per_rank[:k] >= self.thresh_iou).any():
                    hits[k] += 1
            total += 1
        results = {f"P@{k}": hits[k] / max(total, 1) for k in self.k}
        print(f"RefExp precision: {results}")
        return results
