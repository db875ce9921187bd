"""Postprocessors (the port's copy of ``tce_rvos_tpu/models/postprocessors.py``;
parity with reference models/postprocessors.py).

A2D/JHMDB is split into a device part (sigmoid, 4x bilinear upsample,
threshold; on the model's device) and a host part (un-pad, nearest resize
to the original size, RLE encode): one device-to-host copy moves the
binarised stack. The COCO postprocessors run on the host, on the outputs
copied there, with the port's resizes (``utils/interpolate.py``) on CPU
tensors.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from tce_rvos_tpu_torch.utils import rle as rle_util
from tce_rvos_tpu_torch.utils.interpolate import resize_bilinear, resize_nearest


def _host(x) -> np.ndarray:
    """A tensor (any device, any float dtype) or array as a float32 numpy
    array; booleans and integers keep their dtype."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def _sigmoid(x: np.ndarray) -> np.ndarray:
    """1 / (1 + exp(-x)); exp's overflow to inf gives the limit 0."""
    with np.errstate(over="ignore"):
        return 1.0 / (1.0 + np.exp(-x))


def a2d_device_postprocess(outputs: Dict) -> Dict:
    """Device half of A2DSentencesPostProcess (reference :22-41): take the
    single annotated frame, sigmoid scores, upsample masks 4x (bilinear,
    align_corners=False), binarise. Tensors stay on their device."""
    out_logits = outputs["pred_logits"][:, 0, :, 0]       # [B, N]
    out_masks = outputs["pred_masks"][:, 0]               # [B, N, h, w]
    h, w = out_masks.shape[-2:]
    masks = resize_bilinear(out_masks, (h * 4, w * 4), align_corners=False)
    return {"scores": torch.sigmoid(out_logits), "masks": torch.sigmoid(masks) > 0.5}


def a2d_host_postprocess(
    device_out: Dict,
    resized_sizes: List,   # per-sample (h, w) before padding
    orig_sizes: List,      # per-sample (H, W) original dataset size
) -> List[Dict]:
    """Host half (reference :43-54): un-pad, nearest-resize to original size,
    RLE-encode every query's mask."""
    scores = _host(device_out["scores"])
    masks = _host(device_out["masks"])
    preds = []
    for i, (rs, os_) in enumerate(zip(resized_sizes, orig_sizes)):
        mh, mw = int(rs[0]), int(rs[1])
        m = torch.from_numpy(np.ascontiguousarray(masks[i][:, :mh, :mw])).float()
        m = resize_nearest(m, (int(os_[0]), int(os_[1]))).numpy()   # [N, H, W]
        rles = [rle_util.encode((mi > 0.5).astype(np.uint8)) for mi in m]
        preds.append({"scores": scores[i], "masks": m > 0.5, "rle_masks": rles})
    return preds


def coco_postprocess_bbox(outputs: Dict, target_sizes: np.ndarray) -> List[Dict]:
    """PostProcess for COCO pretraining (reference :58-100): flatten (t, q),
    top-k by score, scale boxes to absolute coords, labels forced binary."""
    logits = _host(outputs["pred_logits"])
    boxes = _host(outputs["pred_boxes"])
    b = logits.shape[0]
    logits = logits.reshape(b, -1, logits.shape[-1])
    boxes = boxes.reshape(b, -1, 4)
    num_queries = logits.shape[1]
    prob = _sigmoid(logits)
    flat = prob.reshape(b, -1)
    topk = np.argsort(-flat, axis=1)[:, :num_queries]
    scores = np.take_along_axis(flat, topk, axis=1)
    topk_boxes = topk // logits.shape[2]
    labels = topk % logits.shape[2]
    cx, cy, w, h = (boxes[..., i] for i in range(4))
    xyxy = np.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], -1)
    xyxy = np.take_along_axis(xyxy, topk_boxes[..., None].repeat(4, -1), axis=1)
    target_sizes = np.asarray(target_sizes)
    img_h, img_w = target_sizes[:, 0], target_sizes[:, 1]
    scale = np.stack([img_w, img_h, img_w, img_h], axis=1)[:, None, :]
    xyxy = xyxy * scale
    return [
        {"scores": s, "labels": np.ones_like(l), "boxes": bx}
        for s, l, bx in zip(scores, labels, xyxy)
    ]


def coco_postprocess_segm(
    results: List[Dict],
    outputs: Dict,
    orig_target_sizes: np.ndarray,
    max_target_sizes: np.ndarray,
    threshold: float = 0.5,
) -> List[Dict]:
    """PostProcessSegm (reference :103-154): each sample's top queries'
    masks upsampled 4x (bilinear), thresholded, un-padded and
    nearest-resized to the original size, as ``results[i]["masks"]``
    [N, 1, H, W] uint8."""
    logits = _host(outputs["pred_logits"])
    masks = _host(outputs["pred_masks"])
    b = logits.shape[0]
    logits = logits.reshape(b, -1, logits.shape[-1])
    masks = masks.reshape(b, -1, masks.shape[-2], masks.shape[-1])
    num_queries = logits.shape[1]
    prob = _sigmoid(logits)
    flat = prob.reshape(b, -1)
    topk = np.argsort(-flat, axis=1)[:, :num_queries]
    topk_boxes = topk // logits.shape[2]
    sel = np.take_along_axis(masks, topk_boxes[..., None, None], axis=1)
    h, w = sel.shape[-2:]
    up = resize_bilinear(torch.from_numpy(np.ascontiguousarray(sel, np.float32)),
                         (h * 4, w * 4)).numpy()
    up = _sigmoid(up) > threshold
    for i, (t, tt) in enumerate(zip(max_target_sizes, orig_target_sizes)):
        ih, iw = int(t[0]), int(t[1])
        cur = torch.from_numpy(np.ascontiguousarray(up[i][:, :ih, :iw])).float()
        cur = resize_nearest(cur, (int(tt[0]), int(tt[1]))).numpy().astype(np.uint8)
        results[i]["masks"] = cur[:, None]
    return results
