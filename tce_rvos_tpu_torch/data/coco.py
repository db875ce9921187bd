"""Plain COCO detection dataset (the port's copy of
``tce_rvos_tpu/data/coco.py``; parity with reference datasets/coco.py:
CocoDetection + polygon->mask conversion, over ``data/refexp.py``'s
``poly_to_mask``, which fills polygons as cv2.fillPoly does). A
self-contained JSON reader: no pycocotools, no cv2. No entry point of
either package reads it."""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from tce_rvos_tpu_torch.data.refexp import poly_to_mask


class CocoDetection:
    def __init__(self, img_folder: str, ann_file: str, transforms=None,
                 return_masks: bool = True):
        self.img_folder = img_folder
        self._transforms = transforms
        self.return_masks = return_masks
        with open(ann_file) as fh:
            coco = json.load(fh)
        self.images = {img["id"]: img for img in coco["images"]}
        self.anns_by_image: Dict = {}
        self._eval_anns_by_image: Dict = {}  # crowds kept (evaluator ignores)
        for ann in coco["annotations"]:
            self._eval_anns_by_image.setdefault(ann["image_id"], []).append(ann)
            if ann.get("iscrowd", 0):
                continue
            self.anns_by_image.setdefault(ann["image_id"], []).append(ann)
        self.ids = sorted(self.images.keys())

    def coco_gt_by_image(self) -> Dict:
        """GT annotations in eval.coco_eval.CocoEvaluator format: crowd anns
        are retained (the COCO protocol scores them as ignores, reference
        datasets/coco_eval.py via pycocotools)."""
        from tce_rvos_tpu_torch.utils import rle as rle_util

        out: Dict = {}
        for img_id, anns in self._eval_anns_by_image.items():
            info = self.images[img_id]
            h, w = int(info["height"]), int(info["width"])
            recs = []
            for a in anns:
                d = {
                    "bbox": a["bbox"],
                    "area": a.get(
                        "area", float(a["bbox"][2]) * float(a["bbox"][3])
                    ),
                    "iscrowd": a.get("iscrowd", 0),
                }
                if "segmentation" in a:
                    seg = a["segmentation"]
                    # polygons are rasterized; crowd anns usually ship RLE
                    # dicts already in the wire format — pass them through
                    d["segmentation"] = seg if isinstance(seg, dict) else (
                        rle_util.encode(poly_to_mask(seg, h, w).astype(np.uint8))
                    )
                recs.append(d)
            out[img_id] = recs
        return out

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx: int):
        from PIL import Image

        img_id = self.ids[idx]
        info = self.images[img_id]
        anns = self.anns_by_image.get(img_id, [])
        img = np.asarray(
            Image.open(os.path.join(self.img_folder, info["file_name"])).convert("RGB"),
            np.float32,
        ) / 255.0
        h, w = img.shape[:2]

        boxes, labels, masks, valid = [], [], [], []
        for ann in anns:
            x, y, bw, bh = ann["bbox"]
            box = [x, y, x + bw, y + bh]
            box = [
                min(max(box[0], 0), w), min(max(box[1], 0), h),
                min(max(box[2], 0), w), min(max(box[3], 0), h),
            ]
            if box[2] <= box[0] or box[3] <= box[1]:
                continue
            boxes.append(box)
            labels.append(ann["category_id"])
            valid.append(1)
            if self.return_masks and "segmentation" in ann:
                masks.append(poly_to_mask(ann["segmentation"], h, w))
        target = {
            "image_id": img_id,
            "labels": np.asarray(labels, np.int64),
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "valid": np.asarray(valid, np.int64),
            "orig_size": np.asarray([h, w], np.int64),
            "size": np.asarray([h, w], np.int64),
        }
        if masks:
            target["masks"] = np.stack(masks)
        frames = [img]  # 1-frame clip
        if self._transforms is not None:
            frames, target = self._transforms(frames, target)
        return np.stack(frames), target
