"""MeViS dataset, multi-object expressions (the port's copy of
``tce_rvos_tpu/data/mevis.py``): the same samples for the same
``random.Random``.

Parity with reference datasets/mevis.py: expressions carry lists of
obj_id/anno_id; the supervision mask is the UNION of the RLE-decoded
per-annotation masks from mask_dict.json (mevis.py:60-73,139-143). Clip
sampling is the ytvos default scheme (``ytvos.sample_clip_indices``).
"""

from __future__ import annotations

import json
import os
import random
from typing import Optional

import numpy as np

from tce_rvos_tpu_torch.data.ytvos import mask_to_box, sample_clip_indices
from tce_rvos_tpu_torch.utils import rle as rle_util


class MeViSDataset:
    def __init__(
        self,
        img_folder: str,
        ann_file: str,
        transforms=None,
        num_frames: int = 5,
        rng: Optional[random.Random] = None,
    ):
        self.img_folder = str(img_folder)
        self._transforms = transforms
        self.num_frames = num_frames
        self.rng = rng or random.Random()

        with open(ann_file) as fh:
            exps_by_video = json.load(fh)["videos"]
        with open(os.path.join(self.img_folder, "mask_dict.json")) as fh:
            self.mask_dict = json.load(fh)

        self.videos = list(exps_by_video.keys())
        self.metas = []
        for vid in self.videos:
            data = exps_by_video[vid]
            vid_frames = sorted(data["frames"])
            for exp_dict in data["expressions"].values():
                for frame_id in range(0, len(vid_frames), self.num_frames):
                    self.metas.append(dict(
                        video=vid,
                        exp=exp_dict["exp"],
                        anno_ids=[str(a) for a in exp_dict["anno_id"]],
                        frames=vid_frames,
                        frame_id=frame_id,
                    ))

    def __len__(self):
        return len(self.metas)

    def _union_mask(self, anno_ids, frame_idx: int, hw):
        mask = np.zeros(hw, np.float32)
        for aid in anno_ids:
            r = self.mask_dict[aid][frame_idx]
            if r is not None:
                mask = np.maximum(mask, rle_util.decode(r).astype(np.float32))
        return mask

    def __getitem__(self, idx: int):
        from PIL import Image

        for _ in range(64):  # resample-on-empty
            meta = self.metas[idx]
            exp = " ".join(meta["exp"].lower().split())
            frames, frame_id = meta["frames"], meta["frame_id"]
            sample_indx = sample_clip_indices(frame_id, len(frames), self.num_frames, self.rng)

            imgs, labels, boxes, masks, valid = [], [], [], [], []
            for j in range(self.num_frames):
                name = frames[sample_indx[j]]
                img = np.asarray(
                    Image.open(os.path.join(self.img_folder, "JPEGImages", meta["video"],
                                            name + ".jpg")).convert("RGB"),
                    np.float32,
                ) / 255.0
                mask = self._union_mask(meta["anno_ids"], sample_indx[j], img.shape[:2])
                if (mask > 0).any():
                    y1, y2, x1, x2 = mask_to_box(mask)
                    boxes.append([x1, y1, x2, y2])
                    valid.append(1)
                else:
                    boxes.append([0, 0, 0, 0])
                    valid.append(0)
                imgs.append(img)
                labels.append(0)
                masks.append(mask)

            h, w = imgs[0].shape[:2]
            boxes = np.asarray(boxes, np.float32)
            boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
            boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
            target = {
                "frames_idx": np.asarray(sample_indx, np.int64),
                "labels": np.asarray(labels, np.int64),
                "boxes": boxes,
                "masks": np.stack(masks),
                "valid": np.asarray(valid, np.int64),
                "caption": exp,
                "orig_size": np.asarray([h, w], np.int64),
                "size": np.asarray([h, w], np.int64),
            }
            if self._transforms is not None:
                imgs, target = self._transforms(imgs, target)
            if np.any(target["valid"] == 1):
                return np.stack(imgs), target
            idx = self.rng.randint(0, len(self) - 1)
        raise RuntimeError("could not sample a MeViS clip with a visible instance")


def build_mevis(image_set: str, data_cfg, model_cfg, transforms=None):
    """``<mevis_path>/train`` (or ``valid``): JPEGImages, mask_dict.json and
    meta_expressions.json."""
    from tce_rvos_tpu_torch.data.transforms import make_train_transform, make_val_transform

    split = "train" if image_set == "train" else "valid"
    img_folder = os.path.join(data_cfg.mevis_path, split)
    tf = transforms or (
        make_train_transform(data_cfg.max_size) if image_set == "train"
        else make_val_transform()
    )
    return MeViSDataset(img_folder, os.path.join(img_folder, "meta_expressions.json"), tf,
                        num_frames=model_cfg.num_frames)
