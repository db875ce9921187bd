"""Ref-YouTube-VOS (and Ref-DAVIS17 train) clip dataset: the port's copy of
``tce_rvos_tpu/data/ytvos.py``, the same samples for the same
``random.Random`` (and, under ``vid_aug``, the same global numpy state).

Behavioural parity with reference datasets/ytvos.py / datasets/davis.py:
  * metas enumerated per (video, expression) with anchor frames every
    num_frames (default mode, ytvos.py:89-99) or consecutive windows with a
    per-epoch phase counter (keep_fps mode, ytvos.py:76-87 + refresh_metas);
  * default sampling: anchor + local (±1..3) + global random fill
    (ytvos.py:138-162);
  * vid_aug: random fps step, 50% clip reversal, random black-box occlusion
    (ytvos.py:128-132,164-175,286-299);
  * per-frame binary mask from the palette PNG, box from the mask, valid
    flag per frame; resample-on-empty retry loop (ytvos.py:114,226-231);
  * f_extra context frames whose targets are trimmed (clip_target,
    ytvos.py:234-247).

Host-side numpy, PIL for decoding. Returns (frames: list[np.float32 HxWx3 in
0..1], target dict) ready for the transforms in data/transforms.py.

Quirks kept on purpose, as in the JAX package: without ``rng`` the dataset
draws from an unseeded ``random.Random()``, and ``vid_aug``'s occlusion
fires on the global ``np.random``.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from tce_rvos_tpu_torch.data.categories import davis_category_dict, ytvos_category_dict


def mask_to_box(mask: np.ndarray) -> Tuple[int, int, int, int]:
    """binary mask -> (y1, y2, x1, x2) tight box (ytvos.py:102-108)."""
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    rmin, rmax = np.where(rows)[0][[0, -1]]
    cmin, cmax = np.where(cols)[0][[0, -1]]
    return int(rmin), int(rmax), int(cmin), int(cmax)


def sample_clip_indices(
    frame_id: int,
    vid_len: int,
    num_frames: int,
    rng: random.Random,
    keep_fps: bool = False,
    vid_aug: bool = False,
    f_extra: int = 0,
) -> List[int]:
    """Clip frame sampling (ytvos.py:125-165): anchor + local(±1..3) +
    global random fill; or consecutive (optionally fps-stepped) window in
    keep_fps mode; optional 50% reversal with vid_aug.

    Reference quirks replicated deliberately (ytvos.py:134-137): in
    keep_fps mode the window length ignores f_extra (total != num_frames
    when f_extra > 0 — the combination is broken in the reference too),
    and with vid_aug's step > 1 the range yields num_frames extra indices
    offset by +1 (consumers read the first ``total`` sorted entries,
    exactly as the reference's read loop does)."""
    total = num_frames + 2 * f_extra
    sample = [frame_id]
    if vid_aug:
        valid_fps = min((vid_len - frame_id) // max(total, 1), 3)
        step = rng.randint(1, max(valid_fps, 1))
    else:
        step = 1
    if keep_fps:
        if total != 1:
            for s in range(1, num_frames * step, step):
                assert frame_id + s < vid_len, "frame sampled out of range"
                sample.append(frame_id + s)
    elif total != 1:
        before = rng.randint(1, 3)
        after = rng.randint(1, 3)
        sample.extend([max(0, frame_id - before), min(vid_len - 1, frame_id + after)])
        if total > 3:
            all_inds = list(range(vid_len))
            global_inds = all_inds[: min(sample)] + all_inds[max(sample):]
            global_n = total - len(sample)
            if len(global_inds) > global_n:
                sample.extend(rng.sample(global_inds, global_n))
            elif vid_len >= global_n:
                sample.extend(rng.sample(all_inds, global_n))
            else:
                sample.extend(rng.sample(all_inds, global_n - vid_len) + all_inds)
    sample.sort()
    if vid_aug and rng.random() < 0.5:
        sample.reverse()
    return sample


def random_black_box(img: np.ndarray, rng: random.Random, ratio: float = 0.5):
    """vid_aug occlusion: zero out a random box (ytvos.py:286-299)."""
    h, w = img.shape[:2]
    xc = rng.random() * (w - 1)
    yc = rng.random() * (h - 1)
    h_r = rng.random() * (h - 1) * ratio
    w_r = rng.random() * (w - 1) * ratio
    xl, xh = int(max(0, xc - w_r / 2)), int(min(w, xc + w_r / 2))
    yl, yh = int(max(0, yc - h_r / 2)), int(min(h, yc + h_r / 2))
    img = img.copy()
    img[yl:yh, xl:xh] = 0.0
    return img


class YTVOSDataset:
    """Training clips for Ref-YouTube-VOS-style layouts
    (<root>/JPEGImages, <root>/Annotations, meta.json + meta_expressions)."""

    def __init__(
        self,
        img_folder: str,
        ann_file: str,
        transforms=None,
        num_frames: int = 5,
        max_skip: int = 3,
        keep_fps: bool = False,
        vid_aug: bool = False,
        f_extra: int = 0,
        category_dict: Optional[Dict[str, int]] = None,
        rng: Optional[random.Random] = None,
    ):
        self.img_folder = str(img_folder)
        self.ann_file = str(ann_file)
        self._transforms = transforms
        self.num_frames = num_frames
        self.max_skip = max_skip
        self.keep_fps = keep_fps
        self.vid_aug = vid_aug
        self.f_extra = f_extra
        self.category_dict = category_dict or ytvos_category_dict
        self.counter = -1
        self.rng = rng or random.Random()
        self.prepare_metas()

    def refresh_metas(self):
        """keep_fps epoch hook: advance the window phase (ytvos.py:53-57)."""
        self.counter = (self.counter + 1) % self.num_frames
        self.prepare_metas()

    def prepare_metas(self):
        with open(os.path.join(self.img_folder, "meta.json")) as fh:
            metas_by_video = json.load(fh)["videos"]
        with open(self.ann_file) as fh:
            exps_by_video = json.load(fh)["videos"]
        self.videos = list(exps_by_video.keys())
        self.metas: List[Dict] = []
        for vid in self.videos:
            vid_meta = metas_by_video[vid]
            vid_data = exps_by_video[vid]
            vid_frames = sorted(vid_data["frames"])
            vid_len = len(vid_frames)
            for exp_id, exp_dict in vid_data["expressions"].items():
                obj_id = exp_dict["obj_id"]
                category = vid_meta["objects"][obj_id]["category"]
                if self.keep_fps:
                    anchor_range = range(
                        max(self.counter, 0), vid_len - self.num_frames,
                        self.num_frames - 1,
                    )
                else:
                    anchor_range = range(0, vid_len, self.num_frames)
                for frame_id in anchor_range:
                    self.metas.append(
                        dict(
                            video=vid,
                            exp=exp_dict["exp"],
                            obj_id=int(obj_id),
                            frames=vid_frames,
                            frame_id=frame_id,
                            category=category,
                        )
                    )

    def __len__(self):
        return len(self.metas)

    def _sample_indices(self, frame_id: int, vid_len: int) -> List[int]:
        return sample_clip_indices(
            frame_id, vid_len, self.num_frames, self.rng,
            keep_fps=self.keep_fps, vid_aug=self.vid_aug, f_extra=self.f_extra,
        )

    def _load_frame(self, video: str, frame_name: str):
        from PIL import Image

        img_path = os.path.join(self.img_folder, "JPEGImages", video, frame_name + ".jpg")
        mask_path = os.path.join(self.img_folder, "Annotations", video, frame_name + ".png")
        img = np.asarray(Image.open(img_path).convert("RGB"), np.float32) / 255.0
        mask = np.array(Image.open(mask_path).convert("P"))
        return img, mask

    def __getitem__(self, idx: int):
        for _attempt in range(64):  # resample-on-empty (ytvos.py:114,226-231)
            meta = self.metas[idx]
            exp = " ".join(meta["exp"].lower().split())
            category_id = self.category_dict[meta["category"]]
            frames, frame_id = meta["frames"], meta["frame_id"]
            vid_len = len(frames)
            num_frames = self.num_frames + 2 * self.f_extra

            sample_indx = self._sample_indices(frame_id, vid_len)
            imgs, labels, boxes, masks, valid = [], [], [], [], []
            for j in range(num_frames):
                img, pal = self._load_frame(meta["video"], frames[sample_indx[j]])
                if self.vid_aug and np.random.rand() < 1.0 / num_frames:
                    img = random_black_box(img, self.rng)
                mask = (pal == meta["obj_id"]).astype(np.float32)
                if (mask > 0).any():
                    y1, y2, x1, x2 = mask_to_box(mask)
                    boxes.append([x1, y1, x2, y2])
                    valid.append(1)
                else:
                    boxes.append([0, 0, 0, 0])
                    valid.append(0)
                imgs.append(img)
                labels.append(category_id)
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
                return np.stack(imgs), clip_target(target, self.f_extra)
            idx = self.rng.randint(0, len(self) - 1)
        raise RuntimeError("could not sample a clip with a visible instance")


def clip_target(target: Dict, f_extra: int) -> Dict:
    """Trim the f_extra context frames from supervision (ytvos.py:234-247)."""
    if f_extra == 0:
        return target
    for k in ("frames_idx", "labels", "boxes", "masks", "valid"):
        target[k] = target[k][f_extra:-f_extra]
    return target


def _build(root: str, image_set: str, data_cfg, model_cfg, transforms, category_dict):
    from tce_rvos_tpu_torch.data.transforms import make_train_transform, make_val_transform

    paths = {
        "train": (os.path.join(root, "train"),
                  os.path.join(root, "meta_expressions", "train", "meta_expressions.json")),
        # the reference pairs valid/ images with a nonexistent
        # meta_expressions/val/ file (ytvos.py:307, marked "not used
        # actually"); the real on-disk layout is "valid"
        "val": (os.path.join(root, "valid"),
                os.path.join(root, "meta_expressions", "valid", "meta_expressions.json")),
    }
    img_folder, ann_file = paths[image_set]
    tf = transforms or (
        make_train_transform(data_cfg.max_size) if image_set == "train"
        else make_val_transform()
    )
    return YTVOSDataset(
        img_folder, ann_file, tf,
        num_frames=model_cfg.num_frames, max_skip=data_cfg.max_skip,
        keep_fps=data_cfg.keep_fps, vid_aug=data_cfg.vid_aug,
        f_extra=model_cfg.f_extra, category_dict=category_dict,
    )


def build_ytvos(image_set: str, data_cfg, model_cfg, transforms=None):
    return _build(data_cfg.ytvos_path, image_set, data_cfg, model_cfg, transforms,
                  ytvos_category_dict)


def build_davis(image_set: str, data_cfg, model_cfg, transforms=None):
    """Ref-DAVIS17 train uses the same layout with davis categories
    (reference datasets/davis.py)."""
    return _build(data_cfg.davis_path, image_set, data_cfg, model_cfg, transforms,
                  davis_category_dict)
