"""A2D-Sentences and JHMDB-Sentences datasets (the port's copy of
``tce_rvos_tpu/data/a2d.py``).

Parity with reference datasets/a2d.py / datasets/jhmdb.py:
  * A2D: frames decoded from Release/clips320H/<video>.mp4 with cv2,
    instance masks from per-frame .h5 files ('reMask' transposed,
    'instance' ids) with h5py; ONE annotated frame per clip ->
    ``valid_indices`` in the target; train window = the annotated frame +
    local + global sampling, val window centred on the annotated frame
    with edge padding (a2d.py:113-121). cv2 and h5py are imported when a
    sample is read, and a missing one raises naming the package: the
    port's other datasets need neither (the GPU machine of the port's
    smoke run has neither, so A2D runs on machines that have them).
  * JHMDB (evaluation only): frames from Rename_Images (PNG), masks from
    puppet_mask.mat (scipy.io); a window of ``num_frames`` centred on the
    annotated frame, whose index in the window is ``valid_indices``.
    Numpy, PIL and scipy only.
"""

from __future__ import annotations

import importlib
import json
import os
import random
from typing import List, Optional

import numpy as np

from tce_rvos_tpu_torch.data.ytvos import mask_to_box


def _require(module: str, package: str):
    """Import ``module``, or raise naming the package that provides it."""
    try:
        return importlib.import_module(module)
    except ImportError as exc:
        raise ImportError(
            f"--dataset_file a2d reads its .mp4 clips with cv2 and its .h5 masks with h5py: "
            f"install {package} ({exc})") from exc


def read_video_cv2(path: str) -> np.ndarray:
    """Every frame of a video file, RGB uint8 [T, H, W, 3]."""
    cv2 = _require("cv2", "opencv-python")
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    return np.stack(frames) if frames else np.zeros((0, 0, 0, 3), np.uint8)


def _train_window(frame_id: int, vid_len: int, num_frames: int, rng) -> List[int]:
    """A2D train window (a2d.py:113-121): the annotated frame, one local
    frame a side (1-3 away) and a global random fill, sorted."""
    sample = [frame_id]
    before, after = rng.randint(1, 3), rng.randint(1, 3)
    sample.extend([max(0, frame_id - before), min(vid_len - 1, frame_id + after)])
    if num_frames > 3:
        all_inds = list(range(vid_len))
        global_inds = all_inds[: min(sample)] + all_inds[max(sample):]
        global_n = num_frames - len(sample)
        if len(global_inds) > global_n:
            sample.extend(rng.sample(global_inds, global_n))
        elif vid_len >= global_n:
            sample.extend(rng.sample(all_inds, global_n))
        else:
            sample.extend(rng.sample(all_inds, global_n - vid_len) + all_inds)
    sample.sort()
    return sample


def _val_window(frame_id: int, vid_len: int, num_frames: int) -> List[int]:
    """``num_frames`` indices centred on ``frame_id``, clamped to the video."""
    start, end = frame_id - num_frames // 2, frame_id + (num_frames + 1) // 2
    return sorted(min(max(i, 0), vid_len - 1) for i in range(start, end))


class A2DSentencesDataset:
    """Samples are (text, video_id, frame_idx, instance_id), one annotated
    frame each; the train split resamples (another index, the dataset's
    ``rng``) a clip whose object is not in the annotated frame after the
    transforms, at most 64 times."""

    def __init__(self, dataset_path: str, ann_file: str, transforms=None,
                 num_frames: int = 5, subset: str = "train",
                 rng: Optional[random.Random] = None):
        self.mask_annotations_dir = os.path.join(
            dataset_path, "text_annotations/a2d_annotation_with_instances")
        self.videos_dir = os.path.join(dataset_path, "Release/clips320H")
        with open(ann_file) as fh:
            self.text_annotations = [tuple(a) for a in json.load(fh)]
        self._transforms = transforms
        self.num_frames = num_frames
        self.subset = subset
        self.rng = rng or random.Random()

    def __len__(self):
        return len(self.text_annotations)

    def __getitem__(self, idx: int):
        h5py = _require("h5py", "h5py")
        for _ in range(64):
            text_query, video_id, frame_idx, instance_id = self.text_annotations[idx]
            text_query = " ".join(text_query.lower().split())
            video = read_video_cv2(os.path.join(self.videos_dir, f"{video_id}.mp4"))
            vid_len = len(video)
            frame_id = frame_idx - 1  # a2d is 1-indexed

            if self.subset == "train":
                sample_indx = _train_window(frame_id, vid_len, self.num_frames, self.rng)
            else:
                sample_indx = _val_window(frame_id, vid_len, self.num_frames)
            valid_indices = sample_indx.index(frame_id)

            imgs = [video[i].astype(np.float32) / 255.0 for i in sample_indx]

            with h5py.File(os.path.join(self.mask_annotations_dir, video_id,
                                        f"{frame_idx:05d}.h5"), "r") as f:
                instances = list(f["instance"])
                instance_idx = instances.index(instance_id)
                instance_masks = np.array(f["reMask"])
                if len(instances) == 1:
                    instance_masks = instance_masks[np.newaxis]
                instance_masks = instance_masks.transpose(0, 2, 1)

            mask = instance_masks[instance_idx].astype(np.float32)
            if (mask > 0).any():
                y1, y2, x1, x2 = mask_to_box(mask)
                box, valid = [x1, y1, x2, y2], [1]
            else:
                box, valid = [0, 0, 0, 0], [0]

            h, w = mask.shape
            target = {
                "frames_idx": np.asarray(sample_indx, np.int64),
                "valid_indices": np.asarray([valid_indices], np.int64),
                "labels": np.zeros((1,), np.int64),
                "boxes": np.asarray([box], np.float32),
                "masks": mask[None],
                "valid": np.asarray(valid, np.int64),
                "caption": text_query,
                "orig_size": np.asarray([h, w], np.int64),
                "size": np.asarray([h, w], np.int64),
                "image_id": f"v_{video_id}_f_{frame_idx}_i_{instance_id}",
            }
            if self.subset != "train":
                # untransformed GT for eval: scored at the ORIGINAL resolution
                # (reference engine.py:332-345), while target['masks'] goes
                # through the val resize
                target["orig_masks"] = mask[None].copy()
            if self._transforms is not None:
                imgs, target = self._transforms(imgs, target)
            if np.any(target["valid"] == 1) or self.subset == "val":
                return np.stack(imgs), target
            idx = self.rng.randint(0, len(self) - 1)
        raise RuntimeError("could not sample a valid A2D clip")


class JHMDBSentencesDataset:
    """Eval-only (reference datasets/jhmdb.py): samples are
    (text, video_id, chosen_frame_path, video_masks_path, frame_count);
    window centred like A2D val; masks from puppet_mask.mat."""

    def __init__(self, dataset_path: str, ann_file: str, transforms=None,
                 num_frames: int = 5):
        with open(ann_file) as fh:
            self.samples = [tuple(a) for a in json.load(fh)]
        self.dataset_path = dataset_path
        self._transforms = transforms
        self.num_frames = num_frames

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int):
        from PIL import Image
        from scipy.io import loadmat

        text_query, video_id, chosen_frame_path, video_masks_path, video_total_frames = (
            self.samples[idx]
        )
        text_query = " ".join(text_query.lower().split())
        chosen_frame_idx = int(chosen_frame_path.split("/")[-1].split(".")[0])
        sample_indx = _val_window(chosen_frame_idx, int(video_total_frames) + 1,
                                  self.num_frames)
        sample_indx = [max(i, 1) for i in sample_indx]  # jhmdb frames are 1-based
        valid_indices = sample_indx.index(chosen_frame_idx)

        frame_dir = os.path.dirname(os.path.join(self.dataset_path, chosen_frame_path))
        imgs = []
        for i in sample_indx:
            p = os.path.join(frame_dir, f"{i:05d}.png")
            imgs.append(np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0)

        all_masks = loadmat(os.path.join(self.dataset_path, video_masks_path))[
            "part_mask"
        ].transpose(2, 0, 1)
        mask = all_masks[chosen_frame_idx - 1].astype(np.float32)
        y1, y2, x1, x2 = mask_to_box(mask) if (mask > 0).any() else (0, 0, 0, 0)
        h, w = mask.shape
        target = {
            "frames_idx": np.asarray(sample_indx, np.int64),
            "valid_indices": np.asarray([valid_indices], np.int64),
            "labels": np.zeros((1,), np.int64),
            "boxes": np.asarray([[x1, y1, x2, y2]], np.float32),
            "masks": mask[None],
            "valid": np.asarray([1], np.int64),
            "caption": text_query,
            "orig_size": np.asarray([h, w], np.int64),
            "size": np.asarray([h, w], np.int64),
            "image_id": f"v_{video_id}_f_{chosen_frame_idx}",
            "orig_masks": mask[None].copy(),  # untransformed GT for eval
        }
        if self._transforms is not None:
            imgs, target = self._transforms(imgs, target)
        return np.stack(imgs), target


def build_a2d(image_set: str, data_cfg, model_cfg, transforms=None):
    """``<a2d_path>``'s single-frame train or test annotations with the
    train or val transform."""
    from tce_rvos_tpu_torch.data.transforms import make_train_transform, make_val_transform

    root = data_cfg.a2d_path
    ann = {
        "train": os.path.join(root, "a2d_sentences_single_frame_train_annotations.json"),
        "val": os.path.join(root, "a2d_sentences_single_frame_test_annotations.json"),
    }[image_set]
    tf = transforms or (make_train_transform(data_cfg.max_size) if image_set == "train"
                        else make_val_transform())
    return A2DSentencesDataset(root, ann, tf, num_frames=model_cfg.num_frames, subset=image_set)


def build_jhmdb(image_set: str, data_cfg, model_cfg, transforms=None):
    """``<jhmdb_path>/jhmdb_sentences_samples_metadata.json`` with the val
    transform, for every ``image_set`` (JHMDB-Sentences is evaluation only)."""
    from tce_rvos_tpu_torch.data.transforms import make_val_transform

    root = data_cfg.jhmdb_path
    ann = os.path.join(root, "jhmdb_sentences_samples_metadata.json")
    return JHMDBSentencesDataset(root, ann, transforms or make_val_transform(),
                                 num_frames=model_cfg.num_frames)
