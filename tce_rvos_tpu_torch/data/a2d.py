"""JHMDB-Sentences dataset and the A2D-Sentences clip windows (the port's
copy of the JHMDB part of ``tce_rvos_tpu/data/a2d.py``).

Parity with reference datasets/jhmdb.py: evaluation only; frames from
Rename_Images (PNG), masks from puppet_mask.mat (scipy.io); a window of
``num_frames`` centred on the annotated frame, edge-padded, whose index in
the window is the target's ``valid_indices`` (the model keeps only that
frame). Numpy, PIL and scipy only.

A2D-Sentences itself (``A2DSentencesDataset``, ``build_a2d``) is not
ported: it decodes Release/clips320H/*.mp4 with cv2 and reads its masks
from .h5 files with h5py, and the card's machine has neither a video
decoder nor h5py. Its window functions are here, with the JAX package's
draws.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from tce_rvos_tpu_torch.data.ytvos import mask_to_box


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


def build_jhmdb(image_set: str, data_cfg, model_cfg, transforms=None):
    """``<jhmdb_path>/jhmdb_sentences_samples_metadata.json`` with the val
    transform, for every ``image_set`` (JHMDB-Sentences is evaluation only)."""
    from tce_rvos_tpu_torch.data.transforms import make_val_transform

    root = data_cfg.jhmdb_path
    ann = os.path.join(root, "jhmdb_sentences_samples_metadata.json")
    return JHMDBSentencesDataset(root, ann, transforms or make_val_transform(),
                                 num_frames=model_cfg.num_frames)
