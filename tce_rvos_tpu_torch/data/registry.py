"""Dataset registry and batch collation (the port's copy of
``tce_rvos_tpu/data/registry.py``).

``build_dataset`` dispatches over the dataset names of the reference's
datasets/__init__.py:24-43. The port builds ``ytvos`` and ``davis``; the
other names (a2d, jhmdb, mevis, refcoco(+/g), joint) raise ``ValueError``
naming them as not ported yet. VidSTG: the reference ships only an
unfinished stub (datasets/vidstg.py:108-126), so the name raises
``NotImplementedError``, as in the JAX package.

``collate_batch`` replaces the reference's NestedTensor collate with padded
numpy arrays and a pad mask (size_divisibility=32, optional H/W buckets),
tokenizing the captions with the port's ``tokenize``. The keys that only
the unported datasets' targets carry (``valid_indices``, ``image_ids``,
``orig_masks``) come with those datasets.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tce_rvos_tpu_torch.utils.nested import batch_videos

NOT_PORTED = ("a2d", "jhmdb", "mevis", "refcoco", "refcoco+", "refcocog", "joint")


class ConcatDataset:
    """reference datasets/concat_dataset.py semantics."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1]) if len(self.datasets) else 0

    def __getitem__(self, idx):
        d = int(np.searchsorted(self.offsets, idx, side="right"))
        prev = 0 if d == 0 else int(self.offsets[d - 1])
        return self.datasets[d][idx - prev]


def build_dataset(name: str, image_set: str, data_cfg, model_cfg):
    from tce_rvos_tpu_torch.data.ytvos import build_davis, build_ytvos

    if name == "ytvos":
        return build_ytvos(image_set, data_cfg, model_cfg)
    if name == "davis":
        return build_davis(image_set, data_cfg, model_cfg)
    if name in NOT_PORTED:
        raise ValueError(f"dataset {name!r} is not ported to the PyTorch port yet "
                         "(ytvos and davis are)")
    if name == "vidstg":
        raise NotImplementedError(
            "VidSTG: the reference ships an unfinished stub "
            "(datasets/vidstg.py:108-126); not supported"
        )
    raise ValueError(f"unknown dataset {name}")


def collate_batch(
    samples: List[Tuple[np.ndarray, Dict]],
    size_divisibility: int = 32,
    hw_buckets: Optional[Sequence[int]] = None,
) -> Dict:
    """List of (clip [T,H,W,3], target) -> model-input dict of padded numpy
    arrays + stacked targets (masks padded to the video's padded size so the
    criterion's strided downsample lines up)."""
    from tce_rvos_tpu_torch.models.text_encoder import tokenize

    clips = [s[0] for s in samples]
    targets = [s[1] for s in samples]
    batch = batch_videos(clips, size_divisibility, hw_buckets)
    b, t, hp, wp = batch.mask.shape

    masks = np.zeros((b, t, hp, wp), np.float32)
    for i, tgt in enumerate(targets):
        m = tgt["masks"]
        masks[i, : m.shape[0], : m.shape[1], : m.shape[2]] = m

    captions = [t_["caption"] for t_ in targets]
    text_ids, text_attn = tokenize(captions)

    out = {
        "video": batch.data.astype(np.float32),
        "video_mask": batch.mask,
        "text_ids": text_ids,
        "text_attn_mask": text_attn,
        "sizes": np.stack([t_["size"] for t_ in targets]).astype(np.int32),
        "targets": {
            "labels": np.stack([t_["labels"] for t_ in targets]).astype(np.int32),
            "boxes": np.stack([t_["boxes"] for t_ in targets]).astype(np.float32),
            "masks": masks,
            "valid": np.stack([t_["valid"] for t_ in targets]).astype(np.int32),
        },
    }
    if "orig_size" in targets[0]:
        out["orig_sizes"] = np.stack([t_["orig_size"] for t_ in targets]).astype(np.int32)
    return out
