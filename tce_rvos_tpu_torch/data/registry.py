"""Dataset registry and batch collation (the port's copy of
``tce_rvos_tpu/data/registry.py``).

``build_dataset`` dispatches over the dataset names of the reference's
datasets/__init__.py:24-43: ytvos, davis, jhmdb, mevis, refcoco(+/g) and
``joint`` (the three refexp sets plus ytvos unless ``pretrain_coco``, one
``ConcatDataset``) and a2d (which reads its clips with cv2 and its
masks with h5py, imported at the first sample). VidSTG: the reference
ships only an unfinished stub (datasets/vidstg.py:108-126), so the name
raises ``NotImplementedError``, as in the JAX package.

``collate_batch`` replaces the reference's NestedTensor collate with padded
numpy arrays and a pad mask (size_divisibility=32, optional H/W buckets),
tokenizing the captions with the port's ``tokenize``. Evaluation targets
add ``valid_indices`` (JHMDB's annotated frame), ``orig_sizes``,
``image_ids`` and the untransformed ``orig_masks`` (a host-side list), each
when every target of the batch has it (the JAX package asks the first
target only, which fails on a ``joint`` batch that mixes refexp and ytvos
samples).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tce_rvos_tpu_torch.utils.nested import batch_videos

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
    from tce_rvos_tpu_torch.data.a2d import build_a2d, build_jhmdb
    from tce_rvos_tpu_torch.data.mevis import build_mevis
    from tce_rvos_tpu_torch.data.refexp import REFEXP_NAMES, build_refexp
    from tce_rvos_tpu_torch.data.ytvos import build_davis, build_ytvos

    if name == "ytvos":
        return build_ytvos(image_set, data_cfg, model_cfg)
    if name == "davis":
        return build_davis(image_set, data_cfg, model_cfg)
    if name == "a2d":
        return build_a2d(image_set, data_cfg, model_cfg)
    if name == "jhmdb":
        return build_jhmdb(image_set, data_cfg, model_cfg)
    if name == "mevis":
        return build_mevis(image_set, data_cfg, model_cfg)
    if name in REFEXP_NAMES:
        return build_refexp(name, image_set, data_cfg, model_cfg)
    if name == "joint":
        parts = [build_refexp(n, image_set, data_cfg, model_cfg) for n in REFEXP_NAMES]
        if not data_cfg.pretrain_coco:
            parts.append(build_ytvos(image_set, data_cfg, model_cfg))
        return ConcatDataset(parts)
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
    def every(key):  # a ``joint`` batch mixes refexp targets with ytvos ones
        return all(key in t_ for t_ in targets)

    if every("valid_indices"):
        out["valid_indices"] = np.stack(
            [t_["valid_indices"][0] for t_ in targets]).astype(np.int32)
    if every("orig_size"):
        out["orig_sizes"] = np.stack([t_["orig_size"] for t_ in targets]).astype(np.int32)
    if every("image_id"):
        out["image_ids"] = [t_["image_id"] for t_ in targets]
    if every("orig_masks"):
        # host-side ragged list (original resolutions differ per sample);
        # evaluation only, never copied to the device
        out["orig_masks"] = [t_["orig_masks"] for t_ in targets]
    return out
