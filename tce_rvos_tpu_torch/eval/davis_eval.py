"""DAVIS J&F evaluation (the port's copy of ``tce_rvos_tpu/eval/davis_eval.py``).

The official davis2017 evaluator's semantics: region similarity J
(Jaccard), the boundary F-measure with a dilated one-pixel boundary match
(metrics.py:6-120), per-sequence mean/recall/decay statistics
(utils.py:135-160), and the *unsupervised* protocol that Hungarian-matches
predicted proposals to ground-truth objects by mean (J+F)/2
(evaluation.py:44-64).

Numpy, scipy and PIL only (no skimage, no cv2). The boundary match
counts the boundary pixels of one mask that lie within the disk of radius r (x^2 + y^2 <= r^2, skimage's ``disk``)
of a boundary pixel of the other: the sum that the reference takes of one
boundary map times the other dilated by the disk (cv2.dilate), computed
with a k-d tree over the boundary pixels (scipy.spatial): a dilation
(``scipy.ndimage.binary_dilation``) visits every pixel of the frame for
every disk offset, several times a frame, where the tree visits the
boundary pixels only. The boundary map runs in C where the port's native
library is built (``native/``), else in numpy. The file walking is
isolated in ``DavisDataset`` and ``read_result_masks`` so the metric core
is testable on arrays.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from tce_rvos_tpu_torch import native


def _within(points: np.ndarray, others: np.ndarray, radius: int) -> int:
    """How many of the pixels ``points`` [n, 2] have a pixel of ``others``
    in the disk of ``radius`` around them: ``(a * dilate(b, disk)).sum()``
    for the masks a and b of those pixels."""
    if not len(points) or not len(others):
        return 0
    from scipy.spatial import cKDTree

    dist, _ = cKDTree(others).query(points, k=1, distance_upper_bound=radius + 0.5)
    # integer offsets: the squared distance is an integer, compared with margin
    return int((dist * dist <= radius * radius + 0.5).sum())


def seg2bmap(seg: np.ndarray) -> np.ndarray:
    """One-pixel-wide boundary map (Martin-style, same-size fast path of
    davis2017 metrics._seg2bmap), in C where the port's native library is
    built (``utils/rle.py``'s ``USE_NATIVE``)."""
    from tce_rvos_tpu_torch.utils import rle

    if rle._native():
        return native.seg2bmap(seg)
    seg = seg.astype(bool)
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]
    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = False
    return b


def db_eval_iou(
    annotation: np.ndarray, segmentation: np.ndarray,
    void_pixels: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Jaccard over the trailing 2 axes; empty-vs-empty counts as 1."""
    annotation = annotation.astype(bool)
    segmentation = segmentation.astype(bool)
    if void_pixels is None:
        void = np.zeros_like(segmentation)
    else:
        void = void_pixels.astype(bool)
    inters = np.sum((segmentation & annotation) & ~void, axis=(-2, -1))
    union = np.sum((segmentation | annotation) & ~void, axis=(-2, -1))
    with np.errstate(divide="ignore", invalid="ignore"):
        j = inters / union
    if j.ndim == 0:
        return np.array(1.0) if np.isclose(union, 0) else j
    j[np.isclose(union, 0)] = 1.0
    return j


def f_measure(
    foreground_mask: np.ndarray, gt_mask: np.ndarray,
    void_pixels: Optional[np.ndarray] = None, bound_th: float = 0.008,
) -> float:
    if void_pixels is None:
        void = np.zeros_like(foreground_mask, dtype=bool)
    else:
        void = void_pixels.astype(bool)
    bound_pix = (
        bound_th if bound_th >= 1
        else np.ceil(bound_th * np.linalg.norm(foreground_mask.shape))
    )
    fg_boundary = seg2bmap(foreground_mask * ~void)
    gt_boundary = seg2bmap(gt_mask * ~void)

    # the boundary pixels of each map within the other's disk-dilated map
    # (the disk is symmetric: q in dilate(b) iff b has a pixel within it)
    radius = int(bound_pix)
    fg_pts, gt_pts = np.argwhere(fg_boundary), np.argwhere(gt_boundary)
    gt_match = _within(gt_pts, fg_pts, radius)
    fg_match = _within(fg_pts, gt_pts, radius)
    n_fg = len(fg_pts)
    n_gt = len(gt_pts)
    if n_fg == 0 and n_gt > 0:
        precision, recall = 1.0, 0.0
    elif n_fg > 0 and n_gt == 0:
        precision, recall = 0.0, 1.0
    elif n_fg == 0 and n_gt == 0:
        precision, recall = 1.0, 1.0
    else:
        precision = fg_match / float(n_fg)
        recall = gt_match / float(n_gt)
    if precision + recall == 0:
        return 0.0
    return 2.0 * precision * recall / (precision + recall)


def db_eval_boundary(
    annotation: np.ndarray, segmentation: np.ndarray,
    void_pixels: Optional[np.ndarray] = None, bound_th: float = 0.008,
) -> np.ndarray:
    if annotation.ndim == 3:
        return np.array(
            [
                f_measure(
                    segmentation[i], annotation[i],
                    None if void_pixels is None else void_pixels[i],
                    bound_th,
                )
                for i in range(annotation.shape[0])
            ]
        )
    return np.array(f_measure(segmentation, annotation, void_pixels, bound_th))


def db_statistics(per_frame_values: np.ndarray) -> Tuple[float, float, float]:
    """(mean, recall@0.5, decay over 4 bins) — utils.py:135-160 semantics."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        m = np.nanmean(per_frame_values)
        o = np.nanmean(per_frame_values > 0.5)
    n_bins = 4
    ids = np.round(np.linspace(1, len(per_frame_values), n_bins + 1) + 1e-10) - 1
    ids = ids.astype(np.uint8)
    d_bins = [per_frame_values[ids[i] : ids[i + 1] + 1] for i in range(n_bins)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        d = np.nanmean(d_bins[0]) - np.nanmean(d_bins[3])
    return float(m), float(o), float(d)


def evaluate_unsupervised(
    all_gt_masks: np.ndarray,    # [n_obj, T, H, W]
    all_res_masks: np.ndarray,   # [n_prop, T, H, W]
    max_n_proposals: int = 20,
) -> Tuple[np.ndarray, np.ndarray]:
    """Hungarian-match proposals to objects by mean (J+F)/2, return matched
    per-frame J and F arrays [n_obj, T] (evaluation.py:44-64)."""
    from scipy.optimize import linear_sum_assignment

    assert all_res_masks.shape[0] <= max_n_proposals
    if all_res_masks.shape[0] < all_gt_masks.shape[0]:
        pad = np.zeros(
            (all_gt_masks.shape[0] - all_res_masks.shape[0], *all_res_masks.shape[1:])
        )
        all_res_masks = np.concatenate([all_res_masks, pad], axis=0)
    n_prop, n_obj = all_res_masks.shape[0], all_gt_masks.shape[0]
    t = all_gt_masks.shape[1]
    j = np.zeros((n_prop, n_obj, t))
    f = np.zeros((n_prop, n_obj, t))
    for ii in range(n_obj):
        for jj in range(n_prop):
            j[jj, ii] = db_eval_iou(all_gt_masks[ii], all_res_masks[jj])
            f[jj, ii] = db_eval_boundary(all_gt_masks[ii], all_res_masks[jj])
    score = (j.mean(axis=2) + f.mean(axis=2)) / 2.0
    row, col = linear_sum_assignment(-score)
    return j[row, col], f[row, col]


# ---------------------------------------------------------------------------
# file-system layer
# ---------------------------------------------------------------------------


def read_palette_png(path: str) -> np.ndarray:
    from PIL import Image

    return np.array(Image.open(path))


class DavisDataset:
    """Minimal DAVIS-layout reader (ImageSets/2017/<subset>.txt +
    Annotations_unsupervised/480p/<seq>/*.png)."""

    def __init__(self, root: str, subset: str = "val", task: str = "unsupervised"):
        self.root = root
        anno_dir = (
            "Annotations_unsupervised" if task == "unsupervised" else "Annotations"
        )
        self.mask_dir = os.path.join(root, anno_dir, "480p")
        with open(os.path.join(root, "ImageSets", "2017", subset + ".txt")) as fh:
            self.sequences = [s.strip() for s in fh if s.strip()]

    def get_all_masks(self, seq: str):
        files = sorted(
            f for f in os.listdir(os.path.join(self.mask_dir, seq)) if f.endswith(".png")
        )
        ids = [os.path.splitext(f)[0] for f in files]
        masks = np.stack(
            [read_palette_png(os.path.join(self.mask_dir, seq, f)) for f in files]
        )
        masks[masks == 255] = 0  # void label
        num_objects = int(masks.max())
        per_obj = np.stack([(masks == i + 1) for i in range(num_objects)])
        return per_obj, ids  # [n_obj, T, H, W], frame ids


def read_result_masks(results_root: str, seq: str, mask_ids: List[str]) -> np.ndarray:
    first = read_palette_png(os.path.join(results_root, seq, mask_ids[0] + ".png"))
    masks = np.zeros((len(mask_ids), *first.shape))
    for i, mid in enumerate(mask_ids):
        masks[i] = read_palette_png(os.path.join(results_root, seq, mid + ".png"))
    num_objects = int(masks.max())
    return np.stack([(masks == i + 1) for i in range(max(num_objects, 1))]) > 0


def evaluate_davis(
    davis_root: str, results_path: str, subset: str = "val",
    task: str = "unsupervised",
) -> Dict:
    """Full-dataset evaluation; returns the same nested dict as
    DAVISEvaluation.evaluate plus the summary row of eval_davis.py:43-48."""
    dataset = DavisDataset(davis_root, subset, task)
    res = {
        "J": {"M": [], "R": [], "D": [], "M_per_object": {}},
        "F": {"M": [], "R": [], "D": [], "M_per_object": {}},
    }
    for seq in dataset.sequences:
        gt, ids = dataset.get_all_masks(seq)
        if task == "semi-supervised":
            gt, ids = gt[:, 1:-1], ids[1:-1]
        pred = read_result_masks(results_path, seq, ids)
        j, f = evaluate_unsupervised(gt, pred)
        for ii in range(gt.shape[0]):
            name = f"{seq}_{ii + 1}"
            jm, jr, jd = db_statistics(j[ii])
            fm, fr, fd = db_statistics(f[ii])
            res["J"]["M"].append(jm)
            res["J"]["R"].append(jr)
            res["J"]["D"].append(jd)
            res["J"]["M_per_object"][name] = jm
            res["F"]["M"].append(fm)
            res["F"]["R"].append(fr)
            res["F"]["D"].append(fd)
            res["F"]["M_per_object"][name] = fm
    summary = {
        "J&F-Mean": (np.mean(res["J"]["M"]) + np.mean(res["F"]["M"])) / 2.0,
        "J-Mean": np.mean(res["J"]["M"]),
        "J-Recall": np.mean(res["J"]["R"]),
        "J-Decay": np.mean(res["J"]["D"]),
        "F-Mean": np.mean(res["F"]["M"]),
        "F-Recall": np.mean(res["F"]["R"]),
        "F-Decay": np.mean(res["F"]["D"]),
    }
    res["summary"] = summary
    return res
