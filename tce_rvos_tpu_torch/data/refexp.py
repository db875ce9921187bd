"""RefCOCO/+/g datasets for joint pretraining (the port's copy of
``tce_rvos_tpu/data/refexp.py``): the same samples for the same
``random.Random``.

Parity with reference datasets/refexp.py (single-image "1-frame clips") and
datasets/refexp2seq.py (pseudo-video clips made from one COCO image by a
random perspective and affine jitter and a frame shuffle,
refexp2seq.py:31-67). Expects COCO-format json (tools/convert_refexp_to_coco
of the JAX package) with the caption in image['caption'].

The JAX package rasterises polygons and warps frames with cv2; the port
does not use cv2 (the card's machine has none) and computes the same
functions in numpy:

  * ``fill_poly``: cv2.fillPoly (8-connected, no shift) on int vertices,
    bitwise: every edge drawn as cv2's clipped Bresenham line, then the
    even-odd scanline fill of cv2's fixed-point (16-bit) edge walk, whose
    edges that cross the border start from the clipped line's integer end
    points;
  * ``perspective_transform`` / ``rotation_matrix_2d``:
    cv2.getPerspectiveTransform (the 8x8 system in float64, its products of
    coordinates in float32) and cv2.getRotationMatrix2D (closed form);
  * ``warp_perspective``: cv2.warpPerspective with a constant 0 border,
    bilinear on float frames and nearest on masks. cv2 inverts the matrix
    in float64 and maps every destination pixel through its float32 copy,
    each row as fused multiply-adds (``fma(m0, x, m1 y + m2)`` over the
    16-pixel vector blocks, ``fma(m0, x, m1 y) + m2`` in the scalar tail
    past the last whole block), then divides by w; bilinear taps take
    fused lerps of the four neighbours (0 outside the frame), nearest takes
    the source pixel at the coordinates rounded half to even. With the fused
    multiply-adds emulated in float64 the frames come out within one float32
    rounding of cv2's and the masks bitwise equal.
"""

from __future__ import annotations

import json
import os
import random
from typing import Optional, Sequence, Tuple

import numpy as np

XY_SHIFT = 16  # cv2's fixed-point fraction bits of the polygon edge walk


def _tdiv(a: int, b: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2::clipLine on a ``w`` x ``h`` image: (inside, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _inside(w: int, h: int, *pts: Tuple[int, int]) -> bool:
    return all(0 <= x < w and 0 <= y < h for x, y in pts)


def _draw_line(img: np.ndarray, x1: int, y1: int, x2: int, y2: int) -> None:
    """cv2's 8-connected line (LineIterator, left to right), clipped."""
    h, w = img.shape
    if not _inside(w, h, (x1, y1), (x2, y2)):
        ok, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not ok:
            return
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, abs(y2 - y1)
    sy = 1 if y2 >= y1 else -1
    # Bresenham's error term steps the minor axis at step k of the major
    # one ceil((2 k minor + major) / (2 major)) - 1 times
    if dy > dx:
        k = np.arange(dy + 1)
        xs, ys = x1 + (2 * dx * k + dy - 1) // (2 * dy), y1 + sy * k
    else:
        k = np.arange(dx + 1)
        minor = (2 * dy * k + dx - 1) // (2 * dx) if dx else np.zeros_like(k)
        xs, ys = x1 + k, y1 + sy * minor
    img[ys, xs] = 1


def fill_poly(img: np.ndarray, pts: np.ndarray) -> None:
    """``cv2.fillPoly(img, [pts], 1)`` for one polygon of int vertices
    ``[n, 2]`` (x, y) on a 2-D uint8 ``img``, in place."""
    h, w = img.shape
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    edges = []  # (y0, y1, x at y0 in fixed point, dx per row)
    p0 = pts[-1]
    for p1 in pts:
        _draw_line(img, *p0, *p1)
        (ax, ay), (bx, by) = (p0[0] << XY_SHIFT, p0[1]), (p1[0] << XY_SHIFT, p1[1])
        if not _inside(w, h, p0, p1):
            # the edge walks from the clipped line's end points
            _, cx0, cy0, cx1, cy1 = _clip_line(w, h, *p0, *p1)
            if cy0 != cy1:
                ay, by = cy0, cy1
            ax, bx = cx0 << XY_SHIFT, cx1 << XY_SHIFT
        if p0[1] != p1[1]:
            dx = _tdiv(bx - ax, by - ay)
            if p0[1] < p1[1]:
                edges.append((p0[1], p1[1], ax + (p0[1] - ay) * dx, dx))
            else:
                edges.append((p1[1], p0[1], bx + (p1[1] - by) * dx, dx))
        p0 = p1
    if len(edges) < 2:
        return
    ends = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    y_min, y_max = min(e[0] for e in edges), max(e[1] for e in edges)
    if y_max < 0 or y_min >= h or max(ends) < 0 or min(ends) >= (w << XY_SHIFT):
        return
    for y in range(max(y_min, 0), min(y_max, h)):
        xs = sorted(e[2] + (y - e[0]) * e[3] for e in edges if e[0] <= y < e[1])
        for a, b in zip(xs[0::2], xs[1::2]):   # even-odd spans, pixels a <= x <= b
            x1, x2 = -((-a) >> XY_SHIFT), b >> XY_SHIFT
            if x1 < w and x2 >= 0:
                img[y, max(x1, 0): min(x2, w - 1) + 1] = 1


def poly_to_mask(segmentation, h: int, w: int) -> np.ndarray:
    """COCO polygon(s) / RLE -> binary float32 mask; each polygon's vertices
    rounded to int and filled as cv2.fillPoly fills them."""
    from tce_rvos_tpu_torch.utils import rle as rle_util

    if isinstance(segmentation, dict):
        if isinstance(segmentation["counts"], list):
            return rle_util.decode_counts(segmentation["counts"], h, w).astype(np.float32)
        return rle_util.decode(segmentation).astype(np.float32)
    mask = np.zeros((h, w), np.uint8)
    for poly in segmentation:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        fill_poly(mask, np.round(pts).astype(np.int32))
    return mask.astype(np.float32)


def perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """cv2.getPerspectiveTransform of 4 float32 point pairs -> float64 3x3."""
    src = np.asarray(src, np.float32)
    dst = np.asarray(dst, np.float32)
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        (sx, sy), (dx, dy) = src[i], dst[i]
        a[i, :3] = a[i + 4, 3:6] = (sx, sy, 1.0)
        a[i, 6:] = (-sx * dx, -sy * dx)           # float32 products, as cv2 forms them
        a[i + 4, 6:] = (-sx * dy, -sy * dy)
        b[i], b[i + 4] = dx, dy
    return np.append(np.linalg.solve(a, b), 1.0).reshape(3, 3)


def rotation_matrix_2d(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D (angle in degrees, centre as float32) -> 2x3."""
    cx, cy = (float(np.float32(c)) for c in center)
    angle = angle * np.pi / 180
    alpha, beta = np.cos(angle) * scale, np.sin(angle) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once (through float64)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _source_coords(m: np.ndarray, h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """The float32 source (x, y) of every destination pixel of
    cv2.warpPerspective(., m, (w, h))."""
    inv = np.linalg.inv(np.asarray(m, np.float64)).astype(np.float32)
    y, x = (a.astype(np.float32) for a in np.mgrid[0:h, 0:w])
    vector = (np.arange(w) < w // 16 * 16)[None, :]
    xyw = [np.where(vector, _fma(r[0], x, r[1] * y + r[2]), _fma(r[0], x, r[1] * y) + r[2])
           for r in inv]
    return xyw[0] / xyw[2], xyw[1] / xyw[2]


def _taps(src: np.ndarray, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """src[ys, xs] with 0 outside the frame."""
    h, w = src.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    out = np.zeros(xs.shape + src.shape[2:], src.dtype)
    out[ok] = src[ys[ok], xs[ok]]
    return out


def warp_perspective(src: np.ndarray, m: np.ndarray, nearest: bool = False) -> np.ndarray:
    """cv2.warpPerspective(src, m, (w, h)) with a constant 0 border:
    INTER_LINEAR on a float32 [H, W, C] frame, INTER_NEAREST (``nearest``)
    on an [H, W] mask of any dtype."""
    h, w = src.shape[:2]
    sx, sy = _source_coords(m, h, w)
    if nearest:
        return _taps(src, np.rint(sx).astype(np.int64), np.rint(sy).astype(np.int64))
    fx, fy = np.floor(sx), np.floor(sy)
    ax, ay = (sx - fx)[..., None], (sy - fy)[..., None]
    x0, y0 = fx.astype(np.int64), fy.astype(np.int64)
    p00, p01 = _taps(src, x0, y0), _taps(src, x0 + 1, y0)
    p10, p11 = _taps(src, x0, y0 + 1), _taps(src, x0 + 1, y0 + 1)
    top = _fma(ax, p01 - p00, p00)
    bottom = _fma(ax, p11 - p10, p10)
    return _fma(ay, bottom - top, top)


class ImageToSeqAugmenter:
    """Pseudo-video jitter (semantics of datasets/image_to_seq_augmenter.py):
    per synthetic frame, a random perspective + affine (rotate/translate)
    warp of the still image and its mask, drawn from ``rng`` in the JAX
    package's order."""

    def __init__(
        self,
        perturb_max: float = 0.02,
        rotation_range: Tuple[float, float] = (-20, 20),
        translate_range: Tuple[float, float] = (-0.1, 0.1),
        rng: Optional[random.Random] = None,
    ):
        self.perturb_max = perturb_max
        self.rotation_range = rotation_range
        self.translate_range = translate_range
        self.rng = rng or random.Random()

    def _warp_matrix(self, h: int, w: int) -> np.ndarray:
        r = self.rng
        # perspective: jitter the 4 corners
        src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
        jit = np.float32(
            [
                [r.uniform(-1, 1) * self.perturb_max * w,
                 r.uniform(-1, 1) * self.perturb_max * h]
                for _ in range(4)
            ]
        )
        persp = perspective_transform(src, src + jit)
        # affine: rotation + translation about the center
        ang = r.uniform(*self.rotation_range) * 0.1
        tx = r.uniform(*self.translate_range) * w * 0.3
        ty = r.uniform(*self.translate_range) * h * 0.3
        aff = rotation_matrix_2d((w / 2, h / 2), ang, 1.0)
        aff[:, 2] += (tx, ty)
        aff3 = np.vstack([aff, [0, 0, 1]]).astype(np.float32)
        return (persp @ aff3).astype(np.float32)

    def __call__(self, image: np.ndarray, mask: np.ndarray):
        h, w = image.shape[:2]
        m = self._warp_matrix(h, w)
        img_w = warp_perspective(np.asarray(image, np.float32), m)
        mask_w = warp_perspective(mask.astype(np.uint8), m, nearest=True)
        return img_w, mask_w.astype(np.float32)


class RefExpDataset:
    """COCO-format referring expressions; returns clips of length
    ``num_frames`` (1 for the plain image dataset; >1 synthesises a
    pseudo-video like refexp2seq)."""

    def __init__(
        self,
        img_folder: str,
        ann_file: str,
        transforms=None,
        num_frames: int = 1,
        f_extra: int = 0,
        rng: Optional[random.Random] = None,
    ):
        self.img_folder = img_folder
        with open(ann_file) as fh:
            coco = json.load(fh)
        self.images = {img["id"]: img for img in coco["images"]}
        self.anns_by_image = {}
        for ann in coco["annotations"]:
            self.anns_by_image.setdefault(ann["image_id"], []).append(ann)
        self.ids = [i for i in self.images if i in self.anns_by_image]
        self._transforms = transforms
        self.num_frames = num_frames
        self.f_extra = f_extra
        self.rng = rng or random.Random()
        self.augmenter = ImageToSeqAugmenter(rng=self.rng)

    def __len__(self):
        return len(self.ids)

    def gt_boxes_by_image(self):
        """image_id -> [n_gt, 4] xyxy, for eval.refexp_eval.RefExpEvaluator
        (reference datasets/refexp_eval.py:49-60 reads them off coco_gt)."""
        out = {}
        for img_id in self.ids:
            boxes = []
            for a in self.anns_by_image[img_id]:
                x, y, w, h = a["bbox"]
                boxes.append([x, y, x + w, y + h])
            out[img_id] = np.asarray(boxes, np.float32)
        return out

    def coco_gt_by_image(self):
        """image_id -> annotation dicts for eval.coco_eval.CocoEvaluator.
        Polygon segmentations are rasterised to RLE so the evaluator can
        score the ``segm`` iou_type (the reference feeds pycocotools the
        raw polygons and it rasterises internally)."""
        from tce_rvos_tpu_torch.utils import rle as rle_util

        out = {}
        for img_id in self.ids:
            info = self.images[img_id]
            h, w = int(info["height"]), int(info["width"])
            anns = []
            for a in self.anns_by_image[img_id]:
                d = {
                    "bbox": a["bbox"],
                    "area": a.get("area", float(a["bbox"][2]) * float(a["bbox"][3])),
                    "iscrowd": a.get("iscrowd", 0),
                }
                if "segmentation" in a:
                    d["segmentation"] = rle_util.encode(
                        poly_to_mask(a["segmentation"], h, w).astype(np.uint8))
                anns.append(d)
            out[img_id] = anns
        return out

    def __getitem__(self, idx: int):
        from PIL import Image

        from tce_rvos_tpu_torch.data.ytvos import clip_target, mask_to_box

        img_id = self.ids[idx]
        info = self.images[img_id]
        anns = self.anns_by_image[img_id]
        caption = " ".join(info.get("caption", "").lower().split())
        path = os.path.join(self.img_folder, info["file_name"])
        img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
        h, w = img.shape[:2]

        ann = anns[0]
        mask = (poly_to_mask(ann["segmentation"], h, w) if "segmentation" in ann
                else np.zeros((h, w), np.float32))
        x, y, bw, bh = ann["bbox"]
        box = [x, y, x + bw, y + bh]

        total = self.num_frames + 2 * self.f_extra
        # the warp+shuffle clip synthesis runs in EVERY split: the
        # reference's refexp2seq.py:62-67 applies its augmenter in
        # __getitem__ with no image_set gate, so val clips are randomly
        # warped there too (a quirk kept for protocol parity)
        frames, masks = [img], [mask]
        for _ in range(total - 1):
            fi, mi = self.augmenter(img, mask)
            frames.append(fi)
            masks.append(mi)
        order = list(range(total))
        if total > 1:
            self.rng.shuffle(order)
        frames = [frames[i] for i in order]
        masks = [masks[i] for i in order]

        boxes, valid = [], []
        for m in masks:
            if (m > 0).any():
                y1, y2, x1, x2 = mask_to_box(m)
                boxes.append([x1, y1, x2, y2])
                valid.append(1)
            else:
                boxes.append(box)
                valid.append(0)

        target = {
            "frames_idx": np.arange(total, dtype=np.int64),
            "labels": np.zeros((total,), np.int64),
            "boxes": np.asarray(boxes, np.float32),
            "masks": np.stack(masks),
            "valid": np.asarray(valid, np.int64),
            "caption": caption,
            "orig_size": np.asarray([h, w], np.int64),
            "size": np.asarray([h, w], np.int64),
            "image_id": img_id,
        }
        if self._transforms is not None:
            frames, target = self._transforms(frames, target)
        return np.stack(frames), clip_target(target, self.f_extra)


REFEXP_NAMES: Sequence[str] = ("refcoco", "refcoco+", "refcocog")


def build_refexp(
    name: str, image_set: str, data_cfg, model_cfg, as_video: bool = True,
    transforms=None,
):
    """``<coco_path>/train2014`` images with
    ``<coco_path>/instances_<name>_<image_set>.json``."""
    from tce_rvos_tpu_torch.data.transforms import make_train_transform, make_val_transform

    if name not in REFEXP_NAMES:
        raise KeyError(name)
    root = data_cfg.coco_path
    tf = transforms or (
        make_train_transform(data_cfg.max_size) if image_set == "train"
        else make_val_transform()
    )
    return RefExpDataset(
        os.path.join(root, "train2014"),
        os.path.join(root, f"instances_{name}_{image_set}.json"),
        tf,
        num_frames=model_cfg.num_frames if as_video else 1,
        f_extra=model_cfg.f_extra if as_video else 0,
    )
