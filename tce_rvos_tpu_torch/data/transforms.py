"""Clip-level data transforms on the host (the port's copy of
``tce_rvos_tpu/data/transforms.py``), drawing the same ``random.Random``
values in the same order, so one seed gives the JAX package's samples.

Behavioural parity with reference datasets/transforms_video.py: every
transform acts on a whole clip (a list of frames) plus a target dict with
boxes (xyxy, absolute), masks, caption and valid flags. The train pipeline
(ytvos.py:250-284): hflip(0.5) + photometric distort + multi-scale resize
(or resize->crop->resize) + normalize(+cxcywh); val: resize 360 / max 640.

The JAX package resizes and converts colours with cv2; the port does not
use cv2. Frames are resized bilinearly with half-pixel centres and the
source coordinate in float64 (within 2e-7 of cv2's INTER_LINEAR), masks
by cv2's nearest-neighbour index (bitwise equal), and RGB<->HSV follows
cv2's float formulas (H in [0, 360), S and V in [0, 1]). Numpy only.

Notable reference semantics preserved:
  * horizontal flip swaps 'left'<->'right' in the caption
    (transforms_video.py:453-463);
  * Check() marks boxes that collapse after cropping as invalid
    (transforms_video.py:20-45) — implemented here as area>0 validity;
  * resize keeps aspect ratio, short side=size capped so long side<=max_size.

Arrays: frames float32 [H, W, 3] RGB in [0,1] pre-normalize; masks uint8
[H, W]; boxes float32 [N, 4].
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

TRAIN_SCALES = [288, 320, 352, 392, 416, 448, 480, 512]


def _linear_taps(src: int, dst: int):
    """Source pixels and the weight of the second for a bilinear resize
    with half-pixel centres, clamped at the borders: the coordinate
    ``(i + 0.5) * src / dst - 0.5`` in float64, as cv2's INTER_LINEAR takes
    it (in float32, as ``F.interpolate`` takes it on the CPU, it is off by
    up to 6e-5 of a pixel at 1280 pixels, and a frame by up to 1.2e-4)."""
    x = np.clip((np.arange(dst) + 0.5) * (src / dst) - 0.5, 0, src - 1)
    x0 = np.floor(x).astype(np.int64)
    return x0, np.minimum(x0 + 1, src - 1), (x - x0).astype(np.float32)


def _resize_frame(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an ``[H, W, C]`` float32 frame to ``size`` with
    half-pixel centres and no antialiasing (cv2's INTER_LINEAR, within
    2e-7 of it)."""
    h, w = size
    y0, y1, fy = _linear_taps(img.shape[0], h)
    x0, x1, fx = _linear_taps(img.shape[1], w)
    img = np.asarray(img, np.float32)
    fy = fy[:, None, None]
    rows = img[y0] * (1 - fy) + img[y1] * fy
    fx = fx[None, :, None]
    return rows[:, x0] * (1 - fx) + rows[:, x1] * fx


def _nearest_index(src: int, dst: int) -> np.ndarray:
    """cv2's INTER_NEAREST source index: ``floor(i / (dst / src))``,
    clamped to the last source pixel."""
    inv = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * inv).astype(np.int64), src - 1)


def _resize_mask(mask: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Nearest resize of an ``[H, W]`` mask to ``size``, as uint8."""
    h, w = size
    m = mask.astype(np.uint8)
    return m[_nearest_index(m.shape[0], h)[:, None], _nearest_index(m.shape[1], w)[None, :]]


_FLT_EPSILON = np.float32(np.finfo(np.float32).eps)
# HSV sector -> which of (v, p, q, t) are r, g and b (cv2's HSV2RGB table)
_SECTOR_RGB = np.array([[0, 3, 1], [2, 0, 1], [1, 0, 3], [1, 2, 0], [3, 1, 0], [0, 1, 2]])


def rgb_to_hsv(x: np.ndarray) -> np.ndarray:
    """Float RGB ``[..., 3]`` to HSV with cv2's float convention and formula
    (COLOR_RGB2HSV): H in [0, 360) degrees, S and V in [0, 1]."""
    r, g, b = (x[..., i] for i in range(3))
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + _FLT_EPSILON)
    k = np.float32(60.0) / (diff + _FLT_EPSILON)
    h = np.where(v == r, (g - b) * k,
                 np.where(v == g, (b - r) * k + np.float32(120.0),
                          (r - g) * k + np.float32(240.0)))
    h = np.where(h < 0, h + np.float32(360.0), h)
    return np.stack([h, s, v], -1).astype(np.float32)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """The inverse of ``rgb_to_hsv`` with cv2's formula (COLOR_HSV2RGB): H
    wraps into [0, 360), S is not clipped."""
    h, s, v = (hsv[..., i] for i in range(3))
    h = h * np.float32(6.0 / 360.0)
    h = np.where(h < 0, h + np.float32(6.0), np.where(h >= 6, h - np.float32(6.0), h))
    sector = np.floor(h)
    h = h - sector
    sector = sector.astype(np.int64)
    out_of_range = (sector < 0) | (sector >= 6)
    sector = np.where(out_of_range, 0, sector)
    h = np.where(out_of_range, np.float32(0.0), h)
    one = np.float32(1.0)
    tab = np.stack([v, v * (one - s), v * (one - s * h), v * (one - s * (one - h))])
    idx = np.moveaxis(_SECTOR_RGB[sector], -1, 0)    # [3, ...]: which row of tab
    return np.moveaxis(np.take_along_axis(tab, idx, 0), 0, -1).astype(np.float32)


def get_size_with_aspect_ratio(
    image_size: Tuple[int, int], size: int, max_size: Optional[int] = None
) -> Tuple[int, int]:
    """(h, w) -> target (h, w); torchvision/DETR convention
    (transforms_video.py RandomResize internals)."""
    h, w = image_size
    if max_size is not None:
        min_original = float(min(h, w))
        max_original = float(max(h, w))
        if max_original / min_original * size > max_size:
            size = int(round(max_size * min_original / max_original))
    if (h <= w and h == size) or (w <= h and w == size):
        return h, w
    if h < w:
        oh = size
        ow = int(size * w / h)
    else:
        ow = size
        oh = int(size * h / w)
    return oh, ow


class ClipTransform:
    def __call__(self, frames: List[np.ndarray], target: Dict) -> Tuple[List[np.ndarray], Dict]:
        raise NotImplementedError


class Compose(ClipTransform):
    def __init__(self, transforms: Sequence[ClipTransform]):
        self.transforms = list(transforms)

    def __call__(self, frames, target):
        for t in self.transforms:
            frames, target = t(frames, target)
        return frames, target


class RandomHorizontalFlip(ClipTransform):
    def __init__(self, p: float = 0.5, rng: Optional[random.Random] = None):
        self.p = p
        self.rng = rng or random

    def __call__(self, frames, target):
        if self.rng.random() >= self.p:
            return frames, target
        w = frames[0].shape[1]
        frames = [np.ascontiguousarray(f[:, ::-1]) for f in frames]
        if "masks" in target:
            target["masks"] = np.ascontiguousarray(target["masks"][..., ::-1])
        if "boxes" in target and len(target["boxes"]):
            b = target["boxes"].copy()
            b[:, [0, 2]] = w - b[:, [2, 0]]
            target["boxes"] = b
        if "caption" in target:
            # the reference swaps 'left'/'right' words on flip
            cap = target["caption"].replace("left", "@").replace("right", "left")
            target["caption"] = cap.replace("@", "right")
        return frames, target


class RandomResize(ClipTransform):
    def __init__(self, sizes: Sequence[int], max_size: Optional[int] = None,
                 rng: Optional[random.Random] = None):
        self.sizes = list(sizes)
        self.max_size = max_size
        self.rng = rng or random

    def __call__(self, frames, target):
        size = self.rng.choice(self.sizes)
        h, w = frames[0].shape[:2]
        oh, ow = get_size_with_aspect_ratio((h, w), size, self.max_size)
        frames = [_resize_frame(f, (oh, ow)) for f in frames]
        ratio_h, ratio_w = oh / h, ow / w
        if "boxes" in target and len(target["boxes"]):
            b = target["boxes"] * np.array([ratio_w, ratio_h, ratio_w, ratio_h], np.float32)
            target["boxes"] = b
        if "masks" in target:
            target["masks"] = np.stack(
                [_resize_mask(m, (oh, ow)) for m in target["masks"]]
            )
        target["size"] = np.array([oh, ow], np.int64)
        return frames, target


class RandomSizeCrop(ClipTransform):
    def __init__(self, min_size: int, max_size: int, rng: Optional[random.Random] = None):
        self.min_size = min_size
        self.max_size = max_size
        self.rng = rng or random

    def __call__(self, frames, target):
        h, w = frames[0].shape[:2]
        tw = self.rng.randint(self.min_size, min(w, self.max_size))
        th = self.rng.randint(self.min_size, min(h, self.max_size))
        i = self.rng.randint(0, h - th) if h > th else 0
        j = self.rng.randint(0, w - tw) if w > tw else 0
        frames = [f[i : i + th, j : j + tw] for f in frames]
        if "boxes" in target and len(target["boxes"]):
            b = target["boxes"] - np.array([j, i, j, i], np.float32)
            b[:, 0::2] = b[:, 0::2].clip(0, tw)
            b[:, 1::2] = b[:, 1::2].clip(0, th)
            target["boxes"] = b
            # Check() semantics: a box that collapsed is invalid
            areas = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
            if "valid" in target:
                target["valid"] = (target["valid"].astype(bool) & (areas > 0)).astype(
                    target["valid"].dtype
                )
        if "masks" in target:
            target["masks"] = target["masks"][..., i : i + th, j : j + tw]
        target["size"] = np.array([th, tw], np.int64)
        return frames, target


_LIGHTING_PERMS = (
    (0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)
)


class PhotometricDistort(ClipTransform):
    """Per-frame brightness/contrast/saturation/hue jitter + channel-swap
    lighting noise, matching the reference's stochastic structure
    (transforms_video.py:396-421): every parameter is drawn FRESH for each
    frame, each sub-op fires with independent p=0.5, one of the two contrast
    ops (before vs after the HSV block) is chosen at random per frame, and
    RandomLightingNoise applies a random channel permutation.

    Deliberate deviations from the reference (documented, not silent):
      * we operate on float RGB in [0, 1] end to end — the reference
        round-trips through uint8 (``astype('uint8')``), whose numpy cast
        WRAPS out-of-range values modulo 256 (a defect, not a feature);
        we clip instead;
      * the reference converts with cv2.COLOR_BGR2HSV while its arrays are
        actually RGB (PIL order), silently computing hue on swapped
        channels; we use the correct RGB<->HSV conversion.
    """

    def __init__(self, rng: Optional[random.Random] = None):
        self.rng = rng or random

    def _distort_frame(self, x: np.ndarray) -> np.ndarray:
        r = self.rng
        # RandomBrightness (delta scaled from the reference's 0..255 range)
        if r.random() < 0.5:
            x = x + r.uniform(-32.0 / 255, 32.0 / 255)
        contrast_first = r.random() < 0.5
        if contrast_first and r.random() < 0.5:
            x = x * r.uniform(0.5, 1.5)
        hsv = rgb_to_hsv(x.clip(0.0, 1.0))
        if r.random() < 0.5:  # RandomSaturation
            hsv[..., 1] *= r.uniform(0.5, 1.5)
        if r.random() < 0.5:  # RandomHue
            hsv[..., 0] = (hsv[..., 0] + r.uniform(-18.0, 18.0)) % 360.0
        x = hsv_to_rgb(hsv)
        if (not contrast_first) and r.random() < 0.5:
            x = x * r.uniform(0.5, 1.5)
        if r.random() < 0.5:  # RandomLightingNoise
            swap = _LIGHTING_PERMS[r.randrange(len(_LIGHTING_PERMS))]
            x = x[:, :, swap]
        return x.clip(0.0, 1.0)

    def __call__(self, frames, target):
        return [self._distort_frame(f.astype(np.float32)) for f in frames], target


class Normalize(ClipTransform):
    """ImageNet-normalize frames; convert boxes xyxy(abs) -> cxcywh(norm)
    (transforms_video.py:529-547)."""

    def __call__(self, frames, target):
        frames = [(f - IMAGENET_MEAN) / IMAGENET_STD for f in frames]
        h, w = frames[0].shape[:2]
        if "boxes" in target and len(target["boxes"]):
            b = target["boxes"].astype(np.float32)
            cx = (b[:, 0] + b[:, 2]) / 2 / w
            cy = (b[:, 1] + b[:, 3]) / 2 / h
            bw = (b[:, 2] - b[:, 0]) / w
            bh = (b[:, 3] - b[:, 1]) / h
            target["boxes"] = np.stack([cx, cy, bw, bh], axis=1)
        return frames, target


def make_train_transform(max_size: int = 640, rng: Optional[random.Random] = None):
    """Parity with the reference train pipeline (ytvos.py:250-284)."""
    rng = rng or random
    multi = RandomResize(TRAIN_SCALES, max_size=max_size, rng=rng)
    crop_path = Compose([
        RandomResize([400, 500, 600], rng=rng),
        RandomSizeCrop(384, 600, rng=rng),
        RandomResize(TRAIN_SCALES, max_size=max_size, rng=rng),
    ])

    class _Select(ClipTransform):
        def __call__(self, frames, target):
            if rng.random() < 0.5:
                return multi(frames, target)
            return crop_path(frames, target)

    return Compose([
        RandomHorizontalFlip(0.5, rng=rng),
        PhotometricDistort(rng=rng),
        _Select(),
        Normalize(),
    ])


def make_val_transform(size: int = 360, max_size: int = 640):
    """Reference val pipeline: T.RandomResize([360], max_size=640) +
    normalize. A single size makes RandomResize deterministic, and —
    unlike a frames-only resize — it rescales the BOXES with the frames,
    so Normalize's abs->cxcywh conversion sees coordinates at the resized
    resolution."""
    return Compose([RandomResize([size], max_size=max_size), Normalize()])
