"""Resizes with torch ``F.interpolate`` semantics (counterpart of
``tce_rvos_tpu/utils/interpolate.py``).

The port works channel-first: every function takes ``[..., C, H, W]`` or,
for masks, ``[..., H, W]``, and resizes the last two axes.

  * ``resize_nearest``: torch's legacy ``mode='nearest'``, src = floor(dst *
    in / out);
  * ``resize_bilinear``: ``mode='bilinear'``, ``align_corners`` as given;
  * ``aligned_bilinear``: the AdelaiDet upsample of the dynamic mask head:
    replicate-pad, align_corners=True resize to (f*h+1, f*w+1),
    replicate-pad by f//2, crop.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _as_4d(x: torch.Tensor):
    lead = x.shape[:-2]
    return x.reshape((-1, 1) + tuple(x.shape[-2:])), lead


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    x4, lead = _as_4d(x)
    return F.interpolate(x4, size=tuple(size), mode="nearest").reshape(lead + tuple(size))


def resize_bilinear(
    x: torch.Tensor, size: Tuple[int, int], align_corners: bool = False
) -> torch.Tensor:
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    x4, lead = _as_4d(x)
    out = F.interpolate(x4.float(), size=tuple(size), mode="bilinear",
                        align_corners=align_corners)
    return out.reshape(lead + tuple(size)).to(x.dtype)


def aligned_bilinear(x: torch.Tensor, factor: int) -> torch.Tensor:
    if factor < 1:
        raise ValueError(f"factor must be >= 1, got {factor}")
    if factor == 1:
        return x
    h, w = x.shape[-2:]
    x4, lead = _as_4d(x)
    x4 = F.pad(x4, (0, 1, 0, 1), mode="replicate")
    oh, ow = factor * h + 1, factor * w + 1
    x4 = F.interpolate(x4, size=(oh, ow), mode="bilinear", align_corners=True)
    x4 = F.pad(x4, (factor // 2, 0, factor // 2, 0), mode="replicate")
    x4 = x4[..., : oh - 1, : ow - 1]
    return x4.reshape(lead + tuple(x4.shape[-2:]))


def resize_mask_nearest(mask: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest-resize a boolean mask [..., H, W] (resize a float copy, then
    cast back, as the reference does)."""
    return resize_nearest(mask.float(), size).bool()
