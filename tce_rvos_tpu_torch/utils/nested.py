"""Padded-batch containers (counterpart of ``tce_rvos_tpu/utils/nested.py``):
an explicit ``(data, mask)`` pair, ``mask`` True on padded elements, in
place of the reference's NestedTensor, with bucketing of the padded size.

Layout is channel-last, as in the JAX package: videos ``[B, T, H, W, 3]``,
masks ``[B, T, H, W]``. Numpy only; the train step moves the batch to the
device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np


@dataclasses.dataclass
class MaskedArray:
    """(data, pad-mask) pair. ``mask`` is True where padded."""

    data: np.ndarray
    mask: np.ndarray

    @property
    def shape(self):
        return self.data.shape


def _round_up(x: int, d: int) -> int:
    return ((x + d - 1) // d) * d


def pad_to(size: int, divisor: int, buckets: Sequence[int] | None = None) -> int:
    """Smallest padded size: next bucket if given, else next multiple of divisor."""
    padded = _round_up(size, divisor)
    if buckets:
        for b in sorted(buckets):
            if b >= padded:
                return b
        return _round_up(size, divisor)
    return padded


def batch_videos(
    videos: Iterable[np.ndarray],
    size_divisibility: int = 32,
    hw_buckets: Sequence[int] | None = None,
) -> MaskedArray:
    """Pad a list of ``[T, H, W, 3]`` float videos to a common
    ``[B, T, Hp, Wp, 3]`` batch with a ``[B, T, Hp, Wp]`` True-on-pad mask
    (zero padding, sizes rounded up to ``size_divisibility`` or to the next
    of ``hw_buckets``)."""
    videos = [np.asarray(v) for v in videos]
    t_max = max(v.shape[0] for v in videos)
    h_max = pad_to(max(v.shape[1] for v in videos), size_divisibility, hw_buckets)
    w_max = pad_to(max(v.shape[2] for v in videos), size_divisibility, hw_buckets)
    b = len(videos)
    data = np.zeros((b, t_max, h_max, w_max, 3), dtype=videos[0].dtype)
    mask = np.ones((b, t_max, h_max, w_max), dtype=bool)
    for i, v in enumerate(videos):
        t, h, w = v.shape[:3]
        data[i, :t, :h, :w] = v
        mask[i, :t, :h, :w] = False
    return MaskedArray(data, mask)


def batch_tensors(
    tensors: Iterable[np.ndarray], size_divisibility: int = 32
) -> MaskedArray:
    """Pad a list of ``[T, H, W]`` mask stacks (or ``[H, W]`` images) to a
    common shape, the last two dimensions rounded up to
    ``size_divisibility``."""
    tensors = [np.asarray(x) for x in tensors]
    shapes = np.array([x.shape for x in tensors])
    maxes = shapes.max(axis=0)
    maxes[-2] = _round_up(int(maxes[-2]), size_divisibility)
    maxes[-1] = _round_up(int(maxes[-1]), size_divisibility)
    b = len(tensors)
    data = np.zeros((b, *maxes.tolist()), dtype=tensors[0].dtype)
    mask = np.ones((b, *maxes.tolist()), dtype=bool)
    for i, x in enumerate(tensors):
        sl = (i,) + tuple(slice(0, s) for s in x.shape)
        data[sl] = x
        mask[sl] = False
    return MaskedArray(data, mask)
