"""COCO run-length encoding in numpy (the port's copy of the numpy path of
``tce_rvos_tpu/utils/rle.py``).

The wire format of cocoapi's maskApi.c: column-major runs starting with the
zero run, and the counts compressed into a string of 6-bit groups (each
count after the second stored as its difference from the count two before).
The postprocessors encode predictions with it, MeViS stores its masks in it
and the evaluators decode both. The loops run in C
(``native/rle_ext.c``) where the port's native library is built (at first
use, with the host's C compiler), else in numpy and Python here, which
compute the same functions. ``USE_NATIVE = False`` keeps them in numpy.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from tce_rvos_tpu_torch import native

USE_NATIVE = True


def _native() -> bool:
    return USE_NATIVE and native.lib() is not None


def encode_counts(mask: np.ndarray) -> List[int]:
    """Binary [H, W] mask -> uncompressed counts (column-major, starting with
    the zero run)."""
    if _native():
        return native.rle_encode_bytes(np.asarray(mask).astype(np.uint8).T)
    flat = np.asarray(mask).astype(np.uint8).flatten(order="F")
    if flat.size == 0:
        return [0]
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    if flat[0] == 1:
        runs = [0] + runs
    return [int(r) for r in runs]


def decode_counts(counts: List[int], h: int, w: int) -> np.ndarray:
    if _native():
        return native.rle_decode_counts(counts, h, w)
    flat = np.zeros(h * w, dtype=np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos: pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F")


def _compress_counts(cnts: List[int]) -> str:
    if _native():
        return native.rle_counts_to_string(cnts)
    s = []
    for i, x in enumerate(cnts):
        if i > 2:
            x -= cnts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            s.append(chr(c + 48))
    return "".join(s)


def _decompress_counts(s: str) -> List[int]:
    if _native():
        return native.rle_string_to_counts(s)
    cnts: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))
            k += 1
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return cnts


def _counts(rle: Dict) -> List[int]:
    counts = rle["counts"]
    if isinstance(counts, bytes):
        counts = counts.decode("ascii")
    return _decompress_counts(counts) if isinstance(counts, str) else list(counts)


def encode(mask: np.ndarray) -> Dict:
    """Binary [H, W] -> pycocotools-style dict {'size': [H, W], 'counts': str}."""
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": _compress_counts(encode_counts(mask))}


def decode(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    return decode_counts(_counts(rle), h, w)


def area(rle: Dict) -> int:
    return int(sum(_counts(rle)[1::2]))


def iou(rle_a: Dict, rle_b: Dict) -> float:
    a = decode(rle_a).astype(bool)
    b = decode(rle_b).astype(bool)
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter) / float(union) if union else 0.0
