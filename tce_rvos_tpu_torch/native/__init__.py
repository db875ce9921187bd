"""The port's C host loops (``rle_ext.c``): COCO RLE encode and decode, the
counts' string codec and the DAVIS boundary map, the counterpart of the
JAX package's ``native/`` extension.

The source is built at first use with the host's C compiler (``$CC``, else
``cc``; ``-O3 -shared -fPIC``) into ``build/tce_rvos_tpu_torch/`` at the
root of the checkout, named by a hash of the source and the flags, and
loaded with ctypes, as ``ops/_build.py`` builds the CUDA kernels. Without a
compiler ``lib()`` is None and the callers (``utils/rle.py``,
``eval/davis_eval.py``) take their numpy paths, which compute the same
functions. ``CALLS`` counts the calls that went through the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "rle_ext.c"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "tce_rvos_tpu_torch"
CFLAGS = ("-O3", "-shared", "-fPIC")
CALLS = {"native": 0}

_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(CFLAGS).encode())
    return BUILD_DIR / f"rle_ext-{key.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """Compile ``rle_ext.c`` if its library is missing; None without a C
    compiler. A compiler that fails raises with its output."""
    so = library_path()
    if so.exists():
        return so
    cc = shutil.which(os.environ.get("CC", "cc"))
    if cc is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    res = subprocess.run([cc, *CFLAGS, "-o", str(tmp), str(SOURCE)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"rle_ext.c build failed ({cc} exit {res.returncode}):\n{res.stdout}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


@functools.lru_cache(maxsize=None)
def lib() -> Optional[ctypes.CDLL]:
    """The loaded library (built if needed, once per process), or None."""
    so = build()
    if so is None:
        return None
    dll = ctypes.CDLL(str(so))
    for name, args in (("tce_rle_encode", (_U8P, ctypes.c_int64, _I64P)),
                       ("tce_rle_to_string", (_I64P, ctypes.c_int64, ctypes.c_char_p)),
                       ("tce_rle_from_string", (ctypes.c_char_p, ctypes.c_int64, _I64P))):
        getattr(dll, name).argtypes = args
        getattr(dll, name).restype = ctypes.c_int64
    dll.tce_rle_decode.argtypes = (_I64P, ctypes.c_int64, _U8P, ctypes.c_int64)
    dll.tce_seg2bmap.argtypes = (_U8P, ctypes.c_int64, ctypes.c_int64, _U8P)
    for name in ("tce_rle_decode", "tce_seg2bmap"):
        getattr(dll, name).restype = None
    return dll


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _i64(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def rle_encode_bytes(flat: np.ndarray) -> List[int]:
    """Column-major mask bytes (uint8, contiguous) -> counts."""
    CALLS["native"] += 1
    flat = np.ascontiguousarray(flat, np.uint8).reshape(-1)
    counts = np.empty(flat.size + 1, np.int64)
    n = lib().tce_rle_encode(_u8(flat), flat.size, _i64(counts))
    return counts[:n].tolist()


def rle_decode_counts(counts: List[int], h: int, w: int) -> np.ndarray:
    """Counts -> the [h, w] uint8 mask."""
    CALLS["native"] += 1
    c = np.ascontiguousarray(counts, np.int64).reshape(-1)
    out = np.empty(h * w, np.uint8)
    lib().tce_rle_decode(_i64(c), c.size, _u8(out), out.size)
    return out.reshape((h, w), order="F")


def rle_counts_to_string(counts: List[int]) -> str:
    CALLS["native"] += 1
    c = np.ascontiguousarray(counts, np.int64).reshape(-1)
    buf = ctypes.create_string_buffer(13 * c.size + 1)
    n = lib().tce_rle_to_string(_i64(c), c.size, buf)
    return buf.raw[:n].decode("ascii")


def rle_string_to_counts(s: str) -> List[int]:
    CALLS["native"] += 1
    raw = s.encode("ascii")
    counts = np.empty(len(raw), np.int64)
    n = lib().tce_rle_from_string(raw, len(raw), _i64(counts))
    if n < 0:
        raise ValueError("bad rle string")
    return counts[:n].tolist()


def seg2bmap(seg: np.ndarray) -> np.ndarray:
    """Row-major mask [h, w] -> its boundary map, bool [h, w]."""
    CALLS["native"] += 1
    seg = np.ascontiguousarray(np.asarray(seg) != 0, np.uint8)
    h, w = seg.shape
    out = np.empty((h, w), np.uint8)
    lib().tce_seg2bmap(_u8(seg), h, w, _u8(out))
    return out.astype(bool)
