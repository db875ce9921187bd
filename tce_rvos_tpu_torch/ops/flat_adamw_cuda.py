"""The fused flat AdamW update on the card: the wrapper of the hand-written
CUDA kernel ``csrc/flat_adamw.cu``.

It takes the place of the update that XLA fuses for the JAX package's
``tce_rvos_tpu/parallel/flat_adamw.py::make_flat_adamw_fused`` (no Pallas
kernel there). ``parallel/flat_adamw.py::flat_adamw_update`` calls
``flat_adamw_cuda`` for CUDA tensors and the plain torch version
``flat_adamw_update_plain`` for CPU tensors; on CUDA a kernel that does not
build or launch raises, nothing falls back. While tracing is on
(``utils/profiling.py``) the counter ``flat_adamw.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from tce_rvos_tpu_torch.ops._build import load_library
from tce_rvos_tpu_torch.utils import profiling

SOURCE = "flat_adamw.cu"
MAX_TIERS = 4
_PTR, _I32, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


class UpdateScalars(NamedTuple):
    """The f32 scalars of one update (each a Python float holding an f32
    value): per live tier its exclusive end in live coordinates, ``lr_t *
    rel`` and ``1 - lr_t * rel * wd``; the clip threshold; Adam's betas
    with ``1 - b``; the bias corrections ``1 - b ** count``; eps."""

    his: Tuple[int, ...]
    lrs: Tuple[float, ...]
    decays: Tuple[float, ...]
    clip: float
    b1: float
    omb1: float
    b2: float
    omb2: float
    bc1: float
    bc2: float
    eps: float


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library(SOURCE).flat_adamw_update
    fn.argtypes = ([_PTR] * 5 + [_I64, _I32, _PTR, _PTR, _PTR] + [_F32] * 8 + [_PTR])
    fn.restype = _I32
    return fn


def _check(p, g, mu, nu, gnorm, s: UpdateScalars) -> None:
    n = p.numel()
    for name, t in (("p", p), ("g", g), ("mu", mu), ("nu", nu)):
        if t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f"{name} must be a contiguous 1-D float32 CUDA tensor, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if t.numel() != n or t.device != p.device:
            raise ValueError(f"{name} holds {t.numel()} elements on {t.device}; p holds {n} on "
                             f"{p.device}")
    if gnorm.dtype != torch.float32 or gnorm.numel() != 1 or gnorm.device != p.device:
        raise ValueError(f"gnorm must be one float32 on {p.device}, got {gnorm.dtype} "
                         f"{tuple(gnorm.shape)} on {gnorm.device}")
    if not 1 <= len(s.his) <= MAX_TIERS or len(s.lrs) != len(s.his) or len(s.decays) != len(s.his):
        raise ValueError(f"1 to {MAX_TIERS} tiers, got ends {s.his}")
    if list(s.his) != sorted(s.his) or s.his[-1] != n:
        raise ValueError(f"the tiers' ends {s.his} must ascend to the live length {n}")


def flat_adamw_cuda(p, g, mu, nu, gnorm, s: UpdateScalars) -> None:
    """One launch of the update kernel, in place on ``p``, ``mu`` and ``nu``
    (the live ranges, 1-D f32 on one card) from ``g`` and the 0-d global
    norm ``gnorm``, on the current stream, without a host sync."""
    _check(p, g, mu, nu, gnorm, s)
    k = len(s.his)
    his = (ctypes.c_longlong * k)(*s.his)
    lrs = (ctypes.c_float * k)(*s.lrs)
    decays = (ctypes.c_float * k)(*s.decays)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                       gnorm.data_ptr(), p.numel(), k, his, lrs, decays, s.clip, s.b1, s.omb1,
                       s.b2, s.omb2, s.bc1, s.bc2, s.eps, stream)
    if rc != 0:
        raise RuntimeError(f"flat_adamw kernel launch failed with CUDA error {rc}")
    profiling.count("flat_adamw.launches")
