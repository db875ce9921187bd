"""MSDA forward on the card: the wrapper of the hand-written CUDA kernel
``csrc/msda_fwd.cu``, which replaces the TPU kernels
``tce_rvos_tpu/ops/pallas_msda.py::_sep_kernel_ah`` and ``::_flat_kernel_ah``.

``ms_deform_attn(value, spatial_shapes, loc, attn)`` has the signature of
``tce_rvos_tpu/ops/msda.py::ms_deform_attn``. On CUDA tensors it launches
the kernel or raises; it never falls back. Only CPU tensors go to the plain
version (``ops/msda.py``). ``ms_deform_attn.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from tce_rvos_tpu_torch.ops._build import load_library
from tce_rvos_tpu_torch.ops.msda import level_splits, ms_deform_attn_plain

SOURCE = "msda_fwd.cu"
MAX_LEVELS = 8
CHANNELS = 32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library(SOURCE).tce_msda_fwd
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, i32, ctypes.POINTER(i32), i32, ptr, ptr, ptr,
                   i32, i32, i32, i32, i32, i32, ptr]
    fn.restype = i32
    return fn


def _check(value, spatial_shapes, loc, attn) -> None:
    if value.dtype not in _DTYPE_CODE:
        raise TypeError(f"value must be float32 or bfloat16, got {value.dtype}")
    for name, t in (("sampling_locations", loc), ("attention_weights", attn)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != value.device:
            raise ValueError(f"{name} is on {t.device}, value on {value.device}")
    for name, t in (("value", value), ("sampling_locations", loc),
                    ("attention_weights", attn)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if value.dim() != 4 or value.shape[-1] != CHANNELS:
        raise ValueError(f"value must be [N, S, M, {CHANNELS}], got {tuple(value.shape)}")
    n, s, m, _ = value.shape
    n_levels = len(spatial_shapes)
    if not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} levels supported, got {n_levels}")
    if level_splits(spatial_shapes)[-1] != s:
        raise ValueError(f"spatial_shapes {spatial_shapes} do not cover S={s}")
    if loc.dim() != 6 or loc.shape[0] != n or loc.shape[2] != m \
            or loc.shape[3] != n_levels or loc.shape[5] != 2:
        raise ValueError(f"sampling_locations must be [N, Q, M, L, P, 2], got {tuple(loc.shape)}")
    if tuple(attn.shape) != tuple(loc.shape[:5]):
        raise ValueError(f"attention_weights must be {tuple(loc.shape[:5])}, got {tuple(attn.shape)}")


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """value [N, S, M, 32] f32|bf16, loc [N, Q, M, L, P, 2] f32,
    attn [N, Q, M, L, P] f32 -> [N, Q, M*32] in the value's dtype."""
    if value.device.type == "cpu":
        return ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                                    attention_weights)
    if value.device.type != "cuda":
        raise ValueError(f"no MSDA kernel for device {value.device}")
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    n, s, m, d = value.shape
    q, n_levels, p = sampling_locations.shape[1], len(spatial_shapes), sampling_locations.shape[4]
    out = torch.empty((n, q, m * d), dtype=value.dtype, device=value.device)
    level_hw = (ctypes.c_int * (2 * n_levels))(*(int(v) for hw in spatial_shapes for v in hw))
    fn = _kernel()
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(value.data_ptr(), _DTYPE_CODE[value.dtype], level_hw, n_levels,
                sampling_locations.data_ptr(), attention_weights.data_ptr(),
                out.data_ptr(), n, s, q, m, d, p, stream)
    if rc != 0:
        raise RuntimeError(f"msda_fwd kernel launch failed with CUDA error {rc}")
    ms_deform_attn.launches += 1
    return out


ms_deform_attn.launches = 0
