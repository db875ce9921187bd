"""MSDA on the card: the wrappers of the hand-written CUDA kernels.

* 2D: ``csrc/msda_fwd.cu`` (replaces the TPU kernels
  ``tce_rvos_tpu/ops/pallas_msda.py::_sep_kernel_ah`` and ``::_flat_kernel_ah``)
  and ``csrc/msda_bwd.cu`` (replaces ``tce_rvos_tpu/ops/pallas_msda_bwd.py::
  _bwd_q_kernel_sep``, ``_bwd_v_kernel_sep``, ``_bwd_q_kernel_flat`` and
  ``_bwd_v_kernel_flat``), joined by ``MSDeformAttnFunction``;
* 3D (``--msda_3d``): ``csrc/msda3d_fwd.cu`` (replaces
  ``tce_rvos_tpu/ops/pallas_msda_3d.py::_sep_kernel_3d`` and
  ``::_flat_kernel_3d``) and ``csrc/msda3d_bwd.cu`` (replaces
  ``tce_rvos_tpu/ops/pallas_msda_3d_bwd.py::_bwd3d_q_sep``, ``_bwd3d_v_sep``,
  ``_bwd3d_q_flat`` and ``_bwd3d_v_flat``), joined by
  ``MSDeformAttn3DFunction``.

``ms_deform_attn(value, spatial_shapes, loc, attn)`` and
``ms_deform_attn_3d(...)`` have the signatures of
``tce_rvos_tpu/ops/msda.py::ms_deform_attn`` and ``::ms_deform_attn_3d``.
CUDA tensors go through the autograd function with or without grad: its
forward launches the forward kernel, its backward the backward kernel, or
they raise; nothing falls back. Only CPU tensors go to the plain versions
(``ops/msda.py``), which autograd differentiates. While tracing is on
(``utils/profiling.py``) the autograd functions count their kernel
launches: ``msda.fwd`` and ``msda.bwd`` (2D), ``msda3d.fwd`` and
``msda3d.bwd`` (3D), each also under the span open at the forward's call
(a backward's too, though it runs after that span has closed).

The 3D forward takes a query batch Nq that differs from the value's N
frames (the frame-sharded forward's call, ``parallel/mesh.py``); its
backward kernel does not, and ``launch_backward`` raises for a backward of
such a call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from tce_rvos_tpu_torch.ops._build import load_library
from tce_rvos_tpu_torch.ops.msda import (
    level_splits,
    ms_deform_attn_3d_plain,
    ms_deform_attn_plain,
)
from tce_rvos_tpu_torch.utils import profiling

SOURCES = ("msda_fwd.cu", "msda_bwd.cu", "msda3d_fwd.cu", "msda3d_bwd.cu")
MAX_LEVELS = 8
CHANNELS = 32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the 2D kernels' launch plan (csrc/msda2d_common.cuh, make_plan)
LANES_PER_ROW = 16          # 4 channel groups x 4 tap groups
THREADS_FLAT = 256          # a block's threads on the flat path,
THREADS_STAGED = {False: 512, True: 256}  # and on the staged path (backward?)
STAGE_MIN_QUERIES = 512     # staged path from this many queries on
SMEM_BUDGET = 115_712       # bytes a block, so that two blocks share an SM
TARGET_BLOCKS = 4 * 132     # two waves of two blocks on an H100's 132 SMs
_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_SHAPE_ARGS = [_I32] * 6 + [_PTR]  # N, S, Q, M, D, P, stream


_FWD_ARGS = [_PTR, _I32, ctypes.POINTER(_I32), _I32, _PTR, _PTR, _PTR] + _SHAPE_ARGS
_FWD3_ARGS = _FWD_ARGS[:7] + [_I32] + _SHAPE_ARGS  # Nq before N
_BWD_ARGS = [_PTR, _I32, ctypes.POINTER(_I32), _I32, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR] + _SHAPE_ARGS


def bind(source, backward: bool, is_3d: bool = False):
    """The C entry point (``tce_msda[3d]_{fwd,bwd}``; the 3D forward's is
    ``tce_msda3d_fwd_nq``, which takes the query frames Nq before N) of the
    library built from ``source``: a file of ``csrc/`` or the path of
    another build of the same entry points (``chip_smoke.py`` times such
    builds against these). Raises, naming the file, for a build that lacks
    the entry point, such as a 3D forward from before it took Nq."""
    name = f"tce_msda{'3d' if is_3d else ''}_{'bwd' if backward else 'fwd'}"
    if is_3d and not backward:
        name += "_nq"
    lib = load_library(str(source))
    if not hasattr(lib, name):
        raise ValueError(f"{source} exports no {name}"
                         + (" (a 3D forward taking one N for queries and frames, "
                            "tce_msda3d_fwd, cannot be bound)" if name.endswith("_nq") else ""))
    fn = getattr(lib, name)
    fn.argtypes = _BWD_ARGS if backward else (_FWD3_ARGS if is_3d else _FWD_ARGS)
    fn.restype = _I32
    return fn


@functools.lru_cache(maxsize=None)
def _fwd_kernel(is_3d: bool = False):
    return bind("msda3d_fwd.cu" if is_3d else "msda_fwd.cu", False, is_3d)


@functools.lru_cache(maxsize=None)
def _bwd_kernel(is_3d: bool = False):
    return bind("msda3d_bwd.cu" if is_3d else "msda_bwd.cu", True, is_3d)


def launch_plan(backward: bool, dtype, spatial_shapes, n: int, q: int, m: int) -> dict:
    """How the 2D forward (or backward) kernel launches for these shapes, as
    ``make_plan`` in ``csrc/msda2d_common.cuh`` decides it (the card's
    ``tce_msda_plan`` returns the same; ``chip_smoke.py`` compares them):

    * ``staged``: a block takes one (frame, head) and ``run`` consecutive
      queries and keeps the trailing levels from ``value_from`` on, as many
      as fit in ``SMEM_BUDGET``, in ``smem`` bytes of shared memory; else
      every tap reads device memory (the small FTF and decoder calls);
    * ``threads`` a block, 16 a row; ``blocks``: the grid size."""
    starts = level_splits(spatial_shapes)
    n_levels = len(spatial_shapes)
    pix_bytes = (4 if dtype == torch.float32 else 2) * CHANNELS
    first = n_levels
    while first > 0 and (starts[-1] - starts[first - 1]) * pix_bytes <= SMEM_BUDGET:
        first -= 1
    if q < STAGE_MIN_QUERIES or first == n_levels or n * m == 0:
        rows = THREADS_FLAT // LANES_PER_ROW
        return dict(staged=0, threads=THREADS_FLAT, run=0, blocks=-(-n * m * q // rows),
                    value_from=n_levels, smem=0)
    threads = THREADS_STAGED[backward]
    rows = threads // LANES_PER_ROW
    per_nm = -(-TARGET_BLOCKS // (n * m))
    run = -(-(-(-q // per_nm)) // rows) * rows
    return dict(staged=1, threads=threads, run=run, blocks=n * m * -(-q // run),
                value_from=first, smem=(starts[-1] - starts[first]) * pix_bytes)


_PLAN_KEYS = ("staged", "threads", "run", "blocks", "value_from", "smem")


def kernel_plan(backward: bool, dtype, spatial_shapes, n: int, q: int, m: int) -> dict:
    """``launch_plan`` as the built kernels compute it (``tce_msda_plan``)."""
    fn = load_library("msda_fwd.cu").tce_msda_plan
    fn.argtypes = [_I32, _I32, ctypes.POINTER(_I32), _I32] + [_I32] * 4 + [ctypes.POINTER(_I32)]
    fn.restype = _I32
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    rc = fn(int(backward), _DTYPE_CODE[dtype], _level_hw(spatial_shapes), len(spatial_shapes),
            n, level_splits(spatial_shapes)[-1], q, m, out)
    if rc != 0:
        raise RuntimeError(f"tce_msda_plan failed with CUDA error {rc}")
    return dict(zip(_PLAN_KEYS, out))


def _check(value, spatial_shapes, loc, attn, coords: int = 2) -> None:
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
    # the 3D op's queries may be fewer frames than the value's (Nq < N)
    nq = loc.shape[0] if coords == 3 and loc.dim() == 6 else n
    n_levels = len(spatial_shapes)
    if not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} levels supported, got {n_levels}")
    if level_splits(spatial_shapes)[-1] != s:
        raise ValueError(f"spatial_shapes {spatial_shapes} do not cover S={s}")
    if loc.dim() != 6 or loc.shape[0] != nq or loc.shape[2] != m \
            or loc.shape[3] != n_levels or loc.shape[5] != coords:
        raise ValueError(f"sampling_locations must be [N, Q, M, L, P, {coords}], "
                         f"got {tuple(loc.shape)}")
    if tuple(attn.shape) != tuple(loc.shape[:5]):
        raise ValueError(f"attention_weights must be {tuple(loc.shape[:5])}, got {tuple(attn.shape)}")
    # the kernels read value rows in 16 bytes; the 2D ones read locations in
    # 8 (a 3D location, 12 bytes, is read a float at a time)
    aligned = [("value", value, 16)] + ([("sampling_locations", loc, 8)] if coords == 2 else [])
    for name, t, nbytes in aligned:
        if t.data_ptr() % nbytes:
            raise ValueError(f"{name} must start on a {nbytes}-byte boundary "
                             f"(pointer {t.data_ptr():#x}); pass a fresh tensor")


def _aligned(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """``t``, or a copy in a fresh (aligned) allocation if its pointer is not
    a multiple of ``nbytes``."""
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def _level_hw(spatial_shapes):
    return (ctypes.c_int * (2 * len(spatial_shapes)))(
        *(int(v) for hw in spatial_shapes for v in hw))


def _dims(value, loc):
    n, s, m, d = value.shape
    return n, s, loc.shape[1], m, d, loc.shape[4]


def launch_forward(kernel, name: str, value, spatial_shapes, loc, attn) -> torch.Tensor:
    """One launch of a forward entry point (``bind``) -> [Nq, Q, M*32]
    (Nq = N in 2D; the 3D entry point takes Nq, the rows of ``loc``)."""
    n, s, q, m, d, p = _dims(value, loc)
    nq = loc.shape[0]
    rows = (nq,) if loc.shape[-1] == 3 else ()
    out = torch.empty((nq, q, m * d), dtype=value.dtype, device=value.device)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = kernel(value.data_ptr(), _DTYPE_CODE[value.dtype], _level_hw(spatial_shapes),
                    len(spatial_shapes), loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
                    *rows, n, s, q, m, d, p, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    return out


def launch_backward(kernel, name: str, value, spatial_shapes, loc, attn, grad_out):
    """One launch of a backward entry point (``bind``) -> (d_value in the
    value's dtype, d_loc, d_attn). ``grad_out`` is made contiguous and, if
    its pointer is not 16-byte aligned, copied to a buffer that is. The
    kernels take as many query rows as value frames (Nq = N): a 3D forward
    call with fewer query frames has no backward here."""
    if loc.shape[0] != value.shape[0]:
        raise NotImplementedError(
            f"no {name} for {loc.shape[0]} query frames over {value.shape[0]} value frames "
            "(the frame-sharded forward is inference only)")
    grad_out = _aligned(grad_out.contiguous(), 16)
    if grad_out.dtype != value.dtype or grad_out.device != value.device:
        raise TypeError(f"grad_out is {grad_out.dtype} on {grad_out.device}; "
                        f"value is {value.dtype} on {value.device}")
    n, s, q, m, d, p = _dims(value, loc)
    if tuple(grad_out.shape) != (n, q, m * d):
        raise ValueError(f"grad_out must be {(n, q, m * d)}, got {tuple(grad_out.shape)}")
    d_value = torch.zeros(value.shape, dtype=torch.float32, device=value.device)
    d_loc = torch.empty(loc.shape, dtype=torch.float32, device=value.device)
    d_attn = torch.empty(attn.shape, dtype=torch.float32, device=value.device)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = kernel(value.data_ptr(), _DTYPE_CODE[value.dtype], _level_hw(spatial_shapes),
                    len(spatial_shapes), loc.data_ptr(), attn.data_ptr(), grad_out.data_ptr(),
                    d_value.data_ptr(), d_loc.data_ptr(), d_attn.data_ptr(),
                    n, s, q, m, d, p, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    return d_value.to(value.dtype), d_loc, d_attn


def _forward(is_3d: bool, value, spatial_shapes, loc, attn) -> torch.Tensor:
    return launch_forward(_fwd_kernel(is_3d), "msda3d_fwd" if is_3d else "msda_fwd",
                          value, spatial_shapes, loc, attn)


def _backward(is_3d: bool, value, spatial_shapes, loc, attn, grad_out):
    return launch_backward(_bwd_kernel(is_3d), "msda3d_bwd" if is_3d else "msda_bwd",
                           value, spatial_shapes, loc, attn, grad_out)


def msda_forward(value, spatial_shapes, loc, attn) -> torch.Tensor:
    """One launch of the 2D forward kernel -> [N, Q, M*32] in the value's
    dtype. Inputs as ``_check`` takes them."""
    return _forward(False, value, spatial_shapes, loc, attn)


def msda_backward(value, spatial_shapes, loc, attn, grad_out):
    """One launch of the 2D backward kernel -> (d_value in the value's
    dtype, d_loc f32, d_attn f32). ``grad_out`` [N, Q, M*32] is made
    contiguous and must have the value's dtype. ``d_value`` is accumulated
    in an f32 buffer zeroed here, then cast, as the JAX package's backward
    does."""
    return _backward(False, value, spatial_shapes, loc, attn, grad_out)


def msda3d_forward(value, spatial_shapes, loc, attn) -> torch.Tensor:
    """One launch of the 3D forward kernel (value [N, S, M, 32], loc
    [Nq, Q, M, L, P, 3]) -> [Nq, Q, M*32] in the value's dtype."""
    return _forward(True, value, spatial_shapes, loc, attn)


def msda3d_backward(value, spatial_shapes, loc, attn, grad_out):
    """One launch of the 3D backward kernel -> (d_value in the value's
    dtype, d_loc [N, Q, M, L, P, 3] f32, d_attn f32), as ``msda_backward``."""
    return _backward(True, value, spatial_shapes, loc, attn, grad_out)


def _needed(ctx, d_value, d_loc, d_attn):
    need_v, _, need_loc, need_attn = ctx.needs_input_grad
    return (d_value if need_v else None, None, d_loc if need_loc else None,
            d_attn if need_attn else None)


class MSDeformAttnFunction(torch.autograd.Function):
    """MSDA on CUDA tensors: the forward kernel, and the backward kernel as
    its gradient. It saves ``value``, ``loc`` and ``attn``; under
    recomputation (``use_checkpoint``) the forward kernel runs again in the
    backward pass."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, loc, attn):
        ctx.spatial_shapes = tuple(spatial_shapes)
        ctx.save_for_backward(value, loc, attn)
        ctx.site = profiling.site()
        out = msda_forward(value, spatial_shapes, loc, attn)
        profiling.count("msda.fwd")
        return out

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        grads = msda_backward(value, ctx.spatial_shapes, loc, attn, grad_out)
        profiling.count("msda.bwd", site=ctx.site)
        return _needed(ctx, *grads)


class MSDeformAttn3DFunction(torch.autograd.Function):
    """3D MSDA on CUDA tensors: the 3D forward kernel, and the 3D backward
    kernel as its gradient; saves what ``MSDeformAttnFunction`` saves. The
    backward kernel takes Nq = N only: a backward of a call whose queries
    are fewer frames than the value's raises (``launch_backward``)."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, loc, attn):
        ctx.spatial_shapes = tuple(spatial_shapes)
        ctx.save_for_backward(value, loc, attn)
        ctx.site = profiling.site()
        out = msda3d_forward(value, spatial_shapes, loc, attn)
        profiling.count("msda3d.fwd")
        return out

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        grads = msda3d_backward(value, ctx.spatial_shapes, loc, attn, grad_out)
        profiling.count("msda3d.bwd", site=ctx.site)
        return _needed(ctx, *grads)


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
    return MSDeformAttnFunction.apply(value, tuple(spatial_shapes), sampling_locations,
                                      attention_weights)


def ms_deform_attn_3d(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """value [N, S, M, 32] f32|bf16, loc [Nq, Q, M, L, P, 3] f32 (x, y and
    the frame coordinate over the value's N frames), attn [Nq, Q, M, L, P]
    f32 -> [Nq, Q, M*32] in the value's dtype."""
    if value.device.type == "cpu":
        return ms_deform_attn_3d_plain(value, spatial_shapes, sampling_locations,
                                       attention_weights)
    if value.device.type != "cuda":
        raise ValueError(f"no 3D MSDA kernel for device {value.device}")
    _check(value, spatial_shapes, sampling_locations, attention_weights, coords=3)
    return MSDeformAttn3DFunction.apply(value, tuple(spatial_shapes), sampling_locations,
                                        attention_weights)
