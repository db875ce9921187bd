"""Multi-scale deformable attention (MSDA): the plain PyTorch versions.

``ms_deform_attn_plain`` is the counterpart of
``tce_rvos_tpu/ops/msda.py::ms_deform_attn`` and ``ms_deform_attn_3d_plain``
that of its temporal variant ``ms_deform_attn_3d`` (``--msda_3d``). They are
the CPU path of the model and the oracles that the CUDA kernels
(``ops/msda_cuda.py``; ``csrc/msda_fwd.cu``, ``csrc/msda_bwd.cu`` and
``csrc/msda3d_fwd.cu``, ``csrc/msda3d_bwd.cu``) are held against on the
card: the forward by its output, the backward by autograd through the plain
version. Their floor-based corners and frames give the JAX package's
right-derivative at integer sampling points and integer frames.

Semantics (the reference CUDA ``ms_deformable_im2col`` / grid_sample with
``align_corners=False``):

  * sampling locations are normalised to [0, 1] per level; the bilinear tap
    sits at pixel coordinate ``p = loc * (W, H) - 0.5``;
  * corners outside the level contribute zero (zero padding);
  * ``out[n, q, m*D + d] = sum_l sum_p attn[n,q,m,l,p] *
    bilinear(value_l[n, :, m, d], loc[n,q,m,l,p])``.

The 3D variant gives every point a third coordinate f: the tap sits on the
fractional frame ``f_im = f * N - 0.5`` of the batch axis (N frames) and
lerps the bilinear taps of frames ``floor(f_im)`` and ``floor(f_im) + 1``
with weights ``1 - df`` and ``df``; frames outside [0, N - 1] add nothing.
Time is the whole batch axis of the call, as in the JAX package: with clips
or expressions stacked on it, a tap can reach into a neighbouring clip.

Taps are gathered and summed in float32 for a float32 or bfloat16 value
(float64 for a float64 one, which only the CPU takes); the result is cast
back to the value's dtype, as the kernels do.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

SpatialShapes = Tuple[Tuple[int, int], ...]


def level_splits(spatial_shapes: Sequence[Tuple[int, int]]) -> Tuple[int, ...]:
    """Flattened start offset of each level, plus the total (python ints)."""
    starts = [0]
    for h, w in spatial_shapes:
        starts.append(starts[-1] + h * w)
    return tuple(starts)


def _bilinear_corner_terms(x: torch.Tensor, y: torch.Tensor, h: int, w: int):
    """Four (flat_index, weight) pairs of the zero-padded bilinear tap at
    pixel coordinates (x, y) on an (h, w) grid; weight 0 outside."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = x - x0
    dy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    terms = []
    for cy, cx, wgt in (
        (0, 0, (1.0 - dy) * (1.0 - dx)),
        (0, 1, (1.0 - dy) * dx),
        (1, 0, dy * (1.0 - dx)),
        (1, 1, dy * dx),
    ):
        xi = x0i + cx
        yi = y0i + cy
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        terms.append((idx, torch.where(inb, wgt, torch.zeros_like(wgt))))
    return terms


def _gather_heads(value_l: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """value_l [N, HW, M, D], flat_idx [N, Q, M, P] -> [N, Q, M, P, D]."""
    n, q, m, p = flat_idx.shape
    d = value_l.shape[-1]
    idx = flat_idx.permute(0, 1, 3, 2).reshape(n, q * p, m, 1).expand(n, q * p, m, d)
    tap = torch.gather(value_l, 1, idx)  # [N, Q*P, M, D]
    return tap.reshape(n, q, p, m, d).permute(0, 1, 3, 2, 4)


def ms_deform_attn_plain(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """value [N, S, M, D], loc [N, Q, M, L, P, 2] (x, y in [0, 1]),
    attn [N, Q, M, L, P] -> [N, Q, M*D] in the value's dtype."""
    n, s, m, d = value.shape
    q = sampling_locations.shape[1]
    starts = level_splits(spatial_shapes)
    if starts[-1] != s:
        raise ValueError(f"spatial_shapes cover {starts[-1]} pixels, value has {s}")
    ctype = torch.promote_types(value.dtype, torch.float32)
    vf = value.to(ctype)
    loc = sampling_locations.to(ctype)
    attn = attention_weights.to(ctype)
    out = torch.zeros((n, q, m, d), dtype=ctype, device=value.device)
    for lvl, (h, w) in enumerate(spatial_shapes):
        value_l = vf[:, starts[lvl] : starts[lvl + 1]]
        x = loc[:, :, :, lvl, :, 0] * w - 0.5
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        a = attn[:, :, :, lvl]
        for flat_idx, wgt in _bilinear_corner_terms(x, y, h, w):
            tap = _gather_heads(value_l, flat_idx)
            out = out + torch.einsum("nqmpd,nqmp->nqmd", tap, wgt * a)
    return out.reshape(n, q, m * d).to(value.dtype)


def ms_deform_attn_3d_plain(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """value [N, S, M, D], loc [N, Q, M, L, P, 3] (x, y, f in [0, 1]),
    attn [N, Q, M, L, P] -> [N, Q, M*D] in the value's dtype."""
    n, s, m, d = value.shape
    q = sampling_locations.shape[1]
    starts = level_splits(spatial_shapes)
    if starts[-1] != s:
        raise ValueError(f"spatial_shapes cover {starts[-1]} pixels, value has {s}")
    ctype = torch.promote_types(value.dtype, torch.float32)
    vf = value.to(ctype)
    loc = sampling_locations.to(ctype)
    attn = attention_weights.to(ctype)
    f = loc[..., 2] * n - 0.5  # [N, Q, M, L, P]
    f0 = torch.floor(f)
    df = f - f0
    f0i = f0.to(torch.int64)
    heads = torch.arange(m, device=value.device)[:, None]  # against [..., M, P]
    out = torch.zeros((n, q, m, d), dtype=ctype, device=value.device)
    for lvl, (h, w) in enumerate(spatial_shapes):
        hw = h * w
        # (frame, pixel) flattened, so that one index picks both
        value_l = vf[:, starts[lvl] : starts[lvl + 1]].reshape(n * hw, m, d)
        x = loc[:, :, :, lvl, :, 0] * w - 0.5
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        a = attn[:, :, :, lvl]
        corners = _bilinear_corner_terms(x, y, h, w)
        for foff, fwgt in ((0, 1.0 - df[:, :, :, lvl]), (1, df[:, :, :, lvl])):
            fi = f0i[:, :, :, lvl] + foff
            fwgt = torch.where((fi >= 0) & (fi < n), fwgt, torch.zeros_like(fwgt))
            row0 = fi.clamp(0, n - 1) * hw
            for flat_idx, wgt in corners:
                tap = value_l[row0 + flat_idx, heads]  # [N, Q, M, P, D]
                out = out + torch.einsum("nqmpd,nqmp->nqmd", tap, fwgt * wgt * a)
    return out.reshape(n, q, m * d).to(value.dtype)
