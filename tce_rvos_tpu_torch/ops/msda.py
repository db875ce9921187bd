"""Multi-scale deformable attention (MSDA): the plain PyTorch version.

Counterpart of ``tce_rvos_tpu/ops/msda.py::ms_deform_attn``. It is the CPU
path of the model and the oracle that the CUDA kernel
(``ops/msda_cuda.py``, ``csrc/msda_fwd.cu``) is held against on the card.

Semantics (the reference CUDA ``ms_deformable_im2col`` / grid_sample with
``align_corners=False``):

  * sampling locations are normalised to [0, 1] per level; the bilinear tap
    sits at pixel coordinate ``p = loc * (W, H) - 0.5``;
  * corners outside the level contribute zero (zero padding);
  * ``out[n, q, m*D + d] = sum_l sum_p attn[n,q,m,l,p] *
    bilinear(value_l[n, :, m, d], loc[n,q,m,l,p])``.

Taps are gathered and summed in float32 whatever the value's dtype; the
result is cast back to the value's dtype, as the kernel does.
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
    vf = value.float()
    loc = sampling_locations.float()
    attn = attention_weights.float()
    out = torch.zeros((n, q, m, d), dtype=torch.float32, device=value.device)
    for lvl, (h, w) in enumerate(spatial_shapes):
        value_l = vf[:, starts[lvl] : starts[lvl + 1]]
        x = loc[:, :, :, lvl, :, 0] * w - 0.5
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        a = attn[:, :, :, lvl]
        for flat_idx, wgt in _bilinear_corner_terms(x, y, h, w):
            tap = _gather_heads(value_l, flat_idx)
            out = out + torch.einsum("nqmpd,nqmp->nqmd", tap, wgt * a)
    return out.reshape(n, q, m * d).to(value.dtype)
