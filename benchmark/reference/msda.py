"""Multi-scale deformable attention as a plain gather (the reference's MSDA).

Semantics of the reference CUDA ``ms_deformable_im2col`` / grid_sample
with ``align_corners=False``: sampling locations are normalised to [0, 1]
per level, the bilinear tap sits at pixel ``loc * (W, H) - 0.5``, corners
outside the level add nothing, and

    out[n, q, m*D + d] = sum_l sum_p attn[n, q, m, l, p]
                         * bilinear(value_l[n, :, m, d], loc[n, q, m, l, p])

Taps are gathered and summed in float32 (float64 for a float64 value) and
the result is cast back to the value's dtype. The sum is written as a
product and a reduction, not as a matrix product, so that a FLOP counter
sees only the model's matrix products and convolutions.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def ms_deform_attn(
    value: torch.Tensor,                      # [N, S, M, D]
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,         # [N, Q, M, L, P, 2]
    attention_weights: torch.Tensor,          # [N, Q, M, L, P]
) -> torch.Tensor:
    """-> [N, Q, M*D] in the value's dtype."""
    n, s, m, d = value.shape
    q = sampling_locations.shape[1]
    if sum(h * w for h, w in spatial_shapes) != s:
        raise ValueError(f"spatial_shapes do not cover the value's {s} pixels")
    ctype = torch.promote_types(value.dtype, torch.float32)
    vf = value.to(ctype)
    loc = sampling_locations.to(ctype)
    attn = attention_weights.to(ctype)
    out = torch.zeros((n, q, m, d), dtype=ctype, device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        value_l = vf[:, start:start + h * w]                      # [N, HW, M, D]
        start += h * w
        x = loc[:, :, :, lvl, :, 0] * w - 0.5                     # [N, Q, M, P]
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        dx, dy = x - x0, y - y0
        p = x.shape[-1]
        for cy, cx, wgt in ((0, 0, (1 - dy) * (1 - dx)), (0, 1, (1 - dy) * dx),
                            (1, 0, dy * (1 - dx)), (1, 1, dy * dx)):
            xi = x0.long() + cx
            yi = y0.long() + cy
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            flat = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)    # [N, Q, M, P]
            idx = flat.permute(0, 1, 3, 2).reshape(n, q * p, m, 1).expand(n, q * p, m, d)
            tap = torch.gather(value_l, 1, idx).reshape(n, q, p, m, d)
            coef = torch.where(inside, wgt, torch.zeros_like(wgt)) * attn[:, :, :, lvl]
            out = out + (tap * coef.permute(0, 1, 3, 2)[..., None]).sum(2)
    return out.reshape(n, q, m * d).to(value.dtype)
