"""Dynamic-convolution mask head (counterpart of
``tce_rvos_tpu/models/dynamic_head.py``): each query's controller output
parameterises a small per-query 1x1 conv stack over the shared mask
features, written as batched einsums."""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from .interpolate import aligned_bilinear


def dynamic_head_param_counts(
    in_channels: int, channels: int, num_layers: int, rel_coord: bool = True
) -> Tuple[List[int], List[int]]:
    """Per-layer weight and bias element counts; with ``rel_coord`` layer 0
    also takes the two relative coordinates."""
    weight_nums, bias_nums = [], []
    for l in range(num_layers):
        if l == 0:
            weight_nums.append((in_channels + 2 if rel_coord else in_channels) * channels)
            bias_nums.append(channels)
        elif l == num_layers - 1:
            weight_nums.append(channels)
            bias_nums.append(1)
        else:
            weight_nums.append(channels * channels)
            bias_nums.append(channels)
    return weight_nums, bias_nums


def compute_locations(h: int, w: int, stride: int, device) -> torch.Tensor:
    """Feature-pixel centres in input coordinates [h, w, 2] (x, y)."""
    shift_x = torch.arange(0, w * stride, stride, dtype=torch.float32, device=device) + stride // 2
    shift_y = torch.arange(0, h * stride, stride, dtype=torch.float32, device=device) + stride // 2
    ys, xs = torch.meshgrid(shift_y, shift_x, indexing="ij")
    return torch.stack([xs, ys], -1)


def dynamic_mask_with_coords(
    mask_features: torch.Tensor,     # [b, t, C, h, w]
    params: torch.Tensor,            # [b, t, q, num_gen_params]
    reference_points: torch.Tensor,  # [b, t, q, 2] normalised (cx, cy)
    sizes: torch.Tensor,             # [b, 2] (img_h, img_w) model-input size
    channels: int,
    num_layers: int,
    rel_coord: bool = True,
    mask_feat_stride: int = 4,
    mask_out_stride: int = 4,
) -> torch.Tensor:
    """Mask logits [b, t, q, H_out, W_out] at ``mask_out_stride``; layer 0
    sees the mask features and, with ``rel_coord``, each pixel's offset
    from the query's reference point."""
    if num_layers < 2:
        raise ValueError("dynamic mask head needs >= 2 layers")
    if mask_feat_stride % mask_out_stride != 0:
        raise ValueError("mask_feat_stride must be a multiple of mask_out_stride")
    b, t, c, h, w = mask_features.shape
    q = params.shape[2]
    in_ch = c + 2 if rel_coord else c
    weight_nums, bias_nums = dynamic_head_param_counts(c, channels, num_layers, rel_coord)
    pieces = torch.split(params, weight_nums + bias_nums, dim=-1)
    ws, bs = pieces[:num_layers], pieces[num_layers:]

    # layer 0 split: the feature part is shared by every query, so multiply
    # the [b, t, C, h, w] map against each query's weights directly
    w0 = ws[0].reshape(b, t, q, channels, in_ch)
    x = torch.einsum("btchw,btqoc->btqohw", mask_features, w0[..., :c])
    if rel_coord:
        scale = torch.stack([sizes[:, 1], sizes[:, 0]], -1).float()
        ref_abs = reference_points.float() * scale[:, None, None, :]
        locations = compute_locations(h, w, mask_feat_stride, mask_features.device)
        rel = (ref_abs[:, :, :, None, None, :] - locations).to(mask_features.dtype)
        x = x + torch.einsum("btqhwr,btqor->btqohw", rel, w0[..., c:])
    x = F.relu(x + bs[0].reshape(b, t, q, channels, 1, 1))
    cin = channels
    for l in range(1, num_layers):
        cout = 1 if l == num_layers - 1 else channels
        wl = ws[l].reshape(b, t, q, cout, cin)
        x = torch.einsum("btqihw,btqoi->btqohw", x, wl) + bs[l].reshape(b, t, q, cout, 1, 1)
        if l < num_layers - 1:
            x = F.relu(x)
        cin = cout
    logits = x[:, :, :, 0]
    return aligned_bilinear(logits, mask_feat_stride // mask_out_stride)
