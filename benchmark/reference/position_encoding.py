"""Sinusoidal position encodings (counterpart of
``tce_rvos_tpu/models/position_encoding.py``), built in float32.

Both take a True-on-pad mask and return channel-last embeddings, as the JAX
functions do: ``sine_pos_1d`` [B, T, F], ``sine_pos_2d`` [B, H, W, 2F].
Positions are normalised to [0, 2*pi] (the JAX functions' defaults, the
only setting the model uses).
"""

from __future__ import annotations

import math

import torch


def _dim_t(num_pos_feats: int, temperature: float, device) -> torch.Tensor:
    i = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    return temperature ** (2.0 * torch.floor(i / 2.0) / num_pos_feats)


def _interleave_sin_cos(pos: torch.Tensor) -> torch.Tensor:
    s = torch.sin(pos[..., 0::2])
    c = torch.cos(pos[..., 1::2])
    return torch.stack([s, c], dim=-1).flatten(-2)


def sine_pos_1d(
    mask: torch.Tensor, num_pos_feats: int = 256, temperature: float = 10000.0
) -> torch.Tensor:
    """mask [B, T] True=pad -> [B, T, num_pos_feats]."""
    x_embed = torch.cumsum((~mask).float(), dim=1)
    x_embed = x_embed / (x_embed[:, -1:] + 1e-6) * (2 * math.pi)
    pos = x_embed[..., None] / _dim_t(num_pos_feats, temperature, mask.device)
    return _interleave_sin_cos(pos)


def sine_pos_2d(
    mask: torch.Tensor, num_pos_feats: int = 128, temperature: float = 10000.0
) -> torch.Tensor:
    """mask [B, H, W] True=pad -> [B, H, W, 2*num_pos_feats] (y then x),
    with the reference's -0.5 centre shift."""
    not_mask = (~mask).float()
    y_embed = torch.cumsum(not_mask, dim=1)
    x_embed = torch.cumsum(not_mask, dim=2)
    y_embed = (y_embed - 0.5) / (y_embed[:, -1:, :] + 1e-6) * (2 * math.pi)
    x_embed = (x_embed - 0.5) / (x_embed[:, :, -1:] + 1e-6) * (2 * math.pi)
    dim_t = _dim_t(num_pos_feats, temperature, mask.device)
    pos_x = _interleave_sin_cos(x_embed[..., None] / dim_t)
    pos_y = _interleave_sin_cos(y_embed[..., None] / dim_t)
    return torch.cat([pos_y, pos_x], dim=-1)
