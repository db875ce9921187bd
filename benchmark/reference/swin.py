"""Frozen reference copy of the port's shifted-window machinery, as
Video-Swin uses it: tokens channel-last [B, T, H, W, C]; the relative-position
bias table a parameter, its index a non-persistent buffer; the shifted
window mask (-100 between tokens of one window from different regions)
built from each token's region label; the window attention in chunks of at
most ``ATTN_LOGITS_CHUNK`` logits; DropPath from torch's generator;
LayerNorm eps 1e-6. Keys are the reference checkpoint's."""

from __future__ import annotations

import functools
import itertools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import ATTN_LOGITS_CHUNK, layer_norm, run_layer

def rel_position_index(window: Sequence[int]) -> np.ndarray:
    """[n, n] index into the bias table of a window of n = prod(window)
    tokens: each axis' relative offset made >= 0, read as a mixed-radix
    number with radices 2 w - 1 (``_rel_position_index``,
    ``_rel_position_index_3d``)."""
    grids = np.meshgrid(*[np.arange(w) for w in window], indexing="ij")
    coords = np.stack(grids).reshape(len(window), -1)
    rel = coords[:, :, None] - coords[:, None, :]
    idx = np.zeros(rel.shape[1:], np.int64)
    for axis, w in enumerate(window):
        idx = idx * (2 * w - 1) + rel[axis] + (w - 1)
    return idx


def _grid_partition(x: np.ndarray, window: Sequence[int]) -> np.ndarray:
    """numpy [*dims] -> [nW, n], windows in row-major order."""
    k = len(window)
    shape = [s for d, w in zip(x.shape, window) for s in (d // w, w)]
    perm = [2 * i for i in range(k)] + [2 * i + 1 for i in range(k)]
    return x.reshape(shape).transpose(perm).reshape(-1, math.prod(window))


@functools.lru_cache(maxsize=64)
def shift_region_labels(padded: Tuple[int, ...], window: Tuple[int, ...],
                        shift: Tuple[int, ...]) -> np.ndarray:
    """[nW, n] label of the region each token of each window came from
    after the cyclic shift; tokens with different labels are masked apart
    (``_shift_attn_mask``, ``_shift_attn_mask_3d``: -100 where labels
    differ). An axis with shift 0 is one region."""
    img = np.zeros(padded, np.int32)

    def slices(w, s):
        return [slice(None)] if s == 0 else [slice(0, -w), slice(-w, -s), slice(-s, None)]

    for label, region in enumerate(itertools.product(*[slices(w, s)
                                                       for w, s in zip(window, shift)])):
        img[region] = label
    return _grid_partition(img, window)


def window_partition(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """[B, *dims, C] -> [B * nW, n, C] (each dim a multiple of its window)."""
    b, *dims, c = x.shape
    k = len(dims)
    x = x.reshape(b, *[s for d, w in zip(dims, window) for s in (d // w, w)], c)
    perm = [0] + [1 + 2 * i for i in range(k)] + [2 + 2 * i for i in range(k)] + [2 * k + 1]
    return x.permute(perm).reshape(-1, math.prod(window), c)


def window_reverse(xw: torch.Tensor, window: Sequence[int], b: int,
                   dims: Sequence[int]) -> torch.Tensor:
    """[B * nW, n, C] -> [B, *dims, C], the inverse of ``window_partition``."""
    k = len(dims)
    x = xw.reshape(b, *[d // w for d, w in zip(dims, window)], *window, -1)
    perm = [0] + [a for i in range(k) for a in (1 + i, 1 + k + i)] + [2 * k + 1]
    return x.permute(perm).reshape(b, *dims, -1)


class DropPath(nn.Module):
    """Stochastic depth: in training, each sample's branch is kept with
    probability 1 - rate and scaled by 1 / (1 - rate), else zeroed."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        mask = torch.empty((x.shape[0],) + (1,) * (x.ndim - 1), device=x.device).bernoulli_(keep)
        return torch.where(mask.bool(), x / keep, 0.0)


class WindowAttention(nn.Module):
    """Multi-head self-attention inside each window, with a learned
    relative-position bias. The table is sized for the full ``window``; a
    window that shrank to n tokens reads the full window's index sliced
    [:n, :n], as the reference does (video_swin_transformer.py:156)."""

    def __init__(self, dim: int, window: Sequence[int], num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(math.prod(2 * w - 1 for w in window), num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(rel_position_index(window)), persistent=False)

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [nB, n, C] windows of n tokens; ``labels`` [nB, n], a shifted
        block's region labels (None: no mask)."""
        b_, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(b_, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        idx = self.relative_position_index[:n, :n].reshape(-1)
        bias = self.relative_position_bias_table[idx].reshape(n, n, h).permute(2, 0, 1)
        attn = q @ k.transpose(-2, -1) + bias.to(q.dtype)
        if labels is not None:
            apart = labels[:, None, :, None] != labels[:, None, None, :]
            attn = attn + apart.to(attn.dtype) * -100.0
        out = attn.softmax(-1) @ v
        return self.proj(out.transpose(1, 2).reshape(b_, n, c))


def init_module(mod: nn.Module, generator: torch.Generator) -> None:
    """The Swin families' init hook: a window attention's relative-position
    bias table truncated N(0, 0.02) at two standard deviations; any other
    module is left as it is."""
    if isinstance(mod, WindowAttention):
        nn.init.trunc_normal_(mod.relative_position_bias_table, std=0.02, a=-0.04, b=0.04,
                              generator=generator)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


def get_window_size(x_size, window_size, shift_size):
    """Video-Swin's rule (reference video_swin_transformer.py:71-84): on an
    axis no longer than the window, the window is the axis and the shift 0."""
    use_w, use_s = list(window_size), list(shift_size)
    for i, size in enumerate(x_size):
        if size <= window_size[i]:
            use_w[i], use_s[i] = size, 0
    return tuple(use_w), tuple(use_s)


class SwinBlock(nn.Module):
    """One (shifted-)window block over [B, *dims, C], two or three axes:
    LayerNorm, zero padding of each axis to a multiple of the window, the
    cyclic shift and its mask, window attention, the inverse; a DropPath
    residual; then the GELU MLP's DropPath residual. ``shrink``: the window
    and shift follow ``get_window_size`` (Video-Swin)."""

    def __init__(self, dim: int, num_heads: int, window: Sequence[int], shift: Sequence[int],
                 drop_path: float, shrink: bool, mlp_ratio: float = 4.0):
        super().__init__()
        self.window, self.shift, self.shrink = tuple(window), tuple(shift), shrink
        self.norm1 = layer_norm(dim)
        self.attn = WindowAttention(dim, window, num_heads)
        self.drop_path = DropPath(drop_path)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def _attention(self, xw: torch.Tensor, labels: Optional[torch.Tensor]) -> torch.Tensor:
        n = xw.shape[1]
        step = max(1, ATTN_LOGITS_CHUNK // (self.attn.num_heads * n * n))
        if xw.shape[0] <= step:
            return self.attn(xw, labels)
        return torch.cat([self.attn(xw[i:i + step], None if labels is None else labels[i:i + step])
                          for i in range(0, xw.shape[0], step)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, *dims, C]."""
        b, *dims, _ = x.shape
        window, shift = self.window, self.shift
        if self.shrink:
            window, shift = get_window_size(dims, window, shift)
        shortcut = x
        x = shortcut + self.drop_path(self._windows(self.norm1(x), window, shift))
        return x + self.drop_path(self.mlp(self.norm2(x)))

    def _windows(self, x: torch.Tensor, window, shift) -> torch.Tensor:
        """The attention branch on the normed tokens of the whole clip."""
        b, *dims, _ = x.shape
        pads = [(-d) % w for d, w in zip(dims, window)]
        if any(pads):  # F.pad's pairs run from the last axis: C, then the dims reversed
            x = F.pad(x, [0, 0] + [a for p in reversed(pads) for a in (0, p)])
        padded = tuple(d + p for d, p in zip(dims, pads))
        axes = tuple(range(1, 1 + len(dims)))
        labels = None
        if any(shift):
            x = torch.roll(x, [-s for s in shift], axes)
            labels = torch.from_numpy(shift_region_labels(padded, window, shift))
            labels = labels.to(x.device).repeat(b, 1)
        x = window_reverse(self._attention(window_partition(x, window), labels), window, b, padded)
        if any(shift):
            x = torch.roll(x, list(shift), axes)
        if any(pads):
            x = x[(slice(None),) + tuple(slice(0, d) for d in dims)]
        return x


class PatchMerging(nn.Module):
    """2x2 patch merging over the last two spatial axes of [..., H, W, C]
    (Video-Swin's ``PatchMergingSpatial`` is this on every frame): H and W
    padded to even, the four phases concatenated, LayerNorm, a linear map
    to 2C without bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = layer_norm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-3], x.shape[-2]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[..., 0::2, 0::2, :], x[..., 1::2, 0::2, :],
                       x[..., 0::2, 1::2, :], x[..., 1::2, 1::2, :]], -1)
        return self.reduction(self.norm(x))


class PatchEmbed(nn.Module):
    """A patch convolution (``proj``: Conv2d 4x4, or Video-Swin's Conv3d
    (1, 4, 4)) and LayerNorm (``norm``) over its channel-last output."""

    def __init__(self, proj: nn.Module, dim: int):
        super().__init__()
        self.proj = proj
        self.norm = layer_norm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, 3, (T,) H, W], H and W padded to multiples of 4 ->
        channel-last tokens [N, (T,) h, w, C]."""
        h, w = x.shape[-2:]
        if h % 4 or w % 4:
            x = F.pad(x, (0, (-w) % 4, 0, (-h) % 4))
        return self.norm(self.proj(x).movedim(1, -1))


class SwinStage(nn.Module):
    """One stage's blocks, and in 2D Swin its downsample (``layers.{i}``)."""

    def __init__(self, blocks: List[nn.Module], downsample: Optional[nn.Module] = None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


def swin_stages(spec: dict, shrink: bool) -> List[List[SwinBlock]]:
    """The blocks of each stage: widths doubling from ``embed_dim``, the
    shift on odd blocks (half the window), the DropPath rate rising
    linearly over all blocks from 0 to ``drop_path_rate``."""
    window = spec["window_size"]
    window = (window, window) if isinstance(window, int) else tuple(window)
    shift = tuple(w // 2 for w in window)
    depths = spec["depths"]
    dpr = np.linspace(0, spec["drop_path_rate"], sum(depths)).tolist()
    stages, cur = [], 0
    for i, depth in enumerate(depths):
        dim = spec["embed_dim"] * 2**i
        stages.append([SwinBlock(dim, spec["num_heads"][i], window,
                                 (0,) * len(window) if j % 2 == 0 else shift,
                                 dpr[cur + j], shrink) for j in range(depth)])
        cur += depth
    return stages
