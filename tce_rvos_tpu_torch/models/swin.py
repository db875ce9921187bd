"""Swin Transformer backbone (t/s/b/l) and the shifted-window machinery it
shares with Video-Swin (counterpart of ``tce_rvos_tpu/models/swin.py``, and
of the 3D blocks of ``tce_rvos_tpu/models/video_swin.py``).

Tokens are channel-last inside the backbone: [B, H, W, C] in 2D, [B, T, H,
W, C] in 3D. The window functions and blocks here take either: 2D Swin's
``SwinBlock``/``WindowAttention`` and Video-Swin's ``SwinBlock3D``/
``WindowAttention3D`` are the same computation over two or three axes, so
one block serves both, with ``shrink`` for Video-Swin's ``get_window_size``
rule. The backbones take and return NCHW.

  * The relative-position bias table is a parameter; its index is a
    non-persistent buffer, so the state_dict has exactly the keys of
    ``tce_rvos_tpu/utils/checkpoint.py::flax_to_torch_key``, and a reference
    ``.pth``'s ``relative_position_index`` keys are reported unused, as in
    the JAX package.
  * The shifted-window mask (-100 between tokens of a window that come from
    different regions of the shifted frame) is built on the device from
    each token's region label, per window chunk, not stored; the labels
    are uploaded once per shape and kept on the device (``region_labels``),
    so a block waits for nothing and a CUDA graph can hold it.
  * The windows' attention runs in chunks of at most ``ATTN_LOGITS_CHUNK``
    logits (whole-video serving puts thousands of windows through one
    block); the windows are independent, so the chunks compute the same
    function.
  * DropPath draws its per-sample keep mask from torch's generator;
    ``use_checkpoint`` recomputes each block in the backward pass
    (``layers.run_layer``), as ``nn.remat`` does.
  * LayerNorm eps 1e-6 (flax's default, which the JAX package keeps); the
    attention and MLP dropout rates are 0 in every spec, so there is no
    dropout module.
  * Tracing (``utils/profiling.py``): each stage of either backbone, its
    blocks and its output, is the span ``tce.model.backbone.stage{i}``
    (``stage_span``, units: frames); each block counts the tokens it feeds
    to window attention, padding included (``swin.window_tokens``), and the
    tokens it returns (``swin.window_tokens_real``), under its stage's span;
    each upload of region labels counts ``swin.label_uploads``.

Checkpoint keys (``backbone.0.body.`` + ``patch_embed.proj``,
``layers.{i}.blocks.{j}.{norm1,attn.qkv,attn.proj,
attn.relative_position_bias_table,norm2,mlp.fc1,mlp.fc2}``,
``layers.{i}.downsample.{norm,reduction}``, ``norm{i}``) are the reference's.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tce_rvos_tpu_torch.models.layers import ATTN_LOGITS_CHUNK, layer_norm, run_layer
from tce_rvos_tpu_torch.parallel.collectives import gather_frame_range, spread
from tce_rvos_tpu_torch.utils import profiling

SWIN_CONFIGS = {
    # the JAX package's swin.py:204-209 (reference swin_transformer.py:687-745)
    "swin_t_p4w7": dict(embed_dim=96, depths=(2, 2, 6, 2),
                        num_heads=(3, 6, 12, 24), drop_path_rate=0.2),
    "swin_s_p4w7": dict(embed_dim=96, depths=(2, 2, 18, 2),
                        num_heads=(3, 6, 12, 24), drop_path_rate=0.2),
    "swin_b_p4w7": dict(embed_dim=128, depths=(2, 2, 18, 2),
                        num_heads=(4, 8, 16, 32), drop_path_rate=0.3),
    "swin_l_p4w7": dict(embed_dim=192, depths=(2, 2, 18, 2),
                        num_heads=(6, 12, 24, 48), drop_path_rate=0.3),
}


STAGE_SPANS = tuple(f"tce.model.backbone.stage{i}" for i in range(4))


def stage_span(i: int, frames: int):
    """The span of a Swin backbone's stage ``i`` (its blocks and its
    output) over ``frames`` frames."""
    return profiling.span(STAGE_SPANS[i], frames)


def count_window_tokens(b: int, padded: Sequence[int], dims: Sequence[int]) -> None:
    """Counts a block's tokens: ``b * prod(padded)`` fed to window
    attention, ``b * prod(dims)`` its own."""
    profiling.count("swin.window_tokens", b * math.prod(padded))
    profiling.count("swin.window_tokens_real", b * math.prod(dims))


def swin_spec(name: str) -> dict:
    cfg = SWIN_CONFIGS[name]
    return dict(**cfg, window_size=7, strides=[4, 8, 16, 32],
                channels=[cfg["embed_dim"] * 2**i for i in range(4)])


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


@functools.cache
def region_labels(padded: Tuple[int, ...], window: Tuple[int, ...], shift: Tuple[int, ...],
                  windows: Optional[Tuple[int, ...]], device: torch.device) -> torch.Tensor:
    """``shift_region_labels`` on ``device``: [nW, n], or with ``windows``
    only the windows of those temporal windows (indices along the first
    axis of ``padded``), in their order. Uploaded once per key, each miss
    counted (``swin.label_uploads``): a copy to the device on every call
    would wait for the stream, and no CUDA graph can hold one. Kept for the
    life of the process, never evicted: a captured graph reads the tensor
    at its address, so freeing it would let the graph read whatever the
    allocator puts there next. One tensor per key, 4 bytes a token,
    however many blocks and engines share it. Made outside
    inference mode, so that a training forward after a served one may use
    it; never written."""
    grid = shift_region_labels(padded, window, shift)
    if windows is not None:
        n = grid.shape[-1]
        grid = grid.reshape(padded[0] // window[0], -1, n)[list(windows)].reshape(-1, n)
    profiling.count("swin.label_uploads")
    with torch.inference_mode(False):
        return torch.from_numpy(grid).to(device)


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


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class WindowPlan(NamedTuple):
    """``temporal_window_plan``'s answer for one rank."""

    padded_frames: int          # Tp, the clip padded to a multiple of the window
    windows: Tuple[int, ...]    # the temporal windows the rank's frames fall in, in order
    ranges: Tuple[Tuple[int, int], ...]  # the clip frames to gather ([lo, hi), zeros past T)
    take: Tuple[int, ...]       # the gathered frames (ranges concatenated) in window order
    keep: Tuple[int, ...]       # the rank's own frames' places in that order


@functools.lru_cache(maxsize=256)
def temporal_window_plan(frames: int, window: int, shift: int, first: int,
                         count: int) -> WindowPlan:
    """Which frames a rank holding frames ``[first, first + count)`` of a
    ``frames``-frame clip needs for one shifted-window block with temporal
    window ``window`` and shift ``shift`` (both from ``get_window_size``
    over the whole clip). The clip is padded to Tp frames and rolled by
    -shift, so window k holds the clip's frames (p + shift) mod Tp for
    positions p in [k window, (k + 1) window): frames past T are the zero
    pad, and with a shift the last window takes the clip's first
    ``shift`` frames. The needed frames are a cyclic interval of [0, Tp):
    one range, or with a shift two (every rank then gathers two, the
    second possibly empty, since the gathers are collective)."""
    tp = -(-frames // window) * window
    own = range(first, first + count)
    windows = sorted({(f - shift) % tp // window for f in own})
    order = [(p + shift) % tp for k in windows for p in range(k * window, (k + 1) * window)]
    needed = sorted(set(order))
    runs: List[List[int]] = []
    for f in needed:
        if runs and runs[-1][1] == f:
            runs[-1][1] = f + 1
        else:
            runs.append([f, f + 1])
    if len(runs) == 2 and runs[0][0] == 0:  # the wrapped interval: its tail first
        runs.reverse()
    ranges = [tuple(r) for r in runs] + [(0, 0)] * ((2 if shift else 1) - len(runs))
    at, offset = 0, {}
    for lo, hi in ranges:
        for f in range(lo, hi):
            offset[f] = at + f - lo
        at += hi - lo
    place = {k: i for i, k in enumerate(windows)}
    keep = [place[(f - shift) % tp // window] * window + (f - shift) % tp % window for f in own]
    return WindowPlan(tp, tuple(windows), tuple(ranges), tuple(offset[f] for f in order),
                      tuple(keep))


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

    def forward(self, x: torch.Tensor, frame_shard=None) -> torch.Tensor:
        """x [B, *dims, C]. ``frame_shard`` (Video-Swin under the
        frame-sharded forward): x holds the rank's frames of the clip, and
        the window and shift follow the whole clip's frame count."""
        b, *dims, _ = x.shape
        sharded = spread(frame_shard)
        window, shift = self.window, self.shift
        if self.shrink:
            window, shift = get_window_size((frame_shard.frames, *dims[1:]) if sharded else dims,
                                            window, shift)
        shortcut = x
        x = self.norm1(x)
        if sharded:
            x = self._sharded_windows(x, window, shift, frame_shard)
        else:
            x = self._windows(x, window, shift)
        x = shortcut + self.drop_path(x)
        return x + self.drop_path(self.mlp(self.norm2(x)))

    def _windows(self, x: torch.Tensor, window, shift) -> torch.Tensor:
        """The attention branch on the normed tokens of the whole clip."""
        b, *dims, _ = x.shape
        pads = [(-d) % w for d, w in zip(dims, window)]
        if any(pads):  # F.pad's pairs run from the last axis: C, then the dims reversed
            x = F.pad(x, [0, 0] + [a for p in reversed(pads) for a in (0, p)])
        padded = tuple(d + p for d, p in zip(dims, pads))
        count_window_tokens(b, padded, dims)
        axes = tuple(range(1, 1 + len(dims)))
        labels = None
        if any(shift):
            x = torch.roll(x, [-s for s in shift], axes)
            labels = region_labels(padded, window, shift, None, x.device).repeat(b, 1)
        x = window_reverse(self._attention(window_partition(x, window), labels), window, b, padded)
        if any(shift):
            x = torch.roll(x, list(shift), axes)
        if any(pads):
            x = x[(slice(None),) + tuple(slice(0, d) for d in dims)]
        return x

    def _sharded_windows(self, x: torch.Tensor, window, shift, shard) -> torch.Tensor:
        """``_windows`` for the rank's frames of the clip (x [b, t, h, w,
        C] normed): the rank gathers every frame of the temporal windows
        its own frames fall in (``temporal_window_plan``: its neighbours'
        frames, the zero pad frames, and after the cyclic shift the clip's
        first frames that wrap into the last window), lays those windows
        out in the shifted order, runs their attention with the region
        labels of the whole padded clip, and keeps its own frames' rows."""
        b, t, h, w, _ = x.shape
        plan = temporal_window_plan(shard.frames, window[0], shift[0], shard.first, shard.count)
        parts = [gather_frame_range(x, shard, lo, hi) for lo, hi in plan.ranges]
        take = torch.as_tensor(plan.take, device=x.device)
        x = (torch.cat(parts, 1) if len(parts) > 1 else parts[0]).index_select(1, take)
        pads = [(-h) % window[1], (-w) % window[2]]
        if any(pads):
            x = F.pad(x, [0, 0, 0, pads[1], 0, pads[0]])
        padded = (len(plan.take), h + pads[0], w + pads[1])
        count_window_tokens(b, padded, (t, h, w))
        labels = None
        if any(shift):
            x = torch.roll(x, [-shift[1], -shift[2]], (2, 3))
            labels = region_labels((plan.padded_frames, *padded[1:]), window, shift,
                                   plan.windows, x.device).repeat(b, 1)
        x = window_reverse(self._attention(window_partition(x, window), labels), window, b, padded)
        if any(shift):
            x = torch.roll(x, [shift[1], shift[2]], (2, 3))
        keep = torch.as_tensor(plan.keep, device=x.device)
        return x[:, :, :h, :w].index_select(1, keep)


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


class SwinBackbone(nn.Module):
    """Image Swin: frames [N, 3, H, W] -> four maps [N, C_i, h, w] (strides
    4, 8, 16, 32), each through its stage's LayerNorm (``norm{i}``)."""

    def __init__(self, spec: dict, use_checkpoint: bool = False):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        dims = spec["channels"]
        self.patch_embed = PatchEmbed(nn.Conv2d(3, dims[0], 4, stride=4), dims[0])
        stages = swin_stages(spec, shrink=False)
        self.layers = nn.ModuleList(
            SwinStage(blocks, PatchMerging(dims[i]) if i < len(stages) - 1 else None)
            for i, blocks in enumerate(stages))
        for i, dim in enumerate(dims):
            self.add_module(f"norm{i}", layer_norm(dim))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        n = x.shape[0]
        x = self.patch_embed(x)
        outs = []
        for i, stage in enumerate(self.layers):
            with stage_span(i, n):
                for blk in stage.blocks:
                    x = run_layer(blk, self.use_checkpoint, x)
                outs.append(getattr(self, f"norm{i}")(x).permute(0, 3, 1, 2).contiguous())
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs
