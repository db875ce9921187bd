"""X3D video backbone (xs/s/m/l/self) (counterpart of
``tce_rvos_tpu/models/x3d.py``), NCTHW.

The stem is a spatial 3x3 conv, a depthwise temporal 5x1x1 conv,
BatchNorm and ReLU; then four stages of bottleneck blocks (1x1x1 conv,
depthwise 3x3x3 conv, squeeze-excitation on even blocks, Swish, 1x1x1
conv, each conv followed by BatchNorm), widths and depths scaled with the
JAX package's ``round_width``/``round_repeats`` arithmetic. Time stays
inside the convs; the output is the per-frame map of stages 1-4 (strides
4, 8, 16, 32), the stem's dropped.

Under the frame-sharded forward (``frame_shard``) the rank holds its
frames of the clip: the stem's 5x1x1 conv takes 2 frames a side from its
neighbours and each block's 3x3x3 conv 1 (``temporal_halo``; zeros past
the clip's ends, as one process pads), and the squeeze-excitation mean
over (T, H, W) is a sum all-reduced over the ranks. Everything else is
per frame.

BatchNorm (``BatchNorm3d``: eps 1e-5) normalises with its running
statistics. X3D serves and evaluates in the port but does not train: the
JAX package cannot train it (its train-mode flax BatchNorm is applied
without a mutable ``batch_stats``), and the port adds no feature the JAX
package lacks (``parallel/train_step.py``).

Module names are the reference's pytorchvideo layout as
``tce_rvos_tpu/utils/checkpoint.py`` maps it (``blocks.0.conv.conv_t`` is
the stem's *spatial* conv and ``conv_xy`` its temporal one;
``branch2.norm_b.0`` the inner BatchNorm, ``branch2.norm_b.1.block.{0,2}``
the squeeze-excitation convs).
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from tce_rvos_tpu_torch.parallel.collectives import all_reduce_sum, gather_frame_range, spread

X3D_CONFIGS = {
    # the JAX package's x3d.py:116-123 (reference x3d.py:1447-1474)
    "x3d_xs": dict(width_factor=1.5, depth_factor=2.2),
    "x3d_s": dict(width_factor=2.0, depth_factor=2.2),
    "x3d_m": dict(width_factor=2.0, depth_factor=2.2),
    "x3d_l": dict(width_factor=2.0, depth_factor=5.0),
    "x3d_self": dict(width_factor=2.0, depth_factor=2.2),
}
STEM_WIDTH, STAGE_DEPTHS, SE_RATIO = 12, (1, 2, 5, 3), 0.0625


def round_width(width, multiplier, min_width=8, divisor=8, ceil=False):
    if not multiplier:
        return width
    width *= multiplier
    min_width = min_width or divisor
    if ceil:
        width_out = max(min_width, int(math.ceil(width / divisor)) * divisor)
    else:
        width_out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if width_out < 0.9 * width:
        width_out += divisor
    return int(width_out)


def round_repeats(repeats, multiplier):
    if not multiplier:
        return repeats
    return int(math.ceil(multiplier * repeats))


def temporal_halo(x: torch.Tensor, shard, k: int) -> torch.Tensor:
    """[b, C, t, H, W] holding the rank's frames -> [b, C, t + 2k, H, W]
    with k frames a side from the ranks that hold them (zeros past the
    clip's ends): what a temporal kernel of 2k + 1 with padding k reads."""
    first = shard.first
    return gather_frame_range(x.transpose(1, 2), shard, first - k,
                              first + shard.count + k).transpose(1, 2)


def _stage_bases() -> List[int]:
    """The stages' widths before the width factor: 12, then doubling."""
    dims = [STEM_WIDTH]
    for _ in range(3):
        dims.append(round_width(dims[-1], 2.0, divisor=8))
    return dims


def x3d_spec(name: str) -> dict:
    cfg = X3D_CONFIGS[name]
    return dict(**cfg, strides=[4, 8, 16, 32],
                channels=[round_width(d, cfg["width_factor"]) for d in _stage_bases()])


class BatchNorm3d(nn.Module):
    """BatchNorm over the channels of [N, C, ...] with its running
    statistics, eps 1e-5, folded to a per-channel scale and shift as
    ``FrozenBatchNorm2d`` does (X3D does not train in the port). No
    ``num_batches_tracked``: its keys are the JAX package's."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * (self.running_var + 1e-5).rsqrt()
        shift = self.bias - self.running_mean * scale
        view = (1, -1) + (1,) * (x.ndim - 2)
        return x * scale.to(x.dtype).view(view) + shift.to(x.dtype).view(view)


class SqueezeExcitation(nn.Module):
    """Mean over (T, H, W), 1x1x1 conv, ReLU, 1x1x1 conv, sigmoid gate."""

    def __init__(self, channels: int, reduced: int):
        super().__init__()
        self.block = nn.Sequential(nn.Conv3d(channels, reduced, 1), nn.ReLU(),
                                   nn.Conv3d(reduced, channels, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor, frame_shard=None) -> torch.Tensor:
        if not spread(frame_shard):
            return x * self.block(x.mean(dim=(2, 3, 4), keepdim=True))
        # the whole clip's mean: the ranks' sums, reduced in float32 or wider
        wide = torch.promote_types(x.dtype, torch.float32)
        total = all_reduce_sum(x.sum(dim=(2, 3, 4), keepdim=True, dtype=wide), frame_shard)
        n = frame_shard.frames * x.shape[3] * x.shape[4]
        return x * self.block((total / n).to(x.dtype))


class Branch2(nn.Module):
    def __init__(self, dim_in: int, dim_inner: int, dim_out: int, stride, use_se: bool):
        super().__init__()
        self.conv_a = nn.Conv3d(dim_in, dim_inner, 1, bias=False)
        self.norm_a = BatchNorm3d(dim_inner)
        self.conv_b = nn.Conv3d(dim_inner, dim_inner, 3, stride=stride, padding=1,
                                groups=dim_inner, bias=False)
        norm_b = [BatchNorm3d(dim_inner)]
        if use_se:
            norm_b.append(SqueezeExcitation(dim_inner, round_width(dim_inner, SE_RATIO)))
        self.norm_b = nn.Sequential(*norm_b)
        self.conv_c = nn.Conv3d(dim_inner, dim_out, 1, bias=False)
        self.norm_c = BatchNorm3d(dim_out)

    def forward(self, x: torch.Tensor, frame_shard=None) -> torch.Tensor:
        y = F.relu(self.norm_a(self.conv_a(x)))
        if spread(frame_shard):  # temporal stride 1, padding 1: a frame a side
            conv = self.conv_b
            y = F.conv3d(temporal_halo(y, frame_shard, 1), conv.weight, None, conv.stride,
                         (0, *conv.padding[1:]), 1, conv.groups)
        else:
            y = self.conv_b(y)
        y = self.norm_b[0](y)
        if len(self.norm_b) > 1:
            y = self.norm_b[1](y, frame_shard)
        y = y * torch.sigmoid(y)  # Swish
        return self.norm_c(self.conv_c(y))


class X3DBottleneckBlock(nn.Module):
    """The shortcut is projected by a 1x1x1 conv when the width or the
    resolution changes, and normalised only when the width does."""

    def __init__(self, dim_in: int, dim_inner: int, dim_out: int, stride, use_se: bool):
        super().__init__()
        self.branch1_conv = self.branch1_norm = None
        if dim_in != dim_out or math.prod(stride) > 1:
            self.branch1_conv = nn.Conv3d(dim_in, dim_out, 1, stride=stride, bias=False)
            if dim_in != dim_out:
                self.branch1_norm = BatchNorm3d(dim_out)
        self.branch2 = Branch2(dim_in, dim_inner, dim_out, stride, use_se)

    def forward(self, x: torch.Tensor, frame_shard=None) -> torch.Tensor:
        shortcut = x
        if self.branch1_conv is not None:
            shortcut = self.branch1_conv(x)
            if self.branch1_norm is not None:
                shortcut = self.branch1_norm(shortcut)
        return F.relu(shortcut + self.branch2(x, frame_shard))


class StemConv(nn.Module):
    """The stem's two convs, under the reference's swapped names."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv_t = nn.Conv3d(3, dim, (1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1), bias=False)
        self.conv_xy = nn.Conv3d(dim, dim, (5, 1, 1), padding=(2, 0, 0), groups=dim, bias=False)

    def forward(self, x: torch.Tensor, frame_shard=None) -> torch.Tensor:
        y = self.conv_t(x)
        if not spread(frame_shard):
            return self.conv_xy(y)
        conv = self.conv_xy  # 5x1x1, padding 2: two frames a side
        return F.conv3d(temporal_halo(y, frame_shard, 2), conv.weight, None, 1, 0, 1, conv.groups)


class Stem(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = StemConv(dim)
        self.norm = BatchNorm3d(dim)

    def forward(self, x: torch.Tensor, frame_shard=None) -> torch.Tensor:
        return F.relu(self.norm(self.conv(x, frame_shard)))


class Stage(nn.Module):
    def __init__(self, blocks: List[nn.Module]):
        super().__init__()
        self.res_blocks = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor, frame_shard=None) -> torch.Tensor:
        for block in self.res_blocks:
            x = block(x, frame_shard)
        return x


class X3DBackbone(nn.Module):
    """Clips [b, 3, t, H, W] -> four per-frame maps [(b t), C_i, h, w] of
    stages 1-4."""

    def __init__(self, spec: dict):
        super().__init__()
        wf, df = spec["width_factor"], spec["depth_factor"]
        stem_dim = round_width(STEM_WIDTH, wf)
        blocks: List[nn.Module] = [Stem(stem_dim)]
        dim_in = stem_dim
        for base, depth in zip(_stage_bases(), STAGE_DEPTHS):
            dim_out = round_width(base, wf)
            dim_inner = int(2.25 * dim_out)
            blocks.append(Stage([
                X3DBottleneckBlock(dim_in if i == 0 else dim_out, dim_inner, dim_out,
                                   (1, 2, 2) if i == 0 else (1, 1, 1), use_se=(i % 2 == 0))
                for i in range(round_repeats(depth, df))]))
            dim_in = dim_out
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor, frame_shard=None) -> List[torch.Tensor]:
        """``frame_shard``: x holds the rank's frames of the clip (the
        frame-sharded forward)."""
        y = self.blocks[0](x, frame_shard)
        outs = []
        for stage in self.blocks[1:]:
            y = stage(y, frame_shard)
            b, c, t, h, w = y.shape
            outs.append(y.transpose(1, 2).reshape(b * t, c, h, w))
        return outs
