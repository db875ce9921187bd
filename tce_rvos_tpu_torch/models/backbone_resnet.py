"""ResNet-50 with frozen BatchNorm, NCHW (counterpart of
``tce_rvos_tpu/models/backbone_resnet.py``).

Module names are torchvision's, under the reference's ``backbone.0.body``
prefix, so reference checkpoints and ``utils/convert.py`` load directly.
Returns res2..res5 (strides 4, 8, 16, 32; channels 256, 512, 1024, 2048).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

RESNET50_LAYERS = (3, 4, 6, 3)
RESNET_CHANNELS = (256, 512, 1024, 2048)


class FrozenBatchNorm2d(nn.Module):
    """Per-channel affine from frozen statistics, eps 1e-5 added before the
    rsqrt; the four statistics are buffers, as in the reference."""

    def __init__(self, n: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(n))
        self.register_buffer("bias", torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * (self.running_var + 1e-5).rsqrt()
        shift = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype)[None, :, None, None] + shift.to(x.dtype)[None, :, None, None]


class Bottleneck(nn.Module):
    """torchvision v1.5 bottleneck: 1x1 -> 3x3 (stride) -> 1x1 (x4)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
            FrozenBatchNorm2d(planes * 4),
        ) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        inplanes = 64
        for stage, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512), RESNET50_LAYERS)):
            stride = 1 if stage == 0 else 2
            blocks = []
            for b in range(n_blocks):
                blocks.append(Bottleneck(inplanes, planes, stride if b == 0 else 1,
                                         downsample=(b == 0)))
                inplanes = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
            outs.append(x)
        return outs


class Backbone(nn.Module):
    """The reference's ``backbone.0``: the ResNet under ``body``."""

    def __init__(self):
        super().__init__()
        self.body = ResNet()

    def forward(self, frames: torch.Tensor) -> List[torch.Tensor]:
        """frames [N, 3, H, W] -> res2..res5, each [N, C, h, w]."""
        return self.body(frames)
