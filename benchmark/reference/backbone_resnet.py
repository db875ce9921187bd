"""The ResNet family: ResNet-50/101 with frozen BatchNorm, NCHW
(counterpart of ``tce_rvos_tpu/models/backbone_resnet.py``), on frames.

Module names are torchvision's, under the reference's ``backbone.0.body``
prefix, so reference checkpoints and ``utils/convert.py`` load directly.
Returns res2..res5 (strides 4, 8, 16, 32; channels 256, 512, 1024, 2048).

DC5 (``dilation``) as the JAX package has it: layer4 at stride 1 with
dilation 2 in every block, its first included. torchvision keeps the first
block of a dilated stage at its previous dilation (1); the port follows the
JAX package (ROADMAP.md, section C).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import conv_out

CONFIGS = {
    "resnet50": dict(layers=(3, 4, 6, 3)),
    "resnet101": dict(layers=(3, 4, 23, 3)),
}
TEMPORAL = False
DILATION = True
CHANNELS = (256, 512, 1024, 2048)


def build(name: str, cfg):
    """(the ResNet, the strides and channels of res2..res5); DC5 halves the
    last stride."""
    strides = [4, 8, 16, 32]
    if cfg.dilation:
        strides[-1] //= 2
    return ResNet(CONFIGS[name]["layers"], cfg.dilation), strides, list(CHANNELS)


def channels(name: str) -> List[int]:
    return list(CHANNELS)


def flops(name: str, cfg: dict, t: int, hw: Tuple[int, int]
          ) -> Tuple[float, float, List[Tuple[int, int]]]:
    """(FLOPs of t frames, FLOPs of the first convolution, res2..res5 sizes)."""
    layers = CONFIGS[name]["layers"]
    h, w = conv_out(hw[0], 7, 2, 3), conv_out(hw[1], 7, 2, 3)
    first = 2.0 * h * w * 64 * 3 * 49
    total = first
    h, w = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1)
    inplanes, sizes = 64, []
    for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
        stride, dil = (1 if stage == 0 else 2), 1
        if stage == 3 and cfg.get("dilation"):
            stride, dil = 1, 2
        for b in range(blocks):
            s = stride if b == 0 else 1
            oh, ow = conv_out(h, 3, s, dil, dil), conv_out(w, 3, s, dil, dil)
            total += 2.0 * h * w * inplanes * planes                  # 1x1
            total += 2.0 * oh * ow * planes * planes * 9               # 3x3
            total += 2.0 * oh * ow * planes * planes * 4               # 1x1 to 4x
            if b == 0:
                total += 2.0 * oh * ow * inplanes * planes * 4         # downsample
            h, w, inplanes = oh, ow, planes * 4
        sizes.append((h, w))
    return t * total, t * first, sizes


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
    """torchvision v1.5 bottleneck: 1x1 -> 3x3 (stride, dilation) -> 1x1 (x4)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=dilation,
                               dilation=dilation, bias=False)
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
    """``layers``: blocks per stage, (3, 4, 6, 3) for ResNet-50 and
    (3, 4, 23, 3) for ResNet-101; ``dilation``: DC5."""

    def __init__(self, layers=CONFIGS["resnet50"]["layers"], dilation: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        inplanes = 64
        for stage, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride, dil = (1 if stage == 0 else 2), 1
            if stage == 3 and dilation:
                stride, dil = 1, 2
            blocks = []
            for b in range(n_blocks):
                blocks.append(Bottleneck(inplanes, planes, stride if b == 0 else 1,
                                         downsample=(b == 0), dilation=dil))
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
