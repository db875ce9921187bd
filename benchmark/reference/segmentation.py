"""Cross-modal segmentation head and its losses (counterpart of
``tce_rvos_tpu/models/segmentation.py``).

  * ``VisionLanguageFusionModule``: vision queries attend to the text; the
    output gates the vision features multiplicatively;
  * ``VisionLanguageBlock``: FPN-level block, spatially reduced
    self-attention over the whole clip, cross-attention to the text, FFN,
    with dropout 0.1 (fixed, as in the JAX package);
  * ``CrossModalFPNDecoder``: lateral and output convs over [res2, encoder
    memory at 8x, 16x, 32x] with top-down nearest upsampling, giving the
    stride-4 mask features;
  * ``dice_loss`` and ``sigmoid_focal_loss``, the criterion's mask and
    class losses.

Convolutions work on NCHW; the V-L blocks take channel-last clips
[b, t, h, w, C] like the JAX module.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (
    GroupNorm,
    MultiheadAttention,
    ffn,
    layer_norm,
    with_pos,
)
from .interpolate import resize_bilinear, resize_nearest


def _cl_resize(x: torch.Tensor, size, fn, **kw) -> torch.Tensor:
    """Resize a channel-last [..., h, w, C] tensor with a channel-first
    resize ``fn``."""
    return fn(x.movedim(-1, -3), size, **kw).movedim(-3, -1)


class VisionLanguageFusionModule(nn.Module):
    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.multihead_attn = MultiheadAttention(d_model, nhead)

    def forward(self, tgt, memory, memory_key_padding_mask=None, pos=None, query_pos=None):
        """tgt [b, S_vis, C], memory [b, S_txt, C] -> [b, S_vis, C]."""
        attn_out = self.multihead_attn(
            with_pos(tgt, query_pos), with_pos(memory, pos), memory,
            key_padding_mask=memory_key_padding_mask)
        return tgt * attn_out


class VisionLanguageBlock(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, activation: str = "relu", sr_ratio: int = 1):
        super().__init__()
        self.sr_ratio = sr_ratio
        self.activation = activation
        self.self_attn = MultiheadAttention(d_model, nhead, dropout)
        self.multihead_attn = MultiheadAttention(d_model, nhead, dropout)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)
        self.norm3 = layer_norm(d_model)
        self.dropout = nn.Dropout(dropout)

    def forward(self, tgt, memory, tgt_key_padding_mask, memory_key_padding_mask,
                pos, query_pos):
        """tgt, query_pos [b, t, h, w, C]; tgt_key_padding_mask [b, t, h, w];
        memory, pos [b, S_txt, C]."""
        b, t, h, w, c = tgt.shape
        q = k = with_pos(tgt, query_pos)
        v = tgt
        kpm = tgt_key_padding_mask
        nh, nw = h, w
        if self.sr_ratio > 1:
            nh, nw = int(h / self.sr_ratio), int(w / self.sr_ratio)
            q = k = _cl_resize(q, (nh, nw), resize_nearest)
            v = _cl_resize(v, (nh, nw), resize_nearest)
            kpm = resize_nearest(kpm.float(), (nh, nw)).bool()
        sq = t * nh * nw
        sk = k.shape[1] * nh * nw  # the whole clip's keys
        tgt2 = self.self_attn(q.reshape(b, sq, c), k.reshape(b, sk, c), v.reshape(b, sk, c),
                              key_padding_mask=kpm.reshape(b, sk))
        tgt2 = tgt2.reshape(b, t, nh, nw, c)
        if self.sr_ratio > 1:
            tgt2 = _cl_resize(tgt2, (h, w), resize_bilinear, align_corners=False)
        tgt = self.norm1(tgt + self.dropout(tgt2))

        s = t * h * w
        tgt2 = self.multihead_attn(
            with_pos(tgt, query_pos).reshape(b, s, c), with_pos(memory, pos), memory,
            key_padding_mask=memory_key_padding_mask,
        ).reshape(b, t, h, w, c)
        tgt = self.norm2(tgt + self.dropout(tgt2))
        return ffn(tgt, self.linear1, self.linear2, self.norm3, self.dropout, self.activation)


class Conv2d(nn.Conv2d):
    """The reference's conv wrapper: a conv with an optional GroupNorm(8)
    under ``norm`` (the conv then has no bias) and an optional ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, norm: bool = True,
                 act: bool = False):
        super().__init__(in_ch, out_ch, kernel, padding=kernel // 2, bias=not norm)
        self.norm = GroupNorm(8, out_ch) if norm else None
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = super().forward(x)
        if self.norm is not None:
            x = self.norm(x)
        return F.relu(x) if self.act else x


class CrossModalFPNDecoder(nn.Module):
    """Top-down FPN over [res2, memory 8x, 16x, 32x] with per-level V-L
    blocks (none with ``vlblock=False``); stage s = 1..4 from 4x to 32x,
    sr_ratios (8, 4, 2, 1)."""

    SR_RATIOS = (8, 4, 2, 1)

    def __init__(self, conv_dim: int, mask_dim: int, dim_feedforward: int = 2048,
                 res2_channels: int = 256, vlblock: bool = True):
        super().__init__()
        self.conv_dim = conv_dim
        self.vlblock = vlblock
        for stage in range(1, 5):
            in_ch = res2_channels if stage == 1 else conv_dim
            setattr(self, f"adapter_{stage}", Conv2d(in_ch, conv_dim, 1))
            setattr(self, f"layer_{stage}", Conv2d(conv_dim, conv_dim, 3, act=True))
            if vlblock:
                setattr(self, f"cross_attn_{stage}", VisionLanguageBlock(
                    conv_dim, 8, dim_feedforward, sr_ratio=self.SR_RATIOS[stage - 1]))
        self.mask_features = Conv2d(conv_dim, mask_dim, 3, norm=False)

    def _stage(self, stage, x, x_mask, pos, y, nf, text_features, text_pad_mask, text_pos,
               ):
        n, _, h, w = x.shape
        b, t, c = n // nf, nf, self.conv_dim
        vis = getattr(self, f"adapter_{stage}")(x)
        if self.vlblock:
            vis = getattr(self, f"cross_attn_{stage}")(
                vis.permute(0, 2, 3, 1).reshape(b, t, h, w, c),
                text_features, x_mask.reshape(b, t, h, w), text_pad_mask, text_pos,
                pos.reshape(b, t, h, w, c),
            ).reshape(n, h, w, c).permute(0, 3, 1, 2)
        if y is not None:
            vis = vis + resize_nearest(y, (h, w))
        return getattr(self, f"layer_{stage}")(vis)

    def forward(
        self,
        features: Sequence,                  # 4 x (feat [N, C_i, H, W], mask [N, H, W])
        text_features: torch.Tensor,         # [b, S_txt, C]
        text_pad_mask: torch.Tensor,         # [b, S_txt]
        text_pos: torch.Tensor,              # [b, S_txt, C]
        poses: Sequence[torch.Tensor],       # 4 x [N, H, W, C]
        memory: Sequence[torch.Tensor],      # 3 x [N, C, h, w] 8x -> 32x
        nf: int,
    ) -> torch.Tensor:
        y = None
        items = list(zip(memory[::-1], features[1:][::-1], poses[1:][::-1]))
        for idx, (mem, feat, pos) in enumerate(items):
            y = self._stage(4 - idx, mem, feat[1], pos, y, nf,
                            text_features, text_pad_mask, text_pos)
        x, x_mask = features[0]
        y = self._stage(1, x, x_mask, poses[0], y, nf, text_features, text_pad_mask, text_pos)
        return self.mask_features(y)


def dice_loss(inputs: torch.Tensor, targets: torch.Tensor, num_boxes) -> torch.Tensor:
    """Dice loss of mask logits [N, ...] against binary targets, flattened
    per instance, summed over instances and divided by ``num_boxes``."""
    probs = torch.sigmoid(inputs).reshape(inputs.shape[0], -1)
    targets = targets.reshape(targets.shape[0], -1)
    numerator = 2.0 * (probs * targets).sum(1)
    denominator = probs.sum(-1) + targets.sum(-1)
    loss = 1.0 - (numerator + 1.0) / (denominator + 1.0)
    return loss.sum() / num_boxes


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy with logits, in the JAX package's stable form."""
    return logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(inputs: torch.Tensor, targets: torch.Tensor, num_boxes,
                       alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Focal loss of logits [N, K] against targets of the same shape: mean
    over the last axis, summed over instances, divided by ``num_boxes``."""
    prob = torch.sigmoid(inputs)
    p_t = prob * targets + (1 - prob) * (1 - targets)
    loss = sigmoid_ce(inputs, targets) * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss.mean(1).sum() / num_boxes
