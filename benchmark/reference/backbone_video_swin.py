"""The Video-Swin family: the Video Swin Transformer backbone (t/s/b)
(counterpart of ``tce_rvos_tpu/models/video_swin.py``), on clips.

  * patch embedding (1, 4, 4): a Conv3d with no temporal stride, so the
    features stay per frame;
  * 3D windows (8, 7, 7) with ``swin.get_window_size``'s shrink rule: at T = 5
    the temporal window is 5 and the temporal shift 0; past 8 frames the
    windows are 8 frames, shifted by 4, T padded to a multiple of 8, with
    the 3D shift mask (``swin.SwinBlock`` over three axes, ``shrink=True``);
  * the relative-position bias of a shrunk window reads the full window's
    index sliced [:n, :n] (``swin.WindowAttention``);
  * each stage's output is taken before its spatial downsample, and the
    downsamples are hoisted out of the stages as ``downsamples.{i}``, the
    layout of the reference wrapper (video_swin_transformer.py:666-670),
    unlike 2D Swin's ``layers.{i}.downsample``.

A Kinetics-400 checkpoint's (2, 4, 4) patch embedding is summed over its
temporal axis on loading (``utils/checkpoint.py::convert_state_dict``).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
from torch import nn

from . import swin
from .layers import run_layer
from .swin import PatchEmbed, PatchMerging, SwinStage, swin_stages

CONFIGS = {
    # the JAX package's video_swin.py:217-222 (reference video_swin_transformer.py:733-779)
    "video_swin_t_p4w7": dict(embed_dim=96, depths=(2, 2, 6, 2),
                              num_heads=(3, 6, 12, 24), drop_path_rate=0.2),
    "video_swin_s_p4w7": dict(embed_dim=96, depths=(2, 2, 18, 2),
                              num_heads=(3, 6, 12, 24), drop_path_rate=0.2),
    "video_swin_b_p4w7": dict(embed_dim=128, depths=(2, 2, 18, 2),
                              num_heads=(4, 8, 16, 32), drop_path_rate=0.2),
}
TEMPORAL = True
WINDOW = (8, 7, 7)
init_module = swin.init_module  # the window attentions' relative-position bias tables


def channels(name: str) -> List[int]:
    return [CONFIGS[name]["embed_dim"] * 2**i for i in range(4)]


def build(name: str, cfg):
    """(the network, the strides and channels of its four maps)."""
    spec = dict(**CONFIGS[name], window_size=WINDOW, channels=channels(name))
    body = VideoSwinBackbone(spec, use_checkpoint=cfg.use_checkpoint)
    return body, [4, 8, 16, 32], spec["channels"]


def flops(name: str, cfg: dict, t: int, hw: Tuple[int, int]
          ) -> Tuple[float, float, List[Tuple[int, int]]]:
    """Video-Swin on one clip of t frames: the (1, 4, 4) patch embedding;
    per block the qkv, proj and MLP products of every (unpadded) token and
    q k^T and attention times v over its window's n tokens (Video-Swin's
    shrink rule: an axis no longer than the window is the window); the
    patch mergings, 4C to 2C."""
    c, depths = CONFIGS[name]["embed_dim"], CONFIGS[name]["depths"]
    h, w = -(-hw[0] // 4), -(-hw[1] // 4)
    first = 2.0 * t * h * w * c * 3 * 16
    total, sizes = first, []
    for i, depth in enumerate(depths):
        n_tok = t * h * w
        window = math.prod(min(size, win) for size, win in zip((t, h, w), WINDOW))
        total += depth * (2.0 * n_tok * c * (3 * c + c + 8 * c) + 4.0 * n_tok * window * c)
        sizes.append((h, w))
        if i < len(depths) - 1:
            h, w = -(-h // 2), -(-w // 2)
            total += 2.0 * t * h * w * 4 * c * 2 * c
            c *= 2
    return total, first, sizes


class VideoSwinBackbone(nn.Module):
    """Clips [b, 3, t, H, W] -> four per-frame maps [(b t), C_i, h, w]
    (strides 4, 8, 16, 32), each taken before the stage's downsample."""

    def __init__(self, spec: dict, use_checkpoint: bool = False):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        dims = spec["channels"]
        self.patch_embed = PatchEmbed(nn.Conv3d(3, dims[0], (1, 4, 4), stride=(1, 4, 4)), dims[0])
        self.layers = nn.ModuleList(SwinStage(blocks) for blocks in swin_stages(spec, shrink=True))
        self.downsamples = nn.ModuleList(PatchMerging(d) for d in dims[:-1])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        b, t = x.shape[0], x.shape[2]
        x = self.patch_embed(x)  # [b, t, h, w, C]
        outs = []
        for i, stage in enumerate(self.layers):
            for blk in stage.blocks:
                x = run_layer(blk, self.use_checkpoint, x)
            outs.append(x.reshape(b * t, *x.shape[2:]).permute(0, 3, 1, 2).contiguous())
            if i < len(self.downsamples):
                x = self.downsamples[i](x)
        return outs
