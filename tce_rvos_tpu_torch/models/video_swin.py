"""Video Swin Transformer backbone (t/s/b) (counterpart of
``tce_rvos_tpu/models/video_swin.py``).

  * patch embedding (1, 4, 4): a Conv3d with no temporal stride, so the
    features stay per frame;
  * 3D windows (8, 7, 7) with ``swin.get_window_size``'s shrink rule: at T = 5
    the temporal window is 5 and the temporal shift 0; past 8 frames the
    windows are 8 frames, shifted by 4, T padded to a multiple of 8, with
    the 3D shift mask (``swin.SwinBlock`` over three axes, ``shrink=True``);
  * the relative-position bias of a shrunk window reads the full window's
    index sliced [:n, :n] (``swin.WindowAttention``);
  * under the frame-sharded forward each block takes its windows and
    shift from the whole clip's frame count and gathers the frames of the
    windows the rank's frames fall in (``swin.temporal_window_plan``): up
    to 7 frames beyond each end, the pad, the wrapped first frames; at
    T <= 8 the one temporal window is the whole clip;
  * each stage, its blocks and its output, is the span
    ``tce.model.backbone.stage{i}`` in frames (``swin.stage_span``), as in
    2D Swin;
  * each stage's output is taken before its spatial downsample, and the
    downsamples are hoisted out of the stages as ``downsamples.{i}``, the
    layout of the reference wrapper (video_swin_transformer.py:666-670),
    unlike 2D Swin's ``layers.{i}.downsample``.

A Kinetics-400 checkpoint's (2, 4, 4) patch embedding is summed over its
temporal axis on loading (``utils/checkpoint.py::convert_state_dict``).
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from tce_rvos_tpu_torch.models.layers import run_layer
from tce_rvos_tpu_torch.models.swin import (
    PatchEmbed,
    PatchMerging,
    SwinStage,
    stage_span,
    swin_stages,
)

VIDEO_SWIN_CONFIGS = {
    # the JAX package's video_swin.py:217-222 (reference video_swin_transformer.py:733-779)
    "video_swin_t_p4w7": dict(embed_dim=96, depths=(2, 2, 6, 2),
                              num_heads=(3, 6, 12, 24), drop_path_rate=0.2),
    "video_swin_s_p4w7": dict(embed_dim=96, depths=(2, 2, 18, 2),
                              num_heads=(3, 6, 12, 24), drop_path_rate=0.2),
    "video_swin_b_p4w7": dict(embed_dim=128, depths=(2, 2, 18, 2),
                              num_heads=(4, 8, 16, 32), drop_path_rate=0.2),
}


def video_swin_spec(name: str) -> dict:
    cfg = VIDEO_SWIN_CONFIGS[name]
    return dict(**cfg, window_size=(8, 7, 7), strides=[4, 8, 16, 32],
                channels=[cfg["embed_dim"] * 2**i for i in range(4)])


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

    def forward(self, x: torch.Tensor, frame_shard=None) -> List[torch.Tensor]:
        """``frame_shard``: x holds the rank's frames of the clip (the
        frame-sharded forward); each block gathers the frames of its
        temporal windows (``swin.SwinBlock``), the rest is per frame."""
        b, t = x.shape[0], x.shape[2]
        x = self.patch_embed(x)  # [b, t, h, w, C]
        outs = []
        for i, stage in enumerate(self.layers):
            with stage_span(i, b * t):
                for blk in stage.blocks:
                    x = run_layer(blk, self.use_checkpoint, x, frame_shard)
                outs.append(x.reshape(b * t, *x.shape[2:]).permute(0, 3, 1, 2).contiguous())
            if i < len(self.downsamples):
                x = self.downsamples[i](x)
        return outs
