"""The Swin family: the image Swin Transformer backbone (t/s/b/l)
(counterpart of ``tce_rvos_tpu/models/swin.py``), on frames, as ReferFormer
runs it (``--backbone swin_l_p4w7``; its ``models/swin_transformer.py``, the
detection variant with padding and ``out_indices`` (0, 1, 2, 3)).

  * patch embedding: a Conv2d 4x4 at stride 4 over the frame padded to
    multiples of 4, then LayerNorm (``patch_norm``); no absolute position
    embedding (``ape`` False);
  * 2D windows of 7x7, shifted by 3 on odd blocks; each block pads H and W
    with zeros to whole windows and crops after (``swin.SwinBlock`` over two
    axes, ``shrink=False``: no window shrinks, whatever the map's size);
  * each stage's output is taken before its downsample, through its
    LayerNorm ``norm{i}``; the downsample is the stage's own
    (``layers.{i}.downsample``), the reference's keys.

Departures from ReferFormer's ``swin_transformer.py``:

  * the benchmark computes this reference in the configuration's precision
    (bf16) with the port's mixed-precision rules, as for every
    configuration (``harness/check.py``), not in float32;
  * LayerNorm eps 1e-6, flax's default, which the JAX package and the port
    keep, where torch's ``nn.LayerNorm`` default is 1e-5;
  * the shifted-window mask (-100 between tokens of a window from different
    regions) is built in each shifted block from the tokens' region labels,
    where the reference builds it once a stage: the same values;
  * ``relative_position_index`` is a non-persistent buffer, so it is not a
    key of the state dict;
  * the windows' attention runs in chunks of at most ``ATTN_LOGITS_CHUNK``
    logits: the windows are independent, so it is the same function;
  * the attention and MLP dropout rates are 0, so there is no dropout
    module; DropPath draws from torch's generator (serving runs in eval
    mode, where it is the identity);
  * weights are drawn from the run's seed (``harness/weights.py``), not the
    ImageNet-22K checkpoint.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from . import swin
from .layers import layer_norm, run_layer
from .swin import PatchEmbed, PatchMerging, SwinStage, swin_stages

CONFIGS = {
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
TEMPORAL = False
WINDOW = 7
init_module = swin.init_module  # the window attentions' relative-position bias tables


def channels(name: str) -> List[int]:
    return [CONFIGS[name]["embed_dim"] * 2**i for i in range(4)]


def build(name: str, cfg):
    """(the network, the strides and channels of its four maps)."""
    spec = dict(**CONFIGS[name], window_size=WINDOW, channels=channels(name))
    body = SwinBackbone(spec, use_checkpoint=cfg.use_checkpoint)
    return body, [4, 8, 16, 32], spec["channels"]


def flops(name: str, cfg: dict, t: int, hw: Tuple[int, int]
          ) -> Tuple[float, float, List[Tuple[int, int]]]:
    """Swin on t frames: the 4x4 patch embedding; per block the qkv, proj
    and MLP products of every unpadded token and q k^T and attention times
    v over its 7x7 window's 49 tokens; the patch mergings, 4C to 2C."""
    c, depths = CONFIGS[name]["embed_dim"], CONFIGS[name]["depths"]
    n = WINDOW * WINDOW
    h, w = -(-hw[0] // 4), -(-hw[1] // 4)
    first = 2.0 * t * h * w * c * 3 * 16
    total, sizes = first, []
    for i, depth in enumerate(depths):
        n_tok = t * h * w
        total += depth * (2.0 * n_tok * c * 12 * c + 4.0 * n_tok * n * c)
        sizes.append((h, w))
        if i < len(depths) - 1:
            h, w = -(-h // 2), -(-w // 2)
            total += 2.0 * t * h * w * 4 * c * 2 * c
            c *= 2
    return total, first, sizes


class SwinBackbone(nn.Module):
    """Frames [N, 3, H, W] -> four maps [N, C_i, h, w] (strides 4, 8, 16,
    32), each through its stage's LayerNorm (``norm{i}``)."""

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
        x = self.patch_embed(x)  # [N, h, w, C]
        outs = []
        for i, stage in enumerate(self.layers):
            for blk in stage.blocks:
                x = run_layer(blk, self.use_checkpoint, x)
            outs.append(getattr(self, f"norm{i}")(x).permute(0, 3, 1, 2).contiguous())
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs
