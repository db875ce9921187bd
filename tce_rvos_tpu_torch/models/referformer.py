"""ReferFormer / TCE-RVOS model assembly (counterpart of
``tce_rvos_tpu/models/referformer.py``).

Pipeline: backbone (b*t frames) -> per-level input_proj + early V-L fusion
-> deformable transformer (FTF encoder, IQT decoder) -> class and box heads
-> cross-modal FPN -> dynamic mask head.

Public layouts are the JAX package's: video [b, t, H, W, 3], masks
[b, t, H, W] True on padding, outputs as ``tce_rvos_tpu/infer.py`` returns
them. Inside, features are NCHW.

The serving split: ``backbone_only=True`` returns the text-independent
feature pyramid; ``precomputed_feats`` skips the backbone, and when the text
batch b is E times the video batch, the video-side tensors are tiled E times
so the text-conditioned trunk runs all expressions in one batch.

By default only what inference reads is computed: the last decoder layer's
classes, boxes and masks, the reference points and the top-30 sampling
locations. ``aux_outputs=True`` (set by the train step when
``cfg.aux_loss``) adds the classes, boxes and masks of every other decoder
layer under ``"aux_outputs"``, for the criterion's ``_i`` losses; serving
never pays for them. ``cfg.freeze_text_encoder`` stops the gradient at the
text encoder's outputs. Not ported yet: the A2D ``valid_indices`` path, ``vis_loss`` and
``contrastive`` heads, and the non-ResNet backbones.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from tce_rvos_tpu_torch.config import NUM_CLASSES, ModelConfig
from tce_rvos_tpu_torch.models.backbone_resnet import RESNET_CHANNELS, Backbone
from tce_rvos_tpu_torch.models.dynamic_head import (
    dynamic_head_param_counts,
    dynamic_mask_with_coords,
)
from tce_rvos_tpu_torch.models.layers import (
    MLP,
    FeatureResizer,
    GroupNorm,
    MultiheadAttention,
)
from tce_rvos_tpu_torch.models.position_encoding import sine_pos_1d, sine_pos_2d
from tce_rvos_tpu_torch.models.segmentation import (
    CrossModalFPNDecoder,
    VisionLanguageFusionModule,
)
from tce_rvos_tpu_torch.models.text_encoder import RobertaModel
from tce_rvos_tpu_torch.models.transformer import (
    DeformableTransformer,
    MSDeformAttn,
    xavier_,
)
from tce_rvos_tpu_torch.utils.boxes import inverse_sigmoid
from tce_rvos_tpu_torch.utils.interpolate import resize_mask_nearest


class ReferFormer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.hidden_dim
        channels = RESNET_CHANNELS
        self.backbone = nn.ModuleList([Backbone()])
        self.text_encoder = RobertaModel(
            hidden=cfg.text_encoder_hidden, layers=cfg.text_encoder_layers,
            heads=cfg.text_encoder_heads, intermediate=cfg.text_encoder_intermediate)
        self.resizer = FeatureResizer(cfg.text_encoder_hidden, c, dropout=0.1)
        self.fusion_module = VisionLanguageFusionModule(c, 8)
        projs = [nn.Sequential(nn.Conv2d(ch, c, 1), GroupNorm(32, c)) for ch in channels[-3:]]
        for lvl in range(3, cfg.num_feature_levels):
            in_ch = channels[-1] if lvl == 3 else c
            projs.append(nn.Sequential(nn.Conv2d(in_ch, c, 3, stride=2, padding=1),
                                       GroupNorm(32, c)))
        self.input_proj = nn.ModuleList(projs)
        self.query_embed = nn.Embedding(cfg.num_queries, c)
        self.transformer = DeformableTransformer(
            d_model=c, nhead=cfg.nheads, num_encoder_layers=cfg.enc_layers,
            num_decoder_layers=cfg.dec_layers, dim_feedforward=cfg.dim_feedforward,
            num_feature_levels=cfg.num_feature_levels, dec_n_points=cfg.dec_n_points,
            enc_n_points=cfg.enc_n_points, q_trans=cfg.qtrans, f_token=cfg.f_token,
            with_box_refine=cfg.with_box_refine, dropout=cfg.dropout,
            use_checkpoint=cfg.use_checkpoint, msda_3d=cfg.msda_3d)
        n_heads = cfg.dec_layers if cfg.with_box_refine else 1
        self.class_embed = nn.ModuleList(nn.Linear(c, NUM_CLASSES) for _ in range(n_heads))
        self.bbox_embed = nn.ModuleList(MLP(c, c, 4, 3) for _ in range(n_heads))
        weight_nums, bias_nums = dynamic_head_param_counts(
            cfg.mask_dim, cfg.dynamic_mask_channels, cfg.controller_layers)
        self.controller = MLP(c, c, sum(weight_nums) + sum(bias_nums), 3)
        self.pixel_decoder = CrossModalFPNDecoder(
            c, cfg.mask_dim, cfg.dim_feedforward, res2_channels=channels[0])

    # ------------------------------------------------------------------
    def forward(
        self,
        video: Optional[torch.Tensor],        # [bv, t, H, W, 3] normalised
        video_mask: torch.Tensor,             # [bv, t, H, W] True=pad
        text_ids: Optional[torch.Tensor] = None,       # [b, S] int
        text_attn_mask: Optional[torch.Tensor] = None,  # [b, S] 1=token
        sizes: Optional[torch.Tensor] = None,  # [bv, 2] (h, w) unpadded size
        precomputed_feats: Optional[Sequence[torch.Tensor]] = None,
        backbone_only: bool = False,
        aux_outputs: bool = False,
    ):
        cfg = self.cfg
        c = cfg.hidden_dim
        bv, t = video_mask.shape[0], video_mask.shape[1]
        b = bv if text_ids is None else text_ids.shape[0]

        if precomputed_feats is None:
            frames = video.reshape((bv * t,) + tuple(video.shape[2:])).permute(0, 3, 1, 2)
            feats = self.backbone[0](frames)
            if backbone_only:
                return feats
        else:
            feats = list(precomputed_feats)
        if b != bv:  # expression batching: tile the video side E times
            if b % bv:
                raise ValueError(f"text batch {b} is not a multiple of video batch {bv}")
            e = b // bv
            feats = [f.repeat(e, 1, 1, 1) for f in feats]
            video_mask = video_mask.repeat(e, 1, 1, 1)
            sizes = sizes.repeat(e, 1)
        frame_mask = video_mask.reshape((b * t,) + tuple(video_mask.shape[2:]))
        feat_masks = [resize_mask_nearest(frame_mask, tuple(f.shape[-2:])) for f in feats]
        poses = [sine_pos_2d(m, num_pos_feats=c // 2) for m in feat_masks]

        # ---- text ----
        text_hidden, text_pooled = self.text_encoder(text_ids, text_attn_mask)
        if cfg.freeze_text_encoder:
            text_hidden, text_pooled = text_hidden.detach(), text_pooled.detach()
        text_features = self.resizer(text_hidden)   # [b, S, c]
        text_sentence = self.resizer(text_pooled)   # [b, c]
        text_pad_mask = text_attn_mask == 0
        text_pos = sine_pos_1d(text_pad_mask, num_pos_feats=c)

        def fuse(x):  # [(b t), c, h, w]
            n, _, h, w = x.shape
            seq = x.flatten(2).transpose(1, 2).reshape(b, t * h * w, c)
            seq = self.fusion_module(seq, text_features, text_pad_mask, pos=text_pos)
            return seq.reshape(n, h * w, c).transpose(1, 2).reshape(n, c, h, w)

        # ---- per-level projection + early fusion ----
        srcs, masks_l = [], []
        for lvl, feat in enumerate(feats[-3:]):
            srcs.append(fuse(self.input_proj[lvl](feat)))
            masks_l.append(feat_masks[len(feats) - 3 + lvl])
        for lvl in range(3, cfg.num_feature_levels):
            src_in = feats[-1] if lvl == 3 else srcs[-1]
            proj = self.input_proj[lvl](src_in)
            m = resize_mask_nearest(frame_mask, tuple(proj.shape[-2:]))
            srcs.append(fuse(proj))
            masks_l.append(m)
            poses.append(sine_pos_2d(m, num_pos_feats=c // 2))

        # ---- transformer ----
        q = cfg.num_queries
        text_embed = text_sentence[:, None, None, :].expand(b, t, q, c)
        tr = self.transformer(
            srcs, text_embed, masks_l, poses[len(feats) - 3:][: cfg.num_feature_levels],
            self.query_embed.weight,
            bbox_embed=self.bbox_embed if cfg.with_box_refine else None)
        # ---- segmentation ----
        mask_features = self.pixel_decoder(
            list(zip(feats, feat_masks)), text_features, text_pad_mask, text_pos,
            poses[:4], tr["memory_features"], t)
        mask_features = mask_features.reshape((b, t) + tuple(mask_features.shape[1:]))

        def layer_outputs(lvl):
            """Classes [b, t, q, K], boxes [b, t, q, 4] and masks
            [b, t, q, h, w] of decoder layer ``lvl``."""
            hs = tr["hs"][lvl]
            logits = self.class_embed[lvl if cfg.with_box_refine else 0](hs)
            if cfg.with_box_refine:
                boxes = tr["coords"][lvl]
            else:
                tmp = self.bbox_embed[0](hs)
                ref = inverse_sigmoid(tr["init_reference"])
                boxes = torch.sigmoid(torch.cat([tmp[..., :2] + ref, tmp[..., 2:]], -1))
            params = self.controller(hs).reshape(b, t, q, -1)
            refs = tr["inter_references"][lvl][..., :2].reshape(b, t, q, 2)
            masks = dynamic_mask_with_coords(
                mask_features, params, refs, sizes, channels=cfg.dynamic_mask_channels,
                num_layers=cfg.controller_layers)
            return {"pred_logits": logits.reshape(b, t, q, -1),
                    "pred_boxes": boxes.reshape(b, t, q, 4), "pred_masks": masks}

        ref_vis = (tr["inter_references"][-2][..., :2] if cfg.dec_layers > 1
                   else tr["init_reference"])
        out = layer_outputs(cfg.dec_layers - 1)
        out.update({
            "reference_points": ref_vis.reshape(b, t, q, 2),
            "inter_samples": tr["inter_samples"],          # [l, b*t, q, 30, 2]
            "memory": tr["memory"],
        })
        if aux_outputs:
            out["aux_outputs"] = [layer_outputs(lvl) for lvl in range(cfg.dec_layers - 1)]
        return out


def init_weights(model: ReferFormer, generator: torch.Generator) -> None:
    """Seeded random initialisation with the JAX package's initialisers:
    lecun-normal linears and convs, zero biases, identity frozen BatchNorm,
    the MSDA layout (zero offset/weight kernels, directional offset bias),
    N(0, 1) level and query embeddings, the focal-loss class prior and
    zero last bbox layers (bias -2 on w, h for the first)."""
    g = generator
    cfg = model.cfg

    def lecun_(w):
        w.normal_(0.0, 1.0 / math.sqrt(w[0].numel()), generator=g)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                lecun_(mod.weight)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.weight.shape[1]), generator=g)
            elif isinstance(mod, MultiheadAttention):
                lecun_(mod.in_proj_weight)
                mod.in_proj_bias.zero_()
        for mod in model.modules():
            if isinstance(mod, MSDeformAttn):
                mod.reset_parameters(g)
        tr = model.transformer
        xavier_(tr.reference_points.weight, g)
        tr.level_embed.normal_(0.0, 1.0, generator=g)
        model.query_embed.weight.normal_(0.0, 1.0, generator=g)
        if cfg.f_token > 0:
            std = math.sqrt(2.0 / cfg.f_token)
            tr.encoder.memory_bus.normal_(0.0, std, generator=g)
            tr.encoder.memory_pos.normal_(0.0, std, generator=g)
        prior = -math.log((1 - 0.01) / 0.01)
        for head in model.class_embed:
            head.bias.fill_(prior)
        for i, mlp in enumerate(model.bbox_embed):
            mlp.layers[-1].weight.zero_()
            mlp.layers[-1].bias.zero_()
            if i == 0:
                mlp.layers[-1].bias[2:] = -2.0
