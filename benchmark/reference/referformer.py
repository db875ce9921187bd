"""Frozen reference copy of the port's ReferFormer / TCE-RVOS model, in
plain PyTorch: backbone (a family of ``backbones.py``, found by the
configuration's name: ResNet-50/101 on the b*t frames, Video-Swin on the b
clips) -> per-level input_proj + early V-L fusion -> deformable
transformer (FTF encoder, IQT decoder) -> class and box heads -> cross-modal
FPN -> dynamic mask head.

Layouts: video [b, t, H, W, 3], masks [b, t, H, W] True on padding.
``backbone_only`` returns the text-independent feature pyramid and
``precomputed_feats`` skips the backbone; a text batch E times the video
batch tiles the video side E times. ``aux_outputs`` adds the other decoder
layers' classes, boxes and masks for the criterion. Only the MSDA differs
from the port: a plain gather (``msda.py``), with no kernel.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
from torch import nn

from .backbones import family
from .config import ModelConfig
from .dynamic_head import (
    dynamic_head_param_counts,
    dynamic_mask_with_coords,
)
from .layers import (
    MLP,
    FeatureResizer,
    GroupNorm,
    MultiheadAttention,
)
from .position_encoding import sine_pos_1d, sine_pos_2d
from .segmentation import (
    CrossModalFPNDecoder,
    VisionLanguageFusionModule,
)
from .text_encoder import RobertaModel
from .transformer import (
    DeformableTransformer,
    MSDeformAttn,
    xavier_,
)
from .boxes import inverse_sigmoid
from .interpolate import resize_mask_nearest


def check_backbone(cfg: ModelConfig) -> None:
    """Raises ``ValueError`` naming the flag for a backbone name that no
    family builds, and for DC5 (``--dilation``) on a backbone whose family
    does not take it (only ResNet's does)."""
    fam = family(cfg.backbone)
    if cfg.dilation and not getattr(fam, "DILATION", False):
        raise ValueError(f"--dilation: DC5 is a ResNet option, not one of {cfg.backbone!r}")


def build_backbone_module(cfg: ModelConfig):
    """(the backbone network, its strides, its channels, whether it is
    temporal: takes clips [b, 3, t, H, W] rather than frames)."""
    check_backbone(cfg)
    fam = family(cfg.backbone)
    body, strides, channels = fam.build(cfg.backbone, cfg)
    return body, strides, channels, fam.TEMPORAL


class Backbone(nn.Module):
    """The reference's ``backbone.0``: the backbone network under ``body``."""

    def __init__(self, body: nn.Module):
        super().__init__()
        self.body = body

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """frames [N, 3, H, W] (a temporal body: clips [b, 3, t, H, W]) ->
        four maps, each [N, C, h, w] (N = b t)."""
        return self.body(x)


class ReferFormer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.hidden_dim
        body, _, channels, self.temporal_backbone = build_backbone_module(cfg)
        self.backbone = nn.ModuleList([Backbone(body)])
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
        self.class_embed = nn.ModuleList(nn.Linear(c, cfg.num_classes) for _ in range(n_heads))
        if cfg.vis_loss:
            self.visible_embed = nn.ModuleList(nn.Linear(c, 1) for _ in range(n_heads))
        self.bbox_embed = nn.ModuleList(MLP(c, c, 4, 3) for _ in range(n_heads))
        weight_nums, bias_nums = dynamic_head_param_counts(
            cfg.mask_dim, cfg.dynamic_mask_channels, cfg.controller_layers, cfg.rel_coord)
        self.controller = MLP(c, c, sum(weight_nums) + sum(bias_nums), 3)
        self.pixel_decoder = CrossModalFPNDecoder(
            c, cfg.mask_dim, cfg.dim_feedforward, res2_channels=channels[0],
            vlblock=cfg.vlblock)

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
        valid_indices: Optional[torch.Tensor] = None,  # [b] (a2d/jhmdb: t -> 1)
    ):
        cfg = self.cfg
        c = cfg.hidden_dim
        bv, t = video_mask.shape[0], video_mask.shape[1]
        b = bv if text_ids is None else text_ids.shape[0]

        if precomputed_feats is None:
            if self.temporal_backbone:  # clips [bv, 3, t, H, W]
                feats = self.backbone[0](video.permute(0, 4, 1, 2, 3))
            else:
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
        if valid_indices is not None:
            # keep only the annotated frame of each clip, an index into (b t)
            valid_indices = valid_indices.to(frame_mask.device, torch.long)
            sel = torch.arange(b, device=frame_mask.device) * t + valid_indices % t
            feats, feat_masks, poses = ([x[sel] for x in xs] for xs in (feats, feat_masks, poses))
            frame_mask = frame_mask[sel]
            t = 1

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
            """Classes [b, t, q, K], boxes [b, t, q, 4], masks
            [b, t, q, h, w] and with ``vis_loss`` visibility [b, t, q, 1]
            of decoder layer ``lvl``."""
            hs = tr["hs"][lvl]
            head = lvl if cfg.with_box_refine else 0
            logits = self.class_embed[head](hs)
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
                num_layers=cfg.controller_layers, rel_coord=cfg.rel_coord)
            out = {"pred_logits": logits.reshape(b, t, q, -1),
                   "pred_boxes": boxes.reshape(b, t, q, 4), "pred_masks": masks}
            if cfg.vis_loss:
                out["pred_visible"] = self.visible_embed[head](hs).reshape(b, t, q, 1)
            return out

        ref_vis = (tr["inter_references"][-2][..., :2] if cfg.dec_layers > 1
                   else tr["init_reference"])
        out = layer_outputs(cfg.dec_layers - 1)
        out.update({
            "reference_points": ref_vis.reshape(b, t, q, 2),
            "inter_samples": tr["inter_samples"],          # [l, b*t, q, 30, 2]
            "memory": tr["memory"],
        })
        if cfg.contrastive:
            mem = tr["memory"].reshape(b, t, -1, c).mean(2)
            out["contrastive"] = (mem * text_sentence[:, None]).sum(-1) / (
                torch.linalg.vector_norm(mem, dim=-1)
                * torch.linalg.vector_norm(text_sentence, dim=-1)[:, None] + 1e-6)
        if aux_outputs:
            out["aux_outputs"] = [layer_outputs(lvl) for lvl in range(cfg.dec_layers - 1)]
        return out


def init_weights(model: ReferFormer, generator: torch.Generator) -> None:
    """Seeded random initialisation with the JAX package's initialisers:
    lecun-normal linears and convs, zero biases, identity BatchNorm, the
    backbone family's own module types by its ``init_module`` (Swin's
    relative-position bias tables truncated N(0, 0.02)), the MSDA
    layout (zero offset/weight kernels, directional offset bias), N(0, 1)
    level and query embeddings, the focal-loss prior on the class and
    visibility biases and zero last bbox layers (bias -2 on w, h for the
    first)."""
    g = generator
    cfg = model.cfg
    init_module = getattr(family(cfg.backbone), "init_module", None)

    def lecun_(w):
        w.normal_(0.0, 1.0 / math.sqrt(w[0].numel()), generator=g)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d)):
                lecun_(mod.weight)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.weight.shape[1]), generator=g)
            elif isinstance(mod, MultiheadAttention):
                lecun_(mod.in_proj_weight)
                mod.in_proj_bias.zero_()
            elif init_module is not None:
                init_module(mod, g)
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
        for head in (*model.class_embed, *getattr(model, "visible_embed", ())):
            head.bias.fill_(prior)
        for i, mlp in enumerate(model.bbox_embed):
            mlp.layers[-1].weight.zero_()
            mlp.layers[-1].bias.zero_()
            if i == 0:
                mlp.layers[-1].bias[2:] = -2.0
