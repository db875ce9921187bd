"""ReferFormer / TCE-RVOS model assembly (counterpart of
``tce_rvos_tpu/models/referformer.py``).

Pipeline: backbone (a 2D one on the b*t frames, a temporal one on the b
clips; ``BACKBONES`` lists them) -> per-level input_proj + early V-L fusion
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
text encoder's outputs. ``valid_indices`` ([b], A2D/JHMDB evaluation) keeps
only each clip's annotated frame after the position encodings: from there
on t = 1, as in the JAX package (reference tce_rvos.py:234-243).

The frame-sharded forward: ``frame_shard`` (from
``parallel/mesh.py::shard_time_axis``, which also cuts ``video`` and
``video_mask`` to the rank's frames) runs the rank's frames of the clip,
gathering over the ranks what mixes frames (``models/transformer.py``,
``models/segmentation.py``); every output is then the rank's frames of the
one-process forward's. A temporal backbone gathers its own halos
(Video-Swin's 3D windows, X3D's temporal convolutions and its
squeeze-excitation means). With ``valid_indices`` each clip's annotated
frame comes from the rank that holds it (``collectives.pick_from_owners``,
bitwise), and from there the forward runs unsharded on every rank, so
each rank's outputs are the one-process forward's. It is inference only,
as the JAX package's (``deterministic=True``): it raises with grad
enabled or in training mode, and it refuses the serving split
(``precomputed_feats``, ``backbone_only``), naming the option: the JAX
engine never shards time.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from tce_rvos_tpu_torch.config import ModelConfig
from tce_rvos_tpu_torch.models import backbone_resnet, swin, video_swin, x3d
from tce_rvos_tpu_torch.models.backbone_resnet import Backbone
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
from tce_rvos_tpu_torch.parallel import collectives
from tce_rvos_tpu_torch.utils import profiling
from tce_rvos_tpu_torch.utils.boxes import inverse_sigmoid
from tce_rvos_tpu_torch.utils.interpolate import resize_mask_nearest


BACKBONES = (*backbone_resnet.RESNET_SPECS, *swin.SWIN_CONFIGS,
             *video_swin.VIDEO_SWIN_CONFIGS, *x3d.X3D_CONFIGS)


def check_backbone(cfg: ModelConfig) -> None:
    """Raises ``ValueError`` naming the flag for a backbone name that is not
    in ``BACKBONES``, and for DC5 (``--dilation``) on a backbone that is
    not a ResNet."""
    if cfg.backbone not in BACKBONES:
        raise ValueError(f"--backbone: unknown backbone {cfg.backbone!r}; the known ones are "
                         + ", ".join(BACKBONES))
    if cfg.dilation and cfg.backbone not in backbone_resnet.RESNET_SPECS:
        raise ValueError(f"--dilation: DC5 is a ResNet option, not one of {cfg.backbone!r}")


def build_backbone_module(cfg: ModelConfig):
    """(the backbone network, its strides, its channels, whether it is
    temporal: takes clips [b, 3, t, H, W] rather than frames)."""
    check_backbone(cfg)
    name = cfg.backbone
    if name in video_swin.VIDEO_SWIN_CONFIGS:
        spec = video_swin.video_swin_spec(name)
        body = video_swin.VideoSwinBackbone(spec, use_checkpoint=cfg.use_checkpoint)
        return body, spec["strides"], spec["channels"], True
    if name in swin.SWIN_CONFIGS:
        spec = swin.swin_spec(name)
        body = swin.SwinBackbone(spec, use_checkpoint=cfg.use_checkpoint)
        return body, spec["strides"], spec["channels"], False
    if name in x3d.X3D_CONFIGS:
        spec = x3d.x3d_spec(name)
        return x3d.X3DBackbone(spec), spec["strides"], spec["channels"], True
    strides, channels = backbone_resnet.resnet_strides_channels(name, cfg.dilation)
    body = backbone_resnet.ResNet(backbone_resnet.RESNET_SPECS[name]["layers"], cfg.dilation)
    return body, strides, channels, False


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
        frame_shard=None,                     # the rank's t frames of the clip
    ):
        cfg = self.cfg
        c = cfg.hidden_dim
        bv, t = video_mask.shape[0], video_mask.shape[1]
        b = bv if text_ids is None else text_ids.shape[0]
        if frame_shard is not None:
            self._check_frame_shard(frame_shard, t, precomputed_feats, backbone_only)

        if precomputed_feats is None:
            with profiling.span("tce.model.backbone", bv * t):
                if self.temporal_backbone:  # clips [bv, 3, t, H, W]
                    feats = self.backbone[0](video.permute(0, 4, 1, 2, 3), frame_shard)
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
            # keep only the annotated frame of each clip, an index into (b t);
            # under a frame shard, from the rank that holds it (rank i holds
            # the clip's frames [i t, (i + 1) t)), and the rest runs unsharded
            valid_indices = valid_indices.to(frame_mask.device, torch.long)
            sel = torch.arange(b, device=frame_mask.device) * t + valid_indices % t
            picked = collectives.pick_from_owners(
                [x[sel] for x in (*feats, *feat_masks, *poses, frame_mask)],
                valid_indices // t, frame_shard)
            n = len(feats)
            feats, feat_masks, poses = picked[:n], picked[n:2 * n], picked[2 * n:3 * n]
            frame_mask = picked[-1]
            t, frame_shard = 1, None

        # ---- text ----
        with profiling.span("tce.model.text", b * t):
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
        with profiling.span("tce.model.fusion", b * t):
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
            bbox_embed=self.bbox_embed if cfg.with_box_refine else None,
            frame_shard=frame_shard)
        # ---- segmentation ----
        with profiling.span("tce.model.pixel_decoder", b * t):
            mask_features = self.pixel_decoder(
                list(zip(feats, feat_masks)), text_features, text_pad_mask, text_pos,
                poses[:4], tr["memory_features"], t, frame_shard)
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

        with profiling.span("tce.model.heads", b * t):
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

    def _check_frame_shard(self, shard, t: int, precomputed_feats, backbone_only: bool) -> None:
        """Raises for what the frame-sharded forward does not take."""
        if self.training or torch.is_grad_enabled():
            raise ValueError("frame_shard: the frame-sharded forward is inference only "
                             "(call it in eval mode under torch.no_grad or inference_mode)")
        if precomputed_feats is not None or backbone_only:
            raise ValueError("precomputed_feats / backbone_only: the serving split is not "
                             "frame-sharded; run the plain forward")
        if t != shard.count:
            raise ValueError(f"frame_shard holds {shard.count} frames, the video {t}")


def init_weights(model: ReferFormer, generator: torch.Generator) -> None:
    """Seeded random initialisation with the JAX package's initialisers:
    lecun-normal linears and convs, zero biases, identity BatchNorm, the
    Swin relative-position bias tables truncated N(0, 0.02), the MSDA
    layout (zero offset/weight kernels, directional offset bias), N(0, 1)
    level and query embeddings, the focal-loss prior on the class and
    visibility biases and zero last bbox layers (bias -2 on w, h for the
    first)."""
    g = generator
    cfg = model.cfg

    def lecun_(w):
        w.normal_(0.0, 1.0 / math.sqrt(w[0].numel()), generator=g)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d)):
                lecun_(mod.weight)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, swin.WindowAttention):
                nn.init.trunc_normal_(mod.relative_position_bias_table, std=0.02, a=-0.04,
                                      b=0.04, generator=g)
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
        for head in (*model.class_embed, *getattr(model, "visible_embed", ())):
            head.bias.fill_(prior)
        for i, mlp in enumerate(model.bbox_embed):
            mlp.layers[-1].weight.zero_()
            mlp.layers[-1].bias.zero_()
            if i == 0:
                mlp.layers[-1].bias[2:] = -2.0
