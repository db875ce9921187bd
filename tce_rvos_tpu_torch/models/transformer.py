"""Deformable transformer with Frame Token Fusion (FTF, ``--f_token``) in the
encoder and the Instance Query Transformer (IQT, ``--qtrans``) in the
decoder (counterpart of ``tce_rvos_tpu/models/transformer.py``).

Module and parameter names are the reference's ``state_dict`` keys
(``transformer.encoder.layers.{i}.self_attn.sampling_offsets`` ...). The
flattened batch of every call is N = b*t; masks are True on padding;
sequences are batch-first [N, S, C]. Level shapes are python tuples.

FTF token attention and IQT attention are scoped to each batch element's
clip (t frames), as in the JAX package: with expressions stacked on the
batch axis, expressions never attend to each other.

``msda_3d`` (``--msda_3d``) makes the encoder's self-attention and the
decoder's cross-attention temporal (``MSDeformAttn(is_3d=True)``, the 3D
MSDA op); FTF's token attention stays 2D. As in the JAX package, the 3D op
takes the call's whole batch axis as time, so with clips or expressions
stacked on it a temporal tap can reach into the neighbouring clip: the port
copies this, it does not scope it.

Dropout follows the JAX package: ``dropout`` on every residual branch, in
the FFNs and on the attention probabilities of the FTF and IQT attention
(none inside MSDA). ``use_checkpoint`` recomputes each encoder and decoder
layer in the backward pass (``torch.utils.checkpoint``, non-reentrant,
with the RNG state kept so dropout draws the same masks). Unlike the JAX
policy, which saves each MSDA output, the MSDA forward kernel runs again in
the recomputation: 12 extra forward launches per flagship step.

Not ported yet: ``LastLayerAsToken`` (f_token < 0).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from tce_rvos_tpu_torch.models.layers import (
    MultiheadAttention,
    ffn,
    layer_norm,
    with_pos,
)
from tce_rvos_tpu_torch.ops.msda_cuda import ms_deform_attn, ms_deform_attn_3d
from tce_rvos_tpu_torch.utils.boxes import inverse_sigmoid

SpatialShapes = Tuple[Tuple[int, int], ...]


def offset_bias(n_heads: int, n_levels: int, n_points: int) -> torch.Tensor:
    """Directional sampling-offset bias: head h points at angle 2*pi*h/M,
    normalised to the unit box, scaled by the point index."""
    thetas = torch.arange(n_heads, dtype=torch.float64) * (2.0 * math.pi / n_heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True).values
    grid = grid[:, None, None, :].repeat(1, n_levels, n_points, 1)
    grid = grid * torch.arange(1, n_points + 1, dtype=torch.float64)[None, None, :, None]
    return grid.reshape(-1).float()


def offset_bias_3d(n_heads: int, n_levels: int, n_points: int) -> torch.Tensor:
    """The directional bias with a zero temporal coordinate per point."""
    b2 = offset_bias(n_heads, n_levels, n_points).reshape(n_heads, n_levels, n_points, 2)
    return torch.cat([b2, torch.zeros_like(b2[..., :1])], -1).reshape(-1)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention module (reference parameter layout:
    value [N, S, M, D], loc/attn [N, Q, M, L, P, ...]). The core op is
    ``ops/msda_cuda.py::ms_deform_attn``: the CUDA kernel on the card, the
    plain version on the CPU. With ``is_3d`` every point has a third
    (frame) offset and the op is ``ms_deform_attn_3d``: the temporal
    reference is the query's own frame along the batch axis, ``(n + 0.5) /
    N``, so zero temporal offsets give the 2D result."""

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4, is_3d: bool = False):
        super().__init__()
        self.d_model, self.n_levels, self.n_heads, self.n_points = (
            d_model, n_levels, n_heads, n_points)
        self.is_3d = is_3d
        self.coords = 3 if is_3d else 2
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * self.coords)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.sampling_offsets.weight.zero_()
            bias = offset_bias_3d if self.is_3d else offset_bias
            self.sampling_offsets.bias.copy_(bias(self.n_heads, self.n_levels, self.n_points))
            self.attention_weights.weight.zero_()
            self.attention_weights.bias.zero_()
            for lin in (self.value_proj, self.output_proj):
                xavier_(lin.weight, generator)
                lin.bias.zero_()

    def forward(
        self,
        query: torch.Tensor,             # [N, Q, C]
        reference_points: torch.Tensor,  # [N, Q, L, 2] or [N, Q, L, 4], float32
        input_flatten: torch.Tensor,     # [N, S, C]
        spatial_shapes: SpatialShapes,
        padding_mask: Optional[torch.Tensor] = None,  # [N, S]
    ):
        m, l, p = self.n_heads, self.n_levels, self.n_points
        n, q_len, _ = query.shape
        s = input_flatten.shape[1]
        value = self.value_proj(input_flatten)
        if padding_mask is not None:
            value = value.masked_fill(padding_mask[..., None], 0.0)
        value = value.reshape(n, s, m, self.d_model // m)
        offsets = self.sampling_offsets(query).reshape(n, q_len, m, l, p, self.coords)
        attn = self.attention_weights(query).reshape(n, q_len, m, l * p)
        attn = torch.softmax(attn, -1).reshape(n, q_len, m, l, p)
        ref = reference_points[:, :, None]  # broadcast over heads
        off_xy = offsets[..., :2]
        if reference_points.shape[-1] == 2:
            normalizer = torch.tensor([[w, h] for h, w in spatial_shapes],
                                      dtype=offsets.dtype, device=offsets.device)
            loc = ref[:, :, :, :, None, :] + off_xy / normalizer[None, None, None, :, None, :]
        elif reference_points.shape[-1] == 4:
            loc = ref[:, :, :, :, None, :2] + off_xy / p * ref[:, :, :, :, None, 2:] * 0.5
        else:
            raise ValueError("reference_points last dim must be 2 or 4")
        if self.is_3d:
            # the query's own frame along the batch-as-time axis: f_im =
            # loc_f * N - 0.5 lands exactly on frame n at zero offset. f32,
            # as the (f32) reference points make the spatial coordinates
            ref_f = (torch.arange(n, dtype=loc.dtype, device=loc.device) + 0.5) / n
            loc_f = ref_f[:, None, None, None, None] + offsets[..., 2] / n
            loc = torch.cat([loc, loc_f[..., None]], -1)
        # coordinates and weights stay float32 into the kernel
        loc = loc.float().contiguous()
        attn = attn.float().contiguous()
        if self.is_3d:
            out = ms_deform_attn_3d(value, spatial_shapes, loc, attn)
            loc = loc[..., :2]  # what the consumers read (the top-30 export)
        else:
            out = ms_deform_attn(value, spatial_shapes, loc, attn)
        return self.output_proj(out), loc, attn


def xavier_(w: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    fan_out, fan_in = w.shape[0], w[0].numel()
    a = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return w.uniform_(-a, a, generator=generator)


def get_encoder_reference_points(
    spatial_shapes: SpatialShapes, valid_ratios: torch.Tensor
) -> torch.Tensor:
    """Per-pixel normalised reference grid. valid_ratios [N, L, 2] (w, h)
    -> [N, S, L, 2]."""
    refs = []
    dev = valid_ratios.device
    for lvl, (h, w) in enumerate(spatial_shapes):
        ry = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
        rx = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
        gy, gx = torch.meshgrid(ry, rx, indexing="ij")
        gy = gy.reshape(-1)[None] / (valid_ratios[:, None, lvl, 1] * h)
        gx = gx.reshape(-1)[None] / (valid_ratios[:, None, lvl, 0] * w)
        refs.append(torch.stack([gx, gy], -1))
    ref = torch.cat(refs, 1)  # [N, S, 2]
    return ref[:, :, None] * valid_ratios[:, None]


def get_valid_ratio(mask: torch.Tensor) -> torch.Tensor:
    """mask [N, H, W] True=pad -> [N, 2] (w_ratio, h_ratio)."""
    h, w = mask.shape[1], mask.shape[2]
    valid_h = (~mask[:, :, 0]).sum(1).float()
    valid_w = (~mask[:, 0, :]).sum(1).float()
    return torch.stack([valid_w / w, valid_h / h], -1)


class FrameTokenLayer(nn.Module):
    """FTF: per-frame learnable tokens gather frame information through
    deformable cross-attention, attend jointly across the clip's frames,
    then write back into the frame features."""

    def __init__(self, d_model=256, d_ffn=1024, dropout=0.1, activation="relu", n_heads=8,
                 n_levels=4, n_points=4):
        super().__init__()
        self.activation = activation
        self.reference_points = nn.Linear(d_model, 2)
        self.token_frame_atten = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = layer_norm(d_model)
        self.token_self_atten = MultiheadAttention(d_model, n_heads, dropout)
        self.norm2 = layer_norm(d_model)
        self.frame_token_atten = MultiheadAttention(d_model, n_heads, dropout)
        self.norm3 = layer_norm(d_model)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm4 = layer_norm(d_model)
        self.dropout = nn.Dropout(dropout)

    def forward(self, src, pos, token, token_pos, spatial_shapes, padding_mask,
                valid_ratios, clip_frames: int):
        n, n_tok, c = token.shape
        t = clip_frames
        b = n // t
        # 1) token <- frame features; reference points from the tokens
        ref = torch.sigmoid(self.reference_points(token))
        ref = ref[:, :, None] * valid_ratios[:, None]  # [N, To, L, 2]
        token2, _, _ = self.token_frame_atten(
            with_pos(token, token_pos), ref, src, spatial_shapes, padding_mask)
        token = self.norm1(token + self.dropout(token2))
        # 2) joint self-attention over one clip's t*To tokens
        flat = token.reshape(b, t * n_tok, c)
        qk = with_pos(flat, token_pos.reshape(b, t * n_tok, c))
        token = self.norm2(flat + self.dropout(self.token_self_atten(qk, qk, flat)))
        token = token.reshape(n, n_tok, c)
        # 3) frame features <- tokens
        src2 = self.frame_token_atten(with_pos(src, pos), with_pos(token, token_pos), token)
        src = self.norm3(src + self.dropout(src2))
        # 4) FFN
        src = ffn(src, self.linear1, self.linear2, self.norm4, self.dropout, self.activation)
        return src, token


class EncoderLayer(nn.Module):
    def __init__(self, d_model=256, d_ffn=1024, dropout=0.1, activation="relu", n_levels=4,
                 n_heads=8, n_points=4, f_token=0, msda_3d=False):
        super().__init__()
        if f_token < 0:
            raise NotImplementedError("f_token < 0 (LastLayerAsToken) is not ported yet")
        self.activation = activation
        self.ftoken_layers = (
            FrameTokenLayer(d_model, d_ffn, dropout, activation, n_heads, n_levels, n_points)
            if f_token > 0 else None
        )
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points, is_3d=msda_3d)
        self.norm1 = layer_norm(d_model)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = layer_norm(d_model)
        self.dropout = nn.Dropout(dropout)

    def forward(self, src, pos, reference_points, spatial_shapes, valid_ratios,
                padding_mask, memory_bus, memory_pos, clip_frames: int):
        if self.ftoken_layers is not None:
            src, memory_bus = self.ftoken_layers(
                src, pos, memory_bus, memory_pos, spatial_shapes, padding_mask,
                valid_ratios, clip_frames)
        src2, _, _ = self.self_attn(
            with_pos(src, pos), reference_points, src, spatial_shapes, padding_mask)
        src = self.norm1(src + self.dropout(src2))
        src = ffn(src, self.linear1, self.linear2, self.norm2, self.dropout, self.activation)
        return src, memory_bus


class DecoderLayer(nn.Module):
    """Deformable decoder layer; with IQT the self-attention runs over each
    query slot's t frames instead of over the query slots of one frame."""

    def __init__(self, d_model=256, d_ffn=1024, dropout=0.1, activation="relu", n_levels=4,
                 n_heads=8, n_points=4, is_query_atten=False, msda_3d=False):
        super().__init__()
        self.activation = activation
        self.is_query_atten = is_query_atten
        self.self_attn = MultiheadAttention(d_model, n_heads, dropout)
        self.norm2 = layer_norm(d_model)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points, is_3d=msda_3d)
        self.norm1 = layer_norm(d_model)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm3 = layer_norm(d_model)
        self.dropout = nn.Dropout(dropout)

    def forward(self, tgt, query_pos, reference_points, src, spatial_shapes,
                padding_mask, clip_frames: int):
        qk = with_pos(tgt, query_pos)
        if self.is_query_atten:
            n, q_len, c = tgt.shape
            t = clip_frames
            b = n // t

            def to_iqt(x):  # [b*t, Q, C] -> [b*Q, t, C]
                return x.reshape(b, t, q_len, c).transpose(1, 2).reshape(b * q_len, t, c)

            tgt2 = self.self_attn(to_iqt(qk), to_iqt(qk), to_iqt(tgt))
            tgt2 = tgt2.reshape(b, q_len, t, c).transpose(1, 2).reshape(n, q_len, c)
        else:
            tgt2 = self.self_attn(qk, qk, tgt)
        tgt = self.norm2(tgt + self.dropout(tgt2))
        tgt2, loc, attn_w = self.cross_attn(
            with_pos(tgt, query_pos), reference_points, src, spatial_shapes, padding_mask)
        tgt = self.norm1(tgt + self.dropout(tgt2))
        tgt = ffn(tgt, self.linear1, self.linear2, self.norm3, self.dropout, self.activation)
        return tgt, loc, attn_w


class _Stack(nn.Module):
    """``encoder`` / ``decoder`` containers: ``layers.{i}`` (+ the FTF
    memory bus on the encoder), as in the reference's keys."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class DeformableTransformer(nn.Module):
    """Encoder/decoder. With box refinement the per-layer bbox MLPs belong to
    the model head (``bbox_embed.{l}``, the reference's keys) and are passed
    to ``forward``; the transformer holds no copy of them."""

    def __init__(self, d_model=256, nhead=8, num_encoder_layers=4, num_decoder_layers=4,
                 dim_feedforward=2048, dropout=0.1, activation="relu", num_feature_levels=4,
                 dec_n_points=4, enc_n_points=4, q_trans=False, f_token=0,
                 with_box_refine=False, use_checkpoint=False, msda_3d=False):
        super().__init__()
        self.d_model = d_model
        self.f_token = f_token
        self.with_box_refine = with_box_refine
        self.use_checkpoint = use_checkpoint
        self.num_feature_levels = num_feature_levels
        self.level_embed = nn.Parameter(torch.zeros(num_feature_levels, d_model))
        self.encoder = _Stack([
            EncoderLayer(d_model, dim_feedforward, dropout, activation, num_feature_levels,
                         nhead, enc_n_points, f_token, msda_3d)
            for _ in range(num_encoder_layers)
        ])
        if f_token > 0:
            self.encoder.memory_bus = nn.Parameter(torch.zeros(f_token, d_model))
            self.encoder.memory_pos = nn.Parameter(torch.zeros(f_token, d_model))
        self.decoder = _Stack([
            DecoderLayer(d_model, dim_feedforward, dropout, activation, num_feature_levels,
                         nhead, dec_n_points, q_trans, msda_3d)
            for _ in range(num_decoder_layers)
        ])
        self.reference_points = nn.Linear(d_model, 2)

    def _run_layer(self, layer: nn.Module, *args):
        """One encoder or decoder layer; recomputed in the backward pass
        under ``use_checkpoint`` when gradients are being recorded. The
        layer's parameters and buffers go into the checkpoint as arguments:
        under the bf16 train step's ``functional_call`` they are bf16 casts
        that the module no longer holds when the backward pass recomputes."""
        if self.use_checkpoint and torch.is_grad_enabled():
            tensors = {**dict(layer.named_parameters()), **dict(layer.named_buffers())}
            return checkpoint(functional_call, layer, tensors, args, use_reentrant=False)
        return layer(*args)

    def forward(
        self,
        srcs: Sequence[torch.Tensor],        # L x [N, C, H_l, W_l]
        tgt: torch.Tensor,                   # [b, t, q, C] (text embedding)
        masks: Sequence[torch.Tensor],       # L x [N, H_l, W_l] True=pad
        pos_embeds: Sequence[torch.Tensor],  # L x [N, H_l, W_l, C] float32
        query_embed: torch.Tensor,           # [q, C]
        bbox_embed: Optional[Sequence[nn.Module]] = None,
    ) -> Dict[str, object]:
        c = self.d_model
        spatial_shapes = tuple((int(s.shape[2]), int(s.shape[3])) for s in srcs)
        n = srcs[0].shape[0]
        src_flat = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
        mask_flat = torch.cat([m.reshape(n, -1) for m in masks], 1)
        pos_flat = torch.cat([
            p.reshape(n, -1, c).to(src_flat.dtype) + self.level_embed[lvl][None, None]
            for lvl, p in enumerate(pos_embeds)
        ], 1)
        valid_ratios = torch.stack([get_valid_ratio(m) for m in masks], 1)

        # ---- encoder ----
        b, t, q_per_frame, _ = tgt.shape
        enc_ref = get_encoder_reference_points(spatial_shapes, valid_ratios)
        memory_bus = memory_pos = None
        if self.f_token > 0:
            memory_bus = self.encoder.memory_bus[None].expand(n, -1, -1)
            memory_pos = self.encoder.memory_pos[None].expand(n, -1, -1)
        output = src_flat
        run = self._run_layer
        for layer in self.encoder.layers:
            output, memory_bus = run(layer, output, pos_flat, enc_ref, spatial_shapes,
                                     valid_ratios, mask_flat, memory_bus, memory_pos, t)
        memory = output

        # ---- decoder ----
        tgt_dec = tgt.reshape(b * t, q_per_frame, c)
        query_pos = query_embed[None].expand(b * t, -1, -1)
        # coordinate math pinned to float32 (a bf16 box centre drifts pixels)
        init_reference = torch.sigmoid(self.reference_points(query_pos)).float()
        reference_points = init_reference
        out = tgt_dec
        hs, inter_refs, coords, samples = [], [], [], []
        for i, layer in enumerate(self.decoder.layers):
            if reference_points.shape[-1] == 4:
                ref_input = reference_points[:, :, None] * torch.cat(
                    [valid_ratios] * 2, -1)[:, None]
            else:
                ref_input = reference_points[:, :, None] * valid_ratios[:, None]
            out, loc, attn_w = run(layer, out, query_pos, ref_input, memory, spatial_shapes,
                                   mask_flat, t)
            # top-30 sampling locations for visualisation
            nq = loc.shape[1]
            loc_n = loc / valid_ratios[:, None, None, :, None, :]
            top_i = torch.topk(attn_w.reshape(n, nq, -1), 30, dim=-1).indices
            samples.append(torch.gather(
                loc_n.reshape(n, nq, -1, 2), 2, top_i[..., None].expand(-1, -1, -1, 2)))
            if self.with_box_refine:
                tmp = bbox_embed[i](out)
                if reference_points.shape[-1] == 4:
                    new_ref = torch.sigmoid(tmp + inverse_sigmoid(reference_points))
                else:
                    new_ref = torch.sigmoid(torch.cat(
                        [tmp[..., :2] + inverse_sigmoid(reference_points), tmp[..., 2:]], -1))
                coords.append(new_ref)
                reference_points = new_ref.detach()
            hs.append(out)
            inter_refs.append(reference_points)

        memory_features = []
        start = 0
        for h, w in spatial_shapes[: self.num_feature_levels - 1]:
            memory_features.append(
                memory[:, start : start + h * w].transpose(1, 2).reshape(n, c, h, w))
            start += h * w
        return dict(
            hs=torch.stack(hs),                    # [l, N, q, C]
            memory_features=memory_features,       # 3 x [N, C, h, w] (8x, 16x, 32x)
            init_reference=init_reference,         # [N, q, 2]
            inter_references=torch.stack(inter_refs),  # [l, N, q, 2|4]
            memory=memory,                         # [N, S, C]
            coords=torch.stack(coords) if coords else None,  # [l, N, q, 4]
            inter_samples=torch.stack(samples),    # [l, N, q, 30, 2]
        )
