"""Shared building blocks (counterpart of ``tce_rvos_tpu/models/layers.py``).

Sequence tensors are batch-first ``[B, S, C]``; masks are True on padding.
Epsilons follow the JAX package, not torch's defaults: LayerNorm 1e-6 in
the transformer, FFN and FPN, GroupNorm 1e-6, FeatureResizer 1e-12.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-6
# the most attention logits (batch x heads x queries x keys, or windows x
# heads x n x n in Swin) one chunk computes at once: 2^28 is 512 MiB in bf16
ATTN_LOGITS_CHUNK = 2**28
# the most FFN hidden activations (rows x d_ffn) one chunk of rows computes
# at once: 2^30 is 2 GiB in bf16 (a whole-video window of 160 frames at
# 384x640 puts 4.9M stride-4 pixels of each expression through the FPN's
# 2048-wide FFN)
FFN_HIDDEN_CHUNK = 2**30


def conv_out(size: int, k: int, s: int, p: int, d: int = 1) -> int:
    """The output length of a convolution (or pooling) along one axis."""
    return (size + 2 * p - d * (k - 1) - 1) // s + 1


def run_layer(layer: nn.Module, recompute: bool, *args):
    """``layer(*args)``, recomputed in the backward pass when ``recompute``
    and gradients are being recorded (``torch.utils.checkpoint``,
    non-reentrant, the RNG state kept so dropout and DropPath draw the same
    masks; ``nn.remat`` in the JAX package). The layer's parameters and
    buffers go into the checkpoint as arguments: under the bf16 train
    step's ``functional_call`` they are bf16 casts that the module no
    longer holds when the backward pass recomputes."""
    if recompute and torch.is_grad_enabled():
        tensors = {**dict(layer.named_parameters()), **dict(layer.named_buffers())}
        return checkpoint(functional_call, layer, tensors, args, use_reentrant=False)
    return layer(*args)


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "relu":
        return F.relu
    if name == "gelu":
        return F.gelu
    if name == "glu":
        return F.glu
    raise ValueError(f"activation should be relu/gelu/glu, not {name}")


def layer_norm(d_model: int, eps: float = LN_EPS) -> nn.LayerNorm:
    return nn.LayerNorm(d_model, eps=eps)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over NCHW with float32 statistics and affine, cast back to
    the input's dtype (the JAX GroupNorm computes in float32 whatever the
    operand's dtype)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6):
        super().__init__(num_groups, num_channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class MLP(nn.Module):
    """ReLU MLP (``layers.{i}``), the controller and bbox heads."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims_in = [input_dim] + [hidden_dim] * (num_layers - 1)
        dims_out = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims_in, dims_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class FeatureResizer(nn.Module):
    """Linear + LayerNorm(eps 1e-12) + dropout: text width -> d_model."""

    def __init__(self, input_dim: int, output_dim: int, dropout: float = 0.1):
        super().__init__()
        self.fc = nn.Linear(input_dim, output_dim)
        self.layer_norm = nn.LayerNorm(output_dim, eps=1e-12)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(self.layer_norm(self.fc(x)))


class MultiheadAttention(nn.Module):
    """``torch.nn.MultiheadAttention`` parameters (packed ``in_proj_weight``
    / ``in_proj_bias``, ``out_proj``), batch-first, with dropout on the
    attention probabilities. ``key_padding_mask`` [B, Sk] is True where a
    key is ignored; masked logits take the dtype's most negative finite
    value, as in the JAX package (a fully masked row stays finite). Past
    ``ATTN_LOGITS_CHUNK`` logits the queries go in chunks: their rows are
    independent, so the chunks compute the same function (whole-video
    windows put T x 240 pixels through the FPN's V-L self-attention)."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        self.dropout = nn.Dropout(dropout)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        key_padding_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        c, h = self.d_model, self.num_heads
        hd = c // h
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        b, sq, _ = query.shape
        sk = key.shape[1]
        q = F.linear(query, wq, bq).reshape(b, sq, h, hd).transpose(1, 2)
        k = F.linear(key, wk, bk).reshape(b, sk, h, hd).transpose(1, 2)
        v = F.linear(value, wv, bv).reshape(b, sk, h, hd).transpose(1, 2)
        mask = None if key_padding_mask is None else key_padding_mask[:, None, None, :]
        rows = max(1, ATTN_LOGITS_CHUNK // (b * h * sk))
        if sq <= rows:
            out = self._attend(q, k, v, mask)
        else:
            out = torch.cat([self._attend(q[:, :, i:i + rows], k, v, mask)
                             for i in range(0, sq, rows)], 2)
        return self.out_proj(out.transpose(1, 2).reshape(b, sq, c))

    def _attend(self, q, k, v, mask):
        """softmax(q k^T / sqrt(d)) v over heads [B, H, Sq, D]."""
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        if mask is not None:
            logits = logits.masked_fill(mask, torch.finfo(logits.dtype).min)
        return torch.matmul(self.dropout(torch.softmax(logits, dim=-1)), v)


def ffn(
    x: torch.Tensor,
    linear1: nn.Linear,
    linear2: nn.Linear,
    norm: nn.LayerNorm,
    dropout: nn.Dropout,
    activation: str = "relu",
) -> torch.Tensor:
    """Post-norm FFN with residual: norm(x + drop(W2 drop(act(W1 x)))). The
    layers live on the calling block under the reference's names
    (``linear1``, ``linear2`` and ``norm2`` in the encoder, ``norm3`` in the
    decoder and the FPN's V-L blocks), and so does its dropout. Past
    ``FFN_HIDDEN_CHUNK`` hidden activations the rows go in chunks: each
    row's FFN is its own, so the chunks compute the same function."""
    def block(rows):
        y = dropout(get_activation(activation)(linear1(rows)))
        return norm(rows + dropout(linear2(y)))

    n = x.shape[:-1].numel()
    step = max(1, FFN_HIDDEN_CHUNK // linear1.out_features)
    if n <= step:
        return block(x)
    flat = x.reshape(n, x.shape[-1])
    return torch.cat([block(flat[i:i + step]) for i in range(0, n, step)]).reshape(x.shape)


def with_pos(tensor: torch.Tensor, pos: Optional[torch.Tensor]) -> torch.Tensor:
    """Add a (float32) position encoding in the feature's dtype."""
    return tensor if pos is None else tensor + pos.to(tensor.dtype)
