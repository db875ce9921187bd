"""Frozen reference copy of the port's RoBERTa text encoder, with
HuggingFace's module names, and of its tokenizer's hash fallback: a caption
becomes BOS, one id per lower-cased word (3 + crc32 % 50000), EOS, padded to
a multiple of 8. The benchmark runs the port with no cached tokenizer, so
the port takes the same fallback."""

from __future__ import annotations

import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

PAD_TOKEN_ID = 1
BOS_TOKEN_ID = 0
EOS_TOKEN_ID = 2
LN_EPS = 1e-5
DROPOUT = 0.1  # fixed, as in the JAX package (HF's hidden and attention dropout)


class RobertaEmbeddings(nn.Module):
    def __init__(self, vocab_size, hidden, max_positions, type_vocab):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, hidden)
        self.position_embeddings = nn.Embedding(max_positions, hidden)
        self.token_type_embeddings = nn.Embedding(type_vocab, hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=LN_EPS)
        self.dropout = nn.Dropout(DROPOUT)

    def forward(self, input_ids, attention_mask):
        # pad keeps padding_idx, real tokens count from padding_idx + 1
        mask = attention_mask.long()
        position_ids = torch.cumsum(mask, dim=1) * mask + PAD_TOKEN_ID
        x = (self.word_embeddings(input_ids) + self.position_embeddings(position_ids)
             + self.token_type_embeddings(torch.zeros_like(input_ids)))
        return self.dropout(self.LayerNorm(x))


class RobertaSelfAttention(nn.Module):
    def __init__(self, hidden, heads):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.dropout = nn.Dropout(DROPOUT)

    def forward(self, x, attention_mask):
        b, s, c = x.shape
        h = self.heads
        hd = c // h
        q = self.query(x).reshape(b, s, h, hd).transpose(1, 2)
        k = self.key(x).reshape(b, s, h, hd).transpose(1, 2)
        v = self.value(x).reshape(b, s, h, hd).transpose(1, 2)
        logits = torch.matmul(q, k.transpose(-1, -2)) / (hd ** 0.5)
        logits = logits.masked_fill(
            attention_mask[:, None, None, :] == 0, torch.finfo(logits.dtype).min
        )
        probs = self.dropout(torch.softmax(logits, dim=-1))
        return torch.matmul(probs, v).transpose(1, 2).reshape(b, s, c)


class _DenseNorm(nn.Module):
    """HF's ``*Output`` block: dense, dropout, residual, LayerNorm."""

    def __init__(self, d_in, d_out):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.LayerNorm = nn.LayerNorm(d_out, eps=LN_EPS)
        self.dropout = nn.Dropout(DROPOUT)

    def forward(self, x, residual):
        return self.LayerNorm(residual + self.dropout(self.dense(x)))


class _Attention(nn.Module):
    def __init__(self, hidden, heads):
        super().__init__()
        self.self = RobertaSelfAttention(hidden, heads)
        self.output = _DenseNorm(hidden, hidden)


class _Intermediate(nn.Module):
    def __init__(self, hidden, intermediate):
        super().__init__()
        self.dense = nn.Linear(hidden, intermediate)


class RobertaLayer(nn.Module):
    def __init__(self, hidden, heads, intermediate):
        super().__init__()
        self.attention = _Attention(hidden, heads)
        self.intermediate = _Intermediate(hidden, intermediate)
        self.output = _DenseNorm(intermediate, hidden)

    def forward(self, x, attention_mask):
        x = self.attention.output(self.attention.self(x, attention_mask), x)
        y = F.gelu(self.intermediate.dense(x))
        return self.output(y, x)


class _Encoder(nn.Module):
    def __init__(self, hidden, layers, heads, intermediate):
        super().__init__()
        self.layer = nn.ModuleList(
            RobertaLayer(hidden, heads, intermediate) for _ in range(layers)
        )


class _Pooler(nn.Module):
    def __init__(self, hidden):
        super().__init__()
        self.dense = nn.Linear(hidden, hidden)


class RobertaModel(nn.Module):
    """(input_ids, attention_mask) -> (last_hidden_state [B, S, H],
    pooler_output [B, H])."""

    def __init__(self, vocab_size: int = 50265, hidden: int = 768, layers: int = 12,
                 heads: int = 12, intermediate: int = 3072, max_positions: int = 514,
                 type_vocab: int = 1):
        super().__init__()
        self.embeddings = RobertaEmbeddings(vocab_size, hidden, max_positions, type_vocab)
        self.encoder = _Encoder(hidden, layers, heads, intermediate)
        self.pooler = _Pooler(hidden)

    def forward(self, input_ids, attention_mask) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.embeddings(input_ids, attention_mask)
        for layer in self.encoder.layer:
            x = layer(x, attention_mask)
        pooled = torch.tanh(self.pooler.dense(x[:, 0]))
        return x, pooled


ROBERTA_VOCAB_SIZE = 50265


def tokenize(
    captions: List[str], max_len: Optional[int] = None, pad_to_multiple: int = 8
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side tokenization -> (input_ids, attention_mask) int32 arrays,
    padded to a multiple of ``pad_to_multiple``, never truncated unless
    ``max_len`` is given."""
    ids, msk = [], []
    for cap in captions:
        words = cap.lower().split()
        # zlib.crc32, not hash(): str hashing is salted per process
        wid = [BOS_TOKEN_ID] + [
            3 + (zlib.crc32(w.encode("utf-8")) % 50000) for w in words
        ] + [EOS_TOKEN_ID]
        ids.append(wid)
        msk.append([1] * len(wid))
    longest = max(len(x) for x in ids)
    if max_len is None:
        max_len = -(-longest // pad_to_multiple) * pad_to_multiple
    ids_arr = np.full((len(ids), max_len), PAD_TOKEN_ID, dtype=np.int32)
    msk_arr = np.zeros((len(ids), max_len), dtype=np.int32)
    for i, (seq, mseq) in enumerate(zip(ids, msk)):
        seq = seq[:max_len]
        ids_arr[i, : len(seq)] = seq
        msk_arr[i, : len(seq)] = mseq[: len(seq)]
    return ids_arr, msk_arr
