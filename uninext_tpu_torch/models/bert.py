"""BERT text encoder (bert-base architecture), mirroring
`uninext_tpu/models/bert.py`, with the HF BertModel parameter names
(embeddings.*, encoder.layer.{i}.attention.self.*, ...).

The attention scores carry the reference's bf16-stability clamp at
+/-50000 (`uninext_tpu/models/bert.py:37`)."""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..config import LanguageConfig

from .layers import LayerNorm, Linear


class _Embeddings(nn.Module):
    def __init__(self, c: LanguageConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_dim)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings,
                                                c.hidden_dim)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_dim)
        self.LayerNorm = LayerNorm(c.hidden_dim, eps=c.layer_norm_eps)


class _SelfAttention(nn.Module):
    def __init__(self, c: LanguageConfig, dtype):
        super().__init__()
        self.query = Linear(c.hidden_dim, c.hidden_dim, dtype=dtype)
        self.key = Linear(c.hidden_dim, c.hidden_dim, dtype=dtype)
        self.value = Linear(c.hidden_dim, c.hidden_dim, dtype=dtype)


class _DenseLN(nn.Module):
    def __init__(self, d_in: int, d_out: int, eps: float, dtype):
        super().__init__()
        self.dense = Linear(d_in, d_out, dtype=dtype)
        self.LayerNorm = LayerNorm(d_out, eps=eps)


class _Attention(nn.Module):
    def __init__(self, c: LanguageConfig, dtype):
        super().__init__()
        self.self = _SelfAttention(c, dtype)
        self.output = _DenseLN(c.hidden_dim, c.hidden_dim, c.layer_norm_eps, dtype)


class _Intermediate(nn.Module):
    def __init__(self, c: LanguageConfig, dtype):
        super().__init__()
        self.dense = Linear(c.hidden_dim, c.intermediate_dim, dtype=dtype)


class BertLayer(nn.Module):
    def __init__(self, c: LanguageConfig, dtype=torch.float32):
        super().__init__()
        self.num_heads = c.num_heads
        self.compute_dtype = dtype
        self.attention = _Attention(c, dtype)
        self.intermediate = _Intermediate(c, dtype)
        self.output = _DenseLN(c.intermediate_dim, c.hidden_dim,
                               c.layer_norm_eps, dtype)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        B, L, C = x.shape
        nh = self.num_heads
        hd = C // nh
        sa = self.attention.self
        q = sa.query(x).reshape(B, L, nh, hd)
        k = sa.key(x).reshape(B, L, nh, hd)
        v = sa.value(x).reshape(B, L, nh, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        scores = (scores + attn_bias).clamp(-50000, 50000)
        probs = scores.float().softmax(-1).to(self.compute_dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, L, C)
        ao = self.attention.output
        x = ao.LayerNorm(x + ao.dense(out))
        h = F.gelu(self.intermediate.dense(x))
        return self.output.LayerNorm(x + self.output.dense(h))


class _Encoder(nn.Module):
    def __init__(self, c: LanguageConfig, dtype):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(c, dtype) for _ in range(c.num_layers))


class BertModel(nn.Module):
    """Token ids -> contextual embeddings.

    forward(input_ids (B, L), attention_mask (B, L) 1=valid) ->
    dict(hidden (B, L, C) fp32, masks, aggregate (B, C))."""

    def __init__(self, c: LanguageConfig, dtype=torch.float32):
        super().__init__()
        if c.model_type != "bert-base-uncased":
            raise NotImplementedError(f"language model {c.model_type}")
        self.compute_dtype = dtype
        self.embeddings = _Embeddings(c)
        self.encoder = _Encoder(c, dtype)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        B, L = input_ids.shape
        e = self.embeddings
        pos_ids = torch.arange(L, device=input_ids.device)[None].expand(B, L)
        x = e.LayerNorm(e.word_embeddings(input_ids)
                        + e.position_embeddings(pos_ids)
                        + e.token_type_embeddings(torch.zeros_like(input_ids)))
        dt = self.compute_dtype
        x = x.to(dt)
        neg = torch.tensor(-1e9, dtype=dt, device=x.device)
        bias = torch.where(attention_mask[:, None, None, :] > 0,
                           torch.zeros((), dtype=dt, device=x.device), neg)
        for layer in self.encoder.layer:
            x = layer(x, bias)
        hidden = x.float()
        m = attention_mask.float()
        aggregate = (hidden * m[..., None]).sum(1) / m.sum(-1, keepdim=True).clamp(
            min=1e-6)
        return {"hidden": hidden, "masks": attention_mask, "aggregate": aggregate}
