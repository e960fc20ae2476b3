"""Bidirectional vision-language early fusion (GLIP-style), mirroring
`uninext_tpu/models/vl_fusion.py`, with the reference parameter names
(vl_layers.{i}.b_attn.{gamma_v,gamma_l,layer_norm_v,layer_norm_l,attn.*}).

Keeps the reference's stability clamps at +/-50000, the text-side max
subtraction and the -9e15 language mask (`vl_fusion.py:46-59`)."""
from __future__ import annotations

import torch
from torch import nn

from ..config import LanguageConfig, TransformerConfig

from .layers import LayerNorm, Linear


class BiMultiHeadAttention(nn.Module):
    def __init__(self, v_dim: int, l_dim: int, embed_dim: int, num_heads: int,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.embed_dim = embed_dim
        self.compute_dtype = dtype
        self.v_proj = Linear(v_dim, embed_dim, dtype=dtype)
        self.l_proj = Linear(l_dim, embed_dim, dtype=dtype)
        self.values_v_proj = Linear(v_dim, embed_dim, dtype=dtype)
        self.values_l_proj = Linear(l_dim, embed_dim, dtype=dtype)
        self.out_v_proj = Linear(embed_dim, v_dim, dtype=dtype)
        self.out_l_proj = Linear(embed_dim, l_dim, dtype=dtype)

    def forward(self, v, l, l_mask):
        """v: (B, Nv, v_dim); l: (B, Nl, l_dim); l_mask: (B, Nl) 1=valid."""
        H = self.num_heads
        Dh = self.embed_dim // H
        B, Nv, _ = v.shape
        Nl = l.shape[1]
        dt = self.compute_dtype
        q = (self.v_proj(v) * Dh ** -0.5).reshape(B, Nv, H, Dh)
        k = self.l_proj(l).reshape(B, Nl, H, Dh)
        val_v = self.values_v_proj(v).reshape(B, Nv, H, Dh)
        val_l = self.values_l_proj(l).reshape(B, Nl, H, Dh)
        attn = torch.einsum("bvhd,blhd->bhvl", q, k).clamp(-50000, 50000)
        attn_t = attn.transpose(2, 3)
        attn_t = (attn_t - attn_t.amax(-1, keepdim=True)).clamp(-50000, 50000)
        probs_l = attn_t.float().softmax(-1).to(dt)
        if l_mask is not None:
            bias = torch.where(l_mask[:, None, None, :] > 0, 0.0, -9e15)
            attn = attn + bias.to(attn.dtype)
        probs_v = attn.float().softmax(-1).to(dt)
        out_v = torch.einsum("bhvl,blhd->bvhd", probs_v, val_l).reshape(
            B, Nv, self.embed_dim)
        out_l = torch.einsum("bhlv,bvhd->blhd", probs_l, val_v).reshape(
            B, Nl, self.embed_dim)
        return self.out_v_proj(out_v), self.out_l_proj(out_l)


class BiAttentionBlock(nn.Module):
    """Pre-LN bi-attention with layer-scale residuals on the NORMED inputs
    (fuse_helper.py:142-179)."""

    def __init__(self, tcfg: TransformerConfig, lcfg: LanguageConfig,
                 dtype=torch.float32):
        super().__init__()
        v_dim, l_dim = tcfg.d_model, lcfg.hidden_dim
        self.init_value = 1.0 / tcfg.enc_layers
        self.layer_norm_v = LayerNorm(v_dim, eps=1e-6)
        self.layer_norm_l = LayerNorm(l_dim, eps=1e-6)
        self.attn = BiMultiHeadAttention(v_dim, l_dim, tcfg.vl_hidden_dim, 8,
                                         dtype=dtype)
        self.gamma_v = nn.Parameter(torch.empty(v_dim))
        self.gamma_l = nn.Parameter(torch.empty(l_dim))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.constant_(self.gamma_v, self.init_value)
        nn.init.constant_(self.gamma_l, self.init_value)

    def forward(self, visual, lang_hidden, lang_mask):
        v = self.layer_norm_v(visual)
        l = self.layer_norm_l(lang_hidden)
        dv, dl = self.attn(v, l, lang_mask)
        return v + self.gamma_v * dv, l + self.gamma_l * dl


class VLFuse(nn.Module):
    def __init__(self, tcfg: TransformerConfig, lcfg: LanguageConfig,
                 dtype=torch.float32):
        super().__init__()
        self.b_attn = BiAttentionBlock(tcfg, lcfg, dtype=dtype)

    def forward(self, visual, lang_hidden, lang_mask):
        return self.b_attn(visual, lang_hidden, lang_mask)
