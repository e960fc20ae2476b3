"""Prediction heads, mirroring `uninext_tpu/models/heads.py`: the VL
alignment classifier and the binary encoder classifier (fp32)."""
from __future__ import annotations

import math

import torch
from torch import nn

from ..config import TransformerConfig

from .layers import Linear


class VLAlign(nn.Module):
    """Query/token alignment logits (deformable_detr.py:35-68): L2-normalised
    text embedding, /2 projection, log-scale temperature, language bias,
    +/-50000 clamp."""

    def __init__(self, c: TransformerConfig, lang_dim: int = 768):
        super().__init__()
        self.cfg = c
        self.dot_product_projection_text = Linear(lang_dim, c.d_model)
        self.log_scale = nn.Parameter(torch.empty(1))
        self.bias_lang = nn.Parameter(torch.empty(lang_dim))
        self.bias0 = nn.Parameter(torch.empty(1))

    def init_weights(self, generator: torch.Generator) -> None:
        c = self.cfg
        nn.init.constant_(self.log_scale, c.log_scale)
        nn.init.zeros_(self.bias_lang)
        nn.init.constant_(self.bias0, -math.log((1 - c.prior_prob) / c.prior_prob))

    def forward(self, x: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
        """x: (B, Q, C) queries; embedding: (B, T, C_l) -> (B, Q, T)."""
        emb = embedding / torch.linalg.norm(embedding, dim=-1,
                                            keepdim=True).clamp(min=1e-12)
        tokens = self.dot_product_projection_text(emb / 2.0)
        token_bias = torch.einsum("blc,c->bl", emb, self.bias_lang) + self.bias0
        logits = (torch.einsum("bqc,blc->bql", x.float(), tokens.float())
                  / self.log_scale.exp()) + token_bias[:, None, :]
        if self.cfg.clamp_dot_product:
            logits = logits.clamp(-50000, 50000)
        return logits


class StillClassifier(nn.Module):
    """Binary objectness head (deformable_detr.py:70-76)."""

    def __init__(self, d_model: int, prior_prob: float = 0.01):
        super().__init__()
        self.prior_prob = prior_prob
        self.body = Linear(d_model, 1)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.constant_(self.body.bias,
                          -math.log((1 - self.prior_prob) / self.prior_prob))

    def forward(self, x: torch.Tensor, lang_feat=None) -> torch.Tensor:
        return self.body(x.float())
