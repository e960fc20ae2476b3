"""Sine positional embedding over padded feature maps, mirroring
`uninext_tpu/models/position_encoding.py:position_embedding_sine`."""
from __future__ import annotations

import math

import torch


def position_embedding_sine(mask: torch.Tensor, num_pos_feats: int = 128,
                            temperature: int = 10000,
                            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """mask: (B, H, W) bool, True = padding. Returns (B, H, W, 2*num_pos_feats)."""
    not_mask = (~mask).float()
    y_embed = not_mask.cumsum(1)
    x_embed = not_mask.cumsum(2)
    eps = 1e-6
    scale = 2 * math.pi
    y_embed = (y_embed - 0.5) / (y_embed[:, -1:, :] + eps) * scale
    x_embed = (x_embed - 0.5) / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        dim=-1).flatten(-2)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        dim=-1).flatten(-2)
    return torch.cat([pos_y, pos_x], dim=-1).to(dtype)
