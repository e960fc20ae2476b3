"""Shared layers, mirroring `uninext_tpu/models/layers.py`.

Precision follows the flax modules: a `Linear` or `Conv2d` built with a
`dtype` casts its input and parameters to that dtype at each call (flax
`Dense(dtype=...)`); `LayerNorm` and `GroupNorm` normalise in fp32 and
return fp32 (flax norms with fp32 parameters promote to fp32). Parameters
are stored in fp32. Module attribute names follow the reference UNINEXT
checkpoint, so `state_dict()` keys are the reference keys.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.msda import ms_deform_attn
from ..parallel.comm import reduce_from_model
from ..utils.misc import host_constant


def trunc_normal_(w: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """`w` from a normal of scale `std` truncated at +/-2 `std` (JAX's
    `random.truncated_normal(-2, 2) * std`), drawn by inverting the CDF of
    a uniform draw from `generator`."""
    lo = 0.5 * math.erfc(math.sqrt(2.0))           # the normal's CDF at -2
    with torch.no_grad():
        w.uniform_(2 * lo - 1, 1 - 2 * lo, generator=generator)
        w.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)
    return w


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel initialiser `lecun_normal`: the truncated
    normal of `trunc_normal_`, scaled so that its standard deviation is
    1 / sqrt(fan_in) (no value beyond 2.2737 of it)."""
    return trunc_normal_(w, 1.0 / math.sqrt(fan_in) / 0.87962566103423978, generator)


class Linear(nn.Linear):
    """nn.Linear computing in `dtype` (flax Dense with `dtype`). A
    row-parallel shard (`reduce_group` set by `parallel/sharding.py:
    shard_module`) sums its partial outputs over that group in fp32 and adds
    its bias once, after the sum."""

    reduce_group = None

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.reduce_group is None:
            return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))
        y = reduce_from_model(F.linear(x.to(dt), self.weight.to(dt)).float(),
                              self.reduce_group)
        return (y + self.bias.float()).to(dt)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in `dtype`, on NHWC tensors (the JAX layout)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        # the NCHW view of an NHWC tensor is channels-last strided, which
        # cuDNN takes as it is; its output is channels-last too
        y = self._conv_forward(x.to(dt).permute(0, 3, 1, 2),
                               self.weight.to(dt), bias)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.LayerNorm):
    """LayerNorm in fp32 (flax LayerNorm with fp32 parameters)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class GroupNorm(nn.GroupNorm):
    """GroupNorm in fp32 on NHWC tensors (flax GroupNorm)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float().permute(0, 3, 1, 2), self.num_groups,
                         self.weight, self.bias, self.eps)
        return y.permute(0, 2, 3, 1)


class MLP(nn.Module):
    """fp32 MLP with ReLU between layers (deformable_detr.py:917-929)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1]) for i in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class FeatureResizer(nn.Module):
    """Linear + LayerNorm(eps 1e-12) (deformable_transformer.py:510-529)."""

    def __init__(self, input_dim: int, output_dim: int):
        super().__init__()
        self.fc = Linear(input_dim, output_dim)
        self.layer_norm = LayerNorm(output_dim, eps=1e-12)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer_norm(self.fc(x))


def sampling_offsets_bias(n_heads: int, n_levels: int, n_points: int
                          ) -> torch.Tensor:
    """Directional ring init of the sampling offsets (ms_deform_attn.py:62-70)."""
    thetas = torch.arange(n_heads, dtype=torch.float32) * (2.0 * math.pi / n_heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True).values
    grid = grid[:, None, None, :].repeat(1, n_levels, n_points, 1)
    scales = torch.arange(1, n_points + 1, dtype=torch.float32)[None, None, :, None]
    return (grid * scales).reshape(-1)


class MSDeformAttn(nn.Module):
    """Projections around MSDA (uninext_tpu/models/layers.py:73-133).

    forward(query (B,Lq,C), reference_points (B,Lq,L,2|4), value_flatten
    (B,S,C), value_mask (B,S) True=padding, spatial_shapes) -> (B,Lq,C).
    Offsets and weights are computed in fp32; the locations and attention
    weights are rounded to the value's dtype before the op, as the JAX
    module does, and reach the kernel as fp32 tensors holding those values.
    The kernel then folds the corners and sums in fp32, where the JAX op
    rounds each corner product and the four-corner sum to bf16
    (uninext_tpu/ops/msda.py:201-208): in bf16 the two differ by about one
    output rounding step."""

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.d_model = d_model
        self.sampling_offsets = Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = Linear(d_model, d_model, dtype=dtype)
        self.output_proj = Linear(d_model, d_model, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.sampling_offsets.weight)
        with torch.no_grad():
            self.sampling_offsets.bias.copy_(sampling_offsets_bias(
                self.n_heads, self.n_levels, self.n_points))
        nn.init.zeros_(self.attention_weights.weight)

    def forward(self, query, reference_points, value_flatten, value_mask,
                spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        B, Lq, _ = query.shape
        S = value_flatten.shape[1]
        M, L, P = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(value_flatten)
        if value_mask is not None:
            value = value.masked_fill(value_mask[..., None], 0.0)
        value = value.reshape(B, S, M, self.d_model // M)
        q32 = query.float()
        offsets = self.sampling_offsets(q32).reshape(B, Lq, M, L, P, 2)
        attn = self.attention_weights(q32).reshape(B, Lq, M, L * P)
        attn = attn.softmax(-1).reshape(B, Lq, M, L, P)
        if reference_points.shape[-1] == 2:
            normalizer = host_constant([[w, h] for h, w in spatial_shapes],
                                       torch.float32, query.device)
            loc = (reference_points[:, :, None, :, None, :]
                   + offsets / normalizer[None, None, None, :, None, :])
        else:
            loc = (reference_points[:, :, None, :, None, :2]
                   + offsets / P * reference_points[:, :, None, :, None, 2:] * 0.5)
        out = ms_deform_attn(value.contiguous(), tuple(spatial_shapes),
                             loc.to(value.dtype).float().contiguous(),
                             attn.to(value.dtype).float().contiguous())
        return self.output_proj(out)


class MultiHeadAttention(nn.Module):
    """Decoder self-attention with the parameters of torch
    nn.MultiheadAttention (in_proj_weight/in_proj_bias/out_proj), computed
    as uninext_tpu/models/layers.py:136-162. A bool `attn_mask` of shape
    (Lq, Lk) or (B, Lq, Lk) blocks where True."""

    def __init__(self, d_model: int, n_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_heads = n_heads
        self.compute_dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = Linear(d_model, d_model, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        d = self.in_proj_weight.shape[1]
        lecun_normal_(self.in_proj_weight, d, generator)
        nn.init.zeros_(self.in_proj_bias)

    def forward(self, q, k, v, attn_mask: Optional[torch.Tensor] = None):
        dt = self.compute_dtype
        H = self.n_heads
        B, Lq, C = q.shape
        Lk = k.shape[1]
        Dh = C // H
        w = self.in_proj_weight.to(dt).chunk(3)
        bias = self.in_proj_bias.to(dt).chunk(3)
        qh = F.linear(q.to(dt), w[0], bias[0]).reshape(B, Lq, H, Dh)
        kh = F.linear(k.to(dt), w[1], bias[1]).reshape(B, Lk, H, Dh)
        vh = F.linear(v.to(dt), w[2], bias[2]).reshape(B, Lk, H, Dh)
        scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(Dh)
        if attn_mask is not None:
            m = attn_mask[None, None] if attn_mask.dim() == 2 else attn_mask[:, None]
            scores = scores.masked_fill(m, -1e9)
        probs = scores.float().softmax(-1).to(dt)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(B, Lq, C)
        return self.out_proj(out)


def get_sine_pos_embed(pos: torch.Tensor, num_pos_feats: int = 128,
                       temperature: int = 10000) -> torch.Tensor:
    """Sine embedding of box coordinates for the DAB/DINO query position,
    x and y exchanged. pos: (B, N, n) in [0, 1] -> (B, N, n*num_pos_feats)."""
    scale = 2 * math.pi
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)

    def sine(x):
        sx = x * scale / dim_t
        return torch.stack([sx[:, :, 0::2].sin(), sx[:, :, 1::2].cos()],
                           dim=3).flatten(2)

    parts = [sine(pos[..., i:i + 1]) for i in range(pos.shape[-1])]
    if len(parts) >= 2:
        parts[0], parts[1] = parts[1], parts[0]
    return torch.cat(parts, dim=2)
