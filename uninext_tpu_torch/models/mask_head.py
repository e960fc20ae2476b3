"""The CondInst dynamic mask head, mirroring `uninext_tpu/models/mask_head.py`.

    encoder memory (levels s8, s16, s32) -> MaskHeadSmallConv -> 8-channel
    stride-8 mask features; per instance, the controller's output split into
    three dynamic 1x1 layers over [relative coordinates, mask features] ->
    one logit map, upsampled by `aligned_bilinear` to the mask stride.

The grouped 1x1 convolutions over the instances are one batched product
(B, N, HW, Cin) x (B, N, Cin, Cout), as in the JAX package; `aligned_bilinear`
is its two interpolation matrices. Plain PyTorch: the JAX package has no
hand-written kernel here.
"""
from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import MaskHeadConfig
from .layers import Conv2d


def dynamic_params_split(cfg: MaskHeadConfig, rel_coord: bool, in_channels: int
                         ) -> Tuple[List[int], List[int]]:
    """Per-layer weight and bias sizes of the controller's output;
    `in_channels` is the mask features' width, d_model // 32."""
    ch = cfg.dynamic_mask_channels
    in_ch = in_channels + (2 if rel_coord else 0)
    weight_nums, bias_nums = [], []
    for l in range(cfg.controller_layers):
        if l == 0:
            weight_nums.append(in_ch * ch)
            bias_nums.append(ch)
        elif l == cfg.controller_layers - 1:
            weight_nums.append(ch)
            bias_nums.append(1)
        else:
            weight_nums.append(ch * ch)
            bias_nums.append(ch)
    return weight_nums, bias_nums


def num_gen_params(cfg: MaskHeadConfig, in_channels: int) -> int:
    w, b = dynamic_params_split(cfg, cfg.rel_coord, in_channels)
    return sum(w) + sum(b)


@functools.lru_cache(maxsize=None)
def _aligned_bilinear_matrix(in_size: int, factor: int, device: torch.device,
                             dtype: torch.dtype) -> torch.Tensor:
    """(factor * in_size, in_size) matrix of the reference's aligned_bilinear
    along one axis: replicate-pad right by 1, resize with align_corners=True
    to factor * in_size + 1, replicate-pad left by factor // 2, crop. Made
    once per device, so a request copies nothing to the card, and outside
    inference mode, so training may use it after an evaluation made it."""
    h, p = in_size, factor // 2
    m = np.zeros((factor * h, h), dtype=np.float32)
    for j in range(factor * h):
        c = max(j - p, 0) / factor
        lo = int(np.floor(c))
        frac = c - lo
        m[j, min(lo, h - 1)] += 1 - frac
        m[j, min(lo + 1, h - 1)] += frac
    with torch.inference_mode(False):
        return torch.from_numpy(m).to(device, dtype)


def aligned_bilinear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(..., H, W) -> (..., H * factor, W * factor), CondInst's convention."""
    if factor == 1:
        return x
    H, W = x.shape[-2:]
    my = _aligned_bilinear_matrix(H, factor, x.device, x.dtype)
    mx = _aligned_bilinear_matrix(W, factor, x.device, x.dtype)
    return my @ x @ mx.T


def _up_nearest(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """The JAX package's nearest upsample of (B, H, W, C) to (th, tw): a
    repeat along each axis whose size divides; if the shape still differs,
    the index gather arange(t) * H // t on both axes, with H and W the sizes
    before the repeat (as `uninext_tpu/models/mask_head.py:99-109` does)."""
    H, W = x.shape[1:3]
    x = x.repeat_interleave(th // H if th % H == 0 else 1, dim=1)
    x = x.repeat_interleave(tw // W if tw % W == 0 else 1, dim=2)
    if x.shape[1] != th or x.shape[2] != tw:
        iy = torch.arange(th, device=x.device) * H // th
        ix = torch.arange(tw, device=x.device) * W // tw
        x = x[:, iy][:, :, ix]
    return x


class MaskHeadSmallConv(nn.Module):
    """Decode the encoder memory's levels s8, s16, s32 into 8-channel
    stride-8 mask features (3x3 convolutions in the compute dtype)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = lambda cin, cout: Conv2d(cin, cout, 3, padding=1, dtype=dtype)
        self.lay3 = conv(dim, dim)
        self.lay4 = conv(dim, dim)
        self.jia_dcn = conv(dim, dim)
        self.lay1 = conv(dim, dim // 4)
        self.lay2 = conv(dim // 4, dim // 32)

    def init_weights(self, generator: torch.Generator) -> None:
        """He-uniform kernels, zero biases (the JAX module's initialisers)."""
        with torch.no_grad():
            for conv in (self.lay3, self.lay4, self.jia_dcn, self.lay1, self.lay2):
                bound = math.sqrt(6.0 / conv.weight[0].numel())
                conv.weight.uniform_(-bound, bound, generator=generator)
                conv.bias.zero_()

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        """feats: [(B, H8, W8, C), (B, H16, W16, C), (B, H32, W32, C)] ->
        (B, H8, W8, C // 32)."""
        x = F.relu(self.lay3(feats[-1]))
        x = feats[-2] + _up_nearest(x, *feats[-2].shape[1:3])
        x = F.relu(self.lay4(x))
        x = feats[-3] + _up_nearest(x, *feats[-3].shape[1:3])
        x = F.relu(self.jia_dcn(x))
        x = F.relu(self.lay1(x))
        return F.relu(self.lay2(x))


def dynamic_mask_forward(mask_feats: torch.Tensor, reference_points: torch.Tensor,
                         params: torch.Tensor, cfg: MaskHeadConfig,
                         mask_feat_stride: int = 8) -> torch.Tensor:
    """Per-instance dynamic 1x1 layers over the mask features, in fp32.

    mask_feats (B, H, W, C) at stride 8; reference_points (B, N, 2) instance
    centres (x, y) in input pixels; params (B, N, num_gen_params) the
    controller's output. Returns mask logits (B, N, H * up, W * up) at the
    stride `cfg.mask_out_stride`."""
    B, H, W, C = mask_feats.shape
    N = params.shape[1]
    weight_nums, bias_nums = dynamic_params_split(cfg, cfg.rel_coord, C)
    x = mask_feats.reshape(B, 1, H * W, C).expand(B, N, H * W, C)
    if cfg.rel_coord:
        dev = mask_feats.device
        ys = torch.arange(H, dtype=torch.float32, device=dev) * mask_feat_stride \
            + mask_feat_stride // 2
        xs = torch.arange(W, dtype=torch.float32, device=dev) * mask_feat_stride \
            + mask_feat_stride // 2
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        locations = torch.stack([gx, gy], -1).reshape(1, 1, H * W, 2)
        rel = reference_points[:, :, None, :] - locations
        x = torch.cat([rel, x], -1)
    splits = torch.split(params, weight_nums + bias_nums, dim=-1)
    ws, bs = splits[:len(weight_nums)], splits[len(weight_nums):]
    n_layers = len(weight_nums)
    for l in range(n_layers):
        cout = 1 if l == n_layers - 1 else cfg.dynamic_mask_channels
        # torch conv weight layout (out, in)
        w = ws[l].reshape(B, N, cout, x.shape[-1])
        x = x @ w.transpose(-1, -2) + bs[l].reshape(B, N, 1, cout)
        if l < n_layers - 1:
            x = F.relu(x)
    logits = x.reshape(B, N, H, W)
    return aligned_bilinear(logits, mask_feat_stride // cfg.mask_out_stride)
