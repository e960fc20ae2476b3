"""ConvNeXt (the reference's D2ConvNeXt), NHWC, mirroring
`uninext_tpu/models/convnext.py`: a 4x4/4 stem and LayerNorm, LayerNorm
then a 2x2/2 convolution between stages, blocks of a depthwise 7x7
convolution, LayerNorm (eps 1e-6), a pointwise MLP (4x, exact GELU) and the
layer scale `gamma`, with stochastic depth on the block's branch; outputs
res3, res4 and res5 (strides 8, 16, 32) through their own LayerNorms.

Tensors stay NHWC throughout, as in `models/resnet.py`: the convolutions
hand cuDNN the channels-last NCHW view, the LayerNorms and the pointwise
MLP act on the last axis, and no layout copy runs between blocks.

Precision follows the flax module: the convolutions and the MLP compute in
the compute dtype, the LayerNorms return fp32 (flax norms with fp32
parameters promote), and `gamma * x` is fp32, so the residual stream is
fp32 from the first block on and res3-res5 come out fp32.

Parameter names follow the reference checkpoint (`uninext_tpu/engine/
convert.py:convert_convnext` reads them): downsample_layers.0.{0,1} (stem
conv, stem norm), downsample_layers.{i}.{0,1} (norm, conv) for i >= 1,
stages.{i}.{j}.{dwconv,norm,pwconv1,pwconv2,gamma} and norm{1,2,3} (the out
norms of res3-res5).

Inputs are padded to a multiple of 32, where the JAX convolutions' "SAME"
padding of the stem and the downsampling adds nothing; here they take none.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import rows_of_draw
from .layers import Conv2d, LayerNorm, Linear


class LayerScale(nn.Module):
    """The per-channel layer scale `gamma` (`weight`, (dim,)), initialised
    to `init` (D2ConvNeXt's 1.0, not the paper's 1e-6)."""

    def __init__(self, dim: int, init: float):
        super().__init__()
        self.init = init
        self.weight = nn.Parameter(torch.empty(dim))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.constant_(self.weight, self.init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.weight * x


class Block(nn.Module):
    """dwconv 7x7 -> LN -> pwconv1 (4x) -> GELU -> pwconv2 -> gamma ->
    drop-path -> residual. `drop` is None or the (B,) stochastic-depth
    mask (0 or 1) of `drop_path_mask`, with its keep probability."""

    def __init__(self, dim: int, layer_scale_init: float, dtype: torch.dtype):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 7, padding=3, groups=dim, dtype=dtype)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = Linear(dim, 4 * dim, dtype=dtype)
        self.pwconv2 = Linear(4 * dim, dim, dtype=dtype)
        self.gamma = LayerScale(dim, layer_scale_init)

    def forward(self, x: torch.Tensor, drop=None) -> torch.Tensor:
        y = self.pwconv1(self.norm(self.dwconv(x)))
        y = self.gamma(self.pwconv2(F.gelu(y)))
        if drop is not None:
            mask, keep = drop
            y = y * mask.reshape(-1, 1, 1, 1) / keep
        return x + y


def drop_path_mask(batch: int, rate: float, generator: Optional[torch.Generator],
                   device, mesh=None):
    """A block's per-sample stochastic-depth mask: (B,) of 0 or 1, kept
    with probability 1 - rate (the JAX block's `bernoulli` on its
    'droppath' rng, whose stream is not reproduced), and the keep
    probability. Under data parallelism (`mesh`) the draw is the whole
    batch's, cut to this rank's rows."""
    keep = 1.0 - rate
    u = rows_of_draw(lambda n: torch.rand((n,), generator=generator, device=device),
                     batch, mesh)
    return (u < keep).float(), keep


class ConvNeXt(nn.Module):
    """ConvNeXt-L defaults: (B, H, W, in_channels) -> {res3, res4, res5},
    NHWC, fp32."""

    def __init__(self, depths: Sequence[int] = (3, 3, 27, 3),
                 dims: Sequence[int] = (192, 384, 768, 1536), drop_path_rate: float = 0.0,
                 in_channels: int = 3, layer_scale_init: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.drop_path_rates = [float(r) for r in np.linspace(0, drop_path_rate, sum(depths))]
        down = [nn.Sequential(Conv2d(in_channels, dims[0], 4, stride=4, dtype=dtype),
                              LayerNorm(dims[0], eps=1e-6))]
        for i in range(1, 4):
            down.append(nn.Sequential(LayerNorm(dims[i - 1], eps=1e-6),
                                      Conv2d(dims[i - 1], dims[i], 2, stride=2, dtype=dtype)))
        self.downsample_layers = nn.ModuleList(down)
        self.stages = nn.ModuleList(
            nn.ModuleList(Block(dims[i], layer_scale_init, dtype) for _ in range(depths[i]))
            for i in range(4))
        for i in range(1, 4):
            self.add_module(f"norm{i}", LayerNorm(dims[i], eps=1e-6))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, mesh=None
                ) -> Dict[str, torch.Tensor]:
        """`train` turns on stochastic depth (masks from `generator`, this
        rank's rows of the whole batch's under a `mesh`)."""
        x = x.to(self.compute_dtype)
        B = x.shape[0]
        rates = iter(self.drop_path_rates)
        outs = {}
        for i in range(4):
            x = self.downsample_layers[i](x)
            for blk in self.stages[i]:
                rate = next(rates)
                drop = (drop_path_mask(B, rate, generator, x.device, mesh)
                        if train and rate > 0 else None)
                x = blk(x, drop)
            if i >= 1:
                outs[f"res{i + 2}"] = getattr(self, f"norm{i}")(x)
        return outs
