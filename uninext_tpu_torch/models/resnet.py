"""ResNet-50 with frozen batch norm, NHWC, mirroring
`uninext_tpu/models/resnet.py` (detectron2's `build_resnet_backbone` with
FrozenBN, STRIDE_IN_1X1=False and FREEZE_AT=2; outputs res3, res4, res5 at
strides 8, 16 and 32).

Tensors stay NHWC from the stem to res5: each `Conv2d` hands cuDNN the
NCHW view of its NHWC input, which is channels-last strided, and gets a
channels-last output back, so no layout copy runs between convolutions.

Parameter names follow detectron2's ResNet, so `state_dict()` keys are the
reference checkpoint's (`uninext_tpu/engine/convert.py:convert_resnet`
reads them): stem.conv1, stem.conv1.norm.{weight,bias,running_mean,
running_var}, res{s}.{b}.conv{k}, res{s}.{b}.conv{k}.norm.*,
res{s}.{b}.shortcut and res{s}.{b}.shortcut.norm.*.

The four tensors of a frozen batch norm are parameters, as in the JAX
package, and take part in autograd; the optimizer's groups keep the stem,
res2 and every mean and var at a learning rate of 0
(`engine/optimizer.py:classify_param`).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d


class FrozenBatchNorm(nn.Module):
    """y = x * mul + add with mul = scale / sqrt(var + eps) and
    add = bias - mean * scale / sqrt(var + eps), both formed in fp32 and
    rounded to the compute dtype, in which the multiply-add runs."""

    EPS = 1e-5

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.running_mean = nn.Parameter(torch.empty(features))
        self.running_var = nn.Parameter(torch.empty(features))

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        root = torch.sqrt(self.running_var + self.EPS)
        mul = (self.weight / root).to(dt)
        add = (self.bias - self.running_mean * self.weight / root).to(dt)
        return x * mul + add


class ConvNorm(Conv2d):
    """detectron2's Conv2d with its `norm`: a bias-free convolution, then a
    frozen batch norm."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, k, stride=stride, padding=k // 2,
                         bias=False, dtype=dtype)
        self.norm = FrozenBatchNorm(cout, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(super().forward(x))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (with the stride) -> 1x1, a projected shortcut in the
    first block of a stage."""

    def __init__(self, cin: int, cout: int, stride: int, dtype: torch.dtype):
        super().__init__()
        mid = cout // 4
        if cin != cout or stride != 1:
            self.shortcut = ConvNorm(cin, cout, 1, stride, dtype)
        else:
            self.shortcut = None
        self.conv1 = ConvNorm(cin, mid, 1, dtype=dtype)
        self.conv2 = ConvNorm(mid, mid, 3, stride, dtype)
        self.conv3 = ConvNorm(mid, cout, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        sc = x if self.shortcut is None else self.shortcut(x)
        return F.relu(out + sc)


class _Stem(nn.Module):
    def __init__(self, in_channels: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = ConvNorm(in_channels, 64, 7, 2, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv1(x))
        # 3x3/2 max-pool, padded with -inf as flax's max_pool pads
        y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1)
        return y.permute(0, 2, 3, 1)


class ResNet(nn.Module):
    """ResNet-50 trunk: (B, H, W, in_channels) -> {res3, res4, res5}, NHWC,
    in the compute dtype."""

    STAGE_BLOCKS = (3, 4, 6, 3)

    def __init__(self, in_channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.stem = _Stem(in_channels, dtype)
        cin, cout = 64, 256
        for s, n_blocks in enumerate(self.STAGE_BLOCKS):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if s > 0 and b == 0 else 1
                blocks.append(Bottleneck(cin, cout, stride, dtype))
                cin = cout
            self.add_module(f"res{s + 2}", nn.Sequential(*blocks))
            cout *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x.to(self.compute_dtype))
        outs = {}
        for s in range(2, 6):
            x = getattr(self, f"res{s}")(x)
            if s >= 3:
                outs[f"res{s}"] = x
        return outs
