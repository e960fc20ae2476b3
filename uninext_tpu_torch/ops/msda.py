"""Multi-scale deformable attention forward (kernel B, `csrc/ms_deform_attn.cu`).

Semantics of `uninext_tpu/ops/msda.py:ms_deform_attn`: for every (query,
head, level, point), bilinearly sample the level's value map at a location
normalised to [0, 1] (grid_sample, align_corners=False, zero padding) and
sum with the attention weights.

Layouts (as in the JAX package):
  value:              (B, S, M, D)         S = sum(H_l * W_l)
  sampling_locations: (B, Lq, M, L, P, 2)  (x, y), fp32
  attention_weights:  (B, Lq, M, L, P)     fp32
  returns:            (B, Lq, M * D)       value dtype
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build


def ms_deform_attn_plain(value: torch.Tensor,
                         spatial_shapes: Sequence[Tuple[int, int]],
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    """One `F.grid_sample` per level, in fp32; the output takes the value
    dtype (the kernel's precision contract)."""
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    v = value.float()
    out = None
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        vl = v[:, start:start + H * W].permute(0, 2, 3, 1).reshape(B * M, D, H, W)
        grid = sampling_locations[:, :, :, lvl].float().permute(0, 2, 1, 3, 4)
        grid = grid.reshape(B * M, Lq, P, 2) * 2 - 1
        s = F.grid_sample(vl, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=False)             # (B*M, D, Lq, P)
        a = attention_weights[:, :, :, lvl].float().permute(0, 2, 1, 3)
        r = (s * a.reshape(B * M, 1, Lq, P)).sum(-1)        # (B*M, D, Lq)
        out = r if out is None else out + r
        start += H * W
    out = out.reshape(B, M, D, Lq).permute(0, 3, 1, 2).reshape(B, Lq, M * D)
    return out.to(value.dtype)


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """Kernel B on a CUDA tensor, the plain version on a CPU tensor."""
    dev = value.device
    if dev.type == "cpu":
        return ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                                    attention_weights)
    if dev.type != "cuda":
        raise ValueError(f"ms_deform_attn: unsupported device {dev}")
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    dtype = _build.dtype_code(value)
    for name, t, shape in (
            ("sampling_locations", sampling_locations, (B, Lq, M, L, P, 2)),
            ("attention_weights", attention_weights, (B, Lq, M, L, P))):
        if t.dtype != torch.float32:
            raise TypeError(f"ms_deform_attn: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"ms_deform_attn: {name} shape {tuple(t.shape)} != {shape}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"ms_deform_attn: {name} must be contiguous on {dev}")
    if not value.is_contiguous():
        raise ValueError("ms_deform_attn: value must be contiguous")
    if L != len(spatial_shapes) or S != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"ms_deform_attn: spatial shapes {spatial_shapes} do not "
                         f"match value length {S} and {L} levels")
    rows, start = [], 0
    for h, w in spatial_shapes:
        rows.append((h, w, start))
        start += h * w
    levels = torch.tensor(rows, dtype=torch.int32)    # host table, passed by value
    out = torch.empty((B, Lq, M * D), dtype=value.dtype, device=dev)
    lib = _build.library("ms_deform_attn")
    fn = lib.ms_deform_attn_fwd
    fn.argtypes = [_build.P] * 5 + [_build.I] * 8 + [_build.P]
    fn.restype = _build.I
    rc = fn(value.data_ptr(), sampling_locations.data_ptr(),
            attention_weights.data_ptr(), out.data_ptr(),
            ctypes.c_void_p(levels.data_ptr()), B, S, Lq, M, D, L, P,
            dtype, _build.stream_of(value))
    _build.check(lib, rc, "ms_deform_attn_fwd")
    ms_deform_attn.launches += 1
    return out


ms_deform_attn.launches = 0
