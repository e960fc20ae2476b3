"""Multi-scale deformable attention: MSDA and its backward MSDA-bwd, both
in `csrc/ms_deform_attn.cu`.

Semantics of `uninext_tpu/ops/msda.py:ms_deform_attn`: for every (query,
head, level, point), bilinearly sample the level's value map at a location
normalised to [0, 1] (grid_sample, align_corners=False, zero padding) and
sum with the attention weights.

Layouts (as in the JAX package):
  value:              (B, S, M, D)         S = sum(H_l * W_l)
  sampling_locations: (B, Lq, M, L, P, 2)  (x, y), fp32
  attention_weights:  (B, Lq, M, L, P)     fp32
  returns:            (B, Lq, M * D)       value dtype

The kernels read a value row in 16-byte pieces, so on the card D must be a
multiple of 8 up to 256 in bf16, or of 4 up to 128 in fp32; any other D
raises `ValueError` before a launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..utils.misc import recomputing
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


def _levels_table(spatial_shapes, S: int, L: int) -> torch.Tensor:
    """Host int32 (L, 3) table of (H_l, W_l, start_l), which the C entry
    points copy into the launch parameters. Made once per level shapes: the
    table is never written, and serving and training repeat a few shapes."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if L != len(shapes) or S != sum(h * w for h, w in shapes):
        raise ValueError(f"ms_deform_attn: spatial shapes {spatial_shapes} do not "
                         f"match value length {S} and {L} levels")
    return _levels_of(shapes)


@functools.lru_cache(maxsize=64)
def _levels_of(shapes: Tuple[Tuple[int, int], ...]) -> torch.Tensor:
    rows, start = [], 0
    for h, w in shapes:
        rows.append((h, w, start))
        start += h * w
    return torch.tensor(rows, dtype=torch.int32)


def _check_inputs(value, sampling_locations, attention_weights):
    dev = value.device
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    for name, t, shape in (
            ("sampling_locations", sampling_locations, (B, Lq, M, L, P, 2)),
            ("attention_weights", attention_weights, (B, Lq, M, L, P))):
        if t.dtype != torch.float32:
            raise TypeError(f"ms_deform_attn: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"ms_deform_attn: {name} shape {tuple(t.shape)} != {shape}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"ms_deform_attn: {name} must be contiguous on {dev}")
    if not value.is_contiguous() or value.data_ptr() % 16:
        raise ValueError("ms_deform_attn: value must be contiguous and 16-byte aligned")
    # the kernels read a row in 16-byte pieces, one lane each, at most 32
    per_piece = 8 if value.dtype == torch.bfloat16 else 4
    if D % per_piece or not 0 < D <= 32 * per_piece:
        raise ValueError(f"ms_deform_attn: head width D={D} in {value.dtype} must be a "
                         f"multiple of {per_piece} up to {32 * per_piece}")


@functools.cache
def _entry(name: str):
    """The C entry point `name` of the MSDA library, with its signature."""
    fn = getattr(_build.library("ms_deform_attn"), name)
    n_ptr = {"ms_deform_attn_fwd": 5, "ms_deform_attn_bwd": 8}[name]
    fn.argtypes = [_build.P] * n_ptr + [_build.I] * 8 + [_build.P]
    fn.restype = _build.I
    return fn


def ms_deform_attn_kernel(value: torch.Tensor,
                          spatial_shapes: Sequence[Tuple[int, int]],
                          sampling_locations: torch.Tensor,
                          attention_weights: torch.Tensor) -> torch.Tensor:
    """Launch MSDA on CUDA tensors (no autograd)."""
    _check_inputs(value, sampling_locations, attention_weights)
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    dtype = _build.dtype_code(value)
    levels = _levels_table(spatial_shapes, S, L)
    out = torch.empty((B, Lq, M * D), dtype=value.dtype, device=value.device)
    rc = _entry("ms_deform_attn_fwd")(
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), out.data_ptr(),
        ctypes.c_void_p(levels.data_ptr()), B, S, Lq, M, D, L, P, dtype,
        _build.stream_of(value))
    _build.check(_build.library("ms_deform_attn"), rc, "ms_deform_attn_fwd")
    ms_deform_attn.launches += 1
    if recomputing():
        ms_deform_attn.recompute_launches += 1
    return out


def ms_deform_attn_bwd(value: torch.Tensor,
                       spatial_shapes: Sequence[Tuple[int, int]],
                       sampling_locations: torch.Tensor,
                       attention_weights: torch.Tensor, dout: torch.Tensor):
    """Launch MSDA-bwd on CUDA tensors. Returns (dvalue in the value dtype,
    dloc fp32, datt fp32). dvalue is summed with fp32 vector reductions, so
    its last bits vary from run to run."""
    _check_inputs(value, sampling_locations, attention_weights)
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    dtype = _build.dtype_code(value)
    levels = _levels_table(spatial_shapes, S, L)
    dout = dout.to(value.dtype).contiguous()
    if tuple(dout.shape) != (B, Lq, M * D) or dout.data_ptr() % 16:
        raise ValueError(f"ms_deform_attn_bwd: dout shape {tuple(dout.shape)} != "
                         f"{(B, Lq, M * D)} or not 16-byte aligned")
    dev = value.device
    dvalue = torch.zeros((B, S, M, D), dtype=torch.float32, device=dev)
    dloc = torch.empty((B, Lq, M, L, P, 2), dtype=torch.float32, device=dev)
    datt = torch.empty((B, Lq, M, L, P), dtype=torch.float32, device=dev)
    rc = _entry("ms_deform_attn_bwd")(
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), dout.data_ptr(), dvalue.data_ptr(),
        dloc.data_ptr(), datt.data_ptr(), ctypes.c_void_p(levels.data_ptr()),
        B, S, Lq, M, D, L, P, dtype, _build.stream_of(value))
    _build.check(_build.library("ms_deform_attn"), rc, "ms_deform_attn_bwd")
    ms_deform_attn_bwd.launches += 1
    return dvalue.to(value.dtype), dloc, datt


class _MSDeformAttn(torch.autograd.Function):
    """MSDA forward, MSDA-bwd backward."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations, attention_weights):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return ms_deform_attn_kernel(value, spatial_shapes, sampling_locations,
                                     attention_weights)

    @staticmethod
    def backward(ctx, dout):
        value, loc, att = ctx.saved_tensors
        dvalue, dloc, datt = ms_deform_attn_bwd(value, ctx.spatial_shapes, loc,
                                                att, dout)
        return dvalue, None, dloc, datt


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """MSDA on CUDA tensors (differentiable: its backward is MSDA-bwd), the
    plain version (differentiable by autograd) on CPU tensors. `launches`
    counts MSDA's launches; `recompute_launches` those of them made while a
    checkpointed layer is recomputed for the backward."""
    dev = value.device
    if dev.type == "cpu":
        return ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                                    attention_weights)
    if dev.type != "cuda":
        raise ValueError(f"ms_deform_attn: unsupported device {dev}")
    if not torch.is_grad_enabled() or not any(
            t.requires_grad for t in (value, sampling_locations, attention_weights)):
        return ms_deform_attn_kernel(value, spatial_shapes, sampling_locations,
                                     attention_weights)
    return _MSDeformAttn.apply(value, tuple(spatial_shapes), sampling_locations,
                               attention_weights)


ms_deform_attn.launches = 0
ms_deform_attn.recompute_launches = 0
ms_deform_attn_bwd.launches = 0
