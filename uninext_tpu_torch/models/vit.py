"""Plain ViT backbone with windowed attention (ViTDet), NHWC, mirroring
`uninext_tpu/models/vit.py`.

Every block's attention goes through `flash_rel_pos_attention`, the wrapper
of kernel A: on a CUDA tensor both the global blocks (the whole grid) and
the windowed blocks (14 x 14 windows as a batch) launch it, in bf16 on the
tensor cores (`csrc/rel_pos_flash_attn_mma.cu`), in fp32 on the CUDA cores
(`csrc/rel_pos_flash_attn.cu`); each route counts its own launches. The JAX package's `H*W >= 2048` flash gate and its q-row
chunking were decisions for the TPU and are not carried over. Under
autograd the wrapper is a `torch.autograd.Function` whose backward is
kernel A-bwd, again with two routes: bf16 on the tensor cores
(`csrc/rel_pos_flash_attn_bwd_mma.cu`), fp32 on the CUDA cores
(`csrc/rel_pos_flash_attn_bwd.cu`).

Training adds stochastic depth (masks drawn before each block from an
explicit generator) and per-block activation checkpointing
(`torch.utils.checkpoint`, the JAX package's `nn.remat` of each block).

Under tensor parallelism (`parallel/sharding.py:shard_module`) each block
holds nh / k heads: qkv and fc1 are column-parallel, proj and fc2
row-parallel, and the attention, global and windowed, is A′
(`flash_rel_pos_attention_tp`: kernel A on the rank's heads). The JAX
package's ViT turns its flash path off under a "model" axis; the outputs
are the same.

Parameter names follow the reference D2ViT (`backbone/vit.py:233-432`):
patch_embed.proj, pos_embed, blocks.{i}.{norm1,attn.{qkv,proj,rel_pos_h,
rel_pos_w},norm2,mlp.{fc1,fc2}}, fpn1.0 (the 2x2 stride-2 deconvolution
that makes res3).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import _build
from ..parallel.comm import copy_to_model
from ..parallel.mesh import rows_of_draw
from ..utils.misc import checkpointed, recomputing
from .layers import Conv2d, LayerNorm, Linear, trunc_normal_


def interp_abs_pos(pos_embed: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Reference get_abs_pos: strip the cls token, reshape square, bicubic
    (a = -0.75, half-pixel centres, edge-clamped taps) to (h, w).
    Returns (1, h, w, C)."""
    pos_embed = pos_embed[:, 1:]
    n = pos_embed.shape[1]
    s = int(round(math.sqrt(n)))
    grid = pos_embed.reshape(1, s, s, -1)
    if (s, s) != (h, w):
        grid = F.interpolate(grid.float().permute(0, 3, 1, 2), size=(h, w),
                             mode="bicubic", align_corners=False)
        grid = grid.permute(0, 2, 3, 1)
    return grid


def linear_resize_weights(in_size: int, out_size: int,
                          device: torch.device) -> torch.Tensor:
    """(in_size, out_size) weights of `jax.image.resize(..., "linear")` along
    one axis: a triangle filter at half-pixel centres, WIDENED by in/out when
    shrinking (JAX antialiases by default), columns normalised to sum 1.
    `F.interpolate(mode="linear")` does not widen the filter, so the two
    differ when the table shrinks."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=device)
                 + 0.5) * inv_scale - 0.5)
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    x = (sample_f[None, :] - src[:, None]).abs() / kernel_scale
    weights = (1.0 - x).clamp(min=0.0)
    total = weights.sum(0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def interp_rel_pos(rel_pos: torch.Tensor, size: int) -> torch.Tensor:
    """Resize a (L, hd) rel-pos table to (2*size-1, hd) exactly as the JAX
    package does (`interp_rel_pos`, which calls jax.image.resize)."""
    max_rel = 2 * size - 1
    if rel_pos.shape[0] == max_rel:
        return rel_pos
    w = linear_resize_weights(rel_pos.shape[0], max_rel, rel_pos.device)
    return torch.einsum("io,id->od", w, rel_pos.float())


def rel_pos_attention_plain(q, k, v, Rh, Rw, scale: float) -> torch.Tensor:
    """The whole attention matrix in fp32: softmax(scale*q.k + bh + bw) v,
    with the bias from the unscaled q. q: (B, H, W, nh, hd); k, v:
    (B, S, nh, hd); Rh: (H, H, hd); Rw: (W, W, hd). Returns (B, H, W,
    nh*hd) in q's dtype."""
    B, H, W, nh, hd = q.shape
    S = H * W
    qf, kf, vf = q.float(), k.float(), v.float()
    attn = torch.einsum("byxhd,bkhd->bhyxk", qf * scale, kf)
    bh = torch.einsum("byxhd,yid->bhyxi", qf, Rh.float())
    bw = torch.einsum("byxhd,xjd->bhyxj", qf, Rw.float())
    attn = (attn.reshape(B, nh, H, W, H, W) + bh[..., :, None]
            + bw[..., None, :]).reshape(B, nh, S, S)
    out = torch.einsum("bhqk,bkhd->bqhd", attn.softmax(-1), vf)
    return out.reshape(B, H, W, nh * hd).to(q.dtype)


def _check_attention_inputs(q, k, v, Rh, Rw):
    B, H, W, nh, hd = q.shape
    S = H * W
    q3 = q.reshape(B, S, nh, hd)             # a view for the slices of qkv
    for name, t, shape in (("k", k, (B, S, nh, hd)), ("v", v, (B, S, nh, hd)),
                           ("Rh", Rh, (H, H, hd)), ("Rw", Rw, (W, W, hd))):
        if tuple(t.shape) != shape:
            raise ValueError(f"flash_rel_pos_attention: {name} shape "
                             f"{tuple(t.shape)} != {shape}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_rel_pos_attention: {name} must be "
                             f"{q.dtype} on {q.device}")
    if not (q3.stride() == k.stride() == v.stride()) or q3.stride(-1) != 1:
        raise ValueError("flash_rel_pos_attention: q, k, v need equal strides "
                         "and a unit last stride")
    if not (Rh.is_contiguous() and Rw.is_contiguous()):
        raise ValueError("flash_rel_pos_attention: Rh, Rw must be contiguous")
    return q3


def _dev_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


@functools.lru_cache(maxsize=None)
def _smem_check(lib_name: str, H: int, W: int, hd: int, dev_index: int) -> None:
    """Raise if the kernel's shared memory at these sizes exceeds the card's
    limit (memoised: a check per shape, not per launch)."""
    fn = getattr(_build.library(lib_name), f"{lib_name}_smem_bytes")
    fn.argtypes = [_build.I] * 3
    fn.restype = _build.LL
    smem = fn(H, W, hd)
    limit = torch.cuda.get_device_properties(dev_index).shared_memory_per_block_optin
    if hd > 128 or smem > limit:
        raise ValueError(f"{lib_name}: hd={hd}, grid {H}x{W} needs {smem} B of "
                         f"shared memory (limit {limit}, hd <= 128)")


# ctypes signatures of the C entry points: pointers, ints, strides, [the
# bias tables' strides], scale, [dtype], stream
_P, _I, _LL, _F = _build.P, _build.I, _build.LL, _build.F
_LLP = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "rel_pos_flash_attn_mma": [_P] * 7 + [_I] * 5 + [_LL] * 3 + [_LLP] * 2 + [_F, _P],
    "rel_pos_flash_attn": [_P] * 7 + [_I] * 5 + [_LL] * 3 + [_F, _P],
    "rel_pos_flash_attn_bwd_mma": [_P] * 13 + [_I] * 5 + [_LL] * 6 + [_LLP] * 2 + [_F, _P],
    "rel_pos_flash_attn_bwd": [_P] * 13 + [_I] * 5 + [_LL] * 3 + [_LLP] * 2 + [_F, _P],
}


def _strides(t) -> ctypes.Array:
    """The strides of a bias table but its unit last one, for the C side."""
    return (ctypes.c_longlong * 4)(*t.stride()[:4])


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The C entry point `name` of library `name`, its signature set once."""
    fn = getattr(_build.library(name), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = _build.I
    return fn


def rel_pos_bias(q, Rh, Rw):
    """The decomposed rel-pos bias of kernel A's scores, fp32, from the
    unscaled q: bh[b,h,y,x,i] = q[b,y,x,h].Rh[y,i] (B, nh, H, W, H) and
    bw[b,h,y,x,j] = q[b,y,x,h].Rw[x,j] (B, nh, H, W, W), as strided views
    with a unit last stride. Each is one batched product (over grid rows y
    for bh, grid columns x for bw), fp32 out of bf16 inputs, whose output
    the kernels read where it lies. The JAX package, too, forms them with
    einsums outside its Pallas call."""
    B, H, W, nh, hd = q.shape
    qy = q.permute(1, 0, 2, 3, 4).reshape(H, B * W * nh, hd)
    qx = q.permute(2, 0, 1, 3, 4).reshape(W, B * H * nh, hd)
    bh = _bmm_f32(qy, Rh.transpose(1, 2)).view(H, B, W, nh, H)
    bw = _bmm_f32(qx, Rw.transpose(1, 2)).view(W, B, H, nh, W)
    return bh.permute(1, 3, 0, 2, 4), bw.permute(1, 3, 2, 0, 4)


def _bmm_f32(a, b):
    """a @ b in fp32: bf16 inputs multiply exactly and sum in fp32."""
    if a.dtype == torch.bfloat16 and a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _count_forward(route) -> None:
    route.launches += 1
    flash_rel_pos_attention.launches += 1
    if recomputing():
        flash_rel_pos_attention.recompute_launches += 1


def _check_mma_inputs(name, q, k, v, Rh, Rw):
    """What the tensor-core kernels take: bf16 with hd a multiple of 8 up
    to 128 and 16-byte aligned q, k, v rows; ValueError for anything else.
    Returns q as (B, S, nh, hd)."""
    B, H, W, nh, hd = q.shape
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{name}: takes bfloat16, got {q.dtype}")
    if hd % 8 or not 8 <= hd <= 128:
        raise ValueError(f"{name}: hd={hd}; the tensor-core kernel "
                         "takes a multiple of 8 up to 128")
    if H * (W + 7) // 8 * 8 + 64 > 1 << 22:
        raise ValueError(f"{name}: grid {H}x{W} is too large")
    q3 = _check_attention_inputs(q, k, v, Rh, Rw)
    if any(t.data_ptr() % 16 for t in (q3, k, v)) or any(st % 8 for st in q3.stride()[:3]):
        raise ValueError(f"{name}: q, k, v rows must be 16-byte aligned")
    return q3


def rel_pos_flash_attn_mma(q, k, v, Rh, Rw, scale: float, with_lse: bool = False):
    """Kernel A's bf16 route (`csrc/rel_pos_flash_attn_mma.cu`, tensor
    cores) on CUDA tensors, no autograd; the bias tables from
    `rel_pos_bias`. Takes bf16 with hd a multiple of 8 up to 128 and
    16-byte aligned q, k, v rows, and raises ValueError for any other bf16
    input (no other kernel takes it). Returns as `rel_pos_flash_attn_fwd`."""
    B, H, W, nh, hd = q.shape
    S = H * W
    q3 = _check_mma_inputs("rel_pos_flash_attn_mma", q, k, v, Rh, Rw)
    dev = q.device
    _smem_check("rel_pos_flash_attn_mma", H, W, hd, _dev_index(dev))
    bh, bw = rel_pos_bias(q, Rh, Rw)
    out = torch.empty((B, H, W, nh * hd), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, nh, S), dtype=torch.float32, device=dev)
           if with_lse else None)
    sb, ss, sh, _ = q3.stride()
    rc = _entry("rel_pos_flash_attn_mma")(
        q3.data_ptr(), k.data_ptr(), v.data_ptr(), bh.data_ptr(), bw.data_ptr(),
        out.data_ptr(), 0 if lse is None else lse.data_ptr(), B, H, W, nh, hd,
        sb, ss, sh, _strides(bh), _strides(bw), float(scale), _build.stream_of(q))
    _build.check(_build.library("rel_pos_flash_attn_mma"), rc, "rel_pos_flash_attn_mma")
    _count_forward(rel_pos_flash_attn_mma)
    return out, lse


def rel_pos_flash_attn_fp32(q, k, v, Rh, Rw, scale: float, with_lse: bool = False):
    """Kernel A's fp32 route (`csrc/rel_pos_flash_attn.cu`, CUDA cores) on
    CUDA tensors, no autograd. Returns as `rel_pos_flash_attn_fwd`."""
    B, H, W, nh, hd = q.shape
    if q.dtype != torch.float32:
        raise ValueError(f"rel_pos_flash_attn_fp32: takes float32, got {q.dtype}")
    dev = q.device
    q3 = _check_attention_inputs(q, k, v, Rh, Rw)
    _smem_check("rel_pos_flash_attn", H, W, hd, _dev_index(dev))
    out = torch.empty((B, H, W, nh * hd), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, nh, H * W), dtype=torch.float32, device=dev)
           if with_lse else None)
    sb, ss, sh, _ = q3.stride()
    rc = _entry("rel_pos_flash_attn")(
        q3.data_ptr(), k.data_ptr(), v.data_ptr(), Rh.data_ptr(), Rw.data_ptr(),
        out.data_ptr(), 0 if lse is None else lse.data_ptr(), B, H, W, nh, hd,
        sb, ss, sh, float(scale), _build.stream_of(q))
    _build.check(_build.library("rel_pos_flash_attn"), rc, "rel_pos_flash_attn")
    _count_forward(rel_pos_flash_attn_fp32)
    return out, lse


def rel_pos_flash_attn_fwd(q, k, v, Rh, Rw, scale: float, with_lse: bool = False):
    """Launch kernel A on CUDA tensors (no autograd): bf16 on the tensor
    cores, fp32 on the CUDA cores; any other dtype raises. Returns the output
    (B, H, W, nh*hd) and, with `with_lse`, the per-row natural-log
    logsumexp of the biased scores (B, nh, S) fp32 (else None)."""
    if q.dtype == torch.bfloat16:
        return rel_pos_flash_attn_mma(q, k, v, Rh, Rw, scale, with_lse)
    if q.dtype == torch.float32:
        return rel_pos_flash_attn_fp32(q, k, v, Rh, Rw, scale, with_lse)
    raise TypeError(f"flash_rel_pos_attention: kernels take float32 or bfloat16, "
                    f"got {q.dtype}")


def _bwd_inputs(q, out, dout):
    """dO as (B, S, nh, hd) rows in q's dtype, and Dq = rowsum(dO * O)
    (B, nh, S) in fp32, which both backward routes read."""
    B, H, W, nh, hd = q.shape
    S = H * W
    dout4 = dout.reshape(B, S, nh, hd).to(q.dtype).contiguous()
    dsum = (dout4.float() * out.reshape(B, S, nh, hd).float()).sum(-1)
    return dout4, dsum.transpose(1, 2).contiguous()


def _bias_grad_buffers(bh, bw):
    """dbh and dbw, fp32, laid out as `rel_pos_bias`'s bh and bw: the
    kernels write them through the same strides they read the tables."""
    return (torch.empty_strided(bh.shape, bh.stride(), dtype=torch.float32, device=bh.device),
            torch.empty_strided(bw.shape, bw.stride(), dtype=torch.float32, device=bw.device))


def _bias_chain(q, Rh, Rw, dq, dbh, dbw):
    """The chain rule through bh = q.Rh and bw = q.Rw from the kernels' dbh
    and dbw (laid out by `_bias_grad_buffers`): dq (B, S, nh, hd) with its
    bias terms added, as (B, H, W, nh, hd), and dRh, dRw, all fp32. Batched
    products over grid rows (bh) and grid columns (bw), as `rel_pos_bias`
    forms the tables; dRh and dRw batch over the images too and sum those
    after, so that their long sums (B W nh, B H nh terms) are split."""
    B, H, W, nh, hd = q.shape
    gh = dbh.permute(2, 0, 3, 1, 4).reshape(H, B * W * nh, H)
    gw = dbw.permute(3, 0, 2, 1, 4).reshape(W, B * H * nh, W)
    qy = q.permute(1, 0, 2, 3, 4).reshape(H * B, W * nh, hd)
    qx = q.permute(2, 0, 1, 3, 4).reshape(W * B, H * nh, hd)
    dq = (dq.reshape(B, H, W, nh, hd)
          + _bmm_f32(gh, Rh).view(H, B, W, nh, hd).permute(1, 0, 2, 3, 4)
          + _bmm_f32(gw, Rw).view(W, B, H, nh, hd).permute(1, 2, 0, 3, 4))
    dRh = _bmm_f32(gh.view(H * B, W * nh, H).transpose(1, 2), qy).view(H, B, H, hd).sum(1)
    dRw = _bmm_f32(gw.view(W * B, H * nh, W).transpose(1, 2), qx).view(W, B, W, hd).sum(1)
    return dq, dRh, dRw


def rel_pos_flash_attn_bwd_mma(q, k, v, Rh, Rw, scale: float, out, lse, dout):
    """Kernel A-bwd's bf16 route (`csrc/rel_pos_flash_attn_bwd_mma.cu`,
    tensor cores) on CUDA tensors. Takes what kernel A's bf16 route takes
    and raises ValueError for any other bf16 input. Returns as
    `rel_pos_flash_attn_bwd`."""
    B, H, W, nh, hd = q.shape
    S = H * W
    name = "rel_pos_flash_attn_bwd_mma"
    q3 = _check_mma_inputs(name, q, k, v, Rh, Rw)
    dev = q.device
    _smem_check(name, H, W, hd, _dev_index(dev))
    bh, bw = rel_pos_bias(q, Rh, Rw)
    dout4, dsum = _bwd_inputs(q, out, dout)
    if dout4.data_ptr() % 16:
        raise ValueError(f"{name}: dout rows must be 16-byte aligned")
    dq = torch.empty((B, S, nh, hd), dtype=torch.float32, device=dev)
    dk = torch.empty((B, S, nh, hd), dtype=q.dtype, device=dev)
    dv = torch.empty((B, S, nh, hd), dtype=q.dtype, device=dev)
    dbh, dbw = _bias_grad_buffers(bh, bw)
    sb, ss, sh, _ = q3.stride()
    dsb, dss, dsh, _ = dout4.stride()
    rc = _entry(name)(
        q3.data_ptr(), k.data_ptr(), v.data_ptr(), dout4.data_ptr(), lse.data_ptr(),
        dsum.data_ptr(), bh.data_ptr(), bw.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dbh.data_ptr(), dbw.data_ptr(), B, H, W, nh, hd, sb, ss, sh,
        dsb, dss, dsh, _strides(bh), _strides(bw), float(scale), _build.stream_of(q))
    _build.check(_build.library(name), rc, name)
    rel_pos_flash_attn_bwd_mma.launches += 1
    dq, dRh, dRw = _bias_chain(q, Rh, Rw, dq, dbh, dbw)
    dt = q.dtype
    return dq.to(dt), dk, dv, dRh.to(dt), dRw.to(dt)


def rel_pos_flash_attn_bwd_fp32(q, k, v, Rh, Rw, scale: float, out, lse, dout):
    """Kernel A-bwd's fp32 route (`csrc/rel_pos_flash_attn_bwd.cu`, CUDA
    cores) on CUDA tensors. Returns as `rel_pos_flash_attn_bwd`."""
    B, H, W, nh, hd = q.shape
    S = H * W
    if q.dtype != torch.float32:
        raise ValueError(f"rel_pos_flash_attn_bwd_fp32: takes float32, got {q.dtype}")
    dev = q.device
    q3 = _check_attention_inputs(q, k, v, Rh, Rw)
    _smem_check("rel_pos_flash_attn_bwd", H, W, hd, _dev_index(dev))
    bh, bw = rel_pos_bias(q, Rh, Rw)
    dout4, dsum = _bwd_inputs(q, out, dout)
    f32 = dict(dtype=torch.float32, device=dev)
    dq = torch.empty((B, S, nh, hd), **f32)
    dk = torch.empty((B, S, nh, hd), **f32)
    dv = torch.empty((B, S, nh, hd), **f32)
    dbh, dbw = _bias_grad_buffers(bh, bw)
    sb, ss, sh, _ = q3.stride()
    rc = _entry("rel_pos_flash_attn_bwd")(
        q3.data_ptr(), k.data_ptr(), v.data_ptr(), dout4.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), bh.data_ptr(), bw.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbh.data_ptr(),
        dbw.data_ptr(), B, H, W, nh, hd, sb, ss, sh, _strides(bh), _strides(bw),
        float(scale), _build.stream_of(q))
    _build.check(_build.library("rel_pos_flash_attn_bwd"), rc, "rel_pos_flash_attn_bwd")
    rel_pos_flash_attn_bwd_fp32.launches += 1
    dq, dRh, dRw = _bias_chain(q, Rh, Rw, dq, dbh, dbw)
    return dq, dk, dv, dRh, dRw


def rel_pos_flash_attn_bwd(q, k, v, Rh, Rw, scale: float, out, lse, dout):
    """Launch kernel A-bwd on CUDA tensors: the gradients of
    `rel_pos_flash_attn_fwd` for the output cotangent `dout`, from the
    forward's logsumexp `lse`; bf16 on the tensor cores, fp32 on the CUDA
    cores, any other dtype raises. The kernels read the bias tables of
    `rel_pos_bias` where they lie, and the chain rule through bh = q.Rh and
    bw = q.Rw is taken here from their dbh and dbw. Returns (dq, dk, dv,
    dRh, dRw) in the input dtype. `launches` counts both routes."""
    if q.dtype == torch.bfloat16:
        grads = rel_pos_flash_attn_bwd_mma(q, k, v, Rh, Rw, scale, out, lse, dout)
    elif q.dtype == torch.float32:
        grads = rel_pos_flash_attn_bwd_fp32(q, k, v, Rh, Rw, scale, out, lse, dout)
    else:
        raise TypeError(f"rel_pos_flash_attn_bwd: kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    rel_pos_flash_attn_bwd.launches += 1
    return grads


class _RelPosFlashAttn(torch.autograd.Function):
    """Kernel A forward (saving each row's logsumexp), kernel A-bwd
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, Rh, Rw, scale):
        out, lse = rel_pos_flash_attn_fwd(q, k, v, Rh, Rw, scale, with_lse=True)
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, Rh, Rw, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, Rh, Rw, out, lse = ctx.saved_tensors
        grads = rel_pos_flash_attn_bwd(q, k, v, Rh, Rw, ctx.scale, out, lse, dout)
        return (*grads, None)


def flash_rel_pos_attention(q, k, v, Rh, Rw, scale: float) -> torch.Tensor:
    """Kernel A on CUDA tensors, differentiable (its backward is kernel
    A-bwd); `rel_pos_attention_plain`, differentiable by autograd, on CPU
    tensors. Shapes as `rel_pos_attention_plain`. q, k and v must share
    their strides with a unit last stride (the slices of one qkv tensor do).
    `launches` counts kernel A's launches on either route (each route's
    wrapper counts its own too); `recompute_launches` those of them made
    while a checkpointed block is recomputed for the backward."""
    dev = q.device
    if dev.type == "cpu":
        return rel_pos_attention_plain(q, k, v, Rh, Rw, scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_rel_pos_attention: unsupported device {dev}")
    if not torch.is_grad_enabled() or not any(
            t.requires_grad for t in (q, k, v, Rh, Rw)):
        return rel_pos_flash_attn_fwd(q, k, v, Rh, Rw, scale)[0]
    return _RelPosFlashAttn.apply(q, k, v, Rh, Rw, scale)


flash_rel_pos_attention.launches = 0
flash_rel_pos_attention.recompute_launches = 0


def flash_rel_pos_attention_tp(q, k, v, Rh, Rw, scale: float) -> torch.Tensor:
    """A′, the counterpart of `uninext_tpu/models/vit.py:195
    flash_rel_pos_attention_tp`: kernel A (`flash_rel_pos_attention`, under
    autograd with kernel A-bwd as its backward) on this rank's heads. q, k
    and v hold the nh / k heads of the rank's column-parallel qkv shard
    (`parallel/sharding.py` cuts q, k and v by heads), Rh and Rw are whole;
    no collective runs inside, and the head-major output (B, H, W, nh/k *
    hd) is the input shard the row-parallel `proj` takes. `launches` counts
    its launches of kernel A (its calls on CUDA tensors)."""
    if q.is_cuda:
        flash_rel_pos_attention_tp.launches += 1
    return flash_rel_pos_attention(q, k, v, Rh, Rw, scale)


flash_rel_pos_attention_tp.launches = 0
rel_pos_flash_attn_mma.launches = 0
rel_pos_flash_attn_fp32.launches = 0
rel_pos_flash_attn_bwd.launches = 0
rel_pos_flash_attn_bwd_mma.launches = 0
rel_pos_flash_attn_bwd_fp32.launches = 0


def drop_path_masks(batch: int, rate: float, generator: Optional[torch.Generator],
                    device, mesh=None) -> torch.Tensor:
    """Per-sample stochastic-depth scales (reference timm DropPath,
    `uninext_tpu/models/vit.py:109`): (2, B) of 0 or 1/keep, one row for
    the attention branch and one for the MLP branch of a block. Drawn before
    the block runs, so a checkpointed block's recompute sees the same masks.
    Under data parallelism (`mesh`) the draw is the whole batch's, cut to
    this rank's rows."""
    keep = 1.0 - rate
    u = rows_of_draw(lambda n: torch.rand((2, n), generator=generator, device=device),
                     batch, mesh, dim=1)
    return (u < keep).float() / keep


class Attention(nn.Module):
    """Attention over a (H, W) grid with the decomposed rel-pos bias.
    `rel_pos_size` is the span the tables are stored at; other grid sizes
    resize them (`interp_rel_pos`). Under tensor parallelism
    (`parallel/sharding.py:shard_module` sets `model_group` and cuts the
    heads) the block holds nh / k local heads: qkv is column-parallel, proj
    row-parallel, and the attention is A′, global and windowed blocks
    alike."""

    model_group = None

    def __init__(self, dim: int, num_heads: int, rel_pos_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = dtype
        self.head_dim = hd = dim // num_heads
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.rel_pos_h = nn.Parameter(torch.empty(2 * rel_pos_size - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.empty(2 * rel_pos_size - 1, hd))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.rel_pos_h)
        nn.init.zeros_(self.rel_pos_w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        nh, hd = self.num_heads, self.head_dim
        x = copy_to_model(x, self.model_group)
        qkv = self.qkv(x).reshape(B, H * W, 3, nh, hd)
        q, k, v = qkv.unbind(2)
        ar_h = torch.arange(H, device=x.device)
        ar_w = torch.arange(W, device=x.device)
        idx_h = ar_h[:, None] - ar_h[None, :] + H - 1
        idx_w = ar_w[:, None] - ar_w[None, :] + W - 1
        Rh = interp_rel_pos(self.rel_pos_h, H)[idx_h].to(self.compute_dtype)
        Rw = interp_rel_pos(self.rel_pos_w, W)[idx_w].to(self.compute_dtype)
        attend = (flash_rel_pos_attention if self.model_group is None
                  else flash_rel_pos_attention_tp)
        out = attend(q.reshape(B, H, W, nh, hd), k, v, Rh.contiguous(),
                     Rw.contiguous(), 1.0 / math.sqrt(hd))
        return self.proj(out)


class _Mlp(nn.Module):
    """fc1 is column-parallel and fc2 row-parallel under tensor
    parallelism."""

    model_group = None

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Linear(dim, 4 * dim, dtype=dtype)
        self.fc2 = Linear(4 * dim, dim, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(copy_to_model(x, self.model_group))))


class Block(nn.Module):
    """Pre-LN ViT block; `window_size` 0 = global attention. `drop` is None
    or the (2, B) stochastic-depth scales of `drop_path_masks`."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 rel_pos_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size = window_size
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, rel_pos_size, dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, dtype)

    def forward(self, x: torch.Tensor, drop: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        B, H, W, C = x.shape
        shortcut = x
        x = self.norm1(x)
        ws = self.window_size
        if ws > 0:
            ph = (ws - H % ws) % ws
            pw = (ws - W % ws) % ws
            if ph or pw:
                x = F.pad(x, (0, 0, 0, pw, 0, ph))
            Hp, Wp = H + ph, W + pw
            x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
            x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C)
        x = self.attn(x)
        if ws > 0:
            x = x.reshape(B, Hp // ws, Wp // ws, ws, ws, C)
            x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)[:, :H, :W]
        x = shortcut + _scaled(x, drop, 0)
        return x + _scaled(self.mlp(self.norm2(x)), drop, 1)


def _scaled(x: torch.Tensor, drop: Optional[torch.Tensor], branch: int):
    """x times its sample's drop-path scale (none without masks)."""
    if drop is None:
        return x
    return x * drop[branch].to(x.dtype).reshape(-1, *([1] * (x.dim() - 1)))


class _PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, patch: int, dtype):
        super().__init__()
        self.proj = Conv2d(in_channels, dim, patch, stride=patch, dtype=dtype)

    def forward(self, x):
        return self.proj(x)


class ViT(nn.Module):
    """ViT-Huge defaults, the reference D2ViT 'ViT-huge' layout: window 14,
    windowed blocks {0,1,3,4,6,7,9,10}, all others global; rel-pos tables
    stored at span 2*64-1 (global) or 2*14-1 (windowed); learned abs-pos
    embedding at pretrain 224 with a cls slot. Returns res3 (2x up),
    res4 (1x) and res5 (max-pool /2), NHWC."""

    REF_WINDOW_BLOCKS = (0, 1, 3, 4, 6, 7, 9, 10)

    def __init__(self, patch_size: int = 16, embed_dim: int = 1280,
                 depth: int = 32, num_heads: int = 16, window_size: int = 14,
                 global_blocks: Optional[Sequence[int]] = None,
                 pretrain_img_size: int = 224, rel_pos_init_size: int = 64,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32,
                 drop_path_rate: float = 0.0, use_checkpoint: bool = False):
        super().__init__()
        self.compute_dtype = dtype
        self.drop_path_rates = [float(r) for r in
                                np.linspace(0, drop_path_rate, depth)]
        self.use_checkpoint = use_checkpoint
        self.patch_embed = _PatchEmbed(in_channels, embed_dim, patch_size, dtype)
        n = pretrain_img_size // patch_size
        self.pos_embed = nn.Parameter(torch.empty(1, n * n + 1, embed_dim))
        blocks = []
        for i in range(depth):
            is_global = (i in global_blocks if global_blocks is not None
                         else i not in self.REF_WINDOW_BLOCKS)
            blocks.append(Block(embed_dim, num_heads,
                                0 if is_global else window_size,
                                rel_pos_init_size if is_global else window_size,
                                dtype=dtype))
        self.blocks = nn.ModuleList(blocks)
        self.fpn1 = nn.Sequential(nn.ConvTranspose2d(embed_dim, embed_dim // 2,
                                                     2, stride=2))

    def init_weights(self, generator: torch.Generator) -> None:
        trunc_normal_(self.pos_embed, 0.02, generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, mesh=None
                ) -> Dict[str, torch.Tensor]:
        """`train` turns on stochastic depth (masks from `generator`, this
        rank's rows of the whole batch's under a `mesh`) and, with
        `use_checkpoint` and autograd on, per-block activation checkpointing
        (the reference's MODEL.VIT.USE_CHECKPOINT)."""
        dt = self.compute_dtype
        x = self.patch_embed(x.to(dt))
        B, H, W, C = x.shape
        x = x + interp_abs_pos(self.pos_embed, H, W).to(dt)
        remat = train and self.use_checkpoint and torch.is_grad_enabled()
        for blk, rate in zip(self.blocks, self.drop_path_rates):
            drop = (drop_path_masks(B, rate, generator, x.device, mesh)
                    if train and rate > 0 else None)
            x = checkpointed(blk, x, drop) if remat else blk(x, drop)
        up = self.fpn1[0]
        res3 = F.conv_transpose2d(x.permute(0, 3, 1, 2), up.weight.to(dt),
                                  up.bias.to(dt), stride=2)
        res5 = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2)
        return {"res3": res3.permute(0, 2, 3, 1), "res4": x,
                "res5": res5.permute(0, 2, 3, 1)}
