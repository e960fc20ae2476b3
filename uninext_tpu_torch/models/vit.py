"""Plain ViT backbone with windowed attention (ViTDet), NHWC, mirroring
`uninext_tpu/models/vit.py`.

Every block's attention goes through `flash_rel_pos_attention`, the wrapper
of kernel A (`csrc/rel_pos_flash_attn.cu`): on a CUDA tensor both the global
blocks (the whole grid) and the windowed blocks (14 x 14 windows as a batch)
launch it. The JAX package's `H*W >= 2048` flash gate and its q-row
chunking were decisions for the TPU and are not carried over. Under
autograd the wrapper is a `torch.autograd.Function` whose backward is
kernel A-bwd (`csrc/rel_pos_flash_attn_bwd.cu`).

Training adds stochastic depth (masks drawn before each block from an
explicit generator) and per-block activation checkpointing
(`torch.utils.checkpoint`, the JAX package's `nn.remat` of each block).

Parameter names follow the reference D2ViT (`backbone/vit.py:233-432`):
patch_embed.proj, pos_embed, blocks.{i}.{norm1,attn.{qkv,proj,rel_pos_h,
rel_pos_w},norm2,mlp.{fc1,fc2}}, fpn1.0 (the 2x2 stride-2 deconvolution
that makes res3).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import _build
from ..utils.misc import checkpointed, recomputing
from .layers import Conv2d, LayerNorm, Linear


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


def _smem_check(lib, fn_name: str, H: int, W: int, hd: int, dev) -> None:
    fn = getattr(lib, fn_name)
    fn.argtypes = [_build.I] * 3
    fn.restype = _build.LL
    smem = fn(H, W, hd)
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if hd > 128 or smem > limit:
        raise ValueError(f"{fn_name}: hd={hd}, grid {H}x{W} needs {smem} B of "
                         f"shared memory (limit {limit}, hd <= 128)")


def rel_pos_flash_attn_fwd(q, k, v, Rh, Rw, scale: float, with_lse: bool = False):
    """Launch kernel A on CUDA tensors (no autograd). Returns the output
    (B, H, W, nh*hd) and, with `with_lse`, the per-row logsumexp (B, nh, S)
    fp32 (else None)."""
    B, H, W, nh, hd = q.shape
    dev = q.device
    dtype = _build.dtype_code(q)
    q3 = _check_attention_inputs(q, k, v, Rh, Rw)
    lib = _build.library("rel_pos_flash_attn")
    _smem_check(lib, "rel_pos_flash_attn_smem_bytes", H, W, hd, dev)
    out = torch.empty((B, H, W, nh * hd), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, nh, H * W), dtype=torch.float32, device=dev)
           if with_lse else None)
    sb, ss, sh, _ = q3.stride()
    fn = lib.rel_pos_flash_attn
    fn.argtypes = ([_build.P] * 7 + [_build.I] * 5 + [_build.LL] * 3
                   + [_build.F, _build.I, _build.P])
    fn.restype = _build.I
    rc = fn(q3.data_ptr(), k.data_ptr(), v.data_ptr(), Rh.data_ptr(),
            Rw.data_ptr(), out.data_ptr(), 0 if lse is None else lse.data_ptr(),
            B, H, W, nh, hd, sb, ss, sh, float(scale), dtype, _build.stream_of(q))
    _build.check(lib, rc, "rel_pos_flash_attn")
    flash_rel_pos_attention.launches += 1
    if recomputing():
        flash_rel_pos_attention.recompute_launches += 1
    return out, lse


def rel_pos_flash_attn_bwd(q, k, v, Rh, Rw, scale: float, out, lse, dout):
    """Launch kernel A-bwd on CUDA tensors: the gradients of
    `rel_pos_flash_attn_fwd` for the output cotangent `dout`. The two
    products of the bias, bh = q.Rh and bw = q.Rw, are formed here (fp32
    einsums) for the kernels, and the chain rule through them is taken here
    from the kernels' dbh and dbw. Returns (dq, dk, dv, dRh, dRw) in the
    input dtype."""
    B, H, W, nh, hd = q.shape
    S = H * W
    dev = q.device
    dtype = _build.dtype_code(q)
    q3 = _check_attention_inputs(q, k, v, Rh, Rw)
    lib = _build.library("rel_pos_flash_attn_bwd")
    _smem_check(lib, "rel_pos_flash_attn_bwd_smem_bytes", H, W, hd, dev)
    qf = q.float()
    bh = torch.einsum("byxhd,yid->bhyxi", qf, Rh.float()).reshape(B, nh, S, H)
    bw = torch.einsum("byxhd,xjd->bhyxj", qf, Rw.float()).reshape(B, nh, S, W)
    dout4 = dout.reshape(B, S, nh, hd).to(q.dtype).contiguous()
    dsum = (dout4.float() * out.reshape(B, S, nh, hd).float()).sum(-1)
    dsum = dsum.transpose(1, 2).contiguous()                # (B, nh, S)
    f32 = dict(dtype=torch.float32, device=dev)
    dq = torch.empty((B, S, nh, hd), **f32)
    dk = torch.empty((B, S, nh, hd), **f32)
    dv = torch.empty((B, S, nh, hd), **f32)
    dbh = torch.empty((B, nh, S, H), **f32)
    dbw = torch.empty((B, nh, S, W), **f32)
    sb, ss, sh, _ = q3.stride()
    fn = lib.rel_pos_flash_attn_bwd
    fn.argtypes = ([_build.P] * 13 + [_build.I] * 5 + [_build.LL] * 3
                   + [_build.F, _build.I, _build.P])
    fn.restype = _build.I
    rc = fn(q3.data_ptr(), k.data_ptr(), v.data_ptr(), dout4.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), bh.data_ptr(), bw.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbh.data_ptr(),
            dbw.data_ptr(), B, H, W, nh, hd, sb, ss, sh, float(scale), dtype,
            _build.stream_of(q))
    _build.check(lib, rc, "rel_pos_flash_attn_bwd")
    rel_pos_flash_attn_bwd.launches += 1
    dbh = dbh.reshape(B, nh, H, W, H)
    dbw = dbw.reshape(B, nh, H, W, W)
    dq = (dq.reshape(B, H, W, nh, hd)
          + torch.einsum("bhyxi,yid->byxhd", dbh, Rh.float())
          + torch.einsum("bhyxj,xjd->byxhd", dbw, Rw.float()))
    dRh = torch.einsum("bhyxi,byxhd->yid", dbh, qf)
    dRw = torch.einsum("bhyxj,byxhd->xjd", dbw, qf)
    dt = q.dtype
    return dq.to(dt), dk.to(dt), dv.to(dt), dRh.to(dt), dRw.to(dt)


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
    `launches` counts kernel A's launches; `recompute_launches` those of
    them made while a checkpointed block is recomputed for the backward."""
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
rel_pos_flash_attn_bwd.launches = 0

def drop_path_masks(batch: int, rate: float, generator: Optional[torch.Generator],
                    device) -> torch.Tensor:
    """Per-sample stochastic-depth scales (reference timm DropPath,
    `uninext_tpu/models/vit.py:109`): (2, B) of 0 or 1/keep, one row for
    the attention branch and one for the MLP branch of a block. Drawn before
    the block runs, so a checkpointed block's recompute sees the same masks."""
    keep = 1.0 - rate
    u = torch.rand((2, batch), generator=generator, device=device)
    return (u < keep).float() / keep


class Attention(nn.Module):
    """Attention over a (H, W) grid with the decomposed rel-pos bias.
    `rel_pos_size` is the span the tables are stored at; other grid sizes
    resize them (`interp_rel_pos`)."""

    def __init__(self, dim: int, num_heads: int, rel_pos_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = dtype
        hd = dim // num_heads
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.rel_pos_h = nn.Parameter(torch.empty(2 * rel_pos_size - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.empty(2 * rel_pos_size - 1, hd))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.rel_pos_h)
        nn.init.zeros_(self.rel_pos_w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        nh = self.num_heads
        hd = C // nh
        qkv = self.qkv(x).reshape(B, H * W, 3, nh, hd)
        q, k, v = qkv.unbind(2)
        ar_h = torch.arange(H, device=x.device)
        ar_w = torch.arange(W, device=x.device)
        idx_h = ar_h[:, None] - ar_h[None, :] + H - 1
        idx_w = ar_w[:, None] - ar_w[None, :] + W - 1
        Rh = interp_rel_pos(self.rel_pos_h, H)[idx_h].to(self.compute_dtype)
        Rw = interp_rel_pos(self.rel_pos_w, W)[idx_w].to(self.compute_dtype)
        out = flash_rel_pos_attention(q.reshape(B, H, W, nh, hd), k, v,
                                      Rh.contiguous(), Rw.contiguous(),
                                      1.0 / math.sqrt(hd))
        return self.proj(out)


class _Mlp(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Linear(dim, 4 * dim, dtype=dtype)
        self.fc2 = Linear(4 * dim, dim, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


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
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """`train` turns on stochastic depth (masks from `generator`) and,
        with `use_checkpoint` and autograd on, per-block activation
        checkpointing (the reference's MODEL.VIT.USE_CHECKPOINT)."""
        dt = self.compute_dtype
        x = self.patch_embed(x.to(dt))
        B, H, W, C = x.shape
        x = x + interp_abs_pos(self.pos_embed, H, W).to(dt)
        remat = train and self.use_checkpoint and torch.is_grad_enabled()
        for blk, rate in zip(self.blocks, self.drop_path_rates):
            drop = (drop_path_masks(B, rate, generator, x.device)
                    if train and rate > 0 else None)
            x = checkpointed(blk, x, drop) if remat else blk(x, drop)
        up = self.fpn1[0]
        res3 = F.conv_transpose2d(x.permute(0, 3, 1, 2), up.weight.to(dt),
                                  up.bias.to(dt), stride=2)
        res5 = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2)
        return {"res3": res3.permute(0, 2, 3, 1), "res4": x,
                "res5": res5.permute(0, 2, 3, 1)}
