"""The v6 MSDA formulation on the card: one gather from all levels' stacked
corner-packed tables, then a fold of the gathered rows (kernel B).

Port of tools/msda_v6_lab.py. There the fold was a Pallas kernel reading
the gather output through its transposed view, and v6 lost to the per-level
op (v4) on the TPU. Here the gather is one `index_select` and the fold is
kernel B (`ops/gather_fold.py:msda_fold`), which reads the gathered rows as
they come. `bench` times v6 against the port's MSDA kernel
(`ops/msda.py:ms_deform_attn`, lane groups of a warp sampling the value
map directly) at the lab's encoder shape.

    python -m uninext_tpu_torch.tools.msda_v6_lab     # parity, then bench (card)

The corner packing (`pack_levels`, `indices_weights`) lives here only: the
port's MSDA does not pack corners.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.gather_fold import msda_fold
from ..ops.msda import ms_deform_attn, ms_deform_attn_plain
from . import event_ms

SHAPES = ((100, 152), (50, 76), (25, 38), (13, 19))
S = sum(h * w for h, w in SHAPES)
B, M, D, L, P = 1, 8, 32, 4, 4
LQ = S
FOLD_TN = 8192       # the lab's query padding unit (its fold's block width)


def pack_levels(value_t: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]]):
    """value_t (B, M, S, D) -> per level (B, M, (H+2)*(W+2), 4D): each
    level zero-padded by one pixel and concatenated with itself rolled by
    {1, W+2, W+3}, so one row holds a sample's four bilinear corners."""
    Bv, Mv, _, Dv = value_t.shape
    out, start = [], 0
    for H, W in spatial_shapes:
        slab = value_t[:, :, start:start + H * W].reshape(Bv, Mv, H, W, Dv)
        slab = F.pad(slab, (0, 0, 1, 1, 1, 1))
        flat = slab.reshape(Bv, Mv, (H + 2) * (W + 2), Dv)
        out.append(torch.cat([flat, torch.roll(flat, -1, 2),
                              torch.roll(flat, -(W + 2), 2),
                              torch.roll(flat, -(W + 3), 2)], -1))
        start += H * W
    return out


def indices_weights(spatial_shapes, loc: torch.Tensor, att: torch.Tensor):
    """Per level the packed-row index (B, M, Lq, P) and the corner weights
    times the attention (B, M, Lq, P, 4), fp32. loc (B, M, Lq, L, P, 2) and
    att (B, M, Lq, L, P) are head-major. A sample counts where floor(x) is
    in [-1, W-1] and floor(y) in [-1, H-1]; corners beyond the frame land
    on the zero border."""
    idxs, ws = [], []
    for lvl, (H, W) in enumerate(spatial_shapes):
        l = loc[:, :, :, lvl].float()
        a = att[:, :, :, lvl].float()
        x = l[..., 0] * W - 0.5
        y = l[..., 1] * H - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        in_range = (x0 >= -1) & (x0 <= W - 1) & (y0 >= -1) & (y0 <= H - 1)
        a = a * in_range
        bx = torch.clamp(x0.to(torch.int32) + 1, 0, W)
        by = torch.clamp(y0.to(torch.int32) + 1, 0, H)
        idxs.append(by * (W + 2) + bx)
        bl = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy),
                          (1 - fx) * fy, fx * fy], -1)
        ws.append(bl * a[..., None])
    return idxs, ws


def pad_q_fused(B: int, M: int, Lq: int):
    """(Lq_pad, pad_q, B*M*Lq_pad): queries padded so that B*M*Lq_pad is a
    multiple of FOLD_TN, as in the lab; padded queries gather row 0 with
    weight 0."""
    bm = B * M
    step = FOLD_TN // math.gcd(bm, FOLD_TN)
    Lq_pad = -(-Lq // step) * step
    return Lq_pad, Lq_pad - Lq, bm * Lq_pad


def v6_operands(value: torch.Tensor, spatial_shapes, sampling_locations: torch.Tensor,
                attention_weights: torch.Tensor):
    """The gather's and the fold's operands: all levels' corner-packed
    tables stacked (rows, 4D), the gather index (L*P*BMLq,) int32, level-
    and point-major over B*M*Lq_pad columns, and the corner weights
    (L*P, BMLq, 4) in the value dtype, as in the lab."""
    Bv, _, Mv, Dv = value.shape
    _, Lq, _, Lv, Pv, _ = sampling_locations.shape
    dtype, dev = value.dtype, value.device
    Lq_pad, pad_q, BMLq = pad_q_fused(Bv, Mv, Lq)

    packed = pack_levels(value.permute(0, 2, 1, 3), spatial_shapes)
    idxs, ws = indices_weights(spatial_shapes,
                               sampling_locations.permute(0, 2, 1, 3, 4, 5),
                               attention_weights.permute(0, 2, 1, 3, 4))
    bm = (torch.arange(Bv, device=dev)[:, None] * Mv
          + torch.arange(Mv, device=dev)[None]).to(torch.int32)[..., None, None]
    bufs, gidx_parts, w_parts, off = [], [], [], 0
    for lvl in range(Lv):
        Rl = packed[lvl].shape[2]
        bufs.append(packed[lvl].reshape(Bv * Mv * Rl, 4 * Dv))
        gidx = F.pad(off + bm * Rl + idxs[lvl], (0, 0, 0, pad_q))   # (B, M, Lq_pad, P)
        gidx_parts.append(gidx.permute(3, 0, 1, 2).reshape(-1))
        w = F.pad(ws[lvl].to(dtype), (0, 0, 0, 0, 0, pad_q))         # (B, M, Lq_pad, P, 4)
        w_parts.append(w.permute(3, 0, 1, 2, 4).reshape(-1, 4))
        off += Bv * Mv * Rl
    return (torch.cat(bufs), torch.cat(gidx_parts),
            torch.cat(w_parts).view(Lv * Pv, BMLq, 4))


def msda_v6(value: torch.Tensor, spatial_shapes, sampling_locations: torch.Tensor,
            attention_weights: torch.Tensor) -> torch.Tensor:
    """MSDA with the layouts of `ops/msda.py:ms_deform_attn`: value
    (B, S, M, D), locations (B, Lq, M, L, P, 2), weights (B, Lq, M, L, P);
    returns (B, Lq, M*D) in the value dtype. The corner weights are cast to
    the value dtype before the fold, as in the lab."""
    Bv, _, Mv, Dv = value.shape
    Lq = sampling_locations.shape[1]
    buf, gidx, w = v6_operands(value, spatial_shapes, sampling_locations,
                               attention_weights)
    g = buf.index_select(0, gidx)                         # (L*P*BMLq, 4D)
    out = msda_fold(g.view(*w.shape[:2], 4 * Dv), w)      # (BMLq, D) fp32
    out = out.view(Bv, Mv, -1, Dv)[:, :, :Lq]
    return out.to(value.dtype).permute(0, 2, 1, 3).reshape(Bv, Lq, Mv * Dv)


def parity_inputs(device="cuda"):
    """The lab's parity inputs: four small levels, 37 queries, locations in
    [-0.1, 1.1] (some samples outside the frame), fp32, RandomState(1)."""
    shapes = ((15, 20), (8, 10), (4, 5), (10, 10))
    s = sum(h * w for h, w in shapes)
    rng = np.random.RandomState(1)
    value = rng.randn(B, s, M, D).astype(np.float32)
    loc = (rng.rand(B, 37, M, L, P, 2) * 1.2 - 0.1).astype(np.float32)
    att = rng.randn(B, 37, M, L, P).astype(np.float32)
    value, loc, att = (torch.from_numpy(a).to(device) for a in (value, loc, att))
    att = att.reshape(B, 37, M, L * P).softmax(-1).reshape(B, 37, M, L, P)
    return value, shapes, loc, att


def parity(device="cuda") -> float:
    """v6 against the plain MSDA (one grid_sample per level) at the lab's
    parity inputs; raises above the lab's 1e-4."""
    args = parity_inputs(device)
    err = (msda_v6(*args) - ms_deform_attn_plain(*args)).abs().max().item()
    print(f"parity v6 vs plain MSDA (f32, tiny, {device}): max|d| = {err:.2e}")
    if not err < 1e-4:
        raise AssertionError(f"msda_v6 parity: {err}")
    return err


def bench(dtype=torch.bfloat16, iters=20) -> dict:
    """The port's MSDA kernel ("v4 per-level" in the lab) and msda_v6 at the
    lab's encoder shape (B=1, M=8, D=32, L=P=4, Lq=S=20197) on the card,
    and v6 in its three parts: the operands (packing and index arithmetic),
    the gather (`index_select`) and the fold (kernel B). Returns the times
    (ms, CUDA events over graph replays) and the largest difference of the
    two outputs."""
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    value = torch.from_numpy(rng.randn(B, S, M, D).astype(np.float32)).to(dev, dtype)
    loc = torch.from_numpy(rng.rand(B, LQ, M, L, P, 2).astype(np.float32)).to(dev)
    att = torch.from_numpy(rng.randn(B, LQ, M, L, P).astype(np.float32)).to(dev)
    att = att.reshape(B, LQ, M, L * P).softmax(-1).reshape(B, LQ, M, L, P)
    args = (value, SHAPES, loc, att)
    with torch.inference_mode():
        err = (msda_v6(*args).float() - ms_deform_attn(*args).float()).abs().max().item()
        buf, gidx, w = v6_operands(*args)
        g = buf.index_select(0, gidx).view(*w.shape[:2], 4 * D)
        r = {"msda_ms": event_ms(lambda: ms_deform_attn(*args), iters),
             "v6_ms": event_ms(lambda: msda_v6(*args), iters),
             "operands_ms": event_ms(lambda: v6_operands(*args), iters),
             "gather_ms": event_ms(lambda: buf.index_select(0, gidx), iters),
             "fold_ms": event_ms(lambda: msda_fold(g, w), iters),
             "max_abs_err": err}
    name = str(dtype).removeprefix("torch.")
    print(f"[{name}] port MSDA kernel {r['msda_ms']:.3f} ms; v6 {r['v6_ms']:.3f} ms = "
          f"operands {r['operands_ms']:.3f} + index_select {r['gather_ms']:.3f} + "
          f"fold (kernel B) {r['fold_ms']:.3f} ms; max|v6 - MSDA| = {err:.2e} "
          f"({torch.cuda.get_device_name(0)})")
    return r


def main():
    if not torch.cuda.is_available():
        raise SystemExit("msda_v6_lab: no CUDA device")
    parity()
    bench(torch.bfloat16)


if __name__ == "__main__":
    main()
