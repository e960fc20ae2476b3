"""Class-aware greedy NMS (kernel C, `csrc/nms.cu`).

Semantics of `uninext_tpu/ops/nms.py:batched_nms`, batched over images:
boxes are visited in descending score order (stable: the lower index first
among equal scores, invalid entries last); a box is kept unless a kept,
earlier box of the same class overlaps it with IoU > threshold. Invalid
entries are never kept. The result is exact greedy NMS.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils import box_ops
from . import _build


def _sorted_inputs(boxes, scores, classes, valid):
    order = torch.argsort(-torch.where(valid, scores, float("-inf")), dim=-1,
                          stable=True)
    b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    return order, b, torch.gather(classes, 1, order), torch.gather(valid, 1, order)


def batched_nms_plain(boxes: torch.Tensor, scores: torch.Tensor,
                      classes: torch.Tensor, iou_threshold: float,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Suppression matrix from `box_ops.box_iou`, then the sequential greedy
    sweep on the host. boxes (B, N, 4) xyxy; scores (B, N); classes (B, N)
    int -> keep (B, N) bool in the original order."""
    B, N = scores.shape
    if valid is None:
        valid = torch.ones((B, N), dtype=torch.bool, device=boxes.device)
    order, b, c, v = _sorted_inputs(boxes, scores, classes, valid)
    iou, _ = box_ops.box_iou(b, b)
    later = torch.ones((N, N), dtype=torch.bool, device=boxes.device).triu(1)
    sup = ((iou > iou_threshold) & (c[:, :, None] == c[:, None, :]) & later
           & v[:, :, None] & v[:, None, :]).cpu()
    keep_sorted = v.cpu().clone()
    for bi in range(B):
        for i in range(N):
            if keep_sorted[bi, i]:
                keep_sorted[bi] &= ~sup[bi, i]
    keep_sorted = keep_sorted.to(boxes.device)
    return torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor, iou_threshold: float,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel C on CUDA tensors, the plain version on CPU tensors."""
    dev = boxes.device
    if dev.type == "cpu":
        return batched_nms_plain(boxes, scores, classes, iou_threshold, valid)
    if dev.type != "cuda":
        raise ValueError(f"batched_nms: unsupported device {dev}")
    B, N = scores.shape
    if valid is None:
        valid = torch.ones((B, N), dtype=torch.bool, device=dev)
    if tuple(boxes.shape) != (B, N, 4) or boxes.dtype != torch.float32:
        raise ValueError(f"batched_nms: boxes must be float32 (B, N, 4), got "
                         f"{boxes.dtype} {tuple(boxes.shape)}")
    if tuple(classes.shape) != (B, N) or classes.dtype != torch.int64:
        raise ValueError("batched_nms: classes must be int64 (B, N)")
    if tuple(valid.shape) != (B, N) or valid.dtype != torch.bool:
        raise ValueError("batched_nms: valid must be bool (B, N)")
    if any(t.device != dev for t in (scores, classes, valid)):
        raise ValueError("batched_nms: inputs on different devices")
    if N == 0:
        return torch.zeros((B, 0), dtype=torch.bool, device=dev)
    order, b, c, v = _sorted_inputs(boxes, scores, classes, valid)
    b, c, v, order = (t.contiguous() for t in (b, c, v, order))
    nw = -(-N // 64)
    mask = torch.empty((B, N, nw), dtype=torch.int64, device=dev)
    keep = torch.empty((B, N), dtype=torch.bool, device=dev)
    lib = _build.library("nms")
    stream = _build.stream_of(boxes)
    lib.nms_bitmask.argtypes = [_build.P] * 4 + [_build.I, _build.I, _build.F, _build.P]
    lib.nms_bitmask.restype = _build.I
    rc = lib.nms_bitmask(b.data_ptr(), c.data_ptr(), v.data_ptr(),
                         mask.data_ptr(), B, N, float(iou_threshold), stream)
    _build.check(lib, rc, "nms_bitmask")
    lib.nms_sweep.argtypes = [_build.P] * 4 + [_build.I, _build.I, _build.P]
    lib.nms_sweep.restype = _build.I
    rc = lib.nms_sweep(mask.data_ptr(), v.data_ptr(), order.data_ptr(),
                       keep.data_ptr(), B, N, stream)
    _build.check(lib, rc, "nms_sweep")
    batched_nms.launches += 1
    return keep


batched_nms.launches = 0
