"""Class-aware greedy NMS (the NMS kernel, `csrc/nms.cu`).

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


_MAX_N = 1024        # the kernel's block holds one thread per box


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor, iou_threshold: float,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel C on CUDA tensors, the plain version on CPU tensors.

    The kernel takes contiguous boxes (B, N, 4) and scores (B, N) in
    float32, classes (B, N) int64 and valid (B, N) bool or None, with
    N <= 1024, and raises ValueError before any launch otherwise. Scores
    must be finite: the kernel orders valid boxes by score as
    `torch.argsort(-score, stable=True)` does only then. One call is one
    launch (no sort, gather or copy around it) and makes no host sync, so
    it can be captured in a CUDA graph."""
    dev = boxes.device
    if dev.type == "cpu":
        return batched_nms_plain(boxes, scores, classes, iou_threshold, valid)
    if dev.type != "cuda":
        raise ValueError(f"batched_nms: unsupported device {dev}")
    B, N = scores.shape
    for name, t, shape, dtype in (("boxes", boxes, (B, N, 4), torch.float32),
                                  ("scores", scores, (B, N), torch.float32),
                                  ("classes", classes, (B, N), torch.int64),
                                  ("valid", valid, (B, N), torch.bool)):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"batched_nms: {name} must be contiguous {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError("batched_nms: inputs on different devices")
    if N > _MAX_N:
        raise ValueError(f"batched_nms: the kernel takes N <= {_MAX_N} boxes, got {N}")
    keep = torch.empty((B, N), dtype=torch.bool, device=dev)
    if B == 0 or N == 0:
        return keep
    fn = _build.function("nms", "nms_fused",
                         (_build.P,) * 5 + (_build.I, _build.I, _build.F, _build.P))
    rc = fn(boxes.data_ptr(), scores.data_ptr(), classes.data_ptr(),
                   None if valid is None else valid.data_ptr(), keep.data_ptr(),
                   B, N, float(iou_threshold), _build.stream_of(boxes))
    _build.check(_build.library("nms"), rc, "nms_fused")
    batched_nms.launches += 1
    return keep


batched_nms.launches = 0
