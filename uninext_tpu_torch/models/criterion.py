"""Set-prediction losses, mirroring `uninext_tpu/models/criterion.py` (the
detection losses; the mask losses wait with the mask head).

Targets are padded to (B, G) with a validity mask and a matching is a
dense per-query map q2g (B, Q) with -1 for unmatched, so every loss is a
masked sum.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import LossConfig
from ..utils import box_ops


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE with logits, elementwise."""
    return logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0):
    """Elementwise focal loss (no reduction)."""
    p = logits.sigmoid()
    ce = sigmoid_ce(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def gather_by_match(x: torch.Tensor, q2g: torch.Tensor) -> torch.Tensor:
    """x (B, G, ...); q2g (B, Q) -> (B, Q, ...), row 0 where q2g is -1."""
    idx = q2g.clamp(min=0).reshape(*q2g.shape, *([1] * (x.dim() - 2)))
    return torch.gather(x, 1, idx.expand(*q2g.shape, *x.shape[2:]))


def loss_labels_vl(pred_logits: torch.Tensor, positive_map: torch.Tensor,
                   q2g: torch.Tensor, text_mask: Optional[torch.Tensor],
                   num_boxes: torch.Tensor, cfg: LossConfig) -> torch.Tensor:
    """Token-level focal loss: pred_logits (B, Q, T); positive_map
    (B, G, T); q2g (B, Q); text_mask (B, T) 1 = valid, or None."""
    matched = (q2g >= 0)[..., None]
    target = gather_by_match(positive_map.float(), q2g)
    target = torch.where(matched, target, 0.0)
    loss = sigmoid_focal_loss(pred_logits.float(), target, cfg.focal_alpha,
                              cfg.focal_gamma)
    if text_mask is not None:
        loss = loss * text_mask[:, None, :].to(loss.dtype)
    return loss.sum() / num_boxes


def loss_boxes(pred_boxes: torch.Tensor, gt_boxes: torch.Tensor,
               q2g: torch.Tensor, num_boxes: torch.Tensor,
               pred_boxious: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
    """L1 and GIoU over matched pairs, and with `pred_boxious` the IoU
    branch's BCE against the (detached) IoU of each matched pair.
    pred_boxes (B, Q, 4) cxcywh; gt_boxes (B, G, 4); q2g (B, Q)."""
    matched = (q2g >= 0).float()
    tgt = gather_by_match(gt_boxes, q2g)
    pred = pred_boxes.float()
    l1 = (pred - tgt).abs().sum(-1) * matched
    pred_xyxy = box_ops.box_cxcywh_to_xyxy(pred)
    tgt_xyxy = box_ops.box_cxcywh_to_xyxy(tgt)
    giou = box_ops.elementwise_giou_loss(pred_xyxy, tgt_xyxy) * matched
    out = {"loss_bbox": l1.sum() / num_boxes, "loss_giou": giou.sum() / num_boxes}
    if pred_boxious is not None:
        iou_tgt = box_ops.elementwise_box_iou(pred_xyxy, tgt_xyxy).detach()
        bce = sigmoid_ce(pred_boxious[..., 0].float(), iou_tgt)
        out["loss_boxiou"] = (bce * matched).sum() / matched.sum().clamp(min=1.0)
    return out
