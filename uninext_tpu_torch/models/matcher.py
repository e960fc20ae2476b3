"""Set matching for the training losses, mirroring
`uninext_tpu/models/matcher.py`, batched over images.

  * `vl_cost_matrix`: focal class cost averaged over each object's positive
    tokens + L1 + GIoU (reference HungarianMatcherVL.forward).
  * `hungarian_match`: exact assignment of each valid gt to a distinct
    query with `scipy.optimize.linear_sum_assignment` on the host, as the
    reference does. The JAX package solves the same problem on the device
    (its `_lsa`, the same Jonker-Volgenant algorithm) because a TPU step
    cannot leave the device; here one host round trip per step is the cost
    (a batched CUDA assignment waits for a profile that shows it matters).
  * `ota_cost_and_iou` / `simota_match`: the simOTA dynamic-k assignment of
    the decoder layers, as torch ops on the device. Its ties resolve as in
    the JAX package: stable sorts, the lowest index first.

Every matcher returns a dense per-query map q2g (B, Q): the gt index or -1.
Costs are computed on detached predictions (the callers pass them so).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from ..utils import box_ops

INF = 1e18


def _class_cost(pred_logits, positive_map, alpha: float, gamma: float):
    """(B, Q, T), (B, G, T) -> (B, Q, G): focal cost averaged over each
    gt's positive tokens."""
    prob = pred_logits.float().sigmoid()
    neg = (1 - alpha) * prob ** gamma * (-torch.log(1 - prob + 1e-8))
    pos = alpha * (1 - prob) ** gamma * (-torch.log(prob + 1e-8))
    pm = positive_map.float()
    denom = pm.sum(-1).clamp(min=1.0)                       # tokens per gt
    return torch.einsum("bqt,bgt->bqg", pos - neg, pm) / denom[:, None, :]


def vl_cost_matrix(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                   positive_map: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_valid: torch.Tensor, cost_class: float = 2.0,
                   cost_bbox: float = 5.0, cost_giou: float = 2.0,
                   alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """pred_logits (B, Q, T); pred_boxes (B, Q, 4) cxcywh; positive_map
    (B, G, T) bool; gt_boxes (B, G, 4); gt_valid (B, G) -> cost (B, Q, G),
    0 at invalid gts."""
    cls = _class_cost(pred_logits, positive_map, alpha, gamma)
    l1 = (pred_boxes[:, :, None] - gt_boxes[:, None]).abs().sum(-1)
    giou = -box_ops.generalized_box_iou(box_ops.box_cxcywh_to_xyxy(pred_boxes),
                                        box_ops.box_cxcywh_to_xyxy(gt_boxes))
    C = cost_bbox * l1 + cost_class * cls + cost_giou * giou
    return torch.where(gt_valid[:, None, :], C, 0.0)


def hungarian_match(cost: torch.Tensor, gt_valid: torch.Tensor) -> torch.Tensor:
    """cost (B, Q, G); gt_valid (B, G) -> q2g (B, Q) int64 on cost's device:
    each valid gt goes to a distinct query at the least total cost."""
    c = cost.detach().float().cpu().numpy()
    valid = gt_valid.cpu().numpy()
    q2g = np.full(c.shape[:2], -1, np.int64)
    for b in range(c.shape[0]):
        g_idx = np.flatnonzero(valid[b])
        if len(g_idx):
            rows, cols = linear_sum_assignment(c[b][:, g_idx].T)
            q2g[b, cols] = g_idx[rows]
    return torch.from_numpy(q2g).to(cost.device)


def ota_cost_and_iou(pred_logits, pred_boxes, positive_map, gt_boxes, gt_valid,
                     alpha: float = 0.25, gamma: float = 2.0,
                     expanded_strides: int = 32, center_radius: float = 2.5
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """OTA cost (B, Q, G), INF at invalid gts, and pairwise IoU (B, Q, G),
    0 at invalid gts (reference compute_cost / get_in_boxes_info)."""
    xyxy_gt = box_ops.box_cxcywh_to_xyxy(gt_boxes)
    cx, cy = pred_boxes[..., 0:1], pred_boxes[..., 1:2]        # (B, Q, 1)
    in_boxes = ((cx > xyxy_gt[:, None, :, 0]) & (cx < xyxy_gt[:, None, :, 2])
                & (cy > xyxy_gt[:, None, :, 1]) & (cy < xyxy_gt[:, None, :, 3]))
    r = center_radius / expanded_strides
    gx, gy = gt_boxes[:, None, :, 0], gt_boxes[:, None, :, 1]
    in_centers = ((cx > gx - r) & (cx < gx + r) & (cy > gy - r) & (cy < gy + r))
    in_boxes = in_boxes & gt_valid[:, None, :]
    in_centers = in_centers & gt_valid[:, None, :]
    fg_mask = (in_boxes | in_centers).any(-1)                  # (B, Q)
    both = in_boxes & in_centers

    iou, _ = box_ops.box_iou(box_ops.box_cxcywh_to_xyxy(pred_boxes), xyxy_gt)
    cls = _class_cost(pred_logits, positive_map, alpha, gamma)
    giou = -box_ops.generalized_box_iou(box_ops.box_cxcywh_to_xyxy(pred_boxes),
                                        xyxy_gt)
    cost = cls + 3.0 * giou + 100.0 * (~both)
    cost = cost + 10000.0 * (~fg_mask[..., None])
    valid = gt_valid[:, None, :]
    return torch.where(valid, cost, INF), torch.where(valid, iou, 0.0)


def _dedup(matching: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """Queries matched to more than one gt keep only their least-cost gt."""
    multi = matching.sum(-1) > 1
    best_g = torch.where(matching, cost, INF).argmin(-1)
    onehot = F.one_hot(best_g, cost.shape[-1]).bool()
    return torch.where(multi[..., None], onehot & matching, matching)


def simota_match(cost: torch.Tensor, ious: torch.Tensor, gt_valid: torch.Tensor,
                 n_candidate_k: int = 10, max_fixup_iters: int = 50
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic-k many-to-one matching. cost, ious (B, Q, G); gt_valid (B, G).
    Returns (q2g (B, Q) gt or -1, g2q_best (B, G) best query per gt or -1).

    Each gt takes its k lowest-cost queries, k = max(1, int(sum of its 10
    highest IoUs)); a query claimed twice keeps its cheapest gt; then a gt
    left without a query takes its cheapest unmatched query, for at most
    `max_fixup_iters` rounds (one host check per round)."""
    B, Q, G = cost.shape
    topk_ious = ious.transpose(1, 2).topk(min(Q, n_candidate_k), dim=-1).values
    dynamic_ks = topk_ious.sum(-1).int().clamp(min=1)          # (B, G)
    order = torch.argsort(cost, dim=1, stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(1, order, torch.arange(Q, device=cost.device)[None, :, None]
                   .expand(B, Q, G))
    matching = (ranks < dynamic_ks[:, None, :]) & gt_valid[:, None, :]
    matching = _dedup(matching, cost)
    for _ in range(max_fixup_iters):
        unmatched = gt_valid & (matching.sum(1) == 0)             # (B, G)
        if not bool(unmatched.any()):
            break
        adj = cost + 100000.0 * matching.any(-1)[..., None]
        pick = adj.argmin(1)                                        # (B, G)
        add = torch.zeros_like(matching)
        add.scatter_(1, pick[:, None, :], unmatched[:, None, :])
        matching = _dedup(matching | add, cost)
    q2g = torch.where(matching.any(-1), matching.int().argmax(-1), -1)
    g2q = torch.where(matching, cost, INF).argmin(1)
    return q2g, torch.where(gt_valid, g2q, -1)
