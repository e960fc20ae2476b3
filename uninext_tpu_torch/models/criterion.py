"""Set-prediction losses, mirroring `uninext_tpu/models/criterion.py`: the
token-level focal loss, L1, GIoU and the IoU branch, the CondInst mask
losses (focal and dice), BoxInst's box-supervised mask losses (the
projection and pairwise terms) and the video configs' contrastive reid
loss.

Targets are padded to (B, G) with a validity mask and a matching is a
dense per-query map q2g (B, Q) with -1 for unmatched, so every loss is a
masked sum.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import torch
import torch.nn.functional as F

from ..config import LossConfig
from ..parallel.comm import global_count
from ..utils import box_ops
from ..utils.misc import checkpointed


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
               pred_boxious: Optional[torch.Tensor] = None, mesh=None
               ) -> Dict[str, torch.Tensor]:
    """L1 and GIoU over matched pairs, and with `pred_boxious` the IoU
    branch's BCE against the (detached) IoU of each matched pair, over the
    whole batch's matched count (over `mesh`'s data group).
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
        out["loss_boxiou"] = (bce * matched).sum() / global_count(matched.sum(), mesh)
    return out


def dice_loss_elem(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-instance dice loss over the last axis: logits, targets (..., P)."""
    probs = logits.sigmoid()
    num = 2 * (probs * targets).sum(-1)
    den = probs.sum(-1) + targets.sum(-1)
    return 1 - (num + 1) / (den + 1)


def loss_masks(pred_masks: torch.Tensor, target_masks: torch.Tensor,
               sel_valid: torch.Tensor, num_boxes: torch.Tensor,
               cfg: LossConfig) -> Dict[str, torch.Tensor]:
    """Focal (the pixel mean per instance) and dice over the selected
    instances: pred_masks (B, N, H, W) logits, target_masks (B, N, H, W) in
    {0, 1}, sel_valid (B, N); each summed and divided by num_boxes."""
    B, N = pred_masks.shape[:2]
    pred = pred_masks.reshape(B, N, -1).float()
    tgt = target_masks.reshape(B, N, -1).float()
    v = sel_valid.float()
    focal = sigmoid_focal_loss(pred, tgt, cfg.focal_alpha, cfg.focal_gamma).mean(-1) * v
    dice = dice_loss_elem(pred, tgt) * v
    return {"loss_mask": focal.sum() / num_boxes, "loss_dice": dice.sum() / num_boxes}


def _neighbours(x: torch.Tensor, kernel_size: int = 3, dilation: int = 2
                ) -> Iterator[torch.Tensor]:
    """x (..., H, W) -> each of its k*k-1 dilated neighbours (..., H, W),
    zero-padded, in the order of `uninext_tpu/models/criterion.py:115
    unfold_wo_center` (the reference's, deformable_detr.py:787-810)."""
    k, d = kernel_size, dilation
    pad = (k + (d - 1) * (k - 1)) // 2
    xp = F.pad(x, (pad, pad, pad, pad))
    H, W = x.shape[-2:]
    for dy in range(k):
        for dx in range(k):
            if dy == k // 2 and dx == k // 2:
                continue
            yield xp[..., dy * d:dy * d + H, dx * d:dx * d + W]


def _pairwise_sum(mask_logits: torch.Tensor, bitmasks: torch.Tensor,
                  color_similarity: torch.Tensor, thresh: float, kernel_size: int,
                  dilation: int) -> torch.Tensor:
    """The pairwise term's numerator, sum(-log P(same label) x weight), one
    neighbour at a time: JAX's formula on (B, N, H, W) slices, without its
    (B, N, 8, H, W) tensors."""
    log_fg = F.logsigmoid(mask_logits)
    log_bg = F.logsigmoid(-mask_logits)
    total = mask_logits.new_zeros(())
    for i, (fg_n, bg_n) in enumerate(zip(_neighbours(log_fg, kernel_size, dilation),
                                         _neighbours(log_bg, kernel_size, dilation))):
        same_fg = log_fg + fg_n
        same_bg = log_bg + bg_n
        mx = torch.maximum(same_fg, same_bg)
        log_same = torch.log(torch.exp(same_fg - mx) + torch.exp(same_bg - mx)) + mx
        weight = (color_similarity[:, i] >= thresh).float()[:, None] * bitmasks
        total = total + (-log_same * weight).sum()
    return total


def loss_masks_boxinst(mask_logits: torch.Tensor, box_bitmasks: torch.Tensor,
                       color_similarity: torch.Tensor, sel_valid: torch.Tensor,
                       warmup_factor: torch.Tensor, pairwise_color_thresh: float = 0.3,
                       pairwise_size: int = 3, pairwise_dilation: int = 2, mesh=None
                       ) -> Dict[str, torch.Tensor]:
    """BoxInst's box-supervised mask losses (`uninext_tpu/models/
    criterion.py:134`; the reference's loss_masks_boxinst,
    deformable_detr.py:457-527), in fp32 whatever the logits' dtype.

    mask_logits (B, N, H, W) of the selected instances; box_bitmasks (B, N,
    H, W) their gt boxes rasterised (the only supervision);
    color_similarity (B, 8, H, W) each pixel's similarity to its 8 dilated
    neighbours; sel_valid (B, N); warmup_factor a scalar in [0, 1].

    `loss_prj`: the dice of the max over rows and of the max over columns
    of the scores against the bitmasks', summed over the valid instances
    and divided by their count. `loss_pairwise`: per pixel and neighbour,
    -log(P(both foreground) + P(both background)) as a log-sum-exp of
    log-sigmoids, weighted by `color_similarity >= pairwise_color_thresh`
    times the bitmask, over the weights' sum, times the warm-up factor. The
    numerator is taken one neighbour at a time under activation
    checkpointing, so the step keeps no (B, N, 8, H, W) tensor. Over a
    `mesh` both divisors are the whole batch's (`global_count`)."""
    x = mask_logits.float()
    v = sel_valid.float()
    scores = x.sigmoid() * v[..., None, None]
    bitmasks = box_bitmasks.float() * v[..., None, None]

    def dice(a, b):
        a, b = a.flatten(2), b.flatten(2)
        inter = (a * b).sum(-1)
        union = (a ** 2).sum(-1) + (b ** 2).sum(-1) + 1e-5
        return 1.0 - 2 * inter / union

    proj_x = dice(scores.amax(2, keepdim=True), bitmasks.amax(2, keepdim=True))
    proj_y = dice(scores.amax(3, keepdim=True), bitmasks.amax(3, keepdim=True))
    loss_prj = ((proj_x + proj_y) * v).sum() / global_count(v.sum(), mesh)

    color_similarity = color_similarity.float()
    n_pass = (color_similarity >= pairwise_color_thresh).float().sum(1)   # (B, H, W)
    weight_sum = global_count((n_pass[:, None] * bitmasks).sum(), mesh)
    numer = checkpointed(_pairwise_sum, x, bitmasks, color_similarity,
                         pairwise_color_thresh, pairwise_size, pairwise_dilation)
    loss_pairwise = numer / weight_sum * warmup_factor
    return {"loss_prj": loss_prj, "loss_pairwise": loss_pairwise}


def loss_reid_static(contrast: torch.Tensor, labels3: torch.Tensor,
                     row_valid: torch.Tensor, cos_sim: torch.Tensor, mesh=None
                     ) -> Dict[str, torch.Tensor]:
    """The contrastive reid loss of `uninext_tpu/models/criterion.py:181`.

    contrast (R, Q): dot products of each key-frame gt's query embedding
    (rows) with every ref-frame query's; labels3 (R, Q): 1 positive, 0
    negative, -1 left out; row_valid (R,); cos_sim (R, Q): the cosines.

    Per row, log(1 + sum over positives i and negatives j of
    exp(c_j - c_i)), the JAX package's logsumexp over the Q*Q differences
    and a zero, computed as softplus(LSE_j(c_j) + LSE_i(-c_i)) without the
    (R, Q*Q) tensor. A row with no positive or no negative (or not valid)
    adds 0, as there, and gets no gradient. The aux term is the weighted
    mean of (cos - label)^2, negatives weighted to ~10x the positive count.
    Both are means over the whole batch's valid rows (over `mesh`'s data
    group)."""
    pos = labels3 == 1
    neg = labels3 == 0
    row_valid = row_valid.float()
    rv = row_valid[:, None] > 0
    pos_v, neg_v = pos & rv, neg & rv
    has = pos_v.any(-1) & neg_v.any(-1)
    low = torch.finfo(contrast.dtype).min       # a finite stand-in for -inf
    lse_neg = torch.logsumexp(torch.where(neg_v, contrast, low), -1)
    lse_pos = torch.logsumexp(torch.where(pos_v, -contrast, low), -1)
    x = torch.where(has, lse_neg + lse_pos, 0.0)
    contras = torch.where(has, torch.nn.functional.softplus(x), 0.0)
    n = global_count(row_valid.sum(), mesh)
    loss_contrast = (contras * row_valid).sum() / n

    n_pos = pos.sum(-1).clamp(min=1)
    n_neg = neg.sum(-1).clamp(min=1)
    w_neg = (10.0 * n_pos / n_neg).clamp(max=1.0)[:, None]
    w = torch.where(pos, 1.0, torch.where(neg, w_neg, 0.0))
    err = (cos_sim - pos.float()) ** 2
    aux_per_row = (err * w).sum(-1) / w.sum(-1).clamp(min=1e-6)
    loss_aux = (aux_per_row * row_valid).sum() / n
    return {"loss_reid": loss_contrast, "loss_reid_aux": loss_aux}
