"""Inference postprocessing, mirroring `uninext_tpu/models/postprocess.py`:
grounding -> OD logits (mean over each class's tokens), IoU-aware score
sqrt(sigmoid(cls) * sigmoid(iou)), class-aware NMS (the NMS kernel) and top-k."""
from __future__ import annotations

from typing import Dict

import torch

from ..ops.nms import batched_nms
from ..utils import box_ops
from ..utils.misc import stable_topk_indices


def grounding_to_od_logits(logits: torch.Tensor,
                           cls_token_map: torch.Tensor) -> torch.Tensor:
    """logits: (B, Q, T); cls_token_map: (C, T) bool -> (B, Q, C)."""
    m = cls_token_map.float()
    denom = m.sum(-1).clamp(min=1.0)
    return torch.einsum("bqt,ct->bqc", logits.float(), m) / denom


def postprocess_detection(outputs: Dict[str, torch.Tensor],
                          cls_token_map: torch.Tensor, max_inst: int = 100,
                          use_nms: bool = True, nms_threshold: float = 0.7,
                          score_threshold: float = 0.0) -> Dict[str, torch.Tensor]:
    """Returns dict(boxes (B,K,4) normalised xyxy, scores (B,K), classes
    (B,K), query_idx (B,K)) with K = min(max_inst, Q*C)."""
    logits = grounding_to_od_logits(outputs["pred_logits"], cls_token_map)
    prob = logits.sigmoid()
    if "pred_boxious" in outputs:
        prob = (prob * outputs["pred_boxious"].float().sigmoid()).sqrt()
    boxes_xyxy = box_ops.box_cxcywh_to_xyxy(outputs["pred_boxes"])
    B, Q, C = prob.shape
    if use_nms:
        # argmax returns the first maximum, as jnp.argmax does
        keep = batched_nms(boxes_xyxy.float().contiguous(), prob.amax(-1),
                           prob.argmax(-1), nms_threshold)
        prob = torch.where(keep[..., None], prob, -1.0)
    if score_threshold > 0.0:
        prob = torch.where(prob > score_threshold, prob, -1.0)
    flat = prob.reshape(B, Q * C)
    k = min(max_inst, Q * C)
    idx = stable_topk_indices(flat, k)
    scores = torch.gather(flat, 1, idx)
    query_idx = idx // C
    classes = idx % C
    sel_boxes = torch.gather(boxes_xyxy, 1, query_idx[..., None].expand(-1, -1, 4))
    return {"boxes": sel_boxes, "scores": scores, "classes": classes,
            "query_idx": query_idx}
