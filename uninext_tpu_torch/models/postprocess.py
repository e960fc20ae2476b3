"""Inference postprocessing, mirroring `uninext_tpu/models/postprocess.py`:
grounding -> OD logits (mean over each class's tokens), IoU-aware score
sqrt(sigmoid(cls) * sigmoid(iou)), class-aware NMS (the NMS kernel) and top-k.

Also the two query selections that the JAX package computes inline before
`predict_masks`: the top-k detections' masks of instance segmentation
(`bench_instseg`) and the top-1 box and mask of REC/RES (`bench_rec`)."""
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


def take_queries(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, Q, C) at query indices idx (B, K) -> (B, K, C)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def postprocess_instseg(model, outputs: Dict, cls_token_map: torch.Tensor,
                  image_sizes: torch.Tensor, max_inst: int = 100) -> Dict:
    """Instance segmentation (`bench.py:bench_instseg`,
    `uninext_tpu/engine/evaluator.py:47-61`): `postprocess_detection`'s
    top `max_inst`, then the masks of those queries. Adds mask_logits
    (B, max_inst, H/4, W/4) to its dict."""
    post = postprocess_detection(outputs, cls_token_map, max_inst=max_inst)
    idx = post["query_idx"]
    post["mask_logits"] = model.predict_masks(
        outputs["memory"], outputs["spatial_shapes"],
        take_queries(outputs["hs"], idx),
        take_queries(outputs["base_reference"], idx), image_sizes)
    return post


def postprocess_rec(model, outputs: Dict, image_sizes: torch.Tensor) -> Dict:
    """REC/RES on a grounding forward (`bench.py:bench_rec`,
    `uninext_tpu/engine/evaluator.py:231-244`): the query of the largest
    sqrt(sigmoid(logit) * sigmoid(iou)), its box (B, 4) cxcywh normalised
    and its mask logits (B, 1, H/4, W/4)."""
    prob = outputs["pred_logits"][..., 0].float().sigmoid()
    if "pred_boxious" in outputs:
        prob = (prob * outputs["pred_boxious"][..., 0].float().sigmoid()).sqrt()
    best = prob.argmax(-1)[:, None]          # the first maximum, as jnp.argmax
    masks = model.predict_masks(
        outputs["memory"], outputs["spatial_shapes"],
        take_queries(outputs["hs"], best),
        take_queries(outputs["base_reference"], best), image_sizes)
    return {"box": take_queries(outputs["pred_boxes"], best)[:, 0],
            "query_idx": best[:, 0], "mask_logits": masks}
